"""The LayerNorm kernels' plain versions and FusedLayerNorm against the JAX
package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``APEX_TPU_FORCE_PALLAS=1``), the port its wrappers' plain PyTorch
versions (CPU tensors); the same numpy inputs go through both.  The row
sums run in another order on each side, so fp32 results agree to a few
units of fp32 rounding; bf16 outputs can then round to neighbouring bf16
values, one unit of bf16's last place (2**-8 relative) apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.normalization import fused_layer_norm as jax_layer_norm
from apex_tpu.ops import pallas_layer_norm as pln

from apex_tpu_torch import ops
from apex_tpu_torch.normalization import FusedLayerNorm, fused_layer_norm
from apex_tpu_torch.ops import layer_norm as lnm
from apex_tpu_torch.utils.jax_interop import _to_numpy, _to_torch

N1 = 24


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _case(n2, dtype, affine, seed=0):
    rs = np.random.RandomState(seed + n2)
    x = (rs.randn(N1, n2) * 2.0 + 0.7).astype(np.float32)
    dy = rs.randn(N1, n2).astype(np.float32)
    w = rs.randn(n2).astype(np.float32) if affine else None
    b = rs.randn(n2).astype(np.float32) if affine else None
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return jnp.asarray(x, jd), jnp.asarray(dy, jd), w, b


# fp32: 1e-5 abs on values of order 1-10 (the sums' order; inv up to 1e6
# at n2 = 1 with eps 1e-12, where var is exactly 0 on both sides).  bf16:
# one bf16 unit (2**-8 relative) on y and dx, or the fp32 bound if larger.
def _close(got, want, dtype, rtol32=1e-5, atol32=1e-5):
    tol = ((rtol32, atol32) if dtype == "fp32"
           else (2 ** -7, max(2 ** -7, atol32)))
    np.testing.assert_allclose(_np32(_to_numpy(got)), _np32(want),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("n2", [768, 100, 1, 4096])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_kernels_match_jax(monkeypatch, n2, dtype, eps, affine):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
    x, dy, w, b = _case(n2, dtype, affine)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    jy, jmean, jinv = pln.forward(x, jw, jb, eps)
    jdx, jdw, jdb = pln.backward(dy, x, jw, jb, jmean, jinv)

    tx, tdy = _to_torch(np.asarray(x)), _to_torch(np.asarray(dy))
    tw = None if w is None else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    y, mean, inv = ops.layer_norm_fwd(tx, tw, tb, eps)
    assert y.dtype == tx.dtype and mean.dtype == inv.dtype == torch.float32
    _close(y, jy, dtype)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-5)
    # the backward from the JAX statistics, so only its own sums differ
    dx, dw, db = ops.layer_norm_bwd(tdy, tx, tw,
                                    torch.from_numpy(np.array(jmean)),
                                    torch.from_numpy(np.array(jinv)))
    assert dx.dtype == tx.dtype
    # dx is inv times a difference of terms of size |dy*w|, which rounds to
    # a few units of 2**-24 * |dy*w|: at n2 = 1 with eps 1e-12 (inv = 1e6)
    # the terms cancel exactly here (dx = 0) and leave ~1e-3 in XLA's
    # CPU code; elsewhere inv is about 0.5 and the bound is ~1e-6
    g = np.abs(_np32(dy)) * (1.0 if w is None else np.abs(w))
    atol = 2e-5 + 8 * 2.0 ** -24 * float(np.asarray(jinv).max() * g.max())
    _close(dx, jdx, dtype, rtol32=1e-5, atol32=atol)
    if affine:
        # column sums over 24 rows of terms of order 1-10
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("affine", [True, False])
def test_fused_layer_norm_module_matches_jax(monkeypatch, affine):
    """FusedLayerNorm over the last two dims of a (2, 3, 4, 5) input: y and
    the grads of x, weight and bias through the autograd op."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 4, 5).astype(np.float32)
    g = rs.randn(2, 3, 4, 5).astype(np.float32)
    w = rs.randn(4, 5).astype(np.float32)
    b = rs.randn(4, 5).astype(np.float32)

    def jloss(x, w, b):
        y = jax_layer_norm(x, (4, 5), w, b, 1e-5)
        return jnp.sum(y * g), y

    args = (jnp.asarray(x), jnp.asarray(w) if affine else None,
            jnp.asarray(b) if affine else None)
    argnums = (0, 1, 2) if affine else (0,)
    (_, jy), jg = jax.value_and_grad(jloss, argnums=argnums,
                                     has_aux=True)(*args)

    mod = FusedLayerNorm((4, 5), eps=1e-5, elementwise_affine=affine,
                         device="cpu")
    if affine:
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(w))
            mod.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).requires_grad_()
    y = mod(tx)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    got = [tx.grad] + ([mod.weight.grad, mod.bias.grad] if affine else [])
    for t, j in zip(got, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=2e-5)


def test_grads_come_back_in_the_params_dtype():
    """bf16 input with fp32 weight (O2's layout): y in bf16, dw and db in
    fp32; bf16 weight and bias: their grads in bf16."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(6, 16).astype(np.float32)).bfloat16()
    for pd in (torch.float32, torch.bfloat16):
        w = torch.ones(16, dtype=pd, requires_grad=True)
        b = torch.zeros(16, dtype=pd, requires_grad=True)
        xi = x.clone().requires_grad_()
        y = fused_layer_norm(xi, 16, w, b, 1e-12)
        y.float().sum().backward()
        assert y.dtype == torch.bfloat16 and xi.grad.dtype == torch.bfloat16
        assert w.grad.dtype == b.grad.dtype == pd


def test_layer_norm_wrappers_check_their_operands():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        ops.layer_norm_fwd(x[:, ::2], None, None, 1e-5)
    with pytest.raises(TypeError):
        ops.layer_norm_fwd(x.double(), None, None, 1e-5)
    with pytest.raises(ValueError):
        ops.layer_norm_fwd(x, torch.ones(7), None, 1e-5)
    _, mean, inv = ops.layer_norm_fwd(x, None, None, 1e-5)
    with pytest.raises(ValueError):
        ops.layer_norm_bwd(x.bfloat16(), x, None, mean, inv)


@pytest.mark.parametrize("n1", [1, 7, 1024, 4096, 4097, 100_000])
@pytest.mark.parametrize("n2", [1, 100, 104, 768, 1024, 1500])
def test_bwd_plan_depends_on_the_shape_alone(n1, n2):
    """The backward's grid on the card (the host's choice, run here as the
    pure function it is): the 16-byte path only for rows of whole 16-byte
    chunks with aligned operands; the partial rows, and so the order of
    every sum of dw and db, set by (n1, n2) alone; every row covered and
    the scratch holding every partial row."""
    plans = {(isz, aligned): lnm._bwd_plan(n1, n2, isz, aligned)
             for isz in (2, 4) for aligned in (True, False)}
    for (isz, aligned), plan in plans.items():
        if n2 > 1024:
            assert plan.path == "stream"
        else:
            whole = n2 * isz % 16 == 0
            assert plan.path == ("vector" if whole and aligned
                                 else "element")
    assert len({plan._replace(path="") for plan in plans.values()}) == 1
    plan = plans[(2, True)]
    assert 1 <= plan.warps <= 8 and plan.rows_per_warp >= 1
    if n2 > 1024:
        # a grid stride over the rows, a partial row a warp
        assert plan.parts == plan.blocks * plan.warps
    else:
        # consecutive rows a warp, a partial row a block, no block without
        # rows
        rows = plan.warps * plan.rows_per_warp
        assert plan.parts == plan.blocks
        assert plan.blocks * rows >= n1 > (plan.blocks - 1) * rows
    assert plan.parts <= 256 * plan.warps
    assert plan.scratch == 2 * plan.parts * n2


@pytest.mark.parametrize("n1", [1, 7, 1024, 4096, 4097, 100_000])
@pytest.mark.parametrize("n2", [1, 100, 104, 768, 1024, 1500, 4096, 8192,
                                9000])
def test_fwd_plan_depends_on_the_shape_alone(n1, n2):
    """The forward's grid on the card (the host's choice, run here as the
    pure function it is): the 16-byte path only for rows of whole 16-byte
    chunks up to 8192 with aligned operands; the grid set by (n1, n2)
    alone; a warp a row up to 1024, a block of 8 warps a row up to 8192;
    every row covered and no block without rows."""
    plans = {(isz, aligned): lnm._fwd_plan(n1, n2, isz, aligned)
             for isz in (2, 4) for aligned in (True, False)}
    for (isz, aligned), plan in plans.items():
        if n2 > 8192:
            assert plan.path == "stream"
        else:
            whole = n2 * isz % 16 == 0
            assert plan.path == ("vector" if whole and aligned
                                 else "element")
    assert len({plan._replace(path="") for plan in plans.values()}) == 1
    plan = plans[(2, True)]
    assert 1 <= plan.warps <= 8 and plan.rows_per_group >= 1
    assert plan.row_warps == (8 if 1024 < n2 <= 8192 else 1)
    assert plan.warps % plan.row_warps == 0
    rows = plan.warps // plan.row_warps * plan.rows_per_group
    assert plan.blocks * rows >= n1 > (plan.blocks - 1) * rows
