"""Parity of the port's kernel wrappers with the JAX package's Pallas kernels.

On the CPU each wrapper of ``apex_tpu_torch.ops`` runs its plain PyTorch
version; the JAX side calls ``apex_tpu.ops.pallas_multi_tensor`` and
``pallas_adam`` directly, which run in Pallas interpret mode off the TPU
(as tests/test_pallas_kernels.py runs them).  Inputs come from a numpy
seed and go through both.  ``test_torch_cuda.py`` holds the CUDA kernels
against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.multi_tensor_apply import multi_tensor as jax_mt
from apex_tpu.ops import pallas_adam as pa
from apex_tpu.ops import pallas_multi_tensor as pk

from apex_tpu_torch import multi_tensor_apply as mta
from apex_tpu_torch import ops


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _ulps(a, b) -> int:
    """Largest distance in units in the last place between two fp32
    arrays (same-sign values; NaNs must sit in the same places)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ok = ~np.isnan(a)
    return int(np.max(np.abs(ia - ib)[ok], initial=0))


def _inject(x: np.ndarray, kind):
    x = x.copy()
    if kind == "inf":
        x[len(x) // 3] = np.inf
    elif kind == "nan":
        x[-1] = np.nan
    return x


# -- scale ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("inject", [None, "inf", "nan"])
def test_scale_matches_pallas_bitwise(n, inject):
    x = _inject(np.random.RandomState(n).randn(n).astype(np.float32), inject)
    ref, ref_flag = pk.multi_tensor_scale([jnp.asarray(x)], 1.0 / 65536.0)
    out, flag = ops.multi_tensor_scale(_t(x), 1.0 / 65536.0)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref[0]))
    assert float(flag) == float(ref_flag) == float(inject is not None)


def test_scale_in_place_and_device_scalar():
    x = np.random.RandomState(1).randn(300).astype(np.float32)
    xt = _t(x)
    s = torch.tensor(0.25)
    out, flag = ops.multi_tensor_scale(xt, s, out=xt)
    assert out.data_ptr() == xt.data_ptr()
    np.testing.assert_array_equal(xt.numpy(), x * np.float32(0.25))
    assert float(flag) == 0.0


# -- axpby ---------------------------------------------------------------------

@pytest.mark.parametrize("arg_to_check", [0, 1, -1])
@pytest.mark.parametrize("bad", [None, "x", "y"])
def test_axpby_matches_pallas(arg_to_check, bad):
    rs = np.random.RandomState(2)
    x = rs.randn(1000).astype(np.float32)
    y = rs.randn(1000).astype(np.float32)
    if bad == "x":
        x[5] = np.inf
    if bad == "y":
        y[9] = -np.inf
    a, b = 1.0 / 1024.0, 1.0
    ref, ref_flag = pk.multi_tensor_axpby(a, b, [jnp.asarray(x)],
                                          [jnp.asarray(y)], arg_to_check)
    out, flag = ops.multi_tensor_axpby(a, b, _t(x), _t(y), arg_to_check)
    # bitwise: with b == 1 and a a power of two no rounding step can be
    # contracted into an FMA by XLA's CPU fusion
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref[0]))
    want = float(bad is not None and (arg_to_check == -1
                                      or (arg_to_check == 0) == (bad == "x")))
    assert float(flag) == float(ref_flag) == want


def _fma(a, x, c):
    """fp32 a*x + c with one rounding (exact product and sum in float64,
    then one rounding to fp32), which is what XLA's CPU backend emits
    when it contracts a multiply and an add."""
    return (np.float64(a) * x.astype(np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def test_axpby_general_scalars_differ_only_by_fma_contraction():
    rs = np.random.RandomState(3)
    x = rs.randn(4099).astype(np.float32)
    y = rs.randn(4099).astype(np.float32)
    a, b = np.float32(0.3), np.float32(-1.7)
    ref, _ = pk.multi_tensor_axpby(0.3, -1.7, [jnp.asarray(x)],
                                   [jnp.asarray(y)])
    out, _ = ops.multi_tensor_axpby(0.3, -1.7, _t(x), _t(y))
    # the port rounds each product and the sum (the CUDA kernel is built
    # with -fmad=false); XLA on the CPU contracts a*x + (b*y) into one FMA.
    # Each is bitwise its own formula; where the sum cancels they differ
    # by many ulps of the (small) result
    np.testing.assert_array_equal(out.numpy(), a * x + b * y)
    np.testing.assert_array_equal(np.asarray(ref[0]), _fma(a, x, b * y))


# -- l2norm --------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 70001])
def test_l2norm_matches_pallas(n):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    ref, _ = pk.multi_tensor_l2norm([jnp.asarray(x)])
    got = ops.multi_tensor_l2norm(_t(x))
    # the sums run in another order
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


# -- Adam ----------------------------------------------------------------------

@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("half", [None, "bfloat16", "float16"])
def test_adam_matches_pallas(eps_inside_sqrt, weight_decay, half):
    rs = np.random.RandomState(4)
    n = 1001
    p = rs.randn(n).astype(np.float32)
    m = (np.abs(rs.randn(n)) * 0.1).astype(np.float32)
    v = (np.abs(rs.randn(n)) * 0.01).astype(np.float32)
    g = (rs.randn(n) * 1024).astype(np.float32)
    step_size, scale = 1e-3, 1024.0
    hp = dict(beta1=0.9, beta2=0.999, eps=1e-8,
              eps_inside_sqrt=eps_inside_sqrt, weight_decay=weight_decay)
    jhalf = None if half is None else jnp.dtype(half)
    rp, rm, rv, rh = pa.fused_adam(jnp.asarray(p), jnp.asarray(m),
                                   jnp.asarray(v), jnp.asarray(g), step_size,
                                   scale, half_dtype=jhalf, **hp)
    tp, tm, tv, tg = _t(p), _t(m), _t(v), _t(g)
    th = None if half is None else torch.empty(n, dtype=getattr(torch, half))
    inv = 1.0 / torch.tensor(scale, dtype=torch.float32)
    ops.fused_adam(tp, tm, tv, tg, torch.tensor(step_size), inv, half=th,
                   **hp)
    # the port is op for op the kernel's formula, each step rounded
    f = np.float32
    gs = g * (f(1) / f(scale))
    m_sep = f(0.9) * m + f(1.0 - 0.9) * gs
    np.testing.assert_array_equal(tm.numpy(), m_sep)
    # XLA on the CPU contracts beta1*m + ((1-beta1)*g) into one FMA, which
    # moves m by many ulps where the two terms cancel; v and p follow from
    # the same contractions within a few ulps
    np.testing.assert_array_equal(np.asarray(rm),
                                  _fma(f(0.9), m, f(1.0 - 0.9) * gs))
    assert _ulps(tv.numpy(), rv) <= 1
    assert _ulps(tp.numpy(), rp) <= 4
    if half is not None:
        d = np.abs(th.view(torch.int16).numpy().astype(np.int32)
                   - np.asarray(rh).view(np.int16).astype(np.int32))
        assert d.max() <= 1


def test_adam_noop_flag_leaves_state_unchanged():
    rs = np.random.RandomState(5)
    bufs = [_t(rs.randn(257).astype(np.float32)) for _ in range(4)]
    before = [b.clone() for b in bufs]
    half = torch.zeros(257, dtype=torch.bfloat16)
    ops.fused_adam(*bufs, torch.tensor(1e-3), torch.tensor(1.0), 0.9, 0.999,
                   1e-8, False, 0.0, half=half, noop=torch.tensor(1.0))
    for b, a in zip(bufs, before):
        assert torch.equal(b, a)
    assert torch.equal(half, torch.zeros_like(half))


# -- guards and the list form ---------------------------------------------------

def test_wrapper_rejects_wrong_dtype_and_shape():
    with pytest.raises(TypeError):
        ops.multi_tensor_scale(torch.ones(4, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        ops.multi_tensor_l2norm(torch.ones(2, 2))
    with pytest.raises(ValueError):
        ops.multi_tensor_axpby(1.0, 1.0, torch.ones(4), torch.ones(5))


def test_dispatch_is_by_device_only():
    assert ops._build.use_kernel(torch.ones(1)) is False
    meta = torch.empty(1, device="meta")
    with pytest.raises(ValueError):
        ops._build.use_kernel(torch.ones(1), meta)


def test_list_form_matches_jax_multi_tensor():
    rs = np.random.RandomState(6)
    a = rs.randn(33, 5).astype(np.float32)
    b = rs.randn(7).astype(np.float32)
    jout, jflag = jax_mt.multi_tensor_scale(
        [jnp.asarray(a), jnp.asarray(b, jnp.bfloat16)], 0.5)
    tout, tflag = mta.multi_tensor_scale([_t(a), _t(b).to(torch.bfloat16)],
                                         0.5)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert tout[1].dtype == torch.bfloat16
    np.testing.assert_array_equal(tout[1].float().numpy(),
                                  np.asarray(jout[1], np.float32))
    assert float(tflag) == float(jflag) == 0.0
    norm, _ = mta.multi_tensor_l2norm([_t(a), _t(b)])
    jnorm, _ = jax_mt.multi_tensor_l2norm([jnp.asarray(a), jnp.asarray(b)])
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    bad = _t(a)
    bad[0, 0] = np.nan
    assert float(mta.global_grad_norm([bad])) == -1.0
