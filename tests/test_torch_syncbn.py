"""The SyncBatchNorm slice of the port against the JAX package, on the CPU.

- ``ops.batch_norm_apply_fused`` (the syncbn kernels' plain versions on the
  CPU) against ``apex_tpu.ops.pallas_syncbn.batch_norm_apply_fused`` in
  interpret mode: forward and the gradients of (x, mean, var, w, b);
- ``nn.BatchNorm2d`` train and eval against the JAX module with the Pallas
  apply forced (``APEX_TPU_FORCE_PALLAS=1``);
- ``parallel.SyncBatchNorm`` on 2 gloo ranks (processes started by the
  port's launcher, each with half of a 16-sample batch) against the JAX
  package's on 2 of its CPU devices under ``shard_map``, whole and in two
  groups of one;
- ``convert_syncbn_model``.

Inputs come from numpy seeds.  XLA's CPU backend may contract a multiply
and an add into an FMA where the port rounds each (ROADMAP queue 3), so
fp32 comparisons allow a few ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import nn as jnn
from apex_tpu.ops import pallas_syncbn
from apex_tpu.parallel import SyncBatchNorm as JSyncBatchNorm

from apex_tpu_torch import amp, models, nn, ops, optimizers, parallel

import torch_dist_worker

EPS = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _inputs(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    C = shape[1]
    return (rs.randn(*shape).astype(dtype),
            rs.randn(C).astype(np.float32),
            (rs.rand(C) + 0.1).astype(np.float32),
            rs.randn(C).astype(np.float32),
            rs.randn(C).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


# -- the fused op ----------------------------------------------------------------

SHAPES = [(2, 3, 4, 5), (3, 8, 16, 16), (1, 1, 1, 1), (2, 5, 3, 5),
          (3, 7, 7, 7)]


# fp32: the same formula on both sides; the FMA XLA may form costs <= 2 ulp
# of |y| (~4).  bf16: the fp32 results round to bf16, so an ulp there moves
# y by one bf16 step (2**-8 relative) at most.
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_apply_forward_matches_pallas(shape, dtype):
    x, mean, var, w, b, _ = _inputs(shape, 0)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = pallas_syncbn.batch_norm_apply_fused(jx, mean, var, w, b, EPS)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.batch_norm_apply_fused(tx, _t(mean), _t(var), _t(w), _t(b), EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * np.spacing(np.float32(8)))
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


# grads of sum(y * g): dx elementwise (fp32 a few ulp; bf16 one bf16 step),
# dmean/dvar/dw/db are sums over N*H*W, in another order on each side
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_apply_grads_match_pallas(shape, dtype):
    x, mean, var, w, b, g = _inputs(shape, 1)
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)

    def loss(args):
        y = pallas_syncbn.batch_norm_apply_fused(*args, EPS)
        return jnp.sum(y.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(loss)((jx, jnp.asarray(mean), jnp.asarray(var),
                           jnp.asarray(w), jnp.asarray(b)))
    tdt = getattr(torch, dtype)
    targs = [_t(np.asarray(jx.astype(jnp.float32))).to(tdt)] + \
        [_t(a) for a in (mean, var, w, b)]
    for a in targs:
        a.requires_grad_()
    y = ops.batch_norm_apply_fused(*targs, EPS)
    (y.float() * _t(np.asarray(jg.astype(jnp.float32)))).sum().backward()
    got = [a.grad for a in targs]
    assert got[0].dtype == tdt
    n = shape[0] * shape[2] * shape[3]
    for name, t, j in zip(("dx", "dmean", "dvar", "dw", "db"), got, want):
        t, j = t.float().numpy(), np.asarray(j, np.float32)
        if name == "dx":
            tol = 2 ** -8 if dtype == "bfloat16" else 1e-6
            np.testing.assert_allclose(t, j, rtol=tol, atol=1e-6,
                                       err_msg=name)
        else:
            # fp32 sums of n terms of size ~|g|*|xhat|*|w*inv|
            np.testing.assert_allclose(t, j, rtol=1e-5,
                                       atol=n * 1e-6 * max(1.0, np.abs(j)
                                                           .max()),
                                       err_msg=name)


def test_fused_apply_row_sums_odd_planes():
    """The backward's per-row sums and dx against float64 numpy."""
    for shape in [(2, 3, 1, 1), (3, 5, 3, 5), (2, 3, 7, 7)]:
        x, mean, var, w, _, dy = _inputs(shape, 2)
        inv = (1.0 / np.sqrt(var.astype(np.float64) + EPS)).astype(
            np.float32)
        dx, sdy, sdyx = ops.syncbn_bwd(_t(dy), _t(x), _t(mean), _t(inv),
                                       _t(w))
        col = (1, -1, 1, 1)
        xhat = (x.astype(np.float64) - mean.reshape(col)) * inv.reshape(col)
        np.testing.assert_allclose(sdy.numpy(), dy.sum(axis=(2, 3),
                                                       dtype=np.float64),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(sdyx.numpy(),
                                   (dy * xhat).sum(axis=(2, 3)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx.numpy(), dy * w.reshape(col)
                                   * inv.reshape(col), rtol=1e-6)
        assert sdy.shape == (shape[0], shape[1])


def test_fused_op_raises_on_mixed_devices_and_bad_input():
    x, mean, var, w, b, _ = _inputs((2, 3, 4, 4), 3)
    with pytest.raises(ValueError):
        ops.syncbn_fwd(_t(x)[0], _t(mean), _t(var), _t(w), _t(b))
    with pytest.raises(TypeError):
        ops.syncbn_fwd(_t(x), _t(mean).double(), _t(var), _t(w), _t(b))
    with pytest.raises(ValueError):
        ops.syncbn_fwd(_t(x), _t(mean)[:2], _t(var), _t(w), _t(b))


# -- BatchNorm2d -------------------------------------------------------------------

def _jax_bn_params(w, b):
    return {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm2d_train_and_eval_match_jax_forced_pallas(monkeypatch,
                                                            affine):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
    x, _, _, w, b, g = _inputs((4, 6, 5, 5), 4)
    x = x * 2 + 0.5
    jbn = jnn.BatchNorm2d(6, affine=affine)
    _, jstate = jbn.init(jax.random.PRNGKey(0))
    jparams = _jax_bn_params(w, b) if affine else {}

    def loss(p, xin):
        y, st = jnn.apply(jbn, p, xin, state=jstate, train=True)
        return jnp.sum(y * g), (y, st)

    (_, (jy, jst)), (jdp, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))
    jy_eval, _ = jnn.apply(jbn, jparams, jnp.asarray(x), state=jst,
                           train=False)

    bn = nn.BatchNorm2d(6, affine=affine, device="cpu")
    if affine:
        with torch.no_grad():
            bn.weight.copy_(_t(w))
            bn.bias.copy_(_t(b))
    tx = _t(x).requires_grad_()
    y = bn(tx)
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-4, atol=1e-5)
    if affine:
        np.testing.assert_allclose(bn.weight.grad.numpy(),
                                   np.asarray(jdp["weight"]), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(bn.bias.grad.numpy(),
                                   np.asarray(jdp["bias"]), rtol=1e-5,
                                   atol=1e-4)
    jleaves = list(jst.values())[0]
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(jleaves[k]), rtol=1e-6,
                                   atol=1e-7)
    assert int(bn.num_batches_tracked) == int(jleaves["num_batches_tracked"])
    bn.eval()
    np.testing.assert_allclose(bn(_t(x)).detach().numpy(),
                               np.asarray(jy_eval), rtol=1e-5, atol=1e-5)


def test_batchnorm2d_without_running_stats_uses_batch_stats():
    x = _inputs((4, 3, 3, 3), 5)[0]
    bn = nn.BatchNorm2d(3, track_running_stats=False, device="cpu").eval()
    assert bn.running_mean is None and "running_mean" not in bn.state_dict()
    y = bn(_t(x)).detach().numpy()
    np.testing.assert_allclose(y.mean(axis=(0, 2, 3)), 0.0, atol=1e-6)


def test_running_var_factor_on_device_matches_host_rounding():
    """A synced count is a tensor: count/(count-1) formed in fp32 on the
    device gives the bits the host-side numpy form gives."""
    var = _t(np.random.RandomState(6).rand(5).astype(np.float32))
    mean = torch.zeros(5)
    for count in (2, 3, 7, 49, 1000, 12544 * 16):
        a = nn.BatchNorm2d(5, device="cpu")
        b = nn.BatchNorm2d(5, device="cpu")
        a._update_running_stats(count, mean, var)
        b._update_running_stats(torch.tensor(float(count)), mean, var)
        assert torch.equal(a.running_var, b.running_var), count


# -- SyncBatchNorm over 2 gloo ranks -------------------------------------------------

@pytest.fixture(scope="module")
def syncbn_inputs():
    rs = np.random.RandomState(7)
    x2 = rs.randn(16, 2, 2, 2).astype(np.float32)
    x2[8:] += 10.0          # the second rank's half sees shifted data
    return {"x": (rs.randn(16, 6, 4, 4) * 3 + 1.5).astype(np.float32),
            "g": rs.randn(16, 6, 4, 4).astype(np.float32),
            "w": (rs.rand(6) + 0.5).astype(np.float32),
            "b": rs.randn(6).astype(np.float32),
            "x2": x2}


@pytest.fixture(scope="module")
def ranks(syncbn_inputs, tmp_path_factory):
    return torch_dist_worker.run("syncbn", syncbn_inputs,
                                 tmp_path_factory.mktemp("syncbn"))


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _shard(mesh, fn, *args, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(*args)


# y and dx: the fused formula on the port, x*scale + shift on the JAX side,
# and Chan's combine summed by gloo and by XLA (the same two terms each):
# a few ulp of |y| ~ 5.  dw, db: sums over the batch (measured 1.9e-5 of
# ~40 between the JAX package's own sharded and full-batch runs).
def test_syncbn_two_ranks_match_jax_shard_map(ranks, syncbn_inputs, mesh2):
    inp = syncbn_inputs
    sbn = JSyncBatchNorm(6)
    _, st = sbn.init(jax.random.PRNGKey(0))
    params = _jax_bn_params(inp["w"], inp["b"])

    def fn(xb, gb):
        def loss(p, xin):
            y, new = jnn.apply(sbn, p, xin, state=st, train=True)
            return jnp.sum(y * gb), (y, new)
        (_, (y, new)), (dp, dx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, xb)
        dp = jax.tree_util.tree_map(lambda t: jax.lax.psum(t, "data"), dp)
        return y, dx, dp, new

    y, dx, dp, new = _shard(mesh2, fn, inp["x"], inp["g"],
                            in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data"), P(), P()))
    leaves = list(new.values())[0]
    y_eval, _ = jnn.apply(sbn, params, jnp.asarray(inp["x"]), state=new,
                          train=False)
    got = {k: np.concatenate([r["sync"][k] for r in ranks])
           for k in ("y", "dx", "y_eval")}
    np.testing.assert_allclose(got["y"], np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["dx"], np.asarray(dx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["y_eval"], np.asarray(y_eval), rtol=1e-5,
                               atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["sync"]["dw"], np.asarray(dp["weight"]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(r["sync"]["db"], np.asarray(dp["bias"]),
                                   rtol=1e-5, atol=1e-4)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r["sync"][k], np.asarray(leaves[k]),
                                       rtol=1e-6, atol=1e-6)
        assert r["sync"]["num_batches_tracked"] == 1


def test_syncbn_groups_of_one_match_jax_axis_index_groups(ranks,
                                                          syncbn_inputs,
                                                          mesh2):
    x2 = syncbn_inputs["x2"]
    sbn = JSyncBatchNorm(2, process_group=("data", [[0], [1]]))
    params, st = sbn.init(jax.random.PRNGKey(0))

    def fn(xb):
        y, new = jnn.apply(sbn, params, xb, state=st, train=True)
        return y, list(new.values())[0]["running_mean"][None]

    y, rmean = _shard(mesh2, fn, x2, in_specs=(P("data"),),
                      out_specs=(P("data"), P("data")))
    got = np.concatenate([r["groups"]["y"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(y), rtol=1e-5, atol=1e-5)
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["groups"]["running_mean"],
                                   np.asarray(rmean)[i], rtol=1e-6,
                                   atol=1e-6)
    # each group normalized over its own half: the shifted half too
    for half in (got[:8], got[8:]):
        np.testing.assert_allclose(half.mean(axis=(0, 2, 3)), 0.0, atol=1e-5)


def test_syncbn_without_process_group_is_local_batchnorm():
    assert not torch.distributed.is_initialized()
    x = _t(_inputs((4, 3, 2, 2), 8)[0])
    a, b = parallel.SyncBatchNorm(3, device="cpu"), \
        nn.BatchNorm2d(3, device="cpu")
    assert torch.equal(a(x), b(x))
    assert torch.equal(a.running_var, b.running_var)


# -- convert_syncbn_model --------------------------------------------------------------

def test_convert_syncbn_model_carries_parameters_and_buffers():
    model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                          device="cpu")
    rs = np.random.RandomState(9)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if v.is_floating_point():
                v.copy_(_t(rs.randn(*v.shape).astype(np.float32)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_bn = sum(type(m) is nn.BatchNorm2d for m in model.modules())
    model = parallel.convert_syncbn_model(model)
    assert sum(isinstance(m, parallel.SyncBatchNorm)
               for m in model.modules()) == n_bn == 17
    assert not any(type(m) is nn.BatchNorm2d for m in model.modules())
    after = model.state_dict()
    assert after.keys() == before.keys()
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert model(torch.zeros(2, 3, 16, 16)).shape == (2, 10)

    single = parallel.convert_syncbn_model(
        nn.BatchNorm2d(4, eps=1e-3, momentum=0.2, device="cpu"),
        channel_last=True)
    assert isinstance(single, parallel.SyncBatchNorm)
    assert (single.eps, single.momentum, single.channel_axis) == \
        (1e-3, 0.2, -1)
    # a layer whose channels are last stays so; no other axis converts
    last = parallel.convert_syncbn_model(
        nn.BatchNorm2d(4, channel_axis=-1, device="cpu"))
    assert last.channel_axis == -1
    with pytest.raises(ValueError, match="channel_axis 2"):
        parallel.convert_syncbn_model(
            nn.BatchNorm2d(4, channel_axis=2, device="cpu"))


def test_convert_syncbn_model_refuses_an_amp_initialized_model():
    model, _ = amp.initialize(
        models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                      device="cpu"),
        optimizers.FusedAdam(), opt_level="O0", verbosity=0)
    with pytest.raises(RuntimeError, match="before amp.initialize"):
        parallel.convert_syncbn_model(model)
