"""LAMB in the port against the JAX package, on the CPU.

- the plain versions of the two LAMB kernels (``ops.lamb_stage1``,
  ``ops.lamb_stage2``) against ``apex_tpu.ops.pallas_lamb`` in Pallas
  interpret mode, and against their own formula rounded op by op;
- the per-tensor norms (``ChunkedFlatLayout.per_tensor_sqsum``,
  ``expand_per_tensor``, ``multi_tensor_l2norm(per_tensor=True)``)
  against the JAX package's;
- ``FusedLAMB`` against the JAX ``FusedLAMB`` (under
  ``APEX_TPU_FORCE_PALLAS=1``, its kernels' arithmetic) for two steps on a
  ragged list of tensors, one of them all zeros;
- the LAMB state carried across by ``utils.jax_interop`` and back, and a
  found-inf step that changes nothing.

Inputs come from numpy seeds and go through both sides.
``test_torch_cuda.py`` holds the CUDA kernels against the plain versions
on the card.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.multi_tensor_apply import multi_tensor as jax_mt
from apex_tpu.multi_tensor_apply.flatten import (ChunkedFlat as JChunkedFlat,
                                                 ChunkedFlatLayout as JLayout)
from apex_tpu.ops import pallas_lamb as pl_lamb
from apex_tpu.optimizers import FusedLAMB as JFusedLAMB
from apex_tpu.optimizers.fused_lamb import LambState as JLambState

from apex_tpu_torch import multi_tensor_apply as mta
from apex_tpu_torch import ops, optimizers
from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
from apex_tpu_torch.utils.jax_interop import (lamb_state_from_jax,
                                              lamb_state_to_jax)

f32 = np.float32
# a ragged list: lengths on and off the 1024 chunk, a 2-D tensor, an
# all-zero tensor (zero norm: trust ratio 1)
SHAPES = {"a": (1,), "b": (1023,), "c": (1025,), "d": (3, 1024),
          "e": (37, 5), "z": (129,)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(seed, scale=1.0, zero="z"):
    rs = np.random.RandomState(seed)
    return {k: (np.zeros(s, f32) if k == zero else
                (rs.randn(*s) * scale).astype(f32))
            for k, s in SHAPES.items()}


def _list(tree):
    # the JAX package's leaf order: the keys sorted
    return [_t(tree[k]) for k in sorted(tree)]


# -- stage 1 --------------------------------------------------------------------

def _stage1_np(g, p, m, v, inv_clip, inv_bc1, inv_bc2, b1, b2, b3, eps, wd,
               adam_w_mode):
    """The kernel's formula in numpy fp32, each operation rounded.  The
    square root is torch's: on the CPU it is within an ulp of the rounded
    root, not always equal to it (on the card it is IEEE's)."""
    gs = g * f32(inv_clip)
    if not adam_w_mode and wd:
        gs = gs + f32(wd) * p
    m = f32(b1) * m + f32(b3) * gs
    v = f32(b2) * v + f32(1.0 - b2) * gs * gs
    root = torch.sqrt(_t(v * f32(inv_bc2))).numpy()
    u = (m * f32(inv_bc1)) / (root + f32(eps))
    if adam_w_mode and wd:
        u = u + f32(wd) * p
    return u, m, v


@pytest.mark.parametrize("n", [1, 1001])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_stage1_matches_pallas(n, adam_w_mode, wd):
    rs = np.random.RandomState(n)
    g = (rs.randn(n) * 3).astype(f32)
    p = rs.randn(n).astype(f32)
    m = (rs.randn(n) * 0.1).astype(f32)
    v = (np.abs(rs.randn(n)) * 0.01).astype(f32)
    scal = (f32(0.5), f32(1.0) / f32(0.1), f32(1.0) / f32(0.001))
    hp = (0.9, 0.999, 0.1, 1e-6, wd, adam_w_mode)
    ru, rm, rv = pl_lamb.lamb_stage1(*(jnp.asarray(a) for a in (g, p, m, v)),
                                     *scal, *hp)
    tm, tv = _t(m), _t(v)
    tu = ops.lamb_stage1(_t(g), _t(p), tm, tv, *(float(s) for s in scal),
                         *hp)
    # the port is its formula exactly, each operation rounded (as the CUDA
    # kernel, built with -fmad=false)
    for got, want in zip((tu, tm, tv), _stage1_np(g, p, m, v, *scal, *hp)):
        np.testing.assert_array_equal(got.numpy(), want)
    # XLA's CPU code contracts b1*m + b3*g and the v update into FMAs (in
    # interpret mode too): a few ulps, more where the terms cancel; the
    # tolerance of the JAX package's own Pallas-vs-jnp LAMB test
    for got, want in ((tu, ru), (tm, rm), (tv, rv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# -- stage 2 --------------------------------------------------------------------

@pytest.mark.parametrize("half", [None, torch.bfloat16, torch.float16])
def test_stage2_matches_pallas(half):
    tensors = _list(_tree(2))
    lay = ChunkedFlatLayout(tensors)
    rs = np.random.RandomState(3)
    p = lay.pack(tensors)
    u = _t(rs.randn(lay.total).astype(f32))
    ratio = _t(np.abs(rs.randn(lay.num_tensors)).astype(f32) + 0.5)
    ratio_flat = lay.expand_per_tensor(ratio)
    ref = pl_lamb.lamb_stage2(jnp.asarray(p.numpy()), jnp.asarray(u.numpy()),
                              jnp.asarray(ratio_flat.numpy()), f32(0.01))
    th = None if half is None else torch.empty(lay.total, dtype=half)
    tp = p.clone()
    ops.lamb_stage2(tp, u, ratio, lay.chunk_table("cpu"), 0.01, half=th)
    want = p.numpy() - (f32(0.01) * ratio_flat.numpy()) * u.numpy()
    np.testing.assert_array_equal(tp.numpy(), want)
    # XLA may contract p - (lr*ratio)*u into one FMA: one rounding apart
    np.testing.assert_allclose(tp.numpy(), np.asarray(ref), rtol=2.0 ** -23,
                               atol=1e-7)
    if half is not None:
        assert torch.equal(th, tp.to(half))


def test_noop_flag_leaves_every_buffer_unchanged():
    rs = np.random.RandomState(5)
    g, p, m, v, u = (_t(rs.randn(1027).astype(f32)) for _ in range(5))
    tensors = [p[:1000].clone(), p[1000:].clone()]
    lay = ChunkedFlatLayout(tensors)
    before = [t.clone() for t in (g, p, m, v, u)]
    one = torch.ones(())
    ops.lamb_stage1(g, p, m, v, 0.5, 2.0, 3.0, 0.9, 0.999, 0.1, 1e-6, 0.01,
                    True, noop=one, out=u)
    half = torch.zeros(1027, dtype=torch.bfloat16)
    ops.lamb_stage2(p, u, torch.ones(2), lay.chunk_table("cpu"), 0.1,
                    half=half, noop=one)
    for a, b in zip((g, p, m, v, u), before):
        assert torch.equal(a, b)
    assert torch.equal(half, torch.zeros_like(half))


# -- per-tensor norms -------------------------------------------------------------

def test_chunked_layout_matches_jax():
    tree = _tree(6)
    tree["z"] = np.random.RandomState(7).randn(129).astype(f32)
    jl = JLayout({k: jnp.asarray(a) for k, a in tree.items()})
    tensors = _list(tree)
    lay = ChunkedFlatLayout(tensors)
    assert lay.num_tensors == jl.num_tensors == len(SHAPES)
    assert lay.chunk == jl.chunk == 1024
    flat = lay.pack(tensors)
    jflat = jl.pack({k: jnp.asarray(a) for k, a in tree.items()})
    # the port's buffer is dense; the JAX package pads each tensor
    assert lay.total == sum(a.size for a in tree.values())
    assert jl.total == sum(-(-a.size // 1024) * 1024 for a in tree.values())
    # per-chunk sums summed in chunk order on both sides, in other orders
    # within a chunk
    np.testing.assert_allclose(lay.per_tensor_sqsum(flat).numpy(),
                               np.asarray(jl.per_tensor_sqsum(jflat)),
                               rtol=1e-6)
    vals = np.arange(1, lay.num_tensors + 1, dtype=f32)
    dense = lay.expand_per_tensor(_t(vals)).numpy()
    padded = np.asarray(jl.expand_per_tensor(jnp.asarray(vals)))
    for (o, n), jo in zip(lay.spans(), jl.offsets):
        np.testing.assert_array_equal(dense[o:o + n], padded[jo:jo + n])
    for got, want in zip(lay.unpack(flat), tensors):
        assert torch.equal(got, want)


def test_flatten_helpers_match_jax():
    # the module (the package exports a function of the same name)
    jf = importlib.import_module("apex_tpu.multi_tensor_apply.flatten")
    rs = np.random.RandomState(17)
    arrays = [rs.randn(3, 2).astype(f32), rs.randn(5).astype(np.float16),
              rs.randn(4).astype(f32), rs.randint(0, 9, (2,)).astype(np.int32)]
    tensors = [_t(a) for a in arrays]
    flat = mta.flatten([tensors[0], tensors[2]])
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jf.flatten([jnp.asarray(arrays[0]),
                                              jnp.asarray(arrays[2])])))
    back = mta.unflatten(flat, [tensors[0], tensors[2]])
    assert all(torch.equal(a, b) for a, b in zip(back, (tensors[0],
                                                        tensors[2])))
    with pytest.raises(TypeError):
        mta.flatten(tensors[:2])
    groups = mta.split_by_dtype(tensors)
    jgroups = jf.split_by_dtype([jnp.asarray(a) for a in arrays])
    assert [[i for i, _ in g] for g in groups.values()] == \
        [[i for i, _ in g] for g in jgroups.values()]
    tf = mta.TreeFlattener(tensors)
    packed = tf.pack(tensors)
    jpacked = jf.TreeFlattener([jnp.asarray(a) for a in arrays]).pack(
        [jnp.asarray(a) for a in arrays])
    for (dt, buf), jbuf in zip(packed.items(), jpacked.values()):
        assert buf.dtype == dt
        np.testing.assert_array_equal(buf.float().numpy(),
                                      np.asarray(jbuf, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(tf.unpack(packed),
                                                 tensors))


@pytest.mark.parametrize("pallas", [False, True])
def test_per_tensor_l2norm_matches_jax(monkeypatch, pallas):
    if pallas:
        monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    tree = _tree(8)
    jnorm, jper = jax_mt.multi_tensor_l2norm(
        {k: jnp.asarray(a) for k, a in tree.items()}, per_tensor=True)
    norm, per = mta.multi_tensor_l2norm(_list(tree), per_tensor=True)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-6)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert float(per[-1]) == 0.0                    # the zero tensor
    assert mta.multi_tensor_l2norm(_list(tree))[1] is None


def test_per_tensor_kernel_plain_version_sums_chunk_by_chunk():
    # sizes around the chunk, and a tensor of length 0
    sizes = [1, 1023, 1025, 3 * 1024, 0, 5]
    rs = np.random.RandomState(9)
    x = rs.randn(sum(sizes)).astype(f32)
    lay = ChunkedFlatLayout([torch.zeros(n) for n in sizes])
    table = lay.chunk_table("cpu")
    assert table.chunks[:, 2].max() <= 1024
    assert table.bounds.tolist() == [0, 1, 2, 4, 7, 7, 8]
    got = ops.multi_tensor_l2norm_per_tensor(_t(x), table).numpy()
    want = [np.sum(x[o:o + n].astype(np.float64) ** 2) for o, n in
            lay.spans()]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert ops.multi_tensor_l2norm_per_tensor.launches == 0   # no kernel here


# -- FusedLAMB ------------------------------------------------------------------

def _jax_lamb(params, grads_seq, **kw):
    opt = JFusedLAMB(**kw)
    st = opt.init(params)
    for grads in grads_seq:
        params, st = opt.step(params, st, grads)
    return params, st


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_lamb_matches_jax(monkeypatch, clip, adam_w_mode):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    params = _tree(10)
    # grads far above max_grad_norm 1.0 (clipping active) or far below
    scale = 1.0 if clip else 1e-3
    grads = [_tree(11 + i, scale, zero="a") for i in range(2)]
    kw = dict(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode)
    jp, jst = _jax_lamb({k: jnp.asarray(a) for k, a in params.items()},
                        [{k: jnp.asarray(a) for k, a in g.items()}
                         for g in grads], **kw)
    gnorm = np.sqrt(sum(np.sum(a.astype(np.float64) ** 2)
                        for a in grads[0].values()))
    assert (gnorm > 1.0) == clip

    tensors = _list(params)
    lay = ChunkedFlatLayout(tensors)
    flat = lay.pack(tensors)
    opt = optimizers.FusedLAMB(**kw)
    st = opt.init(flat, lay)
    for g in grads:
        opt.step(flat, st, lay.pack(_list(g)))
    assert int(st.step) == int(jst.step) == 2
    # the kernels' arithmetic on both sides; XLA contracts the moments'
    # updates into FMAs and sums the norms in other orders (the tolerance
    # of the JAX package's Pallas-vs-jnp LAMB test)
    for k, got in zip(sorted(params), lay.unpack(flat)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the zero tensor moved by its update alone (unit trust ratio)
    assert np.all(np.asarray(jp["z"]) != 0.0)
    back = lamb_state_to_jax(st)
    for k in ("m", "v"):
        np.testing.assert_allclose(back[k], np.asarray(getattr(jst, k).buf),
                                   rtol=1e-5, atol=1e-6)


def test_lamb_state_round_trip_bitwise():
    params = {k: jnp.asarray(a) for k, a in _tree(12).items()}
    grads = {k: jnp.asarray(a) for k, a in _tree(13).items()}
    _, jst = _jax_lamb(params, [grads])
    lay = ChunkedFlatLayout(_list(_tree(12)))
    st = lamb_state_from_jax({"step": np.asarray(jst.step),
                              "m": np.asarray(jst.m.buf),
                              "v": np.asarray(jst.v.buf)}, lay)
    assert int(st.step) == 1 and st.m.layout is lay
    back = lamb_state_to_jax(st)
    for k in ("m", "v"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jst, k).buf))
    assert int(back["step"]) == 1
    # the JAX state rebuilt from it steps as the original does
    jl = jst.m.layout
    again = JLambState(step=jnp.asarray(back["step"]),
                       m=JChunkedFlat(jnp.asarray(back["m"]), jl),
                       v=JChunkedFlat(jnp.asarray(back["v"]), jl))
    opt = JFusedLAMB()
    a, _ = opt.step(params, jst, grads)
    b, _ = opt.step(params, again, grads)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_found_inf_step_changes_nothing():
    tensors = _list(_tree(14))
    lay = ChunkedFlatLayout(tensors)
    flat = lay.pack(tensors)
    opt = optimizers.FusedLAMB(lr=1e-2)
    st = opt.init(flat, lay)
    opt.step(flat, st, lay.pack(_list(_tree(15))))
    half = flat.to(torch.bfloat16)
    before = [t.clone() for t in (flat, st.m.buf, st.v.buf, st.step, half)]
    bad = lay.pack(_list(_tree(16)))
    bad[5] = float("inf")
    opt.step(flat, st, bad, half=half, noop=torch.ones(()))
    for a, b in zip((flat, st.m.buf, st.v.buf, st.step, half), before):
        assert torch.equal(a, b)
    assert int(st.step) == 1


def test_fused_lamb_needs_the_layout_of_its_buffer():
    lay = ChunkedFlatLayout([torch.zeros(3), torch.zeros(4)])
    assert not optimizers.FusedLAMB.elementwise
    with pytest.raises(ValueError):
        optimizers.FusedLAMB().init(torch.zeros(8), lay)
    with pytest.raises(RuntimeError):
        optimizers.FusedLAMB(amsgrad=True)
