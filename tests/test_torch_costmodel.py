"""The port's cost model (``apex_tpu_torch/observability/costmodel.py``)
against the JAX package's (``apex_tpu/observability/costmodel.py``).

One O2 training step (scaled_grad and the FusedAdam step) of a tiny
ResNet (its stem a strided, padded convolution, whose dgrad and wgrad are
priced by valid positions), BERT and GPT, from the same weights: the
port's ``count_cost`` of the eager step against ``jaxpr_cost`` of the
JAX step's jaxpr (the JAX package's CPU paths: dense attention, the jnp
optimizer).

- ``matmul_flops`` and ``matmul_flops_by_dtype`` are equal, exactly: the
  convolutions, the linears, the fused head's fp32-result products (in
  their operands' dtype), and the attention at the dense path's
  convention, which the flash kernels declare.
- ``flops`` within 10 %, ``transcendentals`` within 25 %, bytes within
  40 % (measured: ResNet +6.1 %, 0 %, -30.5 %; BERT +1.3 %, +15.3 %,
  -9.6 %; GPT +2.2 %, +18.4 %, -6.4 %).  The rest is not the same
  program: the eager step runs operators a jit would drop, torch's GELU
  and softmax backward are priced by their JAX lowerings' counts, and
  the JAX package's flat optimizer reads and writes its buffers through
  concatenates and slices that the port's in-place kernels do not have.

The kernels: each wrapper is priced as what the cost model counts of its
plain version (flops, transcendentals and bytes exactly), as one entry,
the flash kernels at the JAX dense path's count, which they declare; and
one step counts the same with its kernels' plain versions running (the
CPU) as with them stubbed out where they compute (the card, where they
do not run: the count prices the plain version on meta tensors).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu.nn import functional as JF
from apex_tpu.observability import costmodel as JC
from apex_tpu.transformer.attention import dot_product_attention

from apex_tpu_torch import amp, models, ops, optimizers
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.observability import costmodel as C
from apex_tpu_torch.ops.multi_tensor import ChunkTable
from apex_tpu_torch.utils.jax_interop import params_from_jax

import torch_threads  # noqa: F401  (one torch thread a process)

FLOPS_RTOL, TRANSC_RTOL, BYTES_RTOL = 0.10, 0.25, 0.40
BERT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, head_chunk=48)
GPT_CFG = dict(vocab_size=64, block_size=16, n_layer=2, n_head=4,
               n_embd=32, dropout=0.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _resnet():
    jnet = jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                          num_classes=10)
    params, state = jnet.init(jax.random.PRNGKey(0))
    params, state = _np_tree(params), _np_tree(state)
    jm, jopt = jamp.initialize(jnet, joptim.FusedAdam(lr=1e-5),
                               opt_level="O2", verbosity=0)
    jp = jm.cast_params(jax.tree_util.tree_map(jnp.asarray, params))
    js = jax.tree_util.tree_map(jnp.asarray, state)
    jost = jopt.init(jp)
    tm = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                       device="cpu")
    tm.load_state_dict(params_from_jax(params, state), strict=True)
    tm, topt = amp.initialize(tm, optimizers.FusedAdam(lr=1e-5),
                              opt_level="O2", verbosity=0)
    rs = np.random.RandomState(1)
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.int32)

    def jstep(p, st, ost):
        def loss_fn(pp):
            out, new_st = jm.apply(pp, jnp.asarray(x), state=st, train=True)
            return JF.cross_entropy(out, jnp.asarray(y)), new_st
        loss, new_st, g = jamp.scaled_grad(loss_fn, p, ost, has_aux=True)
        return jopt.step(p, ost, g), new_st, loss

    tx, ty = _t(x), _t(y).long()

    def tstep():
        loss, g = amp.scaled_grad(lambda: cross_entropy(tm(tx), ty), topt)
        topt.step(g)
    return jax.make_jaxpr(jstep)(jp, js, jost), tstep


def _bert():
    jnet = jmodels.BertForPretraining(jmodels.BertConfig(**BERT_CFG))
    params = _np_tree(jnet.init(jax.random.PRNGKey(0))[0])
    jm, jopt = jamp.initialize(jnet, joptim.FusedAdam(lr=1e-5),
                               opt_level="O2", verbosity=0)
    jp = jm.cast_params(jax.tree_util.tree_map(jnp.asarray, params))
    jost = jopt.init(jp)
    tm = models.BertForPretraining(models.BertConfig(**BERT_CFG),
                                   device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    tm, topt = amp.initialize(tm, optimizers.FusedAdam(lr=1e-5),
                              opt_level="O2", verbosity=0)
    rs = np.random.RandomState(1)
    B, T = 4, 16
    ids = rs.randint(5, BERT_CFG["vocab_size"], (B, T))
    mask = rs.rand(B, T) < 0.15
    labels = np.where(mask, ids, -100).astype(np.int32)
    nsp = rs.randint(0, 2, (B,)).astype(np.int32)
    attn = np.ones((B, T), np.int32)
    attn[1, -4:] = 0
    ids = ids.astype(np.int32)

    def jstep(p, ost):
        loss, g = jamp.scaled_grad(lambda pp: jm.loss(
            pp, *map(jnp.asarray, (ids, labels, nsp)),
            attention_mask=jnp.asarray(attn)), p, ost)
        return jopt.step(p, ost, g)

    def tstep():
        loss, g = amp.scaled_grad(lambda: tm.loss(
            *map(_t, (ids, labels, nsp)), attention_mask=_t(attn)), topt)
        topt.step(g)
    return jax.make_jaxpr(jstep)(jp, jost), tstep


def _gpt():
    jnet = jmodels.GPT(jmodels.GPTConfig(**GPT_CFG))
    params = _np_tree(jnet.init(jax.random.PRNGKey(0))[0])
    jm, jopt = jamp.initialize(jnet, joptim.FusedAdam(lr=1e-5),
                               opt_level="O2", verbosity=0)
    jp = jm.cast_params(jax.tree_util.tree_map(jnp.asarray, params))
    jost = jopt.init(jp)
    tm = models.GPT(models.GPTConfig(**GPT_CFG), device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    tm, topt = amp.initialize(tm, optimizers.FusedAdam(lr=1e-5),
                              opt_level="O2", verbosity=0)
    ids = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32)

    def jstep(p, ost):
        loss, g = jamp.scaled_grad(lambda pp: jm.loss(pp, jnp.asarray(ids)),
                                   p, ost)
        return jopt.step(p, ost, g)

    def tstep():
        loss, g = amp.scaled_grad(lambda: tm.loss(_t(ids)), topt)
        topt.step(g)
    return jax.make_jaxpr(jstep)(jp, jost), tstep


STEPS = {"resnet": _resnet, "bert": _bert, "gpt": _gpt}


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1.0)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_counts_match_jaxpr_cost(name):
    jaxpr, tstep = STEPS[name]()
    want = JC.jaxpr_cost(jaxpr)
    got = C.count_cost(tstep)
    assert got.matmul_flops == want.matmul_flops
    assert got.matmul_flops_by_dtype == want.matmul_flops_by_dtype
    assert got.dominant_matmul_dtype == want.dominant_matmul_dtype
    assert got.fp32_matmul_fraction() == want.fp32_matmul_fraction()
    assert _rel(got.flops, want.flops) <= FLOPS_RTOL
    assert _rel(got.transcendentals, want.transcendentals) <= TRANSC_RTOL
    assert _rel(got.bytes_accessed, want.bytes_accessed) <= BYTES_RTOL
    assert got.unknown_prims == {}
    rec, jrec = got.to_record(), want.to_record()
    assert set(rec) == set(jrec) - {"while_loops"}


def _stubbed(fn, tstep):
    """``tstep`` with every kernel wrapper's plain version replaced by one
    that makes its outputs and does nothing else."""
    from apex_tpu_torch.ops import (adam, flash_attention, layer_norm,
                                    multi_tensor, syncbn)
    stubs = {
        (multi_tensor, "_scale_plain"):
            lambda x, s, out: (out, torch.zeros(())),
        (multi_tensor, "_l2norm_plain"): lambda x: torch.zeros(()),
        (adam, "_adam_plain"): lambda *a: None,
        (syncbn, "_fwd_plain"): lambda x, *a: torch.empty_like(x),
        (syncbn, "_bwd_plain"): lambda dy, x, *a: (
            torch.empty_like(dy), torch.zeros(dy.shape[:2]),
            torch.zeros(dy.shape[:2])),
        (layer_norm, "_fwd_plain"): lambda x2, w, b, eps: (
            torch.empty_like(x2), torch.zeros(x2.shape[0]),
            torch.ones(x2.shape[0])),
        (layer_norm, "_bwd_plain"): lambda dy, x2, w, m, i: (
            torch.empty_like(x2), torch.zeros(x2.shape[1]),
            torch.zeros(x2.shape[1])),
        (flash_attention, "_fwd_plain"): lambda q3, *a: (
            torch.zeros_like(q3), torch.zeros(q3.shape[:2])),
        (flash_attention, "_dq_plain"): lambda q3, *a: torch.zeros_like(q3),
        (flash_attention, "_dkv_plain"): lambda q3, k3, v3, *a: (
            torch.zeros_like(k3), torch.zeros_like(v3)),
    }
    def on_data(orig, stub):
        # the count's meta run of the plain version stays; the run that
        # computes (on the CPU here) is stubbed out, as on the card
        def call(*a, **k):
            meta = any(isinstance(t, torch.Tensor) and t.is_meta
                       for t in a)
            return (orig if meta else stub)(*a, **k)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for (mod, attr), stub in stubs.items():
            mp.setattr(mod, attr, on_data(getattr(mod, attr), stub))
        return fn(tstep)


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_step_counts_alike_without_the_plain_versions(name):
    """The count with the kernels' plain versions running (the CPU) and
    with them stubbed out (as on the card, where none runs) is the same:
    the priced wrappers hide their bodies."""
    _, tstep = STEPS[name]()
    got = C.count_cost(tstep)
    _, tstep2 = STEPS[name]()
    stub = _stubbed(C.count_cost, tstep2)
    for f in ("flops", "transcendentals", "bytes_accessed", "matmul_flops",
              "matmul_flops_by_dtype", "flops_by_prim"):
        assert getattr(got, f) == getattr(stub, f), f


def _plain_count(fn):
    """The cost model's count of ``fn`` with the wrappers not priced: their
    bodies (on the CPU, the plain versions) counted operator by
    operator."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "_kernel_hook",
                   lambda wrapper, body, cost, args, kwargs: body(*args,
                                                                  **kwargs))
        return C.count_cost(fn)


def _f32(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(n)
                            .astype(np.float32))


N = 3000
_ONE = torch.ones(())


def _tables():
    return (ChunkTable.build([(0, 1024), (1024, 1976)], 8, "cpu"),
            ChunkTable.build([(0, 1000), (1000, 2000)], 64, "cpu"))


# each: the wrapper and a maker of its arguments (made outside the count)
WRAPPER_CALLS = {
    "scale": (ops.multi_tensor_scale, lambda: ((_f32(N), 0.5), {})),
    "axpby": (ops.multi_tensor_axpby,
              lambda: ((0.5, 2.0, _f32(N), _f32(N, 1)), {})),
    "axpby_x": (ops.multi_tensor_axpby,
                lambda: ((0.5, 2.0, _f32(N), _f32(N, 1), 0), {})),
    "l2norm": (ops.multi_tensor_l2norm, lambda: ((_f32(N),), {})),
    "l2norm_per_tensor": (ops.multi_tensor_l2norm_per_tensor,
                          lambda: ((_f32(N), _tables()[0]), {})),
    "adam": (ops.fused_adam, lambda: ((
        _f32(N), _f32(N), _f32(N), _f32(N), _ONE, _ONE, 0.9, 0.999, 1e-8,
        False, 0.0), {})),
    "adam_half_noop": (ops.fused_adam, lambda: ((
        _f32(N), _f32(N), _f32(N), _f32(N), _ONE, _ONE, 0.9, 0.999, 1e-8,
        False, 0.01), {"half": torch.zeros(N, dtype=torch.bfloat16),
                       "noop": torch.zeros(())})),
    "lamb1": (ops.lamb_stage1, lambda: ((
        _f32(N), _f32(N), _f32(N), _f32(N), _ONE, _ONE, _ONE, 0.9, 0.999,
        0.1, 1e-6, 0.01, True), {})),
    "lamb1_noop": (ops.lamb_stage1, lambda: ((
        _f32(N), _f32(N), _f32(N), _f32(N), _ONE, _ONE, _ONE, 0.9, 0.999,
        0.1, 1e-6, 0.0, True), {"noop": torch.zeros(())})),
    "lamb2_half": (ops.lamb_stage2, lambda: ((
        _f32(N), _f32(N), torch.ones(2), _tables()[1], _ONE),
        {"half": torch.zeros(N, dtype=torch.bfloat16)})),
    "syncbn_fwd_bf16": (ops.syncbn_fwd, lambda: ((
        torch.rand(2, 4, 6, 5).bfloat16(), *[torch.rand(4)] * 4), {})),
    "syncbn_bwd_fp32": (ops.syncbn_bwd, lambda: ((
        torch.rand(2, 4, 6, 5), torch.rand(2, 4, 6, 5),
        *[torch.rand(4)] * 3), {})),
    "layer_norm_fwd_bf16": (ops.layer_norm_fwd, lambda: ((
        torch.rand(30, 48).bfloat16(), torch.rand(48), torch.rand(48),
        1e-5), {})),
    "layer_norm_bwd_fp32": (ops.layer_norm_bwd, lambda: ((
        torch.rand(30, 48), torch.rand(30, 48), torch.rand(48),
        torch.rand(30), torch.rand(30)), {})),
}


@pytest.mark.parametrize("call", sorted(WRAPPER_CALLS))
def test_declared_cost_is_the_plain_versions_count(call):
    """Each wrapper is priced at exactly what the cost model counts of its
    plain version run on the CPU; the count is one entry, the
    wrapper's."""
    fn, make = WRAPPER_CALLS[call]
    args, kw = make()
    got = C.count_cost(fn, *args, **kw)
    args, kw = make()
    plain = _plain_count(lambda: fn(*args, **kw))
    assert (got.flops, got.transcendentals, got.bytes_accessed) == \
        (plain.flops, plain.transcendentals, plain.bytes_accessed)
    assert got.eqns == 1
    assert list(got.flops_by_prim) == [f"kernel:{fn.__name__}"]


@pytest.mark.parametrize("B,H,T,D,causal", [(2, 3, 16, 8, False),
                                            (1, 2, 32, 16, True),
                                            (2, 2, 8, 32, True)])
def test_flash_declares_the_dense_paths_count(B, H, T, D, causal):
    """The convention: the flash kernels declare what ``jaxpr_cost``
    counts of the JAX package's dense attention on the same shapes — the
    full (T, T) scores, causal or not; the forward's two matmuls and
    elementwise work to ``flash_fwd``, the backward's four matmuls to
    ``flash_dq`` (dP, dQ, and the softmax backward's elementwise work)
    and ``flash_dkv`` (dV, dK).  Flops and transcendentals are equal;
    the matmuls are in q's dtype."""
    from apex_tpu_torch import transformer
    rs = np.random.RandomState(0)
    arrs = [rs.randn(B, H, T, D).astype(np.float32) for _ in range(4)]
    jq = [jnp.asarray(a, jnp.bfloat16) for a in arrs]

    def f(q, k, v):
        return dot_product_attention(q, k, v, causal=causal)
    fwd = JC.jaxpr_cost(jax.make_jaxpr(f)(*jq[:3]))
    vjp = JC.jaxpr_cost(jax.make_jaxpr(
        lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))(*jq))
    tq = [_t(a).bfloat16().requires_grad_(True) for a in arrs[:3]]

    def tf():
        return transformer.dot_product_attention(*tq, causal=causal)
    tfwd = C.count_cost(tf)
    out = tf()
    tbwd = C.count_cost(lambda: torch.autograd.grad(
        out, tq, _t(arrs[3]).bfloat16()))
    assert tfwd.flops_by_prim.keys() >= {"kernel:flash_fwd"}
    ffwd = tfwd.flops_by_prim["kernel:flash_fwd"]
    fbwd = tbwd.flops_by_prim["kernel:flash_dq"] \
        + tbwd.flops_by_prim["kernel:flash_dkv"]
    assert tfwd.matmul_flops == fwd.matmul_flops
    assert tfwd.matmul_flops_by_dtype == fwd.matmul_flops_by_dtype
    # the vjp's jaxpr holds the forward again, less its dead P·V product
    assert tbwd.matmul_flops == vjp.matmul_flops - fwd.matmul_flops / 2
    assert ffwd == fwd.flops
    assert fbwd == vjp.flops - fwd.flops + fwd.matmul_flops / 2
    s = B * H * T * T
    assert tfwd.transcendentals == fwd.transcendentals == s
    assert tbwd.transcendentals == 0


def test_conv_flops_valid_position_counting():
    """A strided, padded convolution's forward, dgrad and wgrad each count
    its valid positions: XLA's and the JAX package's count, not the full
    window's."""
    x = jnp.ones((1, 64, 8, 8), jnp.bfloat16)
    w = jnp.ones((64, 64, 3, 3), jnp.bfloat16)

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
    want_fwd = JC.jaxpr_cost(jax.make_jaxpr(conv)(x, w)).matmul_flops
    want_bwd = JC.jaxpr_cost(jax.make_jaxpr(lambda x, w: jax.grad(
        lambda x, w: conv(x, w).astype(jnp.float32).sum(),
        argnums=(0, 1))(x, w))(x, w)).matmul_flops
    tx = torch.ones(1, 64, 8, 8, dtype=torch.bfloat16, requires_grad=True)
    tw = torch.ones(64, 64, 3, 3, dtype=torch.bfloat16, requires_grad=True)
    got_fwd = C.count_cost(lambda: torch.nn.functional.conv2d(
        tx, tw, stride=2, padding=1))
    out = torch.nn.functional.conv2d(tx, tw, stride=2, padding=1)
    got_bwd = C.count_cost(lambda: torch.autograd.grad(
        out.float().sum(), (tx, tw)))
    assert got_fwd.matmul_flops == want_fwd
    # the grad's jaxpr drops the forward product (dead under grad-of-sum)
    assert got_bwd.matmul_flops == want_bwd
    # the dgrad and the wgrad each cost the forward
    assert got_bwd.matmul_flops == 2 * got_fwd.matmul_flops
    full = 2 * 64 * 64 * 9 * 4 * 4
    assert got_fwd.matmul_flops < full


def test_peak_flops_and_mfu():
    for arch, dt in (("cpu", "bfloat16"), ("cpu", "float32"),
                     ("CPU", "float64"), ("cpu", "int8")):
        assert C.peak_flops(arch, dt) == JC.peak_flops(arch, dt)
        assert C.mfu(1e9, 0.5, arch, dt) == JC.mfu(1e9, 0.5, arch, dt)
    h100 = "NVIDIA H100 80GB HBM3"
    assert C.peak_flops(h100, "bfloat16") == 989.4e12
    assert C.peak_flops(h100, torch.float16) == 989.4e12
    assert C.peak_flops(h100, "tf32") == 494.7e12
    assert C.peak_flops(h100, "float32") == 66.9e12
    assert C.peak_flops("some other card", "bfloat16") is None
    m = C.mfu(98.94e12 * 0.02, 0.02, h100, "bfloat16")
    assert m["mfu"] == pytest.approx(0.1) and m["mfu_dtype"] == "bfloat16"
    assert C.mfu(1.0, 1.0, "unknown", "bfloat16")["mfu"] is None
