"""The T5 encoder-decoder of the port against the JAX package on the CPU.

A tiny ``T5`` (vocab 128, width 32, d_kv 8, 2 + 2 layers, 4 heads, 8
buckets out to distance 20) is built from the JAX package's ``init`` and
carried over by ``utils.jax_interop``; both sides see the same numpy
batch.  The relative-position buckets are held bitwise; fp32 logits, loss
and grads at rtol 1e-5; greedy tokens exactly; the serving slots' state
and logits at rtol 1e-5; three O2 + FusedAdam steps at the BERT tests'
tolerances.  T5's attention never takes the flash route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import optimizers as joptim
from apex_tpu.models import t5 as jt5

from apex_tpu_torch import amp, models, optimizers, parallel, transformer
from apex_tpu_torch.models import t5 as tt5
from apex_tpu_torch.utils.jax_interop import (kv_cache_from_jax,
                                              kv_cache_to_jax, params_from_jax,
                                              params_to_jax)

CFG = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
           num_heads=4, relative_attention_num_buckets=8,
           relative_attention_max_distance=20, dropout_rate=0.0)
B, TS, TT = 2, 12, 7
LR = 1e-4
STEPS = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _paths(tree):
    return {'.'.join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=1e-5):
    """Within rtol of each element, or of the tensor's largest magnitude
    (a grad near zero is a difference of larger terms)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(
        2, CFG["vocab_size"], shape).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """JAX weights of the relu/tied and gated-gelu/untied configs, the
    RMSNorm weights moved off ones so they count, at a scale whose
    logits spread (the N(0, 1) tables would saturate the softmax)."""
    out = {}
    for ff, tie in (("relu", True), ("gated-gelu", False)):
        cfg = jt5.T5Config(**CFG, feed_forward_proj=ff,
                           tie_word_embeddings=tie)
        params, _ = jt5.T5(cfg).init(jax.random.PRNGKey(0))
        rs = np.random.RandomState(1)
        out[ff] = jax.tree_util.tree_map(
            lambda a: np.asarray(a) * np.float32(0.5) + np.float32(0.02)
            * rs.randn(*a.shape).astype(np.float32), params)
    return out


def _pair(weights, ff="relu"):
    tie = ff == "relu"
    cfg = dict(CFG, feed_forward_proj=ff, tie_word_embeddings=tie)
    jm = jt5.T5(jt5.T5Config(**cfg))
    tm = models.T5(models.T5Config(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(weights[ff]), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, weights[ff]), tm


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 20)])
def test_buckets_bitwise(bidirectional, buckets, distance):
    """Every relative position in [-512, 512]: the same bucket as the JAX
    function's fp32 log formula."""
    rel = np.arange(-512, 513)
    want = np.asarray(jt5._relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, buckets, distance))
    got = tt5._relative_position_bucket(_t(rel), bidirectional, buckets,
                                        distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_weights_carry_both_ways(weights):
    for ff in ("relu", "gated-gelu"):
        _, _, tm = _pair(weights, ff)
        back, state = params_to_jax(tm.state_dict())
        assert not state
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(weights[ff])
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(weights[ff])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # one bias table a stack, in layer 0
    tables = [n for n in tm.state_dict() if "relative_attention_bias" in n]
    assert tables == ["enc_blocks.0.attn.relative_attention_bias.weight",
                      "dec_blocks.0.self_attn.relative_attention_bias."
                      "weight"]


# fp32 on both sides; the sums run in other orders
@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_logits_loss_and_grads_match_jax(weights, ff, with_mask):
    jm, jp, tm = _pair(weights, ff)
    ids, dec = _ids(0, (B, TS)), _ids(1, (B, TT))
    labels = _ids(2, (B, TT))
    labels[1, -2:] = -100                   # ignored positions
    mask = None
    if with_mask:
        mask = np.ones((B, TS), np.int32)
        mask[0, 8:] = 0                     # a padded source row
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    jl = jax.jit(lambda p: jm(p, jnp.asarray(ids), jnp.asarray(dec),
                              jmask))(jp)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(ids), jnp.asarray(labels), jmask)))(jp)
    paths = []
    transformer.set_path_hook(paths.append)
    try:
        tl = tm(_t(ids), _t(dec), tmask)
        tloss = tm.loss(_t(ids), _t(labels), tmask)
        tloss.backward()
        with torch.no_grad():
            tm.generate(_t(ids), 3, tmask)
    finally:
        transformer.set_path_hook(None)
    # dense torch attention throughout: the dispatch never ran
    assert paths == []
    _close(tl.detach().numpy(), jl)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    jgp = _paths(jg)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), jgp[name])


def test_attention_mask_changes_only_what_it_masks(weights):
    """A padded source position changes the logits, and the padded row
    equals the same row run alone at its valid length."""
    _, _, tm = _pair(weights)
    ids, dec = _t(_ids(3, (B, TS))), _t(_ids(4, (B, TT)))
    mask = torch.ones((B, TS), dtype=torch.int32)
    mask[0, 8:] = 0
    with torch.no_grad():
        full = tm(ids, dec)
        masked = tm(ids, dec, mask)
        alone = tm(ids[:1, :8], dec[:1])
    assert not torch.allclose(full[0], masked[0])
    torch.testing.assert_close(masked[1], full[1], rtol=0, atol=0)
    torch.testing.assert_close(masked[0], alone[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_greedy_generate_matches_jax(weights, ff):
    """The cached greedy decode: the JAX package's tokens, and those of an
    uncached argmax loop over the port's own forward."""
    jm, jp, tm = _pair(weights, ff)
    ids = _ids(5, (B, TS))
    mask = np.ones((B, TS), np.int32)
    mask[1, 5:] = 0
    want = np.asarray(jax.jit(lambda p: jm.generate(
        p, jnp.asarray(ids), 10, jnp.asarray(mask)))(jp))
    got = tm.generate(_t(ids), 10, _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    dec = torch.zeros((B, 1), dtype=torch.int64)
    with torch.no_grad():
        for _ in range(10):
            nxt = tm(_t(ids), dec, _t(mask))[:, -1].argmax(-1)
            dec = torch.cat([dec, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(dec[:, 1:].numpy(), want)


def test_decode_step_rows_matches_jax(weights):
    """Slots seeded one request each, then decoder steps at per-row
    positions: the state (cross K/V, decoder caches, source masks) and
    the logits equal the JAX package's."""
    jm, jp, tm = _pair(weights)
    slots, src_len, dec_len = 3, 10, 8
    srcs = _ids(6, (slots, src_len))
    n_src = (10, 4, 7)
    js = jm.init_seq2seq_state(slots, src_len, dec_len)
    ts = tm.init_seq2seq_state(slots, src_len, dec_len)
    jseed = jax.jit(jm.seed_slot_seq2seq)
    jdecode = jax.jit(jm.decode_step_rows)
    for slot in (2, 0, 1):
        js = jseed(jp, js, slot, jnp.asarray(srcs[slot]), n_src[slot])
        ts = tm.seed_slot_seq2seq(ts, slot, _t(srcs[slot]), n_src[slot])
    toks = _ids(7, (4, slots))
    pos = np.asarray([[0, 0, 0], [1, 1, 1], [2, 1, 2], [3, 2, 5]], np.int32)
    for tok, p in zip(toks, pos):
        jl, js = jdecode(jp, jnp.asarray(tok), jnp.asarray(p), js)
        tl, ts = tm.decode_step_rows(_t(tok), _t(p), ts)
        _close(tl.numpy(), jl)
    want = kv_cache_to_jax(kv_cache_from_jax(
        jax.tree_util.tree_map(np.asarray, js)))
    got = kv_cache_to_jax(ts)
    np.testing.assert_array_equal(got["src_mask"], want["src_mask"])
    for part in ("cross", "dec"):
        for li in want[part]:
            for name in ("k", "v"):
                _close(got[part][li][name], want[part][li][name])


# O2 + FusedAdam through the functional step and make_step, against the
# JAX package's scaled_grad + step: the BERT tests' tolerances (bf16
# matmuls round apart: losses rtol 1e-2; FusedAdam moves a weight by about
# lr a step, so masters within 2*lr a step)
def test_o2_fused_adam_steps_match_jax(weights):
    ids, labels = _ids(8, (B, TS)), _ids(9, (B, TT))
    cfg = dict(CFG, feed_forward_proj="relu")
    jm = jt5.T5(jt5.T5Config(**cfg))
    jmodel, jopt = jamp.initialize(jm, joptim.FusedAdam(lr=LR),
                                   opt_level="O2", verbosity=0)
    params = jmodel.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                       weights["relu"]))
    ost = jopt.init(params)

    @jax.jit
    def jstep(params, ost):
        loss, _, grads = jamp.scaled_grad(
            lambda p: (jmodel.loss(p, jnp.asarray(ids),
                                   jnp.asarray(labels)), ()),
            params, ost, has_aux=True)
        params, ost, _ = jopt.step(params, ost, grads)
        return params, ost, loss

    jl = []
    for _ in range(STEPS):
        params, ost, loss = jstep(params, ost)
        jl.append(float(loss))

    tm = models.T5(models.T5Config(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(weights["relu"]))
    model, opt = amp.initialize(tm, optimizers.FusedAdam(lr=LR),
                                opt_level="O2", verbosity=0)
    # the JAX package's O2 keep-fp32 rule: RMSNorm sets no fp32_params
    jdt = {n: np.asarray(a).dtype for n, a in _paths(params).items()}
    for name, p in model.named_parameters():
        assert str(p.dtype).replace("torch.", "") == jdt[name].name, name
    assert model.enc_blocks[0].ln_attn.weight.dtype == torch.bfloat16

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: model.loss(x, y), opt)
        opt.step(grads)
        return loss

    train = parallel.make_step(step, model)
    tl = [float(train((_t(ids), _t(labels)))) for _ in range(STEPS)]
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    tmast, jmast = opt.masters.buf.numpy(), np.asarray(ost.masters.buf)
    atol = 2 * LR * STEPS + 4 * float(np.spacing(np.abs(jmast).max()))
    np.testing.assert_allclose(tmast, jmast, rtol=0, atol=atol)
    assert int(opt.state.step) == int(ost.inner.step) == STEPS


def test_refusals():
    with pytest.raises(ValueError, match="feed_forward_proj"):
        models.T5Config(feed_forward_proj="swiglu")
