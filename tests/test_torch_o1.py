"""amp O1 as a whole: the port against the JAX package on the CPU.

O1 casts no parameter: ``amp.initialize`` installs the process-wide cast
policy, and the ops of ``nn.functional`` cast at their boundaries
(whitelist to the half dtype, blacklist to fp32, promote to the widest).
A tiny BERT (2 layers, width 64, dropout 0) trains three steps under O1 +
FusedAdam in bf16 and a ResNet-18 on 48 x 48 images four steps under O1 +
FusedAdam in fp16 with the dynamic loss scale (one step overflowing), each
from the JAX package's weights (``utils.jax_interop``), against the JAX
package's same run; at 32 x 32, where fp16 rounding swings the run, the
port against the JAX run's spread under a one-ulp move of its input.  The
JAX side runs its Pallas kernels in interpret mode
(``APEX_TPU_FORCE_PALLAS=1``), the port its wrappers' plain versions.
Also: the dtypes O1 gives the LayerNorm and attention inputs, the default
opt level, ``disable_casts`` and the banned ``binary_cross_entropy``.  An
autouse fixture restores ``NoPolicy`` in both packages after every test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import nn as jnn
from apex_tpu import optimizers as joptim
from apex_tpu.amp import policy as JP
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, models, normalization, optimizers
from apex_tpu_torch import nn as tnn
from apex_tpu_torch.amp import policy as P
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.transformer import attention as tattn
from apex_tpu_torch.utils.jax_interop import params_from_jax

STEPS = 3


@pytest.fixture(autouse=True)
def reset_policy():
    yield
    P.set_policy(P.NoPolicy())
    JP.set_policy(JP.NoPolicy())


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _update_gap(port, ref, start) -> float:
    """||dp_port - dp_ref|| / ||dp_ref||: how far the port's update (its
    params less the start) is from the JAX package's, over all params."""
    d_ref = ref.astype(np.float64) - start
    d_port = port.astype(np.float64) - start
    return float(np.linalg.norm(d_port - d_ref) / np.linalg.norm(d_ref))


def _port_flat(model) -> np.ndarray:
    """The port's params in the JAX package's leaf order."""
    by_name = dict(model.named_parameters())
    return np.concatenate([by_name[n].detach().float().numpy().ravel()
                           for n in amp._process_optimizer.jax_leaf_order(
                               by_name)])


# -- BERT ------------------------------------------------------------------------------

BERT_LR = 1e-4
B, T = 4, 32
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0, head_chunk=48)


def _bert_batch(seed=1):
    """examples/bert/main_amp.py's synthetic MLM/NSP batch, padded."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, CFG["vocab_size"], (B, T))
    mask = rs.rand(B, T) < 0.15
    labels = np.where(mask, ids, -100)
    ids = np.where(mask & (rs.rand(B, T) < 0.8), 3, ids)
    nsp = rs.randint(0, 2, (B,))
    attn = np.ones((B, T), np.int32)
    attn[1:3, -5:] = 0
    return (ids.astype(np.int32), labels.astype(np.int32),
            nsp.astype(np.int32), attn)


@pytest.fixture(scope="module")
def bert_weights():
    params, _ = jmodels.BertForPretraining(
        jmodels.BertConfig(**CFG)).init(jax.random.PRNGKey(0))
    return _numpy_tree(params)


@pytest.fixture(scope="module")
def jax_bert_o1(bert_weights):
    """The JAX package's O1 run, under the forced Pallas path."""
    batch = _bert_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_FORCE_PALLAS", "1")
        mp.delenv("APEX_TPU_DISABLE_PALLAS", raising=False)
        ids, labels, nsp, attn = (jnp.asarray(a) for a in batch)
        jmodel, jopt = jamp.initialize(
            jmodels.BertForPretraining(jmodels.BertConfig(**CFG)),
            joptim.FusedAdam(lr=BERT_LR), opt_level="O1", verbosity=0)
        try:
            params = jmodel.cast_params(jax.tree_util.tree_map(
                jnp.asarray, bert_weights))
            ost = jopt.init(params)

            @jax.jit
            def step(params, ost):
                def loss_fn(p):
                    return jmodel.loss(p, ids, labels, nsp,
                                       attention_mask=attn), ()
                loss, _, grads = jamp.scaled_grad(loss_fn, params, ost,
                                                  has_aux=True)
                params, ost, _ = jopt.step(params, ost, grads)
                return params, ost, loss

            losses = []
            for _ in range(STEPS):
                params, ost, loss = step(params, ost)
                losses.append(float(loss))
        finally:
            JP.set_policy(JP.NoPolicy())
    return batch, losses, params, ost


def _port_bert(weights):
    model = models.BertForPretraining(models.BertConfig(**CFG),
                                      device="cpu")
    model.load_state_dict(params_from_jax(weights), strict=True)
    return model


# losses: the matmuls run in bf16 through oneDNN here and XLA there, and
# their bf16 outputs round on each side on their own (measured: 2.4e-4
# relative over three steps).  params: the update (params less the start)
# against the JAX package's, in norm over all params (measured: 0.044);
# FusedAdam moves a weight by about lr a step whatever its grad, so the few
# near-zero grads whose sign flips under another sum order differ by up to
# 2*lr a step.  A missing update gives 1, one of the wrong sign 2.
BERT_UPDATE_GAP = 0.1
def test_bert_o1_training_matches_jax(jax_bert_o1, bert_weights,
                                      monkeypatch):
    batch, jl, jparams, jost = jax_bert_o1
    seen = {"ln": set(), "qkv": set(), "path": []}
    real_flash = tattn.fa.flash_attention

    def flash(q, k, v, **kw):
        seen["qkv"].update((q.dtype, k.dtype, v.dtype))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(tattn.fa, "flash_attention", flash)
    tattn.set_path_hook(seen["path"].append)
    model, opt = amp.initialize(_port_bert(bert_weights),
                                optimizers.FusedAdam(lr=BERT_LR),
                                opt_level="O1", verbosity=0)
    for m in model.modules():
        if isinstance(m, normalization.FusedLayerNorm):
            m.register_forward_pre_hook(
                lambda mod, args: seen["ln"].add(args[0].dtype))
    ids, labels, nsp, attn = (_t(a) for a in batch)
    tl = []
    try:
        for _ in range(STEPS):
            loss = model.loss(ids, labels, nsp, attention_mask=attn)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            opt.zero_grad()
            tl.append(float(loss.detach()))
    finally:
        tattn.set_path_hook(None)
    # O1: fp32 params that are views into the flat buffer, no half copy,
    # a static scale of 1 under bf16 (as the JAX package: no masters)
    assert jost.masters is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not opt.master_weights and opt.masters.half is None
    assert not opt.scaler.dynamic and amp.current_loss_scale(opt) == 1.0
    # the residual adds promote to fp32: every LayerNorm gets fp32; the
    # whitelisted projections hand attention bf16 q, k and v
    assert seen["ln"] == {torch.float32}
    assert seen["qkv"] == {torch.bfloat16}
    assert set(seen["path"]) == {"flash"}
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    tm, jm = _port_flat(model), _flat(jparams)
    assert _update_gap(tm, jm, _flat(bert_weights)) <= BERT_UPDATE_GAP
    np.testing.assert_array_equal(opt.masters.buf.numpy(), tm)
    assert int(opt.state.step) == int(jost.inner.step) == STEPS


def test_bert_o1_forward_dtypes_match_jax(bert_weights, monkeypatch):
    """Under O1 the logits of the dense MLM head come out of the
    whitelisted matmul in bf16 and the NSP logits of the whitelisted
    linear, in both packages."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    ids, _, _, attn = _bert_batch()
    jm = jmodels.BertForPretraining(jmodels.BertConfig(**CFG))
    with JP.use_policy(JP.CastPolicy(jnp.bfloat16)):
        (jl, jn), _ = jax.jit(lambda p, i, a: jnn.apply(
            jm, p, i, attention_mask=a))(
            jax.tree_util.tree_map(jnp.asarray, bert_weights), ids, attn)
    port = _port_bert(bert_weights)
    with P.use_policy(P.CastPolicy(torch.bfloat16)):
        tl, tn = port(_t(ids), attention_mask=_t(attn))
    assert tl.dtype == tn.dtype == torch.bfloat16
    assert str(jl.dtype) == str(jn.dtype) == "bfloat16"
    # bf16 logits from bf16 products that round apart on the two sides
    np.testing.assert_allclose(tl.detach().float().numpy(),
                               np.asarray(jl, np.float32), rtol=0,
                               atol=4 * 2.0 ** -7 * float(
                                   np.abs(np.asarray(jl, np.float32)).max()))


# -- ResNet-18 under O1 fp16, dynamic scale --------------------------------------------

RESNET_LR = 1e-5
RESNET_STEPS = 4
RESNET_INF_STEP = 1       # its batch holds an inf: the step overflows


@pytest.fixture(scope="module")
def resnet_weights():
    params, state = jmodels.resnet18(num_classes=10).init(
        jax.random.PRNGKey(0))
    return _numpy_tree(params), _numpy_tree(state)


def _resnet_batch(seed=1, hw=48):
    """8 images of hw x hw, and the same images with an inf planted."""
    rs = np.random.RandomState(seed)
    x = rs.randn(8, 3, hw, hw).astype(np.float32)
    bad = x.copy()
    bad[0, 0, 0, 0] = np.inf
    return x, bad, rs.randint(0, 10, 8).astype(np.int32)


def _train_jax_resnet(weights, xs, y, opt_level="O1", **kw):
    jmodel, jopt = jamp.initialize(jmodels.resnet18(num_classes=10),
                                   joptim.FusedAdam(lr=RESNET_LR),
                                   opt_level=opt_level, verbosity=0, **kw)
    try:
        params = jmodel.cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                           weights[0]))
        state = jax.tree_util.tree_map(jnp.asarray, weights[1])
        ost = jopt.init(params)

        @jax.jit
        def step(params, state, ost, x):
            def loss_fn(p):
                out, new_state = jmodel.apply(p, x, state=state, train=True)
                return JF.cross_entropy(out, y), new_state
            loss, new_state, grads = jamp.scaled_grad(loss_fn, params, ost,
                                                      has_aux=True)
            params, ost, info = jopt.step(params, ost, grads)
            return params, new_state, ost, loss, info["found_inf"]

        losses, skips = [], []
        for i in range(RESNET_STEPS):
            params, state, ost, loss, found = step(
                params, state, ost, xs[i == RESNET_INF_STEP])
            losses.append(float(loss))
            skips.append(float(found))
    finally:
        JP.set_policy(JP.NoPolicy())
    return losses, skips, params, ost


def _train_port_resnet(weights, xs, y, opt_level="O1", **kw):
    """The port's run of ``_train_jax_resnet``: its losses, overflow flags,
    model and optimizer."""
    port = models.resnet18(num_classes=10, device="cpu")
    port.load_state_dict(params_from_jax(*weights), strict=True)
    model, opt = amp.initialize(port, optimizers.FusedAdam(lr=RESNET_LR),
                                opt_level=opt_level, verbosity=0, **kw)
    xs, yt = tuple(_t(a) for a in xs), _t(y).long()
    losses, skips = [], []
    try:
        for i in range(RESNET_STEPS):
            loss = F.cross_entropy(model(xs[i == RESNET_INF_STEP]), yt)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            opt.zero_grad()
            losses.append(float(loss.detach()))
            skips.append(float(opt.last_info["found_inf"]))
    finally:
        P.set_policy(P.NoPolicy())
    return losses, skips, model, opt


# losses: fp16 convolutions through oneDNN here and XLA there round apart
# (measured: 1.1e-4 relative over the three applied steps).  The update
# (params less the start) against the JAX package's, in norm: measured
# 0.141.  Most of that is the fp16 run's own spread, not the port's:
# test_resnet18_o1_fp16_at_32_within_jax_spread measures the JAX run
# against itself under a one-ulp move of its input, and holds the port to
# it.
RESNET_UPDATE_GAP = 0.25


def test_resnet18_o1_fp16_dynamic_matches_jax(resnet_weights):
    x, bad, y = _resnet_batch()
    jl, jskips, jparams, jost = _train_jax_resnet(
        resnet_weights, (jnp.asarray(x), jnp.asarray(bad)), jnp.asarray(y),
        half_dtype="float16")
    port = models.resnet18(num_classes=10, device="cpu")
    port.load_state_dict(params_from_jax(*resnet_weights), strict=True)
    model, opt = amp.initialize(port, optimizers.FusedAdam(lr=RESNET_LR),
                                opt_level="O1", half_dtype="float16",
                                verbosity=0)
    assert opt.scaler.dynamic and amp.current_loss_scale(opt) == 2.0 ** 16
    seen = set()
    model.conv1.register_forward_hook(lambda m, a, out: seen.add(out.dtype))
    xs, yt = (_t(x), _t(bad)), _t(y).long()
    tl, tskips = [], []
    for i in range(RESNET_STEPS):
        loss = F.cross_entropy(model(xs[i == RESNET_INF_STEP]), yt)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        tl.append(float(loss.detach()))
        tskips.append(float(opt.last_info["found_inf"]))
    assert seen == {torch.float16}          # the whitelisted conv
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert tskips == jskips == [float(i == RESNET_INF_STEP)
                                for i in range(RESNET_STEPS)]
    assert amp.amp_stats(opt)["per_loss"][0] == {
        "loss_scale": float(jost.scalers[0].loss_scale),
        "unskipped": int(jost.scalers[0].unskipped),
        "steps_skipped": int(jost.scalers[0].steps_skipped)}
    del tl[RESNET_INF_STEP], jl[RESNET_INF_STEP]
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    gap = _update_gap(_port_flat(model), _flat(jparams),
                      _flat(resnet_weights[0]))
    assert gap <= RESNET_UPDATE_GAP, gap
    assert int(opt.state.step) == int(jost.inner.step)


def _loss_gap(a, b) -> float:
    """The largest relative gap of two loss curves, the skipped step
    left out."""
    keep = [i for i in range(RESNET_STEPS) if i != RESNET_INF_STEP]
    a, b = np.asarray(a)[keep], np.asarray(b)[keep]
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("seed", [1, 2])
def test_resnet18_o1_fp16_at_32_within_jax_spread(resnet_weights, seed):
    """At 32 x 32 the last stage's BatchNorm normalizes one pixel of each
    of 8 images, and fp16 rounding swings the run: the JAX package's own
    O1 run moves by up to 4.7e-3 on the loss and about 0.3 in update when
    its input moves one fp32 ulp up or down.  The port (whose fp16
    convolutions and BatchNorm round in other places) stays within that
    spread of the JAX run: its loss gap at most twice, its update gap at
    most 1.5 times the larger of JAX's two moves.  In fp32 (O0) the two
    agree to 1e-5 on the loss and 1e-2 in update, so what differs under O1
    is where fp16 rounds, not the casts."""
    x, bad, y = _resnet_batch(seed, hw=32)
    start = _flat(resnet_weights[0])

    def jax_o1(images):
        worse = images.copy()
        worse[0, 0, 0, 0] = np.inf
        return _train_jax_resnet(resnet_weights, (jnp.asarray(images),
                                                  jnp.asarray(worse)),
                                 jnp.asarray(y), half_dtype="float16")

    ref = jax_o1(x)
    moved = [jax_o1(np.nextafter(x, np.float32(d))) for d in (np.inf, -np.inf)]
    port = _train_port_resnet(resnet_weights, (x, bad), y,
                              half_dtype="float16")
    assert all(r[1] == ref[1] == port[1] for r in moved)
    spread = (max(_loss_gap(r[0], ref[0]) for r in moved),
              max(_update_gap(_flat(r[2]), _flat(ref[2]), start)
                  for r in moved))
    gaps = (_loss_gap(port[0], ref[0]),
            _update_gap(_port_flat(port[2]), _flat(ref[2]), start))
    assert spread[0] > 0 and spread[1] > 0.1, spread
    assert gaps[0] <= 2 * spread[0] and gaps[1] <= 1.5 * spread[1], \
        (gaps, spread)
    # fp32: the same steps with no overflow agree closely
    j32 = _train_jax_resnet(resnet_weights, (jnp.asarray(x),) * 2,
                            jnp.asarray(y), opt_level="O0")
    t32 = _train_port_resnet(resnet_weights, (x, x), y, opt_level="O0")
    np.testing.assert_allclose(t32[0], j32[0], rtol=1e-5)
    assert _update_gap(_port_flat(t32[2]), _flat(j32[2]), start) <= 1e-2


# -- the surface -----------------------------------------------------------------------

def test_initialize_defaults_to_o1():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3))
    m, o = amp.initialize(model, optimizers.FusedAdam())
    pol = amp.current_policy()
    assert isinstance(pol, amp.CastPolicy) and pol.half_dtype == \
        torch.bfloat16
    assert amp._amp_state._amp_state.opt_properties.opt_level == "O1"
    assert m[0].weight.dtype == torch.float32 and not o.master_weights
    assert amp.compute_dtype("O1") == torch.bfloat16
    assert amp.compute_dtype("O0") == torch.float32
    assert amp.compute_dtype("O2", "float16") == torch.float16
    x = torch.randn(2, 4)
    assert F.linear(x, m[0].weight).dtype == torch.bfloat16
    amp.set_policy(amp.NoPolicy())
    assert F.linear(x, m[0].weight).dtype == torch.float32


def test_disable_casts_and_the_banned_op():
    p = torch.tensor([0.3, 0.6])
    y = torch.tensor([1.0, 0.0])
    with amp.use_policy(amp.CastPolicy(torch.float16)):
        with pytest.raises(NotImplementedError,
                           match="binary_cross_entropy_with_logits"):
            F.binary_cross_entropy(p, y)
        with amp.disable_casts():
            loss = F.binary_cross_entropy(p, y)
            assert F.matmul(p[None], p[:, None]).dtype == torch.float32
        assert F.matmul(p[None], p[:, None]).dtype == torch.float16
    want = -(np.log(0.3 + 1e-12) + np.log(1 - 0.6 + 1e-12)) / 2
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)


def test_cast_leaves_ints_generators_and_none_alone():
    g = torch.Generator()
    args = (torch.ones(2), torch.arange(3), None, g, 0.5,
            {"w": torch.ones(1, dtype=torch.float64), "r": "mean"},
            [torch.ones(1, dtype=torch.bfloat16), True])
    with amp.use_policy(amp.CastPolicy(torch.float16)):
        (a, i, n, gg, s, d, lst), kw = P.cast_op_args("linear", args,
                                                      {"bias": None})
    assert a.dtype == torch.float16 and i.dtype == torch.int64
    assert n is None and gg is g and s == 0.5 and kw == {"bias": None}
    assert d["w"].dtype == torch.float16 and d["r"] == "mean"
    assert lst[0].dtype == torch.float16 and lst[1] is True
    # promote: fp16 and bf16 rank alike, the first met wins, fp64 widest
    assert P._widest_dtype([torch.ones(1, dtype=torch.float16),
                            torch.ones(1, dtype=torch.bfloat16)]) == \
        torch.float16
    assert P._widest_dtype([torch.ones(1), [torch.ones(
        1, dtype=torch.float64)]]) == torch.float64
    assert P._widest_dtype([torch.arange(2), 1.0]) is None


def test_layer_norm_module_casts_its_input_to_fp32():
    """``nn.LayerNorm`` goes through the policy's "layer_norm" entry, as the
    JAX module goes through ``F.layer_norm``: under O1 a bf16 input comes
    out fp32, normalized by the LayerNorm kernels (their plain versions
    here), within 1e-5 of the JAX module; ``FusedLayerNorm`` itself keeps
    the input's dtype."""
    x = np.random.RandomState(4).randn(6, 16).astype(np.float32) * 3 + 1
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jln = jnn.LayerNorm(16)
    params, _ = jln.init(jax.random.PRNGKey(0))
    tln = tnn.LayerNorm(16, device="cpu")
    with JP.use_policy(JP.CastPolicy(jnp.bfloat16)):
        j, _ = jnn.apply(jln, params, jnp.asarray(x, jnp.bfloat16))
    with P.use_policy(P.CastPolicy(torch.bfloat16)):
        t = tln(xb)
        fused = normalization.FusedLayerNorm(16, device="cpu")(xb)
    assert t.dtype == torch.float32 and str(j.dtype) == "float32"
    assert fused.dtype == torch.bfloat16
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)
    assert tln(xb).dtype == torch.bfloat16          # no policy: as given
