"""amp checkpoints of the port: resume bitwise, and carry a JAX run across.

A small convolutional net with BatchNorm trains k steps under O1 or O2
(fp16, dynamic loss scale, one overflow planted) with FusedAdam or FusedLAMB; the
model's, the optimizer's and amp's state dicts go through ``torch.save`` /
``torch.load``; a fresh ``amp.initialize``d pair loads them and trains m
more steps.  Params, masters, half copy, moments, step counter and the
three scaler fields must be bitwise those of k + m uninterrupted steps
(the CPU runs the same ops in the same order).  A checkpoint of another
model raises.  ``utils.jax_interop.amp_state_from_jax`` takes a JAX
``AmpOptState`` after k steps and the port continues it to the JAX
package's own k + m steps (at the tolerance of
``test_torch_amp.py::test_amp_optimizer_step_matches_jax``), and
``amp_state_to_jax`` carries the port's state the other way.  Last, the
``FP16_Optimizer`` state dict round trip.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import optimizers as joptim
from apex_tpu.amp import _process_optimizer as jpo
from apex_tpu.amp import policy as JP
from apex_tpu.optimizers.fused_adam import AdamState as JAdamState

from apex_tpu_torch import amp, nn, optimizers
from apex_tpu_torch.amp import policy as P
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.utils.jax_interop import (amp_state_from_jax,
                                              amp_state_to_jax,
                                              params_from_jax)

K, M = 4, 2
OVERFLOW_STEP = 1         # its loss is scaled by inf


@pytest.fixture(autouse=True)
def reset_policy():
    yield
    P.set_policy(P.NoPolicy())
    JP.set_policy(JP.NoPolicy())


class _Net(torch.nn.Module):
    """Two convolutions with BatchNorm and a linear head: under O1 the
    convolutions run in fp16 on fp32 params, under O2 the params are fp16
    but for the BatchNorms'."""

    def __init__(self, num_classes):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(16, device="cpu")
        self.conv2 = nn.Conv2d(16, 32, 3, stride=2, padding=1, bias=False,
                               **kw)
        self.bn2 = nn.BatchNorm2d(32, device="cpu")
        self.fc = nn.Linear(32, num_classes, **kw)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.fc(F.adaptive_avg_pool2d(x, 1).flatten(1))


def _pair(opt_level, which, num_classes=10):
    inner = (optimizers.FusedAdam(lr=1e-3, weight_decay=0.01)
             if which == "adam" else optimizers.FusedLAMB(lr=1e-3))
    return amp.initialize(_Net(num_classes), inner, opt_level=opt_level,
                          half_dtype="float16", loss_scale="dynamic",
                          verbosity=0)


def _batches(n):
    """(x, y, overflow) of each step; the overflow step's loss is scaled
    by inf (an inf in the input would also poison the BatchNorm running
    statistics)."""
    rs = np.random.RandomState(3)
    return [(torch.from_numpy(rs.randn(8, 3, 16, 16).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, 8)), i == OVERFLOW_STEP)
            for i in range(n)]


def _train(model, opt, batches):
    for x, y, overflow in batches:
        loss = cross_entropy(model(x), y)
        if overflow:
            loss = loss * float("inf")
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()


def _snapshot(model, opt):
    m, v = opt.state.m, opt.state.v
    snap = {"model." + k: v_.clone() for k, v_ in model.state_dict().items()}
    snap.update({"masters": opt.masters.buf.clone(),
                 "m": getattr(m, "buf", m).clone(),
                 "v": getattr(v, "buf", v).clone(),
                 "step": opt.state.step.clone()})
    if opt.masters.half is not None:
        snap["half"] = opt.masters.half.clone()
    for i, s in enumerate(amp.state_dict(opt)["scalers"]):
        snap.update({f"scaler{i}.{k}": t.clone() for k, t in s.items()})
    return snap


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _save(model, opt):
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "amp": amp.state_dict(opt)}, buf)
    buf.seek(0)
    return buf


@pytest.mark.parametrize("opt_level", ["O1", "O2"])
@pytest.mark.parametrize("which", ["adam", "lamb"])
def test_resume_is_bitwise(opt_level, which):
    batches = _batches(K + M)
    ref_model, ref_opt = _pair(opt_level, which)
    _train(ref_model, ref_opt, batches)
    skipped = amp.steps_skipped(ref_opt)
    assert skipped >= 1 and int(ref_opt.state.step) + skipped == K + M

    model, opt = _pair(opt_level, which)
    _train(model, opt, batches[:K])
    assert int(opt.state.step) >= 1 and amp.steps_skipped(opt) >= 1
    saved = _snapshot(model, opt)
    ck = torch.load(_save(model, opt), weights_only=True)
    del model, opt

    model, opt = _pair(opt_level, which)
    model.load_state_dict(ck["model"])
    opt.load_state_dict(ck["optimizer"])
    amp.load_state_dict(opt, ck["amp"])
    _assert_bitwise(_snapshot(model, opt), saved)
    # every parameter still a view into the optimizer's flat buffers
    bases = {opt.masters.buf.untyped_storage().data_ptr()}
    if opt.masters.half is not None:
        bases.add(opt.masters.half.untyped_storage().data_ptr())
    assert all(p.untyped_storage().data_ptr() in bases
               for p in model.parameters())
    _train(model, opt, batches[K:])
    _assert_bitwise(_snapshot(model, opt), _snapshot(ref_model, ref_opt))


@pytest.mark.parametrize("order", ["optimizer_first", "model_after"])
def test_masters_win_in_either_load_order(order):
    """O2: the model's state dict holds the fp16 params, the optimizer's
    the fp32 masters; loaded in either order, the masters are the
    optimizer's, unrounded."""
    model, opt = _pair("O2", "adam")
    _train(model, opt, _batches(K))
    ck = torch.load(_save(model, opt), weights_only=True)
    want = opt.masters.buf.clone()
    assert not torch.equal(want, opt.masters.half.float())   # not on the grid
    fresh, fopt = _pair("O2", "adam")
    if order == "optimizer_first":
        fopt.load_state_dict(ck["optimizer"])
        fresh.load_state_dict(ck["model"])
    else:
        fresh.load_state_dict(ck["model"])
        fopt.load_state_dict(ck["optimizer"])
    assert torch.equal(fopt.masters.buf, want)
    assert torch.equal(fopt.masters.half, want.half())


def test_checkpoint_of_another_model_raises():
    model, opt = _pair("O2", "adam")
    _train(model, opt, _batches(1))
    sd = opt.state_dict()
    _, other = _pair("O2", "adam", num_classes=7)
    with pytest.raises(ValueError, match="masters"):
        other.load_state_dict(sd)
    _, lamb = _pair("O2", "lamb")
    bad = dict(sd, masters=None)
    with pytest.raises(ValueError, match="inner"):
        lamb.load_state_dict(dict(bad, inner={"step": sd["inner"]["step"]}))
    with pytest.raises(ValueError, match="loss scalers"):
        amp.load_state_dict(opt, {"scalers": []})


# -- a JAX run carried across ----------------------------------------------------------

# leaf names chosen so that JAX's order differs from registration order
_TOY = {"fc": {"weight": (5, 7), "bias": (5,)},
        "bn1": {"weight": (7,), "bias": (7,)},
        "layer": {"2": {"weight": (3, 4)}, "10": {"weight": (6,)}}}


class _Node(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, (_Norm if k.startswith("bn") else _Node)(v))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(torch.from_numpy(
                        np.asarray(v, np.float32).copy())))


class _Norm(_Node):
    fp32_params = True


def _flat_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat_names(v, name) if isinstance(v, dict)
                   else {name: v})
    return out


def _toy(rs):
    def draw(t):
        return {k: draw(v) if isinstance(v, dict)
                else rs.randn(*v).astype(np.float32) * 0.5
                for k, v in t.items()}
    return draw(_TOY)


def _jax_params(arrays, half, master_weights):
    def cast(t, pinned=False):
        return {k: cast(v, pinned or k.startswith("bn"))
                if isinstance(v, dict) else jnp.asarray(
                    v, jnp.float32 if pinned or not master_weights else half)
                for k, v in t.items()}
    return cast(arrays)


def _jax_loss(params, grads_by_name):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return sum(jnp.sum(leaf.astype(jnp.float32) * grads_by_name[
        '.'.join(str(k.key) for k in path)]) for path, leaf in leaves)


def _port_loss(model, grads_by_name):
    return sum((p.float() * torch.from_numpy(grads_by_name[n])).sum()
               for n, p in model.named_parameters())


def _grads(rs, shapes, step, inf):
    g = {n: (rs.randn(*a.shape) * 1e-2).astype(np.float32)
         for n, a in shapes.items()}
    if inf and step == 1:
        g["layer.2.weight"][1, 1] = np.inf
    return g


def _jax_step(jopt, jparams, jost, grads):
    jg = jax.grad(lambda p: _jax_loss(p, grads)
                  * jost.scalers[0].loss_scale)(jparams)
    jparams, jost, _ = jopt.step(jparams, jost, jg)
    return jparams, jost


def _port_step(model, opt, grads):
    with amp.scale_loss(_port_loss(model, grads), opt) as scaled:
        scaled.backward()
    opt.step()
    opt.zero_grad()


def _assert_matches_jax(model, opt, jparams, jost):
    """As test_torch_amp.py's check: masters within 4 ulps (the JAX jnp
    Adam divides by the scale where the port multiplies by its
    reciprocal, and XLA contracts the EMAs into FMAs), m and v within
    2e-6 of their largest magnitude, step and scaler exact."""
    tb = opt.masters.buf.numpy()
    if jost.masters is not None:
        jb = np.asarray(jost.masters.buf)
    else:
        by_name = _flat_names(jax.tree_util.tree_map(np.asarray, jparams))
        jb = np.concatenate([np.asarray(by_name[n], np.float32).ravel()
                             for n in opt.masters.layout.names])
    d = np.abs(tb.view(np.int32).astype(np.int64)
               - jb.view(np.int32).astype(np.int64))
    assert d.max() <= 4, d.max()
    for t, j in ((opt.state.m, jost.inner.m), (opt.state.v, jost.inner.v)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=np.float32(2e-6) * np.abs(j).max())
    assert int(opt.state.step) == int(jost.inner.step)
    for k in ("loss_scale", "unskipped", "steps_skipped"):
        assert getattr(opt.scalers[0], k).numpy().tobytes() == np.asarray(
            getattr(jost.scalers[0], k)).tobytes(), k


# O2 fp16 with a dynamic scale and an overflow (masters a flat buffer);
# O1 (fp32 params, no masters in the JAX package: the params come from the
# model's state dict)
@pytest.mark.parametrize("opt_level,half", [("O2", "float16"),
                                            ("O1", "bfloat16")])
def test_jax_amp_state_continues_in_the_port(opt_level, half):
    rs = np.random.RandomState(21)
    arrays = _toy(rs)
    shapes = _flat_names(arrays)
    masters = opt_level == "O2"
    hp = dict(lr=1e-3, weight_decay=0.01)
    jopt = jamp.AmpOptimizer(joptim.FusedAdam(**hp), jamp.LossScaler(
        "dynamic" if half == "float16" else 1.0), master_weights=masters)
    jparams = _jax_params(arrays, jnp.dtype(half), masters)
    jost = jopt.init(jparams)
    steps = [_grads(rs, shapes, i, half == "float16") for i in range(K + M)]
    for g in steps[:K]:
        jparams, jost = _jax_step(jopt, jparams, jost, g)

    model = _Node(arrays)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams)))
    model, opt = amp.initialize(model, optimizers.FusedAdam(**hp),
                                opt_level=opt_level, half_dtype=half,
                                verbosity=0)
    sd = amp_state_from_jax(jost, opt.masters.layout)
    assert (sd["masters"] is None) == (not masters)
    opt.load_state_dict(sd)
    _assert_matches_jax(model, opt, jparams, jost)
    for g in steps[K:]:
        jparams, jost = _jax_step(jopt, jparams, jost, g)
        _port_step(model, opt, g)
    _assert_matches_jax(model, opt, jparams, jost)
    if half == "float16":
        assert amp.steps_skipped(opt) == int(jost.scalers[0].steps_skipped) \
            == 1


def test_port_amp_state_continues_in_jax():
    """The other way: the port's state after k steps, through
    ``amp_state_to_jax``, continues in the JAX package."""
    rs = np.random.RandomState(22)
    arrays = _toy(rs)
    shapes = _flat_names(arrays)
    hp = dict(lr=1e-3, weight_decay=0.01)
    model, opt = amp.initialize(_Node(arrays), optimizers.FusedAdam(**hp),
                                opt_level="O2", half_dtype="float16",
                                verbosity=0)
    steps = [_grads(rs, shapes, i, True) for i in range(K + M)]
    for g in steps[:K]:
        _port_step(model, opt, g)
    out = amp_state_to_jax(opt)
    jopt = jamp.AmpOptimizer(joptim.FusedAdam(**hp),
                             jamp.LossScaler("dynamic"), master_weights=True)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, _jax_params(arrays, jnp.float16, True))
    jparams = _jax_from_port(jparams, {n: p.detach() for n, p in
                                       model.named_parameters()})
    layout = jpo._FlatLayout(jparams)
    jost = jpo.AmpOptState(
        inner=JAdamState(**{k: jnp.asarray(v)
                            for k, v in out["inner"].items()}),
        masters=jpo.FlatMasters(jnp.asarray(out["masters"]), layout),
        scalers=tuple(jamp.ScalerState(**{k: jnp.asarray(v)
                                          for k, v in s.items()})
                      for s in out["scalers"]))
    _assert_matches_jax(model, opt, jparams, jost)
    for g in steps[K:]:
        jparams, jost = _jax_step(jopt, jparams, jost, g)
        _port_step(model, opt, g)
    _assert_matches_jax(model, opt, jparams, jost)


def _jax_from_port(like, values):
    """``like``'s tree with each leaf replaced by the port's parameter of
    its path (same dtype)."""
    def walk(t, prefix=""):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else jnp.asarray(values[prefix + k].float().numpy()
                                 ).astype(v.dtype)
                for k, v in t.items()}
    return walk(like)


# -- FP16_Optimizer ----------------------------------------------------------------------

def test_fp16_optimizer_state_dict_round_trip():
    rs = np.random.RandomState(23)
    params = [torch.from_numpy(rs.randn(*s).astype(np.float32)).half()
              for s in ((4, 3), (5,))]
    fopt = optimizers.FP16_Optimizer(optimizers.FusedAdam(lr=1e-3),
                                     dynamic_loss_scale=True)
    state = fopt.init(params)
    for i in range(3):
        grads = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32)
                                  * 100).half() for p in params]
        if i == 1:
            grads[0][0, 0] = float("inf")
        fopt.step(params, state, grads)
    buf = io.BytesIO()
    torch.save(fopt.state_dict(state), buf)
    buf.seek(0)
    sd = torch.load(buf, weights_only=True)
    jfopt = joptim.FP16_Optimizer(joptim.FusedAdam())
    jsd = jfopt.state_dict(jfopt.init([jnp.zeros((2,), jnp.float16)]))
    assert set(sd) == set(jsd) == {"masters", "adam", "scaler"}
    for k in ("adam", "scaler"):
        assert set(sd[k]) == set(jsd[k]), k
    back = fopt.load_state_dict(sd)
    for a, b in ((back.masters, state.masters), (back.adam.m, state.adam.m),
                 (back.adam.v, state.adam.v),
                 (back.adam.step, state.adam.step),
                 (back.scaler.loss_scale, state.scaler.loss_scale),
                 (back.scaler.unskipped, state.scaler.unskipped),
                 (back.scaler.steps_skipped, state.scaler.steps_skipped)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back.scaler.steps_skipped) == 1
    # one more step from each: the same bits
    p2 = [p.clone() for p in params]
    grads = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32)).half()
             for p in params]
    fopt.step(params, state, grads)
    fopt.step(p2, back, grads)
    assert all(torch.equal(a, b) for a, b in zip(params, p2))
    assert torch.equal(state.masters, back.masters)
