"""Parity of the port's amp layer with the JAX package's, on the CPU.

The flat layout, the loss scaler, ``AmpOptimizer.step`` and the gradient
accumulation across backward passes of ``apex_tpu_torch.amp`` against
``apex_tpu.amp``: the same numpy inputs go through both.  On the CPU the
port's kernel wrappers run their plain PyTorch versions, and the JAX
package runs its jnp paths.  Also: the port imports without JAX, and an
entry point called without ``device=`` on a machine with no GPU raises.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu.amp import _process_optimizer as jpo

from apex_tpu_torch import amp, models, optimizers
from apex_tpu_torch.amp._process_optimizer import _FlatLayout

REPO = pathlib.Path(__file__).resolve().parents[1]


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.itemsize == 2 else a


def _port_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_names(tree):
    return ['.'.join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# -- the package stands alone ----------------------------------------------------

def test_import_leaves_jax_and_apex_tpu_out():
    code = (
        "import sys\n"
        "import apex_tpu_torch\n"
        "from apex_tpu_torch import (amp, models, multi_tensor_apply, nn, "
        "normalization, ops, optimizers, parallel, transformer, utils)\n"
        "import apex_tpu_torch.nn.fused_xent\n"
        "import apex_tpu_torch.utils.jax_interop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'apex_tpu'))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_of_the_port_imports_jax_or_apex_tpu():
    files = sorted((REPO / "apex_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "apex_tpu"), \
                    f"{f.relative_to(REPO)} imports {m}"


def test_entry_point_without_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.resnet18()
    from apex_tpu_torch import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


# -- the flat layout follows JAX's leaf order ----------------------------------------

def _small_jax():
    return jmodels.ResNet(jmodels.resnet.Bottleneck, [1, 1, 1, 1],
                          num_classes=10)


def _small_port():
    return models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                         device="cpu")


@pytest.mark.parametrize("which", ["resnet18", "bottleneck_1111"])
def test_flat_layout_matches_jax(which):
    if which == "resnet18":
        jm, tm = jmodels.resnet18(num_classes=10), models.resnet18(
            num_classes=10, device="cpu")
    else:
        jm, tm = _small_jax(), _small_port()
    jmodel, _ = jamp.initialize(jm, joptim.FusedAdam(), opt_level="O2",
                                verbosity=0)
    # the layout needs only shapes and dtypes
    params, _ = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jlay = jpo._FlatLayout(params)
    tm, _ = amp.initialize(tm, optimizers.FusedAdam(), opt_level="O2",
                           verbosity=0)
    tlay = _FlatLayout(list(tm.named_parameters()))
    assert list(tlay.names) == _jax_names(params)
    assert tlay.shapes == jlay.shapes
    assert tlay.sizes == jlay.sizes and tlay.offsets == jlay.offsets
    assert tlay.total == jlay.total
    assert [str(d).replace("torch.", "") for d in tlay.dtypes] == \
        list(jlay.dtypes)
    assert tlay.half_dtype == torch.bfloat16 and \
        jlay.half_dtype == jnp.bfloat16


def test_jax_leaf_order_sorts_keys_as_strings():
    names = ["layer.2.w", "layer.10.w", "conv1.w", "bn1.w", "downsample.0.w"]
    assert amp._process_optimizer.jax_leaf_order(names) == [
        "bn1.w", "conv1.w", "downsample.0.w", "layer.10.w", "layer.2.w"]


# -- the loss scaler -------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(loss_scale="dynamic", init_scale=8.0, scale_window=3,
         min_loss_scale=2.0, max_loss_scale=32.0),
    dict(loss_scale="dynamic"),
    dict(loss_scale=128.0),
])
def test_loss_scaler_transitions_match_jax_bitwise(cfg):
    # three clean steps grow the scale (to the max clamp and past it), a run
    # of overflows halves it (to the min clamp and past it)
    flags = [0] * 9 + [1] * 6 + [0] * 4 + [1, 0, 0, 0]
    js, ts = jamp.LossScaler(**cfg), amp.LossScaler(**cfg)
    jst, tst = js.init_state(), ts.init_state("cpu")
    seen = set()
    for f in flags:
        jst = js.update(jst, jnp.float32(f))
        tst = ts.update(tst, torch.tensor(float(f)))
        for field in ("loss_scale", "unskipped", "steps_skipped"):
            j, t = np.asarray(getattr(jst, field)), getattr(tst, field)
            assert t.dtype == {"float32": torch.float32,
                               "int32": torch.int32}[str(j.dtype)]
            assert t.numpy().tobytes() == j.tobytes(), (field, f)
        seen.add(float(tst.loss_scale))
    if cfg.get("min_loss_scale") is not None:
        assert {2.0, 32.0} <= seen and 64.0 not in seen and 1.0 not in seen
    assert int(tst.steps_skipped) == sum(flags)


# -- AmpOptimizer.step -----------------------------------------------------------------

# leaf names chosen so that JAX's order differs from registration order:
# bn1 sorts before conv1, and "10" before "2"
_TOY = {"fc": {"weight": (5, 7), "bias": (5,)},
        "bn1": {"weight": (7,), "bias": (7,)},
        "layer": {"2": {"weight": (3, 4)}, "10": {"weight": (6,)}},
        "conv1": {"weight": (4, 3, 3, 3)}}


class _Node(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, (_Norm if k.startswith("bn") else _Node)(v))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(torch.from_numpy(v.copy())))


class _Norm(_Node):
    fp32_params = True      # amp keeps it fp32 under O2, as BatchNorm


def _toy_arrays(rs):
    def draw(t):
        return {k: draw(v) if isinstance(v, dict)
                else rs.randn(*v).astype(np.float32) * 0.5
                for k, v in t.items()}
    return draw(_TOY)


def _flat_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat_names(v, name) if isinstance(v, dict)
                   else {name: v})
    return out


def _jax_toy(arrays, half, keep_batchnorm_fp32=True):
    def cast(t, pinned=False):
        return {k: cast(v, pinned or (keep_batchnorm_fp32
                                      and k.startswith("bn")))
                if isinstance(v, dict)
                else jnp.asarray(v, jnp.float32 if pinned else half)
                for k, v in t.items()}
    return cast(arrays)


def _jax_loss(params, grads_by_name):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return sum(jnp.sum(leaf.astype(jnp.float32) * grads_by_name[
        '.'.join(str(k.key) for k in path)]) for path, leaf in leaves)


def _port_loss(model, grads_by_name):
    return sum((p.float() * torch.from_numpy(grads_by_name[n])).sum()
               for n, p in model.named_parameters())


def _assert_state_matches(model, opt, jparams, jost, *, masters_ulps):
    f32 = np.float32
    # the JAX package's jnp Adam divides by the scale and XLA's CPU backend
    # contracts beta*m + (1-beta)*g into one FMA; the port multiplies by the
    # reciprocal (exact for these power-of-two scales) and rounds every op.
    # The masters differ by a few ulps at most, m and v by rounding at
    # their own scale
    if jost.masters is not None:
        tb = opt.masters.buf.numpy()
        jb = np.asarray(jost.masters.buf)
        d = np.abs(tb.view(np.int32).astype(np.int64)
                   - jb.view(np.int32).astype(np.int64))
        assert d.max() <= masters_ulps, d.max()
    for t, j in ((opt.state.m, jost.inner.m), (opt.state.v, jost.inner.v)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=f32(2e-6) * np.abs(j).max())
    assert int(opt.state.step) == int(jost.inner.step)
    sj, st = jost.scalers[0], opt.scalers[0]
    assert float(st.loss_scale) == float(sj.loss_scale)
    assert int(st.steps_skipped) == int(sj.steps_skipped)
    jflat = _flat_names(jax.tree_util.tree_map(_np, jparams))
    for n, p in model.named_parameters():
        assert str(p.dtype).replace("torch.", "") == str(
            _flat_names(jparams)[n].dtype), n
        # a half copy of masters a few ulps apart rounds at most one half
        # ulp apart
        half_ulp = 2.0 ** -7 if p.dtype == torch.bfloat16 else 2.0 ** -10
        np.testing.assert_allclose(_port_np(p), jflat[n], rtol=half_ulp,
                                   atol=1e-30)


# O2: fp32 masters (BN kept fp32); O3: no masters, Adam starts each step
# from the half params, as the JAX package's no-master path does
@pytest.mark.parametrize("half,opt_level", [("bfloat16", "O2"),
                                            ("float16", "O2"),
                                            ("bfloat16", "O3")])
def test_amp_optimizer_step_matches_jax(half, opt_level):
    rs = np.random.RandomState(11)
    arrays = _toy_arrays(rs)
    hp = dict(lr=1e-3, weight_decay=0.01)
    model, opt = amp.initialize(_Node(arrays), optimizers.FusedAdam(**hp),
                                opt_level=opt_level, half_dtype=half,
                                verbosity=0)
    # bf16: a static scale of 1; fp16: dynamic from 2**16
    assert opt.scaler.dynamic == (half == "float16")
    jopt = jamp.AmpOptimizer(joptim.FusedAdam(**hp), jamp.LossScaler(
        "dynamic" if half == "float16" else 1.0),
        master_weights=opt_level == "O2")
    jparams = _jax_toy(arrays, jnp.dtype(half),
                       keep_batchnorm_fp32=opt_level == "O2")
    jost = jopt.init(jparams)
    names = list(_flat_names(arrays))
    for step in range(4):
        grads = {n: (rs.randn(*_flat_names(arrays)[n].shape) * 1e-2)
                 .astype(np.float32) for n in names}
        if half == "float16" and step == 2:
            grads["layer.2.weight"][1, 1] = np.inf      # an overflow step
        before = opt.masters.buf.clone(), opt.state.m.clone()
        scale = opt.loss_scale()
        jg = jax.grad(lambda p: _jax_loss(p, grads) * jost.scalers[0]
                      .loss_scale)(jparams)
        jparams, jost, info = jopt.step(jparams, jost, jg)

        loss = _port_loss(model, grads)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()

        skipped = half == "float16" and step == 2
        assert float(opt.last_info["found_inf"]) == float(
            info["found_inf"]) == float(skipped)
        if skipped:
            assert float(opt.loss_scale()) == float(scale) / 2
            assert torch.equal(opt.masters.buf, before[0])
            assert torch.equal(opt.state.m, before[1])
        else:
            np.testing.assert_allclose(float(opt.last_info["grad_norm"]),
                                       float(info["grad_norm"]), rtol=1e-6)
        _assert_state_matches(model, opt, jparams, jost, masters_ulps=4)
    assert int(opt.state.step) == (3 if half == "float16" else 4)


def test_two_backward_passes_accumulate_like_jax():
    """Two ``scale_loss`` contexts in one step: the second unscale is
    axpby (``grads/scale + stashed``), as in the JAX package's eager
    eager path (``amp.stateful``)."""
    rs = np.random.RandomState(12)
    arrays = _toy_arrays(rs)
    model, opt = amp.initialize(_Node(arrays), optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", half_dtype="float16",
                                verbosity=0)
    jopt = jamp.AmpOptimizer(joptim.FusedAdam(lr=1e-3),
                             jamp.LossScaler("dynamic"), master_weights=True)
    bound = jamp.stateful.bind(jopt, _jax_toy(arrays, jnp.float16))
    shapes = _flat_names(arrays)
    for _ in range(2):
        micro = [{n: (rs.randn(*a.shape) * 1e-2).astype(np.float32)
                  for n, a in shapes.items()} for _ in range(2)]
        for grads in micro:
            with jamp.scale_loss(lambda p, g=grads: _jax_loss(p, g),
                                 jopt) as scaled:
                scaled.backward()
            with amp.scale_loss(_port_loss(model, grads), opt) as scaled:
                scaled.backward()
        # the stash holds grads/scale of the first pass plus those of the
        # second: compare before the step consumes it
        jstash = jpo._FlatLayout(bound.params).pack(bound._grads32)
        np.testing.assert_array_equal(opt._stash.grads.numpy(),
                                      np.asarray(jstash))
        jopt.step()
        opt.step()
        opt.zero_grad()
        _assert_state_matches(model, opt, bound.params, bound.opt_state,
                              masters_ulps=4)


# -- FusedAdam on its own: clipping through the l2norm, schedules ----------------------

@pytest.mark.parametrize("lr", [1e-3, "schedule"])
def test_fused_adam_clip_and_schedule_match_jax(lr):
    if lr == "schedule":
        lr = lambda step: 1e-3 * 0.5 ** step                 # noqa: E731
    rs = np.random.RandomState(13)
    n = 1001
    p = rs.randn(n).astype(np.float32)
    hp = dict(lr=lr, weight_decay=0.01, max_grad_norm=1.0)
    jopt, topt = joptim.FusedAdam(**hp), optimizers.FusedAdam(**hp)
    jp, jst = jnp.asarray(p), jopt.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    tst = topt.init(tp)
    for _ in range(3):
        # scaled grads whose norm (~32 after the 1/1024 unscale) is well
        # over max_grad_norm: the clip engages
        g = (rs.randn(n) * 1024).astype(np.float32)
        jp, jst = jopt.step(jp, jst, jnp.asarray(g), scale=1024.0)
        topt.step(tp, tst, torch.from_numpy(g), scale=1024.0)
    assert int(tst.step) == int(jst.step) == 3
    # combined_scale = clip * 1024 is no power of two here: the JAX
    # package's jnp path divides by it, the port multiplies by its
    # reciprocal (the kernel's formula), one rounding apart on g~
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-6)
    for t, j in ((tst.m, jst.m), (tst.v, jst.v)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2e-6 * np.abs(j).max())


# -- amp.initialize --------------------------------------------------------------------

def test_initialize_casts_and_guards():
    model, opt = amp.initialize(_Node(_toy_arrays(np.random.RandomState(0))),
                                optimizers.FusedAdam(), opt_level="O2",
                                verbosity=0)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["bn1.weight"] == torch.float32
    assert dtypes["fc.weight"] == torch.bfloat16
    assert not opt.scaler.dynamic and opt.scaler._init_scale == 1.0
    # the half params are views into the flat half buffer the Adam kernel
    # writes, the fp32 ones views into the master buffer
    lay = opt.masters.layout
    half_base = opt.masters.half.untyped_storage().data_ptr()
    for n, p in model.named_parameters():
        base = (opt.masters.buf if p.dtype == torch.float32
                else opt.masters.half).untyped_storage().data_ptr()
        assert p.untyped_storage().data_ptr() == base, n
    assert half_base != opt.masters.buf.untyped_storage().data_ptr()
    assert lay.total == opt.masters.buf.numel()
    masters = list(amp.master_params(opt))
    assert len(masters) == len(lay.names)
    assert all(m.dtype == torch.float32 for m in masters)
    assert torch.equal(masters[lay.names.index("fc.weight")],
                       dict(model.named_parameters())["fc.weight"].float())
    with pytest.raises(RuntimeError, match="only once"):
        amp.initialize(model, optimizers.FusedAdam(), opt_level="O2",
                       verbosity=0)
    fresh = _Node(_toy_arrays(np.random.RandomState(0)))
    with pytest.raises(NotImplementedError, match="O1"):
        amp.initialize(fresh, optimizers.FusedAdam(), opt_level="O1",
                       verbosity=0)
    with pytest.raises(RuntimeError, match="letter O"):
        amp.initialize(fresh, optimizers.FusedAdam(), opt_level="02",
                       verbosity=0)
    with pytest.raises(RuntimeError, match="before backward"):
        _, o = amp.initialize(fresh, optimizers.FusedAdam(), opt_level="O0",
                              verbosity=0)
        o.step()
