"""The O1 cast policy of the port against the JAX package's, on the CPU.

The 19 cases of ``tests/test_amp_casts.py`` (the reference's
tests/L0/run_amp test_basic_casts.py pattern, promotion, banned
functions, disabled-amp passthrough, the registries, the O0/O2/O3 param
casts, gradient accumulation), each run through
``apex_tpu_torch.nn.functional`` and ``apex_tpu.nn.functional`` on the same
numpy inputs: the output dtypes must agree, and the values within 1e-6
relative in fp32 and one unit of the half dtype's rounding (2^-10 fp16,
2^-7 bf16, of the largest magnitude) otherwise.  The policy is
process-wide in both packages: an autouse fixture restores ``NoPolicy``
in both after every test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import apex_tpu
from apex_tpu import amp as jamp
from apex_tpu import nn as jnn
from apex_tpu.amp import policy as JP
from apex_tpu.nn import functional as JF

from apex_tpu_torch import amp, nn, optimizers
from apex_tpu_torch.amp import policy as P
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.utils.jax_interop import params_from_jax

HALF = {"float16": (torch.float16, jnp.float16),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# one unit of each dtype's rounding, relative
UNIT = {torch.float32: 1e-6, torch.float16: 2.0 ** -10,
        torch.bfloat16: 2.0 ** -7, torch.bool: 0.0}


@pytest.fixture(autouse=True)
def reset_policy():
    yield
    P.set_policy(P.NoPolicy())
    JP.set_policy(JP.NoPolicy())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.itemsize == 2 else a


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _agree(t: torch.Tensor, j, units: float = 1.0) -> None:
    """Same dtype; values within ``units`` of the dtype's rounding."""
    assert _dtype_name(t) == str(jnp.asarray(j).dtype), (t.dtype, j.dtype)
    tn, jn = t.detach().float().numpy(), _np(j).astype(np.float32)
    tol = units * UNIT[t.dtype]
    np.testing.assert_allclose(tn, jn, rtol=tol,
                               atol=tol * float(np.abs(jn).max(initial=0)))


def _o1(half):
    return (P.use_policy(P.CastPolicy(HALF[half][0])),
            JP.use_policy(JP.CastPolicy(HALF[half][1])))


def _both(name, half, arrays, **kw):
    """``F.name(*arrays, **kw)`` in both packages under O1 of ``half``."""
    tp, jp = _o1(half)
    with tp:
        t = getattr(F, name)(*[_t(a) for a in arrays], **kw)
    with jp:
        j = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kw)
    return t, j


_RS = np.random.RandomState(0)
_X24, _W34 = _RS.randn(2, 4).astype(np.float32), _RS.randn(3, 4).astype(
    np.float32)


# -- whitelist: gemms and convolutions cast to half (test_basic_casts.py) ------

@pytest.mark.parametrize("name,half,arrays,kw,want", [
    ("linear", "float16", (_X24, _W34), {}, torch.float16),
    ("matmul", "bfloat16", (_X24, _W34.T.copy()), {}, torch.bfloat16),
    ("conv2d", "float16", (_RS.randn(1, 3, 8, 8).astype(np.float32),
                           _RS.randn(4, 3, 3, 3).astype(np.float32)),
     {"padding": 1}, torch.float16),
])
def test_whitelist_casts_to_half(name, half, arrays, kw, want):
    t, j = _both(name, half, arrays, **kw)
    assert t.dtype == want
    _agree(t, j)


# -- blacklist: softmax & the losses in fp32 ------------------------------------

@pytest.mark.parametrize("name,arrays", [
    ("softmax", (_X24.astype(np.float16),)),
    ("cross_entropy", (_X24.astype(np.float16), np.zeros(2, np.int32))),
])
def test_blacklist_runs_in_fp32(name, arrays):
    t, j = _both(name, "float16", arrays)
    assert t.dtype == torch.float32
    _agree(t, j)


# -- promote: the widest type wins ------------------------------------------------

@pytest.mark.parametrize("name,call", [
    ("add", lambda f, a, b: f.add(a, b)),
    ("cat", lambda f, a, b: f.cat([a, b])),
])
def test_promote_to_widest(name, call):
    a = _RS.randn(2).astype(np.float16)
    b = _RS.randn(2).astype(np.float32)
    tp, jp = _o1("float16")
    with tp:
        t = call(F, _t(a), _t(b))
    with jp:
        j = call(JF, jnp.asarray(a), jnp.asarray(b))
    assert t.dtype == torch.float32
    _agree(t, j)


# -- banned ops raise with the reference's message ---------------------------------

def test_binary_cross_entropy_banned():
    p = np.asarray([0.5, 0.5], np.float16)
    y = np.asarray([1.0, 0.0], np.float16)
    tp, jp = _o1("float16")
    for pol, f, arr in ((tp, F, _t), (jp, JF, jnp.asarray)):
        with pol:
            with pytest.raises(NotImplementedError,
                               match="binary_cross_entropy_with_logits"):
                f.binary_cross_entropy(arr(p), arr(y))


def test_banned_op_ok_with_disabled_casts():
    p = np.asarray([0.3, 0.6], np.float32)
    y = np.asarray([1.0, 0.0], np.float32)
    tp, jp = _o1("float16")
    with tp, amp.disable_casts():
        assert amp.current_policy().enabled is False
        t = F.binary_cross_entropy(_t(p), _t(y))
    with jp, jamp.disable_casts():
        j = JF.binary_cross_entropy(jnp.asarray(p), jnp.asarray(y))
    assert np.isfinite(float(t))
    _agree(t, j)


# -- no policy: passthrough (test_basic_casts.py:140-158) ---------------------------

def test_disabled_passthrough():
    for dt in (np.float16, np.float32):
        t = F.linear(_t(_X24.astype(dt)), _t(_W34.astype(dt)))
        j = JF.linear(jnp.asarray(_X24.astype(dt)),
                      jnp.asarray(_W34.astype(dt)))
        assert t.dtype == (torch.float16 if dt == np.float16
                           else torch.float32)
        _agree(t, j)


# -- user registries (apex.amp.amp:30-64) -------------------------------------------

def test_register_float_function_moves_category():
    assert amp.lists.classify("matmul") == jamp.lists.classify("matmul") \
        == "half"
    amp.register_float_function("matmul")
    jamp.register_float_function("matmul")
    try:
        assert amp.lists.classify("matmul") == "float"
        a = _RS.randn(2, 2).astype(np.float32)
        t, j = _both("matmul", "float16", (a, a))
        assert t.dtype == torch.float32
        _agree(t, j)
    finally:
        amp.register_half_function("matmul")
        jamp.register_half_function("matmul")
    assert amp.lists.classify("matmul") == "half"


def test_half_function_decorator():
    @amp.half_function
    def my_op(x):
        return x * 2

    @jamp.half_function
    def my_jop(x):
        return x * 2

    x = _RS.randn(3).astype(np.float32)
    assert my_op(_t(x)).dtype == torch.float32     # no policy: passthrough
    tp, jp = _o1("float16")
    with tp:
        t = my_op(_t(x))
    with jp:
        j = my_jop(jnp.asarray(x))
    assert t.dtype == torch.float16
    _agree(t, j)


# -- opt levels: which params are cast -----------------------------------------------

class ConvBN(torch.nn.Module):
    """The JAX test's ConvBN, with the JAX module's parameter names."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = nn.Conv2d(3, 8, 3, padding=1, bias=False, device="cpu",
                              generator=g)
        self.bn = nn.BatchNorm2d(8, device="cpu")
        self.fc = nn.Linear(8, 4, device="cpu", generator=g)

    def forward(self, x):
        h = self.bn(self.conv(x))
        h = F.adaptive_avg_pool2d(F.relu(h), 1).reshape(x.shape[0], -1)
        return self.fc(h)


class _JaxConvBN(jnn.Module):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn = jnn.BatchNorm2d(8)
        self.fc = jnn.Linear(8, 4)

    def forward(self, p, x):
        h = self.bn(p["bn"], self.conv(p["conv"], x))
        h = JF.adaptive_avg_pool2d(JF.relu(h), 1).reshape(x.shape[0], -1)
        return self.fc(p["fc"], h)


def _convbn_pair(opt_level, **kw):
    """Both ConvBNs from the JAX init's fp32 weights, through
    ``amp.initialize`` at ``opt_level``; each one's params and the output
    (eval mode, running statistics) on one input."""
    jm = _JaxConvBN()
    params, state = jm.init(jax.random.PRNGKey(0))
    jmodel = jamp.initialize(jm, opt_level=opt_level, verbosity=0, **kw)
    jparams = jmodel.cast_params(params)
    tm = ConvBN()
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params),
                                       jax.tree_util.tree_map(np.asarray,
                                                              state)))
    tm = amp.initialize(tm, opt_level=opt_level, verbosity=0, **kw)
    tm.eval()
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    jout, _ = jmodel.apply(jparams, jnp.asarray(x), state=state)
    return dict(tm.named_parameters()), tm(_t(x)), jparams, jout


# the half convolution and linear round apart through oneDNN and XLA
@pytest.mark.parametrize("opt_level,kw,conv,bn,units", [
    ("O2", {}, torch.bfloat16, torch.float32, 4),
    ("O3", {"half_dtype": "float16"}, torch.float16, torch.float16, 4),
    ("O0", {}, torch.float32, torch.float32, 4),
])
def test_opt_level_param_casts(opt_level, kw, conv, bn, units):
    tp, out, jparams, jout = _convbn_pair(opt_level, **kw)
    assert tp["conv.weight"].dtype == conv and tp["fc.weight"].dtype == conv
    assert tp["bn.weight"].dtype == bn
    for name in ("conv.weight", "bn.weight", "fc.weight"):
        mod, leaf = name.split(".")
        assert _dtype_name(tp[name]) == str(jparams[mod][leaf].dtype)
    # O2/O3 cast the outputs back to fp32 (reference _initialize.py:197-208)
    assert out.dtype == torch.float32
    _agree(out, jout, units=units * (UNIT[conv] / UNIT[out.dtype]))


def test_initialize_twice_raises():
    tm = amp.initialize(ConvBN(), opt_level="O1", verbosity=0)
    with pytest.raises(RuntimeError, match="only once"):
        amp.initialize(tm, opt_level="O1", verbosity=0)
    jm = jamp.initialize(_JaxConvBN(), opt_level="O1", verbosity=0)
    with pytest.raises(RuntimeError, match="only once"):
        jamp.initialize(jm, opt_level="O1", verbosity=0)


def test_properties_string_coercion():
    for props in (amp.Properties(), jamp.Properties()):
        props.options["opt_level"] = "O2"
        props.loss_scale = "128.0"
        assert props.loss_scale == 128.0
        props.loss_scale = "dynamic"
        assert props.loss_scale == "dynamic"
        props.keep_batchnorm_fp32 = "True"
        assert props.keep_batchnorm_fp32 is True
        with pytest.raises(ValueError):
            props.keep_batchnorm_fp32 = "yes"


# -- gradient accumulation: K backward passes, one step ----------------------------

def _accum_setup(opt_level):
    net = jnn.Sequential([jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4)])
    jmodel, jopt = jamp.initialize(net, apex_tpu.optimizers.FusedAdam(
        lr=1e-2), opt_level=opt_level, verbosity=0, hard_override=True)
    params, _ = net.init(jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    tnet = torch.nn.Sequential(nn.Linear(8, 16, device="cpu", generator=g),
                               torch.nn.ReLU(),
                               nn.Linear(16, 4, device="cpu", generator=g))
    tnet.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    tmodel, topt = amp.initialize(tnet, optimizers.FusedAdam(lr=1e-2),
                                  opt_level=opt_level, verbosity=0,
                                  hard_override=True)
    jparams = jmodel.cast_params(params)
    rng = np.random.RandomState(0)
    x = rng.randn(12, 8).astype(np.float32)
    y = rng.randn(12, 4).astype(np.float32)

    def jloss(p, mb):
        out, _ = jmodel.apply(p, mb[0])
        return JF.mse_loss(out, mb[1])

    return (jmodel, jopt, jparams, jopt.init(jparams), jloss), \
        (tmodel, topt), x, y


def _port_accum(tmodel, topt, xs, ys):
    """One scale_loss context a micro-batch (mean-loss convention: each
    loss over K), the stash then holds the summed unscaled grads."""
    K = len(xs)
    for xb, yb in zip(xs, ys):
        loss = F.mse_loss(tmodel(_t(xb)), _t(yb)) / K
        with amp.scale_loss(loss, topt) as scaled:
            scaled.backward()
    return topt._stash.grads.clone()


def _jax_flat(grads):
    return np.concatenate([np.asarray(g, np.float32).ravel()
                           for g in jax.tree_util.tree_leaves(grads)])


def test_accumulation_matches_big_batch_fp32():
    """Three accumulated micro-batches == one three-times-bigger batch at
    O0, in both packages, and the port's equals the JAX package's."""
    (_, _, jparams, jost, jloss), (tm, topt), x, y = _accum_setup("O0")
    micro = (x.reshape(3, 4, 8), y.reshape(3, 4, 4))
    _, g_acc = jamp.scaled_grad_accum(jloss, jparams, jost,
                                      tuple(map(jnp.asarray, micro)))
    t_acc = _port_accum(tm, topt, *micro)
    topt.zero_grad()
    t_big = _port_accum(tm, topt, [x], [y])
    np.testing.assert_allclose(t_acc.numpy(), t_big.numpy(), atol=2e-6)
    np.testing.assert_allclose(t_acc.numpy(), _jax_flat(g_acc), atol=2e-6)


def test_accumulation_o2_step_and_overflow():
    """Under O2 the accumulated grads feed one step; an inf in any
    micro-batch skips it and leaves the params bitwise, in both."""
    (_, jopt, jparams, jost, jloss), (tm, topt), x, y = _accum_setup("O2")
    micro = (x.reshape(3, 4, 8), y.reshape(3, 4, 4))
    _, g_acc = jamp.scaled_grad_accum(jloss, jparams, jost,
                                      tuple(map(jnp.asarray, micro)))
    t_acc = _port_accum(tm, topt, *micro)
    # bf16 matmuls through oneDNN and XLA round apart
    np.testing.assert_allclose(t_acc.numpy(), _jax_flat(g_acc), atol=1e-3,
                               rtol=0.05)
    _, _, info = jopt.step(jparams, jost, g_acc)
    topt.step()
    topt.zero_grad()
    assert float(info["found_inf"]) == float(topt.last_info["found_inf"]) \
        == 0.0
    bad = micro[0].copy()
    bad[1] = np.inf
    _, g_bad = jamp.scaled_grad_accum(jloss, jparams, jost,
                                      (jnp.asarray(bad),
                                       jnp.asarray(micro[1])))
    p3, _, info3 = jopt.step(jparams, jost, g_bad)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    _port_accum(tm, topt, bad, micro[1])
    topt.step()
    assert float(info3["found_inf"]) > 0
    assert float(topt.last_info["found_inf"]) > 0
    for a, b in zip(jax.tree_util.tree_leaves(p3),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
