"""Promotion semantics and the whole ``amp.lists`` surface of the port,
against the JAX package, on the CPU.

The port of ``tests/test_promotion.py``: every name the O1 tables classify
exists in ``apex_tpu_torch.nn.functional`` (or ``transformer``) and carries
``__amp_op__``; mixed-dtype promotion, the comparisons and the sequence
ops; then each op of the gemm, conv, transcendental, reduction, norm, loss
and promote families on the same numpy inputs through both packages,
with no policy in fp32 (within 1e-5 relative, of the largest magnitude
for the absolute part) and under O1 (the output dtype, and the values
within 1e-5 when the op runs in fp32, two units of bf16's rounding when
it runs in bf16: the products round apart through oneDNN and XLA).  An
autouse fixture restores ``NoPolicy`` in both packages after every test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.amp import lists as jlists
from apex_tpu.amp import policy as JP
from apex_tpu.nn import functional as JF

from apex_tpu_torch import transformer
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp import policy as P
from apex_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def reset_policy():
    yield
    P.set_policy(P.NoPolicy())
    JP.set_policy(JP.NoPolicy())


def _t(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def _j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _o1(half):
    th, jh = {"float16": (torch.float16, jnp.float16),
              "bfloat16": (torch.bfloat16, jnp.bfloat16)}[half]
    return P.use_policy(P.CastPolicy(th)), JP.use_policy(JP.CastPolicy(jh))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.itemsize == 2 else a


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


# -- the tables name only ops that exist ---------------------------------------------

def test_tables_are_the_jax_packages():
    for name in ("FP16_FUNCS", "FP32_FUNCS", "PROMOTE_FUNCS",
                 "SEQUENCE_PROMOTE_FUNCS", "BANNED_FUNCS"):
        assert getattr(lists, name) == getattr(jlists, name), name
    assert "apex_tpu_torch.amp.disable_casts()" in lists.BANNED_MSG


def test_every_listed_op_exists():
    for table in (lists.FP16_FUNCS, lists.FP32_FUNCS, lists.PROMOTE_FUNCS,
                  lists.SEQUENCE_PROMOTE_FUNCS, lists.BANNED_FUNCS):
        for name in table:
            if name == "dot_product_attention":
                assert hasattr(transformer, name)
                continue
            fn = getattr(F, name, None)
            assert fn is not None, f"amp.lists names unimplemented op {name}"
            assert fn.__amp_op__ == name, name
    # and F's public surface covers the JAX module's
    assert set(JF.__all__) <= set(F.__all__)


# -- out-of-place promotion: widest type wins ------------------------------------------

@pytest.mark.parametrize("op,args", [
    ("sub", 2), ("div", 2), ("atan2", 2), ("fmod", 2), ("remainder", 2),
    ("addcdiv", 3), ("addcmul", 3),
])
def test_mixed_dtype_promotes_widest(op, args):
    xs16 = [np.ones((4,), np.float16) * (i + 1) for i in range(args - 1)]
    x32 = np.ones((4,), np.float32) * 3
    tp, jp = _o1("float16")
    with tp:
        t = (getattr(F, op)(_t(x32), *map(_t, xs16)),
             getattr(F, op)(*map(_t, xs16), _t(x32)))
    with jp:
        j = (getattr(JF, op)(_j(x32), *map(_j, xs16)),
             getattr(JF, op)(*map(_j, xs16), _j(x32)))
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and _dt(a) == _dt(b), op
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)


def test_same_half_dtype_stays_half():
    a = np.full((4,), 1.5, np.float16)
    b = np.full((4,), 0.5, np.float16)
    tp, jp = _o1("float16")
    for pol, f, arr in ((tp, F, _t), (jp, JF, _j)):
        with pol:
            for name in ("sub", "min", "max"):
                assert _dt(getattr(f, name)(arr(a), arr(b))) == "float16"


def test_comparisons_promote_inputs_return_bool():
    a = np.asarray([1.0, 2.0, 3.0, 4.0], np.float16)
    b = np.asarray([1.0, 3.0, 2.0, 4.0], np.float32)
    for name in ("eq", "ne", "lt", "gt", "le", "ge"):
        tp, jp = _o1("float16")
        with tp:
            t = getattr(F, name)(_t(a), _t(b))
        with jp:
            j = getattr(JF, name)(_j(a), _j(b))
        assert t.dtype == torch.bool and _dt(j) == "bool", name
        np.testing.assert_array_equal(_np(t), _np(j))
    with _o1("float16")[0]:
        assert bool(F.equal(_t(a), _t(a.astype(np.float32))))
        assert not bool(F.equal(_t(a), _t(b)))


def test_sequence_promote_mixed_cat():
    a = np.asarray([1.0, 2.0], np.float16)
    b = np.asarray([3.0, 4.0], np.float32)
    tp, jp = _o1("float16")
    with tp:
        t = (F.cat([_t(a), _t(b)]), F.concatenate([_t(a), _t(b)]),
             F.stack([_t(a), _t(a)]))
    with jp:
        j = (JF.cat([_j(a), _j(b)]), JF.concatenate([_j(a), _j(b)]),
             JF.stack([_j(a), _j(a)]))
    assert [_dt(x) for x in t] == [_dt(x) for x in j] == \
        ["float32", "float32", "float16"]
    for x, y in zip(t, j):
        np.testing.assert_array_equal(_np(x), _np(y))


# -- the families, op by op ------------------------------------------------------------

def _r(*shape, lo=None, hi=None, seed=[0]):
    seed[0] += 1
    rs = np.random.RandomState(seed[0])
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _labels(n, c, seed):
    return np.random.RandomState(seed).randint(0, c, n).astype(np.int32)


# (name, args, kwargs); the float arrays are fp32, int arrays stay as they are
CASES = [
    # gemm family and prelu (whitelist)
    ("linear", (_r(3, 4), _r(5, 4), _r(5)), {}),
    ("matmul", (_r(2, 3, 4), _r(4, 5)), {}),
    ("mm", (_r(2, 3), _r(3, 2)), {}),
    ("mv", (_r(2, 3), _r(3)), {}),
    ("bmm", (_r(2, 2, 3), _r(2, 3, 2)), {}),
    ("addmm", (_r(2, 2), _r(2, 3), _r(3, 2)), {"beta": 2.0, "alpha": 0.5}),
    ("addmv", (_r(2), _r(2, 3), _r(3)), {"beta": 0.5}),
    ("addr", (_r(2, 2), _r(2), _r(3)[:2]), {"alpha": 2.0}),
    ("addbmm", (_r(2, 2), _r(2, 2, 3), _r(2, 3, 2)), {}),
    ("baddbmm", (_r(2, 2, 2), _r(2, 2, 3), _r(2, 3, 2)), {"beta": 0.5}),
    ("prelu", (_r(2, 3, 4), _r(3) * 0.5), {}),
    # conv family (whitelist)
    ("conv1d", (_r(2, 3, 16), _r(5, 3, 3), _r(5)), {"padding": 1}),
    ("conv2d", (_r(2, 3, 8, 8), _r(4, 3, 3, 3)), {"padding": 1,
                                                  "stride": 2}),
    ("conv3d", (_r(1, 2, 4, 6, 6), _r(4, 2, 2, 3, 3)), {}),
    ("conv_transpose1d", (_r(2, 5, 8), _r(5, 3, 4)), {"stride": 2}),
    ("conv_transpose2d", (_r(2, 4, 5, 5), _r(4, 3, 3, 3), _r(3)),
     {"stride": 2, "padding": 1, "output_padding": 1}),
    ("conv_transpose3d", (_r(1, 2, 3, 4, 4), _r(2, 3, 2, 2, 2)),
     {"stride": 2}),
    ("conv_tbc", (_r(10, 2, 3), _r(3, 3, 5), _r(5)), {"pad": 1}),
    # transcendentals (blacklist)
    ("exp", (_r(3, 4),), {}),
    ("expm1", (_r(3, 4),), {}),
    ("log", (_r(3, 4, lo=0.1, hi=3.0),), {}),
    ("log10", (_r(3, 4, lo=0.1, hi=3.0),), {}),
    ("log2", (_r(3, 4, lo=0.1, hi=3.0),), {}),
    ("log1p", (_r(3, 4, lo=-0.5, hi=3.0),), {}),
    ("reciprocal", (_r(3, 4, lo=0.5, hi=3.0),), {}),
    ("rsqrt", (_r(3, 4, lo=0.1, hi=3.0),), {}),
    ("acos", (_r(3, 4, lo=-0.9, hi=0.9),), {}),
    ("asin", (_r(3, 4, lo=-0.9, hi=0.9),), {}),
    ("cosh", (_r(3, 4),), {}),
    ("sinh", (_r(3, 4),), {}),
    ("tan", (_r(3, 4, lo=-1.0, hi=1.0),), {}),
    ("erf", (_r(3, 4),), {}),
    ("erfinv", (_r(3, 4, lo=-0.9, hi=0.9),), {}),
    ("cumsum", (_r(3, 4),), {}),
    ("cumsum", (_r(3, 4),), {"axis": 1}),
    ("cumprod", (_r(3, 4, lo=0.5, hi=1.5),), {"axis": 0}),
    ("pow", (_r(3, 4, lo=0.1, hi=2.0), 2.5), {}),
    ("softplus", (_r(3, 4) * 10,), {"beta": 2.0, "threshold": 5.0}),
    ("gelu", (_r(3, 4),), {}),
    ("gelu", (_r(3, 4),), {"approximate": False}),
    # reductions and softmaxes (blacklist)
    ("sum", (_r(3, 4),), {}),
    ("sum", (_r(3, 4),), {"axis": 1, "keepdims": True}),
    ("mean", (_r(3, 4),), {"axis": 0}),
    ("prod", (_r(3, 4, lo=0.5, hi=1.5),), {}),
    ("prod", (_r(3, 4, lo=0.5, hi=1.5),), {"axis": 1}),
    ("std", (_r(3, 4),), {}),
    ("var", (_r(3, 4),), {"axis": 1}),
    ("logsumexp", (_r(3, 4),), {"axis": 1}),
    ("norm", (_r(3, 4),), {}),
    ("norm", (_r(3, 4),), {"p": 3.0, "axis": 1}),
    ("dist", (_r(3, 4), _r(3, 4)), {}),
    ("renorm", (_r(3, 4), 2.0, 0, 1.0), {}),
    ("softmax", (_r(3, 4),), {}),
    ("log_softmax", (_r(3, 4),), {"axis": 0}),
    ("softmin", (_r(3, 4),), {}),
    ("normalize", (_r(3, 4),), {}),
    ("cosine_similarity", (_r(3, 4), _r(3, 4)), {}),
    ("pdist", (_r(4, 3),), {}),
    ("pdist", (_r(4, 3),), {"p": 1.0}),
    # norms (blacklist)
    ("layer_norm", (_r(2, 3, 8), (8,), _r(8), _r(8)), {}),
    ("group_norm", (_r(2, 4, 3, 3), 2, _r(4), _r(4)), {}),
    ("instance_norm", (_r(2, 4, 3, 3), _r(4), _r(4)), {}),
    ("batch_norm", (_r(2, 4, 3, 3), None, None, _r(4), _r(4)),
     {"training": True}),
    # losses (blacklist)
    ("cross_entropy", (_r(6, 5), _labels(6, 5, 1)), {}),
    ("nll_loss", (_r(6, 5), _labels(6, 5, 2)), {"reduction": "sum"}),
    ("mse_loss", (_r(3, 4), _r(3, 4)), {}),
    ("l1_loss", (_r(3, 4), _r(3, 4)), {"reduction": "none"}),
    ("smooth_l1_loss", (_r(3, 4), _r(3, 4)), {"beta": 0.5}),
    ("kl_div", (_r(3, 4), _r(3, 4, lo=0.0, hi=1.0)), {}),
    ("kl_div", (_r(3, 4), _r(3, 4)), {"log_target": True,
                                      "reduction": "batchmean"}),
    ("soft_margin_loss", (_r(3, 4), np.sign(_r(3, 4))), {}),
    ("poisson_nll_loss", (_r(3, 4), _r(3, 4, lo=0.0, hi=4.0)),
     {"full": True}),
    ("cosine_embedding_loss", (_r(4, 3), _r(4, 3),
                               np.asarray([1, -1, 1, -1], np.int32)),
     {"margin": 0.1}),
    ("hinge_embedding_loss", (_r(4), np.asarray([1, -1, 1, -1], np.int32)),
     {}),
    ("margin_ranking_loss", (_r(4), _r(4), np.sign(_r(4))), {"margin": 0.5}),
    ("triplet_margin_loss", (_r(4, 3), _r(4, 3), _r(4, 3)), {}),
    ("multi_margin_loss", (_r(4, 5), _labels(4, 5, 3)), {}),
    ("multilabel_margin_loss", (_r(2, 4), np.asarray(
        [[3, 0, -1, 1], [1, 2, 3, 0]], np.int32)), {}),
    ("binary_cross_entropy_with_logits", (_r(3, 4), _r(3, 4, lo=0.0,
                                                        hi=1.0)), {}),
    # promote ops
    ("add", (_r(3, 4), _r(3, 4)), {}),
    ("sub", (_r(3, 4), _r(3, 4)), {}),
    ("mul", (_r(3, 4), _r(3, 4)), {}),
    ("div", (_r(3, 4), _r(3, 4, lo=0.5, hi=2.0)), {}),
    ("addcdiv", (_r(3), _r(3), _r(3, lo=0.5, hi=2.0)), {"value": 0.5}),
    ("addcmul", (_r(3), _r(3), _r(3)), {"value": 2.0}),
    ("atan2", (_r(3, 4), _r(3, 4)), {}),
    ("cross", (_r(4, 3), _r(4, 3)), {}),
    ("dot", (_r(5), _r(5)), {}),
    ("dot", (_r(2, 3), _r(3, 4)), {}),
    ("bilinear", (_r(3, 4), _r(3, 5), _r(2, 4, 5), _r(2)), {}),
    ("min", (_r(3, 4), _r(3, 4)), {}),
    ("max", (_r(3, 4),), {"axis": 1}),
    ("min", (_r(3, 4),), {}),
    ("fmod", (_r(3, 4) * 3, _r(3, 4, lo=0.5, hi=2.0)), {}),
    ("remainder", (_r(3, 4) * 3, _r(3, 4, lo=0.5, hi=2.0)), {}),
]
IDS = [f"{i}-{c[0]}" for i, c in enumerate(CASES)]


def _run(name, args, kwargs, half=None, in_dtype=None):
    """The op in both packages: ``in_dtype`` casts the fp32 arrays
    (numpy), ``half`` runs under O1."""
    if in_dtype is not None:
        args = tuple(a.astype(in_dtype) if isinstance(a, np.ndarray)
                     and a.dtype == np.float32 else a for a in args)
    tp, jp = _o1(half) if half else (P.use_policy(P.NoPolicy()),
                                     JP.use_policy(JP.NoPolicy()))
    with tp:
        t = getattr(F, name)(*map(_t, args), **kwargs)
    with jp:
        j = getattr(JF, name)(*map(_j, args), **kwargs)
    return t, j


def _close(t, j, rtol):
    tn, jn = _np(t), _np(j)
    assert tn.shape == jn.shape, (tn.shape, jn.shape)
    np.testing.assert_allclose(tn, jn, rtol=rtol,
                               atol=rtol * float(np.abs(jn).max(initial=0)))


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=IDS)
def test_op_matches_jax_fp32(name, args, kwargs):
    t, j = _run(name, args, kwargs)
    assert _dt(t) == _dt(j) == "float32", (t.dtype, j.dtype)
    _close(t, j, 1e-5)


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=IDS)
def test_op_under_o1_matches_jax(name, args, kwargs):
    """Whitelist ops from fp32 inputs run in bf16; the others from fp16
    inputs run in fp32 (blacklist), or in the widest input dtype, fp16
    here (promote)."""
    kind = lists.classify(name)
    if kind == "half":
        t, j = _run(name, args, kwargs, half="bfloat16")
        want, rtol = "bfloat16", 2 * 2.0 ** -7
    else:
        t, j = _run(name, args, kwargs, half="float16", in_dtype=np.float16)
        want = "float32" if kind == "float" else "float16"
        rtol = 1e-5 if kind == "float" else 2.0 ** -10
    assert _dt(t) == _dt(j) == want, (kind, t.dtype, j.dtype)
    _close(t, j, rtol)
