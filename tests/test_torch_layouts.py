"""The functional layouts and the layer classes of the port against the JAX
package, on the CPU.

``conv2d`` (every padding form, groups, dilation), ``conv_transpose2d``,
the three pools and ``space_to_depth``, in NCHW and NHWC, forward and
grads (of ``sum(y * g)`` for a fixed random ``g``), from the same numpy
inputs.  All fp32: XLA and oneDNN sum a convolution in other orders, so
each comparison is at rtol/atol 1e-5 (measured: at most 4e-6 at these
sizes); the pools and ``space_to_depth`` move values and are held
tighter.  The NHWC calls of the port run on channels-last views, so their
outputs are checked to be NHWC in memory (no copy back to NCHW).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import nn as jnn
from apex_tpu.nn import functional as JF
from apex_tpu.parallel import SyncBatchNorm as JSyncBatchNorm

from apex_tpu_torch import nn
from apex_tpu_torch.nn import functional as F
from apex_tpu_torch.parallel import SyncBatchNorm

RTOL = ATOL = 1e-5


def _nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def _grads_port(fn, args, g):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out, [t.grad.numpy() for t in ts]


def _check(jfn, tfn, args, rtol=RTOL, atol=ATOL, nhwc=False):
    """``jfn`` (JAX) and ``tfn`` (the port) on the same inputs: outputs,
    and the grads of ``sum(out * g)`` for a fixed random ``g``."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    g = np.random.RandomState(99).randn(*jout.shape).astype(np.float32)
    jgrads = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    jout = np.asarray(jout)
    tout, tgrads = _grads_port(tfn, args, g)
    if nhwc:
        # NHWC in memory: the channels-last view came back as it was
        assert tout.is_contiguous(), tout.stride()
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=rtol,
                               atol=atol)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


CONV_CASES = {
    "int": dict(stride=1, padding=1),
    "pair": dict(stride=(2, 1), padding=(1, 2)),
    "asymmetric": dict(stride=1, padding=((2, 1), (0, 3))),
    "s2d-stem": dict(stride=1, padding=((2, 1), (2, 1))),
    "groups": dict(stride=2, padding=1, groups=2),
    "dilation": dict(stride=1, padding=2, dilation=2),
}


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, data_format):
    kw = CONV_CASES[case]
    rs = np.random.RandomState(0)
    groups = kw.get("groups", 1)
    x = rs.randn(2, 4, 9, 10).astype(np.float32)
    k = 4 if case == "s2d-stem" else 3
    w = (rs.randn(6, 4 // groups, k, k) * 0.2).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    _check(lambda x, w, b: JF.conv2d(x, w, b, data_format=data_format, **kw),
           lambda x, w, b: F.conv2d(x, w, b, data_format=data_format, **kw),
           [x, w, b], nhwc=data_format == "NHWC")


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,padding,output_padding",
                         [(1, 0, 0), (2, 1, 1), ((2, 1), (1, 0), (1, 0))])
def test_conv_transpose2d_matches_jax(data_format, stride, padding,
                                      output_padding):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 5, 6).astype(np.float32)
    w = (rs.randn(4, 3, 3, 3) * 0.2).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    kw = dict(stride=stride, padding=padding, output_padding=output_padding,
              data_format=data_format)
    _check(lambda x, w, b: JF.conv_transpose2d(x, w, b, **kw),
           lambda x, w, b: F.conv_transpose2d(x, w, b, **kw), [x, w, b],
           nhwc=data_format == "NHWC")


POOLS = {
    "max k3 s2 p1": ("max_pool2d", (3, 2, 1)),
    "max k2": ("max_pool2d", (2, None, 0)),
    "avg k2 s2": ("avg_pool2d", (2, 2, 0)),
    "avg k3 s1 p1": ("avg_pool2d", (3, 1, 1)),
}


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pools_match_jax(pool, data_format):
    name, (k, s, p) = POOLS[pool]
    x = np.random.RandomState(2).randn(2, 3, 8, 10).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    # a max moves values (exact); an average of at most 9 sums in another
    # order
    tol = 0 if name == "max_pool2d" else 1e-6
    _check(lambda x: getattr(JF, name)(x, k, s, p, data_format),
           lambda x: getattr(F, name)(x, k, s, p, data_format), [x],
           rtol=tol, atol=tol, nhwc=data_format == "NHWC")


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_adaptive_avg_pool2d_matches_jax(data_format):
    x = np.random.RandomState(3).randn(2, 5, 7, 6).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    _check(lambda x: JF.adaptive_avg_pool2d(x, 1, data_format),
           lambda x: F.adaptive_avg_pool2d(x, 1, data_format), [x],
           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_space_to_depth_matches_jax_bitwise(data_format):
    x = np.random.RandomState(4).randn(2, 3, 8, 6).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    want = np.asarray(JF.space_to_depth(jnp.asarray(x), 2, data_format))
    got = F.space_to_depth(torch.from_numpy(x), 2, data_format).numpy()
    np.testing.assert_array_equal(got, want)


def test_bad_data_format_raises_as_jax():
    x = torch.zeros(1, 3, 4, 4)
    for fn in (lambda: F.conv2d(x, torch.zeros(2, 3, 1, 1),
                                data_format="NWHC"),
               lambda: F.max_pool2d(x, 2, data_format="nchw"),
               lambda: nn.Conv2d(3, 2, 1, data_format="CHWN", device="cpu",
                                 generator=torch.Generator())(x)):
        with pytest.raises(ValueError, match="data_format"):
            fn()


# -- the layer classes --------------------------------------------------------

def _jax_layer(layer, x):
    params, state = layer.init(jax.random.PRNGKey(0))
    out, _ = jnn.apply(layer, params, jnp.asarray(x), state=state,
                       train=False)
    return params, np.asarray(out)


def _load(port_layer, params):
    with torch.no_grad():
        for name, v in params.items():
            getattr(port_layer, name).copy_(torch.from_numpy(np.array(v)))
    return port_layer


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_conv_layers_match_jax(data_format):
    gen = torch.Generator().manual_seed(0)
    x = np.random.RandomState(5).randn(2, 4, 6, 6).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    pairs = [
        (jnn.Conv2d(4, 6, 3, stride=2, padding=1, dilation=1, groups=2,
                    data_format=data_format),
         nn.Conv2d(4, 6, 3, stride=2, padding=1, dilation=1, groups=2,
                   data_format=data_format, device="cpu", generator=gen)),
        (jnn.ConvTranspose2d(4, 5, 3, stride=2, padding=1, output_padding=1,
                             data_format=data_format),
         nn.ConvTranspose2d(4, 5, 3, stride=2, padding=1, output_padding=1,
                            data_format=data_format, device="cpu",
                            generator=gen)),
    ]
    for jl, tl in pairs:
        params, want = _jax_layer(jl, x)
        assert {k: v.shape for k, v in params.items()} == \
            {k: tuple(v.shape) for k, v in tl.named_parameters()}
        got = _load(tl, params)(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_conv_transpose_layer_fan_in_is_torch():
    """The weight is uniform in +-sqrt(1/fan_in) with fan_in from
    weight.size(1) (out_channels), as in torch and the JAX package."""
    layer = nn.ConvTranspose2d(64, 2, 3, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    bound = (1.0 / (2 * 9)) ** 0.5
    w = layer.weight.detach().abs()
    assert float(w.max()) <= bound and float(w.max()) > 0.95 * bound
    params, _ = jnn.ConvTranspose2d(64, 2, 3).init(jax.random.PRNGKey(0))
    jw = np.abs(np.asarray(params["weight"]))
    assert jw.max() <= bound and jw.max() > 0.95 * bound


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_pool_layers_match_jax(data_format):
    x = np.random.RandomState(6).randn(2, 3, 8, 8).astype(np.float32)
    if data_format == "NHWC":
        x = _nhwc(x)
    for jl, tl in ((jnn.MaxPool2d(3, 2, 1, data_format),
                    nn.MaxPool2d(3, 2, 1, data_format)),
                   (jnn.AvgPool2d(2, data_format=data_format),
                    nn.AvgPool2d(2, data_format=data_format)),
                   (jnn.AdaptiveAvgPool2d(1, data_format),
                    nn.AdaptiveAvgPool2d(1, data_format))):
        _, want = _jax_layer(jl, x)
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ReLU", "GELU", "Tanh", "Sigmoid",
                                  "LeakyReLU", "Identity", "Flatten"])
def test_activation_layers_match_jax(name):
    x = np.random.RandomState(7).randn(2, 3, 4, 5).astype(np.float32)
    _, want = _jax_layer(getattr(jnn, name)(), x)
    got = getattr(nn, name)()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    # the transcendental ones (tanh-form gelu, tanh, sigmoid) within a few
    # ulps of XLA's; the rest move or scale values exactly
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_leaky_relu_layer_slope():
    x = torch.tensor([-2.0, 3.0])
    assert torch.equal(nn.LeakyReLU(0.2)(x), torch.tensor([-0.4, 3.0]))
    assert nn.LeakyReLU().negative_slope == 0.01


# -- the JAX package's layout specs, mirrored ---------------------------------

def test_conv_transpose_channels_last_matches_nchw():
    """tests/test_models.py::test_conv_transpose_channels_last_matches_nchw
    on the port."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 8, 8).astype(np.float32))
    w = torch.from_numpy((rs.randn(4, 6, 3, 3) * 0.1).astype(np.float32))
    b = torch.from_numpy(rs.randn(6).astype(np.float32))
    ref = F.conv_transpose2d(x, w, b, stride=2, padding=1, output_padding=1)
    out = F.conv_transpose2d(x.permute(0, 2, 3, 1).contiguous(), w, b,
                             stride=2, padding=1, output_padding=1,
                             data_format="NHWC")
    torch.testing.assert_close(out.permute(0, 3, 1, 2), ref, rtol=1e-5,
                               atol=1e-5)


def test_syncbn_channels_last_native_axis():
    """tests/test_models.py::test_syncbn_channels_last_native_axis on the
    port (no process group: the statistics are local), held against the
    JAX layer too."""
    x = np.random.RandomState(1).randn(4, 5, 6, 8).astype(np.float32)
    bn_nhwc = SyncBatchNorm(8, channel_last=True, device="cpu")
    bn_nchw = SyncBatchNorm(8, device="cpu")
    out = bn_nhwc(torch.from_numpy(x))
    ref = bn_nchw(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)
    jl = JSyncBatchNorm(8, channel_last=True)
    params, state = jl.init(jax.random.PRNGKey(0))
    want, _ = jnn.apply(jl, params, jnp.asarray(x), state=state, train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_nhwc_batch_norm_takes_no_fused_op(monkeypatch):
    """A channels-last BatchNorm never reaches the syncbn op, whose
    ``x.contiguous()`` would copy NHWC back to NCHW: the JAX package's
    plain route for channel_axis != 1."""
    from apex_tpu_torch import ops

    def refuse(*a, **k):
        raise AssertionError("NHWC input reached batch_norm_apply_fused")

    monkeypatch.setattr(ops, "batch_norm_apply_fused", refuse)
    bn = nn.BatchNorm2d(8, channel_axis=-1, device="cpu")
    y = bn(torch.randn(2, 3, 3, 8))
    assert y.shape == (2, 3, 3, 8) and y.is_contiguous()
