"""The ResNet family of the port against the JAX package's, on the CPU.

- All five depths: every parameter and buffer has the JAX tree's name and
  shape (``jax.eval_shape`` of ``init``, so nothing big is computed), in
  both layouts and with both stems, and the conv7 models have
  torchvision's parameter counts.
- Small models (``ResNet(BasicBlock | Bottleneck, [1, 1, 1, 1], 10)``,
  batch 4, 32 x 32, fp32) built from the JAX model's weights
  (``utils.jax_interop``): logits, BatchNorm state and one step's grads
  against the JAX model in {NCHW, channels-last fed NCHW, channels-last fed
  NHWC} x {conv7, space_to_depth}.  (At batch 2 layer4's BatchNorms
  normalize two values a channel, 1 x 1 each, and their weight grads are
  differences of near-equal terms: two summation orders of the same fp32
  model, NCHW and NHWC, then part by 30 %.  Batch 4 is conditioned.)  The
  JAX side runs NCHW for the conv7
  stem and channels-last (fed NHWC) for the space-to-depth one.  oneDNN
  and XLA sum the convolutions in other orders: logits within rtol 1e-4,
  atol 5e-5 (test_torch_resnet.py's measured bound); each grad tensor
  within 2e-2 of its norm.  That is loose for a reason: a pre-activation
  within rounding of 0 lands on the other side of the ReLU's kink in the
  two packages and passes one element's grad in one and stops it in the
  other (measured: the Bottleneck with the space-to-depth stem, at
  layer3.0.bn1, min |z| 2.7e-6, moves every grad below it by up to 1.2 %;
  every other case and tensor is within 1.2e-4).
- ``stem_weight_to_s2d`` bitwise against the JAX package's, and the
  space-to-depth model equal to the conv7 one it was converted from.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import models as jmodels
from apex_tpu import nn as jnn
from apex_tpu.nn import functional as JF

from apex_tpu_torch import models
from apex_tpu_torch.nn.functional import cross_entropy
from apex_tpu_torch.utils.jax_interop import params_from_jax

DEPTHS = {"resnet18": 11_689_512, "resnet34": 21_797_672,
          "resnet50": 25_557_032, "resnet101": 44_549_160,
          "resnet152": 60_192_808}           # torchvision's counts
# (port mode) -> (channels_last, input_format)
MODES = {"nchw": (False, "NCHW"), "cl-nchw-in": (True, "NCHW"),
         "cl-nhwc-in": (True, "NHWC")}
BLOCKS = ("BasicBlock", "Bottleneck")


def _names(tree, sep="."):
    return {sep.join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_shapes(model):
    params, state = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    out = {k: (tuple(v.shape), str(v.dtype)) for k, v in
           _names(params).items()}
    for path, leaves in state.items():
        for k, v in leaves.items():
            out[f"{path}.{k}"] = (tuple(v.shape), str(v.dtype))
    return out


def _port_shapes(model):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("arch", sorted(DEPTHS))
def test_names_shapes_and_counts_match_jax(arch):
    port = getattr(models, arch)(device="meta")
    assert _port_shapes(port) == _jax_shapes(getattr(jmodels, arch)())
    assert sum(p.numel() for p in port.parameters()) == DEPTHS[arch]


@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
def test_names_and_shapes_are_layout_agnostic(stem):
    want = _jax_shapes(jmodels.resnet50(channels_last=True, stem=stem))
    for channels_last, input_format in MODES.values():
        port = models.resnet50(channels_last=channels_last,
                               input_format=input_format, stem=stem,
                               device="meta")
        assert _port_shapes(port) == want
    conv1 = dict(port.named_parameters())["conv1.weight"]
    assert tuple(conv1.shape) == ((64, 12, 4, 4) if stem == "space_to_depth"
                                  else (64, 3, 7, 7))


def test_constructor_errors_are_jax_s():
    for kw, msg in ((dict(input_format="NWHC"), "input_format"),
                    (dict(input_format="NHWC"), "requires"),
                    (dict(stem="conv5"), "stem")):
        with pytest.raises(ValueError, match=msg):
            models.resnet18(device="cpu", **kw)
        with pytest.raises(ValueError, match=msg):
            jmodels.resnet18(**kw)


# -- small models against JAX -------------------------------------------------

def _batch():
    rs = np.random.RandomState(0)
    return (rs.randn(4, 3, 32, 32).astype(np.float32),
            rs.randint(0, 10, 4).astype(np.int32))


_JAX_CACHE = {}


def _jax_reference(block, stem):
    """Weights, logits, new BatchNorm state and grads of one train-mode
    step of the JAX model (NCHW for conv7, channels-last fed NHWC for
    space_to_depth)."""
    key = (block, stem)
    if key not in _JAX_CACHE:
        cl = stem == "space_to_depth"
        jm = jmodels.ResNet(getattr(jmodels.resnet, block), [1, 1, 1, 1], 10,
                            channels_last=cl,
                            input_format="NHWC" if cl else "NCHW", stem=stem)
        params, state = jm.init(jax.random.PRNGKey(0))
        x, y = _batch()
        xin = jnp.asarray(np.transpose(x, (0, 2, 3, 1)) if cl else x)

        def loss(p):
            out, new = jnn.apply(jm, p, xin, state=state, train=True)
            return JF.cross_entropy(out, jnp.asarray(y)), (out, new)

        (_, (out, new)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        _JAX_CACHE[key] = (np_tree(params), np_tree(state), np.asarray(out),
                           np_tree(new), _names(np_tree(grads)))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
@pytest.mark.parametrize("block", BLOCKS)
def test_small_resnet_matches_jax(block, stem, mode):
    params, state, out, new_state, grads = _jax_reference(block, stem)
    channels_last, input_format = MODES[mode]
    port = models.ResNet(getattr(models, block), [1, 1, 1, 1], 10,
                         channels_last=channels_last,
                         input_format=input_format, stem=stem, device="cpu")
    port.load_state_dict(params_from_jax(params, state), strict=True)
    x, y = _batch()
    if input_format == "NHWC":
        x = np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))
    logits = port(torch.from_numpy(x))
    cross_entropy(logits, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), out, rtol=1e-4,
                               atol=5e-5)
    sd = port.state_dict()
    for path, leaves in new_state.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(sd[f"{path}.{k}"].numpy(), v,
                                       rtol=1e-4, atol=1e-6)
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert got.keys() == grads.keys()
    for k, g in grads.items():
        err = np.linalg.norm(got[k] - g) / np.linalg.norm(g)
        assert err <= 2e-2, (k, err)


def test_channels_last_activations_stay_nhwc_in_memory():
    """Every conv of the channels-last model gets an NHWC-contiguous
    input: the layout is carried through, not copied back to NCHW."""
    port = models.resnet18(num_classes=10, channels_last=True, device="cpu")
    seen = []
    for m in port.modules():
        if isinstance(m, torch.nn.Module) and hasattr(m, "data_format"):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append(a[0].is_contiguous()))
    port(torch.randn(2, 3, 32, 32))
    assert seen and all(seen), seen


def test_flat_grads_of_nhwc_model_equal_nchw():
    """Same weights, same batch: the NHWC model's grads, flattened in the
    parameter order, are the NCHW model's, to the convolutions' summation
    order: within 1e-4 in norm, and each tensor's within 1e-3 of its
    largest grad (measured: 2e-5 and 1.6e-4)."""
    x, y = _batch()
    flats = []
    for channels_last in (False, True):
        port = models.ResNet(models.Bottleneck, [1, 1, 1, 1], 10,
                             channels_last=channels_last, device="cpu")
        cross_entropy(port(torch.from_numpy(x)),
                      torch.from_numpy(y)).backward()
        flats.append(torch.cat([p.grad.reshape(-1)
                                for p in port.parameters()]))
    assert flats[0].shape == (sum(p.numel() for p in port.parameters()),)
    diff = flats[1] - flats[0]
    assert float(diff.norm() / flats[0].norm()) <= 1e-4
    off = 0
    for p in port.parameters():
        span = slice(off, off + p.numel())
        off += p.numel()
        assert float(diff[span].abs().max()) <= \
            1e-3 * float(flats[0][span].abs().max())


# -- the space-to-depth stem --------------------------------------------------

def test_stem_weight_to_s2d_bitwise_jax():
    w7 = np.random.RandomState(0).randn(64, 3, 7, 7).astype(np.float32)
    want = np.asarray(jmodels.stem_weight_to_s2d(jnp.asarray(w7)))
    got = models.stem_weight_to_s2d(torch.from_numpy(w7)).numpy()
    assert got.shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got[0]) == 147
    with pytest.raises(ValueError, match="7x7"):
        models.stem_weight_to_s2d(torch.zeros(64, 3, 5, 5))


def test_s2d_stem_exact_parity():
    """tests/test_models.py::test_s2d_stem_exact_parity on the port: the
    space-to-depth stem is the conv7 stem's function, at the stem conv
    and through the whole model in both layouts (eval mode)."""
    from apex_tpu_torch.nn import functional as F
    rs = np.random.RandomState(0)
    w7 = torch.from_numpy((rs.randn(64, 3, 7, 7) * 0.05).astype(np.float32))
    x = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32))
    ref = F.conv2d(x, w7, stride=2, padding=3)
    via = F.conv2d(F.space_to_depth(x, 2, "NCHW"),
                   models.stem_weight_to_s2d(w7), stride=1,
                   padding=((2, 1), (2, 1)))
    assert ref.shape == via.shape
    torch.testing.assert_close(via, ref, rtol=1e-5, atol=1e-5)

    m7 = models.resnet18(num_classes=10, device="cpu").eval()
    sd = models.convert_stem_to_s2d(m7.state_dict())
    assert sd["conv1.weight"].shape == (64, 12, 4, 4)
    assert sd["layer1.0.conv1.weight"].data_ptr() == \
        m7.layer1[0].conv1.weight.data_ptr()
    for channels_last in (False, True):
        ms = models.resnet18(num_classes=10, stem="space_to_depth",
                             channels_last=channels_last, device="cpu")
        ms.load_state_dict(sd)
        ms.eval()
        with torch.no_grad():
            torch.testing.assert_close(ms(x), m7(x), rtol=1e-4, atol=1e-4)
