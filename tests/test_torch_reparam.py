"""The port's weight norm (``apex_tpu_torch.reparameterization``) and
``fp16_utils.Fused_Weight_Norm`` against the JAX package's, on the CPU:
tests/test_larc_reparam.py's four weight-norm cases, each on the same
weights (the JAX tree carried over by ``utils.jax_interop.rnn_from_jax``,
``inner.weight_g``/``inner.weight_v`` included) and inputs from numpy
seeds.  Forward outputs and grads agree within rtol 1e-5 (fp32; the two
packages' matmuls sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as jfp16
from apex_tpu import nn as jnn
from apex_tpu.reparameterization import apply_weight_norm as japply
from apex_tpu.reparameterization import compute_weight as jcompute
from apex_tpu.reparameterization import remove_weight_norm as jremove

from apex_tpu_torch import nn
from apex_tpu_torch.fp16_utils import Fused_Weight_Norm
from apex_tpu_torch.reparameterization import (WeightNorm, apply_weight_norm,
                                               compute_weight,
                                               remove_weight_norm)
from apex_tpu_torch.utils.jax_interop import rnn_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _x(seed=1, shape=(3, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(dim=0):
    """A JAX wrapped Linear and the port's, on the JAX weights."""
    jwn = japply(jnn.Linear(6, 4), name="weight", dim=dim)
    jp, _ = jwn.init(jax.random.PRNGKey(0))
    wn = apply_weight_norm(nn.Linear(6, 4, generator=torch.Generator()),
                           name="weight", dim=dim)
    wn.load_state_dict(rnn_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jwn, jp, wn


def test_weight_norm_preserves_initial_output():
    """At wrap time g = ||w||: the wrapped module computes the plain one's
    output, and the JAX wrapper's on the JAX weights."""
    g = torch.Generator().manual_seed(0)
    lin = nn.Linear(6, 4, generator=g)
    x = torch.from_numpy(_x())
    ref = lin(x).detach()
    wn = apply_weight_norm(lin, name="weight", dim=0)
    np.testing.assert_allclose(wn(x).detach().numpy(), ref.numpy(), **TOL)
    jwn, jp, wn = _pair()
    jout, _ = jwn.apply(jp, jnp.asarray(_x()))
    np.testing.assert_allclose(wn(x).detach().numpy(), np.asarray(jout),
                               **TOL)


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_param_structure_and_grad(dim):
    jwn, jp, wn = _pair(dim)
    names = dict(wn.named_parameters())
    assert set(names) == {"inner.weight_g", "inner.weight_v", "inner.bias"}
    assert tuple(names["inner.weight_g"].shape) == tuple(
        jp["inner"]["weight_g"].shape)
    x = _x()
    (wn(torch.from_numpy(x)) ** 2).sum().backward()

    def loss(p):
        out, _ = jwn.apply(p, jnp.asarray(x))
        return jnp.sum(out ** 2)

    jg = jax.grad(loss)(jp)["inner"]
    for k in ("weight_g", "weight_v", "bias"):
        got = names[f"inner.{k}"].grad
        assert torch.all(torch.isfinite(got))
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-5)


def test_remove_weight_norm_bakes_weight():
    jwn, jp, wn = _pair()
    x = torch.from_numpy(_x())
    with torch.no_grad():
        wn.inner.weight_g.mul_(1.5)     # move off the initial magnitude
    ref = wn(x).detach()
    plain = remove_weight_norm(wn)
    assert set(dict(plain.named_parameters())) == {"weight", "bias"}
    np.testing.assert_allclose(plain(x).detach().numpy(), ref.numpy(), **TOL)
    jp["inner"]["weight_g"] = jp["inner"]["weight_g"] * 1.5
    jplain, jpp = jremove(jwn, jp)
    np.testing.assert_allclose(plain.weight.detach().numpy(),
                               np.asarray(jpp["weight"]), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compute_weight_unit_norm(dtype):
    v = _x(0, (4, 6))
    g = np.ones((4, 1), np.float32)
    w = compute_weight(torch.from_numpy(g), torch.from_numpy(v).to(dtype), 0)
    assert w.dtype == dtype
    norms = torch.sqrt(torch.sum(w.float() ** 2, dim=1))
    np.testing.assert_allclose(norms.numpy(), np.ones(4), rtol=1e-2 if
                               dtype == torch.bfloat16 else 1e-5)
    if dtype == torch.float32:
        jw = jcompute(jnp.asarray(g), jnp.asarray(v), dim=0)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        fw = Fused_Weight_Norm.apply(torch.from_numpy(v),
                                     torch.from_numpy(g), 0)
        np.testing.assert_allclose(
            fw.numpy(), np.asarray(jfp16.Fused_Weight_Norm.apply(
                jnp.asarray(v), jnp.asarray(g), 0)), **TOL)
    assert isinstance(apply_weight_norm(
        nn.Linear(2, 2, generator=torch.Generator())), WeightNorm)
