"""The port's recurrent stack (``apex_tpu_torch.RNN``) against the JAX
package's ``apex_tpu.RNN``, on the CPU: each of the five cells (LSTM,
GRU, ReLU, Tanh, mLSTM) as a two-layer stack, bidirectional, with the
output projection and from a given hidden state, on the JAX weights
(``utils.jax_interop.rnn_from_jax``) and inputs from numpy seeds.
Outputs, final hidden states and the grads of a loss on them (against
``jax.grad``) agree within rtol 1e-5 and atol 1e-5 (fp32; the matmuls sum
in different orders).  Also the refusals (GRU's projection,
``batch_first``), the gate matmuls' dtypes under amp O1 (bf16 gates, the
LSTM cell state stored back in its own dtype) against the JAX package's
O1 run (bf16: atol 3e-2), and the inter-layer dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import RNN as JRNN
from apex_tpu import amp as jamp

from apex_tpu_torch import RNN, amp
from apex_tpu_torch.utils.jax_interop import rnn_from_jax

T, B, F, H = 5, 3, 4, 6
TOL = dict(rtol=1e-5, atol=1e-5)
CELLS = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]


@pytest.fixture(autouse=True)
def _no_policy():
    yield
    amp.set_policy(amp.NoPolicy())
    jamp.set_policy(jamp.NoPolicy())


def _gen():
    return torch.Generator().manual_seed(0)


def _pair(cell, **kw):
    jm = getattr(JRNN, cell)(F, H, **kw)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    m = getattr(RNN, cell)(F, H, generator=_gen(), **kw)
    m.load_state_dict(rnn_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, m


def _x(seed=2, dtype=np.float32):
    return np.random.RandomState(seed).randn(T, B, F).astype(dtype)


def _leaves(h):
    if isinstance(h, torch.Tensor):
        return [h]
    return [t for part in h for t in _leaves(part)]


def _jleaves(h):
    return jax.tree_util.tree_leaves(h)


def _check(jm, jp, m, x, hidden=None, jhidden=None):
    (jout, jh), _ = jm.apply(jp, jnp.asarray(x), jhidden)
    out, h = m(torch.from_numpy(x), hidden)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, b in zip(_leaves(h), _jleaves(jh)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    # grads of a loss on the outputs and the final hidden state
    loss = (out ** 2).sum() + sum((t ** 2).sum() for t in _leaves(h))
    loss.backward()

    def jloss(p):
        (o, hh), _ = jm.apply(p, jnp.asarray(x), jhidden)
        return jnp.sum(o ** 2) + sum(jnp.sum(t ** 2) for t in _jleaves(hh))

    jg = rnn_from_jax(jax.tree_util.tree_map(np.asarray,
                                             jax.grad(jloss)(jp)))
    named = dict(m.named_parameters())
    assert set(named) == set(jg)
    for k, g in jg.items():
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   err_msg=k, **TOL)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_stacked(cell):
    out = _check(*_pair(cell, num_layers=2), _x())
    assert out.shape == (T, B, H)


@pytest.mark.parametrize("cell", CELLS)
def test_bidirectional(cell):
    out = _check(*_pair(cell, bidirectional=True), _x(3))
    assert out.shape == (T, B, 2 * H)


@pytest.mark.parametrize("cell", ["LSTM", "ReLU", "Tanh", "mLSTM"])
def test_output_projection(cell):
    jm, jp, m = _pair(cell, output_size=7, num_layers=2)
    assert "rnns.0.w_ho" in dict(m.named_parameters())
    out = _check(jm, jp, m, _x(4))
    assert out.shape == (T, B, 7)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_from_a_hidden_state(cell):
    """The final hidden state fed back in, against the JAX package's."""
    jm, jp, m = _pair(cell)
    x = _x(5)
    (_, jh), _ = jm.apply(jp, jnp.asarray(x))
    _, h = m(torch.from_numpy(x))
    h = [tuple(t.detach() for t in part) for part in h]
    cold, _ = m(torch.from_numpy(x))
    warm = _check(jm, jp, m, x, h, jh)
    assert float((cold - warm).detach().abs().max()) > 1e-6


def test_refusals():
    with pytest.raises(NotImplementedError, match="GRU"):
        RNN.GRU(F, H, output_size=7, generator=_gen())
    with pytest.raises(NotImplementedError, match="batch_first"):
        RNN.LSTM(F, H, batch_first=True, generator=_gen())
    with pytest.raises(NotImplementedError):
        JRNN.GRU(F, H, output_size=7).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("cell", ["LSTM", "mLSTM"])
def test_o1_gate_dtypes(cell):
    """Under O1 the gate matmuls run in bf16: the output is bf16, the cell
    state is formed in bf16 and stored back in its own dtype (fp32 from
    an fp32 start), and a bf16 run agrees with the JAX package's O1 run."""
    jm, jp, m = _pair(cell)
    seen = []
    from apex_tpu_torch.nn import functional as Fn
    linear = Fn.linear

    def spy(*a, **k):
        y = linear(*a, **k)
        seen.append(y.dtype)
        return y

    amp.set_policy(amp.CastPolicy(torch.bfloat16))
    try:
        RNN.cells.F.linear = spy
        out, ((h, c),) = m(torch.from_numpy(_x()))
    finally:
        RNN.cells.F.linear = linear
    assert set(seen) == {torch.bfloat16}
    assert out.dtype == h.dtype == torch.bfloat16 and c.dtype == torch.float32
    xb = torch.from_numpy(_x()).to(torch.bfloat16)
    out, ((h, c),) = m(xb)
    assert c.dtype == torch.bfloat16
    jamp.set_policy(jamp.CastPolicy(jnp.bfloat16))
    (jout, _), _ = jm.apply(jp, jnp.asarray(_x(), jnp.bfloat16))
    assert jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout, np.float32), atol=3e-2)


def test_interlayer_dropout():
    """Dropout between layers in train mode only, from its generator."""
    def model():
        return RNN.LSTM(F, H, num_layers=3, dropout=0.5, generator=_gen(),
                        dropout_generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(_x())
    a, b = model(), model()
    out_a, _ = a(x)
    out_b, _ = b(x)
    assert torch.equal(out_a, out_b)           # same generator seed
    a.eval()
    plain, _ = a(x)
    assert not torch.equal(plain, out_a)
    a2 = model()
    a2.dropout = 0.0
    assert torch.equal(a2(x)[0], plain)
