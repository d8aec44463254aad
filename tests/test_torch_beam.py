"""Beam search of the port against the JAX package on the CPU.

A tiny GPT (vocab 16, block 16, 2 layers, 4 heads, width 32) from the
JAX package's ``init``, carried over by ``utils.jax_interop``: the
beams' ids and ``final_len`` equal the JAX package's and the score is
within rtol 1e-5; one beam is greedy decoding; a row that finishes early
keeps its best hypothesis; the validation error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import models as jmodels
from apex_tpu.models import beam_search as jbeam

from apex_tpu_torch import models
from apex_tpu_torch.models import beam_search
from apex_tpu_torch.utils.jax_interop import params_from_jax

CFG = dict(vocab_size=16, block_size=16, n_layer=2, n_head=4, n_embd=32,
           dropout=0.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _gpt(seed):
    jm = jmodels.GPT(jmodels.GPTConfig(**CFG))
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = models.GPT(models.GPTConfig(**CFG), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm


def _buf(seed, lens):
    rng = np.random.RandomState(seed)
    buf = np.zeros((len(lens), 16), np.int32)
    for i, n in enumerate(lens):
        buf[i, :n] = rng.randint(0, 16, n)
    return buf, np.asarray(lens, np.int32)


@pytest.mark.parametrize("num_beams,lens,new", [
    (4, (4, 6), 6), (3, (5, 3), 11), (2, (12,), 8)])
def test_beams_match_jax(num_beams, lens, new):
    """ids and final_len equal the JAX package's, the score at rtol 1e-5;
    the last case saturates at the buffer end."""
    jm, jp, tm = _gpt(2)
    buf, plen = _buf(2, lens)
    jo, jn, js = jax.jit(lambda p: jbeam(jm, p, jnp.asarray(buf),
                                         jnp.asarray(plen), new,
                                         num_beams=num_beams))(jp)
    out, n, score = beam_search(tm, _t(buf), _t(plen), new,
                                num_beams=num_beams)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(score.numpy(), np.asarray(js), rtol=1e-5)
    assert score.dtype == torch.float32


def test_beam1_equals_greedy():
    _, _, tm = _gpt(0)
    buf, plen = _buf(0, (5, 3))
    ref, n_ref = tm.generate_cached(_t(buf), _t(plen), 6)
    out, n, _ = beam_search(tm, _t(buf), _t(plen), 6, num_beams=1)
    np.testing.assert_array_equal(n.numpy(), n_ref.numpy())
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_beam_score_dominates_greedy():
    """The 4-beam score is at least greedy's (beam 1's score is the greedy
    continuation's log-probability)."""
    _, _, tm = _gpt(2)
    buf, plen = _buf(2, (4, 6))
    _, _, s1 = beam_search(tm, _t(buf), _t(plen), 6, num_beams=1)
    _, _, s4 = beam_search(tm, _t(buf), _t(plen), 6, num_beams=4)
    assert float(s4.sum()) >= float(s1.sum()) - 1e-3


def test_ragged_early_finish_keeps_best_hypothesis():
    """A row that finishes early freezes its ids and scores together: its
    result equals beam search on it alone."""
    _, _, tm = _gpt(4)
    buf, plen = _buf(4, (3, 9))
    out, n, score = beam_search(tm, _t(buf), _t(plen), 6, num_beams=4)
    solo, n0, s0 = beam_search(tm, _t(buf[:1]), _t(plen[:1]), 6,
                               num_beams=4)
    np.testing.assert_array_equal(out[0, :int(n[0])].numpy(),
                                  solo[0, :int(n0[0])].numpy())
    np.testing.assert_allclose(float(score[0]), float(s0[0]), rtol=1e-5)


def test_ties_go_to_the_lower_index():
    """Equal totals: the lower flat index first, as ``lax.top_k``."""
    from apex_tpu_torch.models.beam import _top_k
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = _top_k(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]


def test_validation():
    _, _, tm = _gpt(3)
    with pytest.raises(ValueError, match="num_beams"):
        beam_search(tm, torch.zeros((1, 16), dtype=torch.int64), 4, 2,
                    num_beams=0)
    out, n, _ = beam_search(tm, torch.zeros((1, 16), dtype=torch.int64),
                            torch.tensor([2]), 4, num_beams=3)
    assert out.shape == (1, 16) and int(n[0]) == 6
