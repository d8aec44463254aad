"""The port's encoder-decoder serving engine
(``apex_tpu_torch.serving.Seq2SeqEngine``) against the JAX package's on
the CPU: the JAX seq2seq tests' tiny T5 (vocab 64, width 32, 2 + 2
layers, 4 heads) with one set of weights in both packages; staggered
arrivals, mixed source lengths, the queue, slot reuse and EOS, at
windows 1 and 4, give the JAX engine's tokens at every step in fp32; the
slot state leaf by leaf, the two-resident ledger, ``stats()`` and census
keys and validation errors equal."""

import numpy as np
import pytest

from apex_tpu import serving as jserving

from apex_tpu_torch import serving
from apex_tpu_torch.utils.jax_interop import kv_cache_from_jax

import torch_serving_util as su


@pytest.fixture(scope="module")
def t5():
    return su.t5(50)


@pytest.mark.parametrize("window", [1, 4])
def test_matches_jax(t5, window):
    jm, params, tm = t5
    jeng = jserving.Seq2SeqEngine(jm, params, slots=2, src_len=12,
                                  max_new_cap=10, window=window)
    teng = serving.Seq2SeqEngine(tm, slots=2, src_len=12, max_new_cap=10,
                                 window=window)
    pa, pb, pc = su.prompts(50, (11, 4, 7), low=2)
    first = su.same_traffic(jeng, teng, [("add", pa, 1, {}),
                                         ("drain",)])[0][0]
    got = su.same_traffic(jeng, teng, [
        ("add", pa, 9, {}), ("step",), ("add", pb, 5, {}),
        ("submit", pc, 7, {}), ("drain",),
        ("add", pa, 8, {"eos_token_id": first}), ("step",),
        ("add", pb, 12, {}), ("drain",)])
    assert [len(r) for r in got] == [9, 5, 7, 1, 10]
    su.assert_tree_close(teng.state,
                         su.kv_numpy(kv_cache_from_jax(jeng.state)))
    su.assert_tree_close(teng.out, np.asarray(jeng.out))
    assert teng.kv_fragmentation() == jeng.kv_fragmentation()
    assert set(teng.stats()) == set(jeng.stats())
    assert teng.compile_census() == jeng.compile_census()


def test_ledger_and_validation(t5):
    jm, params, tm = t5
    jeng = jserving.Seq2SeqEngine(jm, params, slots=2, src_len=12,
                                  max_new_cap=10)
    teng = serving.Seq2SeqEngine(tm, slots=2, src_len=12, max_new_cap=10)
    src = su.prompts(12, (9,), low=2)[0]
    for script in ([], [("add", src, 4, {})], [("step",)], [("drain",)]):
        su.same_traffic(jeng, teng, script)
        assert teng.kv_fragmentation() == jeng.kv_fragmentation()
    for bad in ((list(range(13)), 2, {}), ([3, 4], 2, {"seed": 1}),
                ([3], 2, {"temperature": 0.5}), ([3], 0, {})):
        with pytest.raises(ValueError) as je:
            jeng.submit(bad[0], bad[1], **bad[2])
        with pytest.raises(ValueError) as te:
            teng.submit(bad[0], bad[1], **bad[2])
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="window"):
        serving.Seq2SeqEngine(tm, slots=1, src_len=8, max_new_cap=4,
                              window=0)
