"""The port's fixed-slot serving engine (``apex_tpu_torch.serving.Engine``)
against the JAX package's on the CPU.

The JAX serving tests' models (a GPT of vocab 64, block 24, 2 layers, 4
heads, width 32, 2 KV heads; a tiny Mistral-windowed Llama for rolling)
with one set of weights in both packages (``utils.jax_interop``).  Every
script of requests and steps runs on a JAX engine and a port engine of
the same configuration, and both give the same tokens at every step, in
fp32: staggered arrivals, EOS freeing a slot that is reused, the queue,
cancel and preemption, windows of 4 against 1, prefix splice (also with
the int8 KV cache), rolling and speculative engines.  The caches are
held leaf by leaf, the ledgers, ``stats()`` keys, census keys and
validation errors equal.  Sampled mode keeps the port's own contracts
(its stream is not JAX's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import serving as jserving

from apex_tpu_torch import serving
from apex_tpu_torch.serving import _mix32, _mul32, _stream_word
from apex_tpu_torch.utils.jax_interop import kv_cache_from_jax

import torch_serving_util as su


@pytest.fixture(scope="module")
def gpt0():
    return su.gpt(0)


@pytest.fixture(scope="module")
def fixed(gpt0):
    """A JAX engine and a port engine (3 slots, buf 24, window 1), kept in
    lockstep by the tests of this module that use them, in order."""
    jm, params, tm = gpt0
    return (jserving.Engine(jm, params, slots=3, buf_len=su.BUF),
            serving.Engine(tm, slots=3, buf_len=su.BUF))


def test_staggered_arrivals(fixed):
    pa, pb, pc = su.prompts(0, (6, 4, 9))
    got = su.same_traffic(*fixed, [
        ("add", pa, 8, {}), ("step",), ("step",), ("step",),
        ("add", pb, 10, {}), ("step",), ("step",),
        ("add", pc, 5, {}), ("drain",)])
    assert [len(r) for r in got] == [8, 10, 5]


def test_eos_frees_the_slot_and_reuse_is_clean(fixed):
    jeng, teng = fixed
    pa, pb, pc, pd = su.prompts(1, (5, 7, 3, 8))
    # the first token of a solo run of pa is its EOS
    first = su.same_traffic(jeng, teng, [("add", pa, 1, {}),
                                         ("drain",)])[0][0]
    got = su.same_traffic(jeng, teng, [
        ("add", pa, 8, {"eos_token_id": first}), ("add", pb, 6, {}),
        ("step",), ("add", pc, 4, {}), ("add", pd, 5, {}), ("drain",)])
    assert got[0] == [first]
    assert teng.live() == 0 and teng.free_slots() == 3


def test_queue_cancel_preempt_and_take_waiting(fixed):
    jeng, teng = fixed
    ps = su.prompts(2, (5, 4, 9, 3, 6, 7))
    script = [("submit", p, 4 + i, {}) for i, p in enumerate(ps)]
    script += [("step",), ("cancel", 3), ("preempt", 1), ("step",)]
    su.play(jeng, script)
    su.play(teng, script)
    assert teng.queue_depth() == jeng.queue_depth()
    assert teng.stats()["preempted"] == jeng.stats()["preempted"] == 1
    taken_j, taken_t = jeng.take_waiting(), teng.take_waiting()
    assert [(r, [int(t) for t in p], n) for r, p, n, *_ in taken_j] \
        == [(r, p, n) for r, p, n, *_ in taken_t]
    while jeng.live():
        jeng.step()
    while teng.live():
        teng.step()
    for r in range(len(ps)):
        assert teng.is_finished(r) == jeng.is_finished(r)
        if teng.is_finished(r):
            assert teng.result(r) == [int(t) for t in jeng.result(r)]
    assert not teng.cancel(0) and not teng.preempt(99)


def test_caches_leaf_by_leaf(fixed):
    jeng, teng = fixed
    pa, pb = su.prompts(3, (6, 11))
    su.same_traffic(jeng, teng, [("add", pa, 5, {}), ("add", pb, 4, {}),
                                 ("step",), ("step",)])
    for slot in teng._by_slot:
        live = {k: {n: t[slot] for n, t in layer.items()}
                for k, layer in teng.cache.items()}
        want = {k: {n: np.asarray(t)[slot] for n, t in layer.items()}
                for k, layer in jeng.cache.items()}
        su.assert_tree_close(live, su.kv_numpy(kv_cache_from_jax(want)))
    su.assert_tree_close(teng.ids, np.asarray(jeng.ids))
    su.assert_tree_close(teng.cur_len, np.asarray(jeng.cur_len))
    su.play(jeng, [("drain",)])
    su.play(teng, [("drain",)])


def test_ledger_stats_and_census_equal(fixed):
    jeng, teng = fixed
    pa, pb = su.prompts(4, (6, 3))
    for script in ([], [("add", pa, 4, {})], [("step",)],
                   [("add", pb, 3, {}), ("step",)], [("drain",)]):
        su.same_traffic(jeng, teng, script)
        fj, ft = jeng.kv_fragmentation(), teng.kv_fragmentation()
        assert ft == fj
        assert teng.metrics.gauge("engine_kv_waste_bytes").value \
            == ft["kv_waste_bytes"]
    sj, st = jeng.stats(), teng.stats()
    assert set(st) == set(sj)
    for k in ("live", "waiting", "free", "finished", "admitted",
              "tokens_generated", "decode_steps", "host_syncs",
              "kv_cache_bytes", "kv_waste_bytes", "window",
              "admission_mode", "prefix_hits"):
        assert st[k] == sj[k], k
    # no device memory census on the CPU
    assert st["device_live_bytes"] is None and st["hbm_occupancy"] is None
    assert set(st["ttft"]) == set(sj["ttft"])
    assert teng.compile_census() == jeng.compile_census()


def test_warmup_on_the_cpu(fixed):
    jeng, teng = fixed
    assert teng.warmup() is teng
    assert teng.captures == {}          # the CPU captures nothing
    jeng.warmup()
    su.play(jeng, [("add", [1, 2], 2, {})])
    su.play(teng, [("add", [1, 2], 2, {})])
    with pytest.raises(RuntimeError, match="idle"):
        teng.warmup()
    su.play(jeng, [("drain",)])
    su.play(teng, [("drain",)])


@pytest.mark.parametrize("name", [
    "DONATION_BLOCKLIST", "STEP_K_ARG_NAMES", "PREFILL_SLOT_ARG_NAMES",
    "SEQ2SEQ_STEP_K_ARG_NAMES", "PAGED_STEP_K_ARG_NAMES",
    "PAGED_ADMIT_ARG_NAMES"])
def test_argument_names_are_the_jax_packages(name):
    assert name in serving.__all__ and name in jserving.__all__
    assert getattr(serving, name) == getattr(jserving, name)


def test_captures_count_the_captured_graphs(gpt0):
    """``captures`` is read off the engine's graphs: a graph counts once
    it holds a capture, under its census name."""
    eng = serving.Engine(gpt0[2], slots=2, buf_len=su.BUF, window=2)
    assert eng.captures == {}
    assert sorted(set(eng._graphs.values())) == sorted(
        eng.compile_census())
    for g, name in eng._graphs.items():
        if name == "engine._step_k":
            g.graph = object()          # what a capture leaves
    assert eng.captures == {"engine._step_k": 1}


@pytest.mark.parametrize("window", [4])
def test_window_against_window_1(gpt0, window):
    """Staggered arrivals at window boundaries, a max-token freeze and an
    EOS mid-window: the K-tick window gives the JAX engine's tokens at
    every step, and every request the K = 1 engine's tokens."""
    jm, params, tm = gpt0
    pa, pb, pc, pd = su.prompts(5, (6, 4, 9, 5))
    k1 = serving.Engine(tm, slots=3, buf_len=su.BUF)
    solo = su.play(k1, [("add", pd, 8, {}), ("drain",)])[1]
    eos = [t for out in solo for t in out[0]][2]
    script = [("add", pa, 8, {}), ("step",), ("add", pb, 10, {}),
              ("step",), ("add", pc, 5, {}),
              ("submit", pd, 8, {"eos_token_id": eos}), ("drain",)]
    got = su.same_traffic(
        jserving.Engine(jm, params, slots=3, buf_len=su.BUF,
                        window=window),
        serving.Engine(tm, slots=3, buf_len=su.BUF, window=window), script)
    assert got == su.results(k1, su.play(k1, script)[0])
    assert got[3][-1] == eos and len(got[3]) == 3


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefix_splice(gpt0, cache_dtype):
    """Registered prefixes admit by splice: the JAX engine's tokens (the
    splice's suffix runs through decode_chunk, exactly as there), the
    pool rows leaf by leaf, boundary lengths (prompt = buf_len - 1, a
    suffix of one chunk, of one token, an exact match) and slot reuse."""
    jm, params, tm = gpt0
    jd, td = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jeng = jserving.Engine(jm, params, slots=3, buf_len=su.BUF,
                           cache_dtype=jd, prefix_pool=2, prefix_chunk=4)
    teng = serving.Engine(tm, slots=3, buf_len=su.BUF, cache_dtype=td,
                          prefix_pool=2, prefix_chunk=4)
    pref = su.prompts(6, (10,))[0]
    assert teng.register_prefix(pref) == jeng.register_prefix(pref) == 0
    su.assert_tree_close(
        {k: {n: t[0] for n, t in layer.items()}
         for k, layer in teng._pool_cache.items()},
        {k: {n: np.asarray(t)[0] for n, t in layer.items()}
         for k, layer in jeng._pool_cache.items()})
    tails = su.prompts(7, (13, 4, 1, 3))
    script = [("submit", pref + t, 1 if len(t) == 13 else 5, {})
              for t in tails]
    script += [("submit", su.prompts(8, (5,))[0], 4, {}),
               ("submit", list(pref), 4, {}), ("drain",),
               ("submit", su.prompts(9, (9,))[0], 5, {}), ("drain",)]
    su.same_traffic(jeng, teng, script)
    assert teng.prefix_hits == jeng.prefix_hits == 5
    assert teng.kv_fragmentation() == jeng.kv_fragmentation()


def test_rolling_engine():
    """Sliding-window serving with ring caches of the window's width:
    prompts longer and shorter than the window, generation across several
    wrap-arounds, staggered arrivals, at windows 1 and 4."""
    jm, params, tm = su.mistral(40)
    pa, pb = su.prompts(40, (9, 3), vocab=97)
    script = [("add", pa, 12, {}), ("step",), ("add", pb, 14, {}),
              ("drain",)]
    for window in (1, 4):
        teng = serving.Engine(tm, slots=2, buf_len=32, rolling=True,
                              window=window)
        assert teng.cache["0"]["k"].shape[2] == 5
        jeng = jserving.Engine(jm, params, slots=2, buf_len=32,
                               rolling=True, window=window)
        su.same_traffic(jeng, teng, script)
        assert teng.kv_fragmentation() == jeng.kv_fragmentation()


def test_speculative_engine(gpt0):
    """Continuous batching + speculative decoding: staggered arrivals, a
    different-weights draft and a perfect one, EOS inside an accepted
    run: the JAX engine's tokens at every step."""
    jm, params, tm = gpt0
    djm, dparams, dtm = su.gpt(11)
    pa, pb = su.prompts(10, (6, 4))
    jeng = jserving.Engine(jm, params, slots=2, buf_len=su.BUF, draft=djm,
                           draft_params=dparams, gamma=3)
    teng = serving.Engine(tm, slots=2, buf_len=su.BUF, draft=dtm, gamma=3)
    su.same_traffic(jeng, teng, [("add", pa, 9, {}), ("step",),
                                 ("add", pb, 7, {}), ("drain",)])
    assert teng.compile_census() == jeng.compile_census()
    assert teng.kv_fragmentation() == jeng.kv_fragmentation()
    perfect = serving.Engine(tm, slots=1, buf_len=su.BUF, draft=tm,
                             gamma=4)
    jperfect = jserving.Engine(jm, params, slots=1, buf_len=su.BUF,
                               draft=jm, draft_params=params, gamma=4)
    solo = su.results(jeng, [0])[0]
    got = su.same_traffic(jperfect, perfect, [
        ("add", pa, 9, {"eos_token_id": solo[1]}), ("drain",),
        ("add", pa, 8, {}), ("drain",)])
    assert got[0] == solo[:solo.index(solo[1]) + 1]
    assert got[1] == solo[:8]


# -- sampled mode: the port's own contracts --------------------------------

def test_hash_is_the_same_on_ints_and_tensors():
    xs = [0, 1, 2 ** 31, 2 ** 32 - 1, 123456789, 0x9E3779B9]
    t = torch.tensor(xs, dtype=torch.int64)
    assert _mix32(t).tolist() == [_mix32(x) for x in xs]
    assert _mul32(t, 0x846CA68B).tolist() == [
        (x * 0x846CA68B) % 2 ** 32 for x in xs]
    assert all(0 <= _mix32(x) < 2 ** 32 for x in xs)
    # domain separation: a seed never collides with the same rid
    assert _stream_word(3, 0, 7) != _stream_word(3, 1, 7)
    assert _stream_word(-1, 1, -5) == _stream_word(-1, 1, -5)


def _sampled(tm, **kw):
    kw.setdefault("slots", 2)
    return serving.Engine(tm, buf_len=su.BUF, temperature=1.0, top_k=16,
                          rng=3, **kw)


def test_seeded_requests_are_batch_and_window_independent(gpt0):
    """An explicitly seeded request draws the same tokens alone, with
    other traffic, arriving late through the queue, and at any window."""
    _, _, tm = gpt0
    px, pa, pb = su.prompts(36, (5, 8, 3))
    alone = su.results(*(lambda e: (e, su.play(
        e, [("add", px, 9, {"seed": 7}), ("drain",)])[0]))(_sampled(tm)))
    for window in (1, 4):
        eng = _sampled(tm, window=window)
        rids, _ = su.play(eng, [
            ("submit", pa, 9, {"seed": 1}), ("submit", pb, 4, {"seed": 2}),
            ("step",), ("submit", px, 9, {"seed": 7}), ("drain",)])
        assert su.results(eng, rids)[2] == alone[0], window
    assert len(alone[0]) == 9 and all(0 <= t < su.VOCAB for t in alone[0])
    other = _sampled(tm)
    r = su.play(other, [("add", px, 9, {"seed": 8}), ("drain",)])[0]
    assert su.results(other, r)[0] != alone[0]


def test_temperature_zero_is_the_argmax_row(gpt0, fixed):
    """On a sampled engine a temperature-0 request is greedy (the JAX
    greedy engine's tokens) while sampled co-tenants draw; a near-zero
    and a scorching temperature on one seed diverge."""
    jm, params, tm = gpt0
    jeng, _ = fixed
    pg, ps = su.prompts(38, (5, 4))
    eng = _sampled(tm)
    rids, _ = su.play(eng, [("add", pg, 6, {"temperature": 0.0}),
                            ("add", ps, 8, {}), ("drain",)])
    jr, _ = su.play(jeng, [("add", pg, 6, {}), ("drain",)])
    assert su.results(eng, rids)[0] == su.results(jeng, jr)[0]
    sharp = su.gpt(38, scale=True)[2]
    eng = _sampled(sharp)
    rids, _ = su.play(eng, [("add", pg, 6, {"seed": 9,
                                            "temperature": 0.05}),
                            ("add", pg, 6, {"seed": 9,
                                            "temperature": 50.0}),
                            ("drain",)])
    cold, hot = su.results(eng, rids)
    assert cold != hot


# -- validation: the JAX package's exception type for each misuse --------

def _raises_alike(jfn, tfn):
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert type(te.value) is type(je.value), (je.value, te.value)
    return te.value


def test_validation_matches(gpt0):
    jm, params, tm = gpt0
    mm, mp, mt = su.mistral(41)
    djm, dparams, dtm = su.gpt(11)
    J, T = jserving.Engine, serving.Engine
    cases = [
        (lambda: J(jm, params, 1, su.BUF, window=0),
         lambda: T(tm, 1, su.BUF, window=0)),
        (lambda: J(jm, params, 1, su.BUF, window=4, draft=djm,
                   draft_params=dparams),
         lambda: T(tm, 1, su.BUF, window=4, draft=dtm)),
        (lambda: J(jm, params, 1, su.BUF, temperature=0.5, draft=djm,
                   draft_params=dparams),
         lambda: T(tm, 1, su.BUF, temperature=0.5, draft=dtm)),
        (lambda: J(jm, params, 1, su.BUF, rolling=True),
         lambda: T(tm, 1, su.BUF, rolling=True)),
        (lambda: J(mm, mp, 1, 32, rolling=True, prefix_pool=1),
         lambda: T(mt, 1, 32, rolling=True, prefix_pool=1)),
        (lambda: J(mm, mp, 1, 32, rolling=True, draft=mm,
                   draft_params=mp),
         lambda: T(mt, 1, 32, rolling=True, draft=mt)),
        (lambda: J(mm, mp, 1, 32, rolling=True, cache_dtype=jnp.int8),
         lambda: T(mt, 1, 32, rolling=True, cache_dtype=torch.int8)),
        (lambda: J(jm, params, 1, su.BUF, prefix_pool=1, prefix_chunk=0),
         lambda: T(tm, 1, su.BUF, prefix_pool=1, prefix_chunk=0)),
        (lambda: J(jm, params, 1, su.BUF).register_prefix([1]),
         lambda: T(tm, 1, su.BUF).register_prefix([1])),
    ]
    for jfn, tfn in cases:
        _raises_alike(jfn, tfn)
    je, te = J(jm, params, 1, su.BUF, prefix_pool=1), T(tm, 1, su.BUF,
                                                        prefix_pool=1)
    for e in (je, te):
        e.register_prefix([5, 6, 7])
    _raises_alike(lambda: je.register_prefix([1]),
                  lambda: te.register_prefix([1]))
    for bad in ((list(range(24)), 2, {}), ([], 2, {}), ([1], 0, {}),
                ([1], 2, {"seed": 3}), ([1], 2, {"temperature": 0.5})):
        _raises_alike(lambda: je.add_request(bad[0], bad[1], **bad[2]),
                      lambda: te.add_request(bad[0], bad[1], **bad[2]))
    sj = J(jm, params, 1, su.BUF, temperature=1.0)
    st = T(tm, 1, su.BUF, temperature=1.0)
    _raises_alike(lambda: sj.add_request([1], 2, temperature=-1.0),
                  lambda: st.add_request([1], 2, temperature=-1.0))
    for e in (je, te):
        e.add_request([1, 2, 3], 4)
    _raises_alike(lambda: je.add_request([4, 5], 4),
                  lambda: te.add_request([4, 5], 4))
    e2j = J(jm, params, 1, su.BUF, prefix_pool=2)
    e2t = T(tm, 1, su.BUF, prefix_pool=2)
    for e in (e2j, e2t):
        e.register_prefix([5, 6])
        e.register_prefix([5, 6, 7, 8])
    for p in ([5, 6, 7, 8, 9], [5, 6, 9], [9, 5, 6]):
        assert e2t._match_prefix(p) == e2j._match_prefix(p)
