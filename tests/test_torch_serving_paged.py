"""The port's paged-KV engine (``apex_tpu_torch.serving.PagedEngine``)
against the JAX package's on the CPU.

The JAX serving tests' GPT (vocab 64, block 24, 2 layers, width 32, 2 KV
heads) with one set of weights in both packages.  Each script runs on a
JAX paged engine and a port paged engine of one configuration: the same
tokens at every step in fp32, the same block headroom and in-window
admissions after every window (the device's admission trace replayed by
the host), under pool pressure, with a block size that does not divide
the buffer, in-window admission and the int8 KV cache; the block pool,
tables and free stack leaf by leaf; the ledger's numbers, ``stats()``
keys, census keys and validation errors equal.  Sampled, the port's
paged engine draws its fixed engine's tokens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu import serving as jserving

from apex_tpu_torch import serving
from apex_tpu_torch.utils.jax_interop import kv_cache_from_jax

import torch_serving_util as su


@pytest.fixture(scope="module")
def gpt70():
    return su.gpt(70)


def _pair(gpt, **kw):
    jm, params, tm = gpt
    kw.setdefault("slots", 3)
    kw.setdefault("buf_len", su.BUF)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 8)
    jkw = dict(kw)
    if "cache_dtype" in kw:
        jkw["cache_dtype"] = getattr(jnp, kw["cache_dtype"])
        kw["cache_dtype"] = getattr(torch, kw["cache_dtype"])
    return (jserving.PagedEngine(jm, params, **jkw),
            serving.PagedEngine(tm, **kw))


def _blocks(eng):
    s = eng.stats()
    return s["blocks_free"], s["midwindow_admissions"], s["live"]


def same_windows(jeng, teng, script):
    """``su.same_traffic`` plus the block headroom, the in-window
    admissions and the live count after every step."""
    trace = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        rec = []
        step = eng.step

        def counted(step=step, eng=eng, rec=rec):
            out = step()
            rec.append(_blocks(eng))
            return out

        eng.step = counted
        try:
            rids, outs = su.play(eng, script)
        finally:
            del eng.step
        trace[name] = (rids, outs, rec, su.results(eng, rids))
    assert trace["port"] == trace["jax"]
    return trace["port"][3]


def _state(eng):
    out = {"tables": eng.tables, "n_blk": eng.n_blk, "kv_len": eng.kv_len,
           "cur_len": eng.cur_len, "limit": eng.limit, "ids": eng.ids,
           "free_stack": eng.free_stack, "free_top": eng.free_top}
    return {k: (v if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _script(seed):
    prompts = su.prompts(seed, (6, 4, 9, 2))
    return [("submit", prompts[0], 8, {}), ("step",),
            ("submit", prompts[1], 10, {}), ("submit", prompts[2], 5, {}),
            ("step",), ("submit", prompts[3], 7, {}), ("drain",)]


@pytest.mark.parametrize("window", [1, 4])
def test_pool_pressure_matches(gpt70, window):
    """Mixed prompts, staggered arrivals, num_blocks below the worst
    case (admissions contend for blocks): the JAX paged engine's tokens,
    headroom and in-window admissions window by window, and its pool,
    tables and free stack at the end; and the fixed-slot engine's
    tokens."""
    jeng, teng = _pair(gpt70, num_blocks=7, window=window)
    got = same_windows(jeng, teng, _script(70))
    su.assert_tree_close(teng.pool,
                         su.kv_numpy(kv_cache_from_jax(jeng.pool)))
    su.assert_tree_close(_state(teng), _state(jeng))
    assert teng.stats()["blocks_free"] == teng.stats()["blocks_total"]
    fixed = serving.Engine(gpt70[2], slots=3, buf_len=su.BUF)
    assert got == su.results(fixed, su.play(fixed, _script(70))[0])


def test_nondivisor_block_and_midwindow_admission(gpt70):
    """block_size 5 (the table pads past buf_len) on one slot with a
    16-tick window: the queued request is admitted inside the window the
    first one dies in, a mid-window EOS recycles its blocks in the same
    window, and the freed blocks are clean for the next occupant."""
    jeng, teng = _pair(gpt70, slots=1, block_size=5, window=16)
    pa, pb, pc = su.prompts(73, (5, 7, 6))
    got = same_windows(jeng, teng, [("submit", pa, 4, {}),
                                    ("submit", pb, 6, {}), ("step",)])
    assert teng.stats()["midwindow_admissions"] == 1
    assert teng.stats()["host_syncs"] == 1
    eos = got[1][2]
    got = same_windows(jeng, teng, [
        ("add", pb, 8, {"eos_token_id": eos}), ("step",),
        ("add", pc, 6, {}), ("drain",)])
    assert got[0][-1] == eos
    su.assert_tree_close(teng.pool,
                         su.kv_numpy(kv_cache_from_jax(jeng.pool)))
    assert teng.stats()["blocks_free"] == teng.num_blocks


def test_int8_kv(gpt70):
    jeng, teng = _pair(gpt70, slots=2, cache_dtype="int8", window=2)
    prompts = su.prompts(75, (4, 8, 5))
    same_windows(jeng, teng, [("add", prompts[0], 6, {}),
                              ("add", prompts[1], 6, {}),
                              ("submit", prompts[2], 5, {}), ("drain",)])
    su.assert_tree_close(teng.pool,
                         su.kv_numpy(kv_cache_from_jax(jeng.pool)))


def test_window_choice_moves_no_tokens(gpt70, monkeypatch):
    """The prefill window on every step gives the tokens of the host's
    choice between the two windows."""
    tm = gpt70[2]
    kw = dict(slots=2, buf_len=su.BUF, block_size=8, prefill_chunk=8,
              window=4)
    script = _script(71)
    chosen = serving.PagedEngine(tm, **kw)
    want = su.results(chosen, su.play(chosen, script)[0])
    monkeypatch.setattr(serving.PagedEngine, "_prefill_window",
                        lambda self: True)
    always = serving.PagedEngine(tm, **kw)
    assert su.results(always, su.play(always, script)[0]) == want


def test_ledger_cancel_admission_control_and_validation(gpt70):
    """The per-block ledger through admission, decode, cancel and finish;
    add_request on a block-starved engine and every constructor misuse
    raise the JAX package's exception types; census and stats keys."""
    jeng, teng = _pair(gpt70, slots=2, num_blocks=4)

    def both(fn):
        out = fn(jeng), fn(teng)
        assert teng.kv_fragmentation() == jeng.kv_fragmentation()
        assert _blocks(teng) == _blocks(jeng)
        return out

    both(lambda e: None)
    ra = both(lambda e: e.add_request([1] * 16, 8))       # 3 blocks
    for e in (jeng, teng):
        with pytest.raises(RuntimeError, match="no free KV blocks"):
            e.add_request([2] * 8, 8)                     # needs 2
    rb = both(lambda e: e.add_request([3] * 4, 4))        # 1 fits
    assert _blocks(teng)[0] == 0
    assert both(lambda e: e.cancel(rb[0])) == (True, True)
    both(lambda e: e.step())
    assert both(lambda e: e.cancel(ra[0])) == (True, True)
    both(lambda e: (e.submit([4] * 16, 6), e.submit([5] * 16, 6)))
    assert teng.live() == 1 and teng.queue_depth() == 1
    while teng.live() or teng.queue_depth():
        both(lambda e: e.step())
    assert teng.stats()["blocks_free"] == 4
    assert set(teng.stats()) == set(jeng.stats())
    assert teng.compile_census() == jeng.compile_census()
    jm, params, tm = gpt70
    for kw in ({"window": 0}, {"block_size": 0}, {"prefill_chunk": 0},
               {"num_blocks": 1}):
        with pytest.raises(ValueError) as je:
            jserving.PagedEngine(jm, params, 1, su.BUF, **kw)
        with pytest.raises(ValueError) as te:
            serving.PagedEngine(tm, 1, su.BUF, **kw)
        assert str(te.value) == str(je.value)


def test_sampled_paged_equals_fixed(gpt70):
    """Explicitly seeded streams: the paged engine draws the fixed
    engine's tokens at windows 1 and 4, staggered or not."""
    tm = gpt70[2]
    pa, pb = su.prompts(74, (5, 7))
    kw = dict(temperature=1.0, top_k=8, rng=9)

    def run(eng, stagger):
        script = [("add", pa, 9, {"seed": 3})] + (
            [("step",)] if stagger else []) + [
            ("add", pb, 6, {"seed": 4}), ("drain",)]
        return su.results(eng, su.play(eng, script)[0])

    base = run(serving.Engine(tm, slots=2, buf_len=su.BUF, **kw), False)
    for window in (1, 4):
        for stagger in (False, True):
            eng = serving.PagedEngine(tm, slots=2, buf_len=su.BUF,
                                      block_size=8, prefill_chunk=8,
                                      window=window, **kw)
            assert run(eng, stagger) == base, (window, stagger)
    assert [len(t) for t in base] == [9, 6]


def test_prefill_chunk_past_the_dense_width():
    """A prompt whose last prefill chunk would run past the dense view
    (21 tokens, chunks of 16, a 24-position buffer): the port's chunk
    slides back and recomputes the overlap, and the request decodes as
    its solo run (the JAX package's generate_cached) and the fixed engine
    do.  (The JAX paged engine's clamped write shifts that chunk's K/V
    here: ROADMAP.md queue 3.)"""
    jm, params, tm = su.gpt(3)
    p = su.prompts(5, (21,))[0]
    buf = jnp.zeros((1, su.BUF), jnp.int32).at[0, :21].set(jnp.asarray(p))
    out, fl = jm.generate_cached(params, buf, 21, 3)
    want = [int(t) for t in np.asarray(out[0, 21:int(fl[0])])]
    for eng in (serving.PagedEngine(tm, slots=1, buf_len=su.BUF,
                                    block_size=8, prefill_chunk=16),
                serving.Engine(tm, slots=1, buf_len=su.BUF)):
        assert su.results(eng, su.play(eng, [("add", p, 3, {}),
                                             ("drain",)])[0]) == [want]
