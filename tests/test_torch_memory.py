"""The port's memory observability (``apex_tpu_torch/observability/
memory.py``) against the JAX package's
(``apex_tpu/observability/memory.py``).

- ``graph_live_bytes`` (the last-use scan over a ``make_fx`` graph)
  against ``jaxpr_live_bytes`` on the same functions: an MLP's forward,
  a concatenate-then-reduce, and the fp32 upcast twin of
  ``tests/test_costmodel.py:257`` — the upcast multiplies the fp32 temp
  peak on both sides while the bf16 version keeps it near zero.  The
  peaks are equal where the two graphs hold the same values (the
  arguments always; the temps where each op is one primitive on both
  sides).
- ``record_live_arrays``: the gauge names and the census shape of the
  JAX package's; on the CPU the census counts live tensors, each storage
  once.
- ``memory_plan``'s refusal without a capture, its reassembly from a
  capture's allocator counts and its donated credit (the card's
  measurement is ``tests/test_torch_cuda.py``'s and ``chip_smoke.py``'s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.observability import exporters as jexporters
from apex_tpu.observability import memory as JM

from apex_tpu_torch import _graph
from apex_tpu_torch.observability import MetricsRegistry, exporters
from apex_tpu_torch.observability import memory as M

import torch_threads  # noqa: F401  (one torch thread a process)


def _w(shape, dtype):
    rs = np.random.RandomState(0)
    a = rs.randn(*shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(
        getattr(torch, str(jnp.dtype(dtype))))


def test_upcast_doubles_fp32_temps_on_both_sides():
    jw, tw = _w((256, 256), jnp.bfloat16)
    jx, tx = _w((64, 256), jnp.bfloat16)

    def jclean(x, w):
        h = jnp.maximum(x @ w, 0)
        return (h @ w).astype(jnp.float32).sum()

    def jup(x, w):
        h = jnp.maximum(x.astype(jnp.float32) @ w.astype(jnp.float32), 0)
        return (h @ w.astype(jnp.float32)).sum()

    def tclean(x, w):
        h = torch.clamp_min(x @ w, 0)
        return (h @ w).float().sum()

    def tup(x, w):
        h = torch.clamp_min(x.float() @ w.float(), 0)
        return (h @ w.float()).sum()

    got = {k: M.graph_live_bytes(f, tx, tw) for k, f in
           (("clean", tclean), ("up", tup))}
    want = {k: JM.jaxpr_live_bytes(jax.make_jaxpr(f)(jx, jw)) for k, f in
            (("clean", jclean), ("up", jup))}
    for k in got:
        assert got[k]["argument_bytes"] == want[k]["argument_bytes"] \
            == (64 + 256) * 256 * 2
        assert set(got[k]) == set(want[k])
    f32 = {k: got[k]["peak_temp_bytes_by_dtype"].get("float32", 0)
           for k in got}
    jf32 = {k: want[k]["peak_temp_bytes_by_dtype"].get("float32", 0)
            for k in want}
    assert f32["up"] > 2 * max(f32["clean"], 1)
    assert jf32["up"] > 2 * max(jf32["clean"], 1)
    # the upcast's fp32 peak: both sides hold the widened weight, the
    # widened input and the first product, then the second's
    assert f32["up"] == jf32["up"]
    assert got["up"]["peak_temp_bytes"] == want["up"]["peak_temp_bytes"]


def test_concat_then_reduce_peak_equals_jax():
    jx, tx = _w((1024,), jnp.float32)
    got = M.graph_live_bytes(
        lambda x: torch.cat([x, x, x]).sum().reshape(1), tx)
    want = JM.jaxpr_live_bytes(jax.make_jaxpr(
        lambda x: jnp.concatenate([x, x, x]).sum(keepdims=True))(jx))
    assert got["argument_bytes"] == want["argument_bytes"] == 4096
    assert got["peak_temp_bytes"] == want["peak_temp_bytes"] >= 3 * 4096
    assert got["peak_temp_bytes_by_dtype"] == \
        want["peak_temp_bytes_by_dtype"]


def test_mlp_forward_peak_equals_jax():
    jw1, tw1 = _w((32, 64), jnp.float32)
    jw2, tw2 = _w((64, 16), jnp.float32)
    jx, tx = _w((8, 32), jnp.float32)
    got = M.graph_live_bytes(
        lambda x, a, b: torch.tanh(x @ a) @ b, tx, tw1, tw2)
    want = JM.jaxpr_live_bytes(jax.make_jaxpr(
        lambda x, a, b: jnp.tanh(x @ a) @ b)(jx, jw1, jw2))
    assert got == want


def test_record_live_arrays_gauges_and_census():
    keep = torch.ones(1024)                      # noqa: F841 — stays live
    census = M.live_tensor_bytes("cpu")
    assert census["bytes"] >= 4096 and census["arrays"] >= 1
    assert set(census) == set(JM.live_array_bytes())
    reg, jreg = MetricsRegistry(), JRegistry()
    out = M.record_live_arrays(reg, platform="cpu")
    jout = JM.record_live_arrays(jreg, platform="cpu")
    assert set(reg._metrics) == set(jreg._metrics) == {
        "device_live_bytes", "device_live_arrays"}
    assert reg.gauge("device_live_bytes").value == out["bytes"]
    assert reg.gauge("device_live_arrays").value == out["arrays"]
    assert set(out) == set(jout)
    assert M.device_memory_stats("cpu") is None
    assert JM.device_memory_stats(jax.devices("cpu")[0]) is None
    assert M.live_array_bytes is M.live_tensor_bytes
    del keep


def test_memory_plan_refuses_without_a_capture_and_reassembles():
    fn = _graph.CapturedFn(lambda: None, torch.device("cpu"))
    fn()
    with pytest.raises(ValueError, match="captured on the card"):
        M.memory_plan(fn)
    # a capture's allocator counts, as _graph._capture records them
    step = _graph.CapturedStep(lambda b: b, 1, torch.device("cpu"))
    step.graph = object()
    step.static_out = torch.zeros(256)           # 1 KiB in the pool
    step.memory = {"allocated_before": 10_000, "reserved_before": 20_000,
                   "reserved_after": 28_192}
    state = torch.nn.Linear(16, 16)              # 1,088 bytes of state
    plan = M.memory_plan(step, donated=(state,))
    assert tuple(plan)[:5] == M.MEMORY_PLAN_FIELDS \
        == jexporters.MEMORY_PLAN_KEYS
    assert plan == {"argument_bytes": 10_000, "output_bytes": 1024 + 1088,
                    "temp_bytes": 8192 - 1024, "alias_bytes": 1088,
                    "generated_code_bytes": 0, "peak_bytes": 10_000 + 8192,
                    "pool_bytes": 8192, "donated_bytes": 1088}
    rec = exporters.JsonlExporter.enrich({
        "kind": "memory", "metric": "toy", "flops": 0.0,
        "transcendentals": 0.0, "matmul_flops": 0.0, "bytes_accessed": 0,
        **plan})
    assert exporters.validate_memory_record(rec) == []


def test_state_bytes_counts_each_storage_once():
    lin = torch.nn.Linear(8, 4)
    shared = lin.weight
    assert M.state_bytes(lin, shared, {"w": shared}, [lin.bias]) == \
        (8 * 4 + 4) * 4
