"""The port's device timeline (``apex_tpu_torch/observability/
timeline.py``) against the JAX package's
(``apex_tpu/observability/timeline.py``).

- The synthetic interval sets of ``tests/test_timeline.py:72-150``,
  written once in XLA's trace format (``hlo_op`` events) and once in
  torch's (CUPTI ``kernel`` rows laned by device and stream), give equal
  ``attribute_timeline`` output through each package's
  ``device_events``; the module filter is the JAX package's
  ``hlo_module`` on one side, a named range (``gpu_user_annotation``) on
  the other.  NCCL kernels classify as collectives, the port's kernels
  as compute.  A card capture with no kernel row raises.
- A real CPU capture (``torch.profiler`` over a few matmuls) parses into
  a valid ``kind: profile`` record from the thread's top-level
  operators, nested calls excluded.
- ``steptime.attribute_step(capture_timeline=True)`` carries the
  timeline, its measured overlap fraction and the ``consistency``
  verdict.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from apex_tpu.observability import timeline as jtimeline
from apex_tpu.observability import exporters as jexporters

from apex_tpu_torch.observability import exporters, steptime, timeline

import torch_threads  # noqa: F401  (one torch thread a process)


def _xla(events):
    noise = [{"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
              "args": {"name": "python"}},
             {"ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 999.0,
              "name": "host frame", "args": {"not_hlo": 1}}]
    return {"traceEvents": noise + [
        {"ph": "X", "pid": 7, "tid": lane, "ts": ts, "dur": dur,
         "name": name, "args": {"hlo_op": name, "hlo_module": module}}
        for name, ts, dur, lane, module in events]}


# XLA's names and the card's for the same work
_CUDA_NAME = {"dot": "void gemm_kernel", "fusion": "void elementwise_kernel",
              "tanh": "void tanh_kernel", "sum": "void reduce_kernel",
              "all-reduce": "ncclDevKernel_AllReduce_Sum_f32_RING_LL"}


def _cuda(events):
    """The same intervals as torch.profiler writes a card capture: the
    host's cpu_op and cuda_runtime rows (noise), each kernel a ``kernel``
    row on its device and stream, the module a ``gpu_user_annotation``
    range over its kernels."""
    rows = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
             "tid": 1, "ts": 0.0, "dur": 999.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": 1.0, "dur": 5.0}]
    spans = {}
    for name, ts, dur, lane, module in events:
        base, _, n = name.partition(".")
        rows.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": lane,
                     "ts": ts, "dur": dur,
                     "name": _CUDA_NAME[base] + (f".{n}" if n else ""),
                     "args": {"device": 0, "stream": lane}})
        lo, hi = spans.get(module, (ts, ts + dur))
        spans[module] = (min(lo, ts), max(hi, ts + dur))
    for module, (lo, hi) in spans.items():
        rows.append({"ph": "X", "cat": "gpu_user_annotation", "name": module,
                     "pid": 0, "tid": 99, "ts": lo, "dur": hi - lo})
    return {"traceEvents": rows, "deviceProperties": [{"id": 0}]}


SYNTHETIC = {
    "full_overlap": [("dot.1", 0.0, 100.0, 2, "jit_step"),
                     ("all-reduce.1", 20.0, 50.0, 3, "jit_step")],
    "no_overlap": [("fusion.1", 0.0, 100.0, 2, "jit_step"),
                   ("all-reduce.1", 100.0, 40.0, 2, "jit_step")],
    "gap_partial": [("dot.1", 0.0, 100.0, 2, "jit_step"),
                    ("all-reduce.2", 200.0, 100.0, 3, "jit_step"),
                    ("fusion.7", 200.0, 50.0, 2, "jit_step")],
    "topk": [("dot.1", 0.0, 10.0, 2, "jit_step"),
             ("dot.2", 10.0, 30.0, 2, "jit_step"),
             ("tanh.1", 40.0, 5.0, 2, "jit_step"),
             ("sum.1", 1000.0, 500.0, 2, "jit__multi_slice")],
}


def _without_names(att):
    return {k: v for k, v in att.items() if k != "top_kernels"}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
@pytest.mark.parametrize("top_k", [1, 10])
def test_synthetic_attribution_equals_jax(case, top_k):
    ev = SYNTHETIC[case]
    want = jtimeline.attribute_timeline(
        jtimeline.device_events(_xla(ev)), top_k=top_k)
    got = timeline.attribute_timeline(
        timeline.device_events(_cuda(ev)), top_k=top_k)
    assert _without_names(got) == _without_names(want)
    assert [(k["kind"], k["count"], k["total_ms"])
            for k in got["top_kernels"]] == \
        [(k["kind"], k["count"], k["total_ms"])
         for k in want["top_kernels"]]
    # the module filter: hlo_module there, a named range here
    wf = jtimeline.attribute_timeline(jtimeline.device_events(
        _xla(ev), modules=("jit_step",)), top_k=top_k)
    gf = timeline.attribute_timeline(timeline.device_events(
        _cuda(ev), modules=("jit_step",)), top_k=top_k)
    assert _without_names(gf) == _without_names(wf)
    # the JAX package's own rows parse the same through the port
    assert timeline.attribute_timeline(timeline.device_events(_xla(ev),
                                                              device="cpu"))


def test_classify_and_fields_equal_jax():
    for name in ("all-reduce.1", "all-gather.3", "reduce-scatter",
                 "collective-permute.2", "all-to-all", "dot.3",
                 "fusion.12", "convolution.1", "copy"):
        assert timeline.classify_kernel(name) == \
            jtimeline.classify_kernel(name), name
    for name in ("ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                 "ncclKernel_AllGather_RING_LL_Sum_int8_t",
                 "c10d::allreduce_", "nccl:all_reduce"):
        assert timeline.classify_kernel(name) == "collective", name
    for name in ("void flash_fwd_mma_kernel<__nv_bfloat16, 64>",
                 "void adam_kernel<__nv_bfloat16>(float*, float*)",
                 "void ln_bwd_vec_kernel<float, 6>", "void scale_kernel",
                 "void bn_fwd_kernel<c10::BFloat16>", "lamb_stage1_kernel",
                 "nvjet_tst_96x128_64x6_2x1_v_bz_NNN"):
        assert timeline.classify_kernel(name) == "compute", name
    assert timeline.PROFILE_FIELDS == jtimeline.PROFILE_FIELDS
    assert exporters.PROFILE_TIME_FIELDS + ("measured_overlap_fraction",) \
        == timeline.PROFILE_FIELDS


def test_card_capture_without_kernels_raises():
    doc = _cuda([])
    with pytest.raises(ValueError, match="no kernel"):
        timeline.device_events(doc)
    with pytest.raises(ValueError, match="no kernel"):
        timeline.device_events({"traceEvents": []}, device="cuda")
    # a CPU capture with no operator is an idle process: an empty record
    assert timeline.device_events({"traceEvents": []}) == []


def test_memcpy_and_memset_rows_count_as_device_time(tmp_path):
    doc = _cuda([("dot.1", 0.0, 10.0, 7, "m")])
    doc["traceEvents"] += [
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "pid": 0,
         "tid": 7, "ts": 10.0, "dur": 5.0, "args": {"device": 0,
                                                    "stream": 7}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0,
         "tid": 8, "ts": 20.0, "dur": 2.0, "args": {"device": 0,
                                                    "stream": 8}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    att = timeline.analyze_capture(str(tmp_path), steps=2)
    assert att["device_busy_ms"] == pytest.approx(0.017 / 2)
    assert att["lane_count"] == 2 and att["kernel_count"] == 3
    assert att["steps"] == 2 and att["trace_path"] == str(path)
    with gzip.open(str(tmp_path / "b.trace.json.gz"), "wt") as f:
        json.dump(doc, f)
    assert timeline.load_trace(str(tmp_path / "b.trace.json.gz")) == doc


def _matmuls(x):
    for _ in range(3):
        x = torch.tanh(x @ x)
    return x


def test_cpu_capture_gives_a_valid_profile_record(tmp_path):
    x = torch.randn(64, 64) / 8
    _matmuls(x)
    att = timeline.capture(_matmuls, x, iters=2, logdir=str(tmp_path))
    assert att["steps"] == 2 and att["kernel_count"] > 0
    assert att["device_busy_ms"] > 0 and att["collective_ms"] == 0.0
    names = {k["name"] for k in att["top_kernels"]}
    # the thread's top-level operators: matmul holds mm, and mm is not
    # counted again beneath it
    assert "aten::matmul" in names and "aten::mm" not in names
    for rec, v in ((exporters.JsonlExporter.enrich(timeline.profile_record(
            att, metric="cpu_matmuls")), exporters),
            (jexporters.JsonlExporter.enrich(jtimeline.profile_record(
                att, metric="cpu_matmuls")), jexporters)):
        assert v.validate_profile_record(rec) == []
        assert v.validate_telemetry_record(rec) == []
    # the profiler hook of /profilez over an idle window: a valid record
    hook = timeline.make_profiler(subject="idle", default_duration_ms=5,
                                  logdir=str(tmp_path))
    rec = hook()
    assert rec["kind"] == "profile" and "trace_path" not in rec
    assert exporters.validate_profile_record(
        exporters.JsonlExporter.enrich(rec)) == []


def test_attribute_step_carries_the_timeline_and_consistency(tmp_path):
    w = torch.randn(32, 32) / 6

    def full():
        return torch.tanh(w @ w).sum()

    def compute():
        return torch.tanh(w @ w).sum()

    def comm():
        return (w * 2).sum()

    att = steptime.attribute_step(full, compute, comm, iters=2, warmup=1,
                                  capture_timeline=True, capture_iters=2,
                                  capture_dir=str(tmp_path))
    tl = att["timeline"]
    assert tl["steps"] == 2 and tl["kernel_count"] > 0
    assert att["measured_overlap_fraction"] == \
        tl["measured_overlap_fraction"] == 0.0
    con = att["consistency"]
    assert set(con) == {"differenced_comm_fraction",
                        "measured_comm_fraction", "abs_diff", "tol",
                        "consistent"}
    assert con["measured_comm_fraction"] == 0.0 and con["tol"] == 0.35
    from apex_tpu.observability import steptime as jsteptime
    assert con == jsteptime.timeline_consistency(att, tl)
