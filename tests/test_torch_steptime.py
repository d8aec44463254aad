"""The port's step-time attribution against the JAX package's
(``apex_tpu/observability/steptime.py``).

- ``attribute_step`` on 2 gloo ranks (one start for the file, suite
  ``steptime`` of ``tests/torch_dist_worker.py``): a DDP step, its
  ``comm_enabled=False`` compute twin and the isolated all-reduce.  The
  twin issues zero collectives (``torch.distributed.all_reduce`` counted
  on every rank) and returns the local grads divided by the world,
  bitwise; the full step issues one a bucket; the attribution's fields
  reassemble as ``exporters.validate_bench_record`` requires (checked by
  the port's and the JAX package's validators);
  ``capture_timeline=True`` carries the measured timeline of the full
  step (its top-level CPU operators, the all-reduce a collective), the
  measured overlap fraction and the consistency verdict;
- ``timeline_consistency`` and the bucket split equal the JAX package's
  on the same dicts, and the field tuples are the same.
"""

import numpy as np
import pytest

import jax

from apex_tpu.observability import exporters as jexporters
from apex_tpu.observability import steptime as jsteptime
from apex_tpu import nn as jnn

from apex_tpu_torch.observability import exporters, steptime

import torch_dist_worker
import torch_threads  # noqa: F401  (one torch thread a process)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    net = jnn.Sequential([jnn.Flatten(), jnn.Linear(24, 16), jnn.ReLU(),
                          jnn.Linear(16, 10)])
    params, _ = net.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(4)
    inp = {"mlp": jax.tree_util.tree_map(np.asarray, params),
           "x": rs.randn(2, 8, 24).astype(np.float32),
           "y": rs.randint(0, 10, (2, 8)).astype(np.int64)}
    return torch_dist_worker.run("steptime", inp,
                                 tmp_path_factory.mktemp("steptime"))


def _record(att):
    return {"metric": "train_step_attribution_flat", "value":
            att["step_ms"], "unit": "ms", "vs_baseline": None,
            "backend": "cpu", "ndev": 2, "arch": "mlp",
            **{k: att[k] for k in steptime.ATTRIBUTION_FIELDS},
            **{k: att[k] for k in steptime.OVERLAP_SCHEDULE_FIELDS}}


def test_compute_twin_issues_no_collective(ranks):
    for out in ranks:
        assert out["twin_calls"] == 0
        assert out["twin_stats"] == []
        assert out["twin_is_local_mean"] is True
        assert out["full_calls"] == 1           # one fp32 bucket
    np.testing.assert_array_equal(ranks[0]["full"][0], ranks[1]["full"][0])


def test_attribution_fields_reassemble(ranks):
    for out in ranks:
        att = out["att"]
        for k in steptime.ATTRIBUTION_FIELDS:
            assert att[k] >= 0.0, k
        assert att["compute_ms"] + att["comm_ms"] == pytest.approx(
            att["step_ms"], abs=2e-4)
        assert att["ici_ms"] + att["dcn_ms"] == pytest.approx(
            att["comm_isolated_ms"], abs=2e-4)
        assert 0.0 <= att["overlap_fraction"] <= 1.0
        assert att["overlap_mode"] == "reduce_after_backward"
        assert att["n_stages"] == 1 and att["issue_order"] == [0]
        assert [b["topology"] for b in att["buckets"]] == ["flat"]
        rec = exporters.JsonlExporter.enrich(_record(att))
        assert exporters.validate_bench_record(rec) == []
        assert jexporters.validate_bench_record(
            jexporters.JsonlExporter.enrich(_record(att))) == []
        # warm-up and timed calls: (1 + 3) full steps and (1 + 3)
        # isolated reductions, one collective each; the twin none
        assert out["att_calls"] == 8
        tl = out["timeline"]
        assert tl["timeline"]["steps"] == 2
        assert tl["timeline"]["kernel_count"] > 0
        # the step's one all-reduce a call, a c10d operator on gloo
        assert tl["timeline"]["collective_ms"] > 0.0
        assert 0.0 <= tl["measured_overlap_fraction"] <= 1.0
        assert set(tl["consistency"]) == {
            "differenced_comm_fraction", "measured_comm_fraction",
            "abs_diff", "tol", "consistent"}
        assert "iters >= 1" in out["iters_error"]


@pytest.mark.parametrize("att,tl", [
    ({"step_ms": 10.0, "comm_ms": 3.0},
     {"span_ms": 10.0, "collective_ms": 4.0, "overlap_ms": 1.0}),
    ({"step_ms": 0.0, "comm_ms": 0.0}, {"span_ms": 0.0}),
    ({"step_ms": 5.0, "comm_ms": 4.0},
     {"span_ms": 8.0, "collective_ms": 0.5, "overlap_ms": 2.0}),
])
def test_timeline_consistency_equals_jax(att, tl):
    for tol in (0.35, 0.01):
        assert steptime.timeline_consistency(att, tl, tol=tol) == \
            jsteptime.timeline_consistency(att, tl, tol=tol)
    assert steptime.ATTRIBUTION_FIELDS == jsteptime.ATTRIBUTION_FIELDS
    assert steptime.OVERLAP_SCHEDULE_FIELDS == \
        jsteptime.OVERLAP_SCHEDULE_FIELDS


def test_attribute_step_split_equals_jax():
    """The same three timings through each package's decomposition: a
    fixed clock makes the timings equal, so the dicts must be too."""
    plan = [{"topology": "hierarchical", "ici_wire_bytes": 300,
             "dcn_wire_bytes": 100, "comm_dtype": "float32",
             "elements": 10, "cause": "single", "wire_bytes": 400},
            {"topology": "flat", "wire_bytes": 200, "stage": 1,
             "issue_order": 0}]
    outs = []
    for mod in (steptime, jsteptime):
        ticks = iter([0.0, 0.010, 0.0, 0.008, 0.0, 0.004, 0.0, 0.001])
        real = mod.time.perf_counter
        mod.time.perf_counter = lambda: next(ticks)
        try:
            outs.append(mod.attribute_step(
                lambda: None, lambda: None, lambda: None, plan=plan,
                iters=1, warmup=0, ici_step=lambda: None))
        finally:
            mod.time.perf_counter = real
    assert outs[0] == outs[1]
