"""Step-time attribution: where a distributed train step's wall time
goes — compute vs gradient communication, per fabric level.

Counterpart of ``apex_tpu/observability/steptime.py``.  The method is
**blocked-fetch differential timing**, run entirely outside the training
step:

- three separately built callables are timed with a hard device-to-host
  fetch as the completion barrier (a D2H copy cannot complete before the
  work queued ahead of it): the **full step** (compute + collectives),
  its **compute twin** (the identical step with the gradient all-reduce
  elided — ``DistributedDataParallel.comm_enabled = False`` builds it
  from the same step function), and the **isolated comm program** (just
  the all-reduce on grads-shaped buffers);
- nothing is inserted into any step — no callbacks, no timers, no extra
  host reads — so a captured step stays the graph it was.

The decomposition::

    comm_ms    = max(step_ms - compute_ms, 0)      # comm on the critical path
    overlap    = 1 - comm_ms / comm_isolated_ms    # clamped to [0, 1]

``compute_ms + comm_ms == step_ms`` by construction (up to the clamp),
which is the wall-clock consistency ``exporters.validate_bench_record``
pins on attribution records.  Per-level attribution takes the ICI/DCN
(in-node / cross-node) labels from ``parallel.allreduce_comm_plan``: the
measured comm time is split across buckets by wire bytes and within a
bucket by its ``ici_wire_bytes`` / ``dcn_wire_bytes``.  Pass
``ici_step=`` (a callable running only the in-node collectives) to
replace the byte-proportional level split with a measured one.

``attribute_step(..., capture_timeline=True)`` also captures the full
step's device timeline (``observability.timeline.capture``: the card's
kernels under ``torch.profiler``) and carries the measured split, its
``measured_overlap_fraction`` and the :func:`timeline_consistency`
verdict against the differenced one.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["blocked_time", "attribute_step", "timeline_consistency",
           "ATTRIBUTION_FIELDS", "OVERLAP_SCHEDULE_FIELDS"]

# the fields every step-attribution bench record must carry
# (exporters.validate_bench_record keys its checks off
# ``overlap_fraction``)
ATTRIBUTION_FIELDS = ("step_ms", "compute_ms", "comm_ms",
                      "comm_isolated_ms", "overlap_fraction",
                      "ici_ms", "dcn_ms")

# the schedule an attribution record measured (PR 14): which
# bucket-issue schedule the timed step ran — "overlapped" (per-stage
# reductions interleaved with backward) or "reduce_after_backward"
# (the classic baseline) — plus the stage count and stage-level issue
# order.  Duplicated stdlib-side as exporters.OVERLAP_SCHEDULE_FIELDS
# (pinned equal in tests); at schema v9 every fresh
# train_step_attribution_* record carries them, so a dashboard can
# split the overlap trend by schedule instead of guessing from metric
# names.
OVERLAP_SCHEDULE_FIELDS = ("overlap_mode", "n_stages", "issue_order")


def _block(out) -> None:
    """Hard completion barrier: one D2H fetch of an output tensor.  A
    fetch cannot complete before the work queued ahead of it on its
    stream finishes."""
    first = _first_tensor(out)
    if first is not None:
        float(first.detach().sum().to(torch.float32))


def _first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor of a tree of tuples, lists and dicts (other
    leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def blocked_time(fn: Callable, *args, iters: int = 10,
                 warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` timed
    calls after ``warmup`` untimed ones (compile + cache warm), with
    the blocked-fetch barrier before starting and after the last
    call."""
    if iters < 1 or warmup < 0:
        raise ValueError(f"need iters >= 1 and warmup >= 0, got "
                         f"iters={iters}, warmup={warmup}")
    out = None
    for _ in range(warmup):
        out = fn(*args)
    # barrier BEFORE t0 either way: with warmup=0 there is no output
    # to fetch yet, so drain in-flight transfers of the inputs instead
    # — otherwise previously dispatched async work lands inside the
    # timed window
    _block(out if warmup else args)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block(out)
    return (time.perf_counter() - t0) / iters


def _bucket_level_bytes(bucket: Dict[str, Any]):
    """(ici_bytes, dcn_bytes) attribution weights for one comm-plan
    bucket.  Hierarchical buckets split by the plan's per-level wire
    bytes (which sum to the bucket's total); a flat bucket is a single
    fabric, so its whole payload weighs on the ``ici`` column."""
    if bucket.get("topology") == "hierarchical":
        return (float(bucket["ici_wire_bytes"]),
                float(bucket["dcn_wire_bytes"]))
    b = float(bucket.get("wire_bytes", bucket.get("bytes", 0)))
    return b, 0.0


def timeline_consistency(attribution: Dict[str, Any],
                         tl: Dict[str, Any],
                         tol: float = 0.35) -> Dict[str, Any]:
    """Pin the differencing estimate against the measured split.

    Compares the comm share of a step the two ways: differenced —
    critical-path ``comm_ms / step_ms`` (host wall clock) — vs
    measured — the collective time NOT hidden under compute over the
    capture span (``(collective_ms - overlap_ms) / span_ms``, device
    timeline).  ``tol`` is an ABSOLUTE tolerance on the fraction
    difference: both methods see the same schedule, but differencing
    folds dispatch gaps and compiler-schedule drift between the twin
    programs into its estimate, so the stated tolerance is loose by
    design — the check catches the methodology being *wrong* (a twin
    that elides more than the collectives), not timer noise."""
    step_ms = float(attribution.get("step_ms", 0.0) or 0.0)
    diff_frac = (float(attribution.get("comm_ms", 0.0)) / step_ms
                 if step_ms > 0 else 0.0)
    span_ms = float(tl.get("span_ms", 0.0) or 0.0)
    vis = max(float(tl.get("collective_ms", 0.0))
              - float(tl.get("overlap_ms", 0.0)), 0.0)
    meas_frac = (vis / span_ms) if span_ms > 0 else 0.0
    delta = abs(diff_frac - meas_frac)
    return {"differenced_comm_fraction": round(diff_frac, 4),
            "measured_comm_fraction": round(meas_frac, 4),
            "abs_diff": round(delta, 4),
            "tol": float(tol),
            "consistent": bool(delta <= tol)}


def attribute_step(full_step: Callable, compute_step: Callable,
                   comm_step: Callable, args: Sequence[Any] = (),
                   plan: Optional[List[dict]] = None,
                   iters: int = 10, warmup: int = 2,
                   ici_step: Optional[Callable] = None,
                   schedule: Optional[Dict[str, Any]] = None,
                   capture_timeline: bool = False,
                   capture_dir: Optional[str] = None,
                   capture_iters: Optional[int] = None,
                   timeline_modules: Optional[Sequence[str]] = None,
                   consistency_tol: float = 0.35
                   ) -> Dict[str, Any]:
    """Measure and decompose one train step (see module docstring).

    ``full_step`` / ``compute_step`` / ``comm_step`` (and the optional
    ``ici_step``) are called as ``fn(*args)``; each should be its own
    step (a ``make_step`` capture, say) over the SAME shapes.  ``plan`` is the
    ``parallel.allreduce_comm_plan`` of the step's gradient reduction
    (or the ``buckets`` of an ``overlap_comm_schedule``, whose
    ``stage``/``issue_order`` labels ride into the output buckets);
    without one the comm time reports as a single unlabeled bucket on
    the ``ici`` column.

    ``schedule`` is the step's ``parallel.overlap_comm_schedule`` (or
    ``DistributedDataParallel.last_overlap_schedule``): its
    ``OVERLAP_SCHEDULE_FIELDS`` are folded onto the attribution dict
    so the emitted record says WHICH bucket-issue schedule it
    measured.  ``None`` stamps the classic single-stage
    reduce-after-backward shape — every attribution record carries
    the fields either way (schema v9).

    ``capture_timeline=True`` additionally captures ``capture_iters``
    (default ``iters``) full steps under ``torch.profiler`` into
    ``capture_dir`` (``timeline.capture``, restricted to
    ``timeline_modules`` when given) and returns the measured
    attribution as ``timeline``, its ``measured_overlap_fraction``, and
    ``consistency`` (:func:`timeline_consistency` at
    ``consistency_tol``).

    Returns the attribution dict (all times in ms)::

        {step_ms, compute_ms, comm_ms, comm_isolated_ms,
         overlap_fraction, ici_ms, dcn_ms, overlap_mode, n_stages,
         issue_order, buckets: [...], compute_twin_excess_ms?}
    """
    step_ms = blocked_time(full_step, *args, iters=iters,
                           warmup=warmup) * 1e3
    compute_ms = blocked_time(compute_step, *args, iters=iters,
                              warmup=warmup) * 1e3
    comm_isolated_ms = blocked_time(comm_step, *args, iters=iters,
                                    warmup=warmup) * 1e3
    # the decomposition model says compute <= step (the twin is the
    # step minus its collectives); a twin that times SLOWER than the
    # full step — routine on the oversubscribed CPU smoke mesh, where
    # the collectives' rendezvous accidentally staggers the device
    # threads — would otherwise publish a record violating its own
    # compute+comm==step identity.  Clamp to the model and surface the
    # excess as ``compute_twin_excess_ms`` so the record stays
    # schema-consistent while the anomaly stays visible.
    twin_excess = max(compute_ms - step_ms, 0.0)
    compute_ms = min(compute_ms, step_ms)
    comm_ms = max(step_ms - compute_ms, 0.0)
    if comm_isolated_ms > 0.0:
        overlap = 1.0 - comm_ms / comm_isolated_ms
    else:
        overlap = 0.0
    overlap = min(max(overlap, 0.0), 1.0)

    # per-level split of the measured comm time, labeled from the plan
    buckets = list(plan) if plan else [{"topology": "flat",
                                        "wire_bytes": 1}]
    weights = [_bucket_level_bytes(b) for b in buckets]
    total_w = sum(i + d for i, d in weights)
    if total_w <= 0.0:
        # a plan whose buckets carry no recognized byte weight cannot
        # label the split — fall back to the single-fabric default
        # (everything on the first bucket's ici column) so ici+dcn
        # still reassembles comm_isolated_ms and the record passes its
        # own schema
        weights = [(1.0, 0.0)] + [(0.0, 0.0)] * (len(weights) - 1)
        total_w = 1.0
    if ici_step is not None:
        ici_total = min(blocked_time(ici_step, *args, iters=iters,
                                     warmup=warmup) * 1e3,
                        comm_isolated_ms)
        dcn_total = comm_isolated_ms - ici_total
        iw = sum(i for i, _ in weights)
        dw = sum(d for _, d in weights)
        # a level with zero byte weight cannot absorb measured time —
        # fold the residue into the other level instead of dropping it
        # (a single-fabric plan with a measured ici_step residual
        # would otherwise emit ici+dcn < comm_isolated and fail the
        # schema's reassembly check)
        if dw == 0.0:
            ici_total, dcn_total = comm_isolated_ms, 0.0
        elif iw == 0.0:
            ici_total, dcn_total = 0.0, comm_isolated_ms
        # distribute each measured level over buckets by that level's
        # bytes
        split = [(ici_total * i / (iw or 1.0),
                  dcn_total * d / (dw or 1.0)) for i, d in weights]
    else:
        split = [(comm_isolated_ms * i / total_w,
                  comm_isolated_ms * d / total_w) for i, d in weights]

    out_buckets = []
    for b, (ici_ms, dcn_ms) in zip(buckets, split):
        rec = {"ici_ms": round(ici_ms, 4), "dcn_ms": round(dcn_ms, 4)}
        for k in ("comm_dtype", "elements", "topology", "cause",
                  "ici_wire_bytes", "dcn_wire_bytes", "wire_bytes",
                  "stage", "issue_order"):
            if k in b:
                rec[k] = b[k]
        out_buckets.append(rec)

    # which bucket-issue schedule the timed step ran — lazily through
    # parallel (the owner of the schedule shape)
    from ..parallel import distributed as _dist
    out = {"step_ms": round(step_ms, 4),
           "compute_ms": round(compute_ms, 4),
           "comm_ms": round(comm_ms, 4),
           "comm_isolated_ms": round(comm_isolated_ms, 4),
           "overlap_fraction": round(overlap, 4),
           "ici_ms": round(sum(i for i, _ in split), 4),
           "dcn_ms": round(sum(d for _, d in split), 4),
           **_dist.overlap_schedule_fields(schedule),
           "buckets": out_buckets}
    if twin_excess > 0.0:
        out["compute_twin_excess_ms"] = round(twin_excess, 4)

    if capture_timeline:
        from . import timeline as tlmod
        n = capture_iters if capture_iters is not None else iters
        tl = tlmod.capture(full_step, *args, iters=max(n, 1),
                           logdir=capture_dir,
                           modules=timeline_modules)
        out["timeline"] = tl
        out["measured_overlap_fraction"] = \
            tl["measured_overlap_fraction"]
        out["consistency"] = timeline_consistency(
            out, tl, tol=consistency_tol)
    return out
