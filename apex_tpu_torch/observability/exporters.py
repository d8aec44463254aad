"""Exporters: schema-versioned JSONL, Prometheus text exposition.

Counterpart of ``apex_tpu/observability/exporters.py``, copied whole (it
is stdlib code over the port's ``.metrics``): the same schema version,
the same record shapes, and every ``validate_*``, so a record either
package emits validates the same way in both.

The JSONL exporter is the machine-readable telemetry trail: every
emitted record carries ``schema_version``, the
capture host, and a first-class boolean ``stale`` field (replacing the
ad-hoc "STALE REPLAY" note strings as the *structured* staleness
signal — the human-readable note stays for people reading artifacts).
``bench.py`` routes every line through it, and
``tests/ci/check_bench_schema.py`` validates the output against
:func:`validate_bench_record`.

Chrome-trace export lives on :class:`tracing.SpanRecorder`; this module
adds the registry-wide surfaces: Prometheus text exposition for
scrape-style consumers and a registry→JSONL dump.
"""

from __future__ import annotations

import json
import numbers
import os
import platform
import re
import socket
import sys
from typing import Any, Dict, IO, Iterable, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["SCHEMA_VERSION", "OVERLAP_MODES", "OVERLAP_SCHEDULE_FIELDS",
           "COMPILE_FIELDS", "TENANT_COUNTS", "CLASS_COUNTS",
           "ADMISSION_MODES",
           "host_info", "JsonlExporter",
           "prometheus_text", "parse_prometheus_text",
           "validate_prometheus_text", "validate_bench_record",
           "validate_bench_jsonl", "validate_lint_record",
           "validate_fleet_record", "validate_trace_record",
           "validate_memory_record", "validate_numerics_record",
           "validate_run_record", "validate_recovery_record",
           "validate_profile_record", "validate_sharding_record",
           "validate_telemetry_record", "validate_telemetry_jsonl"]

# v2: ``kind: fleet`` records REQUIRE ``trace_id`` (the fleet-record
# <-> request-trace join key) and ``kind: trace`` records exist.
# v3: ``kind: memory`` records exist (cost-model/memory-plan dumps);
# fresh ``*_train_throughput`` records must carry the MFU fields
# (``mfu`` / ``achieved_tflops`` / ``flops_per_step`` / ``peak_bytes``)
# and fresh engine-decode records must carry ``kv_cache_bytes``.
# v4: ``kind: numerics`` records exist (gradient-health dumps from
# ``NumericsMonitor.to_record`` / ``bench.py --numerics``) and fresh
# ``numerics_overhead_*`` bench lines must carry ``step_ms_on`` /
# ``step_ms_off`` (an overhead claim is meaningless without both
# sides of the comparison).
# v5: ``kind: run`` records exist (training-run supervisor verdicts
# from ``RunSupervisor.record`` / ``bench.py --run``); fresh
# ``run_supervisor_overhead*`` bench lines must carry ``step_ms_on`` /
# ``step_ms_off`` (same both-sides rule as the v4 numerics overhead);
# ``kind: fleet`` records MAY carry the SLO/goodput fields
# (``goodput_tokens_per_s`` / ``slo_attainment`` /
# ``tokens_within_slo`` / ``deadline_exceeded`` /
# ``deadline_last_sweep``), validated whenever present at any version.
# v6: ``kind: recovery`` records exist (telemetry→action controller
# snapshots from ``fleet.recovery.RecoveryLog.record`` — the elastic
# training controller and the serving SLO-feedback controller — via
# ``bench.py --chaos`` / ``tests/ci/chaos_smoke.py``); fresh
# ``chaos_mttr*`` bench lines must carry ``mttr_s`` and fresh
# ``chaos_spike*`` lines must carry ``slo_attainment`` +
# ``goodput_tokens_per_s`` (a controller-vs-baseline claim is
# meaningless without the SLO side of it); ``kind: fleet`` records MAY
# carry the ``mttr`` aggregate, validated whenever present.
# v7: preemption-safe deterministic resume.  ``kind: recovery``
# records gain ``cause`` (one of RECOVERY_CAUSES — ``preemption`` is
# the planned-SIGTERM exit), ``preempted`` (bool) and ``data_state``
# (the checkpointed sample-stream census:
# samples_consumed/epoch/cursor plus the shard identity), all
# validated whenever present; RECOVERY_ACTION_KINDS grows
# ``preempt_snapshot`` (the coordinated emergency snapshot at the
# step boundary); fresh ``chaos_preempt*`` bench lines must carry
# ``mttr_s`` (preempt request → first committed post-resume step),
# ``resume_overhead_s`` and ``resumed_step`` — a resume-overhead claim
# is meaningless without the resume it measured.
# v8: device-time truth.  ``kind: profile`` records exist (the
# Chrome-trace device-timeline attribution from
# ``observability.timeline``, via ``bench.py --profile`` and the
# ``/profilez`` endpoint): span/busy/compute/collective/gap/overlap
# split in ms plus a MEASURED ``measured_overlap_fraction`` from
# actual kernel-interval overlap — the timeline-backed counterpart of
# steptime's differenced estimate, internally cross-checked by
# ``validate_profile_record``.  Fresh engine-decode bench lines must
# now carry the KV fragmentation pair ``kv_waste_bytes`` +
# ``kv_utilization`` next to v3's ``kv_cache_bytes`` (allocated bytes
# without the wasted bytes is exactly the blind spot ROADMAP item 1's
# paged allocator must drive down); both fields are validated whenever
# present at any version.
# v9: overlapped gradient communication.  Step-time attribution
# records (``train_step_attribution_*`` from ``bench.py --comm``) must
# say WHICH bucket-issue schedule they measured: ``overlap_mode``
# (one of OVERLAP_MODES — ``overlapped`` interleaves per-stage bucket
# reductions with the backward, ``reduce_after_backward`` is the
# classic baseline), ``n_stages`` and the stage-level ``issue_order``
# permutation (OVERLAP_SCHEDULE_FIELDS, duplicated from
# ``observability.steptime`` and pinned equal in tests) — a
# comm-hidden claim is meaningless without the schedule that hid it.
# The fields are validated whenever present at any version; fresh
# v9 attribution lines must carry them.
# v10: the compilation plane.  Fresh train-throughput and engine-decode
# lines must say what their warmup COMPILED — ``cold_compile_ms``
# (trace+lower+compile wall time, separated from every timed rate: the
# gotcha class of compile seconds folded into a trended
# number), ``compiles_total`` (tracing dispatches during warmup — a
# cold fleet measuring N replica re-jits shows N here, not a mystery
# slowdown) and ``steady_state_retraces`` (compilation-ledger trace
# DELTA across the timed loop, which must be 0: a steady-state retrace
# means the measured rate included a recompile).  All three validated
# whenever present (COMPILE_FIELDS, duplicated from
# observability.compilation.BENCH_COMPILE_FIELDS and pinned equal in
# tests); required on fresh v10 lines; ``supervisor`` anomaly kinds
# grow ``recompilation_storm``.
# v11: the tenant plane.  ``kind: fleet`` records carry the per-tenant
# SLO rollup — a ``tenants`` object keyed by tenant name whose buckets
# hold the TENANT_COUNTS tallies plus ``slo_attainment`` /
# ``goodput_tokens_per_s`` (same nullability/range contract as the
# fleet-level pair), and ``tenants_dropped`` (tenant ids folded into
# the overflow bucket by the label-cardinality cap).  Validated
# whenever present; REQUIRED on fresh v11 fleet records — a fleet
# snapshot that cannot say whose requests it served cannot answer
# "which tenant's p99 regressed".  Untagged requests stay out of the
# map, so per-tenant sums are <= the fleet totals, never ==.  Bench
# grows the two-tenant open-loop leg: fresh ``*_tenant_*_goodput``
# lines must carry ``tenant`` + ``slo_attainment``, and the
# ``*_tenant_parity`` line must carry the token counts its ratio came
# from (``tenants_goodput_tokens`` / ``tokens_within_slo``) and
# reassemble from them.
# v12: the paged serving plane.  Fresh engine-decode lines must say
# HOW their engine admits and holds KV: ``admission_mode`` (one of
# ADMISSION_MODES — ``fixed_slot`` reserves a whole buf_len row per
# request, ``paged`` reserves fixed-size blocks off a shared pool and
# admits at iteration boundaries), so trend tooling never compares a
# paged line against a fixed-slot baseline unknowingly.  Lines from a
# paged engine must additionally carry the pool geometry —
# ``block_size``, ``blocks_total``, ``blocks_free`` (ints,
# blocks_free <= blocks_total) — next to the v8 fragmentation pair
# those fields explain: a falling ``kv_waste_bytes`` claim is
# meaningless without the block size that produced it.  All four are
# validated whenever present at any version; required on fresh v12
# engine-decode lines.
# v13: the sharding plane.  ``kind: sharding`` records exist (the
# static replication ledger from ``analysis.sharding``, via
# ``python -m apex_tpu.analysis --sharding`` and ``bench.py
# --graph-lint``): per entry point, the shard_map world and mesh axes,
# the body-operand byte census split into ``unique_bytes`` +
# ``replicated_bytes`` (world-total duplicate bytes the ZeRO-2/3
# stages of ROADMAP item 2 exist to delete — on the ZeRO-1 DDP train
# EPs this names the fully-replicated fp32 master/optimizer state),
# the per-dtype replicated split, the top replicated arrays with their
# inferred specs, and the resharding-eqn census.  The arithmetic
# identity ``unique_bytes + replicated_bytes == world *
# argument_bytes`` is enforced — a ledger that does not reassemble
# from its own parts is hand-built, not propagated.  Deterministic
# like the compiled memory plan, so ``check_bench_trend`` gates
# ``replicated_bytes`` per entry point on every backend.
# v14: the QoS plane.  ``kind: fleet`` records carry the per-class
# rollup — a ``classes`` object keyed by priority-class name whose
# buckets hold the CLASS_COUNTS tallies (TENANT_COUNTS plus
# ``preempted``: requests evicted mid-decode to admit a higher class)
# alongside ``slo_attainment`` / ``goodput_tokens_per_s`` (fleet-level
# contract) and the live queue shape (``queue_depth`` / ``queue_cap``
# / ``weight`` / ``preemptible``), and a fleet-level ``preemptions``
# total.  Validated whenever present; REQUIRED on fresh v14 fleet
# records — a fleet snapshot that cannot split its SLO story by
# priority class cannot answer "did the batch flood eat the
# interactive tier".  RECOVERY_ACTION_KINDS grows
# ``class_admission_tighten`` / ``class_admission_relax`` (the
# per-class admission knob — the controller squeezes the
# lowest-priority class's queue quota, never rank 0's).  Bench grows
# the QoS leg: fresh per-class ``*_class_*_goodput`` lines must carry
# ``qos_class`` + ``slo_attainment``, and the ``*_preemption_parity``
# line (token-for-token equality of a preempted-then-readmitted
# request vs an undisturbed run) must carry the token counts its
# ratio came from (``matched_tokens`` / ``expected_tokens``), at
# least one measured ``preemptions``, and reassemble from them —
# check_bench_trend gates the parity at exactly 1.0 on EVERY backend
# (determinism, not timing).
# v15: the ZeRO weight-update sharding plane.  Fresh ZeRO bench lines
# (``*zero*_train_throughput`` from the ``ddp_resnet18_o2_zero{1,2,3}``
# / ``ddp_mlp_overlap_zero2`` legs) must carry ``zero_stage`` in
# {1, 2, 3} — a sharded-update throughput number compared against the
# wrong stage's baseline is the exact confusion the replication ledger
# exists to prevent — and ``kind: sharding`` ledger records for zero
# entry points carry the same tag so ``check_bench_trend`` can gate
# ``replicated_bytes`` per (entry_point, backend) on every backend
# with the stage visible in the gated record (the stage-3 ledger
# collapse — masters ARE the params, nothing replicated but BN state
# and scalars — is a per-stage claim, not a per-EP one).  Validated
# whenever present at any version; required on fresh v15 records.
# Validators gate each version's requirements on the record's DECLARED
# version, so archived v1..v14 streams stay valid.
SCHEMA_VERSION = 15

# how a serving engine admits requests and holds KV (stdlib-side
# duplicate of the serving engines' ``admission_mode`` class attrs —
# this module must stay importable without jax; tests pin them in sync)
ADMISSION_MODES = ("fixed_slot", "paged")

# the compile-plane bench fields (stdlib-side duplicate of
# observability.compilation.BENCH_COMPILE_FIELDS — this module must
# stay importable without jax; tests pin the tuples equal)
COMPILE_FIELDS = ("cold_compile_ms", "compiles_total",
                  "steady_state_retraces")

# which bucket-issue schedule an attribution record measured — the
# stdlib-side duplicate of parallel.distributed.OVERLAP_MODES /
# observability.steptime.OVERLAP_SCHEDULE_FIELDS (this module must
# stay importable without jax; tests pin the tuples equal)
OVERLAP_MODES = ("overlapped", "reduce_after_backward")
OVERLAP_SCHEDULE_FIELDS = ("overlap_mode", "n_stages", "issue_order")

_host_info_cache: Optional[Dict[str, Any]] = None


def host_info() -> Dict[str, Any]:
    """Capture-host provenance stamped onto every exported record."""
    global _host_info_cache
    if _host_info_cache is None:
        _host_info_cache = {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "platform": sys.platform,
            "python": platform.python_version(),
        }
    return dict(_host_info_cache)


class JsonlExporter:
    """Write records as schema-versioned JSON lines.

    ``enrich`` fills only *missing* fields: a replayed record that
    already carries ``stale: true`` / the capture host of the original
    measurement keeps that provenance instead of being restamped.
    """

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None):
        if (path is None) == (stream is None):
            raise ValueError("exactly one of path/stream required")
        self._stream = stream
        self._path = path
        self._file: Optional[IO[str]] = None

    @staticmethod
    def enrich(record: Dict[str, Any], stale: bool = False
               ) -> Dict[str, Any]:
        out = dict(record)
        out.setdefault("schema_version", SCHEMA_VERSION)
        out.setdefault("host", host_info())
        out.setdefault("stale", bool(stale))
        out["stale"] = bool(out["stale"])
        return out

    def _out(self) -> IO[str]:
        if self._stream is not None:
            return self._stream
        if self._file is None:
            self._file = open(self._path, "a")
        return self._file

    def emit(self, record: Dict[str, Any], stale: bool = False
             ) -> Dict[str, Any]:
        line = self.enrich(record, stale=stale)
        out = self._out()
        out.write(json.dumps(line) + "\n")
        out.flush()
        return line

    def emit_registry(self, registry: MetricsRegistry,
                      **extra) -> List[Dict[str, Any]]:
        """One record per metric (histograms as their summary)."""
        lines = []
        for m in registry.collect():
            rec = {"metric": m.name, "kind": m.kind, **extra}
            if isinstance(m, Histogram):
                rec.update(m.summary())
            else:
                rec["value"] = m.value
            lines.append(self.emit(rec))
        return lines

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- Prometheus text exposition ------------------------------------------

def _escape_label_value(v) -> str:
    """Exposition-format label-value escaping: backslash, double quote
    and newline must be escaped or a label like ``layer="conv\\1"`` /
    a path with a quote corrupts every line after it."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _unescape_label_value(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt,
                                                             c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _escape_help(h: str) -> str:
    """HELP text escaping (backslash + newline; quotes are legal
    there)."""
    return h.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(label_set) -> str:
    if not label_set:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in label_set) + "}"


def _edge_str(e: float) -> str:
    return repr(e) if e != int(e) else str(int(e))


def _expose_one(lines: List[str], m, label_set=()):
    if isinstance(m, Histogram):
        acc = 0
        with m._lock:
            counts, total, n = list(m._counts), m._sum, m._count
        for e, c in zip(m.edges, counts):
            acc += c
            ls = tuple(label_set) + (("le", _edge_str(e)),)
            lines.append(f"{m.name}_bucket{_fmt_labels(ls)} {acc}")
        ls = tuple(label_set) + (("le", "+Inf"),)
        lines.append(f"{m.name}_bucket{_fmt_labels(ls)} {acc + counts[-1]}")
        lines.append(f"{m.name}_sum{_fmt_labels(label_set)} {total}")
        lines.append(f"{m.name}_count{_fmt_labels(label_set)} {n}")
    else:
        lines.append(f"{m.name}{_fmt_labels(label_set)} {m.value}")


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Registry contents in the Prometheus text exposition format
    (labeled children exported under the parent name)."""
    from .metrics import get_registry
    reg = registry or get_registry()
    lines: List[str] = []
    for m in reg.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        children = m.children()
        # a parent that only ever fans out to labeled children (bare
        # value untouched) contributes no unlabeled sample
        untouched = (m.count == 0 if isinstance(m, Histogram)
                     else m.value == 0)
        if not (children and untouched):
            _expose_one(lines, m)
        for key, child in sorted(children.items()):
            _expose_one(lines, child, key)
    return "\n".join(lines) + "\n"


# a sample line: name, optional {labels}, value.  Label values are
# double-quoted with \\ \" \n escapes (the regex accepts any escaped
# char and _unescape_label_value resolves it).
_PROM_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r'\s+(\S+)\s*$')
_PROM_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# suffixes a histogram family's samples may carry
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse one text exposition into
    ``{family: {type, help, samples: [(name, labels, value)]}}`` with
    label values UNESCAPED — the round-trip half of the conformance
    test.  Raises ``ValueError`` on a malformed line (the validator
    wrapper reports instead)."""
    families: Dict[str, Dict[str, Any]] = {}

    def fam(name):
        return families.setdefault(
            name, {"type": None, "help": None, "samples": []})

    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):].split(" ", 1)
            fam(rest[0])["help"] = (rest[1] if len(rest) > 1 else "")
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):].split(" ", 1)
            if len(rest) != 2:
                raise ValueError(f"line {i}: malformed TYPE: {raw!r}")
            fam(rest[0])["type"] = rest[1]
            continue
        if line.startswith("#"):
            continue                     # plain comment
        m = _PROM_SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: not a valid sample: {raw!r}")
        name, labels_raw, value_raw = m.groups()
        try:
            value = float(value_raw.replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(f"line {i}: non-numeric value "
                             f"{value_raw!r}") from None
        labels = {k: _unescape_label_value(v)
                  for k, v in _PROM_LABEL_RE.findall(labels_raw or "")}
        base = name
        for sfx in _HIST_SUFFIXES:
            if name.endswith(sfx) and name[:-len(sfx)] in families:
                base = name[:-len(sfx)]
                break
        fam(base)["samples"].append((name, labels, value))
    return families


def validate_prometheus_text(text: str) -> List[str]:
    """Exposition-format conformance check (the `/metricsz` contract,
    shared by the pytest round-trip and tests/ci/server_smoke.py):
    every line parses; every sample belongs to a ``# TYPE``-declared
    family; counters never go negative; histogram families expose a
    ``+Inf`` bucket per label set, cumulative bucket counts that are
    monotone over ascending ``le`` edges, and ``_count`` equal to the
    ``+Inf`` bucket; label values survive the escape round-trip (the
    parser has already unescaped them — a raw quote/newline would have
    failed the parse)."""
    errs: List[str] = []
    try:
        families = parse_prometheus_text(text)
    except ValueError as e:
        return [str(e)]
    for name, f in sorted(families.items()):
        if f["type"] is None:
            errs.append(f"{name}: samples with no # TYPE line")
            continue
        if f["type"] not in ("counter", "gauge", "histogram",
                             "summary", "untyped"):
            errs.append(f"{name}: unknown type {f['type']!r}")
        if f["type"] == "counter":
            for sname, labels, value in f["samples"]:
                if value < 0:
                    errs.append(f"{name}: counter sample {sname} "
                                f"{labels} is negative ({value})")
        if f["type"] != "histogram":
            for sname, labels, _ in f["samples"]:
                if sname != name:
                    errs.append(f"{name}: unexpected sample name "
                                f"{sname!r} for a {f['type']}")
            continue
        # histogram: group buckets by their non-le label set
        series: Dict[tuple, Dict[str, Any]] = {}
        for sname, labels, value in f["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if sname == name + "_bucket":
                if "le" not in labels:
                    errs.append(f"{name}: bucket sample missing le "
                                f"label ({labels})")
                    continue
                le = labels["le"]
                edge = float("inf") if le == "+Inf" else float(le)
                s["buckets"].append((edge, value))
            elif sname == name + "_sum":
                s["sum"] = value
            elif sname == name + "_count":
                s["count"] = value
            else:
                errs.append(f"{name}: unexpected histogram sample "
                            f"{sname!r}")
        for key, s in sorted(series.items()):
            lbl = dict(key)
            buckets = sorted(s["buckets"])
            if not buckets or buckets[-1][0] != float("inf"):
                errs.append(f"{name}{lbl}: histogram has no +Inf "
                            f"bucket")
                continue
            prev = None
            for edge, c in buckets:
                if prev is not None and c < prev:
                    errs.append(f"{name}{lbl}: cumulative bucket "
                                f"counts decrease at le={edge}")
                prev = c
            if s["count"] is None or s["sum"] is None:
                errs.append(f"{name}{lbl}: histogram missing _sum or "
                            f"_count")
            elif s["count"] != buckets[-1][1]:
                errs.append(f"{name}{lbl}: _count ({s['count']}) != "
                            f"+Inf bucket ({buckets[-1][1]})")
    return errs


# -- bench record schema --------------------------------------------------

def _need(rec, errs, key, types, allow_none=False):
    """Shared required-key type check (bool is not an int here)."""
    if key not in rec:
        errs.append(f"missing required key {key!r}")
        return None
    v = rec[key]
    if v is None and allow_none:
        return v
    if not isinstance(v, types) or isinstance(v, bool) != (types is bool):
        errs.append(f"{key!r} must be {types}, got {type(v).__name__}")
    return v


def _check_kv_fields(rec, errs):
    """The KV fragmentation field contract, shared by bench and
    profile records (one implementation so the two schemas cannot
    drift): byte fields are non-negative ints, waste is a subset of
    the allocation, utilization is a fraction — all validated
    whenever present."""
    for opt in ("kv_cache_bytes", "kv_waste_bytes"):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0, got {v!r}")
    kvw, kvc = rec.get("kv_waste_bytes"), rec.get("kv_cache_bytes")
    if (isinstance(kvw, int) and isinstance(kvc, int)
            and not isinstance(kvw, bool) and not isinstance(kvc, bool)
            and kvw > kvc):
        errs.append(f"kv_waste_bytes ({kvw}) exceeds kv_cache_bytes "
                    f"({kvc}) — waste is a subset of the allocation")
    if "kv_utilization" in rec:
        v = rec["kv_utilization"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (0.0 <= v <= 1.0)):
            errs.append(f"'kv_utilization' must be in [0, 1], got "
                        f"{v!r}")


def _check_block_pool_fields(rec, errs):
    """The paged-KV field contract (schema v12), validated whenever
    present at any version: ``admission_mode`` names a known mode;
    ``block_size`` is a positive int; ``blocks_total`` /
    ``blocks_free`` are non-negative ints with free <= total (free
    blocks beyond the pool would mean the allocator double-freed)."""
    if "admission_mode" in rec:
        am = rec["admission_mode"]
        if am not in ADMISSION_MODES:
            errs.append(f"'admission_mode' must be one of "
                        f"{ADMISSION_MODES}, got {am!r}")
    if "block_size" in rec:
        v = rec["block_size"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errs.append(f"'block_size' must be an int >= 1, got {v!r}")
    for key in ("blocks_total", "blocks_free"):
        if key in rec:
            v = rec[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{key!r} must be an int >= 0, got {v!r}")
    bf, bt = rec.get("blocks_free"), rec.get("blocks_total")
    if (isinstance(bf, int) and isinstance(bt, int)
            and not isinstance(bf, bool) and not isinstance(bt, bool)
            and bf > bt):
        errs.append(f"blocks_free ({bf}) exceeds blocks_total ({bt}) "
                    f"— free blocks are a subset of the pool")


def _check_compile_fields(rec, errs):
    """The compilation-plane field contract (schema v10), validated
    whenever present: ``cold_compile_ms`` is a non-negative number,
    ``compiles_total`` / ``steady_state_retraces`` non-negative ints.
    (Whether a nonzero steady-state retrace count GATES is the trend
    checker's job — schema-wise the record is honest about it.)"""
    if "cold_compile_ms" in rec:
        v = rec["cold_compile_ms"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (v >= 0)):
            errs.append(f"'cold_compile_ms' must be a number >= 0, "
                        f"got {v!r}")
    for key in ("compiles_total", "steady_state_retraces"):
        if key in rec:
            v = rec[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{key!r} must be an int >= 0, got {v!r}")


def _check_envelope(rec, errs):
    """The common record envelope every exported line carries
    (schema_version / capture host / first-class ``stale``) — one
    implementation for bench and lint records."""
    sv = _need(rec, errs, "schema_version", int)
    if isinstance(sv, int) and not isinstance(sv, bool) and sv < 1:
        errs.append(f"schema_version must be >= 1, got {sv}")
    _need(rec, errs, "stale", bool)
    host = _need(rec, errs, "host", dict)
    if isinstance(host, dict):
        if not isinstance(host.get("hostname"), str):
            errs.append("host.hostname must be a string")
        if not isinstance(host.get("pid"), int):
            errs.append("host.pid must be an int")


def validate_bench_record(rec: Any) -> List[str]:
    """Schema check for one bench JSONL record; returns a list of
    problems (empty = valid).  Shared by the pytest coverage and the
    tests/ci/check_bench_schema.py gate."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types, allow_none=False):
        return _need(rec, errs, key, types, allow_none)

    _check_envelope(rec, errs)
    metric = need("metric", str)
    if isinstance(metric, str) and not metric:
        errs.append("metric must be non-empty")
    need("value", numbers.Number, allow_none=True)
    need("unit", str, allow_none=True)
    need("backend", str)
    need("ndev", int)
    need("arch", str)
    for opt in ("note", "error", "recorded_at", "stale_recorded_at"):
        if opt in rec and not isinstance(rec[opt], str):
            errs.append(f"{opt!r} must be a string when present")
    if "vs_baseline" in rec and rec["vs_baseline"] is not None \
            and not isinstance(rec["vs_baseline"], numbers.Number):
        errs.append("'vs_baseline' must be a number or null")
    # serving decode-window fields: ``window`` is the in-graph
    # decode ticks per host sync — tokens/sec lines are only comparable
    # given it, so fresh engine-decode measurements must carry it.
    # Stale replays of pre-window records and error lines are exempt.
    if "window" in rec:
        w = rec["window"]
        if not isinstance(w, int) or isinstance(w, bool) or w < 1:
            errs.append(f"'window' must be an int >= 1, got {w!r}")
    if "tokens_per_sync" in rec and not isinstance(
            rec["tokens_per_sync"], numbers.Number):
        errs.append("'tokens_per_sync' must be a number when present")
    sv_rec = rec.get("schema_version")
    v3 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 3)
    v8 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 8)
    v10 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
           and sv_rec >= 10)
    v12 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
           and sv_rec >= 12)
    if (isinstance(metric, str) and "engine_decode" in metric
            and "error" not in rec and not rec.get("stale")):
        if "window" not in rec:
            errs.append("engine decode records must carry 'window' "
                        "(decode ticks per host sync)")
        unit = rec.get("unit")
        if isinstance(unit, str) and "tokens/sec" not in unit:
            errs.append(f"engine decode records must report a "
                        f"tokens/sec unit, got {unit!r}")
        if v3 and "kv_cache_bytes" not in rec:
            errs.append("fresh engine decode records must carry "
                        "'kv_cache_bytes' (schema v3)")
        # v8: allocated bytes without the wasted bytes is exactly the
        # fragmentation blind spot — fresh decode lines carry the pair
        if v8:
            for key in ("kv_waste_bytes", "kv_utilization"):
                if key not in rec:
                    errs.append(f"fresh engine decode records must "
                                f"carry {key!r} (schema v8)")
        # v10: a decode rate is only a steady-state claim if it says
        # what warmup compiled and that the timed loop re-traced
        # nothing — the compile-plane triple
        if v10:
            for key in COMPILE_FIELDS:
                if key not in rec:
                    errs.append(f"fresh engine decode records must "
                                f"carry {key!r} (schema v10)")
        # v12: the paged serving plane — a decode line must say HOW
        # its engine admits and holds KV (a paged line compared
        # against a fixed-slot baseline unknowingly is the trend
        # checker's blind spot), and a paged line must carry the pool
        # geometry its fragmentation numbers are denominated in
        if v12:
            if "admission_mode" not in rec:
                errs.append("fresh engine decode records must carry "
                            "'admission_mode' (schema v12)")
            elif rec.get("admission_mode") == "paged":
                for key in ("block_size", "blocks_total",
                            "blocks_free"):
                    if key not in rec:
                        errs.append(f"fresh paged engine decode "
                                    f"records must carry {key!r} "
                                    f"(schema v12)")
    # MFU / peak-memory fields: a fresh train-step throughput
    # line is only a roofline statement given the model FLOPs behind
    # it — v3 records must say what they computed (flops_per_step,
    # per device), how fast (achieved_tflops, mfu vs the costmodel
    # peak table — null where the table has no entry for the
    # hardware) and at what memory high-water mark (peak_bytes from
    # the compiled plan).  Stale replays of older rounds and error
    # lines stay exempt, as does anything declaring schema_version < 3.
    if (v3 and isinstance(metric, str)
            and metric.endswith("_train_throughput")
            and "error" not in rec and not rec.get("stale")):
        for key in ("flops_per_step", "achieved_tflops"):
            v = _need(rec, errs, key, numbers.Number)
            if (isinstance(v, numbers.Number) and not isinstance(v, bool)
                    and v < 0):
                errs.append(f"{key!r} must be >= 0, got {v}")
        mv = _need(rec, errs, "mfu", numbers.Number, allow_none=True)
        if (isinstance(mv, numbers.Number) and not isinstance(mv, bool)
                and mv < 0):
            errs.append(f"'mfu' must be >= 0 or null, got {mv}")
        pb = _need(rec, errs, "peak_bytes", int)
        if isinstance(pb, int) and not isinstance(pb, bool) and pb < 0:
            errs.append(f"'peak_bytes' must be >= 0, got {pb}")
    # v10: fresh train-throughput lines carry the compile-plane triple
    # next to the v3 cost-model fields — a timed rate that cannot say
    # its compile time was separated out is the gotcha class bench
    # exists to prevent (cold compiles folded into trended numbers)
    if (v10 and isinstance(metric, str)
            and metric.endswith("_train_throughput")
            and "error" not in rec and not rec.get("stale")):
        for key in COMPILE_FIELDS:
            if key not in rec:
                errs.append(f"fresh train-throughput records must "
                            f"carry {key!r} (schema v10)")
    _check_kv_fields(rec, errs)
    _check_compile_fields(rec, errs)
    _check_block_pool_fields(rec, errs)
    if "mfu" in rec and rec["mfu"] is not None and (
            not isinstance(rec["mfu"], numbers.Number)
            or isinstance(rec["mfu"], bool)):
        errs.append("'mfu' must be a number or null")
    # gradient-allreduce comm microbench fields (bench.py --comm): a
    # record carrying ``comm_topology`` describes one topology variant
    # of the two-level ICI/DCN reduction and must state the per-level
    # wire bytes — the flat-vs-hierarchical comparison is meaningless
    # without them — plus the compression flag and the level widths.
    if "comm_topology" in rec:
        ct = rec["comm_topology"]
        if ct not in ("flat", "hierarchical"):
            errs.append(f"'comm_topology' must be 'flat' or "
                        f"'hierarchical', got {ct!r}")
        _need(rec, errs, "compress", bool)
        for key in ("ici_size", "dcn_size"):
            v = _need(rec, errs, key, int)
            if isinstance(v, int) and not isinstance(v, bool) and v < 1:
                errs.append(f"{key!r} must be >= 1, got {v}")
        for key in ("wire_bytes", "ici_wire_bytes", "dcn_wire_bytes"):
            v = _need(rec, errs, key, int)
            if isinstance(v, int) and not isinstance(v, bool) and v < 0:
                errs.append(f"{key!r} must be >= 0, got {v}")
    if (isinstance(metric, str) and metric.startswith("grad_allreduce_")
            and "error" not in rec and not rec.get("stale")
            and "comm_topology" not in rec):
        errs.append("grad_allreduce records must carry 'comm_topology' "
                    "(and the per-level wire-byte fields)")
    # numerics-instrumentation overhead fields (bench.py --numerics,
    # schema v4): an overhead line is the on-vs-off step-time
    # comparison — both sides must be on the record, non-negative,
    # and arithmetically consistent with the headline value.
    for opt in ("step_ms_on", "step_ms_off", "overhead_fraction"):
        if opt in rec:
            v = rec[opt]
            if (not isinstance(v, numbers.Number)
                    or isinstance(v, bool) or v < 0):
                errs.append(f"{opt!r} must be a number >= 0 when "
                            f"present, got {v!r}")
    v4 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 4)
    v5 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 5)
    # the v5 supervisor-overhead lines (bench.py --run) follow the
    # same both-sides contract as the v4 numerics overhead: an
    # overhead claim must carry the on and off step times it came from
    if (isinstance(metric, str)
            and ((v4 and metric.startswith("numerics_overhead"))
                 or (v5 and metric.startswith("run_supervisor_overhead")))
            and "error" not in rec and not rec.get("stale")):
        on = _need(rec, errs, "step_ms_on", numbers.Number)
        off = _need(rec, errs, "step_ms_off", numbers.Number)
        val = rec.get("value")
        ok_num = all(isinstance(v, numbers.Number)
                     and not isinstance(v, bool)
                     for v in (on, off, val))
        if ok_num:
            # the headline must reassemble from its own sides (bench
            # clamps negative overhead to 0 and rounds to 4 decimals
            # — 0.01 ms absorbs the rounding, nothing else)
            expect = max(on - off, 0.0)
            if abs(val - expect) > max(0.01, 0.01 * expect):
                errs.append(
                    f"value ({val}) inconsistent with "
                    f"step_ms_on - step_ms_off ({on} - {off})")
            frac = rec.get("overhead_fraction")
            if (isinstance(frac, numbers.Number)
                    and not isinstance(frac, bool) and off > 0
                    and abs(frac - expect / off)
                    > max(0.01, 0.01 * frac)):
                errs.append(
                    f"overhead_fraction ({frac}) inconsistent with "
                    f"value/step_ms_off ({expect:.4g}/{off})")
        if "opt_level" in rec and not isinstance(rec["opt_level"], str):
            errs.append("'opt_level' must be a string when present")
    # chaos lines (bench.py --chaos, schema v6): the MTTR line must
    # carry the measurement it claims, and the spike lines must carry
    # the SLO side of the controller-vs-baseline comparison
    v6 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 6)
    if (v6 and isinstance(metric, str)
            and "error" not in rec and not rec.get("stale")):
        if metric.startswith("chaos_mttr"):
            v = _need(rec, errs, "mttr_s", numbers.Number)
            if (isinstance(v, numbers.Number)
                    and not isinstance(v, bool) and not (v >= 0)):
                errs.append(f"'mttr_s' must be >= 0, got {v!r}")
        if metric.startswith("chaos_spike"):
            att = _need(rec, errs, "slo_attainment", numbers.Number,
                        allow_none=True)
            if (isinstance(att, numbers.Number)
                    and not isinstance(att, bool)
                    and not (0.0 <= att <= 1.0)):
                errs.append(f"'slo_attainment' must be null or in "
                            f"[0, 1], got {att!r}")
            gp = _need(rec, errs, "goodput_tokens_per_s",
                       numbers.Number)
            if (isinstance(gp, numbers.Number)
                    and not isinstance(gp, bool) and not (gp >= 0)):
                errs.append(f"'goodput_tokens_per_s' must be >= 0, "
                            f"got {gp!r}")
    # preemption resume lines (bench.py --chaos, schema v7): the
    # trend-gated resume-overhead claim must carry the resume it
    # measured — the MTTR window (preempt request → first committed
    # post-resume step), the restore overhead, and where it resumed
    v7 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 7)
    if (v7 and isinstance(metric, str)
            and metric.startswith("chaos_preempt")
            and "error" not in rec and not rec.get("stale")):
        for key in ("mttr_s", "resume_overhead_s"):
            v = _need(rec, errs, key, numbers.Number)
            if (isinstance(v, numbers.Number)
                    and not isinstance(v, bool) and not (v >= 0)):
                errs.append(f"{key!r} must be >= 0, got {v!r}")
        rs = _need(rec, errs, "resumed_step", int)
        if isinstance(rs, int) and not isinstance(rs, bool) and rs < 0:
            errs.append(f"'resumed_step' must be >= 0, got {rs}")
    # step-time attribution fields (bench.py --comm): a record
    # carrying ``overlap_fraction`` decomposes a train step into
    # compute vs comm time per fabric level and must be internally
    # consistent — compute + critical-path comm reassemble the
    # wall-clock step, the per-level times reassemble the isolated
    # comm measurement, and the overlap fraction is a fraction.
    if "overlap_fraction" in rec:
        for key in ("step_ms", "compute_ms", "comm_ms",
                    "comm_isolated_ms", "ici_ms", "dcn_ms",
                    "overlap_fraction"):
            v = _need(rec, errs, key, numbers.Number)
            if (isinstance(v, numbers.Number) and not isinstance(v, bool)
                    and v < 0):
                errs.append(f"{key!r} must be >= 0, got {v}")
        vals = {k: rec.get(k) for k in ("step_ms", "compute_ms",
                                        "comm_ms", "comm_isolated_ms",
                                        "ici_ms", "dcn_ms",
                                        "overlap_fraction")}
        if all(isinstance(v, numbers.Number) and not isinstance(v, bool)
               for v in vals.values()):
            if vals["overlap_fraction"] > 1.0:
                errs.append(f"overlap_fraction must be in [0, 1], got "
                            f"{vals['overlap_fraction']}")
            # comm_ms is the CLAMPED step-compute difference, so the
            # only legitimate residue is measurement noise when the
            # compute twin times slower than the full step
            resid = abs(vals["compute_ms"] + vals["comm_ms"]
                        - vals["step_ms"])
            if resid > max(0.25 * vals["step_ms"], 0.25):
                errs.append(
                    f"compute_ms + comm_ms ({vals['compute_ms']} + "
                    f"{vals['comm_ms']}) inconsistent with step_ms "
                    f"({vals['step_ms']})")
            lvl = abs(vals["ici_ms"] + vals["dcn_ms"]
                      - vals["comm_isolated_ms"])
            if lvl > max(0.02 * vals["comm_isolated_ms"], 0.01):
                errs.append(
                    f"ici_ms + dcn_ms ({vals['ici_ms']} + "
                    f"{vals['dcn_ms']}) must reassemble "
                    f"comm_isolated_ms ({vals['comm_isolated_ms']})")
    # overlap schedule fields (schema v9): a record saying WHICH
    # bucket-issue schedule it measured must say it coherently — a
    # known mode, a positive stage count, and a stage-level issue order
    # that is a permutation of the stages.  Validated whenever present;
    # REQUIRED on fresh v9 train_step_attribution_* lines (a
    # comm-hidden claim without its schedule is not comparable).
    if "overlap_mode" in rec:
        om = rec["overlap_mode"]
        if om not in OVERLAP_MODES:
            errs.append(f"'overlap_mode' must be one of "
                        f"{OVERLAP_MODES}, got {om!r}")
        # a mode claim needs its schedule shape alongside it
        _need(rec, errs, "n_stages", int)
        _need(rec, errs, "issue_order", list)
    # the shape fields are coherence-checked WHENEVER present — a
    # record carrying n_stages=0 or a non-permutation issue_order is
    # incoherent whether or not it also names its mode
    ns = rec.get("n_stages")
    ns_ok = isinstance(ns, int) and not isinstance(ns, bool)
    if "n_stages" in rec:
        if not ns_ok:
            errs.append(f"'n_stages' must be an int, got {ns!r}")
        elif ns < 1:
            errs.append(f"'n_stages' must be >= 1, got {ns}")
    if "issue_order" in rec:
        io = rec["issue_order"]
        if not isinstance(io, list) or not all(
                isinstance(s, int) and not isinstance(s, bool)
                for s in io):
            errs.append("'issue_order' must be a list of ints")
        elif ns_ok and ns >= 1 and sorted(io) != list(range(ns)):
            errs.append(
                f"'issue_order' must be a permutation of the "
                f"{ns} stage ids, got {io}")
    v9 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
          and sv_rec >= 9)
    if (v9 and isinstance(metric, str)
            and metric.startswith("train_step_attribution")
            and "error" not in rec and not rec.get("stale")):
        for key in OVERLAP_SCHEDULE_FIELDS:
            if key not in rec:
                errs.append(f"fresh step-attribution records must "
                            f"carry {key!r} (schema v9: which "
                            f"bucket-issue schedule was measured)")
    # tenant-tagged bench lines (bench.py --fleet two-tenant leg,
    # schema v11): whenever a line names a tenant it must name it
    # coherently, and the fresh v11 per-tenant goodput/parity lines
    # must carry the SLO side of the claim — a per-tenant throughput
    # without attainment cannot say whether that tenant's deadlines
    # held, and a parity ratio without its token counts cannot be
    # re-derived.
    if "tenant" in rec and (not isinstance(rec["tenant"], str)
                            or not rec["tenant"]):
        errs.append(f"'tenant' must be a non-empty string when "
                    f"present, got {rec['tenant']!r}")
    v11 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
           and sv_rec >= 11)
    if (v11 and isinstance(metric, str)
            and "error" not in rec and not rec.get("stale")):
        if "_tenant_" in metric and metric.endswith("_goodput"):
            if "tenant" not in rec:
                errs.append("fresh per-tenant goodput records must "
                            "carry 'tenant' (schema v11)")
            att = _need(rec, errs, "slo_attainment", numbers.Number,
                        allow_none=True)
            if (isinstance(att, numbers.Number)
                    and not isinstance(att, bool)
                    and not (0.0 <= att <= 1.0)):
                errs.append(f"'slo_attainment' must be null or in "
                            f"[0, 1], got {att!r}")
        if metric.endswith("_tenant_parity"):
            counts = {}
            for key in ("tenants_goodput_tokens", "tokens_within_slo"):
                v = _need(rec, errs, key, int)
                if isinstance(v, int) and not isinstance(v, bool):
                    if v < 0:
                        errs.append(f"{key!r} must be >= 0, got {v}")
                    else:
                        counts[key] = v
            val = rec.get("value")
            if (len(counts) == 2 and counts["tokens_within_slo"] > 0
                    and isinstance(val, numbers.Number)
                    and not isinstance(val, bool)):
                expect = (counts["tenants_goodput_tokens"]
                          / counts["tokens_within_slo"])
                if abs(val - expect) > 0.005:
                    errs.append(
                        f"value ({val}) inconsistent with "
                        f"tenants_goodput_tokens/tokens_within_slo "
                        f"({expect:.4g})")
    # QoS-tagged bench lines (bench.py --fleet QoS leg, schema v14):
    # whenever a line names a priority class it must name it
    # coherently; fresh v14 per-class goodput lines must carry the SLO
    # side of the claim, and the preemption-parity line must carry the
    # token counts its ratio came from plus the preemption count it
    # survived — an exactness claim that preempted nothing measured
    # nothing.
    if "qos_class" in rec and (not isinstance(rec["qos_class"], str)
                               or not rec["qos_class"]):
        errs.append(f"'qos_class' must be a non-empty string when "
                    f"present, got {rec['qos_class']!r}")
    v14 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
           and sv_rec >= 14)
    if (v14 and isinstance(metric, str)
            and "error" not in rec and not rec.get("stale")):
        if "_class_" in metric and metric.endswith("_goodput"):
            if "qos_class" not in rec:
                errs.append("fresh per-class goodput records must "
                            "carry 'qos_class' (schema v14)")
            att = _need(rec, errs, "slo_attainment", numbers.Number,
                        allow_none=True)
            if (isinstance(att, numbers.Number)
                    and not isinstance(att, bool)
                    and not (0.0 <= att <= 1.0)):
                errs.append(f"'slo_attainment' must be null or in "
                            f"[0, 1], got {att!r}")
        if metric.endswith("_preemption_parity"):
            counts = {}
            for key in ("matched_tokens", "expected_tokens"):
                v = _need(rec, errs, key, int)
                if isinstance(v, int) and not isinstance(v, bool):
                    if v < 0:
                        errs.append(f"{key!r} must be >= 0, got {v}")
                    else:
                        counts[key] = v
            pre = _need(rec, errs, "preemptions", int)
            if (isinstance(pre, int) and not isinstance(pre, bool)
                    and pre < 1):
                errs.append(f"'preemptions' must be >= 1 on a "
                            f"preemption-parity line, got {pre}")
            val = rec.get("value")
            if (len(counts) == 2 and counts["expected_tokens"] > 0
                    and isinstance(val, numbers.Number)
                    and not isinstance(val, bool)):
                expect = (counts["matched_tokens"]
                          / counts["expected_tokens"])
                if abs(val - expect) > 0.005:
                    errs.append(
                        f"value ({val}) inconsistent with "
                        f"matched_tokens/expected_tokens "
                        f"({expect:.4g})")
    # ZeRO-tagged bench lines (bench.py --comm zero legs, schema v15):
    # whenever a line names a ZeRO stage it must be a real one; fresh
    # v15 zero train-throughput lines must say WHICH stage produced the
    # number — trending a stage-3 rate against a stage-1 baseline
    # unknowingly is the blind spot the tag closes.
    if "zero_stage" in rec:
        zs = rec["zero_stage"]
        if not isinstance(zs, int) or isinstance(zs, bool) \
                or zs not in (1, 2, 3):
            errs.append(f"'zero_stage' must be 1, 2 or 3 when present, "
                        f"got {zs!r}")
    v15 = (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
           and sv_rec >= 15)
    if (v15 and isinstance(metric, str) and "zero" in metric
            and metric.endswith("_train_throughput")
            and "error" not in rec and not rec.get("stale")
            and "zero_stage" not in rec):
        errs.append("fresh ZeRO train-throughput records must carry "
                    "'zero_stage' (schema v15)")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


def validate_bench_jsonl(lines: Iterable[str]) -> List[str]:
    """Validate a bench stdout stream: every non-empty line must parse
    as JSON and pass the record schema."""
    return _validate_jsonl(lines, validate_bench_record)


# -- graph-lint record schema ---------------------------------------------

_LINT_SEVERITIES = ("error", "warning", "info")


def validate_lint_record(rec: Any) -> List[str]:
    """Schema check for one graph-lint JSONL record (what
    ``python -m apex_tpu.analysis`` and tests/ci/graph_lint.py emit):
    the common envelope (schema_version / host / stale) plus either a
    finding (``kind: graph_lint``) or the run summary
    (``kind: graph_lint_summary``)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types):
        return _need(rec, errs, key, types)

    _check_envelope(rec, errs)
    kind = rec.get("kind")
    if kind == "graph_lint":
        for key in ("rule", "entry_point", "message"):
            v = need(key, str)
            if isinstance(v, str) and not v:
                errs.append(f"{key!r} must be non-empty")
        sev = need("severity", str)
        if isinstance(sev, str) and sev not in _LINT_SEVERITIES:
            errs.append(f"severity must be one of {_LINT_SEVERITIES}, "
                        f"got {sev!r}")
        if "detail" in rec and not isinstance(rec["detail"], dict):
            errs.append("'detail' must be an object when present")
    elif kind == "graph_lint_summary":
        for key in ("entry_points", "rules", "findings", "errors",
                    "warnings"):
            v = need(key, int)
            if isinstance(v, int) and not isinstance(v, bool) and v < 0:
                errs.append(f"{key!r} must be >= 0, got {v}")
        f, e, w = (rec.get("findings"), rec.get("errors"),
                   rec.get("warnings"))
        if all(isinstance(v, int) for v in (f, e, w)) and f != e + w:
            errs.append(f"findings ({f}) != errors ({e}) + warnings ({w})")
    else:
        errs.append(f"unknown lint kind {kind!r}")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- fleet record schema ---------------------------------------------------

# monotonic fleet totals every ``kind: fleet`` record must carry —
# Fleet.record() emits exactly these (plus replicas/policy/state tallies)
_FLEET_COUNTS = ("queue_depth", "submitted", "finished", "failed",
                 "shed", "retries", "failovers", "drains", "tokens")

# the per-tenant bucket tallies a v11 ``tenants`` block carries —
# the stdlib-side duplicate of fleet.slo's tenant bucket (this module
# must stay importable without jax; tests pin the shapes equal).
# Every field is a non-negative int; ``slo_attainment`` /
# ``goodput_tokens_per_s`` ride alongside with the fleet-level
# contract (null-or-fraction / non-negative number).
TENANT_COUNTS = ("submitted", "finished", "failed", "shed",
                 "deadline_exceeded", "slo_misses", "goodput_tokens",
                 "with_deadline", "within_deadline")

# the per-class bucket tallies a v14 ``classes`` block carries — the
# tenant bucket plus ``preempted`` (requests evicted mid-decode to
# admit a higher-priority class; the evictee is re-queued from its
# prompt, so ``preempted`` is not a failure count).  Stdlib-side
# duplicate of fleet.slo's class bucket; tests pin the shapes equal.
CLASS_COUNTS = TENANT_COUNTS + ("preempted",)


def _check_tenants_block(rec, errs):
    """The v11 per-tenant rollup contract, validated whenever present:
    ``tenants`` maps non-empty tenant names to buckets of TENANT_COUNTS
    tallies (ints >= 0, internally consistent — finishes cannot exceed
    submissions, within-deadline is a subset of with-deadline), and the
    per-tenant sums stay within the fleet totals (untagged requests are
    counted fleet-wide but deliberately kept OUT of the tenant map, so
    the sums are <=, never ==)."""
    if "tenants_dropped" in rec:
        v = rec["tenants_dropped"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"'tenants_dropped' must be an int >= 0, "
                        f"got {v!r}")
    if "tenants" not in rec:
        return
    tenants = rec["tenants"]
    if not isinstance(tenants, dict):
        errs.append("'tenants' must be an object when present")
        return
    sums = {k: 0 for k in ("shed", "deadline_exceeded",
                           "goodput_tokens")}
    for name, b in tenants.items():
        if not isinstance(name, str) or not name:
            errs.append(f"tenant names must be non-empty strings, "
                        f"got {name!r}")
        if not isinstance(b, dict):
            errs.append(f"tenants[{name!r}] must be an object")
            continue
        for key in TENANT_COUNTS:
            v = b.get(key)
            if key not in b:
                errs.append(f"tenants[{name!r}] missing {key!r}")
            elif not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"tenants[{name!r}].{key} must be an int "
                            f">= 0, got {v!r}")
            elif key in sums:
                sums[key] += v
        fin, sub = b.get("finished"), b.get("submitted")
        if (isinstance(fin, int) and isinstance(sub, int)
                and not isinstance(fin, bool)
                and not isinstance(sub, bool) and fin > sub):
            errs.append(f"tenants[{name!r}]: finished ({fin}) exceeds "
                        f"submitted ({sub})")
        wi, wd = b.get("within_deadline"), b.get("with_deadline")
        if (isinstance(wi, int) and isinstance(wd, int)
                and not isinstance(wi, bool)
                and not isinstance(wd, bool) and wi > wd):
            errs.append(f"tenants[{name!r}]: within_deadline ({wi}) "
                        f"exceeds with_deadline ({wd})")
        att = b.get("slo_attainment")
        if att is not None and (
                not isinstance(att, numbers.Number)
                or isinstance(att, bool)
                or not (0.0 <= att <= 1.0)):
            errs.append(f"tenants[{name!r}].slo_attainment must be "
                        f"null or in [0, 1], got {att!r}")
        gp = b.get("goodput_tokens_per_s")
        if gp is not None and (
                not isinstance(gp, numbers.Number)
                or isinstance(gp, bool) or not (gp >= 0)):
            errs.append(f"tenants[{name!r}].goodput_tokens_per_s must "
                        f"be null or a number >= 0, got {gp!r}")
    # untagged traffic keeps the tenant sums strictly within the fleet
    # totals; a sum EXCEEDING its total is double-counting
    for key, total_key in (("shed", "shed"),
                           ("deadline_exceeded", "deadline_exceeded"),
                           ("goodput_tokens", "tokens_within_slo")):
        total = rec.get(total_key)
        if (isinstance(total, int) and not isinstance(total, bool)
                and sums[key] > total):
            errs.append(f"sum of per-tenant {key} ({sums[key]}) "
                        f"exceeds fleet {total_key} ({total})")


def _check_classes_block(rec, errs):
    """The v14 per-class rollup contract, validated whenever present:
    ``classes`` maps non-empty priority-class names to buckets of
    CLASS_COUNTS tallies (ints >= 0, internally consistent the tenant
    way), each riding with the SLO pair (null-or-fraction attainment,
    non-negative goodput rate) and the live queue shape (depth/cap
    ints, weight >= 1, preemptible bool) — and the per-class sums stay
    within the fleet totals (every admitted request resolves to
    exactly one class, so under a multi-class policy the sums may
    reach the totals but never exceed them).  ``preemptions`` is the
    fleet-level eviction total the per-class ``preempted`` tallies
    roll up into."""
    if "preemptions" in rec:
        v = rec["preemptions"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"'preemptions' must be an int >= 0, "
                        f"got {v!r}")
    if "classes" not in rec:
        return
    classes = rec["classes"]
    if not isinstance(classes, dict):
        errs.append("'classes' must be an object when present")
        return
    sums = {k: 0 for k in ("shed", "deadline_exceeded",
                           "goodput_tokens")}
    preempted_sum = 0
    for name, b in classes.items():
        if not isinstance(name, str) or not name:
            errs.append(f"class names must be non-empty strings, "
                        f"got {name!r}")
        if not isinstance(b, dict):
            errs.append(f"classes[{name!r}] must be an object")
            continue
        for key in CLASS_COUNTS:
            v = b.get(key)
            if key not in b:
                errs.append(f"classes[{name!r}] missing {key!r}")
            elif not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"classes[{name!r}].{key} must be an int "
                            f">= 0, got {v!r}")
            elif key in sums:
                sums[key] += v
            elif key == "preempted":
                preempted_sum += v
        fin, sub = b.get("finished"), b.get("submitted")
        if (isinstance(fin, int) and isinstance(sub, int)
                and not isinstance(fin, bool)
                and not isinstance(sub, bool) and fin > sub):
            errs.append(f"classes[{name!r}]: finished ({fin}) exceeds "
                        f"submitted ({sub})")
        wi, wd = b.get("within_deadline"), b.get("with_deadline")
        if (isinstance(wi, int) and isinstance(wd, int)
                and not isinstance(wi, bool)
                and not isinstance(wd, bool) and wi > wd):
            errs.append(f"classes[{name!r}]: within_deadline ({wi}) "
                        f"exceeds with_deadline ({wd})")
        att = b.get("slo_attainment")
        if att is not None and (
                not isinstance(att, numbers.Number)
                or isinstance(att, bool)
                or not (0.0 <= att <= 1.0)):
            errs.append(f"classes[{name!r}].slo_attainment must be "
                        f"null or in [0, 1], got {att!r}")
        gp = b.get("goodput_tokens_per_s")
        if gp is not None and (
                not isinstance(gp, numbers.Number)
                or isinstance(gp, bool) or not (gp >= 0)):
            errs.append(f"classes[{name!r}].goodput_tokens_per_s must "
                        f"be null or a number >= 0, got {gp!r}")
        for key in ("queue_depth", "queue_cap"):
            if key in b:
                v = b[key]
                if (not isinstance(v, int) or isinstance(v, bool)
                        or v < 0):
                    errs.append(f"classes[{name!r}].{key} must be an "
                                f"int >= 0 when present, got {v!r}")
        if "weight" in b:
            w = b["weight"]
            if not isinstance(w, int) or isinstance(w, bool) or w < 1:
                errs.append(f"classes[{name!r}].weight must be an int "
                            f">= 1 when present, got {w!r}")
        if "preemptible" in b and not isinstance(b["preemptible"],
                                                 bool):
            errs.append(f"classes[{name!r}].preemptible must be a "
                        f"bool when present, got "
                        f"{b['preemptible']!r}")
    for key, total_key in (("shed", "shed"),
                           ("deadline_exceeded", "deadline_exceeded"),
                           ("goodput_tokens", "tokens_within_slo")):
        total = rec.get(total_key)
        if (isinstance(total, int) and not isinstance(total, bool)
                and sums[key] > total):
            errs.append(f"sum of per-class {key} ({sums[key]}) "
                        f"exceeds fleet {total_key} ({total})")
    pre = rec.get("preemptions")
    if (isinstance(pre, int) and not isinstance(pre, bool)
            and preempted_sum > pre):
        errs.append(f"sum of per-class preempted ({preempted_sum}) "
                    f"exceeds fleet preemptions ({pre})")


def validate_fleet_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: fleet`` JSONL record
    (``Fleet.record()`` enriched by the exporter): the common envelope
    plus the replica/state tallies and the fleet counters
    (shed/retries/failovers/drains & co), with the cross-field sanity
    checks a dashboard would otherwise discover at 3am — state tallies
    cannot exceed the replica count, finishes cannot exceed
    submissions."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types):
        return _need(rec, errs, key, types)

    _check_envelope(rec, errs)
    if rec.get("kind") != "fleet":
        errs.append(f"kind must be 'fleet', got {rec.get('kind')!r}")
    # the flight-recorder cross-reference: every fleet snapshot names
    # the fleet-run trace whose request traces (``kind: trace``,
    # trace_id "<fleet>/r<rid>") it aggregates — a dashboard can join
    # the two streams on this id.  Schema v2 requirement: archived v1
    # fleet records (pre-flight-recorder) predate the field and stay
    # valid at their declared version.
    sv = rec.get("schema_version", SCHEMA_VERSION)
    if isinstance(sv, int) and not isinstance(sv, bool) and sv >= 2:
        # (a non-int schema_version is already an envelope error — no
        # crash, no v2 requirements)
        tid = need("trace_id", str)
        if isinstance(tid, str) and not tid:
            errs.append("trace_id must be non-empty")
    pol = need("policy", str)
    if isinstance(pol, str) and not pol:
        errs.append("policy must be non-empty")
    n = need("replicas", int)
    if isinstance(n, int) and not isinstance(n, bool) and n < 1:
        errs.append(f"replicas must be >= 1, got {n}")
    tally = 0
    for key in ("healthy", "degraded", "dead"):
        v = need(key, int)
        if isinstance(v, int) and not isinstance(v, bool):
            if v < 0:
                errs.append(f"{key!r} must be >= 0, got {v}")
            tally += v
    if isinstance(n, int) and not isinstance(n, bool) and tally > n:
        errs.append(f"healthy+degraded+dead ({tally}) exceeds "
                    f"replicas ({n})")
    for key in _FLEET_COUNTS:
        v = need(key, int)
        if isinstance(v, int) and not isinstance(v, bool) and v < 0:
            errs.append(f"{key!r} must be >= 0, got {v}")
    fin, sub = rec.get("finished"), rec.get("submitted")
    if (isinstance(fin, int) and isinstance(sub, int)
            and not isinstance(fin, bool) and not isinstance(sub, bool)
            and fin > sub):
        errs.append(f"finished ({fin}) exceeds submitted ({sub})")
    # SLO / goodput / deadline-sweep fields (schema v5 additions,
    # OPTIONAL at every version — older records simply predate them,
    # but whenever present they must be internally consistent: goodput
    # cannot exceed total tokens, attainment is a fraction or null,
    # and the deadline-sweep aggregate mirrors what the flight ring's
    # ``deadline_exceeded`` events carry)
    for opt in ("deadline_exceeded", "tokens_within_slo"):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0 when "
                            f"present, got {v!r}")
    tw, tok = rec.get("tokens_within_slo"), rec.get("tokens")
    if (isinstance(tw, int) and isinstance(tok, int)
            and not isinstance(tw, bool) and not isinstance(tok, bool)
            and tw > tok):
        errs.append(f"tokens_within_slo ({tw}) exceeds tokens ({tok})")
    if "goodput_tokens_per_s" in rec:
        v = rec["goodput_tokens_per_s"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (v >= 0)):
            errs.append(f"'goodput_tokens_per_s' must be a number "
                        f">= 0 when present, got {v!r}")
    if "slo_attainment" in rec and rec["slo_attainment"] is not None:
        v = rec["slo_attainment"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (0.0 <= v <= 1.0)):
            errs.append(f"'slo_attainment' must be null or in [0, 1], "
                        f"got {v!r}")
    if "mttr" in rec:
        # schema-v6 optional: the fleet's failover→first-progress
        # aggregate ({last, mean, count}), same nullability contract
        # as the recovery record's mttr_s
        mttr = rec["mttr"]
        if not isinstance(mttr, dict):
            errs.append("'mttr' must be an object when present")
        else:
            c = mttr.get("count")
            if not isinstance(c, int) or isinstance(c, bool) or c < 0:
                errs.append(f"mttr.count must be an int >= 0, got "
                            f"{c!r}")
            for k in ("last", "mean"):
                v = mttr.get(k)
                if v is None:
                    continue
                if (not isinstance(v, numbers.Number)
                        or isinstance(v, bool) or v != v
                        or not (v >= 0)):
                    errs.append(f"mttr.{k} must be null or a finite "
                                f"number >= 0, got {v!r}")
    # the v11 tenant plane: validated whenever present, required on
    # records declaring v11 — Fleet.record() always emits the block
    # (empty object when no request was tagged), so a fresh record
    # missing it was hand-built
    if isinstance(sv, int) and not isinstance(sv, bool) and sv >= 11:
        if "tenants" not in rec:
            errs.append("fresh fleet records must carry 'tenants' "
                        "(schema v11: the per-tenant SLO rollup)")
        if "tenants_dropped" not in rec:
            errs.append("fresh fleet records must carry "
                        "'tenants_dropped' (schema v11)")
    _check_tenants_block(rec, errs)
    # the v14 QoS plane: validated whenever present, required on
    # records declaring v14 — Fleet.record() always emits the block
    # (zero buckets for every policy class when nothing ran), so a
    # fresh record missing it was hand-built
    if isinstance(sv, int) and not isinstance(sv, bool) and sv >= 14:
        if "classes" not in rec:
            errs.append("fresh fleet records must carry 'classes' "
                        "(schema v14: the per-QoS-class SLO rollup)")
        if "preemptions" not in rec:
            errs.append("fresh fleet records must carry "
                        "'preemptions' (schema v14)")
    _check_classes_block(rec, errs)
    if "deadline_last_sweep" in rec:
        sweep = rec["deadline_last_sweep"]
        if not isinstance(sweep, dict):
            errs.append("'deadline_last_sweep' must be an object when "
                        "present")
        else:
            c = sweep.get("count")
            if not isinstance(c, int) or isinstance(c, bool) or c < 0:
                errs.append(f"deadline_last_sweep.count must be an "
                            f"int >= 0, got {c!r}")
            rids = sweep.get("rids")
            if not isinstance(rids, list) or any(
                    not isinstance(r, int) or isinstance(r, bool)
                    for r in rids):
                errs.append("deadline_last_sweep.rids must be a list "
                            "of ints")
            elif isinstance(c, int) and not isinstance(c, bool) \
                    and len(rids) > c:
                errs.append(f"deadline_last_sweep lists {len(rids)} "
                            f"rids for a count of {c}")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- memory record schema ---------------------------------------------------

# Compiled.memory_analysis() components every ``kind: memory`` record
# must carry; ``peak_bytes`` must reassemble from them exactly.
# Public: observability.memory builds its plans from THIS tuple, so
# the producer and the validator cannot drift.  (This module stays
# import-light — memory.py imports from here, never the reverse, so
# tests/ci/check_bench_schema.py's jax-free loader keeps working.)
MEMORY_PLAN_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
                    "alias_bytes", "generated_code_bytes")
_MEMORY_PLAN_KEYS = MEMORY_PLAN_KEYS


def validate_memory_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: memory`` JSONL record (the
    cost-model/memory-plan dump emitted per analysis entry point by
    ``python -m apex_tpu.analysis --memory`` and per bench config by
    ``bench.py``): the common envelope, a subject (``entry_point`` or
    ``metric``), non-negative analytic FLOP/byte totals, the compiled
    memory-plan components, and the arithmetic cross-check — a
    ``peak_bytes`` that does not reassemble from its own components is
    a hand-built record, not a plan."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types):
        return _need(rec, errs, key, types)

    _check_envelope(rec, errs)
    if rec.get("kind") != "memory":
        errs.append(f"kind must be 'memory', got {rec.get('kind')!r}")
    subject = rec.get("entry_point", rec.get("metric"))
    if not isinstance(subject, str) or not subject:
        errs.append("memory records must carry a non-empty "
                    "'entry_point' or 'metric'")
    for key in ("flops", "transcendentals", "matmul_flops"):
        v = need(key, numbers.Number)
        if (isinstance(v, numbers.Number) and not isinstance(v, bool)
                and v < 0):
            errs.append(f"{key!r} must be >= 0, got {v}")
    parts = {}
    for key in _MEMORY_PLAN_KEYS + ("peak_bytes", "bytes_accessed"):
        v = need(key, int)
        if isinstance(v, int) and not isinstance(v, bool):
            if v < 0:
                errs.append(f"{key!r} must be >= 0, got {v}")
            parts[key] = v
    if len(parts) == len(_MEMORY_PLAN_KEYS) + 2:
        expect = (parts["argument_bytes"] + parts["output_bytes"]
                  + parts["temp_bytes"] + parts["generated_code_bytes"]
                  - parts["alias_bytes"])
        if parts["peak_bytes"] != expect:
            errs.append(
                f"peak_bytes ({parts['peak_bytes']}) != argument + "
                f"output + temp + generated_code - alias ({expect})")
    for opt in ("analytic_live_bytes", "analytic_temp_bytes",
                "kv_cache_bytes"):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0 when "
                            f"present, got {v!r}")
    for opt in ("matmul_flops_by_dtype", "bytes_by_dtype",
                "analytic_temp_bytes_by_dtype"):
        if opt in rec and not isinstance(rec[opt], dict):
            errs.append(f"{opt!r} must be an object when present")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- sharding record schema -------------------------------------------------

def validate_sharding_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: sharding`` JSONL record (the static
    replication ledger from ``analysis.sharding.
    entry_point_sharding_record``, schema v13): the common envelope, a
    non-empty ``entry_point``, a coherent mesh (``world`` equals the
    product of ``mesh_axes``), non-negative byte totals with the
    arithmetic identity ``unique_bytes + replicated_bytes == world *
    argument_bytes`` (the ledger must reassemble from its own parts),
    a per-dtype split that sums to ``replicated_bytes``, a
    ``replicated_fraction`` consistent with the totals, well-formed
    ``top_replicated`` entries, and a resharding census of
    non-negative eqn counts."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types):
        return _need(rec, errs, key, types)

    _check_envelope(rec, errs)
    if rec.get("kind") != "sharding":
        errs.append(f"kind must be 'sharding', got {rec.get('kind')!r}")
    epn = need("entry_point", str)
    if isinstance(epn, str) and not epn:
        errs.append("entry_point must be non-empty")
    src = need("source", str)
    if isinstance(src, str) and not src:
        errs.append("source must be non-empty")
    world = need("world", int)
    if isinstance(world, int) and not isinstance(world, bool) \
            and world < 1:
        errs.append(f"world must be >= 1, got {world}")
    axes = need("mesh_axes", dict)
    if isinstance(axes, dict):
        prod = 1
        ok = bool(axes)
        for name, sz in axes.items():
            if not isinstance(name, str) or not name:
                errs.append(f"mesh axis names must be non-empty "
                            f"strings, got {name!r}")
                ok = False
            if not isinstance(sz, int) or isinstance(sz, bool) or sz < 1:
                errs.append(f"mesh_axes[{name!r}] must be an int >= 1, "
                            f"got {sz!r}")
                ok = False
            else:
                prod *= sz
        if not axes:
            errs.append("mesh_axes must be non-empty")
        if (ok and isinstance(world, int) and not isinstance(world, bool)
                and prod != world):
            errs.append(f"world ({world}) != product of mesh_axes "
                        f"({prod})")
    sm = need("shard_maps", int)
    if isinstance(sm, int) and not isinstance(sm, bool) and sm < 1:
        errs.append(f"shard_maps must be >= 1, got {sm}")
    parts = {}
    for key in ("argument_bytes", "unique_bytes", "replicated_bytes"):
        v = need(key, int)
        if isinstance(v, int) and not isinstance(v, bool):
            if v < 0:
                errs.append(f"{key!r} must be >= 0, got {v}")
            else:
                parts[key] = v
    if (len(parts) == 3 and isinstance(world, int)
            and not isinstance(world, bool) and world >= 1
            and parts["unique_bytes"] + parts["replicated_bytes"]
            != world * parts["argument_bytes"]):
        errs.append(
            f"unique_bytes + replicated_bytes "
            f"({parts['unique_bytes']} + {parts['replicated_bytes']}) "
            f"!= world * argument_bytes "
            f"({world} * {parts['argument_bytes']}) — the ledger must "
            f"reassemble from its own parts")
    by_dtype = need("replicated_bytes_by_dtype", dict)
    if isinstance(by_dtype, dict):
        total = 0
        ok = True
        for dt, v in by_dtype.items():
            if not isinstance(dt, str) or not dt:
                errs.append(f"replicated_bytes_by_dtype keys must be "
                            f"non-empty strings, got {dt!r}")
                ok = False
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"replicated_bytes_by_dtype[{dt!r}] must "
                            f"be an int >= 0, got {v!r}")
                ok = False
            else:
                total += v
        if ok and "replicated_bytes" in parts \
                and total != parts["replicated_bytes"]:
            errs.append(f"replicated_bytes_by_dtype sums to {total}, "
                        f"!= replicated_bytes "
                        f"({parts['replicated_bytes']})")
    frac = need("replicated_fraction", numbers.Number)
    if (isinstance(frac, numbers.Number) and not isinstance(frac, bool)
            and not (0.0 <= frac <= 1.0)):
        errs.append(f"replicated_fraction must be in [0, 1], got "
                    f"{frac!r}")
    if (isinstance(frac, numbers.Number) and not isinstance(frac, bool)
            and len(parts) == 3 and isinstance(world, int)
            and not isinstance(world, bool) and world >= 1
            and parts["argument_bytes"] > 0):
        expect = (parts["replicated_bytes"]
                  / (world * parts["argument_bytes"]))
        if abs(frac - expect) > 1e-9:
            errs.append(f"replicated_fraction ({frac}) inconsistent "
                        f"with replicated_bytes / (world * "
                        f"argument_bytes) ({expect:.6g})")
    top = need("top_replicated", list)
    if isinstance(top, list):
        for i, t in enumerate(top):
            if not isinstance(t, dict):
                errs.append(f"top_replicated[{i}] is not an object")
                continue
            idx = t.get("index")
            if not isinstance(idx, int) or isinstance(idx, bool) \
                    or idx < 0:
                errs.append(f"top_replicated[{i}].index must be an "
                            f"int >= 0, got {idx!r}")
            if not isinstance(t.get("shape"), list):
                errs.append(f"top_replicated[{i}].shape must be a list")
            if not isinstance(t.get("dtype"), str) or not t.get("dtype"):
                errs.append(f"top_replicated[{i}].dtype must be a "
                            f"non-empty string")
            lb = t.get("local_bytes")
            if not isinstance(lb, int) or isinstance(lb, bool) or lb < 0:
                errs.append(f"top_replicated[{i}].local_bytes must be "
                            f"an int >= 0, got {lb!r}")
            rf = t.get("replication_factor")
            if (not isinstance(rf, numbers.Number)
                    or isinstance(rf, bool) or not (rf >= 1)):
                errs.append(f"top_replicated[{i}].replication_factor "
                            f"must be a number >= 1, got {rf!r}")
            if not isinstance(t.get("spec"), str) or not t.get("spec"):
                errs.append(f"top_replicated[{i}].spec must be a "
                            f"non-empty string")
    census = need("resharding_eqns", dict)
    if isinstance(census, dict):
        for prim, n in census.items():
            if not isinstance(prim, str) or not prim:
                errs.append(f"resharding_eqns keys must be non-empty "
                            f"strings, got {prim!r}")
            if not isinstance(n, int) or isinstance(n, bool) or n < 0:
                errs.append(f"resharding_eqns[{prim!r}] must be an "
                            f"int >= 0, got {n!r}")
    # v15: a ledger for a ZeRO entry point must say which stage it
    # measured — stage 3's collapse (nothing replicated but BN state
    # and scalars) is only comparable against stage 1/2 ledgers when
    # each carries its stage; validated whenever present at any
    # version, required on fresh v15 zero-EP records
    if "zero_stage" in rec:
        zs = rec["zero_stage"]
        if not isinstance(zs, int) or isinstance(zs, bool) \
                or zs not in (1, 2, 3):
            errs.append(f"'zero_stage' must be 1, 2 or 3 when present, "
                        f"got {zs!r}")
    sv_rec = rec.get("schema_version")
    if (isinstance(sv_rec, int) and not isinstance(sv_rec, bool)
            and sv_rec >= 15 and isinstance(epn, str) and "zero" in epn
            and not rec.get("stale") and "zero_stage" not in rec):
        errs.append("fresh sharding records for ZeRO entry points must "
                    "carry 'zero_stage' (schema v15)")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- numerics record schema -------------------------------------------------

def validate_numerics_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: numerics`` JSONL record
    (``NumericsMonitor.to_record`` enriched by the exporter): the
    common envelope, a subject (``metric`` or ``entry_point``), the
    step/overflow tallies, a non-empty per-layer health list
    (nonfinite counts, abs-max, grad norm, underflow fraction), a
    ``culprit`` that — when named — must actually be one of the
    record's layers (an attribution pointing at a layer the record
    does not describe is a hand-built record, not a flush), plus the
    optional per-bucket and divergence-digest sections with their own
    cross-field consistency (``in_sync`` iff zero desync steps)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types, allow_none=False):
        return _need(rec, errs, key, types, allow_none)

    _check_envelope(rec, errs)
    if rec.get("kind") != "numerics":
        errs.append(f"kind must be 'numerics', got {rec.get('kind')!r}")
    subject = rec.get("entry_point", rec.get("metric"))
    if not isinstance(subject, str) or not subject:
        errs.append("numerics records must carry a non-empty "
                    "'entry_point' or 'metric'")
    steps = need("steps", int)
    ov = need("overflow_steps", int)
    for key, v in (("steps", steps), ("overflow_steps", ov)):
        if isinstance(v, int) and not isinstance(v, bool) and v < 0:
            errs.append(f"{key!r} must be >= 0, got {v}")
    if (isinstance(steps, int) and isinstance(ov, int)
            and not isinstance(steps, bool) and not isinstance(ov, bool)
            and ov > steps):
        errs.append(f"overflow_steps ({ov}) exceeds steps ({steps})")
    for opt in ("loss_scale", "grad_norm", "tiny"):
        if opt in rec:
            v = rec[opt]
            if (not isinstance(v, numbers.Number)
                    or isinstance(v, bool) or v < 0):
                errs.append(f"{opt!r} must be a number >= 0 when "
                            f"present, got {v!r}")
    if "half_dtype" in rec and rec["half_dtype"] not in (
            "float16", "bfloat16"):
        errs.append(f"'half_dtype' must be float16/bfloat16, got "
                    f"{rec['half_dtype']!r}")
    layer_names = set()
    layers = need("layers", list)
    if isinstance(layers, list):
        if not layers:
            errs.append("layers must be non-empty (a health record "
                        "with no layers describes nothing)")
        for i, lyr in enumerate(layers):
            if not isinstance(lyr, dict):
                errs.append(f"layers[{i}] is not an object")
                continue
            name = lyr.get("name")
            if not isinstance(name, str) or not name:
                errs.append(f"layers[{i}].name must be a non-empty "
                            f"string")
            else:
                layer_names.add(name)
            nf = lyr.get("nonfinite")
            if not isinstance(nf, int) or isinstance(nf, bool) or nf < 0:
                errs.append(f"layers[{i}].nonfinite must be an int "
                            f">= 0, got {nf!r}")
            for key in ("abs_max", "grad_norm"):
                v = lyr.get(key)
                # `not (v >= 0)` also rejects NaN (all NaN
                # comparisons are false) — a health record carrying
                # un-numbers is worse than none
                if (not isinstance(v, numbers.Number)
                        or isinstance(v, bool) or not (v >= 0)):
                    errs.append(f"layers[{i}].{key} must be a number "
                                f">= 0, got {v!r}")
            uf = lyr.get("underflow_fraction")
            if (not isinstance(uf, numbers.Number)
                    or isinstance(uf, bool)
                    or not (0.0 <= uf <= 1.0)):
                errs.append(f"layers[{i}].underflow_fraction must be "
                            f"in [0, 1], got {uf!r}")
    culprit = rec.get("culprit")
    if culprit is not None:
        if not isinstance(culprit, str) or not culprit:
            errs.append(f"'culprit' must be null or a non-empty "
                        f"string, got {culprit!r}")
        elif isinstance(layers, list) and culprit not in layer_names:
            errs.append(f"culprit {culprit!r} is not one of the "
                        f"record's layers")
    if culprit is not None and isinstance(ov, int) \
            and not isinstance(ov, bool) and ov == 0:
        errs.append("a culprit with zero overflow_steps attributes an "
                    "overflow that never happened")
    if "buckets" in rec:
        bks = rec["buckets"]
        if not isinstance(bks, list):
            errs.append("'buckets' must be a list when present")
        else:
            for i, b in enumerate(bks):
                if not isinstance(b, dict):
                    errs.append(f"buckets[{i}] is not an object")
                    continue
                lbl = b.get("label")
                if not isinstance(lbl, str) or not lbl:
                    errs.append(f"buckets[{i}].label must be a "
                                f"non-empty string")
                nf = b.get("nonfinite")
                if not isinstance(nf, int) or isinstance(nf, bool) \
                        or nf < 0:
                    errs.append(f"buckets[{i}].nonfinite must be an "
                                f"int >= 0, got {nf!r}")
                for key in ("abs_max", "grad_norm",
                            "compression_sq_error"):
                    if key in b:
                        v = b[key]
                        if (not isinstance(v, numbers.Number)
                                or isinstance(v, bool)
                                or not (v >= 0)):
                            errs.append(f"buckets[{i}].{key} must be "
                                        f"a number >= 0, got {v!r}")
    if "divergence" in rec:
        div = rec["divergence"]
        if not isinstance(div, dict):
            errs.append("'divergence' must be an object when present")
        else:
            mr = div.get("max_rel_dev")
            if (not isinstance(mr, numbers.Number)
                    or isinstance(mr, bool) or not (mr >= 0)):
                errs.append(f"divergence.max_rel_dev must be a number "
                            f">= 0, got {mr!r}")
            ds = div.get("desync_steps")
            if not isinstance(ds, int) or isinstance(ds, bool) or ds < 0:
                errs.append(f"divergence.desync_steps must be an int "
                            f">= 0, got {ds!r}")
            ins = div.get("in_sync")
            if not isinstance(ins, bool):
                errs.append(f"divergence.in_sync must be a bool, got "
                            f"{ins!r}")
            elif isinstance(ds, int) and not isinstance(ds, bool) \
                    and ins != (ds == 0):
                errs.append(f"divergence.in_sync ({ins}) inconsistent "
                            f"with desync_steps ({ds})")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- run record schema ------------------------------------------------------

# anomaly kinds a supervisor may declare — kept in sync with
# observability.supervisor.ANOMALY_KINDS (duplicated here so the
# stdlib-only CI loader never imports the supervisor module; the
# pytest coverage pins the two tuples equal)
RUN_ANOMALY_KINDS = ("stall", "loss_spike", "nan",
                     "throughput_regression", "replica_divergence",
                     "recompilation_storm")


def validate_run_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: run`` JSONL record
    (``RunSupervisor.record`` enriched by the exporter, schema v5):
    the common envelope, a non-empty ``run`` name, the observation /
    watermark tallies, per-kind anomaly counts over the KNOWN kinds,
    a bounded anomaly-detail list whose entries each name a counted
    kind, and the verdict cross-check — ``ok`` iff zero anomalies
    (a record claiming health while counting anomalies is lying to
    the dashboard)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types, allow_none=False):
        return _need(rec, errs, key, types, allow_none)

    _check_envelope(rec, errs)
    if rec.get("kind") != "run":
        errs.append(f"kind must be 'run', got {rec.get('kind')!r}")
    run = need("run", str)
    if isinstance(run, str) and not run:
        errs.append("run must be non-empty")
    obs = need("observations", int)
    if isinstance(obs, int) and not isinstance(obs, bool) and obs < 0:
        errs.append(f"observations must be >= 0, got {obs}")
    wm = rec.get("watermark")
    if wm is not None and (not isinstance(wm, int)
                           or isinstance(wm, bool)):
        errs.append(f"'watermark' must be null or an int, got {wm!r}")
    verdict = need("verdict", str)
    if isinstance(verdict, str) and verdict not in ("ok", "attention"):
        errs.append(f"verdict must be 'ok' or 'attention', got "
                    f"{verdict!r}")
    counts = need("anomaly_counts", dict)
    total = None
    if isinstance(counts, dict):
        total = 0
        for k, v in sorted(counts.items()):
            if k not in RUN_ANOMALY_KINDS:
                errs.append(f"anomaly_counts names unknown kind {k!r} "
                            f"(known: {RUN_ANOMALY_KINDS})")
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"anomaly_counts[{k!r}] must be an int "
                            f">= 0, got {v!r}")
            else:
                total += v
    if isinstance(verdict, str) and total is not None \
            and verdict in ("ok", "attention") \
            and (verdict == "ok") != (total == 0):
        errs.append(f"verdict {verdict!r} inconsistent with "
                    f"{total} counted anomalies")
    anomalies = need("anomalies", list)
    if isinstance(anomalies, list):
        per_kind: Dict[str, int] = {}
        for i, a in enumerate(anomalies):
            if not isinstance(a, dict):
                errs.append(f"anomalies[{i}] is not an object")
                continue
            k = a.get("kind")
            if k not in RUN_ANOMALY_KINDS:
                errs.append(f"anomalies[{i}].kind must be one of "
                            f"{RUN_ANOMALY_KINDS}, got {k!r}")
            else:
                per_kind[k] = per_kind.get(k, 0) + 1
            o = a.get("observation")
            if not isinstance(o, int) or isinstance(o, bool) or o < 1:
                errs.append(f"anomalies[{i}].observation must be an "
                            f"int >= 1, got {o!r}")
        if isinstance(counts, dict):
            for k, n in sorted(per_kind.items()):
                c = counts.get(k)
                if isinstance(c, int) and not isinstance(c, bool) \
                        and n > c:
                    errs.append(
                        f"anomalies lists {n} {k!r} entries but "
                        f"anomaly_counts[{k!r}] is {c} (the detail "
                        f"list is bounded, the counts are exact — "
                        f"details can never exceed the count)")
    # the loss / step-time summaries, when present, must be objects of
    # numbers-or-null with NaN rejected (x == x is False only for NaN)
    for opt in ("loss", "step_time_s"):
        if opt in rec:
            d = rec[opt]
            if not isinstance(d, dict):
                errs.append(f"{opt!r} must be an object when present")
                continue
            for k, v in sorted(d.items()):
                if v is None:
                    continue
                if (not isinstance(v, numbers.Number)
                        or isinstance(v, bool) or v != v):
                    errs.append(f"{opt}.{k} must be a finite number "
                                f"or null, got {v!r}")
    for opt in ("checkpoints",):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0 when "
                            f"present, got {v!r}")
    if "duration_s" in rec:
        v = rec["duration_s"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (v >= 0)):
            errs.append(f"'duration_s' must be a number >= 0, got "
                        f"{v!r}")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- recovery record schema -------------------------------------------------

# fleet.recovery.RECOVERY_ROLES / RECOVERY_ACTION_KINDS /
# RECOVERY_CAUSES (duplicated here so the stdlib-side validator needs
# no jax-adjacent import — tests pin the pairs equal, the
# RUN_ANOMALY_KINDS discipline)
RECOVERY_ROLES = ("training", "serving")
RECOVERY_ACTION_KINDS = (
    "world_shrink", "resume", "rollback", "preempt_snapshot",
    "admission_tighten", "admission_relax",
    "class_admission_tighten", "class_admission_relax",
    "window_shrink", "window_grow",
    "drain", "undrain",
    "cooldown_shorten", "cooldown_extend")
RECOVERY_CAUSES = ("fault", "verdict", "preemption")


def validate_recovery_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: recovery`` JSONL record
    (``fleet.recovery.RecoveryLog.record`` enriched by the exporter,
    schema v6): the common envelope, a known controller ``role``, the
    episode/action tallies, a bounded action-detail list whose entries
    each name a known action kind inside a counted episode, and the
    MTTR aggregate — internally consistent the way a dashboard
    assumes (details never exceed the total, the per-episode maximum
    never exceeds it either, MTTR numbers are finite and
    non-negative)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types, allow_none=False):
        return _need(rec, errs, key, types, allow_none)

    _check_envelope(rec, errs)
    if rec.get("kind") != "recovery":
        errs.append(f"kind must be 'recovery', got {rec.get('kind')!r}")
    role = need("role", str)
    if isinstance(role, str) and role not in RECOVERY_ROLES:
        errs.append(f"role must be one of {RECOVERY_ROLES}, got "
                    f"{role!r}")
    subj = need("subject", str)
    if isinstance(subj, str) and not subj:
        errs.append("subject must be non-empty")
    eps = need("episodes", int)
    if isinstance(eps, int) and not isinstance(eps, bool) and eps < 0:
        errs.append(f"episodes must be >= 0, got {eps}")
    total = need("actions_total", int)
    if isinstance(total, int) and not isinstance(total, bool) \
            and total < 0:
        errs.append(f"actions_total must be >= 0, got {total}")
    mx = need("max_actions_in_episode", int)
    if isinstance(mx, int) and not isinstance(mx, bool):
        if mx < 0:
            errs.append(f"max_actions_in_episode must be >= 0, got "
                        f"{mx}")
        elif isinstance(total, int) and not isinstance(total, bool) \
                and mx > total:
            errs.append(f"max_actions_in_episode ({mx}) exceeds "
                        f"actions_total ({total})")
        elif (isinstance(eps, int) and not isinstance(eps, bool)
              and eps == 0 and mx > 0):
            errs.append(f"max_actions_in_episode ({mx}) with zero "
                        f"episodes")
    need("in_flight", bool)
    actions = need("actions", list)
    if isinstance(actions, list):
        if isinstance(total, int) and not isinstance(total, bool) \
                and len(actions) > total:
            errs.append(f"actions lists {len(actions)} entries but "
                        f"actions_total is {total} (the detail list "
                        f"is bounded, the counts are exact)")
        for i, a in enumerate(actions):
            if not isinstance(a, dict):
                errs.append(f"actions[{i}] is not an object")
                continue
            k = a.get("kind")
            if k not in RECOVERY_ACTION_KINDS:
                errs.append(f"actions[{i}].kind must be one of "
                            f"{RECOVERY_ACTION_KINDS}, got {k!r}")
            ep = a.get("episode")
            if ep is None:
                # an action taken before any episode opened (the
                # unwinding/correction case) carries a null episode
                pass
            elif not isinstance(ep, int) or isinstance(ep, bool) \
                    or ep < 1:
                errs.append(f"actions[{i}].episode must be null or "
                            f"an int >= 1, got {ep!r}")
            elif isinstance(eps, int) and not isinstance(eps, bool) \
                    and ep > eps:
                errs.append(f"actions[{i}].episode ({ep}) exceeds "
                            f"episodes ({eps})")
            t = a.get("t_s")
            if (not isinstance(t, numbers.Number)
                    or isinstance(t, bool) or not (t >= 0)):
                errs.append(f"actions[{i}].t_s must be a number >= 0, "
                            f"got {t!r}")
    mttr = need("mttr_s", dict)
    if isinstance(mttr, dict):
        c = mttr.get("count")
        if not isinstance(c, int) or isinstance(c, bool) or c < 0:
            errs.append(f"mttr_s.count must be an int >= 0, got {c!r}")
        for k in ("last", "mean"):
            v = mttr.get(k)
            if v is None:
                if isinstance(c, int) and not isinstance(c, bool) \
                        and c > 0:
                    errs.append(f"mttr_s.{k} is null with count {c}")
                continue
            if (not isinstance(v, numbers.Number)
                    or isinstance(v, bool) or v != v or not (v >= 0)):
                errs.append(f"mttr_s.{k} must be null or a finite "
                            f"number >= 0, got {v!r}")
            elif isinstance(c, int) and not isinstance(c, bool) \
                    and c == 0:
                errs.append(f"mttr_s.{k} is {v} with zero "
                            f"measurements")
    # role extras, validated whenever present
    if "world" in rec:
        v = rec["world"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errs.append(f"'world' must be an int >= 1 when present, "
                        f"got {v!r}")
    # schema-v7 preemption fields, validated whenever present (older
    # records simply predate them)
    if "cause" in rec and rec["cause"] is not None:
        if rec["cause"] not in RECOVERY_CAUSES:
            errs.append(f"'cause' must be null or one of "
                        f"{RECOVERY_CAUSES}, got {rec['cause']!r}")
    if "preempted" in rec and not isinstance(rec["preempted"], bool):
        errs.append(f"'preempted' must be a bool when present, got "
                    f"{rec['preempted']!r}")
    if "data_state" in rec and rec["data_state"] is not None:
        ds = rec["data_state"]
        if not isinstance(ds, dict):
            errs.append("'data_state' must be an object when present")
        else:
            for key in ("samples_consumed", "epoch", "cursor"):
                if key in ds:
                    v = ds[key]
                    if (not isinstance(v, int) or isinstance(v, bool)
                            or v < 0):
                        errs.append(f"data_state.{key} must be an int "
                                    f">= 0, got {v!r}")
            sid, ns = ds.get("shard_id"), ds.get("num_shards")
            for key, v in (("shard_id", sid), ("num_shards", ns)):
                if v is not None and (not isinstance(v, int)
                                      or isinstance(v, bool) or v < 0):
                    errs.append(f"data_state.{key} must be an int "
                                f">= 0, got {v!r}")
            if (isinstance(sid, int) and isinstance(ns, int)
                    and not isinstance(sid, bool)
                    and not isinstance(ns, bool) and ns >= 1
                    and not 0 <= sid < ns):
                errs.append(f"data_state.shard_id ({sid}) out of "
                            f"range for num_shards ({ns})")
    for opt in ("recoveries", "max_queue", "base_max_queue"):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0 when "
                            f"present, got {v!r}")
    if "duration_s" in rec:
        v = rec["duration_s"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (v >= 0)):
            errs.append(f"'duration_s' must be a number >= 0, got "
                        f"{v!r}")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- trace record schema ----------------------------------------------------

def validate_trace_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: trace`` JSONL record
    (``SpanRecorder.trace_record`` enriched by the exporter): the
    common envelope, a non-empty ``trace_id``, and a non-empty span
    list where every span belongs to the record's trace, carries a
    unique positive ``span_id``, and any ``parent_id`` references an
    EARLIER span id (span ids are allocated in causal order — a child
    pointing at a later or unknown parent means the recorder lost the
    chain, exactly the worker-thread interleaving bug this schema
    exists to catch)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types):
        return _need(rec, errs, key, types)

    _check_envelope(rec, errs)
    if rec.get("kind") != "trace":
        errs.append(f"kind must be 'trace', got {rec.get('kind')!r}")
    tid = need("trace_id", str)
    if isinstance(tid, str) and not tid:
        errs.append("trace_id must be non-empty")
    spans = need("spans", list)
    n = need("span_count", int)
    if isinstance(spans, list):
        if not spans:
            errs.append("spans must be non-empty (an empty trace is "
                        "not a trace)")
        if isinstance(n, int) and not isinstance(n, bool) \
                and n != len(spans):
            errs.append(f"span_count ({n}) != len(spans) "
                        f"({len(spans)})")
        all_ids = {sp.get("span_id") for sp in spans
                   if isinstance(sp, dict)}
        seen: set = set()
        for i, sp in enumerate(spans):
            if not isinstance(sp, dict):
                errs.append(f"spans[{i}] is not an object")
                continue
            name = sp.get("name")
            if not isinstance(name, str) or not name:
                errs.append(f"spans[{i}].name must be a non-empty "
                            f"string")
            if sp.get("ph") not in ("X", "i"):
                errs.append(f"spans[{i}].ph must be 'X' or 'i', got "
                            f"{sp.get('ph')!r}")
            if not isinstance(sp.get("ts"), numbers.Number):
                errs.append(f"spans[{i}].ts must be a number")
            if isinstance(tid, str) and sp.get("trace_id") != tid:
                errs.append(f"spans[{i}] belongs to trace "
                            f"{sp.get('trace_id')!r}, record is {tid!r}")
            sid = sp.get("span_id")
            if not isinstance(sid, int) or isinstance(sid, bool) \
                    or sid < 1:
                errs.append(f"spans[{i}].span_id must be an int >= 1")
                continue
            if sid in seen:
                errs.append(f"duplicate span_id {sid}")
            seen.add(sid)
            pid = sp.get("parent_id")
            if pid is not None:
                if not isinstance(pid, int) or isinstance(pid, bool):
                    errs.append(f"spans[{i}].parent_id must be an int")
                elif pid >= sid:
                    errs.append(
                        f"spans[{i}] (span_id {sid}) parents on "
                        f"{pid}, which is not causally earlier")
                elif pid not in all_ids:
                    # a parent that is not in the record at all means
                    # the chain's head was lost (e.g. evicted from a
                    # bounded recorder): not a complete trace
                    errs.append(
                        f"spans[{i}] (span_id {sid}) parents on "
                        f"{pid}, which is not in this record")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


# -- profile record schema --------------------------------------------------

# observability.timeline.PROFILE_FIELDS (duplicated here so the
# stdlib-only CI loader never imports the timeline module; the pytest
# coverage pins the two tuples equal — the RUN_ANOMALY_KINDS
# discipline)
PROFILE_TIME_FIELDS = ("span_ms", "device_busy_ms", "compute_ms",
                       "collective_ms", "gap_ms", "overlap_ms")
_PROFILE_KERNEL_KINDS = ("compute", "collective")


def validate_profile_record(rec: Any) -> List[str]:
    """Schema check for one ``kind: profile`` JSONL record (the
    device-timeline attribution from ``observability.timeline`` via
    ``bench.py --profile`` or ``/profilez``, schema v8): the common
    envelope, a subject (``metric`` or ``entry_point``), the six
    non-negative timing fields, and the interval arithmetic a
    hand-built record gets wrong — busy never exceeds the span, gap
    reassembles span minus busy, the class unions bound the busy
    union from both sides, overlap fits inside BOTH classes, and the
    measured fraction is overlap over collective time.  ``top_kernels``
    entries must each name a known class; the optional KV fragmentation
    fields follow the bench-record rules (waste is a subset of the
    allocation, utilization is a fraction)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]

    def need(key, types, allow_none=False):
        return _need(rec, errs, key, types, allow_none)

    _check_envelope(rec, errs)
    if rec.get("kind") != "profile":
        errs.append(f"kind must be 'profile', got {rec.get('kind')!r}")
    subject = rec.get("entry_point", rec.get("metric"))
    if not isinstance(subject, str) or not subject:
        errs.append("profile records must carry a non-empty "
                    "'entry_point' or 'metric'")
    vals = {}
    for key in PROFILE_TIME_FIELDS:
        v = need(key, numbers.Number)
        if isinstance(v, numbers.Number) and not isinstance(v, bool):
            if not (v >= 0):           # also rejects NaN
                errs.append(f"{key!r} must be >= 0, got {v!r}")
            else:
                vals[key] = float(v)
    frac = need("measured_overlap_fraction", numbers.Number)
    if (isinstance(frac, numbers.Number) and not isinstance(frac, bool)
            and not (0.0 <= frac <= 1.0)):
        errs.append(f"'measured_overlap_fraction' must be in [0, 1], "
                    f"got {frac!r}")

    def tol(x):
        # the producer rounds every field to 4 decimals independently;
        # merged-interval arithmetic is exact before rounding
        return max(0.01, 0.01 * x)

    if len(vals) == len(PROFILE_TIME_FIELDS):
        span, busy = vals["span_ms"], vals["device_busy_ms"]
        comp, coll = vals["compute_ms"], vals["collective_ms"]
        gap, ovl = vals["gap_ms"], vals["overlap_ms"]
        if busy > span + tol(span):
            errs.append(f"device_busy_ms ({busy}) exceeds span_ms "
                        f"({span})")
        if abs(gap - max(span - busy, 0.0)) > tol(span):
            errs.append(f"gap_ms ({gap}) != span_ms - device_busy_ms "
                        f"({span} - {busy})")
        if busy > comp + coll + tol(busy):
            errs.append(f"device_busy_ms ({busy}) exceeds compute_ms "
                        f"+ collective_ms ({comp} + {coll}) — the "
                        f"busy union is covered by the class unions")
        if busy + tol(busy) < max(comp, coll):
            errs.append(f"device_busy_ms ({busy}) below "
                        f"max(compute_ms, collective_ms) "
                        f"({comp}, {coll})")
        if ovl > min(comp, coll) + tol(ovl):
            errs.append(f"overlap_ms ({ovl}) exceeds a class union it "
                        f"is an intersection of ({comp}, {coll})")
        if (isinstance(frac, numbers.Number)
                and not isinstance(frac, bool)):
            if coll > 0:
                expect = min(max(ovl / coll, 0.0), 1.0)
                if abs(frac - expect) > max(0.01, 0.02 * expect):
                    errs.append(
                        f"measured_overlap_fraction ({frac}) "
                        f"inconsistent with overlap_ms/collective_ms "
                        f"({ovl}/{coll})")
            elif frac != 0.0:
                errs.append(f"measured_overlap_fraction ({frac}) with "
                            f"zero collective_ms")
    for opt in ("kernel_count", "lane_count"):
        if opt in rec:
            v = rec[opt]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{opt!r} must be an int >= 0 when "
                            f"present, got {v!r}")
    if "steps" in rec:
        v = rec["steps"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errs.append(f"'steps' must be an int >= 1 when present, "
                        f"got {v!r}")
    if "duration_ms" in rec:
        v = rec["duration_ms"]
        if (not isinstance(v, numbers.Number) or isinstance(v, bool)
                or not (v >= 0)):
            errs.append(f"'duration_ms' must be a number >= 0 when "
                        f"present, got {v!r}")
    if "trace_path" in rec and not isinstance(rec["trace_path"], str):
        errs.append("'trace_path' must be a string when present")
    if "top_kernels" in rec:
        top = rec["top_kernels"]
        if not isinstance(top, list):
            errs.append("'top_kernels' must be a list when present")
        else:
            for i, k in enumerate(top):
                if not isinstance(k, dict):
                    errs.append(f"top_kernels[{i}] is not an object")
                    continue
                name = k.get("name")
                if not isinstance(name, str) or not name:
                    errs.append(f"top_kernels[{i}].name must be a "
                                f"non-empty string")
                if k.get("kind") not in _PROFILE_KERNEL_KINDS:
                    errs.append(f"top_kernels[{i}].kind must be one "
                                f"of {_PROFILE_KERNEL_KINDS}, got "
                                f"{k.get('kind')!r}")
                c = k.get("count")
                if not isinstance(c, int) or isinstance(c, bool) \
                        or c < 1:
                    errs.append(f"top_kernels[{i}].count must be an "
                                f"int >= 1, got {c!r}")
                t = k.get("total_ms")
                if (not isinstance(t, numbers.Number)
                        or isinstance(t, bool) or not (t >= 0)):
                    errs.append(f"top_kernels[{i}].total_ms must be a "
                                f"number >= 0, got {t!r}")
    # KV fragmentation fields on serving profiles: the same shared
    # contract as the bench-record fields
    _check_kv_fields(rec, errs)
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        errs.append(f"record is not JSON-serializable: {e}")
    return errs


def validate_telemetry_record(rec: Any) -> List[str]:
    """Dispatching validator: graph-lint, fleet and trace records (by
    ``kind``) go through their own schemas, everything else through
    the bench schema — so one stream may interleave bench
    measurements, lint findings (``bench.py --graph-lint``), fleet
    snapshots (``bench.py --fleet N``), request traces
    (``kind: trace``), cost-model dumps (``kind: memory``, from
    ``python -m apex_tpu.analysis --memory`` / ``bench.py``) and
    gradient-health dumps (``kind: numerics``, from
    ``bench.py --numerics`` / ``NumericsMonitor.to_record``) and
    training-run supervisor verdicts (``kind: run``, from
    ``bench.py --run`` / ``RunSupervisor.record``, schema v5) and
    recovery-controller snapshots (``kind: recovery``, from
    ``bench.py --chaos`` / ``RecoveryLog.record``, schema v6) and
    device-timeline attributions (``kind: profile``, from
    ``bench.py --profile`` / ``/profilez``, schema v8) and static
    replication ledgers (``kind: sharding``, from
    ``python -m apex_tpu.analysis --sharding`` / ``bench.py
    --graph-lint``, schema v13)."""
    if isinstance(rec, dict) and rec.get("kind") in (
            "graph_lint", "graph_lint_summary"):
        return validate_lint_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "fleet":
        return validate_fleet_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "trace":
        return validate_trace_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "memory":
        return validate_memory_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "numerics":
        return validate_numerics_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "run":
        return validate_run_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "recovery":
        return validate_recovery_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "profile":
        return validate_profile_record(rec)
    if isinstance(rec, dict) and rec.get("kind") == "sharding":
        return validate_sharding_record(rec)
    return validate_bench_record(rec)


def validate_telemetry_jsonl(lines: Iterable[str]) -> List[str]:
    """Validate a mixed bench + graph-lint + fleet + trace + memory +
    numerics + run JSONL stream."""
    return _validate_jsonl(lines, validate_telemetry_record)


def _validate_jsonl(lines: Iterable[str], validate) -> List[str]:
    errs: List[str] = []
    n = 0
    for i, raw in enumerate(lines, 1):
        raw = raw.strip()
        if not raw:
            continue
        n += 1
        try:
            rec = json.loads(raw)
        except ValueError as e:
            errs.append(f"line {i}: not JSON ({e})")
            continue
        label = rec.get("metric") or rec.get("kind") or "?" \
            if isinstance(rec, dict) else "?"
        for e in validate(rec):
            errs.append(f"line {i} ({label}): {e}")
    if n == 0:
        errs.append("no records found")
    return errs
