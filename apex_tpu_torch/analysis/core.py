"""Rule engine: findings, the rule registry, and ``analyze``.

Counterpart of ``apex_tpu/analysis/core.py``, with its names, its
expectation schema and its record schema.  A :class:`Rule` looks at one
entry point's traced graph (:class:`.graphs.Graph`, the aten graph of one
call of its step) and returns :class:`Finding`s.  Rules are data-driven: each entry point
carries an ``expect`` dict (see :mod:`.entry_points`) and a rule only
applies where its expectation key is present (except the always-on
host-transfer rule).  Findings are machine-readable and export as
schema-versioned JSONL records through ``observability.exporters`` —
tests, the CI gate (tests/ci/graph_lint_torch.py), and the CLI
(``python -m apex_tpu_torch.analysis``) all consume the same objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Finding", "Rule", "RULES", "register_rule", "get_rule",
           "analyze", "analyze_entry_point", "findings_to_records",
           "run_lint", "ERROR", "WARNING"]

ERROR = "error"
WARNING = "warning"


@dataclass
class Finding:
    """One violated invariant in one entry point's graph."""
    rule: str
    entry_point: str
    message: str
    severity: str = ERROR
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        """Flat JSONL payload (enriched with schema_version/host/stale
        by the exporter)."""
        rec = {"kind": "graph_lint", "rule": self.rule,
               "severity": self.severity, "entry_point": self.entry_point,
               "message": self.message}
        if self.detail:
            rec["detail"] = self.detail
        return rec

    def __str__(self):
        return (f"[{self.severity}] {self.entry_point}: "
                f"{self.rule}: {self.message}")


class Rule:
    """Base class: subclasses set ``name``/``expect_key`` and implement
    ``check``.  ``expect_key`` is the entry-point expectation that opts
    a graph into the rule; ``None`` means the rule is unconditional."""

    name: str = "?"
    expect_key: Optional[str] = None

    def applies(self, entry_point) -> bool:
        if self.expect_key is None:
            return True
        return self.expect_key in entry_point.expect

    def check(self, entry_point, graph) -> List[Finding]:
        raise NotImplementedError

    def finding(self, entry_point, message: str, severity: str = ERROR,
                **detail) -> Finding:
        return Finding(rule=self.name, entry_point=entry_point.name,
                       message=message, severity=severity, detail=detail)


RULES: Dict[str, Rule] = {}


def register_rule(rule_cls):
    """Class decorator: instantiate and register a rule by its name."""
    rule = rule_cls()
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return rule_cls


def get_rule(name: str) -> Rule:
    try:
        return RULES[name]
    except KeyError:
        raise KeyError(f"unknown rule {name!r}; known: {sorted(RULES)}")


def analyze_entry_point(entry_point,
                        rules: Optional[Iterable] = None
                        ) -> List[Finding]:
    """Run every applicable rule (objects or names) over one entry
    point's graph."""
    out: List[Finding] = []
    graph = entry_point.graph()
    if rules is None:
        rules = list(RULES.values())
    rules = [get_rule(r) if isinstance(r, str) else r for r in rules]
    for rule in rules:
        if rule.applies(entry_point):
            out.extend(rule.check(entry_point, graph))
    return out


def analyze(entry_points=None, rules=None, names=None, tags=None
            ) -> List[Finding]:
    """Run the analyzer: ``entry_points`` (objects) or ``names``/``tags``
    select from the registry; ``rules`` (names or objects) defaults to
    all registered rules."""
    from .entry_points import prefetch, select
    if entry_points is None:
        entry_points = select(names=names, tags=tags)
    entry_points = list(entry_points)
    prefetch(entry_points)
    if rules is not None:
        rules = [get_rule(r) if isinstance(r, str) else r for r in rules]
    findings: List[Finding] = []
    for ep in entry_points:
        findings.extend(analyze_entry_point(ep, rules=rules))
    return findings


def findings_to_records(findings: Iterable[Finding]) -> List[Dict[str, Any]]:
    return [f.to_record() for f in findings]


def run_lint(entry_points=None, rules=None, emit=None,
             skip_runtime_errors: bool = False, on_skip=None,
             progress=None) -> Dict[str, Any]:
    """Drive the analyzer end to end — the shared core of the CLI
    (``python -m apex_tpu_torch.analysis``), the CI gate and
    ``chip_smoke.py``'s analysis phase, so severity tallies and the
    summary-record shape cannot drift between consumers.

    ``emit(record)`` receives one RAW (un-enriched) JSONL payload per
    finding plus the final ``graph_lint_summary`` — callers route it
    through their exporter.  The multi-rank entry points of the selection
    are traced first, in one start of the gloo ranks
    (``entry_points.prefetch``).  ``skip_runtime_errors`` skips entry points
    whose builders raise RuntimeError (the rank-count gate) after
    calling ``on_skip(ep, exc)``; ``progress(ep, findings, seconds)``
    fires after each analyzed entry point.  Returns the summary dict.
    """
    import time as _time
    from .entry_points import prefetch, select
    if entry_points is None:
        entry_points = select()
    entry_points = list(entry_points)
    prefetch(entry_points)
    if rules is not None:
        rules = [get_rule(r) if isinstance(r, str) else r for r in rules]
    n_err = n_warn = n_run = n_skip = 0
    t_start = _time.perf_counter()
    for ep in entry_points:
        t0 = _time.perf_counter()
        try:
            findings = analyze_entry_point(ep, rules=rules)
        except RuntimeError as e:
            if not skip_runtime_errors:
                raise
            n_skip += 1
            if on_skip is not None:
                on_skip(ep, e)
            continue
        n_run += 1
        for f in findings:
            if f.severity == ERROR:
                n_err += 1
            else:
                n_warn += 1
            if emit is not None:
                emit(f.to_record())
        if progress is not None:
            progress(ep, findings, _time.perf_counter() - t0)
    summary: Dict[str, Any] = {
        "kind": "graph_lint_summary", "entry_points": n_run,
        "rules": len(rules) if rules is not None else len(RULES),
        "findings": n_err + n_warn, "errors": n_err,
        "warnings": n_warn,
        "elapsed_seconds": round(_time.perf_counter() - t_start, 2)}
    if n_skip:
        summary["skipped_entry_points"] = n_skip
    if emit is not None:
        emit(summary)
    return summary
