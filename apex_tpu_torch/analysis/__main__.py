"""CLI: ``python -m apex_tpu_torch.analysis`` — lint the port's hot steps.

Counterpart of ``python -m apex_tpu.analysis``, with its flags.  Stdout is
pure schema-versioned JSONL: one ``graph_lint`` record per finding plus
one ``graph_lint_summary`` record, enriched by
``observability.exporters.JsonlExporter``.  Human-readable progress goes
to stderr.  Exit status: 0 = clean, 1 = any error-severity finding (the
CI gate tests/ci/graph_lint_torch.py relies on this), 2 = bad usage.

The multi-rank entry points (DDP, ZeRO, TP) trace inside 8 gloo ranks on
the CPU, started once for the run through the port's launcher; the
launcher runs this file by path with ``--rank-job`` in each rank.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
from typing import List

if __package__ in (None, ""):
    # run by path (the rank launcher): import as the package's module
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    __package__ = "apex_tpu_torch.analysis"


def _rank_job(job: str, out: str) -> int:
    """One gloo rank of ``entry_points.prefetch``: trace the job's entries
    and, on rank 0, write their traces to ``out``."""
    import torch
    import torch.distributed as dist
    from ..parallel import init_process_group
    from .entry_points import rank_job
    torch.set_num_threads(1)
    rank = init_process_group()
    with open(job, "rb") as f:
        names = pickle.load(f)["names"]
    res = rank_job(names)
    dist.barrier()
    if rank == 0:
        with open(out + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(out + ".tmp", out)
    dist.destroy_process_group()
    return 0


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--rank-job"]:
        return _rank_job(argv[1], argv[2])
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.analysis",
        description="Graph lint over the port's hot entry points.")
    p.add_argument("--entry-points", default=None,
                   help="comma-separated entry-point names "
                        "(default: all registered)")
    p.add_argument("--tags", default=None,
                   help="comma-separated tags to select entry points "
                        "(e.g. training,serving)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule names (default: all)")
    p.add_argument("--entry", default=None, metavar="SUBSTR",
                   help="substring filter on entry-point names — the "
                        "rule-author iteration loop (--entry=paged runs "
                        "just the paged engine EPs).  Composes with "
                        "--entry-points/--tags and filters --list")
    p.add_argument("--rule", default=None, metavar="SUBSTR",
                   help="substring filter on rule names (e.g. "
                        "--rule=shard matches sharding + "
                        "resharding-census).  Composes with --rules "
                        "and filters --list")
    p.add_argument("--list", action="store_true",
                   help="list entry points and rules, run nothing")
    p.add_argument("--memory", action="store_true",
                   help="emit one `kind: memory` record per entry "
                        "point (analytic FLOPs/bytes + the recorded "
                        "graph's memory plan) instead of linting")
    p.add_argument("--sharding", action="store_true",
                   help="emit one `kind: sharding` record (the "
                        "replication ledger: per-dtype replicated "
                        "bytes, top replicated arrays, resharding "
                        "census) per entry point instead of linting. "
                        "Entry points traced on no process group "
                        "(serving engines) are skipped")
    p.add_argument("--out", default=None,
                   help="append JSONL findings to this path instead of "
                        "stdout")
    args = p.parse_args(argv)

    from . import ENTRY_POINTS, RULES, get_rule, run_lint, select
    from .entry_points import prefetch

    def _ep_match(name):
        return args.entry is None or args.entry in name

    def _rule_match(name):
        return args.rule is None or args.rule in name

    from ..observability.exporters import JsonlExporter

    if args.list:
        for ep in ENTRY_POINTS.values():
            if _ep_match(ep.name):
                print(f"{ep.name:32s} [{', '.join(sorted(ep.tags))}] "
                      f"{ep.description}")
        print("rules: " + ", ".join(
            r for r in sorted(RULES) if _rule_match(r)))
        return 0

    try:
        eps = select(
            names=args.entry_points.split(",")
            if args.entry_points else None,
            tags=args.tags.split(",") if args.tags else None)
        rules = ([get_rule(r) for r in args.rules.split(",")]
                 if args.rules else None)
    except KeyError as e:
        print(f"graph lint: {e.args[0]}", file=sys.stderr)
        return 2
    eps = [ep for ep in eps if _ep_match(ep.name)]
    if args.rule is not None:
        rules = [r for r in (rules if rules is not None
                             else RULES.values())
                 if _rule_match(r.name)]
        if not rules:
            print(f"no rules match --rule={args.rule}", file=sys.stderr)
            return 2
    if not eps:
        print("no entry points selected", file=sys.stderr)
        return 2

    def progress(ep, findings, dt):
        for f in findings:
            print(f"  {f}", file=sys.stderr)
        print(f"{ep.name:32s} {len(findings)} finding(s) [{dt:.1f}s]",
              file=sys.stderr)

    exp = JsonlExporter(path=args.out) if args.out \
        else JsonlExporter(stream=sys.stdout)

    if args.memory:
        # per-entry-point memory/FLOP dump: the cost count and the
        # memory plan of the recorded graph (free: the cached trace)
        from .entry_points import entry_point_memory_record
        prefetch(eps)
        failed = 0
        with exp:
            for ep in eps:
                t0 = time.perf_counter()
                try:
                    rec = entry_point_memory_record(ep)
                except RuntimeError as e:
                    # only a bare RuntimeError (the rank-count gate) is a
                    # skip; a subclass is a real failure
                    if type(e) is not RuntimeError:
                        failed += 1
                        print(f"{ep.name:32s} FAILED: {e}",
                              file=sys.stderr)
                        continue
                    print(f"{ep.name:32s} skipped: {e}",
                          file=sys.stderr)
                    continue
                except Exception as e:
                    failed += 1
                    print(f"{ep.name:32s} FAILED: {e}", file=sys.stderr)
                    continue
                exp.emit(rec)
                print(f"{ep.name:32s} flops={rec['flops']:.4g} "
                      f"peak_bytes={rec['peak_bytes']:,} "
                      f"[{time.perf_counter() - t0:.1f}s]",
                      file=sys.stderr)
        return 1 if failed else 0

    if args.sharding:
        # per-entry-point replication ledger from the ranks' digests
        # (free: the cached trace).  The bare-RuntimeError skip class:
        # an entry traced on no process group (the serving engines)
        from .sharding import entry_point_sharding_record
        prefetch(eps)
        failed = 0
        with exp:
            for ep in eps:
                t0 = time.perf_counter()
                try:
                    rec = entry_point_sharding_record(ep)
                except RuntimeError as e:
                    if type(e) is not RuntimeError:
                        failed += 1
                        print(f"{ep.name:32s} FAILED: {e}",
                              file=sys.stderr)
                        continue
                    print(f"{ep.name:32s} skipped: {e}",
                          file=sys.stderr)
                    continue
                except Exception as e:
                    failed += 1
                    print(f"{ep.name:32s} FAILED: {e}", file=sys.stderr)
                    continue
                exp.emit(rec)
                print(f"{ep.name:32s} "
                      f"replicated={rec['replicated_bytes']:,} "
                      f"({rec['replicated_fraction']:.1%} of world "
                      f"bytes) [{time.perf_counter() - t0:.1f}s]",
                      file=sys.stderr)
        return 1 if failed else 0
    t0 = time.perf_counter()
    with exp:
        summary = run_lint(entry_points=eps, rules=rules,
                           emit=exp.emit, progress=progress)
    print(f"graph lint: {summary['entry_points']} entry point(s), "
          f"{summary['errors']} error(s), {summary['warnings']} "
          f"warning(s) in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    return 1 if summary["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
