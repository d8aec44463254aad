#!/usr/bin/env python
"""CI gate for the PyTorch port: run apex_tpu_torch.analysis over every
registered hot entry point and fail on ANY finding.

The port's counterpart of tests/ci/graph_lint.py: no host sync in a step
the card captures, state updated in place (never rebound; the per-slot
length vectors too), conv/matmul operand dtypes matching the O-level
policy, relayout-free channels-last steps, the exact collective pattern
of each comm plan, the ranks' state agreeing where a step claims it
replicated, and every placement-changing collective explained by the
plan.  New rules registered in apex_tpu_torch.analysis.rules are picked
up automatically: this gate runs the full RULES registry through the
module CLI, which starts the gloo ranks the multi-rank entries trace on.
Usage:

    python tests/ci/graph_lint_torch.py                  # full registry
    python tests/ci/graph_lint_torch.py --tags serving   # subset
    python tests/ci/graph_lint_torch.py --entry paged    # substring

Stdout is pure schema-versioned JSONL (findings + a summary record);
progress goes to stderr.  Exit 0 = clean, 1 = any finding.  Unlike the
module CLI (``python -m apex_tpu_torch.analysis``), warnings also fail
here: CI has no one to read them.
"""

import json
import os
import sys

_ROOT = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir, os.pardir))


def main(argv):
    sys.path.insert(0, _ROOT)
    import io
    from apex_tpu_torch.analysis.__main__ import main as lint_main

    args = argv[1:]
    buf = io.StringIO()
    real = sys.stdout
    sys.stdout = buf
    try:
        rc = lint_main(args)
    finally:
        sys.stdout = real
    out = buf.getvalue()
    sys.stdout.write(out)
    sys.stdout.flush()

    # promote warnings to failures by reading the run's own
    # graph_lint_summary record — from the --out file when the stream
    # was redirected there (--out appends, so scan from the end);
    # argparse accepts both "--out PATH" and "--out=PATH"
    out_path = None
    for i, a in enumerate(args):
        if a == "--out" and i + 1 < len(args):
            out_path = args[i + 1]
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
    lines = out.splitlines()
    if out_path:
        with open(out_path) as f:
            lines = f.read().splitlines()
    n_warn = 0
    for ln in reversed(lines):
        if ln.strip():
            rec = json.loads(ln)
            if rec.get("kind") == "graph_lint_summary":
                n_warn = rec.get("warnings", 0)
                break
    if rc == 0 and n_warn:
        print(f"graph_lint: {n_warn} warning(s) — CI treats warnings "
              f"as failures", file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
