"""Full L1 cross-product driver of the port: the twin of tests/L1/run_l1.py
(the reference's tests/L1/common/run_test.sh + compare.py).

Trains ResNet-18 under the {O0..O3} x {loss scale} x {keep_batchnorm_fp32}
matrix on ``--device``, each config twice, and asserts:

- **bitwise** the same loss trajectory and final-parameter digest from
  the two runs (cuDNN set deterministic for them);
- on the card, every O0 config against the same config on the CPU,
  where the kernels' plain versions run, over the first ``CPU_ITERS``
  steps.  Not bitwise: cuDNN and oneDNN sum their convolutions in other
  orders, and Adam turns each last-bit difference of a small grad into a
  step of lr, so trajectories from scratch part within a few steps (the
  card's own run parts as far from itself when its input moves one ulp).
  So: the first three losses within 1e-3 relative (measured 1.3e-4), and
  every loss of the CPU run within twice the largest distance between the
  card's run and the card's run on the input moved one ulp (measured on
  an NVIDIA H100 at ResNet-18, batch 16, 32 x 32: 0.72 against that
  spread of 0.62 over the first 10 steps, 0.83 against 0.76 over 50);
- every trajectory finite, and at ``--iters >= 50`` the last loss below
  the first.

  python tests/L1/run_l1_torch.py --device cuda --iters 100 --out L1.json

Prints one JSON line a config and a summary line; exits non-zero on any
failure.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# beside this file; by path, since a host may have another `tests` package
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.abspath(__file__).rsplit("/tests/", 1)[0])

from torch_l1_common import FULL_MATRIX, is_fp32_config, train_one  # noqa


CPU_ITERS = 10          # the CPU run's steps: ~0.45 s each on a card's host


def run(matrix, device="cuda", iters=100, batch=16, image=32, log=print):
    """Run ``matrix`` as the module doc says; returns (per-config results,
    summary).  ``summary["failures"]`` lists what failed."""
    results, failures = [], []
    for (ol, ls, kbn) in matrix:
        key = f"{ol}_ls{ls}_kbn{kbn}"
        t0 = time.time()
        kw = dict(iters=iters, batch=batch, image=image)
        traj, dig = train_one(ol, ls, kbn, device=device, **kw)
        traj2, dig2 = train_one(ol, ls, kbn, device=device, **kw)
        bitwise = traj.tobytes() == traj2.tobytes() and dig == dig2
        if not bitwise:
            failures.append(f"{key}: two runs on {device} differ (max "
                            f"{float(np.max(np.abs(traj - traj2)))})")
        cpu_diff = spread = cpu_ok = None
        if is_fp32_config(ol) and device != "cpu":
            n = min(iters, CPU_ITERS)
            kw_n = dict(kw, iters=n)
            cpu, _ = train_one(ol, ls, kbn, device="cpu", **kw_n)
            moved, _ = train_one(ol, ls, kbn, device=device, nudge=True,
                                 **kw_n)
            cpu_diff = float(np.max(np.abs(traj[:n] - cpu)))
            spread = float(np.max(np.abs(traj[:n] - moved)))
            head = float(np.max(np.abs(traj[:3] - cpu[:3])
                                / np.abs(cpu[:3])))
            cpu_ok = head <= 1e-3 and cpu_diff <= 2 * spread
            if not cpu_ok:
                failures.append(
                    f"{key}: {device} and cpu trajectories part (first "
                    f"three losses {head:.2e} relative; max {cpu_diff:.3e} "
                    f"against the one-ulp spread {spread:.3e})")
        if not np.all(np.isfinite(traj)):
            failures.append(f"{key}: non-finite losses")
        if iters >= 50 and traj[-1] >= traj[0]:
            failures.append(f"{key}: no training progress")
        results.append({"config": key, "bitwise_repeat": bitwise,
                        "cpu_max_diff": cpu_diff,
                        "one_ulp_spread": spread,
                        "cpu_within_tolerance": cpu_ok,
                        "loss_first": float(traj[0]),
                        "loss_last": float(traj[-1]),
                        "ok": not any(f.startswith(key + ":")
                                      for f in failures),
                        "wall_s": round(time.time() - t0, 2)})
        log(json.dumps(results[-1]))
    summary = {"total": len(results),
               "bitwise_repeatable": sum(r["bitwise_repeat"]
                                         for r in results),
               "cpu_checked": sum(r["cpu_within_tolerance"] is not None
                                  for r in results),
               "within_tolerance": sum(bool(r["cpu_within_tolerance"])
                                       for r in results),
               "ok": sum(r["ok"] for r in results),
               "failures": failures}
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--configs", type=int, default=0,
                    help="run only the first N configs (0 = all 48)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    matrix = FULL_MATRIX[:args.configs] if args.configs else FULL_MATRIX
    results, summary = run(matrix, args.device, args.iters, args.batch,
                           args.image)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "summary": summary}, f, indent=1)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
