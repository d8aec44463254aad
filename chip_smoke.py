#!/usr/bin/env python3
"""Smoke run of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device   the card's name and power limit; TF32 off for matmul and cuDNN.
2. build    nvcc builds every kernel of ops/csrc from the checkout.
3. kernels  each kernel against its plain PyTorch version on the card, at
            ResNet-50's flat length (25,557,032) and an odd length, with
            timings (kernel, plain version, nearest library call) and the
            bound (bytes over the card's memory rate); the syncbn forward
            and backward at every BatchNorm shape of ResNet-50 at batch
            128 (y and dx bitwise; the row sums within
            f(hw)*2^-24*sum|term| of their fp64 sums) and at odd
            shapes, timed as one training step's 53 layers.
4. train    the single-card path: ResNet-50 under amp O2 + FusedAdam at
            batch 128, 3x224x224, then two steps of two micro-batches
            (axpby); the device time of three more steps by kernel
            (torch.profiler); and a small ResNet trained on the card
            against the same run on the CPU (plain versions), in fp32.
5. ddp      the data-parallel path on a one-rank NCCL group: ResNet-50 ->
            convert_syncbn_model -> O2 + FusedAdam -> DistributedDataParallel
            at batch 128, 12 steps and two of two micro-batches, the
            rank-0 broadcast checked, and three steps profiled.
6. overflow one fp16 step with an inf in the input: the loss scale halves
            and masters, m, v and the step counter stay bitwise.
7. counts   every kernel launched on each path; Adam once per step, the
            syncbn kernels once per BatchNorm layer and pass.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.  It
imports torch, numpy and apex_tpu_torch, and needs the repository
beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

# H100 SXM HBM3: 3.35 TB/s (NVIDIA's data sheet, at the 700 W limit)
MEM_BYTES_PER_S = 3.35e12
N_FULL = 25_557_032          # ResNet-50's flat parameter count
N_ODD = 1_000_003
SEED = 0
REPS = 20
DEVICE = "cuda"
BATCH = 128                  # the bench headline's per-chip batch
IMAGE = 224
OVERFLOW_BATCH = 32

REPLACES = {
    "multi_tensor_scale": "apex_tpu/ops/pallas_multi_tensor.py:45",
    "multi_tensor_axpby": "apex_tpu/ops/pallas_multi_tensor.py:89",
    "multi_tensor_l2norm": "apex_tpu/ops/pallas_multi_tensor.py:142",
    "fused_adam": "apex_tpu/ops/pallas_adam.py:27",
    "syncbn_fwd": "apex_tpu/ops/pallas_syncbn.py:59",
    "syncbn_bwd": "apex_tpu/ops/pallas_syncbn.py:65",
}
SOURCE = {
    "multi_tensor_scale": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "multi_tensor_axpby": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "multi_tensor_l2norm": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "fused_adam": "apex_tpu_torch/ops/csrc/adam.cu",
    "syncbn_fwd": "apex_tpu_torch/ops/csrc/syncbn.cu",
    "syncbn_bwd": "apex_tpu_torch/ops/csrc/syncbn.cu",
}
BN_LAYERS = 53               # BatchNorm layers of ResNet-50
BN_ODD = ((3, 37, 15, 13), (5, 9, 1, 1), (2, 7, 12, 12))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` launches, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, inner: int = 10) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    the replay timed as ``time_ms`` times a call, divided by ``inner``.
    ``time_ms`` of one call also counts the host time of the call when
    the card waits for it, which dominates a small kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = time_ms(graph.replay) / inner
    del graph
    return ms


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaNs in the same places counting as equal."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs().nan_to_num(0.0)
    return float(d.max()) if d.numel() else 0.0


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on a GPU and has nothing to run here")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    log(f"[device] {name} | nvidia-smi: {smi} | count "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    from apex_tpu_torch.ops import _build
    t0 = time.time()
    logs = _build.build_all()
    secs = time.time() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}.cu: {line.strip()}")
    log(f"[build] {sorted(logs)} built in {secs:.2f} s")


# -- phase 3 -----------------------------------------------------------------

def phase_kernels():
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    from apex_tpu_torch.ops import multi_tensor as mt

    dev = torch.device(DEVICE)
    rows = {}
    for n in (N_FULL, N_ODD):
        rs = np.random.RandomState(SEED + n % 97)
        x = torch.from_numpy(rs.randn(n).astype(np.float32)).to(dev)
        y = torch.from_numpy(rs.randn(n).astype(np.float32)).to(dev)
        err = {k: 0.0 for k in REPLACES if not k.startswith("syncbn")}

        # scale: clean, then one inf and one nan
        s = torch.full((), 1.0 / 65536.0, device=dev)
        for inject in (False, True):
            xi = x.clone()
            if inject:
                xi[n // 3] = float("inf")
                xi[n - 1] = float("nan")
            ok, fk = ops.multi_tensor_scale(xi, s)
            op, fp = mt._scale_plain(xi, s, torch.empty_like(xi))
            assert same(ok, op), "scale: kernel != plain"
            assert float(fk) == float(fp) == float(inject), \
                f"scale flag {float(fk)} plain {float(fp)} expected {inject}"
            err["multi_tensor_scale"] = max(err["multi_tensor_scale"],
                                            max_abs(ok, op))
        # in place, as the optimizer runs it
        xi = x.clone()
        ops.multi_tensor_scale(xi, s, out=xi)
        assert same(xi, x * s), "scale in place"

        # axpby: each arg_to_check, clean and with inf in x, then in y
        a = torch.full((), 1.0 / 1024.0, device=dev)
        b = torch.full((), 1.0, device=dev)
        for arg in (0, 1, -1):
            for bad in (None, "x", "y"):
                xi, yi = x.clone(), y.clone()
                if bad == "x":
                    xi[7] = float("inf")
                if bad == "y":
                    yi[n // 2] = float("-inf")
                ok, fk = ops.multi_tensor_axpby(a, b, xi, yi, arg)
                op, fp = mt._axpby_plain(a, b, xi, yi, arg,
                                         torch.empty_like(xi))
                want = float(bad is not None and (
                    arg == -1 or (arg == 0) == (bad == "x")))
                assert same(ok, op), f"axpby arg {arg} bad {bad}"
                assert float(fk) == float(fp) == want, \
                    f"axpby flag arg {arg} bad {bad}: {float(fk)} vs {want}"
                err["multi_tensor_axpby"] = max(err["multi_tensor_axpby"],
                                                max_abs(ok, op))

        # l2norm: relative 1e-6 (the sums run in another order)
        nk = ops.multi_tensor_l2norm(x)
        np_ = mt._l2norm_plain(x)
        rel = abs(float(nk) - float(np_)) / float(np_)
        assert rel <= 1e-6, f"l2norm rel err {rel}"
        assert float(ops.multi_tensor_l2norm(x)) == float(nk), \
            "l2norm differs between runs"
        err["multi_tensor_l2norm"] = abs(float(nk) - float(np_))

        # Adam: eps modes x weight decay x half copy; then the no-op flag
        p0 = x
        m0 = torch.from_numpy(
            (np.abs(rs.randn(n)) * 0.1).astype(np.float32)).to(dev)
        v0 = torch.from_numpy(
            (np.abs(rs.randn(n)) * 0.01).astype(np.float32)).to(dev)
        g0 = y * 1024.0
        ss = torch.full((), 1e-3, device=dev)
        inv = torch.full((), 1.0 / 1024.0, device=dev)
        zero = torch.zeros((), device=dev)
        for eps_in in (False, True):
            for wd in (0.0, 0.01):
                for hd in (None, torch.bfloat16, torch.float16):
                    bufs_k = [t.clone() for t in (p0, m0, v0)]
                    bufs_p = [t.clone() for t in (p0, m0, v0)]
                    hk = None if hd is None else torch.empty(n, dtype=hd,
                                                             device=dev)
                    hp = None if hd is None else torch.empty(n, dtype=hd,
                                                             device=dev)
                    args = (0.9, 0.999, 1e-8, eps_in, wd)
                    ops.fused_adam(*bufs_k, g0, ss, inv, *args, half=hk,
                                   noop=zero)
                    adam_mod._adam_plain(*bufs_p, g0, ss, inv, *args, hp,
                                         zero)
                    for k_, p_ in zip(bufs_k + [hk], bufs_p + [hp]):
                        if k_ is None:
                            continue
                        assert same(k_, p_), (f"adam eps_in {eps_in} wd {wd}"
                                              f" half {hd}: kernel != plain")
                        err["fused_adam"] = max(err["fused_adam"],
                                                max_abs(k_, p_))
                    # the no-op flag leaves everything bitwise unchanged
                    before = [t.clone() for t in bufs_k + ([hk] if hk is not
                                                            None else [])]
                    ops.fused_adam(*bufs_k, g0, ss, inv, *args, half=hk,
                                   noop=torch.ones((), device=dev))
                    after = bufs_k + ([hk] if hk is not None else [])
                    assert all(torch.equal(u, w) for u, w in
                               zip(before, after)), "adam no-op wrote"
        log(f"[kernels] n={n}: scale, axpby, l2norm, adam (12 variants + "
            f"no-op) agree with the plain versions; max abs err {err}")

        if n != N_FULL:
            continue
        # timings at the main path's shapes
        out = torch.empty_like(x)
        hbuf = torch.empty(n, dtype=torch.bfloat16, device=dev)
        pk, mk, vk = p0.clone(), m0.clone(), v0.clone()
        pp, mp, vp = p0.clone(), m0.clone(), v0.clone()
        pl = p0.clone()
        pl.grad = g0.clone()
        lib_adam = torch.optim.Adam([pl], lr=1e-3, fused=True)
        timing = {
            "multi_tensor_scale": (
                8 * n,
                lambda: ops.multi_tensor_scale(x, s, out=out),
                lambda: mt._scale_plain(x, s, out),
                lambda: torch.mul(x, s)),
            "multi_tensor_axpby": (
                12 * n,
                lambda: ops.multi_tensor_axpby(a, b, x, y, 0, out=out),
                lambda: mt._axpby_plain(a, b, x, y, 0, out),
                lambda: torch.add(y, x, alpha=1.0 / 1024.0)),
            "multi_tensor_l2norm": (
                4 * n,
                lambda: ops.multi_tensor_l2norm(x),
                lambda: mt._l2norm_plain(x),
                lambda: torch.linalg.vector_norm(x)),
            "fused_adam": (
                30 * n,   # reads p m v g, writes p m v and the bf16 copy
                lambda: ops.fused_adam(pk, mk, vk, g0, ss, inv, 0.9, 0.999,
                                       1e-8, False, 0.0, half=hbuf,
                                       noop=zero),
                lambda: adam_mod._adam_plain(pp, mp, vp, g0, ss, inv, 0.9,
                                             0.999, 1e-8, False, 0.0, hbuf,
                                             zero),
                lib_adam.step),   # writes no half copy
        }
        for name, (nbytes, kern, plain, libcall) in timing.items():
            kms = time_ms(kern)
            pms = time_ms(plain)
            lms = time_ms(libcall)
            bound = nbytes / MEM_BYTES_PER_S * 1e3
            rows[name] = {"name": name, "route": "cuda",
                          "source": SOURCE[name], "replaces": REPLACES[name],
                          "launches": 0, "max_abs_err": err[name],
                          "ms": kms, "plain_ms": pms, "bound_ms": bound,
                          "bound_by": "bytes", "library_ms": lms,
                          "bytes": nbytes, "n": n}
            log(f"[kernels] {name} n={n}: kernel_ms {kms:.4f} bound_ms "
                f"{bound:.4f} ({nbytes} B at {MEM_BYTES_PER_S / 1e12} TB/s) "
                f"plain_ms {pms:.4f} library_ms {lms:.4f}")
        # the max over both lengths
        for name in rows:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            err[name])
    return rows


def _bn_shapes(image: int):
    """(C, H, W) of every BatchNorm input of ResNet-50 in forward order,
    read off one forward at batch 1 on the CPU (the plain versions)."""
    from apex_tpu_torch import models, nn
    model = models.resnet50(device="cpu",
                            generator=torch.Generator().manual_seed(SEED))
    shapes = []
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape[1:])))
    with torch.no_grad():
        model(torch.zeros(1, 3, image, image))
    assert len(shapes) == BN_LAYERS, f"{len(shapes)} BatchNorm layers"
    return shapes


def _bn_case(shape, dtype, seed):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev)

    x = (rnd(*shape) * 2.0 + 0.5).to(dtype)
    dy = rnd(*shape).to(dtype)
    inv = torch.rsqrt(torch.rand(C, generator=gen, device=dev) + 0.1 + 1e-5)
    return x, dy, rnd(C), inv, rnd(C), rnd(C)


def row_sum_ratio(sums: torch.Tensor, terms: torch.Tensor) -> float:
    """The largest error of fp32 row sums (N, C) of ``terms`` (N, C, H, W)
    against their fp64 sums, over f(hw) * 2**-24 * sum |term|: at most 1
    passes.  f(hw) = sqrt(hw), the probabilistic bound on the rounding
    error of a sum of hw terms, where hw >= 64; below that
    min(hw - 1, 8), which bounds every order of a sum of at most 9 terms
    and is the floor above.  A row whose terms are all 0 must sum to 0."""
    hw = terms.shape[2] * terms.shape[3]
    t = terms.double()
    err = (sums.double() - t.sum(dim=(2, 3))).abs()
    f = min(hw - 1, max(math.sqrt(hw), 8.0))
    bound = f * 2.0 ** -24 * t.abs().sum(dim=(2, 3))
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, math.inf, 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def _bn_check(shape, dtype, seed):
    """syncbn kernels against the plain versions: y and dx bitwise; the row
    sums of the kernel and of the plain version each within the bound of
    ``row_sum_ratio`` of the fp64 sums.  Returns the inputs, the max abs
    errors against the plain versions and the two sums' worst ratios."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import syncbn as sbn
    x, dy, mean, inv, w, b = _bn_case(shape, dtype, seed)
    y, yp = ops.syncbn_fwd(x, mean, inv, w, b), sbn._fwd_plain(x, mean, inv,
                                                                w, b)
    assert same(y, yp), f"syncbn_fwd {shape} {dtype}: kernel != plain"
    got, want = ops.syncbn_bwd(dy, x, mean, inv, w), sbn._bwd_plain(
        dy, x, mean, inv, w)
    assert same(got[0], want[0]), f"syncbn_bwd dx {shape} {dtype}"
    d = dy.float()
    xhat = (x.float() - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    ratios = {"kernel": 0.0, "plain": 0.0}
    for k, terms in ((1, d), (2, d * xhat)):
        for who, sums in (("kernel", got[k]), ("plain", want[k])):
            r = row_sum_ratio(sums, terms)
            assert r <= 1.0, (f"syncbn_bwd row sums {k} ({who}) {shape} "
                              f"{dtype}: {r} of the bound")
            ratios[who] = max(ratios[who], r)
    errs = (max_abs(y, yp), max(max_abs(g, p) for g, p in zip(got, want)))
    return (x, dy, mean, inv, w, b), errs, ratios


def _lib_bn_bwd(dy, x, mean, inv, w, count):
    """PyTorch's own SyncBatchNorm backward: the per-channel reduce, then
    the elementwise dx (which also folds in the statistics' terms)."""
    sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(dy, x, mean, inv, w,
                                                       True, True, True)
    return torch.batch_norm_backward_elemt(dy, x, mean, inv, w, sdy, sdyx,
                                           count)


def phase_syncbn():
    """syncbn forward and backward at every BatchNorm shape of ResNet-50 at
    batch BATCH (bf16, as O2 runs them) and at odd shapes (fp32, bf16 and
    fp16).  Each time is one training step's: the sum over the 53 layers
    of the device time at each layer's shape (``graph_ms``), and of one
    eager call's time (``call_ms``, host time included)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import syncbn as sbn
    per_layer = Counter(_bn_shapes(IMAGE))
    err = {"syncbn_fwd": 0.0, "syncbn_bwd": 0.0}
    ratios = {"kernel": 0.0, "plain": 0.0}

    def note(errs, rat):
        err["syncbn_fwd"] = max(err["syncbn_fwd"], errs[0])
        err["syncbn_bwd"] = max(err["syncbn_bwd"], errs[1])
        for who in ratios:
            ratios[who] = max(ratios[who], rat[who])

    for i, shape in enumerate(BN_ODD):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            note(*_bn_check(shape, dtype, SEED + 10 + i)[1:])
    log(f"[kernels] syncbn at odd shapes {BN_ODD} in fp32/bf16/fp16: y and "
        f"dx bitwise, row sums within the bound (worst error over "
        f"f(hw)*2^-24*sum|term| against fp64: {ratios})")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "call_ms": 0.0,
               "bytes": 0} for k in err}
    for i, ((C, H, W), layers) in enumerate(sorted(per_layer.items())):
        shape = (BATCH, C, H, W)
        (x, dy, mean, inv, w, b), errs, rat = _bn_check(
            shape, torch.bfloat16, SEED + 20 + i)
        note(errs, rat)
        log(f"[kernels] syncbn_bwd {shape} bf16 row sums: worst error over "
            f"the bound, kernel {rat['kernel']:.3e}, plain "
            f"{rat['plain']:.3e}")
        n, isz = x.numel(), x.element_size()
        count = torch.full((1,), BATCH * H * W, dtype=torch.int32,
                           device=x.device)
        timing = {
            # reads x and four per-channel vectors, writes y
            "syncbn_fwd": (
                2 * n * isz + 4 * C * 4,
                lambda: ops.syncbn_fwd(x, mean, inv, w, b),
                lambda: sbn._fwd_plain(x, mean, inv, w, b),
                lambda: torch.batch_norm_elemt(x, w, b, mean, inv, 1e-5)),
            # reads dy, x and three vectors, writes dx and two row sums
            "syncbn_bwd": (
                3 * n * isz + 3 * C * 4 + 2 * BATCH * C * 4,
                lambda: ops.syncbn_bwd(dy, x, mean, inv, w),
                lambda: sbn._bwd_plain(dy, x, mean, inv, w),
                lambda: _lib_bn_bwd(dy, x, mean, inv, w, count)),
        }
        for name, (nbytes, kern, plain, libcall) in timing.items():
            kms, pms, lms = graph_ms(kern), graph_ms(plain), graph_ms(libcall)
            cms = time_ms(kern)
            t = tot[name]
            t["ms"] += layers * kms
            t["plain_ms"] += layers * pms
            t["library_ms"] += layers * lms
            t["call_ms"] += layers * cms
            t["bytes"] += layers * nbytes
            log(f"[kernels] {name} {shape} bf16 x{layers} layers: kernel_ms "
                f"{kms:.4f} bound_ms {nbytes / MEM_BYTES_PER_S * 1e3:.4f} "
                f"plain_ms {pms:.4f} library_ms {lms:.4f} (device time, "
                f"graph replay); one eager call {cms:.4f}")
        del x, dy
    rows = {}
    for name, t in tot.items():
        bound = t["bytes"] / MEM_BYTES_PER_S * 1e3
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": bound,
                      "bound_by": "bytes", "library_ms": t["library_ms"],
                      "call_ms": t["call_ms"], "bytes": t["bytes"],
                      "per": f"training step: {BN_LAYERS} BatchNorm layers "
                             f"of ResNet-50 at batch {BATCH}, bf16"}
        log(f"[kernels] {name} per step ({BN_LAYERS} layers, "
            f"{len(per_layer)} shapes): kernel_ms {t['ms']:.4f} bound_ms "
            f"{bound:.4f} ({t['bytes']} B) plain_ms {t['plain_ms']:.4f} "
            f"library_ms {t['library_ms']:.4f} (device time); eager calls "
            f"{t['call_ms']:.4f}; max abs err {err[name]}")
    rows["syncbn_bwd"]["row_sum_bound_ratio"] = ratios
    log(f"[kernels] syncbn_bwd row sums, all shapes: worst error against "
        f"the fp64 sums over f(hw)*2^-24*sum|term|: kernel "
        f"{ratios['kernel']:.3e}, plain {ratios['plain']:.3e} (<= 1 passes)")
    return rows


# -- phase 4 -----------------------------------------------------------------

def _train_step(model, opt, x, y, micro: int = 1):
    from apex_tpu_torch import amp
    from apex_tpu_torch.nn.functional import cross_entropy
    losses = []
    for xb, yb in zip(x.chunk(micro), y.chunk(micro)):
        loss = cross_entropy(model(xb), yb)
        with amp.scale_loss(loss, opt, delay_unscale=False) as scaled:
            scaled.backward()
        losses.append(loss.detach())
    opt.step()
    opt.zero_grad()
    return torch.stack(losses).mean()


def _batch(rs, batch, hw, classes, device):
    x = torch.from_numpy(rs.randn(batch, 3, hw, hw).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, classes, batch).astype(np.int64))
    return x.to(device), y.to(device)


def _drive(model, opt, tag: str, smi: str):
    """A path's run: 12 steps at batch BATCH (the last 10 timed), then two
    steps of two micro-batches (axpby), with the launch counts set to 0
    just before and read just after; then three steps profiled."""
    from apex_tpu_torch import ops
    x, y = _batch(np.random.RandomState(SEED), BATCH, IMAGE, 1000, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                       # the path starts
    losses, step_ms = [], []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_train_step(model, opt, x, y))
        torch.cuda.synchronize()
        if i >= 2:                                  # 2 warm-up steps
            step_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(2):                              # two micro-batches of 64
        losses.append(_train_step(model, opt, x, y, micro=2))
    torch.cuda.synchronize()
    counts = ops.launch_counts()                    # the path ends

    vals = [float(l) for l in losses]
    peak = torch.cuda.max_memory_allocated()
    steps_done = int(opt.state.step)
    assert all(math.isfinite(v) for v in vals), f"non-finite loss {vals}"
    assert vals[11] < vals[0], f"loss did not fall: {vals}"
    assert steps_done == 14, f"Adam applied {steps_done} steps, expected 14"
    med = statistics.median(step_ms)
    log(f"[{tag}] batch {BATCH} 3x{IMAGE}x{IMAGE} on {smi}: losses "
        f"{['%.4f' % v for v in vals]}")
    log(f"[{tag}] step_ms median {med:.2f} over {len(step_ms)} steps "
        f"(all: {['%.2f' % t for t in step_ms]}), images/s "
        f"{BATCH / med * 1e3:.1f}, max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB), grad_norm "
        f"{float(opt.last_info['grad_norm']):.4f}")
    by_cat = phase_profile(model, opt, x, y, med, tag=f"{tag}-profile")
    return counts, steps_done, {"step_ms": med, "images_per_s":
                                BATCH / med * 1e3, "peak_bytes": peak,
                                "losses": vals, "profile_ms": by_cat}


def phase_train(smi):
    """The single-card path: ResNet-50 -> O2 + FusedAdam."""
    from apex_tpu_torch import amp, models, optimizers
    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(SEED))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    log("[train] resnet50 O2 FusedAdam, one card")
    out = _drive(model, opt, "train", smi)
    del model, opt
    torch.cuda.empty_cache()
    return out


# -- phase 5 -----------------------------------------------------------------

def phase_ddp(smi):
    """The data-parallel path on a one-rank group: ResNet-50 ->
    convert_syncbn_model -> O2 + FusedAdam -> DistributedDataParallel."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    try:
        backend = dist.get_backend()
        assert backend == ("nccl" if DEVICE == "cuda" else "gloo"), backend
        model = models.resnet50(device=DEVICE,
                                generator=torch.Generator().manual_seed(SEED))
        model = parallel.convert_syncbn_model(model)
        n_sync = sum(isinstance(m, parallel.SyncBatchNorm)
                     for m in model.modules())
        assert n_sync == BN_LAYERS, f"{n_sync} SyncBatchNorm layers"
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                    opt_level="O2", verbosity=0)
        before = opt.masters.buf.clone()
        ddp = parallel.DistributedDataParallel(model)
        m = opt.masters
        # the broadcast went through the masters: rank 0's fp32 values
        # (one rank: unchanged) and a half copy derived from them
        assert torch.equal(m.buf, before), "broadcast changed the masters"
        assert torch.equal(m.half, m.buf.to(m.half.dtype)), \
            "half copy and masters disagree after the broadcast"
        log(f"[ddp] {backend} group of {dist.get_world_size()}: resnet50 -> "
            f"convert_syncbn_model ({n_sync} SyncBatchNorm) -> O2 FusedAdam "
            f"-> DistributedDataParallel; broadcast left masters and half "
            f"copy consistent")
        out = _drive(ddp, opt, "ddp", smi)
        log(f"[ddp] buckets of the last all-reduce: {ddp.last_comm_stats}")
        del model, opt, ddp
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


_PORT_KERNELS = ("scale_kernel", "axpby_kernel", "l2norm_", "adam_kernel")
_PORT_BN = ("bn_fwd_kernel", "bn_bwd_rows_kernel")
_LIBRARY_MATH = ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad",
                 "fprop", "implicit")


def _category(kernel: str) -> str:
    k = kernel.lower()
    if any(p in k for p in _PORT_BN):
        return "port BatchNorm apply kernels (syncbn fwd, bwd)"
    if "nccl" in k:
        return "collectives (NCCL)"
    if any(p in k for p in _PORT_KERNELS):
        return "port optimizer kernels"
    if any(p in k for p in _LIBRARY_MATH):
        return "convolution and matmul (cuDNN, cuBLAS)"
    if "reduce" in k:
        return "reductions (BN statistics, loss, grad sums)"
    if "catarray" in k:
        return "grad packing (cat)"
    return "elementwise and other (BN statistics' casts, ReLU, adds)"


def phase_profile(model, opt, x, y, step_ms: float, tag: str = "profile",
                  steps: int = 3):
    """Device time of a path's steps by kernel (torch.profiler), after the
    launch counts were read: where the time goes, and how much of the
    unprofiled step the device is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _train_step(model, opt, x, y)
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.key_averages():
        # the kernels themselves: the operators that launch them carry
        # the same device time again
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + us / 1e3
    device_ms = sum(per_kernel.values()) / steps
    if device_ms == 0:
        log(f"[{tag}] torch.profiler recorded no device time: not measured")
        return None
    by_cat = {}
    for name, ms in per_kernel.items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms / steps
    log(f"[{tag}] device ms per step {device_ms:.3f} of step_ms "
        f"{step_ms:.3f}: busy share {device_ms / step_ms:.4f}, idle share "
        f"{1 - device_ms / step_ms:.4f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {ms:9.3f} ms  {ms / device_ms:7.2%}  {cat}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        log(f"[{tag}]   kernel {ms / steps:8.3f} ms/step  {name[:100]}")
    # the host side: self CPU time of the operators (inflated by the
    # profiler's own cost, so read as shares) and device launches a step
    host, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            launches += evt.count
        elif evt.self_cpu_time_total > 0:
            host[evt.key] = (evt.self_cpu_time_total / 1e3, evt.count)
    host_ms = sum(ms for ms, _ in host.values()) / steps
    log(f"[{tag}] host: {host_ms:.3f} ms/step of operator self CPU time "
        f"under the profiler, {launches / steps:.0f} device launches a step")
    for name, (ms, n) in sorted(host.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag}]   host {ms / steps:8.3f} ms/step {n / steps:6.0f} "
            f"calls/step  {name[:80]}")
    log(f"{tag} " + json.dumps({"device_ms_per_step": device_ms,
                                "step_ms": step_ms, "by_category": by_cat,
                                "host_ms_per_step": host_ms,
                                "launches_per_step": launches / steps}))
    return by_cat


def phase_reference():
    """A small ResNet trained three steps in fp32 (O0) on the card and on
    the CPU (the plain versions), from the same weights and batch."""
    from apex_tpu_torch import amp, models, optimizers

    runs = {}
    for dev in (DEVICE, "cpu"):
        model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                              device=dev,
                              generator=torch.Generator().manual_seed(SEED))
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                    opt_level="O0", verbosity=0)
        x, y = _batch(np.random.RandomState(SEED + 1), 8, 32, 10, dev)
        losses = [float(_train_step(model, opt, x, y)) for _ in range(3)]
        runs[dev] = (losses, opt.masters.buf.cpu())
    (lc, mc), (lp, mp) = runs[DEVICE], runs["cpu"]
    # fp32 on both; cuDNN's and the CPU's convolutions sum in other orders
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    # Adam moves each weight by about lr per step, so a sign flip of a
    # near-zero grad costs up to 2*lr per step
    dmax = float((mc - mp).abs().max())
    assert rel < 1e-4, f"card vs CPU losses {lc} vs {lp}"
    assert dmax <= 2 * 1e-4 * 3, f"card vs CPU masters differ by {dmax}"
    log(f"[reference] O0 small ResNet, card vs CPU: losses {lc} vs {lp} "
        f"(max rel {rel:.2e} <= 1e-4), masters max abs diff {dmax:.2e} "
        f"(<= 2*lr*steps = 6e-4)")


# -- phase 6 -----------------------------------------------------------------

def phase_overflow():
    from apex_tpu_torch import amp, models, optimizers

    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(SEED + 1))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", half_dtype="float16",
                                verbosity=0)
    assert opt.scaler.dynamic, "fp16 O2 must scale dynamically"
    x, y = _batch(np.random.RandomState(SEED + 2), OVERFLOW_BATCH, IMAGE,
                  1000, DEVICE)
    for _ in range(8):       # until a step is applied: m, v become non-zero
        _train_step(model, opt, x, y)
        if int(opt.state.step) > 0:
            break
    before = {"masters": opt.masters.buf.clone(), "half": opt.masters.half
              .clone(), "m": opt.state.m.clone(), "v": opt.state.v.clone(),
              "step": opt.state.step.clone()}
    scale0 = float(opt.loss_scale())
    x[0, 0, 0, 0] = float("inf")
    loss = _train_step(model, opt, x, y)
    scale1 = float(opt.loss_scale())
    after = {"masters": opt.masters.buf, "half": opt.masters.half,
             "m": opt.state.m, "v": opt.state.v, "step": opt.state.step}
    assert not math.isfinite(float(loss)), "the planted inf did not overflow"
    assert float(opt.last_info["found_inf"]) == 1.0
    assert scale1 == scale0 / 2, f"loss scale {scale0} -> {scale1}"
    for k in before:
        assert torch.equal(before[k], after[k]), f"{k} changed on a skip"
    log(f"[overflow] fp16 dynamic: loss {float(loss)}, loss scale {scale0} "
        f"-> {scale1}, masters/half/m/v/step bitwise unchanged "
        f"(step {int(after['step'])})")


def _check_counts(tag: str, counts, steps_done: int) -> None:
    """Every kernel launched on the path; Adam once per applied step; the
    syncbn kernels once per BatchNorm layer and pass (12 whole batches and
    two steps of two micro-batches: 16 passes)."""
    log(f"kernels {tag} {json.dumps(counts)}")
    for k, c in counts.items():
        assert c > 0, f"{k} was not launched on the {tag} path"
    assert counts["fused_adam"] == steps_done, \
        f"Adam launched {counts['fused_adam']} times for {steps_done} steps"
    for k in ("syncbn_fwd", "syncbn_bwd"):
        assert counts[k] == BN_LAYERS * 16, f"{k}: {counts[k]} launches"


def main():
    name, smi = phase_device()
    import apex_tpu_torch  # noqa: F401  (fails outside the repository)
    phase_build()
    rows = phase_kernels()
    rows.update(phase_syncbn())
    counts1, steps1, train = phase_train(smi)
    phase_reference()
    counts, steps_done, ddp = phase_ddp(smi)
    phase_overflow()

    _check_counts("train", counts1, steps1)
    _check_counts("ddp", counts, steps_done)
    for k in rows:
        rows[k]["launches"] = counts[k]
    log(json.dumps({"train": train, "ddp": ddp, "card": smi}))
    log(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
