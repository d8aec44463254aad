#!/usr/bin/env python3
"""Smoke run of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --captured
    python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT

The second form runs phases 1, 2 and 15 alone.  The third builds the
kernels and times the LayerNorm backward of this checkout against the one
in PARENT_CHECKOUT (another tree of this repository), at BERT-base's and
BERT-large's shapes, by graph replay in the order parent, change, change,
parent, with each one's device time by kernel and this backward at other
grids; it runs nothing else.

Phases, in order; any failure raises and the exit code is non-zero:

1. device   the card's name and power limit; TF32 off for matmul and cuDNN.
2. build    nvcc builds every kernel of ops/csrc from the checkout.
3. kernels  each kernel against its plain PyTorch version on the card, with
            device times by CUDA-graph replay (kernel, plain version,
            nearest library call; one eager call beside them as call_ms)
            and the bound (bytes over the card's memory rate, or operations
            over its bf16 tensor-core rate, whichever is longer): scale, axpby,
            l2norm and Adam at ResNet-50's flat length (25,557,032) and an
            odd length; the syncbn forward and backward at every BatchNorm
            shape of ResNet-50 at batch 128 in bf16 and fp16 (y and dx
            bitwise; the row sums within f(hw)*2^-24*sum|term| of their
            fp64 sums) and at odd
            shapes, timed as one training step's 53 layers; the LayerNorm
            forward and backward at BERT-base's (4096, 768) and
            BERT-large's (1024, 1024) bf16, at odd shapes and on views off
            16 bytes (the backward the same bits on a second launch and on
            graph replays; its device time split by kernel; the
            registers, spills and shared bytes of its kernels), and the
            flash forward, dQ and dK/dV at BERT-base's
            (32, 12, 128, 64) in bf16 and fp16 (all three on tensor
            cores) in every variant (causal, key padding, segments,
            dropout), at T = 512, at D = 128 with 16 heads and at odd
            shapes (also fp32, the FMA kernels), each output held against
            an fp64 evaluation within a stated bound and each kernel
            launched twice, bitwise; the dropout mask shown to be the
            hash's (q = k = 0, V = identity) in fp32, bf16 and fp16, with
            and without the causal mask; the flash kernels' registers,
            spills and resident blocks an SM;
            the LAMB stage 1 and stage 2 at BERT-large's flat length
            (336,195,586, its 301 tensors, the weights of the model) and
            an odd length, bitwise, with the no-op flag set and clear, and
            the per-tensor l2norm on BERT-large's tensors and a ragged
            list (rtol 1e-6).
4. train    the single-card ResNet path: ResNet-50 under amp O2 + FusedAdam
            at batch 128, 3x224x224, then two steps of two micro-batches
            (axpby); the device time of three more steps by kernel
            (torch.profiler); and a small ResNet trained on the card
            against the same run on the CPU (plain versions), in fp32.
5. ddp      the data-parallel path on a one-rank NCCL group: ResNet-50 ->
            convert_syncbn_model -> O2 + FusedAdam -> DistributedDataParallel
            at batch 128, 12 steps and two of two micro-batches, the
            rank-0 broadcast checked, and three steps profiled.
6. bert     the BERT path: BertForPretraining(bert_base()) -> O2 +
            FusedAdam(lr=1e-4), MLM + NSP loss in train mode (dropout 0.1,
            so the flash kernels' dropout runs) at 32 x 128 tokens, 12
            steps and two of two micro-batches, three steps profiled; and
            a tiny BERT trained on the card against the CPU, in fp32, with
            FusedAdam and with FusedLAMB.
7. bert-large  the BERT-large path on a one-rank NCCL group:
            BertForPretraining(bert_large()) -> O2 + FusedLAMB(lr=1e-3) ->
            DistributedDataParallel, MLM + NSP in train mode (dropout 0.1)
            at 8 x 128 tokens, 12 steps and two of two micro-batches,
            three steps profiled.
8. overflow one fp16 step with an inf in the input, under FusedAdam and
            under FusedLAMB: the loss scale halves and masters, half copy,
            m, v and the step counter stay bitwise.
9. bert-o1  the BERT path under amp O1 (after every O2 phase, which run
            under no cast policy): BertForPretraining(bert_base()) -> O1 +
            FusedAdam(lr=1e-4), bf16, as phase 6; fp32 params with no
            masters, and a probe forward showing the LayerNorms receive
            fp32 and attention bf16 q/k/v.
10. resnet-o1  ResNet-50 -> O1 + FusedAdam(lr=1e-3) in fp16 with the
            dynamic loss scale from 2**16, batch 128, as phase 4; steps
            applied + skipped = 14; amp_stats printed.
11. resume  that model and optimizer saved through torch.save (model,
            optimizer and amp state dicts), loaded into a fresh pair:
            every tensor bitwise, then one more step on each with the
            same overflow flag and scaler and losses within 1e-6.
12. counts  (checked last, after 13, 14 and 15) each path launched each
            of its kernels exactly as often as it
            runs it (per step, per BatchNorm, LayerNorm or attention layer
            and pass) and no kernel of another path; phase 13's runs too
            (zero syncbn launches on the NHWC models), and phase 15's
            captured steps (the launches of one step recorded at capture,
            times the steps its replays ran, plus the eager warm-up's).
13. imagenet  the port's user entry point, examples/imagenet/
            main_amp_torch.main(argv), in process at batch 128, 3x224x224,
            O2, its step the functional one captured in a CUDA graph (two
            warm-up steps: eager, then the capture; the --prof trace sees
            the replayed kernels but no launching operator for them):
            (a) resnet50 + FusedAdam, NCHW, 20 iterations; (b) the same
            channels-last with the space-to-depth stem; (c) resnet34, 101
            and 152 with SGD, 5 iterations; (d) a uint8 NHWC blob of 256
            images (38.5 MB) through the native DataLoader, channels-last,
            10 iterations; (e) resnet18 checkpointed over two epochs of 3
            iterations, then resumed into the space-to-depth stem (its
            first-batch logits the conv7 model's: within 1e-5 in fp32, and
            under O2 within twice the conv7 model's own move under a
            one-ulp input move).
            Each prints img/s, step_ms and peak memory less the floor; (a)
            and (b) also device time by category and the ten kernels that
            take the most, from a chrome trace the example's --prof window
            writes over two more steps.
14. l1      tests/L1/run_l1_torch.py's matrix on the card: ResNet-18 at
            batch 16, 32x32, 50 iterations, under the 48 amp configs, each
            run twice and bitwise the same (trajectory and parameter
            digest), finite and falling; the 12 O0 configs also on the CPU
            for 10 steps, the first three losses within 1e-3 and all
            within twice the card's own move under a one-ulp input move.
15. captured  the functional step (amp.scaled_grad or scaled_grad_accum,
            ddp.allreduce_grads(grads), optimizer.step(grads)) through
            make_step, captured whole in a CUDA graph, with cuDNN
            deterministic: (a) ResNet-50 -> convert_syncbn_model -> O2 +
            FusedAdam -> DistributedDataParallel (one-rank NCCL group) at
            batch 128, 3x224x224, steps_per_call 1 and 4; (b) BERT-base O2 +
            FusedAdam at 32 x 128, dropout 0.1, as two micro-batches of 16
            (scaled_grad_accum); (c) BERT-large O2 + FusedLAMB + DDP at 8 x
            128, dropout 0.1.  On each, from one state, the step run
            eagerly and through the graph: losses, every state tensor
            (masters, half copy, moments, step counter, scaler, BatchNorm
            statistics) and the dropout generator's offset bitwise after 8
            steps (12 for K = 4); step_ms eager against graph, the graph's
            device time (torch.profiler, and one replay between CUDA
            events), idle share, launches a step, peak memory above the
            state and what the graph holds.  Then fp16 ResNet-50 O2 at
            batch 32: an inf in the input of a replay skips the step (scale
            halved, masters, half copy, m, v and step bitwise) and the next
            replay scales by the halved scale.

Phase 3 also times the variants the O1 paths run: Adam without the half
copy at N = 25,557,032, the LayerNorm forward and backward in fp32 at
(4096, 768), the syncbn forward and backward in fp16 at ResNet-50's
BatchNorm shapes; they print as the "kernels_o1" line.  The last lines are the
kernels' JSON record, the card's name and power limit as nvidia-smi gives
them, and {"ok": true, "device": {...}}.  It
imports torch, numpy and apex_tpu_torch, and needs the repository
beside it.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import time
from collections import Counter
from pathlib import Path

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
    "layer_norm_fwd": "apex_tpu/ops/pallas_layer_norm.py:42",
    "layer_norm_bwd": "apex_tpu/ops/pallas_layer_norm.py:100",
    "flash_fwd": "apex_tpu/ops/pallas_flash_attention.py:154",
    "flash_dq": "apex_tpu/ops/pallas_flash_attention.py:293",
    "flash_dkv": "apex_tpu/ops/pallas_flash_attention.py:351",
    "lamb_stage1": "apex_tpu/ops/pallas_lamb.py:30",
    "lamb_stage2": "apex_tpu/ops/pallas_lamb.py:84",
    # the per-tensor branch of the l2norm (jnp there: ChunkedFlatLayout.
    # per_tensor_sqsum, apex_tpu/multi_tensor_apply/flatten.py:210)
    "multi_tensor_l2norm_per_tensor":
        "apex_tpu/ops/pallas_multi_tensor.py:172",
}
SOURCE = {
    "multi_tensor_scale": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "multi_tensor_axpby": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "multi_tensor_l2norm": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
    "fused_adam": "apex_tpu_torch/ops/csrc/adam.cu",
    "syncbn_fwd": "apex_tpu_torch/ops/csrc/syncbn.cu",
    "syncbn_bwd": "apex_tpu_torch/ops/csrc/syncbn.cu",
    "layer_norm_fwd": "apex_tpu_torch/ops/csrc/layer_norm.cu",
    "layer_norm_bwd": "apex_tpu_torch/ops/csrc/layer_norm.cu",
    "flash_fwd": "apex_tpu_torch/ops/csrc/flash_attention.cu",
    "flash_dq": "apex_tpu_torch/ops/csrc/flash_attention.cu",
    "flash_dkv": "apex_tpu_torch/ops/csrc/flash_attention.cu",
    "lamb_stage1": "apex_tpu_torch/ops/csrc/lamb.cu",
    "lamb_stage2": "apex_tpu_torch/ops/csrc/lamb.cu",
    "multi_tensor_l2norm_per_tensor": "apex_tpu_torch/ops/csrc/multi_tensor.cu",
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
    """Every library, and flash_attention.cu once more without the dK/dV
    kernel's register cap (``-DAPEX_FLASH_DKV_BLOCKS=1``), one ``nvcc``
    each, all started together; returns the uncapped library and
    ``nvcc``'s output by source (``-Xptxas -v``)."""
    from apex_tpu_torch.ops import _build
    t0 = time.time()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    uncapped = _build.BUILD_DIR / "libflash_attention-uncapped.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DAPEX_FLASH_DKV_BLOCKS=1",
         "-o", str(uncapped), str(_build.CSRC / "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = _build.build_all()
    finally:
        out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the uncapped build:\n{out}")
    secs = time.time() - t0
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {src}.cu: {line.strip()}")
    log(f"[build] {sorted(logs)} and flash_attention.cu uncapped built in "
        f"{secs:.2f} s")
    return _build._load("flash_attention", uncapped), logs


def ptxas_resources(text: str) -> dict:
    """Registers, spill bytes and static shared bytes a thread of each
    kernel in ``nvcc -Xptxas -v`` output, by mangled name."""
    res, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            res[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                         "smem_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            res[name]["spill_stores"] = int(m.group(1))
            res[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            res[name]["smem_bytes"] = int(m.group(1)) if m else 0
    return res


_TYPE = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}


def kernel_short(mangled: str) -> str:
    """``ln_bwd_vec_kernel<bf16,4>`` (and ``ln_fwd_kernel<bf16,3,vec>``,
    ``...,elem,wide>`` for the forward's two flags) from the mangled name
    of a LayerNorm kernel in its anonymous namespace
    (``_ZN12_GLOBAL__N_1...``)."""
    m = re.search(r"\d+(ln_\w*?kernel)(?:I(f|13__nv_bfloat16|6__half)"
                  r"(?:Li(\d+)E)?((?:Lb[01]E)*)E)?", mangled)
    if not m:
        return mangled
    args = [a for a in (_TYPE.get(m.group(2) or ""), m.group(3)) if a]
    flags = re.findall(r"Lb([01])E", m.group(4) or "")
    if len(flags) == 2:
        args += ["vec" if flags[0] == "1" else "elem"]
        args += ["wide"] if flags[1] == "1" else []
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


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
        err = dict.fromkeys(OPT_COUNTS, 0.0)

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
        # capturable: its step count stays on the card, so graph_ms can
        # capture the step (a non-capturable fused Adam refuses capture)
        lib_adam = torch.optim.Adam([pl], lr=1e-3, fused=True,
                                    capturable=True)
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
        # O1 runs Adam on fp32 params: no half copy (reads p m v g,
        # writes p m v)
        timing["fused_adam:no_half"] = (
            28 * n,
            lambda: ops.fused_adam(pk, mk, vk, g0, ss, inv, 0.9, 0.999, 1e-8,
                                   False, 0.0, half=None, noop=zero),
            lambda: adam_mod._adam_plain(pp, mp, vp, g0, ss, inv, 0.9, 0.999,
                                         1e-8, False, 0.0, None, zero),
            lib_adam.step)
        # device time by graph replay; the one eager call (host time
        # included) beside it as call_ms
        for key, (nbytes, kern, plain, libcall) in timing.items():
            name = key.split(":")[0]
            kms, pms, lms = graph_ms(kern), graph_ms(plain), graph_ms(libcall)
            bound = nbytes / MEM_BYTES_PER_S * 1e3
            rows[key] = {"name": name, "route": "cuda",
                         "source": SOURCE[name], "replaces": REPLACES[name],
                         "launches": 0, "max_abs_err": err[name],
                         "ms": kms, "plain_ms": pms, "bound_ms": bound,
                         "bound_by": "bytes", "library_ms": lms,
                         "call_ms": time_ms(kern), "bytes": nbytes, "n": n}
            log(f"[kernels] {key} n={n}: kernel_ms {kms:.4f} bound_ms "
                f"{bound:.4f} ({nbytes} B at {MEM_BYTES_PER_S / 1e12} TB/s) "
                f"plain_ms {pms:.4f} library_ms {lms:.4f} (device time, "
                f"graph replay); one eager call {rows[key]['call_ms']:.4f}")
        # the max over both lengths
        for key, row in rows.items():
            row["max_abs_err"] = max(row["max_abs_err"], err[row["name"]])
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
    batch BATCH, in bf16 (as O2 runs them) and in fp16 (as O1 with
    half_dtype float16 runs them, the "syncbn_*:fp16" rows), and at odd
    shapes (fp32, bf16 and fp16).  Each time is one training step's: the
    sum over the 53 layers of the device time at each layer's shape
    (``graph_ms``), and of one eager call's time (``call_ms``, host time
    included)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import syncbn as sbn
    per_layer = Counter(_bn_shapes(IMAGE))
    tags = {torch.bfloat16: "", torch.float16: ":fp16"}
    err = {f"{k}{t}": 0.0 for t in tags.values()
           for k in ("syncbn_fwd", "syncbn_bwd")}
    ratios = {"kernel": 0.0, "plain": 0.0}

    def note(errs, rat, tag=""):
        err["syncbn_fwd" + tag] = max(err["syncbn_fwd" + tag], errs[0])
        err["syncbn_bwd" + tag] = max(err["syncbn_bwd" + tag], errs[1])
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
        for j, (dtype, tag) in enumerate(tags.items()):
            dname = str(dtype).replace("torch.", "")
            (x, dy, mean, inv, w, b), errs, rat = _bn_check(
                shape, dtype, SEED + 20 + i + 100 * j)
            note(errs, rat, tag)
            log(f"[kernels] syncbn_bwd {shape} {dname} row sums: worst "
                f"error over the bound, kernel {rat['kernel']:.3e}, plain "
                f"{rat['plain']:.3e}")
            n, isz = x.numel(), x.element_size()
            count = torch.full((1,), BATCH * H * W, dtype=torch.int32,
                               device=x.device)
            timing = {
                # reads x and four per-channel vectors, writes y
                "syncbn_fwd" + tag: (
                    2 * n * isz + 4 * C * 4,
                    lambda: ops.syncbn_fwd(x, mean, inv, w, b),
                    lambda: sbn._fwd_plain(x, mean, inv, w, b),
                    lambda: torch.batch_norm_elemt(x, w, b, mean, inv,
                                                   1e-5)),
                # reads dy, x and three vectors, writes dx and two row sums
                "syncbn_bwd" + tag: (
                    3 * n * isz + 3 * C * 4 + 2 * BATCH * C * 4,
                    lambda: ops.syncbn_bwd(dy, x, mean, inv, w),
                    lambda: sbn._bwd_plain(dy, x, mean, inv, w),
                    lambda: _lib_bn_bwd(dy, x, mean, inv, w, count)),
            }
            for key, (nbytes, kern, plain, libcall) in timing.items():
                kms, pms = graph_ms(kern), graph_ms(plain)
                lms, cms = graph_ms(libcall), time_ms(kern)
                t = tot[key]
                t["ms"] += layers * kms
                t["plain_ms"] += layers * pms
                t["library_ms"] += layers * lms
                t["call_ms"] += layers * cms
                t["bytes"] += layers * nbytes
                log(f"[kernels] {key.split(':')[0]} {shape} {dname} "
                    f"x{layers} layers: kernel_ms {kms:.4f} bound_ms "
                    f"{nbytes / MEM_BYTES_PER_S * 1e3:.4f} plain_ms "
                    f"{pms:.4f} library_ms {lms:.4f} (device time, graph "
                    f"replay); one eager call {cms:.4f}")
            del x, dy
    rows = {}
    for key, t in tot.items():
        name = key.split(":")[0]
        dname = "fp16" if key.endswith(":fp16") else "bf16"
        bound = t["bytes"] / MEM_BYTES_PER_S * 1e3
        rows[key] = {"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": t["library_ms"],
                     "call_ms": t["call_ms"], "bytes": t["bytes"],
                     "per": f"training step: {BN_LAYERS} BatchNorm layers "
                            f"of ResNet-50 at batch {BATCH}, {dname}"}
        log(f"[kernels] {key} per step ({BN_LAYERS} layers, "
            f"{len(per_layer)} shapes, {dname}): kernel_ms {t['ms']:.4f} "
            f"bound_ms {bound:.4f} ({t['bytes']} B) plain_ms "
            f"{t['plain_ms']:.4f} library_ms {t['library_ms']:.4f} (device "
            f"time); eager calls {t['call_ms']:.4f}; max abs err {err[key]}")
    rows["syncbn_bwd"]["row_sum_bound_ratio"] = ratios
    log(f"[kernels] syncbn_bwd row sums, all shapes and types: worst error "
        f"against the fp64 sums over f(hw)*2^-24*sum|term|: kernel "
        f"{ratios['kernel']:.3e}, plain {ratios['plain']:.3e} (<= 1 passes)")
    return rows


# -- phase 3, LayerNorm and flash attention -----------------------------------

LN_ROWS, LN_WIDTH = 32 * 128, 768   # BERT-base at 32 x 128 tokens
LN_PER_PASS = 26                    # LayerNorms in one BERT-base pass
# the rows of the kernels' JSON line: BERT-base first (its launches), then
# BERT-large at 8 x 128 tokens
LN_SHAPES = ((LN_ROWS, LN_WIDTH), (8 * 128, 1024))
# odd shapes, the main paths' with a tail block (4097) and rows the
# forward holds a block a row (1500, 4096, 8192), in fp32, bf16 and fp16;
# the misaligned views take the element paths
LN_ODD = ((7, 1), (33, 100), (300, 1024), (9, 1500), (LN_ROWS, LN_WIDTH),
          (8 * 128, 1024), (4097, 768), (2048, 4096), (3, 8192))
LN_MISALIGNED = ((33, 104), (LN_ROWS, LN_WIDTH), (300, 1024), (3, 8192))
# a wide row (a NeoX-style hidden size): the forward's row "7 W", timed in
# phase 3 and in the A/B; no path of the port runs it yet
LN_WIDE = (2048, 4096)
FLASH_BASE = (32, 12, 128, 64)      # B, H, T, D of BERT-base at 32 x 128
FLASH_LONG = (8, 12, 512, 64)
FLASH_ODD = ((2, 3, 200, 64), (2, 3, 77, 128), (3, 2, 64, 24))
FLASH_WIDE = (2, 16, 128, 128)      # D = 128 at BERT-large's 16 heads
FLASH_LARGE = (8, 16, 128, 64)      # BERT-large at 8 x 128
FLASH_PER_PASS = 12                 # attention layers of BERT-base
FLASH_VARIANTS = {
    "none": {}, "causal": {"causal": True}, "kv_mask": {"kv_mask": True},
    "segments": {"segments": True}, "dropout": {"rate": 0.1},
    "all": {"causal": True, "kv_mask": True, "segments": True, "rate": 0.1}}
EPS32 = 2.0 ** -24
# a unit in the last place, relative: twice the largest error of one
# rounding to the type
UNIT = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
        torch.float16: 2.0 ** -10}
# half the spacing of the type's subnormals: the absolute error of one
# rounding of a tiny value (P or dS) to it
TINY = {torch.float32: 2.0 ** -150, torch.bfloat16: 2.0 ** -134,
        torch.float16: 2.0 ** -25}
# H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
BF16_FLOPS = 989e12


def worst_ratio(err: torch.Tensor, bound: torch.Tensor) -> float:
    """max(err / bound): at most 1 passes; where the bound is 0 the error
    must be 0."""
    r = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                    torch.where(err > 0, math.inf, 0.0))
    return float(r.max()) if r.numel() else 0.0


def _sum_f(n: int) -> float:
    """The rounding error of an fp32 sum of n terms, in units of 2^-24 of
    the sum of their magnitudes: sqrt(n) (the probabilistic bound), at
    least 8."""
    return max(math.sqrt(n), 8.0)


def _off16(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view one element past a fresh
    allocation: contiguous, but off 16 bytes."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _ln_case(n1, n2, dtype, seed, misaligned=False):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev)

    case = ((rnd(n1, n2) * 2.0 + 0.5).to(dtype), rnd(n1, n2).to(dtype),
            rnd(n2), rnd(n2))
    return tuple(map(_off16, case)) if misaligned else case


def graph_replays(fn, replays: int = 3):
    """``fn``'s outputs on each of ``replays`` replays of one CUDA graph
    that captured it (cloned after each replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    got = []
    for _ in range(replays):
        graph.replay()
        got.append([t.clone() for t in outs])
    torch.cuda.synchronize()
    del graph
    return got


def _ln_check(n1, n2, dtype, seed, eps=1e-12, misaligned=False):
    """LayerNorm kernels and plain versions, each against an fp64
    evaluation: mean within (f(n2)+1)*2^-24*mean|x|, inv within
    (f(n2)+8)*2^-24 relative, y and dx within one rounding to their type
    plus (f(n2)+8)*2^-24 of the magnitudes of their terms, dw and db within
    (f(n1)+4)*2^-24*sum|term|; forward and backward the same bits on a
    second launch and on three replays of a CUDA graph.  ``misaligned``:
    every input a view off 16 bytes (the element paths), the forward the
    same bits as on fresh (aligned) copies of the same values.  Returns
    the inputs, the max abs errors against the plain versions and the
    worst ratios to the bounds."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    x, dy, w, b = _ln_case(n1, n2, dtype, seed, misaligned)
    u, f, fr = UNIT[dtype], _sum_f(n2), _sum_f(n1)
    x64, dy64, w64, b64 = (t.double() for t in (x, dy, w, b))
    m64 = x64.mean(dim=1)
    d64 = x64 - m64[:, None]
    inv64 = ((d64 * d64).mean(dim=1) + eps).rsqrt()
    absx = x64.abs().mean(dim=1)
    xhat64 = d64 * inv64[:, None]
    y64 = xhat64 * w64 + b64
    y_bound = u * y64.abs() + (f + 8) * EPS32 * (
        xhat64.abs() * w64.abs() + w64.abs() * (inv64 * absx)[:, None]
        + b64.abs())
    fwd = {"kernel": ops.layer_norm_fwd(x, w, b, eps),
           "plain": lnm._fwd_plain(x, w, b, eps)}
    ratios = {}
    for who, (y, mean, inv) in fwd.items():
        ratios[who] = max(
            worst_ratio((mean.double() - m64).abs(),
                        (f + 1) * EPS32 * absx),
            worst_ratio((inv.double() - inv64).abs(),
                        (f + 8) * EPS32 * inv64),
            worst_ratio((y.double() - y64).abs(), y_bound))
    # the backward from the plain statistics (what the kernel is handed)
    _, mean, inv = fwd["plain"]
    mu, iv = mean.double()[:, None], inv.double()[:, None]
    xh = (x64 - mu) * iv
    g = dy64 * w64
    c1 = g.mean(dim=1, keepdim=True)
    c2 = (g * xh).mean(dim=1, keepdim=True)
    dx64 = iv * ((g - c1) - xh * c2)
    dx_bound = u * dx64.abs() + (f + 8) * EPS32 * iv * (
        g.abs() + g.abs().mean(dim=1, keepdim=True)
        + xh.abs() * (g * xh).abs().mean(dim=1, keepdim=True))
    bwd = {"kernel": ops.layer_norm_bwd(dy, x, w, mean, inv),
           "plain": lnm._bwd_plain(dy, x, w, mean, inv)}
    for who, (dx, dw, db) in bwd.items():
        ratios[who] = max(
            ratios[who], worst_ratio((dx.double() - dx64).abs(), dx_bound),
            worst_ratio((dw.double() - (dy64 * xh).sum(dim=0)).abs(),
                        (fr + 4) * EPS32 * (dy64 * xh).abs().sum(dim=0)),
            worst_ratio((db.double() - dy64.sum(dim=0)).abs(),
                        (fr + 4) * EPS32 * dy64.abs().sum(dim=0)))
    for who, r in ratios.items():
        assert r <= 1.0, (f"layer_norm {who} ({n1}, {n2}) {dtype}: {r} of "
                          f"the fp64 bound")
    errs = (max(max_abs(a, p_) for a, p_ in zip(fwd["kernel"],
                                                fwd["plain"])),
            max(max_abs(a, p_) for a, p_ in zip(bwd["kernel"],
                                                bwd["plain"])))
    # the same bits on a second run and on graph replays: no atomics, no
    # state carried between launches
    again = [ops.layer_norm_bwd(dy, x, w, mean, inv)]
    fwd_again = [ops.layer_norm_fwd(x, w, b, eps)]
    if misaligned:
        # the same values in fresh allocations: the forward's vector path
        # where the rows are whole 16-byte chunks
        fwd_again.append(ops.layer_norm_fwd(x.clone(), w.clone(), b.clone(),
                                            eps))
    if x.is_cuda:
        again += graph_replays(lambda: ops.layer_norm_bwd(dy, x, w, mean,
                                                          inv))
        fwd_again += graph_replays(lambda: ops.layer_norm_fwd(x, w, b, eps))
        if misaligned:
            plan = lnm._bwd_plan(n1, n2, x.element_size(),
                                 lnm._aligned(dy, x, w))
            assert plan.path != "vector", plan
            plan = lnm._fwd_plan(n1, n2, x.element_size(),
                                 lnm._aligned(x, w, b))
            assert plan.path != "vector", plan
    for outs in again:
        assert all(torch.equal(a, b_) for a, b_ in zip(outs, bwd["kernel"])), \
            f"layer_norm_bwd ({n1}, {n2}) {dtype} differs between runs"
    for outs in fwd_again:
        assert all(torch.equal(a, b_) for a, b_ in zip(outs, fwd["kernel"])), \
            f"layer_norm_fwd ({n1}, {n2}) {dtype} differs between runs"
    return (x, dy, w, b, mean, inv), errs, ratios


def device_split(fn, calls: int = 10) -> dict:
    """Device time a call of each kernel that ``fn`` launches
    (torch.profiler over ``calls`` eager calls), by short kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if evt.device_type == DeviceType.CUDA and us > 0:
            m = re.search(r"ln_\w+<[^>]*>|ln_\w+", evt.key)
            name = m.group() if m else evt.key[:60]
            split[name] = split.get(name, 0.0) + us / 1e3 / calls
    return split


def phase_layer_norm(resources=None):
    """LayerNorm forward and backward at BERT-base's (4096, 768) and
    BERT-large's (1024, 1024) shapes (bf16, eps 1e-12, as O2 runs them) and
    at odd shapes, each held against fp64; timed per call at both main
    shapes, with the backward's device time split by kernel, and the
    forward at the wide row ``LN_WIDE``; logs the kernels' registers,
    spills and shared bytes (``resources``, from ``ptxas_resources``) and
    the runtime's for the planned grids."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    err = {"layer_norm_fwd": 0.0, "layer_norm_bwd": 0.0}
    worst = {"kernel": 0.0, "plain": 0.0}

    def note(errs, rat):
        err["layer_norm_fwd"] = max(err["layer_norm_fwd"], errs[0])
        err["layer_norm_bwd"] = max(err["layer_norm_bwd"], errs[1])
        for who in worst:
            worst[who] = max(worst[who], rat[who])

    for i, (n1, n2) in enumerate(LN_ODD):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            note(*_ln_check(n1, n2, dtype, SEED + 30 + i)[1:])
    for i, (n1, n2) in enumerate(LN_MISALIGNED):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            note(*_ln_check(n1, n2, dtype, SEED + 50 + i,
                            misaligned=True)[1:])
    # the main paths' cases: bf16 at both shapes (O2), and fp32 at
    # BERT-base's (the O1 path: its residual adds hand LayerNorm fp32)
    main = [(n1, n2, torch.bfloat16, _ln_check(n1, n2, torch.bfloat16,
                                               SEED + 40 + i))
            for i, (n1, n2) in enumerate(LN_SHAPES)]
    main.append((LN_ROWS, LN_WIDTH, torch.float32,
                 _ln_check(LN_ROWS, LN_WIDTH, torch.float32, SEED + 45)))
    for *_, (_, errs, rat) in main:
        note(errs, rat)
    log(f"[kernels] layer_norm at {LN_ODD} (fp32/bf16/fp16), misaligned at "
        f"{LN_MISALIGNED} (fp32/bf16/fp16), {LN_SHAPES} bf16 and "
        f"{(LN_ROWS, LN_WIDTH)} fp32: within the "
        f"fp64 bounds, forward and backward the same bits on a second "
        f"launch and three graph replays, the forward of a misaligned view "
        f"the same bits as of aligned copies; worst ratio kernel "
        f"{worst['kernel']:.3e}, plain {worst['plain']:.3e}; max abs err "
        f"against the plain version {err}")
    for name, r in sorted((resources or {}).items()):
        short = kernel_short(name)
        if (short.startswith(("ln_bwd", "ln_colsum")) and "fp" not in short
                or short.startswith("ln_fwd") and ",vec" in short):
            log(f"[kernels] layer_norm ptxas {short}: {r}")
    for n1, n2 in LN_SHAPES:
        plan = lnm._bwd_plan(n1, n2, 2, True)
        log(f"[kernels] layer_norm_bwd bf16 ({n1}, {n2}): {plan}, row "
            f"kernel {lnm.bwd_kernel_info(torch.bfloat16, n2, plan)}")
    for n1, n2, dtype in LN_FWD_CASES:
        plan = lnm._fwd_plan(n1, n2, torch.tensor([], dtype=dtype)
                             .element_size(), True)
        log(f"[kernels] layer_norm_fwd {dtype} ({n1}, {n2}): {plan}, "
            f"kernel {lnm.fwd_kernel_info(dtype, n2, plan)}")
    rows = {}
    for n1, n2, dtype, ((x, dy, w, b, mean, inv), _, _) in main:
        isz, eps = x.element_size(), 1e-12
        tag = "" if dtype == torch.bfloat16 else ":fp32"
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n2], wl, bl,
                                                           eps)
        timing = {
            "layer_norm_fwd" + tag: _ln_fwd_entry(x, w, b, eps),
            # reads dy, x, w, mean, inv; writes dx, dw, db
            "layer_norm_bwd" + tag: (
                3 * n1 * n2 * isz + 3 * n2 * 4 + 2 * n1 * 4, 11 * n1 * n2,
                lambda: ops.layer_norm_bwd(dy, x, w, mean, inv),
                lambda: lnm._bwd_plain(dy, x, w, mean, inv),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [n2], lmean, lrstd, wl, bl, [True, True, True])),
        }
        dname = str(dtype).replace("torch.", "")
        per = (f"({n1}, {n2}) {dname}, one call; "
               f"{LN_PER_PASS if n2 == LN_WIDTH else LARGE_LN_PER_PASS} "
               f"calls a pass")
        at = _time_rows(timing, err, per)
        split = device_split(timing["layer_norm_bwd" + tag][2])
        log(f"[kernels] layer_norm_bwd ({n1}, {n2}) {dname} device time by "
            f"kernel, ms a call (torch.profiler, 10 eager calls): "
            f"{json.dumps(split)}")
        at["layer_norm_bwd" + tag]["split"] = split
        if dtype == torch.bfloat16 and n2 == LN_WIDTH:
            # row 7 W, logged only
            wx, _, ww, wb = _ln_case(*LN_WIDE, torch.bfloat16, SEED + 47)
            err["layer_norm_fwd"] = max(err["layer_norm_fwd"], max(
                max_abs(a, p_) for a, p_ in zip(
                    ops.layer_norm_fwd(wx, ww, wb, eps),
                    lnm._fwd_plain(wx, ww, wb, eps))))
            _time_rows({"layer_norm_fwd": _ln_fwd_entry(wx, ww, wb, eps)},
                       err, f"{LN_WIDE} bf16, one call; no path runs it")
        for key, row in at.items():
            if key not in rows:
                rows[key] = dict(row, shapes=[])
            rows[key]["shapes"].append(
                {k: row[k] for k in ("per", "ms", "plain_ms", "library_ms",
                                     "bound_ms", "call_ms", "bytes")}
                | ({"split": split} if row["name"] == "layer_norm_bwd"
                   else {}))
    return rows


def load_ops(root):
    """The ops package of the checkout at ``root`` (its own sources and
    build directory), imported as ``parent_ops``."""
    import importlib.util
    import sys
    from pathlib import Path
    init = Path(root).resolve() / "apex_tpu_torch" / "ops" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "parent_ops", init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_ops"] = mod
    spec.loader.exec_module(mod)
    return mod


# (warps a block, rows a warp) of the backward's vector path, timed beside
# the plan's own grid
LN_GRIDS = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (8, 8))
# the forward's A/B cases: the main paths' (BERT-base bf16, BERT-large
# bf16, BERT-base fp32 under O1), BERT-base's micro-batch of 16 in phase
# 15 (b), and the wide row
LN_FWD_CASES = ((LN_ROWS, LN_WIDTH, torch.bfloat16),
                (8 * 128, 1024, torch.bfloat16),
                (LN_ROWS, LN_WIDTH, torch.float32),
                (LN_ROWS // 2, LN_WIDTH, torch.bfloat16),
                LN_WIDE + (torch.bfloat16,))
# grids of the forward timed beside the plan's: (warps a block, rows a
# warp) where a warp holds a row, rows a block where a block does
LN_FWD_GRIDS = ((8, 1), (4, 1), (2, 1), (1, 1), (8, 2), (4, 2), (2, 2),
                (4, 4))
LN_WIDE_GRIDS = (1, 2, 4, 8, 16)


def _ln_fwd_entry(x, w, b, eps):
    """``_time_rows``' entry for the forward on these inputs: bytes (x
    read, y written, w, b, mean and inv), flops (8 an element), the
    kernel, its plain version and ``F.layer_norm``."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    n1, n2 = x.shape
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    return (2 * n1 * n2 * x.element_size() + 2 * n2 * 4 + 2 * n1 * 4,
            8 * n1 * n2, lambda: ops.layer_norm_fwd(x, w, b, eps),
            lambda: lnm._fwd_plain(x, w, b, eps),
            lambda: torch.nn.functional.layer_norm(x, (n2,), wl, bl, eps))


def _ln_fwd_ab(parent, n1, n2, dtype, seed):
    """The forward against ``parent``'s at (n1, n2): graph-replay ms in the
    order parent, change, change, parent, the bound, the change's forward
    at other grids (the same bits at each) and the max abs difference."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    x, _, w, b = _ln_case(n1, n2, dtype, seed)
    eps = 1e-12
    calls = {"parent": lambda: parent.layer_norm_fwd(x, w, b, eps),
             "change": lambda: ops.layer_norm_fwd(x, w, b, eps)}
    want = calls["change"]()
    diff = max(max_abs(a, p) for a, p in zip(want, calls["parent"]()))
    ms = [(who, graph_ms(calls[who]))
          for who in ("parent", "change", "change", "parent")]
    plan = lnm._fwd_plan(n1, n2, x.element_size(), True)
    if plan.row_warps == 1:
        grids = []
        for wp, r in LN_FWD_GRIDS:
            groups = -(-n1 // r)
            grids.append((f"{wp}x{r}", lnm.FwdPlan(plan.path, wp, 1, r,
                                                   -(-groups // wp))))
    else:
        grids = [(f"block x{r}", plan._replace(rows_per_group=r,
                                                blocks=-(-n1 // r)))
                 for r in LN_WIDE_GRIDS]
    at = {}
    for key, g in grids:
        y, mean, inv = (torch.empty_like(t) for t in want)
        lnm._launch_fwd(x, w, b, eps, y, mean, inv, g)
        assert all(torch.equal(a, c) for a, c in zip((y, mean, inv), want)), \
            f"layer_norm_fwd differs at grid {g}"
        at[key] = graph_ms(lambda: lnm._launch_fwd(x, w, b, eps, y, mean, inv,
                                                   g))
    bound = _ln_fwd_entry(x, w, b, eps)[0] / MEM_BYTES_PER_S * 1e3
    dname = str(dtype).replace("torch.", "")
    log(f"[ab] layer_norm_fwd ({n1}, {n2}) {dname}, graph replay, ms: "
        + ", ".join(f"{who} {t:.4f}" for who, t in ms)
        + f"; bound {bound:.4f}; change's grids {json.dumps(at)}; the plan "
        f"{plan}, kernel {lnm.fwd_kernel_info(dtype, n2, plan)}; max abs "
        f"diff {diff}")
    return {"ms": ms, "bound_ms": bound, "grids": at, "plan": plan._asdict(),
            "max_abs_diff": diff}


def phase_layer_norm_ab(parent):
    """The LayerNorm forward and backward against ``parent``'s (an ops
    package from ``load_ops``): device time by graph replay in the order
    parent, change, change, parent; the forward at ``LN_FWD_CASES`` and at
    the grids of ``LN_FWD_GRIDS`` / ``LN_WIDE_GRIDS``, the backward at both
    main shapes in bf16, each one's split by kernel, and at the grids of
    ``LN_GRIDS`` (the outputs the same bits at every grid)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    out = {"fwd": {}}
    for i, (n1, n2, dtype) in enumerate(LN_FWD_CASES):
        dname = str(dtype).replace("torch.", "")
        out["fwd"][f"({n1}, {n2}) {dname}"] = _ln_fwd_ab(parent, n1, n2,
                                                         dtype, SEED + 70 + i)
    for i, (n1, n2) in enumerate(LN_SHAPES):
        x, dy, w, b = _ln_case(n1, n2, torch.bfloat16, SEED + 60 + i)
        _, mean, inv = lnm._fwd_plain(x, w, b, 1e-12)
        calls = {"parent": lambda: parent.layer_norm_bwd(dy, x, w, mean, inv),
                 "change": lambda: ops.layer_norm_bwd(dy, x, w, mean, inv)}
        diff = max(max_abs(a, p) for a, p in zip(calls["change"](),
                                                 calls["parent"]()))
        ms = [(who, graph_ms(calls[who]))
              for who in ("parent", "change", "change", "parent")]
        split = {who: device_split(fn) for who, fn in calls.items()}
        want = calls["change"]()[0]
        grids = {}
        for warps, rpw in LN_GRIDS:
            blocks = -(-n1 // (warps * rpw))
            plan = lnm.BwdPlan("vector", warps, rpw, blocks, blocks,
                               2 * blocks * n2)
            dx = torch.empty_like(dy)
            lnm._launch_bwd(dy, x, w, mean, inv, dx, plan)
            assert torch.equal(dx, want), f"dx differs at grid {plan}"
            grids[f"{warps}x{rpw}"] = graph_ms(
                lambda: lnm._launch_bwd(dy, x, w, mean, inv, dx, plan))
        out[f"({n1}, {n2})"] = {"ms": ms, "split": split, "grids": grids,
                                "max_abs_diff": diff}
        log(f"[ab] layer_norm_bwd ({n1}, {n2}) bf16, graph replay, ms: "
            + ", ".join(f"{who} {t:.4f}" for who, t in ms)
            + f"; by kernel {json.dumps(split)}; change's vector path at "
            f"(warps, rows a warp) {json.dumps(grids)}; the plan "
            f"{lnm._bwd_plan(n1, n2, 2, True)}; max abs diff {diff}")
    log("layer_norm_ab " + json.dumps(out))
    return out


def _time_rows(timing, err, per):
    """kernel, plain and library device time (``graph_ms``) of each entry
    of ``timing`` = name -> (bytes, flops, kernel, plain, library), the
    library a call or its time already taken."""
    rows = {}
    for key, (nbytes, flops, kern, plain, libcall) in timing.items():
        name = key.split(":")[0]      # "name:variant" times a variant
        kms, pms = graph_ms(kern), graph_ms(plain)
        lms = libcall if isinstance(libcall, float) else graph_ms(libcall)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        rows[key] = {"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err[name], "ms": kms, "plain_ms": pms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": lms, "call_ms": time_ms(kern),
                     "bytes": nbytes, "flops": flops, "per": per}
        log(f"[kernels] {key} {per}: kernel_ms {kms:.4f} bound_ms "
            f"{rows[key]['bound_ms']:.4f} ({nbytes} B, {flops} flops) "
            f"plain_ms {pms:.4f} library_ms {lms:.4f} (device time, graph "
            f"replay); one eager call {rows[key]['call_ms']:.4f}")
    return rows


def _flash_case(B, H, T, D, dtype, seed):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B * H, T, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    kvm = torch.rand(B, T, generator=gen, device=dev) > 0.3
    kvm[0] = False                           # a sequence with no valid key
    seg = torch.sort(torch.randint(0, 3, (B, T), generator=gen, device=dev),
                     dim=1).values.to(torch.int32)
    words = torch.tensor([SEED + 12345 + seed, -(seed + 1)],
                         dtype=torch.int32, device=dev)
    return q, k, v, do, kvm, seg, words


def _flash_ref64(q, k, v, do, o, H, scale, causal, kvm, seg, words, rate):
    """fp64 o, dq, dk, dv from the same inputs and masks (delta from the
    given o, as the backward forms it), the fp64 sums of the terms'
    magnitudes that bound the rounding of each, and the sums of the
    magnitudes of the operand each rounded P or dS multiplies."""
    from apex_tpu_torch.ops import flash_attention as fa
    valid = fa._valid(q, H, causal, kvm, seg)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s = torch.where(valid, torch.matmul(q64, k64.transpose(1, 2)) * scale,
                    -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pn = p / torch.where(l == 0, 1.0, l)
    dp = torch.matmul(do64, v64.transpose(1, 2))
    dpa = torch.matmul(do64.abs(), v64.abs().transpose(1, 2))
    pa = pn
    if rate:
        keep, ik = fa._keep(q, words, rate), fa._inv_keep(rate)
        pa = torch.where(keep, pn, 0.0) * ik
        dp = torch.where(keep, dp, 0.0) * ik
        dpa = torch.where(keep, dpa, 0.0) * ik
    delta = (do64 * o.double()).sum(dim=-1, keepdim=True)
    ds = pn * (dp - delta)
    dsa = pn * (dpa + delta.abs())
    pat, dst, dsat = (t.transpose(1, 2) for t in (pa, ds, dsa))
    def colsum(t):
        return t.abs().sum(dim=1, keepdim=True)

    return {"o": (torch.matmul(pa, v64), torch.matmul(pa, v64.abs()),
                  colsum(v64)),
            "dq": (torch.matmul(ds, k64) * scale,
                   torch.matmul(dsa, k64.abs()) * scale, colsum(k64) * scale),
            "dk": (torch.matmul(dst, q64) * scale,
                   torch.matmul(dsat, q64.abs()) * scale,
                   colsum(q64) * scale),
            "dv": (torch.matmul(pat, do64), torch.matmul(pat, do64.abs()),
                   colsum(do64))}


def _flash_check(shape, dtype, variant, seed):
    """The three flash kernels and their plain versions, each against
    fp64: an output within one rounding to its type of the fp64 value plus
    (u + 256*2^-24) of the fp64 sum of its terms' magnitudes (u: the
    rounding of P and dS to the type; 256*2^-24: the fp32 sums, exp and the
    scores' rounding), plus the rounding of P and dS values too small for
    the type's normal range (fp16).  A fully masked row must be exactly
    0."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import flash_attention as fa
    B, H, T, D = shape
    q, k, v, do, kvm, seg, words = _flash_case(B, H, T, D, dtype, seed)
    spec = FLASH_VARIANTS[variant]
    causal = spec.get("causal", False)
    kvm = kvm if spec.get("kv_mask") else None
    seg = seg if spec.get("segments") else None
    rate = spec.get("rate", 0.0)
    scale = D ** -0.5
    args = (H, scale, causal, kvm, seg, words, rate)
    got, want = {}, {}
    got["o"], lse = ops.flash_fwd(q, k, v, *args)
    want["o"], plse = fa._fwd_plain(q, k, v, *args)
    # each backward from its own forward, as autograd runs it
    for out, o_, l_ in ((got, got["o"], lse), (want, want["o"], plse)):
        delta = (do.float() * o_.float()).sum(dim=-1)
        kern = out is got
        dq = (ops.flash_dq if kern else fa._dq_plain)(q, k, v, do, l_, delta,
                                                     *args)
        dk, dv = (ops.flash_dkv if kern else fa._dkv_plain)(
            q, k, v, do, l_, delta, *args)
        out.update(dq=dq, dk=dk, dv=dv)
    u = UNIT[dtype]
    ratios = {"kernel": 0.0, "plain": 0.0}
    for who, out in (("kernel", got), ("plain", want)):
        ref = _flash_ref64(q, k, v, do, out["o"], *args)
        for name, (r64, mag, floor) in ref.items():
            bound = (u * r64.abs() + (u + 256 * EPS32) * mag
                     + TINY[dtype] * floor)
            r = worst_ratio((out[name].double() - r64).abs(), bound)
            assert r <= 1.0, (f"flash {who} {name} {shape} {dtype} "
                              f"{variant}: {r} of the fp64 bound")
            ratios[who] = max(ratios[who], r)
    if kvm is not None:
        assert float(got["o"][:H].float().abs().max()) == 0.0, \
            "a sequence with no valid key must give zeros"
    # the same bits on a second launch: each block writes only its rows
    o2, lse2 = ops.flash_fwd(q, k, v, *args)
    delta = (do.float() * got["o"].float()).sum(dim=-1)
    dq2 = ops.flash_dq(q, k, v, do, lse, delta, *args)
    dk2, dv2 = ops.flash_dkv(q, k, v, do, lse, delta, *args)
    assert torch.equal(o2, got["o"]) and torch.equal(lse2, lse), \
        f"flash_fwd differs between launches {shape} {dtype} {variant}"
    assert torch.equal(dq2, got["dq"]), \
        f"flash_dq differs between launches {shape} {dtype} {variant}"
    assert torch.equal(dk2, got["dk"]) and torch.equal(dv2, got["dv"]), \
        f"flash_dkv differs between launches {shape} {dtype} {variant}"
    errs = {"flash_fwd": max_abs(got["o"], want["o"]),
            "flash_dq": max_abs(got["dq"], want["dq"]),
            "flash_dkv": max(max_abs(got["dk"], want["dk"]),
                             max_abs(got["dv"], want["dv"]))}
    return errs, ratios


def phase_flash(uncapped):
    """The flash kernels at BERT-base's shape (every variant, bf16 and
    fp16: all three on tensor cores), at T = 512, at D = 128 with 16 heads
    and at odd shapes (fp32 on the FMA kernels, bf16, fp16), each against
    fp64 and each kernel twice, bitwise; the
    dropout mask shown equal to the hash in every dtype, with and without
    the causal mask; timed at BERT-base's shape with the path's dropout
    0.1, in bf16 (the rows) and fp32 (the FMA route); the dK/dV kernel
    with its register cap against ``uncapped``, the library built without
    it."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    worst = {"kernel": 0.0, "plain": 0.0}
    i = 0
    cases = [(FLASH_BASE, d, v) for d in (torch.bfloat16, torch.float16)
             for v in FLASH_VARIANTS]
    cases += [(FLASH_LONG, torch.bfloat16, v) for v in ("none", "all")]
    cases.append((FLASH_WIDE, torch.bfloat16, "all"))
    cases += [(s, d, v) for s in FLASH_ODD
              for d in (torch.float32, torch.bfloat16, torch.float16)
              for v in ("none", "all")]
    cases.append(((2, 2, 512, 64), torch.float32, "kv_mask"))
    for shape, dtype, variant in cases:
        errs, rat = _flash_check(shape, dtype, variant, SEED + 50 + i)
        i += 1
        for k_, e in errs.items():
            err[k_] = max(err[k_], e)
        for who in worst:
            worst[who] = max(worst[who], rat[who])
    log(f"[kernels] flash fwd/dq/dkv at {len(cases)} shape, dtype and "
        f"variant cases: within the fp64 bounds, worst ratio kernel "
        f"{worst['kernel']:.3e}, plain {worst['plain']:.3e}; max abs err "
        f"against the plain version {err}")
    # the dropout mask: q = k = 0 and V = identity (T = D), so O's zero
    # pattern is the mask (under the causal mask, the mask's lower
    # triangle), and each kept value is round_T(1/(1 - rate)) over the
    # row's count of valid keys: the plain version's bits
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for T in (64, 128):
            for causal in (False, True):
                z = torch.zeros(12, T, T, device=DEVICE, dtype=dtype)
                eye = (torch.eye(T, device=DEVICE).expand(12, T, T)
                       .contiguous().to(dtype))
                words = torch.tensor([SEED + 7, 99], dtype=torch.int32,
                                     device=DEVICE)
                o, _ = ops.flash_fwd(z, z, eye, 3, 1.0, causal, seed=words,
                                     rate=0.1)
                keep = fa._keep(z, words, 0.1)
                if causal:
                    keep = keep & torch.ones(T, T, dtype=torch.bool,
                                             device=DEVICE).tril()
                what = f"{dtype} T = {T} causal {causal}"
                assert torch.equal(o != 0, keep), f"dropout mask, {what}"
                po, _ = fa._fwd_plain(z, z, eye, 3, 1.0, causal, None, None,
                                      words, 0.1)
                assert torch.equal(o, po), f"kept values, {what}"
    log(f"[kernels] flash dropout: O's zero pattern equals the hash's mask "
        f"and O the plain version's bits at T = D = 64 and 128, fp32, bf16 "
        f"and fp16, with and without the causal mask (keep share "
        f"{float(keep.float().mean()):.4f} at rate 0.1, causal)")
    B, H, T, D = FLASH_BASE
    q, k, v, do, _, _, words = _flash_case(B, H, T, D, torch.bfloat16,
                                           SEED + 90)
    args = (H, D ** -0.5, False, None, None, words, 0.1)
    o, lse = ops.flash_fwd(q, k, v, *args)
    delta = (do.float() * o.float()).sum(dim=-1)
    q4, k4, v4, do4 = (t.view(B, H, T, D).detach().requires_grad_()
                       for t in (q, k, v, do))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, dropout_p=0.1)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    # the library's backward is one call for dq, dk and dv: its time
    # (forward and backward, less forward) stands beside both rows
    lib_fwd = graph_ms(sdpa)
    lib_bwd = graph_ms(sdpa_fwd_bwd) - lib_fwd
    log(f"[kernels] scaled_dot_product_attention at {FLASH_BASE} bf16, "
        f"dropout 0.1: forward {lib_fwd:.4f} ms, backward (dq, dk, dv in "
        f"one) {lib_bwd:.4f} ms")
    n, isz, f0 = B * H * T * D, q.element_size(), B * H * T * T * D
    stats = B * H * T * 4
    timing = {
        # reads q, k, v; writes o and lse
        "flash_fwd": (4 * n * isz + stats, 4 * f0,
                      lambda: ops.flash_fwd(q, k, v, *args),
                      lambda: fa._fwd_plain(q, k, v, *args), lib_fwd),
        # reads q, k, v, dO, lse, delta; writes dq
        "flash_dq": (5 * n * isz + 2 * stats, 6 * f0,
                     lambda: ops.flash_dq(q, k, v, do, lse, delta, *args),
                     lambda: fa._dq_plain(q, k, v, do, lse, delta, *args),
                     lib_bwd),
        # reads q, k, v, dO, lse, delta; writes dk, dv
        "flash_dkv": (6 * n * isz + 2 * stats, 8 * f0,
                      lambda: ops.flash_dkv(q, k, v, do, lse, delta, *args),
                      lambda: fa._dkv_plain(q, k, v, do, lse, delta, *args),
                      lib_bwd),
    }
    rows = _time_rows(timing, err, f"{FLASH_BASE} (B, H, T, D) bf16, "
                      f"dropout 0.1, one call; {FLASH_PER_PASS} calls a pass")
    # the kernels' device time without library or plain timing: fp32 (the
    # FMA route) at BERT-base's shape, bf16 at BERT-large's and at T = 512
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
    for shape, dtype, rate in ((FLASH_BASE, torch.float32, 0.1),
                               (FLASH_LARGE, torch.bfloat16, 0.1),
                               (FLASH_LONG, torch.bfloat16, 0.0)):
        B, H, T, D = shape
        q, k, v, do = _flash_case(B, H, T, D, dtype, SEED + 91)[:4]
        args = (H, D ** -0.5, False, None, None, words, rate)
        o, lse = ops.flash_fwd(q, k, v, *args)
        delta = (do.float() * o.float()).sum(dim=-1)
        bwd = (q, k, v, do, lse, delta, *args)
        f0 = B * H * T * T * D
        ms = {"flash_fwd": graph_ms(lambda: ops.flash_fwd(q, k, v, *args)),
              "flash_dq": graph_ms(lambda: ops.flash_dq(*bwd)),
              "flash_dkv": graph_ms(lambda: ops.flash_dkv(*bwd))}
        tag = f"{shape} {str(dtype)[6:]} dropout {rate}"
        for name, t in ms.items():
            rows[name].setdefault("also", {})[tag] = {
                "ms": t, "tflops": flops[name] * f0 / t / 1e9}
        log(f"[kernels] flash at {tag}: " + ", ".join(
            f"{n[6:]} {t:.4f} ms ({flops[n] * f0} flops, "
            f"{flops[n] * f0 / t / 1e9:.1f} TFLOP/s)" for n, t in ms.items()))
    # the launch shape and resources of each instantiation the paths and
    # checks run: grid at BERT-base's and BERT-large's shapes, resident
    # blocks an SM (the occupancy API), registers and spills (the runtime's
    # attributes of the built kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in timing:
        which = name[6:]
        res = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for D in (32, 64, 128):
                info = fa.kernel_info(which, dtype, D)
                res[f"{str(dtype)[6:]} D<={D}"] = info
                log(f"[kernels] {name} {str(dtype)[6:]} D <= {D}: {info}")
        for shape in (FLASH_BASE, FLASH_LARGE):
            B, H, T, D = shape
            grid = B * H * -(-T // 64)
            dp = next(w for w in (32, 64, 128) if D <= w)
            info = res[f"bfloat16 D<={dp}"]
            resident = min(grid, info["blocks_per_sm"] * sms)
            warps = resident * info["threads"] // 32 / sms
            log(f"[kernels] {name} bf16 at {shape}: {grid} blocks of "
                f"{info['threads']} threads, {info['blocks_per_sm']} "
                f"resident an SM, {grid / (info['blocks_per_sm'] * sms):.2f} "
                f"waves on {sms} SMs, {warps:.1f} warps an SM in the first")
    # the dK/dV register cap (flash_attention.cu, APEX_FLASH_DKV_BLOCKS):
    # the same bits with and without it, and the time of each
    capped = _build.library("flash_attention")
    for shape in (FLASH_BASE, FLASH_LARGE):
        B, H, T, D = shape
        q, k, v, do = _flash_case(B, H, T, D, torch.bfloat16, SEED + 92)[:4]
        args = (H, D ** -0.5, False, None, None, words, 0.1)
        o, lse = ops.flash_fwd(q, k, v, *args)
        bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(dim=-1), *args)
        want = ops.flash_dkv(*bwd)
        t_cap = graph_ms(lambda: ops.flash_dkv(*bwd))
        _build._LIBS["flash_attention"] = uncapped
        try:
            got = ops.flash_dkv(*bwd)
            t_free = graph_ms(lambda: ops.flash_dkv(*bwd))
            info = fa.kernel_info("dkv", torch.bfloat16, D)
        finally:
            _build._LIBS["flash_attention"] = capped
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"flash_dkv with and without the register cap differ at {shape}"
        tag = f"{shape} bfloat16 dropout 0.1 uncapped"
        rows["flash_dkv"]["also"][tag] = {
            "ms": t_free, "tflops": 8 * B * H * T * T * D / t_free / 1e9}
        log(f"[kernels] flash_dkv register cap at {shape} bf16, dropout "
            f"0.1: capped {t_cap:.4f} ms, uncapped {t_free:.4f} ms "
            f"(uncapped: {info}), the same bits")
    return rows


# -- phase 3, LAMB and the per-tensor l2norm ------------------------------------

BERT_LARGE_N = 336_195_586          # BERT-large's flat parameter count
BERT_LARGE_TENSORS = 301
RAGGED = (1, 1023, 1025, 3 * 1024)  # lengths around the 1024 chunk
ODD_TENSORS = (5, 70_001, 2, 929_995)   # N_ODD in four, chunks off 16 B
FP32_FLOPS = 67e12                  # H100 SXM fp32 outside tensor cores
LAMB_HP = (0.9, 0.999, 0.1, 1e-6)   # beta1, beta2, beta3, eps


def _layout(sizes):
    from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
    return ChunkedFlatLayout([torch.empty(n, device="meta") for n in sizes])


def _bert_large_params():
    """BERT-large's weights (seed SEED) on the card, flat in the amp layout
    (the JAX package's leaf order), and that layout."""
    from apex_tpu_torch import models
    from apex_tpu_torch.amp._process_optimizer import jax_leaf_order
    from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
    model = models.BertForPretraining(
        models.bert_large(), device=DEVICE,
        generator=torch.Generator().manual_seed(SEED))
    by_name = dict(model.named_parameters())
    tensors = [by_name[n].detach() for n in jax_leaf_order(by_name)]
    layout = ChunkedFlatLayout(tensors)
    flat = layout.pack(tensors)
    del model, by_name, tensors
    torch.cuda.empty_cache()
    return flat, layout


def _lamb_inputs(p, seed):
    dev = p.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = p.numel()
    g = torch.randn(n, generator=gen, device=dev) * 3.0
    m = torch.randn(n, generator=gen, device=dev) * 0.01
    v = torch.rand(n, generator=gen, device=dev) * 1e-4
    # 1/clip, 1/(1-beta1^3), 1/(1-beta2^3) as a third step forms them
    scal = [torch.full((), s, dtype=torch.float32, device=dev) for s in
            (0.5, 1.0 / (1.0 - 0.9 ** 3), 1.0 / (1.0 - 0.999 ** 3))]
    return g, m, v, scal, gen


def _lamb_check(p, table, seed):
    """Stage 1 in both modes with and without weight decay, and stage 2
    with and without the bf16 copy, each with the no-op flag clear and
    set: kernel and plain version bitwise, and a set flag writes nothing.
    Returns the max abs errors against the plain versions."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import lamb as lm
    g, m0, v0, scal, gen = _lamb_inputs(p, seed)
    err = {"lamb_stage1": 0.0, "lamb_stage2": 0.0}
    for noop in (0.0, 1.0):
        flag = torch.full((), noop, device=p.device)
        for adam_w_mode in (True, False):
            for wd in (0.0, 0.01):
                hp = (*LAMB_HP, wd, adam_w_mode)
                mk, vk, uk = m0.clone(), v0.clone(), torch.zeros_like(p)
                mp, vp, up = m0.clone(), v0.clone(), torch.zeros_like(p)
                ops.lamb_stage1(g, p, mk, vk, *scal, *hp, noop=flag, out=uk)
                lm._stage1_plain(g, p, mp, vp, up, *scal, *hp, flag)
                for name, a, b in (("u", uk, up), ("m", mk, mp),
                                   ("v", vk, vp)):
                    assert same(a, b), (f"lamb_stage1 {name} n={p.numel()} "
                                        f"adam_w_mode {adam_w_mode} wd {wd} "
                                        f"noop {noop}: kernel != plain")
                    err["lamb_stage1"] = max(err["lamb_stage1"],
                                             max_abs(a, b))
                if noop:
                    assert torch.equal(mk, m0) and torch.equal(vk, v0) \
                        and not bool(uk.any()), "lamb_stage1 no-op wrote"
                del mk, vk, uk, mp, vp, up
    u = ops.lamb_stage1(g, p, m0.clone(), v0.clone(), *scal, *LAMB_HP, 0.01,
                        True)
    ratio = torch.rand(table.num_tensors, generator=gen,
                       device=p.device) + 0.5
    lr = torch.full((), 1e-3, device=p.device)
    for noop in (0.0, 1.0):
        flag = torch.full((), noop, device=p.device)
        for half in (None, torch.bfloat16):
            pk, pp = p.clone(), p.clone()
            hk, hp = ((None, None) if half is None else
                      (torch.zeros_like(p, dtype=half),
                       torch.zeros_like(p, dtype=half)))
            ops.lamb_stage2(pk, u, ratio, table, lr, half=hk, noop=flag)
            lm._stage2_plain(pp, u, ratio, table, lr, hp, flag)
            assert same(pk, pp), (f"lamb_stage2 n={p.numel()} half {half} "
                                  f"noop {noop}: kernel != plain")
            if half is not None:
                assert same(hk, hp), f"lamb_stage2 half copy {half}"
            if noop:
                assert torch.equal(pk, p) and (hk is None or not bool(
                    hk.any())), "lamb_stage2 no-op wrote"
            err["lamb_stage2"] = max(err["lamb_stage2"], max_abs(pk, pp))
            del pk, pp, hk, hp
    return err


def _l2pt_check(x, table) -> float:
    """The per-tensor l2norm against its plain version at rtol 1e-6 (the
    sums run in another order), the same bits on a second run."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import multi_tensor as mt
    got = ops.multi_tensor_l2norm_per_tensor(x, table)
    want = mt._l2norm_per_tensor_plain(x, table)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(ops.multi_tensor_l2norm_per_tensor(x, table), got), \
        "l2norm per tensor differs between runs"
    return max_abs(got, want)


def phase_lamb():
    """The LAMB kernels and the per-tensor l2norm at BERT-large's flat
    length and tensors (its weights as p) and at odd lengths, against
    their plain versions; timed at BERT-large's length."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import lamb as lm
    from apex_tpu_torch.ops import multi_tensor as mt
    err = {"lamb_stage1": 0.0, "lamb_stage2": 0.0,
           "multi_tensor_l2norm_per_tensor": 0.0}

    def note(e):
        for k, v in e.items():
            err[k] = max(err[k], v)

    dev = torch.device(DEVICE)
    for i, sizes in enumerate((RAGGED, ODD_TENSORS)):
        table = _layout(sizes).chunk_table(dev)
        x = torch.from_numpy(np.random.RandomState(SEED + 60 + i).randn(
            sum(sizes)).astype(np.float32)).to(dev)
        note({"multi_tensor_l2norm_per_tensor": _l2pt_check(x, table)})
        note(_lamb_check(x, table, SEED + 62 + i))
    log(f"[kernels] lamb stage 1 (adam_w_mode and L2, wd 0 and 0.01), stage "
        f"2 (with and without the bf16 copy), no-op flag clear and set, and "
        f"the per-tensor l2norm at tensors {RAGGED} and {ODD_TENSORS}: "
        f"agree with the plain versions; max abs err {err}")

    p, layout = _bert_large_params()
    n, T = p.numel(), layout.num_tensors
    assert n == BERT_LARGE_N and T == BERT_LARGE_TENSORS, (n, T)
    table = layout.chunk_table(dev)
    K = table.chunks.shape[0]
    note({"multi_tensor_l2norm_per_tensor": _l2pt_check(p, table)})
    g, m0, v0, scal, _ = _lamb_inputs(p, SEED + 64)
    note({"multi_tensor_l2norm_per_tensor": _l2pt_check(g, table)})
    del g, m0, v0
    torch.cuda.empty_cache()
    note(_lamb_check(p, table, SEED + 64))
    log(f"[kernels] lamb stage 1, stage 2 and the per-tensor l2norm at "
        f"BERT-large's {n} parameters in {T} tensors ({K} chunks of at most "
        f"{table.chunk}): agree with the plain versions; max abs err {err}")

    g, m0, v0, scal, gen = _lamb_inputs(p, SEED + 65)
    hp = (*LAMB_HP, 0.01, True)
    zero = torch.zeros((), device=dev)
    mk, vk, mp, vp = m0.clone(), v0.clone(), m0.clone(), v0.clone()
    uk, up = torch.empty_like(p), torch.empty_like(p)
    u = ops.lamb_stage1(g, p, m0, v0, *scal, *hp)
    ratio = torch.rand(T, generator=gen, device=dev) + 0.5
    lr = torch.full((), 1e-3, device=dev)
    pk, pp = p.clone(), p.clone()
    hk, hpl = (torch.empty_like(p, dtype=torch.bfloat16) for _ in range(2))
    table_bytes = 24 * K + 8 * (T + 1)
    spans = table.spans
    timing = {
        # reads g, p, m, v; writes u, m, v
        "lamb_stage1": (
            28 * n, 20 * n,
            lambda: ops.lamb_stage1(g, p, mk, vk, *scal, *hp, noop=zero,
                                    out=uk),
            lambda: lm._stage1_plain(g, p, mp, vp, up, *scal, *hp, zero),
            None),
        # reads p, u, the ratios and the chunk table; writes p and the
        # bf16 copy
        "lamb_stage2": (
            14 * n + 4 * T + table_bytes, 3 * n,
            lambda: ops.lamb_stage2(pk, u, ratio, table, lr, half=hk,
                                    noop=zero),
            lambda: lm._stage2_plain(pp, u, ratio, table, lr, hpl, zero),
            None),
        # reads x and the chunk table; writes one sum a tensor
        "multi_tensor_l2norm_per_tensor": (
            4 * n + table_bytes + 4 * T, 2 * n,
            lambda: ops.multi_tensor_l2norm_per_tensor(p, table),
            lambda: mt._l2norm_per_tensor_plain(p, table),
            lambda: [torch.linalg.vector_norm(p[o:o + k]) for o, k in spans]),
    }
    rows = {}
    for key, (nbytes, flops, kern, plain, libcall) in timing.items():
        name = key.split(":")[0]      # "name:variant" times a variant
        kms, pms = graph_ms(kern), graph_ms(plain)
        lms = None if libcall is None else graph_ms(libcall)
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err[name], "ms": kms, "plain_ms": pms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "library_ms": lms, "call_ms": time_ms(kern),
                      "bytes": nbytes, "flops": flops, "n": n,
                      "per": f"one call at BERT-large's {n} parameters, "
                             f"{T} tensors"}
        log(f"[kernels] {name} n={n}: kernel_ms {kms:.4f} bound_ms "
            f"{rows[name]['bound_ms']:.4f} ({nbytes} B at "
            f"{MEM_BYTES_PER_S / 1e12} TB/s; {flops} fp32 flops) plain_ms "
            f"{pms:.4f} library_ms "
            f"{'none' if lms is None else '%.4f' % lms} (device time, graph "
            f"replay); one eager call {rows[name]['call_ms']:.4f}")
    del g, m0, v0, mk, vk, mp, vp, uk, up, u, pk, pp, hk, hpl, p
    torch.cuda.empty_cache()
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


def _mem_floor() -> int:
    """The bytes still allocated on the card before a path builds its
    model: what earlier phases left behind, once their garbage (reference
    cycles included) is collected."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _drive(opt, step, tag: str, smi: str, items: int, unit: str,
           floor: int):
    """A path's run: 12 steps (the last 10 timed), then two steps of two
    micro-batches (axpby), with the launch counts set to 0 just before and
    read just after; then three steps profiled.  ``step(micro)`` runs one
    optimizer step and returns its mean loss; ``items`` (images or
    sequences) make one step's batch.  ``floor`` is ``_mem_floor()`` taken
    before the path built its model: the path's peak memory is the card's
    peak less that floor (model, optimizer state and activations)."""
    from apex_tpu_torch import amp, ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                       # the path starts
    losses, step_ms = [], []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(1))
        torch.cuda.synchronize()
        if i >= 2:                                  # 2 warm-up steps
            step_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(2):                              # two micro-batches
        losses.append(step(2))
    torch.cuda.synchronize()
    counts = ops.launch_counts()                    # the path ends

    vals = [float(l) for l in losses]
    peak = torch.cuda.max_memory_allocated() - floor
    # FusedAdam's step counts applied updates only; fp16's dynamic scale
    # skips the steps that overflow
    steps_done, skipped = int(opt.state.step), amp.steps_skipped(opt)
    assert all(math.isfinite(v) for v in vals), f"non-finite loss {vals}"
    assert vals[11] < vals[0], f"loss did not fall: {vals}"
    assert steps_done + skipped == 14, \
        f"applied {steps_done} + skipped {skipped} steps, expected 14"
    assert opt.scaler.dynamic or skipped == 0, f"{skipped} steps skipped"
    med = statistics.median(step_ms)
    log(f"[{tag}] {items} {unit} a step on {smi}: losses "
        f"{['%.4f' % v for v in vals]}; steps applied {steps_done}, "
        f"skipped {skipped}")
    log(f"[{tag}] step_ms median {med:.2f} over {len(step_ms)} steps "
        f"(all: {['%.2f' % t for t in step_ms]}), {unit}/s "
        f"{items / med * 1e3:.1f}, max_memory_allocated less the floor "
        f"{peak} B ({peak / 2**30:.2f} GiB; floor left by earlier phases "
        f"{floor} B), grad_norm "
        f"{float(opt.last_info['grad_norm']):.4f}")
    by_cat = phase_profile(lambda: step(1), med, tag=f"{tag}-profile")
    return counts, steps_done, {"step_ms": med, f"{unit}_per_s":
                                items / med * 1e3, "peak_bytes": peak,
                                "floor_bytes": floor,
                                "losses": vals, "profile_ms": by_cat}


def _resnet_step(model, opt):
    x, y = _batch(np.random.RandomState(SEED), BATCH, IMAGE, 1000, DEVICE)
    return lambda micro: _train_step(model, opt, x, y, micro)


def phase_train(smi):
    """The single-card path: ResNet-50 -> O2 + FusedAdam."""
    from apex_tpu_torch import amp, models, optimizers
    floor = _mem_floor()
    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(SEED))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    log("[train] resnet50 O2 FusedAdam, one card")
    out = _drive(opt, _resnet_step(model, opt), "train", smi, BATCH,
                 "images", floor)
    del model, opt
    torch.cuda.empty_cache()
    return out


# -- phase 5 -----------------------------------------------------------------

def phase_ddp(smi):
    """The data-parallel path on a one-rank group: ResNet-50 ->
    convert_syncbn_model -> O2 + FusedAdam -> DistributedDataParallel."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    floor = _mem_floor()
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
        out = _drive(opt, _resnet_step(ddp, opt), "ddp", smi, BATCH,
                     "images", floor)
        log(f"[ddp] buckets of the last all-reduce: {ddp.last_comm_stats}")
        del model, opt, ddp
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


_PORT_KERNELS = ("scale_kernel", "axpby_kernel", "l2norm_", "adam_kernel",
                 "lamb_stage")
_PORT_BN = ("bn_fwd_kernel", "bn_bwd_rows_kernel")
_PORT_LN = ("ln_fwd_", "ln_bwd_", "ln_colsum_kernel")
_PORT_ATTN = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
              "flash_fwd_mma_kernel", "flash_dq_mma_kernel",
              "flash_dkv_mma_kernel")
_LIBRARY_MATH = ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad",
                 "fprop", "implicit", "nvjet")


def _category(kernel: str) -> str:
    k = kernel.lower()
    if any(p in k for p in _PORT_BN):
        return "port BatchNorm apply kernels (syncbn fwd, bwd)"
    if any(p in k for p in _PORT_LN):
        return "port LayerNorm kernels"
    if any(p in k for p in _PORT_ATTN):
        return "port attention kernels"
    if "nccl" in k:
        return "collectives (NCCL)"
    if any(p in k for p in _PORT_KERNELS):
        return "port optimizer kernels"
    if any(p in k for p in _LIBRARY_MATH):
        return "convolution and matmul (cuDNN, cuBLAS)"
    if "reduce" in k:
        return "reductions (statistics, losses, grad sums)"
    if "catarray" in k:
        return "grad packing (cat)"
    return "elementwise and other (casts, activations, dropout, adds)"


def phase_profile(step, step_ms: float, tag: str = "profile",
                  steps: int = 3, per: int = 1):
    """Device time of a path's steps by kernel (torch.profiler), after the
    launch counts were read: where the time goes, and how much of the
    unprofiled step the device is busy.  ``step()`` is called ``steps``
    times and runs ``per`` steps a call (a captured graph of K steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    steps *= per
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
    # each port attention kernel, in or out of the top list
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        if _category(name) == "port attention kernels":
            short = re.search(r"flash_\w+<[^>]*>", name)
            log(f"[{tag}]   attention {ms / steps:8.3f} ms/step  "
                f"{short.group() if short else name[:80]}")
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


# -- phase 6, BERT ------------------------------------------------------------

BERT_BATCH, BERT_SEQ = 32, 128      # bench.py's BERT-base: 32 x 128 a chip


def _bert_batch(vocab, rs, B, T, device):
    """The synthetic MLM/NSP batch of examples/bert/main_amp.py: 15 % of the
    positions labelled, 80 % of those masked to id 3."""
    ids = rs.randint(5, vocab, (B, T))
    mask = rs.rand(B, T) < 0.15
    labels = np.where(mask, ids, -100)
    ids = np.where(mask & (rs.rand(B, T) < 0.8), 3, ids)
    nsp = rs.randint(0, 2, (B,))
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (ids, labels, nsp))


def _bert_step(model, opt, batch):
    from apex_tpu_torch import amp
    ids, labels, nsp = batch

    def step(micro):
        losses = []
        for i, l, n in zip(ids.chunk(micro), labels.chunk(micro),
                           nsp.chunk(micro)):
            loss = model.loss(i, l, n)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            losses.append(loss.detach())
        opt.step()
        opt.zero_grad()
        return torch.stack(losses).mean()
    return step


def phase_bert(smi):
    """The BERT path: BertForPretraining(bert_base()) -> O2 + FusedAdam(lr
    1e-4), train mode with the config's dropout 0.1, 32 x 128 tokens."""
    from apex_tpu_torch import amp, models, optimizers
    floor = _mem_floor()
    cfg = models.bert_base()
    model = models.BertForPretraining(
        cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED),
        dropout_generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                opt_level="O2", verbosity=0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    ln32 = model.bert.layer[0].attention_ln.weight.dtype
    assert ln32 == torch.float32 and \
        model.bert.word_embeddings.weight.dtype == torch.bfloat16
    log(f"[bert] BertForPretraining(bert_base) {n_params} parameters, O2 "
        f"FusedAdam(lr=1e-4), dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}, batch {BERT_BATCH} x "
        f"{BERT_SEQ}")
    batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED),
                        BERT_BATCH, BERT_SEQ, DEVICE)
    out = _drive(opt, _bert_step(model, opt, batch), "bert", smi,
                 BERT_BATCH, "sequences", floor)
    del model, opt
    torch.cuda.empty_cache()
    return out


def phase_bert_reference(make_opt, lr: float):
    """A tiny BERT trained three steps in fp32 (O0) on the card and on the
    CPU (the plain versions), from the same weights and batch, under the
    optimizer ``make_opt(lr)`` makes."""
    from apex_tpu_torch import amp, models
    cfg = models.BertConfig(vocab_size=128, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, max_position_embeddings=64,
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0, head_chunk=48)
    runs = {}
    for dev in (DEVICE, "cpu"):
        model = models.BertForPretraining(
            cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        opt = make_opt(lr)
        name = type(opt).__name__
        model, opt = amp.initialize(model, opt, opt_level="O0", verbosity=0)
        batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED + 3),
                            4, 32, dev)
        step = _bert_step(model, opt, batch)
        losses = [float(step(1)) for _ in range(3)]
        runs[dev] = (losses, opt.masters.buf.cpu())
    (lc, mc), (lp, mp) = runs[DEVICE], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    dmax = float((mc - mp).abs().max())
    # fp32 on both (TF32 off); sums in other orders.  Adam moves a weight
    # about lr a step, so a flipped near-zero grad costs up to 2*lr a step;
    # LAMB moves it by lr*ratio*u, ratio = ||p||/||u||, so up to about
    # 2*lr*|p| a step: 2*lr*steps*max|p|
    bound = 2 * lr * 3 * (1.0 if name == "FusedAdam"
                          else float(mp.abs().max()))
    assert rel < 1e-4, f"{name}: card vs CPU losses {lc} vs {lp}"
    assert dmax <= bound, f"{name}: card vs CPU masters differ by {dmax}"
    log(f"[bert-reference] O0 tiny BERT, {name}(lr={lr}), card vs CPU: "
        f"losses {lc} vs {lp} (max rel {rel:.2e} <= 1e-4), masters max abs "
        f"diff {dmax:.2e} (<= {bound:.2e})")


# -- phase 7, BERT-large ------------------------------------------------------

BERT_LARGE_BATCH = 8                # bench.py's BERT-large: 8 x 128 a chip


def phase_bert_large(smi):
    """The BERT-large path on a one-rank group: BertForPretraining(
    bert_large()) -> O2 + FusedLAMB(lr 1e-3) -> DistributedDataParallel,
    train mode with the config's dropout 0.1, 8 x 128 tokens."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    floor = _mem_floor()
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    try:
        cfg = models.bert_large()
        model = models.BertForPretraining(
            cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED),
            dropout_generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        n_tensors = len(list(model.parameters()))
        assert (n_params, n_tensors) == (BERT_LARGE_N, BERT_LARGE_TENSORS), \
            (n_params, n_tensors)
        model, opt = amp.initialize(model, optimizers.FusedLAMB(lr=1e-3),
                                    opt_level="O2", verbosity=0)
        ddp = parallel.DistributedDataParallel(model)
        model.train()
        m = opt.masters
        assert torch.equal(m.half, m.buf.to(m.half.dtype)), \
            "half copy and masters disagree after the broadcast"
        log(f"[bert-large] {dist.get_backend()} group of "
            f"{dist.get_world_size()}: BertForPretraining(bert_large) "
            f"{n_params} parameters in {n_tensors} tensors, O2 "
            f"FusedLAMB(lr=1e-3) -> DistributedDataParallel, dropout "
            f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
            f"batch {BERT_LARGE_BATCH} x {BERT_SEQ}")
        batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED),
                            BERT_LARGE_BATCH, BERT_SEQ, DEVICE)
        out = _drive(opt, _bert_step(model, opt, batch), "bert-large", smi,
                     BERT_LARGE_BATCH, "sequences", floor)
        log(f"[bert-large] buckets of the last all-reduce: "
            f"{ddp.last_comm_stats}")
        del model, opt, ddp
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


# -- phase 8 -----------------------------------------------------------------

def _moments(opt):
    """The optimizer's m and v buffers (FusedLAMB keeps them with their
    layout)."""
    m, v = opt.state.m, opt.state.v
    return getattr(m, "buf", m), getattr(v, "buf", v)


def phase_overflow(inner):
    from apex_tpu_torch import amp, models

    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(SEED + 1))
    model, opt = amp.initialize(model, inner, opt_level="O2",
                                half_dtype="float16", verbosity=0)
    assert opt.scaler.dynamic, "fp16 O2 must scale dynamically"
    x, y = _batch(np.random.RandomState(SEED + 2), OVERFLOW_BATCH, IMAGE,
                  1000, DEVICE)
    for _ in range(8):       # until a step is applied: m, v become non-zero
        _train_step(model, opt, x, y)
        if int(opt.state.step) > 0:
            break
    m, v = _moments(opt)
    before = {"masters": opt.masters.buf.clone(), "half": opt.masters.half
              .clone(), "m": m.clone(), "v": v.clone(),
              "step": opt.state.step.clone()}
    scale0 = float(opt.loss_scale())
    x[0, 0, 0, 0] = float("inf")
    loss = _train_step(model, opt, x, y)
    scale1 = float(opt.loss_scale())
    m, v = _moments(opt)
    after = {"masters": opt.masters.buf, "half": opt.masters.half,
             "m": m, "v": v, "step": opt.state.step}
    assert not math.isfinite(float(loss)), "the planted inf did not overflow"
    assert float(opt.last_info["found_inf"]) == 1.0
    assert scale1 == scale0 / 2, f"loss scale {scale0} -> {scale1}"
    for k in before:
        assert torch.equal(before[k], after[k]), f"{k} changed on a skip"
    log(f"[overflow] {type(inner).__name__}, fp16 dynamic: loss "
        f"{float(loss)}, loss scale {scale0} -> {scale1}, masters/half/m/v/"
        f"step bitwise unchanged (step {int(after['step'])})")
    del model, opt
    torch.cuda.empty_cache()


# -- phases 9-11, amp O1 and resume ------------------------------------------

def _o1_dtype_probe(model, batch) -> dict:
    """One forward of ``model.loss`` on two sequences of ``batch``: the
    dtypes each LayerNorm and the flash kernels receive."""
    from apex_tpu_torch import normalization
    from apex_tpu_torch.transformer import attention
    seen = {"layer_norm": set(), "qkv": set()}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen["layer_norm"].add(args[0].dtype))
        for m in model.modules()
        if isinstance(m, normalization.FusedLayerNorm)]
    flash = attention.fa.flash_attention

    def probe(q, k, v, **kw):
        seen["qkv"].update((q.dtype, k.dtype, v.dtype))
        return flash(q, k, v, **kw)

    attention.fa.flash_attention = probe
    try:
        with torch.no_grad():
            model.loss(*(t[:2] for t in batch))
    finally:
        attention.fa.flash_attention = flash
        for h in hooks:
            h.remove()
    return seen


def phase_o1_bert(smi):
    """The BERT path under O1: BertForPretraining(bert_base()) -> O1 +
    FusedAdam(lr 1e-4), bf16, train mode with the config's dropout 0.1,
    32 x 128 tokens."""
    from apex_tpu_torch import amp, models, optimizers
    floor = _mem_floor()
    cfg = models.bert_base()
    model = models.BertForPretraining(
        cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED),
        dropout_generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    try:
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                    opt_level="O1", verbosity=0)
        model.train()
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert not opt.master_weights and opt.masters.half is None, \
            "O1 keeps no masters: the fp32 params are the flat buffer"
        assert not opt.scaler.dynamic and amp.current_loss_scale(opt) == 1.0
        batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED),
                            BERT_BATCH, BERT_SEQ, DEVICE)
        seen = _o1_dtype_probe(model, batch)
        assert seen == {"layer_norm": {torch.float32},
                        "qkv": {torch.bfloat16}}, seen
        log(f"[bert-o1] BertForPretraining(bert_base) O1 FusedAdam(lr=1e-4), "
            f"params fp32 with no masters or half copy, static scale 1.0; "
            f"the LayerNorms receive {sorted(map(str, seen['layer_norm']))}, "
            f"attention q/k/v {sorted(map(str, seen['qkv']))}; batch "
            f"{BERT_BATCH} x {BERT_SEQ}, dropout {cfg.hidden_dropout_prob}")
        out = _drive(opt, _bert_step(model, opt, batch), "bert-o1", smi,
                     BERT_BATCH, "sequences", floor)
        del model, opt
        torch.cuda.empty_cache()
    finally:
        amp.set_policy(amp.NoPolicy())
    return out


def _resnet_o1(seed):
    from apex_tpu_torch import amp, models, optimizers
    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(seed))
    return amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                          opt_level="O1", half_dtype="float16", verbosity=0)


def phase_o1_resnet(smi):
    """The ResNet path under O1 as the reference ran it: ResNet-50 -> O1 +
    FusedAdam(lr 1e-3) in fp16 with the dynamic loss scale from 2**16, at
    batch 128.  Returns the path's results and its model and optimizer."""
    from apex_tpu_torch import amp
    floor = _mem_floor()
    try:
        model, opt = _resnet_o1(SEED)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert not opt.master_weights and opt.masters.half is None
        assert opt.scaler.dynamic and amp.current_loss_scale(opt) == 2 ** 16
        log("[resnet-o1] resnet50 O1 FusedAdam(lr=1e-3), fp16, dynamic "
            "loss scale from 2**16, one card")
        out = _drive(opt, _resnet_step(model, opt), "resnet-o1", smi, BATCH,
                     "images", floor)
        out[2]["amp_stats"] = amp.amp_stats(opt)
        log(f"[resnet-o1] amp_stats {json.dumps(out[2]['amp_stats'])}")
    finally:
        amp.set_policy(amp.NoPolicy())
    return out, model, opt


def _state_of(model, opt) -> dict:
    """Clones of everything a resume restores: the model's state dict, the
    masters, m, v, the step counter and the scalers' fields."""
    from apex_tpu_torch import amp
    out = {"model." + k: v.detach().clone()
           for k, v in model.state_dict().items()}
    out.update({"masters": opt.masters.buf.clone(),
                "m": opt.state.m.clone(), "v": opt.state.v.clone(),
                "step": opt.state.step.clone()})
    for i, sc in enumerate(amp.state_dict(opt)["scalers"]):
        out.update({f"scaler{i}.{k}": t.clone() for k, t in sc.items()})
    return out


def phase_resume(model, opt):
    """Checkpoint the O1 ResNet path's model and optimizer through
    ``torch.save`` into memory, load it into a fresh ResNet-50 and
    optimizer under the same options, and hold the two: every restored
    tensor bitwise, then one more step on each from the same batch with
    the same overflow flag and scaler state and losses within 1e-6."""
    import io
    from apex_tpu_torch import amp
    try:
        buf = io.BytesIO()
        torch.save({"model": model.state_dict(),
                    "optimizer": opt.state_dict(),
                    "amp": amp.state_dict(opt)}, buf)
        size = buf.tell()
        saved = _state_of(model, opt)
        buf.seek(0)
        ck = torch.load(buf, map_location=DEVICE, weights_only=True)
        fresh, fopt = _resnet_o1(SEED + 7)
        fresh.train()
        fresh.load_state_dict(ck["model"])
        fopt.load_state_dict(ck["optimizer"])
        amp.load_state_dict(fopt, ck["amp"])
        loaded = _state_of(fresh, fopt)
        assert loaded.keys() == saved.keys()
        for k in saved:
            assert same(saved[k], loaded[k]), f"resume: {k} differs"
        # the path's own batch
        x, y = _batch(np.random.RandomState(SEED), BATCH, IMAGE, 1000,
                      DEVICE)
        la = float(_train_step(model, opt, x, y))
        lb = float(_train_step(fresh, fopt, x, y))
        fa, fb = (float(o.last_info["found_inf"]) for o in (opt, fopt))
        sa, sb = amp.amp_stats(opt), amp.amp_stats(fopt)
        assert math.isfinite(la) and abs(la - lb) <= 1e-6 * abs(la), \
            f"resume: losses {la} and {lb}"
        assert fa == fb and sa == sb, f"resume: {fa} {sa} against {fb} {sb}"
        log(f"[resume] state dict {size} B ({size / 2**20:.1f} MiB) through "
            f"torch.save; {len(saved)} tensors restored bitwise (model, "
            f"masters, m, v, step, scaler); one more step: losses {la} / "
            f"{lb}, found_inf {fa} / {fb}, amp_stats {json.dumps(sa)}")
        del fresh, fopt, ck
        torch.cuda.empty_cache()
    finally:
        amp.set_policy(amp.NoPolicy())
    return {"bytes": size, "tensors": len(saved), "losses": [la, lb]}


# -- phase 13, the imagenet example --------------------------------------------

IMAGENET_ITERS = 20                 # (a) and (b): one epoch of 20 steps
DEPTH_ITERS = 5                     # (c)
# BatchNorm layers: the stem's, two (BasicBlock) or three (Bottleneck) a
# block, one a downsample (layers 2-4, and layer1's of a Bottleneck)
BN_OF = {"resnet18": 1 + 2 * 8 + 3, "resnet34": 1 + 2 * 16 + 3,
         "resnet50": 1 + 3 * 16 + 4, "resnet101": 1 + 3 * 33 + 4,
         "resnet152": 1 + 3 * 50 + 4}
BLOB_IMAGES, BLOB_VAL = 256, 128    # (d): 256 x 224 x 224 x 3 uint8, 38.5 MB


class _Tee:
    """Writes to the console and keeps a copy (the example's lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _load(*parts):
    """A module of this checkout by its path (a host may have packages of
    the same name, ``tests`` for one)."""
    import importlib.util
    path = Path(__file__).resolve().parent.joinpath(*parts)
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example():
    return _load("examples", "imagenet", "main_amp_torch.py")


def _run_example(example, tag, argv, floor=None):
    """``example.main(argv)`` on the card, with the launch counts set to 0
    just before and read just after; returns its img/s, the counts, its
    printed lines, the peak memory less ``floor`` and the losses it
    printed (all finite)."""
    import contextlib
    import sys
    from apex_tpu_torch import ops
    argv = ["--device", DEVICE] + argv
    log(f"[{tag}] main_amp_torch.main({argv})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    ops.reset_launch_counts()                       # the path starts
    with contextlib.redirect_stdout(tee):
        ips = example.main(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()                    # the path ends
    text = "".join(tee.parts)
    losses = [float(v) for v in re.findall(r"Loss ([-0-9.a-z]+) ", text)]
    assert losses and all(math.isfinite(v) for v in losses), losses
    assert "=> done. avg" in text, text[-2000:]
    peak = None if floor is None else torch.cuda.max_memory_allocated() - floor
    return ips, counts, text, peak, losses


def _trace_breakdown(tag, capture, steps, step_ms):
    """Device time a step by category and the ten kernels that take the
    most, from the chrome trace the example's ``--prof`` window wrote."""
    with open(Path(capture) / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # each kernel's launching operator, through the id they share
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op" and "External id" in e.get("args",
                                                                    {})}
    per_kernel, per_op = Counter(), Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ms = e["dur"] / 1e3 / steps
            per_kernel[e["name"]] += ms
            per_op[op_of.get(e.get("args", {}).get("External id"),
                             "(no operator)")] += ms
    device_ms = sum(per_kernel.values())
    if device_ms == 0:
        log(f"[{tag}] the trace holds no device time: not measured")
        return None
    by_cat = Counter()
    for name, ms in per_kernel.items():
        by_cat[_category(name)] += ms
    log(f"[{tag}] device ms per step {device_ms:.3f} of step_ms "
        f"{step_ms:.3f}: idle share {1 - device_ms / step_ms:.4f} "
        f"({steps} steps profiled by --prof)")
    for cat, ms in by_cat.most_common():
        log(f"[{tag}]   {ms:9.3f} ms  {ms / device_ms:7.2%}  {cat}")
    top = [(_short(n), ms) for n, ms in per_kernel.most_common(10)]
    for name, ms in top:
        log(f"[{tag}]   top kernel {ms:8.3f} ms/step  {name}")
    # cuDNN's own layout transforms around its convolutions
    layout = sum(ms for n, ms in per_kernel.items()
                 if "nchwToNhwc" in n or "nhwcToNchw" in n)
    log(f"[{tag}]   cuDNN layout transforms (nchwToNhwc, nhwcToNchw) "
        f"{layout:.3f} ms/step; {len(per_kernel)} kernels by name")
    for op, ms in per_op.most_common(12):
        log(f"[{tag}]   by launching operator {ms:8.3f} ms/step  {op}")
    return {"device_ms_per_step": device_ms, "step_ms": step_ms,
            "by_category": dict(by_cat), "layout_transform_ms": layout,
            "by_operator": dict(per_op.most_common(12)),
            "top10_ms_per_step": top}


def _imagenet_path(example, smi, tag, argv, profile=False):
    """One run of the example at batch 128 for img/s, step_ms, peak memory
    and launch counts; with ``profile``, a second, short one (12 steps,
    ``--prof`` over the last two) for device time by kernel."""
    floor = _mem_floor()
    ips, counts, _, peak, losses = _run_example(example, tag, argv, floor)
    step_ms = BATCH / ips * 1e3
    log(f"[{tag}] {smi}: img/s {ips:.1f}, step_ms {step_ms:.2f}, "
        f"max_memory_allocated less the floor {peak} B ({peak / 2**30:.2f} "
        f"GiB; floor {floor} B), losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    out = {"img_per_s": ips, "step_ms": step_ms, "peak_bytes": peak,
           "floor_bytes": floor, "losses": losses}
    if profile:
        from apex_tpu_torch.utils import profiler
        _run_example(example, tag + "-prof", argv + ["--iters", "12",
                                                     "--prof"])
        out["profile"] = _trace_breakdown(tag, profiler.last_capture_dir(),
                                          2, step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def _stem_check(example, ckpt_dir, x):
    """The conv7 -> space-to-depth conversion of the example's resume on
    the card, from the checkpoint in ``ckpt_dir``: (1) in fp32, the
    checkpoint's own conv7 model and the converted model give the same
    train-mode logits on ``x`` to rounding (1e-5 in norm); (2) under O2,
    both models restored by the example's resume (the same bf16 weights),
    the converted model's logits lie no further from the conv7 model's
    than twice the conv7 model's own move when ``x`` moves by one ulp
    (bf16 rounds each layer's output: that move is the noise floor).
    Returns the three distances."""
    from apex_tpu_torch import amp, models, optimizers
    from apex_tpu_torch.utils import checkpoint

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    m7 = models.resnet18(device=DEVICE)
    m7.load_state_dict(checkpoint.restore_checkpoint(
        ckpt_dir, {"model": m7.state_dict()})["model"])
    out = {}
    for level, stem in (("O0", "space_to_depth"), ("O2", "conv7"),
                        ("O2", "space_to_depth")):
        model, opt = amp.initialize(
            models.resnet18(stem=stem, device=DEVICE),
            optimizers.SGD(lr=0.1), opt_level=level, verbosity=0)
        assert example.resume_state(ckpt_dir, model, opt, stem) == 2
        out[level, stem] = model.train()
    xp = torch.nextafter(x, torch.full_like(x, math.inf))
    with torch.no_grad():
        fp32 = rel(out["O0", "space_to_depth"](x), m7.train()(x))
        l7 = out["O2", "conv7"](x)
        half = rel(out["O2", "space_to_depth"](x), l7)
        spread = rel(out["O2", "conv7"](xp), l7)
    assert fp32 <= 1e-5, f"fp32: s2d logits {fp32} from conv7's"
    assert half <= 2 * spread, f"O2: s2d logits {half}, spread {spread}"
    return {"fp32": fp32, "o2": half, "o2_one_ulp_spread": spread}


def _short(kernel: str) -> str:
    """A kernel's name without its namespaces and argument list."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "binary_internal::", "cudnn::engines_precompiled::"):
        kernel = kernel.replace(noise, "")
    cut = kernel.rfind(">(")
    return (kernel[:cut + 1] if cut > 0 else kernel)[:200]


def phase_imagenet(smi):
    """The port's user entry point, examples/imagenet/main_amp_torch.py, on
    the card at batch 128, 3 x 224 x 224, O2, synthetic data unless said:
    (a) resnet50 + FusedAdam, NCHW; (b) the same channels-last with the
    space-to-depth stem; (c) resnet34, resnet101 and resnet152 with SGD;
    (d) a uint8 NHWC blob through the native DataLoader, channels-last;
    (e) resnet18 checkpointed over two epochs, then resumed into the
    space-to-depth stem.  Returns each run's launch counts and results."""
    import tempfile
    example = _example()
    counts, results = {}, {}
    adam = ["-b", str(BATCH), "--image-size", str(IMAGE), "--fused-adam",
            "--lr", "1e-3", "--iters", str(IMAGENET_ITERS)]
    counts["a"], results["a"] = _imagenet_path(
        example, smi, "imagenet-a", ["--arch", "resnet50"] + adam,
        profile=True)
    counts["b"], results["b"] = _imagenet_path(
        example, smi, "imagenet-b", ["--arch", "resnet50", "--channels-last",
                                     "--stem", "space_to_depth"] + adam,
        profile=True)
    for arch in ("resnet34", "resnet101", "resnet152"):
        counts[arch], results[arch] = _imagenet_path(
            example, smi, f"imagenet-c-{arch}",
            ["--arch", arch, "-b", str(BATCH), "--image-size", str(IMAGE),
             "--iters", str(DEPTH_ITERS)])
    with tempfile.TemporaryDirectory() as tmp:
        rs = np.random.RandomState(SEED)
        blob = Path(tmp) / "blob.npz"
        np.savez(blob, images=rs.randint(
            0, 256, (BLOB_IMAGES, IMAGE, IMAGE, 3)).astype(np.uint8),
            labels=rs.randint(0, 1000, BLOB_IMAGES),
            val_images=rs.randint(0, 256, (BLOB_VAL, IMAGE, IMAGE, 3))
            .astype(np.uint8), val_labels=rs.randint(0, 1000, BLOB_VAL))
        # two batches an epoch: five epochs make ten iterations
        ips, counts["d"], text, _, losses = _run_example(
            example, "imagenet-d",
            ["--arch", "resnet50", "-b", str(BATCH), "--data", str(blob),
             "--channels-last", "--epochs", "5", "--iters", "10"])
        assert "=> native data loader: True (2 batches/epoch)" in text, \
            "the DataLoader did not take the native ring on this host"
        assert len(re.findall(r"\* Prec@1 ", text)) == 5, text[-2000:]
        results["d"] = {"img_per_s": ips, "losses": losses, "native": True}
        log(f"[imagenet-d] {BLOB_IMAGES} uint8 NHWC images "
            f"({blob.stat().st_size} B npz) through the native DataLoader: "
            f"img/s {ips:.1f} over 10 iterations")
    counts["e-save"], counts["e-resume"], results["e"] = \
        _imagenet_resume(example)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, results


def _imagenet_resume(example):
    """(e): resnet18 checkpointed over two epochs of three iterations,
    then resumed into the space-to-depth stem (the conv7 -> s2d
    conversion); the converted model's first-batch logits held against
    the conv7 model's (``_stem_check``)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck")
        base = ["--arch", "resnet18", "-b", str(BATCH), "--image-size",
                str(IMAGE), "--iters", "3", "--checkpoint-dir", ck]
        _, save, _, _, _ = _run_example(example, "imagenet-e",
                                        base + ["--epochs", "2"])
        # the first batch of the synthetic data, as the example draws it
        x = torch.from_numpy(np.random.RandomState(0).randn(
            BATCH, 3, IMAGE, IMAGE).astype(np.float32)).to(DEVICE)
        stem = _stem_check(example, ck, x)
        _, resume, text, _, _ = _run_example(
            example, "imagenet-e-resume",
            base + ["--epochs", "3", "--resume", "--stem", "space_to_depth"])
        assert "converting" in text and "resumed from epoch 2" in text
    log(f"[imagenet-e] resnet18 conv7 checkpoint -> space_to_depth, "
        f"first-batch logits in train mode, distance in norm: fp32 "
        f"{stem['fp32']:.3e} (<= 1e-5), O2 {stem['o2']:.3e} (<= 2 x the "
        f"conv7 model's one-ulp spread {stem['o2_one_ulp_spread']:.3e}); "
        f"the resume trained epoch 3")
    return save, resume, stem


# -- phase 14, L1 -------------------------------------------------------------

L1_ITERS, L1_BATCH, L1_IMAGE = 50, 16, 32


def phase_l1():
    """tests/L1/run_l1_torch.py's matrix on the card: ResNet-18 under the
    48 amp configs, each twice (bitwise the same), the O0 ones also on the
    CPU (within the tolerance that file states)."""
    l1 = _load("tests", "L1", "run_l1_torch.py")
    t0 = time.time()
    _, summary = l1.run(l1.FULL_MATRIX, DEVICE, L1_ITERS, L1_BATCH,
                        L1_IMAGE, log=lambda line: log(f"[l1] {line}"))
    summary["wall_s"] = time.time() - t0
    log("l1 " + json.dumps(summary))
    assert summary["total"] == len(l1.FULL_MATRIX) == 48
    assert not summary["failures"], summary["failures"]
    return summary


# -- phase 15, the captured step ---------------------------------------------

CAPTURE_HOLD = 8                    # steps held bitwise, graph against eager
CAPTURE_TIMED = 10                  # steps timed after them


def _flat_state(tree, prefix=""):
    """(name, tensor) pairs of a nested dict or list of tensors."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        if v is not None:
            out += _flat_state(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _snapshot(model, opt, gens):
    """Clones of a path's whole training state: the optimizer's state dict
    (masters, moments, step counter, scalers), the half copy, the model's
    buffers (BatchNorm's running statistics) and the generators' states."""
    return {"opt": {k: v.clone() for k, v in _flat_state(opt.state_dict())},
            "half": (None if opt.masters.half is None
                     else opt.masters.half.clone()),
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "gens": [g.get_state() for g in gens],
            "offsets": [g.get_offset() for g in gens]}


def _restore(model, opt, gens, snap):
    """Write ``snap`` back in place (a captured step keeps its addresses):
    the optimizer through ``load_state_dict``, buffers and generators by
    copy."""
    sd, flat = opt.state_dict(), snap["opt"]
    with torch.no_grad():
        for name, t in _flat_state(sd):
            t.copy_(flat[name])
        if snap["half"] is not None:
            opt.masters.half.copy_(snap["half"])
        for k, b in model.named_buffers():
            b.copy_(snap["buffers"][k])
    for g, st in zip(gens, snap["gens"]):
        g.set_state(st)


def _held(tag, a, b):
    """Two snapshots bitwise the same: every tensor and generator offset."""
    for part in ("opt", "buffers"):
        for k in a[part]:
            assert same(a[part][k], b[part][k]), f"[{tag}] {part} {k} differs"
    assert a["half"] is None or same(a["half"], b["half"]), f"[{tag}] half"
    assert a["offsets"] == b["offsets"], \
        f"[{tag}] generator offsets {a['offsets']} and {b['offsets']}"
    return len(a["opt"]) + len(a["buffers"]) + (a["half"] is not None)


def _timed(fn, n):
    """Host time of each of ``n`` calls of ``fn``, each ended by a
    synchronize; returns their outputs and the times (ms)."""
    outs, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _replay_ms(train) -> float:
    """Device time of one replay of ``train``'s graph, between CUDA events
    (the graph's kernels back to back: no host gaps to wait for).  Runs
    steps outside ``train``, so only after its counts were read."""
    return time_ms(train.graph.replay, reps=5)


def _captured_path(tag, model, opt, step_fn, batch, per_step, smi, items,
                   gens=(), ks=(1,), make=None):
    # items: (count, unit) of one step's batch
    """A path's functional step held and timed: from one state, the step
    run eagerly (``CAPTURE_HOLD + CAPTURE_TIMED`` steps) and through
    ``make(step_fn, K)`` for each K of ``ks`` (a CUDA graph of K steps a
    call): losses, the whole state and the generators' offsets bitwise
    the eager run's after as many steps; launch counts exact (``per_step``
    a step) over the graph's calls; step_ms eager against graph, the
    graph's device time (profiler and CUDA events), idle share, launches
    a step and peak memory.  Returns the launch counts of each K."""
    from apex_tpu_torch import ops, parallel
    if make is None:
        def make(fn, k):
            return parallel.make_step(fn, model, steps_per_call=k)
    s0 = _snapshot(model, opt, gens)
    # calls of a K-step graph held against the eager run: at least 3 (the
    # warm-up, the capture, one more replay), CAPTURE_HOLD steps for K = 1
    held = {k: max(CAPTURE_HOLD // k, 3) for k in ks}
    marks = {c * k for k, c in held.items()}
    n_eager = max(marks) + CAPTURE_TIMED
    eager, digests, ms = [], {}, []
    for i in range(n_eager):
        if i == n_eager - CAPTURE_TIMED:
            # the eager step's own memory, over the timed steps (the held
            # snapshots already allocated below the floor)
            eager_floor = _mem_floor()
            torch.cuda.reset_peak_memory_stats()
        (loss,), (t,) = _timed(lambda: step_fn(batch), 1)
        eager.append(loss.float().reshape(()).clone())
        ms.append(t)
        if i + 1 in marks:
            digests[i + 1] = _snapshot(model, opt, gens)
    eager_ms = statistics.median(ms[-CAPTURE_TIMED:])
    eager_peak = torch.cuda.max_memory_allocated() - eager_floor
    vals = [float(v) for v in eager]
    assert all(math.isfinite(v) for v in vals), f"[{tag}] losses {vals}"
    assert vals[CAPTURE_HOLD - 1] < vals[0], f"[{tag}] loss did not fall"
    log(f"[{tag}] {smi}: eager functional step, {n_eager} steps: losses "
        f"{['%.4f' % v for v in vals[:CAPTURE_HOLD]]}..., step_ms median "
        f"{eager_ms:.2f} over the last {CAPTURE_TIMED}, peak above the "
        f"state {eager_peak} B ({eager_peak / 2**30:.2f} GiB)")
    n, unit = items
    out = {"eager_step_ms": eager_ms, f"eager_{unit}_per_s":
           n / eager_ms * 1e3, "eager_peak_bytes": eager_peak,
           "eager_losses": vals, "graphs": {}}
    counts = {}
    for k in ks:
        _restore(model, opt, gens, s0)
        floor = _mem_floor()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        stacked = batch if k == 1 else tuple(
            t.unsqueeze(0).expand(k, *t.shape).contiguous() for t in batch)
        ops.reset_launch_counts()                   # the graph's calls start
        train = make(step_fn, k)
        calls = held[k]
        got, call_ms = _timed(lambda: train(stacked), calls)
        torch.cuda.synchronize()
        got = torch.cat([g.float().reshape(-1) for g in got])
        want = torch.stack(eager[:calls * k])
        assert same(got, want), \
            f"[{tag}] K={k}: losses {got.tolist()} against eager " \
            f"{want.tolist()}"
        n_held = _held(f"{tag} K={k}", digests[calls * k],
                       _snapshot(model, opt, gens))
        assert train.replays == calls - 1, train.replays
        more, tms = _timed(lambda: train(stacked), CAPTURE_TIMED)
        peak = torch.cuda.max_memory_allocated() - floor
        # what the graph keeps: its private pool (reserved, not released by
        # empty_cache while the graph lives), static batch and outputs
        _mem_floor()                                # empty_cache
        held_bytes = torch.cuda.memory_reserved() - reserved
        got_counts = ops.launch_counts()            # the graph's calls end
        steps = (calls + CAPTURE_TIMED) * k
        counts[k] = (got_counts, {name: c * steps
                                  for name, c in per_step.items()})
        step_ms = statistics.median(tms) / k
        assert all(math.isfinite(float(v)) for m in more
                   for v in m.reshape(-1)), f"[{tag}] K={k} non-finite"
        replay = _replay_ms(train) / k
        log(f"[{tag}] K={k}: {calls} calls ({calls * k} steps) captured "
            f"and replayed, losses and {n_held} state tensors bitwise the "
            f"eager run's, generator offsets {s0['offsets']} -> "
            f"{digests[calls * k]['offsets']} alike; {steps} steps in all; "
            f"{unit}/s {n / step_ms * 1e3:.1f}; step_ms median "
            f"{step_ms:.2f} over "
            f"{CAPTURE_TIMED} calls (eager {eager_ms:.2f}); one replay "
            f"{replay:.2f} ms a step by CUDA events; peak above the state "
            f"{peak} B ({peak / 2**30:.2f} GiB; eager "
            f"{eager_peak / 2**30:.2f}), held by the graph (its pool, "
            f"static batch and outputs) {held_bytes} B "
            f"({held_bytes / 2**30:.2f} GiB); capture in call 2 took "
            f"{call_ms[1]:.0f} ms")
        by_cat = phase_profile(lambda: train(stacked), step_ms,
                               tag=f"{tag}-graph-K{k}-profile", steps=2,
                               per=k)
        out["graphs"][k] = {"step_ms": step_ms, "replay_ms": replay,
                            "peak_bytes": peak, "held_bytes": held_bytes,
                            f"{unit}_per_s": n / step_ms * 1e3,
                            "profile_ms": by_cat,
                            "capture_call_ms": call_ms[1]}
        del train
        gc.collect()
        torch.cuda.empty_cache()
    return counts, out


def _resnet_functional(net, opt, ddp=None):
    """The JAX example's step (examples/imagenet/main_amp.py:240-262):
    grads of the scaled loss, reduced over the group, the functional
    optimizer step.  Returns the loss."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.nn.functional import cross_entropy

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: cross_entropy(net(x), y), opt)
        if ddp is not None:
            grads = ddp.allreduce_grads(grads)
        opt.step(grads)
        return loss
    return step


def phase_captured(smi):
    """Phase 15: the functional step captured whole in a CUDA graph on the
    three main paths, held bitwise against the same step run eagerly, and
    an fp16 overflow inside a replay.  cuDNN runs deterministic here (its
    other algorithms may sum in another order from run to run, and the
    check is bitwise)."""
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counts, results = {}, {}
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    try:
        for name, path in (("a", _captured_resnet), ("b", _captured_bert),
                           ("c", _captured_bert_large)):
            counts[name], results[name] = path(smi)
    finally:
        dist.destroy_process_group()
    results["overflow"] = _captured_overflow()
    torch.backends.cudnn.deterministic = det
    log("captured " + json.dumps(results))
    return counts, results


def _captured_resnet(smi):
    """(a) ResNet-50 -> SyncBN -> O2 + FusedAdam -> DDP, batch 128, K = 1
    and 4 (the JAX bench headline's steps_per_call)."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    model = parallel.convert_syncbn_model(models.resnet50(
        device=DEVICE, generator=torch.Generator().manual_seed(SEED)))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    batch = _batch(np.random.RandomState(SEED), BATCH, IMAGE, 1000, DEVICE)
    log(f"[captured-a] resnet50 -> convert_syncbn_model -> O2 FusedAdam -> "
        f"DistributedDataParallel ({dist.get_backend()} group of "
        f"{dist.get_world_size()}), batch {BATCH}: scaled_grad, "
        f"allreduce_grads(grads), step(grads) through ddp.make_step")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "syncbn_fwd": BN_LAYERS,
           "syncbn_bwd": BN_LAYERS}
    out = _captured_path(
        "captured-a", model, opt, _resnet_functional(ddp, opt, ddp), batch,
        per, smi, (BATCH, "images"), ks=(1, 4),
        make=lambda fn, k: ddp.make_step(fn, steps_per_call=k))
    del model, opt, ddp, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _bert_model(cfg, opt):
    from apex_tpu_torch import amp, models
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = models.BertForPretraining(
        cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED),
        dropout_generator=gen)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0)
    model.train()
    return model, opt, gen


def _captured_bert(smi):
    """(b) BERT-base O2 + FusedAdam, dropout 0.1, 32 x 128 as two
    micro-batches of 16 through scaled_grad_accum, K = 1."""
    from apex_tpu_torch import amp, models, optimizers
    cfg = models.bert_base()
    model, opt, gen = _bert_model(cfg, optimizers.FusedAdam(lr=1e-4))
    ids, labels, nsp = _bert_batch(cfg.vocab_size,
                                   np.random.RandomState(SEED), BERT_BATCH,
                                   BERT_SEQ, DEVICE)
    batch = tuple(t.reshape(2, BERT_BATCH // 2, *t.shape[1:])
                  for t in (ids, labels, nsp))

    def step(b):
        loss, grads = amp.scaled_grad_accum(
            lambda mb: model.loss(*mb), opt, b)
        opt.step(grads)
        return loss
    log(f"[captured-b] BertForPretraining(bert_base) O2 FusedAdam, dropout "
        f"{cfg.hidden_dropout_prob}, {BERT_BATCH} x {BERT_SEQ} as 2 "
        f"micro-batches of {BERT_BATCH // 2}: scaled_grad_accum, step(grads)")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "layer_norm_fwd": 2 * LN_PER_PASS,
           "layer_norm_bwd": 2 * LN_PER_PASS,
           "flash_fwd": 2 * FLASH_PER_PASS, "flash_dq": 2 * FLASH_PER_PASS,
           "flash_dkv": 2 * FLASH_PER_PASS}
    out = _captured_path("captured-b", model, opt, step, batch, per, smi,
                         (BERT_BATCH, "sequences"), gens=[gen])
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _captured_bert_large(smi):
    """(c) BERT-large O2 + FusedLAMB -> DDP, dropout 0.1, 8 x 128, K = 1."""
    from apex_tpu_torch import amp, models, optimizers, parallel
    cfg = models.bert_large()
    model, opt, gen = _bert_model(cfg, optimizers.FusedLAMB(lr=1e-3))
    ddp = parallel.DistributedDataParallel(model)
    batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED),
                        BERT_LARGE_BATCH, BERT_SEQ, DEVICE)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(*b), opt)
        opt.step(ddp.allreduce_grads(grads))
        return loss
    log(f"[captured-c] BertForPretraining(bert_large) O2 FusedLAMB -> "
        f"DistributedDataParallel, dropout {cfg.hidden_dropout_prob}, "
        f"{BERT_LARGE_BATCH} x {BERT_SEQ}: scaled_grad, "
        f"allreduce_grads(grads), step(grads)")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "lamb_stage1": 1, "lamb_stage2": 1,
           "multi_tensor_l2norm_per_tensor": 3,
           "layer_norm_fwd": LARGE_LN_PER_PASS,
           "layer_norm_bwd": LARGE_LN_PER_PASS,
           "flash_fwd": LARGE_FLASH_PER_PASS,
           "flash_dq": LARGE_FLASH_PER_PASS,
           "flash_dkv": LARGE_FLASH_PER_PASS}
    out = _captured_path("captured-c", model, opt, step, batch, per, smi,
                         (BERT_LARGE_BATCH, "sequences"), gens=[gen],
                         make=lambda fn, k: ddp.make_step(fn, k))
    del model, opt, ddp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _captured_overflow():
    """ResNet-50 O2 in fp16 (dynamic scale) through make_step: an inf in
    the input of a replayed step skips it (loss scale halved; masters,
    half copy, m, v and step counter bitwise), and the next replay scales
    its loss by the halved scale."""
    from apex_tpu_torch import amp, models, optimizers, parallel
    from apex_tpu_torch.nn.functional import cross_entropy
    model = models.resnet50(device=DEVICE,
                            generator=torch.Generator().manual_seed(SEED + 1))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", half_dtype="float16",
                                verbosity=0)
    assert opt.scaler.dynamic, "fp16 O2 must scale dynamically"
    x, y = _batch(np.random.RandomState(SEED + 2), OVERFLOW_BATCH, IMAGE,
                  1000, DEVICE)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")

    def step(b):
        used = opt.scalers[0].loss_scale.clone()
        loss, grads = amp.scaled_grad(lambda: cross_entropy(model(b[0]),
                                                            b[1]), opt)
        info = opt.step(grads)
        return loss, used, info["found_inf"]
    train = parallel.make_step(step, model)
    for _ in range(8):       # until a replay applied a step
        train((x, y))
        if train.replays and int(opt.state.step) > 0:
            break
    m, v = _moments(opt)
    before = {"masters": opt.masters.buf.clone(), "half": opt.masters.half
              .clone(), "m": m.clone(), "v": v.clone(),
              "step": opt.state.step.clone()}
    scale0 = float(opt.loss_scale())
    replays = train.replays
    loss, used, found = train((bad, y))
    assert train.replays == replays + 1, "the overflow step was not a replay"
    assert not math.isfinite(float(loss)) and float(found) == 1.0
    assert float(used) == scale0, (float(used), scale0)
    scale1 = float(opt.loss_scale())
    assert scale1 == scale0 / 2, f"loss scale {scale0} -> {scale1}"
    m, v = _moments(opt)
    after = {"masters": opt.masters.buf, "half": opt.masters.half,
             "m": m, "v": v, "step": opt.state.step}
    for k in before:
        assert same(before[k], after[k]), f"{k} changed on a skip"
    loss2, used2, found2 = train((x, y))
    assert float(used2) == scale1, \
        f"the next replay scaled by {float(used2)}, not {scale1}"
    log(f"[captured-overflow] fp16 ResNet-50 O2 through make_step, batch "
        f"{OVERFLOW_BATCH}: an inf in replay {replays + 1} skipped the step "
        f"(loss {float(loss)}, found_inf 1), loss scale {scale0} -> "
        f"{scale1}, masters/half/m/v/step bitwise; the next replay scaled "
        f"by {float(used2)} (loss {float(loss2):.4f}, found_inf "
        f"{float(found2)})")
    del model, opt, train
    gc.collect()
    torch.cuda.empty_cache()
    return {"scale": [scale0, scale1, float(used2)],
            "overflow_replay": replays + 1}


def _check_counts(tag: str, counts, expect) -> None:
    """Each wrapper launched exactly as often as the path needs it, and the
    wrappers of other paths not at all."""
    log(f"kernels {tag} {json.dumps(counts)}")
    for k, c in counts.items():
        assert c == expect.get(k, 0), \
            f"{tag}: {k} launched {c} times, expected {expect.get(k, 0)}"


def _check_captured_counts(counts) -> None:
    """Phase 15's graphs: each path's launches over its captured calls,
    the launches of one step times the steps replayed and run."""
    for path, by_k in counts.items():
        for k, (got, expect) in by_k.items():
            _check_counts(f"captured-{path}-K{k}", got, expect)


# 12 whole steps and two steps of two micro-batches: 14 optimizer steps,
# 16 backward passes (the scale kernel on the first of a step, axpby on
# the second)
PASSES = 16
OPT_COUNTS = {"multi_tensor_scale": 14, "multi_tensor_axpby": 2,
              "multi_tensor_l2norm": 14, "fused_adam": 14}
RESNET_COUNTS = dict(OPT_COUNTS, syncbn_fwd=BN_LAYERS * PASSES,
                     syncbn_bwd=BN_LAYERS * PASSES)
BERT_COUNTS = dict(OPT_COUNTS, layer_norm_fwd=LN_PER_PASS * PASSES,
                   layer_norm_bwd=LN_PER_PASS * PASSES,
                   flash_fwd=FLASH_PER_PASS * PASSES,
                   flash_dq=FLASH_PER_PASS * PASSES,
                   flash_dkv=FLASH_PER_PASS * PASSES)
# BERT-large: 24 layers of 16 heads, 50 LayerNorms a pass (the embeddings',
# two a layer, the MLM head's); a LAMB step runs the per-tensor l2norm on
# the grads, the params and the update
LARGE_LN_PER_PASS, LARGE_FLASH_PER_PASS = 50, 24
BERT_LARGE_COUNTS = dict(
    OPT_COUNTS, fused_adam=0, lamb_stage1=14, lamb_stage2=14,
    multi_tensor_l2norm_per_tensor=3 * 14,
    layer_norm_fwd=LARGE_LN_PER_PASS * PASSES,
    layer_norm_bwd=LARGE_LN_PER_PASS * PASSES,
    flash_fwd=LARGE_FLASH_PER_PASS * PASSES,
    flash_dq=LARGE_FLASH_PER_PASS * PASSES,
    flash_dkv=LARGE_FLASH_PER_PASS * PASSES)


# phase 13: a run of the example on the card takes two warm-up steps (the
# first eager, the second captures its CUDA graph) and then its
# iterations, each one backward pass; AmpOptimizer.step runs the l2norm (the
# grad norm) every step, the scale kernel unscales every pass, FusedAdam's
# kernel runs a step and SGD none; the syncbn kernels run at every NCHW
# BatchNorm of a pass, and the NHWC models (b, d) take the plain route
def _example_counts(steps, bn_layers=0, adam=False):
    out = {"multi_tensor_scale": steps, "multi_tensor_l2norm": steps}
    if adam:
        out["fused_adam"] = steps
    if bn_layers:
        out.update(syncbn_fwd=bn_layers * steps, syncbn_bwd=bn_layers * steps)
    return out


EXAMPLE_WARMUP = 2
EXAMPLE_COUNTS = {
    "a": _example_counts(EXAMPLE_WARMUP + IMAGENET_ITERS, BN_OF["resnet50"],
                         adam=True),
    "b": _example_counts(EXAMPLE_WARMUP + IMAGENET_ITERS, adam=True),
    "resnet34": _example_counts(EXAMPLE_WARMUP + DEPTH_ITERS,
                                BN_OF["resnet34"]),
    "resnet101": _example_counts(EXAMPLE_WARMUP + DEPTH_ITERS,
                                 BN_OF["resnet101"]),
    "resnet152": _example_counts(EXAMPLE_WARMUP + DEPTH_ITERS,
                                 BN_OF["resnet152"]),
    "d": _example_counts(EXAMPLE_WARMUP + 10),
    "e-save": _example_counts(EXAMPLE_WARMUP + 2 * 3, BN_OF["resnet18"]),
    "e-resume": _example_counts(EXAMPLE_WARMUP + 3, BN_OF["resnet18"]),
}


# O1 launches each wrapper as often as O2 on the same model: the policy
# casts around the kernels, and Adam runs with no half copy
BERT_O1_COUNTS = BERT_COUNTS
RESNET_O1_COUNTS = RESNET_COUNTS
# the variant rows of phase 3, by the O1 path that runs them
O1_ROWS = {"fused_adam:no_half": "resnet_o1", "layer_norm_fwd:fp32":
           "bert_o1", "layer_norm_bwd:fp32": "bert_o1",
           "syncbn_fwd:fp16": "resnet_o1", "syncbn_bwd:fp16": "resnet_o1"}


def main():
    t0 = time.time()
    name, smi = phase_device()
    import apex_tpu_torch  # noqa: F401  (fails outside the repository)
    uncapped, logs = phase_build()
    rows = phase_kernels()
    rows.update(phase_syncbn())
    rows.update(phase_layer_norm(ptxas_resources(logs.get("layer_norm",
                                                          ""))))
    rows.update(phase_flash(uncapped))
    rows.update(phase_lamb())
    log(f"[time] phases 1-3 done at {time.time() - t0:.1f} s")
    counts_train, _, train = phase_train(smi)
    phase_reference()
    counts_ddp, _, ddp = phase_ddp(smi)
    counts_bert, _, bert = phase_bert(smi)
    from apex_tpu_torch import optimizers
    phase_bert_reference(lambda lr: optimizers.FusedAdam(lr=lr), 1e-4)
    phase_bert_reference(lambda lr: optimizers.FusedLAMB(lr=lr), 1e-3)
    counts_large, _, large = phase_bert_large(smi)
    phase_overflow(optimizers.FusedAdam(lr=1e-3))
    phase_overflow(optimizers.FusedLAMB(lr=1e-3))
    # O1 after every O2 phase: those ran under no cast policy
    counts_bert_o1, _, bert_o1 = phase_o1_bert(smi)
    (counts_resnet_o1, _, resnet_o1), model, opt = phase_o1_resnet(smi)
    resume = phase_resume(model, opt)
    del model, opt
    torch.cuda.empty_cache()
    log(f"[time] phases 1-11 done at {time.time() - t0:.1f} s")
    counts_imagenet, imagenet = phase_imagenet(smi)
    log(f"[time] phase 13 done at {time.time() - t0:.1f} s")
    l1 = phase_l1()
    log(f"[time] phase 14 done at {time.time() - t0:.1f} s")
    counts_captured, captured = phase_captured(smi)
    log(f"[time] phase 15 done at {time.time() - t0:.1f} s")

    _check_counts("train", counts_train, RESNET_COUNTS)
    _check_counts("ddp", counts_ddp, RESNET_COUNTS)
    _check_counts("bert", counts_bert, BERT_COUNTS)
    _check_counts("bert-large", counts_large, BERT_LARGE_COUNTS)
    _check_counts("bert-o1", counts_bert_o1, BERT_O1_COUNTS)
    _check_counts("resnet-o1", counts_resnet_o1, RESNET_O1_COUNTS)
    for run, expect in EXAMPLE_COUNTS.items():
        _check_counts(f"imagenet-{run}", counts_imagenet[run], expect)
    _check_captured_counts(counts_captured)
    variants = {k: rows.pop(k) for k in list(rows) if ":" in k}
    o1_counts = {"bert_o1": counts_bert_o1, "resnet_o1": counts_resnet_o1}
    for k, row in variants.items():
        row["variant"] = k
        row["launches"] = o1_counts[O1_ROWS[k]][row["name"]]
    # each row's launches from the path that runs it: the optimizer
    # kernels from the single-card ResNet path, syncbn from the DDP path,
    # LayerNorm and flash from the BERT-base path (the shapes of their
    # rows), LAMB and the per-tensor l2norm from the BERT-large path
    path_of = dict.fromkeys(OPT_COUNTS, counts_train)
    path_of.update(syncbn_fwd=counts_ddp, syncbn_bwd=counts_ddp,
                   lamb_stage1=counts_large, lamb_stage2=counts_large,
                   multi_tensor_l2norm_per_tensor=counts_large)
    for k in rows:
        rows[k]["launches"] = path_of.get(k, counts_bert)[k]
    log(json.dumps({"train": train, "ddp": ddp, "bert": bert,
                    "bert_large": large, "bert_o1": bert_o1,
                    "resnet_o1": resnet_o1, "resume": resume,
                    "imagenet": imagenet, "l1": l1, "captured": captured,
                    "card": smi}))
    log("kernels_o1 " + json.dumps({"kernels": list(variants.values())}))
    log(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--captured"]:
        # python3 chip_smoke.py --captured: phases 1, 2 and 15 alone
        _, smi = phase_device()
        phase_build()
        _check_captured_counts(phase_captured(smi)[0])
    elif sys.argv[1:2] == ["--layer-norm-ab"]:
        # python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT
        phase_device()
        phase_build()
        parent_ops = load_ops(sys.argv[2])
        parent_ops._build.build_all(["layer_norm"])
        phase_layer_norm_ab(parent_ops)
    else:
        main()
