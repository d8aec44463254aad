#!/usr/bin/env python3
"""Smoke run of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --captured
    python3 chip_smoke.py --decoder
    python3 chip_smoke.py --decoder-tail
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --dp
    python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT

The second form runs phases 1, 2 and 15 alone, the third phases 1, 2 and
16 (with 16's launch-count checks), the fourth phases 1, 2 and 17, the
fifth 1, 2 and 18, the sixth 1, 2 and 19.  The last builds the
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
12. counts  (checked last, after 13 to 17) each path launched each
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
16. decoder  the decoder families.  The flash kernels causal at the
            decoder lengths: GPT-2 small's (8, 12, 1024, 64) bf16 with
            dropout 0.1 and TinyLlama's (4, 32, 2048, 64) (its fp64 and
            plain-version check at one sequence: the plain version's
            scores are 2 GiB a tensor at four), each output within
            phase 3's fp64 bound, each kernel twice bitwise, timed against
            the plain versions and SDPA (is_causal=True), the bound
            counting the causal half; the LayerNorm kernels at GPT-2's
            (8192, 768) rows, likewise.  Then GPT-2 small (dropout 0.1) at
            8 x 1024 and a Llama at TinyLlama-1.1B's published widths (22
            layers, 2048 wide, 32 heads, 4 KV heads, vocab 32000, untied)
            at 4 x 2048, random weights from seed 0, ids below 1000, each
            under O2 + FusedAdam(lr 1e-4) through make_step, held as phase
            15 holds its paths (TinyLlama's snapshots in host memory),
            the profile of the replayed graph showing the port's attention
            (and for GPT-2 LayerNorm) kernels; then greedy generation of
            64 tokens from four prompts of 16 to 57 tokens: on the trained
            bf16 model generate_cached with a bf16 cache (chunked prefill)
            and an int8 cache, their agreement with the uncached loop
            reported; on the same weights in fp32, generate_cached
            (chunked and step prefill) exactly the uncached loop's tokens
            (GPT.generate; for Llama a full forward a token).  Last, the
            examples as a user runs them, 10 iterations each:
            examples/gpt/main_amp_torch.py --config small --stdlib-corpus 1
            --generate 64, the same with --arch llama --n-kv-head 4,
            examples/bert/main_amp_torch.py --config base -b 32 and
            --config large --optimizer lamb -b 8, each with exact launch
            counts.  The phase's kernel rows print as the
            "kernels_decoder" line.
17. decoder-tail  the rest of the decoder families, random weights from
            seed 0.  T5 at google-t5/t5-base's published widths (12 + 12
            layers, 768 wide, vocab 32128, relu, tied) under O2 +
            FusedAdam(lr 1e-4) at 16 x (512 -> 128) tokens through
            make_step, held as phase 15 holds its paths (its attention
            never reaching the dispatch), then greedy generation of 32
            tokens from four sources of valid lengths 512 to 97: fp32
            exactly an uncached argmax loop over forward, bf16's agreement
            reported.  The optimizer kernels at T5-base's flat length, the
            flash forward causal with a key-padding mask at beam search's
            (16, 12, 96, 64) in bf16 and fp32 and the LayerNorm forward at
            a decode step's (4, 768), each against fp64 and the plain
            version, timed.  LoRA on the Llama at TinyLlama-1.1B's widths
            (phase 16's): a frozen bf16 base, rank-8 alpha-16 adapters on
            q_proj and v_proj under O2 + FusedAdam(lr 1e-3) at 4 x 2048,
            the loss on merged weights through functional_call, through
            make_step and held likewise, the base bitwise unchanged; the
            base through llama_to_hf and llama_from_hf (a duck-typed
            stand-in for the HF model), bitwise.  Decoding at GPT-2
            small's widths with distilgpt2's (6 layers) as the draft, four
            prompts of 16 to 57 tokens, 32 new tokens: beam search (4
            beams; 1 beam exactly greedy generate in fp32, 4 beams' score
            at least greedy's, no host read), speculative decoding (gamma
            4, cached and full verify, exactly the target's greedy tokens
            in fp32, also with draft = target; sampling at temperature
            0.8), acceptance rate and host reads an iteration (torch's
            sync debug mode), quantize_for_decode on the card bitwise the
            CPU's, int8 weights with the int8 cache against bf16 greedy,
            tok/s of each; examples/serving/demo_torch.py --batch 4
            --prompt 16 --new 32 in process.  Every one of flash_fwd,
            flash_dq, flash_dkv, layer_norm_fwd, fused_adam,
            multi_tensor_scale and multi_tensor_l2norm launched on the
            phase's paths; the kernel rows print as the
            "kernels_decoder_tail" line.

18. serving  the serving engines (Engine, PagedEngine, Seq2SeqEngine) on
            the card, their decode windows captured in CUDA graphs (the
            "kernels_serving" line).
19. dp      the wider data-parallel stack on a one-rank NCCL group, cuDNN
            deterministic.  First the Adam kernel on every ZeRO window of
            ResNet-50's flat buffer (25,557,032) padded to 3 windows (odd,
            bases off 16 bytes: the element path) and to 8, bitwise its
            plain version with nothing outside the window written, and its
            time on one window of 3 against its bound and torch's fused
            Adam (the "kernels_dp" line).  Then four paths, each from one
            state 8 eager steps bitwise its plain twin's, then held as phase
            15 holds its paths (graph against eager, exact launch counts,
            step_ms, idle share, peak memory, the graph's pool), then the
            NCCL kernels of one replay counted exactly: (m) ResNet-50 O2 +
            FusedAdam at batch 128 under ZeRO-1 against the unsharded
            step, and examples/imagenet/main_amp_torch.py --zero for 10
            iterations with exact launch counts; (n) BERT-base O2 +
            FusedAdam at 32 x 128, dropout 0.1, through the hook path
            under DistributedDataParallel(overlap=True, comm_topology=
            'hierarchical', ici_size=1) against the flat after-backward
            hook path; (o) GPT-2 small's widths with an untied head, all
            bf16, at 8 x 1024, dropout 0.1, through
            staged_zero2_allreduce_grads over 14 stages (embeddings, 12
            blocks, final LayerNorm and head), FusedAdam's kernel on fp32
            masters a stage, against ZeRO-1 of the model; (p) the same
            model under ZeRO-3 (zero_gather_params under
            zero_gather_checkpoint_policy) against ZeRO-1; and ZeRO-3's
            peak beside the staged ZeRO-2's.

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


def graph_ms(fn, inner: int = 10, reps: int = REPS) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    the replay timed as ``time_ms`` (``reps`` replays) times a call,
    divided by ``inner``.  ``time_ms`` of one call also counts the host
    time of the call when the card waits for it, which dominates a small
    kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = time_ms(graph.replay, reps=reps) / inner
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
    "all": {"causal": True, "kv_mask": True, "segments": True, "rate": 0.1},
    "causal_dropout": {"causal": True, "rate": 0.1},
    "causal_kv_mask": {"causal": True, "kv_mask": True}}
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


def _time_rows(timing, err, per, plain_graph=(10, REPS)):
    """kernel, plain and library device time (``graph_ms``) of each entry
    of ``timing`` = name -> (bytes, flops, kernel, plain, library), the
    library a call or its time already taken; ``plain_graph`` the plain
    version's (calls a graph, replays timed)."""
    rows = {}
    for key, (nbytes, flops, kern, plain, libcall) in timing.items():
        name = key.split(":")[0]      # "name:variant" times a variant
        kms, pms = graph_ms(kern), graph_ms(plain, *plain_graph)
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


def _flash_check(shape, dtype, variant, seed, lengths=None):
    """The three flash kernels and their plain versions, each against
    fp64: an output within one rounding to its type of the fp64 value plus
    (u + 256*2^-24) of the fp64 sum of its terms' magnitudes (u: the
    rounding of P and dS to the type; 256*2^-24: the fp32 sums, exp and the
    scores' rounding), plus the rounding of P and dS values too small for
    the type's normal range (fp16).  A fully masked row must be exactly
    0.  ``lengths`` (B,): the key-padding mask keeps each sequence's
    first ``lengths[b]`` keys (default: a random mask, the first sequence
    all masked)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import flash_attention as fa
    B, H, T, D = shape
    q, k, v, do, kvm, seg, words = _flash_case(B, H, T, D, dtype, seed)
    spec = FLASH_VARIANTS[variant]
    causal = spec.get("causal", False)
    kvm = kvm if spec.get("kv_mask") else None
    if lengths is not None:
        kvm = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
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
    if kvm is not None and not bool(kvm[0].any()):
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


def _snapshot(model, opt, gens, host=False):
    """Clones of a path's whole training state: the optimizer's state dict
    (masters, moments, step counter, scalers), the half copy, the model's
    buffers (BatchNorm's running statistics) and the generators' states;
    in host memory with ``host`` (a state too large to hold twice more on
    the card)."""
    def clone(t):
        return t.to("cpu", copy=True) if host else t.clone()
    full = getattr(opt.masters, "full", None)
    return {"opt": {k: clone(v) for k, v in _flat_state(opt.state_dict())},
            "half": (None if opt.masters.half is None
                     else clone(opt.masters.half)),
            # under ZeRO the model's fp32 params view a gathered buffer
            "full": None if full is None else clone(full),
            "buffers": {k: clone(b) for k, b in model.named_buffers()},
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
        if snap["full"] is not None:
            opt.masters.full.copy_(snap["full"])
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
    assert a["full"] is None or same(a["full"], b["full"]), f"[{tag}] full"
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
                   gens=(), ks=(1,), make=None, host=False):
    # items: (count, unit) of one step's batch
    """A path's functional step held and timed: from one state, the step
    run eagerly (``CAPTURE_HOLD + CAPTURE_TIMED`` steps) and through
    ``make(step_fn, K)`` for each K of ``ks`` (a CUDA graph of K steps a
    call): losses, the whole state and the generators' offsets bitwise
    the eager run's after as many steps; launch counts exact (``per_step``
    a step) over the graph's calls; step_ms eager against graph, the
    graph's device time (profiler and CUDA events), idle share, launches
    a step and peak memory.  ``host``: the snapshots held against each
    other live in host memory.  Returns the launch counts of each K."""
    from apex_tpu_torch import ops, parallel
    if make is None:
        def make(fn, k):
            return parallel.make_step(fn, model, steps_per_call=k)
    s0 = _snapshot(model, opt, gens, host)
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
            digests[i + 1] = _snapshot(model, opt, gens, host)
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
                       _snapshot(model, opt, gens, host))
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


# -- phase 16, the decoder families ------------------------------------------

GPT2_BATCH, GPT2_SEQ = 8, 1024      # GPT-2 small's block at batch 8
TL_BATCH, TL_SEQ = 4, 2048          # TinyLlama's max positions at batch 4
TL_LAYERS = 22                      # TinyLlama-1.1B's depth, uncut
FLASH_GPT2 = (GPT2_BATCH, 12, GPT2_SEQ, 64)
FLASH_TL = (TL_BATCH, 32, TL_SEQ, 64)
# the fp64 and plain-version check at TinyLlama's shape, at one sequence:
# the plain version's (B*H, T, T) fp32 scores are 2 GiB a tensor at four
FLASH_TL_HELD = (1, 32, TL_SEQ, 64)
DECODER_LR = 1e-4
DECODER_TOKENS = 1000               # the training batch's ids: [0, 1000)
GEN_PROMPTS = (16, 29, 40, 57)      # four prompts of different lengths
GEN_NEW = 64
GEN_BUF = 128                       # generation buffer: prompts + 64 tokens
DECODER_EXAMPLE_ITERS = 10
# the examples as a user runs them: (examples/<dir>, command line)
DECODER_EXAMPLES = {
    "gpt": ("gpt", ["--config", "small", "--stdlib-corpus", "1",
                    "--generate", "64"]),
    "llama": ("gpt", ["--config", "small", "--stdlib-corpus", "1",
                      "--generate", "64", "--arch", "llama",
                      "--n-kv-head", "4"]),
    "bert-base": ("bert", ["--config", "base", "-b", "32"]),
    "bert-large": ("bert", ["--config", "large", "--optimizer", "lamb",
                            "-b", "8"]),
}
GPT2_LN_PER_PASS = 2 * 12 + 1       # two a block and ln_f
GPT2_FLASH_PER_PASS = 12


def tinyllama(layers: int = TL_LAYERS):
    """TinyLlama/TinyLlama-1.1B's published config.json widths: hidden
    2048, intermediate 5632, 22 layers, 32 heads, 4 KV heads, vocab 32000,
    2048 positions, RMS eps 1e-5, rope theta 10000, untied head."""
    from apex_tpu_torch import models
    return models.LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=layers, num_attention_heads=32,
        num_key_value_heads=4, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)


def _decoder_flash_rows(shape, rate, tag):
    """Kernel, plain and SDPA (``is_causal=True``) device times of the
    three flash kernels, causal, at ``shape`` in bf16; the bound counts
    the causal half of the scores (2, 3 and 4 B*H*T^2*D multiply-adds
    against the full product's 4, 6 and 8)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import flash_attention as fa
    B, H, T, D = shape
    q, k, v, do, _, _, words = _flash_case(B, H, T, D, torch.bfloat16,
                                           SEED + 95)
    args = (H, D ** -0.5, True, None, None, words, rate)
    o, lse = ops.flash_fwd(q, k, v, *args)
    delta = (do.float() * o.float()).sum(dim=-1)
    q4, k4, v4, do4 = (t.view(B, H, T, D).detach().requires_grad_()
                       for t in (q, k, v, do))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, dropout_p=rate, is_causal=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    lib_fwd = graph_ms(sdpa)
    lib_bwd = graph_ms(sdpa_fwd_bwd) - lib_fwd
    n, isz, f0 = B * H * T * D, q.element_size(), B * H * T * T * D
    stats = B * H * T * 4
    timing = {
        f"flash_fwd:{tag}": (4 * n * isz + stats, 2 * f0,
                             lambda: ops.flash_fwd(q, k, v, *args),
                             lambda: fa._fwd_plain(q, k, v, *args), lib_fwd),
        f"flash_dq:{tag}": (5 * n * isz + 2 * stats, 3 * f0,
                            lambda: ops.flash_dq(q, k, v, do, lse, delta,
                                                 *args),
                            lambda: fa._dq_plain(q, k, v, do, lse, delta,
                                                 *args), lib_bwd),
        f"flash_dkv:{tag}": (6 * n * isz + 2 * stats, 4 * f0,
                             lambda: ops.flash_dkv(q, k, v, do, lse, delta,
                                                   *args),
                             lambda: fa._dkv_plain(q, k, v, do, lse, delta,
                                                   *args), lib_bwd)}
    log(f"[decoder] scaled_dot_product_attention(is_causal=True) at {shape} "
        f"bf16, dropout {rate}: forward {lib_fwd:.4f} ms, backward (dq, "
        f"dk, dv in one) {lib_bwd:.4f} ms")
    return timing


def phase_decoder_kernels():
    """The three flash kernels causal at the decoder shapes, for the first
    time at T = 1024 and 2048: GPT-2 small's (8, 12, 1024, 64) bf16 with
    dropout 0.1 and TinyLlama's (4, 32, 2048, 64) bf16 (GQA repeated to 32
    heads), each output of kernel and plain version within the fp64 bound
    of phase 3 (TinyLlama's at one sequence), each kernel twice bitwise;
    then timed against the plain versions and SDPA.  The LayerNorm
    kernels at GPT-2's rows, likewise."""
    err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    worst = {"kernel": 0.0, "plain": 0.0}
    for i, (shape, variant) in enumerate(((FLASH_GPT2, "causal_dropout"),
                                          (FLASH_TL_HELD, "causal"))):
        errs, rat = _flash_check(shape, torch.bfloat16, variant,
                                 SEED + 93 + i)
        for k_, e in errs.items():
            err[k_] = max(err[k_], e)
        for who in worst:
            worst[who] = max(worst[who], rat[who])
        log(f"[decoder] flash fwd/dq/dkv at {shape} bf16 {variant}: within "
            f"the fp64 bounds, worst ratio kernel {rat['kernel']:.3e}, "
            f"plain {rat['plain']:.3e}; max abs err against the plain "
            f"version {errs}; second launches bitwise")
        gc.collect()
        torch.cuda.empty_cache()
    rows = _time_rows(
        _decoder_flash_rows(FLASH_GPT2, 0.1, "gpt2"), err,
        f"{FLASH_GPT2} (B, H, T, D) bf16, causal, dropout 0.1, one call; "
        f"{GPT2_FLASH_PER_PASS} calls a pass")
    gc.collect()
    torch.cuda.empty_cache()
    # the plain versions at TinyLlama's shape take ~0.1 s a call: two
    # calls a graph, five replays
    rows.update(_time_rows(
        _decoder_flash_rows(FLASH_TL, 0.0, "tinyllama"), err,
        f"{FLASH_TL} (B, H, T, D) bf16, causal, one call; {TL_LAYERS} "
        f"calls a pass", plain_graph=(2, 5)))
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(_decoder_ln_rows(worst))
    return rows, worst


def _decoder_ln_rows(worst):
    """The LayerNorm kernels at GPT-2 small's rows, (8 x 1024, 768) bf16 at
    eps 1e-5: held against fp64 (phase 3's bounds) and timed."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import layer_norm as lnm
    n1, n2, eps = GPT2_BATCH * GPT2_SEQ, 768, 1e-5
    (x, dy, w, b, mean, inv), errs, rat = _ln_check(
        n1, n2, torch.bfloat16, SEED + 96, eps=eps)
    for who in worst:
        worst[who] = max(worst[who], rat[who])
    log(f"[decoder] layer_norm at ({n1}, {n2}) bf16, eps {eps}: within the "
        f"fp64 bounds (ratio kernel {rat['kernel']:.3e}, plain "
        f"{rat['plain']:.3e}), max abs err against the plain version "
        f"{errs}")
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n2], wl, bl, eps)
    timing = {
        "layer_norm_fwd:gpt2": _ln_fwd_entry(x, w, b, eps),
        # reads dy, x, w, mean, inv; writes dx, dw, db
        "layer_norm_bwd:gpt2": (
            3 * n1 * n2 * x.element_size() + 3 * n2 * 4 + 2 * n1 * 4,
            11 * n1 * n2, lambda: ops.layer_norm_bwd(dy, x, w, mean, inv),
            lambda: lnm._bwd_plain(dy, x, w, mean, inv),
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [n2], lmean, lrstd, wl, bl, [True, True, True]))}
    return _time_rows(timing, {"layer_norm_fwd": errs[0],
                               "layer_norm_bwd": errs[1]},
                      f"({n1}, {n2}) bf16, eps {eps}, one call; "
                      f"{GPT2_LN_PER_PASS} calls a pass")


def _agreement(a, b, lens):
    """Generated tokens of ``a`` equal to ``b``'s, and each row's first
    position where they part (None: none)."""
    equal, total, first = 0, 0, []
    for r, n in enumerate(lens):
        eq = a[r, n:n + GEN_NEW] == b[r, n:n + GEN_NEW]
        equal += int(eq.sum())
        total += eq.numel()
        bad = torch.nonzero(~eq)
        first.append(None if bad.numel() == 0 else int(bad[0]))
    return equal / total, first


def _greedy_uncached(model, ids, lens, n):
    """Greedy decoding by a full forward over the whole buffer a token
    (``GPT.generate``'s loop, for a model without it): the reference the
    cached loop must equal."""
    B, S = ids.shape
    ids, cur = ids.clone(), lens.clone()
    ar = torch.arange(S, device=ids.device)
    rows = torch.arange(B, device=ids.device)
    with torch.no_grad():
        for _ in range(n):
            amask = (ar[None, :] < cur[:, None]).to(torch.int32)
            logits = model(ids, amask)
            nxt = logits[rows, (cur - 1).clamp(max=S - 1)].argmax(-1)
            wpos = cur.clamp(max=S - 1)
            ids[rows, wpos] = torch.where(cur < S, nxt, ids[rows, wpos])
            cur = (cur + 1).clamp(max=S)
    return ids, cur


def _decoder_generation(tag, model, prompts, uncached):
    """Greedy generation of GEN_NEW tokens from four prompts of different
    lengths (GEN_PROMPTS, taken from the training batch) in a GEN_BUF
    buffer: ``generate_cached`` with a bf16 cache (chunked prefill) and
    with the int8 cache against ``uncached`` (``generate``) on the trained
    half-precision model, reported; then the same model in fp32 (its
    weights as trained, widened), where ``generate_cached`` with either
    prefill must give exactly ``uncached``'s tokens."""
    from apex_tpu_torch import ops
    dev = torch.device(DEVICE)
    buf = torch.zeros((len(GEN_PROMPTS), GEN_BUF), dtype=torch.int64,
                      device=dev)
    for r, n in enumerate(GEN_PROMPTS):
        buf[r, :n] = prompts[r % prompts.shape[0], :n]
    lens = torch.tensor(GEN_PROMPTS, device=dev)
    model.eval()
    out = {}
    ((ref, rlen),), (ms,) = _timed(lambda: uncached(buf, lens), 1)
    ops.reset_launch_counts()
    ((got, glen),), (gms,) = _timed(lambda: model.generate_cached(
        buf, lens, GEN_NEW), 1)
    gen_counts = {k: v for k, v in ops.launch_counts().items() if v}
    ((q8, _),), (qms,) = _timed(lambda: model.generate_cached(
        buf, lens, GEN_NEW, cache_dtype=torch.int8), 1)
    assert torch.equal(glen, rlen) and torch.equal(
        glen, lens + GEN_NEW), (glen, rlen)
    for t in (ref, got, q8):
        assert bool((t >= 0).all()), f"[{tag}] negative token ids"
        assert torch.equal(t[:, :GEN_PROMPTS[0]], buf[:, :GEN_PROMPTS[0]])
    agree, first = _agreement(got, ref, GEN_PROMPTS)
    agree8, first8 = _agreement(q8, ref, GEN_PROMPTS)
    n_tok = len(GEN_PROMPTS) * GEN_NEW
    log(f"[{tag}] half precision: generate_cached (bf16 cache, chunked "
        f"prefill) {n_tok} tokens in {gms:.1f} ms ({n_tok / gms * 1e3:.1f} "
        f"tok/s; launches {json.dumps(gen_counts)}), int8 cache "
        f"{qms:.1f} ms, uncached {ms:.1f} ms; tokens equal to the uncached "
        f"loop's: bf16 cache {agree:.4f} (rows part at {first}), int8 "
        f"{agree8:.4f} (at {first8})")
    out.update(bf16_agreement=agree, int8_agreement=agree8,
               cached_ms=gms, int8_ms=qms, uncached_ms=ms,
               cached_tokens_per_s=n_tok / gms * 1e3,
               generation_launches=gen_counts)
    # fp32: the trained weights widened, the fp32 kernels (TF32 is off)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.float()
    ref32, _ = uncached(buf, lens)
    for mode in ("chunked", "step"):
        got32, _ = model.generate_cached(buf, lens, GEN_NEW,
                                         prefill_mode=mode)
        assert torch.equal(got32, ref32), \
            f"[{tag}] fp32 generate_cached ({mode}) differs from the " \
            f"uncached loop: {_agreement(got32, ref32, GEN_PROMPTS)}"
    log(f"[{tag}] fp32: generate_cached (fp32 cache; chunked and step "
        f"prefill) gives exactly the uncached loop's {n_tok} tokens")
    out["fp32_exact"] = True
    return out


def _decoder_path(tag, smi, floor, model, batch, per, gens, host,
                  uncached):
    """One decoder trained under O2 + FusedAdam through make_step, held
    bitwise against its eager step (``_captured_path``), then generating
    (``_decoder_generation``; ``uncached(model, buf, lens)`` the greedy
    reference).  ``floor``: ``_mem_floor()`` before the model was built."""
    from apex_tpu_torch import amp, optimizers
    n_params = sum(p.numel() for p in model.parameters())
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=DECODER_LR),
                                opt_level="O2", verbosity=0)
    model.train()

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b[0]), opt)
        opt.step(grads)
        return loss

    B, T = batch.shape
    log(f"[{tag}] {n_params} parameters, O2 + FusedAdam(lr={DECODER_LR}), "
        f"{B} x {T} tokens (ids below {DECODER_TOKENS}), floor {floor} B: "
        f"scaled_grad, step(grads) through make_step")
    counts, out = _captured_path(tag, model, opt, step, (batch,), per, smi,
                                 (B * T, "tokens"), gens=gens, host=host)
    cats = out["graphs"][1]["profile_ms"]
    if cats is not None:
        # the replayed graph's kernels, by category: the port's own
        assert cats.get("port attention kernels", 0) > 0, cats
        if "layer_norm_fwd" in per:
            assert cats.get("port LayerNorm kernels", 0) > 0, cats
    del opt
    gc.collect()
    out["generation"] = _decoder_generation(
        tag, model, batch, lambda b, n: uncached(model, b, n))
    out["parameters"] = n_params
    del model
    _mem_floor()
    return counts, out


def _run_decoder_examples():
    """The examples as a user runs them, a few iterations each, with the
    launch counts of each run."""
    counts, out = {}, {}
    for name, (which, argv) in DECODER_EXAMPLES.items():
        example = _load("examples", which, "main_amp_torch.py")
        argv = argv + ["--iters", str(DECODER_EXAMPLE_ITERS),
                       "--print-freq", "5"]
        floor = _mem_floor()
        t0 = time.time()
        _, counts[name], text, peak, losses = _run_example(
            example, f"example-{name}", argv, floor)
        speed = re.findall(r"=> done\. avg ([0-9.]+) seq/s(?: \(([0-9]+) "
                           r"tok/s)?", text)
        assert speed, text[-2000:]
        out[name] = {"losses": losses, "seq_per_s": float(speed[-1][0]),
                     "tokens_per_s": (float(speed[-1][1]) if speed[-1][1]
                                      else None),
                     "peak_bytes": peak, "seconds": time.time() - t0}
        log(f"[example-{name}] {out[name]}")
    return counts, out


def _decoder_example_counts():
    """Each example run's launches: its warm-up steps on the card (eager,
    then the capture) and the iterations, a backward pass each; the GPT runs' generation of 64 tokens: a
    chunked prefill (the blocks of one forward pass, without ln_f) and a
    decode step a token (the LayerNorms of one token; attention against
    the cache takes no flash kernel)."""
    steps = EXAMPLE_WARMUP + DECODER_EXAMPLE_ITERS
    opt = {"multi_tensor_scale": steps, "multi_tensor_l2norm": steps}
    gpt = dict(opt, fused_adam=steps,
               layer_norm_fwd=(GPT2_LN_PER_PASS * (steps + 64)
                               + GPT2_LN_PER_PASS - 1),
               layer_norm_bwd=GPT2_LN_PER_PASS * steps,
               flash_fwd=GPT2_FLASH_PER_PASS * (steps + 1),
               flash_dq=GPT2_FLASH_PER_PASS * steps,
               flash_dkv=GPT2_FLASH_PER_PASS * steps)
    llama = {k: v for k, v in gpt.items() if not k.startswith("layer_norm")}
    bert = dict(opt, fused_adam=steps, layer_norm_fwd=LN_PER_PASS * steps,
                layer_norm_bwd=LN_PER_PASS * steps,
                flash_fwd=FLASH_PER_PASS * steps,
                flash_dq=FLASH_PER_PASS * steps,
                flash_dkv=FLASH_PER_PASS * steps)
    large = dict(opt, lamb_stage1=steps, lamb_stage2=steps,
                 multi_tensor_l2norm_per_tensor=3 * steps,
                 layer_norm_fwd=LARGE_LN_PER_PASS * steps,
                 layer_norm_bwd=LARGE_LN_PER_PASS * steps,
                 flash_fwd=LARGE_FLASH_PER_PASS * steps,
                 flash_dq=LARGE_FLASH_PER_PASS * steps,
                 flash_dkv=LARGE_FLASH_PER_PASS * steps)
    return {"gpt": gpt, "llama": llama, "bert-base": bert,
            "bert-large": large}


def phase_decoder(smi):
    """Phase 16: the decoder families.  The flash kernels causal at the
    decoder shapes; GPT-2 small (dropout 0.1) at 8 x 1024 and TinyLlama's
    widths at 4 x 2048, each under O2 + FusedAdam through make_step,
    captured and held bitwise against the eager step over 8 steps, then
    generating; the GPT and BERT examples as a user runs them."""
    from apex_tpu_torch import models
    t0 = time.time()
    rows, worst = phase_decoder_kernels()
    log(f"[time] decoder kernel checks and rows in {time.time() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    dev = torch.device(DEVICE)
    counts, results = {}, {"kernels_worst_ratio": worst}

    floor = _mem_floor()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gpt2 = models.GPT(models.gpt2_small(), device=dev,
                      generator=torch.Generator().manual_seed(SEED),
                      dropout_generator=gen)
    ids = torch.from_numpy(rs.randint(0, DECODER_TOKENS, (
        GPT2_BATCH, GPT2_SEQ))).to(dev)
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "layer_norm_fwd": GPT2_LN_PER_PASS,
           "layer_norm_bwd": GPT2_LN_PER_PASS,
           "flash_fwd": GPT2_FLASH_PER_PASS, "flash_dq": GPT2_FLASH_PER_PASS,
           "flash_dkv": GPT2_FLASH_PER_PASS}
    counts["gpt2"], results["gpt2"] = _decoder_path(
        "decoder-gpt2", smi, floor, gpt2, ids, per, [gen], False,
        lambda m, b, n: m.generate(b, n, GEN_NEW))
    del gpt2
    log(f"[time] decoder gpt2 in {time.time() - t0:.1f} s")
    floor = _mem_floor()
    llama = models.Llama(tinyllama(), device=dev,
                         generator=torch.Generator().manual_seed(SEED))
    ids = torch.from_numpy(rs.randint(0, DECODER_TOKENS, (
        TL_BATCH, TL_SEQ))).to(dev)
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "flash_fwd": TL_LAYERS, "flash_dq": TL_LAYERS,
           "flash_dkv": TL_LAYERS}
    counts["tinyllama"], results["tinyllama"] = _decoder_path(
        "decoder-tinyllama", smi, floor, llama, ids, per, [], True,
        lambda m, b, n: _greedy_uncached(m, b, n, GEN_NEW))
    del llama
    log(f"[time] decoder tinyllama in {time.time() - t0:.1f} s")
    counts_ex, results["examples"] = _run_decoder_examples()
    log(f"[time] decoder examples in {time.time() - t0:.1f} s")
    log("decoder " + json.dumps(results))
    return rows, counts, counts_ex, results


# -- phase 17, the rest of the decoder families ------------------------------

T5_BATCH, T5_SRC, T5_TGT = 16, 512, 128     # 16 x (512 -> 128) tokens
T5_GEN = 32                         # greedy tokens from four sources
T5_VALID = (512, 371, 230, 97)      # their valid source lengths
T5_LR = 1e-4
LORA_RANK, LORA_ALPHA = 8, 16.0     # lora.py's example: q_proj and v_proj
LORA_TARGETS = ("q_proj", "v_proj")
LORA_LR = 1e-3
TAIL_NEW = 32                       # new tokens of each decode mode
TAIL_BUF = 96                       # GEN_PROMPTS' longest + 32, rounded up
TAIL_GAMMA = 4
TAIL_BEAMS = 4
TAIL_TEMP = 0.8
DEMO_ARGV = ["--batch", "4", "--prompt", "16", "--new", "32"]
# the seven wrappers this phase's paths must launch
TAIL_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "layer_norm_fwd",
                "fused_adam", "multi_tensor_scale", "multi_tensor_l2norm")


def t5_base():
    """google-t5/t5-base's published config.json: d_model 768, d_ff 3072,
    d_kv 64, 12 heads, 12 encoder and 12 decoder layers, vocab 32128,
    relu, 32 buckets out to distance 128, eps 1e-6, tied embeddings
    (dropout 0.1 is stored and not applied, as in the JAX package)."""
    from apex_tpu_torch import models
    return models.T5Config(
        vocab_size=32128, d_model=768, d_kv=64, d_ff=3072, num_layers=12,
        num_decoder_layers=12, num_heads=12,
        relative_attention_num_buckets=32,
        relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
        dropout_rate=0.1, feed_forward_proj="relu", tie_word_embeddings=True)


def distilgpt2():
    """distilgpt2's published widths: GPT-2 small's (768 wide, 12 heads,
    vocab 50257, 1024 positions) at 6 layers."""
    from apex_tpu_torch import models
    return models.GPTConfig(n_layer=6)


def _tail_opt_rows(n, tag):
    """The optimizer kernels at a path's flat length ``n``: scale (clean,
    then an inf and a nan: the flag), the l2norm (rel 1e-6, the same bits
    twice) and Adam with the bf16 copy, each against its plain version
    (scale and Adam bitwise), then timed (inputs drawn on the card)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    from apex_tpu_torch.ops import multi_tensor as mt
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 97)
    x = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev) * 1024.0
    m0 = torch.randn(n, generator=gen, device=dev).abs() * 0.1
    v0 = torch.randn(n, generator=gen, device=dev).abs() * 0.01
    err = {}
    s = torch.full((), 1.0 / 65536.0, device=dev)
    for inject in (False, True):
        xi = x.clone()
        if inject:
            xi[n // 3] = float("inf")
            xi[n - 1] = float("nan")
        ok, fk = ops.multi_tensor_scale(xi, s)
        op, fp = mt._scale_plain(xi, s, torch.empty_like(xi))
        assert same(ok, op), f"[{tag}] scale: kernel != plain"
        assert float(fk) == float(fp) == float(inject), (tag, float(fk))
        err["multi_tensor_scale"] = max_abs(ok, op)
        del xi, ok, op
    nk, np_ = ops.multi_tensor_l2norm(x), mt._l2norm_plain(x)
    assert abs(float(nk) - float(np_)) <= 1e-6 * float(np_), (tag, nk, np_)
    assert float(ops.multi_tensor_l2norm(x)) == float(nk)
    err["multi_tensor_l2norm"] = abs(float(nk) - float(np_))
    ss = torch.full((), 1e-3, device=dev)
    inv = torch.full((), 1.0 / 1024.0, device=dev)
    zero = torch.zeros((), device=dev)
    bk = [t.clone() for t in (x, m0, v0)]
    bp = [t.clone() for t in (x, m0, v0)]
    hk = torch.empty(n, dtype=torch.bfloat16, device=dev)
    hp = torch.empty_like(hk)
    args = (0.9, 0.999, 1e-8, False, 0.0)
    ops.fused_adam(*bk, g, ss, inv, *args, half=hk, noop=zero)
    adam_mod._adam_plain(*bp, g, ss, inv, *args, hp, zero)
    for a, b in zip(bk + [hk], bp + [hp]):
        assert same(a, b), f"[{tag}] adam: kernel != plain"
    err["fused_adam"] = max(max_abs(a, b) for a, b in zip(bk, bp))
    log(f"[decoder-tail] {tag}: scale, l2norm and Adam at n = {n} agree "
        f"with the plain versions; max abs err {err}")
    out = torch.empty_like(x)
    pl = x.clone()
    pl.grad = g.clone()
    lib_adam = torch.optim.Adam([pl], lr=1e-3, fused=True, capturable=True)
    timing = {
        f"multi_tensor_scale:{tag}": (
            8 * n, 0, lambda: ops.multi_tensor_scale(x, s, out=out),
            lambda: mt._scale_plain(x, s, out), lambda: torch.mul(x, s)),
        f"multi_tensor_l2norm:{tag}": (
            4 * n, 0, lambda: ops.multi_tensor_l2norm(x),
            lambda: mt._l2norm_plain(x),
            lambda: torch.linalg.vector_norm(x)),
        f"fused_adam:{tag}": (
            30 * n, 0,
            lambda: ops.fused_adam(*bk, g, ss, inv, *args, half=hk,
                                   noop=zero),
            lambda: adam_mod._adam_plain(*bp, g, ss, inv, *args, hp, zero),
            lib_adam.step)}
    rows = _time_rows(timing, err, f"n = {n} fp32 (bf16 copy), one call a "
                      f"step")
    del timing, lib_adam, pl
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _tail_flash_rows(lens, tag):
    """The flash forward as beam search and the full verify run it: causal
    with the key-padding mask of per-row lengths, at GPT-2 small's heads
    and a 4-beam batch of ``lens``' prompts (bf16 and fp32), within phase
    3's fp64 bound (the backward too), each kernel twice bitwise; the
    bf16 forward timed against its plain version and SDPA with the same
    boolean mask."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import flash_attention as fa
    B, H, T, D = len(lens), 12, TAIL_BUF, 64
    lens = torch.tensor(lens, device=DEVICE)
    err = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        errs, rat = _flash_check((B, H, T, D), dtype, "causal_kv_mask",
                                 SEED + 98 + i, lengths=lens)
        for k_, e in errs.items():
            err[k_] = max(err[k_], e)
        log(f"[decoder-tail] flash at {(B, H, T, D)} {dtype} causal with "
            f"the key-padding mask of lengths {lens.tolist()}: within the "
            f"fp64 bounds (ratio kernel {rat['kernel']:.3e}, plain "
            f"{rat['plain']:.3e}); max abs err {errs}")
    q, k, v, _, _, _, words = _flash_case(B, H, T, D, torch.bfloat16,
                                          SEED + 98)
    kvm = torch.arange(T, device=DEVICE)[None, :] < lens[:, None]
    args = (H, D ** -0.5, True, kvm, None, words, 0.0)
    causal = torch.ones((T, T), dtype=torch.bool, device=DEVICE).tril()
    amask = (causal[None, None] & kvm[:, None, None, :])
    q4, k4, v4 = (t.view(B, H, T, D) for t in (q, k, v))
    n, stats = B * H * T * D, B * H * T * 4
    # the (query, key) pairs of this mask: query i sees keys j <= i, j <
    # its row's length
    pairs = sum(min(i + 1, n_) for n_ in lens.tolist() for i in range(T))
    timing = {f"flash_fwd:{tag}": (
        4 * n * q.element_size() + stats, 4 * H * pairs * D,
        lambda: ops.flash_fwd(q, k, v, *args),
        lambda: fa._fwd_plain(q, k, v, *args),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=amask))}
    return _time_rows(timing, err, f"{(B, H, T, D)} (B, H, T, D) bf16, "
                      f"causal, key padding, one call; 12 calls a pass")


def _tail_ln_rows(rows_n, tag, calls="25 calls a decode step"):
    """The LayerNorm forward at a shape of GPT-2 small's decoding ((rows,
    768) bf16, eps 1e-5): within phase 3's fp64 bounds, timed."""
    (x, _, w, b, _, _), errs, rat = _ln_check(rows_n, 768, torch.bfloat16,
                                              SEED + 99 + rows_n, eps=1e-5)
    log(f"[{tag}] layer_norm at ({rows_n}, 768) bf16: within the "
        f"fp64 bounds (ratio kernel {rat['kernel']:.3e}, plain "
        f"{rat['plain']:.3e}), max abs err {errs}")
    return _time_rows({f"layer_norm_fwd:{tag}": _ln_fwd_entry(x, w, b,
                                                               1e-5)},
                      {"layer_norm_fwd": errs[0]},
                      f"({rows_n}, 768) bf16, eps 1e-5, one call; {calls}")


def _counted(fn):
    """``fn()``'s result and the launch counts of that call alone: set to
    0 just before, read just after."""
    from apex_tpu_torch import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in ops.launch_counts().items() if v}


def _host_reads(fn):
    """``fn()``'s result, its wall time (ms) and how many times it made
    the host wait on the card (torch's CUDA sync debug mode warns at each
    synchronizing call: a read of a device value, a blocking copy)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    reads = sum("synchroniz" in str(w.message).lower() for w in caught)
    return out, ms, reads


def _tail_t5(smi, totals):
    """T5 at t5-base's widths under O2 + FusedAdam through make_step,
    captured and held bitwise against the eager step; then greedy
    generation against an uncached argmax loop over ``forward``."""
    from apex_tpu_torch import amp, models, optimizers
    dev = torch.device(DEVICE)
    floor = _mem_floor()
    model = models.T5(t5_base(), device=dev,
                      generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(SEED + 17)
    src = torch.from_numpy(rs.randint(2, 32128, (T5_BATCH, T5_SRC))).to(dev)
    labels = torch.from_numpy(rs.randint(2, 32128,
                                         (T5_BATCH, T5_TGT))).to(dev)
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=T5_LR),
                                opt_level="O2", verbosity=0)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b[0], b[1]), opt)
        opt.step(grads)
        return loss

    log(f"[decoder-tail-t5] {n_params} parameters, O2 + FusedAdam(lr="
        f"{T5_LR}), {T5_BATCH} x ({T5_SRC} -> {T5_TGT}) tokens, floor "
        f"{floor} B: scaled_grad, step(grads) through make_step")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1}
    paths = []
    from apex_tpu_torch import transformer
    transformer.set_path_hook(paths.append)
    try:
        counts, out = _captured_path(
            "decoder-tail-t5", model, opt, step, (src, labels), per, smi,
            (T5_BATCH * (T5_SRC + T5_TGT), "tokens"))
    finally:
        transformer.set_path_hook(None)
    assert not paths, f"T5 reached the attention dispatch: {set(paths)}"
    _add(totals, counts[1][0])
    out["flat_length"] = opt.masters.layout.total
    del opt
    gc.collect()
    out["parameters"] = n_params
    out["generation"] = _t5_generation(model, src[:4])
    del model
    _mem_floor()
    return counts, out


def _t5_generation(model, src):
    """Greedy generation of T5_GEN tokens from four sources of valid
    lengths T5_VALID: in bf16 (the trained weights) its agreement with an
    uncached argmax loop over ``forward``; in fp32 (the weights widened)
    equal to it token for token."""
    B = src.shape[0]
    mask = (torch.arange(T5_SRC, device=src.device)[None, :]
            < torch.tensor(T5_VALID, device=src.device)[:, None]).long()
    model.eval()

    def uncached():
        dec = torch.full((B, 1), model.cfg.decoder_start_token_id,
                         dtype=torch.int64, device=src.device)
        with torch.no_grad():
            for _ in range(T5_GEN):
                nxt = model(src, dec, mask)[:, -1].argmax(-1)
                dec = torch.cat([dec, nxt[:, None]], dim=1)
        return dec[:, 1:]

    out = {}
    for precision in ("bf16", "fp32"):
        if precision == "fp32":
            with torch.no_grad():
                for p in model.parameters():
                    p.data = p.data.float()
        (ref,), (ums,) = _timed(uncached, 1)
        got, gms, reads = _host_reads(lambda: model.generate(src, T5_GEN,
                                                             mask))
        agree = float((got == ref).float().mean())
        n_tok = B * T5_GEN
        log(f"[decoder-tail-t5] {precision}: generate {n_tok} tokens in "
            f"{gms:.1f} ms ({n_tok / gms * 1e3:.1f} tok/s, {reads} host "
            f"reads), uncached loop {ums:.1f} ms; tokens equal to the "
            f"uncached loop's: {agree:.4f}")
        out[precision] = {"agreement": agree, "generate_ms": gms,
                          "tokens_per_s": n_tok / gms * 1e3,
                          "uncached_ms": ums, "host_reads": reads}
    assert out["fp32"]["agreement"] == 1.0, \
        "fp32 T5 generate differs from the uncached loop"
    return out


class _LossOf(torch.nn.Module):
    """``model.loss`` as a module's forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids):
        return self.model.loss(ids)


def _tail_lora(smi, totals):
    """LoRA on the Llama at TinyLlama-1.1B's widths: a frozen bf16 base,
    rank-8 alpha-16 adapters on q_proj and v_proj under O2 + FusedAdam
    through make_step, the loss on merged weights through functional_call;
    captured and held bitwise against the eager step, the base bitwise
    unchanged.  Then the base through llama_to_hf and back."""
    from apex_tpu_torch import amp, lora, models, optimizers
    dev = torch.device(DEVICE)
    floor = _mem_floor()
    t0 = time.time()
    base = models.Llama(tinyllama(), device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    base = base.to(torch.bfloat16).requires_grad_(False)
    log(f"[decoder-tail-lora] base built in {time.time() - t0:.1f} s")
    before = {k: v.clone() for k, v in base.state_dict().items()}
    adapters = lora.init(base, LORA_TARGETS, rank=LORA_RANK,
                         generator=torch.Generator().manual_seed(SEED))
    small, full = lora.num_params(adapters)
    adapters, opt = amp.initialize(adapters,
                                   optimizers.FusedAdam(lr=LORA_LR),
                                   opt_level="O2", verbosity=0)
    s = lora.scale(LORA_ALPHA, LORA_RANK)
    frozen = {f"model.{n}": p.detach() for n, p in base.named_parameters()}
    prefixed = {f"model/{k}": v for k, v in adapters.items()}
    wrapper = _LossOf(base)

    def step(b):
        def loss_fn():
            merged = lora.merge(frozen, prefixed, s)
            return torch.func.functional_call(wrapper, merged, (b[0],))
        loss, grads = amp.scaled_grad(loss_fn, opt)
        opt.step(grads)
        return loss

    rs = np.random.RandomState(SEED + 18)
    ids = torch.from_numpy(rs.randint(0, DECODER_TOKENS,
                                      (TL_BATCH, TL_SEQ))).to(dev)
    log(f"[decoder-tail-lora] {small} adapter parameters (rank "
        f"{LORA_RANK}, alpha {LORA_ALPHA}, {LORA_TARGETS}) over {full} "
        f"adapted and {sum(p.numel() for p in base.parameters())} base "
        f"parameters; O2 + FusedAdam(lr={LORA_LR}) on the adapters, "
        f"{TL_BATCH} x {TL_SEQ} tokens, floor {floor} B")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "flash_fwd": TL_LAYERS, "flash_dq": TL_LAYERS,
           "flash_dkv": TL_LAYERS}
    counts, out = _captured_path("decoder-tail-lora", adapters, opt, step,
                                 (ids,), per, smi, (TL_BATCH * TL_SEQ,
                                                    "tokens"))
    _add(totals, counts[1][0])
    for k, v in base.state_dict().items():
        assert torch.equal(v, before[k]), f"[decoder-tail-lora] base {k}"
    assert all(p.grad is None for p in base.parameters())
    log(f"[decoder-tail-lora] every base tensor ({len(before)}) bitwise "
        f"as before the steps; graph step_ms "
        f"{out['graphs'][1]['step_ms']:.2f} against the full training "
        f"step's 258.35 (PERF.md, PR 12)")
    out.update(adapter_parameters=small, adapted_parameters=full)
    del before, opt, adapters, prefixed, frozen
    gc.collect()
    out["round_trip"] = _tail_round_trip(base)
    del base
    _mem_floor()
    return counts, out


def _tail_round_trip(base):
    """The TinyLlama-width weights through llama_to_hf and back through
    llama_from_hf on a duck-typed stand-in for the HF model (its config's
    fields and the state dict): fp32 copies bitwise the weights widened."""
    from types import SimpleNamespace
    from apex_tpu_torch.utils import hf_interop
    cfg = base.cfg
    t0 = time.time()
    sd = hf_interop.llama_to_hf(cfg, base.state_dict())
    hc = SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        tie_word_embeddings=cfg.tie_word_embeddings, hidden_act="silu")
    back = hf_interop.llama_from_hf(SimpleNamespace(
        config=hc, state_dict=lambda: sd), device=DEVICE)
    n = 0
    for k, v in base.state_dict().items():
        got = back.state_dict()[k]
        assert got.dtype == torch.float32 and torch.equal(got, v.float()), k
        n += v.numel()
    secs = time.time() - t0
    log(f"[decoder-tail-roundtrip] llama_to_hf -> llama_from_hf: {len(sd)} "
        f"tensors, {n} parameters bitwise (fp32) in {secs:.1f} s")
    return {"tensors": len(sd), "parameters": n, "seconds": secs}


def _acceptance(calls, gamma):
    """Accepted draft tokens over the proposals that could be accepted
    (a proposal needs its correction slot inside the window), and the
    iterations, from the (cur_len, new_len, final_len) of each verify
    round."""
    acc = elig = 0
    for cur, new, final in calls:
        active = cur < final
        n_acc = (new - cur - 1).clamp(min=0)
        e = (final - 1 - cur).clamp(0, gamma)
        acc += int(n_acc[active].sum())
        elig += int(e[active].sum())
    return acc / max(elig, 1), len(calls)


def _tail_decode(totals):
    """Decoding at GPT-2 small's widths (target gpt2_small, draft
    distilgpt2's widths, random weights from seeds 0 and 1): beam search,
    speculative decoding (both verify modes, a perfect draft, sampling)
    and int8 weights, each against greedy decoding."""
    from apex_tpu_torch import models
    from apex_tpu_torch.models import (beam_search, generate_speculative,
                                       speculative)
    dev = torch.device(DEVICE)
    floor = _mem_floor()
    t32 = _gpt2_small(dev)
    d32 = models.GPT(distilgpt2(), device=dev,
                     generator=torch.Generator().manual_seed(SEED + 1)).eval()
    t16 = _gpt2_small(dev).to(torch.bfloat16)
    d16 = models.GPT(distilgpt2(), device=dev, generator=torch.Generator(
        ).manual_seed(SEED + 1)).to(torch.bfloat16).eval()
    rs = np.random.RandomState(SEED + 19)
    buf = torch.zeros((len(GEN_PROMPTS), TAIL_BUF), dtype=torch.int64,
                      device=dev)
    for r, n in enumerate(GEN_PROMPTS):
        buf[r, :n] = torch.from_numpy(rs.randint(0, DECODER_TOKENS, n))
    lens = torch.tensor(GEN_PROMPTS, device=dev)
    n_tok = len(GEN_PROMPTS) * TAIL_NEW
    out, counts = {}, {}
    calls = []
    inner = speculative._rebuild

    def recording(*a):
        # each verify round of either mode: (cur_len, new_len, final_len)
        res = inner(*a)
        calls.append((a[2].clone(), res[1].clone(), a[3].clone()))
        return res

    def run(name, fn, tokens=n_tok):
        fn()                            # warm-up: the timed call is the 2nd
        calls.clear()
        ((res, ms, reads), c) = _counted(lambda: _host_reads(fn))
        counts[name] = c
        _add(totals, c)
        out[name] = {"ms": ms, "tokens_per_s": tokens / ms * 1e3,
                     "host_reads": reads, "launches": c}
        if calls:
            rate, iters = _acceptance(calls, TAIL_GAMMA)
            out[name].update(acceptance=rate, iterations=iters,
                             host_reads_per_iteration=reads / iters)
        log(f"[decoder-tail-decode] {name}: {json.dumps(out[name])}")
        return res

    speculative._rebuild = recording
    try:
        greedy16, _ = run("greedy_bf16", lambda: t16.generate_cached(
            buf, lens, TAIL_NEW))
        beam16, _, score16 = run("beam4_bf16", lambda: beam_search(
            t16, buf, lens, TAIL_NEW, num_beams=TAIL_BEAMS))
        assert out["beam4_bf16"]["host_reads"] == 0, out["beam4_bf16"]
        spec16, _ = run("spec_cached_bf16", lambda: generate_speculative(
            t16, d16, buf, lens, TAIL_NEW, gamma=TAIL_GAMMA))
        gen = torch.Generator(device=dev).manual_seed(SEED + 20)
        samp, _ = run("spec_sample_bf16", lambda: generate_speculative(
            t16, d16, buf, lens, TAIL_NEW, gamma=TAIL_GAMMA,
            temperature=TAIL_TEMP, generator=gen))
        assert bool(((samp >= 0) & (samp < 50257)).all())
        assert torch.equal(samp[:, :GEN_PROMPTS[0]],
                           buf[:, :GEN_PROMPTS[0]])
        # fp32: exactness (TF32 is off)
        ref, rlen = run("greedy_fp32_uncached", lambda: t32.generate(
            buf, lens, TAIL_NEW))
        assert torch.equal(rlen, lens + TAIL_NEW)
        beam1, _, score1 = run("beam1_fp32", lambda: beam_search(
            t32, buf, lens, TAIL_NEW, num_beams=1))
        assert torch.equal(beam1, ref), "beam 1 differs from greedy"
        _, _, score4 = run("beam4_fp32", lambda: beam_search(
            t32, buf, lens, TAIL_NEW, num_beams=TAIL_BEAMS))
        assert float(score4.sum()) >= float(score1.sum()) - 1e-3, \
            (score4.tolist(), score1.tolist())
        out["beam_scores"] = {"beam4": score4.tolist(),
                              "greedy": score1.tolist()}
        for verify in ("cached", "full"):
            got, _ = run(f"spec_{verify}_fp32", lambda: generate_speculative(
                t32, d32, buf, lens, TAIL_NEW, gamma=TAIL_GAMMA,
                verify=verify))
            assert torch.equal(got, ref), f"speculative ({verify}) != greedy"
            got, _ = run(f"spec_{verify}_self_fp32",
                         lambda: generate_speculative(
                             t32, t32, buf, lens, TAIL_NEW,
                             gamma=TAIL_GAMMA, verify=verify))
            assert torch.equal(got, ref), \
                f"speculative ({verify}, draft = target) != greedy"
    finally:
        speculative._rebuild = inner
    # the loop's condition, once an iteration and once to end
    for name, o in out.items():
        if name.startswith("spec_") and "iterations" in o:
            assert o["host_reads"] == o["iterations"] + 1, (name, o)
    # draft = target: every eligible proposal is accepted by the full
    # verify; the cached verify's draft lacks the K/V of the last proposal
    # of a fully accepted round (the JAX package's spec_iteration), so
    # it accepts fewer
    assert out["spec_full_self_fp32"]["acceptance"] == 1.0, out
    out["spec_bf16_agreement"] = _agree(spec16, greedy16, GEN_PROMPTS)
    out["beam4_bf16_agreement_with_greedy"] = _agree(beam16, greedy16,
                                                     GEN_PROMPTS)
    del t32, d32, d16
    gc.collect()
    out["int8"] = _tail_int8(t16, buf, lens, greedy16, run)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - floor
    return counts, out


def _gpt2_small(device):
    """GPT-2 small with random weights from SEED, in eval mode."""
    from apex_tpu_torch import models
    return models.GPT(models.gpt2_small(), device=device,
                      generator=torch.Generator().manual_seed(SEED)).eval()


def _agree(a, b, lens):
    """The share of generated tokens of ``a`` equal to ``b``'s."""
    eq = total = 0
    for r, n in enumerate(lens):
        e = a[r, n:n + TAIL_NEW] == b[r, n:n + TAIL_NEW]
        eq += int(e.sum())
        total += e.numel()
    return eq / total


def _tail_int8(t16, buf, lens, greedy16, run):
    """quantize_for_decode on the card bitwise the CPU's for the same
    weights; the bytes before and after; generate_cached with int8
    weights and the int8 cache against bf16 greedy."""
    from apex_tpu_torch import quantization
    from apex_tpu_torch.quantization import QTensor
    q = quantization.quantize_for_decode(t16)
    # the same weights on the CPU: drawn from the seed there, cast there
    qc = quantization.quantize_for_decode(
        _gpt2_small("cpu").to(torch.bfloat16))
    n = 0
    cpu_mods = dict(qc.named_modules())
    for name, m in q.named_modules():
        if isinstance(m, QTensor):
            c = cpu_mods[name]
            assert torch.equal(m.data.cpu(), c.data), name
            assert torch.equal(m.scale.cpu(), c.scale), name
            n += 1

    def nbytes(model):
        return sum(t.numel() * t.element_size() for t in
                   list(model.parameters()) + list(model.buffers()))

    before, after = nbytes(t16), nbytes(q)
    got, _ = run("int8_weights_int8_cache", lambda: q.generate_cached(
        buf, lens, TAIL_NEW, cache_dtype=torch.int8))
    agree = _agree(got, greedy16, GEN_PROMPTS)
    log(f"[decoder-tail-int8] {n} weights quantized on the card bitwise "
        f"the CPU's; weight bytes {before} -> {after} "
        f"({after / before:.3f}); int8 weights + int8 cache tokens equal "
        f"to bf16 greedy's: {agree:.4f}")
    return {"quantized_tensors": n, "bytes_before": before,
            "bytes_after": after, "agreement_with_bf16": agree}


def _tail_demo(totals):
    """examples/serving/demo_torch.py as a user runs it, in process."""
    import contextlib
    import sys
    demo = _load("examples", "serving", "demo_torch.py")
    tee = _Tee(sys.stdout)
    log(f"[decoder-tail-demo] demo_torch.main({DEMO_ARGV})")
    with contextlib.redirect_stdout(tee):
        res, c = _counted(lambda: demo.main(DEMO_ARGV))
    text = "".join(tee.parts)
    assert set(res) == set(demo.MODES + demo.ENGINE_MODES) \
        and "done" in text, text[-2000:]
    assert "speculative == greedy: True" in text, text[-2000:]
    times = dict(re.findall(r"^(\w+)\s+([0-9.]+)s$", text, re.M))
    _add(totals, c)
    log(f"[decoder-tail-demo] launches {json.dumps(c)}, times {times}")
    return {"seconds": {k: float(v) for k, v in times.items()},
            "launches": c}


def _add(totals, counts):
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def phase_decoder_tail(smi):
    """Phase 17: the rest of the decoder families.  The kernels at this
    phase's shapes; T5 at t5-base's widths and LoRA at TinyLlama's, each
    trained captured through make_step; decoding at GPT-2 small's widths
    (beam search, speculative decoding, int8 weights); the converters'
    round trip; the serving demo."""
    t0 = time.time()
    rows, totals, results, counts = {}, {}, {}, {}
    counts["t5"], results["t5"] = _tail_t5(smi, totals)
    log(f"[time] decoder-tail t5 in {time.time() - t0:.1f} s")
    # the kernels at this phase's shapes: the optimizer's at T5-base's
    # flat length, the flash forward at beam search's, the LayerNorm
    # forward at a decode step's
    rows.update(_tail_opt_rows(results["t5"]["flat_length"], "t5"))
    rows.update(_tail_flash_rows([n for n in GEN_PROMPTS
                                  for _ in range(TAIL_BEAMS)], "beam"))
    rows.update(_tail_ln_rows(len(GEN_PROMPTS), "decode"))
    log(f"[time] decoder-tail kernel checks and rows in "
        f"{time.time() - t0:.1f} s")
    counts["lora"], results["lora"] = _tail_lora(smi, totals)
    log(f"[time] decoder-tail lora in {time.time() - t0:.1f} s")
    decode_counts, results["decode"] = _tail_decode(totals)
    log(f"[time] decoder-tail decode in {time.time() - t0:.1f} s")
    results["demo"] = _tail_demo(totals)
    log(f"[time] decoder-tail demo in {time.time() - t0:.1f} s")
    log(f"[decoder-tail] launches over the phase's paths: "
        f"{json.dumps(totals)}")
    for k in TAIL_KERNELS:
        assert totals.get(k, 0) > 0, f"decoder-tail: {k} never launched"
    # each row's launches from the path of its shape
    for key, row in rows.items():
        row["variant"] = key
        if key.endswith(":t5"):
            row["launches"] = counts["t5"][1][0][row["name"]]
        elif key == "flash_fwd:beam":
            row["launches"] = decode_counts["beam4_bf16"]["flash_fwd"]
        else:
            row["launches"] = decode_counts["greedy_bf16"]["layer_norm_fwd"]
    results["launches"] = totals
    log("decoder_tail " + json.dumps(results))
    return list(rows.values()), counts


# -- phase 18: the serving engines --------------------------------------------

SRV_SLOTS = 16
SRV_BUF = 2048                      # TinyLlama's positions
SRV_WINDOW = 8
SRV_REQUESTS = 48                   # three waves of SRV_SLOTS
SRV_WAVE_AT = 12                    # windows between two waves
SRV_PLEN = (32, 1024)
SRV_NEW = (32, 256)
SRV_SOLO = (0, 9, 17, 26, 38, 47)   # greedy requests re-run alone
SRV_SAMPLED = 16                    # seeded sampled requests, 4 re-run
SRV_SAMPLED_PLEN, SRV_SAMPLED_NEW = (32, 256), (32, 64)
SRV_TEMP, SRV_TOP_K = 0.8, 40
SRV_BLOCK = 16
SRV_BLOCKS = SRV_SLOTS * (SRV_BUF // SRV_BLOCK) // 2   # half the worst case
S2S_SRC, S2S_NEW = 512, 128         # Seq2SeqEngine at t5-base's widths
S2S_PLEN = (64, S2S_SRC)
GPT2_SRV_BUF = 1024
GPT2_PREFIX = 256                   # the registered system prefix
GPT2_PLEN, GPT2_NEW = (16, 256), (32, 128)
GPT2_CHUNK = 32                     # the splice's suffix chunk
SPEC_SLOTS, SPEC_GAMMA = 8, 4
SRV_FP32_NEW = 64                   # (h)'s first wave, cut, in fp32
SRV_PROFILE_AT = 6                  # the window the profile starts at
SRV_EAGER_WINDOWS = 6               # windows held against the eager engine


def _srv_traffic(seed, n, plen, new, vocab, low=0, seeded=False):
    """``n`` requests (prompt, max_new, kwargs), lengths and ids from
    ``seed``; ``seeded``: each with an explicit sampling seed."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = [int(t) for t in rs.randint(low, vocab,
                                        int(rs.randint(plen[0],
                                                       plen[1] + 1)))]
        out.append((p, int(rs.randint(new[0], new[1] + 1)),
                    {"seed": SEED + i} if seeded else {}))
    return out


def _srv_eager(eng):
    """The engine with every graph run eagerly (the plain path)."""
    for g in eng._graphs:
        g.eager = True
    return eng


def _srv_step(eng):
    """One ``eng.step()``: its output, wall ms and host reads (sync debug
    mode), with where in Python each read was made."""
    import traceback
    import warnings
    where = []

    def record(message, category, filename, lineno, *rest):
        if "synchroniz" in str(message).lower():
            # where torch saw the wait, and the innermost frame of the
            # repository's code that led there
            root = str(Path(__file__).resolve().parent)
            ours = [f for f in traceback.extract_stack()[:-1]
                    if f.filename.startswith(root)]
            at = f"{Path(filename).name}:{lineno}"
            if ours and ours[-1].filename != filename:
                at += f" via {Path(ours[-1].filename).name}:{ours[-1].lineno}"
            where.append(at)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return out, ms, where


def _srv_run(eng, traffic, tag, profile=False, windows_max=None):
    """``traffic`` through ``eng`` in waves of SRV_SLOTS, one every
    SRV_WAVE_AT windows (or only its first ``windows_max`` windows): each
    window's output, wall time and host reads, tok/s and tokens a host
    read over the windows timed (a profiled stretch of three windows left
    out of both), the device's idle share (its device time a profiled
    window against the median timed window), TTFT of the requests, the
    results in order, the windows run in all."""
    waves = [traffic[i:i + SRV_SLOTS]
             for i in range(0, len(traffic), SRV_SLOTS)]
    rids, outs, step_ms, windows, nxt = [], [], [], 0, 0
    reads, where = 0, Counter()
    excl_s, prof, n_prof = 0.0, None, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while nxt < len(waves) or eng.live() or eng.queue_depth():
        if windows_max is not None and len(outs) >= windows_max:
            break
        if nxt < len(waves) and windows >= nxt * SRV_WAVE_AT:
            rids += [eng.submit(p, n, **kw) for p, n, kw in waves[nxt]]
            nxt += 1
            continue
        if not (eng.live() or eng.queue_depth()):
            windows += 1                # idle until the next wave
            continue
        if profile and windows == SRV_PROFILE_AT and step_ms:
            tp = time.perf_counter()

            def counted_step():
                nonlocal n_prof
                eng.step()
                n_prof += 1

            prof = phase_profile(counted_step, statistics.median(step_ms),
                                 f"{tag}-profile", steps=3)
            excl_s += time.perf_counter() - tp
            windows += 3
            continue
        out, ms, w = _srv_step(eng)
        # keyed by the request's place in the traffic (rids differ when
        # an engine served its warmup's requests first)
        index = {r: i for i, r in enumerate(rids)}
        outs.append({index[r]: t for r, t in out.items()})
        step_ms.append(ms)
        reads += len(w)
        where.update(w)
        windows += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - excl_s
    done = [r for r in rids if eng.is_finished(r)]
    results = [eng.result(r) if eng.is_finished(r) else None for r in rids]
    tokens = sum(len(eng.result(r)) for r in done)
    ttft = [eng._finished[r].t_first - eng._finished[r].t_submit
            for r in done if eng._finished[r].t_first is not None]
    timed_tok = sum(len(t) for o in outs for t in o.values())
    median = statistics.median(step_ms)
    return {"results": results, "outs": outs, "tokens": tokens,
            "tok_s": timed_tok / wall if wall > 0 else 0.0,
            "tokens_per_sync": timed_tok / len(step_ms),
            "wall_s": wall, "windows": len(step_ms),
            "windows_run": len(step_ms) + n_prof, "step_ms": step_ms,
            "step_ms_median": median,
            "step_ms_p90": float(np.percentile(step_ms, 90)),
            "host_reads_per_window": reads / len(step_ms),
            "host_reads_at": dict(where),
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else None,
            "profile": prof,
            "profile_idle_share": (1 - sum(prof.values()) / median
                                   if prof else None)}


def _srv_agreement(a, b):
    """The share of tokens of the results ``a`` equal to ``b``'s, position
    by position (a shorter list counts its missing tokens as unequal)."""
    eq = total = 0
    for x, y in zip(a, b):
        total += max(len(x), len(y))
        eq += sum(int(u == v) for u, v in zip(x, y))
    return eq / max(total, 1)


def _srv_path(tag, make, traffic, expect, eager=True, check=None):
    """One engine path: warmup() captures exactly the census's admission
    and decode graphs; the traffic, captured, with the launch counts set to
    0 just before and read just after, adds no capture (a prefix-pool
    graph captures at its second use) and launches each kernel exactly
    ``expect(run)`` times (run: the run's numbers, ``windows_run`` the
    windows it decoded); its first SRV_EAGER_WINDOWS
    windows through an identical engine run eagerly emit the same tokens
    window by window, bitwise; ``check(engine)`` holds after the captured
    run.  Returns the captured run's numbers, its results and counts."""
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    eng = make()
    census = eng.compile_census()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = {k for k, st in census.items() if st in ("admission", "decode")}
    assert set(eng.captures) == warm, (tag, eng.captures, census)
    captured = dict(eng.captures)
    run, counts = _counted(lambda: _srv_run(eng, traffic, tag,
                                            profile=True))
    want = {k: v for k, v in expect(run).items() if v}
    _check_counts(tag, {**{k: 0 for k in want}, **counts},
                  want)
    assert set(eng.captures) <= set(census), (tag, eng.captures)
    if not any(st.startswith(("register", "prefix"))
               for st in census.values()):
        assert eng.captures == captured, (tag, eng.captures, captured)
    if check is not None:
        check(eng)
    st = eng.stats()
    out = {k: v for k, v in run.items()
           if k not in ("results", "outs", "profile", "step_ms",
                        "tokens_per_sync")}
    out.update(
        warmup_s=warm_s, captures=dict(eng.captures), launches=counts,
        stats_ttft_p50_s=st["ttft"]["p50"], stats_ttft_p99_s=st["ttft"]["p99"],
        tokens_per_sync=run["tokens_per_sync"],
        kv_cache_bytes=eng.kv_cache_bytes(),
        peak_gib=(torch.cuda.max_memory_allocated() - floor) / 2 ** 30,
        device_ms_per_window=(sum(run["profile"].values())
                              if run["profile"] else None))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["graph_pool_held_gib"] = (torch.cuda.memory_reserved()
                                  - torch.cuda.memory_allocated()) / 2 ** 30
    log(f"[{tag}] captured: {run['tokens']} tokens, {run['tok_s']:.1f} tok/s,"
        f" step_ms median {run['step_ms_median']:.3f} (p90 "
        f"{run['step_ms_p90']:.3f}) over {run['windows']} windows, "
        f"{run['host_reads_per_window']:.3f} host reads a window "
        f"({run['host_reads_at']}), device idle share (a profiled "
        f"window's device time against the median window) "
        f"{run['profile_idle_share']}, TTFT p50/p99 {run['ttft_p50_s']:.4f} "
        f"/ {run['ttft_p99_s']:.4f} s (stats(), the warmup's requests too: "
        f"{out['stats_ttft_p50_s']:.4f} / {out['stats_ttft_p99_s']:.4f}), "
        f"{out['tokens_per_sync']:.2f} tokens a sync, peak "
        f"{out['peak_gib']:.2f} GiB above the model, KV "
        f"{out['kv_cache_bytes']} B, graph pool held "
        f"{out['graph_pool_held_gib']:.3f} GiB, launches {counts}, captures "
        f"{eng.captures} (census {census})")
    results, outs = run["results"], run["outs"]
    del eng
    if eager:
        gc.collect()
        torch.cuda.empty_cache()
        ref = _srv_eager(make())
        n = SRV_EAGER_WINDOWS
        er = _srv_run(ref, traffic, tag + "-eager", windows_max=n)
        assert er["outs"] == outs[:n], \
            f"[{tag}] a captured window differs from the eager window"
        def rate(o, ms):
            # tokens a second over the windows alone
            return sum(len(t) for w in o for t in w.values()) / (
                sum(ms) / 1e3)

        out.update(eager_windows=n,
                   eager_tok_s=rate(er["outs"], er["step_ms"]),
                   captured_tok_s_same_windows=rate(outs[:n],
                                                    run["step_ms"][:n]),
                   eager_step_ms_median=er["step_ms_median"],
                   captured_step_ms_median_same_windows=statistics.median(
                       run["step_ms"][:n]),
                   eager_host_reads_per_window=er["host_reads_per_window"])
        log(f"[{tag}] the first {n} windows, eager against captured: "
            f"{out['eager_tok_s']:.1f} against "
            f"{out['captured_tok_s_same_windows']:.1f} tok/s, step_ms "
            f"median {er['step_ms_median']:.3f} against "
            f"{out['captured_step_ms_median_same_windows']:.3f}, "
            f"{er['host_reads_per_window']:.3f} host reads a window; each "
            f"window's tokens bitwise the captured window's")
        del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out, results, counts


def _srv_alone(tag, make, traffic, which, want):
    """Each request of ``which`` alone in an identically built engine
    (captured): its tokens bitwise those it got with traffic."""
    eng = make().warmup()
    for i in which:
        p, n, kw = traffic[i]
        rid = eng.add_request(p, n, **kw)
        while not eng.is_finished(rid):
            eng.step()
        assert eng.result(rid) == want[i], \
            f"[{tag}] request {i} alone differs from it with traffic"
    log(f"[{tag}] requests {list(which)} alone in an identical engine: "
        f"bitwise their tokens with traffic")
    del eng
    gc.collect()


def _srv_flash_row(shape, tag):
    """The flash forward at an admission's full-buffer prefill shape,
    causal, bf16: within phase 3's fp64 bound, timed against its plain
    version and SDPA (is_causal), the bound counting the causal half."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import flash_attention as fa
    B, H, T, D = shape
    errs, rat = _flash_check(shape, torch.bfloat16, "causal", SEED + 101)
    log(f"[serving] flash at {shape} bf16 causal: within the fp64 bounds "
        f"(ratio kernel {rat['kernel']:.3e}, plain {rat['plain']:.3e}); max "
        f"abs err {errs}")
    q, k, v, _, _, _, words = _flash_case(B, H, T, D, torch.bfloat16,
                                          SEED + 101)
    args = (H, D ** -0.5, True, None, None, words, 0.0)
    q4, k4, v4 = (t.view(B, H, T, D) for t in (q, k, v))
    n, isz = B * H * T * D, q.element_size()
    timing = {f"flash_fwd:{tag}": (
        4 * n * isz + B * H * T * 4, 2 * B * H * T * T * D,
        lambda: ops.flash_fwd(q, k, v, *args),
        lambda: fa._fwd_plain(q, k, v, *args),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))}
    rows = _time_rows(timing, {"flash_fwd": errs["flash_fwd"]},
                      f"{shape} (B, H, T, D) bf16, causal, one admission's "
                      f"prefill layer", plain_graph=(2, 5))
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _srv_fp32_pair(tag, make_a, make_b, traffic):
    """Two engines on one traffic; the share of equal tokens."""
    res = []
    for make in (make_a, make_b):
        eng = make().warmup()
        res.append(_serve_list(eng, traffic))
        del eng
        gc.collect()
    return _srv_agreement(res[0], res[1]), res


def _srv_chunks(plen, L, C, buf):
    """The splice's suffix chunks for a prompt of ``plen`` tokens whose
    first ``L`` are a registered prefix (``Engine._admit``'s loop)."""
    n, off = 0, L
    while off < plen:
        off = min(off, buf - C) + C
        n += 1
    return n


def _serve_list(eng, traffic):
    rids = [eng.submit(p, n, **kw) for p, n, kw in traffic]
    while eng.live() or eng.queue_depth():
        eng.step()
    return [eng.result(r) for r in rids]


def phase_serving(smi):
    """Phase 18: the serving engines on the card, their decode windows and
    admissions replaying CUDA graphs.  (h) Engine at TinyLlama-1.1B's
    widths, (i) PagedEngine on (h)'s traffic, (j) Seq2SeqEngine at
    t5-base's widths, (k) the prefix pool and (l) speculative decoding at
    GPT-2 small's widths; the flash and LayerNorm forward kernels at the
    serving shapes; the demo's engine modes."""
    from apex_tpu_torch import models, serving
    dev = torch.device(DEVICE)
    t0 = time.time()
    rows, counts, summary = {}, {}, {"card": smi}
    rows.update(_srv_flash_row((1, 32, SRV_BUF, 64), "serving-tinyllama"))
    rows.update(_srv_flash_row((1, 12, GPT2_SRV_BUF, 64), "serving-gpt2"))
    # GPT-2's LayerNorm rows on paths (k) and (l): decode ticks, the
    # admissions' prefill, the splice's chunks, the draft's ticks and the
    # target's verify chunk
    ln_shapes = {"serving": (SRV_SLOTS, "25 calls a decode tick"),
                 "serving-prefill": (GPT2_SRV_BUF, "24 calls a prefill "
                                     "(12 a draft's)"),
                 "serving-chunk": (GPT2_CHUNK, "25 calls a splice chunk"),
                 "serving-spec-draft": (SPEC_SLOTS, "13 calls a draft "
                                        "tick"),
                 "serving-spec-verify": (SPEC_SLOTS * (SPEC_GAMMA + 1),
                                         "25 calls a verify")}
    for tag, (n, calls) in ln_shapes.items():
        rows.update(_tail_ln_rows(n, tag, calls))
    log(f"[time] serving kernel rows in {time.time() - t0:.1f} s")

    # (h) Engine at TinyLlama's widths, bf16 -----------------------------
    llama = models.Llama(tinyllama(), device=dev, generator=torch.Generator(
        ).manual_seed(SEED)).to(torch.bfloat16).eval()
    traffic = _srv_traffic(SEED + 40, SRV_REQUESTS, SRV_PLEN, SRV_NEW,
                           tinyllama().vocab_size)

    def fixed():
        return serving.Engine(llama, slots=SRV_SLOTS, buf_len=SRV_BUF,
                              window=SRV_WINDOW)

    n_tl = tinyllama().num_hidden_layers
    summary["h"], res_h, counts["h"] = _srv_path(
        "serving-h", fixed, traffic,
        lambda run: {"flash_fwd": SRV_REQUESTS * n_tl})
    _srv_alone("serving-h", fixed, traffic, SRV_SOLO, res_h)
    sampled_tr = _srv_traffic(SEED + 41, SRV_SAMPLED, SRV_SAMPLED_PLEN,
                              SRV_SAMPLED_NEW, tinyllama().vocab_size,
                              seeded=True)
    kw = dict(slots=SRV_SLOTS, buf_len=SRV_BUF, temperature=SRV_TEMP,
              top_k=SRV_TOP_K, rng=SEED)
    eng = serving.Engine(llama, window=SRV_WINDOW, **kw).warmup()
    res_s = _serve_list(eng, sampled_tr)
    del eng
    _srv_alone("serving-h-sampled K=1", lambda: serving.Engine(
        llama, window=1, **kw), sampled_tr, range(4), res_s)
    summary["h"]["sampled_tokens"] = sum(len(r) for r in res_s)
    log(f"[time] serving (h) in {time.time() - t0:.1f} s")

    # (i) PagedEngine on (h)'s traffic -----------------------------------
    def paged():
        return serving.PagedEngine(
            llama, slots=SRV_SLOTS, buf_len=SRV_BUF, block_size=SRV_BLOCK,
            num_blocks=SRV_BLOCKS, window=SRV_WINDOW)

    def all_blocks_back(eng):
        assert eng.stats()["blocks_free"] == SRV_BLOCKS, eng.stats()

    summary["i"], res_i, counts["i"] = _srv_path(
        "serving-i", paged, traffic, lambda run: {}, check=all_blocks_back)
    summary["i"]["agreement_with_h"] = _srv_agreement(res_i, res_h)
    summary["i"]["requests_equal_to_h"] = sum(
        a == b for a, b in zip(res_i, res_h))
    del llama
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serving-i] paged against (h), bf16: "
        f"{summary['i']['agreement_with_h']:.4f} of the tokens, "
        f"{summary['i']['requests_equal_to_h']} of "
        f"{SRV_REQUESTS} requests equal; every block back on the free stack")
    # (i) against (h) in fp32 (TF32 off, phase 1) at TinyLlama's widths,
    # on (h)'s first wave with its new tokens cut to SRV_FP32_NEW
    llama32 = models.Llama(tinyllama(), device=dev,
                           generator=torch.Generator().manual_seed(
                               SEED)).eval()
    cut = [(p, min(n, SRV_FP32_NEW), kw)
           for p, n, kw in traffic[:SRV_SLOTS]]
    fp32 = {}
    fp32["paged_vs_fixed_tinyllama"], _ = _srv_fp32_pair(
        "i-fp32", lambda: serving.PagedEngine(
            llama32, slots=SRV_SLOTS, buf_len=SRV_BUF,
            block_size=SRV_BLOCK, num_blocks=SRV_BLOCKS,
            window=SRV_WINDOW),
        lambda: serving.Engine(llama32, slots=SRV_SLOTS, buf_len=SRV_BUF,
                               window=SRV_WINDOW), cut)
    log(f"[serving-i] paged against (h) in fp32 on {len(cut)} requests: "
        f"{fp32['paged_vs_fixed_tinyllama']:.4f} of the tokens")
    del llama32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] serving (i) in {time.time() - t0:.1f} s")

    # (j) Seq2SeqEngine at t5-base's widths, bf16 ------------------------
    t5 = models.T5(t5_base(), device=dev, generator=torch.Generator(
        ).manual_seed(SEED)).to(torch.bfloat16).eval()
    s2s_tr = _srv_traffic(SEED + 42, SRV_REQUESTS, S2S_PLEN,
                          (S2S_NEW // 4, S2S_NEW), t5_base().vocab_size,
                          low=2)

    def s2s():
        return serving.Seq2SeqEngine(t5, slots=SRV_SLOTS, src_len=S2S_SRC,
                                     max_new_cap=S2S_NEW, window=SRV_WINDOW)

    summary["j"], res_j, counts["j"] = _srv_path("serving-j", s2s, s2s_tr,
                                                 lambda run: {})
    _srv_alone("serving-j", s2s, s2s_tr, SRV_SOLO[:4], res_j)
    del t5
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] serving (j) in {time.time() - t0:.1f} s")

    # (k) prefix pool and (l) speculative at GPT-2 small's widths --------
    t16 = _gpt2_small(dev).to(torch.bfloat16)
    d16 = models.GPT(distilgpt2(), device=dev, generator=torch.Generator(
        ).manual_seed(SEED + 1)).to(torch.bfloat16).eval()
    rs = np.random.RandomState(SEED + 43)
    prefix = [int(t) for t in rs.randint(0, 50257, GPT2_PREFIX)]
    fresh = _srv_traffic(SEED + 44, 32, GPT2_PLEN, GPT2_NEW, 50257)
    pre_tr = [((prefix + p) if i % 2 == 0 else p, n, kw)
              for i, (p, n, kw) in enumerate(fresh)]

    def with_prefix(model):
        def make():
            eng = serving.Engine(model, slots=SRV_SLOTS,
                                 buf_len=GPT2_SRV_BUF, window=SRV_WINDOW,
                                 prefix_pool=1, prefix_chunk=GPT2_CHUNK)
            eng.register_prefix(prefix)
            return eng
        return make

    # GPT-2's LayerNorms: two a block, and the final one where a forward
    # returns its hidden state (not in a prefill); flash once a block of
    # each prefill.  By shape, from the run's windows and its traffic.
    n_t, n_d = models.gpt2_small().n_layer, distilgpt2().n_layer
    n_fresh = sum(p[:GPT2_PREFIX] != prefix for p, _, _ in pre_tr)
    chunks = sum(_srv_chunks(len(p), GPT2_PREFIX, GPT2_CHUNK, GPT2_SRV_BUF)
                 for p, _, _ in pre_tr if p[:GPT2_PREFIX] == prefix)
    ln_at = {}

    def expect_k(run):
        ln_at["serving"] = run["windows_run"] * SRV_WINDOW * (2 * n_t + 1)
        ln_at["serving-prefill"] = n_fresh * 2 * n_t
        ln_at["serving-chunk"] = chunks * (2 * n_t + 1)
        return {"flash_fwd": n_fresh * n_t,
                "layer_norm_fwd": sum(ln_at.values())}

    summary["k"], res_k, counts["k"] = _srv_path("serving-k",
                                                 with_prefix(t16), pre_tr,
                                                 expect_k)
    plain16 = lambda: serving.Engine(t16, slots=SRV_SLOTS,  # noqa: E731
                                     buf_len=GPT2_SRV_BUF,
                                     window=SRV_WINDOW)
    res_plain = _serve_list(plain16().warmup(), pre_tr)
    summary["k"]["bf16_agreement_splice_vs_prefill"] = _srv_agreement(
        res_k, res_plain)
    spec_tr = _srv_traffic(SEED + 45, 16, GPT2_PLEN, (32, 32), 50257)

    def spec16():
        return serving.Engine(t16, slots=SPEC_SLOTS, buf_len=GPT2_SRV_BUF,
                              draft=d16, gamma=SPEC_GAMMA)

    def expect_l(run):
        # a round: SPEC_GAMMA draft ticks, one verify chunk of the target
        ln_at["serving-prefill"] += len(spec_tr) * 2 * (n_t + n_d)
        ln_at["serving-spec-draft"] = (run["windows_run"] * SPEC_GAMMA
                                       * (2 * n_d + 1))
        ln_at["serving-spec-verify"] = run["windows_run"] * (2 * n_t + 1)
        return {"flash_fwd": len(spec_tr) * (n_t + n_d),
                "layer_norm_fwd": len(spec_tr) * 2 * (n_t + n_d)
                + ln_at["serving-spec-draft"]
                + ln_at["serving-spec-verify"]}

    summary["l"], res_l, counts["l"] = _srv_path("serving-l", spec16,
                                                 spec_tr, expect_l)
    res_greedy = _serve_list(serving.Engine(
        t16, slots=SPEC_SLOTS, buf_len=GPT2_SRV_BUF,
        window=SRV_WINDOW).warmup(), spec_tr)
    summary["l"]["bf16_agreement_with_greedy"] = _srv_agreement(
        res_l, res_greedy)
    del t16, d16
    gc.collect()
    torch.cuda.empty_cache()
    # fp32 (TF32 off, phase 1): splice against a fresh prefill, speculative
    # against greedy, paged against fixed, the engine against solo
    # generate_cached
    t32 = _gpt2_small(dev)
    d32 = models.GPT(distilgpt2(), device=dev, generator=torch.Generator(
        ).manual_seed(SEED + 1)).eval()
    fp32["splice_vs_prefill"], _ = _srv_fp32_pair(
        "k-fp32", with_prefix(t32), lambda: serving.Engine(
            t32, slots=SRV_SLOTS, buf_len=GPT2_SRV_BUF, window=SRV_WINDOW),
        pre_tr[:16])
    fp32["speculative_vs_greedy"], (res_sp, _) = _srv_fp32_pair(
        "l-fp32", lambda: serving.Engine(t32, slots=SPEC_SLOTS,
                                         buf_len=GPT2_SRV_BUF, draft=d32,
                                         gamma=SPEC_GAMMA),
        lambda: serving.Engine(t32, slots=SPEC_SLOTS, buf_len=GPT2_SRV_BUF,
                               window=SRV_WINDOW), spec_tr[:SPEC_SLOTS])
    fp32["paged_vs_fixed"], _ = _srv_fp32_pair(
        "i-fp32", lambda: serving.PagedEngine(
            t32, slots=SRV_SLOTS, buf_len=GPT2_SRV_BUF,
            block_size=SRV_BLOCK, window=SRV_WINDOW),
        lambda: serving.Engine(t32, slots=SRV_SLOTS, buf_len=GPT2_SRV_BUF,
                               window=SRV_WINDOW), fresh[:16])
    solo = []
    for p, n, _ in spec_tr[:SPEC_SLOTS]:
        buf = torch.zeros((1, GPT2_SRV_BUF), dtype=torch.int64, device=dev)
        buf[0, :len(p)] = torch.tensor(p, device=dev)
        out, fl = t32.generate_cached(buf, len(p), n)
        solo.append(out[0, len(p):int(fl[0])].tolist())
    fp32["engine_vs_solo_generate_cached"] = _srv_agreement(res_sp, solo)
    summary["fp32_agreement"] = fp32
    for k, v in fp32.items():
        assert v == 1.0, f"[serving] fp32 {k}: {v} of the tokens agree"
    log(f"[serving] fp32 agreement (TF32 off): {json.dumps(fp32)}, each "
        f"required 1.0; bf16: "
        f"splice against a fresh prefill "
        f"{summary['k']['bf16_agreement_splice_vs_prefill']:.4f}, "
        f"speculative against greedy "
        f"{summary['l']['bf16_agreement_with_greedy']:.4f}")
    del t32, d32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] serving (k), (l) in {time.time() - t0:.1f} s")

    # the demo's engine modes, as examples/serving/demo_torch.py runs them
    demo = _load("examples", "serving", "demo_torch.py")
    args = demo.parse_args(DEMO_ARGV)
    block = args.block or (args.prompt + args.new)
    target = demo.build(args.layers, args.width, 0, args.vocab, block, dev)
    drs = np.random.RandomState(0)
    (st_e, n_e), c_e = _counted(lambda: demo.run_engine(target, args, block,
                                                        drs))
    (st_s, n_s), _ = _counted(lambda: demo.run_seq2seq(args, drs, dev))
    assert st_e["finished"] == st_s["finished"] == 2 * args.batch
    assert st_e["prefix_hits"] == args.batch
    summary["demo"] = {"engine_tokens": n_e, "seq2seq_tokens": n_s,
                       "engine_launches": c_e}
    log(f"[serving-demo] engine: {n_e} tokens over {st_e['finished']} "
        f"requests ({st_e['prefix_hits']} by splice), seq2seq: {n_s} tokens")
    # each row's launches: those at its shape on the paths that run it
    # (the path totals held exactly above)
    rows["flash_fwd:serving-tinyllama"]["launches"] = counts["h"]["flash_fwd"]
    rows["flash_fwd:serving-gpt2"]["launches"] = (counts["k"]["flash_fwd"]
                                                  + counts["l"]["flash_fwd"])
    assert sum(ln_at.values()) == (counts["k"]["layer_norm_fwd"]
                                   + counts["l"]["layer_norm_fwd"])
    for tag, n in ln_at.items():
        rows[f"layer_norm_fwd:{tag}"]["launches"] = n
    log(f"[serving] LayerNorm launches of (k) and (l) by shape: "
        f"{json.dumps({f'({ln_shapes[t][0]}, 768)': n for t, n in ln_at.items()})}")
    for key, row in rows.items():
        row["variant"] = key
    log(f"[time] phase 18 in {time.time() - t0:.1f} s")
    log("serving " + json.dumps(summary, default=str))
    return list(rows.values()), summary


# -- phase 19: the wider data-parallel stack ----------------------------------

DP_GPT_BATCH, DP_GPT_SEQ = 8, 1024      # phase 16's GPT-2 small batch
DP_SHARDS = (3, 8)                      # ZeRO windows of ResNet-50's buffer
DP_EXAMPLE_ITERS = 10


def _nccl_kernels(call) -> tuple:
    """The NCCL kernels of one ``call()`` (a replay) by name, and its
    device-to-device copies, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out, copies = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        if "nccl" in evt.key.lower():
            out[evt.key[:80]] = out.get(evt.key[:80], 0) + evt.count
        elif "memcpy" in evt.key.lower() and "dtod" in evt.key.lower():
            copies += evt.count
    return out, copies


def _dp_state(opt, names=None) -> dict:
    """Clones of what a step writes: masters (the window's first
    ``layout.total`` elements under ZeRO), moments, step, scale."""
    n = opt.masters.layout.total
    st = opt.state
    return {"masters": opt.masters.buf[:n].clone(),
            "m": st.m[:n].clone(), "v": st.v[:n].clone(),
            "step": st.step.clone(),
            "scale": opt.scalers[0].loss_scale.clone()}


def _dp_twins(tag, a, b, what) -> int:
    """Two runs' losses and states bitwise; returns the tensors held."""
    la, sa = a
    lb, sb = b
    assert same(la, lb), f"[{tag}] losses {la.tolist()} against {what} " \
        f"{lb.tolist()}"
    for k in sa:
        assert same(sa[k], sb[k]), f"[{tag}] {k} differs from {what}"
    return len(sa) + 1


def _dp_eager(step, batch, opt):
    losses = torch.stack([step(batch).float().reshape(())
                          for _ in range(CAPTURE_HOLD)])
    torch.cuda.synchronize()
    return losses, _dp_state(opt)


# On one rank NCCL runs a collective as a copy (or nothing, in place) and
# launches none of its kernels: a replay's NCCL kernels are exactly 0
DP_NCCL = 0
DP_NCCL_WHY = ("a one-rank communicator launches no NCCL kernel; its "
               "collectives {}")


def _dp_path(tag, model, opt, step, batch, per, smi, items, gens=(),
             make=None, twin=None, nccl=DP_NCCL, collectives=""):
    """A path of phase 19: 8 eager steps held bitwise against the twin's
    (``twin``: (losses, state) of the plain step from the same start),
    then ``_captured_path`` (graph against eager, exact launch counts,
    step_ms, idle share, peak memory, the graph's pool), then the NCCL
    kernels of one replay against ``nccl``; ``collectives`` names the
    step's collectives for the log."""
    nccl_why = DP_NCCL_WHY.format(collectives)
    from apex_tpu_torch import parallel
    held = 0
    if twin is not None:
        snap = _snapshot(model, opt, gens)
        held = _dp_twins(tag, _dp_eager(step, batch, opt), twin, "the twin")
        log(f"[{tag}] {CAPTURE_HOLD} eager steps: losses and {held - 1} "
            f"state tensors bitwise the twin's")
        _restore(model, opt, gens, snap)
        del snap
    counts, out = _captured_path(tag, model, opt, step, batch, per, smi,
                                 items, gens=gens, make=make)
    if make is None:
        def make(fn, k):
            return parallel.make_step(fn, model, steps_per_call=k)
    train = make(step, 1)
    for _ in range(2):                  # the warm-up, the capture
        train(batch)
    kernels, copies = _nccl_kernels(lambda: train(batch))
    got = sum(kernels.values())
    log(f"[{tag}] one replay: {got} NCCL kernels (expected {nccl}: "
        f"{nccl_why}) {json.dumps(kernels)}, {copies} device-to-device "
        f"copies")
    assert nccl is None or got == nccl, f"[{tag}] {got} NCCL kernels"
    out["nccl_kernels_per_step"] = got
    out["dtod_copies_per_step"] = copies
    out["twin_tensors_bitwise"] = held
    del train
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def _dp_resnet(smi):
    """(m) ResNet-50 O2 + FusedAdam, the ImageNet example's step, under
    ZeRO-1 over the one-rank group, against the same step unsharded; then
    the example itself with --zero."""
    from apex_tpu_torch import amp, models, optimizers

    def build():
        model = models.resnet50(
            device=DEVICE, generator=torch.Generator().manual_seed(SEED))
        return amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                              opt_level="O2", verbosity=0)
    batch = _batch(np.random.RandomState(SEED), BATCH, IMAGE, 1000, DEVICE)
    model, opt = build()
    twin = _dp_eager(_resnet_functional(model, opt), batch, opt)
    del model, opt
    model, opt = build()
    opt.zero_shard()
    z = opt.masters.zero
    log(f"[dp-m] resnet50 O2 FusedAdam, ZeRO-1 over the one-rank group: "
        f"window {z.shard_n} of {z.padded} (N {opt.masters.layout.total}), "
        f"batch {BATCH}: scaled_grad, step(grads) (reduce-scatter, update "
        f"of the window, all-gather) through make_step")
    per = {"multi_tensor_scale": 1, "fused_adam": 1,
           "syncbn_fwd": BN_LAYERS, "syncbn_bwd": BN_LAYERS}
    counts, out = _dp_path(
        "dp-m", model, opt, _resnet_functional(model, opt), batch, per, smi,
        (BATCH, "images"), twin=twin,
        collectives="(a reduce-scatter, the overflow flag's and the grad "
                    "norm's all-reduces, the fp32 and half all-gathers)")
    del model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    # the example as a user runs it, on this phase's group
    ips, ex_counts, text, _, _ = _run_example(
        _example(), "dp-m-example",
        ["--arch", "resnet50", "-b", str(BATCH), "--image-size", str(IMAGE),
         "--iters", str(DP_EXAMPLE_ITERS), "--print-freq", "5",
         "--fused-adam", "--zero"])
    assert "ZeRO-1 optimizer-state sharding" in text, text[-2000:]
    steps = EXAMPLE_WARMUP + DP_EXAMPLE_ITERS
    _check_counts("dp-m-example", ex_counts,
                  {"multi_tensor_scale": steps, "fused_adam": steps,
                   "syncbn_fwd": BN_LAYERS * steps,
                   "syncbn_bwd": BN_LAYERS * steps})
    log(f"[dp-m-example] --zero: {ips:.1f} img/s over "
        f"{DP_EXAMPLE_ITERS} iterations")
    out["example_images_per_s"] = ips
    return counts, out


def _dp_bert(smi):
    """(n) BERT-base O2 + FusedAdam through the hook path (scale_loss,
    backward, step()) under DDP with overlap=True and the hierarchical
    topology (ici_size=1), against the flat after-backward hook path."""
    from apex_tpu_torch import amp, models, optimizers, parallel
    cfg = models.bert_base()
    batch = _bert_batch(cfg.vocab_size, np.random.RandomState(SEED),
                        BERT_BATCH, BERT_SEQ, DEVICE)

    def build(**kw):
        model, opt, gen = _bert_model(cfg, optimizers.FusedAdam(lr=1e-4))
        ddp = parallel.DistributedDataParallel(model, **kw)

        def step(b):
            loss = ddp.module.loss(*b)
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            return loss.detach()
        return model, opt, gen, ddp, step
    model, opt, gen, ddp, step = build()
    twin = _dp_eager(step, batch, opt)
    del model, opt, gen, ddp, step
    gc.collect()
    model, opt, gen, ddp, step = build(overlap=True,
                                       comm_topology="hierarchical",
                                       ici_size=1)
    # a bucket a grad dtype (bf16, and the LayerNorms' fp32)
    buckets = len({p.dtype for p in model.parameters()})
    log(f"[dp-n] BertForPretraining(bert_base) O2 FusedAdam, dropout "
        f"{cfg.hidden_dropout_prob}, {BERT_BATCH} x {BERT_SEQ}, the hook "
        f"path (scale_loss, backward, step()) under "
        f"DistributedDataParallel(overlap=True, comm_topology="
        f"'hierarchical', ici_size=1), {buckets} buckets, against the flat "
        f"after-backward hook path")
    per = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
           "fused_adam": 1, "layer_norm_fwd": LN_PER_PASS,
           "layer_norm_bwd": LN_PER_PASS, "flash_fwd": FLASH_PER_PASS,
           "flash_dq": FLASH_PER_PASS, "flash_dkv": FLASH_PER_PASS}
    counts, out = _dp_path(
        "dp-n", model, opt, step, batch, per, smi, (BERT_BATCH, "sequences"),
        gens=[gen], make=lambda fn, k: ddp.make_step(fn, k), twin=twin,
        collectives=f"({buckets} buckets of a reduce-scatter, a cross-node "
                    f"all-reduce and an all-gather, on the comm stream)")
    out["buckets"] = buckets
    del model, opt, gen, ddp, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


class _StagedGPT(torch.nn.Module):
    """GPT-2 small's embeddings, blocks and final LayerNorm with an untied
    head (the staged schedule gives a parameter to one stage): 14 stages,
    the embeddings, the 12 blocks, the final LayerNorm with the head."""

    def __init__(self, gpt):
        super().__init__()
        self.wte, self.wpe, self.drop = gpt.wte, gpt.wpe, gpt.drop
        self.h, self.ln_f = gpt.h, gpt.ln_f
        self.head = torch.nn.Parameter(gpt.wte.weight.detach().clone())

    def stages(self):
        from apex_tpu_torch.nn import functional as F

        def embed(p, ids):
            pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
            return self.drop(self.wte(ids) + self.wpe(pos))

        def block(i):
            return lambda p, x: self.h[i](x)

        def final(p, x):
            return F.matmul(self.ln_f(x), self.head.t())
        fns = [embed] + [block(i) for i in range(len(self.h))] + [final]
        params = ([[self.wte.weight, self.wpe.weight]]
                  + [list(b.parameters()) for b in self.h]
                  + [[self.ln_f.weight, self.ln_f.bias, self.head]])
        return fns, params

    def forward(self, ids):
        fns, params = self.stages()
        x = ids
        for fn, p in zip(fns, params):
            x = fn(p, x)
        return x


def _gpt_nll(logits, ids):
    from apex_tpu_torch.nn.functional import cross_entropy
    return cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         ids[:, 1:].reshape(-1))


def _dp_gpt_build():
    """The untied GPT-2 small under O2 with every parameter bf16 (one dtype
    a stage) and a static loss scale of 1 (the staged update runs without
    a scaler), dropout 0.1, random weights from the seed."""
    from apex_tpu_torch import amp, models, optimizers
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    gpt = models.GPT(models.gpt2_small(), device=DEVICE,
                     generator=torch.Generator().manual_seed(SEED),
                     dropout_generator=gen)
    model = _StagedGPT(gpt).train()
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                opt_level="O2", keep_batchnorm_fp32=False,
                                loss_scale=1.0, verbosity=0)
    return model, opt, gen


def _dp_gpt(smi):
    """(o) the untied GPT-2 small under ZeRO-2 through
    staged_zero2_allreduce_grads (a stage's grads scatter-reduced, its
    window updated by FusedAdam's kernel on fp32 masters, the bf16 params
    gathered back, all on the comm stream as the stage's grads arrive),
    and (p) the same model under ZeRO-3 (zero_gather_params under
    zero_gather_checkpoint_policy), each against ZeRO-1 of the model."""
    from apex_tpu_torch import amp, optimizers, parallel
    rs = np.random.RandomState(SEED)
    ids = torch.from_numpy(rs.randint(0, DECODER_TOKENS, (
        DP_GPT_BATCH, DP_GPT_SEQ)).astype(np.int64)).to(DEVICE)
    counts, out = {}, {}

    # the twin: ZeRO-1, the monolithic backward
    model, opt, gen = _dp_gpt_build()
    opt.zero_shard()

    def z1_step(b):
        loss, g = amp.scaled_grad(lambda: _gpt_nll(model(b), b), opt)
        opt.step(g)
        return loss
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    twin = _dp_eager(z1_step, ids, opt)
    z1_peak = torch.cuda.max_memory_allocated() - floor
    log(f"[dp-o] the twin, ZeRO-1 of the model: {CAPTURE_HOLD} eager steps, "
        f"peak above the state {z1_peak} B ({z1_peak / 2**30:.2f} GiB)")
    halves = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, gen
    gc.collect()
    torch.cuda.empty_cache()

    # (o)
    model, opt, gen = _dp_gpt_build()
    ddp = parallel.DistributedDataParallel(
        model, comm_topology="hierarchical", ici_size=1, overlap=True,
        zero_stage=2)
    fns, params = model.stages()
    inner = optimizers.FusedAdam(lr=1e-4)
    windows = []
    for leaves in params:
        buf = torch.cat([p.detach().float().reshape(-1) for p in leaves])
        windows.append((buf, inner.init(buf), torch.empty_like(
            buf, dtype=torch.bfloat16)))

    def update(stage, p_shard, g_shard):
        buf, st, half = windows[stage]
        inner.step(buf, st, g_shard.float(), half=half)
        return half

    def o_step(b):
        loss, new = ddp.staged_zero2_allreduce_grads(
            fns, lambda logits: _gpt_nll(logits, b), params, b, update)
        with torch.no_grad():
            for leaves, vals in zip(params, new):
                for p, v in zip(leaves, vals):
                    p.copy_(v)
        return loss

    log(f"[dp-o] GPT-2 small widths, untied head, O2 all bf16, FusedAdam(lr "
        f"1e-4) on fp32 masters a stage, dropout 0.1, {DP_GPT_BATCH} x "
        f"{DP_GPT_SEQ}: staged_zero2_allreduce_grads over {len(fns)} stages "
        f"(overlap=True, hierarchical, ici_size=1)")
    losses = torch.stack([o_step(ids).float() for _ in range(CAPTURE_HOLD)])
    torch.cuda.synchronize()
    assert same(losses, twin[0]), \
        f"[dp-o] losses {losses.tolist()} against ZeRO-1 {twin[0].tolist()}"
    by_stage = {}
    for leaves, (buf, st, half) in zip(params, windows):
        off = 0
        for p in leaves:
            by_stage[id(p)] = (buf[off:off + p.numel()],
                               st.m[off:off + p.numel()])
            off += p.numel()
    pnames = {id(p): n for n, p in model.named_parameters()}
    lay = opt.masters.layout
    for leaves in params:
        for p in leaves:
            n = pnames[id(p)]
            i = lay.names.index(n)
            o, k = lay.offsets[i], lay.sizes[i]
            assert same(p.detach(), halves[n]), f"[dp-o] param {n}"
            assert same(by_stage[id(p)][0], twin[1]["masters"][o:o + k]), \
                f"[dp-o] master {n}"
            assert same(by_stage[id(p)][1], twin[1]["m"][o:o + k]), \
                f"[dp-o] m {n}"
    fields = parallel.overlap_schedule_fields(ddp.last_overlap_schedule)
    log(f"[dp-o] {CAPTURE_HOLD} eager steps: losses, the bf16 params, the "
        f"fp32 masters and m bitwise ZeRO-1's ({len(lay.names)} tensors); "
        f"schedule {json.dumps(fields)}")
    per = {"fused_adam": len(fns), "layer_norm_fwd": 25,
           "layer_norm_bwd": 25, "flash_fwd": 12, "flash_dq": 12,
           "flash_dkv": 12}

    class _Windows:
        """The stages' windows as one optimizer for the snapshots; the
        model's bf16 params view the amp optimizer's half buffer."""
        masters = type("M", (), {"half": opt.masters.half})()

        @staticmethod
        def state_dict():
            return {str(i): {"buf": b, "m": st.m, "v": st.v,
                             "step": st.step, "half": h}
                    for i, (b, st, h) in enumerate(windows)}
    counts["o"], out["o"] = _dp_path(
        "dp-o", model, _Windows, o_step, ids, per, smi,
        (DP_GPT_BATCH, "sequences"), gens=[gen],
        collectives=f"({len(fns)} stages of a reduce-scatter, a cross-node "
                    f"all-reduce and an all-gather, on the comm stream)")
    del model, opt, gen, ddp, windows, params, fns
    gc.collect()
    torch.cuda.empty_cache()

    # (p)
    model, opt, gen = _dp_gpt_build()
    opt.zero_shard(zero_stage=3, zero_ici_size=1)

    def p_step(b):
        with amp.zero_gather_checkpoint_policy(opt):
            loss, g = amp.scaled_grad(lambda: _gpt_nll(
                torch.func.functional_call(
                    model, amp.zero_gather_params(opt), (b,)), b), opt)
        opt.step(g)
        return loss
    log(f"[dp-p] the same model under ZeRO-3 (zero_shard(zero_stage=3, "
        f"zero_ici_size=1)): the forward through functional_call on "
        f"zero_gather_params under zero_gather_checkpoint_policy (the "
        f"backward regathers), the grad window into step(grads)")
    counts["p"], out["p"] = _dp_path(
        "dp-p", model, opt, p_step, ids, {
            "multi_tensor_scale": 1, "fused_adam": 1,
            "layer_norm_fwd": 25, "layer_norm_bwd": 25, "flash_fwd": 12,
            "flash_dq": 12, "flash_dkv": 12},
        smi, (DP_GPT_BATCH, "sequences"), gens=[gen], twin=twin,
        collectives="(the half gather, its regather in the backward, the "
                    "grads' reduce-scatter, the cross-node all-reduce, the "
                    "overflow flag's and the grad norm's all-reduces)")
    out["p"]["zero1_eager_peak_bytes"] = z1_peak
    out["p"]["zero_dropped_saves"] = opt.zero_dropped_saves
    assert opt.zero_dropped_saves > 0, \
        "[dp-p] the ZeRO-3 policy dropped no save of a gathered parameter"
    log(f"[dp-p] the policy dropped {opt.zero_dropped_saves} saves of the "
        f"gathered parameters in the last traced forward (regathered in "
        f"the backward)")
    del model, opt, gen
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def _dp_adam_rows():
    """The Adam kernel on every ZeRO window of ResNet-50's flat buffer
    padded to 3 and to 8 windows (odd windows over 3: bases off 16 bytes),
    bitwise its plain version, nothing outside the window written; and
    its time on one ZeRO-1 window of 3, with its bound and the library's
    fused Adam on the same window."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for shards in DP_SHARDS:
        shard = -(-N_FULL // shards)
        total = shard * shards

        def padded(scale=1.0, positive=False):
            t = torch.randn(N_FULL, device=DEVICE, generator=gen) * scale
            t = t.abs() if positive else t
            return torch.cat([t, torch.zeros(total - N_FULL, device=DEVICE)])
        p, m, v = padded(), padded(0.1, True), padded(0.01, True)
        g = padded()
        half = p.to(torch.bfloat16)
        args = (torch.tensor(1e-3, device=DEVICE),
                torch.tensor(0.5, device=DEVICE), 0.9, 0.999, 1e-8, False,
                0.01)
        for i in range(shards):
            win = slice(i * shard, (i + 1) * shard)
            before = [t.clone() for t in (p, m, v, half)]
            plain = [t[win].clone() for t in (p, m, v)]
            ph = half[win].clone()
            ops.fused_adam(p[win], m[win], v[win], g[win], *args,
                           half=half[win])
            adam_mod._adam_plain(*plain, g[win], *args, ph, None)
            for t, want in zip((p, m, v, half), plain + [ph]):
                assert same(t[win], want), f"[dp-adam] {shards} window {i}"
            keep = torch.ones(total, dtype=torch.bool, device=DEVICE)
            keep[win] = False
            for t, old in zip((p, m, v, half), before):
                assert same(t[keep], old[keep]), \
                    f"[dp-adam] {shards} window {i} wrote outside"
            # the sharded step's layout: fp32 operands of their own, the
            # half copy in place in the full buffer
            own = [t[win].clone() for t in (p, m, v)]
            plain = [t.clone() for t in own]
            hw, ph = half[win], half[win].clone()
            ops.fused_adam(*own, g[win], *args, half=hw)
            adam_mod._adam_plain(*plain, g[win], *args, ph, None)
            for t, want in zip(own + [hw], plain + [ph]):
                assert same(t, want), f"[dp-adam] {shards} own window {i}"
        log(f"[dp-adam] N {N_FULL} in {shards} windows of {shard} (padded "
            f"to {total}; bases {[i * shard * 4 % 16 for i in range(shards)]}"
            f" bytes off 16): every window bitwise the plain version, "
            f"nothing outside it written; and each window's fp32 operands "
            f"as their own allocations with the half copy in place, bitwise")
        if shards == DP_SHARDS[0]:
            rows.update(_dp_adam_times(p, m, v, g, half, shard, args))
        del p, m, v, g, half
    return rows


def _dp_adam_times(p, m, v, g, half, shard, args):
    """The Adam kernel timed on window 1 of 3, in two layouts: every
    operand a window of its padded buffer (fp32 bases 12 bytes off 16:
    a scalar head of one element, then 16-byte vectors and paired half
    stores), and the sharded step's own (the fp32 window, moments and
    grads its own allocations, the half copy written in place in the full
    half buffer, 6 bytes off 8: vectors and single half stores)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    win = slice(shard, 2 * shard)
    own = [t[win].clone() for t in (p, m, v, g)]
    rows = {}
    for key, (pk, mk, vk, gk), hk in (
            ("fused_adam:zero_window", [t[win] for t in (p, m, v, g)],
             half[win]),
            ("fused_adam:zero_window_own", own, half[win])):
        plan = adam_mod._vector_plan(pk, mk, vk, gk, hk)
        pp, mp, vp, hp = (t.clone() for t in (pk, mk, vk, hk))
        lib = pk.clone()
        lib.grad = gk.clone()
        lib_adam = torch.optim.Adam([lib], lr=1e-3, fused=True,
                                    capturable=True)
        nbytes = 30 * shard    # reads p m v g, writes p m v and the half
        kms = graph_ms(lambda: ops.fused_adam(pk, mk, vk, gk, *args,
                                              half=hk))
        pms = graph_ms(lambda: adam_mod._adam_plain(pp, mp, vp, gk, *args,
                                                    hp, None))
        lms = graph_ms(lib_adam.step)
        bound = nbytes / MEM_BYTES_PER_S * 1e3
        rows[key] = {"name": "fused_adam", "route": "cuda",
                     "source": SOURCE["fused_adam"],
                     "replaces": REPLACES["fused_adam"], "launches": 0,
                     "max_abs_err": 0.0, "ms": kms, "plain_ms": pms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lms, "n": shard, "bytes": nbytes,
                     "vector_plan": list(plan)}
        log(f"[dp-adam] {key}: window 1 of 3, n {shard}, (head, paired "
            f"half stores) {plan}: kernel_ms {kms:.4f} bound_ms "
            f"{bound:.4f} ({nbytes} B) plain_ms {pms:.4f} library_ms "
            f"{lms:.4f} (device time, graph replay)")
    return rows


def phase_dp(smi):
    """Phase 19: the wider data-parallel stack at world 1 over NCCL, paths
    (m) to (p), each held bitwise against its eager run and its plain
    twin, and the Adam kernel on ZeRO windows."""
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    counts, results = {}, {}
    try:
        rows = _dp_adam_rows()
        counts["m"], results["m"] = _dp_resnet(smi)
        counts["n"], results["n"] = _dp_bert(smi)
        got, res = _dp_gpt(smi)
        counts.update(got)
        results.update(res)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = det
    p = results["p"]
    log(f"[dp-p] peak above the state, eager: ZeRO-3 "
        f"{p['eager_peak_bytes']} B against ZeRO-1 "
        f"{p['zero1_eager_peak_bytes']} B; captured: ZeRO-3 "
        f"{p['graphs'][1]['peak_bytes']} B against the staged ZeRO-2 "
        f"{results['o']['graphs'][1]['peak_bytes']} B.  At world 1 a window "
        f"is the whole buffer: ZeRO-3 saves only the gathered parameters it "
        f"does not keep between the forward and the backward")
    log("dp " + json.dumps(results))
    return counts, results, rows


def _check_counts(tag: str, counts, expect) -> None:
    """Each wrapper launched exactly as often as the path needs it, and the
    wrappers of other paths not at all."""
    log(f"kernels {tag} {json.dumps(counts)}")
    for k, c in counts.items():
        assert c == expect.get(k, 0), \
            f"{tag}: {k} launched {c} times, expected {expect.get(k, 0)}"


def _check_decoder_counts(counts, counts_examples) -> None:
    """Phase 16: each decoder's launches over its captured calls, and each
    example run's."""
    _check_captured_counts({f"decoder-{k}": v for k, v in counts.items()})
    for run, expect in _decoder_example_counts().items():
        _check_counts(f"example-{run}", counts_examples[run], expect)


def _check_tail_counts(counts) -> None:
    """Phase 17's graphs: T5's and LoRA's launches over their captured
    calls."""
    _check_captured_counts({f"decoder-tail-{k}": v
                            for k, v in counts.items()})


def _decoder_rows(rows, counts):
    """Phase 16's kernel rows, each with its launches on the decoder path
    of its shape (the captured calls of phase 16)."""
    out = []
    for key, row in rows.items():
        path = "gpt2" if key.endswith(":gpt2") else "tinyllama"
        row["variant"] = key
        row["launches"] = counts[path][1][0][row["name"]]
        out.append(row)
    return out


def _check_dp_counts(counts, rows) -> None:
    """Phase 19's graphs: each path's launches over its captured calls;
    the Adam window row takes the launches of path (m)."""
    _check_captured_counts({f"dp-{k}": v for k, v in counts.items()})
    for row in rows.values():
        row["launches"] = counts["m"][1][0][row["name"]]


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
    dec_rows, counts_dec, counts_dec_ex, decoder = phase_decoder(smi)
    log(f"[time] phase 16 done at {time.time() - t0:.1f} s")
    tail_rows, counts_tail = phase_decoder_tail(smi)
    log(f"[time] phase 17 done at {time.time() - t0:.1f} s")
    serving_rows, _ = phase_serving(smi)
    log(f"[time] phase 18 done at {time.time() - t0:.1f} s")
    counts_dp, _, dp_rows = phase_dp(smi)
    log(f"[time] phase 19 done at {time.time() - t0:.1f} s")

    _check_counts("train", counts_train, RESNET_COUNTS)
    _check_counts("ddp", counts_ddp, RESNET_COUNTS)
    _check_counts("bert", counts_bert, BERT_COUNTS)
    _check_counts("bert-large", counts_large, BERT_LARGE_COUNTS)
    _check_counts("bert-o1", counts_bert_o1, BERT_O1_COUNTS)
    _check_counts("resnet-o1", counts_resnet_o1, RESNET_O1_COUNTS)
    for run, expect in EXAMPLE_COUNTS.items():
        _check_counts(f"imagenet-{run}", counts_imagenet[run], expect)
    _check_captured_counts(counts_captured)
    _check_decoder_counts(counts_dec, counts_dec_ex)
    _check_tail_counts(counts_tail)
    _check_dp_counts(counts_dp, dp_rows)
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
                    "decoder": decoder, "card": smi}))
    log("kernels_o1 " + json.dumps({"kernels": list(variants.values())}))
    log("kernels_decoder " + json.dumps(
        {"kernels": _decoder_rows(dec_rows, counts_dec)}))
    log("kernels_decoder_tail " + json.dumps({"kernels": tail_rows}))
    log("kernels_serving " + json.dumps({"kernels": serving_rows}))
    log("kernels_dp " + json.dumps({"kernels": list(dp_rows.values())}))
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
    elif sys.argv[1:2] == ["--decoder"]:
        # python3 chip_smoke.py --decoder: phases 1, 2 and 16 alone
        _, smi = phase_device()
        phase_build()
        dec_rows, counts_dec, counts_dec_ex, _ = phase_decoder(smi)
        _check_decoder_counts(counts_dec, counts_dec_ex)
        log("kernels_decoder " + json.dumps(
            {"kernels": _decoder_rows(dec_rows, counts_dec)}))
    elif sys.argv[1:2] == ["--decoder-tail"]:
        # python3 chip_smoke.py --decoder-tail: phases 1, 2 and 17 alone
        _, smi = phase_device()
        phase_build()
        tail_rows, counts_tail = phase_decoder_tail(smi)
        _check_tail_counts(counts_tail)
        log("kernels_decoder_tail " + json.dumps({"kernels": tail_rows}))
    elif sys.argv[1:2] == ["--serving"]:
        # python3 chip_smoke.py --serving: phases 1, 2 and 18 alone
        _, smi = phase_device()
        phase_build()
        serving_rows, _ = phase_serving(smi)
        log("kernels_serving " + json.dumps({"kernels": serving_rows}))
    elif sys.argv[1:2] == ["--dp"]:
        # python3 chip_smoke.py --dp: phases 1, 2 and 19 alone
        _, smi = phase_device()
        phase_build()
        counts_dp, _, dp_rows = phase_dp(smi)
        _check_dp_counts(counts_dp, dp_rows)
        log("kernels_dp " + json.dumps({"kernels": list(dp_rows.values())}))
    elif sys.argv[1:2] == ["--layer-norm-ab"]:
        # python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT
        phase_device()
        phase_build()
        parent_ops = load_ops(sys.argv[2])
        parent_ops._build.build_all(["layer_norm"])
        phase_layer_norm_ab(parent_ops)
    else:
        main()
