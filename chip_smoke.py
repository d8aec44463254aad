#!/usr/bin/env python3
"""Smoke run of apex_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --captured
    python3 chip_smoke.py --decoder
    python3 chip_smoke.py --decoder-tail
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --dp
    python3 chip_smoke.py --mp
    python3 chip_smoke.py --sp-pp
    python3 chip_smoke.py --legacy
    python3 chip_smoke.py --fleet
    python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT

The second form runs phases 1, 2 and 15 alone, the third phases 1, 2 and
16 (with 16's launch-count checks), the fourth phases 1, 2 and 17, the
fifth 1, 2 and 18, the sixth 1, 2 and 19, the seventh 1, 2 and 20, the
eighth 1, 2 and 21, the ninth 1, 2 and 22, the tenth 1, 2 and 23.  The
last builds the
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
14. l1      tests/L1/run_l1_torch.py's matrix on the card (its configs
            dealt to 4 spawned processes): ResNet-18 at
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
20. mp      tensor and expert parallelism on a one-rank NCCL group (each
            skips its collectives at world 1, as the JAX layers do at axis
            size 1): (q) Mixtral at Mixtral-8x7B's widths, one layer,
            O2 + FusedAdam(max_grad_norm=1.0), 2 x 2048 tokens, ep_axis
            the group, through make_step: 12 captured calls bitwise the
            eager steps and the ep_axis=None twin (the whole state, held
            in host memory), falling loss, the aux term above 1, exact
            launches, step_ms, device time by category, the dense
            dispatch's forward time; the flash kernels at (2, 32, 2048,
            128) bf16 causal (fp64 bounds at one sequence) and scale,
            l2norm and Adam at (q)'s flat length, against their plain
            versions and timed (the "kernels_mp" line); (r) TinyLlama's
            widths, four layers, under tp_axis from a non-TP model's
            weights through llama_params_to_tp, bitwise that model's
            step; (t) Mixtral two layers in fp32: generate_cached greedy
            token for token the uncached loop; (s) the same weights in
            bf16 served by Engine on (h)'s traffic, dropless, its windows
            captured and bitwise eager.
21. sp-pp   sequence and pipeline parallelism on a one-rank NCCL group
            (at world 1 the ring rotates nothing and the all-to-alls and
            the pipeline's exchanges are skipped): (u) TinyLlama's widths,
            four layers, under sp_axis (ring attention at n = 1) under O2
            + FusedAdam at 4 x 2048, 3 captured calls bitwise the eager
            steps, its losses against the non-SP twin (the flash path)
            within 1e-4; (v) examples/long_context/train_sp_torch.py at
            GPT-2 small's widths, T = 8192, --strategy ulysses and ring,
            falling losses, the first steps' within 1e-4, exact launches,
            and the flash kernels at its Ulysses shape (1, 12, 8192, 64)
            bf16 causal, they and their plain versions against fp64
            (two heads at a time), timed against SDPA (the "kernels_sp" line); (w)
            GPT-2 small's 12 blocks as one pipeline stage, 8 microbatches
            of (2, 1024, 768) under 1F1B with O2 + FusedAdam through
            make_step, 3 captured calls bitwise the eager steps, loss and
            grads against the sequential fallback, GPipe's forward bitwise
            the sequential one, and the peak memory of 1F1B against
            autograd through GPipe.
22. legacy  the Apex legacy surface and the sharded checkpoint.  (x)
            examples/dcgan/main_amp_torch.py in process at its defaults
            (O1, batch 64, nz 100, ngf = ndf = 64, 64x64, 200
            iterations), then at O2 for 20, each with exact launches an
            iteration (scale, l2norm and Adam twice, the syncbn forward 17
            times and backward 13), ms/it and peak memory; then its step in
            fp32 at ngf = ndf = 16, batch 8, 5 iterations, the card against
            the CPU from the same weights: losses and BatchNorm running
            statistics within 5e-3, their counts equal.  (y) an mLSTM at
            the width of Radford et al. 2017 (a 256 -> 64 byte embedding,
            one layer of 4096 units, a 4096 -> 256 decoder: 86,294,784
            parameters) in fp16 by network_to_half under the legacy
            FP16_Optimizer(FusedAdam(lr 5e-4), dynamic scale) on random
            bytes at 128 x 256, 6 steps with clip_master_grads: the first
            loss near ln 256, exact launches; one update through the
            kernels against their plain versions on the card (masters
            within a bound from the l2norm's summation order); an inf
            skipped bitwise; state_dict into a fresh optimizer and its next
            step bitwise; LSTM, GRU, ReLU, Tanh and a 2-layer bidirectional
            LSTM in fp32 on the card against the CPU.  The legacy amp
            handle (amp.init, OptimWrapper with two losses, the no-op
            handle) and the shims (multi_tensor_applier, _native's
            flatten).  (z) DCGAN's whole state through
            utils/checkpoint_orbax.py (torch.distributed.checkpoint), sync
            and async, restored bitwise, the next iteration bitwise, a torn
            save refused, keep pruning; examples/imagenet/main_amp_torch.py
            --zero --checkpoint-dir on a one-rank NCCL group, resnet18 at
            batch 128: three epochs of 3 iterations against the epoch-2
            checkpoint resumed, the third epoch's losses and the epoch-3
            checkpoints bitwise.  The kernel rows print as the
            "kernels_legacy" line: scale and Adam (no half copy) at G's and
            D's lengths, scale, l2norm and Adam (fp16 copy) at the mLSTM's,
            the syncbn forward and backward at DCGAN's 7 BatchNorm shapes
            in bf16 and fp32.
23. fleet   the serving fleet (apex_tpu_torch.fleet) over two GPT-2 small
            Engines on the one card (12 layers, width 768, vocab 50,257,
            bf16, random from SEED; 16 slots, window 8, buf_len 1,024),
            warmed once by Fleet.warmup(), on phase 18's traffic
            generator: 96 requests in three waves of 32, prompts of 32-768
            tokens, 32-256 new, greedy.  (aa) a one-replica fleet (the
            reference), then the fleet of two, least_loaded, with
            step_workers 1 and 2: every result the reference's, no
            failover, failure or shed, no capture after warmup(), exact
            flash and LayerNorm launches equal in both; tok/s, TTFT, the
            fleet's own host ms a tick, the device idle share of three
            profiled ticks.  (ab) replica 1 inside a FaultyReplica raising
            from its 20th step: every result the reference's, dead, the
            survivor capturing nothing, the flight ring dumped with the
            failover, MTTR, the fleet and trace records valid.  (ac) two
            QoS classes (interactive, with a deadline in ticks of a tick
            clock, over preemptible batch) with a SloController ticked
            every tick: every finished request its no-QoS reference's,
            preemptions each an engine's, no failover, some deadlines
            missed and the controller acting on them within its bound;
            TTFT by class, goodput, SLO attainment.  (ad) a prefix
            registered after warmup on a third engine, its splice graphs
            capturing during traffic under prefix_affinity with
            step_workers 2; the tokens those of a step_workers 1 run.
            Peak memory and each engine's graph pool.  The kernel rows
            print as the "kernels_fleet" line: the flash forward at (1,
            12, 1024, 64) bf16 causal, the LayerNorm forward at (16, 768),
            (1024, 768) and (32, 768) bf16, with phase 23's launches.

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

import contextlib
import gc
import json
import math
import os
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


def _time_rows(timing, err, per, plain_graph=(10, REPS),
               kernel_graph=(10, REPS)):
    """kernel, plain and library device time (``graph_ms``) of each entry
    of ``timing`` = name -> (bytes, flops, kernel, plain, library), the
    library a call or its time already taken; ``plain_graph`` the plain
    version's (calls a graph, replays timed), ``kernel_graph`` the
    kernel's and the library's."""
    rows = {}
    for key, (nbytes, flops, kern, plain, libcall) in timing.items():
        name = key.split(":")[0]      # "name:variant" times a variant
        kms, pms = graph_ms(kern, *kernel_graph), graph_ms(plain,
                                                           *plain_graph)
        lms = (libcall if isinstance(libcall, float)
               else graph_ms(libcall, *kernel_graph))
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


def _flash_check(shape, dtype, variant, seed, lengths=None, ref_rows=None):
    """The three flash kernels and their plain versions, each against
    fp64: an output within one rounding to its type of the fp64 value plus
    (u + 256*2^-24) of the fp64 sum of its terms' magnitudes (u: the
    rounding of P and dS to the type; 256*2^-24: the fp32 sums, exp and the
    scores' rounding), plus the rounding of P and dS values too small for
    the type's normal range (fp16).  A fully masked row must be exactly
    0.  ``lengths`` (B,): the key-padding mask keeps each sequence's
    first ``lengths[b]`` keys (default: a random mask, the first sequence
    all masked).  ``ref_rows``: the fp64 reference ``ref_rows`` of the
    B*H (T, D) rows at a time, where the whole would not fit (variants
    without a key mask, segments or dropout, whose rows are
    independent)."""
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
    rows = ref_rows or B * H
    assert rows == B * H or not (kvm is not None or seg is not None
                                 or rate), "rows hold masks"
    for who, out in (("kernel", got), ("plain", want)):
        for lo in range(0, B * H, rows):
            part = slice(lo, lo + rows)
            ref = _flash_ref64(q[part], k[part], v[part], do[part],
                               out["o"][part], *args)
            for name, (r64, mag, floor) in ref.items():
                bound = (u * r64.abs() + (u + 256 * EPS32) * mag
                         + TINY[dtype] * floor)
                r = worst_ratio((out[name][part].double() - r64).abs(),
                                bound)
                assert r <= 1.0, (f"flash {who} {name} {shape} {dtype} "
                                  f"{variant} rows {lo}+: {r} of the fp64 "
                                  f"bound")
                ratios[who] = max(ratios[who], r)
            del ref
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


L1_PROCS = 4        # the matrix's host-bound eager steps, in parallel


def _l1_part(args):
    """Configs ``part::L1_PROCS`` of the L1 matrix, run in a worker process
    of phase_l1: (per-config results, summary)."""
    part, device, iters, batch, image = args
    torch.set_num_threads(max(1, (os.cpu_count() or L1_PROCS) // L1_PROCS))
    l1 = _load("tests", "L1", "run_l1_torch.py")
    return l1.run(l1.FULL_MATRIX[part::L1_PROCS], device, iters, batch,
                  image, log=lambda line: None)


def phase_l1():
    """tests/L1/run_l1_torch.py's matrix on the card: ResNet-18 under the
    48 amp configs, each twice (bitwise the same), the O0 ones also on the
    CPU (within the tolerance that file states); the configs dealt to
    L1_PROCS processes (spawned, joined before the phase ends), since each
    eager step waits on the host."""
    import multiprocessing
    l1 = _load("tests", "L1", "run_l1_torch.py")
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(L1_PROCS) as pool:
        parts = pool.map(_l1_part, [(p, DEVICE, L1_ITERS, L1_BATCH, L1_IMAGE)
                                    for p in range(L1_PROCS)])
    results = [parts[i % L1_PROCS][0][i // L1_PROCS]
               for i in range(len(l1.FULL_MATRIX))]
    for r in results:
        log(f"[l1] {json.dumps(r)}")
    summary = {k: sum(part[1][k] for part in parts)
               for k in ("total", "bitwise_repeatable", "cpu_checked",
                         "within_tolerance", "ok")}
    summary["failures"] = [f for part in parts for f in part[1]["failures"]]
    summary["processes"] = L1_PROCS
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


def tinyllama(layers: int = TL_LAYERS, **kw):
    """TinyLlama/TinyLlama-1.1B's published config.json widths (of its 22
    layers, ``layers``): hidden 2048, intermediate 5632, 32 heads, 4 KV
    heads, vocab 32000, 2048 positions, RMS eps 1e-5, rope theta 10000,
    untied head; ``kw`` more of LlamaConfig's fields (``tp_axis``)."""
    from apex_tpu_torch import models
    return models.LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=layers, num_attention_heads=32,
        num_key_value_heads=4, max_position_embeddings=2048,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
        **kw)


def _seeded(build, seed):
    """``build(device)`` on the meta device, its parameters then drawn on
    the card from ``seed`` with the modules' distributions: N(0, 0.02)
    embeddings and router, N(0, 2 / fan_in) expert banks, U(+-1/sqrt(
    fan_in)) linear weights, norms at one.  For the Llama family (no
    biases): the modules draw on the CPU, 8 s at TinyLlama's widths and
    minutes at Mixtral's."""
    with torch.device("meta"):
        model = build(torch.device("meta"))
    model = model.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() == 1:
                p.fill_(1.0)
            elif "embed" in name or leaf == "router":
                p.normal_(0.0, 0.02, generator=gen)
            elif leaf in ("w_in", "w_gate", "w_out"):
                p.normal_(0.0, (2.0 / p.shape[1]) ** 0.5, generator=gen)
            else:
                b = p.shape[1] ** -0.5
                p.uniform_(-b, b, generator=gen)
    return model


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
    llama = _seeded(lambda d: models.Llama(tinyllama(), device=d), SEED)
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
    base = _seeded(lambda d: models.Llama(tinyllama(), device=d), SEED)
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
        f"/ {run['ttft_p99_s']:.4f} s (stats(): "
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
    llama = _seeded(lambda d: models.Llama(tinyllama(), device=d),
                    SEED).to(torch.bfloat16).eval()
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
    llama32 = _seeded(lambda d: models.Llama(tinyllama(), device=d),
                      SEED).eval()
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


# -- phase 20, tensor and expert parallelism with Mixtral -------------------

MX_BATCH, MX_SEQ = 2, 2048          # (q): 2 x 2048 tokens
MX_LAYERS = 1                       # (q)'s depth: the only cut
MX_STEPS = 12                       # held: eager, captured, ep_axis=None twin
MX_LR, MX_CLIP = 1e-4, 1.0
MX_SERVE_LAYERS = 2                 # (s), (t)
MX_SERVE_CF = 8.0                   # capacity_factor = n_experts: dropless
FLASH_MX = (MX_BATCH, 32, MX_SEQ, 128)
FLASH_MX_HELD = (1, 32, MX_SEQ, 128)
TP_CALLS = 3                        # (r): warm-up, capture, one replay held
TP_LAYERS = 4                       # (r)'s depth: the only cut, for time
MX_CHUNK = 1 << 27                  # elements a chunk of a state comparison
MX_PLAIN_CHUNKS = 8                 # the plain Adam over the flat length
# a step of (q): the unscale, the l2norm of AmpOptimizer.step's grad norm
# and of FusedAdam's clip (max_grad_norm), Adam, and the flash kernels of
# its one layer; (r): (e)'s step at TP_LAYERS
MX_PER_STEP = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 2,
               "fused_adam": 1, "flash_fwd": MX_LAYERS, "flash_dq": MX_LAYERS,
               "flash_dkv": MX_LAYERS}
TP_PER_STEP = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
               "fused_adam": 1, "flash_fwd": TP_LAYERS, "flash_dq": TP_LAYERS,
               "flash_dkv": TP_LAYERS}


def mixtral_8x7b(layers: int, **kw):
    """mistralai/Mixtral-8x7B-v0.1's published config.json widths: vocab
    32000, hidden 4096, intermediate 14336, 32 heads and 8 KV heads (head
    dim 128), 8 experts, top-2, router_aux_loss_coef 0.02, RMS eps 1e-5,
    rope theta 1e6, 32768 positions, untied head; ``layers`` deep."""
    from apex_tpu_torch import models
    return models.MixtralConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=layers, num_attention_heads=32,
        num_key_value_heads=8, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1e6, tie_word_embeddings=False,
        num_local_experts=8, num_experts_per_tok=2,
        router_aux_loss_coef=0.02, **kw)


def _mx_held(tag, snap, opt):
    """The optimizer's live state (masters, moments, step, scalers, the
    half copy) bitwise a host ``_snapshot``, chunk by chunk: at (q)'s size
    a whole-tensor compare on the card would need 24 GB more."""
    live = dict(_flat_state(opt.state_dict()))
    pairs = [(live[k], snap["opt"][k], k) for k in live]
    pairs.append((opt.masters.half, snap["half"], "half"))
    n = 0
    for t, h, k in pairs:
        a, b = t.reshape(-1), h.reshape(-1)
        for i in range(0, max(a.numel(), 1), MX_CHUNK):
            assert same(a[i:i + MX_CHUNK], b[i:i + MX_CHUNK].to(a.device)), \
                f"[{tag}] {k} differs"
        n += a.numel()
    return n


def _mx_train(smi):
    """(q): Mixtral at Mixtral-8x7B's widths, MX_LAYERS deep, under O2 +
    FusedAdam(max_grad_norm) through make_step with ep_axis the one-rank
    NCCL group: from one state, MX_STEPS eager steps, the captured step's
    MX_STEPS calls and the ep_axis=None twin's eager steps, losses and the
    whole state bitwise alike; the loss falls and the aux term is finite
    and above 1; launch counts exact; step_ms eager and captured, replay
    ms, device time by category, idle share, peak and the graph's pool."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    floor = _mem_floor()
    cfg = mixtral_8x7b(MX_LAYERS, ep_axis=dist.group.WORLD)
    model = _seeded(lambda d: models.Mixtral(cfg, device=d), SEED + 110)
    n_params = sum(p.numel() for p in model.parameters())
    model, opt = amp.initialize(
        model, optimizers.FusedAdam(lr=MX_LR, max_grad_norm=MX_CLIP),
        opt_level="O2", verbosity=0)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(SEED + 110).randint(
        0, DECODER_TOKENS, (MX_BATCH, MX_SEQ))).to(DEVICE)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
        opt.step(grads)
        return loss

    log(f"[mp-q] Mixtral-8x7B widths, {MX_LAYERS} layer: {n_params} "
        f"parameters (flat length {opt.masters.layout.total}), O2 + "
        f"FusedAdam(lr={MX_LR}, max_grad_norm={MX_CLIP}), capacity_factor "
        f"{cfg.capacity_factor}, {MX_BATCH} x {MX_SEQ} tokens, ep_axis a "
        f"one-rank NCCL group ({smi}); state above the floor "
        f"{torch.cuda.memory_allocated() - floor} B")
    s0 = _snapshot(model, opt, (), host=True)
    eager_floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed(lambda: step(ids), MX_STEPS)
    eager = torch.stack([o.float() for o in outs])
    eager_peak = torch.cuda.max_memory_allocated() - eager_floor
    vals = eager.tolist()
    assert all(math.isfinite(v) for v in vals), vals
    assert vals[-1] < vals[0], f"[mp-q] loss did not fall: {vals}"
    d12 = _snapshot(model, opt, (), host=True)
    eager_ms = statistics.median(ms[2:])
    log(f"[mp-q] eager: losses {['%.4f' % v for v in vals]}, step_ms median "
        f"{eager_ms:.2f} (steps 3-{MX_STEPS}), peak above the state "
        f"{eager_peak} B ({eager_peak / 2**30:.2f} GiB)")

    _restore(model, opt, (), s0)
    floor_g = _mem_floor()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    train = parallel.make_step(step, model)
    got, counts = _counted(lambda: _timed(lambda: train(ids), MX_STEPS))
    outs, call_ms = got
    assert same(torch.stack([o.float() for o in outs]), eager), \
        f"[mp-q] captured losses {[float(o) for o in outs]} against {vals}"
    n_held = _mx_held("mp-q captured", d12, opt)
    assert train.replays == MX_STEPS - 1, train.replays
    expect = {k: v * MX_STEPS for k, v in MX_PER_STEP.items()}
    _check_counts("mp-q", {**{k: 0 for k in expect}, **counts}, expect)
    _, tms = _timed(lambda: train(ids), CAPTURE_TIMED)
    peak = torch.cuda.max_memory_allocated() - floor_g
    step_ms = statistics.median(tms)
    replay = _replay_ms(train)
    by_cat = phase_profile(lambda: train(ids), step_ms, tag="mp-q-profile",
                           steps=2)
    del train
    _mem_floor()
    held = torch.cuda.memory_reserved() - reserved
    log(f"[mp-q] captured: {MX_STEPS} calls, losses and {n_held} state "
        f"elements bitwise the eager run's; step_ms median {step_ms:.2f} "
        f"over {CAPTURE_TIMED} replays (eager {eager_ms:.2f}), "
        f"{MX_BATCH * MX_SEQ / step_ms * 1e3:.1f} tok/s, one replay "
        f"{replay:.2f} ms by CUDA events, peak above the state {peak} B "
        f"({peak / 2**30:.2f} GiB), held by the graph {held} B "
        f"({held / 2**30:.2f} GiB), capture in call 2 {call_ms[1]:.0f} ms; "
        f"free on the card {torch.cuda.mem_get_info()[0]} B")

    # the ep_axis=None twin: the same model with its MoE layers local
    _restore(model, opt, (), s0)
    model.cfg.ep_axis = None
    for blk in model.layers:
        blk.mlp.axis_name = None
    twin = torch.stack([step(ids).float() for _ in range(MX_STEPS)])
    assert same(twin, eager), f"[mp-q] twin {twin.tolist()} against {vals}"
    _mx_held("mp-q twin", d12, opt)
    with torch.no_grad():
        _, aux = model._backbone(ids)
    aux = float(aux)
    assert math.isfinite(aux) and aux > 1.0, aux
    log(f"[mp-q] the ep_axis=None twin: {MX_STEPS} eager steps, losses and "
        f"state bitwise; the aux term after training {aux:.4f} (finite, "
        f"above 1)")
    dispatch = _mx_dispatch_ms(model.layers[0].mlp, cfg, step_ms)
    out = {"parameters": n_params, "flat_length": opt.masters.layout.total,
           "eager_losses": vals, "eager_step_ms": eager_ms,
           "eager_peak_bytes": eager_peak, "step_ms": step_ms,
           "replay_ms": replay, "peak_bytes": peak, "held_bytes": held,
           "tokens_per_s": MX_BATCH * MX_SEQ / step_ms * 1e3,
           "profile_ms": by_cat, "aux": aux, "launches": counts,
           "capture_call_ms": call_ms[1], "dispatch_forward_ms": dispatch}
    del model, opt, s0, d12
    _mem_floor()
    return counts, out


def _mx_dispatch_ms(moe, cfg, step_ms):
    """Forward device time (graph replay) at (q)'s shapes of the dense
    GShard dispatch, the JAX package's design: the routing that builds the
    (T, E, C) dispatch and combine tensors, the two einsums over them, and
    the experts' batched matmuls beside them."""
    T = MX_BATCH * MX_SEQ
    C = max(1, math.ceil(cfg.capacity_factor * T / cfg.num_local_experts))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 115)
    x2d = torch.randn(T, cfg.hidden_size, generator=gen,
                      device=DEVICE).to(torch.bfloat16)
    with torch.no_grad():
        disp, comb, _ = moe._dispatch(x2d, moe.router, C)
        sent = torch.einsum("tec,td->ecd", disp.to(x2d.dtype), x2d)
        got = moe._expert_mlp(sent)
        out = {"routing_ms": graph_ms(
            lambda: moe._dispatch(x2d, moe.router, C), 2, 10),
            "einsums_ms": graph_ms(lambda: (
                torch.einsum("tec,td->ecd", disp.to(x2d.dtype), x2d),
                torch.einsum("tec,ecd->td", comb.to(got.dtype), got)), 2,
                10),
            "experts_ms": graph_ms(lambda: moe._expert_mlp(sent), 2, 10)}
    out["share_of_step"] = (out["routing_ms"] + out["einsums_ms"]) / step_ms
    log(f"[mp-q] the dense dispatch at T = {T}, E = "
        f"{cfg.num_local_experts}, C = {C}, forward alone: routing "
        f"{out['routing_ms']:.3f} ms, dispatch and combine einsums "
        f"{out['einsums_ms']:.3f} ms, against the experts' matmuls "
        f"{out['experts_ms']:.3f} ms; routing and einsums "
        f"{out['share_of_step']:.2%} of the captured step")
    return out


def _tp_run(tag, model, ids):
    """A TinyLlama-width model under O2 + FusedAdam(lr=DECODER_LR) through
    make_step: TP_CALLS calls held (losses; masters and moments by
    parameter name, in host memory), then timed; exact launch counts."""
    from apex_tpu_torch import amp, optimizers, parallel
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=DECODER_LR),
                                opt_level="O2", verbosity=0)
    model.train()

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
        opt.step(grads)
        return loss

    train = parallel.make_step(step, model)
    (outs, call_ms), counts = _counted(
        lambda: _timed(lambda: train(ids), TP_CALLS))
    expect = {k: v * TP_CALLS for k, v in TP_PER_STEP.items()}
    _check_counts(tag, {**{k: 0 for k in expect}, **counts}, expect)
    layout = opt.masters.layout
    state = {}
    for what, buf in (("masters", opt.masters.buf), ("m", opt.state.m),
                      ("v", opt.state.v)):
        for name, piece in zip(layout.names, layout.pieces(buf)):
            state[f"{what}:{name}"] = piece.to("cpu", copy=True)
    _, tms = _timed(lambda: train(ids), CAPTURE_TIMED)
    out = {"losses": torch.stack([o.float() for o in outs]).cpu(),
           "state": state, "step_ms": statistics.median(tms),
           "replay_ms": _replay_ms(train), "launches": counts,
           "capture_call_ms": call_ms[1]}
    log(f"[{tag}] {TP_CALLS} calls, losses {out['losses'].tolist()}; "
        f"step_ms median {out['step_ms']:.2f} over {CAPTURE_TIMED} replays, "
        f"one replay {out['replay_ms']:.2f} ms; launches {counts}")
    del train, opt, model
    _mem_floor()
    return out


def _mx_tp(smi):
    """(r): TinyLlama-1.1B's widths, TP_LAYERS deep, under tp_axis (the
    one-rank NCCL group) at 4 x 2048, captured, from the weights of a
    non-TP model of (e)'s widths through llama_params_to_tp; the non-TP
    step runs first as its twin.  Losses and every parameter's master and
    moments bitwise alike (the same cuBLAS calls run: at world 1 the f/g
    collectives are identities)."""
    import torch.distributed as dist
    from apex_tpu_torch import models
    ids = torch.from_numpy(np.random.RandomState(SEED + 111).randint(
        0, DECODER_TOKENS, (TL_BATCH, TL_SEQ))).to(DEVICE)
    _mem_floor()
    dense = _seeded(lambda d: models.Llama(tinyllama(TP_LAYERS), device=d),
                    SEED + 111)
    init = {k: v.to("cpu", copy=True) for k, v in dense.state_dict().items()}
    twin = _tp_run("mp-r-dense", dense, ids)
    del dense
    with torch.device("meta"):
        tp = models.Llama(tinyllama(TP_LAYERS, tp_axis=dist.group.WORLD),
                          device=torch.device("meta"))
    tp = tp.to_empty(device=DEVICE)
    tp.load_state_dict(models.llama_params_to_tp(init), strict=True)
    del init
    got = _tp_run("mp-r-tp", tp, ids)
    assert same(got["losses"], twin["losses"]), (got["losses"],
                                                 twin["losses"])
    for key, t in twin["state"].items():
        what, name = key.split(":", 1)
        tp_name = next(iter(models.llama_params_to_tp({name: None})))
        assert same(got["state"][f"{what}:{tp_name}"], t), f"[mp-r] {key}"
    log(f"[mp-r] tp_axis TinyLlama widths, {TP_LAYERS} layers: losses and "
        f"the masters and moments of "
        f"all {len(twin['state']) // 3} parameters bitwise the non-TP step's "
        f"over "
        f"{TP_CALLS} calls; step_ms {got['step_ms']:.2f} against the non-TP "
        f"{twin['step_ms']:.2f} ({smi})")
    return {"tp_step_ms": got["step_ms"], "dense_step_ms": twin["step_ms"],
            "tp_replay_ms": got["replay_ms"],
            "dense_replay_ms": twin["replay_ms"],
            "losses": got["losses"].tolist(), "launches": got["launches"]}


def _mx_opt_rows(n, tag):
    """Scale, l2norm and Adam (with the bf16 copy) at (q)'s flat length
    ``n``, each against its plain version (scale bitwise with the flag, the
    l2norm within rel 1e-6, Adam bitwise on the first MX_CHUNK elements),
    then timed.  Four fp32 buffers of n are 27 GB, so the plain Adam runs
    over MX_PLAIN_CHUNKS chunks (its temporaries would not fit whole)."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    from apex_tpu_torch.ops import multi_tensor as mt
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 114)
    x = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev) * 1024.0
    m0 = torch.randn(n, generator=gen, device=dev).abs() * 0.1
    v0 = torch.randn(n, generator=gen, device=dev).abs() * 0.01
    err = {}
    s = torch.full((), 1.0 / 65536.0, device=dev)
    out = torch.empty_like(x)
    ok, fk = ops.multi_tensor_scale(x, s, out=out)
    op, fp = mt._scale_plain(x, s, torch.empty_like(x))
    assert same(ok, op) and float(fk) == float(fp) == 0.0, tag
    err["multi_tensor_scale"] = max_abs(ok, op)
    del op
    nk, np_ = ops.multi_tensor_l2norm(x), mt._l2norm_plain(x)
    assert abs(float(nk) - float(np_)) <= 1e-6 * float(np_), (tag, nk, np_)
    err["multi_tensor_l2norm"] = abs(float(nk) - float(np_))
    ss = torch.full((), 1e-3, device=dev)
    inv = torch.full((), 1.0 / 1024.0, device=dev)
    zero = torch.zeros((), device=dev)
    args = (0.9, 0.999, 1e-8, False, 0.0)
    c = MX_CHUNK
    bk = [t[:c].clone() for t in (x, m0, v0)]
    bp = [t[:c].clone() for t in (x, m0, v0)]
    hk = torch.empty(c, dtype=torch.bfloat16, device=dev)
    hp = torch.empty_like(hk)
    ops.fused_adam(*bk, g[:c], ss, inv, *args, half=hk, noop=zero)
    adam_mod._adam_plain(*bp, g[:c], ss, inv, *args, hp, zero)
    for a, b in zip(bk + [hk], bp + [hp]):
        assert same(a, b), f"[{tag}] adam: kernel != plain"
    err["fused_adam"] = max(max_abs(a, b) for a, b in zip(bk, bp))
    del bk, bp, hk, hp
    half = torch.empty(n, dtype=torch.bfloat16, device=dev)
    k_ = -(-n // MX_PLAIN_CHUNKS)

    def plain_adam():
        for i in range(0, n, k_):
            sl = slice(i, i + k_)
            adam_mod._adam_plain(x[sl], m0[sl], v0[sl], g[sl], ss, inv,
                                 *args, half[sl], zero)

    pl = torch.nn.Parameter(x)
    pl.grad = g
    lib_adam = torch.optim.Adam([pl], lr=1e-3, fused=True, capturable=True)
    log(f"[{tag}] scale, l2norm and Adam at n = {n}: agree with the plain "
        f"versions; max abs err {err}")
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
            lambda: ops.fused_adam(x, m0, v0, g, ss, inv, *args, half=half,
                                   noop=zero),
            plain_adam, lib_adam.step)}
    rows = _time_rows(timing, err, f"n = {n} fp32 (bf16 copy), one call a "
                      f"step (the l2norm two)", plain_graph=(2, 5),
                      kernel_graph=(2, 10))
    del timing, lib_adam, pl, x, g, m0, v0, out, half
    _mem_floor()
    return rows


def _mx_kernel_rows(n, counts_q):
    """The kernel rows of (q)'s shapes (the "kernels_mp" line): the three
    flash kernels at FLASH_MX bf16 causal (held against fp64 at one
    sequence, FLASH_MX_HELD, each twice bitwise), timed against the plain
    versions and SDPA; scale, l2norm and Adam at (q)'s flat length.  Each
    row's launches are (q)'s counted run's."""
    errs, rat = _flash_check(FLASH_MX_HELD, torch.bfloat16, "causal",
                             SEED + 113)
    log(f"[mp] flash fwd/dq/dkv at {FLASH_MX_HELD} bf16 causal: within the "
        f"fp64 bounds (worst ratio kernel {rat['kernel']:.3e}, plain "
        f"{rat['plain']:.3e}); max abs err against the plain version "
        f"{errs}; second launches bitwise")
    _mem_floor()
    rows = _time_rows(_decoder_flash_rows(FLASH_MX, 0.0, "mixtral"), errs,
                      f"{FLASH_MX} (B, H, T, D) bf16, causal, one call; "
                      f"{MX_LAYERS} a pass", plain_graph=(2, 5))
    _mem_floor()
    rows.update(_mx_opt_rows(n, "mixtral"))
    out = []
    for key, row in rows.items():
        row["variant"] = key
        row["launches"] = counts_q[row["name"]]
        out.append(row)
    return out


def _mx_serving(smi):
    """(t) then (s) on one model: Mixtral at Mixtral-8x7B's widths,
    MX_SERVE_LAYERS deep, dropless.  (t) in fp32 (TF32 off):
    generate_cached greedy (chunked and step prefill) token for token the
    uncached loop.  (s) the same weights in bf16 served by Engine on (h)'s
    traffic (phase 18), its windows captured (_srv_path: warmup captures
    the census, the first windows bitwise their eager twins, one host read
    a window, exact flash launches)."""
    from apex_tpu_torch import models, serving
    dev = torch.device(DEVICE)
    _mem_floor()
    cfg = mixtral_8x7b(MX_SERVE_LAYERS, capacity_factor=MX_SERVE_CF)
    m32 = _seeded(lambda d: models.Mixtral(cfg, device=d), SEED + 112)
    m32.eval()
    n_params = sum(p.numel() for p in m32.parameters())
    rs = np.random.RandomState(SEED + 112)
    buf = torch.zeros((len(GEN_PROMPTS), GEN_BUF), dtype=torch.int64,
                      device=dev)
    for r, n in enumerate(GEN_PROMPTS):
        buf[r, :n] = torch.from_numpy(rs.randint(0, DECODER_TOKENS, n))
    lens = torch.tensor(GEN_PROMPTS, device=dev)
    ((ref, _),), (ref_ms,) = _timed(lambda: _greedy_uncached(
        m32, buf, lens, GEN_NEW), 1)
    ms = {}
    for mode in ("chunked", "step"):
        ((got, _),), (ms[mode],) = _timed(lambda: m32.generate_cached(
            buf, lens, GEN_NEW, prefill_mode=mode), 1)
        assert torch.equal(got, ref), \
            f"[mp-t] fp32 generate_cached ({mode}) differs from the " \
            f"uncached loop: {_agreement(got, ref, GEN_PROMPTS)}"
    log(f"[mp-t] Mixtral-8x7B widths, {MX_SERVE_LAYERS} layers ({n_params} "
        f"parameters), fp32, dropless: generate_cached (chunked and step "
        f"prefill) gives exactly the uncached loop's "
        f"{len(GEN_PROMPTS) * GEN_NEW} tokens; {ms['chunked']:.1f} / "
        f"{ms['step']:.1f} ms against {ref_ms:.1f} ms uncached")
    t_out = {"parameters": n_params, "fp32_exact": True,
             "cached_ms": ms, "uncached_ms": ref_ms}
    m16 = m32.to(torch.bfloat16)
    del m32
    _mem_floor()
    traffic = _srv_traffic(SEED + 40, SRV_REQUESTS, SRV_PLEN, SRV_NEW,
                           cfg.vocab_size)

    def fixed():
        return serving.Engine(m16, slots=SRV_SLOTS, buf_len=SRV_BUF,
                              window=SRV_WINDOW)

    s_out, _, counts = _srv_path(
        "mp-s", fixed, traffic,
        lambda run: {"flash_fwd": SRV_REQUESTS * MX_SERVE_LAYERS})
    s_out["parameters"] = n_params
    del m16
    _mem_floor()
    return t_out, s_out, counts


def phase_mp(smi):
    """Phase 20: tensor and expert parallelism with Mixtral on a one-rank
    NCCL group: (q) Mixtral training, its kernel rows, (r) Llama under
    tp_axis against its non-TP twin, (t) fp32 cached decoding and (s)
    serving.  At world 1 every collective is skipped, as the JAX layers
    skip theirs at axis size 1: the phase exercises the code paths, not
    the wire."""
    from apex_tpu_torch import parallel
    import torch.distributed as dist
    t0 = time.time()
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    results = {}
    try:
        counts_q, results["q"] = _mx_train(smi)
        log(f"[time] mp (q) in {time.time() - t0:.1f} s")
        rows = _mx_kernel_rows(results["q"]["flat_length"], counts_q)
        log(f"[time] mp kernel rows in {time.time() - t0:.1f} s")
        results["r"] = _mx_tp(smi)
        log(f"[time] mp (r) in {time.time() - t0:.1f} s")
        results["t"], results["s"], _ = _mx_serving(smi)
        log(f"[time] mp (t), (s) in {time.time() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    results["card"] = smi
    results["seconds"] = time.time() - t0
    log("mp " + json.dumps(results, default=str))
    return rows, results


SP_LAYERS = 4                       # (u)'s depth, as (r)'s: the only cut
SP_STEPS = 3                        # (u), (w): eager, captured, twin
SP_EXAMPLE_ARGV = ["--dim", "768", "--heads", "12", "--layers", "12",
                   "--vocab", "50257", "--seq-len", "8192", "-b", "1",
                   "--dp", "1", "--sp", "1", "--print-freq", "1"]
SP_EXAMPLE_ITERS = 3
FLASH_U = (1, 12, 8192, 64)         # (v)'s Ulysses attention, a layer
FLASH_U_REF_ROWS = 2                # its fp64 check, 2 heads at a time:
                                    # 1.1 GB a T x T tensor
SP_TWIN_RTOL = 1e-4                 # (u)'s losses, ring vs flash: 4.9e-6
                                    # measured on an H100 (PERF.md)
SP_FIRST_RTOL = 1e-4                # (v)'s first losses: 4.8e-6 measured
PP_MICRO, PP_MB = 8, (2, 1024, 768)  # (w): M microbatches of GPT-2 rows
PP_BLOCKS = 12                      # GPT-2 small's blocks, one stage
PP_GRAD_RTOL = 2e-2                 # (w): 1F1B's grads vs the fallback's,
                                    # of the largest: 7.9e-3 measured
# a step of (u): the unscale, AmpOptimizer.step's grad norm, Adam (the
# ring path runs no flash kernel; RMSNorm is torch ops)
SP_PER_STEP = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
               "fused_adam": 1}


def _sp_state(opt):
    """The masters and moments by parameter name, in host memory."""
    layout = opt.masters.layout
    out = {}
    for what, buf in (("masters", opt.masters.buf), ("m", opt.state.m),
                      ("v", opt.state.v)):
        for name, piece in zip(layout.names, layout.pieces(buf)):
            out[f"{what}:{name}"] = piece.to("cpu", copy=True)
    return out


def _sp_held(tag, a, b):
    for k, t in a.items():
        assert same(t, b[k]), f"[{tag}] {k} differs"
    return sum(t.numel() for t in a.values())


def _sp_llama(smi):
    """(u): TinyLlama-1.1B's widths, SP_LAYERS deep, under sp_axis (the
    one-rank NCCL group: ring attention at n = 1) under O2 + FusedAdam at
    4 x 2048: from one state, SP_STEPS eager steps, the captured step's
    SP_STEPS calls (losses, masters and moments bitwise), then the non-SP
    twin (the same model, its sp_axis cleared: the flash path) whose
    losses agree within SP_TWIN_RTOL; step_ms, tok/s, peak memory."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    floor = _mem_floor()
    model = _seeded(lambda d: models.Llama(
        tinyllama(SP_LAYERS, sp_axis=dist.group.WORLD), device=d),
        SEED + 121)
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=DECODER_LR),
                                opt_level="O2", verbosity=0)
    model.train()
    ids = torch.from_numpy(np.random.RandomState(SEED + 121).randint(
        0, DECODER_TOKENS, (TL_BATCH, TL_SEQ))).to(DEVICE)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
        opt.step(grads)
        return loss

    s0 = _snapshot(model, opt, (), host=True)
    state_bytes = torch.cuda.memory_allocated() - floor
    eager_floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed(lambda: step(ids), SP_STEPS)
    eager = torch.stack([o.float() for o in outs])
    eager_peak = torch.cuda.max_memory_allocated() - eager_floor
    vals = eager.tolist()
    assert all(math.isfinite(v) for v in vals), vals
    d_eager = _sp_state(opt)
    _restore(model, opt, (), s0)
    floor_g = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    train = parallel.make_step(step, model)
    (outs, call_ms), counts = _counted(
        lambda: _timed(lambda: train(ids), SP_STEPS))
    assert same(torch.stack([o.float() for o in outs]), eager), \
        f"[sp-u] captured losses {[float(o) for o in outs]} against {vals}"
    n_held = _sp_held("sp-u captured", d_eager, _sp_state(opt))
    assert train.replays == SP_STEPS - 1, train.replays
    expect = {k: v * SP_STEPS for k, v in SP_PER_STEP.items()}
    _check_counts("sp-u", {**{k: 0 for k in expect}, **counts}, expect)
    _, tms = _timed(lambda: train(ids), CAPTURE_TIMED)
    peak = torch.cuda.max_memory_allocated() - floor_g
    step_ms = statistics.median(tms)
    replay = _replay_ms(train)
    del train
    # the non-SP twin: the same model and state on the flash path
    _restore(model, opt, (), s0)
    model.cfg.sp_axis = None
    twin, counts_twin = _counted(
        lambda: torch.stack([step(ids).float() for _ in range(SP_STEPS)]))
    assert counts_twin.get("flash_fwd") == SP_LAYERS * SP_STEPS, counts_twin
    rel = float(((twin - eager).abs() / twin.abs()).max())
    assert rel <= SP_TWIN_RTOL, (twin.tolist(), vals)
    tok_s = TL_BATCH * TL_SEQ / step_ms * 1e3
    log(f"[sp-u] Llama at TinyLlama-1.1B's widths, {SP_LAYERS} layers, "
        f"sp_axis the one-rank NCCL group (ring attention at n = 1), O2 + "
        f"FusedAdam, {TL_BATCH} x {TL_SEQ} tokens ({smi}): {SP_STEPS} "
        f"captured calls, losses and {n_held} masters and moments bitwise "
        f"the eager steps'; losses {['%.5f' % v for v in vals]}; the "
        f"non-SP twin (flash) {['%.5f' % v for v in twin.tolist()]}, "
        f"max rel diff {rel:.3e} (bound {SP_TWIN_RTOL}); step_ms median "
        f"{step_ms:.2f} over {CAPTURE_TIMED} replays (eager "
        f"{statistics.median(ms[1:]):.2f}), one replay {replay:.2f} ms, "
        f"{tok_s:.1f} tok/s; state {state_bytes} B, peak above it eager "
        f"{eager_peak} B ({eager_peak / 2**30:.2f} GiB), captured {peak} B "
        f"({peak / 2**30:.2f} GiB); launches {counts}")
    out = {"losses": vals, "twin_losses": twin.tolist(), "twin_rel": rel,
           "step_ms": step_ms, "eager_step_ms": statistics.median(ms[1:]),
           "replay_ms": replay, "tokens_per_s": tok_s,
           "peak_bytes": peak, "eager_peak_bytes": eager_peak,
           "state_bytes": state_bytes, "launches": counts,
           "capture_call_ms": call_ms[1]}
    del model, opt, s0
    _mem_floor()
    return out


def _sp_example(smi):
    """(v): examples/long_context/train_sp_torch.py at GPT-2 small's
    widths, T = 8192, dp 1 x sp 1, with --strategy ulysses (the flash
    kernels) and ring, each in process with its launch counts; both losses
    finite and falling, the first steps' within SP_FIRST_RTOL."""
    example = _load("examples", "long_context", "train_sp_torch.py")
    steps = EXAMPLE_WARMUP + SP_EXAMPLE_ITERS
    out, counts = {}, {}
    for strategy in ("ulysses", "ring"):
        _mem_floor()
        floor = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res, counts[strategy] = _counted(lambda: example.main(
            SP_EXAMPLE_ARGV + ["--iters", str(SP_EXAMPLE_ITERS),
                               "--strategy", strategy, "--device", DEVICE]))
        peak = torch.cuda.max_memory_allocated() - floor
        losses = res["losses"]
        assert all(math.isfinite(v) for v in losses), losses
        assert losses[-1] < losses[0], (strategy, losses)
        layers = int(SP_EXAMPLE_ARGV[SP_EXAMPLE_ARGV.index("--layers") + 1])
        flash = layers * steps if strategy == "ulysses" else 0
        expect = dict({k: steps for k in SP_PER_STEP},
                      flash_fwd=flash, flash_dq=flash, flash_dkv=flash)
        _check_counts(f"sp-v-{strategy}", counts[strategy], expect)
        out[strategy] = {"losses": losses, "tokens_per_s": res["tok_s"],
                         "peak_bytes": peak, "seconds": time.time() - t0}
        log(f"[sp-v] {strategy}: losses {['%.5f' % v for v in losses]}, "
            f"{res['tok_s']:.1f} tok/s, peak {peak / 2**30:.2f} GiB, "
            f"{out[strategy]['seconds']:.1f} s ({smi})")
    first = [out[s]["losses"][0] for s in ("ulysses", "ring")]
    rel = abs(first[0] - first[1]) / abs(first[1])
    assert rel <= SP_FIRST_RTOL, first
    out["first_step_rel"] = rel
    log(f"[sp-v] first-step losses ulysses {first[0]:.6f}, ring "
        f"{first[1]:.6f}: rel diff {rel:.3e} (bound {SP_FIRST_RTOL})")
    return out, counts["ulysses"]


def _sp_kernel_rows(counts_v):
    """Rows 11 U - 13 U: the flash kernels at (v)'s Ulysses shape
    FLASH_U, bf16 causal: they and their plain versions within the fp64
    bounds (the reference FLASH_U_REF_ROWS heads at a time), each kernel
    twice bitwise, timed against the plain versions and SDPA; launches
    from (v)'s Ulysses run."""
    errs, rat = _flash_check(FLASH_U, torch.bfloat16, "causal", SEED + 122,
                             ref_rows=FLASH_U_REF_ROWS)
    log(f"[sp] flash fwd/dq/dkv at {FLASH_U} bf16 causal within the fp64 "
        f"bounds (worst ratio kernel {rat['kernel']:.3e}, plain "
        f"{rat['plain']:.3e}); max abs err against the plain version "
        f"{errs}")
    _mem_floor()
    rows = _time_rows(_decoder_flash_rows(FLASH_U, 0.0, "sp"), errs,
                      f"{FLASH_U} (B, H, T, D) bf16, causal, one call; 12 "
                      f"a step of (v)'s Ulysses run", plain_graph=(2, 5))
    out = []
    for key, row in rows.items():
        row["variant"] = key
        row["launches"] = counts_v[row["name"]]
        out.append(row)
    _mem_floor()
    return out


def _pp_stage(cfg, group):
    """GPT-2 small's PP_BLOCKS blocks as one pipeline stage on ``group``,
    drawn from a CPU generator seeded SEED + 123."""
    from apex_tpu_torch.models.gpt import GPTBlock
    from apex_tpu_torch.parallel import pipeline as pp
    gen = torch.Generator().manual_seed(SEED + 123)
    dgen = torch.Generator(device=DEVICE).manual_seed(0)
    return pp.init_stacked(lambda: torch.nn.Sequential(*[
        GPTBlock(cfg, device=DEVICE, generator=gen, dropout_generator=dgen)
        for _ in range(PP_BLOCKS)]), 1, group)


def _pp_1f1b(smi):
    """(w): GPT-2 small's 12 blocks as the stage of a one-stage pipeline
    (the one-rank NCCL group), dropout 0, M = PP_MICRO microbatches of
    PP_MB hidden states, an MSE loss, O2 + FusedAdam through the 1F1B
    schedule: SP_STEPS captured calls bitwise the eager steps; loss and
    grads against the sequential fallback (axis None); GPipe's forward
    bitwise the sequential forward; the peak memory of 1F1B against
    autograd through pipeline_apply at the same M."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    from apex_tpu_torch.parallel import pipeline as pp
    group = dist.group.WORLD
    _mem_floor()
    cfg = models.gpt2_small()
    cfg.dropout = 0.0
    stage, opt = amp.initialize(_pp_stage(cfg, group),
                                optimizers.FusedAdam(lr=DECODER_LR),
                                opt_level="O2", verbosity=0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 123)
    x = torch.randn((PP_MICRO,) + PP_MB, generator=gen, device=DEVICE)
    tgt = torch.randn((PP_MICRO,) + PP_MB, generator=gen, device=DEVICE)

    def mse(y, t):
        return ((y.float() - t) ** 2).mean()

    def step(batch):
        xb, tb = batch
        scale = opt.scalers[0].loss_scale
        loss, grads = pp.pipeline_1f1b_grads(
            stage, lambda y, t: mse(y, t) * scale, xb, tb, group)
        opt.step(grads)
        return loss / scale

    s0 = _snapshot(stage, opt, ())
    # 1F1B against the sequential fallback from the first state
    with torch.no_grad():
        y_pipe = pp.pipeline_apply(stage, x, group)
        y_seq = pp.pipeline_apply(stage, x, None)
    assert same(y_pipe, y_seq), "[pp-w] GPipe's forward is not bitwise"
    del y_pipe, y_seq
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    l_1f1b, g_1f1b = pp.pipeline_1f1b_grads(stage, mse, x, tgt, group)
    peak_1f1b = torch.cuda.max_memory_allocated() - floor
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    l_seq, g_seq = pp.pipeline_1f1b_grads(stage, mse, x, tgt, None)
    peak_seq = torch.cuda.max_memory_allocated() - floor
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    params = [p for p in stage.parameters()]
    y = pp.pipeline_apply(stage, x, group)
    g_gpipe = torch.autograd.grad(
        torch.stack([mse(y[m], tgt[m]) for m in range(PP_MICRO)]).mean(),
        params)
    peak_gpipe = torch.cuda.max_memory_allocated() - floor
    del y, g_gpipe
    loss_rel = abs(float(l_1f1b) - float(l_seq)) / abs(float(l_seq))
    gmax = max(float(g.float().abs().max()) for g in g_seq.values())
    gerr = max(max_abs(g_1f1b[n], g_seq[n]) for n in g_seq)
    assert loss_rel <= 1e-6 and gerr <= PP_GRAD_RTOL * gmax, \
        (loss_rel, gerr, gmax)
    del g_1f1b, g_seq
    log(f"[pp-w] {PP_BLOCKS} GPT-2 small blocks as one stage, M = "
        f"{PP_MICRO} microbatches of {PP_MB}, O2 ({smi}): GPipe's forward "
        f"bitwise the sequential one; 1F1B's loss {float(l_1f1b):.6f} "
        f"against the sequential fallback's {float(l_seq):.6f} (rel "
        f"{loss_rel:.3e}), its grads within {gerr:.3e} of the fallback's "
        f"(largest grad {gmax:.3e}, bound {PP_GRAD_RTOL} of it); peak "
        f"memory of one pass: 1F1B {peak_1f1b} B ({peak_1f1b / 2**30:.2f} "
        f"GiB), autograd through pipeline_apply {peak_gpipe} B "
        f"({peak_gpipe / 2**30:.2f} GiB), the sequential fallback "
        f"{peak_seq} B ({peak_seq / 2**30:.2f} GiB)")
    _restore(stage, opt, (), s0)
    outs, ms = _timed(lambda: step((x, tgt)), SP_STEPS)
    eager = torch.stack([o.float() for o in outs])
    d_eager = _snapshot(stage, opt, ())
    _restore(stage, opt, (), s0)
    floor_g = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    train = parallel.make_step(step, stage)
    (outs, call_ms), counts = _counted(
        lambda: _timed(lambda: train((x, tgt)), SP_STEPS))
    assert same(torch.stack([o.float() for o in outs]), eager), \
        f"[pp-w] captured losses {[float(o) for o in outs]}"
    n_held = _held("pp-w captured", d_eager, _snapshot(stage, opt, ()))
    # each of the M microbatches through PP_BLOCKS blocks (two LayerNorms
    # and one attention a block), then the optimizer's kernels
    n = PP_BLOCKS * PP_MICRO
    per_step = dict(SP_PER_STEP, layer_norm_fwd=2 * n, layer_norm_bwd=2 * n,
                    flash_fwd=n, flash_dq=n, flash_dkv=n)
    expect = {k: v * SP_STEPS for k, v in per_step.items()}
    _check_counts("pp-w", {**{k: 0 for k in expect}, **counts}, expect)
    _, tms = _timed(lambda: train((x, tgt)), CAPTURE_TIMED)
    peak = torch.cuda.max_memory_allocated() - floor_g
    step_ms = statistics.median(tms)
    replay = _replay_ms(train)
    del train
    tok_s = PP_MICRO * PP_MB[0] * PP_MB[1] / step_ms * 1e3
    log(f"[pp-w] 1F1B step under O2 + FusedAdam through make_step: "
        f"{SP_STEPS} captured calls, losses and {n_held} state tensors "
        f"bitwise the eager steps'; losses "
        f"{['%.6f' % v for v in eager.tolist()]}; step_ms median "
        f"{step_ms:.2f} over {CAPTURE_TIMED} replays (eager "
        f"{statistics.median(ms[1:]):.2f}), one replay {replay:.2f} ms, "
        f"{tok_s:.1f} tok/s, peak {peak / 2**30:.2f} GiB; launches {counts}")
    out = {"losses": eager.tolist(), "step_ms": step_ms,
           "eager_step_ms": statistics.median(ms[1:]), "replay_ms": replay,
           "tokens_per_s": tok_s, "peak_bytes": peak,
           "peak_1f1b_bytes": peak_1f1b, "peak_gpipe_bytes": peak_gpipe,
           "peak_sequential_bytes": peak_seq, "loss_rel": loss_rel,
           "grad_err": gerr, "grad_max": gmax, "launches": counts,
           "capture_call_ms": call_ms[1]}
    del stage, opt, s0, d_eager
    _mem_floor()
    return out


def phase_sp_pp(smi):
    """Phase 21: sequence and pipeline parallelism on a one-rank NCCL
    group: (u) Llama under sp_axis, (v) the long-context example and its
    kernel rows (the "kernels_sp" line), (w) 1F1B over GPT-2 blocks.  At
    world 1 the ring rotates nothing, the all-to-alls and the pipeline's
    exchanges are skipped: the phase exercises the code paths, not the
    wire."""
    from apex_tpu_torch import parallel
    import torch.distributed as dist
    t0 = time.time()
    parallel.init_process_group(
        init_method=parallel.multiproc.local_init_method(), world_size=1,
        rank=0)
    results = {}
    try:
        results["u"] = _sp_llama(smi)
        log(f"[time] sp (u) in {time.time() - t0:.1f} s")
        results["v"], counts_v = _sp_example(smi)
        log(f"[time] sp (v) in {time.time() - t0:.1f} s")
        rows = _sp_kernel_rows(counts_v)
        log(f"[time] sp kernel rows in {time.time() - t0:.1f} s")
        results["w"] = _pp_1f1b(smi)
        log(f"[time] sp (w) in {time.time() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    results["card"] = smi
    results["seconds"] = time.time() - t0
    log("sp " + json.dumps(results, default=str))
    return rows, results


# -- phase 22, the legacy surface and the sharded checkpoint --------------------

DCGAN_ITERS = 200                   # the reference example's default
DCGAN_O2_ITERS = 20
DCGAN_TWIN = ["--opt-level", "O0", "--ngf", "16", "--ndf", "16", "-b", "8"]
DCGAN_TWIN_STEPS = 5
# (x)'s fp32 twin, card against CPU: Adam's first steps move a weight by
# about lr = 2e-4 in the sign of its grad, which a grad near zero need not
# share across cuDNN's and oneDNN's summation orders, so a weight may part
# by 2 lr a step, 2e-3 over the 5 steps; the losses and the BatchNorm
# running statistics (averages of normalized activations of order 1) are
# held within 2.5 times that
DCGAN_TWIN_TOL = 5e-3
# an iteration: G forward for the fake (4 BatchNorms, no update, no
# backward), D on real and on fake (3 + 3), G again and D on it (4 + 3);
# backward through D twice (6), then through D and G (3 + 4); each
# optimizer steps once (scale, the l2norm of AmpOptimizer's grad norm,
# Adam)
DCGAN_PER_ITER = {"multi_tensor_scale": 2, "multi_tensor_l2norm": 2,
                  "fused_adam": 2, "syncbn_fwd": 17, "syncbn_bwd": 13}
MLSTM_WIDTH, MLSTM_HIDDEN = 64, 4096        # Radford et al. 2017
MLSTM_BATCH, MLSTM_SEQ = 128, 256
MLSTM_STEPS = 6
# below the grad norm (about 0.007 at the start on random bytes, my chip
# run 1, PR 18): the clip acts
MLSTM_CLIP = 0.005
MLSTM_LR = 5e-4
# a step: the unscale (scale), clip_master_grads (l2norm), Adam with the
# half copy
MLSTM_PER_STEP = {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
                  "fused_adam": 1}
RNN_TWIN = (16, 8, 32, 64)                  # T, B, F, H
RNN_TWIN_TOL = dict(rtol=1e-4, atol=1e-5)
ZERO_RESUME_ARGV = ["--arch", "resnet18", "-b", str(BATCH), "--image-size",
                    str(IMAGE), "--iters", "3", "--print-freq", "1",
                    "--fused-adam", "--zero"]


def _dcgan_example():
    return _load("examples", "dcgan", "main_amp_torch.py")


@contextlib.contextmanager
def _deterministic():
    """cuDNN on its deterministic algorithms, no autotuning: two runs of
    one step held bitwise."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _dcgan_run(ex, tag, argv, iters):
    """examples/dcgan/main_amp_torch.main in process on the card, the
    launch counts set to 0 just before and read just after, held to
    DCGAN_PER_ITER; returns the run and its numbers."""
    from apex_tpu_torch import amp
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--device", DEVICE, "--iters", str(iters),
            "--print-freq", "50"] + argv
    log(f"[legacy-x] {tag}: dcgan main_amp_torch.main({argv})")
    run, counts = _counted(lambda: ex.main(argv))
    peak = torch.cuda.max_memory_allocated() - floor
    losses = run["losses"]
    assert losses.shape == (iters, 2) and bool(torch.isfinite(losses).all())
    expect = {k: v * iters for k, v in DCGAN_PER_ITER.items()}
    _check_counts(f"legacy-x-{tag}", {**dict.fromkeys(expect, 0), **counts},
                  expect)
    log(f"[legacy-x] {tag}: {iters} iterations, {run['ms_per_it']:.2f} "
        f"ms/it ({run['ms_per_it_after_first']:.2f} after the first, which "
        f"autotunes cuDNN), peak {peak} B ({peak / 2**30:.3f} GiB) above the floor; "
        f"first losses D/G {losses[0].tolist()}, last {losses[-1].tolist()}")
    # where the time goes: three more iterations under the profiler, in
    # the run's precision (O1: its cast policy again)
    args = ex.parse_args(argv[2:])
    rng = np.random.RandomState(SEED + 5)
    if args.opt_level == "O1":
        amp.set_policy(amp.CastPolicy(torch.bfloat16))
    try:
        by_cat = phase_profile(
            lambda: ex.train_step(run["netD"], run["netG"], run["optD"],
                                  run["optG"],
                                  *ex.batch(rng, args, torch.device(DEVICE))),
            run["ms_per_it_after_first"], f"legacy-x-{tag}-profile")
    finally:
        amp.set_policy(amp.NoPolicy())
    return run, counts, {"ms_per_it": run["ms_per_it"],
                         "ms_per_it_after_first":
                             run["ms_per_it_after_first"],
                         "device_ms_by_category": by_cat,
                         "peak_bytes": peak,
                         "first": losses[0].tolist(),
                         "last": losses[-1].tolist()}


def _dcgan_twin(ex):
    """The fp32 twin: DCGAN_TWIN_STEPS iterations of the example's step on
    the card (kernels) and on the CPU (plain versions) from the same
    weights and data."""
    args = ex.parse_args(DCGAN_TWIN)
    out = []
    for dev in (torch.device(DEVICE), torch.device("cpu")):
        netD, netG, optD, optG = ex.build(args, dev)
        rng = np.random.RandomState(args.seed)
        (losses, counts) = _counted(lambda: torch.stack([torch.stack(
            ex.train_step(netD, netG, optD, optG, *ex.batch(rng, args, dev)))
            for _ in range(DCGAN_TWIN_STEPS)]).cpu())
        out.append((losses, {n: b.cpu() for m in (netD, netG)
                             for n, b in m.named_buffers(prefix=type(m)
                                                         .__name__)},
                    counts))
    (lk, bk, ck), (lp, bp, cp) = out
    expect = {k: v * DCGAN_TWIN_STEPS for k, v in DCGAN_PER_ITER.items()}
    _check_counts("legacy-x-twin", {**dict.fromkeys(expect, 0), **ck},
                  expect)
    assert not cp, cp
    loss_rel = float(((lk - lp).abs() / lp.abs()).max())
    bn_err = max(float((bk[n].float() - bp[n].float()).abs().max())
                 for n in bk if not n.endswith("num_batches_tracked"))
    assert all(int(bk[n]) == int(bp[n]) for n in bk
               if n.endswith("num_batches_tracked"))
    assert loss_rel <= DCGAN_TWIN_TOL and bn_err <= DCGAN_TWIN_TOL, \
        (loss_rel, bn_err)
    log(f"[legacy-x] fp32 twin {DCGAN_TWIN}, {DCGAN_TWIN_STEPS} iterations: "
        f"card against CPU, losses within rel {loss_rel:.3e}, BatchNorm "
        f"running statistics within {bn_err:.3e} (bound {DCGAN_TWIN_TOL}), "
        f"their counts equal")
    return {"loss_rel": loss_rel, "bn_err": bn_err}, ck


class _ByteMLSTM(torch.nn.Module):
    """The byte model of Radford et al. 2017: a 256 -> 64 byte embedding,
    one mLSTM layer of 4096 units, a 4096 -> 256 decoder."""

    def __init__(self, device, seed=SEED):
        super().__init__()
        from apex_tpu_torch import RNN, nn
        g = torch.Generator().manual_seed(seed)
        self.embed = nn.Embedding(256, MLSTM_WIDTH, init_std=0.1,
                                  device=device, generator=g)
        self.rnn = RNN.mLSTM(MLSTM_WIDTH, MLSTM_HIDDEN, device=device,
                             generator=g)
        self.head = nn.Linear(MLSTM_HIDDEN, 256, device=device, generator=g)

    def forward(self, ids):
        out, _ = self.rnn(self.embed(ids))
        return self.head(out)


def _byte_loss(model, ids):
    """Next-byte cross entropy over (T + 1, B) ids."""
    from apex_tpu_torch.nn import functional as F
    logits = model(ids[:-1]).float()
    return F.cross_entropy(logits.reshape(-1, 256), ids[1:].reshape(-1))


def _mlstm_state(opt):
    st = opt._inner_state
    return [opt.masters.clone(), opt._half.clone(), st.m.clone(),
            st.v.clone(), st.step.clone()]


def _mlstm_put(opt, snap):
    st = opt._inner_state
    for t, s in zip([opt.masters, opt._half, st.m, st.v, st.step], snap):
        t.copy_(s)


class _PlainOps:
    """The optimizer kernels' plain versions in place of the wrappers, on
    the card, while the block runs."""

    def __enter__(self):
        from apex_tpu_torch import ops
        from apex_tpu_torch.ops import adam as adam_mod
        from apex_tpu_torch.ops import multi_tensor as mt
        self.ops = ops
        self.saved = {k: getattr(ops, k) for k in
                      ("multi_tensor_scale", "multi_tensor_l2norm",
                       "fused_adam")}
        ops.multi_tensor_scale = lambda x, s, out=None: mt._scale_plain(
            x, mt.as_scalar(s, x), torch.empty_like(x) if out is None
            else out)
        ops.multi_tensor_l2norm = mt._l2norm_plain
        ops.fused_adam = (lambda *a, half=None, noop=None:
                          adam_mod._adam_plain(*a, half, noop))

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(self.ops, k, f)


def _mlstm(smi):
    """(y): the mLSTM at Radford et al.'s width, half by network_to_half,
    under the legacy FP16_Optimizer(FusedAdam(lr 5e-4), dynamic scale),
    random bytes from seed 0 at 128 x 256: MLSTM_STEPS steps with
    clip_master_grads, counted; one update through the kernels against
    the same update through their plain versions from one state; an inf
    skipped; state_dict into a fresh optimizer and the next step bitwise.
    Returns the numbers, the counts and the flat length."""
    from apex_tpu_torch import fp16_utils, optimizers
    dev = torch.device(DEVICE)
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()

    def make(seed=SEED):
        model = fp16_utils.network_to_half(_ByteMLSTM(dev, seed))
        opt = fp16_utils.FP16_Optimizer(
            optimizers.FusedAdam(lr=MLSTM_LR), dynamic_loss_scale=True,
            verbose=False)
        opt.setup(model)
        return model, opt

    model, opt = make()
    n = opt.masters.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [torch.randint(0, 256, (MLSTM_SEQ + 1, MLSTM_BATCH),
                             generator=gen, device=dev)
               for _ in range(MLSTM_STEPS + 2)]

    def step(ids):
        loss = _byte_loss(model, ids)
        opt.backward(loss)
        norm = opt.clip_master_grads(MLSTM_CLIP)
        opt.step()
        return loss.detach(), norm

    def run():
        out = []
        for ids in batches[:MLSTM_STEPS]:
            out.append(torch.stack(step(ids)))
        return torch.stack(out)

    t0 = time.perf_counter()
    res, counts = _counted(run)
    ms = (time.perf_counter() - t0) * 1e3 / MLSTM_STEPS
    expect = {k: v * MLSTM_STEPS for k, v in MLSTM_PER_STEP.items()}
    _check_counts("legacy-y", {**dict.fromkeys(expect, 0), **counts},
                  expect)
    losses, norms = res[:, 0].tolist(), res[:, 1].tolist()
    assert all(math.isfinite(v) for v in losses + norms), res
    assert abs(losses[0] - math.log(256)) < 0.05, losses[0]
    peak = torch.cuda.max_memory_allocated() - floor
    tok_s = MLSTM_BATCH * MLSTM_SEQ / ms * 1e3
    by_cat = phase_profile(lambda: step(batches[0]), ms, "legacy-y-profile",
                           steps=1)
    log(f"[legacy-y] mLSTM {MLSTM_WIDTH} -> {MLSTM_HIDDEN} fp16 ({n} "
        f"parameters) under the legacy FP16_Optimizer(FusedAdam) at "
        f"{MLSTM_BATCH} x {MLSTM_SEQ} bytes ({smi}): losses {losses} "
        f"(ln 256 = {math.log(256):.4f}), grad norms before the clip "
        f"{norms}; {ms:.1f} ms a step ({tok_s:.0f} bytes/s), peak {peak} B "
        f"({peak / 2**30:.2f} GiB); launches {counts}")
    # one update through the kernels and through the plain versions
    ids = batches[MLSTM_STEPS]
    opt.backward(_byte_loss(model, ids))
    snap, grads = _mlstm_state(opt), opt._master_grads.clone()
    scaler = opt._scaler_state
    nk = opt.clip_master_grads(MLSTM_CLIP)
    opt.step()
    after_k = _mlstm_state(opt)
    _mlstm_put(opt, snap)
    opt._master_grads, opt._scaler_state = grads, scaler
    with _PlainOps():
        np_ = opt.clip_master_grads(MLSTM_CLIP)
        opt.step()
    after_p = _mlstm_state(opt)
    norm_rel = abs(float(nk) - float(np_)) / float(np_)
    assert norm_rel <= 1e-6, (float(nk), float(np_))
    assert float(np_) > MLSTM_CLIP, "the clip did not act"
    # the l2norm sums its fp32 squares in another order than torch.sum:
    # within rel 1e-6 (asserted), which moves the clip coefficient by as
    # much; Adam's update m / (sqrt(v) + eps) is invariant to a common
    # scale of the grads but for eps, so the masters part by at most that
    # relative amount of lr, plus one rounding of the new master
    bound = MLSTM_LR * 1e-5 + 2.0 ** -23 * float(after_p[0].abs().max())
    err = float((after_k[0] - after_p[0]).abs().max())
    assert err <= bound, (err, bound)
    assert same(after_k[4], after_p[4])
    log(f"[legacy-y] one update from one state, kernels against plain "
        f"versions: grad norm rel {norm_rel:.3e}, masters within {err:.3e} "
        f"(bound {bound:.3e}), m within "
        f"{max_abs(after_k[2], after_p[2]):.3e}")
    _mlstm_put(opt, after_k)
    # an inf: the step is skipped, the scale halves
    snap, scale = _mlstm_state(opt), opt.loss_scale
    opt.backward(_byte_loss(model, ids) * float("inf"))
    assert opt.overflow
    opt.step()
    assert all(same(a, b) for a, b in zip(snap, _mlstm_state(opt)))
    assert opt.loss_scale == scale / 2, (opt.loss_scale, scale)
    # the checkpoint into a fresh optimizer, then the next step on both
    model2, opt2 = make(SEED + 1)
    opt2.load_state_dict(opt.state_dict())
    assert all(same(a, b) for a, b in zip(_mlstm_state(opt),
                                          _mlstm_state(opt2)))
    assert all(same(a, b) for a, b in zip(model.parameters(),
                                          model2.parameters()))
    for m, o in ((model, opt), (model2, opt2)):
        o.backward(_byte_loss(m, batches[-1]))
        o.clip_master_grads(MLSTM_CLIP)
        o.step()
    assert all(same(a, b) for a, b in zip(_mlstm_state(opt),
                                          _mlstm_state(opt2)))
    log(f"[legacy-y] an inf skipped the step (masters, half copy, m, v, "
        f"step bitwise; scale {scale} -> {opt.loss_scale}); state_dict into "
        f"a fresh optimizer and its next step bitwise")
    del model, opt, model2, opt2, batches
    _mem_floor()
    return ({"losses": losses, "grad_norms": norms, "step_ms": ms,
             "device_ms_by_category": by_cat,
             "bytes_per_s": tok_s, "peak_bytes": peak, "n": n,
             "norm_rel": norm_rel, "master_err": err, "master_bound": bound},
            counts, n)


def _rnn_twins():
    """LSTM, GRU, ReLU, Tanh and a 2-layer bidirectional LSTM at RNN_TWIN
    in fp32: output, final state and grads on the card against the CPU
    from the same weights, within RNN_TWIN_TOL (the GEMMs sum in other
    orders; TF32 is off)."""
    from apex_tpu_torch import RNN
    T, B, F, H = RNN_TWIN
    x = torch.randn(T, B, F, generator=torch.Generator().manual_seed(SEED))
    worst = {}
    for name, kw in (("LSTM", {}), ("GRU", {}), ("ReLU", {}), ("Tanh", {}),
                     ("LSTM", dict(num_layers=2, bidirectional=True))):
        res = []
        for dev in (torch.device(DEVICE), torch.device("cpu")):
            m = getattr(RNN, name)(F, H, device=dev, generator=torch
                                   .Generator().manual_seed(SEED), **kw)
            xi = x.to(dev, copy=True).requires_grad_()
            out, h = m(xi)
            leaves = [out] + [t for part in h for t in
                              (part if isinstance(part, (list, tuple))
                               else [part])]
            leaves = [t for l in leaves for t in
                      (l if isinstance(l, (list, tuple)) else [l])]
            sum((t.float() ** 2).sum() for t in leaves).backward()
            res.append([t.detach().cpu() for t in leaves]
                       + [xi.grad.cpu()]
                       + [p.grad.cpu() for p in m.parameters()])
        tag = name + ("-bi2" if kw else "")
        worst[tag] = 0.0
        for a, b in zip(*res):
            torch.testing.assert_close(a, b, **RNN_TWIN_TOL)
            worst[tag] = max(worst[tag], max_abs(a, b))
    log(f"[legacy-y] RNN twins at (T, B, F, H) = {RNN_TWIN} fp32, card "
        f"against CPU: outputs, states and grads within {RNN_TWIN_TOL}; "
        f"max abs err {worst}")
    return worst


def _legacy_handle():
    """amp.init() with wrap_optimizer(num_loss=2): two steps of two losses
    on the card; amp.init(enabled=False) passes through.  Leaves
    NoPolicy."""
    import warnings
    from apex_tpu_torch import amp, nn, optimizers
    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(SEED)
    model = torch.nn.Sequential(nn.Linear(64, 64, device=dev, generator=g),
                                nn.ReLU(),
                                nn.Linear(64, 8, device=dev, generator=g))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", half_dtype="float16",
                                loss_scale="dynamic", verbosity=0)
    handle = amp.init(enabled=True, half_dtype=torch.float16)
    try:
        assert isinstance(amp.current_policy(), amp.CastPolicy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            w = handle.wrap_optimizer(opt, num_loss=2)
        x = torch.randn(16, 64, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        before = model[0].weight.detach().clone()
        for _ in range(2):
            for k in (1.0, 0.5):
                with handle.scale_loss(model(x).float().pow(2).mean() * k,
                                       w) as scaled:
                    scaled.backward()
            w.step()
        moved = max_abs(model[0].weight, before)
        stats = amp.amp_stats(opt)
        assert moved > 0 and stats["num_losses"] == 2, stats
        noop = amp.init(enabled=False)
        loss = torch.ones((), device=dev)
        with noop.scale_loss(loss, w) as out:
            assert out is loss
    finally:
        handle._deactivate()
    assert isinstance(amp.current_policy(), amp.NoPolicy)
    log(f"[legacy] amp.init() handle, OptimWrapper(num_loss=2): two steps "
        f"of two losses, weights moved {moved:.3e}, scales "
        f"{[d['loss_scale'] for d in stats['per_loss']]}; the no-op handle "
        f"passed through; NoPolicy restored")
    return {"moved": moved, "scales": [d["loss_scale"]
                                       for d in stats["per_loss"]]}


def _shims():
    """multi_tensor_applier(multi_tensor_scale, ...) launches the scale
    kernel once; _native.flatten/unflatten round-trip bitwise."""
    from apex_tpu_torch import _native
    from apex_tpu_torch import multi_tensor_apply as mta
    dev = torch.device(DEVICE)
    xs = [torch.randn(n, device=dev) for n in (5, 1000, 3)]
    (out, found), counts = _counted(
        lambda: mta.multi_tensor_applier(mta.multi_tensor_scale, [xs], 0.5))
    assert counts == {"multi_tensor_scale": 1}, counts
    assert all(same(o, x * 0.5) for o, x in zip(out, xs))
    assert float(found) == 0.0
    arrays = [np.random.RandomState(i).randn(*s).astype(np.float32)
              for i, s in enumerate(((3, 5), (7,), (0,), (2, 2, 2)))]
    flat = _native.flatten(arrays)
    back = _native.unflatten(flat, arrays)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(arrays, back))
    log(f"[legacy] multi_tensor_applier(multi_tensor_scale): one scale "
        f"launch; _native.flatten/unflatten bitwise (library "
        f"{_native.available()}); plan_buckets "
        f"{_native.plan_buckets([10] * 5, 25).tolist()}")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _dcgan_tree(netD, netG, optD, optG):
    from apex_tpu_torch import amp
    return {"netD": netD.state_dict(), "netG": netG.state_dict(),
            "optD": optD.state_dict(), "optG": optG.state_dict(),
            "amp": amp.state_dict([optD, optG])}


def _dcgan_checkpoint(ex, run, ck):
    """(z): the whole DCGAN state of (x)'s O1 run through
    utils.checkpoint_orbax, sync and async, restored in place into a fresh
    pair: every tensor bitwise; the next iteration on both bitwise; a torn
    save refused; keep pruning."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.utils import checkpoint_orbax as co
    args = ex.parse_args([])
    netD, netG, optD, optG = (run[k] for k in ("netD", "netG", "optD",
                                               "optG"))
    saved = _dcgan_tree(netD, netG, optD, optG)
    t0 = time.perf_counter()
    co.save_checkpoint(ck, 1, saved)        # the first: DCP's set-up too
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    co.save_checkpoint(ck, 2, saved, async_save=True)
    staged_ms = (time.perf_counter() - t0) * 1e3
    co.wait()
    async_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    co.save_checkpoint(ck, 3, saved)
    sync_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(saved))
    fresh = ex.build(ex.parse_args(["--seed", "1"]), torch.device(DEVICE))
    amp.set_policy(amp.NoPolicy())
    for step in (1, 2):
        t0 = time.perf_counter()
        back = co.restore_checkpoint(ck, _dcgan_tree(*fresh), step=step)
        restore_ms = (time.perf_counter() - t0) * 1e3
        assert all(same(a, b) for a, b in zip(_tensors(back),
                                              _tensors(saved)))
    # the next iteration, uninterrupted and restored, under O1's policy
    rng = np.random.RandomState(SEED + 7)
    real, z = ex.batch(rng, args, torch.device(DEVICE))
    amp.set_policy(amp.CastPolicy(torch.bfloat16))
    try:
        with _deterministic():
            la = ex.train_step(netD, netG, optD, optG, real, z)
            lb = ex.train_step(*fresh, real, z)
    finally:
        amp.set_policy(amp.NoPolicy())
    after = _tensors(_dcgan_tree(netD, netG, optD, optG))
    assert all(same(a, b) for a, b in zip(la, lb))
    assert all(same(a, b) for a, b in zip(
        after, _tensors(_dcgan_tree(*fresh))))
    # a torn save: the marker without the sidecar
    path = co.save_checkpoint(ck, 4, saved)
    os.unlink(os.path.join(path, "_apex_checksum.json"))
    with open(os.path.join(ck, "_apex_pending_step_4.json"), "w") as f:
        f.write('{"step": 4}')
    try:
        co.restore_checkpoint(ck, _dcgan_tree(*fresh), step=4)
        raise AssertionError("a torn save restored")
    except co.CheckpointCorrupt:
        pass
    co.save_checkpoint(ck, 5, saved, keep=2)
    assert co.available_steps(ck) == [4, 5], co.available_steps(ck)
    log(f"[legacy-z] DCGAN's whole state ({len(after)} tensors, {nbytes} "
        f"B: both models with their BatchNorm buffers, both AmpOptimizers, "
        f"amp.state_dict) through checkpoint_orbax: the first sync save "
        f"{cold_ms:.1f} ms (DCP's set-up too), a later one {sync_ms:.1f} "
        f"ms, async staged in {staged_ms:.1f} ms and durable "
        f"at the join in {async_ms:.1f} ms, restore {restore_ms:.1f} ms; "
        f"restored bitwise, the next iteration bitwise the uninterrupted "
        f"one (losses {[float(v) for v in la]}); a torn save refused; keep "
        f"pruned to [4, 5]")
    return {"bytes": nbytes, "first_sync_save_ms": cold_ms,
            "sync_save_ms": sync_ms,
            "async_staged_ms": staged_ms, "async_durable_ms": async_ms,
            "restore_ms": restore_ms}


def _zero_resume(tmp):
    """(z): examples/imagenet/main_amp_torch.py --zero --checkpoint-dir on
    a one-rank NCCL group (the example makes it), resnet18 at batch
    BATCH: three epochs of 3 iterations uninterrupted; the epoch-2
    checkpoint alone resumed for the third.  The third epoch's losses and
    the epoch-3 checkpoints bitwise."""
    import shutil
    from apex_tpu_torch.utils import checkpoint as ckpt
    example = _example()
    ck, ck2 = os.path.join(tmp, "zero"), os.path.join(tmp, "zero2")
    with _deterministic():
        _, counts, _, _, whole = _run_example(
            example, "legacy-zero", ZERO_RESUME_ARGV + [
                "--epochs", "3", "--checkpoint-dir", ck])
        assert ckpt.available_steps(ck) == [1, 2, 3]
        os.makedirs(ck2)
        name = os.path.basename(ckpt._path(ck, 2))
        shutil.copy(os.path.join(ck, name), os.path.join(ck2, name))
        _, counts_r, text, _, third = _run_example(
            example, "legacy-zero-resume", ZERO_RESUME_ARGV + [
                "--epochs", "3", "--checkpoint-dir", ck2, "--resume"])
    assert "resumed from epoch 2" in text
    assert third == whole[6:], (third, whole)
    with np.load(ckpt._path(ck, 3)) as a, np.load(ckpt._path(ck2, 3)) as b:
        keys = sorted(a.files)
        assert keys == sorted(b.files)
        for k in keys:
            assert a[k].tobytes() == b[k].tobytes(), k
    expect = {"multi_tensor_scale": EXAMPLE_WARMUP + 9,
              "fused_adam": EXAMPLE_WARMUP + 9,
              "syncbn_fwd": BN_OF["resnet18"] * (EXAMPLE_WARMUP + 9),
              "syncbn_bwd": BN_OF["resnet18"] * (EXAMPLE_WARMUP + 9)}
    _check_counts("legacy-zero", counts, expect)
    log(f"[legacy-z] --zero --checkpoint-dir: 3 epochs of 3 iterations, "
        f"then the epoch-2 checkpoint resumed: the third epoch's losses "
        f"{third} bitwise the uninterrupted run's, the epoch-3 checkpoints "
        f"bitwise ({len(keys)} arrays)")
    return {"third_epoch_losses": third, "arrays": len(keys)}


def _legacy_rows(counts_x, counts_twin, counts_y, n_mlstm, run):
    """The "kernels_legacy" line: scale and Adam without the half copy at
    G's and D's flat lengths (O1), scale, l2norm and Adam with the fp16
    copy at the mLSTM's, the syncbn forward and backward at DCGAN's 7
    BatchNorm shapes (batch 64) in bf16 (O1, O2) and fp32 (the twin),
    each against its plain version, then timed."""
    from apex_tpu_torch import ops
    from apex_tpu_torch.ops import adam as adam_mod
    from apex_tpu_torch.ops import multi_tensor as mt
    from apex_tpu_torch.ops import syncbn as sbn
    dev = torch.device(DEVICE)
    rows = {}
    lengths = {"G": run["optG"].masters.layout.total,
               "D": run["optD"].masters.layout.total,
               "mLSTM": n_mlstm}
    for tag, n in lengths.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 220)
        x = torch.randn(n, generator=gen, device=dev)
        g = torch.randn(n, generator=gen, device=dev) * 1024.0
        m0 = torch.randn(n, generator=gen, device=dev).abs() * 0.1
        v0 = torch.randn(n, generator=gen, device=dev).abs() * 0.01
        s = torch.full((), 1.0 / 65536.0, device=dev)
        out = torch.empty_like(x)
        err = {}
        ok, fk = ops.multi_tensor_scale(x, s, out=out)
        op, fp = mt._scale_plain(x, s, torch.empty_like(x))
        assert same(ok, op) and float(fk) == float(fp) == 0.0, tag
        err["multi_tensor_scale"] = max_abs(ok, op)
        del op
        half = (torch.empty(n, dtype=torch.float16, device=dev)
                if tag == "mLSTM" else None)
        ss = torch.full((), 5e-4, device=dev)
        inv = torch.full((), 1.0 / 1024.0, device=dev)
        args = (0.9, 0.999, 1e-8, False, 0.0)
        bk = [t.clone() for t in (x, m0, v0)]
        bp = [t.clone() for t in (x, m0, v0)]
        hk = None if half is None else torch.empty_like(half)
        hp = None if half is None else torch.empty_like(half)
        ops.fused_adam(*bk, g, ss, inv, *args, half=hk)
        adam_mod._adam_plain(*bp, g, ss, inv, *args, hp, None)
        for a, b in zip(bk + ([hk] if hk is not None else []),
                        bp + ([hp] if hp is not None else [])):
            assert same(a, b), f"[legacy] adam {tag}: kernel != plain"
        err["fused_adam"] = max(max_abs(a, b) for a, b in zip(bk, bp))
        del bk, bp, hk, hp
        pl = torch.nn.Parameter(x.clone())
        pl.grad = g.clone()
        lib_adam = torch.optim.Adam([pl], lr=5e-4, fused=True,
                                    capturable=True)
        timing = {
            f"multi_tensor_scale:{tag}": (
                8 * n, 0, lambda: ops.multi_tensor_scale(x, s, out=out),
                lambda: mt._scale_plain(x, s, out), lambda: torch.mul(x, s)),
            f"fused_adam:{tag}": (
                (30 if half is not None else 28) * n, 0,
                lambda: ops.fused_adam(x, m0, v0, g, ss, inv, *args,
                                       half=half),
                lambda: adam_mod._adam_plain(x, m0, v0, g, ss, inv, *args,
                                             half, None),
                lib_adam.step)}
        if tag == "mLSTM":
            nk, np_ = ops.multi_tensor_l2norm(x), mt._l2norm_plain(x)
            assert abs(float(nk) - float(np_)) <= 1e-6 * float(np_)
            err["multi_tensor_l2norm"] = abs(float(nk) - float(np_))
            timing[f"multi_tensor_l2norm:{tag}"] = (
                4 * n, 0, lambda: ops.multi_tensor_l2norm(x),
                lambda: mt._l2norm_plain(x),
                lambda: torch.linalg.vector_norm(x))
        per = (f"n = {n} fp32 (the mLSTM's, fp16 copy), one call a step"
               if tag == "mLSTM" else
               f"n = {n} fp32 (DCGAN's {tag} at O1, no half copy), one "
               f"call an iteration")
        rows.update(_time_rows(timing, err, per, plain_graph=(2, 5)))
        del timing, lib_adam, pl, x, g, m0, v0, out, half
        _mem_floor()
    # syncbn at DCGAN's BatchNorm shapes, one forward and one backward a
    # layer summed over the 7 layers
    shapes = _dcgan_bn_shapes()
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "call_ms": 0.0, "bytes": 0, "err": 0.0}
               for k in ("syncbn_fwd", "syncbn_bwd")}
        ratio = 0.0
        for i, shape in enumerate(shapes):
            (x, dy, mean, inv, w, b), errs, rat = _bn_check(
                shape, dtype, SEED + 230 + i)
            ratio = max(ratio, rat["kernel"], rat["plain"])
            B_, C, H, W = shape
            nel, isz = x.numel(), x.element_size()
            count = torch.full((1,), B_ * H * W, dtype=torch.int32,
                               device=dev)
            for key, e, nbytes, kern, plain, lib in (
                    ("syncbn_fwd", errs[0], 2 * nel * isz + 4 * C * 4,
                     lambda: ops.syncbn_fwd(x, mean, inv, w, b),
                     lambda: sbn._fwd_plain(x, mean, inv, w, b),
                     lambda: torch.batch_norm_elemt(x, w, b, mean, inv,
                                                    1e-5)),
                    ("syncbn_bwd", errs[1],
                     3 * nel * isz + 3 * C * 4 + 2 * B_ * C * 4,
                     lambda: ops.syncbn_bwd(dy, x, mean, inv, w),
                     lambda: sbn._bwd_plain(dy, x, mean, inv, w),
                     lambda: _lib_bn_bwd(dy, x, mean, inv, w, count))):
                t = tot[key]
                t["ms"] += graph_ms(kern)
                t["plain_ms"] += graph_ms(plain)
                t["library_ms"] += graph_ms(lib)
                t["call_ms"] += time_ms(kern)
                t["bytes"] += nbytes
                t["err"] = max(t["err"], e)
            del x, dy
        launches = counts_twin if dtype == torch.float32 else counts_x
        for key, t in tot.items():
            bound = t["bytes"] / MEM_BYTES_PER_S * 1e3
            rows[f"{key}:{tag}"] = {
                "name": key, "route": "cuda", "source": SOURCE[key],
                "replaces": REPLACES[key], "launches": launches[key],
                "max_abs_err": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound,
                "bound_by": "bytes", "library_ms": t["library_ms"],
                "call_ms": t["call_ms"], "bytes": t["bytes"],
                "row_sum_bound_ratio": ratio,
                "per": f"DCGAN's 7 BatchNorm layers at batch 64 ({tag}), "
                       f"one call each: {shapes}"}
            log(f"[legacy] {key}:{tag} over the 7 layers: kernel_ms "
                f"{t['ms']:.4f} bound_ms {bound:.4f} plain_ms "
                f"{t['plain_ms']:.4f} library_ms {t['library_ms']:.4f}; "
                f"eager calls {t['call_ms']:.4f}; y and dx bitwise, row "
                f"sums within {ratio:.3e} of their bound")
    out = []
    for key, row in rows.items():
        row["variant"] = key
        tag = key.split(":")[1]
        if tag == "mLSTM":
            row["launches"] = counts_y[row["name"]]
        elif tag in ("G", "D"):
            # an iteration steps each of the two optimizers once
            row["launches"] = counts_x[row["name"]] // 2
        out.append(row)
    return out


def _dcgan_bn_shapes():
    """(B, C, H, W) of DCGAN's 7 BatchNorm inputs at batch 64 (G's four,
    then D's three), read off one forward on the CPU."""
    from apex_tpu_torch import models, nn
    g, d = models.dcgan(generator=torch.Generator().manual_seed(SEED))
    shapes = []
    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(
                lambda mod, a: shapes.append((64,) + tuple(a[0].shape[1:])))
    with torch.no_grad():
        d(g(torch.zeros(1, 100, 1, 1)))
    assert len(shapes) == 7, shapes
    return shapes


def phase_legacy(smi):
    """Phase 22: the Apex legacy surface and the sharded checkpoint: (x)
    DCGAN, (y) the mLSTM under the legacy FP16_Optimizer and the RNN
    twins, the legacy amp handle and the shims, (z) checkpoints; the
    "kernels_legacy" line.  Leaves amp.policy at NoPolicy."""
    import tempfile
    from apex_tpu_torch import amp
    t0 = time.time()
    ex = _dcgan_example()
    results = {}
    try:
        run, counts_x, results["x_o1"] = _dcgan_run(ex, "O1", [],
                                                    DCGAN_ITERS)
        _, _, results["x_o2"] = _dcgan_run(ex, "O2", ["--opt-level", "O2"],
                                           DCGAN_O2_ITERS)
        results["x_twin"], counts_twin = _dcgan_twin(ex)
        log(f"[time] legacy (x) in {time.time() - t0:.1f} s")
        results["y"], counts_y, n_mlstm = _mlstm(smi)
        results["y_rnn"] = _rnn_twins()
        log(f"[time] legacy (y) in {time.time() - t0:.1f} s")
        results["handle"] = _legacy_handle()
        _shims()
        with tempfile.TemporaryDirectory() as tmp:
            results["z_dcgan"] = _dcgan_checkpoint(
                ex, run, os.path.join(tmp, "dcgan"))
            results["z_zero"] = _zero_resume(tmp)
        log(f"[time] legacy (z) in {time.time() - t0:.1f} s")
        rows = _legacy_rows(counts_x, counts_twin, counts_y, n_mlstm, run)
        log(f"[time] legacy rows in {time.time() - t0:.1f} s")
    finally:
        amp.set_policy(amp.NoPolicy())
    del run
    _mem_floor()
    results["card"] = smi
    results["seconds"] = time.time() - t0
    log("legacy " + json.dumps(results, default=str))
    return rows, results


# -- phase 23: the serving fleet ----------------------------------------------

FLEET_REQUESTS = 96                 # three waves of 32: both replicas full
FLEET_WAVE = 32
FLEET_WAVE_AT = 12                  # fleet ticks between two waves
FLEET_PLEN, FLEET_NEW = (32, 768), (32, 256)   # all within 1,024 positions
FLEET_I = 32                        # (ac)'s interactive requests
FLEET_I_PLEN, FLEET_I_NEW = (32, 128), 32
FLEET_I_DEADLINE = 3.0              # (ac): ticks of its tick clock; one
                                    # dispatched at once finishes in its
                                    # 4th step, one that waits misses
FLEET_I_WAVE, FLEET_I_AT = 8, 4     # (ac): 8 interactive every 4 ticks
FLEET_FAULT_AT = 20                 # (ab): replica 1 raises from its 20th
FLEET_PROFILE_AT = 4                # (aa)'s profiled ticks: the first
                                    # wave decoding, no admission
FLEET_PREFIX_REQUESTS = 32          # (ad): half of them with the prefix


class _Timed:
    """A replica whose ``step()`` wall time is summed: a serial tick's
    wall time less its replicas' steps is the fleet's own cost."""

    def __init__(self, rep):
        self._rep = rep
        self.step_s = 0.0

    def step(self):
        t = time.perf_counter()
        try:
            return self._rep.step()
        finally:
            self.step_s += time.perf_counter() - t

    def __getattr__(self, name):
        return getattr(self._rep, name)


def _fleet_schedule(n, wave, every, first=0):
    """Waves of ``wave`` traffic indices, one every ``every`` ticks."""
    return [(first + k * every, list(range(i, min(i + wave, n))))
            for k, i in enumerate(range(0, n, wave))]


def _fleet_run(fl, traffic, tag, schedule, profile=False, on_tick=None):
    """``traffic`` (prompt, max_new, kwargs) through the fleet ``fl``, each
    index submitted at its tick of ``schedule`` (a shed one again at the
    next tick): the results by index (None where not finished), tok/s
    over the timed ticks, TTFT by index (a wave's release to the request's
    first emitted token), each tick's wall ms, the sheds, and with
    ``profile`` the device time by category of three profiled ticks (left
    out of the timing, not of the schedule).  ``on_tick()`` runs after
    every tick."""
    from apex_tpu_torch.fleet import FleetOverloaded
    rid_of, arrive, first, pending = {}, {}, {}, []
    tick_ms, counted = [], {"tokens": 0, "ticks": 0, "shed": 0}
    waves = sorted(schedule)

    def tick(timed=True):
        while waves and waves[0][0] <= counted["ticks"]:
            now = time.perf_counter()
            for i in waves.pop(0)[1]:
                arrive[i] = now
                pending.append(i)
        still = []
        for i in pending:
            p, n, kw = traffic[i]
            try:
                rid_of[fl.submit(p, n, **kw)] = i
            except FleetOverloaded:
                counted["shed"] += 1
                still.append(i)
        pending[:] = still
        counted["ticks"] += 1
        if not fl.live():
            return                      # idle until the next wave
        ts = time.perf_counter()
        out = fl.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        if timed:
            tick_ms.append((now - ts) * 1e3)
        for rid, toks in out.items():
            first.setdefault(rid_of[rid], now)
            if timed:
                counted["tokens"] += len(toks)
        if on_tick is not None:
            on_tick()

    prof, excl_s, profiled = None, 0.0, not profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while waves or pending or fl.live():
        if not profiled and counted["ticks"] >= FLEET_PROFILE_AT \
                and tick_ms:
            profiled = True
            tp = time.perf_counter()
            prof = phase_profile(lambda: tick(False),
                                 statistics.median(tick_ms),
                                 f"{tag}-profile", steps=3)
            excl_s += time.perf_counter() - tp
            continue
        tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - excl_s
    by_index = {i: r for r, i in rid_of.items()}
    results = [fl.result(by_index[i])
               if i in by_index and fl.status(by_index[i]) == "finished"
               else None for i in range(len(traffic))]
    median = statistics.median(tick_ms)
    return {"results": results, "tokens": sum(len(r) for r in results
                                              if r is not None),
            "tok_s": counted["tokens"] / wall, "wall_s": wall,
            "ticks": len(tick_ms), "tick_ms": tick_ms,
            "tick_ms_median": median, "shed": counted["shed"],
            "ttft": {i: first[i] - arrive[i] for i in first},
            "profile": prof,
            "profile_idle_share": (1 - sum(prof.values()) / median
                                   if prof else None)}


def _fleet_expect(engines, before, chunks=0):
    """The flash and LayerNorm launches the engines made since ``before``
    (their ``stats()``), summed over replicas: a full-buffer prefill a
    fresh admission (flash and two LayerNorms a block), GPT-2's 25
    LayerNorms a decode tick, SRV_WINDOW ticks a window, 25 a splice
    chunk; and the LayerNorms by shape."""
    from apex_tpu_torch import models
    n_l = models.gpt2_small().n_layer
    fresh = windows = 0
    for e, b in zip(engines, before):
        s = e.stats()
        fresh += ((s["admitted"] - b["admitted"])
                  - (s.get("prefix_hits", 0) - b.get("prefix_hits", 0)))
        windows += s["decode_steps"] - b["decode_steps"]
    ln = {"fleet": windows * SRV_WINDOW * (2 * n_l + 1),
          "fleet-prefill": fresh * 2 * n_l,
          "fleet-chunk": chunks * (2 * n_l + 1)}
    return {"flash_fwd": fresh * n_l,
            "layer_norm_fwd": sum(ln.values())}, ln


def _fleet_pools(engines):
    """Each engine's graph pool held on the card (the segments of its pool
    in the allocator's snapshot), or None where the snapshot names no
    pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return [sum(s["total_size"] for s in segs
                if tuple(s["segment_pool_id"]) == tuple(e._pool))
            for e in engines]


def _ttft_pcts(ttft, idx):
    vals = [ttft[i] for i in idx if i in ttft]
    return ({"p50_s": float(np.percentile(vals, 50)),
             "p99_s": float(np.percentile(vals, 99))} if vals else None)


def _fleet_aa(engines, traffic, totals, ln_at):
    """(aa): the reference (one warmed replica alone, a one-replica
    fleet), then the fleet of two, least_loaded, with step_workers 1 and
    2: every result the reference's, no failover, failure or shed, no
    capture after warmup(), exact launches equal in both runs."""
    from apex_tpu_torch.fleet import Fleet
    sched = _fleet_schedule(len(traffic), FLEET_WAVE, FLEET_WAVE_AT)
    caps = [dict(e.captures) for e in engines]
    before = [engines[0].stats()]
    ref, c_ref = _counted(lambda: _fleet_run(
        Fleet([engines[0]], max_queue=FLEET_REQUESTS, step_workers=1),
        traffic, "fleet-aa-ref", sched))
    want, ln = _fleet_expect(engines[:1], before)
    _check_counts("fleet-aa-ref", c_ref, want)
    _add(totals, c_ref)
    _fleet_add_ln(ln_at, ln)
    assert all(r is not None for r in ref["results"]), "fleet-aa-ref"
    out = {"ref": {k: ref[k] for k in ("tokens", "tok_s", "wall_s", "ticks",
                                       "tick_ms_median")},
           "ref_ttft": _ttft_pcts(ref["ttft"], range(len(traffic)))}
    counts = {}
    for workers in (1, 2):
        tag = f"fleet-aa-w{workers}"
        reps = [_Timed(e) for e in engines]
        fl = Fleet(reps, policy="least_loaded", max_queue=FLEET_REQUESTS,
                   step_workers=workers)
        before = [e.stats() for e in engines]
        run, counts[workers] = _counted(lambda: _fleet_run(
            fl, traffic, tag, sched, profile=(workers == 2)))
        fl.close()
        s = fl.stats()
        assert (s["failovers"], s["failed"], s["shed"], run["shed"]) \
            == (0, 0, 0, 0), (tag, s["failovers"], s["failed"], s["shed"])
        assert run["results"] == ref["results"], \
            f"[{tag}] a result differs from the one-replica reference"
        assert [dict(e.captures) for e in engines] == caps, \
            (tag, [e.captures for e in engines], caps)
        want, ln = _fleet_expect(engines, before)
        _check_counts(tag, counts[workers], want)
        _add(totals, counts[workers])
        _fleet_add_ln(ln_at, ln)
        step_s = sum(r.step_s for r in reps)
        res = {k: run[k] for k in ("tokens", "tok_s", "wall_s", "ticks",
                                   "tick_ms_median", "profile_idle_share")}
        res.update(ttft=_ttft_pcts(run["ttft"], range(len(traffic))),
                   replica_step_ms_per_tick=step_s * 1e3 / run["ticks"],
                   launches=counts[workers])
        if workers == 1:
            # serial: the tick's wall time less its replicas' steps; the
            # goodput window (the fleet's clock) has no profile in it
            res["fleet_host_ms_per_tick"] = (
                sum(run["tick_ms"]) - step_s * 1e3) / run["ticks"]
            res["goodput_tokens_per_s"] = s["goodput_tokens_per_s"]
        out[f"w{workers}"] = res
        log(f"[{tag}] {run['tokens']} tokens, {run['tok_s']:.1f} tok/s "
            f"(one replica alone: {ref['tok_s']:.1f}), {run['ticks']} "
            f"ticks, tick median {run['tick_ms_median']:.3f} ms, replica "
            f"steps {res['replica_step_ms_per_tick']:.3f} ms a tick"
            + (f", the fleet's own {res['fleet_host_ms_per_tick']:.3f} ms a"
               f" tick" if workers == 1 else
               f", device idle share {run['profile_idle_share']}")
            + f"; every result the reference's; launches {counts[workers]}")
    assert counts[1] == counts[2], counts
    return out, ref["results"]


def _fleet_add_ln(ln_at, ln):
    for k, v in ln.items():
        ln_at[k] = ln_at.get(k, 0) + v


def _fleet_ab(engines, traffic, ref, totals, ln_at):
    """(ab): (aa)'s traffic with replica 1 raising from its FLEET_FAULT_AT-th
    step: every result the reference's, failed over and dead, the
    survivor capturing nothing, the ring dumped with the failover, MTTR,
    the fleet and trace records valid."""
    import tempfile
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.fleet import (FaultyReplica, Fleet, HealthConfig,
                                      RetryPolicy)
    from apex_tpu_torch.observability.exporters import (
        JsonlExporter, validate_fleet_record, validate_trace_record)
    sched = _fleet_schedule(len(traffic), FLEET_WAVE, FLEET_WAVE_AT)
    caps = dict(engines[0].captures)
    bad = FaultyReplica(engines[1])
    bad.arm(raise_on_step=(FLEET_FAULT_AT, None))
    ring = obs.EventRing(capacity=256)
    rec = obs.SpanRecorder()
    prev = obs.set_recorder(rec)
    before = [e.stats() for e in engines]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dump = os.path.join(tmp, "flight.jsonl")
            fl = Fleet([engines[0], bad], policy="least_loaded",
                       max_queue=FLEET_REQUESTS, step_workers=2,
                       health=HealthConfig(dead_consecutive=2,
                                           cooldown_steps=50),
                       retry=RetryPolicy(max_attempts=6, jitter=0.0),
                       ring=ring, flight_dump_path=dump)
            run, counts = _counted(lambda: _fleet_run(fl, traffic,
                                                      "fleet-ab", sched))
            fl.close()
            with open(dump) as f:
                dumped = [json.loads(ln) for ln in f]
        s = fl.stats()
        assert run["results"] == ref, \
            "[fleet-ab] a failed-over result differs from the reference"
        assert s["failovers"] >= 1 and s["failed"] == 0 and s["dead"] == 1, \
            (s["failovers"], s["failed"], s["dead"])
        fo = ring.snapshot("failover")
        assert fo and all(e["replica"] == 1
                          and "injected step fault" in e["reason"]
                          for e in fo), fo
        assert dict(engines[0].captures) == caps, "[fleet-ab] survivor"
        assert any(e["kind"] == "failover" for e in dumped[1:])
        mttr = fl.mttr()
        assert mttr["count"] >= 1 and mttr["last"] > 0, mttr
        frec = JsonlExporter.enrich(fl.record())
        assert validate_fleet_record(frec) == [], \
            validate_fleet_record(frec)
        moved = [r for r in range(fl._next_rid)
                 if fl._results[r].restarts > 0]
        trec = JsonlExporter.enrich(fl.trace_record(moved[0]))
        assert validate_trace_record(trec) == [], validate_trace_record(trec)
        names = [e["name"] for e in rec.trace(fl.request_trace_id(moved[0]))]
        assert "fleet_fault" in names and "fleet_reclaim" in names, names
    finally:
        obs.set_recorder(prev)
    want, ln = _fleet_expect(engines, before)
    _check_counts("fleet-ab", counts, want)
    _add(totals, counts)
    _fleet_add_ln(ln_at, ln)
    out = {"tok_s": run["tok_s"], "ticks": run["ticks"],
           "failovers": s["failovers"], "restarted": len(moved),
           "mttr_s": mttr["last"], "mttr": mttr,
           "ttft": _ttft_pcts(run["ttft"], range(len(traffic))),
           "ring_events": len(dumped) - 1, "launches": counts}
    log(f"[fleet-ab] replica 1 raised from its step {FLEET_FAULT_AT}: "
        f"{s['failovers']} requests failed over ({len(moved)} restarted), "
        f"every result the reference's, MTTR {mttr['last']:.4f} s, "
        f"{run['tok_s']:.1f} tok/s; dump {len(dumped) - 1} events with the "
        f"failover; fleet and trace records valid")
    return out


class _TickClock:
    """(ac)'s fleet clock: one unit a fleet tick, so a deadline is a
    count of ticks and the requests that miss it are the same on every
    card (the tick schedule is request-intrinsic)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fleet_ac(engines, traffic, ref, totals, ln_at):
    """(ac): QoS and SLO.  interactive (weight 4, not preemptible, short
    prompts, FLEET_I_NEW new tokens, a deadline of FLEET_I_DEADLINE
    ticks) over batch (weight 1, preemptible: (aa)'s first wave),
    preemption on, a SloController ticked once a fleet tick, the fleet
    on a tick clock: every finished request, preempted ones included,
    the one-replica fleet's tokens with no QoS policy; every batch
    request finished; no failover, no dead replica, and no failure but
    a missed deadline; each preemption the fleet counts one that an
    engine made; attainment below 1 when the controller first acts; its
    actions of RECOVERY_ACTION_KINDS and within its bound; its record
    valid."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.fleet import (AutoscaleConfig, Fleet, QosClass,
                                      QosPolicy, SloController)
    from apex_tpu_torch.fleet.recovery import RECOVERY_ACTION_KINDS
    from apex_tpu_torch.observability.exporters import (
        JsonlExporter, validate_fleet_record, validate_recovery_record)
    inter = _srv_traffic(SEED + 231, FLEET_I, FLEET_I_PLEN,
                         (FLEET_I_NEW, FLEET_I_NEW), 50257)
    batch = [(p, n, {"tenant": "bob"}) for p, n, _ in traffic[:FLEET_WAVE]]
    inter = [(p, n, {"tenant": "alice", "deadline": FLEET_I_DEADLINE})
             for p, n, _ in inter]
    mixed = batch + inter
    nb = len(batch)
    # the first interactive wave one tick after the batch wave filled
    # every slot: no batch request has finished yet, so it preempts
    sched = [(0, list(range(nb)))] + _fleet_schedule(
        len(inter), FLEET_I_WAVE, FLEET_I_AT, first=1)
    sched = [(t, [nb + i for i in idx]) if k else (t, idx)
             for k, (t, idx) in enumerate(sched)]
    # the interactive requests' reference: a one-replica fleet, no QoS
    # and no deadline
    before = [engines[0].stats()]
    iref, c = _counted(lambda: _fleet_run(
        Fleet([engines[0]], max_queue=FLEET_REQUESTS, step_workers=1),
        [(p, n, {}) for p, n, _ in inter], "fleet-ac-ref",
        _fleet_schedule(len(inter), FLEET_WAVE, 1)))
    want, ln = _fleet_expect(engines[:1], before)
    _check_counts("fleet-ac-ref", c, want)
    _add(totals, c)
    _fleet_add_ln(ln_at, ln)
    expect = ref[:nb] + iref["results"]
    pol = QosPolicy([QosClass("interactive", weight=4, preemptible=False),
                     QosClass("batch", weight=1, preemptible=True)],
                    tenant_class={"alice": "interactive", "bob": "batch"})
    clock, ring = _TickClock(), obs.EventRing(capacity=1024)
    fl = Fleet(engines, policy="least_loaded", max_queue=FLEET_REQUESTS,
               step_workers=2, qos=pol, clock=clock, ring=ring)
    cfg = AutoscaleConfig()
    ctrl = SloController(fl, cfg)
    acts, acted_at = [], []

    def on_tick():
        clock.t += 1.0
        got = ctrl.tick()
        if got and not acted_at:
            acted_at.append({"tick": clock.t,
                             "slo_attainment": fl.slo.slo_attainment,
                             "signal": dict(ctrl.last_signal)})
        acts.extend(got)

    before = [e.stats() for e in engines]
    run, counts = _counted(lambda: _fleet_run(
        fl, mixed, "fleet-ac", sched, on_tick=on_tick))
    fl.close()
    s = fl.stats()
    done = [i for i, r in enumerate(run["results"]) if r is not None]
    assert all(run["results"][i] == expect[i] for i in done), \
        "[fleet-ac] a finished request differs from its reference"
    assert all(run["results"][i] is not None for i in range(nb)), \
        "[fleet-ac] a batch request did not finish"
    # the fleet turns a replica's exception into a failover, and drops
    # one from a replica's preempt(): neither may hide here
    assert (s["failovers"], s["dead"]) == (0, 0), \
        (s["failovers"], s["dead"])
    assert not ring.snapshot("failover"), ring.snapshot("failover")
    assert s["failed"] == s["deadline_exceeded"] == len(mixed) - len(done), \
        (s["failed"], s["deadline_exceeded"], len(mixed) - len(done))
    evicted = sum(e.stats()["preempted"] - b["preempted"]
                  for e, b in zip(engines, before))
    assert s["preemptions"] >= 1 and evicted == s["preemptions"], \
        (s["preemptions"], evicted)
    missed = s["deadline_exceeded"]
    assert 0 < missed < len(inter), (missed, len(inter))
    assert acts and acted_at, "[fleet-ac] the controller never acted"
    assert acted_at[0]["slo_attainment"] is not None \
        and acted_at[0]["slo_attainment"] < 1.0, acted_at[0]
    assert all(a["kind"] in RECOVERY_ACTION_KINDS for a in acts), acts
    crec = JsonlExporter.enrich(ctrl.record())
    assert validate_recovery_record(crec) == [], \
        validate_recovery_record(crec)
    assert 1 <= crec["max_actions_in_episode"] \
        <= cfg.max_actions_per_episode, crec["max_actions_in_episode"]
    frec = JsonlExporter.enrich(fl.record())
    assert validate_fleet_record(frec) == [], validate_fleet_record(frec)
    want, ln = _fleet_expect(engines, before)
    _check_counts("fleet-ac", counts, want)
    _add(totals, counts)
    _fleet_add_ln(ln_at, ln)
    good = s["slo"]["goodput_tokens"]
    out = {"tok_s": run["tok_s"], "ticks": run["ticks"],
           "finished": len(done), "preemptions": s["preemptions"],
           "deadline_ticks": FLEET_I_DEADLINE, "deadline_missed": missed,
           "shed": run["shed"],
           "ttft_interactive": _ttft_pcts(run["ttft"], range(nb, len(mixed))),
           "ttft_batch": _ttft_pcts(run["ttft"], range(nb)),
           "goodput_tokens": good,
           "goodput_tokens_per_s": good / run["wall_s"],
           "slo_attainment": s["slo"]["slo_attainment"],
           "classes": {c: {k: b[k] for k in ("finished", "preempted",
                                             "slo_attainment",
                                             "goodput_tokens")}
                       for c, b in s["classes"].items()},
           "first_action": acted_at[0],
           "actions": [a["kind"] for a in acts],
           "episodes": crec["episodes"],
           "max_actions_in_episode": crec["max_actions_in_episode"],
           "launches": counts}
    log(f"[fleet-ac] {len(done)} of {len(mixed)} finished, each its "
        f"reference's tokens; {s['preemptions']} preemptions, each an "
        f"engine's; {missed} interactive missed the {FLEET_I_DEADLINE:g}-"
        f"tick deadline, {run['shed']} sheds; TTFT p50/p99 interactive "
        f"{out['ttft_interactive']}, batch {out['ttft_batch']}; goodput "
        f"{out['goodput_tokens_per_s']:.1f} tok/s, SLO attainment "
        f"{s['slo']['slo_attainment']}; controller first acted at tick "
        f"{acted_at[0]['tick']:g} with attainment "
        f"{acted_at[0]['slo_attainment']}, actions {out['actions']}")
    return out


def _fleet_ad(pre, other, totals, ln_at):
    """(ad): a prefix registered on replica 0 after warmup, so its prefix
    graphs first capture during traffic, stepped with step_workers=2
    under prefix_affinity while replica 1 serves; then the same traffic
    with step_workers=1 (the prefix registered again: its seeding graph
    captures there).  The tokens of the two runs equal."""
    from apex_tpu_torch.fleet import Fleet
    rs = np.random.RandomState(SEED + 232)
    prefix = [int(t) for t in rs.randint(0, 50257, GPT2_PREFIX)]
    fresh = _srv_traffic(SEED + 233, FLEET_PREFIX_REQUESTS, GPT2_PLEN,
                         GPT2_NEW, 50257)
    tr = [((prefix + p) if i % 2 == 0 else p, n, kw)
          for i, (p, n, kw) in enumerate(fresh)]
    sched = _fleet_schedule(len(tr), FLEET_WAVE, FLEET_WAVE_AT)
    engines = [pre, other]
    results, out = [], {}
    for workers in (2, 1):
        tag = f"fleet-ad-w{workers}"
        fl = Fleet(engines, policy="prefix_affinity",
                   max_queue=FLEET_REQUESTS, step_workers=workers)
        assert fl.register_prefix(prefix, replica=0) == 0
        caps, lazy = dict(pre.captures), pre.uncaptured()
        before = [e.stats() for e in engines]
        run, counts = _counted(lambda: _fleet_run(fl, tr, tag, sched))
        fl.close()
        s = fl.stats()
        assert s["failed"] == 0 and s["failovers"] == 0, tag
        assert all(r is not None for r in run["results"]), tag
        spliced = [fl._results[r].prompt for r in range(fl._next_rid)
                   if fl._results[r].assigned[0] == 0
                   and fl._results[r].prompt[:GPT2_PREFIX] == prefix]
        chunks = sum(_srv_chunks(len(p), GPT2_PREFIX, GPT2_CHUNK,
                                 GPT2_SRV_BUF) for p in spliced)
        want, ln = _fleet_expect(engines, before, chunks)
        _check_counts(tag, counts, want)
        _add(totals, counts)
        _fleet_add_ln(ln_at, ln)
        new = sorted(set(pre.captures) - set(caps))
        if workers == 2:
            assert lazy and set(lazy) <= set(new), (lazy, new)
        out[f"w{workers}"] = {"tok_s": run["tok_s"], "ticks": run["ticks"],
                              "prefix_hits": len(spliced),
                              "captured_in_traffic": new,
                              "uncaptured_before": lazy,
                              "launches": counts}
        results.append(run["results"])
        log(f"[{tag}] {run['tokens']} tokens, {run['tok_s']:.1f} tok/s, "
            f"{len(spliced)} spliced on replica 0; graphs uncaptured before "
            f"the traffic {lazy}, captured during it {new}")
    assert results[0] == results[1], \
        "[fleet-ad] step_workers=2 tokens differ from step_workers=1"
    return out


def phase_fleet(smi):
    """Phase 23: the serving fleet over the port's engines on the card.
    Two GPT-2 small Engines (12 layers, width 768, bf16, random from
    SEED; 16 slots, window 8, buf_len 1,024) and a third with a prefix
    pool, warmed by one Fleet.warmup(); (aa) fault-free, (ab) failover,
    (ac) QoS with preemption and the SLO controller, (ad) lazy capture
    under the step pool; the flash and LayerNorm forward at the fleet's
    shapes against their plain versions."""
    from apex_tpu_torch import serving
    from apex_tpu_torch.fleet import Fleet
    t0 = time.time()
    dev = torch.device(DEVICE)
    rows = {}
    rows.update(_srv_flash_row((1, 12, GPT2_SRV_BUF, 64), "fleet-gpt2"))
    for tag, n, calls in (("fleet", SRV_SLOTS, "25 calls a decode tick"),
                          ("fleet-prefill", GPT2_SRV_BUF,
                           "24 calls a prefill"),
                          ("fleet-chunk", GPT2_CHUNK,
                           "25 calls a splice chunk")):
        rows.update(_tail_ln_rows(n, tag, calls))
    log(f"[time] fleet kernel rows in {time.time() - t0:.1f} s")
    floor = _mem_floor()
    torch.cuda.reset_peak_memory_stats()
    t16 = _gpt2_small(dev).to(torch.bfloat16)

    def engine(**kw):
        return serving.Engine(t16, slots=SRV_SLOTS, buf_len=GPT2_SRV_BUF,
                              window=SRV_WINDOW, **kw)

    engines = [engine(), engine()]
    pre = engine(prefix_pool=2, prefix_chunk=GPT2_CHUNK)
    tw = time.perf_counter()
    Fleet(engines + [pre]).warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    for e in engines:
        assert e.uncaptured() == [], (e.captures, e.uncaptured())
    # the prefix pool's splice graphs wait for their first prefix hit
    assert pre.uncaptured() == sorted(
        k for k, st in pre.compile_census().items()
        if st == "prefix_admission"), pre.uncaptured()
    traffic = _srv_traffic(SEED + 230, FLEET_REQUESTS, FLEET_PLEN,
                           FLEET_NEW, 50257)
    totals, ln_at, summary = {}, {}, {"card": smi, "warmup_s": warm_s}
    summary["aa"], ref = _fleet_aa(engines, traffic, totals, ln_at)
    log(f"[time] fleet (aa) in {time.time() - t0:.1f} s")
    summary["ab"] = _fleet_ab(engines, traffic, ref, totals, ln_at)
    log(f"[time] fleet (ab) in {time.time() - t0:.1f} s")
    summary["ac"] = _fleet_ac(engines, traffic, ref, totals, ln_at)
    log(f"[time] fleet (ac) in {time.time() - t0:.1f} s")
    summary["ad"] = _fleet_ad(pre, engines[0], totals, ln_at)
    log(f"[time] fleet (ad) in {time.time() - t0:.1f} s")
    summary["peak_gib"] = (torch.cuda.max_memory_allocated()
                           - floor) / 2 ** 30
    pools = _fleet_pools(engines + [pre])
    summary["graph_pool_held_bytes"] = pools
    summary["kv_cache_bytes"] = [e.kv_cache_bytes()
                                 for e in engines + [pre]]
    # each row's launches: those of phase 23's runs at its shape
    rows["flash_fwd:fleet-gpt2"]["launches"] = totals["flash_fwd"]
    assert sum(ln_at.values()) == totals["layer_norm_fwd"], (ln_at, totals)
    for tag, n in ln_at.items():
        rows[f"layer_norm_fwd:{tag}"]["launches"] = n
    for key, row in rows.items():
        row["variant"] = key
    summary["launches"] = totals
    log(f"[fleet] peak {summary['peak_gib']:.3f} GiB above what the phase "
        f"found, graph pools held {pools} B (per engine; None: not "
        f"measured), KV {summary['kv_cache_bytes']} B, warmup "
        f"{warm_s:.2f} s, launches {totals}, LayerNorm by shape {ln_at}")
    del engines, pre, t16
    _mem_floor()
    summary["seconds"] = time.time() - t0
    log(f"[time] phase 23 in {summary['seconds']:.1f} s")
    log("fleet " + json.dumps(summary, default=str))
    return list(rows.values()), summary


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
    mp_rows, _ = phase_mp(smi)
    log(f"[time] phase 20 done at {time.time() - t0:.1f} s")
    sp_rows, _ = phase_sp_pp(smi)
    log(f"[time] phase 21 done at {time.time() - t0:.1f} s")
    legacy_rows, _ = phase_legacy(smi)
    log(f"[time] phase 22 done at {time.time() - t0:.1f} s")
    fleet_rows, _ = phase_fleet(smi)
    log(f"[time] phase 23 done at {time.time() - t0:.1f} s")

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
    log("kernels_mp " + json.dumps({"kernels": mp_rows}))
    log("kernels_sp " + json.dumps({"kernels": sp_rows}))
    log("kernels_legacy " + json.dumps({"kernels": legacy_rows}))
    log("kernels_fleet " + json.dumps({"kernels": fleet_rows}))
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
    elif sys.argv[1:2] == ["--mp"]:
        # python3 chip_smoke.py --mp: phases 1, 2 and 20 alone
        _, smi = phase_device()
        phase_build()
        mp_rows, _ = phase_mp(smi)
        log("kernels_mp " + json.dumps({"kernels": mp_rows}))
    elif sys.argv[1:2] == ["--sp-pp"]:
        # python3 chip_smoke.py --sp-pp: phases 1, 2 and 21 alone
        _, smi = phase_device()
        phase_build()
        sp_rows, _ = phase_sp_pp(smi)
        log("kernels_sp " + json.dumps({"kernels": sp_rows}))
    elif sys.argv[1:2] == ["--legacy"]:
        # python3 chip_smoke.py --legacy: phases 1, 2 and 22 alone
        _, smi = phase_device()
        phase_build()
        legacy_rows, _ = phase_legacy(smi)
        log("kernels_legacy " + json.dumps({"kernels": legacy_rows}))
    elif sys.argv[1:2] == ["--fleet"]:
        # python3 chip_smoke.py --fleet: phases 1, 2 and 23 alone
        _, smi = phase_device()
        phase_build()
        fleet_rows, _ = phase_fleet(smi)
        log("kernels_fleet " + json.dumps({"kernels": fleet_rows}))
    elif sys.argv[1:2] == ["--layer-norm-ab"]:
        # python3 chip_smoke.py --layer-norm-ab PARENT_CHECKOUT
        phase_device()
        phase_build()
        parent_ops = load_ops(sys.argv[2])
        parent_ops._build.build_all(["layer_norm"])
        phase_layer_norm_ab(parent_ops)
    else:
        main()
