"""Serving-path showcase for apex_tpu_torch, the PyTorch / NVIDIA GPU port:
examples/serving/demo.py (the JAX package's) with the same command line
plus ``--device``.

Builds a small GPT target (grouped-query attention, bf16 weights) and a
half-size draft, and runs one prompt batch through each decode mode,
printing its tokens and wall time:

  greedy   KV-cached greedy decode (chunked prefill)
  sample   temperature + top-k + nucleus sampling
  int8     weight-only int8 weights + the int8 KV cache
  spec     lossless speculative decoding with the draft model
  beam     beam search (--beams hypotheses)

The JAX demo's ``engine`` (continuous batching with a shared-prefix KV
pool) and ``seq2seq`` (T5 continuous batching) modes need the serving
engines, which the port does not have yet: ``run_engine`` and
``run_seq2seq`` raise.  Weights are random (seeded); the point is the
mechanics and the relative costs.

Run on the GPU:
  python examples/serving/demo_torch.py --batch 4 --prompt 16 --new 32
Run on the CPU (the plain versions of the kernels):
  python examples/serving/demo_torch.py --device cpu --batch 2 --new 8

``main(argv)`` runs in process and returns each mode's tokens.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

# allow running straight from a source checkout
_repo = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if (os.path.isdir(os.path.join(_repo, "apex_tpu_torch"))
        and _repo not in sys.path):
    sys.path.insert(0, _repo)

from apex_tpu_torch import models, quantization  # noqa: E402
from apex_tpu_torch._device import resolve_device  # noqa: E402
from apex_tpu_torch.models import (beam_search,  # noqa: E402
                                   generate_speculative)

MODES = ("greedy", "sample", "int8", "spec", "beam")
_UNPORTED = ("the serving engines (serving.py: Engine, PagedEngine, "
             "Seq2SeqEngine) are not ported yet: ROADMAP.md queue 1, item 5")


def build(n_layer, n_embd, seed, vocab, block, device):
    """A GPT with random weights from ``seed``, in bf16."""
    m = models.GPT(models.GPTConfig(
        vocab_size=vocab, block_size=block, n_layer=n_layer, n_head=4,
        n_embd=n_embd, dropout=0.0, n_kv_head=2), device=device,
        generator=torch.Generator().manual_seed(seed))
    return m.to(torch.bfloat16).eval()


def timed(label, fn, device):
    """``fn()``'s result, after printing its wall time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{label:8s} {time.perf_counter() - t0:7.3f}s", flush=True)
    return out


def run_engine(*args, **kwargs):
    """Continuous batching with a shared-prefix KV pool (the JAX demo's
    ``engine`` mode)."""
    raise NotImplementedError(f"engine mode: {_UNPORTED}")


def run_seq2seq(*args, **kwargs):
    """T5 continuous batching (the JAX demo's ``seq2seq`` mode)."""
    raise NotImplementedError(f"seq2seq mode: {_UNPORTED}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--new", type=int, default=32)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--block", type=int, default=None)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--beams", type=int, default=4)
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    block = args.block or (args.prompt + args.new)
    target = build(args.layers, args.width, 0, args.vocab, block, device)
    draft = build(max(1, args.layers // 2), args.width // 2, 1, args.vocab,
                  block, device)
    rng = np.random.RandomState(0)
    buf = np.zeros((args.batch, block), np.int64)
    buf[:, :args.prompt] = rng.randint(0, args.vocab,
                                       (args.batch, args.prompt))
    ids = torch.from_numpy(buf).to(device)
    plen = torch.full((args.batch,), args.prompt, device=device)
    out = {}

    out["greedy"] = timed("greedy", lambda: target.generate_cached(
        ids, plen, args.new)[0], device)
    gen = torch.Generator(device=device).manual_seed(7)
    out["sample"] = timed("sample", lambda: target.generate_cached(
        ids, plen, args.new, temperature=0.8, top_k=40, top_p=0.95,
        generator=gen)[0], device)
    qmodel = quantization.quantize_for_decode(target)
    out["int8"] = timed("int8", lambda: qmodel.generate_cached(
        ids, plen, args.new, cache_dtype=torch.int8)[0], device)
    out["spec"] = timed("spec", lambda: generate_speculative(
        target, draft, ids, plen, args.new, gamma=args.gamma)[0], device)
    exact = bool(torch.equal(out["spec"], out["greedy"]))
    print(f"speculative == greedy: {exact}")
    if not exact:
        sys.exit("LOSSLESSNESS VIOLATED")
    out["beam"] = timed("beam", lambda: beam_search(
        target, ids, plen, args.new, num_beams=args.beams)[0], device)
    for mode in MODES:
        print(f"{mode:8s} row 0: {out[mode][0, args.prompt:].tolist()}")
    print(f"engine, seq2seq: {_UNPORTED}")
    print("done", flush=True)
    return out


if __name__ == "__main__":
    main()
