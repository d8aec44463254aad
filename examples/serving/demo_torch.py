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
  engine   continuous batching (serving.Engine) with a shared-prefix KV
           pool: half the requests start with a registered system prefix
           and admit by KV splice
  seq2seq  T5 continuous batching (serving.Seq2SeqEngine)

Weights are random (seeded); the point is the mechanics and the relative
costs.  On the GPU each engine's admission and decode windows replay
CUDA graphs (``serving``'s module doc).

Run on the GPU:
  python examples/serving/demo_torch.py --batch 4 --prompt 16 --new 32
Run on the CPU (the plain versions of the kernels):
  python examples/serving/demo_torch.py --device cpu --batch 2 --new 8

``main(argv)`` runs in process and returns each mode's tokens (the
engine modes: their ``stats()`` and token counts).
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

from apex_tpu_torch import models, quantization, serving  # noqa: E402
from apex_tpu_torch._device import resolve_device  # noqa: E402
from apex_tpu_torch.models import (beam_search,  # noqa: E402
                                   generate_speculative)

MODES = ("greedy", "sample", "int8", "spec", "beam")
ENGINE_MODES = ("engine", "seq2seq")


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


def _drain(eng):
    """Step ``eng`` until nothing is live or queued; the tokens emitted."""
    n = 0
    while eng.live() or eng.stats()["waiting"]:
        n += sum(len(t) for t in eng.step().values())
    return n


def run_engine(target, args, block, rng):
    """Continuous batching with a shared-prefix KV pool: 2 x batch
    requests through ``batch`` slots, half of them starting with a
    registered system prefix (the JAX demo's ``engine`` mode)."""
    half = max(1, args.prompt // 2)
    eng = serving.Engine(target, slots=args.batch, buf_len=block,
                         prefix_pool=1)
    sys_prefix = list(rng.randint(0, args.vocab, half))
    eng.register_prefix(sys_prefix)
    for i in range(2 * args.batch):
        pr = (sys_prefix if i % 2 == 0 else
              list(rng.randint(0, args.vocab, half))) \
            + list(rng.randint(0, args.vocab, half))
        eng.submit(pr, max_new_tokens=args.new)
    n = _drain(eng)
    return eng.stats(), n


def run_seq2seq(args, rng, device):
    """T5 continuous batching: 2 x batch sources of random lengths
    through ``batch`` slots (the JAX demo's ``seq2seq`` mode)."""
    t5 = models.T5(models.T5Config(
        vocab_size=args.vocab, d_model=args.width, d_kv=16,
        d_ff=2 * args.width, num_layers=max(1, args.layers // 2),
        num_heads=4, dropout_rate=0.0), device=device,
        generator=torch.Generator().manual_seed(2))
    eng = serving.Seq2SeqEngine(t5.eval(), slots=args.batch,
                                src_len=args.prompt, max_new_cap=args.new)
    for _ in range(2 * args.batch):
        n_src = int(rng.randint(1, args.prompt + 1))
        eng.submit(list(rng.randint(2, args.vocab, n_src)),
                   max_new_tokens=args.new)
    n = _drain(eng)
    return eng.stats(), n


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
    st, n = timed("engine", lambda: run_engine(target, args, block, rng),
                  device)
    print(f"engine: {n} tokens over {st['finished']} requests, "
          f"{st['prefix_hits']} prefix-splice admissions")
    out["engine"] = (st, n)
    st, n = timed("seq2seq", lambda: run_seq2seq(args, rng, device),
                  device)
    print(f"seq2seq engine: {n} tokens over {st['finished']} requests")
    out["seq2seq"] = (st, n)
    print("done", flush=True)
    return out


if __name__ == "__main__":
    main()
