"""LoRA: low-rank adaptation as parameter arithmetic.

Counterpart of ``apex_tpu/lora.py``.  Adapters are a flat mapping keyed by
the target weight's path, the JAX tree path with ``/`` between parts
(``layers/0/self_attn/q_proj/weight``), so ``utils.jax_interop`` carries
them across unchanged; ``merge`` gives ordinary weights ``W + s * B @ A``
that drop into any model call, and the model never learns LoRA exists.
Hu et al.'s init: A ~ N(0, 1/rank), drawn from an explicit generator, and
B = 0, so the merged weights equal the base at step 0.

The mapping is a ``torch.nn.ModuleDict`` (its entries small modules with
parameters ``a`` (rank, in) and ``b`` (out, rank), named ``<path>.a`` and
``<path>.b``), so ``amp.initialize``, ``FusedAdam`` and
``parallel.make_step`` take it as they take a model.
Fine-tuning trains the adapters alone: the loss runs the frozen model on
merged weights through ``torch.func.functional_call``, which writes no
base parameter, so autograd reaches only the adapters::

    adapters = lora.init(model, targets=("q_proj", "v_proj"), rank=8,
                         generator=torch.Generator().manual_seed(0))
    s = lora.scale(alpha=16.0, rank=8)
    base = {n: p.detach() for n, p in model.named_parameters()}
    def loss_fn():
        merged = lora.merge(base, adapters, s)
        return torch.func.functional_call(model, merged, (ids,))
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["init", "merge", "scale", "num_params"]


class _Adapter(torch.nn.Module):
    """One target's ``a`` (rank, in) and ``b`` (out, rank); ``["a"]``
    indexes as the JAX package's dict does."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = torch.nn.Parameter(a)
        self.b = torch.nn.Parameter(b)

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in ("a", "b"):
            raise KeyError(key)
        return getattr(self, key)


def scale(alpha: float = 16.0, rank: int = 8) -> float:
    """The merge scale alpha / rank (a Python float: nothing for an
    optimizer to update)."""
    return float(alpha) / float(rank)


def _path(name: str) -> str:
    return name.replace(".", "/")


def init(model, targets: Sequence[str], rank: int = 8,
         generator: Optional[torch.Generator] = None
         ) -> torch.nn.ModuleDict:
    """Adapters for every 2-D parameter of ``model`` (a module, or a
    mapping of parameter names to tensors) whose path contains one of
    ``targets`` (``("q_proj", "v_proj")`` for Llama's attention,
    ``("qkv",)`` for GPT's), on the parameter's device, fp32.  ``a`` is
    drawn on the CPU from ``generator`` (default: seeded 0)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    named = (model.named_parameters() if isinstance(model, torch.nn.Module)
             else model.items())
    adapters = torch.nn.ModuleDict()
    for name, leaf in named:
        path = _path(name)
        if leaf.dim() != 2 or not any(t in path for t in targets):
            continue
        out_f, in_f = leaf.shape
        a = torch.randn((rank, in_f), generator=generator) / float(rank) ** 0.5
        adapters[path] = _Adapter(
            a.to(leaf.device),
            torch.zeros((out_f, rank), dtype=torch.float32,
                        device=leaf.device))
    if not len(adapters):
        raise ValueError(f"no 2-D weights matched targets {targets!r}")
    return adapters


def merge(params: Mapping[str, torch.Tensor], adapters,
          merge_scale: float = 2.0) -> Dict[str, torch.Tensor]:
    """A new mapping of ``params`` (parameter names to tensors, as
    ``named_parameters`` or ``state_dict`` give them) with ``W +
    (merge_scale * (B @ A)).to(W.dtype)`` at every adapted path; the
    other entries are the same tensors, and no tensor of ``params`` is
    written.  The default ``merge_scale`` is ``scale()``'s for alpha 16,
    rank 8."""
    by_path = {_path(n): n for n in params}
    missing = sorted(set(adapters.keys()) - set(by_path))
    if missing:
        raise KeyError(f"adapter paths not found in params: {missing[:4]}")
    out = dict(params)
    for path, ad in adapters.items():
        name = by_path[path]
        w = params[name]
        out[name] = w + (merge_scale * (ad["b"] @ ad["a"])).to(w.dtype)
    return out


def num_params(adapters) -> Tuple[int, int]:
    """(trainable adapter parameters, parameters of the full matrices at
    the adapted sites): the fine-tuning footprint against full
    fine-tuning."""
    small = sum(ad["a"].numel() + ad["b"].numel()
                for ad in adapters.values())
    full = sum(ad["b"].shape[0] * ad["a"].shape[1]
               for ad in adapters.values())
    return small, full
