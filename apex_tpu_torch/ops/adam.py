"""Kernel wrapper for the fused Adam step, beside its plain PyTorch version.

Counterpart of ``apex_tpu/ops/pallas_adam.py``; the kernel is
``csrc/adam.cu``.  It updates the flat fp32 buffers p, m and v in place
(the TPU kernel's ``input_output_aliases``) and, when ``half`` is given,
writes the bf16/fp16 copy of the new p into it in the same pass.

``step_size`` and ``inv_scale`` are 0-d fp32 tensors on the buffers'
device, and ``noop`` (optional) is the loss scaler's found-inf flag: when
it is non-zero nothing is written.  The whole step therefore stays on the
device, with no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["fused_adam"]

_HALF_KIND = {torch.bfloat16: 1, torch.float16: 2}


def _adam_plain(p, m, v, g, step_size, inv_scale, beta1, beta2, eps,
                eps_inside_sqrt, weight_decay, half, noop):
    # op for op the kernel's arithmetic (pallas_adam.py:30-48)
    gs = g * inv_scale
    new_m = beta1 * m + (1.0 - beta1) * gs
    new_v = beta2 * v + (1.0 - beta2) * gs * gs
    if eps_inside_sqrt:
        denom = torch.sqrt(new_v + eps)
    else:
        denom = torch.sqrt(new_v) + eps
    update = new_m / denom + weight_decay * p
    new_p = p - step_size * update
    new_half = None if half is None else new_p.to(half.dtype)
    if noop is not None:
        keep = noop != 0
        new_p = torch.where(keep, p, new_p)
        new_m = torch.where(keep, m, new_m)
        new_v = torch.where(keep, v, new_v)
        if half is not None:
            new_half = torch.where(keep, half, new_half)
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)
    if half is not None:
        half.copy_(new_half)


def fused_adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, step_size: torch.Tensor,
               inv_scale: torch.Tensor, beta1: float, beta2: float,
               eps: float, eps_inside_sqrt: bool, weight_decay: float,
               half: Optional[torch.Tensor] = None,
               noop: Optional[torch.Tensor] = None) -> None:
    """One in-place Adam step on flat fp32 buffers (see module doc)."""
    n = p.numel()
    on_card = p.is_cuda
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        _build.require(t, name, torch.float32, n, align=16 if on_card else 1)
    for name, t in (("step_size", step_size), ("inv_scale", inv_scale)) + (
            (("noop", noop),) if noop is not None else ()):
        _build.require(t, name, torch.float32, 1, align=1)
    if half is not None:
        if half.dtype not in _HALF_KIND:
            raise TypeError(f"half must be bfloat16 or float16, got "
                            f"{half.dtype}")
        _build.require(half, "half", half.dtype, n, align=8 if on_card else 1)
    extra = [t for t in (half, noop) if t is not None]
    if not _build.use_kernel(p, m, v, g, step_size, inv_scale, *extra):
        _adam_plain(p, m, v, g, step_size, inv_scale, beta1, beta2, eps,
                    eps_inside_sqrt, weight_decay, half, noop)
        return
    if n == 0:
        return
    lib = _build.library("adam")
    beta1, beta2 = float(beta1), float(beta2)
    err = lib.apex_adam(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
        None if half is None else half.data_ptr(),
        0 if half is None else _HALF_KIND[half.dtype], n,
        step_size.data_ptr(), inv_scale.data_ptr(),
        None if noop is None else noop.data_ptr(),
        # (1 - beta) is formed in double and rounded once to fp32, as a
        # Python float meets an fp32 tensor in the plain version and in
        # JAX's weak typing
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, float(eps),
        int(bool(eps_inside_sqrt)), float(weight_decay),
        _build.grid_blocks(n), _build.stream_ptr(p))
    _build.check(err, "apex_adam")
    fused_adam.launches += 1


fused_adam.launches = 0
