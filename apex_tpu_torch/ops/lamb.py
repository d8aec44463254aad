"""Kernel wrappers for LAMB's two stages, each beside its plain PyTorch
version.

Counterpart of ``apex_tpu/ops/pallas_lamb.py``; the kernels are
``csrc/lamb.cu``.  Stage 1 updates the flat fp32 moments m and v in place
(the TPU kernel's ``input_output_aliases``) and returns the update tensor;
stage 2 applies each tensor's trust ratio, ``p -= lr * ratio * update``, in
place, and writes the bf16/fp16 copy of the new p into ``half`` in the
same pass when it is given (the JAX package casts the new masters to the
model dtype after the step, round to nearest).  Stage 2 finds each
element's tensor through a :class:`~.multi_tensor.ChunkTable`, where the
TPU kernel reads a per-element expansion of the ratios.

``inv_clip``, ``inv_bc1``, ``inv_bc2`` and ``lr`` are 0-d fp32 tensors on
the buffers' device (a Python float is written there by a fill kernel),
and ``noop`` (optional) is the loss scaler's found-inf flag: when it is
non-zero neither stage writes anything.  A step therefore stays on the
device, with no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, _launches
from .multi_tensor import ChunkTable, as_scalar

__all__ = ["lamb_stage1", "lamb_stage2"]

_HALF_KIND = {torch.bfloat16: 1, torch.float16: 2}


def _f32_buffers(n: int, **bufs) -> None:
    for name, t in bufs.items():
        _build.require(t, name, torch.float32, n,
                       align=16 if t.is_cuda else 1)


def _flag(noop: Optional[torch.Tensor]) -> list:
    if noop is None:
        return []
    _build.require(noop, "noop", torch.float32, 1, align=1)
    return [noop]


def _stage1_plain(g, p, m, v, upd, inv_clip, inv_bc1, inv_bc2, beta1, beta2,
                  beta3, eps, weight_decay, adam_w_mode, noop):
    # op for op the kernel's arithmetic (pallas_lamb.py:33-46)
    gs = g * inv_clip
    if not adam_w_mode and weight_decay:
        gs = gs + weight_decay * p
    new_m = beta1 * m + beta3 * gs
    new_v = beta2 * v + (1.0 - beta2) * gs * gs
    u = (new_m * inv_bc1) / (torch.sqrt(new_v * inv_bc2) + eps)
    if adam_w_mode and weight_decay:
        u = u + weight_decay * p
    if noop is not None:
        keep = noop != 0
        new_m = torch.where(keep, m, new_m)
        new_v = torch.where(keep, v, new_v)
        u = torch.where(keep, upd, u)
    m.copy_(new_m)
    v.copy_(new_v)
    upd.copy_(u)
    return upd


@_launches.priced(writes=("m", "v", "out"))
def lamb_stage1(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, inv_clip, inv_bc1, inv_bc2, beta1: float,
                beta2: float, beta3: float, eps: float, weight_decay: float,
                adam_w_mode: bool, noop: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LAMB stage 1 on flat fp32 buffers: m and v in place, the update
    returned (written into ``out`` when given)."""
    n = p.numel()
    upd = torch.empty_like(p) if out is None else out
    _f32_buffers(n, g=g, p=p, m=m, v=v, out=upd)
    inv_clip, inv_bc1, inv_bc2 = (as_scalar(s, p)
                                  for s in (inv_clip, inv_bc1, inv_bc2))
    flag = _flag(noop)
    if not _build.use_kernel(g, p, m, v, upd, inv_clip, inv_bc1, inv_bc2,
                             *flag):
        return _stage1_plain(g, p, m, v, upd, inv_clip, inv_bc1, inv_bc2,
                             beta1, beta2, beta3, eps, weight_decay,
                             adam_w_mode, noop)
    if n == 0:
        return upd
    lib = _build.library("lamb")
    beta2 = float(beta2)
    # (1 - beta2) is formed in double and rounded once to fp32, as a Python
    # float meets an fp32 tensor in the plain version and in JAX
    err = lib.apex_lamb_stage1(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        upd.data_ptr(), n, inv_clip.data_ptr(), inv_bc1.data_ptr(),
        inv_bc2.data_ptr(), None if noop is None else noop.data_ptr(),
        float(beta1), beta2, float(beta3), 1.0 - beta2, float(eps),
        float(weight_decay), int(bool(adam_w_mode)), _build.grid_blocks(n),
        _build.stream_ptr(p))
    _build.check(err, "apex_lamb_stage1")
    _launches.count(lamb_stage1)
    return upd


lamb_stage1.launches = 0


def _stage2_plain(p, upd, ratio, table, lr, half, noop):
    # p - (lr * ratio) * u over each tensor's span (pallas_lamb.py:86)
    new_p = p.clone()
    for i, (o, n) in enumerate(table.spans):
        new_p[o:o + n] = p[o:o + n] - (lr * ratio[i]) * upd[o:o + n]
    new_half = None if half is None else new_p.to(half.dtype)
    if noop is not None:
        keep = noop != 0
        new_p = torch.where(keep, p, new_p)
        if half is not None:
            new_half = torch.where(keep, half, new_half)
    p.copy_(new_p)
    if half is not None:
        half.copy_(new_half)


@_launches.priced(writes=("p", "half"))
def lamb_stage2(p: torch.Tensor, upd: torch.Tensor, ratio: torch.Tensor,
                table: ChunkTable, lr, half: Optional[torch.Tensor] = None,
                noop: Optional[torch.Tensor] = None) -> None:
    """LAMB stage 2: ``p -= lr * ratio[tensor] * upd`` in place, ``ratio``
    one fp32 trust ratio per tensor of ``table``; the half copy of the new
    p into ``half`` when given."""
    n = p.numel()
    on_card = p.is_cuda
    _f32_buffers(n, p=p, upd=upd)
    _build.require(ratio, "ratio", torch.float32, table.num_tensors,
                   align=1)
    table.check(p)
    lr = as_scalar(lr, p)
    extra = _flag(noop)
    if half is not None:
        if half.dtype not in _HALF_KIND:
            raise TypeError(f"half must be bfloat16 or float16, got "
                            f"{half.dtype}")
        _build.require(half, "half", half.dtype, n, align=8 if on_card else 1)
        extra.append(half)
    if not _build.use_kernel(p, upd, ratio, table.chunks, lr, *extra):
        _stage2_plain(p, upd, ratio, table, lr, half, noop)
        return
    nchunks = table.chunks.shape[0]
    if nchunks == 0:
        return
    lib = _build.library("lamb")
    err = lib.apex_lamb_stage2(
        p.data_ptr(), upd.data_ptr(), ratio.data_ptr(),
        table.chunks.data_ptr(), nchunks, lr.data_ptr(),
        None if half is None else half.data_ptr(),
        0 if half is None else _HALF_KIND[half.dtype],
        None if noop is None else noop.data_ptr(), _build.stream_ptr(p))
    _build.check(err, "apex_lamb_stage2")
    _launches.count(lamb_stage2)


lamb_stage2.launches = 0
