"""Kernel wrappers for LayerNorm over the rows of an (n1, n2) view, forward
and backward, each beside its plain PyTorch version.

Counterpart of ``apex_tpu/ops/pallas_layer_norm.py``; the kernels are
``csrc/layer_norm.cu``.  The contract is the JAX package's:

- ``layer_norm_fwd(x2, w, b, eps) -> (y, mean, inv)``: per row the mean,
  the shifted two-pass variance ``sum((x - mean)^2) / n2``, ``inv =
  rsqrt(var + eps)`` and ``y = ((x - mean) * inv) * w + b`` in fp32, y in
  x's dtype; mean and inv (n1,) fp32 even for half inputs.
- ``layer_norm_bwd(dy, x2, w, mean, inv) -> (dx, dw, db)``: ``dx = inv *
  ((g - mean(g)) - xhat * mean(g * xhat))`` with ``g = dy * w``, dx in x's
  dtype; ``dw = sum_rows(dy * xhat)`` and ``db = sum_rows(dy)`` in fp32.

``w`` and ``b`` are optional (ones and zeros, as the JAX wrapper pads
them).  x2 and dy are contiguous fp32, bf16 or fp16.  A wrapper given
CUDA tensors launches its kernel and adds one to its ``launches`` count;
given CPU tensors it runs the plain version; anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, _launches

__all__ = ["layer_norm_fwd", "layer_norm_bwd"]

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_WARPS = 8             # warps a block of the streamed backward (kWarps)
_REG_COLS = 1024       # widest row a warp holds (kMaxRegCols)
_WIDE_COLS = 8192      # widest row the forward holds (kMaxWideCols)
_WIDE_WARPS = 8        # warps that share a row above 1024 (kWideThreads/32)
_FWD_WARPS = 8         # warps a block of the forward, most (kFwdMaxWarps)
_FWD_GROUPS = 2048     # warps (rows in flight) the forward aims for
_FWD_BLOCKS = 264      # blocks the forward aims for: two on each of 132 SMs
_STREAM_BLOCKS = 256   # blocks of the streamed backward (n2 > 1024), most
_BWD_WARPS = 8         # warps a block of the backward at n2 <= 1024, most
_BWD_BLOCKS = 128      # the backward's blocks, hence partial rows, at most
_INT_MAX = 2 ** 31 - 1


def _rows(x2: torch.Tensor, name: str) -> None:
    if x2.dim() != 2:
        raise ValueError(f"{name} must be (n1, n2), got {tuple(x2.shape)}")
    if x2.dtype not in _KIND:
        raise TypeError(f"{name} must be float32, bfloat16 or float16, got "
                        f"{x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x2.numel() > _INT_MAX:
        raise ValueError(f"{name} has {x2.numel()} elements, more than the "
                         f"kernel's int index")


def _vec(v: Optional[torch.Tensor], n2: int, fill: float,
         like: torch.Tensor, name: str) -> torch.Tensor:
    if v is None:
        return torch.full((n2,), fill, dtype=torch.float32, device=like.device)
    _build.require(v, name, torch.float32, n2, align=1)
    return v


# -- forward -----------------------------------------------------------------

def _fwd_plain(x2, w, b, eps):
    x = x2.float()
    n2 = x.shape[1]
    mean = x.sum(dim=1, keepdim=True) / n2
    d = x - mean
    var = (d * d).sum(dim=1, keepdim=True) / n2
    inv = torch.rsqrt(var + eps)
    y = ((x - mean) * inv) * w + b
    return y.to(x2.dtype), mean[:, 0], inv[:, 0]


class FwdPlan(NamedTuple):
    """How the forward covers an (n1, n2) problem.  ``path``: "vector"
    (16-byte loads and stores), "element" (the same columns a thread, one
    element a load) or "stream" (n2 > 8192); ``blocks`` of ``warps``
    warps; ``row_warps`` warps share a row (1, or the block's 8 for 1024 <
    n2 <= 8192), and each group of them takes ``rows_per_group``
    consecutive rows."""
    path: str
    warps: int
    row_warps: int
    rows_per_group: int
    blocks: int


def _fwd_plan(n1: int, n2: int, itemsize: int, aligned: bool) -> FwdPlan:
    """The forward's path and grid.  The vector path needs rows of whole
    16-byte chunks (n2 * itemsize % 16 == 0), n2 <= 8192 and ``aligned``
    operands (x, w, b and y on 16-byte addresses); the element path sums
    in the same order, so the path changes no bit.  The grid depends on
    (n1, n2) alone: about ``_FWD_GROUPS`` warps with a row each, more rows
    a warp above that (the next one in flight), in blocks of up to 8
    warps, fewer where that leaves fewer than ``_FWD_BLOCKS`` blocks."""
    if n2 > _WIDE_COLS:
        return FwdPlan("stream", _WARPS, 1, 1, -(-n1 // _WARPS))
    path = ("vector" if aligned and n2 * itemsize % 16 == 0
            else "element")
    if n2 > _REG_COLS:
        # a block a row: as many blocks as two an SM hold
        rows = max(1, -(-n1 // _FWD_BLOCKS))
        return FwdPlan(path, _WIDE_WARPS, _WIDE_WARPS, rows, -(-n1 // rows))
    rows = max(1, -(-n1 // _FWD_GROUPS))
    groups = -(-n1 // rows)
    warps = _FWD_WARPS
    while warps > 1 and -(-groups // warps) < _FWD_BLOCKS:
        warps //= 2
    return FwdPlan(path, warps, 1, rows, -(-groups // warps))


@_launches.priced()
def layer_norm_fwd(x2: torch.Tensor, w: Optional[torch.Tensor],
                   b: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, inv)`` of the rows of ``x2`` (see module doc)."""
    _rows(x2, "x2")
    n1, n2 = x2.shape
    w = _vec(w, n2, 1.0, x2, "w")
    b = _vec(b, n2, 0.0, x2, "b")
    if not _build.use_kernel(x2, w, b):
        return _fwd_plain(x2, w, b, eps)
    y = torch.empty_like(x2)
    mean = torch.empty(n1, dtype=torch.float32, device=x2.device)
    inv = torch.empty(n1, dtype=torch.float32, device=x2.device)
    if n1 and n2:
        plan = _fwd_plan(n1, n2, x2.element_size(), _aligned(x2, w, b, y))
        _launch_fwd(x2, w, b, eps, y, mean, inv, plan)
        _launches.count(layer_norm_fwd)
    return y, mean, inv


layer_norm_fwd.launches = 0


def _launch_fwd(x2, w, b, eps, y, mean, inv, plan: FwdPlan) -> None:
    """The forward's kernel for ``plan``, into y, mean and inv."""
    n1, n2 = x2.shape
    lib = _build.library("layer_norm")
    _build.check(lib.apex_ln_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), n1, n2, float(eps),
        int(plan.path == "vector"), plan.warps, plan.rows_per_group,
        plan.blocks, _KIND[x2.dtype], _build.stream_ptr(x2)), "apex_ln_fwd")


def fwd_kernel_info(dtype: torch.dtype, n2: int, plan: FwdPlan) -> dict:
    """Resources of the kernel that ``plan`` launches for ``dtype`` and
    ``n2`` (see :func:`bwd_kernel_info`).  Builds the library; needs a
    GPU."""
    return _kernel_info("apex_ln_fwd_kernel_info", dtype, n2,
                        plan.path == "vector", plan.warps)


# -- backward ----------------------------------------------------------------

def _bwd_plain(dy, x2, w, mean, inv):
    n2 = x2.shape[1]
    d = dy.float()
    xhat = (x2.float() - mean[:, None]) * inv[:, None]
    g = d * w
    c1 = g.sum(dim=1, keepdim=True) / n2
    c2 = (g * xhat).sum(dim=1, keepdim=True) / n2
    dx = inv[:, None] * ((g - c1) - xhat * c2)
    return dx.to(x2.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


class BwdPlan(NamedTuple):
    """How the backward covers an (n1, n2) problem.  ``path``: "vector"
    (16-byte loads), "element" or "stream" (n2 > 1024); ``blocks`` of
    ``warps`` warps, each warp over ``rows_per_warp`` consecutive rows (a
    grid stride on the stream path); ``parts`` partial rows of dw and db
    (one a block at n2 <= 1024, one a warp above), ``scratch`` fp32
    elements for them."""
    path: str
    warps: int
    rows_per_warp: int
    blocks: int
    parts: int
    scratch: int


def _bwd_plan(n1: int, n2: int, itemsize: int, aligned: bool) -> BwdPlan:
    """The backward's path and grid.  The vector path needs rows of whole
    16-byte chunks (n2 * itemsize % 16 == 0) and ``aligned`` operands (dy,
    x, w and dx on 16-byte addresses).  The grid, and so the number of
    partial rows and the order of every sum of dw and db, depends on
    (n1, n2) alone: not on the dtype, the alignment or the card."""
    if n2 > _REG_COLS:
        blocks = min(-(-n1 // _WARPS), _STREAM_BLOCKS)
        parts = blocks * _WARPS
        return BwdPlan("stream", _WARPS, 1, blocks, parts, 2 * parts * n2)
    # at most 128 blocks, each warp two rows or more where it can (so the
    # ring has the next row in flight), up to 8 warps a block
    rows_per_block = -(-n1 // _BWD_BLOCKS)
    warps = min(_BWD_WARPS, max(1, rows_per_block // 2))
    rows_per_warp = -(-rows_per_block // warps)
    blocks = -(-n1 // (warps * rows_per_warp))
    vector = aligned and n2 * itemsize % 16 == 0
    return BwdPlan("vector" if vector else "element", warps, rows_per_warp,
                   blocks, blocks, 2 * blocks * n2)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@_launches.priced()
def layer_norm_bwd(dy: torch.Tensor, x2: torch.Tensor,
                   w: Optional[torch.Tensor], mean: torch.Tensor,
                   inv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)``: dx like x2, dw and db (n2,) fp32 (module doc)."""
    _rows(x2, "x2")
    n1, n2 = x2.shape
    if dy.shape != x2.shape or dy.dtype != x2.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous with x2's shape and dtype, "
                         f"got {tuple(dy.shape)} {dy.dtype} against "
                         f"{tuple(x2.shape)} {x2.dtype}")
    w = _vec(w, n2, 1.0, x2, "w")
    _build.require(mean, "mean", torch.float32, n1, align=1)
    _build.require(inv, "inv", torch.float32, n1, align=1)
    if not _build.use_kernel(dy, x2, w, mean, inv):
        return _bwd_plain(dy, x2, w, mean, inv)
    dx = torch.empty_like(dy)
    if not (n1 and n2):
        f32 = dict(dtype=torch.float32, device=x2.device)
        return dx, torch.zeros(n2, **f32), torch.zeros(n2, **f32)
    plan = _bwd_plan(n1, n2, x2.element_size(), _aligned(dy, x2, w, dx))
    dw, db = _launch_bwd(dy, x2, w, mean, inv, dx, plan)
    _launches.count(layer_norm_bwd)
    return dx, dw, db


layer_norm_bwd.launches = 0


def _launch_bwd(dy, x2, w, mean, inv, dx, plan: BwdPlan):
    """The backward's kernels for ``plan``; returns (dw, db)."""
    n1, n2 = x2.shape
    f32 = dict(dtype=torch.float32, device=x2.device)
    part = torch.empty(plan.scratch, **f32)
    grads = torch.empty((2, n2), **f32)
    lib = _build.library("layer_norm")
    _build.check(lib.apex_ln_bwd(
        dy.data_ptr(), x2.data_ptr(), w.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), dx.data_ptr(), part.data_ptr(), grads[0].data_ptr(),
        grads[1].data_ptr(), n1, n2, int(plan.path == "vector"), plan.warps,
        plan.rows_per_warp, plan.blocks, _KIND[x2.dtype],
        _build.stream_ptr(x2)), "apex_ln_bwd")
    return grads[0], grads[1]


def bwd_kernel_info(dtype: torch.dtype, n2: int, plan: BwdPlan) -> dict:
    """Resources of the row kernel that ``plan`` launches for ``dtype`` and
    ``n2``, from the CUDA runtime: resident blocks per SM, threads a block,
    dynamic shared bytes, registers and local (spill) bytes a thread.
    Builds the library; needs a GPU."""
    return _kernel_info("apex_ln_bwd_kernel_info", dtype, n2,
                        plan.path == "vector", plan.warps)


def _kernel_info(entry: str, dtype: torch.dtype, n2: int, vector: bool,
                 warps: int) -> dict:
    lib = _build.library("layer_norm")
    out = (ctypes.c_int * 5)()
    _build.check(getattr(lib, entry)(_KIND[dtype], n2, int(vector), warps,
                                     out), entry)
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "registers",
                     "local_bytes"), out))
