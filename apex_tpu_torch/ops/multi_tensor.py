"""Kernel wrappers for scale, axpby and l2norm over one flat fp32 buffer,
and the l2norm's per-tensor mode, each beside its plain PyTorch version.

Counterpart of ``apex_tpu/ops/pallas_multi_tensor.py``; the kernels are
``csrc/multi_tensor.cu``.  A wrapper given CUDA tensors launches the
kernel (and adds one to its ``launches`` count); given CPU tensors it
runs the plain version; anything else raises.  Scalars may be Python
floats or 0-d fp32 tensors on the buffer's device: the loss scaler hands
over device tensors, so no value comes back to the host.

The found-inf flag is a 0-d fp32 tensor, 1.0 when any checked input
element is inf or nan, else 0.0 (the TPU kernels' (1, 1) flag).

The per-tensor mode takes a :class:`ChunkTable`: where each tensor of the
flat buffer lies, cut into chunks that each belong to one tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build, _launches

__all__ = ["multi_tensor_scale", "multi_tensor_axpby", "multi_tensor_l2norm",
           "multi_tensor_l2norm_per_tensor", "ChunkTable", "as_scalar"]

Scalar = Union[float, torch.Tensor]


def as_scalar(s: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device.  A Python float rounds to
    fp32, as JAX's weak-typed scalars do, and is written by a fill kernel
    (no host-to-device copy, so no sync)."""
    if isinstance(s, torch.Tensor):
        if s.device != like.device:
            raise ValueError(f"scalar on {s.device}, buffer on {like.device}")
        return s.reshape(()).to(torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=like.device)


def _flat_f32(x: torch.Tensor, name: str) -> None:
    _build.require(x, name, torch.float32, x.numel(),
                   align=16 if x.is_cuda else 1)
    if x.dim() != 1:
        raise ValueError(f"{name} must be a flat 1-D buffer, got "
                         f"shape {tuple(x.shape)}")


def _nonfinite(x: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(x)).any().to(torch.float32)


# -- scale -------------------------------------------------------------------

def _scale_plain(x, scale, out):
    found = _nonfinite(x)              # from the input, before out is written
    torch.mul(x, scale, out=out)
    return out, found


def multi_tensor_scale(x: torch.Tensor, scale: Scalar,
                       out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = x * scale`` and the found-inf flag of ``x``.  ``out`` may
    be ``x`` (in place)."""
    _flat_f32(x, "x")
    out = torch.empty_like(x) if out is None else out
    _flat_f32(out, "out")
    if out.numel() != x.numel():
        raise ValueError("out and x differ in length")
    scale = as_scalar(scale, x)
    if not _build.use_kernel(x, out, scale):
        return _scale_plain(x, scale, out)
    flag = torch.zeros((), dtype=torch.float32, device=x.device)
    n = x.numel()
    if n:
        lib = _build.library("multi_tensor")
        _build.check(lib.apex_scale(x.data_ptr(), out.data_ptr(), n,
                                    scale.data_ptr(), flag.data_ptr(),
                                    _build.grid_blocks(n),
                                    _build.stream_ptr(x)), "apex_scale")
        _launches.count(multi_tensor_scale)
    return out, flag


multi_tensor_scale.launches = 0


# -- axpby -------------------------------------------------------------------

def _axpby_plain(a, b, x, y, arg_to_check, out):
    if arg_to_check == 0:
        found = _nonfinite(x)
    elif arg_to_check == 1:
        found = _nonfinite(y)
    else:
        found = torch.maximum(_nonfinite(x), _nonfinite(y))
    torch.add(a * x, b * y, out=out)
    return out, found


def multi_tensor_axpby(a: Scalar, b: Scalar, x: torch.Tensor,
                       y: torch.Tensor, arg_to_check: int = -1,
                       out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = a*x + b*y`` with the finite check on x (0), y (1) or both
    (-1).  ``out`` may be ``x`` or ``y``."""
    if arg_to_check not in (0, 1, -1):
        raise ValueError(f"arg_to_check must be 0, 1 or -1, got "
                         f"{arg_to_check!r}")
    _flat_f32(x, "x")
    _flat_f32(y, "y")
    out = torch.empty_like(x) if out is None else out
    _flat_f32(out, "out")
    if not x.numel() == y.numel() == out.numel():
        raise ValueError("x, y and out differ in length")
    a, b = as_scalar(a, x), as_scalar(b, x)
    if not _build.use_kernel(x, y, out, a, b):
        return _axpby_plain(a, b, x, y, arg_to_check, out)
    flag = torch.zeros((), dtype=torch.float32, device=x.device)
    n = x.numel()
    if n:
        lib = _build.library("multi_tensor")
        _build.check(lib.apex_axpby(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, a.data_ptr(),
                                    b.data_ptr(), int(arg_to_check),
                                    flag.data_ptr(), _build.stream_ptr(x)),
                     "apex_axpby")
        _launches.count(multi_tensor_axpby)
    return out, flag


multi_tensor_axpby.launches = 0


# -- l2norm ------------------------------------------------------------------

def _l2norm_plain(x):
    return torch.sqrt(torch.sum(x * x))


def multi_tensor_l2norm(x: torch.Tensor) -> torch.Tensor:
    """fp32 global L2 norm of the flat buffer, as a 0-d tensor.  On the
    card the sum runs in a fixed order (per-block partials, then one
    block), so the result is the same on every run."""
    _flat_f32(x, "x")
    if not _build.use_kernel(x):
        return _l2norm_plain(x)
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    n = x.numel()
    if n:
        blocks = _build.grid_blocks(n)
        partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
        lib = _build.library("multi_tensor")
        _build.check(lib.apex_l2norm(x.data_ptr(), n, partials.data_ptr(),
                                     blocks, out.data_ptr(),
                                     _build.stream_ptr(x)), "apex_l2norm")
        _launches.count(multi_tensor_l2norm)
    return out


multi_tensor_l2norm.launches = 0


# -- l2norm per tensor ---------------------------------------------------------

class ChunkTable(NamedTuple):
    """The tensors of a flat buffer, for the per-tensor kernels.

    ``spans``: (offset, length) of each tensor, host ints.  ``chunks``:
    int64 (K, 3) rows (tensor id, start, length <= ``chunk``), each span
    cut from its start into chunks, in order (the reference Apex's
    multi_tensor_apply chunk list).  ``bounds``: int64 (num_tensors + 1),
    the first chunk of each tensor.  ``chunks`` and ``bounds`` lie on the
    buffer's device; ``multi_tensor_apply.ChunkedFlatLayout.chunk_table``
    builds them once per layout and device."""
    spans: Tuple[Tuple[int, int], ...]
    chunk: int
    chunks: torch.Tensor
    bounds: torch.Tensor

    @staticmethod
    def build(spans: Sequence[Tuple[int, int]], chunk: int,
              device) -> "ChunkTable":
        rows, bounds = [], [0]
        for tid, (off, n) in enumerate(spans):
            rows += [(tid, off + s, min(chunk, n - s))
                     for s in range(0, n, chunk)]
            bounds.append(len(rows))
        chunks = torch.tensor(rows, dtype=torch.int64).reshape(-1, 3)
        return ChunkTable(tuple((int(o), int(n)) for o, n in spans),
                          int(chunk), chunks.to(device),
                          torch.tensor(bounds, dtype=torch.int64).to(device))

    @property
    def num_tensors(self) -> int:
        return len(self.spans)

    def check(self, x: torch.Tensor) -> None:
        """The table fits ``x`` and lies on its device."""
        end = max((o + n for o, n in self.spans), default=0)
        if end > x.numel():
            raise ValueError(f"the chunk table covers {end} elements, the "
                             f"buffer has {x.numel()}")
        for name, t in (("chunks", self.chunks), ("bounds", self.bounds)):
            if t.dtype != torch.int64 or not t.is_contiguous():
                raise TypeError(f"chunk table {name} must be contiguous "
                                f"int64")
            if t.device != x.device:
                raise ValueError(f"chunk table on {t.device}, buffer on "
                                 f"{x.device}")


def _l2norm_per_tensor_plain(x, table):
    # the kernel's two stages: each chunk's sum of squares, then each
    # tensor's chunks summed
    c = table.chunk
    sums = [F.pad(x[o:o + n], (0, -n % c)).view(-1, c).square().sum(dim=1)
            .sum() for o, n in table.spans]
    return (torch.stack(sums) if sums
            else torch.zeros(0, dtype=torch.float32, device=x.device))


def multi_tensor_l2norm_per_tensor(x: torch.Tensor,
                                   table: ChunkTable) -> torch.Tensor:
    """fp32 sum of squares of each tensor of the flat buffer ``x``, as a
    (num_tensors,) tensor (the squared per-tensor norms).  On the card the
    sums run in a fixed order: the same result on every run."""
    _flat_f32(x, "x")
    table.check(x)
    if not _build.use_kernel(x, table.chunks, table.bounds):
        return _l2norm_per_tensor_plain(x, table)
    out = torch.zeros(table.num_tensors, dtype=torch.float32,
                      device=x.device)
    nchunks = table.chunks.shape[0]
    if nchunks:
        partials = torch.empty(nchunks, dtype=torch.float32, device=x.device)
        lib = _build.library("multi_tensor")
        _build.check(lib.apex_l2norm_per_tensor(
            x.data_ptr(), table.chunks.data_ptr(), nchunks,
            table.bounds.data_ptr(), table.num_tensors, partials.data_ptr(),
            out.data_ptr(), _build.stream_ptr(x)), "apex_l2norm_per_tensor")
        _launches.count(multi_tensor_l2norm_per_tensor)
    return out


multi_tensor_l2norm_per_tensor.launches = 0
