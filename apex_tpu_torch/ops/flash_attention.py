"""Kernel wrappers for blocked (flash) attention, forward, dQ and dK/dV,
each beside its plain PyTorch version, and the autograd op built on them.

Counterpart of ``apex_tpu/ops/pallas_flash_attention.py``; the kernels are
``csrc/flash_attention.cu``.  ``flash_attention(q, k, v, causal, scale,
kv_mask, dropout_rate, dropout_seed, segment_ids)`` has the JAX function's
signature, checks and numerics:

- scores ``s = (q . k) * scale`` in fp32 from the input dtype;
- the softmax normalizer uses the undropped probabilities, the value sum
  the dropped ones rescaled by ``1/(1 - rate)`` (that factor formed in
  double and rounded to fp32, as JAX rounds the weak-typed Python float);
- P is rounded to V's dtype before P.V, dS to the input dtype before its
  products;
- a query row with no valid key gives zeros;
- the dropout mask is :func:`keep_unit` of the absolute (b*H + h, q, k)
  position and two int32 seed words: the same bits in the forward, both
  backward passes, the plain versions and the JAX package.  A single seed
  word gets the JAX wrapper's derived second word.

Positions past T match nothing, which the JAX wrapper gets by padding the
segment ids with -1 (q) and -2 (k) and the kernels here by checking the
bounds.  The seed words stay on the device: the kernels read them there,
so no wrapper calls ``.item()``.

The wrappers take (BH, T, D) contiguous operands, fp32, bf16 or fp16,
D <= 128 (:func:`fits` says whether a shape is within the kernels'
limits).  For bf16 and fp16 the forward, dQ and dK/dV kernels do their
products on tensor cores; fp32 operands run fp32 FMAs (see the kernel
source's header).  A wrapper given CUDA tensors launches its
kernel and adds one to its ``launches`` count; given CPU tensors it runs
the plain version
(dense (BH, T, T) scores, which at the test sizes equal the JAX kernel's
single block); anything else raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, _launches

__all__ = ["flash_attention", "flash_fwd", "flash_dq", "flash_dkv",
           "fits", "keep_unit"]

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30
_M32 = 0xFFFFFFFF
# the hash's multipliers: the JAX package's int32 constants as uint32
_C = (0x9E3779B9, 0x85EBCA77, 0xC2B2AE3D, 0x85EBCA6B, 0xC2B2AE35)


# -- the dropout hash ---------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32), in two 16-bit halves
    of ``c`` so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def keep_unit(seed0, seed1, bh, qpos, kpos) -> torch.Tensor:
    """``pallas_flash_attention._keep_unit``: a uniform in [0, 1) per
    (bh, qpos, kpos), bit for bit the JAX function's.  Arguments are int
    tensors (or ints) that broadcast; the seed words are int32 values."""
    def u32(x):
        return torch.as_tensor(x).to(torch.int64) & _M32

    s0, s1 = u32(seed0), u32(seed1)
    h = (_mul32(u32(qpos), _C[0]) ^ _mul32(u32(kpos), _C[1])
         ^ _mul32(u32(bh), _C[2]) ^ s0)
    h = h ^ (h >> 16)
    h = _mul32(h, _C[3])
    h = h ^ s1
    h = h ^ (h >> 16)
    h = _mul32(h, _C[4])
    h = h ^ (h >> 16)
    bits = h & 0x7FFFFFFF
    return bits.to(torch.float32) * (1.0 / 2147483648.0)


def _inv_keep(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


# -- checks -------------------------------------------------------------------

def fits(shape) -> bool:
    """Whether (..., T, D) operands of ``shape`` are within the kernels'
    limits, which :func:`_check` enforces: head dim 1 to 128 and every
    index an int.  The attention dispatch sends other shapes to its dense
    route, as the JAX package's does when ``fits_vmem`` fails."""
    D, n = shape[-1], math.prod(shape)
    return 1 <= D <= 128 and n <= 2 ** 31 - 1


def _check(H: int, *ts: torch.Tensor, names=("q", "k", "v", "do")) -> None:
    q = ts[0]
    if q.dim() != 3:
        raise ValueError(f"operands must be (BH, T, D), got {tuple(q.shape)}")
    if q.dtype not in _KIND:
        raise TypeError(f"operands must be float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    for name, t in zip(names, ts):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with q's shape and "
                             f"dtype, got {tuple(t.shape)} {t.dtype}")
    BH, T, D = q.shape
    if not 1 <= D <= 128:
        raise ValueError(f"head dim {D}: the kernels take 1 to 128")
    if H < 1 or BH % H:
        raise ValueError(f"BH = {BH} is not a multiple of H = {H}")
    if q.numel() > 2 ** 31 - 1 or BH * T > 2 ** 31 - 1:
        raise ValueError("operands exceed the kernels' int indices")


def _check_masks(q3, H, kv_mask, segment_ids, seed, rate):
    BH, T, _ = q3.shape
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or kv_mask.shape != (BH // H, T)
                or not kv_mask.is_contiguous()):
            raise ValueError(f"kv_mask must be contiguous bool {(BH // H, T)}")
    if segment_ids is not None:
        if (segment_ids.dtype != torch.int32
                or segment_ids.shape != (BH // H, T)
                or not segment_ids.is_contiguous()):
            raise ValueError(f"segment_ids must be contiguous int32 "
                             f"{(BH // H, T)}")
    if rate:
        if seed is None or seed.dtype != torch.int32 or seed.shape != (2,):
            raise ValueError("dropout needs a (2,) int32 seed tensor")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _present(*ts):
    return [t for t in ts if t is not None]


# -- plain versions -----------------------------------------------------------

def _valid(q3, H, causal, kv_mask, segment_ids):
    BH, T, _ = q3.shape
    dev = q3.device
    valid = torch.ones((1, T, T), dtype=torch.bool, device=dev)
    if causal:
        valid = torch.tril(valid)
    if kv_mask is not None:
        valid = valid & kv_mask.repeat_interleave(H, 0)[:, None, :]
    if segment_ids is not None:
        s = segment_ids.repeat_interleave(H, 0)
        valid = valid & (s[:, :, None] == s[:, None, :])
    return valid.expand(BH, T, T)


def _keep(q3, seed, rate):
    BH, T, _ = q3.shape
    ar = torch.arange(T, device=q3.device)
    u = keep_unit(seed[0], seed[1],
                  torch.arange(BH, device=q3.device)[:, None, None],
                  ar[None, :, None], ar[None, None, :])
    return u >= torch.tensor(rate, dtype=torch.float32)


def _scores(q3, k3, scale):
    return torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale


def _fwd_plain(q3, k3, v3, H, scale, causal, kv_mask, segment_ids, seed,
               rate):
    valid = _valid(q3, H, causal, kv_mask, segment_ids)
    s = torch.where(valid, _scores(q3, k3, scale), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if rate:
        p = torch.where(_keep(q3, seed, rate), p, 0.0) * _inv_keep(rate)
    acc = torch.matmul(p.to(v3.dtype).float(), v3.float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe).to(q3.dtype), (m + torch.log(l_safe))[..., 0]


def _bwd_common(q3, k3, v3, do3, lse, delta, H, scale, causal, kv_mask,
                segment_ids, seed, rate):
    valid = _valid(q3, H, causal, kv_mask, segment_ids)
    p = torch.where(valid, torch.exp(_scores(q3, k3, scale) - lse[..., None]),
                    0.0)
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    p_acc = p
    if rate:
        keep, ik = _keep(q3, seed, rate), _inv_keep(rate)
        p_acc = torch.where(keep, p, 0.0) * ik
        dp = torch.where(keep, dp, 0.0) * ik
    ds = (p * (dp - delta[..., None])).to(q3.dtype).float()
    return p_acc, ds


def _dq_plain(q3, k3, v3, do3, lse, delta, H, scale, causal, kv_mask,
              segment_ids, seed, rate):
    _, ds = _bwd_common(q3, k3, v3, do3, lse, delta, H, scale, causal,
                        kv_mask, segment_ids, seed, rate)
    return (torch.matmul(ds, k3.float()) * scale).to(q3.dtype)


def _dkv_plain(q3, k3, v3, do3, lse, delta, H, scale, causal, kv_mask,
               segment_ids, seed, rate):
    p_acc, ds = _bwd_common(q3, k3, v3, do3, lse, delta, H, scale, causal,
                            kv_mask, segment_ids, seed, rate)
    dv = torch.matmul(p_acc.to(do3.dtype).float().transpose(1, 2),
                      do3.float())
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    return dk.to(k3.dtype), dv.to(v3.dtype)


# -- declared costs (``_launches.priced``) --------------------------------------
# The convention is the JAX package's dense attention path, which it runs
# wherever the flash kernel does not (``transformer/attention.py:136-156``),
# priced by the cost model: the full (T, S) scores whether causal or not
# (no causal half taken off), the forward's two matmuls (4·BH·T·S·D), the
# backward's four (8·BH·T·S·D: dP and dQ to ``flash_dq``, dV and dK to
# ``flash_dkv``), in the dtype of q; the forward's elementwise work (two
# converts, the scale, the softmax: 7s − r for s scores in r rows, s
# exponentials) and the backward's (9s + r, all charged to ``flash_dq``);
# a mask's select (s), a causal mask's construction (T + T·S), segment
# ids' compare (s) and dropout's counter hash and scale (21s forward, 2s
# each backward kernel).  Bytes: the dense path's operands and results,
# operator by operator, as the cost model counts them (about 70 bytes a
# score forward, 98 backward, 18 and 21 more under a mask).

def _scores_shape(q3, k3, H):
    BH, T, D = q3.shape
    S = k3.shape[1]
    return BH, T, S, D, BH * T * S, BH * T


def _masked(causal, kv_mask, segment_ids) -> bool:
    return bool(causal or kv_mask is not None or segment_ids is not None)


def _mask_flops(q3, k3, causal, kv_mask, segment_ids):
    _, T, S, _, s, _ = _scores_shape(q3, k3, 1)
    return (s * _masked(causal, kv_mask, segment_ids)
            + (T + T * S) * bool(causal) + s * (segment_ids is not None))


def _fwd_cost(q3, k3, v3, H, scale, causal=False, kv_mask=None,
              segment_ids=None, seed=None, rate=0.0):
    BH, T, S, D, s, r = _scores_shape(q3, k3, H)
    mm = 4 * BH * T * S * D
    it = q3.element_size()
    return {"flops": mm + 7 * s - r
            + _mask_flops(q3, k3, causal, kv_mask, segment_ids)
            + 21 * s * bool(rate),
            "transcendentals": s, "matmul_flops": mm,
            "matmul_dtype": q3.dtype,
            "bytes": (70 + 18 * _masked(causal, kv_mask, segment_ids)) * s
            + 7 * it * (q3.numel() + k3.numel())}


def _dq_cost(q3, k3, v3, do3, lse, delta, H, scale, causal=False,
             kv_mask=None, segment_ids=None, seed=None, rate=0.0):
    BH, T, S, D, s, r = _scores_shape(q3, k3, H)
    mm = 4 * BH * T * S * D
    it = q3.element_size()
    return {"flops": mm + 9 * s + r
            + s * _masked(causal, kv_mask, segment_ids)
            + 2 * s * bool(rate),
            "transcendentals": 0, "matmul_flops": mm,
            "matmul_dtype": q3.dtype,
            "bytes": (60 + 21 * _masked(causal, kv_mask, segment_ids)) * s
            + 6 * it * (q3.numel() + k3.numel()) + 8 * r}


def _dkv_cost(q3, k3, v3, do3, lse, delta, H, scale, causal=False,
              kv_mask=None, segment_ids=None, seed=None, rate=0.0):
    BH, T, S, D, s, r = _scores_shape(q3, k3, H)
    mm = 4 * BH * T * S * D
    it = q3.element_size()
    return {"flops": mm + 2 * s * bool(rate), "transcendentals": 0,
            "matmul_flops": mm, "matmul_dtype": q3.dtype,
            "bytes": 38 * s + 6 * it * (q3.numel() + k3.numel())}


# -- kernel wrappers ----------------------------------------------------------

@_launches.priced(_fwd_cost)
def flash_fwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, H: int,
              scale: float, causal: bool = False,
              kv_mask: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None,
              seed: Optional[torch.Tensor] = None, rate: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o like q3, lse (BH, T) fp32 (see module doc)."""
    _check(H, q3, k3, v3)
    _check_masks(q3, H, kv_mask, segment_ids, seed, rate)
    args = (H, scale, causal, kv_mask, segment_ids, seed, rate)
    if not _build.use_kernel(*_present(q3, k3, v3, kv_mask, segment_ids,
                                       seed if rate else None)):
        return _fwd_plain(q3, k3, v3, *args)
    BH, T, D = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q3.device)
    if q3.numel():
        lib = _build.library("flash_attention")
        _build.check(lib.apex_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _ptr(kv_mask), _ptr(segment_ids),
            _ptr(seed) if rate else None, BH, H, T, D, int(bool(causal)),
            float(scale), float(rate), _inv_keep(rate), _KIND[q3.dtype],
            _build.stream_ptr(q3)), "apex_flash_fwd")
        _launches.count(flash_fwd)
    return o, lse


flash_fwd.launches = 0


def _bwd_args(q3, k3, v3, do3, lse, delta, H, kv_mask, segment_ids, seed,
              rate):
    _check(H, q3, k3, v3, do3)
    _check_masks(q3, H, kv_mask, segment_ids, seed, rate)
    BH, T, _ = q3.shape
    _build.require(lse, "lse", torch.float32, BH * T, align=4)
    _build.require(delta, "delta", torch.float32, BH * T, align=4)
    return _build.use_kernel(*_present(q3, k3, v3, do3, lse, delta, kv_mask,
                                       segment_ids, seed if rate else None))


@_launches.priced(_dq_cost)
def flash_dq(q3, k3, v3, do3, lse, delta, H: int, scale: float,
             causal: bool = False, kv_mask=None, segment_ids=None, seed=None,
             rate: float = 0.0) -> torch.Tensor:
    """dQ like q3, from P recomputed from ``lse`` and ``delta = sum(dO * O,
    -1)`` (see module doc)."""
    args = (H, scale, causal, kv_mask, segment_ids, seed, rate)
    if not _bwd_args(q3, k3, v3, do3, lse, delta, H, kv_mask, segment_ids,
                     seed, rate):
        return _dq_plain(q3, k3, v3, do3, lse, delta, *args)
    BH, T, D = q3.shape
    dq = torch.empty_like(q3)
    if q3.numel():
        lib = _build.library("flash_attention")
        _build.check(lib.apex_flash_dq(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(kv_mask),
            _ptr(segment_ids), _ptr(seed) if rate else None, BH, H, T, D,
            int(bool(causal)), float(scale), float(rate), _inv_keep(rate),
            _KIND[q3.dtype], _build.stream_ptr(q3)), "apex_flash_dq")
        _launches.count(flash_dq)
    return dq


flash_dq.launches = 0


@_launches.priced(_dkv_cost)
def flash_dkv(q3, k3, v3, do3, lse, delta, H: int, scale: float,
              causal: bool = False, kv_mask=None, segment_ids=None, seed=None,
              rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` like k3 and v3 (see module doc)."""
    args = (H, scale, causal, kv_mask, segment_ids, seed, rate)
    if not _bwd_args(q3, k3, v3, do3, lse, delta, H, kv_mask, segment_ids,
                     seed, rate):
        return _dkv_plain(q3, k3, v3, do3, lse, delta, *args)
    BH, T, D = q3.shape
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    if q3.numel():
        lib = _build.library("flash_attention")
        _build.check(lib.apex_flash_dkv(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(kv_mask), _ptr(segment_ids), _ptr(seed) if rate else None,
            BH, H, T, D, int(bool(causal)), float(scale), float(rate),
            _inv_keep(rate), _KIND[q3.dtype], _build.stream_ptr(q3)),
            "apex_flash_dkv")
        _launches.count(flash_dkv)
    return dk, dv


flash_dkv.launches = 0


def kernel_info(which: str, dtype: torch.dtype, D: int) -> dict:
    """Launch shape and resources of the kernel that ``flash_<which>``
    (``"fwd"``, ``"dq"`` or ``"dkv"``) launches for ``dtype`` and head dim
    ``D``, from the CUDA runtime: resident blocks per SM, threads a block,
    dynamic shared bytes, registers and local (spill) bytes a thread.
    Builds the library; needs a GPU."""
    lib = _build.library("flash_attention")
    out = (ctypes.c_int * 5)()
    _build.check(lib.apex_flash_kernel_info(
        ("fwd", "dq", "dkv").index(which), _KIND[dtype], D, out),
        "apex_flash_kernel_info")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "registers",
                     "local_bytes"), out))


# -- the autograd op and the public function ----------------------------------

class _Flash(torch.autograd.Function):
    """pallas_flash_attention.py:510-537: the forward kernel, then delta =
    sum(dO * O) in torch and the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q3, k3, v3, kv_mask, segment_ids, seed, H, scale,
                causal, rate):
        o, lse = flash_fwd(q3, k3, v3, H, scale, causal, kv_mask,
                           segment_ids, seed, rate)
        ctx.save_for_backward(q3, k3, v3, o, lse, kv_mask, segment_ids, seed)
        ctx.args = (H, scale, causal)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse, kv_mask, segment_ids, seed = ctx.saved_tensors
        H, scale, causal = ctx.args
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        masks = (kv_mask, segment_ids, seed, ctx.rate)
        dq = flash_dq(q3, k3, v3, do, lse, delta, H, scale, causal, *masks)
        dk, dv = flash_dkv(q3, k3, v3, do, lse, delta, H, scale, causal,
                           *masks)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """softmax(q k^T * scale [+ masks]) v without the (T, T) scores in
    device memory.  q, k, v: (B, H, T, D) of one shape.  ``kv_mask``: (B, T)
    key validity (True = attend); ``segment_ids``: (B, T) packed-sequence
    ids; ``dropout_seed``: one or two int32 words (a tensor on q's device,
    or an int).  See the module doc for the numerics."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, T, D), got {tuple(q.shape)}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError("flash_attention requires matching q/k/v shapes")
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    B, H, T, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"kv_mask must be (B, T) = {(B, T)}, got "
                             f"{tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.bool).contiguous()
    seed = None
    if dropout_rate:
        s = torch.as_tensor(dropout_seed, dtype=torch.int32,
                            device=q.device).reshape(-1)
        if s.numel() == 1:
            # the JAX wrapper's derived second word for one-word seeds
            s = torch.stack([s[0], s[0] ^ 0x5555AAAA])
        elif s.numel() != 2:
            raise ValueError(f"dropout_seed must be 1 or 2 int32 words, got "
                             f"{s.numel()}")
        seed = s.contiguous()
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (B, T):
            raise ValueError(f"segment_ids must be (B, T) = {(B, T)}, got "
                             f"{tuple(segment_ids.shape)}")
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()

    def fold(x):
        return x.reshape(B * H, T, D).contiguous()

    out = _Flash.apply(fold(q), fold(k), fold(v), kv_mask, segment_ids, seed,
                       H, float(scale), bool(causal), dropout_rate)
    return out.reshape(B, H, T, D)
