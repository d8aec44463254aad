"""Chunked fused linear + cross-entropy head: the (N, V) logits are never
kept whole.

Counterpart of ``apex_tpu/nn/fused_xent.py``.  The forward streams the
vocabulary in chunks with an online logsumexp (running max, running sum
of exponentials, label logit per row); the backward recomputes each
chunk's logits and contracts them at once into dh and dtable.  Per-row nll
comes back, so callers own masking and averaging.

The logits are fp32 from the operands' dtype, as the JAX package's
``preferred_element_type=float32`` keeps them: a bf16 ``torch.matmul``
would round them to bf16.  On the card a half-precision product asks
cuBLAS for an fp32 result (``out_dtype``); elsewhere, and for fp32
operands, the operands are widened and multiplied in fp32 (exact
products, fp32 sums; TF32 must be off, as ``chip_smoke.py`` sets it).
This is no kernel of the port: the JAX package leaves these matmuls to
XLA.
"""

from __future__ import annotations

import torch

from ..ops import _launches

__all__ = ["linear_cross_entropy"]

_HALF = (torch.bfloat16, torch.float16)


def _dot_f32_cost(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The cost model's count of the JAX package's ``dot_general`` with
    ``preferred_element_type=float32``: a matmul in the operands' dtype
    (the widening on the CPU is this function's own, hidden from the
    count, so the CPU and the card count alike)."""
    M, K = a.shape
    N = b.shape[1]
    return {"prim": "mm", "flops": 2 * M * N * K, "transcendentals": 0,
            "matmul_flops": 2 * M * N * K, "matmul_dtype": a.dtype,
            "bytes": a.element_size() * (M * K + K * N) + 4 * M * N}


@_launches.priced(_dot_f32_cost)
def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result from fp32 sums, whatever the operands'
    dtype."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunks(V: int, chunk: int):
    C = min(chunk, V)
    return [(c0, min(c0 + C, V)) for c0 in range(0, V, C)]


class _LinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, labels, chunk_size):
        N = h.shape[0]
        f32 = dict(dtype=torch.float32, device=h.device)
        m = torch.full((N,), -float("inf"), **f32)
        s = torch.zeros(N, **f32)
        lab = torch.zeros(N, **f32)
        lbl = labels.long()
        for c0, c1 in _chunks(table.shape[0], chunk_size):
            logits = _dot_f32(h, table[c0:c1].t())
            m2 = logits.amax(dim=-1)
            s2 = torch.exp(logits - m2[:, None]).sum(dim=-1)
            hit = lbl[:, None] == torch.arange(c0, c1, device=h.device)
            lab = lab + torch.where(hit, logits, 0.0).sum(dim=-1)
            mn = torch.maximum(m, m2)
            s = s * torch.exp(m - mn) + s2 * torch.exp(m2 - mn)
            m = mn
        lse = torch.log(s) + m
        ctx.save_for_backward(h, table, labels, lse)
        ctx.chunk_size = chunk_size
        return lse - lab

    @staticmethod
    def backward(ctx, ct):
        h, table, labels, lse = ctx.saved_tensors
        ctf = ct.float()
        lbl = labels.long()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dws = []
        for c0, c1 in _chunks(table.shape[0], ctx.chunk_size):
            rows = table[c0:c1]
            p = torch.exp(_dot_f32(h, rows.t()) - lse[:, None])
            hit = lbl[:, None] == torch.arange(c0, c1, device=h.device)
            g = ((p - hit.float()) * ctf[:, None]).to(h.dtype)
            dh = dh + _dot_f32(g, rows)
            dws.append(_dot_f32(g.t(), h))
        dw = torch.cat(dws, dim=0)
        return dh.to(h.dtype), dw.to(table.dtype), None, None


def linear_cross_entropy(h: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor,
                         chunk_size: int = 8192) -> torch.Tensor:
    """Per-row ``-log softmax(h @ table.T)[label]`` without the (N, V)
    logits.  h: (N, D); table: (V, D); labels: (N,) int.  A row whose label
    is out of range returns garbage: mask it outside."""
    return _LinearCrossEntropy.apply(h, table, labels, int(chunk_size))
