"""Analytic cost model: FLOPs, transcendentals and bytes of one call.

Counterpart of ``apex_tpu/observability/costmodel.py``.  The JAX package
walks a traced jaxpr and prices each primitive by the rules of XLA's
``HloCostAnalysis``; the port runs one call of the function under a
``TorchDispatchMode`` (:func:`count_cost`) and prices each aten operator
it dispatches by the same rules:

- ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` as ``dot_general``:
  2·M·N·K (an ``addmm``'s bias add is the ``add`` the JAX dense layer
  writes);
- ``convolution`` and ``convolution_backward`` as
  ``conv_general_dilated``: 2 FMAs per *valid* (output position, kernel
  tap) pair — taps landing in padding are not arithmetic, so a strided
  conv's dgrad and wgrad each cost what its forward costs (the count
  ``torch.utils.flop_counter`` does not make: it bills the full window);
- the elementwise, transcendental, free, reduction and collective sets
  of the JAX ``eqn_flops``; composite aten operators (softmax, layer and
  batch norms, GELU, the losses) at the sum of the primitives the JAX
  package lowers them to;
- anything else at one flop an output element, listed in
  ``Cost.unknown_prims`` so table gaps surface.

**The port's own kernels** are ``ctypes`` launches that no dispatcher
sees.  Each wrapper of ``ops/`` is priced (``ops._launches.priced``):
while a count runs, the call is priced as its plain version — the
wrapper's body run on meta tensors, which takes the plain branch and
computes nothing — as one entry, ``kernel:<wrapper>`` in
``flops_by_prim``, and the call itself runs with its operators hidden
(its plain version on the CPU, its allocations on the card), so a step
counts the same on both devices.  The flash kernels declare the JAX dense
path's count instead (see ``ops/flash_attention.py``), which is not
their plain version's.

Known divergences from the jaxpr count, beside the kernels' declared
elementwise work: the count is of the operators that RAN (no dead-code
elimination: an eager step computes what a jit would drop), and the
bytes are those of the operators the port runs (the JAX package's flat
optimizer reads and writes its buffers through concatenates and slices
that the port's in-place kernels do not have).  The operands and results
of every operator that computes count (views, copies and allocations are
free and move none); a dtype cast is one flop an element, as a
``convert_element_type`` is.  ``matmul_flops`` and
``matmul_flops_by_dtype`` are exact counterparts.

``PEAK_FLOPS`` / :func:`peak_flops` / :func:`mfu` are the JAX package's,
with the card's row.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Cost", "count_cost", "PEAK_FLOPS", "peak_flops", "mfu",
           "conv_flops", "dot_flops", "op_flops"]


# -- peak-FLOPs table ------------------------------------------------------
#
# Peak arithmetic rates by device name (``torch.cuda.get_device_name``,
# substring-matched, case-insensitive) and matmul operand dtype:
#  - h100: NVIDIA H100 SXM data sheet, dense (no sparsity): bf16 and fp16
#    989.4 TFLOP/s, TF32 494.7, fp32 (no tensor cores) 66.9.  The card
#    these are quoted for is the NVIDIA H100 80GB HBM3 at 700 W.
#  - cpu: the JAX package's NOMINAL 100 GFLOP/s smoke constant, so CPU
#    runs produce a comparable mfu column; not a hardware statement.
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "h100": {"bfloat16": 989.4e12, "float16": 989.4e12,
             "tf32": 494.7e12, "float32": 66.9e12},
    "cpu": {"bfloat16": 100e9, "float32": 100e9, "float64": 50e9},
}


def peak_flops(arch: str, dtype: str) -> Optional[float]:
    """Peak FLOP/s for a device name + matmul dtype, or None when the
    table has no entry (unknown hardware must not fabricate an MFU)."""
    a = str(arch).lower()
    for key, rates in PEAK_FLOPS.items():
        if key in a or a in key:
            return rates.get(str(dtype).replace("torch.", ""))
    return None


def mfu(flops_per_step: float, step_seconds: float, arch: str,
        dtype: str) -> Dict[str, Any]:
    """Model-FLOPs-utilization fields for a bench record.

    ``achieved_tflops`` is always computable; ``mfu`` and
    ``peak_tflops`` are None when the peak table has no entry for the
    hardware (absent beats fabricated)."""
    achieved = flops_per_step / max(step_seconds, 1e-12)
    peak = peak_flops(arch, dtype)
    return {
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": (peak / 1e12) if peak else None,
        "mfu": (achieved / peak) if peak else None,
        "mfu_dtype": str(dtype).replace("torch.", ""),
    }


# -- the whole-call accounting ----------------------------------------------

@dataclass
class Cost:
    """Analytic cost of one call (the JAX package's fields)."""
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: int = 0            # operand + result bytes, all ops
    matmul_flops: float = 0.0          # mm/bmm/conv flops only
    flops_by_prim: Dict[str, float] = field(default_factory=dict)
    matmul_flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    bytes_by_dtype: Dict[str, int] = field(default_factory=dict)
    eqns: int = 0
    while_loops: int = 0               # always 0: the call ran
    unknown_prims: Dict[str, int] = field(default_factory=dict)

    @property
    def dominant_matmul_dtype(self) -> Optional[str]:
        """Operand dtype carrying the most matmul flops — the dtype whose
        peak rate an MFU figure should be quoted against."""
        if not self.matmul_flops_by_dtype:
            return None
        return max(self.matmul_flops_by_dtype,
                   key=self.matmul_flops_by_dtype.get)

    def fp32_matmul_fraction(self) -> float:
        """Fraction of matmul flops with fp32 operands."""
        if not self.matmul_flops:
            return 0.0
        return self.matmul_flops_by_dtype.get("float32", 0.0) \
            / self.matmul_flops

    def to_record(self) -> Dict[str, Any]:
        """Flat JSONL payload (enriched + kind-tagged by callers)."""
        rec = {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes_accessed": int(self.bytes_accessed),
            "matmul_flops": self.matmul_flops,
            "matmul_flops_by_dtype": dict(self.matmul_flops_by_dtype),
            "bytes_by_dtype": {k: int(v)
                               for k, v in self.bytes_by_dtype.items()},
            "eqns": int(self.eqns),
        }
        if self.while_loops:
            rec["while_loops"] = int(self.while_loops)
        if self.unknown_prims:
            rec["unknown_prims"] = dict(self.unknown_prims)
        return rec


# -- per-operator rules ------------------------------------------------------

def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _numel(t) -> int:
    return int(t.numel())


def _valid_pairs(n: int, k: int, o: int, s: int, p: int, d: int) -> int:
    """(output position, tap) pairs of one spatial dimension whose input
    position ``oi*s + ki*d - p`` lies in ``[0, n)``."""
    cnt = 0
    for ki in range(k):
        off = ki * d - p
        # oi in [0, o) with 0 <= oi*s + off < n
        lo = max(0, -(-(-off) // s)) if off < 0 else 0
        hi = min(o - 1, (n - 1 - off) // s) if n - 1 - off >= 0 else -1
        if hi >= lo:
            cnt += hi - lo + 1
    return cnt


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation,
               transposed: bool = False, groups: int = 1) -> float:
    """XLA ``HandleConvolution`` parity over an NC... convolution: 2 FMAs
    per valid (output position, kernel tap) pair — the JAX package's
    ``conv_flops``.  A transposed convolution is priced as the forward
    convolution it transposes (its output is that one's input)."""
    if transposed:
        x_shape, out_shape = out_shape, x_shape
        cin, cout = w_shape[0], w_shape[1] * groups
    else:
        cin, cout = x_shape[1], w_shape[0]
    nd = len(x_shape) - 2
    stride = _per_dim(stride, nd)
    padding = _per_dim(padding, nd)
    dilation = _per_dim(dilation, nd)
    valid = 1
    for i in range(nd):
        valid *= _valid_pairs(x_shape[2 + i], w_shape[2 + i],
                              out_shape[2 + i], stride[i], padding[i],
                              dilation[i])
    return 2.0 * x_shape[0] * cout * (cin // groups) * valid


def _per_dim(v, nd):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * nd if len(v) == 1 else v


def dot_flops(out, k: int) -> float:
    """2*M*N*K (batch dims included in the output element count)."""
    return 2.0 * _numel(out) * int(k)


# one flop an output element (the JAX package's _ELEMENTWISE_1, by their
# aten names)
_ELEMENTWISE_1 = frozenset({
    "add", "sub", "mul", "div", "maximum", "minimum", "neg", "abs", "sign",
    "floor", "ceil", "round", "trunc", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "eq", "ne", "lt", "le", "gt", "ge",
    "isfinite", "isinf", "isnan", "where", "reciprocal", "rsub",
    "clamp_min", "clamp_max", "relu", "threshold_backward",
    "masked_fill", "fmod", "remainder", "sgn", "nextafter",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
    "bitwise_left_shift", "bitwise_right_shift", "_to_copy",
    "lerp", "square",
})
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "asinh", "acosh", "atanh", "erf", "erfc", "erfinv", "sqrt", "rsqrt",
    "digamma", "lgamma",
})
_ELEMENTWISE_N = {"clamp": 2, "addcmul": 2, "addcdiv": 2, "hardtanh": 2,
                  "fmod": 8, "remainder": 8}
# pure data movement / addressing / allocation: no arithmetic
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "as_strided",
    "narrow", "split", "split_with_sizes", "unbind", "chunk", "cat",
    "stack", "flip", "roll", "repeat", "index_select", "gather", "take",
    "embedding", "scatter", "index", "index_put", "index_copy",
    "index_fill", "masked_select", "clone", "contiguous", "copy",
    "copy_", "detach", "alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "fill", "zero", "arange", "scalar_tensor",
    "_local_scalar_dense", "item", "constant_pad_nd", "pad",
    "diagonal", "tril", "triu", "unfold", "pin_memory", "_pin_memory",
    "record_stream", "set_", "resize_", "_reshape_alias",
    "split_copy", "view_as_real", "view_as_complex", "unsqueeze_copy",
    "_foreach_copy", "lift", "sort", "topk", "nonzero",
    "random", "manual_seed", "bernoulli", "uniform", "normal", "rand",
    "randn", "randint", "rand_like", "randn_like", "randperm",
    "is_nonzero", "equal", "broadcast_tensors", "_has_compatible_shallow_copy_type",
    "select_backward", "slice_backward", "slice_scatter",
    "select_scatter", "as_strided_scatter", "diagonal_backward",
    "unfold_backward", "expand_copy", "permute_copy", "view_copy",
    "t_copy", "transpose_copy", "_unsafe_index", "index_select_backward",
})
_REDUCES = frozenset({"sum", "amax", "amin", "prod", "any", "all",
                      "logsumexp_reduce", "max", "min", "nansum"})
# collectives (c10d): the reducing ones charge one add a payload element
_COLLECTIVE_REDUCE = frozenset({"allreduce_", "allreduce_coalesced_",
                                "reduce_", "reduce_scatter_",
                                "_reduce_scatter_base_",
                                "reduce_scatter_tensor_coalesced_",
                                "all_reduce", "reduce_scatter_tensor"})
_COLLECTIVE_FREE = frozenset({"allgather_", "_allgather_base_",
                              "allgather_into_tensor_coalesced_",
                              "broadcast_", "alltoall_", "alltoall_base_",
                              "send", "recv_", "barrier",
                              "all_gather_into_tensor", "all_to_all_single",
                              "wait_tensor", "scatter_", "gather_",
                              "allgather_coalesced_", "recv_any_source_",
                              "monitored_barrier_"})


def _reduce_count(x, out) -> float:
    return float(max(_numel(x) - (_numel(out) if out is not None else 1),
                     0))


def _rows(x, dims) -> int:
    """The number of rows a reduction over ``dims`` of ``x`` leaves."""
    nd = x.dim()
    dims = [d % nd for d in (dims if isinstance(dims, (list, tuple))
                             else [dims])] if nd else []
    red = 1
    for d in dims:
        red *= x.shape[d]
    return _numel(x) // max(red, 1)


def op_flops(name: str, args, kwargs, outs) -> Tuple[float, float, float,
                                                   Optional[str], bool]:
    """``(flops, transcendentals, matmul_flops, matmul_dtype, known)`` of
    one aten operator (name without namespace, overload or trailing ``_``
    of an in-place variant), from its arguments and outputs."""
    out = outs[0] if outs else None
    n_out = float(sum(_numel(o) for o in outs))
    a0 = args[0] if args else None
    if name in ("mm", "bmm"):
        f = dot_flops(out, args[0].shape[-1])
        return f, 0.0, f, _dt(args[0]), True
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        f = dot_flops(out, args[1].shape[-1])
        return f + n_out, 0.0, f, _dt(args[1]), True
    if name in ("mv", "dot", "vdot"):
        f = dot_flops(out, args[0].shape[-1])
        return f, 0.0, f, _dt(args[0]), True
    if name in ("convolution", "_convolution", "cudnn_convolution",
                "mkldnn_convolution", "conv2d", "_conv_depthwise2d"):
        x, w = args[0], args[1]
        bias = args[2] if len(args) > 2 else None
        stride, padding, dilation = args[3], args[4], args[5]
        transposed = bool(args[6]) if len(args) > 6 else False
        groups = int(args[8]) if len(args) > 8 else 1
        f = conv_flops(list(x.shape), list(w.shape), list(out.shape),
                       stride, padding, dilation, transposed, groups)
        extra = n_out if bias is not None else 0.0
        return f + extra, 0.0, f, _dt(x), True
    if name == "convolution_backward":
        gout, x, w = args[0], args[1], args[2]
        stride, padding, dilation = args[4], args[5], args[6]
        transposed, groups, mask = bool(args[7]), int(args[9]), args[10]
        fwd_out = gout
        f1 = conv_flops(list(x.shape), list(w.shape), list(fwd_out.shape),
                        stride, padding, dilation, transposed, groups)
        mm = f1 * (int(bool(mask[0])) + int(bool(mask[1])))
        bias = _reduce_count(gout, outs[2]) if mask[2] and len(outs) > 2 \
            and outs[2] is not None else 0.0
        # the dgrad's operand is the cotangent, the wgrad's the input
        return mm + bias, 0.0, mm, _dt(gout if mask[0] else x), True
    if name in _REDUCES:
        if name in ("max", "min") and len(args) == 1:
            return _reduce_count(a0, out), 0.0, 0.0, None, True
        if name in ("max", "min") and len(args) > 1 and hasattr(
                args[1], "shape"):
            return n_out, 0.0, 0.0, None, True    # elementwise max/min
        return _reduce_count(a0, out), 0.0, 0.0, None, True
    if name == "mean":
        return _reduce_count(a0, out) + float(_numel(out)), 0.0, 0.0, \
            None, True
    if name in ("var", "std", "var_mean", "std_mean"):
        n = _numel(a0)
        r = _numel(out)
        # mean, subtract, square, sum, divide (and a sqrt for std)
        return float(4 * n - 2 * r + 2 * r), float(
            r if name.startswith("std") else 0), 0.0, None, True
    if name in ("argmax", "argmin"):
        return 9.0 * _reduce_count(a0, out), 0.0, 0.0, None, True
    if name in ("linalg_vector_norm", "norm", "_foreach_norm"):
        ins = a0 if isinstance(a0, (list, tuple)) else [a0]
        n = sum(_numel(t) for t in ins)
        return 2.0 * n, float(len(outs)), 0.0, None, True
    if name in ("cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"):
        return n_out, 0.0, 0.0, None, True
    if name in ("_softmax", "softmax"):
        n, r = float(_numel(a0)), float(_rows(a0, args[1]))
        return 4 * n - r, n, 0.0, None, True
    if name in ("_log_softmax", "log_softmax"):
        n, r = float(_numel(a0)), float(_rows(a0, args[1]))
        return 4 * n - r, n + r, 0.0, None, True
    if name in ("_softmax_backward_data", "_log_softmax_backward_data"):
        n, r = float(_numel(a0)), float(_rows(a0, args[2]))
        return 4 * n - r, 0.0, 0.0, None, True
    if name in ("native_layer_norm",):
        n, r = float(_numel(a0)), float(_numel(outs[1]))
        # two-pass mean and variance, normalize, affine
        return 9 * n, r, 0.0, None, True
    if name in ("native_layer_norm_backward",):
        n = float(_numel(a0))
        return 12 * n, 0.0, 0.0, None, True
    if name in ("native_batch_norm", "_native_batch_norm_legit",
                "_native_batch_norm_legit_no_training", "batch_norm"):
        n = float(_numel(a0))
        return 9 * n, float(a0.shape[1]) if a0.dim() > 1 else 1.0, \
            0.0, None, True
    if name in ("native_batch_norm_backward",):
        return 10.0 * _numel(a0), 0.0, 0.0, None, True
    if name in ("gelu",):
        n = float(_numel(a0))
        approx = kwargs.get("approximate", args[1] if len(args) > 1
                            else "none")
        return (7 * n if approx == "tanh" else 4 * n), n, 0.0, None, True
    if name in ("gelu_backward",):
        n = float(_numel(a0))
        return 12 * n, n, 0.0, None, True
    if name in ("max_pool2d_with_indices", "max_pool3d_with_indices",
                "avg_pool2d", "avg_pool3d"):
        win = math.prod(_per_dim(args[1], a0.dim() - 2))
        # reduce_window: window - 1 a result (and the average's divide)
        return _numel(out) * (win - 1 + name.startswith("avg")), 0.0, \
            0.0, None, True
    if name in ("max_pool2d_with_indices_backward",
                "max_pool3d_with_indices_backward",
                "avg_pool2d_backward", "avg_pool3d_backward"):
        win = math.prod(_per_dim(args[2], a0.dim() - 2))
        # select_and_scatter_add: a window a cotangent element
        return float(_numel(a0) * win), 0.0, 0.0, None, True
    if name in ("_adaptive_avg_pool2d", "adaptive_avg_pool2d"):
        return _reduce_count(a0, out) + float(_numel(out)), 0.0, 0.0, \
            None, True
    if name in ("_adaptive_avg_pool2d_backward",):
        return n_out, 0.0, 0.0, None, True
    if name in ("sigmoid", "silu"):
        n = float(_numel(a0))
        return (3 * n + n * (name == "silu")), n, 0.0, None, True
    if name in ("sigmoid_backward", "tanh_backward"):
        return 2.0 * n_out, 0.0, 0.0, None, True
    if name in ("silu_backward",):
        n = float(_numel(a0))
        return 6 * n, n, 0.0, None, True
    if name in ("native_dropout",):
        n = float(_numel(a0))
        # the JAX dropout: random bits (18), a compare, a select, a scale
        return 21 * n, 0.0, 0.0, None, True
    if name in ("native_dropout_backward",):
        return 2.0 * n_out, 0.0, 0.0, None, True
    if name in ("nll_loss_forward", "nll_loss2d_forward"):
        return 2.0 * _numel(args[1]), 0.0, 0.0, None, True
    if name in ("nll_loss_backward", "nll_loss2d_backward"):
        return float(_numel(args[2])), 0.0, 0.0, None, True
    if name in ("mse_loss",):
        n = float(_numel(a0))
        return 3 * n, 0.0, 0.0, None, True
    if name in ("embedding_dense_backward", "index_add", "scatter_add",
                "index_put_accumulate", "scatter_reduce",
                "_embedding_bag_backward"):
        # combining scatters: one op an update element
        ups = args[0] if name == "embedding_dense_backward" else (
            args[3] if len(args) > 3 and hasattr(args[3], "shape")
            else out)
        return float(_numel(ups)), 0.0, 0.0, None, True
    if name == "pow":
        exp = args[1] if len(args) > 1 else None
        if isinstance(exp, (int, float)) and float(exp).is_integer():
            p = abs(int(exp))
            if p <= 1:
                return n_out, 0.0, 0.0, None, True
            muls = int(math.floor(math.log2(p))) + bin(p).count("1") - 1
            return n_out * muls, 0.0, 0.0, None, True
        return 0.0, n_out, 0.0, None, True
    if name in _TRANSCENDENTAL:
        return 0.0, n_out, 0.0, None, True
    if name in _ELEMENTWISE_N:
        return n_out * _ELEMENTWISE_N[name], 0.0, 0.0, None, True
    if name == "copy" and len(args) > 1 and hasattr(args[1], "dtype") \
            and args[1].dtype != a0.dtype:
        return float(_numel(a0)), 0.0, 0.0, None, True
    if name in ("_to_copy", "to"):
        # a cast is convert_element_type; a same-dtype copy moves bytes
        src = a0
        same = (out is not None and hasattr(src, "dtype")
                and src.dtype == out.dtype)
        return (0.0 if same else n_out), 0.0, 0.0, None, True
    if name in _ELEMENTWISE_1:
        return n_out, 0.0, 0.0, None, True
    if name.startswith("_foreach_"):
        base = name[len("_foreach_"):]
        n = float(sum(_numel(t) for t in (a0 or ())))
        if base in _TRANSCENDENTAL:
            return 0.0, n, 0.0, None, True
        return n, 0.0, 0.0, None, True
    if name in _FREE or name in _COLLECTIVE_FREE:
        return 0.0, 0.0, 0.0, None, True
    if name in _COLLECTIVE_REDUCE:
        ins = a0 if isinstance(a0, (list, tuple)) else [a0]
        return float(sum(_numel(t) for t in ins
                         if hasattr(t, "numel"))), 0.0, 0.0, None, True
    # unknown: one flop an output element, and surfaced
    return n_out, 0.0, 0.0, None, False


def _op_name(func) -> str:
    name = func.overloadpacket.__name__ if hasattr(
        func, "overloadpacket") else str(func)
    if name.endswith("_") and not name.endswith("__") and name[:-1] not in (
            "allreduce", "broadcast", "allgather", "reduce",
            "reduce_scatter", "alltoall", "scatter", "gather",
            "recv", "_allgather_base", "_reduce_scatter_base",
            "alltoall_base", "allreduce_coalesced",
            "allgather_coalesced", "allgather_into_tensor_coalesced",
            "reduce_scatter_tensor_coalesced", "recv_any_source",
            "monitored_barrier"):
        name = name[:-1]              # in place: the same arithmetic
    return name


def _tensors(tree):
    import torch
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


class _Counter:
    """What a count accumulates, and the per-thread hiding depth the
    priced kernel wrappers raise around their bodies."""

    def __init__(self):
        self.cost = Cost()
        self.lock = threading.Lock()
        self.hide: Dict[int, int] = {}

    def hidden(self):
        import contextlib

        @contextlib.contextmanager
        def cm():
            tid = threading.get_ident()
            with self.lock:
                self.hide[tid] = self.hide.get(tid, 0) + 1
            try:
                yield
            finally:
                with self.lock:
                    self.hide[tid] -= 1
        return cm()

    def is_hidden(self) -> bool:
        return self.hide.get(threading.get_ident(), 0) > 0

    def add(self, name: str, flops: float, transc: float, mm: float,
            mm_dtype: Optional[str], known: bool, byts: Dict[str, int]):
        c = self.cost
        with self.lock:
            c.flops += flops
            c.transcendentals += transc
            c.eqns += 1
            if flops:
                c.flops_by_prim[name] = c.flops_by_prim.get(name, 0.0) \
                    + flops
            if mm:
                c.matmul_flops += mm
                c.matmul_flops_by_dtype[mm_dtype] = \
                    c.matmul_flops_by_dtype.get(mm_dtype, 0.0) + mm
            if not known:
                c.unknown_prims[name] = c.unknown_prims.get(name, 0) + 1
            for dt, b in byts.items():
                c.bytes_accessed += int(b)
                c.bytes_by_dtype[dt] = c.bytes_by_dtype.get(dt, 0) + int(b)


def _make_mode(counter: _Counter):
    """A ``TorchDispatchMode`` pricing every operator it sees into
    ``counter`` (built lazily: torch is imported only here)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CostMode(TorchDispatchMode):
        cost_counter = counter

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if counter.is_hidden():
                return out
            name = _op_name(func)
            outs = _tensors(out)
            try:
                f, t, mm, mdt, known = op_flops(name, list(args), kwargs,
                                                outs)
            except Exception:           # noqa: BLE001 — an odd overload's
                # arguments: price it as unknown rather than fail the step
                f, t, mm, mdt, known = (float(sum(o.numel() for o in outs)),
                                        0.0, 0.0, None, False)
            # the operands and results of every operator that computes:
            # views, copies and allocations move no bytes of arithmetic
            byts: Dict[str, int] = {}
            if name not in _FREE and name not in _COLLECTIVE_FREE:
                for x in _tensors(args) + _tensors(kwargs) + outs:
                    dt = _dt(x)
                    byts[dt] = byts.get(dt, 0) \
                        + x.numel() * x.element_size()
            counter.add(name, f, t, mm, mdt, known, byts)
            return out

    return CostMode()


def _counters() -> list:
    """The counts running on this thread: the cost modes on its
    dispatch-mode stack (autograd's worker threads inherit the stack of
    the thread that ran the forward)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return [m.cost_counter for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "cost_counter")]


def _to_meta(x):
    """``x`` with every tensor in it (in lists, tuples and named tuples
    too) replaced by a meta tensor of its shape, strides and dtype."""
    import torch
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_meta(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def _plain_count(body, args, kwargs) -> Dict[str, Any]:
    """A kernel wrapper priced as its plain version: ``body`` (the
    wrapper's) run on meta copies of its arguments, which takes the plain
    version's branch, counted apart."""
    sub = _Counter()
    with _make_mode(sub):
        body(*_to_meta(args), **{k: _to_meta(v) for k, v in kwargs.items()})
    c = sub.cost
    by = c.matmul_flops_by_dtype
    return {"flops": c.flops, "transcendentals": c.transcendentals,
            "bytes": c.bytes_accessed, "matmul_flops": c.matmul_flops,
            "matmul_dtype": next(iter(by)) if len(by) == 1 else None,
            "unknown": dict(c.unknown_prims)}


def _kernel_hook(wrapper, body, cost, args, kwargs):
    """An ``ops._launches`` hook while a count runs: price a kernel wrapper's
    call (its declared ``cost``, else its plain version's count) into each
    count of this thread, as one entry under ``kernel:<wrapper>``, and run
    the call with its own operators hidden from them (its plain version on
    the CPU, its output allocations on the card), so one step counts the
    same on both devices.  A wrapper called inside another's body is the
    outer one's."""
    counters = [c for c in _counters() if not c.is_hidden()]
    if not counters:
        return body(*args, **kwargs)
    import contextlib
    with contextlib.ExitStack() as stack:
        for c in counters:
            stack.enter_context(c.hidden())
        declared = (cost(*args, **kwargs) if cost is not None
                    else _plain_count(body, args, kwargs))
        dt = declared.get("matmul_dtype")
        dt = None if dt is None else str(dt).replace("torch.", "")
        for c in counters:
            c.add(declared.get("prim", f"kernel:{wrapper.__name__}"),
                  float(declared["flops"]),
                  float(declared.get("transcendentals", 0)),
                  float(declared.get("matmul_flops", 0)), dt, True,
                  {"kernel": int(declared.get("bytes", 0))})
            for name, n in declared.get("unknown", {}).items():
                with c.lock:
                    c.cost.unknown_prims[name] = \
                        c.cost.unknown_prims.get(name, 0) + n
        return body(*args, **kwargs)


_RUNNING = 0                      # counts running in the process, under
_RUNNING_LOCK = threading.Lock()  # _RUNNING_LOCK: the hook is set while > 0


def count_cost(fn: Callable, *args, **kwargs) -> Cost:
    """The analytic :class:`Cost` of one call ``fn(*args, **kwargs)``,
    which runs (a training step takes its step).  Every aten operator it
    dispatches is priced (see the module doc), the port's kernel wrappers
    as their plain versions (or by their declarations); autograd's
    backward, which runs on worker threads on the card, is counted too
    (they inherit the dispatch mode).  ``bytes_by_dtype`` carries the
    kernels' bytes under ``"kernel"``."""
    global _RUNNING
    from ..ops import _launches
    counter = _Counter()
    mode = _make_mode(counter)
    with _RUNNING_LOCK:
        _RUNNING += 1
        if _RUNNING == 1:
            _launches.add_hook(_kernel_hook)
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        with _RUNNING_LOCK:
            _RUNNING -= 1
            if not _RUNNING:
                _launches.remove_hook(_kernel_hook)
    return counter.cost
