"""Launch lint over the port's ``ctypes`` kernels: each launch checked
against what its ``.cu`` source and its wrapper assume.

Counterpart of ``apex_tpu/analysis/pallas_lint.py`` (the JAX names are
kept so that a reader finds them).  The JAX module intercepts
``pl.pallas_call`` and checks block shapes, index maps and input/output
aliases.  The port's kernels are hand-written CUDA launched through
``ctypes``: no compiler sees the call, so a wrong dtype, a strided view,
a misaligned base, an index past the kernel's int range or two operands
on one buffer is silent corruption on the card.  This module records
every launch of a kernel wrapper of ``ops/`` as a :class:`KernelSite`
(through the ``ops._launches`` hook, without launching anything more:
:func:`capture_kernel_sites` wraps a run) and checks each site:

- **dtype**: each operand's dtype is one the kernel instantiates, and
  operands that share a template type share a dtype;
- **contiguous**: every operand the kernel indexes flat is contiguous;
- **alignment**: the base address meets the vector path the kernel
  requires (the flat fp32 buffers of the multi-tensor and LAMB kernels
  take 16-byte float4 loads; Adam, LayerNorm, syncbn and flash choose a
  scalar path for an unaligned base, so they require nothing);
- **elements**: operands agree in length, and every count fits the
  kernel's index type (int for LayerNorm, syncbn's rows and flash;
  ``long long`` for the flat kernels);
- **grid** / **block** / **shared memory**: the launch configuration, read
  from the wrapper's own computation of it (``_build.grid_blocks``,
  LayerNorm's plans) on the CPU, and from the CUDA runtime's account of
  the kernel (``kernel_info`` of flash and LayerNorm) on the card; grid
  x within 2^31 - 1 blocks, a block at most 1024 threads and whole
  warps, dynamic shared memory within Hopper's opt-in 227 KB.  Where the
  ``.cu`` computes its own grid (axpby, syncbn, LAMB stage 2, flash),
  that computation is not copied here: the element checks bound it;
- **in place**: an output that may alias an input (``out=x``) is the
  same buffer exactly or does not overlap it;
- **overlap**: operands the kernel writes do not overlap any other
  operand.
"""

from __future__ import annotations

import contextlib
import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .graphs import TensorMeta

__all__ = ["KernelSite", "capture_kernel_sites", "check_site",
           "collect_kernel_sites", "lint_pallas_kernels", "CHECKS",
           "SMEM_OPTIN_MAX", "WRAPPERS"]

# Hopper's opt-in dynamic shared memory a block (227 KB)
SMEM_OPTIN_MAX = 227 * 1024
_INT_MAX = 2 ** 31 - 1
_LL_MAX = 2 ** 63 - 1
CHECKS = ("dtype", "contiguous", "alignment", "elements", "grid", "block",
          "shared memory", "in place", "overlap")


@dataclass
class KernelSite:
    """One recorded launch of a kernel wrapper: its tensor operands by
    name (``None`` when not passed), its other arguments, the launch
    configuration where the wrapper computes one (``grid``, ``block``,
    ``smem``), and the operands the kernel writes (the wrapper's
    ``writes``, declared where ``ops._launches.priced`` decorates it)."""
    name: str
    operands: Dict[str, Optional[TensorMeta]]
    scalars: Dict[str, Any] = field(default_factory=dict)
    launch: Dict[str, Any] = field(default_factory=dict)
    written: Tuple[str, ...] = ()

    def describe(self) -> str:
        ops = ", ".join(f"{k}={v}" for k, v in self.operands.items()
                        if v is not None)
        return f"{self.name}({ops}) launch={self.launch}"


@dataclass
class _Req:
    """What a kernel takes of one operand."""
    dtypes: Tuple[str, ...]
    numel: Optional[int] = None
    contiguous: bool = True
    align: int = 1
    ndim: Optional[int] = None


_F32 = ("float32",)
_HALF = ("bfloat16", "float16")
_FLOAT = ("float32", "bfloat16", "float16")


def _n(site, name) -> int:
    m = site.operands.get(name)
    return m.numel if m is not None else 0


def _flat_f32(site, names, align=16):
    n = _n(site, names[0])
    return {k: _Req(_F32, n, True, align, 1) for k in names}


def _scalars(names):
    return {k: _Req(_F32, 1, False, 1) for k in names}


# per wrapper: (requirements, dtype groups, in-place pairs, index limit of
# the kernel's element count); what each writes is the wrapper's ``writes``
def _spec(site) -> Tuple[Dict[str, _Req], List[Tuple[str, ...]],
                         List[Tuple[str, str]], int]:
    name = site.name
    if name == "multi_tensor_scale":
        return ({**_flat_f32(site, ("x", "out")), **_scalars(("scale",))},
                [], [("out", "x")], _LL_MAX)
    if name == "multi_tensor_axpby":
        return ({**_flat_f32(site, ("x", "y", "out")),
                 **_scalars(("a", "b"))},
                [], [("out", "x"), ("out", "y")], _LL_MAX)
    if name == "multi_tensor_l2norm":
        return (_flat_f32(site, ("x",)), [], [], _LL_MAX)
    if name == "multi_tensor_l2norm_per_tensor":
        return ({**_flat_f32(site, ("x",)),
                 "table.chunks": _Req(("int64",), None, True, 8, 2),
                 "table.bounds": _Req(("int64",), None, True, 8, 1)},
                [], [], _INT_MAX)
    if name == "fused_adam":
        n = _n(site, "p")
        reqs = {k: _Req(_F32, n, True, 1, None) for k in ("p", "m", "v",
                                                          "g")}
        reqs["half"] = _Req(_HALF, n, True, 1, None)
        reqs.update(_scalars(("step_size", "inv_scale", "noop")))
        return reqs, [], [], _LL_MAX
    if name == "lamb_stage1":
        reqs = _flat_f32(site, ("g", "p", "m", "v", "out"))
        reqs.update(_scalars(("inv_clip", "inv_bc1", "inv_bc2", "noop")))
        return reqs, [], [], _LL_MAX
    if name == "lamb_stage2":
        reqs = _flat_f32(site, ("p", "upd"))
        reqs["half"] = _Req(_HALF, _n(site, "p"), True, 8, 1)
        reqs["ratio"] = _Req(_F32, None, True, 1, 1)
        reqs["table.chunks"] = _Req(("int64",), None, True, 8, 2)
        reqs.update(_scalars(("lr", "noop")))
        return reqs, [], [], _LL_MAX
    if name in ("syncbn_fwd", "syncbn_bwd"):
        x = site.operands.get("x")
        c = x.shape[1] if x is not None and x.ndim == 4 else None
        reqs = {"x": _Req(_FLOAT, None, True, 1, 4),
                **{k: _Req(_F32, c, True, 1, 1)
                   for k in ("mean", "inv", "w", "b")}}
        groups = []
        if name == "syncbn_bwd":
            reqs["dy"] = _Req(_FLOAT, _n(site, "x"), True, 1, 4)
            groups = [("dy", "x")]
        return reqs, groups, [], _INT_MAX
    if name in ("layer_norm_fwd", "layer_norm_bwd"):
        x = site.operands.get("x2")
        n1, n2 = (x.shape if x is not None and x.ndim == 2 else (None, None))
        reqs = {"x2": _Req(_FLOAT, None, True, 1, 2),
                "w": _Req(_F32, n2, True, 1, 1),
                "b": _Req(_F32, n2, True, 1, 1)}
        groups = []
        if name == "layer_norm_bwd":
            reqs["dy"] = _Req(_FLOAT, _n(site, "x2"), True, 1, 2)
            reqs["mean"] = _Req(_F32, n1, True, 1, 1)
            reqs["inv"] = _Req(_F32, n1, True, 1, 1)
            groups = [("dy", "x2")]
        return reqs, groups, [], _INT_MAX
    if name in ("flash_fwd", "flash_dq", "flash_dkv"):
        q = site.operands.get("q3")
        n = q.numel if q is not None else None
        names = ("q3", "k3", "v3") + (("do3",) if name != "flash_fwd"
                                      else ())
        reqs = {k: _Req(_FLOAT, n, True, 1, 3) for k in names}
        bt = q.shape[0] * q.shape[1] if q is not None and q.ndim == 3 \
            else None
        if name != "flash_fwd":
            reqs["lse"] = _Req(_F32, bt, True, 4, None)
            reqs["delta"] = _Req(_F32, bt, True, 4, None)
        reqs["kv_mask"] = _Req(("bool",), None, True, 1, 2)
        reqs["segment_ids"] = _Req(("int32",), None, True, 1, 2)
        reqs["seed"] = _Req(("int32",), 2, True, 1, 1)
        return reqs, [names], [], _INT_MAX
    raise KeyError(f"no launch spec for kernel wrapper {name!r}")


def _overlaps(a: TensorMeta, b: TensorMeta) -> bool:
    (lo, hi), (lo2, hi2) = a.span, b.span
    return lo < hi2 and lo2 < hi and hi > lo and hi2 > lo2


def _same(a: TensorMeta, b: TensorMeta) -> bool:
    return a.span == b.span and a.shape == b.shape


def check_site(site: KernelSite) -> List[str]:
    """Every problem of one launch (see the module doc); each message
    starts with its check's name."""
    out: List[str] = []
    reqs, groups, inplace, limit = _spec(site)
    for name, m in site.operands.items():
        r = reqs.get(name)
        if m is None or r is None:
            continue
        if m.dtype not in r.dtypes:
            out.append(f"dtype: {site.name}.{name} is {m.dtype}, the kernel "
                       f"takes {'/'.join(r.dtypes)}")
        if r.ndim is not None and m.ndim != r.ndim and m.numel > 1:
            out.append(f"contiguous: {site.name}.{name} has rank {m.ndim}, "
                       f"the kernel indexes rank {r.ndim}")
        if r.contiguous and not m.is_contiguous():
            out.append(f"contiguous: {site.name}.{name} has strides "
                       f"{m.stride} for shape {m.shape}; the kernel "
                       f"indexes it flat")
        if r.align > 1 and m.numel and m.ptr % r.align:
            out.append(f"alignment: {site.name}.{name} starts at "
                       f"{m.ptr:#x}, not {r.align}-byte aligned for the "
                       f"kernel's vector loads")
        if r.numel is not None and m.numel != r.numel:
            out.append(f"elements: {site.name}.{name} has {m.numel} "
                       f"elements, the launch covers {r.numel}")
        if m.numel > limit:
            out.append(f"elements: {site.name}.{name} has {m.numel} "
                       f"elements, past the kernel's index type "
                       f"({limit})")
    for group in groups:
        dts = {site.operands[k].dtype for k in group
               if site.operands.get(k) is not None}
        if len(dts) > 1:
            out.append(f"dtype: {site.name} operands {list(group)} must "
                       f"share a dtype, got {sorted(dts)}")
    grid = tuple(site.launch.get("grid", ()))
    for i, g in enumerate(grid):
        top = _INT_MAX if i == 0 else 65535
        if not 1 <= int(g) <= top:
            out.append(f"grid: {site.name} grid dim {i} is {g}, outside "
                       f"[1, {top}]")
    block = site.launch.get("block")
    if block is not None and not (1 <= int(block) <= 1024
                                  and int(block) % 32 == 0):
        out.append(f"block: {site.name} launches {block} threads a block "
                   f"(1 to 1024, whole warps of 32)")
    smem = site.launch.get("smem")
    if smem is not None and int(smem) > SMEM_OPTIN_MAX:
        out.append(f"shared memory: {site.name} asks {smem} bytes of "
                   f"dynamic shared memory, past the opt-in "
                   f"{SMEM_OPTIN_MAX}")
    ops = {k: m for k, m in site.operands.items()
           if m is not None and m.numel and m.device != "meta"}
    allowed = {frozenset(p) for p in inplace}
    for a, b in inplace:
        if a in ops and b in ops and _overlaps(ops[a], ops[b]) \
                and not _same(ops[a], ops[b]):
            out.append(f"in place: {site.name}.{a} overlaps {b} without "
                       f"being the same buffer")
    for a in site.written:
        if a not in ops:
            continue
        for b in ops:
            if b == a or frozenset((a, b)) in allowed:
                continue
            if _overlaps(ops[a], ops[b]):
                out.append(f"overlap: {site.name}.{a}, which the kernel "
                           f"writes, overlaps {b}")
    return out


# -- recording ---------------------------------------------------------------

def _launch_config(name, bound) -> Dict[str, Any]:
    """The launch configuration the wrapper itself computes for this call
    (none where the ``.cu`` computes it)."""
    from ..ops import _build
    from ..ops import layer_norm as ln
    if name in ("multi_tensor_scale", "multi_tensor_l2norm", "fused_adam",
                "lamb_stage1"):
        t = bound.get("x", bound.get("p"))
        n = t.numel()
        return {"grid": (_build.grid_blocks(n),) if n else (),
                "block": _build.THREADS}
    if name == "multi_tensor_l2norm_per_tensor":
        n = bound["table"].chunks.shape[0]
        return {"grid": (n,) if n else (), "block": _build.THREADS}
    if name == "layer_norm_fwd":
        x2 = bound["x2"]
        n1, n2 = x2.shape
        if not (n1 and n2):
            return {}
        plan = ln._fwd_plan(n1, n2, x2.element_size(),
                            x2.data_ptr() % 16 == 0)
        return {"grid": (plan.blocks,), "block": 32 * plan.warps}
    if name == "layer_norm_bwd":
        x2 = bound["x2"]
        n1, n2 = x2.shape
        if not (n1 and n2):
            return {}
        plan = ln._bwd_plan(n1, n2, x2.element_size(),
                            x2.data_ptr() % 16 == 0)
        return {"grid": (plan.blocks,), "block": 32 * plan.warps}
    return {}


def _site_of(wrapper, args, kwargs) -> KernelSite:
    import torch
    name = wrapper.__name__
    bound = inspect.signature(wrapper).bind(*args, **kwargs)
    bound.apply_defaults()
    operands: Dict[str, Optional[TensorMeta]] = {}
    scalars: Dict[str, Any] = {}
    for k, v in bound.arguments.items():
        if isinstance(v, torch.Tensor):
            operands[k] = TensorMeta.of(v)
        elif hasattr(v, "chunks") and hasattr(v, "bounds"):
            operands[f"{k}.chunks"] = TensorMeta.of(v.chunks)
            operands[f"{k}.bounds"] = TensorMeta.of(v.bounds)
        elif v is None:
            operands[k] = None
        else:
            scalars[k] = v
    return KernelSite(name, operands, scalars,
                      _launch_config(name, bound.arguments), wrapper.writes)


@contextlib.contextmanager
def capture_kernel_sites(into: List[KernelSite]) -> Iterator[None]:
    """Record a :class:`KernelSite` into ``into`` for every kernel wrapper
    call made inside the block (the calls run as they would)."""
    from ..ops import _launches

    def hook(wrapper, body, cost, args, kwargs):
        if not any(getattr(t, "device", None) is not None
                   and t.device.type == "meta" for t in args):
            into.append(_site_of(wrapper, args, kwargs))
        return body(*args, **kwargs)

    _launches.add_hook(hook)
    try:
        yield
    finally:
        _launches.remove_hook(hook)


def _drive(device: str = "cpu") -> None:
    """Every kernel wrapper of ``ops/`` once, at small shapes: the flat
    multi-tensor family (and the per-tensor l2norm), Adam (with and
    without its half copy and skip flag), both LAMB stages, syncbn forward
    and backward, LayerNorm forward and backward, flash forward, dQ and
    dK/dV."""
    import torch
    from .. import ops
    from ..ops.multi_tensor import ChunkTable
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    n = 1000
    x, y = r(n), r(n)
    ops.multi_tensor_scale(x, 0.5)
    ops.multi_tensor_scale(x.clone(), 2.0, out=None)
    xo = x.clone()
    ops.multi_tensor_scale(xo, 0.5, out=xo)
    ops.multi_tensor_axpby(0.5, 2.0, x, y)
    ops.multi_tensor_l2norm(x)
    table = ChunkTable.build([(0, 600), (600, 400)], 256, device)
    ops.multi_tensor_l2norm_per_tensor(x, table)
    one = torch.ones((), device=device)
    for half in (None, torch.zeros(n, dtype=torch.bfloat16,
                                   device=device)):
        ops.fused_adam(r(n), torch.zeros(n, device=device),
                       torch.zeros(n, device=device), r(n), one * 1e-3,
                       one, 0.9, 0.999, 1e-8, False, 0.0, half=half,
                       noop=torch.zeros((), device=device))
    p, m, v = r(n), torch.zeros(n, device=device), torch.zeros(
        n, device=device)
    upd = ops.lamb_stage1(r(n), p, m, v, one, one, one, 0.9, 0.999, 0.1,
                          1e-6, 0.01, True)
    ops.lamb_stage2(p, upd, torch.ones(2, device=device), table, 1e-3,
                    half=torch.zeros(n, dtype=torch.bfloat16,
                                     device=device))
    xb = r(2, 4, 3, 5, dtype=torch.bfloat16)
    vec = [torch.rand(4, generator=g).to(device) + 0.5 for _ in range(4)]
    yb = ops.syncbn_fwd(xb, *vec)
    ops.syncbn_bwd(yb, xb, *vec[:3])
    x2 = r(6, 64, dtype=torch.bfloat16)
    w = torch.ones(64, device=device)
    yy, mean, inv = ops.layer_norm_fwd(x2, w, torch.zeros(64, device=device),
                                       1e-5)
    ops.layer_norm_bwd(yy, x2, w, mean, inv)
    q, k, vv, do = (r(2, 16, 8, dtype=torch.bfloat16) for _ in range(4))
    o, lse = ops.flash_fwd(q, k, vv, 1, 8 ** -0.5, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    ops.flash_dq(q, k, vv, do, lse, delta, 1, 8 ** -0.5, causal=True)
    ops.flash_dkv(q, k, vv, do, lse, delta, 1, 8 ** -0.5, causal=True)


# the wrappers the lint covers: every kernel wrapper of ops/
WRAPPERS = ("multi_tensor_scale", "multi_tensor_axpby",
            "multi_tensor_l2norm", "multi_tensor_l2norm_per_tensor",
            "fused_adam", "lamb_stage1", "lamb_stage2", "syncbn_fwd",
            "syncbn_bwd", "layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
            "flash_dq", "flash_dkv")


def collect_kernel_sites(run: Optional[Callable[[], Any]] = None,
                         device: str = "cpu") -> List[KernelSite]:
    """The sites of ``run()`` (default: every wrapper once at small
    shapes on ``device``)."""
    sites: List[KernelSite] = []
    with capture_kernel_sites(sites):
        if run is None:
            _drive(device)
        else:
            run()
    return sites


def card_launch_checks(sites: List[KernelSite]) -> List[str]:
    """On the card: the block and shared memory of each flash and
    LayerNorm site from the CUDA runtime's account of the kernel it
    launches (``kernel_info``), checked as :func:`check_site` checks a
    launch."""
    import torch
    from ..ops import flash_attention as fa
    from ..ops import layer_norm as ln
    out: List[str] = []
    seen = set()
    for s in sites:
        if s.name.startswith("flash_"):
            q = s.operands["q3"]
            key = (s.name, q.dtype, q.shape[-1])
            if key in seen:
                continue
            seen.add(key)
            info = fa.kernel_info(s.name[len("flash_"):],
                                  getattr(torch, q.dtype), q.shape[-1])
        elif s.name in ("layer_norm_fwd", "layer_norm_bwd"):
            x = s.operands["x2"]
            plan = (ln._fwd_plan if s.name == "layer_norm_fwd"
                    else ln._bwd_plan)(x.shape[0], x.shape[1], x.itemsize,
                                       x.ptr % 16 == 0)
            key = (s.name, x.dtype, x.shape[1], plan.path, plan.warps)
            if key in seen:
                continue
            seen.add(key)
            info = (ln.fwd_kernel_info if s.name == "layer_norm_fwd"
                    else ln.bwd_kernel_info)(getattr(torch, x.dtype),
                                             x.shape[1], plan)
        else:
            continue
        probe = KernelSite(s.name, {}, launch={
            "block": info["threads"], "smem": info["smem_bytes"]})
        out.extend(check_site(probe))
    return out


def lint_pallas_kernels(device: str = "cpu"
                        ) -> Tuple[List[KernelSite], List[str]]:
    """Collect every wrapper's sites and lint them: ``(sites,
    problems)``."""
    sites = collect_kernel_sites(device=device)
    problems = [p for s in sites for p in check_site(s)]
    return sites, problems
