"""AmpOptimizer: fp32 master weights, unscale, overflow skip.

Counterpart of ``apex_tpu/amp/_process_optimizer.py`` on its flat,
non-ZeRO path.  At :meth:`AmpOptimizer.bind` (called by
``amp.initialize``) the model's parameters are laid out, in the JAX
package's leaf order, in one flat fp32 master buffer, plus one flat
buffer of the half dtype when the model has one (O2).  The model's half
parameters then become views into the half buffer and its fp32
parameters (BatchNorm under O2; everything under O0) views into the
master buffer.  The optimizer's kernel (Adam, or LAMB's stage 2) updates
the masters in place and writes the half copy in the same pass, so the
model is updated in place with no rebuild copy: the in-place update the
port allows where it saves memory (here the whole per-step params rebuild
of ``_FlatLayout.rebuild``).  The masters stay dense for every optimizer:
one that is not elementwise (FusedLAMB, LARC) gets the layout, whose
chunk table carries the tensor boundaries, where the JAX package keeps a
master tree for it.

A step is free of host syncs: unscale and overflow check in one kernel,
the scaler's transition on device tensors, and a skipped step is the
optimizer kernels' no-op flag (the JAX package's ``lax.cond``).

Two call shapes.  ``step()`` after ``amp.scale_loss`` takes the grads
stashed by the backward passes (the torch shape).  ``step(scaled_grads)``
is the JAX package's functional step (``AmpOptimizer.step(params,
opt_state, grads)``): it packs the scaled grads that ``amp.scaled_grad``
gave into the flat fp32 stash, unscales them with the fused overflow
check, updates the loss scaler, steps the inner optimizer with the
overflow flag as its no-op, and returns ``info``.  Every piece of state
either form touches is written in place (the scalers, the moments, the
masters, ``last_info``) and neither depends on a host flag, so the
functional step can be captured in a CUDA graph and replayed.

The masters are the source of truth for the parameters.  A write of
parameter values after ``bind`` goes through :meth:`AmpOptimizer.
write_masters`, which sets the fp32 masters and re-derives the half copy
from them.  ``load_state_dict`` does so through pre-hooks that ``bind``
installs on every module that holds parameters, so a load reaches the
masters at full precision (not rounded through the half views) whether it
is called on the bound model, on one of its submodules, or on a wrapper
that holds it (``parallel.DistributedDataParallel``'s ``module.*`` keys);
``DistributedDataParallel``'s rank-0 broadcast takes the same route.

ZeRO (:meth:`AmpOptimizer.zero_shard`, the JAX package's ``init(params,
zero_axis=...)``) shards the fp32 masters and the moments over the data
ranks: each rank keeps its window of ``ceil(N / shards)`` elements of the
flat buffer, padded with zeros at the end to ``shards`` windows
(:func:`zero_optimizer_specs` gives each rank's ``(start, length)``).
Stage 1 shards over the world: the functional step reduce-scatters the
grads the caller did not reduce, updates its window and all-gathers the
new half (and fp32) params back into the buffers the model views.
Stages 2 and 3 shard over the ranks of a node (``zero_ici_size``): the
grads are reduce-scattered within the node and the 1/ici shard reduced
across nodes (in bf16 with ``zero_compress_bf16``); stage 2 gathers the
params back within the node, and stage 3 keeps none: the forward gathers
them just in time (:func:`zero_gather_params`), the backward of that
gather reduce-scatters the grads, and :func:`zero_gather_checkpoint_policy`
regathers them in the backward instead of keeping them.  The overflow flag
is taken over every rank, so a skip is every rank's.

Checkpoints.  :meth:`AmpOptimizer.state_dict` holds the loss scalers (the
JAX package's ``{"scalers": [...]}``), the inner optimizer's state fields
and the flat fp32 master buffer: what the JAX package's ``AmpOptState``
(``inner``, ``masters``, ``scalers``) carries into a checkpoint.
:meth:`AmpOptimizer.load_state_dict` writes them in place into the bound
buffers, so every parameter stays a view into them.  The model's and the
optimizer's loads may come in either order: the model's leaves a half
parameter's masters alone when the value it brings is the one they
round to, so the optimizer's full-precision masters win.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef

from .. import ops
from ..multi_tensor_apply import ChunkedFlatLayout, pack_flat
from ..multi_tensor_apply.flatten import ChunkedFlat
from ..optimizers.base import Optimizer
from .scaler import LossScaler, ScalerState
from .stateful import GradStash

__all__ = ["AmpOptimizer", "FlatMasters", "jax_leaf_order",
           "zero_optimizer_specs", "zero_gather_params",
           "zero_gather_checkpoint_policy"]

_SCALER_FIELDS = {"loss_scale": torch.float32, "unskipped": torch.int32,
                  "steps_skipped": torch.int32}


def _state_to_dict(state: Any) -> Any:
    """An optimizer state (a dataclass of tensors, moments over a layout,
    a wrapped optimizer's state) as nested dicts of tensors; layouts,
    which the bound optimizer rebuilds, are left out."""
    if dataclasses.is_dataclass(state):
        return {f.name: _state_to_dict(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if not isinstance(getattr(state, f.name), ChunkedFlatLayout)}
    if isinstance(state, ChunkedFlat):
        return state.buf
    return state


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
            or src.dtype != dst.dtype:
        got = (f"{tuple(src.shape)} {src.dtype}"
               if isinstance(src, torch.Tensor) else type(src).__name__)
        raise ValueError(f"{what}: the checkpoint holds {got}, the bound "
                         f"optimizer {tuple(dst.shape)} {dst.dtype} (another "
                         f"model or layout)")
    dst.copy_(src)


def _load_state(state: Any, sd: Any, what: str) -> None:
    """Copy ``sd`` (from :func:`_state_to_dict`) into ``state`` in place."""
    for f in dataclasses.fields(state):
        cur = getattr(state, f.name)
        if isinstance(cur, ChunkedFlatLayout):
            continue
        if not isinstance(sd, Mapping) or f.name not in sd:
            raise ValueError(f"{what}: the checkpoint has no {f.name!r}")
        new, name = sd[f.name], f"{what}.{f.name}"
        if dataclasses.is_dataclass(cur):
            _load_state(cur, new, name)
        elif isinstance(cur, ChunkedFlat):
            _copy_into(cur.buf, new, name)
        elif isinstance(cur, torch.Tensor):
            _copy_into(cur, new, name)
        elif new is not None or cur is not None:
            raise ValueError(f"{name}: the checkpoint holds "
                             f"{type(new).__name__}, the bound optimizer "
                             f"{type(cur).__name__}")


def jax_leaf_order(names: Sequence[str]) -> List[str]:
    """``jax.tree_util`` flattens nested dicts with the keys of each level
    sorted as strings (so a Bottleneck's leaves go bn1, bn2, bn3, conv1,
    ..., downsample, and a Sequential's child "10" comes before "2").
    Sorting dotted names by their tuple of components gives that order."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class _FlatLayout(ChunkedFlatLayout):
    """The dense flat layout of the named parameters in the JAX package's
    leaf order, computed once at bind; as a ``ChunkedFlatLayout`` it also
    tells a non-elementwise optimizer where each tensor lies."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]]):
        by_name = dict(named_params)
        self.names = tuple(jax_leaf_order(by_name))
        super().__init__([by_name[n] for n in self.names])
        halves = {d for d, f in zip(self.dtypes, self.is_float)
                  if f and d != torch.float32}
        # the single non-fp32 float dtype (O2's cast_model_type), if any:
        # the optimizer's kernel writes the half model copy in its pass
        self.half_dtype = halves.pop() if len(halves) == 1 else None

    def pieces(self, flat: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """Per-leaf views of a flat buffer (None for non-float leaves)."""
        return self.unpack(flat, cast_like=False)


class FlatMasters:
    """fp32 master weights as one flat buffer, the optional flat half
    copy the model's half parameters view, and their layout.  Under ZeRO
    ``buf`` is this rank's window, ``half`` (stages 1 and 2) the whole
    padded half buffer and ``full`` the padded fp32 buffer the model's
    fp32 parameters view (when it has any, or no half dtype)."""

    def __init__(self, buf: torch.Tensor, half: Optional[torch.Tensor],
                 layout: _FlatLayout, full: Optional[torch.Tensor] = None,
                 zero: Optional["ZeroShard"] = None):
        self.buf = buf
        self.half = half
        self.layout = layout
        self.full = full
        self.zero = zero

    def as_list(self) -> List[torch.Tensor]:
        if self.zero is not None:
            raise RuntimeError(
                "masters are ZeRO-sharded: all_gather the buffer over the "
                "shard group and cut it to layout.total before unpacking")
        return [p for p in self.layout.pieces(self.buf) if p is not None]


def _validate_zero_knobs(zero_stage: int, zero_ici_size,
                         compress: bool) -> None:
    if zero_stage not in (1, 2, 3):
        raise ValueError(f"zero_stage must be 1, 2 or 3, got {zero_stage!r}")
    if zero_stage >= 2 and zero_ici_size is None:
        raise ValueError(
            f"ZeRO stage {zero_stage} shards over the node level of the "
            f"hierarchical fabric; pass zero_ici_size= (ranks a node)")
    if compress and zero_stage < 2:
        raise ValueError(
            "zero_compress_bf16 compresses the cross-node hop of the "
            "stage-2/3 grad reduction; stage 1 shards over the whole world "
            "and has no such hop to shrink")


def _zero3_gather_tables(layout: _FlatLayout, ici: int):
    """The index tables of the ZeRO-3 gather (the JAX package's, as numpy):
    the gather runs in the half dtype, and the elements of parameters
    that stay fp32 ride a second small gather, each rank sending its own
    through a row of ``idx`` padded to the largest count ``M``.  Returns
    ``(idx [ici, max(M, 1)] local indices, rebuild [n32] indices into the
    gathered [ici * max(M, 1)] buffer, n32, M)``."""
    padded = -(-layout.total // ici) * ici
    shard = padded // ici
    half = layout.half_dtype
    pos: List[int] = []
    for dt, f, off, n in zip(layout.dtypes, layout.is_float,
                             layout.offsets, layout.sizes):
        if f and dt != half:
            pos.extend(range(off, off + n))
    per = [[p - d * shard for p in pos if d * shard <= p < (d + 1) * shard]
           for d in range(ici)]
    m_max = max((len(p) for p in per), default=0)
    idx = np.zeros((ici, max(m_max, 1)), np.int64)
    rebuild = np.zeros(len(pos), np.int64)
    k = 0
    for d, p in enumerate(per):
        idx[d, :len(p)] = p
        for slot in range(len(p)):
            rebuild[k] = d * max(m_max, 1) + slot
            k += 1
    return idx, rebuild, len(pos), m_max


def _zero_windows(total: int, stage: int, ici: Optional[int],
                  world: int) -> Tuple[int, int]:
    """``(shards, window length)`` of a ZeRO layout of ``total`` elements:
    the windows split the world for stage 1 and a node of ``ici`` ranks
    for stages 2 and 3; rank ``r`` holds window ``r % shards``."""
    shards = world if stage == 1 else int(ici)
    if world % shards:
        raise ValueError(f"zero_ici_size {shards} must divide the world "
                         f"size {world}")
    return shards, -(-total // shards)


class ZeroShard:
    """Where this rank's ZeRO window lies: the stage, the group the
    windows split (the world for stage 1, the node for 2 and 3), the
    cross-node group, this rank's window index and the window length."""

    def __init__(self, layout: _FlatLayout, stage: int, ici: Optional[int],
                 compress: bool, world: int, rank: int, group=None):
        from ..parallel import topology
        self.stage, self.compress, self.world = stage, compress, world
        self.shards, self.shard_n = _zero_windows(layout.total, stage, ici,
                                                  world)
        self.index = rank % self.shards
        if stage >= 2:
            self.ici = self.shards
            self.group, self.dcn_group = topology.hierarchical_groups(
                self.ici, world, None if group is None
                else dist.get_process_group_ranks(group))
        else:
            self.ici = None
            self.group, self.dcn_group = group, None
        # the group the overflow flag is maxed over: every rank that
        # holds a window of the model
        self.all_group = group
        self.padded = self.shard_n * self.shards

    def window(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.index * self.shard_n:(self.index + 1) * self.shard_n]


def zero_optimizer_specs(optimizer: "AmpOptimizer", zero_stage: int = 1,
                         zero_ici_size: Optional[int] = None,
                         zero_compress_bf16: bool = False
                         ) -> List[Tuple[int, int]]:
    """Each rank's ``(start, length)`` window of the flat master and moment
    buffers under :meth:`AmpOptimizer.zero_shard` with these knobs (the
    JAX package's PartitionSpecs of a ZeRO state): one pair a rank of the
    world, ``length`` the window with its share of the end padding.  The
    knobs are checked as ``zero_shard`` checks them."""
    optimizer._require_bound()
    optimizer._require_zero_capable()
    _validate_zero_knobs(zero_stage, zero_ici_size, zero_compress_bf16)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shards, n = _zero_windows(optimizer.masters.layout.total, zero_stage,
                              zero_ici_size, world)
    return [((r % shards) * n, n) for r in range(world)]


class AmpOptimizer:
    """Wraps a port optimizer with loss scaling and flat fp32 masters, in
    the torch shape::

        with amp.scale_loss(loss, optimizer) as scaled_loss:
            scaled_loss.backward()
        optimizer.step()
        optimizer.zero_grad()

    or in the JAX package's functional shape::

        loss, grads = amp.scaled_grad(loss_fn, optimizer, x, y)
        info = optimizer.step(grads)

    After each step, ``last_info`` holds ``found_inf``, ``loss_scale``,
    ``steps_skipped`` and ``grad_norm`` (the l2norm of the unscaled
    grads) as 0-d device tensors, allocated at ``bind`` and rewritten in
    place by every step."""

    def __init__(self, inner: Optimizer, scaler: LossScaler,
                 master_weights: bool, num_losses: int = 1):
        self.inner = inner
        self.scaler = scaler
        self.master_weights = bool(master_weights)
        self.num_losses = int(num_losses)
        self.masters: Optional[FlatMasters] = None
        self.state = None
        self.scalers: List[ScalerState] = []
        self.last_info: Dict[str, torch.Tensor] = {}
        self._params: List[torch.nn.Parameter] = []
        self._stash: Optional[GradStash] = None
        self._zero: Optional[ZeroShard] = None

    # -- set-up ---------------------------------------------------------------
    def bind(self, model: torch.nn.Module) -> None:
        if self.masters is not None:
            raise RuntimeError("this optimizer is already bound to a model")
        named = list(model.named_parameters())
        if not named:
            raise ValueError("the model has no parameters")
        layout = _FlatLayout(named)
        by_name = dict(named)
        params = [by_name[n] for n in layout.names]
        device = params[0].device
        buf = layout.pack([p.detach() for p in params])
        half = (None if layout.half_dtype is None
                else buf.to(layout.half_dtype))
        # the model's parameters become views into the flat buffers (the
        # casts above are exact: fp32 holds every bf16/fp16 value)
        for p, p32, ph in zip(params, layout.pieces(buf),
                              layout.pieces(half) if half is not None
                              else [None] * len(params)):
            p.data = p32 if p.dtype == torch.float32 else ph
        self.masters = FlatMasters(buf, half, layout)
        # an optimizer with per-tensor semantics (LAMB, LARC) also gets the
        # tensor boundaries (the JAX package gives it the master tree)
        self.state = (self.inner.init(buf) if self.inner.elementwise
                      else self.inner.init(buf, layout))
        self.scalers = [self.scaler.init_state(device)
                        for _ in range(self.num_losses)]
        self._params = params
        self._stash = GradStash(layout.total, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.last_info = {
            "found_inf": torch.zeros((), **f32),
            "loss_scale": torch.zeros((), **f32),
            "steps_skipped": torch.zeros((), dtype=torch.int32,
                                         device=device),
            "grad_norm": torch.zeros((), **f32)}
        # without masters the update starts from the half params each step
        # (the JAX package's no-master path): the spans to refresh
        self._half_spans = [
            (off, n) for d, off, n in zip(layout.dtypes, layout.offsets,
                                          layout.sizes)
            if d == layout.half_dtype and n]
        self._index = {n: i for i, n in enumerate(layout.names)}
        model._amp_optimizer = self
        for mname, mod in model.named_modules():
            if any(p is not None for p in mod._parameters.values()):
                mod.register_load_state_dict_pre_hook(functools.partial(
                    self._load_state_dict_hook, mname + "." if mname else ""))

    # -- ZeRO -----------------------------------------------------------------
    def _require_zero_capable(self) -> None:
        if not (self.master_weights and self.inner.elementwise):
            raise ValueError("zero_axis requires master weights and an "
                             "elementwise inner optimizer (the flat-buffer "
                             "path)")

    def zero_shard(self, zero_stage: int = 1,
                   zero_ici_size: Optional[int] = None,
                   zero_compress_bf16: bool = False,
                   process_group=None) -> None:
        """Shard the masters and the moments over the ranks of the default
        group (the JAX package's ``init(params, zero_axis=...,
        zero_stage, zero_ici_size, zero_compress_bf16)``; see the module
        doc).  Call after ``amp.initialize`` (and after the data-parallel
        wrapper's broadcast, if any), on every rank.  The moments start
        fresh on the window, as the JAX package's init makes them.  From
        then on the step is the functional one, ``step(grads)`` with the
        caller's un-reduced grads (stage 3: the grad window that
        ``amp.scaled_grad`` takes through :func:`zero_gather_params`);
        under stage 3 the model keeps no parameters: its forward runs
        through ``torch.func.functional_call`` on
        :func:`zero_gather_params`.

        ``process_group``: the group whose ranks share the model (``None``:
        the default group) — what an elastic run shrunk onto its
        survivors shards over.  Stage 1 splits the windows over its ranks;
        stages 2 and 3 over the node groups of ``zero_ici_size`` of its
        ranks (``topology.hierarchical_groups(..., ranks=)``), so the node
        shrinks with the world.  Make those groups on every rank before
        the shrink (see ``fleet.ElasticTrainer``)."""
        self._require_bound()
        self._require_zero_capable()
        _validate_zero_knobs(zero_stage, zero_ici_size, zero_compress_bf16)
        if self._zero is not None:
            raise RuntimeError("the optimizer state is already ZeRO-sharded")
        m = self.masters
        lay = m.layout
        if not dist.is_initialized():
            raise RuntimeError("zero_shard needs torch.distributed: call "
                               "apex_tpu_torch.parallel.init_process_group() "
                               "first")
        z = ZeroShard(lay, zero_stage, zero_ici_size, zero_compress_bf16,
                      dist.get_world_size(process_group),
                      dist.get_rank(process_group), process_group)
        dev = m.buf.device
        pad = z.padded - lay.total

        def padded(t):
            return torch.cat([t, t.new_zeros(pad)]) if pad else t.clone()
        shard = z.window(padded(m.buf)).clone()
        half = full = None
        if zero_stage < 3:
            if m.half is not None:
                half = padded(m.half)
            if m.half is None or any(
                    f and d == torch.float32
                    for f, d in zip(lay.is_float, lay.dtypes)):
                full = padded(m.buf)
        for p, p32, ph in zip(self._params,
                              lay.pieces(full) if full is not None
                              else [None] * len(self._params),
                              lay.pieces(half) if half is not None
                              else [None] * len(self._params)):
            if zero_stage == 3:
                # the forward gathers them: the model keeps none
                p.data = torch.empty(0, dtype=p.dtype, device=dev)
            else:
                p.data = p32 if p.dtype == torch.float32 else ph
        self.masters = FlatMasters(shard, half, lay, full=full, zero=z)
        self.state = self.inner.init(shard)
        self._zero = z
        # the functional step packs into the padded buffer; the stash of
        # the eager step goes (the sharded step has none)
        self._stash = None
        self._zero_flat = (torch.zeros(z.padded, dtype=torch.float32,
                                       device=dev)
                           if zero_stage < 3 else None)
        if zero_stage == 3:
            # the leaf amp.scaled_grad differentiates: the window itself
            self._zero_leaf = shard.detach().requires_grad_()
            if lay.half_dtype is not None:
                idx, rebuild, n32, _ = _zero3_gather_tables(lay, z.shards)
                self._zero_tables = (torch.from_numpy(idx[z.index]).to(dev),
                                     torch.from_numpy(rebuild).to(dev), n32)
            self._zero_live: Dict[StorageWeakRef, str] = {}
            self.zero_dropped_saves = 0
            self._zero_regathered: Dict[str, torch.Tensor] = {}

    def _zero_gather_buffers(self, shard: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
        """The ZeRO-3 gather: ``{"half": the padded half buffer, "exact":
        the fp32 parameters' elements}``, or ``{"full": the padded fp32
        buffer}`` when the layout has no half dtype."""
        z, lay = self._zero, self.masters.layout
        half = lay.half_dtype
        if half is None:
            full = shard.new_empty(z.padded)
            dist.all_gather_into_tensor(full, shard, group=z.group)
            return {"full": full}
        fullh = torch.empty(z.padded, dtype=half, device=shard.device)
        dist.all_gather_into_tensor(fullh, shard.to(half), group=z.group)
        out = {"half": fullh}
        row, rebuild, n32 = self._zero_tables
        if n32:
            aux = shard[row]
            g32 = aux.new_empty(z.shards * aux.shape[0])
            dist.all_gather_into_tensor(g32, aux, group=z.group)
            out["exact"] = g32[rebuild]
        return out

    def _zero_leaves(self, bufs: Dict[str, torch.Tensor]
                     ) -> List[torch.Tensor]:
        lay = self.masters.layout
        out, ex_off = [], 0
        for shape, dt, off, n in zip(lay.shapes, lay.dtypes, lay.offsets,
                                     lay.sizes):
            if "full" in bufs:
                out.append(bufs["full"][off:off + n].view(shape).to(dt))
            elif dt == lay.half_dtype:
                out.append(bufs["half"][off:off + n].view(shape))
            else:
                out.append(bufs["exact"][ex_off:ex_off + n].view(shape)
                           .to(dt))
                ex_off += n
        return out

    # -- parameter values after bind ------------------------------------------
    def refresh_masters(self) -> None:
        """Without master weights the half params are the source of truth:
        copy them into the masters' spans (the no-master path's update
        starts from them).  With master weights, nothing to do."""
        self._require_bound()
        if not self.master_weights:
            m = self.masters
            for off, n in self._half_spans:
                m.buf[off:off + n].copy_(m.half[off:off + n])

    def write_masters(self, values: Mapping[str, torch.Tensor]) -> None:
        """Set parameter values after ``bind``: ``values`` maps parameter
        names (as the bound model's ``named_parameters`` gives them) to
        tensors; names of no parameter, and ``None`` values, are ignored.
        Each value is written into the fp32 masters, then its span of the
        half copy, which the model's half parameters view, is re-derived
        from the masters."""
        self._require_bound()
        if self._zero is not None:
            raise RuntimeError("the optimizer state is ZeRO-sharded: write "
                               "the parameters before zero_shard")
        m = self.masters
        lay = m.layout
        for name, v in values.items():
            i = self._index.get(name)
            if v is None or i is None or not lay.is_float[i]:
                continue
            off, n = lay.offsets[i], lay.sizes[i]
            m.buf[off:off + n].copy_(v.detach().reshape(-1))
            if m.half is not None:
                m.half[off:off + n].copy_(m.buf[off:off + n])

    def _load_state_dict_hook(self, qualified: str, module, state_dict,
                              prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs) -> None:
        """``module``'s own parameters: ``prefix + name`` in the state dict
        is the bound model's ``qualified + name``."""
        if local_metadata.get("assign_to_params_buffers", False):
            raise RuntimeError("load_state_dict(assign=True) would replace "
                               "the parameters, which are views into the "
                               "optimizer's flat buffers after "
                               "amp.initialize")
        values = {}
        for name, p in module._parameters.items():
            v = state_dict.get(prefix + name)
            # a mismatched shape is left to the default load to report
            if (p is None or not isinstance(v, torch.Tensor)
                    or v.shape != p.shape):
                continue
            # a half parameter loaded with the value it holds: its masters
            # already round to it, and keep their precision
            if p.dtype != torch.float32 and torch.equal(
                    v.detach().to(p.device, p.dtype), p.detach()):
                continue
            values[qualified + name] = v
        self.write_masters(values)

    def _require_bound(self) -> None:
        if self.masters is None:
            raise RuntimeError("AmpOptimizer is not bound to a model: get it "
                               "from amp.initialize(model, optimizer)")

    # -- checkpoints ------------------------------------------------------------
    def scalers_state_dict(self) -> List[Dict[str, torch.Tensor]]:
        """The loss scalers as the JAX package's ``amp.state_dict`` holds
        them: one ``{"loss_scale", "unskipped", "steps_skipped"}`` a loss."""
        self._require_bound()
        return [{k: getattr(s, k) for k in _SCALER_FIELDS}
                for s in self.scalers]

    def load_scalers_state_dict(self, scalers) -> None:
        self._require_bound()
        if len(scalers) != self.num_losses:
            raise ValueError(f"{len(scalers)} loss scalers for "
                             f"{self.num_losses} losses")
        # in place: a captured step reads these tensors' addresses
        for s, d in zip(self.scalers, scalers):
            for k, dt in _SCALER_FIELDS.items():
                t = getattr(s, k)
                t.copy_(torch.as_tensor(d[k]).to(device=t.device, dtype=dt))

    def state_dict(self) -> Dict[str, Any]:
        """``{"scalers": [...], "inner": {...}, "masters": buf}``: the loss
        scalers, the inner optimizer's state fields (FusedAdam's ``step``,
        ``m``, ``v``; LAMB's, SGD's, LARC's) and the flat fp32 master
        buffer.  References to the live tensors, as ``torch.optim``
        gives; ``torch.save`` them, or clone, before the next step."""
        self._require_bound()
        return {"scalers": self.scalers_state_dict(),
                "inner": _state_to_dict(self.state),
                "masters": self.masters.buf}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Load what :meth:`state_dict` gave, in place: the masters into the
        flat buffer (and the half copy re-derived from them), the inner
        state into its tensors, and the scalers.  Raises ``ValueError`` on
        a checkpoint of another layout.  A ``None`` master buffer (a JAX
        run without masters, see ``utils.jax_interop``) leaves the
        parameters to the model's own ``load_state_dict``."""
        self._require_bound()
        m = self.masters
        if sd.get("masters") is not None:
            _copy_into(m.buf, sd["masters"], "masters")
            if self._zero is not None:
                self._zero_gather_params()
            elif m.half is not None:
                m.half.copy_(m.buf)
        _load_state(self.state, sd["inner"], "inner")
        self.load_scalers_state_dict(sd["scalers"])

    def loss_scale(self, loss_id: int = 0) -> torch.Tensor:
        """The loss scale of ``loss_id`` now, as a 0-d device tensor: a
        copy, since the scaler's own tensor changes in place each step."""
        self._require_bound()
        return self.scalers[loss_id].loss_scale.clone()

    # -- driven by amp.scale_loss ----------------------------------------------
    def _prepare_backward(self) -> None:
        self._require_bound()
        if self._zero is not None:
            raise RuntimeError("a ZeRO-sharded optimizer steps through the "
                               "functional step: amp.scaled_grad, then "
                               "optimizer.step(grads)")
        for p in self._params:
            p.grad = None

    def _post_backward(self, loss_id: int, delay_unscale: bool) -> None:
        self._stash.add(self._params, self.scaler, self.scalers[loss_id])
        if not delay_unscale:
            self.scaler.update_(self.scalers[loss_id],
                                self._stash.found_inf)

    # -- torch-shaped methods ---------------------------------------------------
    def zero_grad(self, set_to_none: bool = True) -> None:
        self._require_bound()
        for p in self._params:
            p.grad = None
        if self._stash is not None:
            self._stash.clear()

    def step(self, scaled_grads=None, loss_id: int = 0,
             found_inf_extra: Optional[torch.Tensor] = None,
             found_inf_axes: Optional[Sequence[Any]] = None,
             grad_health: Any = None):
        """With no argument, the torch shape: step on the grads that
        ``amp.scale_loss`` stashed (and return ``None``).

        With ``scaled_grads``, the JAX package's functional step
        (``_process_optimizer.py:584-815`` there): grads of ``loss *
        loss_scale`` with respect to the bound parameters, as
        ``amp.scaled_grad`` returns them: a list in the layout's order
        (``masters.layout.names``) or a mapping of those names to tensors
        (``None`` is a zero grad).  They are packed into the flat fp32
        stash, unscaled by the scaler of ``loss_id`` with the fused
        overflow check (OR-ed with ``found_inf_extra``, a 0-d flag of
        other overflow sources), the scaler is updated in place, and the
        inner optimizer steps with the overflow flag as its no-op.
        Returns ``info``, a new dict of copies of ``last_info``'s tensors
        (``found_inf``, ``loss_scale``, ``steps_skipped`` and
        ``grad_norm``), as the JAX step returns new arrays: the next step
        rewrites ``last_info`` in place, not the caller's ``info``.

        ``found_inf_axes``: process groups (or JAX axis names, which stand
        for the default group) whose ranks hold disjoint parameter shards
        (tensor parallelism): the overflow flag is all-reduced with MAX
        over each, on the device, so every shard skips together and the
        loss scales stay in lockstep.  A group of one rank, or no
        ``torch.distributed``, is skipped.

        ``grad_health``: an enabled
        ``observability.numerics.NumericsMonitor`` built over the bound
        parameters (``NumericsMonitor(model)``): per-layer nonfinite /
        abs-max / norm / underflow stats of the scaled grads, at the
        scaler's CURRENT loss scale, come back as
        ``info["grad_health"]`` (segment reductions over the packed flat
        fp32 stash, read before the in-place unscale: the JAX package's
        per-leaf fp32 numbers, summed in another order).  ``None`` or a
        disabled monitor computes nothing and the key is absent.  Under
        ZeRO stages 1 and 2 the stats are of this rank's local grads,
        before the reduce-scatter; ZeRO-3's step takes a grad window, so
        there it raises."""
        self._require_bound()
        if scaled_grads is None:
            if (found_inf_extra is not None or loss_id != 0
                    or found_inf_axes or grad_health is not None):
                raise TypeError("loss_id, found_inf_extra, found_inf_axes "
                                "and grad_health belong to the functional "
                                "step: step(scaled_grads, ...)")
            self._eager_step()
            return None
        if grad_health is not None and not getattr(grad_health, "enabled",
                                                   True):
            grad_health = None
        if self._zero is not None:
            health = self._zero_step(scaled_grads, loss_id, found_inf_extra,
                                     found_inf_axes, grad_health)
            info = {k: t.clone() for k, t in self.last_info.items()}
            if health is not None:
                info["grad_health"] = health
            return info
        grads = self._stash.grads
        pack_flat(self._grad_list(scaled_grads), out=grads)
        sstate = self.scalers[loss_id]
        health = (None if grad_health is None
                  else grad_health.flat_stats(grads, sstate.loss_scale))
        # in place: the packed scaled grads are not needed afterwards
        _, found = self.scaler.unscale(grads, sstate, out=grads)
        if found_inf_extra is not None:
            found = torch.maximum(found, found_inf_extra.to(found.dtype))
        found = _merge_found_inf(found, found_inf_axes)
        self.scaler.update_(sstate, found)
        self._apply(grads, found, sstate)
        info = {k: t.clone() for k, t in self.last_info.items()}
        if health is not None:
            info["grad_health"] = health
        return info

    def _grad_list(self, grads) -> List[torch.Tensor]:
        """``grads`` in layout order, zeros for a missing grad."""
        if isinstance(grads, Mapping):
            names = self.masters.layout.names
            unknown = sorted(set(grads) - set(names))
            if unknown:
                raise KeyError(f"grads of no bound parameter: {unknown[:8]}")
            grads = [grads.get(n) for n in names]
        grads = list(grads)
        if len(grads) != len(self._params):
            raise ValueError(f"{len(grads)} grads for {len(self._params)} "
                             f"bound parameters")
        out = []
        for g, p in zip(grads, self._params):
            if g is None:
                g = torch.zeros_like(p)
            elif g.shape != p.shape:
                raise ValueError(f"a grad of shape {tuple(g.shape)} for a "
                                 f"parameter of shape {tuple(p.shape)}")
            out.append(g)
        return out

    def _zero_step(self, scaled_grads, loss_id: int,
                   found_inf_extra: Optional[torch.Tensor],
                   found_inf_axes=None, grad_health=None
                   ) -> Optional[Dict[str, torch.Tensor]]:
        """The sharded functional step (``_process_optimizer.py:633-808``
        of the JAX package): reduce the grads to this rank's window, take
        the mean over the world, unscale with the overflow flag taken over
        every rank, update the window, gather the params back."""
        z = self._zero
        if not dist.is_initialized():
            raise RuntimeError("optimizer state is ZeRO-sharded but step() "
                               "was called outside its process group")
        m = self.masters
        health = None
        if z.stage == 3:
            if grad_health is not None:
                raise ValueError(
                    "grad_health needs the whole gradient tree; the ZeRO-3 "
                    "step takes this rank's grad window")
            g = scaled_grads
            if (not isinstance(g, torch.Tensor) or g.dim() != 1
                    or g.shape != m.buf.shape):
                got = (tuple(g.shape) if isinstance(g, torch.Tensor)
                       else type(g).__name__)
                raise ValueError(f"ZeRO-3 step expects the flat grad shard "
                                 f"the zero_gather_params backward gives "
                                 f"(shape {tuple(m.buf.shape)}), got {got}")
            shard = g.float()
        else:
            flat = self._zero_flat
            pack_flat(self._grad_list(scaled_grads),
                      out=flat[:m.layout.total])
            if grad_health is not None:
                health = grad_health.flat_stats(
                    flat[:m.layout.total], self.scalers[loss_id].loss_scale)
            shard = torch.empty(z.shard_n, dtype=torch.float32,
                                device=flat.device)
            dist.reduce_scatter_tensor(shard, flat, group=z.group)
        if z.stage >= 2:
            if z.compress:
                wire = torch.empty(z.world // z.ici * z.shard_n,
                                   dtype=torch.bfloat16, device=shard.device)
                dist.all_gather_into_tensor(wire, shard.to(torch.bfloat16),
                                            group=z.dcn_group)
                shard = wire.view(-1, z.shard_n).float().sum(0)
            else:
                dist.all_reduce(shard, group=z.dcn_group)
        grads = shard / float(z.world)
        sstate = self.scalers[loss_id]
        _, found = self.scaler.unscale(grads, sstate, out=grads)
        if found_inf_extra is not None:
            found = torch.maximum(found, found_inf_extra.to(found.dtype))
        # each rank saw its window only: the skip must be every rank's
        dist.all_reduce(found, op=dist.ReduceOp.MAX, group=z.all_group)
        found = _merge_found_inf(found, found_inf_axes)
        self.scaler.update_(sstate, found)
        sq = (grads * grads).sum()
        dist.all_reduce(sq, group=z.group)
        # the kernel writes the half copy of the window in place
        half = None if m.half is None else z.window(m.half)
        self.inner.step(m.buf, self.state, grads, half=half, noop=found)
        self._zero_gather_params(half_written=True)
        info = self.last_info
        info["found_inf"].copy_(found)
        info["loss_scale"].copy_(sstate.loss_scale)
        info["steps_skipped"].copy_(sstate.steps_skipped)
        info["grad_norm"].copy_(torch.sqrt(sq))
        return health

    def _zero_gather_params(self, half_written: bool = False) -> None:
        """Stages 1 and 2: the model's params gathered from the windows
        (a skipped step gathers what every rank already holds); the half
        copy of this rank's window re-derived first unless
        ``half_written``."""
        m, z = self.masters, self._zero
        if z.stage == 3:
            return
        if m.full is not None:
            dist.all_gather_into_tensor(m.full, m.buf, group=z.group)
        if m.half is not None:
            win = z.window(m.half)
            if not half_written:
                win.copy_(m.buf)
            # in place: the window is this rank's part of the output
            dist.all_gather_into_tensor(m.half, win, group=z.group)

    def _eager_step(self) -> None:
        if not self._stash.has_grads:
            raise RuntimeError("step() called before backward()")
        stash = self._stash
        self._apply(stash.grads, stash.found_inf, self.scalers[0])
        stash.clear()

    def _apply(self, grads: torch.Tensor, found: torch.Tensor,
               sstate: ScalerState) -> None:
        """The inner step on the unscaled flat fp32 ``grads``, skipped on
        the device when ``found`` is set; ``last_info`` written."""
        masters = self.masters
        # of the unscaled fp32 grads, before the no-master path rounds them
        grad_norm = ops.multi_tensor_l2norm(grads)
        if not self.master_weights:
            self.refresh_masters()   # the update starts from the half params
            for off, n in self._half_spans:
                grads[off:off + n] = grads[off:off + n].to(
                    masters.half.dtype).float()
        self.inner.step(masters.buf, self.state, grads, half=masters.half,
                        noop=found)
        info = self.last_info
        info["found_inf"].copy_(found)
        info["loss_scale"].copy_(sstate.loss_scale)
        info["steps_skipped"].copy_(sstate.steps_skipped)
        info["grad_norm"].copy_(grad_norm)


def _merge_found_inf(found: torch.Tensor, axes) -> torch.Tensor:
    """``found`` all-reduced with MAX over each group of ``axes`` that has
    more than one rank (the JAX step's ``pmax`` over ``found_inf_axes``)."""
    if not axes:
        return found
    from ..parallel.tensor_parallel import axis_group
    for ax in axes:
        g = axis_group(ax)
        if g is not None and dist.get_world_size(g) > 1:
            found = found.clone()
            dist.all_reduce(found, op=dist.ReduceOp.MAX, group=g)
    return found


class _Gather(torch.autograd.Function):
    """ZeRO-3's just-in-time parameters: the forward all-gathers the
    master window within the shard group (in the half dtype, the fp32
    parameters' elements exactly) and cuts the leaves; the backward packs
    their grads into one fp32 buffer and reduce-scatters it, which is the
    grad window the step takes."""

    @staticmethod
    def forward(ctx, leaf, opt):
        ctx.opt = opt
        bufs = opt._zero_gather_buffers(leaf.detach())
        # weak references to the gathered storages: a live storage matches
        # one only if it is that storage (the reference holds its address)
        opt._zero_live = {StorageWeakRef(t.untyped_storage()): k
                          for k, t in bufs.items()}
        opt.zero_dropped_saves = 0
        return tuple(opt._zero_leaves(bufs))

    @staticmethod
    def backward(ctx, *cts):
        opt = ctx.opt
        z, lay = opt._zero, opt.masters.layout
        opt._zero_regathered = {}
        flat = torch.zeros(z.padded, dtype=torch.float32,
                           device=opt.masters.buf.device)
        for ct, off, n in zip(cts, lay.offsets, lay.sizes):
            if ct is not None:
                flat[off:off + n].copy_(ct.reshape(-1))
        shard = torch.empty(z.shard_n, dtype=torch.float32,
                            device=flat.device)
        dist.reduce_scatter_tensor(shard, flat, group=z.group)
        return shard, None


def zero_gather_params(optimizer: AmpOptimizer) -> Dict[str, torch.Tensor]:
    """ZeRO-3's parameters for one forward (``apex_tpu/amp/
    _process_optimizer.py:164-335``): the masters gathered within the
    shard group and cut into the model's parameters, ``{name: tensor}``
    for ``torch.func.functional_call``.  ``amp.scaled_grad`` then
    differentiates the loss with respect to the master window, whose grad
    (the backward of the gather: a reduce-scatter) is what
    ``optimizer.step`` takes.  Wrap the forward in
    :func:`zero_gather_checkpoint_policy` so the backward regathers these
    instead of keeping them."""
    optimizer._require_bound()
    z = optimizer._zero
    if z is None or z.stage != 3:
        raise RuntimeError("zero_gather_params requires a ZeRO-3 layout "
                           "(zero_shard(zero_stage=3)); stages 1/2 gather "
                           "inside the step itself")
    leaves = _Gather.apply(optimizer._zero_leaf, optimizer)
    return dict(zip(optimizer.masters.layout.names, leaves))


def zero_gather_checkpoint_policy(optimizer: AmpOptimizer):
    """A context for a ZeRO-3 forward (the JAX package's remat policy,
    ``:145``): every tensor the forward saves for the backward is kept,
    except views of the parameters :func:`zero_gather_params` gathered,
    which the backward gathers again from the master window when it first
    needs them.  So the gathered parameters are not kept alive from the
    forward into the backward; ``optimizer.zero_dropped_saves`` counts the
    saves of the last forward that were dropped so.  A view is known by
    its storage (held weakly), never by its address, so a tensor the loss
    head makes where a gathered buffer was freed is kept::

        with amp.zero_gather_checkpoint_policy(optimizer):
            loss = loss_fn(functional_call(model,
                                           amp.zero_gather_params(optimizer),
                                           (x,)))
    """
    def pack(t):
        key = optimizer._zero_live.get(StorageWeakRef(t.untyped_storage()))
        if key is None:
            return t
        optimizer.zero_dropped_saves += 1
        return (key, t.storage_offset(), tuple(t.shape), t.stride())

    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        key, offset, shape, stride = saved
        again = optimizer._zero_regathered
        if not again:
            again.update(optimizer._zero_gather_buffers(
                optimizer.masters.buf))
        return again[key].as_strided(shape, stride, offset)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)
