"""Weights between the JAX package's trees and the port's ``state_dict``.

Numpy only: the JAX package's ``(params, state)`` come in as nested dicts
of numpy arrays (``np.asarray`` of each leaf) and go out the same way.
``params`` is nested by module (``{"layer1": {"0": {"bn1": {"weight":
...}}}}``); ``state`` is flat, keyed by module path (``{"layer1.0.bn1":
{"running_mean": ..., ...}}``).  The port's names join the two with dots
(``layer1.0.bn1.weight``, ``layer1.0.bn1.running_mean``), and dtypes are
kept as they are, bfloat16 included.

A LAMB state goes across too (:func:`lamb_state_from_jax`,
:func:`lamb_state_to_jax`): the JAX package's moments are flat buffers in
which every tensor is padded to a multiple of the chunk (1024), the
port's are dense (``multi_tensor_apply.ChunkedFlatLayout``), so each
tensor's slice moves and the padding, zeros, is dropped or restored.

An amp optimizer's state goes across as well (:func:`amp_state_from_jax`,
:func:`amp_state_to_jax`): the JAX package's ``AmpOptState`` (its loss
scalers, the inner optimizer's state, the masters: a flat buffer, a
master tree for LAMB, or none) as the dict that ``AmpOptimizer.
load_state_dict`` takes, and back.  The JAX side is read by attribute
(``opt_state.scalers``, ``.inner``, ``.masters``) and ``np.asarray``, so
nothing here imports it.

A ZeRO-sharded state goes across a rank at a time
(:func:`zero_state_from_jax`, :func:`zero_state_to_jax`): the JAX
package's global buffers are its devices' windows side by side, each
rank's the piece at its index.

Tensor and expert parallelism: the JAX package's parameters are
full-size and ``shard_map`` slices them; a port model holds a rank's
shards, which :func:`tp_shard` cuts from a full state dict
(``params_from_jax``'s) by ``parallel.tensor_parallel.partition_specs``.
A tensor-parallel optimizer state is laid out as ZeRO's (the model
group's buffers side by side, ``sharded_optimizer_specs``), so
:func:`zero_state_from_jax` and :func:`zero_state_to_jax` carry it a rank
at a time, with the rank's index in its model group.

The decoders' and T5's weights need nothing more: ``models.GPT``,
``models.Llama`` and ``models.T5`` name their parameters by the JAX
trees' paths (a tied head is the one table).  A KV cache goes across with
:func:`kv_cache_from_jax` and :func:`kv_cache_to_jax`: ``{layer: {"k",
"v"}}``, plus ``"k_scale"``/``"v_scale"`` for an int8 cache, the same
layout (B, n_kv_head, S, D) and dtypes on both sides; T5's serving state
(``init_seq2seq_state``'s ``{"cross", "dec", "src_mask"}``) goes the
same way.

Weight-only int8 weights: a JAX ``quantization.QTensor`` leaf goes into
the state dict as ``<path>.data`` and ``<path>.scale`` (the port's
``QTensor`` buffers), so a quantized port model loads a quantized JAX
tree; :func:`qtensor_from_jax` and :func:`qtensor_to_jax` carry one
QTensor (data, scale, axis and logical dtype).  LoRA adapters, a flat
dict ``{path: {"a", "b"}}`` keyed alike in both packages, go across with
:func:`adapters_from_jax` and :func:`adapters_to_jax`.

The legacy surface's models name their parameters by the JAX trees'
paths as well: :func:`rnn_from_jax` carries an ``RNN`` stack's params
(``rnns.<i>.<w>``, ``fwd.``/``bwd.`` for a bidirectional one, a weight
norm's ``<name>_g``/``<name>_v``), :func:`dcgan_from_jax` a DCGAN model's
params and BatchNorm state (``main.<i>.running_mean``, ...).

Pipeline stages: the JAX package stacks the S stages' parameters on a
leading axis (``parallel.pipeline.init_stacked``); a port
``parallel.pipeline.StackedStages`` holds a rank's stage (``0.<path>``) or
all S (``<s>.<path>``).  :func:`stacked_from_jax` cuts the stages a
``StackedStages`` holds from the stacked tree, :func:`stacked_to_jax`
stacks stage state dicts back, both bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..multi_tensor_apply.flatten import ChunkedFlat, ChunkedFlatLayout
from ..optimizers.fused_lamb import LambState

__all__ = ["params_from_jax", "params_to_jax", "lamb_state_from_jax",
           "stacked_from_jax", "stacked_to_jax",
           "lamb_state_to_jax", "amp_state_from_jax", "amp_state_to_jax",
           "zero_state_from_jax", "zero_state_to_jax", "tp_shard",
           "kv_cache_from_jax", "kv_cache_to_jax", "qtensor_from_jax",
           "qtensor_to_jax",
           "adapters_from_jax", "adapters_to_jax", "rnn_from_jax",
           "dcgan_from_jax", "STATE_KEYS"]

_SCALER_KEYS = ("loss_scale", "unskipped", "steps_skipped")

# the leaves of the JAX package's BatchNorm state dict
STATE_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: a view would share the port's buffers, which its steps
    write in place, and a JAX array made from it on the CPU shares them
    too (zero copy), so a later port step would change the JAX state
    under a JAX step that has not yet run (dispatch is asynchronous)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                  # only numpy's view of bf16 needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _is_qtensor(leaf) -> bool:
    """A JAX ``quantization.QTensor``, by its attributes (``dequant``
    first: a numpy array's ``data`` is its buffer, which a bfloat16 array
    refuses to give)."""
    return all(hasattr(leaf, a) for a in ("dequant", "axis", "scale",
                                          "data"))


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(v, name, out)
        elif _is_qtensor(v):
            out[f"{name}.data"] = v.data
            out[f"{name}.scale"] = v.scale
        else:
            out[name] = v


def params_from_jax(params: Dict[str, Any],
                    state: Optional[Dict[str, Dict[str, Any]]] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` -> the port's ``state_dict`` (CPU tensors;
    ``load_state_dict`` copies them to the model's device and dtypes)."""
    flat: Dict[str, Any] = {}
    _flatten(params, "", flat)
    for path, leaves in (state or {}).items():
        for k, v in leaves.items():
            flat[f"{path}.{k}" if path else k] = v
    return {k: _to_torch(v) for k, v in flat.items()}


def rnn_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``RNN`` stack's (or ``WeightNorm``'s) params -> the port
    module's ``state_dict``: the ``rnns``/``fwd``/``bwd`` trees by path."""
    sd = params_from_jax(params)
    bad = [k for k in sd if k.rpartition(".")[2] in STATE_KEYS]
    if bad:
        raise ValueError(f"an RNN has no BatchNorm state, got {bad[:4]}")
    return sd


def dcgan_from_jax(params: Dict[str, Any],
                   state: Dict[str, Dict[str, Any]]
                   ) -> Dict[str, torch.Tensor]:
    """A JAX DCGAN ``Generator``'s or ``Discriminator``'s ``(params,
    state)`` -> the port model's ``state_dict``, BatchNorm running
    statistics and counts included (each BatchNorm must have its state)."""
    sd = params_from_jax(params, state)
    bns = {k.rpartition(".")[0] for k in sd if k.endswith(".bias")
           and sd[k.rpartition(".")[0] + ".weight"].dim() == 1}
    missing = sorted(b for b in bns if f"{b}.running_mean" not in sd)
    if missing:
        raise ValueError(f"no BatchNorm state for {missing}")
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """Inverse of :func:`params_from_jax`: the port's ``state_dict`` ->
    JAX ``(params, state)`` as numpy arrays."""
    params: Dict[str, Any] = {}
    state: Dict[str, Dict[str, Any]] = {}
    for name, t in state_dict.items():
        path, _, leaf = name.rpartition(".")
        if leaf in STATE_KEYS:
            state.setdefault(path, {})[leaf] = _to_numpy(t)
            continue
        node = params
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = _to_numpy(t)
    return params, state


def _jax_spans(layout: ChunkedFlatLayout, chunk: int):
    """(port offset, JAX offset, length) of each tensor, and the length of
    the JAX package's padded buffer."""
    spans, off = [], 0
    for o, n in layout.spans():
        spans.append((o, off, n))
        off += -(-n // chunk) * chunk
    return spans, off


def lamb_state_from_jax(state: Dict[str, Any], layout: ChunkedFlatLayout,
                        chunk: int = 1024, device="cpu") -> LambState:
    """A JAX ``LambState`` as numpy, ``{"step", "m", "v"}`` (``m`` and
    ``v`` the ``ChunkedFlat`` buffers), -> the port's ``LambState`` over
    ``layout`` (the same tensors in the same order), on ``device``."""
    spans, total = _jax_spans(layout, chunk)

    def dense(buf):
        buf = np.asarray(buf, np.float32)
        if buf.shape != (total,):
            raise ValueError(f"JAX moments of shape {buf.shape}, the layout "
                             f"pads to ({total},) at chunk {chunk}")
        out = np.zeros(layout.total, np.float32)
        for o, jo, n in spans:
            out[o:o + n] = buf[jo:jo + n]
        return ChunkedFlat(torch.from_numpy(out).to(device), layout)

    step = torch.full((), int(state["step"]), dtype=torch.int32,
                      device=device)
    return LambState(step=step, m=dense(state["m"]), v=dense(state["v"]))


def lamb_state_to_jax(state: LambState, chunk: int = 1024
                      ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`lamb_state_from_jax`: ``{"step", "m", "v"}`` as
    numpy, ``m`` and ``v`` padded as the JAX package lays them out."""
    spans, total = _jax_spans(state.m.layout, chunk)

    def padded(flat):
        buf = flat.buf.detach().cpu().numpy()
        out = np.zeros(total, np.float32)
        for o, jo, n in spans:
            out[jo:jo + n] = buf[o:o + n]
        return out

    return {"step": np.asarray(int(state.step), np.int32),
            "m": padded(state.m), "v": padded(state.v)}


def amp_state_from_jax(opt_state, layout, chunk: int = 1024,
                       device="cpu") -> Dict[str, Any]:
    """A JAX ``AmpOptState`` -> the dict ``AmpOptimizer.load_state_dict``
    takes, on ``device``.  ``layout`` is the bound optimizer's
    (``opt.masters.layout``: the same tensors in the same order).  The
    inner state is FusedAdam's, SGD's or another's with flat buffers, or
    FusedLAMB's padded moments; the masters a flat buffer, a master tree
    (LAMB), or None (no masters: the parameters come from the model's own
    state dict)."""
    def dev(a):
        return _to_torch(np.asarray(a)).to(device)

    scalers = [{k: dev(getattr(s, k)) for k in _SCALER_KEYS}
               for s in opt_state.scalers]
    inner = opt_state.inner
    if hasattr(getattr(inner, "m", None), "buf"):       # LAMB's ChunkedFlat
        lamb = lamb_state_from_jax(
            {"step": np.asarray(inner.step), "m": np.asarray(inner.m.buf),
             "v": np.asarray(inner.v.buf)}, layout, chunk, device)
        inner_sd = {"step": lamb.step, "m": lamb.m.buf, "v": lamb.v.buf}
    else:
        inner_sd = {k: None if getattr(inner, k) is None
                    else dev(getattr(inner, k)) for k in inner._fields}
    masters = opt_state.masters
    if masters is None:
        buf = None
    elif hasattr(masters, "buf"):
        buf = dev(np.asarray(masters.buf, np.float32))
    else:
        flat: Dict[str, Any] = {}
        _flatten(masters, "", flat)
        buf = torch.from_numpy(np.concatenate(
            [np.asarray(flat[n], np.float32).ravel()
             for n, f in zip(layout.names, layout.is_float) if f])).to(device)
    return {"scalers": scalers, "inner": inner_sd, "masters": buf}


def amp_state_to_jax(optimizer, chunk: int = 1024) -> Dict[str, Any]:
    """Inverse of :func:`amp_state_from_jax` for a bound ``AmpOptimizer``:
    ``{"scalers": [...], "inner": {...}, "masters": ...}`` as numpy in the
    JAX package's layout (LAMB's moments padded and its masters a tree by
    parameter path; otherwise the flat buffer).  The JAX package keeps
    no masters without master weights; drop them there."""
    sd = optimizer.state_dict()
    scalers = [{k: _to_numpy(d[k]) for k in _SCALER_KEYS}
               for d in sd["scalers"]]
    layout = optimizer.masters.layout
    if isinstance(optimizer.state, LambState):
        inner = lamb_state_to_jax(optimizer.state, chunk)
        masters: Dict[str, Any] = {}
        for name, piece in zip(layout.names,
                               layout.pieces(optimizer.masters.buf)):
            if piece is None:
                continue
            node = masters
            for part in name.split(".")[:-1]:
                node = node.setdefault(part, {})
            node[name.rpartition(".")[2]] = _to_numpy(piece)
    else:
        inner = {k: None if v is None else _to_numpy(v)
                 for k, v in sd["inner"].items()}
        masters = _to_numpy(sd["masters"])
    return {"scalers": scalers, "inner": inner, "masters": masters}


def zero_state_from_jax(opt_state, rank: int, world: int, device="cpu"
                        ) -> Dict[str, Any]:
    """Rank ``rank``'s part of a JAX ZeRO ``AmpOptState`` (the output of
    ``shard_map`` with ``amp.zero_optimizer_specs``: every flat buffer the
    concatenation of the ``world`` devices' windows, in device order) as
    the dict a ZeRO-sharded ``AmpOptimizer.load_state_dict`` takes; a
    tensor-parallel state (``tensor_parallel.sharded_optimizer_specs``)
    the same way, ``rank`` and ``world`` those of the model group.  The
    JAX package's devices of a data axis are the port's ranks in order,
    so rank ``r`` takes the ``r``-th of ``world`` equal pieces (under
    stages 2 and 3 the windows repeat once a node, as they do on the
    ranks)."""
    def piece(a):
        a = np.asarray(a)
        if a.ndim == 0:
            return _to_torch(a).to(device)
        n = a.shape[0] // world
        return _to_torch(np.ascontiguousarray(
            a[rank * n:(rank + 1) * n])).to(device)

    inner = opt_state.inner
    return {"scalers": [{k: piece(getattr(s, k)) for k in _SCALER_KEYS}
                        for s in opt_state.scalers],
            "inner": {k: None if getattr(inner, k) is None
                      else piece(getattr(inner, k)) for k in inner._fields},
            "masters": piece(np.asarray(opt_state.masters.buf, np.float32))}


def zero_state_to_jax(optimizers) -> Dict[str, Any]:
    """Inverse of :func:`zero_state_from_jax`: the ZeRO-sharded
    ``AmpOptimizer`` of every rank, in rank order (or their
    ``state_dict()``s), as numpy ``{"scalers", "inner", "masters"}`` in
    the JAX package's global layout: each flat buffer the ranks' windows
    concatenated, a scalar (the scalers, Adam's step) rank 0's, which is
    every rank's."""
    sds = [o if isinstance(o, Mapping) else o.state_dict()
           for o in optimizers]

    def cat(ts):
        if ts[0] is None:
            return None
        if ts[0].dim() == 0:
            return _to_numpy(ts[0])
        return np.concatenate([_to_numpy(t) for t in ts])

    first = sds[0]
    return {"scalers": [{k: _to_numpy(d[k]) for k in _SCALER_KEYS}
                        for d in first["scalers"]],
            "inner": {k: cat([sd["inner"][k] for sd in sds])
                      for k in first["inner"]},
            "masters": cat([sd["masters"] for sd in sds])}


def tp_shard(state_dict: Mapping[str, torch.Tensor], specs: Mapping,
             index: int, size: int) -> Dict[str, torch.Tensor]:
    """Rank ``index`` of ``size``'s shards of a full-size ``state_dict``,
    cut by ``specs`` (``parallel.tensor_parallel.partition_specs`` of the
    sharded model, nested by module path): each dimension whose spec
    entry names an axis (the model's tensor- or expert-parallel group)
    keeps its ``index``-th contiguous block, the rest is as it is."""
    flat: Dict[str, Any] = {}
    _flatten(dict(specs), "", flat)
    out = {}
    for name, t in state_dict.items():
        for dim, part in enumerate(flat.get(name) or ()):
            if part is None:
                continue
            n = t.shape[dim]
            if n % size:
                raise ValueError(f"{name}: dimension {dim} of size {n} not "
                                 f"divisible by {size}")
            b = n // size
            t = t.narrow(dim, index * b, b)
        out[name] = t.contiguous()
    return out


def kv_cache_from_jax(cache: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A JAX decoder's KV cache (``init_cache``/``prefill_cache``'s
    ``{layer: {"k", "v"[, "k_scale", "v_scale"]}}``), or T5's serving
    state (``init_seq2seq_state``'s ``{"cross", "dec", "src_mask"}``), as
    the port's, on ``device``, dtypes kept (int8 values, fp32 scales)."""
    if isinstance(cache, dict):
        return {k: kv_cache_from_jax(v, device) for k, v in cache.items()}
    return _to_torch(np.asarray(cache)).to(device)


def kv_cache_to_jax(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`kv_cache_from_jax`: the port's cache as numpy."""
    if isinstance(cache, dict):
        return {k: kv_cache_to_jax(v) for k, v in cache.items()}
    return _to_numpy(cache)


def qtensor_from_jax(q, device="cpu"):
    """A JAX ``QTensor`` as the port's (int8 data, fp32 scale, its axis and
    logical dtype), on ``device``."""
    from ..quantization import QTensor
    dtype = getattr(torch, np.dtype(q.dtype).name)
    return QTensor(_to_torch(np.asarray(q.data)).to(device),
                   _to_torch(np.asarray(q.scale)).to(device), int(q.axis),
                   dtype)


def qtensor_to_jax(q) -> Dict[str, Any]:
    """A port ``QTensor`` as ``{"data", "scale", "axis", "dtype"}`` (numpy
    arrays, the axis, the logical dtype's name): the JAX ``QTensor``'s
    constructor arguments."""
    return {"data": _to_numpy(q.data), "scale": _to_numpy(q.scale),
            "axis": q.axis, "dtype": str(q.dtype).replace("torch.", "")}


def adapters_from_jax(adapters: Dict[str, Dict[str, Any]], device="cpu"):
    """JAX LoRA adapters ``{path: {"a", "b"}}`` as the port's (a
    ``ModuleDict`` of the same paths, ``lora.init``'s form), on
    ``device``."""
    from ..lora import _Adapter
    out = torch.nn.ModuleDict()
    for path, ad in adapters.items():
        out[path] = _Adapter(_to_torch(np.asarray(ad["a"])).to(device),
                             _to_torch(np.asarray(ad["b"])).to(device))
    return out


def adapters_to_jax(adapters) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`adapters_from_jax`: ``{path: {"a", "b"}}`` as
    numpy."""
    return {path: {"a": _to_numpy(ad["a"]), "b": _to_numpy(ad["b"])}
            for path, ad in adapters.items()}


def stacked_from_jax(stacked: Dict[str, Any], stage_ids
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked stage tree (every leaf (S, ...)) -> the
    ``state_dict`` of a ``StackedStages`` holding ``stage_ids`` (a rank's
    ``[axis_index]``, or ``range(S)`` for the fallback): ``<i>.<path>`` is
    leaf ``[stage_ids[i]]``."""
    flat: Dict[str, Any] = {}
    _flatten(stacked, "", flat)
    return {f"{i}.{name}": _to_torch(np.asarray(leaf)[s])
            for i, s in enumerate(stage_ids) for name, leaf in flat.items()}


def stacked_to_jax(*state_dicts: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """Inverse of :func:`stacked_from_jax`: ``StackedStages`` state dicts in
    stage order (the fallback's one, or each rank's in rank order) -> the
    stacked tree as numpy, every leaf (S, ...)."""
    stages = []
    for sd in state_dicts:
        held: Dict[int, Dict[str, torch.Tensor]] = {}
        for name, t in sd.items():
            i, _, path = name.partition(".")
            held.setdefault(int(i), {})[path] = t
        stages += [held[i] for i in sorted(held)]
    out: Dict[str, Any] = {}
    for path in stages[0]:
        node = out
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.stack([_to_numpy(st[path]) for st in stages])
    return out
