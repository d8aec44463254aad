"""Sharded and asynchronous checkpoints on ``torch.distributed.checkpoint``.

Counterpart of ``apex_tpu/utils/checkpoint_orbax.py``.  It holds no Orbax:
it keeps that module's name, call shape and durability contract on
PyTorch's distributed checkpoint (DCP), where each rank writes the shards
it owns and a restore loads in place into the template's tensors,
resharding a ``DTensor`` template of another layout or world size on
read::

    from apex_tpu_torch.utils import checkpoint_orbax as ckpt
    ckpt.save_checkpoint(dir, step, {"model": m.state_dict(), ...})
    state = ckpt.restore_checkpoint(dir, template)          # the newest
    state = ckpt.restore_checkpoint(dir, template, step=7)

A tree is nested dicts, lists and tuples whose leaves are tensors
(``DTensor`` included), numpy arrays or Python numbers; its leaves are
keyed by their path spelled as JAX's ``keystr`` spells it
(``['model']['main.0.weight']``), which are also the DCP keys.  A restore
returns ``template`` with every leaf replaced: a tensor leaf is the
template's own tensor, loaded in place.

Durability (the JAX module's contract): a save writes ``step_N`` under
the directory, after dropping a pending marker beside it; the
``_apex_checksum.json`` sidecar, a crc32 over the keyed leaves (the npz
module's ``tree_checksum``, over each leaf's ``_to_numpy``, the whole
tensor of a ``DTensor``; the same crc the JAX package writes for a tree
of the same values, where neither side stores bfloat16) chained with
``data_state``, is written only once the save is durable: at return, or
at the join for ``async_save=True`` (:func:`wait`, or the next save,
which joins the pending one first).  A restore raises
:class:`CheckpointCorrupt` for an unreadable step, a content mismatch, or
a marker without a sidecar (a save that never joined); neither file is a
legacy snapshot, trusted.  ``keep`` prunes to the newest steps once the
save is durable.  Rank 0 writes the marker, the sidecar and prunes;
every rank takes part in the gathers of a ``DTensor``'s checksum.

Without ``torch.distributed`` a save or restore runs in one process.  An
async save in a group whose backend has no CPU device (NCCL) runs its
DCP collectives on a gloo group made for it.  :func:`zero_state` gives an
``AmpOptimizer``'s ZeRO-sharded state as ``DTensor``s over its windows,
so each rank writes its own.

The JAX module's telemetry (``record_checkpoint_io``) is not ported.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import (CheckpointCorrupt, _leaves, _to_numpy, tree_bytes,
                         tree_checksum)

__all__ = ["CheckpointCorrupt", "save_checkpoint", "restore_checkpoint",
           "latest_step", "available_steps", "load_data_state", "wait",
           "zero_state"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_CHECKSUM_FILE = "_apex_checksum.json"
_PENDING_FMT = "_apex_pending_step_{step}.json"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _grouped() else 0


_cpu_groups: Dict[Any, Any] = {}


def _cpu_group():
    """The group DCP coordinates on: the default one when it has a CPU
    backend, else a gloo group over the same ranks (made once per default
    group, by every rank)."""
    if not _grouped():
        return None
    default = dist.group.WORLD
    if torch.device("cpu") in getattr(default, "_device_types",
                                      [torch.device("cpu")]):
        return None
    if default not in _cpu_groups:
        _cpu_groups[default] = dist.new_group(backend="gloo")
    return _cpu_groups[default]


def _barrier() -> None:
    if _grouped():
        dist.barrier(group=_cpu_group())


def _is_dtensor(leaf) -> bool:
    return type(leaf).__name__ == "DTensor"


def _keyed(tree: Any) -> Dict[str, Any]:
    return dict(_leaves(tree))


def _host(leaf) -> np.ndarray:
    """A leaf as the checksum reads it (a DTensor gathered whole)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    return _to_numpy(leaf)


def _chain_data_state(crc: int, data_state: Optional[dict]) -> int:
    """The data-state blob folded into the content crc."""
    if data_state is None:
        return crc
    blob = json.dumps(data_state, sort_keys=True).encode()
    return zlib.crc32(blob, crc) & 0xFFFFFFFF


def _write_checksum(path: str, crc: int, nbytes: int, dtypes: dict,
                    data_state: Optional[dict] = None) -> None:
    side = os.path.join(path, _CHECKSUM_FILE)
    tmp = side + ".tmp"
    with open(tmp, "w") as f:
        meta = {"crc32": int(crc), "tree_bytes": int(nbytes),
                "dtypes": dtypes}
        if data_state is not None:
            meta["data_state"] = data_state
            meta["data_state_crc32"] = _chain_data_state(0, data_state)
        json.dump(meta, f)
    os.replace(tmp, side)


def _mgr_dir(ckpt_dir: str) -> str:
    return os.path.abspath(ckpt_dir)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(_mgr_dir(ckpt_dir), f"step_{int(step)}")


def _pending_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(_mgr_dir(ckpt_dir),
                        _PENDING_FMT.format(step=int(step)))


def _prune(ckpt_dir: str, keep: int) -> None:
    for s in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_path(ckpt_dir, s), ignore_errors=True)


def _dcp_dict(leaves: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The keyed leaves as DCP's flat state dict: tensors as they are,
    numpy arrays and numbers as CPU tensors."""
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in leaves.items()}


def _finish(ckpt_dir, keep, step, path, nbytes, crc, dtypes,
            data_state) -> None:
    """The save is durable: the sidecar, the marker gone, the pruning."""
    if _rank() == 0:
        _write_checksum(path, crc, nbytes, dtypes, data_state)
        try:
            os.unlink(_pending_path(ckpt_dir, step))
        except OSError:
            pass
        if keep is not None:
            _prune(ckpt_dir, keep)
    _barrier()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: Optional[int] = None,
                    async_save: bool = False,
                    data_state: Optional[dict] = None) -> str:
    """Write ``tree`` under ``ckpt_dir/step_N``, each rank its shards.

    ``async_save=True`` returns once the state is staged in host memory,
    the write going on in the background (:func:`wait` or the next save
    joins it and surfaces its errors).  ``keep`` prunes to the newest N
    steps once the save is durable.  Every rank of the group calls it."""
    import torch.distributed.checkpoint as dcp
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    wait()
    path = _step_path(ckpt_dir, step)
    nbytes = tree_bytes(tree)
    leaves = _keyed(tree)
    # the checksum of exactly the content about to be written
    host = {k: _host(v) for k, v in leaves.items()}
    crc = _chain_data_state(tree_checksum(host), data_state)
    dtypes = {k: str(v.dtype) for k, v in host.items()}
    del host
    if _rank() == 0:
        os.makedirs(_mgr_dir(ckpt_dir), exist_ok=True)
        # the marker first: a process dying mid-save leaves it without a
        # sidecar, which a restore tells from a legacy snapshot
        with open(_pending_path(ckpt_dir, step), "w") as f:
            json.dump({"step": int(step)}, f)
        shutil.rmtree(path, ignore_errors=True)   # no stale shards, no
        os.makedirs(path)                         # stale sidecar
    _barrier()
    sd = _dcp_dict(leaves)
    group = _cpu_group()
    if async_save:
        res = dcp.async_save(sd, checkpoint_id=path, process_group=group,
                             no_dist=not _grouped())
        fut = getattr(res, "upload_completion", res)
        global _pending
        _pending = (fut, ckpt_dir, keep, int(step), path, nbytes, crc,
                    dtypes, data_state)
    else:
        dcp.save(sd, checkpoint_id=path, process_group=group,
                 no_dist=not _grouped())
        _finish(ckpt_dir, keep, int(step), path, nbytes, crc, dtypes,
                data_state)
    return path


_pending = None


def wait() -> None:
    """Join an in-flight async save, then write its sidecar and apply its
    deferred pruning: the save is durable only now."""
    global _pending
    if _pending is not None:
        fut, *rest = _pending
        _pending = None
        fut.result()
        _finish(*rest)


def available_steps(ckpt_dir: str) -> list:
    d = _mgr_dir(ckpt_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(d))
                  if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(template: Any, loaded: Dict[str, torch.Tensor],
             path: str = "") -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], loaded, f"{path}[{k!r}]")
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, loaded, f"{path}[{i}]")
                              for i, v in enumerate(template))
    got = loaded[path]
    if isinstance(template, torch.Tensor):
        return got                      # the template's own tensor
    if isinstance(template, (np.ndarray, np.generic)):
        return got.numpy().astype(template.dtype)
    return type(template)(got.item())


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """Load into ``template``'s tensors in place, in their dtypes, devices
    and layouts (a ``DTensor`` of another mesh or world size reshards on
    read) and return the tree.  ``step=None`` loads the newest; raises
    ``FileNotFoundError`` when there is none and :class:`CheckpointCorrupt`
    for a torn or altered snapshot."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    leaves = _keyed(template)
    sd = _dcp_dict(leaves)
    try:
        dcp.load(sd, checkpoint_id=path, process_group=_cpu_group(),
                 no_dist=not _grouped())
    except (FileNotFoundError, ValueError, KeyError, RuntimeError,
            CheckpointException) as e:
        raise CheckpointCorrupt(f"{path}: unreadable snapshot ({e})")
    side = os.path.join(path, _CHECKSUM_FILE)
    if not os.path.exists(side) and os.path.exists(
            _pending_path(ckpt_dir, step)):
        raise CheckpointCorrupt(
            f"{path}: save was never joined (pending marker present, no "
            f"durability sidecar): torn async write")
    if os.path.exists(side):
        try:
            with open(side) as f:
                meta = json.load(f)
            want = meta["crc32"]
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorrupt(f"{side}: unreadable checksum sidecar "
                                    f"({e})")
        host = {k: _host(v) for k, v in sd.items()}
        # a template of other dtypes casts the restore; its bytes cannot
        # match the saved ones, so verify only when every leaf came back
        # in its saved dtype
        saved = meta.get("dtypes")
        if saved is None or all(str(v.dtype) == saved.get(k)
                                for k, v in host.items()):
            got = _chain_data_state(tree_checksum(host),
                                    meta.get("data_state"))
            if int(want) != got:
                raise CheckpointCorrupt(
                    f"{path}: content checksum mismatch (sidecar "
                    f"{int(want):#010x}, recomputed {got:#010x})")
    return _rebuild(template, sd)


def load_data_state(ckpt_dir: str,
                    step: Optional[int] = None) -> Optional[dict]:
    """The data-pipeline cursor the save stored in the sidecar, checked
    against its own crc; ``None`` when the snapshot carries none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    side = os.path.join(path, _CHECKSUM_FILE)
    if not os.path.exists(side):
        return None
    try:
        with open(side) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{side}: unreadable checksum sidecar ({e})")
    ds = meta.get("data_state")
    if ds is not None:
        want = meta.get("data_state_crc32")
        got = _chain_data_state(0, ds)
        if want is not None and int(want) != got:
            raise CheckpointCorrupt(
                f"{side}: data_state checksum mismatch (stored "
                f"{int(want):#010x}, recomputed {got:#010x}): a torn "
                f"sidecar or a tampered cursor")
    return ds


def zero_state(optimizer) -> Dict[str, Any]:
    """A ZeRO-sharded ``AmpOptimizer``'s state dict (``scalers``,
    ``inner``, ``masters``) with each flat window a ``DTensor`` over it:
    ``Shard(0)`` of the unpadded flat buffer over a 1-D mesh of the world
    for stage 1, and for stages 2 and 3 over a (nodes, ranks a node) mesh,
    ``Replicate`` across nodes.  The windows are ``ceil(N / shards)``
    elements, DTensor's own split, so each local shard is a view of the
    rank's window less its end padding: a save writes each rank's window,
    and a restore loads into the windows in place (then
    ``optimizer.load_state_dict(optimizer.state_dict())`` gathers the
    model's parameters from them)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    z = optimizer._zero
    if z is None:
        raise ValueError("the optimizer is not ZeRO-sharded: its state "
                         "dict holds whole tensors")
    total = optimizer.masters.layout.total
    world = dist.get_world_size()
    dev = optimizer.masters.buf.device.type
    ranks = torch.arange(world)
    if z.stage == 1:
        mesh, placements = DeviceMesh(dev, ranks), [Shard(0)]
    else:
        mesh = DeviceMesh(dev, ranks.view(world // z.shards, z.shards))
        placements = [Replicate(), Shard(0)]
    valid = max(0, min(z.shard_n, total - z.index * z.shard_n))

    def sharded(t):
        if isinstance(t, torch.Tensor) and t.dim() == 1 \
                and t.numel() == z.shard_n:
            return DTensor.from_local(t[:valid], mesh, placements,
                                      run_check=False, shape=(total,),
                                      stride=(1,))
        if isinstance(t, dict):
            return {k: sharded(v) for k, v in t.items()}
        return t

    sd = optimizer.state_dict()
    return {"scalers": sd["scalers"], "inner": sharded(sd["inner"]),
            "masters": sharded(sd["masters"])}
