"""Checkpoint and resume for whole training states, in the JAX package's
file format.

Counterpart of ``apex_tpu/utils/checkpoint.py``.  A state is a tree of
nested dicts, lists and tuples whose leaves are tensors, numpy arrays or
Python numbers (``None`` holds no leaf): for example ``{"model":
model.state_dict(), "optimizer": opt.state_dict()}``.  One step is one
``ckpt_<step:08d>.npz`` that holds every leaf keyed by its path in JAX's
``keystr`` syntax (``['model']['conv1.weight']``, ``['opt'][0]``), so the
two packages read each other's files.  bfloat16 is stored as fp32, which
holds it exactly; a restore casts back to the template's dtype.  The
file also holds ``__checksum__``, a crc32 over every entry that a restore
recomputes (a torn or corrupted file raises :class:`CheckpointCorrupt`),
and, optionally, ``__data_state__``, a JSON blob of the input pipeline's
cursor under the same checksum.  A save writes a temporary file and
renames it into place.

    save_checkpoint(dir, step, {"model": m.state_dict(),
                                "optimizer": opt.state_dict()})
    state = restore_checkpoint(dir, template)           # the newest
    state = restore_checkpoint(dir, template, step=7)

The JAX package's ``record_checkpoint_io`` (checkpoint telemetry for the
observability plane) is not ported.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointCorrupt", "save_checkpoint", "restore_checkpoint",
           "latest_step", "available_steps", "latest_durable_step",
           "verify_checkpoint", "load_data_state", "tree_bytes",
           "tree_checksum"]

_FMT = "ckpt_{step:08d}.npz"
_RE = re.compile(r"ckpt_(\d{8})\.npz$")

# reserved npz keys, never a keypath (a keypath is empty or starts with a
# bracket)
_CHECKSUM_KEY = "__checksum__"
_DATA_STATE_KEY = "__data_state__"


class CheckpointCorrupt(RuntimeError):
    """A snapshot failed its content check (a torn or partial write, bit
    rot, truncation): a restore raises this instead of loading garbage."""


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf: dict keys in sorted order, as JAX
    flattens them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as npz stores it: bfloat16 and fp8, which npz has not, as
    fp32, which holds them exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in (torch.float64, torch.float32, torch.float16,
                           torch.int64, torch.int32, torch.int16, torch.int8,
                           torch.uint8, torch.bool):
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)     # ml_dtypes' bfloat16
    return arr


def tree_bytes(tree: Any) -> int:
    """In-memory bytes of a tree's leaves (what a snapshot persists,
    before compression)."""
    total = 0
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def tree_checksum(leaves: Dict[str, np.ndarray]) -> int:
    """crc32 chained over the sorted keys, each leaf's dtype and shape,
    and its bytes: the JAX package's, so either package verifies the
    other's files."""
    crc = 0
    for key in sorted(leaves):
        arr = np.asarray(leaves[key])
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(str(arr.dtype).encode(), crc)
        crc = zlib.crc32(str(tuple(arr.shape)).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _leaf_dict(tree: Any) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in _leaves(tree):
        if key in out:
            raise ValueError(f"duplicate keypath {key!r}")
        out[key] = _to_numpy(leaf)
    return out


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: Optional[int] = None,
                    data_state: Optional[dict] = None) -> str:
    """Write ``tree`` for ``step`` (a temporary file, then a rename).  With
    ``keep``, only the newest ``keep`` checkpoints stay.  ``data_state``,
    a JSON-serializable dict (``DataLoader.state_dict()``), is stored
    under the checksum beside the tree; :func:`load_data_state` reads it.
    Returns the file's path."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _leaf_dict(tree)
    if data_state is not None:
        blob = json.dumps(data_state, sort_keys=True).encode()
        leaves[_DATA_STATE_KEY] = np.frombuffer(blob, np.uint8)
    leaves[_CHECKSUM_KEY] = np.uint32(tree_checksum(leaves))
    path = os.path.join(ckpt_dir, _FMT.format(step=step))
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if keep is not None:
        for s in available_steps(ckpt_dir)[:-keep]:
            os.unlink(os.path.join(ckpt_dir, _FMT.format(step=s)))
    return path


def available_steps(ckpt_dir: str) -> list:
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _RE.match(name)
            if m:
                steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _path(ckpt_dir: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir!r}")
    path = os.path.join(ckpt_dir, _FMT.format(step=step))
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _load_verified(path: str) -> Dict[str, np.ndarray]:
    """Read one snapshot and check its content checksum; a snapshot
    without one (older than the checksum) loads as it is."""
    try:
        with np.load(path) as data:
            stored = dict(data)
    except (OSError, ValueError, EOFError, KeyError,
            zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(f"{path}: unreadable snapshot ({e})")
    want = stored.pop(_CHECKSUM_KEY, None)
    if want is not None:
        got = tree_checksum(stored)
        if int(want) != got:
            raise CheckpointCorrupt(
                f"{path}: content checksum mismatch (stored "
                f"{int(want):#010x}, recomputed {got:#010x}): a torn write "
                f"or bit rot; fall back to an earlier snapshot")
    return stored


def verify_checkpoint(ckpt_dir: str, step: int) -> None:
    """Check one snapshot's checksum without restoring it; raises
    :class:`CheckpointCorrupt` (or ``FileNotFoundError``)."""
    _load_verified(_path(ckpt_dir, step))


def load_data_state(ckpt_dir: str,
                    step: Optional[int] = None) -> Optional[dict]:
    """The input pipeline's cursor that ``save_checkpoint(...,
    data_state=...)`` stored, checked under the snapshot's checksum;
    ``None`` when the snapshot holds none."""
    stored = _load_verified(_path(ckpt_dir, step))
    blob = stored.get(_DATA_STATE_KEY)
    if blob is None:
        return None
    return json.loads(np.asarray(blob, np.uint8).tobytes().decode())


def latest_durable_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose snapshot passes its checksum (torn ones are
    skipped, newest first); ``None`` when none does."""
    for step in reversed(available_steps(ckpt_dir)):
        try:
            verify_checkpoint(ckpt_dir, step)
            return step
        except CheckpointCorrupt:
            continue
    return None


def _fill(template: Any, stored: Dict[str, np.ndarray], path: str,
          where: str) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _fill(template[k], stored, f"{path}[{k!r}]", where)
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, stored, f"{path}[{i}]", where)
                              for i, v in enumerate(template))
    if path not in stored:
        raise KeyError(f"checkpoint {where} has no entry for {path!r}: the "
                       f"template's structure does not match the saved "
                       f"state")
    arr = stored[path]
    shape = getattr(template, "shape", None)
    if shape is not None and tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {path!r}: checkpoint "
                         f"{arr.shape} vs template {tuple(shape)}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=template.device,
                                                  dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        return np.asarray(arr, template.dtype)
    return type(template)(arr.item())


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """``template`` with every leaf replaced by the stored value, on the
    template leaf's device and in its dtype (shapes must match: a
    mismatch raises ``ValueError`` naming the leaf).  ``step=None`` loads
    the newest checkpoint; raises ``FileNotFoundError`` when there is
    none and :class:`CheckpointCorrupt` when the snapshot fails its
    checksum."""
    path = _path(ckpt_dir, step)
    stored = _load_verified(path)
    stored.pop(_DATA_STATE_KEY, None)
    return _fill(template, stored, "", path)
