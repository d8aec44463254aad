"""The prefetching input pipeline.

Counterpart of ``apex_tpu/data.py``, the reference example's
``data_prefetcher`` (examples/imagenet/main_amp.py:264-300) rebuilt on the
host: batch assembly, the uint8 -> fp32 normalize (NCHW or NHWC) and the
shuffle run in the C++ runtime (``_native``, ``apex_loader_*``), whose
worker threads fill a ring of slots ahead of the training loop and deliver
in batch order.  Without the library it falls back to numpy, as the JAX
package does; ``loader.native`` says which path runs.

    loader = DataLoader(images_u8_nhwc, labels, batch_size=128)
    for imgs, lbls in loader:           # numpy: imgs (B, C, H, W) fp32
        x = torch.from_numpy(imgs).pin_memory().to("cuda", non_blocking=True)

Batches are numpy arrays, owned copies by default.  ``zero_copy=True``
hands out views into the ring's slot, valid only until the next
``next_batch``: do not pair it with an asynchronous copy to the device
(``non_blocking=True``), which may still be reading the slot when the next
call recycles it.

The Python pipeline walks ``np.random.RandomState(seed +
epoch).permutation(n)`` and carries a cursor: ``state_dict`` /
``load_state_dict`` resume it bitwise, ``shard_id`` / ``num_shards`` split
every global batch (the cursor is world-independent), and records that
``bad_record_fn`` flags are replaced in-batch by a good one and counted.
The native ring's shuffle order and rounding are its own, so the state
protocol raises on a native loader (``num_shards > 1`` and
``bad_record_fn`` take the Python pipeline).  The JAX package's
``metrics=`` and ``ring=`` (registry and flight ring of the observability
plane) are not ported.
"""

from __future__ import annotations

import ctypes
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from . import _native

__all__ = ["DataLoader", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)

_NOT_PORTED = ("{} belongs to the observability plane, which is not ported "
               "yet (ROADMAP queue 1 item 9)")


class DataLoader:
    """Normalized (images, labels) batches of ``images`` (N, H, W, C)
    uint8 and ``labels`` (N,).  ``next_batch`` is endless;
    ``__iter__`` yields one epoch, dropping the last partial batch."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD,
                 prefetch: int = 3, workers: int = 4, seed: int = 0,
                 native: Optional[bool] = None, zero_copy: bool = False,
                 data_format: str = "NCHW", metrics=None,
                 shard_id: int = 0, num_shards: int = 1,
                 bad_record_fn=None, ring=None):
        if metrics is not None:
            raise NotImplementedError(_NOT_PORTED.format("metrics="))
        if ring is not None:
            raise NotImplementedError(_NOT_PORTED.format("ring="))
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, "
                             f"got {data_format!r}")
        self.data_format = data_format
        self.zero_copy = zero_copy
        if np.asarray(images).dtype != np.uint8:
            raise TypeError(
                f"images must be uint8, got {np.asarray(images).dtype}: the "
                f"loader normalizes; pass the raw uint8 pixels")
        self.images = np.ascontiguousarray(images, np.uint8)
        self.labels = np.ascontiguousarray(labels, np.int32)
        if self.images.ndim != 4:
            raise ValueError("images must be (N, H, W, C) uint8")
        if len(self.labels) != len(self.images):
            raise ValueError("labels/images length mismatch")
        self.batch_size = int(batch_size)
        self.n, self.h, self.w, self.c = self.images.shape
        if self.n < self.batch_size:
            raise ValueError("dataset smaller than one batch")
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id must be in [0, {num_shards}), "
                             f"got {shard_id}")
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        # all shards together consume one global batch a step; the cursor
        # advances by it, so it does not depend on the world size
        self.global_batch = self.batch_size * self.num_shards
        if self.n < self.global_batch:
            raise ValueError(
                f"dataset ({self.n}) smaller than one global batch "
                f"({self.global_batch} = batch_size x num_shards)")
        self.batches_per_epoch = self.n // self.global_batch
        self.bad_record_fn = bad_record_fn
        self.shuffle = shuffle
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        if len(self.mean) != self.c or len(self.std) != self.c:
            raise ValueError("mean/std length must equal channel count")
        self.seed = seed
        self._handle = None
        self._held = None
        use_native = _native.available() if native is None else native
        if self.num_shards > 1 or bad_record_fn is not None:
            # shards and the quarantine are defined over the Python
            # pipeline's permutation; the ring knows neither
            use_native = False
        lib = _native.library() if use_native else None
        if lib is not None:
            self._lib = lib
            self._handle = lib.apex_loader_create(
                self.images.ctypes.data_as(ctypes.c_void_p),
                self.labels.ctypes.data_as(ctypes.c_void_p),
                self.n, self.h, self.w, self.c, self.batch_size,
                int(prefetch), int(workers), seed,
                self.mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                1 if shuffle else 0, 1 if data_format == "NHWC" else 0)
        # the Python pipeline's cursor: (epoch, cursor) name a position in
        # the stream of epoch permutations, both global (shard-independent)
        self._epoch = 0
        self._cursor = 0                 # samples into this epoch
        self._samples_consumed = 0       # global total across epochs
        self._batch_index = 0            # this loader's next_batch calls
        self._quarantined = 0
        self._perm = None
        self._perm_epoch = -1
        # how long the training loop waits in next_batch
        self._batches = 0
        self._wait_sum = 0.0
        self._wait_max = 0.0

    @property
    def native(self) -> bool:
        return self._handle is not None

    # -- native path -------------------------------------------------------
    def _next_native(self) -> Tuple[np.ndarray, np.ndarray, int]:
        if self._held is not None:
            self._lib.apex_loader_release(self._handle, self._held)
            self._held = None
        img_p = ctypes.c_void_p()
        lbl_p = ctypes.c_void_p()
        b = self._lib.apex_loader_next(self._handle, ctypes.byref(img_p),
                                       ctypes.byref(lbl_p))
        if b < 0:
            # destroy() woke the wait: the pointers were never filled
            raise StopIteration("data loader shut down")
        self._held = img_p
        shape = ((self.batch_size, self.h, self.w, self.c)
                 if self.data_format == "NHWC"
                 else (self.batch_size, self.c, self.h, self.w))
        imgs = np.ctypeslib.as_array(
            ctypes.cast(img_p, ctypes.POINTER(ctypes.c_float)), shape=shape)
        lbls = np.ctypeslib.as_array(
            ctypes.cast(lbl_p, ctypes.POINTER(ctypes.c_int32)),
            shape=(self.batch_size,))
        if not self.zero_copy:
            imgs, lbls = imgs.copy(), lbls.copy()
            # owned now: give the slot back so workers refill it during
            # this step (zero_copy keeps it until the next call)
            self._lib.apex_loader_release(self._handle, self._held)
            self._held = None
        return imgs, lbls, b

    # -- Python pipeline ---------------------------------------------------
    def _epoch_perm(self) -> np.ndarray:
        if self._perm_epoch != self._epoch:
            self._perm = (np.random.RandomState(
                self.seed + self._epoch).permutation(self.n)
                if self.shuffle else np.arange(self.n))
            self._perm_epoch = self._epoch
        return self._perm

    def _quarantine_sweep(self, idx: np.ndarray) -> np.ndarray:
        """Replace every index ``bad_record_fn`` flags by the first good
        sample of the same slice (the batch keeps its shape) and count
        it.  A wholly bad batch takes the dataset's first good record; a
        wholly bad dataset raises."""
        fn = self.bad_record_fn
        if fn is None:
            return idx
        bad = [k for k in range(len(idx)) if fn(int(idx[k]))]
        if not bad:
            return idx
        idx = np.asarray(idx).copy()
        bad_set = set(bad)
        good = [k for k in range(len(idx)) if k not in bad_set]
        if good:
            sub = int(idx[good[0]])
        else:
            sub = next((j for j in range(self.n) if not fn(j)), None)
            if sub is None:
                raise RuntimeError(
                    "every record in the dataset is flagged by "
                    "bad_record_fn: nothing left to train on")
        for k in bad:
            self._quarantined += 1
            idx[k] = sub
        return idx

    def _next_python(self) -> Tuple[np.ndarray, np.ndarray, int]:
        if self._cursor + self.global_batch > self.n:
            # drop-last epoch roll
            self._epoch += 1
            self._cursor = 0
        perm = self._epoch_perm()
        base = self._cursor + self.shard_id * self.batch_size
        idx = perm[base:base + self.batch_size]
        self._cursor += self.global_batch
        self._samples_consumed += self.global_batch
        b = self._batch_index
        self._batch_index += 1
        idx = self._quarantine_sweep(idx)
        imgs = _native.preprocess_images(self.images[idx], self.mean,
                                         self.std, self.data_format)
        return imgs, self.labels[idx], b

    # -- iteration ---------------------------------------------------------
    def next_batch(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """(images, labels, batch_index); endless, in batch order."""
        t0 = time.perf_counter()
        out = self._next_native() if self.native else self._next_python()
        dt = time.perf_counter() - t0
        self._batches += 1
        self._wait_sum += dt
        self._wait_max = max(self._wait_max, dt)
        return out

    def _census(self) -> dict:
        """Samples consumed, epoch and cursor; the native path derives them
        from its count of delivered batches."""
        if self.native:
            epoch, i = divmod(self._batches, self.batches_per_epoch)
            return {"samples_consumed": self._batches * self.global_batch,
                    "epoch": epoch, "cursor": i * self.global_batch}
        return {"samples_consumed": self._samples_consumed,
                "epoch": self._epoch, "cursor": self._cursor}

    def stats(self) -> dict:
        """Batches delivered, the consumed-sample census, the shard, the
        quarantine count and the wait in ``next_batch`` (seconds)."""
        out = {"batches": self._batches,
               "native": self.native,
               "shard_id": self.shard_id,
               "num_shards": self.num_shards,
               "samples_quarantined": self._quarantined,
               "load_wait": {"count": self._batches, "sum": self._wait_sum,
                             "mean": (self._wait_sum / self._batches
                                      if self._batches else None),
                             "max": self._wait_max}}
        out.update(self._census())
        return out

    # -- the resume protocol (Python pipeline only) ------------------------
    def state_dict(self) -> dict:
        """The cursor of the Python pipeline's stream, JSON-serializable
        (``utils.checkpoint.save_checkpoint(..., data_state=...)`` stores
        it).  Raises on the native path, whose order is not portable."""
        if self.native:
            raise RuntimeError(
                "DataLoader.state_dict() needs the Python pipeline: the "
                "native ring's shuffle order is not portable; construct "
                "with native=False")
        return {"version": 1, "seed": int(self.seed),
                "shuffle": bool(self.shuffle), "n": int(self.n),
                "epoch": int(self._epoch), "cursor": int(self._cursor),
                "samples_consumed": int(self._samples_consumed),
                "batch_index": int(self._batch_index),
                "samples_quarantined": int(self._quarantined),
                "shard_id": int(self.shard_id),
                "num_shards": int(self.num_shards)}

    def load_state_dict(self, sd: dict) -> None:
        """Resume at ``sd``'s cursor.  The stream (seed, shuffle, n) must
        be the same; the sharding may differ (this loader's wins)."""
        if self.native:
            raise RuntimeError(
                "DataLoader.load_state_dict() needs the Python pipeline; "
                "construct with native=False")
        for key in ("seed", "shuffle", "n", "epoch", "cursor",
                    "samples_consumed"):
            if key not in sd:
                raise ValueError(f"data state missing {key!r}")
        if int(sd["seed"]) != self.seed:
            raise ValueError(
                f"data state was captured for seed {sd['seed']}, this "
                f"loader has seed {self.seed}: another sample stream "
                f"cannot resume deterministically")
        if bool(sd["shuffle"]) != self.shuffle:
            raise ValueError("data state shuffle flag mismatch")
        if int(sd["n"]) != self.n:
            raise ValueError(
                f"data state names a {sd['n']}-sample dataset, this "
                f"loader holds {self.n}")
        cursor = int(sd["cursor"])
        if not 0 <= cursor <= self.n:
            raise ValueError(f"cursor {cursor} out of range [0, {self.n}]")
        self._epoch = int(sd["epoch"])
        self._cursor = cursor
        self._samples_consumed = int(sd["samples_consumed"])
        self._batch_index = int(sd.get("batch_index", 0))
        self._quarantined = int(sd.get("samples_quarantined", 0))
        self._perm_epoch = -1            # re-derive the permutation

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(self.batches_per_epoch):
            imgs, lbls, _ = self.next_batch()
            yield imgs, lbls

    def close(self) -> None:
        """Stop the ring's workers and free it (the native path)."""
        if self._handle is not None:
            if self._held is not None:
                self._lib.apex_loader_release(self._handle, self._held)
                self._held = None
            self._lib.apex_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
