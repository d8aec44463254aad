"""The input pipeline's host runtime: ``apex_tpu_torch_C.cpp`` built with
``g++`` and loaded with ``ctypes``.

Counterpart of ``apex_tpu/_native``.  The library is built as
``ops/_build.py`` builds the kernels: on first use, into
``build/apex_tpu_torch/libapex_tpu_torch_C-<hash>.so`` under the
repository root (the hash covers the source and the flags), compiled to a
``mkstemp`` file and moved into place with ``os.replace``.  Nothing is
written in place, so processes that build at once each load a whole
library.  When it cannot be built or loaded (no compiler), every entry has
a numpy fallback, as in the JAX package; :func:`available` says which,
and :func:`error` why not.

  available() -> bool
  preprocess_images(u8_nhwc, mean, std, data_format="NCHW"|"NHWC")
      -> normalized float32, NCHW or NHWC
  library() -> the loaded ctypes library or None (the DataLoader's ring:
      apex_loader_create / next / release / destroy)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["available", "error", "build", "library", "version",
           "preprocess_images", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "apex_tpu_torch_C.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
# no -march=native: the library may be loaded on another host of the pool
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FP = ctypes.POINTER(ctypes.c_float)
# argtypes and restype of every entry the port calls
_SIGNATURES = {
    "apex_preprocess_nhwc_u8_to_nchw_f32": ((_P, _P, _L, _L, _L, _L, _FP,
                                             _FP), None),
    "apex_preprocess_nhwc_u8_to_nhwc_f32": ((_P, _P, _L, _L, _L, _L, _FP,
                                             _FP), None),
    "apex_native_version": ((), _I),
    "apex_loader_create": ((_P, _P, _L, _L, _L, _L, _L, _I, _I,
                            ctypes.c_uint64, _FP, _FP, _I, _I), _P),
    "apex_loader_next": ((_P, ctypes.POINTER(_P), ctypes.POINTER(_P)), _L),
    "apex_loader_release": ((_P, _P), None),
    "apex_loader_destroy": ((_P,), None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libapex_tpu_torch_C-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)      # atomic: a racing process sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None (and :func:`error`
    set) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
                _error = str(e)
                return None
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            _lib = lib
        return _lib


def available() -> bool:
    return library() is not None


def error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first attempt)."""
    return _error


def version() -> int:
    """ABI version of the loaded library (0 when unavailable)."""
    lib = library()
    return int(lib.apex_native_version()) if lib is not None else 0


def preprocess_images(images_u8: np.ndarray, mean: Sequence[float],
                      std: Sequence[float],
                      data_format: str = "NCHW") -> np.ndarray:
    """(N, H, W, C) uint8 -> ``(x - mean) / std`` in float32 on host
    threads, delivered NCHW (transposed) or NHWC (in place order).  The
    library multiplies by ``1 / std``, the numpy fallback divides: the two
    differ in the last bit."""
    images_u8 = np.ascontiguousarray(images_u8)
    n, h, w, c = images_u8.shape
    nhwc_out = data_format == "NHWC"
    lib = library()
    if lib is None:
        f = images_u8.astype(np.float32)
        f = (f - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        return np.ascontiguousarray(f if nhwc_out
                                    else f.transpose(0, 3, 1, 2))
    out = np.empty((n, h, w, c) if nhwc_out else (n, c, h, w), np.float32)
    mean_c = (ctypes.c_float * c)(*[float(m) for m in mean])
    std_c = (ctypes.c_float * c)(*[float(s) for s in std])
    fn = (lib.apex_preprocess_nhwc_u8_to_nhwc_f32 if nhwc_out
          else lib.apex_preprocess_nhwc_u8_to_nchw_f32)
    fn(images_u8.ctypes.data_as(ctypes.c_void_p),
       out.ctypes.data_as(ctypes.c_void_p), n, h, w, c, mean_c, std_c)
    return out
