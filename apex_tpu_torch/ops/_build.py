"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library,
``build/apex_tpu_torch/lib<name>-<hash>.so`` under the repository root,
where ``<hash>`` covers the source text and the compiler flags: a changed
source builds anew, an unchanged one loads what is there.  The libraries
have a plain ``extern "C"`` interface (no PyTorch headers), so a build
takes seconds.  :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for them together.

Nothing here runs at import time: the first kernel launch builds.  Each
source loaded is recorded once in the compilation ledger
(``observability.compilation.record_build``) as ``nvcc:<name>``: a
``hit`` when its library was already built, a ``miss`` with its build
seconds when ``nvcc`` ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["SOURCES", "build_all", "library", "check", "use_kernel",
           "stream_ptr", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"

# -fmad=false: a*x+b*y, the Adam EMAs and the BatchNorm apply round after
# each multiply and each add, like the plain PyTorch versions (no FMA
# contraction).  No --use_fast_math: division and sqrt stay IEEE
# round-to-nearest.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_c = ctypes
_P, _F, _I, _L = _c.c_void_p, _c.c_float, _c.c_int, _c.c_longlong

# C signature of every entry point, by library.  Each returns
# cudaGetLastError() as an int.  Pointers and the stream are c_void_p:
# without argtypes ctypes would pass a Python int as a 32-bit C int.
SOURCES: Dict[str, Dict[str, Tuple]] = {
    "multi_tensor": {
        "apex_scale": (_P, _P, _L, _P, _P, _I, _P),
        "apex_axpby": (_P, _P, _P, _L, _P, _P, _I, _P, _P),
        "apex_l2norm": (_P, _L, _P, _I, _P, _P),
        "apex_l2norm_per_tensor": (_P, _P, _L, _P, _I, _P, _P, _P),
    },
    "adam": {
        "apex_adam": (_P, _P, _P, _P, _P, _I, _L, _P, _P, _P,
                      _F, _F, _F, _F, _F, _I, _F, _I, _I, _I, _P),
    },
    "lamb": {
        "apex_lamb_stage1": (_P,) * 5 + (_L,) + (_P,) * 4 + (_F,) * 6
        + (_I, _I, _P),
        "apex_lamb_stage2": (_P, _P, _P, _P, _L, _P, _P, _I, _P, _P),
    },
    "syncbn": {
        "apex_bn_fwd": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
        "apex_bn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P),
    },
    "layer_norm": {
        "apex_ln_fwd": (_P,) * 6 + (_I, _I, _F) + (_I,) * 5 + (_P,),
        "apex_ln_fwd_kernel_info": (_I,) * 4 + (_P,),
        "apex_ln_bwd": (_P,) * 9 + (_I,) * 7 + (_P,),
        "apex_ln_bwd_kernel_info": (_I,) * 4 + (_P,),
    },
    "flash_attention": {
        "apex_flash_fwd": (_P,) * 8 + (_I,) * 5 + (_F,) * 3 + (_I, _P),
        "apex_flash_dq": (_P,) * 10 + (_I,) * 5 + (_F,) * 3 + (_I, _P),
        "apex_flash_dkv": (_P,) * 11 + (_I,) * 5 + (_F,) * 3 + (_I, _P),
        "apex_flash_kernel_info": (_I, _I, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin"
                       " or /usr/local/cuda/bin); the CUDA kernels cannot "
                       "be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build (or find built) every library in ``names`` (default: all),
    one ``nvcc`` per source started together, and load them.  Returns
    ``nvcc``'s output per source (``-Xptxas -v``: registers and spills),
    empty for a source that was already built."""
    names = list(SOURCES if names is None else names)
    logs = {n: "" for n in names}
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
        failed = []
        # each source's build seconds: from the start of all of them to
        # when its nvcc was collected
        seconds = {}
        for n, (proc, tmp, out) in procs.items():
            logs[n], _ = proc.communicate()
            seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"--- {n}.cu (exit {proc.returncode})\n"
                              f"{logs[n]}")
            else:
                os.replace(tmp, out)   # atomic: a racing build sees all
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for n in todo:
            _LIBS[n] = _load(n, _target(n))
    from ..observability import compilation
    for n in todo:
        compilation.record_build(n, seconds.get(n, 0.0), n not in procs)
    return logs


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(err: int, fn: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor is on CUDA (launch the
    kernel), False when every one is on the CPU (take the plain PyTorch
    version) or every one is a meta tensor (the plain version's operators
    with nothing computed: how a cost count prices a wrapper).  Anything
    else raises: there is no fallback."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    raise ValueError(f"kernel operands must all be CUDA or all be CPU "
                     f"tensors, got devices {sorted(kinds)}")


THREADS = 256        # kThreads in csrc/common.cuh
MAX_BLOCKS = 1024    # grid-stride cap; also l2norm's partial count limit


def grid_blocks(n: int) -> int:
    """Blocks for an ``n``-element pass: one float4 per thread, capped so
    the grid stays resident (132 SMs x 2048 threads) and strides."""
    float4s = -(-n // 4)
    return max(1, min(-(-float4s // THREADS), MAX_BLOCKS))


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, n: int,
            align: int = 16) -> None:
    """What every kernel takes: contiguous, the stated dtype and length,
    and aligned for its vector loads (a fresh allocation always is)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{name} must be contiguous with {n} elements, got "
                         f"shape {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned for the "
                         f"kernel's vector loads")
