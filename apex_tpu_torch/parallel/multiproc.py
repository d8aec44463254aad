"""Process-group bootstrap and a local multi-process launcher.

Counterpart of ``apex_tpu/parallel/multiproc.py`` on ``torch.distributed``:

- ``init_process_group()``, called by the trainee script, brings up the
  default group from explicit arguments or from the environment the
  launcher (or ``torchrun``) sets: ``RANK``, ``WORLD_SIZE`` and
  ``APEX_TPU_TORCH_INIT_METHOD`` (or ``MASTER_ADDR``/``MASTER_PORT``, read
  as ``env://``).  Unwired, it is a no-op that returns rank 0, so a script
  runs unchanged alone and under the launcher.  The backend is ``nccl``
  when CUDA is available and ``gloo`` otherwise; a failed NCCL bring-up
  raises, it never becomes gloo.
- ``python -m apex_tpu_torch.parallel.multiproc --nprocs N script.py
  args...`` spawns N local processes wired into one group, at a
  ``tcp://`` address on an OS-assigned free port unless ``--init-method``
  names one (a ``file://`` store, say), all on one node
  (``LOCAL_WORLD_SIZE`` = N, which ``parallel.topology`` reads), and
  exits non-zero if any child fails, killing the survivors, which would
  otherwise wait in the group's bring-up.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Optional

__all__ = ["init_process_group", "local_init_method", "ENV_INIT_METHOD",
           "main"]

ENV_INIT_METHOD = "APEX_TPU_TORCH_INIT_METHOD"


def init_process_group(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> int:
    """Bring up the default ``torch.distributed`` group and return this
    process's rank (see the module doc).  On CUDA each rank takes the card
    ``LOCAL_RANK`` (default: rank modulo the card count)."""
    import torch
    import torch.distributed as dist

    init_method = init_method or os.environ.get(ENV_INIT_METHOD)
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        return 0
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return rank


def local_init_method() -> str:
    """A ``tcp://`` rendezvous URL on 127.0.0.1 at an OS-assigned free
    port: a fixed port collides with any other group on the host."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.parallel.multiproc",
        description="spawn N local processes wired into one "
                    "torch.distributed process group")
    p.add_argument("--nprocs", type=int,
                   default=int(os.environ.get("WORLD_SIZE", "2")))
    p.add_argument("--init-method", default=None,
                   help="the group's rendezvous URL (default: tcp:// on "
                        "127.0.0.1 at a free port)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    init = args.init_method or local_init_method()
    children = []
    for rank in range(args.nprocs):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(args.nprocs),
                   WORLD_SIZE=str(args.nprocs), **{ENV_INIT_METHOD: init})
        children.append(subprocess.Popen(
            [sys.executable, args.script, *args.script_args], env=env))
    rc = 0
    try:
        while True:
            codes = [c.poll() for c in children]
            failed = [code for code in codes if code not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if all(code is not None for code in codes):
                break
            time.sleep(0.05)
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
