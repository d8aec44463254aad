"""Cross-module amp state and printing.

Counterpart of ``apex_tpu/amp/_amp_state.py``: the active opt properties
and verbosity, ``maybe_print`` (rank 0 only, from ``torch.distributed``
when it is initialized) and ``warn_or_err``.
"""

from __future__ import annotations

import torch


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.verbosity = 1
        self.opt_properties = None


_amp_state = AmpState()


def master_params(optimizer):
    """Generator over the fp32 master params of an amp-initialized
    optimizer: per-parameter views of its flat master buffer."""
    masters = getattr(optimizer, "masters", None)
    if masters is None:
        raise AttributeError(
            "master_params requires an optimizer returned by amp.initialize")
    yield from masters.as_list()


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def maybe_print(msg: str, rank0_only: bool = True) -> None:
    if _amp_state.verbosity > 0:
        if not rank0_only or _rank() == 0:
            print(msg)


def warn_or_err(msg: str) -> None:
    if _amp_state.hard_override:
        maybe_print("Warning: " + msg)
    else:
        raise RuntimeError(msg + "\nIf you're sure you know what you're "
                           "doing, supply hard_override=True to amp.initialize.")
