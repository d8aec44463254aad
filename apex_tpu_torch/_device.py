"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU: it raises when there is none, instead of
    carrying on quietly on the CPU.  ``"cpu"`` (what the tests pass) and
    any explicit device are taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
