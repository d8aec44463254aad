"""Weights between the JAX package's trees and the port's ``state_dict``.

Numpy only: the JAX package's ``(params, state)`` come in as nested dicts
of numpy arrays (``np.asarray`` of each leaf) and go out the same way.
``params`` is nested by module (``{"layer1": {"0": {"bn1": {"weight":
...}}}}``); ``state`` is flat, keyed by module path (``{"layer1.0.bn1":
{"running_mean": ..., ...}}``).  The port's names join the two with dots
(``layer1.0.bn1.weight``, ``layer1.0.bn1.running_mean``), and dtypes are
kept as they are, bfloat16 included.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "STATE_KEYS"]

# the leaves of the JAX package's BatchNorm state dict
STATE_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                  # only numpy's view of bf16 needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(v, name, out)
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
