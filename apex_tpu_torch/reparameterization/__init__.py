"""Weight reparameterization (weight norm).

Counterpart of ``apex_tpu/reparameterization/__init__.py``: ``w = g * v /
||v||``, the norm in fp32 over every dim but ``dim``.
``apply_weight_norm(module, name="weight", dim=0)`` wraps a module in a
:class:`WeightNorm`, which replaces the inner module's parameter ``name``
by the parameters ``<name>_g`` (the magnitude, shaped like the norm with
its reduced dims kept) and ``<name>_v`` (the direction) and computes the
weight at every forward, so the wrapper's ``state_dict`` holds
``inner.<name>_g`` and ``inner.<name>_v`` where the JAX package's params
tree holds ``inner/<name>_g`` and ``inner/<name>_v``.
``remove_weight_norm`` bakes the current weight back into the inner
module and returns it.
"""

from __future__ import annotations

import torch

__all__ = ["compute_weight", "WeightNorm", "apply_weight_norm",
           "remove_weight_norm"]


def _norm_except_dim(v: torch.Tensor, dim: int) -> torch.Tensor:
    axes = tuple(a for a in range(v.dim()) if a != dim % v.dim())
    return torch.sqrt(torch.sum(torch.square(v.float()), dim=axes,
                                keepdim=True))


def compute_weight(g: torch.Tensor, v: torch.Tensor, dim: int,
                   eps: float = 0.0) -> torch.Tensor:
    """``g * v / (||v|| + eps)`` in fp32, cast to ``v``'s dtype."""
    n = _norm_except_dim(v, dim)
    return (g.float() * v.float() / (n + eps)).to(v.dtype)


class WeightNorm(torch.nn.Module):
    """``inner`` with its parameter ``name`` reparameterized as a
    magnitude ``<name>_g`` and a direction ``<name>_v``."""

    def __init__(self, inner: torch.nn.Module, name: str = "weight",
                 dim: int = 0):
        super().__init__()
        w = getattr(inner, name)
        del inner._parameters[name]
        inner.register_parameter(name + "_v", torch.nn.Parameter(
            w.detach().clone()))
        inner.register_parameter(name + "_g", torch.nn.Parameter(
            _norm_except_dim(w.detach(), dim)))
        setattr(inner, name, w.detach())
        self.inner = inner
        self.param_name = name
        self.dim = dim

    def weight(self) -> torch.Tensor:
        """The weight the current ``g`` and ``v`` give."""
        return compute_weight(getattr(self.inner, self.param_name + "_g"),
                              getattr(self.inner, self.param_name + "_v"),
                              self.dim)

    def forward(self, *args, **kwargs):
        setattr(self.inner, self.param_name, self.weight())
        return self.inner(*args, **kwargs)


def apply_weight_norm(module: torch.nn.Module, name: str = "weight",
                      dim: int = 0) -> WeightNorm:
    """Wrap ``module`` with weight normalization of its parameter
    ``name``."""
    return WeightNorm(module, name, dim)


def remove_weight_norm(wrapped: WeightNorm) -> torch.nn.Module:
    """The inner module with the current weight baked back in as the
    parameter ``name`` (``<name>_g`` and ``<name>_v`` removed)."""
    inner, name = wrapped.inner, wrapped.param_name
    w = wrapped.weight().detach()
    del inner._parameters[name + "_g"], inner._parameters[name + "_v"]
    if name in inner.__dict__:
        delattr(inner, name)
    inner.register_parameter(name, torch.nn.Parameter(w))
    return inner
