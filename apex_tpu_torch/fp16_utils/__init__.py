"""The manual mixed-precision toolkit: the master-parameter helpers, the
legacy ``FP16_Optimizer`` and loss scalers.

Counterpart of ``apex_tpu/fp16_utils/__init__.py``, with its exports and
its working ``Fused_Weight_Norm``.
"""

from .fp16util import (BN_convert_float, FP16Model, clip_grad_norm,
                       convert_network, master_params_to_model_params,
                       model_grads_to_master_grads, network_to_half,
                       prep_param_lists, tofp16)
from .fp16_optimizer import FP16_Optimizer
from .loss_scaler import DynamicLossScaler, LossScaler

__all__ = ["BN_convert_float", "FP16Model", "clip_grad_norm",
           "convert_network", "master_params_to_model_params",
           "model_grads_to_master_grads", "network_to_half",
           "prep_param_lists", "tofp16", "FP16_Optimizer", "LossScaler",
           "DynamicLossScaler", "Fused_Weight_Norm"]


class Fused_Weight_Norm:
    """The fused weight norm that the reference's reparameterization
    imports from fp16_utils (its own snapshot no longer defines it):
    ``w = g * v / ||v||`` in fp32 over every dim but ``dim``, cast back to
    ``v``'s dtype (``reparameterization.compute_weight``)."""

    @staticmethod
    def apply(v, g, dim: int = 0):
        from ..reparameterization import compute_weight
        return compute_weight(g, v, dim)

    def __call__(self, v, g, dim: int = 0):
        return self.apply(v, g, dim)
