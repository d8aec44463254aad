"""Automatic mixed precision, with the reference Apex's API::

    model, optimizer = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                      opt_level="O2")
    with amp.scale_loss(loss, optimizer) as scaled_loss:
        scaled_loss.backward()
    optimizer.step()
    optimizer.zero_grad()
"""

from ._amp_state import master_params
from ._process_optimizer import AmpOptimizer, FlatMasters
from .frontend import Properties, initialize, opt_levels
from .handle import scale_loss
from .scaler import LossScaler, ScalerState

__all__ = ["initialize", "scale_loss", "master_params", "AmpOptimizer",
           "FlatMasters", "LossScaler", "ScalerState", "Properties",
           "opt_levels"]
