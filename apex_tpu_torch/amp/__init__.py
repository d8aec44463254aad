"""Automatic mixed precision, with the reference Apex's API::

    model, optimizer = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                      opt_level="O2")
    with amp.scale_loss(loss, optimizer) as scaled_loss:
        scaled_loss.backward()
    optimizer.step()
    optimizer.zero_grad()

or the JAX package's functional step, which a CUDA graph can capture
(``parallel.DistributedDataParallel.make_step``)::

    loss, grads = amp.scaled_grad(loss_fn, optimizer, x, y)
    info = optimizer.step(grads)

with ZeRO (``optimizer.zero_shard(zero_stage=...)``, then the functional
step; ``zero_gather_params`` for stage 3), and its checkpoint::

    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "amp": amp.state_dict(optimizer)}, path)
    ...
    model.load_state_dict(ck["model"])
    optimizer.load_state_dict(ck["optimizer"])
    amp.load_state_dict(optimizer, ck["amp"])

plus the O1 registries (``register_half_function`` etc.), the cast
policies and the scaler introspection calls.
"""

from . import lists, policy
from ._amp_state import master_params
from ._process_optimizer import (AmpOptimizer, FlatMasters,
                                 zero_gather_checkpoint_policy,
                                 zero_gather_params, zero_optimizer_specs)
from .frontend import (Properties, amp_stats, compute_dtype,
                       current_loss_scale, initialize, opt_levels,
                       scaler_state, steps_skipped)
from .handle import (disable_casts, scale_loss, scaled_grad,
                     scaled_grad_accum)
from .lists import (register_float_function, register_half_function,
                    register_promote_function)
from .policy import (CastPolicy, NoPolicy, current_policy, float_function,
                     half_function, promote_function, set_policy,
                     use_policy)
from .scaler import LossScaler, ScalerState

__all__ = ["initialize", "scale_loss", "scaled_grad", "scaled_grad_accum",
           "master_params", "AmpOptimizer", "zero_optimizer_specs",
           "zero_gather_params", "zero_gather_checkpoint_policy",
           "FlatMasters", "LossScaler", "ScalerState", "Properties",
           "opt_levels", "compute_dtype", "scaler_state",
           "current_loss_scale", "steps_skipped", "amp_stats",
           "state_dict", "load_state_dict", "disable_casts", "lists",
           "policy", "CastPolicy", "NoPolicy", "current_policy",
           "set_policy", "use_policy", "half_function", "float_function",
           "promote_function", "register_half_function",
           "register_float_function", "register_promote_function"]


def state_dict(optimizer) -> dict:
    """The amp state of an optimizer ``amp.initialize`` returned, or of a
    list of them: its loss scalers, ``{"scalers": [{"loss_scale",
    "unskipped", "steps_skipped"}, ...]}`` (a list of such dicts for a
    list), the JAX package's ``amp.state_dict``."""
    if isinstance(optimizer, (list, tuple)):
        return [state_dict(o) for o in optimizer]
    return {"scalers": optimizer.scalers_state_dict()}


def load_state_dict(optimizer, sd) -> None:
    """Load what :func:`state_dict` gave into the scalers of ``optimizer``
    (or of each optimizer of a list), in place."""
    if isinstance(optimizer, (list, tuple)):
        if len(sd) != len(optimizer):
            raise ValueError(f"{len(sd)} amp states for {len(optimizer)} "
                             f"optimizers")
        for o, s in zip(optimizer, sd):
            load_state_dict(o, s)
        return
    optimizer.load_scalers_state_dict(sd["scalers"])
