"""``amp.scale_loss``, the reference Apex's context manager, and the JAX
package's functional forms ``scaled_grad`` and ``scaled_grad_accum``.

Counterpart of ``apex_tpu/amp/handle.py``.  PyTorch has a tape, so
``loss`` is a tensor (the JAX package takes a callable).  On entry the
model's grads are cleared and the loss is scaled; on exit this backward's
grads are unscaled into the optimizer's flat stash (the scale kernel,
then axpby for every later backward of the step) and, unless
``delay_unscale``, the loss scaler is updated.  An overflowed step is
skipped on the device by the next ``optimizer.step()``.  One optimizer
a context, as in the JAX package.  ``disable_casts`` is the O1 escape
hatch (``policy.disable_casts``).

The functional forms take ``torch.autograd.grad`` where the JAX package
takes ``jax.value_and_grad``: grads of ``loss.float() * loss_scale`` with
respect to the parameters bound to the optimizer (the half parameters
under O2, as the JAX package differentiates its cast params), returned
as a list in the optimizer's layout order for ``optimizer.step(grads)``.
Nothing is accumulated into ``.grad``, so no hook on it fires (the data-
parallel wrapper's end-of-backward reduce among them): the caller reduces
the returned grads with ``DistributedDataParallel.allreduce_grads``.
Both read the loss scale from the device and write nothing back to the
host, so a step built on them can be captured in a CUDA graph
(``DistributedDataParallel.make_step``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List

import torch

from .._graph import leaves, tree_map
from ._process_optimizer import AmpOptimizer
from .policy import disable_casts

__all__ = ["scale_loss", "scaled_grad", "scaled_grad_accum",
           "disable_casts"]


def _require_amp(optimizer) -> AmpOptimizer:
    if isinstance(optimizer, (list, tuple)):
        raise NotImplementedError("pass a single optimizer")
    if not isinstance(optimizer, AmpOptimizer):
        raise TypeError("needs the optimizer amp.initialize returned, got "
                        f"{type(optimizer).__name__}")
    optimizer._require_bound()
    return optimizer


def _detached(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree


def _grads(scaled_loss: torch.Tensor, opt: AmpOptimizer
           ) -> List[torch.Tensor]:
    """d scaled_loss / d bound params, in layout order (zeros where a
    parameter takes no part or needs no grad); under ZeRO-3, d scaled_loss
    / d the master window (``amp.zero_gather_params``'s backward reduced
    it), one flat tensor."""
    if opt._zero is not None and opt._zero.stage == 3:
        (g,) = torch.autograd.grad(scaled_loss, [opt._zero_leaf])
        return g
    params = opt._params
    live = [p for p in params if p.requires_grad]
    got = iter(torch.autograd.grad(scaled_loss, live, allow_unused=True))
    out = []
    for p in params:
        g = next(got) if p.requires_grad else None
        out.append(torch.zeros_like(p) if g is None else g)
    return out


def scaled_grad(loss_fn: Callable, optimizer: AmpOptimizer, *args,
                loss_id: int = 0, has_aux: bool = False, **kwargs):
    """Grads of ``loss * loss_scale`` (``apex_tpu/amp/handle.py:36``).

    ``loss_fn(*args, **kwargs)`` runs on the model bound to ``optimizer``
    and returns the loss, or ``(loss, aux)`` with ``has_aux``.  Returns
    ``(loss, scaled_grads)`` or ``(loss, aux, scaled_grads)``: ``loss``
    unscaled (``loss.float() * scale / scale``, as the JAX package
    returns it), ``aux`` detached, the grads a list in the optimizer's
    layout order to pass to ``optimizer.step``, which unscales them."""
    opt = _require_amp(optimizer)
    scale = opt.scalers[loss_id].loss_scale
    res = loss_fn(*args, **kwargs)
    loss, aux = res if has_aux else (res, None)
    scaled = loss.float() * scale
    grads = _grads(scaled, opt)
    loss = scaled.detach() / scale
    if has_aux:
        return loss, _detached(aux), grads
    return loss, grads


def scaled_grad_accum(loss_fn: Callable, optimizer: AmpOptimizer,
                      batches: Any, loss_id: int = 0, average: bool = True):
    """Gradient accumulation over K micro-batches for one optimizer step
    (``apex_tpu/amp/handle.py:68``).

    ``loss_fn(microbatch) -> loss``; ``batches`` is a tensor, or a tuple,
    list or dict of them, each leading with the K axis.  The scaled grads
    of the K backward passes are summed into an fp32 accumulator (the
    JAX package's ``lax.scan`` carry), so an inf in any micro-batch
    reaches the step's overflow flag.  ``average`` divides grads and loss
    by K (one big batch of the concatenated micro-batches); otherwise the
    sums.  Returns ``(loss, scaled_grads)`` for ``optimizer.step``."""
    opt = _require_amp(optimizer)
    if opt._zero is not None and opt._zero.stage == 3:
        raise NotImplementedError("scaled_grad_accum under ZeRO-3: "
                                  "accumulate the grad windows of "
                                  "scaled_grad instead")
    scale = opt.scalers[loss_id].loss_scale
    K = leaves(batches)[0].shape[0]
    layout = opt.masters.layout
    acc = torch.zeros(layout.total, dtype=torch.float32,
                      device=opt.masters.buf.device)
    # fp32 views, one a parameter, over the one accumulator
    views = [acc[o:o + n].view(p.shape) for o, n, p in
             zip(layout.offsets, layout.sizes, opt._params)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=acc.device)
    for k in range(K):
        scaled = loss_fn(tree_map(lambda t, k=k: t[k], batches)).float() \
            * scale
        for v, g in zip(views, _grads(scaled, opt)):
            v.add_(g)
        loss_sum = loss_sum + scaled.detach()
    if average:
        acc.div_(K)
        return loss_sum / scale / K, views
    return loss_sum / scale, views


@contextlib.contextmanager
def scale_loss(loss: torch.Tensor, optimizer: AmpOptimizer, loss_id: int = 0,
               model=None, delay_unscale: bool = False,
               delay_overflow_check: bool = False):
    if isinstance(optimizer, (list, tuple)):
        raise NotImplementedError(
            "pass a single optimizer per scale_loss context")
    if not isinstance(optimizer, AmpOptimizer):
        raise TypeError("scale_loss needs the optimizer amp.initialize "
                        f"returned, got {type(optimizer).__name__}")
    if not isinstance(loss, torch.Tensor):
        raise TypeError(f"loss must be a tensor, got {type(loss).__name__}")
    optimizer._prepare_backward()
    yield optimizer.scaler.scale_loss(loss, optimizer.scalers[loss_id])
    optimizer._post_backward(loss_id,
                             delay_unscale or delay_overflow_check)
