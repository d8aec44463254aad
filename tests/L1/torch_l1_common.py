"""Shared L1 runner of the port: train ResNet-18 under one amp config and
record the exact loss trajectory and a digest of the final parameters.

Twin of ``tests/L1/l1_common.py``, in PyTorch.  The reference's two runs,
its CUDA extensions against its Python-only build, are here the run on
the card (the CUDA kernels) against the run on the CPU (their plain
versions), chosen by the device alone.  It imports torch and
apex_tpu_torch only.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import amp, models, optimizers
from apex_tpu_torch.amp._process_optimizer import jax_leaf_order
from apex_tpu_torch.nn.functional import cross_entropy


def _param_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


def train_one(opt_level: str, loss_scale: Optional[str],
              keep_bn: Optional[str], device: str = "cuda", iters: int = 100,
              batch: int = 16, image: int = 32, arch: str = "resnet18",
              lr: float = 1e-3, nbatches: int = 10, nudge: bool = False):
    """Returns (loss trajectory as float32 array, sha256 of the final
    parameters in the JAX tree's leaf order).  ``nudge`` moves every
    input value one ulp up: the run's own sensitivity to rounding.

    On the card cuDNN is set deterministic (``deterministic = True``,
    ``benchmark = False``) and TF32 off for the run, and restored after:
    two runs of one config are then the same bits."""
    dev = torch.device(device)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, optimizer = amp.initialize(
            getattr(models, arch)(num_classes=10, device=dev,
                                  generator=torch.Generator().manual_seed(0)),
            optimizers.FusedAdam(lr=lr), opt_level=opt_level,
            loss_scale=loss_scale, keep_batchnorm_fp32=keep_bn,
            verbosity=0, hard_override=True)
        rng = np.random.RandomState(0)
        xs = torch.from_numpy(rng.randn(nbatches, batch, 3, image, image)
                              .astype(np.float32))
        if nudge:
            xs = torch.nextafter(xs, torch.full_like(xs, np.inf))
        xs = xs.to(dev)
        ys = torch.from_numpy(rng.randint(0, 10, (nbatches, batch))
                              .astype(np.int64)).to(dev)
        traj = np.zeros((iters,), np.float32)
        for i in range(iters):
            loss = cross_entropy(model(xs[i % nbatches]), ys[i % nbatches])
            with amp.scale_loss(loss, optimizer) as scaled:
                scaled.backward()
            optimizer.step()
            traj[i] = np.float32(float(loss.detach()))
        params = dict(model.named_parameters())
        digest = hashlib.sha256()
        for name in jax_leaf_order(list(params)):
            digest.update(_param_bytes(params[name]))
        return traj, digest.hexdigest()
    finally:
        amp.set_policy(amp.NoPolicy())   # O1's cast policy is global
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# the reference driver's matrix (tests/L1/common/run_test.sh:64-135):
# {O0..O3} x {default, 1.0, 128.0, dynamic} x {keep_batchnorm_fp32 unset/
# True/False}
FULL_MATRIX = [
    (ol, ls, kbn)
    for ol in ("O0", "O1", "O2", "O3")
    for ls in (None, "1.0", "128.0", "dynamic")
    for kbn in (None, "True", "False")
]


def is_fp32_config(opt_level: str) -> bool:
    """Configs whose whole numeric path is fp32."""
    return opt_level == "O0"
