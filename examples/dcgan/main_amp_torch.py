"""DCGAN training example for apex_tpu_torch, the PyTorch / NVIDIA GPU
port of examples/dcgan/main_amp.py (the JAX package's), with its flags
and defaults: two models and two optimizers under one amp.initialize
call, each optimizer with its own loss scaler.  An iteration is the JAX
example's step: the D step on a real batch and on the detached fake, then
the G step through the updated D, each through the functional step
(amp.scaled_grad, optimizer.step(grads)).

BatchNorm running statistics are updated as the JAX step threads its
state: the forward that makes the fake for the D step updates none of G's
(the JAX step drops that state), D's run from the real batch to the fake
one, the G step's pass through D updates none of D's (dropped there too),
and G keeps the statistics of its second forward.  A forward whose state
the JAX step drops runs with the BatchNorms' ``track_running_stats`` off:
batch statistics, no update.  Synthetic 64x64 data from
np.random.RandomState(seed), as the JAX example draws it.

Run on the GPU:
  python examples/dcgan/main_amp_torch.py
Run on the CPU (the plain versions of the kernels):
  python examples/dcgan/main_amp_torch.py --device cpu -b 8 --iters 5 \\
      --ngf 16 --ndf 16

``main(argv)`` runs in process and returns the run: the losses (an
(iters, 2) tensor of loss_D, loss_G), ms/it (over all iterations, and
after the first, which builds the kernels and autotunes cuDNN), the
models and the optimizers.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

# allow running straight from a source checkout
_repo = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
if (os.path.isdir(os.path.join(_repo, "apex_tpu_torch"))
        and _repo not in sys.path):
    sys.path.insert(0, _repo)

from apex_tpu_torch import amp, models, nn, optimizers  # noqa: E402
from apex_tpu_torch._device import resolve_device  # noqa: E402
from apex_tpu_torch.nn import functional as F  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch DCGAN")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--opt-level", default="O1")
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--half-dtype", default=None,
                   choices=[None, "bfloat16", "float16"])
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    return p.parse_args(argv)


@contextlib.contextmanager
def frozen_stats(model):
    """Forwards in train mode on batch statistics that leave the running
    statistics alone (a state the JAX step drops)."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)
           and m.track_running_stats]
    for m in bns:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.track_running_stats = True


def batch(rng, args, device):
    """One iteration's real images and z, drawn as the JAX example draws
    them."""
    real = rng.randn(args.batch_size, 3, 64, 64).astype(np.float32)
    z = rng.randn(args.batch_size, args.nz, 1, 1).astype(np.float32)
    return (torch.from_numpy(real).to(device, non_blocking=True),
            torch.from_numpy(z).to(device, non_blocking=True))


def train_step(netD, netG, optD, optG, real, z):
    """One iteration (the JAX example's ``train_step``); returns the
    losses (loss_D, loss_G) as 0-d tensors."""
    with frozen_stats(netG), torch.no_grad():
        fake = netG(z)

    # D: real up, fake down; D's statistics run from real to fake
    def d_loss():
        logit_real = netD(real)
        logit_fake = netD(fake)
        return (F.binary_cross_entropy_with_logits(
            logit_real, torch.ones_like(logit_real))
            + F.binary_cross_entropy_with_logits(
                logit_fake, torch.zeros_like(logit_fake)))

    loss_d, grads = amp.scaled_grad(d_loss, optD)
    optD.step(grads)

    # G: fool the updated D; G keeps its second forward's statistics
    def g_loss():
        out = netG(z)
        with frozen_stats(netD):
            logit = netD(out)
        return F.binary_cross_entropy_with_logits(logit,
                                                  torch.ones_like(logit))

    loss_g, grads = amp.scaled_grad(g_loss, optG)
    optG.step(grads)
    return loss_d, loss_g


def build(args, device):
    """The two models and optimizers under one amp.initialize."""
    netG, netD = models.dcgan(
        nz=args.nz, ngf=args.ngf, ndf=args.ndf, device=device,
        generator=torch.Generator().manual_seed(args.seed))
    optG = optimizers.FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    optD = optimizers.FusedAdam(lr=args.lr, betas=(args.beta1, 0.999))
    (netD, netG), (optD, optG) = amp.initialize(
        [netD, netG], [optD, optG], opt_level=args.opt_level,
        loss_scale=args.loss_scale, half_dtype=args.half_dtype, verbosity=0)
    return netD, netG, optD, optG


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    try:
        netD, netG, optD, optG = build(args, device)
        rng = np.random.RandomState(args.seed)
        losses = []
        t0 = t1 = time.time()
        for i in range(args.iters):
            real, z = batch(rng, args, device)
            loss_d, loss_g = train_step(netD, netG, optD, optG, real, z)
            losses.append(torch.stack([loss_d, loss_g]))
            if i == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t1 = time.time()
            if i % args.print_freq == 0 or i == args.iters - 1:
                ld, lg = losses[-1].tolist()
                print(f"[{i:4d}/{args.iters}] loss_D {ld:7.4f} "
                      f"loss_G {lg:7.4f} "
                      f"({(time.time() - t0) / (i + 1) * 1000:.1f} ms/it)",
                      flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.time()
        ms = (t2 - t0) / max(args.iters, 1) * 1000
        ms_rest = (t2 - t1) / max(args.iters - 1, 1) * 1000
        print("done", flush=True)
    finally:
        amp.set_policy(amp.NoPolicy())      # O1's cast policy is global
    return {"losses": torch.stack(losses).cpu() if losses else None,
            "ms_per_it": ms, "ms_per_it_after_first": ms_rest, "netD": netD,
            "netG": netG, "optD": optD, "optG": optG}


if __name__ == "__main__":
    main()
