"""DCGAN generator and discriminator (the 64x64 topology of Radford et
al. 2015, the reference Apex's DCGAN example).

Counterpart of ``apex_tpu/models/dcgan.py``, built from the port's layers:
the generator upsamples z (B, nz, 1, 1) to (B, nc, 64, 64) through strided
transposed convolutions with BatchNorm and ReLU and a final Tanh; the
discriminator mirrors it down with LeakyReLU(0.2) to one logit a sample,
returned as (B,) logits for ``binary_cross_entropy_with_logits``.  Both
are ``torch.nn.Sequential`` under ``main``, so their state dicts are named
as the JAX package's trees (``main.0.weight``, ``main.1.running_mean``).
Weights are drawn on the CPU from ``generator`` and moved to ``device``.
"""

from __future__ import annotations

import torch

from .. import nn

__all__ = ["Generator", "Discriminator", "dcgan"]


class Generator(torch.nn.Module):
    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 3, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.nz = nz
        kw = dict(device=device, generator=generator)
        self.main = torch.nn.Sequential(
            # (nz, 1, 1) -> (ngf*8, 4, 4)
            nn.ConvTranspose2d(nz, ngf * 8, 4, 1, 0, bias=False, **kw),
            nn.BatchNorm2d(ngf * 8, device=device), nn.ReLU(),
            # -> (ngf*4, 8, 8)
            nn.ConvTranspose2d(ngf * 8, ngf * 4, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ngf * 4, device=device), nn.ReLU(),
            # -> (ngf*2, 16, 16)
            nn.ConvTranspose2d(ngf * 4, ngf * 2, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ngf * 2, device=device), nn.ReLU(),
            # -> (ngf, 32, 32)
            nn.ConvTranspose2d(ngf * 2, ngf, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ngf, device=device), nn.ReLU(),
            # -> (nc, 64, 64)
            nn.ConvTranspose2d(ngf, nc, 4, 2, 1, bias=False, **kw),
            nn.Tanh())

    def forward(self, z):
        return self.main(z)


class Discriminator(torch.nn.Module):
    def __init__(self, ndf: int = 64, nc: int = 3, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.main = torch.nn.Sequential(
            # (nc, 64, 64) -> (ndf, 32, 32)
            nn.Conv2d(nc, ndf, 4, 2, 1, bias=False, **kw),
            nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, ndf * 2, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ndf * 2, device=device), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf * 2, ndf * 4, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ndf * 4, device=device), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf * 4, ndf * 8, 4, 2, 1, bias=False, **kw),
            nn.BatchNorm2d(ndf * 8, device=device), nn.LeakyReLU(0.2),
            # -> (1, 1, 1) logit
            nn.Conv2d(ndf * 8, 1, 4, 1, 0, bias=False, **kw))

    def forward(self, x):
        out = self.main(x)
        return out.reshape(out.shape[0])     # (B,) logits


def dcgan(nz: int = 100, ngf: int = 64, ndf: int = 64, nc: int = 3, *,
          device=None, generator: torch.Generator):
    """``(Generator, Discriminator)``, drawn in that order from
    ``generator``."""
    kw = dict(device=device, generator=generator)
    return Generator(nz, ngf, nc, **kw), Discriminator(ndf, nc, **kw)
