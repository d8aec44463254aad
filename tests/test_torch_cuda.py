"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU.  The
file imports neither jax nor apex_tpu, so that on a machine with a GPU
and no jax it runs without the repository's conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``chip_smoke.py`` runs the same comparisons at the main path's sizes.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import nn, ops
from apex_tpu_torch.ops import adam as adam_mod
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops import syncbn as sbn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099, 1_000_003])
def test_cuda_kernels_match_plain(cuda, n):
    rs = np.random.RandomState(7)
    x = _t(rs.randn(n).astype(np.float32)).to(cuda)
    y = _t(rs.randn(n).astype(np.float32)).to(cuda)
    x[n // 2] = float("inf")
    out, flag = ops.multi_tensor_scale(x, 0.5)
    pout, pflag = mt._scale_plain(x, torch.tensor(0.5, device=cuda),
                                  torch.empty_like(x))
    assert torch.equal(out, pout) and float(flag) == float(pflag) == 1.0
    out, flag = ops.multi_tensor_axpby(0.3, -1.7, x, y, 1)
    pout, pflag = mt._axpby_plain(torch.tensor(0.3, device=cuda),
                                  torch.tensor(-1.7, device=cuda), x, y, 1,
                                  torch.empty_like(x))
    assert torch.equal(out, pout) and float(flag) == float(pflag) == 0.0
    norm = ops.multi_tensor_l2norm(y)
    torch.testing.assert_close(norm, mt._l2norm_plain(y), rtol=1e-6, atol=0)
    bufs = [y.clone(), y.abs() * 0.1, y.abs() * 0.01, x.nan_to_num(0.0)]
    pbufs = [b.clone() for b in bufs]
    h, ph = (torch.empty(n, dtype=torch.bfloat16, device=cuda)
             for _ in range(2))
    args = (torch.tensor(1e-3, device=cuda), torch.tensor(0.5, device=cuda),
            0.9, 0.999, 1e-8, False, 0.01)
    ops.fused_adam(*bufs, *args, half=h)
    adam_mod._adam_plain(*pbufs, *args, ph, None)
    for a, b in zip(bufs[:3] + [h], pbufs[:3] + [ph]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrappers_count_their_launches(cuda):
    x = torch.ones(4099, device=cuda)
    one = torch.ones((), device=cuda)
    ops.reset_launch_counts()
    ops.multi_tensor_scale(x, 0.5)
    ops.multi_tensor_axpby(1.0, 1.0, x, x)
    ops.multi_tensor_l2norm(x)
    ops.fused_adam(x.clone(), x.clone(), x.clone(), x, one, one, 0.9, 0.999,
                   1e-8, False, 0.0)
    c = torch.ones(3, device=cuda)
    xb = torch.ones(2, 3, 4, 4, device=cuda)
    ops.syncbn_fwd(xb, c, c, c, c)
    ops.syncbn_bwd(xb, xb, c, c, c)
    assert ops.launch_counts() == {"multi_tensor_scale": 1,
                                   "multi_tensor_axpby": 1,
                                   "multi_tensor_l2norm": 1, "fused_adam": 1,
                                   "syncbn_fwd": 1, "syncbn_bwd": 1}
    # the plain versions, on CPU tensors, launch nothing
    ops.multi_tensor_scale(x.cpu(), 0.5)
    assert ops.launch_counts()["multi_tensor_scale"] == 1
    with pytest.raises(ValueError):
        ops.multi_tensor_axpby(1.0, 1.0, x, x.cpu())


def _bn_case(shape, dtype, cuda, seed=0, misalign=False):
    rs = np.random.RandomState(seed)
    C = shape[1]
    n = int(np.prod(shape))

    def act(scale, shift):
        a = _t((rs.randn(n + 1) * scale + shift).astype(np.float32))
        a = a.to(dtype).to(cuda)
        # one element in: contiguous, but off the 4-element alignment
        return (a[1:] if misalign else a[:n]).view(shape)

    x, dy = act(2.0, 0.5), act(1.0, 0.0)
    mean = _t(rs.randn(C).astype(np.float32)).to(cuda)
    inv = torch.rsqrt(_t((rs.rand(C) + 0.1).astype(np.float32)).to(cuda)
                      + 1e-5)
    w = _t(rs.randn(C).astype(np.float32)).to(cuda)
    b = _t(rs.randn(C).astype(np.float32)).to(cuda)
    return x, dy, mean, inv, w, b


def _row_sum_ratio(sums: torch.Tensor, terms: torch.Tensor) -> float:
    """The largest error of fp32 row sums against the fp64 sums of the same
    terms, over f(hw) * 2**-24 * sum |term| with f(hw) = min(hw - 1,
    max(sqrt(hw), 8)): sqrt(hw), the probabilistic bound on a sum's
    rounding error, from hw = 64 on (as chip_smoke.py holds them)."""
    hw = terms.shape[2] * terms.shape[3]
    t = terms.double()
    err = (sums.double() - t.sum(dim=(2, 3))).abs()
    bound = (min(hw - 1, max(hw ** 0.5, 8.0)) * 2.0 ** -24
             * t.abs().sum(dim=(2, 3)))
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max())


# HW = 1, 15, 49 and 12,544 (the stem's plane), odd C, and 4-element
# vectors (HW % 4 == 0) with and without alignment
@pytest.mark.cuda
@pytest.mark.parametrize("shape,misalign", [
    ((2, 3, 1, 1), False), ((3, 5, 3, 5), False), ((3, 37, 7, 7), False),
    ((2, 7, 12, 12), False), ((2, 7, 12, 12), True),
    ((2, 64, 112, 112), False), ((4, 2048, 7, 7), False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_syncbn_kernels_match_plain(cuda, shape, misalign, dtype):
    x, dy, mean, inv, w, b = _bn_case(shape, dtype, cuda,
                                      misalign=misalign)
    y = ops.syncbn_fwd(x, mean, inv, w, b)
    assert torch.equal(y, sbn._fwd_plain(x, mean, inv, w, b))
    dx, sdy, sdyx = ops.syncbn_bwd(dy, x, mean, inv, w)
    pdx, psdy, psdyx = sbn._bwd_plain(dy, x, mean, inv, w)
    torch.cuda.synchronize()
    assert torch.equal(dx, pdx)
    d = dy.float()
    xhat = (x.float() - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    for sums, terms in ((sdy, d), (sdyx, d * xhat), (psdy, d),
                        (psdyx, d * xhat)):
        assert _row_sum_ratio(sums, terms) <= 1.0


@pytest.mark.cuda
def test_batchnorm_module_on_the_card_matches_the_cpu(cuda):
    """BatchNorm2d train step (statistics in torch ops, the apply through
    the kernels) on the card against the plain versions on the CPU."""
    rs = np.random.RandomState(3)
    x = _t(rs.randn(8, 6, 9, 9).astype(np.float32))
    g = _t(rs.randn(8, 6, 9, 9).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        bn = nn.BatchNorm2d(6, device=dev)
        xi = x.to(dev).detach().requires_grad_()
        y = bn(xi)
        (y * g.to(dev)).sum().backward()
        out[str(dev)] = [t.detach().cpu() for t in
                         (y, xi.grad, bn.weight.grad, bn.bias.grad,
                          bn.running_var)]
    # the statistics are reductions in another order on each device
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
