"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU.  The
file imports neither jax nor apex_tpu, so that on a machine with a GPU
and no jax it runs without the repository's conftest::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

``chip_smoke.py`` runs the same comparisons at the main path's sizes.
"""

import contextlib

import numpy as np
import pytest
import torch

from apex_tpu_torch import nn, ops
from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
from apex_tpu_torch.ops import adam as adam_mod
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import lamb as lamb_mod
from apex_tpu_torch.ops import layer_norm as lnm
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.ops import syncbn as sbn
import torch_threads  # noqa: F401  (one torch thread a process)


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
@pytest.mark.parametrize("n", [3, 13, 4097, 1_048_579, 4_000_001])
@pytest.mark.parametrize("arg", [0, 1, -1])
def test_axpby_matches_plain_at_ragged_lengths(cuda, n, arg):
    """Lengths that are not a multiple of 4 (the scalar tail) around the
    kernel's unrolled float4 runs and its resident grid: out and flag
    bitwise the plain version's, an inf in the tail of x or y seen by
    the checks that cover it, and out aliasing y."""
    rs = np.random.RandomState(n % 101)
    x = _t(rs.randn(n).astype(np.float32)).to(cuda)
    y = _t(rs.randn(n).astype(np.float32)).to(cuda)
    a = torch.tensor(1.0 / 1024.0, device=cuda)
    b = torch.tensor(-0.75, device=cuda)
    for bad in (None, "x", "y"):
        xi, yi = x.clone(), y.clone()
        if bad:
            (xi if bad == "x" else yi)[n - 1] = float("inf")
        out, flag = ops.multi_tensor_axpby(a, b, xi, yi, arg)
        pout, pflag = mt._axpby_plain(a, b, xi, yi, arg,
                                      torch.empty_like(xi))
        want = float(bad is not None and (arg == -1 or (arg == 0)
                                          == (bad == "x")))
        assert torch.equal(out.isnan(), pout.isnan())
        assert torch.equal(out.nan_to_num(0.0), pout.nan_to_num(0.0))
        assert float(flag) == float(pflag) == want
    yi = y.clone()
    ops.multi_tensor_axpby(a, b, x, yi, arg, out=yi)
    assert torch.equal(yi, mt._axpby_plain(a, b, x, y, arg,
                                           torch.empty_like(x))[0])


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
    x2 = torch.ones(5, 7, device=cuda)
    _, mean, inv = ops.layer_norm_fwd(x2, None, None, 1e-5)
    ops.layer_norm_bwd(x2, x2, None, mean, inv)
    q3 = torch.ones(2, 9, 8, device=cuda)
    o, lse = ops.flash_fwd(q3, q3, q3, 1, 0.5)
    ops.flash_dq(q3, q3, q3, q3, lse, lse, 1, 0.5)
    ops.flash_dkv(q3, q3, q3, q3, lse, lse, 1, 0.5)
    table = ChunkedFlatLayout([x[:4000], x[4000:]]).chunk_table(cuda)
    ops.multi_tensor_l2norm_per_tensor(x, table)
    u = ops.lamb_stage1(x, x, x.clone(), x.clone(), 1.0, 1.0, 1.0, 0.9, 0.999,
                        0.1, 1e-6, 0.0, True)
    ops.lamb_stage2(x.clone(), u, torch.ones(2, device=cuda), table, 0.1)
    assert ops.launch_counts() == dict.fromkeys(ops.WRAPPERS, 1)
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


# -- LayerNorm ----------------------------------------------------------------

# widths in registers (1, 100, 768, 1024) and streamed (1500); BERT-base's
# and BERT-large's shapes, and a tail of one row (4097)
@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(7, 1), (33, 100), (4096, 768),
                                   (300, 1024), (9, 1500), (1024, 1024),
                                   (4097, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_kernels_match_plain(cuda, n1, n2, dtype, affine):
    rs = np.random.RandomState(n2)
    x = (_t(rs.randn(n1, n2).astype(np.float32)) * 3 + 1).to(dtype).to(cuda)
    dy = _t(rs.randn(n1, n2).astype(np.float32)).to(dtype).to(cuda)
    w = _t(rs.randn(n2).astype(np.float32)).to(cuda) if affine else None
    b = _t(rs.randn(n2).astype(np.float32)).to(cuda) if affine else None
    got = ops.layer_norm_fwd(x, w, b, 1e-5)
    ones, zeros = torch.ones(n2, device=cuda), torch.zeros(n2, device=cuda)
    want = lnm._fwd_plain(x, w if affine else ones, b if affine else zeros,
                          1e-5)
    # the row sums run in another order: fp32 rounding on the statistics,
    # one unit of the output type's last place on y
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
    for g, p in zip(got, want):
        torch.testing.assert_close(g.float(), p.float(), rtol=tol[dtype],
                                   atol=tol[dtype])
    mean, inv = want[1], want[2]
    got = ops.layer_norm_bwd(dy, x, w, mean, inv)
    want = lnm._bwd_plain(dy, x, w if affine else ones, mean, inv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=tol[dtype], atol=tol[dtype])
    # dw and db: column sums over n1 rows, within 1e-5 of the sum of |term|
    d = dy.float()
    xhat = (x.float() - mean[:, None]) * inv[:, None]
    for g, terms in ((got[1], d * xhat), (got[2], d)):
        err = (g.double() - terms.double().sum(0)).abs()
        assert bool((err <= 1e-5 * terms.double().abs().sum(0) + 1e-30)
                    .all())
    # the same bits on a second run (no atomics)
    again = ops.layer_norm_bwd(dy, x, w, mean, inv)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def _off16(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous view one element past a fresh
    allocation: contiguous, but off 16 bytes."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def _ln_bwd_inputs(cuda, n1, n2, dtype, seed):
    rs = np.random.RandomState(seed)
    x = (_t(rs.randn(n1, n2).astype(np.float32)) * 3 + 1).to(dtype).to(cuda)
    dy = _t(rs.randn(n1, n2).astype(np.float32)).to(dtype).to(cuda)
    w = _t(rs.randn(n2).astype(np.float32)).to(cuda)
    _, mean, inv = lnm._fwd_plain(x, w, torch.zeros_like(w), 1e-5)
    return dy, x, w, mean, inv


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(33, 104), (4096, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_bwd_misaligned_view_takes_the_element_path(cuda, n1, n2,
                                                                dtype):
    """dy, x and w as contiguous views off 16 bytes: the host picks the
    element path (the same rows, aligned, take the vector path), and it
    holds as the vector path does: dx within one unit of the type's last
    place of the plain version, dw and db within 1e-5 of the sum of
    |term|, the same bits on a second launch."""
    dy, x, w, mean, inv = _ln_bwd_inputs(cuda, n1, n2, dtype, n1)
    odd = [_off16(t) for t in (dy, x, w)]
    assert lnm._bwd_plan(n1, n2, x.element_size(),
                         lnm._aligned(dy, x, w)).path == "vector"
    assert lnm._bwd_plan(n1, n2, x.element_size(),
                         lnm._aligned(*odd)).path == "element"
    got = ops.layer_norm_bwd(odd[0], odd[1], odd[2], mean, inv)
    want = lnm._bwd_plain(dy, x, w, mean, inv)
    torch.cuda.synchronize()
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=tol[dtype], atol=tol[dtype])
    d = dy.float()
    xhat = (x.float() - mean[:, None]) * inv[:, None]
    for g, terms in ((got[1], d * xhat), (got[2], d)):
        err = (g.double() - terms.double().sum(0)).abs()
        assert bool((err <= 1e-5 * terms.double().abs().sum(0) + 1e-30)
                    .all())
    again = ops.layer_norm_bwd(odd[0], odd[1], odd[2], mean, inv)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4096, 768), (1024, 1024), (4097, 768),
                                   (9, 1500)])
def test_layer_norm_bwd_graph_replays_give_the_same_bits(cuda, n1, n2):
    """The backward captured in a CUDA graph and replayed three times gives
    the eager call's bits each time: no state carried from one launch to
    the next, no scratch that a replay would find used."""
    dy, x, w, mean, inv = _ln_bwd_inputs(cuda, n1, n2, torch.bfloat16, n2)
    want = ops.layer_norm_bwd(dy, x, w, mean, inv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.layer_norm_bwd(dy, x, w, mean, inv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = ops.layer_norm_bwd(dy, x, w, mean, inv)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(outs, want))


# -- the LayerNorm forward: 16-byte rows, a block a wide row ------------------

# odd widths (the element path; 1500 a block a row) and the wide rows a
# block holds (4096, 8192), forward and backward within chip_smoke's fp64
# bounds, each the same bits on a second launch and on graph replays
@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(7, 1), (33, 100), (9, 1500),
                                   (2048, 4096), (3, 8192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_fwd_odd_and_wide_rows_within_the_fp64_bounds(cuda, n1, n2,
                                                                 dtype):
    import chip_smoke
    _, errs, ratios = chip_smoke._ln_check(n1, n2, dtype, 80 + n1)
    assert max(ratios.values()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4096, 768), (300, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_fwd_misaligned_view_gives_the_aligned_bits(cuda, n1, n2,
                                                               dtype):
    """x, w and b as contiguous views off 16 bytes take the forward's
    element path, the same values aligned its vector path; y, mean and inv
    the same bits, within one unit of the type's last place of the plain
    version."""
    rs = np.random.RandomState(n1)
    x = (_t(rs.randn(n1, n2).astype(np.float32)) * 3 + 1).to(dtype).to(cuda)
    w = _t(rs.randn(n2).astype(np.float32)).to(cuda)
    b = _t(rs.randn(n2).astype(np.float32)).to(cuda)
    odd = [_off16(t) for t in (x, w, b)]
    isz = x.element_size()
    assert lnm._fwd_plan(n1, n2, isz, lnm._aligned(x, w, b)).path == "vector"
    assert lnm._fwd_plan(n1, n2, isz, lnm._aligned(*odd)).path == "element"
    want = ops.layer_norm_fwd(x, w, b, 1e-5)
    got = ops.layer_norm_fwd(*odd, 1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
    for g, p in zip(got, lnm._fwd_plain(x, w, b, 1e-5)):
        torch.testing.assert_close(g.float(), p.float(), rtol=tol[dtype],
                                   atol=tol[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4096, 768), (1024, 1024), (4097, 768),
                                   (9, 1500), (2048, 4096), (3, 9000)])
def test_layer_norm_fwd_is_bitwise_across_launches_and_replays(cuda, n1, n2):
    """y, mean and inv the same bits on a second launch and on three
    replays of a CUDA graph that captured the forward (every path: a warp
    a row, a block a row, streamed above 8192)."""
    rs = np.random.RandomState(n2)
    x = (_t(rs.randn(n1, n2).astype(np.float32)) * 3 + 1).bfloat16().to(cuda)
    w = _t(rs.randn(n2).astype(np.float32)).to(cuda)
    b = _t(rs.randn(n2).astype(np.float32)).to(cuda)
    want = ops.layer_norm_fwd(x, w, b, 1e-12)
    again = ops.layer_norm_fwd(x, w, b, 1e-12)
    assert all(torch.equal(a, c) for a, c in zip(again, want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.layer_norm_fwd(x, w, b, 1e-12)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = ops.layer_norm_fwd(x, w, b, 1e-12)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(outs, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_fwd_of_no_rows_launches_nothing(cuda, dtype):
    x = torch.empty(0, 768, dtype=dtype, device=cuda)
    before = lnm.layer_norm_fwd.launches
    y, mean, inv = ops.layer_norm_fwd(x, None, None, 1e-5)
    torch.cuda.synchronize()
    assert y.shape == (0, 768) and y.dtype == dtype
    assert mean.shape == inv.shape == (0,)
    assert lnm.layer_norm_fwd.launches == before


# -- flash attention ----------------------------------------------------------

def _flash_case(cuda, B, H, T, D, dtype, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (_t(rs.randn(B * H, T, D).astype(np.float32)).to(dtype)
                   .to(cuda) for _ in range(4))
    kvm = _t(rs.rand(B, T) > 0.3).to(cuda)
    kvm[0] = False                          # a batch row with no valid key
    seg = _t(np.sort(rs.randint(0, 3, (B, T)), axis=1).astype(np.int32))
    return q, k, v, do, kvm, seg.to(cuda)


# a unit in the last place (relative) and half the subnormal spacing of
# each type, as chip_smoke.py states its fp64 bound
_UNIT = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
         torch.float16: 2.0 ** -10}
_TINY = {torch.float32: 2.0 ** -150, torch.bfloat16: 2.0 ** -134,
         torch.float16: 2.0 ** -25}


def _dq_bound_ratio(dq, q, k, v, do, o, H, scale, causal, kvm, seg, seed,
                    rate):
    """max(|dq - dQ64| / bound): dQ64 from the same inputs in fp64 (delta
    from ``o``), the bound one rounding to dq's type plus (u + 256*2^-24)
    of the fp64 sum of the terms' magnitudes plus the rounding of dS
    values too small for the type's normal range (chip_smoke.py's
    _flash_check)."""
    valid = fa._valid(q, H, causal, kvm, seg)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s = torch.where(valid, q64 @ k64.transpose(1, 2) * scale, -np.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - torch.where(m.isfinite(), m, 0.0)),
                    0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    dp = do64 @ v64.transpose(1, 2)
    dpa = do64.abs() @ v64.abs().transpose(1, 2)
    if rate:
        keep, ik = fa._keep(q, seed, rate), fa._inv_keep(rate)
        dp = torch.where(keep, dp, 0.0) * ik
        dpa = torch.where(keep, dpa, 0.0) * ik
    delta = (do64 * o.double()).sum(dim=-1, keepdim=True)
    want = p * (dp - delta) @ k64 * scale
    mag = p * (dpa + delta.abs()) @ k64.abs() * scale
    floor = k64.abs().sum(dim=1, keepdim=True) * scale
    u = _UNIT[q.dtype]
    bound = (u * want.abs() + (u + 256 * 2.0 ** -24) * mag
             + _TINY[q.dtype] * floor)
    err = (dq.double() - want).abs()
    r = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                    torch.where(err > 0, np.inf, 0.0))
    return float(r.max())


# bf16 and fp16 take the tensor-core kernels, fp32 the FMA kernels; D = 20
# takes the tensor-core kernels' element-wise tile loads (their 16-byte
# copies need D % 8 == 0)
@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["none", "causal", "kv_mask", "segments",
                                     "dropout", "all"])
@pytest.mark.parametrize("T,D", [(128, 64), (200, 64), (77, 128), (64, 24),
                                 (512, 64), (50, 20)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_kernels_match_plain(cuda, variant, T, D, dtype):
    B, H = 2, 3
    q, k, v, do, kvm, seg = _flash_case(cuda, B, H, T, D, dtype)
    seed = torch.tensor([12345, -678], dtype=torch.int32, device=cuda)
    allv = variant == "all"
    kw = dict(causal=variant == "causal" or allv,
              kv_mask=kvm if variant == "kv_mask" or allv else None,
              segment_ids=seg if variant == "segments" or allv else None,
              seed=seed, rate=0.1 if variant == "dropout" or allv else 0.0)
    args = (H, D ** -0.5)
    o, lse = ops.flash_fwd(q, k, v, *args, **kw)
    po, plse = fa._fwd_plain(q, k, v, *args, kw["causal"], kw["kv_mask"],
                             kw["segment_ids"], seed, kw["rate"])
    # fp32: sums in another order; bf16/fp16: P rounds to the type on
    # either side, and a p one fp32 ulp apart can round to neighbouring
    # values of the type
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1)
    pargs = (kw["causal"], kw["kv_mask"], kw["segment_ids"], seed,
             kw["rate"])
    dq = ops.flash_dq(q, k, v, do, plse, delta, *args, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, plse, delta, *args, **kw)
    pdq = fa._dq_plain(q, k, v, do, plse, delta, *args, *pargs)
    pdk, pdv = fa._dkv_plain(q, k, v, do, plse, delta, *args, *pargs)
    torch.cuda.synchronize()
    for g, p in ((dq, pdq), (dk, pdk), (dv, pdv)):
        scale = max(float(p.float().abs().max()), 1.0)
        torch.testing.assert_close(g.float(), p.float(), rtol=tol,
                                   atol=tol * scale)
    # dQ, kernel and plain version, within chip_smoke.py's fp64 bound
    for who, g in (("kernel", dq), ("plain", pdq)):
        r = _dq_bound_ratio(g, q, k, v, do, po, *args, *pargs)
        assert r <= 1.0, f"dq {who}: {r} of the fp64 bound"
    if kw["kv_mask"] is not None:
        assert float(o[:H].float().abs().max()) == 0.0   # no valid key
    # each block writes only its own rows (no atomics): a second launch of
    # each kernel gives the same bits
    o2, lse2 = ops.flash_fwd(q, k, v, *args, **kw)
    dq2 = ops.flash_dq(q, k, v, do, plse, delta, *args, **kw)
    dk2, dv2 = ops.flash_dkv(q, k, v, do, plse, delta, *args, **kw)
    for x, y in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_dropout_mask_is_the_hash(cuda, dtype, T, causal):
    """q = k = 0 and V = identity (T = D): O's zero pattern is the mask
    (under the causal mask, its lower triangle), each kept value the plain
    version's bits (round_T of 1/(1 - rate) over the row's count of valid
    keys), and lse the log of that count.  A wrong fragment-to-position
    map in the tensor-core kernels moves the pattern."""
    BH = 6
    z = torch.zeros(BH, T, T, device=cuda, dtype=dtype)
    eye = torch.eye(T, device=cuda).expand(BH, T, T).contiguous().to(dtype)
    seed = torch.tensor([7, 99], dtype=torch.int32, device=cuda)
    o, lse = ops.flash_fwd(z, z, eye, 2, 1.0, causal, seed=seed, rate=0.25)
    keep = fa._keep(z, seed, 0.25)
    count = torch.full((T,), float(T), device=cuda)
    if causal:
        keep = keep & torch.ones(T, T, dtype=torch.bool, device=cuda).tril()
        count = torch.arange(1, T + 1, device=cuda).float()
    assert torch.equal(o != 0, keep)
    po, _ = fa._fwd_plain(z, z, eye, 2, 1.0, causal, None, None, seed, 0.25)
    assert torch.equal(o, po)
    torch.testing.assert_close(lse, torch.log(count).expand(BH, T),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_above_128_takes_the_dense_route(cuda, dtype):
    """Head dim 160 is past the flash kernels' limit: on the card the
    dispatch takes the dense route (no kernel raises), forward and
    backward, and agrees with the same call on the CPU."""
    from apex_tpu_torch import transformer
    rs = np.random.RandomState(160)
    x = [_t(rs.randn(2, 3, 64, 160).astype(np.float32)).to(dtype)
         for _ in range(3)]
    seen = []
    transformer.set_path_hook(seen.append)
    try:
        xs = [t.to(cuda).requires_grad_() for t in x]
        got = transformer.dot_product_attention(*xs, causal=True)
        got.float().sum().backward()
        want = transformer.dot_product_attention(*x, causal=True)
    finally:
        transformer.set_path_hook(None)
    assert seen == ["dense", "dense"]
    assert all(t.grad is not None and bool(t.grad.isfinite().all())
               for t in xs)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.detach().cpu().float(), want.float(),
                               rtol=tol, atol=tol)


# -- LAMB and the per-tensor l2norm -------------------------------------------

def _ragged_table(cuda, sizes):
    """The chunk table of tensors of ``sizes`` laid out densely (chunks
    starting off the 16-byte grid after an odd size)."""
    return ChunkedFlatLayout([torch.zeros(n) for n in sizes]).chunk_table(
        cuda)


RAGGED = [(1, 1023, 1025, 3 * 1024), (5, 0, 4099, 2, 70001), (1_000_003,)]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", RAGGED)
def test_l2norm_per_tensor_matches_plain(cuda, sizes):
    table = _ragged_table(cuda, sizes)
    x = _t(np.random.RandomState(11).randn(sum(sizes)).astype(np.float32)
           ).to(cuda)
    got = ops.multi_tensor_l2norm_per_tensor(x, table)
    want = mt._l2norm_per_tensor_plain(x, table)
    # the sums run in another order within a chunk
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(ops.multi_tensor_l2norm_per_tensor(x, table), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099, 1_000_003])
@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.01), (False, 0.01),
                                            (True, 0.0)])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_lamb_stage1_matches_plain(cuda, n, adam_w_mode, wd, noop):
    rs = np.random.RandomState(12)
    g, p, m = (_t(rs.randn(n).astype(np.float32)).to(cuda) for _ in range(3))
    v = _t(np.abs(rs.randn(n)).astype(np.float32) * 0.01).to(cuda)
    flag = torch.full((), noop, device=cuda)
    scal = [torch.full((), s, device=cuda) for s in (0.5, 10.0, 1000.0)]
    hp = (0.9, 0.999, 0.1, 1e-6, wd, adam_w_mode)
    mk, vk, uk = m.clone(), v.clone(), torch.zeros_like(m)
    mp, vp, up = m.clone(), v.clone(), torch.zeros_like(m)
    ops.lamb_stage1(g, p, mk, vk, *scal, *hp, noop=flag, out=uk)
    lamb_mod._stage1_plain(g, p, mp, vp, up, *scal, *hp, flag)
    for a, b in ((mk, mp), (vk, vp), (uk, up)):
        assert torch.equal(a, b)
    if noop:
        assert torch.equal(mk, m) and torch.equal(vk, v)
        assert not uk.any()


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", RAGGED)
@pytest.mark.parametrize("half", [None, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_lamb_stage2_matches_plain(cuda, sizes, half, noop):
    table = _ragged_table(cuda, sizes)
    n = sum(sizes)
    rs = np.random.RandomState(13)
    p, u = (_t(rs.randn(n).astype(np.float32)).to(cuda) for _ in range(2))
    ratio = _t(np.abs(rs.randn(len(sizes))).astype(np.float32) + 0.5
               ).to(cuda)
    lr = torch.full((), 0.01, device=cuda)
    flag = torch.full((), noop, device=cuda)
    pk, pp = p.clone(), p.clone()
    hk, hp = ((None, None) if half is None else
              (torch.zeros(n, dtype=half, device=cuda),
               torch.zeros(n, dtype=half, device=cuda)))
    ops.lamb_stage2(pk, u, ratio, table, lr, half=hk, noop=flag)
    lamb_mod._stage2_plain(pp, u, ratio, table, lr, hp, flag)
    assert torch.equal(pk, pp)
    if half is not None:
        assert torch.equal(hk, hp)
    if noop:
        assert torch.equal(pk, p)


# -- amp O1 and checkpoints on the card ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
def test_layer_norm_fp32_at_bert_base_within_the_fp64_bounds(cuda,
                                                             misaligned):
    """The O1 BERT path's LayerNorm: fp32 at (4096, 768), kernels and
    plain versions each within ``chip_smoke``'s fp64 bounds, the backward
    the same bits on a second launch and on graph replays."""
    import chip_smoke
    _, errs, ratios = chip_smoke._ln_check(4096, 768, torch.float32, 71,
                                           misaligned=misaligned)
    assert max(ratios.values()) <= 1.0 and max(errs) < 1e-3


_TINY_BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=64, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0, head_chunk=48)


@pytest.mark.cuda
def test_o1_bert_two_steps_on_the_card_match_the_cpu(cuda):
    """A tiny BERT under O1 + FusedAdam, two steps on the card (cuBLAS
    bf16 products, the LayerNorm kernels in fp32, the flash kernels in
    bf16) and on the CPU (plain versions) from the same weights and batch:
    the loss falls on both; losses within 1e-3 relative (bf16 products
    round apart, as against the JAX package); the update (params less the
    start) within 0.1 of the CPU's in norm, as the CPU port against the
    JAX package (measured there: 0.044)."""
    from apex_tpu_torch import amp, models, optimizers
    rs = np.random.RandomState(5)
    ids = _t(rs.randint(5, 128, (4, 32)))
    labels = torch.where(_t(rs.rand(4, 32) < 0.15), ids, -100)
    nsp = _t(rs.randint(0, 2, (4,)))
    runs = []
    try:
        for dev in (cuda, torch.device("cpu")):
            model = models.BertForPretraining(
                models.BertConfig(**_TINY_BERT), device=dev,
                generator=torch.Generator().manual_seed(0))
            model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                        opt_level="O1", verbosity=0)
            start = opt.masters.buf.detach().cpu().double()
            losses = []
            for _ in range(2):
                loss = model.loss(ids.to(dev), labels.to(dev), nsp.to(dev))
                with amp.scale_loss(loss, opt) as scaled:
                    scaled.backward()
                opt.step()
                opt.zero_grad()
                losses.append(float(loss.detach()))
            runs.append((losses, opt.masters.buf.cpu().double() - start))
    finally:
        amp.set_policy(amp.NoPolicy())
    (lc, dc), (lp, dp) = runs
    assert lc[-1] < lc[0] and lp[-1] < lp[0], (lc, lp)
    np.testing.assert_allclose(lc, lp, rtol=1e-3)
    gap = float((dc - dp).norm() / dp.norm())
    assert gap <= 0.1, gap


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card_is_bitwise(cuda):
    """O1 fp16 with the dynamic scale on a small ResNet on the card:
    model, optimizer and amp state dicts through torch.save into a fresh
    pair restore every tensor bitwise; one more step on each gives the
    same overflow flag and scaler, losses within 1e-6."""
    import io
    from apex_tpu_torch import amp, models, optimizers
    from apex_tpu_torch.nn.functional import cross_entropy

    def pair(seed):
        model = models.ResNet(models.Bottleneck, [1, 1, 1, 1],
                              num_classes=10, device=cuda,
                              generator=torch.Generator().manual_seed(seed))
        return amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                              opt_level="O1", half_dtype="float16",
                              verbosity=0)

    def step(model, opt, x, y):
        loss = cross_entropy(model(x), y)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        opt.step()
        opt.zero_grad()
        return float(loss.detach())

    def state(model, opt):
        out = {k: v.clone() for k, v in model.state_dict().items()}
        out.update(masters=opt.masters.buf.clone(), m=opt.state.m.clone(),
                   v=opt.state.v.clone(), step=opt.state.step.clone())
        for k, t in amp.state_dict(opt)["scalers"][0].items():
            out["scaler." + k] = t.clone()
        return out

    rs = np.random.RandomState(9)
    x = _t(rs.randn(8, 3, 32, 32).astype(np.float32)).to(cuda)
    y = _t(rs.randint(0, 10, 8)).to(cuda)
    try:
        model, opt = pair(0)
        for _ in range(5):
            step(model, opt, x, y)
        buf = io.BytesIO()
        torch.save({"model": model.state_dict(),
                    "optimizer": opt.state_dict(),
                    "amp": amp.state_dict(opt)}, buf)
        buf.seek(0)
        ck = torch.load(buf, map_location=cuda, weights_only=True)
        fresh, fopt = pair(1)
        fresh.load_state_dict(ck["model"])
        fopt.load_state_dict(ck["optimizer"])
        amp.load_state_dict(fopt, ck["amp"])
        want, got = state(model, opt), state(fresh, fopt)
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
        la, lb = step(model, opt, x, y), step(fresh, fopt, x, y)
        assert abs(la - lb) <= 1e-6 * abs(la)
        assert float(opt.last_info["found_inf"]) == float(
            fopt.last_info["found_inf"])
        assert amp.amp_stats(opt) == amp.amp_stats(fopt)
    finally:
        amp.set_policy(amp.NoPolicy())


# -- layouts, the ResNet family, the imagenet example -------------------------

@pytest.fixture
def fp32_exact():
    """TF32 off for cuDNN and cuBLAS while a test compares fp32 results."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding", [1, (1, 2), ((2, 1), (2, 1))])
def test_conv_and_pools_on_the_card_match_the_cpu(cuda, fp32_exact,
                                                 data_format, padding):
    """cuDNN against oneDNN in fp32 (sums in other orders: 1e-5), forward
    and grads; an NHWC call keeps NHWC memory on the card too."""
    from apex_tpu_torch.nn import functional as F
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 11, 12).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = (rs.randn(16, 8, 3, 3) * 0.1).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda):
        xt = _t(x).to(dev).requires_grad_()
        wt = _t(w).to(dev).requires_grad_()
        y = F.conv2d(xt, wt, None, 1, padding, data_format=data_format)
        z = F.max_pool2d(y, 3, 2, 1, data_format)
        z = F.adaptive_avg_pool2d(z, 1, data_format)
        z.sum().backward()
        assert y.is_contiguous()
        outs[str(dev)] = [t.detach().cpu() for t in (y, xt.grad, wt.grad)]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last,stem,syncbn",
                         [(False, "conv7", True),
                          (True, "space_to_depth", False)])
def test_resnet_layouts_on_the_card(cuda, channels_last, stem, syncbn):
    """One O2 step of resnet18 on the card: finite; the NCHW model runs
    the syncbn kernels at its 20 BatchNorms, the NHWC one none."""
    from apex_tpu_torch import amp, models, optimizers
    model, opt = amp.initialize(
        models.resnet18(channels_last=channels_last, stem=stem,
                        device=cuda),
        optimizers.FusedAdam(lr=1e-3), opt_level="O2", verbosity=0)
    x = torch.randn(8, 3, 64, 64, device=cuda)
    y = torch.randint(0, 1000, (8,), device=cuda)
    ops.reset_launch_counts()
    loss = nn.functional.cross_entropy(model(x), y)
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert torch.isfinite(loss)
    assert counts["syncbn_fwd"] == counts["syncbn_bwd"] == \
        (20 if syncbn else 0)
    assert counts["fused_adam"] == counts["multi_tensor_scale"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [[], ["--channels-last", "--stem",
                                       "space_to_depth", "--fused-adam"]])
def test_imagenet_example_on_the_card(cuda, argv, capsys):
    """examples/imagenet/main_amp_torch.py with its default device."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "imagenet"))
    import main_amp_torch
    ips = main_amp_torch.main(["--arch", "resnet18", "-b", "8",
                               "--image-size", "64", "--iters", "3",
                               "--print-freq", "1"] + argv)
    out = capsys.readouterr().out
    assert ips > 0 and "=> 1 rank(s) on cuda" in out, out


# -- the functional step captured in a CUDA graph -----------------------------

@pytest.fixture
def deterministic():
    """cuDNN restricted to its deterministic algorithms while a test holds
    two runs bitwise."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


def _small_resnet(cuda, seed=0, **kw):
    from apex_tpu_torch import amp, models, optimizers
    model = models.ResNet(models.Bottleneck, [1, 1, 1, 1], num_classes=10,
                          device=cuda,
                          generator=torch.Generator().manual_seed(seed))
    return amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                          opt_level="O2", verbosity=0, **kw)


def _functional(model, opt):
    """The functional step; returns the loss and the loss scale it used."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.nn.functional import cross_entropy

    def step(batch):
        x, y = batch
        used = opt.scalers[0].loss_scale.clone()
        loss, grads = amp.scaled_grad(lambda: cross_entropy(model(x), y),
                                      opt)
        info = opt.step(grads)
        return {"loss": loss, "scale": used,
                "found": info["found_inf"].clone()}
    return step


def _images(cuda, seed=9, n=8):
    rs = np.random.RandomState(seed)
    return (_t(rs.randn(n, 3, 32, 32).astype(np.float32)).to(cuda),
            _t(rs.randint(0, 10, n)).to(cuda))


@pytest.mark.cuda
def test_captured_step_equals_eager_bitwise(cuda, deterministic):
    """make_step's calls (eager warm-up, capture, replays) against the
    same functional step run eagerly on a twin model: losses, masters,
    half copy, moments, step counter, scaler and BatchNorm statistics
    bitwise after 6 steps."""
    from apex_tpu_torch import parallel
    (ma, oa), (mb, ob) = _small_resnet(cuda), _small_resnet(cuda)
    batch = _images(cuda)
    eager = [_functional(ma, oa)(batch)["loss"] for _ in range(6)]
    train = parallel.make_step(_functional(mb, ob), mb)
    graph = [train(batch)["loss"] for _ in range(6)]
    assert train.replays == 5
    assert torch.equal(torch.stack(eager), torch.stack(graph))
    for a, b in ((oa.masters.buf, ob.masters.buf),
                 (oa.masters.half, ob.masters.half),
                 (oa.state.m, ob.state.m), (oa.state.v, ob.state.v),
                 (oa.state.step, ob.state.step)):
        assert torch.equal(a, b)
    assert amp_stats_equal(oa, ob)
    for (k, a), (_, b) in zip(ma.named_buffers(), mb.named_buffers()):
        assert torch.equal(a, b), k


def amp_stats_equal(a, b) -> bool:
    from apex_tpu_torch import amp
    return amp.amp_stats(a) == amp.amp_stats(b)


@pytest.mark.cuda
def test_captured_scale_grows_and_halves_across_replays(cuda):
    """fp16's dynamic scale with a window of 2: each replay scales by the
    scale the one before it left (doubling after two clean steps), and a
    replay with an inf in its input halves it."""
    from apex_tpu_torch import parallel
    model, opt = _small_resnet(cuda, half_dtype="float16")
    opt.scaler.scale_window = 2
    opt.load_scalers_state_dict([{"loss_scale": 2.0 ** 8, "unskipped": 0,
                                  "steps_skipped": 0}])
    x, y = _images(cuda)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("inf")
    train = parallel.make_step(_functional(model, opt), model)
    used, found = [], []
    for xb in (x, x, x, x, bad, x, x):
        out = train((xb, y))
        used.append(float(out["scale"]))
        found.append(float(out["found"]))
    assert found == [0, 0, 0, 0, 1, 0, 0]
    assert used == [2.0 ** 8, 2.0 ** 8, 2.0 ** 9, 2.0 ** 9, 2.0 ** 10,
                    2.0 ** 9, 2.0 ** 9]
    assert float(opt.loss_scale()) == 2.0 ** 10
    assert int(opt.state.step) == 6 and train.replays == 6


@pytest.mark.cuda
def test_captured_overflow_replay_skips(cuda):
    """An inf in a replay's input: found_inf set, the loss scale halved,
    masters, half copy, moments and step counter bitwise unchanged."""
    from apex_tpu_torch import parallel
    model, opt = _small_resnet(cuda, half_dtype="float16")
    opt.load_scalers_state_dict([{"loss_scale": 2.0 ** 8, "unskipped": 0,
                                  "steps_skipped": 0}])
    x, y = _images(cuda)
    train = parallel.make_step(_functional(model, opt), model)
    for _ in range(3):
        train((x, y))
    before = [t.clone() for t in (opt.masters.buf, opt.masters.half,
                                  opt.state.m, opt.state.v, opt.state.step)]
    scale = float(opt.loss_scale())
    bad = x.clone()
    bad[1, 2, 3, 4] = float("inf")
    out = train((bad, y))
    assert train.replays == 3 and float(out["found"]) == 1.0
    assert float(opt.loss_scale()) == scale / 2
    for a, b in zip(before, (opt.masters.buf, opt.masters.half,
                             opt.state.m, opt.state.v, opt.state.step)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_captured_replays_draw_new_dropout_seeds(cuda):
    """A step that draws the flash kernels' seed words from a CUDA
    generator of its own (BERT's dropout generator), captured: each replay
    draws new words, the words an eager run draws from the same generator
    state, and the generator's offset advances as it does eagerly."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.transformer.attention import _draw_seed
    model, opt = _small_resnet(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    model.dropout_generator = gen          # found by make_step
    batch = _images(cuda)
    fn = _functional(model, opt)

    def step(b):
        out = fn(b)
        out["seed"] = _draw_seed(gen, cuda)
        return out

    start = gen.get_state()
    eager = [_draw_seed(gen, cuda) for _ in range(4)]
    offset = gen.get_offset()
    gen.set_state(start)
    train = parallel.make_step(step, model)
    seeds = [train(batch)["seed"] for _ in range(4)]
    assert gen.get_offset() == offset
    for a, b in zip(eager, seeds):
        assert torch.equal(a, b)
    assert len({tuple(s.tolist()) for s in seeds}) == 4


@pytest.mark.cuda
def test_captured_launch_counts_are_exact(cuda):
    """launch_counts() over a captured step: the warm-up counts its
    launches, the capture none, each replay those of one step (the 17
    BatchNorms' syncbn kernels, scale, l2norm, Adam)."""
    from apex_tpu_torch import parallel
    model, opt = _small_resnet(cuda)
    train = parallel.make_step(_functional(model, opt), model,
                               steps_per_call=2)
    x, y = _images(cuda)
    batch = (torch.stack([x, x]), torch.stack([y, y]))
    ops.reset_launch_counts()
    for _ in range(4):
        train(batch)
    torch.cuda.synchronize()
    steps = 4 * 2
    want = {"multi_tensor_scale": steps, "multi_tensor_l2norm": steps,
            "fused_adam": steps, "syncbn_fwd": 17 * steps,
            "syncbn_bwd": 17 * steps}
    got = ops.launch_counts()
    assert {k: v for k, v in got.items() if v} == want
    assert train.launches == {k: v // 4 for k, v in want.items()}


@pytest.mark.cuda
def test_captured_step_returns_copies(cuda):
    """make_step's calls return copies: what call 1 (the eager warm-up)
    and call 2 (capture and replay) returned is unchanged by the calls
    after them, though the step returns the optimizer's info as it is
    (each call a fresh batch, so that the grad norms differ)."""
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch.nn.functional import cross_entropy
    model, opt = _small_resnet(cuda)

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: cross_entropy(model(x), y),
                                      opt)
        return dict(opt.step(grads), loss=loss)

    train = parallel.make_step(step, model)
    outs, firsts = [], []
    for seed in (9, 10, 11):
        outs.append(train(_images(cuda, seed=seed)))
        firsts.append({k: t.clone() for k, t in outs[-1].items()})
    assert train.replays == 2
    for out, first in zip(outs, firsts):
        for k in out:
            assert torch.equal(out[k], first[k]), k
        for k in opt.last_info:
            assert out[k].data_ptr() != opt.last_info[k].data_ptr(), k
    assert len({float(o["grad_norm"]) for o in outs}) == 3
    assert torch.equal(outs[-1]["grad_norm"], opt.last_info["grad_norm"])


# -- the decoder families -----------------------------------------------------

def _tiny_gpt(cuda, remat=None, dropout=0.1, seed=0):
    """A tiny GPT with GQA under O2 + FusedAdam, its dropout generator on
    the card."""
    from apex_tpu_torch import amp, models, optimizers
    gen = torch.Generator(device=cuda).manual_seed(3)
    cfg = models.GPTConfig(vocab_size=97, block_size=64, n_layer=2, n_head=4,
                           n_embd=64, dropout=dropout, n_kv_head=2,
                           remat=remat)
    model = models.GPT(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(seed),
                       dropout_generator=gen)
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    model.train()
    return model, opt, gen


def _decoder_step(model, opt):
    from apex_tpu_torch import amp

    def step(ids):
        loss, grads = amp.scaled_grad(lambda: model.loss(ids), opt)
        opt.step(grads)
        return loss
    return step


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [None, "nothing", "dots"])
def test_tiny_gpt_captured_equals_eager_bitwise(cuda, remat):
    """make_step over a tiny GPT (dropout 0.1: hidden masks and the flash
    kernels' seed words from the model's CUDA generator; remat off, or
    each block recomputed with the forward's draws) against the same
    step run eagerly on a twin: losses, masters, half copy, moments, step
    counter and the generator's offset bitwise after 6 steps."""
    from apex_tpu_torch import parallel
    ids = _t(np.random.RandomState(4).randint(0, 97, (4, 64))).to(cuda)
    (ma, oa, ga), (mb, ob, gb) = (_tiny_gpt(cuda, remat) for _ in range(2))
    step_a = _decoder_step(ma, oa)
    eager = [step_a(ids) for _ in range(6)]
    train = parallel.make_step(_decoder_step(mb, ob), mb)
    graph = [train(ids) for _ in range(6)]
    assert train.replays == 5
    assert torch.equal(torch.stack(eager), torch.stack(graph))
    for a, b in ((oa.masters.buf, ob.masters.buf),
                 (oa.masters.half, ob.masters.half),
                 (oa.state.m, ob.state.m), (oa.state.v, ob.state.v),
                 (oa.state.step, ob.state.step)):
        assert torch.equal(a, b)
    assert ga.get_offset() == gb.get_offset()
    assert float(eager[-1]) < float(eager[0])


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["nothing", "dots"])
def test_remat_with_dropout_matches_no_remat_on_the_card(cuda, remat):
    """A rematerialized GPT in train mode (dropout 0.3) on the card: the
    recompute replays the forward's masks and seed words, so the loss is
    the stored run's bit for bit, the grads its to fp32 rounding, and the
    generator advances no further than without remat."""
    from apex_tpu_torch import models
    ids = _t(np.random.RandomState(5).randint(0, 97, (4, 64))).to(cuda)
    out = {}
    for mode in (None, remat):
        gen = torch.Generator(device=cuda).manual_seed(11)
        cfg = models.GPTConfig(vocab_size=97, block_size=64, n_layer=2,
                               n_head=4, n_embd=64, dropout=0.3, remat=mode)
        m = models.GPT(cfg, device=cuda,
                       generator=torch.Generator().manual_seed(0),
                       dropout_generator=gen)
        loss = m.loss(ids)
        loss.backward()
        out[mode] = (loss.detach(), [p.grad for p in m.parameters()],
                     gen.get_offset())
    (l0, g0, o0), (l1, g1, o1) = out[None], out[remat]
    assert torch.equal(l0, l1) and o0 == o1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,rate", [(1024, 3, 0.1), (1024, 2, 0.0),
                                      (2048, 2, 0.0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_causal_flash_at_long_t_matches_plain(cuda, T, H, rate, dtype):
    """The causal tile skip and the dK/dV loop from the diagonal at the
    decoder lengths (GPT-2's T = 1024 with dropout 0.1, TinyLlama's 2048):
    each kernel against its plain version, dQ (kernel and plain) within
    the fp64 bound, and each kernel's second launch bitwise."""
    B, D = 1, 64
    q, k, v, do, _, _ = _flash_case(cuda, B, H, T, D, dtype, seed=T + H)
    seed = torch.tensor([321, -9], dtype=torch.int32, device=cuda)
    args = (H, D ** -0.5)
    kw = dict(causal=True, kv_mask=None, segment_ids=None, seed=seed,
              rate=rate)
    o, lse = ops.flash_fwd(q, k, v, *args, **kw)
    po, plse = fa._fwd_plain(q, k, v, *args, True, None, None, seed, rate)
    torch.testing.assert_close(o.float(), po.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1)
    pargs = (True, None, None, seed, rate)
    dq = ops.flash_dq(q, k, v, do, plse, delta, *args, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, plse, delta, *args, **kw)
    pdq = fa._dq_plain(q, k, v, do, plse, delta, *args, *pargs)
    pdk, pdv = fa._dkv_plain(q, k, v, do, plse, delta, *args, *pargs)
    for g, p in ((dq, pdq), (dk, pdk), (dv, pdv)):
        scale = max(float(p.float().abs().max()), 1.0)
        torch.testing.assert_close(g.float(), p.float(), rtol=2e-2,
                                   atol=2e-2 * scale)
    for who, g in (("kernel", dq), ("plain", pdq)):
        r = _dq_bound_ratio(g, q, k, v, do, po, *args, *pargs)
        assert r <= 1.0, f"dq {who}: {r} of the fp64 bound"
    o2, lse2 = ops.flash_fwd(q, k, v, *args, **kw)
    dq2 = ops.flash_dq(q, k, v, do, plse, delta, *args, **kw)
    dk2, dv2 = ops.flash_dkv(q, k, v, do, plse, delta, *args, **kw)
    for x, y in ((o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(x, y)


def _greedy_uncached(model, ids, lens, n):
    """Greedy decoding by a full forward a token (GPT.generate's loop)."""
    B, S = ids.shape
    ids, cur = ids.clone(), lens.clone()
    ar = torch.arange(S, device=ids.device)
    rows = torch.arange(B, device=ids.device)
    with torch.no_grad():
        for _ in range(n):
            amask = (ar[None, :] < cur[:, None]).to(torch.int32)
            nxt = model(ids, amask)[rows, cur - 1].argmax(-1)
            ids[rows, cur] = nxt
            cur = cur + 1
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gpt", "llama_gqa", "mistral"])
def test_generate_cached_equals_generate_on_the_card(cuda, family):
    """fp32 (TF32 off) tiny decoders on the card: greedy generate_cached,
    chunked and step prefill, equals the uncached loop (GPT.generate, or
    a full forward a token) token for token, prompts of four lengths; the
    bf16 and int8 caches run and keep the prompts."""
    from apex_tpu_torch import models
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(1)
        if family == "gpt":
            model = models.GPT(models.GPTConfig(
                vocab_size=97, block_size=64, n_layer=2, n_head=4,
                n_embd=64, dropout=0.0, n_kv_head=2), device=cuda,
                generator=gen)
        else:
            model = models.Llama(models.LlamaConfig(
                vocab_size=97, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                sliding_window=8 if family == "mistral" else None),
                device=cuda, generator=gen)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.5 * torch.randn(p.shape, generator=gen).to(cuda)
                       * p.abs().mean().clamp_min(0.02))
        lens = torch.tensor([5, 9, 13, 20], device=cuda)
        buf = torch.zeros((4, 48), dtype=torch.int64, device=cuda)
        rs = np.random.RandomState(2)
        for r, n in enumerate(lens.tolist()):
            buf[r, :n] = _t(rs.randint(0, 97, n))
        want = (model.generate(buf, lens, 20)[0] if family == "gpt"
                else _greedy_uncached(model, buf, lens, 20))
        for mode in ("chunked", "step"):
            got, final = model.generate_cached(buf, lens, 20,
                                               prefill_mode=mode)
            assert torch.equal(got, want), mode
            assert torch.equal(final, lens + 20)
        for dtype in (torch.bfloat16, torch.int8):
            got, _ = model.generate_cached(buf, lens, 20, cache_dtype=dtype)
            assert torch.equal(got[:, :5], buf[:, :5])
            assert bool(((got >= 0) & (got < 97)).all())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# -- the rest of the decoder families: T5, LoRA, int8 weights, beam search,
# speculative decoding ----------------------------------------------------

def _tiny_t5(cuda):
    from apex_tpu_torch import amp, models, optimizers
    cfg = models.T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128,
                          num_layers=2, num_heads=4,
                          relative_attention_num_buckets=8,
                          relative_attention_max_distance=20,
                          dropout_rate=0.0)
    model = models.T5(cfg, device=cuda,
                      generator=torch.Generator().manual_seed(0))
    return amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                          opt_level="O2", verbosity=0)


def _state_equal(oa, ob):
    for a, b in ((oa.masters.buf, ob.masters.buf),
                 (oa.masters.half, ob.masters.half),
                 (oa.state.m, ob.state.m), (oa.state.v, ob.state.v),
                 (oa.state.step, ob.state.step)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tiny_t5_captured_equals_eager_bitwise(cuda):
    """make_step over a tiny T5 (O2 + FusedAdam) against the same step run
    eagerly on a twin: losses, masters, half copy, moments and step
    counter bitwise after 6 steps; the loss falls."""
    from apex_tpu_torch import amp, parallel
    rs = np.random.RandomState(6)
    src = _t(rs.randint(2, 128, (4, 24))).to(cuda)
    tgt = _t(rs.randint(2, 128, (4, 8))).to(cuda)

    def step_of(model, opt):
        def step(batch):
            loss, grads = amp.scaled_grad(lambda: model.loss(*batch), opt)
            opt.step(grads)
            return loss
        return step

    (ma, oa), (mb, ob) = _tiny_t5(cuda), _tiny_t5(cuda)
    eager = [step_of(ma, oa)((src, tgt)) for _ in range(6)]
    train = parallel.make_step(step_of(mb, ob), mb)
    graph = [train((src, tgt)) for _ in range(6)]
    assert train.replays == 5
    assert torch.equal(torch.stack(eager), torch.stack(graph))
    _state_equal(oa, ob)
    assert float(eager[-1]) < float(eager[0])


class _LossOf(torch.nn.Module):
    """``model.loss`` as a module's forward, for ``functional_call``."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids):
        return self.model.loss(ids)


@pytest.mark.cuda
def test_tiny_lora_captured_equals_eager_bitwise(cuda):
    """Rank-4 adapters on q_proj and v_proj of a frozen bf16 Llama, O2 +
    FusedAdam on the adapters, the loss on merged weights through
    functional_call: make_step against the eager step on twin adapters,
    bitwise after 6 steps; the base stays bitwise as it was."""
    from apex_tpu_torch import amp, lora, models, optimizers, parallel
    base = models.Llama(models.LlamaConfig(
        vocab_size=97, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64), device=cuda,
        generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    base.requires_grad_(False)
    before = {k: v.clone() for k, v in base.state_dict().items()}
    frozen = {f"model.{n}": p.detach() for n, p in base.named_parameters()}
    wrapper = _LossOf(base)
    ids = _t(np.random.RandomState(7).randint(0, 97, (4, 64))).to(cuda)
    s = lora.scale(16, 4)

    def twin():
        ad = lora.init(base, ("q_proj", "v_proj"), rank=4,
                       generator=torch.Generator().manual_seed(1))
        ad, opt = amp.initialize(ad, optimizers.FusedAdam(lr=1e-2),
                                 opt_level="O2", verbosity=0)

        def step(batch):
            def loss_fn():
                merged = lora.merge(frozen, {f"model/{k}": v
                                             for k, v in ad.items()}, s)
                return torch.func.functional_call(wrapper, merged, (batch,))
            loss, grads = amp.scaled_grad(loss_fn, opt)
            opt.step(grads)
            return loss
        return ad, opt, step

    (ada, oa, sa), (adb, ob, sb) = twin(), twin()
    eager = [sa(ids) for _ in range(6)]
    train = parallel.make_step(sb, adb)
    graph = [train(ids) for _ in range(6)]
    assert train.replays == 5
    assert torch.equal(torch.stack(eager), torch.stack(graph))
    _state_equal(oa, ob)
    assert float(eager[-1]) < float(eager[0])
    for k, v in base.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_on_the_card_is_bitwise_the_cpu(cuda, dtype):
    """quantize's int8 data and fp32 scales on the card equal the CPU's
    for the same weights (ties to even, a zero row, both axes)."""
    from apex_tpu_torch.quantization import quantize
    rs = np.random.RandomState(8)
    w = rs.randn(768, 2304).astype(np.float32)
    w[0] = 0.0
    w[1, :4] = [0.5, -1.5, 2.5, 127.0]
    w = _t(w).to(dtype)
    for axis in (0, 1):
        qc, qg = quantize(w, axis), quantize(w.to(cuda), axis)
        assert torch.equal(qg.data.cpu(), qc.data)
        assert torch.equal(qg.scale.cpu(), qc.scale)


@pytest.mark.cuda
def test_int8_kv_quantization_on_the_card_is_bitwise_the_cpu(cuda):
    """The int8 KV cache's per-position values and scales on the card equal
    the CPU's for the same K/V."""
    from apex_tpu_torch.models import _cache
    rs = np.random.RandomState(10)
    kv = _t(rs.randn(4, 4, 64, 64).astype(np.float32))
    kv[0, 0, 0] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        qc, sc = _cache.quantize_kv(kv.to(dtype))
        qg, sg = _cache.quantize_kv(kv.to(dtype).to(cuda))
        assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_causal_key_padding_matches_plain(cuda, dtype):
    """Beam search's and the full verify's attention: causal with a
    key-padding mask of per-row lengths (4 beams x 4 prompts, GPT-2's 12
    heads), each kernel against its plain version, bitwise on a second
    launch."""
    B, H, T, D = 16, 12, 128, 64
    q, k, v, do, _, _ = _flash_case(cuda, B, H, T, D, dtype, seed=9)
    lens = torch.tensor([17, 40, 64, 128] * 4, device=cuda)
    kvm = torch.arange(T, device=cuda)[None, :] < lens[:, None]
    seed = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    args = (H, D ** -0.5)
    kw = dict(causal=True, kv_mask=kvm, segment_ids=None, seed=seed,
              rate=0.0)
    pargs = (True, kvm, None, seed, 0.0)
    o, lse = ops.flash_fwd(q, k, v, *args, **kw)
    po, plse = fa._fwd_plain(q, k, v, *args, *pargs)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    delta = (do.float() * po.float()).sum(-1)
    dq = ops.flash_dq(q, k, v, do, plse, delta, *args, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, plse, delta, *args, **kw)
    pdq = fa._dq_plain(q, k, v, do, plse, delta, *args, *pargs)
    pdk, pdv = fa._dkv_plain(q, k, v, do, plse, delta, *args, *pargs)
    for g, p in ((dq, pdq), (dk, pdk), (dv, pdv)):
        scale = max(float(p.float().abs().max()), 1.0)
        torch.testing.assert_close(g.float(), p.float(), rtol=tol,
                                   atol=tol * scale)
    o2, _ = ops.flash_fwd(q, k, v, *args, **kw)
    assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("verify", ["cached", "full"])
def test_speculative_greedy_equals_target_greedy_on_the_card(cuda, verify):
    """fp32 (TF32 off) on the card: speculative decoding with a smaller
    draft gives the target's greedy generate_cached tokens; beam search
    with one beam does too."""
    from apex_tpu_torch import models
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def gpt(n_layer, n_embd, seed):
            return models.GPT(models.GPTConfig(
                vocab_size=97, block_size=64, n_layer=n_layer, n_head=4,
                n_embd=n_embd, dropout=0.0), device=cuda,
                generator=torch.Generator().manual_seed(seed))
        target, draft = gpt(2, 64, 0), gpt(1, 32, 1)
        lens = torch.tensor([5, 9, 13, 20], device=cuda)
        buf = torch.zeros((4, 48), dtype=torch.int64, device=cuda)
        rs = np.random.RandomState(3)
        for r, n in enumerate(lens.tolist()):
            buf[r, :n] = _t(rs.randint(0, 97, n))
        want, final = target.generate_cached(buf, lens, 20)
        got, gfinal = models.generate_speculative(target, draft, buf, lens,
                                                  20, gamma=4,
                                                  verify=verify)
        assert torch.equal(got, want) and torch.equal(gfinal, final)
        beam, bfinal, _ = models.beam_search(target, buf, lens, 20,
                                             num_beams=1)
        assert torch.equal(beam, want) and torch.equal(bfinal, final)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _serve_all(eng, traffic):
    """Submit every (prompt, max_new, kwargs) of ``traffic``, step until
    idle; the results in order."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in traffic]
    steps = 0
    while eng.live() or eng.queue_depth():
        eng.step()
        steps += 1
        assert steps < 500
    return [eng.result(r) for r in rids]


def _serving_traffic(seed, n, vocab, plen=(3, 40), new=(2, 20)):
    rs = np.random.RandomState(seed)
    return [([int(t) for t in rs.randint(0, vocab, int(rs.randint(*plen)))],
             int(rs.randint(*new)), {}) for _ in range(n)]


def _tiny_decoder(cuda, family="gpt"):
    from apex_tpu_torch import models
    gen = torch.Generator().manual_seed(5)
    if family == "gpt":
        return models.GPT(models.GPTConfig(
            vocab_size=97, block_size=64, n_layer=2, n_head=4, n_embd=64,
            dropout=0.0, n_kv_head=2), device=cuda, generator=gen)
    return models.Llama(models.LlamaConfig(
        vocab_size=97, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=True), device=cuda,
        generator=gen)


def _eager(eng):
    for g in eng._graphs:
        g.eager = True
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["engine", "paged", "sampled", "prefix",
                                  "speculative", "seq2seq"])
def test_serving_captured_window_is_the_eager_window(cuda, kind):
    """On the card each engine's windows replay CUDA graphs: warmup()
    captures exactly the census's admission and decode graphs, a warm
    engine captures nothing more through queued admissions, mid-window
    EOS, cancel and preemption, and every request's tokens are bitwise
    those of the same engine run eagerly."""
    from apex_tpu_torch import models, serving
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _tiny_decoder(cuda, "llama" if kind == "paged" else "gpt")
    traffic = _serving_traffic(11, 12, 97)
    kw = dict(slots=4, buf_len=48, window=4)
    if kind == "engine":
        make = lambda: serving.Engine(model, **kw)               # noqa
    elif kind == "paged":
        make = lambda: serving.PagedEngine(model, block_size=8,  # noqa
                                           num_blocks=14, **kw)
    elif kind == "sampled":
        make = lambda: serving.Engine(model, temperature=0.9,   # noqa
                                      top_k=20, rng=7, **kw)
        traffic = [(p, n, {"seed": i}) for i, (p, n, _) in
                   enumerate(traffic)]
    elif kind == "prefix":
        make = lambda: serving.Engine(model, prefix_pool=1,     # noqa
                                      prefix_chunk=8, **kw)
        pref = list(range(1, 13))
        traffic = [(pref + p[:20], n, {}) if i % 2 else (p, n, {})
                   for i, (p, n, _) in enumerate(traffic)]
    elif kind == "speculative":
        draft = _tiny_decoder(cuda, "gpt")
        make = lambda: serving.Engine(model, draft=draft, gamma=3,  # noqa
                                      slots=4, buf_len=48)
    else:
        t5 = models.T5(models.T5Config(
            vocab_size=97, d_model=64, d_kv=16, d_ff=128, num_layers=2,
            num_heads=4, dropout_rate=0.0), device=cuda,
            generator=torch.Generator().manual_seed(6))
        make = lambda: serving.Seq2SeqEngine(t5, slots=4, src_len=40,  # noqa
                                             max_new_cap=20, window=4)
    eng = make()
    census = eng.compile_census()
    eng.warmup()
    assert eng.captures == {k: eng.captures[k] for k, stage in
                            census.items() if stage in ("admission",
                                                        "decode")}
    assert set(eng.captures) == {k for k, stage in census.items()
                                 if stage in ("admission", "decode")}
    if kind == "prefix":
        eng.register_prefix(pref)
    warm = dict(eng.captures)
    # an EOS that fires: the first request's first solo token
    solo = _serve_all(make(), traffic[:1])
    traffic[1] = (traffic[1][0], traffic[1][1],
                  dict(traffic[1][2], eos_token_id=solo[0][0]))
    got = _serve_all(eng, traffic)
    if kind != "prefix":
        assert eng.captures == warm
    ref = _eager(make())
    if kind == "prefix":
        ref.register_prefix(pref)
        assert eng.stats()["prefix_hits"] == 6
    assert _serve_all(ref, traffic) == got
    # cancel and preempt on the warm engine capture nothing
    before = dict(eng.captures)
    rids = [eng.submit(p[:8], 16, **k) for p, n, k in traffic[2:8]]
    eng.step()
    assert eng.cancel(rids[0]) and eng.preempt(rids[1])
    while eng.live() or eng.queue_depth():
        eng.step()
    assert eng.captures == before
    if kind == "paged":
        assert eng.stats()["blocks_free"] == eng.num_blocks


@pytest.mark.cuda
def test_serving_paged_equals_fixed_on_the_card(cuda):
    """fp32 on the card: the paged engine gives the fixed engine's tokens
    (greedy and explicitly seeded sampled), captured."""
    from apex_tpu_torch import serving
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _tiny_decoder(cuda, "llama")
    traffic = _serving_traffic(12, 10, 97)
    for kw in ({}, {"temperature": 0.9, "top_k": 20, "rng": 3}):
        tr = ([(p, n, {"seed": 9 + i}) for i, (p, n, _) in
               enumerate(traffic)] if kw else traffic)
        fixed = serving.Engine(model, slots=3, buf_len=48, window=4, **kw)
        paged = serving.PagedEngine(model, slots=3, buf_len=48, window=4,
                                    block_size=8, num_blocks=12, **kw)
        assert _serve_all(paged.warmup(), tr) == _serve_all(fixed.warmup(),
                                                            tr)


@pytest.mark.cuda
def test_fleet_failover_exact_on_the_card(cuda):
    """A fleet of two captured engines on the card, replica 1 raising from
    its third step: every result the single warmed engine's, the survivor
    capturing nothing after warmup()."""
    from apex_tpu_torch import serving
    from apex_tpu_torch.fleet import (FaultyReplica, Fleet, HealthConfig,
                                      RetryPolicy)
    model = _tiny_decoder(cuda)
    traffic = _serving_traffic(21, 12, 97)
    want = _serve_all(serving.Engine(model, slots=3, buf_len=64,
                                     window=4).warmup(), traffic)
    engines = [serving.Engine(model, slots=3, buf_len=64, window=4)
               for _ in range(2)]
    Fleet(engines).warmup()
    caps = dict(engines[0].captures)
    bad = FaultyReplica(engines[1])
    bad.arm(raise_on_step=(3, None))
    with Fleet([engines[0], bad], policy="round_robin", step_workers=2,
               health=HealthConfig(dead_consecutive=2, cooldown_steps=50),
               retry=RetryPolicy(max_attempts=6, jitter=0.0)) as fl:
        rids = [fl.submit(p, n, **kw) for p, n, kw in traffic]
        while fl.live():
            fl.step()
        s = fl.stats()
        assert s["failovers"] >= 1 and s["failed"] == 0 and s["dead"] == 1
        assert [fl.result(r) for r in rids] == want
    assert engines[0].captures == caps


@pytest.mark.cuda
def test_fleet_lazy_capture_under_the_step_pool(cuda):
    """A prefix registered after warmup() on one replica: its splice graphs
    capture during traffic while the fleet steps with step_workers=2 (a
    replica that may capture steps alone, never beside a pool worker);
    the tokens equal a step_workers=1 run's, and the launch counts of the
    two runs are equal."""
    from apex_tpu_torch import serving
    from apex_tpu_torch.fleet import Fleet
    model = _tiny_decoder(cuda)
    rs = np.random.RandomState(22)
    prefix = [int(t) for t in rs.randint(0, 97, 12)]
    traffic = [((prefix + p) if i % 2 == 0 else p, n, kw) for i, (p, n, kw)
               in enumerate(_serving_traffic(23, 12, 97, plen=(3, 20)))]
    pre = serving.Engine(model, slots=3, buf_len=64, window=4,
                         prefix_pool=2, prefix_chunk=8)
    other = serving.Engine(model, slots=3, buf_len=64, window=4)
    Fleet([pre, other]).warmup()
    results, counts = [], []
    for workers in (2, 1):
        with Fleet([pre, other], policy="prefix_affinity",
                   step_workers=workers) as fl:
            fl.register_prefix(prefix, replica=0)
            lazy = pre.uncaptured()
            assert bool(lazy) == (workers == 2)
            ops.reset_launch_counts()
            rids = [fl.submit(p, n, **kw) for p, n, kw in traffic]
            while fl.live():
                fl.step()
            torch.cuda.synchronize()
            counts.append(ops.launch_counts())
            assert fl.stats()["failed"] == 0
            results.append([fl.result(r) for r in rids])
        assert pre.uncaptured() == []
        assert set(lazy) <= set(pre.captures)
    assert pre.prefix_hits > 0
    assert results[0] == results[1]
    assert counts[0] == counts[1]


# -- the wider data-parallel stack at world 1 over NCCL -----------------------

@pytest.fixture(scope="module")
def nccl_group():
    """A one-rank NCCL group for the module's data-parallel tests (NCCL
    puts one rank on a device, and these tests need one card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    parallel.init_process_group(parallel.multiproc.local_init_method(),
                                world_size=1, rank=0)
    yield dist.get_backend()
    dist.destroy_process_group()


class _Mlp(torch.nn.Module):
    def __init__(self, device, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.layers = torch.nn.ModuleList(
            [nn.Linear(64, 64, device=device, generator=g) for _ in range(4)])

    def forward(self, x):
        for m in self.layers:
            x = torch.tanh(m(x))
        return x


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hierarchical", "compressed", "adasum",
                                  "adasum_hierarchical"])
def test_wide_reduce_at_world_one_captured_and_eager(cuda, nccl_group,
                                                     mode):
    """The hierarchical reduce (reduce-scatter, cross-node all-reduce,
    all-gather: each over a one-rank NCCL group) and Adasum at world 1,
    eager and captured in a CUDA graph: the flat reduce's grads bitwise
    (a sum of one), the compressed hop the grads rounded once to bf16."""
    from apex_tpu_torch import parallel
    kw = {"hierarchical": dict(comm_topology="hierarchical", ici_size=1),
          "compressed": dict(comm_topology="hierarchical", ici_size=1,
                             allreduce_compress_bf16=True),
          "adasum": dict(adasum=True),
          "adasum_hierarchical": dict(adasum=True,
                                      comm_topology="hierarchical",
                                      ici_size=1)}[mode]
    model = _Mlp(cuda)
    flat = parallel.DistributedDataParallel(model)
    ddp = parallel.DistributedDataParallel(model, **kw)
    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(1)) \
        .to(cuda)

    def step(xb):
        grads = torch.autograd.grad((model(xb) ** 2).mean(),
                                    list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        g = dict(zip(names, grads))
        return {"flat": flat.allreduce_grads(g), "wide": ddp.allreduce_grads(g)}

    eager = step(x)
    train = parallel.make_step(step, model)
    outs = [train(x) for _ in range(3)]
    assert cuda.type != "cuda" or train.replays == 2
    for out in outs:
        for k, v in eager["wide"].items():
            assert torch.equal(out["wide"][k], v), k
    for k, v in eager["flat"].items():
        want = v.to(torch.bfloat16).float() if mode == "compressed" else v
        assert torch.equal(eager["wide"][k], want), k


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(message_size=1000),
                                dict(comm_topology="hierarchical",
                                     ici_size=1)])
def test_overlapped_hook_path_captured(cuda, nccl_group, deterministic, kw):
    """The hook path with overlap=True (each chunk's all-reduce on the comm
    stream as its grads arrive, the callback only waits) captured in a
    CUDA graph: losses and state bitwise its eager run and the
    overlap=False twin's."""
    from apex_tpu_torch import amp, optimizers, parallel

    def pair(overlap):
        model = _Mlp(cuda)
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                    opt_level="O2", verbosity=0)
        ddp = parallel.DistributedDataParallel(model, overlap=overlap, **kw)

        def step(xb):
            loss = (ddp(xb) ** 2).mean()
            with amp.scale_loss(loss, opt) as scaled:
                scaled.backward()
            opt.step()
            return loss.detach().float()
        return model, opt, step

    x = torch.randn(32, 64, generator=torch.Generator().manual_seed(2)) \
        .to(cuda).to(torch.bfloat16)
    runs = {}
    for name, overlap, capture in (("plain", False, False),
                                   ("overlap", True, False),
                                   ("graph", True, True)):
        model, opt, step = pair(overlap)
        fn = parallel.make_step(step, model) if capture else step
        losses = torch.stack([fn(x) for _ in range(4)])
        if capture and cuda.type == "cuda":
            assert fn.replays == 3
        runs[name] = (losses, opt.masters.buf.clone(), opt.state.m.clone())
    for name in ("overlap", "graph"):
        for a, b in zip(runs[name], runs["plain"]):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 8])
def test_adam_on_padded_odd_shards(cuda, shards):
    """The Adam kernel on each ZeRO window of a padded flat buffer
    (1,000,003 elements: odd windows over 3, bases off 16 bytes): every
    window bitwise the plain version, the half copy written in place in
    the full half buffer, and nothing outside the window touched."""
    n = 1_000_003
    shard = -(-n // shards)
    rs = np.random.RandomState(shards)

    def padded(a):
        return torch.cat([_t(a), torch.zeros(shard * shards - n)]).to(cuda)

    bufs = [padded(rs.randn(n).astype(np.float32)),
            padded(np.abs(rs.randn(n)).astype(np.float32) * 0.1),
            padded(np.abs(rs.randn(n)).astype(np.float32) * 0.01)]
    g = padded(rs.randn(n).astype(np.float32))
    half = bufs[0].to(torch.bfloat16)
    args = (torch.tensor(1e-3, device=cuda), torch.tensor(0.5, device=cuda),
            0.9, 0.999, 1e-8, False, 0.01)
    for i in range(shards):
        win = slice(i * shard, (i + 1) * shard)
        before = [b.clone() for b in bufs] + [half.clone()]
        plain = [b[win].clone() for b in bufs]
        ph = half[win].clone()
        ops.fused_adam(*[b[win] for b in bufs], g[win], *args,
                       half=half[win])
        adam_mod._adam_plain(*plain, g[win], *args, ph, None)
        for b, p in zip(bufs + [half], plain + [ph]):
            assert torch.equal(b[win], p)
        for b, old in zip(bufs + [half], before):
            rest = torch.ones(b.numel(), dtype=torch.bool, device=cuda)
            rest[win] = False
            assert torch.equal(b[rest], old[rest])


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_step_captured_equals_eager(cuda, nccl_group, deterministic,
                                         stage):
    """ZeRO at world 1 over NCCL, the sharded update captured whole with its
    collectives: losses, masters and moments bitwise the eager run's, and
    (a sum of one) bitwise the unsharded step's."""
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch.nn.functional import cross_entropy
    batch = _images(cuda)

    def run(zero, capture):
        model, opt = _small_resnet(cuda)
        if zero:
            opt.zero_shard(zero_stage=stage,
                           zero_ici_size=None if stage == 1 else 1)

        def step(b):
            x, y = b
            if zero and stage == 3:
                with amp.zero_gather_checkpoint_policy(opt):
                    loss, g = amp.scaled_grad(lambda: cross_entropy(
                        torch.func.functional_call(
                            model, amp.zero_gather_params(opt), (x,)), y),
                        opt)
            else:
                loss, g = amp.scaled_grad(lambda: cross_entropy(model(x), y),
                                          opt)
            opt.step(g)
            return loss
        fn = parallel.make_step(step, model) if capture else step
        losses = torch.stack([fn(batch) for _ in range(4)])
        n = opt.masters.layout.total
        return losses, opt.masters.buf[:n].clone(), opt.state.m[:n].clone()

    plain = run(False, False)
    eager = run(True, False)
    graph = run(True, True)
    for a, b, c in zip(plain, eager, graph):
        assert torch.equal(a, b) and torch.equal(b, c)


class _Stages(torch.nn.Module):
    """Sequential stages of wide tanh layers, as dicts for the staged
    schedule."""

    def __init__(self, device, n=6, width=2048):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.w = torch.nn.ParameterList(
            [torch.nn.Parameter((torch.randn(width, width, generator=g)
                                 / width ** 0.5).to(device))
             for _ in range(n)])
        self.b = torch.nn.ParameterList(
            [torch.nn.Parameter((0.1 * torch.randn(width, generator=g))
                                .to(device)) for _ in range(n)])

    def stage_params(self):
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]


@pytest.mark.cuda
def test_staged_zero2_overlap_keeps_its_buffers_until_the_join(cuda,
                                                               nccl_group):
    """The fused ZeRO-2 staged step with overlap=True at world 1 over NCCL,
    eager and captured: each stage's flat grads, flat params and param
    shard are made on the compute stream and read on the comm stream
    (the predivide, the shard update that reads the params), while the
    next stages' wide backward allocates on the compute stream.  Losses
    and params bitwise the overlap=False run's."""
    from apex_tpu_torch import parallel
    x = torch.randn(8192, 2048, generator=torch.Generator().manual_seed(4)) \
        .to(cuda)

    def fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def head(a):
        return (a ** 2).mean()

    def upd(stage, p, g):
        return p - 0.5 * g

    def run(overlap, capture):
        model = _Stages(cuda)
        ddp = parallel.DistributedDataParallel(
            model, comm_topology="hierarchical", ici_size=1,
            gradient_predivide_factor=2.0, overlap=overlap, zero_stage=2)
        params = model.stage_params()

        def step(xb):
            loss, new = ddp.staged_zero2_allreduce_grads(
                [fn] * len(params), head, params, xb, upd)
            with torch.no_grad():
                for p, q in zip(params, new):
                    p["w"].copy_(q["w"])
                    p["b"].copy_(q["b"])
            return loss
        train = parallel.make_step(step, model) if capture else step
        losses = torch.stack([train(x) for _ in range(4)])
        if capture:
            assert train.replays == 3
        return [losses] + [t.detach().clone() for t in model.parameters()]

    plain = run(False, False)
    for name, got in (("eager", run(True, False)),
                      ("graph", run(True, True))):
        for a, b in zip(got, plain):
            assert torch.equal(a, b), name


# -- tensor and expert parallelism at world 1 over NCCL -----------------------

_MX = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64, num_local_experts=4,
           num_experts_per_tok=2, capacity_factor=2.0)


def _mixtral_steps(device, ep_axis, captured, steps=4):
    """A tiny Mixtral under O2 with fp32 weights (cast_model_type, so the
    card and the CPU compute the same function up to rounding) and
    FusedAdam(max_grad_norm=1.0): the losses of ``steps`` steps and the
    masters after them."""
    from apex_tpu_torch import amp, models, optimizers, parallel
    model, opt = amp.initialize(
        models.Mixtral(models.MixtralConfig(ep_axis=ep_axis, **_MX),
                       device=device,
                       generator=torch.Generator().manual_seed(0)),
        optimizers.FusedAdam(lr=1e-3, max_grad_norm=1.0), opt_level="O2",
        cast_model_type=torch.float32, verbosity=0)
    ids = _t(np.random.RandomState(0).randint(0, 97, (4, 64))).to(device)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
        opt.step(grads)
        return loss

    fn = parallel.make_step(step, model) if captured else step
    losses = torch.stack([fn(ids).float().reshape(()) for _ in range(steps)])
    return losses.cpu(), opt.masters.buf.cpu()


@pytest.mark.cuda
def test_mixtral_captured_step_is_its_eager_step(cuda, nccl_group):
    """A tiny Mixtral (ep_axis the one-rank NCCL group) through make_step:
    losses and masters bitwise its eager steps on the card, and within
    rtol 1e-4 (losses) and 1e-4 of the largest master of the same steps
    run on the CPU (the plain versions; TF32 off, so only the order of
    the sums differs)."""
    import torch.distributed as dist
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eager = _mixtral_steps(cuda, dist.group.WORLD, captured=False)
        graph = _mixtral_steps(cuda, dist.group.WORLD, captured=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = _mixtral_steps(torch.device("cpu"), None, captured=False)
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1], eager[1])
    assert float(eager[0][-1]) < float(eager[0][0])
    torch.testing.assert_close(eager[0], cpu[0], rtol=1e-4, atol=0)
    torch.testing.assert_close(eager[1], cpu[1], rtol=0,
                               atol=1e-4 * float(cpu[1].abs().max()))


@pytest.mark.cuda
def test_tp_llama_is_its_dense_twin(cuda, nccl_group):
    """Llama under tp_axis (the one-rank NCCL group) from a dense model's
    weights through llama_params_to_tp, O2 + FusedAdam through make_step:
    losses and every parameter's master bitwise the dense model's (at
    world 1 the f/g collectives are identities and the same cuBLAS calls
    run)."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers, parallel
    kw = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    dense = models.Llama(models.LlamaConfig(**kw), device=cuda)
    tp = models.Llama(models.LlamaConfig(tp_axis=dist.group.WORLD, **kw),
                      device=cuda,
                      generator=torch.Generator().manual_seed(1))
    tp.load_state_dict(models.llama_params_to_tp(dense.state_dict()))
    ids = _t(np.random.RandomState(0).randint(0, 97, (2, 64))).to(cuda)
    out = []
    for model in (dense, tp):
        model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-3),
                                    opt_level="O2", verbosity=0)

        def step(b, model=model, opt=opt):
            loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
            opt.step(grads)
            return loss

        train = parallel.make_step(step, model)
        losses = torch.stack([train(ids).float() for _ in range(4)])
        layout = opt.masters.layout
        masters = dict(zip(layout.names, layout.pieces(opt.masters.buf)))
        out.append((losses, masters))
    assert torch.equal(out[0][0], out[1][0])
    for name, t in out[0][1].items():
        tp_name = next(iter(models.llama_params_to_tp({name: None})))
        assert torch.equal(out[1][1][tp_name], t), name


# -- sequence and pipeline parallelism at world 1 over NCCL -------------------

_SP_LLAMA = dict(vocab_size=97, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64)


def _held_steps(model, opt, step, batch, captured, steps=4):
    """The losses of ``steps`` steps (through make_step when ``captured``)
    and the masters after them."""
    from apex_tpu_torch import parallel
    fn = parallel.make_step(step, model) if captured else step
    losses = torch.stack([fn(batch).float().reshape(())
                          for _ in range(steps)])
    return losses.cpu(), opt.masters.buf.cpu()


@pytest.mark.cuda
def test_sp_llama_captured_step_is_its_eager_step(cuda, nccl_group):
    """A tiny Llama under sp_axis (the one-rank NCCL group: ring attention
    at n = 1) through make_step: losses and masters bitwise its eager
    steps, and the loss within 1e-2 of the non-SP model's (the flash
    path) on the same weights."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers
    ids = _t(np.random.RandomState(0).randint(0, 97, (2, 64))).to(cuda)
    out = {}
    for name, sp in (("eager", dist.group.WORLD), ("graph", dist.group.WORLD),
                     ("flash", None)):
        model, opt = amp.initialize(
            models.Llama(models.LlamaConfig(sp_axis=sp, **_SP_LLAMA),
                         device=cuda,
                         generator=torch.Generator().manual_seed(0)),
            optimizers.FusedAdam(lr=1e-3), opt_level="O2", verbosity=0)

        def step(b, model=model, opt=opt):
            loss, grads = amp.scaled_grad(lambda: model.loss(b), opt)
            opt.step(grads)
            return loss

        out[name] = _held_steps(model, opt, step, ids, name == "graph")
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert torch.equal(out["graph"][1], out["eager"][1])
    torch.testing.assert_close(out["eager"][0], out["flash"][0], rtol=1e-2,
                               atol=0)


@pytest.mark.cuda
def test_1f1b_captured_step_is_its_eager_step(cuda, nccl_group):
    """Two GPT blocks as the stage of a one-stage pipeline (the one-rank
    NCCL group), four microbatches, O2 + FusedAdam through the 1F1B
    schedule and make_step: losses and masters bitwise the eager steps;
    GPipe's forward bitwise the sequential one."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, models, optimizers
    from apex_tpu_torch.models.gpt import GPTBlock
    from apex_tpu_torch.parallel import pipeline as pp
    cfg = models.GPTConfig(vocab_size=97, block_size=64, n_layer=2,
                           n_head=4, n_embd=64, dropout=0.0)
    rs = np.random.RandomState(0)
    x = _t(rs.randn(4, 2, 64, 64).astype(np.float32)).to(cuda)
    t = _t(rs.randn(4, 2, 64, 64).astype(np.float32)).to(cuda)
    group = dist.group.WORLD
    out = {}
    for name in ("eager", "graph"):
        gen = torch.Generator().manual_seed(0)
        stage, opt = amp.initialize(
            pp.init_stacked(lambda: torch.nn.Sequential(*[
                GPTBlock(cfg, device=cuda, generator=gen,
                         dropout_generator=None) for _ in range(2)]), 1,
                group),
            optimizers.FusedAdam(lr=1e-3), opt_level="O2", verbosity=0)

        def step(batch, stage=stage, opt=opt):
            scale = opt.scalers[0].loss_scale
            loss, grads = pp.pipeline_1f1b_grads(
                stage, lambda y, tt: ((y.float() - tt) ** 2).mean() * scale,
                batch[0], batch[1], group)
            opt.step(grads)
            return loss / scale

        if name == "eager":
            with torch.no_grad():
                assert torch.equal(pp.pipeline_apply(stage, x, group),
                                   pp.pipeline_apply(stage, x, None))
        out[name] = _held_steps(stage, opt, step, (x, t), name == "graph")
    assert torch.equal(out["graph"][0], out["eager"][0])
    assert torch.equal(out["graph"][1], out["eager"][1])
    assert float(out["eager"][0][-1]) < float(out["eager"][0][0])


@pytest.mark.cuda
def test_ulysses_flash_route_at_long_t_matches_plain(cuda, nccl_group):
    """ulysses_attention at (1, 4, 4096, 64) bf16, causal, with a key
    padding mask, on the one-rank NCCL group takes the flash route and
    matches the same call on the CPU (the kernels' plain versions): the
    output and the q/k/v grads within 2e-2 of their largest magnitude."""
    import torch.distributed as dist
    from apex_tpu_torch import transformer
    rs = np.random.RandomState(0)
    qkv = [_t(rs.randn(1, 4, 4096, 64).astype(np.float32)).bfloat16()
           for _ in range(3)]
    mask = _t(rs.rand(1, 4096) > 0.2)
    mask[:, 0] = True
    paths = []
    transformer.set_path_hook(paths.append)
    try:
        res = []
        for dev in (cuda, torch.device("cpu")):
            ts = [a.to(dev, copy=True).requires_grad_() for a in qkv]
            y = transformer.ulysses_attention(
                *ts, axis_name=dist.group.WORLD, causal=True,
                kv_mask=mask.to(dev))
            (y.float() ** 2).sum().backward()
            res.append([y.detach().float().cpu()] + [
                a.grad.float().cpu() for a in ts])
    finally:
        transformer.set_path_hook(None)
    assert paths == ["flash", "flash"]
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-2 * float(b.abs().max()))


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_collected_meanwhile(cuda):
    """A captured function dropped in a reference cycle, then another
    captured with the collector set to run at every allocation: no
    collection runs during the capture (destroying the dead graph there
    would invalidate it), and both replay right."""
    import gc
    from apex_tpu_torch import _graph
    buf = torch.zeros(4, device=cuda)
    old = _graph.CapturedFn(lambda: buf.add_(1.0), cuda)
    old()
    old()                               # captured and replayed
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    out = torch.zeros(4, device=cuda)

    def fn():
        parts = [torch.ones(1, device=cuda) for _ in range(4)]
        out.copy_(torch.cat(parts) + buf)

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        new = _graph.CapturedFn(fn, cuda)
        new()
        new()
        new()
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert new.replays == 2
    assert torch.equal(out.cpu(), torch.full((4,), 3.0))


# -- the legacy surface and the sharded checkpoint ------------------------------

class _ByteMLSTM(torch.nn.Module):
    """A byte embedding, an mLSTM and a decoder back to bytes."""

    def __init__(self, device, width=64, hidden=256, seed=0):
        super().__init__()
        from apex_tpu_torch import RNN
        g = torch.Generator().manual_seed(seed)
        self.embed = nn.Embedding(256, width, device=device, generator=g)
        self.rnn = RNN.mLSTM(width, hidden, device=device, generator=g)
        self.head = nn.Linear(hidden, 256, device=device, generator=g)

    def forward(self, ids):
        out, _ = self.rnn(self.embed(ids))
        return self.head(out)


def _byte_loss(model, ids):
    from apex_tpu_torch.nn import functional as F
    logits = model(ids[:-1]).float()
    return F.cross_entropy(logits.reshape(-1, 256), ids[1:].reshape(-1))


class _PlainOps:
    """The optimizer kernels' plain versions in place of the kernels, on
    the card, while the block runs."""

    def __enter__(self):
        from apex_tpu_torch.ops.multi_tensor import as_scalar
        self.saved = {k: getattr(ops, k) for k in
                      ("multi_tensor_scale", "multi_tensor_l2norm",
                       "fused_adam")}
        ops.multi_tensor_scale = lambda x, s, out=None: mt._scale_plain(
            x, as_scalar(s, x), torch.empty_like(x) if out is None else out)
        ops.multi_tensor_l2norm = mt._l2norm_plain
        ops.fused_adam = (lambda *a, half=None, noop=None:
                          adam_mod._adam_plain(*a, half, noop))
        return self

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(ops, k, f)


@pytest.mark.cuda
def test_legacy_fp16_optimizer_kernels_match_plain(cuda):
    """The legacy FP16_Optimizer over FusedAdam on a half mLSTM: one step
    with clip_master_grads through the kernels and the same step through
    their plain versions, from one state.  The scaled grads and their
    unscale are bitwise; the l2norm sums in another order (within rel
    1e-6, its kernel test's bound), which moves the clip coefficient by as
    much, and Adam's step, normalized by sqrt(v), moves by that relative
    amount of lr at most: the masters within lr * 1e-5 plus one fp32 ulp of
    their largest value.  An inf in the loss skips the step: masters,
    model and moments bitwise, the scale halved."""
    from apex_tpu_torch import fp16_utils, optimizers
    ids = torch.randint(0, 256, (33, 8), generator=torch.Generator()
                        .manual_seed(1)).to(cuda)
    lr = 1e-3
    runs = []
    for plain in (False, True):
        model = fp16_utils.network_to_half(_ByteMLSTM(cuda))
        opt = fp16_utils.FP16_Optimizer(optimizers.FusedAdam(lr=lr),
                                        dynamic_loss_scale=True,
                                        verbose=False)
        opt.setup(model)
        counts = dict(ops.launch_counts())
        with _PlainOps() if plain else contextlib.nullcontext():
            opt.backward(_byte_loss(model, ids))
            norm = opt.clip_master_grads(0.1)
            grads = opt._master_grads.clone()
            opt.step()
        torch.cuda.synchronize()
        launched = {k: v - counts[k] for k, v in ops.launch_counts().items()
                    if v != counts[k]}
        runs.append((model, opt, norm, grads, launched))
    (mk, ok, nk, gk, lk), (mp, op_, np_, gp, lp) = runs
    assert lk == {"multi_tensor_scale": 1, "multi_tensor_l2norm": 1,
                  "fused_adam": 1} and lp == {}
    assert float(nk) > 0.1       # the clip acted
    torch.testing.assert_close(nk, np_, rtol=1e-6, atol=0)
    bound = lr * 1e-5 + 2.0 ** -23 * float(op_.masters.abs().max())
    assert float((ok.masters - op_.masters).abs().max()) <= bound
    # the model's half params are the kernel's half output of the masters
    assert torch.equal(ok._half, ok.masters.half())
    # an inf: the step skipped
    state = [ok.masters.clone(), ok._half.clone(),
             ok._inner_state.m.clone(), ok._inner_state.v.clone()]
    scale = ok.loss_scale
    ok.backward(_byte_loss(mk, ids) * float("inf"))
    assert ok.overflow
    ok.step()
    for a, b in zip(state, [ok.masters, ok._half, ok._inner_state.m,
                            ok._inner_state.v]):
        assert torch.equal(a, b)
    assert ok.loss_scale == scale / 2


@pytest.mark.cuda
def test_dcgan_card_matches_cpu(cuda, monkeypatch):
    """examples/dcgan/main_amp_torch.py's step in fp32 (O0) on the card
    (the syncbn, scale and Adam kernels) and on the CPU (their plain
    versions) from the same weights and data, TF32 off: three iterations,
    the losses within rtol 5e-3 and the BatchNorm running statistics
    within 5e-3 (Adam's first steps move a weight by about lr = 2e-4 in the
    sign of its grad, which a grad near zero need not share across cuDNN's
    and oneDNN's summation orders: 2 lr a step at most), their counts
    exactly."""
    import importlib.util
    import os
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "dcgan",
        "main_amp_torch.py")
    spec = importlib.util.spec_from_file_location("dcgan_example", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    args = ex.parse_args(["--opt-level", "O0", "-b", "4", "--ngf", "8",
                          "--ndf", "8"])
    out = []
    for dev in (cuda, torch.device("cpu")):
        netD, netG, optD, optG = ex.build(args, dev)
        rng = np.random.RandomState(args.seed)
        before = dict(ops.launch_counts())
        losses = [torch.stack(ex.train_step(netD, netG, optD, optG,
                                            *ex.batch(rng, args, dev)))
                  for _ in range(3)]
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        out.append((torch.stack(losses).cpu(), netD, netG, launched))
    (lk, dk, gk, ck), (lp, dp, gp, cp) = out
    assert ck["syncbn_fwd"] == 3 * 17 and ck["syncbn_bwd"] == 3 * 13
    assert ck["fused_adam"] == ck["multi_tensor_scale"] == 6
    assert not any(cp.values())
    torch.testing.assert_close(lk, lp, rtol=5e-3, atol=0)
    for a, b in ((dk, dp), (gk, gp)):
        for (n, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
            if n.endswith("num_batches_tracked"):
                assert int(x) == int(y), n
            else:
                torch.testing.assert_close(x.cpu(), y, rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_checkpoint_orbax_round_trip_of_a_cuda_state(cuda, nccl_group,
                                                     tmp_path):
    """A CUDA amp state (model, optimizer, amp scalers) through
    utils.checkpoint_orbax on a one-rank NCCL group, sync and async (the
    async save's collectives on a gloo group made for it), restored in
    place into fresh CUDA tensors: every tensor bitwise."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.utils import checkpoint_orbax as co
    trees = []
    for seed in (0, 1):
        model, opt = _small_resnet(cuda, seed=seed)
        x = torch.randn(2, 3, 32, 32, device=cuda)
        loss, grads = amp.scaled_grad(lambda: model(x).float().mean(), opt)
        opt.step(grads)
        trees.append({"model": model.state_dict(),
                      "optimizer": opt.state_dict(),
                      "amp": amp.state_dict(opt)})
    saved, fresh = trees
    co.save_checkpoint(str(tmp_path), 1, saved)
    co.save_checkpoint(str(tmp_path), 2, saved, async_save=True)
    co.wait()
    for step in (1, 2):
        back = co.restore_checkpoint(str(tmp_path), fresh, step=step)
        for a, b in zip(_leaves(back), _leaves(saved)):
            assert a.device == b.device and torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# -- the training-run plane on the card ----------------------------------------

def _monitored(model, opt, nm, tele, dm=None, dtele=None):
    """The functional step with the numerics monitor (and device metrics)
    updated in place inside it."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.nn.functional import cross_entropy

    def step(batch):
        x, y = batch
        loss, grads = amp.scaled_grad(lambda: cross_entropy(model(x), y),
                                      opt)
        info = opt.step(grads, grad_health=nm)
        nm.update(tele, grad_stats=info["grad_health"],
                  found_inf=info["found_inf"], loss_scale=info["loss_scale"])
        if dm is not None:
            dm.inc(dtele, "steps")
            dm.set(dtele, "loss_scale", info["loss_scale"])
        return loss
    return step


@pytest.mark.cuda
def test_monitor_flush_is_one_transfer_on_the_card(cuda):
    """NumericsMonitor.flush and DeviceMetrics.flush each synchronize with
    the host once (torch's sync debug mode warns at every host read)."""
    import warnings
    from apex_tpu_torch import observability as obs
    model, opt = _small_resnet(cuda)
    nm = obs.NumericsMonitor(model, registry=obs.MetricsRegistry())
    dm = obs.DeviceMetrics(counters=("steps",), gauges=("loss_scale",),
                           registry=obs.MetricsRegistry())
    tele, dtele = nm.init(), dm.init()
    step = _monitored(model, opt, nm, tele, dm, dtele)
    for _ in range(2):
        step(_images(cuda))
    torch.cuda.synchronize()
    for flush, state in ((nm.flush, tele), (dm.flush, dtele)):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = flush(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in caught]
        assert out["steps"] == 2


@pytest.mark.cuda
def test_captured_step_with_monitor_equals_eager_bitwise(cuda,
                                                         deterministic):
    """make_step over the monitored step against the same step run eagerly
    on a twin: losses, the optimizer's state and the monitor's and device
    metrics' state bitwise after 6 steps (the monitor adds only its own
    kernels to the replay)."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch import parallel
    runs = []
    for captured in (False, True):
        model, opt = _small_resnet(cuda)
        nm = obs.NumericsMonitor(model)
        dm = obs.DeviceMetrics(counters=("steps",), gauges=("loss_scale",))
        tele, dtele = nm.init(), dm.init()
        step = _monitored(model, opt, nm, tele, dm, dtele)
        if captured:
            step = parallel.make_step(step, model)
        losses = [step(_images(cuda, seed=i)) for i in range(6)]
        runs.append((torch.stack(losses), opt, tele, dtele))
        if captured:
            assert step.replays == 5
    (la, oa, ta, da), (lb, ob, tb, db) = runs
    assert torch.equal(la, lb)
    assert torch.equal(oa.masters.buf, ob.masters.buf)
    assert torch.equal(oa.state.m, ob.state.m)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for k in da:
        assert torch.equal(da[k], db[k]), k
    assert float(tb["steps"]) == 6.0 and float(db["steps"]) == 6.0


@pytest.mark.cuda
def test_in_place_rollback_keeps_the_graph(cuda, deterministic):
    """A snapshot taken after step 2, written back in place after step 5:
    the captured step replays on the same addresses, and steps 3..5 come
    out bitwise the first time's."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch import parallel
    model, opt = _small_resnet(cuda)
    nm = obs.NumericsMonitor(model)
    tele = nm.init()
    train = parallel.make_step(_monitored(model, opt, nm, tele), model)
    batches = [_images(cuda, seed=i) for i in range(6)]
    for b in batches[:3]:
        train(b)
    sd = opt.state_dict()
    snap = {"masters": sd["masters"].clone(),
            "inner": {k: v.clone() for k, v in sd["inner"].items()
                      if isinstance(v, torch.Tensor)},
            "scalers": [{k: v.clone() for k, v in s.items()}
                        for s in sd["scalers"]],
            "buffers": {k: b.clone() for k, b in model.named_buffers()},
            "tele": {k: v.clone() for k, v in tele.items()}}
    addrs = [t.data_ptr() for t in (opt.masters.buf, opt.masters.half,
                                    *tele.values())]
    first = [train(b) for b in batches[3:]]
    opt.load_state_dict({"masters": snap["masters"],
                         "inner": snap["inner"], "scalers": snap["scalers"]})
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(snap["buffers"][k])
        for k, v in tele.items():
            v.copy_(snap["tele"][k])
    assert addrs == [t.data_ptr() for t in (opt.masters.buf,
                                            opt.masters.half,
                                            *tele.values())]
    again = [train(b) for b in batches[3:]]
    assert train.replays == 8          # 9 calls: the warm-up, then graphs
    assert torch.equal(torch.stack(first), torch.stack(again))
    assert float(tele["steps"]) == 6.0


# -- the observability plane on the card ---------------------------------------

def _bert_step(device, seed=0):
    """One O2 + FusedAdam step of a small BERT in train mode (dropout
    0.1), weights and batch from ``seed``: the step function and its
    batch (two micro-batches)."""
    from apex_tpu_torch import amp, models, optimizers
    cfg = models.BertConfig(vocab_size=512, hidden_size=128,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=256,
                            max_position_embeddings=64)
    dev = torch.device(device)
    model = models.BertForPretraining(
        cfg, device=dev, generator=torch.Generator().manual_seed(seed),
        dropout_generator=torch.Generator(device=dev).manual_seed(seed))
    model, opt = amp.initialize(model, optimizers.FusedAdam(lr=1e-4),
                                opt_level="O2", verbosity=0)
    model.train()
    rs = np.random.RandomState(seed)
    ids = _t(rs.randint(5, 512, (4, 64))).long().to(dev)
    labels = torch.where(torch.rand(4, 64, generator=torch.Generator()
                                    .manual_seed(seed)) < 0.15,
                         ids.cpu(), -100).to(dev)
    nsp = _t(rs.randint(0, 2, (4,))).long().to(dev)
    batch = tuple(t.reshape(2, 2, *t.shape[1:]) for t in (ids, labels, nsp))

    def step(b):
        loss, grads = amp.scaled_grad_accum(
            lambda mb: model.loss(*mb), opt, b)
        opt.step(grads)
        return loss
    return step, batch, model, opt


@pytest.mark.cuda
def test_count_cost_equal_on_the_card_and_the_cpu(cuda):
    """One step counts the same on the card (the kernels' declarations)
    and on the CPU (their plain versions hidden)."""
    from apex_tpu_torch.observability import costmodel
    got = {}
    for dev in ("cuda", "cpu"):
        step, batch, _, _ = _bert_step(dev)
        got[dev] = costmodel.count_cost(step, batch)
    for f in ("flops", "transcendentals", "bytes_accessed", "matmul_flops",
              "matmul_flops_by_dtype", "flops_by_prim", "unknown_prims"):
        assert getattr(got["cuda"], f) == getattr(got["cpu"], f), f
    assert got["cuda"].matmul_flops > 0


@pytest.mark.cuda
def test_memory_plan_temp_bytes_against_memory_stats(cuda):
    """A captured step's pool is what the allocator reserved around its
    capture: the plan's pool equals the reservation the graph keeps,
    and the plan reassembles."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.observability import memory
    step, batch, model, opt = _bert_step("cuda")
    train = parallel.make_step(step, model)
    train(batch)
    torch.cuda.synchronize()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    train(batch)                               # the capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_stats()["reserved_bytes.all.current"] - reserved
    plan = memory.memory_plan(train, donated=(model, opt))
    assert plan["pool_bytes"] > 0 and plan["temp_bytes"] > 0
    # the pool stays reserved while the graph lives (the returned copy of
    # the loss may take one small segment of its own beside it)
    assert 0 <= kept - plan["pool_bytes"] <= 2 * 2**20, \
        (kept, plan["pool_bytes"])
    assert plan["peak_bytes"] == (plan["argument_bytes"]
                                  + plan["output_bytes"]
                                  + plan["temp_bytes"]
                                  - plan["alias_bytes"])
    assert plan["alias_bytes"] == memory.state_bytes(model, opt)


@pytest.mark.cuda
def test_card_capture_lists_the_port_kernels_as_compute(cuda):
    """A timeline capture on the card lists the kernels of the port that
    the step launched by name, each a compute row."""
    from apex_tpu_torch import parallel
    from apex_tpu_torch.observability import timeline
    step, batch, model, _ = _bert_step("cuda")
    train = parallel.make_step(step, model)
    train(batch)
    train(batch)
    tl = timeline.capture(train.graph.replay, iters=2, top_k=1000)
    assert tl["device_busy_ms"] > 0 and tl["collective_ms"] == 0.0
    found = {}
    for k in tl["top_kernels"]:
        for p in ("flash_fwd", "flash_dq", "flash_dkv", "ln_fwd", "ln_bwd",
                  "adam_kernel", "scale_kernel", "l2norm_"):
            if p in k["name"]:
                found.setdefault(p, set()).add(k["kind"])
    assert len(found) == 8 and all(v == {"compute"}
                                   for v in found.values()), found


@pytest.mark.cuda
def test_launch_lint_over_real_launches(cuda):
    """Every kernel wrapper launched on the card once, each launch linted
    against its kernel's assumptions (``analysis.pallas_lint``), and the
    block and shared memory of the flash and LayerNorm kernels read back
    from the CUDA runtime checked too."""
    from apex_tpu_torch.analysis import pallas_lint
    ops.reset_launch_counts()
    sites, problems = pallas_lint.lint_pallas_kernels(device="cuda")
    assert problems == []
    assert {s.name for s in sites} == set(pallas_lint.WRAPPERS)
    assert all(n >= 1 for n in ops.launch_counts().values())
    assert pallas_lint.card_launch_checks(sites) == []
