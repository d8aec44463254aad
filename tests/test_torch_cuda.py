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
from apex_tpu_torch.multi_tensor_apply import ChunkedFlatLayout
from apex_tpu_torch.ops import adam as adam_mod
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import lamb as lamb_mod
from apex_tpu_torch.ops import layer_norm as lnm
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


# -- the LayerNorm forward: 16-byte rows, a block a wide row -------------------

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


# -- LAMB and the per-tensor l2norm ---------------------------------------------

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


# -- amp O1 and checkpoints on the card -------------------------------------------

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


# -- layouts, the ResNet family, the imagenet example -----------------------------

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


# -- the functional step captured in a CUDA graph --------------------------------

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
