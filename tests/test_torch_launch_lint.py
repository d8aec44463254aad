"""The launch lint over the port's ``ctypes`` kernels, the twins of
tests/test_pallas_lint.py: every check flags its seeded violation, the
clean site passes, and every wrapper of ``ops/`` lints clean.

The sites are recorded on the CPU, where each wrapper runs its plain
version; a launch on the card is linted by the ``cuda``-marked test of
tests/test_torch_cuda.py and by ``chip_smoke.py``'s analysis phase.
"""

import dataclasses

import pytest
import torch

from apex_tpu_torch import ops
from apex_tpu_torch.analysis import pallas_lint
from apex_tpu_torch.analysis.graphs import TensorMeta
from apex_tpu_torch.analysis.pallas_lint import check_site

import torch_threads  # noqa: F401  (one torch thread a process)


def _adam_site(**launch):
    n = 1000
    ts = {k: torch.zeros(n) for k in ("p", "m", "v", "g")}
    sites = pallas_lint.collect_kernel_sites(lambda: ops.fused_adam(
        ts["p"], ts["m"], ts["v"], ts["g"], torch.ones(()),
        torch.ones(()), 0.9, 0.999, 1e-8, False, 0.0,
        half=torch.zeros(n, dtype=torch.bfloat16), noop=torch.zeros(())))
    (site,) = sites
    if launch:
        site.launch = dict(site.launch, **launch)
    return site


def _scale_site(x, out=None):
    (site,) = pallas_lint.collect_kernel_sites(
        lambda: ops.multi_tensor_scale(x, 0.5, out=out))
    return site


def _with(site, name, **kw):
    ops_ = dict(site.operands)
    ops_[name] = dataclasses.replace(ops_[name], **kw)
    return dataclasses.replace(site, operands=ops_)


def test_clean_site_passes():
    assert check_site(_adam_site()) == []
    assert check_site(_scale_site(torch.zeros(1000))) == []


def test_non_divisible_block_flags():
    """A block of threads that is no whole number of warps (or past 1024
    threads): the kernels' per-warp reductions assume whole warps."""
    for block in (100, 2048):
        problems = check_site(_adam_site(block=block))
        assert any(p.startswith("block:") for p in problems), problems


def test_out_of_bounds_index_map_flags():
    """A count past the kernel's index type steps outside what its int
    indices reach (flash's and LayerNorm's are int)."""
    (site,) = pallas_lint.collect_kernel_sites(lambda: ops.layer_norm_fwd(
        torch.ones(4, 64), None, None, 1e-5))
    big = _with(site, "x2", shape=(2 ** 21, 2 ** 11), stride=(2 ** 11, 1))
    problems = check_site(big)
    assert any(p.startswith("elements:") and "index type" in p
               for p in problems), problems
    problems = check_site(_adam_site(grid=(2 ** 31,)))
    assert any(p.startswith("grid:") for p in problems), problems


def test_index_map_rank_mismatch_flags():
    """An operand of another rank or a strided view where the kernel
    indexes a contiguous buffer flat."""
    site = _adam_site()
    strided = _with(site, "m", stride=(2,))
    assert any(p.startswith("contiguous:") for p in check_site(strided))
    (ln,) = pallas_lint.collect_kernel_sites(lambda: ops.layer_norm_fwd(
        torch.ones(4, 64), None, None, 1e-5))
    rank3 = _with(ln, "x2", shape=(2, 2, 64), stride=(128, 64, 1))
    assert any("rank" in p for p in check_site(rank3))


def test_double_aliased_output_flags():
    """An in-place output that overlaps its input without being the same
    buffer (``out`` one element past ``x``), and a written operand over
    another (Adam's m on v) are two writes racing one buffer."""
    buf = torch.zeros(2000)
    same = _scale_site(buf[:1000], out=buf[:1000])
    assert check_site(same) == []
    # (the plain version refuses the overlap itself, so the site is
    # seeded: out one element past x in the same buffer)
    shifted = _with(same, "out", ptr=same.operands["x"].ptr + 4)
    problems = check_site(shifted)
    assert any(p.startswith("in place:") for p in problems), problems
    site = _adam_site()
    racing = _with(site, "m", ptr=site.operands["v"].ptr,
                   storage=site.operands["v"].storage)
    assert any(p.startswith("overlap:") for p in check_site(racing))


def test_alias_shape_mismatch_flags():
    """A dtype or a length the kernel does not take: fp16 masters, a half
    copy in fp32, a moment shorter than the parameters."""
    site = _adam_site()
    assert any(p.startswith("dtype:") for p in
               check_site(_with(site, "p", dtype="float16")))
    assert any(p.startswith("dtype:") for p in
               check_site(_with(site, "half", dtype="float32")))
    assert any(p.startswith("elements:") for p in
               check_site(_with(site, "v", shape=(999,))))
    (fl,) = [s for s in pallas_lint.collect_kernel_sites()
             if s.name == "flash_fwd"]
    mixed = _with(fl, "k3", dtype="float16")
    assert any("share a dtype" in p for p in check_site(mixed))


def test_alias_index_out_of_range_flags():
    """A base address off the vector path's alignment (a flat fp32
    window 4 bytes into its buffer) and dynamic shared memory past
    Hopper's opt-in 227 KB."""
    site = _scale_site(torch.zeros(1000))
    off = _with(site, "x", ptr=site.operands["x"].ptr + 4)
    assert any(p.startswith("alignment:") for p in check_site(off))
    problems = check_site(dataclasses.replace(
        _adam_site(), launch={"smem": 228 * 1024}))
    assert any(p.startswith("shared memory:") for p in problems)
    assert check_site(dataclasses.replace(
        _adam_site(), launch={"smem": 227 * 1024})) == []


def test_smem_scalar_spec_is_exempt():
    """The 0-d device scalars (Adam's step size, the skip flag) and an
    unaligned base where the kernel picks its scalar path (Adam, flash,
    LayerNorm) take no vector alignment."""
    site = _adam_site()
    moved = _with(_with(site, "step_size", ptr=site.operands[
        "step_size"].ptr + 4), "p", ptr=site.operands["p"].ptr + 4)
    assert check_site(moved) == []


def test_real_kernel_family_lints_clean():
    """Every kernel wrapper of ops/ — the multi-tensor family and the
    per-tensor l2norm, Adam (both write-out arities), both LAMB stages,
    syncbn forward and backward, LayerNorm forward and backward, flash
    forward, dQ and dK/dV — records a site and lints clean."""
    sites, problems = pallas_lint.lint_pallas_kernels()
    assert problems == []
    names = {s.name for s in sites}
    assert names == set(pallas_lint.WRAPPERS) == set(ops.WRAPPERS)
    assert len(sites) >= 16, [s.describe() for s in sites]
    assert all(s.launch.get("block") == 256 for s in sites
               if s.name == "fused_adam")


def test_aliased_kernels_record_their_donations():
    """The in-place optimizer kernels record the operands they write: the
    port's counterpart of the Pallas kernels' input/output aliases."""
    n = 64
    p, m, v = (torch.zeros(n) for _ in range(3))
    with pallas_lint.capture_kernel_sites(sites := []):
        ops.fused_adam(p, m, v, torch.ones(n), torch.ones(()),
                       torch.ones(()), 0.9, 0.999, 1e-8, False, 0.0)
    (adam,) = sites
    assert adam.written == ops.fused_adam.writes == ("p", "m", "v", "half")
    (st2,) = [s for s in pallas_lint.collect_kernel_sites()
              if s.name == "lamb_stage2"]
    assert st2.written == ("p", "half")
    # the read-only kernels write nothing they are given
    assert all(not s.written for s in pallas_lint.collect_kernel_sites()
               if s.name.startswith(("flash_", "layer_norm_", "syncbn_")))
    # a recorded written operand that overlaps another flags
    assert check_site(dataclasses.replace(
        adam, written=("g",), operands=dict(
            adam.operands, g=adam.operands["p"]))) != []


@pytest.mark.parametrize("check", pallas_lint.CHECKS)
def test_each_check_fires(check):
    """Each check of the launch lint names itself in a message on some
    seeded site (the tests above seed them)."""
    site = _adam_site()
    seeded = {
        "dtype": _with(site, "p", dtype="float16"),
        "contiguous": _with(site, "m", stride=(2,)),
        "alignment": _with(_scale_site(torch.zeros(64)), "x",
                           ptr=TensorMeta.of(torch.zeros(64)).ptr + 4),
        "elements": _with(site, "v", shape=(3,)),
        "grid": dataclasses.replace(site, launch={"grid": (0,)}),
        "block": dataclasses.replace(site, launch={"block": 33}),
        "shared memory": dataclasses.replace(site,
                                             launch={"smem": 10 ** 6}),
        "in place": None,
        "overlap": _with(site, "m", ptr=site.operands["v"].ptr,
                         storage=site.operands["v"].storage),
    }[check]
    if check == "in place":
        buf = torch.zeros(200)
        same = _scale_site(buf[:100], out=buf[:100])
        seeded = _with(same, "out", ptr=same.operands["x"].ptr + 4)
    assert any(p.startswith(check + ":") for p in check_site(seeded))
