"""The wider data-parallel stack of the port on 4 gloo ranks against the
JAX package on 4 of its CPU devices under ``shard_map``: the hierarchical
reduce (two "nodes" of two ranks), Adasum, the staged and overlapped
schedules, the fused ZeRO-2 staged step and the hook path with
``overlap=True``.  The specs are ``tests/test_ddp.py:291-531``,
``tests/test_adasum.py`` and ``tests/test_overlap.py``.

The ranks start once for the file (``tests/torch_dist_worker.py``, suite
``wide_ddp``).  Tolerances: the JAX package's own where it states one
(rtol 1e-6 for a reduction against another order of the same sum, 2e-2
relative for the bf16 cross-node hop, 2e-5 for Adasum); within the port,
schedules that issue the same collectives on the same buffers are held
bitwise.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import parallel as jparallel
from apex_tpu.parallel import adasum as jadasum

import torch

from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import adasum as padasum

import torch_dist_worker
import torch_threads  # noqa: F401  (one torch thread a process)

WORLD = 4
S, H, B = 4, 32, 8


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(15)
    e = np.zeros((4, 8), np.float32)
    e[0, 0], e[1, 0] = 2.0, 4.0      # node 0 along e1, mean 3*e1
    e[2, 1], e[3, 1] = 2.0, 4.0      # node 1 along e2, mean 3*e2
    return {
        "g1001": rs.randn(1001).astype(np.float32),   # 1001 % 4: pads
        "g512": rs.randn(512).astype(np.float32),
        "larc_x": rs.randn(16, 4).astype(np.float32),
        "larc_y": rs.randn(16, 2).astype(np.float32),
        "larc_w": [rs.randn(8, 4).astype(np.float32) * 0.5,
                   np.full(8, 0.1, np.float32),
                   rs.randn(2, 8).astype(np.float32) * 0.5,
                   np.zeros(2, np.float32)],
        "ada4": rs.randn(4, 4, 3).astype(np.float32),
        "ada2": rs.randn(2, 4, 3).astype(np.float32),
        "ada_g": rs.randn(6, 2).astype(np.float32),
        "ada_slices": rs.randn(2, 16).astype(np.float32),
        "ada_e": e,
        "ada_w": rs.randn(5, 2).astype(np.float32),
        "ada_x": rs.randn(8, 5).astype(np.float32),
        "ada_y": rs.randn(8, 2).astype(np.float32),
        "stage_params": [{"w": (rs.randn(H, H) * 0.1).astype(np.float32),
                          "b": (rs.randn(H) * 0.01).astype(np.float32)}
                         for _ in range(S)],
        "stage_x": rs.randn(B, H).astype(np.float32),
        "stage_y": rs.randn(B, H).astype(np.float32),
        "deep_x": rs.randn(8, 16).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return torch_dist_worker.run("wide_ddp", inputs,
                                 tmp_path_factory.mktemp("wide_ddp"), WORLD)


def _mesh(n=WORLD):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _run(fn, *args, n=WORLD, in_specs=(P("data"),), out_specs=P()):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(*args)


def _rank_grads(g):
    rank = lax.axis_index("data").astype(jnp.float32)
    return {"w": jnp.asarray(g) * (rank + 1)}


# -- the hierarchical reduce (tests/test_ddp.py:291-531) ----------------------

def test_hierarchical_matches_flat_and_jax(ranks, inputs):
    g = inputs["g1001"]

    def fn(_):
        return tuple(jparallel.allreduce_grads_tree(
            _rank_grads(g), "data", **kw)["w"] for kw in (
                {}, dict(comm_topology="hierarchical", ici_size=2),
                dict(comm_topology="hierarchical", ici_size=4)))

    jflat, jh2, jh4 = _run(fn, jnp.arange(4.0))
    for r in ranks:
        h = r["hier"]
        np.testing.assert_array_equal(h["flat"][0],
                                      ranks[0]["hier"]["flat"][0])
        np.testing.assert_allclose(h["flat"][0], np.asarray(jflat), rtol=1e-6)
        for k, want in (("h2", jh2), ("h4", jh4)):
            np.testing.assert_allclose(h[k][0], h["flat"][0], rtol=1e-6)
            np.testing.assert_allclose(h[k][0], np.asarray(want), rtol=1e-6)
        # one rank a node: the cross-node hop is the whole sum
        np.testing.assert_allclose(h["h1"][0], h["flat"][0], rtol=1e-6)


def test_hierarchical_compressed_at_bf16_tolerance(ranks, inputs):
    g = inputs["g512"]

    def fn(_):
        return jparallel.allreduce_grads_tree(
            _rank_grads(g), "data", comm_topology="hierarchical",
            ici_size=2, allreduce_compress_bf16=True)["w"]

    jc = np.asarray(_run(fn, jnp.arange(4.0)))
    h = ranks[0]["hier"]
    f, c = h["flat512"][0], h["comp512"][0]
    assert np.max(np.abs(c - f) / np.maximum(np.abs(f), 1e-3)) < 2e-2
    assert np.any(c != f)                   # the wire really was bf16
    # the same per-node sums quantized the same way as the JAX package's
    np.testing.assert_allclose(c, jc, rtol=1e-6)


def test_hierarchical_fp32_comm_mixed_dtypes_and_predivide(ranks, inputs):
    h = ranks[0]["hier"]
    for k in ("fp32comm", "fp32comm_c"):
        vals, dtypes, _ = h[k]
        assert dtypes == ["torch.bfloat16"]
        np.testing.assert_allclose(vals[0], 3.0)
    # the mean taken once across both levels
    np.testing.assert_allclose(h["predivide"][0], 8.0)
    for k in ("a", "b"):
        hv, hd = h["mixed_hierarchical"][k]
        fv, fd = h["mixed_flat"][k]
        assert hd == fd
        tol = 1e-6 if fd == "torch.float32" else 1e-2
        np.testing.assert_allclose(hv, fv, rtol=tol, atol=tol)


def test_hierarchical_composes_with_larc(ranks):
    larc = ranks[0]["hier"]["larc"]
    np.testing.assert_allclose(larc["flat"]["losses"],
                               larc["hierarchical"]["losses"], rtol=1e-5)
    np.testing.assert_allclose(larc["flat"]["params"],
                               larc["hierarchical"]["params"], rtol=1e-4,
                               atol=1e-6)


def test_comm_stats_by_level_and_auto_equal_the_jax_packages(ranks):
    """``last_comm_stats`` key for key the JAX wrapper's trace-time
    records, for the hierarchical, chunked, compressed and auto wrappers
    (auto resolves flat: the launcher puts the ranks on one node)."""
    stats = ranks[0]["hier"]["stats"]
    want = {}
    for name, kw in (("h", dict(comm_topology="hierarchical", ici_size=4)),
                     ("c", dict(message_size=100)),
                     ("hc", dict(comm_topology="hierarchical", ici_size=2,
                                 allreduce_compress_bf16=True)),
                     ("auto", dict(comm_topology="auto",
                                   allreduce_compress_bf16=True))):
        ddp = jparallel.DistributedDataParallel(**kw)
        _run(lambda _: ddp.allreduce_grads({"w": jnp.ones((310,))}),
             jnp.arange(4.0))
        want[name] = ddp.last_comm_stats
    assert stats == want
    (h,) = stats["h"]
    assert h["wire_elements"] == 312 and h["padded_elements"] == 2
    assert h["dcn_wire_bytes"] == 78 * 4
    assert h["ici_wire_bytes"] == 312 * 4 + 78 * 4
    assert [b["topology"] for b in stats["auto"]] == ["flat"]


def test_topology_knob_errors(ranks):
    with pytest.raises(ValueError, match="comm_topology"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                         comm_topology="diagonal")
    with pytest.raises(ValueError, match="no inner level"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                         allreduce_compress_bf16=True)
    with pytest.raises(ValueError, match="allreduce_compress_bf16"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2), adasum=True,
                                         comm_topology="hierarchical",
                                         allreduce_compress_bf16=True)
    with pytest.raises(ValueError, match="divide"):
        parallel.hierarchical_axis_groups(8, 3)
    assert "divide" in ranks[0]["hier"]["bad_ici"]


def test_topology_helpers_equal_the_jax_packages():
    for world, ici in ((8, 4), (8, 2), (4, 1), (6, 3)):
        assert parallel.hierarchical_axis_groups(world, ici) == \
            jparallel.hierarchical_axis_groups(world, ici)
    for n in (1, 3, 5):
        assert parallel.overlap_issue_order(n) == \
            jparallel.overlap_issue_order(n)
    with pytest.raises(ValueError):
        parallel.overlap_issue_order(0)
    from apex_tpu.parallel import topology as jtopo
    sizes = {"data": 2, "sp": 2, "tp": 2}
    for axes in ("data", ("sp", "tp"), "tp"):
        assert parallel.collective_rank_groups(sizes, axes) == \
            jtopo.collective_rank_groups(sizes, axes)
    assert parallel.collective_rank_groups(sizes, "sp", [[1, 0]]) == \
        jtopo.collective_rank_groups(sizes, "sp", [[1, 0]])
    assert parallel.default_ici_size(8, nproc=2) == 4
    assert parallel.auto_comm_topology(nproc=2) == "hierarchical"
    assert parallel.auto_comm_topology(nproc=1) == "flat"
    m = parallel.make_mesh(devices=8, data=-1, sp=2)
    assert m.shape == {"data": 4, "sp": 2}
    assert "sp" in parallel.mesh_info(m)
    with pytest.raises(ValueError, match="at most one axis"):
        parallel.make_mesh(devices=8, a=-1, b=-1)
    with pytest.raises(ValueError, match="do not divide"):
        parallel.make_mesh(devices=8, data=3)


def test_mesh_groups_are_the_collective_rank_groups(ranks):
    """``make_mesh(data=-1, sp=2).group(axis)`` on 4 ranks: each rank's
    group is its row of ``collective_rank_groups``."""
    sizes = {"data": 2, "sp": 2}
    for rank, r in enumerate(ranks):
        for axis, got in r["mesh"].items():
            (want,) = [g for g in parallel.collective_rank_groups(sizes,
                                                                  axis)
                       if rank in g]
            assert tuple(got) == want, (rank, axis)


def test_allreduce_comm_plan_equals_the_jax_packages():
    shapes = {"a": ((310,), "float32"), "b": ((40, 3), "bfloat16"),
              "c": ((7,), "float32")}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
             for k, (s, d) in shapes.items()}
    ptree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
             for k, (s, d) in shapes.items()}
    for kw in (dict(comm_topology="hierarchical", ici_size=4, world=8),
               dict(comm_topology="hierarchical", ici_size=2, world=8,
                    allreduce_compress_bf16=True,
                    allreduce_always_fp32=True),
               dict(comm_topology="auto", world=8, nproc=2),
               dict(message_size=100), dict(delay_allreduce=True)):
        assert parallel.allreduce_comm_plan(ptree, **kw) == \
            jparallel.allreduce_comm_plan(jtree, **kw), kw
    with pytest.raises(ValueError, match="world"):
        parallel.allreduce_comm_plan(ptree, comm_topology="hierarchical")
    assert padasum.adasum_comm_plan(ptree, 8, 2) == \
        jadasum.adasum_comm_plan(jtree, 8, 2)


def test_analysis_and_numerics_hooks_name_their_items():
    """The analysis folds (ported with apex_tpu_torch.analysis) equal the
    JAX package's dicts on the same plans and schedules."""
    shapes = {"a": ((310,), "float32"), "b": ((40, 3), "bfloat16"),
              "c": ((7,), "float32")}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
             for k, (s, d) in shapes.items()}
    ptree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
             for k, (s, d) in shapes.items()}
    for kw in (dict(comm_topology="hierarchical", ici_size=4, world=8),
               dict(comm_topology="hierarchical", ici_size=2, world=8,
                    allreduce_compress_bf16=True)):
        pplan = parallel.allreduce_comm_plan(ptree, **kw)
        jplan = jparallel.allreduce_comm_plan(jtree, **kw)
        assert parallel.plan_collective_expectations(
            pplan, extra_psums=2, extra_psum_bytes=8) == \
            jparallel.plan_collective_expectations(
                jplan, extra_psums=2, extra_psum_bytes=8)
        assert parallel.plan_resharding_expectations(
            pplan, budget={"all_gather": 1}) == \
            jparallel.plan_resharding_expectations(
                jplan, budget={"all_gather": 1})
    stages = [{"w": ((32, 32), "float32"), "b": ((32,), "float32")}] * 3
    jst = [{k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
            for k, (s, d) in st.items()} for st in stages]
    pst = [{k: torch.empty(s, dtype=getattr(torch, d), device="meta")
            for k, (s, d) in st.items()} for st in stages]
    for overlap in (True, False):
        kw = dict(comm_topology="hierarchical", ici_size=4, world=8,
                  nproc=1, overlap=overlap)
        assert parallel.overlap_collective_expectations(
            parallel.overlap_comm_schedule(pst, **kw), extra_psums=2,
            extra_psum_bytes=8) == \
            jparallel.overlap_collective_expectations(
                jparallel.overlap_comm_schedule(jst, **kw), extra_psums=2,
                extra_psum_bytes=8)


# -- Adasum (tests/test_adasum.py) --------------------------------------------

def test_adasum_pair_properties():
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(64).astype(np.float32))
    pair = padasum.adasum_pair
    torch.testing.assert_close(pair(a, a), a, rtol=1e-6, atol=0)
    b = torch.zeros(64)
    b[1] = 3.0
    a0 = torch.zeros(64)
    a0[0] = 2.0
    torch.testing.assert_close(pair(a0, b), a0 + b, rtol=1e-6, atol=0)
    c = torch.from_numpy(rng.randn(64).astype(np.float32))
    torch.testing.assert_close(pair(a, c), pair(c, a), rtol=1e-6, atol=0)
    torch.testing.assert_close(pair(a, torch.zeros(64)), a, rtol=1e-6,
                               atol=0)
    # the JAX package's rule on the same operands
    np.testing.assert_allclose(
        pair(a, c).numpy(),
        np.asarray(jadasum.adasum_pair(jnp.asarray(a.numpy()),
                                       jnp.asarray(c.numpy()))), rtol=2e-6)


def _host_tree_reduce(mats):
    vals = [jnp.asarray(m) for m in mats]
    n, stride = len(vals), 1
    while stride < n:
        vals = [jadasum.adasum_pair(vals[i & ~stride], vals[i | stride])
                for i in range(n)]
        stride *= 2
    return vals


@pytest.mark.parametrize("n", [2, 4])
def test_adasum_butterfly_matches_host_recursion_and_jax(ranks, inputs, n):
    per_rank = inputs[f"ada{n}"]
    got = [r["adasum"][f"n{n}"] for r in ranks[:n]]
    ref = _host_tree_reduce(list(per_rank))
    jout = _run(lambda g: jadasum.adasum_grads({"w": g[0]})["w"][None],
                jnp.asarray(per_rank), n=n, in_specs=P("data"),
                out_specs=P("data"))
    for r in range(n):
        np.testing.assert_allclose(got[r], np.asarray(ref[r]), rtol=2e-5)
        np.testing.assert_allclose(got[r], np.asarray(jout[r]), rtol=2e-5)
        np.testing.assert_array_equal(got[r], got[0])   # every rank alike


def test_adasum_power_of_two_required(ranks):
    for r in ranks[:3]:
        assert "power-of-two" in r["adasum"]["three"]


def test_adasum_wrapper_averages_identical_grads(ranks, inputs):
    g = inputs["ada_g"]
    for r in ranks:
        for name, topo in (("wrapper", "flat"),
                           ("wrapper_h", "hierarchical")):
            got, stats = r["adasum"][name]
            np.testing.assert_allclose(got, g, rtol=2e-5)
            assert [s["topology"] for s in stats] == [topo]
        np.testing.assert_allclose(r["adasum"]["one_slice"], g, rtol=2e-5)
    ddp = jparallel.DistributedDataParallel(adasum=True,
                                            comm_topology="hierarchical",
                                            ici_size=2)
    _run(lambda gg: ddp.allreduce_grads({"w": gg})["w"], jnp.asarray(g),
         in_specs=P(), out_specs=P())
    assert ranks[0]["adasum"]["wrapper_h"][1] == ddp.last_comm_stats


def test_adasum_rejects_psum_knobs():
    for kw in (dict(retain_allreduce_buffers=True),
               dict(gradient_average=False)):
        with pytest.raises(ValueError, match="no effect"):
            parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                             adasum=True, **kw)


def test_adasum_hierarchical_levels(ranks, inputs):
    """Node-identical grads: hierarchical bitwise the flat butterfly (and
    the JAX package's); orthogonal node means add with one average."""
    for r in ranks:
        np.testing.assert_array_equal(r["adasum"]["slice_hier"],
                                      r["adasum"]["slice_flat"])
        want = np.zeros(8, np.float32)
        want[0] = want[1] = 3.0
        np.testing.assert_allclose(r["adasum"]["analytic"], want, rtol=1e-6)
    per = inputs["ada_slices"]

    def fn(_):
        g = {"w": jnp.asarray(per)[lax.axis_index("data") // 2]}
        return jadasum.adasum_grads(g, "data", ici_size=2)["w"]

    np.testing.assert_allclose(ranks[0]["adasum"]["slice_hier"],
                               np.asarray(_run(fn, jnp.arange(4.0))),
                               rtol=2e-5)


def test_adasum_train_step_averages(ranks, inputs):
    w, x, y = (torch.from_numpy(inputs[k]) for k in ("ada_w", "ada_x",
                                                     "ada_y"))
    w.requires_grad_()
    (solo,) = torch.autograd.grad(((x @ w - y) ** 2).mean(), [w])
    for r in ranks:
        np.testing.assert_allclose(r["adasum"]["train"], solo.numpy(),
                                   rtol=2e-5)


# -- the staged schedules (tests/test_overlap.py) -----------------------------

def _leaves(grads):
    return [g[k] for g in grads for k in ("w", "b")]


def _jax_staged(inputs, overlap=True, compress=False):
    sp = [{k: jnp.asarray(v) for k, v in p.items()}
          for p in inputs["stage_params"]]
    ddp = jparallel.DistributedDataParallel(
        comm_topology="hierarchical", allreduce_compress_bf16=compress,
        ici_size=2, overlap=overlap)
    fns = [lambda p, a: jnp.tanh(a @ p["w"] + p["b"])] * S

    def step(params, batch):
        xb, yb = batch
        loss, grads = ddp.staged_allreduce_grads(
            fns, lambda a: jnp.mean((a - yb) ** 2), params, xb)
        return list(grads), loss

    g, _ = _run(step, sp, (jnp.asarray(inputs["stage_x"]),
                           jnp.asarray(inputs["stage_y"])),
                in_specs=(P(), (P("data"), P("data"))), out_specs=(P(), P()))
    return ddp, g


def test_overlapped_is_after_backward_is_monolithic_and_jax(ranks, inputs):
    jddp, jg = _jax_staged(inputs)
    for r in ranks:
        st = r["staged"]
        for a, b in zip(_leaves(st["ov"][0]), _leaves(st["ba"][0])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(st["ov"][0]), _leaves(st["mono"])):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
        for a, b in zip(_leaves(st["ov"][0]), _leaves(jg)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-8)
        for a, b in zip(_leaves(st["cov"][0]), _leaves(st["cba"][0])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(st["cov"][0]), _leaves(st["ov"][0])):
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


def test_schedule_matches_runtime_stats_and_jax(ranks, inputs):
    sp = [{k: torch.from_numpy(v) for k, v in p.items()}
          for p in inputs["stage_params"]]
    sched = parallel.overlap_comm_schedule(
        sp, comm_topology="hierarchical", ici_size=2, world=WORLD, nproc=1)
    jsp = [{k: jnp.asarray(v) for k, v in p.items()}
           for p in inputs["stage_params"]]
    jsched = jparallel.overlap_comm_schedule(
        jsp, comm_topology="hierarchical", ici_size=2, world=WORLD, nproc=1)
    assert sched == jsched
    assert sched["issue_order"] == [3, 2, 1, 0]
    _, _, stats, ls = ranks[0]["staged"]["ov"]
    assert len(sched["buckets"]) == len(stats) == S
    for pb, rb in zip(sched["buckets"], stats):
        for k in ("stage", "issue_order", "cause", "topology",
                  "ici_wire_bytes", "dcn_wire_bytes"):
            assert pb[k] == rb[k], k
        assert pb["wire_bytes"] == rb["bytes"]
    assert ls["overlap_mode"] == "overlapped" and ls["n_stages"] == S
    assert parallel.overlap_schedule_fields(ls) == {
        "overlap_mode": "overlapped", "n_stages": S,
        "issue_order": [3, 2, 1, 0]}
    assert parallel.overlap_schedule_fields(None) == \
        jparallel.overlap_schedule_fields(None)
    assert ranks[0]["staged"]["ba"][3]["overlap_mode"] == \
        "reduce_after_backward"


def test_staged_zero2_matches_unfused_update(ranks, inputs):
    sp = inputs["stage_params"]
    for r in ranks:
        st = r["staged"]
        ref = [{k: sp[s][k] - np.float32(0.1) * st["ov"][0][s][k]
                for k in ("w", "b")} for s in range(S)]
        for a, b in zip(_leaves(st["z_ov"][0]), _leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for a, b in zip(_leaves(st["z_ov"][0]), _leaves(st["z_ba"][0])):
            np.testing.assert_array_equal(a, b)
    _, _, stats, ls = ranks[0]["staged"]["z_ov"]
    sched = parallel.overlap_comm_schedule(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in sp],
        comm_topology="hierarchical", ici_size=2, world=WORLD, nproc=1,
        zero_stage=2)
    assert sched["zero_stage"] == 2
    for pb, rb in zip(sched["buckets"], stats):
        for k in ("stage", "issue_order", "topology", "ici_wire_bytes",
                  "dcn_wire_bytes"):
            assert pb[k] == rb[k], k
        assert pb["wire_bytes"] == rb["bytes"]
    fields = parallel.overlap_schedule_fields(ls)
    assert fields["zero_stage"] == 2 and fields["overlap_mode"] == \
        "overlapped"


def test_overlap_and_zero2_knob_clashes(ranks):
    for kw in ({"delay_allreduce": True}, {"adasum": True},
               {"allreduce_trigger_params": ["weight"]}):
        with pytest.raises(ValueError, match="overlap"):
            parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                             overlap=True, **kw)
    with pytest.raises(ValueError, match="stage 2 only"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                         comm_topology="hierarchical",
                                         ici_size=4, zero_stage=3)
    with pytest.raises(ValueError, match="hierarchical"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2), zero_stage=2)
    with pytest.raises(ValueError, match="adasum"):
        parallel.DistributedDataParallel(torch.nn.Linear(2, 2),
                                         comm_topology="hierarchical",
                                         ici_size=4, zero_stage=2,
                                         adasum=True)
    with pytest.raises(ValueError, match="zero_stage"):
        parallel.overlap_comm_schedule([{}], comm_topology="hierarchical",
                                       ici_size=4, world=8, nproc=1,
                                       zero_stage=1)
    errors = ranks[0]["staged"]["errors"]
    assert "staged" in errors["delay"]
    assert "zero_stage=2" in errors["plain_zero2"]
    assert "shards the update" in errors["armed_allreduce"]


def test_hook_path_overlap_is_bitwise_its_after_backward_twin(ranks):
    for r in ranks:
        for name, got in r["hook_overlap"].items():
            plain, over = got[False], got[True]
            assert plain[0].keys() == over[0].keys(), name
            for k in plain[0]:
                np.testing.assert_array_equal(plain[0][k], over[0][k],
                                              f"{name} {k}")
            assert plain[1] == over[1], name        # the same buckets
            assert plain[2] and over[2], name       # no grad stays None
        # every rank ends with the same grads
        for name in r["hook_overlap"]:
            for k, v in r["hook_overlap"][name][True][0].items():
                np.testing.assert_array_equal(
                    v, ranks[0]["hook_overlap"][name][True][0][k])
    # several chunks, each issued as its grads arrive
    (stats,) = ranks[0]["hook_overlap"]["chunked"][True][1]
    assert stats["cause"] == "chunked" and stats["chunks"] > 4


def test_mesh_groups_are_made_anew_for_each_default_group(tmp_path,
                                                          monkeypatch):
    """The cache of groups follows the default group: after
    ``destroy_process_group`` and a new ``init_process_group`` in the same
    process (whose group may take a destroyed group's address), the
    hierarchical groups are the new group's, and a collective over them
    runs."""
    from apex_tpu_torch.parallel import topology
    monkeypatch.setenv("GLOO_SOCKET_IFNAME",
                       os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    for i in range(6):
        parallel.init_process_group(
            init_method=f"file://{tmp_path / f'store{i}'}", world_size=1,
            rank=0)
        try:
            for g in topology.hierarchical_groups(1, 1):
                assert torch.distributed.get_process_group_ranks(g) == [0]
                t = torch.ones(3)
                torch.distributed.all_reduce(t, group=g)
                assert torch.equal(t, torch.ones(3))
        finally:
            torch.distributed.destroy_process_group()
