"""Trace-level audit of the port's hot steps, driven by
``apex_tpu_torch.analysis``: the twins of tests/test_step_graph_audit.py.

The same rules over the same registry as the CI gate
(tests/ci/graph_lint_torch.py) and the CLI (``python -m
apex_tpu_torch.analysis``): the clean port lints clean.  The multi-rank
entries are traced once for the file on 8 gloo ranks (suite ``analysis``
of tests/torch_dist_worker.py); the engines here.  Each collective census
is also held against the JAX package's own plans and expectation folds
for the same model: the port's step runs one fp32 scalar all-reduce (the
loss average) where the JAX step runs two (it also psums the axis size),
and cuts a chunked flat bucket into one all-reduce a chunk where the JAX
step runs one psum over the stacked chunks; nothing else differs.
"""

from collections import Counter

import numpy as np
import pytest

import jax

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu import parallel as jparallel
from apex_tpu.analysis.entry_points import \
    _zero_collective_expectations as jzero_expectations

from apex_tpu_torch import analysis
from apex_tpu_torch.analysis import entry_points as E

import torch_dist_worker
import torch_threads  # noqa: F401  (one torch thread a process)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    names = [ep.name for ep in E.select() if ep.ranks > 1]
    out = torch_dist_worker.run("analysis", {"names": names},
                                tmp_path_factory.mktemp("audit"),
                                world=8)[0]
    E.install(out["entries"])
    return names


def _findings(name, rules=None):
    return analysis.analyze_entry_point(analysis.get(name), rules=rules)


def _assert_clean(name, rules=None):
    found = _findings(name, rules=rules)
    assert not found, "\n".join(str(f) for f in found)


def _graph(name):
    return analysis.get(name).graph()


def _census(name):
    nodes = analysis.collective_nodes(_graph(name))
    by: Counter = Counter()
    for n in nodes:
        by[n.prim] += analysis.node_payload_bytes(n)
    return Counter(n.prim for n in nodes), by


def _jax_params(opt_level="O2"):
    jm, _ = jamp.initialize(jmodels.resnet18(num_classes=10),
                            joptim.FusedAdam(1e-3), opt_level=opt_level,
                            verbosity=0)
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.eval_shape(jm.cast_params, params)


def _port_view(exp, plan=(), scalars=1, scalar_bytes=4):
    """The JAX package's expectation as the port's step runs it: one
    fp32 scalar all-reduce fewer (``scalars`` dropped, ``scalar_bytes``
    each), and each chunked flat bucket as one all-reduce a chunk."""
    counts = dict(exp["counts"])
    by = dict(exp["payload_bytes_by_primitive"])
    counts["psum"] -= scalars
    by["psum"] -= scalars * scalar_bytes
    counts["psum"] += sum(b["chunks"] - 1 for b in plan
                          if b["topology"] == "flat" and b["chunks"] > 1)
    return ({k: v for k, v in counts.items() if v},
            {k: v for k, v in by.items() if v},
            exp["payload_bytes"] - scalars * scalar_bytes)


def _assert_census(name, jexp, jplan=(), scalars=1, scalar_bytes=4):
    counts, by = _census(name)
    want_counts, want_by, want_total = _port_view(jexp, jplan, scalars,
                                                  scalar_bytes)
    assert dict(counts) == want_counts, name
    assert dict(by) == want_by, name
    assert sum(by.values()) == want_total, name


# -- amp dtype policy ---------------------------------------------------------

def test_o2_step_convs_all_bf16(registry):
    """Every convolution of the O2 step (20 forward, 20 backward nodes)
    takes bf16 operands; the rule's 40-conv floor keeps it non-vacuous."""
    _assert_clean("ddp_resnet18_o2", rules=["amp-dtype"])
    assert len(analysis.conv_nodes(_graph("ddp_resnet18_o2"))) >= 40


@pytest.mark.parametrize("lvl", ["o0", "o1", "o3"])
def test_other_opt_levels_match_policy(registry, lvl):
    _assert_clean(f"ddp_resnet18_{lvl}", rules=["amp-dtype"])


# -- layout ---------------------------------------------------------------

def test_o2_nhwc_step_transpose_free(registry):
    _assert_clean("ddp_resnet18_o2_nhwc", rules=["layout"])


def test_o2_s2d_nhwc_step_convs_bf16_and_transpose_free(registry):
    _assert_clean("ddp_resnet18_o2_nhwc_s2d", rules=["layout", "amp-dtype"])
    ep = analysis.get("ddp_resnet18_o2_nhwc_s2d")
    six_d = [n for n in analysis.transpose_nodes(
        ep.graph(), ep.expect["layout"]["min_activation_elems"])
        if n.inputs[0].ndim == 6]
    assert len(six_d) <= 1


# -- telemetry ------------------------------------------------------------

def test_telemetry_step_adds_zero_host_transfers(registry):
    _assert_clean("ddp_resnet18_o2_telemetry", rules=["host-transfer",
                                                      "donation"])
    _assert_clean("ddp_resnet18_o2", rules=["host-transfer"])
    assert len(analysis.conv_nodes(_graph("ddp_resnet18_o2_telemetry"))) \
        == len(analysis.conv_nodes(_graph("ddp_resnet18_o2")))


# -- numerics ---------------------------------------------------------------

def test_numerics_step_zero_host_transfers_and_plan_exact_collectives(
        registry):
    _assert_clean("ddp_resnet18_o2_numerics",
                  rules=["numerics", "host-transfer", "collective"])
    got, by = _census("ddp_resnet18_o2_numerics")
    base, base_by = _census("ddp_resnet18_o2")
    assert got["psum"] == base["psum"] + 1
    assert analysis.host_transfer_nodes(
        _graph("ddp_resnet18_o2_numerics")) == []
    want = analysis.get("ddp_resnet18_o2_numerics").expect["numerics"]
    assert sum(by.values()) - sum(base_by.values()) == \
        want["extra_payload_bytes"]
    assert len(analysis.conv_nodes(_graph("ddp_resnet18_o2_numerics"))) \
        == len(analysis.conv_nodes(_graph("ddp_resnet18_o2")))


def test_numerics_disabled_step_is_byte_identical(registry):
    _assert_clean("ddp_resnet18_o2_numerics_off", rules=["numerics"])
    assert _graph("ddp_resnet18_o2_numerics_off").text == \
        _graph("ddp_resnet18_o2").text


def test_supervised_step_is_byte_identical_both_ways(registry):
    base = _graph("ddp_resnet18_o2")
    for name in ("ddp_resnet18_o2_supervised",
                 "ddp_resnet18_o2_supervised_off"):
        _assert_clean(name, rules=["supervisor", "host-transfer",
                                   "collective"])
        assert _graph(name).text == base.text, name
        assert analysis.host_transfer_nodes(_graph(name)) == []


# -- collective accounting, held against the JAX package's plans ------------

def test_ddp_collective_accounting(registry):
    """The O2 step's census: the fp32 BatchNorm bucket, the chunked bf16
    bucket (two chunks) and the loss average, the wire bytes to the byte;
    and the JAX plan's expectations for the same resnet18, read as the
    port runs them."""
    _assert_clean("ddp_resnet18_o2", rules=["collective"])
    want = analysis.get("ddp_resnet18_o2").expect["collectives"]
    assert want["counts"]["psum"] == 4        # 1 + 2 chunks + the loss
    jplan = jparallel.allreduce_comm_plan(_jax_params(), world=8, nproc=1)
    jexp = jparallel.plan_collective_expectations(
        jplan, extra_psums=2, extra_psum_bytes=8)
    assert jexp["counts"]["psum"] == 4        # the JAX step: 2 buckets + 2
    _assert_census("ddp_resnet18_o2", jexp, jplan)
    counts, by = _census("ddp_resnet18_o2")
    assert sum(by.values()) == want["payload_bytes"]


@pytest.mark.parametrize("name,ici,world,compress", [
    ("ddp_resnet18_o2_hier", 4, 8, False),
    ("ddp_resnet18_o2_hier_bf16", 4, 8, True),
    ("ddp_resnet18_o2_hier_world4", 2, 4, False)])
def test_hier_ddp_collective_accounting(registry, name, ici, world,
                                        compress):
    """Per grad bucket one in-node reduce-scatter, the cross-node reduce
    of the 1/ici shard (an all-reduce, or a bf16 all-gather compressed)
    and the in-node all-gather back: the JAX plan's census at the same
    world and node width (the shrunk world's too), the cross-node bytes
    exactly 1/ici of the bucket."""
    _assert_clean(name, rules=["collective", "resharding-census"])
    jplan = jparallel.allreduce_comm_plan(
        _jax_params(), comm_topology="hierarchical", ici_size=ici,
        allreduce_compress_bf16=compress, world=world, nproc=1)
    jexp = jparallel.plan_collective_expectations(jplan, extra_psums=2,
                                                  extra_psum_bytes=8)
    _assert_census(name, jexp, jplan)
    counts, by = _census(name)
    nb = counts["reduce_scatter"]
    assert nb >= 1
    if compress:
        assert counts["psum"] == 1 and counts["all_gather"] == 2 * nb
    else:
        assert counts["all_gather"] == nb and counts["psum"] == nb + 1
        assert (by["psum"] - 4) * ici == by["reduce_scatter"]
    groups = Counter(len(n.attrs["group"])
                     for n in analysis.collective_nodes(_graph(name)))
    assert set(groups) <= {ici, world // ici, world}


def test_tp_collective_accounting(registry):
    """DP x TP: one row-parallel forward all-reduce over the model group
    plus the DDP buckets of the local shards over the data group — the
    JAX plan over the same local shapes, its axis-size psum aside."""
    _assert_clean("tp_mlp_train_step")
    g = _graph("tp_mlp_train_step")
    local = {f.name.split(".", 1)[1]: f.before for f in g.state}
    jtree = {n: jax.ShapeDtypeStruct(m.shape, np.float32)
             for n, m in local.items()}
    jplan = jparallel.allreduce_comm_plan(jtree)
    act = 4 * 8 * 4                      # (B/2, 8) fp32 rows a rank
    jexp = jparallel.plan_collective_expectations(
        jplan, extra_psums=2, extra_psum_bytes=act + 4)
    _assert_census("tp_mlp_train_step", jexp, jplan)
    groups = sorted(len(n.attrs["group"])
                    for n in analysis.collective_nodes(g))
    assert groups == [2] * len(jplan) + [4]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_collective_accounting(registry, stage):
    """The ZeRO steps' census is the JAX package's own fold of
    ``zero_update_comm_plan`` (its grad-norm all-reduce, loss average and
    overflow MAX included), collective for collective and byte for byte."""
    name = f"ddp_resnet18_o2_zero{stage}"
    _assert_clean(name, rules=["collective", "resharding-census",
                               "sharding", "memory-budget"])
    jplan = jparallel.zero_update_comm_plan(
        _jax_params(), zero_stage=stage, world=8,
        ici_size=4 if stage >= 2 else None)
    jexp = jzero_expectations(jplan, jparallel)
    counts, by = _census(name)
    assert dict(counts) == jexp["counts"]
    assert dict(by) == jexp["payload_bytes_by_primitive"]
    assert sum(by.values()) == jexp["payload_bytes"]


# -- transformer families ----------------------------------------------------

def test_gpt_o2_step_large_dots_bf16(registry):
    _assert_clean("gpt_o2_train_step", rules=["amp-dtype"])


def test_llama_o2_step_large_dots_bf16(registry):
    _assert_clean("llama_o2_train_step", rules=["amp-dtype"])


# -- serving ----------------------------------------------------------------

def test_serving_window_step_zero_host_transfers():
    _assert_clean("engine_step_k", rules=["host-transfer"])


def test_serving_window_step_cache_buffers_donated():
    """The window's mutated state — ids, the KV cache, the sampling
    streams — is held in place, every cache leaf and the ids written in
    place; the blocklisted length vector is written in place, never
    rebound; the admission's cache row is written in place too."""
    _assert_clean("engine_step_k", rules=["donation"])
    _assert_clean("engine_prefill_slot", rules=["donation"])
    g = _graph("engine_step_k")
    n_cache = sum(1 for f in g.state if f.arg == "cache")
    assert analysis.aliased_output_count(g) >= n_cache + 1
    by = {f.name: f for f in g.state}
    assert by["cur_len"].in_place and not by["cur_len"].rebound
    assert all(f.in_place for f in g.state if f.arg == "cache")
    donated, partial = analysis.donated_arg_names(g)
    assert {"ids", "cache", "cur_len"} <= set(donated) and partial == []
    gp = _graph("engine_prefill_slot")
    assert all(f.in_place for f in gp.state if f.arg == "cache")


def test_seq2seq_window_step_donation():
    _assert_clean("seq2seq_step_k")


# -- the acceptance pin ----------------------------------------------------

def test_full_registry_zero_findings(registry):
    """The whole registry, every rule: zero findings (the multi-rank
    entries from this file's ranks, the engines traced here)."""
    findings = analysis.analyze()
    assert not findings, "\n".join(str(f) for f in findings)
    assert len(analysis.ENTRY_POINTS) == 29


def test_serving_window_host_syncs_per_token():
    """With window=K the engine pays <= 1/K host syncs per generated
    token, as the JAX package's."""
    from apex_tpu_torch import serving
    eng = serving.Engine(E._tiny_gpt(), slots=2, buf_len=32, window=8)
    prompt = list(np.random.RandomState(5).randint(0, 64, 4))
    rid = eng.add_request(prompt, max_new_tokens=16)
    while eng.live():
        eng.step()
    s = eng.stats()
    assert len(eng.result(rid)) == 16
    assert s["host_syncs"] == 2
    assert s["host_syncs"] / s["tokens_generated"] <= 1 / 8
    assert s["tokens_per_sync"] == 8.0
    assert s["window"] == 8
    assert s["decode_steps"] == 2
    assert eng.metrics.counter("engine_host_syncs_total").value == 2
    assert eng.metrics.gauge("engine_window_size").value == 8.0
