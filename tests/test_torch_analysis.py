"""Mutation tests for apex_tpu_torch.analysis, the twins of
tests/test_analysis.py: every rule must FLAG its deliberately broken
step and PASS its fixed twin — no rule may pass vacuously.

Steps without collectives are recorded here, on the CPU.  Steps with
collectives (the collective, numerics, supervisor, sharding and
resharding-census rules, and the real DDP/ZeRO entry points the ledger
tests read) are recorded once for the file on 8 gloo ranks (suite
``analysis`` of tests/torch_dist_worker.py), rank 0's traces coming
back; the rules then run here.  Where the JAX test asserts a count the
port records differently (a loop the port runs unrolled, the JAX step's
axis-size psum the port does not need) the test says so.  The JAX
package's sharding tests are red under jax 0.9.0, so the port is held
to the values they assert, not to their outputs.
"""

import json

import pytest
import torch

import jax.numpy as jnp

from apex_tpu import parallel as jparallel

from apex_tpu_torch import analysis, parallel, serving
from apex_tpu_torch.analysis import EntryPoint, Graph, entry_points as E
from apex_tpu_torch.observability import exporters

import torch_dist_worker
import torch_threads  # noqa: F401  (one torch thread a process)

# the real entries the ledger, interleaving and CLI tests read
_RANK_ENTRIES = ("ddp_resnet18_o2", "ddp_resnet18_o2_zero3",
                 "ddp_mlp_overlap_hier", "ddp_mlp_overlap_zero2",
                 "ddp_mlp_overlap_flat")


@pytest.fixture(scope="module")
def mutants(tmp_path_factory):
    out = torch_dist_worker.run(
        "analysis", {"names": list(_RANK_ENTRIES), "mutants": True},
        tmp_path_factory.mktemp("analysis"), world=8)[0]
    E.install(out["entries"])
    return out["mutants"]


def _ep(name, expect=None, trace=None, recorded=None):
    return EntryPoint(name, lambda ep: Graph(trace=trace,
                                             recorded=recorded),
                      expect=expect)


def _run(ep, rule):
    return analysis.analyze_entry_point(ep, rules=[rule])


def _traced(fn, *args, **kw):
    return lambda: analysis.trace_call(fn, *args, **kw)


# -- host-transfer rule ---------------------------------------------------

def test_host_transfer_rule_flags_seeded_callback():
    """A value read back inside a K-tick window (``.item()`` each tick) is
    the per-tick host sync the serving window exists to kill.  The port
    records the window's ticks unrolled: 4 ticks, 4 reads (the JAX scan
    body counts once)."""
    def window(x):
        for _ in range(4):
            x = x + float(x.sum())
        return x

    ep = _ep("mutant_host_sync", trace=_traced(window, torch.ones(8)))
    found = _run(ep, "host-transfer")
    assert len(found) == 1
    assert found[0].severity == "error"
    assert found[0].detail["primitive"] == "_local_scalar_dense"
    assert found[0].detail["count"] == 4
    assert found[0].detail["where"][0].startswith("test_torch_analysis.py:")

    clean = _ep("clean_host_sync",
                trace=_traced(lambda x: [x + 1.0 for _ in range(4)],
                              torch.ones(8)))
    assert _run(clean, "host-transfer") == []


def test_host_transfer_rule_optout():
    ep = _ep("optout", expect={"allow_host_transfers": True})
    assert not analysis.get_rule("host-transfer").applies(ep)


@pytest.mark.parametrize("sync", ["item", "cpu", "tolist", "nonzero",
                                  "synchronize", "to", "to_device_kw",
                                  "to_device_dtype", "copy_"])
def test_host_transfer_rule_flags_each_host_sync_in_make_step(sync):
    """Each host sync inside a ``make_step`` body is flagged on the CPU,
    those a CPU tensor's copy to the CPU dispatches nothing for too:
    ``.cpu()``, ``.to("cpu")`` in each spelling, and a ``copy_`` into a
    host buffer the step made.  A read of a tensor made from host data
    (``torch.tensor(x)``), a ``.to(dtype)`` and a copy into a buffer on
    the step's device are not one."""
    lin = torch.nn.Linear(4, 4, device="cpu")

    def step(x):
        y = lin(x)
        if sync == "item":
            y = y * y.sum().item()
        elif sync == "cpu":
            y = y + y.cpu()
        elif sync == "tolist":
            y = y + len(y.tolist())
        elif sync == "nonzero":
            y = y[torch.nonzero(y > 0, as_tuple=True)]
        elif sync == "to":
            y = y + y.to("cpu")
        elif sync == "to_device_kw":
            y = y + y.to(device="cpu")
        elif sync == "to_device_dtype":
            y = y + y.to(torch.device("cpu"), torch.float64).float()
        elif sync == "copy_":
            host = torch.empty(2, 4)
            host.copy_(y)
            y = y * 2.0
        else:
            torch.cuda.synchronize()
        y = y + torch.empty_like(y).copy_(y).to(y.device).to(
            torch.float64).float()
        return y.sum() * float(torch.tensor(0.5))

    train = parallel.make_step(step, lin)
    ep = _ep(f"mutant_{sync}", trace=_traced(train, torch.ones(2, 4)))
    found = _run(ep, "host-transfer")
    prim = {"item": "_local_scalar_dense", "to": "cpu", "to_device_kw":
            "cpu", "to_device_dtype": "cpu", "copy_": "cpu"}.get(sync, sync)
    assert [f.detail["primitive"] for f in found] == [prim]


def test_trace_records_only_the_calling_thread():
    """A sync or a kernel launch that another thread makes while a call
    is traced (a serving worker, a server) is not the step's: the trace
    holds the calling thread's own launch and no host node."""
    import threading
    from apex_tpu_torch import ops
    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait()
        torch.cuda.synchronize()
        ops.multi_tensor_l2norm(torch.ones(8))
        done.set()

    def step(x):
        ready.set()
        done.wait(10.0)
        return ops.multi_tensor_l2norm(x)

    worker = threading.Thread(target=other)
    worker.start()
    trace = analysis.trace_call(step, torch.ones(16), cost=False)
    worker.join()
    assert done.is_set()
    kernels = [n for n in trace.nodes if n.kind == "kernel"]
    assert [n.inputs[0].shape for n in kernels] == [(16,)]
    assert not [n for n in trace.nodes if n.kind == "host"]


# -- donation rule --------------------------------------------------------

class _Slots:
    """A window's state: ids, a two-layer KV cache, the length vector."""

    def __init__(self, shared=False):
        self.ids = torch.zeros(2, 4, dtype=torch.int64)
        self.cur_len = torch.zeros(2, dtype=torch.int64)
        k = torch.zeros(2, 8)
        self.cache = {"0": k, "1": k if shared else torch.zeros(2, 8)}
        self.limit = torch.full((2,), 4, dtype=torch.int64)

    def state(self):
        return {"ids": self.ids, "cache": self.cache,
                "cur_len": self.cur_len, "limit": self.limit}


def _donation_ep(name, step, slots, expect):
    return _ep(name, expect={"donation": expect},
               trace=_traced(step, state=slots.state))


def _bump_in_place(s):
    def step():
        s.ids.add_(1)
        for c in s.cache.values():
            c.add_(1.0)
        s.cur_len.add_(1)
    return step


def _bump_rebound(s, what=("ids", "cache")):
    def step():
        if "ids" in what:
            s.ids = s.ids + 1
        if "cache" in what:
            s.cache = {k: c + 1.0 for k, c in s.cache.items()}
        if "cur_len" in what:
            s.cur_len = s.cur_len + 1
        else:
            s.cur_len.add_(1)
    return step


def test_donation_rule_flags_unaliased_cache():
    """A window that promises its KV cache in place but rebinds it
    (functional update): a captured graph would keep replaying on the
    old buffer."""
    s = _Slots()
    broken = _donation_ep("mutant_undonated", _bump_rebound(s), s,
                          {"expect_donated": ("ids", "cache")})
    found = _run(broken, "donation")
    assert {f.detail.get("argument") for f in found} == {"ids", "cache",
                                                         None}
    assert all(f.severity == "error" for f in found)
    s = _Slots()
    fixed = _donation_ep("fixed_donated", _bump_in_place(s), s,
                         {"expect_donated": ("ids", "cache")})
    assert _run(fixed, "donation") == []


def test_donation_rule_flags_blocklisted_cur_len():
    """The per-slot length vectors (serving.DONATION_BLOCKLIST) are the
    state the host's admission writes between windows: a step that
    rebinds one is flagged even when the expectation never names it."""
    assert "cur_len" in serving.DONATION_BLOCKLIST
    assert "n_new" in serving.DONATION_BLOCKLIST
    s = _Slots()
    broken = _donation_ep("mutant_blocklist",
                          _bump_rebound(s, what=("cur_len",)), s,
                          {"expect_donated": ()})
    found = _run(broken, "donation")
    assert len(found) == 1
    assert found[0].detail == {"argument": "cur_len", "blocklisted": True}
    s = _Slots()
    fixed = _donation_ep("fixed_blocklist", _bump_in_place(s), s,
                         {"expect_donated": ()})
    assert _run(fixed, "donation") == []


def test_donation_rule_flags_undonated_block_pool():
    """The paged engine's block pool is THE resident: a window that writes
    a fresh pool and rebinds it flags (and the real window lints
    clean)."""
    ep = E.get("paged_step_k")
    eng = E._tiny_paged_engine()
    eng._stage_pending()
    window = eng._windows[True].fn

    def rebinding():
        window()
        eng.pool = {k: {n: t.clone() for n, t in layer.items()}
                    for k, layer in eng.pool.items()}

    expect = dict(ep.expect["donation"]) if "donation" in ep.expect \
        else None
    if expect is None:
        ep.graph()
        expect = dict(ep.expect["donation"])
    broken = _ep("mutant_undonated_pool", expect={"donation": expect},
                 trace=_traced(rebinding, state=E._paged_state(eng)))
    found = _run(broken, "donation")
    assert any(f.detail.get("argument") == "pool" for f in found)
    assert _run(ep, "donation") == []


def test_donation_rule_flags_rebound_state_in_make_step():
    """A ``make_step`` body that rebinds a parameter (``p.data = ...``) or
    an optimizer moment: the captured graph would keep the old address.
    The real O2 step over the same model and optimizer lints clean."""
    from apex_tpu_torch import amp, optimizers
    model, opt = amp.initialize(torch.nn.Linear(8, 8),
                                optimizers.FusedAdam(lr=1e-3),
                                opt_level="O2", verbosity=0)
    x = torch.ones(4, 8)

    def step(b):
        loss, grads = amp.scaled_grad(lambda: model(b).float().sum(), opt)
        opt.step(grads)
        return loss

    def rebinding(b):
        loss = step(b)
        model.weight.data = model.weight.data.clone()
        return loss

    expect = {"donation": {"expect_donated": ("params", "opt")}}
    state = E._training_state(model, opt)
    clean = _ep("fixed_make_step", expect=expect,
                trace=_traced(parallel.make_step(step, model), x,
                              state=state))
    assert _run(clean, "donation") == []
    broken = _ep("mutant_rebound_param", expect=expect,
                 trace=_traced(parallel.make_step(rebinding, model), x,
                               state=state))
    found = _run(broken, "donation")
    (partial,) = [f for f in found if f.detail.get("argument") == "params"]
    assert "partially donated" in partial.message
    assert "model.weight" not in partial.message and \
        "params.weight" in partial.message
    # and the leaf is no longer written in place: one short of the floor
    (short,) = [f for f in found if "aliased" in f.detail]
    assert short.detail["aliased"] == short.detail["requested"] - 1


def test_donation_rule_flags_double_donation():
    """Two cache layers that share one zeros buffer, both written: one
    buffer, two pieces of state."""
    s = _Slots(shared=True)
    broken = _donation_ep("mutant_double", _bump_in_place(s), s,
                          {"expect_donated": ("ids", "cache")})
    found = _run(broken, "donation")
    dup = [f for f in found if "duplicate" in f.detail]
    assert len(dup) == 1
    assert "cache.1 shares a buffer with cache.0" in dup[0].detail[
        "duplicate"]
    s = _Slots()
    fixed = _donation_ep("fixed_double", _bump_in_place(s), s,
                         {"expect_donated": ("ids", "cache")})
    assert _run(fixed, "donation") == []


def test_donation_rule_flags_forbidden_argument():
    """An entry point's read-only state (``forbid_donated``) written by
    the step flags."""
    s = _Slots()
    base = _bump_in_place(s)

    def writes_limit():
        base()
        s.limit.sub_(1)

    broken = _donation_ep("mutant_forbidden", writes_limit, s,
                          {"expect_donated": ("ids",),
                           "forbid_donated": ("limit",)})
    found = _run(broken, "donation")
    assert len(found) == 1
    assert found[0].detail == {"argument": "limit", "blocklisted": False}
    s = _Slots()
    fixed = _donation_ep("fixed_forbidden", _bump_in_place(s), s,
                         {"expect_donated": ("ids",),
                          "forbid_donated": ("limit",)})
    assert _run(fixed, "donation") == []


def test_donation_rule_counts_a_kernel_read_as_no_write():
    """A state leaf that a kernel only reads (LayerNorm's weight, read by
    ``layer_norm_fwd``) is not updated by the step: promised as donated
    it flags, and as read-only state it passes.  Only the operands a
    wrapper declares it writes (``writes``) count as written."""
    from apex_tpu_torch import ops
    x2 = torch.ones(4, 16)
    ln = {"w": torch.ones(16), "b": torch.zeros(16)}
    assert ops.layer_norm_fwd.writes == ()

    def step():
        return ops.layer_norm_fwd(x2, ln["w"], ln["b"], 1e-5)[0]

    def ep(name, expect):
        return _ep(name, expect={"donation": expect},
                   trace=_traced(step, state=lambda: {"ln": ln}))
    found = _run(ep("mutant_read_only", {"expect_donated": ("ln",)}),
                 "donation")
    assert [f.detail for f in found] == [{"aliased": 0, "requested": 2}]
    assert _run(ep("fixed_read_only", {"expect_donated": (),
                                       "forbid_donated": ("ln",)}),
                "donation") == []


# -- amp dtype rule --------------------------------------------------------

def _conv_step(dtype, w_dtype=None):
    w = torch.randn(8, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 8, 8).to(dtype)
    w = w.to(w_dtype or dtype).requires_grad_()

    def step():
        y = torch.nn.functional.conv2d(x, w, padding=1)
        y.float().sum().backward()
    return step


def test_amp_rule_flags_forced_fp32_conv():
    expect = {"amp": {"opt_level": "O2", "conv_dtype": "bfloat16",
                      "min_convs": 2}}
    broken = _ep("mutant_fp32_conv", expect=expect,
                 trace=_traced(_conv_step(torch.float32)))
    found = _run(broken, "amp-dtype")
    assert len(found) == 2           # the forward and the backward node
    assert {(f.detail["lhs"], f.detail["rhs"]) for f in found} == \
        {("float32", "float32")}
    fixed = _ep("fixed_bf16_conv", expect=expect,
                trace=_traced(_conv_step(torch.bfloat16)))
    assert _run(fixed, "amp-dtype") == []


def test_amp_rule_vacuity_guard():
    ep = _ep("mutant_no_convs",
             expect={"amp": {"opt_level": "O2", "conv_dtype": "bfloat16",
                             "min_convs": 40}},
             trace=_traced(lambda: torch.ones(3) * 2))
    found = _run(ep, "amp-dtype")
    assert len(found) == 1 and "vacuous" in found[0].message


def test_amp_rule_flags_fp32_dot():
    w = torch.ones(64, 64)

    def mm(dtype):
        return lambda: torch.ones(32, 64, dtype=dtype) @ w.to(dtype)

    expect = {"amp": {"opt_level": "O2", "dot_dtype": "bfloat16",
                      "min_dots": 1}}
    found = _run(_ep("mutant_fp32_dot", expect=expect,
                     trace=_traced(mm(torch.float32))), "amp-dtype")
    assert len(found) == 1
    assert found[0].detail["operands"] == ["float32", "float32"]
    assert _run(_ep("fixed_bf16_dot", expect=expect,
                    trace=_traced(mm(torch.bfloat16))), "amp-dtype") == []


# -- layout rule -----------------------------------------------------------

def test_layout_rule_flags_injected_transpose():
    """A channels-last step that materializes an NCHW copy of an
    activation (``permute(...).contiguous()``) pays a relayout each
    step."""
    x = torch.randn(2, 32, 32, 16)
    expect = {"layout": {"min_activation_elems": 12288}}

    def leaky():
        return (x.permute(0, 3, 1, 2).contiguous() * 2).sum()

    found = _run(_ep("mutant_transpose", expect=expect,
                     trace=_traced(leaky)), "layout")
    assert len(found) == 1
    assert found[0].detail["shape"] == [2, 16, 32, 32]
    assert found[0].detail["permutation"] == [0, 2, 3, 1]
    # a permute alone is a view: no copy, no finding
    assert _run(_ep("fixed_transpose", expect=expect,
                    trace=_traced(lambda: (x.permute(0, 3, 1, 2) * 2)
                                  .sum())), "layout") == []


def test_layout_rule_6d_budget():
    """space_to_depth's 6-D block rearrange is the one budgeted
    relayout: within budget passes, twice flags."""
    from apex_tpu_torch.nn.functional import space_to_depth
    x = torch.randn(4, 64, 64, 3)
    once = _traced(lambda: space_to_depth(x, 2, "NHWC"))
    twice = _traced(lambda: (space_to_depth(x, 2, "NHWC"),
                             space_to_depth(x * 2, 2, "NHWC")))
    budget = {"layout": {"min_activation_elems": 12288,
                         "allowed_6d_rearranges": 1}}
    assert _run(_ep("fixed_s2d", expect=budget, trace=once),
                "layout") == []
    found = _run(_ep("mutant_s2d_twice", expect=budget, trace=twice),
                 "layout")
    assert len(found) == 1
    assert (found[0].detail["count"], found[0].detail["budget"]) == (2, 1)


# -- flop-accounting rule --------------------------------------------------

def _mm_chain(dtype, n=64):
    w = torch.ones(n, n, dtype=dtype)
    return lambda: ((torch.ones(n, n, dtype=dtype) @ w) @ w).sum()


def test_flop_rule_flags_unexplained_delta():
    """Two 64^3 matmuls are 2 * 2 * 64^3 flops plus the sum's 4095 adds;
    an expectation of half that flags, the honest count passes."""
    want = 2 * 2 * 64 ** 3 + 64 * 64 - 1
    ok = _ep("fixed_flops", expect={"flops": {"expected_flops": want,
                                              "rtol": 0.01}},
             trace=_traced(_mm_chain(torch.bfloat16)))
    assert _run(ok, "flop-accounting") == []
    bad = _ep("mutant_flops", expect={"flops": {"expected_flops": want / 2,
                                                "rtol": 0.05}},
              trace=_traced(_mm_chain(torch.bfloat16)))
    found = _run(bad, "flop-accounting")
    assert len(found) == 1 and "unexplained FLOP delta" in found[0].message
    assert found[0].detail["flops"] == want
    zero = _ep("mutant_zero_flops", expect={"flops": {"expected_flops": 0}},
               trace=_traced(_mm_chain(torch.bfloat16)))
    assert "must be > 0" in _run(zero, "flop-accounting")[0].message


def test_flop_rule_flags_fp32_matmul_fraction():
    expect = {"flops": {"max_fp32_matmul_fraction": 0.02,
                        "min_matmul_flops": 1e5}}
    found = _run(_ep("mutant_fp32_flops", expect=expect,
                     trace=_traced(_mm_chain(torch.float32))),
                 "flop-accounting")
    assert len(found) == 1
    assert found[0].detail["fp32_matmul_fraction"] == 1.0
    assert _run(_ep("fixed_bf16_flops", expect=expect,
                    trace=_traced(_mm_chain(torch.bfloat16))),
                "flop-accounting") == []


def test_flop_rule_vacuity_guard():
    ep = _ep("mutant_no_matmuls",
             expect={"flops": {"max_fp32_matmul_fraction": 0.02,
                               "min_matmul_flops": 1e6}},
             trace=_traced(lambda: torch.ones(8) * 2))
    found = _run(ep, "flop-accounting")
    assert len(found) == 1 and "vacuous" in found[0].message


# -- memory-budget rule ----------------------------------------------------

def test_memory_rule_flags_seeded_over_budget():
    x = torch.ones(1024)
    trace = _traced(lambda: torch.cat([x, x, x]).sum())
    # argument 4 KB + a 12 KB temp: a 16 KB peak
    found = _run(_ep("mutant_over_budget",
                     expect={"memory": {"budget_bytes": 8 * 1024}},
                     trace=trace), "memory-budget")
    assert len(found) == 1
    assert found[0].detail["peak_live_bytes"] > 8 * 1024
    assert found[0].severity == "error"
    assert _run(_ep("fixed_over_budget",
                    expect={"memory": {"budget_bytes": 32 * 1024}},
                    trace=trace), "memory-budget") == []


def test_memory_rule_flags_live_to_argument_ratio():
    x = torch.ones(1024)
    found = _run(_ep("mutant_ratio",
                     expect={"memory": {"max_live_to_argument_ratio": 3.0}},
                     trace=_traced(lambda: torch.cat([x, x, x, x]).sum())),
                 "memory-budget")
    assert len(found) == 1 and found[0].detail["ratio"] > 3.0
    assert _run(_ep("fixed_ratio",
                    expect={"memory": {"max_live_to_argument_ratio": 3.0}},
                    trace=_traced(lambda: (x * 2).sum())),
                "memory-budget") == []


def test_memory_rule_flags_fp32_upcast_under_o2():
    """The same matmul pipeline with its operands upcast to fp32 doubles
    the fp32 temp bytes and flags; the bf16 pipeline passes under the
    same budget."""
    from apex_tpu_torch.observability import memory as obsmem
    w = torch.ones(256, 256, dtype=torch.bfloat16)
    x = torch.ones(64, 256, dtype=torch.bfloat16)

    def clean():
        h = torch.relu(x @ w)
        return (h @ w).float().sum()

    def upcast():
        h = torch.relu(x.float() @ w.float())
        return (h @ w.float()).sum()

    clean_f32 = obsmem.graph_live_bytes(
        Graph(recorded=analysis.trace_call(clean)).fx())[
            "peak_temp_bytes_by_dtype"].get("float32", 0)
    budget = {"memory": {"temp_budget_bytes_by_dtype":
                         {"float32": 2 * max(clean_f32, 1)}}}
    found = _run(_ep("mutant_fp32_upcast", expect=dict(budget),
                     trace=_traced(upcast)), "memory-budget")
    assert len(found) == 1
    assert found[0].detail["dtype"] == "float32"
    assert found[0].detail["peak_temp_bytes"] > \
        found[0].detail["budget_bytes"]
    assert _run(_ep("fixed_bf16_pipeline", expect=dict(budget),
                    trace=_traced(clean)), "memory-budget") == []


# -- collective accounting rule ---------------------------------------------

def _rec(mutants, name, expect=None):
    return _ep(name, expect=expect, recorded=mutants[name])


def test_collective_rule_flags_wrong_count_and_payload(mutants):
    expect = {"collectives": {"counts": {"psum": 2},
                              "payload_bytes": 2 * 4 * 8 * 4}}
    found = _run(_rec(mutants, "psum1", expect), "collective")
    assert {f.detail.get("primitive", "payload") for f in found} == \
        {"psum", "payload"}
    count = [f for f in found if "primitive" in f.detail][0]
    assert (count.detail["expected"], count.detail["got"]) == (2, 1)
    assert _run(_rec(mutants, "psum2", expect), "collective") == []


def test_collective_rule_flags_unbudgeted_collective(mutants):
    found = _run(_rec(mutants, "all_gather",
                      {"collectives": {"counts": {}}}), "collective")
    assert len(found) == 1
    assert found[0].detail["primitive"] == "all_gather"


def _overlap_expect():
    sched = parallel.overlap_comm_schedule(
        [{"w": torch.empty(32, 32, device="meta"),
          "b": torch.empty(32, device="meta")}] * 4,
        comm_topology="hierarchical", ici_size=4, world=8, nproc=1,
        overlap=True)
    return {"collectives": parallel.overlap_collective_expectations(
        sched, extra_psums=1, extra_psum_bytes=4)}


def test_collective_rule_interleaving_mutation_both_ways(mutants):
    """The REAL staged step recorded with overlap=False (the same census
    and payloads, only the positions differ) flags under the
    overlap-derived expectations; the overlapped step lints clean."""
    expect = _overlap_expect()
    found = _run(_rec(mutants, "overlap_hier_off", dict(expect)),
                 "collective")
    assert len(found) == 1, found
    assert "reduce-after-backward schedule" in found[0].message
    assert found[0].detail["first_collective_eqn"] > \
        found[0].detail["last_matmul_eqn"]
    fixed = _ep("fixed_overlapped", expect=dict(expect),
                recorded=E.get("ddp_mlp_overlap_hier").graph().trace)
    assert _run(fixed, "collective") == []


def test_collective_rule_interleaving_vacuity_guards(mutants):
    no_coll = _ep("mutant_interleave_no_collective",
                  expect={"collectives": {
                      "counts": {}, "interleaving": {"min_payload_bytes":
                                                     64}}},
                  trace=_traced(lambda: torch.tanh(torch.ones(8, 8)
                                                   @ torch.ones(8, 8))))
    assert any("vacuous interleaving" in f.message
               for f in _run(no_coll, "collective"))
    no_mm = _rec(mutants, "psum1", {"collectives": {
        "counts": {"psum": 1}, "payload_bytes": 4 * 8 * 4,
        "interleaving": {"min_payload_bytes": 16}}})
    assert any("no conv/matmul" in f.message
               for f in _run(no_mm, "collective"))


def test_numerics_rule_flags_host_sync_extra_collective_and_residue(
        mutants):
    """An enabled instrumentation that reads a value back flags; one whose
    collective census exceeds baseline + the digest's planned delta
    flags; a disabled step that is not the baseline's graph flags as
    residue; the honest twins pass."""
    baseline = Graph(recorded=mutants["num_base"])
    enabled = {"baseline": baseline, "enabled": True,
               "extra_collectives": {"psum": 1}, "extra_payload_bytes": 4}
    assert _run(_rec(mutants, "num_on", {"numerics": enabled}),
                "numerics") == []
    found = _run(_rec(mutants, "num_sync", {"numerics": enabled}),
                 "numerics")
    assert any(f.detail.get("primitive") == "_local_scalar_dense"
               for f in found)
    found = _run(_rec(mutants, "num_extra", {"numerics": enabled}),
                 "numerics")
    assert any(f.detail.get("got") == 3 and f.detail.get("expected") == 2
               for f in found)
    assert any("payload" in f.message for f in found)
    off = {"baseline": baseline, "enabled": False}
    assert _run(_rec(mutants, "num_base", {"numerics": off}),
                "numerics") == []
    found = _run(_rec(mutants, "num_residue", {"numerics": off}),
                 "numerics")
    assert len(found) == 1 and "residue" in found[0].message


def test_supervisor_rule_flags_instrumented_step_both_ways(mutants):
    baseline = Graph(recorded=mutants["num_base"])
    for enabled in (True, False):
        expect = {"supervisor": {"baseline": baseline, "enabled": enabled}}
        assert _run(_rec(mutants, "num_base", expect), "supervisor") == []
        found = _run(_rec(mutants, "num_sync", expect), "supervisor")
        assert any(f.detail.get("primitive") == "_local_scalar_dense"
                   for f in found)
        assert any("residue" in f.message for f in found)
        found = _run(_rec(mutants, "num_residue", expect), "supervisor")
        assert len(found) == 1 and "residue" in found[0].message
    found = _run(_rec(mutants, "num_base",
                      {"supervisor": {"enabled": True}}), "supervisor")
    assert len(found) == 1 and "baseline" in found[0].message


def test_run_record_dispatch_in_mixed_stream():
    from apex_tpu_torch.observability import supervisor
    assert exporters.RUN_ANOMALY_KINDS == supervisor.ANOMALY_KINDS
    good = exporters.JsonlExporter.enrich({
        "kind": "run", "run": "r", "verdict": "ok",
        "observations": 3, "watermark": 2,
        "anomaly_counts": {k: 0 for k in exporters.RUN_ANOMALY_KINDS},
        "anomalies": []})
    bench = exporters.JsonlExporter.enrich({
        "metric": "m", "value": 1.0, "unit": "x", "backend": "cpu",
        "ndev": 8, "arch": "cpu"})
    assert exporters.validate_telemetry_jsonl(
        [json.dumps(good), json.dumps(bench)]) == []
    errs = exporters.validate_telemetry_jsonl(
        [json.dumps(dict(good, verdict="attention"))])
    assert any("inconsistent" in e for e in errs)


def test_numerics_record_dispatch_in_mixed_stream():
    good = exporters.JsonlExporter.enrich({
        "kind": "numerics", "metric": "mix", "steps": 1,
        "overflow_steps": 0,
        "layers": [{"name": "w", "nonfinite": 0, "abs_max": 1.0,
                    "grad_norm": 1.0, "underflow_fraction": 0.0}]})
    bench = exporters.JsonlExporter.enrich({
        "metric": "m", "value": 1.0, "unit": "x", "backend": "cpu",
        "ndev": 1, "arch": "cpu"})
    assert exporters.validate_telemetry_jsonl(
        [json.dumps(bench), json.dumps(good)]) == []
    errs = exporters.validate_telemetry_jsonl(
        [json.dumps(dict(good, overflow_steps=7))])
    assert errs and any("exceeds steps" in e for e in errs)


def _hier_plan(n=1024):
    return parallel.allreduce_comm_plan(
        {"w": torch.empty(n, device="meta")},
        comm_topology="hierarchical", ici_size=4, world=8)


def test_collective_rule_flags_full_size_dcn_psum(mutants):
    """A 'hierarchical' reduction that gathers BEFORE the cross-node
    reduce moves the full tensor across nodes: the counts match the plan
    exactly (one reduce-scatter, one all-reduce, one all-gather), only
    the per-primitive payload split catches it.  (The JAX mutant adds the
    axis-size psum the port does not need.)"""
    n = 1024
    expect = {"collectives": parallel.plan_collective_expectations(
        _hier_plan(n))}
    found = _run(_rec(mutants, "hier_fat_dcn", expect), "collective")
    assert found and not any("collective(s)" in f.message for f in found)
    psum_f = [f for f in found if f.detail.get("primitive") == "psum"
              and "payload" in f.message][0]
    assert psum_f.detail["payload_bytes"] == n * 4
    assert psum_f.detail["expected_bytes"] == n * 4 // 4
    assert _run(_rec(mutants, "hier_honest", expect), "collective") == []


def test_comm_plan_hierarchical_levels():
    """The port's plan is the JAX package's, level for level, and its
    fold is the JAX fold (the dtype name aside)."""
    from apex_tpu_torch.parallel import (allreduce_comm_plan,
                                         plan_collective_expectations)
    grads = {"w": torch.empty(1001, device="meta")}
    jgrads = {"w": jnp.zeros((1001,), jnp.float32)}
    for kw in ({}, dict(comm_topology="hierarchical", ici_size=4, world=8),
               dict(comm_topology="hierarchical", ici_size=4, world=8,
                    allreduce_compress_bf16=True)):
        assert allreduce_comm_plan(grads, **kw) == \
            jparallel.allreduce_comm_plan(jgrads, **kw)
    (h,) = allreduce_comm_plan(grads, comm_topology="hierarchical",
                               ici_size=4, world=8)
    assert h["eqns"] == {"reduce_scatter": 1, "psum": 1, "all_gather": 1}
    exp = plan_collective_expectations([h], extra_psums=2,
                                       extra_psum_bytes=8)
    assert exp == jparallel.plan_collective_expectations(
        jparallel.allreduce_comm_plan(jgrads, comm_topology="hierarchical",
                                      ici_size=4, world=8),
        extra_psums=2, extra_psum_bytes=8)
    assert exp["counts"] == {"reduce_scatter": 1, "psum": 3,
                             "all_gather": 1}
    with pytest.raises(ValueError, match="world"):
        allreduce_comm_plan(grads, comm_topology="hierarchical",
                            ici_size=4)
    with pytest.raises(ValueError, match="no inner level"):
        allreduce_comm_plan(grads, allreduce_compress_bf16=True)


def test_comm_plan_matches_traced_buckets(mutants):
    """The plan is the static twin of what the step sends: the honest
    hierarchical reduce's recorded collectives carry exactly the plan's
    per-primitive payloads, and the census equals the plan's."""
    plan = _hier_plan()
    trace = mutants["hier_honest"]
    got: dict = {}
    for n in analysis.collective_nodes(trace):
        got[n.prim] = got.get(n.prim, 0) + analysis.node_payload_bytes(n)
    assert got == plan[0]["eqn_payload_bytes"]
    assert sorted(n.prim for n in analysis.collective_nodes(trace)) == \
        sorted(p for p, k in plan[0]["eqns"].items() for _ in range(k))


# -- sharding rule (the ranks' digests) -------------------------------------

def test_sharding_rule_flags_divergent_output_claim_both_ways(mutants):
    """A state leaf written with rank-local values under a replicated
    claim is divergent (checked at run time, by the ranks' digests); the
    declared count ratchets both ways."""
    def expect(n):
        return {"sharding": {"mesh_axes": {"data": 8},
                             "divergent_outputs": n}}
    found = _run(_rec(mutants, "divergent", expect(0)), "sharding")
    assert len(found) == 1
    assert (found[0].detail["divergent"], found[0].detail["declared"]) == \
        (1, 0)
    assert _run(_rec(mutants, "divergent", expect(1)), "sharding") == []
    found = _run(_rec(mutants, "synced", expect(1)), "sharding")
    assert len(found) == 1
    assert "ratchet divergent_outputs down" in found[0].message


def test_sharding_rule_flags_mesh_mismatch_and_vacuity(mutants):
    found = _run(_rec(mutants, "psum1", {"sharding": {
        "mesh_axes": {"data": 4}, "divergent_outputs": 0}}), "sharding")
    assert found and any("mesh" in f.message for f in found)
    found = _run(_ep("mutant_shardless",
                     expect={"sharding": {"mesh_axes": {"data": 8}}},
                     trace=_traced(lambda: torch.ones(8) * 2)),
                 "sharding")
    assert len(found) == 1 and "no process group" in found[0].message


def test_sharding_rule_flags_over_budget_replication(mutants):
    """A replicated 4 KB leaf on 8 ranks is 7 duplicate copies."""
    def expect(budget):
        return {"sharding": {"mesh_axes": {"data": 8},
                             "divergent_outputs": 0,
                             "max_replicated_bytes": budget}}
    found = _run(_rec(mutants, "replicated_leaf", expect(1000)), "sharding")
    assert len(found) == 1
    assert found[0].detail["replicated_bytes"] == 7 * 1024 * 4
    assert "largest contributor" in found[0].message
    assert _run(_rec(mutants, "replicated_leaf", expect(7 * 1024 * 4)),
                "sharding") == []


def test_resharding_census_flags_unplanned_all_gather(mutants):
    """A world all-gather smuggled after the honest hierarchical chain:
    the psum census is unchanged, the per-collective payload match names
    the operand."""
    n = 1024
    expect = parallel.plan_resharding_expectations(_hier_plan(n))
    found = _run(_rec(mutants, "hier_gathered", {"resharding":
                                                 dict(expect)}),
                 "resharding-census")
    assert len(found) == 1, found
    assert found[0].detail["primitive"] == "all_gather"
    assert "unplanned" in found[0].message
    assert found[0].detail["payload_bytes"] == n * 4
    assert _run(_rec(mutants, "hier_honest", {"resharding": dict(expect)}),
                "resharding-census") == []
    assert _run(_rec(mutants, "hier_gathered", {"resharding": dict(
        expect, budget={"all_gather": 1})}), "resharding-census") == []


def test_resharding_census_flags_plan_graph_desync(mutants):
    expect = parallel.plan_resharding_expectations(_hier_plan())
    found = _run(_rec(mutants, "flat", {"resharding": dict(expect)}),
                 "resharding-census")
    assert found and all("never issues" in f.message for f in found)
    assert {f.detail["primitive"] for f in found} == \
        {"reduce_scatter", "all_gather"}
    found = _run(_ep("mutant_resharding_shardless",
                     expect={"resharding": dict(expect)},
                     trace=_traced(lambda: torch.ones(4) + 1)),
                 "resharding-census")
    assert len(found) == 1 and "no process group" in found[0].message


# -- the replication ledger over real entry points ----------------------------

def test_sharding_ledger_reports_replicated_optimizer_state(mutants):
    """The values the JAX test asserts: on the DDP O2 step the fp32
    master and moments ride every rank (factor 8), > 80 % of world bytes
    are duplicates and fp32 dominates them, 0.8-1.1 GB of world-total
    fp32 duplicates for resnet18.  The ledger's argument bytes are the
    state's; the memory plane's placeholders are every tensor the step
    read first (the state, its views and the batch), so they bound it."""
    from apex_tpu_torch.observability import memory as obsmem
    ep = analysis.get("ddp_resnet18_o2")
    rec = analysis.entry_point_sharding_record(ep)
    assert rec["kind"] == "sharding" and rec["world"] == 8
    assert rec["mesh_axes"] == {"data": 8}
    live = obsmem.graph_live_bytes(ep.graph().fx())
    assert 0 < rec["argument_bytes"] <= 2 * live["argument_bytes"]
    assert rec["unique_bytes"] + rec["replicated_bytes"] == \
        rec["world"] * rec["argument_bytes"]
    assert rec["replicated_fraction"] > 0.80
    f32 = rec["replicated_bytes_by_dtype"]["float32"]
    assert f32 > 0.8 * rec["replicated_bytes"]
    assert rec["top_replicated"]
    for t in rec["top_replicated"]:
        assert t["replication_factor"] == 8
        assert t["spec"] == "replicated"
    assert 0.8e9 < f32 < 1.1e9


def test_sharding_ledger_zero2_sharded_state_is_not_replicated(mutants):
    repl = _rec(mutants, "replicated_leaf")
    shard = _rec(mutants, "sharded_leaf")
    r = analysis.entry_point_sharding_record(repl)
    s = analysis.entry_point_sharding_record(shard)
    assert r["replicated_bytes"] == 7 * 1024 * 4
    assert r["replicated_fraction"] == pytest.approx(7 / 8)
    assert s["replicated_bytes"] == 0
    assert s["unique_bytes"] == 8 * s["argument_bytes"]
    bare = _ep("ledger_no_group", trace=_traced(lambda: torch.ones(4) + 1))
    with pytest.raises(RuntimeError, match="no process group") as ei:
        analysis.entry_point_sharding_record(bare)
    assert type(ei.value) is RuntimeError


def test_sharding_rule_ratchet_flags_stale_budget_both_ways(mutants):
    measured = 7 * 1024 * 4

    def expect(budget):
        return {"sharding": {"mesh_axes": {"data": 8},
                             "divergent_outputs": 0,
                             "max_replicated_bytes": budget}}
    found = _run(_rec(mutants, "replicated_leaf", expect(measured * 2)),
                 "sharding")
    assert len(found) == 1, found
    assert "stale" in found[0].message
    assert found[0].detail["replicated_bytes"] == measured
    assert found[0].detail["budget_bytes"] == measured * 2
    assert _run(_rec(mutants, "replicated_leaf",
                     expect(int(measured / 0.75))), "sharding") == []


def test_sharding_ledger_zero3_collapses_replicated_fraction(mutants):
    """The JAX acceptance values: every ZeRO entry is registered, plain
    DDP duplicates > 80 % of world bytes, ZeRO-3 < 1 % within its declared
    ratchet budget, and the record carries its stage."""
    for name in ("ddp_resnet18_o2_zero1", "ddp_resnet18_o2_zero2",
                 "ddp_resnet18_o2_zero3", "ddp_mlp_overlap_zero2"):
        assert name in analysis.ENTRY_POINTS
    assert len(analysis.ENTRY_POINTS) >= 29
    base = analysis.entry_point_sharding_record(
        analysis.get("ddp_resnet18_o2"))
    z3 = analysis.entry_point_sharding_record(
        analysis.get("ddp_resnet18_o2_zero3"))
    assert base["replicated_fraction"] > 0.80
    assert z3["replicated_fraction"] < 0.01
    assert z3["replicated_bytes"] <= 1_333_000
    assert z3["replicated_bytes"] <= analysis.get(
        "ddp_resnet18_o2_zero3").expect["sharding"]["max_replicated_bytes"]
    assert z3["zero_stage"] == 3
    assert "zero_stage" not in base
    assert exporters.validate_sharding_record(
        exporters.JsonlExporter.enrich(z3)) == []


def test_zero2_overlap_interleaving_mutation_both_ways(mutants):
    sched = parallel.overlap_comm_schedule(
        [{"w": torch.empty(32, 32, device="meta"),
          "b": torch.empty(32, device="meta")}] * 4,
        comm_topology="hierarchical", ici_size=4, world=8, nproc=1,
        overlap=True, zero_stage=2)
    expect = {"collectives": parallel.overlap_collective_expectations(
        sched, extra_psums=1, extra_psum_bytes=4)}
    assert expect["collectives"]["interleaving"][
        "min_collectives_before_last_matmul"] > 0
    found = _run(_rec(mutants, "zero2_overlap_off", dict(expect)),
                 "collective")
    assert len(found) == 1, found
    assert "reduce-after-backward schedule" in found[0].message
    fixed = _ep("fixed_zero2_overlapped", expect=dict(expect),
                recorded=E.get("ddp_mlp_overlap_zero2").graph().trace)
    assert _run(fixed, "collective") == []


# -- findings as JSONL ------------------------------------------------------

def _enriched(finding):
    return exporters.JsonlExporter.enrich(finding.to_record())


def test_lint_record_schema_roundtrip():
    f = analysis.Finding(rule="donation", entry_point="engine_step_k",
                         message="cache rebound",
                         detail={"argument": "cache"})
    rec = _enriched(f)
    assert exporters.validate_lint_record(rec) == []
    assert rec["kind"] == "graph_lint"
    assert rec["schema_version"] >= 1 and rec["stale"] is False
    assert any("severity" in e for e in exporters.validate_lint_record(
        dict(rec, severity="catastrophic")))
    assert any("rule" in e for e in exporters.validate_lint_record(
        {k: v for k, v in rec.items() if k != "rule"}))


def test_lint_summary_schema():
    good = exporters.JsonlExporter.enrich(
        {"kind": "graph_lint_summary", "entry_points": 13, "rules": 5,
         "findings": 2, "errors": 1, "warnings": 1})
    assert exporters.validate_lint_record(good) == []
    assert any("errors" in e for e in exporters.validate_lint_record(
        dict(good, findings=3)))


def test_telemetry_jsonl_validates_mixed_stream():
    lint_rec = _enriched(analysis.Finding(rule="layout", entry_point="x",
                                          message="leak"))
    trace_rec = exporters.JsonlExporter.enrich(
        {"kind": "trace", "trace_id": "t/r0", "span_count": 1,
         "spans": [{"name": "s", "ph": "i", "ts": 1.0, "span_id": 1,
                    "trace_id": "t/r0"}]})
    lines = [json.dumps(lint_rec), json.dumps(trace_rec)]
    assert exporters.validate_telemetry_jsonl(lines) == []
    errs = exporters.validate_telemetry_jsonl(
        [json.dumps(trace_rec), json.dumps(dict(lint_rec, message=""))])
    assert len(errs) == 1 and "line 2" in errs[0]


def test_memory_record_schema_and_dispatch():
    """The port's ``--memory`` record of a real entry is schema-valid and
    reassembles; a peak that does not flags."""
    rec = exporters.JsonlExporter.enrich(
        E.entry_point_memory_record(E.get("engine_prefill_slot")))
    assert exporters.validate_memory_record(rec) == []
    assert exporters.validate_telemetry_record(rec) == []
    assert rec["alias_bytes"] > 0 and rec["flops"] > 0
    assert any("peak_bytes" in e for e in exporters.validate_memory_record(
        dict(rec, peak_bytes=rec["peak_bytes"] + 1)))
    errs = exporters.validate_telemetry_jsonl(
        [json.dumps(rec), json.dumps(dict(rec, temp_bytes=-1))])
    assert len(errs) >= 1 and all("line 2" in e for e in errs)


def test_sharding_record_schema_and_dispatch(mutants):
    rec = exporters.JsonlExporter.enrich(
        analysis.entry_point_sharding_record(_rec(mutants,
                                                  "replicated_leaf")))
    assert exporters.validate_sharding_record(rec) == []
    assert exporters.validate_telemetry_record(rec) == []
    assert any("reassemble" in e for e in exporters.validate_sharding_record(
        dict(rec, unique_bytes=rec["unique_bytes"] - 1)))
    assert any("replicated_fraction" in e
               for e in exporters.validate_sharding_record(
                   dict(rec, replicated_fraction=0.5)))
    assert any("mesh_axes" in e for e in exporters.validate_sharding_record(
        dict(rec, mesh_axes={"data": 4})))


def test_findings_to_records_and_registry_surface():
    """The rule set and the registry are the JAX package's, name for
    name."""
    from apex_tpu.analysis import entry_points as jep
    assert set(analysis.RULES) == {"host-transfer", "donation",
                                   "amp-dtype", "layout", "collective",
                                   "flop-accounting", "memory-budget",
                                   "numerics", "supervisor",
                                   "sharding", "resharding-census"}
    assert list(analysis.ENTRY_POINTS) == list(jep.ENTRY_POINTS)
    for name, ep in analysis.ENTRY_POINTS.items():
        assert ep.tags == jep.ENTRY_POINTS[name].tags, name
    f = analysis.Finding(rule="r", entry_point="e", message="m")
    (rec,) = analysis.findings_to_records([f])
    assert rec == {"kind": "graph_lint", "rule": "r", "severity": "error",
                   "entry_point": "e", "message": "m"}


def test_entry_point_build_restores_global_policy():
    """amp.initialize(O1) installs a process-wide cast policy; a build
    restores the global after it, so the O1 entry cannot re-dtype the
    graphs built after it."""
    from apex_tpu_torch import amp, optimizers
    from apex_tpu_torch.amp import policy as P
    name = "mutant_policy_leak"

    def build(ep):
        amp.initialize(torch.nn.Linear(4, 4), optimizers.FusedAdam(1e-3),
                       opt_level="O1", verbosity=0)
        assert not isinstance(P.current_policy(), P.NoPolicy)
        return Graph(trace=lambda: None)

    analysis.register_entry_point(name)(build)
    try:
        before = P.current_policy()
        analysis.get(name).graph()
        assert P.current_policy() is before
    finally:
        del analysis.ENTRY_POINTS[name]


# -- the CLI ----------------------------------------------------------------

def test_cli_list_and_single_entry_point(capsys):
    from apex_tpu_torch.analysis.__main__ import main
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "engine_step_k" in out and "rules:" in out
    for name in analysis.ENTRY_POINTS:
        assert name in out
    assert main(["--entry-points", "engine_prefill_slot"]) == 0
    out = capsys.readouterr().out
    assert exporters.validate_telemetry_jsonl(out.splitlines()) == []
    last = json.loads(out.strip().splitlines()[-1])
    assert last["kind"] == "graph_lint_summary" and last["errors"] == 0


def test_cli_memory_flag(capsys):
    from apex_tpu_torch.analysis.__main__ import main
    assert main(["--memory", "--entry-points", "engine_prefill_slot"]) == 0
    out = capsys.readouterr().out
    assert exporters.validate_telemetry_jsonl(out.splitlines()) == []
    (rec,) = [json.loads(ln) for ln in out.strip().splitlines()]
    assert rec["kind"] == "memory"
    assert rec["entry_point"] == "engine_prefill_slot"
    assert rec["flops"] > 0 and rec["peak_bytes"] > 0
    assert rec["alias_bytes"] > 0


def test_cli_entry_and_rule_filters(capsys):
    from apex_tpu_torch.analysis.__main__ import main
    assert main(["--list", "--entry", "engine", "--rule", "shard"]) == 0
    out = capsys.readouterr().out
    assert "engine_step_k" in out and "ddp_resnet18_o2" not in out
    rules_line = [ln for ln in out.splitlines()
                  if ln.startswith("rules:")][0]
    assert rules_line == "rules: resharding-census, sharding"
    assert main(["--entry", "engine_prefill", "--rule", "donat"]) == 0
    out = capsys.readouterr().out
    assert exporters.validate_telemetry_jsonl(out.splitlines()) == []
    last = json.loads(out.strip().splitlines()[-1])
    assert (last["entry_points"], last["rules"]) == (1, 1)
    assert main(["--entry", "zzz_no_such"]) == 2
    assert main(["--rule", "zzz_no_such"]) == 2


def test_cli_sharding_flag(mutants, capsys):
    from apex_tpu_torch.analysis.__main__ import main
    assert main(["--sharding", "--entry", "ddp_mlp_overlap_flat"]) == 0
    out = capsys.readouterr().out
    assert exporters.validate_telemetry_jsonl(out.splitlines()) == []
    (rec,) = [json.loads(ln) for ln in out.strip().splitlines()]
    assert rec["kind"] == "sharding"
    assert rec["schema_version"] == exporters.SCHEMA_VERSION
    assert rec["entry_point"] == "ddp_mlp_overlap_flat"
    assert rec["world"] == 8 and rec["replicated_bytes"] > 0
    assert main(["--sharding", "--entry", "engine_prefill_slot"]) == 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "skipped" in captured.err


def test_cli_exit_nonzero_on_finding():
    from apex_tpu_torch.analysis.__main__ import main
    name = "mutant_cli_host_sync"

    def build(ep):
        return Graph(trace=_traced(lambda: torch.ones(4).sum().item()))

    analysis.register_entry_point(name)(build)
    try:
        assert main(["--entry-points", name,
                     "--rules", "host-transfer"]) == 1
    finally:
        del analysis.ENTRY_POINTS[name]
