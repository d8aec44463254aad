"""The core rule set: every hot-path invariant, pinned mechanically over
the aten graph of one call of a step.

Counterpart of ``apex_tpu/analysis/rules.py``: the rules keep their names
and their expectation keys, and each applies where its key is present.
What the JAX package reads from a jaxpr and its lowering, the port reads
from :class:`.graphs.Graph` (the recorded call); see each rule for what a
JAX notion means in the port.

``host_transfer`` (always on; opt out with ``allow_host_transfers``)
    No host-sync operator (``graphs.HOST_TRANSFER_PRIMS``: ``.item()``,
    ``bool(t)``, ``.tolist()``, a copy to the CPU, a data-dependent
    shape, ``torch.cuda.synchronize``) may run in a hot step: one breaks
    the step's CUDA graph capture.

``donation``::

    {"expect_donated": ("ids", "cache", "keys"),
     "forbid_donated": ("temps",),
     "min_aliased": None}

    In the JAX package a donated buffer is one the executable aliases to
    an output.  In the port, whose captured graphs replay on fixed
    addresses, a state argument is *donated* when every leaf of it keeps
    its address through the call (updated in place, never rebound: a
    rebound tensor freezes at its capture-time address); a leaf is
    *aliased* when it is also written (its version counter moved, or a
    kernel wrapper took it).  ``expect_donated`` names arguments that
    must be donated; an argument with some leaves rebound is *partially*
    donated; ``min_aliased`` (default: the leaves of the expected
    arguments) floors the count of leaves written in place.
    ``forbid_donated`` names arguments the step must only read: a write
    into one is a finding (the port's "donated where it must not be").
    The JAX blocklist (``serving.DONATION_BLOCKLIST``: the per-slot
    length vectors ``cur_len``/``n_new``/``kv_len``/``n_blk``) keeps
    them out of donation because of an XLA compile-cache hazard the port
    does not have; in the port those vectors are what the host's
    admission writes between windows, so the blocklist holds them to the
    stricter form on every donation entry point: written in place or not
    at all, never rebound.  Two written leaves on one buffer (the same
    tensor under two names, or overlapping views neither holding the
    other) are a double donation.

``amp``::

    {"opt_level": "O2", "conv_dtype": "bfloat16", "dot_dtype": "bfloat16",
     "min_convs": 40, "min_dots": 0, "dot_min_elems": 256}

    Conv nodes (``convolution`` and ``convolution_backward``: the
    backward's dgrad and wgrad are one aten node) and large matmul nodes
    (``mm``/``bmm``/``addmm``, and the flash kernels by their declared
    operand dtype: the fp32 arithmetic of a kernel's plain version is not
    the kernel's) carry the O-level's dtype.

``layout``::

    {"min_activation_elems": 12288, "allowed_6d_rearranges": 0}

    A permute is a free view in PyTorch; the transpose that costs is the
    copy that materializes another dimension order
    (``graphs.transpose_nodes``).  None on activation-sized tensors in a
    channels-last graph; the 6-D block rearrange of space-to-depth is the
    budgeted exception.  A relayout of state or of a tensor of a state
    leaf's shape (PyTorch's channels-last convolution copies its OIHW
    weight to channels-last each call, and its weight gradient back) is
    a weight's and is not counted: the JAX rule counts activations.

``flops``::

    {"expected_flops": 3.8e6, "rtol": 0.05,
     "max_fp32_matmul_fraction": 0.02, "min_matmul_flops": 1e6}

    Over ``observability.costmodel.count_cost`` of the same call.

``memory``::

    {"budget_bytes": ..., "max_live_to_argument_ratio": 4.0,
     "temp_budget_bytes_by_dtype": {"float32": ...}}

    Over ``observability.memory.graph_live_bytes`` of the recorded
    graph (``Graph.fx()``).

``collectives``::

    {"counts": {"psum": 4}, "payload_bytes": ...,
     "payload_bytes_by_primitive": {...},
     "interleaving": {"min_payload_bytes": 1056, "min_matmuls_after": 1,
                      "min_collectives_before_last_matmul": 3}}

    The c10d operators the step ran, named by the JAX primitive each
    stands for, against the plan (``parallel.
    plan_collective_expectations`` / ``overlap_collective_expectations``).
    ``interleaving`` holds the overlapped schedule's positions: the first
    gradient-bucket collective before the last conv/matmul node, in
    program order (on the CPU the collectives of an overlapped schedule
    run in place, in issue order).

``numerics`` / ``supervisor``::

    {"baseline": "ddp_resnet18_o2", "enabled": True,
     "extra_collectives": {"psum": 1}, "extra_payload_bytes": 520}

    The monitor instrumented with no host sync and exactly the planned
    extra collectives; disabled, or a supervisor either way, the step's
    recorded graph is the baseline's (``graphs.text``: every node with
    its operands' shapes and dtypes).

``sharding``::

    {"mesh_axes": {"data": 8}, "divergent_outputs": 40,
     "max_replicated_bytes": None}

    A run-time check in the port (``analysis.sharding``): the ranks
    digest each state leaf, and a leaf the step claims replicated but
    whose digests differ across ranks after the step is a divergent
    output; the mesh the step's groups span and the replication ledger
    (the state leaves equal on several ranks before the step) as in the
    JAX package.

``resharding``::

    {"planned": {"reduce_scatter": [...], "all_gather": [...]},
     "budget": {"all_gather": 0}}

    Every all-gather, reduce-scatter and all-to-all the step ran, matched
    one for one by payload against the plan's list
    (``parallel.plan_resharding_expectations``).
"""

from __future__ import annotations

from collections import Counter
from typing import List

from .core import Rule, Finding, register_rule
from . import graphs as G

__all__ = ["HostTransferRule", "DonationRule", "AmpDtypeRule",
           "LayoutRule", "CollectiveRule", "FlopAccountingRule",
           "MemoryBudgetRule", "NumericsRule", "SupervisorRule",
           "SpecConsistencyRule", "ReshardingCensusRule"]


def _host_hits(graph) -> Counter:
    return Counter(n.prim for n in G.host_transfer_nodes(graph))


def _host_where(graph, prim) -> list:
    return sorted({n.attrs.get("where", "?")
                   for n in G.host_transfer_nodes(graph) if n.prim == prim})


@register_rule
class HostTransferRule(Rule):
    """No host-sync operator inside a hot step: each one is a host round
    trip, and inside ``make_step`` or a ``CapturedFn`` it breaks the CUDA
    graph capture."""

    name = "host-transfer"
    expect_key = None                        # unconditional

    def applies(self, ep):
        return not ep.expect.get("allow_host_transfers", False)

    def check(self, ep, graph) -> List[Finding]:
        return [self.finding(
            ep, f"host-sync operator {prim!r} appears {n}x in the step — "
                f"a host round trip that breaks its CUDA graph capture "
                f"(at {', '.join(_host_where(graph, prim)[:3])})",
            primitive=prim, count=n, where=_host_where(graph, prim))
            for prim, n in sorted(_host_hits(graph).items())]


@register_rule
class DonationRule(Rule):
    """The state a step promises to hold in place keeps its addresses,
    the per-slot length vectors are never rebound, read-only state is not
    written, and no buffer is written under two names (see the module
    doc for what donation means in the port)."""

    name = "donation"
    expect_key = "donation"

    def check(self, ep, graph) -> List[Finding]:
        from ..serving import DONATION_BLOCKLIST
        want = ep.expect["donation"]
        out: List[Finding] = []
        if not graph.arg_names:
            return [self.finding(
                ep, "donation expectation without state — the trace "
                    "cannot map its buffers to arguments")]
        by = {}
        for f in graph.state:
            by.setdefault(f.arg, []).append(f)
        donated, partial = G.donated_arg_names(graph)
        held = [a for a in graph.arg_names
                if by.get(a) and not any(f.rebound for f in by[a])]
        for name in want.get("expect_donated", ()):
            if name not in held and name not in partial:
                out.append(self.finding(
                    ep, f"argument {name!r} must be donated (updated in "
                        f"place every call) but the step rebinds it — a "
                        f"captured graph keeps replaying on the old "
                        f"buffer", argument=name))
        for name in want.get("forbid_donated", ()):
            written = [f.name for f in by.get(name, []) if f.written]
            if written:
                out.append(self.finding(
                    ep, f"argument {name!r} is written by the step but "
                        f"this entry point forbids donating it (read-only "
                        f"state): {written[:3]}", argument=name,
                    blocklisted=False))
        for name in DONATION_BLOCKLIST:
            moved = [f.name for f in by.get(name, []) if f.rebound]
            if moved:
                out.append(self.finding(
                    ep, f"argument {name!r} is rebound by the step but is "
                        f"on the donation blocklist (a per-slot length "
                        f"vector the host's admission writes between "
                        f"windows: in place or not at all)",
                    argument=name, blocklisted=True))
        for name in partial:
            moved = [f.name for f in by[name] if f.rebound]
            out.append(self.finding(
                ep, f"argument {name!r} is only partially donated — "
                    f"{len(moved)} of its leaves are rebound "
                    f"({moved[:3]}), the rest updated in place",
                argument=name))
        min_aliased = want.get("min_aliased")
        if min_aliased is None:
            min_aliased = sum(len(by.get(a, []))
                              for a in want.get("expect_donated", ()))
        n_aliased = G.aliased_output_count(graph)
        if n_aliased < min_aliased:
            out.append(self.finding(
                ep, f"the step writes {n_aliased} state leaves in place "
                    f"but {min_aliased} are expected — state updated "
                    f"off its address (both copies alive)",
                aliased=n_aliased, requested=min_aliased))
        for dup in G.duplicate_donated_leaves(graph):
            out.append(self.finding(
                ep, f"double donation: {dup} — one buffer written as two "
                    f"pieces of state (allocate each layer's cache; no "
                    f"shared buffers)", duplicate=dup))
        return out


@register_rule
class AmpDtypeRule(Rule):
    """Conv/matmul operand dtypes match the O-level policy — forward,
    dgrad and wgrad.  A silently upcast fp32 conv leaves the tensor cores
    and doubles the bytes of that op."""

    name = "amp-dtype"
    expect_key = "amp"

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["amp"]
        out: List[Finding] = []
        lvl = want.get("opt_level", "?")

        conv_dtype = want.get("conv_dtype")
        if conv_dtype is not None:
            convs = G.conv_nodes(graph)
            floor = want.get("min_convs", 1)
            if len(convs) < floor:
                out.append(self.finding(
                    ep, f"vacuous check: expected >= {floor} conv nodes "
                        f"(fwd + bwd) in the {lvl} step, traced "
                        f"{len(convs)}", convs=len(convs), floor=floor))

            def operands(n):
                k = 3 if n.prim == "convolution_backward" else 2
                return tuple(m.dtype for m in n.inputs[:k])
            bad = Counter(operands(n) for n in convs
                          if not all(d == conv_dtype for d in operands(n)))
            for dts, n in sorted(bad.items()):
                out.append(self.finding(
                    ep, f"{n} conv(s) with {dts} operands in the {lvl} "
                        f"step — policy requires {conv_dtype} (silent "
                        f"upcast)", lhs=dts[0], rhs=dts[1], count=n,
                    expected=conv_dtype))

        dot_dtype = want.get("dot_dtype")
        if dot_dtype is not None:
            dots = G.large_dot_nodes(graph, want.get("dot_min_elems", 256))
            floor = want.get("min_dots", 1)
            if len(dots) < floor:
                out.append(self.finding(
                    ep, f"vacuous check: expected >= {floor} large dots "
                        f"in the {lvl} step, traced {len(dots)}",
                    dots=len(dots), floor=floor))
            bad = Counter(G.dot_dtypes(n) for n in dots
                          if not all(d == dot_dtype
                                     for d in G.dot_dtypes(n)))
            for dts, n in sorted(bad.items()):
                out.append(self.finding(
                    ep, f"{n} large dot(s) with {dts} operands in the "
                        f"{lvl} step — policy requires {dot_dtype}",
                    operands=list(dts), count=n, expected=dot_dtype))
        return out


@register_rule
class LayoutRule(Rule):
    """Channels-last graphs stay relayout-free on activation-sized
    tensors; a layout leak pays a copy on every step."""

    name = "layout"
    expect_key = "layout"

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["layout"]
        min_elems = want["min_activation_elems"]
        out: List[Finding] = []
        # a relayout of state or of its gradient (a conv weight copied to
        # channels-last for each call, its grad back) is a parameter's,
        # not an activation's
        big = [n for n in G.transpose_nodes(graph, min_elems)
               if not G.in_state(graph, n.inputs[1] if n.prim == "copy"
                                 else n.inputs[0])]
        # the 6-D block rearrange of space_to_depth is the one sanctioned
        # activation relayout (forward only); it gets a budget
        six_d = [n for n in big if n.inputs[-1].ndim == 6]
        other = [n for n in big if n.inputs[-1].ndim != 6]
        for n in other:
            src = n.inputs[1] if n.prim == "copy" else n.inputs[0]
            perm = G.transpose_permutation(n)
            out.append(self.finding(
                ep, f"activation-sized relayout {src.shape} "
                    f"(permutation {perm}) in a channels-last graph — "
                    f"layout leak", shape=list(src.shape),
                permutation=perm))
        budget = want.get("allowed_6d_rearranges", 0)
        if len(six_d) > budget:
            out.append(self.finding(
                ep, f"{len(six_d)} 6-D block rearranges, budget is "
                    f"{budget} (space_to_depth runs forward-only; a "
                    f"second copy means gradient flows through the "
                    f"rearrange)", count=len(six_d), budget=budget))
        return out


@register_rule
class FlopAccountingRule(Rule):
    """The analytic FLOP count stays explained: totals within a pinned
    tolerance, and under a reduced-precision policy no meaningful share
    of matmul flops runs in fp32 (the flops-weighted twin of the
    amp-dtype rule)."""

    name = "flop-accounting"
    expect_key = "flops"

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["flops"]
        out: List[Finding] = []
        cost = ep.cost() if hasattr(ep, "cost") else graph.cost
        if cost is None:
            return [self.finding(ep, "the trace carries no cost count")]
        expected = want.get("expected_flops")
        if expected is not None:
            rtol = want.get("rtol", 0.05)
            if expected <= 0:
                out.append(self.finding(
                    ep, f"expected_flops must be > 0, got {expected}"))
            elif abs(cost.flops - expected) > rtol * expected:
                out.append(self.finding(
                    ep, f"unexplained FLOP delta: analytic count is "
                        f"{cost.flops:.4g}, expected {expected:.4g} "
                        f"(+/- {rtol:.0%}) — the graph gained or lost "
                        f"arithmetic nobody budgeted",
                    flops=cost.flops, expected_flops=expected,
                    rtol=rtol))
        cap = want.get("max_fp32_matmul_fraction")
        if cap is not None:
            floor = want.get("min_matmul_flops", 1.0)
            if cost.matmul_flops < floor:
                out.append(self.finding(
                    ep, f"vacuous check: expected >= {floor:.4g} "
                        f"dot/conv FLOPs, traced {cost.matmul_flops:.4g}",
                    matmul_flops=cost.matmul_flops, floor=floor))
            frac = cost.fp32_matmul_fraction()
            if frac > cap:
                fp32 = cost.matmul_flops_by_dtype.get("float32", 0.0)
                out.append(self.finding(
                    ep, f"{frac:.1%} of dot/conv FLOPs "
                        f"({fp32:.4g} of {cost.matmul_flops:.4g}) run "
                        f"on fp32 operands — cap is {cap:.1%} (silent "
                        f"upcast where the work is)",
                    fp32_matmul_fraction=frac, cap=cap,
                    fp32_matmul_flops=fp32,
                    matmul_flops=cost.matmul_flops))
        return out


@register_rule
class MemoryBudgetRule(Rule):
    """Peak live bytes stay within budget: a step that keeps a dead copy
    of the cache, stops updating state in place, or upcasts a temp tree
    to fp32 moves the analytic liveness peak."""

    name = "memory-budget"
    expect_key = "memory"

    def check(self, ep, graph) -> List[Finding]:
        lb = ep.live_bytes() if hasattr(ep, "live_bytes") \
            else _live_bytes(graph)
        want = ep.expect["memory"]
        out: List[Finding] = []
        peak = lb["peak_live_bytes"]
        budget = want.get("budget_bytes")
        if budget is not None and peak > budget:
            out.append(self.finding(
                ep, f"analytic peak live bytes {peak:,} exceed the "
                    f"{budget:,}-byte budget",
                peak_live_bytes=peak, budget_bytes=budget))
        ratio_cap = want.get("max_live_to_argument_ratio")
        if ratio_cap is not None:
            args = max(lb["argument_bytes"], 1)
            ratio = peak / args
            if ratio > ratio_cap:
                out.append(self.finding(
                    ep, f"peak live bytes are {ratio:.2f}x the "
                        f"argument bytes ({peak:,} vs {args:,}); "
                        f"budget is {ratio_cap}x — the graph is "
                        f"holding duplicate state",
                    peak_live_bytes=peak, argument_bytes=args,
                    ratio=round(ratio, 3), cap=ratio_cap))
        for dt, cap in sorted(
                want.get("temp_budget_bytes_by_dtype", {}).items()):
            got = lb["peak_temp_bytes_by_dtype"].get(dt, 0)
            if got > cap:
                out.append(self.finding(
                    ep, f"peak {dt} temp bytes {got:,} exceed the "
                        f"{cap:,}-byte budget — e.g. an fp32 upcast "
                        f"materializing a second activation tree",
                    dtype=dt, peak_temp_bytes=got, budget_bytes=cap))
        return out


def _live_bytes(graph):
    from ..observability import memory
    return memory.graph_live_bytes(graph.fx())


@register_rule
class NumericsRule(Rule):
    """Numerics instrumentation is free where enabled and ABSENT where
    disabled.  Expectation::

        {"baseline": "ddp_resnet18_o2", "enabled": True,
         "extra_collectives": {"psum": 1}, "extra_payload_bytes": 520}

    Enabled: no host-sync operator, and the collective census exactly
    the baseline's plus the planned delta (``numerics.digest_comm_plan``).
    Disabled: the step records the baseline's graph, node for node."""

    name = "numerics"
    expect_key = "numerics"

    @staticmethod
    def _baseline_graph(want):
        base = want.get("baseline")
        if base is None:
            return None
        if isinstance(base, str):
            from .entry_points import get as _get_ep
            return _get_ep(base).graph()
        return base.graph() if hasattr(base, "graph") else base

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["numerics"]
        out: List[Finding] = []
        base = self._baseline_graph(want)
        if not want.get("enabled", True):
            if base is None:
                return [self.finding(
                    ep, "a disabled-numerics expectation needs a "
                        "baseline to compare against")]
            if graph.text != base.text:
                n, nb = len(graph.nodes), len(base.nodes)
                out.append(self.finding(
                    ep, f"numerics residue: the disabled-numerics step "
                        f"records a different graph than the "
                        f"uninstrumented baseline ({n} vs {nb} nodes) — "
                        f"the off-switch must be free",
                    eqns=n, baseline_eqns=nb))
            return out
        for prim, n in sorted(_host_hits(graph).items()):
            out.append(self.finding(
                ep, f"numerics-instrumented step contains host-sync "
                    f"operator {prim!r} {n}x — the accounting must "
                    f"accumulate on the device (flush() is the one host "
                    f"fetch, outside the step)", primitive=prim, count=n))
        if base is not None:
            got = Counter(n.prim for n in G.collective_nodes(graph))
            base_counts = Counter(n.prim for n in G.collective_nodes(base))
            extra = dict(want.get("extra_collectives", {}))
            for prim in sorted(set(got) | set(base_counts) | set(extra)):
                w = base_counts.get(prim, 0) + extra.get(prim, 0)
                g = got.get(prim, 0)
                if g != w:
                    out.append(self.finding(
                        ep, f"expected {w} {prim} collective(s) (baseline "
                            f"{base_counts.get(prim, 0)} + planned "
                            f"numerics delta {extra.get(prim, 0)}), "
                            f"instrumented graph has {g}",
                        primitive=prim, expected=w, got=g,
                        baseline=base_counts.get(prim, 0)))
            if "extra_payload_bytes" in want:
                ours = sum(G.node_payload_bytes(n)
                           for n in G.collective_nodes(graph))
                theirs = sum(G.node_payload_bytes(n)
                             for n in G.collective_nodes(base))
                delta, w = ours - theirs, want["extra_payload_bytes"]
                if delta != w:
                    out.append(self.finding(
                        ep, f"numerics adds {delta} collective payload "
                            f"bytes over the baseline, the digest plan "
                            f"budgets exactly {w}",
                        payload_delta=delta, expected_delta=w))
        return out


@register_rule
class SupervisorRule(Rule):
    """A run-supervised step is the UNSUPERVISED step, node for node, and
    syncs nothing with the host, enabled or disabled: the supervisor
    reads host flush points only and ``RunSupervisor.wrap_step`` is an
    identity.  Expectation ``{"baseline": ..., "enabled": True}``."""

    name = "supervisor"
    expect_key = "supervisor"

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["supervisor"]
        out: List[Finding] = []
        for prim, n in sorted(_host_hits(graph).items()):
            out.append(self.finding(
                ep, f"supervised step contains host-sync operator "
                    f"{prim!r} {n}x — the supervisor reads existing host "
                    f"flush points, it never instruments the step",
                primitive=prim, count=n))
        base = NumericsRule._baseline_graph(want)
        if base is None:
            out.append(self.finding(
                ep, "a supervisor expectation needs a baseline to "
                    "compare against"))
            return out
        if graph.text != base.text:
            n, nb = len(graph.nodes), len(base.nodes)
            state = ("enabled" if want.get("enabled", True)
                     else "disabled")
            out.append(self.finding(
                ep, f"supervisor residue: the {state}-supervisor step "
                    f"records a different graph than the unsupervised "
                    f"baseline ({n} vs {nb} nodes) — wrap_step must be "
                    f"an identity in both directions",
                eqns=n, baseline_eqns=nb))
        return out


@register_rule
class CollectiveRule(Rule):
    """The comm pattern is exactly what the algorithm assumes: collective
    counts and on-wire payload bytes in DDP/TP/ZeRO steps, and for an
    overlapped schedule the reductions' positions in the backward."""

    name = "collective"
    expect_key = "collectives"

    def check(self, ep, graph) -> List[Finding]:
        want = ep.expect["collectives"]
        out: List[Finding] = []
        nodes = G.collective_nodes(graph)
        got = Counter(n.prim for n in nodes)
        expected = dict(want.get("counts", {}))
        for prim in sorted(set(got) | set(expected)):
            g, w = got.get(prim, 0), expected.get(prim, 0)
            if g != w:
                out.append(self.finding(
                    ep, f"expected {w} {prim} collective(s), graph has {g}",
                    primitive=prim, expected=w, got=g))
        if "payload_bytes" in want:
            total = sum(G.node_payload_bytes(n) for n in nodes)
            w = want["payload_bytes"]
            tol = want.get("payload_tolerance", 0)
            if abs(total - w) > tol:
                out.append(self.finding(
                    ep, f"collective payload is {total} bytes on the "
                        f"wire, expected {w}"
                        + (f" (+/- {tol})" if tol else ""),
                    payload_bytes=total, expected_bytes=w))
        if "payload_bytes_by_primitive" in want:
            got_by: Counter = Counter()
            for n in nodes:
                got_by[n.prim] += G.node_payload_bytes(n)
            want_by = dict(want["payload_bytes_by_primitive"])
            tol = want.get("payload_tolerance", 0)
            hier = "reduce_scatter" in want.get("counts", want_by)
            for prim in sorted(set(got_by) | set(want_by)):
                g, w = got_by.get(prim, 0), want_by.get(prim, 0)
                if abs(g - w) > tol:
                    out.append(self.finding(
                        ep, f"{prim} payload is {g} bytes on the wire, "
                            f"expected {w}"
                            + (f" (+/- {tol})" if tol else "")
                            + (" — the per-primitive split is the "
                               "fabric-level split under a "
                               "hierarchical comm plan (the psum hop "
                               "is the cross-node payload)" if hier
                               else ""),
                        primitive=prim, payload_bytes=g,
                        expected_bytes=w))
        inter = want.get("interleaving")
        if inter:
            out.extend(self._check_interleaving(ep, graph, inter))
        return out

    def _check_interleaving(self, ep, graph, inter) -> List[Finding]:
        """The overlapped schedule's position pin: the first gradient
        bucket's reduction ahead of the last conv/matmul node, with the
        declared numbers of matmuls after it and of bucket collectives
        before the last matmul (a reduce-after-backward step has the
        same census and payloads; only the positions tell)."""
        out: List[Finding] = []
        thresh = int(inter.get("min_payload_bytes", 16))
        first_coll = None
        coll_pos: List[int] = []
        matmul_pos: List[int] = []
        mm = G.CONV_PRIMS | G.DOT_PRIMS | G._DOT_KERNELS
        for i, n in enumerate(G.walk_graph(graph)):
            if (n.kind == "collective" and n.prim in G.COLLECTIVE_PRIMS
                    and G.node_payload_bytes(n) >= thresh):
                if first_coll is None:
                    first_coll = i
                coll_pos.append(i)
            if n.prim in mm:
                matmul_pos.append(i)
        if first_coll is None:
            return [self.finding(
                ep, f"vacuous interleaving check: no collective moves "
                    f">= {thresh} bytes — there is no gradient bucket "
                    f"reduction to position", min_payload_bytes=thresh)]
        if not matmul_pos:
            return [self.finding(
                ep, "vacuous interleaving check: the graph has no "
                    "conv/matmul nodes to interleave the reduction with")]
        last_mm = matmul_pos[-1]
        if first_coll > last_mm:
            out.append(self.finding(
                ep, f"reduce-after-backward schedule: the first "
                    f"gradient-bucket collective (node #{first_coll}) "
                    f"trails the last matmul (node #{last_mm}) — the "
                    f"overlapped schedule must issue the first bucket's "
                    f"reduction while later stages' backward still runs",
                first_collective_eqn=first_coll, last_matmul_eqn=last_mm))
            return out
        after = sum(1 for i in matmul_pos if i > first_coll)
        floor = int(inter.get("min_matmuls_after", 1))
        if after < floor:
            out.append(self.finding(
                ep, f"only {after} matmul node(s) follow the first "
                    f"gradient-bucket collective (node #{first_coll}); "
                    f"the overlap schedule budgets >= {floor} — nothing "
                    f"is left for the reduction to overlap with",
                matmuls_after=after, floor=floor,
                first_collective_eqn=first_coll))
        coll_floor = inter.get("min_collectives_before_last_matmul")
        if coll_floor is not None:
            before = sum(1 for i in coll_pos if i < last_mm)
            if before < int(coll_floor):
                out.append(self.finding(
                    ep, f"only {before} gradient-bucket collective(s) "
                        f"precede the last matmul (node #{last_mm}); the "
                        f"overlap schedule issues >= {int(coll_floor)} "
                        f"before the final stage's backward — the staged "
                        f"overlap partially collapsed to "
                        f"reduce-after-backward",
                    collectives_before=before, floor=int(coll_floor),
                    last_matmul_eqn=last_mm))
        return out


# a declared max_replicated_bytes budget whose measured ledger value sits
# below this fraction of it is stale (entry points declare ~1.05x
# measured): it outlived a ZeRO-stage (or sharding) change
RATCHET_FRACTION = 0.75


@register_rule
class SpecConsistencyRule(Rule):
    """The step's process groups span the mesh its entry point declares,
    and the number of state leaves the step claims replicated but that
    differ across ranks after it is exactly the declared count (a run-time
    check in the port: the ranks' digests, ``analysis.sharding``), and
    the replication ledger stays within its ratcheted budget."""

    name = "sharding"
    expect_key = "sharding"

    def check(self, ep, graph) -> List[Finding]:
        from . import sharding as S
        want = ep.expect["sharding"]
        out: List[Finding] = []
        rec = graph.info.get("sharding")
        if not rec:
            return [self.finding(
                ep, "a sharding expectation is declared but the trace "
                    "ran on no process group (no rank digests)")]
        for msg in S.check_mesh(graph, want.get("mesh_axes")):
            out.append(self.finding(ep, msg))
        divergent = S.divergent_output_claims(graph)
        declared = int(want.get("divergent_outputs", 0))
        if len(divergent) != declared:
            sample = "; ".join(divergent[:3])
            if len(divergent) > declared:
                out.append(self.finding(
                    ep, f"{len(divergent)} state leaves claimed "
                        f"replicated differ across ranks after the step; "
                        f"{declared} are declared (the non-synced "
                        f"BatchNorm stats class) — a collective went "
                        f"missing. First undeclared: {sample}",
                    divergent=len(divergent), declared=declared))
            else:
                out.append(self.finding(
                    ep, f"only {len(divergent)} divergent state leaves "
                        f"but {declared} are declared — ratchet "
                        f"divergent_outputs down",
                    divergent=len(divergent), declared=declared))
        budget = want.get("max_replicated_bytes")
        if budget is not None:
            args = S.arg_shardings(graph)
            world = rec["world"]
            repl = sum(a.replicated_bytes(world) for a in args)
            if repl > int(budget):
                worst = max(args, key=lambda a: a.replicated_bytes(world))
                out.append(self.finding(
                    ep, f"replication ledger reports {repl:,} "
                        f"world-total duplicate bytes, budget is "
                        f"{int(budget):,} — largest contributor: "
                        f"{worst.dtype}{list(worst.shape)} x"
                        f"{worst.replication_factor} ({worst.spec})",
                    replicated_bytes=repl, budget_bytes=int(budget)))
            elif repl < int(int(budget) * RATCHET_FRACTION):
                out.append(self.finding(
                    ep, f"replication budget is stale: the ledger "
                        f"reports {repl:,} world-total duplicate bytes "
                        f"but {int(budget):,} are budgeted "
                        f"(> {100 - int(RATCHET_FRACTION * 100)}% "
                        f"headroom) — ratchet max_replicated_bytes down "
                        f"to the measured value",
                    replicated_bytes=repl, budget_bytes=int(budget)))
        return out


@register_rule
class ReshardingCensusRule(Rule):
    """Every placement-changing collective the step ran is explained by
    the comm plan or a declared budget, matched one for one by payload;
    an unplanned gather is named by its operand, and a planned payload
    the step never moved flags too (plan/graph desync)."""

    name = "resharding-census"
    expect_key = "resharding"

    def check(self, ep, graph) -> List[Finding]:
        from . import sharding as S
        want = ep.expect["resharding"]
        out: List[Finding] = []
        if not graph.info.get("sharding"):
            return [self.finding(
                ep, "a resharding expectation is declared but the trace "
                    "ran on no process group")]
        sites = [s for s in S.collective_sites(graph)
                 if s.primitive in S.RESHARD_PRIMS]
        planned = {prim: list(pays)
                   for prim, pays in want.get("planned", {}).items()}
        budget = {k: int(v) for k, v in want.get("budget", {}).items()}
        unplanned: dict = {}
        for s in sites:
            pool = planned.get(s.primitive, [])
            if s.payload_bytes in pool:
                pool.remove(s.payload_bytes)
            else:
                unplanned.setdefault(s.primitive, []).append(s)
        for prim in sorted(unplanned):
            extra = unplanned[prim]
            allowed = budget.get(prim, 0)
            if len(extra) <= allowed:
                continue
            for s in extra:
                out.append(self.finding(
                    ep, f"unplanned {s.describe()} — not in the comm "
                        f"plan's {prim} payload list and beyond the "
                        f"declared budget of {allowed}; an unexplained "
                        f"resharding in the hot path",
                    primitive=s.primitive, payload_bytes=s.payload_bytes,
                    shape=list(map(int, s.shape)), dtype=s.dtype,
                    spec=s.spec, budget=allowed))
        for prim in sorted(planned):
            left = planned[prim]
            if left:
                out.append(self.finding(
                    ep, f"comm plan schedules {len(left)} {prim} "
                        f"collective(s) of {sorted(left)} bytes that the "
                        f"step never issues — plan/graph desync",
                    primitive=prim, missing=len(left),
                    payloads=sorted(int(x) for x in left)))
        return out
