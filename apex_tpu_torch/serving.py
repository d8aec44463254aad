"""Continuous-batching serving engines: fixed slots (``Engine``), a paged
KV block pool (``PagedEngine``) and encoder-decoder slots
(``Seq2SeqEngine``).

Counterpart of ``apex_tpu/serving.py``, with the same request lifecycle
and public surface: ``submit`` (queues) or ``add_request`` (claims a free
slot), ``step()`` until ``is_finished(rid)``, then ``result(rid)``;
``cancel``, ``preempt``, ``take_waiting``, ``warmup``, ``compile_census``,
``stats()`` and the KV fragmentation ledger; ``uncaptured()`` names the
graphs a later step may still capture (a fleet steps such a replica
alone).  Requests arrive and finish
at different times; every ``step()`` decodes the whole slot batch for a
WINDOW of ``window`` ticks, and the host reads the window's ``[slots,
window]`` token and validity buffers once.  A slot that hits its EOS or
token limit mid-window freezes (its ids, length, cache and sampling
stream stop advancing), so a request's tokens do not depend on the
window size or on its co-tenants.

Where the JAX package jits each engine entry (``lax.scan`` over the K
ticks of a window, the KV buffers donated), the port captures each entry
in a CUDA graph (``_graph.CapturedFn``): the K ticks unrolled over static
tensors that every tick updates in place (ids, lengths, limits, EOS ids,
temperatures, the sampling streams, the caches or the block pool, the
block tables and the free stack, the window's output buffers).
Admission writes a slot's entries into those tensors from one host copy
(pinned, asynchronous) and runs the captured prefill.  On the card call 1
of an entry runs eagerly on a side stream (kernels built, cuBLAS warmed),
call 2 captures, later calls replay; a capture that fails raises.  All of
one engine's graphs share one memory pool.  ``captures`` counts them
under the JAX compile census's names: ``warmup()`` captures exactly
``compile_census()``'s admission and decode graphs (it runs its
throwaway traffic twice, so each is called twice), and a warm engine
captures nothing more through admissions, cancels, preemption,
mid-window EOS and in-window paged admission.  A prefix-pool graph
captures at its second use.  On the CPU every entry runs eagerly: the
plain path the tests hold against the JAX engines.

Sampling (``temperature > 0``): the JAX package keys each request with
``fold_in`` and splits once per its own decode tick; the port cannot
match JAX's bits.  Its stream is stateless and counter-based: the
uniforms of a tick are a hash of (the engine's integer key ``rng``, the
domain, 0 for a request keyed by its id and 1 for an explicit ``seed``,
that id or seed, the request's own step count, the vocabulary index),
computed in integer tensor ops, and the token is the Gumbel-max draw of
``models.sampling.sample_token`` from them.  So the JAX contracts hold
on the port: an explicitly seeded request's tokens do not depend on its
co-tenants, its arrival or the window size, the paged engine draws the
fixed engine's tokens, and a request at temperature 0 is the argmax
row; the two packages agree in distribution, not token for token.

Works with any model exposing ``prefill_cache`` / ``decode_chunk`` /
``init_cache`` and a head (GPT, Llama and its Mistral / Qwen2 / Gemma /
NeoX knobs, Mixtral); T5 through ``Seq2SeqEngine``.  The models hold their
weights, so the constructors take the JAX engines' arguments less
``params`` and ``draft_params``.  As in the JAX engines, ``Engine`` and
``PagedEngine`` refuse an MoE model whose routing can drop tokens
(``capacity_factor < n_experts``): a dropped token would make a request's
output depend on its co-tenants.

``warmup()`` runs the JAX engines' throwaway traffic twice (eager, then
captured) and the paged engine's extra request, then rewinds the request
ids, the totals and the metrics to where the JAX engine stands after its
own warmup.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ._graph import CapturedFn, leaves
from .models.sampling import filter_logits
from .models.speculative import _head_logits, spec_iteration
from .observability import MetricsRegistry
from .observability.tracing import maybe_event, maybe_span

__all__ = ["Engine", "PagedEngine", "Seq2SeqEngine",
           "DONATION_BLOCKLIST", "STEP_K_ARG_NAMES",
           "PREFILL_SLOT_ARG_NAMES", "SEQ2SEQ_STEP_K_ARG_NAMES",
           "PAGED_STEP_K_ARG_NAMES", "PAGED_ADMIT_ARG_NAMES"]

# The JAX package's public names of its engine jits' arguments and of
# the per-slot length vectors it never donates, kept equal to its own
# (the tests pin them) for code that reads them from either package.
# The port donates nothing: its graphs update every buffer in place, and
# its sampling streams stand where the JAX engines hold ``keys``.
DONATION_BLOCKLIST = ("cur_len", "n_new", "kv_len", "n_blk")
STEP_K_ARG_NAMES = ("ids", "cur_len", "cache", "keys", "temps",
                    "limit", "eos")
PREFILL_SLOT_ARG_NAMES = ("ids", "cache", "d_cache", "slot", "row")
SEQ2SEQ_STEP_K_ARG_NAMES = ("state", "out", "n_new", "limit", "eos")
PAGED_STEP_K_ARG_NAMES = ("ids", "cur_len", "kv_len", "pool", "keys",
                          "temps", "limit", "eos", "tables", "n_blk",
                          "free_stack", "free_top", "pending")
PAGED_ADMIT_ARG_NAMES = ("ids", "cur_len", "kv_len", "limit", "eos",
                         "keys", "temps", "tables", "n_blk",
                         "free_stack", "free_top", "slot", "row",
                         "plen", "lim", "eos_id", "key", "temp",
                         "n_need")

# generated tokens/sec per request spans toy CPU engines (~1/s) to
# hardware batch decode (~10k/s)
_TPS_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                1000.0, 2000.0, 5000.0, 10000.0, 20000.0)


def _tree_nbytes(tree) -> int:
    """Device bytes across a tree's tensors: the one leaf-accounting rule
    ``kv_cache_bytes`` and every engine's fragmentation ledger share."""
    return int(sum(t.numel() * t.element_size() for t in leaves(tree)))


def _tree_map2(fn: Callable, a, b):
    """``fn`` over the paired tensors of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _model_device(model) -> torch.device:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


def _table_dtype(model) -> torch.dtype:
    """``generate_cached``'s default cache dtype: the head table's."""
    if hasattr(model, "_table"):
        return model._table().dtype
    return model.wte.weight.dtype


# -- the counter-based sampling stream -----------------------------------
# 32-bit words held in int64 tensors (or Python ints: the same code runs
# on both).  Every product stays below 2**49, so nothing overflows.
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for x in [0, 2**32) and a constant c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply, lowbias32's constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _stream_word(key: int, domain: int, ident: int) -> int:
    """A request's stream: (engine key, domain, rid or seed) hashed."""
    h = _mix32(key & _M32)
    for w in ((key >> 32) & _M32, domain, ident & _M32,
              (ident >> 32) & _M32):
        h = _mix32(h ^ w)
    return h


def _uniforms(stream: torch.Tensor, step: torch.Tensor,
              vmix: torch.Tensor) -> torch.Tensor:
    """(slots, V) fp32 uniforms in (0, 1) of each slot's stream at its own
    step count; ``vmix`` is ``_mix32`` of the vocabulary indices."""
    h = _mix32(stream ^ _mix32((step + 0x9E3779B9) & _M32))
    bits = _mix32(h[:, None] ^ vmix[None, :])
    return ((bits >> 8).float() + 0.5) * (2.0 ** -24)


def _sample_rows(logits, temps, stream, step, vmix, top_k, top_p):
    """Each row's token: its temperature-scaled, filtered Gumbel-max draw
    from its stream (``sampling.sample_token`` at temperature 1 on
    pre-scaled logits), or its argmax where its temperature is 0."""
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    scaled = filter_logits(logits.float() / safe_t[:, None], top_k=top_k,
                           top_p=top_p)
    u = _uniforms(stream, step, vmix)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))


def _put_row(cache, row_cache, slot: torch.Tensor) -> None:
    """Every leaf's row ``slot`` (a (1,) index) of ``cache`` from the
    (1, ...) ``row_cache``, in place."""
    _tree_map2(lambda b, r: b.index_copy_(0, slot, r.to(b.dtype)), cache,
               row_cache)


def _write_at(buf: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
              can: torch.Tensor) -> None:
    """``buf[b, pos[b]] = val[b]`` where ``can[b]``, in place."""
    p = pos[:, None]
    old = buf.gather(1, p)
    buf.scatter_(1, p, torch.where(can[:, None], val[:, None].to(buf.dtype),
                                   old))


class _Request:
    def __init__(self, rid, slot, prompt_len, max_new, eos):
        self.rid = rid
        self.slot = slot
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.eos = eos
        self.generated: List[int] = []
        self.done = False
        # telemetry timestamps (engine clock): queue entry, slot
        # admission, first emitted token, finish
        self.t_submit: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_finish: Optional[float] = None


def _require_dropless(model) -> None:
    """Capacity-bounded MoE routing would make a request's tokens depend
    on what else shares the batch, breaking the batch-independence
    contract: the JAX engines' check that every MoE layer is dropless."""
    from .parallel.expert_parallel import ExpertParallelMLP
    for mod in model.modules():
        if (isinstance(mod, ExpertParallelMLP)
                and mod.capacity_factor < mod.n_experts):
            raise ValueError(
                f"MoE layer with capacity_factor={mod.capacity_factor} < "
                f"n_experts={mod.n_experts} can drop tokens depending on "
                f"batch contents; serve dropless (capacity_factor >= "
                f"n_experts) to keep requests batch-independent")


def _metric_state(m) -> Dict[str, Any]:
    """A copy of a metric's fields, its labelled children's too (the
    locks are left out)."""
    out = {k: copy.deepcopy(v) for k, v in vars(m).items()
           if k not in ("_lock", "_children")}
    out["_children"] = {key: _metric_state(c)
                        for key, c in m.children().items()}
    return out


def _set_metric_state(m, fields: Dict[str, Any]) -> None:
    """Write ``_metric_state``'s copy back; children made since are
    dropped."""
    children = m.children()
    vars(m).update({k: v for k, v in fields.items() if k != "_children"})
    m._children = {key: children[key] for key in fields["_children"]}
    for key, child in fields["_children"].items():
        _set_metric_state(m._children[key], child)


class _SlotScheduler:
    """Request-lifecycle machinery shared by the engines: slot
    bookkeeping, the FIFO submit queue, result harvesting, telemetry and
    the graphs' bookkeeping.  Subclasses provide ``_admit(rid, prompt,
    max_new, eos, seed, temperature)`` (claim ``self._free.pop()`` and
    seed device state), ``_check_prompt(prompt)`` and ``step()``."""

    def _init_scheduler(self, slots: int,
                        metrics: Optional[MetricsRegistry] = None):
        self._free = list(range(slots))
        self._waiting: List[Any] = []
        self._by_slot: Dict[int, _Request] = {}
        self._finished: Dict[int, _Request] = {}
        self._next_rid = 0
        self._clock = time.perf_counter
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._submit_ts: Dict[int, float] = {}
        # rid -> tenant tag, stamped on the engine's queue/prefill spans
        self._tenant_tags: Dict[int, str] = {}
        # engine-LOCAL totals for stats() (a shared registry's counters
        # would conflate other engines' traffic)
        self._n_admitted = 0
        self._n_tokens = 0
        self._n_steps = 0
        self._n_syncs = 0
        self._n_preempted = 0
        self._last_util = 0.0
        self.window = int(getattr(self, "window", 1))
        self._m_prefill = self.metrics.histogram(
            "engine_prefill_seconds",
            help="admission latency: prompt prefill + slot seed")
        self._m_decode = self.metrics.histogram(
            "engine_decode_step_seconds",
            help="per-TOKEN decode latency: one window's wall time "
                 "(incl. the host fetch) / tokens it emitted")
        self._m_queue_wait = self.metrics.histogram(
            "engine_queue_wait_seconds",
            help="submit-to-admission wait in the FIFO queue")
        self._m_ttft = self.metrics.histogram(
            "engine_ttft_seconds",
            help="submit to first emitted token, per request")
        self._m_tps = self.metrics.histogram(
            "engine_request_tokens_per_sec", buckets=_TPS_BUCKETS,
            help="generated tokens/sec per finished request")
        self._m_admitted = self.metrics.counter("engine_admitted_total")
        self._m_finished = self.metrics.counter("engine_finished_total")
        self._m_tokens = self.metrics.counter("engine_tokens_total")
        self._m_steps = self.metrics.counter(
            "engine_decode_steps_total",
            help="device decode dispatches (one per window, NOT per "
                 "token)")
        self._m_syncs = self.metrics.counter(
            "engine_host_syncs_total",
            help="device->host result fetches the decode loop paid "
                 "(one per window; 1/window per token when full)")
        self.metrics.gauge(
            "engine_window_size",
            help="in-graph decode ticks per host round trip").set(
            float(self.window))
        self._set_kv_gauges()

    # -- the graphs --------------------------------------------------------
    def _init_graphs(self, device: torch.device):
        """Graph bookkeeping: each graph with its census name; the
        engine's graphs share one pool."""
        self.device = device
        self._graphs: Dict[CapturedFn, str] = {}
        self._pool = (torch.cuda.graph_pool_handle()
                      if device.type == "cuda" else None)

    def _graph(self, name: str, fn: Callable[[], None]) -> CapturedFn:
        def run():
            with torch.no_grad():
                fn()
        g = CapturedFn(run, self.device, pool=self._pool)
        self._graphs[g] = name
        return g

    @property
    def captures(self) -> Dict[str, int]:
        """The graphs captured so far, counted by census name."""
        out: Dict[str, int] = {}
        for g, name in self._graphs.items():
            if g.graph is not None:
                out[name] = out.get(name, 0) + 1
        return out

    def uncaptured(self) -> List[str]:
        """Census names of the graphs a ``step()`` may still capture (none
        on the CPU): those not captured yet, less the prefix pool's
        seeding, which only ``register_prefix`` runs.  A capture must
        meet no other thread's CUDA work, so a fleet steps a replica that
        names one alone, never on its step pool beside another replica."""
        census = self.compile_census()
        return sorted({name for g, name in self._graphs.items()
                       if g.may_capture
                       and census.get(name) != "register_prefix"})

    def _to_device(self, dst: torch.Tensor, values) -> None:
        """``dst`` from host ``values`` in one copy: pinned and
        asynchronous on the card (the host allocator keeps the staging
        block until the copy has run), so admission never waits for the
        device."""
        src = torch.as_tensor(values, dtype=dst.dtype)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=dst.is_cuda)

    def _fetch(self, buf: torch.Tensor) -> np.ndarray:
        """THE host read of a window: one device-to-host copy."""
        return buf.cpu().numpy()

    # -- lifecycle ---------------------------------------------------------
    def _admit_timed(self, rid, *rest, refresh_kv=True):
        """All admissions route through here: times the prefill/seed,
        stamps the request's lifecycle timestamps, feeds the admission
        histograms."""
        t0 = self._clock()
        tenant = self._tenant_tags.get(rid)
        with maybe_span("engine_prefill", engine_rid=rid,
                        **({"tenant": tenant} if tenant is not None
                           else {})):
            self._admit(rid, *rest)
        t1 = self._clock()
        self._m_prefill.observe(t1 - t0)
        self._m_admitted.inc()
        self._n_admitted += 1
        req = next((r for r in self._by_slot.values() if r.rid == rid),
                   None)
        if req is not None:
            req.t_submit = self._submit_ts.pop(rid, t0)
            req.t_admit = t1
            self._m_queue_wait.observe(max(t0 - req.t_submit, 0.0))
        if refresh_kv:
            self._set_kv_gauges()

    def _record_step(self, t0: float, tokens: int = 1,
                     capacity: int = 0) -> float:
        """Per-dispatch bookkeeping after the host read; returns `now`."""
        now = self._clock()
        self._m_decode.observe((now - t0) / max(tokens, 1))
        self._m_steps.inc()
        self._n_steps += 1
        self._m_syncs.inc()
        self._n_syncs += 1
        if capacity > 0:
            self._last_util = tokens / capacity
            self.metrics.gauge(
                "engine_window_utilization",
                help="tokens emitted / (live slots * window size) of "
                     "the last dispatch").set(self._last_util)
        self.metrics.gauge("engine_live").set(len(self._by_slot))
        self.metrics.gauge("engine_queue_depth").set(len(self._waiting))
        self.metrics.gauge("engine_occupancy").set(
            len(self._by_slot) / self.slots)
        return now

    def _harvest(self, emitted, t0):
        """Post-dispatch harvest: per-token metrics, first-token stamps,
        EOS truncation (the speculative path's accepted run can cross the
        EOS), finish + freeze of done slots, queue drain.  ``emitted``
        maps every live slot to the tokens its request emitted."""
        n_emitted = sum(len(t) for t in emitted.values())
        now = self._record_step(t0, tokens=n_emitted,
                                capacity=len(emitted) * self.window)
        out: Dict[int, Any] = {}
        for slot, req in list(self._by_slot.items()):
            toks = emitted[slot]
            if req.eos is not None and req.eos in toks:
                toks = toks[:toks.index(req.eos) + 1]
            req.generated.extend(toks)
            if toks:
                out[req.rid] = list(toks)
                if req.t_first is None:
                    req.t_first = now
                self._m_tokens.inc(len(toks))
                self._n_tokens += len(toks)
            hit_eos = req.eos is not None and req.eos in toks
            if hit_eos or self._out_of_budget(req):
                self._finish(slot, req)
                self._freeze_slot(slot)
        self._drain_queue()
        self._set_kv_gauges()
        return out

    def _check_request(self, prompt, max_new_tokens, seed, temperature):
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if seed is not None and not self._supports_seed:
            raise ValueError("per-request seed is only meaningful for "
                             "the sampled decoder-only Engine")
        if temperature is not None:
            if not self._supports_temperature:
                raise ValueError(
                    "per-request temperature needs an engine built "
                    "with temperature > 0 (the sampled tick); greedy "
                    "and speculative engines have no override point")
            if not (temperature >= 0):    # also rejects NaN
                raise ValueError(f"temperature must be >= 0, got "
                                 f"{temperature}")
        self._check_prompt(prompt)

    _supports_seed = False
    _supports_temperature = False
    accepts_tenant = True
    # "fixed_slot" (a buf_len row per slot) or "paged" (block pool)
    admission_mode = "fixed_slot"

    def _can_admit_direct(self, prompt, max_new_tokens) -> bool:
        return bool(self._free)

    def add_request(self, prompt: Sequence[int], max_new_tokens: int,
                    eos_token_id: Optional[int] = None,
                    seed: Optional[int] = None,
                    temperature: Optional[float] = None,
                    tenant: Optional[str] = None) -> int:
        """Claim a slot, seed it, return the request id.  Raises if no
        slot is free (``submit`` queues instead).  ``seed`` names a
        request-intrinsic sampling stream and ``temperature`` overrides
        the engine's for THIS request (0.0 = the argmax row), both on
        sampled engines only; ``tenant`` is an observability tag."""
        if not self._free:
            raise RuntimeError("no free slot; harvest finished "
                               "requests, use submit(), or add "
                               "capacity")
        self._check_request(prompt, max_new_tokens, seed, temperature)
        rid = self._next_rid
        self._next_rid += 1
        if tenant is not None:
            self._tenant_tags[rid] = str(tenant)
        self._submit_ts.setdefault(rid, self._clock())
        self._admit_timed(rid, prompt, max_new_tokens, eos_token_id, seed,
                          temperature)
        return rid

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               seed: Optional[int] = None,
               temperature: Optional[float] = None,
               tenant: Optional[str] = None) -> int:
        """``add_request`` that QUEUES when the engine is full; queued
        requests are admitted in arrival order as slots free."""
        self._check_request(prompt, max_new_tokens, seed, temperature)
        if not self._waiting and self._can_admit_direct(prompt,
                                                        max_new_tokens):
            return self.add_request(prompt, max_new_tokens,
                                    eos_token_id, seed, temperature,
                                    tenant=tenant)
        rid = self._next_rid
        self._next_rid += 1
        if tenant is not None:
            self._tenant_tags[rid] = str(tenant)
        self._submit_ts[rid] = self._clock()
        self._waiting.append((rid, list(prompt), max_new_tokens,
                              eos_token_id, seed, temperature))
        self._set_queue_gauge()
        maybe_event("engine_queue", engine_rid=rid,
                    queue_depth=len(self._waiting),
                    **({"tenant": str(tenant)} if tenant is not None
                       else {}))
        return rid

    def _set_queue_gauge(self):
        self.metrics.gauge("engine_queue_depth").set(len(self._waiting))

    def _drain_queue(self):
        admitted = False
        while self._free and self._waiting:
            self._admit_timed(*self._waiting.pop(0), refresh_kv=False)
            admitted = True
        self._set_queue_gauge()
        if admitted:
            self._set_kv_gauges()

    def take_waiting(self) -> List[tuple]:
        """Pop and return the whole waiting queue (FIFO) as ``(rid,
        prompt, max_new_tokens, eos_token_id, seed, temperature)``
        tuples; the caller owns re-submission."""
        taken, self._waiting = self._waiting, []
        for rid, *_ in taken:
            self._submit_ts.pop(rid, None)
            self._tenant_tags.pop(rid, None)
        self._set_queue_gauge()
        return taken

    def free_slots(self) -> int:
        return len(self._free)

    def queue_depth(self) -> int:
        return len(self._waiting)

    def is_finished(self, rid: int) -> bool:
        return rid in self._finished

    def cancel(self, rid: int) -> bool:
        """Abandon a request: a waiting one leaves the queue, a live one
        frees its slot and freezes on the device (its tokens never enter
        ``result()``).  False for unknown or finished rids."""
        for i, item in enumerate(self._waiting):
            if item[0] == rid:
                del self._waiting[i]
                self._submit_ts.pop(rid, None)
                self._tenant_tags.pop(rid, None)
                self._set_queue_gauge()
                return True
        for slot, req in list(self._by_slot.items()):
            if req.rid == rid:
                self._tenant_tags.pop(rid, None)
                del self._by_slot[slot]
                self._free.append(slot)
                self._freeze_slot(slot)
                self.metrics.gauge("engine_live").set(len(self._by_slot))
                self.metrics.gauge("engine_occupancy").set(
                    len(self._by_slot) / self.slots)
                self._set_kv_gauges()
                return True
        return False

    def preempt(self, rid: int) -> bool:
        """Evict a request (mechanically :meth:`cancel`, counted as
        ``preempted``); the caller re-queues it from its prompt."""
        ok = self.cancel(rid)
        if ok:
            self._n_preempted += 1
            self.metrics.counter(
                "engine_preempted_total",
                help="requests evicted mid-decode by the fleet QoS "
                     "plane (slot freed, KV blocks recycled)").inc()
        return ok

    def _finish(self, slot, req):
        req.done = True
        req.t_finish = self._clock()
        self._tenant_tags.pop(req.rid, None)
        del self._by_slot[slot]
        self._free.append(slot)
        self._finished[req.rid] = req
        self._m_finished.inc()
        if req.t_first is not None and req.t_submit is not None:
            self._m_ttft.observe(req.t_first - req.t_submit)
        if req.generated and req.t_admit is not None:
            dur = req.t_finish - req.t_admit
            if dur > 0:
                self._m_tps.observe(len(req.generated) / dur)

    def result(self, rid: int) -> List[int]:
        """Generated tokens (incl. EOS if hit) for a finished request."""
        return list(self._finished[rid].generated)

    def live(self) -> int:
        return len(self._by_slot)

    def compile_census(self) -> Dict[str, str]:
        """Every graph this engine's configuration captures, under the
        JAX package's compile-census names, mapped to the lifecycle stage
        that first runs it (``admission`` / ``decode`` during
        :meth:`warmup`; ``register_prefix`` / ``prefix_admission`` when
        the prefix pool is used)."""
        return {}

    def _warm_traffic(self):
        """The JAX package's warmup traffic: one throwaway request
        through the census's admission and decode entries."""
        rid = self.add_request([0], max_new_tokens=1)
        while not self.is_finished(rid):
            self.step()
        self._finished.pop(rid, None)

    def _warm_extra(self):
        """Throwaway traffic past the JAX package's, for graphs its
        warmup does not reach (none here)."""

    def _rewind_state(self):
        """The request-id counter, the engine's totals (its ``_n_*``
        attributes and ``prefix_hits``) and its metrics, to rewind to."""
        totals = {k: v for k, v in vars(self).items()
                  if k.startswith("_n_") or k in ("prefix_hits",
                                                  "_last_util")}
        return (self._next_rid, totals,
                {name: _metric_state(m)
                 for name, m in self.metrics._metrics.items()})

    def _rewind(self, state):
        rid, totals, metrics = state
        self._next_rid = rid
        vars(self).update(totals)
        for name, fields in metrics.items():
            _set_metric_state(self.metrics._metrics[name], fields)

    def warmup(self):
        """Capture the engine's admission and decode graphs before
        traffic: the JAX package's throwaway traffic, then a second round
        of it (call 1 of a graph is its eager warm-up, call 2 its
        capture) and whatever traffic reaches the graphs it does not.
        Afterwards the request ids, the totals of ``stats()`` and the
        metrics are rewound to where the JAX engine's stand after its
        warmup: the next request gets the rid it would get there, and no
        rid-keyed stream sees the extra rounds.  Requires an idle engine;
        the requests are scrubbed from ``result()``.  Returns ``self``."""
        if self._by_slot or self._waiting:
            raise RuntimeError(
                "warmup() needs an idle engine (no live or queued "
                "requests); warm before traffic")
        self._warm_traffic()
        state = self._rewind_state()
        self._warm_extra()
        self._warm_traffic()
        self._warm_extra()
        self._rewind(state)
        self._set_kv_gauges()
        return self

    def _kv_buffers(self):
        return []

    def kv_cache_bytes(self) -> int:
        """Device bytes held by this engine's KV buffers (slot caches,
        draft caches, prefix-pool rows; the block pool; seq2seq slot
        state), recomputed from the live buffers."""
        return sum(_tree_nbytes(buf) for buf in self._kv_buffers())

    # -- KV fragmentation ledger: host mirrors and leaf sizes only -------
    def _kv_usage(self):
        return [], []

    def kv_fragmentation(self) -> Dict[str, Any]:
        """Allocated / used / wasted KV bytes, the utilization, and one
        entry per slot (and prefix-pool row)."""
        total = self.kv_cache_bytes()
        slots, pools = self._kv_usage()
        used = min(int(sum(e["used_bytes"] for e in slots)
                       + sum(e["used_bytes"] for e in pools)), total)
        return {"kv_cache_bytes": total,
                "kv_used_bytes": used,
                "kv_waste_bytes": total - used,
                "kv_utilization": (used / total if total else 0.0),
                "slots": slots, "pools": pools}

    def kv_waste_bytes(self) -> int:
        return self.kv_fragmentation()["kv_waste_bytes"]

    def kv_utilization(self) -> float:
        return self.kv_fragmentation()["kv_utilization"]

    def _set_kv_gauges(self) -> Dict[str, Any]:
        frag = self.kv_fragmentation()
        self.metrics.gauge(
            "engine_kv_waste_bytes",
            help="allocated-but-unused KV bytes (slot capacity beyond "
                 "cur_len, free slots, empty pool rows)").set(
            frag["kv_waste_bytes"])
        self.metrics.gauge(
            "engine_kv_utilization",
            help="used / allocated KV bytes of this engine's "
                 "buffers").set(frag["kv_utilization"])
        return frag

    def _memory(self) -> Dict[str, Optional[int]]:
        """Device memory on the card: the caching allocator's allocated
        bytes (``device_live_bytes``), what it holds from the device,
        graph pools included (``hbm_bytes_in_use``), and the card's
        total; None on the CPU."""
        dev = getattr(self, "device", torch.device("cpu"))
        if dev.type != "cuda":
            return {"live": None, "in_use": None, "limit": None}
        return {"live": int(torch.cuda.memory_allocated(dev)),
                "in_use": int(torch.cuda.memory_stats(dev).get(
                    "reserved_bytes.all.current", 0)),
                "limit": int(torch.cuda.get_device_properties(
                    dev).total_memory)}

    def stats(self) -> Dict[str, Any]:
        """Scheduler + telemetry snapshot, the JAX engines' keys: counts,
        occupancy, totals, latency-histogram summaries ({count, sum,
        mean, p50, p99}), the KV ledger's bytes and the device memory
        fields (None on the CPU)."""
        frag = self._set_kv_gauges()
        kv = frag["kv_cache_bytes"]
        self.metrics.gauge(
            "engine_kv_cache_bytes",
            help="device bytes held by this engine's KV buffers"
        ).set(kv)
        mem = self._memory()
        if mem["live"] is not None:
            self.metrics.gauge(
                "device_live_bytes",
                help="bytes the device allocator holds for live "
                     "tensors").set(mem["live"])
        occupancy = (mem["in_use"] / mem["limit"] if mem["limit"]
                     else None)
        return {"live": len(self._by_slot),
                "admission_mode": self.admission_mode,
                "kv_cache_bytes": kv,
                "kv_waste_bytes": frag["kv_waste_bytes"],
                "kv_utilization": frag["kv_utilization"],
                "device_live_bytes": mem["live"],
                "hbm_bytes_in_use": mem["in_use"],
                "hbm_bytes_limit": mem["limit"],
                "hbm_occupancy": occupancy,
                "waiting": len(self._waiting),
                "free": len(self._free),
                "finished": len(self._finished),
                "slots": self.slots,
                "occupancy": len(self._by_slot) / self.slots,
                "queue_depth": len(self._waiting),
                "admitted": self._n_admitted,
                "preempted": self._n_preempted,
                "tokens_generated": self._n_tokens,
                "decode_steps": self._n_steps,
                "window": self.window,
                "host_syncs": self._n_syncs,
                "window_utilization": self._last_util,
                "tokens_per_sync": (self._n_tokens / self._n_syncs
                                    if self._n_syncs else 0.0),
                "prefill_latency": self._m_prefill.summary(),
                "decode_step_latency": self._m_decode.summary(),
                "queue_wait": self._m_queue_wait.summary(),
                "ttft": self._m_ttft.summary(),
                "request_tokens_per_sec": self._m_tps.summary()}


class _Sampler:
    """The sampled tick's per-slot stream state: temperatures, stream
    words and own step counts, static tensors."""

    def _init_sampler(self, slots, device, temperature, top_k, top_p, rng,
                      vocab):
        self.temperature = float(temperature)
        self.top_k, self.top_p = top_k, top_p
        self._key = int(rng) if rng is not None else 0
        self._temps = torch.full((slots,), float(temperature),
                                 dtype=torch.float32, device=device)
        self._stream = torch.zeros((slots,), dtype=torch.int64,
                                   device=device)
        self._sstep = torch.zeros((slots,), dtype=torch.int64,
                                  device=device)
        self._vmix = _mix32(torch.arange(vocab, dtype=torch.int64,
                                         device=device))

    def _stream_of(self, rid, seed) -> int:
        """Domain-separated: an explicit seed never collides with an
        auto rid; the default stream keys off the rid (deterministic
        given the submission order)."""
        return _stream_word(self._key, 0 if seed is None else 1,
                            rid if seed is None else int(seed))

    def _temp_of(self, temperature) -> float:
        return float(self.temperature if temperature is None
                     else temperature)

    def _pick(self, logits, temps, stream, sstep):
        """The tick's tokens: sampled rows or the argmax."""
        if self.temperature > 0.0:
            return _sample_rows(logits, temps, stream, sstep, self._vmix,
                                self.top_k, self.top_p)
        return torch.argmax(logits, dim=-1)


class Engine(_SlotScheduler, _Sampler):
    def __init__(self, model, slots: int, buf_len: int, cache_dtype=None,
                 draft=None, gamma: int = 4, temperature: float = 0.0,
                 top_k=None, top_p=None, rng: Optional[int] = None,
                 prefix_pool: int = 0, prefix_chunk: int = 32,
                 rolling: bool = False, window: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        """The fixed-slot engine: ``slots`` sequences of ``buf_len``
        positions, each with its row of the model's (slots, Hkv, S, D)
        caches.  Admission prefills the prompt with one full-buffer
        forward into a (1, ...) row cache and copies it into the slot.

        ``draft`` switches ``step()`` to SPECULATIVE decoding: one
        ``spec_iteration`` per step (1..gamma+1 tokens a request), each
        request's tokens its solo greedy decode.  ``temperature > 0``
        samples (plain path only).  ``prefix_pool > 0`` enables prefix
        sharing: ``register_prefix(tokens)`` prefills a pool row once; a
        prompt starting with a registered prefix admits by copying that
        row, running only the suffix through ``decode_chunk`` in
        ``prefix_chunk``-wide chunks, and copying the row into its slot.
        ``rolling=True`` serves a sliding-window model with ring caches
        of the window's width.  ``window=K`` runs K decode ticks a
        ``step()``."""
        self.model = model
        self.slots = slots
        self.buf_len = buf_len
        self.draft = draft
        self.gamma = gamma
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if self.window > 1 and draft is not None:
            raise NotImplementedError(
                "windowed decode + speculative is not wired "
                "(spec_iteration already amortizes the host sync over "
                "up to gamma+1 tokens per tick); use window=1 with a "
                "draft")
        if temperature > 0.0 and draft is not None:
            raise NotImplementedError(
                "sampled speculative engine ticks are not wired; use "
                "greedy speculation or the plain sampled path")
        _require_dropless(model)
        if cache_dtype is None:
            cache_dtype = _table_dtype(model)
        self.rolling = rolling
        if rolling:
            if draft is not None:
                raise NotImplementedError(
                    "rolling + speculative is not wired (verify needs "
                    "L>1 chunks over the ring)")
            if prefix_pool:
                raise NotImplementedError(
                    "rolling + prefix_pool is not wired")
            self._window = getattr(model.cfg, "sliding_window", None)
            if not self._window:
                raise ValueError("rolling=True requires a model with "
                                 "sliding_window set")
            if cache_dtype == torch.int8:
                raise NotImplementedError(
                    "rolling + int8 cache is not wired (admission "
                    "parity with the solo step-prefill path)")
        if prefix_chunk < 1:
            raise ValueError(f"prefix_chunk must be >= 1, got "
                             f"{prefix_chunk}")
        dev = _model_device(model)
        self._init_graphs(dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.ids = torch.zeros((slots, buf_len), **i64)
        self.cur_len = torch.zeros((slots,), **i64)
        # limit doubles as the liveness source: _finish zeroes it, so
        # cur_len < limit is exactly "this slot is serving a request"
        self.limit = torch.zeros((slots,), **i64)
        self._eos = torch.full((slots,), -1, **i64)
        self._init_sampler(slots, dev, temperature, top_k, top_p, rng,
                           model.cfg.vocab_size)
        self.cache = (model.init_cache(slots, dtype=cache_dtype,
                                       rolling=True) if rolling
                      else model.init_cache(slots, dtype=cache_dtype))
        self.d_cache = (draft.init_cache(slots, dtype=cache_dtype)
                        if draft is not None else None)
        # admission input: [slot, plen, limit, eos, stream, pool index,
        # row...] and the temperature, one host copy each
        self._adm = torch.zeros((6 + buf_len,), **i64)
        self._adm_t = torch.zeros((1,), dtype=torch.float32, device=dev)
        self._adm_slot = self._adm[0:1]
        self._adm_pidx = self._adm[5:6]
        self._adm_row = self._adm[6:]
        # the (1, ...) caches a prefill or a splice writes before the
        # copy into a slot (positions past buf_len stay zero)
        self._row_cache = model.init_cache(1, dtype=cache_dtype)
        self._row_dcache = (draft.init_cache(1, dtype=cache_dtype)
                            if draft is not None else None)
        self._init_scheduler(slots, metrics)

        def _prefill_slot():
            row = self._adm_row[None, :]
            model.prefill_cache(row, self._row_cache)
            _put_row(self.cache, self._row_cache, self._adm_slot)
            if draft is not None:
                draft.prefill_cache(row, self._row_dcache)
                _put_row(self.d_cache, self._row_dcache, self._adm_slot)

        if rolling:
            W = self._window

            def _prefill_slot_rolling():
                """Full-width single-row prefill, then the last W
                positions relayouted into the ring (slot j <- the
                largest position p < plen with p % W == j; unwritten
                slots zero)."""
                model.prefill_cache(self._adm_row[None, :],
                                    self._row_cache)
                plen = self._adm[1]
                j = torch.arange(W, device=dev)
                p_j = plen - 1 - ((plen - 1 - j) % W)
                gather = torch.clamp(p_j, min=0)

                def relayout(b, fb):
                    ring = fb[0].index_select(1, gather)
                    ring = torch.where((p_j >= 0)[None, :, None], ring,
                                       torch.zeros_like(ring))
                    b.index_copy_(0, self._adm_slot,
                                  ring[None].to(b.dtype))

                _tree_map2(relayout, self.cache, self._row_cache)

            self._prefill = self._graph("engine._prefill_slot_rolling",
                                        _prefill_slot_rolling)
        else:
            self._prefill = self._graph("engine._prefill_slot",
                                        _prefill_slot)

        # -- prefix-sharing pool ------------------------------------------
        self.prefix_pool = prefix_pool
        self.prefix_chunk = min(prefix_chunk, buf_len)
        self.prefix_hits = 0
        self._prefixes: List[tuple] = []
        if prefix_pool > 0:
            self._pool_cache = model.init_cache(prefix_pool,
                                                dtype=cache_dtype)
            self._pool_d_cache = (draft.init_cache(prefix_pool,
                                                   dtype=cache_dtype)
                                  if draft is not None else None)
            C = self.prefix_chunk
            self._chunk_off = torch.zeros((1,), **i64)
            ar_c = torch.arange(C, device=dev)

            def _seed_pool():
                row = self._adm_row[None, :]
                model.prefill_cache(row, self._row_cache)
                _put_row(self._pool_cache, self._row_cache,
                         self._adm_pidx)
                if draft is not None:
                    draft.prefill_cache(row, self._row_dcache)
                    _put_row(self._pool_d_cache, self._row_dcache,
                             self._adm_pidx)

            self._seed_pool = self._graph("engine._seed_pool", _seed_pool)
            # per cache (target, draft): the pool row into the row cache,
            # a suffix chunk on the row cache, the row into the slot
            self._splice = {}
            for attr, pool_attr, rc, m, name in (
                    ("cache", "_pool_cache", self._row_cache, model,
                     "engine._chunk_row"),
                    ("d_cache", "_pool_d_cache", self._row_dcache, draft,
                     "engine._chunk_row_draft")):
                if m is None:
                    continue

                def take(pool_attr=pool_attr, rc=rc):
                    _tree_map2(lambda r, b: r.copy_(b.index_select(
                        0, self._adm_pidx)), rc, getattr(self, pool_attr))

                def chunk(rc=rc, m=m):
                    off = self._chunk_off
                    toks = self._adm_row.gather(0, off + ar_c)[None, :]
                    m.decode_chunk(toks, off, rc)

                def put(attr=attr, rc=rc):
                    _put_row(getattr(self, attr), rc, self._adm_slot)

                self._splice[attr] = (self._graph("engine._take_row", take),
                                      self._graph(name, chunk),
                                      self._graph("engine._put_row", put))

        if draft is not None:
            # [old_len, new_len, ids...]: the speculative step's one read
            self._sout = torch.zeros((2 * slots + slots * buf_len,), **i64)

            def _sstep():
                cur = self.cur_len
                self._sout[:slots].copy_(cur)
                # a never-used slot (cur_len 0) steps from position 0,
                # not -1; it is inactive, so nothing of it is kept
                ids2, new_len, _, _ = spec_iteration(
                    model, draft, self.ids, torch.clamp(cur, min=1),
                    self.limit, self.ids, self.cache, self.d_cache, gamma)
                new_len = torch.where(cur < self.limit, new_len, cur)
                self.ids.copy_(ids2)
                self.cur_len.copy_(new_len)
                self._sout[slots:2 * slots].copy_(new_len)
                self._sout[2 * slots:].copy_(ids2.reshape(-1))

            self._decode = self._graph("engine._sstep", _sstep)
        else:
            K = self.window
            # the window's output: [tokens (slots, K), valid (slots, K)]
            self._out = torch.zeros((2 * slots * K,), **i64)

            def _step_k():
                """K decode ticks.  A per-slot active mask freezes a slot
                that emits its EOS or reaches its limit for the rest of
                the window (ids, cur_len, cache and stream stop
                advancing)."""
                cur, sstep = self.cur_len, self._sstep
                alive = cur < self.limit
                toks, valid = [], []
                for _ in range(K):
                    pos = torch.clamp(cur - 1, min=0)
                    tok_in = self.ids.gather(1, torch.clamp(
                        pos, 0, buf_len - 1)[:, None])
                    # frozen/garbage slots recompute the KV their
                    # position already holds: the write is idempotent
                    h, _ = model.decode_chunk(tok_in, pos, self.cache)
                    logits = _head_logits(model, h)[:, 0]
                    nxt = self._pick(logits, self._temps, self._stream,
                                     sstep)
                    if self.temperature > 0.0:
                        sstep = torch.where(alive, sstep + 1, sstep)
                    can = alive & (cur < buf_len)
                    _write_at(self.ids, torch.clamp(cur, max=buf_len - 1),
                              nxt, can)
                    new_len = torch.where(can, cur + 1, cur)
                    toks.append(nxt)
                    valid.append(alive)
                    hit_eos = (self._eos >= 0) & (nxt == self._eos)
                    alive = alive & ~hit_eos & (new_len < self.limit)
                    cur = new_len
                self.cur_len.copy_(cur)
                self._sstep.copy_(sstep)
                self._out.copy_(torch.cat([
                    torch.stack(toks, 1).reshape(-1),
                    torch.stack(valid, 1).reshape(-1).long()]))

            self._decode = self._graph("engine._step_k", _step_k)
        self._set_kv_gauges()

    # -- request lifecycle -------------------------------------------------
    def register_prefix(self, tokens: Sequence[int]) -> int:
        """Prefill ``tokens`` into a prefix-pool row once; later prompts
        starting with them admit via KV splice + suffix-only prefill.
        Returns the pool index."""
        if self.prefix_pool == 0:
            raise RuntimeError("Engine built with prefix_pool=0")
        if len(self._prefixes) >= self.prefix_pool:
            raise RuntimeError(f"prefix pool full "
                               f"({self.prefix_pool} rows)")
        self._check_prompt(tokens)
        idx = len(self._prefixes)
        self._load_admission(0, tokens, 0, -1, 0, idx, 0.0)
        self._seed_pool()
        self._prefixes.append(tuple(int(t) for t in tokens))
        self._set_kv_gauges()
        return idx

    def _match_prefix(self, prompt):
        """(pool_idx, L) of the longest registered prefix the prompt
        starts with, or (None, 0)."""
        best, best_len = None, 0
        pt = tuple(int(t) for t in prompt)
        for i, pref in enumerate(self._prefixes):
            if len(pref) > best_len and len(pref) <= len(pt) \
                    and pt[:len(pref)] == pref:
                best, best_len = i, len(pref)
        return best, best_len

    @property
    def _supports_seed(self):
        return self.temperature > 0.0 and self.draft is None

    @property
    def _supports_temperature(self):
        return self.temperature > 0.0 and self.draft is None

    def _load_admission(self, slot, prompt, lim, eos, stream, pidx, temp):
        row = np.zeros((6 + self.buf_len,), np.int64)
        row[:6] = (slot, len(prompt), lim, eos, stream, pidx)
        row[6:6 + len(prompt)] = prompt
        self._to_device(self._adm, row)
        self._to_device(self._adm_t, [temp])

    def _seat(self):
        """The admitted slot's scalar state and ids row, from the
        admission input."""
        s = self._adm_slot
        for vec, j in ((self.cur_len, 1), (self.limit, 2), (self._eos, 3),
                       (self._stream, 4)):
            vec.index_copy_(0, s, self._adm[j:j + 1])
        self._sstep.index_fill_(0, s, 0)
        self._temps.index_copy_(0, s, self._adm_t)
        self.ids.index_copy_(0, s, self._adm_row[None, :])

    def _admit(self, rid, prompt, max_new_tokens, eos_token_id,
               seed=None, temperature=None):
        slot = self._free.pop()
        pidx, L = (self._match_prefix(prompt) if self._prefixes
                   else (None, 0))
        self._load_admission(
            slot, prompt, min(len(prompt) + max_new_tokens, self.buf_len),
            -1 if eos_token_id is None else int(eos_token_id),
            self._stream_of(rid, seed), 0 if pidx is None else pidx,
            self._temp_of(temperature))
        if pidx is not None and not self.rolling:
            # splice: the pool row, only the suffix [L, prompt_len)
            # through decode_chunk on it, the row into the slot
            self.prefix_hits += 1
            self.metrics.counter("engine_prefix_hits_total").inc()
            C = self.prefix_chunk
            for take, chunk, put in self._splice.values():
                take()
                off = L
                while off < len(prompt):
                    # slide the last chunk back instead of shrinking it:
                    # one captured width, the overlap recompute is
                    # idempotent
                    start = min(off, self.buf_len - C)
                    self._chunk_off.fill_(start)
                    chunk()
                    off = start + C
                put()
        else:
            self._prefill()
        self._seat()
        self._by_slot[slot] = _Request(rid, slot, len(prompt),
                                       max_new_tokens, eos_token_id)

    def _check_prompt(self, prompt):
        if len(prompt) < 1 or len(prompt) >= self.buf_len:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"[1, {self.buf_len})")

    def step(self) -> Dict[int, Any]:
        """One decode dispatch, a WINDOW of ``window`` ticks (or one
        speculative round): {request_id: [tokens]} for every live request
        that emitted; finished requests free their slot, queued arrivals
        admit at the window boundary."""
        if not self._by_slot and self._waiting:
            # cancel() can free every slot without draining the queue
            self._drain_queue()
        if not self._by_slot:
            return {}
        t0 = self._clock()
        live = list(self._by_slot)
        S = self.slots
        with maybe_span("engine_window_decode", window=self.window,
                        live=len(live)):
            self._decode()
            if self.draft is not None:
                out = self._fetch(self._sout)
                old_len, new_len = out[:S], out[S:2 * S]
                rows = out[2 * S:].reshape(S, self.buf_len)
                emitted = {slot: [int(t) for t in
                                  rows[slot, old_len[slot]:new_len[slot]]]
                           for slot in self._by_slot}
            else:
                # THE host read: one fetch a window, not one a token
                out = self._fetch(self._out).reshape(2, S, self.window)
                emitted = {slot: [int(t) for t, v
                                  in zip(out[0, slot], out[1, slot]) if v]
                           for slot in live}
        return self._harvest(emitted, t0)

    def _out_of_budget(self, req):
        return (len(req.generated) >= req.max_new
                or req.prompt_len + len(req.generated) >= self.buf_len)

    def _freeze_slot(self, slot):
        # a slice's fill: an element assignment would copy a host scalar
        # and wait for the device
        self.limit[slot:slot + 1].zero_()

    def _kv_buffers(self):
        bufs = [self.cache]
        for attr in ("d_cache", "_pool_cache", "_pool_d_cache"):
            buf = getattr(self, attr, None)
            if buf is not None:
                bufs.append(buf)
        return bufs

    def _kv_usage(self):
        """Per-slot / per-pool-row occupancy from host mirrors: a live
        request uses ``prompt_len + len(generated)`` positions, capped at
        the slot's capacity (``buf_len``, or the ring's width)."""
        cap = self._window if self.rolling else self.buf_len
        slot_bytes = _tree_nbytes(self.cache)
        if getattr(self, "d_cache", None) is not None:
            slot_bytes += _tree_nbytes(self.d_cache)
        per_pos = slot_bytes / (self.slots * cap) if self.slots else 0.0
        row_bytes = int(round(per_pos * cap))
        slots = []
        for slot in range(self.slots):
            req = self._by_slot.get(slot)
            used_pos = (min(req.prompt_len + len(req.generated), cap)
                        if req is not None else 0)
            used_b = int(round(per_pos * used_pos))
            slots.append({"slot": slot,
                          "rid": req.rid if req is not None else None,
                          "used_positions": used_pos,
                          "capacity_positions": cap,
                          "used_bytes": used_b,
                          "kv_waste_bytes": row_bytes - used_b})
        pools = []
        if getattr(self, "prefix_pool", 0):
            pool_bytes = _tree_nbytes(self._pool_cache)
            if self._pool_d_cache is not None:
                pool_bytes += _tree_nbytes(self._pool_d_cache)
            per_pool_pos = pool_bytes / (self.prefix_pool * self.buf_len)
            pool_row = int(round(per_pool_pos * self.buf_len))
            for i in range(self.prefix_pool):
                used_pos = (min(len(self._prefixes[i]), self.buf_len)
                            if i < len(self._prefixes) else 0)
                used_b = int(round(per_pool_pos * used_pos))
                pools.append({"row": i, "used_positions": used_pos,
                              "capacity_positions": self.buf_len,
                              "used_bytes": used_b,
                              "kv_waste_bytes": pool_row - used_b})
        return slots, pools

    def compile_census(self) -> Dict[str, str]:
        census: Dict[str, str] = {}
        census["engine._prefill_slot_rolling" if self.rolling
               else "engine._prefill_slot"] = "admission"
        census["engine._sstep" if self.draft is not None
               else "engine._step_k"] = "decode"
        if self.prefix_pool > 0:
            census["engine._seed_pool"] = "register_prefix"
            census["engine._take_row"] = "prefix_admission"
            census["engine._put_row"] = "prefix_admission"
            census["engine._chunk_row"] = "prefix_admission"
            if self.draft is not None:
                census["engine._chunk_row_draft"] = "prefix_admission"
        return census

    def stats(self) -> Dict[str, Any]:
        """Base snapshot plus prefix-cache effectiveness."""
        s = super().stats()
        s["prefix_hits"] = self.prefix_hits
        s["prefix_hit_rate"] = (self.prefix_hits / s["admitted"]
                                if s["admitted"] else 0.0)
        return s


class PagedEngine(_SlotScheduler, _Sampler):
    """Paged-KV continuous-batching engine: KV in ONE pool of
    ``num_blocks`` blocks of ``block_size`` positions per cache leaf
    ((num_blocks, Hkv, block_size, D)), a (max_blocks,) block table per
    slot, a LIFO free stack, chunked prefill interleaved with decode
    inside the window, admission at ITERATION boundaries (at most one
    staged request a tick, into a slot freed earlier in the same window),
    and blocks recycled the tick a request dies.

    A request reserves ``ceil(min(prompt + max_new, buf_len) /
    block_size)`` blocks at admission.  Each tick gathers the pool
    through the tables into a dense per-slot view (a torch gather) fed to
    the models' unmodified ``decode_chunk``, and scatters the fresh
    columns back, gated: a lane whose gate is off writes a scratch block
    past the pool, never a block re-handed to another request.  Causality
    makes the dense view exact (junk past a slot's position is masked),
    so the tokens equal the fixed-slot engine's.

    The JAX package skips the chunk-width prefill forward of a tick with
    ``lax.cond`` when no slot is prefilling; a graph cannot branch on
    device data, so the decode window is captured twice: with the gated
    prefill chunk on every tick, and decode only.  The host picks one at
    the window boundary from its mirrors: the prefill window when a
    request is staged or a live request has emitted nothing yet (a slot
    is decode-ready before its first token).  The chunk's writes are
    gated, so the choice moves time, not tokens.

    Not wired (use ``Engine``): speculative drafts, rolling windows,
    prefix pools."""

    admission_mode = "paged"

    def __init__(self, model, slots: int, buf_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 16, cache_dtype=None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 rng: Optional[int] = None, window: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        self.model = model
        self.slots = slots
        self.buf_len = buf_len
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got "
                             f"{block_size}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.block_size = int(block_size)
        self.prefill_chunk = int(min(prefill_chunk, buf_len))
        self.max_blocks = -(-buf_len // self.block_size)
        self.num_blocks = (int(num_blocks) if num_blocks is not None
                           else slots * self.max_blocks)
        if self.num_blocks < self.max_blocks:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold even one "
                f"full-length request ({self.max_blocks} blocks of "
                f"{self.block_size})")
        _require_dropless(model)
        if cache_dtype is None:
            cache_dtype = _table_dtype(model)
        dev = _model_device(model)
        self._init_graphs(dev)
        NB, bs, MB = self.num_blocks, self.block_size, self.max_blocks
        template = model.init_cache(1, dtype=cache_dtype)

        def pool_leaf(leaf):
            if leaf.dim() != 4:
                raise NotImplementedError(
                    "paged KV needs (B, H, S, D)-shaped cache leaves")
            # one scratch block past the pool takes the gated-off writes
            return torch.zeros((NB + 1, leaf.shape[1], bs, leaf.shape[3]),
                               dtype=leaf.dtype, device=dev)

        self._pool_store = {k: {n: pool_leaf(t) for n, t in layer.items()}
                            for k, layer in template.items()}
        del template
        self.pool = {k: {n: t[:NB] for n, t in layer.items()}
                     for k, layer in self._pool_store.items()}
        i64 = dict(dtype=torch.int64, device=dev)
        self.ids = torch.zeros((slots, buf_len), **i64)
        self.cur_len = torch.zeros((slots,), **i64)
        # prompt positions whose KV is written; a slot is decode-ready
        # when kv_len == cur_len - 1
        self.kv_len = torch.zeros((slots,), **i64)
        self.limit = torch.zeros((slots,), **i64)
        self._eos = torch.full((slots,), -1, **i64)
        self.tables = torch.zeros((slots, MB), **i64)
        self.n_blk = torch.zeros((slots,), **i64)
        # LIFO free stack: free_stack[:free_top] are the free block ids
        # (its scratch entry past the end takes the masked pushes)
        self._fs_store = torch.arange(NB + 1, **i64)
        self.free_stack = self._fs_store[:NB]
        self.free_top = torch.full((), NB, **i64)
        self._init_sampler(slots, dev, temperature, top_k, top_p, rng,
                           model.cfg.vocab_size)
        # host mirrors: block headroom and per-slot holdings
        self._free_top_h = NB
        self._slot_nblk_h: Dict[int, int] = {}
        self._n_midwindow = 0
        P, L = slots, buf_len
        # window-boundary admission input: [slot, plen, lim, eos, stream,
        # n_need, row...] and its temperature
        self._adm = torch.zeros((6 + L,), **i64)
        self._adm_t = torch.zeros((1,), dtype=torch.float32, device=dev)
        # the staged pending pack: [count, len, limit, eos, stream,
        # n_need (P each), ids (P, buf_len)] and the temperatures
        self._pend = torch.zeros((1 + 5 * P + P * L,), **i64)
        self._pend_t = torch.zeros((P,), dtype=torch.float32, device=dev)
        K = self.window
        # the window's output: [tokens, valid (slots, K); admitted (K,);
        # free_top]
        self._out = torch.zeros((2 * slots * K + K + 1,), **i64)
        self._init_scheduler(slots, metrics)
        self.metrics.gauge(
            "engine_kv_blocks_total",
            help="KV pool capacity in blocks").set(float(NB))

        S_d = MB * bs            # dense gather width per slot
        C = self.prefill_chunk
        ar_s = torch.arange(slots, device=dev)
        ar_c = torch.arange(C, device=dev)
        jj = torch.arange(MB, device=dev)

        def gather_dense(tables):
            """The pool -> per-slot dense (slots, H, MB*bs, D) views
            through the block tables (stale or padded entries gather junk
            that the causal mask drops)."""
            flat = tables.reshape(-1)

            def g(leaf):
                d = leaf[:NB].index_select(0, flat)
                d = d.view(slots, MB, leaf.shape[1], bs, leaf.shape[3])
                return d.permute(0, 2, 1, 3, 4).reshape(
                    slots, leaf.shape[1], S_d, leaf.shape[3])
            return {k: {n: g(t) for n, t in layer.items()}
                    for k, layer in self._pool_store.items()}

        def scatter_cols(dense, tables, q, gate):
            """The columns ``q`` (slots, L) of the dense views back into
            their blocks; gated-off lanes write the scratch block."""
            blk = torch.clamp(q // bs, 0, MB - 1)
            phys = tables.gather(1, blk)
            phys = torch.where(gate, phys, NB).reshape(-1)
            off = (q % bs).reshape(-1)
            qc = torch.clamp(q, 0, S_d - 1)

            def s(pl, dl):
                H, Dp = pl.shape[1], pl.shape[3]
                idx = qc[:, None, :, None].expand(slots, H, qc.shape[1],
                                                  Dp)
                cols = dl.gather(2, idx)
                vals = cols.permute(0, 2, 1, 3).reshape(-1, H, Dp)
                pl[phys, :, off, :] = vals

            _tree_map2(s, self._pool_store, dense)

        def pop_blocks(free_top, n_need):
            """The top n_need entries of the free stack as a padded
            (max_blocks,) table row (unpopped lanes 0)."""
            src = torch.clamp(free_top - 1 - jj, 0, NB - 1)
            return torch.where(jj < n_need, self._fs_store.index_select(
                0, src), torch.zeros_like(jj))

        def pend(j):
            return self._pend[1 + j * P:1 + (j + 1) * P]

        def at(vec, i):
            return vec.index_select(0, i.reshape(1))[0]

        def window(with_prefill: bool):
            ids, cur, kv = self.ids, self.cur_len, self.kv_len
            lim, eos = self.limit, self._eos
            temps, stream, sstep = self._temps, self._stream, self._sstep
            tables, n_blk, ft = self.tables, self.n_blk, self.free_top
            p_next = torch.zeros((), **i64)
            p_ids = self._pend[1 + 5 * P:].view(P, L)
            toks, valid, adm = [], [], []
            for _ in range(K):
                if with_prefill:
                    # -- admission at the iteration boundary ----------
                    i = torch.clamp(p_next, 0, P - 1)
                    n_need = at(pend(4), i)
                    free_slot = lim == 0
                    can = ((p_next < self._pend[0]) & free_slot.any()
                           & (ft >= n_need))
                    slot = torch.argmax(free_slot.long())
                    onehot = (ar_s == slot) & can
                    trow = pop_blocks(ft, n_need)
                    tables = torch.where(onehot[:, None], trow[None, :],
                                         tables)
                    ft = ft - torch.where(can, n_need, 0)
                    ids = torch.where(onehot[:, None],
                                      p_ids.index_select(0, i.reshape(1)),
                                      ids)
                    cur = torch.where(onehot, at(pend(0), i), cur)
                    kv = torch.where(onehot, 0, kv)
                    lim = torch.where(onehot, at(pend(1), i), lim)
                    eos = torch.where(onehot, at(pend(2), i), eos)
                    temps = torch.where(onehot, at(self._pend_t, i),
                                        temps)
                    stream = torch.where(onehot, at(pend(3), i), stream)
                    sstep = torch.where(onehot, 0, sstep)
                    n_blk = torch.where(onehot, n_need, n_blk)
                    p_next = p_next + can.long()
                    adm.append(torch.where(can, slot, -1))
                else:
                    adm.append(torch.full((), -1, **i64))
                alive = cur < lim
                if with_prefill:
                    # -- chunked prefill, interleaved with decode -----
                    needs_pf = alive & (kv < cur - 1)
                    # a chunk that would run past the dense width slides
                    # back (the overlap recomputes what it holds)
                    pos0 = torch.clamp(torch.clamp(kv, 0, buf_len - 1),
                                       max=S_d - C)
                    qs = pos0[:, None] + ar_c[None, :]
                    ptoks = ids.gather(1, torch.clamp(qs, 0, buf_len - 1))
                    dense = gather_dense(tables)
                    model.decode_chunk(ptoks, pos0, dense)
                    gate = needs_pf[:, None] & (qs < (cur - 1)[:, None])
                    scatter_cols(dense, tables, qs, gate)
                    kv = torch.where(needs_pf,
                                     torch.minimum(kv + C, cur - 1), kv)
                # -- decode tick for every decode-ready slot ---------
                # (against the post-prefill kv_len: a slot whose last
                # chunk landed this tick decodes in the same tick)
                dec_ok = alive & (kv >= cur - 1)
                pos = torch.clamp(cur - 1, min=0)
                tok_in = ids.gather(1, torch.clamp(pos, 0,
                                                   buf_len - 1)[:, None])
                dense = gather_dense(tables)
                h, _ = model.decode_chunk(tok_in, pos, dense)
                scatter_cols(dense, tables, pos[:, None], dec_ok[:, None])
                logits = _head_logits(model, h)[:, 0]
                nxt = self._pick(logits, temps, stream, sstep)
                if self.temperature > 0.0:
                    sstep = torch.where(dec_ok, sstep + 1, sstep)
                wpos = torch.clamp(cur, max=buf_len - 1)[:, None]
                ids = ids.scatter(1, wpos, torch.where(
                    dec_ok[:, None], nxt[:, None], ids.gather(1, wpos)))
                new_len = torch.where(dec_ok, cur + 1, cur)
                # the decode scatter wrote KV at cur_len - 1
                kv = torch.where(dec_ok, cur, kv)
                # -- block recycling on eos/limit --------------------
                hit_eos = dec_ok & (eos >= 0) & (nxt == eos)
                died = dec_ok & (hit_eos | (new_len >= lim))
                freed = torch.where(died, n_blk, 0)
                offs = torch.cumsum(freed, 0) - freed
                push = died[:, None] & (jj[None, :] < n_blk[:, None])
                dest = torch.where(push, ft + offs[:, None] + jj[None, :],
                                   NB)
                self._fs_store[dest.reshape(-1)] = tables.reshape(-1)
                ft = ft + freed.sum()
                lim = torch.where(died, 0, lim)
                n_blk = torch.where(died, 0, n_blk)
                cur = new_len
                toks.append(nxt)
                valid.append(dec_ok)
            for dst, src in ((self.ids, ids), (self.cur_len, cur),
                             (self.kv_len, kv), (self.limit, lim),
                             (self._eos, eos), (self._temps, temps),
                             (self._stream, stream), (self._sstep, sstep),
                             (self.tables, tables), (self.n_blk, n_blk),
                             (self.free_top, ft)):
                if dst is not src:
                    dst.copy_(src)
            self._out.copy_(torch.cat([
                torch.stack(toks, 1).reshape(-1),
                torch.stack(valid, 1).reshape(-1).long(),
                torch.stack(adm), ft.reshape(1)]))

        # one census entry, two graphs (see the class doc)
        self._windows = {
            True: self._graph("engine._paged_step_k",
                              lambda: window(True)),
            False: self._graph("engine._paged_step_k",
                               lambda: window(False))}

        def _paged_admit():
            """Window-boundary admission: blocks off the free stack and
            the slot's scheduler row; no prefill (the chunked-prefill
            ticks of the next window write the prompt's KV)."""
            a = self._adm
            slot = a[0:1]
            n_need = a[5]
            trow = pop_blocks(self.free_top, n_need)
            self.tables.index_copy_(0, slot, trow[None, :])
            self.free_top.sub_(n_need)
            self.ids.index_copy_(0, slot, a[6:][None, :])
            for vec, j in ((self.cur_len, 1), (self.limit, 2),
                           (self._eos, 3), (self._stream, 4),
                           (self.n_blk, 5)):
                vec.index_copy_(0, slot, a[j:j + 1])
            self.kv_len.index_fill_(0, slot, 0)
            self._sstep.index_fill_(0, slot, 0)
            self._temps.index_copy_(0, slot, self._adm_t)

        self._paged_admit = self._graph("engine._paged_admit",
                                        _paged_admit)
        self._set_kv_gauges()

    # -- admission ---------------------------------------------------------
    def _blocks_for(self, prompt, max_new_tokens) -> int:
        """Blocks a request reserves at admission: its whole budget, so
        an admitted request always runs to completion."""
        need = min(len(prompt) + max_new_tokens, self.buf_len)
        return -(-need // self.block_size)

    @property
    def _supports_seed(self):
        return self.temperature > 0.0

    @property
    def _supports_temperature(self):
        return self.temperature > 0.0

    def _check_prompt(self, prompt):
        if len(prompt) < 1 or len(prompt) >= self.buf_len:
            raise ValueError(f"prompt length {len(prompt)} not in "
                             f"[1, {self.buf_len})")

    def _can_admit_direct(self, prompt, max_new_tokens) -> bool:
        return (bool(self._free) and self._free_top_h
                >= self._blocks_for(prompt, max_new_tokens))

    def add_request(self, prompt, max_new_tokens, eos_token_id=None,
                    seed=None, temperature=None, tenant=None):
        if self._free and self._free_top_h < self._blocks_for(
                prompt, max_new_tokens):
            raise RuntimeError(
                f"no free KV blocks for this request (needs "
                f"{self._blocks_for(prompt, max_new_tokens)}, "
                f"{self._free_top_h} free); use submit() to queue "
                f"until blocks recycle, or grow num_blocks")
        return super().add_request(prompt, max_new_tokens,
                                   eos_token_id, seed, temperature,
                                   tenant=tenant)

    def _admit(self, rid, prompt, max_new_tokens, eos_token_id,
               seed=None, temperature=None):
        n_need = self._blocks_for(prompt, max_new_tokens)
        if self._free_top_h < n_need:
            raise RuntimeError(
                f"no free KV blocks (need {n_need}, have "
                f"{self._free_top_h}); use submit() to queue until "
                f"blocks recycle")
        slot = self._free.pop()
        row = np.zeros((6 + self.buf_len,), np.int64)
        row[:6] = (slot, len(prompt),
                   min(len(prompt) + max_new_tokens, self.buf_len),
                   -1 if eos_token_id is None else int(eos_token_id),
                   self._stream_of(rid, seed), n_need)
        row[6:6 + len(prompt)] = prompt
        self._to_device(self._adm, row)
        self._to_device(self._adm_t, [self._temp_of(temperature)])
        self._paged_admit()
        self._free_top_h -= n_need
        self._slot_nblk_h[slot] = n_need
        self._by_slot[slot] = _Request(rid, slot, len(prompt),
                                       max_new_tokens, eos_token_id)

    def _drain_queue(self):
        # FIFO head-of-line: stop at the first queued request that does
        # not fit the current slot/block headroom
        admitted = False
        while (self._free and self._waiting
               and self._free_top_h >= self._blocks_for(
                   self._waiting[0][1], self._waiting[0][2])):
            self._admit_timed(*self._waiting.pop(0), refresh_kv=False)
            admitted = True
        self._set_queue_gauge()
        if admitted:
            self._set_kv_gauges()

    # -- the window --------------------------------------------------------
    def _stage_pending(self) -> int:
        """The waiting queue's first ``slots`` requests into the pending
        pack, one host copy; items STAY in ``_waiting`` until the device
        admits them (the ``adm`` replay).  Returns how many."""
        P, L = self.slots, self.buf_len
        n = min(len(self._waiting), P)
        pack = np.zeros((1 + 5 * P + P * L,), np.int64)
        temps = np.zeros((P,), np.float32)
        pack[0] = n
        fields = pack[1:1 + 5 * P].reshape(5, P)
        fields[2] = -1
        ids = pack[1 + 5 * P:].reshape(P, L)
        for i in range(n):
            (rid, prompt, max_new, eos_id, seed,
             temp) = self._waiting[i]
            ids[i, :len(prompt)] = prompt
            fields[:, i] = (len(prompt),
                            min(len(prompt) + max_new, self.buf_len),
                            -1 if eos_id is None else int(eos_id),
                            self._stream_of(rid, seed),
                            self._blocks_for(prompt, max_new))
            temps[i] = self._temp_of(temp)
        self._to_device(self._pend, pack)
        self._to_device(self._pend_t, temps)
        return n

    def _prefill_window(self) -> bool:
        """Whether this window needs the prefill graph: a live request
        that has emitted nothing (its prompt may still be prefilling; a
        slot decodes its first token the tick its prefill completes), or
        a queued request that a slot could take within the window (a
        slot is free, or a live request may die in it: it has an EOS or
        at most ``window`` tokens left)."""
        live = self._by_slot.values()
        if any(not r.generated and r.prompt_len > 1 for r in live):
            return True
        if not self._waiting:
            return False
        return bool(self._free) or any(
            r.eos is not None
            or min(r.max_new, self.buf_len - r.prompt_len)
            - len(r.generated) <= self.window for r in live)

    def step(self) -> Dict[int, Any]:
        """One decode window: stage the queue head, run the K ticks, read
        tokens, validity, the admission trace and the block headroom in
        ONE host read, then replay the device's tick-by-tick decisions
        into the host bookkeeping."""
        if not self._by_slot and not self._waiting:
            return {}
        t0 = self._clock()
        live0 = len(self._by_slot)
        with_prefill = self._prefill_window()
        if with_prefill:
            self._stage_pending()
        S, K = self.slots, self.window
        with maybe_span("engine_window_decode", window=K, live=live0):
            self._windows[with_prefill]()
            out = self._fetch(self._out)
        toks_h = out[:S * K].reshape(S, K)
        valid_h = out[S * K:2 * S * K].reshape(S, K)
        adm_h = out[2 * S * K:2 * S * K + K]
        self._free_top_h = int(out[-1])
        return self._harvest_paged(toks_h, valid_h, adm_h, t0, live0)

    def _harvest_paged(self, toks_h, valid_h, adm_h, t0, live0):
        """Replay the window's device decisions in tick order: an
        admission at tick t binds the queue head to its slot before that
        slot's later tokens are harvested, and a death at tick t frees
        the slot before a later admission reuses it."""
        n_tok = int(valid_h.sum())
        now = self._record_step(t0, tokens=n_tok,
                                capacity=max(live0, 1) * self.window)
        out: Dict[int, Any] = {}
        for t in range(self.window):
            s = int(adm_h[t])
            if s >= 0:
                (rid, prompt, max_new, eos_id, seed,
                 temp) = self._waiting.pop(0)
                req = _Request(rid, s, len(prompt), max_new, eos_id)
                req.t_submit = self._submit_ts.pop(rid, None)
                req.t_admit = now
                if req.t_submit is not None:
                    self._m_queue_wait.observe(
                        max(now - req.t_submit, 0.0))
                self._by_slot[s] = req
                if s in self._free:
                    self._free.remove(s)
                self._slot_nblk_h[s] = self._blocks_for(prompt, max_new)
                self._m_admitted.inc()
                self._n_admitted += 1
                self._n_midwindow += 1
                self.metrics.counter(
                    "engine_midwindow_admissions_total",
                    help="requests admitted INSIDE a decode window at "
                         "an iteration boundary (blocks freed by a "
                         "death earlier in the same window, reused "
                         "before it ends)").inc()
                self._set_queue_gauge()
            for s2 in range(self.slots):
                if not valid_h[s2][t]:
                    continue
                req = self._by_slot.get(s2)
                if req is None:
                    continue
                tok = int(toks_h[s2][t])
                req.generated.append(tok)
                out.setdefault(req.rid, []).append(tok)
                if req.t_first is None:
                    req.t_first = now
                self._m_tokens.inc()
                self._n_tokens += 1
                hit = req.eos is not None and tok == req.eos
                if hit or self._out_of_budget(req):
                    # the device recycled its blocks the tick it died
                    self._slot_nblk_h.pop(s2, None)
                    self._finish(s2, req)
        self._drain_queue()
        self._set_kv_gauges()
        return out

    def _out_of_budget(self, req):
        return (len(req.generated) >= req.max_new
                or req.prompt_len + len(req.generated) >= self.buf_len)

    def _freeze_slot(self, slot):
        """cancel() of a LIVE request: the device never saw it die, so
        its blocks go back on the free stack here (eager device ops)."""
        n = self._slot_nblk_h.pop(slot, 0)
        if n:
            j = torch.arange(self.max_blocks, device=self.device)
            dest = torch.where(j < n, self.free_top + j, self.num_blocks)
            self._fs_store[dest] = self.tables[slot]
            self.free_top.add_(n)
            self._free_top_h += n
        self.limit[slot:slot + 1].zero_()
        self.n_blk[slot:slot + 1].zero_()

    def _warm_traffic(self):
        """The JAX package's paged warmup: a prompt spanning a chunk
        boundary and a queued 1-token request."""
        plen = max(1, min(self.prefill_chunk + 1, self.buf_len - 1))
        r1 = self.add_request([0] * plen, max_new_tokens=1)
        r2 = self.submit([0], max_new_tokens=1)
        while not (self.is_finished(r1) and self.is_finished(r2)):
            self.step()
        for r in (r1, r2):
            self._finished.pop(r, None)

    def _warm_extra(self):
        """A request that outlives its first window, so the decode-only
        graph runs too."""
        r3 = self.add_request([0], max_new_tokens=min(
            self.window + 1, self.buf_len - 1))
        while not self.is_finished(r3):
            self.step()
        self._finished.pop(r3, None)

    # -- observability -----------------------------------------------------
    def _kv_buffers(self):
        return [self.pool]

    def _kv_usage(self):
        """PER-BLOCK accounting: a live request wastes only the unfilled
        tail of its reserved blocks; unreserved blocks are one free-pool
        entry."""
        pool_bytes = _tree_nbytes(self.pool)
        per_block = (pool_bytes / self.num_blocks
                     if self.num_blocks else 0.0)
        per_pos = per_block / self.block_size
        slots = []
        for slot in range(self.slots):
            req = self._by_slot.get(slot)
            held = (self._slot_nblk_h.get(slot, 0)
                    if req is not None else 0)
            used_pos = (min(req.prompt_len + len(req.generated),
                            held * self.block_size)
                        if req is not None else 0)
            used_b = int(round(per_pos * used_pos))
            held_b = int(round(per_block * held))
            slots.append({"slot": slot,
                          "rid": req.rid if req is not None else None,
                          "blocks_held": held,
                          "used_positions": used_pos,
                          "capacity_positions": held * self.block_size,
                          "used_bytes": used_b,
                          "kv_waste_bytes": held_b - used_b})
        free_blocks = max(self.num_blocks
                          - sum(self._slot_nblk_h.values()), 0)
        pools = [{"row": "free_blocks", "blocks": free_blocks,
                  "used_positions": 0,
                  "capacity_positions": free_blocks * self.block_size,
                  "used_bytes": 0,
                  "kv_waste_bytes": int(round(per_block
                                              * free_blocks))}]
        return slots, pools

    def _set_kv_gauges(self):
        frag = super()._set_kv_gauges()
        self.metrics.gauge(
            "engine_kv_blocks_free",
            help="KV pool blocks not reserved by any live request "
                 "(admission headroom)").set(
            float(getattr(self, "_free_top_h", 0)))
        return frag

    def compile_census(self) -> Dict[str, str]:
        return {"engine._paged_admit": "admission",
                "engine._paged_step_k": "decode"}

    def stats(self) -> Dict[str, Any]:
        """Base snapshot plus the block-pool fields."""
        s = super().stats()
        s["block_size"] = self.block_size
        s["blocks_total"] = self.num_blocks
        s["blocks_free"] = self._free_top_h
        s["max_blocks_per_request"] = self.max_blocks
        s["midwindow_admissions"] = self._n_midwindow
        return s


class Seq2SeqEngine(_SlotScheduler):
    """Continuous batching for ENCODER-DECODER models (T5).  Each slot
    holds the cross-attention K/V of its request's encoder pass and a
    decoder self-attention cache (``T5.init_seq2seq_state``);
    ``add_request`` runs the encoder for the new request alone and seeds
    its slot (``seed_slot_seq2seq``); a window is ``window`` greedy
    ``decode_step_rows`` ticks over all slots at per-slot positions, each
    request's tokens ``T5.generate``'s for it alone.  ``src_len`` fixes
    the padded source width, ``max_new_cap`` the decoder cache width."""

    def __init__(self, model, slots: int, src_len: int, max_new_cap: int,
                 cache_dtype=None, window: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        self.model = model
        self.slots = slots
        self.src_len = src_len
        self.max_new_cap = max_new_cap
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if cache_dtype is None:
            cache_dtype = model.shared.weight.dtype
        dev = _model_device(model)
        self._init_graphs(dev)
        self.state = model.init_seq2seq_state(slots, src_len,
                                              max_new_cap, cache_dtype)
        i64 = dict(dtype=torch.int64, device=dev)
        self.out = torch.zeros((slots, max_new_cap), **i64)
        self.n_new = torch.zeros((slots,), **i64)
        # per-slot token budget (n_new < s_limit == live; zeroed on
        # finish) and EOS id (-1 = none)
        self.s_limit = torch.zeros((slots,), **i64)
        self._eos = torch.full((slots,), -1, **i64)
        # admission input: [slot, n_src, limit, eos, row...]
        self._adm = torch.zeros((4 + src_len,), **i64)
        self._init_scheduler(slots, metrics)

        def _seed():
            a = self._adm
            model.seed_slot_seq2seq(self.state, a[0:1], a[4:], a[1])
            self.n_new.index_fill_(0, a[0:1], 0)
            self.s_limit.index_copy_(0, a[0:1], a[2:3])
            self._eos.index_copy_(0, a[0:1], a[3:4])

        self._seed = self._graph("seq2seq._seed", _seed)
        K = self.window
        self._wout = torch.zeros((2 * slots * K,), **i64)
        start_id = model.cfg.decoder_start_token_id

        def _step_k():
            """K decoder ticks; the decoder-only window's freeze/validity
            contract."""
            n = self.n_new
            alive = n < self.s_limit
            toks, valid = [], []
            for _ in range(K):
                prev = self.out.gather(1, torch.clamp(n - 1,
                                                      min=0)[:, None])[:, 0]
                tok = torch.where(n == 0, torch.full_like(prev, start_id),
                                  prev)
                logits, _ = model.decode_step_rows(tok, n, self.state)
                nxt = torch.argmax(logits, dim=-1)
                can = alive & (n < max_new_cap)
                _write_at(self.out, torch.clamp(n, max=max_new_cap - 1),
                          nxt, can)
                new_n = torch.where(can, n + 1, n)
                toks.append(nxt)
                valid.append(alive)
                hit_eos = (self._eos >= 0) & (nxt == self._eos)
                alive = alive & ~hit_eos & (new_n < self.s_limit)
                n = new_n
            self.n_new.copy_(n)
            self._wout.copy_(torch.cat([
                torch.stack(toks, 1).reshape(-1),
                torch.stack(valid, 1).reshape(-1).long()]))

        self._step_k = self._graph("seq2seq._step_k", _step_k)

    def compile_census(self) -> Dict[str, str]:
        return {"seq2seq._seed": "admission",
                "seq2seq._step_k": "decode"}

    def _kv_buffers(self):
        return [self.state]

    def _kv_usage(self):
        """Per-slot occupancy over the two residents: ``cross`` (used up
        to the source length) and ``dec`` (up to the generated count);
        the rest of the slot state counts as used while live."""
        cross = _tree_nbytes(self.state["cross"])
        dec = _tree_nbytes(self.state["dec"])
        other = _tree_nbytes(self.state) - cross - dec
        slots = []
        for slot in range(self.slots):
            req = self._by_slot.get(slot)
            if req is not None:
                src_pos = min(req.prompt_len, self.src_len)
                dec_pos = min(len(req.generated), self.max_new_cap)
                live = 1.0
            else:
                src_pos = dec_pos = 0
                live = 0.0
            used_b = int(round(
                cross * src_pos / (self.slots * self.src_len)
                + dec * dec_pos / (self.slots * self.max_new_cap)
                + other * live / self.slots))
            cap_b = int(round((cross + dec + other) / self.slots))
            slots.append({"slot": slot,
                          "rid": req.rid if req is not None else None,
                          "used_positions": src_pos + dec_pos,
                          "capacity_positions": (self.src_len
                                                 + self.max_new_cap),
                          "used_bytes": used_b,
                          "kv_waste_bytes": cap_b - used_b})
        return slots, []

    def _check_prompt(self, src):
        if len(src) < 1 or len(src) > self.src_len:
            raise ValueError(f"source length {len(src)} not in "
                             f"[1, {self.src_len}]")

    def _admit(self, rid, src, max_new_tokens, eos_token_id,
               seed=None, temperature=None):
        slot = self._free.pop()
        max_new = min(max_new_tokens, self.max_new_cap)
        row = np.zeros((4 + self.src_len,), np.int64)
        row[:4] = (slot, len(src), max_new,
                   -1 if eos_token_id is None else int(eos_token_id))
        row[4:4 + len(src)] = src
        self._to_device(self._adm, row)
        self._seed()
        self._by_slot[slot] = _Request(rid, slot, len(src), max_new,
                                       eos_token_id)

    def step(self) -> Dict[int, Any]:
        """One decoder window; {rid: [tokens]} for live requests."""
        if not self._by_slot and self._waiting:
            self._drain_queue()
        if not self._by_slot:
            return {}
        t0 = self._clock()
        live = list(self._by_slot)
        with maybe_span("engine_window_decode", window=self.window,
                        live=len(live)):
            self._step_k()
            # THE host read: one fetch a window
            out = self._fetch(self._wout).reshape(2, self.slots,
                                                  self.window)
            emitted = {slot: [int(t) for t, v
                              in zip(out[0, slot], out[1, slot]) if v]
                       for slot in live}
        return self._harvest(emitted, t0)

    def _out_of_budget(self, req):
        return len(req.generated) >= req.max_new

    def _freeze_slot(self, slot):
        self.s_limit[slot:slot + 1].zero_()
