"""The sharding plane: the replication ledger, the collective sites of a
step, and the divergent-output check, over the ranks' state.

Counterpart of ``apex_tpu/analysis/sharding.py``.  The JAX package
propagates partitions through a ``shard_map`` body statically: each
operand's in-spec says which devices hold equal copies, and a replicated
out-spec over a value that still varies is a claim nothing checks at run
time.  The port has no ``shard_map``: each rank runs the same step on its
own process, so its counterpart reads the ranks' state itself.  A step
traced inside the gloo ranks (:func:`rank_sharding_info`, called by
``entry_points``) digests every state leaf on every rank before and after
the call and gathers the digests to rank 0:

- **the replication ledger** (:func:`arg_shardings`,
  :func:`entry_point_sharding_record`): per state leaf (the port's
  "argument"), the bytes each rank holds and in how many distinct copies
  the world holds them: a leaf the step claims sharded (a ZeRO window)
  as each rank's own block, as the JAX ledger's in-specs count it (so a
  ZeRO-2/3 window repeated on every node of the hierarchical layout is
  counted sharded in both packages), a leaf claimed replicated by its
  digests before the step;
- **the divergent-output claims** (:func:`divergent_output_claims`): a
  state leaf the step claims replicated whose digests differ across the
  ranks after the step.  This is a run-time check in the port, where the
  JAX package's is static: it sees real agreement where a propagator
  could not prove it (ZeRO-2's in-node gather-back, TP's flat grad
  bundle), and a real divergence (non-synced BatchNorm statistics) as
  the JAX package declares it;
- **the mesh** (:func:`check_mesh`): the world the step ran on and every
  collective's group against the declared mesh axes;
- **the collective sites** (:func:`collective_sites`): each collective
  the step ran, with its payload, operand and group, for the
  resharding census.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["RESHARD_PRIMS", "ArgSharding", "CollectiveSite",
           "rank_sharding_info", "arg_shardings", "collective_sites",
           "check_mesh", "divergent_output_claims",
           "entry_point_sharding_record"]

# placement-changing collectives: the resharding census matches these;
# psum/pmax/pmin change values, not placement
RESHARD_PRIMS = ("all_gather", "all_to_all", "reduce_scatter", "pgather")


@dataclasses.dataclass
class ArgSharding:
    """Placement of one state leaf across the ranks."""

    index: int
    name: str
    shape: Tuple[int, ...]          # this rank's (local) shape
    dtype: str
    local_bytes: int
    n_cells: int                    # distinct copies the world holds
    replication_factor: float
    spec: str

    def replicated_bytes(self, world: int) -> int:
        return self.local_bytes * (world - self.n_cells)


@dataclasses.dataclass
class CollectiveSite:
    """One collective the step ran: its primitive, payload, the operand
    it sent and the group it ran over."""

    primitive: str
    payload_bytes: int
    shape: Tuple[int, ...]
    dtype: str
    spec: str
    group: Tuple[int, ...]

    def describe(self) -> str:
        return (f"{self.primitive} of {self.dtype}{list(self.shape)} "
                f"({self.payload_bytes} bytes, {self.spec}) over ranks "
                f"{list(self.group)}")


def rank_sharding_info(trace, mesh_axes: Dict[str, int],
                       sharded: Sequence[str] = (), group=None
                       ) -> Optional[Dict[str, Any]]:
    """Gather every rank's state digests of ``trace`` (recorded with
    ``digests=True``) over ``group`` (default: the world); rank 0 of the
    group gets the sharding facts, the others ``None``.  A leaf whose
    name starts with an entry of ``sharded`` is one the step claims
    sharded (a ZeRO window); every other leaf it claims replicated.
    ``sharded`` may map each prefix to the number of distinct blocks the
    world holds (a tensor-parallel shard: the model axis's size; by
    default every rank its own)."""
    import torch.distributed as dist
    mine = [(f.name, f.digest_before, f.digest_after) for f in trace.state]
    world = dist.get_world_size(group)
    got: List[Any] = [None] * world
    dist.all_gather_object(got, mine, group=group)
    if dist.get_rank(group) != 0:
        return None
    cells_of = (dict(sharded) if isinstance(sharded, dict)
                else {p: world for p in sharded})
    leaves = []
    for i, f in enumerate(trace.state):
        cells = [c for p, c in cells_of.items() if f.name.startswith(p)]
        leaves.append({
            "name": f.name, "shape": list(f.before.shape),
            "dtype": f.before.dtype, "local_bytes": f.before.nbytes,
            "claim": "sharded" if cells else "replicated",
            "cells": cells[0] if cells else 1,
            "before": [r[i][1] for r in got],
            "after": [r[i][2] for r in got]})
    return {"world": world, "mesh_axes": dict(mesh_axes), "leaves": leaves}


def _info(graph) -> Dict[str, Any]:
    rec = graph.info.get("sharding")
    if not rec:
        raise RuntimeError("the trace ran on no process group: the "
                           "sharding plane does not apply")
    return rec


def arg_shardings(graph) -> List[ArgSharding]:
    """The ledger's rows: each state leaf with the number of distinct
    copies the world holds of it — a leaf the step claims sharded is each
    rank's own block (the JAX in-spec's accounting, so that the records
    compare), a leaf claimed replicated has as many cells as distinct
    digests before the step."""
    rec = _info(graph)
    world = rec["world"]
    out = []
    for i, leaf in enumerate(rec["leaves"]):
        cells = (leaf["cells"] if leaf["claim"] == "sharded"
                 else len(set(leaf["before"])))
        spec = ("replicated" if cells == 1
                else f"sharded({cells} of {world} ranks distinct)")
        out.append(ArgSharding(i, leaf["name"], tuple(leaf["shape"]),
                               leaf["dtype"], int(leaf["local_bytes"]),
                               cells, world / cells, spec))
    return out


def divergent_output_claims(graph) -> List[str]:
    """State leaves the step claims replicated whose digests differ
    across the ranks after it."""
    rec = _info(graph)
    return [f"{leaf['name']} ({leaf['dtype']}{leaf['shape']}) claimed "
            f"replicated, {len(set(leaf['after']))} distinct values "
            f"across {rec['world']} ranks"
            for leaf in rec["leaves"]
            if leaf["claim"] == "replicated"
            and len(set(leaf["after"])) > 1]


def _axis_products(mesh_axes: Dict[str, int]) -> set:
    sizes = list(mesh_axes.values())
    out = set()
    for r in range(len(sizes) + 1):
        for combo in itertools.combinations(sizes, r):
            p = 1
            for s in combo:
                p *= int(s)
            out.add(p)
    return out


def check_mesh(graph, mesh_axes: Optional[Dict[str, int]]) -> List[str]:
    """Problems of the step's ranks against the declared mesh: the world
    it ran on must be the product of the axes, and every collective's
    group a product of some of them (a group of any other size is a
    collective over ranks no axis names)."""
    rec = _info(graph)
    out: List[str] = []
    if mesh_axes is None:
        return out
    prod = 1
    for v in mesh_axes.values():
        prod *= int(v)
    if prod != rec["world"]:
        out.append(f"the step ran on {rec['world']} ranks but the mesh "
                   f"axes {dict(mesh_axes)} span {prod}")
    if dict(rec.get("mesh_axes") or {}) != dict(mesh_axes):
        out.append(f"the step's mesh axes {rec.get('mesh_axes')} are not "
                   f"the {dict(mesh_axes)} the entry point asked for")
    # a group spans some axes, or a slice of one (the node groups of a
    # hierarchical reduce are axis_index_groups of the data axis): its
    # size divides a product of the axes
    ok = _axis_products(mesh_axes)
    bad = sorted({len(s.group) for s in collective_sites(graph)
                  if s.group and not any(p % len(s.group) == 0
                                         for p in ok)})
    for n in bad:
        out.append(f"a collective runs over a group of {n} ranks, which "
                   f"divides no product of the mesh axes "
                   f"{dict(mesh_axes)}")
    return out


def collective_sites(graph) -> List[CollectiveSite]:
    from . import graphs as G
    out = []
    for n in G.collective_nodes(graph):
        op = n.inputs[0] if n.inputs else None
        group = tuple(n.attrs.get("group", ()))
        out.append(CollectiveSite(
            n.prim, G.node_payload_bytes(n),
            op.shape if op is not None else (),
            op.dtype if op is not None else "?",
            f"over {len(group)} ranks" if group else "over the world",
            group))
    return out


def entry_point_sharding_record(ep, top_n: int = 8) -> Dict[str, Any]:
    """The replication ledger of one entry point as a ``kind: sharding``
    record (``observability.exporters.validate_sharding_record``):
    ``argument_bytes`` the state bytes one rank holds,
    ``replicated_bytes`` the world-total duplicate bytes
    (``sum(local_bytes * (world - n_cells))``), so ``unique_bytes +
    replicated_bytes == world * argument_bytes``.  An entry point traced
    on no process group (the serving engines) raises ``RuntimeError``,
    the CLI's skip class."""
    graph = ep.graph()
    rec_info = _info(graph)
    world = rec_info["world"]
    args = arg_shardings(graph)
    by_dtype: Dict[str, int] = {}
    for a in args:
        b = a.replicated_bytes(world)
        if b:
            by_dtype[a.dtype] = by_dtype.get(a.dtype, 0) + b
    resharding: Dict[str, int] = {}
    for s in collective_sites(graph):
        if s.primitive in RESHARD_PRIMS:
            resharding[s.primitive] = resharding.get(s.primitive, 0) + 1
    ranked = sorted(args, key=lambda a: a.replicated_bytes(world),
                    reverse=True)
    top = [{"index": a.index, "shape": list(a.shape), "dtype": a.dtype,
            "local_bytes": a.local_bytes,
            "replication_factor": a.replication_factor, "spec": a.spec}
           for a in ranked[:top_n] if a.replicated_bytes(world) > 0]
    argument_bytes = sum(a.local_bytes for a in args)
    replicated = sum(a.replicated_bytes(world) for a in args)
    unique = sum(a.local_bytes * a.n_cells for a in args)
    rec = {
        "kind": "sharding", "entry_point": ep.name, "source": "ranks",
        "world": world,
        "mesh_axes": {k: int(v) for k, v in rec_info["mesh_axes"].items()},
        "shard_maps": 1,
        "argument_bytes": argument_bytes, "unique_bytes": unique,
        "replicated_bytes": replicated,
        "replicated_bytes_by_dtype": by_dtype,
        "replicated_fraction": (replicated / (world * argument_bytes)
                                if argument_bytes else 0.0),
        "top_replicated": top, "resharding_eqns": resharding}
    zero_m = re.search(r"zero([123])", ep.name)
    if zero_m:
        rec["zero_stage"] = int(zero_m.group(1))
    return rec
