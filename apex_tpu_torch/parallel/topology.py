"""Rank grids over ``torch.distributed``: the fast and slow fabric levels.

Counterpart of ``apex_tpu/parallel/topology.py``.  The JAX package lays a
device mesh out so that collectives inside a TPU slice ride ICI and
collectives across slices cross DCN.  On GPUs the same two levels are
NVLink inside a node (the "ICI" level here) and the network between nodes
(the "DCN" level).  A launcher starts each node's ranks as one contiguous
block (``LOCAL_WORLD_SIZE`` of them), which is the JAX package's
multi-host ordering, so the same group arithmetic holds:

    world=8, ici_size=4 ->  ici: [[0,1,2,3], [4,5,6,7]]
                            dcn: [[0,4], [1,5], [2,6], [3,7]]

``make_mesh`` gives a :class:`RankMesh`, whose ``group(axis)`` is this
rank's ``torch.distributed`` group along an axis, and
:func:`hierarchical_groups` this rank's (ICI, DCN) pair.  Every rank must
create every group, in the same order, even the groups it is not in
(``dist.new_group``'s rule): both create all groups of a split at once and
keep them for the life of the default group.  A group's NCCL communicator
is made by its first collective, which may not run inside a CUDA graph
capture: the first (eager) call of a captured step makes it.
"""

from __future__ import annotations

import itertools
import os
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["make_mesh", "RankMesh", "mesh_info", "hierarchical_axis_groups",
           "hierarchical_groups", "default_ici_size", "auto_comm_topology",
           "overlap_issue_order", "collective_rank_groups", "node_count"]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def node_count(world: Optional[int] = None) -> int:
    """The number of nodes the world spans: ``world / LOCAL_WORLD_SIZE``
    (the launcher's ranks a node), 1 when the launcher set none."""
    world = _world() if world is None else int(world)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the "
                         f"world size {world}")
    return world // local


def default_ici_size(world: int, nproc: Optional[int] = None) -> int:
    """Ranks a node along the data axis: the width of the fast (NVLink)
    level of a two-level reduction.  ``nproc`` is the number of nodes
    (the JAX package's process count); by default from the launcher's
    ``LOCAL_WORLD_SIZE``."""
    nproc = node_count(world) if nproc is None else int(nproc)
    if nproc < 1 or world % nproc != 0:
        raise ValueError(
            f"axis size {world} is not divisible by the node count "
            f"{nproc}; pass ici_size explicitly")
    return world // nproc


def auto_comm_topology(nproc: Optional[int] = None) -> str:
    """``comm_topology='auto'``: hierarchical when the world spans more
    than one node (a network hop to economize on), else flat."""
    nproc = node_count() if nproc is None else int(nproc)
    return "hierarchical" if nproc > 1 else "flat"


def hierarchical_axis_groups(world: int, ici_size: int
                             ) -> Tuple[List[List[int]], List[List[int]]]:
    """``(ici_groups, dcn_groups)``: consecutive blocks of ``ici_size``
    ranks share the fast fabric, and ranks at the same offset in their
    block talk across the slow one (see the module doc)."""
    if ici_size < 1 or world % ici_size != 0:
        raise ValueError(
            f"ici_size {ici_size} must be >= 1 and divide the axis "
            f"size {world}")
    n_slices = world // ici_size
    ici_groups = [list(range(s * ici_size, (s + 1) * ici_size))
                  for s in range(n_slices)]
    dcn_groups = [[j + s * ici_size for s in range(n_slices)]
                  for j in range(ici_size)]
    return ici_groups, dcn_groups


def overlap_issue_order(n_stages: int) -> List[int]:
    """Stage issue order of the overlapped gradient schedule: the backward
    makes the last stage's grads first, so its reduction goes first,
    ``[S-1, ..., 1, 0]``.  The one place the order lives: the staged step
    and :func:`..distributed.overlap_comm_schedule` both read it."""
    n = int(n_stages)
    if n < 1:
        raise ValueError(f"need at least one stage, got {n_stages}")
    return list(range(n - 1, -1, -1))


def collective_rank_groups(axis_sizes: Dict[str, int], axes,
                           axis_index_groups: Optional[
                               Sequence[Sequence[int]]] = None
                           ) -> List[Tuple[int, ...]]:
    """Flattened-rank groups of a collective over named mesh axes
    (``axis_sizes`` an ordered ``{name: size}``, outermost first; ranks
    row-major).  Without ``axis_index_groups`` each group holds the ranks
    that share their coordinates on the other axes; with them (one named
    axis only) each listed group is made once for every combination of
    the other axes' coordinates, in the listed order."""
    names = list(axis_sizes)
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    for a in axes:
        if a not in axis_sizes:
            raise KeyError(f"axis {a!r} not in mesh axes {names}")
    strides: Dict[str, int] = {}
    s = 1
    for n in reversed(names):
        strides[n] = s
        s *= int(axis_sizes[n])
    other = [n for n in names if n not in axes]
    other_ranges = [range(int(axis_sizes[n])) for n in other]

    def rank(coords: Dict[str, int]) -> int:
        return sum(coords[n] * strides[n] for n in names)

    groups: List[Tuple[int, ...]] = []
    if axis_index_groups is not None:
        if len(axes) != 1:
            raise ValueError(
                "axis_index_groups only apply to a single named axis")
        ax = axes[0]
        for combo in itertools.product(*other_ranges):
            coords = dict(zip(other, combo))
            for g in axis_index_groups:
                groups.append(tuple(rank({**coords, ax: int(i)})
                                    for i in g))
    else:
        named_ranges = [range(int(axis_sizes[a])) for a in axes]
        for combo in itertools.product(*other_ranges):
            coords = dict(zip(other, combo))
            groups.append(tuple(
                rank({**coords, **dict(zip(axes, named))})
                for named in itertools.product(*named_ranges)))
    return groups


# groups made once per rank lists under one default group, every rank
# calling new_group for every group in one order; dropped with the default
# group they were made under (held weakly: a group made after it is
# destroyed may take its address)
_GROUPS: Dict[Tuple, object] = {}
_GROUPS_WORLD: Optional[weakref.ref] = None


def _split(rank_lists: Sequence[Sequence[int]]):
    """This rank's group of a split of the world into ``rank_lists``,
    every group of the split created (once) by every rank."""
    global _GROUPS_WORLD
    world = dist.group.WORLD
    if _GROUPS_WORLD is None or _GROUPS_WORLD() is not world:
        _GROUPS.clear()
        _GROUPS_WORLD = weakref.ref(world)
    key = tuple(tuple(r) for r in rank_lists)
    if key not in _GROUPS:
        me = dist.get_rank()
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(list(ranks))
            if me in ranks:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def hierarchical_groups(ici_size: int, world: Optional[int] = None,
                        ranks: Optional[Sequence[int]] = None):
    """This rank's ``(ici_group, dcn_group)`` for ``ici_size`` ranks a slice
    (see :func:`hierarchical_axis_groups`), over the default group or,
    with ``ranks``, over those global ranks (a process group's, in its
    order: the hierarchy of a world shrunk onto its survivors).  A rank
    outside ``ranks`` gets ``(None, None)``.  Every rank of the default
    group takes part in making the groups, so an elastic run makes them
    for every world it can shrink to while every rank is there; the call
    after the shrink finds them made."""
    if ranks is None:
        world = _world() if world is None else int(world)
        ranks = range(world)
    ranks = [int(r) for r in ranks]
    if world is not None and int(world) != len(ranks):
        raise ValueError(f"world {world} but {len(ranks)} ranks")
    ici_groups, dcn_groups = hierarchical_axis_groups(len(ranks),
                                                      int(ici_size))
    return (_split([[ranks[i] for i in g] for g in ici_groups]),
            _split([[ranks[i] for i in g] for g in dcn_groups]))


class RankMesh:
    """A grid of the world's ranks with named axes (outermost first),
    row-major: the JAX package's ``Mesh`` over ``torch.distributed``."""

    def __init__(self, axis_sizes: Dict[str, int]):
        self.axis_sizes = dict(axis_sizes)
        self.axis_names = tuple(self.axis_sizes)
        self.size = 1
        for v in self.axis_sizes.values():
            self.size *= int(v)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axis_sizes)

    def group(self, axis):
        """This rank's group along ``axis`` (a name or a tuple of names),
        made once, all its sibling groups with it."""
        return _split(collective_rank_groups(self.axis_sizes, axis))


def make_mesh(devices: Optional[int] = None, **axes: int) -> RankMesh:
    """A :class:`RankMesh` from ``axis_name=size`` (outermost first) over
    ``devices`` ranks (default: the world).  One axis may be -1: it takes
    the ranks left.  Raises if the sizes do not cover the ranks exactly.
    With more than one node, the outermost axis must be divisible by the
    node count: it is the one laid across nodes."""
    if not axes:
        axes = {"data": -1}
    n = _world() if devices is None else int(devices)
    names = list(axes)
    sizes = list(axes.values())
    if sum(1 for s in sizes if s == -1) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = 1
    for s in sizes:
        if s != -1:
            fixed *= int(s)
    if fixed <= 0 or n % fixed != 0:
        raise ValueError(f"axis sizes {dict(zip(names, sizes))} do not "
                         f"divide {n} devices")
    sizes = [n // fixed if s == -1 else int(s) for s in sizes]
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"axis sizes {dict(zip(names, sizes))} != {n} "
                         f"devices")
    nodes = node_count(n) if dist.is_initialized() else 1
    if nodes > 1 and sizes[0] % nodes:
        raise ValueError(f"outermost axis {names[0]}={sizes[0]} must be "
                         f"divisible by the node count {nodes}")
    return RankMesh(dict(zip(names, sizes)))


def mesh_info(mesh: RankMesh) -> str:
    """One line describing a mesh, for start-up logging."""
    backend = dist.get_backend() if dist.is_initialized() else "no group"
    nodes = node_count(mesh.size) if dist.is_initialized() else 1
    return (f"mesh {mesh.shape} over {mesh.size} rank(s) ({backend}), "
            f"{nodes} node(s)")
