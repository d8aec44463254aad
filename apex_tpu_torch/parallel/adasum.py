"""Adasum: adaptive gradient summation across data-parallel ranks.

Counterpart of ``apex_tpu/parallel/adasum.py`` ("Scaling Distributed
Training with Adaptive Summation", Maleki et al., arXiv:2006.02924).  A
pair of gradients combines as

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b

so orthogonal gradients add, identical ones average, and opposed
components are damped.  N ranks apply the rule over a fixed XOR
butterfly of ``log2(N)`` stages: at stage ``s`` each rank swaps its whole
fp32 buffer with the rank whose index differs in bit ``s``
(``torch.distributed.batch_isend_irecv``, where the JAX package uses
``ppermute``) and both combine the two with the lower block's buffer as
the first operand, so partners compute the same bits and every rank ends
with the same result.  Dots and norms are taken per tensor (the paper's
per-layer granularity), in fp32.

``ici_size > 1`` is the hierarchical form: the gradients are averaged
within each block of ``ici_size`` ranks (one node's NVLink level), and the
butterfly runs across blocks only, on the block means.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

import torch
import torch.distributed as dist

from .topology import hierarchical_groups

__all__ = ["adasum_pair", "adasum_grads", "adasum_comm_plan"]


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The two-operand rule for one tensor, in fp32, returned in ``a``'s
    dtype.  A zero-norm operand degrades the rule to addition."""
    af = a.float().reshape(-1)
    bf = b.float().reshape(-1)
    dot = torch.dot(af, bf)
    na = torch.dot(af, af)
    nb = torch.dot(bf, bf)
    one = torch.ones((), dtype=torch.float32, device=af.device)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, one)),
                     one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, one)),
                     one)
    return (ca * af + cb * bf).reshape(a.shape).to(a.dtype)


def _stages(ici: int, world: int) -> int:
    """``log2`` of the number of blocks; raises unless ``ici`` divides
    ``world`` into a power of two of them."""
    if ici < 1 or world % ici:
        raise ValueError(f"ici_size {ici} must be >= 1 and divide the "
                         f"axis size {world}")
    n_slices = world // ici
    if n_slices & (n_slices - 1):
        raise ValueError(f"adasum needs a power-of-two number of slices, "
                         f"got {n_slices} ({world} ranks / ici_size {ici})")
    return n_slices.bit_length() - 1


def adasum_grads(grads: Any, process_group=None, ici_size: int = 1) -> Any:
    """Adasum-combine ``grads`` (a list of tensors, or a mapping of names
    to tensors) across the ranks of ``process_group`` (``None``: the
    world).  Returns the combined grads in the same form, new tensors in
    the grads' dtypes, the same on every rank.  See the module doc for
    ``ici_size``; the number of blocks (``world / ici_size``) must be a
    power of two."""
    if isinstance(grads, Mapping):
        names = list(grads)
        out = adasum_grads([grads[n] for n in names], process_group,
                           ici_size)
        return dict(zip(names, out))
    leaves = list(grads)
    world = dist.get_world_size(process_group)
    idx = dist.get_rank(process_group)
    ici = int(ici_size)
    stages = _stages(ici, world)
    if not leaves:
        return leaves
    sizes = [t.numel() for t in leaves]
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    # one fp32 exchange buffer a stage, the dots per tensor on its views
    flat = torch.cat([t.detach().float().reshape(-1) for t in leaves])
    if ici > 1:
        ici_group, _ = hierarchical_groups(
            ici, world, None if process_group is None
            else dist.get_process_group_ranks(process_group))
        dist.all_reduce(flat, group=ici_group)
        flat = flat / float(ici)
    sid, j = divmod(idx, ici)
    for s in range(stages):
        stride = 1 << s
        peer = (sid ^ stride) * ici + j
        if process_group is not None:
            peer = dist.get_global_rank(process_group, peer)
        theirs = torch.empty_like(flat)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, flat, peer, process_group),
                dist.P2POp(dist.irecv, theirs, peer, process_group)]):
            req.wait()
        # the lower block's buffer first on both partners: the same bits
        a, b = (flat, theirs) if sid & stride == 0 else (theirs, flat)
        flat = torch.cat([adasum_pair(a[offs[i]:offs[i + 1]],
                                      b[offs[i]:offs[i + 1]])
                          for i in range(len(leaves))])
    return [flat[offs[i]:offs[i + 1]].view(t.shape).to(t.dtype)
            for i, t in enumerate(leaves)]


def adasum_comm_plan(grads: Any, world: int,
                     ici_size: int = 1) -> List[Dict[str, Any]]:
    """What :func:`adasum_grads` puts on the wire, from shapes alone (the
    JAX package's dict): one bucket, the fp32 exchange buffer swapped at
    each of ``log2(world / ici_size)`` stages (across blocks: the slow
    level under the hierarchical layout), plus the in-block mean when
    ``ici_size > 1``."""
    leaves = list(grads.values()) if isinstance(grads, Mapping) \
        else list(grads)
    n = sum(math.prod(getattr(t, "shape", ()) or (1,)) for t in leaves)
    ici, world = int(ici_size), int(world)
    stages = _stages(ici, world)
    n_slices = world // ici
    buf_bytes = n * 4
    dcn_bytes = stages * buf_bytes
    ici_bytes = buf_bytes if ici > 1 else 0
    eqns: Dict[str, int] = {}
    payload: Dict[str, int] = {}
    if stages:
        eqns["ppermute"] = stages
        payload["ppermute"] = dcn_bytes
    if ici > 1:
        eqns["psum"] = 1
        payload["psum"] = ici_bytes
    total = dcn_bytes + ici_bytes
    return [{
        "dtype": "float32", "comm_dtype": "float32",
        "leaves": len(leaves), "elements": n, "chunks": 1,
        "cause": "adasum",
        "topology": "hierarchical" if ici > 1 else "flat",
        "ici_size": ici, "dcn_size": n_slices, "stages": stages,
        "wire_elements": n, "padded_elements": 0,
        "bytes": total, "wire_bytes": total,
        # with no level split every byte counts on both fabrics
        "ici_wire_bytes": ici_bytes if ici > 1 else total,
        "dcn_wire_bytes": dcn_bytes if ici > 1 else total,
        "dcn_comm_dtype": "float32",
        "eqns": eqns, "eqn_payload_bytes": payload}]
