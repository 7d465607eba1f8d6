"""GMI — the Galapagos Messaging Interface (paper §5), on mesh axes (port
of `repro/core/gmi.py`).

The paper defines a minimal collective set (Broadcast / Reduce / Scatter /
Gather) plus composition ("Allgather = Gather to a root, then Broadcast",
§5.1) and two communicator levels: intra-cluster and inter-cluster, where
ALL inter-cluster traffic funnels through a Gateway kernel (§4).

Single-controller mapping: one process holds every shard's tensor.  A
collective takes the list of per-shard tensors of a `DeviceMesh` (one per
flat shard, in the mesh's row-major order), runs over a mesh axis or a
tuple of axes (the communicator: the shards that share every other
coordinate), and returns the list of per-shard results, each on its
shard's device.  The collectives are copies, concatenations and sums; a
sum adds the group's members in axis-index order, so the same inputs give
the same bits on any device.  Shards of one device share a result where
the values are the same.

  * communicator  = named mesh axis (or tuple of axes)
  * intra-cluster = `data`/`model` axes;  inter-cluster = `pod` axis
  * gateway       = the two-phase hierarchical schedule: intra-pod
    reduce-scatter, inter-pod exchange between same-index shard leaders
    only, intra-pod all-gather (`hier_allreduce`).

Two forms are kept for each All* collective, as in the reference:
`*_composed`, the paper's root-based composition, and the one-step form.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch

from repro_torch.launch.mesh import DeviceMesh

Axis = Union[str, Sequence[str]]
Shards = List[torch.Tensor]


def axis_size(mesh: DeviceMesh, axis: Axis) -> int:
    return mesh.axis_size(axis)


def _dev(xs: Shards, mesh: DeviceMesh, f: int) -> torch.device:
    return xs[f].device if mesh.abstract else mesh.device(f)


def _sum(parts: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """The parts added in the order given, on `dev`."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def _per_group(xs: Shards, mesh: DeviceMesh, axis: Axis, fn) -> Shards:
    """fn(group_members, member_position, device) -> member's result, for
    every shard; results are shared between members of one group on one
    device when fn says the value is the same for them (fn returns
    (value, shareable))."""
    out: List = [None] * len(xs)
    for group in mesh.groups(axis):
        held: Dict[str, torch.Tensor] = {}
        for i, f in enumerate(group):
            dev = _dev(xs, mesh, f)
            key = str(dev)
            val, shared = fn(group, i, dev, held.get(key))
            if shared:
                held[key] = val
            out[f] = val
    return out


# -- the four GMI primitives -------------------------------------------------


def broadcast(xs: Shards, mesh: DeviceMesh, axis: Axis,
              root: int = 0) -> Shards:
    """Every member receives root's x."""
    return _per_group(xs, mesh, axis, lambda g, i, dev, have: (
        have if have is not None else xs[g[root]].to(dev), True))


def reduce(xs: Shards, mesh: DeviceMesh, axis: Axis,
           root: int = 0) -> Shards:
    """Sum of x over the group, on root only (others get zeros)."""
    def fn(g, i, dev, have):
        if i == root:
            return _sum([xs[f] for f in g], dev), False
        return torch.zeros_like(xs[g[i]], device=dev), False
    return _per_group(xs, mesh, axis, fn)


def gather(xs: Shards, mesh: DeviceMesh, axis: Axis,
           root: int = 0) -> Shards:
    """Group members' x stacked on a new leading dim, on root only
    (others get zeros of that shape)."""
    def fn(g, i, dev, have):
        full = torch.stack([xs[f].to(dev) for f in g])
        return (full if i == root else torch.zeros_like(full)), False
    return _per_group(xs, mesh, axis, fn)


def scatter(xs: Shards, mesh: DeviceMesh, axis: Axis,
            root: int = 0) -> Shards:
    """Root holds (group_size, ...); member i receives slice i."""
    return _per_group(xs, mesh, axis, lambda g, i, dev, have: (
        xs[g[root]][i].to(dev), False))


# -- composed All* (paper-faithful: via a root, §5.1) ------------------------


def allgather_composed(xs: Shards, mesh: DeviceMesh, axis: Axis,
                       root: int = 0) -> Shards:
    return broadcast(gather(xs, mesh, axis, root), mesh, axis, root)


def allreduce_composed(xs: Shards, mesh: DeviceMesh, axis: Axis,
                       root: int = 0) -> Shards:
    return broadcast(reduce(xs, mesh, axis, root), mesh, axis, root)


# -- one-step collectives ------------------------------------------------------


def allgather(xs: Shards, mesh: DeviceMesh, axis: Axis) -> Shards:
    return _per_group(xs, mesh, axis, lambda g, i, dev, have: (
        have if have is not None
        else torch.stack([xs[f].to(dev) for f in g]), True))


def allreduce(xs: Shards, mesh: DeviceMesh, axis: Axis) -> Shards:
    return _per_group(xs, mesh, axis, lambda g, i, dev, have: (
        have if have is not None else _sum([xs[f] for f in g], dev), True))


def reduce_scatter(xs: Shards, mesh: DeviceMesh, axis: Axis) -> Shards:
    """Sum over the group; member i keeps block i of the leading dim."""
    def fn(g, i, dev, have):
        total = _sum([xs[f] for f in g], dev)
        w = total.shape[0] // len(g)
        return total[i * w:(i + 1) * w].contiguous(), False
    return _per_group(xs, mesh, axis, fn)


def allgather_dim(xs: Shards, mesh: DeviceMesh, axis: Axis,
                  dim: int) -> Shards:
    """`allgather`, the members' blocks joined on `dim` in axis-index
    order (an FSDP gather: each member's block of a leaf -> the leaf)."""
    held: Dict[int, torch.Tensor] = {}
    out = []
    for g in allgather(xs, mesh, axis):
        if id(g) not in held:  # members on one device share the result
            held[id(g)] = torch.cat(list(g.unbind(0)), dim)
        out.append(held[id(g)])
    return out


def reduce_scatter_dim(xs: Shards, mesh: DeviceMesh, axis: Axis,
                       dim: int) -> Shards:
    """`reduce_scatter` on `dim`: the sum over the group in axis-index
    order, member i keeping block i of `dim` (a gradient's data-parallel
    reduction back to its FSDP block)."""
    out = reduce_scatter([x.movedim(dim, 0) for x in xs], mesh, axis)
    return [x.movedim(0, dim).contiguous() for x in out]


# -- hierarchical (gateway) collectives: the clusters-of-clusters schedule ---


def hier_allreduce(xs: Shards, mesh: DeviceMesh, intra_axis: Axis,
                   inter_axis: Axis) -> Shards:
    """Gateway-style inter-cluster allreduce (paper §4).

    Phase 1: reduce-scatter inside the cluster (each member becomes the
    gateway for its shard).  Phase 2: the per-shard gateways all-reduce
    across clusters (1/N_intra of the naive inter-cluster bytes).  Phase 3:
    all-gather inside the cluster (the blocks concatenated).
    """
    n = axis_size(mesh, intra_axis)
    rows = xs[0].shape[0]
    pad = (-rows) % n
    if pad:
        xs = [torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in xs]
    shard = reduce_scatter(xs, mesh, intra_axis)
    shard = allreduce(shard, mesh, inter_axis)
    full = [g.reshape((-1,) + g.shape[2:])
            for g in allgather(shard, mesh, intra_axis)]
    return [f[:rows] for f in full] if pad else full


def flat_allreduce(xs: Shards, mesh: DeviceMesh, intra_axis: Axis,
                   inter_axis: Axis) -> Shards:
    """Naive single-phase allreduce over both levels (the DFX-style
    baseline the paper argues against: every kernel talks to every
    cluster)."""
    axes = ((intra_axis,) if isinstance(intra_axis, str)
            else tuple(intra_axis))
    axes += ((inter_axis,) if isinstance(inter_axis, str)
             else tuple(inter_axis))
    return allreduce(xs, mesh, axes)


def hier_allgather(xs: Shards, mesh: DeviceMesh, intra_axis: Axis,
                   inter_axis: Axis) -> Shards:
    """Gather within cluster, exchange across clusters via gateways —
    returns (n_inter, n_intra, ...) stacked on every member."""
    return allgather(allgather(xs, mesh, intra_axis), mesh, inter_axis)


# -- point-to-point through the gateway (inter-cluster send, §5.2) -----------


def cluster_send(xs: Shards, mesh: DeviceMesh, inter_axis: str,
                 dst_offset: int = 1) -> Shards:
    """Send x to the next cluster along the ring: member j receives the x
    of member (j - dst_offset) mod n (the reference's collective_permute
    on the pod axis)."""
    def fn(g, i, dev, have):
        return xs[g[(i - dst_offset) % len(g)]].to(dev), False
    return _per_group(xs, mesh, inter_axis, fn)
