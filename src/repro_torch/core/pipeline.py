"""Pipeline parallelism over clusters (paper §7.2 + §8 Eq. 1 runtime; port
of `repro/core/pipeline.py`).

The paper deploys I-BERT as one encoder per 6-FPGA cluster, clusters chained
serially in dataflow; the full-model latency follows Eq. 1
``T + (L-1)(X+d)``.  Here stage = cluster, the stage axis is a mesh axis,
microbatches stream GPipe-style and move between stages with
`gmi.cluster_send` — the single-controller form of the paper's
gateway-to-gateway inter-cluster messages.

Stage s holds its slice of the stacked stage parameters on its own
device; at tick t it applies its layers to microbatch (t - s) and hands
the activation to stage s + 1.  Total ticks = n_micro + n_stages - 1,
i.e. Eq. 1 with X = T_stage.  One process issues every stage's work in
tick order; on a host with a card per stage the launches of one tick run
on their cards side by side.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.core import gmi
from repro_torch.launch.mesh import DeviceMesh


def pipeline_steps(n_micro: int, n_stages: int) -> int:
    return n_micro + n_stages - 1


def gpipe_forward_perm(n_stages: int):
    """The forward send pairs of the GPipe schedule — stage s hands its
    activation to s+1 (the last stage's wrap-around carries an activation
    no active stage ever reads).  Shared by `pipelined_apply` and the
    serving executor's pipelined decode loop, so the schedule can't drift
    between the two."""
    return [(i, (i + 1) % n_stages) for i in range(n_stages)]


def stage_devices(mesh: DeviceMesh, axis: str) -> List[torch.device]:
    """The device of each stage: the first group along `axis` (the stages
    are replicated over any other axis, and one copy runs)."""
    return [mesh.device(f) for f in mesh.groups(axis)[0]]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def stage_slices(stage_params: Any, devices: List[torch.device]) -> list:
    """Stage s's slice of every leaf's leading (stage) dim, on its
    device."""
    return [_tree_map(lambda p: p[s].to(dev), stage_params)
            for s, dev in enumerate(devices)]


def pipelined_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    mesh: DeviceMesh, axis: str, stage_params: Any,
                    x_micro: torch.Tensor) -> torch.Tensor:
    """Run x through n_stages stage_fns, GPipe-schedule over `axis`.

    stage_params: pytree (nested dicts / tuples) of tensors with leading
    dim n_stages.  x_micro: (n_micro, mb, ...) microbatched input.
    Returns (n_micro, mb, ...) outputs of the final stage, on x_micro's
    device.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    steps = pipeline_steps(n_micro, n_stages)
    devs = stage_devices(mesh, axis)
    ring = DeviceMesh((n_stages,), (axis,), devs)
    params = stage_slices(stage_params, devs)
    buf = [torch.zeros_like(x_micro[0], device=d) for d in devs]
    out = torch.zeros_like(x_micro, device=devs[-1])
    for t in range(steps):
        ys = []
        for s in range(n_stages):
            # stage 0 ingests microbatch t; the others take what arrived
            x_in = (x_micro[min(t, n_micro - 1)].to(devs[0]) if s == 0
                    else buf[s])
            active = s <= t < s + n_micro
            ys.append(stage_fn(params[s], x_in) if active else buf[s])
        oslot = t - (n_stages - 1)
        if oslot >= 0:  # the last stage's result for microbatch oslot
            out[oslot] = ys[-1]
        buf = gmi.cluster_send(ys, ring, axis)
    return out.to(x_micro.device)
