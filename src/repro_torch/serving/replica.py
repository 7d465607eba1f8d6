"""One serving replica of the fleet (port of `repro/serving/replica.py`):
a ContinuousBatchingEngine plus the identity and load/hit-rate surface
the FleetRouter routes against.

A replica is a whole single-process serving stack — its own serve plan,
paged arena and radix prefix tree — placed on a device group of the host
(`replica_device_groups`).  The router never reaches inside the engine:
the three methods it needs (`queue_depth`, `projected_occupancy`,
`stats`) are the replica's published surface.

Device groups default to the visible cards, `cuda:i`, and must not
overlap.  A caller that wants replicas to share one card (a one-card
host) passes ``devices=`` itself, e.g. ``[cuda:0, cuda:0]``: the
replicas' kernels then run one after another on it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.scheduler import Request


def replica_device_groups(n: int, width: int = 1,
                          devices: Optional[Sequence] = None) -> List[list]:
    """Partition the devices into `n` groups of `width` (replica i gets
    devices [i*width, (i+1)*width)).  The default list is the visible
    cards.  Raises when the list cannot cover the fleet — the caller chose
    the replica count, so silently overlapping groups would just
    serialize on the hardware."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n * width
    if need > len(devices):
        raise ValueError(
            f"fleet: {n} replicas x {width} devices = {need} devices, "
            f"host has {len(devices)}")
    return [devices[i * width:(i + 1) * width] for i in range(n)]


def make_group_mesh(devs: Sequence, shape: Sequence[int],
                    axes: Sequence[str]) -> DeviceMesh:
    """A mesh over one replica's device group (`launch/mesh.make_mesh`
    always starts at the first card, so fleet placement builds the mesh
    directly)."""
    return DeviceMesh(tuple(shape), tuple(axes), list(devs))


class Replica:
    """Engine + identity.  Owns nothing the engine doesn't already own —
    the value added is the routing surface and per-replica stat deltas."""

    def __init__(self, idx: int, engine: ContinuousBatchingEngine):
        self.idx = idx
        self.engine = engine
        self.routed = 0            # requests this replica was handed
        self.wall_s = 0.0          # cumulative run() wall time
        self._stat0 = dict(engine.stats)  # baseline for delta stats

    # -- routing surface -----------------------------------------------------

    def submit(self, req: Request) -> None:
        self.routed += 1
        self.engine.submit(req)

    def queue_depth(self) -> int:
        return self.engine.sched.queue_depth()

    def projected_occupancy(self) -> int:
        return self.engine.sched.projected_occupancy()

    def run(self) -> List[Request]:
        t0 = time.perf_counter()
        done = self.engine.run()
        self.wall_s += time.perf_counter() - t0
        return done

    # -- per-replica stats (prefix hit rates for the router) -----------------

    def stats(self) -> Dict[str, float]:
        """Engine stat deltas since this replica joined the fleet, plus
        the derived prefix hit rate (hits / admissions; 0.0 before any
        admission)."""
        cur = self.engine.stats
        out: Dict[str, float] = {"replica": self.idx, "routed": self.routed,
                                 "wall_s": round(self.wall_s, 6)}
        for k in ("admitted", "completed", "prefills",
                  "prefix_hits", "prefix_hit_tokens", "preemptions"):
            if k in cur:
                out[k] = cur[k] - self._stat0.get(k, 0)
        admitted = out.get("admitted", 0)
        out["prefix_hit_rate"] = (out.get("prefix_hits", 0) / admitted
                                  if admitted else 0.0)
        return out
