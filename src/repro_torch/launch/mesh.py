"""Device meshes for the port's single-controller plans (port of
`repro/launch/mesh.py`).

A `DeviceMesh` is named axes over a list of `torch.device`s: shard i of
the mesh, in row-major order over its axes, runs on ``devices[i]``.  One
process drives every shard (the reference's `shard_map` program, without
a partitioner): each shard's kernels launch on that shard's device, and
the GMI collectives (`core/gmi.py`) are copies, concatenations and sums
over the per-shard tensors in a fixed shard order.

``mesh.shape[axis]`` reads like the JAX mesh's.  `make_mesh` puts shard i
on ``cuda:(i % torch.cuda.device_count())``: on a host with fewer cards
than shards, several shards share one card (`shared_devices()` says so),
and their kernels then run one after another on it — the program and its
contract are the same, the scaling is not.  ``device="cpu"`` puts every
shard on the CPU (the kernels' plain versions).  `make_abstract_mesh` has
no devices, for spec-only planning.

Mesh shapes of the reference's production plans (TPU v5e pods):
  single-pod: (16, 16)    axes (data, model)          = 256 devices
  multi-pod:  (2, 16, 16) axes (pod, data, model)     = 512 devices
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


class DeviceMesh:
    """Named axes over a row-major list of devices (None: abstract)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        dims = tuple(int(s) for s in shape)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {dims} vs axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        # {axis: size}, in axis order, as jax's Mesh.shape
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.size = 1
        for s in dims:
            self.size *= s
        self.devices: Optional[List[torch.device]] = (
            None if devices is None else [torch.device(d) for d in devices])
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} shards")

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape})"

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def coords(self, flat: int) -> Dict[str, int]:
        """The axis coordinates of flat shard `flat` (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = flat % self.shape[name]
            flat //= self.shape[name]
        return {a: out[a] for a in self.axis_names}

    def axis_index(self, flat: int, axis) -> int:
        """The shard's index along `axis` (a name or a tuple of names,
        row-major over the tuple), as `lax.axis_index`."""
        c = self.coords(flat)
        if isinstance(axis, str):
            return c[axis]
        i = 0
        for a in axis:
            i = i * self.shape[a] + c[a]
        return i

    def axis_size(self, axis) -> int:
        if isinstance(axis, str):
            return self.shape[axis]
        n = 1
        for a in axis:
            n *= self.shape[a]
        return n

    def groups(self, axis) -> List[List[int]]:
        """The communicator groups of `axis`: lists of flat shard indices
        that share every other coordinate, each in axis-index order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        out: Dict[tuple, List[int]] = {}
        for f in range(self.size):
            c = self.coords(f)
            key = tuple(c[a] for a in self.axis_names if a not in names)
            out.setdefault(key, []).append(f)
        for g in out.values():
            g.sort(key=lambda f: self.axis_index(f, names))
        return list(out.values())

    def device(self, flat: int) -> torch.device:
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[flat]

    def shared_devices(self) -> bool:
        """Do two or more shards run on one device?"""
        return (self.devices is not None
                and len(set(self.devices)) < len(self.devices))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of `shape` over the visible cards: shard i on
    ``cuda:(i % torch.cuda.device_count())``, so shards share a card when
    the mesh is larger than the host (their kernels then run one after
    another there).  ``device="cpu"`` puts every shard on the CPU.  Raises
    when CUDA is asked for and there is no card."""
    n = 1
    for s in shape:
        n *= int(s)
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass device='cpu' for the plain path")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", i % count) for i in range(n)]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"make_mesh: device {device!r}: want cuda or cpu")
    return DeviceMesh(shape, axes, devs)


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]
                       ) -> DeviceMesh:
    """Device-free mesh for spec-only planning (tests, plan inspection)."""
    return DeviceMesh(shape, axes, None)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def required_devices(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
