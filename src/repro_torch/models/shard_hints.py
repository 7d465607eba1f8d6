"""The plan context that model code reads (port of
`repro/models/shard_hints.py`).

The reference enables activation sharding constraints for a mesh and lets
XLA's partitioner place everything else.  The port has no partitioner:
the serving executor places each leaf itself (`Shards`: one tensor per
shard of the tensor-parallel group, or per pipeline stage), and the model
code runs the per-shard work and the GMI points between them.  What stays
of the reference's hints:

  * `hint(xs, "gather")` — the GMI gather before a replicated reduction
    projection (serve_exact: gather-form TP, Fig. 14's gather then
    linear_o): the per-shard activations concatenated on their last dim,
    in shard order, on shard 0's device (the controller, where the
    replicated projection runs once).  Bit-identical to one device.
    ``dim=0`` joins the MoE experts' blocks in expert order
    (models/moe.py), where the reference's all-to-all returns them.
  * `hint(xs, "psum")` — the throughput form (serve_psum, ``--no-exact``):
    the per-shard partial products of a row-sharded reduction projection
    summed in shard order on shard 0's device (`gmi.reduce`, Megatron
    TP).  The partials are the shards' f32 sums (`layers.dense(partial=
    True)`), rounded to bf16 once after the sum, so a stream parts from
    one device's only where the f32 sums, added in another order, round
    to another bf16 value.
  * `paged_shard_ctx()` — (mesh, tp axis, tp size) under a serve plan.
  * The layout kinds ('btd', 'bshd', 'bskv', 'btf', 'btv', 'bsni', 'moe',
    'state', 'last') only constrained XLA's placement of an activation;
    there is nothing to constrain here, so they return x as it is.

`fsdp_int8_gather` (int8 FSDP weight gathers) belongs to the sharded
training step and is not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_state = threading.local()


class Shards(list):
    """One leaf of a plan: its per-shard tensors, in shard order.

    axis: the mesh axis it is cut over ("model" for tensor parallel
    leaves, "stage" for a pipeline's); dim: the dim of the full leaf that
    is cut into equal contiguous blocks, or None when every shard holds
    the whole leaf (shards on one device then share one tensor)."""

    def __init__(self, parts, axis: str, dim: Optional[int]):
        super().__init__(parts)
        self.axis, self.dim = axis, dim

    def map(self, fn: Callable, dim: Optional[int] = -1) -> "Shards":
        """fn over the parts (once per distinct tensor, so shared parts
        stay shared); dim -1 keeps this leaf's."""
        done: Dict[int, torch.Tensor] = {}
        out = []
        for p in self:
            if id(p) not in done:
                done[id(p)] = fn(p)
            out.append(done[id(p)])
        return Shards(out, self.axis, self.dim if dim == -1 else dim)

    def distinct(self) -> List[torch.Tensor]:
        """The parts with shared tensors listed once."""
        seen, out = set(), []
        for p in self:
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out


def part(x, i: int):
    """Shard i's view of x: its part of a `Shards`, else x itself."""
    return x[i] if isinstance(x, Shards) else x


def zip_parts(*leaves) -> List[tuple]:
    """Per-shard tuples of the leaves' parts (a leaf that is not `Shards`
    repeats), listing each combination of distinct tensors once."""
    n = max((len(x) for x in leaves if isinstance(x, Shards)), default=1)
    seen, out = set(), []
    for i in range(n):
        tup = tuple(part(x, i) for x in leaves)
        key = tuple(id(t) for t in tup)
        if key not in seen:
            seen.add(key)
            out.append(tup)
    return out


def _cfg() -> Optional[Dict]:
    return getattr(_state, "cfg", None)


@contextmanager
def hints(mesh, dp_axes: Tuple[str, ...] = ("data",), tp_axis: str = "model",
          serve_exact: bool = False, serve_psum: bool = False):
    """The serve plan's context for code run inside it.

    serve_exact=True arms the `hint(x, "gather")` sites (gather-form TP:
    bit-identical serving), serve_psum=True the `hint(x, "psum")` ones
    (the --no-exact throughput form); either publishes the mesh through
    `paged_shard_ctx()`."""
    prev = _cfg()
    _state.cfg = {
        "mesh": mesh,
        "dp": dp_axes,
        "tp": tp_axis,
        "tp_n": mesh.shape[tp_axis],
        "serve_exact": serve_exact,
        "serve_psum": serve_psum,
    }
    try:
        yield
    finally:
        _state.cfg = prev


def paged_shard_ctx() -> Optional[Tuple]:
    """(mesh, tp_axis, tp_n) when a serve_exact/serve_psum hints context
    with more than one tensor-parallel shard is active."""
    c = _cfg()
    if c is None or not (c["serve_exact"] or c["serve_psum"]) \
            or c["tp_n"] <= 1:
        return None
    return c["mesh"], c["tp"], c["tp_n"]


def hint(x, kind: str, dim: int = -1):
    """kind 'gather' (a list of per-shard activations -> one tensor,
    concatenated on `dim` (the last by default; 0 for the MoE experts'
    blocks) in shard order on shard 0's device), 'psum' (a list of
    per-shard partial products -> their sum in shard order on shard 0's
    device), or a layout kind (returned as it is).  A list is gathered (or
    summed) whichever serve form is active: the placement decides which
    list a site holds, and a one-shard list is its part."""
    if kind not in ("gather", "psum") or not isinstance(x, list):
        return x
    if len(x) == 1:
        return x[0]
    root = x[0].device
    if kind == "gather":
        return torch.cat([t.to(root) for t in x], dim)
    acc = x[0]
    for t in x[1:]:
        acc = acc + t.to(root)
    return acc


def broadcast_to(x: torch.Tensor, like: Sequence) -> List[torch.Tensor]:
    """x copied to the device of each shard of `like` (a `Shards` or a
    list of tensors; a part may be a W8A8 {"q", "s"} leaf, on its q's
    device): the GMI broadcast of an activation that the controller holds
    to the shards that use it (one tensor per device)."""
    held: Dict[str, torch.Tensor] = {}
    out = []
    for p in like:
        dev = (p["q"] if isinstance(p, dict) else p).device
        key = str(dev)
        if key not in held:
            held[key] = x if x.device == dev else x.to(dev)
        out.append(held[key])
    return out
