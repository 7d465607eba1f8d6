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

  * `fsdp_int8_gather` — the FSDP weight gather at int8 width, under
    ``hints(int8_gather=True)``: each row of the leaf quantized to int8
    at the scale of its largest |w| (over the whole row, wherever the
    row is cut), the int8 values and the f32 scales what crosses the data
    axis, dequantized at each destination to bf16.  The backward is
    straight through (`_Ste`): the cotangent of the dequantized weight
    goes to the master weight as it is.  On a whole tensor it is the
    reference's function, called at the reference's call sites
    (`attention`'s wq/wk/wv/wo, `mlp`'s wi/wg/wo, the routed experts'
    wi/wg/wo); on a train plan's `Sharded` leaf it is the sharded train
    step's gather (launch/train.py), and the forward's call sites then
    see its blocks (`Shards`), which pass through.
  * `router_stats()` — collects each MoE router's sums over its batch
    while open, for the sharded train step's load-balance loss over the
    global batch (models/moe.py).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cluster_builder import Sharded, spec_axes

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
          int8_gather: bool = False, serve_exact: bool = False,
          serve_psum: bool = False):
    """The plan's context for code run inside it.

    int8_gather=True turns the FSDP weight gathers at `fsdp_int8_gather`
    into int8 transfers.  serve_exact=True arms the `hint(x, "gather")`
    sites (gather-form TP: bit-identical serving), serve_psum=True the
    `hint(x, "psum")` ones (the --no-exact throughput form); either
    publishes the mesh through `paged_shard_ctx()`.  A training context
    sets neither: it publishes no serving plan."""
    prev = _cfg()
    _state.cfg = {
        "mesh": mesh,
        "dp": tuple(dp_axes),
        "tp": tp_axis,
        "tp_n": mesh.shape[tp_axis],
        "int8_gather": int8_gather,
        "serve_exact": serve_exact,
        "serve_psum": serve_psum,
    }
    try:
        yield
    finally:
        _state.cfg = prev


def int8_gather_on() -> bool:
    """Is an ``int8_gather=True`` hints context active?"""
    c = _cfg()
    return bool(c and c["int8_gather"])


def replay():
    """A factory of contexts that put back the hints context active now
    (with no router collection): `torch.utils.checkpoint` recomputes a
    layer period in the backward pass, on another thread on the card,
    and the recompute must see the forward's context."""
    cfg = _cfg()

    @contextmanager
    def ctx():
        prev = (_cfg(), getattr(_state, "router", None))
        _state.cfg, _state.router = cfg, None
        try:
            yield
        finally:
            _state.cfg, _state.router = prev

    return ctx


@contextmanager
def router_stats():
    """Collects, while open, one (Σ router probabilities over the call's
    tokens (E,), Σ top-1 one-hot (E,), tokens) per MoE router call, in
    call order (`record_router`); yields the list."""
    prev = getattr(_state, "router", None)
    _state.router = out = []
    try:
        yield out
    finally:
        _state.router = prev


def record_router(probs: torch.Tensor, top1: torch.Tensor) -> None:
    """A router call's sums, where `router_stats` is collecting: probs
    and top1 (B, S, E)."""
    out = getattr(_state, "router", None)
    if out is not None:
        out.append((probs.sum((0, 1)), top1.sum((0, 1)),
                    probs.shape[0] * probs.shape[1]))


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


# -- the FSDP gather at int8 width ------------------------------------------


class _Ste(torch.autograd.Function):
    """dq forward; the cotangent straight through to w (the reference's
    `_ste`)."""

    @staticmethod
    def forward(ctx, w, dq):
        return dq

    @staticmethod
    def backward(ctx, g):
        return g, None


def int8_rows(w: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """(q int8 of w's shape, s f32 (..., 1)): each row over w's last dim
    at the scale max(max|w|, 1e-12) / 127, q = clip(round(w / s)) with
    round half to even (`jnp.round`'s).  amax: the rows' max|w| where w
    holds a block of each row (the max of the blocks' maxima)."""
    wf = w.float()
    if amax is None:
        amax = wf.abs().amax(-1, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8), s


def _dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.bfloat16) * s.to(torch.bfloat16)


def per_part(fn, *lists) -> list:
    """fn over the lists' parts, once per distinct combination."""
    held: Dict[tuple, object] = {}
    out = []
    for parts in zip(*lists):
        key = tuple(id(p) for p in parts)
        if key not in held:
            held[key] = fn(*parts)
        out.append(held[key])
    return out


def _int8_gather_parts(w, dp: Tuple[str, ...]) -> List[torch.Tensor]:
    """A train plan's `Sharded` leaf (one FSDP block per flat shard) ->
    each flat shard's tensor-parallel block, gathered over the data axes
    at int8: the row maxima's max over the shards that cut the last dim,
    each block quantized at it, its q and (where the rows are cut) s
    gathered with `gmi.allgather_dim`, dequantized at the destination."""
    from repro_torch.core import gmi
    mesh, spec, nd = w.sharding.mesh, w.spec, len(w.shape)

    def axes(d):
        return spec_axes(spec[d]) if d < len(spec) else ()

    amax = per_part(lambda p: p.float().abs().amax(-1, keepdim=True), w)
    if axes(nd - 1):  # the row is cut: the max of its blocks' maxima
        amax = per_part(lambda g: g.amax(0),
                        gmi.allgather(amax, mesh, axes(nd - 1)))
    qs = per_part(int8_rows, w, amax)
    q, s = [x[0] for x in qs], [x[1] for x in qs]
    fd = next((d for d in range(nd) if set(axes(d)) & set(dp)), None)
    if fd is not None:  # int8 q and f32 s cross the data axes
        q = gmi.allgather_dim(q, mesh, axes(fd), fd)
        if fd != nd - 1:
            s = gmi.allgather_dim(s, mesh, axes(fd), fd)
    return per_part(_dequant, q, s)


def fsdp_int8_gather(w, tp_dim: int = 0):
    """The FSDP weight gather at int8 width (the reference's, §Perf B2),
    a no-op outside ``hints(int8_gather=True)``.  A whole tensor (one
    device) -> its dequantized rows, the backward straight through to w;
    a train plan's `Sharded` leaf -> each flat shard's block gathered at
    int8 (`_int8_gather_parts`; the step takes the gradient of those
    blocks as the master's, the same straight-through rule).  A W8A8
    {"q", "s"} leaf and a plan's `Shards` (blocks already gathered) pass
    through.  tp_dim: the dim the reference keeps cut over the
    tensor-parallel axis when it divides (`w.shape[tp_dim] % tp_n`), a
    placement the port takes from `cluster_builder.tp_cut`; the values
    do not depend on it."""
    c = _cfg()
    if c is None or not c["int8_gather"] or isinstance(w, (dict, Shards)):
        return w
    if isinstance(w, Sharded):
        return _int8_gather_parts(w, c["dp"])
    with torch.no_grad():
        q, s = int8_rows(w)
        dq = _dequant(q, s)
    return _Ste.apply(w, dq)
