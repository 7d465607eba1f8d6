"""Mixture-of-Experts FFN: top-k routing with capacity-dropping dense
dispatch (port of `repro/models/moe.py`).

Each batch row is one routing group.  The router runs in f32; the top k
experts of a token are taken in descending probability, the lower expert
index first on equal probabilities (`jax.lax.top_k`'s order, which
`torch.topk` does not promise), and their gates renormalised to sum to
1.  Every (token, choice) pair is ranked within its expert by an
exclusive running count in routing order (token-major, choice-minor); a
pair ranked at or past the expert's capacity is dropped and reaches the
block's output only through the residual.  The capacity is set per call
from that call's sequence length, ``ceil(top_k * S * capacity_factor /
E)``, so a prefill bucket or a verify block of T tokens routes otherwise
than T single-token decode steps: the reference's semantics, kept.

Dispatch is dense, as in the reference: every expert computes all of its
`cap` slots, filled or not, in three bf16 batched products over the
experts.  The slots of all groups sit in one expert-major buffer, (E, B *
cap) rows and one overflow row last, filled by one `index_put`; dropped
pairs all land on the overflow row, which is cut off, so the order of
those duplicate writes does not matter.  The combine gathers each pair's
row back (the overflow row reads zeros), weights it by its gate times
its keep mask in bf16 and sums over the k choices (f32 accumulation,
rounded once).  Shared experts are a plain bf16 MLP of width
``n_shared_experts * d_ff`` added to the routed sum.

Under a tensor-parallel serve plan (`Shards` leaves) the router runs
once, whole, on the controller, so every shard drops the same pairs;
shard i runs the experts of its block of E / n, and the shared experts
split by column as the MLP does (`layers.ffn`).  No expert's
contraction is cut, so in an exact plan the output is one device's bit
for bit (`_experts`).

The experts' SiLU is the reference's on a bf16 array, ``x *
logistic(x)``, whose lowering rounds each of its ops to bf16 (negate,
exp, add 1, reciprocal, multiply); `F.silu` rounds once and gives ~40%
of the routed outputs other bits, up to 0.03 off.  With the same chain
the routed and shared products equal the reference's bit for bit
(tests/test_torch_moe.py).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, at_lanes, by_column, ffn
from repro_torch.models.shard_hints import (Shards, fsdp_int8_gather, hint,
                                            part, record_router)

Params = Dict[str, Any]


class Routing(NamedTuple):
    """One call's routing, groups = batch rows.  gates, experts: (B, S, k)
    renormalised gate values (f32) and expert ids (int64); rank: (B, S*k)
    each pair's rank within its expert, in routing order; keep: (B, S*k)
    rank < cap; aux: the load-balance loss (0-d f32); cap: the capacity."""
    gates: torch.Tensor
    experts: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    cap: int


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(math.ceil(cfg.top_k * tokens_per_group * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, 1)


def _router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w)


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x), each op rounded to x's dtype."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _act(cfg):
    return _silu_bf16 if cfg.act == "silu" else act_fn(cfg.act)


def route(x: torch.Tensor, p: Params, cfg, columns: bool = False
          ) -> Routing:
    """The router, top-k, the aux loss and the capacity ranks of x (B, S,
    D).  columns: run the router's product one query column at a time (a
    verify pass; `layers.dense`)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, s)
    if columns and s > 1:
        logits = by_column(_router_logits, x, p["router"])
    else:
        logits = _router_logits(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = srt[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): e * sum_e f_e * p_e
    top1 = F.one_hot(experts[..., 0], e).float()
    me = probs.mean(dim=(0, 1))
    ce = top1.mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    record_router(probs, top1)  # the sharded train step's global batch

    flat = experts.reshape(b, s * k)
    onehot = F.one_hot(flat, e).to(torch.int32)  # (B, S*k, E)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    rank = before.gather(-1, flat[..., None])[..., 0]
    return Routing(gates, experts, rank, rank < cap, aux, cap)


def _hidden(xe: torch.Tensor, wi, wg, cfg, act) -> torch.Tensor:
    """The experts' hidden rows: act(xe wg) * (xe wi), or act(xe wi)."""
    hi = torch.bmm(xe, wi)
    if cfg.mlp_style == "swiglu":
        return act(torch.bmm(xe, wg)) * hi
    return act(hi)


def _experts(xe: torch.Tensor, p: Params, cfg, act) -> torch.Tensor:
    """The routed experts over their slots, xe (E, rows, D) -> (E, rows,
    D).  Under a tensor-parallel plan `wi` and `wg` are `Shards` of E / n
    experts each: shard i takes its experts' block of xe on its device
    (the single-controller form of the reference's all-to-all at
    ``hint(xe, "moe")``) and runs their products; the blocks join in
    expert order on the controller, the hidden rows before a whole `wo`
    (an exact plan: one product over all E experts, one device's shape)
    or each shard's outputs where `wo` is `Shards` too (``exact=False``).
    No expert's contraction is cut, so nothing is summed across shards:
    each expert's rows are its own products'.  On the card a block of
    E / n experts gives the same bits as those experts of the E-expert
    call (chip_smoke.py's expert probe holds it)."""
    # the FSDP gathers at int8 width under hints(int8_gather=True)
    wi, wo = fsdp_int8_gather(p["wi"]), fsdp_int8_gather(p["wo"])
    wg = fsdp_int8_gather(p["wg"]) if "wg" in p else None
    ws = wi if isinstance(wi, Shards) else [wi]
    per = xe.shape[0] // len(ws)
    hs = [_hidden(xe[i * per:(i + 1) * per].to(w.device), w, part(wg, i),
                  cfg, act) for i, w in enumerate(ws)]
    if isinstance(wo, Shards):
        return hint([torch.bmm(h, w) for h, w in zip(hs, wo)], "gather",
                    dim=0)
    return torch.bmm(hint(hs, "gather", dim=0), wo)


def moe_ffn(x: torch.Tensor, p: Params, cfg, columns: bool = False,
            lanes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) bf16 -> (y (B, S, D) bf16, aux 0-d f32).  columns: a
    verify pass, whose router product runs one query column at a time as
    a decode step's does (its f32 product is cuBLAS's, whose rows part by
    row count; the shared experts' bf16 products are K-ordered, one
    product of B*S rows); the routed experts group each row's S tokens
    together, as the reference's verify pass does.

    lanes: (rows, n) when x holds the lanes `rows` of an n-lane batch (a
    serve_pipeline stage's microbatch or lane group).  The FFN then runs
    at one device's shape, x at its own lanes of a zero n-lane input
    (`layers.at_lanes`), and returns those lanes' rows, so that the
    router's f32 product and the expert products, cuBLAS's, give each row
    one device's bits.  Every batch row is its own routing group and the
    capacity comes from S, so the zero lanes take only their own slots
    and change no real row's routing; aux is the n-lane call's."""
    if lanes is not None:
        y, aux = moe_ffn(at_lanes(x, lanes), p, cfg, columns)
        return y[lanes[0]], aux
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(x, p, cfg, columns)
    cap = r.cap
    act = _act(cfg)

    # expert-major dispatch: pair -> row e * (B * cap) + b * cap + rank,
    # dropped pairs -> the overflow row E * B * cap
    flat = r.experts.reshape(b, s * k)
    lane = torch.arange(b, device=x.device)[:, None]
    n_rows = e * b * cap
    dest = torch.where(r.keep, flat * (b * cap) + lane * cap + r.rank,
                       torch.full_like(flat, n_rows))
    src = x.repeat_interleave(k, dim=1)  # (B, S*k, D), routing order
    buf = torch.zeros((n_rows + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest.reshape(-1),), src.reshape(-1, d))
    xe = buf[:n_rows].view(e, b * cap, d)

    ye = _experts(xe, p, cfg, act).reshape(n_rows, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    back = ye[dest]  # (B, S*k, D)
    w = (r.gates.reshape(b, s * k) * r.keep).to(x.dtype)
    y = torch.sum((back * w[..., None]).reshape(b, s, k, d), dim=2)

    if cfg.n_shared_experts:
        y = y + ffn(x, p["shared_wi"], p["shared_wg"] if cfg.mlp_style
                    == "swiglu" else None, p["shared_wo"], act)
    return y, r.aux
