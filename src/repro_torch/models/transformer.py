"""Decoder backbone, prefill, the fused greedy decode loop and greedy
speculative decoding (port of `repro/models/transformer.py`; every
family).

Parameters keep the JAX package's layout: {"embed", "scan", "tail",
"final_norm"}, with every "scan" leaf stacked on a leading layer-period
axis (1 for the attention-only families and moonshot's all-MoE layers,
2 for llama4's dense then MoE layer, 3 for recurrentgemma's rglru,
rglru, attn, 8 for xLSTM's 7 mLSTM : 1 sLSTM); the remainder layers
(recurrentgemma's 26 = 8 x 3 + 2) sit unstacked under "tail".  The
backbone is a Python loop over the periods, indexing one period's
parameter and cache views at a time.  Caches follow the same layout: an
attention block holds KV rows (models/attention.py), a recurrent one its
state (models/recurrent.py), and the serving path updates both in place.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import kv_quantize
from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.moe import moe_ffn
from repro_torch.models import shard_hints
from repro_torch.models.shard_hints import Shards, zip_parts
from repro_torch.models.layers import (
    COMPUTE_DTYPE, at_lanes, cross_entropy_sums, embed, lm_head, mlp, norm,
)

Params = Dict[str, Any]

KPOS_SENTINEL = attn_mod.KPOS_SENTINEL


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


def period_length(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid" and cfg.block_pattern:
        return len(cfg.block_pattern)
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    if cfg.n_experts and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def layer_plan(cfg: ModelConfig) -> Tuple[int, int, List[str]]:
    """(n_repeat, tail_len, kinds-of-one-period)."""
    p = period_length(cfg)
    kinds = [cfg.block_kind(i) for i in range(p)]
    return cfg.n_layers // p, cfg.n_layers % p, kinds


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------


_RECURRENT = {"rglru": rec_mod.rglru_block, "mlstm": rec_mod.mlstm_block,
              "slstm": rec_mod.slstm_block}


def _write_state(state, new, active) -> None:
    """A recurrent block's new state into its cache leaves, in place; an
    inactive lane keeps its old state.  A leaf a serve plan cuts
    (`Shards`) is written part by part, each on its own device."""
    for name, leaf in state.items():
        for old, val in zip_parts(leaf, new[name]):
            val = val.to(old.dtype)
            if active is not None:
                gate = active.to(old.device).reshape(
                    (-1,) + (1,) * (old.dim() - 1))
                val = torch.where(gate, val, old)
            old.copy_(val)


def block_apply(cfg: ModelConfig, pos_in_period: int, p: Params,
                h: torch.Tensor, positions: torch.Tensor, segment_ids, state,
                pos_contiguous: bool = False, page_table=None, active=None,
                lanes=None):
    """The block at `pos_in_period` of a layer period: the pre-norm mixer
    of its kind ("attn", "rglru", "mlstm", "slstm"), then (all but the
    xLSTM family's blocks) a pre-norm MLP, or the MoE FFN on a MoE layer,
    each added to the residual.  Returns (h, aux): the MoE layer's
    load-balance loss, else None.  `state` (a KV cache or a recurrent
    state) is updated in place; a recurrent state keeps an inactive lane's
    values, and pad steps (positions at 2^30, or segment -1) leave it
    alone.

    lanes: (rows, n) when h holds the lanes `rows` of an n-lane batch (a
    serve_pipeline stage's microbatch or lane group; positions and active
    are those lanes', a dense `state` holds all n).  Attention then reads
    and writes the rows' views of a dense cache; a recurrent mixer and the
    MoE FFN, whose products are cuBLAS's, run at one device's n lanes (h
    at its lanes, zeros and pad steps elsewhere: `layers.at_lanes`) and
    only the rows' state is written, so each row gets one device's bits."""
    kind = cfg.block_kind(pos_in_period)
    rows = None if lanes is None else lanes[0]
    z = norm(h, p["norm1"], cfg)
    if kind == "attn":
        if rows is not None and page_table is None and state is not None:
            state = {k: v[rows] for k, v in state.items()}
        y, _ = attn_mod.attention(z, p["mix"], cfg, positions, segment_ids,
                                  cache=state, pos_contiguous=pos_contiguous,
                                  page_table=page_table, active=active)
    else:
        valid = positions < 2 ** 29
        if segment_ids is not None:
            valid = valid & (segment_ids >= 0)
        if rows is None:
            y, new = _RECURRENT[kind](z, p["mix"], cfg, state, valid)
        else:
            y, new = _RECURRENT[kind](at_lanes(z, lanes), p["mix"], cfg,
                                      state, at_lanes(valid, lanes))
            y, new = y[rows], {k: v[rows] for k, v in new.items()}
            state = {k: v[rows] for k, v in state.items()}
        if state is not None:
            _write_state(state, new, active)
    h = h + y
    aux = None
    if "ffn" in p:
        z = norm(h, p["norm2"], cfg)
        if cfg.is_moe_layer(pos_in_period):
            y, aux = moe_ffn(z, p["ffn"], cfg, columns=page_table is not None,
                             lanes=lanes)
        else:
            y = mlp(z, p["ffn"], cfg)
        h = h + y
    return h, aux


def greedy_token_update(logits, cur, active, remaining, eos_id, pad_token):
    """One step of the fused decode loop's token state machine (no forced
    queue): greedy argmax, -1 emission for masked lanes, EOS/budget lane
    exit, pad feedback.  Returns (emit, cur, active, remaining)."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    emit = torch.where(active, nxt, torch.full_like(nxt, -1))
    remaining = torch.where(active, remaining - 1, remaining)
    still = active & (nxt != eos_id) & (remaining > 0)
    cur = torch.where(still, nxt, torch.full_like(nxt, pad_token))
    return emit, cur, still, remaining


def forced_token_update(logits, cur, active, remaining, eos_id, pad_token,
                        forced, forced_len, forced_ptr):
    """One step of the fused decode loop's token state machine with a
    forced-token queue (`decode_steps`): while ``forced_ptr < forced_len``
    the lane's output is swallowed (-1), its budget kept and the queued
    token fed; the step that consumes its last pending input emits the
    first generated token.  Returns (emit, cur, active, remaining,
    forced_ptr)."""
    lane = torch.arange(cur.shape[0], device=cur.device)
    fcap = forced.shape[1]
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    pending = forced_ptr < forced_len  # this step's output is swallowed
    emitting = active & ~pending
    emit = torch.where(emitting, nxt, torch.full_like(nxt, -1))
    remaining = torch.where(emitting, remaining - 1, remaining)
    still = active & (pending | ((nxt != eos_id) & (remaining > 0)))
    feed = torch.where(
        pending,
        forced[lane, torch.clamp(forced_ptr, max=fcap - 1).long()], nxt)
    cur = torch.where(still, feed, torch.full_like(feed, pad_token))
    forced_ptr = torch.where(active & pending, forced_ptr + 1, forced_ptr)
    return emit, cur, still, remaining, forced_ptr


def spec_acceptance(ins, tgt, active, remaining, eos_id, pad_token,
                    forced, forced_len, forced_ptr):
    """The acceptance state machine of one speculative block, vectorised
    over lanes.

    ins: (B, T) the block's input tokens (T = k+1; column 0 is the lane's
    current input, later columns are forced-queue tokens or draft
    proposals); tgt: (B, T) the target's greedy argmax at each position.
    It follows `decode_steps`' forced-queue rules step for step: step j's
    output is swallowed while ``forced_ptr + j < forced_len``; a drafted
    input (one the forced queue did not cover) is consumed only if it
    equals the target's argmax at the step before; the first divergence
    emits the target's own argmax, which is ``tgt[:, j-1]``, already
    emitted — so rejection costs nothing and the emitted stream equals
    plain greedy decoding.

    Returns (emit (T, B) with -1 holes, cur, alive, remaining, forced_ptr,
    n_consumed): `n_consumed` is how many block positions the sequential
    run would have taken, the advance of both caches' position counters.
    """
    b, t = ins.shape
    lane = torch.arange(b, device=ins.device)
    fcap = forced.shape[1]
    valid = active  # step 0's input is the lane's own cur: always matched
    alive = active
    rem = remaining
    n_consumed = torch.zeros((b,), dtype=torch.int32, device=ins.device)
    minus1 = torch.full((b,), -1, dtype=torch.int32, device=ins.device)
    emits = []
    for j in range(t):
        if j > 0:
            drafted = (forced_ptr + j - 1) >= forced_len
            matched = ~drafted | (ins[:, j] == tgt[:, j - 1])
            valid = valid & matched & alive
        n_consumed = n_consumed + valid.to(torch.int32)
        swallowed = (forced_ptr + j) < forced_len
        emitting = valid & ~swallowed
        emits.append(torch.where(emitting, tgt[:, j], minus1))
        rem = torch.where(emitting, rem - 1, rem)
        exited = emitting & ((tgt[:, j] == eos_id) | (rem <= 0))
        alive = alive & ~exited
    # the next input of the sequential run: the first unconsumed step's
    # input — a still-pending forced token, or the target's argmax at the
    # last consumed step (the correction on divergence, the bonus token on
    # full acceptance; both already emitted)
    idx = forced_ptr + n_consumed - 1
    nxt = torch.where(
        idx < forced_len,
        forced[lane, torch.clamp(idx, 0, fcap - 1).long()],
        tgt[lane, torch.clamp(n_consumed - 1, 0, t - 1).long()])
    cur = torch.where(alive, nxt.to(torch.int32),
                      torch.full_like(minus1, pad_token))
    fptr = forced_ptr + torch.minimum(
        torch.clamp(forced_len - forced_ptr, min=0), n_consumed)
    return (torch.stack(emits), cur, alive, rem, fptr.to(torch.int32),
            n_consumed)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters in the JAX layout, drawn from a torch.Generator.

    Same shapes, dtypes and scales as `repro.models.transformer
    .init_params` (normal weights scaled 1/sqrt(d_in), embeddings and the
    f32 MoE router 0.02, norm gains 1 and layernorm biases 0), but torch's
    generator gives other numbers than jax.random from the same seed; load
    JAX weights with `models.convert.params_from_jax` to compare with the
    reference.  Stacked expert weights are drawn one (d_in, d_out) expert
    slice at a time into their bf16 leaf, so no f32 copy of a whole leaf
    (35 GB for moonshot-v1-16b-a3b's `wi`) is ever made.
    """
    n_rep, tail, kinds = layer_plan(cfg)
    gen = None  # device="meta": the shapes alone (a plan's --dryrun)
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(COMPUTE_DTYPE)

    def dense_w(lead, d_in, d_out):
        return normal(lead + (d_in, d_out), d_in ** -0.5)

    def norm_p(lead, d):
        """Gain 1 (and, for layernorm, bias 0), f32."""
        p = {"g": torch.ones(lead + (d,), dtype=torch.float32,
                             device=device)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros_like(p["g"])
        return p

    def f32(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def mixer(kind, lead):
        d, hd = cfg.d_model, cfg.head_dim
        if kind == "attn":
            return {"wq": dense_w(lead, d, cfg.n_heads * hd),
                    "wk": dense_w(lead, d, cfg.n_kv_heads * hd),
                    "wv": dense_w(lead, d, cfg.n_kv_heads * hd),
                    "wo": dense_w(lead, cfg.n_heads * hd, d)}
        if kind == "rglru":
            w = cfg.rnn_width or d
            # lam such that a = sigmoid(lam)^c lies in [0.9, 0.999]
            u = 0.9 + 0.099 * torch.rand(lead + (w,), generator=gen,
                                         device=device)
            uc = u ** (1 / rec_mod._RGLRU_C)
            return {"w_gate_in": dense_w(lead, d, w),
                    "w_x_in": dense_w(lead, d, w),
                    "conv": f32(lead + (cfg.conv_width, w)) * 0.02,
                    "w_rgate": dense_w(lead, w, w),
                    "w_igate": dense_w(lead, w, w),
                    "w_out": dense_w(lead, w, d),
                    "lam": torch.log(uc / (1 - uc))}
        nh = cfg.n_heads
        if kind == "mlstm":
            inner, _, ih, dk = rec_mod._mlstm_dims(cfg, d)
            return {"up_z": dense_w(lead, d, inner),
                    "up_g": dense_w(lead, d, inner),
                    "wq": normal(lead + (nh, ih, dk), ih ** -0.5),
                    "wk": normal(lead + (nh, ih, dk), ih ** -0.5),
                    "wv": normal(lead + (nh, ih, ih), ih ** -0.5),
                    "w_if": dense_w(lead, d, 2 * nh),
                    "down": dense_w(lead, inner, d)}
        dh, glu_d = d // nh, int(4 * d / 3)  # slstm
        return {"w_in": dense_w(lead, d, 4 * d),
                "r": f32(lead + (4, nh, dh, dh)) / math.sqrt(dh),
                "glu_wi": dense_w(lead, d, 2 * glu_d),
                "glu_wo": dense_w(lead, glu_d, d)}

    def experts(lead, d_in, d_out):
        w = torch.empty(lead + (cfg.n_experts, d_in, d_out),
                        dtype=COMPUTE_DTYPE, device=device)
        for one in w.view(-1, d_in, d_out):
            one.copy_(dense_w((), d_in, d_out))
        return w

    def moe(lead):
        d, f = cfg.d_model, cfg.d_ff
        p = {"router": f32(lead + (d, cfg.n_experts)) * 0.02,
             "wi": experts(lead, d, f), "wo": experts(lead, f, d)}
        if cfg.mlp_style == "swiglu":
            p["wg"] = experts(lead, d, f)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p["shared_wi"] = dense_w(lead, d, fs)
            p["shared_wo"] = dense_w(lead, fs, d)
            if cfg.mlp_style == "swiglu":
                p["shared_wg"] = dense_w(lead, d, fs)
        return p

    def block(pos_in_period, lead):
        d, kind = cfg.d_model, cfg.block_kind(pos_in_period)
        p = {"norm1": norm_p(lead, d), "mix": mixer(kind, lead)}
        if cfg.family == "ssm":  # xLSTM blocks carry no MLP
            return p
        p["norm2"] = norm_p(lead, d)
        if cfg.is_moe_layer(pos_in_period):
            p["ffn"] = moe(lead)
        elif cfg.mlp_style != "none" and cfg.d_ff:
            p["ffn"] = {"wi": dense_w(lead, d, cfg.d_ff),
                        "wo": dense_w(lead, cfg.d_ff, d)}
            if cfg.mlp_style == "swiglu":
                p["ffn"]["wg"] = dense_w(lead, d, cfg.d_ff)
        return p

    emb = {"tok": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        emb["head"] = normal((cfg.d_model, cfg.vocab_size), 0.02)
    return {
        "embed": emb,
        "scan": ({f"b{i}": block(i, (n_rep,))
                  for i in range(len(kinds))} if n_rep else {}),
        "tail": {str(t): block(t, ()) for t in range(tail)},
        "final_norm": norm_p((), cfg.d_model),
    }


def _index(tree, i: int):
    """Period i's view of a scan-stacked (params or cache) subtree.  Under
    a plan a leaf may be `Shards`: a pipeline's (cut over the period axis,
    each stage holding a contiguous block of periods) gives the owning
    stage's period; a tensor-parallel one gives each shard's period."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, Shards):
        if tree.dim == 0:
            per = tree[0].shape[0]
            return tree[i // per][i % per]
        return tree.map(lambda t: t[i],
                        None if tree.dim is None else tree.dim - 1)
    return tree[i]


def _tree_device(tree):
    """The device of a subtree's first tensor leaf (None: no tensor)."""
    if isinstance(tree, dict):
        for v in tree.values():
            d = _tree_device(v)
            if d is not None:
                return d
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


# ---------------------------------------------------------------------------
# cache trees
# ---------------------------------------------------------------------------


def cache_map(fn, *trees):
    """Map ``fn(batch_axis, *leaves)`` over cache trees ``{"scan": ...,
    "tail": ..., "pos": ...}``: leaves under "scan" carry the stacked
    period axis first, so their batch axis is 1; every other leaf has it
    at 0."""

    def go(axis, *subs):
        if isinstance(subs[0], dict):
            return {k: go(axis, *[s[k] for s in subs]) for k in subs[0]}
        return fn(axis, *subs)

    return {k: go(1 if k == "scan" else 0, *[t[k] for t in trees])
            for k in trees[0]}


def paged_cache_map(fn, *trees):
    """Map ``fn(page_axis, leaf_name, *leaves)`` over the scan/tail arena
    leaves of paged cache trees.

    Arena leaves ((P, ps, ...) under "tail", (n_rep, P, ps, ...) under
    "scan") have a *page* axis where dense slot caches have a batch axis;
    top-level "pos"/"pt" are per-lane and pass through from the first
    tree.
    """

    def go(axis, name, *subs):
        if isinstance(subs[0], dict):
            return {k: go(axis, k, *[s[k] for s in subs]) for k in subs[0]}
        return fn(axis, name, *subs)

    return {k: (go(1 if k == "scan" else 0, k, *[t[k] for t in trees])
                if k in ("scan", "tail") else trees[0][k])
            for k in trees[0]}


def cache_is_quantized(tree) -> bool:
    """Does this (sub)tree hold int8 KV arenas (k_scale planes present)?"""
    if isinstance(tree, dict):
        return "k_scale" in tree or any(cache_is_quantized(v)
                                        for v in tree.values())
    return False


def quantize_kv_tree(tree):
    """A dense bf16 cache tree with its attention leaves ({"k", "v",
    "kpos"}) in the int8 arena's layout ({"k", "v": int8, "k_scale",
    "v_scale": f32, "kpos"}): `kv_quantize` per cache row per kv head, the
    rule the decode scatter applies row by row, so a prefix hit's suffix
    ingest stays bit-identical to a cold prefill under int8 KV too."""
    if not isinstance(tree, dict):
        return tree
    if "k" in tree and "kpos" in tree and "k_scale" not in tree:
        out = {"kpos": tree["kpos"]}
        for name in ("k", "v"):
            x = tree[name]
            if isinstance(x, Shards):  # each shard its own kv heads' scales
                pairs = x.map(kv_quantize)
                out[name] = Shards([q for q, _ in pairs], x.axis, x.dim)
                out[name + "_scale"] = Shards([sc for _, sc in pairs],
                                              x.axis, x.dim)
            else:
                out[name], out[name + "_scale"] = kv_quantize(x)
        return out
    return {k: quantize_kv_tree(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


class Model:
    """Binds a ModelConfig and a device to the apply functions."""

    def __init__(self, cfg: ModelConfig, device="cuda", remat: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        # recompute each layer period's activations in the backward pass
        # instead of keeping them (the reference's jax.checkpoint with
        # nothing_saveable); only while autograd records a cache-free call
        self.remat = remat

    # -- core --------------------------------------------------------------

    def backbone(self, params: Params, h: torch.Tensor,
                 positions: torch.Tensor, segment_ids=None, caches=None,
                 pos_contiguous: bool = False, page_table=None, active=None):
        """h (B,S,D) embeddings -> (final-normed h, aux): aux is the sum
        of the MoE layers' load-balance losses (0-d f32, summed per period
        and then over periods, as the reference's scan does), None in a
        model without them.  Cache leaves are updated in place; the page
        table is shared by every layer.  With `remat`, a call without
        caches that autograd records runs each period under
        `torch.utils.checkpoint` (its activations recomputed in the
        backward pass, through the same product routes, so the gradients
        are the same bits); the tail's blocks are kept, as the
        reference's are."""
        cfg = self.cfg
        n_rep, tail, kinds = layer_plan(cfg)
        kw = dict(pos_contiguous=pos_contiguous, page_table=page_table,
                  active=active)
        aux = None
        remat = self.remat and caches is None and torch.is_grad_enabled()
        # the recompute sees the forward's hints context (on the card it
        # runs on autograd's device thread)
        replay = shard_hints.replay() if remat else None

        def add(total, a):
            return a if total is None else (total if a is None else total + a)

        def period_fn(h, pp, pc, positions, segment_ids):
            period = None
            for j in range(len(kinds)):
                h, a = block_apply(cfg, j, pp[f"b{j}"], h, positions,
                                   segment_ids,
                                   None if pc is None else pc[f"b{j}"], **kw)
                period = add(period, a)
            return h, period

        for i in range(n_rep):
            pp = _index(params["scan"], i)
            pc = None if caches is None else _index(caches["scan"], i)
            dev = _tree_device(pp)
            if dev is not None and dev != h.device:
                # a pipeline plan's next stage: the activation (and the
                # lanes' routing) moves to the stage's device
                h, positions = h.to(dev), positions.to(dev)
                segment_ids, kw["page_table"], kw["active"] = (
                    None if t is None else t.to(dev)
                    for t in (segment_ids, kw["page_table"], kw["active"]))
            if remat:
                h, period = torch.utils.checkpoint.checkpoint(
                    period_fn, h, pp, pc, positions, segment_ids,
                    use_reentrant=False, preserve_rng_state=False,
                    context_fn=lambda: (contextlib.nullcontext(), replay()))
            else:
                h, period = period_fn(h, pp, pc, positions, segment_ids)
            aux = add(aux, period)
        for t in range(tail):
            st = None if caches is None else caches["tail"][str(t)]
            h, a = block_apply(cfg, t, params["tail"][str(t)], h,
                               positions, segment_ids, st, **kw)
            aux = add(aux, a)
        root = params["final_norm"]["g"].device
        return norm(h.to(root), params["final_norm"], cfg), aux

    # -- caches ------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int):
        """Dense per-lane cache (the prefill bucket cache), JAX layout:
        {"scan": {"b<i>": leaves stacked on the period axis}, "tail":
        {...}, "pos": (B,)}; an attention block's leaves are {"k", "v":
        (B, slots, KVH, hd), "kpos": (B, slots)} (a ring buffer of
        min(seq_len, window) slots when windowed), a recurrent block's its
        state ({"h", "conv"}, {"C", "n", "m"} or {"h", "c", "n", "m"}),
        batch first."""
        cfg, dev = self.cfg, self.device
        n_rep, tail, kinds = layer_plan(cfg)

        def one(kind):
            if kind == "attn":
                return attn_mod.init_attn_cache(cfg, batch, seq_len,
                                                device=dev)
            return getattr(rec_mod, f"init_{kind}_state")(cfg, batch,
                                                          device=dev)

        def stacked(kind):
            return {k: v[None].repeat((n_rep,) + (1,) * v.dim())
                    for k, v in one(kind).items()}

        return {"scan": ({f"b{i}": stacked(kinds[i])
                          for i in range(len(kinds))} if n_rep else {}),
                "tail": {str(t): one(kinds[t]) for t in range(tail)},
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages: int, kv_dtype: str = "bf16"):
        """Paged serving cache: per-layer global KV page arenas (no batch
        axis) + per-lane position counters "pos" (B,) and page tables
        "pt" (B, max_pages) (0 = the allocator's trash page).
        kv_dtype="int8" stores int8 k/v plus f32 `k_scale`/`v_scale`
        planes per arena.  Only unwindowed all-attention models qualify:
        recurrent state and ring buffers have no paged form."""
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: want 'bf16' or 'int8'")
        cfg, dev = self.cfg, self.device
        n_rep, tail, kinds = layer_plan(cfg)
        if any(k != "attn" for k in kinds) or cfg.local_window:
            raise ValueError(f"{cfg.name}: paged KV needs an unwindowed "
                             "all-attention model")

        def arena():
            return attn_mod.init_paged_attn_cache(
                cfg, num_pages, page_size, device=dev,
                quantized=kv_dtype == "int8")

        def stacked():
            return {k: v[None].repeat((n_rep,) + (1,) * v.dim())
                    for k, v in arena().items()}

        return {"scan": ({f"b{i}": stacked() for i in range(len(kinds))}
                         if n_rep else {}),
                "tail": {str(t): arena() for t in range(tail)},
                "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "pt": torch.zeros((batch, max_pages), dtype=torch.int32,
                                  device=dev)}

    def embed_inputs(self, params, tokens=None, embeds=None):
        """Token ids (B, S) -> embeddings, or given embeddings in the
        compute dtype."""
        if embeds is not None:
            return embeds.to(COMPUTE_DTYPE)
        return embed(tokens, params["embed"])

    # -- entry points ------------------------------------------------------

    def _positions(self, x, positions):
        """(positions, contiguous): the plain arange when none are given,
        which marks the long-prefill route through flash_attention."""
        if positions is not None:
            return positions, False
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device).expand(b, s), True

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy (0-d f32) of a batch dict, plus
        0.01 x the MoE layers' load-balance loss in a MoE model, as the
        reference's: "tokens" (B, S) or "embeds" (B, S, D), "labels" (B,
        S) (< 0 = ignored), optional "positions" and "segment_ids".
        Without positions, S > 1024 runs flash_attention, which is
        forward-only (the reference has no VJP for its Pallas kernel
        either): call this under torch.no_grad() there.  So the train CLI
        (launch/train.py) refuses --seq above 1,024 on the card unless
        --pack gives explicit positions (the dense or chunked route)."""
        nll, cnt, aux = self.loss_terms(params, batch)
        ce = nll / torch.clamp(cnt, min=1)
        return ce if aux is None else ce + 0.01 * aux

    def loss_terms(self, params, batch):
        """`loss`'s terms: (the f32 sum of the valid labels' negative
        log-likelihoods, their int32 count, the MoE layers' load-balance
        loss or None).  The sharded train step sums the first two over
        its data replicas (launch/train.py)."""
        x = self.embed_inputs(params, batch.get("tokens"),
                              batch.get("embeds"))
        positions, contiguous = self._positions(x, batch.get("positions"))
        h, aux = self.backbone(params, x, positions,
                               batch.get("segment_ids"),
                               pos_contiguous=contiguous)
        nll, cnt = cross_entropy_sums(h, batch["labels"], params["embed"])
        return nll, cnt, aux

    def forward_logits(self, params, tokens=None, embeds=None,
                       positions=None) -> torch.Tensor:
        """(B, S, V) f32 logits of every position; without positions,
        S > 1024 runs flash_attention once per layer."""
        x = self.embed_inputs(params, tokens, embeds)
        positions, contiguous = self._positions(x, positions)
        h, _ = self.backbone(params, x, positions, pos_contiguous=contiguous)
        return lm_head(h, params["embed"])

    def prefill(self, params, caches, tokens=None, embeds=None,
                positions=None, last_idx=None):
        """Fill `caches` (in place) from a left-aligned prompt batch: token
        ids (B, S), or embeddings (B, S, D) for the stub frontends
        (musicgen-medium's audio frames, internvl2-1b's patches).

        last_idx: (B,) index of each request's final prompt token;
        defaults to S-1.  Without positions the prompt sits at 0..S-1 and,
        past 1024 tokens, attends through flash_attention.  Returns
        (logits at last_idx (B, V) f32, caches).
        """
        x = self.embed_inputs(params, tokens, embeds)
        b, s = x.shape[:2]
        positions, contiguous = self._positions(x, positions)
        if last_idx is None:
            last_idx = torch.full((b,), s - 1, dtype=torch.long,
                                  device=x.device)
        last_idx = last_idx.long()
        h, _ = self.backbone(params, x, positions, caches=caches,
                             pos_contiguous=contiguous)
        bidx = torch.arange(b, device=x.device)
        caches["pos"] = positions[bidx, last_idx].to(torch.int32) + 1
        h_last = h[bidx, last_idx][:, None]
        return lm_head(h_last, params["embed"])[:, 0], caches

    def decode_step(self, params, caches, token: torch.Tensor,
                    active: Optional[torch.Tensor] = None):
        """token (B,) ids, or (B, D) embeddings for the stub frontends ->
        (logits (B, V) f32, caches) on a paged or a dense slot cache.

        Inactive lanes are computed (the batch shape is static) but leave
        their cache rows and position counters untouched: on a paged cache
        they write only to the trash page, on a dense one they write their
        slot's old contents back."""
        x = (embed(token[:, None], params["embed"]) if token.dim() == 1
             else token[:, None, :].to(COMPUTE_DTYPE))
        positions = caches["pos"][:, None]
        h, _ = self.backbone(params, x, positions, caches=caches,
                             page_table=caches.get("pt"), active=active)
        pos = caches["pos"]
        caches["pos"] = (pos + 1 if active is None
                         else torch.where(active, pos + 1, pos))
        return lm_head(h[:, -1:], params["embed"])[:, 0], caches

    def decode_steps(self, params, caches, token: torch.Tensor,
                     active: torch.Tensor, n: int,
                     eos_id: Optional[torch.Tensor] = None,
                     budget: Optional[torch.Tensor] = None,
                     pad_token: int = 0,
                     forced: Optional[torch.Tensor] = None,
                     forced_len: Optional[torch.Tensor] = None,
                     forced_ptr: Optional[torch.Tensor] = None):
        """n greedy decode steps without a host sync: the whole loop
        (decode_step -> argmax -> feed back) stays on the device and the
        caller fetches one (n, B) int32 token block.

        A lane drops out after it emits EOS or exhausts its budget; from
        then on it emits -1 and leaves its cache rows and counter alone.
        forced/forced_len/forced_ptr (all or none): per-lane queues of
        forced input tokens — a prefix-cache hit's prompt-suffix ingest.
        While ``forced_ptr[b] < forced_len[b]`` the lane feeds the queued
        token, emits -1 and keeps its budget; the step that consumes its
        last pending input emits the first generated token.

        Returns (tokens (n, B), next token (B,), active (B,), remaining
        (B,), caches); with a forced queue, forced_ptr (B,) comes before
        caches.
        """
        b = token.shape[0]
        dev = token.device
        if eos_id is None:
            eos_id = torch.full((b,), -1, dtype=torch.int32, device=dev)
        if budget is None:
            budget = torch.full((b,), 2 ** 30, dtype=torch.int32, device=dev)
        cur, act, rem = token.to(torch.int32), active, budget
        toks = []
        if forced is None:
            for _ in range(n):
                logits, caches = self.decode_step(params, caches, cur,
                                                  active=act)
                emit, cur, act, rem = greedy_token_update(
                    logits, cur, act, rem, eos_id, pad_token)
                toks.append(emit)
            return torch.stack(toks), cur, act, rem, caches

        fptr = forced_ptr.to(torch.int32)
        for _ in range(n):
            logits, caches = self.decode_step(params, caches, cur,
                                              active=act)
            emit, cur, act, rem, fptr = forced_token_update(
                logits, cur, act, rem, eos_id, pad_token, forced,
                forced_len, fptr)
            toks.append(emit)
        return torch.stack(toks), cur, act, rem, fptr, caches

    def draft_steps(self, params, caches, token: torch.Tensor,
                    active: torch.Tensor, n_draft: int,
                    forced: torch.Tensor, forced_len: torch.Tensor,
                    forced_ptr: torch.Tensor, pad_token: int = 0):
        """Build one speculative input block on the draft model.

        Runs ``n_draft + 1`` draft decode steps: step j consumes input
        ``ins[:, j]`` — the forced-queue token while the queue still covers
        the position (so a prefix-hit lane's draft cache ingests the same
        suffix as the target's), else the previous step's draft argmax.
        The last step only ingests the last input's KV, so the draft cache
        covers every position the target verifies; its output is dropped.
        Returns (ins (B, n_draft+1), caches), the draft position counters
        advanced by n_draft+1 (the caller rewinds them to the accepted
        length).
        """
        b = token.shape[0]
        lane = torch.arange(b, device=token.device)
        fcap = forced.shape[1]
        pad = torch.full_like(token, pad_token, dtype=torch.int32)
        cur = torch.where(active, token.to(torch.int32), pad)
        ins = [cur]
        for j in range(n_draft + 1):
            logits, caches = self.decode_step(params, caches, cur,
                                              active=active)
            if j == n_draft:
                break
            prop = torch.argmax(logits, dim=-1).to(torch.int32)
            idx = forced_ptr + j
            nxt = torch.where(
                idx < forced_len,
                forced[lane, torch.clamp(idx, max=fcap - 1).long()], prop)
            cur = torch.where(active, nxt.to(torch.int32), pad)
            ins.append(cur)
        return torch.stack(ins, dim=1), caches

    def verify_block(self, params, caches, tokens: torch.Tensor,
                     active: Optional[torch.Tensor] = None):
        """The target's pass over T contiguous speculative inputs.

        tokens: (B, T), column j at position ``caches['pos'][b] + j``.  One
        backbone call with S = T takes the paged verify branch
        (models/attention.py), and every product (projections, MLP, head)
        runs once over the B*T rows, each row summed as a decode step's
        (`layers.product`; the MoE router one query column at a time,
        models/moe.py): every row's logits are what T chained
        single-step `decode_step` calls with the same inputs give, bit for
        bit, which is what makes greedy verification lossless.  A MoE
        layer routes each row's T tokens as one group with the capacity of
        S = T (the reference's verify pass): where a pair is dropped there,
        the row parts from its chained steps, which route one token a call
        and never drop; speculation on a MoE model is therefore not
        lossless, in the reference as here (models/moe.py).  Returns
        (logits (B, T, V) f32, caches), the position counters untouched:
        the caller advances them by the accepted length only.
        """
        if "pt" not in caches:
            raise ValueError("verify_block needs a paged cache")
        t = tokens.shape[1]
        x = self.embed_inputs(params, tokens=tokens)
        positions = (caches["pos"][:, None]
                     + torch.arange(t, dtype=torch.int32,
                                    device=x.device)[None, :])
        h, _ = self.backbone(params, x, positions, caches=caches,
                             page_table=caches["pt"], active=active)
        return lm_head(h, params["embed"]), caches

    def spec_decode_step(self, params, caches, token: torch.Tensor,
                         active: torch.Tensor, n_draft: int,
                         draft_model: "Model", draft_params, draft_caches,
                         eos_id: Optional[torch.Tensor] = None,
                         budget: Optional[torch.Tensor] = None,
                         pad_token: int = 0,
                         forced: Optional[torch.Tensor] = None,
                         forced_len: Optional[torch.Tensor] = None,
                         forced_ptr: Optional[torch.Tensor] = None):
        """One speculative block: the draft's n_draft+1 steps, one target
        verify pass and the acceptance state machine, emitting up to
        ``n_draft + 1`` tokens per lane while equal to `decode_steps`.

        A rejection is rolled back by rewinding both caches' position
        counters (in place): rejected rows sit at kpos beyond every later
        query position until the stream overwrites them.  Returns (toks
        (n_draft+1, B), cur, active, remaining, forced_ptr, caches,
        draft_caches, n_consumed).
        """
        b = token.shape[0]
        dev = token.device
        if eos_id is None:
            eos_id = torch.full((b,), -1, dtype=torch.int32, device=dev)
        if budget is None:
            budget = torch.full((b,), 2 ** 30, dtype=torch.int32,
                                device=dev)
        if forced is None:
            forced = torch.zeros((b, 1), dtype=torch.int32, device=dev)
            forced_len = torch.zeros((b,), dtype=torch.int32, device=dev)
            forced_ptr = torch.zeros((b,), dtype=torch.int32, device=dev)
        ins, draft_caches = draft_model.draft_steps(
            draft_params, draft_caches, token, active, n_draft, forced,
            forced_len, forced_ptr, pad_token)
        logits, caches = self.verify_block(params, caches, ins,
                                           active=active)
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks, cur, alive, rem, fptr, v = spec_acceptance(
            ins, tgt, active, budget, eos_id, pad_token, forced, forced_len,
            forced_ptr)
        pos = caches["pos"]
        caches["pos"] = torch.where(active, pos + v, pos)
        dpos = draft_caches["pos"]
        draft_caches["pos"] = torch.where(active, dpos - (n_draft + 1) + v,
                                          dpos)
        return toks, cur, alive, rem, fptr, caches, draft_caches, v

    def insert_prefill_cache(self, big, small, slot: int):
        """Write a batch-1 prefill cache `small` into lane `slot` of the
        dense slot cache `big`, in place, "pos" included.  A shorter
        bucket leaves a gap past its slots, refilled with zeros (k/v) and
        the never-written sentinel (kpos), so the lane's previous
        occupant can never be attended to.  A recurrent state has no slot
        axis: its leaves match but for the batch and are copied whole."""

        def leaf(axis, b, s):
            if isinstance(b, Shards):  # a plan's parts, pairwise
                for bp, sp in zip_parts(b, s):
                    leaf(axis, bp, sp)
                return b
            s = s.to(b.dtype)
            gap = b.dim() > 1 and s.shape[axis + 1] < b.shape[axis + 1]
            if gap:
                fill = KPOS_SENTINEL if b.dtype == torch.int32 else 0
                pad_shape = list(s.shape)
                pad_shape[axis + 1] = b.shape[axis + 1] - s.shape[axis + 1]
                s = torch.cat([s, torch.full(pad_shape, fill, dtype=s.dtype,
                                             device=s.device)], axis + 1)
            b.narrow(axis, slot, 1).copy_(s)
            return b

        cache_map(leaf, big, small)
        return big

    def admit_lane_cache(self, big, slot: int, pt_row, pos0: int,
                         reset_pages, small=None, write_pages=None):
        """Prepare lane `slot` of the paged cache `big` for a new occupant,
        in place.

        reset_pages: (R,) pages whose kpos return to the never-written
        sentinel before use (recycled pages must not expose the previous
        occupant's keys; padded with the trash page 0).  small /
        write_pages: optional batch-1 bucket cache from a dense prefill and
        the (W,) pages that receive it, positions [0, W*page_size) in
        prompt order (quantized per cache row first when the arena is
        int8).  The lane's table row becomes `pt_row` and its
        counter `pos0` (the prompt length; a prefix hit passes hit_len and
        no `small` — its suffix arrives through the forced queue).
        """
        dev = self.device
        if small is not None and cache_is_quantized(big):
            small = quantize_kv_tree(small)
        reset = torch.as_tensor(reset_pages, dtype=torch.long, device=dev)
        wp = (None if write_pages is None else
              torch.as_tensor(write_pages, dtype=torch.long, device=dev))

        def leaf(page_axis, name, b, s):
            if isinstance(b, Shards):  # a plan's parts, pairwise
                for bp, sp in zip_parts(b, s):
                    leaf(page_axis, name, bp, sp)
                return
            reset_, wp_ = reset.to(b.device), (None if wp is None
                                               else wp.to(b.device))
            ps = b.shape[page_axis + 1]
            idx = (slice(None),) * page_axis
            if name == "kpos":
                b[idx + (reset_,)] = KPOS_SENTINEL
            if s is None:
                return
            s = s.squeeze(page_axis).to(b.dtype)  # drop the batch-1 axis
            need, got = wp_.shape[0] * ps, s.shape[page_axis]
            if got < need:
                fill = KPOS_SENTINEL if name == "kpos" else 0
                pad_shape = list(s.shape)
                pad_shape[page_axis] = need - got
                s = torch.cat([s, torch.full(pad_shape, fill, dtype=s.dtype,
                                             device=s.device)], page_axis)
            elif got > need:  # the lane owns fewer pages than the bucket
                s = s.narrow(page_axis, 0, need)
            s = s.reshape(s.shape[:page_axis] + (wp_.shape[0], ps)
                          + s.shape[page_axis + 1:])
            b[idx + (wp_,)] = s

        for key, axis in (("scan", 1), ("tail", 0)):
            for blk, arena in big[key].items():
                sm = None if small is None else small[key][blk]
                for name, t in arena.items():
                    leaf(axis, name, t, None if sm is None else sm[name])
        big["pos"][slot] = int(pos0)
        big["pt"][slot] = torch.as_tensor(pt_row, dtype=torch.int32,
                                          device=dev)
        return big


def make_model(cfg: ModelConfig, remat: bool = True, device="cuda") -> Model:
    return Model(cfg, device=device, remat=remat)
