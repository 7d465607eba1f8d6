"""Recurrent sequence mixers: RG-LRU (Griffin / recurrentgemma) and the
xLSTM cells, mLSTM and sLSTM (port of `repro/models/recurrent.py`).

Prefill runs the parallel forms: a log-step scan for the RG-LRU, a
chunkwise stabilised recurrence for the mLSTM (`MLSTM_CHUNK` steps a
chunk, the max-stabiliser ``m`` carried across chunks); the sLSTM is
sequential by nature.  Decode is a single step on O(1) state.  The
reference has no kernel here: its products are einsums, so these are
plain torch products on both devices (the projections `layers.dense`'s).

Under a tensor-parallel serve plan (serving/executor.py places the
leaves) each block runs per shard in `layers.ffn`'s form: the RG-LRU
shard i its block of the width; the mLSTM its columns of `up_z` and
`up_g`, the sLSTM its columns of `glu_wi`, each gathered before the
cell (or the GLU) runs whole on the controller; the blocks gathered, or
summed, at the block's reduction projection (`layers.project_out`).  An
exact plan's outputs and states are one device's, bit for bit.

Pads: a step whose `valid` is False leaves the state alone (RG-LRU: a = 1,
b = 0; mLSTM: input gate log -1e30, forget gate log 0; sLSTM: the step is
not taken), the recurrent form of the no-padding rule.  The sentinels
(``-1e30``, ``exp(-m_i)``, ``maximum(|den|, .)``) are the reference's, so
a padded row gives 0 and never NaN.

Each block returns (y, new_state), new_state None when called without a
state; `models/transformer.py` writes a new state into the cache in
place.  Parameters keep the reference's layout; `init_params` there
draws them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, project_out
from repro_torch.models.shard_hints import Shards, broadcast_to, hint, part

Params = Dict[str, Any]

MLSTM_CHUNK = 128
_RGLRU_C = 8.0
_NEG = -1e30


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def _where_valid(valid: torch.Tensor, x: torch.Tensor, fill: float):
    return torch.where(valid[..., None], x, torch.full_like(x, fill))


# ===========================================================================
# RG-LRU (Griffin) recurrent block
# ===========================================================================


def _causal_conv(x: torch.Tensor, conv: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (B, S, W), conv (cw, W) f32, state (B,
    cw-1, W) -> (out (B, S, W) in x's dtype, new state)."""
    cw = conv.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    ext = torch.cat([state.to(x.dtype), x], 1)
    s = x.shape[1]
    out = sum(ext[:, i:i + s] * conv[cw - 1 - i] for i in range(cw))
    new_state = ext[:, -(cw - 1):] if cw > 1 else state
    return out.to(x.dtype), new_state


def _rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_(t-1) + b_t over axis 1 from h_(-1) = 0, as a log-step
    (Hillis-Steele) scan of the combine (a1, b1), (a2, b2) -> (a1 a2,
    a2 b1 + b2).  `jax.lax.associative_scan` combines in another tree
    order: the two agree within f32 rounding, not bit for bit."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], 1)
        shift *= 2
    return b


def rglru_block(x: torch.Tensor, p: Params, cfg,
                state: Optional[Params] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Griffin recurrent block.  x (B, S, D); state {"h": (B, W) f32,
    "conv": (B, cw-1, W)}; valid (B, S) bool.

    Tensor parallel (a serve plan: `w_gate_in`, `w_x_in`, `conv`, `lam`
    and the state by width, `w_rgate` and `w_igate` by column): shard i
    runs its block of the width end to end, the recurrence being
    elementwise in W; only the gates' products need the whole conv
    output, which is gathered and broadcast (a row block of `w_rgate`
    would be a partial sum).  `y`'s blocks meet at `w_out`
    (`layers.project_out`)."""
    wg = p["w_gate_in"]
    xs = broadcast_to(x, wg) if isinstance(wg, Shards) else [x]
    gates, convs, new_convs = [], [], []
    for i, xi in enumerate(xs):
        gates.append(_gelu(dense(xi, part(wg, i))))
        xi_raw = dense(xi, part(p["w_x_in"], i))
        conv = part(p["conv"], i)
        conv_state = None if state is None else part(state["conv"], i)
        xc, new_conv = _causal_conv(xi_raw, conv, conv_state)
        if valid is not None and state is not None and x.shape[1] > 1:
            # a prefill with trailing pads: the decode conv state holds
            # the last valid inputs, not the pad columns
            cw1 = conv.shape[0] - 1
            lengths = valid.to(xi.device, torch.int64).sum(1)
            at = torch.clamp(lengths[:, None] - cw1 + torch.arange(
                cw1, device=xi.device)[None], min=0)
            new_conv = torch.gather(
                xi_raw, 1, at[..., None].expand(-1, -1, xi_raw.shape[2]))
            new_conv = new_conv.to(conv_state.dtype)
        convs.append(xc)
        new_convs.append(new_conv)

    xc = hint(convs, "gather")  # the gates' products take the whole width
    ys, hs = [], []
    for i, xci in enumerate(broadcast_to(xc, wg) if len(xs) > 1 else [xc]):
        xf = convs[i].float()
        # the gate products stay bf16; the sigmoids run in f32
        r = torch.sigmoid(dense(xci, part(p["w_rgate"], i)).float())
        g = torch.sigmoid(dense(xci, part(p["w_igate"], i)).float())
        log_a = _RGLRU_C * r * F.logsigmoid(part(p["lam"], i))  # <= 0
        v = None if valid is None else valid.to(xci.device)
        if v is not None:
            log_a = _where_valid(v, log_a, 0.0)
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (g * xf)
        if v is not None:
            b = _where_valid(v, b, 0.0)
        if state is None:
            h = _rglru_scan(a, b)
        elif x.shape[1] == 1:  # decode
            h = a * part(state["h"], i)[:, None, :] + b
        else:  # a prefill from a state: h0 folds into the first step
            b = torch.cat([b[:, :1] + a[:, :1] * part(state["h"], i)[:, None],
                           b[:, 1:]], 1)
            h = _rglru_scan(a, b)
        hs.append(h[:, -1])
        ys.append((gates[i].float() * h).to(x.dtype))
    new_state = None if state is None else {
        "h": _like(hs, state["h"]), "conv": _like(new_convs, state["conv"])}
    return project_out(ys, p["w_out"]), new_state


def _like(parts, leaf):
    """Per-shard results held as `leaf` is: `Shards` like it, or the one
    tensor."""
    if isinstance(leaf, Shards):
        return Shards(parts, leaf.axis, leaf.dim)
    return parts[0]


def init_rglru_state(cfg, batch: int, device=None) -> Params:
    w = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=torch.bfloat16, device=device),
    }


# ===========================================================================
# mLSTM (xLSTM matrix-memory cell), chunkwise parallel
# ===========================================================================


def _mlstm_dims(cfg, d: int):
    inner = int(cfg.proj_factor * d)
    nh = cfg.n_heads
    ih = inner // nh
    return inner, nh, ih, ih // 2


def _mlstm_chunk(q, k, v, li, lf, carry):
    """One chunk of the stabilised mLSTM.  q, k (B, T, nh, dk); v (B, T,
    nh, ih); li / lf (B, T, nh) logs; carry = (C (B, nh, dk, ih), n (B,
    nh, dk), m (B, nh))."""
    C, n, m = carry
    t = q.shape[1]
    b = torch.cumsum(lf, 1)  # inclusive cumsum of logsigmoid(f)
    # log intra-chunk decay D_ij = b_i - b_j + li_j for j <= i
    dmat = b[:, :, None] - b[:, None, :] + li[:, None, :]  # (B, T, T, nh)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
    dmat = torch.where(causal[None, :, :, None], dmat,
                       torch.full_like(dmat, float("-inf")))
    m_intra = dmat.amax(2)  # (B, T, nh)
    m_inter = b + m[:, None, :]
    m_i = torch.maximum(m_inter, m_intra)  # the running stabiliser

    qf, kf, vf = q.float(), k.float(), v.float()
    dint = torch.exp(dmat - m_i[:, :, None])
    s = torch.einsum("binK,bjnK->bijn", qf, kf)
    sw = s * dint
    num = torch.einsum("bijn,bjnh->binh", sw, vf)
    den = sw.sum(2)  # (B, T, nh)

    winter = torch.exp(m_inter - m_i)
    num = num + winter[..., None] * torch.einsum("binK,bnKh->binh", qf, C)
    den = den + winter * torch.einsum("binK,bnK->bin", qf, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]

    # the carry
    bt = b[:, -1]  # (B, nh): the chunk's total log decay
    lj = bt[:, None, :] - b + li  # log decay from step j to the chunk's end
    m_new = torch.maximum(m + bt, lj.amax(1))
    wj = torch.exp(lj - m_new[:, None, :])
    decay = torch.exp(m + bt - m_new)
    C_new = (decay[:, :, None, None] * C
             + torch.einsum("bjn,bjnK,bjnh->bnKh", wj, kf, vf))
    n_new = decay[:, :, None] * n + torch.einsum("bjn,bjnK->bnK", wj, kf)
    return h, (C_new, n_new, m_new)


def mlstm_block(x: torch.Tensor, p: Params, cfg,
                state: Optional[Params] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """mLSTM block with its pre-up projection.  x (B, S, D); state {"C",
    "n", "m"}; valid (B, S) bool.

    Tensor parallel (a serve plan): `up_z` and `up_g` run per shard on
    their column blocks, gathered in column order; the cell, its q/k/v
    weights and its state stay whole on the controller, as the sLSTM's
    do (a block of heads run alone parts from the nh-head call on an
    H100: chip_smoke.py's mlstm probe); h * g meets `down`
    (`layers.project_out`, by its rows where `down` is row `Shards`)."""
    bsz, s, d = x.shape
    inner, nh, ih, dk = _mlstm_dims(cfg, d)

    z = _columns(x, p["up_z"]).reshape(bsz, s, nh, ih)
    g = F.silu(_columns(x, p["up_g"]))
    q = torch.einsum("bsnh,nhk->bsnk", z, p["wq"]) / math.sqrt(dk)
    k = torch.einsum("bsnh,nhk->bsnk", z, p["wk"]) / math.sqrt(dk)
    v = torch.einsum("bsnh,nhj->bsnj", z, p["wv"])
    gates = dense(x, p["w_if"]).float()
    li = gates[..., :nh]  # log input gate (i = exp(li))
    lf = F.logsigmoid(gates[..., nh:])  # log forget gate
    if valid is not None:  # pads: f = 1, i = 0 -> the state is untouched
        li = _where_valid(valid, li, _NEG)
        lf = _where_valid(valid, lf, 0.0)

    if state is not None:
        carry = (state["C"], state["n"], state["m"])
    else:
        z0 = init_mlstm_state(cfg, bsz, device=x.device)
        carry = (z0["C"], z0["n"], z0["m"])
    if s > 1:
        chunk = min(MLSTM_CHUNK, s)
        pad = (-s) % chunk
        if pad:
            q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
            li = F.pad(li, (0, 0, 0, pad), value=_NEG)
            lf = F.pad(lf, (0, 0, 0, pad))
        hs = []
        for c0 in range(0, q.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            h, carry = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                                    lf[:, sl], carry)
            hs.append(h)
        h = torch.cat(hs, 1)[:, :s]
    else:
        h, carry = _mlstm_chunk(q, k, v, li, lf, carry)
    new_state = (None if state is None else
                 {"C": carry[0], "n": carry[1], "m": carry[2]})

    y = (g * h.reshape(bsz, s, inner).float()).to(x.dtype)
    return project_out(_row_blocks(y, p["down"]), p["down"]), new_state


def _columns(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w, where w may be column `Shards`: each shard's block of the
    product, gathered in column order on the controller (one device's
    bits: `ops.gemm`'s column blocks equal the whole product's)."""
    xs = broadcast_to(x, w) if isinstance(w, Shards) else [x]
    return hint([dense(xi, part(w, i)) for i, xi in enumerate(xs)], "gather")


def _row_blocks(v: torch.Tensor, wo) -> list:
    """`v`, whole on the controller, as `layers.project_out`'s blocks: its
    column blocks on the shards' devices where `wo` is row `Shards` (the
    psum form), else [v]."""
    if not isinstance(wo, Shards):
        return [v]
    rows = wo[0].shape[0]
    return [v[..., i * rows:(i + 1) * rows].to(w.device)
            for i, w in enumerate(wo)]


def init_mlstm_state(cfg, batch: int, device=None) -> Params:
    _, nh, ih, dk = _mlstm_dims(cfg, cfg.d_model)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, nh, dk, ih), dtype=f32, device=device),
        "n": torch.zeros((batch, nh, dk), dtype=f32, device=device),
        "m": torch.full((batch, nh), _NEG, dtype=f32, device=device),
    }


# ===========================================================================
# sLSTM (xLSTM scalar-memory cell): sequential by nature
# ===========================================================================


def _slstm_step(p, cfg, carry, x_t):
    """One step; x_t (B, 4d), the input's precomputed contribution."""
    h, c, n, m = carry  # each (B, nh, dh)
    bsz = x_t.shape[0]
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    rec = torch.einsum("bnh,gnhk->bgnk", h, p["r"])  # (B, 4, nh, dh)
    raw = x_t.reshape(bsz, 4, nh, dh).float() + rec
    il, fl, zl, ol = raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]
    lf = F.logsigmoid(fl)
    m_new = torch.maximum(lf + m, il)
    i = torch.exp(il - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(zl)
    n_new = f * n + i
    h_new = torch.sigmoid(ol) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_block(x: torch.Tensor, p: Params, cfg,
                state: Optional[Params] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """sLSTM block with its post-up GLU.  x (B, S, D); state {"h", "c",
    "n", "m"}; valid (B, S) bool.

    Tensor parallel (a serve plan): the cell and its state stay whole on
    the controller; `glu_wi`'s column blocks run per shard and `u` is
    gathered in column order before its halves are taken (a column block
    holds one half's columns, never a pair), and the GLU's output meets
    `glu_wo` (`layers.project_out`, by its rows where `glu_wo` is row
    `Shards`)."""
    bsz, s, d = x.shape
    xin = dense(x, p["w_in"])
    if state is None:
        z0 = init_slstm_state(cfg, bsz, device=x.device)
        carry = (z0["h"], z0["c"], z0["n"], z0["m"])
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    if valid is None:
        valid = torch.ones((bsz, s), dtype=torch.bool, device=x.device)
    hs = []
    for t in range(s):
        new = _slstm_step(p, cfg, carry, xin[:, t])
        keep = valid[:, t, None, None]
        carry = tuple(torch.where(keep, a, b) for a, b in zip(new, carry))
        hs.append(carry[0])
    y = torch.stack(hs, 1).reshape(bsz, s, d).to(x.dtype)
    new_state = (None if state is None else
                 dict(zip(("h", "c", "n", "m"), carry)))

    u = _columns(y, p["glu_wi"])
    a, b = u.chunk(2, dim=-1)
    return project_out(_row_blocks(_gelu(a) * b, p["glu_wo"]),
                       p["glu_wo"]), new_state


def init_slstm_state(cfg, batch: int, device=None) -> Params:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    shape = (batch, nh, dh)
    f32 = torch.float32
    return {"h": torch.zeros(shape, dtype=f32, device=device),
            "c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, _NEG, dtype=f32, device=device)}
