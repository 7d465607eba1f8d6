"""Attention: GQA, RoPE, dense and KV-chunked prefill, paged decode (port
of `repro/models/attention.py`).

Prefill attends densely up to `DENSE_ATTN_MAX_KV` keys.  Above that, a
prompt at contiguous positions 0..S-1 without segment ids (the
`forward_logits` / `loss` entry points, and `prefill` called without
positions) goes through the `flash_attention` kernel, once per layer;
explicit positions (the serving engine's padded buckets) or packed
segment ids take a KV-chunked online softmax.  Decode attends one query
row per lane, once per layer per step, through one of three kernels
(kernels/ops.py): `paged_flash_decode` over a bf16 page arena,
`paged_flash_decode_q` over an int8 one, `flash_decode` over dense slot
rows.

The JAX code builds new cache arrays with ``.at[].set`` and relies on
buffer donation; this port updates the cache tensors in place
(``index_put_`` and slice assignment) and returns the same dict.

A paged cache with T > 1 queries per lane is speculative decoding's
verify pass: the T queries fold into B*T lanes of one paged decode
launch, and every projection runs once over the B*T rows (the K-ordered
products of `layers.product` give each row its decode step's bits).

Sliding windows (`cfg.local_window`, recurrentgemma-2b) keep a ring
buffer of ``min(seq_len, window)`` slots per lane: a prefill writes its
last ``take`` rows at ``arange(s - take, s) % slots``, a decode step at
``qpos % slots``, and flash_decode masks ``qpos - kpos < window``.  A
windowed prompt attends densely up to `DENSE_ATTN_MAX_KV` tokens, then
through `_windowed_attention` when S > 2 * window, else the chunked
route; it never reaches flash_attention.  Paged caches have no windows.

A prefill bucket wider than the window writes only the bucket's last
`window` rows: for a short prompt with trailing pads, real rows still
inside the window are dropped.  That is the reference's rule, and the
port keeps it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import kv_quantize
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_rope, dense,
                                      project_out)
from repro_torch.models.shard_hints import (Shards, broadcast_to,
                                            fsdp_int8_gather, part)

Params = Dict[str, Any]

DENSE_ATTN_MAX_KV = 1024  # above this, use the KV-chunked online softmax
KV_CHUNK = 1024
NEG_INF = -1e30
KPOS_SENTINEL = 2 ** 30  # never-written cache slot


def _split_heads(x, n):  # (B,S,n*hd) -> (B,S,n,hd)
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _mask(sq: int, sk: int, q_pos, k_pos, causal: bool, window: int,
          q_seg=None, k_seg=None) -> torch.Tensor:
    """(B, sq, sk) bool mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], sq, sk), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window:
        m = m & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if q_seg is not None:
        m = m & (q_seg[:, :, None] == k_seg[:, None, :])
    return m


def _gq_scores(q, k) -> torch.Tensor:
    """Grouped scores without expanding KV: q (B,Sq,H,hd), k (B,Sk,KVH,hd)
    -> (B,H,Sq,Sk) in the working dtype."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqngd,bknd->bngqk", q5, k)
    return s.reshape(b, h, sq, k.shape[1])


def _gq_pv(p, v) -> torch.Tensor:
    """p (B,H,Sq,Sk) x v (B,Sk,KVH,hd) -> (B,Sq,H,hd), grouped."""
    b, h, sq, sk = p.shape
    kvh, hd = v.shape[2], v.shape[3]
    p5 = p.reshape(b, kvh, h // kvh, sq, sk)
    out = torch.einsum("bngqk,bknd->bqngd", p5, v)
    return out.reshape(b, sq, h, hd)


def _dense_attention(q, k, v, mask) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KVH,hd), mask (B,Sq,Sk)."""
    s = _gq_scores(q, k).float()
    m = mask[:, None]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return _gq_pv(p.to(q.dtype), v)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, window,
                       q_seg=None, k_seg=None) -> torch.Tensor:
    """Online softmax over KV chunks; O(Sq * KV_CHUNK) live scores."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    chunk = min(KV_CHUNK, sk)
    m_run = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        # the last chunk may be short: the JAX scan pads it with sentinel
        # keys, which the mask drops, so a short chunk is the same sum
        kx, vx = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        px = k_pos[:, c0:c0 + chunk]
        sx = None if k_seg is None else k_seg[:, c0:c0 + chunk]
        s = _gq_scores(q, kx).float()
        msk = _mask(sq, kx.shape[1], q_pos, px, causal, window, q_seg, sx)
        s = torch.where(msk[:, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _gq_pv(
            p.to(q.dtype), vx).transpose(1, 2).float()
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,hd)


def _windowed_attention(q, k, v, q_pos, k_pos, window,
                        q_seg=None, k_seg=None) -> torch.Tensor:
    """Causal sliding-window attention in O(S * 2W): query blocks of W
    rows attend to their own KV block and the one before (block -1 is
    zeros at the never-written position).  q (B,S,H,hd), k/v
    (B,S,KVH,hd); q_pos/k_pos (B,S)."""
    b, s, h, hd = q.shape
    blk = window
    pad = (-s) % blk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        q_pos = F.pad(q_pos, (0, pad), value=KPOS_SENTINEL)
        k_pos = F.pad(k_pos, (0, pad), value=KPOS_SENTINEL)
        if q_seg is not None:
            q_seg = F.pad(q_seg, (0, pad), value=-2)
            k_seg = F.pad(k_seg, (0, pad), value=-3)
    nb = q.shape[1] // blk

    def blocks(a):  # (B, nb, blk, ...)
        return a.reshape(b, nb, blk, *a.shape[2:])

    def with_prev(a, fill):  # (B, nb, 2*blk, ...): block i-1, then i
        prev = torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], 1)
        return torch.cat([prev, a], 2)

    def fold(a):  # (B, nb, ...) -> (B*nb, ...)
        return a.reshape(b * nb, *a.shape[2:])

    qb, qpb = blocks(q), blocks(q_pos)
    k2, v2 = with_prev(blocks(k), 0), with_prev(blocks(v), 0)
    kp2 = with_prev(blocks(k_pos), KPOS_SENTINEL)
    qs2 = ks2 = None
    if q_seg is not None:
        qs2, ks2 = fold(blocks(q_seg)), fold(with_prev(blocks(k_seg), -3))
    msk = _mask(blk, 2 * blk, fold(qpb), fold(kp2), True, window, qs2, ks2)
    out = _dense_attention(fold(qb), fold(k2), fold(v2), msk)
    return out.reshape(b, nb * blk, h, hd)[:, :s]


def attention(x: torch.Tensor, p: Params, cfg, positions: torch.Tensor,
              segment_ids: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              pos_contiguous: bool = False,
              page_table: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention block.

    Prefill: cache=None -> self-attention over x; cache={'k','v','kpos'}
    (a dense bucket cache) -> also write x's KV and positions into it.
    Paged decode: page_table (B, MAXP) marks `cache` as a paged arena
    (`k`/`v`: (P, ps, KVH, hd), `kpos`: (P, ps)); lane b's position q
    lives at arena page page_table[b, q // ps], offset q % ps.  The new
    row is scattered through the table in place (quantized first when the
    arena holds `k_scale`/`v_scale`); inactive lanes write to the trash
    page 0 with sentinel kpos, so a parked lane never touches a live page.
    Dense slot decode: cache={'k','v','kpos'} with rows (B, slots, ...)
    and no page table; the new row goes to slot q % slots of each active
    lane when windowed (a ring buffer), else min(q, slots - 1).  Returns
    (output (B, S, d_model), the same cache dict).

    Tensor parallel (a serve plan: `wq`, `wk`, `wv` are column `Shards`,
    models/shard_hints.py): x is broadcast to the shards, shard i
    projects, rotates and attends its n_heads/n query heads and
    n_kv_heads/n kv heads over its own kv-head slice of the cache
    (whatever the branch), and the head outputs meet at `wo`: gathered in
    shard order before a replicated `wo` (exact), or each shard's partial
    product through its row block of `wo`, summed in shard order (psum).
    """
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the FSDP gathers at int8 width under hints(int8_gather=True)
    wq, wk, wv = (fsdp_int8_gather(p[w], tp_dim=1) for w in ("wq", "wk",
                                                              "wv"))
    n = len(wq) if isinstance(wq, Shards) else 1
    xs = broadcast_to(x, wq) if n > 1 else [x]
    qs, q, k, v = [], [], [], []
    for i, xi in enumerate(xs):
        pos_i = positions.to(xi.device)
        qi = _split_heads(dense(xi, part(wq, i)), nh // n)
        ki = _split_heads(dense(xi, part(wk, i)), nkv // n)
        vi = _split_heads(dense(xi, part(wv, i)), nkv // n)
        qi = apply_rope(qi, pos_i, cfg.rope_theta)
        ki = apply_rope(ki, pos_i, cfg.rope_theta)
        q.append(qi)
        k.append(ki)
        v.append(vi)
        # bf16, as the reference scales it (the flash_attention route
        # alone takes q unscaled: its kernel scales the f32 score)
        qs.append(qi * (1.0 / math.sqrt(hd)))

    if cache is not None and page_table is not None:
        if cfg.local_window:
            raise ValueError("paged KV does not support sliding windows")
        outs = _paged_decode(qs, k, v, cache, page_table, positions, active)
    else:
        outs = []
        for i, xi in enumerate(xs):
            dev = xi.device
            outs.append(_attend(
                qs[i], q[i], k[i], v[i], cfg,
                None if cache is None else {n_: part(t, i) for n_, t
                                            in cache.items()},
                positions.to(dev),
                None if segment_ids is None else segment_ids.to(dev),
                pos_contiguous, None if active is None else active.to(dev)))
    outs = [o.reshape(x.shape[0], x.shape[1], -1) for o in outs]
    return project_out(outs, fsdp_int8_gather(p["wo"], tp_dim=0)), cache


def _attend(qs, q, k, v, cfg, cache, positions, segment_ids,
            pos_contiguous, active) -> torch.Tensor:
    """Attention of one shard's heads outside the paged path: prefill (a
    dense bucket cache written when given) or dense slot decode.  Returns
    (B, S, heads, hd)."""
    from repro_torch.kernels import ops as kops

    window = cfg.local_window
    s = q.shape[1]
    if cache is None or s > 1:
        if s <= DENSE_ATTN_MAX_KV:
            msk = _mask(s, s, positions, positions, cfg.causal, window,
                        segment_ids, segment_ids)
            out = _dense_attention(qs, k, v, msk)
        elif pos_contiguous and segment_ids is None and not window:
            out = kops.flash_attention(q, k, v, causal=cfg.causal)
        elif window and cfg.causal and s > 2 * window:
            out = _windowed_attention(qs, k, v, positions, positions,
                                      window, segment_ids, segment_ids)
        else:
            out = _chunked_attention(qs, k, v, positions, positions,
                                     cfg.causal, window, segment_ids,
                                     segment_ids)
        if cache is not None:
            # prefill: write the last `slots` rows + absolute positions,
            # at their ring slots when windowed
            slots = cache["k"].shape[1]
            take = min(s, slots)
            idx = (torch.arange(s - take, s, device=q.device) % slots
                   if window else slice(0, take))
            cache["k"][:, idx] = k[:, -take:].to(cache["k"].dtype)
            cache["v"][:, idx] = v[:, -take:].to(cache["v"].dtype)
            cache["kpos"][:, idx] = positions[:, -take:].to(torch.int32)
        return out
    # dense slot decode: lane b's row for position q is slot q % slots
    # of a ring buffer (windowed), else min(q, slots - 1).  The
    # reference writes every lane and where-masks the cache tree
    # afterwards; here an inactive lane writes its slot's old
    # contents back, so its rows and kpos are untouched in place.
    b = q.shape[0]
    ck, cv, ckpos = cache["k"], cache["v"], cache["kpos"]
    slots = ck.shape[1]
    cpos = positions[:, 0].to(torch.int32)
    slot = (cpos % slots if window
            else torch.clamp(cpos, max=slots - 1)).long()
    lane = torch.arange(b, device=q.device)
    act = (torch.ones((b,), dtype=torch.bool, device=q.device)
           if active is None else active.bool())
    a3 = act[:, None, None]
    ck[lane, slot] = torch.where(a3, k[:, 0].to(ck.dtype), ck[lane, slot])
    cv[lane, slot] = torch.where(a3, v[:, 0].to(cv.dtype), cv[lane, slot])
    ckpos[lane, slot] = torch.where(act, cpos, ckpos[lane, slot])
    return kops.flash_decode(qs[:, 0].contiguous(), ck, cv, ckpos, cpos,
                             active=act, window=window)[:, None]


def _paged_decode(qs, k, v, cache, page_table, positions, active):
    """Paged decode: T contiguous queries per lane against the arena (T = 1
    for a decode step, T = k+1 for speculative decoding's verify pass).

    qs, k, v: lists of the shards' (B, T, heads, hd) tensors (one for an
    unsharded arena); under a plan the arena's `k`/`v` (and scale planes)
    are kv-head `Shards` and its `kpos` one tensor per device.  All B*T
    new rows are scattered through the page table in one write per arena
    part, exactly as T single-query decode writes would place them, then
    the T queries are folded into B*T lanes of one decode-kernel launch
    per shard, each attending at its own position with its lane's table.
    Rows ahead of a query carry kpos above its qpos, so the causal mask
    hides them, and each output row is what a single-step decode at that
    position gives.  Rejected rows need no cleanup: the caller rewinds
    the position counter, and they stay beyond every later query until
    overwritten.  Returns the shards' (B, T, heads, hd) outputs.
    """
    from repro_torch.kernels import ops as kops

    b, t = positions.shape
    ps = part(cache["k"], 0).shape[1]
    dev = positions.device
    cpos = positions.to(torch.int32)  # (B, T)
    act = (torch.ones((b,), dtype=torch.bool, device=dev)
           if active is None else active.bool())
    # clamped like a JAX gather: the block's last rows near cache_len, and
    # inactive lanes' stale counters, may run off the table's columns
    col = torch.clamp(cpos // ps, max=page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, col)
    a2 = act[:, None]
    zero = torch.zeros_like(page)
    wr_page = torch.where(a2, page, zero).reshape(-1).long()
    wr_off = torch.where(a2, cpos % ps, zero).reshape(-1).long()
    # inactive lanes' rows all land on the trash page 0, offset 0; the
    # order of duplicate writes is not fixed on the card, which is harmless
    # only because each of them writes the same sentinel kpos first
    kpos_val = torch.where(a2, cpos, torch.full_like(cpos, KPOS_SENTINEL))
    kpos = cache["kpos"]
    for kp in (kpos.distinct() if isinstance(kpos, Shards) else [kpos]):
        d = kp.device
        kp.index_put_((wr_page.to(d), wr_off.to(d)),
                      kpos_val.reshape(-1).to(d))
    quant = "k_scale" in cache
    qf = []
    for i in range(len(qs)):
        d = qs[i].device
        kf = k[i].reshape(b * t, *k[i].shape[2:])
        vf = v[i].reshape(b * t, *v[i].shape[2:])
        qf.append(qs[i].reshape(b * t, *qs[i].shape[2:]).contiguous())
        idx = (wr_page.to(d), wr_off.to(d))
        ck, cv = part(cache["k"], i), part(cache["v"], i)
        if quant:
            # int8 arena: each row quantized on the way in, per kv head
            # (a shard's scales are its own kv heads')
            kq, ksc = kv_quantize(kf)
            vq, vsc = kv_quantize(vf)
            ck.index_put_(idx, kq)
            cv.index_put_(idx, vq)
            part(cache["k_scale"], i).index_put_(idx, ksc)
            part(cache["v_scale"], i).index_put_(idx, vsc)
        else:
            ck.index_put_(idx, kf.to(ck.dtype))
            cv.index_put_(idx, vf.to(cv.dtype))
    qpf = cpos.reshape(-1)
    # a decode step (T = 1) needs no fold: the table and mask are the lanes'
    ptf = page_table if t == 1 else page_table.repeat_interleave(t, dim=0)
    actf = act if t == 1 else act.repeat_interleave(t)
    sharded = isinstance(cache["k"], Shards)
    q_in = qf if sharded else qf[0]
    if quant:
        out = kops.paged_flash_decode_q(
            q_in, cache["k"], cache["v"], cache["k_scale"],
            cache["v_scale"], kpos, ptf, qpf, active=actf)
    else:
        out = kops.paged_flash_decode(q_in, cache["k"], cache["v"], kpos,
                                      ptf, qpf, active=actf)
    outs = list(out) if sharded else [out]
    return [o.reshape(b, t, *o.shape[1:]) for o in outs]


def init_paged_attn_cache(cfg, num_pages: int, page_size: int,
                          dtype=COMPUTE_DTYPE, device=None,
                          quantized: bool = False):
    """Paged KV arena: a global page pool, no batch axis.  kpos starts at
    the never-written sentinel everywhere, the trash page 0 included.

    quantized=True stores int8 k/v plus per-row per-kv-head f32 scale
    planes `k_scale`/`v_scale` (P, ps, KVH) (core/quant.kv_quantize); the
    scales live in the arena, so a shared prefix page carries its scales
    to every lane that reads it."""
    kv_shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {
        "k": torch.zeros(kv_shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=kv_dtype, device=device),
        "kpos": torch.full((num_pages, page_size), KPOS_SENTINEL,
                           dtype=torch.int32, device=device),
    }
    if quantized:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(kv_shape[:3], dtype=torch.float32,
                                      device=device)
    return cache


def init_attn_cache(cfg, batch: int, seq_len: int, dtype=COMPUTE_DTYPE,
                    device=None):
    """Dense per-lane KV cache (the prefill bucket cache); a ring buffer
    of min(seq_len, window) slots when windowed."""
    slots = min(seq_len, cfg.local_window) if cfg.local_window else seq_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # 2^30 marks never-written slots so the causal mask excludes them
        "kpos": torch.full((batch, slots), KPOS_SENTINEL,
                           dtype=torch.int32, device=device),
    }
