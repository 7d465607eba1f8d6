"""The card's decode schedule, repeated in torch on the CPU.

The CUDA body of `paged_flash_decode`, `flash_decode` and
`paged_flash_decode_q` (`src/repro_torch/kernels/csrc/decode_split.cuh`)
cannot run here, so `decode_schedule` repeats its arithmetic, and the CPU
tests hold it against the plain versions and the JAX package's Pallas
bodies:

* a lane's key slots are cut into tiles of `ops.DECODE_TILE` slots;
  split s of `ops.DECODE_SPLITS` takes tiles [n*s/S, n*(s+1)/S), dealt to
  its `ops.DECODE_WARPS` warps in turn;
* a tile with no kept key is skipped: it changes no state;
* a warp pass scores 256/hd keys at once; the lanes holding pass slot r
  form one sub-stream with its own running (m, l, acc), updated key by
  key: m' = max(m, s), alpha = exp(m - m'), p = exp(s - m') where the key
  counts and 0 elsewhere, l' = l alpha + p, acc' = acc alpha + p V with p
  rounded to V's dtype (bf16 on the card) against the running max it was
  taken from;
* sub-streams, then warps, then splits combine as M = max m_i,
  l = sum l_i e^(m_i - M), acc = sum acc_i e^(m_i - M) (the cluster's
  combine through distributed shared memory);
* out = acc / max(l, 1e-30) in q's dtype; an inactive lane is exact
  zeros;
* `flash_decode` cuts a group of more than 8 query heads into chunks of
  at most 8 (`ops.decode_group_chunks`: 10 -> 5 + 5), one cluster each
  over the same kv head's rows; each chunk runs the schedule above on
  its own heads.

`paged_schedule` maps slot j of a lane to row j % ps of page
page_table[b, j // ps], as the paged kernel's loader does.
`paged_q_schedule` does the same over an int8 arena, as the int8
kernel's loader does: each row is dequantized as float(int8) * its f32
scale (one rounding, `kv_dequantize`), q is promoted to f32, and p stays
f32 for the PV product (V is f32, so rounding p to V's dtype is none);
the result is rounded to q's dtype once, at the end.

`decode_limit` is the card tests' bound on |kernel - plain|.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import kv_dequantize
from repro_torch.kernels import ops, ref


def decode_limit(want, w=None, atol=1e-4):
    """The bound on |out - want| of a decode kernel's output against its
    plain version `want`: atol + 2^-7 |want| + 2^-8 w.  w is the plain
    version over |v| (sum p |v| / l per output), or None where both keep
    p in f32.  Both sides round p to bf16, against different maxima (the
    kernel's running one, the lane's), so each p is off by at most 2^-9
    of itself on each side and the f32 outputs part by at most 2^-8 w;
    rounding both outputs to bf16 adds at most 2^-7 |want|; atol covers
    the f32 summation order."""
    limit = atol + 2 ** -7 * want.float().abs()
    return limit if w is None else limit + 2 ** -8 * w.float()


def _combine(m, l, acc, dim):
    mx = m.amax(dim, keepdim=True)
    w = torch.exp(m - mx)
    return (mx.squeeze(dim), (l * w).sum(dim),
            (acc * w.unsqueeze(-1)).sum(dim))


def tile_plan(n_tiles: int):
    """[split][warp] -> the tiles that warp walks, in order."""
    ns, nw = ops.DECODE_SPLITS, ops.DECODE_WARPS
    return [[list(range(n_tiles * s // ns + w, n_tiles * (s + 1) // ns, nw))
             for w in range(nw)] for s in range(ns)]


def decode_schedule(q, k, v, kpos, qpos, active=None, window=0,
                    with_split_counts=False):
    """Dense-slot decode by the card's schedule.  q: (B, H, hd); k/v:
    (B, Sk, KVH, hd); kpos: (B, Sk); qpos: (B,).  Returns (B, H, hd) in
    q.dtype and, with `with_split_counts`, the (B, DECODE_SPLITS) count of
    kept keys in each split.  A group wider than 8 heads runs as its head
    chunks, one after the other."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    chunks = ops.decode_group_chunks(h // kvh)
    if len(chunks) > 1:
        q4 = q.reshape(b, kvh, h // kvh, hd)
        outs, g0 = [], 0
        for gn in chunks:
            got = _one_chunk(q4[:, :, g0:g0 + gn].reshape(b, kvh * gn, hd),
                             k, v, kpos, qpos, active, window,
                             with_split_counts)
            outs.append(got)
            g0 += gn
        out = torch.cat([(o[0] if with_split_counts else o).reshape(
            b, kvh, -1, hd) for o in outs], 2).reshape(b, h, hd)
        return (out, outs[0][1]) if with_split_counts else out
    return _one_chunk(q, k, v, kpos, qpos, active, window, with_split_counts)


def _one_chunk(q, k, v, kpos, qpos, active, window, with_split_counts):
    """The schedule of one cluster's heads (at most 8 per kv head)."""
    b, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    tile, ns = ops.DECODE_TILE, ops.DECODE_SPLITS
    kpp = 256 // hd  # keys per warp pass
    passes = tile // kpp
    n_tiles = -(-sk // tile)
    pad = n_tiles * tile - sk  # slots past Sk hold no key
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kp = F.pad(kpos, (0, pad), value=ref.KPOS_SENTINEL)
    on = torch.ones((b,), dtype=torch.bool) if active is None else active
    keep = (kp <= qpos[:, None]) & on[:, None]
    if window:
        keep &= qpos[:, None] - kp < window
    walked = keep.reshape(b, n_tiles, tile).any(-1)  # (B, n_tiles)

    plan = tile_plan(n_tiles)
    steps = max(len(ts) for sp in plan for ts in sp) * passes
    nw = ops.DECODE_WARPS
    slot = torch.full((ns, nw, kpp, max(steps, 1)), -1, dtype=torch.long)
    for s, sp in enumerate(plan):
        for w, ts in enumerate(sp):
            for i, t in enumerate(ts):
                for p in range(passes):
                    slot[s, w, :, i * passes + p] = (t * tile + p * kpp
                                                     + torch.arange(kpp))

    qf = q.float().reshape(b, kvh, g, hd)
    shape = (b, kvh, g, ns, nw, kpp)
    m = torch.full(shape, ref.NEG_INF)
    l = torch.zeros(shape)
    acc = torch.zeros(shape + (hd,))
    for j in range(steps):
        sl = slot[..., j]
        valid = sl >= 0
        sc = sl.clamp(min=0)
        kk = kf[:, sc]  # (B, ns, W, kpp, KVH, hd)
        vv = vf[:, sc]
        kept = (keep[:, sc] & valid)[:, None, None]  # (B, 1, 1, ns, W, kpp)
        walk = (walked[:, sc // tile] & valid)[:, None, None]
        x = torch.einsum("bngd,bswrnd->bngswr", qf, kk)
        x = torch.where(kept, x, torch.tensor(ref.NEG_INF))
        mx = torch.maximum(m, x)
        alpha = torch.exp(m - mx)
        p = torch.where(kept, torch.exp(x - mx), torch.tensor(0.0))
        pv = p.to(v.dtype).float()
        l_new = l * alpha + p
        acc_new = (acc * alpha.unsqueeze(-1)
                   + pv.unsqueeze(-1)
                   * vv.permute(0, 4, 1, 2, 3, 5).unsqueeze(2))
        m = torch.where(walk, mx, m)
        l = torch.where(walk, l_new, l)
        acc = torch.where(walk.unsqueeze(-1), acc_new, acc)
    for dim in (5, 4, 3):  # sub-streams, warps, splits
        m, l, acc = _combine(m, l, acc, dim)
    out = acc / torch.clamp(l, min=1e-30).unsqueeze(-1)
    out = torch.where(on[:, None, None, None], out, torch.tensor(0.0))
    out = out.reshape(b, h, hd).to(q.dtype)
    if not with_split_counts:
        return out
    counts = torch.zeros((b, ns), dtype=torch.long)
    for s, sp in enumerate(plan):
        for ts in sp:
            for t in ts:
                counts[:, s] += keep[:, t * tile:(t + 1) * tile].sum(-1)
    return out, counts


def paged_schedule(q, k, v, kpos, page_table, qpos, active=None,
                   with_split_counts=False):
    """Paged decode by the card's schedule: lane b's slot j is row j % ps
    of arena page page_table[b, j // ps]."""
    b = q.shape[0]
    kvh, hd = k.shape[2], k.shape[3]
    pt = page_table.long()
    return decode_schedule(
        q, k[pt].reshape(b, -1, kvh, hd), v[pt].reshape(b, -1, kvh, hd),
        kpos[pt].reshape(b, -1), qpos, active=active,
        with_split_counts=with_split_counts)


def paged_q_schedule(q, k, v, k_scale, v_scale, kpos, page_table, qpos,
                     active=None, with_split_counts=False):
    """Paged decode over an int8 arena by the card's schedule: k/v (P, ps,
    KVH, hd) int8, k_scale/v_scale (P, ps, KVH) f32.  Returns (B, H, hd)
    in q.dtype (and the split counts, as `decode_schedule`)."""
    b = q.shape[0]
    kvh, hd = k.shape[2], k.shape[3]
    pt = page_table.long()
    kd, vd = (kv_dequantize(x[pt], sc[pt]).reshape(b, -1, kvh, hd)
              for x, sc in ((k, k_scale), (v, v_scale)))
    got = decode_schedule(q.float(), kd, vd, kpos[pt].reshape(b, -1), qpos,
                          active=active, with_split_counts=with_split_counts)
    if with_split_counts:
        return got[0].to(q.dtype), got[1]
    return got.to(q.dtype)
