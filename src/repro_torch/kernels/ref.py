"""Plain PyTorch versions of the port's kernels.

Each hand-written kernel in `kernels/csrc/` computes the function of the
same name here.  The wrappers in `kernels/ops.py` take these on the CPU,
the CPU tests hold them against the JAX package, and `chip_smoke.py`
holds each kernel against them on the card.

The I-BERT functions are the integer oracles of `core/ibert_ops.py`
(and the INT8 GEMM contract of `core/quant.py`); kernel and plain
version agree bit for bit.  The GEMM's plain version forms the product
in float64, which is exact (|acc| <= K * 127^2 < 2^53) and runs on the
CPU and on the card alike (PyTorch has no int32 matmul on CUDA).

The decode functions follow the JAX oracles (`repro/kernels/ref.py`
flash_decode / paged_flash_decode / paged_flash_decode_q) with the
kernels' numerics: masked
scores become ``NEG_INF = -1e30`` (never ``-inf``), p is taken from the
mask rather than from the scores, p is cast to the value dtype before the
PV product (bf16 for the bf16 caches, f32 for the dequantized int8 ones)
while its sum stays f32, and the result is divided by
``max(l, 1e-30)`` — so a fully masked (inactive) lane gives exact zeros,
never NaN.  `flash_attention` is the prefill kernel's function (see its
docstring): unscaled q, the scale applied to the f32 score.

`rmsnorm` and `layernorm` are the model's norms as the JAX package
writes them in plain jnp (`repro/models/layers.py`), and the function of
the port-only `row_norm` kernel; `row_norm_schedule` is the same function
in that kernel's order of sums (for the tests and chip_smoke.py only).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import ibert_ops as _io
from repro_torch.core.quant import f32 as _f32
from repro_torch.core.quant import kv_dequantize as _kv_dequantize
from repro_torch.core.quant import requantize as _requantize

NEG_INF = -1e30
KPOS_SENTINEL = 2 ** 30  # never-written cache slot


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kpos: torch.Tensor, qpos: torch.Tensor,
                 active: Optional[torch.Tensor] = None,
                 window: int = 0) -> torch.Tensor:
    """Single-query (decode) attention over a dense per-lane cache.

    q: (B, H, hd) pre-scaled by 1/sqrt(hd); k/v: (B, Sk, KVH, hd) with
    H = G * KVH (GQA: KV is never expanded); kpos: (B, Sk) absolute key
    positions, 2^30 = never written; qpos: (B,); active: optional (B,)
    bool lane gate; window: sliding-window width (0 = none).  A key counts
    iff ``kpos <= qpos``, ``qpos - kpos < window`` when ``window > 0``,
    and the lane is active.  Returns (B, H, hd) in q.dtype.
    """
    b, h, hd = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, kvh, h // kvh, hd).float()
    s = torch.einsum("bngd,bknd->bngk", q5, k.float())  # (B, KVH, G, Sk)
    qp = qpos.reshape(b, 1, 1, 1)
    msk = kpos[:, None, None, :] <= qp
    if window:
        msk = msk & (qp - kpos[:, None, None, :] < window)
    if active is not None:
        msk = msk & active.reshape(b, 1, 1, 1).bool()
    s = torch.where(msk, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(msk, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngk,bknd->bngd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, hd).to(q.dtype)


def paged_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kpos: torch.Tensor, page_table: torch.Tensor,
                       qpos: torch.Tensor,
                       active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged decode: gather each lane's pages through the table, then
    decode.

    k/v: (P, ps, KVH, hd) global page arenas; kpos: (P, ps); page_table:
    (B, MAXP) — lane b's logical positions [j*ps, (j+1)*ps) live in arena
    page page_table[b, j] (entries may repeat across lanes: shared prefix
    pages; unused entries name the all-sentinel trash page 0).
    """
    b = q.shape[0]
    kvh, hd = k.shape[2], k.shape[3]
    pt = page_table.long()
    kg = k[pt].reshape(b, -1, kvh, hd)
    vg = v[pt].reshape(b, -1, kvh, hd)
    kpg = kpos[pt].reshape(b, -1)
    return flash_decode(q, kg, vg, kpg, qpos, active=active)


def paged_flash_decode_q(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, kpos: torch.Tensor,
                         page_table: torch.Tensor, qpos: torch.Tensor,
                         active: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Paged decode over an int8 arena: gather the int8 pages and their
    per-row per-kv-head f32 scales (P, ps, KVH) through the table,
    dequantize (`kv_dequantize`), and decode with q promoted to f32, so p
    stays f32 for the PV product.  Returns (B, H, hd) in q.dtype."""
    b = q.shape[0]
    kvh, hd = k.shape[2], k.shape[3]
    pt = page_table.long()
    kg = _kv_dequantize(k[pt], k_scale[pt]).reshape(b, -1, kvh, hd)
    vg = _kv_dequantize(v[pt], v_scale[pt]).reshape(b, -1, kvh, hd)
    kpg = kpos[pt].reshape(b, -1)
    out = flash_decode(q.float(), kg, vg, kpg, qpos, active=active)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention over contiguous positions 0..S-1, the function of the
    Pallas body `repro/kernels/flash_attention.py::_kernel`.

    q: (B, S, H, hd) *unscaled*; k/v: (B, S, KVH, hd), H = G * KVH (query
    head h reads kv head h // G).  Scores are q . k summed in f32, then
    multiplied by 1/sqrt(hd) in f32; under `causal` key j counts for
    query i iff j <= i.  Softmax in f32, p rounded to v's dtype before
    the PV product (summed in f32), the result divided by max(l, 1e-30)
    and returned in q.dtype.  (The JAX oracle `repro/kernels/ref.py
    ::flash_attention` differs: it takes pre-scaled q and rounds bf16
    scores to bf16.)
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, s, kvh, h // kvh, hd).float()
    sc = torch.einsum("bqngd,bknd->bngqk", q5, k.float()) * (1.0 / hd ** 0.5)
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngqk,bknd->bngqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)  # (B, KVH, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (..., M, K) @ (..., K, N) -> int32, through float64
    (every partial sum is an integer below 2^53 at the shapes here)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor, s_a, s_b,
                bias: Optional[torch.Tensor] = None,
                s_out=None) -> torch.Tensor:
    """INT8 (M,K) x INT8 (K,N) -> INT32 accum (+ int32 bias at scale
    s_a*s_b), optionally requantized to INT8 at s_out.  The paper's Linear
    module (Matrix-Multiply + Bias Addition + Quant)."""
    acc = int_matmul(a, b)
    if bias is not None:
        acc = acc + bias.to(torch.int32)[None, :]
    if s_out is None:
        return acc
    return _requantize(acc, _f32(s_a) * _f32(s_b), s_out)


def i_softmax_rows(q: torch.Tensor, scale) -> torch.Tensor:
    """Integer softmax over the last axis; returns int32 probs at 2^-14."""
    out, _ = _io.i_softmax(q.to(torch.int32), scale, dim=-1)
    return out


def i_layernorm_rows(q8: torch.Tensor, q_gamma: torch.Tensor,
                     q_beta: torch.Tensor) -> torch.Tensor:
    """Integer LayerNorm over the last axis (input int8-range int32)."""
    prep = _io.LNParams(q_gamma, None, q_beta, None)
    out, _ = _io.i_layernorm(q8.to(torch.int32), prep)
    return out


def i_gelu_elem(q: torch.Tensor, scale) -> torch.Tensor:
    out, _ = _io.i_gelu(q.to(torch.int32), scale)
    return out


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last axis in f32, returned in x's dtype
    (`repro/models/layers.py` rmsnorm; the row_norm kernel's function)."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms) * g).to(x.dtype)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance), returned in
    x's dtype (`repro/models/layers.py` layernorm; the row_norm kernel's
    function with a bias)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * g + b
    return y.to(x.dtype)


def row_norm_schedule(x: torch.Tensor, g: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm (b None) or layernorm in the row_norm kernel's exact order
    (csrc/row_norm.cu), over `ops.row_norm_geometry(D, x.dtype)`: value e
    of thread t's slot i is column (i * threads + t) * vec + e; a slot's
    vec values are added as a pairwise tree, a thread's slot trees in slot
    order from +0, the threads' sums by the xor butterfly over the row's
    lanes of a warp, then the warps' sums in warp order.  Only elementwise
    f32 adds and multiplies, IEEE sqrt and division (tensor by tensor: a
    CUDA tensor divided by a scalar is multiplied by its reciprocal), so
    it gives the kernel's bits on the CPU and on the card.  Not on the
    main path: the card tests and chip_smoke.py hold the kernel to it."""
    from repro_torch.kernels.ops import row_norm_geometry

    d = x.shape[-1]
    geo = row_norm_geometry(d, x.dtype)
    vec, th, slots = geo.vec, geo.threads, geo.slots
    xf = x.reshape(-1, d).float()
    n, width = xf.shape[0], slots * th * vec
    xp = torch.zeros((n, width), dtype=torch.float32, device=x.device)
    xp[:, :d] = xf
    inside = torch.arange(width, device=x.device) < d
    lane = torch.arange(th, device=x.device)

    def row_sum(f):  # f: (n, width), zeros outside the row
        v = f.view(n, slots, th, vec)
        while v.shape[-1] > 1:
            v = v[..., 0::2] + v[..., 1::2]
        acc = torch.zeros((n, th), dtype=torch.float32, device=x.device)
        for i in range(slots):
            acc = acc + v[:, i, :, 0]
        o = min(th, 32) // 2
        while o:
            acc = acc + acc[:, lane ^ o]
            o //= 2
        tot = acc[:, 0]
        for w in range(1, th // 32):
            tot = tot + acc[:, 32 * w]
        return tot[:, None]

    fd = torch.full((n, 1), float(d), dtype=torch.float32, device=x.device)
    one = torch.ones_like(fd)
    if b is None:
        r = one / torch.sqrt(row_sum(xp * xp) / fd + eps)
        y = (xf * r) * g
    else:
        mu = row_sum(xp) / fd
        c = xp - mu
        r = one / torch.sqrt(row_sum(torch.where(inside, c * c, 0.0)) / fd
                             + eps)
        y = ((xf - mu) * r) * g + b
    return y.to(x.dtype).view(x.shape)
