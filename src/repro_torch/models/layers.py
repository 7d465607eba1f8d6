"""Shared float layers: norms, RoPE, MLPs, embeddings (port of
`repro/models/layers.py`).

Parameters are plain nested dicts of tensors in the JAX package's layout
(`dense` weights are (d_in, d_out)).  Compute dtype is bf16; norms and
RoPE compute in f32 and cast back, matmuls round their result to bf16.
The norms go through the `row_norm` kernel wrapper (`kernels/ops.py`):
the kernel on the card, its plain version (`kernels/ref.py`) on the CPU.
A `dense` weight that is a {"q", "s"} leaf (`models/quantized.py`) runs
W8A8 through the `int8_matmul` wrapper.  `cross_entropy_sums` is the
evaluation loss (f32 logsumexp over sequence chunks).

Products: serving needs a row to give the same bits in products of
any shape — a decode step's B rows, a verify pass's B*T, a pipeline
microbatch's rows, a tensor-parallel shard's columns — and cuBLAS picks
its kernel and its split of K by shape, so on the card `dense` and
`lm_head` run on the port-only `gemm` kernel (`kernels/ops.gemm`), whose
f32 sums follow an order fixed by K alone.  A verify pass therefore runs
each product once over its B*T rows.  Products of more than
EXACT_ROWS_MAX rows and products that autograd records (the synthetic
fit) take torch.matmul: nothing compares their bits across shapes, and
there cuBLAS runs 3-7x faster.  On the CPU every product is
torch.matmul.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.shard_hints import (Shards, broadcast_to,
                                            fsdp_int8_gather, hint,
                                            paged_shard_ctx, part)

Params = Dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16
# the most rows a product runs on the gemm kernel with.  The cb engine
# prefills one request at a time, at its bucket (max(buckets) rows at
# most: 256 at EngineBase's defaults); a decode step has B rows, a verify
# pass B*T; the wave engine prefills in request blocks of at most this
# many rows (serving/executor.py).  A serve plan that cuts refuses
# buckets past this (serving/engine._check_plan) and `product` raises on
# a longer product under its context.  Longer products take
# torch.matmul, and no plan runs them: the long forward and its loss
# chunks
EXACT_ROWS_MAX = 1024


def product(x: torch.Tensor, w: torch.Tensor, w_nk: bool = False,
            out_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """x (..., K) @ w (w (K, N), or (N, K) when w_nk) in bf16, rounded to
    out_dtype: the gemm kernel for a served product, torch.matmul for one
    of more than EXACT_ROWS_MAX rows or that autograd records (see the
    module docstring).  Under a serve plan's context with more than one
    tensor-parallel shard a product of more than EXACT_ROWS_MAX rows
    raises: its shards' column blocks would not equal one device's."""
    rows = x.numel() // max(x.shape[-1], 1)
    if rows > EXACT_ROWS_MAX and paged_shard_ctx() is not None:
        raise ValueError(
            f"a product of {rows} rows under a tensor-parallel serve plan: "
            f"at most EXACT_ROWS_MAX = {EXACT_ROWS_MAX} rows run on the "
            "K-ordered gemm kernel, whose column blocks equal the whole")
    if rows <= EXACT_ROWS_MAX and not (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad)):
        return ops.gemm(x, w, w_nk=w_nk, out_dtype=out_dtype)
    wk = w.t() if w_nk else w
    if out_dtype == torch.float32:
        return torch.matmul(x.float(), wk.float())
    return torch.matmul(x, wk)


def by_column(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """fn over a (B, T, ...) x one query column at a time, each column a
    contiguous (B, 1, ...) tensor as a decode step holds it; the results
    joined on axis 1 (the MoE router's f32 product in a verify pass,
    which runs on cuBLAS, not on the gemm kernel)."""
    return torch.cat([fn(x[:, j:j + 1].contiguous(), *args)
                      for j in range(x.shape[1])], 1)


def at_lanes(x: torch.Tensor, lanes) -> torch.Tensor:
    """x (n, ...), the lanes `rows` of a `total`-lane batch (lanes =
    (rows, total), rows a slice), at those lanes of a zero (False) tensor
    of `total` lanes: a pipeline stage's rows at one device's shape, for
    the products that run on cuBLAS (the MoE FFN's, the recurrent
    mixers'), which picks its kernel, and with it a row's bits, by the
    row count."""
    rows, total = lanes
    out = x.new_zeros((total,) + tuple(x.shape[1:]))
    out[rows] = x
    return out


def dense(x: torch.Tensor, w, partial: bool = False) -> torch.Tensor:
    """x (..., d) @ w (d, f) in the working dtype; W8A8 (`quantized.qdense`)
    when w is a {"q", "s"} leaf.  partial: the f32 sums, unrounded (a
    tensor-parallel shard's share of a product over a sharded K, which
    the shards' sum rounds once)."""
    if isinstance(w, dict):
        from repro_torch.models.quantized import qdense
        return qdense(x, w)
    return product(x, w, out_dtype=torch.float32 if partial
                   else COMPUTE_DTYPE)


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    return ops.row_norm(x, p["g"], eps=eps)


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    return ops.row_norm(x, p["g"], p["b"], eps=eps)


def norm(x, p, cfg):
    return layernorm(x, p) if cfg.norm == "layernorm" else rmsnorm(x, p)


# -- RoPE -------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE.  x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP --------------------------------------------------------------------


def act_fn(name: str):
    return {
        "silu": F.silu,
        # jax.nn.gelu defaults to the tanh form; F.gelu to exact erf
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def ffn(x: torch.Tensor, wi, wg, wo, act) -> torch.Tensor:
    """act(x wg) * (x wi) @ wo (act(x wi) @ wo when wg is None).  Tensor
    parallel (a serve plan: `wi`, `wg` column `Shards`): shard i computes
    its block of the hidden units, which meet at `wo` as attention's head
    outputs do (gathered before a replicated `wo`, or partial products
    summed, models/shard_hints.py)."""
    xs = broadcast_to(x, wi) if isinstance(wi, Shards) else [x]
    hs = []
    for i, xi in enumerate(xs):
        h = dense(xi, part(wi, i))
        hs.append(act(h) if wg is None
                  else act(dense(xi, part(wg, i))) * h)
    return project_out(hs, wo)


def project_out(hs, wo) -> torch.Tensor:
    """The reduction projection of per-shard blocks `hs` (a list in shard
    order; one block plan-free): gathered on the controller before a
    whole `wo` (an exact plan: one device's product), or, where `wo` is
    row `Shards` (``exact=False``), each block's f32 partial product
    through its rows, summed in shard order and rounded once (W8A8 rows:
    the int32 partial sums, `quantized.qdense_rows`, one device's bits)."""
    if isinstance(wo, Shards):  # psum form
        if isinstance(wo[0], dict):  # W8A8 rows: int32 partial sums
            from repro_torch.models.quantized import qdense_rows
            return qdense_rows(hs, wo)
        return hint([dense(h, wo[i], partial=True)
                     for i, h in enumerate(hs)], "psum").to(hs[0].dtype)
    return dense(hint(hs, "gather"), wo)


def mlp(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """The MLP block (`ffn`, tensor parallel under a plan; its weights'
    FSDP gathers at int8 width under hints(int8_gather=True))."""
    wg = (fsdp_int8_gather(p["wg"], tp_dim=1) if cfg.mlp_style == "swiglu"
          else None)
    return ffn(x, fsdp_int8_gather(p["wi"], tp_dim=1), wg,
               fsdp_int8_gather(p["wo"], tp_dim=0), act_fn(cfg.act))


# -- embedding / head -------------------------------------------------------


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    """Token rows of the embedding.  A vocab-sharded `tok` (a serve plan,
    when the vocabulary divides the shards) takes each token's row from
    the shard that owns it; a width-sharded one joins each row's blocks
    in shard order.  Either is a copy, bit for bit one device's rows."""
    tok = p["tok"]
    if not isinstance(tok, Shards):
        return tok[tokens.long()]
    root = tok[0].device
    t = tokens.long().to(root)
    if tok.dim == 1:
        return torch.cat([w[t.to(w.device)].to(root) for w in tok], -1)
    vs = tok[0].shape[0]
    out = None
    for i, w in enumerate(tok):
        local = t - i * vs
        own = (local >= 0) & (local < vs)
        rows = w[local.clamp(0, vs - 1).to(w.device)].to(root)
        out = rows if out is None else torch.where(own[..., None], rows,
                                                   out)
    return out


def lm_head(h: torch.Tensor, p: Params) -> torch.Tensor:
    """f32 logits of a bf16 product: rounded to bf16 first, then cast.
    A vocab-sharded head (or tied embedding) runs
    one product per shard, the logits concatenated in shard order (so an
    argmax keeps the lowest token id on ties); a tied embedding sharded
    over its width is gathered first (a product over a sharded K would
    sum partials)."""
    w = p.get("head")
    tied = w is None
    if tied:  # the (V, D) embedding read as (N, K)
        w = p["tok"]
    if isinstance(w, Shards):
        if tied and w.dim == 1:
            w = torch.cat([t.to(w[0].device) for t in w], 1)
        else:
            hs = broadcast_to(h, w)
            return hint([product(hs[i], t, w_nk=tied).float()
                         for i, t in enumerate(w)], "gather")
    return product(h, w, w_nk=tied).float()


# -- loss -------------------------------------------------------------------


def cross_entropy_sums(h: torch.Tensor, labels: torch.Tensor,
                       embed_p: Params, chunk: int = 512):
    """The next-token cross-entropy's terms without materializing (B, S,
    V) logits: (the f32 sum of the valid labels' negative
    log-likelihoods, their int32 count), over sequence chunks of `chunk`
    rows, the last one padded with label -1, an f32 logsumexp per chunk.
    Labels < 0 are ignored.  The mean is the sum over the count (at
    least 1): the reference's `cross_entropy_chunked`; a data-parallel
    step sums both terms over its replicas before that one division."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        lx = labels[:, c0:c0 + chunk].long()
        logits = lm_head(h[:, c0:c0 + chunk], embed_p)  # (B, chunk, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx.clamp(min=0)[..., None])[..., 0]
        valid = lx >= 0
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        tot = tot + nll.sum()
        cnt = cnt + valid.sum().to(torch.int32)
    return tot, cnt
