"""Shared float layers: norms, RoPE, MLPs, embeddings (port of
`repro/models/layers.py`).

Parameters are plain nested dicts of tensors in the JAX package's layout
(`dense` weights are (d_in, d_out)).  Compute dtype is bf16; norms and
RoPE compute in f32 and cast back, matmuls round their result to bf16.
The norms go through the `row_norm` kernel wrapper (`kernels/ops.py`):
the kernel on the card, its plain version (`kernels/ref.py`) on the CPU.
A `dense` weight that is a {"q", "s"} leaf (`models/quantized.py`) runs
W8A8 through the `int8_matmul` wrapper.  `cross_entropy_chunked` is the
evaluation loss (f32 logsumexp over sequence chunks).

Query columns: a speculative verify pass computes T query columns per
lane in one backbone call, where a decode step computes one.  cuBLAS
picks its GEMM kernel (and its split of K) by shape, so a row of a
(B*T, D) product can come out in other bits than the same row of a
(B, D) one.  `dense` and `lm_head` with ``columns=True`` therefore run a
(B, T, D) input as T products of a contiguous (B, 1, D) column each: the
decode step's own product, at M = B.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


def by_column(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """fn over a (B, T, ...) x one query column at a time, each column a
    contiguous (B, 1, ...) tensor as a decode step holds it; the results
    joined on axis 1."""
    return torch.cat([fn(x[:, j:j + 1].contiguous(), *args)
                      for j in range(x.shape[1])], 1)


def dense(x: torch.Tensor, w, columns: bool = False) -> torch.Tensor:
    """x (..., d) @ w (d, f) in the working dtype; W8A8 (`quantized.qdense`)
    when w is a {"q", "s"} leaf.  columns: x is (B, T, d) and runs as T
    products at M = B (see the module docstring)."""
    if columns and x.dim() == 3 and x.shape[1] > 1:
        return by_column(dense, x, w)
    if isinstance(w, dict):
        from repro_torch.models.quantized import qdense
        return qdense(x, w)
    return torch.matmul(x, w)


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


def mlp(x: torch.Tensor, p: Params, cfg, columns: bool = False
        ) -> torch.Tensor:
    a = act_fn(cfg.act)
    h = dense(x, p["wi"], columns)
    if cfg.mlp_style == "swiglu":
        h = a(dense(x, p["wg"], columns)) * h
    else:
        h = a(h)
    return dense(h, p["wo"], columns)


# -- embedding / head -------------------------------------------------------


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return p["tok"][tokens.long()]


def lm_head(h: torch.Tensor, p: Params, columns: bool = False
            ) -> torch.Tensor:
    """f32 logits of a bf16 product: rounded to bf16 first, then cast.
    columns: as `dense`'s."""
    if columns and h.dim() == 3 and h.shape[1] > 1:
        return by_column(lm_head, h, p)
    w = p.get("head")
    if w is None:
        w = p["tok"].t()
    return torch.matmul(h, w).float()


# -- loss -------------------------------------------------------------------


def cross_entropy_chunked(h: torch.Tensor, labels: torch.Tensor,
                          embed_p: Params, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (B, S, V)
    logits: sequence chunks of `chunk` rows, the last one padded with
    label -1; f32 logsumexp per chunk.  Labels < 0 are ignored; returns a
    0-d f32 tensor (0 when no label counts)."""
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
    return tot / torch.clamp(cnt, min=1)
