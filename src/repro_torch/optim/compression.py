"""Gradient compression for the inter-cluster hop (port of
`repro/optim/compression.py`).

Block-wise int8 quantization with error feedback: a tensor flattened into
blocks of BLOCK values, each block stored as int8 at its own f32 scale
(largest |x| / 127), so the slow cross-pod link carries about a quarter
of an f32 all-reduce's bytes.  `compressed_psum` is the all-reduce over
the port's per-shard tensors (`core/gmi.py`'s convention: a list of one
tensor per flat shard of the mesh): every shard's int8 blocks and scales
gathered, then dequantized and summed in shard order on each shard's
device.

Rounding is `torch.round` (half to even), as `jnp.round`, and the scale's
division is the IEEE f32 quotient, as XLA computes it on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import gmi
from repro_torch.launch.mesh import DeviceMesh

BLOCK = 256


def block_quantize(x: torch.Tensor, block: int = BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flatten -> (int8 values (nblk, block), f32 per-block scales
    (nblk, 1), pad)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), pad


def block_dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int,
                     shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(xs, mesh: DeviceMesh, axis, block: int = BLOCK):
    """All-reduce of the per-shard tensors `xs` over `axis`, exchanging
    int8 blocks instead of f32: each shard's (int8 blocks, f32 scales)
    gathered over its group, then dequantized and summed in the group's
    order on every member's device."""
    quant = [block_quantize(x, block) for x in xs]
    qg = gmi.allgather([q for q, _, _ in quant], mesh, axis)
    sg = gmi.allgather([s for _, s, _ in quant], mesh, axis)
    out = []
    for x, (_, _, pad), q, s in zip(xs, quant, qg, sg):
        parts = q.float() * s  # (N, nblk, block), the group's order
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        flat = total.reshape(-1)
        if pad:
            flat = flat[:-pad]
        out.append(flat.reshape(x.shape))
    return out


def quantize_residual(x: torch.Tensor, block: int = BLOCK):
    """(compressed, residual) pair for error-feedback accumulation."""
    q, scale, pad = block_quantize(x, block)
    deq = block_dequantize(q, scale, pad, x.shape)
    return (q, scale, pad), x - deq
