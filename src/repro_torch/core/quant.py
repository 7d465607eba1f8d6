"""Symmetric integer quantization arithmetic: the I-BERT subset and the
int8 KV-cache rows.

The port's copy of `repro.core.quant`: INT8 operands, INT32 accumulators
and a float32 *scale* per tensor; the "Quant" module turns an INT32
accumulator back into INT8.  Rounding is half away from zero, written out
as ``sign(x) * floor(|x| + 0.5)`` (not `torch.round`, which rounds half
to even).

Scales are 0-d float32 tensors and every scale expression is float32
arithmetic, as in the reference.  A division always has a tensor divisor
on the dividend's device (`fdiv`): PyTorch turns ``x / python_float`` on
the card, and ``python_float / x`` everywhere, into a multiplication by
the reciprocal, which can move the result by an ulp and flip a rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INT8_MIN, INT8_MAX = -127, 127  # symmetric: -128 excluded, as in I-BERT


def f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`x` as a float32 tensor (on `like`'s device when given)."""
    dev = like.device if like is not None else None
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=dev or x.device)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def fdiv(a, b) -> torch.Tensor:
    """IEEE float32 ``a / b`` with both operands as tensors on one device."""
    a = f32(a) if not isinstance(a, torch.Tensor) else a
    return a / f32(b, like=a)


class QTensor(NamedTuple):
    """Integer values + float scale: real = values * scale."""

    values: torch.Tensor  # int8 or int32
    scale: torch.Tensor  # f32 scalar

    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scale


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (I-BERT / TFLite rounding)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def compute_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-tensor scale from the dynamic range."""
    qmax = 2.0 ** (bits - 1) - 1
    return fdiv(torch.clamp(x.abs().max(), min=1e-8), qmax)


def quantize(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
             bits: int = 8) -> QTensor:
    if scale is None:
        scale = compute_scale(x, bits=bits)
    scale = f32(scale)
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(_round_half_away(fdiv(x, scale)), -qmax, qmax)
    return QTensor(q.to(torch.int8 if bits <= 8 else torch.int32), scale)


def requantize(acc: torch.Tensor, scale_in, scale_out) -> torch.Tensor:
    """INT32 accumulator (scale_in) -> INT8 (scale_out): the Quant module."""
    ratio = fdiv(f32(scale_in), scale_out)
    q = _round_half_away(acc.float() * ratio)
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


# float32(1/127): the per-row KV scale is amax times this constant.  Under
# jit, XLA turns the reference's `amax / 127` into exactly this product, and
# the reference quantizes KV rows only inside jitted programs, so its
# arenas hold these scales (they differ from IEEE division by one ulp in ~5%
# of rows).  PyTorch's `t / 127.0` would not match either way: it divides on
# the CPU and multiplies by a reciprocal on the card.  A tensor/tensor
# multiply is the same IEEE operation on both devices.
RECIP_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def kv_quantize(x: torch.Tensor):
    """Per-row symmetric int8 over the last axis, for KV-cache storage.

    x: (..., hd) float; returns (int8 values of x.shape, float32 scales of
    x.shape[:-1]).  Round half away from zero, so |x - dequant| <= scale/2.
    """
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1), min=1e-8)
    s = amax * torch.tensor(RECIP_127, dtype=torch.float32, device=x.device)
    q = torch.clamp(_round_half_away(xf / s[..., None]), INT8_MIN, INT8_MAX)
    return q.to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of `kv_quantize`: (..., hd) int8 + (...,) f32 -> f32."""
    return q.float() * s[..., None]
