"""Integer-only I-BERT nonlinearities (Kim et al. 2021), in PyTorch.

The port's copy of `repro.core.ibert_ops`, operation for operation:
second-order polynomial approximations of exp and erf and a Newton
integer square root, so that the encoder runs in INT8/INT32 with float
touch-points only at scale factors.  Nonlinearity inputs are requantized
to ACT_BITS = 12 bits.  These functions are the plain versions behind
`kernels/ref.py`; the CUDA kernels in `kernels/csrc/` compute the same
bits.

What the reference's arithmetic means, spelled out here:

* int32 tensor arithmetic wraps in two's complement (as XLA's does);
  sums are taken in int64 and wrapped back to int32, which gives the
  same bits as a wrapping int32 sum;
* ``//`` on integers floors (``-7 // 2 == -4``);
* right shifts are arithmetic, and a shift by 32 or more fills with the
  sign: the shift amount is clamped to 31;
* a float constant is the float32 rounding of the Python constant, and
  every scale expression is float32, in the reference's order (divisions
  through `quant.fdiv`);
* ``log2(x)`` is ``log(x) / log(2)`` and ``exp2(x)`` is ``exp(x·log 2)``
  in float32, as JAX computes them (`_log2`, `_exp2`).  The Newton
  start of `i_sqrt` is ``int(exp2(k))`` for k = 0..16, taken from the
  table `ISQRT_X0` so that every device uses the same integers: JAX's
  exp2(15) is 32767.984, so its integer is 32767.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quant import QTensor, _round_half_away, f32, fdiv

ACT_BITS = 12  # nonlinearity-input precision
ACT_QMAX = 2 ** (ACT_BITS - 1) - 1  # 2047
SOFTMAX_OUT_BITS = 14  # probabilities emitted with scale 2**-14
LN_NORM_SHIFT = 11  # normalized value scale 2**-11
MIN_RANGE = 0.5  # dynamic-range floor before nonlinearities

# I-BERT polynomial constants
_EXP_A, _EXP_B, _EXP_C = 0.35815147, 1.353, 0.344
_ERF_A, _ERF_B, _ERF_C = -0.2888, -1.769, 1.0
_LN2 = math.log(2.0)
_EXP_CLAMP = -30.0  # exp(-30) ~ 9e-14: clamp keeps z*q_ln2 within int32

_ISQRT_ITERS = 20
# int(exp2(k)) for k = 0..16 as the reference computes exp2 in float32
ISQRT_X0 = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
            16384, 32767, 65536)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating float->int32 (clip at float32(±2.147e9) first)."""
    return torch.clamp(x, -2.147e9, 2.147e9).to(torch.int32)


def _sum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Wrapping int32 sum over `dim` (kept)."""
    return x.sum(dim, keepdim=True, dtype=torch.int64).to(torch.int32)


def _shr(x: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift; a shift of 32 or more fills with the sign."""
    if isinstance(s, torch.Tensor):
        return x >> torch.clamp(s, max=31)
    return x >> min(int(s), 31)


def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) / f32(_LN2, like=x)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(f32(_LN2, like=x) * x)


def requantize_to_bits(q: torch.Tensor, scale, bits: int = ACT_BITS,
                       dim: Optional[int] = None,
                       min_range: float = MIN_RANGE) -> QTensor:
    """Dynamic-range integer->integer requant (the paper's Quant module)."""
    qmax = 2 ** (bits - 1) - 1
    if dim is None:
        amax = q.abs().max()
    else:
        amax = q.abs().amax(dim=dim, keepdim=True)
    scale = f32(scale, like=q)
    range_f = torch.clamp(amax.float() * scale, min=min_range)
    s_out = fdiv(range_f, qmax)
    ratio = fdiv(scale, s_out)
    out = _round_half_away(q.float() * ratio)
    return QTensor(torch.clamp(out, -qmax, qmax).to(torch.int32), s_out)


# ---------------------------------------------------------------------------
# i-exp (I-BERT Alg. 2): exp(qS) for q <= 0
# ---------------------------------------------------------------------------


def i_exp(q: torch.Tensor, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: int32 <= 0.  Returns (q_exp >= 0 int32, S_exp f32 scalar)."""
    s = f32(scale)
    q_clamp = int(torch.floor(fdiv(_EXP_CLAMP, s)).to(torch.int32))
    q = torch.clamp(q, min=q_clamp)
    q_ln2 = int(torch.clamp(_to_i32(torch.floor(fdiv(_LN2, s))), min=1))
    z = torch.div(-q, q_ln2, rounding_mode="floor")  # >= 0
    p = q + z * q_ln2  # in (-q_ln2, 0]
    s_exp = f32(_EXP_A, like=s) * s * s
    q_b = int(_to_i32(torch.floor(fdiv(_EXP_B, s))))
    q_c = int(_to_i32(torch.floor(fdiv(_EXP_C, s_exp))))
    t = p + q_b
    q_out = _shr(t * t + q_c, z)  # /2^z
    return q_out.to(torch.int32), s_exp


# ---------------------------------------------------------------------------
# i-sqrt (I-BERT Alg. 4): integer Newton sqrt with early-stop semantics
# ---------------------------------------------------------------------------


def i_sqrt(n: torch.Tensor) -> torch.Tensor:
    """Elementwise integer sqrt of int32 (floor-ish, I-BERT Alg. 4)."""
    n = n.to(torch.int32)
    bits = torch.ceil(_log2(torch.clamp(n, min=1).float() + 1.0))
    k = torch.ceil(bits / 2.0).long()
    x = torch.tensor(ISQRT_X0, dtype=torch.int32, device=n.device)[k]
    x = torch.clamp(x, min=1)
    done = torch.zeros_like(n, dtype=torch.bool)
    for _ in range(_ISQRT_ITERS):
        d = torch.div(n, torch.clamp(x, min=1), rounding_mode="floor")
        nx = (x + d) >> 1
        done = done | (nx >= x)
        x = torch.where(done, x, nx)
    return torch.where(n == 0, torch.zeros_like(x), x)


# ---------------------------------------------------------------------------
# i-softmax (I-BERT Alg. 3)
# ---------------------------------------------------------------------------


def i_softmax(q: torch.Tensor, scale, dim: int = -1,
              where: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer softmax. q int32 (<= ACT_QMAX range), scale f32.

    Returns (q_p int32 in [0, 2^SOFTMAX_OUT_BITS], S_out = 2^-14).
    `where`: optional bool mask (False entries get probability 0).
    """
    q = q.to(torch.int32)
    if where is not None:
        q = torch.where(where, q, torch.full_like(q, -(2 ** 31) // 2))
    q_max = q.amax(dim=dim, keepdim=True)
    q_exp, _ = i_exp(q - q_max, scale)
    if where is not None:
        q_exp = torch.where(where, q_exp, torch.zeros_like(q_exp))
    q_sum = torch.clamp(_sum32(q_exp, dim), min=1)

    # int32-safe normalization: scale sum into < 2^16, then fixed-point divide
    sh = torch.clamp(torch.ceil(_log2(q_sum.float() + 1.0)) - 16,
                     min=0).to(torch.int32)
    q_e2 = q_exp >> sh
    q_s2 = torch.clamp(q_sum >> sh, min=1)
    factor = torch.div(torch.full_like(q_s2, 2 ** 29), q_s2,
                       rounding_mode="floor")
    q_out = (q_e2 * factor) >> (29 - SOFTMAX_OUT_BITS)
    return q_out.to(torch.int32), f32(2.0 ** (-SOFTMAX_OUT_BITS))


# ---------------------------------------------------------------------------
# i-erf / i-GELU (I-BERT Alg. 1)
# ---------------------------------------------------------------------------


def i_erf(q: torch.Tensor, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    s = f32(scale)
    q_sgn = torch.sign(q).to(torch.int32)
    q_b = int(_to_i32(torch.floor(fdiv(-_ERF_B, s))))  # positive
    q_clip = torch.clamp(torch.abs(q), max=q_b)
    s_l = f32(_ERF_A, like=s) * s * s
    q_c = int(_to_i32(torch.floor(fdiv(_ERF_C, s_l))))  # negative
    t = q_clip - q_b  # <= 0
    q_l = t * t + q_c
    return q_sgn * q_l, s_l


def i_gelu(q: torch.Tensor, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer GELU.  q int32 within ACT_BITS range, scale f32.

    GELU(x) = x * Phi(x), Phi = 0.5(1+erf(x/sqrt2)).  The Phi integer
    (q_erf + q_one, <= 0 at the negative erf scale) is shifted right by a
    g derived from the scale alone, so that |q * q_phi| < 2^30.
    """
    s = f32(scale)
    q = q.to(torch.int32)
    q_erf, s_erf = i_erf(q, fdiv(s, math.sqrt(2.0)))
    q_one = int(_to_i32(torch.floor(fdiv(1.0, s_erf))))  # negative
    tmax = fdiv(2.0, torch.abs(s_erf))
    g = int(torch.clamp(torch.ceil(_log2(tmax + 1.0)) - 19.0, min=0.0)
            .to(torch.int32))
    q_phi = _shr(q_erf + q_one, g)  # |q_phi| < 2^19
    q_out = q * q_phi
    s_out = fdiv(s * s_erf * _exp2(f32(float(g), like=s)), 2.0)
    return q_out.to(torch.int32), s_out


# ---------------------------------------------------------------------------
# i-LayerNorm (I-BERT §3.3; paper Fig. 10 LayerNorm modules)
# ---------------------------------------------------------------------------


class LNParams(NamedTuple):
    q_gamma: torch.Tensor  # int8-range int32, per-channel
    s_gamma: torch.Tensor  # f32 scalar
    q_beta: torch.Tensor  # int32, at scale s_out = 2^-LN_NORM_SHIFT * s_gamma
    s_out: torch.Tensor  # f32 scalar


def layernorm_prepare(gamma: torch.Tensor, beta: torch.Tensor) -> LNParams:
    """Offline float->integer parameter prep (weights side)."""
    s_g = fdiv(torch.clamp(gamma.abs().max(), min=1e-8), 127.0)
    q_g = torch.clamp(_round_half_away(fdiv(gamma, s_g)), -127, 127)
    s_out = f32(2.0 ** (-LN_NORM_SHIFT), like=s_g) * s_g
    q_b = _round_half_away(fdiv(beta, s_out))
    return LNParams(q_g.to(torch.int32), s_g, q_b.to(torch.int32), s_out)


def i_layernorm(q8: torch.Tensor, prep: LNParams, dim: int = -1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer LayerNorm over `dim`.  Input must be int8-range int32 (or
    a sum of two such values: |q| <= 254 gives var <= 64516, so
    ``var << 14`` stays below 2^31)."""
    q = q8.to(torch.int32)
    h = q.shape[dim]
    mean = torch.div(_sum32(q, dim), h, rounding_mode="floor")
    qc = q - mean
    var = torch.div(_sum32(qc * qc, dim), h, rounding_mode="floor")
    std_s = torch.clamp(i_sqrt(var << 14), min=1)  # ~ std * 2^7
    # qc * 2^(LN_NORM_SHIFT+7) / (std*2^7) = (qc/std) * 2^LN_NORM_SHIFT
    norm = torch.div(qc * (1 << (LN_NORM_SHIFT + 7)), std_s,
                     rounding_mode="floor")
    y = norm * prep.q_gamma.to(torch.int32) + prep.q_beta.to(torch.int32)
    return y, prep.s_out


# ---------------------------------------------------------------------------
# float oracles (how close is integer to real math)
# ---------------------------------------------------------------------------


def f_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(fdiv(x, math.sqrt(2.0))))


def f_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=dim)


def f_layernorm(x, gamma, beta, dim: int = -1):
    mu = x.mean(dim, keepdim=True)
    var = ((x - mu) ** 2).mean(dim, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-12) * gamma + beta
