"""W8A8 serving weights (port of `repro/models/quantized.py`).

Weights are quantized once, offline: per output channel, symmetric int8,
stored as {"q": int8, "s": f32 (1, N)}.  Activations are quantized at each
projection with one scale per tensor; the product runs int8 x int8 ->
int32 through the `int8_matmul` wrapper (the hand-written kernel on the
card, its plain version on the CPU) and is scaled back into bf16.
Attention, the norms and the head stay bf16.

Only 2-d `QUANT_NAMES` leaves are quantized, as in the reference: leaves
stacked over a layer period are 3-d and stay bf16, so a model quantizes
only the projections of its tail layers (``n_layers % period``).  Of the
port's families only recurrentgemma-2b has such layers with an MLP (26
layers with a period of 3 leave two); for smollm-135m and the other
attention-only families nothing changes.

`layers.dense` dispatches here when its weight is a {"q", "s"} leaf.  `q`
is kept column-major — a (K, N) tensor whose ``.t()`` is contiguous — so
the kernel reads it K-major with no transposing copy per call.

Rounding is `torch.round` (half to even), as `jnp.round`.  The scales
follow where the reference computes them: a weight's, eagerly (its
executor quantizes outside jit), as the IEEE f32 quotient ``amax / 127``;
an activation's, inside the jitted decode step, as ``amax *
float32(1/127)``, the product XLA compiles that quotient into
(`core/quant.RECIP_127`).  Both give JAX's bits on the CPU
(tests/test_torch_quantized.py).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.quant import RECIP_127, fdiv
from repro_torch.kernels import ops

# the 2-d attention and MLP projections (the MoE names too, as in the
# reference; recurrent-cell projections stay bf16)
QUANT_NAMES = ("wq", "wk", "wv", "wo", "wi", "wg", "shared_wi", "shared_wg",
               "shared_wo")


def _recip_127(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(RECIP_127, dtype=torch.float32, device=like.device)


def column_major(q: torch.Tensor) -> torch.Tensor:
    """A (K, N) tensor of the same values whose ``.t()`` is contiguous."""
    return q.t().contiguous().t()


def quantize_leaf(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel (last axis) symmetric int8: {"q": (K, N) int8,
    column-major, "s": (1, N) f32}."""
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8)
    s = fdiv(amax, 127.0)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": column_major(q), "s": s}


def quantize_params_for_serving(params: Any) -> Any:
    """Every 2-d `QUANT_NAMES` leaf -> {"q", "s"}; the rest as it is."""

    def go(tree, name=""):
        if isinstance(tree, dict):
            return {k: go(v, k) for k, v in tree.items()}
        if name in QUANT_NAMES and tree.dim() == 2:
            return quantize_leaf(tree)
        return tree

    return go(params)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_activation(x: torch.Tensor):
    """One f32 scale for the whole of x, and x in int8 at it."""
    xf = x.float()
    s_x = torch.clamp(xf.abs().amax(), min=1e-8) * _recip_127(xf)
    x8 = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x8, s_x


def qdense(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dynamic-A8 x static-W8 -> int32 -> bf16: x (..., K) with a
    per-tensor scale, w {"q": (K, N) int8, "s": (1, N) f32}."""
    x8, s_x = quantize_activation(x)
    q = w["q"]
    acc = ops.int8_matmul(x8.reshape(-1, x8.shape[-1]), q, 1.0, 1.0)
    acc = acc.reshape(x8.shape[:-1] + (q.shape[-1],))
    return (acc.float() * (s_x * w["s"])).to(torch.bfloat16)
