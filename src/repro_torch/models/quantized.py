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

Under a tensor-parallel serve plan (serving/executor.py) the reference
shards `q` like its parent weight and replicates `s`
(`repro/core/cluster_builder.py:244-250`).  The port keeps each shard's
block a {"q", "s"} leaf of its own: a column block (`wi`, `wg`) holds its
columns of `q` and of `s` and runs `qdense` on the replicated input, whose
scale is the whole tensor's; a row block (`wo` under ``exact=False``)
holds its rows of `q` and the whole `s`, and `qdense_rows` quantizes every
shard's input block at the one scale of the whole input (the max of the
shards' amax, which GSPMD computes for the reference) and adds the
shards' int32 partial sums in shard order before the one dequantizing
multiply.  int32 addition is exact, so either form gives one device's
bits.

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
from repro_torch.models.shard_hints import broadcast_to, hint

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


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor f32 scale of an activation whose largest |x| is
    `amax`."""
    return torch.clamp(amax, min=1e-8) * _recip_127(amax)


def quantize_activation(x: torch.Tensor, s_x=None):
    """One f32 scale for the whole of x (or the scale `s_x` given: that of
    the whole tensor x is a block of), and x in int8 at it."""
    xf = x.float()
    if s_x is None:
        s_x = activation_scale(xf.abs().amax())
    x8 = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x8, s_x


def _int32_product(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    acc = ops.int8_matmul(x8.reshape(-1, x8.shape[-1]), q, 1.0, 1.0)
    return acc.reshape(x8.shape[:-1] + (q.shape[-1],))


def qdense(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dynamic-A8 x static-W8 -> int32 -> bf16: x (..., K) with a
    per-tensor scale, w {"q": (K, N) int8, "s": (1, N) f32}."""
    x8, s_x = quantize_activation(x)
    acc = _int32_product(x8, w["q"])
    return (acc.float() * (s_x * w["s"])).to(torch.bfloat16)


def qdense_rows(hs, wo) -> torch.Tensor:
    """`qdense` of the concatenation of the blocks `hs` (shard order) with
    the row `Shards` `wo` (shard i: {"q": its (K/n, N) rows, "s": the whole
    (1, N)}), on shard 0's device: every block quantized at the whole
    input's scale, the shards' int32 partial sums added in shard order,
    then one dequantizing multiply (the reference's int32 all-reduce)."""
    root = hs[0].device
    amax = torch.stack([h.float().abs().amax().to(root) for h in hs]).amax()
    s_x = activation_scale(amax)
    scales = broadcast_to(s_x, hs)
    acc = hint([_int32_product(quantize_activation(h, s)[0], w["q"])
                for h, s, w in zip(hs, scales, wo)], "psum")
    return (acc.float() * (s_x * wo[0]["s"].to(root))).to(torch.bfloat16)
