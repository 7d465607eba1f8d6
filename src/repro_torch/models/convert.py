"""Weight bridge: JAX parameter trees -> the port's parameters.

The JAX package's trees arrive as nested dicts of numpy arrays — e.g.
``jax.tree.map(np.asarray, params)`` — so this module needs no JAX.  Two
kinds are carried:

* the decoder LM's `init_params` tree (`{"embed", "scan", "tail",
  "final_norm"}`, "scan" leaves stacked on a leading layer axis);
* I-BERT's float tree (`init_ibert_params`) and its quantized tree
  (`quantize_ibert`): int8 weights, int32 biases, `LNParams` named tuples
  (which become the port's `LNParams`), 0-d float32 scales and the
  calibrated `act` dict;
* a decoder tree quantized for W8A8 serving
  (`quantize_params_for_serving`), whose {"q", "s"} leaves keep their
  values.

The layout is kept as it is; only the leaves become tensors of the same
dtype.  A W8A8 weight's 2-d `q` becomes column-major, as the port's own
`models/quantized.quantize_leaf` stores it.  A 0-d leaf (a scale) stays
on the CPU, where the port keeps scale arithmetic.  numpy's bfloat16
(ml_dtypes) does not go through ``torch.from_numpy``, so bf16 leaves
travel as their raw 16-bit patterns and are reinterpreted, bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.ibert_ops import LNParams
from repro_torch.models.quantized import column_major


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Any, device="cuda") -> Any:
    """Nested dicts (and named tuples) of numpy arrays, in the JAX layout
    -> the same structure of tensors on `device` (0-d leaves on the
    CPU), the layout `repro_torch.models.transformer` and
    `repro_torch.models.ibert` read."""
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device) for k, v in tree.items()}
        if set(out) == {"q", "s"} and out["q"].dim() == 2:
            out["q"] = column_major(out["q"])
        return out
    if isinstance(tree, tuple):
        if type(tree).__name__ != "LNParams":
            raise TypeError(f"no port type for {type(tree).__name__}")
        return LNParams(*(params_from_jax(v, device) for v in tree))
    leaf = np.asarray(tree)
    return tensor_from_numpy(leaf, "cpu" if leaf.ndim == 0 else device)
