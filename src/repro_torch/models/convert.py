"""Weight bridge: JAX parameter trees -> the port's parameters.

The JAX package's `init_params` tree (`{"embed", "scan", "tail",
"final_norm"}`, "scan" leaves stacked on a leading layer axis) arrives as
nested dicts of numpy arrays — e.g. ``jax.tree.map(np.asarray, params)``
— so this module needs no JAX.  The layout is kept as it is; only the
leaves become tensors of the same dtype.  numpy's bfloat16
(ml_dtypes) does not go through ``torch.from_numpy``, so bf16 leaves
travel as their raw 16-bit patterns and are reinterpreted, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dicts of numpy arrays (the JAX layout) -> nested dicts of
    tensors on `device`, the layout `repro_torch.models.transformer`
    reads."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
