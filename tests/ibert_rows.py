"""Seeded I-BERT softmax rows shared by the CPU and the card tests (torch
only: the card's machine has no JAX)."""
import numpy as np
import torch

from repro_torch.core import ibert_ops as io


def row_with_sum(target: int, cols: int):
    """(row, scale): a row of n zeros, -d1, -d2 and -ACT_QMAX padding
    (whose i-exp is 0) with an i-exp sum of exactly `target`."""
    for scale in np.linspace(0.01, 0.02, 41, dtype=np.float32):
        e = io.i_exp(-torch.arange(0, io.ACT_QMAX + 1, dtype=torch.int32),
                     scale)[0].numpy().astype(np.int64)
        n = max(target // int(e[0]) - 1, 1)  # a 0 keeps the row max at 0
        rest = {int(v): d for d, v in enumerate(e) if d}
        for d1 in range(1, len(e)):
            d2 = rest.get(target - n * int(e[0]) - int(e[d1]))
            if d2 is not None and e[-1] == 0:
                row = np.full((1, cols), -io.ACT_QMAX, np.int32)
                row[0, :n + 2] = [0] * n + [-d1, -d2]
                return row, scale
    raise AssertionError(f"no row sums to {target}")
