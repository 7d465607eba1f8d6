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


# -- arguments of ceil(log2(.)) at and beside a power of two -----------------
#
# The three I-BERT kernels take ceil(log2(v + 1)) of a float32 v (i_softmax:
# the row's i-exp sum; i_layernorm: var << 14 in its integer square root;
# i_gelu: 2 / |s_erf|, from the scale alone), as log(x) / log(2).  Where the
# card's logf and the CPU's log round apart, a power of two flips the
# ceiling.  These helpers make inputs whose argument x = float32(v) + 1 is
# 2^k itself, or the nearest value the input can reach below or above it.


def _f32_plus_one(v) -> np.float32:
    return np.float32(np.float32(v) + np.float32(1))


def beside_power_of_two(k: int, side: int):
    """(lo, hi): the int32 values v >= 1 whose x = float32(v) + 1 is
    2^k (side 0), the largest such x below 2^k (side -1) or the smallest
    above it (side 1), or None where no v reaches one."""
    p = 2 ** k
    w = max(4, p >> 21)
    vs = range(max(1, p - 1 - w), min(2 ** 31 - 1, p - 1 + w) + 1)
    xs = {v: _f32_plus_one(v) for v in vs}
    if side == 0:
        want = np.float32(p)
    else:
        cand = [x for x in xs.values() if (x - p) * side > 0]
        if not cand:
            return None
        want = min(cand) if side > 0 else max(cand)
    hit = [v for v, x in xs.items() if x == want]
    return (min(hit), max(hit)) if hit else None


def softmax_row_with_sum_in(lo: int, hi: int):
    """(row (1, cols) int32, scale): a row of n zeros and up to two values
    -d1, -d2 whose i-exp sum lies in [lo, hi]."""
    d = -torch.arange(0, io.ACT_QMAX + 1, dtype=torch.int32)
    for scale in np.geomspace(1e-4, 64.0, 800).astype(np.float32):
        e = io.i_exp(d, float(scale))[0].numpy().astype(np.int64)
        e0 = int(e[0])
        if e0 < 1 or hi // e0 > 4000:
            continue
        tail = e[1:]
        order = np.argsort(tail)
        srt = tail[order]
        for n in range(max(1, hi // e0), 0, -1):
            rlo, rhi = lo - n * e0, hi - n * e0
            if rhi < 0:
                continue
            if rlo <= 0:
                return np.zeros((1, n), np.int32), scale
            for i1, v1 in enumerate(tail):
                a = np.searchsorted(srt, rlo - v1)
                if a < len(srt) and srt[a] <= rhi - v1:
                    row = np.zeros((1, n + 2), np.int32)
                    row[0, n:] = [-(i1 + 1), -(int(order[a]) + 1)]
                    return row, scale
            if n < hi // e0 - 3:
                break
    raise AssertionError(f"no softmax row sums into [{lo}, {hi}]")


def layernorm_row_with_var(var: int) -> np.ndarray:
    """(1, 8) int32: +-a, +-b, +-c, +-e (mean 0) whose integer variance
    sum(q^2) // 8 = (a^2 + b^2 + c^2 + e^2) // 4 is `var`."""
    two = {}
    lim = int(np.sqrt(4 * var + 3)) + 1
    for c in range(lim):
        for e in range(c, lim):
            two.setdefault(c * c + e * e, (c, e))
    for t in range(4 * var, 4 * var + 4):
        for a in range(lim):
            for b in range(a, lim):
                rest = t - a * a - b * b
                if rest < 0:
                    break
                if rest in two:
                    c, e = two[rest]
                    row = np.array([[a, -a, b, -b, c, -c, e, -e]], np.int32)
                    q = row.astype(np.int64)
                    assert (q * q).sum() // 8 == var and q.sum() == 0
                    return row
    raise AssertionError(f"no row of variance {var}")


def gelu_x(scale) -> torch.Tensor:
    """i_gelu's ceil_log2 argument x = float32(2 / |s_erf|) + 1 at each
    float32 scale, as `core.ibert_ops.i_gelu` computes it."""
    s_e = io.fdiv(io.f32(scale), np.sqrt(2.0))
    s_l = io.f32(io._ERF_A, like=s_e) * s_e * s_e
    return io.fdiv(2.0, torch.abs(s_l)) + 1.0


def gelu_scale_beside(k: int, side: int) -> float:
    """A float32 scale whose i_gelu argument x is 2^k (side 0), or the
    nearest x a scale reaches below (side -1) or above (side 1) it."""
    p = 2.0 ** k
    s0 = np.float32(np.sqrt(2.0) * np.sqrt(2.0 / (abs(io._ERF_A) * (p - 1))))
    span = np.arange(-6000, 6001).astype(np.float32)
    cand = torch.tensor(s0 + span * np.spacing(s0), dtype=torch.float32)
    x = gelu_x(cand)
    if side == 0:
        hit = (x == p).nonzero()
    else:
        on = (x - p) * side > 0
        best = (x[on].min() if side > 0 else x[on].max()) if on.any() else None
        hit = (x == best).nonzero() if best is not None else []
    if not len(hit):
        raise AssertionError(f"no scale gives x on side {side} of 2^{k}")
    return float(cand[int(hit[0])])


def ceil_log2_args() -> np.ndarray:
    """Every argument x the seeded card cases give ceil_log2: i_softmax's
    sums (k = 1 .. 31), i_layernorm's var << 14 (var = 2^m - 1 .. 2^m + 1,
    m = 0 .. 17, wrapping past 2^17) and i_gelu's scales (k = 19 .. 40)."""
    xs = []
    for k in range(1, 32):
        for side in (-1, 0, 1):
            r = beside_power_of_two(k, side)
            if r:
                xs += [_f32_plus_one(v) for v in r]
    for m in range(0, 18):
        for var in (2 ** m - 1, 2 ** m, 2 ** m + 1):
            n = (var << 14) & 0xFFFFFFFF
            n = n - 2 ** 32 if n >= 2 ** 31 else n
            xs.append(_f32_plus_one(max(n, 1)))
    for k in range(19, 41):
        for side in (-1, 0, 1):
            try:
                xs.append(gelu_x(gelu_scale_beside(k, side)).item())
            except AssertionError:
                pass
    return np.array(xs, np.float32)
