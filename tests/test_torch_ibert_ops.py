"""The port's plain I-BERT kernels against the JAX package, bit for bit.

The same numpy inputs go through `repro_torch.kernels.ops` on CPU tensors
(which take the plain PyTorch versions in `repro_torch.kernels.ref`) and
through `repro.kernels.ops` with impl="interpret" (the Pallas kernel body,
run by the interpreter) and impl="ref" (the jnp oracle).  Integer outputs
must be identical: no tolerance.  Shapes are those of
tests/test_kernels.py, plus the edges where integer semantics differ
between languages: floor division of negative numbers, right shifts by 32
or more, int32 wrap, float32 constants, round half away from zero, and
log2 at powers of two.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibert_rows import ceil_log2_args, row_with_sum
from repro.core import ibert_ops as jio
from repro.core.quant import quantize as jquantize
from repro.kernels import ops as jops
from repro_torch.core import ibert_ops as tio
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

MIN_SCALE = np.float32(np.float32(jio.MIN_RANGE) / np.float32(jio.ACT_QMAX))


def same(got: torch.Tensor, *wants) -> None:
    for want in wants:
        want = np.asarray(want)
        assert got.dtype == getattr(torch, str(want.dtype)), (got.dtype,
                                                              want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)


def q12(x: np.ndarray):
    """numpy floats -> (int32 values, f32 scale) at ACT_BITS, as JAX does."""
    q = jquantize(jnp.asarray(x), bits=jio.ACT_BITS)
    return np.asarray(q.values).astype(np.int32), np.float32(q.scale)


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [
    (8, 128, 128), (128, 512, 256), (50, 300, 70), (1, 128, 128),
    (33, 1024, 65),
])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_matches_jax(m, k, n, requant):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-500, 500, (n,)).astype(np.int32)
    sa, sb, so = np.float32(0.013), np.float32(0.021), np.float32(0.4)
    s_out = so if requant else None
    got = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           torch.tensor(sa), torch.tensor(sb),
                           s_out=None if s_out is None else torch.tensor(so),
                           bias=torch.from_numpy(bias))
    ja, jb, jbias = jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias)
    same(got, *(jops.int8_matmul(ja, jb, sa, sb, s_out=s_out, bias=jbias,
                                 impl=impl)
                for impl in ("interpret", "ref")))


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (33, 65, 77), (7, 1, 100),
                                   (130, 770, 96)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_column_major_b_matches_row_major_and_jax(m, k, n,
                                                             requant):
    """b of shape (K, N) stored column-major (as `quantize_ibert` keeps its
    weights, and as the card kernel reads it with no copy) gives the same
    bits as the row-major b and as JAX's Pallas body, at ragged shapes."""
    rng = np.random.default_rng(m + 10 * k + 100 * n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    bias = rng.integers(-5000, 5000, (n,)).astype(np.int32)
    sa, sb = np.float32(0.013), np.float32(0.021)
    so = np.float32(0.9) if requant else None
    b_row = torch.from_numpy(b)
    b_col = b_row.t().contiguous().t()
    assert b_col.t().is_contiguous() and torch.equal(b_col, b_row)
    got = [tops.int8_matmul(torch.from_numpy(a), bb, torch.tensor(sa),
                            torch.tensor(sb), s_out=so,
                            bias=torch.from_numpy(bias))
           for bb in (b_col, b_row)]
    assert torch.equal(got[0], got[1])
    same(got[0], jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), sa, sb,
                                  s_out=so, bias=jnp.asarray(bias),
                                  impl="interpret"))


@pytest.mark.parametrize("sa", [0.5, 0.49999997, 0.0123])
def test_int8_matmul_requant_rounds_half_away(sa):
    """x = acc * ratio at exact halves, and at 0.49999997, where
    floor(|x| + 0.5) gives 1 and roundf would give 0."""
    a = np.arange(-9, 10, dtype=np.int8).reshape(-1, 1)
    b = np.ones((1, 3), np.int8)
    sa, sb, so = np.float32(sa), np.float32(1.0), np.float32(1.0)
    got = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), sa, sb,
                           s_out=so)
    same(got, *(jops.int8_matmul(jnp.asarray(a), jnp.asarray(b), sa, sb,
                                 s_out=so, impl=impl)
                for impl in ("interpret", "ref")))
    if sa == np.float32(0.49999997):
        assert got[10, 0] == 1 and got[8, 0] == -1


# ---------------------------------------------------------------------------
# i_softmax
# ---------------------------------------------------------------------------


def _softmax_same(q: np.ndarray, scale: np.float32) -> torch.Tensor:
    got = tops.i_softmax(torch.from_numpy(q), torch.tensor(scale))
    jq = jnp.asarray(q)
    same(got, jops.i_softmax(jq, scale, impl="interpret"),
         jops.i_softmax(jq, scale, impl="ref"))
    return got


@pytest.mark.parametrize("rows,cols", [(8, 64), (13, 77), (64, 128), (1, 9)])
def test_i_softmax_matches_jax(rows, cols):
    rng = np.random.default_rng(rows * 100 + cols)
    q, s = q12(rng.normal(0, 4, (rows, cols)).astype(np.float32))
    p = _softmax_same(q, s).numpy() * 2.0 ** -jio.SOFTMAX_OUT_BITS
    assert np.all(p >= 0)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=2e-2)


def test_i_softmax_clamped_rows_shift_past_31():
    """A wide scale puts q - max far below the -30 clamp, where the i-exp
    shift z reaches ~43: the reference fills with the sign there."""
    rng = np.random.default_rng(3)
    q = rng.integers(-jio.ACT_QMAX, jio.ACT_QMAX + 1, (16, 50)).astype(
        np.int32)
    scale = np.float32(0.02)
    q_ln2 = int(np.floor(np.float32(jio._LN2) / scale))
    assert 1500 // q_ln2 >= 32  # z at the clamp, floor(-30 / 0.02)
    _softmax_same(q, scale)


def test_i_softmax_at_the_min_range_scale_wraps_the_sum():
    """At the MIN_RANGE floor an equal row's i-exp values (~4.7e7 each)
    sum past 2^31: the int32 sum wraps, in the reference and here."""
    rng = np.random.default_rng(4)
    q = rng.integers(-300, 300, (6, 77)).astype(np.int32)
    q[0] = 0
    q[1] = -5
    _softmax_same(q, MIN_SCALE)
    e, _ = tio.i_exp(torch.zeros(1, dtype=torch.int32), MIN_SCALE)
    assert 77 * int(e) > 2 ** 31


@pytest.mark.parametrize("target", [2 ** 15 - 1, 2 ** 15, 2 ** 17 - 1,
                                    2 ** 17, 2 ** 17 + 1])
def test_i_softmax_rows_whose_sum_is_a_power_of_two(target):
    """ceil(log2(q_sum + 1)) at q_sum + 1 = 2^k and at q_sum = 2^k: the
    reference's log2 is log(x) / log(2) in float32."""
    q, scale = row_with_sum(target, 16)
    e, _ = tio.i_exp(torch.from_numpy(q), scale)
    assert e.sum().item() == target
    _softmax_same(q, scale)


def test_kernels_ceil_log2_matches_the_reference_beside_powers_of_two():
    """The card kernels' ceil_log2 (csrc/ibert_int.cuh) takes the float32
    of a double log, the correctly rounded float32 log, then the
    reference's float32 division by ln 2: at every argument the seeded
    card cases reach (tests/test_torch_cuda.py), it equals the port's and
    JAX's ceil(log2(x)).  With a float32 log one ulp high, as CUDA's logf
    gave at x = 2^26 (i_gelu's shift one too large on the card), 2^26
    flips to 27."""
    xs = ceil_log2_args()
    ln2 = np.float32(tio._LN2)
    kernel = np.array([np.ceil(np.float32(math.log(float(x))) / ln2)
                       for x in xs])
    assert (kernel == torch.ceil(tio._log2(torch.from_numpy(xs))).numpy()
            ).all()
    assert (kernel == np.asarray(jnp.ceil(jnp.log2(jnp.asarray(xs))))).all()
    x = np.float32(2.0 ** 26)
    assert kernel[list(xs).index(x)] == 26
    up = np.nextafter(np.float32(math.log(float(x))), np.float32(np.inf))
    assert np.ceil(up / ln2) == 27
    src = open(os.path.join(os.path.dirname(tops.__file__), "csrc",
                            "ibert_int.cuh")).read()
    assert "ceilf((float)log((double)x) / kLn2)" in src


# The card kernel (csrc/i_softmax.cu) divides by q_ln2 as a multiply-high
# by a reciprocal: for 0 <= n < 2^RECIP_BITS and d = q_ln2 >= 1, with l =
# ceil(log2 d), s = RECIP_BITS + l and m = ceil(2^s / d), floor(n / d) =
# (n * m) >> s, in uint64 as the card computes it.  The emulation below
# repeats that formula; test_i_softmax_reciprocal_matches_the_cuda_kernel
# holds it to the source.
RECIP_BITS = 31


def _recip_div(n: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The kernel's floor(n / d) for n in [0, 2^RECIP_BITS), d >= 1."""
    n, d = n.astype(np.uint64), d.astype(np.uint64)
    _, l = np.frexp((d - np.uint64(1)).astype(np.float64))  # ceil(log2 d)
    s = np.uint64(RECIP_BITS) + l.astype(np.uint64)
    m = ((np.uint64(1) << s) + d - np.uint64(1)) // d  # ceil(2^s / d)
    assert np.all(m < np.uint64(2 ** 32)) and np.all(n < np.uint64(2 ** 31))
    return (n * m) >> s


def _q_ln2(scale: np.float32) -> int:
    return max(int(np.floor(np.float32(jio._LN2) / scale)), 1)


def _n_max() -> int:
    """-q_clamp at MIN_SCALE: the largest dividend i-exp meets at a scale
    in [MIN_SCALE, 1] (q_clamp = floor(-30 / S) grows with S)."""
    return -int(np.floor(np.float32(jio._EXP_CLAMP) / MIN_SCALE))


def test_i_softmax_reciprocal_division_is_floor_division():
    """Every q_ln2 a float32 scale in [MIN_SCALE, 1] gives (it falls as
    the scale grows, so all lie in [q_ln2(1), q_ln2(MIN_SCALE)]), at
    dividends 0, 1, b-1, b, b+1, k b +- 1 up to -q_clamp and 2^31 - 1,
    then 10^5 random dividends in [0, 2^31) at random such divisors and
    10^5 at random divisors in [1, 2^31)."""
    d_lo, d_hi, n_max = _q_ln2(np.float32(1.0)), _q_ln2(MIN_SCALE), _n_max()
    assert d_lo == 1 and d_hi > 2000 and n_max < 2 ** 31
    for b in range(d_lo, d_hi + 1):
        k = np.arange(1, n_max // b + 2, dtype=np.int64) * b
        n = np.concatenate([[0, 1, b - 1, b, b + 1, n_max, 2 ** 31 - 1],
                            k - 1, k + 1])
        n = n[(n >= 0) & (n < 2 ** 31)]
        got = _recip_div(n, np.full_like(n, b))
        np.testing.assert_array_equal(got.astype(np.int64), n // b,
                                      err_msg=f"q_ln2 {b}")
    rng = np.random.default_rng(19)
    n = rng.integers(0, 2 ** 31, 2 * 10 ** 5, dtype=np.int64)
    d = np.concatenate([rng.integers(d_lo, d_hi + 1, 10 ** 5),
                        rng.integers(1, 2 ** 31, 10 ** 5)]).astype(np.int64)
    np.testing.assert_array_equal(_recip_div(n, d).astype(np.int64), n // d)


def test_i_softmax_reciprocal_matches_the_cuda_kernel():
    """RECIP_BITS and _recip_div's formula are the ones csrc/i_softmax.cu
    compiles, and the kernel keeps floordiv for a dividend below 0."""
    import os
    import re

    text = open(os.path.join(os.path.dirname(tops.__file__), "csrc",
                             "i_softmax.cu")).read()
    bits = re.findall(r"constexpr int kDivBits = (\d+);", text)
    assert bits == [str(RECIP_BITS)], bits
    for line in ("const int l = d > 1 ? 32 - __builtin_clz(d - 1) : 0;",
                 "c.s = kDivBits + l;",
                 "c.m = (unsigned)(((1ull << c.s) + d - 1) / d);",
                 "const int n = wsub(0, qn);",
                 "if (__builtin_expect(n < 0, 0))",
                 "z = floordiv(n, c.q_ln2);",
                 "z = (int)(((unsigned long long)(unsigned)n * c.m) >> c.s);"):
        assert text.count(line) == 1, line


@pytest.mark.parametrize("scale", [MIN_SCALE, np.float32(0.004),
                                   np.float32(0.02), np.float32(1.0)])
def test_i_exp_with_the_reciprocal_matches_jax(scale):
    """The kernel's i-exp, its division emulated, at every qn from below
    the clamp to 0, equals JAX's and the port's i_exp."""
    f32 = np.float32
    q_clamp = int(np.floor(f32(jio._EXP_CLAMP) / scale))
    q_ln2 = _q_ln2(scale)
    q_b = int(np.floor(f32(jio._EXP_B) / scale))
    q_c = int(np.floor(f32(jio._EXP_C) / (f32(jio._EXP_A) * scale * scale)))
    qn = np.arange(q_clamp - 5, 1, dtype=np.int64)
    qc = np.maximum(qn, q_clamp)
    z = _recip_div(-qc, np.full_like(qc, q_ln2)).astype(np.int64)
    t = qc + z * q_ln2 + q_b
    e = (t * t + q_c).astype(np.int32) >> np.minimum(z, 31).astype(np.int32)
    q = qn.astype(np.int32)
    same(torch.from_numpy(e), jio.i_exp(jnp.asarray(q), scale)[0],
         tio.i_exp(torch.from_numpy(q), scale)[0].numpy())


# ---------------------------------------------------------------------------
# i_layernorm
# ---------------------------------------------------------------------------


def _ln_same(q: np.ndarray, gamma: np.ndarray, beta: np.ndarray) -> None:
    jprep = jio.layernorm_prepare(jnp.asarray(gamma), jnp.asarray(beta))
    tprep = tio.layernorm_prepare(torch.from_numpy(gamma),
                                  torch.from_numpy(beta))
    for jf, tf in zip(jprep, tprep):
        same(tf, jf)
    got, s_out = tops.i_layernorm(torch.from_numpy(q), tprep)
    jq = jnp.asarray(q)
    same(got, jops.i_layernorm(jq, jprep, impl="interpret")[0],
         jops.i_layernorm(jq, jprep, impl="ref")[0])
    same(s_out, jprep.s_out)


@pytest.mark.parametrize("rows,h", [(8, 768), (9, 576), (16, 64), (3, 8192),
                                    (5, 1), (3, 513)])
def test_i_layernorm_matches_jax(rows, h):
    rng = np.random.default_rng(rows + h)
    x = rng.normal(0, 2, (rows, h)).astype(np.float32)
    q = np.asarray(jquantize(jnp.asarray(x), bits=8).values).astype(np.int32)
    _ln_same(q, rng.uniform(0.5, 1.5, h).astype(np.float32),
             rng.normal(0, 0.1, h).astype(np.float32))


def test_i_layernorm_residual_sums_and_negative_means():
    """Rows as the encoder feeds them: sums of two int8 residuals (up to
    ±254), rows with a negative mean, a constant row, an all-±254 row."""
    rng = np.random.default_rng(7)
    h = 768
    r = (rng.integers(-127, 128, (8, h)) + rng.integers(-127, 128, (8, h)))
    r[1] -= 120  # negative mean
    r[2] = np.clip(r[2] - 200, -254, 254)
    r[3] = -37  # zero variance
    r[4] = np.where(rng.random(h) < 0.5, 254, -254)
    r[5] = np.where(rng.random(h) < 0.9, -254, 254)
    _ln_same(r.astype(np.int32), rng.uniform(-1.5, 1.5, h).astype(np.float32),
             rng.normal(0, 0.3, h).astype(np.float32))


@pytest.mark.parametrize("h", [2, 513, 768])
def test_i_layernorm_rows_whose_variance_wraps(h):
    """Values far outside the residual range, as the card tests feed the
    kernel: at +-470 (var = 220900) var << 14 wraps to -675741696, where
    i_sqrt runs all 20 steps; at +-400 to -1673527296, where a step's sum
    wraps and stops it; at +-2^20 the int32 sum of squares wraps too."""
    rng = np.random.default_rng(h)
    sign = np.where(np.arange(h) % 2, -1, 1)
    r = np.stack([470 * sign, 400 * sign,
                  rng.integers(-2 ** 12, 2 ** 12, h),
                  rng.integers(-2 ** 20, 2 ** 20, h),
                  rng.integers(-127, 128, h) - 2 ** 14])
    _ln_same(r.astype(np.int32), rng.uniform(-1.5, 1.5, h).astype(np.float32),
             rng.normal(0, 0.3, h).astype(np.float32))


def test_i_sqrt_matches_jax_and_its_start_table():
    """Newton starts come from ISQRT_X0, which must hold JAX's
    int(exp2(k)); the sweep covers 0, powers of two (var << 14 at var =
    2^j), their neighbours, the largest int32 and wrapped negatives."""
    k = np.arange(len(tio.ISQRT_X0), dtype=np.float32)
    assert list(tio.ISQRT_X0) == np.asarray(
        jnp.exp2(jnp.asarray(k))).astype(np.int32).tolist()
    p2 = 2 ** np.arange(31, dtype=np.int64)
    n = np.concatenate([p2, p2 - 1, p2 + 1, (p2 % 65537) << 14,
                        np.arange(0, 3000), [2 ** 31 - 1, -1, -5, -(2 ** 31),
                                             -123456789]])
    n = n[(n >= -(2 ** 31)) & (n < 2 ** 31)].astype(np.int32)
    same(tio.i_sqrt(torch.from_numpy(n)), jio.i_sqrt(jnp.asarray(n)))


# ---------------------------------------------------------------------------
# i_gelu
# ---------------------------------------------------------------------------


def _gelu_same(q: np.ndarray, scale: np.float32,
               impls=("interpret", "ref")) -> None:
    got = tops.i_gelu(torch.from_numpy(q), torch.tensor(scale))
    jq = jnp.asarray(q)
    same(got, *(jops.i_gelu(jq, scale, impl=impl) for impl in impls))
    _, ts = tio.i_gelu(torch.from_numpy(q), torch.tensor(scale))
    same(ts, jio.i_gelu(jq, scale)[1])


@pytest.mark.parametrize("shape", [(37, 100), (64, 64), (1, 5), (128, 300),
                                   (1, 3), (1, 4099)])
def test_i_gelu_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    q, s = q12(rng.uniform(-6, 6, shape).astype(np.float32))
    _gelu_same(q, s)


@pytest.mark.parametrize("scale", [MIN_SCALE, np.float32(1e-6),
                                   np.float32(0.3)])
def test_i_gelu_at_extreme_scales(scale):
    """The MIN_RANGE floor, a scale small enough that the Phi shift g
    passes 31, and a coarse one.  Held against the oracle: under jit, XLA
    turns the Pallas body's ``scale / sqrt(2)`` into a multiplication by
    the float32 reciprocal, which at the MIN_RANGE scale moves s_e by an
    ulp, so there the JAX package's interpret path and its own oracle
    disagree (3 of these 297 elements); the port divides, as the oracle
    and the encoder's ``impl="ref"`` path do."""
    rng = np.random.default_rng(11)
    q = rng.integers(-jio.ACT_QMAX, jio.ACT_QMAX + 1, (9, 33)).astype(
        np.int32)
    _gelu_same(q, scale, impls=("ref",))
    s = np.float32(scale)
    if s / np.float32(np.sqrt(2.0)) == s * np.float32(1 / np.sqrt(2.0)):
        _gelu_same(q, scale, impls=("interpret",))


def test_requantize_to_bits_matches_jax():
    rng = np.random.default_rng(5)
    for amp in (3, 30000, 2 ** 20):
        q = rng.integers(-amp, amp, (7, 19)).astype(np.int32)
        s = np.float32(0.0037)
        got = tio.requantize_to_bits(torch.from_numpy(q), torch.tensor(s))
        want = jio.requantize_to_bits(jnp.asarray(q), s)
        same(got.values, want.values)
        same(got.scale, want.scale)


def test_quantize_and_requantize_match_jax():
    from repro.core import quant as jq

    rng = np.random.default_rng(6)
    x = rng.normal(0, 3, (17, 23)).astype(np.float32)
    got = tquant.quantize(torch.from_numpy(x))
    want = jq.quantize(jnp.asarray(x))
    same(got.values, want.values)
    same(got.scale, want.scale)
    acc = rng.integers(-2 ** 24, 2 ** 24, (5, 11)).astype(np.int32)
    same(tquant.requantize(torch.from_numpy(acc), torch.tensor(
        np.float32(3e-5)), torch.tensor(np.float32(0.07))),
        jq.requantize(jnp.asarray(acc), np.float32(3e-5), np.float32(0.07)))


def test_masked_i_softmax_matches_jax():
    """The `where` form (False entries get probability 0)."""
    rng = np.random.default_rng(8)
    q, s = q12(rng.normal(0, 4, (6, 40)).astype(np.float32))
    where = rng.random((6, 40)) < 0.7
    where[0] = False  # a fully masked row
    got, gs = tio.i_softmax(torch.from_numpy(q), torch.tensor(s),
                            where=torch.from_numpy(where))
    want, ws = jio.i_softmax(jnp.asarray(q), s, where=jnp.asarray(where))
    same(got, want)
    same(gs, ws)


def test_float_oracles_match_jax():
    """f32 tolerance: erf, exp and the reductions differ by ulps."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 2, (5, 64)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for got, want in ((tio.f_gelu(tx), jio.f_gelu(jx)),
                      (tio.f_softmax(tx), jio.f_softmax(jx)),
                      (tio.f_layernorm(tx, torch.from_numpy(g),
                                       torch.from_numpy(b)),
                       jio.f_layernorm(jx, jnp.asarray(g), jnp.asarray(b)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
