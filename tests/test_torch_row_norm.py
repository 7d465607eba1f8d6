"""The row_norm kernel's order of sums, on the CPU.

The card's `row_norm` kernel (`src/repro_torch/kernels/csrc/row_norm.cu`)
cannot run here, so `ref.row_norm_schedule` repeats its arithmetic in
torch over `ops.row_norm_geometry(D, dtype)`: the card tests and
chip_smoke.py hold the kernel equal to it bit for bit, and this file
holds it

* against a literal reading of the kernel (a loop over the threads of a
  row in numpy float32: slot trees, the butterfly, the warps' sums),
  bit for bit;
* against the plain version (`ref.rmsnorm` / `ref.layernorm`) and the
  JAX package's `repro.models.layers` rmsnorm / layernorm on the same
  numpy inputs, at every served width and at rows 1, 8, 40 and 256;
* row-count invariant.

Limits (chip_smoke's ROW_NORM_TOL): a bf16 output within one bf16 ulp of
the other side's (the two round f32 values a few f32 ulps apart), an f32
one within 1e-6 of it; layernorm adds 1e-6 of the row's largest |output|
(x - mu cancels where x is near the mean, so a mean a few f32 ulps apart
moves an output near 0 by more than its own ulp).

The geometry is a function of (D, dtype) alone and covers every row
exactly; its constants equal the ones the kernel compiles with.
"""
import inspect
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.configs.base import list_archs
from repro_torch.kernels import ops, ref

TOL = 1e-6
ROWS = (1, 8, 40, 256)
# the served widths (every registry config's d_model, 64 for .reduced())
# and three that fill no whole 16-byte vector in bf16
WIDTHS = (64, 576, 768, 896, 1536, 2048, 2560, 4096, 5120, 7168, 1, 7, 100)
DTYPES = (torch.bfloat16, torch.float32)
EPS = 1e-6


def _registry_widths():
    cfgs = [get_config(n) for n in list_archs()]
    return sorted({c.d_model for c in cfgs} | {c.reduced().d_model
                                               for c in cfgs})


def _inputs(d, rows=ROWS[-1], seed=0):
    rng = np.random.default_rng(seed + d)
    x = rng.normal(0.3, 1.0, (rows, d)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, d).astype(np.float32)
    b = rng.normal(0, 0.1, d).astype(np.float32)
    return x, g, b


def _assert_close(out, want, layer):
    """|out - want| within one bf16 ulp of want (f32: TOL |want|), plus
    TOL of the row's largest |want| for layernorm."""
    assert out.dtype == want.dtype and out.shape == want.shape
    o, w = out.float(), want.float()
    diff = (o - w).abs()
    if out.dtype == torch.bfloat16:
        limit = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    else:
        limit = TOL * w.abs()
    if layer:
        limit = limit + TOL * w.abs().amax(-1, keepdim=True)
    bad = int((diff > limit).sum())
    assert bad == 0, (f"{bad} outputs beyond the limit; max_abs_err "
                      f"{diff.max().item():.3g}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", _registry_widths() + [1, 7, 100])
def test_geometry_covers_the_row(d, dtype):
    """Every served width (and 1, 7, 100): threads a power of two within
    the block, each thread's slots t, t + T, ... cover the row's vectors
    exactly once, at most ROW_NORM_SLOTS of them a thread (the row in
    registers) at every width the registry serves, a thread a vector
    where the row fits a warp, whole warps a block."""
    geo = ops.row_norm_geometry(d, dtype)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    assert geo.vec * itemsize == 16
    nvec = -(-d // geo.vec)
    t = geo.threads
    assert t & (t - 1) == 0 and 1 <= t <= ops.ROW_NORM_MAX_THREADS
    assert (t * geo.block_rows) % 32 == 0
    assert t * geo.block_rows <= ops.ROW_NORM_MAX_THREADS
    held = np.arange(geo.slots)[:, None] * t + np.arange(t)[None, :]
    held = held[held < nvec]
    assert sorted(held.tolist()) == list(range(nvec))
    assert geo.slots <= ops.ROW_NORM_SLOTS
    # the fewest threads that hold the row at that many slots, with a
    # thread a vector up to a warp
    assert t >= min(32, nvec)
    assert t == 1 or (-(-nvec // (t // 2)) > ops.ROW_NORM_SLOTS
                      or t // 2 < min(32, nvec))


def test_geometry_is_a_function_of_width_and_dtype():
    """(D, dtype) is all the geometry reads, and all the wrapper hands the
    kernel beside the shapes; a width past the registers' reach walks
    the same map in chunks; other dtypes are refused."""
    assert list(inspect.signature(ops.row_norm_geometry).parameters) == [
        "d", "dtype"]
    src = inspect.getsource(ops._row_norm_launch)
    assert "geo = row_norm_geometry(d, x.dtype)" in src
    assert "geo.threads, geo.slots, geo.block_rows" in src
    wide = ops.row_norm_geometry(40000, torch.bfloat16)
    assert wide.threads == ops.ROW_NORM_MAX_THREADS
    assert wide.slots == -(-5000 // 512) > ops.ROW_NORM_SLOTS
    for bad in ((576, torch.float16), (0, torch.bfloat16)):
        with pytest.raises(ValueError, match="row_norm"):
            ops.row_norm_geometry(*bad)


def test_geometry_constants_match_the_cuda_kernel():
    """ops' ROW_NORM_SLOTS and ROW_NORM_MAX_THREADS are the kSlots and
    kMaxBlock csrc/row_norm.cu compiles with; the kernel sums in the
    order the schedule repeats (slot trees, the xor butterfly, the warps
    in order) and refuses a geometry that is not the wrapper's."""
    text = open(os.path.join(os.path.dirname(ops.__file__), "csrc",
                             "row_norm.cu")).read()
    assert re.findall(r"constexpr int kSlots = (\d+);", text) == [
        str(ops.ROW_NORM_SLOTS)]
    assert re.findall(r"constexpr int kMaxBlock = (\d+);", text) == [
        str(ops.ROW_NORM_MAX_THREADS)]
    assert "f[i] = f[2 * i] + f[2 * i + 1];" in text
    assert "s += __shfl_xor_sync(0xffffffffu, s, o);" in text
    assert "for (int k = 1; k < (tpr >> 5); ++k) t += part[first + k];" \
        in text
    assert "slots != (nvec + threads - 1) / threads" in text
    assert "atomicAdd" not in text
    assert "row_norm" in ops.row_norm.__doc__


def _literal(x, g, b, d, dtype):
    """The kernel read literally, one row at a time, in numpy float32:
    each thread's slots, each slot's pairwise tree, the butterfly over
    min(T, 32) lanes, then the warps' sums in order."""
    geo = ops.row_norm_geometry(d, dtype)
    v_, t_, s_ = geo.vec, geo.threads, geo.slots
    f32 = np.float32
    out = np.empty_like(x)
    for n, row in enumerate(x):
        def total(f):
            sums = []
            for t in range(t_):
                acc = f32(0)
                for i in range(s_):
                    vals = [f(row, (i * t_ + t) * v_ + e) for e in range(v_)]
                    while len(vals) > 1:
                        vals = [f32(vals[2 * j] + vals[2 * j + 1])
                                for j in range(len(vals) // 2)]
                    acc = f32(acc + vals[0])
                sums.append(acc)
            o = min(t_, 32) // 2
            while o:
                sums = [f32(sums[t] + sums[t ^ o]) for t in range(t_)]
                o //= 2
            tot = sums[0]
            for w in range(1, t_ // 32):
                tot = f32(tot + sums[32 * w])
            return tot

        fd = f32(d)
        if b is None:
            ms = total(lambda r, c: f32(r[c] * r[c]) if c < d else f32(0))
            rs = f32(1) / np.sqrt(f32(ms / fd + f32(EPS)))
            out[n] = (row * rs).astype(f32) * g
        else:
            mu = f32(total(lambda r, c: r[c] if c < d else f32(0)) / fd)
            var = total(lambda r, c: f32((r[c] - mu) * (r[c] - mu))
                        if c < d else f32(0))
            rs = f32(1) / np.sqrt(f32(var / fd + f32(EPS)))
            out[n] = (((row - mu) * rs).astype(f32) * g).astype(f32) + b
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("d,dtype", [(1, torch.float32), (7, torch.float32),
                                     (100, torch.bfloat16),
                                     (576, torch.bfloat16),
                                     (1536, torch.float32),
                                     (7168, torch.bfloat16)])
@pytest.mark.parametrize("layer", [False, True])
def test_schedule_is_the_kernel_read_literally(d, dtype, layer):
    x, g, b = _inputs(d, rows=2)
    xt = torch.from_numpy(x).to(dtype)
    xq = xt.float().numpy()  # the values the kernel reads
    got = ref.row_norm_schedule(xt, torch.from_numpy(g),
                                torch.from_numpy(b) if layer else None, EPS)
    want = _literal(xq, g, b if layer else None, d, dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("layer", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_schedule_matches_plain_and_jax(d, layer, dtype):
    """The schedule against ref.rmsnorm / ref.layernorm at every row count
    and against JAX's norms on the same numpy inputs, within the limits
    above; and row-count invariant, bit for bit."""
    x, g, b = _inputs(d)
    xt = torch.from_numpy(x).to(dtype)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b) if layer else None
    whole = ref.row_norm_schedule(xt, gt, bt, EPS)
    for rows in ROWS:
        got = ref.row_norm_schedule(xt[:rows], gt, bt, EPS)
        assert torch.equal(got, whole[:rows]), rows
        want = (ref.layernorm(xt[:rows], gt, bt, EPS) if layer
                else ref.rmsnorm(xt[:rows], gt, EPS))
        _assert_close(got, want, layer)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    if layer:
        yj = jlayers.layernorm(xj, {"g": jnp.asarray(g), "b": jnp.asarray(b)},
                               EPS)
    else:
        yj = jlayers.rmsnorm(xj, {"g": jnp.asarray(g)}, EPS)
    want = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(dtype)
    _assert_close(whole, want, layer)


def test_schedule_takes_any_leading_shape():
    """A (B, S, D) tensor gives each row the bits it has alone."""
    x, g, _ = _inputs(576, rows=21)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g)
    whole = ref.row_norm_schedule(xt.view(3, 7, 576), gt)
    assert whole.shape == (3, 7, 576)
    assert torch.equal(whole.view(21, 576), ref.row_norm_schedule(xt, gt))
    assert torch.equal(whole[1], ref.row_norm_schedule(xt[7:14], gt))
