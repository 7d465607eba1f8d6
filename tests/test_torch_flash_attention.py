"""The port's `flash_attention` against the JAX package's, on the CPU.

The JAX side runs the Pallas kernel body itself (`impl="interpret"`), as
the JAX package's own tests do; the port's wrapper takes its plain
version (`kernels/ref.py`) for CPU tensors.  Inputs come from a numpy
seed: q, k, v ~ N(0, 1) in (B, S, H, hd) / (B, S, KVH, hd).

Tolerances, as |got - want| <= atol + rtol * |want|: 2e-5 and 2e-5 in
f32, as tests/test_flash_attention.py (the two sum the same f32 products
in other orders, and the Pallas body's online softmax rescales per
256-key block where the plain version takes one max); 4e-3 and 2^-7 in
bf16, two bf16 ulps of the output plus a floor (p is rounded to bf16
relative to a different running max, and the bf16 output rounds once
more).  That JAX test's 3e-2 in bf16 is no limit here: at S in the
thousands a typical output is ~0.03, and a key tile left out of a late
query tile moves it by less.

The card's bf16 kernel cannot run here, so `_kernel_schedule` repeats
its schedule in torch (128-key tiles; query rows in warpgroups of 64;
p = 2^(x log2e - m log2e) against the running max of each key tile,
rounded to bf16 for PV; the mask applied only on tiles that cross the
causal diagonal or the end of S), and the file holds it against the
plain version and the Pallas body at the bf16 limit: evidence that the
limit covers the kernel's rounding points before the card runs them.

The wrapper is forward-only on both devices, and the last test shows
why: the reference cannot differentiate through its kernel either.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = {"f32": (2e-5, 2e-5), "bf16": (4e-3, 2 ** -7)}  # (atol, rtol)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, s, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, n, hd)).astype(np.float32)
            for n in (h, kvh, kvh)]


def _torch(a, dtype):
    return torch.tensor(a).to(DTYPES[dtype][1])


# every S, head grouping, head_dim, mask and dtype of the sweep appears
# more than once; the ragged S (300, 1100) are no multiple of the card
# kernel's 64-row tiles nor of the Pallas kernel's 256
CASES = [
    # (B, S, H, KVH, hd, causal, dtype)
    (2, 64, 4, 4, 16, True, "f32"),
    (2, 64, 8, 2, 64, False, "bf16"),
    (1, 64, 9, 3, 128, True, "bf16"),
    (1, 300, 9, 3, 64, True, "bf16"),
    (1, 300, 4, 4, 128, False, "f32"),
    (2, 300, 8, 2, 16, True, "f32"),
    (1, 300, 4, 4, 64, False, "bf16"),
    (1, 1100, 4, 4, 16, True, "f32"),
    (1, 1100, 9, 3, 64, True, "bf16"),
    (1, 1100, 8, 2, 128, False, "bf16"),
    (1, 1100, 9, 3, 64, False, "f32"),
    (1, 1100, 8, 2, 128, True, "f32"),
]


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,dtype", CASES)
def test_plain_flash_attention_matches_pallas_body(b, s, h, kvh, hd, causal,
                                                   dtype):
    q, k, v = _inputs(b, s, h, kvh, hd, seed=s + h + hd)
    jdt = DTYPES[dtype][0]
    want = jops.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), causal=causal,
                                impl="interpret")
    n0 = ops.launches["flash_attention"]
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal)
    assert ops.launches["flash_attention"] == n0  # the CPU launches nothing
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype][0], rtol=TOL[dtype][1])


KEY_TILE = 128  # keys per K/V tile of the card's bf16 kernel
LOG2E = 1.4426950408889634


def _kernel_schedule(q, k, v, causal):
    """The card's bf16 flash_attention schedule, in torch on the CPU.

    Key tiles of KEY_TILE keys are walked from tile 0 with an online
    softmax: s = (q . k) * float32(1/sqrt(hd)), summed in f32 from bf16
    inputs; a row's max advances tile by tile; p = 2^(s log2e - m log2e)
    against that running max, summed into l in f32 and rounded to bf16
    for PV.  Rows sit in warpgroups of 64, and a warpgroup applies the
    mask only on a tile that crosses its first row's diagonal (causal) or
    the end of S; elsewhere every key counts.  Tiles past a row's
    diagonal leave it unchanged (p = 0, alpha = 1), so every row may walk
    every tile."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float().reshape(b, s, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B, KVH, S, hd)
    rows = torch.arange(s)[:, None]
    rmin = rows // 64 * 64
    m = torch.full(qf.shape[:-1] + (1,), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, s, KEY_TILE):
        keys = torch.arange(k0, min(k0 + KEY_TILE, s))[None]
        keep = (keys <= rows) | (not causal)
        tile_masked = (((k0 + KEY_TILE - 1 > rmin) & causal)
                       | (k0 + KEY_TILE > s))
        drop = tile_masked & ~keep  # (S, keys): dropped on masked tiles only
        x = torch.einsum("bngqd,bnkd->bngqk", qf, kf[:, :, k0:k0 + KEY_TILE])
        x = torch.where(drop, torch.tensor(ref.NEG_INF), x * scale)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * LOG2E)
        p = torch.exp2(x * LOG2E - mx * LOG2E)
        p = torch.where(drop, torch.tensor(0.0), p)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bngqk,bnkd->bngqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + KEY_TILE])
        m = mx
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


@pytest.mark.parametrize("b,s,h,kvh,hd,causal,dtype",
                         [c for c in CASES if c[-1] == "bf16"])
def test_kernel_schedule_matches_plain_and_pallas_body(b, s, h, kvh, hd,
                                                       causal, dtype):
    q, k, v = _inputs(b, s, h, kvh, hd, seed=s + h + hd)
    got = _kernel_schedule(_torch(q, dtype), _torch(k, dtype),
                           _torch(v, dtype), causal)
    plain = ref.flash_attention(_torch(q, dtype), _torch(k, dtype),
                                _torch(v, dtype), causal=causal)
    jdt = DTYPES[dtype][0]
    pallas = jops.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                  jnp.asarray(v, jdt), causal=causal,
                                  impl="interpret")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    for want in (plain.float().numpy(), np.asarray(pallas, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype][0], rtol=TOL[dtype][1])


def test_wrapper_refuses_grad_on_the_cpu():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 2, 1, 16, 0))
    for which in range(3):
        args = [q.clone(), k.clone(), v.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            ops.flash_attention(*args)
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(True), k, v)
    assert not out.requires_grad  # under no_grad nothing requires grad


def test_wrapper_checks_shapes():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 6, 4, 16, 0))
    with pytest.raises(ValueError, match="head groups"):
        ops.flash_attention(q, k, v)  # 6 query heads over 4 kv heads
    with pytest.raises(ValueError, match="two equal"):
        ops.flash_attention(q, k, v[:, :32])


def test_reference_kernel_has_no_gradient():
    """Why the wrapper is forward-only: jax.grad through the reference's
    interpreted Pallas kernel fails in pallas_call's JVP rule, while the
    same function through the jnp oracle (impl="ref") differentiates."""
    q, k, v = (jnp.asarray(a) for a in _inputs(1, 64, 2, 1, 16, 0))

    def loss(impl):
        return lambda q, k, v: jops.flash_attention(q, k, v,
                                                    impl=impl).sum()

    g = jax.grad(loss("ref"), argnums=(0, 1, 2))(q, k, v)
    assert all(np.isfinite(np.asarray(x)).all() for x in g)
    with pytest.raises(AssertionError):
        jax.grad(loss("interpret"), argnums=(0, 1, 2))(q, k, v)
