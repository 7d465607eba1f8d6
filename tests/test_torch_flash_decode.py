"""The port's plain flash_decode (dense slot cache) against the JAX
package's kernel.

The same numpy inputs go through `repro_torch.kernels.ops.flash_decode`
on CPU tensors (which takes the plain PyTorch version) and through
`repro.kernels.ops.flash_decode` with impl="interpret" (the Pallas body,
run by the interpreter, with its wrapper's padding of Sk to the split
length and of G to 8) and impl="ref" (the jnp oracle).  Cases: GQA
ratios, Sk that is no multiple of 256, sliding windows and ring-buffer
positions, sentinel kpos rows, inactive lanes.

Tolerance: f32 inputs agree to 2e-5 absolute and relative (the JAX
package's own bar between its kernel and oracle; only the summation order
differs).  Inactive and fully masked lanes are exact zeros.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

SENTINEL = 2 ** 30
TOL = dict(atol=2e-5, rtol=2e-5)


def _mk(b, h, kvh, hd, s, seed=0):
    rng = np.random.default_rng(seed)
    return dict(q=rng.normal(0, 1, (b, h, hd)) * hd ** -0.5,
                k=rng.normal(0, 1, (b, s, kvh, hd)),
                v=rng.normal(0, 1, (b, s, kvh, hd)),
                kpos=np.tile(np.arange(s, dtype=np.int32), (b, 1)),
                qpos=rng.integers(s // 2, s, b).astype(np.int32))


def _check(inp, active=None, window=0, bs=None):
    """Port plain vs JAX interpret and ref; returns the port's output."""
    f32 = {n: (np.asarray(a, np.float32) if n in "qkv" else a)
           for n, a in inp.items()}
    got = tops.flash_decode(
        *(torch.tensor(f32[n]) for n in ("q", "k", "v", "kpos", "qpos")),
        active=None if active is None else torch.tensor(active),
        window=window).numpy()
    jin = [jnp.asarray(f32[n]) for n in ("q", "k", "v", "kpos", "qpos")]
    act = None if active is None else jnp.asarray(active)
    for impl in ("interpret", "ref"):
        kw = {"bs": bs} if impl == "interpret" and bs else {}
        want = np.asarray(jops.flash_decode(*jin, active=act, window=window,
                                            impl=impl, **kw))
        np.testing.assert_allclose(got, want, err_msg=impl, **TOL)
    assert np.isfinite(got).all()
    return got


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (6, 1), (9, 3)])
def test_flash_decode_gqa_ratios(h, kvh):
    _check(_mk(2, h, kvh, 16, 64, seed=h))


@pytest.mark.parametrize("s", [33, 192, 300])
def test_flash_decode_ragged_sk(s):
    """Sk of 33, 192 (the serve path's slot rows) and 300 (two splits of
    256, the second ragged): the JAX wrapper pads, the port does not."""
    _check(_mk(3, 9, 3, 64, s, seed=s))


@pytest.mark.parametrize("window", [8, 16, 40])
def test_flash_decode_sliding_window(window):
    _check(_mk(3, 4, 2, 16, 48, seed=window), window=window, bs=16)


def test_flash_decode_ring_buffer_positions():
    """A windowed cache as a ring buffer: kpos is the absolute position
    held at slot = pos % window, and lane 1 has not wrapped yet."""
    window = s = 16
    inp = _mk(2, 4, 2, 16, s, seed=9)
    inp["qpos"] = np.array([20, 7], np.int32)
    ar = np.arange(s)
    inp["kpos"] = np.stack([20 - ((20 - ar) % s),
                            np.where(ar <= 7, ar, SENTINEL)]).astype(np.int32)
    _check(inp, window=window, bs=8)


def test_flash_decode_sentinel_rows():
    """Never-written slots (2^30) are unreachable; a lane whose every slot
    is sentinel gives exact zeros, not NaN."""
    inp = _mk(3, 4, 2, 16, 32, seed=3)
    inp["kpos"][0, 10:] = SENTINEL
    inp["kpos"][1] = SENTINEL
    got = _check(inp, bs=8)
    assert (got[1] == 0).all()


def test_flash_decode_inactive_lanes_are_zero():
    inp = _mk(4, 6, 2, 16, 40, seed=5)
    active = np.array([True, False, True, False])
    got = _check(inp, active=active, window=12, bs=8)
    assert (got[~active] == 0).all()
    on = tops.flash_decode(*(torch.tensor(np.asarray(inp[n], np.float32)
                                          if n in "qkv" else inp[n])
                             for n in ("q", "k", "v", "kpos", "qpos")),
                           window=12).numpy()
    assert np.array_equal(got[active], on[active])  # lanes are independent


def test_flash_decode_bf16_keeps_dtype():
    """bf16 in, bf16 out; within 2e-2 of JAX's oracle (outputs in (-1, 1),
    one bf16 ulp at most 2^-8: the oracle rounds scores and normalised p
    to bf16, the port keeps f32 scores and rounds the unnormalised p)."""
    inp = _mk(2, 6, 3, 64, 50, seed=11)
    bf = {n: torch.tensor(np.asarray(a, np.float32)).bfloat16()
          for n, a in inp.items() if n in "qkv"}
    got = tops.flash_decode(bf["q"], bf["k"], bf["v"],
                            torch.tensor(inp["kpos"]),
                            torch.tensor(inp["qpos"]))
    assert got.dtype == torch.bfloat16
    want = jops.flash_decode(
        *(jnp.asarray(bf[n].float().numpy(), jnp.bfloat16) for n in "qkv"),
        jnp.asarray(inp["kpos"]), jnp.asarray(inp["qpos"]), impl="ref")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_flash_decode_wrapper_checks_and_counts_no_cpu_launch():
    inp = _mk(2, 4, 2, 16, 24, seed=4)
    t = {n: torch.tensor(np.asarray(a, np.float32) if n in "qkv" else a)
         for n, a in inp.items()}
    before = dict(tops.launches)
    with pytest.raises(ValueError, match="kpos"):
        tops.flash_decode(t["q"], t["k"], t["v"], t["kpos"][:, :5],
                          t["qpos"])
    with pytest.raises(ValueError, match="window"):
        tops.flash_decode(t["q"], t["k"], t["v"], t["kpos"], t["qpos"],
                          window=-1)
    tops.flash_decode(t["q"], t["k"], t["v"], t["kpos"], t["qpos"])
    assert tops.launches == before  # the plain version is no launch
