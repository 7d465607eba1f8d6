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

The card kernel's schedule (tests/decode_schedule.py: 32-slot tiles split
over a cluster of 8 blocks and their warps, skipped tiles, per-sub-stream
online softmax with p rounded to bf16 against its own running max, the
cluster combine) is held against the plain version and the Pallas body
at the same f32 bar and, in bf16, at 2e-2 (outputs in (-1, 1), where one
bf16 ulp is at most 2^-8; the Pallas body rounds its scores and p at
other points).  At a long context the schedule also stays within the
card tests' limit (`decode_limit`), and a schedule that leaves out one
tile of each lane does not.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decode_schedule import decode_limit, decode_schedule
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


# (B, H, KVH, hd, Sk, window, qpos, active): each case places whole
# tiles (ops.DECODE_TILE slots) against the split over
# ops.DECODE_SPLITS blocks
SCHEDULE_CASES = {
    # lane 0 keeps 41 keys of 10 tiles: splits 2-7 hold no kept key
    "split_without_keys": (3, 9, 3, 64, 300, 0, [40, 299, 170],
                           [True, True, False]),
    # 35 tiles; lane 0's 101 keys lie in tiles 0-3, all in split 0
    "keys_in_one_split": (2, 4, 2, 16, 1100, 0, [100, 1099], None),
    # window 32 at qpos 95 keeps slots 64-95: every tile but tile 2 skipped
    "window_keeps_one_tile": (2, 6, 3, 64, 192, 32, [95, 191], None),
    # several tiles per warp, lanes 1 and 3 inactive
    "inactive_lanes": (4, 8, 2, 128, 520, 0, [519, 300, 7, 0],
                       [True, False, True, False]),
    "long_window": (2, 4, 1, 16, 2048, 700, [2047, 1500], None),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_kernel_schedule_matches_plain_and_pallas_body(case, dtype):
    b, h, kvh, hd, sk, window, qpos, active = SCHEDULE_CASES[case]
    inp = _mk(b, h, kvh, hd, sk, seed=sk + hd)
    inp["qpos"] = np.array(qpos, np.int32)
    act = np.ones(b, bool) if active is None else np.array(active)
    tdt, jdt, tol = ((torch.float32, jnp.float32, TOL) if dtype == "f32"
                     else (torch.bfloat16, jnp.bfloat16,
                           dict(atol=2e-2, rtol=0)))
    t = {n: torch.tensor(np.asarray(inp[n], np.float32)).to(tdt)
         for n in "qkv"}
    kpos, qp = torch.tensor(inp["kpos"]), torch.tensor(inp["qpos"])
    got, counts = decode_schedule(t["q"], t["k"], t["v"], kpos, qp,
                                  torch.tensor(act), window,
                                  with_split_counts=True)
    assert got.dtype == tdt
    plain = tref.flash_decode(t["q"], t["k"], t["v"], kpos, qp,
                              active=torch.tensor(act), window=window)
    pallas = jops.flash_decode(
        *(jnp.asarray(t[n].float().numpy(), jdt) for n in "qkv"),
        jnp.asarray(inp["kpos"]), jnp.asarray(inp["qpos"]),
        active=jnp.asarray(act), window=window, impl="interpret")
    got = got.float().numpy()
    np.testing.assert_allclose(got, plain.float().numpy(), err_msg="plain",
                               **tol)
    np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)),
                               err_msg="pallas", **tol)
    assert (got[~act] == 0).all(), "inactive lanes must be exact zeros"
    assert np.isfinite(got).all()
    held = (counts > 0).sum(1).numpy()
    tile = tops.DECODE_TILE
    want = {"split_without_keys": held[0] < tops.DECODE_SPLITS,
            "keys_in_one_split": held[0] == 1,
            "window_keeps_one_tile": int(counts[0].sum()) == window
            and qpos[0] // tile == (qpos[0] - window + 1) // tile,
            "inactive_lanes": bool((held[~act] == 0).all()),
            "long_window": bool((held > 1).all())}[case]
    assert want, (case, counts.tolist())


@pytest.mark.parametrize("hd", [64, 128])
def test_card_limit_holds_the_schedule_and_sees_a_tile_left_out(hd):
    """At 2,048 slots, where a typical output is ~0.015, the schedule's
    bf16 output lies within decode_limit of the plain version, and the
    same schedule with the keys of one 32-slot tile per lane left out
    (their kpos set to the sentinel) lies outside it."""
    b, kvh, g, sk = 4, 2, 3, 2048
    rng = np.random.default_rng(hd)
    n = rng.integers(sk // 2, sk + 1, b)
    kpos = torch.tensor(np.where(np.arange(sk)[None] < n[:, None],
                                 np.arange(sk)[None], SENTINEL),
                        dtype=torch.int32)
    qpos = torch.tensor(n - 1, dtype=torch.int32)
    q = torch.tensor(rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5
                     ).bfloat16()
    k, v = (torch.tensor(rng.uniform(-1, 1, (b, sk, kvh, hd))).bfloat16()
            for _ in range(2))
    want = tref.flash_decode(q, k, v, kpos, qpos)
    limit = decode_limit(want, tref.flash_decode(q, k, v.abs(), kpos, qpos))
    got = decode_schedule(q, k, v, kpos, qpos)
    assert ((got.float() - want.float()).abs() / limit).max() <= 1.0
    tile = tops.DECODE_TILE
    dropped = kpos.clone()
    dropped[:, 2 * tile:3 * tile] = SENTINEL
    bad = decode_schedule(q, k, v, dropped, qpos)
    assert ((bad.float() - want.float()).abs() / limit).max() > 1.0
