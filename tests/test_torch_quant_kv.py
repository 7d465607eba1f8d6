"""The port's int8 KV cache against the JAX package: `kv_quantize`,
the quantized cache trees and the int8 admission, and the plain
`paged_flash_decode_q` (the fused decode loop and the engine over an int8
arena are in tests/test_torch_dense_serving.py).

`kv_quantize` must equal the reference bit for bit, values and scales,
as the reference runs it: inside jitted programs (the decode scatter and
the admission program), where XLA turns ``amax / 127`` into ``amax *
float32(1/127)``.  Eager JAX divides, and differs in some scales; one
assertion records that.

The plain `paged_flash_decode_q` is held against
`repro.kernels.ops.paged_flash_decode_q` with impl="interpret" (the Pallas
body) and impl="ref" (the dequantizing gather oracle) in f32, to 2e-5
absolute and relative (the JAX package's own bar; only the summation
order differs), on page tables with pages shared between lanes, garbage
in the trash page and inactive lanes (exact zeros).

The card kernel's schedule over the int8 arena
(tests/decode_schedule.py `paged_q_schedule`: rows dequantized one by
one, p kept f32, the bf16 kernels' tiles, splits and sub-streams) is held
against both at the same limits, at hd 16/64/128, G 1-8 and MAXP up to
128.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from decode_schedule import decode_limit, paged_q_schedule
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.models import transformer as jtr
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttr

torch.set_num_threads(1)

SENTINEL = 2 ** 30
TOL = dict(atol=2e-5, rtol=2e-5)
_jit_kv_quantize = jax.jit(jquant.kv_quantize)


def _rows(seed=0, n=4000, hd=64):
    """Random rows, all-zero rows, and rows whose scaled values land on
    exact halves (amax 127 * 2^k, so the scale is a power of two)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, hd)).astype(np.float32)
    x[:7] = 0.0
    halves = rng.integers(-126, 126, (40, hd)) + 0.5
    halves[:, 0] = 127.0
    x[7:47] = halves * 2.0 ** rng.integers(-6, 3, (40, 1))
    return x


def test_kv_quantize_bit_exact_with_jitted_reference():
    x = _rows()
    jq, js = (np.asarray(a) for a in _jit_kv_quantize(jnp.asarray(x)))
    tq, ts = tquant.kv_quantize(torch.tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), jq) and np.array_equal(ts.numpy(), js)
    # the exact-half rows round half away from zero, as the reference does
    half = np.abs(x[7:47] / js[7:47, None]) % 1 == 0.5
    assert half.sum() > 1000
    # eager JAX divides by 127 and lands one ulp off in some scales: the
    # reason the port multiplies by float32(1/127)
    _, es = jquant.kv_quantize(jnp.asarray(x))
    assert (np.asarray(es) != js).sum() > 0
    deq = tquant.kv_dequantize(tq, ts).numpy()
    assert np.array_equal(deq, np.asarray(jquant.kv_dequantize(
        jnp.asarray(jq), jnp.asarray(js))))
    assert (np.abs(deq - x) <= ts.numpy()[:, None] / 2 * (1 + 1e-6)).all()


def test_kv_quantize_bf16_rows_and_zero_rows():
    x = torch.tensor(_rows(seed=1, n=600, hd=16)).bfloat16()
    jq, js = _jit_kv_quantize(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    tq, ts = tquant.kv_quantize(x)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert (tq[:7] == 0).all() and (ts[:7] > 0).all()


def _bucket_tree(seed, n_rep=2, s=12, kvh=3, hd=16):
    """A batch-1 bucket cache tree like a prefill writes, numpy leaves."""
    rng = np.random.default_rng(seed)
    kpos = np.where(np.arange(s) < 9, np.arange(s), SENTINEL).astype(
        np.int32)

    def leaf(lead):
        return {"k": rng.normal(0, 1, lead + (1, s, kvh, hd)),
                "v": rng.normal(0, 1, lead + (1, s, kvh, hd)),
                "kpos": np.broadcast_to(kpos, lead + (1, s)).copy()}

    return {"scan": {"b0": leaf((n_rep,))}, "tail": {"0": leaf(())},
            "pos": np.array([9], np.int32)}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _bf16_pair(tree):
    """The same bf16 bucket cache as a torch tree and a jnp tree."""
    tt = _tree(tree, lambda a: torch.tensor(a).bfloat16()
               if a.dtype == np.float64 else torch.tensor(a))
    jt = _tree(tt, lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
               if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))
    return tt, jt


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def test_quantize_kv_tree_matches_jitted_reference():
    tt, jt = _bf16_pair(_bucket_tree(0))
    got = ttr.quantize_kv_tree(tt)
    want = jax.jit(jtr.quantize_kv_tree)(jt)
    for blk in (("scan", "b0"), ("tail", "0")):
        g, w = got[blk[0]][blk[1]], want[blk[0]][blk[1]]
        assert set(g) == {"k", "v", "k_scale", "v_scale", "kpos"}
        for name in g:
            assert np.array_equal(_np(g[name]), np.asarray(w[name])), name
    assert ttr.cache_is_quantized(got) and not ttr.cache_is_quantized(tt)


def test_int8_admit_lane_cache_matches_jitted_reference():
    """The admission program: reset pages, quantize the bucket cache per
    row and scatter it into the lane's pages of an int8 arena.  Only rows
    whose kpos is not the sentinel are read by decode; the bucket's pad
    rows are compared too (both quantize the same input here)."""
    from repro.configs import get_config
    from repro_torch.configs import get_config as tget

    cfg = get_config("smollm-135m").reduced()
    ps, maxp, n_pages = 4, 5, 12
    tt, jt = _bf16_pair(_bucket_tree(3, n_rep=cfg.n_layers,
                                     kvh=cfg.n_kv_heads, hd=cfg.head_dim))
    jt.pop("pos")
    tt.pop("pos")
    jt["tail"] = tt["tail"] = {}
    pages = np.array([3, 7, 5], np.int32)
    pt_row = np.array([3, 7, 5, 0, 0], np.int32)
    reset = np.array([3, 7, 5, 2], np.int32)
    jm = jtr.make_model(cfg, remat=False)
    jbig = jm.init_paged_cache(2, n_pages, ps, maxp, kv_dtype="int8")
    want = jax.jit(jm.admit_lane_cache)(
        jbig, 1, jnp.asarray(pt_row), 9, jnp.asarray(reset),
        small=dict(jt, pos=jnp.asarray([9]), pt=jbig["pt"]),
        write_pages=jnp.asarray(pages))
    tm = ttr.make_model(tget("smollm-135m").reduced(), device="cpu")
    got = tm.admit_lane_cache(
        tm.init_paged_cache(2, n_pages, ps, maxp, kv_dtype="int8"), 1,
        pt_row, 9, reset, small=tt, write_pages=pages)
    for name, leaf in got["scan"]["b0"].items():
        want_leaf = np.asarray(want["scan"]["b0"][name])
        assert np.array_equal(_np(leaf), want_leaf), name
    for name in ("pos", "pt"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def _mk_paged_q(seed, b, h, kvh, hd, ps, maxp):
    """An int8 arena quantized by the reference rule, lanes sharing prefix
    pages (and so their scales), unused table entries on the trash page."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    q = (rng.normal(0, 1, (b, h, hd)) * hd ** -0.5).astype(np.float32)
    k8, ks = (np.array(a) for a in _jit_kv_quantize(
        jnp.asarray(rng.normal(0, 1, (n_pages, ps, kvh, hd)), jnp.float32)))
    v8, vs = (np.array(a) for a in _jit_kv_quantize(
        jnp.asarray(rng.normal(0, 1, (n_pages, ps, kvh, hd)), jnp.float32)))
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    qpos = rng.integers(ps, maxp * ps - 1, b).astype(np.int32)
    nxt = 1
    for lane in range(b):
        for j in range(int(qpos[lane]) // ps + 1):
            if lane and (j + 1) * ps <= min(qpos[0], qpos[lane]) and \
                    rng.random() < 0.7:
                pt[lane, j] = pt[0, j]  # shared prefix page
                continue
            pt[lane, j] = nxt
            kpos[nxt] = j * ps + np.arange(ps)  # rows past qpos: stale
            nxt += 1
    return dict(q=q, k=k8, v=v8, ks=ks, vs=vs, kpos=kpos, pt=pt, qpos=qpos)


_ORDER = ("q", "k", "v", "ks", "vs", "kpos", "pt", "qpos")


def _check_q(inp, active):
    got = tops.paged_flash_decode_q(
        *(torch.tensor(inp[n]) for n in _ORDER),
        active=torch.tensor(active)).numpy()
    for impl in ("interpret", "ref"):
        want = np.asarray(jops.paged_flash_decode_q(
            *(jnp.asarray(inp[n]) for n in _ORDER),
            active=jnp.asarray(active), impl=impl))
        np.testing.assert_allclose(got, want, err_msg=impl, **TOL)
    assert np.isfinite(got).all() and (got[~active] == 0).all()
    return got


@pytest.mark.parametrize("h,kvh,ps,maxp", [(4, 4, 8, 3), (8, 2, 16, 2),
                                           (9, 3, 8, 5), (6, 3, 4, 6)])
def test_paged_flash_decode_q_matches_jax(h, kvh, ps, maxp):
    inp = _mk_paged_q(h * 10 + ps, 4, h, kvh, 16, ps, maxp)
    assert (inp["pt"] == 0).any() or (inp["qpos"] // ps == maxp - 1).all()
    _check_q(inp, np.array([True, False, True, True]))


def test_paged_flash_decode_q_trash_garbage_and_sentinel_lane():
    """Garbage int8 values and scales in the trash page cannot reach a
    live lane while its kpos stay sentinel; a lane whose table names only
    the trash page gives exact zeros."""
    inp = _mk_paged_q(7, 3, 4, 2, 16, 8, 4)
    active = np.ones(3, bool)
    clean = _check_q(inp, active)
    inp["k"][0], inp["v"][0] = 127, -127
    inp["ks"][0] = inp["vs"][0] = 1e9
    dirty = _check_q(inp, active)
    assert np.array_equal(clean, dirty)
    inp["pt"][2] = 0
    assert (_check_q(inp, active)[2] == 0).all()


def test_paged_flash_decode_q_wrapper_checks():
    inp = _mk_paged_q(1, 2, 4, 2, 16, 4, 3)
    t = [torch.tensor(inp[n]) for n in _ORDER]
    before = dict(tops.launches)
    with pytest.raises(ValueError, match="k_scale"):
        tops.paged_flash_decode_q(t[0], t[1], t[2], t[3][:, :2], *t[4:])
    out = tops.paged_flash_decode_q(t[0].bfloat16(), *t[1:])
    assert out.dtype == torch.bfloat16  # the result comes back in q's dtype
    assert tops.launches == before  # the plain version is no launch


@pytest.mark.parametrize("b,h,kvh,hd,ps,maxp", [
    (4, 4, 4, 16, 8, 5),      # G = 1, MAXP below the split count
    (4, 9, 3, 64, 16, 12),    # the serve path's heads and pages
    (3, 16, 2, 128, 4, 9),    # G = 8, eight pages per tile
    (3, 10, 2, 64, 32, 8),    # G = 5, one page per tile
    (2, 6, 3, 16, 16, 128),   # 2,048 slots
    (2, 8, 2, 128, 16, 17),   # G = 4 at hd 128, MAXP no multiple of 8
])
def test_int8_kernel_schedule_matches_plain_and_pallas_body(b, h, kvh, hd,
                                                            ps, maxp):
    inp = _mk_paged_q(b + h + hd + maxp, b, h, kvh, hd, ps, maxp)
    active = np.ones(b, bool)
    active[1] = False
    t = {n: torch.tensor(inp[n]) for n in _ORDER}
    got, counts = paged_q_schedule(*(t[n] for n in _ORDER),
                                   active=torch.tensor(active),
                                   with_split_counts=True)
    assert got.dtype == torch.float32
    got = got.numpy()
    plain = tops.paged_flash_decode_q(*(t[n] for n in _ORDER),
                                      active=torch.tensor(active)).numpy()
    np.testing.assert_allclose(got, plain, err_msg="plain", **TOL)
    want = np.asarray(jops.paged_flash_decode_q(
        *(jnp.asarray(inp[n]) for n in _ORDER), active=jnp.asarray(active),
        impl="interpret"))
    np.testing.assert_allclose(got, want, err_msg="pallas", **TOL)
    assert np.isfinite(got).all() and (got[~active] == 0).all()
    # the bf16 query the card takes: the schedule rounds only its output
    qb = t["q"].bfloat16()
    got_b = paged_q_schedule(qb, *(t[n] for n in _ORDER[1:]),
                             active=torch.tensor(active))
    plain_b = tops.paged_flash_decode_q(qb, *(t[n] for n in _ORDER[1:]),
                                        active=torch.tensor(active))
    assert got_b.dtype == torch.bfloat16
    diff = (got_b.float() - plain_b.float()).abs()
    assert bool((diff <= decode_limit(plain_b)).all()), diff.max().item()
    # every kept key lies in exactly one split
    kept = (inp["kpos"][inp["pt"]].reshape(b, -1)
            <= inp["qpos"][:, None]).sum(1)
    assert counts.sum(1)[active].tolist() == kept[active].tolist()
