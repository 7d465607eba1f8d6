"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: each test skips without a CUDA device; run them on
a machine with one (and nvcc) with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the decode kernels' outputs agree within 1e-4 + 2^-7 |want|
+ 2^-8 W, W = sum p |v| / l (the plain version over |v|), a bound on
the two sides' different bf16 rounding of p (`decode_schedule
.decode_limit`); the int8 kernel keeps p in f32 on both sides, so its W
term is 0.  `kv_quantize` on the card equals the CPU bit for bit.
Inactive lanes are exact zeros on both.  The I-BERT integer kernels have
no tolerance: each equals its plain version bit for bit, on the card and
on the CPU.
"""
import numpy as np
import pytest
import torch

from decode_schedule import decode_limit
from ibert_rows import (beside_power_of_two, gelu_scale_beside,
                        layernorm_row_with_var, row_with_sum,
                        softmax_row_with_sum_in)
from repro_torch.core import quant
from repro_torch.kernels import ops, ref

SENTINEL = 2 ** 30

pytestmark = pytest.mark.cuda


def _assert_decode_close(out, want, w=None):
    """|out - want| within decode_limit (chip_smoke's limit): w is the
    plain version over |v|, or None where p stays f32."""
    diff = (out.float() - want.float()).abs()
    worst = (diff / decode_limit(want, w)).max().item()
    assert worst <= 1.0, (f"max_abs_err {diff.max().item():.3g}, worst "
                          f"{worst:.3f} of the limit")


def _paged_spread(q, k, v, kpos, pt, qpos, act):
    """W of the paged kernel's limit: sum p |v| / l, per output."""
    return ref.paged_flash_decode(q, k, v.abs(), kpos, pt, qpos, active=act)


def _dense_spread(q, k, v, kpos, qpos, act, window):
    """W of the dense kernel's limit."""
    return ref.flash_decode(q, k, v.abs(), kpos, qpos, active=act,
                            window=window)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b, kvh, g, hd, ps, maxp, dev):
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    qpos = rng.integers(0, maxp * ps, b).astype(np.int32)
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    nxt = 1
    for lane in range(b):
        for j in range(int(qpos[lane]) // ps + 1):
            if lane and (j + 1) * ps <= min(qpos[0], qpos[lane]):
                pt[lane, j] = pt[0, j]  # shared prefix page
                continue
            pt[lane, j] = nxt
            kpos[nxt] = j * ps + np.arange(ps)  # rows past qpos: stale
            nxt += 1
    active = rng.random(b) < 0.7
    active[0] = False
    q = torch.tensor(rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5)
    k = torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd)))
    v = torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd)))
    return (q.bfloat16().to(dev), k.bfloat16().to(dev), v.bfloat16().to(dev),
            torch.tensor(kpos, device=dev), torch.tensor(pt, device=dev),
            torch.tensor(qpos, device=dev), torch.tensor(active, device=dev))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g,ps,maxp", [(1, 16, 3), (2, 4, 9), (3, 16, 12),
                                       (8, 32, 5)])
def test_paged_flash_decode_kernel_matches_plain(dev, g, ps, maxp, hd):
    args = _inputs(g * 100 + hd, 6, 2, g, hd, ps, maxp, dev)
    n0 = ops.launches["paged_flash_decode"]
    out = ops.paged_flash_decode(*args[:6], active=args[6])
    torch.cuda.synchronize()
    assert ops.launches["paged_flash_decode"] == n0 + 1
    want = ref.paged_flash_decode(*args[:6], active=args[6])
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want, _paged_spread(*args))
    assert (out[~args[6]] == 0).all()


def test_kernel_wrapper_refuses_what_it_cannot_run(dev):
    q, k, v, kpos, pt, qpos, act = _inputs(1, 2, 1, 2, 64, 16, 2, dev)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_flash_decode(q, k, v, kpos, pt.long(), qpos, active=act)
    with pytest.raises(ValueError, match="bf16"):
        ops.paged_flash_decode(q.float(), k.float(), v.float(), kpos, pt,
                               qpos, active=act)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_flash_decode(q[..., :32].contiguous(),
                               k[..., :32].contiguous(),
                               v[..., :32].contiguous(), kpos, pt, qpos,
                               active=act)


def _dense_inputs(seed, b, kvh, g, hd, sk, dev):
    """A dense slot cache: lane i's slots hold positions 0..n_i-1, the
    rest never written (sentinel); qpos is the lane's last position."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, sk + 1, b)
    kpos = np.where(np.arange(sk)[None] < n[:, None], np.arange(sk)[None],
                    SENTINEL).astype(np.int32)
    active = rng.random(b) < 0.7
    active[0] = False
    q = torch.tensor(rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5)
    k = torch.tensor(rng.uniform(-1, 1, (b, sk, kvh, hd)))
    v = torch.tensor(rng.uniform(-1, 1, (b, sk, kvh, hd)))
    return (q.bfloat16().to(dev), k.bfloat16().to(dev), v.bfloat16().to(dev),
            torch.tensor(kpos, device=dev),
            torch.tensor((n - 1).astype(np.int32), device=dev),
            torch.tensor(active, device=dev))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g,sk,window", [(1, 33, 0), (3, 192, 0),
                                         (3, 192, 40), (8, 300, 0),
                                         (2, 2048, 100)])
def test_flash_decode_kernel_matches_plain(dev, g, sk, window, hd):
    *args, act = _dense_inputs(g * 1000 + sk + hd, 6, 2, g, hd, sk, dev)
    n0 = ops.launches["flash_decode"]
    out = ops.flash_decode(*args, active=act, window=window)
    torch.cuda.synchronize()
    assert ops.launches["flash_decode"] == n0 + 1
    want = ref.flash_decode(*args, active=act, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want, _dense_spread(*args, act, window))
    assert (out[~act] == 0).all()


# flash_decode at recurrentgemma-2b's decode heads, hd 256 with MQA at G =
# 10 (two head chunks of 5, each a cluster reading the same kv head), and
# other groups wider than 8 (9 -> 5 + 4, 16 -> 8 + 8), windows below Sk
@pytest.mark.parametrize("g,sk,window", [(10, 192, 2048), (10, 2048, 512),
                                         (10, 300, 40), (9, 65, 0),
                                         (16, 100, 30)])
def test_flash_decode_kernel_hd256_wide_groups(dev, g, sk, window):
    *args, act = _dense_inputs(g * 100 + sk, 8, 1, g, 256, sk, dev)
    n0 = ops.launches["flash_decode"]
    out = ops.flash_decode(*args, active=act, window=window)
    torch.cuda.synchronize()
    assert ops.launches["flash_decode"] == n0 + 1
    want = ref.flash_decode(*args, active=act, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want, _dense_spread(*args, act, window))
    assert (out[~act] == 0).all()


# kernels 1 and 3 at more shapes: G = 1-8 at every compiled head_dim,
# MAXP = 1, 7, 9, 17 and 128 (below, near and far above the 8 splits of a
# cluster), Sk = 1, 65 and 4096, and B = 64 (more clusters than SMs)
_MAXPS, _SKS = (1, 7, 9, 17, 128), (1, 65, 4096, 300, 1100)
SPLIT_CASES = [(64 if g in (3, 8) else 6, g, hd, i)
               for hd in (16, 64, 128) for g in range(1, 9)
               for i in [(g + hd) % 5]]


@pytest.mark.parametrize("b,g,hd,i", SPLIT_CASES)
def test_paged_flash_decode_kernel_more_shapes(dev, b, g, hd, i):
    maxp, ps = _MAXPS[i], (16, 4, 32, 16, 8)[i]
    args = _inputs(b * 7 + g * 100 + hd, b, 2, g, hd, ps, maxp, dev)
    out = ops.paged_flash_decode(*args[:6], active=args[6])
    torch.cuda.synchronize()
    want = ref.paged_flash_decode(*args[:6], active=args[6])
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want, _paged_spread(*args))
    assert (out[~args[6]] == 0).all()


@pytest.mark.parametrize("b,g,hd,i", SPLIT_CASES)
def test_flash_decode_kernel_more_shapes(dev, b, g, hd, i):
    sk, window = _SKS[i], (0, 0, 0, 48, 300)[i]
    *args, act = _dense_inputs(b * 7 + g * 1000 + hd, b, 2, g, hd, sk, dev)
    out = ops.flash_decode(*args, active=act, window=window)
    torch.cuda.synchronize()
    want = ref.flash_decode(*args, active=act, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want, _dense_spread(*args, act, window))
    assert (out[~act] == 0).all()


def _poison(x, where):
    """x with the rows `where` selects set to inf in the first half of
    the feature axis and NaN in the second: a read of any of them
    reaches the output as inf or NaN."""
    x = x.clone()
    hd = x.shape[-1]
    x[where, ..., : hd // 2] = float("inf")
    x[where, ..., hd // 2:] = float("nan")
    return x


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("hd,g", [(16, 8), (64, 3), (128, 4)])
def test_paged_decode_skip_reads_no_skipped_tile(dev, hd, g):
    """Pages that lie only in tiles with no kept key (the trash page 0,
    stale pages whose kpos are all past qpos, an inactive lane's pages)
    are never read: poisoned with inf and NaN, the output does not change
    by one bit."""
    tile = ops.DECODE_TILE
    b, kvh, ps, maxp = 5, 2, tile, 8  # one page per tile
    q, k, v, kpos, pt, qpos, act = _inputs(hd + g, b, kvh, g, hd, ps, maxp,
                                           dev)
    act[:] = True
    act[3] = False
    # lane 1 at qpos 69; its table past page 2 names fresh pages whose rows
    # hold positions past qpos (stale) rather than the trash page
    n0 = k.shape[0]
    k, v = (torch.cat([x, x[1:maxp + 1]]) for x in (k, v))
    kpos = torch.cat([kpos, torch.full((maxp, ps), SENTINEL, dtype=torch.int32,
                                       device=dev)])
    qpos[1] = 2 * tile + 5
    for j in range(int(qpos[1]) // ps + 1, maxp):
        pt[1, j] = n0 + j
        kpos[n0 + j] = j * ps + torch.arange(ps, dtype=torch.int32,
                                             device=dev)
    slot_page = pt.cpu().repeat_interleave(ps, 1)  # (B, slots)
    kp = kpos.cpu()[pt.cpu().long()].reshape(b, -1)
    keep = (kp <= qpos.cpu()[:, None]) & act.cpu()[:, None]
    walked = keep.reshape(b, -1, tile).any(-1).repeat_interleave(tile, 1)
    skipped = sorted(set(range(k.shape[0]))
                     - set(slot_page[walked].tolist()))
    assert 0 in skipped and n0 + maxp - 1 in skipped, skipped
    clean = ops.paged_flash_decode(q, k, v, kpos, pt, qpos, active=act)
    where = torch.tensor(skipped, device=dev)
    dirty = ops.paged_flash_decode(q, _poison(k, where), _poison(v, where),
                                   kpos, pt, qpos, active=act)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dirty), _bits(clean))
    want = ref.paged_flash_decode(q, k, v, kpos, pt, qpos, active=act)
    _assert_decode_close(clean, want,
                         _paged_spread(q, k, v, kpos, pt, qpos, act))
    assert (clean[~act] == 0).all()


@pytest.mark.parametrize("hd,g,window", [(16, 8, 0), (64, 3, 40),
                                         (128, 4, 100)])
def test_flash_decode_skip_reads_no_skipped_tile(dev, hd, g, window):
    """Slot tiles wholly past qpos or wholly outside the window are never
    read: poisoned with inf and NaN, the output does not change by one
    bit."""
    b, kvh, sk = 6, 2, 300
    tile = ops.DECODE_TILE
    q, k, v, _, _, act = _dense_inputs(hd + window, b, kvh, g, hd, sk, dev)
    act[:] = True
    kpos = torch.arange(sk, dtype=torch.int32).repeat(b, 1)
    qpos = torch.tensor([299, 150, 40, 200, 5, 250], dtype=torch.int32)
    keep = kpos <= qpos[:, None]
    if window:
        keep &= qpos[:, None] - kpos < window
    n_tiles = -(-sk // tile)
    keep = torch.nn.functional.pad(keep, (0, n_tiles * tile - sk))
    skipped = ~keep.reshape(b, n_tiles, tile).any(-1)
    rows = skipped.repeat_interleave(tile, 1)[:, :sk].to(dev)  # (B, Sk)
    assert bool(skipped[:, :-1].any())
    kpos, qpos = kpos.to(dev), qpos.to(dev)
    clean = ops.flash_decode(q, k, v, kpos, qpos, active=act, window=window)
    dirty = ops.flash_decode(q, _poison(k, rows), _poison(v, rows), kpos,
                             qpos, active=act, window=window)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dirty), _bits(clean))
    want = ref.flash_decode(q, k, v, kpos, qpos, active=act, window=window)
    _assert_decode_close(clean, want,
                         _dense_spread(q, k, v, kpos, qpos, act, window))


def _quantized(args):
    """The paged inputs with k/v quantized into an int8 arena on the card."""
    q, k, v, *rest = args
    k8, ks = quant.kv_quantize(k)
    v8, vs = quant.kv_quantize(v)
    return (q, k8, v8, ks, vs, *rest)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g,ps,maxp", [(1, 16, 3), (2, 4, 9), (3, 16, 12),
                                       (3, 16, 128), (8, 32, 5)])
def test_paged_flash_decode_q_kernel_matches_plain(dev, g, ps, maxp, hd):
    *args, act = _quantized(_inputs(g * 100 + hd + maxp, 6, 2, g, hd, ps,
                                    maxp, dev))
    n0 = ops.launches["paged_flash_decode_q"]
    out = ops.paged_flash_decode_q(*args, active=act)
    torch.cuda.synchronize()
    assert ops.launches["paged_flash_decode_q"] == n0 + 1
    want = ref.paged_flash_decode_q(*args, active=act)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    _assert_decode_close(out, want)
    assert (out[~act] == 0).all()


@pytest.mark.parametrize("hd,g", [(16, 8), (64, 3), (128, 4)])
def test_paged_decode_q_skip_reads_no_skipped_tile(dev, hd, g):
    """The int8 twin of the test above: rows of tiles with no kept key,
    and rows that no active lane counts (stale, never written, an
    inactive lane's), hold garbage int8 values and NaN / inf scales; the
    kernel reads none of them, so the output does not change by one
    bit."""
    tile = ops.DECODE_TILE
    b, kvh, ps, maxp = 5, 2, tile, 8  # one page per tile
    q, k, v, kpos, pt, qpos, act = _inputs(hd * 3 + g, b, kvh, g, hd, ps,
                                           maxp, dev)
    act[:] = True
    act[3] = False
    n0 = k.shape[0]
    k, v = (torch.cat([x, x[1:maxp + 1]]) for x in (k, v))
    kpos = torch.cat([kpos, torch.full((maxp, ps), SENTINEL, dtype=torch.int32,
                                       device=dev)])
    qpos[1] = 2 * tile + 5
    for j in range(int(qpos[1]) // ps + 1, maxp):  # stale pages, as above
        pt[1, j] = n0 + j
        kpos[n0 + j] = j * ps + torch.arange(ps, dtype=torch.int32,
                                             device=dev)
    q8, k8, v8, ks, vs, *_ = _quantized((q, k, v))
    # (page, row) pairs some active lane counts; every other row is junk
    counted = torch.zeros(kpos.shape, dtype=torch.bool)
    kp, ptc = kpos.cpu(), pt.cpu().long()
    for lane in range(b):
        if act[lane]:
            counted[ptc[lane]] |= kp[ptc[lane]] <= int(qpos[lane])
    junk = (~counted).to(dev)
    assert bool(junk[0].all()) and bool(junk[n0 + maxp - 1].all())
    assert 0 < int(junk[1:n0].sum()) < junk[1:n0].numel()  # in kept tiles
    args = (kpos, pt, qpos)
    clean = ops.paged_flash_decode_q(q8, k8, v8, ks, vs, *args, active=act)
    k8d, v8d, ksd, vsd = (x.clone() for x in (k8, v8, ks, vs))
    k8d[junk], v8d[junk] = 127, -128
    ksd[junk], vsd[junk] = float("nan"), float("inf")
    dirty = ops.paged_flash_decode_q(q8, k8d, v8d, ksd, vsd, *args,
                                     active=act)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dirty), _bits(clean))
    want = ref.paged_flash_decode_q(q8, k8, v8, ks, vs, *args, active=act)
    _assert_decode_close(clean, want)
    assert (clean[~act] == 0).all()


def test_kv_quantize_card_equals_cpu(dev):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (4096, 64)), dtype=torch.float32)
    x[:3] = 0
    for t in (x, x.bfloat16()):
        q, s = quant.kv_quantize(t.to(dev))
        q_cpu, s_cpu = quant.kv_quantize(t)
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)


def test_new_decode_wrappers_refuse_what_they_cannot_run(dev):
    *args, act = _dense_inputs(2, 2, 1, 2, 64, 40, dev)
    q, k, v, kpos, qpos = args
    with pytest.raises(ValueError, match="int32"):
        ops.flash_decode(q, k, v, kpos.long(), qpos, active=act)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, kpos, qpos, active=act)
    pq = _inputs(1, 2, 1, 2, 64, 16, 2, dev)
    with pytest.raises(ValueError, match="int8"):
        ops.paged_flash_decode_q(pq[0], pq[1], pq[2],
                                 *_quantized(pq)[3:7], pq[5], active=pq[6])
    with pytest.raises(ValueError, match="float32"):
        qd = _quantized(pq)
        ops.paged_flash_decode_q(*qd[:3], qd[3].bfloat16(), *qd[4:8],
                                 active=qd[8])


# ---------------------------------------------------------------------------
# The I-BERT integer kernels: bit for bit against the plain versions, on
# the card and on the CPU, at ragged shapes (no tile multiples; rows of 1
# and of 513).
# ---------------------------------------------------------------------------

from repro_torch.core import ibert_ops as io  # noqa: E402

MIN_SCALE = float(np.float32(np.float32(0.5) / np.float32(2047)))


def _same_everywhere(out, want_card, want_cpu):
    torch.cuda.synchronize()
    assert out.dtype == want_card.dtype and out.shape == want_card.shape
    assert torch.equal(out, want_card)
    assert torch.equal(out.cpu(), want_cpu)


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (33, 65, 77), (128, 768, 768),
                                   (130, 770, 3072), (7, 1, 1000),
                                   (128, 3072, 768)])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, requant, with_bias):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8)
    bias = (torch.tensor(rng.integers(-5000, 5000, (n,)), dtype=torch.int32)
            if with_bias else None)
    sa, sb = torch.tensor(0.013), torch.tensor(0.021)
    so = torch.tensor(0.9) if requant else None
    n0 = ops.launches["int8_matmul"]
    out = ops.int8_matmul(a.to(dev), b.to(dev), sa, sb, s_out=so,
                          bias=None if bias is None else bias.to(dev))
    assert ops.launches["int8_matmul"] == n0 + 1
    want = ref.int8_matmul(a.to(dev), b.to(dev), sa, sb, s_out=so,
                           bias=None if bias is None else bias.to(dev))
    _same_everywhere(out, want, ref.int8_matmul(a, b, sa, sb, s_out=so,
                                                bias=bias))


def _colmajor(b):
    """(K, N) with the same values, stored column-major."""
    return b.t().contiguous().t()


# the kernel reads b K-major: a column-major b goes in as it is, a
# row-major one through one copy; every K below 16 bytes' multiple takes
# the narrow load path, and K = 770 and 3072 split each tile's K steps
# over a cluster (ops.int8_matmul_split)
@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (33, 65, 77), (7, 1, 1000),
                                   (130, 770, 3072), (128, 768, 768),
                                   (128, 3072, 768), (100, 770, 200),
                                   (64, 3072, 96)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_kernel_column_major_b(dev, m, k, n, requant):
    rng = np.random.default_rng(m * 5 + k * 11 + n)
    a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8)
    bias = torch.tensor(rng.integers(-5000, 5000, (n,)), dtype=torch.int32)
    sa, sb = torch.tensor(0.013), torch.tensor(0.021)
    so = torch.tensor(0.9) if requant else None
    ad, bd, biasd = a.to(dev), _colmajor(b).to(dev), bias.to(dev)
    assert bd.t().is_contiguous()
    n0 = ops.launches["int8_matmul"]
    out = ops.int8_matmul(ad, bd, sa, sb, s_out=so, bias=biasd)
    assert ops.launches["int8_matmul"] == n0 + 1
    row = ops.int8_matmul(ad, b.to(dev), sa, sb, s_out=so, bias=biasd)
    torch.cuda.synchronize()
    assert torch.equal(out, row)
    _same_everywhere(out, ref.int8_matmul(ad, bd, sa, sb, s_out=so,
                                          bias=biasd),
                     ref.int8_matmul(a, b, sa, sb, s_out=so, bias=bias))


@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 63, 64, 65, 100, 127, 128])
def test_int8_matmul_kernel_every_row_count(dev, m):
    """M = 1..128 at the encoder's w2 shape (K = 3072: 8-way split-K)."""
    rng = np.random.default_rng(m)
    a = torch.tensor(rng.integers(-127, 128, (m, 3072)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (3072, 768)), dtype=torch.int8)
    bias = torch.tensor(rng.integers(-20000, 20000, (768,)),
                        dtype=torch.int32)
    sa, sb, so = torch.tensor(0.02), torch.tensor(0.004), torch.tensor(0.3)
    for s_out in (so, None):
        out = ops.int8_matmul(a.to(dev), _colmajor(b).to(dev), sa, sb,
                              s_out=s_out, bias=bias.to(dev))
        _same_everywhere(out, ref.int8_matmul(a.to(dev), b.to(dev), sa, sb,
                                              s_out=s_out, bias=bias.to(dev)),
                         ref.int8_matmul(a, b, sa, sb, s_out=s_out,
                                         bias=bias))


def test_int8_matmul_encoder_path_takes_no_copy(dev):
    """The encoder's weights are column-major on the card, and a call with
    one allocates nothing but its output; a row-major b costs one more
    allocation (its transposing copy)."""
    from repro_torch.models import ibert as ib

    lin = {"w": torch.randn(768, 3072, device=dev),
           "b": torch.zeros(3072, device=dev)}
    w = ib._q_lin(lin, torch.tensor(0.1))["w"]
    assert w.device.type == "cuda" and w.t().is_contiguous()
    a = torch.ones((128, 768), dtype=torch.int8, device=dev)
    ops.int8_matmul(a, w, 0.1, 0.1)  # built and bound
    torch.cuda.synchronize()

    def allocations(b):
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        ops.int8_matmul(a, b, 0.1, 0.1)
        return torch.cuda.memory_stats()["allocation.all.allocated"] - before

    assert allocations(w) == 1
    assert allocations(w.contiguous()) == 2


# recurrentgemma-2b's W8A8 tail MLPs: K 2560 -> N 7680 (wi, wg) and 7680 ->
# 2560 (wo), at a decode step's 8 lanes and a 128-token prefill bucket
@pytest.mark.parametrize("m,k,n", [(8, 2560, 7680), (8, 7680, 2560),
                                   (128, 2560, 7680), (128, 7680, 2560)])
def test_int8_matmul_kernel_decoder_shapes(dev, m, k, n):
    from repro_torch.models.quantized import quantize_leaf

    rng = np.random.default_rng(m + k)
    a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8,
                     device=dev)
    q = quantize_leaf(torch.tensor(rng.normal(0, 0.02, (k, n)),
                                   dtype=torch.bfloat16, device=dev))["q"]
    assert q.t().is_contiguous()
    out = ops.int8_matmul(a, q, 1.0, 1.0)
    assert torch.equal(out, ref.int8_matmul(a, q, 1.0, 1.0))
    assert torch.equal(out.cpu(), ref.int8_matmul(a.cpu(), q.cpu(), 1.0,
                                                  1.0))


def test_qdense_card_equals_cpu(dev):
    """W8A8's activation quantization, scales and output: the card's
    bits are the CPU's (every division a tensor / tensor one)."""
    from repro_torch.models.quantized import qdense, quantize_leaf

    rng = np.random.default_rng(5)
    w = quantize_leaf(torch.tensor(rng.normal(0, 0.02, (2560, 7680)),
                                   dtype=torch.bfloat16, device=dev))
    x = torch.tensor(rng.normal(0, 1, (8, 1, 2560)), dtype=torch.bfloat16,
                     device=dev)
    got = qdense(x, w)
    want = qdense(x.cpu(), {k: v.cpu() for k, v in w.items()})
    assert torch.equal(got.cpu(), want)


def _on_card(t, dev, offset):
    """t on the card, contiguous; at offset 1 a view one element into a
    larger buffer, so its base is not 16-byte aligned."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


def _softmax_same(q, scale, dev, offset=0):
    qd = _on_card(q, dev, offset)
    n0 = ops.launches["i_softmax"]
    out = ops.i_softmax(qd, scale)
    assert ops.launches["i_softmax"] == n0 + 1
    _same_everywhere(out, ref.i_softmax_rows(qd, scale),
                     ref.i_softmax_rows(q, scale))


# cols 128 and 512 (the vector path, a row whole in registers: the
# encoder's and ibert-base's max_seq_len), 513 and 4096 (chunks of 512),
# 1, 5 and 127 (the scalar path); offset 1: an unaligned base, the scalar
# path at any cols
@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 513), (1536, 128),
                                       (5, 1), (1, 513), (6144, 512),
                                       (2, 4096), (4, 127), (2, 5)])
@pytest.mark.parametrize("scale", [0.004, 0.02, MIN_SCALE])
@pytest.mark.parametrize("offset", [0, 1])
def test_i_softmax_kernel_matches_plain(dev, rows, cols, scale, offset):
    rng = np.random.default_rng(rows + cols)
    q = torch.tensor(rng.integers(-2047, 2048, (rows, cols)),
                     dtype=torch.int32)
    q[0, : cols // 2] = 0  # an equal run: at MIN_SCALE the sum wraps
    _softmax_same(q, scale, dev, offset)


# the CPU tests' edge rows: z past 31 under the clamp, an int32 sum that
# wraps, and sums at and beside a power of two (ceil(log2(q_sum + 1)))
@pytest.mark.parametrize("case", ["clamped", "wraps", 2 ** 15 - 1, 2 ** 15,
                                  2 ** 17 - 1, 2 ** 17, 2 ** 17 + 1])
def test_i_softmax_kernel_edge_rows(dev, case):
    if case == "clamped":
        rng = np.random.default_rng(3)
        q = torch.tensor(rng.integers(-io.ACT_QMAX, io.ACT_QMAX + 1,
                                      (16, 50)), dtype=torch.int32)
        scale = 0.02
    elif case == "wraps":
        rng = np.random.default_rng(4)
        q = torch.tensor(rng.integers(-300, 300, (6, 77)), dtype=torch.int32)
        q[0], q[1], scale = 0, -5, MIN_SCALE
        e, _ = io.i_exp(torch.zeros(1, dtype=torch.int32), MIN_SCALE)
        assert 77 * int(e) > 2 ** 31
    else:
        row, scale = row_with_sum(case, 16)
        q, scale = torch.tensor(row), float(scale)
        assert io.i_exp(q, scale)[0].sum().item() == case
    _softmax_same(q, scale, dev)


# H: 1 and 513 (the scalar path), 768 (ibert-base, whole in registers),
# 4096 and 8192 (chunks of 1024); offset 1: an unaligned base
@pytest.mark.parametrize("rows,h", [(r, h) for r in (1, 5, 128, 384)
                                    for h in (1, 513, 768, 4096, 8192)]
                         + [(3, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_i_layernorm_kernel_matches_plain(dev, rows, h, offset):
    rng = np.random.default_rng(rows * h)
    r = (rng.integers(-127, 128, (rows, h))
         + rng.integers(-127, 128, (rows, h)))
    r[0] -= 120  # a negative mean
    if rows > 3:  # far outside the residual range: var << 14 wraps
        r[1] = np.where(np.arange(h) % 2, -470, 470)  # to < 0: 20 steps
        r[2] = rng.integers(-2 ** 12, 2 ** 12, h)
        r[3] = rng.integers(-2 ** 20, 2 ** 20, h)  # the var sum wraps too
    q = torch.tensor(r, dtype=torch.int32)
    prep = io.layernorm_prepare(
        torch.tensor(rng.uniform(-1.5, 1.5, h), dtype=torch.float32),
        torch.tensor(rng.normal(0, 0.3, h), dtype=torch.float32))
    prep_dev = prep._replace(q_gamma=prep.q_gamma.to(dev),
                             q_beta=prep.q_beta.to(dev))
    qd = _on_card(q, dev, offset)
    n0 = ops.launches["i_layernorm"]
    out, s_out = ops.i_layernorm(qd, prep_dev)
    assert ops.launches["i_layernorm"] == n0 + 1
    assert s_out is prep.s_out
    _same_everywhere(out, ref.i_layernorm_rows(qd, prep_dev.q_gamma,
                                               prep_dev.q_beta),
                     ref.i_layernorm_rows(q, prep.q_gamma, prep.q_beta))


# n = 1, 3 and 4099: a ragged last vector; offset 1: the scalar path
@pytest.mark.parametrize("shape", [(1, 1), (3, 513), (128, 3072), (2, 5, 7),
                                   (3,), (4099,)])
@pytest.mark.parametrize("scale", [0.003, MIN_SCALE, 1e-6, 0.3])
@pytest.mark.parametrize("offset", [0, 1])
def test_i_gelu_kernel_matches_plain(dev, shape, scale, offset):
    rng = np.random.default_rng(sum(shape))
    q = torch.tensor(rng.integers(-2047, 2048, shape), dtype=torch.int32)
    qd = _on_card(q, dev, offset)
    n0 = ops.launches["i_gelu"]
    out = ops.i_gelu(qd, scale)
    assert ops.launches["i_gelu"] == n0 + 1
    _same_everywhere(out, ref.i_gelu_elem(qd, scale),
                     ref.i_gelu_elem(q, scale))


# ceil(log2(x)) at and beside a power of two: the card's logf and the
# CPU's log may round apart there, and the ceiling then flips.  x is
# float32(v) + 1 for v the i-exp sum (i_softmax's shift), var << 14
# (i_layernorm's Newton start) or 2 / |s_erf| (i_gelu's shift g); each
# case seeds x = 2^k and the nearest x the input reaches on either side.
@pytest.mark.parametrize("k", range(1, 32))
def test_i_softmax_kernel_sums_beside_powers_of_two(dev, k):
    sides = [s for s in (-1, 0, 1) if beside_power_of_two(k, s)]
    assert sides and (k in (1, 31) or len(sides) == 3)
    for side in sides:
        row, scale = softmax_row_with_sum_in(*beside_power_of_two(k, side))
        q = torch.tensor(row)
        assert beside_power_of_two(k, side)[0] <= io.i_exp(
            q, float(scale))[0].sum().item()
        _softmax_same(q, float(scale), dev)


# var = 2^m - 1, 2^m, 2^m + 1: x = 2^(m + 14) exactly for m = 10 .. 16,
# x = 2 at var = 0 and where var << 14 wraps (m = 17)
@pytest.mark.parametrize("m", range(0, 18))
def test_i_layernorm_kernel_variance_beside_powers_of_two(dev, m):
    q = torch.tensor(np.concatenate([layernorm_row_with_var(2 ** m + off)
                                     for off in (-1, 0, 1)]))
    rng = np.random.default_rng(m)
    prep = io.layernorm_prepare(
        torch.tensor(rng.uniform(-1.5, 1.5, 8), dtype=torch.float32),
        torch.tensor(rng.normal(0, 0.3, 8), dtype=torch.float32))
    prep_dev = prep._replace(q_gamma=prep.q_gamma.to(dev),
                             q_beta=prep.q_beta.to(dev))
    out, _ = ops.i_layernorm(q.to(dev), prep_dev)
    _same_everywhere(out, ref.i_layernorm_rows(q.to(dev), prep_dev.q_gamma,
                                               prep_dev.q_beta),
                     ref.i_layernorm_rows(q, prep.q_gamma, prep.q_beta))


# g = ceil(log2(x)) - 19 clamped at 0: from k = 19 on a flip moves g
@pytest.mark.parametrize("k", range(19, 41))
def test_i_gelu_kernel_scale_beside_powers_of_two(dev, k):
    rng = np.random.default_rng(k)
    q = torch.tensor(rng.integers(-2047, 2048, (4, 257)), dtype=torch.int32)
    for side in (-1, 0, 1):
        try:
            scale = gelu_scale_beside(k, side)
        except AssertionError:  # no float32 scale lands on 2^k itself
            assert side == 0
            continue
        out = ops.i_gelu(q.to(dev), scale)
        _same_everywhere(out, ref.i_gelu_elem(q.to(dev), scale),
                         ref.i_gelu_elem(q, scale))


def test_ibert_wrappers_refuse_what_they_cannot_run(dev):
    a = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    b = torch.zeros((8, 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        ops.int8_matmul(a.int(), b, 0.1, 0.1)
    with pytest.raises(ValueError, match="int32"):
        ops.int8_matmul(a, b, 0.1, 0.1,
                        bias=torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):  # neither layout
        ops.int8_matmul(a, torch.zeros((8, 8), dtype=torch.int8,
                                       device=dev)[:, :4], 0.1, 0.1)
    with pytest.raises(ValueError, match=r"\(M, K\) @ \(K, N\)"):
        ops.int8_matmul(a, a, 0.1, 0.1)
    q = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        ops.i_softmax(q.long(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.i_gelu(q.t(), 0.1)
    prep = io.LNParams(torch.ones(8, dtype=torch.int32), torch.tensor(1.0),
                       torch.zeros(8, dtype=torch.int32), torch.tensor(1.0))
    with pytest.raises(ValueError, match="cpu"):
        ops.i_layernorm(q, prep)  # gamma/beta left on the CPU


# ---------------------------------------------------------------------------
# flash_attention: the prefill kernel against its plain version, at
# chip_smoke.py's shapes (smollm-135m and phi3-medium-14b heads at S=4096,
# in bf16 and in f32, a ragged non-causal f32 case) and at small ragged
# shapes for every compiled head_dim; bf16 runs on the tensor-core
# kernel, f32 on the FMA kernel.  Limits, as |out - want| <= atol +
# rtol * |want|: 2e-5 in f32; in bf16 4e-3 plus 2^-7 of |want| (two bf16
# ulps), well under a typical output (~0.03 at S=4096), which a key tile
# left out or counted twice moves by more.
# ---------------------------------------------------------------------------

FA_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (4e-3, 2 ** -7)}


def _fa_inputs(b, s, h, kvh, hd, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(0, 1, (b, s, n, hd)),
                         dtype=torch.float32).to(dtype).to(dev)
            for n in (h, kvh, kvh)]


@pytest.mark.parametrize("b,s,h,kvh,hd,dtype,causal", [
    (2, 4096, 9, 3, 64, torch.bfloat16, True),     # smollm-135m
    (1, 4096, 40, 10, 128, torch.bfloat16, True),  # phi3-medium-14b
    (1, 4096, 9, 3, 64, torch.float32, True),
    (1, 4096, 40, 10, 128, torch.float32, True),
    (1, 1100, 9, 3, 64, torch.float32, False),     # ragged, f32
    (2, 1100, 4, 2, 16, torch.bfloat16, True),
    (2, 77, 4, 2, 16, torch.float32, False),
    (1, 300, 8, 2, 32, torch.bfloat16, False),
    (3, 130, 4, 1, 32, torch.float32, True),
    (1, 1, 2, 1, 128, torch.float32, True),
    (2, 65, 6, 3, 128, torch.float32, False),
    # the tensor-core kernel at every head_dim, causal and not, at S no
    # multiple of its 128-row query or 128-key tiles, G = 1 and G = 8
    (1, 1, 4, 4, 16, torch.bfloat16, True),
    (1, 4097, 8, 1, 16, torch.bfloat16, False),
    (2, 63, 8, 1, 32, torch.bfloat16, False),
    (2, 127, 4, 2, 32, torch.bfloat16, True),
    (1, 127, 4, 4, 64, torch.bfloat16, True),
    (1, 1100, 8, 1, 64, torch.bfloat16, False),
    (1, 1, 8, 1, 64, torch.bfloat16, False),
    (2, 129, 16, 2, 128, torch.bfloat16, False),
    (1, 4097, 4, 4, 128, torch.bfloat16, True),
    (1, 63, 8, 1, 128, torch.bfloat16, True),
])
def test_flash_attention_kernel_matches_plain(dev, b, s, h, kvh, hd, dtype,
                                              causal):
    q, k, v = _fa_inputs(b, s, h, kvh, hd, dtype, dev, seed=s + hd)
    n0 = ops.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == n0 + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == want.shape
    atol, rtol = FA_TOL[dtype]
    err = (out.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), (
        err.max().item())


@pytest.mark.parametrize("hd,causal", [(64, True), (128, False)])
def test_flash_attention_reads_no_row_past_s(dev, hd, causal):
    """q, k, v are B=1 leading-row views of buffers whose rows past S hold
    inf.  The kernel must read none of them: a row past S that reached a
    product would give inf or NaN (0 x inf) where the plain version,
    which sees only the view, is finite."""
    b, s, h, kvh, pad = 1, 1100, 8, 2, 100
    bufs = _fa_inputs(b, s + pad, h, kvh, hd, torch.bfloat16, dev, seed=7)
    for x in bufs:
        x[:, s:] = float("inf")
    q, k, v = (x[:, :s] for x in bufs)
    assert all(x.is_contiguous() for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(want).all()) and bool(torch.isfinite(out).all())
    atol, rtol = FA_TOL[torch.bfloat16]
    err = (out.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), (
        err.max().item())


def test_flash_attention_wrapper_refuses_what_it_cannot_run(dev):
    q, k, v = _fa_inputs(1, 64, 4, 2, 64, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="bf16"):
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="bf16 or float32"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    q48, k48, v48 = _fa_inputs(1, 64, 4, 2, 48, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q48, k48, v48)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q.float().requires_grad_(True), k.float(),
                            v.float())


# ---------------------------------------------------------------------------
# speculative decoding's verify pass: kernels 1 and 2 with the T queries
# of a block folded into B*T lanes, and the spec engine against the plain
# engine on a fitted pair
# ---------------------------------------------------------------------------


def _verify_inputs(seed, b, t, kvh, g, hd, ps, maxp, dev):
    """The verify pass's folded inputs: lane i's block sits at positions
    pos_i .. pos_i + t - 1, all written (the verify scatter runs before
    the kernel), later rows never written; the folded lanes repeat their
    lane's table row t times, qpos = pos_i + j, and lanes 5 and 7 (all t
    of their folded lanes) are inactive."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    pos = rng.integers(ps, maxp * ps - t, b)
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    nxt = 1
    for lane in range(b):
        end = int(pos[lane]) + t  # one past the block's last position
        for j in range(-(-end // ps)):
            pt[lane, j] = nxt
            kpos[nxt] = np.where(j * ps + np.arange(ps) < end,
                                 j * ps + np.arange(ps), SENTINEL)
            nxt += 1
    active = np.ones((b,), bool)
    active[[5, 7]] = False
    q = torch.tensor(rng.normal(0, 1, (b * t, kvh * g, hd)) * hd ** -0.5)
    k = torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd)))
    v = torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd)))
    pt_t = torch.tensor(pt, device=dev).repeat_interleave(t, dim=0)
    qpos = torch.tensor((pos[:, None] + np.arange(t)).reshape(-1),
                        dtype=torch.int32, device=dev)
    return (q.bfloat16().to(dev), k.bfloat16().to(dev), v.bfloat16().to(dev),
            torch.tensor(kpos, device=dev), pt_t.contiguous(), qpos,
            torch.tensor(active, device=dev).repeat_interleave(t))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kvh,g,hd,ps,maxp", [(2, 2, 16, 4, 16),
                                              (3, 3, 64, 16, 12)])
def test_decode_kernels_at_verify_shape(dev, kv_dtype, kvh, g, hd, ps,
                                        maxp):
    """B=8, T=5: 40 folded lanes against their plain versions."""
    args = _verify_inputs(hd + maxp, 8, 5, kvh, g, hd, ps, maxp, dev)
    act = args[6]
    name = ("paged_flash_decode" if kv_dtype == "bf16"
            else "paged_flash_decode_q")
    n0 = ops.launches[name]
    if kv_dtype == "bf16":
        out = ops.paged_flash_decode(*args[:6], active=act)
        want = ref.paged_flash_decode(*args[:6], active=act)
        w = _paged_spread(*args)
    else:
        *qargs, _ = _quantized(args)
        out = ops.paged_flash_decode_q(*qargs, active=act)
        want = ref.paged_flash_decode_q(*qargs, active=act)
        w = None
    torch.cuda.synchronize()
    assert ops.launches[name] == n0 + 1 and out.shape == (40, kvh * g, hd)
    _assert_decode_close(out, want, w)
    assert (out[~act] == 0).all() and bool(act.sum() == 30)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_engine_matches_plain_engine_on_card(dev, kv_dtype):
    """The port's own fitted reduced pair on the card (a 1-layer draft
    that disagrees on every value = 0 mod 3): every request's stream
    from the speculative engine equals the plain paged engine's, and the
    verify pass launched the route's kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.synthetic import affine_prompts, fit_affine_lm
    from repro_torch.models.transformer import make_model
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    cfg = get_config("smollm-135m").reduced()
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1)
    model, draft = make_model(cfg, device=dev), make_model(dcfg, device=dev)
    params = fit_affine_lm(model, steps=300)
    dparams = fit_affine_lm(draft, steps=300, disagree_every=3)
    rng = np.random.default_rng(0)
    prompts = affine_prompts(rng, 12, cfg.vocab_size, (4, 30))
    budgets = [int(rng.integers(8, 24)) for _ in prompts]

    def serve(**kw):
        eng = ContinuousBatchingEngine(model, params, max_batch=8,
                                       buckets=(16, 32), deadline_s=0.0,
                                       kv_dtype=kv_dtype, **kw)
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=b))
        return [r.tokens_out for r in eng.run()], eng.stats

    plain, _ = serve()
    spec, stats = serve(spec_config=dict(draft_model=draft,
                                         draft_params=dparams, spec_k=4))
    assert spec == plain
    assert stats["spec_dispatches"] > 0 and stats["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# row_norm: the port-only rmsnorm / layernorm kernel against its plain
# version, at the widths of the served families (64: reduced; 576, 896,
# 1536, 2048, 2560, 4096, 5120, 7168: smollm-135m, internvl2-1b,
# musicgen-medium, moonshot-v1-16b-a3b and xlstm-1.3b, recurrentgemma-2b,
# minitron-8b, llama4-maverick-400b-a17b, deepseek-coder-33b), at widths
# that fill no whole 16-byte vector (7, 100: the kernel's scalar loads),
# past what a row's registers hold (20000, and 10001 unaligned: the row
# walked in chunks) and the row counts of a lane, a decode step, a verify
# pass and a long prompt.  Limits: a bf16 output within one bf16 ulp of the plain one, an
# f32 one within 1e-6 of itself; layernorm adds 1e-6 of the row's largest
# |output| (x - mu cancels near the mean).  And bit for bit: the kernel
# equals its order of sums in torch (`ref.row_norm_schedule`), and a
# row's output does not depend on the row count of its launch.
# ---------------------------------------------------------------------------

ROW_NORM_ROWS = (1, 8, 40, 4096)


def _row_norm_close(out, want, layer):
    o, w = out.float(), want.float()
    diff = (o - w).abs()
    if out.dtype == torch.bfloat16:
        limit = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    else:
        limit = 1e-6 * w.abs()
    if layer:
        limit = limit + 1e-6 * w.abs().amax(-1, keepdim=True)
    assert out.dtype == want.dtype and out.shape == want.shape
    assert bool((diff <= limit).all()), f"max_abs_err {diff.max().item()}"


@pytest.mark.parametrize("d", [64, 576, 896, 1536, 2048, 2560, 4096, 5120,
                               7168, 7, 100, 20000, 10001])
@pytest.mark.parametrize("layer", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_norm_kernel_matches_plain(dev, d, layer, dtype):
    rng = np.random.default_rng(d)
    x = torch.tensor(rng.normal(0.3, 1.0, (ROW_NORM_ROWS[-1], d)),
                     dtype=torch.float32).to(dtype).to(dev)
    g = torch.tensor(rng.uniform(0.5, 1.5, d), dtype=torch.float32,
                     device=dev)
    b = (torch.tensor(rng.normal(0, 0.1, d), dtype=torch.float32,
                      device=dev) if layer else None)
    outs = {}
    for rows in ROW_NORM_ROWS:
        n0 = ops.launches["row_norm"]
        outs[rows] = ops.row_norm(x[:rows], g, b)
        assert ops.launches["row_norm"] == n0 + 1
        want = (ref.layernorm(x[:rows], g, b) if layer
                else ref.rmsnorm(x[:rows], g))
        sched = ref.row_norm_schedule(x[:rows], g, b)
        torch.cuda.synchronize()
        _row_norm_close(outs[rows], want, layer)
        assert torch.equal(outs[rows], sched), (
            rows, int((outs[rows] != sched).sum()))
    # row-count invariance, bit for bit
    for small, big in zip(ROW_NORM_ROWS, ROW_NORM_ROWS[1:]):
        assert torch.equal(outs[small], outs[big][:small]), (small, big)


@pytest.mark.parametrize("layer", [False, True])
def test_row_norm_kernel_takes_any_row_layout(dev, layer):
    """A (B, S, D) tensor, a transposed view (copied first) and a view one
    element into a buffer give each row the bits it has alone."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(0, 1, (3, 7, 576)),
                     dtype=torch.bfloat16).to(dev)
    g = torch.tensor(rng.uniform(0.5, 1.5, 576), dtype=torch.float32,
                     device=dev)
    b = torch.zeros_like(g) if layer else None
    whole = ops.row_norm(x, g, b)
    assert whole.shape == x.shape
    for i in range(3):
        assert torch.equal(whole[i], ops.row_norm(x[i], g, b))
    xt = x.transpose(0, 1)
    assert torch.equal(ops.row_norm(xt, g, b), whole.transpose(0, 1))
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(ops.row_norm(shifted, g, b), whole)
    # g (and b) one element into their buffers: the scalar loads
    gs = torch.empty(577, dtype=torch.float32, device=dev)[1:]
    gs.copy_(g)
    bs = None
    if layer:
        bs = torch.empty(577, dtype=torch.float32, device=dev)[1:]
        bs.copy_(b)
    assert torch.equal(ops.row_norm(x, gs, bs), whole)
    assert torch.equal(whole, ref.row_norm_schedule(x, g, b))


def test_row_norm_gradient_is_the_plain_versions(dev):
    """Under autograd the kernel's forward and the plain version's
    gradient (fit_affine_lm on the card)."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(0, 1, (8, 64)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    g = torch.tensor(rng.uniform(0.5, 1.5, 64), dtype=torch.float32,
                     device=dev, requires_grad=True)
    b = torch.zeros(64, dtype=torch.float32, device=dev, requires_grad=True)
    dy = torch.tensor(rng.normal(0, 1, (8, 64)), dtype=torch.float32,
                      device=dev)
    n0 = ops.launches["row_norm"]
    got = torch.autograd.grad(ops.row_norm(x, g, b), (x, g, b), dy)
    assert ops.launches["row_norm"] == n0 + 1
    want = torch.autograd.grad(ref.layernorm(x, g, b), (x, g, b), dy)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_row_norm_wrapper_refuses_what_it_cannot_run(dev):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    g = torch.ones(64, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        ops.row_norm(x, g.bfloat16())
    with pytest.raises(ValueError, match="cpu"):
        ops.row_norm(x, g.cpu())
    with pytest.raises(ValueError, match="bf16 or float32"):
        ops.row_norm(x.half(), g)
    with pytest.raises(ValueError, match=r"\(D,\)"):
        ops.row_norm(x, g[:32])


# -- serve plans: the per-shard dispatch of kernels 1 and 2 ------------------


@pytest.mark.parametrize("kvh,g,hd,mb", [(3, 3, 64, 2), (3, 3, 64, 1),
                                         (8, 6, 128, 2)])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_lane_groups_equal_the_whole_batch(dev, kvh, g, hd, mb,
                                                        quantized):
    """The request-skewed pipeline's launches: smollm-135m's heads at
    lane groups of 2 (B 12 on 6 stages) and 1, minitron-8b's at 2 (B 8 on
    4).  Each group (a contiguous slice of the batch's queries, table,
    positions and mask) is within the limit of the plain version, and
    equal bit for bit to its lanes of one launch over the whole batch."""
    args = _inputs(kvh * 10 + mb, 12, kvh, g, hd, 16, 12, dev)
    if quantized:
        *args, act = _quantized(args)
        call, plain = ops.paged_flash_decode_q, ref.paged_flash_decode_q
    else:
        *args, act = args
        call, plain = ops.paged_flash_decode, ref.paged_flash_decode
    q, arenas, (kpos, pt, qpos) = args[0], args[1:-3], args[-3:]
    whole = call(q, *arenas, kpos, pt, qpos, active=act)
    for r0 in range(0, 12, mb):
        rows = slice(r0, r0 + mb)
        got = call(q[rows], *arenas, kpos, pt[rows], qpos[rows],
                   active=act[rows])
        torch.cuda.synchronize()
        want = plain(q[rows], *arenas, kpos, pt[rows], qpos[rows],
                     active=act[rows])
        _assert_decode_close(got, want, None if quantized else _paged_spread(
            q[rows], *arenas, kpos, pt[rows], qpos[rows], act[rows]))
        assert torch.equal(got, whole[rows])


def _shard_arena(t, n):
    """t's kv-head slices (dim 2) as a plan holds them."""
    from repro_torch.models.shard_hints import Shards
    w = t.shape[2] // n
    return Shards([t[:, :, i * w:(i + 1) * w].contiguous() for i in range(n)],
                  "model", 2)


@pytest.mark.parametrize("kvh,g,hd,n", [(3, 3, 64, 3), (8, 4, 128, 4),
                                        (2, 2, 16, 2)])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_per_shard_dispatch_equals_unsharded(dev, kvh, g, hd, n,
                                                          quantized):
    """smollm-135m on 3 shards (1 kv head of 3 query heads each) and
    minitron-8b on 4 (2 of 4 each): one launch per shard over its arena
    slice, the outputs in shard order, equal the unsharded launch bit for
    bit."""
    from repro_torch.models.shard_hints import Shards
    args = _inputs(kvh * 10 + n, 8, kvh, g, hd, 16, 12, dev)
    if quantized:
        *args, act = _quantized(args)
        q, k, v, ks, vs, kpos, pt, qpos = args
        call = ops.paged_flash_decode_q
        arenas = (k, v, ks, vs)
    else:
        q, k, v, kpos, pt, qpos, act = args
        call = ops.paged_flash_decode
        arenas = (k, v)
    name = "paged_flash_decode_q" if quantized else "paged_flash_decode"
    want = call(q, *arenas, kpos, pt, qpos, active=act)
    n0 = ops.launches[name]
    shards = [_shard_arena(a, n) for a in arenas]
    got = call(q, *shards, Shards([kpos] * n, "model", None), pt, qpos,
               active=act)
    torch.cuda.synchronize()
    assert ops.launches[name] == n0 + n
    assert len(got) == n and all(o.shape[1] == kvh * g // n for o in got)
    assert torch.equal(torch.cat(list(got), 1), want)


# -- the K-ordered gemm (port-only) -------------------------------------------


def _gemm_inputs(seed, m, k, n, dev, nk=False):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 1, (m, k)), dtype=torch.bfloat16,
                     device=dev)
    w = torch.tensor(rng.normal(0, k ** -0.5, (n, k) if nk else (k, n)),
                     dtype=torch.bfloat16, device=dev)
    return x, w


def _gemm_close(out, x, w, nk):
    wk = (w.t() if nk else w).float()
    want = x.float() @ wk
    spread = x.float().abs() @ wk.abs()
    limit = 2 ** -8 * want.abs() + 1e-5 * spread + 1e-30
    assert ((out.float() - want).abs() <= limit).all(), (
        (out.float() - want).abs().max().item())


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (8, 576, 576), (8, 576, 192),
                                   (40, 576, 1536), (128, 4096, 1024),
                                   (3, 100, 77), (70, 33, 130),
                                   (8, 896, 151655)])
@pytest.mark.parametrize("nk", [False, True])
def test_gemm_kernel_matches_plain(dev, m, k, n, nk):
    x, w = _gemm_inputs(m + k + n, m, k, n, dev, nk)
    n0 = ops.launches["gemm"]
    out = ops.gemm(x, w, w_nk=nk)
    torch.cuda.synchronize()
    assert ops.launches["gemm"] == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    _gemm_close(out, x, w, nk)


@pytest.mark.parametrize("k,n,shards", [(576, 576, 3), (576, 192, 3),
                                        (4096, 4096, 4), (4096, 1024, 4),
                                        (4096, 16384, 4), (576, 49152, 3)])
def test_gemm_blocks_equal_the_whole(dev, k, n, shards):
    """The reduction order is fixed by K: a column block of w (a
    tensor-parallel shard's) and a row block of x (a pipeline
    microbatch's, a decode step inside a verify pass) give the whole
    product's bits."""
    x, w = _gemm_inputs(k + n, 128, k, n, dev)
    whole = ops.gemm(x, w)
    cols = n // shards
    for m in (1, 6, 8, 40, 64, 128):
        got = torch.cat([ops.gemm(x[:m], w[:, i * cols:(i + 1) * cols]
                                  .contiguous()) for i in range(shards)], 1)
        assert torch.equal(got, whole[:m]), m
        assert torch.equal(ops.gemm(x[m - 1:m], w), whole[m - 1:m]), m


def test_gemm_routes_training_and_long_products_to_matmul(dev):
    """The kernel is forward-only and raises where autograd records;
    `layers.product` sends such products, and those of more than
    EXACT_ROWS_MAX rows, to torch.matmul, and served ones to the kernel."""
    from repro_torch.models import layers
    x, w = _gemm_inputs(3, 16, 64, 32, dev)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.gemm(x, w)
    n0 = ops.launches["gemm"]
    assert torch.equal(layers.product(x, w), torch.matmul(x, w))
    assert ops.launches["gemm"] == n0
    w = w.detach()
    big = _gemm_inputs(4, layers.EXACT_ROWS_MAX + 1, 64, 32, dev)[0]
    assert torch.equal(layers.product(big, w), torch.matmul(big, w))
    assert ops.launches["gemm"] == n0
    layers.product(big[:layers.EXACT_ROWS_MAX], w)
    assert ops.launches["gemm"] == n0 + 1


def test_gemm_wrapper_refuses_what_it_cannot_run(dev):
    x, w = _gemm_inputs(4, 4, 64, 32, dev)
    with pytest.raises(ValueError, match="float32"):
        ops.gemm(x.float(), w)
    with pytest.raises(ValueError, match="cpu"):
        ops.gemm(x, w.cpu())
    with pytest.raises(ValueError, match="w_nk"):
        ops.gemm(x, w.t())


# -- the replica fleet and the disaggregated pools on the card ----------------


def _reduced_on(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, make_model
    cfg = get_config("smollm-135m").reduced()
    return cfg, make_model(cfg, device=dev), init_params(cfg, seed=0,
                                                          device=dev)


def _served(target, reqs):
    from repro_torch.serving.stream import clone_requests
    for r in clone_requests(reqs):
        target.submit(r)
    return {r.rid: tuple(r.tokens_out) for r in target.run()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_disagg_engine_equals_colocated_on_card(dev, kv_dtype):
    """disagg=(1, 1), both pools on the one card: streams equal
    colocated serving's bit for bit, every cold admission ships once, a
    replay ships nothing, and the route's kernel launches as often as
    colocated serving's."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.stream import bursty_requests
    cfg, model, params = _reduced_on(dev)
    kw = dict(max_batch=2, buckets=(32, 64), max_decode_len=8,
              num_pages=64, page_size=8, kv_dtype=kv_dtype, deadline_s=0.0)
    reqs = bursty_requests(np.random.default_rng(0), 8, cfg.vocab_size,
                           short_range=(10, 16), long_range=(40, 56),
                           burst_every=3, burst_size=2, budgets=(3, 5))
    kernel = ("paged_flash_decode_q" if kv_dtype == "int8"
              else "paged_flash_decode")
    colo = ContinuousBatchingEngine(model, params, **kw)
    dis = ContinuousBatchingEngine(model, params, disagg=(1, 1), **kw)
    assert dis.executor.prefill_model.device.type == "cuda"
    for _ in range(2):  # cold, then a replay of radix hits
        n0 = ops.launches[kernel]
        want = _served(colo, reqs)
        n1 = ops.launches[kernel]
        ships = dis.stats["ship_dispatches"]
        assert _served(dis, reqs) == want
        assert ops.launches[kernel] - n1 == n1 - n0 > 0
    s = dis.stats
    assert s["ship_dispatches"] == len(reqs) == ships  # none on the replay
    assert s["shipped_bytes"] == s["shipped_pages"] * dis.kv_page_bytes()
    assert s["prefix_hits"] == len(reqs)
    # the bytes gathered off the staging arena's leaves (padding pages
    # included): a page of every decode arena leaf, kpos with k and v
    from repro_torch.models.transformer import paged_cache_map
    page = []
    paged_cache_map(lambda ax, name, b: page.append(
        b.numel() // b.shape[ax] * b.element_size()), dis._slot_caches)
    gathered = dis.executor.gathered
    assert s["shipped_pages"] <= gathered["pages"] < 2 * s["shipped_pages"]
    assert gathered["bytes"] == gathered["pages"] * sum(page)


def test_two_replica_fleet_equals_plain_engine_on_card(dev):
    """A 2-replica affinity fleet on cuda:0, plan-free and under 1x1 serve
    plans on [cuda:0, cuda:0] groups: streams equal the plain engine's."""
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.replica import (make_group_mesh,
                                             replica_device_groups)
    from repro_torch.serving.router import FleetConfig, build_fleet
    from repro_torch.serving.stream import multi_prefix_requests
    cfg, model, params = _reduced_on(dev)
    kw = dict(max_batch=2, buckets=(16, 32, 64), num_pages=64,
              deadline_s=0.0)
    reqs = multi_prefix_requests(np.random.default_rng(1), 12,
                                 cfg.vocab_size, n_prefixes=2,
                                 prefix_len=24, suffix_range=(2, 6),
                                 budgets=(3, 7))
    want = _served(ContinuousBatchingEngine(model, params, **kw), reqs)
    config = FleetConfig(rebalance_margin=10_000)
    groups = replica_device_groups(2, 1, devices=["cuda:0", "cuda:0"])
    plans = [build_plan(cfg, make_group_mesh(g, (1, 1), ("data", "model")),
                        mode="serve") for g in groups]
    for p in (None, plans):
        fleet = build_fleet(model, params, 2, plans=p, config=config, **kw)
        assert _served(fleet, reqs) == want
        assert fleet.stats()["prefix_hits"] == 10
        assert all(r.engine.executor.device.type == "cuda"
                   for r in fleet.replicas)


def test_plan_auto_equals_plain_engine_on_card(dev, tmp_path):
    """serve.serve with --plan auto on a devices-2 profile: the choice's
    two replicas on the one card, int8 pages of 8, each stream equal to
    one plain engine's on the same pages (FIFO admission), and
    paged_flash_decode_q launched once a layer a decode step."""
    import json
    from repro_torch.launch import serve as serve_cli
    path = tmp_path / "profile.json"
    path.write_text(json.dumps({"devices": 2, "hbm_gb": 80.0}))
    base = ["--reduced", "--requests", "8", "--max-new", "6"]

    def served(argv):
        args = serve_cli.parse_args(base + argv)
        n0 = ops.launches["paged_flash_decode_q"]
        target, done, _ = serve_cli.serve(args, deadline_s=0.0)
        engines = ([r.engine for r in target.replicas]
                   if hasattr(target, "replicas") else [target])
        steps = sum(e.stats["decode_steps"] for e in engines)
        assert ops.launches["paged_flash_decode_q"] - n0 == \
            engines[0].model.cfg.n_layers * steps > 0
        assert all(e.executor.device.type == "cuda" for e in engines)
        return args, engines, {r.rid: tuple(r.tokens_out) for r in done}

    args, engines, got = served(["--plan", "auto", "--traffic", str(path)])
    assert args.chosen.key == "serve.tp1.r2.exact.kv=ps8.int8.w=int8"
    assert len(engines) == 2
    assert all(e.page_size == 8 and e.kv_dtype == "int8" for e in engines)
    _, _, want = served(["--plan", "none", "--page-size", "8",
                         "--kv-dtype", "int8", "--quant-weights"])
    assert got == want


def test_moe_ffn_stage_rows_equal_the_batch_call(dev, monkeypatch):
    """moonshot-v1-16b-a3b's MoE FFN at full width (64 experts, D 2048,
    F 1408; one layer of `init_params` weights): each 2-lane group of a
    12-lane batch, run through `moe_ffn`'s ``lanes`` (at one device's 12
    lanes, as a pipeline stage runs it), equals the 12-row call at those
    rows bit for bit, its routing included.  cuBLAS picks its kernels for
    the f32 router product and the bf16 expert products by row count."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1)
    p = {k: v[0] for k, v in
         init_params(cfg, seed=0, device=dev)["scan"]["b0"]["ffn"].items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((12, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    routes = []
    orig = moe.route

    def spy(*args, **kw):
        routes.append(orig(*args, **kw))
        return routes[-1]

    monkeypatch.setattr(moe, "route", spy)
    with torch.no_grad():
        want, _ = moe.moe_ffn(x, p, cfg)
        full = routes[-1]
        for r0 in range(0, 12, 2):
            rows = slice(r0, r0 + 2)
            got, _ = moe.moe_ffn(x[rows], p, cfg, lanes=(rows, 12))
            assert torch.equal(got, want[rows]), r0
            for name in ("gates", "experts", "rank", "keep"):
                assert torch.equal(getattr(routes[-1], name)[rows],
                                   getattr(full, name)[rows]), (r0, name)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_ffn_per_shard_equals_one_device(dev, n):
    """moonshot-v1-16b-a3b's MoE FFN at full width (one layer of
    `init_params` weights) under an exact (1, n) serve plan's placement,
    every shard on the card: each shard runs its 64 / n experts' wi and wg
    products (torch.bmm over the block) and its columns of the shared
    experts, the whole wo on the joined rows.  At a decode step (B 8, S 1)
    and a bucket of 32 (B 1), with the verify pass's `columns` on and off,
    its output equals the plan-free `moe_ffn` bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.shard_hints import Shards
    from repro_torch.models.transformer import (_index, init_params,
                                                make_model)
    from repro_torch.serving.executor import Executor
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1)
    params = init_params(cfg, seed=0, device=dev)
    ex = Executor(make_model(cfg, device=dev), params, plan=build_plan(
        cfg, make_mesh((1, n), ("data", "model")), mode="serve"))
    whole = _index(params["scan"]["b0"]["ffn"], 0)
    placed = _index(ex.params["scan"]["b0"]["ffn"], 0)
    assert isinstance(placed["wi"], Shards) and len(placed["wi"]) == n
    assert not isinstance(placed["wo"], Shards)
    gen = torch.Generator(device=dev).manual_seed(n)
    for b, s in ((8, 1), (1, 32)):
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        for columns in (False, True):
            with torch.no_grad():
                want, _ = moe.moe_ffn(x, whole, cfg, columns=columns)
                with ex._ctx():
                    got, _ = moe.moe_ffn(x, placed, cfg, columns=columns)
            assert torch.equal(got, want), (b, s, columns)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_recurrent_blocks_per_shard_equal_one_device(dev, arch, n):
    """One RG-LRU block (recurrentgemma-2b) or one mLSTM and one sLSTM
    block (xlstm-1.3b, slstm_every=2) at full width, `init_params`
    weights with a vocabulary of 256, under an exact (1, n) serve plan's
    placement, every shard on the card: the RG-LRU's width a shard, the
    mLSTM's `up_z`/`up_g` columns a shard (one head's on (1, 4)) and the
    sLSTM's GLU columns, both cells whole on the controller.  From a random state, at a
    decode step (B 8, S 1) and a bucket of 32 (B 1, trailing pads), each
    block's output and new state equal the plan-free block's bit for
    bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recurrent as rec
    from repro_torch.models.shard_hints import Shards
    from repro_torch.models.transformer import (_index, cache_map,
                                                init_params, make_model)
    from repro_torch.serving.executor import Executor
    blocks = {"rglru": rec.rglru_block, "mlstm": rec.mlstm_block,
              "slstm": rec.slstm_block}
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, vocab_size=256, **(
        dict(n_layers=1) if arch == "recurrentgemma-2b"
        else dict(n_layers=2, slstm_every=2)))
    model = make_model(cfg, device=dev)
    params = init_params(cfg, seed=0, device=dev)
    ex = Executor(model, params, max_batch=8, plan=build_plan(
        cfg, make_mesh((1, n), ("data", "model")), mode="serve"))
    gen = torch.Generator(device=dev).manual_seed(n)

    def whole(t):
        if not isinstance(t, Shards):
            return t
        return t[0] if t.dim is None else torch.cat(list(t), t.dim)

    def fill(axis, t):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        return t

    for b, s in ((8, 1), (1, 32)):
        caches = cache_map(fill, model.init_cache(b, 32))
        placed = ex.place_caches(cache_map(lambda a, t: t.clone(), caches),
                                 False, slot_table=False)
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        valid[0, s - s // 4:] = False
        sites = [(cfg.block_kind(j), _index(params["scan"][k], 0),
                  _index(ex.params["scan"][k], 0), _index(caches["scan"][k],
                                                          0),
                  _index(placed["scan"][k], 0))
                 for j, k in enumerate(params["scan"])]
        sites += [(cfg.block_kind(int(k)), params["tail"][k],
                   ex.params["tail"][k], caches["tail"][k],
                   placed["tail"][k]) for k in params["tail"]]
        for kind, p, pp, st, pst in sites:
            if "n" in st:
                st["n"].abs_()
                for part in (pst["n"] if isinstance(pst["n"], Shards)
                             else [pst["n"]]):
                    part.abs_()
            with torch.no_grad():
                y, new = blocks[kind](x, p["mix"], cfg, dict(st), valid)
                with ex._ctx():
                    y2, new2 = blocks[kind](x, pp["mix"], cfg, dict(pst),
                                            valid)
            assert torch.equal(y, y2), (kind, b, s)
            for k in new:
                assert torch.equal(new[k], whole(new2[k])), (kind, k, b, s)


# recurrentgemma-2b's W8A8 tail MLP on a (1, 2) serve plan at 8 lanes: a
# column block of wi / wg, the whole wo, and a row block of wo under
# exact=False, each block stored column-major as the executor places it
@pytest.mark.parametrize("k,n,block", [(2560, 3840, "column"),
                                       (7680, 2560, None),
                                       (3840, 2560, "row")])
def test_int8_matmul_at_the_shard_shapes(dev, k, n, block):
    from repro_torch.models.quantized import column_major, quantize_leaf
    rng = np.random.default_rng(k + n)
    whole = {"column": (k, 2 * n), "row": (2 * k, n), None: (k, n)}[block]
    q = quantize_leaf(torch.tensor(rng.normal(0, 0.02, whole),
                                   dtype=torch.bfloat16))["q"]
    q = column_major({"column": q[:, :n], "row": q[:k],
                      None: q}[block]).to(dev)
    assert q.t().is_contiguous()
    a = torch.tensor(rng.integers(-127, 128, (8, k)), dtype=torch.int8,
                     device=dev)
    n0 = ops.launches["int8_matmul"]
    out = ops.int8_matmul(a, q, 1.0, 1.0)
    assert ops.launches["int8_matmul"] == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(out, ref.int8_matmul(a, q, 1.0, 1.0))
    assert torch.equal(out.cpu(), ref.int8_matmul(a.cpu(), q.cpu(), 1.0,
                                                  1.0))


def test_train_step_grads_match_the_cpu(dev):
    """One train step's loss and gradients (reduced smollm-135m, remat, B 4
    S 64, init_params seed 0 drawn on the CPU and copied to the card: a
    generator draws other numbers on the card) on the card against the
    CPU's: the loss
    within 2e-3 relative and every gradient leaf within 2e-2 of its
    largest |value| (bf16 forward and backward in cuBLAS's and the CPU's
    orders; the card's norms run the row_norm kernel), the grad norm
    within 1e-2 relative; remat's gradients equal no remat's bit for bit
    on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.optim.optimizer import global_norm, tree_leaves
    cfg = get_config("smollm-135m").reduced()
    b = TokenPipeline(cfg.vocab_size, 4, 64, seed=0).next_batch()
    cpu = init_params(cfg, seed=0, device="cpu")

    def on(tree, d):
        if isinstance(tree, dict):
            return {k: on(v, d) for k, v in tree.items()}
        return tree.to(d)
    out = {}
    for d in ("cpu", dev):
        batch = {k: torch.as_tensor(v, device=d) for k, v in b.items()}
        out[str(d)] = train._grads(make_model(cfg, device=d), on(cpu, d),
                                   batch)
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert abs(lg.item() - lc.item()) <= 2e-3 * abs(lc.item())
    for a, c in zip(tree_leaves(gg), tree_leaves(gc)):
        scale = c.float().abs().max().item()
        assert (a.cpu().float() - c.float()).abs().max().item() <= \
            2e-2 * scale + 1e-6
    nc, ng = global_norm(gc).item(), global_norm(gg).item()
    assert abs(ng - nc) <= 1e-2 * nc
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    _, g0 = train._grads(make_model(cfg, remat=False, device=dev),
                         on(cpu, dev), batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(g0),
                                                 tree_leaves(gg)))


def test_sharded_train_step_on_card(dev):
    """The sharded step (`train.jit_train_step`: reduced smollm-135m on a
    (2, 2) ("data", "model") train plan, its four shards on the card)
    against one device's `make_train_step` on the card from the same
    init and batch: the loss within 1e-4 relative and the grad norm
    within 5e-3 (the CPU tests' bounds); every updated block on the card;
    row_norm launched 2 (4n + 1) times and nothing else; one step under
    hints(int8_gather=True) finite and within 1e-2 of the bf16 step's
    loss."""
    from repro_torch.configs import get_config
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.data.pipeline import TokenPipeline, shard_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import shard_hints
    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.optim.optimizer import (cosine_schedule,
                                             make_optimizer, tree_leaves)
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, seed=0, device=dev)
    init, upd = make_optimizer("adamw", cosine_schedule(3e-3, 5, 30))
    state = init(params)
    mesh = make_mesh((2, 2), ("data", "model"))
    plan = build_plan(cfg, mesh, params, batch=4)
    pspecs = train.train_param_specs(plan, params)
    model = make_model(cfg, device=dev)
    step = train.jit_train_step(model, upd, plan,
                                train.opt_state_specs(state, pspecs))
    b = TokenPipeline(cfg.vocab_size, 4, 64, seed=0).next_batch()
    ops.reset_launches()
    p, _, m = step(params, state, shard_batch(b, mesh, plan.data_spec))
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert ops.launches["row_norm"] == 2 * (4 * n + 1)
    assert not any(v for k, v in ops.launches.items() if k != "row_norm")
    assert all(t.is_cuda for leaf in tree_leaves(p) for t in leaf)
    _, _, m1 = train.make_train_step(model, upd)(
        params, state, {k: torch.as_tensor(v, device=dev)
                        for k, v in b.items()})
    loss, loss1 = float(m["loss"]), float(m1["loss"])
    assert abs(loss - loss1) <= 1e-4 * abs(loss1)
    assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
        5e-3 * float(m1["grad_norm"])
    with shard_hints.hints(mesh, int8_gather=True):
        _, _, m8 = step(params, state, shard_batch(b, mesh, plan.data_spec))
    loss8 = float(m8["loss"])
    assert np.isfinite(loss8) and abs(loss8 - loss) <= 1e-2 * abs(loss)
