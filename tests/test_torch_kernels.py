"""The port's plain paged_flash_decode against the JAX package's kernel.

Same numpy inputs go through `repro_torch.kernels.ops.paged_flash_decode`
on CPU tensors (which takes the plain PyTorch version) and through
`repro.kernels.ops.paged_flash_decode` with impl="interpret" (the Pallas
kernel body, run by the interpreter) and impl="ref" (the jnp gather
oracle).  Page tables carry pages shared between lanes, trash page 0
entries, sentinel and stale (kpos > qpos) rows, and inactive lanes.

Tolerances: f32 inputs agree to 1e-5 (only the summation order differs).
bf16 inputs agree to 2e-2: outputs lie in (-1, 1), where one bf16 ulp is
at most 2^-8, and the oracle rounds its scores and normalised p to bf16
where the kernel keeps f32 scores and rounds the unnormalised p.
Inactive lanes must be exact zeros.

The card kernel's schedule (tests/decode_schedule.py: the lane's slots
in 32-slot tiles through the page table, split over a cluster of 8
blocks and their warps, tiles without a kept key skipped, the cluster
combine) is held against the plain version and the Pallas body at the
same limits, at MAXP below, equal to and no multiple of the split count.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from decode_schedule import paged_schedule
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

SENTINEL = 2 ** 30


def make_paged(seed, b, kvh, g, hd, ps=4, maxp=5):
    """Random arena + page tables in the serving engine's invariants: a
    lane's logical page j holds positions [j*ps, (j+1)*ps); prefix pages
    may be shared with lane 0; pages past a lane's length name the trash
    page 0; rows past qpos in a lane's last page are stale (kpos > qpos)
    or never written (sentinel).  Lanes 1 and b-1 are inactive."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    q = rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5
    k = rng.uniform(-1, 1, (n_pages, ps, kvh, hd))
    v = rng.uniform(-1, 1, (n_pages, ps, kvh, hd))
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    qpos = rng.integers(ps, maxp * ps - 2, b).astype(np.int32)
    nxt = 1
    for lane in range(b):
        for j in range(int(qpos[lane]) // ps + 1):
            full = (j + 1) * ps <= min(qpos[0], qpos[lane])
            if lane and full and (lane == 2 or rng.random() < 0.5):
                pt[lane, j] = pt[0, j]  # shared prefix page
                continue
            pt[lane, j] = nxt
            kpos[nxt] = j * ps + np.arange(ps)
            nxt += 1
        last = pt[lane, int(qpos[lane]) // ps]
        off = int(qpos[lane]) % ps
        if off + 1 < ps:  # the row after qpos: never written
            kpos[last, off + 1] = SENTINEL
    active = np.ones((b,), bool)
    active[[1, b - 1]] = False
    return dict(q=q, k=k, v=v, kpos=kpos, pt=pt, qpos=qpos, active=active)


def _jax(inp, dtype, impl):
    out = jops.paged_flash_decode(
        jnp.asarray(inp["q"], dtype), jnp.asarray(inp["k"], dtype),
        jnp.asarray(inp["v"], dtype), jnp.asarray(inp["kpos"]),
        jnp.asarray(inp["pt"]), jnp.asarray(inp["qpos"]),
        active=jnp.asarray(inp["active"]), impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _torch(inp, dtype):
    out = tops.paged_flash_decode(
        torch.tensor(inp["q"]).to(dtype), torch.tensor(inp["k"]).to(dtype),
        torch.tensor(inp["v"]).to(dtype), torch.tensor(inp["kpos"]),
        torch.tensor(inp["pt"]), torch.tensor(inp["qpos"]),
        active=torch.tensor(inp["active"]))
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_flash_decode_matches_jax(dtype, g, hd):
    inp = make_paged(seed=10 * g + hd, b=4, kvh=2, g=g, hd=hd)
    assert (inp["pt"] == 0).any() and len(np.unique(inp["pt"])) < \
        (inp["pt"] > 0).sum() + 1, "want trash entries and shared pages"
    tdt, jdt, atol = ((torch.float32, jnp.float32, 1e-5) if dtype == "f32"
                      else (torch.bfloat16, jnp.bfloat16, 2e-2))
    got = _torch(inp, tdt)
    for impl in ("interpret", "ref"):
        want = _jax(inp, jdt, impl)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=impl)
    off = ~inp["active"]
    assert (got[off] == 0).all(), "inactive lanes must be exact zeros"
    assert np.isfinite(got).all()


def test_fully_masked_lane_is_zero_not_nan():
    """A lane whose every key is masked (qpos below its first row) gives
    exact zeros through the plain version, as the kernel does."""
    inp = make_paged(seed=3, b=3, kvh=1, g=2, hd=16)
    inp["qpos"][0] = -1
    got = _torch(inp, torch.float32)
    assert (got[0] == 0).all() and np.isfinite(got).all()


def test_wrapper_refuses_bad_shapes_and_counts_no_cpu_launch():
    inp = make_paged(seed=4, b=2, kvh=1, g=2, hd=16)
    q = torch.tensor(inp["q"]).float()
    k = torch.tensor(inp["k"]).float()
    before = dict(tops.launches)
    with pytest.raises(ValueError, match="kpos"):
        tops.paged_flash_decode(q, k, k, torch.tensor(inp["kpos"])[:, :2],
                                torch.tensor(inp["pt"]),
                                torch.tensor(inp["qpos"]))
    tops.paged_flash_decode(q, k, k, torch.tensor(inp["kpos"]),
                            torch.tensor(inp["pt"]),
                            torch.tensor(inp["qpos"]))
    assert tops.launches == before  # the plain version is no launch


def test_ref_gather_equals_dense_decode():
    """The paged plain version is the dense one over the gathered cache."""
    inp = make_paged(seed=5, b=3, kvh=2, g=2, hd=16)
    t = {n: torch.tensor(a) for n, a in inp.items()}
    pt = t["pt"].long()
    dense = tref.flash_decode(
        t["q"], t["k"][pt].reshape(3, -1, 2, 16),
        t["v"][pt].reshape(3, -1, 2, 16), t["kpos"][pt].reshape(3, -1),
        t["qpos"], active=t["active"])
    paged = tref.paged_flash_decode(t["q"], t["k"], t["v"], t["kpos"],
                                    t["pt"], t["qpos"], active=t["active"])
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ps,maxp,hd,g", [
    (32, 5, 64, 3),   # one page per tile; MAXP below the split count
    (32, 8, 16, 8),   # ... equal to it
    (32, 13, 64, 2),  # ... and no multiple of it
    (4, 5, 16, 1),    # eight pages per tile
    (16, 12, 128, 4),  # the serve path's page size, two pages per tile
])
def test_kernel_schedule_matches_plain_and_pallas_body(dtype, ps, maxp, hd,
                                                       g):
    inp = make_paged(seed=ps + maxp + hd, b=4, kvh=2, g=g, hd=hd, ps=ps,
                     maxp=maxp)
    tdt, jdt, atol = ((torch.float32, jnp.float32, 1e-5) if dtype == "f32"
                      else (torch.bfloat16, jnp.bfloat16, 2e-2))
    t = {n: torch.tensor(inp[n]).to(tdt) for n in ("q", "k", "v")}
    got, counts = paged_schedule(
        t["q"], t["k"], t["v"], torch.tensor(inp["kpos"]),
        torch.tensor(inp["pt"]), torch.tensor(inp["qpos"]),
        active=torch.tensor(inp["active"]), with_split_counts=True)
    assert got.dtype == tdt
    got = got.float().numpy()
    plain = tref.paged_flash_decode(
        t["q"], t["k"], t["v"], torch.tensor(inp["kpos"]),
        torch.tensor(inp["pt"]), torch.tensor(inp["qpos"]),
        active=torch.tensor(inp["active"]))
    np.testing.assert_allclose(got, plain.float().numpy(), atol=atol,
                               rtol=0, err_msg="plain")
    np.testing.assert_allclose(got, _jax(inp, jdt, "interpret"), atol=atol,
                               rtol=0, err_msg="pallas")
    off = ~inp["active"]
    assert (got[off] == 0).all(), "inactive lanes must be exact zeros"
    assert np.isfinite(got).all()
    # trash-page tiles and tiles past qpos hold no kept key, so some split
    # of an active lane adds nothing
    assert ((counts[inp["active"]] == 0).sum(1) > 0).any(), counts.tolist()


def test_build_returns_the_report_of_a_library_built_earlier(tmp_path,
                                                             monkeypatch):
    """A library already built is not rebuilt, and build_all still returns
    the ptxas report kept beside it (chip_smoke gates spills on it)."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    lib = build.lib_path("flash_decode")
    open(lib, "wb").close()
    assert build.build_all(["flash_decode"]) == {"flash_decode": ""}
    with open(lib + ".log", "w") as f:
        f.write("ptxas info : 0 bytes spill stores, 0 bytes spill loads\n")
    rep = build.build_all(["flash_decode"])
    assert rep == {"flash_decode": "ptxas info : 0 bytes spill stores, "
                   "0 bytes spill loads\n"}


def test_decode_schedule_constants_match_the_cuda_body():
    """ops' DECODE_TILE, DECODE_SPLITS and DECODE_WARPS (which the CPU
    emulation and the card tests' tile placement read) equal the kTile,
    kSplit and kWarps the CUDA body compiles with, and all three decode
    kernels run that body: the bf16 ones rounding p to bf16, the int8 one
    (paged_flash_decode_q.cu) keeping p in f32 with a scaled loader."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(tops.__file__), "csrc")
    text = open(os.path.join(csrc, "decode_split.cuh")).read()
    for kernel, round_p, scaled in (("paged_flash_decode", "true", "false"),
                                    ("flash_decode", "true", "false"),
                                    ("paged_flash_decode_q", "false",
                                     "true")):
        body = open(os.path.join(csrc, kernel + ".cu")).read()
        assert '#include "decode_split.cuh"' in body, kernel
        assert "__cluster_dims__(kSplit, 1, 1)" in body, kernel
        calls = re.findall(r"decode_split::decode<HD, GMAX, (\w+)>", body)
        assert calls == [round_p], (kernel, calls)
        assert re.findall(r"static constexpr bool kScaled = (\w+);",
                          body) == [scaled], kernel
    assert not os.path.exists(os.path.join(csrc, "decode_attn.cuh"))

    def const(name):
        found = re.findall(rf"constexpr int {name} = ([^;]+);", text)
        assert len(found) == 1, (name, found)
        return found[0].strip()

    threads = int(const("kThreads"))
    assert const("kWarps") == "kThreads / 32"
    assert int(const("kTile")) == tops.DECODE_TILE
    assert int(const("kSplit")) == tops.DECODE_SPLITS
    assert threads // 32 == tops.DECODE_WARPS


def test_int8_matmul_constants_match_the_cuda_kernel():
    """ops' INT8_MM_BM, INT8_MM_BN, INT8_MM_BK and INT8_MM_MAX_SPLIT (the
    wrapper picks the split from them) equal the tile and split constants
    int8_matmul.cu compiles with, and the kernel computes on the int8
    tensor cores without .satfinite (which would clamp where the plain
    version wraps)."""
    import os
    import re

    text = open(os.path.join(os.path.dirname(tops.__file__), "csrc",
                             "int8_matmul.cu")).read()
    tile = re.findall(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);",
                      text)
    assert tile == [(str(tops.INT8_MM_BM), str(tops.INT8_MM_BN),
                     str(tops.INT8_MM_BK))], tile
    split = re.findall(r"constexpr int kMaxSplit = (\d+);", text)
    assert split == [str(tops.INT8_MM_MAX_SPLIT)], split
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    asm = re.findall(r'"([^"]*)"', text)  # the inline PTX strings
    assert not [a for a in asm if "satfinite" in a]


@pytest.mark.parametrize("m,n,k,sms,want", [
    (128, 768, 768, 132, 8),    # ibert-base q/k/v/wo: 24 tiles
    (128, 3072, 768, 132, 2),   # w1: 96 tiles
    (128, 768, 3072, 132, 8),   # w2: 24 tiles, 48 K steps
    (1, 5, 3, 132, 1),          # one K step: no split
    (130, 3072, 770, 132, 1),   # 144 tiles fill the card
    (33, 77, 65, 132, 2),       # two K steps: one each
    (64, 64, 4096, 132, 8),     # capped at INT8_MM_MAX_SPLIT
    (128, 768, 768, 48, 2),     # a smaller card fills sooner
])
def test_int8_matmul_split_fills_the_card(m, n, k, sms, want):
    got = tops.int8_matmul_split(m, n, k, sms)
    assert got == want
    tiles = -(-m // tops.INT8_MM_BM) * -(-n // tops.INT8_MM_BN)
    steps = -(-k // tops.INT8_MM_BK)
    assert 1 <= got <= tops.INT8_MM_MAX_SPLIT and got <= max(steps, 1)
    assert got == 1 or tiles * got // 2 < sms  # the smallest that fills


# -- the K-ordered gemm's wrapper on the CPU -----------------------------------


@pytest.mark.parametrize("shape", [(8, 64), (2, 3, 64), (1, 1, 64)])
@pytest.mark.parametrize("nk", [False, True])
def test_gemm_plain_version_is_torch_matmul(shape, nk):
    """On the CPU the wrapper is torch.matmul on the shapes as given (the
    bits the JAX comparisons were held to), the tied head's (N, K) weight
    read transposed; out_dtype f32 gives the f32 product of the bf16
    inputs (a shard's partial)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g).bfloat16()
    w = torch.randn((32, 64) if nk else (64, 32), generator=g).bfloat16()
    wk = w.t() if nk else w
    n0 = tops.launches["gemm"]
    assert torch.equal(tops.gemm(x, w, w_nk=nk), torch.matmul(x, wk))
    part = tops.gemm(x, w, w_nk=nk, out_dtype=torch.float32)
    assert part.dtype == torch.float32
    assert torch.equal(part, torch.matmul(x.float(), wk.float()))
    assert tops.launches["gemm"] == n0  # the plain version counts nothing


def test_gemm_wrapper_checks_shapes():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gemm"):
        tops.gemm(x, torch.zeros((32, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="gemm"):
        tops.gemm(x, torch.zeros((64,), dtype=torch.bfloat16))


def test_gemm_constants_match_the_cuda_kernel():
    """The kernel's K tile, its mma step and its split of K over a cluster,
    which fix the reduction order (csrc/gemm.cu): functions of K alone,
    the ranks' partial sums added in rank order, no atomics."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tops.__file__), "csrc",
                            "gemm.cu")).read()
    assert re.search(rf"constexpr int BN = 64, BK = {tops.GEMM_BK};", src)
    assert re.search(rf"constexpr int kMaxSplit = {tops.GEMM_MAX_SPLIT};",
                     src)
    assert "*per = max(3, (nk + kMaxSplit - 1) / kMaxSplit);" in src
    assert "*split = max(1, (nk + *per - 1) / *per);" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ks < BK; ks += 16" in src
    assert "for (int s = 1; s < split; ++s)" in src
    assert "atomicAdd" not in src
    # smollm-135m's K 576 (9 tiles), minitron-8b's 4096 and 16384, one tile
    assert [tops.gemm_split(k) for k in (576, 1536, 4096, 16384, 64, 1)] \
        == [(3, 3), (3, 8), (8, 8), (32, 8), (3, 1), (3, 1)]
