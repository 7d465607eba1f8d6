"""Kernel wrappers: dispatch by the tensors' device.

A CUDA tensor goes to the hand-written kernel, and any failure raises —
there is no fallback on the card.  A CPU tensor goes to the kernel's plain
PyTorch version in `kernels/ref.py`.  Each wrapper counts its kernel
launches in `launches` (plain integers), so a run can show that its main
path went through the kernels.

Scales (float32 scalars: Python floats or 0-d tensors) reach a kernel by
value; a 0-d tensor on the card is read back to the host for that, so
callers keep scales on the CPU (the I-BERT model does).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.ibert_ops import LNParams
from repro_torch.kernels import ref as _ref

launches = {"paged_flash_decode": 0, "paged_flash_decode_q": 0,
            "flash_decode": 0, "flash_attention": 0, "int8_matmul": 0,
            "i_softmax": 0, "i_layernorm": 0, "i_gelu": 0, "row_norm": 0,
            "gemm": 0}

HEAD_DIMS = (16, 64, 128)  # the paged decode kernels' head_dim instances
MAX_GROUP = 8  # query heads per kv head the paged decode kernels take
# flash_decode (dense slot rows) also has hd 256 (recurrentgemma-2b), and
# takes any group: its heads are cut into chunks of at most MAX_GROUP,
# one cluster each (`decode_group_chunks`)
FLASH_DECODE_HEAD_DIMS = (16, 64, 128, 256)
# the decode kernels' schedule (the bf16 ones and the int8 one share it),
# as csrc/decode_split.cuh's kTile, kSplit and kWarps (a CPU test holds
# them equal): a lane's key slots are walked in tiles of DECODE_TILE
# slots, split over a cluster of DECODE_SPLITS blocks of DECODE_WARPS
# warps; a tile with no kept key is skipped unread
DECODE_TILE = 32
DECODE_SPLITS = 8
DECODE_WARPS = 4
# int8_matmul's tiling, as csrc/int8_matmul.cu's BM, BN, BK and kMaxSplit
# (a CPU test holds them equal): INT8_MM_BM x INT8_MM_BN output tiles, K
# in steps of INT8_MM_BK, each tile's steps split over a cluster of up to
# INT8_MM_MAX_SPLIT blocks
INT8_MM_BM = 64
INT8_MM_BN = 64
INT8_MM_BK = 64
INT8_MM_MAX_SPLIT = 8
FA_HEAD_DIMS = (16, 32, 64, 128)  # flash_attention's compiled instances
# the gemm kernel's order of summation, as csrc/gemm.cu's BK, kMaxSplit
# and split_of (a CPU test holds them equal): K in tiles of GEMM_BK,
# split over a cluster of blocks by `gemm_split`, a function of K alone
GEMM_BK = 64
GEMM_MAX_SPLIT = 8


# row_norm's geometry, as csrc/row_norm.cu's kSlots and kMaxBlock (a CPU
# test holds them equal): a thread holds at most ROW_NORM_SLOTS 16-byte
# vectors of its row in registers, a row takes at most ROW_NORM_MAX_THREADS
# threads, and a block ROW_NORM_BLOCK threads where its rows are narrower
ROW_NORM_SLOTS = 4
ROW_NORM_MAX_THREADS = 512
ROW_NORM_BLOCK = 256


class RowNormGeometry(NamedTuple):
    vec: int         # values in a 16-byte vector: 8 bf16 or 4 f32
    threads: int     # threads a row, a power of two
    slots: int       # vectors a thread: t, t + threads, t + 2 threads, ...
    block_rows: int  # rows a block


@functools.lru_cache(maxsize=None)
def row_norm_geometry(d: int, dtype: torch.dtype) -> RowNormGeometry:
    """The row_norm kernel's geometry at width d in x's dtype (bf16 or
    float32), a function of (d, dtype) alone, so a row's order of sums,
    and its bits, are too: the fewest threads (a power of two, at most
    ROW_NORM_MAX_THREADS) at which each holds at most ROW_NORM_SLOTS of
    the row's ceil(d / vec) vectors, and at least one thread a vector up
    to a warp (a narrow row's sums are then a tree over the warp's lanes,
    not a chain in one thread); past ROW_NORM_MAX_THREADS, more slots a
    thread, walked in chunks of ROW_NORM_SLOTS.  `ref.row_norm_schedule`
    repeats the kernel's order over it."""
    if dtype not in (torch.bfloat16, torch.float32) or d < 1:
        raise ValueError(f"row_norm: no geometry for d {d} in {dtype}")
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    nvec = -(-d // vec)
    threads = 1
    while threads < ROW_NORM_MAX_THREADS and (
            threads * ROW_NORM_SLOTS < nvec or threads < min(32, nvec)):
        threads *= 2
    return RowNormGeometry(vec, threads, -(-nvec // threads),
                           max(1, ROW_NORM_BLOCK // threads))


def gemm_split(k: int) -> tuple:
    """(K tiles a block, blocks a cluster) of the gemm kernel at this K:
    rank r of the cluster sums tiles [r per, (r + 1) per) in order, and
    the ranks' partial sums are added in rank order."""
    nk = -(-k // GEMM_BK)
    per = max(3, -(-nk // GEMM_MAX_SPLIT))
    return per, max(1, -(-nk // per))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: library -> (symbol, argtypes); pointers and the stream as
# c_void_p, since a bare int would be cut to 32 bits
_SIGNATURES = {
    "paged_flash_decode": ("paged_flash_decode_bf16", [_P] * 8 + [_I] * 6
                           + [_P]),
    "paged_flash_decode_q": ("paged_flash_decode_q_int8", [_P] * 10
                             + [_I] * 6 + [_P]),
    "flash_decode": ("flash_decode_bf16", [_P] * 7 + [_I] * 6 + [_P]),
    "flash_attention": ("flash_attention", [_P] * 4 + [_I] * 7 + [_P]),
    "int8_matmul": ("int8_matmul", [_P] * 4 + [_I] * 3 + [_F] * 3
                    + [_I, _I, _P]),
    "i_softmax": ("i_softmax", [_P, _P, _I, _I, _F, _P]),
    "i_layernorm": ("i_layernorm", [_P] * 4 + [_I, _I, _P]),
    "i_gelu": ("i_gelu", [_P, _P, ctypes.c_longlong, _F, _P]),
    "row_norm": ("row_norm", [_P] * 4 + [_I, _I, _F] + [_I] * 4 + [_P]),
    "gemm": ("gemm_bf16", [_P] * 3 + [_I] * 5 + [_P]),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_FNS = {}


def _kernel_fn(name: str):
    """Kernel `name`'s C entry point, built and bound at first use."""
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels.build import load

        sym, argtypes = _SIGNATURES[name]
        fn = getattr(load(name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device` (the device of its tensors, made
    current for the launch: a plan's shards may sit on any card) and its
    current stream; count it or raise."""
    index = device.index
    if index is not None and index != torch._C._cuda_getDevice():
        with torch.cuda.device(device):
            return _launch(name, device, *args)
    # the raw handle of torch.cuda.current_stream(device) (cheaper on
    # the host, which bounds a decode step: ~250 launches a smollm step)
    stream = torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice() if index is None else index)
    err = _kernel_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _check(cond: bool, msg: str, kernel: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_cuda(kernel: str, dtypes: dict, **tensors) -> None:
    """The card's contract: every tensor on the first one's CUDA device,
    contiguous, in its dtype."""
    first = next(iter(tensors.values()))
    _check(first.is_cuda, f"no kernel for device {first.device}", kernel)
    for name, t in tensors.items():
        if (t.device == first.device and t.is_contiguous()
                and t.dtype == dtypes[name]):
            continue  # the messages below cost more than the checks
        _check(t.device == first.device, f"{name} on {t.device}, not "
               f"{first.device}", kernel)
        _check(t.is_contiguous(), f"{name} is not contiguous", kernel)
        want = str(dtypes[name]).replace("torch.", "").replace(
            "bfloat16", "bf16")
        _check(t.dtype == dtypes[name], f"{name} is {t.dtype}, the kernel "
               f"takes {want}", kernel)


def _scale(s) -> float:
    """A float32 scale as the float the kernel takes by value."""
    return float(torch.as_tensor(s, dtype=torch.float32))


def _decode_shapes(kernel: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, qpos: torch.Tensor,
                   active: Optional[torch.Tensor]):
    """Shape checks the decode wrappers share; returns (B, KVH, active)."""
    b, h, hd = q.shape
    _check(k.dim() == 4 and k.shape == v.shape, f"k/v shapes "
           f"{tuple(k.shape)} {tuple(v.shape)}: want equal 4-d caches",
           kernel)
    kvh = k.shape[2]
    _check(k.shape[3] == hd and h % kvh == 0, f"q {tuple(q.shape)} vs k "
           f"{tuple(k.shape)}: head_dim or head groups disagree", kernel)
    _check(tuple(qpos.shape) == (b,), f"qpos {tuple(qpos.shape)}", kernel)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=q.device)
    _check(tuple(active.shape) == (b,), f"active {tuple(active.shape)}",
           kernel)
    return b, kvh, active


def decode_group_chunks(g: int) -> list:
    """flash_decode's cut of a group of g query heads into chunks of at
    most MAX_GROUP, as even as the count allows (10 -> [5, 5], 9 -> [5,
    4]): one cluster of the kernel per chunk, as csrc/flash_decode.cu
    cuts it."""
    n = -(-g // MAX_GROUP)
    gc = -(-g // n)
    return [min(gc, g - i * gc) for i in range(n)]


def _check_decode_cuda(kernel: str, kv_dtype: torch.dtype,
                       head_dims=HEAD_DIMS, max_group=MAX_GROUP,
                       **tensors) -> None:
    """The decode kernels' contract on the card: bf16 q, k/v in kv_dtype,
    f32 scales, int32 positions and tables, a bool lane gate, all
    contiguous on one device; hd in `head_dims`, at most `max_group`
    query heads per kv head (None: any), q/k/v 16-byte aligned."""
    dtypes = dict(q=torch.bfloat16, k=kv_dtype, v=kv_dtype,
                  k_scale=torch.float32, v_scale=torch.float32,
                  kpos=torch.int32, page_table=torch.int32,
                  qpos=torch.int32, active=torch.bool)
    _check_cuda(kernel, dtypes, **tensors)
    q, k = tensors["q"], tensors["k"]
    hd, kvh = q.shape[2], k.shape[2]
    _check(hd in head_dims, f"head_dim {hd} not in {head_dims}", kernel)
    _check(max_group is None or q.shape[1] // kvh <= max_group,
           f"group {q.shape[1] // kvh} > {max_group}", kernel)
    for name in ("q", "k", "v"):
        _check(tensors[name].data_ptr() % 16 == 0,
               f"{name} is not 16-byte aligned", kernel)


def shard_heads(call, q, *args, active=None):
    """A paged decode kernel under a serve plan, once per shard.

    `args` are the call's arguments after q: a list (the plan's
    `Shards`) gives shard i its part i — the arena's `k`/`v` (and
    `k_scale`/`v_scale`) kv-head slice (P, ps, KVH/n, hd), and `kpos`
    held once per device; a tensor (the page table, the positions, and
    `active`) is the same routing metadata on every shard, moved to its
    device.  q is the shards' list of (B, H/n, hd) queries, or the whole
    (B, H, hd): heads are kv-head-major, so a contiguous split of H is a
    split by kv head, whole GQA groups on each shard.  Each shard launches
    the kernel once, on its device; per-head math never crosses shards, so
    each output equals the unsharded launch's heads.  Returns the shards'
    (B, H/n, hd) outputs in shard order (the caller gathers them).  Port
    of the reference's `_shard_map_heads`."""
    from repro_torch.models.shard_hints import Shards

    arena = args[0]
    n = len(arena)
    if not isinstance(q, list):
        h = q.shape[1]
        _check(h % n == 0, f"H={h} heads do not divide {n} shards; the "
               "caller runs the unsharded dispatch instead", "shard_heads")
        w = h // n
        q = [q[:, i * w:(i + 1) * w] for i in range(n)]
    outs = []
    for i in range(n):
        dev = arena[i].device
        a = [x[i] if isinstance(x, list) else x.to(dev) for x in args]
        outs.append(call(q[i].to(dev).contiguous(), *a,
                         active=None if active is None else active.to(dev)))
    return Shards(outs, getattr(arena, "axis", "model"), 1)


def paged_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kpos: torch.Tensor, page_table: torch.Tensor,
                       qpos: torch.Tensor,
                       active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-query decode attention over a paged KV arena.

    q: (B, H, hd) pre-scaled by 1/sqrt(hd), heads kv-head-major; k/v:
    (P, ps, KVH, hd) global page arenas; kpos: (P, ps) int32 absolute
    positions (2^30 = never written); page_table: (B, MAXP) int32 (entries
    may repeat across lanes; unused ones name the trash page 0); qpos:
    (B,) int32; active: optional (B,) bool lane gate.  Returns (B, H, hd)
    in q.dtype; an inactive lane is exact zeros.

    On the card the kernel takes bf16 q/k/v, int32 kpos/page_table/qpos,
    contiguous, and hd in HEAD_DIMS; anything else raises.
    """
    if isinstance(k, list):  # a plan's kv-head shards
        return shard_heads(paged_flash_decode, q, k, v, kpos, page_table,
                           qpos, active=active)
    name = "paged_flash_decode"
    b, kvh, active = _decode_shapes(name, q, k, v, qpos, active)
    n_pages, ps = k.shape[:2]
    _check(tuple(kpos.shape) == (n_pages, ps), f"kpos {tuple(kpos.shape)}",
           name)
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           f"page_table {tuple(page_table.shape)}", name)
    if q.device.type == "cpu":
        return _ref.paged_flash_decode(q, k, v, kpos, page_table, qpos,
                                       active=active)
    _check_decode_cuda(name, torch.bfloat16, q=q, k=k, v=v, kpos=kpos,
                       page_table=page_table, qpos=qpos, active=active)
    out = torch.empty_like(q)
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kpos.data_ptr(), page_table.data_ptr(), qpos.data_ptr(),
            active.data_ptr(), out.data_ptr(), b, kvh, q.shape[1] // kvh,
            q.shape[2], ps, page_table.shape[1])
    return out


def paged_flash_decode_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         kpos: torch.Tensor, page_table: torch.Tensor,
                         qpos: torch.Tensor,
                         active: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Single-query decode attention over an int8 paged KV arena.

    As `paged_flash_decode`, with k/v (P, ps, KVH, hd) int8 and
    k_scale/v_scale (P, ps, KVH) f32 per-row per-kv-head scales
    (core/quant.kv_quantize).  Keys are dequantized as float(int8) *
    scale; scores, softmax and the PV product are f32 (p is not rounded).
    Returns (B, H, hd) in q.dtype; an inactive lane is exact zeros.

    On the card: bf16 q, int8 k/v, f32 scales, int32 kpos/page_table/qpos,
    contiguous, hd in HEAD_DIMS; anything else raises.  The kernel runs
    the bf16 kernels' schedule (DECODE_TILE-slot tiles skipped by kpos,
    DECODE_SPLITS blocks of one cluster), reading only the kept rows and
    their scales.
    """
    if isinstance(k, list):  # a plan's kv-head shards
        return shard_heads(paged_flash_decode_q, q, k, v, k_scale, v_scale,
                           kpos, page_table, qpos, active=active)
    name = "paged_flash_decode_q"
    b, kvh, active = _decode_shapes(name, q, k, v, qpos, active)
    n_pages, ps = k.shape[:2]
    for sname, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(tuple(sc.shape) == (n_pages, ps, kvh),
               f"{sname} {tuple(sc.shape)}: want {(n_pages, ps, kvh)}", name)
    _check(tuple(kpos.shape) == (n_pages, ps), f"kpos {tuple(kpos.shape)}",
           name)
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           f"page_table {tuple(page_table.shape)}", name)
    if q.device.type == "cpu":
        return _ref.paged_flash_decode_q(q, k, v, k_scale, v_scale, kpos,
                                         page_table, qpos, active=active)
    _check_decode_cuda(name, torch.int8, q=q, k=k, v=v, k_scale=k_scale,
                       v_scale=v_scale, kpos=kpos, page_table=page_table,
                       qpos=qpos, active=active)
    out = torch.empty_like(q)
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), kpos.data_ptr(),
            page_table.data_ptr(), qpos.data_ptr(), active.data_ptr(),
            out.data_ptr(), b, kvh, q.shape[1] // kvh, q.shape[2], ps,
            page_table.shape[1])
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kpos: torch.Tensor, qpos: torch.Tensor,
                 active: Optional[torch.Tensor] = None,
                 window: int = 0) -> torch.Tensor:
    """Single-query decode attention over a dense per-lane slot cache.

    q: (B, H, hd) pre-scaled, heads kv-head-major; k/v: (B, Sk, KVH, hd);
    kpos: (B, Sk) int32 absolute positions (2^30 = never written); qpos:
    (B,) int32; active: optional (B,) bool lane gate; window: sliding
    window width (0 = none; a key counts iff ``qpos - kpos < window``).
    Returns (B, H, hd) in q.dtype; an inactive lane is exact zeros.

    On the card: bf16 q/k/v, int32 kpos/qpos, contiguous, hd in
    FLASH_DECODE_HEAD_DIMS, any Sk >= 1 (the kernel masks the ragged last
    tile) and any group width (chunks of at most MAX_GROUP heads, each
    reading the kv head's rows).
    """
    name = "flash_decode"
    b, kvh, active = _decode_shapes(name, q, k, v, qpos, active)
    sk = k.shape[1]
    _check(k.shape[0] == b and tuple(kpos.shape) == (b, sk),
           f"k {tuple(k.shape)}, kpos {tuple(kpos.shape)}: want (B, Sk, "
           "KVH, hd) and (B, Sk)", name)
    _check(int(window) >= 0, f"window {window}", name)
    if q.device.type == "cpu":
        return _ref.flash_decode(q, k, v, kpos, qpos, active=active,
                                 window=int(window))
    _check_decode_cuda(name, torch.bfloat16, FLASH_DECODE_HEAD_DIMS, None,
                       q=q, k=k, v=v, kpos=kpos, qpos=qpos, active=active)
    out = torch.empty_like(q)
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kpos.data_ptr(), qpos.data_ptr(), active.data_ptr(),
            out.data_ptr(), b, kvh, q.shape[1] // kvh, q.shape[2], sk,
            int(window))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Prefill self-attention over contiguous positions 0..S-1.

    q: (B, S, H, hd) *unscaled* (the kernel multiplies the f32 score by
    1/sqrt(hd)); k/v: (B, S, KVH, hd), heads kv-head-major (query head h
    reads kv head h // (H / KVH)); causal: key j counts for query i iff
    j <= i.  Returns (B, S, H, hd) in q.dtype (`kernels/ref.py`
    flash_attention is the function).

    Forward only, on both devices: an input that requires grad raises
    while autograd records (torch.no_grad() turns recording off).
    The reference cannot differentiate through its Pallas kernel either
    (`jax.grad` fails in pallas_call's JVP rule), so a backward kernel
    belongs to the training slice, which keeps sequences <= 1024 on the
    dense route until then.

    On the card: q/k/v all bf16 or all f32, contiguous, 16-byte aligned,
    hd in FA_HEAD_DIMS; any S >= 1 (the kernel masks the ragged tile).
    """
    name = "flash_attention"
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
           "want (B, S, H, hd) and two equal (B, S, KVH, hd)", name)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    _check(k.shape[0] == b and k.shape[1] == s and k.shape[3] == hd
           and h % kvh == 0, f"q {tuple(q.shape)} vs k {tuple(k.shape)}: "
           "batch, length, head_dim or head groups disagree", name)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention is forward-only: no backward kernel exists "
            "until the training slice, and the JAX reference cannot "
            "differentiate through its Pallas kernel either (jax.grad "
            "fails in pallas_call's JVP rule); call it under "
            "torch.no_grad(), or train at S <= 1024 on the dense route")
    if q.device.type == "cpu":
        return _ref.flash_attention(q, k, v, causal=causal)
    dt = q.dtype
    _check(dt in (torch.bfloat16, torch.float32), f"q is {dt}, the kernel "
           "takes bf16 or float32", name)
    _check_cuda(name, dict(q=dt, k=dt, v=dt), q=q, k=k, v=v)
    _check(hd in FA_HEAD_DIMS, f"head_dim {hd} not in {FA_HEAD_DIMS}", name)
    for tname, t in (("q", q), ("k", k), ("v", v)):
        _check(t.data_ptr() % 16 == 0, f"{tname} is not 16-byte aligned",
               name)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, kvh, hd, int(dt == torch.bfloat16),
            int(bool(causal)))
    return out


def int8_matmul_split(m: int, n: int, k: int, sms: int) -> int:
    """Blocks of one cluster that share each output tile's K steps: the
    smallest power of two (at most INT8_MM_MAX_SPLIT) that gives `sms`
    blocks or more, as long as every block keeps a K step."""
    tiles = -(-m // INT8_MM_BM) * -(-n // INT8_MM_BN)
    steps = -(-k // INT8_MM_BK)
    split = 1
    while (split < INT8_MM_MAX_SPLIT and tiles * split < sms
           and 2 * split <= steps):
        split *= 2
    return split


def int8_matmul(a: torch.Tensor, b: torch.Tensor, s_a, s_b, s_out=None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """INT8 (M, K) @ INT8 (K, N) -> INT32 accumulators, plus an optional
    int32 bias (N,) at scale s_a*s_b; with `s_out`, requantized to INT8 at
    s_out (round half away from zero, clip to ±127).

    On the card: a int8 row-major (contiguous), bias int32 contiguous; b
    int8 of shape (K, N) stored column-major (``b.t()`` contiguous, as
    `models/ibert.py` keeps its weights) goes to the kernel as it is, and
    a row-major b takes one transposing copy first (the kernel reads both
    operands K-major); M, N, K of any size (the kernel masks ragged
    edges).
    """
    name = "int8_matmul"
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"a {tuple(a.shape)} @ b {tuple(b.shape)}: want (M, K) @ (K, N)",
           name)
    m, k = a.shape
    n = b.shape[1]
    _check(bias is None or tuple(bias.shape) == (n,),
           f"bias {None if bias is None else tuple(bias.shape)}: want ({n},)",
           name)
    if a.device.type == "cpu":
        return _ref.int8_matmul(a, b, s_a, s_b, bias=bias, s_out=s_out)
    bt = b.t()  # (N, K): row-major when b is column-major
    if not bt.is_contiguous() and b.is_contiguous():
        bt = bt.contiguous()
    tensors = {"a": a, "b": bt}
    dtypes = {"a": torch.int8, "b": torch.int8, "bias": torch.int32}
    if bias is not None:
        tensors["bias"] = bias
    _check_cuda(name, dtypes, **tensors)
    requant = s_out is not None
    out = torch.empty((m, n), dtype=torch.int8 if requant else torch.int32,
                      device=a.device)
    if out.numel() == 0:
        return out
    _launch(name, a.device, a.data_ptr(), bt.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m,
            n, k, _scale(s_a), _scale(s_b),
            _scale(s_out) if requant else 1.0, int(requant),
            int8_matmul_split(m, n, k, torch.cuda.get_device_properties(
                a.device).multi_processor_count))
    return out


def i_softmax(q: torch.Tensor, scale) -> torch.Tensor:
    """Integer softmax (I-BERT) over the last axis of int32 scores at
    float32 `scale` -> int32 probabilities at 2^-14, same shape.

    On the card: q int32 and contiguous.
    """
    name = "i_softmax"
    _check(q.dim() >= 1 and q.shape[-1] > 0, f"q {tuple(q.shape)}", name)
    if q.device.type == "cpu":
        return _ref.i_softmax_rows(q, scale)
    _check_cuda(name, {"q": torch.int32}, q=q)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    cols = q.shape[-1]
    _launch(name, q.device, q.data_ptr(), out.data_ptr(), q.numel() // cols,
            cols, _scale(scale))
    return out


def i_layernorm(q8: torch.Tensor, prep: LNParams):
    """Integer LayerNorm (I-BERT) over the last axis of int8-range int32
    values (or sums of two such) -> (int32 values, prep.s_out).

    On the card: q8, prep.q_gamma and prep.q_beta int32 and contiguous.
    """
    name = "i_layernorm"
    h = q8.shape[-1] if q8.dim() else 0
    _check(h > 0 and tuple(prep.q_gamma.shape) == (h,)
           and tuple(prep.q_beta.shape) == (h,),
           f"q8 {tuple(q8.shape)}, gamma {tuple(prep.q_gamma.shape)}, beta "
           f"{tuple(prep.q_beta.shape)}: want (..., H), (H,), (H,)", name)
    if q8.device.type == "cpu":
        return _ref.i_layernorm_rows(q8, prep.q_gamma, prep.q_beta), prep.s_out
    i32 = torch.int32
    _check_cuda(name, {"q8": i32, "q_gamma": i32, "q_beta": i32}, q8=q8,
                q_gamma=prep.q_gamma, q_beta=prep.q_beta)
    out = torch.empty_like(q8)
    if out.numel() == 0:
        return out, prep.s_out
    _launch(name, q8.device, q8.data_ptr(), prep.q_gamma.data_ptr(),
            prep.q_beta.data_ptr(), out.data_ptr(), q8.numel() // h, h)
    return out, prep.s_out


def i_gelu(q: torch.Tensor, scale) -> torch.Tensor:
    """Integer GELU (I-BERT), elementwise over int32 q at float32 `scale`
    -> int32 at the scale `core.ibert_ops.i_gelu` returns.

    On the card: q int32 and contiguous.
    """
    name = "i_gelu"
    if q.device.type == "cpu":
        return _ref.i_gelu_elem(q, scale)
    _check_cuda(name, {"q": torch.int32}, q=q)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(name, q.device, q.data_ptr(), out.data_ptr(), q.numel(),
            _scale(scale))
    return out


def _row_norm_launch(x: torch.Tensor, g: torch.Tensor,
                     b: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    name = "row_norm"
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check(x.dtype in (torch.bfloat16, torch.float32), f"x is {x.dtype}, "
           "the kernel takes bf16 or float32", name)
    f32 = torch.float32
    tensors, dtypes = {"x": x2, "g": g}, {"x": x.dtype, "g": f32, "b": f32}
    if b is not None:
        tensors["b"] = b
    _check_cuda(name, dtypes, **tensors)
    out = torch.empty_like(x2)
    if out.numel():
        geo = row_norm_geometry(d, x.dtype)
        _launch(name, x.device, x2.data_ptr(), g.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(),
                x2.shape[0], d, float(eps), int(x.dtype == torch.bfloat16),
                geo.threads, geo.slots, geo.block_rows)
    return out.view(x.shape)


class _RowNormFn(torch.autograd.Function):
    """The kernel's forward where autograd records (`fit_affine_lm` on the
    card).  The gradient is the plain version's, recomputed from the saved
    inputs: the reference differentiates its jnp norms through XLA, with
    no kernel behind them."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        ctx.save_for_backward(x, g, b)
        ctx.eps = eps
        return _row_norm_launch(x, g, b, eps)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:3]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = (_ref.rmsnorm(ins[0], ins[1], ctx.eps) if ins[2] is None
                 else _ref.layernorm(ins[0], ins[1], ins[2], ctx.eps))
        wrt = [t for t, n in zip(ins, need) if t is not None and n]
        grads = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(grads) if t is not None and n else None
                     for t, n in zip(ins, need)) + (None,)


def row_norm(x: torch.Tensor, g: torch.Tensor,
             b: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (b None) or LayerNorm (with bias b) over the last axis of x,
    in f32, returned in x's dtype: `kernels/ref.py` rmsnorm and layernorm.

    x: (..., D) bf16 or f32; g, b: (D,) f32.  On the card the kernel sums
    each row in an order fixed by (D, dtype) alone (`row_norm_geometry`;
    `ref.row_norm_schedule` repeats it), so a row gives the same bits
    in a tensor of any row count (a speculative verify pass and a decode
    step); x is taken contiguous (one copy first where it is not), g and
    b contiguous on x's device.  Differentiable: under autograd the
    gradient is the plain version's.
    """
    name = "row_norm"
    d = x.shape[-1] if x.dim() else 0
    _check(d > 0 and tuple(g.shape) == (d,)
           and (b is None or tuple(b.shape) == (d,)),
           f"x {tuple(x.shape)}, g {tuple(g.shape)}, b "
           f"{None if b is None else tuple(b.shape)}: want (..., D), (D,), "
           "(D,)", name)
    if x.device.type == "cpu":
        return (_ref.rmsnorm(x, g, eps) if b is None
                else _ref.layernorm(x, g, b, eps))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, g, b)):
        return _RowNormFn.apply(x, g, b, eps)
    return _row_norm_launch(x, g, b, eps)


# -- the K-ordered bf16 product (port-only) -----------------------------------


def _gemm_launch(x2: torch.Tensor, w: torch.Tensor, w_nk: bool,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    name = "gemm"
    if not (x2.is_cuda and w.device == x2.device and w.is_contiguous()
            and x2.dtype == w.dtype == torch.bfloat16):
        _check_cuda(name, dict(x=torch.bfloat16, w=torch.bfloat16), x=x2,
                    w=w)
    _check(out_dtype in (torch.bfloat16, torch.float32),
           f"out_dtype {out_dtype}: want bf16 or float32", name)
    m, k = x2.shape
    n = w.shape[0] if w_nk else w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m and n:
        _launch(name, x2.device, x2.data_ptr(), w.data_ptr(),
                out.data_ptr(), m, n, k, int(w_nk),
                int(out_dtype == torch.float32))
    return out


def gemm(x: torch.Tensor, w: torch.Tensor, w_nk: bool = False,
         out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w in bf16: w is (K, N), or (N, K) when w_nk (the tied
    embedding as the head).  Returns (..., N) bf16, f32 sums rounded once
    (out_dtype=torch.float32: the f32 sums, a shard's partial product).

    On the card the port-only `gemm` kernel sums every output in an order
    fixed by K alone (csrc/gemm.cu), so a row or a column block of the
    product is the same bits as in the whole product: a tensor-parallel
    shard's columns, a pipeline microbatch's rows and a verify pass's
    B*T rows equal one device's.  x is taken contiguous (a copy first
    where it is not), w contiguous on x's device.  The plain version on
    the CPU is torch.matmul on the shapes as given.  The kernel is
    forward-only: on the card it raises while autograd records
    (`layers.product` sends such products to torch.matmul)."""
    if not (x.dim() >= 1 and w.dim() == 2
            and x.shape[-1] == w.shape[1 if w_nk else 0]):
        raise ValueError(f"gemm: x {tuple(x.shape)} @ w {tuple(w.shape)} "
                         f"(w_nk={w_nk})")
    if x.device.type == "cpu":
        wk = w.t() if w_nk else w
        if out_dtype == torch.float32:
            return torch.matmul(x.float(), wk.float())
        return torch.matmul(x, wk)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("gemm: the kernel is forward-only; run "
                           "products that autograd records elsewhere")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _gemm_launch(x2, w.contiguous(), w_nk, out_dtype)
    return out.reshape(*lead, out.shape[-1])
