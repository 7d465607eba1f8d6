"""Kernel wrappers: dispatch by the tensors' device.

A CUDA tensor goes to the hand-written kernel, and any failure raises —
there is no fallback on the card.  A CPU tensor goes to the kernel's plain
PyTorch version in `kernels/ref.py`.  Each wrapper counts its kernel
launches in `launches` (plain integers), so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref

launches = {"paged_flash_decode": 0}

HEAD_DIMS = (16, 64, 128)  # the kernel's compiled head_dim instances
MAX_GROUP = 8  # query heads per kv head the kernel takes


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_FNS = {}


def _paged_flash_decode_fn():
    """The kernel's C entry point, built and bound at first use."""
    fn = _FNS.get("paged_flash_decode")
    if fn is None:
        from repro_torch.kernels.build import load

        fn = load("paged_flash_decode").paged_flash_decode_bf16
        # pointers and the stream as c_void_p: a bare int would be cut to
        # 32 bits
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS["paged_flash_decode"] = fn
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("paged_flash_decode: " + msg)


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
    b, h, hd = q.shape
    _check(k.dim() == 4 and k.shape == v.shape, f"k/v shapes {tuple(k.shape)}"
           f" {tuple(v.shape)}: want equal (P, ps, KVH, hd)")
    n_pages, ps, kvh, khd = k.shape
    _check(khd == hd and h % kvh == 0, f"q {tuple(q.shape)} vs k "
           f"{tuple(k.shape)}: head_dim or head groups disagree")
    _check(tuple(kpos.shape) == (n_pages, ps), f"kpos {tuple(kpos.shape)}")
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           f"page_table {tuple(page_table.shape)}")
    _check(tuple(qpos.shape) == (b,), f"qpos {tuple(qpos.shape)}")
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=q.device)
    _check(tuple(active.shape) == (b,), f"active {tuple(active.shape)}")
    if q.device.type == "cpu":
        return _ref.paged_flash_decode(q, k, v, kpos, page_table, qpos,
                                       active=active)
    _check(q.is_cuda, f"no kernel for device {q.device}")
    tensors = dict(q=q, k=k, v=v, kpos=kpos, page_table=page_table,
                   qpos=qpos, active=active)
    for name, t in tensors.items():
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), f"{name} is not contiguous")
    for name in ("q", "k", "v"):
        _check(tensors[name].dtype == torch.bfloat16,
               f"{name} is {tensors[name].dtype}, the kernel takes bf16")
    for name in ("kpos", "page_table", "qpos"):
        _check(tensors[name].dtype == torch.int32,
               f"{name} is {tensors[name].dtype}, the kernel takes int32")
    _check(active.dtype == torch.bool, f"active is {active.dtype}")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _check(h // kvh <= MAX_GROUP, f"group {h // kvh} > {MAX_GROUP}")
    for name in ("q", "k", "v"):
        _check(tensors[name].data_ptr() % 16 == 0,
               f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    err = _paged_flash_decode_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
             page_table.data_ptr(), qpos.data_ptr(), active.data_ptr(),
             out.data_ptr(), b, kvh, h // kvh, hd, ps, page_table.shape[1],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {err}")
    launches["paged_flash_decode"] += 1
    return out
