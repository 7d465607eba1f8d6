"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: each test skips without a CUDA device; run them on
a machine with one (and nvcc) with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bf16 outputs in (-1, 1) agree to 1e-2 (a few ulps: the kernel
and the plain version sum scores and p @ V in different orders).
Inactive lanes are exact zeros on both.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

SENTINEL = 2 ** 30

pytestmark = pytest.mark.cuda


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
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 1e-2, err
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
