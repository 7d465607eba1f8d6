"""Optimizers: AdamW, SGD with momentum, and int8-state AdamW (port of
`repro/optim/optimizer.py`).

`make_optimizer(name, lr_fn) -> (init, update)`.  States are dicts that
mirror the params, as the reference's pytrees do, so a plan's param specs
place them alike (`launch/train.opt_state_specs`).  `update(grads, state,
params, wd)` returns new params and a new state and leaves its arguments
untouched; it does its arithmetic in f32 and casts each param back to its
dtype, as the reference's does.  The step count is a 0-d int32 tensor on
the params' device, so an update never waits for the host.

adamw8 keeps both Adam moments block-quantized to int8 along each leaf's
last dim (`_leaf_block`, `_bq`, `_bdq`: one f32 scale per block, the
leaf's own shape, so its state shards as its param does).  Rounding is
`torch.round` (half to even), as `jnp.round`.

Dict leaves are visited in sorted-key order, the order `jax.tree.leaves`
takes, so `global_norm` adds the leaves' squares as the reference does.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch.optim.compression import BLOCK

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def tree_map(fn, *trees):
    """fn over the leaves of dicts of the same keys (a leaf is anything
    that is not a dict of the first tree), visited in sorted-key order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a dict tree in sorted-key order (`jax.tree.leaves`'
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to base_lr over `warmup` steps, then a cosine decay
    to 0 at `total`; of a step tensor, as an f32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return _sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """(grads in f32 scaled to a global norm of at most max_norm, the
    norm before scaling)."""
    norm = global_norm(grads)
    # a true division (a Python number over a tensor is its reciprocal
    # times the number in torch)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as `jnp.sqrt` gives it: on
    the CPU through f64, since torch's vectorized f32 kernel there rounds
    about 0.7% of inputs the other way (the card's is exact)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _corrections(step):
    t = step.float()
    return 1 - torch.pow(torch.tensor(B1, device=t.device), t), \
        1 - torch.pow(torch.tensor(B2, device=t.device), t)


def _split(out, n):
    """A tree of per-leaf n-tuples -> n trees."""
    return tuple(tree_map(lambda o: o[i], out) for i in range(n))


# -- f32-state AdamW ---------------------------------------------------------


def adamw(lr_fn):
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, wd: float = WD):
        step = state["step"] + 1
        lr = lr_fn(step)
        bc1, bc2 = _corrections(step)

        def upd(g, m, v, p):
            g = g.float()
            m = B1 * m + (1 - B1) * g
            v = B2 * v + (1 - B2) * g * g
            u = (m / bc1) / (_sqrt(v / bc2) + EPS)
            u = u + wd * p.float()
            return (p.float() - lr * u).to(p.dtype), m, v

        new_p, new_m, new_v = _split(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return init, update


# -- int8-state AdamW --------------------------------------------------------


def _leaf_block(last_dim: int, block: int = BLOCK) -> int:
    """Largest power-of-two block <= BLOCK dividing the last dim."""
    b = block
    while b > 1 and last_dim % b:
        b //= 2
    return b


def _bq(x: torch.Tensor):
    """Block quantization along the last dim, keeping the leaf's shape:
    (int8 q of x's shape, f32 scales (..., last // block))."""
    last = x.shape[-1]
    b = _leaf_block(last)
    xb = x.reshape(*x.shape[:-1], last // b, b)
    scale = torch.clamp(xb.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale.squeeze(-1).float()


def _bdq(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    last, nblk = q.shape[-1], scale.shape[-1]
    xb = q.float().reshape(*q.shape[:-1], nblk, last // nblk)
    return (xb * scale[..., None]).reshape(q.shape)


def adamw8(lr_fn):
    def init(params):
        def z(p):
            shape = tuple(p.shape) if p.dim() else (1,)
            b = _leaf_block(shape[-1])
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(shape[:-1] + (max(shape[-1], 1) // b,),
                                     dtype=torch.float32, device=p.device)}

        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, wd: float = WD):
        step = state["step"] + 1
        lr = lr_fn(step)
        bc1, bc2 = _corrections(step)

        def upd(g, mq, vq, p):
            shape = tuple(p.shape) if p.dim() else (1,)
            g = g.float().reshape(shape)
            m = B1 * _bdq(mq["q"], mq["s"]) + (1 - B1) * g
            v = B2 * _bdq(vq["q"], vq["s"]) + (1 - B2) * g * g
            v = torch.clamp(v, min=0.0)
            u = (m / bc1) / (_sqrt(v / bc2) + EPS)
            u = u + wd * p.float().reshape(shape)
            newp = (p.float().reshape(shape) - lr * u).to(p.dtype)
            return (newp.reshape(p.shape), dict(zip(("q", "s"), _bq(m))),
                    dict(zip(("q", "s"), _bq(v))))

        # a grad leaf meets its {"q", "s"} moments whole
        new_p, new_m, new_v = _split(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return init, update


def sgdm(lr_fn, momentum: float = 0.9):
    def init(params):
        return {"m": tree_map(_zeros_f32, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params, wd: float = 0.0):
        step = state["step"] + 1
        lr = lr_fn(step)

        def upd(g, m, p):
            m = momentum * m + g.float()
            return (p.float() - lr * m).to(p.dtype), m

        new_p, new_m = _split(tree_map(upd, grads, state["m"], params), 2)
        return new_p, {"m": new_m, "step": step}

    return init, update


def make_optimizer(name: str, lr_fn) -> Tuple[Callable, Callable]:
    return {"adamw": adamw, "adamw8": adamw8, "sgdm": sgdm}[name](lr_fn)
