"""Optimizers: AdamW, SGD with momentum, and int8-state AdamW (port of
`repro/optim/optimizer.py`).

`make_optimizer(name, lr_fn) -> (init, update)`.  States are dicts that
mirror the params, as the reference's pytrees do, so a plan's param specs
place them alike (`launch/train.opt_state_specs`).  `update(grads, state,
params, wd)` returns new params and a new state and leaves its arguments
untouched; it does its arithmetic in f32 and casts each param back to its
dtype, as the reference's does.  The step count is a 0-d int32 tensor on
the params' device, so an update never waits for the host.  Each
update carries its leaf-at-a-time form (`update.leafwise`, a `Leafwise`),
which a train plan's step runs on every block of a sharded leaf.

adamw8 keeps both Adam moments block-quantized to int8 along each leaf's
last dim (`_leaf_block`, `bq_cols`, `bdq_cols`: one f32 scale per block, the
leaf's own shape, so its state shards as its param does).  Rounding is
`torch.round` (half to even), as `jnp.round`.

Dict leaves are visited in sorted-key order, the order `jax.tree.leaves`
takes, so `global_norm` adds the leaves' squares as the reference does.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

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


class Leafwise(NamedTuple):
    """An optimizer's update one leaf at a time, which its tree `update`
    runs over every leaf and a train plan's step over every block
    (launch/train.py): consts(step, wd) -> the step's constants;
    leaf(g, moments, p, consts) -> (new p, new moments) with the moments
    in f32; moments: the state's moment keys; blocked: the moments are
    stored as adamw8's int8 blocks along the last dim (`bq_cols`)."""
    consts: Callable
    leaf: Callable
    moments: Tuple[str, ...]
    wd: float
    blocked: bool = False


def _update(lw: Leafwise, grads, state, params, wd: float):
    step = state["step"] + 1
    k = lw.consts(step, wd)

    def upd(g, p, *moms):
        if lw.blocked:  # a grad leaf meets its {"q", "s"} moments whole
            b = _leaf_block(moms[0]["q"].shape[-1])
            moms = [bdq_cols(m["q"], m["s"], 0, b) for m in moms]
        newp, new = lw.leaf(g, moms, p, k)
        if lw.blocked:
            new = [dict(zip(("q", "s"), bq_cols(m, block_amax_cols(
                m, 0, b, m.shape[-1] // b), 0, b))) for m in new]
        return (newp,) + tuple(new)

    out = _split(tree_map(upd, grads, params,
                          *(state[n] for n in lw.moments)),
                 1 + len(lw.moments))
    return out[0], {**dict(zip(lw.moments, out[1:])), "step": step}


def _optimizer(init, lw: Leafwise):
    """(init, update): update(grads, state, params, wd=lw.wd) -> (new
    params, new state), the step's arithmetic in f32 and each param cast
    back to its dtype; `update.leafwise` is lw."""
    @torch.no_grad()
    def update(grads, state, params, wd: float = lw.wd):
        return _update(lw, grads, state, params, wd)

    update.leafwise = lw
    return init, update


def _adam_consts(lr_fn):
    def consts(step, wd):
        bc1, bc2 = _corrections(step)
        return lr_fn(step), bc1, bc2, wd
    return consts


# -- f32-state AdamW ---------------------------------------------------------


def _adamw_leaf(g, moms, p, k):
    lr, bc1, bc2, wd = k
    m, v = moms
    g = g.float()
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    u = (m / bc1) / (_sqrt(v / bc2) + EPS)
    u = u + wd * p.float()
    return (p.float() - lr * u).to(p.dtype), (m, v)


def adamw(lr_fn):
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params), "step": _step0(params)}

    return _optimizer(init, Leafwise(_adam_consts(lr_fn), _adamw_leaf,
                                     ("m", "v"), WD))


# -- int8-state AdamW --------------------------------------------------------


def _leaf_block(last_dim: int, block: int = BLOCK) -> int:
    """Largest power-of-two block <= BLOCK dividing the last dim."""
    b = block
    while b > 1 and last_dim % b:
        b //= 2
    return b


# The int8 block format, on a block of a leaf's columns [c0, c0 + width)
# (c0 = 0 over the whole leaf): the quantization blocks are the whole
# leaf's (b = `_leaf_block` of the whole last dim), so that a shard's
# edge may fall inside one, and a column's value is the same whether the
# leaf is whole or cut (a train plan's step requantizes at each block's
# max over the shards that hold it).


def _col_blocks(c0: int, width: int, b: int, device) -> torch.Tensor:
    return torch.arange(c0, c0 + width, device=device) // b


def bdq_cols(q: torch.Tensor, s: torch.Tensor, c0: int,
             b: int) -> torch.Tensor:
    """Dequantized columns [c0, ...) of a leaf: q (..., width), s the
    rows' scales over the whole last dim (..., nblk)."""
    return q.float() * s[..., _col_blocks(c0, q.shape[-1], b, q.device)]


def block_amax_cols(x: torch.Tensor, c0: int, b: int,
                    nblk: int) -> torch.Tensor:
    """max |x| of the columns [c0, ...) that fall in each quantization
    block, (..., nblk), 0 in blocks without such a column."""
    idx = _col_blocks(c0, x.shape[-1], b, x.device).expand(x.shape)
    out = torch.zeros(x.shape[:-1] + (nblk,), dtype=torch.float32,
                      device=x.device)
    return out.scatter_reduce(-1, idx, x.abs(), "amax")


def bq_cols(x: torch.Tensor, amax: torch.Tensor, c0: int, b: int):
    """Columns [c0, ...) of a leaf quantized at the whole rows' block
    maxima amax (..., nblk): (int8 q of x's shape, f32 scales (...,
    nblk)); round half to even, as `jnp.round`."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    cols = scale[..., _col_blocks(c0, x.shape[-1], b, x.device)]
    q = torch.clamp(torch.round(x / cols), -127, 127).to(torch.int8)
    return q, scale


def _adamw8_leaf(g, moms, p, k):
    lr, bc1, bc2, wd = k
    shape = tuple(p.shape) if p.dim() else (1,)
    g = g.float().reshape(shape)
    m = B1 * moms[0] + (1 - B1) * g
    v = B2 * moms[1] + (1 - B2) * g * g
    v = torch.clamp(v, min=0.0)
    u = (m / bc1) / (_sqrt(v / bc2) + EPS)
    u = u + wd * p.float().reshape(shape)
    newp = (p.float().reshape(shape) - lr * u).to(p.dtype)
    return newp.reshape(p.shape), (m, v)


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

    return _optimizer(init, Leafwise(_adam_consts(lr_fn), _adamw8_leaf,
                                     ("m", "v"), WD, blocked=True))


def sgdm(lr_fn, momentum: float = 0.9):
    def init(params):
        return {"m": tree_map(_zeros_f32, params), "step": _step0(params)}

    def consts(step, wd):
        return lr_fn(step), wd

    def leaf(g, moms, p, k):
        m = momentum * moms[0] + g.float()
        return (p.float() - k[0] * m).to(p.dtype), (m,)

    return _optimizer(init, Leafwise(consts, leaf, ("m",), 0.0))


def make_optimizer(name: str, lr_fn) -> Tuple[Callable, Callable]:
    return {"adamw": adamw, "adamw8": adamw8, "sgdm": sgdm}[name](lr_fn)
