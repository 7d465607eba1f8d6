"""Deterministic op-level FLOP/byte accounting for the port's programs: the
counterpart of the reference's jaxpr counter (`repro/roofline/
jaxpr_cost.py`), over aten ops instead of jaxpr equations.

`count_costs(fn, *args)` runs ``fn(*args)`` under `FakeTensorMode`, on
fake CPU tensors (shapes and dtypes, no storage: a 400B-parameter
config counts on a laptop), inside a `TorchDispatchMode` that sees every
aten op the call dispatches.  The kernel wrappers (`kernels/ops.py`)
dispatch by the tensors' device, and a fake CPU tensor takes the plain
PyTorch version, so a kernel is counted through its plain version's ops.

Model, jaxpr_cost's, applied to aten ops:
  flops: mm / addmm / bmm / baddbmm / mv / dot = 2*M*N*K*batch;
         convolution = 2 * output elements * kernel taps * input channels;
         a `torch.einsum` is counted whole, as the reference's jnp.einsum
         lowers: each pairwise contraction (left to right) one product of
         2 * the sizes of every index its operands keep, the ops torch
         lowers it to uncounted.  torch lowers a contraction over size-1
         indices (a decode step's outer products, S = 1) to an
         elementwise mul, which the aten rule would leave out.
  bytes (fused, the roofline memory term): a product's operands plus its
         result (an einsum's pairwise intermediates included); index /
         gather / embedding ops 2x their output;
         index_put_ / scatter / slice copies (copy_ into a view) 2x the
         moved update; cat / pad / sort / cumsum / topk 2x their output.
         Elementwise chains are assumed fused into their producers.
  bytes_unfused (upper bound, reported alongside): every other op's
         outputs as one write as well.
  views (view, permute, select, slice, expand, ...) are free.

The reference's scan terms (each scan carry's round trip a layer, and
the scan's stacked cache outputs written once, `jaxpr_cost.py:111-121`)
have no counterpart: the port runs its layer stack as a Python loop and
writes each new cache row in place (an index_put_ or a slice copy of the
row, 2x the row), so those terms are absent from its byte counts.  FLOPs
equal the reference's ref-impl counts; the bytes part by these terms and
by the plain versions' operand dtypes (tests/op_cost_cases.py).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
             "convolution"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
# op name -> position of the moved update among the op's arguments
_SCATTERS = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_add": 3, "index_add_": 3, "index_copy": 3,
             "index_copy_": 3, "slice_scatter": 1, "select_scatter": 1,
             "copy_": 1}
_MATERIALIZE = {"cat", "constant_pad_nd", "pad", "sort", "cumsum",
                "cumprod", "cummax", "logcumsumexp", "flip", "topk"}
_VIEWS = {"_unsafe_view", "lift_fresh"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _product_flops(name: str, args, out: torch.Tensor) -> int:
    if name == "convolution":
        w = args[1]  # (out channels, in channels / groups, *taps)
        return 2 * out.numel() * w[0].numel()
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]  # the added term first
    a, b = args[0], args[1]  # (batch, M, K) x (batch, K, N), or 1-d
    n = 1 if b.dim() == 1 else int(b.shape[-1])
    return 2 * a.numel() * n


def _einsum_costs(eq: str, operands) -> tuple:
    """(flops, bytes) of an explicit einsum (``"ij,jk->ik"``, no
    ellipsis), contracted pairwise left to right.  Before each pair, an
    index of one operand that neither the other operand nor anything
    after needs is summed out (a reduction, no flops)."""
    ins, out = eq.replace(" ", "").split("->")
    terms = ins.split(",")
    size = {}
    for t, x in zip(terms, operands):
        size.update(zip(t, (int(d) for d in x.shape)))

    def nbytes(idx, itemsize):
        n = itemsize
        for c in idx:
            n *= size[c]
        return n

    flops = byts = 0
    cur, cur_item = terms[0], operands[0].element_size()
    for j in range(1, len(terms)):
        nxt, item = terms[j], operands[j].element_size()
        later = set(out).union(*terms[j + 1:])
        a = "".join(c for c in cur if c in later or c in nxt)
        b = "".join(c for c in nxt if c in later or c in a)
        keep = "".join(dict.fromkeys(a + b))
        prod = 1
        for c in keep:
            prod *= size[c]
        res = "".join(c for c in keep if c in later)
        res_item = max(cur_item, item)
        flops += 2 * prod
        byts += (nbytes(a, cur_item) + nbytes(b, item)
                 + nbytes(res, res_item))
        cur, cur_item = res, res_item
    return flops, byts


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.acc = {"flops": 0.0, "bytes": 0.0, "bytes_unfused": 0.0}
        self.muted = False  # inside an einsum, counted whole

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.muted:
            return out
        name = func.overloadpacket.__name__
        acc = self.acc
        outs = _tensors(out)
        if name in _PRODUCTS:
            b = sum(_nbytes(t) for t in _tensors(args)) + _nbytes(outs[0])
            acc["flops"] += _product_flops(name, args, outs[0])
            acc["bytes"] += b
            acc["bytes_unfused"] += b
        elif name in _SCATTERS:
            upd = args[_SCATTERS[name]] if len(args) > _SCATTERS[name] \
                else kwargs.get("src", kwargs.get("values"))
            b = 2 * _nbytes(upd)
            acc["bytes"] += b
            acc["bytes_unfused"] += b
        elif name in _GATHERS or name in _MATERIALIZE:
            b = 2 * sum(_nbytes(t) for t in outs)
            acc["bytes"] += b
            acc["bytes_unfused"] += b
        elif not (func.is_view or name in _VIEWS):
            # elementwise / reduction / cast: fuses in the optimistic
            # model, one write in the unfused bound
            acc["bytes_unfused"] += sum(_nbytes(t) for t in outs)
        return out


class _Einsums(TorchFunctionMode):
    """Counts each explicit `torch.einsum` whole (`_einsum_costs`) and
    mutes the dispatch counter while torch runs it."""

    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is not torch.einsum or self.counter.muted or kwargs
                or "->" not in args[0] or "." in args[0]):
            return func(*args, **kwargs)
        eq, ops = args[0], args[1:]
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        flops, byts = _einsum_costs(eq, ops)
        self.counter.muted = True
        try:
            out = func(*args, **kwargs)
        finally:
            self.counter.muted = False
        acc = self.counter.acc
        acc["flops"] += flops
        acc["bytes"] += byts
        acc["bytes_unfused"] += byts
        return out


def fake_mode() -> FakeTensorMode:
    """A mode to build a count's inputs in (``with mode: params =
    init_params(cfg, device="cpu")``): its tensors hold no storage."""
    return FakeTensorMode()


def count_costs(fn, *args) -> Dict[str, float]:
    """Run fn(*args) on fake CPU tensors and count its global flops and
    bytes: {"flops", "bytes", "bytes_unfused"}.  Tensors of ``args`` (any
    nesting of lists, tuples and dicts) that are real are faked; fake
    ones, built under `fake_mode()`, are counted in their own mode."""
    leaves = _tensors(args)
    mode = next((t.fake_mode for t in leaves if isinstance(t, FakeTensor)),
                None) or FakeTensorMode()
    args = pytree.tree_map_only(
        torch.Tensor,
        lambda t: t if isinstance(t, FakeTensor) else mode.from_tensor(t),
        args)
    counter = _Counter()
    with mode, counter, _Einsums(counter):
        fn(*args)
    return counter.acc
