"""Training entry point: the step factories and the fault-tolerant CLI
loop (port of `repro/launch/train.py`).

`make_train_step` builds one training step: loss, gradients by
torch.autograd through `Model.loss` (each layer period recomputed in the
backward pass under `make_model`'s remat), clipping by the global norm,
and the optimizer's update, with gradient accumulation over `n_micro`
microbatches into f32 buffers.  The CLI loop adds the reference's
substrate: the seeded data pipeline (`data/pipeline.py`), async
checkpoints (`checkpoint/`), failure injection with recovery from the
last checkpoint and straggler monitoring (`runtime/`).

On the card, the forward's norms run the `row_norm` kernel (its gradient
is the plain version's, `kernels/ops._RowNormFn`); every product that
autograd records runs in torch.matmul, and the attention at S <= 1,024 on
the dense route.  Past that, a contiguous sequence would reach the
forward-only `flash_attention` kernel, which has no backward (nor has
the reference's Pallas kernel a VJP), so the CLI refuses --seq above
1,024 on the card unless --pack gives the batch explicit positions (the
dense or KV-chunked route, plain torch).

`jit_train_step` is the step over a ``mode="train"`` plan (the
reference's name; nothing is jitted), single-controller like the serve
plans: one process drives every shard of a `launch/mesh.DeviceMesh`, and
the collectives are `core/gmi.py`'s copies, concatenations and sums in
shard order.  Each leaf of the master params, its f32 gradient and
accumulator and its optimizer state is held as per-flat-shard blocks
(`cluster_builder.Sharded`), cut over `model` as `cluster_builder.tp_cut`
says (the serving executor's rule) and over the data axes as the plan's
FSDP spec says (`train_param_specs`, `opt_state_specs`).  One step:

  * gather: each leaf's FSDP blocks over the data axes to each replica's
    tensor-parallel blocks (`gmi.allgather_dim`; int8 q and f32 scales
    under ``hints(int8_gather=True)``, `shard_hints.fsdp_int8_gather`);
  * forward: each data replica runs `Model.loss_terms` on its rows with
    its blocks as `Shards` (the model code the serve plans run: column
    blocks, `project_out`'s psum form for a row-cut reduction, a
    vocab-cut embedding and head, the experts by block), in a training
    hints context that publishes no serving plan;
  * the global batch's loss: the cross-entropy's sums and the MoE
    routers' (E,) sums added over the replicas before the division and
    the load-balance product (`shard_hints.router_stats`), in one
    autograd graph, so the gradients are the global loss's;
  * gradients of each replica's blocks, reduced over the data axes in
    shard order in f32 (`gmi.reduce_scatter_dim` back to each FSDP block,
    `gmi.allreduce` where a leaf is not cut over data): the exact SPMD
    sum of the reference, not `compressed_psum`; over `n_micro`
    microbatches (each the one-device step's rows of the global batch)
    added into f32 blocks held as the params are;
  * clipping by the global norm, each distinct block counted once;
  * the optimizer's update per block (`optim.Leafwise`), adamw8's
    requantization taking a block's max over the shards that hold it.

Runs on the CUDA device unless ``--device cpu`` is given; without a card
it stops with an error instead of falling back to the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 60 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --batch 8 --seq 512 --steps 30 --ckpt-every 10 --inject-failure-at 15
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import gmi
from repro_torch.core.cluster_builder import (Sharded, block_kind,
                                              spec_axes, tp_cut)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import shard_hints
from repro_torch.models.attention import DENSE_ATTN_MAX_KV
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import Model, init_params, make_model
from repro_torch.optim.optimizer import (_leaf_block, _sqrt,
                                         block_amax_cols, bdq_cols, bq_cols,
                                         clip_by_global_norm,
                                         cosine_schedule, make_optimizer,
                                         tree_leaves, tree_map)
from repro_torch.runtime import (FailureInjector, StragglerMonitor,
                                 run_with_recovery)

log = logging.getLogger("repro_torch.train")


def pick_optimizer(cfg) -> str:
    """adamw8 (int8 moments) for models whose f32 Adam state would not fit
    under full FSDP, f32 AdamW otherwise (the reference's rule)."""
    return "adamw8" if cfg.param_count() > 50e9 else "adamw"


def _grads(model: Model, params, batch):
    """(loss, gradients in the params' layout and dtypes)."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = model.loss(ps, batch)
    got = iter(torch.autograd.grad(loss, tree_leaves(ps)))
    return loss.detach(), tree_map(lambda p: next(got), ps)


def make_train_step(model: Model, opt_update, max_grad_norm: float = 1.0,
                    n_micro: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}: 0-d f32 tensors).  n_micro > 1 splits the
    batch's leading dim into n_micro microbatches, adds their gradients
    into f32 buffers and their losses into an f32 sum, and divides both by
    n_micro, as the reference's scan does."""

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = _grads(model, params, batch)
        else:
            mb = next(iter(batch.values())).shape[0] // n_micro
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for j in range(n_micro):
                part = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
                lj, gj = _grads(model, params, part)
                grads = tree_map(lambda a, b: a + b.float(), grads, gj)
                loss = loss + lj
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.float(),
                                   "grad_norm": gnorm.float()}

    return train_step


def default_micro_batches(cfg, global_batch: int, seq_len: int, dp: int,
                          act_budget_bytes: float = 0) -> int:
    """Smallest microbatch count (dividing the per-replica batch) that keeps
    remat-saved per-layer activations under the budget (a larger budget
    for MoE models, as the reference's)."""
    if not act_budget_bytes:
        act_budget_bytes = 12e9 if cfg.n_experts else 4e9
    b_loc = max(global_batch // dp, 1)
    per_row = seq_len * cfg.d_model * 2 * max(cfg.n_layers, 1)
    mb_loc = max(1, int(act_budget_bytes // max(per_row, 1)))
    n = max(1, -(-b_loc // mb_loc))
    while b_loc % n:
        n += 1
    return min(n, b_loc)


def opt_state_specs(opt_state_shape, param_specs, mesh=None) -> Any:
    """Optimizer-state specs (`core/cluster_builder` spec tuples), the
    reference's rule: f32 moments mirror their parameter; an int8 moment's
    `q` shards as its parameter and its per-block scale `s` drops the last
    (blocked) axis' assignment; scalars replicate."""
    def P(*parts):
        return tuple(parts)

    def blk_spec(sub, spec_sub):
        if not hasattr(spec_sub, "__len__") or len(spec_sub) != sub["q"].ndim:
            return {"q": P(), "s": P()}
        return {"q": spec_sub, "s": P(*(tuple(spec_sub[:-1]) + (None,)))}

    def go(sub, spec_sub):
        if isinstance(sub, dict) and "q" in sub and "s" in sub:
            return blk_spec(sub, spec_sub)
        if isinstance(sub, dict):
            return {k: go(v, spec_sub.get(k) if isinstance(spec_sub, dict)
                          else spec_sub) for k, v in sub.items()}
        if spec_sub is None or not hasattr(sub, "shape") or sub.ndim == 0:
            return P()
        return spec_sub if sub.ndim == len(spec_sub) else P()

    out = {}
    for key, sub in opt_state_shape.items():
        if key in ("m", "v"):
            out[key] = go(sub, param_specs)
        else:
            out[key] = tree_map(lambda _: P(), sub)
    return out


# ---------------------------------------------------------------------------
# The step over a mode="train" plan
# ---------------------------------------------------------------------------


def _tree_paths(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _tree_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def train_param_specs(plan, params_shape) -> Any:
    """The port's placement of a mode="train" plan's params (a tree of
    spec tuples): the plan's specs (the reference's), with each leaf's
    tensor-parallel cut moved where `cluster_builder.tp_cut` puts it (an
    attention block whose heads do not divide the axis whole on each
    replica's controller, the recurrent cells' departures), each
    departure a note in `plan.notes`; the FSDP cut over the data axes
    kept."""
    specs = plan.specs_for_params(params_shape)
    tp, dp = plan.axes.tp, set(plan.axes.dp)
    n = plan.mesh.shape[tp]

    def note(msg):
        if msg and msg not in plan.notes:
            plan.notes.append(msg)

    def place(path, leaf):
        spec = _at(specs, path)
        tdim = next((d for d, e in enumerate(spec) if tp in spec_axes(e)),
                    None)
        fdim = next((d for d, e in enumerate(spec)
                     if dp & set(spec_axes(e))), None)
        tdim, msg = tp_cut(plan.cfg, n, tp, path, tuple(leaf.shape), tdim,
                           whole=" whole on each data replica's controller")
        note(msg)
        out = [None] * len(spec)
        if fdim is not None and fdim == tdim:
            note(f"plan: {'/'.join(path)} cut over '{tp}' on dim {tdim}, "
                 "not over the data axes there")
        elif fdim is not None:
            out[fdim] = spec[fdim]
        if tdim is not None:
            out[tdim] = tp
        return tuple(out)

    return _tree_paths(params_shape, place)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def plan_shardings(plan, specs) -> Any:
    """A tree of `cluster_builder.Sharding` on the plan's mesh from a
    tree of specs: `place`'s and `CheckpointManager.restore`'s."""
    return tree_map(plan.sharding, specs)


def place(tree, shardings) -> Any:
    """Each leaf cut onto the mesh (`Sharding.place`); a leaf already
    placed stays as it is."""
    return tree_map(lambda t, sh: t if isinstance(t, Sharded)
                    else sh.place(t), tree, shardings)


def int8_gathered(cfg, path) -> bool:
    """Does the model pass the leaf at `path` through
    `shard_hints.fsdp_int8_gather`?  Its call sites are the reference's:
    an attention block's wq, wk, wv, wo (models/attention.py), an MLP's
    and the routed experts' wi, wg, wo (models/layers.py `mlp`,
    models/moe.py `_experts`); not the shared experts, the router, the
    recurrent mixers, the embeddings or the norms."""
    if len(path) < 2:
        return False
    if path[-2] == "mix":
        return (block_kind(cfg, path) == "attn"
                and path[-1] in ("wq", "wk", "wv", "wo"))
    return path[-2] == "ffn" and path[-1] in ("wi", "wg", "wo")


def _dims(leaf: Sharded, tp: str, dp) -> tuple:
    """(the tensor-parallel dim, the FSDP dim and its axes) of a placed
    leaf (None where it is not cut)."""
    tdim = fdim = None
    faxes = ()
    for d, e in enumerate(leaf.spec):
        axes = spec_axes(e)
        if tp in axes:
            tdim = d
        elif set(axes) & set(dp):
            fdim, faxes = d, axes
    return tdim, fdim, faxes


def _shared(xs: List[torch.Tensor], like: Sharded) -> List[torch.Tensor]:
    """xs held as `like` is: the shards that hold one block on one device
    share the first one's tensor."""
    out = list(xs)
    for fs in like.owners().values():
        for f in fs[1:]:
            out[f] = out[fs[0]]
    return out


def _data_reduce(gs, leaf: Sharded, mesh, tp: str,
                 dp) -> List[torch.Tensor]:
    """Each flat shard's gradient of its tensor-parallel block (f32) ->
    its FSDP block's, summed over the data replicas in shard order."""
    _, fdim, faxes = _dims(leaf, tp, dp)
    if fdim is not None:
        gs = gmi.reduce_scatter_dim(gs, mesh, faxes, fdim)
    rest = tuple(a for a in dp if a not in faxes)
    if rest:
        gs = gmi.allreduce(gs, mesh, rest)
    return _shared(gs, leaf)


def _replica_rows(batch, mesh, dp, replicas) -> List[Dict[str, Any]]:
    """Each data replica's rows of the batch, on its controller: a leaf
    placed by `shard_batch` gives its blocks, a whole tensor is cut into
    equal contiguous blocks."""
    n = len(replicas)
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in batch.items():
        if isinstance(v, Sharded) and v.spec and set(
                spec_axes(v.spec[0])) == set(dp):
            for r, g in enumerate(replicas):
                out[r][k] = v[g[0]]
            continue
        t = v.join() if isinstance(v, Sharded) else torch.as_tensor(v)
        if t.shape[0] % n:
            raise ValueError(f"jit_train_step: batch '{k}' of {t.shape[0]} "
                             f"rows does not divide over {n} data replicas")
        w = t.shape[0] // n
        for r, g in enumerate(replicas):
            out[r][k] = t[r * w:(r + 1) * w].to(mesh.device(g[0]))
    return out


def _micro(rows, j: int, n_micro: int, mesh, replicas):
    """Replica r's rows of microbatch j: the one-device step's microbatch
    j is rows [j mb, (j + 1) mb) of the global batch, and replica r takes
    its r-th block of them, block k = j * n + r of the global batch's
    (B / n_micro / n)-row blocks, held by replica k // n_micro."""
    if n_micro == 1:
        return rows
    n = len(replicas)
    out = []
    for r, g in enumerate(replicas):
        k = j * n + r
        src = rows[k // n_micro]
        w = next(iter(src.values())).shape[0] // n_micro
        o = (k % n_micro) * w
        out.append({key: t[o:o + w].to(mesh.device(g[0]))
                    for key, t in src.items()})
    return out


def _global_aux(stats, e: int, root) -> torch.Tensor:
    """The MoE layers' load-balance loss over the global batch: per router
    call, e * sum_e me_e * ce_e from the replicas' sums (in replica
    order), summed over the calls in order."""
    aux = None
    for calls in zip(*stats):
        probs = calls[0][0].to(root)
        top1 = calls[0][1].to(root)
        tokens = calls[0][2]
        for p, c, t in calls[1:]:
            probs, top1, tokens = probs + p.to(root), top1 + c.to(root), \
                tokens + t
        a = e * torch.sum((probs / tokens) * (top1 / tokens))
        aux = a if aux is None else aux + a
    return aux


def _update_placed(opt_update, grads, opt_state, params, mesh):
    """The optimizer's update over placed trees, per distinct block (the
    shards that hold one block on one device share it): each block's
    elementwise update equals the whole leaf's there, bit for bit; a
    blocked (adamw8) moment is dequantized and requantized at the whole
    leaf's quantization blocks, each block's max taken over the shards
    that hold a part of it (`gmi.allgather` over the axes that cut the
    last dim)."""
    lw = opt_update.leafwise
    steps = opt_state["step"]
    new_step = Sharded(shard_hints.per_part(lambda s: s + 1, steps),
                       steps.sharding)
    k0 = lw.consts(new_step[0], lw.wd)
    consts: Dict[str, tuple] = {}

    def on(dev):
        if str(dev) not in consts:
            consts[str(dev)] = tuple(c.to(dev) if torch.is_tensor(c) else c
                                     for c in k0)
        return consts[str(dev)]

    moms = lw.moments

    def leaf(path, p: Sharded):
        g = _at(grads, path)
        state = [_at(opt_state[m], path) for m in moms]
        owners = p.owners()
        new_p = [None] * len(p)
        new_m = [[None] * len(p) for _ in moms]
        if lw.blocked:
            last = p.shape[-1]
            b = _leaf_block(last)
            cut = spec_axes(p.spec[-1]) if p.spec else ()
        for (blk, dev), fs in owners.items():
            f = fs[0]
            if lw.blocked:
                c0 = blk[-1][0]
                ms = [bdq_cols(s["q"][f], s["s"][f], c0, b) for s in state]
            else:
                ms = [s[f] for s in state]
            np_, nm = lw.leaf(g[f], ms, p[f], on(p[f].device))
            for i in fs:
                new_p[i] = np_
                for j in range(len(moms)):
                    new_m[j][i] = nm[j]
        out_m = []
        for j, m in enumerate(new_m):
            if not lw.blocked:
                out_m.append(Sharded(m, p.sharding))
                continue
            nblk = state[j]["s"][0].shape[-1]
            amax = [block_amax_cols(m[f], p.sharding.block(
                f, p.shape)[-1].start, b, nblk) for f in range(len(p))]
            if cut:  # a quantization block's max over the shards holding it
                amax = [x.amax(0) for x in gmi.allgather(amax, mesh, cut)]
            qs = [bq_cols(m[f], amax[f], p.sharding.block(
                f, p.shape)[-1].start, b) for f in range(len(p))]
            qq, ss = state[j]["q"], state[j]["s"]
            out_m.append({
                "q": Sharded(_shared([x[0] for x in qs], qq), qq.sharding),
                "s": Sharded(_shared([x[1] for x in qs], ss), ss.sharding)})
        return (Sharded(new_p, p.sharding),) + tuple(out_m)

    out = _tree_paths(params, leaf)
    new_params = _pick(out, 0)
    new_state = {m: _pick(out, 1 + j) for j, m in enumerate(moms)}
    new_state["step"] = new_step
    return new_params, new_state


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def jit_train_step(model: Model, opt_update, plan, opt_specs,
                   n_micro: int = 1, max_grad_norm: float = 1.0):
    """The training step over a mode="train" plan (the reference's name:
    nothing is jitted; the module docstring says what one step does).
    Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}: 0-d f32 tensors on shard 0's device): params
    and opt_state placed trees (`place`; a leaf that is not yet placed is
    cut by `train_param_specs` and `opt_specs`, as the reference's
    in_shardings place a host array), batch `shard_batch`'s (or whole
    tensors, cut over the data replicas), its rows divisible by n_micro
    times the data replicas when n_micro > 1.  Under
    ``shard_hints.hints(plan.mesh, int8_gather=True)`` the FSDP gathers
    named by `int8_gathered` run at int8.  `opt_update` is one of
    `make_optimizer`'s (its `leafwise` form runs per block)."""
    mesh, tp, dp = plan.mesh, plan.axes.tp, plan.axes.dp
    replicas = sorted(mesh.groups(tp), key=lambda g: mesh.axis_index(
        g[0], dp) if dp else 0)
    root = mesh.device(replicas[0][0])
    cfg = model.cfg
    specs: Dict[str, Any] = {}

    def gather(path, p: Sharded, int8: bool):
        """Each flat shard's tensor-parallel block of the leaf."""
        if int8 and int8_gathered(cfg, path):
            with shard_hints.hints(mesh, dp_axes=dp, tp_axis=tp,
                                   int8_gather=True):
                return shard_hints.fsdp_int8_gather(p)
        _, fdim, faxes = _dims(p, tp, dp)
        return list(p) if fdim is None else gmi.allgather_dim(
            list(p), mesh, faxes, fdim)

    def replicas_view(params, int8: bool):
        """([(path, placed leaf, each replica's grad leaves)], each
        replica's params tree: its tensor-parallel blocks as `Shards`, a
        leaf not cut over `model` whole on its controller)."""
        leaves, per_rep = [], [{} for _ in replicas]

        def fill(path, p):
            blocks = gather(path, p, int8)
            tdim, _, _ = _dims(p, tp, dp)
            reps = []
            for r, g in enumerate(replicas):
                xs = [blocks[f].detach().requires_grad_(True)
                      for f in (g[:1] if tdim is None else g)]
                reps.append(xs)
                _set(per_rep[r], path,
                     xs[0] if tdim is None else Shards(xs, tp, tdim))
            leaves.append((path, p, reps))

        _tree_paths(params, fill)
        return leaves, per_rep

    def micro_grads(leaves, per_rep, mb):
        """(the microbatch's global loss, each leaf's f32 gradient blocks
        held as the leaf is, summed over the data replicas)."""
        nll = cnt = None
        stats = []
        with shard_hints.hints(mesh, dp_axes=dp, tp_axis=tp):
            for r in range(len(replicas)):
                with shard_hints.router_stats() as st:
                    a, c, _ = model.loss_terms(per_rep[r], mb[r])
                stats.append(st)
                nll = a.to(root) if nll is None else nll + a.to(root)
                cnt = c.to(root) if cnt is None else cnt + c.to(root)
        loss = nll / torch.clamp(cnt, min=1)
        if cfg.n_experts:
            loss = loss + 0.01 * _global_aux(stats, cfg.n_experts, root)
        flat = [x for _, _, reps in leaves for xs in reps for x in xs]
        got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        out = []
        for path, p, reps in leaves:
            per = [[next(got) for _ in xs] for xs in reps]
            per = [[torch.zeros_like(x) if y is None else y
                    for x, y in zip(xs, ys)] for xs, ys in zip(reps, per)]
            tdim, _, _ = _dims(p, tp, dp)
            held: Dict[tuple, torch.Tensor] = {}

            def f32_on(x, dev):  # once per gradient and device
                key = (id(x), str(dev))
                if key not in held:
                    held[key] = x.float().to(dev)
                return held[key]

            mine = [f32_on(per[mesh.axis_index(f, dp)][
                0 if tdim is None else mesh.axis_index(f, tp)], p[f].device)
                for f in range(mesh.size)]
            out.append(_data_reduce(mine, p, mesh, tp, dp))
        return loss.detach(), out

    def step(params, opt_state, batch):
        if "params" not in specs:
            specs["params"] = plan_shardings(
                plan, train_param_specs(plan, params))
            specs["opt"] = plan_shardings(plan, opt_specs)
        params = place(params, specs["params"])
        opt_state = place(opt_state, specs["opt"])
        leaves, per_rep = replicas_view(params, shard_hints.int8_gather_on())
        rows = _replica_rows(batch, mesh, dp, replicas)
        loss = acc = None
        for j in range(n_micro):
            lj, gs = micro_grads(leaves, per_rep,
                                 _micro(rows, j, n_micro, mesh, replicas))
            loss = lj if loss is None else loss + lj
            acc = gs if acc is None else [
                shard_hints.per_part(torch.add, x, y)
                for x, y in zip(acc, gs)]
        if n_micro > 1:
            loss = loss / n_micro
            acc = [shard_hints.per_part(lambda x: x / n_micro, xs)
                   for xs in acc]
        # clip by the global norm, each distinct block once, the leaves in
        # sorted-path order (the reference's `global_norm`)
        total = 0
        for (_, p, _), xs in sorted(zip(leaves, acc), key=lambda t: t[0][0]):
            for f in p.blocks():
                total = total + torch.sum(torch.square(xs[f])).to(root)
        norm = _sqrt(torch.as_tensor(total, dtype=torch.float32))
        scale = torch.clamp(torch.full_like(norm, max_grad_norm)
                            / torch.clamp(norm, min=1e-9), max=1.0)
        grads: Dict = {}
        for (path, _, _), xs in zip(leaves, acc):
            _set(grads, path, shard_hints.per_part(
                lambda x: x * scale.to(x.device), xs))
        params, opt_state = _update_placed(opt_update, grads, opt_state,
                                           params, mesh)
        return params, opt_state, {"loss": loss.float(),
                                   "grad_norm": norm.float()}

    return step


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# CLI loop
# ---------------------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--pack", action="store_true",
                    help="no-padding packed sequences (paper §7.1)")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Train; returns {"losses" (one a step run, replays included),
    "report" (RecoveryReport), "state" ({"params", "opt"}), "opt",
    "monitor", "ckpt" (the CheckpointManager), "step_s" (seconds of each
    step, to the loss on the host), "restore_s" (seconds of each
    restore), "restored_devices" (the devices each restore put the params
    on)}; prints the reference's summary line last."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if (device.type == "cuda" and args.seq > DENSE_ATTN_MAX_KV
            and not args.pack):
        raise ValueError(
            f"train: --seq {args.seq} on the card would run the forward-only"
            f" flash_attention kernel (contiguous positions past "
            f"{DENSE_ATTN_MAX_KV}), which has no backward (nor has the "
            "reference's Pallas kernel a VJP): train at --seq <= "
            f"{DENSE_ATTN_MAX_KV}, or pass --pack (explicit positions, the "
            "dense or KV-chunked route)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device is available; pass "
                         "--device cpu to run the plain PyTorch path")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg, device=device)
    opt_name = args.optimizer or pick_optimizer(cfg)
    lr_fn = cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                            total=args.steps)
    opt_init, opt_update = make_optimizer(opt_name, lr_fn)
    step_fn = make_train_step(model, opt_update)

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed, pack=args.pack)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    injector = FailureInjector(
        {args.inject_failure_at: "node_loss"}
        if args.inject_failure_at >= 0 else {})
    monitor = StragglerMonitor()
    losses: list = []
    step_s: list = []
    restore_s: list = []
    restored_devices: list = []

    def make_state():
        params = init_params(cfg, seed=args.seed, device=device)
        return {"params": params, "opt": opt_init(params)}

    def train_steps(state, start, stop):
        params, opt = state["params"], state["opt"]
        for step in range(start, stop):
            injector.check(step)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in pipe.next_batch().items()}
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])  # waits for the step's work
            dt = time.perf_counter() - t0
            monitor.observe(step, dt)
            step_s.append(dt)
            losses.append(loss)
            if step % 10 == 0:
                log.info("step %d loss %.4f", step, loss)
        return {"params": params, "opt": opt}

    def save(step, state):
        ckpt.save(step, {"params": state["params"]})

    def restore():
        ckpt.wait()  # an in-flight async save must land before we pick
        latest = ckpt.latest_step()
        if latest is None:
            return None
        t0 = time.perf_counter()
        state = make_state()
        step, tree = ckpt.restore(latest, device=device,
                                  template={"params": state["params"]})
        restore_s.append(time.perf_counter() - t0)
        restored_devices.append(sorted({str(p.device) for p in
                                        tree_leaves(tree["params"])}))
        return step, {"params": tree["params"], "opt": state["opt"]}

    state, report = run_with_recovery(
        make_state, train_steps, save, restore,
        total_steps=args.steps, checkpoint_every=args.ckpt_every)
    ckpt.wait()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    log.info("loss %.4f -> %.4f, restarts=%d", first, last, report.restarts)
    print(f"train: arch={cfg.name} opt={opt_name} steps={args.steps} "
          f"loss {first:.4f} -> {last:.4f} restarts={report.restarts} "
          f"stragglers={len(monitor.events)}")
    return {"losses": losses, "report": report, "state": state,
            "opt": opt_name, "monitor": monitor, "ckpt": ckpt,
            "step_s": step_s, "restore_s": restore_s,
            "restored_devices": restored_devices}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
