"""Training entry point: the step factory and the fault-tolerant CLI loop
(port of `repro/launch/train.py`, its plan-free path).

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

The sharded step (the reference's `jit_train_step` over a plan, its
`shard_batch`, data-parallel gradient reduction and `fsdp_int8_gather`)
is not ported yet (ROADMAP.md §1).

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
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.attention import DENSE_ATTN_MAX_KV
from repro_torch.models.transformer import Model, init_params, make_model
from repro_torch.optim.optimizer import (clip_by_global_norm,
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
