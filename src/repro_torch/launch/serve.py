"""Serving CLI of the PyTorch port: one engine on one device, fed a
synthetic request stream.  The continuous-batching engine (`--engine cb`,
the default) serves from a paged KV arena, bf16 or `--kv-dtype int8` (or,
through `serve(args, paged=False)`, from dense slot rows), and with
`--draft-config` speculates greedily (a draft proposes, the target
verifies); `--engine wave` is the batch-synchronous baseline on dense
slot rows.  Models with recurrent blocks or sliding windows
(recurrentgemma-2b, xlstm-1.3b) serve from dense slot rows; the MoE
models (moonshot-v1-16b-a3b, llama4-maverick-400b-a17b) from the paged
arena.  `--quant-weights` serves W8A8 weights (2-d leaves only, as in
the reference, so a MoE model, all of whose weights are stacked, stays
bf16).  The summary line ends with the engine's stats (`spec_*` under
speculation).

Runs on the CUDA device unless ``--device cpu`` is given; without a card
it stops with an error instead of falling back to the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 16 --stream shared-prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve --engine wave
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --arch recurrentgemma-2b --quant-weights
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --arch moonshot-v1-16b-a3b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --draft-config smollm-135m --spec-k 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params, make_model
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.kv_manager import paged_eligible
from repro_torch.serving.wave import WaveEngine
from repro_torch.serving.stream import (poisson_requests,
                                        shared_prefix_requests)

BUCKETS = (16, 32, 64, 128)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-135m",
                    help="a decoder of the registry: smollm-135m, "
                         "phi3-medium-14b, minitron-8b, musicgen-medium, "
                         "internvl2-1b, deepseek-coder-33b, "
                         "moonshot-v1-16b-a3b, llama4-maverick-400b-a17b "
                         "(MoE), recurrentgemma-2b, xlstm-1.3b (the last "
                         "two on dense slot rows)")
    ap.add_argument("--engine", choices=["cb", "wave"], default="cb",
                    help="cb: continuous batching; wave: the batch-"
                         "synchronous baseline (dense slot rows)")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                    help="int8: quantized KV pages (per-row f32 scales), "
                         "~half the HBM per token; needs the paged pool")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = all at t=0")
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="max fused decode steps per dispatch")
    ap.add_argument("--stream", choices=["poisson", "shared-prefix"],
                    default="poisson",
                    help="shared-prefix: one system prompt + unique tails "
                         "(the radix prefix cache's target ingress)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV page-pool size (0 = the dense table's "
                         "capacity + the trash page)")
    ap.add_argument("--draft-config", default="",
                    help="arch of a speculative-decoding draft model "
                         "(random weights from seed + 1; --reduced applies "
                         "to it too): the draft proposes up to --spec-k "
                         "tokens per lane per dispatch and the target "
                         "verifies them in one pass.  Needs the paged cb "
                         "engine and the target's vocabulary")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="most drafted tokens per speculative dispatch; "
                         "each lane walks a depth ladder below it on low "
                         "acceptance")
    ap.add_argument("--quant-weights", action="store_true",
                    help="serve W8A8: the 2-d projections (a model's tail "
                         "layers) run int8 x int8 -> int32 through "
                         "int8_matmul (models/quantized.py)")
    ap.add_argument("--warmup", action="store_true",
                    help="first serve, unmeasured, a stream drawn from "
                         "seed + 1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the kernels' plain "
                         "PyTorch versions")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, paged="auto"):
    """Build the model and engine, serve the stream; returns (engine,
    finished requests, wall seconds of the measured pass).  `paged`
    goes to the cb engine (False: dense slot rows)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device is available; pass "
                         "--device cpu to run the plain PyTorch path")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_dtype == "int8" and args.engine != "cb":
        raise SystemExit(
            "serve: --kv-dtype int8 needs the continuous-batching engine "
            "(the wave baseline decodes dense slot rows); drop --engine wave")
    if args.kv_dtype == "int8" and not (paged_eligible(cfg) and paged):
        raise SystemExit(
            "serve: --kv-dtype int8 needs the paged pool (an all-attention, "
            "unwindowed, causal model)")
    model = make_model(cfg, device=device)
    params = init_params(cfg, seed=args.seed, device=device)
    kw = {}
    if args.engine == "cb":
        kw = dict(paged=paged, page_size=args.page_size,
                  kv_dtype=args.kv_dtype)
        if args.num_pages:
            kw["num_pages"] = args.num_pages
        if args.draft_config:
            kw["spec_config"] = draft_config(args, cfg, paged, device)
    elif args.draft_config:
        raise SystemExit("serve: --draft-config needs --engine cb")
    cls = ContinuousBatchingEngine if args.engine == "cb" else WaveEngine
    engine = cls(model, params, max_batch=args.max_batch, buckets=BUCKETS,
                 monitor=StragglerMonitor(),
                 decode_horizon=args.decode_horizon,
                 quant_weights=args.quant_weights, **kw)
    if args.warmup:  # another seed: the measured prompts stay uncached
        for r in make_stream(args, cfg.vocab_size, args.seed + 1):
            engine.submit(r)
        engine.run()
    t0 = time.perf_counter()
    for r in make_stream(args, cfg.vocab_size, args.seed):
        engine.submit(r)
    done = engine.run()
    return engine, done, time.perf_counter() - t0


def draft_config(args: argparse.Namespace, cfg, paged, device) -> dict:
    """The engine's spec_config for --draft-config: the draft's model and
    random weights (seed + 1), at the target's vocabulary."""
    if not (paged and paged_eligible(cfg)):
        raise SystemExit(
            "serve: --draft-config needs the paged cb engine (an "
            "all-attention, unwindowed, causal model)")
    dcfg = get_config(args.draft_config)
    if args.reduced:
        dcfg = dcfg.reduced()
    if dcfg.vocab_size != cfg.vocab_size:
        raise SystemExit(
            "serve: draft and target must share a vocabulary "
            f"({dcfg.vocab_size} vs {cfg.vocab_size})")
    return dict(draft_model=make_model(dcfg, device=device),
                draft_params=init_params(dcfg, seed=args.seed + 1,
                                         device=device),
                spec_k=args.spec_k)


def make_stream(args: argparse.Namespace, vocab_size: int, seed: int):
    rng = np.random.default_rng(seed)
    if args.stream == "shared-prefix":
        return shared_prefix_requests(rng, args.requests, vocab_size,
                                      prefix_len=48, suffix_range=(3, 9),
                                      budgets=args.max_new, rate=args.rate)
    return poisson_requests(rng, args.requests, vocab_size,
                            len_range=(4, 60), budgets=args.max_new,
                            rate=args.rate)


def main(argv=None):
    args = parse_args(argv)
    engine, done, wall = serve(args)
    toks = sum(len(r.tokens_out) for r in done)
    lat = sorted((r.t_done - r.t_enqueue) * 1e3 for r in done)
    ttft = sorted((r.t_first_token - r.t_enqueue) * 1e3 for r in done)
    print(f"serve[{args.engine}]: arch={engine.model.cfg.name} "
          f"device={args.device} kv_dtype={args.kv_dtype} "
          f"quant_weights={args.quant_weights} "
          f"requests={len(done)} tokens={toks} wall={wall*1e3:.0f}ms "
          f"throughput={toks/wall:.1f}tok/s "
          f"ttft_p50={ttft[len(ttft)//2]:.0f}ms "
          f"p50={lat[len(lat)//2]:.0f}ms p_max={lat[-1]:.0f}ms "
          f"stats={engine.stats}")
    return done


if __name__ == "__main__":
    main()
