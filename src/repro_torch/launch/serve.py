"""Serving CLI of the PyTorch port: one engine on one device, fed a
synthetic request stream.  The continuous-batching engine (`--engine cb`,
the default) serves from a paged KV arena, bf16 or `--kv-dtype int8` (or,
through `serve(args, paged=False)`, from dense slot rows), and with
`--draft-config` speculates greedily (a draft proposes, the target
verifies; also under `--plan serve`); `--engine wave` is the
batch-synchronous baseline on dense slot rows (also under `--plan
serve`).  Models with recurrent blocks or sliding windows
(recurrentgemma-2b, xlstm-1.3b) serve from dense slot rows; the MoE
models (moonshot-v1-16b-a3b, llama4-maverick-400b-a17b) from the paged
arena.  `--quant-weights` serves W8A8 weights (2-d leaves only, as in
the reference, so a MoE model, all of whose weights are stacked, stays
bf16).  The summary line ends with the engine's stats (`spec_*` under
speculation).

Weights and the serving cache are placed under the Cluster Builder's
plan (core/cluster_builder.py), over a single-controller device mesh
(launch/mesh.py: shard i on card i mod the host's count, so shards share
a card on a smaller host):

  --plan serve           kv-head-sharded paged serving over a
                         (data, model) mesh, bit-identical to one device
                         (the default, as in the reference; on a 1-wide
                         mesh it runs the plain programs)
  --plan serve_pipeline  the layer stack cut over a `stage` mesh axis,
                         decode microbatches streamed through the stages
                         (the paper's 6-FPGA encoder pipeline), on dense
                         slot rows; every family whose layer periods
                         divide the stages (xlstm-1.3b and the MoE ones
                         too; recurrentgemma-2b's tail refuses)
  --plan none            single-device

`--no-exact` switches a plan to throughput mode: under `--plan serve`
psum-form TP, token streams gated by a match-rate band instead of
bitwise equality; under `--plan serve_pipeline` the request-skewed
schedule over lane groups, from stage-local paged arenas (bf16 or
int8; the attention-only and MoE families), whose streams stay bit
for bit one device's.  A `--plan serve` plan that cuts serves the MoE
families with each shard running its block of the experts, and the
recurrent families on dense slot rows with each shard running its block
of the RG-LRU's width, or its columns of the mLSTM's and sLSTM's
projections (both cells whole on the controller), and
`--quant-weights` with each shard running its blocks of the quantized
projections (recurrentgemma-2b's two tail MLPs), bit for bit one
device's in an exact plan.
`--dryrun` prints the chosen plan's per-leaf shardings (params + serving
cache) and exits, allocating nothing.

`--plan auto` searches the plans (core/plan_search.py: TP width, stage
depth, exactness, page size, KV dtype, W8A8 weights, replica count and
disaggregated pools, priced by a cost model against the H100's peaks)
for the `--traffic <profile.json>` profile (default: the built-in one),
prints the Pareto frontier and the `chosen:` line, and serves the choice:
its plan, page size, KV dtype, W8A8 and exactness, and, under
`--replicas 0` (the default), its replica count, a fleet with a
per-replica mesh.  A choice the port does not serve yet raises the
engine's refusal; the CLI never serves another candidate instead.
`--plan auto --dryrun` realizes the choice on an abstract mesh and
prints its shardings.  `--no-plan` is `--plan none`.

`--replicas N` serves a fleet of N engines behind the prefix-affinity
router (serving/router.py; `--route`, `--shed-depth`, `--shed-budget`);
under a plan, `--mesh` is one replica's mesh and the replicas take
disjoint device groups, by `make_mesh`'s rule (so on a one-card host
they share the card).  `--disagg P:D` splits the paged cb engine into a
prefill pool and a decode pool (under `--plan none`); `--stream bursty`
is its target ingress (steady short prompts with long-prompt bursts).
The engine's buckets cover the stream's longest prompt: BUCKETS, plus
one more bucket where a prompt is longer (256 for the bursts).

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
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan serve --mesh 1,2 --stream shared-prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan serve_pipeline --mesh 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan serve_pipeline --mesh 2 --no-exact --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch xlstm-1.3b --plan serve_pipeline --mesh 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch moonshot-v1-16b-a3b --plan serve_pipeline --mesh 2 --no-exact
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch xlstm-1.3b --plan serve --mesh 1,2 [--no-exact]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch recurrentgemma-2b --plan serve --mesh 1,2 [--no-exact] \\
      [--quant-weights]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan serve --mesh 1,2 --draft-config smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan serve --mesh 1,2 --engine wave
  PYTHONPATH=src python -m repro_torch.launch.serve --plan serve \\
      --mesh 1,3 --dryrun
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --replicas 2 --stream shared-prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan none --disagg 1:1 --stream bursty
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --plan auto --traffic profile.json
  PYTHONPATH=src python -m repro_torch.launch.serve --plan auto \\
      --traffic profile.json --dryrun
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cluster_builder import build_plan
from repro_torch.core.packing import bucket_len
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import init_params, make_model
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.kv_manager import paged_eligible
from repro_torch.serving.replica import (make_group_mesh,
                                         replica_device_groups)
from repro_torch.serving.router import (ROUTE_POLICIES, FleetConfig,
                                        build_fleet)
from repro_torch.serving.wave import WaveEngine
from repro_torch.serving.stream import (bursty_requests, poisson_requests,
                                        shared_prefix_requests)

BUCKETS = (16, 32, 64, 128)


def stream_buckets(reqs) -> tuple:
    """BUCKETS, extended by one bucket that covers the stream's longest
    prompt where BUCKETS do not (--stream bursty's long prompts)."""
    longest = max((len(r.prompt) for r in reqs), default=0)
    if longest <= max(BUCKETS):
        return BUCKETS
    return BUCKETS + (bucket_len(longest, BUCKETS),)


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
    ap.add_argument("--stream",
                    choices=["poisson", "shared-prefix", "bursty"],
                    default="poisson",
                    help="shared-prefix: one system prompt + unique tails "
                         "(the radix prefix cache's target ingress); "
                         "bursty: steady short prompts with long-prompt "
                         "bursts (the --disagg pools' target ingress)")
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
    ap.add_argument("--plan",
                    choices=["none", "serve", "serve_pipeline", "auto"],
                    default="serve",
                    help="Cluster-Builder placement: serve (kv-head-sharded "
                         "paged serving over a (data, model) mesh), "
                         "serve_pipeline (the layer stack over a stage "
                         "axis: dense slot rows, or stage-local paged "
                         "arenas under --no-exact), none, or auto (the "
                         "cost-model search over TP width, stage depth, "
                         "exactness, paging, W8A8 and replicas for the "
                         "--traffic profile)")
    ap.add_argument("--traffic", default="",
                    help="traffic-profile JSON for --plan auto (arrival "
                         "rate, prompt/output mix, device and HBM budget; "
                         "the fields of core/plan_search.TrafficProfile); "
                         "default: the built-in profile")
    ap.add_argument("--no-plan", action="store_true",
                    help="alias for --plan none")
    ap.add_argument("--mesh", default="",
                    help="mesh shape: 1,3 for (data, model), or 6 for the "
                         "serve_pipeline stage axis; default: the visible "
                         "cards on the plan's axis")
    ap.add_argument("--exact", dest="exact", action="store_true",
                    default=True,
                    help="bit-identical serving (default): gather-form TP "
                         "and the drained pipeline")
    ap.add_argument("--no-exact", dest="exact", action="store_false",
                    help="throughput mode: psum-form TP (serve; streams "
                         "are held to a token-match band, not equality), "
                         "the request-skewed pipeline over lane groups "
                         "(serve_pipeline; --max-batch a multiple of the "
                         "stages)")
    ap.add_argument("--dryrun", action="store_true",
                    help="print the plan's per-leaf shardings and "
                         "exactness modes (params + serving cache), "
                         "allocate nothing, and exit")
    ap.add_argument("--disagg", default="",
                    help="disaggregated prefill/decode pools as P:D device "
                         "counts, e.g. --disagg 1:1: pool devices [0, P) "
                         "prefill and ship completed KV pages into the "
                         "decode pool's arena (pool device i on card i mod "
                         "the host's count); the radix tree spans both, so "
                         "a prefix hit admits decode-side with no transfer."
                         "  Needs the paged cb engine under --plan none")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve a fleet of N engine replicas behind the "
                         "prefix-affinity router; 0 (default) = the search's "
                         "replica count under --plan auto, else 1.  With a "
                         "plan, --mesh is per replica and the replicas take "
                         "disjoint device groups (card i mod the host's "
                         "count)")
    ap.add_argument("--route", choices=list(ROUTE_POLICIES),
                    default="affinity",
                    help="fleet dispatch policy (--replicas > 1): affinity "
                         "routes a request to the replica whose radix tree "
                         "should hold its longest prefix, falling back to "
                         "least-loaded; round-robin is the control arm")
    ap.add_argument("--shed-depth", type=int, default=0,
                    help="fleet load shedding: reject a request when every "
                         "replica's admission queue is this deep (x "
                         "--shed-budget); 0 = never shed")
    ap.add_argument("--shed-budget", type=float, default=1.0,
                    help="deadline-budget multiplier on --shed-depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.no_plan:
        args.plan = "none"
    return args


def _mesh_shape(spec: str, plan_mode: str, n_dev: int,
                of: str = "") -> tuple:
    """(shape, axes) for --mesh: "1,3" -> a (data, model) mesh; "6" under
    serve_pipeline -> a (stage,) mesh.  Default: n_dev on the plan's
    TP/stage axis.  `of` names whose mesh it is, for the refusals."""
    shape = tuple(int(x) for x in spec.split(",")) if spec else None
    if plan_mode == "serve_pipeline":
        if shape is not None and len(shape) != 1:
            raise SystemExit("serve: serve_pipeline takes a 1-axis --mesh "
                             f"(the stage axis{of}), e.g. --mesh 6")
        return shape or (n_dev,), ("stage",)
    if shape is not None and len(shape) != 2:
        raise SystemExit("serve: --plan serve takes a 2-axis --mesh "
                         f"(data, model){of}, e.g. --mesh 1,3")
    return shape or (1, n_dev), ("data", "model")


def _cards(device: str) -> int:
    """The visible cards (one on the CPU)."""
    return (torch.cuda.device_count()
            if torch.device(device).type == "cuda" else 1)


def make_plan(args: argparse.Namespace, cfg):
    """The Cluster Builder's plan for --plan / --mesh / --exact (None
    under --plan none)."""
    if args.plan == "none":
        return None
    shape, axes = _mesh_shape(args.mesh, args.plan, _cards(args.device))
    return build_plan(cfg, make_mesh(shape, axes, device=args.device),
                      mode=args.plan, exact=args.exact)


def fleet_plans(args: argparse.Namespace, cfg):
    """Per-replica plans over disjoint device groups: --mesh is the shape
    of ONE replica's mesh (default: an even split of the host's cards on
    the plan's axis).  The groups take their devices by `make_mesh`'s
    rule, device i on card i mod the host's count, so on a host with
    fewer cards than replicas x width the replicas share them."""
    n = args.replicas
    shape, axes = _mesh_shape(args.mesh, args.plan,
                              max(_cards(args.device) // n, 1),
                              of=" per replica")
    width = 1
    for s in shape:
        width *= s
    devices = make_mesh((n * width,), ("fleet",), device=args.device).devices
    groups = replica_device_groups(n, width, devices=devices)
    return [build_plan(cfg, make_group_mesh(g, shape, axes),
                       mode=args.plan, exact=args.exact) for g in groups]


def parse_disagg(args: argparse.Namespace, paged: bool):
    """(P, D) for --disagg P:D (None without it), with the reference's
    refusals."""
    if not args.disagg:
        return None
    try:
        p_pool, d_pool = (int(x) for x in args.disagg.split(":"))
    except ValueError:
        raise SystemExit("serve: --disagg takes P:D device counts, "
                         "e.g. --disagg 1:1")
    if args.engine != "cb" or not paged:
        raise SystemExit("serve: --disagg needs the paged cb engine "
                         "(page shipping is the handoff mechanism)")
    if args.plan != "none":
        raise SystemExit("serve: --disagg owns device placement; "
                         "combine it with --plan none")
    if args.replicas > 1:
        raise SystemExit("serve: --disagg does not compose with a "
                         "--replicas fleet yet (cross-host shipping "
                         "lands with the multi-process fleet)")
    if args.draft_config:
        raise SystemExit("serve: --disagg does not compose with "
                         "--draft-config (no draft shipping path yet)")
    return p_pool, d_pool


# projections that *reduce* over a contracted dim: replicated + gather-form
# under exact serving, row-sharded + psum-form under --no-exact
_REDUCTION_LEAVES = ("wo", "shared_wo", "glu_wo", "down", "w_out")


def _leaf_exactness(plan, path) -> str:
    """Exactness mode of one plan leaf, for --dryrun."""
    name = path[-1] if path else ""
    if name in ("q", "scale") and len(path) > 1:  # quantized leaf pair
        name = path[-2]
    if plan.mode == "serve" and name in _REDUCTION_LEAVES:
        return "gather(exact)" if plan.exact else "psum(throughput)"
    if plan.mode == "serve_pipeline":
        return "drained(exact)" if plan.exact else "skewed(throughput)"
    return "exact"


def _print_shardings(title: str, specs, shapes, plan=None) -> None:
    print(f"-- {title} " + "-" * max(1, 60 - len(title)))

    def walk(sp, sh, path=()):
        if isinstance(sp, dict):
            for k in sorted(sp):
                walk(sp[k], sh[k], path + (k,))
            return
        note = f"  [{_leaf_exactness(plan, path)}]" if plan is not None else ""
        print(f"  {'/'.join(path):<40} {str(tuple(sh.shape)):<22} {sp}{note}")

    walk(specs, shapes)


def _print_pareto(cfg, result) -> None:
    """The search's dump: profile, frontier table (chosen starred), and,
    when nothing is feasible, the pruning reasons."""
    prof = result.profile
    print(f"plan auto-search: arch={cfg.name} profile={prof.name} "
          f"(rate={prof.arrival_rate:g}/s prompt~{prof.prompt_mean:g} "
          f"out~{prof.output_mean:g} devices={prof.devices} "
          f"hbm={prof.hbm_gb:g}GB max_batch={prof.max_batch})")
    print(f"  {len(result.scores)} candidates, {result.n_feasible} "
          f"feasible, {len(result.frontier)} on the Pareto frontier "
          "(max tok/s, min ttft, min hbm):")
    print(f"  {'candidate':<38} {'tok/s':>9} {'ttft_ms':>9} "
          f"{'hbm':>5} {'lanes':>5} {'repl':>4}")
    for s in result.frontier:
        mark = "*" if result.chosen and s.key == result.chosen.key else " "
        print(f" {mark}{s.key:<38} {s.tok_s:>9.0f} {s.ttft_ms:>9.3f} "
              f"{s.hbm_frac:>5.2f} {s.lanes:>5d} {s.replicas:>4d}")
    if result.chosen is not None:
        print(f"  chosen: {result.chosen.key}")
    else:
        reasons = {}
        for s in result.scores:
            if not s.feasible:
                reasons[s.reason] = reasons.get(s.reason, 0) + 1
        for rsn, n in sorted(reasons.items()):
            print(f"  infeasible x{n}: {rsn}")


def auto_plan(args: argparse.Namespace, cfg):
    """--plan auto: search the plans for the --traffic profile, print the
    frontier, and carry the choice onto ``args`` (plan mode, exactness,
    page size, KV dtype, W8A8; a disaggregated choice as --disagg P:D
    under --plan none, as `plan_search.realize` says to deploy it).
    Returns the chosen Score."""
    from repro_torch.core.plan_search import TrafficProfile, search
    profile = (TrafficProfile.from_json(args.traffic) if args.traffic
               else TrafficProfile())
    result = search(cfg, profile)
    _print_pareto(cfg, result)
    if result.chosen is None:
        raise SystemExit(
            "serve: plan auto-search found no feasible candidate for "
            "this traffic profile (pruning reasons above); raise "
            "hbm_gb/devices or quantize")
    cand = result.chosen.cand
    if cand.paged and args.engine != "cb":
        raise SystemExit("serve: the auto-chosen plan serves from the "
                         "paged pool; drop --engine wave")
    args.plan, args.exact = cand.mode, cand.exact
    if cand.paged:
        args.page_size, args.kv_dtype = cand.page_size, cand.kv_dtype
    args.quant_weights = args.quant_weights or cand.quant_weights
    if cand.disagg_prefill and not args.dryrun:
        args.plan = "none"
        args.disagg = f"{cand.disagg_prefill}:{cand.disagg_decode}"
    return result.chosen


def _dryrun(cfg, plan, paged: bool, engine_kw) -> None:
    """Spec-only plan inspection: every leaf on the meta device (shapes,
    no storage)."""
    model = make_model(cfg, device="meta")
    params_shape = init_params(cfg, device="meta")
    plan.param_specs = plan.specs_for_params(params_shape)
    mesh = plan.mesh
    print(f"serve --dryrun: arch={cfg.name} mode={plan.mode} "
          f"exact={plan.exact} mesh={dict(mesh.shape)} paged={paged}"
          + (" (shards share devices)" if mesh.shared_devices() else ""))
    _print_shardings("params", plan.param_specs, params_shape, plan=plan)
    if paged:
        ps = engine_kw.get("page_size", 16)
        cache_shape = model.init_paged_cache(
            4, 64, ps, 8, kv_dtype=engine_kw.get("kv_dtype", "bf16"))
    else:
        cache_shape = model.init_cache(4, 64)
    cache_specs = plan.specs_for_caches(cache_shape, batch=4,
                                        slot_table=True, paged=paged)
    _print_shardings("serving cache" + (" (paged arena)" if paged else
                                        " (dense slots)"),
                     cache_specs, cache_shape, plan=plan)


def serve(args: argparse.Namespace, paged="auto", **engine_kw):
    """Build the model and engine (or, with --replicas > 1, the fleet
    router), serve the stream; returns (engine or router, finished
    requests, wall seconds of the measured pass).  `paged` goes to the cb
    engine (False: dense slot rows), `engine_kw` (e.g. deadline_s) to
    every engine.  Under --plan auto, ``args`` leaves with the choice
    carried onto it and the chosen Score as ``args.chosen``.  With
    --dryrun, prints the plan's shardings and returns (None, [], 0.0)."""
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
    chosen = args.chosen = (auto_plan(args, cfg) if args.plan == "auto"
                            else None)
    # 0: the search's replica count under --plan auto, else 1
    if args.replicas == 0:
        args.replicas = chosen.replicas if chosen is not None else 1
    if args.replicas > 1 and args.engine != "cb":
        raise SystemExit("serve: --replicas > 1 serves a fleet of "
                         "continuous-batching engines; drop --engine wave")
    fleet = args.replicas > 1 and not args.dryrun
    if chosen is not None and not args.mesh:
        cand = chosen.cand
        if fleet:  # per-replica mesh: each engine gets its device group
            args.mesh = (f"1,{cand.tp}" if cand.mode == "serve"
                         else str(cand.stages))
        else:
            args.mesh = (f"{chosen.replicas},{cand.tp}"
                         if cand.mode == "serve" else str(cand.stages))
    plans = None
    if chosen is not None and args.dryrun and args.plan != "none":
        # spec inspection needs no devices: the choice realized on an
        # abstract mesh of its own shape (profile.devices may differ from
        # this host's)
        from repro_torch.core.plan_search import realize
        plan = realize(cfg, chosen)
    elif fleet and args.plan != "none":
        plans = fleet_plans(args, cfg)
        plan = plans[0]  # representative: replicas differ only in devices
    else:
        plan = make_plan(args, cfg)
    eligible = paged_eligible(cfg, plan)
    if args.kv_dtype == "int8" and not (eligible and paged):
        raise SystemExit(
            "serve: --kv-dtype int8 needs the paged pool (an all-attention, "
            "unwindowed, causal model under --plan none or serve, or "
            "serve_pipeline with --no-exact)")
    disagg = parse_disagg(args, eligible and bool(paged))
    if args.dryrun:
        if plan is None:
            raise SystemExit("serve: --dryrun inspects a plan; pick "
                             "--plan serve or serve_pipeline")
        _dryrun(cfg, plan, eligible and args.engine == "cb" and bool(paged),
                dict(page_size=args.page_size, kv_dtype=args.kv_dtype))
        return None, [], 0.0
    model = make_model(cfg, device=device)
    params = init_params(cfg, seed=args.seed, device=device)
    kw = {}
    if args.engine == "cb":
        kw = dict(paged=paged, page_size=args.page_size,
                  kv_dtype=args.kv_dtype)
        if disagg is not None:
            kw["disagg"] = disagg
        if args.num_pages:
            kw["num_pages"] = args.num_pages
        if args.draft_config:
            kw["spec_config"] = draft_config(args, cfg, paged, device)
    elif args.draft_config:
        raise SystemExit("serve: --draft-config needs --engine cb")
    # the warm-up stream takes another seed: the measured prompts stay
    # uncached
    warm = make_stream(args, cfg.vocab_size, args.seed + 1) \
        if args.warmup else []
    stream = make_stream(args, cfg.vocab_size, args.seed)
    max_batch = args.max_batch
    if (plan is not None and plan.mode == "serve_pipeline"
            and not plan.exact and args.engine == "cb"):
        n_stages = plan.mesh.shape["stage"]
        if max_batch % n_stages:
            max_batch = -(-max_batch // n_stages) * n_stages
            print(f"serve: request-skewed pipeline needs one lane group "
                  f"per stage; max_batch {args.max_batch} -> {max_batch} "
                  f"({n_stages} stages)")
    kw.update(engine_kw)
    kw.update(max_batch=max_batch, monitor=StragglerMonitor(),
              buckets=stream_buckets(warm + stream),
              decode_horizon=args.decode_horizon,
              quant_weights=args.quant_weights)
    if fleet:
        engine = build_fleet(
            model, params, args.replicas, plans=plans,
            config=FleetConfig(route=args.route, shed_depth=args.shed_depth,
                               shed_budget=args.shed_budget), **kw)
    else:
        cls = ContinuousBatchingEngine if args.engine == "cb" else WaveEngine
        engine = cls(model, params, plan=plan, **kw)
    if warm:
        for r in warm:
            engine.submit(r)
        engine.run()
    t0 = time.perf_counter()
    for r in stream:
        engine.submit(r)
    done = engine.run()
    return engine, done, time.perf_counter() - t0


def draft_config(args: argparse.Namespace, cfg, paged, device) -> dict:
    """The engine's spec_config for --draft-config: the draft's model and
    random weights (seed + 1), at the target's vocabulary."""
    if not (paged and paged_eligible(cfg)) or args.plan == "serve_pipeline":
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
    if args.stream == "bursty":
        return bursty_requests(rng, args.requests, vocab_size,
                               budgets=args.max_new, rate=args.rate)
    return poisson_requests(rng, args.requests, vocab_size,
                            len_range=(4, 60), budgets=args.max_new,
                            rate=args.rate)


def main(argv=None):
    args = parse_args(argv)
    engine, done, wall = serve(args)
    if engine is None:  # --dryrun
        return done
    toks = sum(len(r.tokens_out) for r in done)
    if args.replicas > 1:
        st = engine.stats()
        print(f"serve[fleet]: arch={engine.replicas[0].engine.model.cfg.name}"
              f" device={args.device} plan={args.plan} "
              f"replicas={args.replicas} route={args.route} "
              f"requests={len(done)} shed={st['shed']} tokens={toks} "
              f"wall={wall*1e3:.0f}ms throughput={toks/wall:.1f}tok/s "
              f"by_kind={st['by_kind']} "
              f"prefix_hit_tokens={st['prefix_hit_tokens']}")
        for p in st["replicas"]:
            print(f"  replica {p['replica']}: routed={p['routed']} "
                  f"admitted={p.get('admitted', 0)} "
                  f"hit_rate={p['prefix_hit_rate']:.2f} "
                  f"wall={p['wall_s']*1e3:.0f}ms")
        for req, reason in engine.shed[:3]:
            print(f"  shed rid={req.rid}: {reason}")
        return done
    plan = engine.plan
    mesh = "" if plan is None else f" mesh={dict(plan.mesh.shape)}"
    for note in engine.executor.notes:
        print(note)
    lat = sorted((r.t_done - r.t_enqueue) * 1e3 for r in done)
    ttft = sorted((r.t_first_token - r.t_enqueue) * 1e3 for r in done)
    print(f"serve[{args.engine}]: arch={engine.model.cfg.name} "
          f"device={args.device} plan={args.plan}{mesh} "
          f"exact={args.exact} kv_dtype={args.kv_dtype} "
          f"quant_weights={args.quant_weights} disagg={args.disagg or None} "
          f"requests={len(done)} tokens={toks} wall={wall*1e3:.0f}ms "
          f"throughput={toks/wall:.1f}tok/s "
          f"ttft_p50={ttft[len(ttft)//2]:.0f}ms "
          f"p50={lat[len(lat)//2]:.0f}ms p_max={lat[-1]:.0f}ms "
          f"stats={engine.stats}")
    return done


if __name__ == "__main__":
    main()
