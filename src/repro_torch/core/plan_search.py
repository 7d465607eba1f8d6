"""Cost-model-driven serve-plan search (port of
`repro/core/plan_search.py`).

The paper's Cluster Builder (§6) maps a transformer onto the platform
*before* anything is deployed, and its pipeline latency model (§8.2.2,
Eq. 1: T_total = T + (L-1)(X+d)) prices each mapping.  This module plays
both roles for the port: it enumerates serve-plan candidates over TP
width x pipeline stage depth x `exact` x `page_size` x `kv_dtype` x
`quant_weights` x replicas x disaggregated pools, scores each against a
declared traffic profile with a cost model composed from

  * roofline/op_cost     — per-block FLOPs/bytes counted from the port's
    own decode step on fake tensors (exact, deterministic; the kernels
    through their plain versions), with an active/total parameter
    correction for MoE (the count runs every expert dense);
  * roofline/analysis    — the H100's peaks (bf16/int8 FLOP/s, HBM and
    NVLink bandwidth) that turn counts into seconds;
  * core/latency_model   — Eq. 1 fill math for pipeline TTFT (X ~= 0.53 T,
    the paper's §9 Versal fit) and the ticks-per-step schedules of the
    drained (exact) vs request-skewed (throughput) pipelines;
  * serving/kv_manager   — `kv_page_bytes` / `num_pages_for_hbm` for HBM
    feasibility: a candidate whose weights + KV pool exceed the profile's
    per-device budget is pruned, never chosen.

The scoring is the reference's arithmetic in the reference's order, so
equal `BlockCosts` and an equal `HardwareModel` give equal scores, the
same frontier and the same choice.  The output is a Pareto frontier
(maximise tok/s, minimise TTFT, minimise HBM pressure) plus a single
deterministic choice, realisable as a `ClusterPlan` via `realize()` and
printable with `launch/serve.py --plan auto --traffic <profile.json>
--dryrun`.  `DeviceCalibration` / `predict_engine_tok_s` at the bottom
set a prediction from measured step, dispatch and prefill costs beside a
measured tok/s.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.latency_model import (StageTiming,
                                            pipeline_ticks_per_step,
                                            total_latency)
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW,
                                           PEAK_FLOPS_BF16, PEAK_FLOPS_INT8)
from repro_torch.serving.kv_manager import kv_page_bytes, num_pages_for_hbm

# Bump when the scoring math changes shape: snapshots embed it so a plan
# drift caused by a cost-model revision is distinguishable from one
# caused by a config/profile edit.
# v2: replicas became an enumerated candidate axis (the fleet router's
# TP-width-vs-replica-count trade) instead of the implicit devices//width.
# v3: disaggregated prefill:decode splits became an enumerated axis —
# priced with a shipped-bytes-per-admission transfer term (paper hop
# latency) and prefill-pool queueing, pruned when either pool saturates.
COST_MODEL_VERSION = 3

PAGE_SIZES = (8, 16, 32)
KV_DTYPES = ("bf16", "int8")

# Paper §9 Versal fit: time-to-first-output X ~= 0.53 T at seq 128; we
# reuse it for pipeline prefill fill (Eq. 1 needs an X and the stages
# stream activations exactly like the paper's encoder clusters).
X_FRACTION = 0.53

# Fraction of the per-device HBM budget reserved for activations,
# dispatch scratch and allocator slack before the KV pool is sized.
ACT_SLACK_FRAC = 0.05

# int8 weight bytes per parameter (1 B value + amortised f32 scale).
INT8_WEIGHT_BYTES = 1.05

# One H100's memory, as torch.cuda.get_device_properties(0).total_memory
# reports it (NVIDIA H100 80GB HBM3, 79.18 GiB; chip_smoke.py's
# plansearch phase prints it): the default per-device budget, in GiB.
CARD_HBM_BYTES = 85_017_493_504
CARD_HBM_GB = CARD_HBM_BYTES / (1 << 30)

# The fixed cost of one fused decode dispatch on the card, seconds:
# t_dispatch of the two-point calibration (`DeviceCalibration`) in
# chip_smoke.py's plansearch phase, smollm-135m x30 at 4 lanes on int8
# pages of 8, NVIDIA H100 80GB HBM3 at 700 W.  Two calls gave 0 (the fit
# clamps at 0): one fused step cost 54.2 ms, and in the other 104.6 ms at
# n = 1 against 109.0 ms a step at n = 8, so a dispatch's fixed cost is
# below the spread of a host-bound step.
DISPATCH_S = 0.0


class PlanSearchError(ValueError):
    pass


# ---------------------------------------------------------------------------
# traffic profile
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficProfile:
    """The declared workload + platform budget a plan is searched for.

    The JSON schema mirrors the field names 1:1; unknown keys are
    rejected so a typo'd profile cannot silently search the defaults.
    """
    name: str = "default"
    arrival_rate: float = 8.0     # offered requests/s
    prompt_mean: float = 128.0    # tokens
    prompt_max: int = 256
    output_mean: float = 128.0    # tokens
    output_max: int = 256
    devices: int = 8              # declared device budget (not the host's)
    hbm_gb: float = CARD_HBM_GB   # per-device HBM budget
    max_batch: int = 32           # scheduler lane cap per replica
    ttft_target_ms: float = 0.0   # 0 = unconstrained

    @property
    def hbm_bytes(self) -> int:
        return int(self.hbm_gb * (1 << 30))

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrafficProfile":
        known = {f for f in cls.__dataclass_fields__}
        unknown = sorted(set(d) - known)
        if unknown:
            raise PlanSearchError(
                f"unknown traffic-profile keys {unknown}; "
                f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, path: str) -> "TrafficProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# hardware model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareModel:
    """Per-card peaks (roofline/analysis: one H100 SXM5 80 GB at 700 W),
    the paper's inter-stage hop d and the card's dispatch cost."""
    peak_flops: float = PEAK_FLOPS_BF16
    peak_flops_int8: float = PEAK_FLOPS_INT8
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    # Eq. 1's d: the paper's FPGA switch latency (Table 1), not a card
    # figure
    hop_s: float = 1.1e-6
    dispatch_s: float = DISPATCH_S

    def peak(self, quant_weights: bool) -> float:
        return self.peak_flops_int8 if quant_weights else self.peak_flops


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Candidate:
    mode: str                 # "serve" | "serve_pipeline"
    tp: int = 1               # model-axis width      (mode="serve")
    stages: int = 1           # stage-axis depth      (mode="serve_pipeline")
    exact: bool = True
    page_size: int = 16       # 0 = dense slot table (exact pipeline)
    kv_dtype: str = "bf16"
    quant_weights: bool = False
    replicas: int = 1         # independent engines behind the fleet router
    # disaggregated pools (engine disagg=(P, D)): device counts for the
    # prefill and decode pools; (0, 0) = colocated.  Disagg candidates
    # ride mode="serve" tp=1 (each pool replicates the model in-process —
    # docs/serving.md §disaggregated serving).
    disagg_prefill: int = 0
    disagg_decode: int = 0

    @property
    def width(self) -> int:
        """Devices one replica occupies."""
        if self.disagg_prefill:
            return self.disagg_prefill + self.disagg_decode
        return self.tp if self.mode == "serve" else self.stages

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    @property
    def key(self) -> str:
        core = (f"serve.tp{self.tp}" if self.mode == "serve"
                else f"pipe.s{self.stages}")
        if self.disagg_prefill:
            core += f".pd{self.disagg_prefill}-{self.disagg_decode}"
        ex = "exact" if self.exact else "tput"
        kv = ("kv=dense" if not self.paged
              else f"kv=ps{self.page_size}.{self.kv_dtype}")
        w = "w=int8" if self.quant_weights else "w=bf16"
        return f"{core}.r{self.replicas}.{ex}.{kv}.{w}"


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_candidates(cfg, profile: TrafficProfile) -> List[Candidate]:
    """The search grid the tentpole declares, canonicalised:

    * serve: tp over divisors of the device budget; tp=1 has no
      gather/psum distinction so only exact=True is emitted.
    * replicas: for each width, every divisor count the budget covers
      (replicas x width <= devices) — the explicit TP-width-vs-replica-
      count trade the fleet router serves (serving/router.py).  Fewer
      replicas than the budget allows is enumerable (a fleet may reserve
      devices) but is dominated at fixed width, so the frontier documents
      the trade instead of hiding it in an implicit devices//width.
    * serve_pipeline: stage depths over divisors >= 2 whose layer stack
      divides (cluster_builder shards the scan dim; a non-dividing depth
      replicates and is never worth enumerating).  exact pipelines
      stream the dense slot path (page_size=0, bf16 cache — executor
      asserts paged is off); throughput (request-skewed) pipelines run
      the stage-local paged arena.
    * int8 KV requires the paged arena (engine guard), so dense slots
      are bf16-only; quant_weights composes with everything.
    * disagg: every prefill:decode split of the device budget (P >= 1,
      D = devices - P), paged tp=1 only — page shipping is the handoff
      unit and each pool replicates the model.  Priced with the transfer
      + queueing terms in `score_candidate`; today's in-process pools
      never beat colocated tp=1 on TTFT alone, so these document the
      trade on the frontier rather than win it (the device-parallel win
      arrives with multi-process fleets — docs/serving.md).
    """
    from repro_torch.models.transformer import period_length
    cands: List[Candidate] = []
    for tp in _divisors(profile.devices):
        exacts = (True,) if tp == 1 else (True, False)
        for rep in _divisors(profile.devices // tp):
            for exact in exacts:
                for ps in PAGE_SIZES:
                    for kvd in KV_DTYPES:
                        for qw in (False, True):
                            cands.append(Candidate(
                                mode="serve", tp=tp, exact=exact,
                                page_size=ps, kv_dtype=kvd,
                                quant_weights=qw, replicas=rep))
    stack = cfg.n_layers // period_length(cfg)
    for s in _divisors(profile.devices):
        if s < 2 or stack % s:
            continue
        for rep in _divisors(profile.devices // s):
            for qw in (False, True):
                cands.append(Candidate(mode="serve_pipeline", stages=s,
                                       exact=True, page_size=0,
                                       kv_dtype="bf16", quant_weights=qw,
                                       replicas=rep))
                for ps in PAGE_SIZES:
                    for kvd in KV_DTYPES:
                        cands.append(Candidate(
                            mode="serve_pipeline", stages=s, exact=False,
                            page_size=ps, kv_dtype=kvd, quant_weights=qw,
                            replicas=rep))
    for p in range(1, profile.devices):
        d = profile.devices - p
        for ps in PAGE_SIZES:
            for kvd in KV_DTYPES:
                for qw in (False, True):
                    cands.append(Candidate(
                        mode="serve", tp=1, exact=True, page_size=ps,
                        kv_dtype=kvd, quant_weights=qw, replicas=1,
                        disagg_prefill=p, disagg_decode=d))
    return sorted(set(cands))


# ---------------------------------------------------------------------------
# traced block costs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockCosts:
    """Affine decode-step cost decomposition from two counts:

        cost(B) = fixed + B * per_lane

    `fixed` is dominated by the weight stream (every decode step reads
    every live parameter once), `per_lane` by the KV read + activation
    math of one resident lane.  `moe_active_frac` scales matmul FLOPs
    down to the routed share (the trace runs all experts dense).
    """
    flops_fixed: float
    flops_per_lane: float
    bytes_fixed: float
    bytes_per_lane: float
    prefill_flops_per_tok: float   # per prompt token, full model
    weight_bytes_bf16: float       # analytic live-parameter bytes
    moe_active_frac: float


@lru_cache(maxsize=None)
def block_costs(cfg, cache_len: int = 512) -> BlockCosts:
    """Count the port's `Model.decode_step` on `init_cache(B, cache_len)`
    at two batch sizes, on fake CPU tensors (cheap even for the 400B
    config: nothing is allocated), and fit the affine decomposition."""
    import torch

    from repro_torch.models.transformer import init_params, make_model
    from repro_torch.roofline.op_cost import count_costs, fake_mode

    def costs_at(batch: int):
        with fake_mode():
            model = make_model(cfg, device="cpu")
            params = init_params(cfg, device="cpu")
            caches = model.init_cache(batch, cache_len)
            token = torch.zeros((batch,), dtype=torch.int32)
        c = count_costs(lambda p, ca, t: model.decode_step(p, ca, t)[0],
                        params, caches, token)
        return c["flops"], c["bytes"]

    b_lo, b_hi = 1, 5
    f_lo, by_lo = costs_at(b_lo)
    f_hi, by_hi = costs_at(b_hi)
    f_lane = max((f_hi - f_lo) / (b_hi - b_lo), 0.0)
    by_lane = max((by_hi - by_lo) / (b_hi - b_lo), 0.0)
    act = cfg.active_param_count() / max(cfg.param_count(), 1)
    return BlockCosts(
        flops_fixed=max(f_lo - b_lo * f_lane, 0.0),
        flops_per_lane=f_lane,
        bytes_fixed=max(by_lo - b_lo * by_lane, 0.0),
        bytes_per_lane=by_lane,
        prefill_flops_per_tok=2.0 * cfg.active_param_count(),
        weight_bytes_bf16=2.0 * cfg.param_count(),
        moe_active_frac=act,
    )


def _reduction_frac(cfg) -> float:
    """Share of block matmul params living in *reduction* projections
    (attention output + FFN down): the mats gather-form exact TP
    replicates, so their FLOPs/bytes do not shrink with tp."""
    d, ff = cfg.d_model, cfg.d_ff
    attn_out = cfg.n_heads * cfg.head_dim * d
    attn_in = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    ffn_down = ff * d
    ffn_up = (2 * d * ff if cfg.mlp_style == "swiglu" else d * ff)
    red = attn_out + ffn_down
    tot = red + attn_in + ffn_up
    return red / max(tot, 1)


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


@dataclass
class Score:
    cand: Candidate
    feasible: bool
    reason: str = ""               # why infeasible (empty when feasible)
    tok_s: float = 0.0             # predicted aggregate tokens/s (all replicas)
    ttft_ms: float = 0.0           # predicted cold time-to-first-token
    step_ms: float = 0.0           # one decode tick at the operating batch
    hbm_frac: float = 0.0          # per-device HBM used / budget
    lanes: int = 0                 # resident lanes per replica at steady state
    replicas: int = 1
    kv_pages: int = 0              # pool size per replica (0 = dense slots)
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return self.cand.key


def _infeasible(cand: Candidate, reason: str) -> Score:
    return Score(cand=cand, feasible=False, reason=reason)


def _kv_shards(cfg, cand: Candidate) -> int:
    """How many ways the KV arena actually divides per device.  serve
    shards over kv heads (falls back to replication when tp does not
    divide, mirroring cluster_builder's Rules); throughput pipelines
    stage-shard the layer stack (kv_manager's shards= semantics)."""
    if cand.mode == "serve":
        return cand.tp if cfg.n_kv_heads % cand.tp == 0 else 1
    if not cand.exact:
        return cand.stages
    return cand.stages  # exact pipeline: scan-stacked dense cache shards


def score_candidate(cfg, cand: Candidate, profile: TrafficProfile,
                    hw: HardwareModel, costs: BlockCosts) -> Score:
    w = cand.width
    if w > profile.devices:
        return _infeasible(cand, "wider than device budget")
    replicas = cand.replicas
    if replicas * w > profile.devices:
        return _infeasible(cand, "replica fleet exceeds device budget")
    disagg = cand.disagg_prefill > 0
    if disagg:
        # both pools replicate the full model in-process, so every
        # per-device quantity below is the tp=1 figure; the split's own
        # costs (transfer + prefill queueing) are priced after TTFT
        w = 1

    # ---- HBM feasibility: weights first, then the KV pool -----------------
    wbytes_per_param = (INT8_WEIGHT_BYTES if cand.quant_weights else 2.0)
    weight_total = cfg.param_count() * wbytes_per_param
    embed_bytes = cfg.embed_params() * wbytes_per_param
    if cand.mode == "serve":
        red = _reduction_frac(cfg) if cand.exact and w > 1 else 0.0
        weight_dev = weight_total * ((1 - red) / w + red)
    else:
        # stage s holds its layer slice; embeddings ride on first/last
        # stage but budget them everywhere (conservative).
        weight_dev = (weight_total - embed_bytes) / w + embed_bytes
    budget = profile.hbm_bytes * (1.0 - ACT_SLACK_FRAC)
    kv_budget = budget - weight_dev
    if kv_budget <= 0:
        return _infeasible(
            cand, f"weights alone need {weight_dev / 1e9:.1f} GB/device "
                  f"(budget {budget / 1e9:.1f} GB)")

    seq_cap = profile.prompt_max + profile.output_max
    shards = _kv_shards(cfg, cand)
    if cand.paged:
        pages = num_pages_for_hbm(cfg, cand.page_size, cand.kv_dtype,
                                  int(kv_budget), shards=shards)
        pages_per_lane = -(-seq_cap // cand.page_size) + 1
        lanes_cap = max((pages - 1) // pages_per_lane, 0)  # -1: trash page
        lane_bytes = pages_per_lane * kv_page_bytes(
            cfg, cand.page_size, cand.kv_dtype, shards=shards)
    else:
        pages = 0
        per_row = 2 * cfg.n_kv_heads * cfg.head_dim * 2  # k+v bf16
        lane_bytes = cfg.n_layers * seq_cap * per_row / shards
        lanes_cap = int(kv_budget // lane_bytes)
    if lanes_cap < 1:
        return _infeasible(
            cand, f"KV pool cannot hold one {seq_cap}-token lane "
                  f"({lane_bytes / 1e6:.0f} MB/lane, "
                  f"{max(kv_budget, 0) / 1e6:.0f} MB free)")
    lanes_cap = min(lanes_cap, profile.max_batch)
    if cand.mode == "serve_pipeline" and not cand.exact:
        # request-skewed schedule groups lanes per stage
        lanes_cap = max((lanes_cap // cand.stages) * cand.stages, 0)
        if lanes_cap < cand.stages:
            return _infeasible(
                cand, "fewer KV lanes than stages (skewed schedule needs "
                      "one lane group per stage)")

    # ---- decode tick time at batch B --------------------------------------
    peak = hw.peak(cand.quant_weights)
    act = costs.moe_active_frac
    red = (_reduction_frac(cfg)
           if cand.mode == "serve" and cand.exact and w > 1 else 0.0)
    wscale = wbytes_per_param / 2.0   # traced bytes assume 2 B weights
    kvscale = (0.55 if cand.kv_dtype == "int8" else 1.0)

    def tick_s(batch: int) -> float:
        flops = (costs.flops_fixed + batch * costs.flops_per_lane) * act
        byts = (costs.bytes_fixed * wscale
                + batch * costs.bytes_per_lane * kvscale)
        # per-device share: reduction mats replicate under gather-form TP
        f_dev = flops * ((1 - red) / w + red)
        b_dev = byts * ((1 - red) / w + red)
        t = max(f_dev / peak, b_dev / hw.hbm_bw)
        row = batch * cfg.d_model * 2  # one activation row, bf16
        if cand.mode == "serve" and w > 1:
            sites = 2 * cfg.n_layers       # attn + ffn reduction points
            per_site = (row * (w - 1) / w) * (1 if cand.exact else 2)
            t += sites * (per_site / hw.link_bw + hw.hop_s)
        elif cand.mode == "serve_pipeline":
            # t is already the per-stage slice (f_dev/b_dev divide by w)
            ticks = pipeline_ticks_per_step(w, exact=cand.exact)
            hop = hw.hop_s + (row / w) / hw.link_bw
            return ticks * (t + hop)
        return t

    # ---- operating point: Little's-law fixed point ------------------------
    per_replica_rate = profile.arrival_rate / replicas
    lanes = max(min(lanes_cap, profile.max_batch), 1)
    for _ in range(8):
        t = tick_s(lanes) + hw.dispatch_s / 8.0   # horizon-8 amortised
        demand = per_replica_rate * profile.output_mean * t
        lanes = max(1, min(lanes_cap, int(math.ceil(demand))))
    step = tick_s(lanes) + hw.dispatch_s / 8.0
    tok_s = replicas * lanes / step

    # ---- TTFT: prefill + (pipeline) Eq. 1 fill ----------------------------
    pre_flops = costs.prefill_flops_per_tok * profile.prompt_mean
    pre_bytes = costs.weight_bytes_bf16 * wscale
    t_pre_dev = max((pre_flops / w) / peak, (pre_bytes / w) / hw.hbm_bw)
    if cand.mode == "serve_pipeline":
        fill = StageTiming(T=t_pre_dev, X=X_FRACTION * t_pre_dev,
                           d=hw.hop_s)
        ttft = total_latency(fill, w) + hw.dispatch_s
    else:
        ttft = t_pre_dev + hw.dispatch_s
    ttft += step  # first decoded token rides the next tick

    if disagg:
        # ---- disaggregated pools: transfer + queueing -----------------
        # Shipped bytes per cold admission: the prompt's pages (int8
        # arenas ship their scale planes too — kv_page_bytes counts them)
        # cross the pool link once, plus the paper's hop latency (Eq. 1's
        # d) and one ingest dispatch on the decode pool.
        p_pool = cand.disagg_prefill
        n_ship = max(int(math.ceil(profile.prompt_mean / cand.page_size)),
                     1)
        ship_bytes = n_ship * kv_page_bytes(cfg, cand.page_size,
                                            cand.kv_dtype, shards=1)
        t_ship = ship_bytes / hw.link_bw + hw.hop_s
        # Prefill pool: P parallel workers (the multi-process form; the
        # in-process pools serialise on the host, docs/serving.md), each
        # an M/M/1 at rate lambda/P with service = one bucketed prefill.
        rho = per_replica_rate * t_pre_dev / p_pool
        if rho >= 1.0:
            return _infeasible(
                cand, f"prefill pool saturated (util {rho:.2f} at "
                      f"{p_pool} prefill devices)")
        ingest = per_replica_rate * (t_ship + hw.dispatch_s)
        if ingest >= 1.0:
            return _infeasible(
                cand, "decode pool saturated by page ingest")
        tok_s *= 1.0 - ingest     # decode time lost to ingest dispatches
        ttft += t_ship + rho / (1.0 - rho) * t_pre_dev

    if cand.paged:
        # pool the engine would allocate: full residency for the lane
        # cap plus the trash page (engine default sizing), never more
        # than the budget buys
        pool_pages = min(pages, lanes_cap * pages_per_lane + 1)
        kv_used = pool_pages * kv_page_bytes(
            cfg, cand.page_size, cand.kv_dtype, shards=shards)
    else:
        pool_pages = 0
        kv_used = lanes_cap * lane_bytes
    hbm_used = weight_dev + kv_used
    detail = {"weight_gb_dev": weight_dev / 1e9,
              "lanes_cap": float(lanes_cap),
              "tick_ms": tick_s(lanes) * 1e3}
    if disagg:
        detail.update(ship_bytes_adm=float(ship_bytes),
                      t_ship_us=t_ship * 1e6, prefill_util=rho)
    return Score(
        cand=cand, feasible=True, tok_s=tok_s, ttft_ms=ttft * 1e3,
        step_ms=step * 1e3, hbm_frac=hbm_used / profile.hbm_bytes,
        lanes=lanes, replicas=replicas, kv_pages=pool_pages,
        detail=detail,
    )


# ---------------------------------------------------------------------------
# pareto + choice
# ---------------------------------------------------------------------------


def _dominates(a: Score, b: Score) -> bool:
    ge = (a.tok_s >= b.tok_s and a.ttft_ms <= b.ttft_ms
          and a.hbm_frac <= b.hbm_frac)
    gt = (a.tok_s > b.tok_s or a.ttft_ms < b.ttft_ms
          or a.hbm_frac < b.hbm_frac)
    return ge and gt


def pareto_frontier(scores: Sequence[Score]) -> List[Score]:
    feas = [s for s in scores if s.feasible]
    front = [s for s in feas
             if not any(_dominates(o, s) for o in feas if o is not s)]
    return sorted(front, key=lambda s: (-s.tok_s, s.ttft_ms, s.key))


def choose(scores: Sequence[Score],
           profile: TrafficProfile) -> Optional[Score]:
    """Deterministic winner: feasible, meets the TTFT target when one is
    declared (falls back to min-TTFT if nothing does), then max tok/s,
    tie-broken by lower TTFT, lower HBM, candidate key."""
    feas = [s for s in scores if s.feasible]
    if not feas:
        return None
    pool = feas
    if profile.ttft_target_ms > 0:
        meeting = [s for s in feas if s.ttft_ms <= profile.ttft_target_ms]
        pool = meeting or sorted(feas, key=lambda s: (s.ttft_ms, s.key))[:1]
    return sorted(pool, key=lambda s: (-s.tok_s, s.ttft_ms,
                                       s.hbm_frac, s.key))[0]


@dataclass
class SearchResult:
    profile: TrafficProfile
    scores: List[Score]
    frontier: List[Score]
    chosen: Optional[Score]

    @property
    def n_feasible(self) -> int:
        return sum(1 for s in self.scores if s.feasible)


def search(cfg, profile: TrafficProfile,
           hw: Optional[HardwareModel] = None) -> SearchResult:
    hw = hw or HardwareModel()
    costs = block_costs(cfg)
    scores = [score_candidate(cfg, c, profile, hw, costs)
              for c in enumerate_candidates(cfg, profile)]
    return SearchResult(profile=profile, scores=scores,
                        frontier=pareto_frontier(scores),
                        chosen=choose(scores, profile))


def realize(cfg, score: Score, mesh=None):
    """Turn the chosen Score into a ClusterPlan.  With mesh=None an
    abstract mesh of the candidate's shape is built (enough for --dryrun
    sharding inspection); pass a real mesh (launch/mesh.make_mesh) to
    deploy."""
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.launch.mesh import make_abstract_mesh
    cand = score.cand
    if cand.disagg_prefill:
        raise PlanSearchError(
            "disagg candidates own their device placement (no ClusterPlan "
            "to realize); deploy with launch/serve.py --disagg "
            f"{cand.disagg_prefill}:{cand.disagg_decode} --plan none")
    if mesh is None:
        if cand.mode == "serve":
            mesh = make_abstract_mesh(
                (score.replicas, cand.tp), ("data", "model"))
        else:
            mesh = make_abstract_mesh((cand.stages,), ("stage",))
    return build_plan(cfg, mesh, mode=cand.mode, exact=cand.exact)


def engine_kwargs(score: Score) -> Dict[str, Any]:
    """ContinuousBatchingEngine kwargs the chosen candidate implies."""
    cand = score.cand
    kw: Dict[str, Any] = {"paged": cand.paged}
    if cand.paged:
        kw.update(page_size=cand.page_size, kv_dtype=cand.kv_dtype)
    if cand.disagg_prefill:
        kw["disagg"] = (cand.disagg_prefill, cand.disagg_decode)
    return kw


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def to_snapshot(cfg, result: SearchResult) -> Dict[str, Any]:
    ch = result.chosen
    snap: Dict[str, Any] = {
        "arch": cfg.name,
        "cost_model_version": COST_MODEL_VERSION,
        "profile": result.profile.to_dict(),
        "n_candidates": len(result.scores),
        "n_feasible": result.n_feasible,
        "frontier": [s.key for s in result.frontier],
        "chosen": None,
    }
    if ch is not None:
        snap["chosen"] = {
            "key": ch.key, **asdict(ch.cand),
            "replicas": ch.replicas,
            "predicted": {"pred_tok_s": round(ch.tok_s, 3),
                          "pred_ttft_ms": round(ch.ttft_ms, 4),
                          "pred_hbm_frac": round(ch.hbm_frac, 4)},
        }
    return snap


def diff_snapshots(old: Dict[str, Any],
                   new: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """(hard drift, informational drift).  Structural changes — chosen
    candidate, frontier membership, profile, cost-model version — fail
    the gate; predicted-number deltas beyond 2 % are reported but
    informational (torch version skew can shift counted byte counts without
    changing the ranking)."""
    hard: List[str] = []
    info: List[str] = []
    for k in ("arch", "cost_model_version", "profile",
              "n_candidates", "n_feasible", "frontier"):
        if old.get(k) != new.get(k):
            hard.append(f"{k}: {old.get(k)!r} -> {new.get(k)!r}")
    oc, nc = old.get("chosen"), new.get("chosen")
    if (oc is None) != (nc is None):
        hard.append(f"chosen: {oc and oc.get('key')!r} -> "
                    f"{nc and nc.get('key')!r}")
    elif oc is not None and nc is not None:
        for k in sorted(set(oc) | set(nc)):
            if k == "predicted":
                continue
            if oc.get(k) != nc.get(k):
                hard.append(f"chosen.{k}: {oc.get(k)!r} -> {nc.get(k)!r}")
        op, np_ = oc.get("predicted") or {}, nc.get("predicted") or {}
        for k in sorted(set(op) | set(np_)):
            a, b = op.get(k), np_.get(k)
            if a is None or b is None or a == 0:
                if a != b:
                    info.append(f"predicted.{k}: {a!r} -> {b!r}")
            elif abs(b - a) / abs(a) > 0.02:
                info.append(f"predicted.{k}: {a} -> {b} "
                            f"({(b - a) / a:+.1%})")
    return hard, info


# ---------------------------------------------------------------------------
# predicted-vs-measured
# ---------------------------------------------------------------------------

# Acceptable predicted/measured tok/s ratio.  The
# calibration below pins the device's decode-step, dispatch and prefill
# costs on the same box in the same run, so machine speed cancels and the
# band only absorbs scheduler/occupancy modelling error plus noise.
PREDICTION_BAND = (0.5, 2.0)

# Occupancy constant: fraction of scheduler lanes carrying live tokens
# over a serve bench (admission ramps + tail drain keep it under 1).
STEADY_OCCUPANCY = 0.8
# Fraction of the dispatched horizon that emits surviving tokens.
HORIZON_UTILIZATION = 0.75


@dataclass(frozen=True)
class DeviceCalibration:
    """Two-point decode fit: time a fused n-step dispatch at n_lo and
    n_hi, then

        t_step     = (t_hi - t_lo) / (n_hi - n_lo)   marginal step cost
        t_dispatch = t_lo - n_lo * t_step            fixed launch cost

    — the measured analogue of the paper's Table 1 (T and I measured on
    the proof-of-concept, then projected).  `t_prefill_s` is a third
    probe: one batch-1 bucketed prefill dispatch, the unit the engine's
    admission path pays per request."""
    t_step_s: float
    t_dispatch_s: float
    t_prefill_s: float = 0.0

    @classmethod
    def from_two_point(cls, t_lo: float, n_lo: int, t_hi: float,
                       n_hi: int,
                       t_prefill: float = 0.0) -> "DeviceCalibration":
        step = max((t_hi - t_lo) / max(n_hi - n_lo, 1), 1e-9)
        return cls(t_step_s=step,
                   t_dispatch_s=max(t_lo - n_lo * step, 0.0),
                   t_prefill_s=t_prefill)


def predict_engine_tok_s(calib: DeviceCalibration, *, n_requests: int,
                         total_tokens: int, prompt_tokens: int,
                         max_batch: int, horizon: int) -> float:
    """Predicted end-to-end tok/s for a continuous-batching bench run
    from the calibrated step/dispatch costs and the stream's declared
    shape.  Kept deliberately simple — the point of the band is to
    catch the cost model drifting from the device, not to model the
    scheduler exactly."""
    lanes = max(max_batch * STEADY_OCCUPANCY, 1.0)
    steps = total_tokens / lanes
    h_eff = max(horizon * HORIZON_UTILIZATION, 1.0)
    decode_s = steps * calib.t_step_s + (steps / h_eff) * calib.t_dispatch_s
    # prefill: the engine admits one prompt per dispatch (batch-1
    # bucketed prefill) — priced by the calibration's prefill probe when
    # present, else approximated from the decode-step cost
    if calib.t_prefill_s > 0:
        per_req = calib.t_prefill_s
    else:
        per_req = (calib.t_dispatch_s
                   + calib.t_step_s * (prompt_tokens / max(n_requests, 1))
                   / max(max_batch, 1))
    return total_tokens / max(decode_s + n_requests * per_req, 1e-9)


def prediction_ratio_ok(ratio: float,
                        band: Tuple[float, float] = PREDICTION_BAND) -> bool:
    lo, hi = band
    return lo <= ratio <= hi
