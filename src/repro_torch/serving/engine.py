"""Serving engines: the composition root over the scheduler (host policy),
the executor (device work) and the KV manager (page pool + radix prefix
cache).  Port of `repro/serving/engine.py`.

`ContinuousBatchingEngine` admits into freed lanes between fused decode
dispatches, over a paged KV arena (bf16 or int8) or over dense slot rows
(`paged=False`).  On the paged path a radix hit reuses the shared prefix
pages and its suffix rides the decode loop's forced-token queue; a cold
request is prefilled at its bucket and scattered into its own pages, and
its full prompt pages are registered for later hits.  On dense slots each
admission is a batch-1 prefill inserted into the lane's row.  With a
draft model (`spec_config`) a paged engine speculates: each lane also
holds pages of the draft's arena, and a dispatch drafts, verifies and
accepts up to spec_k + 1 tokens per lane.
`WaveEngine` (serving/wave.py), the batch-synchronous baseline, shares
`EngineBase`.  Decode: one fused n-step dispatch per loop turn, one (n, B)
token fetch, host-side reconciliation.

A `plan` (core/cluster_builder.build_plan) places the model over a
device mesh through the executor: a ``mode="serve"`` plan serves the
paged arena sharded by kv head (exact gather-form TP, or the psum form
under ``exact=False``), speculation included, for the attention-only
and MoE families (a MoE layer's experts split over the shards), and the
recurrent families' dense slot rows (the RG-LRU cut by width, the mLSTM
and sLSTM projections by column, their cells whole on the controller);
an exact ``mode="serve_pipeline"`` plan streams the dense slot path
through its stages (any family whose layer periods divide the stages:
the recurrent and MoE ones too), and an ``exact=False`` one (the
request-skewed throughput pipeline) serves from stage-local paged arenas
with one lane group per stage (the attention-only and MoE families).  A
plan whose axis is 1 wide runs the plain programs on its mesh's device.

``disagg=(P, D)`` splits a paged engine into a prefill pool and a decode
pool: cold admissions prefill on the prefill pool into a staging arena,
and their pages ship into the decode arena (`executor.ship_pages`).  The
pools take their devices by `launch/mesh.make_mesh`'s rule (pool device
i on ``cuda:(i % count)``, so on a one-card host both pools share it;
all on the CPU for a CPU model), where the reference raises unless the
host has P + D devices.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import bucket_len
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.serving.executor import PAD_TOKEN, Executor
from repro_torch.serving.kv_manager import (KVManager, kv_page_bytes,
                                            paged_eligible)
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "WaveEngine", "EngineBase",
           "Request", "PAD_TOKEN"]


def plan_cuts(plan) -> bool:
    """Does `plan` place anything over more than one shard (its stage
    axis, or its tensor-parallel one)?"""
    if plan is None:
        return False
    axis = (plan.axes.stage if plan.mode == "serve_pipeline"
            else plan.axes.tp)
    return plan.mesh.shape[axis] > 1


def _check_plan(plan, buckets=()) -> None:
    """What the port's plans do not take: a tensor-parallel plan's prefill
    longer than the K-ordered products run (one request at its bucket:
    max(buckets) rows).  A ``mode="serve"`` plan takes every decoder
    family: attention by kv head, a MoE layer's experts by block
    (models/moe.py), the recurrent mixers by width or by column
    (models/recurrent.py; the mLSTM and sLSTM cells whole on the
    controller), and W8A8 weights by their parent's blocks
    (models/quantized.py).  A serve_pipeline plan takes every family, and
    W8A8 too: it needs the layers in whole periods (no tail), and only 2-d
    (tail) projections are quantized, so its weights stay bf16."""
    if plan is None:
        return
    if plan.mode not in ("serve", "serve_pipeline"):
        raise ValueError(f"plan mode {plan.mode!r}: the serving engines "
                         "take 'serve' or 'serve_pipeline' plans")
    if plan.mesh.abstract:
        raise ValueError("a plan on an abstract mesh has no devices: "
                         "build it on make_mesh(...) to serve")
    if not plan_cuts(plan) or plan.mode != "serve":
        return
    from repro_torch.models.layers import EXACT_ROWS_MAX
    if max(buckets, default=0) > EXACT_ROWS_MAX:
        raise ValueError(
            f"buckets {tuple(buckets)}: a tensor-parallel serve plan "
            f"prefills at most EXACT_ROWS_MAX = {EXACT_ROWS_MAX} rows (the "
            "K-ordered products; models/layers.py)")


class EngineBase:
    """Shared composition: scheduler + executor, stats, prefill plumbing.

    ``quant_weights=True`` serves W8A8 (`models/quantized.py`): the
    executor quantizes the params once, at construction, as the
    reference's does.  Only 2-d projections are quantized, i.e. those of
    the tail layers: for recurrentgemma-2b its two tail MLPs, which then
    run through `int8_matmul`; for smollm-135m and the other
    attention-only families every projection is stacked over layers (3-d),
    so nothing changes.  Under a ``mode="serve"`` plan that cuts, each
    shard runs its blocks of the quantized weights (serving/executor.py),
    and an exact plan gives one device's bits."""

    def __init__(self, model: Model, params, max_batch: int = 8,
                 buckets=(32, 64, 128, 256), deadline_s: float = 0.05,
                 plan=None, max_decode_len: int = 64,
                 decode_horizon: int = 8,
                 monitor: Optional[StragglerMonitor] = None,
                 quant_weights: bool = False):
        _check_plan(plan, buckets)
        self.plan = plan
        self.model = model
        self.max_batch = max_batch
        self.buckets = tuple(sorted(buckets))
        self.monitor = monitor
        self.paged = False  # ContinuousBatchingEngine may flip this
        self.spec_k = 0  # drafted tokens per speculative dispatch, or 0
        # lane rows: prompt KV + decode headroom, fixed per engine
        self.cache_len = bucket_len(max(self.buckets), self.buckets,
                                    lane=8) + max_decode_len
        self.sched = Scheduler(self.buckets, deadline_s, decode_horizon,
                               max_batch)
        self.executor = Executor(model, params, max_batch=max_batch,
                                 cache_len=self.cache_len,
                                 buckets=self.buckets,
                                 quant_weights=quant_weights, plan=plan)
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "decode_dispatches": 0, "device_syncs": 0}

    policy = property(lambda self: self.sched.policy)

    def submit(self, req: Request) -> None:
        need = self.policy.bucket_of(len(req.prompt)) + req.max_new_tokens
        # speculation scatters up to spec_k rows past the committed
        # position; the lane's page table must cover the overshoot
        need += self.spec_k
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: bucket+budget {need} exceeds lane "
                f"cache_len {self.cache_len} (raise max_decode_len)")
        if self.paged and self.kv.pages_for(need) > self.kv.num_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {self.kv.pages_for(need)} pages,"
                f" pool has {self.kv.num_pages - 1} (raise num_pages)")
        self.sched.enqueue(req)

    def _prefill(self, prompts, batch: int, bucket_cache: bool = False):
        self.stats["prefill_tokens"] += int(sum(len(p) for p in prompts))
        return self.executor.prefill_prompts(prompts, batch,
                                             bucket_cache=bucket_cache)

    def _greedy_next(self, logits: torch.Tensor) -> np.ndarray:
        self.stats["device_syncs"] += 1
        return torch.argmax(logits, dim=-1).cpu().numpy()


class ContinuousBatchingEngine(EngineBase):
    """Slot-asynchronous serving: admit into freed lanes between fused
    decode dispatches.

    ``paged`` (default "auto") serves from the page arena + radix prefix
    cache where the model allows it (all-attention, unwindowed, causal),
    else from dense slot rows; ``kv_dtype="int8"`` quantizes the arena.
    ``spec_config`` (paged only) serves greedy speculative decoding: a
    dict with ``draft_model``, ``draft_params``, ``spec_k`` (default 4)
    and ``draft_num_pages`` (default: the target pool's count).  The
    draft proposes up to spec_k tokens per lane per dispatch from its own
    page arena, the target verifies them in one pass, and the streams
    equal plain greedy decoding, also under a ``mode="serve"`` plan.
    Under an ``exact=False`` serve_pipeline plan the arena is stage-local
    (`KVManager(shards=S)`) and the lanes form S groups, one per stage
    offset of the skewed schedule.  ``disagg=(P, D)`` (paged, plan-free,
    no speculation) serves from separate prefill and decode pools
    (`_init_disagg`).
    """

    def __init__(self, *args, paged="auto", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_hit_suffix: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 spec_config: Optional[dict] = None,
                 disagg: Optional[Tuple[int, int]] = None, **kw):
        super().__init__(*args, **kw)
        self.disagg = tuple(disagg) if disagg is not None else None
        self.stats.update(admitted=0, completed=0, prefills=0,
                          active_lane_steps=0)
        self._slot_caches = None
        eligible = paged_eligible(self.model.cfg, self.plan)
        if paged == "auto":
            paged = eligible
        elif paged and not eligible:
            raise ValueError(
                "paged KV needs an all-attention, unwindowed, causal model "
                "(recurrent state and ring buffers have no paged analogue) "
                "under no plan, a mode='serve' plan, or a throughput "
                "(exact=False) serve_pipeline plan (the exact pipeline "
                "streams the dense slot path)")
        self.paged = bool(paged)
        # throughput pipeline (exact=False serve_pipeline): stage-local
        # arenas + lane groups, one group per stage schedule offset
        self._stage_n = 0
        if (self.plan is not None and self.plan.mode == "serve_pipeline"
                and not self.plan.exact):
            if spec_config:
                raise ValueError(
                    "spec_config does not compose with the request-skewed "
                    "serve_pipeline plan (the spec program has no skewed "
                    "schedule); serve speculation from a mode='serve' plan")
            self._stage_n = self.plan.mesh.shape[self.plan.axes.stage]
            if self.max_batch % self._stage_n:
                raise ValueError(
                    f"request-skewed serve_pipeline splits the batch into "
                    f"one lane group per stage: max_batch={self.max_batch} "
                    f"must be a multiple of the stage count "
                    f"{self._stage_n}")
            if plan_cuts(self.plan) and not self.paged:
                raise ValueError(
                    "the request-skewed serve_pipeline decodes from the "
                    "paged arena: drop paged=False")
            self.sched.set_lane_groups(self._stage_n)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}: want 'bf16' or 'int8'")
        if kv_dtype == "int8" and not self.paged:
            raise ValueError(
                "kv_dtype='int8' needs the paged KV pool (quantized dense "
                "slot rows are not implemented); this model/config fell "
                "back to dense slots")
        self.kv_dtype = kv_dtype
        self.kv: Optional[KVManager] = None
        self.spec = bool(spec_config)
        self._draft_slot_caches = None
        if self.spec and not self.paged:
            raise ValueError(
                "spec_config needs the paged KV pool: the draft arena and "
                "the batched verify both address KV through page tables")
        if self.paged:
            self.page_size = page_size
            # whole-page capacity: gathered paged layout == dense slot row
            self.cache_len = -(-self.cache_len // page_size) * page_size
            self.executor.cache_len = self.cache_len
            self.max_pages = self.cache_len // page_size
            if num_pages is None:  # default: dense table capacity + trash
                num_pages = self.max_batch * self.max_pages + 1
            draft_num_pages = 0
            if self.spec:
                # the draft arena defaults to position parity with the
                # target's: every target page a lane can hold has a draft
                # twin (kv_manager.spec_pool_split sizes both from one
                # byte budget when the caller wants byte parity)
                self.spec_k = int(spec_config.get("spec_k", 4))
                if self.spec_k < 1:
                    raise ValueError(f"spec_k {self.spec_k}: want >= 1")
                self.draft_model: Model = spec_config["draft_model"]
                draft_num_pages = int(spec_config.get("draft_num_pages")
                                      or num_pages)
                self.executor.set_draft(self.draft_model,
                                        spec_config["draft_params"])
                self.sched.set_spec(self.spec_k)
                self._spec_warm = False
                self._tpos = [0] * self.max_batch  # target positions
                self._dpos = [0] * self.max_batch  # draft positions
                self.stats.update(spec_dispatches=0, spec_draft_steps=0,
                                  spec_accepted=0, spec_proposed=0,
                                  spec_draft_prefills=0,
                                  spec_catchup_tokens=0)
            self.kv = KVManager(num_pages, page_size, self.max_batch,
                                self.max_pages,
                                draft_num_pages=draft_num_pages,
                                shards=self._stage_n or 1)
            self.max_hit_suffix = (max(self.buckets)
                                   if max_hit_suffix is None
                                   else max_hit_suffix)
            self.stats.update(prefix_hits=0, prefix_hit_tokens=0,
                              preemptions=0, pages_in_use=0, pages_peak=0)
        if self.disagg is not None:
            self._init_disagg()

    def _init_disagg(self) -> None:
        """Disaggregated prefill/decode pools (`disagg=(P, D)`): pool
        devices [0, P) prefill, [P, P+D) decode, each pool device i on
        `make_mesh`'s ``cuda:(i % count)`` (every one on the CPU for a
        CPU model).  The prefill pool owns bucketed prefill and a
        transient staging arena; completed pages ship into the decode
        arena (executor.ship_pages) and ownership moves with them.  One
        radix tree — the decode pool's — spans both: it indexes
        decode-arena pages only, so a prefix hit admits without touching
        the prefill pool at all."""
        p, d = self.disagg
        if not self.paged:
            raise ValueError(
                "disagg needs the paged KV pool: page shipping is the "
                "ownership-handoff mechanism (dense slot rows have no "
                "transferable unit)")
        if self.plan is not None:
            raise ValueError(
                "disagg does not compose with a ClusterPlan (the plan "
                "already owns device placement); pick one")
        if self.spec:
            raise ValueError(
                "disagg does not compose with spec_config (the draft "
                "arena has no shipping path yet)")
        if p < 1 or d < 1:
            raise ValueError(
                f"disagg={self.disagg}: needs prefill >= 1 and decode >= 1 "
                "pool devices")
        mesh = make_mesh((p + d,), ("pool",), device=self.model.device.type)
        self.executor.set_disagg(mesh.devices[:p], mesh.devices[p:])
        if mesh.shared_devices():  # for the log, as the plan notes
            self.executor.notes.append(
                f"disagg={self.disagg}: {p + d} pool devices on "
                f"{len(set(mesh.devices))} device(s): the pools share them, "
                "so the program is the same, the scaling is not")
        # staging KV: one admission in flight, so max_pages + trash always
        # covers the export
        self.kv_prefill = KVManager(self.max_pages + 1, self.page_size, 1,
                                    self.max_pages)
        self._prefill_arena = None
        self.stats.update(shipped_pages=0, shipped_bytes=0,
                          ship_dispatches=0)
        # queue split: the radix peek classifies pending requests into the
        # decode-ingest queue (hit: admits decode-side, zero transfers)
        # and the prefill queue, and drives the pool-aware occupancy
        # signals the fleet router reads.  prefill_chunk=max_batch keeps
        # admission work-conserving: the pools drain one after another
        # in this process, so throttling colds below free-lane capacity
        # only delays them; the SJF order alone shields steady short
        # traffic from a long-prompt burst
        self.sched.set_disagg(
            lambda r: self.kv.peek_hit(np.asarray(r.effective_prompt())),
            prefill_chunk=self.max_batch)

    def hit_stats(self) -> dict:
        """Prefix-reuse summary with the derived hit rate — the
        per-replica figure the fleet router aggregates; dense engines
        report zeros (no radix tree to hit)."""
        s = self.stats
        admitted = s.get("admitted", 0)
        hits = s.get("prefix_hits", 0)
        return {"admitted": admitted, "prefix_hits": hits,
                "prefix_hit_tokens": s.get("prefix_hit_tokens", 0),
                "prefix_hit_rate": hits / admitted if admitted else 0.0}

    def kv_page_bytes(self) -> int:
        """Per-device HBM bytes one arena page costs at this engine's
        kv_dtype (stage-local arenas hold 1/stages of the stack)."""
        return kv_page_bytes(self.model.cfg, self.page_size, self.kv_dtype,
                             shards=self._stage_n or 1)

    # -- admission -----------------------------------------------------------

    def _admit_dense(self, r: Request, sl: int, st) -> bool:
        """Batch-1 prefill + insert into slot `sl`; TTFT paid here."""
        logits, small = self._prefill([r.prompt], 1, bucket_cache=True)
        st["caches"] = self.executor.insert(st["caches"], small, sl)
        self.stats["prefills"] += 1
        self.stats["admitted"] += 1
        self._first_token(r, int(self._greedy_next(logits)[0]))
        if not r.done:
            self.executor.admit_lane(st, sl, r.tokens_out[-1], r.eos_id,
                                     r.remaining())
        return True

    def _admit_paged(self, r: Request, sl: int, st) -> bool:
        """Radix hit -> reuse shared pages, suffix rides the forced-token
        queue; cold -> bucket prefill scattered into owned pages + prompt
        registered.  False = the pool can't cover it (nothing held)."""
        prompt = r.effective_prompt()
        grant = self.kv.admit(prompt, r.remaining(), self.max_hit_suffix,
                              spec_margin=self.spec_k)
        if grant is None:
            return False
        self.stats["admitted"] += 1
        ex = self.executor
        if grant.hit_len:
            suffix = prompt[grant.hit_len:]
            ex.admit_hit(st, sl, grant.pt_row, grant.hit_len, grant.reset)
            ex.admit_lane_paged(st, sl, int(suffix[0]), r.eos_id,
                                r.remaining(), suffix[1:], len(suffix) - 1)
            self.sched.lane_forced[sl] = len(suffix) - 1
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += int(grant.hit_len)
            r.t_admitted = time.perf_counter()
        else:
            logits, small = self._prefill([prompt], 1, bucket_cache=True)
            bucket = bucket_len(len(prompt), self.buckets, lane=8)
            n_wp = min(self.kv.pages_for(bucket), len(grant.pages))
            if self.disagg is not None:
                self._ship_cold(st, sl, small, grant, prompt, n_wp)
            else:
                ex.admit_cold(st, sl, small, grant.pt_row, len(prompt),
                              grant.reset, np.asarray(grant.pages[:n_wp],
                                                      np.int32))
            self.stats["prefills"] += 1
            self.kv.register_prefix(prompt, grant.pages)
            self._first_token(r, int(self._greedy_next(logits)[0]))
            self.sched.lane_forced[sl] = 0
            if not r.done:
                ex.admit_lane_paged(st, sl, r.tokens_out[-1], r.eos_id,
                                    r.remaining(), np.zeros((0,), np.int32),
                                    0)
        self.kv.commit(sl, grant)
        if self.spec and not r.done:
            self._admit_draft(r, sl, st, grant, prompt)
        self.stats["pages_in_use"] = self.kv.pages_in_use
        self.stats["pages_peak"] = max(self.stats["pages_peak"],
                                       self.kv.pages_in_use)
        return True

    def _ship_cold(self, st, sl: int, small, grant, prompt,
                   n_wp: int) -> None:
        """The disaggregated ownership handoff for one cold admission.

        The request is prefill-owned while its bucket cache scatters into
        staging pages of the prefill pool's arena, then decode-owned once
        `ship_pages` lands those pages in the lane's granted decode pages.
        admit_hit first sentinels every granted page and points the lane's
        table row at them, so the shipped page contents (what admit_cold
        would have written, partial-page sentinel kpos and int8 scale
        planes included) arrive into the arena state colocated serving
        would hold."""
        ex = self.executor
        src = self.kv_prefill.stage_export(n_wp)
        self._prefill_arena = ex.prefill_admit(
            self._prefill_arena, small, src.pt_row, len(prompt), src.reset,
            np.asarray(src.pages, np.int32))
        ex.admit_hit(st, sl, grant.pt_row, len(prompt), grant.reset)
        ex.ship_pages(self._prefill_arena, st, src.pages, grant.pages[:n_wp])
        self.kv_prefill.finish_export(src.pages)
        self.stats["ship_dispatches"] += 1
        self.stats["shipped_pages"] += n_wp
        self.stats["shipped_bytes"] += n_wp * self.kv_page_bytes()

    def _admit_draft(self, r: Request, sl: int, st, grant, prompt) -> None:
        """Bring the lane's draft cache to the target's position: a cold
        lane prefills its whole effective prompt on the draft model, a
        prefix-hit lane prompt[:hit_len] (page-aligned, so the rest of the
        suffix ingests in lockstep through the spec dispatch's forced
        queue; the draft has no radix tree to hit on)."""
        plen = grant.hit_len if grant.hit_len else len(prompt)
        small, bucket = self.executor.draft_prefill_prompts(
            [prompt[:plen]], 1)
        n_wp = min(self.kv.draft_pool.pages_for(bucket),
                   len(grant.draft_pages))
        self.executor.admit_cold_draft(
            st, sl, small, grant.draft_pt_row, plen, grant.draft_reset,
            np.asarray(grant.draft_pages[:n_wp], np.int32))
        self._tpos[sl] = self._dpos[sl] = int(plen)
        self.sched.reset_lane_spec(sl)
        self.stats["spec_draft_prefills"] += 1

    @staticmethod
    def _first_token(r: Request, tok: int) -> None:
        t_now = time.perf_counter()
        r.t_admitted = t_now
        r.append_token(tok, t_now)

    def _release(self, sl: int) -> None:
        self.kv.release(sl)
        self.sched.lane_forced[sl] = 0
        if self.spec:
            self._tpos[sl] = self._dpos[sl] = 0
        self.stats["pages_in_use"] = self.kv.pages_in_use

    def _preempt(self, slots, pending, st) -> None:
        """Evict the lane with the most work left; greedy decode is
        deterministic, so the re-queued victim continues exactly where it
        stopped (usually as a prefix hit on its own pages)."""
        sl = self.sched.victim(slots)
        if sl is None:
            return
        victim, slots[sl] = slots[sl], None
        victim.n_preempts += 1
        self.executor.park_lane(st, sl)
        self._release(sl)
        pending.append(victim)
        self.stats["preemptions"] += 1

    # -- speculation bookkeeping -----------------------------------------------

    def _advance_mirrors(self, block: np.ndarray, slots, n: int) -> None:
        """Advance the host's target-position mirrors by what the device
        consumed: per live lane, min(pending forced, n) swallowed
        positions plus one per emitted token (each consumed step is one or
        the other, in decode_steps and in the spec block alike)."""
        for i, r in enumerate(slots):
            if r is None:
                continue
            emitted = int((block[:, i] >= 0).sum())
            self._tpos[i] += min(self.sched.lane_forced[i], n) + emitted

    def _reconcile_spec(self, block: np.ndarray, slots, k: int) -> None:
        """A spec dispatch's bookkeeping, before the scheduler's: one
        (k+1, B) block; acceptance drives each lane's depth ladder, and
        both position mirrors move together (the device rewound both
        counters alike)."""
        self.stats["spec_dispatches"] += 1
        self.stats["spec_draft_steps"] += k + 1
        self._advance_mirrors(block, slots, k + 1)
        for i, r in enumerate(slots):
            if r is None:
                continue
            self._dpos[i] = self._tpos[i]  # verify + rewind keep them equal
            emitted = int((block[:, i] >= 0).sum())
            if emitted >= 1 and self.sched.lane_forced[i] == 0:
                # emitted = 1 sure token + accepted drafts (+ the bonus);
                # a forced-ingest dispatch says nothing about the draft
                accepted = min(emitted - 1, k)
                self.stats["spec_accepted"] += accepted
                self.stats["spec_proposed"] += k
                self.sched.observe_acceptance(i, accepted, k)

    def _spec_catchup(self, slots, st) -> None:
        """Feed draft lanes the stream tokens the target consumed during
        plain dispatches, so each draft cache re-enters speculation at its
        target's exact position."""
        lags = [(self._tpos[i] - self._dpos[i]) if r is not None else 0
                for i, r in enumerate(slots)]
        width = max(lags)
        if width <= 0:
            return
        tokens = np.zeros((self.max_batch, width), np.int32)
        for i, r in enumerate(slots):
            if r is None or lags[i] == 0:
                continue
            stream = np.concatenate(
                [np.asarray(r.prompt, np.int32),
                 np.asarray(r.tokens_out, np.int32)])
            tokens[i, :lags[i]] = stream[self._dpos[i]:self._tpos[i]]
            self._dpos[i] = self._tpos[i]
        self.executor.draft_catchup(st, tokens, np.asarray(lags, np.int32))
        self.stats["spec_catchup_tokens"] += int(sum(lags))

    # -- serving loop ----------------------------------------------------------

    def run(self) -> List[Request]:
        """Serve until queue + lanes drain; returns requests sorted by rid.
        Admission honours `Request.t_arrival` (seconds after this call)."""
        if self._slot_caches is None:
            self._slot_caches = self.executor.init_caches(
                self.paged, *((self.page_size, self.kv.num_pages,
                               self.max_pages, self.kv_dtype)
                              if self.paged else ()))
        if self.spec and self._draft_slot_caches is None:
            self._draft_slot_caches = self.executor.init_draft_caches(
                self.page_size, self.kv.draft_pool.num_pages,
                self.max_pages, self.kv_dtype)
        if self.disagg is not None and self._prefill_arena is None:
            self._prefill_arena = self.executor.init_prefill_arena(
                self.page_size, self.kv_prefill.num_pages, self.max_pages,
                self.kv_dtype)
        st = self.executor.fresh_state(
            self._slot_caches, self.paged,
            draft_caches=self._draft_slot_caches if self.spec else None)
        if self.spec and not self._spec_warm:
            self.executor.warm_spec(st, self.sched.spec_ladder)
            self._spec_warm = True
        done: List[Request] = []
        pending = self.sched.take_queue()
        slots: List[Optional[Request]] = [None] * self.max_batch
        admit = self._admit_paged if self.paged else self._admit_dense
        t0 = time.perf_counter()
        for r in pending:  # latency clocks start at simulated arrival
            r.t_enqueue = max(r.t_enqueue, t0 + r.t_arrival)

        while pending or any(r is not None for r in slots):
            now = time.perf_counter() - t0
            free = self.sched.order_free(
                [i for i, r in enumerate(slots) if r is None], slots)
            admitted, starved = self.sched.admission_cycle(
                pending, free, now, self.executor.warm_buckets,
                lambda r, sl: admit(r, sl, st))
            for r, sl in admitted:
                pending.remove(r)
                if r.done:  # budget of 1 / instant EOS at admission
                    done.append(r)
                    if self.paged:
                        self._release(sl)
                    free.insert(0, sl)
                    self.stats["completed"] += 1
                else:
                    slots[sl] = r
            if self.sched.should_preempt(starved, now):
                self._preempt(slots, pending, st)
            if not any(r is not None for r in slots):
                self.sched.idle_wait(pending, starved,
                                     time.perf_counter() - t0)
                continue

            k = (self.sched.spec_depth(slots, starved is not None)
                 if self.spec else 0)
            t_step = time.perf_counter()
            if k:
                self._spec_catchup(slots, st)
                toks = self.executor.spec_decode(st, k)
                n = k + 1
            else:
                n = self.sched.pick_horizon(bool(pending),
                                            self.sched.lane_remaining(slots))
                toks = self.executor.decode(st, n, self.paged)
            block = toks.cpu().numpy()  # the only per-dispatch device sync
            if self.monitor is not None:
                self.monitor.observe(self.stats["decode_steps"] + n,
                                     (time.perf_counter() - t_step) / n)
            if k:
                self._reconcile_spec(block, slots, k)
            elif self.spec:  # a plain dispatch: the draft lags until the
                self._advance_mirrors(block, slots, n)  # next catch-up
            self.sched.reconcile(block, slots, done, n, self.stats,
                                 time.perf_counter(), self.paged,
                                 self._release if self.paged else None)

        if self.paged:
            self.kv.assert_drained()
            if self.disagg is not None:
                # exports are transient: every staged page was returned by
                # finish_export before its admission completed
                self.kv_prefill.assert_drained()
        self._slot_caches = st["caches"]
        self._draft_slot_caches = st.get("draft_caches")
        return sorted(done, key=lambda r: r.rid)


def __getattr__(name):  # PEP 562: WaveEngine (serving/wave.py) subclasses
    if name == "WaveEngine":  # EngineBase — lazy both ways, no import cycle
        from repro_torch.serving.wave import WaveEngine
        return WaveEngine
    raise AttributeError(name)
