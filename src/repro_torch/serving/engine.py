"""The paged continuous-batching engine: the composition root over the
scheduler (host policy), the executor (device work) and the KV manager
(page pool + radix prefix cache).  Port of `repro/serving/engine.py`,
single device, paged path only.

Admission: a radix hit reuses the shared prefix pages and its suffix
rides the decode loop's forced-token queue; a cold request is prefilled
at its bucket and scattered into its own pages, and its full prompt pages
are registered for later hits.  Decode: one fused n-step dispatch per
loop turn, one (n, B) token fetch, host-side reconciliation.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import bucket_len
from repro_torch.models.transformer import Model
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.serving.executor import PAD_TOKEN, Executor
from repro_torch.serving.kv_manager import KVManager, paged_eligible
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["ContinuousBatchingEngine", "Request", "PAD_TOKEN"]


class ContinuousBatchingEngine:
    """Slot-asynchronous serving over a paged KV arena: admit into freed
    lanes between fused decode dispatches.

    Not ported yet (each raises): a ClusterPlan, speculative decoding
    (`spec_config`), int8 KV pages, disaggregated pools, W8A8 weights, and
    the dense slot path (`paged=False` or a config that is not
    all-attention, unwindowed and causal).
    """

    def __init__(self, model: Model, params, max_batch: int = 8,
                 buckets=(32, 64, 128, 256), deadline_s: float = 0.05,
                 plan=None, max_decode_len: int = 64,
                 decode_horizon: int = 8,
                 monitor: Optional[StragglerMonitor] = None,
                 quant_weights: bool = False, paged="auto",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_hit_suffix: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 spec_config: Optional[dict] = None,
                 disagg: Optional[Tuple[int, int]] = None):
        unported = {"plan": plan is not None,
                    "spec_config": bool(spec_config),
                    "kv_dtype='int8'": kv_dtype != "bf16",
                    "disagg": disagg is not None,
                    "quant_weights": bool(quant_weights)}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"not ported yet: {', '.join(bad)} (see ROADMAP.md, port "
                "queue)")
        if paged is False or not paged_eligible(model.cfg):
            raise NotImplementedError(
                "the dense slot path (paged=False, or a recurrent / "
                "windowed / non-causal config) arrives with a later slice")
        self.model = model
        self.max_batch = max_batch
        self.buckets = tuple(sorted(buckets))
        self.monitor = monitor
        self.page_size = page_size
        # whole-page lane capacity: prompt bucket + decode headroom
        cache_len = bucket_len(max(self.buckets), self.buckets,
                               lane=8) + max_decode_len
        self.cache_len = -(-cache_len // page_size) * page_size
        self.max_pages = self.cache_len // page_size
        if num_pages is None:  # default: dense table capacity + trash page
            num_pages = max_batch * self.max_pages + 1
        self.sched = Scheduler(self.buckets, deadline_s, decode_horizon,
                               max_batch)
        self.executor = Executor(model, params, max_batch=max_batch,
                                 cache_len=self.cache_len,
                                 buckets=self.buckets)
        self.kv = KVManager(num_pages, page_size, max_batch, self.max_pages)
        self.max_hit_suffix = (max(self.buckets) if max_hit_suffix is None
                               else max_hit_suffix)
        self._slot_caches = None
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "decode_dispatches": 0, "device_syncs": 0,
                      "admitted": 0, "completed": 0, "prefills": 0,
                      "active_lane_steps": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "preemptions": 0,
                      "pages_in_use": 0, "pages_peak": 0}

    policy = property(lambda self: self.sched.policy)

    def submit(self, req: Request) -> None:
        need = self.policy.bucket_of(len(req.prompt)) + req.max_new_tokens
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: bucket+budget {need} exceeds lane "
                f"cache_len {self.cache_len} (raise max_decode_len)")
        if self.kv.pages_for(need) > self.kv.num_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {self.kv.pages_for(need)} pages,"
                f" pool has {self.kv.num_pages - 1} (raise num_pages)")
        self.sched.enqueue(req)

    # -- admission -----------------------------------------------------------

    def _greedy_next(self, logits: torch.Tensor) -> int:
        self.stats["device_syncs"] += 1
        return int(torch.argmax(logits[0], dim=-1))

    def _admit(self, r: Request, sl: int, st) -> bool:
        """Radix hit -> reuse shared pages, suffix rides the forced-token
        queue; cold -> bucket prefill scattered into owned pages + prompt
        registered.  False = the pool can't cover it (nothing held)."""
        prompt = r.effective_prompt()
        grant = self.kv.admit(prompt, r.remaining(), self.max_hit_suffix)
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
            self.stats["prefill_tokens"] += len(prompt)
            logits, small = ex.prefill_prompts([prompt], 1)
            bucket = bucket_len(len(prompt), self.buckets, lane=8)
            n_wp = min(self.kv.pages_for(bucket), len(grant.pages))
            ex.admit_cold(st, sl, small, grant.pt_row, len(prompt),
                          grant.reset, np.asarray(grant.pages[:n_wp],
                                                  np.int32))
            self.stats["prefills"] += 1
            self.kv.register_prefix(prompt, grant.pages)
            t_now = time.perf_counter()
            r.t_admitted = t_now
            r.append_token(self._greedy_next(logits), t_now)
            self.sched.lane_forced[sl] = 0
            if not r.done:
                ex.admit_lane_paged(st, sl, r.tokens_out[-1], r.eos_id,
                                    r.remaining(), np.zeros((0,), np.int32),
                                    0)
        self.kv.commit(sl, grant)
        self.stats["pages_in_use"] = self.kv.pages_in_use
        self.stats["pages_peak"] = max(self.stats["pages_peak"],
                                       self.kv.pages_in_use)
        return True

    def _release(self, sl: int) -> None:
        self.kv.release(sl)
        self.sched.lane_forced[sl] = 0
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

    # -- serving loop ----------------------------------------------------------

    def run(self) -> List[Request]:
        """Serve until queue + lanes drain; returns requests sorted by rid.
        Admission honours `Request.t_arrival` (seconds after this call)."""
        if self._slot_caches is None:
            self._slot_caches = self.executor.init_caches(
                self.page_size, self.kv.num_pages, self.max_pages)
        st = self.executor.fresh_state(self._slot_caches)
        done: List[Request] = []
        pending = self.sched.take_queue()
        slots: List[Optional[Request]] = [None] * self.max_batch
        t0 = time.perf_counter()
        for r in pending:  # latency clocks start at simulated arrival
            r.t_enqueue = max(r.t_enqueue, t0 + r.t_arrival)

        while pending or any(r is not None for r in slots):
            now = time.perf_counter() - t0
            free = self.sched.order_free(
                [i for i, r in enumerate(slots) if r is None], slots)
            admitted, starved = self.sched.admission_cycle(
                pending, free, now, self.executor.warm_buckets,
                lambda r, sl: self._admit(r, sl, st))
            for r, sl in admitted:
                pending.remove(r)
                if r.done:  # budget of 1 / instant EOS at admission
                    done.append(r)
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

            n = self.sched.pick_horizon(bool(pending),
                                        self.sched.lane_remaining(slots))
            t_step = time.perf_counter()
            toks = self.executor.decode(st, n)
            block = toks.cpu().numpy()  # the only per-dispatch device sync
            if self.monitor is not None:
                self.monitor.observe(self.stats["decode_steps"] + n,
                                     (time.perf_counter() - t_step) / n)
            self.sched.reconcile(block, slots, done, n, self.stats,
                                 time.perf_counter(), True, self._release)

        self.kv.assert_drained()
        self._slot_caches = st["caches"]
        return sorted(done, key=lambda r: r.rid)

