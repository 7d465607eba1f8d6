"""Host-side serving policy (no device code): admission, preemption, the horizon
ladder, and token-stream reconciliation.

Everything here is pure scheduling state — which request enters which
lane, how many fused decode steps the next dispatch should run, how a
fetched token block maps back onto request streams, who gets preempted
under pool pressure.  Device work lives in serving/executor.py; page
accounting lives in serving/kv_manager.py; serving/engine.py composes the
three.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.packing import AdmissionPolicy
from repro_torch.runtime.stragglers import AdmissionDeadline


@dataclass(eq=False)  # identity equality: rid is caller-chosen, prompt is a
class Request:        # numpy array (== would be ambiguous), requests mutate
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never
    t_arrival: float = 0.0  # seconds after engine start (Poisson streams)
    tokens_out: List[int] = field(default_factory=list)
    done: bool = False
    n_preempts: int = 0  # preemption-cascade damping (Scheduler.victim)
    t_enqueue: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def append_token(self, tok: int, now: float) -> None:
        assert not self.done, \
            f"request {self.rid}: token appended after done"
        if not self.tokens_out:
            self.t_first_token = now
        self.tokens_out.append(int(tok))
        if tok == self.eos_id or len(self.tokens_out) >= self.max_new_tokens:
            self.done = True
            self.t_done = now

    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens_out)

    def effective_prompt(self) -> np.ndarray:
        """Prompt + tokens already generated: greedy decode is
        deterministic, so a preempted request re-enters as if its output
        so far had been part of the prompt and continues its stream."""
        if not self.tokens_out:
            return self.prompt
        return np.concatenate(
            [np.asarray(self.prompt, np.int32),
             np.asarray(self.tokens_out, np.int32)])


class Scheduler:
    """Admission ordering + decode-horizon policy for one engine.

    Owns the waiting queue and the host mirror of per-lane forced-token
    (prefix-hit suffix ingest) counts; never touches device state.
    """

    def __init__(self, buckets: Sequence[int], deadline_s: float,
                 decode_horizon: int, max_batch: int,
                 preempt_budget: int = 2):
        assert decode_horizon >= 1
        self.policy = AdmissionPolicy(
            buckets=tuple(sorted(buckets)), lane=8,
            deadline=AdmissionDeadline(deadline_s))
        self.decode_horizon = decode_horizon
        # powers of two bound the number of compiled horizon programs;
        # decode_horizon=1 is the one-dispatch-per-token baseline
        self.horizons = [h for h in (1, 2, 4, 8, 16, 32, 64, 128)
                         if h <= decode_horizon] or [1]
        self.queue: List[Request] = []
        self.lane_forced = [0] * max_batch  # host mirror of suffix ingest
        # preemption-cascade damping: a request preempted this many times
        # is excluded from victim() and jumps the admission order instead,
        # so a hot shared prefix can't starve one lane through the
        # evict/preempt loop indefinitely
        self.preempt_budget = preempt_budget
        # speculation-depth ladder (speculative decoding; set_spec): each
        # lane carries an acceptance EWMA and its own depth; a dispatch
        # speculates at the shallowest occupied lane's depth so no lane
        # pays for draft tokens its stream keeps rejecting
        self.spec_ladder: List[int] = []
        self.lane_spec_k = [0] * max_batch
        self.lane_accept = [1.0] * max_batch
        # lane groups (request-skewed pipeline; set_lane_groups): lanes
        # partition into contiguous groups, one per pipeline stage offset
        self.max_batch = max_batch
        self.n_lane_groups = 1
        # disaggregated prefill/decode (set_disagg): a classifier splits
        # the waiting queue into a prefill queue (cold prompts — they owe
        # the prefill pool a bucketed dispatch) and a decode-ingest queue
        # (radix prefix hits — they skip prefill AND the page transfer),
        # each with its own occupancy signal for the fleet router
        self._hit_len = None  # classify(req) -> cached-prefix positions
        self.prefill_chunk = 1

    # -- disaggregated queues (prefill pool vs decode ingest) ----------------

    def set_disagg(self, hit_len, prefill_chunk: int = 1) -> None:
        """Enable the split admission queues.  `hit_len(req)` returns the
        request's advisory cached-prefix length in positions (0 = cold —
        the request owes the prefill pool a bucketed dispatch; > 0 = the
        decode pool can ingest it directly).  `prefill_chunk` caps
        non-overdue cold admissions per cycle so a long-prompt burst
        cannot monopolize consecutive admission windows — the TTFT knob
        the disaggregation buys (docs/serving.md §disaggregated
        serving)."""
        assert prefill_chunk >= 1
        self._hit_len = hit_len
        self.prefill_chunk = prefill_chunk

    # -- lane groups (request-skewed serve_pipeline) -------------------------

    def set_lane_groups(self, n_groups: int) -> None:
        """Partition the lanes into `n_groups` contiguous groups — the
        request-skewed pipeline's unit of schedule offset (stage s runs
        group g while stage s-1 runs group g+1).  Groups are fixed slabs
        of the batch (lane i belongs to group i // (max_batch/n_groups)):
        a lane never changes group, so admission/preemption churn can't
        interleave two groups' decode positions mid-flight."""
        assert n_groups >= 1 and self.max_batch % n_groups == 0, \
            (self.max_batch, n_groups)
        self.n_lane_groups = n_groups

    def lane_group(self, slot: int) -> int:
        return slot // (self.max_batch // self.n_lane_groups)

    def order_free(self, free: List[int],
                   slots: Sequence[Optional[Request]]) -> List[int]:
        """Admission order over free slots: fill the emptiest lane group
        first (ties: lowest group, then lowest slot).  The skewed
        schedule runs every group each tick, so a group left empty while
        another saturates is pure bubble — balancing admissions across
        groups is the host-side half of filling the pipeline, and because
        every group gains occupants before any group gains a second one,
        no group (and no lane) can starve behind a hot neighbour."""
        if self.n_lane_groups <= 1:
            return free
        occ = [0] * self.n_lane_groups
        for i, r in enumerate(slots):
            if r is not None:
                occ[self.lane_group(i)] += 1
        # rank = the group's occupancy *as of this slot's admission* (one
        # cycle admits down the list in order), so a burst round-robins
        # the groups instead of packing the first one solid
        rank, seen = {}, [0] * self.n_lane_groups
        for s in sorted(free):
            g = self.lane_group(s)
            rank[s] = occ[g] + seen[g]
            seen[g] += 1
        return sorted(free, key=lambda s: (rank[s], self.lane_group(s), s))

    # -- queue ---------------------------------------------------------------

    def enqueue(self, req: Request) -> None:
        req.t_enqueue = time.perf_counter()
        self.queue.append(req)

    def queue_depth(self, pool: Optional[str] = None) -> int:
        """Requests waiting for admission (the fleet router's shedding
        signal: serving/router.py sheds when every replica's depth
        exceeds its configured budget).

        pool=None counts the whole queue (the router's historical
        signal); pool="prefill" counts requests owing a prefill-pool
        dispatch, pool="decode" the decode-ingest (prefix-hit) queue —
        with no classifier set, every admission pays prefill, so
        "prefill" is the whole queue and "decode" empty."""
        if pool is None:
            return len(self.queue)
        assert pool in ("prefill", "decode"), pool
        if self._hit_len is None:
            return len(self.queue) if pool == "prefill" else 0
        hits = sum(self._hit_len(r) > 0 for r in self.queue)
        return hits if pool == "decode" else len(self.queue) - hits

    def projected_occupancy(self, pool: Optional[str] = None) -> int:
        """Projected queued work in token-steps: per waiting request, the
        bucketed prompt cost (prefill rides a bucket-padded dispatch) plus
        the decode budget still owed.  The fleet router's least-loaded
        placement ranks replicas by this figure — it is the queue-side
        analogue of `order_free`'s per-group occupancy ranking, exported
        because between `run()` drains the queue is the whole backlog.

        pool=None is the combined figure (back-compatible).  Under
        disaggregation the two pools carry different work for the same
        request: pool="prefill" sums the bucketed prompt cost of COLD
        queued requests only (what the prefill pool owes — the signal a
        router uses to route around a saturated prefill pool);
        pool="decode" sums every request's decode budget plus, for
        prefix hits, the un-hit suffix it re-ingests through the forced
        queue (hits never touch the prefill pool)."""
        if pool is None:
            return sum(self.policy.bucket_of(len(r.prompt)) + r.remaining()
                       for r in self.queue)
        assert pool in ("prefill", "decode"), pool
        hit = self._hit_len if self._hit_len is not None else (lambda r: 0)
        if pool == "prefill":
            return sum(self.policy.bucket_of(len(r.prompt))
                       for r in self.queue if hit(r) <= 0)
        return sum(r.remaining()
                   + (max(0, len(r.prompt) - h) if (h := hit(r)) > 0 else 0)
                   for r in self.queue)

    def take_queue(self) -> List[Request]:
        pending, self.queue = self.queue, []
        return pending

    def select(self, arrived: Sequence[Request], n_free: int, warm,
               now: float) -> List[Request]:
        """Requests to admit, in order (deadline-overdue FIFO first, then
        warm buckets — core/packing.AdmissionPolicy)."""
        pick = self.policy.select(arrived, n_free, warm=warm, now=now)
        return [arrived[p] for p in pick]

    def admission_cycle(self, pending, free: List[int], now: float, warm,
                        admit):
        """One admission pass: call ``admit(req, slot)`` for each selected
        arrival while free slots last.  Returns (admitted [(req, slot)],
        starved) — `starved` is the head-of-line request the backing store
        couldn't cover (admit returned False; nothing was mutated for it),
        the signal for preempt-to-free."""
        arrived = [r for r in pending if r.t_arrival <= now]
        admitted, starved = [], None
        if free and arrived:
            # preemption-cascade damping: victims already preempted to
            # their budget are admitted first (FIFO among themselves),
            # ahead of the policy's ordering — they have paid for their
            # pages enough times
            hot = [r for r in arrived if r.n_preempts >= self.preempt_budget]
            rest = [r for r in arrived if r.n_preempts < self.preempt_budget]
            if self._hit_len is not None:
                order = hot + self._disagg_order(rest, now)
            else:
                order = hot + (self.select(rest, len(free) - len(hot),
                                           warm, now)
                               if rest and len(free) > len(hot) else [])
            for r in order:
                if not free:
                    break
                if not admit(r, free[0]):
                    starved = r
                    break
                admitted.append((r, free.pop(0)))
        return admitted, starved

    def _disagg_order(self, rest, now: float):
        """Admission order under split queues.  Decode-ingest requests
        (advisory prefix hits) admit first, FIFO, without limit — they
        cost the decode pool a pt/reset update and zero prefill-pool or
        transfer work.  Cold requests go through the prefill pool:
        deadline-overdue ones keep their FIFO guarantee, then at most
        `prefill_chunk` more per cycle ordered shortest-bucket-first —
        SJF bounds how long a long-prompt burst can stall the short
        steady traffic queued behind it, and because admission order
        changes only WHEN a request runs (greedy lanes decode
        independently), the streams stay bit-identical to colocated
        FIFO serving."""
        ingest = [r for r in rest if self._hit_len(r) > 0]
        cold = [r for r in rest if self._hit_len(r) <= 0]
        dl = self.policy.deadline
        overdue = [r for r in cold
                   if dl is not None and dl.overdue(now - r.t_arrival)]
        fresh = sorted((r for r in cold if r not in overdue),
                       key=lambda r: (self.policy.bucket_of(len(r.prompt)),
                                      r.t_enqueue))
        return ingest + overdue + fresh[:self.prefill_chunk]

    @staticmethod
    def idle_wait(pending, starved, now: float) -> None:
        """Nothing resident: sleep to the next arrival, or a beat while a
        pool-starved admission waits for eviction to free pages."""
        if starved is not None:
            time.sleep(0.0005)
        elif pending:
            wait = min(r.t_arrival for r in pending) - now
            if wait > 0:
                time.sleep(min(wait, 0.005))

    def should_preempt(self, starved, now: float) -> bool:
        """Deadline pressure on a pool-starved admission triggers
        preempt-to-free."""
        return (starved is not None and self.policy.deadline is not None
                and self.policy.deadline.overdue(now - starved.t_arrival))

    # -- horizon -------------------------------------------------------------

    def pick_horizon(self, waiting: bool, remaining: List[int]) -> int:
        """Adaptive decode horizon from admission pressure.

        With `waiting` requests, aim for the next *predicted* completion
        (min remaining budget) so a slot frees — and is refilled — at the
        earliest useful horizon boundary, floored at 4 steps so dispatch
        overhead stays amortized (a completion can overshoot by at most 3
        masked slot-steps); with a drained queue run up to the longest
        remaining budget.  EOS can still end a lane mid-horizon; those
        lanes decode masked until the boundary (wasted slot-steps, never
        wrong tokens)."""
        if waiting:
            target = max(min(remaining), min(4, self.decode_horizon))
        else:
            target = max(remaining)
        n = 1
        for h in self.horizons:
            if h <= max(1, target):
                n = h
        return n

    def lane_remaining(self, slots: Sequence[Optional[Request]]) -> List[int]:
        """Per-occupied-lane work left: pending forced ingest + budget."""
        return [self.lane_forced[i] + r.remaining()
                for i, r in enumerate(slots) if r is not None]

    def consume_forced(self, slots: Sequence[Optional[Request]],
                       n: int) -> None:
        for i in range(len(slots)):
            if slots[i] is not None:
                self.lane_forced[i] = max(0, self.lane_forced[i] - n)

    # -- reconciliation ------------------------------------------------------

    @staticmethod
    def append_block(block: np.ndarray, requests, now: float) -> None:
        """Reconcile one fetched (n, B) token block into request streams.

        -1 marks a step at which the lane emitted nothing: a free slot, a
        lane that early-exited on device after EOS/budget (-1 *suffix*), or
        a prefix-hit lane still ingesting its prompt suffix through the
        forced-token queue (-1 *prefix*) — so -1 entries are skipped, not
        treated as end-of-block.  Device-side masking mirrors
        `Request.append_token`'s done rule, so the host appends every
        non-negative token until its own done flag flips; nothing real can
        follow a lane's device-side exit."""
        for i, r in enumerate(requests):
            if r is None or r.done:
                continue
            for tok in block[:, i]:
                if tok < 0:
                    continue
                r.append_token(int(tok), now)
                if r.done:
                    break

    def reconcile(self, block: np.ndarray, slots, done: List[Request],
                  n: int, stats: dict, now: float, paged: bool,
                  on_release=None) -> None:
        """Post-dispatch bookkeeping: account the fused dispatch, mirror
        suffix-ingest consumption, append streams, sweep completed lanes
        (calling ``on_release(slot)`` for paged page returns)."""
        stats["decode_dispatches"] += 1
        stats["decode_steps"] += n
        stats["device_syncs"] += 1
        stats["active_lane_steps"] += sum(r is not None for r in slots) * n
        if paged:
            self.consume_forced(slots, n)
        self.append_block(block, slots, now)
        for i, r in enumerate(slots):
            if r is not None and r.done:
                done.append(r)
                slots[i] = None  # device lane already inactive
                if on_release is not None:
                    on_release(i)
                stats["completed"] += 1

    # -- preemption ----------------------------------------------------------

    def victim(self, slots: Sequence[Optional[Request]]) -> Optional[int]:
        """The occupied lane with the most work left (it holds the most
        still-unearned pages); None when nothing runs.  Lanes whose
        occupant has exhausted its preemption budget are exempt — without
        the damping, a hot shared prefix keeps re-admitting over the same
        victim and one request ping-pongs between lane and queue forever
        (tests/test_serving.py::test_preemption_budget_stops_cascade)."""
        occ = [(i, r) for i, r in enumerate(slots)
               if r is not None and r.n_preempts < self.preempt_budget]
        if not occ:
            return None
        return max(occ, key=lambda ir: ir[1].remaining())[0]

    # -- speculation depth ---------------------------------------------------

    def set_spec(self, spec_k: int) -> None:
        """Enable the speculation-depth ladder up to `spec_k` drafted
        tokens per dispatch (powers of two, like the horizon ladder, to
        bound compiled spec programs)."""
        assert spec_k >= 1
        self.spec_ladder = [h for h in (1, 2, 4, 8) if h <= spec_k] or [1]
        top = self.spec_ladder[-1]
        self.lane_spec_k = [top] * len(self.lane_spec_k)
        self.lane_accept = [1.0] * len(self.lane_accept)

    def reset_lane_spec(self, slot: int) -> None:
        """New occupant: start at full depth with a clean acceptance EWMA
        (greedy acceptance is a property of the stream, not the lane)."""
        if self.spec_ladder:
            self.lane_spec_k[slot] = self.spec_ladder[-1]
            self.lane_accept[slot] = 1.0

    def observe_acceptance(self, slot: int, accepted: int, k: int) -> None:
        """Fold one dispatch's acceptance (accepted drafted tokens out of
        k proposed) into the lane's EWMA and walk its depth along the
        ladder: persistent rejection shrinks k toward 1 (each rejected
        draft costs a wasted draft forward + verify row), sustained
        acceptance grows it back."""
        if not self.spec_ladder:
            return
        acc = accepted / max(k, 1)
        ew = self.lane_accept[slot] = (0.5 * self.lane_accept[slot]
                                       + 0.5 * acc)
        cur = self.lane_spec_k[slot]
        i = self.spec_ladder.index(cur)
        if ew < 0.4 and i > 0:
            self.lane_spec_k[slot] = self.spec_ladder[i - 1]
        elif ew > 0.8 and i < len(self.spec_ladder) - 1:
            self.lane_spec_k[slot] = self.spec_ladder[i + 1]

    def spec_depth(self, slots: Sequence[Optional[Request]],
                   starved: bool) -> int:
        """Drafted tokens for the next dispatch: the shallowest occupied
        lane's ladder depth, or 0 (speculation off, plain fused decode)
        under admission pressure — a pool-starved arrival means every
        speculative margin page is a page eviction could free, and the
        overshoot past completion boundaries delays the slot hand-off."""
        if not self.spec_ladder or starved:
            return 0
        ks = [self.lane_spec_k[i] for i, r in enumerate(slots)
              if r is not None]
        return min(ks) if ks else 0
