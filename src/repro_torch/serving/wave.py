"""WaveEngine: the batch-synchronous baseline (port of
`repro/serving/wave.py`).  One batched prefill per wave into dense slot
rows spanning cache_len, then fused decode dispatches until every member
finishes; finished rows feed PAD_TOKEN behind the decode active mask.
Re-exported lazily from serving/engine.py.

A wave's prefill runs in request blocks of at most EXACT_ROWS_MAX rows
(`Executor._prefill`), so its products stay on the K-ordered gemm.
Under a ``mode="serve"`` plan the wave's dense rows are sharded by kv
head and kernel 3 launches once per shard, its streams bit for bit one
device's.  A serve_pipeline plan refuses, as in the reference.
"""
from __future__ import annotations

import time
from typing import List

import torch

# engine.py imports this module lazily, after EngineBase exists, so the
# circular import resolves in definition order
from repro_torch.serving import engine as _engine
from repro_torch.serving.executor import PAD_TOKEN
from repro_torch.serving.scheduler import Request


class WaveEngine(_engine.EngineBase):
    """Batch-synchronous baseline: deadline-batched waves of up to
    max_batch requests, each served to completion."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.plan is not None and self.plan.mode == "serve_pipeline":
            raise ValueError(
                "serve_pipeline drives the continuous engine's fixed-lane "
                "decode state; the wave baseline has no fixed batch")
        self.stats.update(waves=0)

    def run(self) -> List[Request]:
        done: List[Request] = []
        pending = self.sched.take_queue()
        t0 = time.perf_counter()
        for r in pending:  # latency clocks start at simulated arrival
            r.t_enqueue = max(r.t_enqueue, t0 + r.t_arrival)
        deadline_s = self.policy.deadline.deadline_s
        while pending:
            # deadline batching: launch a partial wave at the deadline
            # instead of waiting for a full batch
            while True:
                now = time.perf_counter() - t0
                arrived = [r for r in pending if r.t_arrival <= now]
                if len(arrived) >= self.max_batch:
                    break
                if len(arrived) == len(pending):
                    break  # nobody else can join: don't sit out the deadline
                if arrived and now - min(
                        r.t_arrival for r in arrived) >= deadline_s:
                    break
                nxt = min((r.t_arrival for r in pending
                           if r.t_arrival > now), default=float("inf"))
                wake = min([nxt] + [r.t_arrival + deadline_s
                                    for r in arrived])
                time.sleep(max(min(wake - now, 0.005), 0.0005))
            wave = arrived[: self.max_batch]
            for r in wave:
                pending.remove(r)
            done += self._serve_wave(wave)
        return done

    def _serve_wave(self, wave: List[Request]) -> List[Request]:
        self.stats["waves"] += 1
        logits, caches = self._prefill([r.prompt for r in wave], len(wave))
        nxt = self._greedy_next(logits)
        now = time.perf_counter()
        for i, r in enumerate(wave):
            r.append_token(int(nxt[i]), now)
        # decode state moves to the device once per wave; the fused horizon
        # loop feeds tokens back on the device and ships (n, b) blocks out
        dev = self.executor.device

        def lanes(vals, dtype=torch.int32):
            return torch.tensor(vals, dtype=dtype, device=dev)

        st = {"caches": caches,
              "cur": lanes([PAD_TOKEN if r.done else r.tokens_out[-1]
                            for r in wave]),
              "active": lanes([not r.done for r in wave], torch.bool),
              "eos": lanes([r.eos_id for r in wave]),
              "budget": lanes([r.remaining() for r in wave])}

        while not all(r.done for r in wave):
            n = self.sched.pick_horizon(
                False, [r.remaining() for r in wave if not r.done])
            t_step = time.perf_counter()
            toks = self.executor.decode(st, n, paged=False)
            self.stats["decode_dispatches"] += 1
            self.stats["decode_steps"] += n
            self.stats["device_syncs"] += 1
            block = toks.cpu().numpy()  # the only per-dispatch device sync
            if self.monitor is not None:
                self.monitor.observe(self.stats["decode_steps"],
                                     (time.perf_counter() - t_step) / n)
            self.sched.append_block(block, wave, time.perf_counter())
        return wave
