"""Synthetic request streams: the port's own copy of the generators in
`repro/serving/stream.py`, with `Request` from the port's scheduler, and
the warm-up/measure harness `replay`.  `t_arrival` is seconds after the
engine's run() starts, with exponential inter-arrival gaps.  For one
`np.random.default_rng(seed)` each generator draws the reference's
requests: the same prompts, budgets and arrivals.
"""
from __future__ import annotations

import time
from typing import List, Tuple, Union

import numpy as np

from repro_torch.serving.scheduler import Request


def poisson_requests(rng: np.random.Generator, n: int, vocab_size: int,
                     len_range: Tuple[int, int] = (4, 30),
                     budgets: Union[int, Tuple[int, int]] = 8,
                     rate: float = 0.0) -> List[Request]:
    """n requests with uniform prompt lengths in ``len_range``, decode
    budgets fixed (int) or uniform in a (lo, hi) range, and Poisson
    arrivals at ``rate`` req/s (0 = everything arrives at t=0)."""
    lengths = rng.integers(len_range[0], len_range[1], n)
    if isinstance(budgets, tuple):
        buds = rng.integers(budgets[0], budgets[1], n)
    else:
        buds = np.full(n, budgets)
    gaps = (rng.exponential(1.0 / rate, n) if rate > 0
            else np.zeros(n))
    arrivals = np.cumsum(gaps)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size,
                                        lengths[i]).astype(np.int32),
                    max_new_tokens=int(buds[i]),
                    t_arrival=float(arrivals[i]))
            for i in range(n)]


def shared_prefix_requests(rng: np.random.Generator, n: int, vocab_size: int,
                           prefix_len: int = 48,
                           suffix_range: Tuple[int, int] = (3, 9),
                           budgets: Union[int, Tuple[int, int]] = (16, 48),
                           rate: float = 0.0) -> List[Request]:
    """n requests sharing one ``prefix_len``-token system prompt with unique
    uniform-length tails — the ingress the radix prefix cache targets."""
    prefix = rng.integers(0, vocab_size, prefix_len).astype(np.int32)
    suffixes = rng.integers(suffix_range[0], suffix_range[1], n)
    if isinstance(budgets, tuple):
        buds = rng.integers(budgets[0], budgets[1], n)
    else:
        buds = np.full(n, budgets)
    gaps = (rng.exponential(1.0 / rate, n) if rate > 0 else np.zeros(n))
    arrivals = np.cumsum(gaps)
    return [Request(rid=i,
                    prompt=np.concatenate(
                        [prefix, rng.integers(0, vocab_size, suffixes[i])
                         .astype(np.int32)]),
                    max_new_tokens=int(buds[i]),
                    t_arrival=float(arrivals[i]))
            for i in range(n)]



def multi_prefix_requests(rng: np.random.Generator, n: int, vocab_size: int,
                          n_prefixes: int = 4, prefix_len: int = 48,
                          suffix_range: Tuple[int, int] = (3, 9),
                          budgets: Union[int, Tuple[int, int]] = (16, 48),
                          rate: float = 0.0) -> List[Request]:
    """n requests drawn over ``n_prefixes`` distinct shared system prompts
    (uniform random assignment) — the multi-tenant ingress the fleet
    router's prefix-affinity dispatch targets: each prefix group hits one
    replica's radix tree under affinity routing, while round-robin pays a
    cold prefill per (replica, prefix) pair."""
    prefixes = [rng.integers(0, vocab_size, prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]
    which = rng.integers(0, n_prefixes, n)
    suffixes = rng.integers(suffix_range[0], suffix_range[1], n)
    if isinstance(budgets, tuple):
        buds = rng.integers(budgets[0], budgets[1], n)
    else:
        buds = np.full(n, budgets)
    gaps = (rng.exponential(1.0 / rate, n) if rate > 0 else np.zeros(n))
    arrivals = np.cumsum(gaps)
    return [Request(rid=i,
                    prompt=np.concatenate(
                        [prefixes[which[i]],
                         rng.integers(0, vocab_size, suffixes[i])
                         .astype(np.int32)]),
                    max_new_tokens=int(buds[i]),
                    t_arrival=float(arrivals[i]))
            for i in range(n)]


def bursty_requests(rng: np.random.Generator, n: int, vocab_size: int,
                    short_range: Tuple[int, int] = (8, 16),
                    long_range: Tuple[int, int] = (180, 240),
                    burst_every: int = 8, burst_size: int = 4,
                    budgets: Union[int, Tuple[int, int]] = (6, 12),
                    rate: float = 0.0) -> List[Request]:
    """Phase-skewed arrivals: steady short-prompt decode traffic with
    long-prompt *bursts* injected every ``burst_every`` steady arrivals
    (``burst_size`` long prompts land at the same instant).  Each burst
    member costs a large-bucket prefill, and every short request queued
    behind the burst pays for it in TTFT: the ingress the disaggregated
    prefill/decode pools target.

    Short vs long is classifiable from ``len(prompt)`` alone (the ranges
    must not overlap); the request count is exactly ``n``.  Purely
    rng-driven, so a stream is deterministic under `clone_requests`."""
    if short_range[1] > long_range[0]:
        raise ValueError("bursty_requests: short_range and long_range "
                         "overlap — burst membership must be classifiable "
                         "from prompt length")
    reqs: List[Request] = []
    t = 0.0
    steady = 0
    while len(reqs) < n:
        if steady and steady % burst_every == 0:
            # a burst: `burst_size` long prompts at this instant
            for _ in range(min(burst_size, n - len(reqs))):
                ln = int(rng.integers(long_range[0], long_range[1]))
                bud = (int(rng.integers(budgets[0], budgets[1]))
                       if isinstance(budgets, tuple) else int(budgets))
                reqs.append(Request(
                    rid=len(reqs),
                    prompt=rng.integers(0, vocab_size, ln).astype(np.int32),
                    max_new_tokens=bud, t_arrival=t))
            steady += 1  # one burst per boundary, then steady resumes
            continue
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        ln = int(rng.integers(short_range[0], short_range[1]))
        bud = (int(rng.integers(budgets[0], budgets[1]))
               if isinstance(budgets, tuple) else int(budgets))
        reqs.append(Request(
            rid=len(reqs),
            prompt=rng.integers(0, vocab_size, ln).astype(np.int32),
            max_new_tokens=bud, t_arrival=t))
        steady += 1
    return reqs


def clone_requests(reqs: List[Request]) -> List[Request]:
    """Fresh Request objects over the same prompts/budgets/arrivals (for
    replaying one stream through several engines)."""
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
                    t_arrival=r.t_arrival) for r in reqs]


def replay(engine, stream: List[Request], warmup: bool = True):
    """Run `stream` through `engine`; returns (done, wall_s, tok_s, ttft_ms).

    warmup=True first replays the stream unmeasured, then measures a
    second pass.  ttft_ms is the list of per-request first-token latencies
    (measured from simulated arrival)."""
    if warmup:
        for r in clone_requests(stream):
            engine.submit(r)
        engine.run()
    for r in clone_requests(stream):
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens_out) for r in done)
    ttft = [(r.t_first_token - r.t_enqueue) * 1e3 for r in done]
    return done, wall, toks / wall, ttft
