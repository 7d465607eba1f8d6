"""Synthetic request streams: the port's own copy of the generators in
`repro/serving/stream.py`, with `Request` from the port's scheduler.
`t_arrival` is seconds after the engine's run() starts, with exponential
inter-arrival gaps.
"""
from __future__ import annotations

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

