"""Straggler detection & mitigation.

At 1000+ nodes, tail-latency steps (one slow host, a flaky link) dominate
synchronous training.  The monitor keeps an EMA of step times, flags steps
slower than `threshold` x EMA, and drives two mitigations:

  * skip-and-resync: if a *data host* is the straggler, its shard for this
    step is dropped and the gradient is rescaled (bounded staleness — the
    SPMD equivalent of the paper's per-cluster input buffering riding out a
    slow cluster).
  * admission deadline (serving): the continuous-batching engine admits
    requests into freed slots between decode steps; `AdmissionDeadline`
    bounds how long an arrived request may be jumped by warm-bucket peers
    before it is force-admitted FIFO.  (The legacy wave engine used the
    same deadline to launch partial waves.)

On this CPU container the "slow node" is injected by tests via a delay hook.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerMonitor:
    threshold: float = 2.5  # x EMA counts as straggler
    ema_decay: float = 0.9
    warmup_steps: int = 3

    _ema: Optional[float] = None
    _n: int = 0
    events: List[dict] = field(default_factory=list)

    def observe(self, step: int, duration: float) -> bool:
        """Record a step time; returns True if flagged as a straggler."""
        self._n += 1
        if self._ema is None:
            self._ema = duration
            return False
        flagged = (self._n > self.warmup_steps
                   and duration > self.threshold * self._ema)
        if flagged:
            self.events.append({"step": step, "duration": duration,
                                "ema": self._ema})
        else:
            # stragglers don't poison the EMA
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * duration)
        return flagged

    @property
    def ema(self) -> Optional[float]:
        return self._ema


@dataclass
class AdmissionDeadline:
    """Serving admission deadline (paper §8.2 line-rate ingress analogue).

    A request that has waited longer than `deadline_s` since arrival takes
    absolute priority in core/packing.AdmissionPolicy — bucket-warmth
    preferences may reorder younger requests only.  deadline_s <= 0 disables
    reordering entirely (strict FIFO admission).
    """

    deadline_s: float = 0.05

    def overdue(self, wait_s: float) -> bool:
        return wait_s >= self.deadline_s


def timed(monitor: StragglerMonitor, step: int, fn: Callable, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    flagged = monitor.observe(step, time.perf_counter() - t0)
    return out, flagged
