"""The paper's pipeline latency model (§8.2.2, Eq. 1), in plain Python.

  T_total(L) = T + (L - 1) * (X + d)

  T : latency of one encoder (first input -> last output)
  X : time until an encoder emits its FIRST output packet
  d : inter-cluster network hop (switch) latency
  L : number of serially-connected encoder clusters

The port's copy of the part of `repro.core.latency_model` that
`launch/ibert_encoder.py` uses to print the 12-encoder estimate.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StageTiming:
    T: float  # per-stage total latency (s)
    X: float  # time-to-first-output (s)
    d: float  # inter-stage hop latency (s)


def total_latency(t: StageTiming, n_stages: int) -> float:
    """Eq. 1."""
    return t.T + (n_stages - 1) * (t.X + t.d)
