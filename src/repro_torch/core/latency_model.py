"""The paper's pipeline latency model (§8.2.2, Eq. 1), in plain Python.

  T_total(L) = T + (L - 1) * (X + d)

  T : latency of one encoder (first input -> last output)
  X : time until an encoder emits its FIRST output packet
  d : inter-cluster network hop (switch) latency
  L : number of serially-connected encoder clusters

The port's copy of the part of `repro.core.latency_model` that
`launch/ibert_encoder.py` uses to print the 12-encoder estimate, and the
serving pipelines' tick accounting (`serving/executor.py`: the drained
schedule's 2S - 1 stage-passes a step, the request-skewed one's S).
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


def pipeline_bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble: (S-1)/(M+S-1), Eq. 1's fill/drain overhead."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_ticks_per_step(n_stages: int, exact: bool) -> int:
    """Stage-passes one decode step costs on an S-stage serving pipeline.

    exact (the drained schedule): every lane's token traverses all S
    stages and the pipeline drains before the next step, 2S-1 ticks.
    Throughput (the request-skewed schedule): each stage advances its own
    lane group every tick, so a full rotation emits one token per lane in
    S ticks with no drain bubble."""
    if n_stages <= 1:
        return 1
    return 2 * n_stages - 1 if exact else n_stages


def decode_step_latency(t_stage: float, n_stages: int, d: float,
                        exact: bool) -> float:
    """One decode step through the pipeline: Eq. 1 with X = T per stage
    (a single-token step emits its output only when the stage finishes),
    scaled by the schedule's ticks a step."""
    return pipeline_ticks_per_step(n_stages, exact) * (t_stage + d)
