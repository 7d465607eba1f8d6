"""The paper's pipeline latency model (§8.2.2, Eq. 1), in plain Python.

  T_total(L) = T + (L - 1) * (X + d)

  T : latency of one encoder (first input -> last output)
  X : time until an encoder emits its FIRST output packet
  d : inter-cluster network hop (switch) latency
  L : number of serially-connected encoder clusters

The paper measures X, T, I (packet interval) per sequence length on the
6-FPGA proof-of-concept (Table 1), then projects the 72-FPGA full model
(Table 2) and the Versal variant (§9, X ~= 0.53 T).  The port's copy of
`repro.core.latency_model`: `launch/ibert_encoder.py` prints the
12-encoder estimate with it, the serving pipelines count their ticks
with it (`serving/executor.py`: the drained schedule's 2S - 1
stage-passes a step, the request-skewed one's S), and `core/plan_search`
prices pipeline prefill fill with Eq. 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence


@dataclass(frozen=True)
class StageTiming:
    T: float  # per-stage total latency (s)
    X: float  # time-to-first-output (s)
    d: float  # inter-stage hop latency (s)
    I: float = 0.0  # steady-state output interval (s)


def total_latency(t: StageTiming, n_stages: int) -> float:
    """Eq. 1."""
    return t.T + (n_stages - 1) * (t.X + t.d)


def throughput(t: StageTiming, items_per_stage_pass: int = 1) -> float:
    """Steady-state items/s: the pipeline drains at the slowest stage rate
    (paper §8.2.3: 'overall throughput should be the same as the layers with
    the lowest throughput')."""
    return items_per_stage_pass / max(t.T, 1e-12)


def fit_x_fraction(x_values: Sequence[float], t_values: Sequence[float]
                   ) -> float:
    """X as a fraction of T (the paper's §9 uses X ~= 0.53 T at seq 128)."""
    num = sum(x * t for x, t in zip(x_values, t_values))
    den = sum(t * t for t in t_values)
    return num / max(den, 1e-12)


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


def estimate_table2(t_by_seq: Dict[int, float], x_by_seq: Dict[int, float],
                    d: float, n_stages: int) -> Dict[int, float]:
    """Reproduce the structure of the paper's Table 2 from measured T/X."""
    return {
        s: total_latency(StageTiming(T=t_by_seq[s], X=x_by_seq[s], d=d),
                         n_stages)
        for s in t_by_seq
    }
