"""Failure injection + checkpoint/restart recovery loop (port of
`repro/runtime/fault_tolerance.py`; host code, unchanged).

Paper §6: "When one FPGA fails in a cluster, only the cluster that holds the
failed FPGA needs to be re-configured ... packets sent to this cluster will
be buffered in the cluster input buffer."  At pod scale the analogue is:
detect the failure, restore the last checkpoint (possibly onto a smaller
elastic mesh, see elastic.py), and replay from the buffered data-pipeline
position — which is deterministic here, so replay = reseeking the pipeline.

`run_with_recovery` is the generic loop used by launch/train.py and the
fault-tolerance tests; failures are injected deterministically so tests are
reproducible.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)


class SimulatedFailure(RuntimeError):
    """Stands in for a lost TPU slice / preempted pod."""

    def __init__(self, step: int, kind: str = "node_loss"):
        super().__init__(f"simulated {kind} at step {step}")
        self.step = step
        self.kind = kind


@dataclass
class FailureInjector:
    """Deterministic failure schedule: {step: kind}."""

    schedule: Dict[int, str] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(step, self.schedule[step])


@dataclass
class RecoveryReport:
    restarts: int = 0
    failed_steps: List[int] = field(default_factory=list)
    completed_steps: int = 0
    recovered_from: List[int] = field(default_factory=list)


def run_with_recovery(
    make_state: Callable[[], Any],
    train_steps: Callable[[Any, int, int], Any],
    save: Callable[[int, Any], None],
    restore: Callable[[], Optional[tuple]],
    total_steps: int,
    checkpoint_every: int,
    max_restarts: int = 8,
) -> tuple:
    """Generic restartable loop.

    train_steps(state, start, stop) runs [start, stop) and may raise
    SimulatedFailure (or any RuntimeError); restore() -> (step, state) | None.
    """
    report = RecoveryReport()
    restored = restore()
    if restored is not None:
        start, state = restored
        report.recovered_from.append(start)
    else:
        start, state = 0, make_state()

    step = start
    while step < total_steps:
        stop = min(step + checkpoint_every, total_steps)
        try:
            state = train_steps(state, step, stop)
            step = stop
            save(step, state)
            report.completed_steps = step
        except (SimulatedFailure, RuntimeError) as e:
            report.restarts += 1
            report.failed_steps.append(getattr(e, "step", step))
            if report.restarts > max_restarts:
                raise
            log.warning("failure %s; restoring last checkpoint", e)
            restored = restore()
            if restored is None:
                step, state = 0, make_state()
            else:
                step, state = restored
            report.recovered_from.append(step)
    return state, report
