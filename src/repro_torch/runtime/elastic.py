"""Elastic re-meshing after capacity loss (port of
`repro/runtime/elastic.py`; host code, unchanged).

When a pod/slice drops out, training resumes on a smaller mesh: the `data`
axis shrinks (model parallelism is kept intact so the sharded weights still
fit), per-device batch is rebalanced, and the checkpoint is restored with
the new shardings (`CheckpointManager.restore(shardings=...)` places
every leaf on the new mesh, as the reference's does; `launch/train.py`'s
`plan_shardings` gives them for a train plan).  The paper's
cluster-granular restart (§6) maps to exactly this: lose a cluster, keep
the rest serving/training.
"""
from __future__ import annotations

from typing import Optional, Tuple


def elastic_mesh_shape(n_devices: int, model_parallel: int,
                       pod_size: Optional[int] = None
                       ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) mesh that fits n_devices.

    Keeps `model` fixed (weights must stay shardable), shrinks `data`, and
    drops the pod axis if fewer than 2 full pods remain.
    """
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model={model_parallel}")
    groups = n_devices // model_parallel
    if pod_size and n_devices >= 2 * pod_size and n_devices % pod_size == 0:
        pods = n_devices // pod_size
        data = pod_size // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (groups, model_parallel), ("data", "model")


def rebalanced_batch(global_batch: int, data_parallel: int) -> int:
    """Per-replica batch after elastic shrink (keeps global batch by
    increasing per-device share when divisible, else grad-accumulates)."""
    if global_batch % data_parallel == 0:
        return global_batch // data_parallel
    # fall back: next divisible global batch below the target
    return max(global_batch // data_parallel, 1)


def accumulation_steps(global_batch: int, data_parallel: int,
                       max_per_device: int) -> int:
    per = -(-global_batch // data_parallel)
    return max(1, -(-per // max_per_device))
