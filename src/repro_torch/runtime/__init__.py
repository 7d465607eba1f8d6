"""Runtime substrate: straggler detection (serving and training),
failure injection with checkpoint/restart recovery, elastic re-meshing.
Plain host code."""
from repro_torch.runtime.elastic import (  # noqa: F401
    accumulation_steps, elastic_mesh_shape, rebalanced_batch,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    FailureInjector, RecoveryReport, SimulatedFailure, run_with_recovery,
)
from repro_torch.runtime.stragglers import (  # noqa: F401
    AdmissionDeadline, StragglerMonitor,
)
