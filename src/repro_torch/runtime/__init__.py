"""The runtime: elastic fleet membership and recovery, the ifunc control
plane, and checkpoints (the reference's ``repro.runtime``)."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.controller import PodController, WorkerAgent
from repro_torch.runtime.elastic import (ElasticController, FleetState,
                                         StragglerMitigator)

__all__ = ["CheckpointManager", "ElasticController", "FleetState",
           "PodController", "StragglerMitigator", "WorkerAgent"]
