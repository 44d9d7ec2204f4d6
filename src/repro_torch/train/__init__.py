"""Training entry points: the LM trainer, checkpoints and fault tolerance
(counterpart of ``repro.train``, with its exports)."""
from repro_torch.train.checkpoint import CheckpointManager, list_steps
from repro_torch.train.fault_tolerance import (
    ElasticSSGD, PreemptionGuard, RestartPlan, StragglerConfig,
    StragglerDetector, StaticHealthSource, make_restart_plan,
    plan_elastic_mesh, snap_pods,
)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "list_steps", "ElasticSSGD",
           "snap_pods", "PreemptionGuard",
           "RestartPlan", "StragglerConfig", "StragglerDetector",
           "StaticHealthSource", "make_restart_plan", "plan_elastic_mesh",
           "Trainer", "TrainerConfig"]
