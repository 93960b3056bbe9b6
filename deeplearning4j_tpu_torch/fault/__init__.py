"""The preemption-tolerant training runtime (counterpart of
`deeplearning4j_tpu/fault/`): `AsyncCheckpointer`
(atomic, checksummed, asynchronous full-state checkpoints with
retention, committed behind a barrier of per-process manifests when
several processes train), `capture_training_state` / `restore_training_state` (the
state schema), `CheckpointListener` (the fit loop's wiring), `resume`
(the exact restart with fallback past corrupt checkpoints, a
ParallelTrainer's residual, τ and per-replica stacks included, re-sharded
by `reshard_replica_stack` when the replica count changed) and the
drills (`PreemptionListener`, `corrupt_checkpoint`, `auto_resume`).
The on-disk layout and `meta` are the JAX package's, so each package
resumes what the other wrote."""

from deeplearning4j_tpu_torch.fault.checkpointer import (
    AsyncCheckpointer,
    list_checkpoints,
    load_checkpoint,
)
from deeplearning4j_tpu_torch.fault.drill import (
    PreemptionListener,
    auto_resume,
    checkpoint_meta,
    corrupt_checkpoint,
)
from deeplearning4j_tpu_torch.fault.errors import (
    CheckpointCorruptError,
    ElasticMembershipError,
    ElasticReconfiguration,
    SimulatedPreemption,
)
from deeplearning4j_tpu_torch.fault.listener import CheckpointListener
from deeplearning4j_tpu_torch.fault.resume import load_latest_valid, resume
from deeplearning4j_tpu_torch.fault.state import (
    capture_training_state,
    reshard_replica_stack,
    restore_normalizer,
    restore_training_state,
    stacked_replica_count,
)

__all__ = [
    "AsyncCheckpointer", "CheckpointListener", "CheckpointCorruptError",
    "ElasticMembershipError", "ElasticReconfiguration",
    "SimulatedPreemption", "PreemptionListener", "capture_training_state",
    "restore_training_state", "restore_normalizer", "resume",
    "load_latest_valid", "list_checkpoints", "load_checkpoint",
    "auto_resume", "checkpoint_meta", "corrupt_checkpoint",
    "reshard_replica_stack", "stacked_replica_count",
]
