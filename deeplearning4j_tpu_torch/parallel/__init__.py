"""Parallelism over a device mesh (counterpart of
`deeplearning4j_tpu/parallel/`): meshes, data-parallel training
(`ParallelTrainer` with dense, threshold, dense_rs and threshold_rs
exchanges and parameter averaging; the two `TrainingMaster`s and their
`TrainingMasterStats`), batched serving (`ParallelInference`), and
sequence parallelism (the ambient `sequence_sharding` context, ring
attention on the carry-mode CUDA kernel, Ulysses all-to-all
attention). One process drives every replica; the multi-process
pieces (tensor, pipeline, multihost, elastic) are not ported yet."""

from deeplearning4j_tpu_torch.parallel.context import (
    current_sequence_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    MeshSpec,
    device_mesh,
    make_mesh,
)
from deeplearning4j_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention,
    sequence_parallel_attention,
)
from deeplearning4j_tpu_torch.parallel.ulysses import (
    ulysses_parallel_attention,
)

# the training and serving names load on first use: the layers import
# the sequence-parallel names from this package, and the trainers import
# the layers
_LAZY = {"ThresholdConfig": "gradient_sharing",
         "ParallelInference": "inference",
         "ParameterAveragingTrainingMaster": "master",
         "SharedTrainingMaster": "master", "TrainingMaster": "master",
         "TrainingMasterStats": "stats", "ParallelTrainer": "trainer"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["MeshSpec", "ParallelInference", "ParallelTrainer",
           "ParameterAveragingTrainingMaster", "SharedTrainingMaster",
           "ThresholdConfig", "TrainingMaster", "TrainingMasterStats",
           "current_sequence_mesh", "device_mesh", "make_mesh",
           "reference_attention", "ring_attention",
           "sequence_parallel_attention", "sequence_sharding",
           "ulysses_parallel_attention"]
