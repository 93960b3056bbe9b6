"""Parallelism over a device mesh (counterpart of
`deeplearning4j_tpu/parallel/`): meshes, data-parallel training
(`ParallelTrainer` with dense, threshold, dense_rs and threshold_rs
exchanges and parameter averaging; the two `TrainingMaster`s and their
`TrainingMasterStats`), batched serving (`ParallelInference`), and
sequence parallelism (the ambient `sequence_sharding` context, ring
attention on the carry-mode CUDA kernel, Ulysses all-to-all
attention), tensor / FSDP / expert sharding (`ShardedParallelTrainer`
and the spec functions), GPipe pipeline parallelism
(`PipelineParallelTrainer`), several processes over
`torch.distributed` (`initialize_multihost`: meshes span the processes'
devices and the trainers' collectives cross them), and elastic
membership (`ElasticCoordinator`, `ElasticClient`, `ElasticTrainer`,
`elastic_fit`: a world that shrinks and grows between generations)."""

from deeplearning4j_tpu_torch.parallel.context import (
    current_sequence_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_main_process,
    multihost_active,
    process_count,
    process_index,
    shutdown_multihost,
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
         "TrainingMasterStats": "stats", "ParallelTrainer": "trainer",
         "ShardedParallelTrainer": "tensor", "fsdp_param_specs": "tensor",
         "moe_param_specs": "tensor", "tp_param_specs": "tensor",
         "pipeline_apply": "pipeline", "pipeline_forward": "pipeline",
         "PipelineParallelTrainer": "pipeline_container",
         "find_homogeneous_run": "pipeline_container",
         "ElasticConfig": "elastic", "ElasticCoordinator": "elastic",
         "ElasticClient": "elastic", "ElasticTrainer": "elastic",
         "elastic_fit": "elastic"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ElasticClient", "ElasticConfig", "ElasticCoordinator",
           "ElasticTrainer", "MeshSpec", "ParallelInference",
           "ParallelTrainer",
           "ParameterAveragingTrainingMaster", "PipelineParallelTrainer",
           "ShardedParallelTrainer", "SharedTrainingMaster",
           "ThresholdConfig", "TrainingMaster", "TrainingMasterStats",
           "current_sequence_mesh", "device_mesh", "elastic_fit",
           "find_homogeneous_run",
           "fsdp_param_specs", "initialize_multihost", "is_main_process",
           "make_mesh", "moe_param_specs", "multihost_active",
           "pipeline_apply", "pipeline_forward", "process_count",
           "process_index", "reference_attention", "ring_attention",
           "sequence_parallel_attention", "sequence_sharding",
           "shutdown_multihost", "tp_param_specs",
           "ulysses_parallel_attention"]
