"""Sequence parallelism over a device mesh (counterpart of the
sequence-parallel part of `deeplearning4j_tpu/parallel/`): meshes, the
ambient `sequence_sharding` context, ring attention (the flash ring runs
the carry-mode CUDA kernel) and Ulysses all-to-all attention."""

from deeplearning4j_tpu_torch.parallel.context import (
    current_sequence_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention,
    sequence_parallel_attention,
)
from deeplearning4j_tpu_torch.parallel.ulysses import (
    ulysses_parallel_attention,
)

__all__ = ["MeshSpec", "current_sequence_mesh", "make_mesh",
           "reference_attention", "ring_attention",
           "sequence_parallel_attention", "sequence_sharding",
           "ulysses_parallel_attention"]
