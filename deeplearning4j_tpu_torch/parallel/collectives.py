"""The data axis's collectives for one controller that drives every
replica (the `psum`/`pmean`/`psum_scatter`/`all_gather` the JAX
trainers emit inside `shard_map`, `deeplearning4j_tpu/parallel/
gradient_sharing.py`).

Each takes one tensor per replica, replica order, each on its
replica's device, and returns the result on the device it is asked
for. A reduction sums in replica order (replica 0 first, then 1, ...),
so the result does not depend on which replica asks and two modes that
reduce the same tensors get the same bits. On a mesh that repeats one
device (`make_mesh(..., devices=["cuda:0"] * 4)`, the tests' `["cpu"] *
4`) every copy is a no-op and the replicas' work runs one after the
other; on distinct devices each `.to` is a peer copy (written, not yet
run on more than one card).
"""

from __future__ import annotations

from typing import Sequence

import torch


def reduce_sum(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ_r tensors[r] on `device`, summed in replica order, in the
    tensors' dtype."""
    acc = tensors[0].to(device, copy=True)
    for t in tensors[1:]:
        acc.add_(t.to(device))
    return acc


def mean(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The replica mean (`pmean`): the replica-order sum divided by the
    replica count."""
    acc = reduce_sum(tensors, device)
    return acc.div_(torch.tensor(len(tensors), dtype=acc.dtype,
                                 device=acc.device))


def shard_slice(n: int, r: int, length: int) -> slice:
    """Replica r's block of a last axis of `length` split n ways."""
    s = length // n
    return slice(r * s, (r + 1) * s)


def all_gather(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """`all_gather(..., axis=-1, tiled=True)`: the blocks concatenated
    along the last axis on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=-1)
