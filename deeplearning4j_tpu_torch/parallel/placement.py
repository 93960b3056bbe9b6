"""Placing trees on the replicas of a data axis and reading them back
(counterpart of `deeplearning4j_tpu/parallel/placement.py`: `gput`
:22, `gput_tree` :40, `host_view_tree` :49).

A port mesh names `torch.device`s, so a "sharding" here is a device (a
replicated copy) or a `DataSharding` (rows split over the data axis's
devices). Copies from host memory count their bytes with
`monitor.record_transfer(..., "h2d")`, reads back with "d2h", as JAX's
do; a tensor already on the target device is passed through (a mesh
that repeats one card copies nothing).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor


class DataSharding:
    """Rows split over the devices of `mesh`'s `axis` (the JAX
    `NamedSharding(mesh, P(axis))` of a batch): replica r takes the r-th
    of equal row blocks."""

    def __init__(self, mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.devices: List[torch.device] = list(mesh.axis_devices(axis))

    def __repr__(self):
        return f"DataSharding({self.mesh!r}, {self.axis!r})"


class ReplicaBatch:
    """One array split in row blocks, block r on replica r's device (what
    `DevicePrefetchIterator(sharding=)` lands). `shape` is the whole
    array's."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)
        rows = sum(int(s.shape[0]) for s in self.shards)
        self.shape = (rows,) + tuple(self.shards[0].shape[1:])

    def __len__(self):
        return self.shape[0]


def _host_bytes(a) -> int:
    return int(a.numel() * a.element_size()) if isinstance(
        a, torch.Tensor) else int(np.asarray(a).nbytes)


def gput(arr, device) -> torch.Tensor:
    """`arr` (array or tensor) on `device`; host bytes counted as h2d."""
    device = torch.device(device)
    if isinstance(arr, torch.Tensor):
        if arr.device == device:
            return arr
        if arr.device.type == "cpu":
            monitor.record_transfer(_host_bytes(arr), "h2d")
        return arr.to(device)
    a = np.asarray(arr)
    monitor.record_transfer(a.nbytes, "h2d")
    return torch.as_tensor(a).to(device)


def gput_tree(tree, device):
    """Every leaf of a nested dict (or list) tree on `device`."""
    if isinstance(tree, dict):
        return {k: gput_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gput_tree(v, device) for v in tree)
    return gput(tree, device)


def shard_rows(arr, sharding: DataSharding) -> ReplicaBatch:
    """`arr`'s rows in equal blocks, block r on replica r's device (the
    row count must divide by the replicas)."""
    n = len(sharding.devices)
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over the "
                         f"{n}-way data axis")
    b = t.shape[0] // n
    return ReplicaBatch([gput(t[r * b:(r + 1) * b], d)
                         for r, d in enumerate(sharding.devices)])


def host_view_tree(tree):
    """Every tensor leaf as a host numpy array (d2h bytes counted)."""
    if isinstance(tree, dict):
        return {k: host_view_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        h = tree.detach().to("cpu").numpy()
        monitor.record_transfer(h.nbytes, "d2h")
        return h
    return np.asarray(tree)
