"""Device meshes (counterpart of `deeplearning4j_tpu/parallel/mesh.py`:
`MeshSpec` :29 and `make_mesh` :61).

A port mesh is a named grid of `torch.device`s: `Mesh(devices,
axis_names)` with `devices` an object ndarray of the grid's shape, and
the JAX `Mesh`'s `shape` ({axis: size}) and `axis_names`. Arrays are not
sharded by the mesh itself: the sequence-parallel functions
(`parallel/ring.py`, `parallel/ulysses.py`) split their inputs along an
axis and place each shard on its device.

`make_mesh(spec)` takes every CUDA device and raises when there are
fewer than the spec needs, as the JAX function does. An explicit
`devices=` list may repeat a device: `make_mesh(MeshSpec.of(seq=4),
devices=["cuda:0"] * 4)` runs a 4-way ring on one card, each ring
position a shard on the same device and each "send" a no-op — the
counterpart of the 8 virtual CPU devices the JAX tests run their meshes
on. On distinct cards a send is a peer copy.

`shard`, `gather` and `on_device` put an array's shards on the devices
of a mesh axis and back; ring and Ulysses attention share them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Serializable mesh description: ordered {axis_name: size}."""

    axes: tuple  # of (name, size)

    @staticmethod
    def of(**axes: int) -> "MeshSpec":
        return MeshSpec(tuple(axes.items()))

    def names(self):
        return tuple(n for n, _ in self.axes)

    def shape(self):
        return tuple(s for _, s in self.axes)

    def size(self):
        return int(np.prod(self.shape())) if self.axes else 1

    def to_dict(self):
        return {"axes": list(map(list, self.axes))}

    @staticmethod
    def from_dict(d):
        return MeshSpec(tuple((n, int(s)) for n, s in d["axes"]))


class Mesh:
    """A named grid of devices (the JAX `Mesh` surface the port needs)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str):
        """The devices along `axis`, the other axes at index 0: the ring
        (or all-to-all group) a sequence-parallel function runs over."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}")
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return tuple(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(spec: MeshSpec | Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `spec`'s shape over `devices` (default: every CUDA
    device, in order), row-major, the first `spec.size()` used."""
    if isinstance(spec, dict):
        spec = MeshSpec(tuple(spec.items()))
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = spec.size()
    if len(devices) < n:
        raise ValueError(f"Mesh {spec} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(spec.shape()), spec.names())


# ------------------------------------------------ shards on mesh devices
def shard(x, devices, dim=1):
    """Split `x` into len(devices) equal chunks along `dim` (the sequence
    axis, which must divide: JAX's shard_map fails otherwise); chunk j
    on devices[j] (a view where it already lives there)."""
    if x.shape[dim] % len(devices):
        raise ValueError(f"sequence length {x.shape[dim]} must divide by "
                         f"the {len(devices)} devices of the ring")
    return [c.to(d, non_blocking=True)
            for c, d in zip(x.chunk(len(devices), dim=dim), devices)]


def gather(shards, device, dim=1):
    """The shards concatenated along `dim` on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=dim)


def on_device(dev: torch.device):
    """Make `dev` current while its shard's kernels launch (a launch
    goes to the current device)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())
