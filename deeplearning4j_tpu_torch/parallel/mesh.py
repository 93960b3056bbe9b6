"""Device meshes (counterpart of `deeplearning4j_tpu/parallel/mesh.py`:
`MeshSpec` :29, `make_mesh` :61 and `device_mesh` :75).

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

After `parallel.multihost.initialize_multihost`, `make_mesh(spec)`
spans every process's devices, process-major as `jax.devices()` is:
`mesh.ranks` holds the rank that owns each entry (None in one process,
where every entry is local), and a process drives only its own entries
(`mesh.is_local`).

`device_mesh(n)` is the one-axis data-parallel mesh the parallel
trainers default to: every CUDA device (or the first `n`), raising
without CUDA as every entry point does, and under a multi-process world
every process's devices, as JAX's spans `jax.devices()`; tests pass CPU
devices to `make_mesh` explicitly.

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
    def data_parallel(n: Optional[int] = None) -> "MeshSpec":
        """One "data" axis over `n` devices (default: every device, as
        `len(jax.devices())`: every process's under a multi-process
        world, else every CUDA device)."""
        if not n:
            from deeplearning4j_tpu_torch.parallel import multihost
            n = (len(multihost.global_devices())
                 if multihost.multihost_active()
                 else torch.cuda.device_count())
        return MeshSpec((("data", int(n)),))

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

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        # the owning rank of each entry (multi-process meshes only)
        self.ranks = ranks

    def is_local(self, index) -> bool:
        """Whether this process drives the entry at grid `index`."""
        if self.ranks is None:
            return True
        from deeplearning4j_tpu_torch.parallel.multihost import (
            process_index)
        return int(self.ranks[index]) == process_index()

    def axis_devices(self, axis: str):
        """The devices along `axis`, the other axes at index 0: the ring
        (or all-to-all group) a sequence-parallel function runs over."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes "
                             f"{self.axis_names}")
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return tuple(grid.reshape(grid.shape[0], -1)[:, 0])

    def axis_ranks(self, axis: str):
        """The owning ranks of `axis_devices(axis)` (all None in one
        process)."""
        if self.ranks is None:
            return (None,) * int(self.shape[axis])
        grid = np.moveaxis(self.ranks, self.axis_names.index(axis), 0)
        return tuple(int(r) for r in grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(spec: MeshSpec | Dict[str, int] | None = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `spec`'s shape (default: one data axis over every CUDA
    device) over `devices` (default: every CUDA device, in order),
    row-major, the first `spec.size()` used. Under a multi-process world
    the default devices are every process's, process-major, each entry
    owned by its process."""
    from deeplearning4j_tpu_torch.parallel import multihost
    if isinstance(spec, dict):
        spec = MeshSpec(tuple(spec.items()))
    if devices is None and multihost.multihost_active():
        glob = multihost.global_devices()
        if spec is None:
            spec = MeshSpec((("data", len(glob)),))
        n = spec.size()
        if len(glob) < n:
            raise ValueError(f"Mesh {spec} needs {n} devices, have "
                             f"{len(glob)}")
        grid = np.empty(n, dtype=object)
        grid[:] = [d for _, d in glob[:n]]
        ranks = np.array([r for r, _ in glob[:n]], dtype=np.int64)
        return Mesh(grid.reshape(spec.shape()), spec.names(),
                    ranks.reshape(spec.shape()))
    if spec is None:
        spec = MeshSpec.data_parallel()
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


def device_mesh(n_data: Optional[int] = None) -> Mesh:
    """A one-axis data-parallel mesh over every device (or the first
    `n_data`): under a multi-process world every process's devices (the
    ones `initialize_multihost` was given, CPU ones included), else every
    CUDA device, raising without CUDA."""
    from deeplearning4j_tpu_torch.parallel import multihost
    if not multihost.multihost_active():
        from deeplearning4j_tpu_torch.device import resolve_device
        resolve_device("cuda")
    return make_mesh(MeshSpec.data_parallel(n_data))


def data_devices(mesh: Mesh, axis: str = "data"):
    """The devices of the data axis, replica order (the other axes at
    index 0)."""
    return list(mesh.axis_devices(axis))


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
