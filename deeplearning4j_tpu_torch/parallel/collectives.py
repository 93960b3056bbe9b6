"""The data axis's collectives (the `psum`/`pmean`/`psum_scatter`/
`all_gather` the JAX trainers emit inside `shard_map`,
`deeplearning4j_tpu/parallel/gradient_sharing.py`), within a process
and across processes.

Each takes one tensor per replica, replica order, each on its
replica's device, and returns the result on the device it is asked
for. A reduction sums in replica order (replica 0 first, then 1, ...),
so the result does not depend on which replica asks and two modes that
reduce the same tensors get the same bits. On a mesh that repeats one
device (`make_mesh(..., devices=["cuda:0"] * 4)`, the tests' `["cpu"] *
4`) every copy is a no-op and the replicas' work runs one after the
other; on distinct devices each `.to` is a peer copy (written, not yet
run on more than one card).

Across processes (`parallel/multihost.py`) a collective first reduces
this process's replicas as above, then `CrossProcess` sums (or gathers)
across the processes that own the rest of the axis, on a
`torch.distributed` group per mesh-axis line; a mean divides the
cross-process sum by the global replica count.
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


def shard_slice(n: int, r: int, length: int) -> slice:
    """Replica r's block of a last axis of `length` split n ways."""
    s = length // n
    return slice(r * s, (r + 1) * s)


def all_gather(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """`all_gather(..., axis=-1, tiled=True)`: the blocks concatenated
    along the last axis on `device`."""
    return torch.cat([s.to(device) for s in shards], dim=-1)


# ------------------------------------------------- across processes
# {rank tuple: process group}, cleared when the world goes down
_GROUPS: dict = {}
# pinned host staging buffers for gloo on CUDA tensors: {(dtype, n): t}
_STAGING: dict = {}


def _register_caches():
    from deeplearning4j_tpu_torch.parallel import multihost
    for cache in (_GROUPS, _STAGING):
        if not any(c is cache for c in multihost._TOPOLOGY_CACHES):
            multihost._TOPOLOGY_CACHES.append(cache)


def _group(ranks):
    """The process group over `ranks` (the world's own when they are all
    of it). Every process must call this for the same rank sets in the
    same order (`torch.distributed.new_group` is collective)."""
    import torch.distributed as dist
    ranks = tuple(sorted(set(int(r) for r in ranks)))
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _register_caches()
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class CrossProcess:
    """The step of a collective that crosses processes, over a group of
    ranks: after each collective has reduced this process's replicas in
    replica order, it sums (or gathers) across the group's processes.
    Under gloo with CUDA tensors each call stages through one pinned
    host buffer each way; under NCCL and on CPU tensors it goes direct.
    `stats` counts the calls, the payload bytes that crossed and the
    host seconds they took."""

    def __init__(self, ranks):
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.parallel import multihost
        self.ranks = tuple(sorted(set(int(r) for r in ranks)))
        self.size = len(self.ranks)
        self.rank = dist.get_rank()
        self.index = self.ranks.index(self.rank)
        self.backend = multihost.backend()
        self.group = _group(self.ranks)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def _staged(self, flat: torch.Tensor) -> bool:
        return flat.device.type == "cuda" and self.backend == "gloo"

    def _host(self, flat: torch.Tensor, slot: int = 0) -> torch.Tensor:
        key = (flat.dtype, flat.numel(), slot)
        buf = _STAGING.get(key)
        if buf is None:
            _register_caches()
            buf = torch.empty(flat.numel(), dtype=flat.dtype,
                              pin_memory=True)
            _STAGING[key] = buf
        return buf

    def all_reduce_(self, tensors: Sequence[torch.Tensor]):
        """Sum every tensor across the group's processes, in place: one
        flat buffer a dtype, one `all_reduce` each."""
        import time

        import torch.distributed as dist
        t0 = time.perf_counter()
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dt, ts in by_dtype.items():
            flat = torch.cat([t.reshape(-1) for t in ts])
            if self._staged(flat):
                host = self._host(flat)
                host.copy_(flat)
                dist.all_reduce(host, group=self.group)
                flat.copy_(host, non_blocking=False)
            else:
                dist.all_reduce(flat, group=self.group)
            off = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view(t.shape))
                off += n
            self.stats["bytes"] += flat.numel() * flat.element_size()
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return tensors

    def all_gather(self, flat: torch.Tensor):
        """[the group's processes' `flat`], group order (equal sizes)."""
        import time

        import torch.distributed as dist
        t0 = time.perf_counter()
        flat = flat.reshape(-1).contiguous()
        if self._staged(flat):
            src = self._host(flat).copy_(flat)
            outs = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(outs, src, group=self.group)
            outs = [o.to(flat.device) for o in outs]
        else:
            outs = [torch.empty_like(flat) for _ in range(self.size)]
            dist.all_gather(outs, flat, group=self.group)
        self.stats["bytes"] += flat.numel() * flat.element_size()
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return outs

    def all_gather_object(self, obj):
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def cross_process(ranks) -> "CrossProcess | None":
    """The cross-process step over `ranks` (an axis line's owners), or
    None when they are one process (or no world is up)."""
    from deeplearning4j_tpu_torch.parallel import multihost
    if not multihost.multihost_active():
        return None
    ranks = [r for r in ranks if r is not None]
    if len(set(ranks)) < 2:
        return None
    return CrossProcess(ranks)


def axis_lines(mesh, axis: str):
    """The owning ranks of every line of `mesh` along `axis` (one line
    per index of the other axes, row-major), each a sorted tuple; a
    trainer creates the groups of all of them, in this order, on every
    process."""
    import numpy as np
    if mesh.ranks is None:
        return []
    grid = np.moveaxis(mesh.ranks, mesh.axis_names.index(axis), -1)
    return [tuple(sorted(set(int(r) for r in line)))
            for line in grid.reshape(-1, grid.shape[-1])]


def make_axis_groups(mesh, axis: str):
    """Create the process groups of every line along `axis` (collective:
    every process calls it for the same mesh), and return the cross-
    process step of the line holding this process's first entry."""
    from deeplearning4j_tpu_torch.parallel import multihost
    if mesh.ranks is None or not multihost.multihost_active():
        return None
    for line in axis_lines(mesh, axis):
        if len(line) > 1:
            _group(line)
    me = multihost.process_index()
    for line in axis_lines(mesh, axis):
        if me in line:
            return cross_process(line)
    return None
