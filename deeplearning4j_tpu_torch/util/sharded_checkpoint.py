"""Sharded checkpoints: each process writes the shards it owns
(counterpart of `deeplearning4j_tpu/util/sharded_checkpoint.py`, which
writes Orbax's format; the port has its own and does not read Orbax's).

Layout of a checkpoint directory:

- ``state/shard-<p>.npz``: process p's arrays, flat keys
  ``<tree>/<layer>/<param>[/<slot>]``, a block of a sharded array as
  ``...#<j>of<k>@<dim>`` (block j of k along dim);
- ``state/manifest-<p>.json``: the crc32 of every array in that file;
- ``meta/meta.json``: the configuration, the container type, the
  counters and the process count.

A save writes everything into ``<path>.tmp`` and renames it into place
once every process's files are durable (a barrier across processes), so
the meta and the arrays commit together: no side file can tear off, and
a crash leaves the previous checkpoint or none.

`save(path, model, trainer=None)` writes the model's params, running
state and updater state; with a `ShardedParallelTrainer` the sharded
params and updater slots are written as blocks, each process its own
shards (`trainer.param_specs`, the mesh's owners). `restore(path,
model=None, shardings=None)` assembles every array, checks each crc32
(damage raises `CheckpointCorruptError`) and loads the model (built
from the stored configuration when None). `restore_state(path,
shardings)` returns the state tree placed by `shardings` (the same
tree, a leaf None for the default placement, a device, or a
`ShardedTensor.Target(mesh, spec)` that lands the array as its shards
on their mesh devices).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _host(t) -> np.ndarray:
    return t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _unflatten(flat):
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class ShardedTensor:
    """An array as its shards on mesh devices: `shards[j]` is block j of
    `k` along `dim`, on `devices[j]`."""

    class Target:
        """A restore target: the mesh and the spec (one axis name or None
        per dimension) the array lands under."""

        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, tuple(spec)

    def __init__(self, shards, dim, devices, spec):
        self.shards, self.dim = list(shards), dim
        self.devices, self.spec = list(devices), tuple(spec)

    def full(self, device="cpu") -> torch.Tensor:
        return torch.cat([s.to(device) for s in self.shards], dim=self.dim)


def _world():
    from deeplearning4j_tpu_torch.parallel import multihost
    return multihost.process_index(), multihost.process_count()


def _barrier():
    from deeplearning4j_tpu_torch.parallel import multihost
    if multihost.process_count() > 1:
        torch.distributed.barrier()


def _fsync(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class ShardedCheckpoint:
    """save/restore a model's params, running state and updater state with
    their sharding, plus its configuration and counters."""

    @staticmethod
    def _arrays(model, trainer, proc: int) -> Dict[str, np.ndarray]:
        """This process's arrays: whole ones (process 0 only) and the
        blocks of its shards."""
        from deeplearning4j_tpu_torch.parallel.tensor import shard_dim
        params = {k: layer.jax_param_map() for k, layer in model.keyed()
                  if layer.jax_param_map()}
        placed = trainer is not None and getattr(trainer, "_shards", None)
        trees = {"params": params, "net_state": model.net_state,
                 "updater_state": (trainer._full_state() if placed
                                   else model.updater_state)}
        specs = getattr(trainer, "param_specs", None) or {}
        owned = trainer._mine if trainer is not None else None
        out = {}
        for what, tree in trees.items():
            for key, t in _flatten(tree).items():
                parts = key.split("/")
                sd = (shard_dim(specs.get(parts[0], {}).get(parts[1], ()))
                      if what != "net_state" and len(parts) >= 2 else None)
                name = f"{what}/{key}"
                if sd is None:
                    if proc == 0:
                        out[name] = _host(t)
                    continue
                dim, axis = sd
                k = int(trainer.mesh.shape[axis])
                for j in owned(axis):
                    out[f"{name}#{j}of{k}@{dim}"] = _host(
                        t.chunk(k, dim=dim)[j])
        return out

    @staticmethod
    def save(path: str, model, trainer=None) -> str:
        path = os.path.abspath(path)
        tmp = path + ".tmp"
        proc, nprocs = _world()
        if proc == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "state"))
            os.makedirs(os.path.join(tmp, "meta"))
        _barrier()
        arrays = ShardedCheckpoint._arrays(model, trainer, proc)
        spath = os.path.join(tmp, "state", f"shard-{proc:05d}.npz")
        with open(spath, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        mpath = os.path.join(tmp, "state", f"manifest-{proc:05d}.json")
        with open(mpath, "w") as f:
            json.dump({k: _crc(a) for k, a in arrays.items()}, f)
            f.flush()
            os.fsync(f.fileno())
        _barrier()
        if proc == 0:
            meta = {"configuration": model.conf.to_dict(),
                    "model_type": type(model).__name__,
                    "iteration_count": model.iteration_count,
                    "epoch_count": model.epoch_count,
                    "process_count": nprocs}
            with open(os.path.join(tmp, "meta", "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            for sub in ("state", "meta", ""):
                _fsync(os.path.join(tmp, sub))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            _fsync(os.path.dirname(path))
        _barrier()
        return path

    @staticmethod
    def _read(path: str):
        """(meta, {flat key: full host array}) with every crc32 checked."""
        path = os.path.abspath(path)
        try:
            with open(os.path.join(path, "meta", "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: sharded checkpoint unreadable or incomplete "
                f"({e})") from e
        blocks: Dict[str, Dict[int, tuple]] = {}
        whole = {}
        for p in range(int(meta.get("process_count", 1))):
            spath = os.path.join(path, "state", f"shard-{p:05d}.npz")
            mpath = os.path.join(path, "state", f"manifest-{p:05d}.json")
            try:
                with open(mpath) as f:
                    crcs = json.load(f)
                with np.load(spath) as z:
                    arrays = {k: z[k] for k in z.files}
            except (OSError, ValueError, KeyError, zlib.error) as e:
                raise CheckpointCorruptError(
                    f"{path}: sharded checkpoint unreadable or incomplete "
                    f"({e})") from e
            bad = [k for k, a in arrays.items() if crcs.get(k) != _crc(a)]
            if bad or set(crcs) != set(arrays):
                raise CheckpointCorruptError(
                    f"{path}: restored arrays failed checksum "
                    f"verification: {(bad or sorted(set(crcs) ^ set(arrays)))[:5]}")
            for k, a in arrays.items():
                if "#" in k:
                    name, rest = k.split("#")
                    j, rest = rest.split("of")
                    kk, dim = rest.split("@")
                    blocks.setdefault(name, {})[int(j)] = (int(kk),
                                                           int(dim), a)
                else:
                    whole[k] = a
        for name, bl in blocks.items():
            k, dim = next(iter(bl.values()))[:2]
            if sorted(bl) != list(range(k)):
                raise CheckpointCorruptError(
                    f"{path}: blocks of {name} missing: have {sorted(bl)} "
                    f"of {k}")
            whole[name] = np.concatenate([bl[j][2] for j in range(k)],
                                         axis=dim)
        return meta, whole

    @staticmethod
    def restore_state(path: str, shardings=None):
        """The saved state tree ({"params", "net_state",
        "updater_state"}), each leaf placed by `shardings` (None: host
        tensors)."""
        _, flat = ShardedCheckpoint._read(path)
        tree = _unflatten({k: torch.from_numpy(np.array(a))
                           for k, a in flat.items()})
        for what in ("params", "net_state", "updater_state"):
            tree.setdefault(what, {})
        if shardings is None:
            return tree

        def place(t, s):
            if isinstance(t, dict):
                return {k: place(v, (s or {}).get(k) if isinstance(
                    s, dict) else s) for k, v in t.items()}
            if s is None:
                return t
            if isinstance(s, ShardedTensor.Target):
                from deeplearning4j_tpu_torch.parallel.tensor import (
                    shard_dim)
                sd = shard_dim(s.spec)
                if sd is None:
                    return t
                dim, axis = sd
                devs = list(s.mesh.axis_devices(axis))
                return ShardedTensor(
                    [c.to(d) for c, d in zip(t.chunk(len(devs), dim=dim),
                                             devs)], dim, devs, s.spec)
            return t.to(s)
        return place(tree, shardings)

    @staticmethod
    def restore(path: str, model=None, shardings=None, *, device="cuda"):
        """Restore into `model` (or one built from the stored
        configuration on `device`). `shardings` places the arrays first
        (see `restore_state`); the model then takes the full tensors on
        its device."""
        meta, _ = ShardedCheckpoint._read(path)
        if model is None:
            model = ShardedCheckpoint._build_model(meta, device)
        state = ShardedCheckpoint.restore_state(path, shardings)

        def full(t):
            return t.full() if isinstance(t, ShardedTensor) else t
        with torch.no_grad():
            for lk, layer in model.keyed():
                for pn, p in layer.jax_param_map().items():
                    p.copy_(full(state["params"][lk][pn]).to(p.device,
                                                             p.dtype))
                for pn, b in layer.state_map().items():
                    b.copy_(full(state["net_state"][lk][pn]).to(b.device,
                                                                b.dtype))
            for lk, lst in model.updater_state.items():
                for pn, slots in lst.items():
                    for s, t in slots.items():
                        t.copy_(full(state["updater_state"][lk][pn][s]).to(
                            t.device, t.dtype))
        model.params_changed()
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        return model

    @staticmethod
    def _build_model(meta, device):
        if meta["model_type"] == "ComputationGraph":
            from deeplearning4j_tpu_torch.nn.graph import (
                ComputationGraph, ComputationGraphConfiguration)
            return ComputationGraph(ComputationGraphConfiguration.from_dict(
                meta["configuration"]), device=device)
        from deeplearning4j_tpu_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            meta["configuration"]), device=device)

