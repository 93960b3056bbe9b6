"""The complete training state and its capture and restore (counterpart
of `deeplearning4j_tpu/fault/state.py:76-300`).

A checkpoint holds what the next step depends on: the params, each
layer's updater state (`{key: {param: {slot: array}}}`, the layout of
the zip's `updater.npz`), the running state, the iteration and epoch
counters (the step key is `fold_in(PRNGKey(seed + 1), iteration)` and
Adam's bias correction reads the iteration, so the counters restore the
trajectory), the iterator's cursor and a normalizer's statistics. The
`meta` keys are JAX's (`format_version`, `model_type`,
`configuration`, `dtype_policy`, `diagnostics`, `iteration_count`,
`epoch_count`, `score`, `iterator`, `normalizer`), so a checkpoint
either package writes resumes in the other.

Trees flatten to npz keys joined with U+001F, and each array carries the
crc32 of its C-order bytes, as the model zip's do.

Inside a `ParallelTrainer.fit` the model publishes
`_live_state_provider` and the capture reads through it: the live
trees plus the trainer's per-replica stacks (`trainer_arrays`, under
``arrays["trainer"]``) and `trainer_meta` (``meta["trainer"]``), JAX's
layout. `restore_training_state(..., trainer=)` hands them back to the
trainer, which re-shards a stack written at another replica count
(`reshard_replica_stack`).

Capture copies every tensor to fresh host memory before it returns: the
port updates params and Adam's moments in place (fused Adam writes p, m
and v), so a snapshot that queued views of the live tensors for the
writer thread would mix two steps.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError

STATE_FORMAT_VERSION = 1

# the path separator inside flattened keys (ASCII unit separator: it
# cannot occur in layer indices or node names)
SEP = "\x1f"


def checksum_array(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def checksum_flat(flat: Dict[str, np.ndarray]) -> Dict[str, int]:
    return {k: checksum_array(v) for k, v in flat.items()}


def host_copy(t) -> np.ndarray:
    """A C-order host array that shares no memory with `t` (a tensor on
    any device, or an array)."""
    if isinstance(t, torch.Tensor):
        # np.array keeps a 0-d tensor 0-d (ascontiguousarray would not)
        return np.array(t.detach().to("cpu", copy=True).numpy(), order="C")
    return np.array(t, order="C", copy=True)


def flatten_arrays(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested str-keyed dicts of tensor or array leaves -> {path: host
    array}; the device-to-host copies happen here, at the step
    boundary."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            k = str(k)
            if SEP in k:
                raise ValueError(f"tree key {k!r} contains the reserved "
                                 f"path separator U+001F")
            out.update(flatten_arrays(v, f"{prefix}{k}{SEP}"))
        return out
    return {prefix[:-1]: host_copy(tree)}


def unflatten_arrays(flat: Dict[str, np.ndarray]) -> Dict:
    """Inverse of `flatten_arrays`."""
    out: Dict = {}
    for path, arr in flat.items():
        parts = path.split(SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def verify_checksums(flat: Dict[str, np.ndarray], expected: Dict[str, int],
                     *, context: str = ""):
    """Raise `CheckpointCorruptError` naming every array that is missing
    or fails its checksum."""
    bad = []
    for key, crc in expected.items():
        if key not in flat:
            bad.append(f"{key!r} missing")
        elif checksum_array(flat[key]) != crc:
            bad.append(f"{key!r} checksum mismatch")
    if bad:
        raise CheckpointCorruptError(
            f"{context or 'checkpoint'} failed integrity verification: "
            + "; ".join(bad[:8])
            + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else ""))


def _host_tree(tree) -> Dict:
    return unflatten_arrays(flatten_arrays(tree)) if tree else {}


def model_arrays(model) -> Dict[str, Dict]:
    """Host copies of the model's params ({key: {JAX name: array}}),
    running state and updater state, and of an attached LoRA adapter's
    factors ({key: {JAX name: {"B", "A"}}}, `tenancy/lora.py`) under
    "adapter"."""
    params = {key: layer.jax_param_map() for key, layer in model.keyed()
              if layer.jax_param_map()}
    out = {"params": _host_tree(params),
           "net_state": _host_tree(model.net_state),
           "updater_state": _host_tree(model.updater_state)}
    if model.adapted:
        out["adapter"] = _host_tree(model.adapter_factors())
    return out


# ------------------------------------------------------------------ capture
def capture_training_state(model, *, iterator=None, normalizer=None,
                           step: Optional[int] = None,
                           epoch: Optional[int] = None,
                           extra_meta: Optional[Dict] = None
                           ) -> Dict[str, Any]:
    """Snapshot the complete training state to host memory:
    ``{"arrays": {section: tree of arrays}, "meta": {...}}``. `step` and
    `epoch` override the model's counters (a listener fires before the
    fit loop moves them on); `iterator` adds its `cursor()`,
    `normalizer` its statistics."""
    provider = getattr(model, "_live_state_provider", None)
    if provider is not None:
        src = provider()
        arrays: Dict[str, Any] = {
            "params": _host_tree(src["params"]),
            "net_state": _host_tree(src.get("net_state")),
            "updater_state": _host_tree(src.get("updater_state"))}
    else:
        src = {}
        arrays = model_arrays(model)
    meta: Dict[str, Any] = {
        "format_version": STATE_FORMAT_VERSION,
        "model_type": type(model).__name__,
        "configuration": model.conf.to_dict(),
        # the ACTIVE policy (an argument or the environment may have
        # chosen it): the resumed net must run the same program
        "dtype_policy": model.dtype.to_dict(),
        # the ACTIVE diagnostics config (an argument or the environment
        # may have chosen it): under `skip` it bears on the trajectory
        "diagnostics": (None if model.diagnostics is None
                        else model.diagnostics.to_dict()),
        "iteration_count": int(model.iteration_count if step is None
                               else step),
        "epoch_count": int(model.epoch_count if epoch is None else epoch),
        "score": float(getattr(model, "score_value", float("nan"))),
    }
    if "adapter" in arrays:
        # the adapter's rank, alpha and frozen flag, so a resume into a
        # net built from the configuration can attach it again
        from deeplearning4j_tpu_torch.tenancy import lora
        meta["adapter"] = lora.adapter_config(model)
    if src.get("trainer_arrays"):
        arrays["trainer"] = _host_tree(src["trainer_arrays"])
    if src.get("trainer_meta"):
        meta["trainer"] = dict(src["trainer_meta"])
    if iterator is not None:
        cur = getattr(iterator, "cursor", lambda: None)()
        if cur is not None:
            meta["iterator"] = dict(cur)
    if normalizer is not None:
        nmeta, narrays = normalizer.state()
        meta["normalizer"] = nmeta
        arrays["normalizer"] = {k: np.asarray(v) for k, v in narrays.items()}
    if extra_meta:
        meta.update(extra_meta)
    return {"arrays": arrays, "meta": meta}


# ------------------------------------------------------------------ restore
def build_model(meta: Dict[str, Any], *, device="cuda"):
    """An uninitialized container from a checkpoint's meta, under the
    recorded dtype policy and diagnostics config (`DL4J_DTYPE_POLICY` and
    `DL4J_DIAGNOSTICS` still win, as in JAX)."""
    from deeplearning4j_tpu_torch.monitor.diagnostics import as_diagnostics
    from deeplearning4j_tpu_torch.nd.dtype import as_policy
    policy = as_policy(meta.get("dtype_policy"))
    diagnostics = as_diagnostics(meta.get("diagnostics"))
    if meta["model_type"] == "ComputationGraph":
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraph, ComputationGraphConfiguration)
        return ComputationGraph(
            ComputationGraphConfiguration.from_dict(meta["configuration"]),
            device=device, dtype_policy=policy, diagnostics=diagnostics)
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(meta["configuration"]),
        device=device, dtype_policy=policy, diagnostics=diagnostics)


def _pairs(tree: Dict, src: Dict, section: str):
    """(what, tensor, array) for every leaf of `src` (a checkpoint
    section), found in `tree` (the model's tensors, same nesting); a
    leaf the model lacks or of another shape raises. Leaves `src` omits
    keep their values (an empty slot dict cannot be stored in npz)."""
    out = []
    for k, v in src.items():
        if k not in tree:
            raise KeyError(f"checkpoint {section} {k!r} is not in the "
                           f"model")
        if isinstance(v, dict):
            out += _pairs(tree[k], v, f"{section}/{k}")
            continue
        t = tree[k]
        if tuple(np.shape(v)) != tuple(t.shape):
            raise ValueError(f"checkpoint {section}/{k}: shape "
                             f"{np.shape(v)} where the model has "
                             f"{tuple(t.shape)}")
        out.append((f"{section}/{k}", t, v))
    return out


def load_arrays(model, arrays: Dict[str, Any]):
    """Copy a checkpoint's params, running state, updater state and
    adapter factors into `model`'s tensors in place."""
    params = {key: layer.jax_param_map() for key, layer in model.keyed()}
    pairs = (_pairs(params, arrays.get("params") or {}, "params")
             + _pairs(model.net_state, arrays.get("net_state") or {},
                      "net_state")
             + _pairs(model.updater_state, arrays.get("updater_state") or {},
                      "updater_state")
             + _pairs(model.adapter_factors(), arrays.get("adapter") or {},
                      "adapter"))
    with torch.no_grad():
        for _, t, arr in pairs:
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(
                t.device, t.dtype))
    model.params_changed()


def restore_training_state(model, state: Dict[str, Any], *, trainer=None,
                           iterator=None):
    """Load a captured or loaded state into `model` (a `trainer`'s
    residual, τ and per-replica stacks into it, and move `iterator` to
    its cursor). Returns `model`. The counters come back, so the step
    keys and the updater's step continue where the run stopped, and
    `params_version` moves on, so caches keyed on it rebuild. A state
    that carries an adapter attaches it to a `model` without one."""
    arrays, meta = state["arrays"], state["meta"]
    if meta.get("adapter"):
        if not model.adapted:
            from deeplearning4j_tpu_torch.tenancy import lora
            lora.attach_adapter(model, arrays["adapter"], **meta["adapter"])
    load_arrays(model, arrays)
    model.iteration_count = int(meta.get("iteration_count", 0))
    model.epoch_count = int(meta.get("epoch_count", 0))
    if "score" in meta:
        model.score_value = float(meta["score"])
    if trainer is not None and hasattr(trainer, "_restore_fault_state"):
        trainer._restore_fault_state(arrays.get("trainer") or {},
                                     meta.get("trainer") or {})
    if iterator is not None and meta.get("iterator") is not None:
        try:
            iterator.seek(meta["iterator"])
        except NotImplementedError as e:
            raise ValueError(
                f"checkpoint carries an iterator cursor but "
                f"{type(iterator).__name__} does not implement the "
                f"cursor()/seek() position contract "
                f"(ArrayDataSetIterator does)") from e
    return model


def restore_normalizer(state: Dict[str, Any]):
    """The fitted normalizer stored in a checkpoint, or None."""
    meta = state["meta"].get("normalizer")
    if meta is None:
        return None
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        normalizer_from_meta)
    return normalizer_from_meta(meta, state["arrays"].get("normalizer", {}))


# ------------------------------------------------------- elastic resharding
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def reshard_replica_stack(tree, new_n: int, *, kind: str = "state"):
    """A per-replica stacked tree (leading replica axis) at another
    replica count (the JAX `reshard_replica_stack`). kind="residual":
    the error-feedback residual is un-sent mass, so its SUM over
    replicas is kept: each new replica gets sum/new_n (summed in
    float64). kind="state": every new replica starts from the replica
    mean of float leaves and replica 0's value of the others."""
    def one(a):
        a = np.asarray(a)
        if a.ndim == 0:
            return a
        old_n = a.shape[0]
        if old_n == new_n:
            return a
        if kind == "residual":
            total = a.sum(axis=0, dtype=np.float64)
            return np.broadcast_to(
                (total / new_n).astype(a.dtype), (new_n,) + a.shape[1:]
            ).copy()
        if np.issubdtype(a.dtype, np.floating):
            m = a.mean(axis=0)
        else:
            m = a[0]
        return np.broadcast_to(m, (new_n,) + a.shape[1:]).copy()

    return _tree_map(one, tree)


def stacked_replica_count(tree) -> Optional[int]:
    """The leading replica extent of a per-replica stacked tree (None for
    an empty one)."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t
    for leaf in leaves(tree):
        return int(np.shape(leaf)[0])
    return None

