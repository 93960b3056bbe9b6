"""Model persistence: the JAX package's `ModelSerializer` zip, read and
written without JAX (counterpart of `deeplearning4j_tpu/util/
serializer.py:91-199`). The zip holds

- configuration.json  (the `MultiLayerConfiguration` or
                       `ComputationGraphConfiguration`,
                       `to_json(indent=2)`)
- params.npz          ("<key>::<param>" keys, JAX names and layouts; the
                       key is the layer index or the graph node name)
- state.npz           (the running state, "<key>::mean"/"<key>::var"
                       of each BatchNormalization; empty without one)
- updater.npz         ("<key>::<param>__<slot>", e.g. "2::ff_W1__m")
- meta.json           (format_version, model_type "MultiLayerNetwork" or
                       "ComputationGraph", iteration_count, epoch_count,
                       and a crc32 per array: "<section>::<key>" ->
                       `fault/state.checksum_array`)

so a zip either package writes restores in the other, for both
containers. Arrays are written as `np.savez` stores them: fp32, C
order, in the JAX layout (a convolution's W as HWIO), from the fp32
master copy under a mixed policy.

A fitted normalizer (`datasets/normalizers`) travels inside the zip as
the JAX package writes it (`add_normalizer_to_model` /
`restore_normalizer_from_file` :195-220): `normalizer-meta.json` (its
`state()` meta) and `normalizer.npz` (its arrays), appended to a written
model zip.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
import zlib
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.fault.state import checksum_array as _crc
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.container import Container
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FORMAT_VERSION = 1


def _verify(meta: dict, section: str, flat: dict, path):
    """Per-array crc check against meta.json (zips written before the
    checksums existed skip, as in JAX)."""
    expected = meta.get("array_checksums")
    if not expected:
        return
    bad = [k for k, arr in flat.items()
           if f"{section}::{k}" in expected
           and _crc(arr) != expected[f"{section}::{k}"]]
    if bad:
        raise CheckpointCorruptError(
            f"{path}: {section} arrays failed checksum verification: "
            f"{bad[:5]}{'...' if len(bad) > 5 else ''} — the file is "
            f"corrupt; restore from a backup or an earlier checkpoint")


def _save_npz(zf: zipfile.ZipFile, name: str, arrays: dict):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    zf.writestr(name, buf.getvalue())


def _load_npz(zf: zipfile.ZipFile, name: str) -> dict:
    if name not in zf.namelist():
        return {}
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files}


def _host(t: torch.Tensor, what: str) -> np.ndarray:
    """The array as the zip stores it: the fp32 master, on the host."""
    if t.dtype != torch.float32:
        raise TypeError(f"{what} is {t.dtype}; the zip holds the fp32 "
                        f"master copy")
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _flatten_updater(upd_state: dict) -> Dict[str, np.ndarray]:
    return {f"{lk}::{pk}__{slot}": _host(t, f"updater {lk}::{pk}__{slot}")
            for lk, lv in upd_state.items()
            for pk, slots in lv.items()
            for slot, t in slots.items()}


def _unflatten_updater(flat: dict) -> dict:
    out: dict = {}
    for key, arr in flat.items():
        lp, slot = key.rsplit("__", 1)
        lk, pk = lp.split("::", 1)
        out.setdefault(lk, {}).setdefault(pk, {})[slot] = arr
    return out


def _flat(tree: dict, section: str) -> Dict[str, np.ndarray]:
    return {f"{lk}::{pk}": _host(t, f"{section} {lk}::{pk}")
            for lk, lv in tree.items() for pk, t in lv.items()}


def _check_array(arr: np.ndarray, t: torch.Tensor, what: str):
    if arr.dtype != np.float32 or tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"{what}: {arr.dtype} {arr.shape} where the "
                         f"configuration has float32 {tuple(t.shape)}")


class ModelSerializer:
    @staticmethod
    def write_model(model: Container, path: Union[str, Path],
                    save_updater: bool = True):
        """Atomic durable write: the zip is assembled at a same-directory
        tmp path, flushed and fsync'd, then renamed over the target, so a
        crash mid-save never leaves a torn file where a valid one was;
        the tmp file goes whatever happens."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        params_flat = _flat({key: layer.jax_param_map()
                             for key, layer in model.keyed()}, "param")
        state_flat = _flat(model.net_state, "state")
        upd_flat = (_flatten_updater(model.updater_state) if save_updater
                    else {})
        checksums = {}
        for section, flat in (("params", params_flat), ("state", state_flat),
                              ("updater", upd_flat)):
            for k, arr in flat.items():
                checksums[f"{section}::{k}"] = _crc(arr)
        tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                    zf.writestr("configuration.json",
                                model.conf.to_json(indent=2))
                    _save_npz(zf, "params.npz", params_flat)
                    _save_npz(zf, "state.npz", state_flat)
                    if save_updater:
                        _save_npz(zf, "updater.npz", upd_flat)
                    zf.writestr("meta.json", json.dumps({
                        "format_version": FORMAT_VERSION,
                        "model_type": type(model).__name__,
                        "iteration_count": model.iteration_count,
                        "epoch_count": model.epoch_count,
                        "array_checksums": checksums,
                    }))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()

    @staticmethod
    def restore_model(path: Union[str, Path], load_updater: bool = True, *,
                      device="cuda") -> Container:
        """The MultiLayerNetwork or ComputationGraph of a model zip on
        `device`. Raises `CheckpointCorruptError` where the JAX
        package's does (an unreadable or truncated zip, a corrupt
        deflate stream, a bad configuration, a crc mismatch), and
        KeyError or ValueError when the arrays do not cover the
        configuration's params, running state (or a stateful updater's
        slots) exactly, in shape and in fp32. The net is built and
        filled on the host after every check, then moved to the device
        once. The updater state is left fresh when the zip has none: a
        stateless rule (Sgd, NoOp) writes no arrays, and neither does
        `save_updater=False`."""
        try:
            zf_ctx = zipfile.ZipFile(path, "r")
        except (zipfile.BadZipFile, OSError) as e:
            raise CheckpointCorruptError(
                f"{path}: not a readable model zip ({e})") from e
        with zf_ctx as zf:
            try:
                conf_json = json.loads(zf.read("configuration.json"))
                meta = (json.loads(zf.read("meta.json"))
                        if "meta.json" in zf.namelist() else {})
                graph = (meta.get("model_type") == "ComputationGraph"
                         or conf_json.get("format", "").endswith(
                             "ComputationGraphConfiguration"))
                conf = (ComputationGraphConfiguration if graph
                        else MultiLayerConfiguration).from_dict(conf_json)
                params_flat = _load_npz(zf, "params.npz")
                state_flat = _load_npz(zf, "state.npz")
                upd_flat = (_load_npz(zf, "updater.npz") if load_updater
                            else {})
            except (zipfile.BadZipFile, ValueError, KeyError,
                    EOFError, OSError, zlib.error) as e:
                # zlib.error: a flipped bit inside a deflated member
                # fails the decompressor before the crc check runs
                raise CheckpointCorruptError(
                    f"{path}: model zip is corrupt or truncated "
                    f"({e})") from e
        _verify(meta, "params", params_flat, path)
        _verify(meta, "state", state_flat, path)
        _verify(meta, "updater", upd_flat, path)
        dev = resolve_device(device)
        model = (ComputationGraph if graph else MultiLayerNetwork)(
            conf, device="cpu")
        pairs = _exact_pairs({key: layer.jax_param_map()
                              for key, layer in model.keyed()},
                             params_flat, "params", path)
        pairs += _exact_pairs(model.net_state, state_flat, "state", path)
        if upd_flat:
            pairs += _updater_pairs(model, _unflatten_updater(upd_flat),
                                    path)
        for what, t, arr in pairs:
            _check_array(arr, t, what)
        with torch.no_grad():
            for _, t, arr in pairs:
                t.copy_(torch.from_numpy(arr))
        model.params_changed()
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        return model.to(dev)


    # ------------------------------------------------------ normalizers
    @staticmethod
    def add_normalizer_to_model(path: Union[str, Path], normalizer):
        """Append `normalizer`'s statistics to the model zip at `path`
        (refused when it holds one already: write the model again to
        replace it)."""
        meta, arrays = normalizer.state()
        with zipfile.ZipFile(path, "a", zipfile.ZIP_DEFLATED) as zf:
            if "normalizer-meta.json" in zf.namelist():
                raise ValueError(
                    f"{path} already contains a normalizer; write the "
                    f"model again to replace it")
            zf.writestr("normalizer-meta.json", json.dumps(meta))
            _save_npz(zf, "normalizer.npz",
                      {k: np.asarray(v) for k, v in arrays.items()})

    @staticmethod
    def restore_normalizer_from_file(path: Union[str, Path]):
        """The normalizer stored in the model zip at `path`, or None."""
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            normalizer_from_meta)
        with zipfile.ZipFile(path, "r") as zf:
            if "normalizer-meta.json" not in zf.namelist():
                return None
            meta = json.loads(zf.read("normalizer-meta.json"))
            arrays = _load_npz(zf, "normalizer.npz")
        return normalizer_from_meta(meta, arrays)


def _exact_pairs(tree: dict, flat: dict, section: str, path):
    """(key, tensor, array) for every tensor of `tree` ({key: {name:
    tensor}}: the configuration's params or running state); the zip's
    keys must be exactly those."""
    want = {f"{lk}::{pk}": t for lk, lv in tree.items()
            for pk, t in lv.items()}
    if set(want) != set(flat):
        raise KeyError(
            f"{path}: {section} {sorted(set(flat) - set(want))} unexpected, "
            f"{sorted(set(want) - set(flat))} missing")
    return [(k, t, flat[k]) for k, t in want.items()]


def _updater_pairs(model: Container, src: dict, path):
    """(key, state tensor, array) for every slot of every stateful param:
    the zip must carry exactly the rule's slots; stateless params (no
    slots) keep their empty state."""
    extra = set(src) - set(model.updater_state)
    if extra:
        raise KeyError(f"{path}: updater state for layers without params "
                       f"{sorted(extra)}")
    pairs = []
    for lk, lstate in model.updater_state.items():
        unknown = set(src.get(lk, {})) - set(lstate)
        if unknown:
            raise KeyError(f"{path}: layer {lk}: updater state for unknown "
                           f"params {sorted(unknown)}")
        for pk, st in lstate.items():
            have = src.get(lk, {}).get(pk, {})
            if set(have) != set(st):
                raise KeyError(f"{path}: layer {lk} {pk}: updater slots "
                               f"{sorted(have)} != the rule's {sorted(st)}")
            pairs += [(f"{lk}::{pk}__{slot}", t, have[slot])
                      for slot, t in st.items()]
    return pairs
