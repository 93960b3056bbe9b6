"""ModelGuesser: sniff a file and load the right model or configuration
(counterpart of `deeplearning4j_tpu/util/guesser.py`).

The reference's three facades (`ModelGuesser.java`): `load_config_guess`
(MultiLayerConfiguration JSON, Keras config, ComputationGraph JSON, then
the YAML variants), `load_model_guess` (a checkpoint zip as either
container, then a Keras .h5 model) and `load_normalizer`. Content is
sniffed first (zip and HDF5 magic bytes, the JSON `format` tag), as in
the JAX package. A bare config JSON/YAML also loads as a model: an
initialized network with weights drawn from the configuration's seed.
Every model comes back on `device` (default ``"cuda"``).
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.modelimport.hdf5 import HDF5_MAGIC


def _read_text(path) -> str:
    with open(path, "r", errors="replace") as f:
        return f.read()


def _parse_config_text(text: str):
    """Config text -> configuration (the reference's loadConfigGuess
    chain: MLN JSON, Keras config, CG JSON, then the YAML variants)."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration)

    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        d = None
        try:  # the YAML variants (pyyaml is optional)
            import yaml
            d = yaml.safe_load(text)
        except ImportError:
            pass
        except Exception:  # noqa: BLE001 — not YAML either: refused below
            d = None
    if not isinstance(d, dict):
        raise ValueError("not a JSON/YAML mapping")

    if d.get("class_name") in ("Sequential", "Model", "Functional"):
        # a Keras architecture (model.to_json()): config only
        from deeplearning4j_tpu_torch.modelimport.keras import (
            KerasModelImport)
        return KerasModelImport.config_from_dict(d)

    fmt = str(d.get("format", ""))
    errors = []
    if "ComputationGraph" in fmt:
        order = (ComputationGraphConfiguration, MultiLayerConfiguration)
    else:
        order = (MultiLayerConfiguration, ComputationGraphConfiguration)
    for cls in order:
        try:
            return cls.from_dict(d)
        except Exception as e:  # noqa: BLE001 — try the next format
            errors.append(f"{cls.__name__}: {type(e).__name__}: {e}")
    raise ValueError("config JSON matched no known format: "
                     + "; ".join(errors))


class ModelGuesser:
    @staticmethod
    def load_config_guess(path):
        """File -> configuration (MultiLayerConfiguration,
        ComputationGraphConfiguration, or one mapped from Keras)."""
        path = Path(path)
        if zipfile.is_zipfile(path):
            # a checkpoint also carries its configuration
            with zipfile.ZipFile(path) as zf:
                if "configuration.json" in zf.namelist():
                    return _parse_config_text(
                        zf.read("configuration.json").decode())
            raise ValueError(f"{path}: zip without configuration.json")
        with open(path, "rb") as f:
            if f.read(8) == HDF5_MAGIC:
                from deeplearning4j_tpu_torch.modelimport.keras import (
                    KerasModelImport)
                return KerasModelImport.import_keras_configuration(path)
        return _parse_config_text(_read_text(path))

    @staticmethod
    def load_model_guess(path, load_updater: bool = True, *, device="cuda"):
        """File -> model on `device`: a checkpoint zip (either container,
        with then without its updater state), a Keras HDF5 model with
        weights, or a bare config JSON/YAML as an initialized network."""
        device = resolve_device(device)
        path = Path(path)
        if zipfile.is_zipfile(path):
            from deeplearning4j_tpu_torch.util.serializer import (
                ModelSerializer)
            try:
                return ModelSerializer.restore_model(
                    path, load_updater=load_updater, device=device)
            except Exception as first:
                # the reference's retry: a checkpoint whose updater state
                # does not restore still yields a model; if the retry
                # fails too, the ORIGINAL error is the one raised
                if load_updater:
                    try:
                        return ModelSerializer.restore_model(
                            path, load_updater=False, device=device)
                    except Exception:
                        raise first
                raise
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == HDF5_MAGIC:
            from deeplearning4j_tpu_torch.modelimport import KerasModelImport
            return KerasModelImport.import_keras_model_and_weights(
                path, device=device)
        conf = _parse_config_text(_read_text(path))
        return ModelGuesser._init_from_config(conf, device)

    @staticmethod
    def _init_from_config(conf, device="cuda"):
        from deeplearning4j_tpu_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraph, ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        if isinstance(conf, ComputationGraphConfiguration):
            return ComputationGraph(conf, device=device).init()
        if isinstance(conf, MultiLayerConfiguration):
            return MultiLayerNetwork(conf, device=device).init()
        raise ValueError(
            f"Config of type {type(conf).__name__} has no runtime "
            "container to initialize")

    @staticmethod
    def load_normalizer(path):
        """The normalizer packaged inside a model zip, or None."""
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        return ModelSerializer.restore_normalizer_from_file(path)
