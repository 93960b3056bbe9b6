"""ZooModel template (counterpart of `deeplearning4j_tpu/zoo/base.py`):
a model's configuration (`conf()`), its net with weights drawn from the
seed (`init()`), and the packaged checkpoints (`init_pretrained`, JAX
:90-137).

The port downloads nothing. A packaged checkpoint is a file the JAX
package ships in `deeplearning4j_tpu/zoo/weights/`, read in place as a
data file (no module of that package is imported): `MANIFEST.json`
maps its name to its sha256 (and, for the char-LM, its charset), the
hash is checked before anything is read. The payload is routed by its
magic bytes, as JAX's `init_pretrained` routes it (:118-137): a Keras
`.h5` goes through the port's `modelimport` (a full model through
`import_keras_model_and_weights`; a weights-only file through the
model's `keras_architecture` JSON when it has one, else onto `init()`
by `load_weights_into`), anything else is a model zip restored through
`util/serializer.py`. `pretrained_path` and `pretrained_checksum` are
the seam a caller overrides to serve its own file; a type without a
packaged file is refused by name.
"""

from __future__ import annotations

import hashlib
import json
from enum import Enum
from pathlib import Path
from typing import Optional

# the JAX package's packaged weights, read as data
WEIGHTS_DIR = (Path(__file__).resolve().parents[2] / "deeplearning4j_tpu"
               / "zoo" / "weights")


class PretrainedType(str, Enum):
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    TEXT = "text"


def packaged_weight_entry(name: str) -> Optional[dict]:
    """The manifest's entry for a packaged file (None when the file or
    its entry is missing), as the JAX `packaged_weight_entry` reads it."""
    f, mf = WEIGHTS_DIR / name, WEIGHTS_DIR / "MANIFEST.json"
    if not (f.exists() and mf.exists()):
        return None
    manifest = json.loads(mf.read_text())
    if "file" in manifest:      # the single-entry layout
        manifest = {manifest["file"]: manifest}
    return manifest.get(name)


def packaged_weight(name: str):
    """(path, sha256) of an artifact in the JAX package's zoo/weights/,
    or (None, None) when it is absent. A file WITHOUT a manifest entry
    (or one without a sha256) is treated as not packaged, as the JAX
    `packaged_weight` treats it: a path with no checksum would let a
    reader skip the integrity check."""
    entry = packaged_weight_entry(name)
    if entry is None or not entry.get("sha256"):
        return None, None
    return WEIGHTS_DIR / name, entry["sha256"]


class ZooModel:
    # {PretrainedType: file name in the JAX package's zoo/weights/}
    packaged: dict = {}
    # {PretrainedType: architecture JSON in WEIGHTS_DIR} for weights-only
    # keras-applications payloads whose graph is not this model's own
    # builder's (keras ResNet-50's explicit ZeroPadding and biased
    # convs): the weights are copied by Keras layer name through it
    keras_architecture: dict = {}

    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = num_classes
        self.seed = seed
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, seed: Optional[int] = None, *, device="cuda",
             dtype_policy=None):
        """The model's net on `device` (a `ComputationGraph` for a graph
        configuration, else a `MultiLayerNetwork`) with JAX's weights for
        `seed` (the model's seed by default)."""
        from deeplearning4j_tpu_torch.nn.graph import (
            ComputationGraph, ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        conf = self.conf()
        cls = (ComputationGraph
               if isinstance(conf, ComputationGraphConfiguration)
               else MultiLayerNetwork)
        return cls(conf, device=device, dtype_policy=dtype_policy).init(
            self.seed if seed is None else seed)

    def pretrained_path(self, ptype: PretrainedType) -> Optional[Path]:
        name = self.packaged.get(PretrainedType(ptype))
        return None if name is None else WEIGHTS_DIR / name

    def pretrained_checksum(self, ptype: PretrainedType) -> Optional[str]:
        name = self.packaged.get(PretrainedType(ptype))
        entry = None if name is None else packaged_weight_entry(name)
        return None if entry is None else entry.get("sha256")

    def init_pretrained(self, ptype: PretrainedType = PretrainedType.IMAGENET,
                        *, device="cuda"):
        """The checkpoint of `ptype` (`pretrained_path`) restored on
        `device`: its sha256 (md5 for a 32-digit hash) checked against
        `pretrained_checksum` first, an IOError on a mismatch, then routed
        by the file's magic bytes: a Keras HDF5 file through the
        importer, anything else through `ModelSerializer.restore_model`."""
        from deeplearning4j_tpu_torch.device import resolve_device
        ptype = PretrainedType(ptype)
        path, expected = self.pretrained_path(ptype), None
        if path is not None and path.exists():
            expected = self.pretrained_checksum(ptype)
        if not expected:
            raise NotImplementedError(
                f"{type(self).__name__}.init_pretrained: no weights for "
                f"{ptype.value} — no packaged checkpoint with a manifest "
                f"checksum in the JAX package's zoo/weights/, and the port "
                f"downloads nothing (serve a file through pretrained_path "
                f"and pretrained_checksum, restore a model zip with "
                f"util/serializer.py, or load a JAX net's params with "
                f"util/jax_params.py)")
        device = resolve_device(device)
        path = Path(path)
        algo = hashlib.md5 if len(expected) == 32 else hashlib.sha256
        got = algo(path.read_bytes()).hexdigest()
        if got != expected:
            raise IOError(f"Checksum mismatch for {path}: {got} != "
                          f"{expected}")
        from deeplearning4j_tpu_torch.modelimport.hdf5 import HDF5_MAGIC
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == HDF5_MAGIC[:4]:      # JAX routes on these 4 bytes
            return self._import_keras(ptype, path, device)
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        return ModelSerializer.restore_model(path, device=device)

    def _import_keras(self, ptype, path, device):
        from deeplearning4j_tpu_torch.modelimport import (
            Hdf5Archive, KerasModelImport)
        with Hdf5Archive(path) as h5:
            full_model = h5.read_attr_string("model_config") is not None
        if full_model:
            return KerasModelImport.import_keras_model_and_weights(
                path, device=device)
        arch_name = self.keras_architecture.get(ptype)
        if arch_name:
            return KerasModelImport.import_architecture_and_weights(
                WEIGHTS_DIR / arch_name, path, device=device)
        return KerasModelImport.load_weights_into(self.init(device=device),
                                                  path)
