"""Keras model import + packaged pretrained zoo weights.

Two migration paths a DL4J user relies on (reference:
`KerasModelImport.java`, `ZooModel.initPretrained`):

1. import a Keras .h5 (any of the Keras 1/2/3 dialects) — a COMPILED
   model keeps its loss/optimizer and can keep training here. This
   needs libhdf5, which is probed up front (`modelimport.hdf5.libhdf5`)
   and the import skipped, with the probe's result printed, where the
   machine has none;
2. load a zoo model's pretrained checkpoint and evaluate it on the
   repository's committed 8x8 digits (`tests/fixtures/digits`, x / 16,
   bilinear to 28x28).
"""
import numpy as np

from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.modelimport import hdf5
from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
from deeplearning4j_tpu_torch.scripts import _common
from deeplearning4j_tpu_torch.zoo.base import PretrainedType
from deeplearning4j_tpu_torch.zoo.lenet import LeNet

FIXTURES = _common.REPO_ROOT / "tests" / "fixtures"
FINETUNE_EPOCHS = 3
N_EVAL = 300


def import_and_finetune(device):
    # real_bn.h5 was saved by Keras after model.compile(...): the import
    # maps its loss + optimizer, so fit() works immediately
    net = KerasModelImport.import_keras_model_and_weights(
        str(FIXTURES / "keras" / "real_bn.h5"), device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    print("imported output:",
          net.output(x[:2]).detach().cpu().numpy().round(3))
    net.fit(x, y, epochs=FINETUNE_EPOCHS)
    print("fine-tuned score:", net.score_value)
    return net


def digits_28x28():
    """The committed digits as the packaged LeNet was trained on them."""
    import torch
    import torch.nn.functional as F
    d = np.load(FIXTURES / "digits" / "digits_8x8.npz")
    x = torch.from_numpy(d["images"].astype(np.float32) / 16.0)[:, None]
    x = F.interpolate(x, size=(28, 28), mode="bilinear",
                      align_corners=False)[:, 0, :, :, None].numpy()
    return x, np.eye(10, dtype=np.float32)[d["target"]]


def pretrained_zoo(device):
    # ships inside the package (zoo/weights/) — no network needed
    net = LeNet().init_pretrained(PretrainedType.MNIST, device=device)
    x, y = digits_28x28()
    ev = Evaluation(10)
    ev.eval(y[:N_EVAL], net.output(x[:N_EVAL]).detach().cpu().numpy())
    print(ev.stats(include_per_class=False))
    return ev


def main(argv=None):
    device = _common.parse_device(argv, __doc__)
    lib = hdf5.libhdf5()
    print(f"libhdf5: {lib or 'not found'}")
    imported = import_and_finetune(device) if lib else None
    if lib is None:
        print("Keras .h5 import skipped: this machine has no libhdf5")
    return imported, pretrained_zoo(device)


if __name__ == "__main__":
    main()
