"""ZooModel template (counterpart of `deeplearning4j_tpu/zoo/base.py`):
a model's configuration (`conf()`) and its net with weights drawn from
the seed (`init()`). The port ships no weights and downloads nothing:
`init_pretrained` refuses, and the JAX models' Keras-import hooks have
no counterpart.
"""

from __future__ import annotations

from enum import Enum


class PretrainedType(str, Enum):
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    TEXT = "text"


class ZooModel:
    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = num_classes
        self.seed = seed
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, device="cuda", dtype_policy=None):
        raise NotImplementedError

    def init_pretrained(self, ptype: PretrainedType = PretrainedType.IMAGENET):
        raise NotImplementedError(
            f"{type(self).__name__}.init_pretrained: the port ships no "
            f"weights and downloads nothing; restore a model zip "
            f"(util/serializer.py) or load a JAX net's params "
            f"(util/jax_params.py)")
