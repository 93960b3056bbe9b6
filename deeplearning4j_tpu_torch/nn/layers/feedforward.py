"""Dense and Embedding layers and the output-layer loss (counterpart of
`deeplearning4j_tpu/nn/layers/feedforward.py`: `DenseLayer` :35,
`BaseOutputLayerMixin` :83, `EmbeddingLayer` :169). Param names and
layouts are the JAX package's: W is [n_in, n_out] and is used as
``x @ W``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.activations import get_activation
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
)


class DenseLayer(Layer):
    def __init__(self, n_in: int, n_out: int, *, activation="sigmoid"):
        super().__init__()
        self.activation = get_activation(activation)
        self.n_in, self.n_out = int(n_in), int(n_out)
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu")

    def jax_param_map(self):
        return {"W": self.W, "b": self.b}

    def init_weights(self, gen: torch.Generator):
        init_weight_(self, self.W, gen)

    def pre_output(self, x):
        return torch.matmul(x, self.W) + self.b

    def forward(self, x):
        return self.activation(self.pre_output(x))


class BaseOutputLayerMixin:
    """Loss plumbing of the output layers: the loss of `pre_output(x)`
    under the layer's activation (`self.loss`)."""

    def compute_loss(self, x, labels, mask=None):
        return self.loss(labels, self.pre_output(x), self.activation,
                         mask=mask)


class EmbeddingLayer(Layer):
    """Index -> vector lookup with a bias `b` (the JAX layer's). Ids stay
    integer end to end (a float round trip collapses ids above 2^24);
    `fit` converts float-carried ids on the host. The lookup is
    `F.embedding`, whose gradient into W on CUDA sums by sorted index
    (deterministic) rather than with atomics."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.n_in, self.n_out = int(n_in), int(n_out)
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu")

    jax_param_map = DenseLayer.jax_param_map
    init_weights = DenseLayer.init_weights

    def forward(self, x):
        if x.is_floating_point():
            raise TypeError("EmbeddingLayer takes integer token ids")
        # an out-of-range id is a device-side assert on CUDA (XLA's
        # gather clamps or fills instead): clamp, and let the entry
        # points validate ids on the host
        idx = x.long().clamp(0, self.n_in - 1)
        return F.embedding(idx, self.W) + self.b
