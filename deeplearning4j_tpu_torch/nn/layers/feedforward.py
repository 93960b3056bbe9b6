"""Dense and Embedding layers and the output-layer loss (counterpart of
`deeplearning4j_tpu/nn/layers/feedforward.py`: `DenseLayer` :35,
`BaseOutputLayerMixin` :83, `EmbeddingLayer` :169). Param names and
layouts are the JAX package's: W is [n_in, n_out] and is used as
``x @ W``; `b` exists when `has_bias` and starts at `bias_init`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    init_weight_,
    new_param,
    register_layer,
)


class _WeightAndBias(Layer):
    """W [n_in, n_out] and, with `has_bias`, b [n_out] filled with
    `bias_init`: the params of Dense, RnnOutput and Embedding."""

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        W = getattr(self, "W", None)
        if not (self.n_in and self.n_out) or (
                W is not None and tuple(W.shape) == (self.n_in, self.n_out)
                and (self.b is not None) == bool(self.has_bias)):
            return
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu") if self.has_bias else None

    def jax_param_map(self):
        if getattr(self, "W", None) is None:
            return {}
        return {"W": self.W, "b": self.b} if self.has_bias else {"W": self.W}

    def init_weights(self, gen: torch.Generator):
        init_weight_(self, self.W, gen)
        if self.has_bias:
            with torch.no_grad():
                self.b.fill_(self.bias_init)


@register_layer
class DenseLayer(_WeightAndBias):
    layer_name = "dense"
    FIELDS = (("n_in", 0), ("n_out", 0), ("has_bias", True))
    DEFAULT_ACTIVATION = "sigmoid"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self._build()

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.arity()
        self._build()

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def pre_output(self, x):
        z = torch.matmul(x, self.W)
        return z + self.b if self.has_bias else z

    def forward(self, x):
        return self.activation(self.pre_output(x))


class BaseOutputLayerMixin:
    """Loss plumbing of the output layers: the loss of `pre_output(x)`
    under the layer's activation (`self.loss`)."""

    def compute_loss(self, x, labels, mask=None):
        return self.loss(labels, self.pre_output(x), self.activation,
                         mask=mask)


@register_layer
class EmbeddingLayer(_WeightAndBias):
    """Index -> vector lookup with a bias `b` (the JAX layer's). Ids stay
    integer end to end (a float round trip collapses ids above 2^24);
    `fit` converts float-carried ids on the host. The lookup is
    `F.embedding`, whose gradient into W on CUDA sums by sorted index
    (deterministic) rather than with atomics. Without
    `time_series_input` (set by the builder from a recurrent input
    type) a [B, 1] column of ids is a batch of single ids, as in JAX."""

    layer_name = "embedding"
    FIELDS = (("n_in", 0), ("n_out", 0), ("has_bias", True),
              ("time_series_input", False))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self._build()

    def set_n_in(self, input_type, override=True):
        recurrent = isinstance(input_type, InputTypeRecurrent)
        if override or not self.n_in:
            # [B, T] token ids: the vocabulary is the type's size
            self.n_in = input_type.size if recurrent else input_type.arity()
        self.time_series_input = recurrent
        self._build()

    def get_output_type(self, input_type):
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def forward(self, x):
        if x.is_floating_point():
            raise TypeError("EmbeddingLayer takes integer token ids")
        # an out-of-range id is a device-side assert on CUDA (XLA's
        # gather clamps or fills instead): clamp, and let the entry
        # points validate ids on the host
        idx = x.long().clamp(0, self.n_in - 1)
        if idx.ndim == 2 and idx.shape[-1] == 1 and not self.time_series_input:
            idx = idx[:, 0]
        z = F.embedding(idx, self.W)
        return self.activation(z + self.b if self.has_bias else z)
