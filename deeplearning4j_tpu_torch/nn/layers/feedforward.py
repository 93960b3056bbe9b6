"""Dense, output, dropout and embedding layers and the output-layer loss
(counterpart of `deeplearning4j_tpu/nn/layers/feedforward.py`:
`DenseLayer` :35, `BaseOutputLayerMixin` :83, `OutputLayer` :95,
`LossLayer` :109, `ActivationLayer` :136, `DropoutLayer` :150,
`EmbeddingLayer` :169, `AutoEncoder` :240). Param names and layouts
are the JAX package's: W is [n_in, n_out] and is used as ``x @ W``; `b`
exists when `has_bias` and starts at `bias_init`. Dense-based layers
(and the loss) apply their input dropout while training; the embedding
applies none, as in JAX."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.losses import get_loss
from deeplearning4j_tpu_torch.nd import quant
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

    def init_weights(self, key):
        init_weight_(self, self.W, key)
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

    def quantizable_weights(self):
        return ("W",)

    def pre_output(self, x):
        z = quant.matmul(x, quant.weight(self, "W"))
        return z + quant.weight(self, "b") if self.has_bias else z

    def forward(self, x, *, train=False, rng=None, mask=None):
        x = self.apply_input_dropout(x, train, rng)
        return self.activation(self.pre_output(x))


class BaseOutputLayerMixin:
    """Loss plumbing of the output layers: the loss of `pre_output(x)`
    under the layer's activation (`self.loss`), after the layer's input
    dropout while training; `mask` is the label mask."""

    def compute_loss(self, x, labels, mask=None, *, train=False, rng=None):
        x = self.apply_input_dropout(x, train, rng)
        return self.loss(labels, self.pre_output(x), self.activation,
                         mask=mask)


@register_layer
class OutputLayer(DenseLayer, BaseOutputLayerMixin):
    """Dense projection, activation (softmax by default) and loss (mcxent
    by default) for [B, n_in] inputs."""

    layer_name = "output"
    FIELDS = DenseLayer.FIELDS + (("loss", None),)
    DEFAULT_ACTIVATION = "softmax"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in, n_out, **config)
        self.loss = get_loss(self.loss if self.loss is not None
                             else "mcxent")


@register_layer
class LossLayer(Layer, BaseOutputLayerMixin):
    """A parameterless output layer: the activation (identity by default)
    and the loss (mcxent by default) of the incoming array."""

    layer_name = "loss"
    FIELDS = (("loss", None),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.loss = get_loss(self.loss if self.loss is not None
                             else "mcxent")

    def pre_output(self, x):
        return x

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.activation(self.apply_input_dropout(x, train, rng))


@register_layer
class ActivationLayer(Layer):
    """The activation alone (identity by default), no params."""

    layer_name = "activation"
    DEFAULT_ACTIVATION = "identity"

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.activation(x)


@register_layer
class DropoutLayer(Layer):
    """Dropout alone (reference `DropoutLayer.java`): `dropout` (a retain
    probability, 0.5 by default, or an `IDropout`) on the input while
    training, then the activation (identity by default)."""

    layer_name = "dropout_layer"
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        if self.dropout is None:
            self.dropout = 0.5

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.activation(self.apply_input_dropout(x, train, rng))


@register_layer
class EmbeddingLayer(_WeightAndBias):
    """Index -> vector lookup with a bias `b` (the JAX layer's). Ids stay
    integer end to end (a float round trip collapses ids above 2^24);
    `fit` converts float-carried ids on the host. The lookup is
    `F.embedding`; an fp32 W on the card takes `_FixedOrderEmbedding`,
    whose gradient sums each row's contributions in one fixed order
    (`F.embedding`'s own fp32 gradient there differs from run to run in
    the last bits, which breaks a bit-exact resume). Without
    `time_series_input` (set by the builder from a recurrent input
    type) a [B, 1] column of ids is a batch of single ids, as in JAX."""

    layer_name = "embedding"
    FIELDS = (("n_in", 0), ("n_out", 0), ("has_bias", True),
              ("time_series_input", False))
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self._build()

    def quantizable_weights(self):
        return ("W",)

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

    def forward(self, x, *, train=False, rng=None, mask=None):
        if x.is_floating_point():
            raise TypeError("EmbeddingLayer takes integer token ids")
        # an out-of-range id is a device-side assert on CUDA (XLA's
        # gather clamps or fills instead): clamp, and let the entry
        # points validate ids on the host
        idx = x.long().clamp(0, self.n_in - 1)
        if idx.ndim == 2 and idx.shape[-1] == 1 and not self.time_series_input:
            idx = idx[:, 0]
        W = quant.weight(self, "W")
        if isinstance(W, quant.QuantizedTensor):
            # gather the int8 rows, then scale (exact per column)
            z = W.q[idx].to(W.scale.dtype) * W.scale[0]
        elif W.is_cuda and W.dtype == torch.float32:
            z = _FixedOrderEmbedding.apply(idx, W)
        else:
            z = F.embedding(idx, W)
        return self.activation(z + quant.weight(self, "b") if self.has_bias
                               else z)


class _FixedOrderEmbedding(torch.autograd.Function):
    """`F.embedding(idx, W)` whose gradient into W is
    ``index_put_(accumulate=True)`` under deterministic algorithms (a
    stable sort by row, then each row summed in that order), so two runs
    of a step give the same bits."""

    @staticmethod
    def forward(ctx, idx, W):
        ctx.save_for_backward(idx)
        ctx.rows = W.shape[0]
        return F.embedding(idx, W)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        d = grad.shape[-1]
        gw = torch.zeros((ctx.rows, d), dtype=grad.dtype, device=grad.device)
        on = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            gw.index_put_((idx.reshape(-1),), grad.reshape(-1, d),
                          accumulate=True)
        finally:
            torch.use_deterministic_algorithms(on, warn_only=warn)
        return None, gw


@register_layer
class AutoEncoder(Layer):
    """Denoising autoencoder with tied weights: W [n_in, n_out], hidden
    bias b [n_out] (`bias_init`) and visible bias vb [n_in] (zeros).
    `forward` encodes, ``act(x W + b)``; `pretrain_loss` reconstructs
    the input, corrupted by a Bernoulli(1 - corruption_level) keep mask,
    through ``W^T`` and vb under the layer's loss."""

    layer_name = "autoencoder"
    FIELDS = (("n_in", 0), ("n_out", 0), ("corruption_level", 0.3),
              ("sparsity", 0.0), ("loss", "mse"))
    DEFAULT_ACTIVATION = "sigmoid"

    def __init__(self, n_in: int = 0, n_out: int = 0, **config):
        super().__init__(n_in=n_in, n_out=n_out, **config)
        self.loss = get_loss(self.loss)
        self._build()

    def _build(self):
        self.n_in, self.n_out = int(self.n_in), int(self.n_out)
        W = getattr(self, "W", None)
        if not (self.n_in and self.n_out) or (
                W is not None and tuple(W.shape) == (self.n_in, self.n_out)):
            return
        self.W = new_param((self.n_in, self.n_out), "cpu")
        self.b = new_param((self.n_out,), "cpu")
        self.vb = new_param((self.n_in,), "cpu")

    def set_n_in(self, input_type, override=True):
        if override or not self.n_in:
            self.n_in = input_type.arity()
        self._build()

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def jax_param_map(self):
        if getattr(self, "W", None) is None:
            return {}
        return {"W": self.W, "b": self.b, "vb": self.vb}

    def init_weights(self, key):
        init_weight_(self, self.W, key)
        with torch.no_grad():
            self.b.fill_(self.bias_init)
            self.vb.zero_()

    def encode(self, x):
        return self.activation(x @ self.W + self.b)

    def decode(self, h):
        return self.activation(h @ self.W.T + self.vb)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return self.encode(self.apply_input_dropout(x, train, rng))

    def pretrain_loss(self, x, rng):
        """The denoising reconstruction loss under the threefry key `rng`
        (JAX `AutoEncoder.pretrain_loss` :288-298)."""
        if self.corruption_level > 0 and rng is not None:
            keep = prng.bernoulli(rng, 1.0 - self.corruption_level, x.shape,
                                  x.device)
            x_in = torch.where(keep, x, torch.zeros_like(x))
        else:
            x_in = x
        recon_pre = self.encode(x_in) @ self.W.T + self.vb
        return self.loss(x, recon_pre, self.activation)
