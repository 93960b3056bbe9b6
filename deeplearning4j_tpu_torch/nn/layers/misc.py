"""Layer wrappers and shape layers (counterpart of
`deeplearning4j_tpu/nn/layers/misc.py`: `FrozenLayer` :28-68,
`ReshapeLayer` :71-100, `PermuteLayer` :103-129, `PoolHelperLayer`
:132-149).

`FrozenLayer` wraps any layer: its params are the inner layer's own
(JAX names, no prefix), its updater is always `NoOp` and it adds no
regularization. Its forward runs the inner layer in inference mode (no
dropout, BatchNormalization on its running statistics, which it never
updates) on its params with their gradients stopped, so the layers
before it still learn through it.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common.updaters import NoOp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    layer_from_dict,
    register_layer,
)


@register_layer
class FrozenLayer(Layer):
    layer_name = "frozen"
    FIELDS = (("layer", None),)

    def __init__(self, **config):
        inner = config.get("layer")
        if isinstance(inner, dict):
            config["layer"] = layer_from_dict(inner)
        super().__init__(**config)
        self.updater = NoOp()

    def set_n_in(self, input_type, override=True):
        self.layer.set_n_in(input_type, override)

    def get_output_type(self, input_type):
        return self.layer.get_output_type(input_type)

    def jax_param_map(self):
        return self.layer.jax_param_map()

    def init_weights(self, key):
        self.layer.init_weights(key)

    def state_map(self):
        return self.layer.state_map()

    def forward(self, x, *, train=False, rng=None, mask=None,
                new_state=None):
        frozen = {n: p.detach() for n, p in self.layer.named_parameters()}
        return torch.func.functional_call(
            self.layer, frozen, (x,), dict(train=False, rng=None, mask=mask),
            strict=False)

    def forward_mask(self, mask):
        return self.layer.forward_mask(mask)

    def regularization_score(self, params):
        return 0.0


def _type_of(shape):
    """The InputType of a per-example shape in this framework's
    layouts: [F], [T, F] recurrent, [H, W, C] convolutional."""
    if len(shape) == 1:
        return InputType.feed_forward(shape[0])
    if len(shape) == 2:
        return InputType.recurrent(shape[1], shape[0])
    if len(shape) == 3:
        return InputType.convolutional(shape[0], shape[1], shape[2])
    return None


@register_layer
class ReshapeLayer(Layer):
    """A static reshape of the non-batch axes to `target_shape`."""

    layer_name = "reshape"
    FIELDS = (("target_shape", ()),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.target_shape = tuple(int(d) for d in self.target_shape)

    def get_output_type(self, input_type):
        t = _type_of(self.target_shape)
        if t is None:
            raise ValueError(f"Unsupported reshape target {self.target_shape}")
        return t

    def forward(self, x, *, train=False, rng=None, mask=None):
        return x.reshape((x.shape[0],) + self.target_shape)


@register_layer
class PermuteLayer(Layer):
    """Permute the non-batch axes; `dims` are the 1-indexed input axes in
    their new order (Keras's Permute)."""

    layer_name = "permute"
    FIELDS = (("dims", ()),)
    DEFAULT_ACTIVATION = "identity"

    def __init__(self, **config):
        super().__init__(**config)
        self.dims = tuple(int(d) for d in self.dims)

    def get_output_type(self, input_type):
        shape = input_type.shape()
        t = _type_of(tuple(shape[d - 1] for d in self.dims))
        if t is None:
            raise ValueError(f"Unsupported permute rank {len(self.dims)}")
        return t

    def forward(self, x, *, train=False, rng=None, mask=None):
        return x.permute((0,) + self.dims)


@register_layer
class PoolHelperLayer(Layer):
    """Drops the first row and the first column of NHWC activations."""

    layer_name = "pool_helper"
    DEFAULT_ACTIVATION = "identity"

    def get_output_type(self, input_type):
        return InputType.convolutional(input_type.height - 1,
                                       input_type.width - 1,
                                       input_type.channels)

    def forward(self, x, *, train=False, rng=None, mask=None):
        return x[:, 1:, 1:, :]
