"""Global pooling (counterpart of `deeplearning4j_tpu/nn/layers/
pooling.py` :22-90): MAX, AVG, SUM and PNORM over the T axis of
[B, T, F], aware of the [B, T] padding mask (`MaskedReductionUtil`
semantics: masked steps are -inf for MAX and weigh 0 in the sums, and
AVG divides by ``max(sum(mask), 1)``), or over the spatial axes (1, 2)
of an NHWC [B, H, W, C] input, unmasked, as in JAX. The mask stops here
(`forward_mask` is None).
"""

from __future__ import annotations

from enum import Enum

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


class PoolingType(str, Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@register_layer
class GlobalPoolingLayer(Layer):
    layer_name = "global_pooling"
    FIELDS = (("pooling_type", PoolingType.MAX), ("pnorm", 2),
              ("collapse_dimensions", True))

    def __init__(self, **config):
        super().__init__(**config)
        self.pooling_type = PoolingType(self.pooling_type)

    def get_output_type(self, input_type):
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.feed_forward(input_type.size)
        if isinstance(input_type, InputTypeConvolutional):
            return InputType.feed_forward(input_type.channels)
        return input_type

    def _reduce(self, x, dims, mask=None):
        pt = self.pooling_type
        if mask is not None:
            m = mask[..., None]                           # [B, T, 1]
            if pt == PoolingType.MAX:
                return torch.where(m > 0, x, torch.full_like(
                    x, float("-inf"))).amax(dim=dims)
            if pt == PoolingType.SUM:
                return (x * m).sum(dim=dims)
            if pt == PoolingType.AVG:
                denom = torch.clamp(m.sum(dim=dims), min=1.0)
                return (x * m).sum(dim=dims) / denom
            p = float(self.pnorm)
            return ((x.abs() * m) ** p).sum(dim=dims) ** (1.0 / p)
        if pt == PoolingType.MAX:
            return x.amax(dim=dims)
        if pt == PoolingType.SUM:
            return x.sum(dim=dims)
        if pt == PoolingType.AVG:
            return x.mean(dim=dims)
        p = float(self.pnorm)
        return (x.abs() ** p).sum(dim=dims) ** (1.0 / p)

    def forward(self, x, *, train=False, rng=None, mask=None):
        if x.ndim == 3:                 # [B, T, F]: over time
            return self._reduce(x, 1, mask)
        if x.ndim == 4:                 # NHWC: over H and W
            return self._reduce(x, (1, 2))
        raise ValueError(f"GlobalPooling expects 3d or 4d input, got "
                         f"{tuple(x.shape)}")

    def forward_mask(self, mask):
        return None
