"""Global pooling over time (counterpart of
`deeplearning4j_tpu/nn/layers/pooling.py` :22-90): MAX, AVG, SUM and
PNORM over the T axis of [B, T, F], aware of the [B, T] padding mask
(`MaskedReductionUtil` semantics): masked steps are -inf for MAX and
weigh 0 in the sums, and AVG divides by ``max(sum(mask), 1)``. The mask
stops here (`forward_mask` is None). Pooling over a CNN's spatial axes
is a later slice (ROADMAP Queue 1 item 9): a 4-D input is refused.
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

    def _reduce(self, x, mask=None):
        pt = self.pooling_type
        if mask is not None:
            m = mask[..., None]                           # [B, T, 1]
            if pt == PoolingType.MAX:
                return torch.where(m > 0, x, torch.full_like(
                    x, float("-inf"))).amax(dim=1)
            if pt == PoolingType.SUM:
                return (x * m).sum(dim=1)
            if pt == PoolingType.AVG:
                denom = torch.clamp(m.sum(dim=1), min=1.0)
                return (x * m).sum(dim=1) / denom
            p = float(self.pnorm)
            return ((x.abs() * m) ** p).sum(dim=1) ** (1.0 / p)
        if pt == PoolingType.MAX:
            return x.amax(dim=1)
        if pt == PoolingType.SUM:
            return x.sum(dim=1)
        if pt == PoolingType.AVG:
            return x.mean(dim=1)
        p = float(self.pnorm)
        return (x.abs() ** p).sum(dim=1) ** (1.0 / p)

    def forward(self, x, *, train=False, rng=None, mask=None):
        if x.ndim == 3:
            return self._reduce(x, mask)
        if x.ndim == 4:
            raise NotImplementedError(
                "global pooling over a CNN's spatial axes is not ported "
                "(ROADMAP Queue 1 item 9)")
        raise ValueError(f"GlobalPooling expects 3d or 4d input, got "
                         f"{tuple(x.shape)}")

    def forward_mask(self, mask):
        return None
