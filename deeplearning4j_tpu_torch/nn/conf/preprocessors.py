"""Input preprocessors (counterpart of
`deeplearning4j_tpu/nn/conf/preprocessors.py`): the six shape adapters
between layer families, with their fields, serde and output types.
`pre_process` reshapes the activation and `process_mask` the [B, T] /
[B] padding mask the containers carry with it (unchanged by default,
JAX :44-45); both are reshapes and transposes, so they equal JAX's bit
for bit.

Flatten order: activations are NHWC in both packages, and
`CnnToFeedForward` (with `data_format="nchw"`, the default) and
`CnnToRnn` permute to NCHW before they flatten, the reference's
channel-major order, so a dense layer's W rows after a convolution are
the JAX net's (the packaged LeNet's `ffn1` among them). With
`data_format="nhwc"` (the Keras TF dialect) the NHWC tensor flattens as
it is."""

from __future__ import annotations

import dataclasses
from typing import Dict

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

_PREPROC_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    _PREPROC_REGISTRY[cls.preproc_name] = cls
    return cls


class InputPreProcessor:
    preproc_name = "base"

    def pre_process(self, x, mask=None):
        raise NotImplementedError

    def process_mask(self, mask):
        return mask

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        d = {"preprocessor": self.preproc_name}
        d.update(dataclasses.asdict(self))
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def preprocessor_from_dict(d: dict) -> InputPreProcessor:
    d = dict(d)
    return _PREPROC_REGISTRY[d.pop("preprocessor")](**d)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    data_format: str = "nchw"
    preproc_name = "cnn_to_ff"

    def pre_process(self, x, mask=None):
        n = x.shape[0]
        if self.data_format == "nhwc":
            return x.reshape(n, -1)
        return x.permute(0, 3, 1, 2).reshape(n, -1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.arity())


@register_preprocessor
@dataclasses.dataclass(eq=False)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "ff_to_cnn"

    def pre_process(self, x, mask=None):
        nchw = x.reshape(x.shape[0], self.channels, self.height, self.width)
        return nchw.permute(0, 2, 3, 1)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] -> [B*T, F]: time folded into the batch, and the mask
    [B, T] -> [B*T]."""

    preproc_name = "rnn_to_ff"

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def process_mask(self, mask):
        return None if mask is None else mask.reshape(-1)

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] -> [B, T, F] with T = `timesteps`, and the mask [B*T] ->
    [B, T]."""

    timesteps: int = 0
    preproc_name = "ff_to_rnn"

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def process_mask(self, mask):
        return None if mask is None else mask.reshape(-1, self.timesteps)

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.timesteps or None)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class CnnToRnnPreProcessor(InputPreProcessor):
    """NHWC [B, H, W, C] -> [B, 1, C*H*W]: each example's conv output,
    flattened channel-major, is one timestep's features."""

    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "cnn_to_rnn"

    def pre_process(self, x, mask=None):
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], 1, -1)

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.arity(), 1)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, C*H*W] -> NHWC [B*T, H, W, C] (time folded into the
    batch), and the mask [B, T] -> [B*T]."""

    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "rnn_to_cnn"

    def pre_process(self, x, mask=None):
        nchw = x.reshape(x.shape[0] * x.shape[1], self.channels, self.height,
                         self.width)
        return nchw.permute(0, 2, 3, 1)

    def process_mask(self, mask):
        return None if mask is None else mask.reshape(-1)

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)
