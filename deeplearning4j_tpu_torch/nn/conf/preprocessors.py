"""Input preprocessors as configuration (counterpart of
`deeplearning4j_tpu/nn/conf/preprocessors.py`): the six shape adapters
with their fields, serde and output types, so a configuration that
carries one builds and round-trips. Their forward belongs with the
layer families they join (ROADMAP Queue 1 item 9) and raises until
then; the transformer LM's chain inserts none."""

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
        raise NotImplementedError(
            f"input preprocessor {self.preproc_name!r} is not ported yet "
            f"(it joins layer families of ROADMAP Queue 1 item 9)")

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

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.arity())


@register_preprocessor
@dataclasses.dataclass(eq=False)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "ff_to_cnn"

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    preproc_name = "rnn_to_ff"

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    timesteps: int = 0
    preproc_name = "ff_to_rnn"

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.size, self.timesteps or None)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class CnnToRnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "cnn_to_rnn"

    def get_output_type(self, input_type):
        return InputType.recurrent(input_type.arity(), 1)


@register_preprocessor
@dataclasses.dataclass(eq=False)
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0
    preproc_name = "rnn_to_cnn"

    def get_output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)
