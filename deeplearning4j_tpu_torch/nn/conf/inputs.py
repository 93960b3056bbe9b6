"""Input types: shape metadata for n_in inference and automatic
preprocessor insertion (counterpart of
`deeplearning4j_tpu/nn/conf/inputs.py:22-126`, the same four kinds and
serde). Recurrent activations are [batch, time, features] and
convolutional ones NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses


class InputType:
    kind = "base"

    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(int(size))

    @staticmethod
    def recurrent(size: int,
                  timesteps: int | None = None) -> "InputTypeRecurrent":
        return InputTypeRecurrent(int(size), timesteps)

    @staticmethod
    def convolutional(height: int, width: int,
                      channels: int) -> "InputTypeConvolutional":
        return InputTypeConvolutional(int(height), int(width),
                                      int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputTypeConvolutionalFlat":
        return InputTypeConvolutionalFlat(int(height), int(width),
                                          int(channels))

    def arity(self) -> int:
        """Flattened element count per example."""
        raise NotImplementedError

    def shape(self, batch: int | None = None):
        """Per-example array shape in the *internal* layout (no batch dim
        unless batch given)."""
        raise NotImplementedError

    def to_dict(self):
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        kind = d.pop("kind")
        return _KINDS[kind](**d)


@dataclasses.dataclass(frozen=True)
class InputTypeFeedForward(InputType):
    size: int
    kind = "feedforward"

    def arity(self):
        return self.size

    def shape(self, batch=None):
        return (self.size,) if batch is None else (batch, self.size)


@dataclasses.dataclass(frozen=True)
class InputTypeRecurrent(InputType):
    size: int
    timesteps: int | None = None
    kind = "recurrent"

    def arity(self):
        if self.timesteps is None:
            raise ValueError("recurrent input with unknown timesteps has no "
                             "fixed arity")
        return self.size * self.timesteps

    def shape(self, batch=None):
        t = -1 if self.timesteps is None else self.timesteps
        return (t, self.size) if batch is None else (batch, t, self.size)


@dataclasses.dataclass(frozen=True)
class InputTypeConvolutional(InputType):
    height: int
    width: int
    channels: int
    kind = "convolutional"

    def arity(self):
        return self.height * self.width * self.channels

    def shape(self, batch=None):
        # internal layout is NHWC
        s = (self.height, self.width, self.channels)
        return s if batch is None else (batch,) + s


@dataclasses.dataclass(frozen=True)
class InputTypeConvolutionalFlat(InputType):
    height: int
    width: int
    channels: int
    kind = "convolutional_flat"

    def arity(self):
        return self.height * self.width * self.channels

    def shape(self, batch=None):
        s = (self.arity(),)
        return s if batch is None else (batch,) + s


_KINDS = {
    "feedforward": InputTypeFeedForward,
    "recurrent": InputTypeRecurrent,
    "convolutional": InputTypeConvolutional,
    "convolutional_flat": InputTypeConvolutionalFlat,
}
