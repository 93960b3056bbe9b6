"""Dropout schemes as configuration (counterpart of
`deeplearning4j_tpu/nn/conf/dropout.py`): the four classes, their
fields and their serde. What they do to activations is not ported yet
(ROADMAP Queue 1 item 5): they act only while training, so the
container accepts them for inference and refuses them in `fit`.
`p` is the RETAIN probability, as in the reference."""

from __future__ import annotations

import dataclasses

_DROPOUT_REGISTRY = {}


def register_dropout(cls):
    _DROPOUT_REGISTRY[cls.kind] = cls
    return cls


class IDropout:
    kind = "base"

    def to_dict(self):
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()


def dropout_from_dict(d):
    d = dict(d)
    return _DROPOUT_REGISTRY[d.pop("kind")](**d)


@register_dropout
@dataclasses.dataclass(eq=False)
class Dropout(IDropout):
    kind = "dropout"
    p: float = 0.5


@register_dropout
@dataclasses.dataclass(eq=False)
class AlphaDropout(IDropout):
    kind = "alpha_dropout"
    p: float = 0.5


@register_dropout
@dataclasses.dataclass(eq=False)
class GaussianDropout(IDropout):
    kind = "gaussian_dropout"
    rate: float = 0.5


@register_dropout
@dataclasses.dataclass(eq=False)
class GaussianNoise(IDropout):
    kind = "gaussian_noise"
    stddev: float = 0.1
