"""Weight noise as configuration (counterpart of
`deeplearning4j_tpu/nn/conf/weightnoise.py`): DropConnect and
WeightNoise with their serde. The noise itself is not ported yet
(ROADMAP Queue 1 item 5); it acts only while training, so the
container refuses it in `fit`."""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.common.distributions import (
    Distribution,
    NormalDistribution,
    distribution_from_dict,
)

_WEIGHT_NOISE_REGISTRY = {}


def register_weight_noise(cls):
    _WEIGHT_NOISE_REGISTRY[cls.kind] = cls
    return cls


class IWeightNoise:
    kind = "base"

    def to_dict(self):
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.to_dict() if isinstance(v, Distribution) else v
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()


def weight_noise_from_dict(d):
    d = dict(d)
    cls = _WEIGHT_NOISE_REGISTRY[d.pop("kind")]
    if isinstance(d.get("dist"), dict):
        d["dist"] = distribution_from_dict(d["dist"])
    return cls(**d)


@register_weight_noise
@dataclasses.dataclass(eq=False)
class DropConnect(IWeightNoise):
    kind = "drop_connect"
    p: float = 0.5
    apply_to_bias: bool = False


@register_weight_noise
@dataclasses.dataclass(eq=False)
class WeightNoise(IWeightNoise):
    kind = "weight_noise"
    dist: Optional[Distribution] = None
    additive: bool = True
    apply_to_bias: bool = False

    def __post_init__(self):
        if self.dist is None:
            self.dist = NormalDistribution(0.0, 0.01)
