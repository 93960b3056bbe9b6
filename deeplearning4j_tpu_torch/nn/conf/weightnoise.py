"""Weight noise (counterpart of `deeplearning4j_tpu/nn/conf/
weightnoise.py` :36-105): DropConnect and WeightNoise, their serde, and
`apply_params(key, params)`, which the container calls on a layer's
params right before its forward while training, so autograd sees the
noised weights.

Param i of the layer's params in sorted-name order takes the key
`fold_in(key, i)`; bias-like params (`constraints.is_bias_param`) pass
unchanged unless `apply_to_bias`. `DropConnect` is the dropout kernel
on the weight (`kernels/dropout.py`); `WeightNoise` draws from its
distribution's keyed `sample`, JAX's draw for every distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.distributions import (
    Distribution,
    NormalDistribution,
    distribution_from_dict,
)
from deeplearning4j_tpu_torch.kernels.dropout import dropout
from deeplearning4j_tpu_torch.nn.conf.constraints import is_bias_param

_WEIGHT_NOISE_REGISTRY = {}


def register_weight_noise(cls):
    _WEIGHT_NOISE_REGISTRY[cls.kind] = cls
    return cls


class IWeightNoise:
    kind = "base"
    apply_to_bias: bool = False

    def apply(self, key, name: str, w):
        raise NotImplementedError

    def apply_params(self, key, params: dict) -> dict:
        out = {}
        for i, (name, w) in enumerate(sorted(params.items())):
            if is_bias_param(name) and not self.apply_to_bias:
                out[name] = w
            else:
                out[name] = self.apply(prng.fold_in(key, i), name, w)
        return out

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

    def apply(self, key, name, w):
        return dropout(w, key, self.p)


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

    def apply(self, key, name, w):
        noise = self.dist.sample(key, w.shape, w.dtype, w.device)
        return w + noise if self.additive else w * noise
