"""Dropout schemes (counterpart of `deeplearning4j_tpu/nn/conf/dropout.py`
:53-117): the four classes, their serde and their `apply(key, x)`, which
the layers call on their input while training. `p` is the RETAIN
probability, as in the reference.

Each draw is JAX's from the same threefry key (`common/prng.py`):
`Dropout` is the dropout kernel (`kernels/dropout.py`: the mask of
`jax.random.bernoulli(key, p, x.shape)`, x / p with p rounded to x's
dtype); `AlphaDropout` takes the same mask through plain ops;
`GaussianDropout` and `GaussianNoise` draw `jax.random.normal(key,
x.shape, x.dtype)` from the bits kernel. Python-float factors enter in
x's dtype, as JAX's weak types do.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.kernels.dropout import dropout

_DROPOUT_REGISTRY = {}


def _weak(v: float, x: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weak type meets x: rounded to x's dtype."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def register_dropout(cls):
    _DROPOUT_REGISTRY[cls.kind] = cls
    return cls


class IDropout:
    """Base: `apply(key, x)` returns the noised activations (train
    only)."""

    kind = "base"

    def apply(self, key, x):
        raise NotImplementedError

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

    def apply(self, key, x):
        return dropout(x, key, self.p)


@register_dropout
@dataclasses.dataclass(eq=False)
class AlphaDropout(IDropout):
    """SELU-preserving dropout: dropped units become alpha' and the
    result is corrected affinely (reference `AlphaDropout.java`)."""

    kind = "alpha_dropout"
    p: float = 0.5

    _ALPHA = 1.6732632423543772
    _LAMBDA = 1.0507009873554805

    def apply(self, key, x):
        if self.p >= 1.0:
            return x
        p = self.p
        alpha_p = -self._LAMBDA * self._ALPHA
        a = (p + alpha_p ** 2 * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * alpha_p
        keep = prng.bernoulli(key, p, x.shape, x.device)
        dropped = torch.where(keep, x, torch.tensor(alpha_p, dtype=x.dtype,
                                                    device=x.device))
        return _weak(a, x) * dropped + _weak(b, x)


@register_dropout
@dataclasses.dataclass(eq=False)
class GaussianDropout(IDropout):
    """Multiplicative noise N(1, rate / (1 - rate))."""

    kind = "gaussian_dropout"
    rate: float = 0.5

    def apply(self, key, x):
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = 1.0 + _weak(stddev, x) * prng.normal(key, x.shape, x.dtype,
                                                     x.device)
        return x * noise


@register_dropout
@dataclasses.dataclass(eq=False)
class GaussianNoise(IDropout):
    """Additive noise N(0, stddev^2)."""

    kind = "gaussian_noise"
    stddev: float = 0.1

    def apply(self, key, x):
        return x + _weak(self.stddev, x) * prng.normal(key, x.shape, x.dtype,
                                                       x.device)
