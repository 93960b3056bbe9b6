"""Weight-init distributions (counterpart of
`deeplearning4j_tpu/common/distributions.py` :16-115): Normal/Gaussian,
Uniform, Binomial, Constant, LogNormal, TruncatedNormal, Orthogonal,
with the JAX package's dict serde.

Samples are drawn on the CPU from an explicit `torch.Generator`, so a
seed gives the same weights on every device. The JAX package draws
threefry bits; the two packages share the distributions, not the
draws.
"""

from __future__ import annotations

import dataclasses

import torch


class Distribution:
    name = "base"

    def sample(self, gen: torch.Generator, shape, dtype=torch.float32):
        raise NotImplementedError

    def to_dict(self):
        d = {"distribution": self.name}
        d.update(dataclasses.asdict(self))
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def _normal(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=dtype)


@dataclasses.dataclass(eq=False)
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0
    name = "normal"

    def sample(self, gen, shape, dtype=torch.float32):
        return self.mean + self.std * _normal(gen, shape, dtype)


@dataclasses.dataclass(eq=False)
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0
    name = "uniform"

    def sample(self, gen, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=gen, dtype=dtype)
        return self.lower + (self.upper - self.lower) * u


@dataclasses.dataclass(eq=False)
class BinomialDistribution(Distribution):
    trials: int = 1
    probability: float = 0.5
    name = "binomial"

    def sample(self, gen, shape, dtype=torch.float32):
        u = torch.rand((self.trials,) + tuple(shape), generator=gen)
        return (u < self.probability).sum(dim=0).to(dtype)


@dataclasses.dataclass(eq=False)
class ConstantDistribution(Distribution):
    value: float = 0.0
    name = "constant"

    def sample(self, gen, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype)


@dataclasses.dataclass(eq=False)
class LogNormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0
    name = "lognormal"

    def sample(self, gen, shape, dtype=torch.float32):
        return torch.exp(self.mean + self.std * _normal(gen, shape, dtype))


@dataclasses.dataclass(eq=False)
class TruncatedNormalDistribution(Distribution):
    """mean + std·z with z a standard normal truncated to [-2, 2]."""

    mean: float = 0.0
    std: float = 1.0
    name = "truncated_normal"

    def sample(self, gen, shape, dtype=torch.float32):
        z = torch.empty(tuple(shape), dtype=dtype)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return self.mean + self.std * z


@dataclasses.dataclass(eq=False)
class OrthogonalDistribution(Distribution):
    gain: float = 1.0
    name = "orthogonal"

    def sample(self, gen, shape, dtype=torch.float32):
        w = torch.empty(tuple(shape), dtype=dtype)
        return torch.nn.init.orthogonal_(w, gain=self.gain, generator=gen)


_DISTS = {
    "normal": NormalDistribution,
    "gaussian": NormalDistribution,  # the reference treats Gaussian == Normal
    "uniform": UniformDistribution,
    "binomial": BinomialDistribution,
    "constant": ConstantDistribution,
    "lognormal": LogNormalDistribution,
    "truncated_normal": TruncatedNormalDistribution,
    "orthogonal": OrthogonalDistribution,
}


def distribution_from_dict(d: dict) -> Distribution:
    d = dict(d)
    return _DISTS[d.pop("distribution")](**d)
