"""Weight-init distributions (counterpart of
`deeplearning4j_tpu/common/distributions.py` :16-115): Normal/Gaussian,
Uniform, Binomial, Constant, LogNormal, TruncatedNormal, Orthogonal,
with the JAX package's dict serde.

`sample(key, shape, dtype, device)` draws what the JAX distribution's
`sample` draws from the same threefry key (`common/prng.py`): the bits
exact, erfinv, erf and log within about 5e-6 relative, and the
orthogonal draw's QR within its rounding (LAPACK or cuSOLVER here,
XLA's Householder there). Weight init and weight noise both draw
through it.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.common import prng


class Distribution:
    name = "base"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        raise NotImplementedError

    def to_dict(self):
        d = {"distribution": self.name}
        d.update(dataclasses.asdict(self))
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def _scalar(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(eq=False)
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0
    name = "normal"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        """``mean + std * normal(key, shape, dtype)``, the floats entering
        in `dtype`."""
        z = prng.normal(key, shape, dtype, device)
        return _scalar(self.mean, z) + _scalar(self.std, z) * z


@dataclasses.dataclass(eq=False)
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0
    name = "uniform"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        return prng.uniform(key, shape, dtype, self.lower, self.upper,
                            device)


@dataclasses.dataclass(eq=False)
class BinomialDistribution(Distribution):
    trials: int = 1
    probability: float = 0.5
    name = "binomial"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        """The sum over `trials` of ``bernoulli(key, p, (trials,) +
        shape)``."""
        draws = prng.bernoulli(key, self.probability,
                               (self.trials,) + tuple(shape), device)
        return draws.sum(dim=0).to(dtype)


@dataclasses.dataclass(eq=False)
class ConstantDistribution(Distribution):
    value: float = 0.0
    name = "constant"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


@dataclasses.dataclass(eq=False)
class LogNormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0
    name = "lognormal"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        z = prng.normal(key, shape, dtype, device)
        return torch.exp(_scalar(self.mean, z) + _scalar(self.std, z) * z)


@dataclasses.dataclass(eq=False)
class TruncatedNormalDistribution(Distribution):
    """mean + std·z with z a standard normal truncated to [-2, 2]."""

    mean: float = 0.0
    std: float = 1.0
    name = "truncated_normal"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        z = prng.truncated_normal(key, -2.0, 2.0, shape, dtype, device)
        return _scalar(self.mean, z) + _scalar(self.std, z) * z


@dataclasses.dataclass(eq=False)
class OrthogonalDistribution(Distribution):
    gain: float = 1.0
    name = "orthogonal"

    def sample(self, key, shape, dtype=torch.float32, device="cpu"):
        """`gain * jax.nn.initializers.orthogonal()(key, shape, dtype)`:
        n = prod(shape[:-1]) rows, m = shape[-1] columns; Q of the QR of
        ``normal(key, (max(n, m), min(n, m)))`` with its columns' signs
        made those of R's diagonal, transposed when n < m."""
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("orthogonal initializer requires at least a "
                             "2D shape")
        m = shape[-1]
        n = 1
        for d in shape[:-1]:
            n *= d
        z = prng.normal(key, (max(n, m), min(n, m)), dtype, device)
        q, r = torch.linalg.qr(z.float())
        q = (q * torch.sign(torch.diagonal(r))[None, :]).to(dtype)
        if n < m:
            q = q.T
        q = q.reshape(shape)
        return _scalar(self.gain, q) * (_scalar(1.0, q) * q)


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
