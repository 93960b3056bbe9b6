"""Parameter constraints (counterpart of
`deeplearning4j_tpu/nn/conf/constraints.py` :38-130): the four
constraints, their serde and their projections, which the container
applies to a layer's params after every update.

Norms reduce over every axis but the last (the output axis), as
``sqrt(sum(w * w) + 1e-8)``; a 1-D param's norm is over its one axis.
By default only weight-like params are constrained: a bias-like name
(`is_bias_param`) or "gamma" passes unless `apply_to_bias`. The names
are matched exactly as JAX matches them, so a transformer block's
prefixed "attn_bq" or "ln1_gamma" counts as weight-like there and here.
"""

from __future__ import annotations

import dataclasses

import torch

_CONSTRAINT_REGISTRY = {}
_EPS = 1e-8


def is_bias_param(name: str) -> bool:
    """Bias-like param names: "b", names ending in "b" or starting with
    "b", and BN's "beta" (the JAX `is_bias_param`)."""
    return name == "beta" or name.endswith("b") or name.startswith("b")


def register_constraint(cls):
    _CONSTRAINT_REGISTRY[cls.kind] = cls
    return cls


class LayerConstraint:
    kind = "base"
    apply_to_bias: bool = False

    def apply(self, w):
        raise NotImplementedError

    def apply_params(self, params: dict) -> dict:
        out = {}
        for name, w in params.items():
            is_bias = is_bias_param(name) or name == "gamma"
            if (is_bias and not self.apply_to_bias) or w.ndim < 1:
                out[name] = w
            else:
                out[name] = self.apply(w)
        return out

    def _norms(self, w):
        dims = tuple(range(w.ndim - 1)) if w.ndim > 1 else (0,)
        return torch.sqrt((w * w).sum(dim=dims, keepdim=True) + _EPS)

    def to_dict(self):
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()


def constraint_from_dict(d):
    d = dict(d)
    return _CONSTRAINT_REGISTRY[d.pop("kind")](**d)


@register_constraint
@dataclasses.dataclass(eq=False)
class MaxNormConstraint(LayerConstraint):
    kind = "max_norm"
    max_norm: float = 2.0
    apply_to_bias: bool = False

    def apply(self, w):
        return w * torch.clamp(self.max_norm / self._norms(w), max=1.0)


@register_constraint
@dataclasses.dataclass(eq=False)
class MinMaxNormConstraint(LayerConstraint):
    kind = "min_max_norm"
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0
    apply_to_bias: bool = False

    def apply(self, w):
        n = self._norms(w)
        target = torch.clamp(n, self.min_norm, self.max_norm)
        return w * (self.rate * (target / n) + (1.0 - self.rate))


@register_constraint
@dataclasses.dataclass(eq=False)
class UnitNormConstraint(LayerConstraint):
    kind = "unit_norm"
    apply_to_bias: bool = False

    def apply(self, w):
        return w / self._norms(w)


@register_constraint
@dataclasses.dataclass(eq=False)
class NonNegativeConstraint(LayerConstraint):
    kind = "non_negative"
    apply_to_bias: bool = True

    def apply(self, w):
        return torch.clamp(w, min=0.0)
