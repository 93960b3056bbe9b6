"""Parameter constraints as configuration (counterpart of
`deeplearning4j_tpu/nn/conf/constraints.py`): the four constraints with
their serde. The projections are not ported yet (ROADMAP Queue 1
item 5); they act only after an update, so the container refuses them
in `fit`."""

from __future__ import annotations

import dataclasses

_CONSTRAINT_REGISTRY = {}


def register_constraint(cls):
    _CONSTRAINT_REGISTRY[cls.kind] = cls
    return cls


class LayerConstraint:
    kind = "base"

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


@register_constraint
@dataclasses.dataclass(eq=False)
class MinMaxNormConstraint(LayerConstraint):
    kind = "min_max_norm"
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0
    apply_to_bias: bool = False


@register_constraint
@dataclasses.dataclass(eq=False)
class UnitNormConstraint(LayerConstraint):
    kind = "unit_norm"
    apply_to_bias: bool = False


@register_constraint
@dataclasses.dataclass(eq=False)
class NonNegativeConstraint(LayerConstraint):
    kind = "non_negative"
    apply_to_bias: bool = True
