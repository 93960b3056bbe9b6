"""Layer base (counterpart of `deeplearning4j_tpu/nn/layers/base.py`): an
`nn.Module` that is also its own configuration, with the JAX layer's
config fields, defaults and serde, JAX-named parameters, and a loader
for the JAX package's per-layer param dicts.

Configuration: every layer carries the JAX base fields (`activation`,
`weight_init`, `bias_init`, `dist`, `l1`/`l2`/`l1_bias`/`l2_bias`,
`updater`, `dropout`, `weight_noise`, `constraints`, `name`,
`remat_policy`, in that order) and then its own `FIELDS`. `to_dict()`
writes them as the JAX `Layer.to_dict` does (:262), through `_encode`
(:52), and `layer_from_dict` (:276) reads either package's dicts through
`_decode` (:82), ignoring keys the class does not have. `updater` None
is the container's `Sgd(1e-3)` default, as in JAX.

Params: a layer allocates its params once their shapes are known, at
construction or in `set_n_in` (n_in inference in `ListBuilder.build`).
They are zeros until `init_weights` draws them (`weight_init` and
`dist` through `common/weights.py`, biases filled with `bias_init`
where the JAX layer fills them) or a loader copies them in.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.common.activations import (
    Activation,
    get_activation,
)
from deeplearning4j_tpu_torch.common.distributions import (
    Distribution,
    distribution_from_dict,
)
from deeplearning4j_tpu_torch.common.losses import LossFunction, get_loss
from deeplearning4j_tpu_torch.common.schedules import (
    Schedule,
    schedule_from_dict,
)
from deeplearning4j_tpu_torch.common.updaters import (
    Updater,
    updater_from_dict,
)
from deeplearning4j_tpu_torch.common.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.nn.conf.constraints import (
    LayerConstraint,
    constraint_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.dropout import (
    IDropout,
    dropout_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.weightnoise import (
    IWeightNoise,
    weight_noise_from_dict,
)

_LAYER_REGISTRY: Dict[str, type] = {}

REMAT_POLICIES = ("none", "full", "dots_saveable")

# (field, default) of every layer, in the JAX dataclass's order
BASE_FIELDS = (
    ("activation", None), ("weight_init", WeightInit.XAVIER),
    ("bias_init", 0.0), ("dist", None), ("l1", 0.0), ("l2", 0.0),
    ("l1_bias", 0.0), ("l2_bias", 0.0), ("updater", None),
    ("dropout", None), ("weight_noise", None), ("constraints", None),
    ("name", None), ("remat_policy", None))


def register_layer(cls):
    _LAYER_REGISTRY[cls.layer_name] = cls
    return cls


def _encode(v):
    if isinstance(v, Activation):
        return {"__activation__": v.name}
    if isinstance(v, LossFunction):
        return {"__loss__": v.name}
    if isinstance(v, Updater):
        return {"__updater__": v.to_dict()}
    if isinstance(v, Distribution):
        return {"__distribution__": v.to_dict()}
    if isinstance(v, Schedule):
        return {"__schedule__": v.to_dict()}
    if isinstance(v, IDropout):
        return {"__dropout__": v.to_dict()}
    if isinstance(v, IWeightNoise):
        return {"__weightnoise__": v.to_dict()}
    if isinstance(v, LayerConstraint):
        return {"__constraint__": v.to_dict()}
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, InputType):
        return {"__inputtype__": v.to_dict()}
    if isinstance(v, Layer):
        return v.to_dict()
    if isinstance(v, (list, tuple)):
        return [_encode(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode(x) for k, x in v.items()}
    return v


_CODECS = (
    ("__activation__", get_activation),
    ("__loss__", get_loss),
    ("__updater__", updater_from_dict),
    ("__distribution__", distribution_from_dict),
    ("__schedule__", schedule_from_dict),
    ("__dropout__", dropout_from_dict),
    ("__weightnoise__", weight_noise_from_dict),
    ("__constraint__", constraint_from_dict),
    ("__inputtype__", InputType.from_dict),
)


def _decode(v):
    if isinstance(v, dict):
        for tag, fn in _CODECS:
            if tag in v:
                return fn(v[tag])
        if v.get("layer_name") in _LAYER_REGISTRY:
            return layer_from_dict(v)
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


class Layer(nn.Module):
    layer_name = "base"
    # the class's own config fields, after BASE_FIELDS: (name, default)
    FIELDS = ()
    # what `activation=None` becomes (the JAX layer's __post_init__)
    DEFAULT_ACTIVATION = None

    def __init__(self, **config):
        super().__init__()
        fields = self.config_fields()
        unknown = set(config) - {f for f, _ in fields}
        if unknown:
            raise TypeError(f"{type(self).__name__} has no config field(s) "
                            f"{sorted(unknown)}")
        for f, default in fields:
            setattr(self, f, config.get(f, default))
        if self.activation is None:
            self.activation = self.DEFAULT_ACTIVATION
        if self.activation is not None:
            self.activation = get_activation(self.activation)
        if self.weight_init is not None:
            self.weight_init = WeightInit(self.weight_init)
        if (self.remat_policy is not None
                and self.remat_policy not in REMAT_POLICIES):
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES} "
                             f"(or None); got {self.remat_policy!r}")

    @classmethod
    def config_fields(cls):
        return BASE_FIELDS + cls.FIELDS

    # ------------------------------------- hooks of `ListBuilder.build`
    def set_n_in(self, input_type: InputType, override: bool = True):
        """Infer n_in-like fields from the incoming InputType (the JAX
        `Layer.set_n_in`), then allocate the params."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        d = {"layer_name": self.layer_name}
        for f, _ in self.config_fields():
            d[f] = _encode(getattr(self, f))
        return d

    def clone(self) -> "Layer":
        """A fresh layer with this one's configuration (not its
        params)."""
        return layer_from_dict(self.to_dict())

    # ------------------------------------------------------------ params
    def jax_param_map(self) -> Dict[str, torch.Tensor]:
        """{JAX param name: this layer's tensor} — the keys the JAX
        layer's `init_params` uses. Layers without params return {}."""
        return {}

    def init_weights(self, gen: torch.Generator):
        """Draw this layer's params from `gen` (none by default)."""

    @torch.no_grad()
    def load_jax_params(self, params: Dict[str, np.ndarray]):
        targets = self.jax_param_map()
        missing = set(targets) - set(params)
        extra = set(params) - set(targets)
        if missing or extra:
            raise KeyError(f"{type(self).__name__}: missing {sorted(missing)}"
                           f", unexpected {sorted(extra)}")
        for name, t in targets.items():
            arr = np.array(params[name])       # writable copy
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{type(self).__name__}.{name}: shape "
                                 f"{arr.shape} != {tuple(t.shape)}")
            t.copy_(torch.as_tensor(arr, dtype=t.dtype))


def layer_from_dict(d: dict) -> Layer:
    d = dict(d)
    cls = _LAYER_REGISTRY[d.pop("layer_name")]
    names = {f for f, _ in cls.config_fields()}
    return cls(**{k: _decode(v) for k, v in d.items() if k in names})


def new_param(shape, device, dtype=torch.float32):
    """A parameter that takes no gradient outside `fit` (the container
    turns gradients on for the train step only, so inference builds no
    autograd graph)."""
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


def init_weight_(layer: Layer, t: torch.Tensor, gen: torch.Generator):
    """Fill the [fan_in, fan_out] weight `t` by `layer.weight_init`, drawn
    on the CPU from `gen` (reproducible across devices)."""
    w = init_weights(gen, t.shape, layer.weight_init, fan_in=t.shape[0],
                     fan_out=t.shape[-1], distribution=layer.dist,
                     dtype=t.dtype)
    with torch.no_grad():
        t.copy_(w)
