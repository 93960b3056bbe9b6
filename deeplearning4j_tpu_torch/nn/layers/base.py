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
They are zeros until `init_weights(key)` draws them as the JAX
`init_params(key)` does (the same threefry splits and folds, `weight_init`
and `dist` through `common/weights.py`, biases filled with `bias_init`
where the JAX layer fills them) or a loader copies them in.

State (the JAX `init_state`): running values that are not trained
(BatchNormalization's mean and var) are module buffers, so they move
with `.to(device)`; `state_map()` gives them under their JAX names and
`load_jax_state` copies the JAX net's `net_state` entry in. A stateful
layer's `forward` takes `new_state=`, a dict it fills in training with
the values the container writes once the step's update is done.

Training hooks (the JAX `Layer` :186-259): a layer's `forward(x, *,
train, rng, mask)` takes the threefry key `rng` (`common/prng.py`) the
container folds for it and the [B, T] padding mask; `forward_mask`
propagates the mask to the next layer; `apply_input_dropout` applies
`dropout` (an `IDropout`, or a float RETAIN probability: >= 1 is a
no-op) while training; `apply_weight_noise`, `apply_constraints` and
`regularization_score` act on a `{JAX name: tensor}` dict, as the JAX
hooks act on the layer's param dict.
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
from deeplearning4j_tpu_torch.kernels.dropout import dropout
from deeplearning4j_tpu_torch.nn.conf.constraints import (
    LayerConstraint,
    constraint_from_dict,
    is_bias_param,
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
    # a forward that leaves an "aux_loss" in its `new_state` dict in
    # training (MixtureOfExperts), which the container's loss pops
    emits_aux_loss = False

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

    # --------------------------------------------------- training hooks
    def forward_mask(self, mask):
        """The mask the next layer sees (the JAX `forward_mask`):
        unchanged by default."""
        return mask

    def apply_input_dropout(self, x, train: bool, key):
        """`dropout` on x while training (the JAX `apply_input_dropout`,
        :192-201): an `IDropout` applies itself; a float is the retain
        probability of plain inverted dropout."""
        if not train or self.dropout is None or key is None:
            return x
        if isinstance(self.dropout, IDropout):
            return self.dropout.apply(key, x)
        return dropout(x, key, float(self.dropout))

    def apply_weight_noise(self, params: Dict[str, torch.Tensor],
                           train: bool, key):
        """The params the forward uses while training (:226-230)."""
        if not train or self.weight_noise is None or key is None \
                or not params:
            return params
        return self.weight_noise.apply_params(key, params)

    def apply_constraints(self, params: Dict[str, torch.Tensor]):
        """The params after this layer's constraints (:232-240)."""
        if not self.constraints or not params:
            return params
        cs = (self.constraints if isinstance(self.constraints, (list, tuple))
              else [self.constraints])
        for c in cs:
            params = c.apply_params(params)
        return params

    def regularization_score(self, params: Dict[str, torch.Tensor]):
        """The l1/l2 penalty of these params (:242-259): weight-like ones
        take l1/l2, bias-like ones l1_bias/l2_bias, "gamma", "mean" and
        "var" none; ``l1 * sum|w| + 0.5 * l2 * sum(w^2)``, summed in the
        params' dtype."""
        score = 0.0
        for name, value in params.items():
            if name in ("gamma", "mean", "var"):
                continue
            if is_bias_param(name):
                l1c, l2c = self.l1_bias, self.l2_bias
            else:
                l1c, l2c = self.l1, self.l2
            if l1c:
                # |w| whose gradient at 0 is +1, as JAX's abs has it
                # (torch's abs has 0 there, and zero-initialised biases
                # start exactly at 0)
                score = score + l1c * torch.where(value >= 0, value,
                                                  -value).sum()
            if l2c:
                score = score + 0.5 * l2c * (value * value).sum()
        return score

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

    def param_slots(self):
        """{JAX param name: (module, attribute)}: where each tensor of
        `jax_param_map()` is registered (a sublayer's for a prefixed
        name), the address `nd.quant.weight` reads it under."""
        where = {}
        for mod in self.modules():
            for attr, t in mod._parameters.items():
                if t is not None:
                    where[id(t)] = (mod, attr)
        return {name: where[id(t)]
                for name, t in self.jax_param_map().items()}

    def quantizable_weights(self):
        """JAX keys of the params that serve as per-output-channel int8
        (`nd.quant.quantize_net_params`): the matmul weights a layer
        reads through `nd.quant.matmul`. None by default; biases and
        norm gains stay floating."""
        return ()

    def adapter_weights(self):
        """JAX keys of the params that may carry a LoRA low-rank delta
        (`tenancy.lora`): 2-D matmul weights read through
        `nd.quant.matmul`, where a `LoRAWeight` composes at the seam.
        None by default; embedding tables stay out (their gather has no
        matmul seam)."""
        return ()

    def init_weights(self, key):
        """Draw this layer's params under the threefry `key`, as the JAX
        layer's `init_params(key)` (none by default)."""

    def state_map(self) -> Dict[str, torch.Tensor]:
        """{JAX state name: buffer}: the values the JAX layer keeps in
        `net_state` (its `init_state` keys); {} for a stateless layer."""
        return {}

    @torch.no_grad()
    def load_jax_state(self, state: Dict[str, np.ndarray]):
        _copy_named(self, self.state_map(), state, "state")

    @torch.no_grad()
    def load_jax_params(self, params: Dict[str, np.ndarray]):
        _copy_named(self, self.jax_param_map(), params, "params")


def _copy_named(layer: Layer, targets: Dict[str, torch.Tensor],
                arrays: Dict[str, np.ndarray], what: str):
    """Copy `arrays` into `targets` by JAX name; the names must match
    exactly, and each array's shape its tensor's (the JAX layout: a
    tensor whose memory is laid out otherwise is still indexed as JAX
    indexes it, so the copy keeps its strides)."""
    missing = set(targets) - set(arrays)
    extra = set(arrays) - set(targets)
    if missing or extra:
        raise KeyError(f"{type(layer).__name__} {what}: missing "
                       f"{sorted(missing)}, unexpected {sorted(extra)}")
    for name, t in targets.items():
        arr = np.array(arrays[name])       # writable copy
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{type(layer).__name__}.{name}: shape "
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


def init_weight_(layer: Layer, t: torch.Tensor, key, fan_in=None,
                 fan_out=None):
    """Fill the weight `t` by `layer.weight_init` under the threefry
    `key`, drawn on t's device. The fans default to a dense [fan_in,
    fan_out] kernel's; a convolution passes its own."""
    w = init_weights(key, t.shape, layer.weight_init,
                     fan_in=t.shape[0] if fan_in is None else fan_in,
                     fan_out=t.shape[-1] if fan_out is None else fan_out,
                     distribution=layer.dist, dtype=t.dtype, device=t.device)
    with torch.no_grad():
        t.copy_(w)
