"""Weight initialization schemes (counterpart of
`deeplearning4j_tpu/common/weights.py`: `WeightInit` :24,
`init_weights` :49).

`fan_in`/`fan_out` follow the reference: for a dense [n_in, n_out]
kernel fan_in = n_in and fan_out = n_out. Draws take a threefry key
(`common/prng.py`) and are JAX's: ``std * normal(key, shape, dtype)``
or ``uniform(key, shape, dtype, -a, a)``, so a key gives the JAX
package's weights (the bits exact, the normal's erfinv within about
4e-6 relative). They are made on `device`: on a CUDA device the bits
come from the threefry kernel.
"""

from __future__ import annotations

import math
from enum import Enum

import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.distributions import Distribution


class WeightInit(str, Enum):
    ZERO = "zero"
    ONES = "ones"
    IDENTITY = "identity"
    DISTRIBUTION = "distribution"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    UNIFORM = "uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    SELU = "selu"  # == lecun normal, kept for config parity
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"


# scheme -> (normal or uniform, scale as a function of (fan_in, fan_out)):
# normal draws std * N(0, 1), uniform draws U(-a, a)
_SCALED = {
    WeightInit.SIGMOID_UNIFORM: ("uniform",
                                 lambda i, o: 4.0 * math.sqrt(6.0 / (i + o))),
    WeightInit.UNIFORM: ("uniform", lambda i, o: 1.0 / math.sqrt(i)),
    WeightInit.LECUN_NORMAL: ("normal", lambda i, o: math.sqrt(1.0 / i)),
    WeightInit.SELU: ("normal", lambda i, o: math.sqrt(1.0 / i)),
    WeightInit.LECUN_UNIFORM: ("uniform", lambda i, o: math.sqrt(3.0 / i)),
    WeightInit.NORMAL: ("normal", lambda i, o: math.sqrt(1.0 / i)),
    WeightInit.XAVIER: ("normal", lambda i, o: math.sqrt(2.0 / (i + o))),
    WeightInit.XAVIER_UNIFORM: ("uniform",
                                lambda i, o: math.sqrt(6.0 / (i + o))),
    WeightInit.XAVIER_FAN_IN: ("normal", lambda i, o: math.sqrt(1.0 / i)),
    WeightInit.XAVIER_LEGACY: ("normal",
                               lambda i, o: math.sqrt(1.0 / (i + o))),
    WeightInit.RELU: ("normal", lambda i, o: math.sqrt(2.0 / i)),
    WeightInit.RELU_UNIFORM: ("uniform", lambda i, o: math.sqrt(6.0 / i)),
    WeightInit.VAR_SCALING_NORMAL_FAN_IN: ("normal",
                                           lambda i, o: math.sqrt(1.0 / i)),
    WeightInit.VAR_SCALING_NORMAL_FAN_OUT: ("normal",
                                            lambda i, o: math.sqrt(1.0 / o)),
    WeightInit.VAR_SCALING_NORMAL_FAN_AVG: (
        "normal", lambda i, o: math.sqrt(2.0 / (i + o))),
    WeightInit.VAR_SCALING_UNIFORM_FAN_IN: ("uniform",
                                            lambda i, o: math.sqrt(3.0 / i)),
    WeightInit.VAR_SCALING_UNIFORM_FAN_OUT: (
        "uniform", lambda i, o: math.sqrt(3.0 / o)),
    WeightInit.VAR_SCALING_UNIFORM_FAN_AVG: (
        "uniform", lambda i, o: math.sqrt(6.0 / (i + o))),
}


def init_weights(key, shape, weight_init, fan_in: float, fan_out: float,
                 distribution: Distribution | None = None,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """A [shape] tensor on `device` initialised by `weight_init` under
    the threefry `key`, as the JAX `init_weights` (:49) draws it."""
    wi = WeightInit(weight_init)
    shape = tuple(shape)
    if wi == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=device)
    if wi == WeightInit.ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if wi == WeightInit.IDENTITY:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2d shape")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if wi == WeightInit.DISTRIBUTION:
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a distribution")
        return distribution.sample(key, shape, dtype, device)
    kind, scale = _SCALED[wi]
    a = scale(fan_in, fan_out)
    if kind == "normal":
        return a * prng.normal(key, shape, dtype, device)
    return prng.uniform(key, shape, dtype, -a, a, device)
