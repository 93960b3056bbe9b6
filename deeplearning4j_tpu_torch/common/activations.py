"""Activation functions (counterpart of
`deeplearning4j_tpu/common/activations.py`: the functions :24-131,
`Activation` :99, `get_activation` :131).

Each activation is a plain function on tensors, with the JAX package's
formula (hardsigmoid is DL4J's clip(0.2x + 0.5, 0, 1), not PyTorch's
x/6 + 1/2; gelu is jax.nn.gelu's default tanh approximation; softplus is
log(1 + eˣ) with no linear cut-over). Clips are `clip` below: a maximum
then a minimum, as `jnp.clip` is, so a value exactly at a bound takes
half the gradient, as in JAX (`torch.clamp` passes all of it). Names
are the serialization surface; "leakyrelu:0.3" sets leakyrelu's alpha.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip(x, lo=None, hi=None):
    """`jnp.clip`: max(x, lo), then min(., hi); torch.maximum/minimum
    split the gradient of a tie evenly, as JAX's do."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _identity(x):
    return x


def _cube(x):
    return x ** 3


def _hardsigmoid(x):
    return clip(0.2 * x + 0.5, 0.0, 1.0)


def _hardtanh(x):
    return clip(x, -1.0, 1.0)


def _leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def _rationaltanh(x):
    # 1.7159 * tanh(2x/3) approximated rationally (nd4j
    # ActivationRationalTanh: a cheap tanh surrogate)
    a = (2.0 * x / 3.0).abs()
    approx = 1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a ** 4)
    return 1.7159 * torch.sign(x) * approx


def _rectifiedtanh(x):
    return clip(torch.tanh(x), 0.0)


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _softsign(x):
    return x / (1.0 + x.abs())


def _swish(x):
    return x * torch.sigmoid(x)


def _mish(x):
    return x * torch.tanh(_softplus(x))


def _relu6(x):
    return clip(x, 0.0, 6.0)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "identity": _identity,
    "cube": _cube,
    "elu": F.elu,
    "gelu": _gelu,
    "hardsigmoid": _hardsigmoid,
    "hardtanh": _hardtanh,
    "leakyrelu": _leakyrelu,
    "mish": _mish,
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": _rectifiedtanh,
    "relu": F.relu,
    "relu6": _relu6,
    "rrelu": _leakyrelu,  # deterministic (test-mode) RReLU: leaky, mean slope
    "selu": F.selu,
    "sigmoid": torch.sigmoid,
    "softmax": _softmax,
    "softplus": _softplus,
    "softsign": _softsign,
    "swish": _swish,
    "tanh": torch.tanh,
}


class Activation:
    """String-keyed activation, serializable by name."""

    def __init__(self, name: str):
        name = name.lower()
        base, _, param = name.partition(":")
        if base not in ACTIVATIONS:
            raise ValueError(f"Unknown activation: {name!r}. Known: "
                             f"{sorted(ACTIVATIONS)}")
        self.name = name
        if param and base == "leakyrelu":
            alpha = float(param)
            self.fn = lambda x: _leakyrelu(x, alpha)
        elif param:
            raise ValueError(f"Activation {base!r} takes no parameter")
        else:
            self.fn = ACTIVATIONS[base]

    def __call__(self, x):
        return self.fn(x)

    def __repr__(self):
        return f"Activation({self.name})"

    def __eq__(self, other):
        return isinstance(other, Activation) and other.name == self.name

    def __hash__(self):
        return hash(("Activation", self.name))


def get_activation(act) -> Activation:
    if isinstance(act, Activation):
        return act
    if isinstance(act, str):
        return Activation(act)
    raise TypeError(f"Cannot interpret {act!r} as an activation")
