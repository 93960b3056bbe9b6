"""Activation functions the ported path uses (counterpart of
`deeplearning4j_tpu/common/activations.py`; the rest of the catalog is
a later slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _identity(x):
    return x


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"identity": _identity, "softmax": _softmax, "gelu": _gelu}


def get_activation(name):
    if callable(name):
        return name
    fn = ACTIVATIONS.get(str(name).lower())
    if fn is None:
        raise ValueError(f"activation {name!r} is not ported yet; "
                         f"known: {sorted(ACTIVATIONS)}")
    return fn
