"""Minimal layer base (counterpart of `deeplearning4j_tpu/nn/layers/base.py`):
an `nn.Module` with JAX-named parameters, a loader for the JAX
package's per-layer param dicts, and the per-layer training config the
container reads: `updater` (None: the container's `Sgd(1e-3)` default,
as in JAX) and the l1/l2 coefficients (only zero is ported). `name` is
the JAX layer's optional name, used in messages."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


class Layer(nn.Module):
    name = None
    updater = None
    l1 = l2 = l1_bias = l2_bias = 0.0

    def jax_param_map(self) -> Dict[str, torch.Tensor]:
        """{JAX param name: this layer's tensor} — the keys the JAX
        layer's `init_params` uses. Layers without params return {}."""
        return {}

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


def new_param(shape, device, dtype=torch.float32):
    """A parameter that takes no gradient outside `fit` (the container
    turns gradients on for the train step only, so inference builds no
    autograd graph)."""
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                        requires_grad=False)


def xavier_(t: torch.Tensor, gen: torch.Generator):
    """Xavier-normal init drawn on the CPU from `gen` (reproducible across
    devices), copied into `t`."""
    fan_in, fan_out = t.shape[0], t.shape[-1]
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        t.copy_(torch.randn(tuple(t.shape), generator=gen) * std)
