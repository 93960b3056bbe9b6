"""Minimal layer base (counterpart of `deeplearning4j_tpu/nn/layers/base.py`):
an `nn.Module` with JAX-named parameters, a loader for the JAX
package's per-layer param dicts, and the per-layer training config the
container reads: `updater` (None: the container's `Sgd(1e-3)` default,
as in JAX) and the l1/l2 coefficients (only zero is ported). `name` is
the JAX layer's optional name, used in messages. `weight_init` and
`dist` choose how `init_weights` draws the layer's weight matrices
(`common/weights.py`; Xavier by default, as the zoo configures it)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.common.weights import WeightInit, init_weights


class Layer(nn.Module):
    name = None
    updater = None
    l1 = l2 = l1_bias = l2_bias = 0.0
    weight_init = WeightInit.XAVIER
    dist = None

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


def init_weight_(layer: Layer, t: torch.Tensor, gen: torch.Generator):
    """Fill the [fan_in, fan_out] weight `t` by `layer.weight_init`, drawn
    on the CPU from `gen` (reproducible across devices)."""
    w = init_weights(gen, t.shape, layer.weight_init, fan_in=t.shape[0],
                     fan_out=t.shape[-1], distribution=layer.dist,
                     dtype=t.dtype)
    with torch.no_grad():
        t.copy_(w)
