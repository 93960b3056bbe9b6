"""Load the JAX package's parameters into a ported net.

`params` is a JAX net's `net.params` converted to numpy, keyed
``{"<layer index>": {name: array}}`` with the JAX names and layouts
(W is [in, out], used as ``x @ W``; transformer blocks use the
prefixed keys attn_Wq/bq/.../Wo/bo, ln1_gamma/beta, ln2_gamma/beta,
ff_W1/b1/W2/b2). Layers without params (positional encoding) have no
entry. Nothing here imports JAX: convert with
``{k: {n: np.asarray(a) for n, a in v.items()} for k, v in net.params.items()}``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def from_jax_params(model, params: Mapping[str, Mapping[str, np.ndarray]]):
    """Copy `params` into `model` (a ported MultiLayerNetwork) in place;
    every layer with params must be covered exactly. Returns `model`."""
    keys = {str(k) for k in params}
    for i, layer in enumerate(model.layers):
        wanted = layer.jax_param_map()
        if not wanted:
            if str(i) in keys and params[str(i)]:
                raise KeyError(f"layer {i} ({type(layer).__name__}) has no "
                               f"params; got {sorted(params[str(i)])}")
            continue
        if str(i) not in keys:
            raise KeyError(f"params carry no entry for layer {i} "
                           f"({type(layer).__name__})")
        layer.load_jax_params(params[str(i)])
    extra = keys - {str(i) for i in range(len(model.layers))}
    if extra:
        raise KeyError(f"params for layers the model lacks: {sorted(extra)}")
    return model


def to_numpy_params(params) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {name: array-like}} -> the same tree of numpy arrays."""
    return {str(k): {n: np.asarray(a) for n, a in v.items()}
            for k, v in params.items()}
