"""Carry a JAX net's parameters and training state into a ported net,
and back, inside one process (the tests, which load both packages).
Between processes, and onto a machine without JAX, the carrier is the
model zip (`util/serializer.py`).

`params` is a JAX net's `net.params` converted to numpy, keyed
``{"<layer index>": {name: array}}`` with the JAX names and layouts
(W is [in, out], used as ``x @ W``; transformer blocks use the
prefixed keys attn_Wq/bq/.../Wo/bo, ln1_gamma/beta, ln2_gamma/beta,
ff_W1/b1/W2/b2). Layers without params (positional encoding) have no
entry. Nothing here imports JAX: convert with `to_numpy_params(net.params)`.

The updater state is the JAX net's `updater_state` in numpy, keyed
``{"<layer>": {name: {"m": array, "v": array}}}`` for Adam (``{}`` per
name for Sgd); with it and `iteration_count` a JAX net trained k steps
resumes in the port on the same trajectory.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
    model.params_changed()
    return model


def from_jax_updater_state(model, upd_state, iteration: int):
    """Copy the JAX net's `updater_state` (numpy) into `model` in place
    and set its `iteration_count` (the updater's step) to `iteration`.
    Keys and shapes must match the model's state exactly. Returns
    `model`."""
    if set(map(str, upd_state)) != set(model.updater_state):
        raise KeyError(f"updater state layers {sorted(map(str, upd_state))}"
                       f" != the model's {sorted(model.updater_state)}")
    for lk, lstate in model.updater_state.items():
        src = upd_state[lk]
        if set(src) != set(lstate):
            raise KeyError(f"layer {lk}: updater state params "
                           f"{sorted(src)} != {sorted(lstate)}")
        for pk, st in lstate.items():
            if set(src[pk]) != set(st):
                raise KeyError(f"layer {lk} {pk}: state keys "
                               f"{sorted(src[pk])} != {sorted(st)}")
            for sk, t in st.items():
                arr = np.array(src[pk][sk])
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"layer {lk} {pk}.{sk}: shape "
                                     f"{arr.shape} != {tuple(t.shape)}")
                t.copy_(torch.as_tensor(arr, dtype=t.dtype))
    model.iteration_count = int(iteration)
    return model


def to_jax_params(model) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's params as the JAX net's numpy tree."""
    return {str(i): {n: t.detach().cpu().numpy().copy()
                     for n, t in layer.jax_param_map().items()}
            for i, layer in enumerate(model.layers)
            if layer.jax_param_map()}


def to_jax_updater_state(model):
    """The model's updater state as the JAX net's numpy tree."""
    return {lk: {pk: {sk: t.detach().cpu().numpy().copy()
                      for sk, t in st.items()}
                 for pk, st in lstate.items()}
            for lk, lstate in model.updater_state.items()}


def to_numpy_params(params) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {name: array-like}} -> the same tree of numpy arrays."""
    return {str(k): {n: np.asarray(a) for n, a in v.items()}
            for k, v in params.items()}
