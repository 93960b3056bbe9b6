"""Carry a JAX net's parameters and training state into a ported net,
and back, inside one process (the tests, which load both packages).
Between processes, and onto a machine without JAX, the carrier is the
model zip (`util/serializer.py`).

The model is a ported MultiLayerNetwork or ComputationGraph; its
trees are keyed as the JAX net's, by `model.layer_keys` ("<layer
index>" for a layer list, the node name in a graph). `params` is a JAX
net's `net.params` converted to numpy, ``{key: {name: array}}`` with the
JAX names and layouts (a dense W is [in, out], used as ``x @ W``; a
convolution's W is HWIO; transformer blocks use the prefixed keys
attn_Wq/bq/.../Wo/bo, ln1_gamma/beta, ln2_gamma/beta, ff_W1/b1/W2/b2).
Layers without params (positional encoding, pooling) have no entry.
The port's tensors have the JAX shapes (a convolution's W is laid out
OHWI in memory, but indexed HWIO), so every array crosses as it is.
Nothing here imports JAX: convert with `to_numpy_params(net.params)`.

The updater state is the JAX net's `updater_state` in numpy, keyed
``{key: {name: {"m": array, "v": array}}}`` for Adam (``{"v"}`` for
Nesterovs, ``{}`` per name for Sgd); with it and `iteration_count` a
JAX net trained k steps resumes in the port on the same trajectory.
The running state (`from_jax_state`) is the JAX net's `net_state`,
``{key: {"mean": array, "var": array}}`` for BatchNormalization.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _load_tree(model, tree, what, wanted_of, load):
    """Copy {key: {name: array}} into every layer whose `wanted_of` map
    is not empty; the keys must cover those layers exactly."""
    keys = {str(k) for k in tree}
    for key, layer in model.keyed():
        if not wanted_of(layer):
            if key in keys and tree[key]:
                raise KeyError(f"layer {key} ({type(layer).__name__}) has no "
                               f"{what}; got {sorted(tree[key])}")
            continue
        if key not in keys:
            raise KeyError(f"{what} carry no entry for layer {key} "
                           f"({type(layer).__name__})")
        load(layer, tree[key])
    extra = keys - set(model.layer_keys)
    if extra:
        raise KeyError(f"{what} for layers the model lacks: {sorted(extra)}")


def from_jax_params(model, params: Mapping[str, Mapping[str, np.ndarray]]):
    """Copy `params` into `model` in place; every layer with params must
    be covered exactly. Returns `model`."""
    _load_tree(model, params, "params", lambda l: l.jax_param_map(),
               lambda l, p: l.load_jax_params(p))
    model.params_changed()
    return model


def from_jax_state(model, state: Mapping[str, Mapping[str, np.ndarray]]):
    """Copy the JAX net's `net_state` (numpy) into `model`'s running
    state in place; every stateful layer must be covered exactly.
    Returns `model`."""
    _load_tree(model, state, "state", lambda l: l.state_map(),
               lambda l, s: l.load_jax_state(s))
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


def _numpy(t) -> np.ndarray:
    """A C-order host copy, indexed as the tensor is (JAX's layout)."""
    return np.array(t.detach().cpu().numpy(), order="C", copy=True)


def to_jax_params(model) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's params as the JAX net's numpy tree."""
    return {key: {n: _numpy(t) for n, t in layer.jax_param_map().items()}
            for key, layer in model.keyed() if layer.jax_param_map()}


def to_jax_state(model) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's running state as the JAX net's `net_state` in
    numpy."""
    return {key: {n: _numpy(t) for n, t in st.items()}
            for key, st in model.net_state.items()}


def to_jax_updater_state(model):
    """The model's updater state as the JAX net's numpy tree."""
    return {lk: {pk: {sk: _numpy(t) for sk, t in st.items()}
                 for pk, st in lstate.items()}
            for lk, lstate in model.updater_state.items()}


def to_numpy_params(params) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer: {name: array-like}} -> the same tree of numpy arrays."""
    return {str(k): {n: np.asarray(a) for n, a in v.items()}
            for k, v in params.items()}
