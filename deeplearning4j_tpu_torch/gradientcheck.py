"""Finite-difference gradient checker: the port's correctness oracle
(counterpart of `deeplearning4j_tpu/gradientcheck.py`; reference
`gradientcheck/GradientCheckUtil.java:112,207-222`).

Each sampled coordinate of each param is moved by +-epsilon in float64,
and the central difference (f(p+e) - f(p-e)) / 2e is held against the
autograd gradient with a maximum relative error. A wrong forward gives
a gradient that is consistent but wrong; a non-differentiable or
unstable forward shows up as a mismatch.

Like every entry point of the port it runs on the card unless the
caller asks for the CPU. The check is a float64 oracle: on the card a
float64 net runs its dense and convolution layers through cuBLAS and
cuDNN in float64, but the hand-written kernels run float32 and bfloat16
only, and their wrappers raise on a float64 CUDA tensor. So a net that
reaches LayerNorm or flash attention is checked with `device="cpu"`:
there every wrapper takes its plain PyTorch version, which computes in
the inputs' dtype, as the JAX checker runs under `enable_x64` on the
CPU.

Sampling is JAX's: the param tree is walked in JAX's flatten order
(sorted keys), and each tensor draws up to `max_params_per_array`
coordinates from one `np.random.default_rng(seed)` stream, so both
packages check the same coordinates of the same net.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, path=()) -> List[Tuple[tuple, object]]:
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def _rebuild(pairs):
    out: dict = {}
    for path, v in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def check_gradients_fn(loss_fn: Callable[[Dict], torch.Tensor], params: Dict,
                       epsilon: float = 1e-6, max_rel_error: float = 1e-5,
                       min_abs_error: float = 1e-8,
                       max_params_per_array: int = 64, seed: int = 0,
                       verbose: bool = False, device="cuda"):
    """Check the autograd gradients of `loss_fn(params)` (a scalar; params
    a tree of nested dicts of arrays or tensors) against central finite
    differences in float64 on `device`. Returns (ok, max_rel_err,
    failures), each failure (tensor index, coordinate, analytic,
    numeric, relative error)."""
    pairs = [(path, torch.as_tensor(np.asarray(
        v.detach().cpu() if isinstance(v, torch.Tensor) else v),
        dtype=torch.float64, device=device))
        for path, v in _leaves(params)]
    leaves = [v.clone().requires_grad_(True) for _, v in pairs]
    loss = loss_fn(_rebuild([(p, l) for (p, _), l in zip(pairs, leaves)]))
    grads = torch.autograd.grad(loss.to(torch.float64), leaves,
                                allow_unused=True)
    rng = np.random.default_rng(seed)
    failures, worst = [], 0.0
    with torch.no_grad():
        for ti, ((path, arr), g) in enumerate(zip(pairs, grads)):
            g = (torch.zeros_like(arr) if g is None else g).cpu().numpy()
            shape = tuple(arr.shape)
            size = int(np.prod(shape)) if shape else 1
            idxs = rng.choice(size, size=min(size, max_params_per_array),
                              replace=False)
            host = arr.cpu().numpy()
            for flat_idx in idxs:
                idx = np.unravel_index(int(flat_idx), shape) if shape else ()
                orig = float(host[idx])

                def eval_at(v):
                    pert = host.copy()
                    pert[idx] = v
                    tree = [(p, a) for p, a in pairs]
                    tree[ti] = (path, torch.as_tensor(pert, device=device))
                    return float(loss_fn(_rebuild(tree)))

                numeric = (eval_at(orig + epsilon)
                           - eval_at(orig - epsilon)) / (2 * epsilon)
                analytic = float(g[idx])
                denom = max(abs(numeric), abs(analytic))
                abs_err = abs(numeric - analytic)
                rel = abs_err / denom if denom > 0 else 0.0
                if abs_err > min_abs_error and rel > max_rel_error:
                    failures.append((ti, idx, analytic, numeric, rel))
                worst = max(worst, rel if abs_err > min_abs_error else 0.0)
                if verbose:
                    print(f"tensor {ti} idx {idx}: analytic {analytic:.3e} "
                          f"numeric {numeric:.3e} rel {rel:.3e}")
    return len(failures) == 0, worst, failures


def _check_dropout(layers):
    for layer in layers:
        d = getattr(layer, "dropout", None)
        if d is not None and (not isinstance(d, (int, float)) or d < 1.0):
            raise ValueError("Gradient checks require dropout disabled "
                             "(reference GradientCheckUtil precondition)")


def _float64_twin(model, device):
    """A copy of `model` with every floating param and buffer in float64
    on `device`, under an all-float64 dtype policy."""
    from deeplearning4j_tpu_torch.nd.dtype import DataTypePolicy
    twin = copy.deepcopy(model)
    nn.Module.to(twin, torch.device(device), torch.float64)
    twin.device = torch.device(device)
    twin.dtype = DataTypePolicy(torch.float64, torch.float64, torch.float64)
    return twin


def _net_loss(twin, call):
    """loss_fn(tree) for `check_gradients_fn`: `call()` (the twin's
    `_loss_fn` on the batch) with the tree's tensors installed for the
    twin's params ({layer key: {JAX name: tensor}})."""
    qual = {id(p): n for n, p in twin.named_parameters()}
    names = {(key, pn): qual[id(p)] for key, layer in twin.keyed()
             for pn, p in layer.jax_param_map().items()}

    def loss_fn(tree):
        installed = {names[(key, pn)]: t for key, lp in tree.items()
                     for pn, t in lp.items()}
        return torch.func.functional_call(twin, installed, (call,),
                                          strict=False)
    return loss_fn


def _params(twin):
    return {key: dict(layer.jax_param_map()) for key, layer in twin.keyed()
            if layer.jax_param_map()}


def check_model_gradients(model, features, labels, epsilon: float = 1e-6,
                          max_rel_error: float = 1e-4,
                          max_params_per_array: int = 32, features_mask=None,
                          labels_mask=None, seed: int = 0, device="cuda"):
    """Gradient-check a MultiLayerNetwork on one minibatch (reference
    `GradientCheckUtil.checkGradients(mln, ...)`), in float64 on a copy
    of the net; the net itself is untouched. Dropout must be off."""
    _check_dropout(model.layers)
    twin = _float64_twin(model, device)
    x = twin._features(np.asarray(features, dtype=np.float64))
    y = twin._labels(np.asarray(labels, dtype=np.float64))
    fm, lm = twin._mask(features_mask), twin._mask(labels_mask)
    return check_gradients_fn(
        _net_loss(twin, lambda: twin._loss_fn(x, y, fm, lm, train=False)),
        _params(twin), epsilon=epsilon, max_rel_error=max_rel_error,
        max_params_per_array=max_params_per_array, seed=seed, device=device)


def check_graph_gradients(model, inputs, labels, epsilon: float = 1e-6,
                          max_rel_error: float = 1e-4,
                          max_params_per_array: int = 32, seed: int = 0,
                          device="cuda"):
    """Gradient-check a ComputationGraph on one minibatch (reference
    `GradientCheckUtil.checkGradients(graph, ...)`), as
    `check_model_gradients`."""
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    labels = list(labels) if isinstance(labels, (list, tuple)) else [labels]
    _check_dropout(model.layers)
    twin = _float64_twin(model, device)
    xs = twin._features([np.asarray(x, dtype=np.float64) for x in inputs])
    ys = twin._labels([np.asarray(y, dtype=np.float64) for y in labels])
    return check_gradients_fn(
        _net_loss(twin, lambda: twin._loss_fn(xs, ys, train=False)),
        _params(twin), epsilon=epsilon, max_rel_error=max_rel_error,
        max_params_per_array=max_params_per_array, seed=seed, device=device)
