"""Gradient normalization and the global max-norm constraint (counterpart
of `deeplearning4j_tpu/optimize/gradients.py` :23-68).

Gradient normalization runs before the updater, on the per-layer dict
``{layer key: {param name: gradient}}`` in the gradients' own dtype
(bf16 under `mixed_bf16`, as JAX normalizes the cast tree's
gradients). A layer's L2 norm is ``sqrt(sum of every leaf's sum of
squares + 1e-8)``. `apply_max_norm_constraint` runs after the update on
every layer's params: each weight-like param (not "b", "beta" or
"gamma", at least 2-D) has its columns (every axis but the last)
rescaled to L2 norm at most `max_norm`.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf.builder import GradientNormalization

_EPS = 1e-8

Tree = Dict[str, Dict[str, torch.Tensor]]


def _layer_l2(layer_grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    sq = sum((g * g).sum() for g in layer_grads.values())
    return torch.sqrt(sq + _EPS)


def _map(fn, tree: Tree) -> Tree:
    return {k: {pk: fn(g) for pk, g in v.items()} for k, v in tree.items()}


def apply_gradient_normalization(grads: Tree, mode, threshold: float) -> Tree:
    """The normalized gradients (a new dict; the inputs are not
    changed)."""
    mode = GradientNormalization(mode)
    if mode == GradientNormalization.NONE:
        return grads
    if mode == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        out = {}
        for k, v in grads.items():
            n = _layer_l2(v)
            out[k] = {pk: g / n for pk, g in v.items()}
        return out
    if mode == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return _map(lambda g: g / torch.sqrt((g * g).sum() + _EPS), grads)
    if mode == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return _map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if mode == GradientNormalization.CLIP_L2_PER_LAYER:
        out = {}
        for k, v in grads.items():
            scale = torch.clamp(threshold / _layer_l2(v), max=1.0)
            out[k] = {pk: g * scale for pk, g in v.items()}
        return out
    if mode == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        def clip_one(g):
            n = torch.sqrt((g * g).sum() + _EPS)
            return g * torch.clamp(threshold / n, max=1.0)
        return _map(clip_one, grads)
    raise ValueError(mode)


def apply_max_norm_constraint(params: Tree, max_norm: float) -> Tree:
    """Every weight-like param with its columns' L2 norms clipped to
    `max_norm` (a new dict)."""

    def constrain(name, p):
        if name in ("b", "beta", "gamma") or p.ndim < 2:
            return p
        dims = tuple(range(p.ndim - 1))
        norms = torch.sqrt((p * p).sum(dim=dims, keepdim=True) + _EPS)
        return p * torch.clamp(max_norm / norms, max=1.0)

    return {lk: {pk: constrain(pk, p) for pk, p in lv.items()}
            for lk, lv in params.items()}
