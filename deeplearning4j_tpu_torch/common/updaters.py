"""Updaters (counterpart of `deeplearning4j_tpu/common/updaters.py`:
`Updater` :39, `Sgd` :72, `Adam` :89, `_lr` :33). The other rules
(AdaMax, Nadam, Nesterovs, AdaGrad, AdaDelta, RmsProp, NoOp) and the
learning-rate schedules are a later slice.

Each updater is a (grad, state, step) -> (update, state) transform over
one tensor; the container subtracts the update from the param. Adam's
arithmetic is the JAX rule's, term for term and in the same order:

    m = β1·m + (1-β1)·g
    v = β2·v + ((1-β2)·g)·g
    upd = (lr·(m / (1-β1ᵗ))) / (sqrt(v / (1-β2ᵗ)) + ε),  t = step + 1

with every scalar rounded to float32 first (JAX's weak-typed Python
floats meet float32 arrays as float32), and `t`, `1-β1ᵗ`, `1-β2ᵗ` and
`lr` computed in float32 as `Adam.apply` does. The fused kernel
(`kernels/fused_adam.py`) takes the same scalars from `adam_scalars`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def _lr(lr, step):
    """The learning rate at `step`. Only constant rates are ported: a
    schedule (anything with `value_at`) raises until schedules come."""
    if hasattr(lr, "value_at") or not isinstance(lr, (int, float,
                                                      np.floating)):
        raise NotImplementedError(
            f"learning-rate schedules are not ported yet; got {lr!r}")
    return lr


def f32(x) -> float:
    """`x` rounded to float32, as a Python float (exact in either
    precision PyTorch then computes a scalar product in)."""
    return float(np.float32(x))


class Updater:
    """Base updater config."""

    name = "base"

    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, grad, state, step):
        """Return (update_to_subtract, new_state)."""
        raise NotImplementedError

    def to_dict(self):
        d = {"updater": self.name}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d


@dataclasses.dataclass(eq=False)
class Sgd(Updater):
    learning_rate: Any = 1e-3
    name = "sgd"

    def apply(self, grad, state, step):
        return f32(_lr(self.learning_rate, step)) * grad, state


@dataclasses.dataclass(eq=False)
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name = "adam"

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def apply(self, grad, state, step):
        lr, bc1, bc2 = adam_scalars(self, step)
        b1, b2 = f32(self.beta1), f32(self.beta2)
        m = b1 * state["m"] + f32(1 - self.beta1) * grad
        v = b2 * state["v"] + f32(1 - self.beta2) * grad * grad
        # divide by tensors: a CUDA division by a host scalar is a
        # multiplication by its reciprocal, one rounding off
        mhat = m / _scalar(bc1, m)
        vhat = v / _scalar(bc2, v)
        upd = lr * mhat / (torch.sqrt(vhat) + f32(self.epsilon))
        return upd, {"m": m, "v": v}


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def adam_scalars(updater: Adam, step):
    """(lr, 1-β1ᵗ, 1-β2ᵗ) as float32 values (Python floats), computed as
    `Adam.apply` computes them: t = float32(step) + 1, then float32
    powers and differences."""
    t = np.float32(step) + np.float32(1.0)
    one = np.float32(1.0)
    bc1 = one - np.power(np.float32(updater.beta1), t)
    bc2 = one - np.power(np.float32(updater.beta2), t)
    lr = np.float32(_lr(updater.learning_rate, step))
    return float(lr), float(bc1), float(bc2)
