"""Updaters (counterpart of `deeplearning4j_tpu/common/updaters.py`:
`_lr` :33, `Updater` :39, `Sgd` :72, `NoOp` :81, `Adam` :89, `AdaMax`
:110, `Nadam` :129, `Nesterovs` :151, `AdaGrad` :170, `AdaDelta` :185,
`RmsProp` :201, `get_updater` :222, `updater_from_dict` :233).

Each updater is a (grad, state, step) -> (update, state) transform over
one tensor; the container subtracts the update from the param. The
arithmetic is the JAX rule's, term for term and in the same order, with
every scalar rounded to float32 first (JAX's weak-typed Python floats
meet float32 arrays as float32) and scalar-only subexpressions (`t`,
`1-β1ᵗ`, a scheduled lr) computed in numpy float32 as JAX computes them
on float32 scalars. Adam, for one:

    m = β1·m + (1-β1)·g
    v = β2·v + ((1-β2)·g)·g
    upd = (lr·(m / (1-β1ᵗ))) / (sqrt(v / (1-β2ᵗ)) + ε),  t = step + 1

A division by a scalar divides by a 0-d tensor: a CUDA division by a
host scalar is a multiplication by its reciprocal, one rounding off.
The fused kernel (`kernels/fused_adam.py`) takes Adam's scalars from
`adam_scalars`; every other rule runs per leaf.

Learning rates may be numbers or `Schedule`s of the iteration counter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.schedules import (
    Schedule,
    schedule_from_dict,
)


def _lr(lr, step):
    """The learning rate at `step`: a schedule's value there, or the
    number itself."""
    if isinstance(lr, Schedule):
        return lr.value_at(step)
    if isinstance(lr, (int, float, np.floating, np.integer)):
        return lr
    raise TypeError(f"learning rate must be a number or a Schedule; "
                    f"got {lr!r}")


def f32(x) -> float:
    """`x` rounded to float32, as a Python float (exact in either
    precision PyTorch then computes a scalar product in)."""
    return float(np.float32(x))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _bias_correction(beta, step) -> np.float32:
    """1 - βᵗ with t = float32(step) + 1, in float32."""
    t = np.float32(step) + np.float32(1.0)
    return np.float32(1.0) - np.power(np.float32(beta), t)


class Updater:
    """Base updater config. Subclasses are dataclasses (serializable)."""

    name = "base"

    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, grad, state, step):
        """Return (update_to_subtract, new_state)."""
        raise NotImplementedError

    def with_lr(self, lr):
        """Copy of this updater with a replaced learning rate."""
        if hasattr(self, "learning_rate"):
            return dataclasses.replace(self, learning_rate=lr)
        return self

    def to_dict(self):
        d = {"updater": self.name}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Schedule):
                v = v.to_dict()
            d[f.name] = v
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()


def _zeros(names, param):
    return {n: torch.zeros_like(param) for n in names}


@dataclasses.dataclass(eq=False)
class Sgd(Updater):
    learning_rate: Any = 1e-3
    name = "sgd"

    def apply(self, grad, state, step):
        return f32(_lr(self.learning_rate, step)) * grad, state


@dataclasses.dataclass(eq=False)
class NoOp(Updater):
    name = "noop"

    def apply(self, grad, state, step):
        return torch.zeros_like(grad), state


@dataclasses.dataclass(eq=False)
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name = "adam"

    def init_state(self, param):
        return _zeros(("m", "v"), param)

    def apply(self, grad, state, step):
        lr, bc1, bc2 = adam_scalars(self, step)
        b1, b2 = f32(self.beta1), f32(self.beta2)
        m = b1 * state["m"] + f32(1 - self.beta1) * grad
        v = b2 * state["v"] + f32(1 - self.beta2) * grad * grad
        mhat = m / _scalar(bc1, m)
        vhat = v / _scalar(bc2, v)
        upd = lr * mhat / (torch.sqrt(vhat) + f32(self.epsilon))
        return upd, {"m": m, "v": v}


@dataclasses.dataclass(eq=False)
class AdaMax(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name = "adamax"

    def init_state(self, param):
        return _zeros(("m", "u"), param)

    def apply(self, grad, state, step):
        m = f32(self.beta1) * state["m"] + f32(1 - self.beta1) * grad
        u = torch.maximum(f32(self.beta2) * state["u"], grad.abs())
        # lr / (1-β1ᵗ) is a float32 scalar, as in JAX
        c = float(np.float32(_lr(self.learning_rate, step))
                  / _bias_correction(self.beta1, step))
        upd = c * m / (u + f32(self.epsilon))
        return upd, {"m": m, "u": u}


@dataclasses.dataclass(eq=False)
class Nadam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    name = "nadam"

    def init_state(self, param):
        return _zeros(("m", "v"), param)

    def apply(self, grad, state, step):
        b1 = f32(self.beta1)
        bc1 = float(_bias_correction(self.beta1, step))
        bc2 = float(_bias_correction(self.beta2, step))
        m = b1 * state["m"] + f32(1 - self.beta1) * grad
        v = f32(self.beta2) * state["v"] + f32(1 - self.beta2) * grad * grad
        mhat = m / _scalar(bc1, m)
        vhat = v / _scalar(bc2, v)
        nesterov_m = b1 * mhat + f32(1 - self.beta1) * grad / _scalar(bc1, m)
        lr = f32(_lr(self.learning_rate, step))
        upd = lr * nesterov_m / (torch.sqrt(vhat) + f32(self.epsilon))
        return upd, {"m": m, "v": v}


@dataclasses.dataclass(eq=False)
class Nesterovs(Updater):
    learning_rate: Any = 0.1
    momentum: float = 0.9
    name = "nesterovs"

    def init_state(self, param):
        return _zeros(("v",), param)

    def apply(self, grad, state, step):
        # nd4j NesterovsUpdater: vPrev = v; v = mu*v - lr*g;
        # update = -(mu*vPrev - (1+mu)*v), applied as param -= -update
        lr = f32(_lr(self.learning_rate, step))
        mu = f32(self.momentum)
        v_prev = state["v"]
        v = mu * v_prev - lr * grad
        upd = -(mu * v_prev - f32(1 + self.momentum) * v)
        return -upd, {"v": v}


@dataclasses.dataclass(eq=False)
class AdaGrad(Updater):
    learning_rate: Any = 0.1
    epsilon: float = 1e-6
    name = "adagrad"

    def init_state(self, param):
        return _zeros(("h",), param)

    def apply(self, grad, state, step):
        h = state["h"] + grad * grad
        lr = f32(_lr(self.learning_rate, step))
        upd = lr * grad / (torch.sqrt(h) + f32(self.epsilon))
        return upd, {"h": h}


@dataclasses.dataclass(eq=False)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6
    name = "adadelta"

    def init_state(self, param):
        return _zeros(("msg", "msdx"), param)

    def apply(self, grad, state, step):
        rho, one_m = f32(self.rho), f32(1 - self.rho)
        eps = f32(self.epsilon)
        msg = rho * state["msg"] + one_m * grad * grad
        dx = (torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps)) * grad
        msdx = rho * state["msdx"] + one_m * dx * dx
        return dx, {"msg": msg, "msdx": msdx}


@dataclasses.dataclass(eq=False)
class RmsProp(Updater):
    learning_rate: Any = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    name = "rmsprop"

    def init_state(self, param):
        return _zeros(("g2",), param)

    def apply(self, grad, state, step):
        g2 = (f32(self.rms_decay) * state["g2"]
              + f32(1 - self.rms_decay) * grad * grad)
        lr = f32(_lr(self.learning_rate, step))
        upd = lr * grad / torch.sqrt(g2 + f32(self.epsilon))
        return upd, {"g2": g2}


def adam_scalars(updater: Adam, step):
    """(lr, 1-β1ᵗ, 1-β2ᵗ) as float32 values (Python floats), computed as
    `Adam.apply` computes them: t = float32(step) + 1, then float32
    powers and differences; lr is the (scheduled) rate in float32."""
    lr = np.float32(_lr(updater.learning_rate, step))
    return (float(lr), float(_bias_correction(updater.beta1, step)),
            float(_bias_correction(updater.beta2, step)))


_UPDATERS = {
    "sgd": Sgd, "noop": NoOp, "adam": Adam, "adamax": AdaMax, "nadam": Nadam,
    "nesterovs": Nesterovs, "adagrad": AdaGrad, "adadelta": AdaDelta,
    "rmsprop": RmsProp,
}


def get_updater(u) -> Updater:
    if isinstance(u, Updater):
        return u
    if isinstance(u, str):
        key = u.lower()
        if key not in _UPDATERS:
            raise ValueError(f"Unknown updater {u!r}. Known: "
                             f"{sorted(_UPDATERS)}")
        return _UPDATERS[key]()
    raise TypeError(f"Cannot interpret {u!r} as an updater")


def updater_from_dict(d: dict) -> Updater:
    d = dict(d)
    cls = _UPDATERS[d.pop("updater")]
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            if f.name == "learning_rate" and isinstance(v, dict):
                v = schedule_from_dict(v)
            kwargs[f.name] = v
    return cls(**kwargs)
