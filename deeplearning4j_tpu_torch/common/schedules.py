"""Learning-rate (and generally value) schedules (counterpart of
`deeplearning4j_tpu/common/schedules.py`: `Schedule` :20 through
`WarmupCosineSchedule` :127, `schedule_from_dict` :159, `as_schedule`
:170).

A schedule is a pure function of the iteration counter. PyTorch runs
eagerly and the counter is a host int, so `value_at(step)` computes on
the host in numpy float32, term for term in the JAX expression's order:
JAX meets a float32 step with weak-typed Python floats, so every
constant is rounded to float32 first and every operation is a float32
one. The result is an `np.float32` (the updaters read it as a host
scalar; the fused Adam kernel takes it as its lr argument).

The transcendental functions follow XLA:CPU's float32 results, which
numpy's float32 ones miss by up to 2 ulps: `pow` and `exp` are the
float64 functions of the float32 operands, rounded once (XLA's pow
agrees; its exp, an approximation of its own, is within an ulp), and
`cos` is the C library's `cosf`, which XLA:CPU calls (bit-equal; the
cosine decay's 1 + cos(πf) near its end turns one ulp of the cosine
into tens of the value).

`to_dict` and `schedule_from_dict` read and write the JAX package's
dicts.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Dict

import numpy as np

_F = np.float32


@functools.cache
def _cosf():
    """The C library's float32 cosine, loaded at first use."""
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def _pow(a, b) -> np.float32:
    """float32 a ** b: the float64 power of the float32 values, rounded."""
    return _F(float(_F(a)) ** float(_F(b)))


def _exp(x) -> np.float32:
    return _F(np.exp(np.float64(_F(x))))


def _cos(x) -> np.float32:
    return _F(_cosf()(float(_F(x))))


def _step(step) -> np.float32:
    return _F(step)


class Schedule:
    name = "base"

    def value_at(self, step) -> np.float32:
        raise NotImplementedError

    def __call__(self, step):
        return self.value_at(step)

    def to_dict(self):
        d = {"schedule": self.name}
        d.update(dataclasses.asdict(self))
        return d

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


@dataclasses.dataclass(eq=False)
class FixedSchedule(Schedule):
    value: float
    name = "fixed"

    def value_at(self, step):
        return _F(self.value)


@dataclasses.dataclass(eq=False)
class ExponentialSchedule(Schedule):
    initial_value: float
    gamma: float
    name = "exponential"

    def value_at(self, step):
        return _F(self.initial_value) * _pow(self.gamma, _step(step))


@dataclasses.dataclass(eq=False)
class InverseSchedule(Schedule):
    initial_value: float
    gamma: float
    power: float
    name = "inverse"

    def value_at(self, step):
        base = _F(1.0) + _F(self.gamma) * _step(step)
        return _F(self.initial_value) / _pow(base, self.power)


@dataclasses.dataclass(eq=False)
class PolySchedule(Schedule):
    initial_value: float
    power: float
    max_iter: int
    name = "poly"

    def value_at(self, step):
        frac = np.clip(_step(step) / _F(self.max_iter), _F(0.0), _F(1.0))
        return _F(self.initial_value) * _pow(_F(1.0) - frac, self.power)


@dataclasses.dataclass(eq=False)
class SigmoidSchedule(Schedule):
    initial_value: float
    gamma: float
    step_size: int
    name = "sigmoid"

    def value_at(self, step):
        z = _F(self.gamma) * (_step(step) - _F(self.step_size))
        return _F(self.initial_value) / (_F(1.0) + _exp(z))


@dataclasses.dataclass(eq=False)
class StepSchedule(Schedule):
    initial_value: float
    decay_rate: float
    step_size: int
    name = "step"

    def value_at(self, step):
        k = np.floor(_step(step) / _F(self.step_size))
        return _F(self.initial_value) * _pow(self.decay_rate, k)


@dataclasses.dataclass(eq=False)
class MapSchedule(Schedule):
    """Piecewise-constant schedule keyed by iteration, like nd4j
    MapSchedule: the value of the largest key <= step (the first key's
    value before it)."""

    values: Dict[int, float]
    name = "map"

    def value_at(self, step):
        keys = sorted(self.values)
        s = int(np.int32(step))
        out = _F(self.values[keys[0]])
        for k in keys[1:]:
            if s >= k:
                out = _F(self.values[k])
        return out

    def to_dict(self):
        return {"schedule": self.name,
                "values": {str(k): v for k, v in self.values.items()}}


@dataclasses.dataclass(eq=False)
class WarmupCosineSchedule(Schedule):
    """Linear warmup to `peak_value` over `warmup_steps`, then cosine
    decay to `end_value` at `total_steps`."""

    peak_value: float
    warmup_steps: int
    total_steps: int
    end_value: float = 0.0
    name = "warmup_cosine"

    def value_at(self, step):
        s = _step(step)
        if s < _F(self.warmup_steps):
            return _F(self.peak_value) * s / _F(max(self.warmup_steps, 1))
        span = _F(max(self.total_steps - self.warmup_steps, 1))
        frac = np.clip((s - _F(self.warmup_steps)) / span, _F(0.0), _F(1.0))
        # (peak - end) * 0.5 is Python (double) arithmetic in JAX too;
        # the product meets the float32 cosine as a float32
        half = _F(0.5 * (self.peak_value - self.end_value))
        cos = _F(1.0) + _cos(_F(np.pi) * frac)
        return _F(self.end_value) + half * cos


_SCHEDULES = {
    "fixed": FixedSchedule,
    "exponential": ExponentialSchedule,
    "inverse": InverseSchedule,
    "poly": PolySchedule,
    "sigmoid": SigmoidSchedule,
    "step": StepSchedule,
    "map": MapSchedule,
    "warmup_cosine": WarmupCosineSchedule,
}


def schedule_from_dict(d) -> Schedule:
    if isinstance(d, (int, float)):
        return FixedSchedule(float(d))
    d = dict(d)
    name = d.pop("schedule")
    cls = _SCHEDULES[name]
    if cls is MapSchedule:
        return MapSchedule({int(k): float(v) for k, v in d["values"].items()})
    return cls(**d)


def as_schedule(value) -> Schedule:
    if isinstance(value, Schedule):
        return value
    return FixedSchedule(float(value))
