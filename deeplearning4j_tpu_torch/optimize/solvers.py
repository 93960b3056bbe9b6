"""The line-search solver family (counterpart of
`deeplearning4j_tpu/optimize/solvers.py`): `LineGradientDescent`,
`ConjugateGradient` (Polak-Ribiere with restart), `LBFGS` (the
two-loop recursion), `BackTrackLineSearch` (Armijo) and the four step
functions, driven by `Solver` over a container's loss.

The params flatten into one fp32 vector in `ravel_pytree`'s order:
layer keys sorted as strings (layer "10" before "2"), then each layer's
JAX param names sorted, each param in its JAX layout and C order. A
loss evaluation writes the vector into the params and runs the
container's training loss (train mode, no step key: no dropout or
weight noise, BatchNormalization on batch statistics) under its dtype
policy, on the net's device; the dot products are fp32 on the device
and the line search's branching stays on the host, as in JAX. `fit`
runs `Solver.optimize` once per minibatch, for `max_iterations`.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device


class OptimizationAlgorithm(str, Enum):
    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


# ------------------------------------------------------------ step functions
class StepFunction:
    """How a search direction is applied to the params."""

    name = "step"
    sign = 1.0

    def step(self, x: torch.Tensor, direction: torch.Tensor,
             alpha: float) -> torch.Tensor:
        return x + (self.sign * alpha) * direction

    def to_dict(self):
        return {"step_function": self.name}


class DefaultStepFunction(StepFunction):
    """x <- x + alpha * d (the direction carries the descent sign)."""

    name = "default"
    sign = 1.0


class NegativeDefaultStepFunction(StepFunction):
    """x <- x - alpha * d (pairs with raw-gradient directions)."""

    name = "negative_default"
    sign = -1.0


class GradientStepFunction(StepFunction):
    name = "gradient"
    sign = 1.0


class NegativeGradientStepFunction(StepFunction):
    name = "negative_gradient"
    sign = -1.0


_STEP_FUNCTIONS = {c.name: c for c in
                   (DefaultStepFunction, NegativeDefaultStepFunction,
                    GradientStepFunction, NegativeGradientStepFunction)}


def step_function_from_dict(d) -> StepFunction:
    if isinstance(d, StepFunction):
        return d
    name = d["step_function"] if isinstance(d, dict) else str(d)
    return _STEP_FUNCTIONS[name]()


# -------------------------------------------------------------- line search
class BackTrackLineSearch:
    """Armijo backtracking: contract the step by `step_decrease` until
    f(x + a.d) <= f(x) + c1.a.g'd; give up after `max_iterations`."""

    def __init__(self, *, max_iterations: int = 20, c1: float = 1e-4,
                 step_decrease: float = 0.5, min_step: float = 1e-12,
                 step_function: Optional[StepFunction] = None):
        self.max_iterations = max_iterations
        self.c1 = c1
        self.step_decrease = step_decrease
        self.min_step = min_step
        self.step_function = step_function or DefaultStepFunction()

    def optimize(self, f: Callable[[torch.Tensor], float], x: torch.Tensor,
                 f0: float, g: torch.Tensor, direction: torch.Tensor,
                 initial_step: float = 1.0) -> Tuple[float, float]:
        """Returns (alpha, f_new); alpha 0.0 means no acceptable step."""
        slope = _dot(g, direction) * self.step_function.sign
        if slope >= 0:
            return 0.0, f0          # not a descent direction
        alpha = initial_step
        for _ in range(self.max_iterations):
            fa = float(f(self.step_function.step(x, direction, alpha)))
            if np.isfinite(fa) and fa <= f0 + self.c1 * alpha * slope:
                return alpha, fa
            alpha *= self.step_decrease
            if alpha < self.min_step:
                break
        return 0.0, f0


# ------------------------------------------------------------------ solvers
class BaseLineSearchOptimizer:
    """The shared loop: score and gradient -> direction -> line search
    -> step, until `max_iterations` or convergence."""

    def __init__(self, *, max_iterations: int = 100, tolerance: float = 1e-6,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.line_search = line_search or BackTrackLineSearch()
        self.scores: List[float] = []

    def _reset(self, n: int):
        pass

    def _direction(self, it: int, x, g, prev_g, prev_d):
        raise NotImplementedError

    def _post_step(self, s, y):
        pass

    def optimize(self, vg: Callable, f: Callable,
                 x0: torch.Tensor) -> torch.Tensor:
        """Minimize over the flat vector from `x0`: `vg(x)` gives (loss,
        gradient), `f(x)` the loss."""
        x = x0
        self._reset(x.numel())
        self.scores = []
        prev_g = prev_d = None
        f0, g = vg(x)
        self.scores.append(f0)
        for it in range(self.max_iterations):
            d = self._direction(it, x, g, prev_g, prev_d)
            alpha, f_new = self.line_search.optimize(f, x, f0, g, d,
                                                     initial_step=1.0)
            if alpha == 0.0:
                if prev_d is None:
                    break
                # restart from steepest descent once before giving up,
                # dropping the curvature memory
                prev_g = prev_d = None
                self._reset(x.numel())
                d = self._direction(0, x, g, None, None)
                alpha, f_new = self.line_search.optimize(f, x, f0, g, d,
                                                         initial_step=1.0)
                if alpha == 0.0:
                    break
            x_new = self.line_search.step_function.step(x, d, alpha)
            f1, g_new = vg(x_new)
            self._post_step(x_new - x, g_new - g)
            converged = abs(f0 - f1) < self.tolerance * max(1.0, abs(f0))
            x, f0, prev_g, prev_d, g = x_new, f1, g, d, g_new
            self.scores.append(f0)
            if converged:
                break
        return x


class LineGradientDescent(BaseLineSearchOptimizer):
    """Steepest descent with the line search."""

    def _direction(self, it, x, g, prev_g, prev_d):
        return -g


class ConjugateGradient(BaseLineSearchOptimizer):
    """Nonlinear CG with the Polak-Ribiere beta
    g'(g - g_prev) / g_prev'g_prev, clamped at 0 (a steepest-descent
    restart)."""

    def _direction(self, it, x, g, prev_g, prev_d):
        if prev_g is None or prev_d is None:
            return -g
        denom = _dot(prev_g, prev_g)
        if denom <= 0:
            return -g
        beta = max(0.0, _dot(g, g - prev_g) / denom)
        return -g + beta * prev_d


class LBFGS(BaseLineSearchOptimizer):
    """Limited-memory BFGS by the two-loop recursion (memory 10)."""

    def __init__(self, *, memory: int = 10, **kw):
        super().__init__(**kw)
        self.memory = memory
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []

    def _reset(self, n):
        self._s, self._y = [], []

    def _post_step(self, s, y):
        if _dot(y, s) > 1e-10:      # the curvature condition
            self._s.append(s)
            self._y.append(y)
            if len(self._s) > self.memory:
                self._s.pop(0)
                self._y.pop(0)

    def _direction(self, it, x, g, prev_g, prev_d):
        if not self._s:
            return -g
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / _dot(y, s)
            a = rho * _dot(s, q)
            alphas.append((a, rho))
            q = q - a * y
        s, y = self._s[-1], self._y[-1]
        gamma = _dot(s, y) / _dot(y, y)
        r = gamma * q
        for (a, rho), s, y in zip(reversed(alphas), self._s, self._y):
            b = rho * _dot(y, r)
            r = r + (a - b) * s
        return -r


_SOLVERS = {
    OptimizationAlgorithm.LINE_GRADIENT_DESCENT: LineGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
}


def flat_order(model) -> List[Tuple[str, str, torch.Tensor]]:
    """(layer key, JAX name, param) in `ravel_pytree`'s order over the
    JAX params tree: keys sorted as strings at both levels."""
    tree = {key: layer.jax_param_map() for key, layer in model.keyed()
            if layer.jax_param_map()}
    return [(lk, pk, tree[lk][pk]) for lk in sorted(tree)
            for pk in sorted(tree[lk])]


class Solver:
    """Run a line-search solver over a container's loss (the JAX
    `Solver`). `device` is where the solve runs; the model must live
    there (the default is the card)."""

    def __init__(self, model, algorithm: OptimizationAlgorithm
                 = OptimizationAlgorithm.CONJUGATE_GRADIENT, *,
                 max_iterations: int = 100, tolerance: float = 1e-6,
                 line_search: Optional[BackTrackLineSearch] = None,
                 device="cuda"):
        algorithm = OptimizationAlgorithm(algorithm)
        if algorithm == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise ValueError("SGD runs through the containers' train step "
                             "(fit); Solver handles the line-search family")
        if resolve_device(device) != model.device:
            raise ValueError(f"the model lives on {model.device}; a Solver "
                             f"on {device} cannot drive it")
        self.model = model
        self.algorithm = algorithm
        self.optimizer = _SOLVERS[algorithm](
            max_iterations=max_iterations, tolerance=tolerance,
            **({"line_search": line_search} if line_search else {}))

    def _flatten(self, tensors) -> torch.Tensor:
        return torch.cat([t.reshape(-1).float() for t in tensors])

    @torch.no_grad()
    def _write(self, order, flat: torch.Tensor):
        off = 0
        for _, _, p in order:
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape))
            off += n

    def optimize(self, x, y, fmask=None, lmask=None) -> float:
        """Optimize the model's loss on one minibatch (tensors, or lists
        of them for a graph) for `max_iterations`; the params and the
        running state of the last evaluation are written back. Returns
        the final score."""
        model = self.model
        order = flat_order(model)

        def loss_fn(st):
            return model._loss_fn(x, y, fmask, lmask, train=True, rng=None,
                                   new_state=st)

        def vg(flat):
            self._write(order, flat)
            loss, grads, _ = model._loss_and_grads(loss_fn)
            return float(loss), self._flatten(
                grads.get(id(p)) if grads.get(id(p)) is not None
                else torch.zeros_like(p) for _, _, p in order)

        def evaluate(flat, state=None):
            self._write(order, flat)
            with torch.no_grad():
                return float(model._policy_call(
                    loss_fn, {} if state is None else state,
                    output_params=True))

        flat = self.optimizer.optimize(
            vg, evaluate, self._flatten(p for _, _, p in order))
        new_state = {}
        model.score_value = evaluate(flat, new_state)
        model._commit_state(new_state)
        model.params_changed()
        return model.score_value

    @property
    def scores(self):
        return self.optimizer.scores
