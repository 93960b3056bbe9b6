"""The rows of a global batch that this process computes.

JAX's single-barrier data-parallel step and `ShardedParallelTrainer`'s
dense step are ONE program over the global batch: dropout draws the
global key's mask over the global shape, and BatchNorm normalizes with
the global batch's statistics. When several processes share such a step
(`parallel/trainer.py`, `parallel/tensor.py`), each runs the container's
forward on its own rows inside `global_rows(offset, total, xp)`:

- `kernels.dropout.dropout` draws the words of the mask's flat indices
  from ``offset * row_size`` on (the rows of the global threefry mask,
  through the counter-offset word kernel), so each process's rows get
  the bits JAX's global draw gives them;
- `BatchNormalization` in training takes the global batch's mean and
  population variance: fp32 per-channel sums (then sums of squared
  deviations) summed across the processes by `xp` before normalizing,
  differentiable (the backward sums the statistics' gradients across
  the processes too).

Outside the block (one process, or any per-replica program) nothing
changes. Thread-local, like the sequence-parallel context.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()


class GlobalRows:
    def __init__(self, offset: int, total: int, xp):
        self.offset = int(offset)
        self.total = int(total)
        self.xp = xp


def current() -> Optional[GlobalRows]:
    """The active rows context, or None."""
    return getattr(_state, "rows", None)


@contextlib.contextmanager
def global_rows(offset: int, total: int, xp=None):
    """This process computes rows [offset, offset + its batch) of a
    global batch of `total` rows; `xp` (a `parallel.collectives.
    CrossProcess`) sums the BatchNorm statistics across the processes."""
    prev = getattr(_state, "rows", None)
    _state.rows = GlobalRows(offset, total, xp)
    try:
        yield _state.rows
    finally:
        _state.rows = prev


class _CrossSum(torch.autograd.Function):
    """Σ over the processes, both ways (the backward of a sum that every
    process reads is the sum of their gradients)."""

    @staticmethod
    def forward(ctx, x, xp):
        ctx.xp = xp
        y = x.clone()
        xp.all_reduce_([y])
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.xp.all_reduce_([g])
        return g, None


def mean_var(x: torch.Tensor, dims, rows: GlobalRows):
    """The global batch's fp32 mean and population variance over `dims`
    (a two-pass variance, as `jnp.var` takes it), the sums crossing
    processes; the local rows are `x.shape[0]` of `rows.total`."""
    x32 = x.float()
    per = 1
    for d in dims:
        per *= x.shape[d]
    n = per // x.shape[0] * rows.total
    s = x32.sum(dim=dims)
    if rows.xp is not None:
        s = _CrossSum.apply(s, rows.xp)
    mean = s / n
    q = (x32 - mean).square().sum(dim=dims)
    if rows.xp is not None:
        q = _CrossSum.apply(q, rows.xp)
    return mean, q / n


def row_offset_elements(x: torch.Tensor) -> Optional[int]:
    """The flat-index offset of x's first element in the global batch's
    array, or None when x is the whole batch (no context, or one
    process's rows are all of it)."""
    rows = current()
    if rows is None or x.ndim == 0:
        return None
    if rows.offset == 0 and x.shape[0] == rows.total:
        return None
    return rows.offset * (x.numel() // max(1, x.shape[0]))
