"""Pipeline parallelism (GPipe) over the "pipe" mesh axis (counterpart
of `deeplearning4j_tpu/parallel/pipeline.py`).

The model's repeated body is split into S stages, stage s on the s-th
device of the pipe axis. The batch splits into M microbatches that
flow through the stages: at tick t stage s works on microbatch t - s,
so the schedule takes M + S - 1 ticks (fill and drain), and the last
stage's outputs are gathered back in microbatch order. Each hand-over
from stage s to s + 1 is a `.to` of the activation onto the next
stage's device (a no-op on a mesh that repeats one card), and the
backward is autograd through those hops: one `backward()` gives the
pipeline-parallel gradients, as JAX's `jax.grad` through the
`ppermute` schedule does.

With `data_axis` the microbatches' rows also split over the data axis:
data shard d runs its own GPipe stream through the stage devices at
data index d.
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.parallel.mesh import on_device


def _to_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _stage_slice(tree, s):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    return tree[s]


def _line(mesh, axis, at):
    """The devices along `axis` with the other axes at index `at`
    (a dict {axis: index}; unnamed axes at 0)."""
    import numpy as np
    idx = []
    for name in mesh.axis_names:
        idx.append(slice(None) if name == axis else at.get(name, 0))
    return list(np.asarray(mesh.devices[tuple(idx)]).reshape(-1))


def bubble_share(stages: int, microbatches: int) -> float:
    """The GPipe schedule's idle share: (S - 1) / (M + S - 1)."""
    return (stages - 1) / (microbatches + stages - 1)


def pipeline_apply(block_fn: Callable, stage_params, x_mb, devices):
    """The GPipe schedule over the stage `devices` (S of them):
    `stage_params[s]` are stage s's params (on its device), `x_mb` the
    M microbatches (a list, or a tensor [M, b, ...]). At tick t stage s
    runs `block_fn(stage_params[s], h)` on microbatch t - s, for M + S -
    1 ticks. Returns the last stage's M outputs, in microbatch order."""
    S, M = len(devices), len(x_mb)
    outs = [None] * M
    handed = [None] * S
    for t in range(M + S - 1):
        nxt = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            inp = (x_mb[m] if s == 0 else handed[s]).to(devices[s])
            with on_device(devices[s]):
                y = block_fn(stage_params[s], inp)
            if s == S - 1:
                outs[m] = y
            else:
                nxt[s + 1] = y
        handed = nxt
    return outs


def pipeline_forward(block_fn: Callable, stacked_params, x: torch.Tensor,
                     mesh, *, pipe_axis: str = "pipe",
                     microbatches: int = 4, data_axis: str = None
                     ) -> torch.Tensor:
    """`block_fn(stage_params, h)` applied by S pipelined stages to x
    [B, ...] (B divisible by `microbatches`); returns [B, ...] of the
    last stage, on x's device. `stacked_params` is either a list of S
    per-stage trees or a tree whose leaves have a leading stage axis of
    size S (JAX's layout); stage s's are moved to its device."""
    B = x.shape[0]
    if B % microbatches:
        raise ValueError("batch must divide microbatches")
    S = int(mesh.shape[pipe_axis])
    M = int(microbatches)
    if isinstance(stacked_params, (list, tuple)):
        per_stage = list(stacked_params)
    else:
        per_stage = [_stage_slice(stacked_params, s) for s in range(S)]
    if len(per_stage) != S:
        raise ValueError(f"{len(per_stage)} stage param trees for a "
                         f"{S}-stage pipe axis")
    n_data = int(mesh.shape[data_axis]) if data_axis else 1
    mbs = x.chunk(M)
    outs = []
    for d in range(n_data):
        devs = _line(mesh, pipe_axis, {data_axis: d} if data_axis else {})
        params = [_to_tree(per_stage[s], devs[s]) for s in range(S)]
        pieces = [m.chunk(n_data)[d] if n_data > 1 else m for m in mbs]
        outs.append(pipeline_apply(block_fn, params, pieces, devs))
    return torch.cat([torch.cat([outs[d][m].to(x.device)
                                 for d in range(n_data)])
                      for m in range(M)])
