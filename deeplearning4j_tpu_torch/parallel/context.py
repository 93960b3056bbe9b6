"""Ambient sequence-parallel context (counterpart of
`deeplearning4j_tpu/parallel/context.py`).

A layer's config names the strategy (`sequence_parallel="ring"`); the
mesh is runtime state and rides this context manager:

    mesh = make_mesh(MeshSpec.of(seq=4), devices=["cuda:0"] * 4)
    with sequence_sharding(mesh, axis="seq"):
        net.fit(x, y)     # attention layers with sequence_parallel set
                          # run ring/Ulysses attention over the mesh

The lookup happens at every forward (PyTorch caches no traced program).
Thread-local; leaving the block restores the previous value.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

_state = threading.local()


def current_sequence_mesh() -> Optional[Tuple[object, str]]:
    """The active (mesh, seq_axis) pair, or None."""
    return getattr(_state, "mesh_axis", None)


@contextlib.contextmanager
def sequence_sharding(mesh, axis: str = "seq"):
    prev = getattr(_state, "mesh_axis", None)
    _state.mesh_axis = (mesh, axis)
    try:
        yield mesh
    finally:
        _state.mesh_axis = prev
