"""Fault-runtime exception types (counterpart of
`deeplearning4j_tpu/fault/errors.py`): the checkpoint error, the elastic
runtime's two signals (`parallel/elastic.py`) and the drill's preemption
signal. Dependency-free, so every layer can raise and catch them."""

from __future__ import annotations


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated container, corrupt deflate stream). Raised instead of the
    raw numpy/zip traceback so callers can fall back to an earlier
    checkpoint."""


class ElasticMembershipError(RuntimeError):
    """The elastic membership control plane is unreachable or rejected
    a request after bounded retries (`parallel/elastic.py`). Distinct
    from training failures, so a caller decides whether to keep training
    on the last known topology or abort."""


class ElasticReconfiguration(Exception):
    """Control flow of the elastic runtime, not an error: the membership
    generation changed and every process agreed (the in-band drain
    check) to leave the fit at the same step boundary, after a drain
    checkpoint committed. Raised by the drain listener inside `fit`;
    `ElasticTrainer` catches it, tears the process group down and
    re-forms the mesh for the new generation."""

    def __init__(self, generation: int, step: int = -1):
        super().__init__(
            f"elastic reconfiguration to generation {generation} "
            f"(drained at step {step})")
        self.generation = generation
        self.step = step


class SimulatedPreemption(BaseException):
    """Raised by the fault-injection drill at the scripted step. A
    BaseException (like KeyboardInterrupt), so an `except Exception` in
    training code cannot swallow the simulated kill, as it could not
    catch a real SIGTERM."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step
