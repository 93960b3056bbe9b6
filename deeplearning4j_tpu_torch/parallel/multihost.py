"""Multi-process initialization and teardown (counterpart of
`deeplearning4j_tpu/parallel/multihost.py:128-253`).

JAX brings a multi-host world up with `jax.distributed.initialize`,
after which `jax.devices()` lists every process's devices and one mesh
spans them. The port does the same over `torch.distributed`:
`initialize_multihost` starts a process group (`tcp://` rendezvous at
the coordinator address) and gathers every process's devices into one
global list, process-major, which `parallel.mesh.make_mesh` then spans.
Each mesh entry knows the rank that owns it; a process drives only its
own entries, and the collectives (`parallel/collectives.py`) cross
processes on a sub-group per mesh axis.

Backend: the counterpart of JAX's `_enable_cpu_collectives` is an
explicit `backend=`. By default it follows the process's devices:
NCCL for CUDA devices, gloo for CPU devices. gloo on CUDA tensors (each
exchange staged through pinned host memory) runs only when the caller
names it — the one-card case, where NCCL refuses two ranks on one GPU.
There is no silent switch from one backend to another.

The same bounded retry as JAX's: transient connect and bind errors
retry after ``backoff_s * 2**k``, any other error raises at once, and a
half-initialised group is torn down between attempts. The call is
idempotent while the world is up; `shutdown_multihost` destroys the
group, clears the latch and every cache that pins the world (the axis
sub-groups, their staging buffers and the global device list), so a
following call may bring up a different world of another size, with
this process at another rank (the elastic runtime, `parallel/elastic.py`,
does so at every generation). The destroy is bounded: a group wedged by
a dead peer cannot hang the caller (`TEARDOWN_TIMEOUT_S`).
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import List, Optional, Sequence, Tuple

import torch

log = logging.getLogger("deeplearning4j_tpu_torch.parallel.multihost")

# the errors the bounded-retry path treats as "the coordinator is not
# up yet / a transient connect failure" (JAX's markers, and the words
# torch's TCP store uses for the same failures)
_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "timed out",
                      "Timed out", "failed to connect", "Connection refused",
                      "connection attempt", "Socket closed",
                      "Address already in use", "Connection reset",
                      "DistNetworkError")

# how long `shutdown_multihost` waits for `destroy_process_group`
TEARDOWN_TIMEOUT_S = 30.0

# the live world: {"backend", "devices": [(rank, torch.device)], "local":
# [torch.device]}; None while no world is up
_WORLD: Optional[dict] = None
# caches that pin the world, cleared at shutdown (parallel/collectives.py
# registers its sub-group cache here)
_TOPOLOGY_CACHES: List[dict] = []


def _transient(err: BaseException) -> bool:
    msg = f"{type(err).__name__}: {err}"
    return any(m in msg for m in _TRANSIENT_MARKERS)


def _resolve_devices(devices, process_id) -> List[torch.device]:
    """The process's own devices: `devices` as given, else one CUDA card
    (`process_id` modulo the visible cards, one process per card, as
    NCCL wants). Asking for CUDA without it raises."""
    from deeplearning4j_tpu_torch.device import resolve_device
    if devices is None:
        resolve_device("cuda")
        n = max(1, torch.cuda.device_count())
        devices = [torch.device("cuda", int(process_id or 0) % n)]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("initialize_multihost needs at least one device")
    return out


def _resolve_backend(backend: Optional[str], devices) -> str:
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a process's devices must be all CUDA or all "
                         f"CPU; got {sorted(kinds)}")
    kind = kinds.pop()
    if backend is None:
        return "nccl" if kind == "cuda" else "gloo"
    backend = backend.lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("backend='nccl' needs CUDA devices; the CPU "
                         "devices given run over backend='gloo'")
    return backend


def _peer_timeout(heartbeat_interval_s, max_missing_heartbeats
                  ) -> Optional[datetime.timedelta]:
    """The heartbeat knobs' product (a peer silent for that long is
    declared dead), or None when neither is given."""
    if heartbeat_interval_s is None and max_missing_heartbeats is None:
        return None
    hb = float(heartbeat_interval_s if heartbeat_interval_s is not None
               else 10.0)
    miss = int(max_missing_heartbeats if max_missing_heartbeats
               is not None else 10)
    return datetime.timedelta(seconds=max(1.0, hb) * max(1, miss))


def _timeout(initialization_timeout, heartbeat_interval_s,
             max_missing_heartbeats) -> datetime.timedelta:
    """The rendezvous' timeout: `initialization_timeout` when given, else
    the heartbeat knobs' product, else torch's default of 30 minutes."""
    if initialization_timeout is not None:
        return datetime.timedelta(seconds=float(initialization_timeout))
    peer = _peer_timeout(heartbeat_interval_s, max_missing_heartbeats)
    return peer if peer is not None else datetime.timedelta(minutes=30)


def _set_peer_timeout(timeout: datetime.timedelta):
    """Set the live default group's collective timeout (the group was
    created with the rendezvous' timeout). torch's setter is private: a
    torch without it fails here, not with a slow timeout later."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _set_pg_timeout
    if dist.is_initialized():
        _set_pg_timeout(timeout)


def _raw_initialize(coordinator_address, num_processes, process_id, *,
                    backend: str, timeout: datetime.timedelta):
    """One initialization attempt (split out so tests can fake it)."""
    import torch.distributed as dist
    addr = coordinator_address
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend=backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)


def _reset_distributed_state():
    """Best-effort teardown of a half-initialized group, so the next
    attempt does not fail with 'already initialized'."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — peers may already be gone
        log.warning("process-group reset during retry raised %s "
                    "(continuing)", e)
    _reset_group_names()


def _reset_group_names():
    """Restart torch's count of unnamed process groups once no group is
    left. The default group's rendezvous keys carry that count, and a
    failed `init_process_group` advances it without a group to destroy
    (`destroy_process_group` resets it only when there is one): a process
    that failed one rendezvous would then publish its address under other
    keys than a fresh peer's at the next, and both would wait out the
    timeout."""
    import torch.distributed as dist
    if not dist.is_available() or dist.is_initialized():
        return
    from torch.distributed import distributed_c10d
    distributed_c10d._world.group_count = 0


def _gather_devices(local: Sequence[torch.device]
                    ) -> List[Tuple[int, torch.device]]:
    """Every process's devices, process-major: [(rank, device)]."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    if world == 1:
        return [(0, d) for d in local]
    got: List[Optional[list]] = [None] * world
    dist.all_gather_object(got, [str(d) for d in local])
    return [(r, torch.device(s)) for r in range(world) for s in got[r]]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         initialization_timeout: Optional[float] = None,
                         heartbeat_interval_s: Optional[float] = None,
                         max_missing_heartbeats: Optional[int] = None,
                         max_attempts: int = 3,
                         backoff_s: float = 1.0,
                         backend: Optional[str] = None,
                         devices: Optional[Sequence] = None) -> None:
    """Bring up the multi-process world (idempotent while up).

    `coordinator_address` is ``host:port`` (or a ``tcp://`` URL) of
    rank 0's rendezvous; `num_processes` and `process_id` are the world
    size and this process's rank. `devices` are this process's own
    devices (default: one CUDA card, `process_id` modulo the visible
    cards); `backend` defaults to NCCL for CUDA devices and gloo for CPU
    devices, and ``backend="gloo"`` with CUDA devices must be named.

    The heartbeat knobs map onto the process group's timeout: a
    collective waits at most ``heartbeat_interval_s *
    max_missing_heartbeats`` seconds for a peer. `initialization_timeout`
    bounds the rendezvous (and, without the heartbeat knobs, the
    collectives too). Connection setup retries `max_attempts` times with
    ``backoff_s * 2**k`` sleeps on transient errors; other errors raise
    at once."""
    global _WORLD
    if getattr(initialize_multihost, "_done", False):
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs num_processes and "
                         "process_id (nothing auto-detects a cluster)")
    local = _resolve_devices(devices, process_id)
    be = _resolve_backend(backend, local)
    timeout = _timeout(initialization_timeout, heartbeat_interval_s,
                       max_missing_heartbeats)
    if be == "nccl":
        torch.cuda.set_device(local[0])
    last_err: Optional[BaseException] = None
    for attempt in range(max(1, int(max_attempts))):
        try:
            _raw_initialize(coordinator_address, num_processes, process_id,
                            backend=be, timeout=timeout)
            peer = _peer_timeout(heartbeat_interval_s,
                                 max_missing_heartbeats)
            if (initialization_timeout is not None and peer is not None
                    and peer != timeout):
                _set_peer_timeout(peer)
            _WORLD = {"backend": be, "local": list(local),
                      "devices": _gather_devices(local)}
            initialize_multihost._done = True
            return
        except Exception as e:  # noqa: BLE001 — inspect + classify
            last_err = e
            _reset_distributed_state()
            if not _transient(e):
                raise
            if attempt + 1 < max(1, int(max_attempts)):
                delay = backoff_s * (2 ** attempt)
                log.warning(
                    "init_process_group attempt %d/%d failed (coordinator "
                    "%s not reachable yet?): %s — retrying in %.1fs",
                    attempt + 1, max_attempts, coordinator_address,
                    str(e)[:200], delay)
                time.sleep(delay)
    raise RuntimeError(
        f"initialize_multihost: all {max_attempts} attempts failed "
        f"(transient coordinator race?)") from last_err


def multihost_active() -> bool:
    """True between a successful `initialize_multihost` and the next
    `shutdown_multihost`."""
    return bool(getattr(initialize_multihost, "_done", False))


def shutdown_multihost() -> None:
    """Tear the world down so it can be brought up again with another
    topology: destroy the process group, clear the latch, the global
    device list and every cache that pins the world (the axis
    sub-groups). No-op when no world is up."""
    if not multihost_active():
        return
    wedged = None
    try:
        _destroy_bounded(TEARDOWN_TIMEOUT_S)
    except TimeoutError as e:
        wedged = e
    except Exception as e:  # noqa: BLE001 — a dead peer can fail it;
        # the local teardown below must still run
        log.warning("destroy_process_group raised %s (continuing with "
                    "local teardown)", e)
    finally:
        initialize_multihost._done = False
        _clear_topology_caches()
        _reset_group_names()
    if wedged is not None:
        raise RuntimeError(
            f"{wedged}; the distributed runtime is wedged and this process "
            f"cannot bring up another world") from wedged


def _destroy_bounded(timeout_s: float):
    """`destroy_process_group` on a helper thread, waited for at most
    `timeout_s` (TimeoutError past it, the thread left behind)."""
    import threading

    import torch.distributed as dist
    if not dist.is_initialized():
        return
    done, err = threading.Event(), []

    def run():
        try:
            dist.destroy_process_group()
        except Exception as e:  # noqa: BLE001 — raised in the caller
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=run, name="destroy-process-group",
                     daemon=True).start()
    if not done.wait(timeout_s):
        raise TimeoutError(f"destroy_process_group did not return within "
                           f"{timeout_s:.0f} s")
    if err:
        raise err[0]


def _clear_topology_caches():
    global _WORLD
    _WORLD = None
    for cache in _TOPOLOGY_CACHES:
        cache.clear()


def world() -> Optional[dict]:
    """The live world ({"backend", "local", "devices"}), or None."""
    return _WORLD if multihost_active() else None


def global_devices() -> List[Tuple[int, torch.device]]:
    """Every process's devices, process-major, as (rank, device)."""
    w = world()
    if w is None:
        raise RuntimeError("no multi-process world is up; call "
                           "initialize_multihost first")
    return list(w["devices"])


def backend() -> Optional[str]:
    w = world()
    return None if w is None else w["backend"]


def process_count() -> int:
    return (torch.distributed.get_world_size() if multihost_active()
            else 1)


def process_index() -> int:
    return torch.distributed.get_rank() if multihost_active() else 0


def is_main_process() -> bool:
    return process_index() == 0
