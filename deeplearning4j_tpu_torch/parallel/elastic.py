"""Elastic multi-process training (counterpart of
`deeplearning4j_tpu/parallel/elastic.py`).

The world is not fixed when `initialize_multihost` runs. A small
membership coordinator tracks the live processes over a TCP/JSON control
plane; when a process joins, leaves or misses heartbeats past the grace
window, the coordinator commits a new GENERATION: a numbered plan naming
the members, each member's rank and a fresh rendezvous address. The
workers drain their fit at one agreed step boundary, checkpoint, tear the
process group down (`shutdown_multihost`), bring up the new world
(`initialize_multihost`), re-form the mesh and resume from the newest
valid checkpoint, the threshold residual, τ and the per-replica updater
stacks re-sharded to the new replica count (`fault.reshard_replica_stack`).

Three coordination problems, as in JAX:

1. **Membership.** `ElasticCoordinator` runs in a process that outlives
   worker churn (a launcher, or process 0 of the fleet). Members register
   with a stable token, heartbeat every `heartbeat_interval_s`, and are
   evicted after `grace_s` without a beat. Changes coalesce for
   `settle_s` before a generation commits, so a wave of joins forms one
   generation. A generation's `coordinator_address` is the
   `torch.distributed` TCP rendezvous on rank 0's host, at a port bumped
   each generation: the store of a world lives in its rank 0, and a world
   whose rank 0 died leaves its port behind.

2. **Synchronized drain.** The notice of a new generation reaches each
   worker's heartbeat thread at a different time, but every process must
   leave the fit at the same step (one that leaves early strands its
   peers inside a collective). At each step boundary the drain listener
   all-reduces a 1-element "I want to reconfigure" flag over the data
   axis's processes (`make_drain_check`); only when the global flag is
   set do all processes checkpoint (the same step, so the barrier
   manifests line up) and raise `ElasticReconfiguration` together.

3. **Survive the kill.** A SIGKILLed peer cannot drain. Its peers see
   the break as a collective error (gloo's "Connection closed by peer",
   NCCL's watchdog abort after the group's timeout, which
   `initialize_multihost`'s heartbeat knobs set). As in JAX,
   `on_fatal="exit"` exits with `RESTART_EXIT_CODE` for a supervisor to
   relaunch, `on_fatal="exec"` re-executes the process in place, and the
   new process re-registers under its token and resumes from the newest
   valid checkpoint. `on_fatal="raise"` hands the error to the caller,
   which may tear the broken group down itself (`shutdown_multihost` is
   bounded and leaves the process ready for another world) and call
   `fit` again: it rejoins under the same token and resumes, without a
   new process (`parallel/elastic_smoke.py` does so).

Pure host code up to the trainer: the heartbeat thread makes no CUDA
call (a worker's metrics export reads its registry, never the card).
The plan and status keys, metric names and constructor arguments are
JAX's, `jax_port_base`, `jax_port_span`, `jax_heartbeat_interval_s` and
`jax_max_missing_heartbeats` included (they are the rendezvous ports
and the process group's peer timeout here), so either package's client
speaks to the other's coordinator.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.fault.errors import (
    ElasticMembershipError,
    ElasticReconfiguration,
)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch.parallel.elastic")

#: exit code of a worker asking to be relaunched into the current
#: generation (distinct from success and from ordinary failures)
RESTART_EXIT_CODE = 17

# error-message markers that classify an exception as "the distributed
# runtime broke under us" (a peer died) rather than a bug: JAX's, then
# what torch raises when a peer dies: gloo's pair errors, the c10d error
# types, NCCL's watchdog abort and a TCPStore timeout
_FATAL_MARKERS = ("Gloo", "gloo", "heartbeat", "DEADLINE_EXCEEDED",
                  "UNAVAILABLE", "coordination", "Coordination",
                  "Connection reset", "Socket closed", "Connection refused",
                  "distributed service", "INTERNAL:",
                  "Connection closed by peer", "Broken pipe",
                  "DistBackendError", "DistNetworkError", "DistStoreError",
                  "Watchdog caught collective operation timeout",
                  "NCCL communicator was aborted", "ProcessGroupNCCL",
                  "Socket Timeout", "wait timeout after",
                  "destroy_process_group did not return")


def distributed_failure(err: BaseException) -> bool:
    """True when `err` looks like a broken distributed runtime (a peer
    died mid-collective, the rendezvous store is gone) rather than an
    ordinary training error. The exception's type name counts: torch
    raises `DistBackendError` with the backend's own message."""
    msg = f"{type(err).__name__}: {err}"
    return any(m in msg for m in _FATAL_MARKERS)


# =====================================================================
# control-plane wire (newline-delimited JSON, one request a connection)
# =====================================================================
def _send_request(address: str, payload: dict, timeout: float) -> dict:
    host, port = address.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    if not buf:
        raise ConnectionError("empty control-plane response")
    return json.loads(buf.decode())


def retry_request(address: str, payload: dict, *, timeout: float = 5.0,
                  attempts: int = 5, backoff_s: float = 0.2) -> dict:
    """One control-plane request with bounded retry and exponential
    backoff. Raises `ElasticMembershipError` once the attempts are spent
    (or at once when the coordinator rejects the request); the caller
    decides whether a lost control plane is fatal (the fit keeps training
    on the last known topology)."""
    last: Optional[Exception] = None
    for attempt in range(max(1, int(attempts))):
        try:
            reply = _send_request(address, payload, timeout)
            if not reply.get("ok", False):
                raise ElasticMembershipError(
                    f"control plane rejected {payload.get('op')!r}: "
                    f"{reply.get('error')}")
            return reply
        except ElasticMembershipError:
            raise
        except (OSError, ValueError, ConnectionError) as e:
            last = e
            if attempt + 1 < max(1, int(attempts)):
                time.sleep(backoff_s * (2 ** attempt))
    raise ElasticMembershipError(
        f"control plane at {address} unreachable after {attempts} "
        f"attempts: {last}") from last


# =====================================================================
# coordinator
# =====================================================================
@dataclass
class _Member:
    token: str
    host: str
    device_count: int
    last_seen: float
    info: dict = field(default_factory=dict)


class ElasticCoordinator:
    """Membership and generation service (the control plane).

    Any change of the member set (a new token registers, a member
    leaves, or is evicted after `grace_s` without a heartbeat) marks it
    dirty; once `settle_s` passes without another change, and at least
    `min_members` are present for the first generation, a generation
    commits: training members rank-ordered by token, the rendezvous on
    rank 0's host at ``jax_port_base + generation % jax_port_span``.
    Serving members ride the same generation numbers but never take a
    training rank.

    Metrics, while `monitor.enable()` is on in the hosting process:
    ``elastic_live_processes`` and ``elastic_generation`` gauges and the
    ``elastic_reconfigurations_total`` counter (commits after the first).
    """

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 grace_s: float = 5.0, settle_s: float = 1.0,
                 tick_s: float = 0.25, min_members: int = 1,
                 jax_port_base: int = 52000, jax_port_span: int = 500):
        self.host = host
        self.grace_s = float(grace_s)
        self.settle_s = float(settle_s)
        self.tick_s = float(tick_s)
        self.min_members = int(min_members)
        self.jax_port_base = int(jax_port_base)
        self.jax_port_span = int(jax_port_span)
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        self._completed: set = set()
        self._generation = 0
        self._plan: Optional[dict] = None
        self._dirty_since: Optional[float] = time.monotonic()
        self._stopped = threading.Event()
        coordinator = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    line = self.rfile.readline(1 << 20)
                    req = json.loads(line.decode())
                    reply = coordinator._handle(req)
                except Exception as e:  # noqa: BLE001 — wire errors
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                try:
                    self.wfile.write((json.dumps(reply) + "\n").encode())
                except OSError:
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self.address = f"{host}:{self.port}"
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, name="elastic-coordinator",
            daemon=True)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="elastic-membership-monitor",
            daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ElasticCoordinator":
        self._serve_thread.start()
        self._monitor_thread.start()
        log.info("elastic coordinator serving on %s", self.address)
        return self

    def stop(self):
        self._stopped.set()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- requests
    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "register":
            return self._op_register(req)
        if op == "heartbeat":
            return self._op_heartbeat(req)
        if op == "leave":
            return self._op_leave(req)
        if op == "plan":
            with self._lock:
                return {"ok": True, "generation": self._generation,
                        "plan": self._plan}
        if op == "status":
            return {"ok": True, "status": self.status()}
        raise ValueError(f"unknown control-plane op {op!r}")

    def _op_register(self, req: dict) -> dict:
        token = str(req["token"])
        now = time.monotonic()
        with self._lock:
            fresh = token not in self._members
            self._members[token] = _Member(
                token=token, host=str(req.get("host", "127.0.0.1")),
                device_count=int(req.get("device_count", 1)),
                last_seen=now, info=dict(req.get("info") or {}))
            self._completed.discard(token)
            if fresh:
                self._dirty_since = now
                log.info("member %s registered (%d live)", token,
                         len(self._members))
            return {"ok": True, "generation": self._generation,
                    "plan": self._plan, "member": True}

    def _op_heartbeat(self, req: dict) -> dict:
        token = str(req["token"])
        now = time.monotonic()
        with self._lock:
            m = self._members.get(token)
            if m is None:
                # evicted (or unknown): the worker must re-register
                return {"ok": True, "generation": self._generation,
                        "member": False}
            m.last_seen = now
            if req.get("info"):
                m.info.update(req["info"])
            reply = {"ok": True, "generation": self._generation,
                     "member": True}
            if int(req.get("generation", -1)) != self._generation:
                reply["plan"] = self._plan
            return reply

    def _op_leave(self, req: dict) -> dict:
        token = str(req["token"])
        with self._lock:
            if token in self._members:
                del self._members[token]
                if req.get("reason") == "complete":
                    self._completed.add(token)
                self._dirty_since = time.monotonic()
                log.info("member %s left (%s; %d live)", token,
                         req.get("reason", "unspecified"),
                         len(self._members))
            return {"ok": True, "generation": self._generation}

    # -------------------------------------------------------- plan machine
    def _monitor_loop(self):
        while not self._stopped.wait(self.tick_s):
            now = time.monotonic()
            with self._lock:
                stale = [t for t, m in self._members.items()
                         if now - m.last_seen > self.grace_s]
                for t in stale:
                    del self._members[t]
                    self._dirty_since = now
                    log.warning("member %s evicted after %.1fs without a "
                                "heartbeat (%d live)", t, self.grace_s,
                                len(self._members))
                if (self._dirty_since is not None
                        and now - self._dirty_since >= self.settle_s
                        and (self._plan is not None
                             or len(self._members) >= self.min_members)):
                    self._commit_generation()

    def _commit_generation(self):
        # the caller holds the lock
        self._generation += 1
        members = sorted((m for m in self._members.values()
                          if m.info.get("role") != "serving"),
                         key=lambda m: m.token)
        serving = sorted((m for m in self._members.values()
                          if m.info.get("role") == "serving"),
                         key=lambda m: m.token)
        port = self.jax_port_base + (self._generation % self.jax_port_span)
        self._plan = {
            "generation": self._generation,
            "num_processes": len(members),
            "members": [{"token": m.token, "host": m.host,
                         "device_count": m.device_count, "rank": r}
                        for r, m in enumerate(members)],
            "serving_members": [{"token": m.token, "host": m.host,
                                 "info": dict(m.info)}
                                for m in serving],
            "coordinator_address": (f"{members[0].host}:{port}"
                                    if members else None),
        }
        self._dirty_since = None
        from deeplearning4j_tpu_torch.monitor.flightrec import (
            GLOBAL_FLIGHT_RECORDER)
        GLOBAL_FLIGHT_RECORDER.record(
            "elastic_reconfiguration", generation=self._generation,
            members=[m.token for m in members])
        log.info("committed generation %d: %s", self._generation,
                 [m.token for m in members])
        self._record_metrics()

    def _record_metrics(self):
        from deeplearning4j_tpu_torch import monitor
        if not monitor.is_enabled():
            return
        reg = monitor.registry()
        reg.gauge("elastic_live_processes",
                  help="members of the current elastic generation"
                  ).set(len(self._members))
        reg.gauge("elastic_generation",
                  help="current elastic membership generation"
                  ).set(self._generation)
        if self._generation > 1:
            reg.counter(
                "elastic_reconfigurations_total",
                help="committed membership changes after initial "
                     "formation").inc()

    # --------------------------------------------------------------- views
    def status(self) -> dict:
        with self._lock:
            return {"generation": self._generation, "plan": self._plan,
                    "completed": sorted(self._completed),
                    "members": {t: {"host": m.host,
                                    "device_count": m.device_count,
                                    "info": dict(m.info)}
                                for t, m in self._members.items()}}


def serving_directory(status: dict, model: Optional[str] = None) -> dict:
    """The replica view of a coordinator `status()`: the live serving
    members (of one model, when given) with the load gauges of their
    newest heartbeat, under the membership generation. A router polls
    this: `status()` carries member info updated at every heartbeat,
    while a committed plan snapshots it at generation boundaries only.

    Returns ``{"generation": g, "replicas": [{token, host, port, model,
    version, load}, ...]}``, replicas in token order; `load` holds the
    gauges the replica advertised (queue_depth, outstanding_tokens,
    ewma_tok_s, open_streams, n_slots)."""
    replicas = []
    for token, m in (status.get("members") or {}).items():
        info = m.get("info") or {}
        if info.get("role") != "serving":
            continue
        if model is not None and info.get("model") != model:
            continue
        addr = info.get("addr") or [m.get("host"), None]
        replicas.append({
            "token": token,
            "host": addr[0],
            "port": None if addr[1] is None else int(addr[1]),
            "model": info.get("model"),
            "version": info.get("version"),
            "load": {k: info[k] for k in
                     ("queue_depth", "outstanding_tokens", "ewma_tok_s",
                      "open_streams", "n_slots") if k in info},
        })
    replicas.sort(key=lambda r: r["token"])
    return {"generation": int(status.get("generation") or 0),
            "replicas": replicas}


# =====================================================================
# client
# =====================================================================
class ElasticClient:
    """A worker's view of the control plane: registration, a daemon
    heartbeat thread and the newest generation and plan. All I/O goes
    through `retry_request`; a lost control plane degrades to a warning
    and training goes on in the last known topology until it returns."""

    def __init__(self, address: str, token: str, *,
                 heartbeat_interval_s: float = 0.5, io_timeout_s: float = 5.0,
                 io_attempts: int = 5, backoff_s: float = 0.2):
        self.address = address
        self.token = token
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.io_timeout_s = float(io_timeout_s)
        self.io_attempts = int(io_attempts)
        self.backoff_s = float(backoff_s)
        self._lock = threading.Lock()
        self._generation = 0
        self._plan: Optional[dict] = None
        self._info: dict = {}
        self._registration: Optional[dict] = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unreachable_since: Optional[float] = None
        self._federate_worker: Optional[str] = None

    # ------------------------------------------------------------------ io
    def _request(self, payload: dict) -> dict:
        return retry_request(self.address, payload,
                             timeout=self.io_timeout_s,
                             attempts=self.io_attempts,
                             backoff_s=self.backoff_s)

    def register(self, *, host: str = "127.0.0.1",
                 device_count: int = 1, info: Optional[dict] = None) -> dict:
        self._registration = {"op": "register", "token": self.token,
                              "host": host, "device_count": device_count,
                              "info": info or {}}
        reply = self._request(self._registration)
        self._absorb(reply)
        return reply

    def register_serving(self, *, model: str, host: str, port: int,
                         info: Optional[dict] = None) -> dict:
        """Register as a serving member: capacity for `model` at
        `host:port` instead of a training rank. Serving members appear
        in `plan["serving_members"]` and `serving_directory()` under the
        same generation numbers; their load gauges ride `set_info` on
        every heartbeat."""
        full = {"role": "serving", "model": str(model),
                "addr": [host, int(port)]}
        full.update(info or {})
        with self._lock:
            self._info.update(full)
        return self.register(host=host, device_count=0, info=full)

    def leave(self, reason: str = "unspecified"):
        # no beat after the leave: the coordinator would answer it "not a
        # member", the beat loop would register this worker again and a
        # completed run would no longer count as completed
        self.stop()
        try:
            self._request({"op": "leave", "token": self.token,
                           "reason": reason})
        except ElasticMembershipError as e:
            log.warning("leave(%s) failed: %s", reason, e)

    def status(self) -> dict:
        return self._request({"op": "status"})["status"]

    # ----------------------------------------------------------- heartbeat
    def start_heartbeats(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stopped.clear()
        self._thread = threading.Thread(target=self._beat_loop,
                                        name=f"elastic-hb-{self.token}",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.heartbeat_interval_s + 1)

    def _beat_loop(self):
        while not self._stopped.wait(self.heartbeat_interval_s):
            self._refresh_federated_metrics()
            with self._lock:
                payload = {"op": "heartbeat", "token": self.token,
                           "generation": self._generation,
                           "info": dict(self._info)}
            try:
                reply = retry_request(self.address, payload,
                                      timeout=self.io_timeout_s,
                                      attempts=2, backoff_s=self.backoff_s)
            except ElasticMembershipError as e:
                if self._unreachable_since is None:
                    self._unreachable_since = time.monotonic()
                    log.warning("control plane unreachable (%s); training "
                                "continues on the current topology", e)
                continue
            self._unreachable_since = None
            if not reply.get("member", True) and self._registration:
                # evicted while alive (a long stall): register again
                log.warning("member %s was evicted; re-registering",
                            self.token)
                try:
                    reply = self._request(self._registration)
                except ElasticMembershipError as e:
                    log.warning("re-register failed: %s", e)
                    continue
            self._absorb(reply)

    def _absorb(self, reply: dict):
        with self._lock:
            gen = int(reply.get("generation", self._generation))
            if reply.get("plan") is not None:
                self._plan = reply["plan"]
            if gen != self._generation:
                self._generation = gen

    # --------------------------------------------------------------- views
    def set_info(self, **info):
        with self._lock:
            self._info.update(info)

    def federate_metrics(self, worker: Optional[str] = None):
        """Piggyback this worker's metrics registry on the heartbeat's
        info channel: every beat refreshes ``info["metrics"]`` with a
        `monitor.federate.export_snapshot`, so the coordinator's
        `status()` carries one labelled snapshot per live member and
        `monitor.federate.ingest_elastic_status` merges the training
        fleet into one /metrics view, with no other transport."""
        self._federate_worker = worker or self.token
        self._refresh_federated_metrics()

    def _refresh_federated_metrics(self):
        if self._federate_worker is None:
            return
        from deeplearning4j_tpu_torch import monitor
        if not monitor.is_enabled():
            return
        from deeplearning4j_tpu_torch.monitor.federate import export_snapshot
        snap = export_snapshot(monitor.registry(),
                               worker=self._federate_worker)
        with self._lock:
            self._info["metrics"] = snap

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def current_plan(self) -> Optional[dict]:
        with self._lock:
            return self._plan

    def my_rank(self, plan: Optional[dict] = None) -> Optional[int]:
        plan = plan if plan is not None else self.current_plan()
        if not plan:
            return None
        for m in plan["members"]:
            if m["token"] == self.token:
                return int(m["rank"])
        return None

    def await_member_plan(self, *, timeout_s: float = 120.0,
                          poll_s: float = 0.2) -> dict:
        """Block until a plan naming this member exists (a register-time
        reply can predate the first commit, so it polls the control
        plane). Raises `ElasticMembershipError` on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            reply = self._request({"op": "plan"})
            self._absorb(reply)
            plan = self.current_plan()
            if plan is not None and self.my_rank(plan) is not None:
                return plan
            time.sleep(poll_s)
        raise ElasticMembershipError(
            f"no plan including member {self.token!r} within {timeout_s}s")


# =====================================================================
# the drain: a synchronized exit from a running fit
# =====================================================================
class _DrainListener(TrainingListener):
    """At each step boundary, all-reduce the local "my generation is
    stale" flag over the data axis. When the global flag is set, every
    process, at the same step, saves a drain checkpoint, waits for its
    commit and raises `ElasticReconfiguration`."""

    def __init__(self, client: ElasticClient, run_generation: int,
                 drain_check: Callable[[bool], bool],
                 ckpt_listener=None):
        self.client = client
        self.run_generation = run_generation
        self.drain_check = drain_check
        self.ckpt_listener = ckpt_listener

    def iteration_done(self, model, iteration, epoch, score, **info):
        if not info.get("step_boundary", True):
            return
        step = iteration + 1
        self.client.set_info(step=step, phase="fit")
        local = self.client.generation() != self.run_generation
        if not self.drain_check(local):
            return
        # every process reaches this branch at the same step boundary
        if self.ckpt_listener is not None:
            self.ckpt_listener.save_now(model, step, epoch)
            self.ckpt_listener.checkpointer.wait()
        from deeplearning4j_tpu_torch import monitor
        if monitor.is_enabled():
            monitor.registry().counter(
                "elastic_drains_total",
                help="synchronized drains out of a running fit").inc()
        raise ElasticReconfiguration(self.client.generation(), step)


def make_drain_check(mesh, data_axis: str = "data"):
    """The in-band agreement: one all-reduce of a 1-element int tensor
    over the processes that own the data axis (`CrossProcess` on the
    axis's group, the group the trainer's exchange uses), each process
    contributing its local flag; the result is the global OR. In one
    process it is the local flag itself. Every process calls this for
    the same mesh (creating the group is collective). The returned
    check keeps its calls and host seconds in ``check.stats``."""
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives, multihost
    xp = collectives.make_axis_groups(mesh, data_axis)
    if xp is None:
        flag_device = None
    elif xp.backend == "gloo":
        flag_device = torch.device("cpu")
    else:
        flag_device = multihost.world()["local"][0]
    stats = {"calls": 0, "seconds": 0.0}

    def check(local_flag: bool) -> bool:
        t0 = time.perf_counter()
        if xp is None:
            out = bool(local_flag)
        else:
            flag = torch.full((1,), int(bool(local_flag)), dtype=torch.int32,
                              device=flag_device)
            xp.all_reduce_([flag])
            out = int(flag.item()) > 0
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - t0
        return out

    check.stats = stats
    return check


# =====================================================================
# the elastic trainer
# =====================================================================
@dataclass
class ElasticConfig:
    """The elastic runtime's knobs (the control plane and the process
    group)."""

    control_address: str
    token: str
    host: str = "127.0.0.1"
    heartbeat_interval_s: float = 0.5
    io_timeout_s: float = 5.0
    io_attempts: int = 5
    backoff_s: float = 0.2
    join_timeout_s: float = 120.0
    #: the process group: `init_timeout_s` bounds the rendezvous, so a
    #: join to a superseded generation gives up and fetches the newer
    #: plan; a collective waits for a silent peer at most
    #: ``jax_heartbeat_interval_s * jax_max_missing_heartbeats`` seconds
    #: (under NCCL that is the watchdog's abort; gloo sees a dead peer's
    #: closed socket at once)
    init_timeout_s: float = 30.0
    init_attempts: int = 3
    jax_heartbeat_interval_s: float = 1.0
    jax_max_missing_heartbeats: int = 5
    #: when the distributed runtime breaks under us (a peer was
    #: hard-killed): "raise" re-raises for the caller or a supervisor,
    #: "exit" exits with RESTART_EXIT_CODE, "exec" re-executes sys.argv
    on_fatal: str = "raise"
    max_generations: int = 50


class ElasticTrainer:
    """A restartable fit around `ParallelTrainer` (sync dense, threshold
    and rs modes): join the current generation, train until the run
    completes or the generation changes, then drain, re-form the world
    and the mesh, resume, until `epochs` epochs are done.

    `build_model` is called once per generation; state carries over only
    through the checkpoints, which is also what makes a SIGKILLed and
    relaunched worker indistinguishable from a drained one.

    `devices` are this process's mesh devices and `backend` the process
    group's (`initialize_multihost`'s arguments): by default one CUDA
    card (the rank modulo the visible cards) and NCCL; pass CPU devices
    to train on the CPU over gloo."""

    def __init__(self, build_model: Callable[[], object], *,
                 config: ElasticConfig, ckpt_dir, ckpt_frequency: int = 5,
                 keep_last: int = 5, mode: str = "sync",
                 gradient_sharing: Optional[str] = None,
                 trainer_kwargs: Optional[dict] = None,
                 devices: Optional[Sequence] = None,
                 backend: Optional[str] = None):
        self.build_model = build_model
        self.config = config
        self.ckpt_dir = ckpt_dir
        self.ckpt_frequency = int(ckpt_frequency)
        self.keep_last = int(keep_last)
        self.mode = mode
        self.gradient_sharing = gradient_sharing
        self.trainer_kwargs = dict(trainer_kwargs or {})
        self.devices = None if devices is None else list(devices)
        self.backend = backend
        self.client = ElasticClient(
            config.control_address, config.token,
            heartbeat_interval_s=config.heartbeat_interval_s,
            io_timeout_s=config.io_timeout_s,
            io_attempts=config.io_attempts, backoff_s=config.backoff_s)
        #: one report a generation (introspection for drills and tests):
        #: {generation, n_workers, resumed, residual_restored, step}
        self.history: List[dict] = []

    # ----------------------------------------------------- runtime seams
    # overridable, so tests run the protocol in one process
    def _init_runtime(self, plan: dict):
        from deeplearning4j_tpu_torch.parallel.multihost import (
            _clear_topology_caches,
            initialize_multihost,
            multihost_active,
        )
        if plan["num_processes"] <= 1:
            return
        cfg = self.config
        if not multihost_active():
            _clear_topology_caches()
        initialize_multihost(
            plan["coordinator_address"], plan["num_processes"],
            self.client.my_rank(plan),
            initialization_timeout=cfg.init_timeout_s,
            heartbeat_interval_s=cfg.jax_heartbeat_interval_s,
            max_missing_heartbeats=cfg.jax_max_missing_heartbeats,
            max_attempts=cfg.init_attempts, devices=self.devices,
            backend=self.backend)

    def _teardown_runtime(self):
        from deeplearning4j_tpu_torch.parallel.multihost import (
            shutdown_multihost)
        shutdown_multihost()

    def _mesh(self, plan: dict):
        """The data-parallel mesh over the world's devices (this
        process's own when the generation has one process)."""
        from deeplearning4j_tpu_torch.parallel import multihost
        from deeplearning4j_tpu_torch.parallel.mesh import (
            MeshSpec, device_mesh, make_mesh)
        if self.devices is None or multihost.multihost_active():
            return device_mesh()
        return make_mesh(MeshSpec.of(data=len(self.devices)),
                         devices=self.devices)

    # ------------------------------------------------------------- fit
    def fit(self, iterator_factory: Callable[[], object], *,
            epochs: int, batch_size: int, steps_per_execution: int = 1,
            extra_listeners: Optional[Callable[[int], list]] = None):
        """Run `epochs` epochs elastically. `iterator_factory` builds a
        fresh seekable DataSetIterator a generation (the checkpoint's
        cursor repositions it); `extra_listeners(generation)` may add
        listeners a generation. Returns the final generation's model."""
        cfg = self.config
        self.client.register(host=cfg.host,
                             device_count=self._local_device_count(),
                             info={"phase": "join"})
        self.client.start_heartbeats()
        try:
            return self._fit_loop(iterator_factory, epochs, batch_size,
                                  steps_per_execution, extra_listeners)
        finally:
            self.client.stop()

    def _fit_loop(self, iterator_factory, epochs, batch_size,
                  steps_per_execution, extra_listeners):
        cfg = self.config
        for _ in range(cfg.max_generations):
            plan = self.client.await_member_plan(
                timeout_s=cfg.join_timeout_s)
            gen = int(plan["generation"])
            self.client.set_info(phase="init", generation=gen)
            try:
                self._init_runtime(plan)
            except Exception as e:  # noqa: BLE001 — classified below
                self._teardown_runtime()
                if self.client.generation() != gen:
                    log.warning("generation %d superseded while joining "
                                "(%s); rejoining", gen, str(e)[:120])
                    continue
                raise
            try:
                model, done = self._run_generation(
                    plan, iterator_factory, epochs, batch_size,
                    steps_per_execution, extra_listeners)
            except ElasticReconfiguration as e:
                log.info("generation %d drained at step %d; re-forming",
                         gen, e.step)
                try:
                    self._teardown_runtime()
                except Exception as err:  # noqa: BLE001 — a wedged group
                    if distributed_failure(err):
                        self._handle_fatal(err, gen)
                    raise
                continue
            except Exception as e:  # noqa: BLE001 — classified below
                if distributed_failure(e):
                    self._handle_fatal(e, gen)
                raise
            if done:
                self.client.leave(reason="complete")
                return model
        raise ElasticMembershipError(
            f"run did not complete within {cfg.max_generations} "
            f"membership generations")

    def _resume(self, trainer, model, iterator) -> bool:
        """Restore the newest valid checkpoint into `trainer` (False when
        there is none: the model then starts from its init)."""
        try:
            trainer.resume(self.ckpt_dir, iterator=iterator)
            return True
        except FileNotFoundError:
            if model.params_version == 0:
                model.init()
            return False

    def _run_generation(self, plan, iterator_factory, epochs, batch_size,
                        steps_per_execution, extra_listeners):
        from deeplearning4j_tpu_torch import fault, monitor
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

        gen = int(plan["generation"])
        mesh = self._mesh(plan)
        model = self.build_model()
        trainer = ParallelTrainer(model, mesh, mode=self.mode,
                                  gradient_sharing=self.gradient_sharing,
                                  **self.trainer_kwargs)
        iterator = iterator_factory()
        resumed = self._resume(trainer, model, iterator)
        report = {"generation": gen, "n_workers": trainer.n_workers,
                  "resumed": resumed,
                  "residual_restored": trainer._resume_res is not None,
                  "step": int(model.iteration_count)}
        self.history.append(report)
        if monitor.is_enabled():
            reg = monitor.registry()
            reg.gauge("elastic_generation",
                      help="current elastic membership generation").set(gen)
            if resumed:
                reg.counter("elastic_resume_total",
                            help="elastic resumes from checkpoint").inc()
        log.info("generation %d: %d workers, resumed=%s at step %d",
                 gen, trainer.n_workers, resumed, model.iteration_count)

        ck = fault.AsyncCheckpointer(self.ckpt_dir,
                                     keep_last=self.keep_last)
        ckl = fault.CheckpointListener(ck, frequency=self.ckpt_frequency,
                                       iterator=iterator)
        drain = _DrainListener(self.client, gen,
                               make_drain_check(mesh), ckpt_listener=ckl)
        extras = list(extra_listeners(gen)) if extra_listeners else []
        for lst in extras + [ckl, drain]:
            model.add_listener(lst)
        self.client.set_info(phase="fit", generation=gen,
                             step=int(model.iteration_count))
        remaining = int(epochs) - int(model.epoch_count)
        try:
            if remaining > 0:
                trainer.fit(iterator, epochs=remaining,
                            batch_size=batch_size,
                            steps_per_execution=steps_per_execution)
        finally:
            # the drain (and a fatal exit) needs pending saves durable
            # before the world goes down
            try:
                ck.wait()
            except Exception as e:  # noqa: BLE001
                log.warning("checkpoint drain on generation exit: %s", e)
        self.client.set_info(phase="done", step=int(model.iteration_count))
        return model, True

    # ----------------------------------------------------------- plumbing
    def _local_device_count(self) -> int:
        """This process's mesh devices, for its registration. Creates no
        CUDA context (`torch.cuda.device_count` does not)."""
        if self.devices is not None:
            return len(self.devices)
        import torch
        return max(1, torch.cuda.device_count())

    def _handle_fatal(self, err: BaseException, generation: int):
        cfg = self.config
        log.error("distributed runtime failed under generation %d: %s",
                  generation, str(err)[:300])
        if cfg.on_fatal == "exit":
            # a broken group cannot be trusted in-process: the supervisor
            # relaunches us and we resume from the newest checkpoint
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(RESTART_EXIT_CODE)
        if cfg.on_fatal == "exec":
            log.warning("re-executing %s %s", sys.executable, sys.argv)
            os.execv(sys.executable, [sys.executable] + sys.argv)
        # "raise": fall through, the caller re-raises


def elastic_fit(build_model, iterator_factory, *, config: ElasticConfig,
                ckpt_dir, epochs: int, batch_size: int,
                mode: str = "sync", gradient_sharing: Optional[str] = None,
                ckpt_frequency: int = 5, steps_per_execution: int = 1,
                extra_listeners=None, trainer_kwargs=None,
                keep_last: int = 5, devices: Optional[Sequence] = None,
                backend: Optional[str] = None):
    """One-call elastic training: build the trainer, join the membership,
    survive reconfigurations; returns (the trained model, the
    `ElasticTrainer`). See `ElasticTrainer`."""
    et = ElasticTrainer(build_model, config=config, ckpt_dir=ckpt_dir,
                        ckpt_frequency=ckpt_frequency, keep_last=keep_last,
                        mode=mode, gradient_sharing=gradient_sharing,
                        trainer_kwargs=trainer_kwargs, devices=devices,
                        backend=backend)
    model = et.fit(iterator_factory, epochs=epochs, batch_size=batch_size,
                   steps_per_execution=steps_per_execution,
                   extra_listeners=extra_listeners)
    return model, et
