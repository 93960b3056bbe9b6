"""Horizontal serving: model replicas in processes of their own.

One logical model, N worker processes. Each `ReplicaWorker` wraps a
`GenerationServer` behind a TCP socket speaking the fleet wire frames
(`DLFQ` requests in, `DLFR` token chunks out, length-prefixed via
`wire.send_frame`/`recv_frame`) and registers with the
`parallel/elastic.py` coordinator as a SERVING member — it advertises
capacity (queue depth, outstanding tokens, tok/s EWMA) on every
heartbeat instead of training ranks, and the coordinator's
generation-numbered membership gives every router one consistent
replica view across joins and deaths (`elastic.serving_directory`).

Router side, `ReplicaSet` polls the directory and keeps one
`ReplicaClient` connection per live replica; `FleetRouter.submit`
balances across them LEAST-LOADED FIRST and sheds only when the whole
set is projected past SLO (serving/router.py). A worker dying
mid-stream surfaces as a typed `ReplicaLostError` carrying the request
id, the last reply ordinal received, and the partial tokens — the
signal the router's migration logic acts on: nothing-received requests
resubmit verbatim to a survivor, partial streams continue as
prompt+received with emit_start (same-version replicas only, the
continuation contract).

(Counterpart of `deeplearning4j_tpu/serving/replica.py`.) A replica
serves on its `device`, the card unless the caller asks for the CPU; a
spawned replica is `python -m deeplearning4j_tpu_torch.serving.replica
--device cuda ...`. The JAX replica's `compile_cache_dir` has no
counterpart: the port's kernels are built once by `kernels/build.py`
into a cache every process of the checkout shares.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.serving import wire

log = logging.getLogger("deeplearning4j_tpu_torch.serving.replica")


def _hard_close(sock: socket.socket) -> None:
    """shutdown() then close(): close() alone does NOT send FIN while
    another thread is blocked in recv() on the same socket (the
    in-flight syscall keeps the kernel socket referenced), so a peer
    would never observe the death — shutdown() tears the connection
    down immediately and wakes every blocked reader."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ReplicaLostError(RuntimeError):
    """A replica worker died (or its connection broke) with requests in
    flight. Carries everything retry/migration logic needs: the request
    id, ``last_seq`` (last reply ordinal received; -1 = none) and
    ``tokens`` (the partial stream). Zero tokens received means the
    request never started — resubmit verbatim anywhere; a partial
    stream continues as prompt+received with ``emit_start`` on a
    same-version replica (bit-consistent by the continuation
    contract)."""

    def __init__(self, message: str, *, request_id: Optional[str] = None,
                 last_seq: int = -1, tokens=None,
                 replica: Optional[str] = None):
        super().__init__(message)
        self.request_id = request_id
        self.last_seq = int(last_seq)
        self.tokens = [int(t) for t in (tokens or [])]
        self.replica = replica


# =====================================================================
# client side
# =====================================================================
class ReplicaStream:
    """Client face of one replica-served generation — `TokenStream`'s
    future face over a socket: `.tokens` grows as chunks land,
    `result()` blocks on the terminal frame, producer-side
    `t_submit`/`t_first` timestamps feed TTFT."""

    def __init__(self, request_id: str, model: str, n_tokens: int,
                 replica: Optional[str] = None):
        self._fut: Future = Future()
        self.request_id = request_id
        self.model = model
        self.version: Optional[int] = None
        self.n_tokens = int(n_tokens)
        self.tokens: List[int] = []
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.last_seq = -1
        self.replica = replica

    def _on_reply(self, header: dict, chunk) -> None:
        seq = int(header.get("seq", 0))
        if seq > self.last_seq:
            self.last_seq = seq
            if len(chunk):
                now = time.monotonic()
                if self.t_first is None:
                    self.t_first = now
                self.t_last = now
                self.tokens.extend(int(t) for t in chunk)
        if header.get("version") is not None:
            self.version = int(header["version"])
        if header.get("done") and not self._fut.done():
            err = wire.reply_error(header)
            if err is not None:
                self._fut.set_exception(err)
            else:
                self._fut.set_result(list(self.tokens))

    def _lose(self, exc: BaseException) -> None:
        if not self._fut.done():
            self._fut.set_exception(exc)

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return np.asarray(self._fut.result(timeout), np.int32)


class ReplicaClient:
    """One connection to one replica worker. Thread-safe submits; a
    single reader thread demultiplexes reply frames onto streams by
    request id. Any connection failure fails EVERY in-flight stream
    with `ReplicaLostError` — the typed signal migration acts on."""

    def __init__(self, host: str, port: int, *,
                 token: Optional[str] = None,
                 connect_timeout_s: float = 5.0):
        self.host, self.port = host, int(port)
        self.token = token or f"{host}:{port}"
        self._sock = socket.create_connection((host, self.port),
                                              timeout=connect_timeout_s)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._streams: Dict[str, ReplicaStream] = {}
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"replica-client-{self.token}")
        self._reader.start()

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, model: str, prompt_ids, n_tokens: int, *,
               temperature: float = 0.0, top_p: Optional[float] = None,
               rng=None, emit_start: int = 0,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None) -> ReplicaStream:
        rid = request_id or uuid.uuid4().hex
        frame = wire.encode_request(model, rid, prompt_ids, n_tokens,
                                    temperature=temperature, top_p=top_p,
                                    rng=rng, emit_start=emit_start,
                                    trace_id=trace_id)
        stream = ReplicaStream(rid, model, n_tokens, replica=self.token)
        with self._lock:
            if self._closed:
                raise ReplicaLostError(
                    f"replica {self.token} connection is closed",
                    request_id=rid, replica=self.token)
            self._streams[rid] = stream
        try:
            with self._wlock:
                wire.send_frame(self._sock, frame)
        except OSError as e:
            with self._lock:
                self._streams.pop(rid, None)
            self._fail_all(e)
            raise ReplicaLostError(
                f"replica {self.token} died at submit ({e})",
                request_id=rid, replica=self.token) from e
        return stream

    def _read_loop(self) -> None:
        try:
            while True:
                data = wire.recv_frame(self._sock)
                header, chunk = wire.decode_reply(data)
                rid = header["request_id"]
                with self._lock:
                    stream = self._streams.get(rid)
                    if header.get("done"):
                        self._streams.pop(rid, None)
                if stream is not None:
                    stream._on_reply(header, chunk)
        except (ConnectionError, OSError) as e:
            self._fail_all(e)
        except wire.WireFormatError as e:
            # a corrupt stream cannot be resynchronized — same fate as
            # a dead peer, but the typed cause rides along
            self._fail_all(e)

    def _fail_all(self, cause: BaseException) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            streams, self._streams = self._streams, {}
        _hard_close(self._sock)
        for rid, s in streams.items():
            s._lose(ReplicaLostError(
                f"replica {self.token} lost mid-stream after seq "
                f"{s.last_seq} of request {rid} ({cause!r})",
                request_id=rid, last_seq=s.last_seq, tokens=s.tokens,
                replica=self.token))

    def close(self) -> None:
        self._fail_all(ConnectionError("client closed"))


class ReplicaSet:
    """Router-side replica view for one model: polls the elastic
    coordinator's `status()` (member info refreshes every heartbeat —
    fresher than the committed plan), reconciles one `ReplicaClient`
    per live serving member, and exposes `(token, client, meta)`
    backends with their advertised load gauges. A member leaving the
    directory closes its client, which fails its in-flight streams
    with `ReplicaLostError` — death detection and load reporting ride
    the SAME membership plane."""

    def __init__(self, coordinator_address: str, model: str, *,
                 refresh_s: float = 0.1, io_timeout_s: float = 2.0):
        self.coordinator_address = coordinator_address
        self.model = str(model)
        self.refresh_s = float(refresh_s)
        self.io_timeout_s = float(io_timeout_s)
        self.generation = 0
        self._lock = threading.Lock()
        self._clients: Dict[str, ReplicaClient] = {}
        self._meta: Dict[str, dict] = {}
        self._last_refresh = 0.0

    def refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_s:
                return
            self._last_refresh = now
        from deeplearning4j_tpu_torch.parallel.elastic import (
            retry_request,
            serving_directory,
        )
        try:
            status = retry_request(
                self.coordinator_address, {"op": "status"},
                timeout=self.io_timeout_s, attempts=2)["status"]
        except Exception as e:  # noqa: BLE001 — keep last known view
            log.warning("replica directory refresh failed (%s); keeping "
                        "the last known view", e)
            return
        d = serving_directory(status, self.model)
        live = {}
        for r in d["replicas"]:
            if r["port"] is None:
                continue
            live[r["token"]] = r
        # connect OUTSIDE the lock: ReplicaClient() is a blocking
        # connect with a multi-second timeout, and one unreachable
        # replica must not stall backends() — and every submit — for
        # that long
        with self._lock:
            need = []
            for tok, r in live.items():
                c = self._clients.get(tok)
                if c is None or c.closed:
                    need.append((tok, r["host"], r["port"]))
        connected = []
        for tok, host, port in need:
            try:
                connected.append((tok, ReplicaClient(host, port,
                                                     token=tok)))
            except OSError as e:
                log.warning("replica %s unreachable at %s:%s (%s)",
                            tok, host, port, e)
        evicted: List[ReplicaClient] = []
        with self._lock:
            self.generation = d["generation"]
            self._meta = live
            for tok, c in connected:
                old = self._clients.get(tok)
                if old is not None and not old.closed:
                    # a concurrent refresh connected first; keep its
                    # client (it may already carry in-flight streams)
                    evicted.append(c)
                else:
                    self._clients[tok] = c
            for tok in list(self._clients):
                if tok not in live:
                    # evicted from the membership: fail its streams NOW
                    # (typed) instead of letting them ride a dead socket
                    evicted.append(self._clients.pop(tok))
        # close AFTER releasing the lock: close() fails the client's
        # in-flight streams synchronously on THIS thread, and a failed
        # stream's migration path re-enters refresh()/backends() on
        # this same ReplicaSet — closing under the non-reentrant lock
        # deadlocks the whole replica set (the re-entrant refresh now
        # just returns early via the throttle with the view installed
        # above)
        for c in evicted:
            c.close()

    def backends(self) -> List[Tuple[str, ReplicaClient, dict]]:
        with self._lock:
            return [(tok, c, dict(self._meta.get(tok, {})))
                    for tok, c in self._clients.items() if not c.closed]

    def close(self) -> None:
        with self._lock:
            clients, self._clients = self._clients, {}
        for c in clients.values():
            c.close()


# =====================================================================
# worker side
# =====================================================================
class ReplicaWorker:
    """One serving replica: a `GenerationServer` behind a TCP request
    plane, registered with the elastic coordinator as a serving member.
    Load gauges (`queue_depth`, `outstanding_tokens`, `ewma_tok_s`,
    `open_streams`) refresh on every heartbeat via the member info
    channel AND publish locally as `serving_replica_*` gauge families
    {model=, replica=} — with `monitor.federate` enabled they flow to
    the coordinator like every other federated family."""

    def __init__(self, net, *, model: str = "model", version: int = 1,
                 host: str = "127.0.0.1", port: int = 0,
                 coordinator: Optional[str] = None,
                 token: Optional[str] = None,
                 heartbeat_interval_s: float = 0.25,
                 warmup_prompt_len: Optional[int] = None,
                 warmup_tokens: int = 2,
                 poll_s: float = 0.002, device="cuda",
                 **server_kw):
        from deeplearning4j_tpu_torch.serving.server import GenerationServer
        device = resolve_device(device)
        self.model = str(model)
        self.version = int(version)
        self.poll_s = float(poll_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        server_kw.setdefault("name", self.model)
        self.server = GenerationServer(net, device=device, **server_kw)
        if warmup_prompt_len is not None:
            self.server.warmup(warmup_prompt_len, warmup_tokens)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()[:2]
        self.token = token or f"replica-{self.model}-{self.port}"
        self.coordinator = coordinator
        self._elastic = None
        self._running = False
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._metrics_cache = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaWorker":
        if self._running:
            return self
        self._running = True
        self.server.start()
        if self.coordinator is not None:
            from deeplearning4j_tpu_torch.parallel.elastic import ElasticClient
            self._elastic = ElasticClient(
                self.coordinator, self.token,
                heartbeat_interval_s=self.heartbeat_interval_s)
            self._elastic.register_serving(
                model=self.model, host=self.host, port=self.port,
                info=dict(self._load_info(), version=self.version))
            self._elastic.federate_metrics(worker=self.token)
            self._elastic.start_heartbeats()
        for target, name in ((self._accept_loop, "accept"),
                             (self._gauge_loop, "gauges")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"replica-{self.token}-{name}")
            t.start()
            self._threads.append(t)
        log.info("replica %s serving %s v%d on %s:%d", self.token,
                 self.model, self.version, self.host, self.port)
        return self

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        if self._elastic is not None:
            self._elastic.leave("replica stopped")
            self._elastic.stop()
        # shutdown() first: close() alone leaves the accept thread
        # blocked in accept() on Linux until its join times out
        _hard_close(self._lsock)
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            _hard_close(c)
        for t in self._threads:
            t.join(timeout=5)
        self.server.stop()

    # --------------------------------------------------------- load gauges
    def _load_info(self) -> dict:
        srv = self.server
        return {
            "queue_depth": int(srv.queue_depth()),
            "outstanding_tokens": int(srv._outstanding_tokens()
                                      + srv.queued_tokens),
            "ewma_tok_s": float(srv._ewma_tok_s or 0.0),
            "open_streams": int(srv.open_streams),
            "n_slots": int(srv.engine.n_slots),
        }

    def _metrics(self):
        def build(reg):
            lab = dict(model=self.model, replica=self.token)
            return {
                "queue": reg.gauge(
                    "serving_replica_queue_depth",
                    "admission queue depth of one serving replica",
                    **lab),
                "outstanding": reg.gauge(
                    "serving_replica_outstanding_tokens",
                    "projected decode work owed by one replica", **lab),
                "tok_s": reg.gauge(
                    "serving_replica_tok_s",
                    "token-throughput EWMA of one replica", **lab),
                "open": reg.gauge(
                    "serving_replica_open_streams",
                    "streams open on one replica", **lab),
            }

        return monitor.resolve_cached_metrics(self, "_metrics_cache", build)

    def _gauge_loop(self) -> None:
        while self._running:
            info = self._load_info()
            if self._elastic is not None:
                self._elastic.set_info(**info)
            m = self._metrics()
            if m is not None:
                m["queue"].set(info["queue_depth"])
                m["outstanding"].set(info["outstanding_tokens"])
                m["tok_s"].set(info["ewma_tok_s"])
                m["open"].set(info["open_streams"])
            time.sleep(self.heartbeat_interval_s)

    # ------------------------------------------------------- request plane
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return                           # listener closed: stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name=f"replica-{self.token}-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        """One connection: a reader half ingesting DLFQ frames and a
        relay half streaming DLFR chunks back. All socket WRITES happen
        on the relay half (single writer — no interleaved frames);
        submit failures are queued as error entries the relay sends."""
        active: Dict[str, dict] = {}
        lock = threading.Lock()
        reader_done = threading.Event()

        def reader():
            try:
                while self._running:
                    data = wire.recv_frame(conn)
                    rid = None
                    try:
                        header, prompt = wire.decode_request(data)
                        rid = header["request_id"]
                        stream = self.server.generate_async(
                            prompt, int(header["n_tokens"]),
                            temperature=header.get("temperature") or 0.0,
                            top_p=header.get("top_p"),
                            rng=header.get("rng"),
                            emit_start=int(header.get("emit_start") or 0))
                        ent = {"stream": stream, "cursor": 0, "seq": 0}
                    except wire.WireFormatError:
                        if rid is None:
                            log.exception("replica %s: undecodable "
                                          "frame dropped", self.token)
                            continue
                        ent = {"stream": None, "seq": 0,
                               "error": wire.WireFormatError(
                                   "malformed request frame")}
                    except Exception as e:  # noqa: BLE001 — shed /
                        # validation errors fail THAT request only
                        if rid is None:
                            log.exception("replica %s: request failed "
                                          "before it had an id",
                                          self.token)
                            continue
                        ent = {"stream": None, "seq": 0, "error": e}
                    with lock:
                        active[rid] = ent
            except (ConnectionError, OSError, wire.WireFormatError):
                pass
            finally:
                reader_done.set()

        rt = threading.Thread(target=reader, daemon=True,
                              name=f"replica-{self.token}-read")
        rt.start()
        try:
            self._relay(conn, active, lock, reader_done)
        finally:
            _hard_close(conn)
            # client gone: cancel what it will never read, so a dead
            # connection does not pin slots against live traffic
            with lock:
                orphans = [e["stream"] for e in active.values()
                           if e.get("stream") is not None]
                active.clear()
            for s in orphans:
                if not s._fut.done():
                    s.cancel()
            rt.join(timeout=5)

    def _relay(self, conn, active, lock, reader_done) -> None:
        """The router `_relay_loop` discipline over a socket: freeze a
        chunk before its first send, advance only after success, send
        the terminal frame only when every chunk is out."""
        while self._running:
            with lock:
                items = list(active.items())
            if not items and reader_done.is_set():
                return
            progressed = False
            for rid, ent in items:
                stream = ent.get("stream")
                try:
                    if stream is None:
                        wire.send_frame(conn, wire.encode_reply(
                            rid, ent["seq"], [], done=True,
                            model=self.model, version=self.version,
                            error=ent["error"]))
                        with lock:
                            active.pop(rid, None)
                        progressed = True
                        continue
                    toks = stream.tokens
                    if len(toks) > ent["cursor"]:
                        end = len(toks)
                        wire.send_frame(conn, wire.encode_reply(
                            rid, ent["seq"], toks[ent["cursor"]:end],
                            done=False, model=self.model,
                            version=self.version))
                        ent["cursor"] = end
                        ent["seq"] += 1
                        progressed = True
                    if (stream._fut.done()
                            and ent["cursor"] == len(stream.tokens)):
                        exc = stream._fut.exception(timeout=0)
                        wire.send_frame(conn, wire.encode_reply(
                            rid, ent["seq"], [], done=True,
                            model=self.model, version=self.version,
                            error=exc))
                        with lock:
                            active.pop(rid, None)
                        progressed = True
                except (ConnectionError, OSError):
                    return                       # peer gone: cleanup above
            if not progressed:
                time.sleep(self.poll_s)


# =====================================================================
# replica fleet management (the autoscaler's actuator)
# =====================================================================
class ReplicaManager:
    """Grow/shrink the replica count for one model. `factory()` builds
    and starts one replica (a `ReplicaWorker`, a subprocess handle from
    `spawn_replica`, anything with `.stop()`); shrink stops the
    NEWEST replica first (the oldest carries the warmed caches and the
    longest EWMA history). `FleetAutoscaler(replicas=...)` drives this
    from the same pressure signal that scales slots."""

    def __init__(self, factory, *, min_replicas: int = 1,
                 max_replicas: int = 4):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"[{min_replicas}, {max_replicas}]")
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._replicas: List[object] = []
        self._lock = threading.Lock()

    def count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def grow(self) -> bool:
        with self._lock:
            if len(self._replicas) >= self.max_replicas:
                return False
        handle = self.factory()
        with self._lock:
            self._replicas.append(handle)
        return True

    def shrink(self) -> bool:
        with self._lock:
            if len(self._replicas) <= self.min_replicas:
                return False
            handle = self._replicas.pop()
        handle.stop()
        return True

    def scale_to(self, n: int) -> int:
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        while self.count() < n:
            if not self.grow():
                break
        while self.count() > n:
            if not self.shrink():
                break
        return self.count()

    def stop(self) -> None:
        with self._lock:
            replicas, self._replicas = self._replicas, []
        for h in replicas:
            try:
                h.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.exception("replica stop failed")


# =====================================================================
# subprocess entry
# =====================================================================
class ReplicaProcess:
    """Handle on one `spawn_replica` subprocess."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int,
                 token: str):
        self.proc = proc
        self.host, self.port, self.token = host, int(port), token

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Hard kill — the replica-death drill's murder weapon."""
        self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def spawn_replica(registry_root: str, model: str, *,
                  coordinator: Optional[str] = None,
                  version: str = "latest",
                  n_slots: int = 8, n_blocks: int = 64,
                  block_len: int = 16, steps_per_dispatch: int = 1,
                  warmup_prompt_len: Optional[int] = None,
                  warmup_tokens: int = 2,
                  token: Optional[str] = None,
                  step_floor_ms: Optional[float] = None,
                  ready_timeout_s: float = 300.0,
                  device="cuda") -> ReplicaProcess:
    """Launch one replica worker subprocess serving `model` from the
    on-disk registry on `device` (`python -m
    deeplearning4j_tpu_torch.serving.replica --device ...`); blocks until
    its READY line (a JSON {host, port, token}) arrives, under a
    watchdog that kills a child silent past `ready_timeout_s`. The JAX
    replica's `compile_cache_dir` is not taken: the kernel build cache
    of `kernels/build.py` is already shared by every process.
    `step_floor_ms` is passed as JAX's flag, which the port's replica
    refuses (its server has no emulated dispatch floor)."""
    device = resolve_device(device)
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.serving.replica",
           "--registry", str(registry_root), "--model", str(model),
           "--version", str(version), "--n-slots", str(n_slots),
           "--n-blocks", str(n_blocks), "--block-len", str(block_len),
           "--steps-per-dispatch", str(steps_per_dispatch),
           "--warmup-tokens", str(warmup_tokens), "--device", str(device)]
    if coordinator is not None:
        cmd += ["--coordinator", coordinator]
    if warmup_prompt_len is not None:
        cmd += ["--warmup-prompt-len", str(warmup_prompt_len)]
    if token is not None:
        cmd += ["--token", token]
    if step_floor_ms is not None:
        cmd += ["--step-floor-ms", str(step_floor_ms)]
    # the child imports this package from the checkout it came from,
    # whatever its working directory
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=sys.stderr, env=env, text=True)
    # readline() has no timeout of its own, and a child hung in model
    # load/warmup prints NOTHING to stdout (its logs go to stderr) —
    # a watchdog kills it at the deadline so the blocked readline
    # returns EOF instead of wedging the caller forever
    timed_out = threading.Event()

    def _watchdog():
        timed_out.set()
        proc.kill()

    watchdog = threading.Timer(ready_timeout_s, _watchdog)
    watchdog.daemon = True
    watchdog.start()
    line = ""
    try:
        while True:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("REPLICA_READY "):
                watchdog.cancel()
                if timed_out.is_set():
                    break        # READY raced the kill: already dead
                info = json.loads(line[len("REPLICA_READY "):])
                return ReplicaProcess(proc, info["host"], info["port"],
                                      info["token"])
        proc.kill()
        if timed_out.is_set():
            raise RuntimeError(
                f"replica subprocess for {model!r} did not report "
                f"ready within {ready_timeout_s}s")
        raise RuntimeError(
            f"replica subprocess for {model!r} never reported ready "
            f"(last line: {line!r})")
    finally:
        watchdog.cancel()


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="serving replica worker")
    p.add_argument("--registry", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--version", default="latest")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--token", default=None)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--n-blocks", type=int, default=64)
    p.add_argument("--block-len", type=int, default=16)
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--warmup-prompt-len", type=int, default=None)
    p.add_argument("--warmup-tokens", type=int, default=2)
    p.add_argument("--step-floor-ms", type=float, default=None,
                   help="JAX's emulated device-step floor for CPU load "
                        "tests; refused here (the server has none)")
    p.add_argument("--device", default="cuda",
                   help="where the replica serves (default: the card; "
                        "never falls back to the CPU)")
    args = p.parse_args(argv)
    if args.step_floor_ms is not None:
        p.error("--step-floor-ms: the port's GenerationServer has no "
                "emulated dispatch floor")

    # a serving worker always publishes its gauges: the coordinator
    # federation (heartbeat-piggybacked snapshots) is how the fleet
    # sees per-replica serving_replica_* load
    monitor.enable()

    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    version = (args.version if args.version == "latest"
               else int(args.version))
    net, ver = ModelRegistry(args.registry).resolve(
        args.model, version, device=args.device)
    worker = ReplicaWorker(
        net, model=args.model, version=ver, host=args.host,
        port=args.port, coordinator=args.coordinator, token=args.token,
        warmup_prompt_len=args.warmup_prompt_len,
        warmup_tokens=args.warmup_tokens, n_slots=args.n_slots,
        n_blocks=args.n_blocks, block_len=args.block_len,
        steps_per_dispatch=args.steps_per_dispatch,
        device=args.device).start()
    print(f"REPLICA_READY "
          f"{json.dumps(dict(host=worker.host, port=worker.port, token=worker.token))}",
          flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
