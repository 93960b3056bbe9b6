"""FleetRouter — the fleet's front-end request plane (counterpart of
`deeplearning4j_tpu/serving/router.py`).

One router fronts N named models (generation backends hosted by a
`FleetServer`, plus plain `.output()` models for the forward-serving
routes): it resolves the ACTIVE server per request — which is what
makes hot-swap invisible to clients, a submit that races the swap
pointer-flip retries against the freshly-resolved successor — applies
the admission policy, and tags every stream with the (model, version)
it was served by.

Admission policy (weighted SLO shedding across models): each model's
projected queue delay is the serving tier's existing EWMA estimator —
outstanding decode work / measured token throughput
(`GenerationServer._should_shed`'s math) — but the router compares it
against ``slo_ttft_s * weight(model)``: a weight-2 model tolerates
twice the delay a weight-1 model does, so under fleet-wide pressure
the low-priority models shed FIRST while the high-priority ones keep
admitting. `max_queue` is the per-model hard backstop before any
throughput estimate exists. Shed requests raise `ShedError` (locally)
or carry it across the wire (`wire.reply_error`).

Fair-share admission (multi-tenant floors): when the router fronts a
`TenantFleet`, model names are TENANTS of one shared base and the
device is a shared resource — a heavy tenant's flood degrades every
tenant's throughput EWMA, so the light tenant's projected delay grows
through no fault of its own and plain SLO shedding starves it.
`set_share_floor(tenant, floor)` grants a tenant a guaranteed
fraction of recently-admitted fleet work (windowed token accounting,
`share_window_s`): while its admitted share sits below the floor, the
projected-delay shed is bypassed (only its own `max_queue` backstop
applies), and any tenant consuming MORE than its weight-proportional
fair share has its budget tightened while a floored tenant is being
squeezed — the heavy tenant absorbs the shedding. Per-tenant
`tenant=`-labeled families (`fleet_tenant_shed_total`,
`fleet_tenant_admitted_tokens_total`, `fleet_tenant_share`,
`fleet_tenant_floor_admits_total`) make the division auditable.

Transport plane: `serve()` starts a pump thread consuming
`<prefix>.requests` frames from a `streaming.Transport` and a relay
thread fanning each stream's token chunks onto
`<prefix>.replies.<request_id>` — clients (`FleetClient`) hold only a
transport, never a server reference. The relay forwards per-CHUNK (the
scheduler already batches emissions per dispatch), so the transport
sees one message per decode chunk, not per token.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
from deeplearning4j_tpu_torch.monitor.reqtrace import RequestTrace
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.replica import ReplicaLostError
from deeplearning4j_tpu_torch.serving.server import (
    ServerDrainingError,
    ShedError,
    TokenStream,
)

log = logging.getLogger("deeplearning4j_tpu_torch.serving.router")


class UnknownModelError(RuntimeError):
    """Request named a model the router doesn't front."""


class FleetRouter:
    def __init__(self, fleet=None, *, slo_ttft_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None,
                 transport=None, prefix: str = "fleet",
                 poll_s: float = 0.005,
                 replica_pending_ttl_s: float = 0.75,
                 share_floors: Optional[Dict[str, float]] = None,
                 share_window_s: float = 10.0):
        self.fleet = fleet
        self.slo_ttft_s = slo_ttft_s
        self.max_queue = max_queue
        self.weights = dict(weights or {})
        # fair-share admission state: a sliding window of per-tenant
        # offered/admitted token counts. `share_floors` maps tenant ->
        # guaranteed fraction of admitted fleet work; the log is one
        # deque of (t, name, n_tokens, admitted) with running totals so
        # admitted_share() is O(expired entries), not O(window)
        self.share_floors: Dict[str, float] = {}
        self.share_window_s = float(share_window_s)
        self._share_lock = threading.Lock()
        self._share_log: deque = deque()
        self._share_admitted: Dict[str, int] = {}
        self._share_offered: Dict[str, int] = {}
        self._share_admitted_total = 0
        for k, v in (share_floors or {}).items():
            self.set_share_floor(k, v)
        self.transport = transport
        self.prefix = prefix
        self.poll_s = float(poll_s)
        self._outputs: Dict[str, object] = {}
        self._out_inflight: Dict[str, int] = {}
        self._out_lock = threading.Lock()
        # horizontal serving: one ReplicaSet per replicated model, plus
        # this router's own not-yet-absorbed token debt per replica —
        # the directory's load gauges refresh once per heartbeat, so a
        # burst submitted between refreshes must see its OWN submissions
        # or every request in the burst lands on the same "least-loaded"
        # replica. Each debt entry is [n_tokens, t_submit] and counts
        # only until the replica's next heartbeat has had time to land
        # (replica_pending_ttl_s): after that the advertised
        # outstanding_tokens gauge includes the same request, and
        # counting both halves would double-count nearly every
        # in-flight request for its whole lifetime
        self._replica_sets: Dict[str, object] = {}
        self._replica_migrations: Dict[str, int] = {}
        self._replica_pending: Dict[str, List[list]] = {}
        self._replica_lock = threading.Lock()
        self.replica_pending_ttl_s = float(replica_pending_ttl_s)
        self._metrics_cache = None
        # transport-plane threads + active remote streams
        self._running = False
        self._pump: Optional[threading.Thread] = None
        self._relay: Optional[threading.Thread] = None
        self._active: Dict[str, dict] = {}
        self._active_lock = threading.Lock()
        # shed-burst flight-recorder rate limit (≤1 event/s)
        self._shed_recent = 0
        self._shed_last_emit = 0.0

    # ------------------------------------------------------------ metrics
    def _metrics(self):
        return monitor.resolve_cached_metrics(
            self, "_metrics_cache", lambda reg: {
                "streams": lambda name: reg.counter(
                    "fleet_streams_total",
                    "generation streams routed per model", model=name),
                "shed": lambda name: reg.counter(
                    "fleet_shed_total",
                    "requests shed by the router admission policy",
                    model=name),
                "lost": lambda name: reg.counter(
                    "fleet_replica_lost_total",
                    "requests failed because no live replica could "
                    "take them", model=name),
                "outputs": lambda name: reg.counter(
                    "fleet_output_requests_total",
                    "one-shot output() requests routed per model",
                    model=name),
                "t_shed": lambda name: reg.counter(
                    "fleet_tenant_shed_total",
                    "requests shed per tenant by the fair-share "
                    "admission policy", tenant=name),
                "t_admitted": lambda name: reg.counter(
                    "fleet_tenant_admitted_tokens_total",
                    "generation tokens admitted per tenant",
                    tenant=name),
                "t_share": lambda name: reg.gauge(
                    "fleet_tenant_share",
                    "tenant's fraction of admitted fleet work over "
                    "the share window", tenant=name),
                "t_floor": lambda name: reg.counter(
                    "fleet_tenant_floor_admits_total",
                    "admissions granted under fair-share floor "
                    "protection (projected-delay shed bypassed)",
                    tenant=name),
            })

    def set_weight(self, name: str, weight: float):
        """Shedding priority: model `name` tolerates
        `slo_ttft_s * weight` of projected delay before shedding
        (weight > 1 sheds later than the fleet default, < 1 earlier)."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0; got {weight}")
        self.weights[name] = float(weight)

    # --------------------------------------------------------- fair share
    def set_share_floor(self, name: str, floor: float):
        """Guarantee tenant `name` at least `floor` (a fraction in
        [0, 1)) of the recently-admitted fleet work: while its admitted
        share sits below the floor, the projected-delay shed is
        bypassed for it (the per-tenant `max_queue` hard backstop still
        applies). The sum of all floors must stay below 1 — the fleet
        cannot guarantee more than itself."""
        floor = float(floor)
        if not 0.0 <= floor < 1.0:
            raise ValueError(f"share floor must be in [0, 1); "
                             f"got {floor}")
        others = sum(v for k, v in self.share_floors.items()
                     if k != name)
        if others + floor >= 1.0:
            raise ValueError(
                f"share floors must sum below 1.0; {name!r} at "
                f"{floor} would bring the total to {others + floor}")
        self.share_floors[name] = floor

    def _note_share(self, name: str, n_tokens: int, admitted: bool):
        """Record one routing decision in the sliding share window and
        refresh the tenant's share gauge."""
        now = time.monotonic()
        n = int(n_tokens)
        with self._share_lock:
            self._share_log.append((now, name, n, admitted))
            self._share_offered[name] = \
                self._share_offered.get(name, 0) + n
            if admitted:
                self._share_admitted[name] = \
                    self._share_admitted.get(name, 0) + n
                self._share_admitted_total += n
            self._trim_share(now)
        m = self._metrics()
        if m is not None:
            if admitted:
                m["t_admitted"](name).inc(n)
            m["t_share"](name).set(self.admitted_share(name))

    def _trim_share(self, now: float):
        """Drop window-expired entries (caller holds _share_lock)."""
        cutoff = now - self.share_window_s
        log_ = self._share_log
        while log_ and log_[0][0] < cutoff:
            _, nm, n, adm = log_.popleft()
            left = self._share_offered.get(nm, 0) - n
            if left > 0:
                self._share_offered[nm] = left
            else:
                self._share_offered.pop(nm, None)
            if adm:
                left = self._share_admitted.get(nm, 0) - n
                if left > 0:
                    self._share_admitted[nm] = left
                else:
                    self._share_admitted.pop(nm, None)
                self._share_admitted_total = max(
                    0, self._share_admitted_total - n)

    def admitted_share(self, name: str) -> float:
        """Tenant's fraction of admitted fleet tokens over the share
        window (0.0 when the window is empty)."""
        with self._share_lock:
            self._trim_share(time.monotonic())
            if self._share_admitted_total <= 0:
                return 0.0
            return (self._share_admitted.get(name, 0)
                    / self._share_admitted_total)

    def _floor_protected(self, name: str) -> bool:
        """True while `name` sits below its configured share floor —
        its projected-delay shed is bypassed (it is being squeezed by
        OTHER tenants' load on the shared device, not by itself)."""
        floor = self.share_floors.get(name)
        if floor is None:
            return False
        return self.admitted_share(name) < floor

    def _overshare_scale(self, name: str) -> float:
        """SLO-budget multiplier in (0, 1] for a tenant consuming more
        than its weight-proportional fair share WHILE some floored
        tenant with live demand is starved below its floor: the heavy
        tenant's delay budget tightens by fair/actual (floored at 1/4)
        so it sheds first and the floor-protected admissions have
        capacity to land on."""
        if not self.share_floors or self.fleet is None:
            return 1.0
        try:
            names = self.fleet.names()
        except Exception:  # noqa: BLE001 — fleet mid-teardown
            return 1.0
        if name not in names or len(names) < 2:
            return 1.0
        share = self.admitted_share(name)
        wsum = sum(self.weights.get(n, 1.0) for n in names)
        fair = (self.weights.get(name, 1.0) / wsum) if wsum > 0 else 1.0
        if share <= fair:
            return 1.0
        with self._share_lock:
            self._trim_share(time.monotonic())
            offered = dict(self._share_offered)
        starving = any(
            n != name and offered.get(n, 0) > 0
            and self.admitted_share(n) < f
            for n, f in self.share_floors.items())
        if not starving:
            return 1.0
        return max(0.25, fair / share)

    # ----------------------------------------------------------- resolve
    def _resolve(self, name: str):
        """(server, version) of the ACTIVE backend for `name` — one
        atomic read of the fleet's swap pointer."""
        if self.fleet is None or not self.fleet.has(name):
            known = ([] if self.fleet is None
                     else self.fleet.names()) + sorted(self._outputs)
            raise UnknownModelError(
                f"router fronts no generation model {name!r} "
                f"(known: {known})")
        return self.fleet.active(name)

    # ---------------------------------------------------------- shedding
    @staticmethod
    def _outstanding_tokens(server) -> int:
        """The server's own outstanding-work estimate PLUS the tokens
        owed by requests still sitting in its submit queue: the server
        computes its projection on the scheduler thread after moving
        queue items to the pending list, but the router projects from
        OUTSIDE — at submit time a just-enqueued request lives in
        `_queue`, which `server._outstanding_tokens()` cannot see.
        `queued_tokens` is the server's O(1) running counter — copying
        a 10k-deep queue under its mutex per submit would make the
        projection itself the bottleneck."""
        return server._outstanding_tokens() + server.queued_tokens

    def _should_shed(self, name: str, server) -> Optional[str]:
        depth = server.queue_depth()
        if self.max_queue is not None and depth >= self.max_queue:
            return (f"model {name!r} admission queue full "
                    f"({depth} >= max_queue {self.max_queue})")
        if self.slo_ttft_s is not None and server._ewma_tok_s:
            # the serving tier's own projected-delay estimator, scaled
            # by the model's weight — fleet-wide pressure sheds the
            # low-weight models first. A tenant past its fair share
            # while a floored tenant starves gets a TIGHTENED budget;
            # a tenant below its floor bypasses the delay shed.
            budget = (self.slo_ttft_s * self.weights.get(name, 1.0)
                      * self._overshare_scale(name))
            projected = (self._outstanding_tokens(server)
                         / server._ewma_tok_s)
            if projected > budget:
                if self._floor_protected(name):
                    m = self._metrics()
                    if m is not None:
                        m["t_floor"](name).inc()
                    return None
                return (f"model {name!r} projected delay "
                        f"{projected:.2f}s exceeds its weighted "
                        f"{budget:.2f}s TTFT budget at "
                        f"{server._ewma_tok_s:.1f} tok/s")
        return None

    # ------------------------------------------------------------ submit
    def submit(self, name: str, prompt_ids, n_tokens: int, *,
               temperature: float = 0.0, top_p: Optional[float] = None,
               rng=None,
               trace: Optional[RequestTrace] = None) -> TokenStream:
        """Route one generation request to `name`'s active server;
        returns its TokenStream tagged with ``.model``/``.version``.
        A submit racing a hot-swap's pointer flip sees the incumbent's
        `ServerDrainingError` and retries against the successor — the
        zero-dropped-streams contract covers the flip window.

        `trace` is upstream trace context (a pump-rehydrated remote
        trace); without one, the router mints the request's trace here
        — the earliest point that sees the routing decision, so a shed
        is annotated into the trace it rejected."""
        m = self._metrics()
        if trace is None and monitor.is_enabled():
            trace = RequestTrace(model=name)
        rset = self._replica_sets.get(name)
        if rset is not None:
            return self._submit_replicated(
                name, rset, prompt_ids, n_tokens, temperature=temperature,
                top_p=top_p, rng=rng, trace=trace)
        for _ in range(64):
            server, version = self._resolve(name)
            reason = self._should_shed(name, server)
            if reason is not None:
                if m is not None:
                    m["shed"](name).inc()
                    m["t_shed"](name).inc()
                if trace is not None:
                    # the router's shed decision, auditable per request
                    trace.event("shed", reason=reason, router=True)
                    trace.finish(status="shed")
                self._note_share(name, n_tokens, admitted=False)
                self._note_shed_burst(name, reason)
                raise ShedError(reason)
            try:
                stream = server.generate_async(
                    prompt_ids, n_tokens, temperature=temperature,
                    top_p=top_p, rng=rng, trace=trace)
            except ServerDrainingError:
                # swap in progress: the pointer flip happens before the
                # incumbent drains, so the next resolve sees the warmed
                # successor
                if trace is not None:
                    trace.event("drain_retry", model=name,
                                version=version)
                time.sleep(0.002)
                continue
            stream.model = name
            stream.version = version
            if trace is not None:
                trace.annotate(version=version)
            if m is not None:
                m["streams"](name).inc()
            self._note_share(name, n_tokens, admitted=True)
            return stream
        raise RuntimeError(
            f"model {name!r} stayed in draining state across retries — "
            f"is a swap stuck without a successor?")

    # ----------------------------------------------- horizontal replicas
    def attach_replicas(self, name: str, replica_set, *,
                        max_migrations: int = 3):
        """Front `name` with a horizontally-replicated backend: a
        `ReplicaSet` polling the elastic coordinator's serving
        directory. Submits to `name` now BALANCE before they shed —
        backends are ordered least-loaded first on their advertised
        gauges (projected delay = outstanding tokens / tok/s EWMA, plus
        this router's own unresolved submissions) and a request is
        refused only when EVERY live replica fails its admission check
        (queue full, or projected past the weighted SLO budget). A
        replica dying mid-stream migrates the request: nothing-received
        resubmits verbatim to any survivor, a partial stream continues
        as prompt+received with emit_start on a same-version replica —
        up to `max_migrations` hops before the typed `ReplicaLostError`
        surfaces to the caller."""
        self._replica_sets[name] = replica_set
        self._replica_migrations[name] = int(max_migrations)

    def detach_replicas(self, name: str):
        """Stop fronting `name` with replicas (the set itself is the
        caller's to close); subsequent submits fall back to the local
        fleet path."""
        self._replica_sets.pop(name, None)
        self._replica_migrations.pop(name, None)

    def replica_pending(self, token: str) -> int:
        """Tokens this router has submitted to `token` that its
        advertised gauges cannot see yet — the between-heartbeats half
        of the balance signal. An entry stops counting when its stream
        resolves OR when it outlives `replica_pending_ttl_s`: by then
        the replica's own heartbeat-refreshed `outstanding_tokens`
        covers the request, and the debt here must drop out or the
        projection counts those tokens twice."""
        now = time.monotonic()
        cutoff = now - self.replica_pending_ttl_s
        with self._replica_lock:
            entries = self._replica_pending.get(token)
            if not entries:
                return 0
            live = [e for e in entries if e[1] > cutoff]
            if len(live) != len(entries):
                if live:
                    self._replica_pending[token] = live
                else:
                    self._replica_pending.pop(token, None)
            return sum(e[0] for e in live)

    def _replica_order_key(self, backend):
        """Least-loaded ordering on the WORK gauges — outstanding
        tokens (advertised + this router's own unresolved submits),
        then queue depth — ties broken by token for stability.

        Deliberately NOT the projected-delay estimator: that divides
        by the throughput EWMA, and a freshly-warmed replica's EWMA
        comes from a 1-slot warmup dispatch — an order of magnitude
        below its full-batch rate — so delay-ordering starves exactly
        the replica that fan-out just added. Outstanding work is
        rate-free: a cold replica reads 0 and attracts traffic, which
        warms it. Projected delay stays where the SLO lives — the
        shed decision (`_replica_shed_reason`)."""
        tok, _client, meta = backend
        load = meta.get("load") or {}
        out = (int(load.get("outstanding_tokens") or 0)
               + self.replica_pending(tok))
        return (out, int(load.get("queue_depth") or 0), tok)

    def _replica_shed_reason(self, name: str, tok: str,
                             meta: dict) -> Optional[str]:
        """Per-replica admission check — `_should_shed` over advertised
        gauges instead of a live server reference."""
        load = meta.get("load") or {}
        depth = int(load.get("queue_depth") or 0)
        if self.max_queue is not None and depth >= self.max_queue:
            return (f"replica {tok} of {name!r} admission queue full "
                    f"({depth} >= max_queue {self.max_queue})")
        rate = float(load.get("ewma_tok_s") or 0.0)
        if self.slo_ttft_s is not None and rate > 0:
            out = (int(load.get("outstanding_tokens") or 0)
                   + self.replica_pending(tok))
            budget = (self.slo_ttft_s * self.weights.get(name, 1.0)
                      * self._overshare_scale(name))
            projected = out / rate
            if projected > budget:
                if self._floor_protected(name):
                    m = self._metrics()
                    if m is not None:
                        m["t_floor"](name).inc()
                    return None
                return (f"replica {tok} of {name!r} projected delay "
                        f"{projected:.2f}s exceeds its weighted "
                        f"{budget:.2f}s TTFT budget at {rate:.1f} tok/s")
        return None

    def _note_replica_submit(self, tok: str, n_tokens: int, stream):
        entry = [int(n_tokens), time.monotonic()]
        with self._replica_lock:
            self._replica_pending.setdefault(tok, []).append(entry)

        def _resolved(_f, tok=tok, entry=entry):
            with self._replica_lock:
                entries = self._replica_pending.get(tok)
                if entries is None:
                    return
                try:
                    entries.remove(entry)
                except ValueError:
                    pass                 # already expired out of view
                if not entries:
                    self._replica_pending.pop(tok, None)

        stream._fut.add_done_callback(_resolved)

    def _submit_replicated(self, name: str, rset, prompt_ids,
                           n_tokens: int, *, temperature: float,
                           top_p, rng, trace) -> "MigratingStream":
        m = self._metrics()
        prompt = np.asarray(prompt_ids)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        # mint the sampling rng HERE, not replica-side: a migrated
        # continuation must fold the SAME key at the same positions on
        # the survivor, so the key has to live with the logical stream
        if temperature and rng is None:
            rng = np.frombuffer(os.urandom(8), np.uint32).copy()
        ms = MigratingStream(
            self, name, rset, prompt, n_tokens, temperature=temperature,
            top_p=top_p, rng=rng, trace=trace,
            max_migrations=self._replica_migrations.get(name, 3))
        try:
            self._dispatch_replica(ms)
        except ShedError as e:
            if m is not None:
                m["shed"](name).inc()
                m["t_shed"](name).inc()
            if trace is not None:
                trace.event("shed", reason=str(e), router=True)
                trace.finish(status="shed")
            self._note_share(name, n_tokens, admitted=False)
            self._note_shed_burst(name, str(e))
            raise
        except ReplicaLostError as e:
            # no live replica could take it — finish the trace and
            # count it, or the failure leaks an unfinished RequestTrace
            # and stays invisible to error telemetry
            if m is not None:
                m["lost"](name).inc()
            if trace is not None:
                trace.event("replica_lost", reason=str(e), router=True)
                trace.finish(status="error",
                             error=type(e).__name__)
            raise
        if m is not None:
            m["streams"](name).inc()
        if trace is not None:
            trace.annotate(replica=ms.replica)
        self._note_share(name, n_tokens, admitted=True)
        return ms

    def _dispatch_replica(self, ms: "MigratingStream") -> None:
        """(Re)submit one logical stream to the best live replica.
        Balance-THEN-shed: candidates are tried least-loaded first and
        `ShedError` is raised only when every live one fails its
        admission check — a single overloaded replica never sheds a
        request another could serve. Called for the initial submit and
        again per migration hop (from the dead client's reader thread,
        via the attempt's done callback)."""
        ms._rset.refresh()
        name = ms.model
        committed = list(ms._committed)
        remaining = ms.n_tokens - len(committed)
        prompt = ms._prompt
        if committed:
            prompt = np.concatenate(
                [prompt, np.asarray(committed, prompt.dtype)])
        dead = set(ms._dead)
        cands = []
        for tok, client, meta in ms._rset.backends():
            if tok in dead or client.closed:
                continue
            if committed and ms._version_pin is not None \
                    and meta.get("version") is not None \
                    and int(meta["version"]) != ms._version_pin:
                # continuations must stay on their version: a partial
                # stream joined across versions would splice two
                # different models' numerics into one "stream"
                continue
            cands.append((tok, client, meta))
        if not cands:
            raise ReplicaLostError(
                f"no live replica of {name!r} can take this stream "
                f"(directory generation {ms._rset.generation}, "
                f"{len(dead)} known dead, version pin "
                f"{ms._version_pin})",
                request_id=ms.request_id, tokens=committed)
        reasons: List[str] = []
        for tok, client, meta in sorted(cands,
                                        key=self._replica_order_key):
            reason = self._replica_shed_reason(name, tok, meta)
            if reason is not None:
                reasons.append(reason)
                continue
            try:
                stream = client.submit(
                    name, prompt, remaining,
                    temperature=ms._temperature, top_p=ms._top_p,
                    rng=ms._rng, emit_start=len(committed),
                    trace_id=(None if ms.trace is None
                              else ms.trace.trace_id))
            except ReplicaLostError:
                # died between refresh and submit: same as dead in the
                # directory — move on to the next candidate
                ms._dead.append(tok)
                continue
            self._note_replica_submit(tok, remaining, stream)
            ms._bind(stream)
            return
        if reasons:
            raise ShedError(
                f"all {len(reasons)} live replicas of {name!r} are past "
                f"their admission budget — {reasons[0]}")
        raise ReplicaLostError(
            f"every live replica of {name!r} died at submit",
            request_id=ms.request_id, tokens=committed)

    def _note_shed_burst(self, name: str, reason: str):
        self._shed_recent += 1
        now = time.monotonic()
        if now - self._shed_last_emit >= 1.0:
            GLOBAL_FLIGHT_RECORDER.record(
                "shed_burst", source="router", model=name,
                count=self._shed_recent, reason=reason)
            self._shed_recent = 0
            self._shed_last_emit = now

    # ------------------------------------------------------- output plane
    def attach_output(self, name: str, model):
        """Front a plain forward model (anything with `.output(x)`) —
        the `ServingRoute` backend kind. Shares the router's naming,
        counters and max_queue backstop with the generation plane."""
        self._outputs[name] = model
        self._out_inflight.setdefault(name, 0)

    def route_output(self, name: str, x) -> np.ndarray:
        model = self._outputs.get(name)
        if model is None:
            raise UnknownModelError(
                f"router fronts no output model {name!r} "
                f"(known: {sorted(self._outputs)})")
        m = self._metrics()
        with self._out_lock:
            if (self.max_queue is not None
                    and self._out_inflight[name] >= self.max_queue):
                if m is not None:
                    m["shed"](name).inc()
                raise ShedError(
                    f"output model {name!r} has "
                    f"{self._out_inflight[name]} requests in flight "
                    f"(max_queue {self.max_queue})")
            self._out_inflight[name] += 1
        try:
            if m is not None:
                m["outputs"](name).inc()
            out = model.output(x)
            if isinstance(out, torch.Tensor):
                # one device-to-host copy: the route publishes numpy
                out = out.detach().cpu().numpy()
            return np.asarray(out)
        finally:
            with self._out_lock:
                self._out_inflight[name] -= 1

    # ------------------------------------------------------ transport plane
    def serve(self) -> "FleetRouter":
        """Start consuming `<prefix>.requests` from the transport and
        relaying token chunks to each request's reply topic."""
        if self.transport is None:
            raise ValueError("router has no transport — pass transport= "
                             "to serve the request plane")
        if self._running:
            return self
        self._running = True
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._relay = threading.Thread(target=self._relay_loop, daemon=True)
        self._pump.start()
        self._relay.start()
        return self

    def stop(self):
        self._running = False
        for t in (self._pump, self._relay):
            if t is not None:
                t.join(timeout=10)
        self._pump = self._relay = None
        # fail whatever was mid-relay so remote consumers don't hang
        with self._active_lock:
            active, self._active = self._active, {}
        for rid, ent in active.items():
            self._publish_final(rid, ent, RuntimeError(
                "FleetRouter stopped before this stream finished"))

    def _reply_topic(self, rid: str) -> str:
        return f"{self.prefix}.replies.{rid}"

    def _pump_loop(self):
        topic = f"{self.prefix}.requests"
        while self._running:
            try:
                data = self.transport.receive(topic, timeout=self.poll_s)
            except (TimeoutError, queue.Empty):
                continue
            except Exception:  # noqa: BLE001 — broker hiccup: keep serving
                log.exception("request-plane receive error (continuing)")
                time.sleep(self.poll_s)
                continue
            rid = None
            try:
                header, prompt = wire.decode_request(data)
                rid = header["request_id"]
                # rehydrate wire trace context: server-side spans land
                # under the CLIENT-minted trace id (one stitched
                # timeline per request across the wire)
                trace = None
                if header.get("trace_id") and monitor.is_enabled():
                    trace = RequestTrace(trace_id=header["trace_id"],
                                         remote=True,
                                         model=header["model"])
                stream = self.submit(
                    header["model"], prompt, header["n_tokens"],
                    temperature=header.get("temperature") or 0.0,
                    top_p=header.get("top_p"), rng=header.get("rng"),
                    trace=trace)
            except Exception as e:  # noqa: BLE001 — fail THAT request only
                if rid is not None:
                    try:
                        self.transport.send(
                            self._reply_topic(rid),
                            wire.encode_reply(rid, 0, None, done=True,
                                              error=e))
                    except Exception:  # noqa: BLE001 — the error-reply
                        # send is a broker touchpoint too: it failing
                        # must not kill the pump thread (the client
                        # times out instead — degraded, not dead)
                        log.exception("error-reply publish failed "
                                      "for %s", rid)
                else:
                    log.exception("undecodable request frame dropped")
                continue
            with self._active_lock:
                self._active[rid] = {"stream": stream, "cursor": 0,
                                     "seq": 0}

    def _relay_loop(self):
        while self._running:
            with self._active_lock:
                items = list(self._active.items())
            progressed = False
            for rid, ent in items:
                stream: TokenStream = ent["stream"]
                try:
                    # a chunk is FROZEN (tokens + seq) before its first
                    # send attempt and re-sent VERBATIM after a failed
                    # one: re-slicing the live token list under the
                    # same seq would combine with the client's seq
                    # dedup to silently drop whatever grew between the
                    # attempts
                    pend = ent.get("pending")
                    toks = stream.tokens
                    if pend is None and len(toks) > ent["cursor"]:
                        end = len(toks)
                        pend = ent["pending"] = (
                            ent["seq"], toks[ent["cursor"]:end], end)
                    if pend is not None:
                        seq, chunk, end = pend
                        self.transport.send(
                            self._reply_topic(rid),
                            wire.encode_reply(rid, seq, chunk,
                                              done=False,
                                              model=stream.model,
                                              version=stream.version))
                        # advance ONLY after a successful send
                        ent["pending"] = None
                        ent["cursor"] = end
                        ent["seq"] = seq + 1
                        progressed = True
                    # terminal frame: only once every token chunk is
                    # out, popped from _active only on a SUCCESSFUL
                    # send — the done frame is the one the client
                    # cannot make progress without, so it gets the
                    # same retry discipline as interior chunks (a
                    # transient error here retries next tick instead
                    # of stranding the client until its timeout)
                    if (stream._fut.done()
                            and ent.get("pending") is None
                            and ent["cursor"] == len(stream.tokens)):
                        exc = stream._fut.exception(timeout=0)
                        self.transport.send(
                            self._reply_topic(rid),
                            wire.encode_reply(
                                rid, ent["seq"], [], done=True,
                                model=stream.model,
                                version=stream.version, error=exc))
                        with self._active_lock:
                            self._active.pop(rid, None)
                        progressed = True
                except Exception:  # noqa: BLE001 — one stream's broker
                    # error must not kill the relay for every OTHER
                    # stream; this one retries next tick
                    log.exception("relay error for %s (will retry)",
                                  rid)
            if not progressed:
                time.sleep(self.poll_s)

    def _publish_final(self, rid: str, ent: dict,
                       exc: Optional[BaseException], tail=None):
        stream = ent["stream"]
        try:
            self.transport.send(
                self._reply_topic(rid),
                wire.encode_reply(rid, ent["seq"], tail or [], done=True,
                                  model=getattr(stream, "model", None),
                                  version=getattr(stream, "version", None),
                                  error=exc))
        except Exception:  # noqa: BLE001 — teardown must not throw
            log.exception("reply publish failed for %s", rid)


# ------------------------------------------------------- migrating stream
class MigratingStream:
    """One logical replica-served generation that SURVIVES worker death:
    wraps successive `ReplicaStream` attempts behind a single future
    face. When an attempt fails with `ReplicaLostError`, the tokens it
    delivered are committed, the dead replica is excluded, and the
    remainder resubmits through the router's balance-then-shed picker —
    verbatim to any survivor when nothing arrived, as prompt+received
    with ``emit_start`` on a same-version survivor when the stream was
    partial (the continuation contract: greedy rejoins bit-exactly,
    sampled keeps its fold_in chain because the rng key lives here, not
    on the replica). After `max_migrations` hops, or on any non-lost
    error, the failure surfaces unchanged."""

    def __init__(self, router, name: str, rset, prompt,
                 n_tokens: int, *, temperature: float = 0.0,
                 top_p=None, rng=None, trace=None,
                 max_migrations: int = 3):
        self._router = router
        self._rset = rset
        self.model = name
        self.request_id = uuid.uuid4().hex
        self._prompt = np.asarray(prompt)
        self.n_tokens = int(n_tokens)
        self._temperature = float(temperature)
        self._top_p = top_p
        self._rng = rng
        self.trace = trace
        self._fut: Future = Future()
        self._lock = threading.Lock()
        self._committed: List[int] = []
        self._cur = None
        self._dead: List[str] = []
        self._version_pin: Optional[int] = None
        self.max_migrations = int(max_migrations)
        self.migrations = 0
        self.version: Optional[int] = None
        self.replica: Optional[str] = None
        self.t_submit = time.monotonic()
        self._t_first: Optional[float] = None

    # ------------------------------------------------------------ consumer
    @property
    def tokens(self) -> List[int]:
        """Committed tokens from finished attempts plus the live
        attempt's stream so far — the one logical token list."""
        with self._lock:
            out = list(self._committed)
            cur = self._cur
        if cur is not None:
            out.extend(cur.tokens)
        return out

    @property
    def t_first(self) -> Optional[float]:
        if self._t_first is not None:
            return self._t_first
        cur = self._cur
        return None if cur is None else cur.t_first

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return np.asarray(self._fut.result(timeout), np.int32)

    # ------------------------------------------------------------ internal
    def _bind(self, stream) -> None:
        with self._lock:
            self._cur = stream
        self.replica = stream.replica
        stream._fut.add_done_callback(
            lambda _f, s=stream: self._attempt_done(s))

    def _attempt_done(self, stream) -> None:
        if self._fut.done():
            return
        if self._t_first is None and stream.t_first is not None:
            self._t_first = stream.t_first
        exc = stream._fut.exception()
        if exc is None:
            with self._lock:
                self._committed.extend(stream.tokens)
                self._cur = None
                toks = list(self._committed)
            self.version = stream.version
            if self.trace is not None:
                self.trace.finish(status="ok")
            self._fut.set_result(toks)
            return
        if (not isinstance(exc, ReplicaLostError)
                or self.migrations >= self.max_migrations):
            if self.trace is not None:
                self.trace.finish(
                    status="shed" if isinstance(exc, ShedError)
                    else "error", error=type(exc).__name__)
            self._fut.set_exception(exc)
            return
        # ------------------------------------------------- migrate
        with self._lock:
            got = list(stream.tokens)
            self._committed.extend(got)
            self._cur = None
            n_done = len(self._committed)
        if self._committed and stream.version is not None:
            # a PARTIAL stream pins its version: the continuation's
            # numerics must come from the same weights
            self._version_pin = int(stream.version)
        if stream.replica is not None:
            self._dead.append(stream.replica)
        self.migrations += 1
        if self.trace is not None:
            self.trace.event("replica_migrate", lost=stream.replica,
                             committed=n_done, hop=self.migrations)
        if n_done >= self.n_tokens:
            # the worker emitted everything before dying — only the
            # terminal frame was lost
            self.version = stream.version
            self._fut.set_result(list(self._committed))
            return
        try:
            self._router._dispatch_replica(self)
        except Exception as e:  # noqa: BLE001 — resubmit failure is
            # THIS stream's terminal error (shed, nothing live, ...)
            if self.trace is not None:
                self.trace.finish(status="error",
                                  error=type(e).__name__)
            self._fut.set_exception(e)


# ------------------------------------------------------------------ client
class RemoteTokenStream:
    """Client face of one routed generation: iterate for token chunks
    as they arrive on the reply topic, or `result()` for the full
    array. Mirrors `TokenStream`'s two faces over the transport."""

    def __init__(self, transport, topic: str, *, timeout: float = 600.0,
                 trace: Optional[RequestTrace] = None):
        self.transport = transport
        self.topic = topic
        self.timeout = float(timeout)
        self.tokens = []
        self.model = None
        self.version = None
        # client half of the stitched timeline: same trace id as the
        # server-side spans (the wire's trace_id header field)
        self.trace = trace
        self.trace_id = None if trace is None else trace.trace_id
        self._got_first = False
        self._done = False
        self._error: Optional[BaseException] = None
        self._last_seq = -1

    def _pull(self, timeout: Optional[float] = None) -> np.ndarray:
        wait = self.timeout if timeout is None else timeout
        try:
            data = self.transport.receive(self.topic, timeout=wait)
        except queue.Empty as e:
            # LocalQueueTransport signals timeout as queue.Empty;
            # normalize so remote consumers see one timeout type
            raise TimeoutError(
                f"no reply on {self.topic} within {wait}s") from e
        header, chunk = wire.decode_reply(data)
        if header.get("model") is not None:
            self.model = header["model"]
            self.version = header["version"]
        # de-duplicate by seq: the relay retries a chunk whose send
        # failed AFTER the broker durably accepted it (at-least-once
        # transports — Kafka's flush can time out post-accept), so a
        # replayed ordinal must not extend the token array twice
        seq = int(header.get("seq", 0))
        if seq > self._last_seq:
            self._last_seq = seq
            self.tokens.extend(int(t) for t in chunk)
            if len(chunk) and not self._got_first:
                self._got_first = True
                if self.trace is not None:
                    self.trace.event("first_chunk")
        else:
            chunk = chunk[:0]
        if header["done"]:
            self._done = True
            self._error = wire.reply_error(header)
            tr = self.trace
            if tr is not None:
                tr.phase("remote_stream", tr.t_created,
                         time.perf_counter(), tokens=len(self.tokens))
                err = self._error
                tr.finish(status=("shed" if isinstance(err, ShedError)
                                  else "error" if err is not None
                                  else "ok"))
            # one reply topic per request: release its transport
            # resources (queue / Kafka consumer) the moment the
            # terminal frame lands, or a long-lived client leaks one
            # per finished request
            try:
                self.transport.close(self.topic)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass
        return chunk

    def __iter__(self):
        while not self._done:
            yield from (int(t) for t in self._pull())
        if self._error is not None:
            raise self._error

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while not self._done:
            if deadline is None:
                self._pull()
            else:
                # each pull is bounded by the REMAINING deadline, not
                # the per-stream default — result(timeout=5) must
                # surface within ~5 s even when no reply ever arrives
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no terminal reply on {self.topic}")
                self._pull(timeout=min(self.timeout, remaining))
        if self._error is not None:
            raise self._error
        return np.asarray(self.tokens, np.int32)


class FleetClient:
    """Submit generation requests over a `streaming.Transport` — no
    server reference, only topics. One client may serve many threads;
    each request gets its own reply topic keyed by request id."""

    def __init__(self, transport, prefix: str = "fleet"):
        self.transport = transport
        self.prefix = prefix

    def generate(self, model: str, prompt_ids, n_tokens: int, *,
                 temperature: float = 0.0, top_p: Optional[float] = None,
                 rng=None, request_id: Optional[str] = None,
                 timeout: float = 600.0,
                 trace_id: Optional[str] = None) -> RemoteTokenStream:
        rid = request_id or uuid.uuid4().hex
        # mint trace context client-side: the id crosses the wire and
        # the router/server spans stitch under it; the client keeps its
        # own wire-level trace on the same id
        trace = None
        if monitor.is_enabled():
            trace = RequestTrace(trace_id=trace_id, model=model,
                                 remote=False)
            trace.event("wire_submit", request_id=rid)
            trace_id = trace.trace_id
        self.transport.send(
            f"{self.prefix}.requests",
            wire.encode_request(model, rid, prompt_ids, n_tokens,
                                temperature=temperature, top_p=top_p,
                                rng=rng, trace_id=trace_id))
        stream = RemoteTokenStream(self.transport,
                                   f"{self.prefix}.replies.{rid}",
                                   timeout=timeout, trace=trace)
        stream.trace_id = trace_id
        return stream
