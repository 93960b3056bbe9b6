"""FleetServer: several named models from a `ModelRegistry`, each behind
its own `GenerationServer`, replaced under live traffic with no stream
dropped (counterpart of `deeplearning4j_tpu/serving/fleet.py`). A swap:

1. **Warm the successor first.** The new version's server runs the full
   `warmup()` grid (every wave width x length bucket, greedy and
   sampled) while the incumbent still takes traffic.
2. **Flip the pointer.** `active(name)` returns the successor from here
   on; the `FleetRouter` retries a submit that raced the flip.
3. **Drain the incumbent.** Its queued, never-admitted requests move to
   the successor (`export_queued`/`adopt_queued`); `drain()` closes its
   admissions and waits for the streams it already admitted, which
   finish on the old weights: each server owns its engine and its net,
   restored from its own zip, so two versions never share a tensor.
4. **Stop and unpin.** Only a drained incumbent is stopped; its pin
   lifts so retention may collect the old version.

`scale()` is the same machinery at the same version, with more slots or
blocks: what `FleetAutoscaler` fires under load, on the `fleet_*` gauge
families or the live state, on alert rules, and across replica
processes (`serving/replica.py`) once the vertical levers are at their
caps. Every server is built on the fleet's `device` (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
from deeplearning4j_tpu_torch.monitor.goodput import GOODPUT_COUNTER_FAMILIES
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.server import GenerationServer

log = logging.getLogger("deeplearning4j_tpu_torch.serving.fleet")


class _Deployment:
    __slots__ = ("name", "version", "server", "server_kw", "warm_len",
                 "warm_tokens")

    def __init__(self, name, version, server, server_kw, warm_len,
                 warm_tokens):
        self.name = name
        self.version = version
        self.server = server
        self.server_kw = server_kw
        self.warm_len = warm_len
        self.warm_tokens = warm_tokens


class FleetServer:
    """N named models from a registry, each behind its own
    `GenerationServer`, swappable under live traffic."""

    def __init__(self, registry: ModelRegistry, *,
                 gauge_interval_s: float = 0.25, device="cuda"):
        self.registry = registry
        # every deployment's net and server live here; asking for the
        # card without one raises now, not at the first deploy
        self.device = resolve_device(device)
        self.gauge_interval_s = float(gauge_interval_s)
        self._models: Dict[str, _Deployment] = {}
        self._deploying: set = set()
        # incumbents whose swap-time drain TIMED OUT: still running
        # with admissions closed (never stopped — that would drop
        # streams). Kept addressable here so `reap_retired()` can
        # finish the job once their streams end; swap() reaps at entry.
        self._retired: List[Tuple[str, int, GenerationServer]] = []
        # model names whose gauges were published at least once — how
        # publish_gauges knows which retired names still need their
        # families zeroed (a popped deployment otherwise keeps
        # exporting its last live-looking values forever)
        self._gauged: set = set()
        self._lock = threading.Lock()
        # shared-prefix registrations per model NAME: re-applied to
        # every successor a swap/scale builds, so a warmed system
        # prompt survives version flips — each application prefills
        # under the SUCCESSOR's weights, which is what keys the cache
        # on (token ids, model version) by construction
        self._prefixes: Dict[str, List] = {}
        # one RLock per model name serializing the whole
        # build→flip→drain sequence: a version swap racing an
        # autoscale resize would otherwise both replace the same
        # incumbent and leak whichever successor lost the pointer race
        # (never drained, never stopped, pin never released)
        self._swap_locks: Dict[str, threading.RLock] = {}
        self._metrics_cache = None
        self._gauge_thread: Optional[threading.Thread] = None
        self._gauge_running = False

    # ------------------------------------------------------------ queries
    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def active(self, name: str) -> Tuple[GenerationServer, int]:
        """(server, version) currently serving `name` — ONE atomic read
        of the swap pointer (the router's resolve primitive; reading
        server and version separately could straddle a flip and
        mis-tag a stream's version)."""
        with self._lock:
            d = self._models.get(name)
            if d is None:
                raise KeyError(f"no deployed model {name!r} "
                               f"(deployed: {sorted(self._models)})")
            return d.server, d.version

    def server(self, name: str) -> GenerationServer:
        return self.active(name)[0]

    def version(self, name: str) -> int:
        return self.active(name)[1]

    # ------------------------------------------------------------ metrics
    def _metrics(self):
        return monitor.resolve_cached_metrics(
            self, "_metrics_cache", self._build_metrics)

    @staticmethod
    def _build_metrics(reg):
        def g(fam, help_):
            return lambda name: reg.gauge(fam, help_, model=name)

        return {
            "active_models": reg.gauge(
                "fleet_active_models", "models the fleet is serving"),
            "version": g("fleet_model_version",
                         "registry version currently served"),
            "queue": g("fleet_queue_depth",
                       "requests awaiting admission per model"),
            "slots_active": g("fleet_active_slots",
                              "slots decoding right now per model"),
            "slots": g("fleet_slot_count",
                       "configured serving slots per model (the "
                       "autoscaler's lever)"),
            "pool_free": g("fleet_pool_blocks_free",
                           "free KV-pool blocks per model"),
            "pool_used": g("fleet_pool_blocks_used",
                           "granted KV-pool blocks per model"),
            "open": g("fleet_open_streams",
                      "streams submitted and unfinished per model"),
            "swaps": lambda name: reg.counter(
                "fleet_swaps_total",
                "zero-downtime server replacements (version swaps + "
                "autoscale resizes)", model=name),
        }

    def publish_gauges(self):
        """Push every deployment's live state onto the per-model
        `fleet_*` gauge families — the /serving page's and the
        autoscaler's signal plane. Gauges of UNDEPLOYED models are
        zeroed (version=0 marks the row retired; the /serving page and
        the autoscaler skip those) — the registry has no
        family-child removal, and stale live-looking values would show
        a retired model as still serving."""
        m = self._metrics()
        if m is None:
            return
        with self._lock:
            deployments = list(self._models.values())
            gauged = set(self._gauged)
            self._gauged.update(d.name for d in deployments)
        m["active_models"].set(len(deployments))
        live = set()
        for d in deployments:
            live.add(d.name)
            s = d.server
            m["version"](d.name).set(d.version)
            m["queue"](d.name).set(s.queue_depth())
            m["slots_active"](d.name).set(s.engine.active_slots)
            m["slots"](d.name).set(s.engine.n_slots)
            m["pool_free"](d.name).set(s.engine.pool.free_blocks)
            m["pool_used"](d.name).set(s.engine.pool.used_blocks)
            m["open"](d.name).set(s.open_streams)
        retired = gauged - live
        for name in retired:
            for fam in ("version", "queue", "slots_active", "slots",
                        "pool_free", "pool_used", "open"):
                m[fam](name).set(0)
        if retired:
            with self._lock:
                self._gauged.difference_update(retired)

    def _gauge_loop(self):
        while self._gauge_running:
            try:
                self.publish_gauges()
            except Exception:  # noqa: BLE001 — telemetry must not kill serving
                log.exception("fleet gauge publish failed (continuing)")
            time.sleep(self.gauge_interval_s)

    def _ensure_gauge_thread(self):
        if self._gauge_thread is None:
            self._gauge_running = True
            self._gauge_thread = threading.Thread(target=self._gauge_loop,
                                                  daemon=True)
            self._gauge_thread.start()

    # ------------------------------------------------------------- deploy
    def _release_version(self, name: str, version: int):
        """Release the retention pin of a no-longer-served version —
        the ONE seam swap()/undeploy()/reap_retired() go through, so a
        subclass whose versions live in a different store (the
        TenantFleet's per-tenant adapter sequence) redirects every
        release by overriding this."""
        self.registry.unpin(name, version)

    def _build_server(self, name: str, version, server_kw: dict,
                      warm_len, warm_tokens: int):
        """Resolve + warm + start one server. The target version is
        PINNED BEFORE resolve: retention GC on a concurrent publish
        must never collect the zip of a version being (or about to be)
        served — resolve-then-pin left a GC window as wide as the
        whole warmup. Pins taken here are released on failure (but
        never a pin some live deployment already held)."""
        reg = self.registry
        target = (reg.latest(name) if version == "latest"
                  else int(version))
        if target is None:
            raise FileNotFoundError(
                f"no published versions of {name!r} in the registry")
        pinned_here = []

        def pin(v):
            if (name, v) not in reg.pinned():
                reg.pin(name, v)
                pinned_here.append(v)

        pin(target)
        try:
            net, v = reg.resolve(name, version, device=self.device)
            if v != target:
                # "latest" fell back past a corrupt newest: keep the
                # version actually loaded, release the target pin
                pin(v)
                if target in pinned_here:
                    reg.unpin(name, target)
                    pinned_here.remove(target)
            # label the server's serving_* metric families: two fleet
            # deployments share one process registry and must not
            # collide on unlabeled series (callers may still override)
            server_kw = dict(server_kw)
            server_kw.setdefault("name", name)
            server = GenerationServer(net, device=self.device, **server_kw)
            # shared prefixes registered for this NAME re-apply to the
            # successor BEFORE warmup (prefill under the new weights;
            # warmup then runs the suffix-extension paths once).
            # The radix prefix cache needs NO such replay: the
            # `prefix_cache="radix"` kwarg rides server_kw through
            # swap()/scale(), and the successor's tree rebuilds itself
            # from live traffic — every admission inserts its prompt
            # blocks, so dedup resumes within one wave of repeats and
            # stale-weight K/V can never leak across a swap
            with self._lock:
                prefixes = list(self._prefixes.get(name, ()))
            for ids in prefixes:
                server.register_prefix(ids)
            if warm_len is not None:
                # the (width x bucket x variant) grid over the
                # deployment's buckets, so the first live waves on the
                # successor pay no first-call cost (kernel builds,
                # allocator growth) in their TTFT
                server.warmup(warm_len, warm_tokens)
            server.start()
            return server, v
        except Exception:
            for v_ in pinned_here:
                reg.unpin(name, v_)
            raise

    def deploy(self, name: str, version="latest", *,
               warmup_prompt_len=None,
               warmup_tokens: int = 2, **server_kw) -> int:
        """Resolve `name`@`version` from the registry, warm a server
        (skipped when `warmup_prompt_len` is None — tests), start it,
        and pin the served version against retention GC. Returns the
        version deployed. Re-deploying a live name is a `swap()`.
        `warmup_prompt_len` is a length or a ``(shortest, longest)``
        pair (`GenerationServer.warmup`); every successor a `swap()` or
        `scale()` builds is warmed with it too, before its flip."""
        # check-and-RESERVE under the lock: two concurrent deploys of
        # one name both passing an unlocked has() check would each
        # build a warmed server and the overwritten one would leak
        # started, pinned and undrained forever
        with self._lock:
            if name in self._models or name in self._deploying:
                raise ValueError(f"{name!r} is already deployed — use "
                                 f"swap() to replace it under traffic")
            self._deploying.add(name)
        try:
            server, v = self._build_server(name, version, server_kw,
                                           warmup_prompt_len,
                                           warmup_tokens)
            with self._lock:
                self._models[name] = _Deployment(
                    name, v, server, dict(server_kw), warmup_prompt_len,
                    warmup_tokens)
                self._swap_locks.setdefault(name, threading.RLock())
            # registrations that raced the build (after _build_server's
            # prefix snapshot, before the swap lock existed) re-apply
            # idempotently now that the deployment is addressable
            with self._lock:
                missed = list(self._prefixes.get(name, ()))
            for ids in missed:
                server.register_prefix(ids)
        finally:
            with self._lock:
                self._deploying.discard(name)
        self._ensure_gauge_thread()
        self.publish_gauges()
        GLOBAL_FLIGHT_RECORDER.record("deploy", model=name, version=v)
        log.info("deployed %s v%d", name, v)
        return v

    def register_prefix(self, name: str, token_ids) -> tuple:
        """Register a shared prompt prefix for model `name`: the
        ACTIVE server warms it now (copy-on-write block reuse,
        `GenerationServer.register_prefix`), and every successor a
        later `swap()`/`scale()` builds re-registers it automatically
        — re-prefilled under the successor's weights, so the cache is
        effectively keyed on (token ids, model version). Registration
        is remembered even for a not-yet-deployed name (applied at
        deploy)."""
        import numpy as np

        ids = np.asarray(token_ids)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        with self._lock:
            known = self._prefixes.setdefault(name, [])
            if not any(np.array_equal(ids, k) for k in known):
                known.append(ids)
            swap_lock = self._swap_locks.get(name)
        # serialize against swap()/scale(): a registration racing a
        # mid-build swap would otherwise apply only to the RETIRING
        # incumbent (the successor snapshotted _prefixes before this
        # entry landed) and the successor would silently serve without
        # it — waiting out the swap applies it to the live winner
        if swap_lock is not None:
            with swap_lock:
                with self._lock:
                    d = self._models.get(name)
                if d is not None:
                    return d.server.register_prefix(ids)
        return tuple(int(t) for t in ids)

    # --------------------------------------------------------------- swap
    def swap(self, name: str, version="latest", *,
             drain_timeout: float = 600.0, **server_overrides) -> int:
        """Zero-downtime replacement: warm the successor FULLY, flip
        the active pointer, drain the incumbent (its in-flight streams
        finish on the old weights), stop it, unpin the old version.
        Raises on drain timeout WITHOUT stopping the incumbent — a
        timeout must not convert into dropped streams.

        Swaps of the same name are SERIALIZED (per-name RLock): a
        version swap racing an autoscale resize must not both replace
        one incumbent — the losing successor would leak warmed,
        running and pinned forever."""
        self.reap_retired()      # finish any drain-timeout leftovers
        with self._lock:
            swap_lock = self._swap_locks.get(name)
        if swap_lock is None:
            raise KeyError(f"no deployed model {name!r} to swap")
        with swap_lock:
            with self._lock:
                d = self._models.get(name)
                if d is None:
                    raise KeyError(f"no deployed model {name!r} to swap")
                old_server, old_version = d.server, d.version
                kw = {**d.server_kw, **server_overrides}
                warm_len, warm_tokens = d.warm_len, d.warm_tokens
            successor, v = self._build_server(name, version, kw,
                                              warm_len, warm_tokens)
            with self._lock:
                d = self._models[name]
                d.server, d.version, d.server_kw = successor, v, kw
            # queued-but-unstarted requests MIGRATE to the warmed
            # successor instead of waiting out the incumbent's drain
            # behind its in-flight streams: a queued request has
            # emitted nothing, so it has no old-weights state to honor
            # — it moves wholesale (same TokenStream, same consumer
            # future) and decodes entirely on the successor. In-flight
            # streams stay put and finish on the old weights (the
            # version-parity contract).
            moved = old_server.export_queued()
            if moved:
                try:
                    successor.adopt_queued(moved)
                    # a migrated request decodes ENTIRELY on the
                    # successor, so the router's version tag must
                    # follow it — keeping the incumbent's version on
                    # the stream would break version-tagged parity
                    for item in moved:
                        st = item[0].stream
                        if getattr(st, "version", None) is not None:
                            st.version = v
                    GLOBAL_FLIGHT_RECORDER.record(
                        "swap_migrate", model=name, count=len(moved),
                        to_version=v)
                except Exception:  # noqa: BLE001 — a refusing successor
                    # must not lose the requests: put them back on the
                    # incumbent (drain below then serves them out)
                    log.exception("swap migration refused; requests "
                                  "stay on the incumbent")
                    old_server.adopt_queued(moved)
            # from here every router resolve sees the successor; the
            # incumbent only owes its already-admitted streams
            drained = old_server.drain(timeout=drain_timeout)
            if not drained:
                # keep the incumbent ADDRESSABLE: it is no longer in
                # _models (the successor is), and without this record
                # no fleet API could ever stop it or release its pin
                with self._lock:
                    self._retired.append((name, old_version,
                                          old_server))
                GLOBAL_FLIGHT_RECORDER.record(
                    "drain_timeout", model=name, version=old_version,
                    timeout_s=drain_timeout,
                    open_streams=old_server.open_streams)
                raise RuntimeError(
                    f"{name!r} incumbent (v{old_version}) did not drain "
                    f"within {drain_timeout}s — it is left running "
                    f"(admissions closed) so no stream is dropped; "
                    f"call reap_retired() once its streams finish")
            old_server.stop()
            if old_version != v:
                self._release_version(name, old_version)
        m = self._metrics()
        if m is not None:
            m["swaps"](name).inc()
        GLOBAL_FLIGHT_RECORDER.record(
            "swap", model=name, from_version=old_version, to_version=v)
        self.publish_gauges()
        log.info("swapped %s v%d -> v%d (drained clean)", name,
                 old_version, v)
        return v

    def scale(self, name: str, *, n_slots: Optional[int] = None,
              n_blocks: Optional[int] = None,
              drain_timeout: float = 600.0) -> dict:
        """Resize a deployment's serving capacity with the swap
        machinery at the SAME registry version (same weights — every
        stream keeps greedy parity across the resize). Holds the
        per-name swap lock across read-current-version + swap, so a
        concurrent version swap can't interleave and get reverted."""
        with self._lock:
            swap_lock = self._swap_locks.get(name)
        if swap_lock is None:
            raise KeyError(f"no deployed model {name!r} to scale")
        with swap_lock:             # RLock: the nested swap() re-enters
            with self._lock:
                d = self._models.get(name)
                if d is None:
                    raise KeyError(
                        f"no deployed model {name!r} to scale")
                before = {"n_slots": d.server.engine.n_slots,
                          "n_blocks": d.server.engine.pool.n_blocks}
                version = d.version
            overrides = {}
            if n_slots is not None:
                overrides["n_slots"] = int(n_slots)
            if n_blocks is not None:
                overrides["n_blocks"] = int(n_blocks)
            if not overrides:
                raise ValueError("scale() needs n_slots and/or n_blocks")
            self.swap(name, version=version,
                      drain_timeout=drain_timeout, **overrides)
            after = {"n_slots": self.server(name).engine.n_slots,
                     "n_blocks": self.server(name).engine.pool.n_blocks}
        GLOBAL_FLIGHT_RECORDER.record(
            "scale", model=name, version=version, before=before,
            after=after)
        return {"name": name, "version": version, "before": before,
                "after": after}

    # ------------------------------------------------------------ teardown
    def reap_retired(self, *, force: bool = False) -> int:
        """Finish off incumbents whose swap-time drain timed out: stop
        (and unpin) every retired server whose streams have since
        ended — or all of them with `force=True` (failing whatever is
        still in flight). Returns the number reaped. swap() calls this
        at entry, so a later swap on the same name cleans up its
        predecessor automatically."""
        with self._lock:
            retired, self._retired = self._retired, []
            live = {(d.name, d.version)
                    for d in self._models.values()}
        reaped, kept = 0, []
        for name, version, server in retired:
            if force or server.open_streams == 0:
                server.stop()
                # a same-version rescale's retiree shares its pin with
                # the LIVE deployment — never release a pin a live
                # server still needs
                if (name, version) not in live:
                    self._release_version(name, version)
                GLOBAL_FLIGHT_RECORDER.record(
                    "reap_retired", model=name, version=version,
                    forced=bool(force))
                reaped += 1
            else:
                kept.append((name, version, server))
        if kept:
            with self._lock:
                self._retired.extend(kept)
        return reaped

    def undeploy(self, name: str, *, drain: bool = True,
                 drain_timeout: float = 600.0):
        """Retire a deployment. Serialized with swap()/scale() via the
        per-name lock (an undeploy racing a mid-warmup swap would let
        the swap crash after building a successor that then leaks
        started and pinned). With `drain=True` a drain TIMEOUT raises
        and leaves the server deployed with admissions closed — the
        swap rule: a timeout must not convert into dropped streams.
        `drain=False` is the explicit force path (in-flight streams
        fail)."""
        with self._lock:
            swap_lock = self._swap_locks.get(name)
        if swap_lock is None:
            raise KeyError(f"no deployed model {name!r}")
        with swap_lock:
            with self._lock:
                d = self._models.get(name)
                if d is None:
                    raise KeyError(f"no deployed model {name!r}")
            if drain and not d.server.drain(timeout=drain_timeout):
                raise RuntimeError(
                    f"{name!r} did not drain within {drain_timeout}s — "
                    f"still deployed with admissions closed so no "
                    f"stream is dropped; retry once its streams finish "
                    f"(or undeploy(drain=False) to force)")
            with self._lock:
                self._models.pop(name, None)
            d.server.stop()
            self._release_version(name, d.version)
        GLOBAL_FLIGHT_RECORDER.record(
            "undeploy", model=name, version=d.version,
            drained=bool(drain))
        self.publish_gauges()

    def stop(self, *, drain: bool = False,
             drain_timeout: float = 600.0):
        """Stop every deployment (drain first when asked) and the
        gauge publisher. Idempotent. Each undeploy takes the per-name
        swap lock, so an in-progress swap finishes before its model is
        retired; with `drain=True`, models whose drain times out are
        LEFT RUNNING (admissions closed) and reported in one raised
        error after the rest have stopped."""
        stuck = []
        for name in self.names():
            try:
                self.undeploy(name, drain=drain,
                              drain_timeout=drain_timeout)
            except KeyError:
                pass            # undeployed concurrently
            except RuntimeError as e:
                stuck.append(str(e))
        # drain-timeout leftovers from earlier swaps: force semantics
        # match stop(drain=False); with drain=True they are only
        # reaped once their streams ended
        self.reap_retired(force=not drain)
        self._gauge_running = False
        if self._gauge_thread is not None:
            self._gauge_thread.join(timeout=10)
            self._gauge_thread = None
        self.publish_gauges()
        if stuck:
            raise RuntimeError("fleet stop left models draining: "
                               + "; ".join(stuck))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()


class FleetAutoscaler:
    """Gauge-driven capacity scaling: when a model's admission queue
    backs up or its KV pool runs low on free blocks, replace its server
    with a bigger one (`FleetServer.scale` — a warmed swap, so the
    resize drops zero streams).

    The decision inputs are the per-model `fleet_queue_depth` /
    `fleet_pool_blocks_{free,used}` gauge families on the metrics
    registry — the SAME signal plane /metrics exports (the gauges the
    ROADMAP names as the autoscaling inputs) — with a live-state
    fallback when monitoring is disabled.

    Rules-driven mode: pass `rules=` (an `monitor.alerts.AlertEngine`)
    and the pressure derivation flips from the two hardcoded thresholds
    to the declarative rule set — a FIRING alert is pressure for the
    model its rule's `model=`/`server=` label names (fleet-wide when
    unlabeled), and `goodput_low=` adds a `serving_goodput_fraction`
    floor (scale out when device work stops turning into kept tokens).
    The legacy thresholds remain the default.

    Horizontal mode: pass `replicas=` (a `serving.replica.
    ReplicaManager`) and the SAME pressure signal gains a second axis —
    when a model is under pressure but its vertical levers are at their
    caps (`max_slots`/`max_blocks`), the autoscaler GROWS the replica
    count instead (decision records carry ``action:
    "grow_replicas"``); after `replica_idle_passes` consecutive
    pressure-free passes with an empty queue it SHRINKS back toward
    `ReplicaManager.min_replicas` (newest replica first)."""

    def __init__(self, fleet: FleetServer, *,
                 queue_depth_high: int = 32,
                 pool_free_frac_low: float = 0.25,
                 factor: int = 2, max_slots: int = 64,
                 max_blocks: int = 8192, cooldown_s: float = 0.0,
                 drain_timeout: float = 600.0,
                 rules=None, goodput_low: Optional[float] = None,
                 replicas=None, replica_idle_passes: int = 4):
        self.fleet = fleet
        self.queue_depth_high = int(queue_depth_high)
        self.pool_free_frac_low = float(pool_free_frac_low)
        self.factor = int(factor)
        self.max_slots = int(max_slots)
        self.max_blocks = int(max_blocks)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout = float(drain_timeout)
        self.rules = rules
        self.goodput_low = (None if goodput_low is None
                            else float(goodput_low))
        # horizontal axis: a ReplicaManager (or anything with
        # count/grow/shrink) — None keeps the vertical-only behavior
        self.replicas = replicas
        self.replica_idle_passes = int(replica_idle_passes)
        self._idle_passes: Dict[str, int] = {}
        self._last_scaled: Dict[str, float] = {}
        self.decisions: List[dict] = []
        self._watch: Optional[threading.Thread] = None
        self._watching = False

    # ------------------------------------------------------------- signal
    def _signal(self, name: str, snap: Optional[dict] = None
                ) -> Optional[dict]:
        """{queue_depth, pool_free, pool_used, n_slots} for `name`,
        read from the gauge families when monitoring is on. `snap` is
        a registry snapshot shared across one check() pass — one copy
        per pass, not one per model (snapshot copies every family
        under the registry lock the hot serving counters contend on)."""
        if monitor.is_enabled():
            if snap is None:
                snap = monitor.registry().snapshot()

            def val(fam):
                for e in (snap.get(fam) or {}).get("values", []):
                    if e.get("labels", {}).get("model") == name:
                        return e.get("value")
                return None

            sig = {"queue_depth": val("fleet_queue_depth"),
                   "pool_free": val("fleet_pool_blocks_free"),
                   "pool_used": val("fleet_pool_blocks_used"),
                   "n_slots": val("fleet_slot_count")}
            if all(v is not None for v in sig.values()):
                return sig
            # gauges not published yet — fall through to live state
        try:
            server = self.fleet.server(name)
        except KeyError:
            return None
        return {"queue_depth": server.queue_depth(),
                "pool_free": server.engine.pool.free_blocks,
                "pool_used": server.engine.pool.used_blocks,
                "n_slots": server.engine.n_slots}

    def _goodput(self, name: str, snap: Optional[dict]) -> Optional[float]:
        """The model's `serving_goodput_fraction` (by its `server=`
        label) from the shared snapshot, falling back to the live
        ledger when monitoring is off.  Returns None until the server
        has dispatched NON-warmup work — a warmed-but-idle server's
        0.0 fraction is absence of traffic, not waste, and must not
        read as scale-out pressure."""
        if snap is not None:
            frac = None
            for e in (snap.get("serving_goodput_fraction")
                      or {}).get("values", []):
                if e.get("labels", {}).get("server") == name:
                    frac = e.get("value")
            if frac is not None:
                served = 0.0
                for cls, fam in GOODPUT_COUNTER_FAMILIES.items():
                    if cls == "warmup":
                        continue
                    for e in (snap.get(fam) or {}).get("values", []):
                        if e.get("labels", {}).get("server") == name:
                            served += e.get("value") or 0.0
                return frac if served > 0 else None
        try:
            server = self.fleet.server(name)
        except KeyError:
            return None
        lg = server.engine.goodput
        if lg.dispatched_total - lg.classes["warmup"] <= 0:
            return None
        return lg.goodput_fraction()

    def _rules_pressure(self, name: str, snap: Optional[dict],
                        states: List[dict]) -> List[str]:
        """Rules-mode pressure: firing alerts targeting this model (or
        fleet-wide), plus the optional goodput floor.  `states` is one
        evaluation shared across the whole check() pass — delta-rate
        rules need real intervals between evaluations."""
        pressure = []
        by_name = {r.name: r for r in self.rules.rules}
        for s in states:
            if s["state"] != "firing":
                continue
            rule = by_name.get(s["name"])
            target = None
            if rule is not None:
                target = (rule.labels.get("model")
                          or rule.labels.get("server"))
            if target in (None, name):
                pressure.append(f"alert {s['name']} firing "
                                f"({s['severity']})")
        if self.goodput_low is not None:
            gp = self._goodput(name, snap)
            if gp is not None and gp < self.goodput_low:
                pressure.append(f"goodput fraction {gp:.2f} < "
                                f"{self.goodput_low}")
        return pressure

    # -------------------------------------------------------------- check
    def check(self, names: Optional[List[str]] = None) -> List[dict]:
        """Evaluate (and execute) scale-up decisions; returns the
        decision records made this pass (also appended to
        ``self.decisions`` for the evidence ledger)."""
        snap = (monitor.registry().snapshot()
                if monitor.is_enabled() else None)
        rule_states = (self.rules.evaluate()
                       if self.rules is not None else None)
        made = []
        for name in (names or self.fleet.names()):
            sig = self._signal(name, snap)
            if sig is None:
                continue
            last = self._last_scaled.get(name, 0.0)
            if time.monotonic() - last < self.cooldown_s:
                continue
            if self.rules is not None:
                pressure = self._rules_pressure(name, snap, rule_states)
            else:
                total = sig["pool_free"] + sig["pool_used"]
                free_frac = sig["pool_free"] / total if total else 1.0
                pressure = []
                if sig["queue_depth"] > self.queue_depth_high:
                    pressure.append(
                        f"queue_depth {sig['queue_depth']:.0f} > "
                        f"{self.queue_depth_high}")
                if free_frac < self.pool_free_frac_low:
                    pressure.append(
                        f"pool free fraction {free_frac:.2f} < "
                        f"{self.pool_free_frac_low}")
            if not pressure:
                rec = self._maybe_shrink_replicas(name, sig)
                if rec is not None:
                    made.append(rec)
                continue
            self._idle_passes[name] = 0
            server = self.fleet.server(name)
            cur_slots = server.engine.n_slots
            cur_blocks = server.engine.pool.n_blocks
            new_slots = min(cur_slots * self.factor, self.max_slots)
            new_blocks = min(cur_blocks * self.factor, self.max_blocks)
            if new_slots <= cur_slots and new_blocks <= cur_blocks:
                # vertical levers at their caps: go HORIZONTAL — add a
                # replica process (the router's least-loaded balancing
                # spreads traffic onto it as soon as it registers)
                rec = self._grow_replicas(name, sig, pressure)
                if rec is not None:
                    made.append(rec)
                continue
            rec = self.fleet.scale(
                name, n_slots=new_slots, n_blocks=new_blocks,
                drain_timeout=self.drain_timeout)
            rec["reason"] = "; ".join(pressure)
            rec["signal"] = sig
            self._last_scaled[name] = time.monotonic()
            self.decisions.append(rec)
            GLOBAL_FLIGHT_RECORDER.record(
                "autoscale", model=name, before=rec["before"],
                after=rec["after"], reason=rec["reason"])
            made.append(rec)
            log.info("autoscaled %s: %s -> %s (%s)", name,
                     rec["before"], rec["after"], rec["reason"])
        return made

    # ------------------------------------------------- horizontal scaling
    def _grow_replicas(self, name: str, sig: dict,
                       pressure: List[str]) -> Optional[dict]:
        if self.replicas is None or not self.replicas.grow():
            return None            # no manager, or at max_replicas
        rec = {"name": name, "action": "grow_replicas",
               "replicas": self.replicas.count(),
               "reason": "; ".join(pressure), "signal": sig}
        self._last_scaled[name] = time.monotonic()
        self.decisions.append(rec)
        GLOBAL_FLIGHT_RECORDER.record(
            "autoscale", model=name, action="grow_replicas",
            replicas=rec["replicas"], reason=rec["reason"])
        log.info("autoscaled %s horizontally: %d replicas (%s)", name,
                 rec["replicas"], rec["reason"])
        return rec

    def _maybe_shrink_replicas(self, name: str,
                               sig: dict) -> Optional[dict]:
        """No pressure this pass: one idle tick toward shrinking. Only
        a run of `replica_idle_passes` pressure-free passes WITH an
        empty admission queue releases a replica — a single quiet
        sample between bursts must not thrash the fleet."""
        if self.replicas is None:
            return None
        if (sig.get("queue_depth") or 0) > 0:
            self._idle_passes[name] = 0
            return None
        n = self._idle_passes.get(name, 0) + 1
        self._idle_passes[name] = n
        if n < self.replica_idle_passes:
            return None
        self._idle_passes[name] = 0
        if not self.replicas.shrink():
            return None            # already at min_replicas
        rec = {"name": name, "action": "shrink_replicas",
               "replicas": self.replicas.count(),
               "reason": f"idle for {n} consecutive passes",
               "signal": sig}
        self._last_scaled[name] = time.monotonic()
        self.decisions.append(rec)
        GLOBAL_FLIGHT_RECORDER.record(
            "autoscale", model=name, action="shrink_replicas",
            replicas=rec["replicas"], reason=rec["reason"])
        log.info("autoscaled %s horizontally: %d replicas (%s)", name,
                 rec["replicas"], rec["reason"])
        return rec

    # -------------------------------------------------------------- watch
    def start(self, interval_s: float = 0.5) -> "FleetAutoscaler":
        if self._watch is not None:
            return self
        self._watching = True

        def loop():
            while self._watching:
                try:
                    self.check()
                except Exception:  # noqa: BLE001 — scaling must not crash serving
                    log.exception("autoscaler pass failed (continuing)")
                time.sleep(interval_s)

        self._watch = threading.Thread(target=loop, daemon=True)
        self._watch.start()
        return self

    def stop(self):
        self._watching = False
        if self._watch is not None:
            self._watch.join(timeout=10)
            self._watch = None
