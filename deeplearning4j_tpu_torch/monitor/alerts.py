"""Declarative alert engine over the metrics substrate (counterpart of
`deeplearning4j_tpu/monitor/alerts.py`).

An `AlertRule` states what to watch; the `AlertEngine` evaluates the
rule set on demand or on a cadence over a `MetricsRegistry` snapshot (or
a federated `MetricsAggregator`, which is duck-compatible), runs each
rule through a pending -> firing -> resolved state machine with `for_s`
hysteresis, logs every transition to the `FlightRecorder` under the
rule's own event kind, and publishes an `alert_state{alert=,severity=}`
gauge family, so `/metrics` and the recorder tell the same story.

Rule kinds:

- ``threshold``  — an aggregated family value against a bound
                   (`checkpoint_last_age_seconds > 120`);
- ``absence``    — something that was there is gone: a previously seen
                   series vanishes, or (against an aggregator) a
                   previously seen worker vanishes or its export goes
                   stale past ``stale_s``;
- ``delta_rate`` — a counter's rate of increase between evaluations; an
                   optional ``unless_metric`` suppresses the breach when
                   that family also increased (a swap during a rollout),
                   and ``only_if_metric`` counts it only when that family
                   also increased (shedding a tenant is starvation only
                   while the fleet still does useful work);
- ``burn_rate``  — a gauge's windowed average against per-window bounds,
                   every window breaching (the multi-window SLO burn
                   pattern; the engine keeps the sampled history).

Evaluation is host arithmetic over a snapshot: no device work, nothing
at all when never called. `evaluate(now=)` takes an explicit clock, so
tests drive the hysteresis deterministically. `default_rule_pack()`
carries JAX's twelve rules, names, kinds, bounds and event kinds alike.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.monitor.flightrec import GLOBAL_FLIGHT_RECORDER
from deeplearning4j_tpu_torch.monitor.goodput import (
    GOODPUT_COUNTER_FAMILIES,
)

__all__ = ["AlertRule", "AlertEngine", "default_rule_pack",
           "ALERT_STATE_GAUGE", "STATE_VALUES"]

#: the tenant-starvation co-requirement family — the fleet's "still
#: moving useful tokens" signal (the goodput ledger's serving mirror).
GOODPUT_USEFUL_FAMILY = GOODPUT_COUNTER_FAMILIES["useful"]

ALERT_STATE_GAUGE = "alert_state"

#: gauge encoding of the state machine (what `/metrics` exports).
STATE_VALUES = {"ok": 0.0, "pending": 1.0, "firing": 2.0}

_KINDS = ("threshold", "absence", "delta_rate", "burn_rate")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
}


@dataclass
class AlertRule:
    """One declarative rule.  `metric=None` on an ``absence`` rule means
    worker liveness (requires an aggregator source); on every other kind
    `metric` is required."""

    name: str
    kind: str
    metric: Optional[str] = None
    labels: Dict[str, str] = field(default_factory=dict)
    op: str = ">"
    value: float = 0.0
    for_s: float = 0.0
    severity: str = "ticket"
    event_kind: str = "alert"
    description: str = ""
    aggregate: str = "max"                 # max | min | sum over series
    stale_s: Optional[float] = None        # absence: export-age bound
    unless_metric: Optional[str] = None    # delta_rate suppressor
    only_if_metric: Optional[str] = None   # delta_rate co-requirement
    windows: Tuple[Tuple[float, float], ...] = ()   # burn_rate

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown rule kind: {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown comparison op: {self.op!r}")
        if self.kind != "absence" and not self.metric:
            raise ValueError(f"rule {self.name!r}: metric is required")
        if self.kind == "burn_rate" and not self.windows:
            raise ValueError(f"rule {self.name!r}: burn_rate needs windows")


def _series_values(snap: Dict, metric: str,
                   labels: Dict[str, str]) -> List[Tuple[Tuple, float]]:
    """Matching (label-key, value) pairs for one family; label match is
    subset (a rule with no labels matches every child).  Histograms
    contribute their cumulative count."""
    fam = snap.get(metric)
    if not fam:
        return []
    out = []
    for entry in fam.get("values", ()):
        lbl = entry.get("labels") or {}
        if any(lbl.get(k) != v for k, v in labels.items()):
            continue
        v = entry.get("value")
        if v is None:
            v = entry.get("count")
        if v is None:
            continue
        try:
            v = float(v)
        except (TypeError, ValueError):
            continue
        if v != v:                       # NaN series never breach
            continue
        out.append((tuple(sorted(lbl.items())), v))
    return out


def _aggregate(vals: Sequence[float], how: str) -> Optional[float]:
    if not vals:
        return None
    if how == "sum":
        return float(sum(vals))
    if how == "min":
        return float(min(vals))
    return float(max(vals))


class AlertEngine:
    """Evaluate a rule set over a snapshot source on demand or cadence.

    `source` is anything with `.snapshot()` (a `MetricsRegistry` or a
    `MetricsAggregator`) or a zero-arg callable returning a snapshot
    dict.  Transitions go to `recorder` (the global flight recorder by
    default); `alert_state` gauges go to `registry` (the active monitor
    registry by default, skipped when monitoring is disabled).
    """

    def __init__(self, source, rules: Sequence[AlertRule] = (), *,
                 recorder=None, registry=None):
        self._source = source
        self._rules: List[AlertRule] = []
        self._recorder = recorder if recorder is not None \
            else GLOBAL_FLIGHT_RECORDER
        self._registry = registry
        self._lock = threading.Lock()
        self._states: Dict[str, Dict] = {}
        self._prev_counters: Dict[str, Tuple[float, Dict[Tuple, float]]] = {}
        self._history: Dict[str, List[Tuple[float, float]]] = {}
        self._seen_workers: set = set()
        self._seen_series: Dict[str, set] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for r in rules:
            self.add_rule(r)

    # -------------------------------------------------------------- rules
    def add_rule(self, rule: AlertRule) -> "AlertEngine":
        with self._lock:
            if any(r.name == rule.name for r in self._rules):
                raise ValueError(f"duplicate rule name: {rule.name!r}")
            self._rules.append(rule)
            self._states[rule.name] = {
                "name": rule.name, "kind": rule.kind, "metric": rule.metric,
                "severity": rule.severity, "event_kind": rule.event_kind,
                "description": rule.description, "for_s": rule.for_s,
                "state": "ok", "since": None, "fired_at": None,
                "resolved_at": None, "value": None, "context": {},
            }
        return self

    @property
    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    # ---------------------------------------------------------- snapshot
    def _snapshot(self) -> Dict:
        src = self._source
        if callable(src) and not hasattr(src, "snapshot"):
            return src() or {}
        return src.snapshot() or {}

    # ---------------------------------------------------------- evaluate
    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation pass; returns the post-pass `states()` view.
        `now` is the state-machine clock (monotonic seconds by default);
        explicit values make hysteresis deterministic in tests."""
        now = time.monotonic() if now is None else float(now)
        snap = self._snapshot()
        with self._lock:
            rules = list(self._rules)
        for rule in rules:
            breach, value, ctx = self._eval_rule(rule, snap, now)
            self._transition(rule, breach, value, ctx, now)
        self._publish_gauges()
        return self.states()

    def _eval_rule(self, rule: AlertRule, snap: Dict, now: float):
        if rule.kind == "threshold":
            pairs = _series_values(snap, rule.metric, rule.labels)
            agg = _aggregate([v for _, v in pairs], rule.aggregate)
            if agg is None:
                return False, None, {}
            return _OPS[rule.op](agg, rule.value), agg, {}

        if rule.kind == "absence":
            return self._eval_absence(rule, snap, now)

        if rule.kind == "delta_rate":
            return self._eval_delta_rate(rule, snap, now)

        # burn_rate: sample the aggregated gauge into engine history,
        # breach when EVERY (window_s, bound) pair's windowed average
        # clears its bound.
        pairs = _series_values(snap, rule.metric, rule.labels)
        agg = _aggregate([v for _, v in pairs], rule.aggregate)
        hist = self._history.setdefault(rule.name, [])
        if agg is not None:
            hist.append((now, agg))
        horizon = max(w for w, _ in rule.windows)
        while hist and hist[0][0] < now - horizon:
            hist.pop(0)
        if not hist:
            return False, agg, {}
        avgs = {}
        breach = True
        for window_s, bound in rule.windows:
            sample = [v for t, v in hist if t >= now - window_s]
            if not sample:
                breach = False
                continue
            avg = sum(sample) / len(sample)
            avgs[f"avg_{int(window_s)}s"] = avg
            if not _OPS[rule.op](avg, bound):
                breach = False
        return breach, agg, avgs

    def _eval_absence(self, rule: AlertRule, snap: Dict, now: float):
        if rule.metric is None:
            # worker liveness: a previously-seen worker label gone from
            # the aggregator, or its export stale past stale_s.
            src = self._source
            if not hasattr(src, "workers"):
                return False, None, {}
            current = set(src.workers())
            self._seen_workers |= current
            missing = sorted(self._seen_workers - current)
            stale: List[str] = []
            if rule.stale_s is not None and hasattr(src, "export_ages"):
                ages = src.export_ages()
                stale = sorted(w for w, age in ages.items()
                               if age > rule.stale_s)
            gone = sorted(set(missing) | set(stale))
            ctx = {"missing": missing, "stale": stale}
            return bool(gone), float(len(gone)), ctx
        # series absence: a previously-seen label set for this family no
        # longer exported.
        pairs = _series_values(snap, rule.metric, rule.labels)
        current = {k for k, _ in pairs}
        seen = self._seen_series.setdefault(rule.name, set())
        seen |= current
        missing = seen - current
        ctx = {"missing": [dict(k) for k in sorted(missing)]}
        return bool(missing), float(len(missing)), ctx

    def _guard_increase(self, rule_key: str, metric: str, snap: Dict,
                        now: float) -> Optional[float]:
        """Total positive increase of a companion counter family since
        the previous evaluation (None on the first sighting)."""
        gpairs = dict(_series_values(snap, metric, {}))
        gprev = self._prev_counters.get(rule_key)
        self._prev_counters[rule_key] = (now, gpairs)
        if gprev is None:
            return None
        _, gold = gprev
        return sum(max(0.0, v - gold.get(k, 0.0))
                   for k, v in gpairs.items())

    def _eval_delta_rate(self, rule: AlertRule, snap: Dict, now: float):
        pairs = dict(_series_values(snap, rule.metric, rule.labels))
        prev = self._prev_counters.get(rule.name)
        self._prev_counters[rule.name] = (now, pairs)
        guard_inc = onlyif_inc = None
        if rule.unless_metric:
            guard_inc = self._guard_increase(
                rule.name + "/unless", rule.unless_metric, snap, now)
        if rule.only_if_metric:
            onlyif_inc = self._guard_increase(
                rule.name + "/only_if", rule.only_if_metric, snap, now)
        if prev is None:
            return False, None, {}
        t0, old = prev
        dt = now - t0
        if dt <= 0:
            return False, None, {}
        inc = sum(max(0.0, v - old.get(k, 0.0)) for k, v in pairs.items())
        rate = inc / dt
        ctx = {"increase": inc, "interval_s": dt}
        if rule.unless_metric:
            ctx["unless_increase"] = guard_inc or 0.0
            if guard_inc:
                return False, rate, ctx
        if rule.only_if_metric:
            ctx["only_if_increase"] = onlyif_inc or 0.0
            if not onlyif_inc:
                return False, rate, ctx
        return _OPS[rule.op](rate, rule.value), rate, ctx

    # ----------------------------------------------------- state machine
    def _transition(self, rule: AlertRule, breach: bool, value, ctx,
                    now: float):
        with self._lock:
            st = self._states[rule.name]
            prev = st["state"]
            new = prev
            if prev == "ok" and breach:
                if rule.for_s > 0:
                    new = "pending"
                    st["since"] = now
                else:
                    new = "firing"
                    st["since"] = now
                    st["fired_at"] = now
            elif prev == "pending":
                if not breach:
                    new = "ok"
                    st["since"] = None
                elif now - st["since"] >= rule.for_s:
                    new = "firing"
                    st["fired_at"] = now
            elif prev == "firing" and not breach:
                new = "ok"
                st["since"] = None
                st["resolved_at"] = now
            st["value"] = value
            st["context"] = dict(ctx)
            changed = new != prev
            if changed:
                st["state"] = new
        if changed:
            # resolved is the firing→ok edge; pending→ok is a flap that
            # never fired.
            label = "resolved" if (prev == "firing" and new == "ok") \
                else new
            try:
                self._recorder.record(
                    rule.event_kind, alert=rule.name, state=label,
                    severity=rule.severity,
                    value=value if value is not None else float("nan"))
            except Exception:
                pass

    # ----------------------------------------------------------- outputs
    def states(self) -> List[Dict]:
        """Current rule states, most urgent first (firing, pending, ok;
        pages before tickets within a band)."""
        with self._lock:
            out = [dict(s, context=dict(s["context"]))
                   for s in self._states.values()]
        rank = {"firing": 0, "pending": 1, "ok": 2}
        sev = {"page": 0, "ticket": 1, "info": 2}
        out.sort(key=lambda s: (rank.get(s["state"], 3),
                                sev.get(s["severity"], 3), s["name"]))
        return out

    def firing(self) -> List[Dict]:
        return [s for s in self.states() if s["state"] == "firing"]

    def _publish_gauges(self):
        reg = self._registry
        if reg is None:
            from deeplearning4j_tpu_torch import monitor
            if not monitor.is_enabled():
                return
            reg = monitor.registry()
        try:
            for s in self.states():
                reg.gauge(ALERT_STATE_GAUGE, alert=s["name"],
                          severity=s["severity"]).set(
                              STATE_VALUES[s["state"]])
        except Exception:
            pass

    # ----------------------------------------------------------- cadence
    def start(self, interval_s: float = 5.0) -> "AlertEngine":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="alert-engine", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval_s: float):
        while not self._stop.wait(interval_s):
            try:
                self.evaluate()
            except Exception:
                pass

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# =====================================================================
# the default rule pack: the documented alert shapes, codified
# =====================================================================

def default_rule_pack(*, checkpoint_stale_s: float = 120.0,
                      elastic_min_processes: float = 1.0,
                      shed_rate_per_s: float = 1.0,
                      watermark_stale_s: float = 120.0,
                      slo_fast_burn: float = 14.0,
                      slo_fast_window_s: float = 60.0,
                      worker_stale_s: Optional[float] = None,
                      radix_evict_per_s: float = 5.0,
                      spec_accept_collapse: float = 0.05,
                      drift_paused_for_s: float = 120.0,
                      tenant_shed_rate_per_s: float = 1.0,
                      for_s: float = 5.0) -> List[AlertRule]:
    """The shipped rules, one per documented alert shape (the table in
    docs/OBSERVABILITY.md).  Rules over families a process never exports
    simply never match — one pack fits training-only, serving-only and
    federated deployments."""
    return [
        AlertRule(
            name="checkpoint-staleness", kind="threshold",
            metric="checkpoint_last_age_seconds", op=">",
            value=checkpoint_stale_s, severity="page",
            event_kind="checkpoint_stale",
            description="newest committed checkpoint older than the "
                        "configured bound — writes are stalling"),
        AlertRule(
            name="elastic-shrink", kind="threshold",
            metric="elastic_live_processes", op="<",
            value=elastic_min_processes, for_s=for_s, severity="page",
            event_kind="elastic_shrink",
            description="elastic membership below the provisioned fleet "
                        "size for longer than a relaunch should take"),
        AlertRule(
            name="shed-growth", kind="delta_rate",
            metric="serving_shed_total", op=">", value=shed_rate_per_s,
            aggregate="sum", severity="ticket", event_kind="shed_growth",
            description="SLO admission policy actively refusing work — "
                        "scale out or raise the objective"),
        AlertRule(
            name="registry-fallback", kind="delta_rate",
            metric="registry_resolve_fallback_total", op=">", value=0.0,
            aggregate="sum", severity="page",
            event_kind="registry_fallback",
            description="published zips failing checksum verification — "
                        "the fleet serves an older version than you "
                        "think"),
        AlertRule(
            name="watermark-lag", kind="threshold",
            metric="streaming_watermark_age_seconds", op=">",
            value=watermark_stale_s, severity="ticket",
            event_kind="watermark_lag",
            description="ingest watermark stalled — the producer "
                        "stopped (lag flat) or training fell behind "
                        "(lag rising)"),
        AlertRule(
            name="worker-vanished", kind="absence", metric=None,
            stale_s=worker_stale_s, severity="page",
            event_kind="worker_vanished",
            description="a previously-seen worker label left the "
                        "federated scrape — its publisher died"),
        AlertRule(
            name="slo-burn", kind="burn_rate", metric="slo_burn_rate",
            op=">", windows=((slo_fast_window_s, slo_fast_burn),),
            severity="page", event_kind="slo_burn",
            description="error budget burning faster than the fast-burn "
                        "page bound"),
        AlertRule(
            name="swap-without-publish", kind="delta_rate",
            metric="fleet_swaps_total", op=">", value=0.0,
            aggregate="sum", unless_metric="registry_published_total",
            severity="info", event_kind="swap_without_publish",
            description="fleet swapped servers with no matching publish "
                        "— the autoscaler is resizing (check "
                        "fleet_slot_count)"),
        AlertRule(
            name="radix-eviction-churn", kind="delta_rate",
            metric="serving_radix_evictions_total", op=">",
            value=radix_evict_per_s, aggregate="sum",
            severity="ticket", event_kind="radix_eviction_churn",
            description="radix prefix-cache nodes evicted faster than "
                        "they pay back — the pool is too small for the "
                        "working set and every admission re-prefills "
                        "what the last one cached"),
        AlertRule(
            name="sampled-spec-acceptance-collapse", kind="threshold",
            metric="serving_spec_accept_rate", op="<",
            value=spec_accept_collapse, aggregate="min",
            severity="ticket", event_kind="spec_acceptance_collapse",
            description="a speculative proposer's acceptance EWMA "
                        "collapsed — sampled streams are paying the "
                        "K-wide verify dispatch for ~1 token/dispatch "
                        "(check the proposer label; rejection-sampling "
                        "acceptance tracks draft/target divergence)"),
        AlertRule(
            name="drift-gate-stuck-paused", kind="threshold",
            metric="online_publish_paused", op=">=", value=1.0,
            aggregate="max", for_s=drift_paused_for_s,
            severity="ticket", event_kind="drift_gate_stuck",
            description="a DriftGate has held publishes paused past "
                        "the hysteresis window — the tenant's stream "
                        "shifted and stayed shifted, so its serving "
                        "adapter is frozen on stale data (check the "
                        "tag label for which tenant)"),
        AlertRule(
            name="tenant-share-starvation", kind="delta_rate",
            metric="fleet_tenant_shed_total", op=">",
            value=tenant_shed_rate_per_s, aggregate="sum",
            only_if_metric=GOODPUT_USEFUL_FAMILY,
            severity="ticket", event_kind="tenant_starvation",
            description="a tenant's shed rate is climbing while the "
                        "fleet is still moving useful tokens — a "
                        "fairness problem (heavy neighbor), not an "
                        "outage: check fleet_tenant_share against the "
                        "tenant's floor and the heavy tenant's "
                        "weight"),
    ]
