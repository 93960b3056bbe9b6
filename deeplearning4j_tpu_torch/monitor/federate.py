"""Fleet telemetry federation: many worker registries, one /metrics view
(counterpart of `deeplearning4j_tpu/monitor/federate.py`).

- `export_snapshot(registry, worker)`: one worker's labelled snapshot, a
  JSON-friendly dict whose histograms carry their bucket layout, so the
  merge is a bucket merge and not a lossy sum/count.
- `MetricsAggregator`: ingests worker exports (the last snapshot per
  worker wins) and renders one exposition: every series relabelled with
  `worker=<name>`, plus the cross-worker merge without that label
  (counters summed, gauges last-write by snapshot time, histograms
  bucket-merged when the layouts match).
- `FederationPublisher` / `FederationCollector`: the push pipe over any
  transport with `send`/`receive` of bytes (the port's
  `streaming.ndarray` transports: a local queue in tests, Kafka in a
  fleet).
- The elastic hook: training workers ride the heartbeat's info channel
  (`parallel.elastic.ElasticClient.federate_metrics`), and
  `ingest_elastic_status` lifts member info out of a coordinator
  `status()` into an aggregator.

Pure host code; the names, payload keys and exposition text are JAX's,
so either package's aggregator ingests the other's exports.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.monitor.registry import (
    MetricsRegistry,
    _escape_help,
    _fmt_labels,
    _fmt_value,
    _label_key,
)


def export_snapshot(registry: MetricsRegistry, worker: str) -> Dict:
    """One worker's federation payload."""
    return {"worker": str(worker), "ts": time.time(),
            "metrics": registry.snapshot()}


def _exposition_lines(name: str, kind: str, entry: Dict,
                      extra_labels: Dict[str, str]) -> List[str]:
    """One snapshot entry (a single labelled child) as exposition lines,
    with `extra_labels` merged in."""
    labels = dict(entry.get("labels") or {})
    labels.update(extra_labels)
    key = _label_key(labels)
    lines: List[str] = []
    if kind in ("histogram", "timer"):
        buckets = entry.get("buckets")
        counts = entry.get("bucket_counts")
        if buckets is not None and counts is not None:
            acc = 0
            for b, c in zip(buckets, counts):
                acc += c
                bkey = key + (("le", _fmt_value(b)),)
                lines.append(f"{name}_bucket{_fmt_labels(bkey)} {acc}")
            acc += counts[-1] if len(counts) > len(buckets) else 0
            ikey = key + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_fmt_labels(ikey)} {acc}")
        lines.append(f"{name}_sum{_fmt_labels(key)} "
                     f"{_fmt_value(entry.get('sum', 0.0))}")
        lines.append(f"{name}_count{_fmt_labels(key)} "
                     f"{int(entry.get('count', 0))}")
    else:
        lines.append(f"{name}{_fmt_labels(key)} "
                     f"{_fmt_value(entry.get('value', 0.0))}")
    return lines


def _merge_entry(slot: Dict, entry: Dict, ts: float):
    """Fold one worker's entry into the family's merge, keyed by its
    label set."""
    lkey = _label_key(entry.get("labels") or {})
    m = slot["_merge"].get(lkey)
    kind = slot["type"]
    if kind == "counter":
        if m is None:
            m = {"labels": dict(entry.get("labels") or {}), "value": 0.0}
            slot["_merge"][lkey] = m
        m["value"] += float(entry.get("value", 0.0))
    elif kind in ("histogram", "timer"):
        if m is None:
            m = {"labels": dict(entry.get("labels") or {}),
                 "sum": 0.0, "count": 0,
                 "buckets": entry.get("buckets"),
                 "bucket_counts": (list(entry["bucket_counts"])
                                   if entry.get("bucket_counts") else None)}
            slot["_merge"][lkey] = m
        elif (m.get("buckets") is not None
                and entry.get("buckets") == m["buckets"]
                and entry.get("bucket_counts")):
            m["bucket_counts"] = [a + b for a, b in
                                  zip(m["bucket_counts"],
                                      entry["bucket_counts"])]
        else:
            # the layouts differ: degrade to sum/count
            m["buckets"] = None
            m["bucket_counts"] = None
        m["sum"] += float(entry.get("sum", 0.0))
        m["count"] += int(entry.get("count", 0))
    elif m is None or ts >= m["_ts"]:
        # gauge: the newest snapshot's write wins
        slot["_merge"][lkey] = {"labels": dict(entry.get("labels") or {}),
                                "value": entry.get("value", 0.0), "_ts": ts}


class MetricsAggregator:
    """Merge worker snapshots into one exposition.

    Duck-compatible with the part of `MetricsRegistry` a `/metrics`
    route and the alert engine read (`exposition()`, `snapshot()`)."""

    def __init__(self):
        self._lock = threading.Lock()
        # worker -> {"ts": float, "metrics": snapshot dict}
        self._exports: Dict[str, Dict] = {}

    # ------------------------------------------------------------- ingest
    def ingest(self, export) -> str:
        """Absorb one `export_snapshot` payload (a dict, or its JSON as
        str or bytes); the last snapshot per worker wins (by the
        export's ts). Returns the worker name."""
        if isinstance(export, (bytes, bytearray)):
            export = export.decode("utf-8")
        if isinstance(export, str):
            export = json.loads(export)
        worker = str(export["worker"])
        ts = float(export.get("ts", time.time()))
        with self._lock:
            prev = self._exports.get(worker)
            if prev is None or ts >= prev["ts"]:
                self._exports[worker] = {"ts": ts,
                                         "metrics": export["metrics"]}
        return worker

    def ingest_registry(self, registry: MetricsRegistry, worker: str) -> str:
        return self.ingest(export_snapshot(registry, worker))

    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._exports)

    def export_ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """Seconds since each worker's last ingested export (by the
        export's own `time.time()` stamp): the scrape side's liveness
        signal, which the worker-vanished alert rule reads."""
        now = time.time() if now is None else float(now)
        with self._lock:
            return {w: max(0.0, now - e["ts"])
                    for w, e in self._exports.items()}

    def drop_worker(self, worker: str) -> bool:
        """Forget one worker's export (a deliberate decommission: its
        series leave `/metrics` instead of going stale)."""
        with self._lock:
            return self._exports.pop(str(worker), None) is not None

    def clear(self):
        with self._lock:
            self._exports.clear()

    # -------------------------------------------------------------- merge
    def _merged_families(self) -> Dict[str, Dict]:
        """family name -> {"type", "help", "per_worker": [(worker,
        entry)], "merged": [entry]}, the merged entries keyed by the
        original label set (see `_merge_entry`)."""
        with self._lock:
            exports = {w: dict(e) for w, e in self._exports.items()}
        fams: Dict[str, Dict] = {}
        for worker in sorted(exports):
            ts = exports[worker]["ts"]
            for name, fam in exports[worker]["metrics"].items():
                slot = fams.setdefault(
                    name, {"type": fam.get("type", "gauge"),
                           "help": fam.get("help", ""),
                           "per_worker": [], "_merge": {}})
                if fam.get("help") and not slot["help"]:
                    slot["help"] = fam["help"]
                for entry in fam.get("values", ()):
                    slot["per_worker"].append((worker, entry))
                    _merge_entry(slot, entry, ts)
        for slot in fams.values():
            merged = []
            for lkey in sorted(slot["_merge"]):
                e = dict(slot["_merge"][lkey])
                e.pop("_ts", None)
                if e.get("buckets") is None:
                    e.pop("buckets", None)
                    e.pop("bucket_counts", None)
                merged.append(e)
            slot["merged"] = merged
            del slot["_merge"]
        return fams

    # ------------------------------------------------------------- export
    def exposition(self) -> str:
        """Prometheus text 0.0.4: per-worker series carry `worker=`
        labels; the merged series carry none."""
        lines: List[str] = []
        fams = self._merged_families()
        for name in sorted(fams):
            slot = fams[name]
            ptype = "histogram" if slot["type"] == "timer" else slot["type"]
            if slot["help"]:
                lines.append(f"# HELP {name} {_escape_help(slot['help'])}")
            lines.append(f"# TYPE {name} {ptype}")
            for worker, entry in slot["per_worker"]:
                lines.extend(_exposition_lines(
                    name, slot["type"], entry, {"worker": worker}))
            for entry in slot["merged"]:
                lines.extend(_exposition_lines(name, slot["type"],
                                               entry, {}))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """The merged cross-worker view in `MetricsRegistry.snapshot()`'s
        shape."""
        out: Dict = {}
        for name, slot in self._merged_families().items():
            out[name] = {"type": slot["type"], "help": slot["help"],
                         "values": [dict(e) for e in slot["merged"]]}
        return out


# =====================================================================
# the transport pipe
# =====================================================================
class FederationPublisher:
    """Push side: serialize this process's registry onto a transport
    topic, once or on a daemon interval."""

    def __init__(self, transport, topic: str, worker: str,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0):
        self.transport = transport
        self.topic = topic
        self.worker = str(worker)
        self._registry = registry
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.published_total = 0

    def _resolve_registry(self) -> MetricsRegistry:
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch import monitor
        return monitor.registry()

    def publish_once(self):
        payload = json.dumps(
            export_snapshot(self._resolve_registry(), self.worker),
            default=str).encode("utf-8")
        self.transport.send(self.topic, payload)
        self.published_total += 1

    def start(self) -> "FederationPublisher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"fed-pub-{self.worker}")
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.publish_once()
            except Exception:  # noqa: BLE001 — telemetry must not crash
                pass

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.interval_s + 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class FederationCollector:
    """Pull side: drain exports off the topic into an aggregator."""

    def __init__(self, transport, topic: str,
                 aggregator: Optional[MetricsAggregator] = None):
        self.transport = transport
        self.topic = topic
        self.aggregator = aggregator or MetricsAggregator()
        self.ingested_total = 0

    def poll(self, timeout: float = 0.05, max_msgs: int = 1000) -> int:
        """Ingest up to `max_msgs` waiting exports; returns how many."""
        n = 0
        for _ in range(int(max_msgs)):
            try:
                payload = self.transport.receive(self.topic, timeout)
            except Exception:  # noqa: BLE001 — queue.Empty / TimeoutError
                break
            self.aggregator.ingest(payload)
            self.ingested_total += 1
            n += 1
        return n


# =====================================================================
# the elastic heartbeat hook
# =====================================================================
def ingest_elastic_status(status: Dict,
                          aggregator: MetricsAggregator) -> int:
    """Lift federated metrics out of an `ElasticCoordinator.status()`
    view: each member whose heartbeat info carries a `"metrics"` export
    (`ElasticClient.federate_metrics`) is ingested. Returns how many
    members contributed."""
    n = 0
    for _token, member in (status.get("members") or {}).items():
        export = (member.get("info") or {}).get("metrics")
        if export:
            aggregator.ingest(export)
            n += 1
    return n
