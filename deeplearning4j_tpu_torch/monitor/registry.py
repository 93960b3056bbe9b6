"""Process-global metrics registry: counters, gauges, histograms and
timers, with the Prometheus text exposition and a JSON snapshot
(counterpart of `deeplearning4j_tpu/monitor/registry.py`).

One named, labeled metric space every layer of the port writes into.
Family names, labels and the exposition text are the JAX package's
letter for letter, so the two packages' `/metrics` pages compare line
by line. Pure stdlib: the registry imports neither torch nor anything
that touches a device.

Thread safety: one registry-level RLock guards family creation; each
child metric guards its own mutation with the same lock object (a
metric write is a few ns of float math, and one shared lock keeps
`exposition()` consistent).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    # exposition-format 0.0.4 HELP escaping: backslash and newline only
    # (no quote escaping — HELP text is not quoted)
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _unescape_label_value(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


class Counter:
    """Monotonically increasing value (one labeled child)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value; may also be backed by a callback evaluated
    lazily at exposition time (device-memory style collectors)."""

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float):
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._fn = None
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]):
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — exporter must never die
                return float("nan")
        return self._value


# default buckets: 0.1ms .. ~100s in roughly 4x steps — wide enough for
# both a short training step (sub-ms) and a kernel build (tens of
# seconds)
DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                   0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 120.0)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    def cumulative_counts(self) -> List[int]:
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class Timer(Histogram):
    """Histogram observed in seconds, with a `time()` context manager."""

    class _Ctx:
        __slots__ = ("_timer", "_t0")

        def __init__(self, timer):
            self._timer = timer

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._timer.observe(time.perf_counter() - self._t0)
            return False

    def time(self) -> "Timer._Ctx":
        return self._Ctx(self)


class _Family:
    def __init__(self, name: str, kind: str, help_text: str,
                 lock: threading.RLock, **kwargs):
        self.name = name
        self.kind = kind          # counter | gauge | histogram
        self.help = help_text
        self.kwargs = kwargs
        self._lock = lock
        self.children: Dict[_LabelKey, object] = {}

    def child(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self._lock:
            c = self.children.get(key)
            if c is None:
                if self.kind == "counter":
                    c = Counter(self._lock)
                elif self.kind == "gauge":
                    c = Gauge(self._lock)
                elif self.kind == "histogram":
                    c = Histogram(self._lock, **self.kwargs)
                else:  # timer
                    c = Timer(self._lock, **self.kwargs)
                self.children[key] = c
            return c


class MetricsRegistry:
    """Named metric families with label support + Prometheus/JSON export.

    `registry.counter("training_iterations_total", phase="fit").inc()`
    creates the family on first use and returns the labeled child; the
    same (name, labels) always maps to the same child object.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------ factories
    def _family(self, name: str, kind: str, help_text: str, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_text, self._lock, **kwargs)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._family(name, "histogram", help,
                            buckets=buckets).child(labels)

    def timer(self, name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_BUCKETS, **labels) -> Timer:
        return self._family(name, "timer", help, buckets=buckets).child(labels)

    # -------------------------------------------------------------- export
    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
            for fam in families:
                ptype = "histogram" if fam.kind == "timer" else fam.kind
                if fam.help:
                    lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {fam.name} {ptype}")
                for key, child in sorted(fam.children.items()):
                    if isinstance(child, Histogram):
                        cum = child.cumulative_counts()
                        for b, c in zip(child.buckets, cum):
                            bkey = key + (("le", _fmt_value(b)),)
                            lines.append(f"{fam.name}_bucket"
                                         f"{_fmt_labels(bkey)} {c}")
                        ikey = key + (("le", "+Inf"),)
                        lines.append(f"{fam.name}_bucket{_fmt_labels(ikey)} "
                                     f"{cum[-1]}")
                        lines.append(f"{fam.name}_sum{_fmt_labels(key)} "
                                     f"{_fmt_value(child.sum)}")
                        lines.append(f"{fam.name}_count{_fmt_labels(key)} "
                                     f"{child.count}")
                    else:
                        lines.append(f"{fam.name}{_fmt_labels(key)} "
                                     f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """JSON-friendly dump (the JSONL sink's payload)."""
        out: Dict = {}
        with self._lock:
            for name, fam in self._families.items():
                entries = []
                for key, child in fam.children.items():
                    labels = dict(key)
                    if isinstance(child, Histogram):
                        # bucket layout rides along so a federation
                        # aggregator can bucket-merge, not just sum/count
                        entries.append({"labels": labels, "sum": child.sum,
                                        "count": child.count,
                                        "buckets": list(child.buckets),
                                        "bucket_counts":
                                            list(child.bucket_counts)})
                    else:
                        entries.append({"labels": labels,
                                        "value": child.value})
                out[name] = {"type": fam.kind, "help": fam.help,
                             "values": entries}
        return out

    def dump_jsonl(self, path: str, **meta):
        """Append one snapshot line to a JSONL event log."""
        rec = {"ts": time.time(), "kind": "metrics",
               "metrics": self.snapshot(), **meta}
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
        return path

    def clear(self):
        with self._lock:
            self._families.clear()


# the process-global registry (`streamz` role); swap per-test via
# monitor.enable(registry=MetricsRegistry())
GLOBAL_REGISTRY = MetricsRegistry()
