"""Nested-span tracer with monotonic clocks and Chrome trace export
(counterpart of `deeplearning4j_tpu/monitor/tracer.py`).

Spans nest per thread, timestamps come from `time.perf_counter_ns()`
(monotonic: a clock step cannot give a negative duration), and the
whole buffer exports as Chrome trace-event JSON that loads in Perfetto
(`ui.perfetto.dev`) beside a `torch.profiler` trace of the same run.
A span times the host: work queued on the card finishes later unless
the span ends in a synchronize (the fit loop's score readback is one).

Pure stdlib, bounded memory (a ring buffer), thread-safe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "args", "thread_id", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.thread_id = threading.get_ident()
        self.start_ns = 0
        self.end_ns = 0

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def set(self, **args):
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._commit(self)
        return False


class _NoopSpan:
    """Shared do-nothing span — what a disabled tracer hands out, so hot
    paths stay allocation-free when monitoring is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Ring-buffered span recorder.

    `with tracer.span("fit/forward_backward", iteration=i): ...` records
    one complete event; nesting is positional (Perfetto reconstructs the
    stack from enclosing timestamps per thread, Chrome "X" events).
    """

    def __init__(self, max_events: int = 200_000, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._origin_ns = time.perf_counter_ns()
        self._pid = os.getpid()
        #: spans lost to ring-buffer overflow — the deque drops the
        #: OLDEST event silently, so exports must say how much history
        #: is missing or a truncated trace reads as a complete one
        self.events_dropped = 0
        # optional registry counter wired by monitor.enable()
        self._drop_counter = None

    def _note_drop(self):
        # lock held by caller; the registry RLock is taken INSIDE the
        # tracer lock (safe: the registry never calls into the tracer)
        if len(self._events) == self._events.maxlen:
            self.events_dropped += 1
            c = self._drop_counter
            if c is not None:
                c.inc()

    # ---------------------------------------------------------- recording
    def span(self, name: str, **args) -> Span:
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, args)

    def _commit(self, span: Span):
        with self._lock:
            self._note_drop()
            self._events.append({
                "name": span.name,
                "ph": "X",
                "ts": (span.start_ns - self._origin_ns) / 1e3,  # µs
                "dur": (span.end_ns - span.start_ns) / 1e3,
                "pid": self._pid,
                "tid": span.thread_id,
                "args": span.args,
            })

    def add_complete_event(self, name: str, start_s: float, duration_s: float,
                           **args):
        """Record a span timed outside the tracer (a TrainingMasterStats
        phase event): `start_s` in seconds since an epoch the caller
        keeps consistent."""
        if not self.enabled:
            return
        with self._lock:
            self._note_drop()
            self._events.append({
                "name": name, "ph": "X",
                "ts": start_s * 1e6, "dur": duration_s * 1e6,
                "pid": self._pid, "tid": threading.get_ident(),
                "args": args,
            })

    def complete_between(self, name: str, t0_perf: float, t1_perf: float,
                         tid: Optional[int] = None, **args):
        """Record a span from two `time.perf_counter()` readings (same
        monotonic clock as the tracer origin), e.g. an ETL window the
        iterator timed itself. `tid` overrides the track id."""
        if not self.enabled:
            return
        start_ns = int(t0_perf * 1e9) - self._origin_ns
        with self._lock:
            self._note_drop()
            self._events.append({
                "name": name, "ph": "X",
                "ts": start_ns / 1e3,
                "dur": max(0.0, (t1_perf - t0_perf) * 1e6),
                "pid": self._pid,
                "tid": threading.get_ident() if tid is None else int(tid),
                "args": args,
            })

    def instant(self, name: str, tid: Optional[int] = None, **args):
        """Zero-duration marker (Chrome 'i' event)."""
        if not self.enabled:
            return
        with self._lock:
            self._note_drop()
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": (time.perf_counter_ns() - self._origin_ns) / 1e3,
                "pid": self._pid,
                "tid": threading.get_ident() if tid is None else int(tid),
                "args": args,
            })

    def set_thread_name(self, tid: int, name: str):
        """Label a track (a Chrome 'M' thread_name event): how a
        request's synthetic track shows its trace id as the lane name."""
        if not self.enabled:
            return
        with self._lock:
            self._note_drop()
            self._events.append({
                "name": "thread_name", "ph": "M",
                "pid": self._pid, "tid": int(tid),
                "args": {"name": name},
            })

    # ------------------------------------------------------------ queries
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def span_names(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events():
            if ev["ph"] == "X":
                out[ev["name"]] = out.get(ev["name"], 0) + 1
        return out

    def clear(self):
        with self._lock:
            self._events.clear()
            self._origin_ns = time.perf_counter_ns()
            self.events_dropped = 0

    # ------------------------------------------------------------- export
    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Chrome trace-event JSON (object form). Loadable in Perfetto
        and `chrome://tracing`; returns the JSON string, optionally also
        writing it to `path`."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "deeplearning4j_tpu_torch.monitor",
                          "events_dropped": self.events_dropped},
        }
        text = json.dumps(doc)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def export_jsonl(self, path: str) -> str:
        """One event per line — the append-friendly event-log sink."""
        with open(path, "a") as f:
            for ev in self.events():
                f.write(json.dumps({"kind": "span", **ev}) + "\n")
        return path


GLOBAL_TRACER = Tracer(enabled=False)
