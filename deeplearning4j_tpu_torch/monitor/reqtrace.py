"""Per-request lifecycle traces for the serving request plane
(counterpart of `deeplearning4j_tpu/monitor/reqtrace.py`).

A `RequestTrace` is a host-side accumulator: the scheduler stamps
`time.perf_counter()` phases onto it (queued, prefill, decode chunks,
preempt-requeue, drain-at-swap, shed, finish) as plain list appends,
with no lock on the hot path and no device synchronize. At `finish()`
the phases flush to the active `Tracer` in one pass on a synthetic
track per request (its tid derived from the trace id), so the Chrome
trace shows one lane per request.

The trace id crosses the wire as a header field (`serving/wire.py`),
so a remote stream and the router-side trace share one id.

A sampled-exemplar JSONL sink (`set_exemplar_sink`) keeps every Nth
finished trace.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.monitor import tracer as _tracer_mod


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _tid_for(trace_id: str) -> int:
    # a stable synthetic track id per trace, positive and away from the
    # low range of real thread idents
    try:
        return (int(trace_id[:8], 16) & 0x7FFFFFFF) | 0x40000000
    except ValueError:
        return (abs(hash(trace_id)) & 0x7FFFFFFF) | 0x40000000


class RequestTrace:
    """Host-side per-request span accumulator. Every mutator is a list
    or dict append; the flush to the Tracer and the exemplar sink
    happens once, in `finish()`."""

    __slots__ = ("trace_id", "parent_id", "remote", "model", "meta",
                 "phases", "events", "status", "t_created", "t_finished",
                 "_finished")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None, remote: bool = False,
                 model: Optional[str] = None, **meta):
        self.trace_id = trace_id or mint_trace_id()
        self.parent_id = parent_id
        self.remote = bool(remote)
        self.model = model
        self.meta: Dict = dict(meta)
        self.phases: List[Dict] = []
        self.events: List[Dict] = []
        self.status: Optional[str] = None
        self.t_created = time.perf_counter()
        self.t_finished: Optional[float] = None
        self._finished = False

    # ---------------------------------------------------------- recording
    def phase(self, name: str, t0: float, t1: float, **args):
        """One timed phase from two `time.perf_counter()` readings."""
        self.phases.append({"name": name, "t0": t0, "t1": t1,
                            "args": args})

    def event(self, name: str, **args):
        """A zero-duration marker (a shed decision, a preempt-requeue)."""
        self.events.append({"name": name, "t": time.perf_counter(),
                            "args": args})

    def annotate(self, **meta):
        self.meta.update(meta)

    # ------------------------------------------------------------- finish
    def finish(self, status: str = "ok", **args):
        """Seal the trace: flush it to the active Tracer on its own
        track and offer it to the exemplar sink. A second call is a
        no-op."""
        if self._finished:
            return
        self._finished = True
        self.status = status
        self.t_finished = time.perf_counter()
        if args:
            self.meta.update(args)
        self._flush_to_tracer()
        _offer_exemplar(self)

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def duration_s(self) -> float:
        end = (self.t_finished if self.t_finished is not None
               else time.perf_counter())
        return end - self.t_created

    def _flush_to_tracer(self):
        from deeplearning4j_tpu_torch.monitor import _STATE  # import cycle
        tr = _STATE.tracer
        if tr is None or not tr.enabled:
            return
        tid = _tid_for(self.trace_id)
        label = f"req:{self.trace_id}"
        if self.model:
            label += f" [{self.model}]"
        if self.remote:
            label += " (remote)"
        tr.set_thread_name(tid, label)
        base = {"trace_id": self.trace_id}
        if self.parent_id:
            base["parent_id"] = self.parent_id
        for p in self.phases:
            tr.complete_between(f"req/{p['name']}", p["t0"], p["t1"],
                                tid=tid, **base, **p["args"])
        for e in self.events:
            tr.complete_between(f"req/{e['name']}", e["t"], e["t"],
                                tid=tid, **base, **e["args"])
        tr.complete_between("req/lifetime", self.t_created,
                            self.t_finished, tid=tid,
                            status=self.status, **base, **self.meta)

    # ------------------------------------------------------------- export
    def to_dict(self) -> Dict:
        return {
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "remote": self.remote,
            "model": self.model,
            "status": self.status,
            "t_created": self.t_created,
            "t_finished": self.t_finished,
            "meta": dict(self.meta),
            "phases": [dict(p) for p in self.phases],
            "events": [dict(e) for e in self.events],
        }


# ------------------------------------------------- sampled-exemplar sink
_sink_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_every = 16
_sink_seen = 0


def set_exemplar_sink(path: str, sample_every: int = 16):
    """Append every `sample_every`-th finished trace to `path` as one
    JSONL line (`sample_every=1` keeps every trace)."""
    global _sink_path, _sink_every, _sink_seen
    with _sink_lock:
        _sink_path = path
        _sink_every = max(1, int(sample_every))
        _sink_seen = 0


def clear_exemplar_sink():
    global _sink_path
    with _sink_lock:
        _sink_path = None


def _offer_exemplar(trace: RequestTrace):
    global _sink_seen
    with _sink_lock:
        if _sink_path is None:
            return
        _sink_seen += 1
        if _sink_seen % _sink_every != 0:
            return
        path = _sink_path
    try:
        with open(path, "a") as f:
            f.write(json.dumps(trace.to_dict(), default=str) + "\n")
    except OSError:
        pass  # an unwritable sink must never fail a request


Tracer = _tracer_mod.Tracer
