"""Control-plane flight recorder: a bounded ring of the events that
explain an incident after the fact (counterpart of
`deeplearning4j_tpu/monitor/flightrec.py`).

The metrics registry answers "what is the value now"; the flight
recorder answers "what did the program DO": watchdog halts here, and
publishes, swaps, drains and autoscale decisions once the serving
planes are ported.

- **Always on.** Such events are rare and tiny, so recording does not
  go through `monitor.is_enabled()`: a run that never enabled metrics
  still leaves a usable ring.
- **Bounded.** A deque ring (default 4096) caps memory; `dropped`
  counts evictions so a dump is honest about missing history.
- **Durable (optional).** `path=` appends every event as one JSONL line
  at record time.
- **Dump on error.** `dump(path)` writes the current ring.

Pure stdlib, thread-safe.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    def __init__(self, capacity: int = 4096, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._path = path
        self._seq = 0
        #: events evicted from the ring (still in the durable log, if any)
        self.dropped = 0

    # ---------------------------------------------------------- recording
    def record(self, kind: str, **fields) -> Dict:
        """Append one event. `kind` is the event type (e.g. "swap",
        "drift_trip"); fields are JSON-friendly details."""
        ev = {"ts": time.time(), "kind": str(kind), **fields}
        line = None
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            if self._path is not None:
                line = json.dumps(ev, default=str)
        if line is not None:
            try:
                with open(self._path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass  # the recorder must never take down the control plane
        return ev

    def attach_file(self, path: Optional[str]):
        """Point (or un-point) the durable JSONL sink."""
        with self._lock:
            self._path = path

    # ------------------------------------------------------------ queries
    def events(self, kind: Optional[str] = None,
               last: Optional[int] = None) -> List[Dict]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if last is not None:
            evs = evs[-int(last):]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------- export
    def dump(self, path: Optional[str] = None) -> str:
        """Serialize the ring; write JSONL to `path` if given, return the
        text either way. Called from error paths, so it never raises on
        I/O failure."""
        evs = self.events()
        text = "\n".join(json.dumps(e, default=str) for e in evs)
        if text:
            text += "\n"
        if path is not None:
            try:
                with open(path, "w") as f:
                    f.write(text)
            except OSError:
                pass
        return text

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0


#: process-global recorder — control-plane call sites record here
GLOBAL_FLIGHT_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return GLOBAL_FLIGHT_RECORDER
