"""SLO objectives and burn-rate tracking for the serving plane
(counterpart of `deeplearning4j_tpu/monitor/slo.py`).

An `SLOObjective` states latency targets (TTFT and/or TPOT seconds) and
an availability target (0.99 leaves a 1% error budget). An `SLOTracker`
classifies each finished request good or bad against it and keeps a
rolling-window burn rate:

    burn_rate = (bad fraction over the window) / (1 - target)

1.0 spends the budget at exactly the sustainable rate. A shed request
counts as bad: shedding is an availability decision and spends budget.
Host-side float math only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class SLOObjective:
    """Per-model latency + availability targets.

    ttft_s / tpot_s: latency thresholds (None = don't judge that axis).
    target: fraction of requests that must be good (0 < target < 1).
    window_s: rolling window the burn rate is computed over.
    """

    __slots__ = ("ttft_s", "tpot_s", "target", "window_s")

    def __init__(self, ttft_s: Optional[float] = None,
                 tpot_s: Optional[float] = None, *,
                 target: float = 0.99, window_s: float = 60.0):
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1); got {target}")
        if ttft_s is None and tpot_s is None:
            raise ValueError("an SLO needs at least one of ttft_s/tpot_s")
        self.ttft_s = None if ttft_s is None else float(ttft_s)
        self.tpot_s = None if tpot_s is None else float(tpot_s)
        self.target = float(target)
        self.window_s = float(window_s)

    def judge(self, ttft: Optional[float],
              tpot: Optional[float]) -> bool:
        """True = good. A missing measurement on a judged axis (e.g. a
        request shed before first token) is bad."""
        if self.ttft_s is not None:
            if ttft is None or ttft > self.ttft_s:
                return False
        if self.tpot_s is not None:
            # single-token requests have no TPOT; don't judge them on it
            if tpot is not None and tpot > self.tpot_s:
                return False
        return True

    def __repr__(self):
        return (f"SLOObjective(ttft_s={self.ttft_s}, tpot_s={self.tpot_s}, "
                f"target={self.target}, window_s={self.window_s})")


class SLOTracker:
    """Rolling good/bad classifier + burn-rate for one (model, objective).

    `record(ttft=, tpot=)` / `record_shed()` per finished request;
    metric families are passed in pre-resolved by the caller (the
    serving scheduler caches them via `resolve_cached_metrics`), so the
    tracker itself stays registry-agnostic and costs two deque appends
    plus float math per request.
    """

    def __init__(self, objective: SLOObjective,
                 model: Optional[str] = None):
        self.objective = objective
        self.model = model
        self.good_total = 0
        self.bad_total = 0
        self._lock = threading.Lock()
        # (timestamp, good) pairs inside the rolling window
        self._window: deque = deque()

    # ---------------------------------------------------------- recording
    def record(self, ttft: Optional[float] = None,
               tpot: Optional[float] = None,
               now: Optional[float] = None) -> bool:
        """Classify one finished request; returns True if good."""
        good = self.objective.judge(ttft, tpot)
        self._admit(good, now)
        return good

    def record_shed(self, now: Optional[float] = None) -> bool:
        """A shed request spends error budget."""
        self._admit(False, now)
        return False

    def _admit(self, good: bool, now: Optional[float]):
        t = time.monotonic() if now is None else now
        with self._lock:
            if good:
                self.good_total += 1
            else:
                self.bad_total += 1
            self._window.append((t, good))
            self._prune(t)

    def _prune(self, now: float):
        # lock held by caller
        horizon = now - self.objective.window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    # ------------------------------------------------------------ queries
    def burn_rate(self, now: Optional[float] = None) -> float:
        """(bad fraction in window) / error budget. 0.0 when the window
        is empty."""
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            n = len(self._window)
            if n == 0:
                return 0.0
            bad = sum(1 for _, g in self._window if not g)
        return (bad / n) / (1.0 - self.objective.target)

    def window_counts(self, now: Optional[float] = None) -> Dict[str, int]:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._prune(t)
            bad = sum(1 for _, g in self._window if not g)
            return {"good": len(self._window) - bad, "bad": bad}
