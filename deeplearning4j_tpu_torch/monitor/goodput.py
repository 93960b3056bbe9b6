"""Token-goodput ledger: every dispatched token-position in one class
(counterpart of `deeplearning4j_tpu/monitor/goodput.py`).

The engine dispatches fixed shapes: waves padded to power-of-two widths
and length buckets, decode chunks over every slot, speculative lanes
that may be rejected. `serving_tokens_total` counts only what was
emitted; the ledger says how many of the token-positions paid for
produced a token a user kept. Each dispatch site of
`serving/engine.py` classifies its token-positions into one of six
classes:

- ``useful``: prefilled a live prompt or emitted a kept token;
- ``spec_rejected``: valid draft positions the target rejected, and the
  truncated drafter's pass;
- ``pad_waste``: padding to wave widths and length buckets, idle lanes;
- ``warmup``: everything dispatched inside `warmup()`;
- ``preempt_discard``: the re-prefill of a preempted continuation;
- ``drain``: positions dispatched while the server drains.

Conservation holds by construction: `account()` adds to
`dispatched_total` the sum it distributes, so ``sum(classes) ==
dispatched_total`` always. The counters are host ints from values the
engine already holds on the host: the ledger adds no device copy.

Modes: `set_mode("warmup")` / `set_mode("drain")` route all later
accounting into that class; rerouting at account time keeps every
counter monotone.

`ttft_decomposition(trace)` splits a finished request's TTFT into
queue wait, prefill and first emit from the stamps `RequestTrace`
already holds.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["GOODPUT_CLASSES", "GoodputLedger", "ttft_decomposition",
           "GOODPUT_COUNTER_FAMILIES", "GOODPUT_FRACTION_GAUGE"]

GOODPUT_CLASSES = ("useful", "spec_rejected", "pad_waste", "warmup",
                   "preempt_discard", "drain")

#: registry family names the serving mirror publishes (one counter per
#: class plus the rolling fraction gauge) — single source of truth for
#: server.py, the loadtest ledger and the verify smoke.
GOODPUT_COUNTER_FAMILIES = {
    c: f"serving_tokens_{c}_total" for c in GOODPUT_CLASSES
}
GOODPUT_FRACTION_GAUGE = "serving_goodput_fraction"


class GoodputLedger:
    """Host-side token-position accounting for one engine.

    Thread-safety: all mutation happens on the scheduler thread (the
    same thread that runs every dispatch), reads from other threads see
    at worst a value one dispatch old — same contract as the engine's
    other host counters.
    """

    __slots__ = ("dispatched_total", "classes", "_mode")

    def __init__(self):
        self.dispatched_total = 0
        self.classes: Dict[str, int] = {c: 0 for c in GOODPUT_CLASSES}
        self._mode: Optional[str] = None

    # ------------------------------------------------------------- mode
    def set_mode(self, mode: Optional[str]):
        """Route ALL subsequent accounting into `mode` ("warmup" /
        "drain"), or back to per-class accounting (None)."""
        if mode is not None and mode not in ("warmup", "drain"):
            raise ValueError(f"unknown ledger mode: {mode!r}")
        self._mode = mode

    @property
    def mode(self) -> Optional[str]:
        return self._mode

    # ------------------------------------------------------- accounting
    def account(self, *, useful: int = 0, spec_rejected: int = 0,
                pad_waste: int = 0, preempt_discard: int = 0):
        """Classify one dispatch's token-positions.  The sum of the
        keyword arguments IS the dispatch total — there is no separate
        total to drift from, so conservation cannot break."""
        total = useful + spec_rejected + pad_waste + preempt_discard
        if total <= 0:
            return
        if min(useful, spec_rejected, pad_waste, preempt_discard) < 0:
            raise ValueError("goodput classes must be non-negative")
        if self._mode is not None:
            self.classes[self._mode] += total
        else:
            self.classes["useful"] += useful
            self.classes["spec_rejected"] += spec_rejected
            self.classes["pad_waste"] += pad_waste
            self.classes["preempt_discard"] += preempt_discard
        self.dispatched_total += total

    # ------------------------------------------------------------ reads
    def goodput_fraction(self) -> float:
        """useful / dispatched — 0.0 before any dispatch (an honest
        zero, never a flattering 1.0)."""
        if self.dispatched_total <= 0:
            return 0.0
        return self.classes["useful"] / self.dispatched_total

    def conserved(self) -> bool:
        return sum(self.classes.values()) == self.dispatched_total

    def snapshot(self) -> Dict:
        out = dict(self.classes)
        out["dispatched_total"] = self.dispatched_total
        out["goodput_fraction"] = self.goodput_fraction()
        return out


# =====================================================================
# TTFT decomposition from RequestTrace host stamps
# =====================================================================

def ttft_decomposition(trace) -> Optional[Dict[str, float]]:
    """Split a finished request's time-to-first-token into
    queue-wait / prefill / first-emit.

    Accepts a `RequestTrace` or its `to_dict()` form.  All inputs are
    stamps the scheduler already recorded: the "queued" phase (submit →
    admission wave), the "prefill" phase (the admission dispatch) and
    the `ttft_s` annotation `_finish` writes.  ``first_emit`` is the
    residual — prefill completion to the consumer seeing the token
    (queue handoff + stream wakeup) — clamped at zero.  Returns None
    when the trace never reached prefill (shed before admission).
    """
    if hasattr(trace, "to_dict"):
        phases = trace.phases
        meta = trace.meta
    else:
        phases = trace.get("phases") or []
        meta = trace.get("meta") or {}
    spans = {}
    for p in phases:
        name = p["name"]
        if name in ("queued", "prefill") and name not in spans:
            spans[name] = max(0.0, float(p["t1"]) - float(p["t0"]))
    if "prefill" not in spans:
        return None
    queue_wait = spans.get("queued", 0.0)
    prefill = spans["prefill"]
    ttft = meta.get("ttft_s")
    if ttft is None:
        ttft = queue_wait + prefill
    ttft = float(ttft)
    first_emit = max(0.0, ttft - queue_wait - prefill)
    return {"queue_wait_s": queue_wait, "prefill_s": prefill,
            "first_emit_s": first_emit, "ttft_s": ttft}
