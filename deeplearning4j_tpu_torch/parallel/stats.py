"""TrainingMaster round statistics and timeline export (counterpart of
`deeplearning4j_tpu/parallel/stats.py`).

The master (or a ParallelTrainer directly) records one event per phase
occurrence (broadcast, local_fit, average, sync_step) with its
wall-clock start and duration. The trainers synchronize the card at the
end of every timed phase (`torch.cuda.synchronize`, where JAX calls
`block_until_ready`), so a timed phase holds its device work; leave
stats off for peak-throughput runs.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional


class TrainingMasterStats:
    PHASES = ("broadcast", "local_fit", "average", "sync_step")

    def __init__(self):
        self.events: List[Dict] = []
        self._t0 = time.perf_counter()
        self._listeners: List[Callable[[Dict], None]] = []
        self.round_count = 0

    # ------------------------------------------------------------ recording
    def add_listener(self, fn: Callable[[Dict], None]):
        """fn(event_dict) called on every recorded phase event."""
        self._listeners.append(fn)
        return self

    def record(self, phase: str, seconds: float, **meta):
        ev = {"phase": phase,
              "start_ms": round((time.perf_counter() - self._t0
                                 - seconds) * 1000.0, 3),
              "duration_ms": round(seconds * 1000.0, 3),
              **meta}
        self.events.append(ev)
        for fn in self._listeners:
            fn(ev)

    def next_round(self):
        self.round_count += 1
        return self.round_count

    class _Timer:
        def __init__(self, stats, phase, meta):
            self.stats, self.phase, self.meta = stats, phase, meta

        def __enter__(self):
            self._start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.stats.record(self.phase,
                              time.perf_counter() - self._start, **self.meta)
            return False

    def time_phase(self, phase: str, **meta):
        """`with stats.time_phase("average", round=r): ...`"""
        return self._Timer(self, phase, meta)

    # ------------------------------------------------------------ summaries
    def phase_totals_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for ev in self.events:
            out[ev["phase"]] = out.get(ev["phase"], 0.0) + ev["duration_ms"]
        return {k: round(v, 3) for k, v in out.items()}

    def phase_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev["phase"]] = out.get(ev["phase"], 0) + 1
        return out

    def summary(self) -> Dict:
        return {"rounds": self.round_count,
                "phase_totals_ms": self.phase_totals_ms(),
                "phase_counts": self.phase_counts(),
                "events": len(self.events)}

    # -------------------------------------------------------------- export
    def to_json(self) -> str:
        return json.dumps({"summary": self.summary(),
                           "timeline": self.events})

    def export_json(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    _COLORS = {"broadcast": "#8a6fc8", "local_fit": "#4a7dbd",
               "average": "#c8763b", "sync_step": "#3b9c6e"}

    def export_html(self, path: str):
        """Standalone HTML timeline (the `StatsUtils.exportStatsAsHtml`
        role): one horizontal lane per phase, bars positioned by
        wall-clock start/duration."""
        if self.events:
            end = max(ev["start_ms"] + ev["duration_ms"] for ev in self.events)
        else:
            end = 1.0
        end = max(end, 1e-6)
        lanes = sorted({ev["phase"] for ev in self.events})
        rows = []
        for lane_i, phase in enumerate(lanes):
            bars = []
            for ev in self.events:
                if ev["phase"] != phase:
                    continue
                left = 100.0 * ev["start_ms"] / end
                width = max(100.0 * ev["duration_ms"] / end, 0.05)
                tip = (f"{phase} {ev['duration_ms']:.1f} ms @ "
                       f"{ev['start_ms']:.1f} ms")
                bars.append(
                    f'<div class="bar" title="{tip}" style="left:{left:.3f}%;'
                    f'width:{width:.3f}%;background:'
                    f'{self._COLORS.get(phase, "#888")}"></div>')
            rows.append(f'<div class="lane"><span class="label">{phase}'
                        f'</span><div class="track">{"".join(bars)}</div></div>')
        totals = self.phase_totals_ms()
        tot_rows = "".join(
            f"<tr><td>{k}</td><td>{v:.1f}</td>"
            f"<td>{self.phase_counts()[k]}</td></tr>"
            for k, v in sorted(totals.items()))
        html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>TrainingMaster timeline</title><style>
body{{font-family:sans-serif;margin:24px}}
.lane{{display:flex;align-items:center;margin:4px 0}}
.label{{width:90px;font-size:12px}}
.track{{position:relative;flex:1;height:18px;background:#f0f0f0}}
.bar{{position:absolute;top:2px;height:14px;min-width:1px}}
table{{border-collapse:collapse;margin-top:16px}}
td,th{{border:1px solid #ccc;padding:4px 10px;font-size:13px}}
</style></head><body>
<h2>TrainingMaster timeline ({self.round_count} rounds,
{len(self.events)} events, {end:.1f} ms)</h2>
{"".join(rows)}
<table><tr><th>phase</th><th>total ms</th><th>count</th></tr>{tot_rows}</table>
</body></html>"""
        with open(path, "w") as f:
            f.write(html)
        return path
