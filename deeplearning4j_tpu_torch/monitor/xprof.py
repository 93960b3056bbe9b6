"""Cost reports, the roofline and profiler capture (counterpart of
`deeplearning4j_tpu/monitor/xprof.py`).

- `roofline()`: the two-ceiling model (arithmetic intensity against a
  compute peak and a memory-bandwidth peak) that turns a program's
  FLOPs and bytes into a predicted time and MFU. The peaks default to
  the H100's: 989 TFLOP/s bf16 (dense tensor cores), 67 TFLOP/s fp32
  outside the tensor cores, 3.35 TB/s of HBM3 (`H100_PEAK_FLOPS`,
  `H100_PEAK_BYTES_PER_SEC`).
- the cost-report registry: `publish_cost_report()` keeps a report
  (`PagedDecodeEngine.decode_cost_report`, or a JSON artifact) keyed by
  its ``model`` and mirrors its headline figures onto the metrics
  registry as ``aot_cost_*`` gauges; `cost_reports(scan=True)` adds the
  ``PROFILE_*/cost_*.json`` files under a root.
- `ProfilerCapture`: start and stop a `torch.profiler` trace around any
  window of driver code, exported as a Chrome trace, with the capture
  counted on the registry and spanned on the tracer.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "ProfilerCapture", "roofline", "publish_cost_report",
    "cost_reports", "clear_cost_reports", "load_cost_reports",
    "H100_PEAK_FLOPS", "H100_PEAK_BYTES_PER_SEC",
]

#: the H100 SXM's peak rates by operand dtype (dense, no sparsity)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_PEAK_BYTES_PER_SEC = 3.35e12


# ---------------------------------------------------------------- roofline
def roofline(flops: float, bytes_accessed: float,
             peak_flops: Optional[float] = None,
             peak_bytes_per_sec: float = H100_PEAK_BYTES_PER_SEC, *,
             dtype: str = "float32") -> Dict[str, float]:
    """Two-ceiling roofline for one program run: arithmetic intensity
    (FLOP/byte), the critical intensity where the ceilings cross, which
    ceiling binds, the time at each ceiling, and the predicted time,
    rate and MFU at the binding one. `peak_flops` defaults to the
    H100's peak for `dtype` ("bfloat16" or "float32")."""
    if peak_flops is None:
        peak_flops = H100_PEAK_FLOPS[dtype]
    flops = float(flops)
    bytes_accessed = float(bytes_accessed)
    if flops <= 0 or peak_flops <= 0 or peak_bytes_per_sec <= 0:
        raise ValueError("roofline needs positive flops and peaks")
    ai = flops / max(bytes_accessed, 1.0)
    critical_ai = peak_flops / peak_bytes_per_sec
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / peak_bytes_per_sec
    t = max(t_compute, t_memory)
    return {
        "arithmetic_intensity_flop_per_byte": ai,
        "critical_intensity_flop_per_byte": critical_ai,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "step_seconds_compute_bound": t_compute,
        "step_seconds_memory_bound": t_memory,
        "predicted_step_seconds": t,
        "predicted_flops_per_sec": flops / t,
        "predicted_mfu": (flops / t) / peak_flops,
        "mfu_if_compute_bound": 1.0,
    }


# ------------------------------------------------------ cost-report store
_REPORTS: Dict[str, dict] = {}
_REPORTS_LOCK = threading.Lock()

_GAUGE_FIELDS = (
    # (gauge name, report path): the figures mirrored to the registry;
    # the names are the JAX package's
    ("aot_cost_flops_per_step", ("per_op", "total_flops_per_step")),
    ("aot_cost_bytes_per_step", ("per_op", "total_bytes_per_step")),
    ("aot_cost_arithmetic_intensity",
     ("roofline", "arithmetic_intensity_flop_per_byte")),
    ("aot_cost_predicted_step_seconds", ("roofline", "predicted_step_seconds")),
    ("aot_cost_predicted_mfu", ("predicted", "mfu")),
    # the program section: its size and what building it cost
    ("aot_compile_seconds", ("program", "compile_seconds")),
    ("aot_compile_jaxpr_eqns", ("program", "jaxpr_eqn_count")),
    ("aot_compile_peak_temp_bytes", ("program", "peak_temp_bytes")),
    ("aot_compile_code_size_bytes",
     ("program", "generated_code_size_in_bytes")),
    # gradient-exchange payload, threshold-encoded against dense fp32
    ("aot_comm_bytes_dense", ("program", "comm_bytes",
                              "dense_bytes_per_step")),
    ("aot_comm_bytes_threshold", ("program", "comm_bytes",
                                  "threshold_bytes_per_step")),
    ("aot_comm_bytes_reduction", ("program", "comm_bytes", "reduction")),
    # exposed against overlapped bytes of a bucketed exchange
    ("aot_comm_overlap_exposed_bytes", ("program", "comm_overlap",
                                        "exposed_bytes")),
    ("aot_comm_overlap_overlapped_bytes", ("program", "comm_overlap",
                                           "overlapped_bytes")),
    ("aot_comm_overlap_exposed_fraction", ("program", "comm_overlap",
                                           "exposed_fraction")),
    # fp32 against mixed_bf16 bytes a step of the same program
    ("aot_precision_fp32_bytes_per_step", ("precision", "float32",
                                           "bytes_per_step")),
    ("aot_precision_bf16_bytes_per_step", ("precision", "mixed_bf16",
                                           "bytes_per_step")),
    ("aot_precision_bytes_reduction", ("precision", "bytes_reduction")),
    ("aot_precision_wire_reduction", ("precision", "wire_reduction")),
)


def _dig(d, path):
    for p in path:
        if not isinstance(d, dict):
            return None
        d = d.get(p)
    return d


def publish_cost_report(report: dict, registry=None) -> dict:
    """Keep one cost report (keyed by its ``model`` field) and mirror its
    headline numbers onto the metrics registry as
    ``aot_cost_*{model=...}`` gauges. `registry=None` uses the monitor's
    active registry. Returns the report."""
    model = str(report.get("model", "unknown"))
    with _REPORTS_LOCK:
        _REPORTS[model] = report
    if registry is None:
        from deeplearning4j_tpu_torch import monitor
        registry = monitor.registry()
    for gname, path in _GAUGE_FIELDS:
        val = _dig(report, path)
        if isinstance(val, (int, float)):
            registry.gauge(
                gname, help="cost report of a program (publish_cost_report)",
                model=model).set(float(val))
    return report


def clear_cost_reports():
    with _REPORTS_LOCK:
        _REPORTS.clear()


def load_cost_reports(root: str = ".") -> Dict[str, dict]:
    """The cost reports committed as ``PROFILE_*/cost_*.json`` under
    `root`, keyed by model."""
    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(root, "PROFILE_*",
                                              "cost_*.json"))):
        try:
            with open(path) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rep, dict):
            out[str(rep.get("model",
                            os.path.basename(path)[5:-5] or path))] = rep
    return out


def cost_reports(scan: bool = False, root: str = ".") -> Dict[str, dict]:
    """Reports published in-process; with `scan=True`, disk artifacts
    fill in models nothing has published yet (published wins)."""
    with _REPORTS_LOCK:
        published = dict(_REPORTS)
    if not scan:
        return published
    merged = load_cost_reports(root)
    merged.update(published)
    return merged


# ------------------------------------------------------- profiler capture
class ProfilerCapture:
    """A `torch.profiler` trace around a window of driver code::

        with ProfilerCapture("chiprun_out/trace"):
            server_burst()

    writes ``<logdir>/trace.json`` (Chrome trace; CUDA activity when a
    card is present). start()/stop() may be called explicitly; stop()
    is idempotent and returns the logdir, or None if nothing was
    active. With monitoring on, captures count in
    `profiler_captures_total`, the last one's length lands in
    `profiler_capture_seconds`, and a `profiler/capture` span brackets
    the window on the tracer."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)
        self.active = False
        self.profile = None
        self._t0: Optional[float] = None
        self._span = None

    def start(self) -> "ProfilerCapture":
        if self.active:
            raise RuntimeError(
                f"ProfilerCapture already active (logdir={self.logdir})")
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        self.active = True
        self._t0 = time.perf_counter()
        from deeplearning4j_tpu_torch import monitor
        if monitor.is_enabled():
            monitor.registry().counter(
                "profiler_captures_total",
                help="profiler capture windows started").inc()
            self._span = monitor.span("profiler/capture", logdir=self.logdir)
            self._span.__enter__()
        return self

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        try:
            self.profile.__exit__(None, None, None)
            self.profile.export_chrome_trace(
                os.path.join(self.logdir, "trace.json"))
        finally:
            self.active = False
        dur = time.perf_counter() - (self._t0 or time.perf_counter())
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        from deeplearning4j_tpu_torch import monitor
        if monitor.is_enabled():
            monitor.registry().gauge(
                "profiler_capture_seconds",
                help="duration of the last profiler capture window").set(dur)
        return self.logdir

    def __enter__(self) -> "ProfilerCapture":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
