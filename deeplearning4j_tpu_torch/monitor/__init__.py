"""Training telemetry: the metrics registry, the span tracer, the
collectors, the flight recorder and the in-step diagnostics
(counterpart of `deeplearning4j_tpu/monitor/__init__.py`).

Usage::

    from deeplearning4j_tpu_torch import monitor
    monitor.enable()                 # global registry + tracer live
    net.fit(x, y, epochs=2)          # spans + counters flow by themselves
    monitor.tracer().export_chrome_trace("fit.trace.json")
    print(monitor.registry().exposition())

Sinks: the Prometheus text exposition (`registry().exposition()`),
Chrome trace-event JSON (`Tracer.export_chrome_trace`, loadable in
Perfetto beside a `torch.profiler` trace) and JSONL event logs
(`Tracer.export_jsonl`, `MetricsRegistry.dump_jsonl`).

Overhead contract: with monitoring off (the default) the fit loop pays
one attribute check per span and `span()` hands out one shared no-op;
on, it adds host-side float math and no device synchronize.

The serving side: `reqtrace` (per-request traces), `goodput` (the
token-position ledger), `slo` (objectives and burn rate) and `xprof`
(the roofline at the H100's peaks, cost reports, `torch.profiler`
capture). The fleet side: `federate` (worker snapshots merged into one
exposition, the publisher and collector, the elastic heartbeat hook)
and `alerts` (the rule engine and its default pack).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from deeplearning4j_tpu_torch.monitor import (
    alerts,
    diagnostics,
    federate,
    flightrec,
    goodput,
    reqtrace,
    slo,
    xprof,
)
from deeplearning4j_tpu_torch.monitor.alerts import (
    AlertEngine,
    AlertRule,
    default_rule_pack,
)
from deeplearning4j_tpu_torch.monitor.collectors import (
    DeviceMemoryCollector,
    KernelBuildCollector,
    record_transfer as _record_transfer_impl,
)
from deeplearning4j_tpu_torch.monitor.diagnostics import (
    Diagnostics,
    DiagnosticsConfig,
    NonFiniteGradientsError,
    resolve_diagnostics,
)
from deeplearning4j_tpu_torch.monitor.federate import (
    FederationCollector,
    FederationPublisher,
    MetricsAggregator,
    export_snapshot,
)
from deeplearning4j_tpu_torch.monitor.flightrec import (
    GLOBAL_FLIGHT_RECORDER,
    FlightRecorder,
    flight_recorder,
)
from deeplearning4j_tpu_torch.monitor.goodput import (
    GOODPUT_CLASSES,
    GoodputLedger,
    ttft_decomposition,
)
from deeplearning4j_tpu_torch.monitor.listener import (
    MonitorListener,
    bind_master_stats,
    record_master_event,
)
from deeplearning4j_tpu_torch.monitor.registry import (
    GLOBAL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
)
from deeplearning4j_tpu_torch.monitor.reqtrace import (
    RequestTrace,
    clear_exemplar_sink,
    mint_trace_id,
    set_exemplar_sink,
)
from deeplearning4j_tpu_torch.monitor.slo import SLOObjective, SLOTracker
from deeplearning4j_tpu_torch.monitor.tracer import (
    GLOBAL_TRACER,
    NOOP_SPAN,
    Span,
    Tracer,
)
from deeplearning4j_tpu_torch.monitor.xprof import (
    ProfilerCapture,
    publish_cost_report,
    roofline,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Timer",
    "Tracer", "Span", "MonitorListener", "KernelBuildCollector",
    "DeviceMemoryCollector", "enable", "disable", "is_enabled", "enabled",
    "registry", "tracer", "span", "record_transfer", "bind_master_stats",
    "attach_master_stats", "record_master_event",
    "extra_listeners", "compile_collector", "memory_collector",
    "resolve_cached_metrics", "diagnostics", "Diagnostics",
    "DiagnosticsConfig", "NonFiniteGradientsError", "resolve_diagnostics",
    "flightrec", "FlightRecorder", "flight_recorder",
    "GLOBAL_FLIGHT_RECORDER", "xprof", "ProfilerCapture", "roofline",
    "publish_cost_report", "reqtrace", "RequestTrace", "mint_trace_id",
    "set_exemplar_sink", "clear_exemplar_sink", "slo", "SLOObjective",
    "SLOTracker", "goodput", "GoodputLedger", "GOODPUT_CLASSES",
    "ttft_decomposition", "federate", "MetricsAggregator",
    "FederationPublisher", "FederationCollector", "export_snapshot",
    "alerts", "AlertEngine", "AlertRule", "default_rule_pack",
]


class _MonitorState:
    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.registry: MetricsRegistry = GLOBAL_REGISTRY
        self.tracer: Tracer = GLOBAL_TRACER
        self.listener: Optional[MonitorListener] = None
        self.compile_collector: Optional[KernelBuildCollector] = None
        self.memory_collector: Optional[DeviceMemoryCollector] = None


_STATE = _MonitorState()


def enable(registry: Optional[MetricsRegistry] = None,
           tracer: Optional[Tracer] = None, *,
           jit_compile: bool = True,
           device_memory: bool = True) -> MetricsRegistry:
    """Turn telemetry on (idempotent); returns the active registry.
    `jit_compile` installs the kernel-build collector (the JAX argument
    name: the port's compiles are its nvcc builds); `device_memory`
    creates the card-memory gauge collector. Neither syncs the card."""
    with _STATE.lock:
        if registry is not None:
            _STATE.registry = registry
        if tracer is not None:
            _STATE.tracer = tracer
        _STATE.tracer.enabled = True
        # the tracer drops its OLDEST event silently: the loss count must
        # be a visible metric
        _STATE.tracer._drop_counter = _STATE.registry.counter(
            "tracer_events_dropped_total",
            help="trace events evicted by the tracer ring buffer")
        _STATE.listener = MonitorListener(_STATE.registry)
        # a collector bound to a superseded registry is torn down
        if (_STATE.compile_collector is not None
                and _STATE.compile_collector.registry is not _STATE.registry):
            _STATE.compile_collector.uninstall()
            _STATE.compile_collector = None
        if jit_compile:
            if _STATE.compile_collector is None:
                _STATE.compile_collector = KernelBuildCollector(
                    _STATE.registry)
            _STATE.compile_collector.install()
        elif _STATE.compile_collector is not None:
            _STATE.compile_collector.uninstall()
        _STATE.memory_collector = (DeviceMemoryCollector(_STATE.registry)
                                   if device_memory else None)
        _STATE.enabled = True
        return _STATE.registry


def disable():
    """Back to zero cost: the fit loops skip spans and counters."""
    with _STATE.lock:
        _STATE.enabled = False
        _STATE.tracer.enabled = False
        if _STATE.compile_collector is not None:
            _STATE.compile_collector.uninstall()
        _STATE.listener = None


def is_enabled() -> bool:
    return _STATE.enabled


enabled = is_enabled  # alias


def registry() -> MetricsRegistry:
    return _STATE.registry


def resolve_cached_metrics(obj, cache_attr: str, build):
    """Resolve-and-cache for hot-loop metric families: None when
    monitoring is off; else `build(registry)`, resolved once per active
    registry (an `enable(registry=)` swap invalidates the cache by
    identity). The cache lives on `obj.<cache_attr>` as a
    `(registry, families)` pair."""
    if not is_enabled():
        return None
    reg = _STATE.registry
    cache = getattr(obj, cache_attr, None)
    if cache is not None and cache[0] is reg:
        return cache[1]
    m = build(reg)
    setattr(obj, cache_attr, (reg, m))
    return m


def tracer() -> Tracer:
    return _STATE.tracer


def compile_collector() -> Optional[KernelBuildCollector]:
    return _STATE.compile_collector


def memory_collector() -> Optional[DeviceMemoryCollector]:
    return _STATE.memory_collector


def span(name: str, **args):
    """`with monitor.span("fit/forward_backward"): ...`; the shared
    NOOP_SPAN when disabled (no allocation, no clock read)."""
    if not _STATE.enabled:
        return NOOP_SPAN
    return _STATE.tracer.span(name, **args)


def record_transfer(nbytes: int, direction: str = "h2d"):
    """Count one host<->device copy; no-op when disabled."""
    if _STATE.enabled:
        _record_transfer_impl(_STATE.registry, nbytes, direction)


def extra_listeners() -> List:
    """The listeners `fit` attaches itself: `[MonitorListener]` when
    enabled, `[]` when not."""
    l = _STATE.listener
    return [l] if (_STATE.enabled and l is not None) else []


def attach_master_stats(stats):
    """Route a `TrainingMasterStats`' phase events onto the active
    registry and tracer (nothing when monitoring is off; once per stats
    object, though the trainers call this at every fit). The sinks are
    resolved when an event lands, so a later `enable(registry=...)`
    redirects an already-bound stats object and `disable()` mutes it.
    Returns `stats`."""
    if (_STATE.enabled and stats is not None
            and not getattr(stats, "_monitor_bound", False)):
        t0_perf = getattr(stats, "_t0", None)

        def on_event(ev):
            if _STATE.enabled:
                record_master_event(ev, _STATE.registry, _STATE.tracer,
                                    t0_perf)

        stats.add_listener(on_event)
        stats._monitor_bound = True
    return stats

