"""Runtime collectors feeding the metrics registry (counterpart of
`deeplearning4j_tpu/monitor/collectors.py`).

Three windows into the runtime that host-side spans cannot see:

- `KernelBuildCollector`: the port's only compile step is the `nvcc`
  build of its hand-written kernels (`kernels/build.py`), the place the
  JAX package's `JitCompileCollector` counts XLA compiles. Its
  `collect()` (call it where a fresh reading matters, as for the memory
  gauges) counts the builds under the JAX family names, `jax_compiles_total` and
  `jax_compile_seconds_total{stage="nvcc_build"}`, so a dashboard reads
  the same families from either package.
- `DeviceMemoryCollector`: per-card allocator gauges from
  `torch.cuda.memory_stats()` (`jax_device_memory_bytes{device, kind}`);
  on a machine without a card it reports itself unavailable.
- `record_transfer`: host<->device copies, counted on
  `jax_transfers_total{direction}` and `jax_transfer_bytes_total`. In
  the port these count the port's own copies: the diagnostics readback
  (d2h) and `DevicePrefetchIterator`'s staging (h2d).

None of these synchronizes the card: builds are host events,
`memory_stats()` reads the caching allocator's bookkeeping, and the
transfer counters count copies the program makes anyway.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry


class KernelBuildCollector:
    """Counts kernel builds and their seconds (the compile families).

    `collect()` moves the builds that `kernels/build.py` finished since
    the last collect (and after `install()`) into the counters; the
    readers below collect first. `uninstall()` stops the counting."""

    STAGE = "nvcc_build"

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._active = False
        self._seen = (0, 0.0)

    def install(self) -> "KernelBuildCollector":
        from deeplearning4j_tpu_torch.kernels import build
        if not self._active:
            self._seen = (build.BUILDS, build.BUILD_SECONDS)
        self._active = True
        return self

    def uninstall(self):
        self.collect()
        self._active = False

    def collect(self):
        if not self._active:
            return
        from deeplearning4j_tpu_torch.kernels import build
        builds, seconds = build.BUILDS, build.BUILD_SECONDS
        n, s = builds - self._seen[0], seconds - self._seen[1]
        self._seen = (builds, seconds)
        if n:
            self.registry.counter(
                "jax_compile_seconds_total",
                help="cumulative jit compile time by stage",
                stage=self.STAGE).inc(s)
            self.registry.counter(
                "jax_compiles_total",
                help="number of XLA backend compilations").inc(n)

    def compile_count(self) -> float:
        self.collect()
        return self.registry.counter("jax_compiles_total").value

    def compile_seconds(self) -> float:
        self.collect()
        fam = self.registry._families.get("jax_compile_seconds_total")
        return 0.0 if fam is None else sum(c.value for c in
                                           fam.children.values())


class DeviceMemoryCollector:
    """Card memory gauges from `torch.cuda.memory_stats()`.

    `collect()` refreshes the gauges; call it where a fresh reading
    matters (epoch end, a /metrics scrape). Without a card it is a
    no-op with `available == False`."""

    # JAX's key -> the caching allocator's statistic
    _KEYS = {"bytes_in_use": "allocated_bytes.all.current",
             "peak_bytes_in_use": "allocated_bytes.all.peak",
             "bytes_reserved": "reserved_bytes.all.current",
             "largest_alloc_size": "allocated_bytes.large_pool.peak"}

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.available: Optional[bool] = None

    def collect(self) -> bool:
        import torch
        seen = False
        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                seen = True
                for key, src in self._KEYS.items():
                    if src in stats:
                        self.registry.gauge(
                            "jax_device_memory_bytes",
                            help="device allocator stats",
                            device=str(d), kind=key).set(float(stats[src]))
                total = torch.cuda.get_device_properties(d).total_memory
                self.registry.gauge(
                    "jax_device_memory_bytes", help="device allocator stats",
                    device=str(d), kind="bytes_limit").set(float(total))
        self.available = seen
        return seen


def record_transfer(registry: MetricsRegistry, nbytes: int,
                    direction: str = "h2d"):
    """One host<->device copy: bump the count and byte counters."""
    registry.counter("jax_transfers_total",
                     help="array placements host<->device",
                     direction=direction).inc()
    registry.counter("jax_transfer_bytes_total",
                     help="bytes moved host<->device",
                     direction=direction).inc(float(max(0, nbytes)))
