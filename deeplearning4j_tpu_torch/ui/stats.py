"""Training stats collection (counterpart of
`deeplearning4j_tpu/ui/stats.py`).

Reference: `ui/stats/BaseStatsListener.java:44` — per-iteration
collection (`iterationDone` :286-544) of score, param/gradient/update
histograms and mean magnitudes, memory and runtime info, written as a
`StatsReport` to a `StatsStorageRouter`. The reference's SBE codecs
(`stats/sbe/UpdateEncoder.java`) become the JAX package's compact
struct-packed `DL4JSTAT` codec, copied here byte for byte: a report
either package encodes decodes in the other, and the same report
encodes to the same bytes in both.

`StatsListener` reads the port's in-step diagnostics
(`monitor/diagnostics.py`): with diagnostics on, the per-param
gradient and update magnitudes, update:param ratios, activation stats
and in-graph histograms come from the train step's packed statistics
(``info["diagnostics"]``, else ``model._last_diagnostics``), the true
updates rather than param deltas. What needs the raw params (their
magnitudes without diagnostics, host histograms, the param-delta
fallback) reads them in ONE device->host copy
(`diagnostics.batched_host_tree`).

Wire compatibility: the codec is versioned. v1 payloads (pre-
diagnostics) decode unchanged with empty new tables; v2 appends the
gradient/ratio/activation tables and the watchdog counter AFTER the v1
payload.
"""

from __future__ import annotations

import dataclasses
import resource
import struct
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = b"DL4JSTAT"
_VERSION = 2


def _rss_mb() -> float:
    """Peak RSS of this process in MB. `getrusage().ru_maxrss` is
    KILOBYTES on Linux but BYTES on macOS (see getrusage(2) in each) —
    dividing by 1024 unconditionally inflated mac numbers 1024x."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        return rss / (1024.0 * 1024.0)
    return rss / 1024.0


@dataclasses.dataclass
class StatsReport:
    session_id: str
    worker_id: str
    iteration: int
    epoch: int
    timestamp: float
    score: float
    iteration_time_ms: float = 0.0
    examples_per_sec: float = 0.0
    # per-param-name summaries
    param_mean_magnitudes: Dict[str, float] = dataclasses.field(default_factory=dict)
    update_mean_magnitudes: Dict[str, float] = dataclasses.field(default_factory=dict)
    param_histograms: Dict[str, Tuple[List[float], List[int]]] = \
        dataclasses.field(default_factory=dict)
    # system
    memory_rss_mb: float = 0.0
    # v2 (diagnostics feed): true per-param gradient magnitudes +
    # update:param ratios, per-layer activation stats, watchdog count
    gradient_mean_magnitudes: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    update_ratios: Dict[str, float] = dataclasses.field(default_factory=dict)
    activation_stats: Dict[str, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)  # (mean, std, dead)
    watchdog_nonfinite: int = 0

    # ------------------------------------------------- binary wire format
    def encode(self) -> bytes:
        """Compact binary encoding (SBE-equivalent role). v2 appends
        the diagnostics tables after the complete v1 payload."""
        def pack_str(s: str) -> bytes:
            b = s.encode("utf-8")
            return struct.pack("<H", len(b)) + b

        out = [_MAGIC, struct.pack("<H", _VERSION)]
        out.append(pack_str(self.session_id))
        out.append(pack_str(self.worker_id))
        out.append(struct.pack("<qqdddd", self.iteration, self.epoch,
                               self.timestamp, self.score,
                               self.iteration_time_ms, self.examples_per_sec))
        out.append(struct.pack("<d", self.memory_rss_mb))
        for table in (self.param_mean_magnitudes, self.update_mean_magnitudes):
            out.append(struct.pack("<H", len(table)))
            for k, v in table.items():
                out.append(pack_str(k))
                out.append(struct.pack("<d", v))
        out.append(struct.pack("<H", len(self.param_histograms)))
        for k, (edges, counts) in self.param_histograms.items():
            out.append(pack_str(k))
            out.append(struct.pack("<H", len(counts)))
            out.append(np.asarray(edges, np.float64).tobytes())
            out.append(np.asarray(counts, np.int64).tobytes())
        # ---- v2 extension block (absent in v1 payloads) ----
        for table in (self.gradient_mean_magnitudes, self.update_ratios):
            out.append(struct.pack("<H", len(table)))
            for k, v in table.items():
                out.append(pack_str(k))
                out.append(struct.pack("<d", v))
        out.append(struct.pack("<H", len(self.activation_stats)))
        for k, (m, s, d) in self.activation_stats.items():
            out.append(pack_str(k))
            out.append(struct.pack("<ddd", m, s, d))
        out.append(struct.pack("<q", self.watchdog_nonfinite))
        return b"".join(out)

    @staticmethod
    def decode(data: bytes) -> "StatsReport":
        if data[:8] != _MAGIC:
            raise ValueError("Not a DL4JSTAT payload (bad magic)")
        (version,) = struct.unpack_from("<H", data, 8)
        pos = [10]

        def unpack_str() -> str:
            (n,) = struct.unpack_from("<H", data, pos[0])
            pos[0] += 2
            s = data[pos[0]:pos[0] + n].decode("utf-8")
            pos[0] += n
            return s

        def unpack_table() -> Dict[str, float]:
            (n,) = struct.unpack_from("<H", data, pos[0])
            pos[0] += 2
            t = {}
            for _ in range(n):
                k = unpack_str()
                (v,) = struct.unpack_from("<d", data, pos[0])
                pos[0] += 8
                t[k] = v
            return t

        session_id = unpack_str()
        worker_id = unpack_str()
        it, ep, ts, score, itms, eps = struct.unpack_from("<qqdddd", data, pos[0])
        pos[0] += struct.calcsize("<qqdddd")
        (rss,) = struct.unpack_from("<d", data, pos[0])
        pos[0] += 8
        tables = [unpack_table(), unpack_table()]
        (nh,) = struct.unpack_from("<H", data, pos[0])
        pos[0] += 2
        hists = {}
        for _ in range(nh):
            k = unpack_str()
            (nb,) = struct.unpack_from("<H", data, pos[0])
            pos[0] += 2
            edges = np.frombuffer(data, np.float64, nb + 1, pos[0]).tolist()
            pos[0] += 8 * (nb + 1)
            counts = np.frombuffer(data, np.int64, nb, pos[0]).tolist()
            pos[0] += 8 * nb
            hists[k] = (edges, counts)
        report = StatsReport(session_id, worker_id, it, ep, ts, score,
                             itms, eps, tables[0], tables[1], hists, rss)
        if version >= 2:
            report.gradient_mean_magnitudes = unpack_table()
            report.update_ratios = unpack_table()
            (na,) = struct.unpack_from("<H", data, pos[0])
            pos[0] += 2
            for _ in range(na):
                k = unpack_str()
                m, s, d = struct.unpack_from("<ddd", data, pos[0])
                pos[0] += 24
                report.activation_stats[k] = (m, s, d)
            (report.watchdog_nonfinite,) = struct.unpack_from(
                "<q", data, pos[0])
            pos[0] += 8
        return report


def param_tree(model) -> Dict[str, Dict[str, object]]:
    """{layer key: {param name: tensor}} of a container's params, keyed
    as the JAX net's `params` (its report keys are
    ``f"{layer}_{param}"``)."""
    return {key: dict(layer.jax_param_map()) for key, layer in model.keyed()
            if layer.jax_param_map()}


class StatsListener:
    """Reference `StatsListener` — collect + route to a StatsStorage.

    `update_frequency`: collect every N iterations (reference
    listenerFrequency). Histograms are optional (more device→host
    traffic).

    Data sources, in order of preference:
    - the diagnostics readback (``info["diagnostics"]`` /
      ``model._last_diagnostics``): the per-param gradient/update
      magnitudes, update:param ratios, activation stats, watchdog count
      and (when the diagnostics config enables them) in-graph parameter
      histograms, with no copy beyond the one the fit loop made;
    - the model's params, fetched in ONE batched copy
      (`diagnostics.batched_host_tree`): param magnitudes without a
      diagnostics seam, host histograms (`np.histogram` on that copy)
      and the param-delta update fallback.
    """

    def __init__(self, storage, session_id: str = "default",
                 worker_id: str = "worker0", update_frequency: int = 1,
                 collect_histograms: bool = False, histogram_bins: int = 20):
        self.storage = storage
        self.session_id = session_id
        self.worker_id = worker_id
        self.update_frequency = max(1, update_frequency)
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self._last_time = None
        self._prev_params: Dict[str, np.ndarray] = {}

    # TrainingListener protocol
    def on_fit_start(self, model):
        self._last_time = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score, **info):
        if iteration % self.update_frequency != 0:
            return
        now = time.perf_counter()
        dt_ms = 0.0 if self._last_time is None else (now - self._last_time) * 1e3
        self._last_time = now
        batch = info.get("batch_size", 0)
        report = StatsReport(
            session_id=self.session_id, worker_id=self.worker_id,
            iteration=iteration, epoch=epoch, timestamp=time.time(),
            score=float(score), iteration_time_ms=dt_ms,
            examples_per_sec=(batch / (dt_ms / 1e3) if dt_ms > 0 and batch else 0.0),
            memory_rss_mb=_rss_mb(),
        )
        # an EXPLICIT None is an off-cadence step: fall back to the
        # param-delta path rather than relabel the model's stale last
        # readback with this iteration; the model attribute is read
        # only when the caller never passed the key
        diag = (info["diagnostics"] if "diagnostics" in info
                else getattr(model, "_last_diagnostics", None))
        diag_params = (diag or {}).get("params") or {}
        diag_hists = (diag or {}).get("hists") or {}
        tree = param_tree(model)
        # host params only where something below reads raw arrays: no
        # diagnostics seam, or host histograms
        need_host = (not diag_params
                     or (self.collect_histograms and not diag_hists))
        host_params = None
        if need_host:
            from deeplearning4j_tpu_torch.monitor.diagnostics import (
                batched_host_tree)
            host_params = batched_host_tree(tree)
        for lk, lparams in tree.items():
            for pn in lparams:
                key = f"{lk}_{pn}"
                d = diag_params.get(key)
                if d is not None:
                    report.param_mean_magnitudes[key] = float(d["param_mm"])
                    # the applied update's magnitude from the step's
                    # statistics, not a param delta
                    report.update_mean_magnitudes[key] = float(d["upd_mm"])
                    report.update_ratios[key] = float(d["ratio"])
                    if "grad_mm" in d:
                        report.gradient_mean_magnitudes[key] = \
                            float(d["grad_mm"])
                else:
                    a = host_params[lk][pn]
                    report.param_mean_magnitudes[key] = \
                        float(np.mean(np.abs(a)))
                    prev = self._prev_params.get(key)
                    if prev is not None and prev.shape == a.shape:
                        # fallback: |param delta| since last report
                        # (reference BaseStatsListener update stats)
                        report.update_mean_magnitudes[key] = float(
                            np.mean(np.abs(a - prev)))
                    # a copy: on the CPU the host tree views the live
                    # params, which the next step updates in place
                    self._prev_params[key] = np.array(a)
                if self.collect_histograms:
                    hv = diag_hists.get(key)
                    if hv is not None and diag is not None:
                        # the fixed-bin in-graph histogram
                        md = getattr(model, "_diag", None)
                        r = (md.config.histogram_range
                             if md is not None else 1.0)
                        edges = np.linspace(-r, r, len(hv) + 1)
                        report.param_histograms[key] = (
                            edges.tolist(),
                            np.asarray(hv, np.int64).tolist())
                    else:
                        counts, edges = np.histogram(
                            host_params[lk][pn], bins=self.histogram_bins)
                        report.param_histograms[key] = (edges.tolist(),
                                                        counts.tolist())
        if diag is not None:
            for lk, st in (diag.get("activations") or {}).items():
                report.activation_stats[lk] = (
                    float(st["mean"]), float(st["std"]), float(st["dead"]))
            md = getattr(model, "_diag", None)
            if md is not None:
                report.watchdog_nonfinite = int(md.nonfinite_total)
        self.storage.put_report(report)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def on_fit_end(self, model):
        pass
