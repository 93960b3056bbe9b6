"""Training UI web server (counterpart of
`deeplearning4j_tpu/ui/server.py`).

Reference: `play/PlayUIServer.java` (embedded Play/Netty server) with
pluggable UIModules: `module/train/TrainModule.java` routes
`/train/overview|model|system` (:93-105), `module/tsne/` (t-SNE
visualization), `module/convolutional/` (activation grids), and
`module/remote/RemoteReceiverModule` (train-here-view-there POST
receiver). Here: stdlib ThreadingHTTPServer serving the same route
surface with self-contained pages built from the declarative component
library (`ui/components.py` — the ui-components equivalent), plus JSON
APIs. The pages read the port's own monitor: its metrics registry (or a
federation `MetricsAggregator`), flight recorder, `AlertEngine` and
cost reports; for the same storage and registry contents each page's
HTML is the JAX package's. `/profile` renders only the cost reports
published in this process (`monitor.xprof.publish_cost_report`), never
the JAX package's committed TPU tables under ``PROFILE_*/``.
"""

from __future__ import annotations

import base64
import html as _html
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.ui.convolutional import png_gray
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    ComponentTable,
)
from deeplearning4j_tpu_torch.ui.stats import StatsReport
from deeplearning4j_tpu_torch.ui.i18n import LANGUAGES, tr as _tr_i18n
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage, StatsStorage


class UIServer:
    """`UIServer.getInstance().attach(storage)` equivalent."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 0, registry=None):
        self.storage: StatsStorage = InMemoryStatsStorage()
        # /metrics exposition source; None → the process-global monitor
        # registry at request time (so enable() after server start works)
        self._registry = registry
        # /alerts source: an AlertEngine attached via attach_alerts()
        self._alerts = None
        self._tsne: Dict[str, dict] = {}          # session → {coords, labels}
        self._activations: Dict[str, bytes] = {}  # name → PNG bytes
        self._module_lock = threading.Lock()      # guards the two dicts
        # per-REQUEST view options (lang/refresh): thread-local because
        # ThreadingHTTPServer handles concurrent requests on separate
        # threads — instance attributes would race between them
        self._req = threading.local()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="text/html; charset=utf-8"):
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path
                q = parse_qs(parsed.query)
                # reference play UI: i18n bundles + live-updating views;
                # here: ?lang=en|ja|zh and ?refresh=<seconds>. lang is
                # WHITELISTED (it is echoed into hrefs — arbitrary
                # values would be a reflected-XSS vector)
                lang = q.get("lang", ["en"])[0]
                outer._req.lang = lang if lang in LANGUAGES else "en"
                try:
                    outer._req.refresh = max(0, int(q.get("refresh", ["0"])[0]))
                except ValueError:
                    outer._req.refresh = 0
                if path in ("/", "/train", "/train/overview"):
                    self._send(200, outer._overview_html())
                elif path == "/train/model":
                    self._send(200, outer._model_html())
                elif path == "/train/system":
                    self._send(200, outer._system_html())
                elif path == "/tsne":
                    self._send(200, outer._tsne_html())
                elif path == "/activations":
                    self._send(200, outer._activations_html())
                elif path.startswith("/activations/img/"):
                    name = path.rsplit("/", 1)[1]
                    with outer._module_lock:
                        png = outer._activations.get(name)
                    if png is None:
                        self._send(404, "not found")
                    else:
                        self._send(200, png, "image/png")
                elif path == "/metrics":
                    # Prometheus text exposition (the telemetry core's
                    # scrape endpoint — see monitor/ and docs/OBSERVABILITY.md)
                    self._send(200, outer.metrics_text(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/serving":
                    # continuous-batching server health (serving/ tier:
                    # queue depth, slots, pool blocks, TTFT/TPOT, sheds
                    # — docs/SERVING.md + OBSERVABILITY.md "Serving")
                    self._send(200, outer._serving_html())
                elif path == "/events":
                    # control-plane flight recorder (monitor/flightrec.py):
                    # publishes, swaps, drains, autoscales, drift trips —
                    # ?kind= filters, ?last= bounds, ?format=json for
                    # machine consumers
                    if q.get("format", [""])[0] == "json":
                        self._send(200, outer._events_json(q),
                                   "application/json")
                    else:
                        self._send(200, outer._events_html(q))
                elif path == "/alerts":
                    # declarative alert states (monitor/alerts.py):
                    # the attached AlertEngine's pending/firing/resolved
                    # view — ?format=json for machine consumers
                    if q.get("format", [""])[0] == "json":
                        self._send(200, outer._alerts_json(),
                                   "application/json")
                    else:
                        self._send(200, outer._alerts_html())
                elif path == "/profile":
                    # cost tables + roofline of the reports published
                    # in this process (monitor/xprof.py)
                    self._send(200, outer._profile_html())
                elif path == "/api/profile":
                    from deeplearning4j_tpu_torch.monitor import xprof
                    self._send(200, json.dumps(xprof.cost_reports(),
                                               default=str),
                               "application/json")
                elif path == "/api/sessions":
                    self._send(200, json.dumps(outer.storage.list_session_ids()),
                               "application/json")
                elif path.startswith("/api/reports/"):
                    sid = path.rsplit("/", 1)[1]
                    reports = outer.storage.get_reports(sid)
                    self._send(200, json.dumps([{
                        "iteration": r.iteration, "score": r.score,
                        "examples_per_sec": r.examples_per_sec,
                        "memory_rss_mb": r.memory_rss_mb,
                    } for r in reports]), "application/json")
                elif path.startswith("/api/components/"):
                    # declarative-component JSON for custom frontends
                    sid = path.rsplit("/", 1)[1]
                    chart = outer._score_chart(sid)
                    self._send(200, chart.to_json(), "application/json")
                else:
                    self._send(404, "not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path == "/remote":
                    try:
                        report = StatsReport.decode(body)
                        outer.storage.put_report(report)
                        self._send(200, '{"status":"ok"}', "application/json")
                    except Exception as e:  # noqa: BLE001 — server boundary
                        self._send(400, json.dumps({"error": str(e)}),
                                   "application/json")
                elif self.path == "/tsne/upload":
                    try:
                        d = json.loads(body)
                        outer.post_tsne(d.get("session", "default"),
                                        d["coords"], d.get("labels"))
                        self._send(200, '{"status":"ok"}', "application/json")
                    except Exception as e:  # noqa: BLE001
                        self._send(400, json.dumps({"error": str(e)}),
                                   "application/json")
                else:
                    self._send(404, "not found")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # --------------------------------------------------------- module data
    def post_tsne(self, session: str, coords, labels=None):
        """t-SNE module upload (reference play `module/tsne/`)."""
        coords = np.asarray(coords, np.float64)
        if coords.ndim != 2 or coords.shape[1] != 2 or coords.shape[0] == 0:
            raise ValueError(f"coords must be non-empty [N, 2], got {coords.shape}")
        with self._module_lock:
            self._tsne[session] = {
                "coords": coords.tolist(),
                "labels": [str(l) for l in labels] if labels is not None else None,
            }
        return self

    def post_activation_grid(self, name: str, grid: np.ndarray):
        """Activations module feed (reference `module/convolutional/`):
        a [H, W] uint8 grid from `activations_to_grid`, kept as a PNG."""
        png = png_gray(grid)
        with self._module_lock:
            self._activations[name] = png
        return self

    # ------------------------------------------------------------- pages
    def _sessions(self):
        return self.storage.list_session_ids()

    def _qs(self):
        parts = []
        if getattr(self._req, "lang", "en") != "en":
            parts.append(f"lang={self._req.lang}")
        if getattr(self._req, "refresh", 0):
            parts.append(f"refresh={self._req.refresh}")
        return ("?" + "&".join(parts)) if parts else ""

    def _tr(self, key):
        return _tr_i18n(getattr(self._req, "lang", "en"), key)

    def _nav(self, active):
        qs = self._qs()
        pages = [("overview", "/train/overview"), ("model", "/train/model"),
                 ("system", "/train/system"), ("tsne", "/tsne"),
                 ("activations", "/activations"), ("profile", "/profile"),
                 ("serving", "/serving"), ("events", "/events"),
                 ("alerts", "/alerts")]
        links = "".join(
            f'<a href="{url}{qs}" style="margin-right:16px;'
            f'{"font-weight:bold" if p == active else ""}">'
            f'{_html.escape(self._tr(p))}</a>'
            for p, url in pages)
        return f'<div style="padding:8px;border-bottom:1px solid #ddd">{links}</div>'

    def _score_chart(self, sid, reports=None) -> ChartLine:
        if reports is None:
            reports = self.storage.get_reports(sid)
        chart = ChartLine(title=f"{self._tr('score')} — {sid}")
        chart.add_series(self._tr("score"), [r.iteration for r in reports],
                         [r.score for r in reports])
        return chart

    def _overview_html(self):
        body = [self._nav("overview")]
        for sid in self._sessions():
            reports = self.storage.get_reports(sid)
            xs = [r.iteration for r in reports]
            body.append(f"<h3>{self._tr('session')} {_html.escape(str(sid))}</h3>")
            body.append(self._score_chart(sid, reports).render())
            if reports and any(r.examples_per_sec for r in reports):
                perf = ChartLine(title=self._tr("throughput"))
                perf.add_series(self._tr("examples_per_sec"), xs,
                                [r.examples_per_sec for r in reports])
                body.append(perf.render())
            # training-health strip — REAL in-graph internals from the
            # diagnostics feed (monitor/diagnostics.py): mean gradient
            # magnitude across params, mean update:param ratio, and the
            # watchdog's non-finite step count
            grad_reports = [r for r in reports
                            if getattr(r, "gradient_mean_magnitudes", None)]
            if grad_reports:
                health = ChartLine(title=self._tr("health"))
                health.add_series(
                    self._tr("grad_norm"),
                    [r.iteration for r in grad_reports],
                    [float(np.mean(list(r.gradient_mean_magnitudes
                                        .values())))
                     for r in grad_reports])
                # ratios of 0 (frozen layers, zero-grad biases) have no
                # log — average only the positive ones, and emit a
                # point only where one exists (a NaN coordinate would
                # poison the whole chart's axis bounds)
                ratio_pts = []
                for r in grad_reports:
                    pos = [math.log10(v)
                           for v in getattr(r, "update_ratios",
                                            {}).values() if v > 0]
                    if pos:
                        ratio_pts.append((r.iteration,
                                          float(np.mean(pos))))
                if ratio_pts:
                    health.add_series(
                        self._tr("update_ratio"),
                        [p[0] for p in ratio_pts],
                        [p[1] for p in ratio_pts])
                body.append(health.render())
            wd = [r for r in reports
                  if getattr(r, "watchdog_nonfinite", 0)]
            if wd:
                wchart = ChartLine(title=self._tr("watchdog"))
                wchart.add_series(self._tr("watchdog"),
                                  [r.iteration for r in wd],
                                  [float(r.watchdog_nonfinite)
                                   for r in wd])
                body.append(wchart.render())
            act_latest = next(
                (r for r in reversed(reports)
                 if getattr(r, "activation_stats", None)), None)
            if act_latest is not None:
                body.append(ComponentTable(
                    [self._tr("act_layer"), self._tr("act_mean"),
                     self._tr("act_std"), self._tr("act_dead")],
                    [(k, f"{m:.4g}", f"{s:.4g}", f"{d:.3f}")
                     for k, (m, s, d)
                     in sorted(act_latest.activation_stats.items())],
                    title=self._tr("act_stats")).render())
        stream = self._streaming_rows()
        if stream:
            body.append(ComponentTable(
                [self._tr("stream_source"), self._tr("stream_records"),
                 self._tr("stream_lag"), self._tr("stream_age"),
                 self._tr("stream_publishes"), self._tr("stream_paused")],
                stream, title=self._tr("stream_health")).render())
        if len(body) == 1:
            body.append(f"<p>{self._tr('no_sessions')}</p>")
        return self._page(self._tr("title.overview"), "".join(body))

    def _streaming_rows(self):
        """Online-training staleness rows for the overview, read from
        the live monitor registry (the same `streaming_*`/`online_*`
        families `/metrics` exports; docs/OBSERVABILITY.md "Streaming /
        online training"). Row kinds are SEPARATE — one per stream
        topic (records consumed, consumer lag, watermark age), one per
        published model (publish count), one per drift-gate tag (gate
        state) — because the registry knows no topic↔model↔tag
        mapping, and smearing a global sum / any-paused flag across
        topic rows would misattribute state the moment two streams are
        live."""
        from deeplearning4j_tpu_torch import monitor
        snap = (self._registry or monitor.registry()).snapshot()

        def by_label(fam, label):
            out = {}
            for e in (snap.get(fam) or {}).get("values", []):
                key = e.get("labels", {}).get(label)
                if key is not None:
                    out[key] = e.get("value")
            return out

        records = by_label("streaming_records_consumed_total", "topic")
        if not records:
            return []
        lag = by_label("streaming_lag_records", "topic")
        age = by_label("streaming_watermark_age_seconds", "topic")
        pubs = by_label("online_publishes_total", "model")
        paused = by_label("online_publish_paused", "tag")

        def fmt(v, suffix=""):
            if v is None or (isinstance(v, float) and v != v):
                return "—"
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            return (f"{v:.1f}{suffix}" if isinstance(v, float)
                    else f"{v}{suffix}")

        rows = [(topic, fmt(records.get(topic)), fmt(lag.get(topic)),
                 fmt(age.get(topic), "s"), "—", "—")
                for topic in sorted(records)]
        rows.extend((f"{self._tr('stream_model')} {model}", "—", "—",
                     "—", fmt(pubs.get(model)), "—")
                    for model in sorted(pubs))
        rows.extend((f"{self._tr('stream_gate')} {tag}", "—", "—", "—",
                     "—",
                     self._tr("stream_paused_yes") if paused.get(tag)
                     else self._tr("stream_paused_no"))
                    for tag in sorted(paused))
        return rows

    def _model_html(self):
        """Per-layer drill-down: mean-magnitude timelines for params and
        updates + latest histograms (reference TrainModule model view)."""
        body = [self._nav("model")]
        for sid in self._sessions():
            reports = self.storage.get_reports(sid)
            latest = self.storage.latest_report(sid)
            if latest is None:
                continue
            body.append(f"<h3>{self._tr('session')} {_html.escape(str(sid))}</h3>")
            xs = [r.iteration for r in reports]
            by_layer: Dict[str, List[str]] = {}
            for key in latest.param_mean_magnitudes:
                lk = key.split("_", 1)[0]
                by_layer.setdefault(lk, []).append(key)
            for lk in sorted(by_layer, key=str):
                chart = ChartLine(title=f"layer {lk} — {self._tr('mean_param')}")
                for key in sorted(by_layer[lk]):
                    chart.add_series(
                        key, xs,
                        [r.param_mean_magnitudes.get(key, 0.0)
                         for r in reports])
                upd_keys = [k for k in latest.update_mean_magnitudes
                            if k.split("_", 1)[0] == lk]
                for key in sorted(upd_keys):
                    chart.add_series(
                        f"Δ{key}", xs,
                        [r.update_mean_magnitudes.get(key, 0.0)
                         for r in reports])
                body.append(chart.render())
                # update:param ratio — THE canonical training-health
                # diagnostic (reference TrainModule "Update:Parameter
                # Ratios" chart; healthy training sits around 1e-3)
                ratio_keys = [k for k in sorted(by_layer[lk])
                              if k in latest.update_mean_magnitudes]
                if ratio_keys:
                    rchart = ChartLine(
                        title=f"layer {lk} — {self._tr('update_ratio')}")
                    for key in ratio_keys:
                        ys = []
                        for r in reports:
                            u = r.update_mean_magnitudes.get(key, 0.0)
                            pm = r.param_mean_magnitudes.get(key, 0.0)
                            ys.append(math.log10(u / pm)
                                      if u > 0 and pm > 0 else float("nan"))
                        pts = [(x, y) for x, y in zip(xs, ys)
                               if y == y]  # drop NaN (no update yet)
                        if pts:
                            rchart.add_series(key, [p_[0] for p_ in pts],
                                              [p_[1] for p_ in pts])
                    if rchart.series:
                        body.append(rchart.render())
                for key in sorted(by_layer[lk]):
                    hist = latest.param_histograms.get(key)
                    if hist:
                        edges, counts = hist
                        h = ChartHistogram(title=f"{key} {self._tr('distribution')}")
                        for lo, hi, c in zip(edges[:-1], edges[1:], counts):
                            h.add_bin(lo, hi, c)
                        body.append(h.render())
            body.append(ComponentTable(
                [self._tr("param"), self._tr("mean_value")],
                [(k, f"{v:.6g}")
                 for k, v in sorted(latest.param_mean_magnitudes.items())],
                title=self._tr("latest_magnitudes")).render())
        if len(body) == 1:
            body.append(f"<p>{self._tr('no_model_stats')}</p>")
        return self._page(self._tr("title.model"), "".join(body))

    def _system_html(self):
        body = [self._nav("system")]
        for sid in self._sessions():
            reports = self.storage.get_reports(sid)
            if not reports:
                continue
            xs = [r.iteration for r in reports]
            body.append(f"<h3>{self._tr('session')} {_html.escape(str(sid))}</h3>")
            mem = ChartLine(title=self._tr("memory"))
            mem.add_series("RSS MB", xs, [r.memory_rss_mb for r in reports])
            body.append(mem.render())
            t = ChartLine(title=self._tr("iteration_time"))
            t.add_series("ms/iter", xs,
                         [r.iteration_time_ms for r in reports])
            body.append(t.render())
        return self._page(self._tr("title.system"), "".join(body))

    def _serving_html(self):
        """Serving health from the live metrics registry (the same
        families /metrics exports — one source of truth, rendered
        instead of scraped): one row PER FLEET MODEL (name, version,
        queue depth, active slots, shed count — the `fleet_*` labeled
        families), then the single-server engine snapshot for the
        non-fleet `GenerationServer` case."""
        from deeplearning4j_tpu_torch import monitor

        body = [self._nav("serving")]
        snap = (self._registry or monitor.registry()).snapshot()

        def by_model(fam):
            out = {}
            for e in (snap.get(fam) or {}).get("values", []):
                model = e.get("labels", {}).get("model")
                if model is not None:
                    out[model] = e.get("value")
            return out

        fleet_rows = {}
        for fam, col in (("fleet_model_version", "version"),
                         ("fleet_queue_depth", "queue depth"),
                         ("fleet_active_slots", "active slots"),
                         ("fleet_slot_count", "slots"),
                         ("fleet_open_streams", "open streams"),
                         ("fleet_pool_blocks_used", "pool used"),
                         ("fleet_pool_blocks_free", "pool free"),
                         ("fleet_streams_total", "streams"),
                         ("fleet_shed_total", "shed"),
                         ("fleet_swaps_total", "swaps")):
            for model, v in by_model(fam).items():
                if isinstance(v, float) and v.is_integer():
                    v = int(v)
                fleet_rows.setdefault(model, {})[col] = v
        # version 0 marks a RETIRED model (the fleet zeroes an
        # undeployed model's gauges; the registry can't remove label
        # children) — don't render it as a live row
        fleet_rows = {name: row for name, row in fleet_rows.items()
                      if row.get("version", 0) != 0}
        if fleet_rows:
            cols = ["model", "version", "queue depth", "active slots",
                    "slots", "open streams", "pool used", "pool free",
                    "streams", "shed", "swaps"]
            body.append("<h3>fleet</h3>")
            body.append("<table border='1' cellpadding='4'><tr>")
            body.extend(f"<th>{_html.escape(c)}</th>" for c in cols)
            body.append("</tr>")
            for model in sorted(fleet_rows):
                row = fleet_rows[model]
                body.append("<tr><td>" + _html.escape(model) + "</td>")
                body.extend(
                    f"<td>{_html.escape(str(row.get(c, 0)))}</td>"
                    for c in cols[1:])
                body.append("</tr>")
            body.append("</table>")
            reg_pub = snap.get("registry_published_total")
            if reg_pub and reg_pub.get("values"):
                published = sum(e.get("value", 0)
                                for e in reg_pub["values"])
                body.append(f"<p>registry: "
                            f"{int(published)} versions published</p>")

        def val(name, default="–"):
            fam = snap.get(name)
            if not fam or not fam.get("values"):
                return default
            v = fam["values"][0].get("value", default)
            if isinstance(v, float) and v.is_integer():
                return int(v)
            return v

        def hist(name):
            fam = snap.get(name)
            if not fam or not fam.get("values"):
                return "–"
            e = fam["values"][0]
            n = e.get("count", 0)
            if not n:
                return "–"
            return f"{1e3 * e['sum'] / n:.1f} ms avg over {n}"

        # pool occupancy: used/free from the allocator-view gauges
        # (incremental block grants — docs/SERVING.md)
        used, free = (val("serving_pool_blocks_used"),
                      val("serving_pool_blocks_free"))
        if isinstance(used, int) and isinstance(free, int) and used + free:
            occupancy = (f"{used} used / {free} free "
                         f"({100.0 * used / (used + free):.0f}%)")
        else:
            occupancy = "–"
        def lval(name, default="–", **labels):
            # label-selected series (e.g. per-proposer accept rate —
            # `val` reads values[0], wrong once a family has children)
            fam = snap.get(name)
            for e in (fam or {}).get("values", []):
                if all(e.get("labels", {}).get(k) == v
                       for k, v in labels.items()):
                    v = e.get("value", default)
                    if isinstance(v, float) and not v.is_integer():
                        return f"{v:.3f}"
                    return v
            return default

        rows = [
            ("queue depth", val("serving_queue_depth")),
            ("active slots", val("serving_active_slots")),
            ("free pool blocks", val("serving_free_blocks")),
            ("pool occupancy", occupancy),
            ("blocks granted", val("serving_block_grants_total", 0)),
            ("preempt-requeues", val("serving_evict_requeue_total", 0)),
            ("requests admitted", val("serving_requests_total", 0)),
            ("tokens emitted", val("serving_tokens_total", 0)),
            ("requests shed (SLO)", val("serving_shed_total", 0)),
            ("evicted mid-stream", val("serving_evicted_total", 0)),
            ("radix-cache nodes", val("serving_radix_nodes", 0)),
            ("radix hit tokens", val("serving_radix_hit_tokens_total", 0)),
            ("radix evictions", val("serving_radix_evictions_total", 0)),
            ("spec accept (ngram)",
             lval("serving_spec_accept_rate", proposer="ngram")),
            ("spec accept (truncated)",
             lval("serving_spec_accept_rate", proposer="truncated")),
            ("TTFT", hist("serving_ttft_seconds")),
            ("per-token (TPOT)", hist("serving_tpot_seconds")),
            ("decode dispatch", hist("serving_step_seconds")),
        ]
        if "serving_requests_total" not in snap:
            body.append("<p>no generation server has reported yet — "
                        "start a <code>GenerationServer</code> with "
                        "monitoring enabled</p>")
        body.append("<table border='1' cellpadding='4'>")
        for k, v in rows:
            body.append(f"<tr><td>{_html.escape(k)}</td>"
                        f"<td>{_html.escape(str(v))}</td></tr>")
        body.append("</table>")
        return self._page("serving", "".join(body))

    def _events_query(self, q):
        kind = q.get("kind", [None])[0] or None
        try:
            last = int(q.get("last", ["200"])[0])
        except ValueError:
            last = 200
        from deeplearning4j_tpu_torch.monitor.flightrec import flight_recorder
        rec = flight_recorder()
        return rec, rec.events(kind=kind, last=max(1, last))

    def _events_json(self, q):
        rec, evs = self._events_query(q)
        return json.dumps({"dropped": rec.dropped, "events": evs},
                          default=str)

    def _events_html(self, q):
        """Flight-recorder view (monitor/flightrec.py): the ordered
        control-plane event log — publish/swap/drain/autoscale/
        drift-trip/elastic/watchdog/shed-burst — newest last, the first
        thing an incident review reads (docs/OBSERVABILITY.md "Flight
        recorder")."""
        import time as _time
        rec, evs = self._events_query(q)
        body = [self._nav("events")]
        if rec.dropped:
            body.append(f"<p>{rec.dropped} older events evicted from "
                        f"the ring</p>")
        if not evs:
            body.append(f"<p>{self._tr('no_events')}</p>")
        else:
            body.append("<table border='1' cellpadding='4'>"
                        "<tr><th>seq</th><th>time</th><th>kind</th>"
                        "<th>details</th></tr>")
            for e in evs:
                detail = {k: v for k, v in e.items()
                          if k not in ("ts", "seq", "kind")}
                when = _time.strftime("%H:%M:%S",
                                      _time.localtime(e["ts"]))
                body.append(
                    f"<tr><td>{int(e['seq'])}</td>"
                    f"<td>{when}</td>"
                    f"<td>{_html.escape(str(e['kind']))}</td>"
                    f"<td><code>{_html.escape(json.dumps(detail, default=str))}"
                    f"</code></td></tr>")
            body.append("</table>")
        return self._page(self._tr("title.events"), "".join(body))

    def _alerts_json(self):
        eng = self._alerts
        states = eng.states() if eng is not None else []
        return json.dumps({"attached": eng is not None,
                           "alerts": states}, default=str)

    def _alerts_html(self):
        """Alert-engine view (monitor/alerts.py): every rule's current
        pending/firing/ok state, most urgent first — the codified
        "Default rule pack" table from docs/OBSERVABILITY.md, live."""
        body = [self._nav("alerts")]
        eng = self._alerts
        states = eng.states() if eng is not None else []
        if not states:
            body.append(f"<p>{self._tr('no_alerts')}</p>")
        else:
            colors = {"firing": "#c62828", "pending": "#ef6c00",
                      "ok": "#2e7d32"}
            body.append("<table border='1' cellpadding='4'>"
                        f"<tr><th>{self._tr('alert_rule')}</th>"
                        f"<th>{self._tr('alert_state')}</th>"
                        f"<th>{self._tr('alert_severity')}</th>"
                        f"<th>{self._tr('alert_value')}</th>"
                        f"<th>{self._tr('alert_desc')}</th></tr>")
            for s in states:
                state = str(s["state"])
                val = s.get("value")
                val = "-" if val is None else f"{float(val):.4g}"
                body.append(
                    f"<tr><td><code>{_html.escape(s['name'])}</code></td>"
                    f"<td style='color:{colors.get(state, '#000')};"
                    f"font-weight:bold'>"
                    f"{_html.escape(self._tr('alert_' + state))}</td>"
                    f"<td>{_html.escape(str(s['severity']))}</td>"
                    f"<td>{val}</td>"
                    f"<td>{_html.escape(str(s.get('description') or ''))}"
                    f"</td></tr>")
            body.append("</table>")
        return self._page(self._tr("title.alerts"), "".join(body))

    def _tsne_html(self):
        body = [self._nav("tsne")]
        with self._module_lock:
            tsne = dict(self._tsne)
        for session, d in tsne.items():
            coords = np.asarray(d["coords"])
            chart = ChartScatter(title=f"t-SNE — {session}")
            chart.add_series("points", coords[:, 0].tolist(),
                             coords[:, 1].tolist(), d.get("labels"))
            chart.style.width, chart.style.height = 720, 540
            body.append(chart.render())
        if len(body) == 1:
            body.append("<p>No t-SNE coordinates uploaded. POST JSON "
                        '{"coords": [[x,y],...], "labels": [...]} '
                        "to /tsne/upload.</p>")
        return self._page(self._tr("title.tsne"), "".join(body))

    def _activations_html(self):
        body = [self._nav("activations")]
        with self._module_lock:
            grids = sorted(self._activations.items())
        for name, png in grids:
            b64 = base64.b64encode(png).decode()
            name = _html.escape(name)
            body.append(f"<h4>{name}</h4>"
                        f'<img src="data:image/png;base64,{b64}" '
                        f'style="image-rendering:pixelated;min-width:160px"/>')
        if len(body) == 1:
            body.append("<p>No activation grids posted yet.</p>")
        return self._page(self._tr("title.activations"), "".join(body))

    def _profile_html(self):
        """Cost / roofline page: one section per cost report published
        in this process. The ``PROFILE_*/cost_*.json`` files under the
        working directory are not read: those in this repository are
        the JAX package's TPU tables."""
        from deeplearning4j_tpu_torch.monitor import xprof
        reports = xprof.cost_reports()
        body = [self._nav("profile")]
        for model in sorted(reports):
            rep = reports[model]
            per_op = rep.get("per_op", {}) or {}
            roof = rep.get("roofline", {}) or {}
            pred = rep.get("predicted", {}) or {}
            meas = rep.get("measured", {}) or {}
            body.append(f"<h3>{_html.escape(str(model))}</h3>")

            def fmt(v, scale=1.0, nd=3):
                return (f"{v * scale:.{nd}g}"
                        if isinstance(v, (int, float)) else "—")
            rows = [
                ("FLOPs / step", fmt(per_op.get("total_flops_per_step"))),
                ("conv+dot FLOPs / step (MFU numerator)",
                 fmt(per_op.get("conv_dot_flops_per_step"))),
                ("bytes / step (unfused upper bound)",
                 fmt(per_op.get("total_bytes_per_step"))),
                ("arithmetic intensity (FLOP/byte)",
                 fmt(roof.get("arithmetic_intensity_flop_per_byte"))),
                ("binding ceiling", str(roof.get("bound", "—"))),
                ("predicted step time (ms)",
                 fmt(pred.get("step_seconds"), 1e3, 4)),
                ("predicted MFU (lower bound)", fmt(pred.get("mfu"))),
                ("MFU if compute-bound (upper bound)",
                 fmt(pred.get("mfu_if_compute_bound"))),
                ("peak (TFLOP/s)", fmt(roof.get("peak_tflops"))
                 + f" [{_html.escape(str(roof.get('peak_source', '?')))}]"),
            ]
            if meas:
                rows.append(("measured throughput",
                             fmt(meas.get("throughput")) + " "
                             + _html.escape(str(meas.get("unit", "")))))
                rows.append(("predicted / measured step time",
                             fmt(meas.get(
                                 "predicted_over_measured_step_time"))))
            body.append(ComponentTable(
                ["quantity", "value"], [(k, v) for k, v in rows],
                title=f"{model} — {self._tr('profile.summary')}").render())
            top = per_op.get("top10") or []
            if top:
                body.append(ComponentTable(
                    ["op", "shape", "FLOPs/step", "bytes/step", "share"],
                    [(str(s.get("op")), str(s.get("shape", ""))[:80],
                      fmt(s.get("flops")), fmt(s.get("bytes")),
                      fmt(s.get("share")))
                     for s in top],
                    title=f"{model} — {self._tr('profile.top_ops')}").render())
        if len(body) == 1:
            body.append("<p>No cost reports yet — publish one with "
                        "<code>monitor.xprof.publish_cost_report</code> "
                        "(for example a <code>PagedDecodeEngine"
                        ".decode_cost_report()</code> with its "
                        "<code>xprof.roofline</code> at the card's "
                        "peaks).</p>")
        return self._page(self._tr("title.profile"), "".join(body))

    def _page(self, title, body):
        refresh = getattr(self._req, "refresh", 0)
        meta = (f'<meta http-equiv="refresh" content="{refresh}">'
                if refresh else "")
        return (f"<!doctype html><html><head><title>{title}</title>{meta}"
                f"</head>"
                f"<body style='font-family:sans-serif'>{body}</body></html>")

    # --------------------------------------------------------------- api
    @classmethod
    def get_instance(cls, port: int = 0) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port).start()
        return cls._instance

    def attach(self, storage: StatsStorage):
        self.storage = storage
        return self

    def attach_alerts(self, engine):
        """Serve `/alerts` from this `monitor.alerts.AlertEngine` (the
        states it also publishes as `alert_state` gauges on whatever
        registry it was given)."""
        self._alerts = engine
        return self

    def attach_registry(self, registry):
        """Serve `/metrics` from this MetricsRegistry — or a federation
        `MetricsAggregator` (monitor/federate.py), turning this UI into
        the fleet-wide scrape endpoint — instead of the process-global
        registry."""
        self._registry = registry
        return self

    def metrics_text(self) -> str:
        from deeplearning4j_tpu_torch import monitor
        reg = self._registry if self._registry is not None \
            else monitor.registry()
        # refresh lazy device gauges right before the scrape, into the
        # registry actually being served (no-op on backends without
        # memory_stats, when monitoring is off, and when the source is
        # a federation MetricsAggregator — a merged read-only view with
        # no gauge() to refresh into)
        if monitor.is_enabled() and hasattr(reg, "gauge"):
            mc = monitor.memory_collector()
            if mc is None or mc.registry is not reg:
                mc = monitor.DeviceMemoryCollector(reg)
            mc.collect()
        return reg.exposition()

    def start(self):
        # a short poll interval keeps stop() prompt: shutdown() waits for
        # the serving loop's next poll
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop serving and close the socket. Bounded: `shutdown()` is
        called only for a started server (on one never started it would
        wait forever), and the serving thread is joined for at most 10
        seconds."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(10.0)
            self._thread = None
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None


def main(argv=None):
    """`dl4j-tpu-torch-ui` console entry (reference: PlayUIServer's
    JCommander CLI, `ui/play/PlayUIServer.java`): standalone dashboard
    process; training processes push stats to its /remote route."""
    import argparse
    import time

    ap = argparse.ArgumentParser(prog="dl4j-tpu-torch-ui")
    ap.add_argument("--port", type=int, default=9000)
    args = ap.parse_args(argv)
    server = UIServer(args.port).start()
    print(f"dl4j-tpu-torch UI listening on http://127.0.0.1:{server.port} "
          f"(POST stats to /remote)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
