"""The port's training UI (`deeplearning4j_tpu_torch/ui/`) held to the
JAX package's (`deeplearning4j_tpu/ui/`) on the CPU:

- the i18n tables equal key for key;
- components' JSON and HTML byte-equal, and each package decoding the
  other's JSON;
- the `DL4JSTAT` codec byte-equal both ways, a v1 payload included;
- sqlite stats files read across packages, every connection closed;
- `StatsListener` reports of the same seeded MLP (params carried across
  by `util/jax_params`) trained in both packages, without diagnostics,
  with them and with in-graph histograms: step 0 within STEP0_RTOL,
  later steps within the fit tolerances of `test_torch_port_training`;
  host histograms bin for bin, a value within HIST_EDGE_RTOL of an edge
  counted as a tie that may move one count;
- `activations_to_grid` equal, the port's stdlib PNG decoding (PIL) to
  JAX's PIL-written pixels, the conv listener's grids within one gray
  level of JAX's;
- every page's HTML equal to JAX's for the same storage, registry,
  flight recorder, alert engine and module data (clock cells masked);
- `/profile` served from the repository root shows no TPU table.

It also ports the cases of `tests/test_ui.py`, `tests/test_diagnostics_ui.py`,
`test_monitor.py::TestStatsRssNormalization` and the UI classes of the
serving, fleet, online and observability tests. Every wait is on a
response or a future, never on a sleep."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import contextlib
import functools
import io
import json
import os
import re
import sqlite3
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitor import flightrec as jflightrec
from deeplearning4j_tpu.monitor import xprof as jxprof
from deeplearning4j_tpu.monitor.alerts import AlertEngine as JAlertEngine
from deeplearning4j_tpu.monitor.alerts import AlertRule as JAlertRule
from deeplearning4j_tpu.monitor.registry import MetricsRegistry as JReg
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import convolutional as jconv
from deeplearning4j_tpu.ui import i18n as ji18n
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import storage as jstorage
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.monitor import flightrec as pflightrec
from deeplearning4j_tpu_torch.monitor import xprof as pxprof
from deeplearning4j_tpu_torch.monitor.alerts import AlertEngine, AlertRule
from deeplearning4j_tpu_torch.monitor.diagnostics import DiagnosticsConfig
from deeplearning4j_tpu_torch.monitor.federate import MetricsAggregator
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ui import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    ConvolutionalIterationListener,
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsListener,
    StatsReport,
    UIServer,
    component_from_dict,
    component_from_json,
)
from deeplearning4j_tpu_torch.ui import components as pcomp
from deeplearning4j_tpu_torch.ui import convolutional as pconv
from deeplearning4j_tpu_torch.ui import i18n as pi18n
from deeplearning4j_tpu_torch.ui import server as pserver
from deeplearning4j_tpu_torch.ui import stats as pstats
from deeplearning4j_tpu_torch.ui import storage as pstorage
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP0_RTOL = 1e-6       # step 0's report, port against JAX
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4   # test_torch_port_training's fits
HIST_EDGE_RTOL = 1e-6   # a value this near a bin edge may fall either side


@pytest.fixture(autouse=True)
def _reset_singletons():
    """Neither package's `UIServer._instance` outlives a test."""
    yield
    for cls in (jserver.UIServer, pserver.UIServer):
        if cls._instance is not None:
            cls._instance.stop()
        cls._instance = None


@contextlib.contextmanager
def served(server):
    server.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


def get(base, path, raw=False):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        body = r.read()
    return body if raw else body.decode()


def post(base, path, data):
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


# =============================================================== i18n
def test_i18n_tables_equal_key_for_key():
    assert pi18n._MESSAGES == ji18n._MESSAGES
    assert pi18n.LANGUAGES == ji18n.LANGUAGES == ("en", "ja", "zh")
    for lang in ("en", "ja", "zh", "xx"):
        for key in list(ji18n._MESSAGES["en"]) + ["no.such.key"]:
            assert pi18n.tr(lang, key) == ji18n.tr(lang, key)


# ========================================================== components
def _component(m, case):
    """The same component built through module `m` (either package's
    `ui/components.py`)."""
    if case == "line":
        c = m.ChartLine(title="loss <&>")
        c.add_series("train", [0, 1, 2], [3.0, 2.0, 1.5])
        c.add_series("val", [0, 1, 2], [3.2, 2.5, 1e-9])
        return c
    if case == "line_styled":
        c = m.ChartLine(title="s", style=m.ChartStyle(
            width=300, height=120, stroke_width=2.0,
            series_colors=("#000", "#111"), background="#fff"))
        for i in range(3):
            c.add_series(f"s{i}", [0.5, 7.25], [float(i), -1.0 / 3])
        return c
    if case == "line_flat":
        return m.ChartLine(title="flat").add_series("one", [4], [4])
    if case == "line_empty":
        return m.ChartLine()
    if case == "histogram":
        h = m.ChartHistogram(title="weights")
        for i in range(5):
            h.add_bin(i - 2.5, i - 1.5, 10 * i - 7)
        return h
    if case == "scatter":
        s = m.ChartScatter(title="tsne")
        s.add_series("pts", [0.0, 1.0, -2.5], [0.0, 1.0, 3.0],
                     ["a", "</text><b>", "c"])
        s.add_series("more", [0.125], [9.0])
        return s
    if case == "table_text_div":
        return m.ComponentDiv(
            m.ComponentText("hello <world>"),
            m.ComponentTable(["k", "v"], [["a", 1], ["<b>", 2.5]],
                             title="t"),
            m.ComponentDiv(m.ComponentText("")))
    raise KeyError(case)


COMPONENT_CASES = ("line", "line_styled", "line_flat", "line_empty",
                   "histogram", "scatter", "table_text_div")


@pytest.mark.parametrize("case", COMPONENT_CASES)
def test_component_json_and_html_byte_equal(case):
    j, p = _component(jcomp, case), _component(pcomp, case)
    assert p.to_json() == j.to_json()
    assert p.to_json(indent=1, sort_keys=True) == \
        j.to_json(indent=1, sort_keys=True)
    assert p.render() == j.render()
    # each package decodes the other's JSON to the same bytes
    assert pcomp.component_from_json(j.to_json()).render() == j.render()
    assert jcomp.component_from_json(p.to_json()).to_json() == p.to_json()


# =============================================================== codec
def _report(m, kind, it=3):
    """The same StatsReport built in module `m` (either `ui/stats.py`)."""
    if kind == "empty":
        return m.StatsReport("s", "w", it, 0, 0.0, float("inf"))
    names = ("0_W", "0_b") if kind == "full" else ("層_W", "é_b")
    return m.StatsReport(
        session_id="sess" if kind == "full" else "セッション",
        worker_id="w0", iteration=it, epoch=1, timestamp=123.25,
        score=0.5 + it, iteration_time_ms=7.5, examples_per_sec=1024.0,
        param_mean_magnitudes={names[0]: 0.1, names[1]: 1e-300},
        update_mean_magnitudes={names[0]: 1e-3},
        param_histograms={names[0]: ([-1.0, 0.0, 1.0], [3, 5]),
                          names[1]: ([0.0, 1.0], [2 ** 40])},
        memory_rss_mb=42.0,
        gradient_mean_magnitudes={names[0]: 0.02},
        update_ratios={names[0]: 0.01, names[1]: 0.0},
        activation_stats={"0": (0.4, 0.5, 0.25), "1": (-1.0, 0.0, 1.0)},
        watchdog_nonfinite=2)


def _encode_v1(r) -> bytes:
    """A genuine v1 payload (the pre-diagnostics codec)."""
    def pack_str(s):
        b = s.encode("utf-8")
        return struct.pack("<H", len(b)) + b

    out = [b"DL4JSTAT", struct.pack("<H", 1), pack_str(r.session_id),
           pack_str(r.worker_id),
           struct.pack("<qqdddd", r.iteration, r.epoch, r.timestamp,
                       r.score, r.iteration_time_ms, r.examples_per_sec),
           struct.pack("<d", r.memory_rss_mb)]
    for table in (r.param_mean_magnitudes, r.update_mean_magnitudes):
        out.append(struct.pack("<H", len(table)))
        for k, v in table.items():
            out.append(pack_str(k))
            out.append(struct.pack("<d", v))
    out.append(struct.pack("<H", len(r.param_histograms)))
    for k, (edges, counts) in r.param_histograms.items():
        out.append(pack_str(k))
        out.append(struct.pack("<H", len(counts)))
        out.append(np.asarray(edges, np.float64).tobytes())
        out.append(np.asarray(counts, np.int64).tobytes())
    return b"".join(out)


def _fields(r):
    import dataclasses
    return dataclasses.asdict(r)


@pytest.mark.parametrize("kind", ["full", "unicode", "empty"])
def test_codec_byte_equal_both_ways(kind):
    j, p = _report(jstats, kind), _report(pstats, kind)
    assert p.encode() == j.encode()
    assert _fields(pstats.StatsReport.decode(j.encode())) == _fields(j)
    assert _fields(jstats.StatsReport.decode(p.encode())) == _fields(p)
    assert pstats.StatsReport.decode(p.encode()) == p


def test_v1_payload_decodes_in_both_packages():
    payload = _encode_v1(_report(pstats, "full"))
    j, p = (m.StatsReport.decode(payload) for m in (jstats, pstats))
    assert _fields(p) == _fields(j)
    assert p.gradient_mean_magnitudes == {} and p.activation_stats == {}
    assert p.watchdog_nonfinite == 0
    assert p.param_histograms == _report(pstats, "full").param_histograms
    with pytest.raises(ValueError, match="bad magic"):
        pstats.StatsReport.decode(b"NOTSTATS" + payload[8:])


# ============================================================= storage
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_files_read_across_packages(tmp_path, writer):
    w, r = (jstorage, pstorage) if writer == "jax" else (pstorage, jstorage)
    ws = w.FileStatsStorage(tmp_path / "stats.db")
    sm = jstats if writer == "jax" else pstats
    for it in (5, 1, 3):
        ws.put_report(_report(sm, "full", it))
    ws.put_report(_report(sm, "unicode", 2))
    ws.put_report(_report(sm, "full", 3))          # replaces iteration 3
    rs = r.FileStatsStorage(tmp_path / "stats.db")
    assert sorted(rs.list_session_ids()) == sorted(ws.list_session_ids()) \
        == sorted(["sess", "セッション"])
    got = rs.get_reports("sess")
    assert [g.iteration for g in got] == [1, 3, 5]
    assert [g.encode() for g in got] == \
        [x.encode() for x in ws.get_reports("sess")]
    assert rs.latest_report("sess").iteration == 5


def test_file_storage_closes_every_connection(tmp_path, monkeypatch):
    opened = []
    real = sqlite3.connect

    def connect(*a, **k):
        c = real(*a, **k)
        opened.append(c)
        return c
    monkeypatch.setattr(sqlite3, "connect", connect)
    st = FileStatsStorage(tmp_path / "s.db")
    st.put_report(_report(pstats, "full"))
    st.list_session_ids()
    st.get_reports("sess")
    assert len(opened) == 4
    for c in opened:
        with pytest.raises(sqlite3.ProgrammingError):
            c.execute("SELECT 1")          # closed
    assert len(FileStatsStorage(tmp_path / "s.db").get_reports("sess")) == 1


# ============================================== StatsListener vs JAX
def _jax_conf(diag, depth=2):
    from deeplearning4j_tpu.common.updaters import Adam as JAdam
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.layers import DenseLayer as JD
    from deeplearning4j_tpu.nn.layers import OutputLayer as JO
    lb = JNNC.builder().seed(11).updater(JAdam(0.01)).list()
    for _ in range(depth):
        lb = lb.layer(JD(n_in=8, n_out=8, activation="relu"))
    lb = lb.layer(JO(n_in=8, n_out=3, activation="softmax", loss="mcxent"))
    if diag is not None:
        lb = lb.diagnostics(diag)
    return lb.build()


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


DIAG_SPECS = {
    "none": None,
    "diagnostics": True,
    "in_graph_hist": dict(histograms=True, histogram_bins=8,
                          histogram_range=0.75),
}


def _twin(diag):
    """(JAX net, port net on the CPU) with equal params; the port's from
    JAX's configuration.json."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    jc = _jax_conf(diag)
    jnet = JNet(jc).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                            device="cpu").init()
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


@functools.lru_cache(maxsize=None)
def _fit_both(diag_name):
    """Each package's reports of the same 4-step fit (histograms on)."""
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JMem
    from deeplearning4j_tpu.ui import StatsListener as JListener
    spec = DIAG_SPECS[diag_name]
    if isinstance(spec, dict):
        import deeplearning4j_tpu.monitor.diagnostics as jd
        jspec, pspec = jd.DiagnosticsConfig(**spec), DiagnosticsConfig(**spec)
    else:
        jspec = pspec = spec
    jnet, net = _twin(jspec)
    assert (net._diag is None) == (spec is None)
    if isinstance(spec, dict):
        assert net.diagnostics == pspec
    x, y = _data()
    js, ps = JMem(), InMemoryStatsStorage()
    jnet.set_listeners(JListener(js, collect_histograms=True))
    net.set_listeners(StatsListener(ps, collect_histograms=True))
    jnet.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
    return (js.get_reports("default"), ps.get_reports("default"),
            to_numpy_params(jnet.params))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("diag", list(DIAG_SPECS))
def test_listener_reports_match_jax(diag):
    jrs, prs, _ = _fit_both(diag)
    assert [r.iteration for r in prs] == [r.iteration for r in jrs] == \
        [0, 1, 2, 3]
    for i, (j, p) in enumerate(zip(jrs, prs)):
        tol = STEP0_RTOL if i == 0 else PARAM_RTOL
        assert _rel(p.score, j.score) <= (STEP0_RTOL if i == 0
                                          else LOSS_RTOL)
        for f in ("param_mean_magnitudes", "update_mean_magnitudes",
                  "gradient_mean_magnitudes", "update_ratios"):
            jt, pt = getattr(j, f), getattr(p, f)
            assert list(pt) == list(jt), (i, f)      # keys, in order
            for k in jt:
                assert _rel(pt[k], jt[k]) <= tol, (i, f, k, pt[k], jt[k])
        assert list(p.activation_stats) == list(j.activation_stats)
        for k, st in j.activation_stats.items():
            np.testing.assert_allclose(p.activation_stats[k], st,
                                       rtol=tol, atol=1e-7)
        assert p.watchdog_nonfinite == j.watchdog_nonfinite == 0
        assert list(p.param_histograms) == list(j.param_histograms)
        assert p.session_id == j.session_id and p.epoch == j.epoch
    first = prs[0]
    if diag == "none":
        # step 0 has no earlier params: no update magnitudes yet
        assert first.update_mean_magnitudes == {} == first.update_ratios
        assert prs[1].update_mean_magnitudes
    else:
        assert set(first.update_ratios) == set(first.param_mean_magnitudes)
        assert set(first.gradient_mean_magnitudes) == \
            set(first.param_mean_magnitudes)
        assert set(first.activation_stats) == {"0", "1"}


def _edge_ties(a, b, edges):
    """Values of either array within HIST_EDGE_RTOL (of the range) of
    an inner edge: each may move one count between neighbours."""
    scale = max(abs(edges[0]), abs(edges[-1]), 1e-30)
    inner = np.asarray(edges[1:-1])
    n = 0
    for arr in (a, b):
        d = np.abs(np.asarray(arr).reshape(-1, 1) - inner.reshape(1, -1))
        n += int(np.sum(d.min(axis=1) <= HIST_EDGE_RTOL * scale)) \
            if inner.size else 0
    return n


@pytest.mark.parametrize("diag", ["none", "in_graph_hist"])
def test_histograms_bin_for_bin(diag):
    """Host histograms (`np.histogram` on the one host copy) and the
    in-graph ones: edges within STEP0_RTOL of JAX's, counts equal but
    for counted near-edge ties; each sums to its leaf's size."""
    jrs, prs, final = _fit_both(diag)
    sizes = {f"{lk}_{pk}": a.size for lk, lp in final.items()
             for pk, a in lp.items()}
    for j, p in zip(jrs, prs):
        for k, (jedges, jcounts) in j.param_histograms.items():
            pedges, pcounts = p.param_histograms[k]
            assert len(pedges) == len(jedges) == len(jcounts) + 1
            np.testing.assert_allclose(pedges, jedges, rtol=STEP0_RTOL,
                                       atol=1e-7)
            lk, pk = k.split("_", 1)
            if diag == "none":
                assert sum(pcounts) == sum(jcounts) == sizes[k]
            else:
                # fixed bins over [-r, r]: values outside are not counted
                assert sum(pcounts) == sum(jcounts) <= sizes[k]
                if p is prs[-1]:
                    assert sum(pcounts) == int(np.sum(
                        np.abs(final[lk][pk]) <= 0.75))
            moved = int(np.sum(np.abs(np.subtract(pcounts, jcounts))))
            if moved:
                # only the last report's params are kept: a moved count
                # is allowed only there, at a counted near-edge value
                assert p is prs[-1], (k, p.iteration)
                ties = _edge_ties(final[lk][pk], final[lk][pk], pedges)
                assert moved <= 2 * ties, (k, moved, ties)
    if diag == "in_graph_hist":
        assert len(prs[0].param_histograms["0_W"][1]) == 8
        np.testing.assert_array_equal(prs[0].param_histograms["0_W"][0],
                                      np.linspace(-0.75, 0.75, 9))


def test_histogram_edge_tie_count_sees_an_edge_value():
    """The tie counter counts a value sitting on an inner edge."""
    edges = np.linspace(-1, 1, 5)
    assert _edge_ties(np.array([0.0, 0.3]), np.array([0.2]), edges) == 1
    assert _edge_ties(np.array([0.3]), np.array([0.2]), edges) == 0


def test_listener_graph_keys_split_on_first_underscore():
    """A graph's report keys are f"{vertex}_{param}", as JAX names them;
    the model page groups them by the vertex before the first '_'."""
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        ComputationGraphConfiguration,
    )
    conf = (ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder().seed(3).updater(Adam(0.01)))
        .add_inputs("in")
        .add_layer("d0", DenseLayer(n_in=8, n_out=8, activation="tanh"),
                   "in")
        .add_layer("out", OutputLayer(n_in=8, n_out=3,
                                      activation="softmax",
                                      loss="mcxent"), "d0")
        .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st))
    x, y = _data(16)
    net.fit(x, y, epochs=1, batch_size=8)
    r = st.latest_report("default")
    assert set(r.param_mean_magnitudes) == {"d0_W", "d0_b", "out_W",
                                            "out_b"}
    html = UIServer().attach(st)._model_html()
    assert "layer d0 — mean |param|" in html
    assert "layer out — mean |param|" in html


def test_explicit_none_diagnostics_is_off_cadence():
    """`diagnostics=None` in the callback means off-cadence: the
    listener reads the params (param-delta path) rather than relabel the
    model's stale readback with this iteration."""
    _, net = _twin(True)
    x, y = _data(8)
    net.fit(x, y, epochs=1, batch_size=8)
    assert net._last_diagnostics is not None
    st = InMemoryStatsStorage()
    lst = StatsListener(st)
    lst.iteration_done(net, 5, 0, 1.0, diagnostics=None)
    lst.iteration_done(net, 6, 0, 1.0)            # key absent: the model's
    off, on = st.get_reports("default")
    assert off.update_ratios == {} and off.gradient_mean_magnitudes == {}
    assert set(on.update_ratios) == set(on.param_mean_magnitudes)


def test_prev_params_are_copies_not_views():
    """On the CPU the host tree views the live params; the delta
    fallback keeps copies, so an in-place update shows as a delta."""
    _, net = _twin(None)
    st = InMemoryStatsStorage()
    lst = StatsListener(st)
    lst.iteration_done(net, 0, 0, 1.0)
    with torch.no_grad():
        net.layers[0].jax_param_map()["W"].add_(0.5)
    lst.iteration_done(net, 1, 0, 1.0)
    r = st.latest_report("default")
    assert r.update_mean_magnitudes["0_W"] == pytest.approx(0.5)
    assert r.update_mean_magnitudes["0_b"] == 0.0


# ======================================================== conv / PNG
@pytest.mark.parametrize("shape", [(5, 7, 6), (3, 3, 1), (8, 8, 10)])
def test_activations_to_grid_equal_to_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    a[..., 0] = 2.0                               # a constant channel
    g = pconv.activations_to_grid(a)
    np.testing.assert_array_equal(g, jconv.activations_to_grid(a))
    np.testing.assert_array_equal(pconv.activations_to_grid(a, pad=0),
                                  jconv.activations_to_grid(a, pad=0))
    assert g.dtype == np.uint8


@pytest.mark.parametrize("shape", [(1, 1), (9, 16), (31, 7)])
def test_png_pixels_equal_to_pil_written(shape):
    from PIL import Image
    grid = np.random.default_rng(shape[0]).integers(
        0, 256, shape).astype(np.uint8)
    png = pconv.png_gray(grid)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    mine = Image.open(io.BytesIO(png))
    assert mine.mode == "L" and mine.size == (shape[1], shape[0])
    jax_png = jserver.UIServer().post_activation_grid(
        "g", grid)._activations["g"]
    theirs = np.asarray(Image.open(io.BytesIO(jax_png)))
    np.testing.assert_array_equal(np.asarray(mine), theirs)
    np.testing.assert_array_equal(np.asarray(mine), grid)
    with pytest.raises(ValueError):
        pconv.png_gray(np.zeros((2, 2, 3), np.uint8))


def _jax_conv_conf():
    from deeplearning4j_tpu.common.updaters import Adam as JAdam
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
    from deeplearning4j_tpu.nn.layers import OutputLayer as JO
    from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JSub
    return (JNNC.builder().seed(0).updater(JAdam(1e-2)).list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JConv(n_out=5, kernel_size=(2, 2), activation="tanh"))
            .layer(JO(n_out=2))
            .set_input_type(JIT.convolutional(8, 8, 1)).build())


def test_conv_listener_grids_match_jax(tmp_path):
    from PIL import Image
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    jc = _jax_conv_conf()
    jnet = JNet(jc).init()
    net = from_jax_params(
        MultiLayerNetwork(MultiLayerConfiguration.from_json(jc.to_json()),
                          device="cpu").init(),
        to_numpy_params(jnet.params))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    jui_srv, pui_srv = jserver.UIServer(), UIServer()
    jnet.set_listeners(jconv.ConvolutionalIterationListener(
        tmp_path / "jax", frequency=1, ui_server=jui_srv))
    net.set_listeners(ConvolutionalIterationListener(
        tmp_path / "port", frequency=1, ui_server=pui_srv))
    jnet.fit(x, y, epochs=1, batch_size=2, shuffle=False)
    net.fit(x, y, epochs=1, batch_size=2, shuffle=False)
    # JAX's numbering: the conv and pooling layers are 4-D
    assert sorted(pui_srv._activations) == sorted(jui_srv._activations) \
        == ["layer0", "layer1", "layer2"]
    for name, png in pui_srv._activations.items():
        mine = np.asarray(Image.open(io.BytesIO(png)), np.int16)
        theirs = np.asarray(Image.open(io.BytesIO(
            jui_srv._activations[name])), np.int16)
        assert mine.shape == theirs.shape
        assert np.abs(mine - theirs).max() <= 1, name
    files = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert files == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert "iter000001_layer2.png" in files and len(files) == 6


def test_conv_listener_skips_a_graph_and_raises_on_a_failed_forward():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    class Sink:
        def __init__(self):
            self.posted = []

        def post_activation_grid(self, name, grid):
            self.posted.append(name)
    sink = Sink()
    lst = ConvolutionalIterationListener(ui_server=sink, frequency=1)
    graph = ComputationGraph.__new__(ComputationGraph)
    lst.iteration_done(graph, 0, 0, 1.0, batch=(np.zeros((1, 8, 8, 1)),))
    assert sink.posted == []                # JAX's outcome, no forward
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conv_conf().to_json()), device="cpu").init()
    with pytest.raises(RuntimeError):
        # three channels where the first conv takes one
        lst.iteration_done(net, 0, 0, 1.0,
                           batch=(np.zeros((1, 8, 8, 3), np.float32),))
    lst.iteration_done(net, 0, 0, 1.0,
                       batch=(np.zeros((1, 8, 8, 1), np.float32),))
    assert sink.posted == ["layer0", "layer1", "layer2"]
    with pytest.raises(ValueError):
        ConvolutionalIterationListener()


# ====================================================== pages vs JAX
def _fill_registry(reg):
    """The same families in either package's MetricsRegistry."""
    reg.counter("serving_requests_total", help="r").inc(4)
    reg.counter("serving_tokens_total", help="t").inc(64)
    reg.gauge("serving_queue_depth", help="q").set(2)
    reg.gauge("serving_active_slots", help="a").set(3)
    reg.gauge("serving_pool_blocks_used", help="u").set(6)
    reg.gauge("serving_pool_blocks_free", help="f").set(10)
    reg.gauge("serving_spec_accept_rate", help="s",
              proposer="ngram").set(0.625)
    h = reg.histogram("serving_ttft_seconds", help="ttft",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5):
        h.observe(v)
    for model, ver, depth in (("alpha", 2, 1), ("beta", 1, 0),
                              ("gone", 0, 0)):
        reg.gauge("fleet_model_version", help="v", model=model).set(ver)
        reg.gauge("fleet_queue_depth", help="d", model=model).set(depth)
        reg.counter("fleet_shed_total", help="s", model=model).inc(ver)
    reg.counter("registry_published_total", help="p", model="alpha").inc(2)
    reg.counter("streaming_records_consumed_total", help="c",
                topic="ui").inc(16)
    reg.gauge("streaming_lag_records", help="l", topic="ui").set(0)
    reg.gauge("streaming_watermark_age_seconds", help="w",
              topic="ui").set(1.5)
    reg.counter("online_publishes_total", help="p", model="m").inc(3)
    reg.gauge("online_publish_paused", help="g", tag="heldout").set(1.0)
    reg.gauge("training_score", help="s").set(0.25)
    return reg


def _fill_storage(storage, m):
    for it in (0, 10, 20):
        storage.put_report(m.StatsReport(
            session_id="s<1>", worker_id="w0", iteration=it, epoch=0,
            timestamp=float(it), score=1.0 / (it + 1),
            iteration_time_ms=5.0 + it, examples_per_sec=100.0 + it,
            param_mean_magnitudes={"0_W": 0.5, "0_b": 0.01, "1_W": 0.25},
            update_mean_magnitudes=({"0_W": 0.005, "1_W": 1e-4}
                                    if it else {}),
            param_histograms={"0_W": ([-1.0, 0.0, 1.0], [3, 7 + it])},
            memory_rss_mb=256.0,
            gradient_mean_magnitudes={"0_W": 0.02 + it, "1_W": 0.5},
            update_ratios={"0_W": 0.01, "1_W": 0.0},
            activation_stats={"0": (0.4, 0.5, 0.25)},
            watchdog_nonfinite=it // 10))
    storage.put_report(m.StatsReport("other", "w1", 1, 0, 1.0, 0.75))
    return storage


_COST = {"model": "demo_model",
         "per_op": {"total_flops_per_step": 1.0e9,
                    "total_bytes_per_step": 2.0e8,
                    "conv_dot_flops_per_step": 9.0e8,
                    "top10": [{"op": "mm", "shape": "f32[8,4] -> f32[8,8]",
                               "flops": 9.0e8, "bytes": 1e6,
                               "share": 0.9}]},
         "roofline": {"arithmetic_intensity_flop_per_byte": 5.0,
                      "bound": "memory", "peak_tflops": 67.0,
                      "peak_source": "H100 fp32"},
         "predicted": {"step_seconds": 0.01, "mfu": 0.2,
                       "mfu_if_compute_bound": 0.9},
         "measured": {"throughput": 123.0, "unit": "tok/s",
                      "predicted_over_measured_step_time": 0.5}}


@pytest.fixture(scope="module")
def twin_servers(tmp_path_factory):
    """A JAX and a port UIServer with equal contents: storage, registry,
    flight recorder, alert engine, t-SNE map, activation grid and cost
    report. Started in a directory with no PROFILE_* tables; one pair
    for every page test (JAX's server takes 0.5 s to stop)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.chdir(tmp_path_factory.mktemp("pages"))
        yield from _twin_servers(monkeypatch)


def _twin_servers(monkeypatch):
    out = []
    grid = (np.arange(48).reshape(6, 8) * 5).astype(np.uint8)
    for fr_mod, xp, Reg, Eng, Rule, srv_mod, st_mod, stats_mod in (
            (jflightrec, jxprof, JReg, JAlertEngine, JAlertRule, jserver,
             jstorage, jstats),
            (pflightrec, pxprof, MetricsRegistry, AlertEngine, AlertRule,
             pserver, pstorage, pstats)):
        rec = fr_mod.FlightRecorder()
        monkeypatch.setattr(fr_mod, "flight_recorder", lambda r=rec: r)
        rec.record("swap", model="ui-probe", from_version=1, to_version=2)
        rec.record("publish", model="m", version=3, note="<x>")
        reg = _fill_registry(Reg())
        eng = Eng(reg, [Rule("queue_deep", "threshold",
                             metric="serving_queue_depth", op=">",
                             value=1.0, severity="page",
                             description="queue <deep>"),
                        Rule("slow_ok", "threshold",
                             metric="serving_active_slots", op=">",
                             value=99.0)], recorder=rec, registry=Reg())
        eng.evaluate(now=100.0)
        xp.clear_cost_reports()
        xp.publish_cost_report(dict(_COST), registry=Reg())
        server = srv_mod.UIServer(registry=reg).attach(
            _fill_storage(st_mod.InMemoryStatsStorage(), stats_mod))
        server.attach_alerts(eng)
        server.post_tsne("emb", [[0.0, 0.0], [1.0, 2.0]], ["cat", "<dog>"])
        server.post_activation_grid("layer0", grid)
        out.append(server.start())
    try:
        yield tuple(f"http://127.0.0.1:{s.port}" for s in out)
    finally:
        for s in out:
            s.stop()
        jxprof.clear_cost_reports()
        pxprof.clear_cost_reports()


PAGES = ["/", "/train", "/train/overview", "/train/overview?lang=ja",
         "/train/overview?lang=zh&refresh=5", "/train/overview?lang=%22",
         "/train/model", "/train/model?lang=zh", "/train/system",
         "/train/system?refresh=2", "/tsne", "/activations", "/profile",
         "/serving", "/events", "/events?kind=swap&last=1",
         "/events?last=x", "/alerts", "/alerts?lang=ja", "/metrics",
         "/api/sessions", "/api/reports/s<1>", "/api/components/s<1>",
         "/api/components/none", "/api/profile", "/alerts?format=json",
         "/no/such/page"]


def _mask(path, body):
    """Clock-dependent cells: the events' wall times, their JSON
    timestamps, the alerts' evaluation times; and the activation PNGs'
    bytes (pixels are held in the PNG tests)."""
    body = re.sub(r"<td>\d\d:\d\d:\d\d</td>", "<td>T</td>", body)
    body = re.sub(r'"(ts|since|last_eval|t)": [0-9.e+-]+', r'"\1": 0',
                  body)
    return re.sub(r"base64,[A-Za-z0-9+/=]+", "base64,PNG", body)


@pytest.mark.parametrize("path", PAGES)
def test_page_equal_to_jax(twin_servers, path):
    jbase, pbase = twin_servers
    got = want = None
    try:
        want = get(jbase, path)
    except urllib.error.HTTPError as e:
        want = e.code
    try:
        got = get(pbase, path)
    except urllib.error.HTTPError as e:
        got = e.code
    if isinstance(want, str):
        got, want = _mask(path, got), _mask(path, want)
    assert got == want


def test_events_json_equal_to_jax(twin_servers):
    jbase, pbase = twin_servers
    docs = [json.loads(get(b, "/events?format=json")) for b in twin_servers]
    for d in docs:
        for e in d["events"]:
            e.pop("ts")
    assert docs[0] == docs[1]
    assert [e["kind"] for e in docs[1]["events"]][:2] == ["swap", "publish"]


# ======================================= /profile: the card's only
def test_profile_from_repo_root_shows_no_tpu_table(monkeypatch):
    """Served from the repository root, JAX's page renders the committed
    PROFILE_aot tables (a TPU v5 lite's); the port's renders none."""
    monkeypatch.chdir(REPO)
    assert os.path.exists(os.path.join(REPO, "PROFILE_aot",
                                       "cost_transformer.json"))
    jxprof.clear_cost_reports()
    pxprof.clear_cost_reports()
    with served(jserver.UIServer()) as jbase:
        assert "tpu" in get(jbase, "/api/profile").lower()
    with served(UIServer()) as base:
        for path in ("/profile", "/api/profile"):
            assert "tpu" not in get(base, path).lower(), path
        assert json.loads(get(base, "/api/profile")) == {}
        assert "transformer" not in get(base, "/profile")


def test_profile_empty_hint_names_no_jax_tool(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pxprof.clear_cost_reports()
    with served(UIServer()) as base:
        html = get(base, "/profile")
    assert "publish_cost_report" in html
    assert "benchtools" not in html and "hlo_cost" not in html


def test_profile_renders_published_report():
    pxprof.clear_cost_reports()
    pxprof.publish_cost_report(dict(_COST), registry=MetricsRegistry())
    try:
        with served(UIServer()) as base:
            html = get(base, "/profile")
            assert "demo_model" in html and "f32[8,4]" in html
            api = json.loads(get(base, "/api/profile"))
            assert api["demo_model"]["predicted"]["mfu"] == 0.2
    finally:
        pxprof.clear_cost_reports()


# ============================================ server lifecycle, entry
def test_stop_is_bounded_started_or_not():
    import time
    t0 = time.perf_counter()
    UIServer().stop()                          # never started
    s = UIServer().start()
    get(f"http://127.0.0.1:{s.port}", "/api/sessions")
    s.stop()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(urllib.error.URLError):
        get(f"http://127.0.0.1:{s.port}", "/api/sessions")


def test_get_instance_is_a_singleton_reset_by_stop():
    a = UIServer.get_instance()
    assert UIServer.get_instance() is a and a._thread is not None
    a.stop()
    assert UIServer._instance is None
    b = UIServer.get_instance()
    assert b is not a
    b.stop()


def test_console_entry_is_declared():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'dl4j-tpu-torch-ui = "deeplearning4j_tpu_torch.ui.server:main"' \
        in text
    with pytest.raises(SystemExit):
        pserver.main(["--help"])


def test_exports_equal_jax():
    import deeplearning4j_tpu.ui as jui
    import deeplearning4j_tpu_torch.ui as pui
    public = {n for n in dir(jui) if not n.startswith("_")} - {
        "components", "convolutional", "i18n", "server", "stats", "storage"}
    assert public <= set(dir(pui))


# ====================================== tests/test_ui.py, on the port
def make_report(it=3, score=0.5):
    return StatsReport(
        session_id="s1", worker_id="w0", iteration=it, epoch=0,
        timestamp=123.0, score=score, iteration_time_ms=10.0,
        examples_per_sec=100.0,
        param_mean_magnitudes={"0_W": 0.12, "0_b": 0.01},
        update_mean_magnitudes={"0_W": 0.001},
        param_histograms={"0_W": ([0.0, 0.5, 1.0], [3, 7])},
        memory_rss_mb=256.0)


def _mlp(n_in=6, seed=0):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_in=n_in, n_out=8, activation="relu"))
            .layer(OutputLayer(n_in=8, n_out=2))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _train(listener, n_in=6, n=64, epochs=3, batch_size=32):
    net = _mlp(n_in).set_listeners(listener)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    net.fit(x, y, epochs=epochs, batch_size=batch_size)
    return net


class TestWireFormat:
    def test_roundtrip(self):
        r = make_report()
        back = StatsReport.decode(r.encode())
        assert back.session_id == "s1" and back.iteration == 3
        assert back.param_mean_magnitudes == r.param_mean_magnitudes
        assert back.param_histograms["0_W"][1] == [3, 7]
        assert back.memory_rss_mb == 256.0


class TestStorage:
    def test_in_memory(self):
        st = InMemoryStatsStorage()
        st.put_report(make_report(1))
        st.put_report(make_report(2))
        assert st.list_session_ids() == ["s1"]
        assert [r.iteration for r in st.get_reports("s1")] == [1, 2]
        assert st.latest_report("s1").iteration == 2

    def test_sqlite_roundtrip(self, tmp_path):
        st = FileStatsStorage(tmp_path / "stats.db")
        st.put_report(make_report(1, 0.9))
        st.put_report(make_report(5, 0.4))
        st2 = FileStatsStorage(tmp_path / "stats.db")  # reopen
        reports = st2.get_reports("s1")
        assert [r.iteration for r in reports] == [1, 5]
        assert reports[1].score == 0.4


class TestListenerAndServer:
    def test_stats_listener_collects(self):
        storage = InMemoryStatsStorage()
        _train(StatsListener(storage, session_id="train1",
                             collect_histograms=True))
        reports = storage.get_reports("train1")
        assert len(reports) == 6  # 3 epochs x 2 batches
        assert "0_W" in reports[0].param_mean_magnitudes
        assert "1_W" in reports[0].param_histograms
        assert reports[-1].memory_rss_mb > 0

    def test_server_pages_and_api(self):
        storage = InMemoryStatsStorage()
        _train(StatsListener(storage, session_id="ui_sess"))
        with served(UIServer().attach(storage)) as base:
            for page in ("/train/overview", "/train/model", "/train/system"):
                assert "ui_sess" in get(base, page)
            api = json.loads(get(base, "/api/reports/ui_sess"))
            assert len(api) == 6 and "score" in api[0]

    def test_remote_router(self):
        with served(UIServer()) as base:       # its own in-memory storage
            router = RemoteUIStatsStorageRouter(base)
            router.put_report(make_report(7))
            reports = json.loads(get(base, "/api/reports/s1"))
            assert [r["iteration"] for r in reports] == [7]

    def test_remote_rejects_a_bad_payload(self):
        with served(UIServer()) as base:
            with pytest.raises(urllib.error.HTTPError) as e:
                post(base, "/remote", b"garbage")
            assert e.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as e:
                post(base, "/nowhere", b"")
            assert e.value.code == 404


class TestConvListener:
    def test_saves_activation_grids(self, tmp_path):
        conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-2))
                .list()
                .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(OutputLayer(n_out=2))
                .set_input_type(InputType.convolutional(8, 8, 1)).build())
        net = MultiLayerNetwork(conf, device="cpu").init().set_listeners(
            ConvolutionalIterationListener(tmp_path, frequency=1))
        rng = np.random.default_rng(0)
        x = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        net.fit(x, y, epochs=1, batch_size=4)
        pngs = list(tmp_path.glob("*.png"))
        assert len(pngs) >= 1  # at least the conv layer grid


class TestComponents:
    def test_chart_line_roundtrip_and_render(self):
        c = ChartLine(title="loss")
        c.add_series("train", [0, 1, 2], [3.0, 2.0, 1.5])
        c.add_series("val", [0, 1, 2], [3.2, 2.5, 2.0])
        rt = component_from_json(c.to_json())
        assert rt.to_dict() == c.to_dict()
        svg = rt.render()
        assert svg.count("<polyline") == 2 and "loss" in svg
        with pytest.raises(ValueError):
            c.add_series("bad", [0, 1], [0])

    def test_chart_histogram_roundtrip_and_render(self):
        h = ChartHistogram(title="weights")
        for i in range(5):
            h.add_bin(i, i + 1, 10 * i)
        rt = component_from_dict(h.to_dict())
        assert rt.to_dict() == h.to_dict()
        assert rt.render().count("<rect") >= 5  # bg + bins

    def test_chart_scatter_labels(self):
        s = ChartScatter(title="tsne")
        s.add_series("pts", [0.0, 1.0], [0.0, 1.0], ["a", "b"])
        svg = component_from_dict(s.to_dict()).render()
        assert svg.count("<circle") == 2 and ">a</text>" in svg

    def test_table_text_div(self):
        div = ComponentDiv(ComponentText("hello"),
                           ComponentTable(["k", "v"], [["a", 1]], title="t"))
        html = component_from_dict(div.to_dict()).render()
        assert "hello" in html and "<table" in html and "<h4>t</h4>" in html


class TestUIModules:
    def _train_with_stats(self, server):
        _train(StatsListener(server.storage, session_id="s-mod",
                             collect_histograms=True), n_in=4, n=16,
               batch_size=8)

    def test_model_drilldown_page(self):
        server = UIServer()
        self._train_with_stats(server)
        with served(server) as base:
            html = get(base, "/train/model")
        assert "mean |param|" in html and "<polyline" in html
        assert "distribution" in html and "<rect" in html
        assert "latest parameter magnitudes" in html
        assert "Δ" in html

    def test_system_page_has_timing(self):
        server = UIServer()
        self._train_with_stats(server)
        with served(server) as base:
            html = get(base, "/train/system")
        assert "RSS MB" in html and "ms/iter" in html

    def test_tsne_module_upload_and_render(self):
        with served(UIServer()) as base:
            payload = json.dumps({
                "session": "emb", "coords": [[0.0, 0.0], [1.0, 2.0]],
                "labels": ["cat", "dog"]}).encode()
            assert post(base, "/tsne/upload", payload)["status"] == "ok"
            html = get(base, "/tsne")
        assert "t-SNE — emb" in html and "cat" in html and "<circle" in html

    def test_tsne_rejects_bad_coords(self):
        with served(UIServer()) as base:
            with pytest.raises(urllib.error.HTTPError) as e:
                post(base, "/tsne/upload",
                     json.dumps({"coords": [1, 2, 3]}).encode())
            assert e.value.code == 400

    def test_activations_module(self):
        server = UIServer()
        grid = (np.arange(64).reshape(8, 8) * 3).astype(np.uint8)
        server.post_activation_grid("layer0", grid)
        with served(server) as base:
            html = get(base, "/activations")
            assert "layer0" in html and "data:image/png;base64," in html
            png = get(base, "/activations/img/layer0", raw=True)
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            with pytest.raises(urllib.error.HTTPError) as e:
                get(base, "/activations/img/nope")
            assert e.value.code == 404

    def test_conv_listener_feeds_ui_server(self):
        server = UIServer()
        conf = (NeuralNetConfiguration.builder().seed(0)
                .updater(Adam(1e-2)).list()
                .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        activation="relu"))
                .layer(OutputLayer(n_out=2))
                .set_input_type(InputType.convolutional(8, 8, 1)).build())
        net = MultiLayerNetwork(conf, device="cpu").init().set_listeners(
            ConvolutionalIterationListener(frequency=1, ui_server=server))
        rng = np.random.default_rng(0)
        x = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        net.fit(x, y, epochs=1, batch_size=4)
        assert "layer0" in server._activations

    def test_components_api_json(self):
        server = UIServer()
        self._train_with_stats(server)
        with served(server) as base:
            chart = component_from_json(get(base, "/api/components/s-mod"))
        assert chart.series and chart.series[0][0] == "score"

    def test_tsne_labels_are_escaped(self):
        with served(UIServer()) as base:
            post(base, "/tsne/upload", json.dumps({
                "session": "x", "coords": [[0.0, 0.0]],
                "labels": ["</text><script>alert(1)</script>"]}).encode())
            html = get(base, "/tsne")
        assert "<script>" not in html and "&lt;script&gt;" in html

    def test_tsne_rejects_empty_coords(self):
        with pytest.raises(ValueError):
            UIServer().post_tsne("s", np.zeros((0, 2)))


class TestDashboardDepth:
    def _server_with_data(self):
        server = UIServer()
        for it in (0, 10, 20):
            server.storage.put_report(StatsReport(
                session_id="s1", worker_id="w0", iteration=it, epoch=0,
                timestamp=float(it), score=1.0 / (it + 1),
                examples_per_sec=100.0,
                param_mean_magnitudes={"0_W": 0.5},
                update_mean_magnitudes=({"0_W": 0.005} if it else {})))
        return server

    def test_update_param_ratio_chart_rendered(self):
        with served(self._server_with_data()) as base:
            html = get(base, "/train/model")
        assert "update : param ratio" in html and "0_W" in html

    def test_lang_parameter_localizes_and_propagates(self):
        with served(self._server_with_data()) as base:
            html = get(base, "/train/overview?lang=ja")
            assert "学習の概要" in html
            assert 'href="/train/model?lang=ja"' in html
            assert "更新:参数比" in get(base, "/train/model?lang=zh")

    def test_refresh_parameter_adds_meta_tag(self):
        with served(self._server_with_data()) as base:
            html = get(base, "/train/overview?refresh=5")
            assert '<meta http-equiv="refresh" content="5">' in html
            assert "http-equiv" not in get(base, "/train/overview")
            assert "http-equiv" not in get(base,
                                           "/train/overview?refresh=x")

    def test_unknown_lang_falls_back_to_english(self):
        with served(self._server_with_data()) as base:
            assert "Training Overview" in get(base,
                                              "/train/overview?lang=xx")

    def test_lang_is_whitelisted_not_reflected(self):
        with served(self._server_with_data()) as base:
            html = get(base, "/train/overview?lang=%22%3E%3Cb%3E")
        assert '"><b>' not in html
        assert 'href="/train/model"' in html


# =============================== tests/test_diagnostics_ui.py, on the port
def _diag_net(diagnostics=None, depth=2):
    lb = NeuralNetConfiguration.builder().seed(11).updater(Adam(0.01)).list()
    for _ in range(depth):
        lb = lb.layer(DenseLayer(n_in=8, n_out=8, activation="relu"))
    lb = lb.layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                              loss="mcxent"))
    if diagnostics is not None:
        lb = lb.diagnostics(diagnostics)
    return MultiLayerNetwork(lb.build(), device="cpu").init()


class TestStatsReportWire:
    def test_v2_roundtrip(self):
        r = _report(pstats, "full")
        assert StatsReport.decode(r.encode()) == r

    def test_v1_payload_still_decodes(self):
        r = _report(pstats, "full")
        rt = StatsReport.decode(_encode_v1(r))
        assert rt.param_mean_magnitudes == r.param_mean_magnitudes
        assert rt.update_mean_magnitudes == r.update_mean_magnitudes
        assert rt.param_histograms == r.param_histograms
        assert rt.gradient_mean_magnitudes == {}
        assert rt.activation_stats == {} and rt.watchdog_nonfinite == 0


class TestStatsListener:
    def test_true_update_magnitudes_from_aux(self):
        x, y = _data()
        net = _diag_net(diagnostics=True)
        storage = InMemoryStatsStorage()
        net.set_listeners(StatsListener(storage))
        net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
        r = storage.latest_report("default")
        d = net._last_diagnostics["params"]
        assert r.update_mean_magnitudes["0_W"] == \
            pytest.approx(d["0_W"]["upd_mm"])
        assert r.gradient_mean_magnitudes["1_W"] == \
            pytest.approx(d["1_W"]["grad_mm"])
        assert r.update_ratios["0_W"] == pytest.approx(d["0_W"]["ratio"])
        assert "0" in r.activation_stats

    def test_batched_readback_single_transfer(self):
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            x, y = _data()
            net = _diag_net()          # no diagnostics: host params
            storage = InMemoryStatsStorage()
            net.set_listeners(StatsListener(storage, update_frequency=4))
            before = reg.counter("jax_transfers_total",
                                 direction="d2h").value
            net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
            # on the CPU the params are already host memory: no copy
            # (a card net's one report is ONE copy; phase 25 checks it)
            assert reg.counter("jax_transfers_total",
                               direction="d2h").value - before == 0
            assert len(storage.latest_report(
                "default").param_mean_magnitudes) == 6
        finally:
            monitor.disable()

    def test_one_report_is_one_batched_copy(self, monkeypatch):
        """A report's host params come from ONE `batched_host_tree`
        call over every leaf, whatever the number of leaves."""
        import deeplearning4j_tpu_torch.monitor.diagnostics as D
        calls = []
        real = D.batched_host_tree

        def spy(tree):
            calls.append(sum(len(v) for v in tree.values()))
            return real(tree)
        monkeypatch.setattr(D, "batched_host_tree", spy)
        x, y = _data()
        net = _diag_net(depth=3)
        net.set_listeners(StatsListener(InMemoryStatsStorage(),
                                        update_frequency=4,
                                        collect_histograms=True))
        net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
        assert calls == [8]

    def test_param_delta_fallback_without_seam(self):
        x, y = _data()
        net = _diag_net()
        storage = InMemoryStatsStorage()
        net.set_listeners(StatsListener(storage))
        net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
        reports = storage.get_reports("default")
        assert reports[-1].update_mean_magnitudes
        assert reports[-1].gradient_mean_magnitudes == {}


class TestTrainingHealthUI:
    def test_overview_serves_real_stats(self):
        x, y = _data()
        net = _diag_net(diagnostics=True)
        storage = InMemoryStatsStorage()
        net.set_listeners(StatsListener(storage))
        net.fit(x, y, epochs=1, batch_size=8, shuffle=False)
        with served(UIServer().attach(storage)) as base:
            html = get(base, "/train/overview")
            assert "training health" in html and "mean |grad|" in html
            assert "activation stats" in html
            assert "学習ヘルス" in get(base, "/train/overview?lang=ja")
            assert "训练健康" in get(base, "/train/overview?lang=zh")


# ============== test_monitor.py's RSS and metrics-route cases, on the port
class TestStatsRssNormalization:
    def test_linux_kb_and_darwin_bytes(self, monkeypatch):
        class RU:
            ru_maxrss = 512 * 1024   # 512 MB in KB (Linux)

        monkeypatch.setattr(pstats.resource, "getrusage", lambda _: RU)
        monkeypatch.setattr(pstats.sys, "platform", "linux")
        assert pstats._rss_mb() == pytest.approx(512.0)
        RU.ru_maxrss = 512 * 1024 * 1024   # the same 512 MB in bytes (macOS)
        monkeypatch.setattr(pstats.sys, "platform", "darwin")
        assert pstats._rss_mb() == pytest.approx(512.0)


class TestMetricsRoute:
    def test_metrics_route_serves_exposition(self):
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            x, y = _data()
            _diag_net().fit(x, y, epochs=1, batch_size=8)
            with served(UIServer()) as base:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=30) as resp:
                    body = resp.read().decode()
                    assert resp.headers["Content-Type"].startswith(
                        "text/plain")
            assert "training_iterations_total" in body
        finally:
            monitor.disable()

    def test_metrics_route_with_explicit_registry(self):
        reg = MetricsRegistry()
        reg.counter("custom_total").inc(5)
        with served(UIServer(registry=reg)) as base:
            assert "custom_total 5.0" in get(base, "/metrics")


# ====================== the UI classes of the serving/fleet/online/obs tests
V, BL = 23, 4


def _lm(seed):
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM
    torch.manual_seed(seed)
    return TransformerLM(V, d_model=16, n_layers=1, n_heads=4,
                         max_len=16).init(device="cpu", seed=seed)


class TestServingUI:
    def test_serving_page_renders_registry_state(self):
        from deeplearning4j_tpu_torch.serving import GenerationServer
        reg = monitor.enable(registry=MetricsRegistry())
        srv = GenerationServer(_lm(3), n_slots=2, n_blocks=16,
                               block_len=BL, device="cpu").start()
        try:
            srv.generate_async(np.array([1, 2, 3]), 6).result(timeout=120)
        finally:
            srv.stop()
            monitor.disable()
        with served(UIServer(registry=reg)) as base:
            html = get(base, "/serving")
            for row in ("requests admitted", "free pool blocks",
                        "pool occupancy", "blocks granted"):
                assert row in html
            assert "<td>requests admitted</td><td>1</td>" in html
            assert "<td>tokens emitted</td><td>6</td>" in html
            assert "serving_ttft_seconds" in get(base, "/metrics")


class TestFleetObservability:
    def test_serving_page_per_model_rows_and_metrics(self, tmp_path):
        from deeplearning4j_tpu_torch.serving import (
            FleetRouter,
            FleetServer,
            ModelRegistry,
        )
        mreg = monitor.enable(registry=MetricsRegistry())
        reg = ModelRegistry(tmp_path)
        reg.publish("alpha", _lm(3))
        reg.publish("beta", _lm(9))
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        try:
            with served(UIServer(registry=mreg)) as base:
                fleet.deploy("alpha", n_slots=1, n_blocks=8, block_len=BL)
                fleet.deploy("beta", n_slots=2, n_blocks=8, block_len=BL)
                router.submit("alpha", np.array([1, 2, 3]),
                              4).result(timeout=120)
                fleet.publish_gauges()
                html = get(base, "/serving")
                for frag in ("fleet", "alpha", "beta", "version",
                             "queue depth", "active slots", "shed"):
                    assert frag in html, frag
                mtext = get(base, "/metrics")
                for fam in ("fleet_active_models", "fleet_queue_depth",
                            "fleet_model_version", "fleet_streams_total",
                            "registry_published_total"):
                    assert fam in mtext, fam
                assert 'model="alpha"' in mtext
                fleet.undeploy("beta")
                html = get(base, "/serving")
                assert "alpha" in html and "<td>beta</td>" not in html
        finally:
            fleet.stop()
            monitor.disable()


class TestStreamingUI:
    def test_overview_renders_staleness_row(self):
        from deeplearning4j_tpu_torch.online import StreamingDataSetIterator
        from deeplearning4j_tpu_torch.streaming import (
            LocalLogTransport,
            serialize_ndarray,
        )
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            t = LocalLogTransport()
            rng = np.random.default_rng(16)
            for _ in range(16):
                t.send("ui", serialize_ndarray(
                    rng.standard_normal(9).astype(np.float32)))
            it = StreamingDataSetIterator(
                t, "ui", batch_size=8, watermark_timeout_s=0.4,
                poll_s=0.02, record_to_example=lambda r: (r[:6], r[6:]))
            assert sum(ds.num_examples() for ds in it) == 16
            reg.counter("online_publishes_total", help="", model="m").inc(3)
            reg.gauge("online_publish_paused", help="",
                      tag="heldout").set(0.0)
            with served(UIServer()) as base:
                html = get(base, "/train/overview")
            assert "streaming / online training" in html
            assert "ui" in html and "records consumed" in html
            assert "model m" in html and "gate heldout" in html
            assert "open" in html
        finally:
            monitor.disable()


def _worker_registry(reqs, depth, lat):
    reg = MetricsRegistry()
    reg.counter("serving_requests_total", model="m").inc(reqs)
    reg.gauge("serving_queue_depth").set(depth)
    reg.histogram("ttft_seconds", buckets=(0.1, 1.0)).observe(lat)
    return reg


class TestObservabilityUI:
    def test_metrics_route_serves_aggregator(self):
        agg = MetricsAggregator()
        agg.ingest_registry(_worker_registry(3, 1, 0.2), "w1")
        agg.ingest_registry(_worker_registry(4, 2, 0.3), "w2")
        with served(UIServer(registry=agg)) as base:
            text = get(base, "/metrics")
        assert 'worker="w1"' in text and 'worker="w2"' in text
        assert text.endswith("\n")

    def test_events_route_renders_flight_recorder(self):
        from deeplearning4j_tpu_torch.monitor.flightrec import (
            GLOBAL_FLIGHT_RECORDER,
        )
        GLOBAL_FLIGHT_RECORDER.record("swap", model="ui-probe",
                                      from_version=1, to_version=2)
        with served(UIServer()) as base:
            html = get(base, "/events")
            assert "ui-probe" in html and "swap" in html
            doc = json.loads(get(base, "/events?format=json&kind=swap"))
        assert any(e["model"] == "ui-probe" for e in doc["events"])

    def test_alerts_route_renders_the_engine(self):
        reg = MetricsRegistry()
        reg.gauge("serving_queue_depth").set(5)
        eng = AlertEngine(reg, [AlertRule(
            "queue_deep", "threshold", metric="serving_queue_depth",
            op=">", value=1.0, severity="page", description="deep")],
            registry=MetricsRegistry())
        eng.evaluate()
        with served(UIServer()) as base:
            assert "queue_deep" not in get(base, "/alerts")
            assert json.loads(get(base, "/alerts?format=json")) == {
                "attached": False, "alerts": []}
        with served(UIServer().attach_alerts(eng)) as base:
            html = get(base, "/alerts")
            doc = json.loads(get(base, "/alerts?format=json"))
        assert "queue_deep" in html and "FIRING" in html
        assert doc["attached"] and doc["alerts"][0]["state"] == "firing"
