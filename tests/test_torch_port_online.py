"""The port's online-learning runtime (`deeplearning4j_tpu_torch/online/`)
against the JAX package's (`tests/test_online.py`, every class but
`TestStreamingUI`, which waits on the port of `ui/`): the log transport,
the unbounded iterator's contract, the async prefetch's abandon hook,
the windowed normalizer, the publish listener's online semantics, the
drift gate in both modes, the OnlineTrainer and the resume from the
stream offset, bit-equal. Beside each scenario the JAX package runs the
same records where a number can be compared: the windowed statistics
bit for bit, an online run's params within 1e-5 of JAX's, the drift
gate's trip history equal.

Every wait is on an event or on the iterator's own watermark, never on
a sleep; the wall-clock cadence runs on a scripted clock."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.common.updaters import Sgd
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import AsyncDataSetIterator
from deeplearning4j_tpu_torch.datasets.normalizers import (
    NormalizerStandardize,
    normalizer_from_meta,
)
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.online import (
    DriftGate,
    OnlineTrainer,
    StreamingDataSetIterator,
    WindowedStandardize,
    lm_example,
)
from deeplearning4j_tpu_torch.optimize.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.streaming import (
    LocalLogTransport,
    LocalQueueTransport,
    serialize_ndarray,
)

F, C, B = 6, 3, 8
PARAM_ATOL = 1e-5       # an online run's params, port against JAX (fp32)


def tiny_net(seed=7, lr=0.1):
    b = NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr))
    lb = b.list().layer(DenseLayer(n_in=F, n_out=8, activation="tanh"))
    return MultiLayerNetwork(
        lb.layer(OutputLayer(n_in=8, n_out=C, activation="softmax",
                             loss="mcxent"))
          .set_input_type(InputType.feed_forward(F)).build(),
        device="cpu").init()


def jax_tiny_net(seed=7, lr=0.1):
    from deeplearning4j_tpu.common.updaters import Sgd as JSgd
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.layers import DenseLayer as JD
    from deeplearning4j_tpu.nn.layers import OutputLayer as JO
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
    b = JNNC.builder().seed(seed).updater(JSgd(lr))
    lb = b.list().layer(JD(n_in=F, n_out=8, activation="tanh"))
    return JM(lb.layer(JO(n_in=8, n_out=C, activation="softmax",
                          loss="mcxent"))
              .set_input_type(JIT.feed_forward(F)).build()).init()


_W_TRUE = np.random.default_rng(42).standard_normal((F, C))


def make_records(n, seed, shuffle_labels=False):
    """Record = [features F | one-hot label C] concatenated."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal(F).astype(np.float32)
        cls = (int(rng.integers(0, C)) if shuffle_labels
               else int(np.argmax(x @ _W_TRUE)))
        y = np.zeros(C, np.float32)
        y[cls] = 1.0
        out.append(np.concatenate([x, y]))
    return out


def split_record(r):
    return r[:F], r[F:]


def fill_log(records, topic="train", transport=None):
    t = transport or LocalLogTransport()
    for r in records:
        t.send(topic, serialize_ndarray(r))
    return t


def make_stream(transport, topic="train", batch_size=B, cls=None, **kw):
    kw.setdefault("watermark_timeout_s", 0.4)
    kw.setdefault("poll_s", 0.02)
    return (cls or StreamingDataSetIterator)(
        transport, topic, batch_size=batch_size,
        record_to_example=split_record, **kw)


def table(net):
    return {k: v.detach().cpu().clone() for k, v in net.param_table().items()}


def params_equal(a, b):
    ta, tb = table(a), table(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


def scale_params(net, factor):
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(factor)
    net.params_changed()


def set_params(net, saved):
    net.set_param_table(saved)


class _Clock:
    """A scripted `time.monotonic`: the registry listener reads the clock
    through the `time` module, so a test advances it by hand."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


# ===================================================== LocalLogTransport
class TestLocalLogTransport:
    def test_offset_reads_are_stable(self):
        t = LocalLogTransport()
        for i in range(5):
            t.send("a", bytes([i]))
        assert t.read("a", 2) == bytes([2])
        assert t.read("a", 2) == bytes([2])     # retained, re-readable
        assert t.producer_offset("a") == 5

    def test_read_blocks_until_producer_reaches_offset(self):
        t = LocalLogTransport()
        waiting = threading.Event()
        cond = t._cond
        real_wait = cond.wait

        def wait(timeout=None):
            waiting.set()
            return real_wait(timeout)

        cond.wait = wait

        def late_send():
            waiting.wait(10)           # the reader is blocked in read()
            t.send("a", b"x")

        threading.Thread(target=late_send, daemon=True).start()
        assert t.read("a", 0, timeout=5.0) == b"x"
        assert waiting.is_set()
        with pytest.raises(TimeoutError):
            t.read("a", 7, timeout=0.05)

    def test_receive_is_queue_compatible(self):
        t = LocalLogTransport()
        t.send("a", b"0")
        t.send("a", b"1")
        assert t.receive("a") == b"0"
        assert t.receive("a") == b"1"
        with pytest.raises(TimeoutError):
            t.receive("a", timeout=0.05)
        assert t.read("a", 0) == b"0"

    def test_close_drops_topic(self):
        t = LocalLogTransport()
        t.send("a", b"0")
        t.close("a")
        assert t.producer_offset("a") == 0


# ================================================ StreamingDataSetIterator
class TestStreamingIterator:
    def test_fixed_shape_batches_with_ragged_holdback(self):
        t = fill_log(make_records(2 * B + 3, seed=0))
        it = make_stream(t)
        batches = list(it)
        assert len(batches) == 2
        assert batches[0].features.shape == (B, F)
        assert batches[0].labels.shape == (B, C)
        assert it.cursor()["batch"] == 2
        assert it.cursor()["offset"] == 2 * B

    def test_cursor_counts_before_yield(self):
        t = fill_log(make_records(2 * B, seed=1))
        it = make_stream(t)
        gen = iter(it)
        next(gen)
        assert it.cursor()["batch"] == 1
        gen.close()

    def test_watermark_timeout_ends_pass_then_resumes(self):
        t = fill_log(make_records(B, seed=2))
        it = make_stream(t)
        assert len(list(it)) == 1
        fill_log(make_records(B, seed=3), transport=t)
        assert len(list(it)) == 1
        assert it.cursor()["batch"] == 2

    def test_stop_ends_stream_at_batch_boundary(self):
        t = fill_log(make_records(8 * B, seed=4))
        it = make_stream(t, watermark_timeout_s=5.0)
        got = []
        for ds in it:
            got.append(ds)
            if len(got) == 2:
                it.stop()
        assert len(got) == 2

    def test_seek_replays_identical_batches(self):
        t = fill_log(make_records(4 * B, seed=5))
        ref = list(make_stream(t))
        it = make_stream(t)
        it.seek({"batch": 2, "batch_size": B})
        replay = list(it)
        assert len(replay) == 2
        for a, b_ in zip(ref[2:], replay):
            np.testing.assert_array_equal(a.features, b_.features)
            np.testing.assert_array_equal(a.labels, b_.labels)

    def test_seek_batch_size_mismatch_raises(self):
        it = make_stream(LocalLogTransport())
        with pytest.raises(ValueError, match="batch_size"):
            it.seek({"batch": 1, "batch_size": B + 1})

    def test_seek_over_destructive_queue_skips_replayed_prefix(self):
        records = make_records(3 * B, seed=6)
        t = LocalQueueTransport()
        ref = list(make_stream(fill_log(records)))
        for r in records:
            t.send("train", serialize_ndarray(r))
        it = make_stream(t)
        it.seek({"batch": 1, "batch_size": B})
        replay = list(it)
        assert len(replay) == 2
        np.testing.assert_array_equal(replay[0].features, ref[1].features)

    def test_shape_change_mid_stream_is_loud(self):
        t = LocalLogTransport()
        t.send("train", serialize_ndarray(np.zeros(F + C, np.float32)))
        t.send("train", serialize_ndarray(np.zeros(F + C + 1, np.float32)))
        it = make_stream(t)
        with pytest.raises(ValueError, match="fixed-shape"):
            list(it)

    def test_metrics_families(self):
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            t = fill_log(make_records(2 * B, seed=7), topic="m1")
            it = make_stream(t, topic="m1")
            list(it)
            snap = reg.snapshot()
            rec = snap["streaming_records_consumed_total"]["values"]
            assert any(e["labels"].get("topic") == "m1"
                       and e["value"] == 2 * B for e in rec)
            lag = snap["streaming_lag_records"]["values"]
            assert any(e["labels"].get("topic") == "m1"
                       and e["value"] == 0 for e in lag)
            age = snap["streaming_watermark_age_seconds"]["values"]
            assert any(e["labels"].get("topic") == "m1"
                       and e["value"] >= 0 for e in age)
        finally:
            monitor.disable()

    def test_lm_example_matches_jax(self):
        from deeplearning4j_tpu.online import lm_example as jax_lm_example
        rec = np.stack([np.arange(10) % 7, (np.arange(10) + 1) % 7])
        x, y = lm_example(rec, vocab_size=7)
        jx, jy = jax_lm_example(rec, vocab_size=7)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
        assert x.dtype == np.float32 and y.shape == (10, 7)


# ============================================= async over unbounded source
class _Counting(StreamingDataSetIterator):
    """Sets `reached` once the worker has built `n` batches."""

    def __init__(self, *a, n=3, **kw):
        super().__init__(*a, **kw)
        self.reached = threading.Event()
        self._n = n

    def _build_batch(self):
        ds = super()._build_batch()
        if self._consumed_batches + 1 >= self._n:
            self.reached.set()
        return ds


class TestAsyncOverUnbounded:
    def test_abandon_does_not_strand_prefetch_thread(self):
        t = fill_log(make_records(3 * B, seed=8))
        base = make_stream(t, watermark_timeout_s=60.0)   # would hang
        ait = AsyncDataSetIterator(base, prefetch=2)
        before = threading.active_count()
        t0 = time.monotonic()
        gen = iter(ait)
        next(gen)
        next(gen)
        gen.close()           # early abandon: the teardown joins the worker
        assert time.monotonic() - t0 < 5.0
        assert threading.active_count() <= before

    def test_cursor_counts_consumed_not_prefetched(self):
        t = fill_log(make_records(5 * B, seed=9))
        base = make_stream(t, watermark_timeout_s=60.0, cls=_Counting)
        ait = AsyncDataSetIterator(base, prefetch=4)
        gen = iter(ait)
        for _ in range(2):
            next(gen)
        assert base.reached.wait(5.0)      # the worker ran ahead
        assert base.cursor()["batch"] > 2
        assert ait.cursor()["batch"] == 2
        gen.close()

    def test_seek_through_async_wrapper(self):
        t = fill_log(make_records(4 * B, seed=10))
        ref = list(make_stream(t))
        base = make_stream(t)
        ait = AsyncDataSetIterator(base, prefetch=2)
        ait.seek({"batch": 3, "batch_size": B})
        got = list(ait)
        assert len(got) == 1
        np.testing.assert_array_equal(got[0].features, ref[3].features)
        assert ait.cursor()["batch"] == 4


# ==================================================== WindowedStandardize
class TestWindowedStandardize:
    def test_window_matches_direct_stats_over_last_batches(self):
        rng = np.random.default_rng(0)
        w = WindowedStandardize(window=3)
        batches = [rng.standard_normal((B, F)) + i for i in range(6)]
        for x in batches:
            w.observe(x)
        tail = np.concatenate(batches[-3:])
        np.testing.assert_allclose(w.mean, tail.mean(axis=0), rtol=1e-10)
        np.testing.assert_allclose(w.std, tail.std(axis=0), rtol=1e-6)

    def test_window_bit_equal_to_jax(self):
        from deeplearning4j_tpu.online import WindowedStandardize as JW
        rng = np.random.default_rng(5)
        w, jw = WindowedStandardize(window=3), JW(window=3)
        for i in range(7):
            x = rng.standard_normal((4, 5, F)) * (i + 1)
            mask = (rng.random((4, 5)) > 0.3).astype(np.float32)
            w.observe(x, mask)
            jw.observe(x, mask)
        np.testing.assert_array_equal(w.mean, jw.mean)
        np.testing.assert_array_equal(w.std, jw.std)
        x = rng.standard_normal((2, F)).astype(np.float32)
        np.testing.assert_array_equal(w.transform(x), jw.transform(x))
        meta, arrays = w.state()
        jmeta, jarrays = jw.state()
        assert meta == jmeta
        for k in arrays:
            np.testing.assert_array_equal(arrays[k], jarrays[k])

    def test_transform_before_data_is_loud(self):
        with pytest.raises(ValueError, match="no data"):
            WindowedStandardize().transform(np.zeros((2, F)))

    def test_snapshot_is_frozen_and_versioned(self):
        rng = np.random.default_rng(1)
        w = WindowedStandardize(window=2)
        w.observe(rng.standard_normal((B, F)))
        s1 = w.snapshot()
        mean1 = np.array(s1.mean)
        w.observe(rng.standard_normal((B, F)) + 10.0)
        s2 = w.snapshot()
        np.testing.assert_array_equal(s1.mean, mean1)
        assert (s1.version, s2.version) == (1, 2)
        assert s2.records_seen == 2 * B
        assert not np.allclose(s1.mean, s2.mean)

    def test_live_window_state_round_trip(self):
        rng = np.random.default_rng(2)
        w = WindowedStandardize(window=4)
        for i in range(6):
            w.observe(rng.standard_normal((B, F)) * (i + 1))
        w.snapshot()
        meta, arrays = w.state()
        w2 = normalizer_from_meta(meta, arrays)
        np.testing.assert_array_equal(w2.mean, w.mean)
        np.testing.assert_array_equal(w2.std, w.std)
        assert w2.snapshot_version == w.snapshot_version
        assert w2.records_seen == w.records_seen
        x = rng.standard_normal((B, F))
        w.observe(x)
        w2.observe(x)
        np.testing.assert_array_equal(w2.mean, w.mean)

    def test_snapshot_rides_the_published_zip(self, tmp_path):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        rng = np.random.default_rng(3)
        w = WindowedStandardize(window=2)
        w.observe(rng.standard_normal((B, F)))
        reg = ModelRegistry(tmp_path)
        v = reg.publish("m", tiny_net(), normalizer=w.snapshot())
        restored = ModelSerializer.restore_normalizer_from_file(
            reg.path("m", v))
        np.testing.assert_array_equal(restored.mean, w.mean)
        assert restored.version == 1
        assert restored.records_seen == B
        assert isinstance(restored, NormalizerStandardize)
        # the JAX package reads the snapshot out of the port's zip
        from deeplearning4j_tpu.util.serializer import (
            ModelSerializer as JaxSerializer)
        jrestored = JaxSerializer.restore_normalizer_from_file(
            str(reg.path("m", v)))
        np.testing.assert_array_equal(jrestored.mean, w.mean)
        assert jrestored.version == 1

    def test_fit_protocol_and_masks(self):
        rng = np.random.default_rng(4)
        x = rng.standard_normal((4, 5, F))
        mask = np.zeros((4, 5), np.float32)
        mask[:, :3] = 1.0
        w = WindowedStandardize(window=8)
        w.fit(DataSet(x, None, mask))
        ref = NormalizerStandardize().fit(DataSet(x, None, mask))
        np.testing.assert_allclose(w.mean, ref.mean, rtol=1e-12)
        np.testing.assert_allclose(w.std, ref.std, rtol=1e-12)


# ===================================== publish listener online semantics
class TestPublishListenerOnline:
    def test_final_publish_at_off_cadence_fit_end(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=100)
        net.add_listener(listener)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((7 * 4, F)).astype(np.float32)
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, 7 * 4)]
        net.fit(x, y, epochs=1, batch_size=4)
        assert listener.published_versions == [1]
        assert listener.published_steps == [7]
        restored, _ = reg.resolve("m", device="cpu")
        assert params_equal(restored, net)

    def test_gate_pauses_without_advancing_cadence(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        allow = {"ok": True}
        listener = reg.publish_listener("m", frequency=3,
                                        gate=lambda: allow["ok"])
        allow["ok"] = False
        net.iteration_count = 3
        listener.iteration_done(net, 2, 0, 0.0)
        assert listener.published_versions == []
        assert listener.gated_skips == 1
        allow["ok"] = True
        net.iteration_count = 4
        listener.iteration_done(net, 3, 0, 0.0)
        assert listener.published_versions == [1]
        assert listener.published_steps == [4]

    def test_gated_skips_count_windows_not_iterations(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=5,
                                        gate=lambda: False)
        for it in range(4, 14):
            net.iteration_count = it + 1
            listener.iteration_done(net, it, 0, 0.0)
        assert listener.gated_skips == 2

    def test_gate_applies_to_fit_end(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=100,
                                        gate=lambda: False)
        net.iteration_count = 9
        listener.on_fit_end(net)
        assert listener.published_versions == []
        assert listener.gated_skips == 1

    def test_cadence_anchors_at_warm_start(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        net.iteration_count = 200
        listener = reg.publish_listener("m", frequency=10)
        listener.on_fit_start(net)
        listener.iteration_done(net, 200, 0, 0.0)
        assert listener.published_versions == []
        listener.iteration_done(net, 209, 0, 0.0)
        assert listener.published_versions == [1]


# ================================================= drift gate integration
def _trained_net(seed):
    rng = np.random.default_rng(seed)
    hx = rng.standard_normal((48, F)).astype(np.float32)
    hy = np.eye(C, dtype=np.float32)[np.argmax(hx @ _W_TRUE, axis=1)]
    x = rng.standard_normal((40 * B, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[np.argmax(x @ _W_TRUE, axis=1)]
    net = tiny_net()
    net.fit(x, y, epochs=2, batch_size=B, shuffle=False)
    return net, DataSet(hx, hy), (x, y)


class TestDriftGate:
    def test_trip_and_recovery_through_real_evaluation(self):
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            net, heldout, _ = _trained_net(0)
            gate = DriftGate(heldout, frequency=1, band=0.2,
                             printer=lambda s: None)
            gate.iteration_done(net, 0, 0, 0.0)
            assert gate.best_score is not None and not gate.paused
            good = table(net)
            scale_params(net, 0.0)
            gate.iteration_done(net, 1, 0, 0.0)
            assert gate.paused and gate.trips == 1
            assert not gate.allow_publish()
            set_params(net, good)
            gate.iteration_done(net, 2, 0, 0.0)
            assert not gate.paused and gate.allow_publish()
            assert gate.trips == 1
            snap = reg.snapshot()
            paused = snap["online_publish_paused"]["values"]
            assert any(e["value"] == 0.0 for e in paused)
            trips = snap["online_drift_trips_total"]["values"]
            assert any(e["value"] == 1 for e in trips)
            assert "evaluative_score" in snap
        finally:
            monitor.disable()

    def test_history_equals_jax_gate(self):
        """The same scripted degradation through both packages' gates on
        twin nets: the (iteration, paused) history and the trips equal,
        the scores within 1e-5."""
        from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
        from deeplearning4j_tpu.online import DriftGate as JGate
        from deeplearning4j_tpu_torch.util.jax_params import (
            from_jax_params, to_numpy_params)
        import jax
        jnet = jax_tiny_net()
        net = from_jax_params(tiny_net(), to_numpy_params(jnet.params))
        rng = np.random.default_rng(3)
        hx = rng.standard_normal((48, F)).astype(np.float32)
        hy = np.eye(C, dtype=np.float32)[np.argmax(hx @ _W_TRUE, axis=1)]
        for metric, band in (("accuracy", 0.2), ("loss", 0.3)):
            g = DriftGate(DataSet(hx, hy), frequency=1, band=band,
                          metric=metric, printer=lambda s: None)
            jg = JGate(JDS(hx, hy), frequency=1, band=band, metric=metric,
                       printer=lambda s: None)
            good, jgood = table(net), jnet.params
            for it, factor in enumerate((1.0, 0.0, 1.0, 9.0, 1.0)):
                set_params(net, good)
                scale_params(net, factor)
                jnet.params = jax.tree_util.tree_map(
                    lambda a, f=factor: a * f, jgood)
                g.iteration_done(net, it, 0, 0.0)
                jg.iteration_done(jnet, it, 0, 0.0)
            jnet.params = jgood
            set_params(net, good)
            assert [(i, p) for i, _, p in g.history] == \
                [(i, p) for i, _, p in jg.history]
            assert g.trips == jg.trips
            np.testing.assert_allclose([s for _, s, _ in g.history],
                                       [s for _, s, _ in jg.history],
                                       rtol=1e-5, atol=1e-6)


class TestDriftGateLossBand:
    def _heldout(self, seed=0, n=48):
        rng = np.random.default_rng(seed)
        hx = rng.standard_normal((n, F)).astype(np.float32)
        hy = np.eye(C, dtype=np.float32)[np.argmax(hx @ _W_TRUE, axis=1)]
        return DataSet(hx, hy)

    def test_trip_on_loss_rise_and_recovery(self):
        reg = MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            heldout = self._heldout()
            net, _, _ = _trained_net(1)
            gate = DriftGate(heldout, frequency=1, band=0.3, metric="loss",
                             printer=lambda s: None)
            gate.iteration_done(net, 0, 0, 0.0)
            assert gate.best_score is not None and not gate.paused
            base_loss = gate.best_score
            good = table(net)
            scale_params(net, 17.0)
            gate.iteration_done(net, 1, 0, 0.0)
            assert gate.paused and gate.trips == 1
            assert gate.last_score > base_loss + 0.3
            assert not gate.allow_publish()
            assert gate.best_score == base_loss
            set_params(net, good)
            gate.iteration_done(net, 2, 0, 0.0)
            assert not gate.paused and gate.allow_publish()
            snap = reg.snapshot()
            scores = snap["evaluative_score"]["values"]
            assert any(e["labels"].get("metric") == "loss" for e in scores)
        finally:
            monitor.disable()

    def test_loss_gate_drives_publish_listener(self, tmp_path):
        registry = ModelRegistry(tmp_path)
        heldout = self._heldout()
        net = tiny_net()
        gate = DriftGate(heldout, frequency=1, band=0.5, metric="loss",
                         printer=lambda s: None)
        listener = registry.publish_listener("m", frequency=2,
                                             gate=gate.allow_publish)
        gate.iteration_done(net, 0, 0, 0.0)
        net.iteration_count = 2
        listener.iteration_done(net, 1, 0, 0.0)
        assert listener.published_versions == [1]
        scale_params(net, 29.0)
        gate.iteration_done(net, 2, 0, 0.0)
        assert gate.paused
        net.iteration_count = 4
        listener.iteration_done(net, 3, 0, 0.0)
        assert listener.published_versions == [1]
        assert listener.gated_skips == 1

    def test_unknown_metric_rejected(self):
        with pytest.raises(ValueError, match="metric"):
            DriftGate(self._heldout(), metric="auc")


# ========================================================= OnlineTrainer
class TestOnlineTrainer:
    def test_stream_run_publishes_and_checkpoints(self, tmp_path):
        from deeplearning4j_tpu_torch.fault.checkpointer import (
            list_checkpoints)
        t = fill_log(make_records(30 * B, seed=11))
        it = make_stream(t)
        reg = ModelRegistry(tmp_path / "reg", keep_last=50)
        trainer = OnlineTrainer(
            tiny_net(), it, registry=reg, model_name="m",
            publish_frequency=10,
            checkpoint_dir=tmp_path / "ckpt", checkpoint_frequency=8)
        s = trainer.run(max_steps=24)
        assert s["iterations"] == 24
        assert s["published_steps"] == [10, 20, 24]
        assert reg.versions("m") == [1, 2, 3]
        steps = list_checkpoints(tmp_path / "ckpt")
        assert 8 in steps and 16 in steps and 24 in steps
        assert s["cursor"]["batch"] == 24

    def test_listeners_detach_after_run(self, tmp_path):
        t = fill_log(make_records(4 * B, seed=12))
        it = make_stream(t)
        net = tiny_net()
        n_before = len(net.listeners)
        OnlineTrainer(net, it, registry=ModelRegistry(tmp_path),
                      model_name="m", publish_frequency=100).run(
                          max_steps=2)
        assert len(net.listeners) == n_before

    def test_run_twice_over_the_same_iterator(self, tmp_path):
        t = fill_log(make_records(10 * B, seed=17))
        it = make_stream(t)
        trainer = OnlineTrainer(tiny_net(), it)
        assert trainer.run(max_steps=3)["iterations"] == 3
        s = trainer.run(max_steps=4)
        assert s["iterations"] == 4
        assert it.cursor()["batch"] == 7

    def test_windowed_normalizer_wires_into_stream(self, tmp_path):
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        t = fill_log(make_records(6 * B, seed=13))
        w = WindowedStandardize(window=4)
        it = make_stream(t, normalizer=None)
        reg = ModelRegistry(tmp_path)
        trainer = OnlineTrainer(tiny_net(), it, registry=reg,
                                model_name="m", publish_frequency=3,
                                normalizer=w)
        assert it.normalizer is w
        s = trainer.run(max_steps=6)
        assert w.records_seen == 6 * B
        versions = s["published_versions"]
        assert len(versions) >= 2
        snaps = [ModelSerializer.restore_normalizer_from_file(
            reg.path("m", v)) for v in versions]
        assert [s_.version for s_ in snaps] == \
            list(range(1, len(versions) + 1))
        assert snaps[-1].records_seen > snaps[0].records_seen

    def test_online_run_matches_jax(self):
        """The same records through both packages' OnlineTrainer (a
        windowed normalizer in the loop) from one init: the scores and
        params within PARAM_ATOL."""
        from deeplearning4j_tpu.online import OnlineTrainer as JOT
        from deeplearning4j_tpu.online import (
            StreamingDataSetIterator as JSDI)
        from deeplearning4j_tpu.online import WindowedStandardize as JW
        from deeplearning4j_tpu.optimize.listeners import (
            CollectScoresListener as JCollect)
        from deeplearning4j_tpu.streaming import LocalLogTransport as JLog
        from deeplearning4j_tpu.streaming import serialize_ndarray as jser
        from deeplearning4j_tpu_torch.util.jax_params import (
            from_jax_params, to_numpy_params)
        records = make_records(12 * B, seed=21)
        jnet = jax_tiny_net()
        net = from_jax_params(tiny_net(), to_numpy_params(jnet.params))
        jt = JLog()
        for r in records:
            jt.send("train", jser(r))
        jit_ = JSDI(jt, "train", batch_size=B,
                    record_to_example=split_record,
                    watermark_timeout_s=0.4, poll_s=0.02)
        js, ps = JCollect(), CollectScoresListener()
        jnet.add_listener(js)
        net.add_listener(ps)
        JOT(jnet, jit_, normalizer=JW(window=3)).run(max_steps=12)
        OnlineTrainer(net, make_stream(fill_log(records)),
                      normalizer=WindowedStandardize(window=3)).run(
                          max_steps=12)
        np.testing.assert_allclose([s for _, s in ps.scores],
                                   [s for _, s in js.scores], rtol=1e-5)
        want = to_numpy_params(jnet.params)
        for k, v in table(net).items():
            lk, pk = k.split("_", 1)
            np.testing.assert_allclose(v.numpy(), want[lk][pk],
                                       atol=PARAM_ATOL)


# ===================================== resume-from-offset bit-parity
class TestResumeFromOffsetParity:
    def test_interrupted_run_resumes_bit_equal(self, tmp_path):
        records = make_records(24 * B, seed=14)
        total = 24
        tA = fill_log(records)
        scoresA = CollectScoresListener()
        netA = tiny_net()
        netA.add_listener(scoresA)
        OnlineTrainer(netA, make_stream(tA)).run(max_steps=total)

        tB = fill_log(records)
        netB = tiny_net()
        OnlineTrainer(netB, make_stream(tB), checkpoint_dir=tmp_path,
                      checkpoint_frequency=12,
                      checkpoint_at_fit_end=False).run(max_steps=16)
        del netB

        tC = fill_log(records)
        itC = make_stream(tC)
        trC = OnlineTrainer.resume(tmp_path, itC, device="cpu")
        assert trC.net.iteration_count == 12
        assert itC.cursor() == {"kind": "stream", "topic": "train",
                                "batch": 12, "batch_size": B,
                                "offset": 12 * B}
        scoresC = CollectScoresListener()
        trC.net.add_listener(scoresC)
        trC.run(max_steps=total - 12)
        assert trC.net.iteration_count == total
        assert params_equal(netA, trC.net)
        refA = {it: s for it, s in scoresA.scores}
        for it, s in scoresC.scores:
            assert s == refA[it], (it, s, refA[it])

    def test_resume_restores_live_normalizer_window(self, tmp_path):
        records = make_records(16 * B, seed=15)
        tA = fill_log(records)
        wA = WindowedStandardize(window=3)
        netA = tiny_net()
        OnlineTrainer(netA, make_stream(tA), normalizer=wA).run(max_steps=12)

        tB = fill_log(records)
        wB = WindowedStandardize(window=3)
        OnlineTrainer(tiny_net(), make_stream(tB), normalizer=wB,
                      checkpoint_dir=tmp_path, checkpoint_frequency=6,
                      checkpoint_at_fit_end=False).run(max_steps=9)
        tC = fill_log(records)
        itC = make_stream(tC)
        trC = OnlineTrainer.resume(tmp_path, itC, device="cpu")
        assert isinstance(trC.normalizer, WindowedStandardize)
        assert itC.normalizer is trC.normalizer
        trC.run(max_steps=6)
        np.testing.assert_array_equal(trC.normalizer.mean, wA.mean)
        np.testing.assert_array_equal(trC.normalizer.std, wA.std)
        assert params_equal(netA, trC.net)


# ====================================== publish listener: wall-clock cadence
class TestPublishListenerEveryS:
    def test_clock_publishes_regardless_of_step_cadence(self, tmp_path,
                                                        clock):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=10_000, every_s=0.4)
        listener.on_fit_start(net)
        net.iteration_count = 1
        clock.now += 0.1
        listener.iteration_done(net, 0, 0, 0.0)
        assert listener.published_versions == []
        clock.now += 0.45
        net.iteration_count = 2
        listener.iteration_done(net, 1, 0, 0.0)
        assert listener.published_versions == [1]
        net.iteration_count = 3
        listener.iteration_done(net, 2, 0, 0.0)
        assert listener.published_versions == [1]
        clock.now += 0.45
        net.iteration_count = 4
        listener.iteration_done(net, 3, 0, 0.0)
        assert listener.published_versions == [1, 2]

    def test_step_cadence_still_applies_alongside(self, tmp_path, clock):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=2, every_s=3600.0)
        listener.on_fit_start(net)
        net.iteration_count = 2
        listener.iteration_done(net, 1, 0, 0.0)
        assert listener.published_versions == [1]

    def test_gate_refusal_freezes_the_clock(self, tmp_path, clock):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        allow = {"ok": False}
        listener = reg.publish_listener("m", frequency=10_000, every_s=0.2,
                                        gate=lambda: allow["ok"])
        listener.on_fit_start(net)
        clock.now += 0.25
        net.iteration_count = 1
        listener.iteration_done(net, 0, 0, 0.0)
        assert listener.published_versions == []
        allow["ok"] = True
        net.iteration_count = 2
        listener.iteration_done(net, 1, 0, 0.0)
        assert listener.published_versions == [1]

    def test_off_cadence_fit_end_publish_preserved(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        net = tiny_net()
        listener = reg.publish_listener("m", frequency=10_000,
                                        every_s=3600.0)
        net.add_listener(listener)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((7 * 4, F)).astype(np.float32)
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, 7 * 4)]
        net.fit(x, y, epochs=1, batch_size=4)
        assert listener.published_versions == [1]
        assert listener.published_steps == [7]

    def test_invalid_every_s_rejected(self, tmp_path):
        reg = ModelRegistry(tmp_path)
        with pytest.raises(ValueError, match="every_s"):
            reg.publish_listener("m", every_s=0)
