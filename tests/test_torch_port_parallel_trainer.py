"""The port's `ParallelTrainer` (`deeplearning4j_tpu_torch/parallel/
trainer.py`) against the JAX package's on a 4-way CPU mesh (the
conftest's virtual devices on the JAX side, ``["cpu"] * 4`` on the
port's): every mode (dense single-barrier and bucketed, threshold
bucketed and single-barrier, dense_rs, threshold_rs, averaging) on a
net with BatchNorm and dropout, where each mode has its own key and
batch-statistics semantics; dense against single-device training
within JAX's own 2e-5; threshold in JAX's band of dense with the
near-ties of its mask counted; dense_rs bit-equal to the port's dense;
averaging replicas bit-equal after each round and apart before it;
fused groups with a ragged tail; a single-input graph and the multi-io
fallback; the guards, the ragged-batch rule, evaluation, the sharded
prefetch iterator and the exchange counters."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_make_mesh
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.datasets.parallel import DevicePrefetchIterator
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelTrainer,
    make_mesh,
)
from deeplearning4j_tpu_torch.parallel.placement import DataSharding

N = 4
JAX_PARITY_ATOL = 2e-5     # JAX's own sync-vs-single-device tolerance
PORT_JAX_ATOL = 1e-5       # port against JAX, fp32, Sgd
MODES = [dict(gradient_sharing="dense", bucketed=False),
         dict(gradient_sharing="dense"),
         dict(gradient_sharing="dense_rs"),
         dict(mode="averaging", averaging_frequency=3)]
THRESHOLD_MODES = [dict(gradient_sharing="threshold"),
                   dict(gradient_sharing="threshold", bucketed=False),
                   dict(gradient_sharing="threshold_rs")]


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for v in ("DL4J_GRADIENT_SHARING", "DL4J_BUCKETED_EXCHANGE",
              "DL4J_DTYPE_POLICY", "DL4J_SCAN_LAYERS"):
        monkeypatch.delenv(v, raising=False)


def jmesh():
    return jax_make_mesh(JaxMeshSpec.of(data=N))


def pmesh(n=N):
    return make_mesh(MeshSpec.of(data=n), devices=["cpu"] * n)


def bn_dropout_conf(updater=None, width=16):
    """Dense(dropout) -> BatchNorm -> Dense -> Output: each mode's key
    and batch-statistics semantics show."""
    return (JaxBuilder.builder().seed(7).updater(updater or JaxSgd(0.05))
            .list()
            .layer(JaxDense(n_in=16, n_out=width, activation="tanh",
                            dropout=0.8))
            .layer(JaxBN(n_out=width))
            .layer(JaxDense(n_in=width, n_out=width, activation="tanh"))
            .layer(JaxOutput(n_in=width, n_out=4, activation="softmax",
                             loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(16)).build())


def mlp_conf(updater=None, depth=4, width=16, seed=7):
    b = JaxBuilder.builder().seed(seed).updater(updater or JaxSgd(0.05)).list()
    b = b.layer(JaxDense(n_in=16, n_out=width, activation="tanh"))
    for _ in range(depth - 1):
        b = b.layer(JaxDense(n_in=width, n_out=width, activation="tanh"))
    return (b.layer(JaxOutput(n_in=width, n_out=4, activation="softmax",
                              loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(16)).build())


def port_net(jconf, **kw):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", **kw).init()


def data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4))
    y = np.eye(4, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def max_param_diff(jn, pn):
    jp, pp = jn.param_table(), pn.param_table()
    assert set(jp) == set(pp)
    return max(float(np.abs(np.asarray(jp[k]) - pp[k].numpy()).max())
               for k in jp)


def max_state_diff(jn, pn):
    js, ps = jn.net_state, pn.net_state
    return max([float(np.abs(np.asarray(js[k][n]) - ps[k][n].numpy()).max())
                for k in js for n in js[k]] or [0.0])


def run_pair(jconf, kw, epochs=2, batch=16, spe=1, n=128):
    x, y = data(n)
    jn = JaxNet(jconf).init()
    jt = JaxTrainer(jn, jmesh(), **kw)
    jt.fit(JaxArrayIterator(x, y, batch_size=batch, shuffle=False),
           epochs=epochs, steps_per_execution=spe)
    pn = port_net(jconf)
    t = ParallelTrainer(pn, pmesh(), **kw)
    t.fit(ArrayDataSetIterator(x, y, batch_size=batch, shuffle=False),
          epochs=epochs, steps_per_execution=spe)
    run_pair.jax_trainer = jt
    return jn, pn, t


class TestModesAgainstJax:
    @pytest.mark.parametrize("kw", MODES, ids=lambda k: "-".join(
        f"{a}={b}" for a, b in k.items()))
    def test_bn_dropout_net(self, kw):
        """Dropout under the mode's key (global for the single barrier,
        folded by replica otherwise) and BatchNorm on the global batch
        or each shard, then the replica mean of the running state."""
        jn, pn, _ = run_pair(bn_dropout_conf(), kw)
        assert pn.iteration_count == jn.iteration_count == 16
        assert max_param_diff(jn, pn) <= PORT_JAX_ATOL
        assert max_state_diff(jn, pn) <= PORT_JAX_ATOL
        assert pn.score_value == pytest.approx(jn.score_value, rel=1e-5)

    @pytest.mark.parametrize("kw", THRESHOLD_MODES, ids=lambda k: "-".join(
        f"{a}={b}" for a, b in k.items()))
    def test_threshold_modes_bn_dropout_net(self, kw):
        """The threshold modes on the same net: τ trees equal to JAX's
        and params equal except where an element of the mask sat at a
        near-tie (each such flip moves one element by τ/N)."""
        jconf = bn_dropout_conf()
        jn, pn, t = run_pair(jconf, kw)
        jt = run_pair.jax_trainer
        if isinstance(jt._thr_tau, dict):
            assert set(t._thr_tau) == set(jt._thr_tau)
            for k, v in jt._thr_tau.items():
                assert float(t._thr_tau[k]) == pytest.approx(
                    float(np.asarray(v)), rel=1e-6), k
        else:
            assert float(t._thr_tau) == pytest.approx(
                float(np.asarray(jt._thr_tau)), rel=1e-6)
        res, jres = t.threshold_residual(), jt.threshold_residual()
        for k in jres:
            for n in jres[k]:
                assert res[k][n].shape == np.shape(jres[k][n])
        diffs = []
        jp, pp = jn.param_table(), pn.param_table()
        for k in jp:
            diffs.append(np.abs(np.asarray(jp[k]) - pp[k].numpy()).ravel())
        d = np.concatenate(diffs)
        flips = int((d > PORT_JAX_ATOL).sum())
        assert flips <= max(1, d.size // 200), (flips, d.size, d.max())
        assert max_state_diff(jn, pn) <= 1e-4
        assert isinstance(t._thr_tau, dict) or not t.bucketed

    def test_dense_against_single_device_sgd(self):
        """JAX's own contract (`test_parallel.py:51-69`): sync training
        equals single-device training within 2e-5, both exchange
        programs."""
        x, y = data(96)
        single = port_net(mlp_conf(depth=2))
        single.fit(ArrayDataSetIterator(x, y, batch_size=48, shuffle=False),
                   epochs=3)
        for bucketed in (False, True):
            net = port_net(mlp_conf(depth=2))
            ParallelTrainer(net, pmesh(), bucketed=bucketed).fit(
                ArrayDataSetIterator(x, y, batch_size=48, shuffle=False),
                epochs=3)
            for k, v in single.param_table().items():
                np.testing.assert_allclose(
                    v.numpy(), net.param_table()[k].numpy(),
                    atol=JAX_PARITY_ATOL, err_msg=f"{k} bucketed={bucketed}")

    def test_dense_adam_against_jax_by_step_bound(self):
        """Adam amplifies rounding on near-zero gradients: held by its
        step bound (steps · lr) where not within fp32 noise."""
        jconf = mlp_conf(updater=JaxAdam(0.01), depth=4)
        jn, pn, _ = run_pair(jconf, dict(gradient_sharing="dense"))
        assert max_param_diff(jn, pn) <= 16 * 0.01 * 1e-2

    def test_threshold_tracks_dense_in_jax_band(self):
        """JAX's convergence band (`test_gradient_sharing.py:168-205`):
        threshold learns and stays within 0.35 x the initial score of
        dense, on both packages."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        jconf = mlp_conf(updater=JaxAdam(0.01), depth=6)
        x, y = data(320)
        ds = DataSet(x, y)
        init = port_net(jconf).score(ds)
        scores = {}
        for mode in ("dense", "threshold"):
            net = port_net(jconf)
            ParallelTrainer(net, pmesh(), gradient_sharing=mode).fit(
                x, y, epochs=5, batch_size=32)
            scores[mode] = net.score(ds)
        jn = JaxNet(jconf).init()
        JaxTrainer(jn, jmesh(), gradient_sharing="threshold").fit(
            x, y, epochs=5, batch_size=32)
        from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDS
        jscore = float(jn.score(JaxDS(x, y)))
        assert scores["dense"] < 0.5 * init
        assert scores["threshold"] < 0.5 * init
        assert abs(scores["threshold"] - scores["dense"]) <= 0.35 * init
        assert abs(scores["threshold"] - jscore) <= 0.35 * init

    def test_fused_groups_with_ragged_tail(self):
        """spe 3 over 4 batches a epoch: a group of 3, then the tail per
        step; equal to per-step within the port and to JAX's."""
        jconf = bn_dropout_conf()
        jn, pn, _ = run_pair(jconf, dict(gradient_sharing="threshold"),
                             batch=32, spe=3)
        assert pn.iteration_count == jn.iteration_count == 8
        per_step = port_net(jconf)
        x, y = data()
        ParallelTrainer(per_step, pmesh(), gradient_sharing="threshold").fit(
            ArrayDataSetIterator(x, y, batch_size=32, shuffle=False),
            epochs=2)
        for k, v in per_step.param_table().items():
            assert torch.equal(v, pn.param_table()[k]), k
        assert max_param_diff(jn, pn) <= 1e-4


class TestDenseRs:
    def test_dense_rs_bit_equal_to_port_dense(self):
        """dense_rs (sharded Adam state, shards updated apart, gathered)
        against bucketed dense: params and updater state bit for bit,
        with leaves that really shard."""
        jconf = mlp_conf(updater=JaxAdam(0.01), depth=3, width=64)
        x, y = data(128, seed=7)

        def run(mode):
            net = port_net(jconf)
            t = ParallelTrainer(net, pmesh(), gradient_sharing=mode)
            t.fit(x, y, epochs=3, batch_size=32)
            return net, t

        dense, _ = run("dense")
        rs, t = run("dense_rs")
        plan = t._rs_plan()
        assert any(v for lp in plan.values() for v in lp.values())
        for k, v in dense.param_table().items():
            assert torch.equal(v, rs.param_table()[k]), k
        for lk, lst in dense.updater_state.items():
            for pk, st in lst.items():
                for sk, v in st.items():
                    assert torch.equal(v, rs.updater_state[lk][pk][sk])
        assert rs.updater_state["1"]["W"]["m"].shape == (64, 64)
        # each replica holds a quarter of a sharded leaf's state
        assert t._rs_state[1]["1"]["W"]["m"].shape == (64, 16)

    def test_dense_rs_against_jax_by_tolerance(self):
        jconf = mlp_conf(updater=JaxSgd(0.05), depth=3, width=64)
        jn, pn, _ = run_pair(jconf, dict(gradient_sharing="dense_rs"))
        assert max_param_diff(jn, pn) <= PORT_JAX_ATOL

    def test_threshold_rs_learns_with_full_size_residual(self):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        jconf = mlp_conf(updater=JaxAdam(0.01), depth=3, width=64)
        x, y = data(256, seed=8)
        net = port_net(jconf)
        init = net.score(DataSet(x, y))
        t = ParallelTrainer(net, pmesh(), gradient_sharing="threshold_rs")
        t.fit(x, y, epochs=6, batch_size=32)
        assert net.score(DataSet(x, y)) < 0.7 * init
        assert isinstance(t._thr_tau, dict)
        assert t.threshold_residual()["1"]["W"].shape == (N, 64, 64)


class TestAveraging:
    def test_replicas_equal_after_rounds_apart_before(self):
        from deeplearning4j_tpu_torch.optimize.listeners import (
            TrainingListener)
        x, y = data(128)
        net = port_net(bn_dropout_conf())
        t = ParallelTrainer(net, pmesh(), mode="averaging",
                            averaging_frequency=2)
        seen = []

        class Probe(TrainingListener):
            def iteration_done(self, model, iteration, epoch, score, **kw):
                trees = [r.param_table() for r in t._nets()]
                same = all(torch.equal(trees[0][k], tr[k])
                           for tr in trees[1:] for k in trees[0])
                seen.append((iteration, same))

        net.set_listeners(Probe())
        t.fit(ArrayDataSetIterator(x, y, batch_size=16, shuffle=False),
              epochs=1)
        assert len(seen) == 8
        for it, same in seen:
            assert same == ((it + 1) % 2 == 0), seen
        assert len({id(r) for r in t._nets()}) == N


class TestGraphs:
    def _jconf(self, mode="dense"):
        adam = lambda: JaxAdam(0.01)
        conf = (JaxGraphConf.graph_builder()
                .add_inputs("in")
                .add_layer("d1", JaxDense(n_in=16, n_out=16,
                                          activation="tanh",
                                          updater=adam()), "in")
                .add_layer("d2", JaxDense(n_in=16, n_out=16,
                                          activation="tanh",
                                          updater=adam()), "d1")
                .add_layer("out", JaxOutput(n_in=16, n_out=4,
                                            activation="softmax",
                                            loss="mcxent",
                                            updater=adam()), "d2")
                .set_outputs("out").build())
        conf.seed = 9
        conf.gradient_sharing = mode
        return conf

    @pytest.mark.parametrize("mode", ["dense", "threshold"])
    def test_single_input_graph_bucketed(self, mode):
        jconf = self._jconf(mode)
        x, y = data(128, seed=9)
        jn = JaxGraph(jconf).init(9)
        JaxTrainer(jn, jmesh()).fit(x, y, epochs=2, batch_size=32)
        pn = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init(9)
        t = ParallelTrainer(pn, pmesh())
        assert t._is_graph and not t._multi_io_graph
        assert t.gradient_sharing == mode
        t.fit(x, y, epochs=2, batch_size=32)
        assert max_param_diff(jn, pn) <= 1e-4
        if mode == "threshold":
            assert set(t._thr_tau) == {"d1", "d2", "out"}

    def test_multi_io_graph_falls_back_or_raises(self):
        conf = (ComputationGraphConfiguration.graph_builder()
                .add_inputs("a", "b")
                .add_layer("da", _pd(8, 8), "a")
                .add_layer("db", _pd(8, 8), "b")
                .add_layer("oa", _po(8, 3), "da")
                .add_layer("ob", _po(8, 3), "db")
                .set_outputs("oa", "ob").build())
        net = ComputationGraph(conf, device="cpu").init(3)
        t = ParallelTrainer(net, pmesh(), gradient_sharing="threshold")
        assert t._multi_io_graph
        with pytest.raises(NotImplementedError, match="single-"):
            t.fit(np.zeros((8, 8), np.float32),
                  np.zeros((8, 3), np.float32), epochs=1, batch_size=8)
        t = ParallelTrainer(net, pmesh())
        assert t._sync_mode() == "global"


def _pd(n_in, n_out):
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer
    return DenseLayer(n_in=n_in, n_out=n_out)


def _po(n_in, n_out):
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    return OutputLayer(n_in=n_in, n_out=n_out)


class TestGuardsAndPlumbing:
    def test_guards(self, monkeypatch):
        net = port_net(mlp_conf(depth=2))
        with pytest.raises(ValueError, match="sync"):
            ParallelTrainer(net, pmesh(), mode="averaging",
                            gradient_sharing="dense_rs")
        with pytest.raises(ValueError, match="sync|averaging"):
            ParallelTrainer(net, pmesh(), mode="async")
        monkeypatch.setenv("DL4J_GRADIENT_SHARING", "threshold")
        t = ParallelTrainer(net, pmesh(), mode="averaging")
        assert t.gradient_sharing == "dense"
        assert ParallelTrainer(net, pmesh()).gradient_sharing == "threshold"
        monkeypatch.delenv("DL4J_GRADIENT_SHARING")
        net.conf.gradient_normalization = "clip_l2_per_layer"
        with pytest.raises(ValueError, match="elementwise"):
            ParallelTrainer(net, pmesh(), gradient_sharing="threshold_rs")
        with pytest.raises(RuntimeError, match="CUDA"):
            ParallelTrainer(net)

    def test_ragged_batches(self, caplog):
        x, y = data(40)
        net = port_net(mlp_conf(depth=2))
        t = ParallelTrainer(net, pmesh())
        t.fit(ArrayDataSetIterator(x, y, batch_size=16, shuffle=False))
        assert net.iteration_count == 3          # the tail of 8 trains too
        with pytest.raises(ValueError, match="indivisible"):
            t.fit(x[:6], y[:6], batch_size=6)
        assert "dropping ragged batch" in caplog.text

    def test_evaluate_pads_ragged_tail(self):
        x, y = data(50)
        net = port_net(mlp_conf(depth=2))
        e = ParallelTrainer(net, pmesh()).evaluate(x, y, batch_size=16)
        want = net.evaluate(ArrayDataSetIterator(x, y, batch_size=16,
                                                 shuffle=False))
        assert e.accuracy() == want.accuracy()
        assert e.f1() == want.f1()
        assert e.stats() == want.stats()

    def test_sharded_prefetch_matches_plain_iterator(self):
        x, y = data(128)
        nets = []
        for sharded in (False, True):
            net = port_net(bn_dropout_conf())
            it = ArrayDataSetIterator(x, y, batch_size=32, shuffle=False)
            if sharded:
                it = DevicePrefetchIterator(
                    it, sharding=DataSharding(pmesh()), device="cpu")
            ParallelTrainer(net, pmesh(), gradient_sharing="dense").fit(
                it, epochs=2)
            nets.append(net)
        for k, v in nets[0].param_table().items():
            assert torch.equal(v, nets[1].param_table()[k]), k

    def test_threshold_residual_and_counters(self):
        x, y = data(64)
        net = port_net(mlp_conf(depth=4))
        reg = monitor.MetricsRegistry()
        monitor.enable(registry=reg)
        try:
            t = ParallelTrainer(net, pmesh(), gradient_sharing="threshold")
            t.fit(x, y, epochs=1, batch_size=32)
        finally:
            monitor.disable()
            monitor._STATE.registry = monitor.GLOBAL_REGISTRY
        res = t.threshold_residual()
        assert set(res) == {"0", "1", "2", "3", "4"}
        assert res["0"]["W"].shape == (N, 16, 16)
        assert any(float(np.abs(v).max()) > 0 for lr in res.values()
                   for v in lr.values())
        assert reg.counter("gradient_exchange_steps_total",
                           mode="threshold", trainer="parallel").value == 2
        from deeplearning4j_tpu_torch.parallel import gradient_sharing as gs
        params = t._params()
        assert reg.gauge("gradient_sharing_compression_ratio",
                         trainer="parallel").value == (
            gs.exchange_wire_bytes(params, "dense")
            / gs.exchange_wire_bytes(params, "threshold", n_workers=N))

    def test_diagnostics_refused_outside_dense(self):
        jconf = mlp_conf(depth=2)
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu", diagnostics=True).init()
        x, y = data(32)
        # the exchanges no longer refuse diagnostics: threshold runs
        # JAX's `_exchange_diag` and reports "exchange" rows
        ParallelTrainer(net, pmesh(), gradient_sharing="threshold").fit(
            x, y, batch_size=32)
        rows = net._last_diagnostics
        assert rows is not None and "finite" in rows
        ParallelTrainer(net, pmesh()).fit(x, y, batch_size=32)
        assert net._last_diagnostics is not None

    def test_placement_counts_transfers_as_jax(self):
        """`gput_tree` places a host tree and counts its bytes as h2d,
        `host_view_tree` reads it back as d2h (JAX's counters); a tensor
        already on the device is passed through uncounted."""
        from deeplearning4j_tpu import monitor as jmonitor
        from deeplearning4j_tpu.parallel import placement as jplace
        from deeplearning4j_tpu_torch.parallel import placement
        tree = {"0": {"W": np.ones((4, 3), np.float32),
                      "b": np.zeros(3, np.float32)}}
        reg, jreg = monitor.MetricsRegistry(), jmonitor.MetricsRegistry()
        monitor.enable(registry=reg)
        jmonitor.enable(registry=jreg)
        try:
            placed = placement.gput_tree(tree, "cpu")
            assert placement.gput(placed["0"]["W"], "cpu") is placed["0"]["W"]
            back = placement.host_view_tree(placed)
            from jax.sharding import SingleDeviceSharding
            jplace.host_view_tree(jplace.gput_tree(tree, SingleDeviceSharding(
                jax_make_mesh(JaxMeshSpec.of(data=1)).devices.flat[0])))
        finally:
            for m, g in ((monitor, monitor.GLOBAL_REGISTRY),
                         (jmonitor, jmonitor.GLOBAL_REGISTRY)):
                m.disable()
                m._STATE.registry = g
        np.testing.assert_array_equal(back["0"]["W"], tree["0"]["W"])
        for d in ("h2d", "d2h"):
            assert reg.counter("jax_transfer_bytes_total",
                               direction=d).value == 60.0
            assert jreg.counter("jax_transfer_bytes_total",
                                direction=d).value == 60.0

