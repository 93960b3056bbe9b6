"""The port's training masters and their stats (`deeplearning4j_tpu_torch/
parallel/{master,stats}.py`), `EarlyStoppingParallelTrainer` and the
monitor's `bind_master_stats` / `attach_master_stats` against the JAX
package's on 4-way CPU meshes: the same phase counts and params as
JAX's masters (averaging and shared), the timeline exports, per-epoch
checkpoints with resume and retries, `execute_evaluation` merged over
shards, early stopping through the parallel trainer, and the phase
events on the registry and the tracer."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.earlystopping import conditions as jc
from deeplearning4j_tpu.earlystopping.config import (
    EarlyStoppingConfiguration as JaxESConf,
)
from deeplearning4j_tpu.earlystopping.scorecalc import (
    DataSetLossCalculator as JaxLossCalc,
)
from deeplearning4j_tpu.earlystopping.trainer import (
    EarlyStoppingParallelTrainer as JaxESParallel,
)
from deeplearning4j_tpu.eval import Evaluation as JaxEvaluation
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import (
    ParameterAveragingTrainingMaster as JaxPAMaster,
    SharedTrainingMaster as JaxSharedMaster,
)
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    EarlyStoppingConfiguration,
    EarlyStoppingParallelTrainer,
)
from deeplearning4j_tpu_torch.earlystopping import conditions as pc
from deeplearning4j_tpu_torch.earlystopping.scorecalc import (
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.monitor import bind_master_stats
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelTrainer,
    ParameterAveragingTrainingMaster,
    SharedTrainingMaster,
    TrainingMasterStats,
    make_mesh,
)

ATOL = 1e-5


def jconf(updater=None):
    return (JaxBuilder.builder().seed(3).updater(updater or JaxAdam(1e-2))
            .list()
            .layer(JaxDense(n_in=5, n_out=12, activation="relu"))
            .layer(JaxOutput(n_in=12, n_out=3, activation="softmax",
                             loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(5)).build())


def nets(updater=None):
    c = jconf(updater)
    return JaxNet(c).init(), MultiLayerNetwork(
        MultiLayerConfiguration.from_json(c.to_json()), device="cpu").init()


def data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("data",))


def pmesh(n):
    return make_mesh(MeshSpec.of(data=n), devices=["cpu"] * n)


def close(jn, pn, atol=ATOL):
    jp, pp = jn.param_table(), pn.param_table()
    for k in jp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   atol=atol, err_msg=k)


class TestMastersAgainstJax:
    @pytest.mark.parametrize("n,freq", [(4, 2), (2, 1)])
    def test_parameter_averaging_phases_and_params(self, n, freq):
        jn, pn = nets()
        x, y = data()
        jm = JaxPAMaster(batch_size_per_worker=8, averaging_frequency=freq,
                         mesh=jmesh(n), collect_training_stats=True)
        jm.execute_training(jn, (x, y), epochs=2)
        pm = ParameterAveragingTrainingMaster(
            batch_size_per_worker=8, averaging_frequency=freq,
            mesh=pmesh(n), collect_training_stats=True)
        pm.execute_training(pn, (x, y), epochs=2)
        ps, js = pm.get_training_stats(), jm.get_training_stats()
        assert ps.phase_counts() == js.phase_counts()
        assert ps.round_count == js.round_count
        assert ps.phase_counts()["broadcast"] == 1
        assert all(v >= 0 for v in ps.phase_totals_ms().values())
        close(jn, pn)

    def test_shared_master_sync_steps_and_params(self):
        jn, pn = nets()
        x, y = data()
        jm = JaxSharedMaster(batch_size_per_worker=16, mesh=jmesh(2),
                             collect_training_stats=True, threshold=1e-3)
        jm.execute_training(jn, (x, y), epochs=2)
        pm = SharedTrainingMaster(batch_size_per_worker=16, mesh=pmesh(2),
                                  collect_training_stats=True,
                                  threshold=1e-3)
        pm.execute_training(pn, (x, y), epochs=2)
        assert (pm.get_training_stats().phase_counts()
                == jm.get_training_stats().phase_counts())
        close(jn, pn)

    def test_shared_master_fused_steps(self):
        jn, pn = nets()
        x, y = data()
        JaxSharedMaster(batch_size_per_worker=8, mesh=jmesh(2),
                        steps_per_execution=3).execute_training(
            jn, (x, y), epochs=1)
        SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(2),
                             steps_per_execution=3).execute_training(
            pn, (x, y), epochs=1)
        assert pn.iteration_count == jn.iteration_count == 4
        close(jn, pn)

    def test_stats_off_by_default_and_exports(self, tmp_path):
        _, pn = nets()
        x, y = data(32)
        m = SharedTrainingMaster(batch_size_per_worker=16, mesh=pmesh(2))
        m.execute_training(pn, (x, y), epochs=1)
        assert m.get_training_stats() is None
        m = ParameterAveragingTrainingMaster(
            batch_size_per_worker=8, averaging_frequency=1, mesh=pmesh(2),
            collect_training_stats=True)
        m.execute_training(pn, (x, y), epochs=1)
        stats = m.get_training_stats()
        events = []
        stats.add_listener(events.append)
        stats.record("average", 0.001, round=99)
        assert events and events[0]["phase"] == "average"
        html = open(stats.export_html(str(tmp_path / "t.html"))).read()
        assert "TrainingMaster timeline" in html and "local_fit" in html
        got = json.loads(open(stats.export_json(
            str(tmp_path / "t.json"))).read())
        assert got["summary"]["events"] == len(got["timeline"])


class TestMasterFaultTolerance:
    def test_checkpoints_written_and_resume(self, tmp_path):
        x, y = data()
        _, pn = nets()
        d = str(tmp_path / "ck")
        m = SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(2),
                                 checkpoint_dir=d, checkpoint_every=1)
        m.execute_training(pn, (x, y), epochs=2)
        assert sorted(os.listdir(d)) == ["epoch00000.zip", "epoch00001.zip"]
        # a fresh model resumes from epoch 1's zip and trains epoch 2
        _, p2 = nets()
        SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(2),
                             checkpoint_dir=d).execute_training(
            p2, (x, y), epochs=3)
        _, ref = nets()
        SharedTrainingMaster(batch_size_per_worker=8,
                             mesh=pmesh(2)).execute_training(
            ref, (x, y), epochs=3)
        for k, v in ref.param_table().items():
            np.testing.assert_allclose(p2.param_table()[k].numpy(),
                                       v.numpy(), atol=1e-6)
        # JAX resumes the port's epoch zips
        jn, _ = nets()
        JaxSharedMaster(batch_size_per_worker=8, mesh=jmesh(2),
                        checkpoint_dir=d).execute_training(
            jn, (x, y), epochs=3)
        close(jn, p2, atol=1e-5)

    def test_retry_restores_the_initial_state(self, monkeypatch):
        x, y = data()
        _, pn = nets()
        _, ref = nets()
        calls = {"n": 0}
        real = ParallelTrainer.fit

        def flaky(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                real(self, *a, **k)        # train, then fail
                raise RuntimeError("worker lost")
            return real(self, *a, **k)

        monkeypatch.setattr(ParallelTrainer, "fit", flaky)
        SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(2),
                             max_retries=1).execute_training(
            pn, (x, y), epochs=1)
        monkeypatch.setattr(ParallelTrainer, "fit", real)
        SharedTrainingMaster(batch_size_per_worker=8,
                             mesh=pmesh(2)).execute_training(
            ref, (x, y), epochs=1)
        assert calls["n"] == 2
        assert pn.iteration_count == ref.iteration_count
        for k, v in ref.param_table().items():
            np.testing.assert_array_equal(pn.param_table()[k].numpy(),
                                          v.numpy())

    def test_retry_budget_exhausted_raises(self, monkeypatch):
        x, y = data()
        _, pn = nets()

        def broken(self, *a, **k):
            raise RuntimeError("always")

        monkeypatch.setattr(ParallelTrainer, "fit", broken)
        with pytest.raises(RuntimeError, match="always"):
            SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(2),
                                 max_retries=2).execute_training(
                pn, (x, y), epochs=1)


class TestEvaluation:
    def test_execute_evaluation_matches_jax_and_host(self):
        jn, pn = nets()
        x, y = data(50)
        jm = JaxSharedMaster(batch_size_per_worker=8, mesh=jmesh(4))
        pm = SharedTrainingMaster(batch_size_per_worker=8, mesh=pmesh(4))
        je = jm.execute_evaluation(jn, (x, y), batch_size=16)
        pe = pm.execute_evaluation(pn, (x, y), batch_size=16)
        host = pn.evaluate(ArrayDataSetIterator(x, y, batch_size=16,
                                                shuffle=False))
        assert pe.accuracy() == je.accuracy() == host.accuracy()
        assert np.array_equal(pe.confusion.matrix, host.confusion.matrix)
        # the caller's configuration reaches every shard
        top2 = pm.execute_evaluation(pn, (x, y), evaluation=Evaluation(
            top_n=2), batch_size=16)
        jtop2 = jm.execute_evaluation(jn, (x, y), evaluation=JaxEvaluation(
            top_n=2), batch_size=16)
        assert top2.top_n_accuracy() == jtop2.top_n_accuracy()


class TestEarlyStoppingParallel:
    @pytest.mark.parametrize("mode", ["sync", "averaging"])
    def test_matches_jax(self, mode):
        x, y = data(64, seed=1)
        xh, yh = data(32, seed=2)
        jn, pn = nets(JaxSgd(0.1))
        theirs = JaxESConf(
            score_calculator=JaxLossCalc(JaxArrayIterator(xh, yh,
                                                          batch_size=16)),
            epoch_termination_conditions=[
                jc.MaxEpochsTerminationCondition(4),
                jc.ScoreImprovementEpochTerminationCondition(2)])
        mine = EarlyStoppingConfiguration(
            score_calculator=DataSetLossCalculator(
                ArrayDataSetIterator(xh, yh, batch_size=16)),
            epoch_termination_conditions=[
                pc.MaxEpochsTerminationCondition(4),
                pc.ScoreImprovementEpochTerminationCondition(2)])
        jr = JaxESParallel(theirs, jn, JaxArrayIterator(
            x, y, batch_size=16, shuffle=False), jmesh(4), mode=mode,
            averaging_frequency=2, batch_size=16).fit()
        pr = EarlyStoppingParallelTrainer(
            mine, pn, ArrayDataSetIterator(x, y, batch_size=16,
                                           shuffle=False),
            pmesh(4), mode=mode, averaging_frequency=2, batch_size=16).fit()
        assert pr.best_model_epoch == jr.best_model_epoch
        assert pr.total_epochs == jr.total_epochs
        assert pr.termination_reason.name == jr.termination_reason.name
        for e, s in jr.score_vs_epoch.items():
            assert pr.score_vs_epoch[e] == pytest.approx(s, rel=1e-5)
        assert pr.best_model_score == pytest.approx(jr.best_model_score,
                                                    rel=1e-5)
        close(jn, pn)


class TestMonitorSink:
    def _monitored(self):
        reg, tr = monitor.MetricsRegistry(), monitor.Tracer()
        monitor.enable(registry=reg, tracer=tr)
        return reg, tr

    def _restore(self):
        monitor.disable()
        monitor._STATE.registry = monitor.GLOBAL_REGISTRY
        monitor._STATE.tracer = monitor.GLOBAL_TRACER

    def test_bind_master_stats(self):
        reg, tr = monitor.MetricsRegistry(), monitor.Tracer()
        tr.enabled = True
        stats = bind_master_stats(TrainingMasterStats(), reg, tr)
        with stats.time_phase("local_fit", round=0):
            pass
        stats.record("average", 0.002, round=0)
        assert reg.counter("parallel_phase_total",
                           phase="local_fit").value == 1
        assert reg.counter("parallel_phase_total",
                           phase="average").value == 1
        assert "parallel_phase_seconds" in reg.exposition()
        names = tr.span_names()
        assert "master/local_fit" in names and "master/average" in names

    def test_trainer_routes_to_registry_once(self):
        reg, tr = self._monitored()
        try:
            stats = TrainingMasterStats()
            _, pn = nets()
            t = ParallelTrainer(pn, pmesh(2), stats=stats)
            x, y = data(32)
            t.fit(x, y, epochs=1, batch_size=16)
            t.fit(x, y, epochs=1, batch_size=16)
            assert reg.counter("parallel_phase_total",
                               phase="sync_step").value == 4
            assert reg.counter("parallel_phase_total",
                               phase="broadcast").value == 2
            assert any(n.startswith("master/") for n in tr.span_names())
            assert reg.counter("training_iterations_total",
                               model="default").value == 4
        finally:
            self._restore()
