"""Two repairs of the port against the JAX reference, and the training
side's stragglers, each held to the JAX package on the CPU.

- Freezing: `TransferLearning.Builder.set_feature_extractor` gives the
  frozen layers a NoOp updater and leaves them training, as JAX's
  builder does (JAX `transferlearning/transfer.py:111-112`): a frozen
  BatchNormalization normalizes with batch statistics and updates its
  running mean and variance, and a frozen DropoutLayer still drops.
  Dense -> BatchNorm -> Dropout -> Output, layers 0-2 frozen, Sgd(0.05),
  2 steps on 16 rows: params, running state and score equal JAX's.
- Widths: an unresolved `n_in` raises JAX's `ValueError("... input
  width unresolved ...")` from `init()` of both containers (JAX
  `validate_param_widths`, `tests/test_eval_depth.py:236-248`).
- `MultipleEpochsIterator`, `EarlyTerminationDataSetIterator`,
  `SamplingDataSetIterator`, `BenchmarkDataSetIterator`,
  `TimedDataSetIterator` and the iterators' `total_outcomes` /
  `input_columns` yield JAX's batches; `memory_report` equals JAX's
  for the same configuration (`tests/test_data_misc.py:135-150`);
  `SleepyTrainingListener` sleeps as JAX's does.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import dataclasses
import time

import numpy as np
import pytest

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets import iterator as jit
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import graph as jgraph_net
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.memory import memory_report as jax_memory
from deeplearning4j_tpu.nn.layers import (
    BatchNormalization as JaxBN,
    ConvolutionLayer as JaxConv,
    DenseLayer as JaxDense,
    DropoutLayer as JaxDropout,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import (
    SleepyTrainingListener as JaxSleepy,
)
from deeplearning4j_tpu.transferlearning import transfer as jt
from deeplearning4j_tpu_torch.common.updaters import NoOp, Sgd
from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator,
    BenchmarkDataSetIterator,
    DataSet,
    EarlyTerminationDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
    TimedDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.memory import memory_report
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import (
    SleepyTrainingListener,
)
from deeplearning4j_tpu_torch.transferlearning import (
    FineTuneConfiguration,
    TransferLearning,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    from_jax_state,
    to_jax_params,
    to_jax_state,
    to_numpy_params,
)

RTOL = 1e-5


def _pair(conf):
    jnet = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    from_jax_state(net, to_numpy_params(jnet.net_state))
    return jnet, net


def _close(got, want, what):
    for lk, lp in to_numpy_params(want).items():
        for name, w in lp.items():
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(got[lk][name] - w).max())
            assert err <= RTOL * scale, (what, lk, name, err)


# ------------------------------------------------------------- freezing
def test_frozen_batchnorm_and_dropout_train_as_jax():
    conf = (JaxBuilder.builder().seed(7).updater(JaxSgd(0.2)).list()
            .layer(JaxDense(n_in=6, n_out=8, activation="tanh"))
            .layer(JaxBN(n_out=8))
            .layer(JaxDropout(dropout=0.7))
            .layer(JaxOutput(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())
    jold, old = _pair(conf)
    jnew = (jt.TransferLearning.Builder(jold)
            .fine_tune_configuration(jt.FineTuneConfiguration(
                updater=JaxSgd(0.05)))
            .set_feature_extractor(2).build())
    new = (TransferLearning.Builder(old)
           .fine_tune_configuration(FineTuneConfiguration(updater=Sgd(0.05)))
           .set_feature_extractor(2).build(device="cpu"))
    assert [type(l).__name__ for l in new.layers] == [
        type(l).__name__ for l in jnew.conf.layers]
    assert all(isinstance(l.updater, NoOp) for l in new.layers[:3])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    frozen = {k: v for k, v in to_jax_params(new).items() if k in "01"}
    state0 = to_jax_state(new)["1"]["mean"].copy()
    for _ in range(2):
        new.fit(x, y, batch_size=16)
        jnew.fit(x, y, batch_size=16)
    np.testing.assert_allclose(new.score_value, jnew.score_value, rtol=RTOL)
    _close(to_jax_params(new), jnew.params, "params")
    _close(to_jax_state(new), jnew.net_state, "running state")
    # the frozen layers' params stayed; BatchNorm's running mean moved
    for lk, lp in frozen.items():
        for name, w in lp.items():
            assert np.array_equal(to_jax_params(new)[lk][name], w)
    assert not np.array_equal(to_jax_state(new)["1"]["mean"], state0)


# --------------------------------------------------------------- widths
def _jax_unresolved_list():
    return (JaxBuilder.builder().seed(0).updater(JaxAdam(1e-2)).list()
            .layer(JaxDense(n_out=16, activation="relu"))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())


def _jax_unresolved_graph():
    b = jgraph_net.ComputationGraphConfiguration.graph_builder(
        JaxBuilder.builder().seed(0).updater(JaxAdam(1e-2)))
    b.add_inputs("in")
    b.add_layer("dense", JaxDense(n_out=4), "in")       # no n_in
    b.add_layer("out", JaxOutput(n_in=4, n_out=3), "dense")
    b.set_outputs("out")
    return b.build()


@pytest.mark.parametrize("kind", ["list", "graph"])
def test_unresolved_width_raises_jax_error_at_init(kind):
    if kind == "list":
        jconf = _jax_unresolved_list()
        with pytest.raises(ValueError) as jerr:
            JaxNet(jconf).init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu")
    else:
        jconf = _jax_unresolved_graph()
        with pytest.raises(ValueError) as jerr:
            jgraph_net.ComputationGraph(jconf).init()
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu")
    assert "input width unresolved" in str(jerr.value)
    with pytest.raises(ValueError) as err:
        net.init()
    assert str(err.value) == str(jerr.value)


def test_resolved_widths_still_init():
    conf = (NeuralNetConfiguration.builder().seed(0).list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=2)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert tuple(net.layers[0].W.shape) == (4, 8)


# ------------------------------------------------------------ iterators
def _batches(it):
    return [(np.asarray(d.features), None if d.labels is None
             else np.asarray(d.labels)) for d in it]


def _equal(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def _xy(n=10):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


@pytest.mark.parametrize("wrapper", ["epochs", "early", "sampling",
                                     "benchmark", "benchmark_labels",
                                     "timed"])
def test_iterator_wrappers_yield_jax_batches(wrapper):
    x, y = _xy()

    def base(mod):
        return mod.ArrayDataSetIterator(x, y, batch_size=4)

    build = {
        "epochs": lambda mod: mod.MultipleEpochsIterator(3, base(mod)),
        "early": lambda mod: mod.EarlyTerminationDataSetIterator(
            base(mod), 2),
        "sampling": lambda mod: mod.SamplingDataSetIterator(
            (JaxDataSet if mod is jit else DataSet)(x, y), 5, 4, seed=9),
        "benchmark": lambda mod: mod.BenchmarkDataSetIterator(
            (6, 3, 2), 5, 3, seed=1),
        "benchmark_labels": lambda mod: mod.BenchmarkDataSetIterator(
            (6, 3), 5, 2, seed=1, label_shape=(6, 2)),
        "timed": lambda mod: mod.TimedDataSetIterator(base(mod)),
    }[wrapper]
    port_mod = __import__("deeplearning4j_tpu_torch.datasets.iterator",
                          fromlist=["x"])
    j, p = build(jit), build(port_mod)
    _equal(_batches(p), _batches(j))
    if wrapper in ("epochs", "early", "timed"):
        p.reset()
        j.reset()
        _equal(_batches(p), _batches(j))
    assert p.batch_size() == j.batch_size()
    if wrapper == "timed":
        assert p.batches == 6 and p.total_etl_ms >= p.last_etl_ms >= 0
        assert p.total_outcomes() == j.total_outcomes() == 4
        assert p.input_columns() is None
        assert p.cursor() == p.base.cursor()


def test_widths_of_the_base_iterators():
    x, y = _xy()
    assert ArrayDataSetIterator(x, y).total_outcomes() == 4
    assert ArrayDataSetIterator(x).total_outcomes() is None
    it = ListDataSetIterator([DataSet(x, y)])
    assert it.total_outcomes() is None and it.input_columns() is None
    assert EarlyTerminationDataSetIterator(it, 1).batch_size() is None
    assert MultipleEpochsIterator(2, it).total_outcomes() is None
    assert len(list(MultipleEpochsIterator(2, it))) == 2
    assert len(list(SamplingDataSetIterator(DataSet(x, y), 2, 3))) == 3
    assert BenchmarkDataSetIterator((2, 3), 4, 1).batch_size() == 2
    assert TimedDataSetIterator(it).total_outcomes() is None


# ------------------------------------------------------- memory report
def _memory_confs():
    conv = (JaxBuilder.builder().updater(JaxAdam(1e-3)).list()
            .layer(JaxConv(n_out=20, kernel_size=(5, 5)))
            .layer(JaxDense(n_out=100, activation="relu"))
            .layer(JaxOutput(n_out=10))
            .set_input_type(JaxInputType.convolutional(28, 28, 1)).build())
    sgd = (JaxBuilder.builder().updater(JaxSgd(0.1)).list()
           .layer(JaxDense(n_in=4, n_out=8))
           .layer(JaxOutput(n_in=8, n_out=2))
           .set_input_type(JaxInputType.feed_forward(4)).build())
    return {"conv_adam": conv, "dense_sgd": sgd}


@pytest.mark.parametrize("name", ["conv_adam", "dense_sgd"])
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_memory_report_equals_jax(name, dtype_bytes):
    jconf = _memory_confs()[name]
    want = jax_memory(jconf, dtype_bytes=dtype_bytes)
    got = memory_report(MultiLayerConfiguration.from_json(jconf.to_json()),
                        dtype_bytes=dtype_bytes)
    assert [dataclasses.asdict(r) for r in got.layer_reports] == \
        [dataclasses.asdict(r) for r in want.layer_reports]
    for b in (1, 32):
        assert got.total_bytes(b) == want.total_bytes(b)
        assert got.summary(b) == want.summary(b)
    assert got.total_parameter_bytes() == want.total_parameter_bytes()
    if name == "conv_adam":
        assert got.layer_reports[0].parameter_bytes == 520 * dtype_bytes
    else:
        assert all(r.updater_state_bytes == 0 for r in got.layer_reports)


# ------------------------------------------------------------ listener
@pytest.mark.parametrize("it_ms,ep_ms", [(20.0, 0.0), (0.0, 30.0)])
def test_sleepy_listener_sleeps_as_jax(it_ms, ep_ms):
    for cls in (SleepyTrainingListener, JaxSleepy):
        lst = cls(timer_iteration_ms=it_ms, timer_epoch_ms=ep_ms)
        t0 = time.perf_counter()
        lst.iteration_done(None, 0, 0, 1.0)
        lst.on_epoch_end(None, 0)
        assert time.perf_counter() - t0 >= (it_ms + ep_ms) / 1e3 * 0.9
    x, y = _xy(8)
    conf = (NeuralNetConfiguration.builder().seed(0).list()
            .layer(DenseLayer(n_in=3, n_out=4))
            .layer(OutputLayer(n_in=4, n_out=4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.add_listener(SleepyTrainingListener(timer_iteration_ms=it_ms,
                                            timer_epoch_ms=ep_ms))
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=4, epochs=1)
    assert time.perf_counter() - t0 >= (2 * it_ms + ep_ms) / 1e3 * 0.9
