"""The containers' training runtime in the port against the JAX package's,
on the CPU: `steps_per_execution` groups against per-step fit (bit for
bit) and the listeners' `step_boundary` sequence against JAX's fused
fit; `data_format` NCHW and NCW against the native layout and against
JAX's `fit`; `copy()` and `set_param_table`; a two-input, two-output
ComputationGraph fit over a `MultiDataSet`; the remat policies
(gradients bit-equal to no remat, fp32 and mixed_bf16, and training
against JAX's remat net); and phase 14 of chip_smoke.py in its small
mode.

Tolerances: RTOL 1e-5 on params and losses against JAX (Sgd or a few
Adam steps of tiny nets, where the two packages' fp32 sums differ in
their last bits).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.datasets.multidataset import (
    MultiDataSet as JaxMultiDataSet,
)
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.conf.graph import MergeVertex as JaxMerge
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import (
    TrainingListener as JaxListener,
)
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    DataSet,
)
from deeplearning4j_tpu_torch.datasets.multidataset import (
    MultiDataSet,
    MultiDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.jax_params import (
    to_jax_params,
    to_numpy_params,
)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def port_of(jconf, **kw):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", **kw).init()


def mlp_conf(updater=None, seed=7):
    return (JaxBuilder.builder().seed(seed)
            .updater(updater or JaxAdam(0.01)).list()
            .layer(jl.DenseLayer(n_in=8, n_out=8, activation="tanh"))
            .layer(jl.DenseLayer(n_in=8, n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())


def data(n=44, n_in=8, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def params_close(net, jparams, rtol=RTOL):
    got = to_jax_params(net)
    for lk, lp in to_numpy_params(jparams).items():
        for name, w in lp.items():
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(got[lk][name] - w).max())
            assert err <= rtol * scale, (lk, name, err)


def bitwise(a, b):
    pa, pb = to_jax_params(a), to_jax_params(b)
    return all(np.array_equal(pa[k][n], pb[k][n]) for k in pa for n in pa[k])


class _Probe(TrainingListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.seen.append((iteration, info.get("step_boundary", True), score,
                          model.iteration_count))


class _JaxProbe(JaxListener):
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.seen.append((iteration, info.get("step_boundary", True), score,
                          model.iteration_count))


# --------------------------------------------------- steps_per_execution
def test_steps_per_execution_matches_per_step_and_jax_cadence():
    """spe 3 over 44 examples in batches of 8 (5 whole batches and a
    ragged tail of 4), two shuffled epochs: params and updater state
    bit-equal to spe 1, and the listener calls (iteration, step_boundary,
    iteration_count at the call) equal to JAX's fused fit's, the scores
    within RTOL."""
    x, y = data()
    ref, net = port_of(mlp_conf()), port_of(mlp_conf())
    ref.fit(ArrayDataSetIterator(x, y, batch_size=8, shuffle=True), epochs=2)
    probe = _Probe()
    net.add_listener(probe)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8, shuffle=True), epochs=2,
            steps_per_execution=3)
    assert bitwise(ref, net)
    for lk in ref.updater_state:
        for pk in ref.updater_state[lk]:
            for s, t in ref.updater_state[lk][pk].items():
                assert torch.equal(t, net.updater_state[lk][pk][s])
    jnet = JaxNet(mlp_conf()).init()
    jprobe = _JaxProbe()
    jnet.add_listener(jprobe)
    jnet.fit(JaxArrayIterator(x, y, batch_size=8, shuffle=True), epochs=2,
             steps_per_execution=3)
    assert [s[:2] + s[3:] for s in probe.seen] == [
        s[:2] + s[3:] for s in jprobe.seen]
    assert [b for _, b, _, _ in probe.seen] == [False, False, True,
                                               False, True, True] * 2
    np.testing.assert_allclose([s[2] for s in probe.seen],
                               [s[2] for s in jprobe.seen], rtol=RTOL)
    params_close(net, jnet.params)


def test_steps_per_execution_falls_back_on_masks_and_reads_once(monkeypatch):
    """Masked batches go per step (every callback a boundary); an
    unmasked group reads its losses back in one transfer."""
    x, y = data(n=16)
    batches = [DataSet(x[i:i + 4], y[i:i + 4]) for i in range(0, 16, 4)]
    masked = [DataSet(b.features, b.labels,
                      labels_mask=np.ones(4, np.float32)) for b in batches]
    net = port_of(mlp_conf())
    probe = _Probe()
    net.add_listener(probe)
    net.fit(masked, steps_per_execution=4)
    assert [b for _, b, _, _ in probe.seen] == [True] * 4
    reads = []
    orig = torch.Tensor.cpu

    def counting(t, *a, **k):
        reads.append(tuple(t.shape))
        return orig(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    probe.seen.clear()
    net.fit(batches, steps_per_execution=4)
    assert reads == [(4,)]
    assert [b for _, b, _, _ in probe.seen] == [False, False, False, True]


# ------------------------------------------------------------ data_format
def cnn_conf():
    return (JaxBuilder.builder().seed(3).updater(JaxSgd(0.1)).list()
            .layer(jl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       activation="relu"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(6, 5, 2)).build())


def rnn_conf():
    return (JaxBuilder.builder().seed(4).updater(JaxSgd(0.1)).list()
            .layer(jl.LSTM(n_in=3, n_out=5))
            .layer(jl.RnnOutputLayer(n_in=5, n_out=4, activation="softmax",
                                     loss="mcxent"))
            .build())


@pytest.mark.parametrize("fmt", ["NCHW", "NCW"])
def test_data_format_matches_native_and_jax(fmt):
    rng = np.random.default_rng(5)
    if fmt == "NCHW":
        conf, native = cnn_conf(), rng.standard_normal((8, 6, 5, 2))
        x = np.transpose(native, (0, 3, 1, 2)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        y_native = y
    else:
        conf, native = rnn_conf(), rng.standard_normal((8, 7, 3))
        x = np.transpose(native, (0, 2, 1)).astype(np.float32)
        y_native = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (8, 7))]
        y = np.transpose(y_native, (0, 2, 1))
    native = native.astype(np.float32)
    net, twin = port_of(conf), port_of(conf)
    torch.testing.assert_close(net.output(x, data_format=fmt),
                               net.output(native), rtol=0, atol=1e-6)
    acts = net.feed_forward(x, data_format=fmt)
    assert len(acts) == 2
    jnet = JaxNet(conf).init()
    for _ in range(2):
        net.fit(x, y, batch_size=4, shuffle=False, data_format=fmt)
        twin.fit(native, y_native, batch_size=4, shuffle=False)
        jnet.fit(x, y, batch_size=4, shuffle=False, data_format=fmt)
    params_close(net, jnet.params)
    pa, pb = to_jax_params(net), to_jax_params(twin)
    for k in pa:
        for n in pa[k]:
            np.testing.assert_allclose(pa[k][n], pb[k][n], rtol=0,
                                       atol=1e-6)
    if fmt == "NCW":
        net.rnn_clear_previous_state()
        step = net.rnn_time_step(x, data_format=fmt)
        torch.testing.assert_close(step, net.output(native), rtol=0,
                                   atol=1e-6)
    else:
        ev = net.evaluate(ArrayDataSetIterator(x, y), data_format=fmt)
        want = net.evaluate(ArrayDataSetIterator(native, y))
        assert ev.accuracy() == want.accuracy()


# --------------------------------------------------- copy, param table
def test_copy_is_independent_and_set_param_table_writes_jax_params():
    x, y = data(n=16)
    net = port_of(mlp_conf())
    net.fit(x, y, batch_size=8)
    clone = net.copy()
    assert bitwise(net, clone) and clone.iteration_count == 2
    before = {k: {n: a.copy() for n, a in v.items()}
              for k, v in to_jax_params(net).items()}
    clone.fit(x, y, batch_size=8)
    after = to_jax_params(net)
    assert all(np.array_equal(before[k][n], after[k][n])
               for k in before for n in before[k])
    assert not bitwise(net, clone)
    jnet = JaxNet(mlp_conf(seed=99)).init()
    v = net.params_version
    net.set_param_table({k: np.asarray(a) for k, a in
                         jnet.param_table().items()})
    assert net.params_version > v
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        net.set_param_table({"0_W": np.zeros((2, 2), np.float32)})


# ----------------------------------------------------------- MultiDataSet
def two_io_conf():
    g = JaxGraphConf.graph_builder(
        JaxBuilder.builder().seed(2).updater(JaxAdam(0.01)))
    g.add_inputs("inA", "inB")
    g.add_vertex("merged", JaxMerge(), "inA", "inB")
    g.add_layer("shared", jl.DenseLayer(n_in=7, n_out=8,
                                        activation="relu"), "merged")
    g.add_layer("outA", jl.OutputLayer(n_in=8, n_out=2, activation="softmax",
                                       loss="mcxent"), "shared")
    g.add_layer("outB", jl.OutputLayer(n_in=8, n_out=1,
                                       activation="identity", loss="mse"),
                "shared")
    g.set_outputs("outA", "outB")
    return g.build()


def test_multidataset_graph_fit_matches_jax():
    rng = np.random.default_rng(6)
    xa = rng.standard_normal((5, 3)).astype(np.float32)
    xb = rng.standard_normal((5, 4)).astype(np.float32)
    ya = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    yb = rng.standard_normal((5, 1)).astype(np.float32)
    conf = two_io_conf()
    jnet = JaxGraph(conf).init()
    jnet.fit(JaxMultiDataSet(features=[xa, xb], labels=[ya, yb]), epochs=3)
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    net.fit(MultiDataSet(features=[xa, xb], labels=[ya, yb]), epochs=3)
    params_close(net, jnet.params)
    oa, ob = net.output(xa, xb)
    ja, jb = jnet.output(xa, xb)
    np.testing.assert_allclose(oa.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(ob.numpy(), np.asarray(jb), atol=1e-5)
    assert net.iteration_count == 3
    twin = ComputationGraph(ComputationGraphConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    twin.fit(MultiDataSetIterator(
        [MultiDataSet(features=[xa, xb], labels=[ya, yb])] * 3),
        steps_per_execution=3)
    assert bitwise(net, twin)


# ------------------------------------------------------------------ remat
LM = dict(vocab_size=32, d_model=32, n_layers=2, n_heads=2, max_len=16)


def lm_conf(policy, dropout=None):
    conf = JaxLM(**LM, remat_policy=policy).conf()
    for layer in conf.layers:
        layer.updater = JaxSgd(0.1)
        if dropout and type(layer).__name__ == "TransformerEncoderBlock":
            layer.dropout = dropout
    return conf


def lm_batch(seed=0, B=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LM["vocab_size"], (B, LM["max_len"] - 1))
    y = np.eye(LM["vocab_size"], dtype=np.float32)[
        rng.integers(0, LM["vocab_size"], ids.shape)]
    return ids.astype(np.float32), y


def _grads(net, x, y):
    xs, ys = net._features(x), net._labels(y)
    loss, grads, _ = net._loss_and_grads(
        lambda st: net._loss_fn(xs, ys, train=True, rng=net._step_key(0),
                                new_state=st))
    return loss, [grads[id(p)] for _, p in net.named_parameters()]


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
@pytest.mark.parametrize("dtype", [None, "mixed_bf16"])
def test_remat_gradients_are_bit_equal(policy, dtype):
    """The loss and every gradient under a remat policy equal those
    without remat bit for bit (dropout 0.9 on the blocks: the recompute
    redraws the same masks), and the policy really recomputes: the
    blocks' forwards run again in the backward."""
    x, y = lm_batch()
    ref = port_of(lm_conf(None, 0.9), dtype_policy=dtype)
    net = port_of(lm_conf(policy, 0.9), dtype_policy=dtype)
    block = net.layers[2]
    calls = []
    block.register_forward_pre_hook(lambda *a: calls.append(1))
    l0, g0 = _grads(ref, x, y)
    l1, g1 = _grads(net, x, y)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(calls) == 2


@pytest.mark.parametrize("policy", ["none", "full", "dots_saveable"])
def test_remat_fit_matches_jax(policy):
    x, y = lm_batch(1)
    conf = lm_conf(None if policy == "none" else policy)
    jnet = JaxNet(conf).init()
    net = port_of(conf)
    for i in range(2):
        jnet.fit(x, y, batch_size=4, shuffle=False)
        net.fit(x, y, batch_size=4, shuffle=False)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=RTOL)
    params_close(net, jnet.params, rtol=1e-4)


def test_legacy_remat_flag_maps_to_full():
    from deeplearning4j_tpu_torch.nn.container import effective_remat_policy
    conf = JaxLM(**LM, remat=True).conf()
    net = port_of(conf)
    assert effective_remat_policy(net.layers[2]) == "full"
    assert effective_remat_policy(net.layers[0]) is None
    assert port_of(lm_conf("none")).layers[2].remat_policy == "none"
    assert effective_remat_policy(port_of(lm_conf("none")).layers[2]) is None


# ------------------------------------------------- phase 14, small mode
def test_phase_14_small_mode_on_the_cpu():
    """chip_smoke.py's phase 14 at small sizes on the CPU: every check
    but the launch counts (0 on the CPU) holds."""
    import chip_smoke
    fails = chip_smoke.Failures()
    report = {}
    chip_smoke.phase_runtime(torch.device("cpu"), report, fails, small=True)
    assert list(fails) == [], list(fails)
    assert report["runtime"]["lm"]["float32"]["resume_bit_equal"]


def test_fixed_order_embedding_gradient_matches_f_embedding():
    """The fp32 card path's embedding (its gradient summed in one fixed
    order, for a bit-exact resume), run here on the CPU tensors it is
    given: the lookup equal to `F.embedding`'s, the gradient into W
    within fp32 rounding of it and equal from run to run."""
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        _FixedOrderEmbedding)
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 7, (5, 9), generator=gen)
    w = torch.randn(7, 4, generator=gen, requires_grad=True)
    g = torch.randn(5, 9, 4, generator=gen)
    z = torch.nn.functional.embedding(idx, w)
    (want,) = torch.autograd.grad(z, w, g)
    got = []
    for _ in range(2):
        z2 = _FixedOrderEmbedding.apply(idx, w)
        assert torch.equal(z2, z)
        got.append(torch.autograd.grad(z2, w, g)[0])
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0], want, rtol=0, atol=1e-6)
    assert not torch.are_deterministic_algorithms_enabled()
