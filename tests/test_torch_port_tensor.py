"""Tensor, FSDP and expert sharding (`deeplearning4j_tpu_torch/parallel/
tensor.py`) against the JAX package's: the spec functions entry for
entry on MLP, conv+BN, graph and MoE nets (divisibility, the minimum
shard size, the replicated output layer, the expert axis); the sharded
trainer's TP, FSDP, conv+BN (params and BatchNorm running state), graph
and MoE training held to JAX's `ShardedParallelTrainer` at JAX's own
tolerances; threshold under TP; `evaluate` against the host; resume;
and JAX's refusals. JAX runs on the conftest's virtual CPU devices, the
port on ``["cpu"] * n`` meshes."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest

from deeplearning4j_tpu.common.updaters import Adam as JAdam
from deeplearning4j_tpu.common.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JEW
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JGraphConf,
)
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGPool
from deeplearning4j_tpu.nn.layers import MixtureOfExperts as JMoE
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JSub
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import tensor as jtensor
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.parallel import tensor


# ----------------------------------------------------------------- nets
def mlp(updater=None, n_in=12, widths=(32, 32), n_out=4, seed=1):
    b = JBuilder.builder().seed(seed).updater(updater or JAdam(1e-2)).list()
    prev = n_in
    for w in widths:
        b = b.layer(JDense(n_in=prev, n_out=w, activation="relu"))
        prev = w
    return (b.layer(JOutput(n_in=prev, n_out=n_out))
            .set_input_type(JInputType.feed_forward(n_in)).build())


def conv_bn():
    return (JBuilder.builder().seed(5).updater(JAdam(1e-2)).list()
            .layer(JConv(n_out=8, kernel_size=(3, 3), activation="identity",
                         has_bias=False))
            .layer(JBN(activation="relu"))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JOutput(n_out=3))
            .set_input_type(JInputType.convolutional(8, 8, 2)).build())


def graph():
    g = (JGraphConf.graph_builder(JBuilder.builder().seed(9)
                                  .updater(JAdam(1e-2)))
         .add_inputs("in"))
    g.add_layer("conv1", JConv(n_out=4, kernel_size=(3, 3),
                               activation="identity", has_bias=False,
                               convolution_mode="same"), "in")
    g.add_layer("bn1", JBN(activation="relu"), "conv1")
    g.add_layer("conv2", JConv(n_out=4, kernel_size=(3, 3),
                               activation="identity", has_bias=False,
                               convolution_mode="same"), "bn1")
    g.add_vertex("res", JEW(op="add"), "conv2", "bn1")
    g.add_layer("pool", JGPool(), "res")
    g.add_layer("out", JOutput(n_out=3), "pool")
    g.set_outputs("out")
    g.set_input_types(JInputType.convolutional(8, 8, 4))
    return g.build()


def moe():
    return (JBuilder.builder().seed(0).updater(JAdam(1e-2)).list()
            .layer(JMoE(n_experts=4, hidden_size=16, top_k=2))
            .layer(JOutput(n_out=3))
            .set_input_type(JInputType.feed_forward(8)).build())


def pair(conf):
    """The JAX net and the port's, from the same configuration (and so
    the same drawn params)."""
    if isinstance(conf, JGraphConf):
        j = JGraph(conf).init(9)
        p = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf.to_json()), device="cpu").init(9)
    else:
        j = JNet(conf).init()
        p = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json()), device="cpu").init()
    return j, p


def pmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshSpec.of(**axes), devices=["cpu"] * n)


def jmesh(**axes):
    return jmake_mesh(JMeshSpec.of(**axes))


def as_tuples(specs):
    return {lk: {pn: tuple(s) for pn, s in lp.items()}
            for lk, lp in specs.items()}


def assert_params_close(jnet, net, rtol, atol):
    got = net.param_table()
    for lk, lp in jnet.params.items():
        for pn, w in lp.items():
            np.testing.assert_allclose(got[f"{lk}_{pn}"].numpy(),
                                       np.asarray(w), rtol=rtol, atol=atol,
                                       err_msg=f"{lk}:{pn}")


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("build,kw", [
    (lambda: mlp(), {}), (lambda: mlp(), {"axis_size": 2}),
    (lambda: mlp(widths=(7,)), {"axis_size": 2}),
    (conv_bn, {"axis_size": 2}), (graph, {"axis_size": 2}),
    (lambda: mlp(), {"shard_output_layer": True})])
def test_tp_specs_equal_jax(build, kw):
    j, p = pair(build())
    assert tensor.tp_param_specs(p, **kw) == as_tuples(
        jtensor.tp_param_specs(j, **kw))


@pytest.mark.parametrize("n_out,axis,min_elems", [(6, 8, 1024),
                                                  (8, 8, 1024), (8, 4, 16)])
def test_fsdp_specs_equal_jax(n_out, axis, min_elems):
    j, p = pair(mlp(JSgd(0.1), n_in=64, widths=(256,), n_out=n_out))
    assert tensor.fsdp_param_specs(
        p, axis_size=axis, min_shard_elems=min_elems) == as_tuples(
        jtensor.fsdp_param_specs(j, axis_size=axis,
                                 min_shard_elems=min_elems))


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_moe_specs_equal_jax(model_axis):
    j, p = pair(moe())
    got = tensor.moe_param_specs(p, "expert", model_axis=model_axis)
    assert got == as_tuples(jtensor.moe_param_specs(
        j, "expert", model_axis=model_axis))
    assert got["0"]["We1"] == ("expert", None, None)


# --------------------------------------------------- training vs JAX's
def _xy(shape, classes, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def test_tp_training_matches_jax():
    j, p = pair(mlp(JAdam(1e-2), n_in=6, widths=(16,), n_out=2, seed=3))
    x, y = _xy((6,), 2, 32, 2)
    jtensor.ShardedParallelTrainer(j, jmesh(data=1, model=2)).fit(
        x, y, epochs=3, batch_size=32)
    tensor.ShardedParallelTrainer(p, pmesh(data=1, model=2)).fit(
        x, y, epochs=3, batch_size=32)
    assert_params_close(j, p, 1e-4, 1e-5)


def test_dp_x_tp_training_matches_jax_and_learns():
    j, p = pair(mlp())
    x, y = _xy((12,), 4, 128, 1)
    jtensor.ShardedParallelTrainer(j, jmesh(data=4, model=2)).fit(
        x, y, epochs=2, batch_size=64)
    tr = tensor.ShardedParallelTrainer(p, pmesh(data=4, model=2))
    tr.fit(x, y, epochs=2, batch_size=64)
    assert_params_close(j, p, 2e-4, 2e-5)
    np.testing.assert_allclose(p.score_value, float(j.score_value),
                               rtol=1e-5)
    # between steps the shards are the only copy of the sharded leaves:
    # this one process holds every shard, so neither more nor less than
    # the whole model it gives back after the fit
    whole = tr.held_bytes()
    assert [s["held"] for s in tr.between_steps] == [whole] * 4


def test_fsdp_training_matches_jax():
    j, p = pair(mlp(JSgd(0.1), n_in=64, widths=(256, 256), n_out=8, seed=3))
    x, y = _xy((64,), 8, 64, 0)
    jtensor.ShardedParallelTrainer(
        j, jmesh(data=8), param_specs=jtensor.fsdp_param_specs(
            j, axis_size=8)).fit(x, y, epochs=3, batch_size=64)
    tensor.ShardedParallelTrainer(
        p, pmesh(data=8), param_specs=tensor.fsdp_param_specs(
            p, axis_size=8)).fit(x, y, epochs=3, batch_size=64)
    np.testing.assert_allclose(p.score_value, float(j.score_value),
                               rtol=1e-5)
    assert_params_close(j, p, 2e-4, 1e-6)


def test_conv_bn_params_and_running_state_match_jax():
    j, p = pair(conv_bn())
    x, y = _xy((8, 8, 2), 3, 16, 4)
    jtensor.ShardedParallelTrainer(j, jmesh(data=1, model=2)).fit(
        x, y, epochs=2, batch_size=16)
    tensor.ShardedParallelTrainer(p, pmesh(data=1, model=2)).fit(
        x, y, epochs=2, batch_size=16)
    assert_params_close(j, p, 2e-4, 2e-5)
    for lk, st in j.net_state.items():
        for pn, v in st.items():
            np.testing.assert_allclose(p.net_state[lk][pn].numpy(),
                                       np.asarray(v), rtol=2e-4, atol=2e-5)


def test_graph_training_matches_jax():
    j, p = pair(graph())
    x, y = _xy((8, 8, 4), 3, 16, 6)
    assert tensor.tp_param_specs(p, axis_size=2)["out"]["W"] == ()
    jtensor.ShardedParallelTrainer(j, jmesh(data=4, model=2)).fit(
        x, y, epochs=2, batch_size=16)
    tensor.ShardedParallelTrainer(p, pmesh(data=4, model=2)).fit(
        x, y, epochs=2, batch_size=16)
    assert_params_close(j, p, 2e-4, 2e-5)


def test_expert_parallel_training_matches_jax():
    j, p = pair(moe())
    x, y = _xy((8,), 3, 64, 1)
    jtensor.ShardedParallelTrainer(
        j, jmesh(data=2, expert=4),
        param_specs=jtensor.moe_param_specs(j, "expert")).fit(
        x, y, epochs=3, batch_size=64)
    tr = tensor.ShardedParallelTrainer(
        p, pmesh(data=2, expert=4),
        param_specs=tensor.moe_param_specs(p, "expert"))
    seen = []

    class Look(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score, **kw):
            sh = tr._shards[("0", "We1")]
            seen.append((sh.dim, sh.k, len(sh.p), len(sh.state),
                         model.updater_state["0"]["We1"]))

    p.set_listeners(Look())
    tr.fit(x, y, epochs=3, batch_size=64)
    np.testing.assert_allclose(p.score_value, float(j.score_value),
                               rtol=1e-4)
    assert_params_close(j, p, 2e-4, 2e-5)
    # during the fit the expert leaves live in 4 shards and the model
    # keeps no full Adam slots of them; after it the model is whole
    assert seen == [(0, 4, 4, 4, {})] * 3
    assert tr._shards is None
    assert set(p.updater_state["0"]["We1"]) == {"m", "v"}


def test_threshold_under_tp_follows_jax():
    """The threshold exchange over the data axis of a DP x TP mesh: JAX's
    trajectory within its band (0.35 x the initial loss) and the same
    per-bucket τ keys. JAX's own DP x TP threshold program does not
    build on this JAX version (its `shard_map` has no `auto`; the
    reference's failing `test_sharded_dp_tp_threshold`), and a sharding
    never changes its math, so its oracle is the same trainer on the
    4-way data axis alone."""
    j, p = pair(mlp())
    x, y = _xy((12,), 4, 64, 1)
    jt = jtensor.ShardedParallelTrainer(
        j, jmesh(data=4), gradient_sharing="threshold",
        param_specs={lk: {pn: jtensor.P() for pn in lp}
                     for lk, lp in j.params.items()})
    pt = tensor.ShardedParallelTrainer(p, pmesh(data=4, model=2),
                                       gradient_sharing="threshold")
    jl, pl = [], []
    for _ in range(3):
        jt.fit(x, y, epochs=1, batch_size=64)
        pt.fit(x, y, epochs=1, batch_size=64)
        jl.append(float(j.score_value))
        pl.append(float(p.score_value))
    band = 0.35 * jl[0]
    assert max(abs(a - b) for a, b in zip(jl, pl)) <= band, (jl, pl)
    assert set(pt._thr._thr_tau) == set(jt._thr_tau)


def test_evaluate_matches_host_with_a_ragged_tail():
    j, p = pair(mlp(widths=(16,), n_in=8, n_out=3, seed=0))
    x, y = _xy((8,), 3, 67, 0)
    host = Evaluation()
    host.eval(y, p.output(x).numpy())
    ev = tensor.ShardedParallelTrainer(p, pmesh(data=4, model=2)).evaluate(
        x, y, batch_size=16)
    assert ev.total == 67
    np.testing.assert_array_equal(np.asarray(ev.confusion.matrix),
                                  np.asarray(host.confusion.matrix))


def test_resume_continues_bit_for_bit(tmp_path):
    from deeplearning4j_tpu_torch import fault
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ListDataSetIterator)
    x, y = _xy((12,), 4, 64, 2)
    batches = [DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    _, ref = pair(mlp())
    tensor.ShardedParallelTrainer(ref, pmesh(data=2, model=2)).fit(
        ListDataSetIterator(batches))
    _, net = pair(mlp())
    ck = fault.AsyncCheckpointer(tmp_path)
    net.set_listeners(fault.CheckpointListener(ck, frequency=2),
                      fault.PreemptionListener(3, wait_for_checkpointer=ck))
    with pytest.raises(fault.SimulatedPreemption):
        tensor.ShardedParallelTrainer(net, pmesh(data=2, model=2)).fit(
            ListDataSetIterator(batches))
    ck.wait()
    assert fault.checkpoint_meta(tmp_path)["trainer"]["trainer"] == "sharded"
    _, back = pair(mlp())
    t = tensor.ShardedParallelTrainer(back, pmesh(data=2, model=2))
    t.resume(str(tmp_path))
    assert back.iteration_count == 2
    t.fit(ListDataSetIterator(batches[2:]))
    for k, v in ref.param_table().items():
        assert np.array_equal(v.numpy(), back.param_table()[k].numpy()), k


def test_refusals_carry_jax_s_messages(monkeypatch):
    _, p = pair(mlp())
    for mode in ("dense_rs", "threshold_rs"):
        with pytest.raises(NotImplementedError,
                           match="dense_rs/threshold_rs shard the updater"):
            tensor.ShardedParallelTrainer(p, pmesh(data=2, model=2),
                                          gradient_sharing=mode)
    # the env's A/B toggle degrades to what the argument resolves
    monkeypatch.setenv("DL4J_GRADIENT_SHARING", "dense_rs")
    assert tensor.ShardedParallelTrainer(
        p, pmesh(data=2, model=2)).gradient_sharing == "dense"
    monkeypatch.delenv("DL4J_GRADIENT_SHARING")
    g = JGraphConf.graph_builder(JBuilder.builder().seed(1)).add_inputs(
        "a", "b")
    g.add_layer("da", JDense(n_in=4, n_out=4), "a")
    g.add_layer("db", JDense(n_in=4, n_out=4), "b")
    g.add_layer("oa", JOutput(n_in=4, n_out=2), "da")
    g.add_layer("ob", JOutput(n_in=4, n_out=2), "db")
    g.set_outputs("oa", "ob")
    multi = ComputationGraph(ComputationGraphConfiguration.from_json(
        g.build().to_json()), device="cpu").init()
    with pytest.raises(NotImplementedError,
                       match="supports single-input single-output graphs"):
        tensor.ShardedParallelTrainer(multi, pmesh(data=2, model=2))
    from deeplearning4j_tpu_torch.parallel import multihost
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match=r"ShardedParallelTrainer.evaluate\(\) reads"):
        tensor.ShardedParallelTrainer(p, pmesh(data=2, model=2)).evaluate(
            np.zeros((4, 12), np.float32), np.eye(4, dtype=np.float32))
