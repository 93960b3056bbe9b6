"""GPipe pipeline parallelism (`deeplearning4j_tpu_torch/parallel/
pipeline.py`, `pipeline_container.py`) against the JAX package's:
`find_homogeneous_run` on the zoo TransformerLM; the schedule against
the sequential blocks (and JAX's `pipeline_forward`); one SGD step of
`PipelineParallelTrainer` against JAX's PP params at JAX's rtol 2e-4 /
atol 1e-6 and against the port's own container; dp x pp; every
validation message; and `evaluate`'s padded tail (to the microbatch
grid, and to microbatches x the data axis)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import pipeline as jpipeline
from deeplearning4j_tpu.parallel import pipeline_container as jpc
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JLM
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.parallel import pipeline
from deeplearning4j_tpu_torch.parallel.pipeline_container import (
    PipelineParallelTrainer,
    find_homogeneous_run,
)


def lm_conf(sgd=None, n_layers=4):
    conf = JLM(vocab_size=12, d_model=16, n_layers=n_layers, n_heads=4,
               max_len=8, seed=3).conf()
    if sgd is not None:
        for layer in conf.layers:
            layer.updater = JSgd(sgd)
    return conf


def pair(conf):
    return (JNet(conf).init(),
            MultiLayerNetwork(MultiLayerConfiguration.from_json(
                conf.to_json()), device="cpu").init())


def lm_data(B=8, T=8, V=12, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, T)).astype(np.float32)
    return ids, np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]


def pmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshSpec.of(**axes), devices=["cpu"] * n)


def jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(
        tuple(axes.values())), tuple(axes))


def assert_params_close(jnet, net, rtol, atol):
    got = net.param_table()
    for lk, lp in jnet.params.items():
        for pn, w in lp.items():
            np.testing.assert_allclose(got[f"{lk}_{pn}"].numpy(),
                                       np.asarray(w), rtol=rtol, atol=atol,
                                       err_msg=f"{lk}:{pn}")


def test_find_homogeneous_run_on_transformer_lm():
    j, p = pair(lm_conf())
    assert find_homogeneous_run(p) == jpc.find_homogeneous_run(j) == (2, 6)


@pytest.mark.parametrize("S", [2, 4])
def test_schedule_matches_sequential_and_jax(S):
    F = 6
    rng = np.random.default_rng(0)
    W = rng.standard_normal((S, F, F)).astype(np.float32) * 0.3
    b = rng.standard_normal((S, F)).astype(np.float32) * 0.1
    x = rng.standard_normal((8, F)).astype(np.float32)

    def block(p, h):
        return torch.tanh(h @ p["W"] + p["b"])
    params = {"W": torch.from_numpy(W).requires_grad_(),
              "b": torch.from_numpy(b)}
    got = pipeline.pipeline_forward(block, params, torch.from_numpy(x),
                                    pmesh(pipe=S), microbatches=4)
    want = torch.from_numpy(x)
    for s in range(S):
        want = block({"W": params["W"][s], "b": params["b"][s]}, want)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jgot = jpipeline.pipeline_forward(
        lambda p, h: jnp.tanh(h @ p["W"] + p["b"]),
        {"W": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(x),
        jmake_mesh(JMeshSpec.of(pipe=S)), microbatches=4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jgot),
                               rtol=1e-5, atol=1e-6)
    got.sum().backward()              # autograd through the stage hops
    assert params["W"].grad is not None
    assert pipeline.bubble_share(S, 4) == (S - 1) / (4 + S - 1)


def test_sgd_step_matches_jax_and_the_container():
    ids, y = lm_data()
    j, p = pair(lm_conf(sgd=0.05))
    _, single = pair(lm_conf(sgd=0.05))
    jpc.PipelineParallelTrainer(j, jmake_mesh(JMeshSpec.of(pipe=4)),
                                microbatches=4).fit(ids, y, epochs=1,
                                                    batch_size=8)
    tr = PipelineParallelTrainer(p, pmesh(pipe=4), microbatches=4)
    tr.fit(ids, y, epochs=1, batch_size=8)
    single.fit(ids, y, epochs=1, batch_size=8)
    np.testing.assert_allclose(p.score_value, float(j.score_value),
                               rtol=1e-5)
    assert_params_close(j, p, 2e-4, 1e-6)
    np.testing.assert_allclose(p.score_value, single.score_value, rtol=1e-6)
    for k, v in single.param_table().items():
        torch.testing.assert_close(p.param_table()[k], v, rtol=1e-6,
                                   atol=1e-7)
    assert tr.bubble_share() == 3 / 7


def test_dp_x_pp_matches_jax():
    ids, y = lm_data()
    j, p = pair(lm_conf(sgd=0.05))
    jpc.PipelineParallelTrainer(j, jmesh(data=2, pipe=2), data_axis="data",
                                microbatches=2).fit(ids, y, epochs=1,
                                                    batch_size=8)
    PipelineParallelTrainer(p, pmesh(data=2, pipe=2), data_axis="data",
                            microbatches=2).fit(ids, y, epochs=1,
                                                batch_size=8)
    assert_params_close(j, p, 2e-4, 1e-6)


def _mlp_with(**kw):
    b = JBuilder.builder().seed(1).updater(JSgd(0.1)).list()
    for _ in range(4):
        b = b.layer(JDense(n_in=8, n_out=8, activation="tanh", **kw))
    conf = (b.layer(JOutput(n_in=8, n_out=3))
            .set_input_type(JInputType.feed_forward(8)).build())
    return pair(conf)


def test_validation_messages_are_jax_s():
    _, p = pair(lm_conf())
    with pytest.raises(ValueError, match="fewer than 8 pipeline stages"):
        PipelineParallelTrainer(p, pmesh(pipe=8))
    with pytest.raises(ValueError, match="does not divide into 3 stages"):
        PipelineParallelTrainer(p, pmesh(pipe=3))
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        PipelineParallelTrainer(p, pmesh(pipe=2), microbatches=0)
    with pytest.raises(ValueError, match="data_axis 'data' is not a mesh"):
        PipelineParallelTrainer(p, pmesh(pipe=2), data_axis="data")
    _, drop = _mlp_with(dropout=0.9)
    with pytest.raises(ValueError, match="uses dropout/weight noise"):
        PipelineParallelTrainer(drop, pmesh(pipe=2))
    tr = PipelineParallelTrainer(p, pmesh(pipe=2), microbatches=4)
    ids, y = lm_data(B=6)
    with pytest.raises(ValueError, match="does not divide into "
                                         "microbatches=4"):
        tr.fit(ids, y, batch_size=6)
    ids, y = lm_data(B=10)
    with pytest.raises(ValueError, match="fit batch of 2 examples"):
        tr.fit(ids, y, batch_size=8)         # the ragged tail
    dp = PipelineParallelTrainer(p, pmesh(data=2, pipe=2), data_axis="data",
                                 microbatches=2)
    with pytest.raises(ValueError, match="per-microbatch size 1 does not "
                                         "divide over the 2-way 'data'"):
        dp.fit(*lm_data(B=2), batch_size=2)


def test_stateful_layers_and_preprocessors_inside_the_run_are_refused():
    from deeplearning4j_tpu.nn.layers import BatchNormalization as JBN
    b = JBuilder.builder().seed(1).updater(JSgd(0.1)).list()
    for _ in range(4):
        b = b.layer(JBN(n_out=8))
    conf = (b.layer(JOutput(n_in=8, n_out=3))
            .set_input_type(JInputType.feed_forward(8)).build())
    _, p = pair(conf)
    with pytest.raises(ValueError, match="is stateful"):
        PipelineParallelTrainer(p, pmesh(pipe=2))
    _, q = _mlp_with()
    q.conf.input_preprocessors[2] = object()
    with pytest.raises(ValueError, match="input preprocessor at layer 2"):
        PipelineParallelTrainer(q, pmesh(pipe=2), run=(0, 4))
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = ComputationGraph.__new__(ComputationGraph)
    with pytest.raises(NotImplementedError, match="stages MultiLayerNetwork"):
        PipelineParallelTrainer(g, pmesh(pipe=2))


def test_evaluate_pads_the_tail_to_the_microbatch_grid():
    j, p = pair(lm_conf())
    ids, y = lm_data(B=10)
    ev = PipelineParallelTrainer(p, pmesh(pipe=4), microbatches=4).evaluate(
        ids, y, batch_size=10)
    host = Evaluation()
    host.eval(y, p.output(ids).numpy())
    assert ev.total == host.total == 80
    np.testing.assert_allclose(ev.accuracy(), host.accuracy())
    jev = jpc.PipelineParallelTrainer(j, jmesh(pipe=4),
                                      microbatches=4).evaluate(
        ids, y, batch_size=10)
    np.testing.assert_allclose(ev.accuracy(), jev.accuracy())


def test_evaluate_pads_the_tail_to_the_data_axis_multiple():
    _, p = pair(lm_conf())
    ids, y = lm_data(B=10)
    tr = PipelineParallelTrainer(p, pmesh(data=2, pipe=4), data_axis="data",
                                 microbatches=2)
    assert tr._batch_multiple() == 4
    ev = tr.evaluate(ids, y, batch_size=8)
    host = Evaluation()
    host.eval(y, p.output(ids).numpy())
    assert ev.total == host.total == 80
    np.testing.assert_allclose(ev.accuracy(), host.accuracy())
