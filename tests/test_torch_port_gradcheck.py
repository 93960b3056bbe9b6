"""The port's finite-difference gradient checker
(`deeplearning4j_tpu_torch/gradientcheck.py`) against the JAX package's
(`deeplearning4j_tpu/gradientcheck.py`), both float64 on the CPU: the
same nets (the port's configuration JSON, the same seeded params) pass
in both, a wrong gradient fails in both, and the checker never touches
the net it checks."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import gradientcheck as jgc
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JaxConf,
)
from deeplearning4j_tpu.nn.graph import (
    ComputationGraph as JaxGraph,
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel.compat import enable_x64
from deeplearning4j_tpu_torch import gradientcheck as pgc
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _dense():
    conf = (NeuralNetConfiguration.builder().seed(42).l2(1e-2).list()
            .layer(DenseLayer(n_in=4, n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    x = np.random.default_rng(0).standard_normal((6, 4))
    y = np.eye(3)[np.random.default_rng(1).integers(0, 3, 6)]
    return conf, x, y, {}


def _conv():
    conf = (NeuralNetConfiguration.builder().seed(42).list()
            .layer(ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                    stride=(1, 1), activation="tanh"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 2))
            .build())
    x = np.random.default_rng(0).standard_normal((3, 6, 6, 2))
    y = np.eye(2)[np.random.default_rng(1).integers(0, 2, 3)]
    return conf, x, y, {}


def _transformer_block():
    conf = (NeuralNetConfiguration.builder().seed(42).list()
            .layer(TransformerEncoderBlock(n_in=8, n_heads=2, causal=True,
                                           use_flash=False))
            .layer(RnnOutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 8))
    y = np.eye(3)[rng.integers(0, 3, (2, 5))]
    return conf, x, y, dict(max_params_per_array=8)


def _port_grads(net, x, y):
    """The port's float64 autograd gradient of the checked loss, leaf by
    leaf in the checker's (JAX's) order."""
    twin = pgc._float64_twin(net, "cpu")
    xs, ys = twin._features(np.asarray(x)), twin._labels(np.asarray(y))
    pairs = pgc._leaves(pgc._params(twin))
    leaves = [t.detach().clone().requires_grad_(True) for _, t in pairs]
    loss = pgc._net_loss(twin, lambda: twin._loss_fn(xs, ys, train=False))(
        pgc._rebuild([(p, t) for (p, _), t in zip(pairs, leaves)]))
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("make", [_dense, _conv, _transformer_block],
                         ids=["dense", "conv", "transformer_block"])
def test_model_check_agrees_with_jax(make):
    """The port passes; JAX passes on Dense and conv. On the transformer
    block JAX's own check fails: its block's forward does not stay in
    float64 (its `tests/test_transformer_gradcheck.py` asserts the
    returned tuple, which is always true), so its central differences
    are off while its autodiff is right. There the port's gradient is
    held to JAX's analytic values at every coordinate JAX reports: the
    same coordinates, the same gradient."""
    conf, x, y, kw = make()
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = {k: t.clone() for k, t in net.param_table().items()}
    ok, worst, failures = pgc.check_model_gradients(net, x, y, device="cpu",
                                                    **kw)
    assert ok, (worst, failures[:3])
    assert worst < 1e-5
    assert all(torch.equal(t, before[k])
               for k, t in net.param_table().items())
    assert next(iter(net.param_table().values())).dtype == torch.float32
    jnet = JaxNet(JaxConf.from_json(conf.to_json())).init()
    jok, _, jfailures = jgc.check_model_gradients(jnet, x, y, **kw)
    if make is not _transformer_block:
        assert jok
        return
    assert not jok and jfailures
    grads = _port_grads(net, x, y)
    for ti, idx, analytic, _, _ in jfailures:
        # JAX's autodiff carries the fp32 rounding of its forward
        # (measured at most 1.5e-8 apart)
        np.testing.assert_allclose(grads[ti][idx], analytic, rtol=1e-5,
                                   atol=1e-7)


def test_graph_check_agrees_with_jax():
    gb = (ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder().seed(5)).add_inputs("in"))
    gb.add_layer("d", DenseLayer(n_in=4, n_out=5, activation="sigmoid"),
                 "in")
    gb.add_layer("out", OutputLayer(n_in=5, n_out=3, activation="identity",
                                    loss="mse"), "d")
    conf = gb.set_outputs("out").build()
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((5, 4)), rng.standard_normal((5, 3))
    ok, worst, failures = pgc.check_graph_gradients(
        ComputationGraph(conf, device="cpu").init(), x, y, device="cpu")
    jok, _, _ = jgc.check_graph_gradients(
        JaxGraph(JaxGraphConf.from_json(conf.to_json())).init(), x, y)
    assert ok and jok, (worst, failures[:3])


def test_a_wrong_gradient_fails_in_both():
    """d/dw sum(w^3) is 3 w^2; a backward that returns 2 w^2 is caught at
    the same sampled coordinates in both packages."""
    w = np.random.default_rng(3).standard_normal((4, 3))

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return (a ** 3).sum()

        @staticmethod
        def backward(ctx, g):
            (a,) = ctx.saved_tensors
            return g * 2 * a ** 2

    ok, _, failures = pgc.check_gradients_fn(lambda p: Wrong.apply(p["w"]),
                                             {"w": w}, device="cpu")
    import jax

    @jax.custom_vjp
    def cube_sum(a):
        return jnp.sum(a ** 3)

    cube_sum.defvjp(lambda a: (cube_sum(a), a),
                    lambda a, g: (g * 2 * a ** 2,))
    with enable_x64(True):
        jok, _, jfailures = jgc.check_gradients_fn(
            lambda p: cube_sum(p["w"]), {"w": jnp.asarray(w)})
    assert not ok and not jok
    assert [f[1] for f in failures] == [f[1] for f in jfailures]


@pytest.mark.parametrize("fn", ["check_gradients_fn", "check_model_gradients",
                                "check_graph_gradients"])
def test_the_checker_runs_on_the_card_unless_asked(fn):
    """Like every entry point of the port, the checker's default device
    is the card; the CPU is the caller's choice."""
    import inspect
    assert inspect.signature(
        getattr(pgc, fn)).parameters["device"].default == "cuda"
