"""The port's input preprocessors against the JAX package's, on the CPU:
each of the six adapters' `pre_process` and `process_mask` (bit-equal:
they are reshapes and transposes), `CnnToFeedForward` in both
`data_format`s, the containers threading the mask through a
preprocessor (a masked [B, T, F] batch through `RnnToFeedForward`, a
dense layer, `FeedForwardToRnn` and an `RnnOutputLayer`: the mask is
folded to [B*T] and back, and the output layer's own preprocessor runs
in the loss), a `MultiLayerNetwork` whose builder inserts
`CnnToFeedForward` itself, and a graph with a `PreprocessorVertex`.

Tolerances: the adapters bit-equal; losses, outputs and gradients of
the small nets within ATOL = 1e-5 of JAX's, relative to the largest
|value| of the reference (XLA:CPU and PyTorch sum in another order).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder,
)
from deeplearning4j_tpu.nn.conf.graph import (
    PreprocessorVertex as JaxPreprocessorVertex,
)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppp
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)

ATOL = 1e-5
B, T, F, H, W, C = 3, 5, 6, 4, 3, 2


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol=ATOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} (tol {tol})"


# (JAX preprocessor, input shape, mask shape or None)
CASES = {
    "cnn_to_ff_nchw": (jpp.CnnToFeedForwardPreProcessor(H, W, C), (B, H, W, C),
                       None),
    "cnn_to_ff_nhwc": (jpp.CnnToFeedForwardPreProcessor(H, W, C, "nhwc"),
                       (B, H, W, C), None),
    "ff_to_cnn": (jpp.FeedForwardToCnnPreProcessor(H, W, C), (B, H * W * C),
                  None),
    "rnn_to_ff": (jpp.RnnToFeedForwardPreProcessor(), (B, T, F), (B, T)),
    "ff_to_rnn": (jpp.FeedForwardToRnnPreProcessor(T), (B * T, F), (B * T,)),
    "cnn_to_rnn": (jpp.CnnToRnnPreProcessor(H, W, C), (B, H, W, C), None),
    "rnn_to_cnn": (jpp.RnnToCnnPreProcessor(H, W, C), (B, T, H * W * C),
                   (B, T)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocessor_matches_jax_bit_for_bit(case):
    """pre_process and process_mask of the port's preprocessor, built
    from the JAX one's dict (which it writes back), equal JAX's; the
    output type too. A mask of None stays None."""
    jp, shape, mshape = CASES[case]
    pp = ppp.preprocessor_from_dict(jp.to_dict())
    assert pp.to_dict() == jp.to_dict()
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    got = pp.pre_process(torch.from_numpy(x)).numpy()
    want = np.asarray(jp.pre_process(jnp.asarray(x)))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert pp.process_mask(None) is None
    if mshape is not None:
        m = (rng.random(mshape) < 0.6).astype(np.float32)
        gm = pp.process_mask(torch.from_numpy(m)).numpy()
        assert np.array_equal(gm, np.asarray(jp.process_mask(jnp.asarray(m))))
    else:
        m = torch.ones(B)
        assert pp.process_mask(m) is m
    if case.startswith(("cnn", "rnn_to_cnn")):
        it = JaxInputType.convolutional(H, W, C) if case.startswith("cnn") \
            else JaxInputType.recurrent(H * W * C, T)
    elif case == "ff_to_cnn":
        it = JaxInputType.feed_forward(H * W * C)
    else:
        it = (JaxInputType.recurrent(F, T) if case == "rnn_to_ff"
              else JaxInputType.feed_forward(F))
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    assert pp.get_output_type(InputType.from_dict(it.to_dict())).to_dict() \
        == jp.get_output_type(it).to_dict()


def test_cnn_to_ff_flattens_channel_major():
    """The default order is NCHW's (the reference's): feature c*H*W +
    h*W + w of the flat vector is channel c at (h, w); "nhwc" keeps the
    NHWC order."""
    x = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H, W, C)
    flat = ppp.CnnToFeedForwardPreProcessor(H, W, C).pre_process(x)
    c, h, w = 1, 2, 1
    assert flat[0, c * H * W + h * W + w] == x[0, h, w, c]
    nhwc = ppp.CnnToFeedForwardPreProcessor(H, W, C, "nhwc").pre_process(x)
    assert nhwc[0, (h * W + w) * C + c] == x[0, h, w, c]


# ------------------------------------------- masks through the containers
def _sequence_net(updater, folded=False):
    """RnnToFeedForward -> Dense -> FeedForwardToRnn -> RnnOutputLayer,
    or with `folded` RnnToFeedForward -> Dense -> OutputLayer (the loss
    on the [B*T] rows, under the folded mask): the JAX configuration."""
    b = (JaxBuilder.builder().seed(7).updater(updater).list()
         .layer(jff.DenseLayer(n_in=F, n_out=8, activation="tanh"))
         .input_preprocessor(0, jpp.RnnToFeedForwardPreProcessor()))
    if folded:
        return b.layer(jff.OutputLayer(n_in=8, n_out=4)).build()
    return (b.layer(jrec.RnnOutputLayer(n_in=8, n_out=4,
                                        activation="softmax",
                                        loss="mcxent"))
            .input_preprocessor(1, jpp.FeedForwardToRnnPreProcessor(T))
            .build())


def _sequence_batch(seed, folded=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, T))]
    lengths = np.array([T, 2, 0])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return x, y.reshape(B * T, 4) if folded else y, mask


def _jax_loss_and_grads(jnet, x, y, fmask):
    def loss(p):
        return jnet._loss_fn(p, jnet.net_state, jnp.asarray(x),
                             jnp.asarray(y), None, jnp.asarray(fmask), None,
                             train=False)[0]
    value, grads = jax.value_and_grad(loss)(jnet.params)
    return float(value), to_numpy_params(grads)


def _port_loss_and_grads(net, x, y, fmask):
    xt, yt, mt = (torch.from_numpy(a) for a in (x, y, fmask))
    loss, grads, _ = net._loss_and_grads(
        lambda st: net._loss_fn(xt, yt, mt, None, new_state=st))
    return float(loss), {
        key: {n: grads[id(t)].numpy()
              for n, t in layer.jax_param_map().items()}
        for key, layer in net.keyed() if layer.jax_param_map()}


@pytest.mark.parametrize("folded", [False, True],
                         ids=["round_trip", "folded"])
def test_masked_sequence_through_rnn_to_ff_and_back_matches_jax(folded):
    """The features mask [B, T] is folded to [B*T] by RnnToFeedForward
    and carried by the dense layer; the round trip unfolds it to [B, T]
    by the output layer's FeedForwardToRnn, which the loss applies, and
    the folded net's OutputLayer takes it as [B*T] row weights: loss and
    every gradient as JAX's (the third row is all padding, the second
    half of it)."""
    from deeplearning4j_tpu_torch.nn import layers as pl
    jconf = _sequence_net(JaxSgd(0.1), folded)
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    assert net.conf.to_dict() == jconf.to_dict()
    assert isinstance(net.layers[1], pl.OutputLayer if folded
                      else pl.RnnOutputLayer)
    x, y, mask = _sequence_batch(3, folded)
    jloss, jgrads = _jax_loss_and_grads(jnet, x, y, mask)
    loss, grads = _port_loss_and_grads(net, x, y, mask)
    np.testing.assert_allclose(loss, jloss, rtol=ATOL)
    for key, lg in jgrads.items():
        for name, g in lg.items():
            _close(grads[key][name], g, what=f"grad {key}/{name}")
    out = net.output(x, mask=mask).numpy()
    _close(out, np.asarray(jnet.output(x, mask=mask)), what="output")
    # the mask acts: unmasked, the loss moves
    unmasked, _ = _port_loss_and_grads(net, x, y, np.ones_like(mask))
    assert abs(unmasked - loss) > 1e-3


def test_masked_sequence_fit_matches_jax():
    """Two Sgd steps with the features mask from a DataSet: losses and
    params as JAX's."""
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet
    jconf = _sequence_net(JaxSgd(0.5))
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    for seed in (4, 5):
        x, y, mask = _sequence_batch(seed)
        jnet.fit(JaxDataSet(x, y, mask), batch_size=B)
        net.fit(DataSet(x, y, mask), batch_size=B)
        np.testing.assert_allclose(net.score_value, jnet.score_value,
                                   rtol=ATOL)
    got = {k: {n: t.detach().numpy() for n, t in layer.jax_param_map().items()}
           for k, layer in net.keyed() if layer.jax_param_map()}
    for key, lp in to_numpy_params(jnet.params).items():
        for name, w in lp.items():
            _close(got[key][name], w, what=f"{key}/{name}")


# ------------------------------------------ the builder inserts cnn_to_ff
def _small_cnn(l):
    return (JaxBuilder.builder().seed(11).updater(JaxSgd(0.1))
            .weight_init("xavier").list()
            .layer(l.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation="relu"))
            .layer(l.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(l.DenseLayer(n_out=7, activation="relu"))
            .layer(l.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(9, 8, 2))
            .build())


def test_builder_inserted_cnn_to_ff_matches_jax():
    """The JAX builder puts CnnToFeedForward (NCHW) before the dense
    layer; the port builds that configuration, and its output, loss and
    gradients (the dense W's rows in channel-major order) are JAX's."""
    from deeplearning4j_tpu.nn import layers as jl
    jconf = _small_cnn(jl)
    assert isinstance(jconf.input_preprocessors[2],
                      jpp.CnnToFeedForwardPreProcessor)
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu")
    assert isinstance(net.conf.input_preprocessors[2],
                      ppp.CnnToFeedForwardPreProcessor)
    from_jax_params(net, to_numpy_params(jnet.params))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 9, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    _close(net.output(x).numpy(), np.asarray(jnet.output(x)), what="output")
    ones = np.ones(4, np.float32)
    jloss, jgrads = _jax_loss_and_grads(jnet, x, y, ones)
    loss, grads = _port_loss_and_grads(net, x, y, ones)
    np.testing.assert_allclose(loss, jloss, rtol=ATOL)
    for key, lg in jgrads.items():
        for name, g in lg.items():
            _close(grads[key][name], g, what=f"grad {key}/{name}")


def test_port_builder_inserts_the_jax_preprocessor():
    """The port's own builder makes the JAX configuration, preprocessor
    included."""
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu_torch.common.updaters import Sgd
    from deeplearning4j_tpu_torch.nn import layers as pl
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    conf = (NeuralNetConfiguration.builder().seed(11)
            .updater(Sgd(0.1))
            .weight_init("xavier").list()
            .layer(pl.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       activation="relu"))
            .layer(pl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(pl.DenseLayer(n_out=7, activation="relu"))
            .layer(pl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.convolutional(9, 8, 2))
            .build())
    assert conf.to_dict() == _small_cnn(jl).to_dict()


# --------------------------------------------- a graph's PreprocessorVertex
def test_graph_with_a_preprocessor_vertex_matches_jax():
    """input (NHWC) -> conv -> PreprocessorVertex(CnnToFeedForward) ->
    dense -> output: output, loss and gradients as JAX's."""
    g = JaxGraphConf.graph_builder(
        JaxBuilder.builder().seed(5).updater(JaxSgd(0.1))
        .weight_init("xavier"))
    g.add_inputs("in")
    g.set_input_types(JaxInputType.convolutional(6, 5, 2))
    g.add_layer("conv", jconv.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                               activation="tanh"), "in")
    g.add_vertex("flat", JaxPreprocessorVertex(
        jpp.CnnToFeedForwardPreProcessor(4, 3, 3)), "conv")
    g.add_layer("dense", jff.DenseLayer(n_in=36, n_out=5,
                                        activation="relu"), "flat")
    g.add_layer("out", jff.OutputLayer(n_in=5, n_out=3), "dense")
    g.set_outputs("out")
    jconf = g.build()
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_dict(
        jconf.to_dict()), device="cpu")
    assert net.conf.to_dict() == jconf.to_dict()
    from_jax_params(net, to_numpy_params(jnet.params))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, 5, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    _close(net.output(x).numpy(), np.asarray(jnet.output(x)), what="output")
    acts = net.feed_forward(x)
    _close(acts["flat"].numpy(),
           np.asarray(jnp.transpose(jnp.asarray(acts["conv"].numpy()),
                                    (0, 3, 1, 2)).reshape(4, -1)),
           what="flat")

    def jloss(p):
        return jnet._loss_fn(p, jnet.net_state, [jnp.asarray(x)],
                             [jnp.asarray(y)], None, None, None,
                             train=False)[0]
    jl_value, jgrads = jax.value_and_grad(jloss)(jnet.params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss, grads, _ = net._loss_and_grads(
        lambda st: net._loss_fn([xt], [yt], new_state=st))
    np.testing.assert_allclose(float(loss), float(jl_value), rtol=ATOL)
    for key, lg in to_numpy_params(jgrads).items():
        layer = dict(net.keyed())[key]
        for name, gr in lg.items():
            _close(grads[id(layer.jax_param_map()[name])].numpy(), gr,
                   what=f"grad {key}/{name}")


def test_rnn_to_cnn_in_a_sequence_net_matches_jax():
    """A [B, T, C*H*W] sequence through RnnToCnn (time into the batch), a
    convolution, CnnToRnn and an RnnOutputLayer, as JAX's output."""
    jconf = (JaxBuilder.builder().seed(9).updater(JaxSgd(0.1)).list()
             .layer(jconv.ConvolutionLayer(n_in=C, n_out=3,
                                           kernel_size=(2, 2),
                                           activation="tanh"))
             .layer(jrec.RnnOutputLayer(n_in=3 * (H - 1) * (W - 1), n_out=4,
                                     activation="softmax", loss="mcxent"))
             .input_preprocessor(0, jpp.RnnToCnnPreProcessor(H, W, C))
             .input_preprocessor(1, jpp.CnnToRnnPreProcessor(H - 1, W - 1,
                                                             3))
             .build())
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        jconf.to_dict()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    x = np.random.default_rng(10).standard_normal(
        (B, T, H * W * C)).astype(np.float32)
    got = net.output(x).numpy()
    want = np.asarray(jnet.output(x))
    assert got.shape == want.shape == (B * T, 1, 4)
    _close(got, want, what="output")
