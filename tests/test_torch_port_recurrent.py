"""The recurrent family held to the JAX package's (`nn/layers/
recurrent.py`): LSTM, GravesLSTM, GravesBidirectionalLSTM, SimpleRnn and
LastTimeStep forward and gradients against `jax.grad`, truncated BPTT on
both containers, `rnn_time_step`, and TextGenerationLSTM with the
committed char-LM.

Tolerances: fp32 forward and gradients within ATOL of each tensor's
largest value (1e-5); under mixed_bf16 the forward within MIXED_BAND
(4 bf16 ulps) and the gradients within MIXED_GRAD_BAND (8 ulps) of it:
bf16 products over the time loop, and each param's gradient summed over
the T = 9 steps in bf16, each side in its own order; TBPTT `fit` losses within LOSS_RTOL and params within
PARAM_RTOL (relative Frobenius) of JAX's after 3 iterations, both nets
from `init(seed)` with no weights loaded (under mixed_bf16 the losses
within MIXED_LOSS_RTOL); `rnn_time_step` within ATOL of
`output()`; the restored char-LM's `output()` within ATOL of JAX's.
Small widths throughout; everything on the CPU.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers as jl
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.conf.builder import BackpropType as JaxBPT
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import (
    TrainingListener as JaxListener,
)
from deeplearning4j_tpu.util.serializer import ModelSerializer as JaxZip
from deeplearning4j_tpu.zoo.base import PretrainedType as JaxPT
from deeplearning4j_tpu.zoo.textgenlstm import TextGenerationLSTM as JaxTG
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.jax_params import to_numpy_params
from deeplearning4j_tpu_torch.zoo import PretrainedType, TextGenerationLSTM

ATOL = 1e-5
MIXED_BAND = 2.0 ** -5
MIXED_GRAD_BAND = 2.0 ** -4
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5
MIXED_LOSS_RTOL = 1e-2
B, T, F = 3, 9, 5


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _mask(seed):
    lens = np.random.default_rng(seed).integers(1, T + 1, B)
    lens[0] = T
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _carry(jlayer, seed):
    """A non-zero carry of the JAX layer's structure."""
    c = jlayer.init_carry(B, jnp.float32)
    leaves, tree = jax.tree_util.tree_flatten(c)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(rng.normal(0, 0.5, l.shape).astype(np.float32))
               for l in leaves])


def _to_torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype), tree)


LAYERS = {
    "lstm": lambda: jl.LSTM(n_in=F, n_out=6, forget_gate_bias_init=0.5),
    "graves_lstm": lambda: jl.GravesLSTM(n_in=F, n_out=6,
                                         gate_activation="hardsigmoid"),
    "graves_bidirectional_lstm": lambda: jl.GravesBidirectionalLSTM(
        n_in=F, n_out=4),
    "simple_rnn": lambda: jl.SimpleRnn(n_in=F, n_out=7, bias_init=0.1),
}


def _run_pair(name, masked, with_carry, mixed):
    """Forward and the gradient of sum(y * r) (plus the final carry's
    sum) in x and every param, JAX against the port."""
    jlay = LAYERS[name]()
    pl = layer_from_dict(jlay.to_dict())
    assert pl.to_dict() == jlay.to_dict()
    params = jlay.init_params(jax.random.PRNGKey(3))
    pl.init_weights((0, 3))
    for k, t in pl.jax_param_map().items():      # init is JAX's too
        _close(t.detach().numpy(), params[k], ATOL, f"init {k}")
    # a non-trivial peephole and bias so their gradients matter
    rng = np.random.default_rng(5)
    params = {k: v + jnp.asarray(rng.normal(0, 0.2, v.shape), v.dtype)
              for k, v in params.items()}
    pl.load_jax_params({k: np.asarray(v) for k, v in params.items()})
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    r = rng.standard_normal((B, T, pl.n_out)).astype(np.float32)
    mask = _mask(7) if masked else None
    carry = _carry(jlay, 9) if with_carry else jlay.init_carry(B)
    jdt = jnp.bfloat16 if mixed else jnp.float32
    tdt = torch.bfloat16 if mixed else torch.float32

    def jf(p, xx, c):
        p = {k: v.astype(jdt) for k, v in p.items()}
        c = jax.tree_util.tree_map(lambda a: a.astype(jdt), c)
        y, _, fc = jlay.forward_with_carry(
            p, {}, xx.astype(jdt), c,
            mask=None if mask is None else jnp.asarray(mask))
        s = jnp.sum(y.astype(jnp.float32) * r)
        return s + sum(jnp.sum(l.astype(jnp.float32))
                       for l in jax.tree_util.tree_leaves(fc)), y
    (_, y0), (gp, gx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x), carry)

    copies = {n: p.detach().to(tdt).requires_grad_(True)
              for n, p in pl.named_parameters()}
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ct = _to_torch(carry, tdt)

    y, fc = torch.func.functional_call(
        _Carry(pl), {f"layer.{n}": t for n, t in copies.items()},
        (xt, ct, None if mask is None else torch.from_numpy(mask)))
    s = (y.float() * torch.from_numpy(r)).sum() + sum(
        l.float().sum() for l in jax.tree_util.tree_leaves(fc))
    s.backward()
    by_name = dict(pl.named_parameters())
    got = {"x": xt.grad}
    for k, t in pl.jax_param_map().items():
        n = next(n for n, p in by_name.items() if p is t)
        got[k] = copies[n].grad
    return (y.detach().float().numpy(),
            {k: v.float().numpy() for k, v in got.items()},
            np.asarray(y0.astype(jnp.float32)),
            {"x": np.asarray(gx.astype(jnp.float32)),
             **{k: np.asarray(v.astype(jnp.float32))
                for k, v in gp.items()}})


class _Carry(torch.nn.Module):
    """`forward_with_carry` as a module call, so `functional_call` can
    swap the layer's params for the mixed step's bf16 copies."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x, carry, mask):
        return self.layer.forward_with_carry(x, carry, mask)


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
@pytest.mark.parametrize("with_carry", [False, True], ids=["fresh", "carry"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name, masked, with_carry,
                                               mixed):
    y, g, y0, g0 = _run_pair(name, masked, with_carry, mixed)
    _close(y, y0, MIXED_BAND if mixed else ATOL, "forward")
    assert set(g) == set(g0)
    for k in g0:
        _close(g[k], g0[k], MIXED_GRAD_BAND if mixed else ATOL, f"grad {k}")


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    x = np.random.default_rng(2).standard_normal((B, T, F)).astype(
        np.float32)
    mask = _mask(4) if masked else None
    if masked:
        mask[1] = 0                               # an all-masked row
    jlay = jl.LastTimeStep()
    want, _ = jlay.forward({}, {}, jnp.asarray(x),
                           mask=None if mask is None else jnp.asarray(mask))
    pl = layer_from_dict(jlay.to_dict())
    got = pl(torch.from_numpy(x),
             mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pl.forward_mask(mask) is None


# ------------------------------------------------------------ containers
class _JLosses(JaxListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **kw):
        self.scores.append(score)


class _PLosses(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **kw):
        self.scores.append(score)


def _rel(got, want):
    n = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (n if n > 0 else 1.0)


def _assert_trained_alike(jnet, jl_, net, pl_):
    np.testing.assert_allclose(pl_, jl_, rtol=LOSS_RTOL)
    want = to_numpy_params(jnet.params)
    for key, layer in net.keyed():
        for name, t in layer.jax_param_map().items():
            assert _rel(t.numpy(), want[key][name]) <= PARAM_RTOL, (key,
                                                                    name)


def _char_data(V, n, steps, seed):
    ids = np.random.default_rng(seed).integers(0, V, (n, steps + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def test_textgen_conf_and_tbptt_fit_match_jax():
    """TextGenerationLSTM's configuration is JAX's, `init(seed)` its
    weights, and 3 TBPTT iterations (T 12, chunks of 5: three chunks, the
    last ragged) follow JAX's, from `init` alone."""
    V = 11
    jm = JaxTG(vocab_size=V, hidden=8, tbptt_length=5)
    pm = TextGenerationLSTM(vocab_size=V, hidden=8, tbptt_length=5)
    assert pm.conf().to_dict() == jm.conf().to_dict()
    assert pm.conf().to_json() == jm.conf().to_json()
    jnet, net = jm.init(), pm.init(device="cpu")
    x, y = _char_data(V, 3, 12, 1)
    jr, pr = _JLosses(), _PLosses()
    jnet.set_listeners(jr)
    net.set_listeners(pr)
    for _ in range(3):
        jnet.fit(x, y, batch_size=3)
        net.fit(x, y, batch_size=3, shuffle=False)
    assert net.iteration_count == 3
    _assert_trained_alike(jnet, jr.scores, net, pr.scores)


def test_mixed_tbptt_carries_bf16_and_tracks_jax():
    """Under mixed_bf16 the carries start in bf16 (the compute dtype), and
    3 TBPTT iterations stay within the mixed band of JAX's mixed run
    (MIXED_LOSS_RTOL, the JAX package's 1e-2 step-0 gate)."""
    V = 11
    jnet = JaxNet(JaxTG(vocab_size=V, hidden=8, tbptt_length=5).conf(),
                  dtype_policy="mixed_bf16").init(123)
    net = TextGenerationLSTM(vocab_size=V, hidden=8, tbptt_length=5).init(
        device="cpu", dtype_policy="mixed_bf16")
    assert all(t.dtype == torch.bfloat16
               for c in net.init_carries(2).values() for t in c)
    x, y = _char_data(V, 3, 12, 2)
    jr, pr = _JLosses(), _PLosses()
    jnet.set_listeners(jr)
    net.set_listeners(pr)
    for _ in range(3):
        jnet.fit(x, y, batch_size=3)
        net.fit(x, y, batch_size=3, shuffle=False)
    np.testing.assert_allclose(pr.scores, jr.scores, rtol=MIXED_LOSS_RTOL)


def _graph_conf(tbptt, mixed=False):
    b = JaxBuilder.builder().seed(4).updater(
        __import__("deeplearning4j_tpu.common.updaters",
                   fromlist=["Adam"]).Adam(1e-2))
    if mixed:
        b = b.dtype_policy("mixed_bf16")
    g = (JaxGraphConf.graph_builder(b).add_inputs("in")
         .set_input_types(JaxInputType.recurrent(F))
         .add_layer("lstm", jl.LSTM(n_out=6), "in")
         .add_layer("rnn", jl.SimpleRnn(n_out=5), "in")
         .add_vertex("cat", __import__(
             "deeplearning4j_tpu.nn.conf.graph",
             fromlist=["MergeVertex"]).MergeVertex(), "lstm", "rnn")
         .add_layer("out", jl.RnnOutputLayer(n_out=4, activation="softmax"),
                    "cat")
         .set_outputs("out"))
    if tbptt:
        g = g.backprop_type(JaxBPT.TRUNCATED_BPTT, 4)
    return g.build()


def test_graph_tbptt_fit_matches_jax():
    jconf = _graph_conf(tbptt=True)
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 10, F)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, 10))]
    jr, pr = _JLosses(), _PLosses()
    jnet.set_listeners(jr)
    net.set_listeners(pr)
    for _ in range(3):
        jnet.fit(x, y, batch_size=B)
        net.fit(x, y, batch_size=B)
    _assert_trained_alike(jnet, jr.scores, net, pr.scores)


@pytest.mark.parametrize("container", ["list", "graph"])
def test_rnn_time_step_in_chunks_equals_output(container):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 7, F)).astype(np.float32)
    if container == "graph":
        jconf = _graph_conf(tbptt=False)
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
        jnet = JaxGraph(jconf).init()
    else:
        jconf = (JaxBuilder.builder().seed(2).list()
                 .layer(jl.GravesLSTM(n_out=6))
                 .layer(jl.LSTM(n_out=5))
                 .layer(jl.RnnOutputLayer(n_out=4, activation="softmax"))
                 .set_input_type(JaxInputType.recurrent(F)).build())
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
        jnet = JaxNet(jconf).init()
    full = net.output(x).numpy()
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), rtol=0,
                               atol=ATOL)
    for chunks in ([1] * 7, [3, 4], [7]):
        net.rnn_clear_previous_state()
        jnet.rnn_clear_previous_state()
        outs, jouts, s = [], [], 0
        for n in chunks:
            xs = x[:, s] if n == 1 else x[:, s:s + n]
            o = net.rnn_time_step(xs).numpy()
            jo = np.asarray(jnet.rnn_time_step(xs))
            np.testing.assert_allclose(o, jo, rtol=0, atol=ATOL)
            outs.append(o[:, None] if n == 1 else o)
            s += n
        np.testing.assert_allclose(np.concatenate(outs, 1), full, rtol=0,
                                   atol=ATOL)


def test_rnn_time_step_streams_the_transformer_lm_as_jax():
    """The KV-cache carries stream through `rnn_time_step` (token ids
    [B, T]), chunk by chunk as JAX's do, and the stream budget holds."""
    from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
    from deeplearning4j_tpu_torch.zoo import TransformerLM
    kw = dict(d_model=16, n_layers=2, n_heads=2, max_len=12)
    jnet = JaxLM(vocab_size=19, **kw).init()
    net = TransformerLM(19, **kw).init(device="cpu")
    ids = np.random.default_rng(4).integers(0, 19, (2, 9))
    full = net.output(ids).numpy()
    np.testing.assert_allclose(full, np.asarray(jnet.output(ids)), rtol=0,
                               atol=ATOL)
    outs, s = [], 0
    for n in (1, 3, 5):
        o = net.rnn_time_step(ids[:, s:s + n]).numpy()
        np.testing.assert_allclose(
            o, np.asarray(jnet.rnn_time_step(ids[:, s:s + n])), rtol=0,
            atol=ATOL)
        outs.append(o)
        s += n
    np.testing.assert_allclose(np.concatenate(outs, 1), full, rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="stream budget"):
        net.rnn_time_step(ids[:, :4])
    net.rnn_clear_previous_state()
    assert net.rnn_time_step(ids[:, :4]).shape == (2, 4, 19)


def test_masked_bidirectional_classifier_trains_as_jax():
    """GravesBidirectionalLSTM -> LastTimeStep -> OutputLayer on padded
    batches with the features mask (one row all padding), 3 steps."""
    jconf = (JaxBuilder.builder().seed(9).updater(
        __import__("deeplearning4j_tpu.common.updaters",
                   fromlist=["RmsProp"]).RmsProp(1e-2)).list()
             .layer(jl.GravesBidirectionalLSTM(n_out=6))
             .layer(jl.LastTimeStep())
             .layer(jl.OutputLayer(n_out=3, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(F)).build())
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    m = _mask(2)
    m[2] = 0
    from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDS
    jr, pr = _JLosses(), _PLosses()
    jnet.set_listeners(jr)
    net.set_listeners(pr)
    for _ in range(3):
        jnet.fit(JaxDS(x, y, features_mask=m))
        net.fit(DataSet(x, y, features_mask=m))
    _assert_trained_alike(jnet, jr.scores, net, pr.scores)


def test_tbptt_holds_the_transformer_stream_budget():
    """A TBPTT sequence longer than a block's KV cache is refused, as the
    JAX `_fit_tbptt` refuses it."""
    jconf = (JaxBuilder.builder().seed(3).list()
             .layer(jl.TransformerEncoderBlock(n_heads=2, causal=True,
                                               cache_len=8))
             .layer(jl.RnnOutputLayer(n_out=4, activation="softmax"))
             .backprop_type(JaxBPT.TRUNCATED_BPTT, 4)
             .set_input_type(JaxInputType.recurrent(6)).build())
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 12))]
    with pytest.raises(ValueError, match="carry budget 8"):
        net.fit(x, y, batch_size=2)
    with pytest.raises(ValueError, match="carry budget 8"):
        JaxNet(jconf).init().fit(x, y, batch_size=2)


def test_transformer_tbptt_with_dropout_trains_as_jax():
    """TBPTT through KV-cache carries (Transformer-XL style), the block's
    residual and FFN dropout on the carry path under the chunk keys:
    Sgd, so rounding is not amplified (Adam moves `attn_bk` on noise)."""
    from deeplearning4j_tpu.common.updaters import Sgd
    jconf = (JaxBuilder.builder().seed(3).updater(Sgd(0.5)).list()
             .layer(jl.PositionalEncodingLayer(max_len=8))
             .layer(jl.TransformerEncoderBlock(n_heads=2, causal=True,
                                               cache_len=8, dropout=0.9))
             .layer(jl.RnnOutputLayer(n_out=4, activation="softmax"))
             .backprop_type(JaxBPT.TRUNCATED_BPTT, 4)
             .set_input_type(JaxInputType.recurrent(6)).build())
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 8))]
    jr, pr = _JLosses(), _PLosses()
    jnet.set_listeners(jr)
    net.set_listeners(pr)
    for _ in range(3):
        jnet.fit(x, y, batch_size=2)
        net.fit(x, y, batch_size=2, shuffle=False)
    _assert_trained_alike(jnet, jr.scores, net, pr.scores)


def test_tbptt_refuses_a_line_search_solver_as_jax_does():
    conf = TextGenerationLSTM(vocab_size=5, hidden=4).conf()
    conf.optimization_algo = "lbfgs"
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y = _char_data(5, 2, 6, 0)
    with pytest.raises(ValueError, match="truncated BPTT"):
        net.fit(x, y, batch_size=2)


# ------------------------------------------------------------ the char-LM
WINDOWS, WT = 16, 100


@pytest.fixture(scope="module")
def char_lm():
    net = TextGenerationLSTM().init_pretrained(PretrainedType.TEXT,
                                               device="cpu")
    jnet = JaxTG().init_pretrained(JaxPT.TEXT)
    charset = TextGenerationLSTM.pretrained_charset()
    assert charset == JaxTG.pretrained_charset()
    from pathlib import Path
    text = (Path(__file__).parents[1] / "SURVEY.md").read_text(
        errors="ignore")
    idx = {c: i for i, c in enumerate(charset)}
    ids = np.asarray([idx.get(c, len(charset)) for c in
                      text[:WINDOWS * WT + 1]], np.int64)
    eye = np.eye(77, dtype=np.float32)
    x = eye[ids[:-1].reshape(WINDOWS, WT)]
    y = ids[1:].reshape(WINDOWS, WT)
    return net, jnet, x, y


def test_pretrained_char_lm_restores_and_agrees_with_jax(char_lm):
    net, jnet, x, y = char_lm
    conf = json.loads(zipfile.ZipFile(
        TextGenerationLSTM().pretrained_path(PretrainedType.TEXT)).read(
        "configuration.json"))
    # every field the JAX-written JSON carries reads back as written
    # (forget_gate_bias_init and gate_activation among them)
    for mine, theirs in zip(net.conf.to_dict()["layers"], conf["layers"]):
        assert {k: mine[k] for k in theirs} == theirs
    got = net.output(x).numpy()
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    acc = (got.argmax(-1) == y).mean(axis=1)
    np.testing.assert_array_equal(acc, (want.argmax(-1) == y).mean(axis=1))
    assert acc.mean() > 0.3
    # streaming one char at a time reproduces output()
    net.rnn_clear_previous_state()
    steps = np.stack([net.rnn_time_step(x[:1, t]).numpy()
                      for t in range(WT)], axis=1)
    np.testing.assert_allclose(steps, got[:1], rtol=0, atol=ATOL)


def test_pretrained_refuses_a_wrong_checksum_and_other_types(monkeypatch):
    model = TextGenerationLSTM()
    monkeypatch.setattr(TextGenerationLSTM, "pretrained_checksum",
                        lambda self, ptype: "0" * 64)
    with pytest.raises(IOError, match="Checksum mismatch"):
        model.init_pretrained(PretrainedType.TEXT, device="cpu")
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="no weights"):
        model.init_pretrained(PretrainedType.IMAGENET, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_pretrained(PretrainedType.TEXT)
    # the committed zip is read in place, never copied or rewritten
    path = model.pretrained_path(PretrainedType.TEXT)
    assert path.parent.name == "weights" and path.exists()
    assert JaxZip is not None
