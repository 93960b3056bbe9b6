"""The port's randomness held to the JAX package's: the threefry key
functions (`common/prng.py` against `jax.random` under the partitionable
layout), `init(seed)` of both containers for every ported layer type,
weight init scheme and distribution, and sampled decoding (`generate`,
the paged engine, speculative rejection sampling) against JAX's streams
from the same keys.

Tolerances: keys and bits bit-equal; the float draws built on erfinv,
erf and log within NOISE_RTOL (XLA's and torch's transcendental
functions differ in the last place); init within INIT_RTOL of each
tensor's largest value (the normal draws' erfinv, amplified near +-1);
the orthogonal draw within ORTHO_ATOL (LAPACK's QR against XLA's).
Sampled streams are held by margin: equal, or first apart where the
reference's noisy logits (filtered log-probabilities plus the key's
Gumbel noise) have a top-1/top-2 gap within MARGIN, with such near-ties
counted. Everything runs on the CPU, through the kernels' plain
versions.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers as jl
from deeplearning4j_tpu.common import distributions as jdist
from deeplearning4j_tpu.common.weights import init_weights as jax_init
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import (
    ComputationGraphConfiguration as JaxGraphConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.serving import PagedDecodeEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch.common import distributions as pdist
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    filter_logits,
    generate,
    stream_agreement,
    teacher_forced_probs,
)

NOISE_RTOL = 5e-6
INIT_RTOL = 1e-5
ORTHO_ATOL = 1e-5
MARGIN = 1e-4
SEEDS = [0, 7, 123456, 2 ** 31 + 5]
SHAPES = [(), (5,), (3, 77), (2, 3, 4)]


def _np_keys(keys):
    return [tuple(int(v) for v in k) for k in np.asarray(keys).tolist()]


# ------------------------------------------------------------ key functions
@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_rows_are_jax_bit_for_bit(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    assert _np_keys(jax.random.split(jk, 6)) == prng.split(k, 6)
    assert _np_keys(jax.random.split(jk)) == prng.split(k)
    keys = np.asarray(jax.random.split(jk, 5))
    data = np.asarray([0, 1, 9, 2 ** 20, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(keys, data))
    got = prng.fold_in_rows(prng.keys_tensor(_np_keys(keys)),
                            torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_and_truncated_normal_fit_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    g = np.asarray(jax.random.gumbel(jk, shape))
    got = prng.gumbel(k, shape).numpy()
    np.testing.assert_allclose(got, g, rtol=0,
                               atol=NOISE_RTOL * max(1.0, np.abs(g).max()))
    tn = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    got = prng.truncated_normal(k, -2.0, 2.0, shape).numpy()
    np.testing.assert_allclose(got, tn, rtol=NOISE_RTOL, atol=1e-6)
    if tn.size:
        assert np.abs(got).max() < 2.0


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_and_row_draws_are_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    logits = np.random.default_rng(seed % 97).normal(
        size=(6, 50)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jk, logits))
    np.testing.assert_array_equal(
        prng.categorical(k, torch.from_numpy(logits)).numpy(), want)
    keys = np.asarray(jax.random.split(jk, 6))
    pk = prng.keys_tensor(_np_keys(keys))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    np.testing.assert_array_equal(
        prng.categorical_rows(pk, torch.from_numpy(logits)).numpy(), want)
    u = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk))(keys))
    np.testing.assert_array_equal(prng.uniform_rows(pk, 1)[:, 0].numpy(), u)
    g = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (77,)))(keys))
    np.testing.assert_allclose(prng.gumbel_rows(pk, 77).numpy(), g, rtol=0,
                               atol=NOISE_RTOL * np.abs(g).max())


# ------------------------------------------------------------------- init
def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    return float(np.abs(np.asarray(got, np.float64) - want).max() / scale) \
        if want.size else 0.0


def _assert_init_matches(net, jparams):
    worst = {}
    for key, layer in net.keyed():
        pm = layer.jax_param_map()
        assert set(pm) == set(jparams.get(key, {})), key
        for name, t in pm.items():
            worst[(key, name)] = _rel_err(t.numpy(), jparams[key][name])
    bad = {k: v for k, v in worst.items() if v > INIT_RTOL}
    assert not bad, bad


def _layer_stack(jmod):
    """One of every ported layer type with params (and the param-free
    ones between them), JAX classes or the port's."""
    return [jmod.EmbeddingLayer(n_in=13, n_out=8),
            jmod.PositionalEncodingLayer(max_len=16),
            jmod.TransformerEncoderBlock(n_heads=2, causal=True,
                                         cache_len=16),
            jmod.MultiHeadAttention(n_in=8, n_out=8, n_heads=2),
            jmod.LayerNormalization(),
            jmod.LSTM(n_out=6),
            jmod.GravesLSTM(n_out=5),
            jmod.GravesBidirectionalLSTM(n_out=4),
            jmod.SimpleRnn(n_out=7),
            jmod.BatchNormalization(),
            jmod.RnnOutputLayer(n_out=13, activation="softmax")]


def test_init_of_every_layer_type_equals_jax():
    b = JaxBuilder.builder().seed(11).weight_init("xavier").list()
    for layer in _layer_stack(jl):
        b.layer(layer)
    b.set_input_type(JaxInputType.recurrent(13))
    jconf = b.build()
    jnet = JaxNet(jconf).init(31)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(31)
    _assert_init_matches(net, to_numpy_params(jnet.params))


def _conv_graph(weight_init):
    b = JaxBuilder.builder().seed(3).weight_init(weight_init)
    g = (JaxGraphConf.graph_builder(b).add_inputs("img")
         .set_input_types(JaxInputType.convolutional(6, 6, 2))
         .add_layer("c1", jl.ConvolutionLayer(n_out=4, kernel_size=3,
                                              convolution_mode="same"),
                    "img")
         .add_layer("bn", jl.BatchNormalization(), "c1")
         .add_layer("c2", jl.ConvolutionLayer(n_out=4, kernel_size=1),
                    "img")
         .add_vertex("sum", ElementWiseVertex("add"), "bn", "c2")
         .add_layer("pool", jl.GlobalPoolingLayer(pooling_type="avg"),
                    "sum")
         .add_layer("d", jl.DenseLayer(n_out=5), "pool")
         .add_layer("out", jl.OutputLayer(n_out=3), "d")
         .set_outputs("out"))
    return g.build()


@pytest.mark.parametrize("scheme", [w.value for w in WeightInit
                                    if w.value not in ("identity",
                                                       "distribution")])
def test_graph_init_per_weight_init_equals_jax(scheme):
    jconf = _conv_graph(scheme)
    jnet = JaxGraph(jconf).init(8)
    net = ComputationGraph(ComputationGraphConfiguration.from_json(
        jconf.to_json()), device="cpu").init(8)
    _assert_init_matches(net, to_numpy_params(jnet.params))


DISTS = {
    "normal": (jdist.NormalDistribution(0.5, 2.0), None),
    "uniform": (jdist.UniformDistribution(-0.3, 0.7), None),
    "binomial": (jdist.BinomialDistribution(5, 0.3), None),
    "constant": (jdist.ConstantDistribution(0.25), None),
    "lognormal": (jdist.LogNormalDistribution(0.0, 0.5), None),
    "truncated_normal": (jdist.TruncatedNormalDistribution(0.1, 0.7), None),
    "orthogonal": (jdist.OrthogonalDistribution(1.5), ORTHO_ATOL),
}


@pytest.mark.parametrize("name", sorted(DISTS))
@pytest.mark.parametrize("shape", [(6, 4), (3, 9), (2, 3, 5)], ids=str)
def test_distribution_draws_equal_jax(name, shape):
    jd, atol = DISTS[name]
    pd = pdist.distribution_from_dict(jd.to_dict())
    for seed in (1, 99):
        if name == "orthogonal" and len(shape) < 2:
            continue
        want = np.asarray(jd.sample(jax.random.PRNGKey(seed), shape))
        got = pd.sample(prng.key(seed), shape).numpy()
        if atol is None:
            assert _rel_err(got, want) <= INIT_RTOL, (name, seed)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # and through a layer's weight init
    w = init_weights(prng.key(4), (5, 6), "distribution", 5, 6,
                     distribution=pd).numpy()
    want = np.asarray(jax_init(jax.random.PRNGKey(4), (5, 6), "distribution",
                            5, 6, distribution=jd))
    np.testing.assert_allclose(w, want, rtol=0,
                               atol=atol or INIT_RTOL * max(
                                   1.0, np.abs(want).max()))


# ----------------------------------------------------------- sampled decode
V, D, HEADS, LAYERS, MAXLEN, BL = 29, 16, 2, 2, 32, 4
N_TOK, TEMP = 10, 1.0


@pytest.fixture(scope="module")
def nets():
    jnet = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=4).init()
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN, seed=4).init(device="cpu")
    # init(seed) is JAX's: no weights loaded; the probabilities agree to
    # rounding
    _assert_init_matches(net, to_numpy_params(jnet.params))
    return jnet, net


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(6).integers(0, V, (3, 5))


def _noisy_logits(net, prompt, stream, noise, top_p=None):
    """The port's filtered, tempered log-probabilities at each position
    of `stream` (teacher-forced) plus the noise [n, V] that drew it."""
    p = torch.from_numpy(teacher_forced_probs(net, prompt, stream))
    logits = torch.log(p.clamp_min(1e-9)) / TEMP
    if top_p is not None:
        logits = filter_logits(logits, None, torch.full((len(p), 1), top_p))
    return (logits + noise).numpy()


def _agree(net, prompt, ref, got, noise, top_p=None):
    rep = stream_agreement(ref, got, _noisy_logits(net, prompt, ref, noise,
                                                   top_p), MARGIN)
    assert rep["ok"], rep
    return rep


def test_sampled_generate_equals_jax(nets, prompts):
    jnet, net = nets
    B = len(prompts)
    want = np.asarray(jax_generate(jnet, prompts, N_TOK, temperature=TEMP,
                                   rng=jax.random.PRNGKey(17)))
    got = generate(net, prompts, N_TOK, temperature=TEMP, rng=17)
    assert (got == generate(net, prompts, N_TOK, temperature=TEMP,
                            rng=np.asarray([0, 17], np.uint32))).all()
    key, noises = prng.key(17), []
    for _ in range(N_TOK):                 # the split chain of the scan
        key, sub = prng.split(key)
        noises.append(prng.gumbel(sub, (B, V)))
    near = 0
    for b in range(B):
        rep = _agree(net, prompts[b], want[b], got[b],
                     torch.stack([n[b] for n in noises]))
        near += rep["near_ties"]
    assert near <= 2, near
    # None is PRNGKey(0), as in JAX
    np.testing.assert_array_equal(
        generate(net, prompts[:1], 4, temperature=TEMP),
        np.asarray(jax_generate(jnet, prompts[:1], 4, temperature=TEMP)))


def _drive(eng, reqs):
    admitted = eng.admit_many(reqs)
    assert len(admitted) == len(reqs)
    out = {s: [int(f)] for s, f, _ in admitted}
    for _ in range(400):
        if not eng.active.any():
            break
        for s, toks in eng.step()[0].items():
            out[s].extend(int(t) for t in toks)
    return [out[s] for s, _, _ in admitted]


@pytest.mark.parametrize("spec", [None, 4], ids=["vanilla", "speculative"])
def test_sampled_engine_streams_equal_jax(nets, prompts, spec):
    jnet, net = nets
    kw = dict(n_slots=4, n_blocks=40, block_len=BL)
    if spec:
        kw.update(speculative=spec, spec_sampled=True)
    keys = [np.asarray([3, 1000 + i], np.uint32) for i in range(3)]
    reqs = [dict(prompt_ids=p, n_tokens=N_TOK, temperature=TEMP, top_p=0.9,
                 rng=k) for p, k in zip(prompts, keys)]
    reqs.append(dict(prompt_ids=prompts[0], n_tokens=N_TOK))    # greedy
    want = _drive(JaxEngine(jnet, **kw), reqs)
    eng = PagedDecodeEngine(net, device="cpu", **kw)
    got = _drive(eng, reqs)
    if spec:
        assert eng.spec_proposed_total > 0
    for i, k in enumerate(keys):
        kt = prng.keys_tensor([tuple(int(v) for v in k)] * N_TOK)
        # token t's vanilla noise: fold_in(key, t) (speculation resamples
        # under sub-folds, so it is held by equality only)
        noise = prng.gumbel_rows(prng.fold_in_rows(
            kt, torch.arange(N_TOK)), V)
        if spec:
            assert got[i] == want[i]
        else:
            _agree(net, prompts[i], want[i], got[i], noise, top_p=0.9)
    assert got[3] == want[3]
