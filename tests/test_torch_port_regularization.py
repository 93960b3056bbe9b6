"""Training with what a real configuration sets, port (CPU) against the
JAX package (CPU): the dropout classes, weight noise, constraints,
gradient normalization, `max_norm` and l1/l2, each as a function and
then in three `fit` steps of a tiny TransformerLM.

The port draws JAX's own threefry bits (`common/prng.py`), so a dropout
or weight-noise mask is the same on both sides and the training
trajectories are compared as fp32 training is: the loss per step within
rtol 1e-5, and after three steps every param and Adam's m and v by
relative Frobenius difference within 1e-5 (XLA:CPU and PyTorch reduce in
another order; the worst case measured here is about 4e-6). Each
block's key bias `attn_bk` has a gradient that is zero up to rounding
(softmax is shift-invariant per query row), so Adam moves it by noise
of up to lr (1-b1)/sqrt(1-b2) a step on either side: it is held to
twice that bound per step, and its m and v are not compared (for the
same reason l1 and the min-max norm go on the output layer: on a
block, l1 turns that noise into sign(attn_bk) gradients and a loss
term, and a minimum norm scales the noise up to it). Normal
draws (GaussianDropout, GaussianNoise, normal WeightNoise) agree to
about 5e-6 relative (XLA's erfinv and torch's), well inside the
tolerance.

One `mixed_bf16` case per family is held to the mixed band of
`tests/test_torch_port_mixed.py`: step 0's loss within 1e-2 relative of
JAX's mixed run, every step within 5% of its initial loss.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import distributions as jdist
from deeplearning4j_tpu.nn.conf import constraints as jcons
from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import weightnoise as jwn
from deeplearning4j_tpu.nn.conf.builder import (
    GradientNormalization as JaxGN,
    MultiLayerConfiguration as JaxConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import gradients as jgrad
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common import distributions as pdist
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.nn import container as pcontainer
from deeplearning4j_tpu_torch.nn.conf import constraints as pcons
from deeplearning4j_tpu_torch.nn.conf import dropout as pdrop
from deeplearning4j_tpu_torch.nn.conf import weightnoise as pwn
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import gradients as pgrad
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)

V, D, LAYERS, HEADS, MAXLEN, T, B, STEPS = 64, 32, 2, 2, 32, 16, 2, 3
LOSS_RTOL, STATE_RTOL = 1e-5, 1e-5
STEP0_RTOL, BAND = 1e-2, 0.05
ADAM_STEP_MAX = 1e-3 * 0.1 / np.sqrt(1e-3)


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def corpus(seed, n=B * STEPS):
    seq = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


def lm_conf(edit):
    """The tiny JAX LM's configuration with `edit(conf)` applied, round
    tripped through JSON so every sublayer is built from the edited
    fields."""
    conf = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=5).conf()
    edit(conf)
    return JaxConf.from_json(conf.to_json())


def train_both(jconf, policy=None, x=None, y=None, batch=B):
    """Three `fit` steps of the JAX net and of the port net built from
    the same configuration JSON and loaded with the JAX net's params.
    Returns (jax net, jax losses, port net, port losses)."""
    jnet = JaxNet(jconf, dtype_policy=policy).init(5)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", dtype_policy=policy)
    from_jax_params(net, to_numpy_params(jnet.params))
    if x is None:
        x, y = corpus(7)
    rec, mine = _Scores(), _Scores()
    jnet.set_listeners(rec)
    net.set_listeners(mine)
    jnet.fit(x, y, batch_size=batch, shuffle=False)
    net.fit(x, y, batch_size=batch, shuffle=False)
    return jnet, rec.scores, net, mine.scores


def _rel(got, want):
    n = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (n if n > 0 else 1.0)


def assert_same_training(jnet, jl, net, pl, steps=STEPS):
    assert len(jl) == len(pl) == steps
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    got, want = to_jax_params(net), to_numpy_params(jnet.params)
    ust = to_jax_updater_state(net)
    for lk, lp in want.items():
        for name, w in lp.items():
            if name == "attn_bk":
                assert np.abs(got[lk][name] - w).max() <= \
                    2 * steps * ADAM_STEP_MAX
                continue
            assert _rel(got[lk][name], w) <= STATE_RTOL, (lk, name)
            for sk in ("m", "v"):
                ws = np.asarray(jnet.updater_state[lk][name][sk])
                assert _rel(ust[lk][name][sk], ws) <= STATE_RTOL, (
                    lk, name, sk, _rel(ust[lk][name][sk], ws))


def _blocks(conf):
    return conf.layers[2:2 + LAYERS]


def _set_blocks(field, value):
    def edit(conf):
        for layer in _blocks(conf):
            setattr(layer, field, value() if callable(value) else value)
    return edit


def _set_out(field, value):
    def edit(conf):
        setattr(conf.layers[-1], field, value)
    return edit


def _set_emb(field, value):
    def edit(conf):
        setattr(conf.layers[0], field, value)
    return edit


def _set_conf(**fields):
    def edit(conf):
        for k, v in fields.items():
            setattr(conf, k, v)
    return edit


# each configured field, set alone (JAX objects; the port reads the JSON)
CASES = {
    "dropout_float": _set_blocks("dropout", 0.9),
    "dropout_class": _set_blocks("dropout", lambda: jdrop.Dropout(0.8)),
    "alpha_dropout": _set_out("dropout", jdrop.AlphaDropout(0.9)),
    "gaussian_dropout": _set_blocks("dropout",
                                    lambda: jdrop.GaussianDropout(0.2)),
    "gaussian_noise": _set_blocks("dropout",
                                  lambda: jdrop.GaussianNoise(0.05)),
    "output_dropout": _set_out("dropout", 0.8),
    "attention_dropout": _set_blocks("attention_dropout", 0.9),
    "drop_connect": _set_blocks("weight_noise",
                                lambda: jwn.DropConnect(0.9)),
    "drop_connect_bias": _set_out("weight_noise",
                                  jwn.DropConnect(0.9, apply_to_bias=True)),
    "weight_noise_normal": _set_blocks(
        "weight_noise",
        lambda: jwn.WeightNoise(jdist.NormalDistribution(0.0, 0.02))),
    "weight_noise_uniform": _set_out(
        "weight_noise", jwn.WeightNoise(
            jdist.UniformDistribution(0.98, 1.02), additive=False)),
    "max_norm_constraint": _set_out(
        "constraints", [jcons.MaxNormConstraint(0.5)]),
    "min_max_norm_constraint": _set_out(
        "constraints", [jcons.MinMaxNormConstraint(0.2, 0.6, rate=0.5)]),
    "unit_norm_constraint": _set_out(
        "constraints", [jcons.UnitNormConstraint(apply_to_bias=True)]),
    "non_negative_constraint": _set_blocks(
        "constraints", lambda: [jcons.NonNegativeConstraint()]),
    "l1": _set_out("l1", 1e-3),
    "l2": _set_blocks("l2", 1e-2),
    "l1_bias": _set_out("l1_bias", 1e-3),
    "l2_bias": _set_emb("l2_bias", 1e-2),
    "max_norm": _set_conf(max_norm=0.5),
    **{f"gn_{gn.value}": _set_conf(gradient_normalization=gn,
                                   gradient_normalization_threshold=0.05)
       for gn in JaxGN if gn != JaxGN.NONE},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_with_each_field_matches_jax(case):
    jnet, jl, net, pl = train_both(lm_conf(CASES[case]))
    assert_same_training(jnet, jl, net, pl)


def _port_losses(jconf):
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(5)
    rec = _Scores()
    net.set_listeners(rec)
    x, y = corpus(7)
    net.fit(x, y, batch_size=B, shuffle=False)
    return rec.scores


def test_the_fields_change_training():
    """Each family moves the trajectory off the plain run's (so the
    parity above is not the plain run twice)."""
    plain = _port_losses(lm_conf(lambda c: None))
    for case in ("dropout_float", "attention_dropout", "drop_connect",
                 "weight_noise_normal", "l2", "gn_clip_l2_per_layer",
                 "max_norm", "max_norm_constraint"):
        assert _port_losses(lm_conf(CASES[case])) != plain, case


MIXED_FAMILIES = {
    "dropout": "dropout_class", "attention_dropout": "attention_dropout",
    "weight_noise": "drop_connect", "constraints": "max_norm_constraint",
    "gradient_normalization": "gn_clip_l2_per_layer", "l1_l2": "l2",
}


@pytest.mark.parametrize("family", sorted(MIXED_FAMILIES))
def test_mixed_fit_with_each_family_follows_jax(family):
    _, jl, net, pl = train_both(lm_conf(CASES[MIXED_FAMILIES[family]]),
                                policy="mixed_bf16")
    assert net.dtype.is_mixed
    assert abs(pl[0] - jl[0]) <= STEP0_RTOL * jl[0], (pl, jl)
    for a, b in zip(pl, jl):
        assert abs(a - b) <= BAND * jl[0], (pl, jl)
    for p in net.parameters():
        assert p.dtype == torch.float32


# ----------------------------------------------------- the functions alone
def _pair(seed, fold):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), fold),
            prng.fold_in(prng.key(seed), fold))


DROPOUTS = [(jdrop.Dropout(0.7), pdrop.Dropout(0.7)),
            (jdrop.AlphaDropout(0.8), pdrop.AlphaDropout(0.8)),
            (jdrop.GaussianDropout(0.3), pdrop.GaussianDropout(0.3)),
            (jdrop.GaussianNoise(0.2), pdrop.GaussianNoise(0.2))]


@pytest.mark.parametrize("i", range(len(DROPOUTS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_classes_match_jax(i, dtype):
    jd, pd = DROPOUTS[i]
    x = np.random.default_rng(i).standard_normal((3, 9, 8)).astype(
        np.float32)
    jk, pk = _pair(2, i)
    want = np.asarray(jd.apply(jk, jnp.asarray(x, dtype))).astype(np.float32)
    got = pd.apply(pk, torch.from_numpy(x).to(getattr(torch, dtype)))
    # fp32: bits equal, normal draws within erfinv's 5e-6; bf16: one ulp
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"W": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "attn_bq": rng.standard_normal(5).astype(np.float32),
            "ln1_gamma": (1 + rng.standard_normal(5)).astype(np.float32),
            "gamma": rng.standard_normal(5).astype(np.float32)}


def _close_trees(got, want, tol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


WEIGHT_NOISE = [
    (jwn.DropConnect(0.6), pwn.DropConnect(0.6)),
    (jwn.DropConnect(0.6, apply_to_bias=True),
     pwn.DropConnect(0.6, apply_to_bias=True)),
    (jwn.WeightNoise(jdist.NormalDistribution(0.1, 0.5)),
     pwn.WeightNoise(pdist.NormalDistribution(0.1, 0.5))),
    (jwn.WeightNoise(jdist.UniformDistribution(0.5, 1.5), additive=False,
                     apply_to_bias=True),
     pwn.WeightNoise(pdist.UniformDistribution(0.5, 1.5), additive=False,
                     apply_to_bias=True))]


@pytest.mark.parametrize("i", range(len(WEIGHT_NOISE)))
def test_weight_noise_matches_jax(i):
    jw, pw = WEIGHT_NOISE[i]
    params = _params(i)
    jk, pk = _pair(4, 0x5EED)
    want = jw.apply_params(jk, {k: jnp.asarray(v) for k, v in params.items()})
    got = pw.apply_params(pk, {k: torch.from_numpy(v)
                               for k, v in params.items()})
    _close_trees({k: v.numpy() for k, v in got.items()}, want, 1e-5)
    if not pw.apply_to_bias:
        assert np.array_equal(got["b"].numpy(), params["b"])


CONSTRAINTS = [
    (jcons.MaxNormConstraint(1.5), pcons.MaxNormConstraint(1.5)),
    (jcons.MinMaxNormConstraint(0.5, 1.0, rate=0.7),
     pcons.MinMaxNormConstraint(0.5, 1.0, rate=0.7)),
    (jcons.UnitNormConstraint(), pcons.UnitNormConstraint()),
    (jcons.UnitNormConstraint(apply_to_bias=True),
     pcons.UnitNormConstraint(apply_to_bias=True)),
    (jcons.NonNegativeConstraint(), pcons.NonNegativeConstraint()),
    (jcons.NonNegativeConstraint(apply_to_bias=False),
     pcons.NonNegativeConstraint(apply_to_bias=False))]


@pytest.mark.parametrize("i", range(len(CONSTRAINTS)))
def test_constraints_match_jax(i):
    jc, pc = CONSTRAINTS[i]
    params = _params(10 + i)
    want = jc.apply_params({k: jnp.asarray(v) for k, v in params.items()})
    got = pc.apply_params({k: torch.from_numpy(v) for k, v in params.items()})
    _close_trees({k: v.numpy() for k, v in got.items()}, want)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"0": {"W": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
            "2": {"attn_Wq": rng.standard_normal((3, 3)).astype(np.float32)
                  * 3, "ln1_gamma": rng.standard_normal(3).astype(
                      np.float32)}}


@pytest.mark.parametrize("mode", [gn.value for gn in JaxGN])
@pytest.mark.parametrize("threshold", [0.5, 100.0])
def test_gradient_normalization_matches_jax(mode, threshold):
    g = _grads(3)
    want = jgrad.apply_gradient_normalization(
        {lk: {k: jnp.asarray(v) for k, v in lv.items()}
         for lk, lv in g.items()}, JaxGN(mode), threshold)
    got = pgrad.apply_gradient_normalization(
        {lk: {k: torch.from_numpy(v) for k, v in lv.items()}
         for lk, lv in g.items()}, mode, threshold)
    for lk in g:
        _close_trees({k: v.numpy() for k, v in got[lk].items()}, want[lk])


@pytest.mark.parametrize("max_norm", [0.5, 10.0])
def test_max_norm_constraint_matches_jax(max_norm):
    p = _grads(4)
    want = jgrad.apply_max_norm_constraint(
        {lk: {k: jnp.asarray(v) for k, v in lv.items()}
         for lk, lv in p.items()}, max_norm)
    got = pgrad.apply_max_norm_constraint(
        {lk: {k: torch.from_numpy(v) for k, v in lv.items()}
         for lk, lv in p.items()}, max_norm)
    for lk in p:
        _close_trees({k: v.numpy() for k, v in got[lk].items()}, want[lk])


@pytest.mark.parametrize("l1,l2,l1b,l2b", [(1e-3, 0, 0, 0), (0, 1e-2, 0, 0),
                                           (0, 0, 1e-3, 1e-2),
                                           (1e-3, 1e-2, 1e-4, 1e-3)])
def test_regularization_score_matches_jax(l1, l2, l1b, l2b):
    from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
    params = _params(7)
    kw = dict(l1=l1, l2=l2, l1_bias=l1b, l2_bias=l2b)
    want = JaxDense(n_in=6, n_out=5, **kw).regularization_score(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = DenseLayer(6, 5, **kw).regularization_score(
        {k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ packing
PACKING = {
    "plain": lambda c: None,
    "clip_elementwise": _set_conf(
        gradient_normalization=JaxGN.CLIP_ELEMENTWISE_ABSOLUTE_VALUE),
    "clip_l2_per_layer": _set_conf(
        gradient_normalization=JaxGN.CLIP_L2_PER_LAYER),
    "renormalize_per_param_type": _set_conf(
        gradient_normalization=JaxGN.RENORMALIZE_L2_PER_PARAM_TYPE),
    "max_norm": _set_conf(max_norm=1.0),
    "block_constraints": _set_blocks(
        "constraints", lambda: [jcons.MaxNormConstraint(2.0)]),
    "output_constraints": _set_out(
        "constraints", [jcons.MaxNormConstraint(2.0)]),
    "dropout": _set_blocks("dropout", 0.9),
}


@pytest.mark.parametrize("case", sorted(PACKING))
def test_fused_adam_packs_exactly_where_jax_packs(case, monkeypatch):
    """The port's packed runs are JAX's `scan_stack.packable_runs`, and
    fused Adam updates exactly those runs (one call a run a step); every
    other layer updates per leaf."""
    jconf = lm_conf(PACKING[case])
    jnet = JaxNet(jconf).init(5)
    want = [[int(k) for k in run] for run in jnet._packed_runs(jnet.params)]
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    assert net._packed_runs() == want
    calls = []
    orig = pcontainer.adam_update_packed

    def spy(updater, ps, *a):
        calls.append(len(ps))
        return orig(updater, ps, *a)
    monkeypatch.setattr(pcontainer, "adam_update_packed", spy)
    x, y = corpus(3, n=B)
    net.fit(x, y, batch_size=B)
    assert calls == [16 * len(run) for run in want]
    assert K.LAUNCHES["fused_adam"] == 0       # the CPU takes the plain one


def test_weight_noise_over_another_distribution_is_refused_by_name():
    """Every distribution now has JAX's keyed draw, so nothing is
    refused: multiplicative LogNormal weight noise on the output layer
    trains as JAX's does."""
    jconf = lm_conf(_set_out("weight_noise", jwn.WeightNoise(
        jdist.LogNormalDistribution(0.0, 0.1), additive=False)))
    assert_same_training(*train_both(jconf))
