"""The port's numeric foundations against the JAX package: schedules,
the nine updater rules, every loss and activation, weight init, and
`TransformerLM.fit` under a learning-rate schedule and under a per-leaf
rule.

Tolerances:
- schedules: within 1 float32 ulp of JAX at every step 0..200 (XLA's
  float32 cos/pow/exp may differ from numpy's by that);
- updaters: 5 steps of `apply` on seeded fp32 tensors, state and
  update at rtol 1e-6;
- losses and activations, values and gradients: fp32 rtol 1e-6, with
  an absolute floor for values that cancel to near zero, where a
  relative bound is meaningless: 2^-22 (4 ulps of 1.0) for values,
  2^-21 for gradients. XLA:CPU's tanh (a rational approximation) and
  PyTorch's differ by an ulp near ±1, and 1 + tanh(u) (gelu's left
  tail) or 1 - tanh² (tanh's derivative) keeps that ulp as an absolute
  error, times |x| <= 4 in a value and up to 6 in gelu's gradient; a
  mean of terms that cancel (the cosine loss) keeps an ulp of its terms
  likewise;
- fit: the fit tolerances of `tests/test_torch_port_training.py`:
  loss per step rtol 1e-5, params and updater state relative Frobenius
  1e-4, each `attn_bk` by the rule's step bound.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import activations as jact
from deeplearning4j_tpu.common import losses as jloss
from deeplearning4j_tpu.common import schedules as jsch
from deeplearning4j_tpu.common import updaters as jupd
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.common import activations as act
from deeplearning4j_tpu_torch.common import distributions as dist
from deeplearning4j_tpu_torch.common import losses as loss
from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common import schedules as sch
from deeplearning4j_tpu_torch.common import updaters as upd
from deeplearning4j_tpu_torch.common.weights import WeightInit, init_weights
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM

RTOL, ATOL, ATOL_GRAD = 1e-6, 2.0 ** -22, 2.0 ** -21


# -------------------------------------------------------------- schedules
SCHEDULES = [
    ("FixedSchedule", dict(value=0.01)),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.99)),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.01, power=0.75)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=150)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.05, step_size=100)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step_size=30)),
    ("MapSchedule", dict(values={0: 0.1, 50: 0.05, 120: 0.01})),
    ("WarmupCosineSchedule", dict(peak_value=1e-3, warmup_steps=20,
                                  total_steps=150, end_value=1e-5)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULES, ids=[c for c, _ in SCHEDULES])
def test_schedule_values_within_one_ulp_and_dicts_round_trip(cls, kw):
    mine, ref = getattr(sch, cls)(**kw), getattr(jsch, cls)(**kw)
    steps = np.arange(201)
    want = np.broadcast_to(np.asarray(ref.value_at(jnp.asarray(steps)),
                                      np.float32), steps.shape)
    got = np.asarray([mine.value_at(int(s)) for s in steps])
    assert got.dtype == np.float32
    # ulps apart: the distance of the two float32 bit patterns (all the
    # values are positive)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert np.all(ulps <= 1), (steps[ulps > 1], got, want)
    assert mine(7) == mine.value_at(7)
    # dicts: the port's read by JAX and JAX's read by the port
    assert jsch.schedule_from_dict(mine.to_dict()) == ref
    assert sch.schedule_from_dict(ref.to_dict()) == mine
    assert mine.to_dict() == ref.to_dict()


def test_schedule_helpers():
    assert sch.as_schedule(0.5) == sch.FixedSchedule(0.5)
    w = sch.WarmupCosineSchedule(1.0, 10, 20)
    assert sch.as_schedule(w) is w
    assert sch.schedule_from_dict(3) == sch.FixedSchedule(3.0)
    # warmup: linear from 0; then cosine to end_value at total_steps
    assert w.value_at(0) == 0 and w.value_at(5) == np.float32(0.5)
    assert w.value_at(10) == 1 and w.value_at(20) == 0 == w.value_at(500)


# --------------------------------------------------------------- updaters
RULES = [
    ("Sgd", dict(learning_rate=0.05)),
    ("NoOp", dict()),
    ("Adam", dict(learning_rate=1e-2)),
    ("AdaMax", dict(learning_rate=1e-2)),
    ("Nadam", dict(learning_rate=1e-2)),
    ("Nesterovs", dict(learning_rate=0.05, momentum=0.8)),
    ("AdaGrad", dict(learning_rate=0.1)),
    ("AdaDelta", dict(rho=0.9)),
    ("RmsProp", dict(learning_rate=0.01, rms_decay=0.9)),
]


def _with_lr(kw, scheduled, module):
    if scheduled and "learning_rate" in kw:
        kw = dict(kw, learning_rate=module.WarmupCosineSchedule(
            peak_value=kw["learning_rate"], warmup_steps=2, total_steps=5))
    return kw


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant_lr", "warmup_cosine"])
@pytest.mark.parametrize("cls,kw", RULES, ids=[c for c, _ in RULES])
def test_updater_rule_follows_jax_for_five_steps(cls, kw, scheduled):
    mine = getattr(upd, cls)(**_with_lr(kw, scheduled, sch))
    ref = getattr(jupd, cls)(**_with_lr(kw, scheduled, jsch))
    rng = np.random.default_rng(11)
    p = rng.standard_normal((7, 5)).astype(np.float32)
    st_m = mine.init_state(torch.from_numpy(p))
    st_j = ref.init_state(jnp.asarray(p))
    assert set(st_m) == set(st_j)
    for step in range(5):
        g = (rng.standard_normal(p.shape) * 10.0 ** (step - 2)).astype(
            np.float32)
        u_m, st_m = mine.apply(torch.from_numpy(g), st_m, step)
        u_j, st_j = ref.apply(jnp.asarray(g), st_j, step)
        np.testing.assert_allclose(u_m.numpy(), np.asarray(u_j), rtol=RTOL,
                                   err_msg=f"update, step {step}")
        for k in st_j:
            np.testing.assert_allclose(st_m[k].numpy(), np.asarray(st_j[k]),
                                       rtol=RTOL, err_msg=f"{k}, step {step}")
    # serde both ways, schedules included
    assert mine.to_dict() == ref.to_dict()
    assert upd.updater_from_dict(ref.to_dict()) == mine
    assert jupd.updater_from_dict(mine.to_dict()) == ref


def test_updater_helpers():
    assert isinstance(upd.get_updater("RMSPROP"), upd.RmsProp)
    with pytest.raises(ValueError):
        upd.get_updater("lion")
    with pytest.raises(TypeError):
        upd.get_updater(3)
    a = upd.Adam(1e-3).with_lr(sch.StepSchedule(0.1, 0.5, 10))
    assert a.to_dict()["learning_rate"]["schedule"] == "step"
    assert upd.AdaDelta().with_lr(0.5) == upd.AdaDelta()
    assert upd.Adam(1e-3) != upd.Nadam(1e-3)
    # the fused kernel's scalars follow a scheduled rate
    lr, _, _ = upd.adam_scalars(upd.Adam(sch.StepSchedule(0.1, 0.5, 10)), 25)
    assert lr == np.float32(0.025)


# ----------------------------------------------------------------- losses
def _loss_case(name, rng):
    """(activation name, labels, preout) for `name` at [4, 5, 6]."""
    shape = (4, 5, 6)
    pre = (rng.standard_normal(shape) * 2).astype(np.float32)
    onehot = np.eye(6, dtype=np.float32)[rng.integers(0, 6, shape[:-1])]
    binary = (rng.random(shape) > 0.5).astype(np.float32)
    real = rng.standard_normal(shape).astype(np.float32)
    probs = rng.dirichlet(np.ones(6), shape[:-1]).astype(np.float32)
    return {
        "mse": ("tanh", real), "l2": ("identity", real),
        "mae": ("identity", real), "l1": ("tanh", real),
        "msle": ("softplus", np.abs(real)),
        "xent": ("sigmoid", binary), "xent:hardsigmoid": ("hardsigmoid",
                                                          binary),
        "mcxent": ("softmax", onehot), "mcxent:sigmoid": ("sigmoid", probs),
        "negativeloglikelihood": ("softmax", onehot),
        "hinge": ("identity", binary), "squaredhinge": ("tanh", binary),
        "kl_divergence": ("softmax", probs),
        "poisson": ("softplus", rng.poisson(1.5, shape).astype(np.float32)),
        "cosine_proximity": ("identity", real),
    }[name] + (pre,)


LOSS_CASES = ["mse", "l2", "mae", "l1", "msle", "xent", "xent:hardsigmoid",
              "mcxent", "mcxent:sigmoid", "negativeloglikelihood", "hinge",
              "squaredhinge", "kl_divergence", "poisson", "cosine_proximity"]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_its_gradient_follow_jax(case, masked):
    rng = np.random.default_rng(LOSS_CASES.index(case))
    act_name, labels, pre = _loss_case(case, rng)
    name = case.split(":")[0]
    mask = weights = None
    if masked:
        mask = (rng.random(pre.shape[:-1]) > 0.3).astype(np.float32)
        weights = rng.uniform(0.5, 2.0, pre.shape[-1]).astype(np.float32)
    mine, ref = loss.get_loss(name), jloss.get_loss(name)
    assert mine.to_dict() == ref.to_dict() and mine.name == name

    def jf(z):
        return ref(jnp.asarray(labels), z, jact.get_activation(act_name),
                   None if mask is None else jnp.asarray(mask), weights)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(pre))
    z = torch.from_numpy(pre).requires_grad_()
    got = mine(torch.from_numpy(labels), z, act_name,
               None if mask is None else torch.from_numpy(mask), weights)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=ATOL_GRAD)
    sa = mine.score_array(torch.from_numpy(labels), torch.from_numpy(pre),
                          act.get_activation(act_name))
    assert tuple(sa.shape) == pre.shape[:-1]


def test_loss_helpers():
    assert sorted(loss._LOSSES) == sorted(jloss._LOSSES)
    assert loss.loss_from_dict({"loss": "HINGE"}) == loss.LossHinge()
    assert repr(loss.LossPoisson()) == "LossPoisson()"
    with pytest.raises(TypeError):
        loss.get_loss(3)


# ------------------------------------------------------------ activations
ACTS = sorted(jact.ACTIVATIONS) + ["leakyrelu:0.3"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_and_its_gradient_follow_jax(name):
    x = np.random.default_rng(len(name)).uniform(-4, 4, (6, 7)).astype(
        np.float32)
    x[0, :3] = [0.0, 1e-3, -1e-3]
    ref, mine = jact.get_activation(name), act.get_activation(name)
    assert mine.name == ref.name and mine == act.Activation(name)
    want, vjp = jax.vjp(ref, jnp.asarray(x))
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    (want_g,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(x).requires_grad_()
    got = mine(t)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=ATOL_GRAD)


def test_activation_helpers():
    assert sorted(act.ACTIVATIONS) == sorted(jact.ACTIVATIONS)
    with pytest.raises(ValueError):
        act.get_activation("swishy")
    with pytest.raises(ValueError):
        act.get_activation("relu:0.2")
    with pytest.raises(TypeError):
        act.get_activation(None)
    assert hash(act.Activation("TANH")) == hash(act.Activation("tanh"))


# ------------------------------------------------------------ weight init
def test_weight_init_scales_and_distributions():
    """Shapes, fans and distributions: each scheme's sample standard
    deviation against its formula (`tests/test_torch_port_keys.py` holds
    the values to JAX's)."""
    g = prng.key(0)
    fan_in, fan_out, shape = 300, 200, (300, 200)
    expect = {
        "xavier": (2 / (fan_in + fan_out)) ** 0.5,
        "xavier_uniform": (6 / (fan_in + fan_out)) ** 0.5 / 3 ** 0.5,
        "relu": (2 / fan_in) ** 0.5,
        "lecun_uniform": (3 / fan_in) ** 0.5 / 3 ** 0.5,
        "var_scaling_normal_fan_out": (1 / fan_out) ** 0.5,
        "sigmoid_uniform": 4 * (6 / (fan_in + fan_out)) ** 0.5 / 3 ** 0.5,
    }
    for scheme, std in expect.items():
        w = init_weights(g, shape, scheme, fan_in, fan_out)
        assert w.shape == shape and w.dtype == torch.float32
        assert abs(float(w.std()) / std - 1) < 0.02, scheme
    assert sorted(w.value for w in WeightInit) == sorted(
        w.value for w in __import__(
            "deeplearning4j_tpu.common.weights",
            fromlist=["WeightInit"]).WeightInit)
    assert torch.equal(init_weights(g, (3, 3), "identity", 3, 3),
                       torch.eye(3))
    assert float(init_weights(g, (2, 2), "ones", 2, 2).sum()) == 4
    with pytest.raises(ValueError):
        init_weights(g, (2, 3), "identity", 2, 3)
    with pytest.raises(ValueError):
        init_weights(g, (2, 3), "distribution", 2, 3)
    o = init_weights(g, (8, 8), "distribution", 8, 8,
                     distribution=dist.OrthogonalDistribution(gain=2.0))
    torch.testing.assert_close(o @ o.T, 4 * torch.eye(8), atol=1e-5,
                               rtol=0)
    tn = dist.TruncatedNormalDistribution(1.0, 0.5).sample(g, (5000,))
    assert float(tn.min()) >= 0.0 and float(tn.max()) <= 2.0
    b = dist.BinomialDistribution(4, 0.25).sample(g, (5000,))
    assert abs(float(b.mean()) - 1.0) < 0.05
    for d in (dist.NormalDistribution(1.0, 2.0), dist.UniformDistribution(),
              dist.ConstantDistribution(3.0), dist.LogNormalDistribution()):
        assert dist.distribution_from_dict(d.to_dict()) == d


def test_layers_draw_through_the_scheme():
    net = TransformerLM(16, d_model=8, n_layers=1, n_heads=2,
                        max_len=8).init(device="cpu")
    W = net.layers[2].ff_W1
    assert abs(float(W.std()) / (2 / (8 + 32)) ** 0.5 - 1) < 0.3
    net.layers[2].weight_init = WeightInit.ZERO
    net.layers[2].init_weights(prng.key(1))
    assert float(net.layers[2].ff_W1.abs().sum()) == 0
    assert float(net.layers[2].attn.Wq.abs().sum()) == 0


# ---------------------------------------------------- fit under a schedule
V, D, LAYERS, HEADS, MAXLEN, B, STEPS = 64, 32, 2, 2, 17, 2, 4
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4


class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def _fit_pair(rule, jrule):
    """A JAX LM and its port from the same params, every layer on the
    given rule, both fit STEPS steps of [B, 16]; per-step losses."""
    conf = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=5).conf()
    for layer in conf.layers:
        layer.updater = jrule
    jnet = JaxNet(conf).init(5)
    layers = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                           max_len=MAXLEN).layers()
    for layer in layers:
        layer.updater = rule
    net = from_jax_params(MultiLayerNetwork(layers, device="cpu"),
                          to_numpy_params(jnet.params))
    seq = np.random.default_rng(3).integers(0, V, (B * STEPS, MAXLEN))
    x = seq[:, :-1].astype(np.float32)
    y = np.eye(V, dtype=np.float32)[seq[:, 1:]]
    rec = _Scores()
    jnet.set_listeners(rec)
    jnet.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    scores = []
    for i in range(STEPS):
        net.fit(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B], batch_size=B,
                shuffle=False)
        scores.append(net.score_value)
    return jnet, net, rec.scores, scores


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("rule", ["adam_warmup_cosine", "rmsprop"])
def test_fit_follows_jax_under_a_schedule_and_a_per_leaf_rule(rule):
    if rule == "rmsprop":
        mine, ref = upd.RmsProp(1e-3), jupd.RmsProp(1e-3)
        step_max = 1e-3 / np.sqrt(1 - 0.95) * STEPS   # |g|/sqrt(g2) bound
    else:
        mine = upd.Adam(sch.WarmupCosineSchedule(3e-3, 2, STEPS))
        ref = jupd.Adam(jsch.WarmupCosineSchedule(3e-3, 2, STEPS))
        step_max = 3e-3 * 0.1 / np.sqrt(1e-3) * STEPS
    jnet, net, jscores, scores = _fit_pair(mine, ref)
    # the packed-run key (`layer_signature`) holds with a schedule inside
    assert net._packed_runs() == [[2, 3]]
    assert len(scores) == len(jscores) == STEPS
    np.testing.assert_allclose(scores, jscores, rtol=LOSS_RTOL)
    got = to_jax_params(net)
    for lk, lp in to_numpy_params(jnet.params).items():
        for name, want in lp.items():
            if name == "attn_bk":
                assert np.abs(got[lk][name] - want).max() <= 2 * step_max
                continue
            assert _rel(got[lk][name], want) <= PARAM_RTOL, (lk, name)
    state = to_jax_updater_state(net)
    for lk, ls in jnet.updater_state.items():
        for name, st in ls.items():
            assert set(state[lk][name]) == set(st)
            if name == "attn_bk":
                continue
            for sk, w in st.items():
                assert _rel(state[lk][name][sk], np.asarray(w)) <= PARAM_RTOL
    assert all(l.updater is mine for l in net.layers)
