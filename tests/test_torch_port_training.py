"""The port's training slice against the JAX package: the mcxent loss,
the minibatch iterator, and `TransformerLM.fit` with Adam.

Both sides start from the same weights (the JAX net's params through
`from_jax_params`) and see the same numpy batches; the port runs on the
CPU, where every kernel wrapper takes its plain version. The JAX side
runs with its kernels off (the CPU default): XLA attention, XLA
LayerNorm and per-leaf jnp Adam.

Tolerances (fp32): loss per step rtol 1e-5; params and Adam's m and v
after training relative Frobenius 1e-4 (reduction order differs
between XLA:CPU and PyTorch, and Adam's m/sqrt(v) step amplifies it
elementwise; measured about 1.5e-6). The one
exception is each block's key bias `attn_bk`: softmax is invariant to a
per-row shift of the scores, so its gradient is zero up to rounding and
Adam turns that noise into steps of up to lr (1-b1)/sqrt(1-b2) each
(Kingma & Ba, section 2.1) on either side; it is held to twice that
bound per step.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.common.activations import (
    get_activation as jax_activation,
)
from deeplearning4j_tpu.common.losses import LossMCXENT as JaxMCXENT
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxIterator,
)
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.common.losses import (
    LossMCXENT,
    LossNegativeLogLikelihood,
    get_loss,
)
from deeplearning4j_tpu_torch.common.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    from_jax_updater_state,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

V, D, LAYERS, HEADS, MAXLEN = 64, 64, 2, 2, 32
N, BATCH = 12, 4                  # 3 batches per epoch
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
LR = 1e-3
ADAM_STEP_MAX = LR * 0.1 / np.sqrt(1e-3)


def corpus(seed, n=N):
    """Token windows of length max_len (ids [n, 31] float-carried, as the
    JAX fit takes them, and one-hot next-token labels [n, 31, V])."""
    seq = np.random.default_rng(seed).integers(0, V, (n, MAXLEN))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


def port_lm(params):
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN).init(device="cpu")
    return from_jax_params(net, params)


def jax_lm():
    return JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=5).init()


class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def port_step_scores(net):
    """Record `score_value` after each of the port's train steps."""
    scores, step = [], net._fit_step

    def recording(x, y):
        step(x, y)
        scores.append(net.score_value)
    net._fit_step = recording
    return scores


def assert_params_close(jparams, net, steps):
    got = to_jax_params(net)
    assert set(got) == set(jparams)
    for lk, lp in jparams.items():
        assert set(got[lk]) == set(lp)
        for name, want in lp.items():
            want = np.asarray(want)
            diff = got[lk][name] - want
            if name == "attn_bk":
                assert np.abs(diff).max() <= 2 * steps * ADAM_STEP_MAX, name
                continue
            rel = np.linalg.norm(diff) / np.linalg.norm(want)
            assert rel <= PARAM_RTOL, (lk, name, rel)


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
def test_mcxent_matches_jax(masked):
    rng = np.random.default_rng(0)
    pre = rng.standard_normal((3, 5, 7)).astype(np.float32) * 3
    lab = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (3, 5))]
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32) if masked else None
    want = JaxMCXENT()(jnp.asarray(lab), jnp.asarray(pre),
                       jax_activation("softmax"),
                       None if mask is None else jnp.asarray(mask))
    got = LossMCXENT()(torch.from_numpy(lab), torch.from_numpy(pre),
                       "softmax",
                       None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the non-softmax path clips the activation
    want = JaxMCXENT()(jnp.asarray(lab), jnp.asarray(pre),
                       jax_activation("identity"))
    got = LossMCXENT()(torch.from_numpy(lab), torch.from_numpy(pre),
                       "identity")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_all_masked_loss_divides_by_one_and_aliases():
    pre = torch.zeros(2, 3, 4)
    lab = torch.zeros(2, 3, 4)
    assert float(LossMCXENT()(lab, pre, "softmax", torch.zeros(2, 3))) == 0
    assert isinstance(get_loss("negativeloglikelihood"),
                      LossNegativeLogLikelihood)
    with pytest.raises(ValueError):
        get_loss("no_such_loss")


# --------------------------------------------------------------- iterator
@pytest.mark.parametrize("shuffle", [False, True])
def test_iterator_batches_match_jax_over_two_epochs(shuffle):
    x = np.arange(11 * 2, dtype=np.float32).reshape(11, 2)
    y = np.arange(11, dtype=np.float32)
    mine = ArrayDataSetIterator(x, y, batch_size=4, shuffle=shuffle)
    ref = JaxIterator(x, y, batch_size=4, shuffle=shuffle)
    for _ in range(2):
        got = [(d.features, d.labels) for d in mine]
        want = [(d.features, d.labels) for d in ref]
        assert [len(f) for f, _ in got] == [4, 4, 3]
        for (gf, gl), (wf, wl) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)


# -------------------------------------------------------------------- fit
@pytest.fixture(scope="module")
def trained():
    """A JAX LM and its port from the same params, both fit 2 epochs of
    3 shuffled batches; per-step losses recorded."""
    jnet = jax_lm()
    net = port_lm(to_numpy_params(jnet.params))
    x, y = corpus(1)
    rec = _Scores()
    jnet.set_listeners(rec)
    jnet.fit(x, y, epochs=2, batch_size=BATCH)
    scores = port_step_scores(net)
    net.fit(x, y, epochs=2, batch_size=BATCH)
    return jnet, net, rec.scores, scores


def test_fit_follows_jax_loss_and_params(trained):
    jnet, net, jscores, scores = trained
    assert len(scores) == len(jscores) == 6
    np.testing.assert_allclose(scores, jscores, rtol=LOSS_RTOL)
    assert net.iteration_count == jnet.iteration_count == 6
    assert net.epoch_count == 2
    assert net.score() == scores[-1]
    assert_params_close(to_numpy_params(jnet.params), net, 6)


def test_updater_state_follows_jax(trained):
    jnet, net, _, _ = trained
    mine = to_jax_updater_state(net)
    want = jnet.updater_state
    assert set(mine) == set(want)
    for lk in want:
        assert set(mine[lk]) == set(want[lk])
        for name in want[lk]:
            if name == "attn_bk":
                continue
            for sk in ("m", "v"):
                w = np.asarray(want[lk][name][sk])
                rel = (np.linalg.norm(mine[lk][name][sk] - w)
                       / np.linalg.norm(w))
                assert rel <= PARAM_RTOL, (lk, name, sk, rel)


def test_output_and_generate_after_fit_match_jax(trained):
    jnet, net, _, _ = trained
    ids = np.random.default_rng(3).integers(0, V, (2, 12))
    np.testing.assert_allclose(net.output(ids).numpy(),
                               np.asarray(jnet.output(ids)), atol=1e-5)
    want = np.asarray(jax_generate(jnet, ids, 6, temperature=0))
    np.testing.assert_array_equal(generate(net, ids, 6, temperature=0),
                                  want)


def test_launch_counters_stay_zero_on_cpu(trained):
    _, net, _, _ = trained
    K.reset_launches()
    x, y = corpus(2, n=4)
    net.fit(x, y, epochs=1, batch_size=4, shuffle=False)
    assert all(n == 0 for n in K.LAUNCHES.values())
    assert not any(p.requires_grad for p in net.parameters())


def test_carry_across_resumes_the_jax_trajectory():
    """The JAX net trains 2 steps; its params, updater state and
    iteration count load into the port; both take one more step."""
    jnet = jax_lm()
    x, y = corpus(4, n=8)
    jnet.fit(x, y, epochs=1, batch_size=4, shuffle=False)
    net = port_lm(to_numpy_params(jnet.params))
    from_jax_updater_state(net, jnet.updater_state, jnet.iteration_count)
    assert net.iteration_count == 2
    x2, y2 = corpus(5, n=4)
    rec = _Scores()
    jnet.set_listeners(rec)
    jnet.fit(x2, y2, epochs=1, batch_size=4, shuffle=False)
    net.fit(x2, y2, epochs=1, batch_size=4, shuffle=False)
    np.testing.assert_allclose(net.score_value, rec.scores[-1],
                               rtol=LOSS_RTOL)
    assert_params_close(to_numpy_params(jnet.params), net, 1)


def test_packed_runs_and_update_groups():
    net = port_lm(to_numpy_params(jax_lm().params))
    assert net._packed_runs() == [[2, 3]]
    assert net._update_groups() == [[0], [2, 3], [4]]
    assert all(type(l.updater) is Adam for l in net.layers)
    assert set(net.updater_state) == {"0", "2", "3", "4"}
    assert set(net.updater_state["2"]["attn_Wq"]) == {"m", "v"}


def test_sgd_layers_update_per_leaf():
    net = port_lm(to_numpy_params(jax_lm().params))
    for layer in net.layers:
        layer.updater = Sgd(0.1)
    before = to_jax_params(net)
    x, y = corpus(6, n=4)
    net.fit(x, y, epochs=1, batch_size=4)
    after = to_jax_params(net)
    assert not np.array_equal(after["4"]["W"], before["4"]["W"])


def test_fit_refuses_what_is_not_ported():
    """`steps_per_execution` and `data_format` train now, as JAX's `fit`
    does: two steps in one group against JAX's fused fit, then a
    data_format JAX names (native, and NCW on [B, T] ids, which JAX
    refuses as the port does)."""
    jnet = jax_lm()
    net = port_lm(to_numpy_params(jnet.params))
    x, y = corpus(7, n=4)
    net.fit(x, y, batch_size=2, shuffle=False, steps_per_execution=2)
    jnet.fit(x, y, batch_size=2, shuffle=False, steps_per_execution=2)
    assert net.iteration_count == jnet.iteration_count == 2
    np.testing.assert_allclose(net.score_value, jnet.score_value,
                               rtol=LOSS_RTOL)
    assert_params_close(jnet.params, net, 2)
    net.fit(ArrayDataSetIterator(x, y), data_format="native")
    with pytest.raises(ValueError):
        jnet.fit(JaxIterator(x, y), data_format="NCW")
    with pytest.raises(ValueError):
        net.fit(ArrayDataSetIterator(x, y), data_format="NCW")
    net.layers[0].l2 = 1e-4              # l2 trains now (its parity with
    net.fit(x, y)                        # JAX: test_torch_port_regularization)
    net.layers[0].l2 = 0.0
    with pytest.raises(ValueError):
        net.fit(x + 0.5, y)                       # ids must be whole
    with pytest.raises(ValueError):
        net.fit(x + V, y)                         # and in range
    # a label mask trains too (test_torch_port_masks holds it to JAX)
    net.fit(DataSet(x, y, labels_mask=np.ones(x.shape, np.float32)))
    assert np.isfinite(net.score_value)
    # a learning rate is a number or a `Schedule`; another object that
    # happens to have `value_at` is refused
    net.layers[-1].updater = Adam(learning_rate=_Schedule())
    with pytest.raises(TypeError):
        net.fit(x, y)
    assert net.score(DataSet(x, y)) > 0


class _Schedule:
    def value_at(self, step):
        return 1e-3
