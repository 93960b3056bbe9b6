"""The zoo's `TransformerClassifier`, the evaluators and the training
listeners of the port against the JAX package, on the CPU, with a tiny
classifier (vocab 64, 4 classes, d_model 32, 2 blocks, 2 heads, max_len
32) on padded batches: seeded lengths, 0-padding, a features mask, and
labels from a rule the model can learn (most tokens of a class-c
sequence come from class c's band of the vocabulary).

- `conf()` equals JAX's `to_dict()` for each pooling type, with and
  without dropout; `output(mask=)` within 1e-5 of JAX's from the same
  params.
- `fit` with block dropout and the features mask: three steps against
  JAX's `fit`, loss rtol 1e-5, params and Adam's m and v by relative
  Frobenius difference within 1e-4 (the training tests' PARAM_RTOL; the
  masked pooled gradient reaches few positions, so Adam turns rounding
  in near-zero gradients into fractions of a step, as in
  `tests/test_torch_port_masks.py`), `attn_bk` to Adam's step bound;
  `mixed_bf16` within the mixed band (step 0 rtol 1e-2, 5% of the
  initial loss).
- The evaluators (`eval/`, the port's own copies) give the same JSON as
  JAX's on the same outputs and masks; `evaluate*` of the two nets
  agree in counts (the outputs agree within 1e-5 and no prediction sits
  at a near-tie, which the test checks).
- Listeners: the same callbacks in the same order with the same
  iterations and epochs as JAX's fit loop makes them.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEvaluation
from deeplearning4j_tpu.eval.regression import (
    RegressionEvaluation as JaxRegression,
)
from deeplearning4j_tpu.eval.roc import (
    ROC as JaxROC,
    ROCBinary as JaxROCBinary,
    ROCMultiClass as JaxROCMultiClass,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu.zoo.transformer import (
    TransformerClassifier as JaxClassifier,
)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.eval import (
    ROC,
    Evaluation,
    RegressionEvaluation,
    ROCBinary,
    ROCMultiClass,
)
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners as plis
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_jax_updater_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerClassifier

V, C, D, LAYERS, HEADS, MAXLEN, T, B = 64, 4, 32, 2, 2, 32, 24, 4
KW = dict(d_model=D, n_layers=LAYERS, n_heads=HEADS, max_len=MAXLEN)
ATOL, LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
STEP0_RTOL, BAND = 1e-2, 0.05
ADAM_STEP_MAX = 1e-3 * 0.1 / np.sqrt(1e-3)


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def padded(seed, n, classes=C):
    """Token ids [n, T] (float-carried, 0 past each length), the features
    mask, and one-hot labels. The rule: a sequence of class c draws
    each token from class c's band of the vocabulary with probability
    0.7, else from the whole vocabulary."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, T + 1, n)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    cls = rng.integers(0, classes, n)
    band = (V - 1) // classes
    own = 1 + cls[:, None] * band + rng.integers(0, band, (n, T))
    ids = np.where(rng.random((n, T)) < 0.7, own,
                   rng.integers(1, V, (n, T))) * mask
    labels = np.eye(classes, dtype=np.float32)[cls]
    return ids.astype(np.float32), mask, labels


def pair(policy=None, **kw):
    """JAX's classifier and the port's from its configuration JSON, with
    the JAX net's params."""
    jnet = JaxNet(JaxClassifier(V, C, **KW, **kw).conf(),
                  dtype_policy=policy).init(7)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu", dtype_policy=policy)
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("pooling", ["avg", "max", "sum", "pnorm"])
@pytest.mark.parametrize("dropout", [None, 0.9])
def test_conf_matches_jax(pooling, dropout):
    want = JaxClassifier(V, C, **KW, pooling=pooling,
                         dropout=dropout).conf()
    got = TransformerClassifier(V, C, **KW, pooling=pooling,
                                dropout=dropout).conf()
    assert got.to_dict() == want.to_dict()
    assert MultiLayerConfiguration.from_json(want.to_json()).to_dict() == \
        want.to_dict()


def test_init_follows_transformer_lm():
    net = TransformerClassifier(V, C, **KW).init(device="cpu")
    again = TransformerClassifier(V, C, **KW).init(device="cpu")
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)
    ids, mask, _ = padded(0, 3)
    probs = net.output(ids, mask=mask)
    assert probs.shape == (3, C)
    torch.testing.assert_close(probs.sum(-1), torch.ones(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerClassifier(V, C, **KW).init()    # the card by default


@pytest.mark.parametrize("pooling", ["avg", "max", "pnorm"])
def test_output_with_a_mask_matches_jax(pooling):
    jnet, net = pair(pooling=pooling)
    ids, mask, _ = padded(1, 5)
    want = np.asarray(jnet.output(ids, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(net.output(ids, mask=mask).numpy(), want,
                               atol=ATOL, rtol=ATOL)
    # the padding tokens do not reach the pooled output: other tokens in
    # the padded tail give the same probabilities
    junk = ids + (1 - mask) * 5
    np.testing.assert_allclose(net.output(junk, mask=mask).numpy(),
                               net.output(ids, mask=mask).numpy(),
                               atol=1e-6)


class _Scores(jlis.TrainingListener, plis.TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def _fit_pair(policy=None, steps=3):
    jnet, net = pair(policy, dropout=0.9)
    ids, mask, labels = padded(2, steps * B)
    rec, mine = _Scores(), _Scores()
    jnet.set_listeners(rec)
    net.set_listeners(mine)
    jnet.fit(JaxDataSet(ids, labels, features_mask=mask), batch_size=B)
    net.fit(DataSet(ids, labels, features_mask=mask), batch_size=B)
    return jnet, rec.scores, net, mine.scores


def test_fit_with_dropout_and_masks_matches_jax():
    jnet, jl, net, pl = _fit_pair()
    assert len(pl) == len(jl) == 3
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    got, ust = to_jax_params(net), to_jax_updater_state(net)
    for lk, lp in to_numpy_params(jnet.params).items():
        for name, w in lp.items():
            diff = got[lk][name] - w
            if name == "attn_bk":
                assert np.abs(diff).max() <= 2 * 3 * ADAM_STEP_MAX
                continue
            assert np.linalg.norm(diff) <= PARAM_RTOL * np.linalg.norm(w), (
                lk, name)
            for sk, ws in jnet.updater_state[lk][name].items():
                ws = np.asarray(ws)
                assert np.linalg.norm(ust[lk][name][sk] - ws) <= \
                    PARAM_RTOL * max(np.linalg.norm(ws), 1e-30), (lk, name)


def test_mixed_fit_follows_jax():
    _, jl, net, pl = _fit_pair("mixed_bf16")
    assert abs(pl[0] - jl[0]) <= STEP0_RTOL * jl[0], (pl, jl)
    for a, b in zip(pl, jl):
        assert abs(a - b) <= BAND * jl[0], (pl, jl)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_the_classifier_learns_its_rule():
    net = TransformerClassifier(V, C, **KW, dropout=0.9).init(
        device="cpu")
    ids, mask, labels = padded(3, 64)
    ds = DataSet(ids, labels, features_mask=mask)
    before = net.evaluate(ds).accuracy()
    net.fit(ds, epochs=8, batch_size=16)
    assert net.evaluate(ds).accuracy() > max(before, 0.5)


# -------------------------------------------------------------- evaluators
def _probs(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape)
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    labels = np.eye(shape[-1])[rng.integers(0, shape[-1], shape[:-1])]
    return p.astype(np.float32), labels.astype(np.float32)


EVALUATORS = {
    "evaluation": (lambda: JaxEvaluation(), lambda: Evaluation()),
    "evaluation_top2": (lambda: JaxEvaluation(top_n=2),
                        lambda: Evaluation(top_n=2)),
    "roc_multi_class": (lambda: JaxROCMultiClass(),
                        lambda: ROCMultiClass()),
    "roc_multi_class_steps": (lambda: JaxROCMultiClass(threshold_steps=20),
                              lambda: ROCMultiClass(threshold_steps=20)),
    "roc_binary": (lambda: JaxROCBinary(), lambda: ROCBinary()),
    "regression": (lambda: JaxRegression(), lambda: RegressionEvaluation()),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
@pytest.mark.parametrize("time_series", [False, True])
def test_evaluators_match_jax_on_the_same_outputs(name, time_series):
    make_j, make_p = EVALUATORS[name]
    shape = (6, 5, C) if time_series else (12, C)
    ej, ep = make_j(), make_p()
    for seed in (0, 1):
        probs, labels = _probs(seed, shape)
        mask = ((np.random.default_rng(seed + 9).random(shape[:-1]) > 0.3)
                .astype(np.float32) if time_series else None)
        ej.eval(labels, probs, mask=mask)
        ep.eval(labels, probs, mask=mask)
    assert ep.to_json() == ej.to_json()


def test_binary_roc_matches_jax():
    probs, labels = _probs(4, (40, 2))
    ej, ep = JaxROC(), ROC()
    ej.eval(labels, probs)
    ep.eval(labels, probs)
    assert ep.calculate_auc() == ej.calculate_auc()
    assert ep.to_json() == ej.to_json()


def test_net_evaluate_matches_jax():
    jnet, net = pair(dropout=0.9)
    ids, mask, labels = padded(5, 48)
    out = net.output(ids, mask=mask).numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.output(
        ids, mask=jnp.asarray(mask))), atol=ATOL)
    top2 = np.sort(out, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 10 * ATOL   # no near-ties
    jds, ds = (JaxDataSet(ids, labels, features_mask=mask),
               DataSet(ids, labels, features_mask=mask))
    e, je = net.evaluate(ds), jnet.evaluate(jds)
    assert np.array_equal(e.confusion.matrix, je.confusion.matrix)
    assert e.accuracy() == je.accuracy()
    r, jr = (net.evaluate_roc_multi_class(ds),
             jnet.evaluate_roc_multi_class(jds))
    for c in range(C):
        np.testing.assert_allclose(r.calculate_auc(c), jr.calculate_auc(c),
                                   atol=1e-6)
    reg, jreg = net.evaluate_regression(ds), jnet.evaluate_regression(jds)
    np.testing.assert_allclose(reg.mean_squared_error(0),
                               jreg.mean_squared_error(0), rtol=1e-5)


def test_binary_classifier_evaluate_roc_matches_jax():
    jnet = JaxNet(JaxClassifier(V, 2, **KW).conf()).init(3)
    net = from_jax_params(MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu"), to_numpy_params(jnet.params))
    ids, mask, labels = padded(6, 32, classes=2)
    r = net.evaluate_roc(DataSet(ids, labels, features_mask=mask))
    jr = jnet.evaluate_roc(JaxDataSet(ids, labels, features_mask=mask))
    np.testing.assert_allclose(r.calculate_auc(), jr.calculate_auc(),
                               atol=1e-6)


# --------------------------------------------------------------- listeners
class _Calls(jlis.TrainingListener, plis.TrainingListener):
    def __init__(self):
        self.calls = []

    def on_fit_start(self, model):
        self.calls.append(("fit_start",))

    def on_epoch_start(self, model, epoch):
        self.calls.append(("epoch_start", epoch))

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.calls.append(("iteration", iteration, epoch,
                           info["batch_size"], len(info["batch"])))

    def on_epoch_end(self, model, epoch):
        self.calls.append(("epoch_end", epoch))

    def on_fit_end(self, model):
        self.calls.append(("fit_end",))


def test_listener_calls_match_jax_in_order_and_count():
    jnet, net = pair()
    ids, mask, labels = padded(7, 10)
    jc, pc = _Calls(), _Calls()
    jnet.add_listener(jc)
    net.add_listener(pc)
    for _ in range(2):        # two fits: the counters carry on
        jnet.fit(JaxDataSet(ids, labels, features_mask=mask), epochs=2,
                 batch_size=4)
        net.fit(DataSet(ids, labels, features_mask=mask), epochs=2,
                batch_size=4)
    assert pc.calls == jc.calls
    assert sum(c[0] == "iteration" for c in pc.calls) == 2 * 2 * 3
    assert net.set_listeners() is net and net.listeners == []


def test_the_shipped_listeners_follow_jax():
    jnet, net = pair()
    ids, mask, labels = padded(8, 12)
    out = {"j": [], "p": []}

    def make(mod, key):
        return [mod.ScoreIterationListener(2, printer=out[key].append),
                mod.CollectScoresListener(frequency=2),
                mod.PerformanceListener(printer=out[key].append, sync=True),
                mod.TimeIterationListener(6, frequency=2,
                                          printer=out[key].append),
                mod.EvaluativeListener(
                    (JaxDataSet if key == "j" else DataSet)(
                        ids, labels, features_mask=mask),
                    invocation="epoch_end", printer=out[key].append)]
    jl, pl = make(jlis, "j"), make(plis, "p")
    jnet.set_listeners(*jl)
    net.set_listeners(*pl)
    jnet.fit(JaxDataSet(ids, labels, features_mask=mask), epochs=2,
             batch_size=4)
    net.fit(DataSet(ids, labels, features_mask=mask), epochs=2,
            batch_size=4)
    assert [len(v) for v in out["p"]] and len(out["p"]) == len(out["j"])
    assert [s.split(" is ")[0] for s in out["p"] if "Score" in s] == \
        [s.split(" is ")[0] for s in out["j"] if "Score" in s]
    assert [i for i, _ in pl[1].scores] == [i for i, _ in jl[1].scores]
    np.testing.assert_allclose([s for _, s in pl[1].scores],
                               [s for _, s in jl[1].scores], rtol=1e-4)
    assert [h["iteration"] for h in pl[2].history] == \
        [h["iteration"] for h in jl[2].history]
    assert len(pl[4].evaluations) == len(jl[4].evaluations) == 2
    assert [e.accuracy() for e in pl[4].evaluations] == \
        [e.accuracy() for e in jl[4].evaluations]
