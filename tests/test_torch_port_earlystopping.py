"""Early stopping, transfer learning and the normalizers in the port
against the JAX package's, on the CPU: every termination condition on
one score sequence, both savers, both score calculators, the
EarlyStoppingTrainer (scores, best epoch, termination) and its resume
through the fault checkpointer, `TransferLearning` and
`TransferLearningHelper` outputs and training on the same params, the
normalizers' statistics (masked too) and transforms, and a model zip
that carries a normalizer in both directions.

Tolerances: scores and outputs within 1e-5 relative (fp32 sums of the
two packages differ in their last bits); the normalizers are host numpy
in both packages and equal bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets import normalizers as jn
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.earlystopping import conditions as jc
from deeplearning4j_tpu.earlystopping.config import (
    EarlyStoppingConfiguration as JaxESConf,
)
from deeplearning4j_tpu.earlystopping.savers import (
    InMemoryModelSaver as JaxInMemorySaver,
)
from deeplearning4j_tpu.earlystopping.scorecalc import (
    ClassificationScoreCalculator as JaxClassCalc,
)
from deeplearning4j_tpu.earlystopping.scorecalc import (
    DataSetLossCalculator as JaxLossCalc,
)
from deeplearning4j_tpu.earlystopping.trainer import (
    EarlyStoppingTrainer as JaxESTrainer,
)
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.transferlearning import transfer as jt
from deeplearning4j_tpu.util.serializer import (
    ModelSerializer as JaxSerializer,
)
from deeplearning4j_tpu_torch.common.updaters import Sgd
from deeplearning4j_tpu_torch.datasets import normalizers as pn
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    DataSet,
)
from deeplearning4j_tpu_torch.earlystopping import (
    ClassificationScoreCalculator,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileModelSaver,
    TerminationReason,
)
from deeplearning4j_tpu_torch.earlystopping import conditions as pc
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.transferlearning import (
    FineTuneConfiguration,
    TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def mlp_conf(seed=7, width=8, n_out=3):
    return (JaxBuilder.builder().seed(seed).updater(JaxSgd(0.2)).list()
            .layer(jl.DenseLayer(n_in=6, n_out=width, activation="tanh"))
            .layer(jl.DenseLayer(n_in=width, n_out=width, activation="tanh"))
            .layer(jl.OutputLayer(n_in=width, n_out=n_out,
                                  activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(6)).build())


def pair(conf):
    """A JAX net and the port's net with the same params."""
    jnet = JaxNet(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    from_jax_params(net, to_numpy_params(jnet.params))
    return jnet, net


def data(n=48, seed=0, n_out=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def params_close(net, jparams, rtol=RTOL):
    got = to_jax_params(net)
    for lk, lp in to_numpy_params(jparams).items():
        for name, w in lp.items():
            scale = max(1.0, float(np.abs(w).max()))
            assert float(np.abs(got[lk][name] - w).max()) <= rtol * scale, (
                lk, name)


# -------------------------------------------------------------- conditions
SCORES = [1.0, 0.8, 0.85, 0.79, 0.9, 0.95, float("nan"), 2.5]
CONDITIONS = {
    "max_epochs": lambda m: m.MaxEpochsTerminationCondition(4),
    "score_improvement": lambda m:
        m.ScoreImprovementEpochTerminationCondition(1, 0.005),
    "max_score": lambda m: m.MaxScoreIterationTerminationCondition(0.9),
    "max_time": lambda m: m.MaxTimeIterationTerminationCondition(3600.0),
    "invalid_score": lambda m: m.InvalidScoreIterationTerminationCondition(),
}


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_conditions_decide_as_jax(name):
    got, want = CONDITIONS[name](pc), CONDITIONS[name](jc)
    got.initialize()
    want.initialize()
    epoch = isinstance(got, pc.EpochTerminationCondition)
    assert epoch == isinstance(want, jc.EpochTerminationCondition)
    for i, s in enumerate(SCORES):
        if epoch:
            assert got.terminate(i, s) == want.terminate(i, s), (i, s)
        else:
            assert got.terminate(s) == want.terminate(s), (i, s)
    assert str(got) == str(want)
    for base in ("EpochTerminationCondition",
                 "IterationTerminationCondition"):
        with pytest.raises(NotImplementedError):
            args = (0, 1.0) if base.startswith("Epoch") else (1.0,)
            getattr(pc, base)().terminate(*args)


# ----------------------------------------------------- calculators, savers
def test_score_calculators_match_jax():
    jnet, net = pair(mlp_conf())
    x, y = data(n=40, seed=3)
    for calc, jcalc in (
            (DataSetLossCalculator(ArrayDataSetIterator(x, y, batch_size=16)),
             JaxLossCalc(JaxArrayIterator(x, y, batch_size=16))),
            (DataSetLossCalculator(ArrayDataSetIterator(x, y, batch_size=16),
                                   average=False),
             JaxLossCalc(JaxArrayIterator(x, y, batch_size=16),
                         average=False)),
            (ClassificationScoreCalculator(ArrayDataSetIterator(x, y)),
             JaxClassCalc(JaxArrayIterator(x, y)))):
        np.testing.assert_allclose(calc.calculate_score(net),
                                   jcalc.calculate_score(jnet), rtol=RTOL)


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_savers_keep_an_independent_copy(tmp_path, kind):
    _, net = pair(mlp_conf())
    saver = (InMemoryModelSaver() if kind == "memory"
             else LocalFileModelSaver(tmp_path, device="cpu"))
    x, y = data()
    saver.save_best_model(net, 0.5)
    saver.save_latest_model(net, 0.5)
    want = to_jax_params(net)
    net.fit(x, y)
    for got in (saver.get_best_model(), saver.get_latest_model()):
        g = to_jax_params(got)
        assert all(np.array_equal(g[k][n], want[k][n])
                   for k in want for n in want[k])
        assert got.device.type == "cpu"
    if kind == "file":
        assert saver.best_path.exists()
        back = JaxSerializer.restore_model(saver.best_path)
        params_close(saver.get_best_model(), back.params, rtol=0)


# ---------------------------------------------------------------- trainer
def es_confs(max_epochs, patience, x, y, *, saver=None, jsaver=None):
    mine = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ArrayDataSetIterator(x, y, batch_size=16)),
        model_saver=saver,
        epoch_termination_conditions=[
            pc.MaxEpochsTerminationCondition(max_epochs),
            pc.ScoreImprovementEpochTerminationCondition(patience)],
        iteration_termination_conditions=[
            pc.InvalidScoreIterationTerminationCondition()])
    theirs = JaxESConf(
        score_calculator=JaxLossCalc(JaxArrayIterator(x, y, batch_size=16)),
        model_saver=jsaver,
        epoch_termination_conditions=[
            jc.MaxEpochsTerminationCondition(max_epochs),
            jc.ScoreImprovementEpochTerminationCondition(patience)],
        iteration_termination_conditions=[
            jc.InvalidScoreIterationTerminationCondition()])
    return mine, theirs


def test_trainer_matches_jax_and_resumes(tmp_path):
    """Held-out loss every epoch, MaxEpochs(6) and ScoreImprovement(1):
    the scores, best epoch, total epochs and termination equal JAX's;
    a run stopped after 2 epochs and resumed with `fit(resume=True)`
    through the checkpointer reaches the uninterrupted run's result, and
    JAX resumes the port's checkpoints to the same."""
    x, y = data(n=64, seed=1)
    xh, yh = data(n=32, seed=2)
    conf = mlp_conf()

    def it():
        return ArrayDataSetIterator(x, y, batch_size=16, shuffle=True)

    def jit():
        return JaxArrayIterator(x, y, batch_size=16, shuffle=True)

    jnet, net = pair(conf)
    mine, theirs = es_confs(6, 1, xh, yh, saver=InMemoryModelSaver(),
                            jsaver=JaxInMemorySaver())
    got = EarlyStoppingTrainer(mine, net, it(), device="cpu").fit()
    want = JaxESTrainer(theirs, jnet, jit()).fit()
    assert got.termination_reason.value == want.termination_reason.value
    assert got.termination_details == want.termination_details
    assert got.best_model_epoch == want.best_model_epoch
    assert got.total_epochs == want.total_epochs
    assert set(got.score_vs_epoch) == set(want.score_vs_epoch)
    for e, s in want.score_vs_epoch.items():
        np.testing.assert_allclose(got.score_vs_epoch[e], s, rtol=RTOL)
    params_close(got.best_model, want.best_model.params)
    assert not any(type(l).__name__ == "_IterationGuard"
                   for l in net.listeners)

    _, n1 = pair(conf)
    c1, _ = es_confs(2, 1, xh, yh)
    r1 = EarlyStoppingTrainer(c1, n1, it(), checkpointer=tmp_path / "es",
                              device="cpu").fit()
    assert r1.total_epochs == 2
    _, n2 = pair(conf)
    c2, t2 = es_confs(6, 1, xh, yh)
    r2 = EarlyStoppingTrainer(c2, n2, it(), checkpointer=tmp_path / "es",
                              device="cpu").fit(resume=True)
    assert r2.best_model_epoch == got.best_model_epoch
    assert r2.total_epochs == got.total_epochs
    np.testing.assert_allclose(r2.best_model_score, got.best_model_score,
                               rtol=1e-7)
    jr = JaxESTrainer(t2, JaxNet(conf).init(), jit(),
                      checkpointer=str(tmp_path / "es")).fit(resume=True)
    assert jr.best_model_epoch >= r2.best_model_epoch
    with pytest.raises(ValueError):
        EarlyStoppingTrainer(c2, n2, it(), device="cpu").fit(resume=True)


def test_trainer_stops_on_an_invalid_score():
    x, y = data()
    _, net = pair(mlp_conf())
    with torch.no_grad():
        net.layers[0].W.fill_(float("nan"))
    mine, _ = es_confs(5, 2, x, y)
    res = EarlyStoppingTrainer(mine, net, ArrayDataSetIterator(x, y),
                               device="cpu").fit()
    assert res.termination_reason == TerminationReason.ITERATION_TERMINATION
    assert res.termination_details == "InvalidScore()"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            EarlyStoppingTrainer(mine, net, ArrayDataSetIterator(x, y))


# --------------------------------------------------------- transfer learning
def test_transfer_learning_matches_jax():
    """Freeze layers 0-1, give the head 5 classes and a fine-tune Sgd:
    the new nets' outputs equal, the frozen layers are FrozenLayers
    whose params do not move, and two steps train as JAX's do."""
    jold, old = pair(mlp_conf())
    ftc_j = jt.FineTuneConfiguration(updater=JaxSgd(0.05), seed=11)
    ftc_p = FineTuneConfiguration(updater=Sgd(0.05), seed=11)
    jnew = (jt.TransferLearning.Builder(jold).fine_tune_configuration(ftc_j)
            .set_feature_extractor(1).n_out_replace(2, 5).build())
    new = (TransferLearning.Builder(old).fine_tune_configuration(ftc_p)
           .set_feature_extractor(1).n_out_replace(2, 5)
           .build(device="cpu"))
    assert [type(l).__name__ for l in new.layers] == [
        "FrozenLayer", "FrozenLayer", "OutputLayer"]
    assert new.conf.seed == 11
    x, y = data(n=16, n_out=5)
    np.testing.assert_allclose(new.output(x).numpy(),
                               np.asarray(jnew.output(x)), rtol=RTOL,
                               atol=1e-7)
    frozen = to_jax_params(new)["0"]["W"].copy()
    for _ in range(2):
        new.fit(x, y, batch_size=16)
        jnew.fit(x, y, batch_size=16)
    np.testing.assert_allclose(new.score_value, jnew.score_value, rtol=RTOL)
    params_close(new, jnew.params)
    assert np.array_equal(to_jax_params(new)["0"]["W"], frozen)
    # remove the head, add a new one
    jcut = (jt.TransferLearning.Builder(jold).remove_output_layer()
            .add_layer(jl.OutputLayer(n_in=8, n_out=2, activation="softmax",
                                      loss="mcxent")).build())
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    cut = (TransferLearning.Builder(old).remove_output_layer()
           .add_layer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                                  loss="mcxent")).build(device="cpu"))
    np.testing.assert_allclose(cut.output(x).numpy(),
                               np.asarray(jcut.output(x)), rtol=RTOL,
                               atol=1e-7)
    two = (TransferLearning.Builder(old).remove_layers_from_output(2)
           .build(device="cpu"))
    assert len(two.layers) == 1 and isinstance(
        TransferLearning.Builder(old).set_feature_extractor(0).build(
            device="cpu").layers[0], FrozenLayer)


def test_transfer_learning_helper_matches_jax():
    jnet, net = pair(mlp_conf())
    x, y = data(n=16)
    jh, h = jt.TransferLearningHelper(jnet, 1), TransferLearningHelper(net, 1)
    feats = h.featurize(DataSet(x, y))
    jfeats = jh.featurize(JaxDataSet(x, y))
    np.testing.assert_allclose(feats.features, np.asarray(jfeats.features),
                               rtol=RTOL, atol=1e-7)
    for _ in range(2):
        h.fit_featurized(feats, batch_size=8)
        jh.fit_featurized(jfeats, batch_size=8)
    np.testing.assert_allclose(h.output_from_featurized(feats.features)
                               .numpy(),
                               np.asarray(jh.output_from_featurized(
                                   jfeats.features)), rtol=RTOL, atol=1e-7)
    params_close(net, jnet.params)


# -------------------------------------------------------------- normalizers
def _series(seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 5, 3)) * 3 + 2).astype(np.float32)
    mask = (rng.uniform(size=(6, 5)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    return x, mask


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
@pytest.mark.parametrize("masked", [False, True])
def test_normalizers_match_jax(kind, masked):
    x, mask = _series()
    if kind == "image":
        x = np.random.default_rng(1).integers(0, 256, (4, 6, 6, 1)).astype(
            np.uint8)
        mask = None
    make = {"standardize": lambda m: m.NormalizerStandardize(),
            "minmax": lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
            "image": lambda m: m.ImagePreProcessingScaler(0.0, 1.0)}[kind]
    got, want = make(pn), make(jn)
    fm = mask if masked else None
    batches = [DataSet(x[:3], None, None if fm is None else fm[:3]),
               DataSet(x[3:], None, None if fm is None else fm[3:])]
    jbatches = [JaxDataSet(b.features, None, b.features_mask)
                for b in batches]
    got.fit(batches)
    want.fit(jbatches)
    meta, arrays = got.state()
    wmeta, warrays = want.state()
    assert meta == wmeta
    for k in warrays:
        assert np.array_equal(arrays[k], warrays[k]), k
    t = got.transform(x)
    assert np.array_equal(t, want.transform(x))
    assert np.array_equal(got.revert(t), want.revert(t))
    assert pn.normalizer_to_json(got) == jn.normalizer_to_json(want)
    back = pn.normalizer_from_meta(meta, arrays)
    assert np.array_equal(back.transform(x), t)
    ds = DataSet(x.copy(), None)
    assert np.array_equal(got.pre_process(ds).features, t)


def test_normalizer_refuses_all_masked():
    x, _ = _series()
    with pytest.raises(ValueError):
        pn.NormalizerStandardize().fit(DataSet(x, None,
                                               np.zeros(x.shape[:2])))
    with pytest.raises(ValueError):
        pn.NormalizerMinMaxScaler().fit([])
    with pytest.raises(ValueError):
        pn.normalizer_from_meta({"kind": "nope"}, {})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zip_with_a_normalizer_crosses_the_bridge(tmp_path, writer):
    jnet, net = pair(mlp_conf())
    x, _ = data()
    path = tmp_path / "m.zip"
    if writer == "port":
        norm = pn.NormalizerStandardize().fit(DataSet(x, None))
        ModelSerializer.write_model(net, path)
        ModelSerializer.add_normalizer_to_model(path, norm)
        with pytest.raises(ValueError):
            ModelSerializer.add_normalizer_to_model(path, norm)
        back = JaxSerializer.restore_normalizer_from_file(path)
        model = JaxSerializer.restore_model(path)
        params_close(net, model.params, rtol=0)
    else:
        norm = jn.NormalizerStandardize().fit(JaxDataSet(x, None))
        JaxSerializer.write_model(jnet, path)
        JaxSerializer.add_normalizer_to_model(path, norm)
        back = ModelSerializer.restore_normalizer_from_file(path)
        model = ModelSerializer.restore_model(path, device="cpu")
        params_close(model, jnet.params, rtol=0)
    assert np.array_equal(back.transform(x), norm.transform(x))
    plain = tmp_path / "plain.zip"
    ModelSerializer.write_model(net, plain)
    assert ModelSerializer.restore_normalizer_from_file(plain) is None
    assert math.isfinite(float(np.abs(back.transform(x)).max()))
