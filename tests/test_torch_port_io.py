"""The port's IO layer held against the JAX package's on the CPU: the
native CSV loader, the shim build, `ModelGuesser`, the sklearn
estimators and the S3 adapters.

- `native_csv`: the port's shim against its numpy path against JAX's
  loader on tests/test_data_misc.py::TestNativeCsv's files (and a
  quirks file), `load_csv_dataset` equal to JAX's. The port's shim
  rejects a partly numeric field ("1,0" quoted, "12abc") as its numpy
  path does; JAX's shim reads its numeric head (see `test_partly_
  numeric_fields`).
- The shims build under build/native/, named by a hash, never beside a
  source.
- `ModelGuesser` over every file class both packages read: model zips
  written by either package, a Keras .h5, MLN/graph/Keras-architecture
  JSON and YAML; the same class, configuration and outputs as JAX's.
- `NetworkEstimator` and `AutoEncoderEstimator`: the init equal to
  JAX's, predictions after `fit` within 1e-5, sklearn `clone` and
  `Pipeline`, a TrainingMaster fit, and the fallback base with sklearn
  hidden.
- S3 against a fake client, and the lazy boto3 error.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import importlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import native_csv as JC
from deeplearning4j_tpu.util.guesser import ModelGuesser as JaxGuesser
from deeplearning4j_tpu_torch.datasets import native_csv as PC
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import native_build
from deeplearning4j_tpu_torch.util.guesser import ModelGuesser
from deeplearning4j_tpu_torch.util.jax_params import (
    to_jax_params,
    to_numpy_params,
)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "keras")
PRED_ATOL = 1e-5
# a drawn init against JAX's: erfinv's last place (tests/test_torch_port_
# keys.py), of each tensor's largest |value|
INIT_RTOL = 1e-5


def assert_init_close(got, want):
    """{key: {name: array}} trees equal up to INIT_RTOL."""
    assert set(got) == {k for k, v in want.items() if v}
    for k, lv in got.items():
        for n, a in lv.items():
            err = np.abs(a - want[k][n]).max() / max(
                np.abs(want[k][n]).max(), 1e-30)
            assert err <= INIT_RTOL, (k, n, err)

# tests/test_data_misc.py::TestNativeCsv's files, and one of every quirk
CSV_FILES = {
    "header_comments_crlf_nan": ("a,b,c\r\n# comment line\r\n1,2,3\r\n"
                                 "4,oops,6\r\n", ",", 1),
    "classification": ("1.0,2.0,0\n3.0,4.0,2\n5.0,6.0,1\n", ",", 0),
    "semicolons": ("1.0;2.0;0.5\n3.0;4.0;1.5\n", ";", 0),
    "quoted_delimiter": ('"1,234",5\n7,8\n', ",", 0),
    "comments_before_header": ("# generated\ncolA,colB\n1,2\n3,4\n", ",", 1),
    "ragged": ('"1,234",5\n7\n8,9\n', ",", 0),
    "quirks": ('# a comment line\n"a","b",c\n1,2,3\n\n"4.5",x,6\r\n'
               '# another\n7,8\n9,"1,0",11,12\n  13 , 14 ,15\n'
               '\t16\t,"17" ,12abc\n', ",", 1),
}
# fields JAX's shim reads by their numeric head (strtof's prefix), where
# both numpy paths and the port's shim say NaN: (file, row, col)
JAX_SHIM_PREFIX_READS = {("quoted_delimiter", 0, 0), ("ragged", 0, 0),
                         ("quirks", 3, 1), ("quirks", 5, 2)}


def _write(tmp_path, name, text):
    p = tmp_path / f"{name}.csv"
    p.write_bytes(text.encode())
    return str(p)


# ------------------------------------------------------------- native CSV
class TestNativeCsv:
    @pytest.mark.parametrize("name", sorted(CSV_FILES))
    def test_shim_numpy_path_and_jax(self, tmp_path, name):
        text, delim, skip = CSV_FILES[name]
        path = _write(tmp_path, name, text)
        assert PC.native_available()
        got = PC.load_csv_matrix(path, delimiter=delim, skip_header=skip)
        plain = PC._numpy_fallback(path, delim, skip)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(
            plain, JC._numpy_fallback(path, delim, skip))
        jax = JC.load_csv_matrix(path, delimiter=delim, skip_header=skip)
        assert jax.shape == got.shape
        prefix = np.zeros(got.shape, bool)
        for f, r, c in JAX_SHIM_PREFIX_READS:
            if f == name:
                prefix[r, c] = True
        np.testing.assert_array_equal(got[~prefix], jax[~prefix])
        assert np.isnan(got[prefix]).all() and not np.isnan(
            jax[prefix]).any()

    def test_matrix_parse_round_trips_bit_for_bit(self, tmp_path):
        rng = np.random.default_rng(0)
        m = rng.standard_normal((500, 7)).astype(np.float32)
        path = str(tmp_path / "m.csv")
        np.savetxt(path, m, fmt="%.9g", delimiter=",")
        got = PC.load_csv_matrix(path)
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(got, JC.load_csv_matrix(path))

    def test_partly_numeric_fields(self, tmp_path):
        """The port's shim holds a field to one number, as both numpy
        paths do; JAX's shim reads "12abc" as 12 and the quoted "1,0"
        as 1."""
        path = _write(tmp_path, "partly", '12abc,"1,0",3\n')
        np.testing.assert_array_equal(PC.load_csv_matrix(path),
                                      [[np.nan, np.nan, 3]])
        np.testing.assert_array_equal(JC.load_csv_matrix(path), [[12, 1, 3]])
        np.testing.assert_array_equal(JC._numpy_fallback(path, ",", 0),
                                      [[np.nan, np.nan, 3]])

    def test_csv_dataset_against_jax(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets import DataSet
        path = _write(tmp_path, "cls", CSV_FILES["classification"][0])
        ds = PC.load_csv_dataset(path, label_index=-1)
        jds = JC.load_csv_dataset(path, label_index=-1)
        assert isinstance(ds, DataSet)
        np.testing.assert_array_equal(ds.features, jds.features)
        np.testing.assert_array_equal(ds.labels, jds.labels)
        ds = PC.load_csv_dataset(path, label_index=0, num_classes=6)
        jds = JC.load_csv_dataset(path, label_index=0, num_classes=6)
        np.testing.assert_array_equal(ds.labels, jds.labels)
        path = _write(tmp_path, "reg", CSV_FILES["semicolons"][0])
        ds = PC.load_csv_dataset(path, regression=True, delimiter=";")
        assert ds.labels.ravel().tolist() == [0.5, 1.5]

    @pytest.mark.parametrize("text,match", [
        ("1.0,2.0,cat\n3.0,4.0,1\n", "non-numeric"),
        ("1.0,2.0,0.5\n", "integers"),
        ("1.0,2.0,-1\n", "integers"),
        ("1.0,2.0,3\n", "num_classes")])
    def test_bad_class_labels_raise(self, tmp_path, text, match):
        path = _write(tmp_path, "bad", text)
        kw = {"num_classes": 2} if match == "num_classes" else {}
        for load in (PC.load_csv_dataset, JC.load_csv_dataset):
            with pytest.raises(ValueError, match=match):
                load(path, **kw)

    def test_missing_file_and_numpy_path(self, tmp_path, monkeypatch):
        with pytest.raises(FileNotFoundError):
            PC.load_csv_matrix(str(tmp_path / "absent.csv"))
        path = _write(tmp_path, "q", CSV_FILES["quirks"][0])
        want = PC.load_csv_matrix(path, skip_header=1)
        # a host where the shim does not build parses with the numpy path
        monkeypatch.setattr(PC, "_lib", None)
        monkeypatch.setattr(PC, "_lib_failed", True)
        assert not PC.native_available()
        np.testing.assert_array_equal(PC.load_csv_matrix(path,
                                                         skip_header=1),
                                      want)


class TestNativeBuild:
    def test_shims_build_under_build_native_only(self):
        from deeplearning4j_tpu_torch.modelimport import hdf5 as H5
        PC.native_available()
        H5._load_lib()
        build = os.path.join(REPO, "build", "native")
        for src, soname in ((PC._SRC, "libdl4j_csv.so"),
                            (H5._SRC, "libdl4j_hdf5.so")):
            flags = ["-O3"] if soname == "libdl4j_csv.so" else []
            so = native_build.so_path(src, soname, flags)
            assert str(so.parent) == build and so.exists()
            assert so.name.startswith(soname[:-3] + "-")
            assert str(src).startswith(os.path.join(
                REPO, "deeplearning4j_tpu_torch", "native"))
            assert not any(f.endswith(".so") for f in os.listdir(src.parent))

    def test_hash_moves_with_source_and_flags(self, tmp_path):
        src = tmp_path / "x.cpp"
        src.write_text("extern \"C\" int f() { return 1; }\n")
        a = native_build.so_path(src, "libx.so")
        assert native_build.so_path(src, "libx.so", ["-O3"]) != a
        src.write_text("extern \"C\" int f() { return 2; }\n")
        assert native_build.so_path(src, "libx.so") != a

    def test_failed_build_names_every_attempt(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
        src = tmp_path / "broken.cpp"
        src.write_text("this is not C++\n")
        with pytest.raises(RuntimeError,
                           match=r"(?s)\[-lnope1\].*\[-lnope2\]"):
            native_build.build(src, "libbroken.so",
                               link_candidates=["-lnope1", "-lnope2"])
        assert not list((tmp_path / "b").glob("*.so"))


# ------------------------------------------------------------ ModelGuesser
def _jax_mln():
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .list()
            .layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(OutputLayer(n_in=8, n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    return JMLN(conf).init()


def _jax_graph_conf():
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.graph import (
        ComputationGraphConfiguration as JCGC)
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    return (JCGC.graph_builder(
        NeuralNetConfiguration.builder().updater(Adam(1e-3)))
        .add_inputs("in")
        .add_layer("d", DenseLayer(n_in=4, n_out=8), "in")
        .add_layer("out", OutputLayer(n_in=8, n_out=2), "d")
        .set_outputs("out").build())


def _same_model(got, jnet, x, drawn=False):
    """The same class, configuration, params (bit for bit when read from
    a file; up to INIT_RTOL when `drawn` from the seed) and outputs."""
    assert type(got).__name__ == type(jnet).__name__
    assert got.conf.to_dict() == jnet.conf.to_dict()
    want = to_numpy_params(jnet.params)
    if drawn:
        assert_init_close(to_jax_params(got), want)
    else:
        for k, lv in to_jax_params(got).items():
            for n, a in lv.items():
                np.testing.assert_array_equal(a, want[k][n])
    out = got.output(x)
    out = out[0] if isinstance(out, (list, tuple)) else out
    jout = jnet.output(x)
    jout = jout[0] if isinstance(jout, (list, tuple)) else jout
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


X4 = np.random.default_rng(3).standard_normal((5, 4)).astype(np.float32)


class TestModelGuesser:
    def test_zips_of_either_package(self, tmp_path):
        from deeplearning4j_tpu.util.serializer import (
            ModelSerializer as JaxSerializer)
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        jnet = _jax_mln()
        jzip = tmp_path / "jax.zip"
        JaxSerializer.write_model(jnet, jzip)
        got = ModelGuesser.load_model_guess(jzip, device=CPU)
        assert isinstance(got, MultiLayerNetwork)
        _same_model(got, jnet, X4)
        pzip = tmp_path / "port.zip"
        ModelSerializer.write_model(got, pzip)
        _same_model(ModelGuesser.load_model_guess(pzip, device=CPU),
                    JaxGuesser.load_model_guess(pzip), X4)
        conf = ModelGuesser.load_config_guess(pzip)
        assert isinstance(conf, MultiLayerConfiguration)
        assert conf.to_dict() == JaxGuesser.load_config_guess(
            pzip).to_dict()

    def test_keras_h5(self, tmp_path):
        path = os.path.join(FIXDIR, "real_cnn.h5")
        got = ModelGuesser.load_model_guess(path, device=CPU)
        preds = np.load(os.path.join(FIXDIR, "predictions.npz"))
        _same_model(got, JaxGuesser.load_model_guess(path), preds["cnn_x"])
        assert (ModelGuesser.load_config_guess(path).to_dict()
                == JaxGuesser.load_config_guess(path).to_dict())

    def test_weights_only_h5_is_refused(self):
        path = os.path.join(FIXDIR, "real_cnn.weights.h5")
        for guess in (JaxGuesser.load_model_guess,
                      lambda p: ModelGuesser.load_model_guess(p, device=CPU)):
            with pytest.raises(ValueError, match="no model_config"):
                guess(path)

    @pytest.mark.parametrize("kind", ["mln", "graph", "keras", "mln_yaml"])
    def test_config_files(self, tmp_path, kind):
        if kind == "graph":
            text = _jax_graph_conf().to_json()
        elif kind == "keras":
            text = json.dumps({"class_name": "Sequential", "config": [
                {"class_name": "Dense", "config": {
                    "name": "d", "units": 3, "activation": "relu",
                    "use_bias": True, "batch_input_shape": [None, 4]}}]})
        else:
            text = _jax_mln().conf.to_json()
            if kind == "mln_yaml":
                yaml = pytest.importorskip("yaml")
                text = yaml.safe_dump(json.loads(text))
        path = tmp_path / f"{kind}.conf"
        path.write_text(text)
        conf = ModelGuesser.load_config_guess(path)
        jconf = JaxGuesser.load_config_guess(path)
        assert type(conf).__name__ == type(jconf).__name__
        assert conf.to_dict() == jconf.to_dict()
        net = ModelGuesser.load_model_guess(path, device=CPU)
        jnet = JaxGuesser.load_model_guess(path)
        assert isinstance(net, ComputationGraph if kind == "graph"
                          else MultiLayerNetwork)
        _same_model(net, jnet, X4, drawn=True)

    def test_unknown_files_raise(self, tmp_path):
        bad = tmp_path / "junk.bin"
        bad.write_bytes(b"garbage")
        with pytest.raises(ValueError):
            ModelGuesser.load_model_guess(bad, device=CPU)
        z = tmp_path / "other.zip"
        import zipfile
        with zipfile.ZipFile(z, "w") as zf:
            zf.writestr("x.txt", "x")
        with pytest.raises(ValueError, match="configuration.json"):
            ModelGuesser.load_config_guess(z)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                ModelGuesser.load_model_guess(bad)

    def test_normalizer_in_a_zip(self, tmp_path):
        from deeplearning4j_tpu_torch.datasets import DataSet
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            NormalizerStandardize)
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        net = ModelGuesser.load_model_guess(
            self._conf_file(tmp_path), device=CPU)
        path = tmp_path / "with_norm.zip"
        ModelSerializer.write_model(net, path)
        assert ModelGuesser.load_normalizer(path) is None
        norm = NormalizerStandardize()
        norm.fit(DataSet(np.random.default_rng(0).standard_normal(
            (20, 4)).astype(np.float32)))
        ModelSerializer.add_normalizer_to_model(path, norm)
        back = ModelGuesser.load_normalizer(path)
        np.testing.assert_allclose(back.mean, norm.mean)

    @staticmethod
    def _conf_file(tmp_path):
        p = tmp_path / "c.json"
        p.write_text(_jax_mln().conf.to_json())
        return p


# -------------------------------------------------------------- estimators
def _iris_confs():
    """The JAX estimator tests' iris configuration in both packages."""
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    conf = (NeuralNetConfiguration.builder().seed(42).updater(Adam(0.02))
            .list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    text = conf.to_json()
    from deeplearning4j_tpu.nn.conf.builder import (
        MultiLayerConfiguration as JMLC)
    return (lambda: JMLC.from_json(text),
            lambda: MultiLayerConfiguration.from_json(text))


def _iris():
    from deeplearning4j_tpu.datasets.fetchers import load_iris
    x, y = load_iris()
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


def _estimators():
    from deeplearning4j_tpu.ml import estimator as JE
    from deeplearning4j_tpu_torch.ml import estimator as PE
    return JE, PE


class TestNetworkEstimator:
    def test_init_equal_to_jax(self):
        JE, PE = _estimators()
        jf, pf = _iris_confs()
        x, y = _iris()
        j = JE.NetworkEstimator(jf, epochs=0).fit(x, y.argmax(1))
        p = PE.NetworkEstimator(pf, epochs=0, device=CPU).fit(x,
                                                              y.argmax(1))
        assert_init_close(to_jax_params(p.model_),
                          to_numpy_params(j.model_.params))

    def test_fit_predict_score_against_jax(self):
        JE, PE = _estimators()
        jf, pf = _iris_confs()
        x, y = _iris()
        j = JE.NetworkEstimator(jf, epochs=5, batch_size=50).fit(
            x, y.argmax(1))
        p = PE.NetworkEstimator(pf, epochs=5, batch_size=50, device=CPU)
        assert p.fit(x, y.argmax(1)) is p
        np.testing.assert_allclose(p.predict_proba(x), j.predict_proba(x),
                                   rtol=0, atol=PRED_ATOL)
        assert isinstance(p.predict_proba(x), np.ndarray)
        np.testing.assert_array_equal(p.predict(x), j.predict(x))
        assert p.score(x, y) == j.score(x, y)
        np.testing.assert_array_equal(p.classes_, j.classes_)
        assert p.transform(x).shape == (150, 3)

    def test_one_hot_labels_and_unfitted(self):
        _, PE = _estimators()
        _, pf = _iris_confs()
        x, y = _iris()
        est = PE.NetworkEstimator(pf, epochs=1, device=CPU)
        with pytest.raises(RuntimeError, match="not fitted"):
            est.predict(x)
        est.fit(x, y)
        np.testing.assert_array_equal(est.classes_, np.arange(3))

    def test_device_defaults_to_cuda(self):
        _, PE = _estimators()
        _, pf = _iris_confs()
        est = PE.NetworkEstimator(pf)
        assert est.device == "cuda"
        if not torch.cuda.is_available():
            x, y = _iris()
            with pytest.raises(RuntimeError, match="CUDA"):
                est.fit(x, y)

    def test_training_master(self):
        """A fit through the port's SharedTrainingMaster over a 2-way CPU
        mesh, against JAX's over its 2 virtual devices."""
        import jax
        from jax.sharding import Mesh
        from deeplearning4j_tpu.parallel import (
            SharedTrainingMaster as JaxMaster)
        from deeplearning4j_tpu_torch.parallel.master import (
            SharedTrainingMaster)
        from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        JE, PE = _estimators()
        jf, pf = _iris_confs()
        x, y = _iris()
        jm = JaxMaster(batch_size_per_worker=25, collect_training_stats=False,
                       mesh=Mesh(np.array(jax.devices()[:2]), ("data",)))
        pm = SharedTrainingMaster(batch_size_per_worker=25,
                                  mesh=make_mesh(MeshSpec.of(data=2),
                                                 devices=[CPU] * 2))
        j = JE.NetworkEstimator(jf, epochs=3, training_master=jm).fit(
            x, y.argmax(1))
        p = PE.NetworkEstimator(pf, epochs=3, training_master=pm,
                                device=CPU).fit(x, y.argmax(1))
        np.testing.assert_allclose(p.predict_proba(x), j.predict_proba(x),
                                   rtol=0, atol=1e-4)

    def test_sklearn_clone_and_pipeline(self):
        base = pytest.importorskip("sklearn.base")
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler
        _, PE = _estimators()
        _, pf = _iris_confs()
        est = PE.NetworkEstimator(pf, epochs=7, batch_size=16, device=CPU)
        twin = base.clone(est)
        assert twin is not est and twin.get_params() == est.get_params()
        assert twin.get_params()["device"] == CPU
        est.set_params(epochs=20)
        assert est.epochs == 20
        x, y = _iris()
        pipe = Pipeline([("scale", StandardScaler()), ("net", est)])
        pipe.fit(x, y.argmax(1))
        assert pipe.score(x, y.argmax(1)) > 0.9


class TestAutoEncoderEstimator:
    def test_codes_and_reconstruction_against_jax(self):
        JE, PE = _estimators()
        rng = np.random.default_rng(0)
        X = np.vstack([rng.normal(0.2, 0.05, (40, 8)),
                       rng.normal(0.8, 0.05, (40, 8))]).astype(np.float32)
        kw = dict(n_hidden=3, epochs=10, batch_size=20, learning_rate=5e-2)
        j = JE.AutoEncoderEstimator(**kw)
        p = PE.AutoEncoderEstimator(**kw, device=CPU)
        np.testing.assert_allclose(p.fit_transform(X), j.fit_transform(X),
                                   rtol=0, atol=PRED_ATOL)
        j.output = p.output = "reconstruction"
        recon = p.transform(X)
        np.testing.assert_allclose(recon, j.transform(X), rtol=0,
                                   atol=PRED_ATOL)
        assert recon.shape == X.shape
        with pytest.raises(ValueError, match="output"):
            PE.AutoEncoderEstimator(2, output="logits")


def test_fallback_base_without_sklearn(monkeypatch):
    """With sklearn hidden the estimators derive from the fallback base,
    whose get_params/set_params keep the same contract."""
    import deeplearning4j_tpu_torch.ml.estimator as PE
    for name in [m for m in sys.modules
                 if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    try:
        fresh = importlib.reload(PE)
        assert all(not c.__module__.startswith("sklearn")
                   for c in fresh.NetworkEstimator.__mro__)
        _, pf = _iris_confs()
        est = fresh.NetworkEstimator(pf, epochs=3, device=CPU)
        assert est.get_params()["epochs"] == 3
        assert est.get_params()["device"] == CPU
        est.set_params(epochs=2, batch_size=50)
        with pytest.raises(ValueError, match="Invalid parameter"):
            est.set_params(nope=1)
        x, y = _iris()
        assert est.fit(x, y.argmax(1)).predict(x).shape == (150,)
        ae = fresh.AutoEncoderEstimator(2, device=CPU)
        assert set(ae.get_params()) == set(
            fresh.AutoEncoderEstimator._param_names)
    finally:
        monkeypatch.undo()
        importlib.reload(PE)


# -------------------------------------------------------------------- S3
class _FakeS3:
    """The boto3 S3 client calls the adapters make, in memory."""

    def __init__(self):
        self.objects = {}

    def upload_file(self, filename, bucket, key):
        with open(filename, "rb") as f:
            self.objects[(bucket, key)] = f.read()

    def download_file(self, bucket, key, filename):
        with open(filename, "wb") as f:
            f.write(self.objects[(bucket, key)])

    def download_fileobj(self, bucket, key, buf):
        buf.write(self.objects[(bucket, key)])

    def list_objects_v2(self, Bucket, Prefix=""):
        return {"Contents": [{"Key": k} for b, k in sorted(self.objects)
                             if b == Bucket and k.startswith(Prefix)]}


def _npz(i):
    buf = io.BytesIO()
    np.savez(buf, features=np.full((4, 3), i, np.float32),
             labels=np.eye(2, dtype=np.float32)[[i % 2] * 4])
    return buf.getvalue()


class TestS3:
    def test_iterator_with_injected_fetch(self):
        from deeplearning4j_tpu.aws import S3DataSetIterator as JaxIt
        from deeplearning4j_tpu_torch.aws import S3DataSetIterator
        from deeplearning4j_tpu_torch.datasets import DataSet
        blobs = {f"part{i}.npz": _npz(i) for i in range(3)}
        got = list(S3DataSetIterator(sorted(blobs), blobs.__getitem__))
        want = list(JaxIt(sorted(blobs), blobs.__getitem__))
        assert len(got) == 3 and all(isinstance(d, DataSet) for d in got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)

    def test_fake_client_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.aws import (
            S3DataSetIterator, S3Downloader, S3Uploader)
        client = _FakeS3()
        up = S3Uploader("bucket", client=client)
        for i in range(2):
            p = tmp_path / f"part{i}.npz"
            p.write_bytes(_npz(i))
            up.upload(p, key=f"data/part{i}.npz")
        (tmp_path / "x.txt").write_text("hello")
        up.upload(tmp_path / "x.txt")
        dl = S3Downloader("bucket", client=client)
        assert dl.list_keys("data/") == ["data/part0.npz", "data/part1.npz"]
        dl.download("x.txt", tmp_path / "back.txt")
        assert (tmp_path / "back.txt").read_text() == "hello"
        it = S3DataSetIterator.from_bucket("bucket", "data/", client=client)
        assert [float(d.features[0, 0]) for d in it] == [0.0, 1.0]
        assert [float(d.features[0, 0]) for d in it] == [0.0, 1.0]
        no_labels = io.BytesIO()
        np.savez(no_labels, features=np.ones((2, 2), np.float32))
        only = S3DataSetIterator(["k"], lambda k: no_labels.getvalue())
        assert only.next().labels is None and not only.has_next()

    def test_clients_without_boto3_name_it(self, monkeypatch):
        from deeplearning4j_tpu_torch.aws import S3Downloader, S3Uploader
        monkeypatch.setitem(sys.modules, "boto3", None)
        for cls in (S3Uploader, S3Downloader):
            with pytest.raises(ImportError, match="boto3"):
                cls("bucket")
