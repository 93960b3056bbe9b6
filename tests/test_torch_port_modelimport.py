"""The port's Keras import (`deeplearning4j_tpu_torch/modelimport/`) held
against the JAX package's on the CPU.

- Each package's `Hdf5Archive` reads the other's files and h5py's, and
  the port writes attributes past HDF5's 64 KiB header limit.
- The cases of tests/test_modelimport.py, tests/test_keras_golden.py and
  tests/test_keras_real_golden.py on the port: every file imported by
  both packages, the port's params (and running state) bit-equal to
  JAX's import and its output within JAX's own tolerance of JAX's, of
  the numpy oracle and of Keras's stored predictions.
- tests/test_keras_fuzz.py's three seeds of each family (the keras
  package writes the files).
- The keras-applications ResNet-50 architecture at 32x32 from seeded
  weights: params and running state bit-equal to JAX's import, the
  output and the pooled features within 1e-4.
- The zoo's Keras route (`init_pretrained` through `pretrained_path`).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import hashlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import Hdf5Archive as JaxArchive
from deeplearning4j_tpu.modelimport.keras import KerasModelImport as JK
from deeplearning4j_tpu.optimize.listeners import TrainingListener as JaxLis
from deeplearning4j_tpu_torch.modelimport import Hdf5Archive, KerasModelImport
from deeplearning4j_tpu_torch.modelimport import hdf5 as H5
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util.jax_params import (
    to_jax_params,
    to_jax_state,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo import base as zoo_base
from deeplearning4j_tpu_torch.zoo.base import PretrainedType, ZooModel
from tests.keras_fixture_util import (
    np_conv2d_same,
    np_lstm,
    np_maxpool2d,
    np_separable_conv2d_valid,
    np_softmax,
    write_keras1_h5,
    write_keras2_h5,
)
from tests.test_modelimport import dense_cfg

CPU = "cpu"
FIXDIR = Path(__file__).parent / "fixtures" / "keras"
ARCH = (Path(__file__).parents[1] / "deeplearning4j_tpu" / "zoo" / "weights"
        / "resnet50_keras_arch.json")
RTOL, ATOL = 1e-4, 1e-5          # JAX's import tests' tolerance
FIT_ATOL = 1e-5


def _np(out):
    out = out[0] if isinstance(out, (list, tuple)) else out
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def import_both(path, **kw):
    """(JAX net, port net) of one Keras file."""
    return (JK.import_keras_model_and_weights(str(path), **kw),
            KerasModelImport.import_keras_model_and_weights(path,
                                                            device=CPU, **kw))


def assert_same_weights(jnet, net):
    """The port's params and running state bit-equal to JAX's."""
    want, got = to_numpy_params(jnet.params), to_jax_params(net)
    assert {k for k, v in want.items() if v} == set(got)
    for k, lv in got.items():
        for n, a in lv.items():
            np.testing.assert_array_equal(a, want[k][n], err_msg=f"{k}/{n}")
    want_s = to_numpy_params(jnet.net_state)
    for k, lv in to_jax_state(net).items():
        for n, a in lv.items():
            np.testing.assert_array_equal(a, want_s[k][n],
                                          err_msg=f"state {k}/{n}")


def assert_same_outputs(jnet, net, x, want=None):
    got = _np(net.output(x))
    np.testing.assert_allclose(got, _np(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


def write_keras_h5(path, model_config, layer_weights):
    """tests/test_modelimport.py's writer, through the PORT's archive."""
    with Hdf5Archive(path, "w") as h5:
        h5.write_attr_string("model_config", json.dumps(model_config))
        h5.write_attr_string("keras_version", "2.1.6")
        h5.write_attr_string("backend", "tensorflow")
        h5.create_group("/model_weights")
        h5.write_attr_strings("layer_names", list(layer_weights),
                              "/model_weights")
        for lname, weights in layer_weights.items():
            h5.create_group(f"/model_weights/{lname}")
            h5.write_attr_strings("weight_names",
                                  [f"{lname}/{wn}:0" for wn in weights],
                                  f"/model_weights/{lname}")
            h5.create_group(f"/model_weights/{lname}/{lname}")
            for wn, arr in weights.items():
                h5.write_dataset(f"/model_weights/{lname}/{lname}/{wn}:0",
                                 np.asarray(arr, np.float32))


def _seq(layers):
    return {"class_name": "Sequential",
            "config": {"name": "sequential", "layers": layers}}


# ------------------------------------------------------------ archives
class TestHdf5Archive:
    def test_roundtrip_and_cross_reads(self, tmp_path):
        data = np.arange(6, dtype=np.float32).reshape(2, 3)
        for Writer, Reader in ((Hdf5Archive, JaxArchive),
                               (JaxArchive, Hdf5Archive),
                               (Hdf5Archive, Hdf5Archive)):
            p = tmp_path / f"{Writer.__module__}_{Reader.__module__}.h5"
            with Writer(p, "w") as h5:
                h5.write_attr_string("model_config", '{"x": 1}')
                h5.create_group("/g")
                h5.write_attr_strings("names", ["a", "bb"], "/g")
                h5.write_dataset("/g/data", data)
                h5.write_dataset("/g/scalar", np.float32(2.5))
            with Reader(p) as h5:
                assert h5.read_attr_string("model_config") == '{"x": 1}'
                assert h5.read_attr_string("missing") is None
                assert h5.read_attr_strings("names", "/g") == ["a", "bb"]
                np.testing.assert_array_equal(h5.read_dataset("/g/data"),
                                              data)
                assert h5.read_dataset("/g/scalar") == np.float32(2.5)
                assert h5.exists("/g/data") and not h5.exists("/nope/x")
                assert h5.list_children("/g") == ["data", "scalar"]

    def test_reads_h5py_files_and_large_attributes(self, tmp_path):
        p = tmp_path / "h5py.h5"
        big = "y" * 200_000      # past HDF5's 64 KiB header limit
        with h5py.File(p, "w") as f:
            f.attrs["model_config"] = big.encode()
            f.attrs["vlen"] = "variable length"
            f.attrs["names"] = np.array([b"a", b"bb", b"ccc"], dtype="S8")
            f.create_dataset("g/d", data=np.ones((2, 2), np.float64))
        with Hdf5Archive(p) as h5:
            assert h5.read_attr_string("model_config") == big
            assert h5.read_attr_string("vlen") == "variable length"
            assert h5.read_attr_strings("names") == ["a", "bb", "ccc"]
            np.testing.assert_array_equal(h5.read_dataset("/g/d"),
                                          np.ones((2, 2), np.float32))
        q = tmp_path / "port_big.h5"
        with Hdf5Archive(q, "w") as h5:
            h5.write_attr_string("model_config", big)
        with h5py.File(q) as f:
            assert f.attrs["model_config"].decode() == big
        with JaxArchive(q) as h5:
            assert h5.read_attr_string("model_config") == big

    def test_missing_libhdf5_names_every_soname(self, monkeypatch, tmp_path):
        assert H5.libhdf5() in H5.SONAMES
        monkeypatch.setattr(H5, "_lib", None)
        monkeypatch.setattr(H5, "SONAMES", ("libnothere_a.so.1",
                                            "libnothere_b.so"))
        assert H5.libhdf5() is None
        with pytest.raises(OSError, match="libnothere_a.so.1, "
                                          "libnothere_b.so"):
            Hdf5Archive(tmp_path / "x.h5", "w")

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(IOError, match="Cannot open"):
            Hdf5Archive(tmp_path / "absent.h5")


# ------------------------------------- tests/test_modelimport.py cases
class TestSequentialImport:
    def test_mlp_forward_matches_manual_and_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        W1 = rng.standard_normal((8, 16)).astype(np.float32)
        b1 = rng.standard_normal(16).astype(np.float32)
        W2 = rng.standard_normal((16, 4)).astype(np.float32)
        b2 = rng.standard_normal(4).astype(np.float32)
        config = {"class_name": "Sequential", "config": [
            dense_cfg("dense_1", 16, "relu", input_shape=[8]),
            dense_cfg("dense_2", 4, "softmax")]}
        p = tmp_path / "mlp.h5"
        write_keras_h5(p, config, {"dense_1": {"kernel": W1, "bias": b1},
                                   "dense_2": {"kernel": W2, "bias": b2}})
        jnet, net = import_both(p)
        assert isinstance(net, MultiLayerNetwork)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((5, 8)).astype(np.float32)
        want = np_softmax(np.maximum(x @ W1 + b1, 0.0) @ W2 + b2)
        assert_same_outputs(jnet, net, x, want)

    def test_keras1_dialect(self, tmp_path):
        rng = np.random.default_rng(1)
        W = rng.standard_normal((6, 3)).astype(np.float32)
        config = {"class_name": "Sequential", "config": [
            dense_cfg("d", 3, "sigmoid", input_shape=[6], keras1=True)]}
        p = tmp_path / "k1.h5"
        write_keras_h5(p, config,
                       {"d": {"d_W": W, "d_b": np.zeros(3, np.float32)}})
        jnet, net = import_both(p)
        np.testing.assert_array_equal(to_jax_params(net)["0"]["W"], W)
        assert_same_weights(jnet, net)

    def test_unmatched_weight_names_raise(self, tmp_path):
        config = {"class_name": "Sequential", "config": [
            dense_cfg("d", 3, "sigmoid", input_shape=[6])]}
        p = tmp_path / "bad.h5"
        write_keras_h5(p, config,
                       {"d": {"mystery": np.zeros((6, 3), np.float32)}})
        for imp in (JK.import_keras_model_and_weights,
                    lambda q: KerasModelImport.import_keras_model_and_weights(
                        q, device=CPU)):
            with pytest.raises(ValueError, match="could not match"):
                imp(str(p))

    def test_cnn_with_flatten(self, tmp_path):
        rng = np.random.default_rng(2)
        K = rng.standard_normal((3, 3, 1, 4)).astype(np.float32) * 0.1
        W = rng.standard_normal((4 * 4 * 4, 2)).astype(np.float32) * 0.1
        config = {"class_name": "Sequential", "config": [
            {"class_name": "Conv2D", "config": {
                "name": "conv", "filters": 4, "kernel_size": [3, 3],
                "strides": [1, 1], "padding": "same", "activation": "relu",
                "use_bias": True, "batch_input_shape": [None, 8, 8, 1]}},
            {"class_name": "MaxPooling2D", "config": {
                "name": "pool", "pool_size": [2, 2], "strides": [2, 2],
                "padding": "valid"}},
            {"class_name": "Flatten", "config": {"name": "flat"}},
            dense_cfg("out", 2, "softmax")]}
        p = tmp_path / "cnn.h5"
        write_keras_h5(p, config, {
            "conv": {"kernel": K, "bias": np.zeros(4, np.float32)},
            "out": {"kernel": W, "bias": np.zeros(2, np.float32)}})
        jnet, net = import_both(p)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
        out = assert_same_outputs(jnet, net, x)
        np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-4)

    def test_lstm_gate_reorder(self, tmp_path):
        H, F = 3, 2
        K = np.concatenate([np.full((F, H), v, np.float32)
                            for v in (1, 2, 3, 4)], 1)
        R = np.concatenate([np.full((H, H), v, np.float32)
                            for v in (1, 2, 3, 4)], 1)
        b = np.concatenate([np.full((H,), v, np.float32)
                            for v in (1, 2, 3, 4)])
        config = {"class_name": "Sequential", "config": [
            {"class_name": "LSTM", "config": {
                "name": "lstm", "units": H, "activation": "tanh",
                "recurrent_activation": "sigmoid", "return_sequences": False,
                "batch_input_shape": [None, 5, F]}},
            dense_cfg("out", 2, "softmax")]}
        rng = np.random.default_rng(3)
        p = tmp_path / "lstm.h5"
        write_keras_h5(p, config, {
            "lstm": {"kernel": K, "recurrent_kernel": R, "bias": b},
            "out": {"kernel": rng.standard_normal((H, 2)).astype(np.float32),
                    "bias": np.zeros(2, np.float32)}})
        jnet, net = import_both(p)
        W = to_jax_params(net)["0"]["W"]
        # the framework's IFOG order: i=1, f=2, o=4, g(c)=3
        assert (W[0, 0], W[0, H], W[0, 2 * H], W[0, 3 * H]) == (1, 2, 4, 3)
        assert net.layers[0].gate_activation.name == "sigmoid"
        assert type(net.layers[1]).__name__ == "LastTimeStep"
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 5, F)).astype(np.float32)
        assert assert_same_outputs(jnet, net, x).shape == (2, 2)

    def test_batchnorm_state(self, tmp_path):
        F = 4
        gamma, beta = np.full(F, 1.5, np.float32), np.full(F, -0.5,
                                                          np.float32)
        mean, var = np.full(F, 2.0, np.float32), np.full(F, 4.0, np.float32)
        config = {"class_name": "Sequential", "config": [
            {"class_name": "BatchNormalization", "config": {
                "name": "bn", "epsilon": 1e-3, "momentum": 0.99,
                "batch_input_shape": [None, F]}}]}
        p = tmp_path / "bn.h5"
        write_keras_h5(p, config, {"bn": {
            "gamma": gamma, "beta": beta, "moving_mean": mean,
            "moving_variance": var}})
        jnet, net = import_both(p)
        assert_same_weights(jnet, net)
        assert set(to_jax_params(net)["0"]) == {"gamma", "beta"}
        x = np.random.default_rng(4).standard_normal((6, F)).astype(
            np.float32)
        want = gamma * (x - mean) / np.sqrt(var + 1e-3) + beta
        np.testing.assert_allclose(_np(net.output(x)), want, rtol=1e-3,
                                   atol=1e-4)
        assert_same_outputs(jnet, net, x)


class TestFunctionalImport:
    def test_two_branch_model(self, tmp_path):
        rng = np.random.default_rng(5)
        W1, W2 = (rng.standard_normal((6, 8)).astype(np.float32)
                  for _ in range(2))
        W3 = rng.standard_normal((16, 3)).astype(np.float32)
        layers = [
            {"class_name": "InputLayer", "name": "input_1",
             "config": {"name": "input_1", "batch_input_shape": [None, 6]},
             "inbound_nodes": []}]
        for n in ("a", "b"):
            layers.append({"class_name": "Dense", "name": n,
                           "config": {"name": n, "units": 8,
                                      "activation": "relu",
                                      "use_bias": True},
                           "inbound_nodes": [[["input_1", 0, 0, {}]]]})
        layers += [
            {"class_name": "Concatenate", "name": "merge",
             "config": {"name": "merge"},
             "inbound_nodes": [[["a", 0, 0, {}], ["b", 0, 0, {}]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 3, "activation": "softmax",
                        "use_bias": True},
             "inbound_nodes": [[["merge", 0, 0, {}]]]}]
        config = {"class_name": "Model", "config": {
            "name": "branchy", "layers": layers,
            "input_layers": [["input_1", 0, 0]],
            "output_layers": [["out", 0, 0]]}}
        p = tmp_path / "func.h5"
        write_keras_h5(p, config, {
            "a": {"kernel": W1, "bias": np.zeros(8, np.float32)},
            "b": {"kernel": W2, "bias": np.zeros(8, np.float32)},
            "out": {"kernel": W3, "bias": np.zeros(3, np.float32)}})
        jnet, net = import_both(p)
        assert isinstance(net, ComputationGraph)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((4, 6)).astype(np.float32)
        h = np.concatenate([np.maximum(x @ W1, 0), np.maximum(x @ W2, 0)], 1)
        assert_same_outputs(jnet, net, x, np_softmax(h @ W3))

    def test_configuration_only(self, tmp_path):
        """`import_keras_configuration` of a bare architecture JSON (the
        real functional fixture's `model_config`) and of an .h5: the
        port's conf equals JAX's as a dict."""
        with h5py.File(FIXDIR / "real_func.h5") as f:
            arch = f.attrs["model_config"]
        p = tmp_path / "arch.json"
        p.write_text(arch if isinstance(arch, str) else arch.decode())
        for src in (p, FIXDIR / "real_func.h5", FIXDIR / "real_lstm.h5"):
            got = KerasModelImport.import_keras_configuration(src)
            assert got.to_dict() == JK.import_keras_configuration(
                str(src)).to_dict()


# ---------------------------------- tests/test_keras_golden.py cases
class TestKeras2Golden:
    def test_cnn_output_parity(self, tmp_path):
        rng = np.random.default_rng(0)
        kconv = rng.standard_normal((3, 3, 1, 4)).astype(np.float32) * 0.3
        bconv = rng.standard_normal(4).astype(np.float32) * 0.1
        kd = rng.standard_normal((64, 10)).astype(np.float32) * 0.2
        bd = rng.standard_normal(10).astype(np.float32) * 0.1
        cfg = _seq([
            {"class_name": "Conv2D",
             "config": {"name": "conv", "filters": 4, "kernel_size": [3, 3],
                        "strides": [1, 1], "padding": "same",
                        "activation": "relu", "use_bias": True,
                        "batch_input_shape": [None, 8, 8, 1]}},
            {"class_name": "MaxPooling2D",
             "config": {"name": "pool", "pool_size": [2, 2],
                        "strides": [2, 2], "padding": "valid"}},
            {"class_name": "Flatten", "config": {"name": "flatten"}},
            {"class_name": "Dense",
             "config": {"name": "fc", "units": 10, "activation": "softmax",
                        "use_bias": True}}])
        path = tmp_path / "cnn.h5"
        write_keras2_h5(path, cfg, [
            ("conv", [("kernel", kconv), ("bias", bconv)]),
            ("pool", []), ("flatten", []),
            ("fc", [("kernel", kd), ("bias", bd)])])
        jnet, net = import_both(path)
        pre = [p for p in net.conf.input_preprocessors.values()
               if isinstance(p, CnnToFeedForwardPreProcessor)]
        assert pre and all(p.data_format == "nhwc" for p in pre)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
        h = np_maxpool2d(np.maximum(np_conv2d_same(x, kconv, bconv), 0.0), 2)
        assert_same_outputs(jnet, net, x, np_softmax(h.reshape(2, -1) @ kd
                                                     + bd))

    def test_lstm_output_parity(self, tmp_path):
        rng = np.random.default_rng(1)
        U, F, T = 5, 3, 4
        K = rng.standard_normal((F, 4 * U)).astype(np.float32) * 0.4
        R = rng.standard_normal((U, 4 * U)).astype(np.float32) * 0.4
        b = rng.standard_normal(4 * U).astype(np.float32) * 0.1
        kd = rng.standard_normal((U, 2)).astype(np.float32)
        cfg = _seq([
            {"class_name": "LSTM",
             "config": {"name": "lstm", "units": U, "activation": "tanh",
                        "recurrent_activation": "hard_sigmoid",
                        "return_sequences": False,
                        "batch_input_shape": [None, T, F]}},
            {"class_name": "Dense",
             "config": {"name": "fc", "units": 2, "activation": "softmax"}}])
        path = tmp_path / "lstm.h5"
        write_keras2_h5(path, cfg, [
            ("lstm", [("kernel", K), ("recurrent_kernel", R), ("bias", b)]),
            ("fc", [("kernel", kd), ("bias", np.zeros(2, np.float32))])])
        jnet, net = import_both(path)
        assert net.layers[0].gate_activation.name == "hardsigmoid"
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, T, F)).astype(np.float32)
        assert_same_outputs(jnet, net, x, np_softmax(np_lstm(x, K, R, b)
                                                     @ kd))

    def test_separable_conv_output_parity(self, tmp_path):
        rng = np.random.default_rng(2)
        dk = rng.standard_normal((3, 3, 2, 2)).astype(np.float32) * 0.3
        pk = rng.standard_normal((1, 1, 4, 5)).astype(np.float32) * 0.3
        b = rng.standard_normal(5).astype(np.float32) * 0.1
        kd = rng.standard_normal((80, 3)).astype(np.float32) * 0.1
        cfg = _seq([
            {"class_name": "SeparableConv2D",
             "config": {"name": "sep", "filters": 5, "kernel_size": [3, 3],
                        "strides": [1, 1], "padding": "valid",
                        "depth_multiplier": 2, "activation": "linear",
                        "use_bias": True,
                        "batch_input_shape": [None, 6, 6, 2]}},
            {"class_name": "Flatten", "config": {"name": "flatten"}},
            {"class_name": "Dense",
             "config": {"name": "fc", "units": 3, "activation": "softmax"}}])
        path = tmp_path / "sep.h5"
        write_keras2_h5(path, cfg, [
            ("sep", [("depthwise_kernel", dk), ("pointwise_kernel", pk),
                     ("bias", b)]),
            ("flatten", []),
            ("fc", [("kernel", kd), ("bias", np.zeros(3, np.float32))])])
        jnet, net = import_both(path)
        assert net.layers[0].depth_multiplier == 2
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 6, 6, 2)).astype(np.float32)
        h = np_separable_conv2d_valid(x, dk, pk, b)
        assert_same_outputs(jnet, net, x, np_softmax(h.reshape(2, -1) @ kd))

    def test_shape_op_layers_import(self, tmp_path):
        rng = np.random.default_rng(3)
        cfg = _seq([
            {"class_name": "Reshape",
             "config": {"name": "rs", "target_shape": [4, 6],
                        "batch_input_shape": [None, 24]}},
            {"class_name": "Permute", "config": {"name": "pm",
                                                 "dims": [2, 1]}},
            {"class_name": "ZeroPadding1D",
             "config": {"name": "zp", "padding": [1, 1]}},
            {"class_name": "UpSampling1D", "config": {"name": "up",
                                                      "size": 2}},
            {"class_name": "Conv1D",
             "config": {"name": "conv", "filters": 3, "kernel_size": [3],
                        "strides": [1], "padding": "valid",
                        "dilation_rate": [2], "activation": "relu"}}])
        kc = rng.standard_normal((3, 4, 3)).astype(np.float32) * 0.3
        path = tmp_path / "shapes.h5"
        write_keras2_h5(path, cfg, [
            ("rs", []), ("pm", []), ("zp", []), ("up", []),
            ("conv", [("kernel", kc), ("bias", np.zeros(3, np.float32))])])
        jnet, net = import_both(path)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 24)).astype(np.float32)
        # 24 -> [4, 6] -> [6, 4] -> T 8 -> T 16 -> dilated k3 d2: T 12
        assert assert_same_outputs(jnet, net, x).shape == (2, 12, 3)

    def test_upsampling1d_keras1_length(self, tmp_path):
        cfg = _seq([{"class_name": "UpSampling1D",
                     "config": {"name": "up", "length": 3,
                                "batch_input_shape": [None, 4, 2]}}])
        path = tmp_path / "up1.h5"
        write_keras2_h5(path, cfg, [("up", [])])
        jnet, net = import_both(path)
        x = np.random.default_rng(0).standard_normal((1, 4, 2)).astype(
            np.float32)
        assert assert_same_outputs(jnet, net, x).shape == (1, 12, 2)


class TestKeras1Golden:
    def test_dense_mlp_keras1_dialect(self, tmp_path):
        rng = np.random.default_rng(4)
        W1 = rng.standard_normal((6, 8)).astype(np.float32) * 0.4
        b1 = rng.standard_normal(8).astype(np.float32) * 0.1
        W2 = rng.standard_normal((8, 3)).astype(np.float32) * 0.4
        cfg = {"class_name": "Sequential", "config": [
            {"class_name": "Dense",
             "config": {"name": "dense_1", "output_dim": 8,
                        "activation": "tanh", "input_dim": 6}},
            {"class_name": "Dense",
             "config": {"name": "dense_2", "output_dim": 3,
                        "activation": "softmax"}}]}
        path = tmp_path / "k1.h5"
        write_keras1_h5(path, cfg, [
            ("dense_1", [("W", W1), ("b", b1)]),
            ("dense_2", [("W", W2), ("b", np.zeros(3, np.float32))])])
        jnet, net = import_both(path)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((3, 6)).astype(np.float32)
        assert_same_outputs(jnet, net, x,
                            np_softmax(np.tanh(x @ W1 + b1) @ W2))

    def test_keras1_per_gate_lstm(self, tmp_path):
        """Keras 1's W_i/U_i/b_i per-gate LSTM tensors concatenate into
        the IFOG layout, as JAX's importer does."""
        rng = np.random.default_rng(6)
        U, F, T = 3, 2, 4
        gates = {}
        for g in "ifco":
            gates[f"W_{g}"] = rng.standard_normal((F, U)).astype(np.float32)
            gates[f"U_{g}"] = rng.standard_normal((U, U)).astype(np.float32)
            gates[f"b_{g}"] = rng.standard_normal(U).astype(np.float32)
        cfg = {"class_name": "Sequential", "config": [
            {"class_name": "LSTM",
             "config": {"name": "lstm_1", "output_dim": U,
                        "input_dim": F, "input_length": T,
                        "inner_activation": "hard_sigmoid",
                        "return_sequences": False}}]}
        path = tmp_path / "k1lstm.h5"
        write_keras1_h5(path, cfg, [("lstm_1", list(gates.items()))])
        jnet, net = import_both(path)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, T, F)).astype(np.float32)
        assert_same_outputs(jnet, net, x)


class TestDimOrderingDetection:
    def test_keras1_th_dim_ordering_keeps_nchw_flatten(self, tmp_path):
        rng = np.random.default_rng(9)
        kconv = rng.standard_normal((1, 1, 2, 2)).astype(np.float32)
        kd = rng.standard_normal((32, 3)).astype(np.float32)
        cfg = {"class_name": "Model", "config": {"name": "m", "layers": [
            {"class_name": "InputLayer", "name": "in",
             "config": {"name": "in", "batch_input_shape": [None, 4, 4, 2]},
             "inbound_nodes": []},
            {"class_name": "Convolution2D", "name": "conv",
             "config": {"name": "conv", "nb_filter": 2, "nb_row": 1,
                        "nb_col": 1, "dim_ordering": "th",
                        "border_mode": "valid", "activation": "linear"},
             "inbound_nodes": [[["in", 0, 0]]]},
            {"class_name": "Flatten", "name": "flat",
             "config": {"name": "flat"}, "inbound_nodes": [[["conv", 0, 0]]]},
            {"class_name": "Dense", "name": "fc",
             "config": {"name": "fc", "output_dim": 3,
                        "activation": "softmax"},
             "inbound_nodes": [[["flat", 0, 0]]]}],
            "input_layers": [["in", 0, 0]],
            "output_layers": [["fc", 0, 0]]}}
        path = tmp_path / "th.h5"
        write_keras2_h5(path, cfg, [
            ("conv", [("kernel", kconv), ("bias", np.zeros(2, np.float32))]),
            ("fc", [("kernel", kd), ("bias", np.zeros(3, np.float32))])])
        with h5py.File(path, "a") as f:  # no backend attr
            del f.attrs["backend"]
        jnet, net = import_both(path)
        flat = [n.preprocessor for n in net.conf.nodes.values()
                if isinstance(n.preprocessor, CnnToFeedForwardPreProcessor)]
        assert flat and all(p.data_format == "nchw" for p in flat)
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
        assert_same_outputs(jnet, net, x)

    def test_theano_kernels_are_transposed_and_flipped(self, tmp_path):
        """An OIHW (Theano) conv kernel lands HWIO, spatially flipped,
        as JAX's `_coerce` lands it."""
        rng = np.random.default_rng(10)
        k = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
        cfg = _seq([{"class_name": "Conv2D",
                     "config": {"name": "conv", "filters": 4,
                                "kernel_size": [3, 3], "padding": "same",
                                "activation": "linear",
                                "batch_input_shape": [None, 5, 5, 2]}}])
        path = tmp_path / "oihw.h5"
        write_keras2_h5(path, cfg, [
            ("conv", [("kernel", k), ("bias", np.zeros(4, np.float32))])])
        jnet, net = import_both(path)
        np.testing.assert_array_equal(
            to_jax_params(net)["0"]["W"],
            np.transpose(k, (2, 3, 1, 0))[::-1, ::-1])
        assert_same_weights(jnet, net)


# -------------------------------------------------- weights-only files
def _write_weights_only(path, layer_weights):
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [ln.encode() for ln, _ in layer_weights], dtype="S64")
        f.attrs["backend"] = b"tensorflow"
        for lname, weights in layer_weights:
            g = f.create_group(lname)
            wnames = [f"{lname}/{wn}:0" for wn, _ in weights]
            g.attrs["weight_names"] = np.array(
                [w.encode() for w in wnames], dtype="S128")
            for (_, arr), full in zip(weights, wnames):
                g.create_dataset(full, data=np.asarray(arr, np.float32))


def _tiny_nets():
    """tests/test_keras_golden.py's `_tiny_net` in both packages, from
    one configuration."""
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import (
        ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu.nn.layers.convolution import ConvolutionMode
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
            .list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode=ConvolutionMode.SAME,
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=6, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    return (JMLN(conf).init(),
            MultiLayerNetwork(MultiLayerConfiguration.from_json(
                conf.to_json()), device=CPU).init())


def _tiny_weights(rng):
    return [("block1_conv1", [("kernel", rng.standard_normal((3, 3, 1, 4))),
                              ("bias", rng.standard_normal(4))]),
            ("pool", []),
            ("fc1", [("kernel", rng.standard_normal((64, 6))),
                     ("bias", rng.standard_normal(6))]),
            ("predictions", [("kernel", rng.standard_normal((6, 2))),
                             ("bias", np.zeros(2))])]


class TestWeightsOnlyH5:
    def test_load_weights_into_order_matched(self, tmp_path):
        path = tmp_path / "weights_only.h5"
        _write_weights_only(path, _tiny_weights(np.random.default_rng(7)))
        jnet, net = _tiny_nets()
        JK.load_weights_into(jnet, str(path))
        assert KerasModelImport.load_weights_into(net, path) is net
        assert_same_weights(jnet, net)
        x = np.random.default_rng(8).standard_normal((3, 8, 8, 1)).astype(
            np.float32)
        assert_same_outputs(jnet, net, x)

    def test_topology_mismatch_raises(self, tmp_path):
        path = tmp_path / "short.h5"
        _write_weights_only(path, [
            ("only_one", [("kernel", np.zeros((3, 3, 1, 4)))])])
        jnet, net = _tiny_nets()
        for load, n in ((JK.load_weights_into, jnet),
                        (KerasModelImport.load_weights_into, net)):
            with pytest.raises(ValueError, match="topologies differ"):
                load(n, str(path))

    def test_shape_mismatch_raises(self, tmp_path):
        path = tmp_path / "wrong.h5"
        w = _tiny_weights(np.random.default_rng(7))
        w[2] = ("fc1", [("kernel", np.zeros((63, 6))),
                        ("bias", np.zeros(6))])
        _write_weights_only(path, w)
        _, net = _tiny_nets()
        with pytest.raises(ValueError, match=r"fc1 param W"):
            KerasModelImport.load_weights_into(net, path)


# ---------------------------------------------------------------- zoo
class _Served(ZooModel):
    """A zoo model serving one file through the port's seam."""
    path = None
    architecture = None

    def pretrained_path(self, ptype):
        return self.path

    def pretrained_checksum(self, ptype):
        return hashlib.sha256(self.path.read_bytes()).hexdigest()


class TestZooKerasRoute:
    def test_full_model_h5(self, tmp_path):
        rng = np.random.default_rng(5)
        W = rng.standard_normal((4, 2)).astype(np.float32)
        cfg = _seq([{"class_name": "Dense",
                     "config": {"name": "fc", "units": 2,
                                "activation": "softmax",
                                "batch_input_shape": [None, 4]}}])
        path = tmp_path / "tiny_pretrained.h5"
        write_keras2_h5(path, cfg, [("fc", [("kernel", W),
                                            ("bias", np.zeros(2))])])
        zoo = _Served()
        zoo.path = path
        net = zoo.init_pretrained(PretrainedType.IMAGENET, device=CPU)
        x = rng.standard_normal((3, 4)).astype(np.float32)
        np.testing.assert_allclose(_np(net.output(x)), np_softmax(x @ W),
                                   rtol=1e-5, atol=1e-6)

    def test_weights_only_onto_init(self, tmp_path):
        path = tmp_path / "zoo_weights.h5"
        _write_weights_only(path, _tiny_weights(np.random.default_rng(8)))
        jnet, _ = _tiny_nets()
        JK.load_weights_into(jnet, str(path))

        class Tiny(_Served):
            def init(self, seed=None, *, device="cuda", dtype_policy=None):
                return _tiny_nets()[1].to(device)
        zoo = Tiny()
        zoo.path = path
        net = zoo.init_pretrained(PretrainedType.IMAGENET, device=CPU)
        assert_same_weights(jnet, net)

    def test_weights_only_through_keras_architecture(self, tmp_path,
                                                     monkeypatch):
        """A weights-only file with the model's `keras_architecture`
        (read from the zoo's weights directory) is copied by name."""
        rng = np.random.default_rng(11)
        arch = {"class_name": "Functional", "config": {
            "name": "m", "layers": [
                {"class_name": "InputLayer", "name": "in",
                 "config": {"batch_shape": [None, 5], "name": "in"},
                 "inbound_nodes": []},
                {"class_name": "Dense", "name": "h",
                 "config": {"name": "h", "units": 4, "activation": "relu"},
                 "inbound_nodes": [[["in", 0, 0, {}]]]},
                {"class_name": "Dense", "name": "out",
                 "config": {"name": "out", "units": 3,
                            "activation": "softmax"},
                 "inbound_nodes": [[["h", 0, 0, {}]]]}],
            "input_layers": [["in", 0, 0]],
            "output_layers": [["out", 0, 0]]}}
        (tmp_path / "tiny_arch.json").write_text(json.dumps(arch))
        monkeypatch.setattr(zoo_base, "WEIGHTS_DIR", tmp_path)
        path = tmp_path / "w.h5"
        # stored out of the graph's order: the copy goes by name
        _write_weights_only(path, [
            ("out", [("kernel", rng.standard_normal((4, 3))),
                     ("bias", rng.standard_normal(3))]),
            ("h", [("kernel", rng.standard_normal((5, 4))),
                   ("bias", rng.standard_normal(4))])])

        class Tiny(_Served):
            keras_architecture = {PretrainedType.IMAGENET: "tiny_arch.json"}
        zoo = Tiny()
        zoo.path = path
        net = zoo.init_pretrained(PretrainedType.IMAGENET, device=CPU)
        jnet = JK.import_architecture_and_weights(
            str(tmp_path / "tiny_arch.json"), str(path))
        assert_same_weights(jnet, net)
        x = rng.standard_normal((2, 5)).astype(np.float32)
        assert_same_outputs(jnet, net, x)

    def test_checksum_gate_and_cuda_default(self, tmp_path):
        path = tmp_path / "bad.h5"
        path.write_bytes(b"\x89HDF\r\n\x1a\njunk")

        class Bad(_Served):
            def pretrained_checksum(self, ptype):
                return "0" * 32
        zoo = Bad()
        zoo.path = path
        with pytest.raises(IOError, match="Checksum mismatch"):
            zoo.init_pretrained(PretrainedType.IMAGENET, device=CPU)
        if not torch.cuda.is_available():
            ok = _Served()
            ok.path = path
            with pytest.raises(RuntimeError, match="CUDA"):
                ok.init_pretrained(PretrainedType.IMAGENET)

    def test_resnet50_names_the_keras_architecture(self):
        from deeplearning4j_tpu.zoo.resnet50 import ResNet50 as JaxResNet50
        from deeplearning4j_tpu_torch.zoo import ResNet50
        assert (ResNet50.keras_architecture
                == {PretrainedType.IMAGENET: "resnet50_keras_arch.json"})
        assert (JaxResNet50.keras_architecture[PretrainedType.IMAGENET]
                == "resnet50_keras_arch.json")
        assert (zoo_base.WEIGHTS_DIR / "resnet50_keras_arch.json").exists()
        with pytest.raises(NotImplementedError, match="no weights"):
            ResNet50().init_pretrained(device=CPU)


# ---------------------------- tests/test_keras_real_golden.py cases
@pytest.fixture(scope="module")
def preds():
    return np.load(FIXDIR / "predictions.npz")


@pytest.mark.parametrize("fname,key", [("real_cnn", "cnn"),
                                       ("real_lstm", "lstm"),
                                       ("real_func", "func"),
                                       ("real_bn", "bn")])
def test_real_keras_fixture(preds, fname, key):
    jnet, net = import_both(FIXDIR / f"{fname}.h5")
    assert_same_weights(jnet, net)
    assert_same_outputs(jnet, net, preds[f"{key}_x"], preds[f"{key}_y"])


def test_real_weights_only_by_name(preds):
    net = KerasModelImport.import_keras_model_and_weights(
        FIXDIR / "real_cnn.h5", device=CPU)
    with torch.no_grad():
        for t in net.parameters():
            t.zero_()
    KerasModelImport.load_weights_into(net, FIXDIR / "real_cnn.weights.h5")
    np.testing.assert_allclose(_np(net.output(preds["cnn_x"])),
                               preds["cnn_y"], rtol=RTOL, atol=ATOL)


def test_real_enforce_training_config_rejects_uncompiled():
    with pytest.raises(ValueError, match="uncompiled"):
        KerasModelImport.import_keras_model_and_weights(
            FIXDIR / "real_cnn.h5", enforce_training_config=True,
            device=CPU)


class _Losses(JaxLis, TrainingListener):
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.losses.append(float(score))


def test_real_compiled_model_fits_as_jax():
    """The compiled real_bn.h5 (its SGD and loss from training_config):
    the first 3 fit losses within 1e-5 of JAX's import's, and falling."""
    jnet, net = import_both(FIXDIR / "real_bn.h5")
    assert type(net.layers[-1]).__name__ == "OutputLayer"
    assert type(net.layers[0].updater).__name__ == type(
        jnet.layers[0].updater).__name__
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    got, want = _Losses(), _Losses()
    net.set_listeners(got)
    jnet.set_listeners(want)
    for _ in range(3):
        net.fit(x, y)
        jnet.fit(x, y)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                               atol=FIT_ATOL)
    assert got.losses[-1] < got.losses[0]


# ----------------------------------- tests/test_keras_fuzz.py's seeds
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("family", ["cnn", "rnn"])
def test_random_keras_model_round_trips(tmp_path, seed, family):
    pytest.importorskip("keras")
    import keras
    from tests import test_keras_fuzz as fuzz
    salt = 1000 * seed + (0 if family == "cnn" else 1)
    rng = np.random.default_rng(salt)
    keras.utils.set_random_seed(salt)
    model, x = (fuzz._random_cnn if family == "cnn"
                else fuzz._random_rnn)(rng)
    want = model.predict(x, verbose=0)
    path = tmp_path / f"fuzz_{family}_{seed}.h5"
    model.save(path)
    jnet, net = import_both(path)
    assert_same_weights(jnet, net)
    got = _np(net.output(x))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, _np(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)


# ----------------------------------------------- ResNet-50 at 32x32
def _resnet_weights(arch, conf, rng):
    out = []
    for lc in arch["config"]["layers"]:
        name, cls = lc["name"], lc["class_name"]
        node = conf.nodes.get(name)
        shapes = ({k: tuple(t.shape)
                   for k, t in node.layer.jax_param_map().items()}
                  if node is not None and node.layer is not None else {})
        if cls in ("Conv2D", "Dense"):
            w = shapes["W"]
            scale = np.sqrt((2.0 if cls == "Conv2D" else 1.0)
                            / np.prod(w[:-1]))
            out.append((name, [("kernel", rng.standard_normal(w) * scale),
                               ("bias", 0.1 * rng.standard_normal(w[-1]))]))
        elif cls == "BatchNormalization":
            c = shapes["gamma"]
            out.append((name, [
                ("gamma", 1 + 0.1 * rng.standard_normal(c)),
                ("beta", 0.1 * rng.standard_normal(c)),
                ("moving_mean", 0.1 * rng.standard_normal(c)),
                ("moving_variance", 1 + 0.5 * rng.random(c))]))
        else:
            out.append((name, []))
    return out


def _resnet_arch(stages=None):
    """keras-applications' ResNet-50 at 32x32; with `stages`, cut after
    that many of its four bottleneck stages (conv2_x, conv3_x, ...), the
    pooling and the 1000-way Dense then reading the cut's output."""
    arch = json.loads(ARCH.read_text())
    layers = arch["config"]["layers"]
    layers[0]["config"]["batch_shape"] = [None, 32, 32, 3]
    if stages is not None:
        keep = ("input", "conv1", "pool1") + tuple(
            f"conv{s + 2}_" for s in range(stages))
        last = [l["name"] for l in layers
                if l["name"].startswith(keep)][-1]
        tail = [l for l in layers if l["name"] in ("avg_pool",
                                                    "predictions")]
        tail[0]["inbound_nodes"][0]["args"][0]["config"][
            "keras_history"][0] = last
        arch["config"]["layers"] = [l for l in layers
                                    if l["name"].startswith(keep)] + tail
    return arch


def _resnet_import_against_jax(tmp_path, arch, n_bn):
    conf = KerasModelImport.config_from_dict(arch)
    bns = [n.layer for n in conf.nodes.values()
           if type(n.layer).__name__ == "BatchNormalization"]
    assert len(bns) == n_bn and {b.eps for b in bns} == {1.001e-5}
    path = tmp_path / "resnet50_weights.h5"
    _write_weights_only(path, _resnet_weights(arch, conf,
                                              np.random.default_rng(0)))
    net = KerasModelImport.import_architecture_and_weights(arch, path,
                                                           device=CPU)
    assert net.conf.to_dict() == conf.to_dict()
    jnet = JK.import_architecture_and_weights(arch, str(path))
    assert net.conf.to_dict() == jnet.conf.to_dict()
    assert_same_weights(jnet, net)
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    got, want = _np(net.output(x)), _np(jnet.output(x))
    assert got.shape == (1, 1000)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    feat = _np(net.feed_forward(x)["avg_pool"])
    jfeat = np.asarray(jnet.feed_forward(x)["avg_pool"])
    assert np.abs(feat - jfeat).max() <= 1e-4 * np.abs(jfeat).max()


def test_resnet50_keras_architecture_first_two_stages(tmp_path):
    """keras-applications' ResNet-50 cut after conv3_x (ZeroPadding, the
    biased convs, BatchNorms at epsilon 1.001e-5, the 1000-way Dense) at
    32x32 from a seeded weights-only file: params and running state
    bit-equal to JAX's import, output and pooled features within 1e-4 of
    max|y|."""
    # conv1_bn, conv2_x's 3 blocks and conv3_x's 4 (3 each, and each
    # stage's projection shortcut)
    _resnet_import_against_jax(tmp_path, _resnet_arch(stages=2),
                               1 + (3 * 3 + 1) + (4 * 3 + 1))


@pytest.mark.slow
def test_resnet50_keras_architecture_at_32(tmp_path):
    """The whole architecture (53 biased convs, 53 BatchNorms), as the
    first-two-stages case holds it."""
    _resnet_import_against_jax(tmp_path, _resnet_arch(), 53)


def test_import_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is satisfiable")
    path = FIXDIR / "real_cnn.h5"
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_keras_model_and_weights(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        KerasModelImport.import_architecture_and_weights(ARCH, path)
