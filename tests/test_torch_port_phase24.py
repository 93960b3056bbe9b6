"""Phase 24 of `chip_smoke.py` (Keras import, the ResNet-50 import and
fine-tune, the CSV shim into an estimator, ModelGuesser) rehearsed on
the CPU in its small mode, through both of its routes: the .h5 files
where libhdf5 links (this host) and the `NpzArchive` twin a host
without libhdf5 takes. A file of its own, so that `--dist loadfile`
runs it beside the other rehearsals."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu_torch.modelimport import Hdf5Archive, KerasModelImport
from deeplearning4j_tpu_torch.modelimport import hdf5 as H5


def _check_common(r):
    b = r["b"]
    assert b["tensors"] == 53 * 2 + 53 * 4 + 2
    assert b["floats"] == 25_636_712          # keras ResNet-50's count
    assert b["output_rel"] == 0.0 and b["features_rel"] == 0.0
    assert b["top1_equal"] and b["eps"] == 1.001e-5
    assert b["output_layer"] == "OutputLayer" and b["packed_runs"] == 0
    ft = b["fine_tune"]
    assert ft["step0_rel_err"] == 0.0 and len(ft["loss_card"]) == ft["steps"]
    c = r["c"]
    assert c["native"] and c["bit_equal"] and c["quirks_equal"]
    assert c["first_loss_diff"] == 0.0 and c["predict_agreement"] == 1.0
    assert c["score"] >= chip_smoke.ESTIMATOR_MIN_SCORE
    assert c["steps"] == chip_smoke.CSV_SMALL["train"] // chip_smoke.\
        CSV_SMALL["batch"]
    assert r["d"]["zip"] and r["d"]["config_json"]
    assert r["launches"] == {"fused_adam": 0}


def test_phase_24_small_mode_h5_route():
    report, fails = {}, chip_smoke.Failures()
    launches = chip_smoke.phase_import_io(torch.device("cpu"), report, fails,
                                          small=True)
    assert not fails, list(fails)
    assert launches == {"fused_adam": 0}
    r = report["import_io"]
    assert r["libhdf5"] in H5.SONAMES
    a = r["a"]
    assert set(a) == {"real_cnn", "real_lstm", "real_func", "real_bn",
                      "real_cnn.weights", "real_bn_fit"}
    assert max(v for k, v in a.items() if k != "real_bn_fit") <= 1e-6
    assert a["real_bn_fit"]["diff"] == 0.0
    assert r["b"]["route"].startswith("h5")
    assert r["d"]["keras_h5"] and r["d"]["weights_only_refused"]
    _check_common(r)


def test_phase_24_small_mode_without_libhdf5():
    """The route of a host without libhdf5: (a) and (d)'s .h5 guesses
    skipped with their reason, (b) through the architecture JSON and
    the archive twin, with the same numbers as the .h5 route."""
    report, fails = {}, chip_smoke.Failures()
    chip_smoke.phase_import_io(torch.device("cpu"), report, fails,
                               small=True, hdf5=None)
    assert not fails, list(fails)
    r = report["import_io"]
    assert r["libhdf5"] is None and "libhdf5" in r["a"]["skipped"]
    assert r["b"]["route"].startswith("npz twin")
    assert "skipped" in r["d"]["h5"]
    _check_common(r)


def test_npz_twin_reads_as_the_h5(tmp_path):
    """The twin and the .h5 written by one layout writer read the same
    names, attributes and arrays, and import into the same params."""
    arch = chip_smoke.keras_resnet_arch(32)
    rng = np.random.default_rng(0)
    weights = [("fc", [("kernel", rng.standard_normal((3, 2), np.float32)),
                       ("bias", np.zeros(2, np.float32))]), ("pool", [])]
    for Archive, name in ((Hdf5Archive, "w.h5"),
                          (chip_smoke.NpzArchive, "w.npz")):
        with Archive(tmp_path / name, "w") as ar:
            chip_smoke.write_keras_weights(ar, weights, "/model_weights")
            ar.write_attr_string("model_config", json.dumps(arch))
    with Hdf5Archive(tmp_path / "w.h5") as h5, \
            chip_smoke.NpzArchive(tmp_path / "w.npz") as twin:
        for ar in (h5, twin):
            assert ar.exists("/model_weights")
            assert KerasModelImport._weights_root(ar) == "/model_weights"
            assert ar.read_attr_strings("layer_names",
                                        "/model_weights") == ["fc", "pool"]
            assert ar.read_attr_strings("weight_names", "/model_weights/"
                                        "pool") == []
        assert json.loads(twin.read_attr_string("model_config")) == arch
        for a, b in zip(*(KerasModelImport._layer_weights(
                ar, "/model_weights", "fc").items() for ar in (h5, twin))):
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_keras_resnet_weights_match_the_architecture():
    arch = chip_smoke.keras_resnet_arch()
    weights = chip_smoke.keras_resnet_weights(arch)
    assert [n for n, _ in weights] == [l["name"] for l in
                                       arch["config"]["layers"]]
    by = dict(weights)
    assert by["conv1_conv"][0][1].shape == (7, 7, 3, 64)
    assert by["predictions"][0][1].shape == (2048, 1000)
    var = dict(by["conv1_bn"])["moving_variance"]
    assert var.min() >= 1.0 and var.max() < 1.5
    assert chip_smoke.keras_resnet_arch(32)["config"]["layers"][0][
        "config"]["batch_shape"] == [None, 32, 32, 3]


def test_probe_decides_the_route_up_front(monkeypatch):
    monkeypatch.setattr(H5, "SONAMES", ("libnothere.so.9",))
    assert H5.libhdf5() is None
    with pytest.raises(OSError, match="libnothere.so.9"):
        monkeypatch.setattr(H5, "_lib", None)
        H5._load_lib()
