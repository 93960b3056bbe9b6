"""`ShardedCheckpoint` (`deeplearning4j_tpu_torch/util/
sharded_checkpoint.py`) in JAX's five cases (`tests/
test_sharded_checkpoint.py`): the round trip keeps outputs and
counters; a restore lands arrays on their target shards; a sharded
model (a ShardedParallelTrainer's shards) saves without a host gather
of the shards; None leaves mean the default placement; and the meta
commits inside the atomic directory, never as a side file. Besides:
damage raises `CheckpointCorruptError`, and the cross-package parity
is by outputs (the formats differ: the port does not read Orbax's)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util import ShardedCheckpoint as JShardedCheckpoint
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
from deeplearning4j_tpu_torch.parallel.tensor import ShardedParallelTrainer
from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
    ShardedCheckpoint,
    ShardedTensor,
)


def _jconf():
    return (JBuilder.builder().seed(9).updater(JAdam(0.02)).list()
            .layer(JDense(n_in=8, n_out=16, activation="relu"))
            .layer(JOutput(n_in=16, n_out=3, activation="softmax",
                           loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _model():
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf().to_json()), device="cpu").init()


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    return x, y


def _mesh4():
    return make_mesh(MeshSpec.of(model=4), devices=["cpu"] * 4)


def test_roundtrip_preserves_outputs_and_counters(tmp_path):
    net = _model()
    x, y = _data()
    net.fit(x, y, epochs=3, batch_size=16)
    want = net.output(x).numpy()
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net)
    clone = ShardedCheckpoint.restore(path, device="cpu")
    np.testing.assert_allclose(clone.output(x).numpy(), want, rtol=1e-5,
                               atol=1e-6)
    assert clone.iteration_count == net.iteration_count
    assert clone.epoch_count == net.epoch_count
    for lk, lst in net.updater_state.items():
        for pn, st in lst.items():
            for s, t in st.items():
                assert torch.equal(clone.updater_state[lk][pn][s], t)


def test_restore_with_target_shardings(tmp_path):
    net = _model()
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net)
    mesh = _mesh4()
    rows = ShardedTensor.Target(mesh, ("model", None))
    shardings = {"params": {"0": {"W": rows, "b": None},
                            "1": {"W": None, "b": None}}}
    state = ShardedCheckpoint.restore_state(path, shardings)
    w = state["params"]["0"]["W"]            # [8, 16] in 4 row blocks
    assert isinstance(w, ShardedTensor) and len(w.shards) == 4
    assert [tuple(s.shape) for s in w.shards] == [(2, 16)] * 4
    np.testing.assert_allclose(w.full().numpy(),
                               net.param_table()["0_W"].numpy(), rtol=1e-6)


def test_sharded_save_of_sharded_model(tmp_path):
    """A TP trainer's state: the sharded params and updater slots are
    written as blocks (each owner its own), none gathered first."""
    net = _model()
    x, y = _data()
    tr = ShardedParallelTrainer(
        net, make_mesh(MeshSpec.of(model=2, data=2), devices=["cpu"] * 4))
    tr.fit(x, y, batch_size=16)
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net, trainer=tr)
    with np.load(os.path.join(path, "state", "shard-00000.npz")) as z:
        keys = set(z.files)
    assert "params/0/W#0of2@1" in keys and "params/0/W#1of2@1" in keys
    assert "updater_state/0/W/m#1of2@1" in keys and "params/0/W" not in keys
    assert "params/1/W" in keys          # the output layer: replicated
    clone = ShardedCheckpoint.restore(path, device="cpu")
    np.testing.assert_allclose(clone.output(x).numpy(),
                               net.output(x).numpy(), rtol=1e-6)
    for k, v in net.param_table().items():
        assert torch.equal(clone.param_table()[k], v), k


def test_none_leaves_mean_default_placement(tmp_path):
    net = _model()
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net)
    rows = ShardedTensor.Target(_mesh4(), ("model", None))
    shardings = {"params": {"0": {"W": rows, "b": None},
                            "1": {"W": None, "b": None}},
                 "net_state": None, "updater_state": None}
    state = ShardedCheckpoint.restore_state(path, shardings)
    assert isinstance(state["params"]["0"]["W"], ShardedTensor)
    w1 = state["params"]["1"]["W"]
    assert isinstance(w1, torch.Tensor) and w1.device.type == "cpu"
    np.testing.assert_array_equal(w1.numpy(),
                                  net.param_table()["1_W"].numpy())
    clone = ShardedCheckpoint.restore(path, shardings=shardings,
                                      device="cpu")
    for k, v in net.param_table().items():
        assert torch.equal(clone.param_table()[k], v), k


def test_no_meta_side_file(tmp_path):
    net = _model()
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net)
    assert not os.path.exists(os.path.join(path, "meta.json"))
    assert os.path.isdir(os.path.join(path, "meta"))
    assert not os.path.exists(path + ".tmp")


def test_damage_raises_corrupt(tmp_path):
    net = _model()
    path = str(tmp_path / "ckpt")
    ShardedCheckpoint.save(path, net)
    shard = os.path.join(path, "state", "shard-00000.npz")
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["params/0/W"] = arrays["params/0/W"] + 1.0
    with open(shard, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        ShardedCheckpoint.restore(path, device="cpu")
    os.remove(os.path.join(path, "meta", "meta.json"))
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        ShardedCheckpoint.restore(path, device="cpu")


def test_cross_package_parity_by_outputs(tmp_path):
    """JAX's restored model and the port's, both saved from the same
    params, give the same `output()`."""
    jnet = JNet(_jconf()).init()
    net = _model()
    x, _ = _data()
    JShardedCheckpoint.save(str(tmp_path / "jax"), jnet)
    ShardedCheckpoint.save(str(tmp_path / "port"), net)
    jback = JShardedCheckpoint.restore(str(tmp_path / "jax"))
    back = ShardedCheckpoint.restore(str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(back.output(x).numpy(),
                               np.asarray(jback.output(x)), rtol=1e-5,
                               atol=1e-6)
