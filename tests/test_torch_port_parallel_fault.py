"""ParallelTrainer checkpoints (`fault/` with a trainer) in the port and
across the packages, on 4-way CPU meshes: a run killed mid-epoch and
resumed continues bit for bit per checkpoint kind (dense, threshold
bucketed and single-barrier, dense_rs, threshold_rs, averaging: the
residual, τ tree and updater stacks, or averaging's stacks and cadence,
ride the checkpoint); JAX-written trainer checkpoints resumed by the
port and the port's by JAX continue each other's runs; an elastic
resume at another replica count keeps Σ residual; and
`reshard_replica_stack` / `stacked_replica_count` equal JAX's."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import fault as jfault
from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.fault import state as jstate
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import MeshSpec as JaxMeshSpec
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_make_mesh
from deeplearning4j_tpu_torch import fault
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.fault import state as fstate
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ParallelTrainer,
    make_mesh,
)

CROSS_ATOL = 1e-5
KINDS = {"dense": dict(gradient_sharing="dense"),
         "threshold": dict(gradient_sharing="threshold"),
         "threshold_single": dict(gradient_sharing="threshold",
                                  bucketed=False),
         "dense_rs": dict(gradient_sharing="dense_rs"),
         "threshold_rs": dict(gradient_sharing="threshold_rs"),
         "averaging": dict(mode="averaging", averaging_frequency=3)}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for v in ("DL4J_GRADIENT_SHARING", "DL4J_BUCKETED_EXCHANGE",
              "DL4J_DTYPE_POLICY"):
        monkeypatch.delenv(v, raising=False)


def jconf(width=16, bn=False):
    b = JaxBuilder.builder().seed(3).updater(JaxAdam(0.01)).list()
    b = b.layer(JaxDense(n_in=16, n_out=width, activation="tanh"))
    if bn:
        b = b.layer(JaxBN(n_out=width))
    for _ in range(2):
        b = b.layer(JaxDense(n_in=width, n_out=width, activation="tanh"))
    return (b.layer(JaxOutput(n_in=width, n_out=4, activation="softmax",
                              loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(16)).build())


def port_net(c):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(c.to_json()),
                             device="cpu").init()


def data(n=128):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def pmesh(n=4):
    return make_mesh(MeshSpec.of(data=n), devices=["cpu"] * n)


def jmesh(n=4):
    return jax_make_mesh(JaxMeshSpec.of(data=n))


def it_port(x, y):
    return ArrayDataSetIterator(x, y, batch_size=16, shuffle=True, seed=5)


def it_jax(x, y):
    return JaxArrayIterator(x, y, batch_size=16, shuffle=True, seed=5)


def bit_equal(a, b):
    for k, v in a.param_table().items():
        assert torch.equal(v, b.param_table()[k]), k
    for lk, lst in a.updater_state.items():
        for pk, st in lst.items():
            for sk, v in st.items():
                assert torch.equal(v, b.updater_state[lk][pk][sk]), (lk, pk)
    for lk, st in a.net_state.items():
        for n, v in st.items():
            assert torch.equal(v, b.net_state[lk][n]), (lk, n)


def killed_run(c, kw, d, x, y, n=4, kill=7):
    net = port_net(c)
    it = it_port(x, y)
    ck = fault.AsyncCheckpointer(d)
    net.set_listeners(fault.CheckpointListener(ck, frequency=5, iterator=it),
                      fault.PreemptionListener(kill, wait_for_checkpointer=ck))
    with pytest.raises(fault.SimulatedPreemption):
        ParallelTrainer(net, pmesh(n), **kw).fit(it, epochs=2)
    ck.wait()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kill_and_resume_bit_equal(kind, tmp_path):
    c = jconf(width=64 if kind.endswith("rs") else 16,
              bn=kind in ("threshold", "averaging"))
    kw = KINDS[kind]
    x, y = data()
    ref = port_net(c)
    ParallelTrainer(ref, pmesh(), **kw).fit(it_port(x, y), epochs=2)
    killed_run(c, kw, str(tmp_path), x, y)
    meta = fault.checkpoint_meta(str(tmp_path))
    want_kind = {"dense": "sync_dense", "threshold_single": "threshold",
                 "dense_rs": "sync_dense_rs"}.get(kind, kind)
    assert meta["trainer"]["kind"] == want_kind
    assert meta["trainer"]["n_workers"] == 4
    net = port_net(c)
    it = it_port(x, y)
    t = ParallelTrainer(net, pmesh(), **kw)
    t.resume(str(tmp_path), iterator=it)
    assert net.iteration_count == 5
    t.fit(it, epochs=2 - net.epoch_count)
    assert net.iteration_count == ref.iteration_count == 16
    bit_equal(ref, net)


def test_threshold_checkpoint_carries_the_stacks(tmp_path):
    c = jconf()
    x, y = data()
    killed_run(c, KINDS["threshold"], str(tmp_path), x, y)
    state, _ = fault.load_latest_valid(str(tmp_path))
    tr = state["arrays"]["trainer"]
    assert set(tr) == {"residual_r", "tau", "upd_r"}
    assert tr["residual_r"]["0"]["W"].shape == (4, 16, 16)
    assert tr["upd_r"]["0"]["W"]["m"].shape == (4, 16, 16)
    assert set(tr["tau"]) == {"0", "1", "2", "3"}
    # drift: the replicas' Adam moments differ
    m = tr["upd_r"]["0"]["W"]["m"]
    assert not np.array_equal(m[0], m[1])


@pytest.mark.parametrize("kind", ["threshold", "averaging", "dense"])
def test_jax_checkpoint_resumed_by_the_port(kind, tmp_path):
    """JAX trains, checkpoints at step 5 and dies at 7; the port resumes
    that directory and finishes; JAX's uninterrupted run is the
    reference."""
    c = jconf()
    kw = KINDS[kind]
    x, y = data()
    jref = JaxNet(c).init()
    JaxTrainer(jref, jmesh(), **kw).fit(it_jax(x, y), epochs=2)
    jn = JaxNet(c).init()
    jit = it_jax(x, y)
    ck = jfault.AsyncCheckpointer(str(tmp_path))
    jn.set_listeners(jfault.CheckpointListener(ck, frequency=5,
                                               iterator=jit),
                     jfault.PreemptionListener(7, wait_for_checkpointer=ck))
    with pytest.raises(jfault.SimulatedPreemption):
        JaxTrainer(jn, jmesh(), **kw).fit(jit, epochs=2)
    ck.wait()
    net = port_net(c)
    it = it_port(x, y)
    t = ParallelTrainer(net, pmesh(), **kw)
    t.resume(str(tmp_path), iterator=it)
    assert net.iteration_count == 5
    t.fit(it, epochs=2 - net.epoch_count)
    for k, v in jref.param_table().items():
        np.testing.assert_allclose(net.param_table()[k].numpy(),
                                   np.asarray(v), atol=CROSS_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["threshold", "averaging"])
def test_port_checkpoint_resumed_by_jax(kind, tmp_path):
    c = jconf()
    kw = KINDS[kind]
    x, y = data()
    ref = port_net(c)
    ParallelTrainer(ref, pmesh(), **kw).fit(it_port(x, y), epochs=2)
    killed_run(c, kw, str(tmp_path), x, y)
    jn = JaxNet(c).init()
    jit = it_jax(x, y)
    jt = JaxTrainer(jn, jmesh(), **kw)
    jt.resume(str(tmp_path), iterator=jit)
    assert jn.iteration_count == 5
    jt.fit(jit, epochs=2 - jn.epoch_count)
    for k, v in ref.param_table().items():
        np.testing.assert_allclose(np.asarray(jn.param_table()[k]),
                                   v.numpy(), atol=CROSS_ATOL, err_msg=k)


def test_elastic_resume_keeps_the_residual_sum(tmp_path):
    """Written at 4 replicas, resumed at 2: Σ residual is conserved (the
    float64 sum rounded to float32 equals the new float32 sum) and the
    updater stacks restart from the replica mean."""
    c = jconf()
    x, y = data()
    killed_run(c, KINDS["threshold"], str(tmp_path), x, y)
    state, _ = fault.load_latest_valid(str(tmp_path))
    old = state["arrays"]["trainer"]["residual_r"]
    net = port_net(c)
    t = ParallelTrainer(net, pmesh(2), gradient_sharing="threshold")
    t.resume(str(tmp_path))
    t._threshold_state(True)
    new = t.threshold_residual()
    for lk in old:
        for pk in old[lk]:
            want = old[lk][pk].sum(axis=0, dtype=np.float64).astype(
                np.float32)
            got = new[lk][pk].sum(axis=0)
            np.testing.assert_array_equal(got, want)
            assert new[lk][pk].shape[0] == 2
    t.fit(it_port(x, y), epochs=1)
    assert np.isfinite(net.score_value)


@pytest.mark.parametrize("kind", ["residual", "state"])
@pytest.mark.parametrize("old_n,new_n", [(4, 2), (2, 4), (4, 4), (3, 8)])
def test_reshard_replica_stack_matches_jax(kind, old_n, new_n):
    rng = np.random.default_rng(old_n * 10 + new_n)
    tree = {"0": {"W": rng.standard_normal((old_n, 3, 5)).astype(np.float32),
                  "step": np.arange(old_n, dtype=np.int32)},
            "tau": np.float32(1e-3)}
    got = fstate.reshard_replica_stack(tree, new_n, kind=kind)
    want = jstate.reshard_replica_stack(tree, new_n, kind=kind)
    for k in ("W", "step"):
        np.testing.assert_array_equal(got["0"][k], np.asarray(want["0"][k]))
        assert got["0"][k].dtype == np.asarray(want["0"][k]).dtype
    assert got["tau"] == want["tau"]
    assert fstate.stacked_replica_count(got["0"]) == new_n
    assert fstate.stacked_replica_count({}) is None
    assert (fstate.stacked_replica_count(tree["0"])
            == jstate.stacked_replica_count(tree["0"]))
