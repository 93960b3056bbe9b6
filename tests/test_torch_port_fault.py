"""The port's fault runtime (`deeplearning4j_tpu_torch/fault/`) against
the JAX package's, on the CPU: the state schema (the same flat keys,
crc32s and meta keys), interrupt-and-resume bit for bit within the port
(per step, at steps_per_execution 3, under mixed_bf16, and on a
ComputationGraph), checkpoints crossing between the packages in both
directions (each continuing the other's trajectory within 1e-5), the
fallback past corrupt checkpoints, the checkpointer's retention and
queueing, and the iterator cursor.

Nets are tiny MLPs built from one JAX configuration: the port's
`init(seed)` draws JAX's weights, so both packages start equal.
"""

import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import fault as jfault
from deeplearning4j_tpu.common.updaters import Adam as JaxAdam
from deeplearning4j_tpu.common.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.datasets.iterator import (
    ArrayDataSetIterator as JaxArrayIterator,
)
from deeplearning4j_tpu.fault import state as jstate
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxBuilder
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import fault
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.fault import state as fstate
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

CROSS_ATOL = 1e-5      # fp32 params after a resume across the packages


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def jax_conf(depth=1, width=8, n_in=8, n_out=3, seed=7, updater=None):
    b = (JaxBuilder.builder().seed(seed)
         .updater(updater or JaxAdam(0.01)).list())
    b = b.layer(JaxDense(n_in=n_in, n_out=width, activation="tanh"))
    for _ in range(depth - 1):
        b = b.layer(JaxDense(n_in=width, n_out=width, activation="tanh"))
    return (b.layer(JaxOutput(n_in=width, n_out=n_out, activation="softmax",
                              loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(n_in)).build())


def port_net(jconf, dtype_policy=None):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu", dtype_policy=dtype_policy).init()


def make_data(n=48, n_in=8, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def make_iter(x, y, batch=8, shuffle=True):
    return ArrayDataSetIterator(x, y, batch_size=batch, shuffle=shuffle,
                                seed=11)


def flat_state(net):
    """Every param and updater-state leaf of a port net, on the host."""
    arrays = fstate.model_arrays(net)
    return fstate.flatten_arrays({"params": arrays["params"],
                                  "updater_state": arrays["updater_state"]})


def assert_bitwise(a, b):
    fa, fb = flat_state(a), flat_state(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def jax_flat(jnet):
    return jstate.flatten_arrays({"params": jnet.params,
                                  "updater_state": jnet.updater_state})


def interrupt(net, iterator, *, kill_at, freq, ckpt_dir, epochs=2, spe=1,
              package=fault):
    ck = package.AsyncCheckpointer(ckpt_dir, keep_last=10)
    net.add_listener(package.CheckpointListener(ck, frequency=freq,
                                                iterator=iterator))
    net.add_listener(package.PreemptionListener(kill_at, mode="exception"))
    with pytest.raises(package.SimulatedPreemption):
        net.fit(iterator, epochs=epochs, steps_per_execution=spe)
    ck.wait()
    assert ck.steps()
    return ck


# ------------------------------------------------------------ the schema
def test_schema_keys_checksums_and_meta_match_jax():
    """The port's capture of a trained net has JAX's flat keys, crc32s
    and meta keys: JAX restores it, and JAX's own capture of the
    restored net is the same arrays."""
    jconf = jax_conf(depth=2)
    net = port_net(jconf)
    x, y = make_data()
    net.fit(x, y, epochs=1, batch_size=16)
    state = fstate.capture_training_state(net, iterator=make_iter(x, y))
    jnet = JaxNet(jconf).init()
    jstate.restore_training_state(jnet, state)
    jcap = jstate.capture_training_state(jnet)
    got = fstate.flatten_arrays(state["arrays"])
    want = jstate.flatten_arrays(jcap["arrays"])
    assert got.keys() == want.keys()
    assert fstate.checksum_flat(got) == jstate.checksum_flat(want)
    assert set(state["meta"]) - {"iterator"} == set(jcap["meta"])
    for k in ("model_type", "configuration", "dtype_policy",
              "iteration_count", "epoch_count", "format_version"):
        assert state["meta"][k] == jcap["meta"][k], k
    flat = dict(got)
    key = next(iter(flat))
    flat[key] = flat[key] + 1.0
    with pytest.raises(fault.CheckpointCorruptError):
        fstate.verify_checksums(flat, fstate.checksum_flat(got))
    with pytest.raises(ValueError):
        fstate.flatten_arrays({"a\x1fb": np.zeros(2)})


def test_capture_is_a_copy_of_the_live_tensors():
    """The snapshot shares no memory with the params that the next step
    updates in place."""
    net = port_net(jax_conf())
    state = fstate.capture_training_state(net)
    before = fstate.flatten_arrays(state["arrays"])
    before = {k: v.copy() for k, v in before.items()}
    x, y = make_data()
    net.fit(x, y, epochs=1, batch_size=16)
    after = fstate.flatten_arrays(state["arrays"])
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_stateless_updater_restores_and_trains():
    jconf = jax_conf(updater=JaxSgd(0.05))
    net = port_net(jconf)
    x, y = make_data()
    net.fit(x, y, epochs=1, batch_size=16)
    state = fstate.capture_training_state(net)
    clone = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu")
    fstate.restore_training_state(clone, state)
    assert clone.updater_state["0"]["W"] == {}
    assert_bitwise(net, clone)
    clone.fit(x, y, epochs=1, batch_size=16)


# ---------------------------------------------------- interrupt / resume
@pytest.mark.parametrize("arm", ["per_step", "spe3", "mixed_bf16", "graph"])
def test_interrupt_resume_is_bit_equal(tmp_path, arm):
    """Kill at step 7 (a checkpoint every 3 steps), resume and finish:
    params and updater state equal the uninterrupted run bit for bit. At
    spe 3 the kill lands at the group's tail (9) and every checkpoint on
    a group boundary; under mixed_bf16 the policy comes back from the
    checkpoint's meta."""
    x, y = make_data()
    spe = 3 if arm == "spe3" else 1
    policy = "mixed_bf16" if arm == "mixed_bf16" else None

    def build():
        if arm == "graph":
            return graph_net()
        return port_net(jax_conf(depth=3 if policy else 1), policy)

    ref = build()
    ref.fit(make_iter(x, y), epochs=2, steps_per_execution=spe)
    net = build()
    interrupt(net, make_iter(x, y), kill_at=8 if spe == 3 else 7, freq=3,
              ckpt_dir=tmp_path, spe=spe)
    steps = fault.list_checkpoints(tmp_path)
    if spe == 3:
        assert all(s % 3 == 0 for s in steps), steps
    it2 = make_iter(x, y)
    cls = ComputationGraph if arm == "graph" else MultiLayerNetwork
    net2 = cls.resume(tmp_path, device="cpu", iterator=it2)
    assert net2.iteration_count == steps[-1]
    if policy:
        assert net2.dtype.is_mixed
    net2.fit(it2, epochs=2 - net2.epoch_count, steps_per_execution=spe)
    assert net2.iteration_count == ref.iteration_count == 12
    assert_bitwise(ref, net2)


def graph_net():
    from deeplearning4j_tpu_torch.common.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    g = ComputationGraphConfiguration.graph_builder(
        NeuralNetConfiguration.builder().seed(7).updater(Adam(0.01)))
    g.add_inputs("in")
    g.add_layer("d1", DenseLayer(n_in=8, n_out=10, activation="tanh"), "in")
    g.add_layer("out", OutputLayer(n_in=10, n_out=3, activation="softmax",
                                   loss="mcxent"), "d1")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device="cpu").init()


def test_epoch_end_checkpoint_resumes_exact(tmp_path):
    x, y = make_data()
    ref = port_net(jax_conf())
    ref.fit(make_iter(x, y), epochs=3)
    net = port_net(jax_conf())
    it = make_iter(x, y)
    ck = fault.AsyncCheckpointer(tmp_path, async_write=False)
    net.add_listener(fault.CheckpointListener(
        ck, frequency=10 ** 9, epoch_frequency=1, iterator=it))
    net.fit(it, epochs=1)
    it2 = make_iter(x, y)
    net2, meta = fault.resume(tmp_path, iterator=it2, device="cpu")
    assert meta["epoch_count"] == 1
    assert meta["iterator"] == {"epoch": 1, "batch": 0, "seed": 11,
                                "shuffle": True}
    net2.fit(it2, epochs=3 - net2.epoch_count)
    assert net2.iteration_count == ref.iteration_count == 18
    assert_bitwise(ref, net2)


# -------------------------------------------------- across the packages
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_the_bridge(tmp_path, writer):
    """One package trains, is killed at step 7 and checkpoints at 6; the
    other resumes and finishes the two epochs. The result equals the
    writer's uninterrupted run within CROSS_ATOL (fp32), params and
    updater state."""
    jconf = jax_conf(depth=2)
    x, y = make_data()
    if writer == "jax":
        ref = JaxNet(jconf).init()
        ref.fit(JaxArrayIterator(x, y, batch_size=8, shuffle=True, seed=11),
                epochs=2)
        want = jax_flat(ref)
        src = JaxNet(jconf).init()
        interrupt(src, JaxArrayIterator(x, y, batch_size=8, shuffle=True,
                                        seed=11),
                  kill_at=7, freq=3, ckpt_dir=tmp_path, package=jfault)
        it2 = make_iter(x, y)
        net2 = MultiLayerNetwork.resume(tmp_path, device="cpu", iterator=it2)
        net2.fit(it2, epochs=2 - net2.epoch_count)
        got = flat_state(net2)
    else:
        ref = port_net(jconf)
        ref.fit(make_iter(x, y), epochs=2)
        want = flat_state(ref)
        interrupt(port_net(jconf), make_iter(x, y), kill_at=7, freq=3,
                  ckpt_dir=tmp_path)
        it2 = JaxArrayIterator(x, y, batch_size=8, shuffle=True, seed=11)
        jnet2, meta = jfault.resume(tmp_path, iterator=it2)
        assert meta["iteration_count"] == 6
        jnet2.fit(it2, epochs=2 - jnet2.epoch_count)
        assert jnet2.iteration_count == 12
        got = jax_flat(jnet2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=CROSS_ATOL, err_msg=k)


# ------------------------------------------------------------ corruption
def _checkpointed_run(tmp_path):
    x, y = make_data()
    net = port_net(jax_conf())
    ck = fault.AsyncCheckpointer(tmp_path, keep_last=10, async_write=False)
    net.add_listener(fault.CheckpointListener(ck, frequency=2))
    net.fit(make_iter(x, y), epochs=1)
    return fault.list_checkpoints(tmp_path)


@pytest.mark.parametrize("how", ["flip", "truncate", "manifest",
                                 "all_corrupt", "empty"])
def test_corruption_falls_back(tmp_path, caplog, how):
    if how == "empty":
        with pytest.raises(FileNotFoundError):
            fault.resume(tmp_path, device="cpu")
        return
    steps = _checkpointed_run(tmp_path)
    assert steps == [2, 4, 6]
    if how == "all_corrupt":
        for s in steps:
            fault.corrupt_checkpoint(tmp_path, step=s, mode="flip")
        with pytest.raises(fault.CheckpointCorruptError) as e:
            fault.resume(tmp_path, device="cpu")
        assert all(f"step {s}" in str(e.value) for s in steps)
        return
    if how == "manifest":
        fault.corrupt_checkpoint(tmp_path, mode="truncate",
                                 target="manifest")
    else:
        fault.corrupt_checkpoint(tmp_path, mode=how)
    with caplog.at_level(logging.WARNING):
        net, meta = fault.resume(tmp_path, device="cpu")
    assert meta["iteration_count"] == 4
    assert "corrupt" in caplog.text
    # JAX falls back to the same checkpoint
    jnet, jmeta = jfault.resume(tmp_path)
    assert jmeta["iteration_count"] == 4


# ---------------------------------------------------------- checkpointer
def _state(i):
    return {"arrays": {"params": {"0": {"W": np.full((4, 4), float(i),
                                                     np.float32)}}},
            "meta": {"iteration_count": i, "epoch_count": 0}}


@pytest.mark.parametrize("case", ["commit", "retention", "latest_wins",
                                  "writer_error"])
def test_checkpointer(tmp_path, case):
    import os
    if case == "commit":
        ck = fault.AsyncCheckpointer(tmp_path, async_write=False)
        ck.save(_state(5), 5)
        assert ck.steps() == [5]
        got = ck.load()
        assert got["meta"]["iteration_count"] == 5
        assert np.array_equal(got["arrays"]["params"]["0"]["W"],
                              np.full((4, 4), 5.0, np.float32))
        assert sorted(os.listdir(tmp_path / "ckpt-00000005")) == [
            "MANIFEST.json", "manifest-00000.json", "shard-00000.npz"]
        assert not [e for e in os.listdir(tmp_path)
                    if e.startswith(".tmp-")]
        # JAX reads the port's layout
        assert jfault.load_checkpoint(tmp_path, 5)["meta"] == got["meta"]
    elif case == "retention":
        ck = fault.AsyncCheckpointer(tmp_path, keep_last=2, keep_every=10,
                                     async_write=False)
        (tmp_path / ".tmp-ckpt-00000003").mkdir()      # a crashed write
        for s in (5, 10, 15, 20, 25):
            ck.save(_state(s), s)
        assert ck.steps() == [10, 20, 25]
        assert not (tmp_path / ".tmp-ckpt-00000003").exists()
    elif case == "latest_wins":
        ck = fault.AsyncCheckpointer(tmp_path, keep_last=10)
        for s in (1, 2, 3, 4):
            ck.save(_state(s), s)
        ck.wait()
        assert ck.steps()[-1] == 4
        ck.close()
    else:
        ck = fault.AsyncCheckpointer(tmp_path)
        bad = dict(_state(1), meta={"not_json": object()})
        ck.save(bad, 1)
        with pytest.raises(Exception):
            ck.wait()
        ck.save(_state(2), 2)          # the error was raised once
        ck.wait()
        assert ck.steps() == [2]


# --------------------------------------------------------------- cursor
def test_iterator_cursor_mid_epoch_matches_jax():
    """The port's cursor equals JAX's at every batch of two shuffled
    passes, and a seek to a mid-epoch cursor continues with JAX's next
    batch under the same permutation."""
    x, y = make_data(n=40)
    a = make_iter(x, y)
    ja = JaxArrayIterator(x, y, batch_size=8, shuffle=True, seed=11)
    for _ in range(2):
        for ds, jds in zip(a, ja):
            assert np.array_equal(ds.features, np.asarray(jds.features))
            assert a.cursor() == ja.cursor()
    cur = {"epoch": 1, "batch": 2, "seed": 11, "shuffle": True}
    b = make_iter(x, y)
    b.seek(cur)
    jb = JaxArrayIterator(x, y, batch_size=8, shuffle=True, seed=11)
    jb.seek(cur)
    got, want = list(b), list(jb)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.features, np.asarray(w.features))
    assert b.cursor() == jb.cursor() == {"epoch": 1, "batch": 5, "seed": 11,
                                         "shuffle": True}
    assert len(list(b)) == 5           # the next pass is whole
    with pytest.raises(NotImplementedError):
        ListDataSetIterator([]).seek(cur)
    assert ListDataSetIterator([]).cursor() is None


def test_restore_rejects_a_state_of_another_model():
    state = fstate.capture_training_state(port_net(jax_conf(width=8)))
    with pytest.raises(ValueError):
        fstate.restore_training_state(port_net(jax_conf(width=9)), state)
    state["arrays"]["params"]["7"] = {"W": np.zeros(2, np.float32)}
    with pytest.raises(KeyError):
        fstate.restore_training_state(port_net(jax_conf()), state)


def test_resume_defaults_to_the_card(tmp_path):
    ck = fault.AsyncCheckpointer(tmp_path, async_write=False)
    net = port_net(jax_conf())
    ck.save(fstate.capture_training_state(net), 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiLayerNetwork.resume(tmp_path)
    with pytest.raises(TypeError):
        ComputationGraph.resume(tmp_path, device="cpu")


def test_drills_auto_resume_and_listener_options(tmp_path):
    """`auto_resume` reruns an attempt after each SimulatedPreemption and
    the resumed attempts finish the uninterrupted run's bits;
    `checkpoint_meta` reads the manifest's meta; `save_now` and
    `save_at_fit_end` checkpoint off the cadence; a mode outside
    exception/sigterm/sigkill is refused."""
    x, y = make_data()
    ref = port_net(jax_conf())
    ref.fit(make_iter(x, y), epochs=2)
    ck = fault.AsyncCheckpointer(tmp_path, keep_last=10)

    def attempt(i):
        it = make_iter(x, y)
        if i == 0:
            net = port_net(jax_conf())
        else:
            net, _ = fault.resume(tmp_path, iterator=it, device="cpu")
        net.add_listener(fault.CheckpointListener(ck, frequency=2,
                                                  iterator=it))
        if i < 2:
            net.add_listener(fault.PreemptionListener(
                5 + 4 * i, wait_for_checkpointer=ck))
        net.fit(it, epochs=2 - net.epoch_count)
        return net

    net, restarts = fault.auto_resume(attempt, max_restarts=3)
    assert restarts == 2
    assert_bitwise(ref, net)
    assert fault.checkpoint_meta(tmp_path)["iteration_count"] == 12
    with pytest.raises(RuntimeError):
        fault.auto_resume(lambda i: (_ for _ in ()).throw(
            fault.SimulatedPreemption(i)), max_restarts=1)
    listener = fault.CheckpointListener(str(tmp_path / "b"), frequency=100,
                                        save_at_fit_end=True)
    net2 = port_net(jax_conf())
    net2.add_listener(listener)
    net2.fit(x, y, batch_size=16)
    listener.save_now(net2, 1, 0)
    listener.checkpointer.wait()
    assert fault.list_checkpoints(tmp_path / "b") == [1, 3]
    with pytest.raises(ValueError):
        fault.PreemptionListener(3, mode="sighup")


def test_sigkill_drill_leaves_the_last_checkpoint(tmp_path):
    """mode="sigkill" ends the process at the step (as a preemption does,
    with no handler run); the checkpoint committed before it resumes."""
    import subprocess
    import sys
    code = f"""
import numpy as np
from deeplearning4j_tpu_torch import fault
from deeplearning4j_tpu_torch.datasets.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
    open({str(tmp_path / 'conf.json')!r}).read()), device="cpu").init()
rng = np.random.default_rng(0)
x = rng.standard_normal((48, 8)).astype(np.float32)
y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 48)]
ck = fault.AsyncCheckpointer({str(tmp_path / 'ck')!r}, async_write=False)
net.add_listener(fault.CheckpointListener(ck, frequency=2))
net.add_listener(fault.PreemptionListener(5, mode="sigkill"))
net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=1)
print("not killed")
"""
    (tmp_path / "conf.json").write_text(jax_conf().to_json())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == -9, out.stderr
    assert "not killed" not in out.stdout
    net, meta = fault.resume(tmp_path / "ck", device="cpu")
    assert meta["iteration_count"] == 4 and net.iteration_count == 4
