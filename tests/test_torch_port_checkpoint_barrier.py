"""The checkpointer's multi-process barrier
(`deeplearning4j_tpu_torch/fault/checkpointer.py`, JAX's
`fault/checkpointer.py:240-345`): a threshold ParallelTrainer run in 2
processes commits behind the barrier and resumes bit-equal; the merged
MANIFEST keeps JAX's layout, so JAX resumes the port's 2-process
checkpoint; the barrier waits for a RANK SET (stale higher-rank
manifests neither satisfy nor pollute it); a barrier that does not
fill raises JAX's `CheckpointCorruptError`; a concurrent committer is
tolerated; and each package's `_merge_and_commit` commits the
manifests the other's processes wrote."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import threading
import time

import jax
import numpy as np
import pytest

import torch_port_mp as mp
from deeplearning4j_tpu import fault as jfault
from deeplearning4j_tpu.fault import checkpointer as jck
from deeplearning4j_tpu_torch import fault
from deeplearning4j_tpu_torch.fault import checkpointer as ck
from deeplearning4j_tpu_torch.fault.errors import CheckpointCorruptError
from deeplearning4j_tpu_torch.parallel import multihost


def _state(step=2):
    rng = np.random.default_rng(step)
    arrays = {"params": {"0": {"W": rng.standard_normal((3, 4)).astype(
        np.float32)}}}
    return {"arrays": arrays, "meta": {"step": step, "tag": "x"}}


def _as_process(monkeypatch, rank, n):
    monkeypatch.setattr(multihost, "process_index", lambda: rank)
    monkeypatch.setattr(multihost, "process_count", lambda: n)


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("barrier") / "ck"
    return d, mp.spawn("checkpoint", 2, dir=str(d))


def test_two_process_commit_resumes_bit_equal(two_process_run):
    d, res = two_process_run
    for r in res:
        assert r["resumed_at"] == 2 and r["bit_equal"]
    manifest = json.loads((d / "ckpt-00000002" / "MANIFEST.json")
                          .read_text())
    assert manifest["process_count"] == 2
    assert manifest["shards"] == ["shard-00000.npz"]
    files = sorted(p.name for p in (d / "ckpt-00000002").iterdir())
    assert files == ["MANIFEST.json", "manifest-00000.json",
                     "manifest-00001.json", "shard-00000.npz"]


def test_jax_resumes_the_port_s_two_process_checkpoint(two_process_run):
    """JAX loads the port's 2-process checkpoint: the same arrays, its
    checksums verified, and the per-replica stacks of all 4 replicas."""
    d, _ = two_process_run
    j = jck.load_checkpoint(d, 2)
    p = ck.load_checkpoint(d, 2)
    assert j["meta"]["trainer"]["kind"] == "threshold"
    jf, pf = (jfault.state.flatten_arrays(j["arrays"]),
              fault.state.flatten_arrays(p["arrays"]))
    assert set(jf) == set(pf)
    for k in jf:
        np.testing.assert_array_equal(np.asarray(jf[k]), pf[k])
    res = j["arrays"]["trainer"]["residual_r"]
    assert next(iter(next(iter(res.values())).values())).shape[0] == 4
    # and a JAX trainer resumes from it: counters, params, residual
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import (
        BatchNormalization, DenseLayer, OutputLayer)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.parallel import (
        MeshSpec, ParallelTrainer, make_mesh)
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Adam(1e-2))
            .list()
            .layer(DenseLayer(n_in=16, n_out=16, activation="tanh",
                              dropout=0.8))
            .layer(BatchNormalization(n_out=16))
            .layer(DenseLayer(n_in=16, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(16)).build())
    jnet = MultiLayerNetwork(conf).init()
    jt = ParallelTrainer(jnet, make_mesh(MeshSpec.of(data=4)),
                         gradient_sharing="threshold")
    jt.resume(str(d))
    assert jnet.iteration_count == 2
    for lk, lp in p["arrays"]["params"].items():
        for pn, a in lp.items():
            np.testing.assert_array_equal(np.asarray(jnet.params[lk][pn]), a)
    jres = jt.threshold_residual()
    for lk, lp in p["arrays"]["trainer"]["residual_r"].items():
        for pn, a in lp.items():
            np.testing.assert_array_equal(np.asarray(jres[lk][pn]), a)


def test_barrier_waits_for_the_rank_set_not_a_file_count(tmp_path,
                                                         monkeypatch):
    """A stale manifest of rank 2 (an aborted wider world) sits in the
    tmp dir: it must not satisfy a 2-rank barrier, and it must not land
    in the merged manifest."""
    c = fault.AsyncCheckpointer(tmp_path, async_write=False,
                                merge_timeout_s=20)
    tmp = tmp_path / ".tmp-ckpt-00000002"
    tmp.mkdir()
    (tmp / "manifest-00002.json").write_text(json.dumps(
        {"process": 2, "shard": "shard-00002.npz",
         "checksums": {"bogus": 1}, "meta": {"stale": True}}))
    _as_process(monkeypatch, 1, 2)
    c.save(_state(), 2)             # rank 1: its manifest only
    _as_process(monkeypatch, 0, 2)
    t0 = time.perf_counter()
    c.save(_state(), 2)             # rank 0: shard, barrier, commit
    assert time.perf_counter() - t0 < 10
    m = json.loads((tmp_path / "ckpt-00000002" / "MANIFEST.json")
                   .read_text())
    assert m["process_count"] == 2 and m["shards"] == ["shard-00000.npz"]
    assert "bogus" not in m["checksums"] and m["meta"] == {"step": 2,
                                                           "tag": "x"}
    assert c.load(2)["meta"]["tag"] == "x"


def test_barrier_with_a_missing_rank_waits_then_times_out(tmp_path,
                                                          monkeypatch):
    c = fault.AsyncCheckpointer(tmp_path, async_write=False,
                                merge_timeout_s=0.3)
    _as_process(monkeypatch, 0, 2)
    with pytest.raises(CheckpointCorruptError,
                       match=r"checkpoint step 2: only ranks \[0\] of 2 "
                             r"arrived within 0.3s"):
        c.save(_state(), 2)
    assert c.steps() == []


def test_barrier_fills_when_the_other_rank_arrives(tmp_path, monkeypatch):
    c = fault.AsyncCheckpointer(tmp_path, async_write=False,
                                merge_timeout_s=20)
    tmp = tmp_path / ".tmp-ckpt-00000004"
    tmp.mkdir()

    def rank1():
        time.sleep(0.3)
        (tmp / "manifest-00001.json").write_text(json.dumps(
            {"process": 1, "shard": None, "checksums": {},
             "meta": {"step": 4}}))
    t = threading.Thread(target=rank1)
    _as_process(monkeypatch, 0, 2)
    t.start()
    c.save(_state(4), 4)
    t.join()
    assert c.steps() == [4]


def test_a_concurrent_committer_is_tolerated(tmp_path):
    """The tmp dir was renamed into place by another committer of the
    same step: its commit stands and this one returns quietly."""
    c = fault.AsyncCheckpointer(tmp_path, merge_timeout_s=5)
    final = tmp_path / "ckpt-00000003"
    final.mkdir()
    c._merge_and_commit(3, tmp_path / ".tmp-ckpt-00000003", final, 2)
    assert final.exists()


def _jax_write(monkeypatch, d, rank, n, step):
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    c = jck.AsyncCheckpointer(d, async_write=False, merge_timeout_s=0.01)
    if rank == 0:
        c._merge_and_commit = lambda *a: None      # the port commits
    c.save(_state(step), step)


def test_port_commits_manifests_jax_processes_wrote(tmp_path, monkeypatch):
    _jax_write(monkeypatch, tmp_path, 1, 2, 6)
    _jax_write(monkeypatch, tmp_path, 0, 2, 6)
    c = fault.AsyncCheckpointer(tmp_path, merge_timeout_s=5)
    c._merge_and_commit(6, tmp_path / ".tmp-ckpt-00000006",
                        tmp_path / "ckpt-00000006", 2)
    for load in (ck.load_checkpoint, jck.load_checkpoint):
        got = load(tmp_path, 6)
        np.testing.assert_array_equal(
            np.asarray(got["arrays"]["params"]["0"]["W"]),
            _state(6)["arrays"]["params"]["0"]["W"])


def test_jax_commits_manifests_port_processes_wrote(tmp_path, monkeypatch):
    c = fault.AsyncCheckpointer(tmp_path, async_write=False)
    _as_process(monkeypatch, 1, 2)
    c.save(_state(8), 8)
    _as_process(monkeypatch, 0, 2)
    monkeypatch.setattr(c, "_merge_and_commit", lambda *a: None)
    monkeypatch.setattr(c, "_gc", lambda: None)
    c.save(_state(8), 8)
    j = jck.AsyncCheckpointer(tmp_path, merge_timeout_s=5)
    j._merge_and_commit(8, tmp_path / ".tmp-ckpt-00000008",
                        tmp_path / "ckpt-00000008", 2)
    for load in (ck.load_checkpoint, jck.load_checkpoint):
        got = load(tmp_path, 8)
        np.testing.assert_array_equal(
            np.asarray(got["arrays"]["params"]["0"]["W"]),
            _state(8)["arrays"]["params"]["0"]["W"])
