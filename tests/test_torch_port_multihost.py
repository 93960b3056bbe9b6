"""Several processes over `torch.distributed`
(`deeplearning4j_tpu_torch/parallel/multihost.py`, the global mesh and
the cross-process collectives): the latch and retry lifecycle against
JAX's; `run_smoke(n=2, device="cpu")` with JAX's checks; the
single-process trajectories of the smoke's training against JAX's own
`_run_training` on a mesh of the same shape; and every
`ParallelTrainer` mode and the sharded trainer run in 2 processes (2
mesh devices each, gloo) against one process on the same 4-device mesh,
BatchNorm and dropout included, within JAX's 1e-4."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest

import torch_port_mp as mp
from deeplearning4j_tpu.parallel import multihost as jmh
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.parallel import multihost_smoke


# ------------------------------------------------------ latch and retry
@pytest.fixture
def fake_init(monkeypatch):
    calls = []

    def install(errors):
        errs = list(errors)

        def raw(addr, n, pid, *, backend, timeout):
            calls.append(dict(addr=addr, n=n, pid=pid, backend=backend,
                              timeout=timeout))
            if errs:
                raise errs.pop(0)
        monkeypatch.setattr(multihost, "_raw_initialize", raw)
        monkeypatch.setattr(multihost, "_gather_devices",
                            lambda local: [(0, d) for d in local])
        monkeypatch.setattr(multihost.time, "sleep", lambda s: None)
        return calls
    yield install
    multihost.initialize_multihost._done = False
    multihost._clear_topology_caches()


def test_transient_markers_cover_jax_s():
    assert set(jmh._TRANSIENT_MARKERS) <= set(multihost._TRANSIENT_MARKERS)


def test_latch_is_idempotent_and_shutdown_clears_it(fake_init):
    calls = fake_init([])
    multihost.initialize_multihost("127.0.0.1:1", 1, 0, devices=["cpu"])
    multihost.initialize_multihost("127.0.0.1:1", 1, 0, devices=["cpu"])
    assert len(calls) == 1 and multihost.multihost_active()
    assert calls[0]["backend"] == "gloo"
    cache = {"x": 1}
    multihost._TOPOLOGY_CACHES.append(cache)
    try:
        multihost.shutdown_multihost()
        assert not multihost.multihost_active() and cache == {}
        assert multihost.world() is None
        multihost.shutdown_multihost()          # a no-op when down
    finally:
        multihost._TOPOLOGY_CACHES.remove(cache)


def test_transient_errors_retry_with_backoff(fake_init, monkeypatch):
    slept = []
    calls = fake_init([RuntimeError("Connection refused"),
                       RuntimeError("DEADLINE_EXCEEDED")])
    monkeypatch.setattr(multihost.time, "sleep", slept.append)
    multihost.initialize_multihost("h:1", 1, 0, devices=["cpu"],
                                   max_attempts=3, backoff_s=0.5)
    assert len(calls) == 3 and slept == [0.5, 1.0]


def test_non_transient_error_raises_at_once(fake_init):
    calls = fake_init([ValueError("bad rank")])
    with pytest.raises(ValueError, match="bad rank"):
        multihost.initialize_multihost("h:1", 1, 0, devices=["cpu"])
    assert len(calls) == 1 and not multihost.multihost_active()


def test_all_attempts_failing_raises_jax_s_message(fake_init):
    fake_init([RuntimeError("timed out")] * 3)
    with pytest.raises(RuntimeError, match="all 3 attempts failed"):
        multihost.initialize_multihost("h:1", 1, 0, devices=["cpu"],
                                       max_attempts=3)


def test_backend_follows_devices_and_never_switches(fake_init):
    with pytest.raises(ValueError, match="needs CUDA devices"):
        multihost.initialize_multihost("h:1", 1, 0, devices=["cpu"],
                                       backend="nccl")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize_multihost("h:1")
    # the default devices are a CUDA card: no CUDA here, so it raises
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        multihost.initialize_multihost("h:1", 1, 0)
    calls = fake_init([])
    multihost.initialize_multihost("h:1", 1, 0, devices=["cpu"],
                                   heartbeat_interval_s=2,
                                   max_missing_heartbeats=3)
    assert calls[0]["timeout"].total_seconds() == 6.0


def test_one_process_defaults():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_main_process()


# ------------------------------------------------------------ the smoke
def test_run_smoke_two_processes_on_the_cpu():
    rep = multihost_smoke.run_smoke(2, device="cpu", timeout=240)
    assert rep["match"] and rep["threshold_match"] and rep["eval_merge_match"]
    assert rep["backend"] == "gloo" and rep["n_processes"] == 2


def test_smoke_training_matches_jax_s_single_process():
    """The smoke's dense, TP and threshold trajectories in one process
    against JAX's `_run_training` on its 8 virtual devices (the port's
    on 8 CPU mesh entries), within JAX's 1e-4."""
    from deeplearning4j_tpu.parallel import multihost_smoke as jsmoke
    jl, jthr, _ = jsmoke._run_training()
    pl, pthr, _ = multihost_smoke._run_training("cpu", devices=["cpu"] * 8)
    assert len(pl) == len(jl) and len(pthr) == len(jthr)
    for a, b in zip(pl + pthr, jl + jthr):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (pl, jl, pthr, jthr)


# ------------------------------------------- every mode in 2 processes
@pytest.fixture(scope="module")
def runs():
    return mp.spawn("trainers", 2), mp.single("trainers")


def _close(a, b, tol=1e-4):
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("mode", list(mp.MODES) + ["tp", "fsdp"])
def test_two_processes_match_one(runs, mode):
    """Each mode's losses, params and updater state in 2 processes equal
    the 4-replica single-process run within 1e-4 (the reduction order
    across processes differs: replicas 0+1 and 2+3 first); both
    processes hold the same params."""
    multi, ref = runs
    got, want = multi[0][mode], ref[mode]
    assert multi[1][mode]["params"] == got["params"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    _close(got["params"], want["params"])
    _close(got["updater"], want["updater"])
    if "residual_rows" in want and want["residual_rows"] is not None:
        assert got["residual_rows"] == want["residual_rows"] == 4


def test_global_batch_statistics_and_dropout_rows(runs):
    """The single-barrier step and the sharded trainer are JAX's one
    program over the global batch: across 2 processes BatchNorm takes
    the global batch's statistics (its running mean equal to one
    process's) and dropout the global mask's rows — a per-process mask
    or per-process statistics would move the params far past 1e-4."""
    multi, ref = runs
    for mode in ("dense_global", "tp"):
        _close(multi[0][mode]["params"], ref[mode]["params"], 1e-5)
    np.testing.assert_allclose(multi[0]["tp"]["state"], ref["tp"]["state"],
                               rtol=1e-5, atol=1e-6)
