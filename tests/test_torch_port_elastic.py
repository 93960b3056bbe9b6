"""Elastic training (`deeplearning4j_tpu_torch/parallel/elastic.py`) held to
JAX's `deeplearning4j_tpu/parallel/elastic.py`:

- both coordinators, driven by the same register / heartbeat / leave /
  eviction script on one fake clock, commit the same generations
  (members, ranks, rendezvous ports, serving members) and report the
  same status and metrics; each package's client speaks to the other's
  coordinator;
- control-plane retry and degradation as `tests/test_elastic.py:171-220`;
- `distributed_failure` classifies what torch raises when a peer dies;
- `serving_directory` is JAX's;
- the in-process `ElasticTrainer` (seams stubbed, 4 -> 2 -> 4 CPU
  replicas over one join and one leave at scripted steps) tracks JAX's
  `_InProcessElasticTrainer` on the same net, data and seeds within
  JAX's bands, in dense and threshold, with equal `history`;
- the world re-forms in one process: after a failed rendezvous, and
  after a peer's SIGKILL (2 spawned processes: `device_mesh()` spans
  them, the drain check ORs their flags, the broken collective is
  classified, the teardown is bounded, a world of another size comes
  up at another port)."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import shutil
import socket
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

import torch_port_mp as mp
from deeplearning4j_tpu import monitor as jmonitor
from deeplearning4j_tpu.parallel import elastic as jel
from deeplearning4j_tpu_torch import fault, monitor
from deeplearning4j_tpu_torch.parallel import elastic as pel
from deeplearning4j_tpu_torch.parallel import multihost


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(pred, timeout=20.0, poll=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(poll)
    raise AssertionError(f"{what} not reached within {timeout}s")


# ============================================ the coordinators, scripted
class Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


class _OneTick:
    """Stands in for the coordinator's stop event: `_monitor_loop` runs
    exactly one pass, in the caller's thread, at the fake clock."""

    def __init__(self):
        self.calls = 0

    def wait(self, timeout):
        self.calls += 1
        return self.calls > 1


def _coordinator(mod, clock, monkeypatch, base):
    monkeypatch.setattr(mod, "time", clock)
    co = mod.ElasticCoordinator(grace_s=5.0, settle_s=1.0, tick_s=0.25,
                                min_members=2, jax_port_base=base,
                                jax_port_span=7)
    co._server.server_close()

    def tick(at):
        clock.now = at
        co._stopped = _OneTick()
        co._monitor_loop()
    return co, tick


SCRIPT = [
    ("register", dict(token="w1", host="hostB", device_count=2)),
    ("tick", 100.5),
    ("register", dict(token="w0", host="hostA", device_count=4,
                      info={"phase": "join"})),
    ("tick", 101.2),                       # settle not passed since w0
    ("tick", 102.1),                       # generation 1: w0, w1
    ("heartbeat", dict(token="w0", generation=0, info={"step": 3})),
    ("heartbeat", dict(token="w1", generation=1, info={"step": 3})),
    ("tick", 103.0),
    ("heartbeat", dict(token="w0", generation=1, info={"step": 5})),
    ("tick", 107.5),                       # w1 silent since 102.1: evicted
    ("heartbeat", dict(token="w0", generation=1, info={"step": 6})),
    ("tick", 108.6),                       # generation 2: w0
    ("heartbeat", dict(token="w1", generation=1)),   # evicted: re-register
    ("register", dict(token="w1", host="hostB", device_count=2)),
    ("register", dict(token="w2", host="hostC")),
    ("register", dict(token="w0", host="hostA", device_count=4)),
    ("tick", 109.0),
    ("tick", 110.0),                       # generation 3: w0, w1, w2
    ("register", dict(token="srv", host="hostS", device_count=0,
                      info={"role": "serving", "model": "lm",
                            "addr": ["hostS", 9000], "queue_depth": 3})),
    ("tick", 111.5),                       # generation 4: serving member
    ("leave", dict(token="w2", reason="complete")),
    ("leave", dict(token="nobody", reason="x")),
    ("tick", 113.0),                       # generation 5: w0, w1
    ("plan", {}),
    ("status", {}),
    ("bogus", {}),
]


def _run_script(mod, monkeypatch, base):
    clock = Clock()
    co, tick = _coordinator(mod, clock, monkeypatch, base)
    trace = []
    for op, arg in SCRIPT:
        if op == "tick":
            tick(arg)
            trace.append(("tick", co._generation, co._plan))
            continue
        req = dict(arg, op=op)
        try:
            reply = co._handle(req)
        except ValueError as e:
            reply = {"error": str(e)}
        trace.append((op, reply))
        trace.append(("status", co.status()))
    return trace


def test_coordinators_commit_the_same_generations(monkeypatch):
    jreg, preg = jmonitor.MetricsRegistry(), monitor.MetricsRegistry()
    jmonitor.enable(registry=jreg)
    monitor.enable(preg, jit_compile=False, device_memory=False)
    try:
        jt = _run_script(jel, monkeypatch, 51000)
        pt = _run_script(pel, monkeypatch, 51000)
    finally:
        jmonitor.disable()
        monitor.disable()
    assert pt == jt
    plans = [t[2] for t in pt if t[0] == "tick" and t[2] is not None]
    last = plans[-1]
    assert last["generation"] == 5 and last["num_processes"] == 2
    assert [(m["token"], m["rank"]) for m in last["members"]] == [
        ("w0", 0), ("w1", 1)]
    assert last["coordinator_address"] == f"hostA:{51000 + 5 % 7}"
    gens = sorted({p["generation"] for p in plans})
    assert gens == [1, 2, 3, 4, 5]
    # serving members never take a training rank
    g4 = next(p for p in plans if p["generation"] == 4)
    assert [m["token"] for m in g4["serving_members"]] == ["srv"]
    assert g4["num_processes"] == 3
    assert preg.snapshot() == jreg.snapshot()
    assert preg.snapshot()["elastic_reconfigurations_total"]["values"][0][
        "value"] == 4.0


def test_commit_records_the_flight_recorder(monkeypatch):
    from deeplearning4j_tpu_torch.monitor.flightrec import (
        GLOBAL_FLIGHT_RECORDER)
    n0 = len(GLOBAL_FLIGHT_RECORDER.events(kind="elastic_reconfiguration"))
    _run_script(pel, monkeypatch, 51000)
    evs = GLOBAL_FLIGHT_RECORDER.events(kind="elastic_reconfiguration")[n0:]
    assert [e["generation"] for e in evs] == [1, 2, 3, 4, 5]
    assert evs[0]["members"] == ["w0", "w1"]


@pytest.fixture
def coordinator():
    co = pel.ElasticCoordinator(settle_s=0.05, grace_s=0.6, tick_s=0.01,
                                min_members=1).start()
    yield co
    co.stop()


@pytest.mark.parametrize("cmod,kmod", [(pel, jel), (jel, pel)],
                         ids=["port_coordinator_jax_client",
                              "jax_coordinator_port_client"])
def test_each_package_s_client_joins_the_other_s_coordinator(cmod, kmod):
    co = cmod.ElasticCoordinator(settle_s=0.05, grace_s=5, tick_s=0.01,
                                 min_members=2).start()
    try:
        a = kmod.ElasticClient(co.address, "bb")
        b = kmod.ElasticClient(co.address, "aa")
        a.register(host="hostA", device_count=2)
        b.register(host="hostB", device_count=1)
        plan = a.await_member_plan(timeout_s=10)
        assert [m["token"] for m in plan["members"]] == ["aa", "bb"]
        assert b.my_rank(plan) == 0 and a.my_rank(plan) == 1
        port = co.jax_port_base + plan["generation"] % co.jax_port_span
        assert plan["coordinator_address"] == f"hostB:{port}"
    finally:
        co.stop()


def test_leave_bumps_the_generation_and_the_port(coordinator):
    a = pel.ElasticClient(coordinator.address, "a",
                          heartbeat_interval_s=0.05)
    b = pel.ElasticClient(coordinator.address, "b")
    a.register(), b.register()
    a.start_heartbeats()
    p1 = a.await_member_plan(timeout_s=10)
    b.leave("shrink")

    def post_leave():
        plan = a.await_member_plan(timeout_s=1)
        return plan if plan["num_processes"] == 1 else None
    p2 = wait_for(post_leave, what="post-leave plan")
    a.stop()
    assert p2["generation"] > p1["generation"]
    assert p2["coordinator_address"] != p1["coordinator_address"]


def test_leave_stops_the_heartbeats(coordinator):
    """A beat answered after the leave found the member gone, and the
    beat loop registered it again, erasing its completion (seen under
    load as a completed `elastic_fit` missing from `completed`)."""
    c = pel.ElasticClient(coordinator.address, "done-w",
                          heartbeat_interval_s=0.01)
    c.register()
    c.start_heartbeats()
    time.sleep(0.05)
    c.leave("complete")
    time.sleep(0.2)                 # twenty beat intervals
    status = coordinator.status()
    assert "done-w" in status["completed"]
    assert "done-w" not in status["members"]


def test_missed_heartbeats_evict(coordinator):
    stay = pel.ElasticClient(coordinator.address, "stay",
                             heartbeat_interval_s=0.05)
    ghost = pel.ElasticClient(coordinator.address, "ghost")
    stay.register()
    ghost.register()
    stay.start_heartbeats()
    wait_for(lambda: (stay.current_plan() or {}).get("num_processes") == 2
             or stay.await_member_plan(timeout_s=1)["num_processes"] == 2,
             what="both members")
    plan = wait_for(lambda: (stay.current_plan()
                             if stay.current_plan()["num_processes"] == 1
                             else None), what="eviction generation")
    assert [m["token"] for m in plan["members"]] == ["stay"]
    stay.stop()


def test_status_carries_heartbeat_info_and_metrics():
    reg = monitor.enable(monitor.MetricsRegistry(), jit_compile=False,
                         device_memory=False)
    co = pel.ElasticCoordinator(settle_s=0.05, grace_s=10.0, tick_s=0.01,
                                min_members=1).start()
    c = pel.ElasticClient(co.address, "w0", heartbeat_interval_s=0.05)
    try:
        reg.counter("steps_total").inc(7)
        c.register(device_count=4)
        c.federate_metrics()
        c.start_heartbeats()
        c.set_info(step=17, phase="fit")

        def carried():
            info = c.status()["members"].get("w0", {}).get("info", {})
            return info if info.get("step") == 17 and "metrics" in info \
                else None
        info = wait_for(carried, what="heartbeat info")
        assert c.status()["members"]["w0"]["device_count"] == 4
        export = info["metrics"]
        assert export["worker"] == "w0"
        assert export["metrics"]["steps_total"]["values"][0]["value"] == 7.0
        c.await_member_plan(timeout_s=10)
        wait_for(lambda: "elastic_live_processes" in reg.snapshot(),
                 what="the coordinator's gauges")
    finally:
        c.stop()
        co.stop()
        monitor.disable()


# ================================================= retry and degradation
def test_unreachable_raises_typed_error_after_attempts():
    t0 = time.monotonic()
    with pytest.raises(fault.ElasticMembershipError, match="unreachable"):
        pel.retry_request(f"127.0.0.1:{_free_port()}", {"op": "status"},
                          timeout=0.2, attempts=3, backoff_s=0.05)
    assert time.monotonic() - t0 >= 0.05 + 0.10


def test_rejected_op_does_not_retry(coordinator):
    with pytest.raises(fault.ElasticMembershipError, match="rejected"):
        pel.retry_request(coordinator.address, {"op": "no-such-op"})


def test_heartbeat_survives_control_plane_outage(coordinator):
    c = pel.ElasticClient(coordinator.address, "w0",
                          heartbeat_interval_s=0.05, io_timeout_s=0.2,
                          backoff_s=0.01)
    c.register()
    c.start_heartbeats()
    c.await_member_plan(timeout_s=10)
    coordinator.stop()
    time.sleep(0.3)
    assert c._thread.is_alive() and c.generation() >= 1
    assert c._unreachable_since is not None
    c.stop()


def test_evicted_client_reregisters(coordinator):
    c = pel.ElasticClient(coordinator.address, "w0",
                          heartbeat_interval_s=0.05)
    c.register()
    c.await_member_plan(timeout_s=10)
    with coordinator._lock:
        coordinator._members.pop("w0", None)
        coordinator._dirty_since = time.monotonic()
    c.start_heartbeats()
    wait_for(lambda: "w0" in coordinator.status()["members"],
             what="re-registration")
    c.stop()


def test_await_member_plan_times_out(coordinator):
    c = pel.ElasticClient(coordinator.address, "late")
    with pytest.raises(fault.ElasticMembershipError, match="no plan"):
        c.await_member_plan(timeout_s=0.2, poll_s=0.05)


# ========================================================== classifier
TORCH_PEER_DEATHS = [
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                 "Connection closed by peer [127.0.0.1]:53387"),
    RuntimeError("[gloo/transport/tcp/pair.cc:537] Read error "
                 "[127.0.0.1]:394: Connection reset by peer"),
    torch.distributed.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp"
                                       ":1970, remote process exited"),
    RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                 "WorkNCCL(SeqNum=5, OpType=ALLREDUCE, NumelIn=1, "
                 "NumelOut=1, Timeout(ms)=20000) ran for 20012 "
                 "milliseconds before timing out."),
    RuntimeError("NCCL communicator was aborted on rank 1."),
    torch.distributed.DistStoreError("wait timeout after 8000ms, keys: "
                                     "/default_pg/0//cpu//0/1"),
    torch.distributed.DistNetworkError("Connection refused"),
    RuntimeError("[c10d] Socket Timeout"),
    OSError("[Errno 32] Broken pipe"),
    RuntimeError("destroy_process_group did not return within 30 s"),
]


@pytest.mark.parametrize("err", TORCH_PEER_DEATHS,
                         ids=[f"death{i}" for i in range(len(
                             TORCH_PEER_DEATHS))])
def test_torch_peer_deaths_are_distributed_failures(err):
    assert pel.distributed_failure(err)


@pytest.mark.parametrize("err", [ValueError("bad batch size"),
                                 RuntimeError("CUDA out of memory"),
                                 RuntimeError("mat1 and mat2 shapes cannot "
                                              "be multiplied")])
def test_ordinary_errors_are_not(err):
    assert not pel.distributed_failure(err)
    assert not jel.distributed_failure(err)


def test_jax_s_markers_and_verdicts_kept():
    assert set(jel._FATAL_MARKERS) <= set(pel._FATAL_MARKERS)
    for e in (RuntimeError("DEADLINE_EXCEEDED: heartbeat timeout"),
              OSError("Connection reset by peer")):
        assert pel.distributed_failure(e) and jel.distributed_failure(e)


# ======================================================= serving view
def test_serving_directory_is_jax_s():
    status = {"generation": 7, "members": {
        "r2": {"host": "h2", "info": {"role": "serving", "model": "lm",
                                      "addr": ["h2", "9002"],
                                      "queue_depth": 4, "ewma_tok_s": 3.5,
                                      "version": 2}},
        "r1": {"host": "h1", "info": {"role": "serving", "model": "cls",
                                      "n_slots": 8}},
        "t0": {"host": "h0", "info": {"step": 3}},
        "r0": {"host": "h9", "info": {"role": "serving", "model": "lm",
                                      "outstanding_tokens": 11,
                                      "open_streams": 1}}}}
    for model in (None, "lm", "cls", "none"):
        assert pel.serving_directory(status, model) == \
            jel.serving_directory(status, model)
    d = pel.serving_directory(status, "lm")
    assert [r["token"] for r in d["replicas"]] == ["r0", "r2"]
    assert d["replicas"][1]["port"] == 9002 and d["generation"] == 7
    assert pel.serving_directory({}) == {"generation": 0, "replicas": []}


def test_register_serving_joins_no_training_rank(coordinator):
    t = pel.ElasticClient(coordinator.address, "t0",
                          heartbeat_interval_s=0.05)
    s = pel.ElasticClient(coordinator.address, "s0",
                          heartbeat_interval_s=0.05)
    t.register()
    t.start_heartbeats()
    s.register_serving(model="lm", host="127.0.0.1", port=9100,
                       info={"n_slots": 8})
    s.start_heartbeats()
    s.set_info(queue_depth=5)
    plan = t.await_member_plan(timeout_s=10)
    wait_for(lambda: len((t.await_member_plan(timeout_s=1)
                          .get("serving_members") or [])) == 1,
             what="serving member")
    assert [m["token"] for m in plan["members"]] == ["t0"]
    d = wait_for(lambda: (lambda dd: dd if dd["replicas"] and dd["replicas"][
        0]["load"].get("queue_depth") == 5 else None)(
            pel.serving_directory(t.status(), "lm")), what="load gauge")
    assert d["replicas"][0]["port"] == 9100
    s.stop()
    t.stop()


# ================================================== exports and errors
def test_names_exported_as_jax():
    from deeplearning4j_tpu_torch import parallel
    for name in ("ElasticConfig", "ElasticCoordinator", "ElasticClient",
                 "ElasticTrainer", "elastic_fit"):
        assert getattr(parallel, name) is getattr(pel, name)
    assert fault.ElasticReconfiguration(4, 9).step == 9
    assert str(fault.ElasticReconfiguration(4, 9)) == str(
        __import__("deeplearning4j_tpu.fault.errors", fromlist=["x"])
        .ElasticReconfiguration(4, 9))
    assert issubclass(fault.ElasticMembershipError, RuntimeError)
    assert pel.RESTART_EXIT_CODE == jel.RESTART_EXIT_CODE
    jc = jel.ElasticConfig("a:1", "t")
    pc = pel.ElasticConfig("a:1", "t")
    assert vars(pc) == vars(jc)


def test_config_maps_onto_initialize_multihost(monkeypatch):
    calls = []
    monkeypatch.setattr(multihost, "initialize_multihost",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(multihost, "multihost_active", lambda: True)
    et = pel.ElasticTrainer(lambda: None, config=pel.ElasticConfig(
        "127.0.0.1:1", "w1", init_timeout_s=7.0, init_attempts=2,
        jax_heartbeat_interval_s=2.0, jax_max_missing_heartbeats=3),
        ckpt_dir="/nonexistent", devices=["cpu"], backend="gloo")
    plan = {"num_processes": 2, "coordinator_address": "h:5", "members": [
        {"token": "w0", "rank": 0}, {"token": "w1", "rank": 1}]}
    et._init_runtime(plan)
    (args, kw), = calls
    assert args == ("h:5", 2, 1)
    assert kw == dict(initialization_timeout=7.0, heartbeat_interval_s=2.0,
                      max_missing_heartbeats=3, max_attempts=2,
                      devices=["cpu"], backend="gloo")
    et._init_runtime(dict(plan, num_processes=1))   # one process: no world
    assert len(calls) == 1
    assert et._local_device_count() == 1


# ===================================== the in-process trainer vs JAX's
def _jax_net():
    from deeplearning4j_tpu.common.updaters import Adam
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater(Adam(0.01)).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf)


def _port_net():
    from deeplearning4j_tpu_torch.parallel.elastic_smoke import dense_net
    return dense_net("cpu")


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((240, 8)).astype(np.float32)
    w = rng.standard_normal((8, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def _jax_side():
    import jax
    from jax.sharding import Mesh

    from deeplearning4j_tpu.datasets.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu.optimize.listeners import TrainingListener
    from deeplearning4j_tpu.parallel.trainer import ParallelTrainer

    class InProcess(jel.ElasticTrainer):
        def _init_runtime(self, plan):
            pass

        def _teardown_runtime(self):
            pass

        def _mesh(self, plan):
            n = 4 if plan["num_processes"] == 1 else 2
            return Mesh(np.array(jax.devices()[:n]), ("data",))

    return types.SimpleNamespace(
        el=jel, net=_jax_net, Iter=ArrayDataSetIterator, L=TrainingListener,
        Trainer=InProcess, ref_mesh=lambda: Mesh(np.array(jax.devices()[:4]),
                                                 ("data",)),
        PT=ParallelTrainer, init=lambda m: m.init(),
        params=lambda m: np.concatenate([np.ravel(np.asarray(v)) for v in
                                         jax.tree_util.tree_leaves(
                                             m.params)]))


def _port_side():
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer

    class InProcess(pel.ElasticTrainer):
        def _init_runtime(self, plan):
            pass

        def _teardown_runtime(self):
            pass

        def _mesh(self, plan):
            n = 4 if plan["num_processes"] == 1 else 2
            return make_mesh(MeshSpec.of(data=n), devices=["cpu"] * n)

    def params(m):
        from deeplearning4j_tpu_torch.util.jax_params import to_jax_params
        tree = to_jax_params(m)
        return np.concatenate([np.ravel(tree[k][n]) for k in sorted(tree)
                               for n in sorted(tree[k])])

    return types.SimpleNamespace(
        el=pel, net=_port_net, Iter=ArrayDataSetIterator, L=TrainingListener,
        Trainer=InProcess, ref_mesh=lambda: make_mesh(
            MeshSpec.of(data=4), devices=["cpu"] * 4),
        PT=ParallelTrainer, init=lambda m: m, params=params)


def _elastic_run(side, gradient_sharing, join_at=8, leave_at=20):
    """The uninterrupted reference and the elastic run (a member joins
    at step `join_at` and leaves at `leave_at`; the listener waits until
    the trainer's client sees each new generation, so the drains land at
    those steps in both packages)."""
    x, y = _data()

    def make_iter():
        return side.Iter(x, y, batch_size=24, shuffle=True, seed=11)

    ref = side.init(side.net())
    ref_losses = {}

    class RefL(side.L):
        def iteration_done(self, model, iteration, epoch, score, **info):
            ref_losses[iteration] = float(score)
    ref.add_listener(RefL())
    side.PT(ref, side.ref_mesh(), mode="sync",
            gradient_sharing=gradient_sharing).fit(make_iter(), epochs=3,
                                                   batch_size=24)
    d = tempfile.mkdtemp(prefix="elastic_inproc_")
    co = side.el.ElasticCoordinator(settle_s=0.05, grace_s=30, tick_s=0.01,
                                    min_members=1).start()
    try:
        cfg = side.el.ElasticConfig(control_address=co.address, token="w0",
                                    heartbeat_interval_s=0.02)
        et = side.Trainer(side.net, config=cfg, ckpt_dir=d,
                          ckpt_frequency=4,
                          gradient_sharing=gradient_sharing)
        fake = side.el.ElasticClient(co.address, "zz-fake",
                                     heartbeat_interval_s=0.02)
        losses = {}

        class Script(side.L):
            def iteration_done(self, model, iteration, epoch, score,
                               **info):
                losses[iteration] = float(score)
                step = iteration + 1
                gen = et.client.generation()
                if step == join_at:
                    fake.register()
                    fake.start_heartbeats()
                elif step == leave_at:
                    fake.stop()
                    fake.leave("shrink")
                else:
                    return
                wait_for(lambda: et.client.generation() != gen,
                         what=f"generation after step {step}")
        model = et.fit(make_iter, epochs=3, batch_size=24,
                       extra_listeners=lambda gen: [Script()])
    finally:
        co.stop()
        shutil.rmtree(d, ignore_errors=True)
    return dict(ref_losses=ref_losses, losses=losses, history=et.history,
                iterations=model.iteration_count,
                params=side.params(model), ref_params=side.params(ref))


@pytest.fixture(scope="module")
def inproc_runs():
    return {gs: (_elastic_run(_jax_side(), gs), _elastic_run(_port_side(),
                                                             gs))
            for gs in (None, "threshold")}


@pytest.mark.parametrize("gradient_sharing", [None, "threshold"],
                         ids=["dense", "threshold"])
def test_in_process_trainer_tracks_jax_s(inproc_runs, gradient_sharing):
    j, p = inproc_runs[gradient_sharing]
    assert p["history"] == j["history"]
    assert [h["n_workers"] for h in p["history"]] == [4, 2, 4]
    assert [h["step"] for h in p["history"]] == [0, 8, 20]
    assert p["iterations"] == j["iterations"] == 30
    init = j["ref_losses"][0]
    for i, jl in j["losses"].items():
        band = (5e-3 * max(1.0, abs(jl)) if gradient_sharing is None
                else 0.25 * init)
        assert abs(p["losses"][i] - jl) <= band, (i, p["losses"][i], jl)
    atol = 2e-3 if gradient_sharing is None else 0.15
    np.testing.assert_allclose(p["params"], j["params"], atol=atol)


@pytest.mark.parametrize("gradient_sharing", [None, "threshold"],
                         ids=["dense", "threshold"])
def test_in_process_trainer_tracks_its_uninterrupted_run(inproc_runs,
                                                         gradient_sharing):
    _, p = inproc_runs[gradient_sharing]
    assert all(h["resumed"] for h in p["history"][1:])
    if gradient_sharing == "threshold":
        assert all(h["residual_restored"] for h in p["history"][1:])
    init = p["ref_losses"][0]
    for i, r in p["ref_losses"].items():
        band = (5e-3 * max(1.0, abs(r)) if gradient_sharing is None
                else 0.25 * init)
        assert abs(p["losses"][i] - r) <= band, (i, p["losses"][i], r)
    atol = 2e-3 if gradient_sharing is None else 0.15
    np.testing.assert_allclose(p["params"], p["ref_params"], atol=atol)


def test_drain_listener_raises_the_typed_signal(coordinator):
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    check = pel.make_drain_check(make_mesh(MeshSpec.of(data=4),
                                           devices=["cpu"] * 4))
    assert check(False) is False and check(True) is True
    assert check.stats["calls"] == 2
    c = pel.ElasticClient(coordinator.address, "w0")
    c.register()
    c.await_member_plan(timeout_s=10)
    run_gen = c.generation()
    lst = pel._DrainListener(c, run_gen, check)
    model = _port_net()
    lst.iteration_done(model, 0, 0, 1.0)
    lst.iteration_done(model, 1, 0, 1.0, step_boundary=False)
    other = pel.ElasticClient(coordinator.address, "w1")
    other.register()

    def bumped():
        c._absorb(c._request({"op": "plan"}))
        return c.generation() != run_gen or None
    wait_for(bumped, what="generation bump")
    with pytest.raises(fault.ElasticReconfiguration) as ei:
        lst.iteration_done(model, 5, 0, 1.0)
    assert ei.value.step == 6 and ei.value.generation > run_gen


# ================================================ the world re-forms
@pytest.fixture
def clean_world():
    yield
    multihost.shutdown_multihost()


def test_failed_rendezvous_leaves_no_stale_group_name(clean_world):
    """A failed rendezvous advanced torch's unnamed-group count, so the
    next world's keys differed from a fresh peer's (both waited out the
    timeout): the count is restarted once no group is left."""
    from torch.distributed import distributed_c10d
    with pytest.raises(RuntimeError, match="attempts failed"):
        multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 2, 0,
                                       devices=["cpu"],
                                       initialization_timeout=1,
                                       max_attempts=1)
    assert not multihost.multihost_active()
    assert distributed_c10d._world.group_count == 0
    # a world of another size comes up in the same process, and again
    for size_devices in (1, 3):
        multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                       devices=["cpu"] * size_devices,
                                       initialization_timeout=30)
        assert torch.distributed.get_world_size() == 1
        assert len(multihost.global_devices()) == size_devices
        multihost.shutdown_multihost()
        assert distributed_c10d._world.group_count == 0


def test_torch_internals_the_world_relies_on():
    """The re-formed world relies on two private parts of torch: the
    unnamed-group count (`_reset_group_names`) and the group timeout's
    setter (`_set_peer_timeout`). An upgrade that drops either fails
    here, not as a slow timeout on the card."""
    from torch.distributed import distributed_c10d
    assert isinstance(distributed_c10d._world.group_count, int)
    assert callable(distributed_c10d._set_pg_timeout)


def test_rendezvous_and_collective_timeouts_split(monkeypatch, clean_world):
    got = {}
    monkeypatch.setattr(multihost, "_set_peer_timeout",
                        lambda t: got.setdefault("peer", t))
    multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                   devices=["cpu"], initialization_timeout=9,
                                   heartbeat_interval_s=5,
                                   max_missing_heartbeats=4)
    assert got["peer"].total_seconds() == 20.0
    multihost.shutdown_multihost()
    monkeypatch.undo()
    # the real setter, on a live gloo group
    multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                   devices=["cpu"], initialization_timeout=9,
                                   heartbeat_interval_s=5,
                                   max_missing_heartbeats=4)
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    assert t.item() == 1.0
    from torch.distributed import distributed_c10d
    backend = distributed_c10d._get_default_group()._get_backend(
        torch.device("cpu"))
    assert backend.options._timeout.total_seconds() == 20.0


def test_teardown_is_bounded(monkeypatch, clean_world):
    multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                   devices=["cpu"], initialization_timeout=30)
    hang = threading.Event()
    real = torch.distributed.destroy_process_group
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda *a: hang.wait(5))
    monkeypatch.setattr(multihost, "TEARDOWN_TIMEOUT_S", 0.2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="wedged") as ei:
        multihost.shutdown_multihost()
    assert time.monotonic() - t0 < 3
    assert pel.distributed_failure(ei.value)
    assert not multihost.multihost_active()
    hang.set()
    monkeypatch.setattr(torch.distributed, "destroy_process_group", real)
    real()


@pytest.fixture(scope="module")
def world_run():
    return mp.spawn_results("elastic_world", 2,
                            second=f"127.0.0.1:{_free_port()}")


def test_device_mesh_spans_the_processes(world_run):
    (rc0, r0, err0), _ = world_run
    assert rc0 == 0, err0[-2000:]
    assert r0["mesh"] == {"data": 4} and r0["spec"] == [4]
    assert r0["mesh_ranks"] == [0, 0, 1, 1]


def test_drain_check_agrees_across_processes(world_run):
    (rc0, r0, err0), _ = world_run
    assert rc0 == 0, err0[-2000:]
    assert r0["drain"] == [True, False, True] and r0["drain_calls"] == 3


def test_peer_sigkill_is_classified_and_the_world_reforms(world_run):
    (rc0, r0, err0), (rc1, r1, _) = world_run
    assert rc1 == -9 and r1 is None
    assert rc0 == 0, err0[-2000:]
    assert r0["error"] is not None and r0["fatal"], r0["error"]
    assert r0["teardown_s"] < multihost.TEARDOWN_TIMEOUT_S
    assert r0["groups_left"] == 0 and not r0["active_after_teardown"]
    assert r0["second_world"] == 1 and r0["second_sum"] == [1.0, 1.0]
    assert r0["second_mesh"] == {"data": 3} and r0["second_drain"] is True


def test_elastic_fit_in_one_process_on_the_cpu(coordinator, tmp_path):
    """`elastic_fit` end to end with its real seams: a one-member plan
    brings up no world, the mesh is this process's CPU device, and the
    run equals a plain one-replica fit."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresListener)
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    x, y = _data()

    def make_iter():
        return ArrayDataSetIterator(x, y, batch_size=24, shuffle=True,
                                    seed=11)
    ref = _port_net()
    scores = CollectScoresListener()
    ref.set_listeners(scores)
    ParallelTrainer(ref, make_mesh(MeshSpec.of(data=1), devices=["cpu"]),
                    gradient_sharing="threshold").fit(make_iter(), epochs=1,
                                                      batch_size=24)
    got = CollectScoresListener()
    model, et = pel.elastic_fit(
        _port_net, make_iter, config=pel.ElasticConfig(
            coordinator.address, "solo", heartbeat_interval_s=0.05),
        ckpt_dir=str(tmp_path), epochs=1, batch_size=24,
        gradient_sharing="threshold", ckpt_frequency=4, devices=["cpu"],
        extra_listeners=lambda gen: [got])
    assert et.history == [{"generation": 1, "n_workers": 1, "resumed": False,
                           "residual_restored": False, "step": 0}]
    assert [s for _, s in got.scores] == [s for _, s in scores.scores]
    assert model.iteration_count == 10 and not multihost.multihost_active()
    assert fault.list_checkpoints(tmp_path) == [4, 8]
    assert "solo" in coordinator.status()["completed"]
