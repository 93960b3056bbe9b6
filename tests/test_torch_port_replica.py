"""The port's replica plane against the JAX package's
(`tests/test_serving_replica.py`: TestServingDirectory, TestReplicaPlane,
TestRouterReplicated, TestQueuedMigration, TestAutoscalerReplicas), and
one spawned replica process killed mid-flood.

Net: the twin LM (head x8, seed 3, max_len 48); greedy streams are held
bit for bit to the reference both packages agree on (JAX `generate()`
equal to the port's), sampled ones bit for bit to the port's own
unmigrated single-server stream of the same key. Every kill, stop and
eviction is gated on an event, not a sleep: a replica's decode steps are
held (`torch_port_fleet.gate_worker`) until it stops, and the stop waits
for the first reply chunk, so every stream is in flight when it dies."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticClient,
    ElasticCoordinator,
    retry_request,
    serving_directory,
)
from deeplearning4j_tpu_torch.serving import (
    FleetAutoscaler,
    FleetRouter,
    FleetServer,
    GenerationServer,
    MigratingStream,
    ModelRegistry,
    ReplicaClient,
    ReplicaLostError,
    ReplicaManager,
    ReplicaSet,
    ReplicaWorker,
    ShedError,
    spawn_replica,
)
from deeplearning4j_tpu_torch.serving import replica as replica_mod
from torch_port_fleet import (
    gate_decode,
    gate_worker,
    greedy_refs,
    twin_lm,
    wait_first_chunk,
    wait_replicas,
)

V, D, HEADS, LAYERS, MAXLEN = 23, 16, 4, 2, 48
N_TOK = 8
LONG = 24
LM_KW = dict(vocab=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
             max_len=MAXLEN)


@pytest.fixture(scope="module")
def twin():
    return twin_lm(3, **LM_KW)


@pytest.fixture(scope="module")
def net(twin):
    return twin[1]


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(5).integers(0, V, (6, 4))


@pytest.fixture(scope="module")
def ref(twin, prompts):
    return greedy_refs(*twin, prompts, N_TOK)


@pytest.fixture(scope="module")
def ref_long(twin, prompts):
    """The flood's reference: every prompt twice, LONG tokens."""
    return greedy_refs(*twin, np.asarray(list(prompts) * 2), LONG)


@pytest.fixture()
def coord():
    c = ElasticCoordinator(settle_s=0.05, grace_s=1.0, tick_s=0.05).start()
    yield c
    c.stop()


def _worker(net, addr, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("n_blocks", 64)
    kw.setdefault("block_len", 4)
    return ReplicaWorker(net, model="m", version=1, coordinator=addr,
                         heartbeat_interval_s=0.05, device="cpu",
                         **kw).start()


def _replicated(coord, net, n=2):
    workers = [_worker(net, coord.address) for _ in range(n)]
    rset = ReplicaSet(coord.address, "m", refresh_s=0.05)
    router = FleetRouter()
    router.attach_replicas("m", rset)
    wait_replicas(rset, n)
    return workers, rset, router


def _sampled_reference(net, prompt, n_tok, rng):
    srv = GenerationServer(net, n_slots=2, n_blocks=32, block_len=4,
                           device="cpu").start()
    try:
        return srv.generate_async(prompt, n_tok, temperature=0.8,
                                  rng=rng).result(60)
    finally:
        srv.stop()


# ================================================= serving directory
class TestServingDirectory:
    def test_serving_members_skip_training_ranks(self, coord, net):
        trainer = ElasticClient(coord.address, "trainer-0",
                                heartbeat_interval_s=0.05)
        trainer.register(device_count=1)
        w = _worker(net, coord.address)
        try:
            deadline = time.monotonic() + 10
            status = {}
            while time.monotonic() < deadline:
                status = trainer.status()
                plan = status.get("plan") or {}
                if plan.get("serving_members") and plan.get("members"):
                    break
                time.sleep(0.05)
            plan = status["plan"]
            assert [m["token"] for m in plan["members"]] == ["trainer-0"]
            assert [m["token"] for m in plan["serving_members"]] \
                == [w.token]
            d = serving_directory(status, "m")
            assert len(d["replicas"]) == 1
            r = d["replicas"][0]
            assert r["port"] == w.port and r["version"] == 1
            assert set(r["load"]) >= {"queue_depth", "outstanding_tokens",
                                      "ewma_tok_s", "open_streams"}
        finally:
            w.stop()
            trainer.stop()

    def test_directory_filters_by_model(self, coord, net):
        w = _worker(net, coord.address)
        try:
            deadline = time.monotonic() + 10
            status = {}
            while time.monotonic() < deadline:
                status = retry_request(coord.address,
                                       {"op": "status"})["status"]
                if serving_directory(status, "m")["replicas"]:
                    break
                time.sleep(0.05)
            assert serving_directory(status, "m")["replicas"]
            assert serving_directory(status, "other")["replicas"] == []
        finally:
            w.stop()


# ==================================================== replica plane
class TestReplicaPlane:
    def test_round_trip_parity_and_version_tag(self, coord, net, prompts,
                                               ref):
        w = _worker(net, coord.address)
        client = ReplicaClient(w.host, w.port)
        try:
            streams = [client.submit("m", p, N_TOK) for p in prompts]
            for s, want in zip(streams, ref):
                np.testing.assert_array_equal(s.result(60), want)
                assert s.version == 1 and s.t_first is not None
        finally:
            client.close()
            w.stop()

    def test_mid_stream_death_is_typed(self, coord, net, prompts):
        w = _worker(net, coord.address)
        gate_worker(w)
        client = ReplicaClient(w.host, w.port)
        try:
            streams = [client.submit("m", p, LONG) for p in prompts[:3]]
            wait_first_chunk(streams)
            w.stop()                      # death with every stream open
            for s in streams:
                with pytest.raises(ReplicaLostError) as ei:
                    s.result(30)
                assert ei.value.request_id == s.request_id
                assert ei.value.last_seq >= -1
                assert ei.value.tokens == s.tokens
                assert len(s.tokens) < LONG
            assert client.closed
        finally:
            client.close()
            w.stop()

    def test_emit_start_continuation_parity(self, net, prompts):
        """A sampled stream cut at k tokens resumes on another server as
        prompt + received with emit_start k, bit-equal to the stream
        that ran through."""
        rng = np.asarray([11, 17], np.uint32)
        full = _sampled_reference(net, prompts[0], 10, rng)
        k = 4
        b = GenerationServer(net, n_slots=2, n_blocks=32, block_len=4,
                             device="cpu").start()
        try:
            cont = b.generate_async(
                np.concatenate([prompts[0], full[:k]]), 10 - k,
                temperature=0.8, rng=rng, emit_start=k).result(60)
        finally:
            b.stop()
        np.testing.assert_array_equal(list(full[:k]) + list(cont), full)

    def test_worker_defaults_to_the_card(self, net):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            ReplicaWorker(net, model="m")

    def test_main_refuses_step_floor(self, tmp_path):
        with pytest.raises(SystemExit) as ei:
            replica_mod.main(["--registry", str(tmp_path), "--model", "m",
                              "--device", "cpu", "--step-floor-ms", "1"])
        assert ei.value.code == 2


# ============================================= router: balance + shed
class TestRouterReplicated:
    def test_least_loaded_balance_and_parity(self, coord, net, prompts,
                                             ref):
        (w1, w2), rset, router = _replicated(coord, net)
        try:
            streams = [router.submit("m", p, N_TOK) for p in prompts]
            for s, want in zip(streams, ref):
                assert isinstance(s, MigratingStream)
                np.testing.assert_array_equal(s.result(60), want)
            assert {s.replica for s in streams} == {w1.token, w2.token}
            assert all(s.version == 1 for s in streams)
        finally:
            rset.close()
            w1.stop()
            w2.stop()

    def test_sheds_only_when_every_replica_is_past_budget(self, coord, net,
                                                          prompts):
        (w1, w2), rset, router = _replicated(coord, net)
        router.max_queue = 0              # every replica reads "full"
        try:
            with pytest.raises(ShedError, match="all 2 live replicas"):
                router.submit("m", prompts[0], N_TOK)
            router.max_queue = 64
            router.submit("m", prompts[0], N_TOK).result(60)
        finally:
            rset.close()
            w1.stop()
            w2.stop()

    def test_kill_drill_zero_dropped_streams(self, coord, net, prompts,
                                             ref_long):
        """Stop one of two replicas mid-flood: every stream finishes
        (migrated, bit-equal), the set converges to the survivor and
        later traffic lands there."""
        (w1, w2), rset, router = _replicated(coord, net)
        gate_worker(w2)
        try:
            flood = [router.submit("m", p, LONG)
                     for p in list(prompts) * 2]
            on_w2 = [s for s in flood if s.replica == w2.token]
            assert on_w2
            wait_first_chunk(on_w2)
            w2.stop()
            for s, want in zip(flood, ref_long):
                np.testing.assert_array_equal(s.result(120), want)
            assert all(s.migrations > 0 for s in on_w2)
            wait_replicas(rset, 1)
            assert [t for t, _, _ in rset.backends()] == [w1.token]
            s = router.submit("m", prompts[0], LONG)
            np.testing.assert_array_equal(s.result(60), ref_long[0])
            assert s.replica == w1.token
        finally:
            rset.close()
            w1.stop()
            w2.stop()

    def test_directory_eviction_migrates_without_deadlock(
            self, coord, net, prompts, ref_long):
        """A replica evicted from the directory while its socket works
        and its streams are in flight: refresh() closes its client, the
        streams migrate on the refreshing thread and re-enter the set's
        refresh()/backends() without wedging it."""
        (w1, w2), rset, router = _replicated(coord, net)
        gate = gate_worker(w2)
        try:
            flood = [router.submit("m", p, LONG)
                     for p in list(prompts) * 2]
            on_w2 = [s for s in flood if s.replica == w2.token]
            wait_first_chunk(on_w2)
            w2._elastic.stop()
            w2._elastic.leave("eviction drill")
            converged = threading.Event()

            def _refresh_until_survivor():
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    rset.refresh(force=True)
                    if [t for t, _, _ in rset.backends()] == [w1.token]:
                        converged.set()
                        return
                    time.sleep(0.05)

            t = threading.Thread(target=_refresh_until_survivor,
                                 daemon=True)
            t.start()
            assert converged.wait(15), \
                "refresh() wedged evicting a replica with live streams"
            gate.set()
            for s, want in zip(flood, ref_long):
                np.testing.assert_array_equal(s.result(120), want)
            assert all(s.migrations > 0 for s in on_w2)
        finally:
            gate.set()
            rset.close()
            w1.stop()
            w2.stop()

    def test_sampled_migration_keeps_fold_chain(self, coord, net,
                                                prompts):
        rng = np.asarray([7, 29], np.uint32)
        want = _sampled_reference(net, prompts[0], LONG, rng)
        (w1, w2), rset, router = _replicated(coord, net)
        gate_worker(w2)
        try:
            streams = [router.submit("m", prompts[0], LONG,
                                     temperature=0.8, rng=rng)
                       for _ in range(4)]
            on_w2 = [s for s in streams if s.replica == w2.token]
            assert on_w2
            wait_first_chunk(on_w2)
            w2.stop()
            for s in streams:
                np.testing.assert_array_equal(s.result(120), want)
            assert all(s.migrations > 0 for s in on_w2)
        finally:
            rset.close()
            w1.stop()
            w2.stop()


# ======================================================== migration
class TestQueuedMigration:
    def test_export_adopt_queued(self, net, prompts, ref):
        """Requests still in the submit queue move between servers
        wholesale: the same stream objects, resolved bit-equal by the
        adopting server."""
        a = GenerationServer(net, n_slots=2, n_blocks=32, block_len=4,
                             device="cpu")
        b = GenerationServer(net, n_slots=4, n_blocks=48, block_len=4,
                             device="cpu")
        gate = gate_decode(a)
        a.start()
        try:
            blocker = a.generate_async(prompts[0], LONG)
            assert gate.blocked.wait(30)     # the scheduler is held
            queued = [a.generate_async(p, N_TOK) for p in prompts[1:4]]
            moved = a.export_queued()
            assert len(moved) == 3
            b.start()
            assert b.adopt_queued(moved) == 3
            for s, want in zip(queued, ref[1:4]):
                np.testing.assert_array_equal(s.result(60), want)
            gate.set()
            blocker.result(60)
            assert a.drain(timeout=60)
            assert a.open_streams == 0 and b.open_streams == 0
        finally:
            gate.set()
            a.stop()
            b.stop()

    def test_swap_migrates_queued_to_successor(self, tmp_path, net,
                                               prompts):
        """In-flight v1 streams finish on v1 (the incumbent is held in
        its decode step until the swap drains it), the queued tail
        decodes entirely on the v2 successor and carries v2's tag."""
        jnet2, net2 = twin_lm(9, **LM_KW)
        reg = ModelRegistry(tmp_path)
        reg.publish("m", net)
        reg.publish("m", net2)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        fleet.deploy("m", version=1, n_slots=2, n_blocks=36, block_len=4)
        srv = fleet.server("m")
        # hold the scheduler at the top of an iteration while the two
        # in-flight requests are queued, so one admission wave takes
        # both; its decode step is then held until the swap drains it
        hold, at_top = threading.Event(), threading.Event()
        hold.set()
        top = srv._drain_control

        def held_top(eng):
            while hold.is_set():
                at_top.set()
                time.sleep(0.001)
            return top(eng)

        srv._drain_control = held_top
        gate = gate_decode(srv, lambda: srv._draining)
        try:
            assert at_top.wait(30)
            inflight = [router.submit("m", p, N_TOK) for p in prompts[:2]]
            hold.clear()
            assert gate.blocked.wait(30)
            assert srv.queue_depth() == 0   # both admitted on v1
            queued = [router.submit("m", p, N_TOK) for p in prompts[2:5]]
            fleet.swap("m", version=2, drain_timeout=120)
            ref1 = greedy_refs(twin_lm(3, **LM_KW)[0], net, prompts[:2],
                               N_TOK)
            ref2 = greedy_refs(jnet2, net2, prompts[2:5], N_TOK)
            for s, want in zip(inflight, ref1):
                np.testing.assert_array_equal(s.result(60), want)
                assert s.version == 1
            for s, want in zip(queued, ref2):
                np.testing.assert_array_equal(s.result(60), want)
                assert s.version == 2
        finally:
            hold.clear()
            gate.set()
            fleet.stop()


# ============================================== autoscaler: replicas
class _FakeReplica:
    def __init__(self):
        self.stopped = False

    def stop(self):
        self.stopped = True


class TestAutoscalerReplicas:
    def _fleet(self, tmp_path, net):
        reg = ModelRegistry(tmp_path)
        reg.publish("m", net)
        fleet = FleetServer(reg, device="cpu")
        fleet.deploy("m", n_slots=2, n_blocks=16, block_len=4,
                     max_queue=64)
        return fleet

    def test_grow_replicas_at_vertical_cap(self, tmp_path, net, prompts):
        fleet = self._fleet(tmp_path, net)
        mgr = ReplicaManager(lambda: _FakeReplica(), min_replicas=1,
                             max_replicas=3)
        mgr.grow()
        scaler = FleetAutoscaler(fleet, queue_depth_high=0, max_slots=2,
                                 max_blocks=16, replicas=mgr)
        srv = fleet.server("m")
        gate = gate_decode(srv)
        try:
            streams = [srv.generate_async(p, N_TOK) for p in prompts]
            assert gate.blocked.wait(30)   # the rest wait in the queue
            made = scaler.check()
            gate.set()
            for s in streams:
                s.result(60)
            grow = [r for r in made if r.get("action") == "grow_replicas"]
            assert grow and mgr.count() == 2
            assert grow[0]["replicas"] == 2
            assert "queue_depth" in grow[0]["reason"]
        finally:
            gate.set()
            mgr.stop()
            fleet.stop()

    def test_shrink_after_idle_passes(self, tmp_path, net):
        fleet = self._fleet(tmp_path, net)
        fakes = []

        def factory():
            fakes.append(_FakeReplica())
            return fakes[-1]

        mgr = ReplicaManager(factory, min_replicas=1, max_replicas=3)
        mgr.grow()
        mgr.grow()
        scaler = FleetAutoscaler(fleet, replicas=mgr, replica_idle_passes=3)
        try:
            made = []
            for _ in range(3):
                made += scaler.check()
            shrink = [r for r in made
                      if r.get("action") == "shrink_replicas"]
            assert shrink and mgr.count() == 1
            assert shrink[0]["replicas"] == 1
            assert fakes[1].stopped and not fakes[0].stopped
        finally:
            mgr.stop()
            fleet.stop()

    def test_manager_bounds(self):
        mgr = ReplicaManager(lambda: _FakeReplica(), min_replicas=1,
                             max_replicas=2)
        assert mgr.grow() and mgr.grow() and not mgr.grow()
        assert mgr.count() == 2
        assert mgr.shrink() and not mgr.shrink()
        assert mgr.count() == 1
        assert mgr.scale_to(5) == 2 and mgr.scale_to(0) == 1
        with pytest.raises(ValueError):
            ReplicaManager(lambda: None, min_replicas=2, max_replicas=1)


# ======================================== a spawned replica, SIGKILLed
def test_spawned_replica_killed_mid_flood(tmp_path, monkeypatch, coord,
                                          net, prompts, ref_long):
    """A `spawn_replica(device="cpu")` process serving the model from a
    registry root beside an in-process replica: SIGKILLed once its first
    reply chunk has arrived, every stream of the flood still finishes
    bit-equal, some by migration, the set converges to the survivor and
    a later request lands there."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reg = ModelRegistry(tmp_path)
    reg.publish("m", net)
    w1 = _worker(net, coord.address)
    proc = spawn_replica(str(tmp_path), "m", coordinator=coord.address,
                         n_slots=4, n_blocks=64, block_len=4,
                         ready_timeout_s=120, device="cpu")
    rset = ReplicaSet(coord.address, "m", refresh_s=0.05)
    router = FleetRouter()
    router.attach_replicas("m", rset)
    try:
        assert proc.alive()
        wait_replicas(rset, 2)
        # four waves' worth: the process holds requests in its queue
        # when it dies, whatever the machine's speed
        flood = [router.submit("m", p, LONG) for p in list(prompts) * 4]
        on_proc = [s for s in flood if s.replica == proc.token]
        assert len(on_proc) > 4
        wait_first_chunk(on_proc)
        proc.kill()
        assert not proc.alive()
        for s, want in zip(flood, list(ref_long) * 2):
            np.testing.assert_array_equal(s.result(120), want)
        assert sum(s.migrations for s in flood) > 0
        wait_replicas(rset, 1)
        assert [t for t, _, _ in rset.backends()] == [w1.token]
        s = router.submit("m", prompts[1], LONG)
        np.testing.assert_array_equal(s.result(60), ref_long[1])
        assert s.replica == w1.token
    finally:
        rset.close()
        proc.stop()
        w1.stop()
