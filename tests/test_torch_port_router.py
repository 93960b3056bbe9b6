"""The port's FleetRouter, FleetClient and the transport request plane
against the JAX package's (`tests/test_serving_fleet.py`:
TestFleetRouter, TestRequestPlane, TestWireTracePropagation).

The admission policy is held to the JAX router's decision for decision:
both routers front one scripted fake fleet whose servers' throughput
EWMA, outstanding and queued tokens and queue depths are injected alike
before each submit, with the clock patched in both router modules, and
must admit and shed the same requests for the same reasons, and count
them alike in their `fleet_*` and `fleet_tenant_*` families. The rest
runs the port's router over a real FleetServer of the twin LM (head x8,
seed 3), held bit for bit to the greedy reference both packages agree
on."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import time

import numpy as np
import pytest

import deeplearning4j_tpu_torch.serving.router as port_router
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import MetricsRegistry, Tracer
from deeplearning4j_tpu_torch.monitor.reqtrace import _tid_for
from deeplearning4j_tpu_torch.serving import (
    FleetClient,
    FleetRouter,
    FleetServer,
    ModelRegistry,
    ShedError,
    UnknownModelError,
    wire,
)
from deeplearning4j_tpu_torch.streaming import LocalQueueTransport
from torch_port_fleet import greedy_refs, twin_lm

V, D, HEADS, LAYERS, MAXLEN = 23, 16, 4, 2, 16
BL = 4
N_TOK = 6


@pytest.fixture(scope="module")
def twin():
    return twin_lm(3, vocab=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                   max_len=MAXLEN)


@pytest.fixture(scope="module")
def net(twin):
    return twin[1]


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(5).integers(0, V, (8, 3))


@pytest.fixture(scope="module")
def ref(twin, prompts):
    return greedy_refs(*twin, prompts, N_TOK)


def _fleet(tmp_path, net, *names):
    reg = ModelRegistry(tmp_path)
    for n in names or ("lm",):
        reg.publish(n, net)
    return FleetServer(reg, device="cpu")


# ====================================== the admission policy against JAX
class _Clock:
    """The router module's `time`: a scripted monotonic clock; `sleep`
    advances it and runs the fake fleet's hook (a swap's pointer flip
    during a submit's drain retry)."""

    def __init__(self):
        self.t = 1000.0
        self.on_sleep = None

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += dt
        if self.on_sleep is not None:
            self.on_sleep()

    perf_counter = staticmethod(time.perf_counter)


class _Stream:
    pass


class _FakeServer:
    def __init__(self, draining_error):
        self._draining_error = draining_error
        self.draining = False
        self._ewma_tok_s = None
        self.outstanding = 0
        self.queued_tokens = 0
        self.depth = 0

    def queue_depth(self):
        return self.depth

    def _outstanding_tokens(self):
        return self.outstanding

    def generate_async(self, prompt, n_tokens, **kw):
        if self.draining:
            raise self._draining_error("draining")
        self.depth += 1
        self.queued_tokens += int(n_tokens)
        return _Stream()


class _FakeFleet:
    def __init__(self, names, draining_error):
        self.err = draining_error
        self.live = {n: (_FakeServer(draining_error), 1) for n in names}

    def has(self, name):
        return name in self.live

    def names(self):
        return sorted(self.live)

    def active(self, name):
        return self.live[name]

    def flip(self, name):
        """A swap's pointer flip: the incumbent drains, a fresh
        successor at the next version takes its load."""
        old, v = self.live[name]
        new = _FakeServer(self.err)
        for k in ("_ewma_tok_s", "outstanding", "queued_tokens", "depth"):
            setattr(new, k, getattr(old, k))
        self.live[name] = (new, v + 1)


NAMES = ("hi", "lo", "t1", "t2")


def _script():
    """(name, n_tokens, clock step, {name: (ewma, outstanding, depth)}
    injected before the submit, or "swap" to start a drain)."""
    rng = np.random.default_rng(20)
    steps = []
    for i in range(120):
        name = NAMES[int(rng.integers(0, 4))]
        load = {n: (float(rng.choice([0.0, 50.0, 200.0, 1000.0])),
                    int(rng.integers(0, 400)), int(rng.integers(0, 7)))
                for n in NAMES}
        event = "swap" if i in (30, 77) else None
        steps.append((name, int(rng.integers(1, 64)),
                      float(rng.choice([0.0, 0.3, 2.5])), load, event))
    return steps


def _run_script(router_mod, draining_error, shed_error, mon, registry_cls):
    clock = _Clock()
    fleet = _FakeFleet(NAMES, draining_error)
    reg = registry_cls()
    mon.enable(registry=reg)
    saved = router_mod.time
    router_mod.time = clock
    try:
        router = router_mod.FleetRouter(
            fleet, slo_ttft_s=0.5, max_queue=5,
            weights={"hi": 4.0, "lo": 0.25}, share_window_s=10.0)
        router.set_share_floor("t2", 0.3)
        router.set_share_floor("t1", 0.1)
        out = []
        for name, n, dt, load, event in _script():
            clock.t += dt
            for m, (ewma, outstanding, depth) in load.items():
                srv = fleet.live[m][0]
                srv._ewma_tok_s = ewma or None
                srv.outstanding, srv.depth = outstanding, depth
            if event == "swap":
                fleet.live[name][0].draining = True
                clock.on_sleep = lambda nm=name: fleet.flip(nm)
            try:
                s = router.submit(name, [1, 2, 3], n)
                out.append(("admit", name, s.model, s.version))
            except shed_error as e:
                out.append(("shed", name, str(e)))
            clock.on_sleep = None
        shares = {n: router.admitted_share(n) for n in NAMES}
        snap = reg.snapshot()
    finally:
        router_mod.time = saved
        mon.disable()
    fams = {k: sorted((tuple(sorted(e["labels"].items())), e["value"])
                      for e in v["values"])
            for k, v in snap.items() if k.startswith("fleet_")}
    return out, shares, fams


def test_admit_shed_sequence_equals_jax():
    """One scripted load through both routers: the same admissions (and
    version tags, across two drain-retried swaps) and the same sheds
    with the same reasons, weighted budgets, max_queue backstops, share
    floors and overshare tightening included; the same windowed shares
    and the same fleet_* families after it."""
    import deeplearning4j_tpu.serving.router as jax_router
    from deeplearning4j_tpu import monitor as jmon
    from deeplearning4j_tpu.monitor.registry import (
        MetricsRegistry as JaxRegistry)
    from deeplearning4j_tpu.serving.server import (
        ServerDrainingError as JaxDraining, ShedError as JaxShed)
    from deeplearning4j_tpu_torch.serving.server import ServerDrainingError
    want = _run_script(jax_router, JaxDraining, JaxShed, jmon, JaxRegistry)
    got = _run_script(port_router, ServerDrainingError, ShedError, monitor,
                      MetricsRegistry)
    assert got == want
    out = got[0]
    kinds = {o[0] for o in out}
    assert kinds == {"admit", "shed"}
    reasons = " ".join(o[2] for o in out if o[0] == "shed")
    assert "weighted" in reasons and "max_queue" in reasons
    assert {o[3] for o in out if o[0] == "admit"} == {1, 2, 3}
    assert got[2]["fleet_tenant_floor_admits_total"]


# ============================================================ the router
class TestFleetRouter:
    def test_unknown_model_names_known(self, tmp_path, net):
        fleet = _fleet(tmp_path, net)
        router = FleetRouter(fleet)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            with pytest.raises(UnknownModelError, match="lm"):
                router.submit("ghost", np.zeros(3, np.int32), 4)
        finally:
            fleet.stop()

    def test_weighted_shedding(self, tmp_path, net, prompts):
        fleet = _fleet(tmp_path, net, "hi", "lo")
        router = FleetRouter(fleet, slo_ttft_s=0.05,
                             weights={"hi": 1e6, "lo": 1e-9})
        try:
            fleet.deploy("hi", n_slots=1, n_blocks=8, block_len=BL)
            fleet.deploy("lo", n_slots=1, n_blocks=8, block_len=BL)
            for n in ("hi", "lo"):
                router.submit(n, prompts[0], N_TOK).result(timeout=120)

            def flood(name, k=6):
                streams, sheds = [], 0
                for i in range(k):
                    try:
                        streams.append(
                            router.submit(name, prompts[i % 8], 12))
                    except ShedError as e:
                        assert "weighted" in str(e)
                        sheds += 1
                return streams, sheds

            hi_streams, hi_sheds = flood("hi")
            lo_streams, lo_sheds = flood("lo")
            assert hi_sheds == 0 and len(hi_streams) == 6
            assert lo_sheds >= 1
            for s in hi_streams + lo_streams:
                s.result(timeout=120)
        finally:
            fleet.stop()

    def test_max_queue_backstop(self, tmp_path, net, prompts):
        fleet = _fleet(tmp_path, net)
        router = FleetRouter(fleet, max_queue=1)
        try:
            fleet.deploy("lm", n_slots=4, n_blocks=4, block_len=BL)
            streams = [router.submit("lm", prompts[0], N_TOK)]
            shed = 0
            for _ in range(8):
                try:
                    streams.append(router.submit("lm", prompts[0], N_TOK))
                except ShedError:
                    shed += 1
            for s in streams:
                s.result(timeout=120)
        finally:
            fleet.stop()
        assert shed >= 1

    def test_share_floor_validation(self):
        router = FleetRouter()
        router.set_share_floor("a", 0.5)
        with pytest.raises(ValueError, match="sum below"):
            router.set_share_floor("b", 0.5)
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            router.set_share_floor("c", 1.0)
        with pytest.raises(ValueError, match="weight"):
            router.set_weight("a", 0)


# ======================================================== request plane
class TestRequestPlane:
    def test_remote_client_end_to_end(self, tmp_path, net, prompts, ref):
        fleet = _fleet(tmp_path, net)
        tr = LocalQueueTransport()
        router = FleetRouter(fleet, transport=tr)
        try:
            fleet.deploy("lm", n_slots=2, n_blocks=16, block_len=BL)
            router.serve()
            client = FleetClient(tr)
            remote = [client.generate("lm", prompts[i], N_TOK)
                      for i in range(4)]
            got = np.stack([r.result(timeout=120) for r in remote])
            np.testing.assert_array_equal(got, ref[:4])
            assert {r.version for r in remote} == {1}
            assert {r.model for r in remote} == {"lm"}
            it = list(client.generate("lm", prompts[0], N_TOK))
            assert it == list(ref[0])
            bad = client.generate("ghost", prompts[0], 4)
            with pytest.raises(RuntimeError, match="ghost"):
                bad.result(timeout=60)
        finally:
            router.stop()
            fleet.stop()

    def test_remote_shed_crosses_wire_as_shed(self, tmp_path, net,
                                              prompts):
        fleet = _fleet(tmp_path, net)
        tr = LocalQueueTransport()
        router = FleetRouter(fleet, transport=tr, max_queue=0)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            router.serve()
            remote = FleetClient(tr).generate("lm", prompts[0], N_TOK)
            with pytest.raises(ShedError):
                remote.result(timeout=60)
        finally:
            router.stop()
            fleet.stop()

    def test_remote_result_deadline(self):
        tr = LocalQueueTransport()
        remote = FleetClient(tr).generate("lm", [1, 2], 3, timeout=0.05)
        with pytest.raises(TimeoutError):
            remote.result(timeout=0.1)


# ==================================================== wire trace context
class TestWireTracePropagation:
    @pytest.fixture
    def mon(self):
        reg, tr = MetricsRegistry(), Tracer()
        monitor.enable(registry=reg, tracer=tr)
        yield reg, tr
        monitor.disable()
        monitor._STATE.registry = monitor.GLOBAL_REGISTRY
        monitor._STATE.tracer = monitor.GLOBAL_TRACER

    @staticmethod
    def _req_events(tracer, trace_id):
        return [e for e in tracer.events()
                if str(e.get("name", "")).startswith("req/")
                and e.get("args", {}).get("trace_id") == trace_id]

    def test_remote_stream_stitches_one_timeline(self, mon, tmp_path, net,
                                                 prompts, ref):
        _, tracer = mon
        fleet = _fleet(tmp_path, net)
        tr = LocalQueueTransport()
        router = FleetRouter(fleet, transport=tr)
        try:
            fleet.deploy("lm", n_slots=2, n_blocks=16, block_len=BL)
            router.serve()
            remote = FleetClient(tr).generate("lm", prompts[0], N_TOK)
            np.testing.assert_array_equal(remote.result(timeout=120),
                                          ref[0])
            tid = remote.trace_id
            assert tid is not None
            assert remote.trace is not None and remote.trace.finished
            # the server's half flushes when the scheduler finishes the
            # stream, just after the done reply: wait for it by deadline
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                evs = self._req_events(tracer, tid)
                if sum(e["name"] == "req/lifetime" for e in evs) >= 2:
                    break
                time.sleep(0.02)
            evs = self._req_events(tracer, tid)
            names = {e["name"] for e in evs}
            assert {"req/wire_submit", "req/remote_stream", "req/queued",
                    "req/prefill", "req/decode", "req/lifetime"} <= names
            assert sum(e["name"] == "req/lifetime" for e in evs) == 2
            assert {e["tid"] for e in evs} == {_tid_for(tid)}
            local = fleet.server("lm").generate_async(prompts[1], N_TOK)
            local.result(timeout=120)
            local_names = [p["name"] for p in local.trace.phases]
            remote_side = [e for e in evs
                           if e["name"] in ("req/queued", "req/prefill",
                                            "req/decode")]
            assert [e["name"].removeprefix("req/")
                    for e in remote_side[:2]] == local_names[:2] \
                == ["queued", "prefill"]
        finally:
            router.stop()
            fleet.stop()

    def test_remote_shed_trace_annotated(self, mon, tmp_path, net,
                                         prompts):
        _, tracer = mon
        fleet = _fleet(tmp_path, net)
        tr = LocalQueueTransport()
        router = FleetRouter(fleet, transport=tr, max_queue=0)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            router.serve()
            remote = FleetClient(tr).generate("lm", prompts[0], N_TOK)
            with pytest.raises(ShedError):
                remote.result(timeout=60)
            assert remote.trace is not None
            assert remote.trace.status == "shed"
            deadline = time.monotonic() + 10
            evs = []
            while time.monotonic() < deadline:
                evs = self._req_events(tracer, remote.trace_id)
                if any(e["name"] == "req/shed" for e in evs):
                    break
                time.sleep(0.02)
            shed = [e for e in evs if e["name"] == "req/shed"]
            assert shed and shed[0]["args"]["reason"]
            assert shed[0]["args"].get("router") is True
        finally:
            router.stop()
            fleet.stop()

    def test_wire_header_carries_trace_id(self):
        data = wire.encode_request("lm", "rid1", np.arange(3), 4,
                                   trace_id="abcd1234abcd1234")
        header, _ = wire.decode_request(data)
        assert header["trace_id"] == "abcd1234abcd1234"
        header, _ = wire.decode_request(
            wire.encode_request("lm", "rid1", np.arange(3), 4))
        assert "trace_id" not in header
