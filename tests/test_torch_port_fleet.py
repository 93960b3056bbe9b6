"""The port's FleetServer and FleetAutoscaler against the JAX package's
(`tests/test_serving_fleet.py`: TestDrainAndLifecycle, TestHotSwap,
TestAutoscaler, TestQueueDepthSeam, TestRulesDrivenAutoscaler).

Nets: twin LMs (`torch_port_fleet.twin_lm`, head x8, seeds 3 and 9 for
v1 and v2); every stream is held bit for bit to the greedy reference
both packages agree on (JAX `generate()` equal to the port's), by the
version tag it carries. The autoscaler's decisions are held to the JAX
`FleetAutoscaler`'s field for field: both run over one scripted fake
fleet, with the same gauge snapshots in each package's MetricsRegistry,
the same alert rules in each package's AlertEngine, the same goodput
families and the same fake replica manager."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor.alerts import AlertEngine, AlertRule
from deeplearning4j_tpu_torch.monitor.flightrec import FlightRecorder
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.serving import (
    FleetAutoscaler,
    FleetRouter,
    FleetServer,
    GenerationServer,
    ModelRegistry,
    ServerDrainingError,
    ServerStoppedError,
)
from torch_port_fleet import greedy_refs, twin_lm

V, D, HEADS, LAYERS, MAXLEN = 23, 16, 4, 2, 16
BL = 4
N_TOK = 6
LM_KW = dict(vocab=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
             max_len=MAXLEN)


@pytest.fixture(scope="module")
def twins():
    return twin_lm(3, **LM_KW), twin_lm(9, **LM_KW)


@pytest.fixture(scope="module")
def net_v1(twins):
    return twins[0][1]


@pytest.fixture(scope="module")
def net_v2(twins):
    return twins[1][1]


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(5).integers(0, V, (8, 3))


@pytest.fixture(scope="module")
def refs(twins, prompts):
    """{version: [8, N_TOK] greedy streams}."""
    return {v: greedy_refs(jnet, net, prompts, N_TOK)
            for v, (jnet, net) in zip((1, 2), twins)}


def _registry(tmp_path, *nets, name="lm", **kw):
    reg = ModelRegistry(tmp_path, **kw)
    for n in nets:
        reg.publish(name, n)
    return reg


def _server(net, **kw):
    kw.setdefault("n_slots", 1)
    kw.setdefault("n_blocks", 8)
    return GenerationServer(net, block_len=BL, device="cpu", **kw)


# ====================================================== drain lifecycle
class TestDrainAndLifecycle:
    def test_drain_finishes_inflight_blocks_admissions(self, net_v1,
                                                       prompts, refs):
        srv = _server(net_v1, n_slots=2, n_blocks=16).start()
        try:
            streams = [srv.generate_async(prompts[i], N_TOK)
                       for i in range(4)]
            assert srv.drain(timeout=120) is True
            got = np.stack([s.result(timeout=0) for s in streams])
            np.testing.assert_array_equal(got, refs[1][:4])
            assert srv.open_streams == 0
            with pytest.raises(ServerDrainingError):
                srv.generate_async(prompts[0], N_TOK)
        finally:
            srv.stop()

    def test_drain_idle_server_immediate(self, net_v1):
        srv = _server(net_v1).start()
        try:
            assert srv.drain(timeout=5) is True
        finally:
            srv.stop()

    def test_stop_idempotent(self, net_v1, prompts):
        srv = _server(net_v1).start()
        s = srv.generate_async(prompts[0], N_TOK)
        srv.stop()
        srv.stop()
        with pytest.raises(RuntimeError):
            s.result(timeout=10)

    def test_start_after_stop_raises_named_error(self, net_v1):
        srv = _server(net_v1).start()
        srv.stop()
        with pytest.raises(ServerStoppedError, match="fresh server"):
            srv.start()
        assert srv._thread is None and not srv._running


# ============================================================= hot-swap
class TestHotSwap:
    def test_swap_zero_drop_version_parity(self, tmp_path, net_v1,
                                           net_v2, prompts, refs):
        """Streams admitted on v1 finish on v1's weights, queued ones
        the swap moved finish on v2's and carry v2's tag, post-swap
        admissions are v2's; none drops."""
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        try:
            assert fleet.deploy("lm", n_slots=2, n_blocks=16,
                                block_len=BL) == 1
            pre = [router.submit("lm", prompts[i], N_TOK)
                   for i in range(6)]
            reg.publish("lm", net_v2)
            assert fleet.swap("lm") == 2
            post = [router.submit("lm", prompts[i], N_TOK)
                    for i in range(6)]
            assert {s.version for s in post} == {2}
            got_pre = [s.result(timeout=120) for s in pre]
            got_post = [s.result(timeout=120) for s in post]
        finally:
            fleet.stop()
        assert {s.version for s in pre} <= {1, 2}
        for i, (s, g) in enumerate(zip(pre, got_pre)):
            np.testing.assert_array_equal(g, refs[s.version][i])
        np.testing.assert_array_equal(np.stack(got_post), refs[2][:6])

    def test_successors_warm_over_the_deployed_length_range(
            self, tmp_path, net_v1, net_v2, prompts, refs, monkeypatch):
        """`warmup_prompt_len=(shortest, longest)` warms the deployment
        and the successor each swap() and scale() builds, before its
        flip, over the buckets from the shortest's to the longest's
        only (prompts 3-6: buckets 4 and 8 at widths 1 and 2, greedy
        and sampled)."""
        warmed = {}
        real = GenerationServer.warmup

        def spy(self, prompt_len, n_tokens=2):
            eng, waves = self.engine, warmed.setdefault(id(self), [])
            admit = eng.admit_many

            def record(reqs):
                waves.append((len(reqs), len(reqs[0]["prompt_ids"])))
                return admit(reqs)

            eng.admit_many = record
            try:
                return real(self, prompt_len, n_tokens)
            finally:
                del eng.admit_many

        monkeypatch.setattr(GenerationServer, "warmup", spy)
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        try:
            fleet.deploy("lm", n_slots=2, n_blocks=16, block_len=BL,
                         warmup_prompt_len=(3, 6))
            first = id(fleet.server("lm"))
            reg.publish("lm", net_v2)
            fleet.swap("lm")
            swapped = id(fleet.server("lm"))
            fleet.scale("lm", n_slots=4, n_blocks=32)
            scaled = id(fleet.server("lm"))
            got = router.submit("lm", prompts[0], N_TOK).result(timeout=120)
        finally:
            fleet.stop()
        assert list(warmed) == [first, swapped, scaled]
        grid = sorted((w, b) for w in (1, 2) for b in (4, 8)
                      for _ in range(2))
        assert sorted(warmed[first]) == grid
        assert sorted(warmed[swapped]) == grid
        assert sorted(warmed[scaled]) == sorted(
            (w, b) for w in (1, 2, 4) for b in (4, 8) for _ in range(2))
        np.testing.assert_array_equal(got, refs[2][0])

    def test_swap_pins_served_and_unpins_old(self, tmp_path, net_v1,
                                             net_v2):
        reg = _registry(tmp_path, net_v1, keep_last=1)
        fleet = FleetServer(reg, device="cpu")
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            assert ("lm", 1) in reg.pinned()
            reg.publish("lm", net_v2)
            assert 1 in reg.versions("lm")
            fleet.swap("lm")
            assert ("lm", 2) in reg.pinned()
            assert ("lm", 1) not in reg.pinned()
            assert reg.versions("lm") == [2]
        finally:
            fleet.stop()
        assert reg.pinned() == set()

    def test_scale_resize_keeps_parity(self, tmp_path, net_v1, prompts,
                                       refs):
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            pre = [router.submit("lm", prompts[i], N_TOK)
                   for i in range(3)]
            rec = fleet.scale("lm", n_slots=4, n_blocks=16)
            assert rec["before"] == {"n_slots": 1, "n_blocks": 8}
            assert rec["after"] == {"n_slots": 4, "n_blocks": 16}
            assert fleet.server("lm").engine.n_slots == 4
            assert fleet.version("lm") == 1
            post = [router.submit("lm", prompts[3 + i], N_TOK)
                    for i in range(3)]
            got = np.stack([s.result(timeout=120) for s in pre + post])
        finally:
            fleet.stop()
        np.testing.assert_array_equal(got, refs[1][:6])

    def test_deploy_duplicate_and_swap_unknown(self, tmp_path, net_v1):
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            with pytest.raises(ValueError, match="already deployed"):
                fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            with pytest.raises(KeyError, match="ghost"):
                fleet.swap("ghost")
            with pytest.raises(KeyError, match="ghost"):
                fleet.scale("ghost", n_slots=2)
            with pytest.raises(ValueError, match="n_slots"):
                fleet.scale("lm")
        finally:
            fleet.stop()

    def test_prefix_reregistered_on_successor(self, tmp_path, net_v1,
                                              net_v2, prompts, refs):
        """A prefix registered for the name is prefilled again into the
        successor's pool under v2's weights; a prompt that extends it
        decodes as v2's reference does."""
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        prefix = prompts[0][:2]
        try:
            fleet.deploy("lm", n_slots=2, n_blocks=16, block_len=BL)
            fleet.register_prefix("lm", prefix)
            assert fleet.server("lm").engine.has_prefixes
            reg.publish("lm", net_v2)
            fleet.swap("lm")
            succ = fleet.server("lm").engine
            assert succ.has_prefixes
            assert [tuple(e["tokens"]) for e in succ._prefixes.values()] \
                == [tuple(int(t) for t in prefix)]
            s = router.submit("lm", prompts[0], N_TOK)
            np.testing.assert_array_equal(s.result(timeout=120),
                                          refs[2][0])
            assert succ.prefix_hits_total >= 1
        finally:
            fleet.stop()

    def test_undeploy_releases_and_zeroes_gauges(self, tmp_path, net_v1):
        mreg = monitor.enable(registry=MetricsRegistry())
        try:
            reg = _registry(tmp_path, net_v1)
            reg.publish("other", net_v1)
            fleet = FleetServer(reg, device="cpu")
            try:
                fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
                fleet.deploy("other", n_slots=2, n_blocks=8, block_len=BL)
                fleet.publish_gauges()
                snap = mreg.snapshot()
                slots = {e["labels"]["model"]: e["value"] for e in
                         snap["fleet_slot_count"]["values"]}
                assert slots == {"lm": 1, "other": 2}
                fleet.undeploy("other")
                assert ("other", 1) not in reg.pinned()
                snap = mreg.snapshot()
            finally:
                fleet.stop()
        finally:
            monitor.disable()
        ver = {e["labels"]["model"]: e["value"] for e in
               snap["fleet_model_version"]["values"]}
        assert ver == {"lm": 1, "other": 0}
        assert snap["fleet_active_models"]["values"][0]["value"] == 1

    def test_fleet_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("checks the refusal on a machine without CUDA")
        with pytest.raises(RuntimeError, match="CUDA"):
            FleetServer(ModelRegistry(tmp_path))


# =========================================================== autoscaler
class TestAutoscaler:
    def test_scales_up_on_queue_pressure_zero_drop(self, tmp_path,
                                                   net_v1, prompts, refs):
        monitor.enable(registry=MetricsRegistry())
        reg = _registry(tmp_path, net_v1)
        fleet = FleetServer(reg, device="cpu")
        router = FleetRouter(fleet)
        scaler = FleetAutoscaler(fleet, queue_depth_high=2, factor=4,
                                 max_slots=4, max_blocks=32)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            streams = [router.submit("lm", prompts[i % 8], N_TOK)
                       for i in range(8)]
            fleet.publish_gauges()
            made = scaler.check()
            assert len(made) == 1
            assert made[0]["after"]["n_slots"] == 4
            assert "queue_depth" in made[0]["reason"]
            assert fleet.server("lm").engine.n_slots == 4
            got = np.stack([s.result(timeout=120) for s in streams])
            np.testing.assert_array_equal(
                got, np.stack([refs[1][i % 8] for i in range(8)]))
            fleet.publish_gauges()
            assert scaler.check() == []
        finally:
            fleet.stop()
            monitor.disable()

    def test_idle_fleet_never_scales(self, tmp_path, net_v1):
        fleet = FleetServer(_registry(tmp_path, net_v1), device="cpu")
        scaler = FleetAutoscaler(fleet, queue_depth_high=2)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            assert scaler.check() == []
            assert fleet.server("lm").engine.n_slots == 1
        finally:
            fleet.stop()


class TestQueueDepthSeam:
    def test_public_queue_depth_counts_pending_work(self, net_v1,
                                                    prompts):
        srv = _server(net_v1).start()
        try:
            streams = [srv.generate_async(prompts[i], 10)
                       for i in range(6)]
            assert srv.queue_depth() >= 4
            for s in streams:
                s.result(timeout=120)
        finally:
            srv.stop()
        assert srv.queue_depth() == 0

    def test_live_autoscaler_path_monitoring_off(self, tmp_path, net_v1,
                                                 prompts, refs):
        assert not monitor.is_enabled()
        fleet = FleetServer(_registry(tmp_path, net_v1), device="cpu")
        router = FleetRouter(fleet)
        scaler = FleetAutoscaler(fleet, queue_depth_high=2, factor=4,
                                 max_slots=4, max_blocks=32)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            streams = [router.submit("lm", prompts[i % 8], N_TOK)
                       for i in range(8)]
            made = scaler.check()
            assert len(made) == 1
            assert "queue_depth" in made[0]["reason"]
            assert fleet.server("lm").engine.n_slots == 4
            got = np.stack([s.result(timeout=120) for s in streams])
            np.testing.assert_array_equal(
                got, np.stack([refs[1][i % 8] for i in range(8)]))
        finally:
            fleet.stop()


class TestRulesDrivenAutoscaler:
    def test_firing_alert_is_pressure_for_its_model(self, tmp_path,
                                                    net_v1):
        mreg = monitor.enable(registry=MetricsRegistry())
        fleet = FleetServer(_registry(tmp_path, net_v1), device="cpu")
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            fleet.publish_gauges()
            rules = AlertEngine(
                mreg,
                [AlertRule(name="lm-hot", kind="threshold",
                           metric="fleet_model_version",
                           labels={"model": "lm"}, op=">=", value=1.0,
                           severity="page")],
                recorder=FlightRecorder(), registry=MetricsRegistry())
            scaler = FleetAutoscaler(fleet, rules=rules, factor=2,
                                     max_slots=2, max_blocks=16)
            made = scaler.check()
            assert len(made) == 1
            assert "alert lm-hot firing" in made[0]["reason"]
            assert fleet.server("lm").engine.n_slots == 2
            fleet.publish_gauges()
            assert scaler.check() == []
        finally:
            fleet.stop()
            monitor.disable()

    def test_quiet_rules_never_scale(self, tmp_path, net_v1):
        fleet = FleetServer(_registry(tmp_path, net_v1), device="cpu")
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL)
            rules = AlertEngine(lambda: {}, [], recorder=FlightRecorder())
            scaler = FleetAutoscaler(fleet, rules=rules,
                                     queue_depth_high=0)
            assert scaler.check() == []
            assert fleet.server("lm").engine.n_slots == 1
        finally:
            fleet.stop()

    def test_goodput_floor_reads_live_ledger(self, tmp_path, net_v1,
                                             prompts):
        assert not monitor.is_enabled()
        fleet = FleetServer(_registry(tmp_path, net_v1), device="cpu")
        router = FleetRouter(fleet)
        quiet = AlertEngine(lambda: {}, [], recorder=FlightRecorder())
        scaler = FleetAutoscaler(fleet, rules=quiet, goodput_low=0.99,
                                 factor=2, max_slots=2, max_blocks=16)
        try:
            fleet.deploy("lm", n_slots=1, n_blocks=8, block_len=BL,
                         warmup_prompt_len=3)
            assert scaler.check() == []
            router.submit("lm", prompts[0], N_TOK).result(timeout=120)
            srv = fleet.server("lm")
            assert 0.0 < srv.engine.goodput.goodput_fraction() < 0.99
            made = scaler.check()
            assert len(made) == 1
            assert "goodput fraction" in made[0]["reason"]
            assert fleet.server("lm").engine.n_slots == 2
        finally:
            fleet.stop()


# ============================ decision records: the port against JAX
class _Pool:
    def __init__(self, n_blocks, used):
        self.n_blocks, self.used_blocks = n_blocks, used

    @property
    def free_blocks(self):
        return self.n_blocks - self.used_blocks


class _Ledger:
    def __init__(self):
        self.dispatched_total, self.classes = 0, {"warmup": 0}
        self.fraction = 0.0

    def goodput_fraction(self):
        return self.fraction


class _Engine:
    def __init__(self, n_slots, n_blocks):
        self.n_slots = n_slots
        self.pool = _Pool(n_blocks, 0)
        self.goodput = _Ledger()


class _Server:
    def __init__(self, n_slots, n_blocks):
        self.engine = _Engine(n_slots, n_blocks)
        self.depth = 0

    def queue_depth(self):
        return self.depth


class _Fleet:
    """The autoscaler's view of a FleetServer (names, server, scale),
    scripted: scale() records the resize as FleetServer.scale does."""

    def __init__(self, models):
        self.servers = {n: _Server(*c) for n, c in models.items()}

    def names(self):
        return sorted(self.servers)

    def server(self, name):
        return self.servers[name]

    def scale(self, name, *, n_slots=None, n_blocks=None,
              drain_timeout=600.0):
        e = self.servers[name].engine
        before = {"n_slots": e.n_slots, "n_blocks": e.pool.n_blocks}
        e.n_slots, e.pool.n_blocks = n_slots, n_blocks
        return {"name": name, "version": 1, "before": before,
                "after": {"n_slots": n_slots, "n_blocks": n_blocks}}


class _Replicas:
    def __init__(self, n, lo, hi):
        self.n, self.lo, self.hi = n, lo, hi

    def count(self):
        return self.n

    def grow(self):
        if self.n >= self.hi:
            return False
        self.n += 1
        return True

    def shrink(self):
        if self.n <= self.lo:
            return False
        self.n -= 1
        return True


def _jax_side():
    from deeplearning4j_tpu import monitor as jmon
    from deeplearning4j_tpu.monitor import alerts as jal
    from deeplearning4j_tpu.monitor.flightrec import (
        FlightRecorder as JaxRecorder)
    from deeplearning4j_tpu.monitor.registry import (
        MetricsRegistry as JaxRegistry)
    from deeplearning4j_tpu.serving.fleet import (
        FleetAutoscaler as JaxScaler)
    return dict(monitor=jmon, AlertEngine=jal.AlertEngine,
                AlertRule=jal.AlertRule, FlightRecorder=JaxRecorder,
                MetricsRegistry=JaxRegistry, FleetAutoscaler=JaxScaler)


_PORT = dict(monitor=monitor, AlertEngine=AlertEngine, AlertRule=AlertRule,
             FlightRecorder=FlightRecorder, MetricsRegistry=MetricsRegistry,
             FleetAutoscaler=FleetAutoscaler)


def _set_gauges(reg, fleet, goodput):
    """The fleet_* gauges of the scripted fleet, and the goodput
    families (`goodput`: {model: (fraction, useful, warmup)})."""
    for n, s in fleet.servers.items():
        e = s.engine
        reg.gauge("fleet_queue_depth", "", model=n).set(s.depth)
        reg.gauge("fleet_pool_blocks_free", "", model=n).set(
            e.pool.free_blocks)
        reg.gauge("fleet_pool_blocks_used", "", model=n).set(
            e.pool.used_blocks)
        reg.gauge("fleet_slot_count", "", model=n).set(e.n_slots)
        reg.gauge("fleet_model_version", "", model=n).set(1)
    for n, (frac, useful, warm) in goodput.items():
        reg.gauge("serving_goodput_fraction", "", server=n).set(frac)
        reg.counter("serving_tokens_useful_total", "",
                    server=n).inc(useful)
        reg.counter("serving_tokens_warmup_total", "",
                    server=n).inc(warm)


# each scenario: the scaler's kwargs, then passes of (per-model queue
# depth, per-model used blocks, goodput families) applied before check()
SCENARIOS = {
    "thresholds": dict(
        kw=dict(queue_depth_high=4, pool_free_frac_low=0.25, factor=2,
                max_slots=8, max_blocks=64),
        passes=[({"a": 0, "b": 9}, {"a": 2, "b": 3}, {}),
                ({"a": 5, "b": 0}, {"a": 15, "b": 1}, {}),
                ({"a": 9, "b": 9}, {"a": 1, "b": 1}, {}),
                ({"a": 9, "b": 9}, {"a": 1, "b": 60}, {})]),
    "rules_and_goodput": dict(
        kw=dict(factor=2, max_slots=8, max_blocks=64, goodput_low=0.5),
        rules=[dict(name="a-deep", kind="threshold",
                    metric="fleet_queue_depth", labels={"model": "a"},
                    op=">", value=3.0, severity="page"),
               dict(name="fleet-tight", kind="threshold",
                    metric="fleet_pool_blocks_free", op="<", value=2.0,
                    severity="ticket")],
        passes=[({"a": 0, "b": 0}, {"a": 0, "b": 0},
                 {"a": (0.0, 0, 64), "b": (0.0, 0, 64)}),
                ({"a": 5, "b": 0}, {"a": 0, "b": 0},
                 {"b": (0.3, 30, 0)}),
                ({"a": 0, "b": 0}, {"a": 0, "b": 31},
                 {"b": (0.9, 300, 0)})]),
    "replicas": dict(
        kw=dict(queue_depth_high=2, factor=2, max_slots=4, max_blocks=32,
                replica_idle_passes=2),
        replicas=(1, 1, 3),
        passes=[({"a": 3}, {"a": 0}, {}), ({"a": 3}, {"a": 0}, {}),
                ({"a": 3}, {"a": 0}, {}), ({"a": 3}, {"a": 0}, {}),
                ({"a": 0}, {"a": 0}, {}), ({"a": 1}, {"a": 0}, {}),
                ({"a": 0}, {"a": 0}, {}), ({"a": 0}, {"a": 0}, {}),
                ({"a": 0}, {"a": 0}, {}), ({"a": 0}, {"a": 0}, {})]),
}


def _decisions(side, scenario, monitored):
    sc = SCENARIOS[scenario]
    models = {m: (2, 16) for m in sc["passes"][0][0]}
    fleet = _Fleet(models)
    mon = side["monitor"]
    reg = side["MetricsRegistry"]()
    if monitored:
        mon.enable(registry=reg)
    try:
        kw = dict(sc["kw"])
        if "rules" in sc:
            kw["rules"] = side["AlertEngine"](
                reg, [side["AlertRule"](**r) for r in sc["rules"]],
                recorder=side["FlightRecorder"](),
                registry=side["MetricsRegistry"]())
        if "replicas" in sc:
            kw["replicas"] = _Replicas(*sc["replicas"])
        scaler = side["FleetAutoscaler"](fleet, **kw)
        passes = []
        for depth, used, goodput in sc["passes"]:
            for n, s in fleet.servers.items():
                s.depth = depth[n]
                s.engine.pool.used_blocks = used[n]
            for n, (frac, useful, warm) in goodput.items():
                lg = fleet.servers[n].engine.goodput
                lg.fraction = frac
                lg.dispatched_total += useful + warm
                lg.classes["warmup"] += warm
            _set_gauges(reg, fleet, goodput)
            passes.append(scaler.check())
        return passes, scaler.decisions
    finally:
        if monitored:
            mon.disable()


@pytest.mark.parametrize("monitored", [True, False],
                         ids=["gauges", "live"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decision_records_equal_jax(scenario, monitored):
    """The same scripted passes give the same decision records, pass by
    pass and in `decisions`, in both packages: the gauge signal (or its
    live fallback), the thresholds, rules mode and its goodput floor,
    and replica growth at the vertical caps and shrinking after idle
    passes."""
    want = _decisions(_jax_side(), scenario, monitored)
    got = _decisions(_PORT, scenario, monitored)
    assert got == want
    assert any(got[0])
