"""The port's serving request plane against the JAX package's, on the CPU
at a small size (2 layers, d32): `GenerationServer`'s traces, goodput
mirror, SLO shedding and metrics, the engine's ledger, handoff and cost
report, and the disaggregated workers.

Both sides serve the same weights (JAX's `init()`, the output head's W
x8 so greedy logits are decisive) and run their scheduler's loop body
(`_schedule_once`) in the test's thread over a burst queued before the
first admission (`chip_smoke.drive_server`), so both see the same waves
and their ledgers and counters can be compared number for number. The
JAX side runs once per module (`jax_runs`): each JAX serving program is
an XLA compile. Mirrors the JAX tests `tests/test_goodput.py`
(`TestServingConservation`, `TestGoodputSyncContract`),
`tests/test_serving_trace.py` (`TestShedTraceAndSLO`),
`tests/test_serving.py` (`test_shed_under_overload`) and
`tests/test_disagg.py`.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import socket

import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu import monitor as jmon
from deeplearning4j_tpu.serving import GenerationServer as JaxServer
from deeplearning4j_tpu.serving import PagedDecodeEngine as JaxEngine
from deeplearning4j_tpu.serving import disagg as jdisagg
from deeplearning4j_tpu.monitor import SLOObjective as JaxSLO
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch import monitor as pmon
from deeplearning4j_tpu_torch.monitor import SLOObjective
from deeplearning4j_tpu_torch.monitor.goodput import (
    GOODPUT_COUNTER_FAMILIES,
)
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.nn.layers import EmbeddingLayer
from deeplearning4j_tpu_torch.serving import (
    DecodeWorker,
    GenerationServer,
    PagedDecodeEngine,
    PrefillWorker,
    ServerDrainingError,
    ShedError,
    run_disaggregated,
    wire,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    stream_agreement,
    teacher_forced_probs,
)

V, D, HEADS, LAYERS, MAXLEN, BL = 48, 32, 4, 2, 32, 4
HEAD_SCALE = 8.0
SLOTS, N_TOK, PROMPT = 2, 6, 3
SHED = dict(slo_ttft_s=0.2, ewma_tok_s=100.0, burst=8)
COUNTERS = ("serving_requests_total", "serving_tokens_total",
            "serving_shed_total", "serving_block_grants_total",
            "slo_requests_good_total", "slo_requests_bad_total",
            *GOODPUT_COUNTER_FAMILIES.values())


@pytest.fixture(scope="module")
def jnet():
    net = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                max_len=MAXLEN, seed=3).init()
    out = str(len(net.layers) - 1)
    net.params = {**net.params,
                  out: {**net.params[out],
                        "W": net.params[out]["W"] * HEAD_SCALE}}
    return net


def _port(jnet, dtype_policy=None):
    lm = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                       max_len=MAXLEN).init(device="cpu",
                                            dtype_policy=dtype_policy)
    return from_jax_params(lm, to_numpy_params(jnet.params))


@pytest.fixture(scope="module")
def net(jnet):
    return _port(jnet)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(16)
    return [rng.integers(0, V, PROMPT) for _ in range(6)]


@pytest.fixture(scope="module")
def spec_prompts():
    # repeating prompts give the n-gram proposer something to draft
    return [np.array([5, 9, 5, 9, 5, 9, 5]), np.array([1, 2, 3, 1, 2, 3])]


class _Mon:
    """Monitoring on for one package with a fresh registry and tracer."""

    def __init__(self, mod):
        self.m = mod

    def __enter__(self):
        self.reg = self.m.enable(registry=self.m.MetricsRegistry(),
                                 tracer=self.m.Tracer())
        return self.reg

    def __exit__(self, *exc):
        self.m.disable()
        self.m._STATE.registry = self.m.GLOBAL_REGISTRY
        self.m._STATE.tracer = self.m.GLOBAL_TRACER


def _counters(reg):
    snap = reg.snapshot()
    return {f: sum(v["value"] for v in snap[f]["values"])
            for f in COUNTERS if f in snap}


def _server(jax, net, **kw):
    kw = dict(n_slots=SLOTS, n_blocks=SLOTS * (MAXLEN // BL) + 1,
              block_len=BL, **kw)
    return JaxServer(net, **kw) if jax else GenerationServer(
        net, device="cpu", **kw)


def _serve(jax, net, reqs, *, monitored=True, warm=True, ewma=None, **kw):
    """One driven burst: (tokens or None per request, the ledger's
    snapshot, the counters, the streams)."""
    mon = _Mon(jmon if jax else pmon)
    reg = mon.__enter__() if monitored else None
    try:
        srv = _server(jax, net, **kw)
        if warm:
            srv.warmup(PROMPT, N_TOK)
        if ewma is not None:
            srv._ewma_tok_s = ewma
        streams = chip_smoke.drive_server(srv, reqs, N_TOK)
    finally:
        if monitored:
            mon.__exit__()
    toks = []
    for s in streams:
        try:
            toks.append(np.asarray(s.result(0)).tolist())
        except ShedError:
            toks.append(None)
        except RuntimeError as e:     # the JAX package's ShedError
            assert type(e).__name__ == "ShedError"
            toks.append(None)
    return dict(tokens=toks, goodput=srv.engine.goodput.snapshot(),
                counters=_counters(reg) if reg is not None else None,
                streams=streams)


def _colocated(eng, prompts, n_tok):
    """Each prompt admitted in a wave of its own, then all decoded
    together: the stream a disaggregated pair must reproduce."""
    firsts, slots = [], []
    for p in prompts:
        slot, first, _ = eng.admit(p, n_tok)
        firsts.append(int(first))
        slots.append(slot)
    rest = {s: [] for s in slots}
    while eng.active.any():
        for s, toks in eng.step()[0].items():
            rest[s].extend(int(t) for t in toks)
    return [[f] + rest[s] for f, s in zip(firsts, slots)]


@pytest.fixture(scope="module")
def jax_runs(jnet, prompts, spec_prompts):
    greedy = [(p, {}) for p in prompts[:4]]
    burst = [(prompts[i % len(prompts)], {}) for i in range(SHED["burst"])]
    shed_kw = dict(slo_ttft_s=SHED["slo_ttft_s"], name="shedder",
                   slo=JaxSLO(ttft_s=600.0))
    kw = dict(n_slots=SLOTS, n_blocks=SLOTS * (MAXLEN // BL) + 1,
              block_len=BL)
    pre = jdisagg.PrefillWorker(jnet, **kw)
    frames = [pre.prefill(p, N_TOK, request_id=f"j{i}")
              for i, p in enumerate(prompts[:SLOTS])]
    return dict(
        plain=_serve(True, jnet, greedy),
        spec=_serve(True, jnet, [(p, {}) for p in spec_prompts],
                    speculative=3),
        shed=_serve(True, jnet, burst, warm=False, ewma=SHED["ewma_tok_s"],
                    **shed_kw),
        frames=frames,
        colocated=_colocated(JaxEngine(jnet, **kw), prompts[:SLOTS], N_TOK),
        cost={q: JaxEngine(jnet, quantize=q, **kw).decode_cost_report()
              for q in (None, "int8")})


# ------------------------------------------------ traces and host reads
def test_monitoring_on_and_off_serve_the_same_streams(net, prompts,
                                                      jax_runs):
    """JAX's sync contract (`tests/test_goodput.py:184-231`): the
    monitored run makes the same host reads and emits the same tokens,
    and equals JAX's stream."""
    reqs = [(p, {}) for p in prompts[:4]]
    runs = {}
    for on in (False, True):
        with chip_smoke.HostReads(torch.device("cpu")) as reads:
            runs[on] = _serve(False, net, reqs, monitored=on)
        runs[on]["reads"] = reads.n
    assert runs[True]["tokens"] == runs[False]["tokens"]
    assert runs[True]["reads"] == runs[False]["reads"] > 0
    assert runs[True]["tokens"] == jax_runs["plain"]["tokens"]
    assert all(s.trace is None for s in runs[False]["streams"])
    for s in runs[True]["streams"]:
        tr = s.trace
        assert tr.finished and tr.status == "ok"
        names = [p["name"] for p in tr.phases]
        assert names[:2] == ["queued", "prefill"] and "decode" in names
        assert tr.meta["prompt_len"] == PROMPT and tr.meta["ttft_s"] >= 0
        assert tr.meta["n_tokens"] == N_TOK


@pytest.mark.parametrize("spec", [False, True])
def test_goodput_classes_equal_jax(net, prompts, spec_prompts, jax_runs,
                                   spec):
    """A warmed run's ledger: conserved, mirrored on the registry, and
    class for class JAX's (speculation off and on)."""
    if spec:
        run = _serve(False, net, [(p, {}) for p in spec_prompts],
                     speculative=3)
        want = jax_runs["spec"]
    else:
        run = _serve(False, net, [(p, {}) for p in prompts[:4]])
        want = jax_runs["plain"]
    snap = run["goodput"]
    assert sum(snap[c] for c in GOODPUT_COUNTER_FAMILIES) == \
        snap["dispatched_total"]
    assert snap == want["goodput"]
    assert snap["warmup"] > 0 and 0 < snap["goodput_fraction"] < 1
    for cls, fam in GOODPUT_COUNTER_FAMILIES.items():
        assert run["counters"].get(fam, 0) == snap[cls]
    assert run["counters"] == want["counters"]
    assert run["tokens"] == want["tokens"]
    if spec:
        assert snap["spec_rejected"] > 0 or snap["useful"] > 0


def test_shed_decisions_and_counters_equal_jax(net, prompts, jax_runs):
    """One scripted `slo_ttft_s` (0.2 s at an estimate of 100 tokens a
    second) against a burst of 8: the same requests shed as in JAX, the
    same counters (shed, SLO good and bad, requests, tokens, goodput),
    each shed stream failed with ShedError and its trace carrying the
    reason."""
    burst = [(prompts[i % len(prompts)], {}) for i in range(SHED["burst"])]
    run = _serve(False, net, burst, warm=False, ewma=SHED["ewma_tok_s"],
                 slo_ttft_s=SHED["slo_ttft_s"], name="shedder",
                 slo=SLOObjective(ttft_s=600.0))
    want = jax_runs["shed"]
    shed = [t is None for t in run["tokens"]]
    assert shed == [t is None for t in want["tokens"]]
    assert shed == [False] * 3 + [True] * 5
    assert run["counters"] == want["counters"]
    assert run["counters"]["serving_shed_total"] == 5
    assert run["counters"]["slo_requests_bad_total"] == 5
    for s, is_shed in zip(run["streams"], shed):
        if is_shed:
            with pytest.raises(ShedError, match="TTFT SLO"):
                s.result(0)
            assert s.trace.status == "shed"
            (ev,) = [e for e in s.trace.events if e["name"] == "shed"]
            assert "projected queue delay" in ev["args"]["reason"]


def test_max_queue_backstop_and_drain_mode(net, prompts):
    run = _serve(False, net, [(p, {}) for p in prompts], warm=False,
                 max_queue=1)
    assert sum(t is None for t in run["tokens"]) == 5
    assert run["counters"]["serving_shed_total"] == 5
    srv = _server(False, net).start()
    try:
        streams = [srv.generate_async(p, N_TOK) for p in prompts[:3]]
        assert srv.drain(timeout=60)
        with pytest.raises(ServerDrainingError):
            srv.generate_async(prompts[0], 2)
    finally:
        srv.stop()
    assert all(len(s.result(0)) == N_TOK for s in streams)
    gp = srv.engine.goodput
    assert gp.mode == "drain" and gp.conserved()


def test_server_queue_surface(net, prompts):
    """`queue_depth`, `queued_tokens`, `output_async` (refused, as in
    JAX) and a queued request migrated with `export_queued` /
    `adopt_queued`."""
    a, b = _server(False, net), _server(False, net)
    with pytest.raises(NotImplementedError, match="token streams"):
        a.output_async(np.zeros((1, 3)))
    a._running = True                 # submit without its scheduler
    try:
        streams = [a.generate_async(p, N_TOK) for p in prompts[:3]]
        assert a.queue_depth() == 3 and a.queued_tokens == 3 * N_TOK
        assert a.open_streams == 3
        items = a.export_queued()
        assert len(items) == 3 and a.open_streams == 0
        assert a.queued_tokens == 0 and a.queue_depth() == 0
    finally:
        a._running = False
        a.stop()
    b.start()
    try:
        assert b.adopt_queued(items) == 3
        got = [s.result(timeout=60).tolist() for s in streams]
    finally:
        b.stop()
    assert all(len(t) == N_TOK for t in got)


# ---------------------------------------------------------- handoff
@pytest.mark.parametrize("policy", [None, "mixed_bf16"])
def test_port_handoff_equals_colocated(jnet, prompts, policy):
    """Port to port through DLFP bytes (over a socket pair too): every
    handed-off slot continues bit-equal to the colocated stream."""
    pnet = _port(jnet, policy)
    kw = dict(n_slots=SLOTS, n_blocks=SLOTS * (MAXLEN // BL) + 1,
              block_len=BL, device="cpu")
    want = _colocated(PagedDecodeEngine(pnet, **kw), prompts[:SLOTS], N_TOK)
    got = run_disaggregated(PrefillWorker(pnet, **kw),
                            DecodeWorker(pnet, **kw), prompts[:SLOTS], N_TOK)
    assert got == want
    a, b = socket.socketpair()
    try:
        got = run_disaggregated(PrefillWorker(pnet, **kw),
                                DecodeWorker(pnet, **kw), prompts[:SLOTS],
                                N_TOK, channel=(a, b))
    finally:
        a.close()
        b.close()
    assert got == want
    pre = PrefillWorker(pnet, **kw)
    first, frame = pre.prefill(prompts[0], N_TOK, request_id="x")
    header, kv = wire.decode_handoff(frame)
    dtype = torch.bfloat16 if policy else np.float32
    assert kv.dtype == dtype and header["request_id"] == "x"
    assert pre.engine.free_slots == SLOTS       # released after the frame
    assert pre.prefill(prompts[1], 1)[1] is None   # done at prefill


def test_jax_handoff_continues_in_the_port(jnet, net, prompts, jax_runs):
    """JAX `export_handoff` -> `wire.encode_handoff` -> the port's
    DecodeWorker: the greedy stream equals JAX's colocated stream by
    margin (`stream_agreement`, eps the largest teacher-forced
    probability difference port against JAX)."""
    dec = DecodeWorker(net, n_slots=SLOTS,
                       n_blocks=SLOTS * (MAXLEN // BL) + 1, block_len=BL,
                       device="cpu")
    firsts, slots = [], []
    for first, frame in jax_runs["frames"]:
        firsts.append(int(first))
        slots.append(dec.adopt(frame))
    rest = dec.decode_to_completion(slots)
    got = [[f] + rest[s] for f, s in zip(firsts, slots)]
    want = jax_runs["colocated"]
    for p, w, g in zip(prompts, want, got):
        probs = _jax_teacher_forced(jnet, p, w)
        eps = float(np.abs(teacher_forced_probs(net, p, w) - probs).max())
        rep = stream_agreement(w, g, probs, eps)
        assert rep["ok"], rep
    assert got == want


def _jax_teacher_forced(jnet, prompt, tokens):
    from deeplearning4j_tpu.nn.layers.recurrent import BaseRecurrentLayer
    seq = np.concatenate([prompt, np.asarray(tokens[:-1])])[None]
    carries = {str(i): layer.init_carry(1, jnet.dtype.compute_dtype)
               for i, layer in enumerate(jnet.layers)
               if isinstance(layer, BaseRecurrentLayer)}
    h = jnet._forward_core(jnet.params, jnet.net_state, seq, train=False,
                           rng=None, carries=carries)[0]
    return np.asarray(h[0, len(prompt) - 1:], np.float64)


def test_handoff_refusals_leave_the_engine_as_it_was(net, prompts):
    kw = dict(n_slots=1, n_blocks=3, block_len=BL, device="cpu")
    src = PagedDecodeEngine(net, n_slots=1, n_blocks=9, block_len=BL,
                            device="cpu")
    slot, _, _ = src.admit(np.arange(9) % V, 4)
    header, kv = src.export_handoff(slot)
    assert kv.shape[:3] == (LAYERS, 2, 3)
    dst = PagedDecodeEngine(net, **kw)
    with pytest.raises(ValueError, match="dtype"):
        dst.adopt_handoff(header, kv.double())
    with pytest.raises(ValueError, match="layers"):
        dst.adopt_handoff(header, kv[:1])
    with pytest.raises(ValueError, match="block_len"):
        dst.adopt_handoff(dict(header, block_len=8), kv)
    with pytest.raises(RuntimeError, match="cannot grant 3 blocks"):
        dst.adopt_handoff(header, kv)           # 2 usable blocks
    assert dst.free_slots == 1 and dst.free_blocks == 2
    assert dst.block_grants_total == 0
    src.evict(slot)
    with pytest.raises(ValueError, match="not in use"):
        src.export_handoff(slot)


def test_export_gathers_shared_blocks_by_value(net):
    """A slot riding a registered prefix (copy-on-write blocks) hands
    off private copies whose stream equals the colocated one."""
    kw = dict(n_slots=2, n_blocks=16, block_len=BL, device="cpu")
    prefix = np.arange(8) % V
    prompt = np.concatenate([prefix, [3, 7]])
    colo = PagedDecodeEngine(net, **kw)
    colo.register_prefix(prefix)
    want = _colocated(colo, [prompt], N_TOK)
    src = PagedDecodeEngine(net, **kw)
    src.register_prefix(prefix)
    slot, first, _ = src.admit(prompt, N_TOK)
    assert src.prefix_hits_total == 1
    header, kv = src.export_handoff(slot)
    dst = DecodeWorker(net, **kw)
    s = dst.adopt(wire.encode_handoff(header, kv))
    assert dst.engine.pool.allocator.shared_blocks == 0
    got = [int(first)] + dst.decode_to_completion([s])[s]
    assert got == want[0]


# ------------------------------------------------------ cost report
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decode_cost_report(net, prompts, jax_runs, quantize):
    """Weight and matmul-weight bytes equal JAX's exactly; the FLOPs of
    one dispatch's weight matmuls are 2 x matmul params x slots x
    steps_per_dispatch (within 5%), and the whole count adds the
    attention over the pages."""
    for J in (1, 2):
        eng = PagedDecodeEngine(net, n_slots=SLOTS, block_len=BL,
                                n_blocks=SLOTS * (MAXLEN // BL) + 1,
                                steps_per_dispatch=J, quantize=quantize,
                                device="cpu")
        eng.admit_many([dict(prompt_ids=p, n_tokens=N_TOK)
                        for p in prompts[:SLOTS]])
        state = (eng.pos.copy(), eng.last_token.copy(),
                 [(k.clone(), v.clone()) for k, v in eng.pool.kv])
        rep = eng.decode_cost_report()
        want = jax_runs["cost"][quantize]
        assert rep["weight_bytes"] == want["weight_bytes"]
        assert rep["matmul_weight_bytes"] == want["matmul_weight_bytes"]
        n_mm = sum(net.layers[int(lk)].jax_param_map()[k].numel()
                   for lk, ks in quant.quantized_weight_keys(net).items()
                   if not isinstance(net.layers[int(lk)], EmbeddingLayer)
                   for k in ks)
        mm = rep["decode_matmul_flops_per_step"] * J
        assert abs(mm - 2 * n_mm * SLOTS * J) <= 0.05 * mm
        assert rep["decode_flops_per_dispatch"] == J * (
            rep["decode_matmul_flops_per_step"]
            + rep["decode_attention_flops_per_step"])
        assert rep["decode_bytes_per_step"] == (
            rep["weight_bytes"] + rep["decode_kv_bytes_per_step"])
        # the walk ran on the garbage block: nothing moved
        assert np.array_equal(eng.pos, state[0])
        assert np.array_equal(eng.last_token, state[1])
        for (k, v), (k0, v0) in zip(eng.pool.kv, state[2]):
            assert torch.equal(k[1:], k0[1:]) and torch.equal(v[1:], v0[1:])


def test_single_admit_and_pool_accounting(net, prompts):
    eng = PagedDecodeEngine(net, n_slots=1, block_len=BL, n_blocks=9,
                            device="cpu")
    slot, first, done = eng.admit(prompts[0], N_TOK)
    assert not done and 0 <= first < V
    assert eng.admit_info == {slot: dict(grants=1, prefix_hit=False,
                                         tokens_saved=0, cow_fork=False)}
    assert eng.admit(prompts[1], N_TOK) is None          # no free slot
    assert eng.admit_info == {}                          # a new wave
    assert eng.pool.used_blocks == 1
    assert eng.pool.device_bytes() == sum(
        t.numel() * 4 for kv in eng.pool.kv for t in kv)
