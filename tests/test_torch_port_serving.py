"""The port's paged serving tier against the JAX package and its own
`generate()`.

Net: the JAX zoo TransformerLM at d16 / 2 blocks, its params converted
to numpy with the output head's W scaled by 8 in the arrays given to
BOTH sides, so greedy logits are decisive rather than near-ties (a
random-init head gives probabilities within float noise of each other,
where argmax parity measures rounding, not the engine). Greedy streams
must be token-equal to the JAX `PagedDecodeEngine`, to JAX `generate()`
and to the port's own `generate()`. Sampled streams are held to
in-vocab, exact length, determinism under a fixed seed, and equality
with the port's sampled `generate()` for the same seed.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import PagedDecodeEngine as JaxEngine
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch.serving import (
    GARBAGE_BLOCK,
    BlockAllocator,
    GenerationServer,
    PagedDecodeEngine,
    ServerDrainingError,
    ServerStoppedError,
    ShedError,
    blocks_needed,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

V, D, HEADS, LAYERS, MAXLEN = 23, 16, 4, 2, 16
BL = 4
HEAD_SCALE = 8.0


@pytest.fixture(scope="module")
def jnet():
    net = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                max_len=MAXLEN, seed=3).init()
    out = str(len(net.layers) - 1)
    net.params = {**net.params,
                  out: {**net.params[out],
                        "W": net.params[out]["W"] * HEAD_SCALE}}
    return net


@pytest.fixture(scope="module")
def net(jnet):
    lm = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                       max_len=MAXLEN).init(device="cpu")
    return from_jax_params(lm, to_numpy_params(jnet.params))


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(5).integers(0, V, (6, 3))


@pytest.fixture(scope="module")
def ref_tokens(jnet, net, prompts):
    want = jax_generate(jnet, prompts, 6, temperature=0)
    np.testing.assert_array_equal(generate(net, prompts, 6, temperature=0),
                                  want)
    return want


def engine(net, **kw):
    kw.setdefault("block_len", BL)
    return PagedDecodeEngine(net, device="cpu", **kw)


def drive(eng, requests, *, n_tokens=6):
    """Admit `requests` (prompt arrays) whenever capacity allows, step to
    completion, requeue preemptions as continuations; returns the
    per-request token lists."""
    out = {r: [] for r in range(len(requests))}
    slot2req, pending = {}, list(range(len(requests)))
    guard = 0
    while pending or eng.active.any():
        while pending:
            r = pending[0]
            cont = np.concatenate([requests[r], np.asarray(out[r], np.int64)])
            left = n_tokens - len(out[r])
            # the JAX engine's can_admit also takes n_tokens (its upfront
            # allocation mode); the port allocates incrementally only
            fits = (eng.can_admit(len(cont))
                    if isinstance(eng, PagedDecodeEngine)
                    else eng.can_admit(len(cont), left))
            if not fits:
                break
            pending.pop(0)
            (slot, first, done), = eng.admit_many(
                [dict(prompt_ids=cont, n_tokens=left, request_id=r,
                      emit_start=len(out[r]))])
            out[r].append(first)
            if not done:
                slot2req[slot] = r
        emitted, finished = eng.step()
        for slot, toks in emitted.items():
            out[slot2req[slot]].extend(toks)
        for slot in finished:
            del slot2req[slot]
        for note in eng.drain_preempted():
            pending.insert(0, slot2req.pop(note["slot"]))
        guard += 1
        assert guard < 200, "engine failed to drain"
    return [out[r] for r in range(len(requests))]


class TestAllocator:
    def test_allocate_free_cycle_and_garbage_block(self):
        a = BlockAllocator(8)
        got = a.allocate(3)
        assert len(got) == 3 and GARBAGE_BLOCK not in got
        assert a.allocate(5) is None          # all-or-nothing
        assert a.free_blocks == 4 and a.used_blocks == 3
        a.free(got)
        assert a.free_blocks == 7

    def test_double_free_and_bad_ids(self):
        a = BlockAllocator(4)
        got = a.allocate(2)
        with pytest.raises(ValueError, match="double-free"):
            a.free([got[0], got[0]])          # validated before mutating
        assert a.free_blocks == 1
        a.free(got)
        with pytest.raises(ValueError, match="double-free"):
            a.free(got[:1])
        with pytest.raises(ValueError, match="invalid block"):
            a.free([0])

    def test_blocks_needed(self):
        assert [blocks_needed(n, 4) for n in (1, 4, 5, 8, 9)] == \
            [1, 1, 2, 2, 3]


class TestEngineParity:
    def test_staggered_admissions_match_jax_engine(self, jnet, net, prompts,
                                                   ref_tokens):
        """2 slots, 4 requests joining as others finish: token-equal to
        the JAX engine under the same schedule and to generate()."""
        got = drive(engine(net, n_slots=2, n_blocks=16), list(prompts[:4]))
        jeng = JaxEngine(jnet, n_slots=2, n_blocks=16, block_len=BL)
        want = drive(jeng, list(prompts[:4]))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(got), ref_tokens[:4])

    @pytest.mark.parametrize("J", [1, 4])
    def test_wave_and_chunked_dispatch(self, net, prompts, ref_tokens, J):
        eng = engine(net, n_slots=4, n_blocks=16, steps_per_dispatch=J)
        admitted = eng.admit_many([dict(prompt_ids=p, n_tokens=6)
                                   for p in prompts[:3]])   # width pads to 4
        assert [a[0] for a in admitted] == [0, 1, 2]
        out = {s: [f] for s, f, _ in admitted}
        while eng.active.any():
            emitted, _ = eng.step()
            for s, toks in emitted.items():
                out[s].extend(toks)
        np.testing.assert_array_equal(np.asarray([out[s] for s in range(3)]),
                                      ref_tokens[:3])
        assert eng.free_blocks == 15

    def test_mixed_length_wave(self, net):
        rng = np.random.default_rng(9)
        ps = [rng.integers(0, V, n) for n in (2, 7, 5)]
        eng = engine(net, n_slots=4, n_blocks=16)
        admitted = eng.admit_many([dict(prompt_ids=p, n_tokens=5)
                                   for p in ps])
        out = {s: [f] for s, f, _ in admitted}
        while eng.active.any():
            for s, toks in eng.step()[0].items():
                out[s].extend(toks)
        for s, p in enumerate(ps):
            want = generate(net, p[None], 5, temperature=0)[0]
            np.testing.assert_array_equal(out[s], want)

    def test_preempt_lowest_progress_and_requeue(self, jnet, net, prompts):
        """Pool pressure evicts the lowest-progress slot; its requeued
        continuation completes exactly (the JAX engine's recipe)."""
        ref_a = generate(net, prompts[:1], 13, temperature=0)[0]
        ref_b = generate(net, prompts[1:2], 6, temperature=0)[0]
        np.testing.assert_array_equal(
            ref_a, jax_generate(jnet, prompts[:1], 13, temperature=0)[0])
        eng = engine(net, n_slots=2, n_blocks=5)          # 4 usable
        (sa, fa, _), = eng.admit_many(
            [dict(prompt_ids=prompts[0], n_tokens=13, request_id="A")])
        out_a = [fa]
        for _ in range(3):
            out_a.extend(eng.step()[0].get(sa, []))
        (sb, fb, _), = eng.admit_many(
            [dict(prompt_ids=prompts[1], n_tokens=6, request_id="B")])
        out_b = [fb]
        while eng.active.any():
            emitted, _ = eng.step()
            out_a.extend(emitted.get(sa, []))
            out_b.extend(emitted.get(sb, []))
        notes = eng.drain_preempted()
        assert [n["request_id"] for n in notes] == ["B"]
        assert notes[0]["emitted"] == len(out_b) and 1 <= len(out_b) < 6
        np.testing.assert_array_equal(out_a, ref_a)
        cont = np.concatenate([prompts[1], np.asarray(out_b)])
        (sb2, f2, _), = eng.admit_many(
            [dict(prompt_ids=cont, n_tokens=6 - len(out_b),
                  emit_start=len(out_b))])
        out_b.append(f2)
        while eng.active.any():
            out_b.extend(eng.step()[0].get(sb2, []))
        np.testing.assert_array_equal(out_b, ref_b)
        assert eng.evict_requeue_total == 1

    def test_incremental_growth_owns_blocks_needed(self, net, prompts):
        eng = engine(net, n_slots=2, n_blocks=16)
        (s, _, _), = eng.admit_many([dict(prompt_ids=prompts[0],
                                          n_tokens=12)])
        while eng.active.any():
            assert len(eng.slots[s].blocks) == blocks_needed(
                int(eng.pos[s]), BL)
            eng.step()
        assert eng.free_blocks == 15

    def test_sampled_stream_deterministic_and_matches_generate(
            self, jnet, net, prompts):
        """A sampled stream does not depend on what else is in flight,
        and it is JAX's: token t drawn under `fold_in(PRNGKey(11), t)`,
        as the JAX engine draws it (JAX's `generate` splits its key
        instead, so the engine's stream is held to the JAX engine)."""
        def run(extra, eng=None):
            eng = eng or engine(net, n_slots=4, n_blocks=16)
            reqs = [dict(prompt_ids=prompts[0], n_tokens=8, temperature=0.8,
                         top_p=0.9, rng=11)]
            reqs += [dict(prompt_ids=p, n_tokens=8) for p in extra]
            admitted = eng.admit_many(reqs)
            out = {s: [f] for s, f, _ in admitted}
            while eng.active.any():
                for s, toks in eng.step()[0].items():
                    out[s].extend(toks)
            return out[0]
        alone = run([])
        batched = run(list(prompts[1:4]))
        assert len(alone) == 8 and all(0 <= t < V for t in alone)
        assert alone == batched
        jeng = JaxEngine(jnet, n_slots=4, n_blocks=16, block_len=BL)
        jeng_reqs = [dict(prompt_ids=prompts[0], n_tokens=8,
                          temperature=0.8, top_p=0.9,
                          rng=np.asarray([0, 11], np.uint32))]
        (js, jfirst, _), = jeng.admit_many(jeng_reqs)
        want = [int(jfirst)]
        while jeng.active.any():
            want.extend(int(t) for t in jeng.step()[0].get(js, []))
        np.testing.assert_array_equal(alone, want)

    def test_top_k_one_samples_the_argmax(self, net, prompts, ref_tokens):
        """top_k=1 leaves only the most probable token, so a sampled
        stream must equal the greedy one."""
        eng = engine(net, n_slots=2, n_blocks=16, top_k=1)
        (s, first, _), = eng.admit_many([dict(
            prompt_ids=prompts[0], n_tokens=6, temperature=1.3, rng=4)])
        out = [first]
        while eng.active.any():
            out.extend(eng.step()[0].get(s, []))
        np.testing.assert_array_equal(out, ref_tokens[0])

    def test_budget_and_validation(self, net):
        eng = engine(net, n_slots=1, n_blocks=4)
        with pytest.raises(ValueError, match="budget"):
            eng.admit_many([dict(prompt_ids=np.zeros(10, np.int64),
                                 n_tokens=10)])
        with pytest.raises(ValueError, match="pool"):
            eng.check_budget(4, 10)          # needs 4 blocks, 3 usable
        with pytest.raises(ValueError, match="token ids"):
            eng.admit_many([dict(prompt_ids=[V], n_tokens=2)])
        assert eng.free_blocks == 3
        # the options ported since are validated as the JAX engine does
        with pytest.raises(ValueError, match="draft depth"):
            PagedDecodeEngine(net, device="cpu", speculative=1)
        with pytest.raises(ValueError, match="quantization mode"):
            PagedDecodeEngine(net, device="cpu", quantize="int4")

    def test_evict_frees_blocks(self, net, prompts):
        eng = engine(net, n_slots=1, n_blocks=4)
        (slot, _, _), = eng.admit_many([dict(prompt_ids=prompts[0],
                                             n_tokens=6)])
        eng.step()
        eng.evict(slot)
        assert eng.free_blocks == 3 and not eng.active.any()
        with pytest.raises(ValueError):
            eng.evict(slot)


class TestServer:
    def test_concurrent_streams_with_requeue(self, net, prompts, ref_tokens):
        """A pool too small for every stream forces preempt-and-requeue
        mid-serving; every stream still equals generate()."""
        srv = GenerationServer(net, n_slots=4, n_blocks=5, block_len=BL,
                               device="cpu").warmup(3, 6).start()
        try:
            streams = [srv.generate_async(p, 6) for p in prompts[:4]]
            got = np.stack([s.result(timeout=60) for s in streams])
        finally:
            srv.stop()
        np.testing.assert_array_equal(got, ref_tokens[:4])
        assert srv.engine.evict_requeue_total >= 1

    def test_staggered_submits_and_iteration(self, net, prompts, ref_tokens):
        with GenerationServer(net, n_slots=2, n_blocks=16, block_len=BL,
                              device="cpu") as srv:
            streams = []
            for p in prompts:
                streams.append(srv.generate_async(p, 6))
                time.sleep(0.01)
            first = list(streams[0])
            got = np.stack([s.result(timeout=60) for s in streams])
            assert srv.drain(timeout=30)
            with pytest.raises(ServerDrainingError):
                srv.generate_async(prompts[0], 2)
        np.testing.assert_array_equal(first, ref_tokens[0])
        np.testing.assert_array_equal(got, ref_tokens)

    def test_sampled_requests(self, net, prompts):
        with GenerationServer(net, n_slots=4, n_blocks=16, block_len=BL,
                              device="cpu") as srv:
            a = srv.generate_async(prompts[0], 7, temperature=0.8,
                                   top_p=0.9, rng=3)
            b = srv.generate_async(prompts[0], 7, temperature=0.8,
                                   top_p=0.9, rng=3)
            a, b = a.result(timeout=60), b.result(timeout=60)
        assert len(a) == 7 and ((a >= 0) & (a < V)).all()
        np.testing.assert_array_equal(a, b)

    def test_shed_cancel_stop_and_validation(self, net, prompts):
        srv = GenerationServer(net, n_slots=1, n_blocks=5, block_len=BL,
                               max_queue=1, device="cpu")
        with pytest.raises(RuntimeError, match="start"):
            srv.generate_async(prompts[0], 2)
        srv.start()
        try:
            with pytest.raises(ValueError, match="budget"):
                srv.generate_async(np.zeros(10, np.int64), 10)
            with pytest.raises(ValueError, match="top_p"):
                srv.generate_async(prompts[0], 2, top_p=0.0)
            streams = [srv.generate_async(prompts[i % 6], 12)
                       for i in range(8)]
            shed = 0
            for s in streams:
                try:
                    s.result(timeout=60)
                except ShedError:
                    shed += 1
            assert shed >= 1
            c = srv.generate_async(prompts[0], 12)
            c.cancel()
            assert len(c.result(timeout=60)) < 12
        finally:
            srv.stop()
        assert srv.engine.free_blocks == 4
        with pytest.raises(ServerStoppedError):
            srv.start()

    def test_stop_fails_inflight(self, net, prompts):
        srv = GenerationServer(net, n_slots=1, n_blocks=5, block_len=BL,
                               device="cpu").start()
        streams = [srv.generate_async(p, 12) for p in prompts[:3]]
        srv.stop()
        for s in streams:
            try:
                s.result(timeout=10)
            except RuntimeError:
                pass
            assert s._fut.done()
        assert threading.active_count() < 50

    def test_server_rejects_unported_options(self, net):
        """The constructor takes the JAX server's SLO, name and metrics
        arguments; the two it leaves out are refused: `dispatch_floor_s`
        (a CPU load-test emulation of a slower device) and
        `idle_wait_s` (a constant here)."""
        GenerationServer(net, device="cpu", slo_ttft_s=1.0, name="a",
                         max_queue=4).stop()
        for kw in (dict(dispatch_floor_s=0.01), dict(idle_wait_s=0.01)):
            with pytest.raises(TypeError):
                GenerationServer(net, device="cpu", **kw)


def test_engine_refuses_net_on_other_device(net):
    with pytest.raises(ValueError, match="lives on"):
        PagedDecodeEngine(net, device="meta")
    assert torch.device("cpu") == net.device
