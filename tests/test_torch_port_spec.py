"""Speculative decoding, copy-on-write shared prefixes and the radix
prefix cache in the port, against the JAX package's serving core
(`deeplearning4j_tpu/serving/{paged,engine,server}.py`,
`zoo/transformer.py`'s `paged_score_forward` and
`rejection_sample_drafts`).

Contracts and tolerances:
- The refcounted allocator and the radix tree are host code: the same
  seeded op sequence gives equal results, refcounts, free counts and
  evictions on both sides; the n-gram proposer gives equal proposals.
- `paged_score_forward`: each real lane's probabilities within
  PROB_ATOL = 1e-5 of K single-token dispatches on the same pool and of
  JAX's score on the same pool (fp32 on the CPU).
- Greedy streams by margin (`zoo.transformer.stream_agreement`): the
  reference (JAX `generate()`, or the port's private-block or
  non-speculative stream) and the stream under test are equal up to a
  first difference, which must sit at a near-tie of the reference,
  whose top-1/top-2 gap is at most EPS, the largest probability
  difference measured in this module between the K-wide score and
  single-token decodes and between the port and JAX (`margin`).
- Sampled streams over a shared prefix equal the private ones token for
  token (same noise, probabilities equal up to rounding).
- Rejection sampling: the acceptance identity E[accepted] = q_t(d)
  within 5 binomial sigmas; zero-support drafts never accepted; the
  emitted token's marginal fits JAX's filtered target by chi-square at
  q = 1 - 1e-4 (`tests/test_torch_port_sampling.py`'s harness).

Net: the JAX zoo LM at d32 / 2 blocks / vocab 31, its output head
scaled by 8 in the params both sides load (decisive greedy logits).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import PagedDecodeEngine as JaxEngine
from deeplearning4j_tpu.serving.engine import Slot as JaxSlot
from deeplearning4j_tpu.serving.paged import (
    BlockAllocator as JaxAllocator,
    RadixPrefixCache as JaxRadix,
)
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    filter_logits as jax_filter_logits,
    generate as jax_generate,
    paged_score_forward as jax_score,
)
from deeplearning4j_tpu_torch.serving import (
    BlockAllocator,
    GenerationServer,
    PagedDecodeEngine,
)
from deeplearning4j_tpu_torch.serving.engine import Slot
from deeplearning4j_tpu_torch.serving.paged import RadixPrefixCache
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    generate,
    rejection_sample_drafts,
    stream_agreement,
    teacher_forced_probs,
)

V, D, HEADS, LAYERS, MAXLEN, BL = 31, 32, 4, 2, 40, 4
HEAD_SCALE = 8.0
PROB_ATOL = 1e-5
N_TOK = 16


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
    return np.random.default_rng(5).integers(0, V, (6, 5))


@pytest.fixture(scope="module")
def ref(jnet, prompts):
    """JAX `generate()`'s greedy streams for `prompts`."""
    return np.asarray(jax_generate(jnet, prompts, N_TOK, temperature=0))


def engine(net, **kw):
    kw.setdefault("block_len", BL)
    return PagedDecodeEngine(net, device="cpu", **kw)


def drive(eng, reqs, **step_kw):
    """Admit every request (all must fit) and step to completion;
    returns the token lists in request order."""
    admitted = eng.admit_many(reqs)
    assert len(admitted) == len(reqs)
    out = {s: [f] for s, f, _ in admitted}
    guard = 0
    while eng.active.any():
        emitted, _ = eng.step(**step_kw)
        for s, toks in emitted.items():
            out[s].extend(toks)
        guard += 1
        assert guard < 400, "engine failed to drain"
    return [out[s] for s, _, _ in admitted]


def jax_pool(eng):
    return tuple((jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
                 for k, v in eng.pool.kv)


def single_lane_probs(eng, token_mat, n_valid):
    """K single-token dispatches over the engine's pool (in place):
    probs [S, K, V]; slot s writes only lanes j < n_valid[s]."""
    K = token_mat.shape[1]
    pos = torch.as_tensor(eng.pos)
    out = []
    with torch.no_grad(), eng._weights():
        for j in range(K):
            live = (j < n_valid)[:, None]
            bt = torch.as_tensor(np.where(live, eng.block_tables, 0))
            out.append(eng._walk(eng._plan, torch.as_tensor(token_mat[:, j]),
                                 pos + j, bt))
    return torch.stack(out, dim=1).numpy()


@pytest.fixture(scope="module")
def margin(jnet, net, prompts, ref):
    """EPS: the largest probability difference between the K-wide score
    and single-token decodes, and between the port and JAX (teacher
    forcing on JAX's streams)."""
    eps = 0.0
    for p, t in zip(prompts, ref):
        jp = teacher_forced_probs_jax(jnet, p, t)
        eps = max(eps, float(np.abs(teacher_forced_probs(net, p, t)
                                    - jp).max()))
    eng = engine(net, n_slots=6, n_blocks=64)
    eng.admit_many([dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts])
    K = 4
    token_mat = np.concatenate([eng.last_token[:, None], ref[:, 1:K]], 1)
    n_valid = np.full(6, K)
    eng._grow_block_tables({s: K for s in range(6)})
    saved = [(k.clone(), v.clone()) for k, v in eng.pool.kv]
    with torch.no_grad(), eng._weights():
        wide = eng._score(token_mat, eng.pos, n_valid).numpy()
    for (k, v), (k0, v0) in zip(eng.pool.kv, saved):
        k.copy_(k0)
        v.copy_(v0)
    single = single_lane_probs(eng, token_mat, n_valid)
    eps = max(eps, float(np.abs(wide - single).max()))
    assert eps <= PROB_ATOL, eps
    return eps


def teacher_forced_probs_jax(jnet, prompt, tokens):
    from deeplearning4j_tpu.nn.layers.recurrent import BaseRecurrentLayer
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    carries = {str(i): layer.init_carry(1, jnet.dtype.compute_dtype)
               for i, layer in enumerate(jnet.layers)
               if isinstance(layer, BaseRecurrentLayer)}
    h = jnet._forward_core(jnet.params, jnet.net_state, seq, train=False,
                           rng=None, carries=carries)[0]
    return np.asarray(h[0, len(prompt) - 1:], np.float64)


def assert_agree(net, prompts, want, got, eps):
    """`got` equals `want` by margin (reference probabilities: the
    port's teacher-forced ones on `want`); returns the near-ties."""
    ties = 0
    for p, w, g in zip(prompts, want, got):
        r = stream_agreement(w, g, teacher_forced_probs(net, p, w), eps)
        assert r["ok"], r
        ties += r["near_ties"]
    return ties


# ----------------------------------------------------- host structures
def _state(alloc, radix):
    return (alloc.free_blocks, alloc.used_blocks, alloc.shared_blocks,
            tuple(alloc.refcount(b) for b in range(alloc.n_blocks)),
            radix.nodes, radix.held_blocks, radix.evictable_blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_radix_follow_jax_on_a_random_op_sequence(seed):
    rng = np.random.default_rng(seed)
    n_blocks, bl = 24, 2
    a, ja = BlockAllocator(n_blocks), JaxAllocator(n_blocks)
    r, jr = RadixPrefixCache(a, bl), JaxRadix(ja, bl)
    held = []                       # references the test holds
    for _ in range(400):
        op = rng.integers(0, 7)
        if op == 0:                                    # allocate
            n = int(rng.integers(1, 4))
            got, want = a.allocate(n), ja.allocate(n)
            assert got == want
            held += got or []
        elif op == 1 and held:                         # share
            pick = [held[i] for i in rng.integers(0, len(held), 2)]
            a.share(pick)
            ja.share(pick)
            held += pick
        elif op == 2 and held:                         # free
            idx = sorted(set(rng.integers(0, len(held), 2).tolist()),
                         reverse=True)
            pick = [held.pop(i) for i in idx]
            a.free(pick)
            ja.free(pick)
        elif op == 3:                                  # refused ops
            b = int(rng.integers(1, n_blocks))
            for fn in (lambda al: al.free([b] * 999),
                       lambda al: al.share([b]) if al.refcount(b) == 0
                       else al.free([0])):
                with pytest.raises(ValueError):
                    fn(a)
                with pytest.raises(ValueError):
                    fn(ja)
        elif op == 4 and len(held) >= 2:               # radix insert
            toks = rng.integers(0, 2, int(rng.integers(2, 9)))
            nb = min(len(toks) // bl, len(held))
            blocks = held[-nb:] if nb else []
            assert r.insert(toks, blocks) == jr.insert(toks, blocks)
        elif op == 5:                                  # radix match
            toks = rng.integers(0, 2, int(rng.integers(1, 9)))
            assert r.match(toks) == jr.match(toks)
        elif op == 6:                                  # evict / clear
            if rng.random() < 0.1:
                assert r.clear() == jr.clear()
            else:
                assert r.evict_lru() == jr.evict_lru()
        assert _state(a, r) == _state(ja, jr)


def test_share_and_free_refusals():
    a = BlockAllocator(6)
    got = a.allocate(2)
    with pytest.raises(ValueError, match="not granted"):
        a.share([5])
    a.share(got[:1])
    assert a.refcount(got[0]) == 2 and a.shared_blocks == 1
    a.free(got[:1])
    assert a.refcount(got[0]) == 1 and a.free_blocks == 3
    with pytest.raises(ValueError, match="double-free"):
        a.free([got[1], got[1]])
    a.free(got)
    assert a.free_blocks == 5 and a.refcount(got[0]) == 0


@pytest.mark.parametrize("max_draft", [0, 1, 3, 4])
def test_ngram_proposals_equal_jax(jnet, net, max_draft):
    eng = engine(net, n_slots=1, n_blocks=8, speculative=5)
    jeng = JaxEngine(jnet, n_slots=1, n_blocks=8, block_len=BL,
                     speculative=5)
    rng = np.random.default_rng(max_draft)
    hists = [rng.integers(0, 4, int(rng.integers(1, 30))).tolist()
             for _ in range(40)]
    hists += [[9, 4, 5, 4, 5, 4, 5], [1, 7, 8, 9, 2, 7, 8, 5, 6, 7, 8],
              [3, 7, 8, 4, 1, 3, 7, 8, 9, 3, 7, 8], [1, 2, 3, 4, 5]]
    for h in hists:
        eng.slots[0] = Slot(None, [], 0, 0, history=list(h))
        jeng.slots[0] = JaxSlot(None, [], 0, 0, history=list(h))
        assert eng._propose(0, max_draft) == jeng._propose(0, max_draft), h


# ----------------------------------------------------------- the score
def test_paged_score_matches_single_decodes_and_jax(jnet, net, prompts,
                                                    ref):
    eng = engine(net, n_slots=4, n_blocks=48)
    jeng = JaxEngine(jnet, n_slots=4, n_blocks=48, block_len=BL)
    eng.admit_many([dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts[:3]])
    K = 4
    token_mat = np.zeros((4, K), np.int64)
    token_mat[:3, 0] = eng.last_token[:3]
    token_mat[0, 1:] = ref[0, 1:K]                 # the true continuation
    token_mat[1, 1:] = [7, 3, 11]                  # drafts off the path
    token_mat[2, 1:] = ref[2, 1:K]
    n_valid = np.asarray([K, K, 2, 0])             # slot 3 sits out
    eng._grow_block_tables({0: K, 1: K, 2: 2})
    saved = [(k.clone(), v.clone()) for k, v in eng.pool.kv]
    pool_j = jax_pool(eng)
    with torch.no_grad(), eng._weights():
        wide = eng._score(token_mat, eng.pos, n_valid).numpy()
    assert wide.shape == (4, K, V)
    # the dead lanes wrote only into the garbage block
    live = {int(b) for s in range(3) for b in eng.block_tables[s]}
    untouched = [b for b in range(1, eng.pool.n_blocks) if b not in live]
    for (k, v), (k0, v0) in zip(eng.pool.kv, saved):
        assert torch.equal(k[untouched], k0[untouched])
        k.copy_(k0)
        v.copy_(v0)
    single = single_lane_probs(eng, token_mat, n_valid)
    i32 = np.int32
    _, want = jax_score(jnet, jeng._plan, jnet.params, jnet.net_state,
                        pool_j, jnp.asarray(eng.block_tables.astype(i32)),
                        jnp.asarray(token_mat.astype(i32)),
                        jnp.asarray(eng.pos.astype(i32)),
                        jnp.asarray(n_valid.astype(i32)))
    want = np.asarray(want)
    for s in range(3):
        lanes = slice(0, n_valid[s])
        np.testing.assert_allclose(wide[s, lanes], single[s, lanes],
                                   rtol=0, atol=PROB_ATOL)
        np.testing.assert_allclose(wide[s, lanes], want[s, lanes],
                                   rtol=0, atol=PROB_ATOL)
    # lane 0 is the next token after the slot's last one: ref's
    assert int(wide[0, 0].argmax()) == ref[0, 1]


# ------------------------------------------------- speculative streams
def test_spec_greedy_streams_match_vanilla_and_jax(net, prompts, ref,
                                                   margin):
    eng = engine(net, n_slots=6, n_blocks=64, speculative=4)
    got = drive(eng, [dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts])
    vanilla = drive(engine(net, n_slots=6, n_blocks=64),
                    [dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts])
    ties = assert_agree(net, prompts, ref, got, margin)
    ties += assert_agree(net, prompts, vanilla, got, margin)
    assert eng.spec_dispatches_total > 0
    assert eng.spec_emitted_total == 6 * (N_TOK - 1)
    assert eng.spec_proposed_by["ngram"] == eng.spec_proposed_total
    print(f"spec vs vanilla and JAX: EPS {margin:.3g}, near-ties {ties}, "
          f"accepted {eng.spec_accepted_total}/{eng.spec_proposed_total}")


def test_staggered_admissions_and_chunk_interleaving(net, prompts, ref,
                                                     margin):
    eng = engine(net, n_slots=4, n_blocks=64, speculative=4,
                 steps_per_dispatch=3)
    adm = eng.admit_many([dict(prompt_ids=prompts[i], n_tokens=N_TOK)
                          for i in range(2)])
    out = {i: [f] for i, (_, f, _) in enumerate(adm)}
    s2r = {s: i for i, (s, _, _) in enumerate(adm)}
    for s, toks in eng.step(speculate=True)[0].items():
        out[s2r[s]].extend(toks)
    for j, (s, f, _) in enumerate(eng.admit_many(
            [dict(prompt_ids=prompts[i], n_tokens=N_TOK) for i in (2, 3)])):
        out[2 + j], s2r[s] = [f], 2 + j
    flip = False
    while eng.active.any():
        flip = not flip
        for s, toks in eng.step(speculate=flip)[0].items():
            out[s2r[s]].extend(toks)
    assert_agree(net, prompts[:4], ref[:4], [out[i] for i in range(4)],
                 margin)


def test_preempt_requeue_under_speculation(net, margin):
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, V, 4) for _ in range(4)]
    want = [generate(net, p[None], N_TOK, temperature=0)[0] for p in ps]
    # 4 growing streams cannot all finish in 8 usable blocks
    srv = GenerationServer(net, n_slots=4, n_blocks=9, block_len=BL,
                           speculative=4, device="cpu")
    srv.warmup(4, N_TOK).start()
    try:
        got = [s.result(timeout=120) for s in
               [srv.generate_async(p, N_TOK) for p in ps]]
    finally:
        srv.stop()
    assert srv.engine.evict_requeue_total > 0
    assert_agree(net, ps, want, got, margin)


def test_spec_depth_capped_by_remaining(net, prompts, ref, margin):
    eng = engine(net, n_slots=1, n_blocks=16, speculative=4)
    adm = eng.admit_many([dict(prompt_ids=prompts[0], n_tokens=2)])
    eng.slots[adm[0][0]].history = [1, 2, 1, 2, 1, 2, 1]   # drafts plenty
    emitted, finished = eng.step()
    assert [len(t) for t in emitted.values()] == [1] and finished
    assert eng.spec_proposed_total == 0          # depth min(k, 1) = 1
    eng = engine(net, n_slots=1, n_blocks=16, speculative=4)
    out = drive(eng, [dict(prompt_ids=prompts[1], n_tokens=3)])
    assert len(out[0]) == 3 and eng.spec_proposed_total <= 1
    assert_agree(net, prompts[1:2], ref[1:2, :3], out, margin)


def test_sampled_slots_keep_their_vanilla_stream(net, prompts, ref, margin):
    alone = drive(engine(net, n_slots=1, n_blocks=16),
                  [dict(prompt_ids=prompts[0], n_tokens=N_TOK,
                        temperature=0.9, rng=71)])[0]
    eng = engine(net, n_slots=3, n_blocks=48, speculative=4)
    got = drive(eng, [dict(prompt_ids=prompts[0], n_tokens=N_TOK,
                           temperature=0.9, rng=71)]
                + [dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts[1:3]])
    assert got[0] == alone
    assert_agree(net, prompts[1:3], ref[1:3], got[1:], margin)


# -------------------------------------------------------------- drafter
def test_drafts_equal_the_jax_drafter(jnet, net, prompts):
    eng = engine(net, n_slots=3, n_blocks=48, speculative=4,
                 spec_draft_layers=1)
    jeng = JaxEngine(jnet, n_slots=3, n_blocks=48, block_len=BL,
                     speculative=4, spec_draft_layers=1)
    reqs = [dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts[:3]]
    assert [f for _, f, _ in eng.admit_many(reqs)] == \
        [f for _, f, _ in jeng.admit_many(reqs)]
    trunc = [(0, 4), (1, 4), (2, 2)]
    eng._grow_block_tables(dict(trunc))
    jeng._grow_block_tables(dict(trunc))
    got, want = eng._run_draft(trunc), np.asarray(jeng._run_draft(trunc))
    for s, d in trunc:
        np.testing.assert_array_equal(got[:d - 1, s], want[:d - 1, s])


def test_drafter_streams_match_vanilla(net, prompts, ref, margin):
    eng = engine(net, n_slots=6, n_blocks=64, speculative=4,
                 spec_draft_layers=1)
    got = drive(eng, [dict(prompt_ids=p, n_tokens=N_TOK) for p in prompts],
                proposers=("truncated",))
    assert eng.spec_proposed_by["truncated"] > 0
    assert eng.spec_proposed_by["ngram"] == 0
    assert eng.spec_draft_dispatches_total > 0
    assert_agree(net, prompts, ref, got, margin)


# --------------------------------------------------- rejection sampling
N_RS, TEMP = 4000, 0.9


def chi2_crit(df: int, q: float = 0.9999) -> float:
    from scipy.stats import chi2
    return float(chi2.ppf(q, df))


def rs_case(top_k=None, top_p=None, draft_rank=2):
    """N_RS rows of one two-lane score: lane 0's probabilities (the
    target after the last token), lane 1's (the bonus lane), a draft of
    the given rank, distinct keys (`PRNGKey(900 + row)`)."""
    rng = np.random.default_rng(13)
    p = rng.dirichlet(np.full(V, 0.4), 2).astype(np.float32)
    probs = torch.as_tensor(np.repeat(p[None], N_RS, 0))
    d = int(np.argsort(-p[0])[draft_rank])
    token_mat = torch.as_tensor(np.tile([3, d], (N_RS, 1)))
    n_acc, final = rejection_sample_drafts(
        probs, token_mat, torch.full((N_RS,), 2),
        np.stack([np.zeros(N_RS, np.int64), np.arange(N_RS) + 900], 1),
        np.zeros(N_RS, np.int64), torch.full((N_RS,), TEMP),
        torch.full((N_RS,), 1.0 if top_p is None else top_p), top_k)
    logits = jnp.log(jnp.clip(jnp.asarray(p[0]), 1e-9, None)) / TEMP
    logits = jax_filter_logits(logits[None], top_k,
                               None if top_p is None else
                               jnp.full((1, 1), top_p))
    q = np.asarray(jax.nn.softmax(logits, axis=-1), np.float64)[0]
    return d, q, n_acc.numpy(), final.numpy()


def test_acceptance_identity():
    d, q, n_acc, final = rs_case()
    rate = float((n_acc >= 1).mean())
    sigma = np.sqrt(q[d] * (1 - q[d]) / N_RS)
    assert abs(rate - q[d]) <= 5 * sigma, (rate, q[d])
    # a rejected draft is never the resample
    assert not ((n_acc == 0) & (final == d)).any()


def test_zero_support_draft_is_always_rejected():
    d, q, n_acc, final = rs_case(top_k=2, draft_rank=4)
    assert q[d] == 0
    assert (n_acc == 0).all()
    assert set(final.tolist()) <= set(np.flatnonzero(q > 0).tolist())


@pytest.mark.parametrize("top_k,top_p", [(None, None), (6, None),
                                         (None, 0.8)])
def test_emitted_marginal_fits_jax_target(top_k, top_p):
    d, q, n_acc, final = rs_case(top_k, top_p)
    first = np.where(n_acc >= 1, d, final)
    expected = q * N_RS
    big = expected >= 5.0
    counts = np.bincount(first, minlength=V).astype(float)
    assert counts[q == 0].sum() == 0
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    df = len(obs) - 1
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert df >= 2 and stat < chi2_crit(df), (stat, df)


def test_sampled_speculation_streams(net, prompts, margin):
    eng = engine(net, n_slots=4, n_blocks=64, speculative=4,
                 spec_sampled=True)
    reqs = [dict(prompt_ids=p, n_tokens=N_TOK, temperature=0.8, rng=i)
            for i, p in enumerate(prompts[:3])]
    reqs.append(dict(prompt_ids=prompts[3], n_tokens=N_TOK))
    got = drive(eng, reqs)
    again = drive(engine(net, n_slots=4, n_blocks=64, speculative=4,
                         spec_sampled=True), reqs)
    assert got == again                             # deterministic
    assert all(len(t) == N_TOK and 0 <= min(t) and max(t) < V for t in got)
    assert eng.spec_proposed_total > 0
    # the greedy slot in the same dispatches keeps the argmax oracle
    assert_agree(net, prompts[3:4],
                 drive(engine(net, n_slots=1, n_blocks=16), [reqs[3]]),
                 got[3:], margin)


# ------------------------------------------------- copy-on-write prefixes
@pytest.fixture(scope="module")
def shared_prefix():
    return np.random.default_rng(21).integers(0, V, 6)     # 6 % BL != 0


def noise_pool(eng, seed=9):
    g = torch.Generator().manual_seed(seed)
    for k, v in eng.pool.kv:
        k.add_(torch.randn(k.shape, generator=g))
        v.add_(torch.randn(v.shape, generator=g))


def private(net, reqs, **kw):
    return drive(engine(net, n_slots=len(reqs), n_blocks=16 * len(reqs)),
                 reqs, **kw)


def test_shared_streams_equal_private(net, shared_prefix, margin):
    rng = np.random.default_rng(31)
    ps = [np.concatenate([shared_prefix, rng.integers(0, V, k)])
          for k in (0, 1, 3, 5)]
    reqs = [dict(prompt_ids=p, n_tokens=N_TOK) for p in ps]
    eng = engine(net, n_slots=4, n_blocks=48)
    noise_pool(eng)
    eng.register_prefix(shared_prefix)
    got = drive(eng, reqs)
    assert_agree(net, ps, private(net, reqs), got, margin)
    assert eng.prefix_hits_total == 4
    assert eng.prefix_tokens_saved_total == 4 * 6
    assert eng.prefix_forks_total == 4     # every hit forks the tail


def test_sampled_shared_streams_equal_private(net, shared_prefix):
    rng = np.random.default_rng(37)
    for p in (np.concatenate([shared_prefix, rng.integers(0, V, 2)]),
              shared_prefix):                       # suffix, exact match
        req = [dict(prompt_ids=p, n_tokens=14, temperature=0.8, rng=19)]
        eng = engine(net, n_slots=1, n_blocks=16)
        eng.register_prefix(shared_prefix)
        assert drive(eng, req) == private(net, req)
        assert eng.prefix_hits_total == 1


def test_fork_at_block_boundary(net, margin):
    rng = np.random.default_rng(33)
    aligned = rng.integers(0, V, 8)                 # 8 % BL == 0
    p = np.concatenate([aligned, rng.integers(0, V, 2)])
    eng = engine(net, n_slots=2, n_blocks=32)
    eng.register_prefix(aligned)
    got = drive(eng, [dict(prompt_ids=p, n_tokens=10)])
    want = generate(net, p[None], 10, temperature=0)
    assert_agree(net, [p], want, got, margin)
    assert eng.prefix_forks_total == 0 and eng.prefix_hits_total == 1


def test_evict_while_shared(net, shared_prefix, margin):
    eng = engine(net, n_slots=2, n_blocks=32)
    key = eng.register_prefix(shared_prefix)
    free0 = eng.pool.free_blocks
    p = np.concatenate([shared_prefix,
                        np.random.default_rng(35).integers(0, V, 3)])
    (slot, _, _), = eng.admit_many([dict(prompt_ids=p, n_tokens=N_TOK)])
    eng.step()
    eng.evict(slot)
    assert eng.pool.free_blocks == free0
    assert all(eng.pool.allocator.refcount(b) == 1
               for b in eng._prefixes[key]["blocks"])
    got = drive(eng, [dict(prompt_ids=p, n_tokens=N_TOK)])
    assert_agree(net, [p], generate(net, p[None], N_TOK, temperature=0),
                 got, margin)


def test_release_prefix_returns_blocks(net, shared_prefix):
    eng = engine(net, n_slots=2, n_blocks=32)
    free0 = eng.pool.free_blocks
    key = eng.register_prefix(shared_prefix)
    assert eng.register_prefix(shared_prefix) == key      # idempotent
    assert eng.pool.free_blocks == free0 - 2 and eng.prefix_pinned_blocks == 2
    (slot, _, _), = eng.admit_many([dict(
        prompt_ids=np.concatenate([shared_prefix, [1, 2]]), n_tokens=4)])
    eng.release_prefix(key)                  # a rider still maps block 0
    assert eng.prefix_pinned_blocks == 0
    assert eng.pool.free_blocks == free0 - len(eng.slots[slot].blocks)
    eng.evict(slot)
    assert eng.pool.free_blocks == free0


def test_preempt_requeue_of_a_cow_slot(net, shared_prefix, margin):
    rng = np.random.default_rng(39)
    ps = [np.concatenate([shared_prefix, rng.integers(0, V, 2)])
          for _ in range(3)]
    want = [generate(net, p[None], N_TOK, temperature=0)[0] for p in ps]
    srv = GenerationServer(net, n_slots=3, n_blocks=11, block_len=BL,
                           device="cpu")
    srv.register_prefix(shared_prefix)
    srv.warmup(8, N_TOK).start()
    try:
        got = [s.result(timeout=120) for s in
               [srv.generate_async(p, N_TOK) for p in ps]]
    finally:
        srv.stop()
    assert srv.engine.evict_requeue_total > 0
    assert srv.engine.prefix_hits_total >= 3
    assert_agree(net, ps, want, got, margin)


def test_budget_check_is_prefix_aware(net, shared_prefix):
    eng = engine(net, n_slots=2, n_blocks=9)
    eng.register_prefix(shared_prefix)
    p = np.concatenate([shared_prefix,
                        np.random.default_rng(41).integers(0, V, 2)])
    eng.check_budget(8, 20, prompt_ids=p)           # rides the prefix
    with pytest.raises(ValueError, match="pinned"):
        eng.check_budget(8, 20)                     # judged by length
    srv = GenerationServer(net, n_slots=2, n_blocks=9, block_len=BL,
                           device="cpu")
    srv.register_prefix(shared_prefix)
    with srv:
        assert len(srv.generate_async(p, 20).result(timeout=120)) == 20


def test_decode_time_fork_safety_net(net):
    eng = engine(net, n_slots=1, n_blocks=24)
    p = np.random.default_rng(43).integers(0, V, 4)
    (slot, _, _), = eng.admit_many([dict(prompt_ids=p, n_tokens=12)])
    eng.step()
    frontier = eng.slots[slot].blocks[int(eng.pos[slot]) // BL]
    eng.pool.allocator.share([frontier])            # a second holder
    forks0 = eng.prefix_forks_total
    eng.step()
    assert eng.prefix_forks_total == forks0 + 1
    assert eng.slots[slot].blocks[-1] != frontier
    assert eng.pool.allocator.refcount(frontier) == 1
    eng.pool.allocator.free([frontier])


def test_register_prefix_capacity_errors(net):
    eng = engine(net, n_slots=1, n_blocks=4)
    with pytest.raises(ValueError, match="pool cannot host"):
        eng.register_prefix(np.zeros(16, np.int64))
    with pytest.raises(ValueError, match="no room to generate"):
        eng.register_prefix(np.zeros(MAXLEN, np.int64))
    assert eng.pool.free_blocks == 3


def test_speculation_over_a_shared_prefix(net, shared_prefix, margin):
    rng = np.random.default_rng(45)
    ps = [np.concatenate([shared_prefix, rng.integers(0, V, k)])
          for k in (0, 2, 4)]
    want = [generate(net, p[None], N_TOK, temperature=0)[0] for p in ps]
    srv = GenerationServer(net, n_slots=3, n_blocks=48, block_len=BL,
                           speculative=4, device="cpu")
    srv.register_prefix(shared_prefix)
    with srv.warmup(10, N_TOK):
        # a registration on the running server rides the control queue
        srv.register_prefix(rng.integers(0, V, 5))
        got = [s.result(timeout=120) for s in
               [srv.generate_async(p, N_TOK) for p in ps]]
    assert_agree(net, ps, want, got, margin)
    assert srv.engine.prefix_hits_total == 3
    assert srv.engine.spec_dispatches_total > 0
    assert len(srv.engine._prefixes) == 2


# ---------------------------------------------------------------- radix
def test_radix_hits_and_evictions_under_pressure(net, margin):
    rng = np.random.default_rng(47)
    stems = [rng.integers(0, V, 8) for _ in range(3)]     # 2 blocks each
    ps = [np.concatenate([stems[i % 3], rng.integers(0, V, 3)])
          for i in range(9)]
    reqs = [dict(prompt_ids=p, n_tokens=10) for p in ps]
    # 2 slots x 5 blocks a stream + the garbage block: the tree must
    # give blocks back for later admissions
    eng = engine(net, n_slots=2, n_blocks=11, prefix_cache="radix")
    got = []
    for i in range(0, len(reqs), 2):
        got += drive(eng, reqs[i:i + 2])
    assert eng.prefix_hits_total > 0 and eng.radix_hit_tokens_total > 0
    assert eng.radix_evictions_total > 0
    assert eng._radix.nodes > 0
    assert_agree(net, ps, private(net, reqs), got, margin)
    eng._radix.clear()
    assert eng.pool.free_blocks == 10


# -------------------------------------------------- server spec policy
def test_auto_disable_and_probe_reenable(net):
    srv = GenerationServer(net, n_slots=2, n_blocks=32, block_len=BL,
                           speculative=4, spec_accept_floor=0.5,
                           spec_probe_every=3, device="cpu")
    eng = srv.engine

    def dispatch(proposed, accepted, emitted):
        eng.spec_dispatches_total += 1
        eng.spec_proposed_total += proposed
        eng.spec_accepted_total += accepted
        eng.spec_emitted_total += emitted
        srv._spec_update()

    assert srv._spec_policy() is True
    for _ in range(12):
        dispatch(3, 0, 1)
    assert srv._spec_disabled
    polls = [srv._spec_policy() for _ in range(6)]
    assert polls.count(True) == 2 and polls.count(False) == 4
    for _ in range(12):
        dispatch(3, 3, 4)
    assert not srv._spec_disabled and srv._spec_policy() is True
    assert GenerationServer(net, n_slots=1, n_blocks=9, block_len=BL,
                            device="cpu")._spec_policy() is None


def test_proposer_arbitration(net):
    srv = GenerationServer(net, n_slots=2, n_blocks=32, block_len=BL,
                           speculative=4, spec_draft_layers=1,
                           spec_accept_floor=0.5, device="cpu")
    eng = srv.engine
    assert srv._spec_proposers() is None
    eng.spec_dispatches_total += 1
    eng.spec_proposed_by["ngram"] += 6
    eng.spec_proposed_total += 6
    eng.spec_emitted_total += 2
    srv._spec_update()
    assert srv._spec_proposers() == ("truncated",)
    eng.spec_dispatches_total += 1
    eng.spec_proposed_by["truncated"] += 6
    eng.spec_proposed_total += 6
    srv._spec_update()
    assert srv._spec_proposers() is None            # both collapsed
