"""The port's sequence-parallel slice against the JAX package: the carry
fold, ring attention (flash and plain), Ulysses, the attention layer
under `sequence_sharding`, and `TransformerLM(sequence_parallel="ring")`
training.

The JAX side runs its real shard_map schedules on the conftest's 8
virtual CPU devices (the Pallas kernels in interpret mode where the
path has them). The port runs on the CPU, where every kernel wrapper
takes its plain version, over a mesh whose devices repeat the CPU.
Inputs come from numpy with a seed.

Tolerances (fp32): the carry state rtol 1e-5, atol 1e-6 (the same
online softmax over one chunk, in other tiles); ring and Ulysses outputs
rtol 2e-4, atol 2e-5 and gradients rtol 5e-4, atol 5e-5 (the JAX
suite's own, `tests/test_parallel_advanced.py`); training as in
`tests/test_torch_port_training.py` (loss per step rtol 1e-5, params
relative Frobenius 1e-4, `attn_bk` by Adam's step bound).
"""

import logging
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention_carry as jax_carry,
)
from deeplearning4j_tpu.nn.conf import InputType
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadAttention as JaxMHA,
)
from deeplearning4j_tpu.parallel import (
    MeshSpec as JaxMeshSpec,
    make_mesh as jax_make_mesh,
    sequence_parallel_attention as jax_ring,
    sequence_sharding as jax_sequence_sharding,
    ulysses_parallel_attention as jax_ulysses,
)
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.nn.layers import attention as port_attention
from deeplearning4j_tpu_torch.nn.layers import (
    MultiHeadAttention,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    current_sequence_mesh,
    make_mesh,
    reference_attention,
    ring_attention,
    sequence_parallel_attention,
    sequence_sharding,
    ulysses_parallel_attention,
)
from deeplearning4j_tpu_torch.parallel import ring as port_ring
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM

STATE_RTOL, STATE_ATOL = 1e-5, 1e-6
OUT_RTOL, OUT_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
ADAM_STEP_MAX = 1e-3 * 0.1 / np.sqrt(1e-3)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qkv(B, T, H, D, seed):
    return [_rand((B, T, H, D), seed + i) for i in range(4)]   # q, k, v, g


def cpu_mesh(P):
    return make_mesh(MeshSpec.of(seq=P), devices=["cpu"] * P)


def _port_vjp(fn, q, k, v, g):
    t = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    o = fn(*t)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [x.grad.numpy() for x in t]


def _jax_vjp(fn, q, k, v, g):
    @jax.jit
    def run(q, k, v, g):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(g)
    o, grads = run(*(jnp.asarray(a) for a in (q, k, v, g)))
    return np.asarray(o), [np.asarray(x) for x in grads]


def _assert_vjp_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=OUT_RTOL, atol=OUT_ATOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# --------------------------------------------------------------- carry fold
@pytest.mark.parametrize("diags,Tq,Tks", [
    ((True, False), 24, (24, 24)),      # the ring's order: own chunk first
    ((False, False), 20, (12, 28)),     # Tq != Tk, ragged tiles in JAX
    ((False, True), 16, (16, 16)),      # a diag fold seeded mid-chain
])
def test_carry_plain_matches_jax_over_two_folds(diags, Tq, Tks):
    B, H, D = 2, 3, 8
    q = _rand((B, Tq, H, D), 0)
    m = np.full((B, H, Tq), -1e30, np.float32)
    l = np.zeros((B, H, Tq), np.float32)
    acc = np.zeros((B, H, Tq, D), np.float32)
    jstate = tuple(jnp.asarray(a) for a in (m, l, acc))
    state = tuple(torch.from_numpy(a.copy()) for a in (m, l, acc))
    tq = torch.from_numpy(q)
    for i, (diag, Tk) in enumerate(zip(diags, Tks)):
        k, v = _rand((B, Tk, H, D), 10 + i), _rand((B, Tk, H, D), 20 + i)
        jstate = jax_carry(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           *jstate, diag=diag, block_q=8, block_k=8,
                           interpret=True)
        out = fa.flash_attention_carry(tq, torch.from_numpy(k),
                                       torch.from_numpy(v), *state,
                                       diag=diag)
        assert all(a is b for a, b in zip(out, state))      # in place
        for got, want in zip(state, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=STATE_RTOL, atol=STATE_ATOL)


def test_carry_finalized_equals_flash_forward():
    """Folding a whole sequence as one diag chunk and finalising gives
    the flash forward's (o, lse)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(2, 19, 2, 16, 30))
    m = torch.full((2, 2, 19), fa.NEG_INF)
    l, acc = torch.zeros(2, 2, 19), torch.zeros(2, 2, 19, 16)
    fa.flash_attention_carry(q, k, v, m, l, acc, diag=True)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    l_safe = l.clamp_min(1e-20)
    torch.testing.assert_close((acc / l_safe[..., None]).transpose(1, 2), o,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m + torch.log(l_safe), lse, rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------- ring and Ulysses
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("P", [2, 4])
def test_flash_ring_matches_jax_forward_and_grads(P, causal):
    q, k, v, g = _qkv(2, 16, 2, 8, 40)
    jmesh = jax_make_mesh(JaxMeshSpec.of(seq=P))
    want = _jax_vjp(lambda *a: jax_ring(*a, jmesh, causal=causal,
                                        use_flash=True), q, k, v, g)
    mesh = cpu_mesh(P)
    got = _port_vjp(lambda *a: sequence_parallel_attention(
        *a, mesh, causal=causal, use_flash=True), q, k, v, g)
    _assert_vjp_close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("P", [2, 4])
def test_plain_ring_matches_jax_xla_ring(P, causal):
    q, k, v, g = _qkv(2, 16, 2, 8, 50)
    jmesh = jax_make_mesh(JaxMeshSpec.of(seq=P))
    want = _jax_vjp(lambda *a: jax_ring(*a, jmesh, causal=causal), q, k, v,
                    g)
    mesh = cpu_mesh(P)
    got = _port_vjp(lambda *a: sequence_parallel_attention(
        *a, mesh, causal=causal, use_flash=False), q, k, v, g)
    _assert_vjp_close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(causal, use_flash):
    q, k, v, g = _qkv(2, 16, 4, 8, 60)
    jmesh = jax_make_mesh(JaxMeshSpec.of(seq=4))
    want = _jax_vjp(lambda *a: jax_ulysses(*a, jmesh, causal=causal,
                                           use_flash=use_flash), q, k, v, g)
    mesh = cpu_mesh(4)
    got = _port_vjp(lambda *a: ulysses_parallel_attention(
        *a, mesh, causal=causal, use_flash=use_flash), q, k, v, g)
    _assert_vjp_close(got, want)


@pytest.mark.parametrize("fn", ["ring_flash", "ring_plain", "ulysses"])
def test_sequence_parallel_matches_reference_attention(fn):
    q, k, v, g = _qkv(1, 24, 4, 8, 70)
    mesh = cpu_mesh(4)
    run = {"ring_flash": lambda *a: sequence_parallel_attention(
               *a, mesh, causal=True, use_flash=True),
           "ring_plain": lambda *a: sequence_parallel_attention(
               *a, mesh, causal=True),
           "ulysses": lambda *a: ulysses_parallel_attention(
               *a, mesh, causal=True)}[fn]
    want = _port_vjp(lambda *a: reference_attention(*a, causal=True),
                     q, k, v, g)
    _assert_vjp_close(_port_vjp(run, q, k, v, g), want)


@pytest.mark.parametrize("causal,calls,diag", [(True, 10, 4),
                                                (False, 16, 0)])
def test_flash_ring_schedule(monkeypatch, causal, calls, diag):
    """A 4-way causal ring folds 10 chunks a forward (4 diagonal, 6 past;
    6 future skipped) and runs the dQ and dK/dV kernels on the same 10
    in the backward; without causal every one of the 16 is visible."""
    seen = {"carry": [], "dq": [], "dkv": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen[name].append(kw["diag"] if "diag" in kw else a[-1])
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(port_ring, "flash_attention_carry",
                        spy("carry", fa.flash_attention_carry))
    monkeypatch.setattr(port_ring, "flash_attention_bwd_dq",
                        spy("dq", fa.flash_attention_bwd_dq))
    monkeypatch.setattr(port_ring, "flash_attention_bwd_dkv",
                        spy("dkv", fa.flash_attention_bwd_dkv))
    q, k, v, g = _qkv(1, 16, 2, 8, 80)
    _port_vjp(lambda *a: ring_attention(*a, ["cpu"] * 4, causal=causal,
                                        use_flash=True), q, k, v, g)
    for name in seen:
        assert len(seen[name]) == calls, name
        assert sum(map(bool, seen[name])) == diag, name


# -------------------------------------------------------------- the layer
def _mha_params():
    layer = JaxMHA(n_in=16, n_out=16, n_heads=4, causal=True,
                   use_flash=False)
    layer.set_n_in(InputType.recurrent(16))
    params = layer.init_params(jax.random.PRNGKey(0))
    x = _rand((2, 16, 16), 90)
    want, _ = layer.forward(params, {}, jnp.asarray(x))
    return ({n: np.asarray(a) for n, a in params.items()}, x,
            np.asarray(want))


def _port_mha(params, sp, use_flash=None):
    mha = MultiHeadAttention(16, 4, causal=True, use_flash=use_flash,
                             sequence_parallel=sp)
    mha.load_jax_params(params)
    return mha


@pytest.mark.parametrize("use_flash", [None, False])
@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_mha_under_sequence_sharding_equals_local_and_jax(sp, use_flash):
    params, x, want = _mha_params()
    local = _port_mha(params, None, use_flash)(torch.from_numpy(x))
    mha = _port_mha(params, sp, use_flash)
    with sequence_sharding(cpu_mesh(4), axis="seq"):
        got = mha(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_RTOL,
                               atol=OUT_ATOL)


def test_mha_without_context_warns_once_and_runs_local(monkeypatch, caplog):
    monkeypatch.setattr(port_attention, "_SP_FALLBACK_WARNED", set())
    params, x, _ = _mha_params()
    local = _port_mha(params, None)(torch.from_numpy(x))
    mha = _port_mha(params, "ring")
    with caplog.at_level(logging.WARNING, logger=port_attention.__name__):
        outs = [mha(torch.from_numpy(x)) for _ in range(3)]
    warned = [r for r in caplog.records if "sequence_parallel" in r.message]
    assert len(warned) == 1
    for o in outs:
        assert torch.equal(o, local)


def test_named_layers_warn_once_each(monkeypatch, caplog):
    """The warning is keyed on the layer's name (its class name when
    unnamed), as in JAX: two named layers warn once each."""
    monkeypatch.setattr(port_attention, "_SP_FALLBACK_WARNED", set())
    params, x, _ = _mha_params()
    layers = []
    for name in ("attn_a", "attn_b"):
        mha = MultiHeadAttention(16, 4, causal=True, sequence_parallel="ring",
                                 name=name)
        mha.load_jax_params(params)
        layers.append(mha)
    with caplog.at_level(logging.WARNING, logger=port_attention.__name__):
        for _ in range(2):
            for mha in layers:
                mha(torch.from_numpy(x))
    warned = [r.getMessage() for r in caplog.records
              if "sequence_parallel" in r.getMessage()]
    assert len(warned) == 2
    assert "attn_a" in warned[0] and "attn_b" in warned[1]


def test_bad_strategy_is_refused_at_construction():
    with pytest.raises(ValueError, match="sequence_parallel"):
        MultiHeadAttention(8, 2, sequence_parallel="ulyses")
    with pytest.raises(ValueError, match="sequence_parallel"):
        TransformerEncoderBlock(8, 2, sequence_parallel="rng")
    with pytest.raises(ValueError, match="sequence_parallel"):
        TransformerLM(16, d_model=8, n_heads=2,
                      sequence_parallel="zigzag").init(device="cpu")


# ------------------------------------------------------------ mesh, context
def test_mesh_spec_and_repeated_device_mesh():
    spec = MeshSpec.of(data=2, seq=4)
    assert spec.names() == ("data", "seq") and spec.shape() == (2, 4)
    assert spec.size() == 8
    assert MeshSpec.from_dict(spec.to_dict()) == spec
    mesh = make_mesh(spec, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "seq": 4}
    assert mesh.axis_names == ("data", "seq")
    assert mesh.axis_devices("seq") == (torch.device("cpu"),) * 4
    assert mesh.axis_devices("data") == (torch.device("cpu"),) * 2
    assert make_mesh({"seq": 2}, devices=["cpu"] * 3).shape == {"seq": 2}
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_devices("model")


def test_sequence_sharding_nests_restores_and_is_thread_local():
    a, b = cpu_mesh(2), cpu_mesh(4)
    assert current_sequence_mesh() is None
    with sequence_sharding(a):
        with sequence_sharding(b, axis="ctx"):
            assert current_sequence_mesh() == (b, "ctx")
            other = []
            t = threading.Thread(
                target=lambda: other.append(current_sequence_mesh()))
            t.start()
            t.join()
            assert other == [None]
        assert current_sequence_mesh() == (a, "seq")
        with pytest.raises(RuntimeError):
            with sequence_sharding(b):
                raise RuntimeError("boom")
        assert current_sequence_mesh() == (a, "seq")
    assert current_sequence_mesh() is None


def test_errors():
    q = torch.zeros(1, 10, 4, 8)
    with pytest.raises(ValueError, match="divide"):
        sequence_parallel_attention(q, q, q, cpu_mesh(4))
    with pytest.raises(ValueError, match="divide"):
        ulysses_parallel_attention(q, q, q, cpu_mesh(4))
    q3 = torch.zeros(1, 8, 3, 8)
    with pytest.raises(ValueError, match="num_heads"):
        ulysses_parallel_attention(q3, q3, q3, cpu_mesh(2))
    with pytest.raises(ValueError, match="needs"):
        make_mesh(MeshSpec.of(seq=torch.cuda.device_count() + 1))
    m, l = torch.full((1, 4, 10), -1e30), torch.zeros(1, 4, 10)
    acc = torch.zeros(1, 4, 10, 8)
    k = torch.zeros(1, 6, 4, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention_carry(q, k, k, m, l, acc, diag=True)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_attention_carry(q, k, k, m.double(), l, acc, diag=False)


# -------------------------------------------------------------- the LM
V, D_MODEL, LAYERS, HEADS, MAXLEN = 64, 32, 2, 4, 32
N, BATCH = 12, 4


def _corpus(seed, n=N):
    seq = np.random.default_rng(seed).integers(0, V, (n, MAXLEN + 1))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


def _jax_lm():
    return JaxLM(vocab_size=V, d_model=D_MODEL, n_layers=LAYERS,
                 n_heads=HEADS, max_len=MAXLEN, sequence_parallel="ring",
                 seed=7).init()


def _port_lm(params, sp="ring"):
    net = TransformerLM(V, d_model=D_MODEL, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN, sequence_parallel=sp).init(
                            device="cpu")
    return from_jax_params(net, params)


def _fit_scores(net, x, y, ctx):
    scores = []
    with ctx:
        for i in range(0, len(x), BATCH):
            net.fit(x[i:i + BATCH], y[i:i + BATCH], batch_size=BATCH,
                    shuffle=False)
            scores.append(float(net.score_value))
    return scores


def test_sp_lm_fit_follows_jax_ring_fit():
    """Three Adam steps of the zoo LM with sequence_parallel="ring" under
    a seq=4 mesh, port (flash ring, plain carry on the CPU) against JAX
    (its CPU default, the XLA ring), from the same params and batches."""
    jnet = _jax_lm()
    net = _port_lm(to_numpy_params(jnet.params))
    x, y = _corpus(1)
    jscores = _fit_scores(jnet, x, y, jax_sequence_sharding(
        jax_make_mesh(JaxMeshSpec.of(seq=4))))
    scores = _fit_scores(net, x, y, sequence_sharding(cpu_mesh(4)))
    np.testing.assert_allclose(scores, jscores, rtol=LOSS_RTOL)
    got, want = to_jax_params(net), to_numpy_params(jnet.params)
    assert set(got) == set(want)
    for lk, lp in want.items():
        for name, w in lp.items():
            diff = got[lk][name] - w
            if name == "attn_bk":
                assert np.abs(diff).max() <= 2 * 3 * ADAM_STEP_MAX, name
                continue
            rel = np.linalg.norm(diff) / np.linalg.norm(w)
            assert rel <= PARAM_RTOL, (lk, name, rel)


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_output_in_and_out_of_context_equals_local(sp):
    """One net: `output()` outside the context (the local path), inside
    it (the SP path) and outside again all match a net without
    sequence_parallel — nothing is cached across the context change."""
    params = to_numpy_params(_jax_lm().params)
    ids = np.random.default_rng(2).integers(0, V, (2, MAXLEN))
    want = _port_lm(params, None).output(ids).numpy()
    net = _port_lm(params, sp)
    before = net.output(ids).numpy()
    with sequence_sharding(cpu_mesh(4)):
        inside = net.output(ids).numpy()
    after = net.output(ids).numpy()
    np.testing.assert_array_equal(before, want)
    np.testing.assert_array_equal(after, want)
    np.testing.assert_allclose(inside, want, rtol=OUT_RTOL, atol=1e-6)


def test_sp_path_never_launches_or_builds_on_cpu(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("build reached from a CPU tensor")
    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(build, "load", no_build)
    K.reset_launches()
    net = _port_lm(to_numpy_params(_jax_lm().params))
    x, y = _corpus(3, n=4)
    with sequence_sharding(cpu_mesh(4)):
        net.fit(x, y, batch_size=4)
    assert np.isfinite(net.score_value)
    assert all(n == 0 for n in K.LAUNCHES.values())


# --------------------------------------------------- on the card (skip here)
@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_carry_kernel_matches_plain(D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for diag, Tq, Tk in ((True, 200, 200), (False, 300, 200)):
        q = torch.from_numpy(_rand((2, Tq, 3, D), 100)).to("cuda", dtype)
        k, v = (torch.from_numpy(_rand((2, Tk, 3, D), s)).to("cuda", dtype)
                for s in (101, 102))
        state = [torch.from_numpy(a).cuda() for a in (
            _rand((2, 3, Tq), 103), np.abs(_rand((2, 3, Tq), 104)) + 1,
            _rand((2, 3, Tq, D), 105))]
        ref = [t.clone() for t in state]
        fa.flash_attention_carry(q, k, v, *state, diag=diag)
        fa.flash_attention_carry_plain(q, k, v, *ref, diag)
        for got, want in zip(state, ref):
            tol = 2e-5 * max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_ring_matches_plain_ring_and_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_mesh(MeshSpec.of(seq=4), devices=["cuda:0"] * 4)
    q, k, v, g = (torch.from_numpy(a).cuda() for a in _qkv(2, 256, 4, 32, 110))
    K.reset_launches()
    o = sequence_parallel_attention(q, k, v, mesh, causal=True,
                                    use_flash=True)
    assert K.LAUNCHES["flash_attention_carry"] == 10
    ref = sequence_parallel_attention(q, k, v, mesh, causal=True)
    torch.testing.assert_close(o, ref, rtol=OUT_RTOL, atol=OUT_ATOL)
