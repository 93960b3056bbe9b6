"""`mixed_bf16` in the port (`nd/dtype.py`, `nn/multilayer.py`) against
the JAX package's policy (`deeplearning4j_tpu/nd/dtype.py`, mirrored
after `tests/test_dtype_policy.py`): the policy seams and resolution,
the structure of a mixed step (bf16 gradients onto an fp32 master,
fp32 loss and `output()`, the output layer's params rounded to bf16 and
upcast, token ids uncast), the refusals, and the tiny TransformerLM
trained mixed, port (CPU) against JAX (CPU).

Tolerances: LayerNorm's bf16 backward (dx, dγ, dβ, plain and residual)
within one bf16 ulp of the largest |value| of JAX's custom_vjp (both
reduce in fp32 and round once; the sums run in another order). Step
0's loss within 1e-2 relative of JAX's (both compute
in bf16, with GEMM and softmax sums in another order: JAX's CPU path
runs XLA attention and XLA LayerNorm, the port's the plain versions of
its kernels); every step's loss within 5% of the initial loss of JAX's
mixed run and of the port's own fp32 run (the JAX package's documented
band, `tests/test_dtype_policy.py:170-186`, `docs/PRECISION.md`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.layernorm import (
    layer_norm as jax_ln,
    residual_layer_norm as jax_res_ln,
)
from deeplearning4j_tpu.nd import dtype as jdt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize.listeners import TrainingListener
from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.kernels.layernorm import (
    layer_norm,
    residual_layer_norm,
)
from deeplearning4j_tpu_torch.nd import dtype as dt
from deeplearning4j_tpu_torch.nn.layers import EmbeddingLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    make_mesh,
    sequence_sharding,
)
from deeplearning4j_tpu_torch.serving import (
    GenerationServer,
    PagedDecodeEngine,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

V, D, LAYERS, HEADS, MAXLEN, B, STEPS = 64, 32, 2, 2, 17, 2, 4
STEP0_RTOL, BAND = 1e-2, 0.05


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def corpus(seed, n=B * STEPS):
    seq = np.random.default_rng(seed).integers(0, V, (n, MAXLEN))
    return (seq[:, :-1].astype(np.float32),
            np.eye(V, dtype=np.float32)[seq[:, 1:]])


@pytest.fixture(scope="module")
def jax_params():
    net = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                max_len=MAXLEN, seed=5).init()
    return to_numpy_params(net.params)


def port_lm(params, policy="mixed_bf16", **kw):
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN, **kw).init(device="cpu",
                                                   dtype_policy=policy)
    return from_jax_params(net, params)


def fit_steps(net, x, y):
    losses = []
    for i in range(0, len(x), B):
        net.fit(x[i:i + B], y[i:i + B], batch_size=B, shuffle=False)
        losses.append(net.score_value)
    return losses


# ---------------------------------------------------------- policy seams
def test_presets_names_and_serde_match_jax():
    p = dt.mixed_bf16()
    assert p.is_mixed and p.name == "mixed_bf16" == jdt.mixed_bf16().name
    assert p.compute_dtype == torch.bfloat16
    assert p.param_dtype == p.output_dtype == torch.float32
    assert not dt.DataTypePolicy().is_mixed
    assert dt.DataTypePolicy().name == "float32"
    assert dt.policy_from_name("bf16") == p == dt.bf16_policy()
    assert dt.DataTypePolicy(compute_dtype="float16").name == "custom"
    with pytest.raises(ValueError):
        dt.policy_from_name("fp8")
    for mine, ref in ((p, jdt.mixed_bf16()),
                      (dt.DataTypePolicy(), jdt.DataTypePolicy())):
        assert mine.to_dict() == ref.to_dict()
        assert dt.DataTypePolicy.from_dict(ref.to_dict()) == mine
        assert dt.as_policy(ref.to_dict()) == mine
    with pytest.raises(TypeError):
        dt.as_policy(3)


def test_casts():
    p = dt.mixed_bf16()
    ids = torch.tensor([300, 301])
    assert p.cast_compute(ids) is ids                 # ids pass uncast
    assert p.cast_compute(torch.ones(2)).dtype == torch.bfloat16
    assert p.cast_output(torch.ones(2, dtype=torch.bfloat16)).dtype == (
        torch.float32)
    tree = {"a": torch.ones(2), "b": [torch.ones(1), ids]}
    assert dt.DataTypePolicy().cast_params(tree) is tree
    cast = p.cast_params(tree)
    assert cast["a"].dtype == cast["b"][0].dtype == torch.bfloat16
    assert cast["b"][1] is ids
    back = p.cast_output_params(cast)
    assert back["a"].dtype == torch.float32
    assert dt.DataTypePolicy().cast_output_params(cast) is cast


def test_process_default_setters():
    try:
        assert dt.get_default_policy() == dt.DataTypePolicy()
        dt.set_default_dtype(compute_dtype=torch.bfloat16)
        assert dt.get_default_policy().is_mixed
        assert dt.get_default_dtype() == torch.float32
        assert not dt.set_default_dtype(reset=True).is_mixed
        dt.set_default_policy(dt.mixed_bf16())
        assert dt.default_policy().is_mixed
    finally:
        dt.set_default_policy(None)
    assert dt.get_default_policy() == dt.DataTypePolicy()


def test_resolution_env_beats_arg_beats_default(monkeypatch, jax_params):
    def net(policy=None):
        return port_lm(jax_params, policy).dtype
    assert not net().is_mixed                          # factory default
    assert net("mixed_bf16").is_mixed                  # explicit arg
    try:
        dt.set_default_policy(dt.mixed_bf16())         # process default
        assert net().is_mixed
        assert not net("float32").is_mixed             # arg beats it
    finally:
        dt.set_default_policy(None)
    monkeypatch.setenv("DL4J_DTYPE_POLICY", "mixed_bf16")
    assert net("float32").is_mixed                     # env beats arg
    monkeypatch.setenv("DL4J_DTYPE_POLICY", "0")
    assert not net("mixed_bf16").is_mixed
    monkeypatch.setenv("DL4J_DTYPE_POLICY", "on")
    assert net().is_mixed
    monkeypatch.setenv("DL4J_DTYPE_POLICY", "float999")
    with pytest.raises(ValueError):
        net()
    monkeypatch.delenv("DL4J_DTYPE_POLICY")
    # the JAX package resolves the same way from the same variable
    monkeypatch.setenv("DL4J_DTYPE_POLICY", "mixed_bf16")
    assert jdt.resolve_policy("float32").is_mixed
    assert dt.resolve_policy("float32").is_mixed


def test_policies_the_port_does_not_run_are_refused(jax_params):
    for bad in (dt.DataTypePolicy(param_dtype=torch.bfloat16,
                                  compute_dtype=torch.bfloat16),
                dt.DataTypePolicy(compute_dtype=torch.float16),
                dt.DataTypePolicy(compute_dtype=torch.bfloat16,
                                  output_dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_lm(jax_params, bad)


# ------------------------------------------------------ a mixed step
def test_grads_are_bf16_and_master_and_state_stay_fp32(jax_params):
    net = port_lm(jax_params)
    x, y = corpus(1)
    seen, orig = [], net._apply_updates

    def spy(step, grads=None):
        seen.append({g.dtype for g in grads.values()})
        return orig(step, grads)
    net._apply_updates = spy
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    fit_steps(net, x[:2 * B], y[:2 * B])
    assert seen == [{torch.bfloat16}] * 2
    for n, p in net.named_parameters():
        assert p.dtype == torch.float32 and not p.requires_grad
        # every param moved (attn.bk's gradient is rounding noise: exempt)
        assert not torch.equal(p, before[n]) or n.endswith("attn.bk"), n
    for lstate in net.updater_state.values():
        for st in lstate.values():
            assert {t.dtype for t in st.values()} == {torch.float32}


def test_output_layer_uses_its_params_rounded_to_bf16_then_fp32(jax_params):
    net = port_lm(jax_params)
    out = net.layers[-1]
    W = out.W.detach().clone()
    seen, orig = {}, out.compute_loss

    def spy(h, labels, mask=None):
        seen.update(W=out.W.detach().clone(), b=out.b.detach().clone(),
                    h=h.dtype, y=labels.dtype)
        loss = orig(h, labels, mask)
        seen["loss"] = loss.dtype
        return loss
    out.compute_loss = spy
    x, y = corpus(2, n=B)
    net.fit(x, y, batch_size=B, shuffle=False)
    assert seen["W"].dtype == torch.float32
    assert torch.equal(seen["W"], W.bfloat16().float())
    assert not torch.equal(seen["W"], W)               # not the master
    assert seen["h"] == seen["y"] == seen["loss"] == torch.float32
    assert isinstance(net.score_value, float)


def test_output_and_score_are_fp32(jax_params):
    net = port_lm(jax_params)
    x, y = corpus(3, n=B)
    probs = net.output(x.astype(np.int64))
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-2)
    ref = port_lm(jax_params, "float32").output(x.astype(np.int64))
    # bf16 compute: within bf16's resolution of the fp32 probabilities
    assert float((probs - ref).abs().max()) < 2e-2
    s = net.score(DataSet(x, y))
    assert np.isfinite(s) and abs(s - port_lm(jax_params, "float32").score(
        DataSet(x, y))) < BAND * s


def test_float_carried_token_ids_above_256_survive():
    layers = [EmbeddingLayer(512, 8), RnnOutputLayer(8, 4)]
    gen = torch.Generator().manual_seed(0)
    for layer in layers:
        layer.init_weights(gen)
    net = MultiLayerNetwork(layers, device="cpu", dtype_policy="mixed_bf16")
    ids = np.asarray([[300, 301], [511, 2]], np.float32)
    assert torch.equal(net._features(ids),
                       torch.tensor([[300, 301], [511, 2]]))
    out = net.output(ids).numpy()
    # a bf16 round would collapse 300 and 301 onto one row
    assert not np.allclose(out[0, 0], out[0, 1])
    net.fit(ids, np.eye(4, dtype=np.float32)[[[0, 1], [2, 3]]], batch_size=2)
    assert np.isfinite(net.score_value)


# ------------------------------------------- LayerNorm's bf16 backward
def _bf16_close(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_bf16_backward_matches_jax(residual):
    """The bf16 forward and the analytic backward from fp32 statistics
    against JAX's Pallas kernel (interpret mode) and its custom_vjp
    (`deeplearning4j_tpu/kernels/layernorm.py:123-191`)."""
    rng = np.random.default_rng(8)
    x, h, gy, gs = (rng.standard_normal((6, 40)).astype(np.float32)
                    for _ in range(4))
    g = (1 + 0.2 * rng.standard_normal(40)).astype(np.float32)
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, h, g, b, gy, gs)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, h, g, b, gy,
                                                           gs)]
    if residual:
        (s_w, y_w), vjp = jax.vjp(
            lambda x_, h_, g_, b_: jax_res_ln(x_, h_, g_, b_, 1e-5, 8, True),
            *jb[:4])
        want = vjp((jb[5], jb[4]))
        leaves = [t.clone().requires_grad_() for t in tb[:4]]
        s_, y = residual_layer_norm(*leaves)
        torch.autograd.backward([s_, y], [tb[5], tb[4]])
        _bf16_close(s_.detach(), s_w)
    else:
        y_w, vjp = jax.vjp(
            lambda x_, g_, b_: jax_ln(x_, g_, b_, 1e-5, 8, True),
            jb[0], jb[2], jb[3])
        want = vjp(jb[4])
        leaves = [tb[0].clone().requires_grad_(),
                  tb[2].clone().requires_grad_(),
                  tb[3].clone().requires_grad_()]
        y = layer_norm(*leaves)
        y.backward(tb[4])
    _bf16_close(y.detach(), y_w)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        _bf16_close(leaf.grad, w)


# ----------------------------------------------------------- refusals
def test_generate_refuses_a_mixed_policy(jax_params):
    net = port_lm(jax_params)
    with pytest.raises(NotImplementedError, match="mixed_bf16"):
        generate(net, np.zeros((1, 3), np.int64), 2, temperature=0)


def test_serving_refuses_a_mixed_policy(jax_params):
    net = port_lm(jax_params)
    with pytest.raises(NotImplementedError, match="mixed_bf16"):
        PagedDecodeEngine(net, n_slots=2, n_blocks=9, block_len=4,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="mixed_bf16"):
        GenerationServer(net, n_slots=2, n_blocks=9, block_len=4,
                         device="cpu")


@pytest.mark.parametrize("sp", ["ring", "ulysses"])
def test_sequence_parallel_refuses_a_mixed_policy(jax_params, sp):
    net = port_lm(jax_params, sequence_parallel=sp)
    x, y = corpus(4, n=B)
    mesh = make_mesh(MeshSpec.of(seq=2), devices=["cpu"] * 2)
    with sequence_sharding(mesh):
        with pytest.raises(NotImplementedError, match="Ulysses"):
            net.fit(x, y, batch_size=B)
        with pytest.raises(NotImplementedError, match="Ulysses"):
            net.output(x.astype(np.int64))
    # outside a mesh context the layers run local attention, mixed
    net.fit(x, y, batch_size=B)
    assert np.isfinite(net.score_value)


# ------------------------------------------------- mixed against JAX
class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score, **info):
        self.scores.append(score)


def test_mixed_training_follows_jax_and_its_own_fp32_within_the_band():
    conf = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=5).conf()
    jnet = JaxNet(conf, dtype_policy="mixed_bf16").init(5)
    assert jnet.dtype.is_mixed
    params = to_numpy_params(jnet.params)
    x, y = corpus(5)
    rec = _Scores()
    jnet.set_listeners(rec)
    jnet.fit(x, y, epochs=1, batch_size=B, shuffle=False)
    mixed = fit_steps(port_lm(params), x, y)
    fp32 = fit_steps(port_lm(params, "float32"), x, y)
    jax_mixed = rec.scores
    assert len(mixed) == len(jax_mixed) == STEPS
    assert abs(mixed[0] - jax_mixed[0]) <= STEP0_RTOL * jax_mixed[0]
    for m, j, f in zip(mixed, jax_mixed, fp32):
        assert abs(m - j) <= BAND * jax_mixed[0], (mixed, jax_mixed)
        assert abs(m - f) <= BAND * fp32[0], (mixed, fp32)
