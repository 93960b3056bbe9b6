"""Int8 weight-only serving in the port (`nd/quant.py`, the layers'
quantization seams, `generate(quantize=)`, the engine and server)
against the JAX package's `nd/quant.py` and `generate(quantize="int8")`.

Contracts and tolerances:
- `quantize` is bit-equal to JAX's (`q` and `scale`), an all-zero
  channel included (`torch.round` and `jnp.round` both round half to
  even); the key plan and the weight bytes are equal.
- Probabilities by teacher forcing (the same tokens fed to both sides,
  through the cached decode path): int8 port against int8 JAX within
  PROB_ATOL = 1e-5 (fp32 on the CPU).
- Greedy streams by margin (`zoo.transformer.stream_agreement`): equal
  at every position where JAX's top-1/top-2 gap exceeds the largest
  probability difference measured in the test; the near-ties are
  counted and printed.
- The cached int8 tree is rebuilt after `fit()` (the params version).

Net: the JAX zoo LM at d32 / 2 blocks, its output head scaled by 8 in
the params both sides load, so greedy logits are decisive.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nd import quant as jquant
from deeplearning4j_tpu.nn.layers.recurrent import BaseRecurrentLayer
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.serving import (
    GenerationServer,
    PagedDecodeEngine,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    generate,
    stream_agreement,
    teacher_forced_probs,
)

V, D, HEADS, LAYERS, MAXLEN, BL = 61, 32, 4, 2, 40, 4
HEAD_SCALE = 8.0
PROB_ATOL = 1e-5
N_TOK = 12


@pytest.fixture(scope="module")
def jnet():
    net = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                max_len=MAXLEN, seed=7).init()
    out = str(len(net.layers) - 1)
    net.params = {**net.params,
                  out: {**net.params[out],
                        "W": net.params[out]["W"] * HEAD_SCALE}}
    return net


def port_net(jnet):
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN).init(device="cpu")
    return from_jax_params(net, to_numpy_params(jnet.params))


@pytest.fixture(scope="module")
def net(jnet):
    return port_net(jnet)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(17).integers(0, V, (4, 6))


@pytest.fixture(scope="module")
def jax_int8(jnet, prompts):
    """JAX's int8 greedy tokens and their teacher-forced probabilities."""
    toks = np.asarray(jax_generate(jnet, prompts, N_TOK, temperature=0,
                                   quantize="int8"))
    params = jquant.serving_params(jnet, "int8")
    probs = []
    for p, t in zip(prompts, toks):
        seq = np.concatenate([p, t[:-1]])[None]
        carries = {str(i): layer.init_carry(1, jnet.dtype.compute_dtype)
                   for i, layer in enumerate(jnet.layers)
                   if isinstance(layer, BaseRecurrentLayer)}
        h = jnet._forward_core(params, jnet.net_state, seq, train=False,
                               rng=None, carries=carries)[0]
        probs.append(np.asarray(h[0, len(p) - 1:], np.float64))
    return toks, probs


def drive_engine(eng, prompts, n_tok):
    admitted = eng.admit_many([dict(prompt_ids=p, n_tokens=n_tok)
                               for p in prompts])
    assert len(admitted) == len(prompts)
    out = {s: [f] for s, f, _ in admitted}
    while eng.active.any():
        for s, toks in eng.step()[0].items():
            out[s].extend(toks)
    return np.asarray([out[s] for s, _, _ in admitted])


# ------------------------------------------------------------ quantize
@pytest.mark.parametrize("shape", [(32, 48), (5, 7, 9), (64, 61)])
def test_quantize_is_bit_equal_to_jax(shape):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[..., 2] = 0.0                            # an all-zero channel
    # scale exactly 1: w / scale lands on .5, where rounding goes to even
    halves = np.asarray([127.0, 2.5, 3.5, -0.5, -126.5], np.float32)
    w[..., 3] = np.resize(halves, w[..., 3].shape)
    got, want = quant.quantize(torch.from_numpy(w)), jquant.quantize(w)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.scale.shape) == tuple(want.scale.shape)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert float(got.scale[..., 2].max()) == np.float32(1.0) / 127
    np.testing.assert_allclose(
        quant.dequantize(got).numpy(), np.asarray(jquant.dequantize(want)),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="matmul weight"):
        quant.quantize(torch.zeros(4))


def test_matmul_scales_after_the_product():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    got = quant.matmul(torch.from_numpy(x), quant.quantize(torch.from_numpy(w)))
    want = jquant.matmul(x, jquant.quantize(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_key_plan_and_weight_bytes_equal_jax(jnet, net):
    assert quant.quantized_weight_keys(net) == \
        jquant.quantized_weight_keys(jnet)
    qtree = quant.quantize_net_params(net)
    jtree = jquant.quantize_net_params(jnet)
    assert quant.weight_bytes(qtree) == jquant.weight_bytes(jtree)
    assert quant.weight_bytes(quant.serving_params(net, None).params) == \
        jquant.weight_bytes(jnet.params)
    for lk, keys in jquant.quantized_weight_keys(jnet).items():
        for k in keys:
            np.testing.assert_array_equal(qtree[lk][k].q.numpy(),
                                          np.asarray(jtree[lk][k].q))
    with pytest.raises(ValueError, match="quantization mode"):
        quant.quantize_net_params(net, "int4")


def test_int8_tree_rebuilds_after_fit(jnet):
    net = port_net(jnet)
    before = quant.serving_params(net, "int8")
    assert quant.serving_params(net, "int8") is before      # cached
    v0 = net.params_version
    seq = np.random.default_rng(5).integers(0, V, (2, 9))
    net.fit(seq[:, :-1].astype(np.float32), np.eye(V)[seq[:, 1:]],
            batch_size=2)
    assert net.params_version > v0
    after = quant.serving_params(net, "int8")
    assert after is not before
    w = net.layers[2].attn.Wq
    np.testing.assert_array_equal(after.params["2"]["attn_Wq"].q.numpy(),
                                  quant.quantize(w).q.numpy())
    assert not torch.equal(after.params["2"]["attn_Wq"].scale,
                           before.params["2"]["attn_Wq"].scale)


# ------------------------------------------------------------- decoding
def test_int8_generate_matches_jax_by_margin(jnet, net, prompts, jax_int8):
    want, jprobs = jax_int8
    got = generate(net, prompts, N_TOK, temperature=0, quantize="int8")
    eps = 0.0
    for p, t, jp in zip(prompts, want, jprobs):
        pp = teacher_forced_probs(net, p, t, quantize="int8")
        eps = max(eps, float(np.abs(pp - jp).max()))
    assert eps <= PROB_ATOL, eps
    ties = 0
    for t, g, jp in zip(want, got, jprobs):
        r = stream_agreement(t, g, jp, eps)
        assert r["ok"], r
        ties += r["near_ties"]
    print(f"int8 generate vs JAX: max prob diff {eps:.3g}, near-ties "
          f"{ties}")
    # the int8 path moves the numbers: fp32 and int8 differ
    fp = teacher_forced_probs(net, prompts[0], want[0])
    q8 = teacher_forced_probs(net, prompts[0], want[0], quantize="int8")
    assert 0 < np.abs(fp - q8).max() < 0.1


def test_int8_engine_and_server_match_int8_generate(jnet, net, prompts,
                                                    jax_int8):
    want, jprobs = jax_int8
    ref = generate(net, prompts, N_TOK, temperature=0, quantize="int8")
    eps = max(float(np.abs(teacher_forced_probs(
        net, p, t, quantize="int8") - jp).max())
        for p, t, jp in zip(prompts, want, jprobs))
    eng = PagedDecodeEngine(net, n_slots=4, n_blocks=48, block_len=BL,
                            quantize="int8", device="cpu")
    got = drive_engine(eng, prompts, N_TOK)
    with GenerationServer(net, n_slots=2, n_blocks=12, block_len=BL,
                          quantize="int8", device="cpu") as srv:
        streams = [srv.generate_async(p, N_TOK) for p in prompts]
        served = [s.result(timeout=60) for s in streams]
    for i, p in enumerate(prompts):
        rp = teacher_forced_probs(net, p, ref[i], quantize="int8")
        for stream in (got[i], served[i]):
            r = stream_agreement(ref[i], stream, rp, eps)
            assert r["ok"], r
    # the params were never touched, and the fp32 path still serves them
    assert not any(isinstance(t, quant.QuantizedTensor)
                   for t in net.parameters())
