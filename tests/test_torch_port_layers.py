"""The port's layers, container and LM against the JAX package.

Both sides run with the same weights: the JAX net's params converted to
numpy and loaded with `from_jax_params`. Inputs come from numpy with a
seed; the port runs on the CPU (`device="cpu"`), where every kernel
wrapper takes its plain version. Tolerance: fp32 atol 1e-5 on
activations (matmul and reduction order differ between XLA:CPU and
PyTorch), 1e-6 on softmax outputs; greedy token streams exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    filter_logits as jax_filter_logits,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch.nn.layers import (
    LayerNormalization,
    MultiHeadAttention,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    filter_logits,
    generate,
)

V, D, HEADS, LAYERS, MAXLEN = 29, 32, 4, 2, 32
ATOL = 1e-5


def port_lm(params, **kw):
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN, **kw).init(device="cpu")
    return from_jax_params(net, params)


@pytest.fixture(scope="module")
def jnet():
    return JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=7).init()


@pytest.fixture(scope="module")
def params(jnet):
    return to_numpy_params(jnet.params)


@pytest.fixture(scope="module")
def net(params):
    return port_lm(params)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_embedding_and_positional(jnet, net, params):
    ids = np.random.default_rng(0).integers(0, V, (3, 9))
    want, _ = jnet.layers[0].forward(jnet.params["0"], {}, jnp.asarray(ids))
    got = net.layers[0](torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0)
    x = _x((3, 9, D), 1)
    pe_j, pe = jnet.layers[1], net.layers[1]
    want, _ = pe_j.forward({}, {}, jnp.asarray(x))
    np.testing.assert_allclose(pe(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=ATOL)
    for c in (0, 5, MAXLEN - 4, MAXLEN + 3):     # the last clamps
        want, _, _ = pe_j.forward_with_carry({}, {}, jnp.asarray(x[:, :4]),
                                             jnp.asarray(c, jnp.int32))
        got, nc = pe.forward_with_carry(torch.from_numpy(x[:, :4]), c)
        assert nc == c + 4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    positions = np.asarray([0, 7, MAXLEN + 5])
    want, _ = pe_j.forward_at_positions({}, {}, jnp.asarray(x[:, :1]),
                                        jnp.asarray(positions))
    got = pe.forward_at_positions(torch.from_numpy(x[:, :1]),
                                  torch.as_tensor(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_normalization_layer(jnet):
    from deeplearning4j_tpu.nn.layers.normalization import (
        LayerNormalization as JLN,
    )
    x = _x((4, 6, D), 2) * 3
    g, b = _x((D,), 3), _x((D,), 4)
    want, _ = JLN(n_out=D).forward({"gamma": jnp.asarray(g),
                                    "beta": jnp.asarray(b)}, {},
                                   jnp.asarray(x))
    ln = LayerNormalization(D)
    ln.load_jax_params({"gamma": g, "beta": b})
    np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=ATOL)


def _mha_pair(jnet, use_flash):
    blk_j = jnet.layers[2]
    p = blk_j._sub(jnet.params["2"], "attn")
    mha = MultiHeadAttention(D, HEADS, causal=True, use_flash=use_flash)
    mha.load_jax_params({k: np.asarray(v) for k, v in p.items()})
    return blk_j._mha, p, mha


@pytest.mark.parametrize("use_flash", [None, False])
def test_mha_forward_plain_and_flash(jnet, use_flash):
    jm, p, mha = _mha_pair(jnet, use_flash)
    x = _x((2, 13, D), 5)
    want, _ = jm.forward(p, {}, jnp.asarray(x))
    np.testing.assert_allclose(mha(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=ATOL)


def test_mha_forward_with_cache_and_clamped_write(jnet):
    jm, p, mha = _mha_pair(jnet, None)
    L, Dh = 8, D // HEADS
    kc = np.zeros((2, L, HEADS, Dh), np.float32)
    vc = np.zeros_like(kc)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pos = 0
    for T in (3, 4, 1, 2):          # the last write starts past L - T
        x = _x((2, T, D), 10 + T)
        want, jk, jv = jm.forward_with_cache(p, jnp.asarray(x), jk, jv,
                                             jnp.asarray(pos, jnp.int32))
        got, tk, tv = mha.forward_with_cache(torch.from_numpy(x), tk, tv, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        pos += T


def test_block_forward_carry_and_paged(jnet, net):
    blk_j, blk = jnet.layers[2], net.layers[2]
    p = jnet.params["2"]
    x = _x((2, 11, D), 20)
    want, _ = blk_j.forward(p, {}, jnp.asarray(x))
    np.testing.assert_allclose(blk(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=ATOL)
    # carry path: prefill 5 then 3 single tokens
    jc = blk_j.init_carry(2, jnp.float32)
    tc = blk.init_carry(2, torch.float32, torch.device("cpu"))
    for lo, hi in ((0, 5), (5, 6), (6, 7), (7, 8)):
        want, _, jc = blk_j.forward_with_carry(p, {}, jnp.asarray(x[:, lo:hi]),
                                               jc)
        got, tc = blk.forward_with_carry(torch.from_numpy(x[:, lo:hi]), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # paged path over non-contiguous blocks with garbage everywhere else
    bl = 4
    rng = np.random.default_rng(21)
    pool = rng.standard_normal((12, bl, HEADS, D // HEADS)).astype(np.float32)
    jk, jv = jnp.asarray(pool), jnp.asarray(pool * 0.5)
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool * 0.5)
    table = np.asarray([[3, 5, 7, 9, 1, 2, 4, 6], [2, 4, 6, 8, 1, 3, 5, 7]])
    pos = np.asarray([0, 3])
    for step in range(6):
        xs = _x((2, 1, D), 30 + step)
        want, jk, jv = blk_j.forward_paged(p, jnp.asarray(xs), jk, jv,
                                           jnp.asarray(table),
                                           jnp.asarray(pos))
        got = blk.forward_paged(torch.from_numpy(xs), tk, tv,
                                torch.as_tensor(table), torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        pos = pos + 1


def test_output_layer_and_full_output(jnet, net):
    ids = np.random.default_rng(40).integers(0, V, (3, 20))
    want = np.asarray(jnet.output(ids))
    got = net.output(ids).numpy()
    assert got.shape == (3, 20, V)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_generate_greedy_token_equal(jnet, net):
    prompts = np.random.default_rng(41).integers(0, V, (4, 5))
    want = jax_generate(jnet, prompts, 12, temperature=0)
    np.testing.assert_array_equal(generate(net, prompts, 12, temperature=0),
                                  want)


def test_generate_sampled_deterministic_and_in_vocab(net):
    prompts = np.random.default_rng(42).integers(0, V, (2, 4))
    a = generate(net, prompts, 10, temperature=0.8, top_p=0.9, rng=5)
    b = generate(net, prompts, 10, temperature=0.8, top_p=0.9, rng=5)
    c = generate(net, prompts, 10, temperature=0.8, top_p=0.9, rng=6)
    assert a.shape == (2, 10) and (a >= 0).all() and (a < V).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (3, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = _x((4, V), 43) * 2
    want = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p))
    got = filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)])


def test_budget_and_ids_validated(net):
    with pytest.raises(ValueError, match="budget"):
        generate(net, np.zeros((1, 30), np.int64), 5, temperature=0)
    with pytest.raises(ValueError, match="token ids"):
        generate(net, np.full((1, 3), V), 2, temperature=0)


def test_default_device_is_cuda_and_raises_without_it(params):
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    lm = TransformerLM(V, d_model=D, n_layers=1, n_heads=HEADS,
                       max_len=MAXLEN)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init()
    cpu_net = lm.init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cpu_net.to("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeEngine(port_lm(params), n_slots=1, n_blocks=4, block_len=8)


def test_from_jax_params_rejects_mismatch(params):
    bad = {k: dict(v) for k, v in params.items()}
    bad["0"]["W"] = bad["0"]["W"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        port_lm(bad)
    missing = {k: v for k, v in params.items() if k != "3"}
    with pytest.raises(KeyError, match="layer 3"):
        port_lm(missing)
