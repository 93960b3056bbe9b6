"""`mixed_bf16` decoding in the port — `generate()`, the paged engine
and the server on the compute-dtype serving tree — against the JAX
package's mixed decoding.

Contracts and tolerances:
- Probabilities by teacher forcing (the same tokens through the cached
  decode path on both sides): port mixed against JAX mixed within
  MIXED_PROB_ATOL = 2^-5 absolute. Both compute in bf16 with fp32
  LayerNorm statistics and round the softmax to bf16; their GEMM and
  softmax sums run in another order, so a logit can differ by a bf16 ulp
  and a probability by about p(1-p) times that, which grows with the
  logits (measured 0.0117 here, printed by the first test). The
  JAX-written small LM (trained 3 steps) has logits in [32, 64), where a
  bf16 ulp is 0.25: ZIP_PROB_ATOL = 2^-3 there (measured 0.068,
  printed by the last test).
- Greedy streams by margin (`zoo.transformer.stream_agreement`) with
  the difference measured in the same module; near-ties are counted.
- The KV pool is bf16 (half the fp32 pool's bytes), the serving tree is
  cast once per params version and rebuilt after `fit()`, and a mixed
  zip restored from the JAX-written fixture serves.

Net: the JAX zoo LM at d32 / 2 blocks built under `mixed_bf16`, its
output head scaled by 2 in the params both sides load.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.recurrent import BaseRecurrentLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.util.serializer import (
    ModelSerializer as JaxSerializer,
)
from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    generate as jax_generate,
)
from deeplearning4j_tpu_torch import kernels as K
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.serving import (
    GenerationServer,
    PagedDecodeEngine,
)
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    generate,
    stream_agreement,
    teacher_forced_probs,
)

V, D, HEADS, LAYERS, MAXLEN, BL = 61, 32, 4, 2, 40, 4
HEAD_SCALE = 2.0
MIXED_PROB_ATOL = 2.0 ** -5
ZIP_PROB_ATOL = 2.0 ** -3
N_TOK = 12
BRIDGE = "tests/fixtures/bridge"


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


def jax_probs(jnet, prompt, tokens):
    """JAX's cached-decode probabilities at the positions predicting
    `tokens` (the port's `teacher_forced_probs`), in fp32."""
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    carries = {str(i): layer.init_carry(1, jnet.dtype.compute_dtype)
               for i, layer in enumerate(jnet.layers)
               if isinstance(layer, BaseRecurrentLayer)}
    h = jnet._forward_core(jnet.params, jnet.net_state, seq, train=False,
                           rng=None, carries=carries)[0]
    return np.asarray(h[0, len(prompt) - 1:].astype(np.float32), np.float64)


@pytest.fixture(scope="module")
def jnet():
    conf = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=7).conf()
    net = JaxNet(conf, dtype_policy="mixed_bf16").init(7)
    out = str(len(net.layers) - 1)
    net.params = {**net.params,
                  out: {**net.params[out],
                        "W": net.params[out]["W"] * HEAD_SCALE}}
    return net


def port_net(jnet, policy="mixed_bf16"):
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN).init(device="cpu",
                                             dtype_policy=policy)
    return from_jax_params(net, to_numpy_params(jnet.params))


@pytest.fixture(scope="module")
def net(jnet):
    return port_net(jnet)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(17).integers(0, V, (4, 6))


@pytest.fixture(scope="module")
def jax_mixed(jnet, net, prompts):
    """JAX's mixed greedy tokens, its teacher-forced probabilities and
    the largest difference from the port's on the same tokens."""
    toks = np.asarray(jax_generate(jnet, prompts, N_TOK, temperature=0))
    probs = [jax_probs(jnet, p, t) for p, t in zip(prompts, toks)]
    eps = max(float(np.abs(teacher_forced_probs(net, p, t) - jp).max())
              for p, t, jp in zip(prompts, toks, probs))
    return toks, probs, eps


def agree(ref, got, ref_probs, eps):
    ties = 0
    for r, g, rp in zip(ref, got, ref_probs):
        out = stream_agreement(r, g, rp, eps)
        assert out["ok"], out
        ties += out["near_ties"]
    return ties


def test_mixed_generate_matches_jax(net, prompts, jax_mixed):
    toks, probs, eps = jax_mixed
    assert net.dtype.name == "mixed_bf16"
    assert 0 < eps <= MIXED_PROB_ATOL, eps
    got = generate(net, prompts, N_TOK, temperature=0)
    ties = agree(toks, got, probs, eps)
    print(f"mixed generate vs JAX: max prob diff {eps:.4g}, near-ties "
          f"{ties}")
    # mixed decoding is not the fp32 net's: the probabilities move
    fp = port_net_from(net, "float32")
    diff = np.abs(teacher_forced_probs(fp, prompts[0], toks[0])
                  - teacher_forced_probs(net, prompts[0], toks[0])).max()
    assert 0 < diff <= MIXED_PROB_ATOL


def port_net_from(net, policy):
    """A port net under `policy` with `net`'s params (through
    `load_state_dict`, which bumps the params version)."""
    out = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN).init(device="cpu",
                                             dtype_policy=policy)
    out.load_state_dict(net.state_dict())
    return out


def test_mixed_engine_and_server_match_mixed_generate(net, prompts,
                                                      jax_mixed):
    _, _, eps = jax_mixed
    ref = generate(net, prompts, N_TOK, temperature=0)
    ref_probs = [teacher_forced_probs(net, p, t) for p, t in zip(prompts,
                                                                 ref)]
    # two slots for four prompts: staggered admissions
    eng = PagedDecodeEngine(net, n_slots=2, n_blocks=24, block_len=BL,
                            device="cpu")
    out, pending, slot2req = {}, list(range(len(prompts))), {}
    while pending or eng.active.any():
        while pending and eng.can_admit(len(prompts[pending[0]])):
            r = pending.pop(0)
            (slot, first, _), = eng.admit_many(
                [dict(prompt_ids=prompts[r], n_tokens=N_TOK)])
            out[r], slot2req[slot] = [first], r
        emitted, finished = eng.step()
        for s, toks in emitted.items():
            out[slot2req[s]].extend(toks)
    got = [out[r] for r in range(len(prompts))]
    with GenerationServer(net, n_slots=4, n_blocks=24, block_len=BL,
                          speculative=3, device="cpu") as srv:
        served = [s.result(timeout=60) for s in
                  [srv.generate_async(p, N_TOK) for p in prompts]]
    agree(ref, got, ref_probs, eps)
    agree(ref, served, ref_probs, eps)


def test_pool_is_bf16_and_half_the_fp32_bytes(jnet, net):
    mixed = PagedDecodeEngine(net, n_slots=2, n_blocks=9, block_len=BL,
                              device="cpu")
    fp32 = PagedDecodeEngine(port_net(jnet, "float32"), n_slots=2,
                             n_blocks=9, block_len=BL, device="cpu")
    assert all(t.dtype == torch.bfloat16 for kv in mixed.pool.kv
               for t in kv)
    assert all(t.dtype == torch.float32 for kv in fp32.pool.kv for t in kv)
    assert 2 * mixed.pool.device_bytes() == fp32.pool.device_bytes()
    carries = net.init_carries(1)
    assert carries["2"][0].dtype == torch.bfloat16


def test_serving_tree_is_cast_once_per_params_version(jnet, prompts,
                                                      monkeypatch):
    net = port_net(jnet)
    builds = []
    real = quant._build_serving_tree
    monkeypatch.setattr(quant, "_build_serving_tree",
                        lambda n, m: builds.append(m) or real(n, m))
    eng = PagedDecodeEngine(net, n_slots=2, n_blocks=24, block_len=BL,
                            device="cpu")
    eng.admit_many([dict(prompt_ids=p, n_tokens=6) for p in prompts[:2]])
    for _ in range(3):
        eng.step()
    assert builds == [None]                       # one cast, many dispatches
    tree = quant.serving_params(net, None)
    assert {t.dtype for lp in tree.params.values()
            for t in lp.values()} == {torch.bfloat16}
    seq = np.random.default_rng(5).integers(0, V, (2, 9))
    net.fit(seq[:, :-1].astype(np.float32), np.eye(V)[seq[:, 1:]],
            batch_size=2)
    while eng.active.any():
        eng.step()
    assert builds == [None, None]                 # rebuilt after fit()
    rebuilt = quant.serving_params(net, None)
    assert torch.equal(rebuilt.params["2"]["attn_Wq"],
                       net.layers[2].attn.Wq.to(torch.bfloat16))
    # int8 under mixed: q stays int8, the scale is bf16
    q8 = quant.serving_params(net, "int8").params["2"]["attn_Wq"]
    assert q8.q.dtype == torch.int8 and q8.scale.dtype == torch.bfloat16
    assert builds == [None, None, "int8"]
    # decode launches only the bf16 LayerNorm instance (none on the CPU)
    assert not any(k.startswith("layer_norm/float32")
                   for k in K.LAUNCHES_BY_DTYPE)


def test_restored_mixed_zip_serves(tmp_path):
    """The JAX-written small-LM zip with the mixed configuration's
    policy (`lm_config_mixed_bf16.json`) restores in both packages as a
    mixed net; the port decodes it like JAX, in `generate()` and the
    server."""
    with open(f"{BRIDGE}/lm_config_mixed_bf16.json") as f:
        policy = json.load(f)["dtype_policy"]
    src, dst = f"{BRIDGE}/lm_small.zip", tmp_path / "lm_small_mixed.zip"
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "configuration.json":
                conf = json.loads(data)
                conf["dtype_policy"] = policy
                data = json.dumps(conf).encode()
            zout.writestr(item, data)
    net = ModelSerializer.restore_model(dst, device="cpu")
    jnet = JaxSerializer.restore_model(str(dst))
    assert net.dtype.name == "mixed_bf16" and jnet.dtype.is_mixed
    vocab = net.layers[-1].n_out
    prompts = np.random.default_rng(23).integers(0, vocab, (2, 5))
    want = np.asarray(jax_generate(jnet, prompts, 8, temperature=0))
    probs = [jax_probs(jnet, p, t) for p, t in zip(prompts, want)]
    eps = max(float(np.abs(teacher_forced_probs(net, p, t) - jp).max())
              for p, t, jp in zip(prompts, want, probs))
    assert eps <= ZIP_PROB_ATOL, eps
    print(f"restored mixed zip vs JAX: max prob diff {eps:.4g}")
    with GenerationServer(net, n_slots=2, n_blocks=2 * 64 // 16 + 1,
                          block_len=16, device="cpu") as srv:
        served = [s.result(timeout=60) for s in
                  [srv.generate_async(p, 8) for p in prompts]]
    agree(want, generate(net, prompts, 8, temperature=0), probs, eps)
    agree(want, served, probs, eps)
    assert all(t.dtype == torch.bfloat16 for kv in
               srv.engine.pool.kv for t in kv)
