"""The port's `beam_search` (`zoo/transformer.py`) against the JAX
package's, on the CPU: ids equal and scores within 1e-5 on a 2-layer
d32 LM with the same params (the head's W scaled by 8 so the beams'
scores are decisive, near-ties of the final ranking counted), with
`eos_id` and a length penalty; `beam_width=1` equal to greedy
`generate()`; a char-RNN (TextGenerationLSTM) whose carries ride the
beams, against a plain beam search over full-sequence `output()` calls;
and the eager validation.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.zoo.transformer import beam_search as jax_beam
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.transformer import (
    TransformerLM,
    beam_search,
    generate,
)

SCORE_ATOL = 1e-5
LM = dict(d_model=32, n_layers=2, n_heads=2, max_len=32)
V = 24


@pytest.fixture(autouse=True)
def _no_env_policy(monkeypatch):
    monkeypatch.delenv("DL4J_DTYPE_POLICY", raising=False)


@pytest.fixture(scope="module")
def lms():
    jnet = JaxLM(V, **LM).init()
    params = to_numpy_params(jnet.params)
    head = str(len(jnet.layers) - 1)
    params[head]["W"] = params[head]["W"] * 8
    jnet.params = {k: {n: jnp.asarray(a) for n, a in v.items()}
                   for k, v in params.items()}
    net = from_jax_params(TransformerLM(V, **LM).init(device="cpu"), params)
    return jnet, net


def prompts(B=3, T=5, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T))


def near_ties(scores, eps=SCORE_ATOL):
    """Adjacent final beams whose scores are within eps (their order may
    differ between the packages)."""
    s = np.sort(scores, axis=1)
    return int((np.diff(s, axis=1) <= 2 * eps).sum())


@pytest.mark.parametrize("case", [
    dict(beam_width=4),
    dict(beam_width=3, eos_id=5),
    dict(beam_width=4, eos_id=7, length_penalty=0.6),
])
def test_beam_search_matches_jax(lms, case):
    jnet, net = lms
    p = prompts()
    ids, scores = beam_search(net, p, 8, device="cpu", **case)
    jids, jscores = jax_beam(jnet, p, 8, **case)
    assert ids.shape == (3, case["beam_width"], 8)
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                               atol=SCORE_ATOL)
    assert near_ties(np.asarray(jscores)) == 0
    np.testing.assert_array_equal(ids, np.asarray(jids))
    if "eos_id" in case:
        eos = case["eos_id"]
        after = np.cumsum(ids == eos, axis=2) > 0
        # once a beam emits eos it emits only eos
        assert np.all(ids[np.roll(after, 1, axis=2) & after] == eos)


def test_beam_width_one_is_greedy(lms):
    _, net = lms
    p = prompts(B=2, seed=3)
    ids, scores = beam_search(net, p, 10, beam_width=1, device="cpu")
    np.testing.assert_array_equal(
        ids[:, 0], generate(net, p, 10, temperature=0.0))
    assert np.all(np.isfinite(scores)) and np.all(scores <= 0)


def _plain_beam(net, prompt, n, W, V, one_hot):
    """Beam search over full-sequence `output()` calls (no caches), the
    ties broken to the lower flat index."""
    beams = [([], 0.0)]
    for _ in range(n):
        cand = []
        for bi, (seq, s) in enumerate(beams):
            ids = np.array([list(prompt) + seq])
            x = np.eye(V, dtype=np.float32)[ids] if one_hot else ids
            p = net.output(x)[0, -1].double().numpy()
            lp = np.log(np.clip(p.astype(np.float32), 1e-9, None))
            for t in range(V):
                cand.append((s + float(lp[t]), bi * V + t, seq + [t]))
        cand.sort(key=lambda c: (-c[0], c[1]))
        beams = [(c[2], c[0]) for c in cand[:W]]
    return np.array([b[0] for b in beams]), np.array([b[1] for b in beams])


def test_char_rnn_beams_ride_the_carries():
    """TextGenerationLSTM takes one-hot characters: the beams regather
    its LSTM carries, and the search equals a plain one over whole
    sequences."""
    Vc = 6
    net = TextGenerationLSTM(vocab_size=Vc, hidden=8).init(device="cpu")
    p = np.array([[1, 4, 2, 0], [3, 3, 5, 1]])
    ids, scores = beam_search(net, p, 5, beam_width=3, device="cpu")
    for b in range(2):
        want_ids, want_s = _plain_beam(net, p[b], 5, 3, Vc, one_hot=True)
        np.testing.assert_array_equal(ids[b], want_ids)
        np.testing.assert_allclose(scores[b], want_s, rtol=0, atol=1e-5)


def test_transformer_beams_equal_a_plain_search(lms):
    _, net = lms
    p = prompts(B=1, seed=9)
    ids, scores = beam_search(net, p, 4, beam_width=2, device="cpu")
    want_ids, want_s = _plain_beam(net, p[0], 4, 2, V, one_hot=False)
    np.testing.assert_array_equal(ids[0], want_ids)
    np.testing.assert_allclose(scores[0], want_s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", ["width", "eos", "budget", "ids", "device"])
def test_beam_search_validates_eagerly(lms, bad):
    _, net = lms
    p = prompts()
    kw = dict(device="cpu")
    n = 4
    if bad == "width":
        kw["beam_width"] = 0
    elif bad == "eos":
        kw["eos_id"] = V
    elif bad == "budget":
        n = LM["max_len"]
    elif bad == "ids":
        p = p + V
    else:
        kw["device"] = "meta"
    with pytest.raises(ValueError):
        beam_search(net, p, n, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            beam_search(net, prompts(), 2)
