"""The port's sampled decoding held to the JAX package's distribution.

The port samples by Gumbel-max over host noise seeded per (request
seed, token index) (`zoo/transformer.py`), JAX by
`jax.random.categorical`: the bits differ by design, so the contract is
distributional. Over N seeds, the marginal of the port's first sampled
token — from `generate()` and from the paged engine's admission wave,
each with top_k and/or top_p on — must fit the target distribution by a
chi-square goodness-of-fit test. The target is the JAX package's own:
softmax of JAX's `filter_logits(log(clip(p, 1e-9)) / T, top_k, top_p)`
over the JAX model's next-token probabilities for the same prompt and
params.

As in `tests/test_serving_statistical.py`: pinned seeds (the run is
reproducible), the q = 1 - 1e-4 critical value (a correct sampler fails
one case with probability < 1e-4 under seed churn), and the tail mass
lumped until every expected count is at least 5. N = 4000 per case: a
total-variation defect of a few percent over the ~6 surviving tokens
drives the statistic far past the threshold.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.zoo.transformer import (
    TransformerLM as JaxLM,
    filter_logits as jax_filter_logits,
)
from deeplearning4j_tpu_torch.serving import PagedDecodeEngine
from deeplearning4j_tpu_torch.util.jax_params import (
    from_jax_params,
    to_numpy_params,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM, generate

V, D, HEADS, LAYERS, MAXLEN, BL = 23, 16, 4, 2, 16, 4
N, TEMP = 4000, 0.9
PROMPT = np.asarray([[3, 17, 5, 11, 2]])


def chi2_crit(df: int, q: float = 0.9999) -> float:
    """Upper chi-square quantile: scipy when present, Wilson-Hilferty
    otherwise (about 1% off at these df; the callers allow 5%)."""
    try:
        from scipy.stats import chi2
        return float(chi2.ppf(q, df))
    except ImportError:
        z = 3.719      # standard normal quantile at 1 - 1e-4
        a = 2.0 / (9.0 * df)
        return df * (1.0 - a + z * np.sqrt(a)) ** 3


@pytest.fixture(scope="module")
def nets():
    # seed 3's next-token probabilities for PROMPT spread over every
    # token (0.49 at the top, then 0.14, 0.06, ...)
    jnet = JaxLM(vocab_size=V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                 max_len=MAXLEN, seed=3).init()
    net = TransformerLM(V, d_model=D, n_layers=LAYERS, n_heads=HEADS,
                        max_len=MAXLEN).init(device="cpu")
    return jnet, from_jax_params(net, to_numpy_params(jnet.params))


def target(jnet, top_k, top_p):
    """The JAX package's sampling distribution for PROMPT's next token."""
    probs = jnet.output(PROMPT)[:, -1]                     # [1, V]
    logits = jnp.log(jnp.clip(probs, 1e-9, None)) / TEMP
    logits = jax_filter_logits(
        logits, top_k, None if top_p is None else jnp.full((1, 1), top_p))
    return np.asarray(jax.nn.softmax(logits, axis=-1), np.float64)[0]


def assert_fits(q, tokens):
    expected = q * len(tokens)
    big = expected >= 5.0
    counts = np.bincount(tokens, minlength=V).astype(float)
    # tokens the filters removed must never be drawn
    assert counts[q == 0].sum() == 0, np.flatnonzero(counts * (q == 0))
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    df = len(obs) - 1
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert df >= 2, f"only {df + 1} atoms survive the filters"
    assert stat < 1.05 * chi2_crit(df), (
        f"chi2={stat:.1f} over df={df} exceeds the 1e-4 critical value "
        f"{chi2_crit(df):.1f}: the port's marginal has drifted from "
        f"JAX's filtered distribution")


FILTERS = [(6, None), (None, 0.8), (8, 0.9)]
IDS = ["top_k", "top_p", "top_k_and_top_p"]


@pytest.mark.parametrize("top_k,top_p", FILTERS, ids=IDS)
def test_generate_first_token_marginal_fits_jax(nets, top_k, top_p):
    jnet, net = nets
    toks = generate(net, np.repeat(PROMPT, N, axis=0), 1, temperature=TEMP,
                    top_k=top_k, top_p=top_p, rng=10_000)[:, 0]
    assert_fits(target(jnet, top_k, top_p), toks)


@pytest.mark.parametrize("top_k,top_p", FILTERS, ids=IDS)
def test_engine_first_token_marginal_fits_jax(nets, top_k, top_p):
    jnet, net = nets
    eng = PagedDecodeEngine(net, n_slots=64, n_blocks=2 * 64 + 1,
                            block_len=BL, top_k=top_k, device="cpu")
    reqs = [dict(prompt_ids=PROMPT[0], n_tokens=1, temperature=TEMP,
                 top_p=top_p, rng=50_000 + i) for i in range(N)]
    toks = []
    while reqs:
        admitted = eng.admit_many(reqs)
        assert admitted and all(done for _, _, done in admitted)
        toks += [first for _, first, _ in admitted]
        reqs = reqs[len(admitted):]
    assert eng.free_blocks == 2 * 64
    assert_fits(target(jnet, top_k, top_p), np.asarray(toks))
