"""TransformerLM and its decoding (counterpart of
`deeplearning4j_tpu/zoo/transformer.py`: `TransformerLM` :76,
`filter_logits` :133, `get_prefill_bucketed` :178, `generate` :336).

Sampling cannot reproduce JAX's threefry bits. Here a sampled token is
the Gumbel-max draw ``argmax(filtered_logits + g)`` with `g` made on the
host by a `torch.Generator` seeded from (request seed, emit index), so
token t of a stream depends only on its seed and t — never on what else
is batched with it — in `generate()` and in the serving engine alike.
Greedy decoding is the bit-level contract with the JAX package; sampled
decoding's is distributional (each token's marginal is the softmax of
the filtered logits, as `jax.random.categorical` draws it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingLayer,
    PositionalEncodingLayer,
    RnnOutputLayer,
    TransformerEncoderBlock,
    stream_budget,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


class TransformerLM:
    """Embedding -> sinusoidal positions -> `n_layers` causal pre-LN
    blocks -> per-position softmax over the vocabulary with the mcxent
    loss. `conf()` is the JAX zoo model's configuration (:76-109), built
    with the port's builder: the same arguments, layer order, global
    `Adam(1e-3)` and Xavier init, and the same `to_dict()`.
    `sequence_parallel="ring"|"ulysses"` goes to every block: inside
    `parallel.sequence_sharding(mesh)`, `fit` and `output()` run their
    attention sequence-parallel over the mesh. `remat` and
    `remat_policy` are carried in the configuration (they change memory,
    not numbers; the port does not rematerialize)."""

    def __init__(self, vocab_size: int, *, d_model: int = 128,
                 n_layers: int = 2, n_heads: int = 8, ff_multiplier: int = 4,
                 max_len: int = 512, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 sequence_parallel: Optional[str] = None, seed: int = 123):
        self.vocab_size, self.d_model = int(vocab_size), int(d_model)
        self.n_layers, self.n_heads = int(n_layers), int(n_heads)
        self.ff_multiplier, self.max_len = int(ff_multiplier), int(max_len)
        self.remat, self.remat_policy = remat, remat_policy
        self.sequence_parallel = sequence_parallel
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(Adam(1e-3))
             .weight_init(WeightInit.XAVIER)
             .list()
             .layer(EmbeddingLayer(n_in=self.vocab_size, n_out=self.d_model))
             .layer(PositionalEncodingLayer(max_len=self.max_len)))
        for _ in range(self.n_layers):
            b.layer(TransformerEncoderBlock(
                n_heads=self.n_heads, ff_multiplier=self.ff_multiplier,
                causal=True, remat=self.remat,
                remat_policy=self.remat_policy, cache_len=self.max_len,
                sequence_parallel=self.sequence_parallel))
        b.layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax",
                               loss="mcxent"))
        b.set_input_type(InputType.recurrent(self.vocab_size))
        return b.build()

    def layers(self):
        """The configuration's layers (params zero until drawn or
        loaded)."""
        return self.conf().layers

    def init(self, seed: Optional[int] = None, *, device="cuda",
             dtype_policy=None) -> MultiLayerNetwork:
        """A net with Xavier-normal weights drawn from a CPU
        `torch.Generator` seeded with `seed` (default: the model's seed;
        not the JAX package's threefry draws: load those with
        `util.jax_params.from_jax_params`). `dtype_policy` (a
        `nd.dtype.DataTypePolicy`, a preset name such as "mixed_bf16", or
        None) goes to the container, where ``DL4J_DTYPE_POLICY``
        overrides it."""
        return MultiLayerNetwork(self.conf(), device=device,
                                 dtype_policy=dtype_policy).init(
            self.seed if seed is None else seed)


def check_decode_policy(net):
    """Decoding (generate() and serving) runs the fp32 policy only;
    mixed serving is not ported yet and is refused, not ignored."""
    if net.dtype.is_mixed:
        raise NotImplementedError(
            f"decoding under the {net.dtype.name} dtype policy is not "
            f"ported yet; decode a float32 net")


def check_cache_budget(net, prompt_len: int, n_tokens: int):
    budget = stream_budget(net.layers)
    total = prompt_len + n_tokens
    if budget is not None and total > budget:
        raise ValueError(
            f"prompt ({prompt_len}) + n_tokens ({n_tokens}) = {total} "
            f"exceeds the decode budget {budget} (min over KV cache "
            f"lengths and positional-encoding max_len)")


def check_ids(ids: np.ndarray, vocab: int):
    if ids.size and (ids.min() < 0 or ids.max() >= vocab):
        raise ValueError(f"token ids must be in [0, {vocab}); got "
                         f"[{ids.min()}, {ids.max()}]")


def filter_logits(logits, top_k: Optional[int], top_p):
    """Vocabulary filters for sampled decoding, shared by `generate()`
    and the engine's sampler. `top_p` is a float or a per-row [S, 1]
    tensor. Nucleus rule: keep tokens whose PRECEDING cumulative mass is
    < p (the most probable token always survives)."""
    neg_inf = torch.tensor(float("-inf"), device=logits.device,
                           dtype=logits.dtype)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, neg_inf)
    if top_p is not None:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        sp = torch.softmax(sorted_l, dim=-1)
        keep = (torch.cumsum(sp, dim=-1) - sp) < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, float("inf")))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        logits = torch.where(logits >= cutoff, logits, neg_inf)
    return logits


def _mix(seed: int, t: int) -> int:
    """splitmix64 of (seed, t): the per-token generator seed."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(t) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def gumbel_noise(seed: int, t: int, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [vocab] for token `t` of the stream seeded
    `seed`, drawn on the CPU from a `torch.Generator`."""
    g = torch.Generator().manual_seed(_mix(seed, t))
    u = torch.rand(vocab, generator=g, dtype=torch.float64)
    u = u.clamp(1e-12, 1.0 - 1e-12)
    return (-torch.log(-torch.log(u))).float()


def sample_ids(probs, temp, top_k, top_p, noise, greedy_only=False):
    """Next token per row of `probs` [S, V]: argmax where temp == 0 (the
    JAX greedy path), else the Gumbel-max draw from
    ``filter_logits(log(clip(probs, 1e-9)) / temp)`` with `noise` [S, V].
    `temp`/`top_p` are [S] tensors on probs' device."""
    greedy_ids = torch.argmax(probs, dim=-1)
    if greedy_only:
        return greedy_ids
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    logits = torch.log(probs.clamp_min(1e-9)) / safe_t[:, None]
    logits = filter_logits(logits, top_k, top_p[:, None])
    sampled = torch.argmax(logits + noise, dim=-1)
    return torch.where(temp > 0, sampled, greedy_ids)


def get_prefill_bucketed(net: MultiLayerNetwork):
    """Mixed-length prefill: `x` [B, Pb] prompts RIGHT-padded to a shared
    bucket, `last_idx` [B] each row's last real position. Returns (probs
    [B, V] at last_idx, filled carries). Right padding is sound because
    the blocks are causal and every later read past a row's position is
    masked."""
    def prefill(x, carries, last_idx):
        h, new_carries = net._forward_core(x, carries=carries)
        rows = torch.arange(h.shape[0], device=h.device)
        return h[rows, last_idx], new_carries
    return prefill


@torch.no_grad()
def generate(net: MultiLayerNetwork, prompt_ids, n_tokens: int, *,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, rng: Optional[int] = None):
    """Autoregressive decoding with per-layer KV caches: one prefill over
    the prompt, then one forward per token (a Python loop — PyTorch runs
    eagerly). `prompt_ids` [B, T] ints -> [B, n_tokens] ids (numpy).
    `temperature=0` is greedy argmax; otherwise row b samples with seed
    ``rng + b`` (default rng 0) — the engine's per-request seed scheme,
    so a one-row sampled `generate` and a served request with the same
    seed draw the same noise."""
    prompt_np = np.asarray(prompt_ids).astype(np.int64)
    if prompt_np.ndim != 2 or prompt_np.shape[1] == 0:
        raise ValueError(f"prompt_ids must be [B, T>0]; got {prompt_np.shape}")
    check_decode_policy(net)
    B, P = prompt_np.shape
    vocab = net.layers[-1].n_out
    check_ids(prompt_np, vocab)
    check_cache_budget(net, P, n_tokens)
    if top_k is not None and not 1 <= int(top_k) <= vocab:
        raise ValueError(f"top_k must be in [1, vocab={vocab}]; got {top_k}")
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    dev = net.device
    greedy = float(temperature) == 0.0
    seed0 = 0 if rng is None else int(rng)
    temp = torch.full((B,), float(temperature), device=dev)
    top_p_t = torch.full((B,), 1.0 if top_p is None else float(top_p),
                         device=dev)
    probs, carries = net._forward_core(
        torch.as_tensor(prompt_np, device=dev), carries=net.init_carries(B))
    probs = probs[:, -1]
    out = []
    for t in range(n_tokens):
        noise = None if greedy else torch.stack(
            [gumbel_noise(seed0 + b, t, vocab) for b in range(B)]).to(dev)
        nxt = sample_ids(probs, temp, top_k, top_p_t, noise,
                         greedy_only=greedy)
        out.append(nxt)
        if t + 1 < n_tokens:
            h, carries = net._forward_core(nxt[:, None], carries=carries)
            probs = h[:, -1]
    return torch.stack(out, dim=1).cpu().numpy()
