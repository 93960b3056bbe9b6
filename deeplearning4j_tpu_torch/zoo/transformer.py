"""TransformerClassifier, TransformerLM and the LM's decoding
(counterpart of `deeplearning4j_tpu/zoo/transformer.py`:
`TransformerClassifier` :31, `TransformerLM` :76,
`filter_logits` :133, `get_prefill` :157, `get_prefill_bucketed` :178,
`paged_score_forward` :207, `rejection_sample_drafts` :252, `generate`
:336, `beam_search` :442-566).

Sampling draws JAX's noise from JAX's keys (`common/prng.py`): a
sampled token is `jax.random.categorical`'s ``argmax(filtered_logits +
gumbel(key))``. `generate()` splits its key once a step, as the JAX
decode scan does (:421-424), and draws the whole batch's [B, V] noise
under the step's key; the serving engine draws row s under
`fold_in(request key, emit index)`. Rejection sampling folds each
lane's key further: 1 for the acceptance uniform, 2 for the resample
(JAX :300-332). The bits are exact and the noise is within about 5e-6
of JAX's (the logs), so a sampled stream equals JAX's up to near-ties
of the noisy logits.

Decoding runs under the dtype policy and `quantize=`: the weights are
the net's serving tree (`nd.quant.serving`: int8, or the compute-dtype
copies of `mixed_bf16`), the KV caches are in the compute dtype, and
the probabilities leave the output layer in the output dtype (fp32),
as in `output()`.

Greedy parity across PyTorch and XLA, and between one K-wide score and
K single-token decodes, is not bit-equality: neither cuBLAS nor the CPU
matmul is batch-invariant. `stream_agreement` holds two greedy streams
to agreement by margin instead: equal, or first apart at a near-tie of
the reference's probabilities.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import prng
from deeplearning4j_tpu_torch.common.updaters import Adam
from deeplearning4j_tpu_torch.nd import quant
from deeplearning4j_tpu_torch.common.weights import WeightInit
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingLayer,
    GlobalPoolingLayer,
    OutputLayer,
    PoolingType,
    PositionalEncodingLayer,
    RnnOutputLayer,
    TransformerEncoderBlock,
    stream_budget,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


class TransformerClassifier:
    """Token ids -> embedding + sinusoidal positions -> `n_layers`
    bidirectional pre-LN blocks (with `dropout` on their attention and
    FFN outputs while training) -> global pooling over time (AVG by
    default; the features mask keeps padding out) -> softmax over
    `num_classes` with the mcxent loss. `conf()` is the JAX zoo model's
    configuration (:31-73) with the same `to_dict()`; `init(device=)`
    follows `TransformerLM.init`. Train it on padded batches with a
    `DataSet` that carries the features mask."""

    def __init__(self, vocab_size: int, num_classes: int, *,
                 d_model: int = 128, n_layers: int = 2, n_heads: int = 8,
                 ff_multiplier: int = 4, max_len: int = 512,
                 dropout: Optional[float] = None,
                 pooling: PoolingType = PoolingType.AVG, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 sequence_parallel: Optional[str] = None, seed: int = 123):
        self.vocab_size, self.num_classes = int(vocab_size), int(num_classes)
        self.d_model, self.n_layers = int(d_model), int(n_layers)
        self.n_heads, self.ff_multiplier = int(n_heads), int(ff_multiplier)
        self.max_len, self.dropout = int(max_len), dropout
        self.pooling = PoolingType(pooling)
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
                dropout=self.dropout, remat=self.remat,
                remat_policy=self.remat_policy,
                sequence_parallel=self.sequence_parallel))
        b.layer(GlobalPoolingLayer(pooling_type=self.pooling))
        b.layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                            loss="mcxent"))
        b.set_input_type(InputType.recurrent(self.vocab_size))
        return b.build()

    def init(self, seed: Optional[int] = None, *, device="cuda",
             dtype_policy=None) -> MultiLayerNetwork:
        """The JAX model's net: Xavier-normal weights from JAX's keys
        for `seed` (default: the model's seed), as `TransformerLM.init`
        draws them."""
        return MultiLayerNetwork(self.conf(), device=device,
                                 dtype_policy=dtype_policy).init(
            self.seed if seed is None else seed)


class TransformerLM:
    """Embedding -> sinusoidal positions -> `n_layers` causal pre-LN
    blocks -> per-position softmax over the vocabulary with the mcxent
    loss. `conf()` is the JAX zoo model's configuration (:76-109), built
    with the port's builder: the same arguments, layer order, global
    `Adam(1e-3)` and Xavier init, and the same `to_dict()`.
    `sequence_parallel="ring"|"ulysses"` goes to every block: inside
    `parallel.sequence_sharding(mesh)`, `fit` and `output()` run their
    attention sequence-parallel over the mesh. `remat` and
    `remat_policy` go to every block: `fit` recomputes the blocks in the
    backward as the policy says (`nn/container.py` `_remat`; memory
    changes, numbers do not)."""

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
        """The JAX model's net: Xavier-normal weights drawn from JAX's
        threefry keys for `seed` (default: the model's seed), on
        `device`. `dtype_policy` (a
        `nd.dtype.DataTypePolicy`, a preset name such as "mixed_bf16", or
        None) goes to the container, where ``DL4J_DTYPE_POLICY``
        overrides it."""
        return MultiLayerNetwork(self.conf(), device=device,
                                 dtype_policy=dtype_policy).init(
            self.seed if seed is None else seed)


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


def request_key(rng):
    """A threefry key as the JAX engine and `generate` take one: a [2]
    uint32 key as is, an int seed as `PRNGKey(seed)`, None as the zero
    key (`PRNGKey(0)`)."""
    if rng is None:
        return (0, 0)
    if np.ndim(rng) == 0:
        return prng.key(int(rng))
    k0, k1 = (int(v) for v in np.asarray(rng).reshape(2))
    return (k0 & prng.MASK, k1 & prng.MASK)


def sample_ids(probs, temp, top_k, top_p, noise, greedy_only=False):
    """Next token per row of `probs` [S, V]: argmax where temp == 0 (the
    JAX greedy path), else the Gumbel-max draw from
    ``filter_logits(log(clip(probs, 1e-9)) / temp)`` with `noise` [S, V]
    (JAX's `categorical` when the noise is `prng.gumbel`'s).
    `temp`/`top_p` are [S] tensors on probs' device."""
    greedy_ids = torch.argmax(probs, dim=-1)
    if greedy_only:
        return greedy_ids
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    logits = torch.log(probs.clamp_min(1e-9)) / safe_t[:, None]
    logits = filter_logits(logits, top_k, top_p[:, None])
    sampled = torch.argmax(logits + noise, dim=-1)
    return torch.where(temp > 0, sampled, greedy_ids)


def get_prefill(net: MultiLayerNetwork):
    """Prompt prefill: `x` [B, P] -> (next-token probs [B, V] in the
    output dtype, filled carries). Runs on the weights installed by the
    caller (`nd.quant.serving`)."""
    def prefill(x, carries):
        h, new_carries = net._forward_core(x, carries=carries)
        return net.dtype.cast_output(h[:, -1]), new_carries
    return prefill


def get_prefill_bucketed(net: MultiLayerNetwork):
    """Mixed-length prefill: `x` [B, Pb] prompts RIGHT-padded to a shared
    bucket, `last_idx` [B] each row's last real position. Returns (probs
    [B, V] at last_idx, in the output dtype, filled carries). Right
    padding is sound because the blocks are causal and every later read
    past a row's position is masked."""
    def prefill(x, carries, last_idx):
        h, new_carries = net._forward_core(x, carries=carries)
        rows = torch.arange(h.shape[0], device=h.device)
        return net.dtype.cast_output(h[rows, last_idx]), new_carries
    return prefill


def paged_score_forward(net: MultiLayerNetwork, plan, kv, block_tables,
                        token_mat, pos, n_valid):
    """The K-position score over the paged pool: `token_mat` [S, K] holds
    K consecutive tokens a slot at positions `pos[s] .. pos[s] + K - 1`,
    `n_valid` [S] its real lanes (0: the slot sits out; its writes go to
    the garbage block). `plan` is the engine's layer walk, `kv` its
    (k_pool, v_pool) list, written in place. Returns probs [S, K, V] in
    the output dtype: probs[s, j] is the next-token distribution after
    token j, per lane the single-token decode's up to the matmuls'
    batch-variance. Runs on the weights installed by the caller."""
    layers = net.layers
    K = token_mat.shape[1]
    positions = pos[:, None] + torch.arange(K, device=pos.device)[None, :]
    h = token_mat
    for entry in plan:
        kind, i = entry[0], entry[1]
        if kind == "plain":
            h = layers[i](h)
        elif kind == "pos":
            h = layers[i].forward_at_positions(h, positions)
        else:
            k_pool, v_pool = kv[entry[2]]
            h = layers[i].forward_paged_multi(h, k_pool, v_pool,
                                              block_tables, pos, n_valid)
    return net.dtype.cast_output(h)


def rejection_sample_drafts(probs, token_mat, n_valid, keys, emit_idx,
                            temp, top_p, top_k):
    """Speculative rejection sampling over point-mass drafts (JAX :252):
    draft d at lane j+1 is accepted with probability q_t(d), where q_t is
    the target's filtered, tempered distribution after lane j
    (`filter_logits(log(p) / T, top_k, top_p)`); at the first rejection
    the token is resampled from q_t with d masked out, and when every
    draft survives the bonus token is drawn from the last lane. Each
    emitted token is then marginally a vanilla sample from q_t, and
    E[accepted at lane j] = q_t(d). A zero-support draft is always
    rejected (u < 0 never holds).

    Keys as JAX folds them: lane j of slot s is ``fold_in(keys[s],
    emit_idx[s] + j)``, its acceptance uniform is drawn under that key's
    fold 1 and the resample under the final lane's fold 2 (folds on the
    host, each draw's rows in one launch of the per-row-key kernel).

    `probs` [S, K, V] (`paged_score_forward`), `token_mat` [S, K] (lanes
    1 .. n_valid-1 are drafts), `n_valid` [S]; `keys` [S, 2] and
    `emit_idx` [S] are host int arrays. `temp`, `top_p` [S] tensors on
    probs' device; rows with temp 0 run at a guard temperature and are
    ignored by the caller. Returns (n_acc [S], final [S]): the leading
    accepted drafts and the token at lane n_acc."""
    S, K, V = probs.shape
    dev = probs.device
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    logits = torch.log(probs.float().clamp_min(1e-9)) / safe_t[:, None, None]
    logits = filter_logits(logits, top_k,
                           None if top_p is None else top_p[:, None, None])
    qt = torch.softmax(logits, dim=-1)
    lanes = (torch.as_tensor(np.asarray(emit_idx))[:, None]
             + torch.arange(K)[None, :])                          # [S, K]
    pos_keys = prng.fold_in_rows(
        torch.as_tensor(np.asarray(keys)).repeat_interleave(K, dim=0),
        lanes.reshape(-1)).reshape(S, K, 2)
    acc_keys = prng.fold_in_rows(pos_keys[:, :-1].reshape(-1, 2),
                                 torch.ones(S * (K - 1), dtype=torch.int64))
    u = prng.uniform_rows(acc_keys.to(dev), 1)[:, 0].reshape(S, K - 1)
    drafts = token_mat[:, 1:]
    p_acc = torch.gather(qt[:, :-1, :], 2, drafts[..., None])[..., 0]
    lane_ok = (torch.arange(K - 1, device=dev)[None, :]
               < (n_valid[:, None] - 1))
    acc = (u < p_acc) & lane_ok
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    lane = n_acc.clamp(0, K - 1)
    final_logits = torch.gather(
        logits, 1, lane[:, None, None].expand(S, 1, V))[:, 0]
    rejected = n_acc < (n_valid - 1).clamp_min(0)
    rej_tok = torch.gather(token_mat, 1,
                           (n_acc + 1).clamp(0, K - 1)[:, None])[:, 0]
    mask = (torch.nn.functional.one_hot(rej_tok, V).bool()
            & rejected[:, None])
    final_logits = final_logits.masked_fill(mask, float("-inf"))
    lane_keys = pos_keys[torch.arange(S), lane.cpu()]
    fin_keys = prng.fold_in_rows(lane_keys, torch.full((S,), 2,
                                                       dtype=torch.int64))
    final = prng.categorical_rows(fin_keys.to(dev), final_logits)
    return n_acc, final


@torch.no_grad()
def generate(net: MultiLayerNetwork, prompt_ids, n_tokens: int, *,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, rng: Optional[int] = None,
             quantize: Optional[str] = None):
    """Autoregressive decoding with per-layer KV caches: one prefill over
    the prompt, then one forward per token (a Python loop — PyTorch runs
    eagerly). `prompt_ids` [B, T] ints -> [B, n_tokens] ids (numpy).
    `temperature=0` is greedy argmax; otherwise each step splits the key
    (`rng`: a [2] uint32 key, an int seed meaning `PRNGKey(seed)`, or
    None for `PRNGKey(0)`, as in JAX) and draws the batch's token with
    `categorical` under the step's subkey, as the JAX decode scan does.
    `quantize="int8"` decodes from the net's cached int8 serving tree
    (`nd.quant`); the params are untouched."""
    prompt_np = np.asarray(prompt_ids).astype(np.int64)
    if prompt_np.ndim != 2 or prompt_np.shape[1] == 0:
        raise ValueError(f"prompt_ids must be [B, T>0]; got {prompt_np.shape}")
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
    key = request_key(rng)
    temp = torch.full((B,), float(temperature), device=dev)
    top_p_t = torch.full((B,), 1.0 if top_p is None else float(top_p),
                         device=dev)
    prefill = get_prefill(net)
    out = []
    with quant.serving(net, quantize):
        probs, carries = prefill(torch.as_tensor(prompt_np, device=dev),
                                 net.init_carries(B))
        for t in range(n_tokens):
            noise = None
            if not greedy:
                key, sub = prng.split(key)
                noise = prng.gumbel(sub, (B, vocab), probs.dtype, dev)
            nxt = sample_ids(probs, temp, top_k, top_p_t, noise,
                             greedy_only=greedy)
            out.append(nxt)
            if t + 1 < n_tokens:
                probs, carries = prefill(nxt[:, None], carries)
    return torch.stack(out, dim=1).cpu().numpy()


# ------------------------------------------------------------ beam search
def _token_input(net: MultiLayerNetwork, ids: torch.Tensor) -> torch.Tensor:
    """The net's input for token ids [N, T]: the ids for an embedding,
    else their one-hot rows over the first layer's `n_in` (a char-RNN
    such as TextGenerationLSTM takes one-hot features)."""
    if isinstance(net.layers[0], EmbeddingLayer):
        return ids
    return torch.nn.functional.one_hot(
        ids, int(net.layers[0].n_in)).to(net.dtype.param_dtype)


def _regather(tree, rows: torch.Tensor):
    """Every tensor of a carries tree indexed by `rows` along its batch
    axis (ints, such as a cache position, pass)."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, rows)
    if isinstance(tree, dict):
        return {k: _regather(v, rows) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_regather(v, rows) for v in tree)
    return tree


def _top_k_stable(x: torch.Tensor, k: int):
    """`lax.top_k` along the last axis: the k largest, ties to the lower
    index (a stable descending sort; `torch.topk` on the card promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(net: MultiLayerNetwork, prompt_ids, n_tokens: int, *,
                beam_width: int = 4, eos_id: Optional[int] = None,
                length_penalty: float = 0.0, device="cuda"):
    """Beam-search decoding over the cached decode of `generate` (the
    JAX `beam_search`): the beams ride the batch axis (B * beam_width
    rows of KV caches, or of recurrent carries for a char-RNN), and each
    step gathers every cache row by its surviving beam. Only beam 0 is
    live at step 0 (the others start at -inf); a step scores
    ``log(clip(p, 1e-9))`` and keeps the `beam_width` best of all beams'
    extensions (ties to the lower flat index, as `lax.top_k`). With
    `eos_id` a finished beam extends with eos at no cost.
    `length_penalty` re-ranks the final beams on the host by score /
    ((5 + len) / 6)^alpha (GNMT; len counts tokens up to and with eos);
    the returned scores stay the raw sums. `prompt_ids` [B, T] ->
    (ids [B, beam_width, n_tokens], log-probs [B, beam_width]), numpy,
    best first. `device` is where the search runs; the net must live
    there (the default is the card)."""
    from deeplearning4j_tpu_torch.device import resolve_device
    prompt_np = np.asarray(prompt_ids).astype(np.int64)
    if prompt_np.ndim != 2 or prompt_np.shape[1] == 0:
        raise ValueError(f"prompt_ids must be [B, T>0]; got "
                         f"{prompt_np.shape}")
    B, Tp = prompt_np.shape
    W, n = int(beam_width), int(n_tokens)
    if resolve_device(device) != net.device:
        raise ValueError(f"the net lives on {net.device}; a beam search "
                         f"on {device} cannot run it")
    check_cache_budget(net, Tp, n)
    if W < 1:
        raise ValueError(f"beam_width must be >= 1; got {beam_width}")
    V = int(net.layers[-1].n_out)
    if eos_id is not None and not 0 <= int(eos_id) < V:
        raise ValueError(f"eos_id must be in [0, vocab={V}); got {eos_id}")
    check_ids(prompt_np, V)
    dev = net.device

    def step_logp(ids, carries):
        h, carries = net._forward_core(_token_input(net, ids),
                                       carries=carries)
        p = net.dtype.cast_output(h[:, -1]).float()
        return torch.log(p.clamp_min(1e-9)), carries

    with quant.serving(net, None):
        logp0, carries = step_logp(torch.as_tensor(prompt_np, device=dev),
                                   net.init_carries(B))
        rep = torch.arange(B, device=dev).repeat_interleave(W)
        carries = _regather(carries, rep)
        logp = logp0[:, None, :].expand(B, W, V)
        scores = torch.full((B, W), float("-inf"), device=dev)
        scores[:, 0] = 0.0
        seqs = torch.zeros((B, W, n), dtype=torch.int64, device=dev)
        fin = torch.zeros((B, W), dtype=torch.bool, device=dev)
        only_eos = None
        if eos_id is not None:
            only_eos = torch.full((V,), float("-inf"), device=dev)
            only_eos[int(eos_id)] = 0.0
        base = (torch.arange(B, device=dev) * W)[:, None]
        for t in range(n):
            cand = scores[..., None] + logp                  # [B, W, V]
            if only_eos is not None:
                cand = torch.where(fin[..., None],
                                   scores[..., None] + only_eos, cand)
            scores, top_i = _top_k_stable(cand.reshape(B, W * V), W)
            beam_idx, token = top_i // V, top_i % V
            seqs = torch.gather(seqs, 1, beam_idx[..., None].expand(B, W, n))
            seqs[:, :, t] = token
            fin = torch.gather(fin, 1, beam_idx)
            if only_eos is not None:
                fin = fin | (token == int(eos_id))
            if t + 1 < n:
                carries = _regather(carries, (base + beam_idx).reshape(-1))
                lp, carries = step_logp(token.reshape(B * W, 1), carries)
                logp = lp.reshape(B, W, V)
    seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
    if eos_id is not None:
        hits = np.cumsum(seqs == eos_id, axis=2) > 0
        lengths = np.where(hits.any(2), hits.argmax(2) + 1, n)
    else:
        lengths = np.full(scores.shape, n)
    norm = ((5.0 + lengths.astype(np.float64)) / 6.0) ** length_penalty
    order = np.argsort(-scores / norm, axis=1, kind="stable")
    return (np.take_along_axis(seqs, order[..., None], axis=1),
            np.take_along_axis(scores, order, axis=1))


# ------------------------------------------------------ parity by margin
@torch.no_grad()
def teacher_forced_probs(net: MultiLayerNetwork, prompt, tokens, *,
                         quantize: Optional[str] = None) -> np.ndarray:
    """The decode path's next-token probabilities [n, V] (output dtype)
    at the positions that predict each of `tokens`, with `prompt` and
    `tokens[:-1]` fed in: one cached-prefill forward on the serving
    weights."""
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    seq = np.concatenate([prompt, tokens[:-1]])[None]
    with quant.serving(net, quantize):
        h, _ = net._forward_core(torch.as_tensor(seq, device=net.device),
                                 carries=net.init_carries(1))
    h = net.dtype.cast_output(h[0])
    return h[len(prompt) - 1:].float().cpu().numpy()


def stream_agreement(ref, got, ref_probs, eps: float) -> dict:
    """Two greedy streams held by margin: `ok` when `got` equals `ref`
    at every position up to the first difference and that position is a
    near-tie of the reference, i.e. its top-1/top-2 gap in `ref_probs`
    ([n, V], the reference's teacher-forced probabilities) is at most
    `eps`, the largest probability difference measured between the two
    paths (past a difference the streams no longer share a context).
    `near_ties` counts the reference's positions with gap <= eps."""
    ref = np.asarray(ref).reshape(-1)
    got = np.asarray(got).reshape(-1)
    top = np.sort(np.asarray(ref_probs, np.float64), axis=-1)
    gaps = (top[:, -1] - top[:, -2])[:len(ref)]
    near = gaps <= eps
    diff = np.flatnonzero(ref[:len(got)] != got[:len(ref)])
    first = int(diff[0]) if diff.size else None
    ok = len(got) == len(ref) and (first is None or bool(near[first]))
    return dict(ok=ok, first_diff=first, near_ties=int(near.sum()),
                min_gap=float(gaps.min()) if gaps.size else None)
