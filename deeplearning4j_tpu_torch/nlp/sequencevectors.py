"""SequenceVectors — the generic embedding-training engine (counterpart of
`deeplearning4j_tpu/nlp/sequencevectors.py`), on a torch device.

Reference: `models/sequencevectors/SequenceVectors.java:192` (`fit()`):
vocab scan → AsyncSequencer prefetch thread → Hogwild per-pair updates.
The JAX package batches that schedule: the host streams sequences,
subsamples frequent words, applies the reduced-window trick and packs
(center, context, negatives) into batches; the device runs one step per
batch — gathers, the [B, K] dot products, log-sigmoid loss and the
sparse closed-form update scattered into the tables, each touched row's
summed delta divided by its count in the batch.

The port keeps the host side as it is: numpy pair packing, the
subsampling, the quantized unigram table, the negatives drawn at flush
time from their own stream, and the async producer thread with its
`etl_stats`. Every random draw is numpy, in JAX's place and order, so
both packages train on the same numbers from the same seed; the port
makes no torch random call.

The device side holds `syn0`, `syn1neg` and `syn1` as float32 tensors
on `device` (default ``"cuda"``; it raises without CUDA) during `fit`,
and hands them back as numpy arrays after it, as JAX's `fit` does. Each
jitted step of the JAX module is a function of plain torch ops here
(`index_select`, `bmm`, `sigmoid`/`logsigmoid`, `index_add_`) that
updates the tables in place, where JAX donates them:

- `_sg_neg_math` / `_sg_neg_scan` (a fused group: k batches from one
  host-to-device copy of each array), `_cbow_neg_math`,
  `_hs_path_grads`, `_sg_hs_math`, `_cbow_hs_math`; `valid` masks and
  `trainable_from` as in JAX. syn1neg takes the contexts' scatter, then
  the negatives', as JAX's does, so on the CPU the tables equal JAX's
  to float32 rounding; on the card `index_add_` adds through atomics,
  so two card runs agree by tolerance, not bit for bit.
- `_sg_neg_mesh`: the sharded skip-gram step (`mesh=`, the port's
  `parallel.mesh.Mesh`, devices may repeat): row counts over the global
  batch, each replica's shard's row sums on its device, summed across
  replicas in replica order before the update.

No host sync inside a fit: the loss stays on the device and is read
once at the end, and each host array goes to the card once per flush
(a fused group's arrays once per group) through pinned staging memory,
`non_blocking`. A ragged epoch-end tail runs at its own length with the
same negatives stream (JAX pads it to the compiled batch with a `valid`
mask only so that XLA does not compile again).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabConstructor,
    build_huffman,
)
from deeplearning4j_tpu_torch.parallel.collectives import (
    reduce_sum,
    shard_slice,
)

_F32 = torch.float32


@dataclasses.dataclass
class SequenceVectorsConfig:
    vector_length: int = 100
    window: int = 5
    min_word_frequency: int = 1
    negative: int = 5           # K negative samples; 0 → hierarchical softmax
    use_hierarchic_softmax: bool = False
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    epochs: int = 1
    iterations: int = 1         # passes per batch (reference `iterations`)
    batch_size: int = 2048      # pairs per device step
    steps_per_flush: int = 8    # skip-gram batches fused into one group
    subsampling: float = 0.0    # frequent-word discard threshold (e.g. 1e-3)
    seed: int = 42
    cbow: bool = False          # elements learning algorithm: CBOW vs SkipGram
    unigram_power: float = 0.75  # negative-table exponent (word2vec standard)
    # AsyncSequencer role (`SequenceVectors.java:288`): pack pair arrays
    # on a producer thread while the consumer feeds the device. Applies
    # to the skip-gram array path without a pair_hook.
    async_producer: bool = True
    producer_queue_depth: int = 2


# ------------------------------------------------------------ device steps
def _scalar(lr, device) -> torch.Tensor:
    """`lr` as a float32 0-d tensor on `device` (a fill, no copy)."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), float(np.float32(lr)), dtype=_F32, device=device)


def _row_counts(n_rows, device, *index_sets):
    """How many times each table row is touched in the batch, at least
    1. Each entry is an index tensor, or (indices, weights) for masked
    references."""
    c = torch.zeros(n_rows, dtype=_F32, device=device)
    one = torch.ones(1, dtype=_F32, device=device)
    for s in index_sets:
        if isinstance(s, tuple):
            idx, w = s
            c.index_add_(0, idx.reshape(-1), w.reshape(-1).to(_F32))
        else:
            c.index_add_(0, s.reshape(-1), one.expand(s.numel()))
    return c.clamp_(min=1.0)


def _rows(table, idx):
    """`table[idx]` for an index tensor of any shape: [*idx.shape, D]."""
    return table.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)


def _scatter(table, updates):
    """Add each (rows, deltas) into `table` in place, in order."""
    for idx, delta in updates:
        table.index_add_(0, idx.reshape(-1),
                         delta.reshape(-1, table.shape[1]))
    return table


def _sg_neg_counts(n0, n1, centers, contexts, negs, valid):
    dev = centers.device
    if valid is None:
        return (_row_counts(n0, dev, centers),
                _row_counts(n1, dev, contexts, negs))
    vk = valid[:, None].expand(negs.shape)
    return (_row_counts(n0, dev, (centers, valid)),
            _row_counts(n1, dev, (contexts, valid), (negs, vk)))


def _sg_neg_terms(syn0, syn1neg, centers, contexts, negs, lr,
                  trainable_from, counts0, counts1, valid=None):
    """One batch's (or one replica's shard's) skip-gram negative-sampling
    terms: the loss sum and the scatters of syn0 and of syn1neg (the
    contexts' first, then the negatives', JAX's order). `counts0` and `counts1` are the batch's row counts (the
    global batch's under a mesh). A delta's sign rides on its scale
    (-(a * s) and a * (-s) are the same float)."""
    v = syn0.index_select(0, centers)                          # [B,D]
    u_pos = syn1neg.index_select(0, contexts)                  # [B,D]
    u_neg = _rows(syn1neg, negs)                               # [B,K,D]
    s_pos = (v * u_pos).sum(-1)                                # [B]
    s_neg = torch.bmm(u_neg, v.unsqueeze(-1)).squeeze(-1)      # [B,K]
    lp, ln = F.logsigmoid(s_pos), F.logsigmoid(-s_neg)
    # dL/ds: σ(s)-1 for the positive, σ(s) for negatives
    c_pos = -torch.sigmoid(-s_pos)
    c_neg = torch.sigmoid(s_neg)
    if valid is None:
        loss = -(lp.sum() + ln.sum())
    else:
        loss = -((lp * valid).sum() + (ln * valid[:, None]).sum())
        c_pos = c_pos * valid
        c_neg = c_neg * valid[:, None]
    dv = c_pos[:, None] * u_pos + torch.bmm(c_neg.unsqueeze(1),
                                            u_neg).squeeze(1)
    scale0 = (lr / counts0[centers])[:, None]                  # [B,1]
    up1 = []
    if trainable_from > 0:
        # inference mode: only rows >= trainable_from learn; the output
        # table is frozen entirely (reference inferVector semantics)
        scale0 = scale0 * (centers >= trainable_from)[:, None]
    else:
        du_pos = c_pos[:, None] * v                            # [B,D]
        du_neg = c_neg[..., None] * v[:, None, :]              # [B,K,D]
        s_ctx = (lr / counts1[contexts])[:, None]
        s_negs = (lr / counts1[negs])[..., None]               # [B,K,1]
        up1 = [(contexts, du_pos * -s_ctx), (negs, du_neg * -s_negs)]
    return loss, [(centers, dv * -scale0)], up1


def _sg_neg_math(syn0, syn1neg, centers, contexts, negs, lr, trainable_from,
                 valid=None):
    """Skip-gram negative-sampling step (JAX `_sg_neg_math`): the sparse
    closed-form update of the B center rows and B·(K+1) output rows, each
    row's summed delta divided by its count in the batch. `valid` (a [B]
    0/1 mask) drops padded entries from loss, counts and updates;
    `trainable_from` > 0 trains only syn0 rows from that index on and
    freezes syn1neg. Updates both tables in place; returns (syn0,
    syn1neg, loss)."""
    counts0, counts1 = _sg_neg_counts(syn0.shape[0], syn1neg.shape[0],
                                      centers, contexts, negs, valid)
    n_eff = (centers.shape[0] if valid is None
             else valid.sum().clamp(min=1.0))
    loss, up0, up1 = _sg_neg_terms(syn0, syn1neg, centers, contexts, negs,
                                   lr, trainable_from, counts0, counts1,
                                   valid)
    _scatter(syn1neg, up1)
    _scatter(syn0, up0)
    return syn0, syn1neg, loss / n_eff


def _sg_neg_mesh(syn0, syn1neg, centers, contexts, negs, lr, trainable_from,
                 devices):
    """`_sg_neg_math` with the batch sharded over `devices` and the
    tables replicated (JAX's global-view sharded step, `_mesh_steps`):
    the row counts over the global batch; each replica's shard's row
    sums on its device; the sums added across replicas in replica order,
    then into the tables. Equal to one device up to reduction order."""
    dev = syn0.device
    counts0, counts1 = _sg_neg_counts(syn0.shape[0], syn1neg.shape[0],
                                      centers, contexts, negs, None)
    n, B = len(devices), centers.shape[0]
    sums0, sums1, losses = [], [], []
    for r, d in enumerate(devices):
        sl = shard_slice(n, r, B)
        s0, s1 = syn0.to(d), syn1neg.to(d)      # the replicated tables
        loss, up0, up1 = _sg_neg_terms(
            s0, s1, centers[sl].to(d), contexts[sl].to(d), negs[sl].to(d),
            lr.to(d), trainable_from, counts0.to(d), counts1.to(d))
        sums0.append(_scatter(torch.zeros_like(s0), up0))
        sums1.append(_scatter(torch.zeros_like(s1), up1))
        losses.append(loss)
    syn0.add_(reduce_sum(sums0, dev))
    if trainable_from <= 0:
        syn1neg.add_(reduce_sum(sums1, dev))
    return syn0, syn1neg, reduce_sum(losses, dev) / B


def _sg_neg_scan(syn0, syn1neg, centers, contexts, negs, lrs, trainable_from,
                 step=_sg_neg_math):
    """k skip-gram batches in one group (JAX `_sg_neg_scan`, a
    `lax.scan`): centers/contexts [k, B], negs [k, B, K], lrs [k], all
    on the tables' device. Returns (syn0, syn1neg, last loss)."""
    loss = None
    for i in range(centers.shape[0]):
        syn0, syn1neg, loss = step(syn0, syn1neg, centers[i], contexts[i],
                                   negs[i], lrs[i], trainable_from)
    return syn0, syn1neg, loss


def _cbow_neg_math(syn0, syn1neg, ctx, ctx_mask, centers, negs, lr,
                   trainable_from, valid=None):
    """CBOW negative-sampling step (JAX `_cbow_neg_math`): the masked
    context mean [B, 2W+1] predicts the center. `valid` and
    `trainable_from` as in `_sg_neg_math`. In place."""
    dev = syn0.device
    vecs = _rows(syn0, ctx)                                    # [B,W2,D]
    m = ctx_mask[..., None]
    M = ctx_mask.sum(1, keepdim=True).clamp(min=1.0)
    h = (vecs * m).sum(1) / M                                  # [B,D]
    u_pos = syn1neg.index_select(0, centers)
    u_neg = _rows(syn1neg, negs)                               # [B,K,D]
    s_pos = (h * u_pos).sum(-1)
    s_neg = torch.bmm(u_neg, h.unsqueeze(-1)).squeeze(-1)
    lp, ln = F.logsigmoid(s_pos), F.logsigmoid(-s_neg)
    c_pos = -torch.sigmoid(-s_pos)
    c_neg = torch.sigmoid(s_neg)
    if valid is None:
        n_eff = centers.shape[0]
        loss = -(lp.sum() + ln.sum())
        ref1 = (centers, negs)
    else:
        n_eff = valid.sum().clamp(min=1.0)
        loss = -((lp * valid).sum() + (ln * valid[:, None]).sum())
        c_pos = c_pos * valid
        c_neg = c_neg * valid[:, None]
        ref1 = ((centers, valid), (negs, valid[:, None].expand(negs.shape)))
    dh = c_pos[:, None] * u_pos + torch.bmm(c_neg.unsqueeze(1),
                                            u_neg).squeeze(1)
    # dL/dv_slot = (mask/M) * dh, per context slot
    dctx = (m / M[..., None]) * dh[:, None, :]                 # [B,W2,D]
    counts0 = _row_counts(syn0.shape[0], dev, (ctx, ctx_mask))
    counts1 = _row_counts(syn1neg.shape[0], dev, *ref1)
    scale0 = (lr / counts0[ctx])[..., None] * m                # [B,W2,1]
    if trainable_from > 0:
        scale0 = scale0 * (ctx >= trainable_from)[..., None]
    else:
        du_pos = c_pos[:, None] * h
        du_neg = c_neg[..., None] * h[:, None, :]
        s_ctr = (lr / counts1[centers])[:, None]
        s_negs = (lr / counts1[negs])[..., None]
        _scatter(syn1neg, [(centers, du_pos * -s_ctr),
                           (negs, du_neg * -s_negs)])
    _scatter(syn0, [(ctx, dctx * -scale0)])
    return syn0, syn1neg, loss / n_eff


def _hs_path_grads(h, syn1, points, codes, code_mask):
    """Shared HS math (JAX `_hs_path_grads`): dL/dh and the per-path-node
    output deltas for a batch of hidden vectors classified down Huffman
    paths [B, C]."""
    u = _rows(syn1, points)                                    # [B,C,D]
    sign = 1.0 - 2.0 * codes
    logits = torch.bmm(u, h.unsqueeze(-1)).squeeze(-1) * sign
    loss = -(F.logsigmoid(logits) * code_mask).sum()
    dlogit = -torch.sigmoid(-logits) * code_mask               # [B,C]
    coef = dlogit * sign
    dh = torch.bmm(coef.unsqueeze(1), u).squeeze(1)
    du = coef[..., None] * h[:, None, :]                       # [B,C,D]
    return loss, dh, du


def _cbow_hs_math(syn0, syn1, ctx, ctx_mask, centers, points, codes,
                  code_mask, lr, valid=None):
    """CBOW + hierarchical softmax (JAX `_cbow_hs_math`): the context mean
    classified down the center word's Huffman path. In place."""
    dev = syn0.device
    if valid is not None:
        code_mask = code_mask * valid[:, None]
    n_eff = (centers.shape[0] if valid is None
             else valid.sum().clamp(min=1.0))
    vecs = _rows(syn0, ctx)
    m = ctx_mask[..., None]
    M = ctx_mask.sum(1, keepdim=True).clamp(min=1.0)
    h = (vecs * m).sum(1) / M
    loss, dh, du = _hs_path_grads(h, syn1, points, codes, code_mask)
    dctx = (m / M[..., None]) * dh[:, None, :]
    counts0 = _row_counts(syn0.shape[0], dev, (ctx, ctx_mask))
    counts1 = _row_counts(syn1.shape[0], dev, (points, code_mask))
    scale0 = (lr / counts0[ctx])[..., None] * m
    scale1 = (lr / counts1[points])[..., None]
    _scatter(syn0, [(ctx, dctx * -scale0)])
    _scatter(syn1, [(points, du * -scale1)])
    return syn0, syn1, loss / n_eff


def _sg_hs_math(syn0, syn1, centers, points, codes, code_mask, lr,
                valid=None):
    """Skip-gram hierarchical softmax over Huffman paths (JAX
    `_sg_hs_math`; reference `SkipGram.iterateSample` HS branch). Padded
    entries (`valid` 0) are masked out of the path mask. In place."""
    dev = syn0.device
    if valid is not None:
        # padded rows index word 0's Huffman path — neutralize it fully
        code_mask = code_mask * valid[:, None]
    v = syn0.index_select(0, centers)                          # [B,D]
    loss, dv, du = _hs_path_grads(v, syn1, points, codes, code_mask)
    n_eff = (centers.shape[0] if valid is None
             else valid.sum().clamp(min=1.0))
    counts0 = _row_counts(syn0.shape[0], dev,
                          centers if valid is None else (centers, valid))
    counts1 = _row_counts(syn1.shape[0], dev, (points, code_mask))
    scale0 = (lr / counts0[centers])[:, None]
    scale1 = (lr / counts1[points])[..., None]
    _scatter(syn0, [(centers, dv * -scale0)])
    _scatter(syn1, [(points, du * -scale1)])
    return syn0, syn1, loss / n_eff


def _on_device(a, device) -> torch.Tensor:
    """A float32 copy of a table (numpy or tensor) on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=_F32, copy=True)
    return torch.tensor(np.asarray(a), dtype=_F32, device=device)


class SequenceVectors:
    """Trains an embedding table over token sequences."""

    def __init__(self, config: Optional[SequenceVectorsConfig] = None, *,
                 mesh=None, data_axis: str = "data", device="cuda", **kw):
        if config is None:
            config = SequenceVectorsConfig(**kw)
        self.conf = config
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.syn0 = None       # np.ndarray [V(+labels), D]
        self.syn1 = None       # HS inner-node table
        self.syn1neg = None    # negative-sampling output table
        self._neg_table = None
        self._rng = np.random.default_rng(config.seed)
        self._negs_rng = None   # flush-side stream (see _sample_negatives)
        self.etl_stats = None   # producer/consumer wait accounting
        # mesh-sharded training (the dl4j-spark-nlp distributed Word2Vec
        # capability): the skip-gram/neg batches shard over `data_axis`
        # of the port's `parallel.mesh.Mesh`, the tables replicate;
        # CBOW and HS run unsharded.
        self.mesh = mesh
        self.data_axis = data_axis

    # ------------------------------------------------------------- vocab
    def build_vocab(self, sequences: Iterable[List[str]]):
        self.vocab = VocabConstructor(
            min_word_frequency=self.conf.min_word_frequency).build(sequences)
        return self

    def _init_tables(self, extra_rows: int = 0):
        V = self.vocab.num_words()
        D = self.conf.vector_length
        # word2vec init: U(-0.5, 0.5)/D for syn0, zeros for output tables
        self.syn0 = ((self._rng.random((V + extra_rows, D)) - 0.5) / D
                     ).astype(np.float32)
        self.syn1neg = np.zeros((V, D), np.float32)
        max_inner = max(V, 2)
        self.syn1 = np.zeros((max_inner, D), np.float32)
        self._init_aux_tables()

    def _init_aux_tables(self):
        """Sampler + Huffman lookup state derived from the vocab. Split
        from `_init_tables` so a model warm-started from
        `WordVectorSerializer` (vocab + syn0 and zeroed output tables,
        none of this derived state) can resume `fit()` without resetting
        its trained embeddings."""
        V = self.vocab.num_words()
        D = self.syn0.shape[1]
        # guards for manually-assembled models (syn0/vocab set directly)
        if self.syn1neg is None:
            self.syn1neg = np.zeros((V, D), np.float32)
        if self.syn1 is None:
            self.syn1 = np.zeros((max(V, 2), D), np.float32)
        # deserialized vocabs carry no Huffman codes — without this, HS
        # warm-start training would be fully masked out (a silent no-op)
        if V > 1 and all(not self.vocab.element_at_index(i).codes
                         for i in range(V)):
            build_huffman(self.vocab)
        # unigram^0.75 negative-sampling distribution (word2vec standard)
        self._freqs = np.array([self.vocab.element_at_index(i).frequency
                                for i in range(V)])
        probs = self._freqs ** self.conf.unigram_power
        self._neg_cdf = np.cumsum(probs / probs.sum())
        self._neg_cdf[-1] = 1.0
        # quantized unigram table: one searchsorted at build time, O(1)
        # integer draws afterwards (the reference's negative table idea)
        tsize = max(1 << 20, 16 * V)
        self._neg_table = np.searchsorted(
            self._neg_cdf, (np.arange(tsize) + 0.5) / tsize).astype(np.int32)
        # Huffman paths as dense [V, C] tables → batch assembly is pure
        # fancy indexing
        C = max((len(self.vocab.element_at_index(i).codes)
                 for i in range(V)), default=1) or 1
        self._max_code = C
        self._hs_points = np.zeros((V, C), np.int32)
        self._hs_codes = np.zeros((V, C), np.float32)
        self._hs_mask = np.zeros((V, C), np.float32)
        for i in range(V):
            vw = self.vocab.element_at_index(i)
            L = len(vw.codes)
            if L:
                self._hs_points[i, :L] = vw.points
                self._hs_codes[i, :L] = vw.codes
                self._hs_mask[i, :L] = 1.0

    # ------------------------------------------------------- pair batching
    def _tokens_to_indices(self, tokens: Sequence[str]) -> np.ndarray:
        """Vocab lookup + frequent-word subsampling, vectorised."""
        conf = self.conf
        idx_of = self.vocab.index_of
        idxs = np.fromiter((idx_of(t) for t in tokens), np.int64, len(tokens))
        idxs = idxs[idxs >= 0]
        if conf.subsampling > 0 and self.vocab.total_word_count > 0 and len(idxs):
            f = self._freqs[idxs] / self.vocab.total_word_count
            keep_p = (np.sqrt(f / conf.subsampling) + 1) * conf.subsampling / f
            idxs = idxs[self._rng.random(len(idxs)) < keep_p]
        return idxs

    def _sequence_to_pair_arrays(self, tokens: Sequence[str]):
        """Skip-gram (center, context) arrays with the reduced-window
        trick, fully vectorised (no per-position Python loop)."""
        conf = self.conf
        idxs = self._tokens_to_indices(tokens)
        n = len(idxs)
        if n < 2:
            return None
        b = self._rng.integers(1, conf.window + 1, n)
        pos = np.arange(n)
        cs, xs = [], []
        for off in range(1, conf.window + 1):
            ok = b >= off
            left = np.nonzero(ok & (pos >= off))[0]
            cs.append(idxs[left]); xs.append(idxs[left - off])
            right = np.nonzero(ok & (pos + off < n))[0]
            cs.append(idxs[right]); xs.append(idxs[right + off])
        return (np.concatenate(cs).astype(np.int32),
                np.concatenate(xs).astype(np.int32))

    def _sequence_to_pairs(self, tokens: Sequence[str]):
        """CBOW pair lists: (center, center, ctx_indices)."""
        conf = self.conf
        idxs = self._tokens_to_indices(tokens).tolist()
        pairs = []
        for p, center in enumerate(idxs):
            bb = int(self._rng.integers(1, conf.window + 1))
            ctx = idxs[max(0, p - bb):p] + idxs[p + 1:p + bb + 1]
            if ctx:
                pairs.append((center, center, ctx))
        return pairs

    def _sample_negatives(self, B: int) -> np.ndarray:
        # own stream, not self._rng: negatives are drawn at FLUSH time
        # (consumer side) while the pair packer may be running on the
        # producer thread — one shared generator would race and break
        # sync/async determinism parity
        if self._negs_rng is None:
            self._negs_rng = np.random.default_rng(self.conf.seed + 0x5EED)
        K = max(self.conf.negative, 1)
        idx = self._negs_rng.integers(0, len(self._neg_table), (B, K))
        return self._neg_table[idx]

    # ------------------------------------------------------- device side
    def _upload(self, *arrays):
        """Each host array once to the tables' device. On a CUDA device
        the copy goes through pinned staging memory, `non_blocking`, so
        the host queues it and goes on (PyTorch's pinned allocator hands
        a staging block out again only after its copy has completed); on
        the CPU the tensor shares the array's memory (read only)."""
        out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type == "cuda":
            out = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in out]
        return out

    def _tables_to_device(self):
        self.syn0 = _on_device(self.syn0, self.device)
        self.syn1 = _on_device(self.syn1, self.device)
        self.syn1neg = _on_device(self.syn1neg, self.device)

    def _tables_to_host(self):
        for name in ("syn0", "syn1", "syn1neg"):
            t = getattr(self, name)
            if isinstance(t, torch.Tensor):
                setattr(self, name, t.detach().cpu().numpy())

    def _sg_step(self, B: int):
        """The skip-gram/neg step for a batch of B: sharded over the
        mesh's data axis when B divides evenly (a ragged tail runs
        unsharded; the replicated tables make that transparent)."""
        if self.mesh is None:
            return _sg_neg_math
        devices = self.mesh.axis_devices(self.data_axis)
        if B % len(devices):
            return _sg_neg_math
        return functools.partial(_sg_neg_mesh, devices=devices)

    def _flush_sg_neg(self, centers, contexts, lr):
        negs = self._sample_negatives(len(centers))
        c, x, n = self._upload(centers, contexts, negs)
        self.syn0, self.syn1neg, loss = self._sg_step(len(centers))(
            self.syn0, self.syn1neg, c, x, n, _scalar(lr, self.device),
            self._trainable_from)
        return loss

    def _flush_sg_neg_multi(self, centers, contexts, lrs):
        """centers/contexts: [k,B]; lrs: [k]. One copy of each array to
        the device, k steps, no host sync — the loss stays a device
        tensor."""
        k, B = centers.shape
        negs = self._sample_negatives(k * B).reshape(k, B, -1)
        c, x, n, l = self._upload(centers, contexts, negs,
                                  lrs.astype(np.float32))
        self.syn0, self.syn1neg, loss = _sg_neg_scan(
            self.syn0, self.syn1neg, c, x, n, l, self._trainable_from,
            self._sg_step(B))
        return loss

    def _pack_cbow(self, pairs):
        # +1 slot so a DM label row fits even at the max reduced window
        W2 = 2 * self.conf.window + 1
        B = len(pairs)
        ctx = np.zeros((B, W2), np.int32)
        mask = np.zeros((B, W2), np.float32)
        centers = np.zeros((B,), np.int32)
        for i, (center, _, cs) in enumerate(pairs):
            centers[i] = center
            cs = cs[:W2]
            ctx[i, :len(cs)] = cs
            mask[i, :len(cs)] = 1.0
        return ctx, mask, centers

    def _flush_cbow_neg(self, pairs, lr):
        ctx, mask, centers = self._pack_cbow(pairs)
        negs = self._sample_negatives(len(pairs))
        ctx, mask, centers, negs = self._upload(ctx, mask, centers, negs)
        self.syn0, self.syn1neg, loss = _cbow_neg_math(
            self.syn0, self.syn1neg, ctx, mask, centers, negs,
            _scalar(lr, self.device), self._trainable_from)
        return loss

    def _flush_cbow_hs(self, pairs, lr):
        ctx, mask, centers = self._pack_cbow(pairs)
        up = self._upload(ctx, mask, centers, self._hs_points[centers],
                          self._hs_codes[centers], self._hs_mask[centers])
        self.syn0, self.syn1, loss = _cbow_hs_math(
            self.syn0, self.syn1, *up, _scalar(lr, self.device))
        return loss

    def _flush_sg_hs(self, centers, contexts, lr):
        # Huffman paths precomputed as [V, C] tables → pure array indexing
        up = self._upload(centers, self._hs_points[contexts],
                          self._hs_codes[contexts], self._hs_mask[contexts])
        self.syn0, self.syn1, loss = _sg_hs_math(
            self.syn0, self.syn1, *up, _scalar(lr, self.device))
        return loss

    # ----------------------------------------------------------------- fit
    def fit(self, sequences, extra_rows: int = 0, trainable_from: int = 0,
            pair_hook=None, total_words: Optional[int] = None):
        """Train. `sequences`: iterable (re-iterable across epochs) of
        token lists. Returns self, its tables numpy arrays again."""
        conf = self.conf
        if self.vocab is None:
            self.build_vocab(sequences)
        warm_start = self.syn0 is not None and self._neg_table is None
        if self.syn0 is None or (not warm_start and extra_rows and
                                 self.syn0.shape[0] == self.vocab.num_words()):
            self._init_tables(extra_rows)
        elif warm_start:
            # warm start (deserialized model): vocab + syn0 exist but the
            # sampler/Huffman state was never built. Keep the trained
            # embeddings; label rows (ParagraphVectors) are appended, not
            # re-randomized with the rest of the table.
            if extra_rows and self.syn0.shape[0] == self.vocab.num_words():
                D = self.syn0.shape[1]
                new_rows = ((self._rng.random((extra_rows, D)) - 0.5) / D
                            ).astype(np.float32)
                self.syn0 = np.concatenate([np.asarray(self.syn0), new_rows])
            self._init_aux_tables()
        self._trainable_from = trainable_from

        use_hs = conf.use_hierarchic_softmax or conf.negative <= 0
        array_path = not conf.cbow  # skip-gram variants carry index arrays
        sg_flush = self._flush_sg_hs if use_hs else self._flush_sg_neg
        cbow_flush = self._flush_cbow_hs if use_hs else self._flush_cbow_neg

        # lr decays linearly over the full corpus; when the training
        # corpus differs from the vocab-construction corpus (graph walks
        # vs degree sequences), the caller passes the real size. For
        # in-memory corpora the exact size is one cheap pass — this also
        # keeps warm-started models (whose deserialized vocab has no real
        # counts) from collapsing the lr schedule immediately.
        if total_words is None and isinstance(sequences, (list, tuple)):
            total_words = sum(len(s) for s in sequences)
        if total_words is None:
            total_words = self.vocab.total_word_count
        total_words = max(total_words * conf.epochs, 1)
        self.last_loss = 0.0
        self.etl_stats = None   # per-fit accounting — never stale
        # fused flush group: skip-gram/neg drains k batches a group; HS
        # and iterations>1 keep per-batch flushes
        k_group = (max(1, conf.steps_per_flush)
                   if (array_path and not use_hs and conf.iterations == 1)
                   else 1)
        self._tables_to_device()
        try:
            if array_path:
                items = self._pair_work_items(sequences, pair_hook,
                                              total_words, k_group)
                # pair_hook runs arbitrary user code against self — keep
                # it on the caller's thread
                if conf.async_producer and pair_hook is None:
                    items = self._produce_async(items)
                loss_dev = self._drain_items(items, sg_flush,
                                             conf.iterations)
            else:
                loss_dev = self._fit_cbow_list_path(
                    sequences, pair_hook, total_words, cbow_flush)
            if loss_dev is not None:   # the one read of the loss
                self.last_loss = float(loss_dev)
        finally:
            self._tables_to_host()
        return self

    def _pair_work_items(self, sequences, pair_hook, total_words, k_group):
        """Generator of flush work items for the skip-gram array path:
        ("group", c[k,B], x[k,B], lrs[k]) fused groups, ("single",
        c[B], x[B], lr) full batches, ("tail", c[<B], x[<B], lr) one
        ragged flush per epoch."""
        conf = self.conf
        B = conf.batch_size
        words_seen = 0
        lr_prev = conf.learning_rate
        for epoch in range(conf.epochs):
            abuf_c, abuf_x, abuf_n = [], [], 0
            for si, tokens in enumerate(sequences):
                frac = words_seen / total_words
                lr = max(conf.learning_rate * (1.0 - frac),
                         conf.min_learning_rate)
                words_seen += len(tokens)
                if pair_hook is not None:
                    new = pair_hook(self, si, tokens)
                    if isinstance(new, list):
                        if not new:
                            continue
                        new = (np.fromiter((p[0] for p in new), np.int32,
                                           len(new)),
                               np.fromiter((p[1] for p in new), np.int32,
                                           len(new)))
                else:
                    new = self._sequence_to_pair_arrays(tokens)
                if new is None:
                    continue
                abuf_c.append(new[0])
                abuf_x.append(new[1])
                abuf_n += len(new[0])
                while abuf_n >= k_group * B:
                    cs = np.concatenate(abuf_c)
                    xs = np.concatenate(abuf_x)
                    take = k_group * B
                    batch_c, rest_c = cs[:take], cs[take:]
                    batch_x, rest_x = xs[:take], xs[take:]
                    abuf_c, abuf_x, abuf_n = [rest_c], [rest_x], len(rest_c)
                    if k_group > 1:
                        # lr interpolated across the group — same decay
                        # granularity the per-batch path would apply
                        lrs = np.linspace(lr_prev, lr, k_group,
                                          dtype=np.float32)
                        yield ("group", batch_c.reshape(k_group, B),
                               batch_x.reshape(k_group, B), lrs)
                    else:
                        yield ("single", batch_c, batch_x, lr)
                    lr_prev = lr
            tail_lr = max(conf.learning_rate * (1 - words_seen / total_words),
                          conf.min_learning_rate)
            if abuf_n:
                cs = np.concatenate(abuf_c)
                xs = np.concatenate(abuf_x)
                # drain full-B batches, then one ragged tail flush
                while len(cs) >= B:
                    yield ("single", cs[:B], xs[:B], tail_lr)
                    cs, xs = cs[B:], xs[B:]
                if len(cs):
                    yield ("tail", cs, xs, tail_lr)

    def _produce_async(self, items):
        """Run the work-item generator on a producer thread through a
        bounded queue (AsyncSequencer, `SequenceVectors.java:288`). The
        producer touches only numpy; this (consumer) thread does the
        copies and launches. Wait accounting lands in `self.etl_stats`:
        consumer_wait_ms is time the device-feeding side starved for
        host packing (the number to drive to ~0), producer_wait_ms is
        host time absorbed by the queue bound while the device was busy
        (healthy)."""
        import queue as _queue
        import threading

        q = _queue.Queue(maxsize=max(1, self.conf.producer_queue_depth))
        stats = {"producer_wait_ms": 0.0, "consumer_wait_ms": 0.0,
                 "mode": "async"}
        self.etl_stats = stats
        DONE = object()
        stop = threading.Event()   # consumer abandoned (flush raised)

        def produce():
            try:
                for item in items:
                    t0 = time.perf_counter()
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.25)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
                    stats["producer_wait_ms"] += (
                        (time.perf_counter() - t0) * 1e3)
                q.put(DONE)
            except BaseException as e:   # surface in the consumer
                q.put(("__error__", e))

        t = threading.Thread(target=produce, daemon=True,
                             name="sequencevectors-producer")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                stats["consumer_wait_ms"] += (time.perf_counter() - t0) * 1e3
                if item is DONE:
                    break
                if isinstance(item, tuple) and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            # a raising flush closes this generator mid-iteration: wake
            # the producer out of its bounded put so the thread (and its
            # queued batches) cannot leak
            stop.set()
            t.join()

    def _drain_items(self, items, sg_flush, iterations):
        loss_dev = None
        if self.etl_stats is None:
            self.etl_stats = {"mode": "sync"}
        for kind, c, x, lr in items:
            if kind == "group":
                loss_dev = self._flush_sg_neg_multi(c, x, lr)
            else:   # "single" and the ragged "tail" alike
                for _ in range(iterations):
                    loss_dev = sg_flush(c, x, lr)
        return loss_dev

    def _fit_cbow_list_path(self, sequences, pair_hook, total_words,
                            cbow_flush):
        conf = self.conf
        B = conf.batch_size
        words_seen = 0
        loss_dev = None
        for epoch in range(conf.epochs):
            lbuf = []
            for si, tokens in enumerate(sequences):
                frac = words_seen / total_words
                lr = max(conf.learning_rate * (1.0 - frac),
                         conf.min_learning_rate)
                words_seen += len(tokens)
                if pair_hook is not None:
                    new = pair_hook(self, si, tokens)
                else:
                    new = self._sequence_to_pairs(tokens)
                lbuf.extend(new)
                while len(lbuf) >= B:
                    batch, lbuf = lbuf[:B], lbuf[B:]
                    for _ in range(conf.iterations):
                        loss_dev = cbow_flush(batch, lr)
            tail_lr = max(conf.learning_rate * (1 - words_seen / total_words),
                          conf.min_learning_rate)
            if lbuf:
                for _ in range(conf.iterations):
                    loss_dev = cbow_flush(lbuf, tail_lr)
        return loss_dev

    # ------------------------------------------------------------- queries
    def get_word_vector(self, word: str):
        i = self.vocab.index_of(word)
        return None if i < 0 else np.asarray(self.syn0[i])

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def _unit_table(self) -> torch.Tensor:
        """The vocabulary's rows of syn0, each scaled to unit length, as
        float64 on the model's device."""
        t = torch.as_tensor(np.asarray(self.syn0[:self.vocab.num_words()]),
                            device=self.device).to(torch.float64)
        return t / t.norm(dim=1, keepdim=True).clamp(min=1e-9)

    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(np.dot(v1, v2) / denom) if denom > 0 else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """The `top_n` words of highest cosine similarity, ranked on the
        model's device in float64 (so the card and the CPU rank alike)."""
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            vec, exclude = np.asarray(word_or_vec), set()
        if vec is None:
            return []
        q = torch.as_tensor(np.asarray(vec), device=self.device).to(
            torch.float64)
        q = q / q.norm().clamp(min=1e-9)
        sims = (self._unit_table() @ q).cpu().numpy()
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out
