"""GloVe embeddings (counterpart of `deeplearning4j_tpu/nlp/glove.py`).

Reference: `models/glove/Glove.java` + `AbstractCoOccurrences.java`:
windowed co-occurrence counting pass, then AdaGrad descent on the
weighted least-squares objective f(X_ij)(w_i·w̃_j + b_i + b̃_j − log X_ij)².

Co-occurrence counting on the host (sparse dict), then minibatch AdaGrad
steps over the non-zero cells on `device`: the closed-form gradients of
the weighted squared error (what JAX's `value_and_grad` computes),
scattered into dense gradients, and a dense AdaGrad update, in place.
The init and the per-epoch shuffle are numpy draws in JAX's order; the
cells go to the device once a fit and the shuffle once an epoch, and the
loss is read once, after the last step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)


def _glove_step(w, wt, b, bt, gw, gwt, gb, gbt, rows, cols, logx, weight, lr):
    """One AdaGrad step on a batch of non-zero co-occurrence cells (JAX
    `_glove_step`), tables and accumulators updated in place. Returns
    the batch's loss (a device tensor)."""
    wi = w.index_select(0, rows)
    wj = wt.index_select(0, cols)
    pred = (wi * wj).sum(-1) + b.index_select(0, rows) + bt.index_select(
        0, cols)
    diff = pred - logx
    loss = (weight * diff ** 2).sum()
    g = weight * (2.0 * diff)                      # dloss/dpred
    gs = (torch.zeros_like(w).index_add_(0, rows, g[:, None] * wj),
          torch.zeros_like(wt).index_add_(0, cols, g[:, None] * wi),
          torch.zeros_like(b).index_add_(0, rows, g),
          torch.zeros_like(bt).index_add_(0, cols, g))
    for p, grad, acc in zip((w, wt, b, bt), gs, (gw, gwt, gb, gbt)):
        acc.add_(grad * grad)
        p.sub_(lr * grad / torch.sqrt(acc + 1e-8))
    return loss


class Glove(SequenceVectors):
    def __init__(self, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.05,
                 epochs: int = 5, x_max: float = 100.0, alpha: float = 0.75,
                 batch_size: int = 8192, symmetric: bool = True,
                 seed: int = 42, device="cuda"):
        super().__init__(SequenceVectorsConfig(
            vector_length=layer_size, window=window,
            min_word_frequency=min_word_frequency,
            learning_rate=learning_rate, epochs=epochs,
            batch_size=batch_size, seed=seed), device=device)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric

    def _count_cooccurrences(self, sequences) -> Dict[Tuple[int, int], float]:
        """Windowed 1/d-weighted counts (reference
        `AbstractCoOccurrences.java`)."""
        counts: Dict[Tuple[int, int], float] = {}
        w = self.conf.window
        for tokens in sequences:
            idxs = [self.vocab.index_of(t) for t in tokens]
            idxs = [i for i in idxs if i >= 0]
            for pos, i in enumerate(idxs):
                for off in range(1, w + 1):
                    if pos + off >= len(idxs):
                        break
                    j = idxs[pos + off]
                    inc = 1.0 / off
                    counts[(i, j)] = counts.get((i, j), 0.0) + inc
                    if self.symmetric:
                        counts[(j, i)] = counts.get((j, i), 0.0) + inc
        return counts

    def fit(self, sequences, **_):
        sequences = list(sequences)
        self.build_vocab(sequences)
        V, D = self.vocab.num_words(), self.conf.vector_length
        rng = self._rng
        counts = self._count_cooccurrences(sequences)
        items = list(counts.items())
        rows = np.array([ij[0] for ij, _ in items], np.int32)
        cols = np.array([ij[1] for ij, _ in items], np.int32)
        xs = np.array([x for _, x in items], np.float32)
        logx = np.log(xs)
        weight = np.minimum((xs / self.x_max) ** self.alpha, 1.0).astype(np.float32)

        scale = 0.5 / D
        w = (rng.random((V, D), np.float32) - 0.5) * 2 * scale
        wt = (rng.random((V, D), np.float32) - 0.5) * 2 * scale
        dev = self.device
        w, wt = (torch.tensor(a, device=dev) for a in (w, wt))
        b = torch.zeros(V, dtype=torch.float32, device=dev)
        bt = torch.zeros_like(b)
        gw, gwt, gb, gbt = (torch.ones_like(t) for t in (w, wt, b, bt))
        rows_d, cols_d, logx_d, weight_d = (
            torch.tensor(a, device=dev) for a in (rows, cols, logx, weight))
        lr = float(np.float32(self.conf.learning_rate))

        B = self.conf.batch_size
        n = len(items)
        loss, n_last = None, 1
        for _ in range(self.conf.epochs):
            order = torch.tensor(rng.permutation(n), device=dev)
            for s in range(0, n, B):
                sel = order[s:s + B]
                loss = _glove_step(w, wt, b, bt, gw, gwt, gb, gbt,
                                   rows_d[sel], cols_d[sel], logx_d[sel],
                                   weight_d[sel], lr)
                n_last = max(sel.numel(), 1)
        self.last_loss = 0.0 if loss is None else float(loss) / n_last
        # final embeddings = w + wt (GloVe paper / reference convention)
        self.syn0 = w.cpu().numpy() + wt.cpu().numpy()
        self.syn1neg = np.zeros_like(self.syn0)
        self.syn1 = np.zeros_like(self.syn0)
        return self
