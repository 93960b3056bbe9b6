"""CnnSentenceDataSetIterator — sentences → padded word-vector tensors
for CNN sentence classification (counterpart of
`deeplearning4j_tpu/nlp/iterator.py`; host numpy, yielding the port's
`datasets.dataset.DataSet`).

Reference: `iterator/CnnSentenceDataSetIterator.java` (516 LoC): each
sentence becomes a [1, maxLength, vectorSize] image-like tensor of
stacked word vectors, zero-padded + masked to the batch max length.
Output here is NHWC [B, maxLen, D, 1] (TPU layout) with a [B, maxLen]
feature mask.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class CnnSentenceDataSetIterator:
    def __init__(self, sentences: Sequence[str], labels: Sequence[int],
                 word_vectors: SequenceVectors, num_classes: int,
                 batch_size: int = 32, max_length: int = 64,
                 tokenizer_factory=None):
        assert len(sentences) == len(labels)
        self.sentences = list(sentences)
        self.labels = list(labels)
        self.wv = word_vectors
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.max_length = max_length
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.sentences)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()

    def next(self) -> DataSet:
        lo = self._pos
        hi = min(lo + self.batch_size, len(self.sentences))
        self._pos = hi
        D = self.wv.conf.vector_length
        batch_tokens = []
        for s in self.sentences[lo:hi]:
            toks = [t for t in self.tokenizer_factory.create(s).get_tokens()
                    if self.wv.has_word(t)][:self.max_length]
            batch_tokens.append(toks)
        L = max((len(t) for t in batch_tokens), default=1) or 1
        B = hi - lo
        feats = np.zeros((B, L, D, 1), np.float32)
        fmask = np.zeros((B, L), np.float32)
        labels = np.zeros((B, self.num_classes), np.float32)
        for bi, toks in enumerate(batch_tokens):
            for ti, tok in enumerate(toks):
                feats[bi, ti, :, 0] = self.wv.get_word_vector(tok)
            fmask[bi, :len(toks)] = 1.0
            labels[bi, self.labels[lo + bi]] = 1.0
        return DataSet(feats, labels, features_mask=fmask)
