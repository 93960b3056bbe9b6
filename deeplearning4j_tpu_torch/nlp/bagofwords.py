"""Bag-of-words vectorizers: counts and TF-IDF.

Reference: `bagofwords/vectorizer/BagOfWordsVectorizer.java` and
`TfidfVectorizer.java` — fit a vocabulary over a corpus, then transform
documents to dense vocab-sized vectors.

The port's own copy of `deeplearning4j_tpu/nlp/bagofwords.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class CountVectorizer:
    """Term-count vectors (reference BagOfWordsVectorizer)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.vocab: Optional[VocabCache] = None

    def _tokens(self, text: str) -> List[str]:
        return self.tokenizer_factory.create(text).get_tokens()

    def _fit_tokens(self, seqs: List[List[str]]):
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False).build(seqs)

    def fit(self, corpus: Iterable[str]):
        self._fit_tokens([self._tokens(t) for t in corpus])
        return self

    def _vector_from_tokens(self, tokens: List[str]) -> np.ndarray:
        vec = np.zeros((self.vocab.num_words(),), np.float32)
        for tok in tokens:
            i = self.vocab.index_of(tok)
            if i >= 0:
                vec[i] += 1.0
        return vec

    def transform(self, text: str) -> np.ndarray:
        return self._vector_from_tokens(self._tokens(text))

    def fit_transform(self, corpus: Iterable[str]) -> np.ndarray:
        seqs = [self._tokens(t) for t in corpus]  # tokenize ONCE
        self._fit_tokens(seqs)
        return np.stack([self._vector_from_tokens(s) for s in seqs])


class TfidfVectorizer(CountVectorizer):
    """TF-IDF weighting (reference TfidfVectorizer: idf = log(N/df))."""

    def _fit_tokens(self, seqs: List[List[str]]):
        super()._fit_tokens(seqs)
        V = self.vocab.num_words()
        df = np.zeros((V,), np.float64)
        for tokens in seqs:
            seen = {self.vocab.index_of(t) for t in tokens}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        n_docs = max(len(seqs), 1)
        self.idf = np.log(n_docs / np.clip(df, 1.0, None)).astype(np.float32)

    def _vector_from_tokens(self, tokens: List[str]) -> np.ndarray:
        counts = super()._vector_from_tokens(tokens)
        total = counts.sum()
        tf = counts / total if total > 0 else counts
        return tf * self.idf
