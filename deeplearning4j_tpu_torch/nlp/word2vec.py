"""Word2Vec (counterpart of `deeplearning4j_tpu/nlp/word2vec.py`).

Reference: `models/word2vec/Word2Vec.java:82` (Builder) — a thin,
configured front-end over SequenceVectors with a tokenizer + sentence
iterator pipeline. `fit()` tokenises the corpus once into token
sequences and drives the SequenceVectors engine on `device`.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    CollectionSentenceIterator,
    SentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    """skip-gram / CBOW word embeddings (reference Word2Vec builder
    options map 1:1 onto the constructor kwargs: layerSize→
    vector_length, windowSize→window, minWordFrequency, negativeSample→
    negative, useHierarchicSoftmax, sampling→subsampling, workers→
    (absorbed by device batching), batchSize→batch_size)."""

    def __init__(self,
                 sentence_iterator: Union[SentenceIterator, Iterable[str], None] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 layer_size: int = 100,
                 window_size: int = 5,
                 min_word_frequency: int = 1,
                 negative_sample: int = 5,
                 use_hierarchic_softmax: bool = False,
                 sampling: float = 0.0,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 epochs: int = 1,
                 iterations: int = 1,
                 batch_size: int = 2048,
                 seed: int = 42,
                 cbow: bool = False,
                 device="cuda"):
        super().__init__(SequenceVectorsConfig(
            vector_length=layer_size, window=window_size,
            min_word_frequency=min_word_frequency, negative=negative_sample,
            use_hierarchic_softmax=use_hierarchic_softmax,
            subsampling=sampling, learning_rate=learning_rate,
            min_learning_rate=min_learning_rate, epochs=epochs,
            iterations=iterations, batch_size=batch_size, seed=seed,
            cbow=cbow), device=device)
        if sentence_iterator is not None and not isinstance(sentence_iterator,
                                                            SentenceIterator):
            sentence_iterator = CollectionSentenceIterator(sentence_iterator)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self._sequences: Optional[List[List[str]]] = None

    def _tokenize_corpus(self) -> List[List[str]]:
        if self._sequences is None:
            if self.sentence_iterator is None:
                raise ValueError("Word2Vec needs a sentence iterator / corpus")
            self._sequences = [
                self.tokenizer_factory.create(s).get_tokens()
                for s in self.sentence_iterator
            ]
        return self._sequences

    def fit(self, sequences=None, **kw):
        if sequences is None:
            sequences = self._tokenize_corpus()
        return super().fit(sequences, **kw)


def load_packaged_word2vec(device="cuda"):
    """The packaged doc-trained skip-gram vectors (the JAX package's
    `zoo/weights/word2vec_docs.bin`, Google binary format, read in
    place) through the full verification path: the port's
    `zoo.base.packaged_weight` manifest lookup → sha256 check →
    `WordVectorSerializer.read_binary` onto `device`. Raises if the
    artifact is missing or fails its checksum (never silently loads an
    unverifiable file)."""
    import hashlib

    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
    from deeplearning4j_tpu_torch.zoo import base as zoo_base

    device = resolve_device(device)
    name = "word2vec_docs.bin"
    path, expected = zoo_base.packaged_weight(name)
    if path is None:
        raise FileNotFoundError(
            f"{name} is not a packaged artifact (no manifest entry); "
            "regenerate with tests/make_word2vec_pretrained.py")
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    if sha != expected:
        raise ValueError(
            f"{name} checksum mismatch (got {sha[:12]}…, manifest "
            f"{expected[:12]}…) — refusing to load")
    return WordVectorSerializer.read_binary(path, device=device)
