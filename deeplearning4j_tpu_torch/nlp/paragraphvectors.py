"""ParagraphVectors (doc2vec): DM and DBOW (counterpart of
`deeplearning4j_tpu/nlp/paragraphvectors.py`).

Reference: `models/paragraphvectors/ParagraphVectors.java` (1,461 LoC)
with sequence learning algorithms `DM.java` / `DBOW.java` and
`inferVector` for unseen documents.

The port, as JAX's, reuses the SequenceVectors engine with the embedding
table EXTENDED by one row per document label (label rows live at
indices >= vocab size). DBOW pairs the label row with every word of the
document (label predicts words, reference DBOW semantics); DM adds the
label row into the CBOW context mean. `infer_vector` freezes all
word/label rows (`trainable_from`) and gradient-trains only the new
document's row — the same frozen-tables inference the reference does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import numpy as np

from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    LabelAwareIterator,
    LabelledDocument,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class ParagraphVectors(SequenceVectors):
    def __init__(self,
                 documents: Union[LabelAwareIterator, Iterable[LabelledDocument], None] = None,
                 tokenizer_factory=None,
                 layer_size: int = 100,
                 window_size: int = 5,
                 min_word_frequency: int = 1,
                 negative_sample: int = 5,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 epochs: int = 1,
                 batch_size: int = 2048,
                 seed: int = 42,
                 dm: bool = False,
                 device="cuda"):
        super().__init__(SequenceVectorsConfig(
            vector_length=layer_size, window=window_size,
            min_word_frequency=min_word_frequency, negative=negative_sample,
            learning_rate=learning_rate, min_learning_rate=min_learning_rate,
            epochs=epochs, batch_size=batch_size, seed=seed, cbow=dm),
            device=device)
        if documents is not None and not isinstance(documents, LabelAwareIterator):
            documents = SimpleLabelAwareIterator(documents)
        self.documents = documents
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.dm = dm
        self.labels: List[str] = []
        self._label_index: Dict[str, int] = {}
        self._doc_tokens: List[List[str]] = []

    # ---------------------------------------------------------------- corpus
    def _prepare(self):
        if self._doc_tokens:
            return
        self._doc_label_idx: List[int] = []  # sequence → label row (labels may repeat)
        for doc in self.documents:
            toks = self.tokenizer_factory.create(doc.content).get_tokens()
            label = doc.labels[0] if doc.labels else f"DOC_{len(self.labels)}"
            if label not in self._label_index:
                self._label_index[label] = len(self.labels)
                self.labels.append(label)
            self._doc_label_idx.append(self._label_index[label])
            self._doc_tokens.append(toks)

    def _label_row(self, label_idx: int) -> int:
        return self.vocab.num_words() + label_idx

    # ------------------------------------------------------------------ fit
    def fit(self, *a, **kw):
        self._prepare()
        self.build_vocab(self._doc_tokens)

        def pair_hook(sv, seq_idx, tokens):
            row = self._label_row(self._doc_label_idx[seq_idx])
            if self.dm:
                # DM: label row joins every CBOW context window
                pairs = sv._sequence_to_pairs(tokens)
                return [(center, center, ctx + [row]) for center, _, ctx in pairs]
            # DBOW: label row predicts each word (reference DBOW.java)
            idxs = [self.vocab.index_of(t) for t in tokens]
            return [(row, i, []) for i in idxs if i >= 0]

        return super().fit(self._doc_tokens, extra_rows=len(self.labels),
                           pair_hook=pair_hook)

    # ------------------------------------------------------------- queries
    def get_doc_vector(self, label: str):
        i = self._label_index.get(label)
        return None if i is None else np.asarray(self.syn0[self._label_row(i)])

    def similarity_doc(self, l1: str, l2: str) -> float:
        v1, v2 = self.get_doc_vector(l1), self.get_doc_vector(l2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(np.dot(v1, v2) / denom) if denom > 0 else 0.0

    def infer_vector(self, text: str, steps: int = 10,
                     learning_rate: float = 0.01):
        """Train ONE new row against frozen tables (reference
        `inferVector`)."""
        tokens = self.tokenizer_factory.create(text).get_tokens()
        V = self.vocab.num_words()
        new_row = self.syn0.shape[0]
        D = self.conf.vector_length
        init = ((self._rng.random((1, D)) - 0.5) / D).astype(np.float32)
        self.syn0 = np.concatenate([np.asarray(self.syn0), init], axis=0)

        def pair_hook(sv, seq_idx, toks):
            idxs = [self.vocab.index_of(t) for t in toks]
            return [(new_row, i, []) for i in idxs if i >= 0]

        saved_conf = self.conf
        import dataclasses as _dc
        self.conf = _dc.replace(saved_conf, epochs=steps,
                                learning_rate=learning_rate, cbow=False)
        try:
            super().fit([tokens], pair_hook=pair_hook, trainable_from=new_row)
        finally:
            self.conf = saved_conf
        vec = np.asarray(self.syn0[new_row]).copy()
        self.syn0 = np.asarray(self.syn0[:new_row])  # pop the scratch row
        return vec
