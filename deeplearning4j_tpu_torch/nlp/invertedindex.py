"""Inverted index over tokenized documents.

Reference: `text/invertedindex/InvertedIndex.java` (the Lucene-backed
`LuceneInvertedIndex` implementation): word → documents containing it,
document → word list, batch/mini-batch sampling for embedding trainers.
Here: plain in-memory postings (word index → sorted doc ids + term
frequencies) built on the same VocabCache vocabulary the embedding
engines use — no Lucene; the TPU pipeline consumes fixed-shape batches,
so the index's job is lookup + corpus statistics, not on-disk search.

The port's own copy of `deeplearning4j_tpu/nlp/invertedindex.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InvertedIndex:
    def __init__(self, vocab: Optional[VocabCache] = None):
        self.vocab = vocab
        self._docs: List[List[str]] = []
        self._postings: Dict[str, Dict[int, int]] = defaultdict(dict)
        self._doc_labels: Dict[int, List[str]] = {}

    # ------------------------------------------------------------- building
    def add_word_to_doc(self, doc_id: int, word: str):
        """Reference `addWordToDoc`."""
        while len(self._docs) <= doc_id:
            self._docs.append([])
        self._docs[doc_id].append(word)
        self._postings[word][doc_id] = self._postings[word].get(doc_id, 0) + 1

    def add_doc(self, tokens: Sequence[str],
                labels: Optional[List[str]] = None) -> int:
        """Reference `addWordsToDoc`; returns the new doc id."""
        doc_id = len(self._docs)
        self._docs.append(list(tokens))
        for t in tokens:
            self._postings[t][doc_id] = self._postings[t].get(doc_id, 0) + 1
        if labels:
            self._doc_labels[doc_id] = list(labels)
        return doc_id

    def index(self, documents: Iterable[Sequence[str]]):
        for tokens in documents:
            self.add_doc(tokens)
        return self

    # -------------------------------------------------------------- queries
    def document(self, doc_id: int) -> List[str]:
        """Reference `document(index)` — the token list."""
        return list(self._docs[doc_id])

    def documents(self, word: str) -> List[int]:
        """Reference `documents(vocabWord)` — sorted doc ids containing
        the word."""
        return sorted(self._postings.get(word, {}))

    def doc_labels(self, doc_id: int) -> List[str]:
        return list(self._doc_labels.get(doc_id, []))

    def term_frequency(self, word: str, doc_id: int) -> int:
        return self._postings.get(word, {}).get(doc_id, 0)

    def document_frequency(self, word: str) -> int:
        return len(self._postings.get(word, {}))

    def total_words(self) -> int:
        """Reference `totalWords()`."""
        return sum(len(d) for d in self._docs)

    def num_documents(self) -> int:
        return len(self._docs)

    def words(self) -> List[str]:
        return sorted(self._postings)

    # ---------------------------------------------------- trainer interface
    def batch_doc_ids(self, batch_size: int) -> Iterable[List[int]]:
        """Mini-batch doc-id slices (the role of the reference's
        `batchIter`/miniBatchSize machinery feeding SequenceVectors)."""
        ids = list(range(len(self._docs)))
        for i in range(0, len(ids), batch_size):
            yield ids[i:i + batch_size]

    def eachDocWithLabels(self) -> Iterable[Tuple[List[str], List[str]]]:
        for i in range(len(self._docs)):
            yield self.document(i), self.doc_labels(i)

    def __iter__(self):
        return iter(self._docs)
