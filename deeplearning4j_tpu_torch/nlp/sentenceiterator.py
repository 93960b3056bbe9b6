"""Sentence / document iterators.

Reference: `text/sentenceiterator/*` (BasicLineIterator,
CollectionSentenceIterator, FileSentenceIterator, SentencePreProcessor)
and `text/documentiterator/*` (LabelledDocument, LabelAwareIterator,
LabelsSource) — the corpus-side protocol every embedding model
consumes.

The port's own copy of `deeplearning4j_tpu/nlp/sentenceiterator.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """Reference `SentenceIterator.java`: nextSentence/hasNext/reset +
    optional preprocessor."""

    def __init__(self):
        self.preprocessor: Optional[SentencePreProcessor] = None

    def set_pre_processor(self, pre: SentencePreProcessor):
        self.preprocessor = pre
        return self

    def _apply(self, s: str) -> str:
        return self.preprocessor.pre_process(s) if self.preprocessor else s

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sentence(self) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._idx = 0

    def has_next(self):
        return self._idx < len(self._sentences)

    def next_sentence(self):
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)

    def reset(self):
        self._idx = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference
    `BasicLineIterator.java`)."""

    def __init__(self, path):
        super().__init__()
        self.path = Path(path)
        self._fh = None

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8")
        self._peek = None

    def has_next(self):
        if self._fh is None:
            self.reset()
        if self._peek is None:
            line = self._fh.readline()
            self._peek = line if line else False
        return self._peek is not False

    def next_sentence(self):
        if not self.has_next():
            raise StopIteration
        s = self._peek.rstrip("\n")
        self._peek = None
        return self._apply(s)


class FileSentenceIterator(SentenceIterator):
    """Every file under a directory, line by line (reference
    `FileSentenceIterator.java`)."""

    def __init__(self, root):
        super().__init__()
        self.root = Path(root)
        self.reset()

    def reset(self):
        self._files = sorted(p for p in self.root.rglob("*") if p.is_file())
        self._lines: List[str] = []
        self._fidx = 0

    def has_next(self):
        while not self._lines and self._fidx < len(self._files):
            self._lines = self._files[self._fidx].read_text(
                encoding="utf-8", errors="replace").splitlines()
            self._fidx += 1
        return bool(self._lines)

    def next_sentence(self):
        if not self.has_next():
            raise StopIteration
        return self._apply(self._lines.pop(0))


# ---------------------------------------------------------------- documents
class LabelledDocument:
    """Reference `documentiterator/LabelledDocument.java`."""

    def __init__(self, content: str, labels: Optional[List[str]] = None):
        self.content = content
        self.labels = labels or []


class LabelAwareIterator:
    """Reference `documentiterator/LabelAwareIterator.java`."""

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)
        self._idx = 0

    def has_next(self):
        return self._idx < len(self._docs)

    def next_document(self):
        d = self._docs[self._idx]
        self._idx += 1
        return d

    def reset(self):
        self._idx = 0
