"""Document iterators.

Reference: `text/documentiterator/` — `DocumentIterator.java` (stream
per document), `FileDocumentIterator.java` (one file = one document),
`FileLabelAwareIterator.java` (subdirectory name = label),
`FilenamesLabelAwareIterator.java` (filename = label). These feed
ParagraphVectors and the bag-of-words vectorizers; here they yield
plain strings / LabelledDocument so they plug into the same pipelines
as the sentence iterators.

The port's own copy of `deeplearning4j_tpu/nlp/documentiterator.py`,
host code unchanged (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Iterable, List

from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    LabelAwareIterator,
    LabelledDocument,
)


class DocumentIterator:
    """One string per document (reference `DocumentIterator.java`)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, documents: Iterable[str]):
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


class FileDocumentIterator(DocumentIterator):
    """Each file under `root` (recursively, sorted) is one document
    (reference `FileDocumentIterator.java`)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        self.root = root
        self.encoding = encoding
        self._paths: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                self._paths.append(os.path.join(dirpath, f))
        self._idx = 0

    def has_next(self):
        return self._idx < len(self._paths)

    def next_document(self):
        p = self._paths[self._idx]
        self._idx += 1
        with open(p, encoding=self.encoding) as f:
            return f.read()

    def reset(self):
        self._idx = 0


class FileLabelAwareIterator(LabelAwareIterator):
    """`root/<label>/<file>` layout: the subdirectory name is the
    document label (reference `FileLabelAwareIterator.java`)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        self.root = root
        self.encoding = encoding
        self._entries: List[tuple] = []
        for label in sorted(os.listdir(root)):
            d = os.path.join(root, label)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                p = os.path.join(d, f)
                if os.path.isfile(p):
                    self._entries.append((p, label))
        self._idx = 0

    def has_next(self):
        return self._idx < len(self._entries)

    def next_document(self) -> LabelledDocument:
        p, label = self._entries[self._idx]
        self._idx += 1
        with open(p, encoding=self.encoding) as f:
            return LabelledDocument(f.read(), [label])

    def reset(self):
        self._idx = 0


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """Each file is a document labelled by its own (base)name —
    reference `FilenamesLabelAwareIterator.java`."""

    def __init__(self, root: str, encoding: str = "utf-8",
                 strip_extension: bool = True):
        self.root = root
        self.encoding = encoding
        self.strip_extension = strip_extension
        self._paths = []
        for dirpath, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                self._paths.append(os.path.join(dirpath, f))
        self._idx = 0

    def has_next(self):
        return self._idx < len(self._paths)

    def next_document(self) -> LabelledDocument:
        p = self._paths[self._idx]
        self._idx += 1
        name = os.path.basename(p)
        if self.strip_extension and "." in name:
            name = name.rsplit(".", 1)[0]
        with open(p, encoding=self.encoding) as f:
            return LabelledDocument(f.read(), [name])

    def reset(self):
        self._idx = 0
