"""Record readers and the record -> DataSet iterators (counterpart of
`deeplearning4j_tpu/datasets/records.py`, the DataVec seam): records
(lists of values) are assembled into minibatch feature and label
arrays, with one-hot label columns for classification and masks for
variable-length sequences. The arrays are numpy; `fit` copies them to
the card.

`ImageRecordReader` imports PIL when it reads its first image, so a
machine without PIL imports this module and raises `ImportError` only
there.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class RecordReader:
    """One record = list of values (DataVec `RecordReader`)."""

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> List:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionRecordReader(RecordReader):
    """In-memory records (DataVec `CollectionRecordReader`)."""

    def __init__(self, records: Iterable[Sequence]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVRecordReader(CollectionRecordReader):
    """CSV file → records of floats/strings (DataVec `CSVRecordReader`)."""

    def __init__(self, path, skip_lines: int = 0, delimiter: str = ","):
        records = []
        with open(path, newline="") as f:
            for i, row in enumerate(csv.reader(f, delimiter=delimiter)):
                if i < skip_lines or not row:
                    continue
                records.append([self._maybe_num(v) for v in row])
        super().__init__(records)

    @staticmethod
    def _maybe_num(v: str):
        try:
            return float(v)
        except ValueError:
            return v


class CSVSequenceRecordReader:
    """One CSV file per sequence (DataVec `CSVSequenceRecordReader`):
    `next_sequence()` → list of records (timesteps)."""

    def __init__(self, paths: Sequence, skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = [Path(p) for p in paths]
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._pos = 0

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sequence()

    def has_next(self):
        return self._pos < len(self.paths)

    def next_sequence(self) -> List[List]:
        reader = CSVRecordReader(self.paths[self._pos],
                                 skip_lines=self.skip_lines,
                                 delimiter=self.delimiter)
        self._pos += 1
        return [r for r in reader]

    def reset(self):
        self._pos = 0


class ImageRecordReader(RecordReader):
    """Image files → [H*W*C...] pixel records + optional label from the
    parent directory name (DataVec `ImageRecordReader`)."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 paths: Optional[Sequence] = None, label_from_dir: bool = True):
        self.height, self.width, self.channels = height, width, channels
        self.paths = [Path(p) for p in (paths or [])]
        self.label_from_dir = label_from_dir
        self.labels = sorted({p.parent.name for p in self.paths}) \
            if label_from_dir else []
        self._pos = 0

    def has_next(self):
        return self._pos < len(self.paths)

    def next_record(self):
        from PIL import Image
        p = self.paths[self._pos]
        self._pos += 1
        img = Image.open(p).resize((self.width, self.height))
        if self.channels == 1:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        rec = list(arr.reshape(-1))
        if self.label_from_dir:
            rec.append(float(self.labels.index(p.parent.name)))
        return rec

    def reset(self):
        self._pos = 0


# ---------------------------------------------------------------- iterators
class RecordReaderDataSetIterator(DataSetIterator):
    """records → minibatches (reference
    `RecordReaderDataSetIterator.java`): `label_index` column becomes a
    one-hot label (classification, `num_classes` given) or a raw
    regression target."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        if label_index is not None and not regression and not num_classes:
            raise ValueError("classification mode needs num_classes "
                             "(or set regression=True)")
        self.reader.reset()

    def reset(self):
        self.reader.reset()

    def has_next(self):
        return self.reader.has_next()

    def next(self) -> DataSet:
        feats, labels = [], []
        while self.reader.has_next() and len(feats) < self.batch_size:
            rec = self.reader.next_record()
            if self.label_index is None:
                feats.append([float(v) for v in rec])
                continue
            li = self.label_index if self.label_index >= 0 else len(rec) - 1
            label = rec[li]
            feat = [float(v) for i, v in enumerate(rec) if i != li]
            feats.append(feat)
            if self.regression:
                labels.append([float(label)])
            else:
                one_hot = np.zeros(self.num_classes, np.float32)
                one_hot[int(label)] = 1.0
                labels.append(one_hot)
        x = np.asarray(feats, np.float32)
        y = np.asarray(labels, np.float32) if labels else None
        return DataSet(x, y)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Aligned feature/label sequence readers → padded+masked RNN
    minibatches [B, T, F] (reference
    `SequenceRecordReaderDataSetIterator.java` ALIGN_END semantics).

    `bucket_boundaries`: T pads UP to the smallest bucket >= the batch
    max (the last bucket is a hard cap: longer sequences keep their
    tail), so a run sees at most len(boundaries) distinct shapes (the
    JAX package bounds its compiles with it; here it bounds the shapes a
    `steps_per_execution` group splits on). The masks make the extra
    padding a numeric no-op."""

    def __init__(self, feature_reader: CSVSequenceRecordReader,
                 label_reader: Optional[CSVSequenceRecordReader],
                 batch_size: int, num_classes: Optional[int] = None,
                 regression: bool = False, label_index: int = -1,
                 bucket_boundaries: Optional[Sequence[int]] = None):
        self.feature_reader = feature_reader
        self.label_reader = label_reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.label_index = label_index
        if bucket_boundaries and any(b <= 0 for b in bucket_boundaries):
            raise ValueError(
                f"bucket_boundaries must be positive, got {bucket_boundaries}")
        self.bucket_boundaries = (sorted(bucket_boundaries)
                                  if bucket_boundaries else None)
        self._truncated_count = 0
        self._warned_truncation = False
        self.reset()

    @property
    def truncated_count(self) -> int:
        """#sequences tail-truncated by the last bucket boundary."""
        return self._truncated_count

    def _bucket_len(self, T: int) -> int:
        if self.bucket_boundaries is None:
            return T
        for b in self.bucket_boundaries:
            if T <= b:
                return b
        return self.bucket_boundaries[-1]     # hard cap: truncate

    def reset(self):
        self.feature_reader.reset()
        if self.label_reader is not None:
            self.label_reader.reset()

    def has_next(self):
        return self.feature_reader.has_next()

    def next(self) -> DataSet:
        seqs, label_seqs = [], []
        while self.feature_reader.has_next() and len(seqs) < self.batch_size:
            fseq = self.feature_reader.next_sequence()
            if self.label_reader is not None:
                lseq = self.label_reader.next_sequence()
            else:  # label column inside the feature records
                li = self.label_index
                lseq = [[r[li if li >= 0 else len(r) - 1]] for r in fseq]
                fseq = [[v for i, v in enumerate(r)
                         if i != (li if li >= 0 else len(r) - 1)] for r in fseq]
            seqs.append(np.asarray(fseq, np.float32))
            label_seqs.append(np.asarray(lseq, np.float32))
        B = len(seqs)
        T = self._bucket_len(max(s.shape[0] for s in seqs))
        F = seqs[0].shape[1]
        if self.regression or self.num_classes is None:
            L = label_seqs[0].shape[1]
        else:
            L = self.num_classes
        x = np.zeros((B, T, F), np.float32)
        y = np.zeros((B, T, L), np.float32)
        mask = np.zeros((B, T), np.float32)
        for i, (s, l) in enumerate(zip(seqs, label_seqs)):
            t = s.shape[0]
            if t > T:
                # hard-cap truncation (bucketing only) keeps the TAIL:
                # ALIGN_END semantics put the informative final steps
                # (and sequence-classification targets) at the end
                self._truncated_count += 1
                if not self._warned_truncation:
                    self._warned_truncation = True
                    import logging
                    logging.getLogger(__name__).warning(
                        "sequence of length %d exceeds the last bucket "
                        "boundary %d and was TAIL-truncated (keeping the "
                        "final %d steps); further truncations are counted "
                        "silently — see .truncated_count. Raise the last "
                        "bucket_boundaries entry to keep full sequences",
                        s.shape[0], T, T)
                t = T
                s, l = s[-T:], l[-T:]
            # (a label sequence misaligned with its features still
            # raises below — truncation never masks corrupted data)
            x[i, :t] = s
            if self.regression or self.num_classes is None:
                y[i, :t] = l
            else:
                for ti in range(t):
                    y[i, ti, int(l[ti, 0])] = 1.0
            mask[i, :t] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()
