"""CSV lines to a DataSet for streams (counterpart of
`deeplearning4j_tpu/streaming/records.py`: dl4j-streaming's CSV route
feeding DataSets)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


def csv_to_dataset(lines, label_index: int = -1,
                   num_classes: Optional[int] = None,
                   delimiter: str = ",") -> DataSet:
    """One example a non-blank line: the column at `label_index` (the
    last by default) is the label, one-hot over `num_classes` when
    given, else a [n, 1] regression target; the other columns, in
    order, are the fp32 features."""
    feats, labels = [], []
    for line in lines:
        if not line.strip():
            continue
        vals = [float(p) for p in line.strip().split(delimiter)]
        li = label_index if label_index >= 0 else len(vals) - 1
        label = vals[li]
        feats.append([v for i, v in enumerate(vals) if i != li])
        if num_classes:
            oh = np.zeros(num_classes, np.float32)
            oh[int(label)] = 1.0
            labels.append(oh)
        else:
            labels.append([label])
    return DataSet(np.asarray(feats, np.float32),
                   np.asarray(labels, np.float32))
