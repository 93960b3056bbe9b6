"""Watermarked normalizer statistics for unbounded streams (counterpart
of `deeplearning4j_tpu/online/normalizer.py`: `StandardizeSnapshot` :43,
`WindowedStandardize` :70; host numpy in float64, as there, so the
statistics are JAX's bit for bit).

`NormalizerStandardize` fits once over a finite corpus; an unbounded
stream has no "once". `WindowedStandardize` keeps the one-pass
sum / sum-of-squares moments (`datasets/normalizers.py`'s math, the
population variance) PER BATCH in a sliding window of the last `window`
dispatched batches, so the statistics track the live distribution.

Versioned snapshot per publish: `snapshot()` freezes the window's
statistics into a `StandardizeSnapshot` (a `NormalizerStandardize`
tagged with a rising version and the records watermark) that rides the
published zip (`ModelRegistry.publish(normalizer=)`), so a release
carries the statistics its training batches were transformed under.

The live window is checkpointable through the normalizer persistence
contract (`state()` / `normalizer_from_meta`): `CheckpointListener(
normalizer=...)` stores it and a resume rebuilds the same window, which
keeps a resumed trajectory bit-equal (the transform bears on it).
"""


from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.normalizers import (
    NormalizerStandardize,
    _float_dtype,
    _mask_weights,
    _reduce_axes,
    register_normalizer,
)


@register_normalizer
class StandardizeSnapshot(NormalizerStandardize):
    """A frozen, versioned standardizer — what `WindowedStandardize.
    snapshot()` returns and a published model zip carries. Transform /
    revert are the parent's; the meta additionally records which
    window version and records watermark produced the stats."""

    kind = "standardize_snapshot"

    def __init__(self, version: int = 0, records_seen: int = 0):
        super().__init__()
        self.version = int(version)
        self.records_seen = int(records_seen)

    def state(self):
        return ({"kind": self.kind, "version": self.version,
                 "records_seen": self.records_seen},
                {"mean": self.mean, "std": self.std})

    @classmethod
    def _from_state(cls, meta, arrays):
        out = cls(meta.get("version", 0), meta.get("records_seen", 0))
        out.mean = arrays["mean"]
        out.std = arrays["std"]
        return out


@register_normalizer
class WindowedStandardize:
    """Sliding-window zero-mean/unit-variance statistics.

    `observe(features)` folds one dispatched batch's moments into the
    window (evicting the oldest past `window` batches); `transform`
    applies the CURRENT window stats. Implements the normalizer
    persistence contract (`state()`/`_from_state`) over the full
    window contents, so checkpoints restore the exact window — not
    just its aggregate."""

    kind = "windowed_standardize"

    def __init__(self, window: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._moments: deque = deque()   # (count, sum[F], sumsq[F])
        self.records_seen = 0            # rows ever observed (watermark)
        self.snapshot_version = 0        # bumped per snapshot()
        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None
        self._dirty = True

    # ---------------------------------------------------------- updating
    def observe(self, features, mask=None) -> "WindowedStandardize":
        x = np.asarray(features, np.float64)
        axes = _reduce_axes(x)
        w = _mask_weights(x, mask)
        if w is not None:
            cnt = float(w.sum())
            s = (x * w).sum(axis=axes)
            sq = (x * x * w).sum(axis=axes)
        else:
            cnt = float(np.prod([x.shape[a] for a in axes])) if axes else 1.0
            s = x.sum(axis=axes)
            sq = (x * x).sum(axis=axes)
        self._moments.append((cnt, s, sq))
        while len(self._moments) > self.window:
            self._moments.popleft()
        self.records_seen += int(x.shape[0]) if x.ndim else 1
        self._dirty = True
        return self

    def fit(self, data) -> "WindowedStandardize":
        """Normalizer-protocol fit: observe every batch of a DataSet /
        iterable (the finite-corpus warm-start before streaming)."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        batches = [data] if isinstance(data, DataSet) else data
        n = 0
        for ds in batches:
            mask = getattr(ds, "features_mask", None)
            self.observe(np.asarray(ds.features),
                         None if mask is None else np.asarray(mask))
            n += 1
        if n == 0:
            raise ValueError("fit() saw no data")
        if hasattr(data, "reset"):
            data.reset()
        return self

    def _refresh(self):
        if not self._dirty:
            return
        if not self._moments:
            raise ValueError(
                "WindowedStandardize has observed no data yet — "
                "transform() before the first batch has no statistics")
        n = sum(c for c, _, _ in self._moments)
        s = sum((m[1] for m in self._moments), 0.0)
        sq = sum((m[2] for m in self._moments), 0.0)
        self._mean = s / n
        var = sq / n - self._mean ** 2
        self._std = np.sqrt(np.clip(var, 1e-12, None))
        self._dirty = False

    # -------------------------------------------------------- transforms
    @property
    def mean(self) -> np.ndarray:
        self._refresh()
        return self._mean

    @property
    def std(self) -> np.ndarray:
        self._refresh()
        return self._std

    def transform(self, features):
        self._refresh()
        x = np.asarray(features)
        return ((x - self._mean) / self._std).astype(_float_dtype(x))

    def revert(self, features):
        self._refresh()
        x = np.asarray(features)
        return (x * self._std + self._mean).astype(_float_dtype(x))

    def pre_process(self, ds):
        ds.features = self.transform(ds.features)
        return ds

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> StandardizeSnapshot:
        """Freeze the current window statistics as an independent,
        versioned standardizer (later `observe` calls do not touch
        it) — the normalizer a publish attaches to its model zip."""
        self._refresh()
        self.snapshot_version += 1
        snap = StandardizeSnapshot(self.snapshot_version,
                                   self.records_seen)
        snap.mean = np.array(self._mean, np.float64)
        snap.std = np.array(self._std, np.float64)
        return snap

    # ------------------------------------------------------- persistence
    def state(self):
        counts = np.asarray([m[0] for m in self._moments], np.float64)
        sums = (np.stack([m[1] for m in self._moments])
                if self._moments else np.zeros((0,), np.float64))
        sumsqs = (np.stack([m[2] for m in self._moments])
                  if self._moments else np.zeros((0,), np.float64))
        return ({"kind": self.kind, "window": self.window,
                 "records_seen": self.records_seen,
                 "snapshot_version": self.snapshot_version},
                {"counts": counts, "sums": sums, "sumsqs": sumsqs})

    @classmethod
    def _from_state(cls, meta, arrays):
        out = cls(meta.get("window", 64))
        out.records_seen = int(meta.get("records_seen", 0))
        out.snapshot_version = int(meta.get("snapshot_version", 0))
        counts = np.asarray(arrays.get("counts", ()))
        sums = np.asarray(arrays.get("sums", ()))
        sumsqs = np.asarray(arrays.get("sumsqs", ()))
        for i in range(counts.shape[0]):
            out._moments.append((float(counts[i]), sums[i], sumsqs[i]))
        out._dirty = True
        return out
