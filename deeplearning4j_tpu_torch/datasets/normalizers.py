"""Data normalizers: fit statistics on a dataset/iterator, then
transform (and revert) minibatches (counterpart of
`deeplearning4j_tpu/datasets/normalizers.py`, host numpy as there, so
the statistics and transforms are JAX's bit for bit).

Reference: ND4J's `org.nd4j.linalg.dataset.api.preprocessor` family —
`NormalizerStandardize` (zero-mean/unit-variance), `NormalizerMinMaxScaler`
(rescale to [min, max]), `ImagePreProcessingScaler` (pixel [0, 255] →
[a, b]) — consumed throughout the reference via
`DataSetIterator.setPreProcessor` and persisted beside models by
`ModelSerializer.addNormalizerToModel` / `restoreNormalizerFromFile`
(`util/ModelSerializer.java`), with the `ModelGuesser.loadNormalizer`
facade (`deeplearning4j-core/util/ModelGuesser.java:29-40`).

Statistics are accumulated on the host in float64 with a streaming
one-pass sum/sum-of-squares (iterators may not fit in memory);
`transform` is plain elementwise numpy on the host side of the input
pipeline.
Feature-axis statistics reduce over every non-feature axis (batch,
time, spatial), matching the reference's per-feature semantics for
2-d, 3-d (masked time series) and 4-d (image) inputs.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

_REGISTRY = {}


def register_normalizer(cls):
    _REGISTRY[cls.kind] = cls
    return cls


def normalizer_from_meta(meta: dict, arrays: dict) -> "Normalizer":
    cls = _REGISTRY.get(meta.get("kind"))
    if cls is None:
        # the online normalizers register on import of their module: a
        # checkpoint an OnlineTrainer wrote restores through plain
        # `fault.resume()` without the caller importing online/ first
        import importlib
        importlib.import_module("deeplearning4j_tpu_torch.online.normalizer")
        cls = _REGISTRY.get(meta.get("kind"))
    if cls is None:
        raise ValueError(f"Unknown normalizer kind: {meta.get('kind')!r}")
    return cls._from_state(meta, arrays)


def _float_dtype(x: np.ndarray):
    """Normalized output is always floating point — casting a
    standardized batch back to the input's uint8 would truncate/wrap
    it into garbage (the reference normalizers yield float too)."""
    return x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32


def _reduce_axes(x: np.ndarray):
    """All axes except the feature axis. Convention: rank-2 [B, F] and
    rank-3 [B, T, F] are feature-last (this repo's NHWC/[B,T,F]
    layouts); rank-4 images are NHWC with channels last."""
    return tuple(i for i in range(x.ndim) if i != x.ndim - 1)


class Normalizer:
    """fit / transform / revert protocol (reference
    `DataNormalization`). Subclasses hold per-feature state arrays."""

    kind = "abstract"
    fits_labels = False

    def fit(self, data) -> "Normalizer":
        """Accept a DataSet or any iterable of DataSets. A
        `features_mask` ([B, T], 1 = real timestep) excludes padded
        timesteps from the statistics — matching ND4J's masked-aware
        accumulation (`NormalizerStandardize` + `DataSetUtil`
        masked-columns path): padding zeros must not drag the mean
        toward 0 or deflate the variance of a padded corpus."""
        from deeplearning4j_tpu_torch.datasets.iterator import DataSet
        batches = [data] if isinstance(data, DataSet) else data
        self._begin()
        n = 0
        for ds in batches:
            mask = getattr(ds, "features_mask", None)
            self._accumulate(np.asarray(ds.features),
                             None if mask is None else np.asarray(mask))
            n += 1
        if n == 0:
            raise ValueError("fit() saw no data")
        self._finish()
        if hasattr(data, "reset"):
            data.reset()
        return self

    def pre_process(self, ds):
        """In-place DataSet hook (reference `preProcess(DataSet)`) —
        the iterator-side entry point."""
        ds.features = self.transform(ds.features)
        return ds

    def transform(self, features):
        raise NotImplementedError

    def revert(self, features):
        raise NotImplementedError

    # ------------------------------------------------------- persistence
    def state(self):
        """(meta dict, arrays dict) for persistence."""
        raise NotImplementedError

    def _begin(self):
        raise NotImplementedError

    def _accumulate(self, x, mask=None):
        raise NotImplementedError

    def _finish(self):
        pass


def _mask_weights(x: np.ndarray, mask) -> Optional[np.ndarray]:
    """Broadcastable 0/1 weights for a [B, T] features_mask against
    [B, T, F] features (None when the mask doesn't apply)."""
    if mask is None or x.ndim != 3:
        return None
    w = np.asarray(mask, np.float64)
    if w.shape != x.shape[:2]:
        return None
    return w[:, :, None]


@register_normalizer
class NormalizerStandardize(Normalizer):
    """Per-feature zero-mean/unit-variance (reference
    `NormalizerStandardize`): one-pass streaming sum / sum-of-squares
    in float64 so iterator-sized corpora never need a second pass."""

    kind = "standardize"

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def _begin(self):
        self._n = 0.0
        self._sum = None
        self._sumsq = None

    def _accumulate(self, x, mask=None):
        x = np.asarray(x, np.float64)
        axes = _reduce_axes(x)
        w = _mask_weights(x, mask)
        if w is not None:
            cnt = float(w.sum())  # per-feature count — same for every F
            s = (x * w).sum(axis=axes)
            sq = (x * x * w).sum(axis=axes)
        else:
            cnt = float(np.prod([x.shape[a] for a in axes])) if axes else 1.0
            s = x.sum(axis=axes)
            sq = (x * x).sum(axis=axes)
        if self._sum is None:
            self._sum, self._sumsq = s, sq
        else:
            self._sum = self._sum + s
            self._sumsq = self._sumsq + sq
        self._n += cnt

    def _finish(self):
        if not self._n:
            # every timestep masked out (upstream filtering bug): a
            # silent 0/0 would make mean/std NaN and poison every
            # later transform with no pointer back here
            raise ValueError(
                "fit() saw no unmasked timesteps — the features_mask "
                "excluded every value; check the mask polarity "
                "(1 = real timestep)")
        self.mean = self._sum / self._n
        var = self._sumsq / self._n - self.mean ** 2
        self.std = np.sqrt(np.clip(var, 1e-12, None))

    def transform(self, features):
        x = np.asarray(features)
        return ((x - self.mean) / self.std).astype(_float_dtype(x))

    def revert(self, features):
        x = np.asarray(features)
        return (x * self.std + self.mean).astype(_float_dtype(x))

    def state(self):
        return {"kind": self.kind}, {"mean": self.mean, "std": self.std}

    @classmethod
    def _from_state(cls, meta, arrays):
        out = cls()
        out.mean = arrays["mean"]
        out.std = arrays["std"]
        return out


@register_normalizer
class NormalizerMinMaxScaler(Normalizer):
    """Per-feature rescale to [min_range, max_range] (reference
    `NormalizerMinMaxScaler`)."""

    kind = "minmax"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def _begin(self):
        self.data_min = None
        self.data_max = None

    def _accumulate(self, x, mask=None):
        x = np.asarray(x, np.float64)
        axes = _reduce_axes(x)
        w = _mask_weights(x, mask)
        if w is not None:
            keep = w > 0
            lo = np.where(keep, x, np.inf).min(axis=axes)
            hi = np.where(keep, x, -np.inf).max(axis=axes)
            if not np.isfinite(lo).all():  # batch fully padded
                return
        else:
            lo = x.min(axis=axes)
            hi = x.max(axis=axes)
        if self.data_min is None:
            self.data_min, self.data_max = lo, hi
        else:
            self.data_min = np.minimum(self.data_min, lo)
            self.data_max = np.maximum(self.data_max, hi)

    def _finish(self):
        if self.data_min is None:
            # every batch was fully masked — same loud failure as the
            # standardizer, instead of a later None-arithmetic crash
            raise ValueError(
                "fit() saw no unmasked timesteps — the features_mask "
                "excluded every value; check the mask polarity "
                "(1 = real timestep)")

    def _span(self):
        return np.clip(self.data_max - self.data_min, 1e-12, None)

    def transform(self, features):
        x = np.asarray(features)
        unit = (x - self.data_min) / self._span()
        out = unit * (self.max_range - self.min_range) + self.min_range
        return out.astype(_float_dtype(x))

    def revert(self, features):
        x = np.asarray(features)
        unit = (x - self.min_range) / (self.max_range - self.min_range)
        return (unit * self._span() + self.data_min).astype(_float_dtype(x))

    def state(self):
        return ({"kind": self.kind, "min_range": self.min_range,
                 "max_range": self.max_range},
                {"data_min": self.data_min, "data_max": self.data_max})

    @classmethod
    def _from_state(cls, meta, arrays):
        out = cls(meta.get("min_range", 0.0), meta.get("max_range", 1.0))
        out.data_min = arrays["data_min"]
        out.data_max = arrays["data_max"]
        return out


@register_normalizer
class ImagePreProcessingScaler(Normalizer):
    """Pixel-range scaler (reference `ImagePreProcessingScaler`):
    [0, 2^bits - 1] → [a, b] with no fitting required."""

    kind = "image_scaler"

    def __init__(self, a: float = 0.0, b: float = 1.0, bits: int = 8):
        self.a = float(a)
        self.b = float(b)
        self.bits = int(bits)

    @property
    def _max_pixel(self):
        return float(2 ** self.bits - 1)

    def fit(self, data):  # stateless — fit is a no-op like the reference
        return self

    def transform(self, features):
        x = np.asarray(features, np.float32)
        return x / self._max_pixel * (self.b - self.a) + self.a

    def revert(self, features):
        x = np.asarray(features, np.float32)
        return (x - self.a) / (self.b - self.a) * self._max_pixel

    def state(self):
        return ({"kind": self.kind, "a": self.a, "b": self.b,
                 "bits": self.bits}, {})

    @classmethod
    def _from_state(cls, meta, arrays):
        return cls(meta.get("a", 0.0), meta.get("b", 1.0),
                   meta.get("bits", 8))


def normalizer_to_json(norm: Normalizer) -> str:
    meta, _ = norm.state()
    return json.dumps(meta)
