"""Native CSV loader: a ctypes binding over the port's
`native/csv/dl4j_csv.cpp` (counterpart of
`deeplearning4j_tpu/datasets/native_csv.py`).

DataVec's `CSVRecordReader` feeding `RecordReaderDataSetIterator`, as
one single-pass C++ parser built at first use (`util/native_build.py`).
Returns float32 matrices ready for a `DataSet` and the upload to the
device; non-numeric fields parse as NaN so the caller chooses a policy.
As in the JAX package, a host where the shim does not build parses with
the NumPy path, which keeps the parser's semantics; `native_available()`
says which one runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.util.native_build import NATIVE_ROOT, build

_SRC = NATIVE_ROOT / "csv" / "dl4j_csv.cpp"

_lib = None
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        so = build(_SRC, "libdl4j_csv.so", extra_flags=["-O3"])
        lib = ctypes.CDLL(str(so))
    except (RuntimeError, OSError):   # no toolchain: the NumPy path
        _lib_failed = True
        return None
    lib.dl4j_csv_shape.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.dl4j_csv_shape.restype = ctypes.c_int
    lib.dl4j_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long]
    lib.dl4j_csv_parse.restype = ctypes.c_long
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def load_csv_matrix(path: str, *, delimiter: str = ",",
                    skip_header: int = 0) -> np.ndarray:
    """Parse a numeric CSV file into a float32 [rows, cols] matrix.
    Unparseable fields become NaN."""
    lib = _load_lib()
    if lib is None:
        return _numpy_fallback(path, delimiter, skip_header)
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.dl4j_csv_shape(str(path).encode(), delimiter.encode(),
                            skip_header, ctypes.byref(rows),
                            ctypes.byref(cols))
    if rc != 0:
        raise FileNotFoundError(path)
    out = np.empty((rows.value, cols.value), np.float32)
    got = lib.dl4j_csv_parse(
        str(path).encode(), delimiter.encode(), skip_header,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, cols.value)
    if got < 0:
        raise IOError(f"native CSV parse failed for {path}")
    return out[:got]


def _split_quoted(line: str, delimiter: str):
    """Quote-aware field split (the native parser's rule)."""
    fields, cur, quoted = [], [], False
    for ch in line:
        if ch == '"':
            quoted = not quoted
        elif ch == delimiter and not quoted:
            fields.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    fields.append("".join(cur))
    return fields


def _numpy_fallback(path, delimiter, skip_header) -> np.ndarray:
    """The native parser's semantics in Python: comment (#) and blank
    lines are dropped BEFORE skip_header counts, fields split
    quote-aware, unparseable fields become NaN, ragged rows are
    NaN-padded or truncated to the first data row's column count."""
    rows = []
    cols = None
    with open(path) as f:
        data_line = 0
        for line in f:
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            if data_line >= skip_header:
                row = []
                for field in _split_quoted(line, delimiter):
                    try:
                        row.append(float(field.strip()))
                    except ValueError:
                        row.append(float("nan"))
                if cols is None:
                    cols = len(row)
                rows.append((row + [float("nan")] * cols)[:cols])
            data_line += 1
    if not rows:
        return np.zeros((0, 0), np.float32)
    return np.asarray(rows, np.float32)


def load_csv_dataset(path: str, *, label_index: int = -1,
                     num_classes: Optional[int] = None,
                     delimiter: str = ",", skip_header: int = 0,
                     regression: bool = False):
    """CSV file -> the port's `DataSet` (the `CSVRecordReader` +
    `RecordReaderDataSetIterator(label_index, num_classes)`
    composition). Classification labels are one-hot."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    m = load_csv_matrix(path, delimiter=delimiter, skip_header=skip_header)
    if label_index < 0:
        label_index = m.shape[1] + label_index
    features = np.delete(m, label_index, axis=1)
    raw = m[:, label_index]
    if regression:
        labels = raw[:, None].astype(np.float32)
    else:
        if len(raw) and not np.all(np.isfinite(raw)):
            bad = np.nonzero(~np.isfinite(raw))[0][:5].tolist()
            raise ValueError(
                f"non-numeric class labels at rows {bad} in {path}")
        idx = np.rint(raw).astype(np.int64)
        if len(idx) and (idx.min() < 0
                         or np.abs(raw - idx).max() > 1e-6):
            raise ValueError(
                f"class labels in {path} must be non-negative integers")
        n = num_classes or (int(idx.max()) + 1 if len(idx) else 0)
        if len(idx) and idx.max() >= n:
            raise ValueError(
                f"label {int(idx.max())} >= num_classes {n} in {path}")
        labels = np.eye(n, dtype=np.float32)[idx]
    return DataSet(features.astype(np.float32), labels)
