"""Hdf5Archive: a ctypes binding over the port's C++ HDF5 shim
(counterpart of `deeplearning4j_tpu/modelimport/hdf5.py`).

The native library (`native/hdf5/dl4j_hdf5.cpp`, built at first use by
`util/native_build.py`) exposes string-attribute reads and writes,
group listing and creation, and float32 dataset reads and writes; this
class is the typed Python surface. It links against the host's libhdf5,
found under the same sonames as the JAX package's (`SONAMES`, tried in
order). `libhdf5()` probes them without building anything; opening an
archive on a host where none loads raises an OSError naming each one.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.util.native_build import NATIVE_ROOT, build

_SRC = NATIVE_ROOT / "hdf5" / "dl4j_hdf5.cpp"
# the first 8 bytes of every HDF5 file
HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
# the JAX package's linker arguments, and the soname each one resolves to
LINK_CANDIDATES = ("-l:libhdf5_serial.so.103", "-l:libhdf5_serial.so.100",
                   "-lhdf5_serial", "-lhdf5")
SONAMES = ("libhdf5_serial.so.103", "libhdf5_serial.so.100",
           "libhdf5_serial.so", "libhdf5.so")

_lib = None


def libhdf5() -> Optional[str]:
    """The first of `SONAMES` the dynamic loader finds here, or None."""
    for name in SONAMES:
        try:
            ctypes.CDLL(name)
        except OSError:
            continue
        return name
    return None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if libhdf5() is None:
        raise OSError(f"libhdf5: none of {', '.join(SONAMES)} on this host")
    so = build(_SRC, "libdl4j_hdf5.so", link_candidates=LINK_CANDIDATES)
    lib = ctypes.CDLL(str(so))
    i64, cp = ctypes.c_int64, ctypes.c_char_p
    lib.dl4j_h5_open.restype = i64
    lib.dl4j_h5_open.argtypes = [cp]
    lib.dl4j_h5_create.restype = i64
    lib.dl4j_h5_create.argtypes = [cp]
    lib.dl4j_h5_close.restype = ctypes.c_int
    lib.dl4j_h5_close.argtypes = [i64]
    lib.dl4j_h5_exists.restype = ctypes.c_int
    lib.dl4j_h5_exists.argtypes = [i64, cp]
    lib.dl4j_h5_create_group.restype = ctypes.c_int
    lib.dl4j_h5_create_group.argtypes = [i64, cp]
    lib.dl4j_h5_read_string_attr.restype = ctypes.c_int
    lib.dl4j_h5_read_string_attr.argtypes = [i64, cp, cp, cp, i64]
    lib.dl4j_h5_write_string_attr.restype = ctypes.c_int
    lib.dl4j_h5_write_string_attr.argtypes = [i64, cp, cp, cp]
    lib.dl4j_h5_write_string_array_attr.restype = ctypes.c_int
    lib.dl4j_h5_write_string_array_attr.argtypes = [i64, cp, cp, cp]
    lib.dl4j_h5_list_children.restype = ctypes.c_int
    lib.dl4j_h5_list_children.argtypes = [i64, cp, cp, i64]
    lib.dl4j_h5_dataset_ndim.restype = ctypes.c_int
    lib.dl4j_h5_dataset_ndim.argtypes = [i64, cp, ctypes.POINTER(i64),
                                         ctypes.c_int]
    lib.dl4j_h5_read_dataset_f32.restype = ctypes.c_int
    lib.dl4j_h5_read_dataset_f32.argtypes = [i64, cp,
                                             ctypes.POINTER(ctypes.c_float)]
    lib.dl4j_h5_write_dataset_f32.restype = ctypes.c_int
    lib.dl4j_h5_write_dataset_f32.argtypes = [
        i64, cp, ctypes.POINTER(i64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


class Hdf5Archive:
    def __init__(self, path, mode: str = "r"):
        self._lib = _load_lib()
        self._f = -1
        path = str(path)
        if mode == "r":
            self._f = self._lib.dl4j_h5_open(path.encode())
        elif mode == "w":
            self._f = self._lib.dl4j_h5_create(path.encode())
        else:
            raise ValueError(mode)
        if self._f <= 0:
            raise IOError(f"Cannot open HDF5 file {path} (mode={mode})")

    def close(self):
        if self._f > 0:
            self._lib.dl4j_h5_close(self._f)
            self._f = -1

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------------- reads
    def exists(self, path: str) -> bool:
        return bool(self._lib.dl4j_h5_exists(self._f, path.encode()))

    def read_attr_string(self, attr: str,
                         obj_path: str = "/") -> Optional[str]:
        size = 1 << 20
        while size <= (1 << 28):  # last size tried: 256 MiB
            buf = ctypes.create_string_buffer(size)
            n = self._lib.dl4j_h5_read_string_attr(
                self._f, obj_path.encode(), attr.encode(), buf, len(buf))
            if n == -2:  # buffer too small: grow and retry
                size *= 4
                continue
            return None if n < 0 else buf.value.decode("utf-8")
        raise IOError(f"Attribute {obj_path}@{attr} exceeds 256 MiB")

    def read_attr_strings(self, attr: str, obj_path: str = "/") -> List[str]:
        s = self.read_attr_string(attr, obj_path)
        return [] if not s else s.split("\n")

    def list_children(self, path: str = "/") -> List[str]:
        """Immediate child link names of a group (name-ascending)."""
        size = 1 << 16
        while size <= (1 << 24):  # last size tried: 16 MiB
            buf = ctypes.create_string_buffer(size)
            n = self._lib.dl4j_h5_list_children(
                self._f, path.encode(), buf, len(buf))
            if n == -2:
                size *= 4
                continue
            if n < 0:
                raise KeyError(f"No group {path}")
            s = buf.value.decode("utf-8")
            return [] if s == "" else s.split("\n")
        raise IOError(f"Group listing for {path} exceeds 16 MiB")

    def read_dataset(self, path: str) -> np.ndarray:
        dims = (ctypes.c_int64 * 16)()
        nd = self._lib.dl4j_h5_dataset_ndim(self._f, path.encode(), dims, 16)
        if nd < 0:
            raise KeyError(f"No dataset {path}")
        shape = tuple(int(dims[i]) for i in range(nd))
        out = np.zeros(shape if shape else (1,), np.float32)
        rc = self._lib.dl4j_h5_read_dataset_f32(
            self._f, path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc < 0:
            raise IOError(f"Read failed for {path}")
        return out.reshape(shape) if shape else out[0]

    # ------------------------------------------------------------ writes
    def create_group(self, path: str):
        if self._lib.dl4j_h5_create_group(self._f, path.encode()) < 0:
            raise IOError(f"Group create failed: {path}")

    def write_attr_string(self, attr: str, value: str, obj_path: str = "/"):
        rc = self._lib.dl4j_h5_write_string_attr(
            self._f, obj_path.encode(), attr.encode(), value.encode())
        if rc < 0:
            raise IOError(f"Attr write failed: {obj_path}@{attr}")

    def write_attr_strings(self, attr: str, values: Sequence[str],
                           obj_path: str = "/"):
        rc = self._lib.dl4j_h5_write_string_array_attr(
            self._f, obj_path.encode(), attr.encode(),
            "\n".join(values).encode())
        if rc < 0:
            raise IOError(f"Attr write failed: {obj_path}@{attr}")

    def write_dataset(self, path: str, data: np.ndarray):
        data = np.ascontiguousarray(data, np.float32)
        dims = (ctypes.c_int64 * max(data.ndim, 1))(*data.shape)
        rc = self._lib.dl4j_h5_write_dataset_f32(
            self._f, path.encode(), dims, data.ndim,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc < 0:
            raise IOError(f"Dataset write failed: {path}")
