"""Build the port's C++ IO shims with g++ (counterpart of
`deeplearning4j_tpu/util/native_build.py`).

The shims (`deeplearning4j_tpu_torch/native/*/dl4j_*.cpp`: the HDF5
reader for Keras import, the CSV parser for bulk ingest) compile at
first use into `build/native/` beside the package (a git-ignored
directory), each named by a hash of its source and its flags, as
`kernels/build.py` names the CUDA libraries: an edited source never
loads a stale library, and nothing is ever written beside a source.
A build that fails raises, naming every linker argument tried.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

NATIVE_ROOT = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-fPIC", "-shared"]
LIB_DIRS = ["-L/lib/x86_64-linux-gnu", "-L/usr/lib/x86_64-linux-gnu"]


def so_path(src: Path, soname: str, extra_flags: Sequence[str] = ()) -> Path:
    """Where the library built from `src` with `extra_flags` lives:
    `build/native/<soname stem>-<hash of source and flags>.so`."""
    h = hashlib.sha256(" ".join([*GXX_FLAGS, *extra_flags]).encode())
    h.update(Path(src).read_bytes())
    stem = soname[:-3] if soname.endswith(".so") else soname
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(src: Path, soname: str,
          link_candidates: Optional[Sequence[str]] = None,
          extra_flags: Sequence[str] = ()) -> Path:
    """Compile `src` (skipped when its hashed library exists). With
    `link_candidates`, each linker argument is tried in order until one
    links (hosts ship libhdf5 under several sonames); a RuntimeError
    with every attempt's error when none does."""
    so = so_path(src, soname, extra_flags)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *extra_flags]
    errors: List[str] = []
    for link in (link_candidates or [None]):
        cmd = base + ([link, *LIB_DIRS] if link else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        errors.append(f"[{link}] {proc.stderr.strip()[:500]}")
    raise RuntimeError(
        f"Could not build {soname} from {src}:\n" + "\n".join(errors))
