"""Build and load the hand-written Hopper kernels.

Each `csrc/<name>.cu` compiles with `nvcc -gencode
arch=compute_90a,code=sm_90a` into its own shared library with a plain
C interface, loaded through `ctypes` (no PyTorch headers: a build takes
seconds, not minutes). Libraries build at first use into
`build/torch_kernels/` beside the package (a git-ignored directory),
named by a hash of their sources and flags, so an edited source never
loads a stale library. `build_all()` starts one `nvcc` per source, all
at once.

Nothing here runs at import time, and nothing builds unless a kernel is
launched on a CUDA tensor: a CPU-only machine never calls `nvcc`.

`BUILDS` and `BUILD_SECONDS` count the finished builds and their
seconds since import; `monitor.KernelBuildCollector` reads them.
`SECONDS` holds each library's last build time, by source name, and
`LOGS` its nvcc output (ptxas's report of each kernel's registers and
its performance warnings, `-Xptxas -v`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILDS = 0
BUILD_SECONDS = 0.0
SECONDS: Dict[str, float] = {}
LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.cmd, proc.t0 = tmp, out, cmd, t0
    proc.name = name
    return proc


def _collect(proc: subprocess.Popen):
    proc.log, _ = proc.communicate()
    proc.seconds = time.perf_counter() - proc.t0


def _finish(proc: subprocess.Popen):
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(proc.cmd)}\n{proc.log}")
    os.replace(proc.tmp, proc.out)      # atomic: readers never see a partial .so
    global BUILDS, BUILD_SECONDS
    seconds = proc.seconds
    BUILDS += 1
    BUILD_SECONDS += seconds
    SECONDS[proc.name] = seconds
    LOGS[proc.name] = proc.log


def build_all(names=None) -> Dict[str, Path]:
    """Compile every missing library, one `nvcc` per source, all started
    together; returns {name: library path}."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = [_start(n, p) for n, p in paths.items() if not p.exists()]
    # a reader thread a process, so each one's seconds end when it does
    readers = [threading.Thread(target=_collect, args=(proc,))
               for proc in procs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    errors = []
    for proc in procs:
        try:
            _finish(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = build_all([name])[name]
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
