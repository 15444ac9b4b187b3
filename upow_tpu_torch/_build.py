"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles into
``_build/lib<name>.so`` (listed in .gitignore) the first time a wrapper
needs it, or when the source is newer than the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The ``-Xptxas -v`` report (registers, spills, stack per kernel) is kept
beside the library as ``_build/<name>.ptxas.txt``.  Nothing here catches
a failed build or load: the caller sees the error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header in csrc/."""
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _command(name: str, out: Path) -> list:
    return [nvcc(), *ARCH, *FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str], force: bool = False) -> Dict[str, float]:
    """Compile the named sources, one nvcc per source, all started
    together.  Returns {name: seconds}; raises on the first failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    with _lock:
        for name in names:
            if not force and not _stale(name):
                continue
            tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
            procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (tmp, t0, proc) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            (BUILD / f"{name}.ptxas.txt").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            os.replace(tmp, library_path(name))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    path = BUILD / f"{name}.ptxas.txt"
    return path.read_text() if path.exists() else ""


def entry_count() -> int:
    """Kernel libraries built in ``_build/`` (one a ``csrc/*.cu``), or -1
    when nothing was ever built here: the node's
    ``compile_cache_persistent_entries`` gauge, the counterpart of the
    JAX package's persistent compile cache entries."""
    if not BUILD.is_dir():
        return -1
    return sum(1 for src in CSRC.glob("*.cu")
               if library_path(src.stem).exists())
