"""ctypes bindings of the port's native C++ host backends, built with g++.

The port's own copy of the JAX package's ``native/``: ``src/upow_native.cpp``
compiles at first use into ``upow_tpu_torch/_build/libupow_native.so``
(listed in .gitignore):

    g++ -O3 -fPIC -shared -std=c++17 [-fopenmp] src/upow_native.cpp

OpenMP when the toolchain has it, without it otherwise.  Where no g++
exists, :func:`load` returns None, counts ``native.unavailable`` and
logs a warning, and each function here returns None: the signature path
then verifies with the pure-Python oracle and the miner's ``cpu`` device
takes the plain PyTorch search.

* :func:`sha256`: one digest.
* :func:`pow_search`: the first nonce of a range that passes the PoW rule
  (the miner's ``native`` backend).
* :func:`p256_verify_batch`: a batch of P-256 verifies, one OpenMP thread
  a signature (the host path of ``verify/txverify.py`` and the degrade's
  fallback).
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

from .. import trace
from .._build import BUILD

log = logging.getLogger("upow_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "src" / "upow_native.cpp"
LIB = BUILD / "libupow_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
OPENMP: Optional[bool] = None  # whether the loaded build has OpenMP


def _compile() -> Optional[bool]:
    """Build the library; True with OpenMP, False without, None when no
    g++ exists or neither build succeeds."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    # a name of this process's own: test workers may build at once
    tmp = BUILD / f"libupow_native.{os.getpid()}.tmp.so"
    base = [gxx, "-O3", "-fPIC", "-shared", "-std=c++17", str(SRC),
            "-o", str(tmp)]
    for cmd, openmp in ((base + ["-fopenmp"], True), (base, False)):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            log.warning("native build failed (%s): %s", " ".join(cmd[-1:]),
                        getattr(e, "stderr", b"")[-400:])
            continue
        os.replace(tmp, LIB)
        (BUILD / "libupow_native.openmp").write_text(str(int(openmp)))
        return openmp
    return None


def load() -> Optional[ctypes.CDLL]:
    """The native library (built first if missing or older than its
    source), or None where it cannot be built."""
    global _lib, _tried, OPENMP
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
            if _compile() is None:
                trace.inc("native.unavailable")
                log.warning("native library unavailable (no g++ or a failed "
                            "build): host paths run in Python")
                return None
        flag = BUILD / "libupow_native.openmp"
        OPENMP = flag.exists() and flag.read_text().strip() == "1"
        lib = ctypes.CDLL(str(LIB))
        lib.upow_sha256.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.c_char_p]
        lib.upow_sha256.restype = None
        lib.upow_pow_search.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32]
        lib.upow_pow_search.restype = ctypes.c_uint32
        lib.upow_p256_verify.argtypes = [ctypes.c_char_p] * 5
        lib.upow_p256_verify.restype = ctypes.c_int
        lib.upow_p256_verify_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p]
        lib.upow_p256_verify_batch.restype = None
        _lib = lib
        return _lib


def sha256(message: bytes) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.upow_sha256(message, len(message), out)
    return out.raw


def pow_search(prefix: bytes, target_prefix_hex: str, charset: int,
               start: int, count: int) -> Optional[int]:
    """First nonce in ``[start, start + count)`` that passes the PoW rule
    (the reference miner's hot loop, miner.py:83-98), else None; None
    also when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    if not (0 <= start and 0 <= count and start + count <= 1 << 32):
        raise ValueError(f"nonce range [{start}, {start + count}) is not "
                         "inside [0, 2^32)")
    nibbles = bytes(int(c, 16) for c in target_prefix_hex)
    hit = lib.upow_pow_search(prefix, len(prefix), nibbles, len(nibbles),
                              charset, start, count)
    return None if hit == 0xFFFFFFFF else hit


def _be32(x: int) -> bytes:
    return x.to_bytes(32, "big")


def p256_verify(msg_digest: bytes, r: int, s: int, qx: int,
                qy: int) -> Optional[bool]:
    lib = load()
    if lib is None:
        return None
    if len(msg_digest) != 32:
        raise ValueError("a P-256 digest is 32 bytes")
    return bool(lib.upow_p256_verify(msg_digest, _be32(r), _be32(s),
                                     _be32(qx), _be32(qy)))


def p256_verify_batch(digests: Sequence[bytes], sigs: Sequence[tuple],
                      pubs: Sequence[tuple]) -> Optional[List[bool]]:
    """Verdicts of ``len(digests)`` verifies of 32-byte digests, (r, s)
    signatures and (x, y) public keys, one OpenMP thread a signature."""
    lib = load()
    if lib is None:
        return None
    n = len(digests)
    if len(sigs) != n or len(pubs) != n:
        raise ValueError("digests, signatures and keys differ in length")
    if any(len(d) != 32 for d in digests):
        raise ValueError("a P-256 digest is 32 bytes")
    out = ctypes.create_string_buffer(n)
    lib.upow_p256_verify_batch(
        b"".join(digests), b"".join(_be32(r) for r, _ in sigs),
        b"".join(_be32(s) for _, s in sigs),
        b"".join(_be32(x) for x, _ in pubs),
        b"".join(_be32(y) for _, y in pubs), n, out)
    return [bool(b) for b in out.raw]
