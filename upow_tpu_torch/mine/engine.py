"""Mining engine: backend-abstracted nonce search over a block template.

The reference mines with N Python processes striding the nonce space and
hashing one candidate at a time (miner.py:83-98).  Here a template becomes
one kernel launch per round of ``batch`` nonces, with the 90 s template
TTL checked between rounds and the host reading each round's result for
an early exit.

Backends (SEARCH_BACKENDS):
    cuda    — the hand-written kernel on the card (csrc/sha256_search.cu)
    torch   — its plain PyTorch version, on the CPU
    mesh    — each round split over a mesh of cards (mesh_engine.py,
              parallel/mesh.py); ``device="cpu"`` meshes the plain version
    native  — the C++ midstate loop on the host (``native/``)
    python  — hashlib loop (reference-shaped oracle)

Every round of a tensor backend is issued through the device runtime
(``_through_runtime``: source ``mine``, kernel ``sha256_search``, or
``sha256_search_mesh`` from the mesh engine), so miner rounds share the
card fairly with verify and index batches.  The closure launches and
returns the round's handle without synchronising; the miner thread
waits on the handle, so the pipelining depth of :func:`mine` keeps its
overlap.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from decimal import Decimal
from typing import Callable, Optional

import torch

from ..core.difficulty import check_pow_hash, pow_target
from ..core.header import BlockHeader
from ..crypto import sha256 as sha_kernel
from ..device import DeviceLike, resolve
from ..device.runtime import get_runtime

SEARCH_BACKENDS = ("cuda", "torch", "mesh", "native", "python")


def check_search_backend(name: str) -> str:
    """``name`` if the port has that backend; ValueError else."""
    if name in SEARCH_BACKENDS:
        return name
    raise ValueError(f"unknown search backend {name!r}")


NONCE_SPACE = 1 << 32
# Device searchers reserve 0xFFFFFFFF as the no-hit sentinel of their
# min-reduction (crypto/sha256.py SENTINEL), so that one nonce is never
# searched: a hit there would be reported as a miss.  Excluding a single
# candidate out of 2^32 costs ~nothing and keeps every backend's contract
# identical.
MAX_SEARCH_END = NONCE_SPACE - 1


@dataclass
class MiningJob:
    """One immutable search job: a fully-built header prefix + PoW target."""

    prefix: bytes           # header minus the 4-byte nonce
    previous_hash: str
    difficulty: Decimal

    @classmethod
    def from_header_fields(cls, previous_hash: str, address: str,
                           merkle_root: str, timestamp: int,
                           difficulty) -> "MiningJob":
        difficulty = Decimal(str(difficulty))
        header = BlockHeader(
            previous_hash=previous_hash,
            address=address,
            merkle_root=merkle_root,
            timestamp=timestamp,
            difficulty_x10=int(difficulty * 10),
            nonce=0,
        )
        return cls(header.prefix_bytes(), previous_hash, difficulty)

    def block_content(self, nonce: int) -> str:
        return (self.prefix + nonce.to_bytes(4, "little")).hex()

    def check(self, nonce: int) -> bool:
        digest = hashlib.sha256(self.prefix + nonce.to_bytes(4, "little")).hexdigest()
        return check_pow_hash(digest, self.previous_hash, self.difficulty)


class _ReadBack:
    """A round's result on its way to the host.

    ``int()`` of the device tensor itself would copy on the stream behind
    every round queued after it, so each read would wait for the next
    round too and the card would idle while the host launched the one
    after.  Here the copy and an event are queued right behind the
    round's own kernel, and ``int()`` waits for that event alone."""

    def __init__(self, value: torch.Tensor):
        self.host = torch.empty((), dtype=value.dtype, pin_memory=True)
        with torch.cuda.device(value.device):
            self.host.copy_(value, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()

    def __int__(self) -> int:
        self.done.synchronize()
        return int(self.host)


def _make_dispatcher(job: MiningJob, backend: str, mesh_devices: int = 0,
                     batch: Optional[int] = None,
                     device: DeviceLike = None) -> Optional[Callable]:
    """For tensor backends: dispatch(start, count) -> an async handle.

    The handle resolves via ``int()``; keeping several dispatches in
    flight keeps the card busy while the host reads a result.  ``cuda``
    raises here without a card.

    ``backend='mesh'`` routes rounds through the process's mesh engine
    (mesh_engine.py): each round split over ``mesh_devices`` cards (0 =
    all visible) by ``shard_bounds``, the least hit taken over the
    shards.  ``batch`` is the round size mine() will dispatch: the engine
    sizes its shards from it at first use.  ``device`` is the mesh's
    device type (None: the cards; "cpu": ``mesh_devices`` shards of the
    plain version); the other backends name their device themselves."""
    check_search_backend(backend)
    if backend == "mesh":
        from .mesh_engine import get_mesh_engine

        return get_mesh_engine(mesh_devices=mesh_devices, round_hint=batch,
                               device=device).dispatcher(job)
    if device is not None:
        raise ValueError(f"backend {backend!r} names its device; device= "
                         "is the mesh backend's")
    if backend not in ("cuda", "torch"):
        return None
    device = resolve("cuda" if backend == "cuda" else "cpu")
    template = sha_kernel.make_template(job.prefix)
    target = sha_kernel.pack_target(
        sha_kernel.target_spec(job.previous_hash, job.difficulty))

    def launch(start: int, count: int):
        out = sha_kernel.pow_search(template, target, start, count,
                                    device=device)
        return _ReadBack(out) if device.type == "cuda" else out

    return _through_runtime(launch, "sha256_search", device)


def _through_runtime(launch: Callable, kernel: str,
                     device: DeviceLike) -> Callable:
    """``launch`` issued by ``device``'s runtime (source ``mine``): the
    drainer launches and returns the round's handle at once, and the
    miner thread blocks on ``int()`` of it, not the drainer."""
    runtime = get_runtime(device)

    def dispatch(start: int, count: int):
        return runtime.submit_call(lambda: launch(start, count),
                                   kernel=kernel, source="mine").result()

    return dispatch


def _make_searcher(job: MiningJob, backend: str) -> Callable[[int, int], Optional[int]]:
    """For the host backends: search(start, count) -> first hit nonce or
    None; ``native`` is the C++ loop, ``python`` one hashlib call per
    nonce."""
    if backend == "native":
        from .. import native

        if native.load() is None:
            raise RuntimeError("native backend requested but no C++ "
                               "toolchain built it")
        prefix_hex, _, charset = pow_target(job.previous_hash,
                                            job.difficulty)

        def search(start: int, count: int) -> Optional[int]:
            return native.pow_search(job.prefix, prefix_hex, charset,
                                     start, count)

        return search
    if backend != "python":
        raise ValueError(f"{backend!r} has no host searcher")

    def search(start: int, count: int) -> Optional[int]:
        for n in range(start, start + count):
            if job.check(n):
                return n
        return None

    return search


@dataclass
class MineResult:
    nonce: Optional[int]          # None -> TTL expired
    hashes_tried: int
    elapsed: float

    @property
    def hashrate(self) -> float:
        return self.hashes_tried / self.elapsed if self.elapsed > 0 else 0.0


def mine(job: MiningJob, backend: str = "cuda", *, start: int = 0,
         stride_end: int = NONCE_SPACE, batch: int = 1 << 22,
         ttl: float = 90.0,
         progress: Optional[Callable] = None,
         mesh_devices: int = 0, device: DeviceLike = None) -> MineResult:
    """Search [start, stride_end) in fixed rounds until hit or TTL.

    ``start``/``stride_end`` let a coordinator hand disjoint nonce ranges to
    multiple chips/hosts (the reference's worker striding, miner.py:140-148,
    without the per-nonce interleave that would defeat batching).
    ``mesh_devices`` and ``device`` are the ``mesh`` backend's (see
    :func:`_make_dispatcher`).
    """
    stride_end = min(stride_end, MAX_SEARCH_END)
    t0 = time.time()
    tried = 0
    cursor = start

    dispatch = _make_dispatcher(job, backend, mesh_devices=mesh_devices,
                                batch=batch, device=device)
    if dispatch is not None:
        # Pipelined device rounds: keep `depth` dispatches in flight so the
        # card never idles while the host blocks on a result.  Each round
        # owns its own output tensor.  A hit wastes at most the in-flight
        # rounds (already dispatched).
        depth = 2
        inflight = []  # (handle, base, count)
        while cursor < stride_end or inflight:
            while len(inflight) < depth and cursor < stride_end:
                count = min(batch, stride_end - cursor)
                inflight.append((dispatch(cursor, count), cursor, count))
                cursor += count
            handle, _, count = inflight.pop(0)
            hit = int(handle)
            tried += count
            if hit != int(sha_kernel.SENTINEL):
                if job.check(hit):
                    if backend == "mesh":
                        from .mesh_engine import get_mesh_engine

                        get_mesh_engine(mesh_devices=mesh_devices,
                                        device=device).note_hit()
                    return MineResult(hit, tried, time.time() - t0)
                raise AssertionError(
                    f"backend {backend} returned nonce {hit} failing host check")
            elapsed = time.time() - t0
            if progress is not None:
                progress(tried, elapsed)
            if elapsed > ttl:
                break
        return MineResult(None, tried, time.time() - t0)

    search = _make_searcher(job, backend)
    while cursor < stride_end:
        count = min(batch, stride_end - cursor)
        hit = search(cursor, count)
        tried += count
        if hit is not None:
            # backend says hit; host double-checks before shipping (cheap)
            if job.check(hit):
                return MineResult(hit, tried, time.time() - t0)
            raise AssertionError(
                f"backend {backend} returned nonce {hit} failing host check")
        elapsed = time.time() - t0
        if progress is not None:
            progress(tried, elapsed)
        if elapsed > ttl:
            break
        cursor += count
    return MineResult(None, tried, time.time() - t0)
