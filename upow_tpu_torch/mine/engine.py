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

What :func:`mine` records (``telemetry.metrics``; the miner CLI
registers the families at its start, :func:`preregister`):

* ``mine.hashes`` and ``mine.rounds``: the nonces and rounds searched,
  every backend, added up in the call and recorded as it returns;
* ``mine.search_launches.aligned`` and ``mine.search_launches.generic``:
  the ``cuda`` backend's rounds, one search kernel launch each, under the
  path the job's template takes (``sha256.search_path``: the v2 header's
  aligned nonce word, any other offset), recorded as a call returns;
* ``mine.round_dispatch``: host seconds from a tensor backend's
  ``dispatch(start, count)`` to its handle: the runtime's queue
  (``runtime.queue_wait.mine`` is its finer split), the drainer's hop,
  the launch and the read-back's set-up;
* ``mine.rounds_dry``: hand-offs at which the round queued last had
  already finished when the host came to queue the next, so the card
  had nothing of this engine's to run (inside a ``profiling`` session
  such a dispatch is the annotation ``mine.round_handoff_dry``);
* on the single-card ``cuda`` backend, the card's idle time between two
  rounds on the device clock: the end of one round's read-back to the
  start of the next round's kernel, both CUDA timing events on the
  stream (:class:`_RoundClock`), into ``mine.round_gap.handoff``
  between two rounds of one template and ``mine.round_gap.refresh``
  between a template's last round and the next template's first (the
  drain, any push, the fetch, the build and the dispatcher's set-up).  A gap is
  read once both of its events have completed, which the round loop
  waits for anyway.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from decimal import Decimal
from typing import Callable, Dict, Optional

import torch

from ..core.difficulty import check_pow_hash, pow_target
from ..core.header import BlockHeader
from ..crypto import sha256 as sha_kernel
from ..device import DeviceLike, resolve
from ..device.runtime import get_runtime
from ..telemetry import metrics, tracing

SEARCH_BACKENDS = ("cuda", "torch", "mesh", "native", "python")

#: a round gap's buckets, in seconds: a hand-off that kept the card fed
#: reads about 0, a dry one tens of µs to ms, a refresh ms to tens of ms
GAP_BUCKETS = (1e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01,
               0.025, 0.05, 0.1, 0.25, 1.0)
#: ``mine.round_dispatch``'s buckets, in seconds
DISPATCH_BUCKETS = (5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01,
                    0.05, 0.1, 1.0)
GAP_HANDOFF = "mine.round_gap.handoff"
GAP_REFRESH = "mine.round_gap.refresh"
ROUND_DISPATCH = "mine.round_dispatch"
#: counted here (hashes, rounds, dry hand-offs) and by the CLI's loop
#: (templates mined and expired, blocks pushed and accepted)
COUNTERS = ("mine.hashes", "mine.rounds", "mine.rounds_dry",
            "mine.templates", "mine.templates_expired",
            "mine.blocks_pushed", "mine.blocks_accepted")
#: the search kernel's launches by path, in the order of sha256's paths
SEARCH_LAUNCHES = ("mine.search_launches.aligned",
                   "mine.search_launches.generic")


def preregister() -> None:
    """The miner's families, all zero until they count, so that a scrape
    of the miner (``miner --metrics-port``) carries them from its first
    read.  The CLI calls it at its start; ``telemetry.configure`` does
    not, so a node's ``/metrics`` keeps its families."""
    for name in COUNTERS + SEARCH_LAUNCHES:
        metrics.ensure_counter(name)
    for name in (GAP_HANDOFF, GAP_REFRESH):
        metrics.ensure_histogram(name, GAP_BUCKETS)
    metrics.ensure_histogram(ROUND_DISPATCH, DISPATCH_BUCKETS)


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
    after.  Here the copy and an event (``done``: a fresh one, or the
    timing event the single-card engine's clock hands it) are queued
    right behind the round's own kernel, and ``int()`` waits for that
    event alone.

    That clock (:meth:`_RoundClock.launch`) also sets ``begin``, its
    timing event just before the round's kernel, and ``prev``, the end of
    the round launched before it on the card, for :meth:`gap`."""

    begin: Optional[torch.cuda.Event] = None
    prev: Optional[torch.cuda.Event] = None

    def __init__(self, value: torch.Tensor,
                 done: Optional[torch.cuda.Event] = None):
        self.host = torch.empty((), dtype=value.dtype, pin_memory=True)
        with torch.cuda.device(value.device):
            self.host.copy_(value, non_blocking=True)
            self.done = torch.cuda.Event() if done is None else done
            self.done.record()

    def __int__(self) -> int:
        self.done.synchronize()
        return int(self.host)

    def gap(self) -> Optional[float]:
        """Seconds on the device clock from the end of the round launched
        before this one to the start of this round's kernel; None where
        either is untimed.  Read after ``int()``: both events have
        completed."""
        if self.begin is None or self.prev is None:
            return None
        return self.prev.elapsed_time(self.begin) / 1e3


class _RoundClock:
    """One card's events for the gaps between the engine's rounds: a
    ring of (begin, end) timing-event pairs reused round after round,
    and the end event of the round launched last, which outlives a
    :func:`mine` call so that the gap across a refresh is timed too.
    Only the runtime's drainer for the card launches, so one thread
    uses the ring, on its current stream (looked up at its first
    launch)."""

    #: more pairs than rounds alive at once: the pipeline's depth in
    #: flight, and the round behind the oldest, whose end a gap reads
    RING = 8

    def __init__(self, device: torch.device):
        self.device = device
        self.ring = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(self.RING)]
        self.next = 0
        self.stream: Optional[torch.cuda.Stream] = None
        self.last_end: Optional[torch.cuda.Event] = None
        self.pair = self.ring[0]
        self.marked: Optional[torch.cuda.Event] = None
        self.hook = sha_kernel.before_launch(self._mark)

    def _mark(self) -> None:
        """Record the current pair's begin (``pow_search``, just before
        its kernel)."""
        begin = self.pair[0]
        begin.record(self.stream)
        self.marked = begin

    def launch(self, search: Callable[[], torch.Tensor]) -> _ReadBack:
        """``search()``, one ``pow_search`` launch, with the next pair's
        begin recorded on the stream just before its kernel
        (``sha256.before_launch``) and its end behind the read-back."""
        if self.stream is None:
            self.stream = torch.cuda.current_stream(self.device)
        self.pair = self.ring[self.next]
        self.next = (self.next + 1) % self.RING
        self.marked = None
        with self.hook:
            out = search()
        end = self.pair[1]
        round_ = _ReadBack(out, end)
        round_.begin = self.marked
        round_.prev, self.last_end = self.last_end, end
        return round_


_clocks: Dict[torch.device, _RoundClock] = {}
_clocks_lock = threading.Lock()


def _clock(device: torch.device) -> _RoundClock:
    with _clocks_lock:
        clock = _clocks.get(device)
        if clock is None:
            clock = _clocks[device] = _RoundClock(device)
        return clock


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

    clock = _clock(device) if device.type == "cuda" else None

    def launch(start: int, count: int):
        def search():
            return sha_kernel.pow_search(template, target, start, count,
                                         device=device)

        return search() if clock is None else clock.launch(search)

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
    counts = {"mine.hashes": 0, "mine.rounds": 0, "mine.rounds_dry": 0}
    try:
        return _mine(job, backend, start, min(stride_end, MAX_SEARCH_END),
                     batch, ttl, progress, mesh_devices, device, counts)
    finally:
        if backend == "cuda" and counts["mine.rounds"]:
            path = sha_kernel.search_path(sha_kernel.make_template(job.prefix))
            counts[SEARCH_LAUNCHES[path]] = counts["mine.rounds"]
        # counted by plain adds, recorded once a call (a template)
        for name, n in counts.items():
            if n:
                metrics.inc(name, n)


def _mine(job: MiningJob, backend: str, start: int, stride_end: int,
          batch: int, ttl: float, progress: Optional[Callable],
          mesh_devices: int, device: DeviceLike,
          counts: Dict[str, int]) -> MineResult:
    """:func:`mine`'s rounds; ``counts`` takes the nonces, rounds and dry
    hand-offs as they pass."""
    t0 = time.time()
    tried = 0
    cursor = start
    perf = time.perf_counter

    dispatch = _make_dispatcher(job, backend, mesh_devices=mesh_devices,
                                batch=batch, device=device)
    if dispatch is not None:
        # Pipelined device rounds: keep `depth` dispatches in flight so the
        # card never idles while the host blocks on a result.  Each round
        # owns its own output tensor.  A hit wastes at most the in-flight
        # rounds (already dispatched).
        depth = 2
        inflight = []  # (handle, base, count)
        gap_name = GAP_REFRESH  # the template's first round: a refresh
        while cursor < stride_end or inflight:
            while len(inflight) < depth and cursor < stride_end:
                count = min(batch, stride_end - cursor)
                t_dispatch = perf()
                if inflight and _ran_dry(inflight[-1][0]):
                    counts["mine.rounds_dry"] += 1
                    with tracing.annotation("mine.round_handoff_dry"):
                        handle = dispatch(cursor, count)
                else:
                    handle = dispatch(cursor, count)
                metrics.observe(ROUND_DISPATCH, perf() - t_dispatch,
                                DISPATCH_BUCKETS)
                inflight.append((handle, cursor, count))
                cursor += count
            handle, _, count = inflight.pop(0)
            hit = int(handle)
            tried += count
            counts["mine.hashes"] += count
            counts["mine.rounds"] += 1
            gap = getattr(handle, "gap", None)
            seconds = gap() if gap is not None else None
            if seconds is not None:
                metrics.observe(gap_name, seconds, GAP_BUCKETS)
            gap_name = GAP_HANDOFF
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
        counts["mine.hashes"] += count
        counts["mine.rounds"] += 1
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


def _ran_dry(handle) -> bool:
    """Whether the round ``handle`` (the one queued last) has finished:
    then the card has nothing of this engine's left to run as the host
    queues the next.  Handles without a ``done`` event (the plain
    version's tensors) never run dry."""
    done = getattr(handle, "done", None)
    return done is not None and done.query()
