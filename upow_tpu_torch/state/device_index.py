"""The resident UTXO index: membership and a value store on the card.

The port of the JAX package's ``state/device_index.py``, with its names.
Each UTXO-class table gets one :class:`DeviceUtxoIndex`:

* **Fingerprints.**  The sorted key is a 64-bit XOR-fold of the txid's
  four u64 lanes mixed with the output index (:func:`fingerprint_batch`);
  each entry also carries an independent 64-bit *check* fingerprint
  (:func:`check_batch`).  A probe matches only when both agree, so a
  false "present" needs a 128-bit collision.  The host code is a copy of
  the JAX package's, bit for bit.
* **Resident lanes.**  Six int32 lanes at power-of-two capacity: the key's
  high and low halves (sign-flipped, so uint32 order is int32 order), the
  two check halves, and the amount's low and high words.  Pads are
  ``I32_MAX, I32_MAX, 0, 0, 0, 0`` and sort last.  A dirty index is
  uploaded whole, in one host-to-device copy from a pinned buffer, into
  lanes reused while the capacity holds.
* **The probe (kernel B6).**  :func:`probe_plain` is the plain PyTorch
  version of the JAX package's ``_probe_kernel``: a lower bound of each
  query's high lane, then a ``window``-slot scan of the equal run
  comparing all four identity lanes, and the amount lanes gathered at the
  first full match (at the lower bound when nothing matches).
  :func:`probe` is the wrapper: a CPU tensor runs the plain version, a
  CUDA tensor launches ``csrc/utxo_probe.cu`` on the current stream, with
  no fallback between the two.
* **Shadow map.**  The exact multiset map ``fp64 -> [outpoints]`` answers
  only what the probe declares ambiguous: an equal-key run longer than
  the window, or a hit on a fingerprint that ever had 64-bit twins.
  ``index.shadow_consults`` counts each consult.
* **Undo log.**  ``apply_block`` records (created, spent, spent values);
  ``rollback_block`` replays the inverse as two sorted-slab splices.
  They, ``lookup_batch``, ``maybe_contains_batch`` and ``missing`` keep
  the JAX index's interface; the port's chain state calls none of them
  (its reorg applies its delta through ``add`` and ``remove``).

Every device dispatch of the index goes through the device runtime
(``device/runtime.py``), source ``index`` unless the caller names one:
an upload is ``kernel="utxo_apply"`` (:meth:`DeviceUtxoIndex.materialize`),
a probe ``kernel="utxo_probe"``, and :func:`fused_probe`, which probes
every part of an accept micro-batch and runs the micro-batch's digest
batch in one call on one stream with one synchronisation at its end, is
``kernel="accept_fused"``.  So the lanes, the staged queries and the
output buffers are written and read on the drainer's stream alone (an
upload that a probe finds due runs there too).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import device as ktel
from ..device import DeviceLike, current_index, raw_stream, resolve
from ..device.runtime import get_runtime

Outpoint = Tuple[str, int]

# Odd 64-bit mixing constant (2^64 / golden ratio).  The txid prefix is
# already uniform (it IS sha256 output); the multiply spreads the output
# index so (h, 0) and (h, 1) land far apart.
_MIX = 0x9E3779B97F4A7C15
_U64 = 0xFFFFFFFFFFFFFFFF

# Independent lane multipliers for the check fingerprint (xxhash64 /
# splitmix64 odd constants).
_CHECK_MULTS = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                0x165667B19E3779F9, 0x27D4EB2F165667C5)
_MIX2 = 0xFF51AFD7ED558CCD

#: slots scanned past the lower bound; an equal-key run that extends past
#: the window flags the probe ambiguous (shadow consult)
PROBE_WINDOW = 8

_I32_MAX = np.int32(np.iinfo(np.int32).max)
# each resident lane's pad value: keys_hi, keys_lo, chk_a, chk_b, amt_lo,
# amt_hi
_PADS = (int(_I32_MAX), int(_I32_MAX), 0, 0, 0, 0)

PROBE_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global PROBE_LAUNCHES
    with _COUNT_LOCK:
        PROBE_LAUNCHES = 0


# --- fingerprints (host) ---------------------------------------------------

def fingerprint(outpoint: Outpoint) -> int:
    """64-bit unsigned fingerprint of one outpoint: XOR-fold of the four
    u64 lanes of the txid, mixed with the output index.  Bit-identical to
    :func:`fingerprint_batch`."""
    tx_hash, index = outpoint
    raw = bytes.fromhex(tx_hash)
    base = 0
    for off in range(0, 32, 8):
        base ^= int.from_bytes(raw[off:off + 8], "little")
    return (base ^ ((index + 1) * _MIX)) & _U64


def fingerprint_batch(outpoints: Sequence[Outpoint]) -> np.ndarray:
    """(N,) uint64 fingerprints in one ``np.frombuffer`` pass."""
    n = len(outpoints)
    if not n:
        return np.zeros(0, dtype=np.uint64)
    blob = bytes.fromhex("".join(o[0] for o in outpoints))
    lanes = np.frombuffer(blob, dtype="<u8").reshape(n, 4)
    base = np.bitwise_xor.reduce(lanes, axis=1)
    idx = np.fromiter((o[1] for o in outpoints), dtype=np.uint64, count=n)
    with np.errstate(over="ignore"):
        return base ^ ((idx + np.uint64(1)) * np.uint64(_MIX))


def check_fp(outpoint: Outpoint) -> int:
    """Scalar twin of :func:`check_batch`."""
    tx_hash, index = outpoint
    raw = bytes.fromhex(tx_hash)
    acc = 0
    for k, off in enumerate(range(0, 32, 8)):
        lane = int.from_bytes(raw[off:off + 8], "little")
        acc ^= (lane * _CHECK_MULTS[k]) & _U64
    return (acc ^ (((index + 1) * _MIX2) & _U64)) & _U64


def check_batch(outpoints: Sequence[Outpoint]) -> np.ndarray:
    """(N,) uint64 check fingerprints, independent of
    :func:`fingerprint_batch`; together the 128-bit identity a probe
    trusts without the host."""
    n = len(outpoints)
    if not n:
        return np.zeros(0, dtype=np.uint64)
    blob = bytes.fromhex("".join(o[0] for o in outpoints))
    lanes = np.frombuffer(blob, dtype="<u8").reshape(n, 4)
    idx = np.fromiter((o[1] for o in outpoints), dtype=np.uint64, count=n)
    with np.errstate(over="ignore"):
        acc = lanes[:, 0] * np.uint64(_CHECK_MULTS[0])
        for k in range(1, 4):
            acc = acc ^ (lanes[:, k] * np.uint64(_CHECK_MULTS[k]))
        return acc ^ ((idx + np.uint64(1)) * np.uint64(_MIX2))


def _lane_hi(fps: np.ndarray) -> np.ndarray:
    """High 32 bits as order-preserving int32 (the sign-bit flip maps
    uint32 order onto int32 order)."""
    hi = (fps >> np.uint64(32)).astype(np.uint32)
    return (hi ^ np.uint32(0x80000000)).view(np.int32)


def _lane_lo(fps: np.ndarray) -> np.ndarray:
    lo = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (lo ^ np.uint32(0x80000000)).view(np.int32)


def _eq_lanes(fps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Equality-only int32 lane pair of a uint64 array, little-endian
    (no order flip: the check lanes are compared, never sorted)."""
    u32 = fps.view(np.uint32).reshape(-1, 2)
    return (u32[:, 0].view(np.int32).copy(),
            u32[:, 1].view(np.int32).copy())


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length()) if n else 1


def query_lanes(fps: np.ndarray, chks: np.ndarray) -> np.ndarray:
    """(4, N) int32 query lanes: key high and low, check a and b."""
    q_ca, q_cb = _eq_lanes(chks)
    return np.stack([_lane_hi(fps), _lane_lo(fps), q_ca, q_cb])


# --- the probe: plain version, wrapper, bound ------------------------------

def probe_plain(keys_hi, keys_lo, chk_a, chk_b, amt_lo, amt_hi, n_live: int,
                q_hi, q_lo, q_ca, q_cb, window: int = PROBE_WINDOW) -> tuple:
    """The JAX package's ``_probe_kernel`` in PyTorch, on any device.

    Six (cap,) int32 resident lanes (keys_hi sorted), ``n_live`` live
    rows, four (q,) int32 query lanes.  Returns per query: the full
    128-bit hit, the 64-bit key hit, the run overflow (the high lane equal
    at the window's last slot) as bool, and the amount lanes (int32) at
    ``clip(pos + argmax(full match), 0, cap - 1)``: the lower bound itself
    where nothing matches."""
    cap = keys_hi.shape[0]
    pos = torch.searchsorted(keys_hi, q_hi, side="left")
    idx = pos[:, None] + torch.arange(window, device=keys_hi.device)[None, :]
    valid = idx < n_live
    idx_c = idx.clamp(0, cap - 1)
    hi_eq = (keys_hi[idx_c] == q_hi[:, None]) & valid
    key_eq = hi_eq & (keys_lo[idx_c] == q_lo[:, None])
    full_eq = key_eq & (chk_a[idx_c] == q_ca[:, None]) \
        & (chk_b[idx_c] == q_cb[:, None])
    hit = full_eq.any(dim=1)
    key_hit = key_eq.any(dim=1)
    overflow = hi_eq[:, window - 1]
    # argmax returns the first maximum, as jnp.argmax does
    row = (pos + full_eq.to(torch.uint8).argmax(dim=1)).clamp(0, cap - 1)
    return hit, key_hit, overflow, amt_lo[row], amt_hi[row]


#: fence entries the kernel keeps in shared memory (FENCE_MAX in
#: csrc/utxo_probe.cu): every 2^shift-th live keys_hi, at the least shift
#: that fits
FENCE_MAX = 8192


def fence_shift(n_live: int) -> int:
    """The least shift whose fence of every 2^shift-th of ``n_live`` keys
    fits :data:`FENCE_MAX` entries."""
    shift = 0
    while (n_live + (1 << shift) - 1) >> shift > FENCE_MAX:
        shift += 1
    return shift


def _check_lane(t: torch.Tensor, shape: tuple, device_index: int) -> None:
    """A contiguous int32 tensor of ``shape`` on the device whose
    ``get_device()`` is ``device_index`` (-1: the CPU), or ValueError."""
    if t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous() \
            or t.get_device() != device_index:
        raise ValueError(
            f"expected a contiguous {shape} int32 tensor on device "
            f"{device_index}, got {t.dtype} {tuple(t.shape)} on {t.device}")


class ProbeArgs:
    """B6's resident side, checked and laid out once (at an upload of the
    index, or once a :func:`probe` call): the six lanes, ``n_live``, the
    fence of every 2^``shift``-th live ``keys_hi`` (a strided copy on the
    lanes' device), and the kernel's prepared argument block, an int64
    array of the lanes' and the fence's pointers, ``n_live``, ``cap``,
    the fence's length, ``shift`` and the device ordinal, which the
    launch hands to the C side as one pointer."""

    __slots__ = ("lanes", "n_live", "device_index", "shift", "fence",
                 "block", "block_ptr")

    def __init__(self, lanes: Sequence[torch.Tensor], n_live: int,
                 shift: Optional[int] = None):
        lanes = tuple(lanes)
        if len(lanes) != 6:
            raise ValueError(f"expected six resident lanes, got {len(lanes)}")
        dev, cap = lanes[0].device, int(lanes[0].shape[0]) \
            if lanes[0].dim() == 1 else -1
        if cap < 1:
            raise ValueError(f"resident lanes of shape "
                             f"{tuple(lanes[0].shape)}")
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        self.device_index = lanes[0].get_device()
        for t in lanes:
            _check_lane(t, (cap,), self.device_index)
        if not 0 <= n_live <= cap:
            raise ValueError(f"n_live {n_live} of capacity {cap}")
        self.lanes, self.n_live = lanes, n_live
        self.shift = fence_shift(n_live) if shift is None else shift
        if (n_live + (1 << self.shift) - 1) >> self.shift > FENCE_MAX:
            raise ValueError(f"a fence at shift {self.shift} of {n_live} "
                             f"keys exceeds {FENCE_MAX} entries")
        # a fresh allocation: contiguous and 16-byte aligned, as the
        # kernel's vector loads of it need
        self.fence = lanes[0][:n_live:1 << self.shift].clone(
            memory_format=torch.contiguous_format)
        self.block = np.array(
            [t.data_ptr() for t in lanes] + [
                self.fence.data_ptr(), n_live, cap, self.fence.shape[0],
                self.shift, max(self.device_index, 0)], dtype=np.int64)
        self.block_ptr = self.block.ctypes.data


_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    """Build (at first use) and load ``csrc/utxo_probe.cu``."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            import ctypes

            from .. import _build

            lib = _build.load("utxo_probe")
            lib.utxo_probe_launch.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 2)
            lib.utxo_probe_launch.restype = ctypes.c_int
            lib.utxo_probe_attributes.argtypes = [ctypes.c_void_p]
            lib.utxo_probe_attributes.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _pack(results: tuple) -> torch.Tensor:
    """The five results of :func:`probe_plain` as the kernel's one output
    buffer: q amt_lo words, q amt_hi words, then q bytes each of hit,
    key_hit and overflow."""
    hit, key_hit, overflow, amt_lo, amt_hi = results
    return torch.cat([amt_lo.view(torch.uint8), amt_hi.view(torch.uint8),
                      hit.to(torch.uint8), key_hit.to(torch.uint8),
                      overflow.to(torch.uint8)])


def split_results(out: torch.Tensor, q: int) -> tuple:
    """(hit, key_hit, overflow, amt_lo, amt_hi) as views of one output
    buffer of 11 * q bytes (a tensor)."""
    amts = out[:8 * q].view(torch.int32)
    flags = out[8 * q:].view(torch.bool)
    return flags[:q], flags[q:2 * q], flags[2 * q:], amts[:q], amts[q:]


def split_host(out: np.ndarray, q: int) -> tuple:
    """:func:`split_results` of a buffer read back to the host, numpy
    views."""
    amts = out[:8 * q].view(np.int32)
    flags = out[8 * q:].view(np.bool_)
    return flags[:q], flags[q:2 * q], flags[2 * q:], amts[:q], amts[q:]


def launch(args: ProbeArgs, queries: torch.Tensor,
           window: int = PROBE_WINDOW) -> torch.Tensor:
    """The probe of ``queries``, (4, q) int32 lanes (key high and low,
    check a and b), into ``args``' lanes; returns the one output buffer
    of 11 * q bytes (:func:`split_results`).

    The slim path both :func:`probe` and the index take: the query
    lanes' check, one ``torch.empty``, one ctypes call with the prepared
    block's pointer and the raw current stream, and
    ``torch.cuda.device`` only when the lanes' card is not the current
    one.  CPU lanes run :func:`probe_plain` and pack its results into
    the same buffer.  A failed build, load or launch raises."""
    global PROBE_LAUNCHES
    q = int(queries.shape[-1])
    _check_lane(queries, (4, q), args.device_index)
    if window < 1:
        raise ValueError(f"window {window}")
    if args.device_index < 0:
        return _pack(probe_plain(*args.lanes, args.n_live, *queries, window))
    dev = args.device_index
    out = torch.empty(11 * q, dtype=torch.uint8, device=dev)
    if q == 0:
        return out
    lib = _LIB if _LIB is not None else _kernel_lib()
    if current_index() == dev:
        rc = lib.utxo_probe_launch(args.block_ptr, queries.data_ptr(), q,
                                   window, out.data_ptr(), raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = lib.utxo_probe_launch(args.block_ptr, queries.data_ptr(), q,
                                       window, out.data_ptr(),
                                       raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"utxo_probe launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        PROBE_LAUNCHES += 1
    return out


def probe(keys_hi, keys_lo, chk_a, chk_b, amt_lo, amt_hi, n_live: int,
          q_hi, q_lo, q_ca, q_cb, window: int = PROBE_WINDOW) -> tuple:
    """The windowed sorted probe (kernel B6); arguments and results as
    :func:`probe_plain`.

    The lanes are checked and their fence built (:class:`ProbeArgs`),
    the four query lanes stacked, then :func:`launch`: CPU tensors run
    :func:`probe_plain`, CUDA tensors launch ``csrc/utxo_probe.cu`` on
    the current stream and return at once.  The three flags are one byte
    each, the amounts int32, all five views of one output buffer.  A
    failed build, load or launch raises."""
    args = ProbeArgs((keys_hi, keys_lo, chk_a, chk_b, amt_lo, amt_hi),
                     n_live)
    q = q_hi.shape[0]
    for t in (q_hi, q_lo, q_ca, q_cb):
        _check_lane(t, (q,), args.device_index)
    queries = torch.stack((q_hi, q_lo, q_ca, q_cb))
    return split_results(launch(args, queries, window), q)


def kernel_attributes(device: DeviceLike = None) -> dict:
    """Threads a block, registers and local-memory bytes a thread and
    static shared bytes a block of the probe kernel on a card
    (``cudaFuncGetAttributes``)."""
    import ctypes

    dev = resolve(device)
    lib = _kernel_lib()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        rc = lib.utxo_probe_attributes(ctypes.addressof(vals))
    if rc != 0:
        raise RuntimeError(f"utxo_probe_attributes: CUDA error {rc}")
    return dict(zip(("threads", "registers", "local_bytes", "shared_bytes"),
                    vals))


def probe_bytes_needed(keys_hi, n_live: int, q_hi,
                       window: int = PROBE_WINDOW) -> int:
    """The bytes the probes of ``q_hi`` into these lanes must move, on the
    run's own data: per query the ``keys_hi`` entries its lower bound
    compares (``ceil(log2(n_live + 1))``, on the binary search's path),
    the window rows of the four identity lanes up to the first high-lane
    mismatch, and the two amount lanes at the matched row; all of these
    counted once per 32-byte sector across the queries; plus 16 bytes of
    query lanes in and 11 bytes of results out a query.  Computed with
    numpy on the host (it reads the lanes back)."""
    keys = keys_hi.detach().cpu().numpy()[:n_live]
    qs = q_hi.detach().cpu().numpy()
    cap = int(keys_hi.shape[0])
    pos = np.searchsorted(keys, qs, side="left")
    sectors = set()  # (lane, sector) pairs read

    def touch(lane: int, rows: np.ndarray) -> None:
        sectors.update(zip([lane] * len(rows), (rows // 8).tolist()))

    # the search: the same halving path a lower bound takes, per query
    lo = np.zeros(len(qs), dtype=np.int64)
    length = np.full(len(qs), n_live, dtype=np.int64)
    while (length > 0).any():
        live = length > 0
        half = length >> 1
        mid = lo + half
        touch(0, mid[live])
        less = live & (keys[np.minimum(mid, max(n_live - 1, 0))] < qs)
        lo = np.where(less, mid + 1, lo)
        length = np.where(less, length - half - 1, np.where(live, half, 0))
    # the window: keys_hi at each slot read, and the other three identity
    # lanes where the high lane still equals the query's
    alive = np.ones(len(qs), dtype=bool)
    for k in range(window):
        j = pos + k
        alive &= j < n_live
        if not alive.any():
            break
        touch(0, j[alive])
        alive[alive] = keys[j[alive]] == qs[alive]
        for lane in range(1, 4):
            touch(lane, j[alive])
    # the amounts at the row, matched or not: pos clipped to the capacity
    row = np.minimum(pos, cap - 1)
    touch(4, row)
    touch(5, row)
    return len(sectors) * 32 + len(qs) * (16 + 11)


# --- the index ---------------------------------------------------------------

class IndexRearmError(RuntimeError):
    """The resident index could not be rebuilt on its device after a
    wholesale table rewrite (a snapshot restore).  The rewrite is rolled
    back with it, so tables and index stay the pre-restore pair; nothing
    falls back to SQL."""


class DeviceUtxoIndex:
    """Sorted-fingerprint UTXO index resident on a device, one per
    UTXO-class table: 128-bit effective identity, the amount lanes, a
    bounded undo log, and a shadow map consulted only on declared
    ambiguity.  ``device`` is the card unless ``"cpu"``."""

    #: undo records retained for O(delta) reorg rollback
    UNDO_DEPTH = 64

    def __init__(self, outpoints: Iterable[Outpoint] = (),
                 values: Optional[Sequence[tuple]] = None,
                 device: DeviceLike = None):
        self.device = resolve(device)
        # fp64 -> live outpoints with that fingerprint; a list, so
        # duplicates mirror the multiset semantics and twins stay
        # individually tracked
        self._shadow: Dict[int, List[Outpoint]] = {}
        # fingerprints that EVER held >= 2 live outpoints (sticky: a
        # surviving twin's row may carry its spent sibling's check lanes)
        self._twin_fps: set = set()
        self._twins_arr: Optional[np.ndarray] = None
        self._host_keys = np.zeros(0, dtype=np.uint64)   # sorted fp64
        self._host_chk = np.zeros(0, dtype=np.uint64)    # aligned check
        self._host_amount = np.zeros(0, dtype=np.int64)  # aligned values
        self._dirty = True
        self._dev: Optional[torch.Tensor] = None       # (6, cap) lanes
        # the probe's prepared arguments and the lanes' (pointer, shape,
        # device) they were prepared from, both set at each upload
        self._args: Optional[ProbeArgs] = None
        self._dev_seal: Optional[tuple] = None
        self._staging: Optional[torch.Tensor] = None   # (6, cap) host
        self._undo: deque = deque(maxlen=self.UNDO_DEPTH)
        self._probes = 0
        self._shadow_consults = 0
        ops = [tuple(o) for o in outpoints]
        if ops:
            self.add(ops, values)

    def __len__(self):
        return int(self._host_keys.shape[0])

    # ------------------------------------------------------------ values --

    @staticmethod
    def _norm_amounts(n: int, values: Optional[Sequence[tuple]]) -> np.ndarray:
        """(n,) int64 amounts from the optional per-outpoint (amount, ...)
        value tuples; zero where unknown.  The JAX index also keeps each
        tuple's script hash and height, which nothing in the port reads."""
        amt = np.zeros(n, dtype=np.int64)
        if values is not None:
            for i, v in enumerate(values):
                if v:
                    amt[i] = int(v[0] or 0)
        return amt

    def _capture_values(self, outpoints: Sequence[Outpoint]) -> List[tuple]:
        """(amount,) rows for live outpoints (zero when absent), taken
        before a spend so the undo log can restore them."""
        out: List[tuple] = []
        if not outpoints:
            return out
        fps = fingerprint_batch(outpoints)
        chks = check_batch(outpoints)
        lo = np.searchsorted(self._host_keys, fps, side="left")
        hi = np.searchsorted(self._host_keys, fps, side="right")
        for i in range(len(outpoints)):
            amount = 0
            for j in range(int(lo[i]), int(hi[i])):
                if self._host_chk[j] == chks[i]:
                    amount = int(self._host_amount[j])
                    break
            out.append((amount,))
        return out

    # ------------------------------------------------------------ updates --

    def add(self, outpoints: Iterable[Outpoint],
            values: Optional[Sequence[tuple]] = None) -> None:
        ops = [tuple(o) for o in outpoints]
        if not ops:
            return
        fps = fingerprint_batch(ops)
        chks = check_batch(ops)
        for o, fp in zip(ops, fps.tolist()):
            bucket = self._shadow.setdefault(fp, [])
            bucket.append(o)
            if len(bucket) >= 2 and fp not in self._twin_fps:
                self._twin_fps.add(fp)
                self._twins_arr = None
        amt = self._norm_amounts(len(ops), values)
        # incremental sorted insert: sort only the slab, then splice it in
        order = np.argsort(fps, kind="stable")
        slab = fps[order]
        pos = np.searchsorted(self._host_keys, slab)
        self._host_keys = np.insert(self._host_keys, pos, slab)
        self._host_chk = np.insert(self._host_chk, pos, chks[order])
        self._host_amount = np.insert(self._host_amount, pos, amt[order])
        self._dirty = True

    def remove(self, outpoints: Iterable[Outpoint]) -> None:
        ops = [tuple(o) for o in outpoints]
        if not ops:
            return
        doomed: List[Tuple[int, int]] = []  # (fp, chk) of live removals
        fps = fingerprint_batch(ops)
        chks = check_batch(ops)
        for o, fp, chk in zip(ops, fps.tolist(), chks.tolist()):
            bucket = self._shadow.get(fp)
            if bucket is None or o not in bucket:
                continue  # absent: a no-op, as the SQL DELETE
            bucket.remove(o)
            if not bucket:
                del self._shadow[fp]
            doomed.append((fp, chk))
        if not doomed:
            return
        rem_fps = np.array([d[0] for d in doomed], dtype=np.uint64)
        lo = np.searchsorted(self._host_keys, rem_fps, side="left")
        hi = np.searchsorted(self._host_keys, rem_fps, side="right")
        marked: set = set()
        for (fp, chk), l, h in zip(doomed, lo.tolist(), hi.tolist()):
            # within the equal-fp run, the row whose check lanes match;
            # the k-th duplicate for true 128-bit twins
            pick = None
            for j in range(l, h):
                if j not in marked and self._host_chk[j] == chk:
                    pick = j
                    break
            if pick is None:
                for j in range(l, h):
                    if j not in marked:
                        pick = j
                        break
            if pick is not None:
                marked.add(pick)
        if not marked:
            return
        gone = np.fromiter(marked, dtype=np.int64, count=len(marked))
        self._host_keys = np.delete(self._host_keys, gone)
        self._host_chk = np.delete(self._host_chk, gone)
        self._host_amount = np.delete(self._host_amount, gone)
        self._dirty = True

    def apply_block(self, created: Sequence[Outpoint],
                    spent: Sequence[Outpoint],
                    created_values: Optional[Sequence[tuple]] = None,
                    materialize: bool = False) -> None:
        """Batched spend/create of one accepted block, recorded in the
        undo log for :meth:`rollback_block`; ``materialize=True`` uploads
        now instead of at the next probe."""
        spent = [tuple(o) for o in spent]
        created = [tuple(o) for o in created]
        spent_values = self._capture_values(spent) if spent else []
        if spent:
            self.remove(spent)
        if created:
            self.add(created, created_values)
        self._undo.append((created, spent, spent_values))
        if materialize and (created or spent):
            self.materialize()

    def rollback_block(self) -> bool:
        """Inverse of the most recent :meth:`apply_block`; False when the
        undo log is exhausted."""
        if not self._undo:
            return False
        created, spent, spent_values = self._undo.pop()
        if created:
            self.remove(created)
        if spent:
            self.add(spent, spent_values)
        return True

    def undo_depth(self) -> int:
        return len(self._undo)

    # ------------------------------------------------------ device state --

    def _device_state(self) -> Tuple[torch.Tensor, int]:
        """((6, cap) int32 lanes on the device, n_live), uploaded first
        when the host state changed: the lanes are written into a staging
        buffer (pinned on a card) and copied in one host-to-device copy
        into lanes kept while the capacity holds."""
        if self._dirty or self._dev is None:
            t0 = time.perf_counter()
            n = len(self._host_keys)
            cap = _pow2(n)
            if self._staging is None or self._staging.shape[1] != cap:
                self._staging = torch.empty(
                    (6, cap), dtype=torch.int32,
                    pin_memory=self.device.type == "cuda")
                self._dev = None
            host = self._staging.numpy()
            chk_a, chk_b = _eq_lanes(self._host_chk)
            amt_u = self._host_amount.view(np.uint64)
            for r, lane in enumerate((
                    _lane_hi(self._host_keys), _lane_lo(self._host_keys),
                    chk_a, chk_b,
                    (amt_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                    (amt_u >> np.uint64(32)).astype(np.uint32))):
                host[r, :n] = lane.view(np.int32)
                host[r, n:] = _PADS[r]
            if self.device.type == "cpu":
                self._dev = self._staging
            else:
                if self._dev is None:
                    self._dev = torch.empty((6, cap), dtype=torch.int32,
                                            device=self.device)
                self._dev.copy_(self._staging)
            self._args = ProbeArgs(self._dev.unbind(0), n)
            self._dev_seal = self._seal(self._dev)
            self._dirty = False
            ktel.record_batch("utxo_apply", real=n, padded=cap,
                              seconds=time.perf_counter() - t0)
        return self._dev, len(self._host_keys)

    @staticmethod
    def _seal(lanes: torch.Tensor) -> tuple:
        return lanes.data_ptr(), lanes.shape, lanes.device

    def _probe_args(self) -> ProbeArgs:
        """The prepared probe arguments of the current lanes (uploaded
        first when the host state changed).  Raises when the resident
        lanes changed pointer, shape or device since they were
        prepared."""
        self._device_state()
        if self._seal(self._dev) != self._dev_seal:
            raise ValueError(
                f"the resident lanes changed since the upload: "
                f"{self._seal(self._dev)} against {self._dev_seal}")
        return self._args

    def materialize(self) -> None:
        """Upload the current host state now, through the runtime
        (kernel ``utxo_apply``), instead of at the next probe."""
        get_runtime(self.device).submit_call(
            self._device_state, kernel="utxo_apply", source="index").result()

    def resident_bytes(self) -> int:
        """Device residency: six int32 lanes at padded capacity."""
        return 6 * 4 * _pow2(len(self._host_keys))

    def stats(self) -> dict:
        return {
            "entries": len(self),
            "capacity": _pow2(len(self._host_keys)),
            "resident_bytes": self.resident_bytes(),
            "probes": self._probes,
            "shadow_consults": self._shadow_consults,
            "twin_fingerprints": len(self._twin_fps),
            "undo_depth": len(self._undo),
        }

    # ------------------------------------------------------------ queries --

    def _twins_sorted(self) -> np.ndarray:
        if self._twins_arr is None:
            self._twins_arr = np.array(
                sorted(self._twin_fps), dtype=np.uint64)
        return self._twins_arr

    def _probe_launch(self, fps: np.ndarray,
                      chks: np.ndarray) -> np.ndarray:
        """Upload the queries and launch the probe; returns the host
        buffer its one output buffer is being copied into (not yet
        complete on a card; :func:`split_host` splits it)."""
        args = self._probe_args()
        lanes = query_lanes(fps, chks)
        if self.device.type == "cpu":
            return launch(args, torch.from_numpy(lanes)).numpy()
        staged = torch.empty(lanes.shape, dtype=torch.int32, pin_memory=True)
        staged.numpy()[:] = lanes
        out = launch(args, staged.to(self.device, non_blocking=True))
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host.numpy()

    def _probe_finish(self, ops: Sequence[Outpoint], fps: np.ndarray,
                      out: np.ndarray, t0: float) -> tuple:
        """The host post-process of one probe whose output buffer is on
        the host: ambiguity, shadow consults, amounts.  Returns (present
        bool[N], maybe bool[N], amounts int64[N], shadow_consults)."""
        n = len(ops)
        hit, key_hit, overflow, amt_lo, amt_hi = split_host(out, n)
        ambiguous = overflow.copy()
        twins = self._twins_sorted()
        if twins.size:
            ambiguous |= (key_hit & np.isin(fps, twins))
        present = hit & ~ambiguous
        consults = 0
        for i in np.nonzero(ambiguous)[0]:
            bucket = self._shadow.get(int(fps[i]))
            present[i] = bucket is not None and tuple(ops[i]) in bucket
            consults += 1
        amounts = ((amt_hi.view(np.uint32).astype(np.uint64)
                    << np.uint64(32))
                   | amt_lo.view(np.uint32).astype(np.uint64)
                   ).view(np.int64)
        amounts = np.where(present & ~ambiguous, amounts, 0)
        maybe = key_hit | overflow
        self._probes += 1
        self._shadow_consults += consults
        ktel.record_batch("utxo_probe", real=n, padded=n,
                          seconds=time.perf_counter() - t0,
                          compile_key=("utxo_probe",)
                          if self.device.type == "cuda" else None)
        ktel.record_index_probe(n, consults, int(ambiguous.sum()))
        return present, maybe, amounts, consults

    def _probe_eval(self, ops: Sequence[Outpoint], fps: np.ndarray,
                    chks: np.ndarray) -> tuple:
        """One probe and its host post-process (see
        :meth:`_probe_finish`)."""
        t0 = time.perf_counter()
        out = self._probe_launch(fps, chks)
        _synchronize(self.device)
        return self._probe_finish(ops, fps, out, t0)

    def _probe(self, outpoints: Sequence[Outpoint]) -> tuple:
        """One probe dispatch through the runtime."""
        ops = [tuple(o) for o in outpoints]
        fps, chks = fingerprint_batch(ops), check_batch(ops)
        return get_runtime(self.device).submit_call(
            lambda: self._probe_eval(ops, fps, chks), kernel="utxo_probe",
            source="index").result()

    def maybe_contains_batch(self, outpoints: Sequence[Outpoint]) -> np.ndarray:
        """(N,) bool prefilter: False is definitive absence; True a
        fingerprint hit."""
        if not outpoints:
            return np.zeros(0, dtype=bool)
        return self._probe(outpoints)[1]

    def contains_batch(self, outpoints: Sequence[Outpoint]) -> np.ndarray:
        """(N,) bool EXACT membership in one probe; the shadow map answers
        only what the probe declares ambiguous."""
        if not outpoints:
            return np.zeros(0, dtype=bool)
        return self._probe(outpoints)[0]

    def lookup_batch(self, outpoints: Sequence[Outpoint]) -> tuple:
        """(present bool[N], amounts int64[N]) in one probe."""
        if not outpoints:
            return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int64)
        present, _maybe, amounts, _c = self._probe(outpoints)
        return present, amounts

    def shadow_contains_batch(self, outpoints: Sequence[Outpoint]) -> np.ndarray:
        """(N,) bool membership from the host shadow map alone; never
        probes."""
        out = np.zeros(len(outpoints), dtype=bool)
        if not len(outpoints):
            return out
        ops = [tuple(o) for o in outpoints]
        for i, (o, fp) in enumerate(
                zip(ops, fingerprint_batch(ops).tolist())):
            bucket = self._shadow.get(fp)
            out[i] = bucket is not None and o in bucket
        return out

    def missing(self, outpoints: Sequence[Outpoint]) -> List[Outpoint]:
        """Outpoints that are definitely absent (exact)."""
        present = self.contains_batch(outpoints)
        return [o for o, m in zip(outpoints, present) if not m]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def fused_probe(parts: Sequence[Tuple[DeviceUtxoIndex, Sequence[Outpoint]]],
                extra_fn: Optional[Callable] = None,
                source: str = "index") -> tuple:
    """Probe every ``(index, outpoints)`` part and run ``extra_fn`` (the
    micro-batch's digest batch) in one runtime slot (``kernel=
    "accept_fused"``): every probe is launched and its results queued for
    the host first, ``extra_fn`` runs while the card works, then one
    synchronisation and the host post-processes.

    Returns ``([(present, amounts, shadow_consults), ...], extra)`` with
    parts in input order."""
    staged = []
    for index, outpoints in parts:
        ops = [tuple(o) for o in outpoints]
        staged.append((index, ops, fingerprint_batch(ops) if ops else None))

    def run():
        t0 = time.perf_counter()
        pending = []
        for index, ops, fps in staged:
            launched = None if not ops else index._probe_launch(
                fps, check_batch(ops))
            pending.append((index, ops, fps, launched))
        extra = extra_fn() if extra_fn is not None else None
        for device in {index.device for index, *_ in pending}:
            _synchronize(device)
        results = []
        for index, ops, fps, launched in pending:
            if launched is None:
                results.append((np.zeros(0, dtype=bool),
                                np.zeros(0, dtype=np.int64), 0))
                continue
            present, _maybe, amounts, consults = index._probe_finish(
                ops, fps, launched, t0)
            results.append((present, amounts, consults))
        return results, extra

    if not staged:
        return [], (extra_fn() if extra_fn is not None else None)
    return get_runtime(staged[0][0].device).submit_call(
        run, kernel="accept_fused", source=source).result()
