"""Batched NIST P-256 ECDSA verification: one CUDA kernel per batch.

The JAX package verifies a block's signatures with ``_scalar_prep`` (an
XLA program) followed by one of its Pallas ladders
(``upow_tpu/crypto/p256.py``).  Here prep and ladder run in ONE
hand-written CUDA launch, four threads to a signature, in either of two
kernels that share their field arithmetic and scalar prep
(``csrc/p256_common.cuh``): s^-1 mod n by Fermat (fixed 4-bit window over
n - 2), u1 = z * s^-1 and u2 = r * s^-1, the on-curve check and the
window digits; then a Strauss ladder for u1*G + u2*Q:

* ``csrc/p256_verify.cu`` and ``csrc/p256_verify_wide.cu``
  (``VERIFY_KERNEL = "jac"``, the default) port ``_ladder_kernel_jac`` at
  every window the JAX package's config admits (:data:`VERIFY_WINDOW`, 2
  to 13; 4 is the default and 5 kernel B7): the first with its tables in
  shared memory at w = 2-5, the second with its Q tables in device memory
  at w = 6-13, each built by up to 32 groups of four (:func:`wide_plan`).
  Jacobian coordinates, each of ceil(256 / w) rounds w
  doublings (dbl-2001-b), a mixed add (madd-2007-bl) from the affine G
  table and a general add (add-2007-bl) from a 2^w - 1 entry Q table
  built per lane.  A zero digit keeps the accumulator, a not-yet-started
  accumulator takes the picked point, and H == 0 with both operands
  real sets the lane's exception flag; accept <=> X == r*Z^2 or
  (r + n < p and X == (r+n)*Z^2), R finite.  Output bit 0 is the verdict, bit 1 the
  exception flag; flagged lanes (cryptographically unreachable for
  honest signatures) are re-verified on the host oracle, exactly as the
  JAX package does, and both bits match the JAX kernel lane for lane.
* ``csrc/p256_complete.cu`` (``VERIFY_KERNEL = "complete"``) ports
  ``_ladder_kernel_list`` and ``_ladder_kernel``: the RCB16 complete
  formulas (a = -3, homogeneous projective), w = 4 always, a 16-entry Q
  table with the identity at 0, and accept <=> X == r*Z or (r + n < p
  and X == (r+n)*Z), Z != 0.  Complete formulas have no exceptional inputs, so bit 1 is
  always 0 and no lane reaches the host oracle.

Beside each kernel lives its plain PyTorch version (:func:`verify_plain`,
:func:`verify_complete_plain`), the same function over int64 tensors
(:mod:`.fp`).  The wrappers :func:`verify_packed` and
:func:`verify_complete_packed` launch the kernel for a CUDA tensor and
run the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling, trace
from ..core import curve as host_curve
from ..core.codecs import is_on_curve
from ..core.constants import CURVE_B, CURVE_N, CURVE_P
from ..device import DeviceLike, resolve
from ..telemetry import device as _ktel
from . import fp

PACKED_ROWS = 42           # z, r, s, qx, qy (8 words each), range_ok, rn_ok
WINDOWS = tuple(range(2, 14))  # the Jacobian ladder's windows: every one
                           # device.verify_window admits, as in the JAX
                           # package
SHARED_WINDOWS = (2, 3, 4, 5)  # tables in shared memory (p256_verify.cu);
                           # the rest are p256_verify_wide.cu's
ENV_WINDOWS = (4, 5)       # what UPOW_JAC_WINDOW takes, as in the JAX
                           # package
DEFAULT_WINDOW = 4         # the JAX package's default, and the complete
                           # ladder's only window
INV_WINDOW = 4             # the prep's fixed window over n - 2 (s^-1),
                           # whatever the ladder's: as the JAX package's
                           # _mod_n_inv_mont
G_ENTRIES = 31             # [k]G in the kernels' constant table: the
                           # shared-memory windows' (w <= 5)
Q_ENTRY_BYTES = 160        # a Q-table entry: X, Y, Z, Z^2, Z^3
G_ENTRY_BYTES = 64         # a G-table entry: affine x, y
WIDE_GROUPS = (1, 2, 4, 8, 16, 32)  # groups of four the wide kernel may
                           # give one signature (32: the whole block)


def rounds(w: int) -> int:
    """Ladder rounds of a w-bit window: ceil(256 / w) (64 at w = 4, 52
    at w = 5, whose top digit reads zero bits past 256)."""
    return -(-256 // w)


def table(w: int) -> int:
    """Table entries of a w-bit window, [1]P .. [2^w - 1]P."""
    return (1 << w) - 1

FP = fp.Field(CURVE_P)
FN = fp.Field(CURVE_N)

# Which ladder verify_batch_prehashed runs: "jac" (the Jacobian kernel,
# exception lanes re-checked on the host oracle) or "complete" (the RCB16
# complete-formula kernel, no exception lanes).  Module-level, as the JAX
# package's PALLAS_KERNEL, so node, tests and chip_smoke.py see one value;
# config.DeviceConfig.apply_kernel_overrides sets it.
VERIFY_KERNEL = "jac"
VERIFY_KERNELS = ("jac", "complete")


def _env_window() -> int:
    """The JAX package's parse of ``UPOW_JAC_WINDOW`` (``p256.py``
    ``_env_choice``): 4 or 5; anything else logs and keeps 4, so a node
    never starts on an unvetted window (``device.verify_window`` takes
    the others)."""
    name = "UPOW_JAC_WINDOW"
    raw = os.environ.get(name)
    if raw is None:
        return DEFAULT_WINDOW
    try:
        val = int(raw.strip())
    except ValueError:
        val = None
    if val not in ENV_WINDOWS:
        logging.getLogger("upow_tpu_torch.crypto").warning(
            "%s=%r invalid (allowed %s); using %d", name, raw,
            sorted(ENV_WINDOWS), DEFAULT_WINDOW)
        return DEFAULT_WINDOW
    return val


# The Jacobian ladder's window (the JAX package's PALLAS_JAC_WINDOW): read
# from UPOW_JAC_WINDOW at import; config.DeviceConfig.apply_kernel_overrides
# sets it from device.verify_window.
VERIFY_WINDOW = _env_window()

# Plain integers, read by chip_smoke.py: launches of each kernel, and lanes
# the Jacobian kernel or its plain version flagged for the host oracle.
# Verifies run on executor threads, so updates take the lock.
# LAUNCHES counts the Jacobian kernel at every window, LAUNCHES_BY_WINDOW
# splits it by window.
LAUNCHES = 0
LAUNCHES_BY_WINDOW = {w: 0 for w in WINDOWS}
COMPLETE_LAUNCHES = 0
EXCEPTION_LANES = 0
_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, COMPLETE_LAUNCHES, EXCEPTION_LANES
    with _COUNT_LOCK:
        LAUNCHES = 0
        for w in LAUNCHES_BY_WINDOW:
            LAUNCHES_BY_WINDOW[w] = 0
        COMPLETE_LAUNCHES = 0
        EXCEPTION_LANES = 0


# --- host packing (same bytes as the JAX package's) ----------------------

def _pack_words(xs, pad: int) -> np.ndarray:
    """Host ints (< 2^256) -> (8, N+pad) uint32 little-endian words."""
    n = len(xs)
    raw = b"".join(x.to_bytes(32, "little") for x in xs)
    w = np.frombuffer(raw, dtype="<u4").reshape(n, 8).T
    return np.pad(w, ((0, 0), (0, pad)), constant_values=0)


def _pack_device_inputs(digests, signatures, pubkeys, padded: int):
    """Sanitize scalars and pack them into ONE fused (42, padded) uint32
    array: rows 0-39 are five (8, N) little-endian word arrays (z, r, s,
    qx, qy), rows 40/41 the host-checked range_ok / rn_ok masks.
    Returns (fused, zs, rs, ss, qxs, qys); the int lists feed the host
    oracle for exception-flagged lanes."""
    n = len(digests)

    def sane(x):  # out-of-[0, 2^256) scalars never reach the word packer
        return x if 0 <= x < (1 << 256) else 0

    def coord(x):
        # the reference's fastecdsa computes everything mod p, so a
        # coordinate in [p, 2^256) encodes the reduced point — accept
        # it identically (consensus parity); reduce oversized/negative
        # ints the way Python % does on the host oracle path
        return x if 0 <= x < (1 << 256) else x % CURVE_P

    # u1 depends only on z mod n, so oversized digests (a direct API
    # caller hashing with sha512, say) reduce exactly like the host's
    # z*w % n — never an exception where the host returns a verdict
    zs = [z if z < (1 << 256) else z % CURVE_N
          for z in (int.from_bytes(d, "big") for d in digests)]
    rs = [sig[0] for sig in signatures]
    ss = [sig[1] for sig in signatures]
    qxs = [coord(pk[0]) for pk in pubkeys]
    qys = [coord(pk[1]) for pk in pubkeys]
    range_ok = np.array(
        [0 < r_ < CURVE_N and 0 < s_ < CURVE_N
         and not (qx_ == 0 and qy_ == 0)
         for r_, s_, (qx_, qy_) in zip(rs, ss, pubkeys)], dtype=bool)
    rn_ok = np.array([0 < r_ and r_ + CURVE_N < CURVE_P for r_ in rs],
                     dtype=bool)
    fused = np.zeros((PACKED_ROWS, padded), dtype=np.uint32)
    for i, xs in enumerate((zs, [sane(r_) for r_ in rs],
                            [sane(s_) for s_ in ss], qxs, qys)):
        fused[8 * i:8 * i + 8, :n] = _pack_words(xs, 0)
    fused[40, :n] = range_ok
    fused[41, :n] = rn_ok
    return fused, zs, rs, ss, qxs, qys


def packed_tensor(fused: np.ndarray, device) -> torch.Tensor:
    """(42, N) uint32 numpy -> the same bits as a (42, N) int32 tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(fused).view(np.int32)).to(device)


# --- host oracle ---------------------------------------------------------

def _host_verify_prehashed(z: int, r: int, s: int, qx: int, qy: int) -> bool:
    """Host oracle for exception-flagged lanes — the exact device
    semantics: range checks, coordinate reduction mod p (fastecdsa
    parity), on-curve check, then x(u1*G + u2*Q) == r (mod n)."""
    if not (0 < r < CURVE_N and 0 < s < CURVE_N):
        return False
    if qx == 0 and qy == 0:
        return False
    qx, qy = qx % CURVE_P, qy % CURVE_P
    if not is_on_curve((qx, qy)):
        return False
    w = pow(s, -1, CURVE_N)
    u1, u2 = z * w % CURVE_N, r * w % CURVE_N
    pt = host_curve.point_add(host_curve.point_mul(u1, host_curve.G),
                              host_curve.point_mul(u2, (qx, qy)))
    return pt is not None and pt[0] % CURVE_N == r


# --- the plain PyTorch version -------------------------------------------

def _nm2_digits() -> list:
    """INV_WINDOW-bit digits of the fixed exponent n - 2, most
    significant first."""
    e, n = CURVE_N - 2, rounds(INV_WINDOW)
    return [(e >> (INV_WINDOW * (n - 1 - k))) & table(INV_WINDOW)
            for k in range(n)]


@functools.lru_cache(maxsize=None)
def _g_multiples(count: int = G_ENTRIES) -> Tuple[Tuple[int, int], ...]:
    """Affine [k]G for k = 1..count, each by one addition to the last
    (8,191 of them at w = 13)."""
    pts = [host_curve.G]
    while len(pts) < count:
        pts.append(host_curve.point_add(pts[-1], host_curve.G))
    return tuple(pts)


_G_PLAIN = {}  # (device, w) -> (2^w - 1, 2, 12) int64 Montgomery limbs


def _g_table_plain(device, w: int = DEFAULT_WINDOW) -> torch.Tensor:
    key = (str(device), w)
    if key not in _G_PLAIN:
        rows = [[fp.int_to_limbs(FP.to_mont(c)) for c in pt]
                for pt in _g_multiples(table(w))]
        _G_PLAIN[key] = torch.tensor(rows, dtype=torch.int64, device=device)
    return _G_PLAIN[key]


def _words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, N) int32 little-endian words -> (12, N) int64 24-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = torch.cat([w, w.new_zeros(2, w.shape[1])])
    bit = torch.arange(fp.NUM_LIMBS, device=w.device) * fp.LIMB_BITS
    word, off = bit // 32, (bit % 32)[:, None]
    v = (w[word] >> off) | (w[word + 1] << (32 - off))
    return v & fp.LIMB_MASK


def _digits(limbs: torch.Tensor, w: int = DEFAULT_WINDOW) -> torch.Tensor:
    """(12, N) canonical 24-bit limbs -> (rounds(w), N) w-bit digits, MSB
    first (the JAX package's ``_digits_from_limbs``).  A digit may span
    two limbs; the top digit of an uneven split reads zero bits past 256."""
    bit = torch.arange(rounds(w), device=limbs.device) * w
    j, off = bit // fp.LIMB_BITS, (bit % fp.LIMB_BITS)[:, None]
    v = (limbs[j] >> off) | (limbs[j + 1] << (fp.LIMB_BITS - off))
    return (v & table(w)).flip(0)


def _muls(*pairs) -> tuple:
    """Independent mod-p products of one dependency level, in one call."""
    return fp.mul_many(pairs, FP)


def _jac_dbl(P):
    """dbl-2001-b (a = -3): 3M + 5S, in four levels of products."""
    X, Y, Z = P
    delta, gamma, yz2 = _muls((Z, Z), (Y, Y), (Y + Z, Y + Z))
    beta, xx, g2 = _muls((X, gamma), (X - delta, X + delta), (gamma, gamma))
    alpha = 3 * xx
    X3 = fp.sqr(alpha, FP) - 8 * beta
    Y3 = fp.mul(alpha, 4 * beta - X3, FP) - 8 * g2
    Z3 = yz2 - gamma - delta
    return X3, Y3, Z3


def _jac_madd(P1, x2, y2):
    """madd-2007-bl (P2 affine): 7M + 4S, in five levels.  Returns
    (P3, H)."""
    X1, Y1, Z1 = P1
    z1z1 = fp.sqr(Z1, FP)
    u2, z1c = _muls((x2, z1z1), (Z1, z1z1))
    H = u2 - X1
    s2, hh, zh2 = _muls((y2, z1c), (H, H), (Z1 + H, Z1 + H))
    i4 = 4 * hh
    rr = 2 * (s2 - Y1)
    j, v, rr2 = _muls((H, i4), (X1, i4), (rr, rr))
    X3 = rr2 - j - 2 * v
    y1j, t = _muls((Y1, j), (rr, v - X3))
    Y3 = t - 2 * y1j
    Z3 = zh2 - z1z1 - hh
    return (X3, Y3, Z3), H


def _jac_add(P1, P2):
    """add-2007-bl (both Jacobian): 11M + 5S, in five levels.  Returns
    (P3, H)."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    z1z1, z2z2 = _muls((Z1, Z1), (Z2, Z2))
    u1, u2, z2c, z1c, zz = _muls((X1, z2z2), (X2, z1z1), (Z2, z2z2),
                                 (Z1, z1z1), (Z1 + Z2, Z1 + Z2))
    H = u2 - u1
    s1, s2, i = _muls((Y1, z2c), (Y2, z1c), (2 * H, 2 * H))
    rr = 2 * (s2 - s1)
    j, v, rr2, Z3 = _muls((H, i), (u1, i), (rr, rr), (zz - z1z1 - z2z2, H))
    X3 = rr2 - j - 2 * v
    t, s1j = _muls((rr, v - X3), (s1, j))
    Y3 = t - 2 * s1j
    return (X3, Y3, Z3), H


def _apply_add(acc, res, H, pick, dg, started, exc):
    """The post-add selects of both add sites: a zero digit keeps the
    accumulator, a not-yet-started accumulator takes the pick, H == 0
    with both operands real flags the lane, else the formula result."""
    pick_id = dg == 0
    take_pick = ~started & ~pick_id
    exc = exc | (fp.is_zero(H, FP) & ~pick_id & started)
    out = tuple(torch.where(take_pick, p, torch.where(pick_id, a, r))
                for a, r, p in zip(acc, res, pick))
    return out, started | ~pick_id, exc


def _prep_plain(packed: torch.Tensor, w: int = DEFAULT_WINDOW):
    """The kernels' shared scalar prep (csrc/p256_common.cuh) on (42, N)
    packed inputs: w-bit window digits of u1 and u2 (rounds(w), N),
    Montgomery forms of qx, qy, r and r + n mod p, and the valid / rn_ok
    lane masks.  s^-1 takes INV_WINDOW bits a step whatever w is."""
    dev = packed.device
    n = packed.shape[1]
    z, r, s, qx, qy = (_words_to_limbs(packed[8 * i:8 * i + 8])
                       for i in range(5))
    range_ok, rn_ok = packed[40] != 0, packed[41] != 0

    # mod n: w = s^-1, u1 = z*w, u2 = r*w (Montgomery domain throughout)
    def nmul(a, b):
        return fp.mul(a, b, FN)

    r2n = FN.const(FN.r2_mod_m, dev)
    s_m = nmul(s, r2n)
    pows = [FN.const(FN.r_mod_m, dev).expand(-1, n), s_m]
    for _ in range(table(INV_WINDOW) - 1):
        pows.append(nmul(pows[-1], s_m))
    w_m = pows[0]
    for d in _nm2_digits():
        for _ in range(INV_WINDOW):
            w_m = nmul(w_m, w_m)
        w_m = nmul(w_m, pows[d])
    u1 = fp.canonical_from_mont(nmul(nmul(z, r2n), w_m), FN)
    u2 = fp.canonical_from_mont(nmul(nmul(r, r2n), w_m), FN)

    # mod p: Montgomery forms of Q, r and r + n; y^2 == x^3 - 3x + b
    r2p = FP.const(FP.r2_mod_m, dev)
    qx_m, qy_m = fp.mul(qx, r2p, FP), fp.mul(qy, r2p, FP)
    r_m = fp.mul(r, r2p, FP)
    rn_m = fp.mul(r + FP.const(CURVE_N, dev), r2p, FP)
    rhs = fp.mul(fp.sqr(qx_m, FP), qx_m, FP) - 3 * qx_m \
        + FP.const(FP.to_mont(CURVE_B), dev)
    valid = range_ok & fp.eq(fp.sqr(qy_m, FP), rhs, FP)
    return (_digits(u1, w), _digits(u2, w), qx_m, qy_m, r_m, rn_m, valid,
            rn_ok)


def _qtable_plain(qx_m: torch.Tensor, qy_m: torch.Tensor, w: int
                  ) -> torch.Tensor:
    """The Q table, (2^w - 1, 3, 12, N): [1]Q = (qx, qy, 1), [2]Q = dbl,
    then [k]Q = [k-1]Q + Q by madd, written into one tensor as it goes
    (19.3 GB at w = 13 and 8,192 lanes)."""
    n = qx_m.shape[1]
    out = qx_m.new_empty((table(w), 3, fp.NUM_LIMBS, n))
    e = (qx_m, qy_m, FP.const(FP.r_mod_m, qx_m.device).expand(-1, n))
    for k in range(table(w)):
        if k:
            e = _jac_dbl(e) if k == 1 else _jac_madd(e, qx_m, qy_m)[0]
        for c in range(3):
            out[k, c] = e[c]
    return out


def verify_plain(packed: torch.Tensor, w: int = DEFAULT_WINDOW
                 ) -> torch.Tensor:
    """The kernel's function in plain PyTorch at window ``w``: (42, N)
    int32 packed inputs -> (N,) int32, bit 0 verdict and bit 1 exception
    flag."""
    prep = _prep_plain(packed, w)
    return _ladder_plain(prep, _qtable_plain(prep[2], prep[3], w), w)


def _ladder_plain(prep: tuple, qtab: torch.Tensor, w: int,
                  n_rounds: Optional[int] = None) -> torch.Tensor:
    """:func:`verify_plain` after its prep and Q table: the ladder and the
    final test.  ``n_rounds`` stops the ladder after that many rounds
    (the JAX package's ``_jac_verify_eager`` has the same knob, for
    short ladders); the default runs all ``rounds(w)``."""
    d1, d2, qx_m, qy_m, r_m, rn_m, valid, rn_ok = prep
    dev = qx_m.device
    n = qx_m.shape[1]
    gtab = _g_table_plain(dev, w)                         # (2^w-1, 2, 12)
    lanes = torch.arange(n, device=dev)

    one = FP.const(FP.r_mod_m, dev).expand(-1, n)
    acc = (one, one, torch.zeros_like(one))
    started = torch.zeros(n, dtype=torch.bool, device=dev)
    exc = torch.zeros(n, dtype=torch.bool, device=dev)
    for k in range(rounds(w) if n_rounds is None else n_rounds):
        for _ in range(w):
            acc = _jac_dbl(acc)
        g = gtab[(d1[k] - 1).clamp(min=0)].permute(1, 2, 0)  # (2, 12, N)
        res, H = _jac_madd(acc, g[0], g[1])
        acc, started, exc = _apply_add(acc, res, H, (g[0], g[1], one),
                                       d1[k], started, exc)
        q = qtab[(d2[k] - 1).clamp(min=0), :, :, lanes].permute(1, 2, 0)
        q = (q[0], q[1], q[2])
        res, H = _jac_add(acc, q)
        acc, started, exc = _apply_add(acc, res, H, q, d2[k], started, exc)

    X, _Y, Z = acc
    z2 = fp.sqr(Z, FP)
    at_inf = fp.is_zero(Z, FP) | ~started
    ok = fp.eq(X, fp.mul(r_m, z2, FP), FP) | (
        rn_ok & fp.eq(X, fp.mul(rn_m, z2, FP), FP))
    verdict = ok & ~at_inf & valid
    return verdict.to(torch.int32) | (exc.to(torch.int32) << 1)


# --- the complete-formula version (RCB16, a = -3) --------------------------

def _point_add_rcb16(P1, P2, b):
    """Renes-Costello-Batina 2016, Algorithm 4 (a = -3, homogeneous
    projective), in the JAX package's operand order: 12 products + 2 by
    b, correct for every pair of inputs, the identity (0 : 1 : 0) and
    P1 == P2 included.  Additions stay lazy (fp.py's bounds: no value
    here exceeds 16 p in magnitude)."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2

    def mul(a, c):
        return fp.mul(a, c, FP)

    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = mul(X1 + Y1, X2 + Y2) - (t0 + t1)
    t4 = mul(Y1 + Z1, Y2 + Z2) - (t1 + t2)
    Y3 = mul(X1 + Z1, X2 + Z2) - (t0 + t2)
    return _rcb16_tail(t0, t1, t2, t3, t4, Y3, b)


def _point_dbl_rcb16(P, b):
    """The same sequence with P1 == P2, its six same-operand products
    squared (the JAX package's ``_point_dbl_rcb16``)."""
    X1, Y1, Z1 = P

    def sqr(a):
        return fp.sqr(a, FP)

    t0, t1, t2 = sqr(X1), sqr(Y1), sqr(Z1)
    t3 = sqr(X1 + Y1) - (t0 + t1)
    t4 = sqr(Y1 + Z1) - (t1 + t2)
    Y3 = sqr(X1 + Z1) - (t0 + t2)
    return _rcb16_tail(t0, t1, t2, t3, t4, Y3, b)


def _rcb16_tail(t0, t1, t2, t3, t4, Y3, b):
    """Algorithm 4 from ``Z3 = b * t2`` on, shared by add and double."""
    def mul(a, c):
        return fp.mul(a, c, FP)

    X3 = Y3 - mul(b, t2)
    X3 = 3 * X3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = mul(b, Y3) - 3 * t2 - t0
    Y3 = 3 * Y3
    t0 = 3 * t0 - 3 * t2
    t1 = mul(t4, Y3)
    t2 = mul(t0, Y3)
    Y3 = mul(X3, Z3) + t2
    X3 = mul(t3, X3) - t1
    Z3 = mul(t4, Z3) + mul(t3, t0)
    return X3, Y3, Z3


_G_COMPLETE = {}  # device -> (16, 3, 12) int64 limbs, [k]G projective


def _g_table_complete(device) -> torch.Tensor:
    """[k]G for k = 0..15 as Montgomery (X, Y, Z), entry 0 the identity
    (0 : 1 : 0), so a zero digit adds the identity."""
    key = str(device)
    if key not in _G_COMPLETE:
        one = fp.int_to_limbs(FP.r_mod_m)
        rows = [[fp.int_to_limbs(0), one, fp.int_to_limbs(0)]]
        rows += [[fp.int_to_limbs(FP.to_mont(c)) for c in pt] + [one]
                 for pt in _g_multiples(table(DEFAULT_WINDOW))]
        _G_COMPLETE[key] = torch.tensor(rows, dtype=torch.int64,
                                        device=device)
    return _G_COMPLETE[key]


def verify_complete_plain(packed: torch.Tensor) -> torch.Tensor:
    """The complete-formula kernel's function in plain PyTorch: (42, N)
    int32 packed inputs -> (N,) int32 verdicts (bit 1 is always 0).

    The shared scalar prep, then the RCB16 ladder of the JAX package's
    ``_verify_device``: a 16-entry projective Q table (identity, Q, then
    14 complete adds), 64 rounds of 4 doublings + a G add + a Q add, and
    accept <=> X == r Z or (r + n < p and X == (r + n) Z), Z != 0."""
    dev = packed.device
    n = packed.shape[1]
    d1, d2, qx_m, qy_m, r_m, rn_m, valid, rn_ok = _prep_plain(packed)
    b = FP.const(FP.to_mont(CURVE_B), dev)
    one = FP.const(FP.r_mod_m, dev).expand(-1, n)
    zero = torch.zeros_like(one)
    identity = (zero, one, zero)
    Q = (qx_m, qy_m, one)

    qtab = [identity, Q]
    while len(qtab) < table(DEFAULT_WINDOW) + 1:
        qtab.append(_point_add_rcb16(qtab[-1], Q, b))
    qtab = torch.stack([torch.stack(e) for e in qtab])   # (16, 3, 12, N)
    gtab = _g_table_complete(dev)                         # (16, 3, 12)
    lanes = torch.arange(n, device=dev)

    acc = identity
    for k in range(rounds(DEFAULT_WINDOW)):
        for _ in range(DEFAULT_WINDOW):
            acc = _point_dbl_rcb16(acc, b)
        g = gtab[d1[k]].permute(1, 2, 0)                  # (3, 12, N)
        acc = _point_add_rcb16(acc, (g[0], g[1], g[2]), b)
        q = qtab[d2[k], :, :, lanes].permute(1, 2, 0)
        acc = _point_add_rcb16(acc, (q[0], q[1], q[2]), b)

    X, _Y, Z = acc
    ok = fp.eq(X, fp.mul(r_m, Z, FP), FP) | (
        rn_ok & fp.eq(X, fp.mul(rn_m, Z, FP), FP))
    return (ok & ~fp.is_zero(Z, FP) & valid).to(torch.int32)


# --- the kernels ---------------------------------------------------------

# Layout of the kernels' __constant__ table, in 32-bit words; mirrored by
# the C_* offsets in csrc/p256_common.cuh.
_C_WORDS = 72 + 16 * G_ENTRIES + 2


def _words_le(x: int) -> list:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def _g_words(count: int) -> list:
    """Affine [k]G, k = 1..count, as the kernels read it: x R and y R mod
    p (R = 2^256), 8 little-endian 32-bit words each."""
    R = 1 << 256
    words = []
    for gx, gy in _g_multiples(count):
        words += _words_le(gx * R % CURVE_P) + _words_le(gy * R % CURVE_P)
    return words


def kernel_constants() -> np.ndarray:
    """The kernels' constant table (R = 2^256 Montgomery, 8 x 32-bit
    limbs): p, n, R^2 mod p, R^2 mod n, R mod p, R mod n, b*R mod p,
    n*R mod p, n - 2, the affine [k]G table (k = 1..31: the ladders at
    w = 2, 3 and 4 read its first 3, 7 and 15 entries), -p^-1 and -n^-1
    mod 2^32."""
    R = 1 << 256
    words = []
    for x in (CURVE_P, CURVE_N, R * R % CURVE_P, R * R % CURVE_N,
              R % CURVE_P, R % CURVE_N, CURVE_B * R % CURVE_P,
              CURVE_N * R % CURVE_P, CURVE_N - 2):
        words += _words_le(x)
    words += _g_words(G_ENTRIES)
    words += [(-pow(CURVE_P, -1, 1 << 32)) % (1 << 32),
              (-pow(CURVE_N, -1, 1 << 32)) % (1 << 32)]
    assert len(words) == _C_WORDS
    return np.array(words, dtype=np.uint32)


_LIBS = {}  # (kernel name, cuda device index) -> armed ctypes library
# each source's kernels, by the prefix of their launch and attribute
# entry points; p256_verify_wide's launch takes more arguments
_ENTRIES = {"p256_verify": ("p256_verify", "p256_verify_w2",
                            "p256_verify_w3", "p256_verify_w5"),
            "p256_verify_wide": (),
            "p256_complete": ("p256_complete",)}


def _kernel_lib(name: str, device: torch.device):
    """Build (at first use), load and arm ``csrc/<name>.cu`` for one
    card: every verify library holds its own copy of the constant
    table."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    lib = _LIBS.get((name, index))
    if lib is None:
        from .. import _build

        lib = _build.load(name)
        lib.p256_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.p256_set_constants.restype = ctypes.c_int
        for entry in _ENTRIES[name]:
            launch = getattr(lib, f"{entry}_launch")
            launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p]
            launch.restype = ctypes.c_int
        if name == "p256_verify_wide":
            lib.p256_verify_wide_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
            lib.p256_verify_wide_launch.restype = ctypes.c_int
        consts = kernel_constants()
        with torch.cuda.device(index):
            rc = lib.p256_set_constants(consts.ctypes.data, consts.size)
        if rc != 0:
            raise RuntimeError(f"p256_set_constants failed: CUDA error {rc}")
        _LIBS[(name, index)] = lib
    return lib


def _run(name: str, packed: torch.Tensor, plain, launch) -> torch.Tensor:
    """Check the packed input; run ``plain`` for a CPU tensor, else
    ``launch(lib, packed, out, n, stream)`` with ``csrc/<name>.cu``'s
    library on the current stream (no fallback)."""
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] != PACKED_ROWS:
        raise ValueError(f"expected (42, N) int32, got {tuple(packed.shape)}"
                         f" {packed.dtype}")
    if packed.device.type == "cpu":
        return plain(packed)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    packed = packed.contiguous()
    n = packed.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    lib = _kernel_lib(name, packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(lib, packed, out, n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _launch_entry(entry: str):
    """The launch of a kernel that takes (packed, out, n, stream)."""
    def launch(lib, packed, out, n, stream):
        return getattr(lib, f"{entry}_launch")(packed.data_ptr(),
                                               out.data_ptr(), n, stream)
    return launch


def _verify_entry(w: int) -> Tuple[str, str]:
    """The Jacobian kernel at window ``w``: its library and entry point."""
    if w not in WINDOWS:
        raise ValueError(f"the Jacobian ladder's window must be one of "
                         f"{WINDOWS}, not {w!r}")
    if w not in SHARED_WINDOWS:
        return "p256_verify_wide", "p256_verify_wide"
    return "p256_verify", "p256_verify" if w == 4 else f"p256_verify_w{w}"


# --- the wide windows (p256_verify_wide.cu) ---------------------------------

_G_DEVICE = {}    # (cuda device index, w) -> the window's [k]G, int32 words
_RESIDENT = {}    # cuda device index -> (SMs, the wide kernel's resident
                  # blocks, groups of four a block)


def _g_table_device(device: torch.device, w: int) -> torch.Tensor:
    """The affine [k]G table of window ``w`` on one card, k = 1 ..
    2^w - 1, each entry x R and y R mod p (R = 2^256) as 8 little-endian
    32-bit words: built once a card and window."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    t = _G_DEVICE.get((index, w))
    if t is None:
        words = np.array(_g_words(table(w)), dtype=np.uint32)
        t = torch.from_numpy(words.view(np.int32)).to(
            torch.device("cuda", index))
        _G_DEVICE[(index, w)] = t
    return t


def _wide_attributes(device: torch.device) -> dict:
    lib = _kernel_lib("p256_verify_wide", device)
    vals = (ctypes.c_int * 6)()
    fn = lib.p256_verify_wide_attributes
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(ctypes.addressof(vals))
    if rc != 0:
        raise RuntimeError(f"p256_verify_wide_attributes: CUDA error {rc}")
    return dict(zip(("group", "threads", "smem_bytes", "registers",
                     "local_bytes", "blocks_per_sm"), vals))


# The wide kernel's cost model, in group steps (PERF.md: fitted to run
# AV's times of every G at 1 to 2,052 lanes and w = 6-13; its pick was
# within 8 % of the fastest G at every shape there and within 10 % in run
# AW): the scalar prep's chain; the prep's slowdown while table groups
# share its warp (G >= 8); and the cost of each further warp a scheduler
# runs at once (a warp's chain is bound by its scheduler's instruction
# rate).
PREP_STEPS = 343
PREP_SHARED = 0.5
WARP_SHARE = 0.5


def wide_cost(n: int, w: int, groups: int, sms: int, resident_blocks: int,
              block_groups: int) -> float:
    """The estimated time, in group steps of one warp alone on its
    scheduler, of a launch of ``n`` lanes at window ``w`` with ``groups``
    groups a signature: the build (the prep beside the table's longest
    segment; at G = 1 one chain) and the ladder, each stretched by the
    warps a scheduler holds in it, times the grid's trips."""
    warps = block_groups // 8      # a block's: its groups lie one a warp
                                   # up to G = warps, consecutive above
    if groups == 1:
        build = PREP_STEPS + 4 * (table(w) - 1)
    else:
        segment = 5 * w + 4 * -(-(table(w) - 1) // (groups - 1))
        prep = PREP_STEPS
        if groups > warps:         # table groups share the prep's warp
            prep += PREP_SHARED * min(PREP_STEPS, segment)
        build = max(prep, segment)
    ladder = rounds(w) * (3 * w + 8) + 1
    sigs = block_groups // groups
    blocks = -(-n // sigs)
    live = min(blocks, resident_blocks)
    # every warp builds; the ladders run on group 0's warps, eight to a
    # warp when a signature's groups lie one a warp
    ladder_warps = sigs // 8 if groups <= warps else sigs
    share = lambda u: 1 + WARP_SHARE * (u - 1)  # noqa: E731
    return -(-blocks // resident_blocks) * (
        build * share(-(-live // sms))
        + ladder * share(-(-live * ladder_warps // (warps * sms))))


def wide_plan(n: int, w: int, sms: int, resident_blocks: int,
              block_groups: int, groups: Optional[int] = None
              ) -> Tuple[int, int, int]:
    """(G, blocks, tables) of a wide-window launch of ``n`` lanes at
    window ``w`` on a card of ``sms`` SMs that holds ``resident_blocks``
    blocks of ``block_groups`` groups of four at once.  G, the groups a
    signature, is the one of :data:`WIDE_GROUPS` of least
    :func:`wide_cost` (the smallest on a tie) unless ``groups`` forces
    it; block_groups / G signatures a block, at most the resident blocks
    (the kernel walks the rest grid-stride); one Q table a signature of
    the grid."""
    if groups is None:
        groups = min(WIDE_GROUPS, key=lambda g: wide_cost(
            n, w, g, sms, resident_blocks, block_groups))
    elif groups not in WIDE_GROUPS:
        raise ValueError(f"groups a signature must be one of {WIDE_GROUPS},"
                         f" not {groups!r}")
    sigs = block_groups // groups
    blocks = min(-(-n // sigs), resident_blocks)
    return groups, blocks, blocks * sigs


def _wide_plan(device: torch.device, n: int, w: int,
               groups: Optional[int] = None) -> Tuple[int, int, int]:
    """:func:`wide_plan` on one card, its SMs and resident blocks read
    once from the kernel's attributes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    got = _RESIDENT.get(index)
    if got is None:
        a = _wide_attributes(torch.device("cuda", index))
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        got = _RESIDENT[index] = (sms, a["blocks_per_sm"] * sms,
                                  a["threads"] // a["group"])
    return wide_plan(n, w, *got, groups=groups)


def scratch_bytes(device: torch.device, n: int, w: int) -> int:
    """Device memory a launch of ``n`` lanes at window ``w`` allocates
    for its Q tables: one table a resident signature (0 where the tables
    live in shared memory)."""
    if w in SHARED_WINDOWS:
        return 0
    return _wide_plan(device, n, w)[2] * table(w) * Q_ENTRY_BYTES


def _launch_wide(w: int, groups: Optional[int] = None):
    """The wide kernel's launch at window ``w`` with G groups a
    signature (the plan's choice unless ``groups`` forces it): the grid,
    the Q-table scratch (from the caching allocator, on the launch's
    stream) and the window's G table."""
    def launch(lib, packed, out, n, stream):
        g, blocks, tables = _wide_plan(packed.device, n, w, groups)
        scratch = torch.empty(tables * table(w) * Q_ENTRY_BYTES // 4,
                              dtype=torch.int32, device=packed.device)
        gtab = _g_table_device(packed.device, w)
        return lib.p256_verify_wide_launch(
            packed.data_ptr(), out.data_ptr(), n, w, g, gtab.data_ptr(),
            scratch.data_ptr(), blocks, stream)
    return launch


def kernel_attributes(name: str, device: torch.device,
                      window: int = DEFAULT_WINDOW, lanes: int = 8192
                      ) -> dict:
    """Kernel ``name``'s (``p256_verify``, at ``window``, or
    ``p256_complete``) launch shape and resources on a card
    (``cudaFuncGetAttributes``): threads a signature and a block, shared
    memory bytes a block, registers and local-memory bytes a thread; for
    the Jacobian kernel also the device memory a launch of ``lanes``
    allocates for its Q tables (``scratch_bytes``) and, at the wide
    windows, the blocks an SM holds and the G table's bytes."""
    lib_name, entry = _verify_entry(window) if name == "p256_verify" \
        else (name, name)
    if lib_name == "p256_verify_wide":
        out = _wide_attributes(device)
        out["g_table_bytes"] = table(window) * G_ENTRY_BYTES
    else:
        lib = _kernel_lib(lib_name, device)
        vals = (ctypes.c_int * 5)()
        fn = getattr(lib, f"{entry}_attributes")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            rc = fn(ctypes.addressof(vals))
        if rc != 0:
            raise RuntimeError(f"{entry}_attributes: CUDA error {rc}")
        out = dict(zip(("group", "threads", "smem_bytes", "registers",
                        "local_bytes"), vals))
    if name == "p256_verify":
        out["scratch_bytes"] = scratch_bytes(device, lanes, window)
    return out


def verify_packed(packed: torch.Tensor, window: Optional[int] = None
                  ) -> torch.Tensor:
    """(42, N) int32 packed inputs -> (N,) int32 (bit 0 verdict, bit 1
    exception).  A CUDA tensor launches the Jacobian kernel at ``window``
    (:data:`VERIFY_WINDOW` when None): csrc/p256_verify.cu's
    ``p256_verify_kernel`` at 4, its B7 ``p256_verify_w5_kernel`` at 5 and
    ``p256_verify_w2_kernel`` / ``_w3_kernel`` at 2 and 3;
    csrc/p256_verify_wide.cu at 6-13.  A CPU tensor runs
    :func:`verify_plain` at that window."""
    return _verify(packed, VERIFY_WINDOW if window is None else window)


def _verify(packed: torch.Tensor, w: int, groups: Optional[int] = None
            ) -> torch.Tensor:
    """:func:`verify_packed` at window ``w``; ``groups`` forces the wide
    kernel's groups a signature (:func:`wide_plan`), for the tests and
    ``chip_smoke.py``.  The verdicts do not depend on it."""
    global LAUNCHES
    lib, entry = _verify_entry(w)
    if groups is not None and lib != "p256_verify_wide":
        raise ValueError(f"w = {w} has no groups a signature to force")
    launch = _launch_wide(w, groups) if lib == "p256_verify_wide" \
        else _launch_entry(entry)
    out = _run(lib, packed, functools.partial(verify_plain, w=w), launch)
    if packed.device.type == "cuda" and out.numel():
        with _COUNT_LOCK:
            LAUNCHES += 1
            LAUNCHES_BY_WINDOW[w] += 1
        trace.inc(f"kernel.p256_verify.w{w}.launches")  # a node's /metrics
    return out


def verify_complete_packed(packed: torch.Tensor) -> torch.Tensor:
    """(42, N) int32 packed inputs -> (N,) int32 verdicts (bit 1 always
    0).  A CUDA tensor launches the complete-formula kernel
    (csrc/p256_complete.cu); a CPU tensor runs
    :func:`verify_complete_plain`."""
    global COMPLETE_LAUNCHES
    out = _run("p256_complete", packed, verify_complete_plain,
               _launch_entry("p256_complete"))
    if packed.device.type == "cuda" and out.numel():
        with _COUNT_LOCK:
            COMPLETE_LAUNCHES += 1
    return out


# Field products by kind, counted from the kernels' code: mod-p multiplies
# and squarings, mod-n multiplies and squarings, and mod-n Montgomery
# reductions alone (a product with 1, out of Montgomery form).
DBL = {"p_mul": 3, "p_sqr": 5}    # dbl-2001-b
MADD = {"p_mul": 7, "p_sqr": 4}   # madd-2007-bl
ADD = {"p_mul": 11, "p_sqr": 5}   # add-2007-bl
DBL_RCB16 = {"p_mul": 8, "p_sqr": 6}  # RCB16 doubling, 2 products by b
ADD_RCB16 = {"p_mul": 14}             # RCB16 Algorithm 4, 2 products by b



def _ladder(kernel: str, w: int) -> tuple:
    """A kernel's Q-table build at window ``w``, the round's doubling, G
    add and Q add, and the final test against r (the test against r + n
    costs one more multiply): X == r*Z^2 (jac) or X == r*Z (complete,
    w = 4 only)."""
    if kernel == "jac":
        return ([(DBL, 1), (MADD, table(w) - 2)], DBL, MADD, ADD,
                {"p_mul": 1, "p_sqr": 1})
    if kernel != "complete" or w != DEFAULT_WINDOW:
        raise ValueError(f"no {kernel!r} ladder at w = {w}")
    return ([(ADD_RCB16, table(w) - 1)], DBL_RCB16, ADD_RCB16, ADD_RCB16,
            {"p_mul": 1})

# The least 32-bit multiply operations each kind needs.  A wide 32x32->64
# product is 2 (low and high halves), a low-half one 1.  A multiply of two
# 8-limb values needs 64 wide products, a squaring 36.  p is a Solinas
# prime (-p^-1 mod 2^32 = 1, limbs 0, 1 or 2^32 - 1), so reducing mod p
# needs no multiplies; reducing mod n needs 8 low-half and 64 wide ones.
MUL_OPS = {"p_mul": 64 * 2, "p_sqr": 36 * 2, "n_mul": 64 * 2 + 8 + 64 * 2,
           "n_sqr": 36 * 2 + 8 + 64 * 2, "n_red": 8 + 64 * 2}


def _add(total: dict, kind: dict, times: int = 1) -> None:
    for k, v in kind.items():
        total[k] = total.get(k, 0) + v * times


def mults_per_lane(kernel: str = "jac", w: int = DEFAULT_WINDOW) -> dict:
    """Field products a kernel does per lane at window ``w``, by kind:
    s*R^2, 14 table and 64 x (4 squarings + 1 multiply) window products
    of s^-1 (INV_WINDOW, whatever w), z and r into Montgomery form, times
    s^-1 and out of it; the forms of qx, qy and r and the on-curve check;
    the Q table (jac: dbl + 2^w - 3 madd; complete: 14 adds); rounds(w)
    rounds of w doublings + G add + Q add; and the final test against r
    and r + n."""
    qtable, dbl, g_add, q_add, final = _ladder(kernel, w)
    inv_rounds = rounds(INV_WINDOW)
    total = {"n_mul": 1 + (table(INV_WINDOW) - 1) + inv_rounds + 2 * 2,
             "n_sqr": inv_rounds * INV_WINDOW, "n_red": 2,
             "p_mul": 3 + 1 + 1, "p_sqr": 2}
    for kind, times in qtable:
        _add(total, kind, times)
    _add(total, dbl, rounds(w) * w)
    _add(total, g_add, rounds(w))
    _add(total, q_add, rounds(w))
    _add(total, final)
    return total


def mul_ops_needed(zs, rs, ss, qxs, qys, kernel: str = "jac",
                   w: int = DEFAULT_WINDOW) -> int:
    """The least 32-bit multiply operations these lanes need with the
    formulas of ``kernel`` at window ``w``, counted from their data: a
    lane that fails the range checks needs none and an off-curve lane only its on-curve
    check; the window over n - 2 squares nothing before its first digit
    and multiplies for no zero digit; the ladder doubles nothing before
    its first nonzero digit, and adds for no zero digit (a complete add
    of the identity changes nothing)."""
    qtable, dbl, g_add, q_add, final = _ladder(kernel, w)
    nm2 = _nm2_digits()
    fermat_mul = sum(1 for d in nm2[1:] if d)
    total: dict = {}
    for z, r, s, qx, qy in zip(zs, rs, ss, qxs, qys):
        if not (0 < r < CURVE_N and 0 < s < CURVE_N) or (qx == 0 and qy == 0):
            continue
        _add(total, {"p_mul": 3, "p_sqr": 2})  # qx, qy forms; y^2, x^2, x^3
        if not is_on_curve((qx % CURVE_P, qy % CURVE_P)):
            continue
        _add(total, {"n_mul": 1 + (table(INV_WINDOW) - 1) + fermat_mul + 2 * 2,
                     "n_sqr": INV_WINDOW * (len(nm2) - 1), "n_red": 2})
        for kind, times in qtable:
            _add(total, kind, times)
        s_inv = pow(s, -1, CURVE_N)
        u1, u2 = z * s_inv % CURVE_N, r * s_inv % CURVE_N
        started = False
        for k in range(rounds(w)):
            if started:
                _add(total, dbl, w)
            shift = w * (rounds(w) - 1 - k)
            for u, kind in ((u1, g_add), (u2, q_add)):
                if (u >> shift) & table(w):
                    if started:
                        _add(total, kind)
                    started = True
        # the r form, the test against r and, when r + n < p, against r + n
        _add(total, {"p_mul": 1 + (r + CURVE_N < CURVE_P)})
        _add(total, final)
    return sum(MUL_OPS[k] * v for k, v in total.items())


def bytes_needed(zs, rs, ss, qxs, qys, w: int = DEFAULT_WINDOW) -> int:
    """The bytes a launch of these lanes moves through device memory at
    window ``w``: the packed input read once and the verdicts written
    once; at the wide windows (their Q tables in device memory) also
    each lane's table, written once (2^w - 1 entries of 160 B) and read
    an entry a nonzero Q digit, and the window's G table
    read once.  As :func:`mul_ops_needed`, counted from the data: a lane
    that fails the range or on-curve checks builds no table."""
    total = len(zs) * (PACKED_ROWS * 4 + 4)
    if w in SHARED_WINDOWS:
        return total
    tables = 0
    for r, s, qx, qy in zip(rs, ss, qxs, qys):
        if not (0 < r < CURVE_N and 0 < s < CURVE_N) or (qx == 0 and qy == 0) \
                or not is_on_curve((qx % CURVE_P, qy % CURVE_P)):
            continue
        u2 = r * pow(s, -1, CURVE_N) % CURVE_N
        reads = sum(1 for k in range(rounds(w)) if (u2 >> (w * k)) & table(w))
        tables += 1
        total += (table(w) + reads) * Q_ENTRY_BYTES
    if tables:
        total += table(w) * G_ENTRY_BYTES
    return total


def work_counts(zs, rs, ss, qxs, qys, kernel: str = "jac",
                w: int = DEFAULT_WINDOW) -> dict:
    """:func:`mul_ops_needed` and :func:`bytes_needed` of these lanes,
    the figures a launch's bound divides (``profiling.analyze_cost``)."""
    return {"mul_ops_needed": mul_ops_needed(zs, rs, ss, qxs, qys, kernel, w),
            "bytes_needed": bytes_needed(zs, rs, ss, qxs, qys, w)}


# --- entry point ---------------------------------------------------------

def verify_batch_prehashed(
    digests: Sequence[bytes],
    signatures: Sequence[Tuple[int, int]],
    pubkeys: Sequence[Tuple[int, int]],
    device: DeviceLike = None,
    mesh: Optional[Sequence[torch.device]] = None,
) -> np.ndarray:
    """Batch-verify ECDSA signatures over already-hashed messages.
    Returns (N,) bool.  Semantics match ``fastecdsa.ecdsa.verify`` as the
    reference uses it: big-endian digest integer, range-checked r and s,
    coordinates reduced mod p, on-curve pubkeys.

    The ladder is :data:`VERIFY_KERNEL`'s, the Jacobian one at
    :data:`VERIFY_WINDOW`.  Runs on the card unless ``device="cpu"``;
    raises when no card is there and none was declined.  ``mesh`` (a
    ``parallel.mesh.make_mesh`` tuple) splits the lanes into one
    contiguous shard a device (``parallel.mesh.verify_packed_sharded``,
    the JAX package's ``_prep_and_verify_pallas_jac_sharded``); then the
    mesh's devices run it and ``device`` is not read.  Only the Jacobian
    ladder is sharded, as in the JAX package."""
    global EXCEPTION_LANES
    if VERIFY_KERNEL not in VERIFY_KERNELS:
        raise ValueError(f"VERIFY_KERNEL must be one of {VERIFY_KERNELS}, "
                         f"not {VERIFY_KERNEL!r}")
    if mesh is not None and VERIFY_KERNEL != "jac":
        raise ValueError("a mesh is wired for the Jacobian kernel only")
    dev = resolve(device) if mesh is None else None
    n = len(digests)
    if len(signatures) != n or len(pubkeys) != n:
        raise ValueError(f"{n} digests, {len(signatures)} signatures, "
                         f"{len(pubkeys)} pubkeys")
    if n == 0:
        return np.zeros(0, dtype=bool)
    fused, zs, rs, ss, qxs, qys = _pack_device_inputs(
        digests, signatures, pubkeys, n)
    if mesh is not None:
        from ..parallel.mesh import verify_packed_sharded

        res = verify_packed_sharded(packed_tensor(fused, "cpu"), mesh)
    elif VERIFY_KERNEL == "complete":
        res = verify_complete_packed(packed_tensor(fused, dev))
    else:
        res = verify_packed(packed_tensor(fused, dev))
    res = res.cpu().numpy()
    w = VERIFY_WINDOW if VERIFY_KERNEL == "jac" else DEFAULT_WINDOW
    on_card = mesh is not None or dev.type == "cuda"
    # a build's first launch of (kernel, window) is the compile miss
    _ktel.record_batch("p256_verify", real=n, padded=n,
                       compile_key=(VERIFY_KERNEL, w) if on_card else None)
    if profiling.COST_ANALYSIS:
        profiling.analyze_cost("p256_verify", work_counts, zs, rs, ss, qxs,
                               qys, VERIFY_KERNEL, w)
    out = (res & 1) != 0
    exc = np.nonzero(res & 2)[0]
    if len(exc):
        with _COUNT_LOCK:
            EXCEPTION_LANES += len(exc)
        for i in exc:
            out[i] = _host_verify_prehashed(zs[i], rs[i], ss[i],
                                            qxs[i], qys[i])
    return out
