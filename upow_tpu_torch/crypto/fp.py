"""Batched 256-bit prime-field arithmetic in plain PyTorch (int64 limbs).

This is the arithmetic of the PLAIN versions of the P-256 verify kernels
(:mod:`.p256`, Jacobian and complete-formula): the CPU tests run it, and
the card's kernels are held against it.  The card never runs it on the
main path.

Layout: an element is an int64 tensor of shape (12, N), twelve 24-bit
limbs per lane (lanes on the last axis), value = sum(limb[k] << 24k).
Montgomery form uses R = 2^288, far enough above p (and n) that the
lazy bounds below are self-stable.

* **Signed, lazy limbs.**  Addition and subtraction are plain limb-wise
  ``+``/``-`` with no carry handling; values may go negative and limbs
  may grow.  Every product first sweeps its inputs once (one carry hop),
  so a product's inputs always have |limb| <= 2^24 + 2^8 whatever
  add/sub chain made them, as long as that chain stays within 2^9 * p
  in value (the point formulas stay within 20 * p).
* **Products** are one outer product over (limbs, limbs, lanes), summed
  along the anti-diagonals by a skew reshape, then 12 word-by-word
  Montgomery rounds.  Bounds in int64: 12 products < 2^52 each, plus
  12 * 2^48 from the reduction, plus carries < 2^33 -> every row stays
  below 2^56.  The output value lies in (-2^244, p + 2^244) for inputs
  below 2^266 in magnitude.
* **Exact tests** (``is_zero``, ``canonical``) reduce once more by
  Montgomery (which lands the value in [0, m]) and then ripple the
  carries through all limbs.

torch on the CPU has no shifts or adds for uint32 and ``>>`` on a signed
type is arithmetic, so everything here is int64 with explicit masks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

LIMB_BITS = 24
NUM_LIMBS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # Montgomery R = 2^288


def int_to_limbs(x: int) -> list:
    """Non-negative host int (< 2^288) -> 12 Python-int limbs."""
    assert 0 <= x < (1 << R_BITS), "value out of range"
    return [(x >> (LIMB_BITS * k)) & LIMB_MASK for k in range(NUM_LIMBS)]


def ints_to_limbs(xs: Sequence[int], device=None) -> torch.Tensor:
    """Host ints (each in [0, 2^288)) -> (12, N) int64 tensor."""
    rows = np.array([int_to_limbs(x) for x in xs], dtype=np.int64)
    rows = rows.reshape(len(xs), NUM_LIMBS)
    return torch.from_numpy(np.ascontiguousarray(rows.T)).to(device)


@dataclass
class Field:
    """Host constants of one prime field, plus per-device limb tensors."""

    m: int
    pinv: int = 0        # -m^-1 mod 2^24
    r_mod_m: int = 0     # R mod m: Montgomery form of 1
    r2_mod_m: int = 0    # R^2 mod m: converts into Montgomery form
    _cache: Dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.pinv = (-pow(self.m, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r_mod_m = (1 << R_BITS) % self.m
        self.r2_mod_m = pow(1 << R_BITS, 2, self.m)

    def const(self, x: int, device) -> torch.Tensor:
        """(12, 1) int64 limbs of the host int ``x``, cached per device."""
        key = (x, str(device))
        t = self._cache.get(key)
        if t is None:
            t = ints_to_limbs([x], device)
            self._cache[key] = t
        return t

    def to_mont(self, x: int) -> int:
        return x * (1 << R_BITS) % self.m


def sweep(a: torch.Tensor) -> torch.Tensor:
    """One carry hop: every limb but the top keeps its low 24 bits and
    hands the (signed) rest to the limb above.  The value is unchanged;
    the top limb keeps the sign and whatever lies above 2^264."""
    lo = torch.cat([a[:-1] & LIMB_MASK, a[-1:]])
    lo[1:] += a[:-1] >> LIMB_BITS
    return lo


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(12, N) x (12, N) -> (24, N) schoolbook product rows.

    Row i of the outer product is a_i * b; padding b to 25 rows and
    reading the (12, 25) block back as (12, 24) shifts row i right by i,
    so summing over i adds each a_i * b_j into row i + j."""
    L = a.shape[0]
    n = a.shape[1]
    b_pad = torch.cat([b, b.new_zeros(L + 1, n)])        # (2L+1, N)
    outer = a[:, None, :] * b_pad[None, :, :]             # (L, 2L+1, N)
    skew = outer.reshape(L * (2 * L + 1), n)[: L * 2 * L]
    return skew.reshape(L, 2 * L, n).sum(0)               # (2L, N)


def _reduce(t: torch.Tensor, f: Field) -> torch.Tensor:
    """(24, N) rows -> t * R^-1 mod m as a (12, N) element (not canonical).

    Word-by-word Montgomery: round i picks the multiple of m that clears
    row i (mod 2^24) and moves row i's exact carry into row i + 1."""
    L = NUM_LIMBS
    m_col = f.const(f.m, t.device)                         # (12, 1)
    for i in range(L):
        q = t[i] & LIMB_MASK
        if f.pinv != 1:  # p is -1 mod 2^96: its pinv is 1
            q = (q * f.pinv) & LIMB_MASK
        t[i:i + L] += q * m_col
        t[i + 1] += t[i] >> LIMB_BITS
    return sweep(sweep(t[L:]))


def mul(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    """Montgomery product a * b * R^-1 (mod m); a (12, 1) constant
    broadcasts over the lanes."""
    a, b = torch.broadcast_tensors(a, b)
    return _reduce(_product(sweep(a), sweep(b)), f)


def sqr(a: torch.Tensor, f: Field) -> torch.Tensor:
    return mul(a, a, f)


def mul_many(pairs, f: Field) -> tuple:
    """The Montgomery products of several independent (a, b) pairs in
    one :func:`mul`, their lanes side by side: the same values as one
    call a pair, in fewer and wider torch operations."""
    pairs = [torch.broadcast_tensors(a, b) for a, b in pairs]
    out = mul(torch.cat([a for a, _ in pairs], 1),
              torch.cat([b for _, b in pairs], 1), f)
    return out.split([a.shape[1] for a, _ in pairs], 1)


def _ripple(a: torch.Tensor) -> torch.Tensor:
    """Full carry propagation: limbs 0..10 in [0, 2^24), top signed."""
    a = a.clone()
    for k in range(NUM_LIMBS - 1):
        a[k + 1] += a[k] >> LIMB_BITS
        a[k] &= LIMB_MASK
    return a


def _from_mont_exact(a: torch.Tensor, f: Field) -> torch.Tensor:
    """a * R^-1 mod m as exact limbs of a value in [0, m] (m itself is
    possible, and means zero)."""
    t = torch.cat([sweep(a), a.new_zeros(a.shape)])
    return _ripple(_reduce(t, f))


def is_zero(a: torch.Tensor, f: Field) -> torch.Tensor:
    """(N,) bool: a == 0 (mod m)."""
    w = _from_mont_exact(a, f)
    return (w == 0).all(0) | (w == f.const(f.m, a.device)).all(0)


def eq(a: torch.Tensor, b: torch.Tensor, f: Field) -> torch.Tensor:
    return is_zero(a - b, f)


def canonical_from_mont(a: torch.Tensor, f: Field) -> torch.Tensor:
    """Montgomery element -> the canonical plain value in [0, m), as
    exact 24-bit limbs."""
    w = _from_mont_exact(a, f)
    at_m = (w == f.const(f.m, a.device)).all(0)
    return torch.where(at_m[None, :], torch.zeros_like(w), w)
