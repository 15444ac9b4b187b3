"""The wide-window Jacobian kernel (``csrc/p256_verify_wide.cu``, w = 6-13)
with each signature's Q table built by G cooperating groups of four,
against the plain version (``crypto/p256.py::verify_plain``, held against
the JAX package's ``_ladder_kernel_jac`` by ``test_torch_p256_windows.py``,
``test_torch_p256_wide.py`` and ``test_torch_p256_widest.py``).

* The CUDA source, compiled by the host's g++ under
  ``test_torch_p256.py``'s group shim (each block's 128 threads as
  std::threads, __syncthreads a barrier of the block that hands each
  group on in turns), bit for bit at w = 6 and 8 for G = 1, 2, 4, 8, 16
  and 32 on 40 lanes: the mix (honest, corrupted, crafted collisions,
  off-curve, (0, 0), hostile ints) with a qy = 0 key and a key of order
  3 on another curve.  One block walks all 40, so every slot takes
  several signatures, and at G >= 2 the last trip's slots past the 40th
  lane idle through the block's syncs.
* Why a lane that is not valid builds its table as one chain: on the
  order-3 key a segmented build (the plain formulas in the kernel's
  segment order) flips the exception bit where the serial chain's, and
  the JAX package's, is set.
* w = 13 at G = 32 on 3 lanes (an honest signature, a crafted collision,
  the (0, 0) key).
* The wrapper's choice of G, the grid and the scratch (``wide_plan``,
  ``scratch_bytes`` with the resident blocks stubbed): pure Python.
* On a card, each forced G against the plain version.

No tolerance: every compared value is a bit or an integer.
"""

import random

import numpy as np
import pytest
import torch

from upow_tpu_torch.core.codecs import is_on_curve
from upow_tpu_torch.core.constants import CURVE_B, CURVE_GX, CURVE_P
from upow_tpu_torch.crypto import fp, p256
from test_torch_p256 import _mix, _mix_lanes
from test_torch_p256_windows import build_wide_kernel, run_wide_kernel

GROUPS = [1, 2, 4, 8, 16, 32]
LANES = 40


def order3_key(seed: int = 1) -> tuple:
    """A point of order 3 on y^2 = x^3 - 3x + b' for some b' != b: x a
    root of the 3-division polynomial 3x^4 - 18x^2 + 12 b' x - 9, so
    off P-256 (valid = 0), and a segmented build's entries differ from
    the chain's (the chain meets the identity at [3]Q)."""
    rng = random.Random(seed)
    while True:
        x = rng.randrange(2, CURVE_P)
        b2 = (9 + 18 * x * x - 3 * x ** 4) * pow(12 * x, -1, CURVE_P) % CURVE_P
        rhs = (x ** 3 - 3 * x + b2) % CURVE_P
        y = pow(rhs, (CURVE_P + 1) // 4, CURVE_P)
        if y and y * y % CURVE_P == rhs and b2 != CURVE_B:
            return x, y


def order3_lane(w: int, digit: int) -> tuple:
    """s = 1 (u1 = z, u2 = r): G starts the ladder, then the Q digit
    ``digit`` twice; with the order-3 key the chain's [digit]Q has Z = 0
    (so the second add flags the lane) where a segment starting at a
    power of two ``digit`` holds a finite point."""
    top = w * (p256.rounds(w) - 1)
    z = (1 << 250) | 12345
    r = (digit << (top - 2 * w)) | (digit << (top - 5 * w))
    return z.to_bytes(32, "big"), (r, 1), order3_key()


# the order-3 lane's digit at each window: a segment start of G = 32's
# split (2 + j ceil((2^w - 2) / 31)) that is a power of two
ORDER3_DIGIT = {6: 4, 8: 128}


def coop_lanes(w: int) -> tuple:
    """40 lanes of the mix with lane 38 the order-3 key's crafted lane and
    lane 39 a qy = 0 key; lanes 6-9 and 28-31 are crafted collisions."""
    digests, sigs, pubs = _mix_lanes(LANES)
    extra = {38: order3_lane(w, ORDER3_DIGIT[w]),
             39: (digests[39], sigs[39], (CURVE_GX, 0))}
    for i, (d, s, q) in extra.items():
        digests[i], sigs[i], pubs[i] = d, s, q
    assert not any(is_on_curve(extra[i][2]) for i in extra)
    return p256._pack_device_inputs(digests, sigs, pubs, LANES)[0]


@pytest.fixture(scope="module", params=[6, 8])
def window_case(request):
    w = request.param
    fused = coop_lanes(w)
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu"), w).numpy()
    return w, fused, want


@pytest.fixture(scope="module")
def wide_kernel(tmp_path_factory):
    return build_wide_kernel(tmp_path_factory.mktemp("jacwidecoop"))


@pytest.mark.parametrize("groups", GROUPS)
def test_coop_kernel_source_matches_plain_under_host_compiler(
        wide_kernel, window_case, groups):
    """One block of 32 / G signatures walks the 40 lanes grid-stride
    (every slot and table reused), each signature's table built by G - 1
    groups while group 0 runs the prep (the one group does both at G = 1),
    against the plain version, bit for bit: the collisions flagged, the
    off-curve lanes' verdicts 0 and their exception bits the chain's."""
    w, fused, want = window_case
    got = run_wide_kernel(wide_kernel, fused, w, grid=1, groups=groups)
    assert got.tolist() == want.tolist()
    assert {6, 7, 8, 9, 28, 29, 30, 31} <= {i for i in range(LANES)
                                            if got[i] & 2}
    assert not got[38] & 1 and not got[39] & 1 and got[38] & 2


def segmented_qtable(qx_m: torch.Tensor, qy_m: torch.Tensor, w: int,
                     segments: int) -> torch.Tensor:
    """The kernel's segment order in plain formulas: entries 2 .. 2^w - 1
    split into ``segments`` contiguous segments, each segment's first
    entry by double-and-add from Q, then madds."""
    n = qx_m.shape[1]
    one = p256.FP.const(p256.FP.r_mod_m, qx_m.device).expand(-1, n)
    out = qx_m.new_empty((p256.table(w), 3, fp.NUM_LIMBS, n))
    for c, v in enumerate((qx_m, qy_m, one)):
        out[0, c] = v
    size = -(-(p256.table(w) - 1) // segments)
    for lo in range(2, p256.table(w) + 1, size):
        e, k, rem = (qx_m, qy_m, one), 1, lo.bit_length() - 1
        while k < lo:
            if k == lo >> rem:
                rem, e, k = rem - 1, p256._jac_dbl(e), 2 * k
            else:
                e, k = p256._jac_madd(e, qx_m, qy_m)[0], k + 1
        for k in range(lo, min(lo + size, p256.table(w) + 1)):
            if k > lo:
                e = p256._jac_madd(e, qx_m, qy_m)[0]
            for c in range(3):
                out[k - 1, c] = e[c]
    return out


@pytest.mark.parametrize("w", [6, 8])
def test_segmented_build_flips_the_order3_lanes_bit(w):
    """On an honest and a collision lane a segmented table gives the
    chain's bits (the order of the build is free on P-256); on the order-3
    key's crafted lane it clears the exception bit the chain sets, so the
    kernel builds a lane that is not valid as one chain."""
    digests, sigs, pubs = (x[:1] + x[6:7] for x in _mix())
    d, s, q = order3_lane(w, ORDER3_DIGIT[w])
    fused = p256._pack_device_inputs(digests + [d], sigs + [s], pubs + [q],
                                     3)[0]
    prep = p256._prep_plain(p256.packed_tensor(fused, "cpu"), w)
    chain = p256._ladder_plain(prep, p256._qtable_plain(prep[2], prep[3], w),
                               w).tolist()
    seg = p256._ladder_plain(prep, segmented_qtable(prep[2], prep[3], w, 31),
                             w).tolist()
    assert chain == [1, 2, 2] and seg == [1, 2, 0]


def test_coop_kernel_at_13_matches_plain_under_host_compiler(wide_kernel):
    """w = 13 (8,191-entry tables, 31 segments of 265 entries) at G = 32
    on an honest lane, a crafted collision and the (0, 0) key of the mix,
    one block walking the three."""
    pick = [0, 6, 14]
    fused = np.ascontiguousarray(
        p256._pack_device_inputs(*_mix(), 22)[0][:, pick])
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu"), 13).numpy()
    got = run_wide_kernel(wide_kernel, fused, 13, grid=1, groups=32)
    assert got.tolist() == want.tolist()
    assert got[0] == 1 and got[1] & 2 and not got[2] & 1


# run AV's card: 132 SMs, 3 blocks an SM by registers, 32 groups a block
SMS, RESIDENT, BLOCK_GROUPS = 132, 396, 32


@pytest.mark.parametrize("n, w, groups, blocks", [
    (8192, 6, 1, 256), (8192, 13, 1, 256), (20000, 13, 1, 396),
    (2052, 13, 4, 257), (1026, 6, 2, 65), (1026, 8, 4, 129),
    (1026, 10, 4, 129), (1026, 13, 8, 257), (528, 13, 16, 264),
    (264, 13, 32, 264), (33, 13, 32, 33), (1, 6, 2, 1), (1, 13, 32, 1)])
def test_wide_plan_picks_the_cheapest_groups(n, w, groups, blocks):
    """G is the one of least ``wide_cost`` on run AV's card: one group a
    signature when every slot is taken (8,192 lanes and up), more as the
    lanes thin out and the table's share of the chain grows with w (the
    accept's 1,026 lanes: 2 at w = 6, 4 at 8 and 10, 8 at 13; one lane:
    32 at w = 13); the grid is n / (32 / G) blocks up to the resident
    ones, one table a signature of the grid."""
    got = p256.wide_plan(n, w, SMS, RESIDENT, BLOCK_GROUPS)
    assert got == (groups, blocks, blocks * BLOCK_GROUPS // groups)


def test_wide_cost_follows_the_chain():
    """At one lane the cost is the chain (no scheduler shared): the
    one-group 341 + 4 (2^w - 2) + rounds (3w + 8) + 1 steps at G = 1 (the
    prep counted as 343), and at G = 32 the ladder after the prep or the
    longest segment, whichever ends later; more lanes than the resident
    blocks take more trips."""
    for w in (6, 13):
        ladder = p256.rounds(w) * (3 * w + 8) + 1
        assert p256.wide_cost(1, w, 1, SMS, RESIDENT, BLOCK_GROUPS) == \
            343 + 4 * (p256.table(w) - 1) + ladder
        segment = 5 * w + 4 * -(-(p256.table(w) - 1) // 31)
        assert p256.wide_cost(1, w, 32, SMS, RESIDENT, BLOCK_GROUPS) == \
            max(343 + 0.5 * min(343, segment), segment) + ladder
    one = p256.wide_cost(RESIDENT * 32, 13, 1, SMS, RESIDENT, BLOCK_GROUPS)
    assert p256.wide_cost(RESIDENT * 32 + 1, 13, 1, SMS, RESIDENT,
                          BLOCK_GROUPS) == 2 * one


@pytest.mark.parametrize("groups", p256.WIDE_GROUPS)
def test_wide_plan_forced_groups(groups):
    got = p256.wide_plan(1026, 13, SMS, RESIDENT, BLOCK_GROUPS,
                         groups=groups)
    sigs = BLOCK_GROUPS // groups
    blocks = min(-(-1026 // sigs), RESIDENT)
    assert got == (groups, blocks, blocks * sigs)


@pytest.mark.parametrize("groups", [0, 3, 64])
def test_wide_plan_refuses_other_groups(groups):
    with pytest.raises(ValueError, match="groups"):
        p256.wide_plan(1026, 13, SMS, RESIDENT, BLOCK_GROUPS,
                       groups=groups)


def test_scratch_bytes_one_table_a_resident_signature(monkeypatch):
    """``scratch_bytes`` on a stubbed card: at 8,192 lanes the one-group
    layout (8,192 tables), at 1,026 lanes 1,032 at w = 8 (G = 4, 129
    blocks of 8) and 1,028 at w = 13 (G = 8, 257 blocks of 4), at 1 lane
    one table (G = 32) where one group a signature took a block's 32; 0
    at the shared-memory windows."""
    monkeypatch.setitem(p256._RESIDENT, 0, (SMS, RESIDENT, BLOCK_GROUPS))
    dev = torch.device("cuda", 0)
    entry = p256.Q_ENTRY_BYTES
    assert p256.scratch_bytes(dev, 8192, 13) == 8192 * 8191 * entry
    assert p256.scratch_bytes(dev, 1026, 8) == 1032 * 255 * entry
    assert p256.scratch_bytes(dev, 1026, 13) == 1028 * 8191 * entry
    assert p256.scratch_bytes(dev, 1, 13) == 8191 * entry
    assert p256.wide_plan(1, 13, SMS, RESIDENT, BLOCK_GROUPS,
                          groups=1)[2] == 32
    assert p256.scratch_bytes(dev, 1026, 5) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("groups", GROUPS)
def test_coop_kernel_matches_plain_on_card(groups):
    """Each forced G at w = 6 and 8 against the plain version on the card,
    bit for bit (runs on a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in (6, 8):
        packed = p256.packed_tensor(coop_lanes(w), "cuda")
        got = p256._verify(packed, w, groups=groups)
        torch.cuda.synchronize()
        assert torch.equal(got, p256.verify_plain(packed, w))
