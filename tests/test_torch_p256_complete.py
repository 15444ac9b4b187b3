"""The port's complete-formula P-256 verify (``VERIFY_KERNEL = "complete"``:
``csrc/p256_complete.cu`` and its plain version ``verify_complete_plain``)
against the JAX package's complete-formula path on the same inputs.

* ``verify_batch_prehashed(device="cpu")`` under ``"complete"`` runs the
  plain version; the JAX package's ``verify_batch_prehashed(backend=
  "jnp", scalar_prep="host")`` runs ``_verify_device``, the XLA twin of
  its Pallas kernels ``_ladder_kernel_list`` and ``_ladder_kernel``.
  Both are held, lane for lane, against each other, the host oracle
  ``_host_verify_prehashed`` and the port's Jacobian path.
* The mix: honest and corrupted signatures; lanes whose verdict holds
  only through r + n < p; crafted lanes that drive the ladder into its
  collisions (the Jacobian kernel flags those for the host oracle, the
  complete formulas decide them themselves), honest ones among them;
  off-curve keys, (0, 0), oversized digests and coordinates.
* The CUDA source, compiled by the host's g++ with each block's threads
  run as std::threads (the group shim of ``test_torch_p256.py``), against
  the plain version; and the kernel on the card, where there is one.

No tolerance: every compared value is a verdict bit.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from test_torch_p256 import (_crafted, _neg, _signed, build_group_kernel,
                             run_group_kernel)
from upow_tpu.crypto import p256 as jp256
from upow_tpu_torch.core import curve
from upow_tpu_torch.core.codecs import is_on_curve
from upow_tpu_torch.core.constants import CURVE_B, CURVE_GX, CURVE_GY, CURVE_N, CURVE_P
from upow_tpu_torch.crypto import p256


def _rn_lane(rng):
    """An honest lane whose verdict holds only through the r + n test:
    R = (x, y) with n <= x < p, r = x - n, s = 1, and Q solved from
    z G + r Q = R."""
    while True:
        x = rng.randrange(CURVE_N, CURVE_P)
        y2 = (x ** 3 - 3 * x + CURVE_B) % CURVE_P
        y = pow(y2, (CURVE_P + 1) // 4, CURVE_P)
        if y * y % CURVE_P == y2:
            break
    z = rng.randrange(1, CURVE_N)
    r = x - CURVE_N
    minus_zg = _neg(curve.point_mul(z, curve.G))
    Q = curve.point_mul(pow(r, -1, CURVE_N),
                        curve.point_add((x, y), minus_zg))
    return _crafted(z, r, Q)


def _collision_lane(rng, sign):
    """An honest lane whose first ladder round collides: Q = sign * G,
    s = 1 (u1 = z, u2 = r) and z's top digit equal to r's, so the G pick
    and the Q pick meet as P1 == P2 (sign 1) or P1 == -P2 (sign -1)."""
    Q = curve.G if sign > 0 else _neg(curve.G)
    while True:
        k = rng.randrange(1, CURVE_N)
        r = curve.point_mul(k, curve.G)[0] % CURVE_N
        z = (k - sign * r) % CURVE_N
        if r and z >> 252 == r >> 252 and r >> 252:
            return _crafted(z, r, Q)


def _mix():
    """(digests, sigs, pubs): 48 lanes over every path of both ladders."""
    rng = random.Random(0xC0DE)
    G = curve.G
    lanes = [_signed(i, 7100 + i, corrupt=(i % 4 == 3)) for i in range(16)]
    lanes += [_rn_lane(rng) for _ in range(3)]
    lanes += [_collision_lane(rng, 1), _collision_lane(rng, -1),
              _collision_lane(rng, 1)]
    d0, s0, pub0 = _signed(91, 7191)
    Q = curve.point_mul(rng.randrange(1, CURVE_N), G)
    neg16 = _neg(curve.point_mul(16, G))
    lanes += [
        # collisions with a false verdict, r + n < p on small r
        _crafted(3, 3, G), _crafted(7, 7, G), _crafted(3, 3, _neg(G)),
        _crafted(0x10, 0x01, neg16),
        _crafted(0x04, 0x50, Q), _crafted(0x90, 0x03, Q),
        _crafted(0x00, 0x07, Q),
        # sanitation: off-curve, (0, 0), r >= n, s >= n, coordinate in
        # [p, 2^256), oversized digest, hostile ints
        (d0, s0, (CURVE_GX, CURVE_GY + 1)), (d0, s0, (0, 0)),
        (d0, (CURVE_N + 3, s0[1]), pub0), (d0, (s0[0], CURVE_N), pub0),
        (d0, s0, (pub0[0] + CURVE_P, pub0[1])) if pub0[0] + CURVE_P < 2 ** 256
        else (d0, s0, (pub0[0], pub0[1] + CURVE_P)),
        (hashlib.sha512(b"big").digest(), s0, pub0),
        (d0, (-1, s0[1]), pub0), (d0, (s0[0], 1 << 280), pub0),
        (d0, s0, (pub0[0] + (1 << 257), -5)),
        (d0, (0, s0[1]), pub0),
    ]
    while len(lanes) < 48:
        lanes.append(_signed(len(lanes), 7300 + len(lanes)))
    return tuple(list(x) for x in zip(*lanes))


def test_mix_reaches_every_path():
    digests, sigs, pubs = _mix()
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, len(digests))
    host = [p256._host_verify_prehashed(*a) for a in zip(zs, rs, ss, qxs, qys)]
    assert len(host) == 48
    # honest r + n lanes and honest collision lanes verify; r + n < p there
    assert host[16:22] == [True] * 6
    assert all(fused[41, 16:19])
    assert is_on_curve(pubs[16])


def test_complete_matches_jax_verify_device_host_and_jac():
    digests, sigs, pubs = _mix()
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, len(digests))
    host = [p256._host_verify_prehashed(*a) for a in zip(zs, rs, ss, qxs, qys)]
    jax_complete = np.asarray(jp256.verify_batch_prehashed(
        digests, sigs, pubs, backend="jnp", scalar_prep="host"))

    saved = p256.VERIFY_KERNEL
    try:
        p256.VERIFY_KERNEL = "complete"
        before = (p256.LAUNCHES, p256.COMPLETE_LAUNCHES, p256.EXCEPTION_LANES)
        mine = p256.verify_batch_prehashed(digests, sigs, pubs, device="cpu")
        # no lane ever takes the exception path, and a CPU tensor launches
        # nothing
        assert (p256.LAUNCHES, p256.COMPLETE_LAUNCHES,
                p256.EXCEPTION_LANES) == before
        p256.VERIFY_KERNEL = "jac"
        exc0 = p256.EXCEPTION_LANES
        jac = p256.verify_batch_prehashed(digests, sigs, pubs, device="cpu")
        flagged = p256.EXCEPTION_LANES - exc0
    finally:
        p256.VERIFY_KERNEL = saved

    assert mine.tolist() == jax_complete.tolist() == host == jac.tolist()
    # the honest collision lanes really reach the Jacobian exception path
    bits = p256.verify_plain(p256.packed_tensor(fused, "cpu")).numpy()
    assert all(bits[19:22] & 2) and flagged >= 3
    assert sum(mine) >= 20


def test_complete_plain_bits_and_rejects_bad_kernel_name():
    digests, sigs, pubs = _mix()
    fused = p256._pack_device_inputs(digests[:8], sigs[:8], pubs[:8], 8)[0]
    out = p256.verify_complete_packed(p256.packed_tensor(fused, "cpu"))
    assert out.dtype == torch.int32 and tuple(out.shape) == (8,)
    assert not (out & 2).any()
    with pytest.raises(ValueError):
        p256.verify_complete_packed(torch.zeros(41, 3, dtype=torch.int32))
    saved = p256.VERIFY_KERNEL
    try:
        p256.VERIFY_KERNEL = "rcb"
        with pytest.raises(ValueError):
            p256.verify_batch_prehashed(digests[:1], sigs[:1], pubs[:1],
                                        device="cpu")
    finally:
        p256.VERIFY_KERNEL = saved


def test_mults_per_lane_counts_the_complete_formulas():
    counts = p256.mults_per_lane("complete")
    # prep 341 + mod-p 6 + Q table 14 x 14 + ladder 64 x (4 x 14 + 28) + 2
    assert sum(counts.values()) == 341 + 6 + 14 * 14 + 64 * 84 + 2
    assert counts == {"n_mul": 83, "n_sqr": 256, "n_red": 2,
                      "p_mul": 4 + 196 + 64 * (4 * 8 + 28) + 2,
                      "p_sqr": 2 + 64 * 4 * 6}
    digests, sigs, pubs = _mix()
    _f, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, len(digests))
    ops = p256.MUL_OPS
    full = sum(ops[k] * v for k, v in counts.items())
    honest = p256.mul_ops_needed(zs[:1], rs[:1], ss[:1], qxs[:1], qys[:1],
                                 kernel="complete")
    assert 0.9 * full < honest < full
    # the complete ladder needs more than the Jacobian one on every lane
    jac = p256.mul_ops_needed(zs, rs, ss, qxs, qys)
    assert p256.mul_ops_needed(zs, rs, ss, qxs, qys, kernel="complete") > jac
    # a lane failing the range checks needs nothing under either ladder
    i = 31  # (d0, (N + 3, s0)): r >= n
    assert rs[i] >= CURVE_N
    assert p256.mul_ops_needed(zs[i:i + 1], rs[i:i + 1], ss[i:i + 1],
                               qxs[i:i + 1], qys[i:i + 1],
                               kernel="complete") == 0


@pytest.fixture(scope="module")
def group_kernel(tmp_path_factory):
    """csrc/p256_complete.cu built by the host's g++ under the group shim
    of test_torch_p256.py."""
    return build_group_kernel(tmp_path_factory.mktemp("complete"),
                              "p256_complete")


@pytest.fixture(scope="module")
def mix_plain():
    digests, sigs, pubs = _mix()
    fused = p256._pack_device_inputs(digests, sigs, pubs, len(digests))[0]
    return p256.verify_complete_plain(p256.packed_tensor(fused, "cpu")).numpy()


@pytest.mark.parametrize("lanes", [48, 33])
def test_complete_kernel_source_matches_plain_under_host_compiler(
        group_kernel, mix_plain, lanes):
    """csrc/p256_complete.cu, device code compiled as host C++ with each
    block's threads run as std::threads (groups of four synced in
    turns), against the plain PyTorch version: the whole mix (48
    lanes, two blocks, the second half empty), and its first 33 lanes (a
    partial warp and a partial block: one live group in the second
    block).  The plain version decides each lane alone, so its verdicts
    on the first 33 lanes of the mix are those lanes' verdicts."""
    digests, sigs, pubs = (x[:lanes] for x in _mix())
    fused = p256._pack_device_inputs(digests, sigs, pubs, lanes)[0]
    got = run_group_kernel(group_kernel, fused)
    assert got.tolist() == mix_plain[:lanes].tolist()
    assert got[16:22].tolist() == [1] * 6


@pytest.mark.cuda
def test_complete_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version and the Jacobian path's
    final verdicts (runs on a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    digests, sigs, pubs = _mix()
    fused = p256._pack_device_inputs(digests, sigs, pubs, len(digests))[0]
    launches = p256.COMPLETE_LAUNCHES
    got = p256.verify_complete_packed(p256.packed_tensor(fused, "cuda")).cpu()
    torch.cuda.synchronize()
    assert p256.COMPLETE_LAUNCHES == launches + 1
    assert torch.equal(
        got, p256.verify_complete_plain(p256.packed_tensor(fused, "cpu")))
    jac = p256.verify_batch_prehashed(digests, sigs, pubs, device="cuda")
    assert got.numpy().astype(bool).tolist() == jac.tolist()
