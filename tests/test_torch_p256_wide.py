"""The port's Jacobian ladder at w = 8-11 against the JAX package's, where
the Q table grows to 2,047 entries a lane (``test_torch_p256_windows.py``
holds w = 2-7 and the rest of the window tests,
``test_torch_p256_widest.py`` w = 12 and 13).

Both packages build a lane's Q table as one chain of 2^w - 2 formulas
([2]Q = dbl, then [k]Q = [k-1]Q + Q), so its cost here is the chain's
length whatever the lanes: about 4 ms a madd for the port's plain version
and 28 ms for the JAX twin's numpy limbs.

* w = 8 and 9: the first 4 rounds of ``verify_plain`` against JAX
  ``_jac_verify_eager(..., n_rounds=4, w)`` (the twin builds its own
  table: 7 and 14 s), verdict and exception bit of every lane of the mix
  with one lane whose top digits collide (flagged in round 0).
* w = 10 and 11, where the twin's own table would take 29 s and 57 s: the
  port's table is held entry by entry against JAX's formulas, every
  entry at once (JAX ``_jac_dbl`` on [1]Q and ``_jac_madd`` on [k-1]Q and
  Q for k = 3 .. 2^w - 1, lanes side by side), so by induction it is the
  table the twin would build, value for value mod p; then the first 4
  rounds of the plain ladder against JAX's ``_jac_round`` and
  ``_jac_final`` over that table (the twin's own loop, with selects by
  index where the twin sums a mask an entry).
* At every one of them the full ladder's verdicts against the host
  oracle on every lane it did not flag.

No tolerance: every compared value is a bit or an integer.
"""

import numpy as np
import pytest

from upow_tpu.crypto import fp as jfp, p256 as jp256
from upow_tpu_torch.core.constants import CURVE_P
from upow_tpu_torch.crypto import fp, p256
from test_torch_p256_windows import (_oracle_bits, jax_prep, jax_prep_at,
                                     packed_lanes, with_top_collision)

N_ROUNDS = 4


def plain_and_jax(w: int) -> dict:
    """The mix with a top-digit collision at window w: the plain prep,
    Q table, short (``N_ROUNDS``) and full ladders, and the JAX prep."""
    lanes = packed_lanes(with_top_collision(w))
    prep = p256._prep_plain(p256.packed_tensor(lanes[0], "cpu"), w)
    qtab = p256._qtable_plain(prep[2], prep[3], w)
    jprep = jax_prep_at(jax_prep(lanes[0]), w)
    assert np.array_equal(prep[0].numpy(), jprep[0])
    assert np.array_equal(prep[1].numpy(), jprep[1])
    return {"lanes": lanes, "prep": prep, "qtab": qtab, "jprep": jprep,
            "short": p256._ladder_plain(prep, qtab, w, N_ROUNDS).numpy(),
            "full": p256._ladder_plain(prep, qtab, w).numpy()}


def check(got: dict, ok_j, exc_j) -> None:
    short, full = got["short"], got["full"]
    assert list((short & 1) != 0) == list(ok_j)
    assert list((short & 2) != 0) == list(exc_j)
    assert exc_j[-1]  # the top-digit collision is flagged in round 0
    assert full[-1] & 2
    _oracle_bits(got["lanes"], full)


@pytest.mark.parametrize("w", [8, 9])
def test_short_ladder_matches_jax_eager(w):
    got = plain_and_jax(w)
    d1, d2, qx, qy, rm, rnm, flags = got["jprep"]
    ok_j, exc_j = jp256._jac_verify_eager(d1, d2, qx, qy, rm, rnm,
                                          flags[0] != 0, flags[1] != 0,
                                          n_rounds=N_ROUNDS, w=w)
    check(got, ok_j, exc_j)


def to_jax(t) -> np.ndarray:
    """Port limbs (..., 12, N) int64, Montgomery R = 2^288 -> JAX
    canonical limbs (..., 21, N) int32 of the same values, R = 2^273."""
    a = t.numpy()
    lead, n = a.shape[:-2], a.shape[-1]
    a = np.moveaxis(a.reshape(-1, fp.NUM_LIMBS, n), 1, 0).reshape(
        fp.NUM_LIMBS, -1)
    vals = sum(a[k].astype(object) << (fp.LIMB_BITS * k)
               for k in range(fp.NUM_LIMBS))
    shift = pow(1 << (fp.R_BITS - jfp.R_BITS), -1, CURVE_P)
    limbs = jfp.ints_to_limbs([int(v) * shift % CURVE_P for v in vals])
    return np.moveaxis(limbs.reshape(jfp.NUM_LIMBS, -1, n), 0, 1).reshape(
        *lead, jfp.NUM_LIMBS, n)


def jax_values(point) -> list:
    """A JAX point's coordinates as lists of ints mod p."""
    return [[v % CURVE_P for v in jfp.limbs_to_ints(np.stack(c.limbs))]
            for c in point]


def fl(limbs: np.ndarray, bound: int):
    return jfp.l_wrap([limbs[i] for i in range(jfp.NUM_LIMBS)], bound)


def jax_ladder_over(w: int, jprep, jtab: np.ndarray, n_rounds: int):
    """``_jac_verify_eager``'s rounds and final test, its helpers called
    as it calls them, over the table ``jtab`` ((2^w - 1, 3, 21, N) JAX
    limbs); the picks select by index."""
    d1, d2, qx, qy, rm, rnm, flags = jprep
    n = qx.shape[1]
    g_tab = jp256._g_affine_table(w)                       # entry 0: zeros
    q_tab = np.concatenate([np.zeros_like(jtab[:1]), jtab])
    lane = np.arange(n)

    def g_pick_fn(dg):
        return tuple(fl(g_tab[c][dg].T, CURVE_P) for c in range(2))

    def q_pick_fn(dg):
        return tuple(fl(q_tab[dg, c, :, lane].T, jp256._JB)
                     for c in range(3))

    acc = jp256._jac_identity(np.zeros((n,), np.int32))
    started = np.zeros((n,), np.int32)
    exc = np.zeros((n,), np.int32)
    for k in range(n_rounds):
        acc, started, exc = jp256._jac_round(acc, started, exc, d1[k], d2[k],
                                             g_pick_fn, q_pick_fn, w=w)
    ok = jp256._jac_final(acc, started, fl(rm, CURVE_P), fl(rnm, CURVE_P),
                          flags[0] != 0, flags[1] != 0)
    return np.asarray(ok), np.asarray(exc != 0)


def table_and_short_ladder_check(got: dict, w: int) -> None:
    """``got`` (:func:`plain_and_jax`) at window w: the plain Q table
    against JAX's formulas entry by entry, then the short ladder against
    JAX's rounds over that table."""
    jprep = got["jprep"]
    jtab = to_jax(got["qtab"])                        # (T, 3, 21, N)
    t, n = p256.table(w), jtab.shape[-1]
    qx, qy = fl(jprep[2], CURVE_P), fl(jprep[3], CURVE_P)
    # [2]Q = dbl([1]Q), with [1]Q = (qx, qy, 1) as the twin lifts it
    first = tuple(fl(jtab[0, c], CURVE_P) for c in range(3))
    assert jax_values(first) == jax_values((qx, qy)) + [[jp256._ONE_M] * n]
    assert jax_values(jp256._jac_dbl(first)) == \
        [[v % CURVE_P for v in jfp.limbs_to_ints(jtab[1, c])]
         for c in range(3)]
    # [k]Q = madd([k-1]Q, Q) for k = 3 .. t, every k at once
    prev = tuple(fl(np.concatenate(list(jtab[1:t - 1, c]), axis=1),
                    jp256._JB) for c in range(3))
    tile = lambda a: fl(np.tile(a, (1, t - 2)), CURVE_P)  # noqa: E731
    nxt, _h = jp256._jac_madd(prev, tile(jprep[2]), tile(jprep[3]))
    want = [[v % CURVE_P for v in jfp.limbs_to_ints(
        np.concatenate(list(jtab[2:, c]), axis=1))] for c in range(3)]
    assert jax_values(nxt) == want
    check(got, *jax_ladder_over(w, jprep, jtab, N_ROUNDS))


@pytest.mark.parametrize("w", [10, 11])
def test_table_and_short_ladder_match_jax(w):
    table_and_short_ladder_check(plain_and_jax(w), w)
