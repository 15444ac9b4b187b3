"""The port's Jacobian ladder at w = 12 and 13 against the JAX
package's: the largest Q tables (4,095 and 8,191 entries a lane), held as
``test_torch_p256_wide.py`` holds w = 10 and 11 (the port's table entry
by entry against JAX's formulas, then the first rounds against JAX's
``_jac_round`` over it, and the full verdicts against the host oracle);
and ``csrc/p256_verify_wide.cu`` at w = 13 under the g++ group shim on 3
lanes of the same mix (an honest signature, a crafted collision, the
(0, 0) key), against the plain version's lanes, bit for bit.  The port's
plain table at w = 13 is about 34 s of this file, the JAX twin's own
would be about 230 s.

No tolerance: every compared value is a bit or an integer.
"""

import numpy as np
import pytest

from test_torch_p256_wide import plain_and_jax, table_and_short_ladder_check
from test_torch_p256_windows import build_wide_kernel, run_wide_kernel


@pytest.fixture(scope="module")
def at13():
    return plain_and_jax(13)


def test_table_and_short_ladder_match_jax_at_12():
    table_and_short_ladder_check(plain_and_jax(12), 12)


def test_table_and_short_ladder_match_jax_at_13(at13):
    table_and_short_ladder_check(at13, 13)


@pytest.fixture(scope="module")
def wide_kernel(tmp_path_factory):
    return build_wide_kernel(tmp_path_factory.mktemp("jacwide13"))


def test_wide_kernel_at_13_matches_plain_under_host_compiler(wide_kernel,
                                                             at13):
    """csrc/p256_verify_wide.cu at w = 13 (34,042 group steps a lane) on
    an honest lane, a crafted collision and the (0, 0) key of the mix,
    against the plain version's same lanes, bit for bit."""
    pick = [0, 6, 14]
    fused = np.ascontiguousarray(at13["lanes"][0][:, pick])
    got = run_wide_kernel(wide_kernel, fused, 13, grid=1)
    assert got.tolist() == at13["full"][pick].tolist()
    assert not got[0] & 2 and got[1] & 2
