"""The port's Jacobian ladder at w = 5 (kernel B7, ``p256_verify_w5``)
against the JAX package's ``_ladder_kernel_jac`` at ``w=5``.

* ``_digits(limbs, 5)`` against JAX ``_digits_from_limbs(limbs, 5)``:
  52 digits MSB first, the top one reading zero bits past 256;
* ``verify_plain(packed, 5)`` against JAX ``_scalar_prep(..., w=5)`` +
  ``_jac_verify_eager(..., w=5)`` (the numpy twin of the Pallas kernel)
  on the mix of ``test_torch_p256.py``: honest and corrupted lanes, bad
  r, off-curve and (0, 0) keys, crafted collisions.  Verdict and
  exception bit of every lane, exactly;
* s^-1 keeps its fixed 4-bit window: u1 and u2 read back from the w = 5
  digits equal the w = 4 ones and the host's;
* the CUDA source's w = 5 instantiation, compiled by the host's g++
  under ``test_torch_p256.py``'s group shim, against the plain version;
* ``device.verify_window`` and ``UPOW_JAC_WINDOW`` parsed as the JAX
  package parses them (every window in [2, 13]: test_torch_p256_windows.py);
* on a card, the kernel against its plain version.

No tolerance: every compared value is a bit or an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upow_tpu.config as jconfig
from upow_tpu.crypto import fp as jfp, p256 as jp256
from upow_tpu_torch import config as tconfig
from upow_tpu_torch.core.constants import CURVE_N
from upow_tpu_torch.crypto import fp, p256
from test_torch_p256 import (_mix, _mix_lanes, build_group_kernel,
                             run_group_kernel)

RNG = np.random.default_rng(0xB7)
SCALARS = [0, 1, 2, CURVE_N - 1, (1 << 255) + 31, (1 << 256) - 1] + [
    int.from_bytes(RNG.bytes(32), "big") % CURVE_N for _ in range(10)]


def _from_digits(digits: np.ndarray, w: int) -> list:
    """(rounds, N) MSB-first digits -> the N integers they spell."""
    out = []
    for lane in digits.T:
        x = 0
        for d in lane:
            x = (x << w) | int(d)
        out.append(x)
    return out


@pytest.mark.parametrize("w", [4, 5])
def test_digits_match_jax(w):
    got = p256._digits(fp.ints_to_limbs(SCALARS), w).numpy()
    want = np.asarray(jp256._digits_from_limbs(jfp.ints_to_limbs(SCALARS), w))
    assert got.shape == (p256.rounds(w), len(SCALARS)) == want.shape
    assert np.array_equal(got, want)
    assert _from_digits(got, w) == SCALARS
    if w == 5:  # the top digit holds bit 255 alone
        assert set(got[0].tolist()) <= {0, 1}


def test_rounds_and_tables_per_window():
    assert [(p256.rounds(w), p256.table(w)) for w in (4, 5)] == \
        [(64, 15), (52, 31)]
    assert p256.rounds(5) == jp256._jac_rounds(5)
    g5 = p256._g_table_plain("cpu", 5)
    assert tuple(g5.shape) == (31, 2, fp.NUM_LIMBS)
    assert torch.equal(p256._g_table_plain("cpu", 4), g5[:15])
    consts = p256.kernel_constants()
    assert consts.size == 72 + 16 * 31 + 2


@pytest.fixture(scope="module")
def mix_fused():
    digests, sigs, pubs = _mix()
    return p256._pack_device_inputs(digests, sigs, pubs, len(digests))


def test_plain_w5_matches_jax_prep_and_eager(mix_fused):
    """Verdict and exception bit of every lane at w = 5, against the JAX
    scalar prep (jit on the CPU) and the numpy twin of the Pallas kernel
    at w = 5."""
    fused, zs, rs, ss, qxs, qys = mix_fused
    d1, d2, qx, qy, rm, rnm, flags = (
        np.asarray(a) for a in jp256._scalar_prep(
            *jp256._unpack_fused(jnp.asarray(fused)), w=5))
    ok_j, exc_j = jp256._jac_verify_eager(d1, d2, qx, qy, rm, rnm,
                                          flags[0] != 0, flags[1] != 0, w=5)
    packed = p256.packed_tensor(fused, "cpu")
    prep = p256._prep_plain(packed, 5)
    assert np.array_equal(prep[0].numpy(), d1)
    assert np.array_equal(prep[1].numpy(), d2)

    before = dict(p256.LAUNCHES_BY_WINDOW)
    bits = p256.verify_packed(packed, window=5).numpy()
    assert p256.LAUNCHES_BY_WINDOW == before  # a CPU tensor never launches
    assert list((bits & 1) != 0) == list(ok_j)
    assert list((bits & 2) != 0) == list(exc_j)
    # the crafted collisions reach the exception path at w = 5 too, and
    # every other lane agrees with the host oracle
    assert list(np.nonzero(exc_j)[0]) == [6, 7, 8, 9, 14]
    for i in range(len(zs)):
        if not bits[i] & 2:
            assert bool(bits[i] & 1) == p256._host_verify_prehashed(
                zs[i], rs[i], ss[i], qxs[i], qys[i]), i


def test_inverse_keeps_its_window(mix_fused):
    """u1 = z s^-1 and u2 = r s^-1 read back from the w = 5 digits equal
    the w = 4 ones and the host's pow(s, -1, n) on every valid lane: the
    prep's Fermat inversion does not follow the ladder's window."""
    fused, zs, rs, ss, qxs, qys = mix_fused
    packed = p256.packed_tensor(fused, "cpu")
    p4, p5 = p256._prep_plain(packed, 4), p256._prep_plain(packed, 5)
    valid = p5[6].numpy()
    for k in (0, 1):
        u4 = _from_digits(p4[k].numpy(), 4)
        u5 = _from_digits(p5[k].numpy(), 5)
        assert u4 == u5
        for i in np.nonzero(valid)[0]:
            want = (zs[i] if k == 0 else rs[i]) * pow(ss[i], -1, CURVE_N)
            assert u5[i] == want % CURVE_N
    for a, b in zip(p4[2:], p5[2:]):
        assert torch.equal(a, b)


def test_verify_batch_prehashed_at_w5_matches_the_oracle(monkeypatch,
                                                         mix_fused):
    """The entry point at VERIFY_WINDOW = 5 on the CPU: exception lanes
    re-checked on the host oracle, so every verdict is the oracle's."""
    digests, sigs, pubs = _mix()
    _f, zs, rs, ss, qxs, qys = mix_fused
    monkeypatch.setattr(p256, "VERIFY_WINDOW", 5)
    exc = p256.EXCEPTION_LANES
    got = p256.verify_batch_prehashed(digests, sigs, pubs, device="cpu")
    assert p256.EXCEPTION_LANES == exc + 5
    assert list(got) == [p256._host_verify_prehashed(*a)
                         for a in zip(zs, rs, ss, qxs, qys)]


def test_mults_per_lane_at_w5():
    counts = p256.mults_per_lane("jac", 5)
    # prep 341 + mod-p 6 + Q table (dbl + 29 madd) 327 + 52 x (5 dbl +
    # madd + add) + final 3
    assert sum(counts.values()) == 341 + 6 + 327 + 52 * 67 + 3
    assert counts["n_mul"] == p256.mults_per_lane()["n_mul"] == 83
    assert counts["n_sqr"] == 256
    with pytest.raises(ValueError):
        p256.mults_per_lane("complete", 5)
    # on the six signed lanes (full-length scalars) the shorter ladder
    # outweighs the longer Q table; the crafted lanes' one-digit ladders
    # do not
    _f, zs, rs, ss, qxs, qys = p256._pack_device_inputs(*_mix(), 22)
    signed = [x[:6] for x in (zs, rs, ss, qxs, qys)]
    w4 = p256.mul_ops_needed(*signed)
    w5 = p256.mul_ops_needed(*signed, w=5)
    assert 0.95 * w4 < w5 < w4
    crafted = [x[6:10] for x in (zs, rs, ss, qxs, qys)]
    assert p256.mul_ops_needed(*crafted, w=5) > p256.mul_ops_needed(*crafted)


@pytest.fixture(scope="module")
def w5_kernel(tmp_path_factory):
    return build_group_kernel(tmp_path_factory.mktemp("jac5"), "p256_verify",
                              kernel="p256_verify_w5_kernel")


@pytest.mark.parametrize("lanes", [22, 33])
def test_w5_kernel_source_matches_plain_under_host_compiler(w5_kernel, lanes):
    """csrc/p256_verify.cu's w = 5 instantiation, device code compiled as
    host C++ with each block's threads run as std::threads, against the
    plain version at w = 5, bit for bit, exception lanes included."""
    digests, sigs, pubs = _mix_lanes(lanes)
    fused = p256._pack_device_inputs(digests, sigs, pubs, lanes)[0]
    got = run_group_kernel(w5_kernel, fused)
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu"), 5).numpy()
    assert got.tolist() == want.tolist()
    n0 = len(_mix()[0])
    assert [i for i in range(lanes) if got[i] & 2] == \
        [i for i in range(lanes) if i % n0 in (6, 7, 8, 9, 14)]


@pytest.fixture
def windows():
    """Restore both packages' module-level kernel choices."""
    saved = (p256.VERIFY_WINDOW, p256.VERIFY_KERNEL,
             jp256.PALLAS_JAC_WINDOW, jp256.PALLAS_KERNEL)
    yield
    (p256.VERIFY_WINDOW, p256.VERIFY_KERNEL,
     jp256.PALLAS_JAC_WINDOW, jp256.PALLAS_KERNEL) = saved


@pytest.mark.parametrize("window", [0, 4, 5])
def test_config_window_applies_like_jax(windows, window):
    tconfig.DeviceConfig(verify_window=window).apply_kernel_overrides()
    jconfig.DeviceConfig(verify_window=window).apply_kernel_overrides()
    assert p256.VERIFY_WINDOW == jp256.PALLAS_JAC_WINDOW == (window or 4)


@pytest.mark.parametrize("window", [14, 1, -5, True, "5", 5.0])
def test_config_window_rejected_like_jax(windows, window):
    for cfg in (tconfig.DeviceConfig, jconfig.DeviceConfig):
        with pytest.raises(ValueError, match=r"\[2, 13\]"):
            cfg(verify_window=window).apply_kernel_overrides()
    assert p256.VERIFY_WINDOW == jp256.PALLAS_JAC_WINDOW == 4


def test_config_reads_the_window_from_the_jax_environment(monkeypatch):
    monkeypatch.setenv("UPOW_DEVICE_VERIFY_WINDOW", "5")
    monkeypatch.setenv("UPOW_DEVICE_MESH_DEVICES", "3")
    got, want = tconfig.Config.load().device, jconfig.Config.load().device
    assert (got.verify_window, got.mesh_devices) == \
        (want.verify_window, want.mesh_devices) == (5, 3)
    assert tconfig.DeviceConfig().mesh_devices == \
        jconfig.DeviceConfig().mesh_devices == 0


@pytest.mark.parametrize("raw", [None, "4", "5", " 5 ", "6", "x", ""])
def test_jac_window_environment_parsed_like_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("UPOW_JAC_WINDOW", raising=False)
    else:
        monkeypatch.setenv("UPOW_JAC_WINDOW", raw)
    assert p256._env_window() == jp256._env_choice("UPOW_JAC_WINDOW", 4,
                                                   {4, 5})


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8192, 1026, 33, 1])
def test_w5_kernel_matches_plain_on_card(lanes):
    """Kernel B7 against its plain version on the card, bit for bit, at
    a full block of signatures, the accept's launch shapes and a partial
    warp (runs on a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    digests, sigs, pubs = _mix_lanes(lanes)
    fused = p256._pack_device_inputs(digests, sigs, pubs, lanes)[0]
    packed = p256.packed_tensor(fused, "cuda")
    before = dict(p256.LAUNCHES_BY_WINDOW)
    got = p256.verify_packed(packed, window=5)
    torch.cuda.synchronize()
    assert p256.LAUNCHES_BY_WINDOW == {**before, 5: before[5] + 1}
    assert torch.equal(got, p256.verify_plain(packed, 5))
