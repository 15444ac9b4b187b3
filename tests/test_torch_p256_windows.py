"""The port's Jacobian ladder at every window ``device.verify_window``
admits (w = 2-13) against the JAX package's ``_ladder_kernel_jac`` at
``w``: kernels B1 and B7 (w = 4, 5) beside the new instantiations of
``csrc/p256_verify.cu`` (w = 2, 3) and ``csrc/p256_verify_wide.cu``
(w = 6-13, the Q tables in device memory).

* ``_digits(limbs, w)`` against JAX ``_digits_from_limbs(limbs, w)``.
* ``_prep_plain(packed, w)`` against JAX ``_scalar_prep(..., w)``.  That
  program is jitted per window and one XLA:CPU compile of it takes about
  a minute here, so it is compiled once (w = 4) and each window's digits
  are what its last two lines compute from the same u1 and u2: JAX
  ``_digits_from_limbs(u, w)``; nothing else in it reads ``w``.
* ``verify_plain(packed, w)`` against JAX ``_jac_verify_eager(..., w)``
  (the numpy twin of the Pallas kernel) on ``test_torch_p256.py``'s mix,
  verdict and exception bit of every lane: full ladders at w = 2, 3, 6
  and 7, each lane's full verdict also against ``_host_verify_prehashed``.
  Windows 8-13 (short ladders, where the Q tables grow to 8,191 entries)
  are ``test_torch_p256_wide.py``'s.
* The CUDA sources, compiled by the host's g++ under
  ``test_torch_p256.py``'s group shim, against the plain version: w = 2
  and 3 (``p256_verify.cu``) and w = 6 (``p256_verify_wide.cu``, one
  block walking 40 signatures grid-stride, so slots and tables are
  reused).
* ``DeviceConfig(verify_window=w)`` applied like the JAX package's at
  every window; ``UPOW_JAC_WINDOW`` still takes only 4 and 5.
* On a card, each new window's kernel against its plain version.

No tolerance: every compared value is a bit or an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upow_tpu.config as jconfig
from upow_tpu.crypto import fp as jfp, p256 as jp256
from upow_tpu_torch import config as tconfig
from upow_tpu_torch.core import curve
from upow_tpu_torch.core.codecs import is_on_curve
from upow_tpu_torch.core.constants import CURVE_N, CURVE_P
from upow_tpu_torch.crypto import fp, p256
from test_torch_p256 import (_crafted, _mix, _mix_lanes, build_group_kernel,
                             run_group_kernel)

NEW = [w for w in p256.WINDOWS if w not in (4, 5)]
WIDE = [w for w in p256.WINDOWS if w not in p256.SHARED_WINDOWS]
RNG = np.random.default_rng(0xB7B)
SCALARS = [0, 1, 2, 3, CURVE_N - 1, (1 << 255) + 31, (1 << 256) - 1] + [
    int.from_bytes(RNG.bytes(32), "big") % CURVE_N for _ in range(9)]


def _from_digits(digits: np.ndarray, w: int) -> list:
    """(rounds, N) MSB-first digits -> the N integers they spell."""
    out = []
    for lane in digits.T:
        x = 0
        for d in lane:
            x = (x << w) | int(d)
        out.append(x)
    return out


def top_collision(w: int):
    """A lane whose first round collides: u1 = u2 = 3 in the top digit
    (s = 1), Q = G, so the Q add meets [3]G with [3]Q."""
    top = 3 << (w * (p256.rounds(w) - 1))
    return _crafted(top, top, curve.G)


def packed_lanes(lanes) -> tuple:
    digests, sigs, pubs = lanes
    return p256._pack_device_inputs(digests, sigs, pubs, len(digests))


def jax_prep(fused: np.ndarray) -> tuple:
    """JAX ``_scalar_prep`` of 22 packed lanes at w = 4 (one compile for
    the file: the jit is keyed by shape): u1 and u2 read back from its
    digits, and its window-free outputs (qx, qy, r R, (r + n) R, flags)."""
    assert fused.shape == (p256.PACKED_ROWS, 22)
    d1, d2, *rest = (np.asarray(a) for a in jp256._scalar_prep(
        *jp256._unpack_fused(jnp.asarray(fused))))
    return _from_digits(d1, 4), _from_digits(d2, 4), rest


def jax_prep_at(jprep, w: int) -> tuple:
    """What JAX ``_scalar_prep(..., w=w)`` returns for the same lanes: its
    digits step on the same canonical u1 and u2."""
    u1, u2, rest = jprep
    return tuple(np.asarray(jp256._digits_from_limbs(jfp.ints_to_limbs(u), w))
                 for u in (u1, u2)) + tuple(rest)


@pytest.fixture(scope="module")
def mix_prep():
    return jax_prep(packed_lanes(_mix())[0])


def with_top_collision(w: int) -> tuple:
    """The mix with its last lane (an honest signature) replaced by
    :func:`top_collision`'s lane, 22 lanes as the mix."""
    extra = top_collision(w)
    return tuple(x[:-1] + [e] for x, e in zip(_mix(), extra))


@pytest.mark.parametrize("w", p256.WINDOWS)
def test_digits_match_jax(w):
    got = p256._digits(fp.ints_to_limbs(SCALARS), w).numpy()
    want = np.asarray(jp256._digits_from_limbs(jfp.ints_to_limbs(SCALARS), w))
    assert got.shape == (p256.rounds(w), len(SCALARS)) == want.shape
    assert p256.rounds(w) == jp256._jac_rounds(w)
    assert np.array_equal(got, want)
    assert _from_digits(got, w) == SCALARS
    # the top digit holds what is left of 256 bits
    assert int(got[0].max()) < 1 << (256 - w * (p256.rounds(w) - 1))


def _plain_ints(t: torch.Tensor) -> list:
    """Port Montgomery limbs (R = 2^288) -> the canonical plain values."""
    canon = fp.canonical_from_mont(t, p256.FP).numpy()
    return [sum(int(canon[k, j]) << (fp.LIMB_BITS * k)
                for k in range(fp.NUM_LIMBS)) for j in range(canon.shape[1])]


def _jax_plain_ints(limbs: np.ndarray) -> list:
    """JAX canonical Montgomery limbs (R = 2^273) -> the plain values."""
    rinv = pow(1 << jfp.R_BITS, -1, p256.FP.m)
    return [v * rinv % p256.FP.m for v in jfp.limbs_to_ints(limbs)]


@pytest.mark.parametrize("w", p256.WINDOWS)
def test_prep_matches_jax(w, mix_prep):
    packed = p256.packed_tensor(packed_lanes(_mix())[0], "cpu")
    d1, d2, qx, qy, rm, rnm, valid, rn_ok = p256._prep_plain(packed, w)
    jd1, jd2, jqx, jqy, jrm, jrnm, flags = jax_prep_at(mix_prep, w)
    assert np.array_equal(d1.numpy(), jd1)
    assert np.array_equal(d2.numpy(), jd2)
    if w == 4:  # the window-free outputs, once
        for mine, theirs in ((qx, jqx), (qy, jqy), (rm, jrm), (rnm, jrnm)):
            assert _plain_ints(mine) == _jax_plain_ints(theirs)
        assert valid.tolist() == (flags[1] != 0).tolist()
        assert rn_ok.tolist() == (flags[0] != 0).tolist()


def _oracle_bits(fused_lists, bits) -> None:
    """Every lane the ladder did not flag has the host oracle's verdict."""
    _f, zs, rs, ss, qxs, qys = fused_lists
    for i in range(len(zs)):
        if not bits[i] & 2:
            assert bool(bits[i] & 1) == p256._host_verify_prehashed(
                zs[i], rs[i], ss[i], qxs[i], qys[i]), i


@pytest.mark.parametrize("w", [2, 3, 6, 7])
def test_plain_matches_jax_eager_full_ladder(w, mix_prep):
    """Verdict and exception bit of every lane of the mix at window w,
    against the JAX twin's full ladder."""
    packed_all = packed_lanes(_mix())
    d1, d2, qx, qy, rm, rnm, flags = jax_prep_at(mix_prep, w)
    ok_j, exc_j = jp256._jac_verify_eager(d1, d2, qx, qy, rm, rnm,
                                          flags[0] != 0, flags[1] != 0, w=w)
    before = dict(p256.LAUNCHES_BY_WINDOW)
    bits = p256.verify_packed(p256.packed_tensor(packed_all[0], "cpu"),
                              window=w).numpy()
    assert p256.LAUNCHES_BY_WINDOW == before  # a CPU tensor never launches
    assert list((bits & 1) != 0) == list(ok_j)
    assert list((bits & 2) != 0) == list(exc_j)
    # the crafted collisions reach the exception path at every window
    assert {6, 7, 8, 9} <= set(np.nonzero(exc_j)[0])
    _oracle_bits(packed_all, bits)


@pytest.fixture
def windows():
    """Restore both packages' module-level kernel choices."""
    saved = (p256.VERIFY_WINDOW, p256.VERIFY_KERNEL,
             jp256.PALLAS_JAC_WINDOW, jp256.PALLAS_KERNEL)
    yield
    (p256.VERIFY_WINDOW, p256.VERIFY_KERNEL,
     jp256.PALLAS_JAC_WINDOW, jp256.PALLAS_KERNEL) = saved


@pytest.mark.parametrize("window", p256.WINDOWS)
def test_config_window_applies_like_jax(windows, window):
    """Every window the JAX config takes sets the same window in both
    packages, with either kernel named beside it."""
    for kernel in ("", "complete"):
        tconfig.DeviceConfig(verify_kernel=kernel,
                             verify_window=window).apply_kernel_overrides()
        jconfig.DeviceConfig(verify_kernel=kernel,
                             verify_window=window).apply_kernel_overrides()
        assert p256.VERIFY_WINDOW == jp256.PALLAS_JAC_WINDOW == window
        assert p256.VERIFY_KERNEL == jp256.PALLAS_KERNEL
    assert p256._verify_entry(window) == (
        ("p256_verify", "p256_verify" if window == 4
         else f"p256_verify_w{window}")
        if window <= 5 else ("p256_verify_wide", "p256_verify_wide"))


@pytest.mark.parametrize("raw", ["2", "3", "6", "13"])
def test_jac_window_environment_takes_only_4_and_5(monkeypatch, raw):
    monkeypatch.setenv("UPOW_JAC_WINDOW", raw)
    assert p256._env_window() == jp256._env_choice(
        "UPOW_JAC_WINDOW", 4, {4, 5}) == 4


@pytest.mark.parametrize("window", [1, 14, 0])
def test_verify_packed_refuses_other_windows(window):
    packed = p256.packed_tensor(packed_lanes(_mix())[0], "cpu")
    with pytest.raises(ValueError, match="window"):
        p256.verify_packed(packed, window=window)


def test_products_and_bytes_per_window():
    """The bound's two terms: products a lane (the Q table's madds grow
    as 2^w, the ladder's adds shrink as 1/w) and, at the wide windows,
    the Q table's bytes."""
    per_lane = {w: sum(p256.mults_per_lane("jac", w).values())
                for w in p256.WINDOWS}
    for w in p256.WINDOWS:
        # prep 341 + mod-p 6 + Q table (dbl + 2^w - 3 madd) + rounds x
        # (w dbl + madd + add) + final 3
        assert per_lane[w] == 341 + 6 + 8 + 11 * (p256.table(w) - 2) \
            + p256.rounds(w) * (8 * w + 11 + 16) + 3
    assert min(per_lane, key=per_lane.get) == 5
    _f, zs, rs, ss, qxs, qys = packed_lanes(_mix())
    lanes = len(zs)
    for w in p256.SHARED_WINDOWS:
        assert p256.bytes_needed(zs, rs, ss, qxs, qys, w) == lanes * 172
    # a lane ladders unless the range or on-curve checks fail it; each
    # writes its table and reads one entry a nonzero Q digit
    ladders = sum(1 for r, s, qx, qy in zip(rs, ss, qxs, qys)
                  if 0 < r < CURVE_N and 0 < s < CURVE_N
                  and (qx, qy) != (0, 0)
                  and is_on_curve((qx % CURVE_P, qy % CURVE_P)))
    assert ladders == 16
    for w in WIDE:
        got = p256.bytes_needed(zs, rs, ss, qxs, qys, w)
        table_bytes = ladders * p256.table(w) * 160
        assert table_bytes < got - lanes * 172 - p256.table(w) * 64 \
            <= table_bytes + ladders * p256.rounds(w) * 160
    # 8,192 lanes at w = 13: about 10.7 GB of tables
    assert 8192 * p256.table(13) * 160 == 10_736_107_520


@pytest.fixture(scope="module")
def small_kernels(tmp_path_factory):
    return {w: build_group_kernel(tmp_path_factory.mktemp(f"jac{w}"),
                                  "p256_verify",
                                  kernel=f"p256_verify_w{w}_kernel")
            for w in (2, 3)}


@pytest.mark.parametrize("w", [2, 3])
def test_small_window_kernel_source_matches_plain_under_host_compiler(
        small_kernels, w):
    """csrc/p256_verify.cu's w = 2 and w = 3 instantiations, compiled as
    host C++ under the group shim, against the plain version on the mix
    repeated to 33 lanes (a second block), bit for bit."""
    digests, sigs, pubs = _mix_lanes(33)
    fused = p256._pack_device_inputs(digests, sigs, pubs, 33)[0]
    got = run_group_kernel(small_kernels[w], fused)
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu"), w).numpy()
    assert got.tolist() == want.tolist()
    assert {6, 7, 8, 9, 28, 29, 30, 31} <= {i for i in range(33) if got[i] & 2}


# main() for p256_verify_wide.cu under the group shim: reads (constants,
# n, packed, w, grid, groups a signature, G-table words), runs ``grid``
# blocks one after another (each its 128 threads as std::threads) over a
# scratch of grid * 32 / groups Q tables that starts as garbage, and
# writes n int32.
WIDE_MAIN = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
inline dim3_ gridDim;
#include "kernel.cpp"
alignas(16) uint32_t smem[1 << 16];
static std::vector<uint32_t> rd(FILE* f, size_t n) {
  std::vector<uint32_t> v(n);
  if (fread(v.data(), 4, n, f) != n) exit(2);
  return v;
}
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<uint32_t> c = rd(f, rd(f, 1)[0]);
  const int n = rd(f, 1)[0];
  std::vector<uint32_t> pk = rd(f, 42 * (size_t)n);
  const int w = rd(f, 1)[0], grid = rd(f, 1)[0], groups = rd(f, 1)[0];
  std::vector<uint32_t> g = rd(f, rd(f, 1)[0]);
  fclose(f);
  if (p256_set_constants(c.data(), (int)c.size()) != 0) return 3;
  std::vector<uint32_t> scratch(
      (size_t)grid * (SIGS / groups) * ((1u << w) - 1) * Q_ENTRY,
      0xA5A5A5A5u);
  std::vector<int32_t> out(n, -1);
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    memset(smem, 0xA5, sizeof smem);  // shared memory starts undefined
    BlockSync sync(THREADS);
    g_sync = &sync;
    std::vector<std::thread> ts;
    for (int t = 0; t < THREADS; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        p256_verify_wide_kernel(pk.data(), out.data(), n, w, groups,
                                g.data(), scratch.data());
        group_exit();
      });
    for (auto& t : ts) t.join();
  }
  FILE* o = fopen(argv[2], "wb");
  fwrite(out.data(), 4, n, o);
  fclose(o);
  return 0;
}
"""


def build_wide_kernel(tmp) -> object:
    return build_group_kernel(tmp, "p256_verify_wide", main=WIDE_MAIN)


def run_wide_kernel(binary, fused: np.ndarray, w: int, grid: int,
                    groups: int = 1) -> np.ndarray:
    """The g++-built wide kernel on one packed (42, n) uint32 array, each
    signature on ``groups`` groups of four."""
    import subprocess

    n = fused.shape[1]
    consts = p256.kernel_constants()
    g = np.array(p256._g_words(p256.table(w)), dtype=np.uint32)
    blob = b"".join([np.array([consts.size], np.uint32).tobytes(),
                     consts.tobytes(), np.array([n], np.uint32).tobytes(),
                     fused.astype(np.uint32).tobytes(),
                     np.array([w, grid, groups, g.size],
                              np.uint32).tobytes(),
                     g.tobytes()])
    inp = binary.with_name(f"in{n}_{w}_{groups}.bin")
    outp = binary.with_name(f"out{n}_{w}_{groups}.bin")
    inp.write_bytes(blob)
    subprocess.run([str(binary), str(inp), str(outp)], check=True,
                   timeout=600)
    return np.fromfile(outp, dtype=np.int32)


@pytest.fixture(scope="module")
def wide_kernel(tmp_path_factory):
    return build_wide_kernel(tmp_path_factory.mktemp("jacwide"))


def test_wide_kernel_source_matches_plain_under_host_compiler(wide_kernel):
    """csrc/p256_verify_wide.cu at w = 6 under the group shim: one block
    of 32 groups walks 40 lanes grid-stride (8 groups take a second
    signature into the slot and table the first one left), against the
    plain version, bit for bit, exception lanes included."""
    digests, sigs, pubs = _mix_lanes(40)
    fused = p256._pack_device_inputs(digests, sigs, pubs, 40)[0]
    got = run_wide_kernel(wide_kernel, fused, 6, grid=1)
    want = p256.verify_plain(p256.packed_tensor(fused, "cpu"), 6).numpy()
    assert got.tolist() == want.tolist()
    assert {6, 7, 8, 9, 28, 29, 30, 31} <= {i for i in range(40) if got[i] & 2}


@pytest.mark.cuda
@pytest.mark.parametrize("w", NEW)
def test_window_kernel_matches_plain_on_card(w):
    """Each new window's kernel against its plain version on the card,
    bit for bit, on 40 lanes (two blocks; runs on a machine with a card,
    skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    digests, sigs, pubs = _mix_lanes(40)
    fused = p256._pack_device_inputs(digests, sigs, pubs, 40)[0]
    packed = p256.packed_tensor(fused, "cuda")
    before = dict(p256.LAUNCHES_BY_WINDOW)
    got = p256.verify_packed(packed, window=w)
    torch.cuda.synchronize()
    assert p256.LAUNCHES_BY_WINDOW == {**before, w: before[w] + 1}
    assert torch.equal(got, p256.verify_plain(packed, w))
