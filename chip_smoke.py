"""Drive the PyTorch/CUDA port's two paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every kernel of the paths from csrc/ with nvcc (sm_90a), one
   nvcc per source, all started together, with ptxas's registers and
   spills, and the sha256 kernel's SASS opcodes per loop trip
   (cuobjdump);
3. kernel vs plain, P-256: the verify kernel against its plain PyTorch
   version on 8,192 lanes (one full block of signatures: honest,
   corrupted, r + n < p, off-curve, (0, 0), oversized digests and
   coordinates, crafted ladder collisions), bit for bit, with verdicts
   held against the host oracle on a sample; then at the main path's
   launch shapes (1,026 lanes, a ragged edge, and 1 lane); times and
   the bound;
4. kernel vs plain, sha256: the nonce-search kernel against its plain
   PyTorch version (and a hashlib brute force where the range is small
   or its first hit near) on v2 and v1 templates, integer and
   fractional difficulties, a miss, dense hits, ragged counts, a range
   ending at 2^32 - 1, and 16 consecutive 2^24-nonce rounds at
   difficulty 5 (the miner's dispatch shape); times and the bound;
5. the accept path: a 3-block chain fanning one coinbase into 255 x 32
   outputs, each block mined by the port's ``mine(job, "cuda")`` at the
   protocol's difficulty 6.0, then ``BlockManager(state).create_block``
   of the 8,160-tx block on the card, counting kernel launches and
   exception lanes, with the device's busy time read by
   ``torch.profiler`` (CUDA activity only); then a block with one
   corrupted signature and a block that spends an output twice must be
   rejected with the reference's error strings;
6. the miner's path: ``upow_tpu_torch.mine.miner.run(device="cuda",
   once=True)`` against a stub node (a stdlib HTTP server over the same
   chain, holding 64 pending txs) must push a block that the port's
   ``BlockManager`` accepts, with the sha256 launches counted;
7. the hash rate: one template at difficulty 10 swept over all 2^32 - 1
   nonces through ``mine(job, "cuda", batch=2**24)``, with the card's
   busy time and idle share from the profiler; then a difficulty-6.3 job
   mined to a hit that hashlib checks.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import hashlib
import json
import random
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from upow_tpu_torch import _build, device as tdevice, trace
from upow_tpu_torch.core import clock, curve, point_to_string
from upow_tpu_torch.core.constants import CURVE_GX, CURVE_GY, CURVE_N, CURVE_P
from upow_tpu_torch.core.difficulty import (
    START_DIFFICULTY, charset_count, check_pow_hash)
from upow_tpu_torch.core.merkle import merkle_root
from upow_tpu_torch.core.tx import Tx, TxInput, TxOutput
from upow_tpu_torch.crypto import p256, sha256 as tsha
from upow_tpu_torch.mine import engine as mine_engine, miner
from upow_tpu_torch.state import ChainState
from upow_tpu_torch.verify import BlockManager

KERNELS = ["p256_verify", "sha256_search"]
LANES = 8192
FAN, PER = 255, 32          # 8,160 leaf spends: one full block
GENESIS_PREV = (18_884_643).to_bytes(32, "little").hex()
SEARCH_BATCH = 1 << 24      # the miner's dispatch (config device.search_batch)
PENDING = 64                # txs the stub node holds for the miner
KEY_SEED = 0xACC7           # the chain's and the miner's key
SENTINEL = int(tsha.SENTINEL)
# charset size -> the fractional part of the difficulty that gives it
FRAC_OF_CHARSET = {charset_count(f"1.{d}"): f".{d}" for d in range(1, 10)}
# H100: 64 32-bit integer multiply(-add)s per SM per clock, and 64 32-bit
# integer adds, shifts and bitwise operations (CUDA C Programming Guide,
# arithmetic instruction throughput, compute capability 9.0).  Shifts and
# logic run on the ALU pipe alone; an add may also issue as IMAD on the
# FMA pipe, so integer work as a whole gets at most 128 a clock, which is
# also the issue rate of the SM's 4 schedulers of 32 threads.
IMUL_PER_SM_CLK = 64
INT_OPS_PER_SM_CLK = 64
INT_ISSUE_PER_SM_CLK = 128
HBM_BYTES_S = 3.35e12       # H100 SXM data sheet


# one SASS instruction in cuobjdump's listing: address, predicate, opcode
# (modifiers dropped), operands
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_]*)[A-Z0-9_.]*([^;]*);")


def phase(title: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase {title}: {body}", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# --- phase 3 inputs --------------------------------------------------------

def signature_mix(n: int, seed: int = 0x5A17):
    """(digests, sigs, pubs, kinds): a block's worth of signature lanes."""
    rng = random.Random(seed)
    keys = [curve.keygen(rng=rng.randrange(1, CURVE_N)) for _ in range(64)]
    G = curve.G
    neg = lambda P: (P[0], CURVE_P - P[1])  # noqa: E731
    digests, sigs, pubs, kinds = [], [], [], []

    def add(kind, digest, sig, pub):
        digests.append(digest)
        sigs.append(sig)
        pubs.append(pub)
        kinds.append(kind)

    crafted = [(3, 3, G), (7, 7, G), (3, 3, neg(G)),
               (0x10, 0x01, neg(curve.point_mul(16, G)))]
    for i in range(n):
        d, pub = keys[i % len(keys)]
        msg = i.to_bytes(4, "big") + b"chip smoke"
        digest = hashlib.sha256(msg).digest()
        sel = i % 32
        if sel < 22:
            add("valid", digest, curve.sign(msg, d), pub)
        elif sel < 25:
            r, s = curve.sign(msg, d)
            add("bad_s", digest, (r, (s + 1) % CURVE_N), pub)
        elif sel == 25:  # r + n < p: small r, s = 1 (digits chosen)
            add("r_plus_n", rng.randrange(1 << 200).to_bytes(32, "big"),
                (rng.randrange(1, 1 << 200), 1), pub)
        elif sel == 26:
            add("off_curve", digest, curve.sign(msg, d),
                (CURVE_GX, CURVE_GY + 1 + i))
        elif sel == 27:
            add("zero_pub", digest, curve.sign(msg, d), (0, 0))
        elif sel == 28:  # oversized digest: z reduced mod n on the host
            big = hashlib.sha512(msg).digest()
            z = int.from_bytes(big, "big") % CURVE_N
            k = rng.randrange(1, CURVE_N)
            r = curve.point_mul_G(k)[0] % CURVE_N
            s = pow(k, -1, CURVE_N) * (z + r * d) % CURVE_N
            add("big_digest", big, (r, s), pub)
        elif sel == 29:  # x + p (reduced on the card) or x + 2p (host)
            x = pub[0] + CURVE_P if pub[0] + CURVE_P < (1 << 256) \
                else pub[0] + 2 * CURVE_P
            add("big_coord", digest, curve.sign(msg, d), (x, pub[1]))
        else:
            z, r, Q = crafted[(i // 32) % len(crafted)]
            add("collision", z.to_bytes(32, "big"), (r, 1), Q)
    return digests, sigs, pubs, kinds


def cuda_ms(fn, reps: int, warm: int = 2, per: int = 1) -> float:
    """Median milliseconds of one ``fn`` over ``reps`` CUDA-event timings,
    each of ``per`` calls queued back to back (so that, for a kernel
    much longer than its launch, the host's launch time hides behind
    the card's work)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def kernel_phase(dev: torch.device) -> dict:
    t0 = time.perf_counter()
    digests, sigs, pubs, kinds = signature_mix(LANES)
    fused, zs, rs, ss, qxs, qys = p256._pack_device_inputs(
        digests, sigs, pubs, LANES)
    packed = p256.packed_tensor(fused, dev)
    setup_s = time.perf_counter() - t0

    got = p256.verify_packed(packed)
    torch.cuda.synchronize()
    plain = p256.verify_plain(packed)
    torch.cuda.synchronize()
    if got.shape != (LANES,) or got.dtype != torch.int32:
        fail(f"kernel output {tuple(got.shape)} {got.dtype}")
    max_abs_err = int((got.long() - plain.long()).abs().max())
    if not torch.equal(got, plain):
        bad = torch.nonzero(got != plain).flatten()[:8].tolist()
        fail(f"kernel != plain on {int((got != plain).sum())} lanes, "
             f"first {bad}")
    bits = got.cpu().numpy()
    exc = [i for i in range(LANES) if bits[i] & 2]
    expect_exc = {i for i, k in enumerate(kinds) if k == "collision"}
    if not expect_exc <= set(exc):
        fail("crafted collision lanes were not flagged")
    sample = sorted(set(random.Random(7).sample(range(LANES), 96))
                    | set(exc[:32]))
    for i in sample:
        if i in exc:
            continue  # the host oracle decides those lanes
        want = p256._host_verify_prehashed(zs[i], rs[i], ss[i], qxs[i], qys[i])
        if bool(bits[i] & 1) != want:
            fail(f"lane {i} ({kinds[i]}): kernel {bits[i] & 1}, host {want}")
    for i, kind in enumerate(kinds):
        want = {"valid": 1, "big_digest": 1, "big_coord": 1,
                "bad_s": 0, "off_curve": 0, "zero_pub": 0}.get(kind)
        if want is not None and (bits[i] & 1) != want:
            fail(f"lane {i} ({kind}): verdict {bits[i] & 1}")

    # the main path's launch shapes: a 1,024-check micro-batch plus the
    # two canaries (8 full blocks of 128 and a 2-lane edge), and a pass-2
    # retry of a single lane; both must equal the plain version's lanes
    shapes = {}
    for width in (1026, 1):
        part = packed[:, :width].contiguous()
        got_part = p256.verify_packed(part)
        if not torch.equal(got_part, plain[:width]):
            fail(f"kernel != plain at the {width}-lane launch shape")
        shapes[width] = part

    ms = cuda_ms(lambda: p256.verify_packed(packed), reps=30, warm=3)
    ms_1026 = cuda_ms(lambda: p256.verify_packed(shapes[1026]), reps=10)
    ms_1 = cuda_ms(lambda: p256.verify_packed(shapes[1]), reps=10)
    plain_ms = cuda_ms(lambda: p256.verify_plain(packed), reps=2, warm=0)

    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    # the least multiply operations these lanes need (crypto/p256.py
    # MUL_OPS): 36 wide products a squaring, none to reduce mod p
    ops = p256.mul_ops_needed(zs, rs, ss, qxs, qys)
    ops_ms = ops / (props.multi_processor_count * IMUL_PER_SM_CLK
                    * clock_mhz * 1e6) * 1e3
    nbytes = LANES * (p256.PACKED_ROWS * 4 + 4)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    phase("kernel_vs_plain", lanes=LANES, equal=True,
          exception_lanes=len(exc), sampled_vs_host=len(sample),
          ms=round(ms, 4), ms_1026_lanes=round(ms_1026, 4),
          ms_1_lane=round(ms_1, 4), plain_ms=round(plain_ms, 1),
          bound_ms=round(max(ops_ms, bytes_ms), 4),
          sms=props.multi_processor_count, clock_mhz=clock_mhz,
          int_mul_ops=ops, setup_s=round(setup_s, 1))
    return {"name": "p256_verify", "route": "cuda",
            "source": "upow_tpu_torch/csrc/p256_verify.cu",
            "replaces": "upow_tpu/crypto/p256.py:1016",
            "launches": 0, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


# --- phase 4: sha256 kernel vs plain ----------------------------------------

def brute(prefix: bytes, prev: str, diff: str, base: int, count: int,
          limit: int = 1 << 16):
    """The least hit by hashlib in [base, base + count), or None where the
    range is longer than ``limit`` and holds no hit within it."""
    for n in range(base, base + min(count, limit)):
        h = hashlib.sha256(prefix + n.to_bytes(4, "little")).hexdigest()
        if check_pow_hash(h, prev, diff):
            return n
    return SENTINEL if count <= limit else None


def sha_cases(rng: random.Random):
    """(name, prefix, previous hash, difficulty, base, count)."""
    def hexs(n):
        return bytes(rng.randrange(256) for _ in range(n)).hex()

    v2 = bytes.fromhex(hexs(104))
    v1 = bytes.fromhex(hexs(134))
    prev = hexs(32)
    cases = []
    for tag, prefix in (("v2", v2), ("v1", v1)):
        for diff in ("1", "2", "3", "4", "5", "1.1", "2.3", "3.9"):
            cases.append((f"{tag}_d{diff}", prefix, prev, diff,
                          rng.randrange(1 << 31), 1 << 20))
    cases.append(("miss_d12", v2, prev, "12", 0, 1 << 22))
    # dense: the previous hash ends in the first lane's leading hex
    # char, so hits are 1 in 16 and the minimum is the first lane
    base = rng.randrange(1 << 31)
    first = hashlib.sha256(v2 + base.to_bytes(4, "little")).hexdigest()
    cases.append(("dense_first_lane", v2, prev[:-1] + first[0], "1", base,
                  1 << 22))
    # the charset edge: the first lane matches the one-char prefix and its
    # next nibble EQUALS the charset size, so it is no hit
    base = rng.randrange(1 << 31)
    while True:
        h = hashlib.sha256(v2 + base.to_bytes(4, "little")).hexdigest()
        if int(h[1], 16) in FRAC_OF_CHARSET:
            break
        base += 1
    cases.append(("charset_edge", v2, prev[:-1] + h[0],
                  "1" + FRAC_OF_CHARSET[int(h[1], 16)], base, 1 << 22))
    for count in (1, 127, (1 << 24) - 1):
        cases.append((f"ragged_{count}", v1, prev, "5",
                      rng.randrange(1 << 31), count))
    for diff, count in (("3", (1 << 22) + 3), ("1.3", 1000)):
        cases.append((f"ends_at_2^32-1_d{diff}", v2, prev, diff,
                      (1 << 32) - 1 - count, count))
    return cases


def sha_phase(dev: torch.device, addr: str) -> dict:
    rng = random.Random(0x5EA)
    worst, checked, hits = 0, 0, 0
    cases = sha_cases(rng)
    for name, prefix, prev, diff, base, count in cases:
        template = tsha.make_template(prefix)
        target = tsha.pack_target(tsha.target_spec(prev, diff))
        got = int(tsha.pow_search(template, target, base, count, device=dev))
        plain = int(tsha.pow_search_plain(template, target, base, count, dev))
        worst = max(worst, abs(got - plain))
        if got != plain:
            fail(f"sha256 {name}: kernel {got}, plain {plain}")
        want = brute(prefix, prev, diff, base, count)
        if want is not None:
            checked += 1
            if want != got:
                fail(f"sha256 {name}: kernel {got}, hashlib {want}")
        if name.startswith("miss") and got != SENTINEL:
            fail(f"sha256 {name}: a hit at {got}, expected none")
        if name.startswith("dense") and got != base:
            fail(f"sha256 {name}: {got}, expected the first lane {base}")
        if name == "charset_edge" and got == base:
            fail(f"sha256 {name}: the first lane {base} reported as a hit")
        hits += got != SENTINEL

    # the miner's dispatch shape: 16 consecutive 2^24-nonce rounds of one
    # v2 template at difficulty 5
    job = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(5).randbytes(32).hex(),
        address=addr, merkle_root=hashlib.sha256(b"").hexdigest(),
        timestamp=1_760_000_000, difficulty="5")
    template = tsha.make_template(job.prefix)
    target = tsha.pack_target(tsha.target_spec(job.previous_hash, "5"))
    rounds = []
    for r in range(16):
        base = r * SEARCH_BATCH
        got = int(tsha.pow_search(template, target, base, SEARCH_BATCH,
                                  device=dev))
        plain = int(tsha.pow_search_plain(template, target, base,
                                          SEARCH_BATCH, dev))
        if got != plain:
            fail(f"sha256 round {r}: kernel {got}, plain {plain}")
        if got != SENTINEL and not job.check(got):
            fail(f"sha256 round {r}: {got} fails the hashlib check")
        rounds.append(got)

    # time one 2^24 dispatch of the sweep's template (difficulty 10: no
    # hit, so every nonce is needed)
    sweep = sweep_job(addr)
    template = tsha.make_template(sweep.prefix)
    target = tsha.pack_target(tsha.target_spec(sweep.previous_hash,
                                               sweep.difficulty))
    if int(tsha.pow_search(template, target, 0, SEARCH_BATCH, device=dev)) \
            != SENTINEL:
        fail("the sweep template hit in its first round; pick another seed")
    ms = cuda_ms(lambda: tsha.pow_search(template, target, 0, SEARCH_BATCH,
                                         device=dev), reps=10, warm=3, per=10)
    plain_ms = cuda_ms(lambda: tsha.pow_search_plain(
        template, target, 0, SEARCH_BATCH, dev), reps=3, warm=1)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = tdevice.max_sm_clock_mhz() or props.clock_rate / 1000
    alu, add = tsha.ops_per_nonce(template, target)
    clocks = max(alu / INT_OPS_PER_SM_CLK, (alu + add) / INT_ISSUE_PER_SM_CLK)
    ops_ms = clocks * SEARCH_BATCH / (props.multi_processor_count
                                      * clock_mhz * 1e6) * 1e3
    bytes_ms = (tsha.ARG_WORDS * 4 + 8) / HBM_BYTES_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    phase("sha256_kernel_vs_plain", cases=len(cases),
          equal=True, hashlib_checked=checked, hits=hits,
          rounds_2e24=len(rounds), round_hits=sum(h != SENTINEL for h in rounds),
          ms=round(ms, 4), mh_s=round(SEARCH_BATCH / ms / 1e3, 1),
          plain_ms=round(plain_ms, 1), bound_ms=round(max(ops_ms, bytes_ms), 4),
          bound_share=round(max(ops_ms, bytes_ms) / ms, 4), bound_by=bound_by,
          alu_ops_per_nonce=alu, add_ops_per_nonce=add,
          sms=props.multi_processor_count, clock_mhz=clock_mhz)
    return {"name": "sha256_search", "route": "cuda",
            "source": "upow_tpu_torch/csrc/sha256_search.cu",
            "replaces": "upow_tpu/crypto/sha256.py:344",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": bound_by, "library_ms": None}


def sweep_job(addr: str) -> "mine_engine.MiningJob":
    """The hash-rate template: difficulty 10 (one hit in about 1.1e12
    nonces, so a sweep of 2^32 - 1 almost surely finds none)."""
    return mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(10).randbytes(32).hex(), address=addr,
        merkle_root=hashlib.sha256(b"sweep").hexdigest(),
        timestamp=1_760_000_000, difficulty="10")


# --- phases 5 and 6: the accept path and the miner's path -----------------

async def main_path(dev: torch.device, key: tuple, fan: int = FAN,
                    per: int = PER) -> tuple:
    """(the accept's record, the miner run's record)."""
    clock.freeze(int(time.time()) - 3600)
    state = ChainState()
    manager = BlockManager(state, device=dev)
    d, pub = key
    addr = point_to_string(pub)
    pub_of = lambda _i: pub  # noqa: E731
    mined = []  # MineResult of every header mined below

    async def header(txs) -> str:
        """A header on the current tip, its nonce found by the port's
        miner on the card at the chain's own difficulty."""
        diff, last = await manager.calculate_difficulty()
        prev = last["hash"] if last else GENESIS_PREV
        job = mine_engine.MiningJob.from_header_fields(
            previous_hash=prev, address=addr, merkle_root=merkle_root(txs),
            timestamp=clock.timestamp(), difficulty=diff)
        if not last:
            return job.block_content(0)  # genesis: no PoW
        res = mine_engine.mine(job, "cuda", batch=SEARCH_BATCH)
        if res.nonce is None:
            fail(f"no nonce found at difficulty {diff}")
        mined.append(res)
        return job.block_content(res.nonce)

    async def submit(txs, content=None):
        """(accepted, errors, seconds in create_block alone)."""
        if content is None:
            clock.advance(60)
            content = await header(txs)
        errors = []
        t0 = time.perf_counter()
        ok = await manager.create_block(content, txs, errors=errors)
        return ok, errors, time.perf_counter() - t0

    def spend(outpoints, outs):
        return Tx([TxInput(h, i) for h, i in outpoints], outs).sign([d], pub_of)

    t0 = time.perf_counter()
    ok, errors, _ = await submit([])
    if not ok:
        fail(f"genesis rejected: {errors}")
    coin = (await state.get_spendable_outputs(addr))[0]
    each = coin.amount // fan
    fan_tx = spend([(coin.tx_hash, coin.index)],
                   [TxOutput(addr, each)] * (fan - 1)
                   + [TxOutput(addr, coin.amount - each * (fan - 1))])
    ok, errors, _ = await submit([fan_tx])
    if not ok:
        fail(f"fan-out block rejected: {errors}")
    mids = []
    for j in range(fan):
        amt = fan_tx.outputs[j].amount
        sub = amt // per
        mids.append(spend([(fan_tx.hash(), j)],
                          [TxOutput(addr, sub)] * (per - 1)
                          + [TxOutput(addr, amt - sub * (per - 1))]))
    ok, errors, _ = await submit(mids)
    if not ok:
        fail(f"mid block rejected: {errors}")
    leaves = [spend([(m.hash(), k)], [TxOutput(addr, o.amount)])
              for m in mids for k, o in enumerate(m.outputs)]
    setup_s = time.perf_counter() - t0
    pre_hash = await state.get_unspent_outputs_hash()
    clock.advance(60)
    content = await header(leaves)  # mined before the measured accept
    chain_difficulty = (await manager.calculate_difficulty())[0]

    # the measured accept: cold verdict cache, counts from zero
    from upow_tpu_torch.verify import txverify

    txverify.clear_sig_verdicts()
    trace.reset()
    p256.reset_counts()
    prof = start_profiler()
    ok, errors, accept_s = await submit(leaves, content)
    launches, exc_lanes = p256.LAUNCHES, p256.EXCEPTION_LANES
    device = device_busy(prof, "p256_verify_kernel")
    breakdown = accept_breakdown(trace.snapshot())
    if not ok:
        fail(f"{len(leaves)}-tx block rejected: {errors}")
    if launches == 0:
        fail("the accept path never launched the kernel")
    if exc_lanes != 0:
        fail(f"{exc_lanes} exception lanes on honest signatures")
    post_hash = await state.get_unspent_outputs_hash()
    tip = await state.get_last_block()
    if post_hash == pre_hash or tip["id"] != 4:
        fail("the accepted block did not move the chain")
    spendable = await state.get_spendable_outputs(addr)
    if len(spendable) != len(leaves) + 3:  # + coinbases of blocks 2-4
        fail(f"{len(spendable)} spendable outputs after accept")

    # tampered candidates on the new tip must be rejected
    new_outs = [(t.hash(), 0, t.outputs[0].amount) for t in leaves[:1024]]
    cand = [spend([(h, i)], [TxOutput(addr, a)]) for h, i, a in new_outs]
    bad = cand[len(cand) // 2]
    r, s = bad.inputs[0].signature
    bad.inputs[0].signature = (r, (s + 1) % CURVE_N)
    bad._hex_cache.pop(True, None)
    bad._hash = None
    ok_bad, err_bad, _ = await submit(cand)
    twin = spend([new_outs[0][:2]], [TxOutput(addr, 1)])
    ok_dbl, err_dbl, _ = await submit(cand[:len(cand) // 2] + [twin])
    if ok_bad or err_bad != ["signature verification failed"]:
        fail(f"corrupted-signature block: {ok_bad} {err_bad}")
    if ok_dbl or err_dbl != ["double spend in block: 5 (unspent_outputs)"]:
        fail(f"double-spend block: {ok_dbl} {err_dbl}")
    if await state.get_unspent_outputs_hash() != post_hash:
        fail("a rejected block changed the UTXO set")
    accept = {"txs": len(leaves), "accept_s": accept_s,
              "launches": launches, "exception_lanes": exc_lanes,
              "setup_s": setup_s, "rejected": [err_bad[0], err_dbl[0]],
              "breakdown": breakdown, "device": device,
              "difficulty": chain_difficulty, "mined": mined}

    # the miner's path: the CLI's run() against a stub node over this
    # chain, holding valid spends of the new outputs as its mempool
    good = [t for t in cand if t is not bad][:PENDING]
    pending = {t.hash(): t for t in good}
    node = StubNode(asyncio.get_running_loop(), manager, pending)
    clock.advance(60)
    tsha.reset_counts()
    t0 = time.perf_counter()
    rc = await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(miner.run, addr, node.url, "cuda",
                                SEARCH_BATCH, 90.0, once=True))
    run_s = time.perf_counter() - t0
    sha_launches = tsha.LAUNCHES
    node.close()
    tip = await state.get_last_block()
    if rc != 0 or len(node.accepted) != 1 or tip["id"] != 5:
        fail(f"miner.run: rc {rc}, pushes {node.replies}, tip {tip['id']}")
    if sha_launches == 0:
        fail("the miner's path never launched the sha256 kernel")
    if await state.get_unspent_outputs_hash() == post_hash:
        fail("the mined block did not move the UTXO set")
    state.close()
    clock.reset()
    return accept, {"run_s": run_s, "launches": sha_launches,
                    "txs": len(node.accepted[0]), "tip": tip["id"],
                    "difficulty": float(tip["difficulty"])}


class StubNode:
    """The two routes a miner calls, over the chain of the running accept
    path: ``get_mining_info`` in the node's wire shape (difficulty and
    last block from ``BlockManager.calculate_difficulty``, the held
    pending txs sorted by hex, their hashes) and ``push_block`` into
    ``BlockManager.create_block``.  A stdlib HTTP server on its own
    thread hands each request to the chain's event loop, which owns the
    sqlite connection.  Scaffolding for this script, not a node."""

    def __init__(self, loop, manager: BlockManager, pending: dict):
        self.loop, self.manager, self.pending = loop, manager, pending
        self.accepted, self.replies = [], []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):
                pass

            def _reply(self, coro):
                body = asyncio.run_coroutine_threadsafe(
                    coro, stub.loop).result(120)
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._reply(stub.mining_info())

            def do_POST(self):
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                self._reply(stub.push_block(json.loads(raw)))

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    async def mining_info(self) -> dict:
        diff, last = await self.manager.calculate_difficulty()
        last = dict(last, difficulty=float(last["difficulty"]))
        pending = sorted(t.hex() for t in self.pending.values())
        return {"ok": True, "result": {
            "difficulty": float(diff), "last_block": last,
            "pending_transactions": pending[:10],
            "pending_transactions_hashes": [
                hashlib.sha256(bytes.fromhex(t)).hexdigest()
                for t in pending]}}

    async def push_block(self, body: dict) -> dict:
        txs = [self.pending[h] for h in body["txs"]]
        errors = []
        ok = await self.manager.create_block(body["block_content"], txs,
                                             errors=errors)
        if ok:
            self.accepted.append(txs)
        self.replies.append({"ok": ok, "errors": errors})
        return self.replies[-1]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


# --- phase 7: the hash rate ---------------------------------------------------

def hashrate_phase(key: tuple) -> dict:
    addr = point_to_string(key[1])
    job = sweep_job(addr)
    tsha.reset_counts()
    prof = start_profiler()
    t0 = time.perf_counter()
    res = mine_engine.mine(job, "cuda", batch=SEARCH_BATCH, ttl=600.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tsha.LAUNCHES
    device = device_busy(prof, "sha256_search_kernel")
    full = mine_engine.MAX_SEARCH_END
    if res.nonce is None and res.hashes_tried != full:
        fail(f"the sweep tried {res.hashes_tried} of {full} nonces")
    # BASELINE config 2: a fractional difficulty mined to a checked hit
    job63 = mine_engine.MiningJob.from_header_fields(
        previous_hash=random.Random(63).randbytes(32).hex(), address=addr,
        merkle_root=hashlib.sha256(b"6.3").hexdigest(),
        timestamp=1_760_000_000, difficulty="6.3")
    t1 = time.perf_counter()
    res63 = mine_engine.mine(job63, "cuda", batch=SEARCH_BATCH)
    s63 = time.perf_counter() - t1
    if res63.nonce is None or not job63.check(res63.nonce):
        fail(f"difficulty 6.3: {res63}")
    return {"tried": res.hashes_tried, "seconds": seconds,
            "hit": res.nonce, "launches": launches, "device": device,
            "nonce_6_3": res63.nonce, "tried_6_3": res63.hashes_tried,
            "seconds_6_3": s63}


def start_profiler():
    """A CUDA-activity-only ``torch.profiler`` session, or None where the
    machine's profiler cannot start (then the idle share is reported as
    not measured; the accept itself runs either way)."""
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        return prof
    except Exception as e:  # noqa: BLE001  (measurement only)
        print(f"  profiler did not start: {e}", flush=True)
        return None


def device_busy(prof, kernel_name: str) -> dict:
    """Seconds the card was busy (the union of every device activity's
    interval: kernels and copies) and in the named kernel, from a
    session started by :func:`start_profiler`."""
    if prof is None:
        return {}
    torch.cuda.synchronize()
    try:
        prof.__exit__(None, None, None)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001  (measurement only)
        print(f"  profiler did not stop cleanly: {e}", flush=True)
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernel = [e for e in events if kernel_name in e.name]
    return {"events": len(events), "busy_s": busy_us / 1e6,
            "kernel_events": len(kernel),
            "kernel_s": sum(e.time_range.elapsed_us() for e in kernel) / 1e6}


def accept_breakdown(snap: dict) -> dict:
    """Seconds by stage of one block accept, from the port's trace."""
    spans, obs = snap["spans"], snap["observations"]
    out = {name: round(spans[name]["seconds"], 4) for name in (
        "block_accept", "block.header_check", "block.sig_verify",
        "block.utxo_apply") if name in spans}
    for stage in ("block_decode", "block_sig_wait"):
        out[stage] = round(sum(obs.get(f"pipeline.{stage}.seconds", [])), 4)
    calls = obs.get("kernel.p256_verify.dispatch_seconds", [])
    out["verify_calls"] = len(calls)
    out["verify_call_s"] = round(sum(calls), 4)
    return out


def device_phase(title: str, dev_use: dict, wall_s: float) -> None:
    if dev_use.get("events"):
        phase(title, events=dev_use["events"],
              busy_s=round(dev_use["busy_s"], 4),
              kernel_events=dev_use["kernel_events"],
              kernel_s=round(dev_use["kernel_s"], 4),
              idle_share=round(1 - dev_use["busy_s"] / wall_s, 4))
    else:
        phase(title, idle_share="not_measured")


def sass_counts(name: str) -> tuple:
    """(instructions in the kernel, opcode counts inside its loop) from
    cuobjdump's SASS of the built library, NOPs left out.  The loop is
    the longest backward branch's span: one nonce a trip in the search
    kernel.  (0, {}) where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return 0, {}
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    code = [(int(a, 16), op, args) for a, op, args in SASS_LINE.findall(sass)
            if op != "NOP"]
    lo, hi = 0, -1
    for addr, op, args in code:
        target = re.findall(r"0x[0-9a-f]+", args) if op == "BRA" else []
        if target and int(target[-1], 16) < addr \
                and addr - int(target[-1], 16) > hi - lo:
            lo, hi = int(target[-1], 16), addr
    loop = collections.Counter(op for a, op, _ in code if lo <= a <= hi)
    return len(code), loop


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = tdevice.card_line()
    if not card:
        fail("nvidia-smi did not report the card")
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    phase("card", name=json.dumps(name), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = _build.build_all(KERNELS, force=True)
    phase("build", seconds=round(time.perf_counter() - t0, 1),
          **{k: round(v, 1) for k, v in built.items()})
    for k in KERNELS:
        for line in _build.ptxas_report(k).splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"  ptxas {k}: {line.strip()}", flush=True)
    total, loop = sass_counts("sha256_search")
    print(f"  sass sha256_search: instructions={total or 'not_measured'} "
          f"loop={sum(loop.values())} "
          + " ".join(f"{op}={n}" for op, n in loop.most_common(12)),
          flush=True)

    record = kernel_phase(dev)
    key = curve.keygen(rng=KEY_SEED)
    sha_record = sha_phase(dev, point_to_string(key[1]))

    res, mined = asyncio.run(main_path(dev, key))
    record["launches"] = res["launches"]
    sha_record["launches"] = mined["launches"]
    blocks = res["mined"]
    phase("chain_mining", blocks=len(blocks), difficulty=res["difficulty"],
          start_difficulty=START_DIFFICULTY,
          hashes=sum(b.hashes_tried for b in blocks),
          seconds=round(sum(b.elapsed for b in blocks), 3))
    phase("main_path", txs=res["txs"], accept_s=round(res["accept_s"], 3),
          tx_per_s=round(res["txs"] / res["accept_s"], 1),
          launches=res["launches"], exception_lanes=res["exception_lanes"],
          chain_setup_s=round(res["setup_s"], 1),
          rejected=json.dumps(res["rejected"]), card=json.dumps(card))
    phase("accept_breakdown", **res["breakdown"])
    device_phase("device_profile", res["device"], res["accept_s"])
    phase("miner_run", accepted=True, tip=mined["tip"], txs=mined["txs"],
          difficulty=mined["difficulty"], launches=mined["launches"],
          seconds=round(mined["run_s"], 3))

    rate = hashrate_phase(key)
    phase("hashrate", hashes=rate["tried"], seconds=round(rate["seconds"], 4),
          mh_s=round(rate["tried"] / rate["seconds"] / 1e6, 1),
          launches=rate["launches"], hit=rate["hit"], card=json.dumps(card),
          torch=torch.__version__, cuda=torch.version.cuda)
    device_phase("hashrate_device_profile", rate["device"], rate["seconds"])
    phase("difficulty_6_3", nonce=rate["nonce_6_3"], hashlib_checked=True,
          hashes=rate["tried_6_3"], seconds=round(rate["seconds_6_3"], 4))

    print(json.dumps({"kernels": [record, sha_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
