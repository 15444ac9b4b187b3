"""Transaction verification: DPoS rules on host, signatures batched on the card.

The port of the JAX package's ``verify/txverify.py``.  The rule checks
stay host-side (they are state lookups, not compute); signature checks
are collected per transaction or per block and verified in one call to
the batched P-256 kernel (:mod:`..crypto.p256`).

Signature semantics are replicated exactly, including the reference's
quirk of accepting a signature over EITHER the raw signing bytes OR
their ASCII-hex string (transaction_input.py:100-109 tries both), and
the per-tx dedup keyed on the signature alone (transaction.py:148-163).

Device health is the JAX package's: one process-wide
:class:`..resilience.degrade.DegradeManager` (:data:`DEGRADE`).  Each
device batch is a boxed call through the device runtime
(``device/runtime.py``, source ``verify``, kernel ``p256_verify``),
under ``device_timeout``, with the ``device.verify`` fault site fired
inside the box.  A raised error is recorded (``failure_limit`` in a row
degrade the path); a hang poisons the path for the process.

Where the JAX package differs from this module, by design:

* the host path is the port's native C++ batch
  (:func:`..native.p256_verify_batch`); the pure-Python oracle runs only
  where the native library cannot be built;
* the host serves a failed, degraded or poisoned device batch only where
  the device is the CPU (:func:`host_may_serve`; there the device path
  is the plain PyTorch version).  On a card the failure is recorded on
  :data:`DEGRADE` and raised, and a dispatch the degrade blocks raises
  :class:`..resilience.degrade.DeviceBlocked`: the caller sees the error
  (the node's 500 envelope), never a verdict from the host;
* a runtime that failed to arm its card raises
  (:class:`..device.runtime.ArmError`);
* the ``auto`` policy sends batches of 8 checks or more to the port's
  device, which is the kernel on a CUDA device and the plain PyTorch
  version on ``device="cpu"``, while the degrade allows it; smaller
  batches take the host path.  ``pad_block`` only splits the coalescing
  keys: the port's kernels take any lane count.

``mesh_devices`` shards a device batch's lanes over a mesh of cards as
the JAX package does (:func:`_verify_mesh`; ``parallel/mesh.py``).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .. import trace
from ..core import curve
from ..core.codecs import OutputType, TransactionType, string_to_point
from ..core.constants import CURVE_N, MAX_INODES, SMALLEST
from ..core.tx import Tx
from ..device import DeviceLike
from ..device.runtime import ArmError, get_runtime, runtime_key
from ..resilience.degrade import POISONED, DegradeManager, DeviceBlocked
from ..resilience.faultinject import get_injector
from ..state.storage import ChainState, _INPUT_TABLE
from ..telemetry.device import DISPATCH_BUCKETS

log = logging.getLogger("upow_tpu_torch.verify")

# The one grandfathered unstake tx exempt from the release-votes rule
# (reference transaction.py:471-472).
_UNSTAKE_EXCEPTION_HASHES = {
    "8befeb253bc6eddd8501f5b27a02b195f5c06a51ccf788213cbedafe7cc49c53",
}

# Checks below this many stay on the host under the auto policy: a
# device call costs more than a few host verifies.
HOST_BELOW = 8

# The device path's health: ok / degraded with a cooldown re-probe /
# poisoned.  The node pushes its failure_limit and cooldown in through
# DEGRADE.configure() at startup.
DEGRADE = DegradeManager()


def _device_usable(device: DeviceLike = None) -> bool:
    """The device path is not poisoned and ``device``'s runtime armed
    (its platform is known; a failed arm raises ArmError here)."""
    if DEGRADE.state == POISONED:
        return False
    return get_runtime(device).platform() is not None


def host_may_serve(device: DeviceLike = None) -> bool:
    """May the host serve what ``device``'s verify path failed or was
    blocked from doing?  Only where the device is the CPU: on a card a
    failure is raised, never answered from the host."""
    return runtime_key(device) == "cpu"


def device_verify_allowed(device: DeviceLike = None) -> bool:
    """The gate of the verify path's device dispatches (signature batches
    through :func:`_resolve_backend`, and the fused accept scan's digest
    batch): True when the device is usable AND the degrade state lets a
    dispatch through.  When it does not, False on the CPU (the host
    serves) and :class:`DeviceBlocked` on a card."""
    if _device_usable(device) and DEGRADE.allow():
        return True
    _blocked(device)
    return False


def _blocked(device: DeviceLike) -> None:
    """A device dispatch the degrade refused: the host serves it on the
    CPU; on a card it raises :class:`DeviceBlocked`."""
    if host_may_serve(device):
        return
    snap = DEGRADE.snapshot()
    raise DeviceBlocked(f"device verify path on {runtime_key(device)} is "
                        f"{snap['state']} after {snap['last_error']}")


def _dedup_sig_checks(tx: Tx, voter: bool, address_of,
                      digests: Optional[tuple] = None) -> Optional[List[tuple]]:
    """Collect per-input signature checks with the reference's dedup.

    Returns None if any input is unsigned or its key can't resolve.
    ``address_of(tx_input)`` -> spending (or voter) address string.
    ``digests`` optionally carries the (digest, digest_hexform) pair a
    fused batch prep (verify/block.py:_fused_digest_prep) already
    computed, skipping the two per-tx hashlib passes here.
    """
    if digests is not None:
        digest, digest_hexform = digests
    else:
        signing_bytes = bytes.fromhex(tx.hex(False))
        digest = hashlib.sha256(signing_bytes).digest()
        digest_hexform = hashlib.sha256(tx.hex(False).encode()).digest()
    checks, seen = [], set()
    for tx_input in tx.inputs:
        if tx_input.signature is None:
            return None
        address = address_of(tx_input)
        if address is None:
            return None
        try:
            pub = string_to_point(address)
        except (ValueError, NotImplementedError):
            return None
        # Consensus-exact dedup: the reference keys on
        # (tx_input.public_key, signature) but from_hex never sets
        # public_key (transaction.py:148-163, 520-592), so its runtime key
        # degenerates to the signature value ALONE — a later input reusing
        # an earlier input's (r, s) is skipped even under a different
        # address.  Replicate that exactly; hardening here would fork.
        key = tx_input.signature
        if key in seen:
            continue
        seen.add(key)
        checks.append((digest, digest_hexform, tx_input.signature, pub))
    return checks


async def run_sig_checks_async(checks: Sequence[tuple],
                               backend: str = "auto",
                               device: DeviceLike = None,
                               pad_block: int = 128,
                               device_timeout: float = 240.0,
                               precomputed: Optional[dict] = None,
                               mesh_devices: int = 1) -> List[bool]:
    """Executor-wrapped :func:`run_sig_checks`: the verify (and its wait
    on the card) must not block the event loop."""
    return await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(run_sig_checks, checks, backend=backend,
                                device=device, pad_block=pad_block,
                                device_timeout=device_timeout,
                                precomputed=precomputed,
                                mesh_devices=mesh_devices))


_VERIFY_MESH: dict = {}  # (mesh_devices, device) -> mesh | None
_VERIFY_MESH_LOCK = threading.Lock()  # intake and block verify race this
# cache from different executor threads


def _verify_mesh(mesh_devices, device: DeviceLike = None):
    """The mesh a device verify is sharded over (the JAX package's
    ``_verify_mesh``): 1 = no mesh, 0 = every visible card, N = the first
    N (``parallel.mesh.plan_devices``; on ``device="cpu"``, N shards of
    the plain version on the host), or an explicit mesh (a
    ``parallel.mesh.make_mesh`` tuple, whose devices may repeat) as
    given.  A mesh of one device is None: a one-card host keeps the
    unsharded launch.  The complete kernel has no sharded path and keeps
    the unsharded dispatch too.  Built once a process for each
    (mesh_devices, device)."""
    if mesh_devices == 1:
        return None
    from ..crypto import p256

    if p256.VERIFY_KERNEL == "complete":
        return None
    if isinstance(mesh_devices, tuple):
        return mesh_devices if len(mesh_devices) > 1 else None
    key = (mesh_devices, str(device))
    with _VERIFY_MESH_LOCK:
        if key not in _VERIFY_MESH:
            from ..parallel.mesh import make_mesh, plan_devices

            devices = plan_devices(mesh_devices, device)
            _VERIFY_MESH[key] = make_mesh(devices) if len(devices) > 1 \
                else None
        return _VERIFY_MESH[key]


_SIG_VERDICTS: "OrderedDict[tuple, bool]" = OrderedDict()
_SIG_VERDICTS_MAX = 1 << 16
_SIG_VERDICTS_LOCK = threading.Lock()  # block verifies of two event
# loops run on different executor threads; OrderedDict mutation is not
# atomic


_SIG_VERDICT_STATS = {"hits": 0, "misses": 0}


def sig_verdict_stats() -> dict:
    """Cache size + hit/miss counters (the node's /metrics)."""
    with _SIG_VERDICTS_LOCK:
        return {"size": len(_SIG_VERDICTS), **_SIG_VERDICT_STATS}


def clear_sig_verdicts() -> None:
    """Drop the process-level signature-verdict cache (tests)."""
    with _SIG_VERDICTS_LOCK:
        _SIG_VERDICTS.clear()
        _SIG_VERDICT_STATS["hits"] = _SIG_VERDICT_STATS["misses"] = 0


_CANARY_LOCK = threading.Lock()
_CANARY: Optional[Tuple[tuple, tuple]] = None
_CANARY_EXPECTED = (True, False)


def _canary_checks() -> Tuple[tuple, tuple]:
    """Deterministic (known-good, known-bad) signature checks.

    Appended to every device-path cache-miss dispatch; the device's
    verdicts are admitted into the process-wide cache only when the
    canaries come back exactly ``(True, False)``.  A device batch that
    silently miscomputes then taints at most the one dispatch it belongs
    to instead of being replayed from the cache on every re-accept.  The
    key pair is fixed and public BY DESIGN — it signs nothing but this
    self-check message and guards no value.  (Same pair, same message as
    the JAX package, so both packages' canaries are the same checks.)
    """
    global _CANARY
    with _CANARY_LOCK:
        if _CANARY is None:
            priv = 0x7E57AB1E_0000C0DE_7E57AB1E_0000C0DE % CURVE_N
            k = 0x9E3779B97F4A7C15_F39CC060_5CEDC834 % CURVE_N
            pub = curve.point_mul(priv, curve.G)
            digest = hashlib.sha256(b"upow-tpu verify canary").digest()
            hexform = hashlib.sha256(b"upow-tpu verify canary hex").digest()
            z = int.from_bytes(digest, "big")  # upowlint: disable=CE001
            r = curve.point_mul(k, curve.G)[0] % CURVE_N
            s = (pow(k, -1, CURVE_N) * (z + r * priv)) % CURVE_N
            good = (digest, hexform, (r, s), pub)
            bad = (digest, hexform, (r, s - 1 if s > 1 else s + 1), pub)
            _CANARY = (good, bad)
        return _CANARY


def _resolve_backend(backend: str, n_checks: int,
                     device: DeviceLike = None) -> str:
    """The ``auto`` policy and the device-health override (one rule for
    the cached and uncached layers): ``auto`` verifies fewer than
    :data:`HOST_BELOW` checks on the host, the rest on the device while
    :func:`device_verify_allowed`; an explicit device backend also
    honours the degrade state (``"tpu"``, the JAX package's name in a
    shared config file, means the device).  On a card a blocked device
    batch raises :class:`DeviceBlocked`."""
    if backend == "auto":
        if n_checks < HOST_BELOW:
            return "host"
        return "device" if device_verify_allowed(device) else "host"
    if backend == "tpu":  # the JAX package's name for its device
        backend = "device"
    if backend not in ("host", "device"):
        raise ValueError(f"unknown signature backend {backend!r}")
    if backend == "device" and not DEGRADE.allow():
        # a degraded device is retried only after its cooldown
        _blocked(device)
        return "host"
    return backend


def run_sig_checks(checks: Sequence[tuple], backend: str = "auto",
                   device: DeviceLike = None,
                   use_cache: bool = True,
                   precomputed: Optional[dict] = None,
                   mesh_devices: int = 1,
                   pad_block: int = 128,
                   device_timeout: float = 240.0) -> List[bool]:
    """Verify deferred checks in one (or two) batched calls.

    Pass 1 verifies against the raw-bytes digest; only failures re-try the
    hex-string digest (the reference's or-fallback).  ``backend='host'``
    uses the native C++ batch; ``'device'`` the batched verify on
    ``device`` (the card unless ``device="cpu"``), a boxed call of at
    most ``device_timeout`` seconds through the device runtime.  A
    device batch that raises is recorded on :data:`DEGRADE`; one that
    hangs poisons the device path.  Either is raised on a card and
    served on the host on the CPU (:func:`host_may_serve`).

    Verdicts are memoized process-wide (bounded LRU) keyed on the full
    (digest, hexdigest, signature, pubkey) tuple: ECDSA verification is
    pure, so reorgs and sync re-accepts hit the same cache.  Host-path
    verdicts are always cached; device-path verdicts only when the
    batch's canary pair (:func:`_canary_checks`, riding in the same
    dispatch) comes back exactly (True, False).

    ``precomputed`` maps checks to verdicts of a chain-sync page's one
    batched dispatch: the checks it holds are answered from it, the rest
    verify as above.  It lives only for that page's accept loop, so it
    carries exactly the trust of the per-block dispatch it replaces.

    ``mesh_devices`` shards each device batch (:func:`_verify_mesh`).
    """
    if not checks:
        return []
    if precomputed:
        out_pre: List[Optional[bool]] = [precomputed.get(c) for c in checks]
        rest_idx = [i for i, v in enumerate(out_pre) if v is None]
        if rest_idx:
            rest = run_sig_checks([checks[i] for i in rest_idx],
                                  backend=backend, device=device,
                                  use_cache=use_cache,
                                  mesh_devices=mesh_devices,
                                  pad_block=pad_block,
                                  device_timeout=device_timeout)
            for i, v in zip(rest_idx, rest):
                out_pre[i] = v
        return out_pre  # type: ignore[return-value]
    if use_cache:
        out: List[Optional[bool]] = [None] * len(checks)
        misses = []
        with _SIG_VERDICTS_LOCK:
            for i, c in enumerate(checks):
                v = _SIG_VERDICTS.get(c)
                if v is None:
                    misses.append(i)
                else:
                    _SIG_VERDICTS.move_to_end(c)
                    out[i] = v
            _SIG_VERDICT_STATS["hits"] += len(checks) - len(misses)
            _SIG_VERDICT_STATS["misses"] += len(misses)
        if misses:
            miss_checks = [checks[i] for i in misses]
            resolved = _resolve_backend(backend, len(miss_checks), device)
            dispatch_checks = miss_checks
            canaries = 0
            if resolved != "host":
                # ride the canary pair along in the same device batch;
                # their verdicts gate whether this batch may be cached
                canary = _canary_checks()
                dispatch_checks = miss_checks + list(canary)
                canaries = len(canary)
            fresh = run_sig_checks(dispatch_checks, backend=resolved,
                                   device=device, use_cache=False,
                                   mesh_devices=mesh_devices,
                                   pad_block=pad_block,
                                   device_timeout=device_timeout)
            cacheable = resolved == "host"
            if canaries:
                canary_ok = tuple(fresh[-canaries:]) == _CANARY_EXPECTED
                fresh = fresh[: len(miss_checks)]
                trace.inc("verify.canary_%s"
                          % ("pass" if canary_ok else "fail"))
                if canary_ok:
                    cacheable = True
                else:
                    log.warning("device verify canary failed; %d verdicts "
                                "NOT cached", len(miss_checks))
            for i, v in zip(misses, fresh):
                out[i] = v
            if cacheable:
                with _SIG_VERDICTS_LOCK:
                    for i, v in zip(misses, fresh):
                        _SIG_VERDICTS[checks[i]] = v
                    while len(_SIG_VERDICTS) > _SIG_VERDICTS_MAX:
                        _SIG_VERDICTS.popitem(last=False)
        return out  # type: ignore[return-value]

    if _resolve_backend(backend, len(checks), device) == "host":
        return _two_pass(checks, _host_batch)
    verify = functools.partial(
        _device_batch, device=device, mesh=_verify_mesh(mesh_devices, device),
        device_timeout=device_timeout)
    try:
        first = verify([c[0] for c in checks], [c[2] for c in checks],
                       [c[3] for c in checks])
    except Exception as e:
        if not _host_serves_failure(e, device, "pass 1", len(checks)):
            raise
        return _two_pass(checks, _host_batch)
    out = list(first)
    retry = [i for i, ok in enumerate(out) if not ok]
    if retry:
        args = ([checks[i][1] for i in retry], [checks[i][2] for i in retry],
                [checks[i][3] for i in retry])
        try:
            second = verify(*args)
        except Exception as e:
            # pass 1's verdicts are in hand; only the retries need the host
            if not _host_serves_failure(e, device, "pass 2", len(retry)):
                raise
            second = _host_batch(*args)
        for i, ok in zip(retry, second):
            out[i] = ok
    return out


def _host_serves_failure(e: Exception, device: DeviceLike, what: str,
                         n: int) -> bool:
    """True when the host serves a failed device pass (the CPU only; the
    failure is already on :data:`DEGRADE`).  On a card, and for a failed
    arm anywhere, the caller raises it."""
    if isinstance(e, ArmError) or not host_may_serve(device):
        return False
    trace.inc("resilience.device_fallback")
    log.warning("device verify %s failed (%s); the host serves %d checks",
                what, e, n)
    return True


def _two_pass(checks: Sequence[tuple], verify) -> List[bool]:
    """Pass 1 on the raw-bytes digests, pass 2 on the hex-form digests of
    the checks that failed it."""
    out = verify([c[0] for c in checks], [c[2] for c in checks],
                 [c[3] for c in checks])
    retry = [i for i, ok in enumerate(out) if not ok]
    if retry:
        second = verify([checks[i][1] for i in retry],
                        [checks[i][2] for i in retry],
                        [checks[i][3] for i in retry])
        for i, ok in zip(retry, second):
            out[i] = ok
    return out


def _host_batch(digests, sigs, pubs) -> List[bool]:
    """The native C++ batch, or the pure-Python oracle where the native
    library cannot be built."""
    from .. import native

    batch = native.p256_verify_batch(digests, sigs, pubs)
    if batch is None:
        batch = [_host_verify_digest(d, s, p)
                 for d, s, p in zip(digests, sigs, pubs)]
    return list(batch)


def _device_batch(digests, sigs, pubs, device: DeviceLike = None,
                  mesh=None, device_timeout: float = 240.0) -> List[bool]:
    """One device batch, boxed through the device runtime under
    ``device_timeout``; its outcome goes to :data:`DEGRADE`.  Raises on
    an error (recorded) and on a hang (the path poisoned)."""
    from ..crypto import p256

    def dispatch():
        injector = get_injector()
        if injector is not None:  # lands inside the box, as a hang would
            injector.fire_sync("device.verify")
        if mesh is None:
            ok = p256.verify_batch_prehashed(digests, sigs, pubs,
                                             device=device)
        else:  # the mesh's devices run it
            ok = p256.verify_batch_prehashed(digests, sigs, pubs, mesh=mesh)
        return [bool(v) for v in ok]

    t0 = time.perf_counter()
    status, value = get_runtime(device).run_boxed(
        dispatch, device_timeout, kernel="p256_verify", source="verify")
    trace.observe("kernel.p256_verify.dispatch_seconds",
                  time.perf_counter() - t0, buckets=DISPATCH_BUCKETS)
    if status == "ok":
        DEGRADE.record_success()
        return value
    if status == "err":
        DEGRADE.record_failure(value)
        log.warning("device verify dispatch failed (state %s): %r",
                    DEGRADE.state, value)
        raise value
    DEGRADE.poison("device verify hung")
    raise TimeoutError(f"device verify hung past {device_timeout}s")


def _host_verify_digest(digest: bytes, sig, pub) -> bool:
    r, s = sig
    if not (0 < r < CURVE_N and 0 < s < CURVE_N):
        return False
    # ECDSA bits2int (SEC 1 / RFC 6979): the digest is a big-endian
    # integer by the signature algorithm's definition, not wire format.
    z = int.from_bytes(digest, "big")  # upowlint: disable=CE001
    w = pow(s, -1, CURVE_N)
    p1 = curve.point_mul(z * w % CURVE_N, curve.G)
    p2 = curve.point_mul(r * w % CURVE_N, pub)
    p = curve.point_add(p1, p2)
    return p is not None and p[0] % CURVE_N == r % CURVE_N


class TxVerifier:
    """All rule checks for one transaction against a ChainState.

    Mirrors Transaction.verify's chain (transaction.py:185-238); each rule
    method cites its reference lines.
    """

    def __init__(self, state: ChainState, is_syncing: bool = False,
                 tx_overlay: Optional[Dict[str, Tx]] = None,
                 verify_mesh_devices: int = 1):
        self.state = state
        self.is_syncing = is_syncing
        # the mesh a signature batch is sharded over (_verify_mesh)
        self.verify_mesh_devices = verify_mesh_devices
        # not-yet-accepted source txs (chain-sync page prefill): input
        # resolution consults these before the chain state, so signature
        # checks for a whole sync page can be collected up front even
        # when a tx spends an output created earlier in the same page
        self.tx_overlay = tx_overlay or {}

    # -- address resolution ------------------------------------------------

    async def input_address(self, tx_input) -> Optional[str]:
        src = self.tx_overlay.get(tx_input.tx_hash)
        if src is not None:
            # coinbase sources included: spending a same-page miner
            # reward is the common case two blocks into a sync page
            if 0 <= tx_input.index < len(src.outputs):
                return src.outputs[tx_input.index].address
            return None
        return await self.state.resolve_output_address(tx_input.tx_hash, tx_input.index)

    async def voter_address(self, tx_input) -> Optional[str]:
        """For revoke inputs: the vote tx's FIRST input address
        (transaction_input.py:56-58, 79-82)."""
        src = self.tx_overlay.get(tx_input.tx_hash)
        if src is not None:
            if src.is_coinbase or not src.inputs:
                return None
            return await self.input_address(src.inputs[0])
        info = await self.state.get_transaction_info(tx_input.tx_hash)
        if info is None or not info["inputs_addresses"]:
            tx = await self.state.get_transaction(tx_input.tx_hash, include_pending=True)
            if tx is None or tx.is_coinbase or not tx.inputs:
                return None
            return await self.input_address(tx.inputs[0])
        return info["inputs_addresses"][0]

    # -- double spends -----------------------------------------------------

    @staticmethod
    def no_internal_double_spend(tx: Tx) -> bool:
        """No outpoint used twice within the tx (transaction.py:90-97)."""
        outpoints = [i.outpoint for i in tx.inputs]
        return len(set(outpoints)) == len(outpoints)

    async def inputs_unspent(self, tx: Tx) -> bool:
        """Every input exists in the UTXO-class table its tx type spends
        (transaction.py:99-124)."""
        table = _INPUT_TABLE.get(tx.transaction_type, "unspent_outputs")
        present = await self.state.outpoints_exist(
            [i.outpoint for i in tx.inputs], table)
        return all(present)

    async def no_pending_double_spend(self, tx: Tx) -> bool:
        """Inputs absent from the pending-spent overlay
        (transaction.py:126-133; like the reference, only this tx's
        outpoints are fetched, not the whole overlay)."""
        pending = await self.state.get_pending_spent_outpoints(
            [i.outpoint for i in tx.inputs])
        return all(i.outpoint not in pending for i in tx.inputs)

    # -- DPoS rules (each returns True when the rule does not apply) -------

    async def check_stake(self, tx: Tx) -> bool:
        """transaction.py:434-465."""
        if not any(o.output_type == OutputType.STAKE for o in tx.outputs):
            return True
        address = await self.input_address(tx.inputs[0])
        stakes = await self.state.get_stake_outputs(address)
        if stakes and not self.is_syncing:
            return False
        pending = [
            t for t in await self.state.get_pending_stake_transactions(address)
            if t.hash() != tx.hash()
        ]
        if pending:
            return False
        delegate_power = sum(
            o.amount for o in tx.outputs
            if o.output_type == OutputType.DELEGATE_VOTING_POWER)
        if delegate_power > 0:
            if delegate_power != 10 * SMALLEST:  # 10 "coins" of voting power
                return False
            if await self.state.get_delegates_all_power(address):
                return False
        else:
            if not await self.state.get_delegates_all_power(address):
                return False
        return True

    async def check_unstake(self, tx: Tx) -> bool:
        """transaction.py:467-479."""
        if not any(o.output_type == OutputType.UN_STAKE for o in tx.outputs):
            return True
        address = await self.input_address(tx.inputs[0])
        if await self.state.get_delegates_spent_votes(address) \
                and tx.hash() not in _UNSTAKE_EXCEPTION_HASHES:
            return False
        if await self.state.get_pending_vote_as_delegate_transactions(address):
            return False
        return True

    async def check_inode_register(self, tx: Tx) -> bool:
        """transaction.py:325-362."""
        if not any(o.output_type == OutputType.INODE_REGISTRATION for o in tx.outputs):
            return True
        address = await self.input_address(tx.inputs[0])
        amount = sum(o.amount for o in tx.outputs
                     if o.output_type == OutputType.INODE_REGISTRATION)
        if amount != 1000 * SMALLEST:
            return False
        if not await self.state.get_stake_outputs(address):
            return False
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            return False
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            return False
        if len(await self.state.get_active_inodes(check_pending_txs=True)) >= MAX_INODES:
            return False
        active = await self.state.get_active_inodes()
        if any(e["wallet"] == address for e in active):
            return False
        return True

    async def check_inode_deregister(self, tx: Tx) -> bool:
        """transaction.py:240-254."""
        if tx.transaction_type != TransactionType.INODE_DE_REGISTRATION:
            return True
        address = await self.input_address(tx.inputs[0])
        if not await self.state.get_inode_registration_outputs(address):
            return False
        active = await self.state.get_active_inodes()
        if any(e["wallet"] == address for e in active):
            return False
        return True

    async def check_validator_register(self, tx: Tx) -> bool:
        """transaction.py:364-396."""
        if tx.transaction_type != TransactionType.VALIDATOR_REGISTRATION:
            return True
        address = await self.input_address(tx.inputs[0])
        if not await self.state.get_stake_outputs(address):
            return False
        if await self.state.is_validator_registered(address, check_pending_txs=True):
            return False
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            return False
        reg_amount = sum(o.amount for o in tx.outputs
                         if o.output_type == OutputType.VALIDATOR_REGISTRATION)
        if reg_amount != 100 * SMALLEST:
            return False
        power = [o for o in tx.outputs
                 if o.output_type == OutputType.VALIDATOR_VOTING_POWER]
        if len(power) != 1 or power[0].amount != 10 * SMALLEST:
            return False
        return True

    async def check_vote_as_validator(self, tx: Tx) -> bool:
        """transaction.py:256-288."""
        if tx.transaction_type != TransactionType.VOTE_AS_VALIDATOR:
            return True
        vote_range = sum(o.amount for o in tx.outputs
                         if o.output_type == OutputType.VOTE_AS_VALIDATOR)
        if vote_range > 10 * SMALLEST or vote_range <= 0:
            return False
        address = await self.input_address(tx.inputs[0])
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            return False
        if not await self.state.is_validator_registered(address, check_pending_txs=True):
            return False
        recipient = ""
        for o in tx.outputs:
            if o.output_type == OutputType.VOTE_AS_VALIDATOR:
                recipient = o.address
        if not await self.state.is_inode_registered(recipient, check_pending_txs=True):
            return False
        return True

    async def check_vote_as_delegate(self, tx: Tx,
                                     verifying_add_pending: bool = False) -> bool:
        """transaction.py:290-323."""
        if tx.transaction_type != TransactionType.VOTE_AS_DELEGATE:
            return True
        vote_range = sum(o.amount for o in tx.outputs
                         if o.output_type == OutputType.VOTE_AS_DELEGATE)
        if vote_range > 10 * SMALLEST or vote_range <= 0:
            return False
        address = await self.input_address(tx.inputs[0])
        if await self.state.is_inode_registered(address, check_pending_txs=True):
            return False
        if not await self.state.get_stake_outputs(
                address, check_pending_txs=verifying_add_pending):
            return False
        recipient = ""
        for o in tx.outputs:
            if o.output_type == OutputType.VOTE_AS_DELEGATE:
                recipient = o.address
        if not await self.state.is_validator_registered(recipient, check_pending_txs=True):
            return False
        return True

    async def check_revoke_as_validator(self, tx: Tx) -> bool:
        """transaction.py:399-417."""
        if tx.transaction_type != TransactionType.REVOKE_AS_VALIDATOR:
            return True
        address = await self.voter_address(tx.inputs[0])
        if not await self.state.is_validator_registered(address, check_pending_txs=True):
            return False
        if not await self.state.get_stake_outputs(address):
            return False
        valid = [await self.state.is_revoke_valid(i.tx_hash) for i in tx.inputs]
        return any(valid)

    async def check_revoke_as_delegate(self, tx: Tx) -> bool:
        """transaction.py:419-432."""
        if tx.transaction_type != TransactionType.REVOKE_AS_DELEGATE:
            return True
        address = await self.voter_address(tx.inputs[0])
        if not await self.state.get_stake_outputs(address):
            return False
        valid = [await self.state.is_revoke_valid(i.tx_hash) for i in tx.inputs]
        return any(valid)

    # -- outputs & fees ----------------------------------------------------

    @staticmethod
    def check_outputs(tx: Tx) -> bool:
        """Non-empty, every output verifies (transaction.py:181-183)."""
        return bool(tx.outputs) and all(o.verify() for o in tx.outputs)

    async def check_fees(self, tx: Tx) -> bool:
        """fee >= 0 (transaction.py:234-236, 499-518)."""
        return await self.state.tx_fees(tx) >= 0

    # -- the full chain ----------------------------------------------------

    async def rules_ok(self, tx: Tx, check_double_spend: bool = True,
                       verifying_add_pending: bool = False) -> bool:
        """Everything except signatures, in reference order.  Block
        verify passes ``check_double_spend=False``: its double-spend scan
        covers every input of the block at once (verify/block.py)."""
        if check_double_spend and not self.no_internal_double_spend(tx):
            return False
        if check_double_spend and not await self.inputs_unspent(tx):
            return False
        for rule in (
            self.check_stake,
            self.check_unstake,
            self.check_validator_register,
            self.check_revoke_as_validator,
            self.check_revoke_as_delegate,
            self.check_inode_deregister,
            self.check_inode_register,
            self.check_vote_as_validator,
        ):
            if not await rule(tx):
                return False
        if not await self.check_vote_as_delegate(
                tx, verifying_add_pending=verifying_add_pending):
            return False
        if not self.check_outputs(tx):
            return False
        if not await self.check_fees(tx):
            return False
        return True

    async def collect_sig_checks(self, tx: Tx,
                                 digests: Optional[tuple] = None
                                 ) -> Optional[List[tuple]]:
        """Deferred signature tuples for this tx (None -> invalid).
        ``digests`` forwards a fused-prep (digest, digest_hexform) pair
        so the per-tx sha256 passes are skipped (verify/block.py)."""
        is_revoke = tx.transaction_type in (
            TransactionType.REVOKE_AS_VALIDATOR, TransactionType.REVOKE_AS_DELEGATE)
        addresses = {}
        for tx_input in tx.inputs:
            addr = (await self.voter_address(tx_input) if is_revoke
                    else await self.input_address(tx_input))
            addresses[tx_input.outpoint] = addr
        return _dedup_sig_checks(
            tx, is_revoke, lambda i: addresses.get(i.outpoint),
            digests=digests)

    async def verify(self, tx: Tx, check_double_spend: bool = True,
                     verifying_add_pending: bool = False,
                     sig_backend: str = "auto",
                     device: DeviceLike = None) -> bool:
        """Full single-tx verification (rules + signatures)."""
        if not await self.rules_ok(tx, check_double_spend, verifying_add_pending):
            return False
        checks = await self.collect_sig_checks(tx)
        if checks is None:
            return False
        return all(await run_sig_checks_async(
            checks, backend=sig_backend, device=device,
            mesh_devices=self.verify_mesh_devices))

    async def prepare_pending(self, tx: Tx) -> Optional[List[tuple]]:
        """Host-side half of add-pending verification: every rule check
        plus the pending-double-spend overlay, with the signature work
        COLLECTED but not dispatched.  The mempool intake flattens the
        returned check tuples across a whole micro-batch into one
        signature dispatch; ``None`` means the tx failed a host-side rule
        and never reaches the device."""
        if not await self.rules_ok(tx, verifying_add_pending=True):
            return None
        if not await self.no_pending_double_spend(tx):
            return None
        return await self.collect_sig_checks(tx)
