"""Block validation and acceptance — the consensus manager (manager.py).

The port of the JAX package's ``verify/block.py``.  Departures from the
reference, by design (SURVEY.md §7):

* **Batched signature verify** — instead of the serial per-input fastecdsa
  call inside the per-tx loop (manager.py:628-632), the block's signature
  checks are collected per micro-batch and verified by the batched P-256
  kernel on the card (verify/txverify.py, crypto/p256.py).
* **Pure difficulty/PoW math** — imported from the stateless core
  (core/difficulty.py) and wired to storage here, not entangled with it.
* **One transaction per block accept** — storage mutations run inside a
  single sqlite transaction instead of the reference's serializable-retry
  loops (database.py:640-672).

``BlockManager(state, device=...)`` runs on the card unless the caller
passes ``device="cpu"`` (the plain PyTorch version of the kernel), and
raises without a card otherwise.  Its signature micro-batches go through
the dispatch front to the device runtime (``source="block"``, weight 4,
so a saturating miner cannot starve them), and the fused accept scan is
one runtime slot a micro-batch (``kernel="accept_fused"``).  The node's
hooks are here: the mempool GC (``clear_pending_transactions``), the
``on_pending_removed`` and ``on_state_committed`` notifications (the
second is the node's hot read cache's generation bump), the cached
difficulty, the active-inode cache that the read routes share with the
accept (which refreshes it from the list its rewards read), and the
chain-sync page verdicts (``page_sig_verdicts``, set by the node around
a sync page's accept loop).  With the state's resident UTXO index armed
(``ChainState.resident_indexes()``), ``check_block`` takes the fused
accept scan: each micro-batch's outpoints are probed on the index
(kernel B6) in the same call as its digest batch, and the double-spend
verdict is read from the probes instead of SQL.

Rules and quirks are otherwise replicated exactly; citations inline.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import logging
import time
from decimal import Decimal
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import DeviceConfig
from ..core.clock import timestamp as now_ts
from ..core.constants import MAX_BLOCK_SIZE_HEX, SMALLEST
from ..core import difficulty as difficulty_rules
from ..core.difficulty import BLOCKS_COUNT, LAST_BLOCK_FOR_GENESIS_KEY, check_pow
from ..core.header import split_block_content
from ..core.merkle import merkle_root
from ..core.rewards import get_block_reward, get_inode_rewards
from ..core.tx import CoinbaseTx, Tx, TxOutput
from ..crypto.sha256 import txid_batch
from ..device import DeviceLike, resolve
from ..state.device_index import fused_probe
from ..state.storage import ChainState, _INPUT_TABLE
from ..telemetry import device as ktel
from ..trace import event, span
from . import txverify
from .dispatch import get_front
from .txverify import TxVerifier, device_verify_allowed

# txs per verify micro-batch: the digest prep of batch N overlaps the
# device verify of batch N - 1 (the JAX package's default)
VERIFY_MICROBATCH = 1024

# Historical chain patches: grandfathered double-spends by height and the
# one merkle exception (consensus DATA for mainnet compatibility;
# manager.py:837-867, 639-645).
DOUBLE_SPEND_WHITELIST = {
    286523: [
        ("16c519171bfa7ee7d42af0d84fe731433048a1aedfd5df692b8beaa755ef6eb9", 0),
        ("747d753fcfecdce5d3a080666ff139ca9123d72d2eb529386f2c3f9f4a55f983", 1),
        ("856b36ecd55a3a427cc988550457435ee9dd7580a423bc3177c1d173b50ff101", 1),
        ("af33808f839698734d801e907f1eb1c24c3547d4cdd984ed0f2e41c58c6d1d9a", 1),
        ("db843078e1fd5f1bbf1c2f550f87548df6fe714ccd12a0ba4a1e25e10fea3ae0", 1),
        ("eb10fd11319aeee7a21766b85c89580f6c3f509a6afaf743df717ca91d33e0da", 1),
    ],
    347027: [
        ("4fd22d5ca99eaa044288de9f850385cbf758efdc4967a92623138e986ce4316e", 2),
        ("b88e9beef7559d48d99ea82e71f7c0601981d6972021feb929c04bc7b52368c2", 1),
        ("ed0f9e07d97ab8a5dc7b8e68ad631a5e78f3cfb6ee6f2aa013854caa64a7b1ae", 1),
    ],
    347034: [
        ("047f5c343dcd15a16c44b3f05fe98bc467002405490ecfb517652207e5425858", 2),
    ],
    349122: [
        ("691695269d8baa441b8e1638a17b3b8497295ec8322c750e8b5312768d4b9ce5", 1),
        ("f7894d0cab92445bd1bb7681106d8fb18d9b4af2465db8a73efbdb97431f855f", 1),
    ],
    395735: [
        ("461c359b956773ff97af6d2189ae84bcc52740e077224efc80b8b5826b51cb92", 1),
        ("ef573f3543ef22b087387fd81493cc7bc977adcc1ff4198483a98a67a6d10e6b", 1),
        ("9efcb290e4c24843bab40dc50591680ac897e52a28db62c7594e4a2b07702291", 1),
    ],
    395736: [
        ("d8421370cef17939c4a2b17c21c7674059c0c24766e80d6129c666f11e886e08", 1),
        ("af2422540ef2f4570b998b262c242b37f7f0e44fbadabcb0f52684dd0ce1ace5", 1),
    ],
}
MERKLE_EXCEPTION = (
    340510, "54e7e3fbfe5c3c7b2a74d14efd22a61c231d157b2c5c2476fca67736736b9ac8")


def _fused_digest_prep(transactions: Sequence[Tx], txid_backend: str,
                       txid_min_batch: int, device: DeviceLike = None,
                       probe: Optional[Sequence[tuple]] = None):
    """Digest preparation for one verify micro-batch.

    Per tx, THREE digests feed the hot path: the raw signing-bytes
    digest and its hex-form twin (both consumed by the signature
    checks) and the txid (consumed by merkle_root and storage).  All of
    them go through ONE :func:`..crypto.sha256.txid_batch` call, which
    buckets them by length, and txids seed ``Tx._hash`` so the later
    ``merkle_root`` is memo reads.  The txid seed is definitionally
    safe: the payload IS ``bytes.fromhex(tx.hex())``, exactly what
    ``Tx.hash()`` would digest.

    A host backend, or a micro-batch below ``txid_min_batch`` payloads,
    hashes with hashlib; otherwise the batch runs on ``device`` (the
    card unless ``"cpu"``) under ``txid_backend`` (``device`` or
    ``auto``), as in the JAX package's node.

    ``probe`` (the resident accept path) is a list of
    ``(DeviceUtxoIndex, outpoints)`` parts: the micro-batch's membership
    probes and its digest batch run in one
    :func:`..state.device_index.fused_probe` call (one runtime slot), the
    digest batch as its ``extra_fn``.  There the device digest batch also
    needs the degrade gate (``txverify.device_verify_allowed``), as in
    the JAX package: on the CPU a degraded device path hashes with
    hashlib without giving up the probe; on a card the gate raises
    (``DeviceBlocked``).  A failed probe or digest launch raises out of
    the accept.

    Returns ``{id(tx): (digest, digest_hexform)}`` for
    ``collect_sig_checks``; with ``probe``, ``(that dict,
    [(present, amounts, shadow_consults), ...])``.
    """
    payloads: List[bytes] = []
    need_txid: List[bool] = []
    for tx in transactions:
        signing_hex = tx.hex(False)
        payloads.append(bytes.fromhex(signing_hex))
        payloads.append(signing_hex.encode())
        need = getattr(tx, "_hash", "x") is None
        need_txid.append(need)
        if need:
            payloads.append(bytes.fromhex(tx.hex()))
    digest_batch = functools.partial(
        txid_batch, payloads, backend=txid_backend, min_batch=txid_min_batch,
        device=device)
    probe_results = None
    if probe is not None:
        if (txid_backend != "host" and len(payloads) >= txid_min_batch
                and not device_verify_allowed(device)):
            digest_batch = functools.partial(txid_batch, payloads,
                                             backend="host")
        probe_results, digests = fused_probe(probe, extra_fn=digest_batch,
                                             source="block")
    else:
        digests = digest_batch()
    out: Dict[int, tuple] = {}
    pos = 0
    for tx, need in zip(transactions, need_txid):
        out[id(tx)] = (bytes.fromhex(digests[pos]),
                       bytes.fromhex(digests[pos + 1]))
        pos += 2
        if need:
            tx._hash = digests[pos]
            pos += 1
    if probe is not None:
        return out, probe_results
    return out


class BlockManager:
    """Difficulty, check_block, create_block over one ChainState."""

    def __init__(self, state: ChainState, device: DeviceLike = None,
                 verify_mesh_devices: int = 1,
                 verify_microbatch: int = VERIFY_MICROBATCH,
                 txid_backend: str = DeviceConfig.txid_backend,
                 txid_min_batch: int = DeviceConfig.txid_min_batch,
                 verify_pad_block: int = DeviceConfig.verify_pad_block,
                 verify_device_timeout: float =
                 DeviceConfig.verify_device_timeout):
        self.state = state
        # the card unless the caller asks for the CPU; raises without one
        self.device = resolve(device)
        # shard the signature batches over a mesh (txverify._verify_mesh):
        # 0 = every visible card, 1 = one device, N = the first N, or an
        # explicit parallel.mesh.make_mesh tuple
        self.verify_mesh_devices = verify_mesh_devices
        self.verify_microbatch = verify_microbatch
        # the digest prep's backend (config device.txid_backend; "host"
        # is hashlib) and its least batch, defaulting to the config's
        self.txid_backend = txid_backend
        self.txid_min_batch = txid_min_batch
        # the signature dispatch's coalescing key and its boxed deadline
        self.verify_pad_block = verify_pad_block
        self.verify_device_timeout = verify_device_timeout
        self.is_syncing = False
        # transient page-level signature verdicts (chain-sync prefill):
        # set by the node's create_blocks around a page's accept loop
        self.page_sig_verdicts: Optional[dict] = None
        self._difficulty_cache: Optional[Tuple[Decimal, dict]] = None
        # the read routes' active-inode list (get_active_inodes_cached)
        self._inode_cache: Optional[List[dict]] = None
        self._inode_cache_time = 0.0  # monotonic
        # mempool notification: called with the tx hashes of every
        # journal removal this manager performs (mined txs on block
        # acceptance, GC evictions), AFTER the removal committed.  The
        # node points this at Mempool.remove so the in-memory pool drops
        # mined txs at once instead of at the next stamp reconcile.
        self.on_pending_removed = None
        # hot read cache notification (state/hotcache.py): called with no
        # arguments after every committed block accept on either path;
        # the node points it at HotStateCache.bump.  Reorgs reach the
        # cache through ChainState.on_blocks_removed instead, since sync
        # calls remove_blocks on the state directly.
        self.on_state_committed = None
        # one acceptance at a time: check_block suspends (sql, executor
        # dispatch), so two concurrent push_block handlers could both
        # validate against tip N and race the same block id into the
        # insert — the loser must instead re-validate against the new
        # tip and reject cleanly ("Previous hash is not matched")
        self._accept_lock = asyncio.Lock()

    def invalidate_difficulty(self):
        self._difficulty_cache = None

    @staticmethod
    def device_health() -> dict:
        """The verify device path's degrade state (``txverify.DEGRADE``);
        its ``gauge`` is the node's ``device_verify_health``."""
        degrade = txverify.DEGRADE
        return {**degrade.snapshot(), "gauge": degrade.state_gauge()}

    async def get_active_inodes_cached(self, max_age: float = 300.0) -> List[dict]:
        """The active inodes, cached ``max_age`` seconds (manager.py:30-32,
        870-900): what ``dobby_info`` and ``get_address_info`` read; the
        accept reads them fresh."""
        if self._inode_cache is not None and \
                time.monotonic() - self._inode_cache_time < max_age:
            return self._inode_cache
        self._inode_cache = await self.state.get_active_inodes()
        self._inode_cache_time = time.monotonic()
        return self._inode_cache

    def _notify_pending_removed(self, hashes: List[str]) -> None:
        if self.on_pending_removed is not None and hashes:
            self.on_pending_removed(hashes)

    def _notify_committed(self) -> None:
        if self.on_state_committed is not None:
            self.on_state_committed()

    # -------------------------------------------------------- difficulty --

    async def calculate_difficulty(self) -> Tuple[Decimal, dict]:
        """(difficulty for next block, last block dict) — manager.py:83-121
        via the pure retarget in core/difficulty.py."""
        last_block = await self.state.get_last_block()
        if last_block is None:
            return difficulty_rules.START_DIFFICULTY, {}
        last = {
            "id": last_block["id"],
            "timestamp": last_block["timestamp"],
            "difficulty": last_block["difficulty"],
            "hash": last_block["hash"],
        }
        window_start = None
        if last["id"] >= int(BLOCKS_COUNT) and last["id"] % int(BLOCKS_COUNT) == 0:
            first = await self.state.get_block_by_id(
                last["id"] - int(BLOCKS_COUNT) + 1)
            window_start = first["timestamp"] if first else last["timestamp"]
        return difficulty_rules.next_difficulty(last, window_start), last

    async def get_difficulty(self) -> Tuple[Decimal, dict]:
        if self._difficulty_cache is None:
            self._difficulty_cache = await self.calculate_difficulty()
        return self._difficulty_cache

    # ------------------------------------------------------- check_block --

    async def check_block(self, block_content: str, transactions: Sequence[Tx],
                          mining_info: Optional[Tuple[Decimal, dict]] = None,
                          errors: Optional[list] = None) -> bool:
        """Full block validation (manager.py:422-647)."""
        errors = errors if errors is not None else []
        if mining_info is None:
            mining_info = await self.calculate_difficulty()
        difficulty, last_block = mining_info
        block_no = (last_block["id"] + 1) if last_block else 1
        with span("block.header_check"):
            try:
                (previous_hash, address, merkle_tree, content_time,
                 content_difficulty, nonce) = split_block_content(
                     block_content)
            except (AssertionError, ValueError, NotImplementedError) as e:
                errors.append(f"malformed block content: {e}")
                return False

            # PoW vs the previous hash at current difficulty
            # (manager.py:130-151)
            if not check_pow(block_content,
                             last_block.get("hash") if last_block else None,
                             difficulty):
                errors.append("block not valid")
                return False
            if last_block and previous_hash != last_block["hash"]:
                errors.append("Previous hash is not matched")
                return False
            prev_ts = last_block.get("timestamp", 0) if last_block else 0
            if prev_ts >= content_time:
                errors.append("timestamp younger than previous block")
                return False
            if content_time > now_ts():
                errors.append("timestamp in the future")
                return False

        transactions = [tx for tx in transactions if not tx.is_coinbase]
        if sum(len(tx.hex()) for tx in transactions) > MAX_BLOCK_SIZE_HEX:
            errors.append("block is too big")
            return False

        # double-spend scan: the fused resident path answers membership
        # from the UTXO index in the same call as each micro-batch's
        # digest prep and hands the digests forward; otherwise the serial
        # per-table SQL scan runs first.  Both feed the same verdict
        # (whitelist, duplicate detect, error strings).
        prep_cache: Optional[Dict[int, tuple]] = None
        if transactions:
            resident = self.state.resident_indexes()
            if resident:
                prep_cache, by_table, presence = \
                    await self._fused_accept_scan(transactions, resident)
                if not self._double_spend_verdict(
                        by_table, presence, block_no, errors):
                    return False
            elif not await self._check_block_double_spends(
                    transactions, block_no, errors):
                return False

        # pipelined verify: the block is split into micro-batches; the
        # digest prep (tx decode + txid/digest sha256) of batch N runs on
        # the executor and OVERLAPS the batched P-256 verify of batch
        # N-1, which is already in flight through the shared dispatch
        # front.  Verdicts are only inspected after the
        # full rules loop, so error ordering is byte-identical to the old
        # serial path: a rules failure always surfaces before a signature
        # verdict, and the error strings are unchanged.
        verifier = TxVerifier(self.state, is_syncing=self.is_syncing,
                              verify_mesh_devices=self.verify_mesh_devices)
        front = get_front()
        loop = asyncio.get_running_loop()
        mb = self.verify_microbatch or max(len(transactions), 1)
        dispatches: List[asyncio.Future] = []
        n_checks = 0
        decode_busy = 0.0  # telemetry accumulator  # upowlint: disable=CP001
        t_wall = time.perf_counter()
        failed_tx: Optional[Tx] = None
        for start in range(0, len(transactions), mb):
            chunk = transactions[start:start + mb]
            t0 = time.perf_counter()
            if prep_cache is not None:
                # the fused scan hashed the whole block already
                prep = prep_cache
            else:
                prep = await loop.run_in_executor(None, functools.partial(
                    _fused_digest_prep, chunk, self.txid_backend,
                    self.txid_min_batch, self.device))
            chunk_checks: List[tuple] = []
            for tx in chunk:
                if not await verifier.rules_ok(tx, check_double_spend=False):
                    failed_tx = tx
                    break
                checks = await verifier.collect_sig_checks(
                    tx, digests=prep.get(id(tx)))
                if checks is None:
                    failed_tx = tx
                    break
                chunk_checks.extend(checks)
            decode_busy += time.perf_counter() - t0
            if failed_tx is not None:
                break
            n_checks += len(chunk_checks)
            if chunk_checks:
                dispatches.append(asyncio.ensure_future(front.submit(
                    chunk_checks, device=self.device,
                    pad_block=self.verify_pad_block,
                    device_timeout=self.verify_device_timeout,
                    mesh_devices=self.verify_mesh_devices,
                    precomputed=self.page_sig_verdicts, source="block")))
        if failed_tx is not None:
            for d in dispatches:
                d.cancel()
            await asyncio.gather(*dispatches, return_exceptions=True)
            errors.append(
                f"transaction {failed_tx.hash()} has been not verified")
            return False
        t_tail = time.perf_counter()
        with span("block.sig_verify", n=n_checks,
                  micro_batches=len(dispatches)):
            results = await asyncio.gather(*dispatches)
        wall = time.perf_counter() - t_wall
        ktel.record_stage("block_decode", decode_busy,
                          items=len(transactions), wall=wall)
        ktel.record_stage("block_sig_wait", time.perf_counter() - t_tail,
                          items=n_checks, wall=wall)
        if not all(all(r) for r in results):
            errors.append("signature verification failed")
            return False

        computed_merkle = merkle_root(transactions)
        if merkle_tree != computed_merkle:
            if (block_no, merkle_tree) == MERKLE_EXCEPTION:
                return True
            errors.append("merkle tree does not match")
            return False
        return True

    @staticmethod
    def _inputs_by_table(transactions: Sequence[Tx]) -> dict:
        """Group every input outpoint by the UTXO-class table it spends
        from, in tx order (reference database.py:589-622 partitioning)."""
        by_table: dict = {}
        for tx in transactions:
            table = _INPUT_TABLE.get(tx.transaction_type, "unspent_outputs")
            by_table.setdefault(table, []).extend(i.outpoint for i in tx.inputs)
        return by_table

    @staticmethod
    def _double_spend_verdict(by_table: dict, presence: dict,
                              block_no: int, errors: list) -> bool:
        """Shared verdict over per-table membership flags: missing set,
        in-block duplicate detect, and the historical whitelist — error
        strings of the reference (manager.py:469-615)."""
        for table, outpoints in by_table.items():
            present = presence[table]
            missing = {o for o, ok in zip(outpoints, present) if not ok}
            has_dup = len(set(outpoints)) != len(outpoints)
            if not missing and not has_dup:
                continue
            if table == "unspent_outputs" and block_no in DOUBLE_SPEND_WHITELIST:
                allowed = set(map(tuple, DOUBLE_SPEND_WHITELIST[block_no]))
                if missing - allowed == set():
                    continue
            errors.append(f"double spend in block: {block_no} ({table})")
            return False
        return True

    async def _check_block_double_spends(self, transactions: Sequence[Tx],
                                         block_no: int, errors: list) -> bool:
        """Per-class outpoint set-diff vs the six UTXO tables
        (manager.py:469-615), with the historical whitelist."""
        by_table = self._inputs_by_table(transactions)
        presence = {
            table: await self.state.outpoints_exist(outpoints, table)
            for table, outpoints in by_table.items()}
        return self._double_spend_verdict(by_table, presence, block_no, errors)

    async def _fused_accept_scan(self, transactions: Sequence[Tx],
                                 resident: dict) -> tuple:
        """Phase 1 of the resident accept path: walk the block in verify
        micro-batches, each one :func:`_fused_digest_prep` call with
        ``probe=`` (its outpoints probed on the index, its digests
        batched).  ``enable_device_index`` indexes every table an input
        can spend from.

        Returns ``(prep_cache, by_table, presence)``: the whole block's
        digests for phase 2, and per-table outpoints and presence flags
        in the grouping and order of the serial scan
        (:meth:`_inputs_by_table`), so the verdict's first error is the
        same."""
        loop = asyncio.get_running_loop()
        mb = self.verify_microbatch or len(transactions) or 1
        prep_cache: Dict[int, tuple] = {}
        by_table: dict = {}
        presence: dict = {}
        n_probed = 0
        t0 = time.perf_counter()
        for start in range(0, len(transactions), mb):
            chunk = transactions[start:start + mb]
            chunk_tables = self._inputs_by_table(chunk)
            prep, probe_results = await loop.run_in_executor(
                None, functools.partial(
                    _fused_digest_prep, chunk, self.txid_backend,
                    self.txid_min_batch, self.device,
                    probe=[(resident[t], ops)
                           for t, ops in chunk_tables.items()]))
            prep_cache.update(prep)
            for (table, ops), (present, _a, _c) in zip(
                    chunk_tables.items(), probe_results):
                by_table.setdefault(table, []).extend(ops)
                presence.setdefault(table, []).extend(bool(p) for p in present)
                n_probed += len(ops)
        ktel.record_stage("accept_probe", time.perf_counter() - t0,
                          items=n_probed)
        return prep_cache, by_table, presence

    # ------------------------------------------------------ create_block --

    async def create_block(self, block_content: str, transactions: List[Tx],
                           errors: Optional[list] = None) -> bool:
        """Validate + apply one mined block (manager.py:650-757)."""
        errors = errors if errors is not None else []
        async with self._accept_lock:
            with span("block_accept", level="info", txs=len(transactions)):
                return await self._create_block_timed(
                    block_content, transactions, errors)

    async def _create_block_timed(self, block_content, transactions,
                                  errors) -> bool:
        difficulty, last_block = await self.calculate_difficulty()
        block_no = (last_block["id"] + 1) if last_block else 1
        if not await self.check_block(block_content, transactions,
                                      (difficulty, last_block), errors):
            return False

        block_hash = hashlib.sha256(bytes.fromhex(block_content)).hexdigest()
        (previous_hash, address, merkle_tree, content_time,
         content_difficulty, nonce) = split_block_content(block_content)

        active_inodes = await self.state.get_active_inodes()
        # the read routes' cache takes the list the rewards read
        self._inode_cache = active_inodes
        self._inode_cache_time = time.monotonic()

        block_reward = get_block_reward(block_no)  # int smallest units
        miner_reward_dec, inode_rewards_dec = get_inode_rewards(
            Decimal(block_reward) / SMALLEST, active_inodes, block_no=block_no)

        # genesis-key / emission gate (manager.py:679-689)
        genesis = await self.state.get_block_by_id(1)
        if genesis is not None:
            _, genesis_address, _, _, _, _ = split_block_content(genesis["content"])
            if address == genesis_address and block_no <= LAST_BLOCK_FOR_GENESIS_KEY:
                pass
            elif inode_rewards_dec:
                pass
            else:
                errors.append("Emission detail is not formed. "
                              "Hence you cannot mine currently.")
                return False

        fees = 0
        for tx in transactions:
            fees += await self.state.tx_fees(tx)

        miner_amount = int(miner_reward_dec * SMALLEST) + fees
        coinbase = CoinbaseTx(block_hash, address, miner_amount)
        for inode_address, reward_dec in inode_rewards_dec.items():
            coinbase.outputs.append(
                TxOutput(inode_address, int(reward_dec * SMALLEST)))
        if not all(o.verify() for o in coinbase.outputs):
            errors.append("invalid coinbase outputs")
            return False

        with span("block.utxo_apply", txs=len(transactions)):
            async with self.state.atomic():
                await self.state.add_block(
                    block_no, block_hash, block_content, address, nonce,
                    difficulty, block_reward + fees, content_time)
                await self.state.add_transaction(coinbase, block_hash)
                await self.state.add_transactions(transactions, block_hash)
                await self.state.add_transaction_outputs(
                    list(transactions) + [coinbase])
                if transactions:
                    await self.state.remove_pending_transactions_by_hash(
                        [tx.hash() for tx in transactions])
                    await self.state.remove_outputs(transactions)
        # outside the atomic block: the pool must only drop entries for
        # a COMMITTED acceptance
        with span("block.mempool_remove"):
            self._notify_pending_removed([tx.hash() for tx in transactions])
        self._notify_committed()
        self.invalidate_difficulty()
        # first-seen stamp for the fleet propagation tracker: emitted
        # once per node per committed block (timed accept path)
        event("block_seen", hash=block_hash, height=block_no)

        if block_no % 10 == 0:
            fingerprint = await self.state.get_unspent_outputs_hash()
            logging.getLogger("upow_tpu_torch").info(
                "unspent_outputs_hash on block no. %s: %s", block_no, fingerprint)

        # emission audit sidecar (manager.py:741-753)
        self.state.record_emission(block_no, [
            {
                "power": str(i["power"]),
                "emission": str(i["emission"]),
                "wallet": i["wallet"],
                "inode_reward": str(inode_rewards_dec.get(i["wallet"], "")),
            }
            for i in active_inodes
        ])
        return True

    async def create_block_syncing(self, block_content: str,
                                   transactions: List[Tx],
                                   coinbase: CoinbaseTx,
                                   errors: Optional[list] = None) -> bool:
        """Sync-time accept: trusts the embedded coinbase, skips the
        emission gate, still runs full check_block (manager.py:760-835)."""
        errors = errors if errors is not None else []
        async with self._accept_lock:
            return await self._create_block_syncing_locked(
                block_content, transactions, coinbase, errors)

    async def _create_block_syncing_locked(self, block_content, transactions,
                                           coinbase, errors) -> bool:
        difficulty, last_block = await self.calculate_difficulty()
        block_no = (last_block["id"] + 1) if last_block else 1
        was_syncing = self.is_syncing
        self.is_syncing = True
        try:
            if not await self.check_block(block_content, transactions,
                                          (difficulty, last_block), errors):
                return False
        finally:
            self.is_syncing = was_syncing

        block_hash = hashlib.sha256(bytes.fromhex(block_content)).hexdigest()
        (previous_hash, address, merkle_tree, content_time,
         content_difficulty, nonce) = split_block_content(block_content)
        block_reward = get_block_reward(block_no)
        fees = 0
        for tx in transactions:
            fees += await self.state.tx_fees(tx)
        if not all(o.verify() for o in coinbase.outputs):
            errors.append("invalid coinbase outputs")
            return False

        with span("block.utxo_apply", txs=len(transactions)):
            async with self.state.atomic():
                await self.state.add_block(
                    block_no, block_hash, block_content, address, nonce,
                    difficulty, block_reward + fees, content_time)
                await self.state.add_transaction(coinbase, block_hash)
                await self.state.add_transactions(transactions, block_hash)
                await self.state.add_transaction_outputs(
                    list(transactions) + [coinbase])
                if transactions:
                    await self.state.remove_pending_transactions_by_hash(
                        [tx.hash() for tx in transactions])
                    await self.state.remove_outputs(transactions)
        with span("block.mempool_remove"):
            self._notify_pending_removed([tx.hash() for tx in transactions])
        self._notify_committed()
        self.invalidate_difficulty()
        # first-seen stamp, sync-accept path (same semantics as timed)
        event("block_seen", hash=block_hash, height=block_no)
        return True

    # --------------------------------------------------------- mempool GC --

    async def clear_pending_transactions(self) -> None:
        """Evict mempool entries whose inputs are gone or double-used
        (manager.py:253-349), with the JAX package's deliberate
        divergences: no unbounded recursion, only the affected
        transactions evicted when every checked input of a class is
        missing (the reference wipes the whole mempool), and exact
        tx-hash removal instead of the reference's hex-substring match."""
        while True:
            txs = await self.state.get_pending_transactions_limit(hex_only=False)
            used: set = set()
            evicted = False
            by_table: dict = {}
            for tx in txs:
                outpoints = [i.outpoint for i in tx.inputs]
                if any(o in used for o in outpoints):
                    await self.state.remove_pending_transactions_by_hash([tx.hash()])
                    self._notify_pending_removed([tx.hash()])
                    evicted = True
                    break
                used.update(outpoints)
                table = _INPUT_TABLE.get(tx.transaction_type, "unspent_outputs")
                by_table.setdefault(table, {})[tx.hash()] = outpoints
            if evicted:
                continue
            for table, tx_map in by_table.items():
                all_outpoints = [o for ops in tx_map.values() for o in ops]
                present = await self.state.outpoints_exist(all_outpoints, table)
                missing = {o for o, ok in zip(all_outpoints, present) if not ok}
                if not missing:
                    continue
                doomed = [h for h, ops in tx_map.items()
                          if any(o in missing for o in ops)]
                await self.state.remove_pending_transactions_by_hash(doomed)
                self._notify_pending_removed(doomed)
            return
