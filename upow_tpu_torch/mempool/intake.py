"""Coalesced transaction admission: micro-batched push_tx intake.

The port of the JAX package's ``mempool/intake.py``.  Concurrent
``push_tx`` requests are queued and drained in micro-batches
(``coalesce_window_ms`` / ``max_intake_batch``); each tx runs its
host-side rule checks on its own, and every surviving signature check of
the whole batch goes to P-256 verification in ONE submission to the
shared dispatch front (verify/dispatch.py): N concurrent requests cost
one verify call, and an intake batch landing while block verify is in
flight shares ITS call too; the front hands it to the device runtime
with ``source="mempool"``.  Under the ``auto`` policy a batch of 8
checks or more runs on the device, through the kernel that
``device.verify_kernel`` selects (crypto/p256.py ``VERIFY_KERNEL``),
while the degrade allows it; smaller ones take the native host batch.

Wire compatibility is the hard constraint: every waiter resolves with a
result dict byte-identical to the JAX node's serial path
(``Node._verify_and_push_tx`` there, under ``mempool.enabled = False``):
same strings, same order of precedence between rejection reasons
(coinbase/unsigned, dedup cache, banned address, already pending,
rule/signature failure).  A failure that is no verdict (a runtime that
failed to arm its card, a state read) is never answered as a reject:
every waiter of the batch re-raises it, and the node answers with its
500 envelope.  A device verify that raises is the degrade's to serve on
the host (verify/txverify.py).

The ``mempool.intake`` fault site fires once a batch (keyed by its
size); an injected fault rejects the whole batch, as in the JAX node.
The drainer records each request's work against the submitting
request's trace (the JAX intake's cross-task attribution): its queue
wait (``intake.queue_wait``), the batch's shared signature dispatch
(``intake.sig_dispatch``), its journal write and its effects, whose
gossip then carries the submitter's trace id.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import Counter
from typing import Dict, List, Optional

from .. import trace
from ..resilience.faultinject import FaultInjected, get_injector
from ..verify.dispatch import get_front
from .pool import MempoolEntry

log = logging.getLogger("upow_tpu_torch.mempool")

# push_tx wire strings: byte-identical to the reference (and to the JAX
# node's serial path)
ERR_NOT_ADDED = "Transaction has not been added"
ERR_JUST_ADDED = "Transaction just added"
ERR_FORBIDDEN = "Access forbidden temporarily."
ERR_PRESENT = "Transaction already present"
MSG_ACCEPTED = "Transaction has been accepted"

_BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _reject(error: str) -> dict:
    return {"ok": False, "error": error}


def _log_drainer_exit(task: "asyncio.Task") -> None:
    """A drainer crash outside _process's per-request catch is logged
    now, not as 'exception was never retrieved' at GC time."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.error("intake drainer died: %r", exc)


class _Req:
    __slots__ = ("tx", "sender", "fut", "t0", "tx_hash", "first_address",
                 "checks", "slice", "dup_of", "result", "span", "wait_span")

    def __init__(self, tx, sender, fut):
        self.tx = tx
        self.sender = sender
        self.fut = fut
        self.t0 = time.perf_counter()
        self.tx_hash: Optional[str] = None
        self.first_address: Optional[str] = None
        self.checks: Optional[list] = None
        self.slice = (0, 0)
        self.dup_of: Optional["_Req"] = None
        self.result: Optional[dict] = None
        # trace attribution across the submit -> drainer task hop: the
        # drainer records its per-request work against the submitting
        # request's span
        self.span = trace.current_span()
        self.wait_span = trace.child_span(self.span, "intake.queue_wait")


class IntakeCoordinator:
    """Admission queue + drainer for one node.

    ``node`` is the owning Node (duck-typed: state, pool, tx_cache,
    config, device, make_tx_verifier(), accept_tx_effects(),
    _background).  The drainer task starts with the first submit and is
    registered in the node's background-task set so Node.close() reaps
    it.  Each drained batch's size is observed as
    ``mempool.intake_batch_size`` (a histogram) and counted exactly in
    :attr:`batch_sizes` (size -> batches), which ``chip_smoke.py``
    prints.
    """

    QUEUE_DEPTH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

    def __init__(self, node, banned_addresses=frozenset()):
        self.node = node
        self.banned = banned_addresses
        self._queue: List[_Req] = []
        self._drainer: Optional[asyncio.Task] = None
        self.batch_sizes: Counter = Counter()

    async def submit(self, tx, sender: Optional[str]) -> dict:
        """Queue one tx and wait for its wire-compatible result dict."""
        fut = asyncio.get_running_loop().create_future()
        self._queue.append(_Req(tx, sender, fut))
        trace.observe("mempool.intake_queue_depth", len(self._queue),
                      buckets=self.QUEUE_DEPTH_BUCKETS)
        self._ensure_drainer()
        return await fut

    def _ensure_drainer(self) -> None:
        if self._drainer is not None and not self._drainer.done():
            return
        self._drainer = asyncio.ensure_future(self._drain())
        self._drainer.add_done_callback(_log_drainer_exit)
        bg = getattr(self.node, "_background", None)
        if bg is not None:
            bg.add(self._drainer)
            self._drainer.add_done_callback(bg.discard)

    async def _drain(self) -> None:
        try:
            while self._queue:
                window = self.node.config.mempool.coalesce_window_ms / 1000.0
                if window > 0:
                    # hold the door: stragglers arriving inside the
                    # window join this batch instead of paying their own
                    # dispatch
                    await asyncio.sleep(window)
                batch = self._queue[:self.node.config.mempool.max_intake_batch]
                del self._queue[:len(batch)]
                if batch:
                    await self._process(batch)
        except asyncio.CancelledError:
            # node shutdown: nothing may hang on an unresolved future
            for req in self._queue:
                self._resolve(req, _reject(ERR_NOT_ADDED))
            self._queue.clear()
            raise

    def _resolve(self, req: _Req, result: dict) -> None:
        req.result = result
        if not req.fut.done():
            req.fut.set_result(result)
        trace.observe("mempool.admit_latency", time.perf_counter() - req.t0)

    # ------------------------------------------------------------ batch ---

    async def _process(self, batch: List[_Req]) -> None:
        try:
            with trace.span("mempool.intake_batch", n=len(batch)):
                await self._process_inner(batch)
        except Exception as e:
            # no verdict (a kernel that did not build or launch, a state
            # read): every open waiter re-raises it, so the client gets
            # the node's 500 envelope and never a reject it would take
            # for a bad signature
            log.error("intake batch failed: %s", e, exc_info=True)
            for req in batch:
                if not req.fut.done():
                    req.fut.set_exception(e)
        finally:
            # covers BaseException too: a drainer cancelled mid-batch has
            # already popped this batch off the queue, so settle its
            # waiters here before the cancellation propagates
            for req in batch:
                if not req.fut.done():
                    self._resolve(req, _reject(ERR_NOT_ADDED))

    async def _process_inner(self, batch: List[_Req]) -> None:
        node = self.node
        trace.inc("mempool.intake_batches")
        trace.inc("mempool.intake_txs", len(batch))
        trace.observe("mempool.intake_batch_size", len(batch),
                      buckets=_BATCH_SIZE_BUCKETS)
        self.batch_sizes[len(batch)] += 1

        injector = get_injector()
        if injector is not None:
            try:
                # the batch-level fault goes to the first submitter's
                # trace, so /debug/events can tie it to a request
                with trace.attached(batch[0].span if batch else None):
                    await injector.fire("mempool.intake",
                                        key=str(len(batch)))
            except FaultInjected:
                trace.inc("mempool.intake_faults")
                for req in batch:
                    self._resolve(req, _reject(ERR_NOT_ADDED))
                return

        # pull in other journal writers (block accept) before membership
        # checks: the pool is the intake authority.  stamp0 anchors the
        # end-of-batch reconcile.
        await node.pool.sync(node.state)
        stamp0 = node.pool.journal_stamp

        # -- phase A: per-tx host-side checks, batch order -----------------
        seen: Dict[str, _Req] = {}
        survivors: List[_Req] = []
        for req in batch:
            trace.finish_child(req.wait_span, batch=len(batch))
            tx = req.tx
            if getattr(tx, "is_coinbase", False) or any(
                    i.signature is None for i in tx.inputs):
                self._resolve(req, _reject(ERR_NOT_ADDED))
                continue
            req.tx_hash = tx.hash()
            first = seen.get(req.tx_hash)
            if first is not None:
                req.dup_of = first  # settled after the first instance
                continue
            seen[req.tx_hash] = req
            if req.tx_hash in node.tx_cache:
                self._resolve(req, _reject(ERR_JUST_ADDED))
                continue
            if tx.inputs:
                req.first_address = await node.state.resolve_output_address(
                    tx.inputs[0].tx_hash, tx.inputs[0].index)
            if req.first_address in self.banned:
                self._resolve(req, _reject(ERR_FORBIDDEN))
                continue
            if req.tx_hash in node.pool:
                self._resolve(req, _reject(ERR_PRESENT))
                continue
            if await node.state.pending_transaction_exists(req.tx_hash):
                # a journal row the pool does not hold (a conflict-skipped
                # loser of sync's reconcile): the serial path answers
                # ERR_PRESENT here, so the batched path must too
                self._resolve(req, _reject(ERR_PRESENT))
                continue
            try:
                checks = await node.make_tx_verifier().prepare_pending(tx)
            except Exception as e:  # serial parity: verify errors reject
                log.info("tx verify error %s: %s", req.tx_hash, e)
                checks = None
            if checks is None:
                self._resolve(req, _reject(ERR_NOT_ADDED))
                continue
            req.checks = checks
            survivors.append(req)

        # -- phase B: ONE signature dispatch for the whole batch -----------
        flat: list = []
        for req in survivors:
            req.slice = (len(flat), len(flat) + len(req.checks))
            flat.extend(req.checks)
        verdicts: List[bool] = []
        if flat:
            # a runtime that failed to arm raises out of the batch (see
            # _process): no verdict is guessed
            dev = node.config.device
            t_dispatch = time.perf_counter()
            with trace.span("mempool.sig_dispatch", n=len(flat)):
                verdicts = await get_front().submit(
                    flat, backend=dev.sig_backend, device=node.device,
                    pad_block=dev.verify_pad_block,
                    device_timeout=dev.verify_device_timeout,
                    mesh_devices=dev.mesh_devices, source="mempool")
            # the ONE coalesced dispatch appears in EVERY sharing
            # request's trace tree (same interval, n/coalesced fields)
            t_done = time.perf_counter()
            for req in survivors:
                trace.add_span(req.span, "intake.sig_dispatch",
                               t_dispatch, t_done, n=len(flat),
                               coalesced=len(survivors))

        # -- phase C: finalize in batch order ------------------------------
        claimed: Dict[tuple, str] = {}  # intra-batch outpoint claims
        added = 0           # successful journal inserts this batch
        last_seq = None     # journal sequence of the latest insert
        for req in survivors:
            lo, hi = req.slice
            if not all(verdicts[lo:hi]):
                self._resolve(req, _reject(ERR_NOT_ADDED))
                continue
            outpoints = tuple(i.outpoint for i in req.tx.inputs)
            if any(op in claimed for op in outpoints):
                # an earlier tx of this batch claimed the outpoint:
                # exactly the serial path's pending-double-spend reject
                self._resolve(req, _reject(ERR_NOT_ADDED))
                continue
            try:
                with trace.attached(req.span), \
                        trace.span("push_tx.journal_write"):
                    last_seq = await node.state.add_pending_transaction(req.tx)
                added += 1
            except Exception as e:  # serial parity (journal reject)
                log.info("tx rejected %s: %s", req.tx_hash, e)
                self._resolve(req, _reject(ERR_NOT_ADDED))
                continue
            for op in outpoints:
                claimed[op] = req.tx_hash
            node.pool.add(MempoolEntry(
                tx_hash=req.tx_hash, tx_hex=req.tx.hex(),
                fees=await node.state.tx_fees(req.tx),
                outpoints=outpoints, tx=req.tx))
            # attached(): the gossip task spawned inside inherits THIS
            # request's trace context, so its X-Upow-Trace header
            # carries the submitter's id
            with trace.attached(req.span), trace.span("push_tx.effects"):
                await node.accept_tx_effects(req.tx, req.tx_hash,
                                             req.first_address, req.sender)
            self._resolve(req, {"ok": True, "result": MSG_ACCEPTED,
                                "tx_hash": req.tx_hash})

        # duplicates: the first instance's fate decides (serial parity: an
        # accepted first instance is in the dedup cache by the time the
        # second would run; a rejected one re-fails the same way)
        for req in batch:
            if req.dup_of is None or req.fut.done():
                continue
            first_result = req.dup_of.result or _reject(ERR_NOT_ADDED)
            if first_result.get("ok"):
                self._resolve(req, _reject(ERR_JUST_ADDED))
            else:
                self._resolve(req, dict(first_result))

        # predict the stamp this batch's own writes produce from stamp0 (K
        # inserts: count +K, max-seq = the last insert's sequence, local
        # generation +K) and reconcile: a match records the stamp cheaply,
        # any mismatch means another journal writer (block acceptance
        # deleting mined txs) landed during this batch's awaits, and
        # reconcile() falls back to the full sync diff
        expected = None
        if (stamp0 is not None and len(stamp0) == 3
                and (added == 0 or last_seq is not None)):
            expected = (stamp0[0] + added,
                        last_seq if added else stamp0[1],
                        stamp0[2] + added)
        await node.pool.reconcile(node.state, expected)
        # byte cap and TTL (write-through: evictions leave the journal)
        await node.pool.enforce_limits(node.state)
