"""The node: the HTTP write path and the reads a miner needs.

The port of the JAX package's ``node/app.py`` (reference
upow/node/main.py), served by the standard-library server in
:mod:`.http` instead of ``aiohttp.web``.  Routes: ``/``, ``/push_tx``,
``/push_block``, ``/get_mining_info``, ``/get_pending_transactions``,
``/get_transaction``, ``/get_block`` and ``/get_blocks``.  Every body
is byte for byte the JAX node's: the ``{"ok": bool, ...}`` envelope, the
reference's error strings, GET query params merged with a POST JSON
body, and the middleware's IP filter, path normalisation, rate limits
and 403/422/429/500 envelopes.  ``/`` carries this node's own timings
and counters (``trace.py``) where the JAX node carries its telemetry's.

Transactions come in through the coalescing intake
(:mod:`..mempool.intake`), so a burst of concurrent ``push_tx`` requests
shares one signature verify; blocks through ``BlockManager``.  Both run
the P-256 kernel that ``device.verify_kernel`` selects, on the card
unless the node was started with ``device="cpu"``; without a card the
node refuses to start.

Not ported yet (ROADMAP.md): peers, gossip and ``propagate``, chain sync
(a ``push_block`` whose gap would trigger a sync answers with the JAX
node's body and starts nothing), reorg rollback, the explorer, address
and governance views, ``ws/``, the hot read cache, telemetry scopes and
SLO capture, snapshots and the archive tier.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import re
import time
from typing import List, Optional

from .. import trace
from ..config import Config
from ..core.constants import MAX_BLOCK_SIZE_HEX, VERSION
from ..core.header import split_block_content
from ..core.merkle import merkle_root
from ..core.tx import AmbiguousSignatureError, Tx, tx_from_hex
from ..device import DeviceLike, resolve
from ..mempool import IntakeCoordinator, Mempool, MiningInfoCache, TTLSet
from ..state.storage import ChainState
from ..verify.block import BlockManager
from ..verify.txverify import TxVerifier
from .http import (BodyTooLarge, HttpServer, Request, Response, json_response,
                   text_response)
from .ipfilter import IpFilter
from .ratelimit import RateLimiter

log = logging.getLogger("upow_tpu_torch.node")

# the one banned address (main.py:426-430)
_BANNED_ADDRESSES = {"DgQKikeDqS2Fzue23KuA36L4eJSFh649zA9jJ6zwbzUMp"}


class Node:
    """One node: state + manager + mempool + the HTTP handler.

    ``device`` is where signatures verify: the card unless ``"cpu"``
    (the plain PyTorch versions of the kernels); raises without a card.
    """

    def __init__(self, config: Optional[Config] = None,
                 state: Optional[ChainState] = None,
                 device: DeviceLike = None):
        self.config = config or Config()
        self.config.device.apply_kernel_overrides()
        self.device = resolve(device)
        self.state = state if state is not None else ChainState(
            self.config.node.db_path or None)
        self.manager = BlockManager(
            self.state, device=self.device,
            verify_microbatch=self.config.device.verify_microbatch)
        self.ip_filter = IpFilter(self.config.node.ip_config_file)
        self.rate_limiter = RateLimiter(
            enabled=self.config.node.rate_limits_enabled)
        mcfg = self.config.mempool
        self.pool = Mempool(max_bytes_hex=mcfg.max_pool_bytes_hex,
                            tx_ttl=mcfg.tx_ttl)
        # block acceptance and the mempool GC drop mined and doomed txs
        # from the pool directly; the stamp-driven sync() stays the
        # reconciliation backstop
        self.manager.on_pending_removed = self.pool.remove
        self.intake = IntakeCoordinator(self, _BANNED_ADDRESSES)
        self.mining_cache = MiningInfoCache()
        self.tx_cache = TTLSet(mcfg.tx_cache_size, mcfg.tx_cache_ttl)
        self._last_mempool_clean: Optional[float] = None  # monotonic
        self._closing = False
        self._background: set = set()
        self.routes = {("GET", "/"): self.h_root}
        for path, handler in (("/push_tx", self.h_push_tx),
                              ("/push_block", self.h_push_block)):
            self.routes[("GET", path)] = self.routes[("POST", path)] = handler
        for path, handler in (
                ("/get_mining_info", self.h_get_mining_info),
                ("/get_pending_transactions", self.h_get_pending_transactions),
                ("/get_transaction", self.h_get_transaction),
                ("/get_block", self.h_get_block),
                ("/get_blocks", self.h_get_blocks)):
            self.routes[("GET", path)] = handler
        self.server: Optional[HttpServer] = None

    # ----------------------------------------------------------- plumbing --
    def _spawn(self, coro) -> None:
        """Fire-and-forget background task, refused once close() began."""
        if self._closing:
            coro.close()
            return
        task = asyncio.ensure_future(coro)
        self._background.add(task)
        task.add_done_callback(self._background.discard)

    async def serve(self, host: Optional[str] = None,
                    port: Optional[int] = None) -> HttpServer:
        """Start the HTTP server (``port=0``: a free port)."""
        self.server = HttpServer(
            self.handle,
            host=self.config.node.host if host is None else host,
            port=self.config.node.port if port is None else port,
            max_body=self.config.node.response_cap)
        await self.server.start()
        return self.server

    async def close(self) -> None:
        self._closing = True
        if self.server is not None:
            await self.server.close()
        # cancel AND await, bounded: a task inside run_in_executor (a
        # verify on the card) cannot be cancelled until the call returns
        tasks = list(self._background)
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=5.0)
        self.state.close()

    @staticmethod
    def _params(request: Request) -> dict:
        """Merge query params with a JSON object body (reference
        Body(False))."""
        params = dict(request.query)
        if request.method == "POST" and request.body_size:
            try:
                body = request.json()
                if isinstance(body, dict):
                    params.update(body)
            except ValueError:  # JSONDecodeError, UnicodeDecodeError
                pass
        return params

    # -------------------------------------------------------- middleware --
    async def handle(self, request: Request) -> Response:
        """The JAX node's middleware (app.py:475-570, less telemetry
        scopes, SLO capture, peer learning, the first-request peer
        bootstrap and gossip), then the route."""
        client_ip = request.peer_ip
        if not self.ip_filter.allowed(client_ip):
            return json_response(
                {"ok": False, "error": "Access forbidden."}, status=403)
        normalized = re.sub("/+", "/", request.path) or "/"
        if normalized != request.path:
            query = request.query_string
            return Response(b"302: Found", 302,
                            content_type="text/plain; charset=utf-8",
                            headers={"Location": normalized + (
                                "?" + query if query else "")})
        if normalized != "/" and not self.ip_filter.allowed(
                client_ip, endpoint=normalized):
            return json_response(
                {"ok": False, "error": "Access forbidden temporarily."},
                status=403)
        if not self.rate_limiter.allow(client_ip, normalized):
            return json_response(
                {"ok": False, "error": "Rate limit exceeded"}, status=429)

        # aiohttp's add_get serves HEAD by the GET handler, and its 405
        # names the route's methods in Allow
        method = "GET" if request.method == "HEAD" else request.method
        handler = self.routes.get((method, normalized))
        if handler is None:
            allowed = {m for m, path in self.routes if path == normalized}
            if not allowed:
                return text_response("404: Not Found", 404)
            if "GET" in allowed:
                allowed.add("HEAD")
            response = text_response("405: Method Not Allowed", 405)
            response.headers["Allow"] = ",".join(sorted(allowed))
            return response
        try:
            response = await handler(request)
        except BodyTooLarge as e:  # aiohttp's 413, past the envelope
            return text_response(str(e), 413)
        except Exception as e:  # exception envelope (main.py:394-406)
            log.error("Error on %s, %s: %s", request.path, type(e).__name__,
                      e, exc_info=True)
            return json_response(
                {"ok": False, "error": f"Uncaught {type(e).__name__} exception"},
                status=500)
        response.headers["Access-Control-Allow-Origin"] = "*"
        return response

    # ------------------------------------------------------- tx intake ----
    def make_tx_verifier(self) -> TxVerifier:
        return TxVerifier(self.state)

    async def accept_tx_effects(self, tx: Tx, tx_hash: str,
                                first_address: Optional[str],
                                sender: Optional[str]) -> None:
        """Post-acceptance side effects of the intake: the dedup cache
        and the log line (gossip and the WS broadcast come with their
        slices)."""
        trace.event("tx_seen", hash=tx_hash)
        self.tx_cache.append(tx_hash)
        log.info("Transaction has been accepted: %s", tx_hash)

    # ------------------------------------------------------- mining info --
    async def _mining_info_result(self) -> dict:
        self.manager.invalidate_difficulty()
        difficulty, last_block = await self.manager.get_difficulty()
        # mempool-GC timer on the monotonic clock (main.py:678-683)
        now = time.monotonic()
        if (self._last_mempool_clean is None
                or now - self._last_mempool_clean
                > self.config.node.mempool_clean_interval):
            self._last_mempool_clean = now
            self._spawn(self.manager.clear_pending_transactions())
        last_json = _json_block(last_block)
        await self.pool.sync(self.state)
        key = (self.pool.generation, (last_json or {}).get("hash"),
               float(difficulty))
        cached = self.mining_cache.get(key)
        if cached is not None:
            return cached
        pending = sorted(self.pool.select_hex(MAX_BLOCK_SIZE_HEX))
        result = {
            "difficulty": float(difficulty),
            "last_block": last_json,
            "pending_transactions": pending[:10],
            "pending_transactions_hashes": [
                hashlib.sha256(bytes.fromhex(t)).hexdigest() for t in pending],
            "merkle_root": merkle_root(
                [tx_from_hex(t, check_signatures=False) for t in pending[:10]]),
        }
        self.mining_cache.put(key, result)
        return result

    # --------------------------------------------------------- handlers ---
    async def h_root(self, request: Request) -> Response:
        """Health probe (reference main.py:266-275) with this node's
        span timings and counters."""
        snap = trace.snapshot()
        return json_response({
            "ok": True, "version": VERSION,
            "unspent_outputs_hash": await self.state.get_unspent_outputs_hash(),
            "timings": snap["spans"],
            "counters": snap["counters"],
        })

    async def h_push_tx(self, request: Request) -> Response:
        params = self._params(request)
        tx_hex = params.get("tx_hex")
        if not tx_hex:
            return json_response(
                {"ok": False, "error": "Missing tx_hex"}, status=422)
        try:
            tx = await self._parse_tx(tx_hex)
        except Exception as e:
            log.debug("push_tx: rejecting unparseable tx: %s", e)
            return json_response(
                {"ok": False, "error": f"Invalid transaction: {e}"})
        return json_response(await self.intake.submit(
            tx, request.headers.get("sender-node")))

    async def _parse_tx(self, tx_hex: str) -> Tx:
        """Decode, resolving the ambiguous-signature relink against
        state (core/tx.py tx_from_hex needs a sync resolver); only the
        ambiguous layout pays the signature-free pre-parse."""
        try:
            return tx_from_hex(tx_hex, check_signatures=True)
        except AmbiguousSignatureError:
            pass
        tx = tx_from_hex(tx_hex, check_signatures=False)
        addrs = {}
        for i in tx.inputs:
            addrs[(i.tx_hash, i.index)] = (
                await self.state.resolve_output_address(i.tx_hash, i.index))
        return tx_from_hex(
            tx_hex, check_signatures=True,
            resolve_address=lambda h, idx: addrs.get((h, idx)))

    async def h_push_block(self, request: Request) -> Response:
        params = self._params(request)
        if "id" in params:
            return json_response({"ok": False, "error": "Deprecated"})
        block_content = params.get("block_content", "")
        txs = params.get("txs", "")
        block_no = params.get("block_no")
        sender = request.headers.get("sender-node")
        if isinstance(txs, str):
            txs = txs.split(",")
            if txs == [""]:
                txs = []
        try:
            previous_hash = split_block_content(block_content)[0]
        except Exception as e:
            log.debug("push_block: malformed block content from %s: %s",
                      sender, e)
            return json_response(
                {"ok": False, "error": f"malformed block content: {e}"})
        next_block_id = await self.state.get_next_block_id()
        if block_no is None:
            previous_block = await self.state.get_block(previous_hash)
            if previous_block is None:
                if sender:
                    return json_response({
                        "ok": False,
                        "error": "Previous hash not found, had to sync "
                                 "according to sender node, block may have "
                                 "been accepted"})
                return json_response(
                    {"ok": False, "error": "Previous hash not found"})
            block_no = previous_block["id"] + 1
        else:
            try:
                block_no = int(block_no)
                if not (0 <= block_no <= 2 ** 63 - 1):
                    raise ValueError
            except (ValueError, TypeError):
                return json_response(
                    {"ok": False, "error": "Invalid block_no"}, status=422)
        if next_block_id < block_no:
            return json_response({
                "ok": False,
                "error": "Blocks missing, had to sync according to sender "
                         "node, block may have been accepted"})
        if next_block_id > block_no:
            return json_response({"ok": False, "error": "Too old block"})

        final_transactions: List[Tx] = []
        hashes: List[str] = []
        for tx_hex in txs:
            if len(tx_hex) == 64:
                hashes.append(tx_hex)
            else:
                final_transactions.append(await self._parse_tx(tx_hex))
        if hashes:
            found = await self.state.get_pending_transactions_by_hash(hashes)
            if len(found) < len(hashes):
                if sender:
                    return json_response({
                        "ok": False,
                        "error": "Transaction hash not found, had to sync "
                                 "according to sender node, block may have "
                                 "been accepted"})
                return json_response(
                    {"ok": False, "error": "Transaction hash not found"})
            for h in found:
                final_transactions.append(await self._parse_tx(h))

        errors: list = []
        if not await self.manager.create_block(
                block_content, final_transactions, errors=errors):
            return json_response(
                {"ok": False, "error": errors[0]} if errors else {"ok": False})
        return json_response({"ok": True})

    async def h_get_mining_info(self, request: Request) -> Response:
        return json_response(
            {"ok": True, "result": await self._mining_info_result()})

    async def h_get_pending_transactions(self, request: Request) -> Response:
        txs = await self.state.get_pending_transactions_limit(hex_only=True)
        return json_response({"ok": True, "result": txs})

    async def h_get_transaction(self, request: Request) -> Response:
        tx = await self.state.get_nice_transaction(
            request.query.get("tx_hash", ""))
        if tx is None:
            return json_response({"ok": False, "error": "Transaction not found"})
        return json_response({"ok": True, "result": tx})

    async def _block_lookup(self, block: str) -> Optional[dict]:
        if block.isdecimal():
            # int64 max has 19 digits; beyond it no id is storable
            if len(block) > 19 or int(block) > 2 ** 63 - 1:
                return None
            return await self.state.get_block_by_id(int(block))
        return await self.state.get_block(block)

    async def h_get_block(self, request: Request) -> Response:
        q = request.query
        block = q.get("block", "")
        full = q.get("full_transactions", "false").lower() in ("1", "true")
        info = await self._block_lookup(block)
        if not info:
            return json_response({"ok": False, "error": "Block not found"})
        block_hash = info["hash"]
        return json_response({"ok": True, "result": {
            "block": _json_block(info),
            "transactions": (
                await self.state.get_block_transactions(block_hash,
                                                        hex_only=True)
                if not full else None),
            "full_transactions": (
                await self.state.get_block_nice_transactions(block_hash)
                if full else None),
        }})

    @staticmethod
    def _page_param(q, name: str, default: int, cap: int):
        """(value, None) or (None, 400 response): negative values clamp
        to 0, oversized ones to ``cap``, non-integers answer 400."""
        raw = q.get(name)
        if raw is None or raw == "":
            return default, None
        try:
            value = int(raw)
        except ValueError:
            return None, json_response(
                {"ok": False, "error": f"{name} must be an integer"},
                status=400)
        return max(0, min(value, cap)), None

    async def h_get_blocks(self, request: Request) -> Response:
        q = request.query
        offset, err = self._page_param(q, "offset", 0, 2 ** 63 - 1)
        if err is None:
            limit, err = self._page_param(q, "limit", 100, 1000)
        if err is not None:
            return err
        blocks = await self.state.get_blocks(offset, limit, size_capped=True)
        return json_response({"ok": True, "result": blocks})


def _json_block(block: Optional[dict]) -> dict:
    """Blocks carry Decimal difficulty/reward; make them JSON-clean the way
    the reference's FastAPI encoder does (floats/strings)."""
    if not block:
        return {}
    out = dict(block)
    if "difficulty" in out:
        out["difficulty"] = float(out["difficulty"])
    if "reward" in out:
        out["reward"] = str(out["reward"])
    return out


async def serve_forever(config: Config, device: DeviceLike = None) -> None:
    """Run one node until cancelled."""
    node = Node(config, device=device)
    server = await node.serve()
    log.info("node serving on %s:%d (device %s, verify kernel %s)",
             server.host, server.port, node.device,
             config.device.verify_kernel or "jac")
    try:
        await asyncio.Event().wait()
    finally:
        await node.close()
