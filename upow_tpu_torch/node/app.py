"""The node: HTTP API, peer gossip and chain sync.

The port of the JAX package's ``node/app.py`` (reference
upow/node/main.py), served by the standard-library server in
:mod:`.http` instead of ``aiohttp.web``.  Routes: ``/``, ``/push_tx``,
``/push_block``, ``/sync_blockchain``, ``/get_mining_info``,
``/add_node``, ``/get_nodes``, ``/get_pending_transactions``,
``/get_transaction``, ``/get_block``, ``/get_blocks``, the explorer,
address and governance reads (``/get_address_info``,
``/get_address_transactions``, ``/get_block_details``,
``/get_blocks_details``, ``/get_validators_info``,
``/get_delegates_info``, ``/dobby_info``, ``/get_supply_info``), the
localhost-only custodial ``/send_to_address`` (GET and POST, gated on the
client IP), the snapshot routes ``/snapshot/manifest`` and
``/snapshot/chunk/{i}``, the archive routes ``/archive/manifest`` and
``/archive/segment/{i}`` (the two routes with a path parameter), the
Prometheus exposition ``/metrics``, the ``/ws`` push hub (under
``ws.enabled``) and, under ``telemetry.debug_endpoints``,
``/debug/traces``, ``/debug/events``, ``/debug/alerts`` (GET, and POST
for the operator knobs), ``/debug/breakers``, ``/debug/cache``,
``/debug/archive`` and (with ``profile.enabled``) ``/debug/profile``.
Every body is byte for byte the JAX node's: the ``{"ok": bool, ...}``
envelope, the reference's error strings, GET query params merged with a
POST JSON body, and the middleware's IP filter, path normalisation, rate
limits and 403/422/429/500 envelopes.  ``/`` carries this process's
span stats and counters (``trace.stats()``, ``trace.counters()``).

The chain state is ``node.db_backend``'s: ``"sqlite"`` (the default, a
:class:`~..state.storage.ChainState` on ``node.db_path``) or
``"postgres"`` (a :class:`~..state.pg.PgChainState` on ``node.pg_dsn``,
which needs asyncpg), as in the JAX node.

The read routes serve through the hot read cache
(:mod:`..state.hotcache`, ``cache.*``): the encoded body is stored under
a generation that every committed write advances (a block accept, a
reorg, a pending-journal change), so a hit is byte for byte the uncached
body; ``X-Upow-Cache-Bypass`` skips it for one request.  ``/ws``
(:mod:`..ws`, on the transport of :mod:`.http`) pushes ``new_block`` for
each block ``push_block`` accepts and ``new_transaction`` for each tx the
intake admits.  With ``watchtower.enabled`` the watchtower
(:mod:`..watchtower`) evaluates its rule pack over the node's telemetry
every ``watchtower.interval`` seconds.

Telemetry (:mod:`..telemetry`), as in the JAX node: each request but the
scrape, ``/ws`` and debug ones runs under a trace root ``http.<path>`` that
adopts a well-formed ``X-Upow-Trace`` header and echoes its id, so the
gossip it spawns (whose RPCs carry the header) is one trace across
nodes; the registered routes feed the ``slo.http.<route>`` latency
histograms; ``telemetry.instance_scope`` gives the node registries of
its own.

Transactions come in through the coalescing intake
(:mod:`..mempool.intake`), so a burst of concurrent ``push_tx`` requests
shares one signature verify; blocks through ``BlockManager``.  Both run
the P-256 kernel that ``device.verify_kernel`` selects, on the card
unless the node was started with ``device="cpu"``; without a card the
node refuses to start.  Every device dispatch goes through the
process's device runtime (``device/runtime.py``), and
``resilience.device_failure_limit`` and ``device_cooldown`` configure
the degrade of the verify path (``txverify.DEGRADE``) at startup.

Peers (:mod:`.peers`): the node keeps a peer book seeded from
``node.seed_url``, learns a peer from each request's ``Sender-Node``,
and on its first request with a non-local ``Host`` learns its seed's
peers, announces itself and syncs.  An accepted tx or block, and the
tip a sync moved, is gossiped to a sample of the book
(:meth:`Node.propagate`), each send cut at
``resilience.propagate_deadline`` and every RPC under the peer's circuit
breaker and the retry policy; journal txs not gossiped for 300 s are
sent again after a later request.

Chain sync (``/sync_blockchain[?node_url=]``, a ``push_block`` whose
gap names a ``Sender-Node``, and the bootstrap) downloads a peer's
blocks in pages, with fork detection inside ``node.sync_reorg_window``
and a reorg through ``ChainState.remove_blocks``; with no ``node_url``
it tries up to 3 sampled peers in health order.  A page's txids are one
``txid_batch`` (the txid kernel under ``device.txid_backend``) and its
signatures one batched verify before the per-block accept.  As in the
JAX package, the signing digests are hashed twice: with hashlib when the
page's checks are collected, and again in each block's digest prep
(``verify/block.py``), whose check keys the page's verdicts answer.

Snapshots (:mod:`..snapshot`, ``snapshot.*``): the node serves the
published generation under ``snapshot.dir`` from disk, builds one on
:meth:`Node.build_snapshot` (and every ``snapshot.rebuild_interval_blocks``
blocks), and :meth:`Node.bootstrap_from_snapshot` restores from peers,
falling back to block replay with a structured reason; a restore that
cannot rebuild the resident index on the card raises.  The pool honours
``mempool.allow_rbf`` on its journal sync.

The cold-block archive (:mod:`..archive`, ``archive.*``): with
``archive.dir`` set the node attaches an
:class:`~..archive.reader.ArchiveReader` to its state, so every block and
transaction read that misses the hot tables falls through to the
archive's segments (archived rows never change, so the read cache's
generation does not move for them); :meth:`Node.compact_archive` (also
run after each background snapshot rebuild) moves fully spent history
below the snapshot anchor less ``archive.safety_window`` into segments
and prunes it from the hot tables; ``/archive/manifest`` and
``/archive/segment/{i}`` serve the published segments from disk, not
through the read cache; :meth:`Node.fetch_archive_from_peer` mirrors a
peer's archive; ``/metrics`` carries the ``archive_*`` families (zeros
with the tier off, as in a JAX node).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import json
import logging
import os
import random
import re
import sys
import time
from decimal import Decimal
from typing import List, Optional

from .. import _build, telemetry, trace
from ..archive import ArchiveReader
from ..archive import compactor as archive_compactor
from ..archive.reader import ArchiveFetchError, fetch_archive
from ..config import Config
from ..core.clock import timestamp
from ..core.constants import (ENDIAN, MAX_BLOCK_SIZE_HEX, MAX_SUPPLY,
                              SMALLEST, VERSION)
from ..core.header import block_to_bytes, split_block_content
from ..core.merkle import merkle_root
from ..core.rewards import get_circulating_supply
from ..core.tx import AmbiguousSignatureError, CoinbaseTx, Tx, tx_from_hex
from ..crypto.sha256 import txid_batch
from ..device import DeviceLike, resolve
from ..device.runtime import get_runtime
from ..logger import setup_logging
from ..mempool import IntakeCoordinator, Mempool, MiningInfoCache, TTLSet
from ..resilience import BreakerRegistry, ResilienceContext, faultinject
from ..snapshot import builder as snapshot_builder
from ..snapshot import client as snapshot_client
from ..snapshot import layout as snapshot_layout
from ..state.hotcache import HotStateCache
from ..state.storage import ChainState
from ..verify.block import BlockManager
from ..verify import txverify
from ..verify.txverify import (TxVerifier, _resolve_backend,
                               run_sig_checks_async, sig_verdict_stats)
from ..wallet import KeyStore, WalletBuilder
from ..watchtower import WatchtowerEngine
from ..ws import WsHub
from .http import (BodyTooLarge, HTTPException, HttpServer, Request, Response,
                   json_response, text_response)
from .ipfilter import IpFilter, is_local_ip
from .peers import NodeInterface, PeerBook, _normalize
from .ratelimit import RateLimiter

log = logging.getLogger("upow_tpu_torch.node")

# the one banned address (main.py:426-430)
_BANNED_ADDRESSES = {"DgQKikeDqS2Fzue23KuA36L4eJSFh649zA9jJ6zwbzUMp"}
GENESIS_PREV_HASH = (18_884_643).to_bytes(32, ENDIAN).hex()
_SYNCING = {"ok": False, "error": "Node is already syncing"}

# any value in this header skips the hot read cache for one request (the
# response is computed fresh and not stored)
_CACHE_BYPASS_HEADER = "x-upow-cache-bypass"

# the routes with a path parameter, and what aiohttp's router matches
# for their ``{i}``: one segment, no braces
_CHUNK_ROUTE = "/snapshot/chunk/{i}"
_SEGMENT_ROUTE = "/archive/segment/{i}"
_PARAM_ROUTES = tuple(
    (route, re.compile(re.escape(route[:-len("{i}")]) + r"([^{}/]+)"))
    for route in (_CHUNK_ROUTE, _SEGMENT_ROUTE))

# every get_address_info query flag that shapes the response: the cache
# key carries all of them
_ADDRESS_INFO_FLAGS = (
    "show_pending", "verify", "stake_outputs", "delegate_spent_votes",
    "delegate_unspent_votes", "inode_registration_outputs",
    "validator_unspent_votes", "validator_spent_votes", "address_state")


class _BadParam(Exception):
    """A malformed integer query parameter: the middleware answers 422."""


# a response aiohttp raises past the JAX middleware's envelope and SLO
# capture; each subclass bears the name of aiohttp's exception, which a
# trace root records as its error
_HttpError = HTTPException


class HTTPNotFound(_HttpError):
    pass


class HTTPMethodNotAllowed(_HttpError):
    pass


class HTTPRequestEntityTooLarge(_HttpError):
    pass


def _int_q(q, name: str, default: int, cap: Optional[int] = None) -> int:
    """An integer query parameter clamped into [0, int64 max] (and
    ``cap``); raises :class:`_BadParam` when it is not an integer."""
    raw = q.get(name)
    if raw is None or raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        raise _BadParam(name) from None
    value = max(0, min(value, 2 ** 63 - 1))
    return min(value, cap) if cap is not None else value


def _fmt_amount(smallest_units: int) -> str:
    return "{:f}".format(Decimal(smallest_units) / SMALLEST)


class Node:
    """One node: state + manager + mempool + the HTTP handler.

    ``device`` is where signatures verify: the card unless ``"cpu"``
    (the plain PyTorch versions of the kernels); raises without a card.
    """

    def __init__(self, config: Optional[Config] = None,
                 state: Optional[ChainState] = None,
                 device: DeviceLike = None):
        self.config = config or Config()
        setup_logging(self.config.log)
        telemetry.configure(self.config.telemetry)
        # instance-scoped registries (several nodes in one process):
        # every request this node handles, and every task spawned under
        # it, reports into this node's own metrics, events and traces
        self.telemetry_scope = None
        if self.config.telemetry.instance_scope:
            self.telemetry_scope = telemetry.TelemetryScope.from_config(
                self.config.telemetry)
        pcfg = self.config.profile
        if pcfg.cost_analysis or pcfg.enabled:
            from .. import profiling

            if pcfg.cost_analysis:
                profiling.COST_ANALYSIS = True
            if pcfg.enabled and self.config.telemetry.debug_endpoints:
                try:
                    profiling.prime()
                except Exception as e:  # the capture reports it later
                    log.warning("torch profiler init failed: %s", e)
        self.config.device.apply_kernel_overrides()
        self.device = resolve(device)
        dcfg = self.config.device
        backend = self.config.node.db_backend
        if state is not None:
            # injected backend (tests and chip_smoke.py: the pg backend
            # over the mock driver)
            self.state = state
        elif backend == "postgres":
            # an existing uPow PostgreSQL database (schema.sql) through
            # asyncpg; without asyncpg this raises, never falls back
            from ..state.pg import PgChainState

            self.state = PgChainState(
                self.config.node.pg_dsn,
                # the reference's sidecar file name (pickledb)
                emission_path="emission_details.json", device=self.device)
            self.state.ensure_schema()
            if dcfg.utxo_index:
                self.state.enable_device_index()
        elif backend == "sqlite":
            self.state = ChainState(
                self.config.node.db_path or None,
                device_index=dcfg.utxo_index, device=self.device)
        else:
            raise ValueError(
                f"node.db_backend must be 'sqlite' or 'postgres', not"
                f" {backend!r}")
        self.manager = BlockManager(
            self.state, device=self.device,
            verify_mesh_devices=dcfg.mesh_devices,
            verify_microbatch=dcfg.verify_microbatch,
            txid_backend=dcfg.txid_backend,
            txid_min_batch=dcfg.txid_min_batch,
            verify_pad_block=dcfg.verify_pad_block,
            verify_device_timeout=dcfg.verify_device_timeout)
        self.ip_filter = IpFilter(self.config.node.ip_config_file)
        self.rate_limiter = RateLimiter(
            enabled=self.config.node.rate_limits_enabled)
        mcfg = self.config.mempool
        self.pool = Mempool(max_bytes_hex=mcfg.max_pool_bytes_hex,
                            tx_ttl=mcfg.tx_ttl, allow_rbf=mcfg.allow_rbf)
        # block acceptance and the mempool GC drop mined and doomed txs
        # from the pool directly; the stamp-driven sync() stays the
        # reconciliation backstop
        self.manager.on_pending_removed = self.pool.remove
        rcfg = self.config.resilience
        self.breakers = BreakerRegistry(
            failure_threshold=rcfg.breaker_failure_threshold,
            open_secs=rcfg.breaker_open_secs,
            half_open_max=rcfg.breaker_half_open_max)
        if rcfg.faults:
            faultinject.install(rcfg.faults, rcfg.faults_seed)
        self.resilience = ResilienceContext.from_config(
            rcfg, breakers=self.breakers)
        # the degrade knobs land on the process-wide manager that the
        # verify dispatch consults
        txverify.DEGRADE.configure(rcfg.device_failure_limit,
                                   rcfg.device_cooldown)
        self.peers = PeerBook(self.config.node, breakers=self.breakers)
        self.started = False  # the first-request bootstrap ran
        self.self_url = self.config.node.self_url
        self.intake = IntakeCoordinator(self, _BANNED_ADDRESSES)
        self.mining_cache = MiningInfoCache()
        # txs of reorged-out blocks go back into the journal (JAX
        # app.py:188; the port's node always runs the mempool)
        self.state.reinject_reorg_txs = bool(mcfg.reinject_on_reorg)
        self.tx_cache = TTLSet(mcfg.tx_cache_size, mcfg.tx_cache_ttl)
        # the hot read cache: read routes serve stored response bytes
        # under a generation the hooks below advance after every
        # committed write, so a hit never reflects a stale tip
        self.hotcache = HotStateCache(self.state, self.config.cache)
        if self.config.cache.enabled:
            self.manager.on_state_committed = self.hotcache.bump
            self.state.on_blocks_removed = \
                lambda _from_id: self.hotcache.bump("reorg")
            # GC evictions and mined-tx removals change the pending
            # journal, which pending lists and show_pending views read
            pool_remove = self.manager.on_pending_removed

            def _pending_removed(hashes, _base=pool_remove):
                _base(hashes)
                self.hotcache.bump("pending_removed")

            self.manager.on_pending_removed = _pending_removed
        self.is_syncing = False
        # the outbound RPC client of sync, gossip and the snapshot
        # bootstrap (a test may swap it)
        self.iface_factory = NodeInterface
        # the snapshot bootstrap's progress (snapshot/client.py updates
        # it in place; /metrics exports it), and the startup
        # housekeeping: keep snapshot.keep generations and sweep the
        # staging dirs a crashed build left (never raises)
        self.snapshot_restore: dict = {}
        scfg = self.config.snapshot
        if scfg.dir:
            snapshot_layout.prune_generations(scfg.dir, keep=scfg.keep)
        # the cold-block archive: the read fallthrough on the state.
        # Archived rows are immutable, so the read cache's generation
        # does not move for them: a cached body is the same either way
        self.archive_compact: dict = {}
        if self.config.archive.dir:
            self.state.archive = ArchiveReader(
                self.config.archive.dir,
                cache_segments=self.config.archive.reader_cache_segments)
        # the rebuild cadence (snapshot.rebuild_interval_blocks): every
        # committed block ticks a counter; at the interval plus a jitter
        # seeded from the node's identity (a fleet started together does
        # not rebuild in lockstep) a rebuild is spawned off the hook
        self._snapshot_rebuild_inflight = False
        self._blocks_since_rebuild = 0
        if scfg.dir and scfg.rebuild_interval_blocks > 0:
            ident = (self.config.node.self_url
                     or f"{self.config.node.host}:{self.config.node.port}")
            jitter = max(0, scfg.rebuild_jitter_blocks)
            self._rebuild_target = scfg.rebuild_interval_blocks + (
                int.from_bytes(
                    hashlib.sha256(ident.encode()).digest()[:4], "big")
                % (jitter + 1))
            base_committed = self.manager.on_state_committed

            def _committed(_base=base_committed):
                if _base is not None:
                    _base()
                self._snapshot_rebuild_tick()

            self.manager.on_state_committed = _committed
        self._last_mempool_clean: Optional[float] = None  # monotonic
        self._closing = False
        self._background: set = set()
        self._services: set = set()  # perpetual loops (the watchtower)
        # the watchtower: rule evaluation over this node's registries
        # (the scope's, or the process globals), fed live gauges by probes
        self.watchtower = None
        if self.config.watchtower.enabled:
            self.watchtower = WatchtowerEngine(
                self.config.watchtower, scope=self.telemetry_scope,
                name=(self.telemetry_scope.name
                      if self.telemetry_scope else "node"))
            self._register_watchtower_probes()
        self.ws_hub = WsHub(self.config.ws) if self.config.ws.enabled \
            else None
        self.routes = {("GET", "/"): self.h_root}
        for path, handler in (("/push_tx", self.h_push_tx),
                              ("/push_block", self.h_push_block),
                              ("/send_to_address", self.h_send_to_address)):
            self.routes[("GET", path)] = self.routes[("POST", path)] = handler
        for path, handler in (
                ("/sync_blockchain", self.h_sync_blockchain),
                ("/get_mining_info", self.h_get_mining_info),
                ("/get_validators_info", self.h_get_validators_info),
                ("/get_delegates_info", self.h_get_delegates_info),
                ("/get_address_info", self.h_get_address_info),
                ("/get_address_transactions",
                 self.h_get_address_transactions),
                ("/add_node", self.h_add_node),
                ("/get_nodes", self.h_get_nodes),
                ("/get_pending_transactions", self.h_get_pending_transactions),
                ("/get_transaction", self.h_get_transaction),
                ("/get_block", self.h_get_block),
                ("/get_block_details", self.h_get_block_details),
                ("/get_blocks", self.h_get_blocks),
                ("/get_blocks_details", self.h_get_blocks_details),
                ("/dobby_info", self.h_dobby_info),
                ("/get_supply_info", self.h_get_supply_info),
                ("/snapshot/manifest", self.h_snapshot_manifest),
                (_CHUNK_ROUTE, self.h_snapshot_chunk),
                ("/archive/manifest", self.h_archive_manifest),
                (_SEGMENT_ROUTE, self.h_archive_segment),
                ("/metrics", self.h_metrics)):
            self.routes[("GET", path)] = handler
        if self.config.telemetry.debug_endpoints:
            self.routes[("GET", "/debug/traces")] = self.h_debug_traces
            self.routes[("GET", "/debug/events")] = self.h_debug_events
            self.routes[("GET", "/debug/alerts")] = self.h_debug_alerts
            self.routes[("POST", "/debug/alerts")] = \
                self.h_debug_alerts_post
            self.routes[("GET", "/debug/breakers")] = self.h_debug_breakers
            self.routes[("GET", "/debug/cache")] = self.h_debug_cache
            self.routes[("GET", "/debug/archive")] = self.h_debug_archive
            if self.config.profile.enabled:
                self.routes[("GET", "/debug/profile")] = self.h_debug_profile
        if self.ws_hub is not None:
            self.routes[("GET", "/ws")] = self.ws_hub.handle
        # SLO latency series for the fixed route set (not /ws, whose
        # "latency" is a socket's lifetime, and not /debug/*, which would
        # meter the metering), preregistered so every route exports an
        # all-zero family from the first scrape
        self._slo_paths = {path for _m, path in self.routes
                           if not path.startswith(("/ws", "/debug"))}
        with telemetry.scope.activate(self.telemetry_scope):
            telemetry.slo.preregister(self._slo_paths)
        self.server: Optional[HttpServer] = None

    def _register_watchtower_probes(self) -> None:
        wt = self.watchtower

        async def block_height() -> float:
            return float(await self.state.get_next_block_id() - 1)

        async def sync_lag() -> float:
            last = await self.state.get_last_block()
            return float(max(0, timestamp() - last["timestamp"])) \
                if last else 0.0

        def ws_dropped() -> float:
            hub = self.ws_hub
            return float(hub.get_stats()["dropped_messages"]) if hub else 0.0

        wt.register_probe("block_height", block_height)
        wt.register_probe("sync_lag", sync_lag)
        # the port's node always runs the mempool
        wt.register_probe("mempool_depth", lambda: float(len(self.pool)))
        wt.register_probe("ws_dropped", ws_dropped)

    # ----------------------------------------------------------- plumbing --
    def _spawn(self, coro) -> None:
        """Fire-and-forget background task, refused once close() began."""
        if self._closing:
            coro.close()
            return
        task = asyncio.ensure_future(coro)
        self._background.add(task)
        task.add_done_callback(self._background.discard)

    def _spawn_service(self, coro) -> None:
        """A long-lived service loop (the watchtower's cadence), ended
        only by close(): kept out of the background set, the work
        requests started, which a drain of that set waits for."""
        if self._closing:
            coro.close()
            return
        task = asyncio.ensure_future(coro)
        self._services.add(task)
        task.add_done_callback(self._services.discard)

    async def serve(self, host: Optional[str] = None,
                    port: Optional[int] = None) -> HttpServer:
        """Start the HTTP server (``port=0``: a free port), and the
        watchtower's loop when it is on."""
        self.server = HttpServer(
            self.handle,
            host=self.config.node.host if host is None else host,
            port=self.config.node.port if port is None else port,
            max_body=self.config.node.response_cap)
        await self.server.start()
        self.start_services()
        return self.server

    def start_services(self) -> None:
        """The node's long-lived loops (the watchtower's), which
        :meth:`serve` starts beside its server; a node served with no
        socket (the swarm's loopback transport) starts them here."""
        if self.watchtower is not None:
            self._spawn_service(self.watchtower.run())

    async def close(self) -> None:
        self._closing = True
        if self.server is not None:
            await self.server.close()
        if self.ws_hub is not None:
            self.ws_hub.close()
        # cancel AND await, bounded: a task inside run_in_executor (a
        # verify on the card) cannot be cancelled until the call returns
        tasks = list(self._background) + list(self._services)
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

    def _client_ip(self, request: Request) -> str:
        """The socket peer, or behind a trusted proxy
        (``node.trust_proxy_headers``) the rightmost ``X-Forwarded-For``
        entry, the one our proxy appended, then ``X-Real-IP``."""
        if self.config.node.trust_proxy_headers:
            xff = request.headers.get("x-forwarded-for", "")
            if xff:
                return xff.split(",")[-1].strip()
            real = request.headers.get("x-real-ip")
            if real:
                return real
        return request.peer_ip

    # ----------------------------------------------------------- gossip ---
    async def propagate(self, path: str, args: dict,
                        ignore_url: Optional[str] = None) -> None:
        """Send ``path`` to the gossip sample of the book
        (main.py:79-94), all at once, each send cut at
        ``resilience.propagate_deadline``."""
        self_base = _normalize(self.self_url)
        ignore_base = _normalize(ignore_url or "")
        deadline = self.config.resilience.propagate_deadline
        aws = []
        for node_url in self.peers.propagate_nodes():
            iface = self.iface_factory(node_url, self.config.node,
                                       resilience=self.resilience)
            if iface.base_url in (self_base, ignore_base):
                continue
            aws.append(self._propagate_one(iface, path, args, self_base,
                                           deadline))
        await asyncio.gather(*aws)

    async def _propagate_one(self, iface: NodeInterface, path: str,
                             args: dict, self_base: str,
                             deadline: float) -> None:
        try:
            await asyncio.wait_for(iface.request(path, args, self_base),
                                   deadline or None)
        except asyncio.TimeoutError:
            trace.inc("resilience.propagate_timeouts")
            # the send was cut inside the wrapper, which recorded nothing
            self.breakers.record_failure(iface.base_url)
            log.debug("propagate to %s timed out after %.1fs",
                      iface.base_url, deadline)
        except Exception as e:
            log.debug("propagate error: %s", e)

    async def _propagate_old_transactions(self) -> None:
        """Gossip again the journal txs last sent over 300 s ago."""
        for tx_hex in await self.state.get_need_propagate_transactions():
            tx_hash = hashlib.sha256(bytes.fromhex(tx_hex)).hexdigest()
            await self.state.update_pending_transaction_propagation(tx_hash)
            await self.propagate("push_tx", {"tx_hex": tx_hex})

    async def _bootstrap(self) -> None:
        """Learn the seed's peers, drop ourselves from the book, announce
        ourselves, then catch up (main.py:324-361)."""
        try:
            seeds = self.peers.recent_nodes()
            if not seeds:
                return
            iface = self.iface_factory(seeds[0], self.config.node,
                                       resilience=self.resilience)
            for url in await iface.get_nodes():
                self.peers.add(url)
            self.peers.remove(self.self_url)
            await self.propagate("add_node", {"url": self.self_url})
            self._spawn(self.sync_blockchain())
        except Exception as e:
            log.debug("bootstrap failed: %s", e)

    # -------------------------------------------------------- middleware --
    async def handle(self, request: Request) -> Response:
        """The JAX node's middleware (app.py:475-570): the node's
        telemetry scope around the whole request, then the IP filter,
        path normalisation, rate limits, peer bookkeeping and bootstrap,
        then the route under a request trace with SLO capture, then the
        old txs' gossip."""
        with telemetry.scope.activate(self.telemetry_scope):
            return await self._handle(request)

    async def _handle(self, request: Request) -> Response:
        client_ip = self._client_ip(request)
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

        sender = request.headers.get("sender-node")
        if sender:
            self.peers.add(sender)
        # the custodial send answers local clients only, by the client IP
        # (the socket peer, or the proxy's report under
        # trust_proxy_headers), not by the Host header the reference
        # gates on (main.py:315-322)
        if normalized == "/send_to_address" and not (
                client_ip and is_local_ip(client_ip)):
            return json_response(
                {"ok": False, "error": "Access forbidden. This endpoint can "
                 "only be accessed from localhost."}, status=403)
        # the first request from outside (by its Host header) bootstraps
        host = request.host.split(":")[0] if request.host else ""
        if normalized != "/get_nodes" and not self.started and \
                not (is_local_ip(host) or host == "localhost"):
            self.started = True
            if not self.self_url:
                self.self_url = f"{request.scheme}://{request.host}"
            self._spawn(self._bootstrap())

        # request-scoped trace root: inbound gossip hops adopt the peer's
        # X-Upow-Trace id, so one push_tx or push_block is one trace
        # across nodes; scrape and debug endpoints stay untraced
        traced = self.config.telemetry.trace_requests and not (
            normalized in ("/metrics", "/ws")
            or normalized.startswith("/debug"))
        # SLO latency capture on the registered routes only
        slo_t0 = time.perf_counter() if normalized in self._slo_paths \
            else None
        trace_id = None
        try:
            if traced:
                with telemetry.request_trace(
                        "http." + (normalized.strip("/") or "root"),
                        trace_id=request.headers.get(
                            telemetry.TRACE_HEADER.lower())) as troot:
                    trace_id = troot.trace_id
                    response = await self._route(request, normalized)
            else:
                response = await self._route(request, normalized)
        except _HttpError as e:  # aiohttp's, past the envelope
            return e.response
        except _BadParam as e:
            if slo_t0 is not None:
                telemetry.slo.observe_request(
                    normalized, time.perf_counter() - slo_t0, 422,
                    trace_id=trace_id)
            return json_response(
                {"ok": False, "error": f"Invalid integer parameter {e}"},
                status=422)
        except Exception as e:  # exception envelope (main.py:394-406)
            log.error("Error on %s, %s: %s", request.path, type(e).__name__,
                      e, exc_info=True)
            if slo_t0 is not None:
                telemetry.slo.observe_request(
                    normalized, time.perf_counter() - slo_t0, 500,
                    trace_id=trace_id)
            return json_response(
                {"ok": False, "error": f"Uncaught {type(e).__name__} exception"},
                status=500)
        if slo_t0 is not None:
            telemetry.slo.observe_request(
                normalized, time.perf_counter() - slo_t0, response.status,
                trace_id=trace_id)
        response.headers["Access-Control-Allow-Origin"] = "*"
        if trace_id is not None:
            response.headers[telemetry.TRACE_HEADER] = trace_id
        self._spawn(self._propagate_old_transactions())
        return response

    async def _route(self, request: Request, normalized: str) -> Response:
        """The route's handler; what aiohttp's router and body reader
        raise (404, 405 with ``Allow``, 413) raises as :class:`_HttpError`.
        aiohttp's ``add_get`` serves HEAD by the GET handler."""
        method = "GET" if request.method == "HEAD" else request.method
        route = normalized
        for template, pattern in _PARAM_ROUTES:
            match = pattern.fullmatch(normalized)
            if match is not None:
                route = template
                request.match_info = {"i": match.group(1)}
                break
            if normalized == template:
                route = None  # the template itself names no resource
                break
        handler = self.routes.get((method, route))
        if handler is None:
            allowed = {m for m, path in self.routes if path == route}
            if not allowed:
                raise HTTPNotFound(text_response("404: Not Found", 404))
            if "GET" in allowed:
                allowed.add("HEAD")
            response = text_response("405: Method Not Allowed", 405)
            response.headers["Allow"] = ",".join(sorted(allowed))
            raise HTTPMethodNotAllowed(response)
        try:
            return await handler(request)
        except BodyTooLarge as e:
            raise HTTPRequestEntityTooLarge(text_response(str(e), 413)) \
                from None

    # ------------------------------------------------------- tx intake ----
    def make_tx_verifier(self) -> TxVerifier:
        return TxVerifier(
            self.state,
            verify_mesh_devices=self.config.device.mesh_devices)

    async def accept_tx_effects(self, tx: Tx, tx_hash: str,
                                first_address: Optional[str],
                                sender: Optional[str]) -> None:
        """Post-acceptance side effects of the intake: peer bookkeeping,
        the gossip fan-out, the ``/ws`` broadcast, the dedup cache and
        the log line."""
        if sender:
            self.peers.update_last_message(sender)
        trace.event("tx_seen", hash=tx_hash)
        self._spawn(self.propagate("push_tx", {"tx_hex": tx.hex()}))
        if self.ws_hub is not None:
            amount = sum(o.amount for o in tx.outputs)
            self._spawn(self.ws_hub.broadcast_new_transaction({
                "tx_hash": tx_hash,
                "from": first_address,
                "to": [o.address for o in tx.outputs],
                "amount": _fmt_amount(amount),
                "fees": _fmt_amount(await self.state.tx_fees(tx)),
            }))
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

    # ------------------------------------------------------- read cache ---
    async def _cached(self, request: Request, entry_class: str, key: tuple,
                      build, dumps=json.dumps) -> Response:
        """A read route through the hot read cache: ``build()`` makes the
        payload, and what is stored is its encoded body (the bytes
        :func:`json_response` would send), so a hit skips SQL and
        encoding and is byte for byte the uncached body.  With the cache
        off or ``X-Upow-Cache-Bypass`` set, the plain path, which leaves
        the store alone."""
        if not self.hotcache.enabled or \
                _CACHE_BYPASS_HEADER in request.headers:
            return json_response(await build(), dumps=dumps)

        async def produce() -> bytes:
            return dumps(await build()).encode("utf-8")

        return Response(await self.hotcache.get_bytes(entry_class, key,
                                                      produce))

    # --------------------------------------------------------- handlers ---
    async def h_root(self, request: Request) -> Response:
        """Health probe (reference main.py:266-275) + additive timing
        stats from the span registry and the counters."""
        return json_response({
            "ok": True, "version": VERSION,
            "unspent_outputs_hash": await self.state.get_unspent_outputs_hash(),
            "timings": trace.stats(),
            "counters": trace.counters(),
        })

    async def h_metrics(self, request: Request) -> Response:
        """Prometheus text exposition (JAX app.py:765-1001): gauges of
        the chain, mempool, peers and breakers, the hot read cache, the
        ``/ws`` hub, the device verify path's health, the resident index
        and the mesh miner, the kernel libraries built, the card's memory
        and the kernels' counted work; the watchtower's and the archive's
        families (zeros when either is off); then every counter, span and
        histogram of the registries.  Rendering and name sanitising are
        :mod:`..telemetry.exposition`'s."""
        e = telemetry.exposition.Exposition()
        e.gauge("block_height", await self.state.get_next_block_id() - 1,
                "Height of the last accepted block")
        e.gauge("mempool_transactions",
                await self.state.get_pending_transactions_count(),
                "Transactions waiting in the mempool")
        last_block = await self.state.get_last_block()
        lag = max(0, timestamp() - last_block["timestamp"]) \
            if last_block else 0
        e.gauge("sync_lag_seconds", lag,
                "Seconds since the tip block's consensus timestamp")
        # the port's node always runs the mempool (the JAX node's
        # mempool.enabled, its default)
        e.gauge("mempool_pool_depth", len(self.pool),
                "Transactions in the in-memory fee-priority pool")
        e.gauge("mempool_pool_bytes_hex", self.pool.total_bytes_hex,
                "Total hex chars held by the in-memory pool")
        e.counter("mining_info_cache_hits", self.mining_cache.hits,
                  "Mining-info requests served from the"
                  " generation-keyed cache")
        e.counter("mining_info_cache_misses", self.mining_cache.misses,
                  "Mining-info requests that rebuilt the template")
        e.gauge("peers_known", len(self.peers.all_nodes()),
                "Peers in the peer book")
        e.gauge("peers_active", len(self.peers.recent_nodes()),
                "Peers messaged within the activity window")
        e.gauge("node_syncing", int(bool(self.is_syncing)),
                "1 while a chain sync is in progress")
        snapshot_gen = self._snapshot_gen()
        if snapshot_gen is not None:
            m = snapshot_gen[1]
            e.gauge("snapshot_published_height", m["anchor_height"],
                    "Anchor height of the published snapshot generation")
            e.gauge("snapshot_published_chunks", len(m["chunks"]),
                    "Chunks in the published snapshot generation")
            e.gauge("snapshot_published_bytes", m["payload_bytes"],
                    "Payload bytes of the published snapshot generation")
        if self.snapshot_restore:
            sr = self.snapshot_restore
            e.gauge("snapshot_restore_chunks_total", sr.get("total", 0),
                    "Chunks the in-progress/last snapshot restore needs")
            e.gauge("snapshot_restore_chunks_verified", sr.get("verified", 0),
                    "Chunks verified by the current restore pass")
            e.gauge("snapshot_restore_chunks_reused", sr.get("reused", 0),
                    "Verified chunks reused from the journal (not"
                    " re-downloaded) by the current restore pass")
        # archive families are emitted unconditionally (zeros when the
        # tier is off) so the scrape's family set does not depend on it
        ast = self.state.archive.stats() if self.state.archive else {}
        e.gauge("archive_segments", ast.get("segments", 0),
                "Published cold-archive segments")
        e.gauge("archive_archived_blocks", ast.get("archived_blocks", 0),
                "Blocks held by the published archive manifest")
        e.gauge("archive_archived_txs", ast.get("archived_txs", 0),
                "Transactions held by the published archive manifest")
        e.counter("archive_hot_rows_pruned",
                  (self.archive_compact.get("pruned_blocks", 0)
                   + self.archive_compact.get("pruned_txs", 0))
                  if self.archive_compact.get("ok") else 0,
                  "Hot block+tx rows deleted by the last compaction")
        e.counter("archive_fallthrough_reads",
                  ast.get("fallthrough_reads", 0),
                  "Reads served from archive segments after a hot miss")
        sig = sig_verdict_stats()
        e.gauge("sig_cache_entries", sig["size"],
                "Entries in the signature-verdict cache")
        e.counter("sig_cache_hits", sig["hits"],
                  "Signature checks answered from the verdict cache")
        e.counter("sig_cache_misses", sig["misses"],
                  "Signature checks that required verification")
        if self.hotcache.enabled:
            cs = self.hotcache.stats()
            e.counter("hotcache_hits", cs["hits"],
                      "Read responses served from the hot-state cache")
            e.counter("hotcache_misses", cs["misses"],
                      "Read responses rebuilt from storage")
            e.counter("hotcache_evictions", cs["evictions"],
                      "Entries evicted by per-class LRU byte caps")
            e.counter("hotcache_singleflight_coalesced",
                      cs["singleflight_coalesced"],
                      "Concurrent identical misses that shared one"
                      " storage trip")
            e.counter("hotcache_generation_bumps", cs["bumps"],
                      "Local generation advances (block accept, reorg,"
                      " pending-journal change)")
            e.counter("hotcache_foreign_bumps", cs["foreign_bumps"],
                      "Generation advances forced by another worker's"
                      " write (journal-stamp revalidation)")
            e.gauge("hotcache_generation", cs["generation"],
                    "Current read-cache generation epoch")
            e.gauge("hotcache_generation_age_seconds",
                    cs["generation_age_seconds"],
                    "Seconds since the generation last advanced")
            e.gauge("hotcache_entries",
                    sum(c["entries"] for c in cs["classes"].values()),
                    "Entries across all hot-state cache classes")
            e.gauge("hotcache_bytes",
                    sum(c["bytes"] for c in cs["classes"].values()),
                    "Encoded response bytes held by the hot-state cache")
        if self.ws_hub is not None:
            ws = self.ws_hub.get_stats()
            e.gauge("ws_connections", ws["total_connections"],
                    "Open WebSocket push connections")
            e.gauge("ws_messages_out", ws["messages_out"],
                    "WebSocket messages delivered")
            e.counter("ws_connects_total", ws["connects_total"],
                      "WebSocket connections accepted since start")
            e.counter("ws_disconnects_total", ws["disconnects_total"],
                      "WebSocket connections dropped since start")
            e.counter("ws_dropped_messages", ws["dropped_messages"],
                      "Broadcast messages shed by per-subscriber bounded"
                      " send queues (drop-slowest policy)")
            e.gauge("ws_send_queue_hwm", ws["send_queue_hwm"],
                    "Deepest any subscriber send queue has ever been"
                    " (high-watermark, including reaped connections)")
        for state_name, count in sorted(self.breakers.state_counts().items()):
            e.gauge(f"breaker_{state_name}_peers", count,
                    f"Peers whose circuit breaker is {state_name}")
        e.gauge("device_verify_health",
                self.manager.device_health()["gauge"],
                "Device verify path: 0=ok 1=degraded(CPU) 2=poisoned")
        index_stats = self.state.index_stats()
        if index_stats is not None:
            e.gauge("utxo_index_entries", index_stats["entries"],
                    "Live outpoints across the HBM-resident UTXO"
                    " index tables")
            e.gauge("utxo_index_resident_bytes",
                    index_stats["resident_bytes"],
                    "Device bytes held by the resident UTXO index")
            e.gauge("utxo_index_twin_fingerprints",
                    index_stats["twin_fingerprints"],
                    "Fingerprints that ever held two live outpoints"
                    " (forces shadow consult on hit)")
            e.counter("utxo_index_probes", index_stats["probes"],
                      "Resident-index membership probe dispatches")
            e.counter("utxo_index_shadow_consults",
                      index_stats["shadow_consults"],
                      "Probes answered by the host shadow map"
                      " (ambiguity; steady-state target is zero)")
        # read the mesh engine's stats only when the process loaded it
        mesh_mod = sys.modules.get("upow_tpu_torch.mine.mesh_engine")
        mesh_stats = mesh_mod.engine_stats() if mesh_mod else None
        if mesh_stats is not None:
            e.gauge("mine_mesh_shards", mesh_stats["devices"],
                    "Devices in the resident mesh search program"
                    " (0 = engine built but not yet armed)")
            e.gauge("mine_mesh_batch_per_shard",
                    mesh_stats["batch_per_device"],
                    "Nonces per shard per round in the resident"
                    " search program")
            e.gauge("mine_mesh_armed", int(mesh_stats["armed"]),
                    "Resident mesh engine armed (compiled + warm)")
            e.counter("mine_mesh_rounds", mesh_stats["dispatches"],
                      "Mesh search rounds dispatched through the"
                      " device runtime")
        e.gauge("mine_mesh_configured_devices",
                self.config.device.mesh_devices,
                "config.device.mesh_devices (0 = all visible)")
        cache_entries = _build.entry_count()
        if cache_entries >= 0:
            e.gauge("compile_cache_persistent_entries", cache_entries,
                    "Kernel libraries built in upow_tpu_torch/_build/")
        for label, mem in sorted(telemetry.device.device_memory().items()):
            for key, value in sorted(mem.items()):
                e.gauge(f"device_{label}_{key}", value,
                        "Best-effort device memory_stats() value")
        # the kernels' counted work (profiling.analyze_cost), next to
        # the compile-cache counters they contextualize
        for kern, costs in sorted(telemetry.device.cost_estimates().items()):
            for key, value in sorted(costs.items()):
                e.gauge(f"kernel_{kern}_cost_{key}", value,
                        "Counted work of the kernel's last batch")
        # the alert families export whether or not the watchtower runs
        # (zeros when it is off)
        wt = self.watchtower
        wrow = wt.metric_rows() if wt is not None else {}
        e.gauge("alert_firing", wrow.get("firing", 0),
                "Alerts currently firing (docs/ALERTING.md)")
        e.gauge("alert_pending", wrow.get("pending", 0),
                "Alert conditions inside their for-duration")
        e.gauge("alert_silenced", wrow.get("silenced", 0),
                "Active alerts suppressed by an operator silence")
        e.gauge("alert_exemplars_firing",
                wrow.get("firing_with_exemplars", 0),
                "Firing alerts carrying at least one exemplar trace id")
        e.gauge("alert_eval_lag_seconds",
                wrow.get("eval_lag_seconds", 0.0),
                "Wall seconds the last watchtower evaluation tick took")
        e.counter("alert_evaluations", wrow.get("evaluations", 0),
                  "Watchtower evaluation ticks since start")
        e.counter("alert_fired", wrow.get("fired_total", 0),
                  "pending->firing transitions since start")
        e.counter("alert_resolved", wrow.get("resolved_total", 0),
                  "firing->resolved transitions since start")
        if wt is not None:
            by_rule: dict = {}
            for a in wt.alerts.active():
                d = by_rule.setdefault(a.rule.name,
                                       {"firing": 0, "pending": 0})
                if a.state in d:
                    d[a.state] += 1
            for rname, rule in sorted(wt.rules.items()):
                d = by_rule.get(rname, {"firing": 0, "pending": 0})
                e.gauge(f"alert_rule_{rname}_{rule.severity}_firing",
                        d["firing"], f"Firing alerts for rule {rname}")
                e.gauge(f"alert_rule_{rname}_{rule.severity}_pending",
                        d["pending"], f"Pending alerts for rule {rname}")
        for name, value in sorted(trace.counters().items()):
            e.counter(name, value)
        for name, st in sorted(trace.stats().items()):
            e.span_stats(name, st)
        for name, h in sorted(trace.histograms().items()):
            e.histogram(name, h["bounds"], h["counts"],
                        h["count"], h["sum"],
                        exemplars=h.get("exemplars"))
        return Response(e.render().encode(), 200,
                        content_type=telemetry.exposition.CONTENT_TYPE)

    async def h_push_tx(self, request: Request) -> Response:
        if self.is_syncing:
            return json_response(_SYNCING)
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
        return json_response(await self._submit_tx(
            tx, request.headers.get("sender-node")))

    async def _submit_tx(self, tx: Tx, sender: Optional[str]) -> dict:
        """Admit one tx through the coalescing intake (it joins the
        current micro-batch and shares its signature dispatch)."""
        result = await self.intake.submit(tx, sender)
        if result.get("ok"):
            # the pending journal gained a row: cached pending lists and
            # show_pending views are stale
            self.hotcache.bump("pending_added")
        return result

    async def h_send_to_address(self, request: Request) -> Response:
        """Localhost-only custodial send (main.py:481-518): the wallet
        keystore in the working directory is looked up by the
        ``Authorization`` address; the tx is built by the wallet's
        builder and admitted as ``push_tx`` admits one."""
        params = self._params(request)
        to_address = params.get("to_address")
        amount = params.get("amount")
        if not to_address or not amount:
            return json_response(
                {"ok": False, "error": "Missing required params."}, status=422)
        private_key = KeyStore().private_key_for_public(
            request.headers.get("authorization"))
        if private_key is None:
            return json_response({"ok": False, "error": "Unauthorized"})
        try:
            tx = await WalletBuilder(self.state).create_transaction(
                private_key, to_address, Decimal(str(amount)))
        except Exception as e:
            log.debug("send_to_address: tx build failed: %s", e)
            return json_response({"ok": False, "error": str(e)})
        return json_response(await self._submit_tx(
            tx, request.headers.get("sender-node")))

    async def _parse_tx(self, tx_hex: str,
                        overlay: Optional[dict] = None) -> Tx:
        """Decode, resolving the ambiguous-signature relink against
        state (core/tx.py tx_from_hex needs a sync resolver); only the
        ambiguous layout pays the signature-free pre-parse.  ``overlay``
        maps tx_hash -> parsed Tx for sources not yet in state (earlier
        blocks of the same sync page)."""
        try:
            return tx_from_hex(tx_hex, check_signatures=True)
        except AmbiguousSignatureError:
            pass
        tx = tx_from_hex(tx_hex, check_signatures=False)
        addrs = {}
        for i in tx.inputs:
            src = overlay.get(i.tx_hash) if overlay else None
            if src is not None and 0 <= i.index < len(src.outputs):
                addrs[(i.tx_hash, i.index)] = src.outputs[i.index].address
            else:
                addrs[(i.tx_hash, i.index)] = (
                    await self.state.resolve_output_address(i.tx_hash,
                                                            i.index))
        return tx_from_hex(
            tx_hex, check_signatures=True,
            resolve_address=lambda h, idx: addrs.get((h, idx)))

    async def h_push_block(self, request: Request) -> Response:
        if self.is_syncing:
            return json_response(_SYNCING)
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
                    self._spawn(self.sync_blockchain(sender))
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
            self._spawn(self.sync_blockchain(sender))
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
                    self._spawn(self.sync_blockchain(sender))
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
        if self.ws_hub is not None:
            block_hash = hashlib.sha256(
                bytes.fromhex(block_content)).hexdigest()
            info = await self._mining_info_result()
            self._spawn(self.ws_hub.broadcast_new_block({
                "block_no": block_no,
                "block_hash": block_hash,
                "transactions_count": len(final_transactions),
                "timestamp": timestamp(),
                **info,
            }))
        if sender:
            self.peers.update_last_message(sender)
        self._spawn(self.propagate("push_block", {
            "block_content": block_content,
            "txs": ([tx.hex() for tx in final_transactions]
                    if len(final_transactions) < 10 else txs),
            "block_no": block_no,
        }))
        return json_response({"ok": True})

    async def h_sync_blockchain(self, request: Request) -> Response:
        if self.is_syncing:
            return json_response(_SYNCING)
        resp = await self.sync_blockchain(request.query.get("node_url"))
        body = {"ok": resp["ok"]}
        if not resp["ok"]:
            body["error"] = resp["error"]
        if resp["peer"]:
            body["peer"] = resp["peer"]
        return json_response(body)

    async def h_get_mining_info(self, request: Request) -> Response:
        return json_response(
            {"ok": True, "result": await self._mining_info_result()})

    async def h_get_pending_transactions(self, request: Request) -> Response:
        async def build():
            txs = await self.state.get_pending_transactions_limit(
                hex_only=True)
            return {"ok": True, "result": txs}

        return await self._cached(request, "pending", (), build)

    async def h_get_transaction(self, request: Request) -> Response:
        tx_hash = request.query.get("tx_hash", "")

        async def build():
            tx = await self.state.get_nice_transaction(tx_hash)
            if tx is None:
                return {"ok": False, "error": "Transaction not found"}
            return {"ok": True, "result": tx}

        return await self._cached(request, "tx", (tx_hash,), build)

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

        async def build():
            info = await self._block_lookup(block)
            if not info:
                return {"ok": False, "error": "Block not found"}
            block_hash = info["hash"]
            return {"ok": True, "result": {
                "block": _json_block(info),
                "transactions": (
                    await self.state.get_block_transactions(block_hash,
                                                            hex_only=True)
                    if not full else None),
                "full_transactions": (
                    await self.state.get_block_nice_transactions(block_hash)
                    if full else None),
            }}

        return await self._cached(request, "block", ("block", block, full),
                                  build)

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

        async def build():
            blocks = await self.state.get_blocks(offset, limit,
                                                 size_capped=True)
            return {"ok": True, "result": blocks}

        return await self._cached(request, "blocks",
                                  ("blocks", offset, limit), build)

    async def h_get_blocks_details(self, request: Request) -> Response:
        q = request.query
        offset, err = self._page_param(q, "offset", 0, 2 ** 63 - 1)
        if err is None:
            limit, err = self._page_param(q, "limit", 100, 1000)
        if err is not None:
            return err

        async def build():
            blocks = await self.state.get_blocks(offset, limit,
                                                 tx_details=True,
                                                 size_capped=True)
            return {"ok": True, "result": blocks}

        return await self._cached(request, "blocks",
                                  ("details", offset, limit), build)

    async def h_get_block_details(self, request: Request) -> Response:
        block = request.query.get("block", "")

        async def build():
            info = await self._block_lookup(block)
            if not info:
                return {"ok": False, "error": "Block not found"}
            txs = await self.state.get_block_nice_transactions(info["hash"])
            return {"ok": True, "result": {
                "block": _json_block(info), "transactions": txs}}

        return await self._cached(request, "block", ("details", block),
                                  build)

    # ---------------------------------------- explorer and governance ----
    async def h_get_validators_info(self, request: Request) -> Response:
        """Inode ballot grouped by voting validator (main.py:698-725)."""
        q = request.query
        inode = q.get("inode")
        offset = _int_q(q, "offset", 0)
        limit = _int_q(q, "limit", 100, cap=1000)

        async def build():
            rows = await self.state.get_ballots(
                "inodes_ballot", inode, offset=offset, limit=limit)
            by_validator: dict = {}
            stakes: dict = {}  # one stake computation per validator
            for row in rows:
                ent = by_validator.setdefault(row["voter"], {
                    "validator": row["voter"], "vote": []})
                ent["vote"].append(_vote(row))
                if row["voter"] not in stakes:
                    stakes[row["voter"]] = str(
                        await self.state.get_validators_stake(
                            row["voter"], check_pending_txs=True))
                ent["totalStake"] = stakes[row["voter"]]
            return list(by_validator.values())

        return await self._cached(request, "governance",
                                  ("validators", inode, offset, limit),
                                  build)

    async def h_get_delegates_info(self, request: Request) -> Response:
        """Validator ballot grouped by voting delegate (main.py:727-764)."""
        q = request.query
        validator = q.get("validator")
        offset = _int_q(q, "offset", 0)
        limit = _int_q(q, "limit", 100, cap=1000)

        async def build():
            rows = await self.state.get_ballots(
                "validators_ballot", validator, offset=offset, limit=limit)
            stakes = await self.state.get_multiple_address_stakes(
                {row["voter"] for row in rows if row["voter"]},
                check_pending_txs=True)
            by_delegate: dict = {}
            for row in rows:
                ent = by_delegate.setdefault(row["voter"], {
                    "delegate": row["voter"], "vote": [], "totalStake": "0"})
                ent["vote"].append(_vote(row))
                ent["totalStake"] = str(stakes.get(row["voter"], Decimal(0)))
            return list(by_delegate.values())

        return await self._cached(request, "governance",
                                  ("delegates", validator, offset, limit),
                                  build)

    async def h_get_address_info(self, request: Request) -> Response:
        q = request.query
        address = q.get("address")
        if not address:
            return json_response(
                {"ok": False, "error": "Missing address"}, status=422)

        def flag(name):
            return q.get(name, "false").lower() in ("1", "true", "yes")

        def out_list(rows):
            return [{"amount": _fmt_amount(r["amount"]),
                     "tx_hash": r["tx_hash"], "index": r["index"]}
                    for r in rows]

        def vote_list(rows):
            return [{"amount": str(r["vote"]), "tx_hash": r["tx_hash"],
                     "index": r["index"]} for r in rows]

        async def build():
            state = self.state
            outputs = await state.get_spendable_outputs(address)
            stake = await state.get_address_stake(address)
            result = {
                "balance": _fmt_amount(sum(o.amount for o in outputs)),
                "stake": str(stake),
                "spendable_outputs": [
                    {"amount": _fmt_amount(o.amount), "tx_hash": o.tx_hash,
                     "index": o.index} for o in outputs],
                "pending_transactions": None,
                "pending_spent_outputs": None,
                "stake_outputs": None,
                "delegate_spent_votes": None,
                "delegate_unspent_votes": None,
                "inode_registration_outputs": None,
                "validator_unspent_votes": None,
                "validator_spent_votes": None,
                "is_inode": None,
                "is_inode_active": None,
                "is_validator": None,
            }
            if flag("show_pending"):
                result["pending_transactions"] = [
                    await state.get_nice_transaction(
                        tx.hash(), address if flag("verify") else None)
                    for tx in await state.get_address_pending_transactions(
                        address)]
                result["pending_spent_outputs"] = [
                    {"tx_hash": h, "index": i} for h, i in
                    await state.get_address_pending_spent_outpoints(address)]
            if flag("stake_outputs"):
                result["stake_outputs"] = out_list(
                    await state.get_outputs_by_address(
                        "unspent_outputs", address, is_stake=True))
            if flag("delegate_spent_votes"):
                result["delegate_spent_votes"] = vote_list(
                    await state.get_delegates_spent_votes(address))
            if flag("delegate_unspent_votes"):
                result["delegate_unspent_votes"] = out_list(
                    await state.get_outputs_by_address(
                        "delegates_voting_power", address))
            if flag("inode_registration_outputs"):
                result["inode_registration_outputs"] = out_list(
                    await state.get_outputs_by_address(
                        "inode_registration_output", address))
            if flag("validator_unspent_votes"):
                result["validator_unspent_votes"] = out_list(
                    await state.get_outputs_by_address(
                        "validators_voting_power", address))
            if flag("validator_spent_votes"):
                result["validator_spent_votes"] = vote_list(
                    await state.get_validators_spent_votes(address))
            if flag("address_state"):
                is_inode = await state.is_inode_registered(address)
                result["is_inode"] = is_inode
                result["is_inode_active"] = is_inode and any(
                    e.get("wallet") == address
                    for e in await self.manager.get_active_inodes_cached())
                result["is_validator"] = await state.is_validator_registered(
                    address)
            return {"ok": True, "result": result}

        key = (address,) + tuple(flag(n) for n in _ADDRESS_INFO_FLAGS)
        return await self._cached(request, "address", key, build)

    async def h_get_address_transactions(self, request: Request) -> Response:
        q = request.query
        page, err = self._page_param(q, "page", 1, 2 ** 63 - 1)
        if err is None:
            limit, err = self._page_param(q, "limit", 5, 1000)
        if err is not None:
            return err
        # the product can pass int64 with both factors clamped
        offset = min((max(page, 1) - 1) * limit, 2 ** 63 - 1)
        address = q.get("address")

        async def build():
            rows = await self.state.get_address_transactions(
                address, limit=limit, offset=offset)
            return {"ok": True, "result": {"transactions": [
                await self.state.get_nice_transaction(r["tx_hash"])
                for r in rows]}}

        return await self._cached(request, "history",
                                  (address, limit, offset), build)

    async def h_dobby_info(self, request: Request) -> Response:
        data = [
            {**item, "emission": f"{item['emission']:.2f}%"
             if isinstance(item["emission"], Decimal)
             else str(item["emission"]) + "%"}
            for item in await self.manager.get_active_inodes_cached()]
        return json_response({"ok": True, "result": data}, dumps=_json_dumps)

    async def h_get_supply_info(self, request: Request) -> Response:
        async def build():
            last_block = await self.state.get_last_block()
            last_id = last_block["id"] if last_block else 0
            return {"ok": True, "result": {
                "max_supply": float(MAX_SUPPLY),
                "circulating_supply": float(get_circulating_supply(last_id)),
                "last_block": _json_block(last_block),
            }}

        return await self._cached(request, "supply", (), build)

    # ------------------------------------------------------- snapshots ---
    # Served ONLY from the published on-disk generation (manifest and
    # chunk files), never the database, and not through the read cache:
    # a restoring peer must not contend with block accept, and never
    # needs a cache-bypass header to get the authoritative bytes.

    def _snapshot_gen(self):
        """(gen dir, manifest) of the published generation, or None."""
        root = self.config.snapshot.dir
        if not root:
            return None
        gen = snapshot_layout.current_gen_dir(root)
        if gen is None:
            return None
        manifest = snapshot_layout.read_manifest(
            os.path.join(gen, snapshot_layout.MANIFEST_NAME))
        if manifest is None:
            return None
        return gen, manifest

    @staticmethod
    async def _snapshot_serve_fault(key: str) -> Optional[Response]:
        """Fire the ``snapshot.serve`` fault site; a 503 keeps an
        injected serve fault inside ordinary peer-error handling."""
        injector = faultinject.get_injector()
        if injector is not None:
            try:
                await injector.fire("snapshot.serve", key)
            except faultinject.FaultInjected:
                return json_response(
                    {"ok": False,
                     "error": "snapshot temporarily unavailable"},
                    status=503)
        return None

    async def h_snapshot_manifest(self, request: Request) -> Response:
        fault = await self._snapshot_serve_fault("manifest")
        if fault is not None:
            return fault
        gen = self._snapshot_gen()
        if gen is None:
            return json_response(
                {"ok": False, "error": "no snapshot available"}, status=404)
        trace.inc("snapshot.manifest_served")
        return json_response({"ok": True, "result": gen[1]})

    async def h_snapshot_chunk(self, request: Request) -> Response:
        try:
            i = int(request.match_info["i"])
        except (KeyError, ValueError):
            return json_response(
                {"ok": False, "error": "chunk index must be an integer"},
                status=422)
        fault = await self._snapshot_serve_fault(f"chunk/{i}")
        if fault is not None:
            return fault
        gen = self._snapshot_gen()
        if gen is None or not 0 <= i < len(gen[1]["chunks"]):
            return json_response(
                {"ok": False, "error": "no such chunk"}, status=404)
        chunk_file = os.path.join(gen[0], snapshot_layout.chunk_name(i))

        def read() -> bytes:
            with open(chunk_file, "rb") as fh:
                return fh.read()
        try:
            # chunks are up to 16 MiB: off the loop thread
            data = await asyncio.get_running_loop().run_in_executor(
                None, read)
        except OSError:
            return json_response(
                {"ok": False, "error": "no such chunk"}, status=404)
        injector = faultinject.get_injector()
        if injector is not None:  # corrupt-kind rules rewrite payloads
            data = injector.fire_mutate("snapshot.serve", f"chunk/{i}", data)
        trace.inc("snapshot.chunks_served")
        return json_response(
            {"ok": True, "result": {"i": i, "data": data.hex()}})

    async def build_snapshot(self) -> Optional[dict]:
        """Build and publish a generation under ``snapshot.dir``; None
        when the subsystem is off or the chain is empty."""
        scfg = self.config.snapshot
        if not scfg.dir:
            return None
        return await snapshot_builder.build_snapshot(
            self.state, scfg.dir, chunk_bytes=scfg.chunk_bytes,
            blocks_tail=scfg.blocks_tail, keep=scfg.keep)

    async def bootstrap_from_snapshot(self, sources=None) -> dict:
        """Onboard this node from a peer's snapshot, falling back to full
        block replay (``sync_blockchain``) with a structured reason when
        the restore cannot complete.  ``sources`` (peer URLs) overrides
        peer selection; by default the peers in the health order sync
        uses.  A resident index that cannot be rebuilt after the restore
        raises :class:`~..state.device_index.IndexRearmError` instead:
        no replay, no SQL."""
        scfg = self.config.snapshot
        if sources is None:
            sources = self.peers.ranked(self.peers.recent_nodes())
        reason = detail = ""
        if not scfg.dir:
            reason = "snapshot_disabled"
        elif not sources:
            reason = "no_sources"
        else:
            ifaces = [self.iface_factory(url, self.config.node,
                                         resilience=self.resilience)
                      for url in sources]
            try:
                result = await snapshot_client.bootstrap_from_snapshot(
                    self.state, ifaces, scfg.dir,
                    chunk_retries=scfg.chunk_retries,
                    progress=self.snapshot_restore,
                    max_chunks=scfg.max_chunks,
                    max_chunk_bytes=scfg.max_chunk_bytes,
                    max_payload_bytes=scfg.max_payload_bytes)
                # the restored state invalidates everything derived from it
                self.hotcache.bump("snapshot_restore")
                self.manager.invalidate_difficulty()
                return {"ok": True, **result}
            except snapshot_client.SnapshotError as e:
                reason, detail = e.reason, e.detail
                if reason == "restored_state_mismatch":
                    # the client wiped the unproven restore back to a
                    # blank chain: derived caches must not outlive it
                    self.hotcache.bump("snapshot_restore")
                    self.manager.invalidate_difficulty()
            finally:
                for iface in ifaces:
                    await iface.close()
        trace.inc("snapshot.fallbacks")
        telemetry.event("snapshot_fallback", reason=reason,
                        detail=detail or None)
        log.warning("snapshot bootstrap failed (%s); falling back to"
                    " full replay", reason)
        sync = await self.sync_blockchain()
        return {"ok": bool(sync.get("ok")), "method": "replay_fallback",
                "reason": reason, "sync": sync}

    # --------------------------------------------------------- archive ---
    # Served from disk like /snapshot/*: the bytes come straight from the
    # published manifest and segment files, not through the read cache
    # (a peer verifying content hashes needs the store's truth, with no
    # cache-bypass header).

    async def _archive_manifest(self) -> Optional[dict]:
        reader = self.state.archive
        if not self.config.archive.dir or reader is None:
            return None
        return await asyncio.get_running_loop().run_in_executor(
            None, reader.store.current_manifest)

    async def h_archive_manifest(self, request: Request) -> Response:
        manifest = await self._archive_manifest()
        if manifest is None:
            return json_response(
                {"ok": False, "error": "no archive available"}, status=404)
        trace.inc("archive.manifest_served")
        return json_response({"ok": True, "result": manifest})

    async def h_archive_segment(self, request: Request) -> Response:
        try:
            i = int(request.match_info["i"])
        except (KeyError, ValueError):
            return json_response(
                {"ok": False, "error": "segment index must be an integer"},
                status=422)
        manifest = await self._archive_manifest()
        if manifest is None or not 0 <= i < len(manifest["segments"]):
            return json_response(
                {"ok": False, "error": "no such segment"}, status=404)
        record = manifest["segments"][i]
        try:
            # segments can be tens of MB: off the loop thread
            data = await asyncio.get_running_loop().run_in_executor(
                None, self.state.archive.store.read_payload,
                record["name"])
        except OSError:
            return json_response(
                {"ok": False, "error": "no such segment"}, status=404)
        trace.inc("archive.segments_served")
        return json_response(
            {"ok": True, "result": {"i": i, "name": record["name"],
                                    "data": data.hex()}})

    async def h_debug_archive(self, request: Request) -> Response:
        reader = self.state.archive
        if reader is None:
            return json_response(
                {"ok": False, "error": "archive disabled"}, status=404)
        await reader.coverage()  # stats() reads the cached manifest
        return json_response({"ok": True, "result": {
            "reader": reader.stats(),
            "last_compaction": self.archive_compact,
            "hot_rows": await self.state.archive_hot_row_counts(),
        }}, dumps=_json_dumps)

    async def compact_archive(self) -> dict:
        """One compaction cycle against the newest published snapshot
        generation (``archive/compactor.py``; crash-safe, idempotent)."""
        acfg = self.config.archive
        if not acfg.dir or not self.config.snapshot.dir:
            return {"ok": False, "reason": "archive_disabled"}
        stats = await archive_compactor.compact(
            self.state, acfg.dir, self.config.snapshot.dir, acfg,
            reader=self.state.archive)
        self.archive_compact = stats
        return stats

    async def fetch_archive_from_peer(self, source: str) -> dict:
        """Mirror a peer's archive (the deep-history sync feed)."""
        acfg = self.config.archive
        if not acfg.dir:
            return {"ok": False, "reason": "archive_disabled"}
        iface = self.iface_factory(source, self.config.node,
                                   resilience=self.resilience)
        try:
            result = await fetch_archive(
                iface, acfg.dir,
                max_segment_bytes=acfg.max_segment_bytes,
                max_segments=acfg.max_segments)
        except (ArchiveFetchError, ConnectionError, asyncio.TimeoutError,
                OSError) as e:
            return {"ok": False, "reason": str(e)}
        finally:
            await iface.close()
        if self.state.archive is not None:
            self.state.archive.invalidate()
        return result

    def _snapshot_rebuild_tick(self) -> None:
        """Committed-block hook: arm a background snapshot rebuild every
        ``rebuild_interval_blocks`` plus the jitter."""
        self._blocks_since_rebuild += 1
        if (self._blocks_since_rebuild >= self._rebuild_target
                and not self._snapshot_rebuild_inflight):
            self._blocks_since_rebuild = 0
            self._snapshot_rebuild_inflight = True
            self._spawn(self._snapshot_rebuild())

    async def _snapshot_rebuild(self) -> None:
        """One background rebuild, then the archive compaction the new
        generation enables (with ``archive.dir`` set)."""
        try:
            if await self.build_snapshot() is not None:
                trace.inc("snapshot.auto_rebuilds")
            if self.config.archive.dir:
                await self.compact_archive()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("background snapshot rebuild failed: %s", e)
        finally:
            self._snapshot_rebuild_inflight = False

    # ------------------------------------------------------------ peers ---
    async def h_add_node(self, request: Request) -> Response:
        url = request.query.get("url", "").strip("/")
        if not url:
            return json_response(
                {"ok": False, "error": "Missing url"}, status=422)
        if _normalize(url) == _normalize(self.self_url):
            return json_response(
                {"ok": False, "error": "Recursively adding node"})
        if self.peers.contains(url):
            return json_response(
                {"ok": False, "error": "Node already present"})
        # one quick attempt, outside the breakers: the candidate may never
        # be admitted to the book
        try:
            await self.iface_factory(url, self.config.node).get("")
        except Exception as e:
            log.debug("add_node: probe of %s failed: %s", url, e)
            return json_response({"ok": False, "error": "Could not add node"})
        self._spawn(self.propagate("add_node", {"url": url}, ignore_url=url))
        self.peers.add(url)
        return json_response({"ok": True, "result": "Node added"})

    async def h_get_nodes(self, request: Request) -> Response:
        return json_response(
            {"ok": True, "result": self.peers.recent_nodes()[:100]})

    # -------------------------------------------------------------- debug --
    # cap on debug ``limit`` params: far above any configurable ring
    # size, so a clamped value never truncates a legitimate request
    _DEBUG_LIMIT_CAP = 100_000

    @classmethod
    def _debug_limit(cls, params, default: int = 0):
        """A debug endpoint's ``limit``: (value, None) or (None, 400
        response).  Negative values clamp to 0 (everything), oversized
        ones to the cap."""
        raw = params.get("limit")
        if raw is None or raw == "":
            return default, None
        try:
            value = int(raw)
        except ValueError:
            return None, json_response(
                {"ok": False, "error": "limit must be an integer"},
                status=400)
        return max(0, min(value, cls._DEBUG_LIMIT_CAP)), None

    async def h_debug_traces(self, request: Request) -> Response:
        """Completed trace trees: recency ring + slowest top-N.
        ``limit`` bounds both lists (0 = all)."""
        limit, err = self._debug_limit(request.query)
        if err is not None:
            return err
        result = telemetry.traces()
        if limit:
            result = {"recent": result.get("recent", [])[-limit:],
                      "slowest": result.get("slowest", [])[:limit]}
        return json_response({"ok": True, "result": result})

    async def h_debug_events(self, request: Request) -> Response:
        """The structured event ring, oldest first, each record stamped
        with the trace id active when it fired and a monotonic ``seq``;
        ``since=<seq>`` reads incrementally (``next_seq``, ``missed``)."""
        params = request.query
        limit, err = self._debug_limit(params)
        if err is not None:
            return err
        kind = params.get("kind")
        since_raw = params.get("since")
        if since_raw is not None and since_raw != "":
            try:
                since_v = int(since_raw)
            except ValueError:
                return json_response(
                    {"ok": False, "error": "since must be an integer"},
                    status=400)
            got = telemetry.events.since(since_v, limit=limit or None,
                                         kind=kind)
            return json_response({
                "ok": True, "result": got["events"],
                "next_seq": got["next_seq"], "missed": got["missed"]})
        return json_response({
            "ok": True,
            "result": telemetry.events.snapshot(limit=limit or None,
                                                kind=kind)})

    async def h_debug_alerts(self, request: Request) -> Response:
        """The watchtower, read-only: the rule pack, the active alerts
        with their exemplar trace ids, the transition history and the
        burn-rate readings; ``{"enabled": false}`` when it is off.  The
        operator knobs are on POST."""
        wt = self.watchtower
        if wt is None:
            return json_response({"ok": True, "result": {"enabled": False}})
        result = wt.snapshot()
        result["enabled"] = True
        return json_response({"ok": True, "result": result})

    async def h_debug_alerts_post(self, request: Request) -> Response:
        """The watchtower's operator knobs: ``silence=<key>&seconds=<s>``,
        ``unsilence=<key>``, ``ack=<key>``, as query parameters or a JSON
        body (the body wins); answers the snapshot after them with an
        ``actions`` record of what was applied."""
        wt = self.watchtower
        if wt is None:
            return json_response({"ok": True, "result": {"enabled": False}})
        q = dict(request.query)
        if request.body_size:
            try:
                body = request.json()
            except ValueError:
                return json_response(
                    {"ok": False, "error": "body must be JSON"}, status=400)
            if not isinstance(body, dict):
                return json_response(
                    {"ok": False, "error": "body must be a JSON object"},
                    status=400)
            q.update({k: v for k, v in body.items() if v is not None})
        actions = {}
        key = q.get("silence")
        if key:
            try:
                secs = float(q.get("seconds", 300))
            except (TypeError, ValueError):
                return json_response(
                    {"ok": False, "error": "seconds must be a number"},
                    status=400)
            wt.silence(str(key), secs)
            actions["silenced"] = key
        key = q.get("unsilence")
        if key:
            wt.alerts.unsilence(str(key))
            actions["unsilenced"] = key
        key = q.get("ack")
        if key:
            actions["acked"] = wt.ack(str(key))
        result = wt.snapshot()
        result["enabled"] = True
        if actions:
            result["actions"] = actions
        return json_response({"ok": True, "result": result})

    async def h_debug_cache(self, request: Request) -> Response:
        """The hot read cache: entries and bytes by class, the hit, miss,
        eviction and coalesce counts, and the generation and its age."""
        return json_response({"ok": True, "result": self.hotcache.stats()})

    async def h_debug_breakers(self, request: Request) -> Response:
        """Each peer's circuit state and EWMA score, what gossip and sync
        rank peers by."""
        return json_response({"ok": True, "result": {
            "peers": self.breakers.snapshot(),
            "state_counts": self.breakers.state_counts(),
        }})

    async def h_debug_profile(self, request: Request) -> Response:
        """Opt-in ``torch.profiler`` capture control (``profile.*``):
        ``?action=start|stop|status``.  Served only when both
        ``telemetry.debug_endpoints`` and ``profile.enabled`` say so.
        The calls run in an executor: a profiler start can block for
        seconds."""
        from .. import profiling

        pcfg = self.config.profile
        action = request.query.get("action", "status")
        loop = asyncio.get_running_loop()
        if action == "start":
            result = await loop.run_in_executor(
                None, profiling.start, pcfg.trace_dir,
                pcfg.max_capture_seconds)
        elif action == "stop":
            result = await loop.run_in_executor(None, profiling.stop)
        elif action == "status":
            result = await loop.run_in_executor(None, profiling.status)
        else:
            return json_response(
                {"ok": False,
                 "error": "action must be start, stop or status"},
                status=400)
        return json_response({"ok": "error" not in result,
                              "result": result})

    # ------------------------------------------------------------ sync ----
    @staticmethod
    def _sync_result(outcome, peer: Optional[str]) -> dict:
        """_sync_blockchain's True | str | Exception as ``{ok, error,
        peer}``."""
        if outcome is True:
            return {"ok": True, "error": None, "peer": peer}
        if isinstance(outcome, BaseException):
            error = f"{type(outcome).__name__}: {outcome}"
        else:
            error = str(outcome)
        return {"ok": False, "error": error, "peer": peer}

    async def sync_blockchain(self, node_url: Optional[str] = None) -> dict:
        """Guarded sync (main.py:230-243) as ``{ok, error, peer}``: from
        ``node_url``, or else from up to 3 peers sampled from the book and
        tried in health order until one succeeds.  The running sync is
        one of the node's background tasks, so :meth:`close` cancels
        it."""
        if self.is_syncing:
            return self._sync_result("Node is already syncing", None)
        self.is_syncing = True
        self.manager.is_syncing = True
        task = asyncio.current_task()
        self._background.add(task)
        try:
            if node_url:
                return self._sync_result(
                    await self._sync_blockchain(node_url), node_url)
            nodes = self.peers.recent_nodes()
            if not nodes:
                return self._sync_result("No nodes found.", None)
            result = self._sync_result("no peers tried", None)
            candidates = random.sample(nodes, min(3, len(nodes)))
            for url in self.peers.ranked(candidates):
                try:
                    outcome = await self._sync_blockchain(url)
                except Exception as e:
                    # a dead peer raises from the fork-detection fetches:
                    # try the next one
                    outcome = e
                result = self._sync_result(outcome, url)
                if result["ok"]:
                    return result
                log.warning("sync from %s did not complete (%s); trying "
                            "another peer", url, result["error"])
            return result
        except Exception as e:
            log.warning("sync_blockchain error: %s: %s", type(e).__name__, e)
            return self._sync_result(e, node_url)
        finally:
            self._background.discard(task)
            self.is_syncing = False
            self.manager.is_syncing = False

    async def _sync_blockchain(self, node_url: str):
        """Fork detection + paged download (main.py:153-227) from one
        named peer: True, or the error."""
        cfg = self.config.node
        iface = self.iface_factory(node_url, cfg, resilience=self.resilience)
        prefetch: Optional[asyncio.Task] = None
        prefetch_from = None
        try:
            _, last_block = await self.manager.calculate_difficulty()
            starting_from = i = await self.state.get_next_block_id()
            # advisory: a peer further ahead than the reorg window would
            # be better reached by a snapshot (best effort)
            try:
                info = (await iface.get("get_mining_info")).get(
                    "result") or {}
                remote_height = int(
                    (info.get("last_block") or {}).get("id") or 0)
            except (OSError, ValueError, TypeError, asyncio.TimeoutError,
                    AttributeError) as e:
                log.debug("tip probe of %s failed: %s", node_url, e)
                remote_height = 0
            if remote_height - (i - 1) > cfg.sync_reorg_window:
                trace.inc("snapshot_recommended")
                trace.event("snapshot_recommended", peer=node_url,
                            local_height=i - 1, remote_height=remote_height,
                            lag=remote_height - (i - 1))
            local_cache = None
            last_common_block = 0
            if last_block and last_block.get("id", 0) > cfg.sync_reorg_window:
                remote_last = (await iface.get_block(i - 1))["block"]
                if remote_last["hash"] != last_block["hash"]:
                    offset = i - cfg.sync_reorg_window
                    remote_blocks = await iface.get_blocks(
                        offset, cfg.sync_reorg_window)
                    local_blocks = await self.state.get_blocks(
                        offset, cfg.sync_reorg_window)
                    # pair by block id: the peer's page may be cut by
                    # its size cap
                    remote_by_id = {rb["block"]["id"]: rb
                                    for rb in remote_blocks}
                    local_blocks.reverse()
                    for n, local in enumerate(local_blocks):
                        remote = remote_by_id.get(local["block"]["id"])
                        if remote is not None and \
                                local["block"]["hash"] == remote["block"]["hash"]:
                            last_common_block = local["block"]["id"]
                            local_cache = local_blocks[:n]
                            local_cache.reverse()
                            await self.state.remove_blocks(
                                last_common_block + 1)
                            break
            errors: list = []
            # pipelined download: page k + 1 is fetched while page k is
            # accepted, paced below the peer's 40/min get_blocks limit
            last_fetch = [0.0]

            async def fetch_page(offset):
                wait = cfg.sync_fetch_interval - (
                    time.monotonic() - last_fetch[0])
                if wait > 0:
                    await asyncio.sleep(wait)
                last_fetch[0] = time.monotonic()
                return await iface.get_blocks(offset, cfg.sync_page)

            while True:
                i = await self.state.get_next_block_id()
                try:
                    if prefetch is not None and prefetch_from == i:
                        try:
                            blocks = await prefetch
                        except Exception as e:
                            # a blip on the speculative fetch: one direct
                            # retry at consumption time
                            log.info("prefetch of page %s failed (%s); "
                                     "retrying directly", i, e)
                            blocks = await fetch_page(i)
                    else:
                        if prefetch is not None:
                            # retrieve the discarded fetch's outcome by a
                            # callback, never an await: awaiting a task we
                            # just cancelled cannot be told apart from our
                            # own cancellation, and sync would outlive
                            # close()
                            prefetch.cancel()
                            prefetch.add_done_callback(
                                lambda t: t.cancelled() or t.exception())
                        blocks = await fetch_page(i)
                    prefetch = None
                    if len(blocks) == cfg.sync_page:
                        prefetch_from = i + cfg.sync_page
                        prefetch = asyncio.ensure_future(
                            fetch_page(prefetch_from))
                except Exception as e:
                    # a failed page must not fall through to success
                    log.error("sync fetch failed: %s", e)
                    return f"sync fetch failed: {e}"
                try:
                    _, last_block = await self.manager.calculate_difficulty()
                    if not blocks:
                        log.info("syncing complete")
                        if last_block and last_block.get("id", 0) > starting_from:
                            await self._propagate_tip(node_url)
                        return True
                    if not await self.create_blocks(blocks, errors):
                        raise RuntimeError("page not accepted")
                except Exception as e:
                    log.error("sync failed: %s", errors[0] if errors else e)
                    if local_cache is not None:
                        log.info("reverting to previous chain")
                        await self.state.remove_blocks(last_common_block + 1)
                        await self.create_blocks(local_cache, [])
                    return errors[0] if errors else e
        finally:
            if prefetch is not None:
                prefetch.cancel()
                prefetch.add_done_callback(
                    lambda t: t.cancelled() or t.exception())
            await iface.close()

    async def _propagate_tip(self, node_url: str) -> None:
        """After a sync that moved the tip: the peer was heard from, and
        a tip less than a day old is gossiped to everyone but it."""
        self.peers.update_last_message(node_url)
        tip = await self.state.get_last_block()
        if tip and timestamp() - tip["timestamp"] < 86400:
            hashes = await self.state.get_block_transaction_hashes(
                tip["hash"])
            await self.propagate("push_block", {
                "block_content": tip["content"], "txs": hashes,
                "block_no": tip["id"]}, ignore_url=node_url)

    async def create_blocks(self, blocks: list,
                            errors: Optional[list] = None,
                            _allow_device_txids: bool = True) -> bool:
        """Batch ingest of one sync page (main.py:97-150): recompute the
        merkle, rebuild content when absent, accept through the sync path
        that trusts the embedded coinbase.

        Departures from the reference, as in the JAX package: the page's
        txids are one :func:`txid_batch` that seeds every tx's hash memo
        (guarded by a round-trip identity check, the batch's integrity
        sample, and check_block's merkle comparison, whose leaves are the
        memos), and the page's signature checks are one batched verify
        whose verdicts the per-block accept reads.  Unlike the JAX
        package, only a peer's bad hex skips the txid batch: a kernel
        error raises out of the sync."""
        errors = errors if errors is not None else []
        _, last_block = await self.manager.calculate_difficulty()
        last_id = last_block["id"] if last_block else 0
        last_hash = last_block["hash"] if last_block else GENESIS_PREV_HASH
        i = last_id + 1
        txid_prefill: dict = {}
        dcfg = self.config.device
        all_hex = []
        if dcfg.txid_backend != "host" and _allow_device_txids:
            all_hex = [t for b in blocks for t in b.get("transactions", ())]
        if len(all_hex) >= max(dcfg.txid_min_batch, 1):
            try:
                payloads = [bytes.fromhex(h) for h in all_hex]
            except (TypeError, ValueError) as e:
                # the parse loop below reports the page's bad entry
                log.info("txid prefill skipped: %s", e)
                payloads = None
            if payloads is not None:
                # executor: the kernel's build and the batch must not
                # block the loop
                with trace.span("sync.page_txids", n=len(payloads)):
                    digests = await asyncio.get_running_loop() \
                        .run_in_executor(None, functools.partial(
                            txid_batch, payloads,
                            backend=dcfg.txid_backend,
                            min_batch=dcfg.txid_min_batch,
                            device=self.device))
                txid_prefill = dict(zip(all_hex, digests))
        parsed, overlay = [], {}
        parse_error = None
        for block_info in blocks:
            try:
                block = dict(block_info["block"])
                txs = []
                for t in block_info["transactions"]:
                    tx = await self._parse_tx(t, overlay=overlay)
                    seed = txid_prefill.get(t)
                    # seed only when the re-serialisation is the wire form
                    # byte for byte (the txid hashes the re-serialised hex)
                    if seed is not None and getattr(tx, "_hash", "x") is None \
                            and tx.hex() == t:
                        tx._hash = seed
                    txs.append(tx)
            except Exception as e:
                # keep the valid prefix: the accept loop still commits
                # every block parsed so far
                log.debug("sync: stopping page at unparseable block: %s", e)
                parse_error = f"block parse failed: {e}"
                break
            coinbase = None
            for tx in txs:
                if isinstance(tx, CoinbaseTx):
                    txs.remove(tx)
                    coinbase = tx
                    break
            for tx in txs:
                overlay[tx.hash()] = tx
            if coinbase is not None:
                overlay[coinbase.hash()] = coinbase
            parsed.append((block, txs, coinbase))

        self.manager.page_sig_verdicts = await self._page_sig_prefill(
            parsed, overlay)
        try:
            for block, txs, coinbase in parsed:
                block["merkle_tree"] = merkle_root(txs)
                content = block.get("content")
                if not content:
                    # the rebuilt header hashes the raw hexes, not the
                    # memos: check_block compares the header's root with
                    # the memo leaves, and a memo root in the header would
                    # compare a wrong device seed with itself
                    block["merkle_tree"] = merkle_root(
                        [tx.hex() for tx in txs])
                    content = block_to_bytes(last_hash, block).hex()
                if int(block["id"]) != i:
                    errors.append(f"unexpected block id {block['id']} != {i}")
                    return False
                if coinbase is None:
                    errors.append(f"block {i} has no coinbase")
                    return False
                if not await self.manager.create_block_syncing(
                        content, txs, coinbase, errors=errors):
                    if (txid_prefill and
                            any("merkle" in e for e in errors[-2:])):
                        # a wrong device-seeded txid surfaces here as a
                        # merkle mismatch (the integrity sample can miss a
                        # lane); redo the rest of the page with hashlib
                        # rather than wedge on the device
                        trace.inc("sync.host_txid_retry")
                        log.warning(
                            "sync accept hit a merkle mismatch with "
                            "device-seeded txids at block %d; retrying "
                            "the page with host hashing", i)
                        self.manager.page_sig_verdicts = None
                        remaining = [
                            b for b in blocks
                            if int(b["block"]["id"]) >= i]
                        errors.append(
                            f"retrying {len(remaining)} blocks with "
                            "host txids after device-seeded merkle "
                            "mismatch")
                        return await self.create_blocks(
                            remaining, errors, _allow_device_txids=False)
                    return False
                last_hash = block["hash"]
                i += 1
        finally:
            self.manager.page_sig_verdicts = None
        if parse_error:
            errors.append(parse_error)
            return False
        return True

    def _prefill_worthwhile(self, n_inputs: int) -> bool:
        """Page-level batching pays only where the checks go to the
        device (one dispatch in place of one a block); on the host path
        it would double the address-resolution reads."""
        return _resolve_backend(
            self.config.device.sig_backend, n_inputs, self.device) != "host"

    async def _page_sig_prefill(self, parsed, overlay) -> Optional[dict]:
        """One batched signature verify for a whole sync page.  Checks
        that fail to collect here (unresolvable inputs, malformed txs)
        are left out: the per-block accept recomputes anything missing
        and reports the real error."""
        n_inputs = sum(len(tx.inputs)
                       for _b, txs, _cb in parsed for tx in txs)
        if n_inputs == 0 or not self._prefill_worthwhile(n_inputs):
            return None
        verifier = TxVerifier(
            self.manager.state, is_syncing=True, tx_overlay=overlay,
            verify_mesh_devices=self.config.device.mesh_devices)
        checks = []
        for _block, txs, _cb in parsed:
            for tx in txs:
                try:
                    c = await verifier.collect_sig_checks(tx)
                except Exception as e:
                    # best effort; the accept loop re-verifies
                    log.debug("sig-check prefill skipped a tx: %s", e)
                    c = None
                if c:
                    checks.extend(c)
        if not checks:
            return None
        checks = list(dict.fromkeys(checks))  # dedup, keep order
        with trace.span("sync.page_sig_prefill", n=len(checks)):
            dcfg = self.config.device
            verdicts = await run_sig_checks_async(
                checks, backend=dcfg.sig_backend, device=self.device,
                pad_block=dcfg.verify_pad_block,
                device_timeout=dcfg.verify_device_timeout,
                mesh_devices=dcfg.mesh_devices)
        return dict(zip(checks, verdicts))


def _vote(row: dict) -> dict:
    return {"wallet": row["recipient"], "vote_count": str(row["vote"]),
            "tx_hash": row["tx_hash"], "index": row["index"]}


def _json_dumps(obj) -> str:
    """``json.dumps`` with Decimals as strings."""
    def default(o):
        if isinstance(o, Decimal):
            return str(o)
        raise TypeError(type(o))
    return json.dumps(obj, default=default)


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
    """Run one node until cancelled.  The node's device runtime arms
    before it serves (on a card: the kernels' build, load and warm
    launches); a failed arm raises, so the node does not start."""
    node = Node(config, device=device)
    try:
        arm = await asyncio.get_running_loop().run_in_executor(
            None, get_runtime(node.device).arm)
    except BaseException:
        await node.close()
        raise
    server = await node.serve()
    log.info("node serving on %s:%d (device %s, verify kernel %s, runtime "
             "armed in %.3fs)", server.host, server.port, node.device,
             config.device.verify_kernel or "jac", arm["probe_seconds"])
    try:
        await asyncio.Event().wait()
    finally:
        await node.close()
