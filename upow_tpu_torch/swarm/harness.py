"""Swarm assembly: N real nodes, one loop, loopback everything (the
port's copy of the JAX package's ``swarm/harness.py``).

Each node is a full :class:`~..node.app.Node` — in-memory sqlite state,
host sig backend, its own PeerBook/breakers/mempool — reachable at a
virtual URL (``http://10.77.0.<i>:3006``).  Every node of a swarm runs
on the swarm's ``device``, resolved as every port entry point resolves
it: None is the card (and raises without one), ``"cpu"`` the host.  On a
card the nodes share that card's one device runtime; a ``cfg_hook``
that sets ``device.sig_backend = "device"`` sends their verifies
through it.  The only alteration is
``iface_factory``: outbound RPC goes through
:class:`~.transport.LoopbackInterface` and pays the
:class:`~.links.LinkMatrix` toll.  The scenario driver talks to nodes
with :meth:`Swarm.get`/:meth:`post` as an unregistered client (no link
shaping, local IP), mirroring how tests drive a real cluster.

Resilience knobs are tightened for simulation speed (milliseconds of
backoff, sub-second breaker reopen) — operational policy only, chain
state stays bit-identical to default-config nodes.
"""

from __future__ import annotations

import asyncio
import json
from decimal import Decimal
from typing import Callable, List, Optional

from .. import trace
from ..config import Config
from ..device import DeviceLike, resolve
from ..logger import get_logger
from ..node.app import GENESIS_PREV_HASH, Node
from .links import LinkMatrix, LinkPolicy
from .transport import LoopbackHub, LoopbackInterface

log = get_logger("swarm")


def swarm_config(ws: bool = False, ws_queue_max: int = 0,
                 reorg_window: int = 0) -> Config:
    cfg = Config()
    cfg.node.db_path = ""           # in-memory sqlite per node
    cfg.node.seed_url = ""
    cfg.node.peers_file = ""        # peer book lives in memory
    cfg.node.ip_config_file = ""
    cfg.node.sync_fetch_interval = 0.0
    cfg.node.rate_limits_enabled = False
    if reorg_window:
        cfg.node.sync_reorg_window = reorg_window
    cfg.ws.enabled = ws
    if ws_queue_max:
        cfg.ws.send_queue_max = ws_queue_max
    cfg.device.sig_backend = "host"
    cfg.log.path = ""
    cfg.log.console = False
    # fast-simulation resilience policy (operational, not consensus)
    cfg.resilience.rpc_attempts = 2
    cfg.resilience.rpc_backoff_base = 0.005
    cfg.resilience.rpc_backoff_max = 0.02
    cfg.resilience.rpc_deadline = 2.0
    cfg.resilience.propagate_deadline = 1.0
    cfg.resilience.breaker_failure_threshold = 3
    cfg.resilience.breaker_open_secs = 0.25
    # swarm assertions read trace trees and events across many nodes;
    # default rings are sized for one
    cfg.telemetry.trace_recent = 512
    cfg.telemetry.events_buffer = 4096
    # every node gets its own metrics/SLO/events/trace registries —
    # 50 in-loop nodes must not clobber one process-global registry
    # (fleet scraper + scenario assertions read them per node)
    cfg.telemetry.instance_scope = True
    # every node is the sole writer of its in-memory state, so the
    # read cache never needs foreign-writer revalidation — leaving it
    # on would let the periodic re-anchor mask a missing invalidation
    # hook (the partition_heal assertion wants the HOOK, not the
    # backstop, to invalidate losers' caches after their reorg)
    cfg.cache.revalidate_interval = -1.0
    return cfg


class Swarm:
    """N loopback nodes over one LinkMatrix."""

    def __init__(self, n: int, seed: int = 0,
                 link: Optional[LinkPolicy] = None, ws: bool = False,
                 ws_queue_max: int = 0, reorg_window: int = 0,
                 cfg_hook: Optional[Callable[[int, Config], None]] = None,
                 device: DeviceLike = None):
        self.n = n
        self.device = resolve(device)
        self.seed = seed
        self.matrix = LinkMatrix(seed, default=link)
        self.hub = LoopbackHub(self.matrix)
        self.ws = ws
        self.ws_queue_max = ws_queue_max
        self.reorg_window = reorg_window
        self.cfg_hook = cfg_hook
        self.nodes: List[Node] = []
        self.urls: List[str] = []
        self.ips: List[str] = []
        self.driver = "http://driver.local"  # unregistered: no shaping
        # per-node black box (fleet/recorder.py): scenario drivers mark
        # phase boundaries; run_scenario dumps on failure/fault/breach
        from ..fleet.recorder import FlightRecorder
        self.recorder = FlightRecorder()

    # -------------------------------------------------------------- build --
    async def start(self, topology: str = "mesh") -> "Swarm":
        for i in range(self.n):
            ip = f"10.77.{i // 250}.{i % 250 + 1}"
            url = f"http://{ip}:3006"
            cfg = swarm_config(ws=self.ws, ws_queue_max=self.ws_queue_max,
                               reorg_window=self.reorg_window)
            if self.cfg_hook is not None:
                self.cfg_hook(i, cfg)
            node = Node(cfg, device=self.device)
            node.self_url = url
            node.started = True  # skip first-request bootstrap
            if node.telemetry_scope is not None:
                node.telemetry_scope.name = f"node{i}"
            node.iface_factory = self._factory(url)
            node.start_services()  # what serve() starts, with no socket
            self.hub.register_node(url, node, ip)
            self.nodes.append(node)
            self.urls.append(url)
            self.ips.append(ip)
        if topology == "mesh":
            for i, node in enumerate(self.nodes):
                for j, url in enumerate(self.urls):
                    if i != j:
                        node.peers.add(url)
        return self

    def _factory(self, self_url: str):
        hub = self.hub

        def make(url, cfg=None, resilience=None):
            return LoopbackInterface(hub, self_url, url, cfg,
                                     resilience=resilience)

        return make

    async def close(self) -> None:
        for node in self.nodes:
            await node.close()  # closes the /ws hub too
        self.nodes.clear()

    # ------------------------------------------------------------- client --
    def _headers(self) -> dict:
        headers = {}
        tid = trace.current_trace_id()
        if tid is not None:
            # driver requests propagate their trace like a peer RPC, so
            # a scenario step is ONE trace across every node it touches
            headers[trace.TRACE_HEADER] = tid
        return headers

    async def get(self, i: int, path: str,
                  params: Optional[dict] = None) -> dict:
        _, body = await self.hub.request(
            self.driver, self.urls[i], "GET", "/" + path.lstrip("/"),
            params=params, headers=self._headers())
        return json.loads(body or b"{}")

    async def post(self, i: int, path: str, json_body: dict) -> dict:
        _, body = await self.hub.request(
            self.driver, self.urls[i], "POST", "/" + path.lstrip("/"),
            json_body=json_body, headers=self._headers())
        return json.loads(body or b"{}")

    # -------------------------------------------------------------- chain --
    async def mine(self, i: int, address: str,
                   push_to: Optional[List[int]] = None,
                   _retried: bool = False) -> dict:
        """Drive the miner protocol against node ``i`` (the test-suite
        mine_via_api port): one BLOCK_TIME tick, template, deterministic
        python search, push.  ``push_to`` pushes the same solved block
        to extra nodes directly — scenarios that must not race gossip
        feed each partition member explicitly."""
        from ..core import clock
        from ..core.clock import timestamp
        from ..core.difficulty import BLOCK_TIME
        from ..core.header import BlockHeader
        from ..core.merkle import miner_merkle_root
        from ..mine.engine import MiningJob, mine

        if not _retried:
            clock.advance(BLOCK_TIME)
        info = (await self.get(i, "get_mining_info"))["result"]
        last_block = dict(info["last_block"])
        prev_hash = last_block.get("hash", GENESIS_PREV_HASH)
        pending_hashes = info["pending_transactions_hashes"]
        header = BlockHeader(
            previous_hash=prev_hash, address=address,
            merkle_root=miner_merkle_root(pending_hashes),
            timestamp=timestamp(),
            difficulty_x10=int(Decimal(str(info["difficulty"])) * 10),
            nonce=0)
        if last_block.get("hash"):
            job = MiningJob(header.prefix_bytes(), prev_hash,
                            Decimal(str(info["difficulty"])))
            result = mine(job, "python", batch=1 << 14, ttl=300)
            if result.nonce is None:
                raise RuntimeError("swarm mine: no nonce found")
            header.nonce = result.nonce
        payload = {"block_content": header.hex(), "txs": pending_hashes,
                   "block_no": last_block.get("id", 0) + 1}
        res = await self.post(i, "push_block", payload)
        if not res.get("ok") and not _retried:
            # same stale-template race as a real miner: the interval
            # mempool GC can evict a listed tx between template and push
            return await self.mine(i, address, push_to=push_to,
                                   _retried=True)
        for j in push_to or []:
            if j != i:
                # gossip may have delivered it already; that answer is
                # not a failure for the scenario
                await self.post(j, "push_block", payload)
        return res

    async def tips(self) -> List[dict]:
        out = []
        for i in range(len(self.nodes)):
            last = await self.nodes[i].state.get_last_block()
            out.append({"id": last["id"] if last else 0,
                        "hash": last["hash"] if last else GENESIS_PREV_HASH})
        return out

    async def converged(self) -> bool:
        tips = await self.tips()
        return len({t["hash"] for t in tips}) == 1

    async def wait_converged(self, rounds: int = 200,
                             delay: float = 0.02) -> bool:
        for _ in range(rounds):
            if await self.converged():
                return True
            await asyncio.sleep(delay)
        return await self.converged()

    async def settle(self, rounds: int = 3) -> None:
        """Let spawned gossip tasks drain (bounded; no wall-clock
        dependence beyond scheduler fairness)."""
        for _ in range(rounds):
            pending = [t for node in self.nodes for t in node._background
                       if not t.done()]
            if not pending:
                break
            await asyncio.gather(*pending, return_exceptions=True)
        await asyncio.sleep(0)

    # ---------------------------------------------------------- summaries --
    def breaker_summary(self) -> dict:
        return {f"node{i}": node.breakers.snapshot()
                for i, node in enumerate(self.nodes)}

    def slo_summary(self) -> dict:
        """Per-node client-side latency quantiles over every driver and
        peer dispatch that landed on that node."""
        from ..loadgen.runner import summarize_latencies

        per_node: dict = {}
        for (url, _path), vals in self.hub.latencies.items():
            per_node.setdefault(url, []).extend(vals)
        out = {}
        for i, url in enumerate(self.urls):
            vals = per_node.get(url)
            if vals:
                out[f"node{i}"] = summarize_latencies(vals)
        return out
