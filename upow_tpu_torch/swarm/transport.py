"""In-memory HTTP/WS transport: real node handlers, zero sockets (the
port's counterpart of the JAX package's ``swarm/transport.py``).

:class:`LoopbackHub` is the wire.  A dispatch builds the
:class:`~..node.http.Request` the port's server would have parsed off a
socket (method, target, lower-cased headers, the body's bytes, the
node's body cap, and the caller's simulated IP as ``peer_ip``) and awaits
the destination :meth:`~..node.app.Node.handle`: the IP filter, path
normalisation, rate limits, routing (``match_info`` included), the
request trace and the handlers run exactly as they would behind a
socket, and the response body comes back as bytes.  The JAX hub hands
aiohttp's ``make_mocked_request`` to the app's ``_handle`` instead; the
port's node has no aiohttp.

:class:`LoopbackInterface` subclasses the port's
:class:`~..node.peers.NodeInterface` and overrides ONLY the one attempt
seam, ``_fetch``: the breaker gate, fault injection, retry policy,
Sender-Node and X-Upow-Trace headers all run through the inherited
``request``/``get``/``_resilient``/``_rpc_headers`` code.  A link
failure (:class:`~.links.LinkDown`) is a ``ConnectionError``, so peers
see retries, breaker flips and health-score decay with no node change.
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse
from typing import Awaitable, Callable, Dict, Optional, Tuple

from ..logger import get_logger
from ..node.http import Request
from ..node.peers import NodeInterface, _normalize
from .links import LinkMatrix

log = get_logger("swarm")

# an adversary endpoint: (method, path, params, json_body) -> (status, doc)
RawHandler = Callable[[str, str, dict, Optional[dict]],
                      Awaitable[Tuple[int, dict]]]


class LoopbackHub:
    """URL -> in-process listener registry + request dispatch."""

    def __init__(self, matrix: LinkMatrix):
        self.matrix = matrix
        self._nodes: Dict[str, object] = {}
        self._raw: Dict[str, RawHandler] = {}
        self._ips: Dict[str, str] = {}
        # client-side latency per (dst url, path): the per-node SLO
        # source — measured at the caller, where each destination's
        # numbers stay apart
        self.latencies: Dict[Tuple[str, str], list] = {}

    def register_node(self, url: str, node, ip: str) -> None:
        base = _normalize(url)
        self._nodes[base] = node
        self._ips[base] = ip
        self.matrix.register(base)

    def register_raw(self, url: str, handler: RawHandler,
                     ip: str = "") -> None:
        """Attach an adversary endpoint: answers RPCs without being a
        node (or raises to model a dead peer)."""
        base = _normalize(url)
        self._raw[base] = handler
        if ip:
            self._ips[base] = ip
        self.matrix.register(base)

    def register_client(self, url: str, ip: str) -> None:
        """A shaped client endpoint (e.g. a spammer): pays link tolls
        and carries a simulated source IP, but serves nothing."""
        base = _normalize(url)
        self._ips[base] = ip
        self.matrix.register(base)

    def node(self, url: str):
        return self._nodes[_normalize(url)]

    async def request(self, src: str, dst: str, method: str, path: str,
                      params: Optional[dict] = None,
                      json_body: Optional[dict] = None,
                      headers: Optional[dict] = None) -> Tuple[int, bytes]:
        """One simulated HTTP exchange src -> dst.  Raises LinkDown /
        ConnectionRefusedError for network-level failure; application
        errors come back as (status, body) like real HTTP."""
        target = path
        if params:
            target += "?" + urllib.parse.urlencode(params)
        body = None if json_body is None else json.dumps(json_body).encode()
        return await self.dispatch(src, dst, method, target, body, headers)

    async def dispatch(self, src: str, dst: str, method: str, target: str,
                       body: Optional[bytes] = None,
                       headers: Optional[dict] = None) -> Tuple[int, bytes]:
        """:meth:`request` on a raw target (``/path?query``) and body."""
        src_base, base = _normalize(src), _normalize(dst)
        await self.matrix.transfer(src_base, base)
        path, _, query = target.partition("?")
        raw = self._raw.get(base)
        if raw is not None:
            params = dict(urllib.parse.parse_qsl(query,
                                                 keep_blank_values=True))
            status, doc = await raw(method, path, params,
                                    json.loads(body) if body else None)
            return status, json.dumps(doc).encode()
        node = self._nodes.get(base)
        if node is None:
            raise ConnectionRefusedError(f"no swarm listener at {dst}")

        hdrs = {"host": base.split("://", 1)[-1]}
        for k, v in (headers or {}).items():
            hdrs[k.lower()] = v
        body = body or b""
        if body:
            hdrs.setdefault("content-type", "application/json")
            hdrs["content-length"] = str(len(body))
        req = Request(method, target, hdrs, body, len(body),
                      node.config.node.response_cap,
                      self._ips.get(src_base, "127.0.0.1"))
        t0 = time.perf_counter()
        resp = await node.handle(req)
        self.latencies.setdefault((base, path), []).append(
            time.perf_counter() - t0)
        return resp.status, bytes(resp.body or b"")


class LoopbackInterface(NodeInterface):
    """NodeInterface whose wire is the LoopbackHub."""

    def __init__(self, hub: LoopbackHub, src: str, url: str, cfg=None,
                 resilience=None):
        super().__init__(url, cfg, resilience=resilience)
        self._hub = hub
        self._src = src

    async def _fetch(self, url: str, method: str = "GET",
                     body: Optional[bytes] = None,
                     headers: Optional[dict] = None) -> dict:
        split = urllib.parse.urlsplit(url)
        target = (split.path or "/") + (
            f"?{split.query}" if split.query else "")
        _, raw = await self._hub.dispatch(self._src, self.base_url, method,
                                          target, body, headers)
        if len(raw) > self.cfg.response_cap:
            raise ValueError("response too large")
        return json.loads(raw or b"{}")


class LoopbackWsClient:
    """In-process WS subscriber sink for ``WsHub.connect_local``: the
    hub's writer task calls ``send_str``; frames land in ``received``.
    ``stall()`` models a consumer whose socket never drains — the
    writer blocks here while the connection's bounded queue sheds —
    and an optional (matrix, node, url) triple routes frames through
    swarm links so partitions cut WS push too."""

    def __init__(self, matrix: Optional[LinkMatrix] = None,
                 node_url: str = "", url: str = ""):
        self.received: list = []
        self._matrix = matrix
        self._node_url = _normalize(node_url)
        self._url = _normalize(url)
        if matrix is not None and self._url:
            matrix.register(self._url)
        self._stalled = False
        self._resume = asyncio.Event()
        self._resume.set()

    def stall(self) -> None:
        self._stalled = True
        self._resume.clear()

    def resume(self) -> None:
        self._stalled = False
        self._resume.set()

    async def send_str(self, payload: str) -> None:
        if self._stalled:
            await self._resume.wait()
        if self._matrix is not None and self._url:
            await self._matrix.transfer(self._node_url, self._url)
        self.received.append(json.loads(payload))

    def of_type(self, mtype: str) -> list:
        return [m for m in self.received if m.get("type") == mtype]
