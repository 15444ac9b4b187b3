"""The peer book and the RPC client for one peer (reference
nodes_manager.py:24-210).

The port's copy of the JAX package's ``node/peers.py``.  A JSON peer
file (``{"nodes": {url: {"added", "last_message"}}}``, the same format,
so either package reads the other's) is written under an ``fcntl`` lock
on ``<peers_file>.lock`` and replaced atomically.  Peers are *active* if
they messaged us within ``node.active_within`` (7 days), pruned after
``node.prune_after`` (90 days) of silence and capped at
``node.max_peers`` (100); the gossip set is a sample of up to
``node.propagate_sample`` (10) active peers plus as many never-seen
ones, open circuits skipped, healthy peers first.  Sampling draws from a
``random.Random`` that the caller may pass.

:class:`NodeInterface` runs on the standard library's client in
:mod:`.http` instead of an aiohttp session: each request opens its own
connection, is cut after ``node.http_timeout`` seconds and refused past
``node.response_cap`` bytes.  Under a ``ResilienceContext`` each RPC is
gated by the peer's circuit breaker, fires the fault site
``rpc.<path>``, and is retried with jittered backoff under
``resilience.rpc_deadline``; without one it is a single attempt.  Its
requests carry ``Sender-Node``, this node's return address, and
``X-Upow-Trace``, the current trace's id.
"""

from __future__ import annotations

import asyncio
import fcntl
import json
import logging
import os
import random
import time
from typing import Dict, List, Optional
from urllib.parse import urlencode

from .. import trace
from ..config import NodeConfig
from ..resilience import (BreakerRegistry, CircuitOpenError,
                          ResilienceContext, call_with_retry, faultinject)
from .http import fetch

# transport trouble is retried; a peer's error body parses and is not
TRANSIENT_ERRORS = (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError)

log = logging.getLogger("upow_tpu_torch.peers")


def _normalize(url: str) -> str:
    url = (url or "").strip().strip("/")
    if url and not url.startswith("http"):
        url = "http://" + url
    return url


class PeerBook:
    """Durable peer registry with active and never-seen classes."""

    def __init__(self, cfg: Optional[NodeConfig] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 rng: Optional[random.Random] = None):
        self.cfg = cfg or NodeConfig()
        self.breakers = breakers if breakers is not None else \
            BreakerRegistry()
        self.rng = rng if rng is not None else random.Random()
        self.path = self.cfg.peers_file
        self._data: Dict[str, dict] = {}
        self._load()
        if not self._data and self.cfg.seed_url:
            self.add(self.cfg.seed_url)

    # ------------------------------------------------------- persistence --
    def _load(self) -> None:
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._data = json.load(f).get("nodes", {})
            except (json.JSONDecodeError, OSError):
                self._data = {}

    def save(self) -> None:
        if not self.path:
            return
        with open(self.path + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"nodes": self._data}, f)
            os.replace(tmp, self.path)

    # ------------------------------------------------------------ updates --
    def add(self, url: str) -> bool:
        url = _normalize(url)
        if not url or url in self._data:
            return False
        if len(self._data) >= self.cfg.max_peers:
            self.prune()
            if len(self._data) >= self.cfg.max_peers:
                return False
        self._data[url] = {"added": int(time.time()), "last_message": 0}
        self.save()
        return True

    def update_last_message(self, url: str) -> None:
        url = _normalize(url)
        if url in self._data:
            self._data[url]["last_message"] = int(time.time())
            self.save()

    def remove(self, url: str) -> None:
        if self._data.pop(_normalize(url), None) is not None:
            self.save()

    def prune(self) -> None:
        """Drop peers silent for ``prune_after`` (never-seen ones by the
        time they were added)."""
        now = time.time()
        doomed = [
            u for u, meta in self._data.items()
            if now - max(meta.get("last_message", 0), meta.get("added", 0))
            > self.cfg.prune_after
        ]
        for u in doomed:
            del self._data[u]
        if doomed:
            self.save()

    # ------------------------------------------------------------- reads --
    def all_nodes(self) -> List[str]:
        return list(self._data)

    def _active(self) -> List[str]:
        now = time.time()
        return [u for u, meta in self._data.items()
                if meta.get("last_message", 0) > 0
                and now - meta["last_message"] < self.cfg.active_within]

    def recent_nodes(self) -> List[str]:
        """Peers that messaged us within the active window, or every
        known peer when none has (a fresh node on its seed)."""
        return self._active() or list(self._data)

    def _healthy_sample(self, pool: List[str], k: int) -> List[str]:
        """``k`` peers, open circuits skipped, scores of 0.5 and up
        first; with no breaker history, ``random.sample``."""
        pool = [u for u in pool if self.breakers.usable(u)]
        good = [u for u in pool if self.breakers.score(u) >= 0.5]
        weak = [u for u in pool if self.breakers.score(u) < 0.5]
        picks = self.rng.sample(good, min(k, len(good)))
        if len(picks) < k:
            picks += self.rng.sample(weak, min(k - len(picks), len(weak)))
        return picks

    def propagate_nodes(self) -> List[str]:
        """Up to ``propagate_sample`` active and as many never-seen peers
        (nodes_manager.py:144-149), ranked by health.  A peer last heard
        from beyond the active window is in neither class."""
        k = self.cfg.propagate_sample
        unseen = [u for u, meta in self._data.items()
                  if meta.get("last_message", 0) == 0]
        picks = self._healthy_sample(self._active(), k)
        picks += self._healthy_sample(unseen, k)
        return self.ranked(picks)

    def ranked(self, urls: List[str]) -> List[str]:
        """Usable circuits first, then by descending score, then by URL:
        a pure function of the breakers' state."""
        return sorted(urls, key=lambda u: (
            0 if self.breakers.usable(u) else 1,
            -self.breakers.score(u), u))

    def contains(self, url: str) -> bool:
        return _normalize(url) in self._data


class NodeInterface:
    """RPC client for one remote node (nodes_manager.py:174-210)."""

    def __init__(self, url: str, cfg: Optional[NodeConfig] = None,
                 resilience: Optional[ResilienceContext] = None):
        self.base_url = _normalize(url)
        self.url = self.base_url
        self.cfg = cfg or NodeConfig()
        self._resilience = resilience

    async def close(self) -> None:
        """Nothing to release: every request closes its own connection."""

    async def _fetch(self, url: str, method: str = "GET",
                     body: Optional[bytes] = None,
                     headers: Optional[dict] = None) -> dict:
        """One request; the decoded JSON body, whatever the status (a
        peer's error envelope included)."""
        _status, raw = await asyncio.wait_for(
            fetch(url, method, body, headers=headers,
                  max_bytes=self.cfg.response_cap),
            self.cfg.http_timeout)
        return json.loads(raw or b"{}")

    async def _resilient(self, attempt, label: str,
                         site: Optional[str] = None,
                         site_key: Optional[str] = None):
        """``attempt`` (a coroutine factory) under the breaker, the fault
        site (``rpc.<label>`` keyed by the peer unless ``site`` and
        ``site_key`` name another: the snapshot bootstrap's
        ``snapshot.fetch``, so a chaos spec can fault restore traffic
        alone) and the retry policy; a single attempt without a
        ResilienceContext."""
        ctx = self._resilience
        if ctx is None:
            return await attempt()
        breaker = ctx.breakers.get(self.base_url)
        if not breaker.available():
            trace.inc("resilience.breaker_rejected")
            raise CircuitOpenError(self.base_url)

        async def guarded():
            injector = faultinject.get_injector()
            if injector is not None:
                await injector.fire(site or f"rpc.{label}",
                                    site_key or self.base_url)
            return await attempt()

        def on_retry(exc, retry_no):
            trace.inc("resilience.rpc_retries")
            log.debug("retry %d for %s %s: %s", retry_no, self.base_url,
                      label, exc)

        try:
            out = await call_with_retry(
                guarded, ctx.policy, retry_on=TRANSIENT_ERRORS,
                rng=ctx.rng, on_retry=on_retry)
        except TRANSIENT_ERRORS:
            breaker.record_failure()
            raise
        breaker.record_success()
        return out

    async def request(self, path: str, args: dict,
                      sender_node: str = "") -> dict:
        """POST JSON for ``push_block``/``push_tx``, GET with query params
        for any other path (nodes_manager.py:192-209), so a gossiped
        ``add_node`` lands on the peers' GET route."""
        headers = self._rpc_headers(sender_node)
        url = f"{self.base_url}/{path}"
        if path in ("push_block", "push_tx"):
            body = json.dumps(args).encode()
            return await self._resilient(
                lambda: self._fetch(url, "POST", body, headers), path)
        query = urlencode({k: str(v) for k, v in args.items()})
        if query:
            url += "?" + query
        return await self._resilient(
            lambda: self._fetch(url, headers=headers), path)

    @staticmethod
    def _rpc_headers(sender_node: str) -> dict:
        """Common outbound headers: peer identity plus the current trace
        ID, so a gossiped tx/block keeps one trace across nodes (the
        receiving middleware adopts X-Upow-Trace)."""
        headers = {"Sender-Node": sender_node} if sender_node else {}
        tid = trace.current_trace_id()
        if tid is not None:
            headers[trace.TRACE_HEADER] = tid
        return headers

    async def get(self, path: str, params: Optional[dict] = None,
                  sender_node: str = "", site: Optional[str] = None,
                  site_key: Optional[str] = None) -> dict:
        """GET ``path`` with query ``params``; the decoded JSON body."""
        query = urlencode(params or {})
        url = f"{self.base_url}/{path}" + (f"?{query}" if query else "")
        headers = self._rpc_headers(sender_node)
        return await self._resilient(
            lambda: self._fetch(url, headers=headers), path, site=site,
            site_key=site_key)

    @staticmethod
    def _result(res: dict):
        """Unwrap an RPC envelope; a peer's error or rate-limit body
        becomes a readable error instead of a bare KeyError."""
        if "result" not in res:
            raise RuntimeError(
                f"peer error: {res.get('error', res)!s:.200}")
        return res["result"]

    async def get_block(self, block_no: int) -> dict:
        return self._result(await self.get(
            "get_block", {"block": str(block_no),
                          "full_transactions": "false"}))

    async def get_blocks(self, offset: int, limit: int) -> list:
        return self._result(await self.get(
            "get_blocks", {"offset": str(offset), "limit": str(limit)}))

    async def get_nodes(self) -> list:
        return self._result(await self.get("get_nodes"))

    # Both snapshot RPCs run under the ordinary breaker and retry stack
    # but fire the ``snapshot.fetch`` site, keyed by the document, so a
    # chaos spec can fault restore traffic, or one chunk, alone.

    async def snapshot_manifest(self) -> dict:
        return self._result(await self.get(
            "snapshot/manifest", site="snapshot.fetch",
            site_key=f"{self.base_url}#manifest"))

    async def snapshot_chunk(self, i: int) -> bytes:
        doc = self._result(await self.get(
            f"snapshot/chunk/{int(i)}", site="snapshot.fetch",
            site_key=f"{self.base_url}#chunk/{int(i)}"))
        return bytes.fromhex(doc["data"])
