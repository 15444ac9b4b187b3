"""The RPC client for one peer (reference nodes_manager.py:174-210).

The port's copy of the JAX package's ``NodeInterface``, on the standard
library's client in :mod:`.http` instead of an aiohttp session: each
request opens its own connection, is cut after ``node.http_timeout``
seconds, and its body is refused past ``node.response_cap`` bytes.
Chain sync reads a peer through it (``get_mining_info``, ``get_block``,
``get_blocks``).  The peer book, its circuit breakers and retries,
gossip and the ``Sender-Node`` learning come with the peers slice
(ROADMAP.md, A5c).
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional
from urllib.parse import urlencode

from ..config import NodeConfig
from .http import fetch


def _normalize(url: str) -> str:
    url = (url or "").strip().strip("/")
    if url and not url.startswith("http"):
        url = "http://" + url
    return url


class NodeInterface:
    """RPC client for one remote node."""

    def __init__(self, url: str, cfg: Optional[NodeConfig] = None):
        self.base_url = _normalize(url)
        self.url = self.base_url
        self.cfg = cfg or NodeConfig()

    async def close(self) -> None:
        """Nothing to release: every request closes its own connection."""

    async def get(self, path: str, params: Optional[dict] = None,
                  sender_node: str = "") -> dict:
        """GET ``path`` with query ``params``; the decoded JSON body,
        whatever the status (a peer's error envelope included)."""
        query = urlencode(params or {})
        url = f"{self.base_url}/{path}" + (f"?{query}" if query else "")
        headers = {"Sender-Node": sender_node} if sender_node else {}
        _status, body = await asyncio.wait_for(
            fetch(url, headers=headers, max_bytes=self.cfg.response_cap),
            self.cfg.http_timeout)
        return json.loads(body or b"{}")

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
