"""Adversary actors for swarm scenarios (the port's copy of the JAX
package's ``swarm/adversary.py``).

Adversaries are *raw* loopback endpoints (``LoopbackHub.register_raw``)
— they answer peer RPCs without being nodes, so they can lie freely:

* :class:`EclipseAdversary` — a clique of fake peers that monopolise a
  victim's peer view.  While the eclipse holds they look perfectly
  healthy (probes succeed, ``get_nodes`` recommends only each other,
  ``get_blocks`` returns an empty page so sync "completes" without
  progress).  Once ``unmask()`` is called they go dark: every RPC
  raises ``ConnectionError``, which the victim's retry stack turns
  into breaker failures and health-score decay — exactly the signal
  ``peers.ranked()`` needs to resurface the honest peer.

  Adversary URLs sit in ``10.66.*`` so they sort *before* the honest
  ``10.77.*`` nodes on the ranked() URL tie-break: recovery in the
  eclipse scenario is earned through health scores, never through
  lexicographic luck.

* :class:`SpamAdversary` — a driver-side flooder pushing garbage and
  duplicate transactions at every node through its own (shaped) links.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .transport import LoopbackHub


class EclipseAdversary:
    """A clique of lying peers registered on the hub."""

    def __init__(self, hub: LoopbackHub, count: int = 4,
                 subnet: str = "10.66.0"):
        self.hub = hub
        self.unmasked = False
        self.calls = 0
        self.calls_after_unmask = 0
        self.urls: List[str] = []
        for k in range(count):
            url = f"http://{subnet}.{k + 1}:3006"
            self.urls.append(url)
            hub.register_raw(url, self._handler, ip=f"{subnet}.{k + 1}")

    def unmask(self) -> None:
        """The attack ends: the fake peers drop off the network."""
        self.unmasked = True

    async def _handler(self, method: str, path: str, params: dict,
                       json_body: Optional[dict]) -> Tuple[int, dict]:
        self.calls += 1
        if self.unmasked:
            self.calls_after_unmask += 1
            raise ConnectionResetError("eclipse adversary unmasked")
        if path == "/get_nodes":
            # recommend only the clique: keeps the victim's view closed
            return 200, {"ok": True, "result": list(self.urls)}
        if path == "/get_blocks":
            # an empty page means "you are up to date" — the stall that
            # makes an eclipse dangerous: sync SUCCEEDS without progress
            return 200, {"ok": True, "result": []}
        if path in ("/push_block", "/push_tx", "/add_node"):
            return 200, {"ok": True}  # swallow gossip silently
        return 200, {"ok": True, "result": "ok"}


class SpamAdversary:
    """Floods ``push_tx`` with garbage and duplicates via the hub.

    The spammer is a registered matrix endpoint, so partitions and drop
    policies apply to its traffic like anyone else's.
    """

    def __init__(self, hub: LoopbackHub, url: str = "http://10.66.9.9:3006",
                 ip: str = "10.66.9.9"):
        self.hub = hub
        self.url = url
        hub.register_client(url, ip)
        self.sent = 0
        self.accepted = 0
        self.rejected = 0

    async def _push(self, dst: str, tx_hex: str) -> bool:
        import json

        self.sent += 1
        try:
            _, body = await self.hub.request(
                self.url, dst, "GET", "/push_tx",
                params={"tx_hex": tx_hex})
            ok = bool(json.loads(body or b"{}").get("ok"))
        except (ConnectionError, OSError):
            ok = False
        if ok:
            self.accepted += 1
        else:
            self.rejected += 1
        return ok

    async def flood_garbage(self, targets: List[str], count: int) -> None:
        """Syntactically invalid transactions, round-robin."""
        for k in range(count):
            blob = (b"\xde\xad" + k.to_bytes(4, "big")).hex()
            await self._push(targets[k % len(targets)], blob)

    async def flood_duplicates(self, targets: List[str], tx_hex: str,
                               count: int) -> None:
        """The same valid transaction pushed over and over, everywhere."""
        for k in range(count):
            await self._push(targets[k % len(targets)], tx_hex)
