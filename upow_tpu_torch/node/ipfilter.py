"""IP filtering + local-address guard (the port's copy of the JAX
package's ``node/ipfilter.py``).

Mirrors the reference's two small pieces of endpoint-surface policy:

* ``ip_config.json`` hot-reloaded whitelist / blocklist / per-endpoint
  blocks (upow/node/ip_manager.py:8-52), reload every 300 s.
* the private-range table guarding the custodial ``send_to_address``
  endpoint (upow/node/utils.py:4-31).
"""

from __future__ import annotations

import ipaddress
import json
import os
import time
from typing import Optional

_PRIVATE_NETS = [
    ipaddress.ip_network(n)
    for n in (
        # the reference's full list (node/utils.py:9-27): RFC1918 plus
        # every special-purpose v4 range — none of these is a routable
        # public peer
        "127.0.0.0/8",      # loopback
        "10.0.0.0/8",       # RFC1918
        "172.16.0.0/12",
        "192.168.0.0/16",
        "0.0.0.0/8",        # "this network"
        "100.64.0.0/10",    # CGNAT
        "169.254.0.0/16",   # link-local
        "192.0.0.0/24",     # IETF protocol assignments
        "192.0.2.0/24",     # TEST-NET-1
        "192.88.99.0/24",   # 6to4 relay (deprecated)
        "198.18.0.0/15",    # benchmarking
        "198.51.100.0/24",  # TEST-NET-2
        "203.0.113.0/24",   # TEST-NET-3
        "224.0.0.0/4",      # multicast
        "233.252.0.0/24",   # MCAST-TEST-NET
        "240.0.0.0/4",      # reserved
        "255.255.255.255/32",
        # v6 equivalents (beyond the reference, which is v4-only)
        "::1/128",
        "fc00::/7",
        "fe80::/10",
    )
]


def is_local_ip(ip: str) -> bool:
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return False
    return any(addr in net for net in _PRIVATE_NETS)


class IpFilter:
    """Reference ip_manager.py semantics, hot-reloaded: a NON-EMPTY
    whitelist is exclusive (only listed IPs pass; the blocklist is then
    irrelevant — ip_manager.py:42-44's ``ip in whitelist or (ip not in
    blocklist and not whitelist)``); with no whitelist, the blocklist
    denies; endpoint blocks apply to every caller, whitelisted or not
    (main.py:306 checks them after the IP gate with no bypass)."""

    def __init__(self, path: str = "ip_config.json",
                 reload_every: float = 300.0):
        self.path = path
        self.reload_every = reload_every
        self._loaded_at = 0.0
        self.whitelist: set = set()
        self.blocklist: set = set()
        self.block_endpoints: set = set()
        self._maybe_reload(force=True)

    def _maybe_reload(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._loaded_at < self.reload_every:
            return
        self._loaded_at = now
        if not self.path or not os.path.exists(self.path):
            return
        try:
            # tiny admin JSON, re-read at most once per reload_every
            # seconds: not worth an executor hop in the middleware
            with open(self.path) as f:
                data = json.load(f)
            self.whitelist = set(data.get("whitelist", []))
            self.blocklist = set(data.get("blocklist", []))
            # normalize: config entries may be written with or without a
            # leading slash; matching strips both sides
            self.block_endpoints = {
                str(e).strip("/") for e in data.get("block_endpoints", [])
            }
        except (json.JSONDecodeError, OSError):
            pass

    def allowed(self, ip: str, endpoint: Optional[str] = None) -> bool:
        self._maybe_reload()
        if self.whitelist:
            if ip not in self.whitelist:
                return False
        elif ip in self.blocklist:
            return False
        if endpoint is not None and endpoint.strip("/") in self.block_endpoints:
            return False
        return True
