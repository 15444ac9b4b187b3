"""The rest of the network, stood in for by the benchmark.

One HTTP server on a loopback port serves what a catching-up node and
a rig's miner ask of their peers and pool:

* ``get_blocks`` and ``get_block`` from the generated chain, in the
  pages a port node with default settings sends (``storage.get_blocks``
  with its size cap: a page ends before the block that takes its
  transactions' hex past eight full blocks, ``MAX_BLOCK_SIZE_HEX * 8``);
* ``get_mining_info``: the chain's tip with the configuration's
  difficulty, the pool's template;
* ``push_block``: the miner's blocks, checked with hashlib against the
  tip and that difficulty (the chain does not grow).

A block may be served tampered the first time a page starts at it: one
transaction's signature changed, alone in its page (as a peer whose tip
it is would serve it), so the node must refuse it.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from decimal import Decimal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from . import uformat
from .chain import Block

PAGE_CAP = uformat.MAX_BLOCK_SIZE_HEX * 8


def tampered(block: Block, index: int) -> dict:
    """``block`` as served with the signature of its ``index``-th
    transaction (after the coinbase) changed: s + 1."""
    out = block.json()
    raw = block.txs[1 + index]
    tx = uformat.parse_tx(raw)
    r, s = tx["sigs"][0]
    out["transactions"][1 + index] = uformat.tx_full(
        tx["body"], [(r, (s + 1) % uformat.N)]).hex()
    return out


class Stub:
    def __init__(self, blocks: List[Block], difficulty: Decimal,
                 tamper: Optional[Dict[int, int]] = None):
        self.blocks = {b.height: b for b in blocks}
        self.tip = blocks[-1]
        self.difficulty = Decimal(difficulty)
        self.tamper = dict(tamper or {})   # height -> tx index, served once
        self.served_tampered: List[int] = []
        self.pages: List[tuple] = []       # (time, offset, first, last)
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None

    # --- the routes ---------------------------------------------------------
    def page(self, offset: int, limit: int) -> list:
        out, size = [], 0
        with self._lock:
            if offset in self.tamper and limit > 0:
                out.append(tampered(self.blocks[offset], self.tamper.pop(offset)))
                self.served_tampered.append(offset)
                limit = 0
            for h in range(max(offset, 1), offset + limit):
                block = self.blocks.get(h)
                if block is None:
                    break
                body = block.json()
                size += sum(len(t) for t in body["transactions"])
                if size > PAGE_CAP:
                    break
                out.append(body)
        if out:
            self.pages.append((time.monotonic(), offset,
                               out[0]["block"]["id"], out[-1]["block"]["id"]))
        return out

    def mining_info(self) -> dict:
        tip = self.tip.json()["block"]
        return {"difficulty": float(self.difficulty), "last_block": tip,
                "pending_transactions": [], "pending_transactions_hashes": [],
                "merkle_root": hashlib.sha256(b"").hexdigest()}

    def push_block(self, body: dict) -> dict:
        content = body.get("block_content", "")
        try:
            head = uformat.split_header(content)
        except ValueError as e:
            verdict = {"ok": False, "error": f"malformed block content: {e}"}
        else:
            block_hash = hashlib.sha256(bytes.fromhex(content)).hexdigest()
            ok = (head["prev"] == self.tip.hash and uformat.pow_ok(
                block_hash, self.tip.hash, self.difficulty))
            verdict = {"ok": True} if ok else {"ok": False,
                                               "error": "block not valid"}
        return verdict

    # --- the server -----------------------------------------------------------
    def start(self) -> str:
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, payload, status: int = 200) -> None:
                raw = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                url = urlparse(self.path)
                q = {k: v[-1] for k, v in parse_qs(url.query).items()}
                path = url.path.strip("/")
                if path == "get_blocks":
                    offset = max(0, int(q.get("offset", 0)))
                    limit = max(0, min(int(q.get("limit", 100)), 1000))
                    self._send({"ok": True, "result": stub.page(offset, limit)})
                elif path == "get_block":
                    block = stub.blocks.get(int(q.get("block", "0") or 0))
                    if block is None:
                        self._send({"ok": False, "error": "Block not found"})
                    else:
                        body = block.json()
                        self._send({"ok": True, "result": {
                            "block": body["block"],
                            "transactions": body["transactions"],
                            "full_transactions": None}})
                elif path == "get_mining_info":
                    self._send({"ok": True, "result": stub.mining_info()})
                elif path == "":
                    self._send({"ok": True})
                else:
                    self._send({"ok": False, "error": "Not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if urlparse(self.path).path.strip("/") == "push_block":
                    self._send(stub.push_block(body))
                else:
                    self._send({"ok": False, "error": "Not found"}, 404)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{self._server.server_address[1]}/"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
