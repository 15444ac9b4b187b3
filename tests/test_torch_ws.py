"""The port's ``/ws`` against the JAX node's, on the wire.

* **Nodes.**  A JAX node (aiohttp ``TestServer``) and the port's node
  (``device="cpu"``) on copies of one JAX-written chain, both with
  ``/ws`` at its defaults, get the messages of the JAX package's
  ``test_node.py`` WebSocket cases from one client, the aiohttp client
  and the port's own ``ws_connect`` in turn: the ``new_block`` frame of
  a pushed block and the ``new_transaction`` frame of a pushed tx, the
  per-IP cap's 403, the rate limit, the unsubscribe and JSON errors.
  Each reply is compared message by message (a ``connection_id`` and a
  frame's ``timestamp`` by their shape: they are random and the wall
  clock).
* **Hub.**  The port's hub reaps an idle connection and a subscriber
  whose send the ``ws.send`` fault site fails; the drop-oldest queue
  sheds the same messages as the JAX hub's.
* **Transport.**  The same raw bytes go to the JAX hub on aiohttp and
  the port's hub on the port's server: the handshake's 101 and
  ``Sec-WebSocket-Accept``, the 400s of a missing or bad upgrade header,
  version or key, the 403 and 503 refusals, an unmasked frame, a
  fragmented message, a message over the cap (1009), a ping's pong, the
  close handshake, text that is not UTF-8 (1007), a reserved bit and an
  unknown opcode (1002), and the heartbeat's ping and drop.  The status,
  the body of a refusal, and every frame the server sends until it
  closes must be equal.
"""

import asyncio
import base64
import hashlib
import json
import os
import re
from datetime import datetime

import aiohttp
import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

import upow_tpu.config as jconfig
import upow_tpu.ws.hub as jhub
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.ws.hub as thub
from test_torch_hotcache import Both, chain_file, nodes  # noqa: F401
from upow_tpu_torch.node.http import (HttpServer, WsHandshakeError,
                                      ws_connect)
from upow_tpu_torch.resilience import faultinject

CLIENTS = ["aiohttp", "port"]


# ------------------------------------------------------------ clients ----

class _AioClient:
    """aiohttp's client with the port client's few calls."""

    def __init__(self, ws):
        self.ws = ws

    async def send_str(self, text):
        await self.ws.send_str(text)

    async def receive_json(self):
        return json.loads((await asyncio.wait_for(self.ws.receive(),
                                                  10)).data)

    async def close(self):
        await self.ws.close()


class _PortClient(_AioClient):
    async def receive_json(self):
        return json.loads((await self.ws.receive(timeout=10)).data)


async def _connect(kind, session, url):
    """A connection, or the refused handshake's status."""
    if kind == "aiohttp":
        try:
            return _AioClient(await session.ws_connect(url))
        except aiohttp.WSServerHandshakeError as e:
            return e.status
    try:
        return _PortClient(await ws_connect(url))
    except WsHandshakeError as e:
        return e.status


def _shape(msg: dict) -> dict:
    """A message with its random and wall-clock fields checked and
    replaced by their shape."""
    msg = dict(msg)
    if "connection_id" in msg:
        assert re.fullmatch(r"[0-9a-f]{12}", msg["connection_id"])
        msg["connection_id"] = "<id>"
    if msg.get("type") in ("new_block", "new_transaction"):
        datetime.fromisoformat(msg["timestamp"])
        msg["timestamp"] = "<iso>"
    return msg


class Pair:
    """One connection to each node, one message to both."""

    def __init__(self, kind, session, b):
        self.kind, self.session, self.b = kind, session, b
        self.conns = {}

    async def connect(self):
        got = {n: await _connect(self.kind, self.session,
                                 self.b.urls[n] + "/ws")
               for n in ("jax", "port")}
        if isinstance(got["jax"], int) or isinstance(got["port"], int):
            assert got["jax"] == got["port"]
            return got["port"]
        self.conns = got
        return await self.receive()

    async def receive(self):
        got = {n: _shape(await c.receive_json())
               for n, c in self.conns.items()}
        assert got["port"] == got["jax"]
        return got["port"]

    async def send(self, message):
        text = message if isinstance(message, str) else json.dumps(message)
        for c in self.conns.values():
            await c.send_str(text)
        return await self.receive()

    async def close(self):
        for c in self.conns.values():
            await c.close()


def _run(jcfg, tcfg, kind, scenario):
    async def main():
        async with Both(jcfg, tcfg) as b:
            async with aiohttp.ClientSession() as session:
                return await scenario(b, lambda: Pair(kind, session, b))
    return asyncio.run(main())


@pytest.mark.parametrize("kind", CLIENTS)
def test_ws_new_block_broadcast(nodes, kind):  # noqa: F811
    jcfg, tcfg, _leaves = nodes

    async def scenario(b, pair):
        ws = pair()
        hello = await ws.connect()
        assert hello == {"type": "connection_established",
                         "connection_id": "<id>",
                         "channels": ["block", "transaction"]}
        sub = await ws.send({"type": "subscribe_block"})
        assert sub == {"type": "success", "message": "Subscribed to block",
                       "data": {"channel": "block"}}
        await b.push_block()
        msg = await ws.receive()
        tip = await b.tnode.state.get_last_block()
        assert msg["type"] == "new_block"
        assert (msg["data"]["block_no"], msg["data"]["block_hash"]) == \
            (tip["id"], tip["hash"])
        assert msg["data"]["transactions_count"] == 0
        assert (await ws.send({"type": "ping"})) == {"type": "pong"}
        err = await ws.send({"type": "bogus"})
        assert err["error_code"] == "INVALID_MESSAGE_TYPE"
        await ws.close()

    _run(jcfg, tcfg, kind, scenario)


@pytest.mark.parametrize("kind", CLIENTS)
def test_ws_transaction_broadcast(nodes, kind):  # noqa: F811
    jcfg, tcfg, leaves = nodes

    async def scenario(b, pair):
        ws = pair()
        await ws.connect()
        await ws.send({"type": "subscribe_transaction"})
        tx = b.chain.spend([leaves[0]], 2)
        _s, raw = await b.both("/push_tx", method="POST",
                               payload={"tx_hex": tx.hex()})
        assert json.loads(raw)["ok"]
        msg = await ws.receive()
        assert msg["type"] == "new_transaction"
        data = msg["data"]
        assert sorted(data) == ["amount", "fees", "from", "to", "tx_hash"]
        assert (data["tx_hash"], data["from"], data["to"]) == (
            tx.hash(), b.chain.addr, [b.chain.addr] * 2)
        await ws.close()

    _run(jcfg, tcfg, kind, scenario)


@pytest.mark.parametrize("kind", CLIENTS)
def test_ws_limits(nodes, kind):  # noqa: F811
    """The per-IP cap (403 on the third connection), the message rate
    limit, unsubscribe without subscribe, the transaction channel's
    round trip and malformed JSON, on both nodes alike."""
    jcfg, tcfg, _leaves = nodes

    async def scenario(b, pair):
        for node in (b.jnode, b.tnode):
            node.ws_hub.cfg.max_per_user = 2
            node.ws_hub.cfg.rate_limit_per_minute = 5
        ws1, ws2 = pair(), pair()
        await ws1.connect()
        await ws2.connect()
        assert await pair().connect() == 403
        for _ in range(5):
            assert (await ws1.send({"type": "ping"})) == {"type": "pong"}
        err = await ws1.send({"type": "ping"})
        assert err["error_code"] == "RATE_LIMIT_EXCEEDED"
        err = await ws2.send({"type": "unsubscribe_block"})
        assert err["error_code"] == "NOT_SUBSCRIBED"
        for mtype in ("subscribe_transaction", "unsubscribe_transaction"):
            assert (await ws2.send({"type": mtype}))["type"] == "success"
        assert (await ws2.send("{nope"))["error_code"] == "INVALID_JSON"
        stats = [node.ws_hub.get_stats() for node in (b.jnode, b.tnode)]
        assert stats[0]["total_connections"] == \
            stats[1]["total_connections"] == 2
        await ws1.close()
        await ws2.close()

    _run(jcfg, tcfg, kind, scenario)


# ---------------------------------------------------------------- hub ----

async def _port_hub_server(hub):
    server = HttpServer(hub.handle)
    await server.start()
    return server


def test_ws_hub_idle_expiry():
    """The cleanup loop closes and drops a connection idle past
    ``connection_expiry`` and leaves an active one alone."""
    async def main():
        hub = thub.WsHub(tconfig.WsConfig(heartbeat_interval=1000.0,
                                          connection_expiry=0.3,
                                          cleanup_interval=0.05))
        server = await _port_hub_server(hub)
        try:
            ws = await ws_connect(f"http://127.0.0.1:{server.port}/ws")
            assert (await ws.receive_json())["type"] == \
                "connection_established"
            for _ in range(4):  # pings refresh last_activity
                await ws.send_json({"type": "ping"})
                assert (await ws.receive_json())["type"] == "pong"
                await asyncio.sleep(0.1)
            assert hub.get_stats()["total_connections"] == 1
            for _ in range(100):
                if hub.get_stats()["total_connections"] == 0:
                    break
                await asyncio.sleep(0.05)
            assert hub.get_stats()["total_connections"] == 0
            msg = await ws.receive(timeout=5)  # the server's close
            assert msg.type.name in ("CLOSE", "CLOSED", "CLOSING")
        finally:
            hub.close()
            await server.close()

    asyncio.run(main())


def test_ws_send_fault_injection_reaps_subscriber():
    """A ``ws.send`` error is a dead subscriber: the broadcast still
    queues, and the failed write reaps the connection."""
    async def main():
        hub = thub.WsHub(tconfig.WsConfig(heartbeat_interval=1000.0))
        server = await _port_hub_server(hub)
        try:
            ws = await ws_connect(f"http://127.0.0.1:{server.port}/ws")
            await ws.receive_json()
            await ws.send_json({"type": "subscribe_block"})
            assert (await ws.receive_json())["type"] == "success"
            assert await hub.broadcast_new_block({"block_no": 1}) == 1
            assert (await ws.receive_json())["type"] == "new_block"
            faultinject.install("ws.send:error", seed=0)
            assert await hub.broadcast_new_block({"block_no": 2}) == 1
            for _ in range(200):
                if hub.get_stats()["total_connections"] == 0:
                    break
                await asyncio.sleep(0.01)
            assert hub.get_stats()["total_connections"] == 0
            await ws.close()
        finally:
            faultinject.uninstall()
            hub.close()
            await server.close()

    asyncio.run(main())


def test_ws_drop_oldest_overflow_matches_jax():
    """A subscriber that stalls: with ``send_queue_max = 2`` six
    broadcasts shed the four oldest, and the two newest arrive once it
    drains, in both hubs."""
    async def run(hub_mod, cfg_cls):
        hub = hub_mod.WsHub(cfg_cls(send_queue_max=2))
        gate = asyncio.Event()

        class Sink:
            frames = []

            async def send_str(self, payload):
                await gate.wait()
                self.frames.append(json.loads(payload)["data"]["n"])

        sink = Sink()
        conn = hub.connect_local(sink, channels=("block",))
        sent = [await hub.broadcast_to_channel(
            "block", {"type": "new_block", "data": {"n": n}})
            for n in range(6)]
        dropped = conn.dropped
        gate.set()
        for _ in range(100):
            if len(sink.frames) == 2:
                break
            await asyncio.sleep(0.01)
        stats = hub.get_stats()
        hub.close()
        return sent, dropped, sink.frames, stats["dropped_messages"], \
            stats["send_queue_hwm"]

    got = [asyncio.run(run(jhub, jconfig.WsConfig)),
           asyncio.run(run(thub, tconfig.WsConfig))]
    assert got[1] == got[0]
    assert got[1] == ([1] * 6, 4, [4, 5], 4, 2)


# ---------------------------------------------------------- transport ----

KEY = "dGhlIHNhbXBsZSBub25jZQ=="


def _request(drop=(), **headers) -> bytes:
    h = {"Host": "127.0.0.1", "Upgrade": "websocket",
         "Connection": "Upgrade", "Sec-WebSocket-Key": KEY,
         "Sec-WebSocket-Version": "13"}
    h.update({k.replace("_", "-"): v for k, v in headers.items()})
    lines = ["GET /ws HTTP/1.1"] + [f"{k}: {v}" for k, v in h.items()
                                    if k not in drop]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _frame(opcode, payload=b"", fin=True, mask=True, rsv=0) -> bytes:
    """A client frame; masked unless told not to."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | rsv | opcode])
    bit = 0x80 if mask else 0
    if n < 126:
        head += bytes([bit | n])
    else:
        head += bytes([bit | 126]) + n.to_bytes(2, "big")
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + bytes(b ^ key[i % 4] for i, b in enumerate(payload))


async def _read_frame(reader):
    b0, b1 = await reader.readexactly(2)
    n = b1 & 0x7F
    if n == 126:
        n = int.from_bytes(await reader.readexactly(2), "big")
    elif n == 127:
        n = int.from_bytes(await reader.readexactly(8), "big")
    assert not b1 & 0x80, "a server frame is never masked"
    return b0, await reader.readexactly(n)


async def _exchange(port, request, frames=b"", quiet=0.3, keep=None):
    """What the server answers: the refusal's status, content type and
    body, or the 101's headers and every frame it sends (its first, the
    hub's hello, by shape) until it closes or stays quiet."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
    status = int(head.split(" ")[1])
    headers = {}
    for line in head.split("\r\n")[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    if status != 101:
        body = await reader.readexactly(int(headers["content-length"]))
        writer.close()
        return {"status": status, "type": headers["content-type"],
                "body": body}
    out = {"status": 101, "upgrade": headers["upgrade"].lower(),
           "connection": headers["connection"].lower(),
           "accept": headers["sec-websocket-accept"]}
    op, hello = await _read_frame(reader)
    out["hello"] = (op, _shape(json.loads(hello)))
    writer.write(frames)
    await writer.drain()
    got, eof = [], False
    while True:
        try:
            got.append(await asyncio.wait_for(_read_frame(reader), quiet))
        except asyncio.TimeoutError:
            break
        except (asyncio.IncompleteReadError, ConnectionError):
            eof = True
            break
    out["frames"], out["eof"] = got, eof
    if keep is not None:
        keep.append(writer)
    else:
        writer.close()
    return out


def _close(code, reason=b""):
    return code.to_bytes(2, "big") + reason


PING = json.dumps({"type": "ping"}).encode()
PONG = (0x81, json.dumps({"type": "pong"}).encode())

#: name -> (hub config, request, frames sent after the hello, quiet s)
EDGES = {
    "unmasked_frame": ({}, _request(), _frame(1, PING, mask=False), 0.3),
    "fragmented_message": ({}, _request(), _frame(1, PING[:9], fin=False)
                           + _frame(0, PING[9:]), 0.3),
    "over_the_cap_1009": ({"max_message_bytes": 64}, _request(),
                          _frame(1, b"x" * 100), 0.3),
    "ping_pong": ({}, _request(), _frame(9, b"hi"), 0.3),
    "close_handshake": ({}, _request(), _frame(8, _close(1001, b"bye")),
                        0.3),
    "not_utf8_1007": ({}, _request(), _frame(1, b"\xff\xfe"), 0.3),
    "reserved_bit_1002": ({}, _request(), _frame(1, PING, rsv=0x20), 0.3),
    "unknown_opcode_1002": ({}, _request(), _frame(3, b"x"), 0.3),
    "binary_ignored": ({}, _request(), _frame(2, b"\x00\x01"), 0.3),
    "heartbeat_drop": ({"heartbeat_interval": 0.3}, _request(), b"", 1.5),
    "no_upgrade_header": ({}, _request(drop=("Upgrade",)), b"", 0.3),
    "no_connection_upgrade": ({}, _request(Connection="keep-alive"), b"",
                              0.3),
    "bad_version": ({}, _request(Sec_WebSocket_Version="12"), b"", 0.3),
    "bad_key": ({}, _request(Sec_WebSocket_Key="abc"), b"", 0.3),
}


async def _jax_server(hub):
    app = web.Application()
    app.router.add_get("/ws", hub.handle)
    server = TestServer(app)
    await server.start_server()
    return server, server.port


async def _port_server(hub):
    server = await _port_hub_server(hub)
    return server, server.port


async def _on_hub(make_server, hub, body):
    server, port = await make_server(hub)
    try:
        return await body(port)
    finally:
        hub.close()
        await server.close()


def _both_hubs(cfg, body):
    """``body(port)`` against the JAX hub on aiohttp and the port's hub
    on its server, each with the hub config ``cfg``."""
    got = {}
    for name, hub_mod, cfg_cls, make in (
            ("jax", jhub, jconfig.WsConfig, _jax_server),
            ("port", thub, tconfig.WsConfig, _port_server)):
        hub = hub_mod.WsHub(cfg_cls(**cfg))
        got[name] = asyncio.run(_on_hub(make, hub, body))
    assert got["port"] == got["jax"]
    return got["port"]


@pytest.mark.parametrize("edge", list(EDGES))
def test_transport_edges_match_aiohttp(edge):
    cfg, request, frames, quiet = EDGES[edge]

    async def body(port):
        return await _exchange(port, request, frames, quiet)

    got = _both_hubs(cfg, body)
    accept = base64.b64encode(hashlib.sha1(
        KEY.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
    if got["status"] == 101:
        assert got["accept"] == accept.decode()
        assert got["hello"][1]["type"] == "connection_established"
    want = {
        "unmasked_frame": ([PONG], False),
        "fragmented_message": ([PONG], False),
        "over_the_cap_1009": ([(0x88, _close(1009))], True),
        "ping_pong": ([(0x8A, b"hi")], False),
        "close_handshake": ([(0x88, _close(1000))], True),
        "not_utf8_1007": ([(0x88, _close(1007))], True),
        "reserved_bit_1002": ([(0x88, _close(1002))], True),
        "unknown_opcode_1002": ([(0x88, _close(1002))], True),
        "binary_ignored": ([], False),
        "heartbeat_drop": ([(0x89, b"")], True),
    }
    if edge in want:
        assert (got["frames"], got["eof"]) == want[edge]
    else:
        assert got["status"] == 400 and got["type"].startswith("text/plain")


@pytest.mark.parametrize("cap, status, text", [
    ({"max_per_user": 1}, 403, b"Too many connections from this IP"),
    ({"max_connections": 1}, 503, b"Too many connections")])
def test_refusals_match_aiohttp(cap, status, text):
    async def body(port):
        kept = []
        first = await _exchange(port, _request(), keep=kept)
        second = await _exchange(port, _request())
        for writer in kept:
            writer.close()
        return first["status"], second

    first, second = _both_hubs(cap, body)
    assert first == 101
    assert second == {"status": status, "type": "text/plain; charset=utf-8",
                      "body": text}


@pytest.mark.parametrize("server", ["jax", "port"])
def test_ws_connect_against_both_servers(server):
    """The port's client on aiohttp's server and on the port's: the
    hello, a subscription, a broadcast, a ping and the close."""
    hub_mod, cfg_cls, make = {
        "jax": (jhub, jconfig.WsConfig, _jax_server),
        "port": (thub, tconfig.WsConfig, _port_server)}[server]
    hub = hub_mod.WsHub(cfg_cls())

    async def body(port):
        ws = await ws_connect(f"http://127.0.0.1:{port}/ws")
        out = [_shape(await ws.receive_json())]
        await ws.send_json({"type": "subscribe_transaction"})
        out.append(await ws.receive_json())
        assert await hub.broadcast_new_transaction({"tx_hash": "ab"}) == 1
        out.append(_shape(await ws.receive_json()))
        await ws.ping(b"p")
        await ws.send_json({"type": "ping"})
        out.append(await ws.receive_json())
        await ws.close()
        out.append(ws.close_code)
        return out

    out = asyncio.run(_on_hub(make, hub, body))
    assert out == [
        {"type": "connection_established", "connection_id": "<id>",
         "channels": ["block", "transaction"]},
        {"type": "success", "message": "Subscribed to transaction",
         "data": {"channel": "transaction"}},
        {"type": "new_transaction", "data": {"tx_hash": "ab"},
         "timestamp": "<iso>"},
        {"type": "pong"}, 1000]


def test_aiohttp_client_against_the_port_hub():
    """aiohttp's own client on the port's server: the handshake's
    accept check, the hello and the close handshake."""
    async def body(port):
        async with aiohttp.ClientSession() as session:
            ws = await session.ws_connect(f"http://127.0.0.1:{port}/ws")
            hello = await ws.receive_json()
            await ws.send_json({"type": "ping"})
            pong = await ws.receive_json()
            await ws.close()
            return hello["type"], pong, ws.close_code

    hub = thub.WsHub(tconfig.WsConfig())
    assert asyncio.run(_on_hub(_port_server, hub, body)) == (
        "connection_established", {"type": "pong"}, 1000)
