"""WebSocket push hub: channels, caps, heartbeats, typed broadcasts.

The port's copy of the JAX package's ``ws/hub.py``, on the standard
library's WebSocket transport (:mod:`..node.http`) instead of
aiohttp's: the same frames, limits, refusals and counters.

One class covers what the reference spreads over five modules
(websocket/socket_endpoint.py, socket_manager.py, socket_connection.py,
socket_handlers.py, socket_utils.py — ~1.1k LoC): per-channel subscriber
sets, per-IP connection caps, a token-bucket message rate limit, 64 KB
message cap, heartbeat pings with idle expiry, and the two typed
broadcasts ``new_block`` / ``new_transaction``.

Wire compatibility with the reference client protocol:
``{"type": "subscribe_block"|"unsubscribe_block"|"ping"|"pong"}`` in,
``{"type": "new_block"|"new_transaction", "data": ..., "timestamp": ...}``
out.  ``subscribe_transaction`` is ALSO accepted here: the reference
routes it (socket_handlers.py:23-31) but forgot it in
ALLOWED_MESSAGE_TYPES (socket_config.py:18-23), making it unreachable —
an evident bug, fixed rather than replicated since no working reference
client can depend on the broken behavior.

Delivery is decoupled from broadcast: every connection owns a bounded
send queue drained by a per-connection writer task, so one stalled
subscriber (full TCP window, hung middlebox) can NEVER block the
broadcast fan-out to everyone else.  Overflow sheds the OLDEST queued
message for that subscriber (drop-slowest: the laggard loses history,
live clients lose nothing) and counts it — exported as
``upow_ws_dropped_messages`` on /metrics.  A failed wire write reaps
the connection from the writer, exactly like the old inline reap.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from collections import deque
from datetime import datetime, timezone
from typing import Dict, Optional, Set

from ..config import WsConfig
from ..logger import get_logger
from ..node.http import (HTTPForbidden, HTTPServiceUnavailable, Request,
                         WebSocketResponse, WSMsgType, text_response)

log = get_logger("ws")


def _retrieve(task: "asyncio.Task", what: str) -> None:
    """Done-callback for hub background tasks: retrieve and log a crash
    instead of leaving 'Task exception was never retrieved' to the GC
    (which surfaces minutes later, far from the cause, or never)."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.error("ws %s task died: %r", what, exc)

# broadcast encoder, module-level so tests can swap in a counting
# wrapper: broadcast_to_channel serializes each message through this
# exactly ONCE and fans the shared string out to every subscriber
# queue — per-subscriber dumps made a 10k-subscriber broadcast pay
# 10k identical encodes
_encode = json.dumps

_SUBSCRIBE = {
    "subscribe_block": ("block", True),
    "unsubscribe_block": ("block", False),
    "subscribe_transaction": ("transaction", True),
    "unsubscribe_transaction": ("transaction", False),
}


class WsConnection:
    """Per-connection state: socket, subscriptions, rate bucket, stats,
    and the bounded send queue its writer task drains."""

    def __init__(self, ws: WebSocketResponse, ip: str, cfg: WsConfig):
        self.id = uuid.uuid4().hex[:12]
        self.ws = ws
        self.ip = ip
        self.cfg = cfg
        self.channels: Set[str] = set()
        self.connected_at = time.monotonic()
        self.last_activity = time.monotonic()
        self.messages_in = 0
        self.messages_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.dropped = 0            # messages shed by queue overflow
        self.queue_hwm = 0          # deepest the send queue ever got
        self._bucket_times: list = []
        # 0 = unbounded (never shed); the deque IS the queue, the event
        # signals the writer — a plain asyncio.Queue cannot drop-oldest
        self._queue: deque = deque(
            maxlen=cfg.send_queue_max if cfg.send_queue_max > 0 else None)
        self._queue_event = asyncio.Event()
        self._closed = False

    def rate_ok(self) -> bool:
        now = time.monotonic()
        self._bucket_times = [t for t in self._bucket_times if now - t < 60.0]
        if len(self._bucket_times) >= self.cfg.rate_limit_per_minute:
            return False
        self._bucket_times.append(now)
        return True

    async def send(self, message) -> bool:
        """Enqueue for the writer task; never blocks on the socket.  A
        full queue sheds this subscriber's OLDEST pending message
        (drop-slowest).  Returns False once the connection is closed.
        ``message`` is a dict (per-connection replies, encoded at write
        time) or an already-encoded ``str`` shared by a broadcast."""
        if self._closed:
            return False
        if self._queue.maxlen and len(self._queue) == self._queue.maxlen:
            self._queue.popleft()  # deque would do this silently; count it
            self.dropped += 1
            try:
                from ..telemetry import event as _event

                # WHICH subscriber is shedding (and how badly) was
                # invisible on /metrics — the counter is hub-global
                _event("ws_queue_evict", subscriber=self.id, ip=self.ip,
                       dropped_total=self.dropped,
                       queue_len=len(self._queue) + 1)
            except Exception:  # telemetry must never break delivery
                log.debug("ws_queue_evict event failed", exc_info=True)
        self._queue.append(message)
        if len(self._queue) > self.queue_hwm:
            self.queue_hwm = len(self._queue)
        self._queue_event.set()
        return True

    async def _next_queued(self):
        while not self._queue:
            self._queue_event.clear()
            await self._queue_event.wait()
        return self._queue.popleft()

    async def _send_now(self, message) -> bool:
        """The actual wire write (writer task only)."""
        try:
            from ..resilience.faultinject import get_injector

            injector = get_injector()
            if injector is not None:
                # chaos hook: a hung/errored subscriber — the hub must
                # reap it and keep broadcasting to everyone else
                await injector.fire("ws.send", self.ip)
            payload = message if isinstance(message, str) \
                else _encode(message)
            await self.ws.send_str(payload)
            self.messages_out += 1
            self.bytes_out += len(payload)
            return True
        except (ConnectionError, RuntimeError):
            return False

    async def send_error(self, code: str, text: str) -> None:
        await self.send({"type": "error", "error_code": code, "message": text})

    async def send_success(self, text: str, data: Optional[dict] = None) -> None:
        await self.send({"type": "success", "message": text, "data": data or {}})


class WsHub:
    """Connection registry + channel broadcast + lifecycle loops."""

    def __init__(self, cfg: Optional[WsConfig] = None):
        self.cfg = cfg or WsConfig()
        self.connections: Dict[str, WsConnection] = {}
        self.by_ip: Dict[str, Set[str]] = {}
        self.channels: Dict[str, Set[str]] = {c: set() for c in self.cfg.channels}
        self._loops_started = False
        self._loop_tasks: Set[asyncio.Task] = set()
        self._writers: Dict[str, asyncio.Task] = {}
        # cumulative lifecycle counters: get_stats() sums over LIVE
        # connections only, so subscriber churn needs these
        self.connects_total = 0
        self.disconnects_total = 0
        self.dropped_total = 0  # includes shed counts of reaped conns
        self.queue_hwm_total = 0  # deepest any queue got, ever (incl. reaped)

    # ------------------------------------------------------------ endpoint --
    async def handle(self, request: Request) -> WebSocketResponse:
        """The /ws route (reference socket_endpoint.py:26-52)."""
        ip = request.headers.get("x-real-ip") or request.peer_ip
        if len(self.connections) >= self.cfg.max_connections:
            raise HTTPServiceUnavailable(text_response(
                "Too many connections", 503))
        if len(self.by_ip.get(ip, ())) >= self.cfg.max_per_user:
            raise HTTPForbidden(text_response(
                "Too many connections from this IP", 403))

        ws = WebSocketResponse(
            heartbeat=self.cfg.heartbeat_interval,
            max_msg_size=self.cfg.max_message_bytes)
        await ws.prepare(request)
        conn = WsConnection(ws, ip, self.cfg)
        self._register(conn)
        log.info("ws connect %s from %s (%d total)", conn.id, ip,
                 len(self.connections))
        await conn.send({"type": "connection_established",
                         "connection_id": conn.id,
                         "channels": list(self.cfg.channels)})
        try:
            async for msg in ws:
                conn.last_activity = time.monotonic()
                if msg.type == WSMsgType.TEXT:
                    conn.messages_in += 1
                    conn.bytes_in += len(msg.data)
                    await self._on_message(conn, msg.data)
                elif msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            self._drop(conn)
        return ws

    async def _on_message(self, conn: WsConnection, raw: str) -> None:
        if not conn.rate_ok():
            await conn.send_error("RATE_LIMIT_EXCEEDED", "Too many messages sent")
            return
        try:
            message = json.loads(raw)
        except json.JSONDecodeError:
            await conn.send_error("INVALID_JSON", "Message must be valid JSON")
            return
        mtype = message.get("type")
        if not mtype:
            await conn.send_error("INVALID_MESSAGE", "Message type is required")
            return
        if mtype == "ping":
            await conn.send({"type": "pong"})
            return
        if mtype == "pong":
            return
        if mtype in _SUBSCRIBE:
            channel, subscribe = _SUBSCRIBE[mtype]
            if channel not in self.channels:
                await conn.send_error("INVALID_CHANNEL",
                                      f"Unknown channel '{channel}'")
                return
            if subscribe:
                conn.channels.add(channel)
                self.channels[channel].add(conn.id)
                await conn.send_success(f"Subscribed to {channel}",
                                        {"channel": channel})
            else:
                if channel not in conn.channels:
                    await conn.send_error(
                        "NOT_SUBSCRIBED", f"Not subscribed to channel '{channel}'")
                    return
                conn.channels.discard(channel)
                self.channels[channel].discard(conn.id)
                await conn.send_success(f"Unsubscribed from {channel}",
                                        {"channel": channel})
            return
        await conn.send_error("INVALID_MESSAGE_TYPE",
                              f"Message type '{mtype}' not allowed")

    def _register(self, conn: WsConnection) -> None:
        self.connections[conn.id] = conn
        self.by_ip.setdefault(conn.ip, set()).add(conn.id)
        self.connects_total += 1
        self._ensure_loops()
        writer = asyncio.ensure_future(self._writer(conn))
        writer.add_done_callback(lambda t: _retrieve(t, "writer"))
        self._writers[conn.id] = writer

    async def _writer(self, conn: WsConnection) -> None:
        """Drain one connection's send queue onto the wire.  A failed
        write means a dead subscriber: reap it here, exactly like the
        old inline broadcast reap, without ever stalling the hub."""
        while True:
            message = await conn._next_queued()
            if not await conn._send_now(message):
                self._writers.pop(conn.id, None)  # self-reap: don't
                self._drop(conn)                  # cancel ourselves
                return

    def connect_local(self, sink, ip: str = "local",
                      channels: tuple = ()) -> WsConnection:
        """Attach an in-process subscriber: ``sink`` needs only
        ``async send_str(payload)``.
        Returns the registered connection; detach with ``drop()``."""
        conn = WsConnection(sink, ip, self.cfg)
        self._register(conn)
        for channel in channels:
            if channel in self.channels:
                conn.channels.add(channel)
                self.channels[channel].add(conn.id)
        return conn

    def drop(self, conn: WsConnection) -> None:
        """Public detach for connect_local subscribers."""
        self._drop(conn)

    def _drop(self, conn: WsConnection) -> None:
        if self.connections.pop(conn.id, None) is not None:
            # count once even when the reap path and the handler's
            # finally both drop the same connection
            self.disconnects_total += 1
            self.dropped_total += conn.dropped
            self.queue_hwm_total = max(self.queue_hwm_total, conn.queue_hwm)
        conn._closed = True
        writer = self._writers.pop(conn.id, None)
        if writer is not None:
            writer.cancel()
        self.by_ip.get(conn.ip, set()).discard(conn.id)
        if not self.by_ip.get(conn.ip):
            self.by_ip.pop(conn.ip, None)
        for members in self.channels.values():
            members.discard(conn.id)

    # ----------------------------------------------------------- broadcast --
    async def broadcast_to_channel(self, channel: str, message: dict) -> int:
        """Enqueue to every subscriber (reference
        socket_manager.py:201-231).  Returns the number of subscribers
        the message was queued for; wire delivery and dead-subscriber
        reaping happen in the per-connection writers, so a stalled
        client costs the broadcast nothing.  The payload is encoded
        ONCE here; every subscriber queue holds the same shared
        string."""
        sent = 0
        payload = _encode(message)
        for conn_id in list(self.channels.get(channel, ())):
            conn = self.connections.get(conn_id)
            if conn is None:
                self.channels[channel].discard(conn_id)
                continue
            if await conn.send(payload):
                sent += 1
            else:
                self._drop(conn)
        return sent

    async def broadcast_new_block(self, block_data: dict) -> int:
        return await self.broadcast_to_channel("block", {
            "type": "new_block", "data": block_data,
            "timestamp": datetime.now(timezone.utc).isoformat(),
        })

    async def broadcast_new_transaction(self, tx_data: dict) -> int:
        return await self.broadcast_to_channel("transaction", {
            "type": "new_transaction", "data": tx_data,
            "timestamp": datetime.now(timezone.utc).isoformat(),
        })

    # ----------------------------------------------------------- lifecycle --
    def _ensure_loops(self) -> None:
        if self._loops_started:
            return
        self._loops_started = True
        for name, coro in (("cleanup", self._cleanup_loop()),
                           ("stats", self._stats_loop())):
            task = asyncio.ensure_future(coro)
            task.add_done_callback(
                lambda t, n=name: _retrieve(t, n))
            self._loop_tasks.add(task)

    def close(self) -> None:
        """Drop every connection and cancel lifecycle/writer tasks (a
        live server keeps the hub for its lifetime)."""
        for conn in list(self.connections.values()):
            self._drop(conn)
        for task in self._loop_tasks:
            task.cancel()
        self._loop_tasks.clear()
        self._loops_started = False

    async def _cleanup_loop(self) -> None:
        """Expire idle connections (reference socket_manager.py:333-352)."""
        while True:
            await asyncio.sleep(self.cfg.cleanup_interval)
            now = time.monotonic()
            for conn in list(self.connections.values()):
                if now - conn.last_activity > self.cfg.connection_expiry:
                    log.info("ws expire %s", conn.id)
                    try:
                        await conn.ws.close()
                    except Exception as e:
                        # peer may already be gone; still worth a trace
                        log.debug("ws close %s failed: %s", conn.id, e)
                    self._drop(conn)

    async def _stats_loop(self) -> None:
        while True:
            await asyncio.sleep(300)
            log.info("ws stats: %s", self.get_stats())

    def get_stats(self) -> dict:
        return {
            "total_connections": len(self.connections),
            "unique_ips": len(self.by_ip),
            "channels": {c: len(m) for c, m in self.channels.items()},
            "messages_out": sum(c.messages_out for c in self.connections.values()),
            "messages_in": sum(c.messages_in for c in self.connections.values()),
            "connects_total": self.connects_total,
            "disconnects_total": self.disconnects_total,
            "dropped_messages": self.dropped_total + sum(
                c.dropped for c in self.connections.values()),
            "send_queue_hwm": max(
                [self.queue_hwm_total]
                + [c.queue_hwm for c in self.connections.values()]),
        }
