"""A small HTTP/1.1 server and client on the standard library alone.

The JAX package's node serves through ``aiohttp.web``; the port needs no
package beyond PyTorch, so it serves through ``asyncio.start_server``:
keep-alive connections, ``Content-Length`` and chunked bodies, GET query
strings and a route table of ``(method, path) -> handler``.  A handler
takes a :class:`Request` and returns a :class:`Response`;
:func:`json_response` serialises exactly as ``aiohttp.web.json_response``
does (``json.dumps`` with its default separators, UTF-8,
``application/json; charset=utf-8``), so a body is byte for byte what the
JAX node sends.  As aiohttp does, a body at or over the cap raises
:class:`BodyTooLarge` only when the handler reads it (the node answers
aiohttp's 413 text), a HEAD response keeps the Content-Length of the body
it leaves out, and an HTTP/1.0 request is answered in HTTP/1.0.

:func:`fetch` is the matching client, one request per connection: the
node's peer RPC (``peers.py``), the tests and chip_smoke.py.

The server side of RFC 6455 (:class:`WebSocketResponse`) behaves as
aiohttp's ``web.WebSocketResponse`` does where the JAX node's ``/ws``
uses it: ``await ws.prepare(request)`` checks the upgrade headers in
aiohttp's order and with its 400 texts, answers 101 with
``Sec-WebSocket-Accept`` and takes the connection out of the keep-alive
loop; ``receive()`` reassembles continuation frames, answers a ping with
a pong and a close with a close (code 1000), closes with 1009 a message
at or over ``max_msg_size``, 1002 a protocol error and 1007 text that is
not UTF-8, and accepts an unmasked client frame, as aiohttp 3.13 does;
``heartbeat`` pings that many seconds after the last frame received and
drops the connection (code 1006, no close frame) when nothing comes back
within half of it.  No extension is negotiated (aiohttp offers
permessage-deflate to a client that asks; the frames are the same
without it).  :func:`ws_connect` is the matching client, masking its
frames.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import enum
import hashlib
import json
import logging
import math
import os
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, NamedTuple, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

log = logging.getLogger("upow_tpu_torch.node.http")

_MAX_HEAD = 64 * 1024          # request line + headers
_KEEPALIVE_SECONDS = 75.0      # idle keep-alive connections close after this
_CHUNK = 64 * 1024             # read size while draining a body


class _Refused(Exception):
    """A request body the server cannot frame: 400, or 501 for a
    transfer coding other than chunked."""

    def __init__(self, status: int = 400):
        super().__init__(status)
        self.status = status


class HTTPException(Exception):
    """A response raised past a handler's envelope, as aiohttp raises
    its ``web.HTTPException``s; a subclass bears the name of aiohttp's,
    which a trace root records as its error."""

    def __init__(self, response: "Response"):
        super().__init__(response.status)
        self.response = response


class HTTPBadRequest(HTTPException):
    pass


class HTTPForbidden(HTTPException):
    pass


class HTTPServiceUnavailable(HTTPException):
    pass


class BodyTooLarge(Exception):
    """A body at or over the cap, raised on reading it, with aiohttp's
    ``HTTPRequestEntityTooLarge`` text."""

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(f"Maximum request body size {max_size} exceeded, "
                         f"actual body size {actual_size}")


class Request:
    """One parsed request: ``path`` is percent-decoded, ``query`` keeps
    the first value of each key (as aiohttp's ``query.get`` does).
    ``body_size`` is the body's length; the bytes are kept only below
    ``max_body`` (0: no cap)."""

    def __init__(self, method: str, target: str, headers: Dict[str, str],
                 body: bytes, body_size: int, max_body: int, peer_ip: str):
        self.method = method
        path, _, self.query_string = target.partition("?")
        self.path = unquote(path) or "/"
        self.query: Dict[str, str] = {}
        for key, value in parse_qsl(self.query_string,
                                    keep_blank_values=True):
            self.query.setdefault(key, value)
        self.headers = headers     # lower-case names
        self._body = body
        self.body_size = body_size
        self.max_body = max_body
        self.peer_ip = peer_ip
        # a path parameter's value by name (aiohttp's ``match_info``),
        # filled by the router
        self.match_info: Dict[str, str] = {}
        # the connection's streams, and the WebSocket that took it over
        self.stream: Optional[Tuple[asyncio.StreamReader,
                                    asyncio.StreamWriter]] = None
        self.upgraded: Optional["WebSocketResponse"] = None

    # the server speaks plain HTTP; a proxy in front may terminate TLS
    scheme = "http"

    @property
    def host(self) -> str:
        """The ``Host`` header (aiohttp's ``request.host``)."""
        return self.headers.get("host", "")

    def read(self) -> bytes:
        """The body; raises :class:`BodyTooLarge` at or over the cap (as
        aiohttp's ``read`` does, ``>=``)."""
        if self.max_body and self.body_size >= self.max_body:
            raise BodyTooLarge(self.max_body, self.body_size)
        return self._body

    def json(self):
        """The body parsed as JSON (raises ValueError when it is not)."""
        return json.loads(self.read().decode("utf-8"))


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(data, status: int = 200, dumps=json.dumps) -> Response:
    return Response(dumps(data).encode("utf-8"), status)


def text_response(text: str, status: int) -> Response:
    return Response(text.encode("utf-8"), status,
                    content_type="text/plain; charset=utf-8")


Handler = Callable[[Request], Awaitable[Response]]


class HttpServer:
    """Serve ``handler`` (which does its own routing) on host:port.

    ``max_body`` caps a request body; ``port=0`` takes a free port,
    readable from :attr:`port` after :meth:`start`."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0, max_body: int = 20 * 1024 * 1024):
        self.handler = handler
        self.host = host
        self.port = port
        self.max_body = max_body
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._connection, self.host, self.port, limit=_MAX_HEAD,
            backlog=1024)
        self.port = self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for writer in list(self._writers):
            writer.close()
        try:
            await asyncio.wait_for(self._server.wait_closed(), 5.0)
        except asyncio.TimeoutError:
            log.warning("HTTP server connections still open at close")
        self._server = None

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        peer = writer.get_extra_info("peername")
        peer_ip = peer[0] if peer else ""
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), _KEEPALIVE_SECONDS)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionError):
                    return
                except asyncio.LimitOverrunError:
                    await _write(writer, text_response(
                        "431: Request Header Fields Too Large", 431), False)
                    return
                parsed = _parse_head(head)
                if parsed is None:
                    await _write(writer, text_response(
                        "400: Bad Request", 400), False)
                    return
                method, target, version, headers = parsed
                keep = _keep_alive(version, headers)
                try:
                    body, size = await self._body(reader, headers)
                except _Refused as e:
                    phrase = HTTPStatus(e.status).phrase
                    await _write(writer, text_response(
                        f"{e.status}: {phrase}", e.status), False, version,
                        method)
                    return
                request = Request(method, target, headers, body, size,
                                  self.max_body, peer_ip)
                request.stream = (reader, writer)
                try:
                    response = await self.handler(request)
                except HTTPException as e:
                    response = e.response
                except Exception:  # the handler's own envelope failed
                    log.exception("unhandled error on %s %s", method, target)
                    response = text_response("500: Internal Server Error",
                                             500)
                if request.upgraded is not None:
                    return  # the WebSocket ran on this connection
                await _write(writer, response, keep, version, method)
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _body(self, reader: asyncio.StreamReader,
                    headers: Dict[str, str]) -> Tuple[bytes, int]:
        """Read the request's body off the connection: (the bytes, kept
        only while under ``max_body``, and the body's full length).  A
        body at or over the cap is read through and dropped, so that the
        connection stays in step for the response."""
        coding = headers.get("transfer-encoding")
        if coding is not None:
            if coding.lower() != "chunked":
                raise _Refused(501)
            try:
                return await self._chunked(reader)
            except (ValueError, asyncio.LimitOverrunError):
                raise _Refused() from None
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _Refused() from None
        if length < 0:
            raise _Refused()
        if not self.max_body or length < self.max_body:
            return (await reader.readexactly(length) if length else b""), length
        left = length
        while left:
            left -= len(await reader.readexactly(min(left, _CHUNK)))
        return b"", length

    async def _chunked(self, reader: asyncio.StreamReader
                       ) -> Tuple[bytes, int]:
        """Decode a chunked body (RFC 9112 7.1; extensions and trailers
        read and dropped); raises ValueError on a malformed one."""
        parts, size = [], 0
        while True:
            line = await reader.readuntil(b"\r\n")
            n = int(line.split(b";", 1)[0].strip(), 16)
            if n < 0:
                raise ValueError("chunk size")
            if n == 0:
                break
            left = n
            while left:
                data = await reader.readexactly(min(left, _CHUNK))
                left -= len(data)
                if not self.max_body or size + n < self.max_body:
                    parts.append(data)
            size += n
            if await reader.readexactly(2) != b"\r\n":
                raise ValueError("chunk end")
        while await reader.readuntil(b"\r\n") != b"\r\n":
            pass                                # trailer fields
        body = b"" if self.max_body and size >= self.max_body \
            else b"".join(parts)
        return body, size


def _parse_head(head: bytes):
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, target, version = lines[0].split(" ")
    except ValueError:
        return None
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            return None
        headers[name.strip().lower()] = value.strip()
    return method, target, version, headers


def _keep_alive(version: str, headers: Dict[str, str]) -> bool:
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


async def _write(writer: asyncio.StreamWriter, response: Response,
                 keep: bool, version: str = "HTTP/1.1",
                 method: str = "GET") -> None:
    """The status line in the request's version (HTTP/1.0 or 1.1); a
    HEAD response carries the headers of the body it leaves out."""
    reason = HTTPStatus(response.status).phrase
    version = "HTTP/1.0" if version == "HTTP/1.0" else "HTTP/1.1"
    lines = [f"{version} {response.status} {reason}",
             f"Content-Type: {response.content_type}",
             f"Content-Length: {len(response.body)}",
             "Connection: " + ("keep-alive" if keep else "close")]
    lines += [f"{k}: {v}" for k, v in response.headers.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                 + (b"" if method == "HEAD" else response.body))
    await writer.drain()


async def fetch(url: str, method: str = "GET", body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                max_bytes: Optional[int] = None,
                response_headers: Optional[Dict[str, str]] = None
                ) -> Tuple[int, bytes]:
    """One request to ``url`` (``http://host:port/path?query``) on its
    own connection (TLS for ``https``); returns (status, body).  A dict
    or list ``body`` is not accepted: pass bytes
    (``json.dumps(...).encode()``).  A ``Host`` in ``headers`` replaces
    the URL's.  A response body longer than ``max_bytes`` raises
    ``ValueError``.  ``response_headers``, when given, receives the
    response's headers, their names lower-cased."""
    split = urlsplit(url)
    target = (split.path or "/") + (f"?{split.query}" if split.query else "")
    tls = split.scheme == "https"
    reader, writer = await asyncio.open_connection(
        split.hostname, split.port or (443 if tls else 80), ssl=tls or None)
    try:
        headers = dict(headers or {})
        host = next((headers.pop(k) for k in list(headers)
                     if k.lower() == "host"), split.netloc)
        lines = [f"{method} {target} HTTP/1.1", f"Host: {host}",
                 "Connection: close"]
        if body is not None:
            lines += ["Content-Type: application/json",
                      f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                     + (body or b""))
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        status_line, *header_lines = head.decode("latin-1").split("\r\n")
        status = int(status_line.split(" ")[1])
        length = None
        for line in header_lines:
            name, _, value = line.partition(":")
            if response_headers is not None:
                response_headers[name.strip().lower()] = value.strip()
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        if length is not None:
            if max_bytes is not None and length > max_bytes:
                raise ValueError("response too large")
            data = await reader.readexactly(length)
        else:  # to the end of the connection
            buf = bytearray()
            while chunk := await reader.read(1 << 16):
                buf += chunk
                if max_bytes is not None and len(buf) > max_bytes:
                    raise ValueError("response too large")
            data = bytes(buf)
        return status, data
    finally:
        writer.close()


# ------------------------------------------------------------ WebSocket ---

WS_KEY = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"   # RFC 6455 1.3
_TIMEOUT_CEIL_THRESHOLD = 5.0   # aiohttp's: longer timers end on a second
_CLOSE_TIMEOUT = 10.0           # wait for the peer's close frame


class WSMsgType(enum.IntEnum):
    """aiohttp's message types: the frame opcodes, then its own."""

    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    UNSUPPORTED_DATA = 1003
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    POLICY_VIOLATION = 1008
    MESSAGE_TOO_BIG = 1009
    MANDATORY_EXTENSION = 1010
    INTERNAL_ERROR = 1011
    SERVICE_RESTART = 1012
    TRY_AGAIN_LATER = 1013
    BAD_GATEWAY = 1014


_ALLOWED_CLOSE_CODES = {int(c) for c in WSCloseCode}


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Optional[str]


_CLOSED = WSMessage(WSMsgType.CLOSED, None, None)
_CLOSING = WSMessage(WSMsgType.CLOSING, None, None)


class WebSocketError(Exception):
    """A frame the protocol refuses: the connection closes with
    ``code``."""

    def __init__(self, code: int, message: str):
        super().__init__(code, message)
        self.code = code

    def __str__(self) -> str:
        return self.args[1]


class WsHandshakeError(Exception):
    """The server did not switch protocols: its status and body."""

    def __init__(self, status: int, body: bytes):
        super().__init__(f"{status}: {body[:200]!r}")
        self.status = status
        self.body = body


def _ws_accept(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1(key.encode() + WS_KEY).digest()).decode()


def _masked(mask: bytes, data: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    pad = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(pad, "big")).to_bytes(n, "big")


def _frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    """One final frame: unmasked from the server, masked from a client."""
    n = len(payload)
    bit = 0x80 if mask else 0
    if n < 126:
        head = bytes((0x80 | opcode, n | bit))
    elif n < 65536:
        head = bytes((0x80 | opcode, 126 | bit)) + n.to_bytes(2, "big")
    else:
        head = bytes((0x80 | opcode, 127 | bit)) + n.to_bytes(8, "big")
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + _masked(key, payload)


class _WsEndpoint:
    """One end of a WebSocket connection: frame reading with aiohttp's
    checks, message reassembly and frame writing."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, max_msg_size: int,
                 mask: bool):
        self._reader = reader
        self._writer = writer
        self._max = max_msg_size
        self._mask = mask
        self._partial = bytearray()
        self._opcode: Optional[int] = None
        self._closed = False      # a close frame sent, or the socket gone
        self._closing = False     # the peer's close frame received
        self._waiting = False     # a receive() is reading the socket
        self._exception: Optional[BaseException] = None
        self.close_code: Optional[int] = None

    def _write_frame(self, opcode: int, payload: bytes) -> None:
        if self._writer.is_closing() or (
                self._closed and opcode != WSMsgType.CLOSE):
            raise ConnectionResetError("Cannot write to closing transport")
        self._writer.write(_frame(opcode, payload, self._mask))

    async def _send(self, opcode: int, payload: bytes) -> None:
        self._write_frame(opcode, payload)
        await self._writer.drain()

    async def send_str(self, data: str) -> None:
        await self._send(WSMsgType.TEXT, data.encode("utf-8"))

    async def send_json(self, data, dumps=json.dumps) -> None:
        await self.send_str(dumps(data))

    async def ping(self, message: bytes = b"") -> None:
        await self._send(WSMsgType.PING, message)

    async def pong(self, message: bytes = b"") -> None:
        await self._send(WSMsgType.PONG, message)

    async def receive_str(self) -> str:
        msg = await self.receive()
        if msg.type != WSMsgType.TEXT:
            raise TypeError(f"Received message {msg.type}:{msg.data!r} is "
                            "not WSMsgType.TEXT")
        return msg.data

    async def receive_json(self, loads=json.loads):
        return loads(await self.receive_str())

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                        WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg

    def _close_transport(self) -> None:
        self._writer.close()

    async def _payload(self, length: int, keep: bool) -> bytes:
        """``length`` bytes off the socket; dropped when ``keep`` is
        false (a message over the cap is read through, as aiohttp reads
        it, before the 1009)."""
        if keep:
            return await self._reader.readexactly(length)
        while length:
            length -= len(await self._reader.readexactly(min(length, _CHUNK)))
        return b""

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        """(fin, opcode, unmasked payload) of the next frame."""
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if b0 & 0x70:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 "Received frame with non-zero reserved bits")
        if opcode > 0x7 and not fin:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 "Received fragmented control frame")
        length = b1 & 0x7F
        if opcode > 0x7 and length > 125:
            raise WebSocketError(
                WSCloseCode.PROTOCOL_ERROR,
                "Control frame payload cannot be larger than 125 bytes")
        if length == 126:
            length = int.from_bytes(await self._reader.readexactly(2), "big")
        elif length == 127:
            length = int.from_bytes(await self._reader.readexactly(8), "big")
        key = await self._reader.readexactly(4) if b1 & 0x80 else None
        total = len(self._partial) + length
        keep = not (opcode <= 0x2 and self._max and total >= self._max)
        payload = await self._payload(length, keep)
        if not keep:
            raise WebSocketError(
                WSCloseCode.MESSAGE_TOO_BIG,
                f"Message size {total} exceeds limit {self._max}")
        return fin, opcode, _masked(key, payload) if key else payload

    async def _next_message(self) -> WSMessage:
        """The next whole message, control frames included (aiohttp's
        ``WebSocketReader`` rules)."""
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode in (WSMsgType.TEXT, WSMsgType.BINARY,
                          WSMsgType.CONTINUATION):
                if opcode == WSMsgType.CONTINUATION and self._opcode is None:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        "Continuation frame for non started message")
                if not fin:
                    if opcode != WSMsgType.CONTINUATION:
                        self._opcode = opcode
                    self._partial += payload
                    continue
                if opcode == WSMsgType.CONTINUATION:
                    opcode, self._opcode = self._opcode, None
                elif self._partial:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        "The opcode in non-fin frame is expected to be "
                        f"zero, got {opcode!r}")
                data = bytes(self._partial) + payload
                self._partial.clear()
                if opcode == WSMsgType.BINARY:
                    return WSMessage(WSMsgType.BINARY, data, "")
                try:
                    return WSMessage(WSMsgType.TEXT, data.decode("utf-8"), "")
                except UnicodeDecodeError:
                    raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                         "Invalid UTF-8 text message") \
                        from None
            if opcode == WSMsgType.CLOSE:
                if len(payload) >= 2:
                    code = int.from_bytes(payload[:2], "big")
                    if code < 3000 and code not in _ALLOWED_CLOSE_CODES:
                        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                             f"Invalid close code: {code}")
                    try:
                        reason = payload[2:].decode("utf-8")
                    except UnicodeDecodeError:
                        raise WebSocketError(
                            WSCloseCode.INVALID_TEXT,
                            "Invalid UTF-8 text message") from None
                    return WSMessage(WSMsgType.CLOSE, code, reason)
                if payload:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        f"Invalid close frame: {fin} {opcode} {payload!r}")
                return WSMessage(WSMsgType.CLOSE, 0, "")
            if opcode in (WSMsgType.PING, WSMsgType.PONG):
                return WSMessage(WSMsgType(opcode), payload, "")
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 f"Unexpected opcode={opcode!r}")

    async def _await_close_frame(self) -> None:
        """After our close frame: the peer's, within the close timeout,
        then the socket is closed."""
        try:
            async with asyncio.timeout(_CLOSE_TIMEOUT):
                while True:
                    msg = await self._next_message()
                    if msg.type == WSMsgType.CLOSE:
                        self.close_code = msg.data
                        return
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, WebSocketError) as e:
            self._exception = e
            self.close_code = WSCloseCode.ABNORMAL_CLOSURE
        finally:
            self._close_transport()


class WebSocketResponse(Response, _WsEndpoint):
    """The server side of one connection (aiohttp's
    ``web.WebSocketResponse`` as the JAX node's hub uses it)."""

    def __init__(self, *, heartbeat: Optional[float] = None,
                 max_msg_size: int = 4 * 1024 * 1024):
        Response.__init__(self, b"", 101)
        _WsEndpoint.__init__(self, None, None, max_msg_size, mask=False)
        self._heartbeat = heartbeat
        self._max_msg_size = max_msg_size
        self._heartbeat_cb: Optional[asyncio.TimerHandle] = None
        self._heartbeat_when = 0.0
        self._pong_cb: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._reader_failed = False

    @staticmethod
    def _handshake(request: Request) -> str:
        """The client's key; raises aiohttp's 400 for a missing or bad
        upgrade header, version or key, in aiohttp's order."""
        h = request.headers
        upgrade = h.get("upgrade")
        if (upgrade or "").lower().strip() != "websocket":
            raise HTTPBadRequest(text_response(
                f"No WebSocket UPGRADE hdr: {upgrade}\n Can \"Upgrade\" "
                "only to \"WebSocket\".", 400))
        if "upgrade" not in h.get("connection", "").lower():
            raise HTTPBadRequest(text_response(
                f"No CONNECTION upgrade hdr: {h.get('connection')}", 400))
        version = h.get("sec-websocket-version", "")
        if version not in ("13", "8", "7"):
            raise HTTPBadRequest(text_response(
                f"Unsupported version: {version}", 400))
        key = h.get("sec-websocket-key")
        try:
            if not key or len(base64.b64decode(key)) != 16:
                raise ValueError
        except (ValueError, binascii.Error):
            raise HTTPBadRequest(text_response(
                f"Handshake error: {key!r}", 400)) from None
        return key

    async def prepare(self, request: Request) -> None:
        """Switch the request's connection to the protocol; raises
        :class:`HTTPBadRequest` as aiohttp's ``prepare`` does."""
        key = self._handshake(request)
        reader, writer = request.stream
        _WsEndpoint.__init__(self, reader, writer, self._max_msg_size,
                             mask=False)
        writer.write(("HTTP/1.1 101 Switching Protocols\r\n"
                      "Upgrade: websocket\r\nConnection: upgrade\r\n"
                      f"Sec-WebSocket-Accept: {_ws_accept(key)}\r\n\r\n"
                      ).encode("latin-1"))
        request.upgraded = self
        self._loop = asyncio.get_running_loop()
        self._reset_heartbeat()
        await writer.drain()

    # ------------------------------------------------------- heartbeat --
    def _when(self, timeout: float) -> float:
        when = self._loop.time() + timeout
        return math.ceil(when) if timeout > _TIMEOUT_CEIL_THRESHOLD else when

    def _cancel_heartbeat(self) -> None:
        for name in ("_pong_cb", "_heartbeat_cb"):
            handle = getattr(self, name)
            if handle is not None:
                handle.cancel()
                setattr(self, name, None)

    def _reset_heartbeat(self) -> None:
        """After each frame received: the next ping ``heartbeat``
        seconds on, and no pong deadline."""
        if self._heartbeat is None:
            return
        if self._pong_cb is not None:
            self._pong_cb.cancel()
            self._pong_cb = None
        self._heartbeat_when = self._when(self._heartbeat)
        if self._heartbeat_cb is None:
            self._heartbeat_cb = self._loop.call_at(self._heartbeat_when,
                                                    self._send_heartbeat)

    def _send_heartbeat(self) -> None:
        self._heartbeat_cb = None
        if self._loop.time() < self._heartbeat_when:  # a frame came since
            self._heartbeat_cb = self._loop.call_at(self._heartbeat_when,
                                                    self._send_heartbeat)
            return
        self._pong_cb = self._loop.call_at(self._when(self._heartbeat / 2.0),
                                           self._pong_not_received)
        try:
            self._write_frame(WSMsgType.PING, b"")
        except (ConnectionError, RuntimeError) as e:
            self._abort(e)

    def _pong_not_received(self) -> None:
        self._pong_cb = None
        self._abort(asyncio.TimeoutError(
            f"No PONG received after {self._heartbeat / 2.0} seconds"))

    def _abort(self, exc: BaseException) -> None:
        """Drop the socket without a close frame (code 1006)."""
        if self._closed:
            return
        self._closed = True
        self._cancel_heartbeat()
        self._exception = exc
        self.close_code = WSCloseCode.ABNORMAL_CLOSURE
        self._close_transport()

    # ---------------------------------------------------------- receive --
    async def receive(self) -> WSMessage:
        """The next text or binary message, or CLOSE, CLOSING, CLOSED or
        ERROR; pings are answered and pongs swallowed."""
        while True:
            if self._closed:
                if self._closing:
                    return _CLOSING
                if self._exception is not None and not self._reader_failed:
                    self._reader_failed = True
                    return WSMessage(WSMsgType.ERROR, self._exception, None)
                return _CLOSED
            if self._closing:
                return _CLOSING
            self._waiting = True
            try:
                msg = await self._next_message()
                self._reset_heartbeat()
            except (asyncio.IncompleteReadError, ConnectionError):
                if self._closed:  # our own close or the heartbeat's
                    continue
                self._reader_failed = True
                self.close_code = WSCloseCode.OK
                await self.close()
                return _CLOSED
            except WebSocketError as e:
                self._reader_failed = True
                self.close_code = e.code
                self._exception = e
                await self.close(code=e.code)
                return WSMessage(WSMsgType.ERROR, e, None)
            finally:
                self._waiting = False
            if msg.type == WSMsgType.CLOSE:
                self._closing = True
                self.close_code = msg.data
                self._cancel_heartbeat()
                if not self._closed:
                    await self.close()
                return msg
            if msg.type == WSMsgType.PING:
                try:
                    await self.pong(msg.data)
                except ConnectionError:
                    pass
                continue
            if msg.type == WSMsgType.PONG:
                continue
            return msg

    async def close(self, *, code: int = WSCloseCode.OK,
                    message: bytes = b"") -> bool:
        """Send a close frame; False when the connection was closed
        already.  The socket closes at once after an error, after the
        peer's own close frame, or while a receive is reading it; else
        after the peer's close frame or the close timeout."""
        if self._closed:
            return False
        self._closed = True
        self._cancel_heartbeat()
        try:
            await self._send(WSMsgType.CLOSE, code.to_bytes(2, "big")
                             + (message.encode() if isinstance(message, str)
                                else message))
        except (ConnectionError, RuntimeError) as e:
            self._exception = e
            self.close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            return True
        if self._waiting:
            self._closing = True
        if self._closing or self._reader_failed:
            self._close_transport()
            return True
        await self._await_close_frame()
        return True


class ClientWebSocket(_WsEndpoint):
    """The client side of one connection (:func:`ws_connect`): frames
    masked, pings answered, pongs swallowed."""

    async def receive(self, timeout: Optional[float] = None) -> WSMessage:
        if self._closed:
            return _CLOSED
        self._waiting = True
        try:
            async with asyncio.timeout(timeout):
                while True:
                    msg = await self._next_message()
                    if msg.type == WSMsgType.PING:
                        await self.pong(msg.data)
                        continue
                    if msg.type != WSMsgType.PONG:
                        break
        except (asyncio.IncompleteReadError, ConnectionError):
            self._closed = True
            self._close_transport()
            return _CLOSED
        except WebSocketError as e:
            self._exception = e
            self._waiting = False
            await self.close(code=e.code)
            return WSMessage(WSMsgType.ERROR, e, None)
        finally:
            self._waiting = False
        if msg.type == WSMsgType.CLOSE:
            self._closing = True
            self.close_code = msg.data
            if not self._closed:
                await self.close()
        return msg

    async def close(self, *, code: int = WSCloseCode.OK,
                    message: bytes = b"") -> bool:
        if self._closed:
            return False
        self._closed = True
        try:
            await self._send(WSMsgType.CLOSE, code.to_bytes(2, "big")
                             + message)
        except (ConnectionError, RuntimeError):
            self._close_transport()
            return True
        if self._closing or self._waiting or self._exception is not None:
            # a receive that is reading the socket ends on its close
            self._close_transport()
        else:
            await self._await_close_frame()
        return True


async def ws_connect(url: str, headers: Optional[Dict[str, str]] = None,
                     max_msg_size: int = 4 * 1024 * 1024) -> ClientWebSocket:
    """Open a WebSocket to ``url`` (``ws://`` or ``http://host:port/path``)
    and return its client end; raises :class:`WsHandshakeError` with the
    status and body when the server does not answer 101 with the key's
    ``Sec-WebSocket-Accept``."""
    split = urlsplit(url)
    target = (split.path or "/") + (f"?{split.query}" if split.query else "")
    reader, writer = await asyncio.open_connection(split.hostname,
                                                   split.port or 80)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        lines = [f"GET {target} HTTP/1.1", f"Host: {split.netloc}",
                 "Upgrade: websocket", "Connection: Upgrade",
                 f"Sec-WebSocket-Key: {key}", "Sec-WebSocket-Version: 13"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        status_line, *header_lines = head.decode("latin-1").split("\r\n")
        status = int(status_line.split(" ")[1])
        got = {}
        for line in header_lines:
            name, _, value = line.partition(":")
            got[name.strip().lower()] = value.strip()
        if status != 101:
            length = int(got.get("content-length", "0") or 0)
            body = await reader.readexactly(length) if length else b""
            raise WsHandshakeError(status, body)
        if got.get("sec-websocket-accept") != _ws_accept(key):
            raise WsHandshakeError(status, b"Sec-WebSocket-Accept mismatch")
    except BaseException:
        writer.close()
        raise
    return ClientWebSocket(reader, writer, max_msg_size, mask=True)
