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
"""

from __future__ import annotations

import asyncio
import json
import logging
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, Optional, Tuple
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
                try:
                    response = await self.handler(Request(
                        method, target, headers, body, size, self.max_body,
                        peer_ip))
                except Exception:  # the handler's own envelope failed
                    log.exception("unhandled error on %s %s", method, target)
                    response = text_response("500: Internal Server Error",
                                             500)
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
