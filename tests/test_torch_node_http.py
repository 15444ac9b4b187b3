"""The port's HTTP layer against aiohttp's, on the same raw bytes.

The JAX node serves through ``aiohttp.web`` (an aiohttp ``TestServer``),
the port's on its standard-library server (``node/http.py``).  Each case
writes one request, byte for byte the same, to both nodes on a fresh
connection and reads the answer to the end; the status line, the content
type, the ``Allow`` header and the body must be equal (aiohttp's 413
body ends in the count of bytes it had read, so there the text is held
up to "actual body size").  The cases pin four places where aiohttp's
framing shows through to a client:

* HEAD on a GET route runs the GET handler and answers 200 with its
  content type and no body;
* a chunked request body is decoded, under the same cap as any body;
* a body at or over ``node.response_cap`` answers aiohttp's 413 text, and
  only when the handler reads it: the IP filter, the rate limit and the
  route come first, and a GET handler never reads it;
* a 405 names the route's methods in ``Allow``, and an HTTP/1.0 request
  is answered in HTTP/1.0.
"""

import asyncio
import json

import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu_torch.node.app as tapp
from test_torch_node import _configs

CAP = 1024
TX_BODY = b'{"tx_hex":1}'


def _head(method, path, extra="", version="HTTP/1.1", close=True):
    conn = "Connection: close\r\n" if close else ""
    return (f"{method} {path} {version}\r\nHost: node\r\n{conn}{extra}"
            "\r\n").encode("latin-1")


def _sized(method, path, body, **kw):
    return _head(method, path, f"Content-Length: {len(body)}\r\n",
                 **kw) + body


def _chunked(method, path, pieces, trailer=b""):
    body = b"".join(b"%x;ext=1\r\n%s\r\n" % (len(p), p) for p in pieces)
    return (_head(method, path, "Transfer-Encoding: chunked\r\n") + body
            + b"0\r\n" + trailer + b"\r\n")


def _big_tx(size):
    """A push_tx body of exactly ``size`` bytes."""
    return b'{"tx_hex":"' + b"a" * (size - 13) + b'"}'


async def _exchange(port, data):
    """(status line, lower-case headers, body) of one request."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(data)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 30)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status, *lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers, body


def _answers(tmp_path, requests, ip_config=None, rate_limits=False):
    """Send each raw request to both nodes; [(jax, port)] answers."""
    jcfg, tcfg = _configs(tmp_path, "jac")
    for cfg in (jcfg, tcfg):
        cfg.node.db_path = ""
        cfg.node.response_cap = CAP
        cfg.node.rate_limits_enabled = rate_limits
        if ip_config is not None:
            path = tmp_path / "ip_config.json"
            path.write_text(json.dumps(ip_config))
            cfg.node.ip_config_file = str(path)

    async def main():
        jnode = japp.Node(jcfg)
        jnode.started = True  # no first-request bootstrap
        tnode = tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        try:
            return [(await _exchange(server.port, r),
                     await _exchange(tserver.port, r)) for r in requests]
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    return asyncio.run(main())


def _same(jax, port, body_upto=None):
    (js, jh, jb), (ts, th, tb) = jax, port
    if body_upto is not None:
        jb, tb = (b[:b.index(body_upto) + len(body_upto)] for b in (jb, tb))
    assert (ts, th.get("content-type"), th.get("allow"), tb) == \
        (js, jh.get("content-type"), jh.get("allow"), jb)


@pytest.mark.parametrize("path", ["/", "/get_mining_info"])
def test_head_on_a_get_route_answers_like_get_without_a_body(tmp_path, path):
    head, get = _answers(tmp_path, [_head("HEAD", path), _head("GET", path)])
    _same(*head)
    status, headers, body = head[1]
    assert status == "HTTP/1.1 200 OK" and body == b""
    assert headers["content-type"] == "application/json; charset=utf-8"
    if path != "/":  # "/" reports each node's own timings
        _same(*get)
        assert headers["content-length"] == head[0][1]["content-length"] \
            == str(len(get[1][2]))


@pytest.mark.parametrize("pieces", [
    [TX_BODY[:5], TX_BODY[5:]],
    [TX_BODY[i:i + 1] for i in range(len(TX_BODY))],
], ids=["two_chunks", "byte_chunks"])
def test_chunked_body_is_decoded(tmp_path, pieces):
    [(jax, port)] = _answers(tmp_path, [_chunked(
        "POST", "/push_tx", pieces, trailer=b"X-Trailer: 1\r\n")])
    _same(jax, port)
    assert json.loads(port[2]) == {
        "ok": False,
        "error": "Invalid transaction: fromhex() argument must be str, "
                 "not int"}


@pytest.mark.parametrize("request_bytes", [
    _sized("POST", "/push_tx", _big_tx(2000)),
    _sized("POST", "/push_tx", _big_tx(CAP)),
    _chunked("POST", "/push_tx", [_big_tx(2000)[:700], _big_tx(2000)[700:]]),
], ids=["over_the_cap", "at_the_cap", "chunked_over_the_cap"])
def test_oversized_body_answers_aiohttp_413(tmp_path, request_bytes):
    [(jax, port)] = _answers(tmp_path, [request_bytes])
    _same(jax, port, body_upto=b"actual body size")
    assert port[0] == "HTTP/1.1 413 Request Entity Too Large"
    assert port[1]["content-type"] == "text/plain; charset=utf-8"
    assert port[2].startswith(
        b"Maximum request body size 1024 exceeded, actual body size")


def test_oversized_body_is_checked_only_when_read(tmp_path):
    """A banned client gets 403, an unknown path 404, a GET route its
    answer, and the rate limit 429, whatever the body's size."""
    big = _big_tx(2000)
    answers = _answers(tmp_path, [
        _sized("GET", "/get_mining_info", big),
        _sized("POST", "/nope", big),
        _sized("POST", "/get_blocks", big),
        *[_sized("POST", "/", big) for _ in range(4)],
    ], ip_config={"block_endpoints": ["get_blocks"]}, rate_limits=True)
    for jax, port in answers:
        _same(jax, port)
    assert [port[0].split(" ")[1] for _jax, port in answers] == \
        ["200", "404", "403", "405", "405", "405", "429"]
    banned = _answers(tmp_path, [_sized("POST", "/push_tx", big)],
                      ip_config={"blocklist": ["127.0.0.1"]})
    _same(*banned[0])
    assert json.loads(banned[0][1][2]) == {"ok": False,
                                           "error": "Access forbidden."}


@pytest.mark.parametrize("request_bytes, allow", [
    (_head("OPTIONS", "/get_blocks"), "GET,HEAD"),
    (_sized("PUT", "/push_tx", b""), "GET,HEAD,POST"),
    (_sized("POST", "/get_block", b""), "GET,HEAD"),
], ids=["options_get_blocks", "put_push_tx", "post_get_block"])
def test_405_names_the_allowed_methods(tmp_path, request_bytes, allow):
    [(jax, port)] = _answers(tmp_path, [request_bytes])
    _same(jax, port)
    assert port[0] == "HTTP/1.1 405 Method Not Allowed"
    assert port[1]["allow"] == allow


@pytest.mark.parametrize("close", [True, False], ids=["close", "no_header"])
def test_http10_request_gets_an_http10_status_line(tmp_path, close):
    [(jax, port)] = _answers(tmp_path, [_head(
        "GET", "/get_mining_info", version="HTTP/1.0", close=close)])
    _same(jax, port)
    assert port[0] == "HTTP/1.0 200 OK"
