"""The miner's own HTTP endpoint (``miner --metrics-port N``).

A ``ThreadingHTTPServer`` on a daemon thread of the miner's process,
serving what the node serves of its telemetry:

* ``/metrics``: the registries in Prometheus text (0.0.4), rendered by
  the node's own code (``telemetry.exposition.Exposition.registries``):
  the miner's ``mine.*`` families (``engine.preregister``), its spans
  and the device runtime's, ``runtime.queue_wait.mine`` among them;
* ``/debug/traces``: a ``mine.template`` tree a template (its fetch and
  build) and a ``mine.push_block`` one a push, under
  ``telemetry.debug_endpoints``;
* ``/debug/profile?action=start|stop|status``: a ``torch.profiler``
  capture (``profiling``) into ``profile.trace_dir``, served only when
  ``profile.enabled`` (``UPOW_PROFILE_ENABLED=1``) as well; it records
  every thread, and the program's spans lie in it beside the kernels on
  the profiler's clock (``profiling.start(spans=True)``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlsplit

from .. import telemetry
from ..config import ProfilingConfig, TelemetryConfig


def _json(status: int, body: dict) -> Tuple[int, bytes, str]:
    return status, json.dumps(body).encode(), "application/json"


class MinerEndpoint:
    """The endpoint on ``host:port`` (``port`` 0: a free one, for tests),
    serving from a daemon thread until :meth:`close`.  Built on the
    thread that imported torch: with profiling on, it primes the
    profiler there (Kineto refuses a first start from another thread)."""

    def __init__(self, port: int, tcfg: TelemetryConfig,
                 pcfg: ProfilingConfig, host: str = "0.0.0.0"):
        self.debug = tcfg.debug_endpoints
        self.pcfg = pcfg if pcfg.enabled and self.debug else None
        if self.pcfg is not None:
            from .. import profiling

            profiling.prime()
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args):
                pass

            def do_GET(self):
                status, body, ctype = endpoint.answer(self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True, name="miner-endpoint")
        self.thread.start()

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def answer(self, target: str) -> Tuple[int, bytes, str]:
        """(status, body, content type) of a GET of ``target``."""
        url = urlsplit(target)
        if url.path == "/metrics":
            e = telemetry.exposition.Exposition()
            e.registries()
            return 200, e.render().encode(), telemetry.exposition.CONTENT_TYPE
        if url.path == "/debug/traces" and self.debug:
            return _json(200, {"ok": True, "result": telemetry.traces()})
        if url.path == "/debug/profile" and self.pcfg is not None:
            return self._profile(parse_qs(url.query).get("action",
                                                         ["status"])[0])
        return _json(404, {"ok": False, "error": "Not found"})

    def _profile(self, action: str) -> Tuple[int, bytes, str]:
        from .. import profiling

        if action == "start":
            result = profiling.start(self.pcfg.trace_dir,
                                     self.pcfg.max_capture_seconds,
                                     spans=True)
        elif action == "stop":
            result = profiling.stop()
        elif action == "status":
            result = profiling.status()
        else:
            return _json(400, {"ok": False, "error":
                               "action must be start, stop or status"})
        return _json(200, {"ok": "error" not in result, "result": result})

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)
