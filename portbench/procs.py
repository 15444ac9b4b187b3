"""The processes of a run: the port's node and miner, each a process of
its own on the card, their output read line by line with the time each
line arrived, and a small HTTP client."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Proc:
    """A child process whose merged output lands in ``lines`` as
    (monotonic arrival time, text) and in a log file."""

    def __init__(self, name: str, argv: List[str], env: Dict[str, str],
                 cwd: Path):
        self.name = name
        self.lines: List[Tuple[float, str]] = []
        self.log = open(cwd / f"{name}.log", "w")
        self.p = subprocess.Popen(
            argv, cwd=cwd, env=env, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            bufsize=1, start_new_session=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.p.stdout:
            t = time.monotonic()
            line = line.rstrip("\n")
            self.lines.append((t, line))
            self.log.write(f"{t:.6f} {line}\n")

    def alive(self) -> bool:
        return self.p.poll() is None

    def stop(self, timeout: float = 20.0) -> Optional[int]:
        """SIGTERM to the process group, SIGKILL after ``timeout``; waits
        for the end and for the reader to drain."""
        if self.p.poll() is None:
            try:
                os.killpg(self.p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                self.p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(self.p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                self.p.wait()
        self._reader.join(timeout=10)
        self.log.close()
        return self.p.returncode

    def tail(self, n: int = 20) -> str:
        return "\n".join(line for _t, line in self.lines[-n:])


def base_env(root: Path, work: Path) -> Dict[str, str]:
    """The environment of the node and miner processes: the checkout on
    the path, no peer but those named, rate limits off (the miner polls
    faster than the reference's 30 a minute allows), and every cache of
    the program in the checkout, the run's work directory or the
    driver's ``HOME``/``XDG_CACHE_HOME``/``TMPDIR``."""
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(root),
        "PYTHONUNBUFFERED": "1",
        "USE_FLAX": "0",
        "UPOW_NODE_SEED_URL": "",
        "UPOW_NODE_PEERS_FILE": str(work / "nodes.json"),
        "UPOW_NODE_RATE_LIMITS_ENABLED": "0",
        "UPOW_LOG_PATH": str(work / "logs" / "app.log"),
        "UPOW_LOG_CONSOLE": "0",
        "TRITON_CACHE_DIR": str(root / ".portbench" / "triton"),
        "TORCH_EXTENSIONS_DIR": str(root / ".portbench" / "torch_extensions"),
    })
    env.pop("BENCH_RUN", None)
    return env


def close_path(work: Path) -> Path:
    """The file whose appearance tells the node and the miner that the
    window has closed."""
    return work / "close.json"


def start_node(name: str, root: Path, work: Path, db: Path, device: str,
               env_extra: Optional[Dict[str, str]] = None) -> Tuple[Proc, str]:
    """The port's ``node.run``, in ``portbench.node_shim``, which reports
    the forbidden modules it holds once ``close`` appears."""
    port = free_port()
    env = base_env(root, work)
    env["UPOW_NODE_SELF_URL"] = f"http://127.0.0.1:{port}"
    env["PORTBENCH_CLOSE"] = str(close_path(work))
    env.update(env_extra or {})
    proc = Proc(name, [sys.executable, "-m", "portbench.node_shim",
                       "--device", device, "--db", str(db),
                       "--port", str(port)], env, work)
    return proc, f"http://127.0.0.1:{port}/"


def get_json(url: str, timeout: float = 30.0, data: Optional[dict] = None):
    req = urllib.request.Request(
        url, data=json.dumps(data).encode() if data is not None else None,
        headers={"Content-Type": "application/json"} if data is not None else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def get_text(url: str, timeout: float = 30.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def wait_ready(proc: Proc, url: str, deadline: float) -> None:
    """Until the node answers ``/`` (it arms its device runtime before it
    serves), or RuntimeError with the end of its output."""
    while time.monotonic() < deadline:
        if not proc.alive():
            raise RuntimeError(f"{proc.name} exited:\n{proc.tail()}")
        try:
            get_json(url, timeout=5)
            return
        except (urllib.error.URLError, OSError, ValueError):
            time.sleep(0.25)
    raise RuntimeError(f"{proc.name} did not serve in time:\n{proc.tail()}")


def scrape(url: str) -> Dict[str, float]:
    """A node's ``/metrics``: {sample name with labels: value}."""
    out: Dict[str, float] = {}
    for line in get_text(url + "metrics").splitlines():
        if not line or line.startswith("#"):
            continue
        body = line.split(" # ", 1)[0].split()
        if len(body) >= 2:
            try:
                out[body[0]] = float(body[1])
            except ValueError:
                pass
    return out
