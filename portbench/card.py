"""The card: whether it is there, and what ``nvidia-smi`` reads beside the
window (name, power limit, SM clock, memory in use, utilization)."""

from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import List, Optional

FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm", "power.draw",
          "memory.used", "utilization.gpu")


class NoCard(RuntimeError):
    pass


def require(chips: int) -> dict:
    """The card's description, or NoCard: the harness never falls back
    to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no CUDA card")
    count = torch.cuda.device_count()
    if count < chips:
        raise NoCard(f"{count} CUDA card(s), the cell asks for {chips}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def _number(text: str) -> Optional[float]:
    try:
        return float(text)
    except ValueError:
        return None


class Sampler:
    """``nvidia-smi`` every ``period_ms`` on a thread of its own, card 0."""

    def __init__(self, period_ms: int = 200):
        self.period_ms = period_ms
        self.rows: List[dict] = []
        self._proc: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Sampler":
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return self
        self._proc = subprocess.Popen(
            [exe, "--id=0", "--query-gpu=" + ",".join(FIELDS),
             "--format=csv,noheader,nounits", f"-lms={self.period_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(FIELDS):
                continue
            row = {"t": time.monotonic(), "name": parts[0]}
            for key, text in zip(FIELDS[1:], parts[1:]):
                row[key] = _number(text)
            self.rows.append(row)

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._thread.join(timeout=5)
            self._proc = None

    def between(self, t0: float, t1: float) -> List[dict]:
        return [r for r in self.rows if t0 <= r["t"] <= t1]

    def summary(self, t0: float, t1: float) -> dict:
        """What the card read over [t0, t1]: its name and power limit, the
        SM clock's median and range, and the most memory in use."""
        rows = self.between(t0, t1) or self.rows[-1:]
        if not rows:
            return {}

        def col(key):
            return sorted(r[key] for r in rows if r.get(key) is not None)

        clocks = col("clocks.sm")
        mem = col("memory.used")
        util = col("utilization.gpu")
        return {
            "name": rows[0]["name"],
            "power_limit_w": rows[0].get("power.limit"),
            "sm_clock_mhz_median": clocks[len(clocks) // 2] if clocks else None,
            "sm_clock_mhz_min": clocks[0] if clocks else None,
            "sm_clock_mhz_max": clocks[-1] if clocks else None,
            "sm_clock_max_mhz": rows[0].get("clocks.max.sm"),
            "power_draw_w_max": max(col("power.draw") or [0.0]),
            "memory_used_bytes_max": int(mem[-1] * 2**20) if mem else None,
            "utilization_gpu_mean": sum(util) / len(util) if util else None,
            "samples": len(rows),
        }
