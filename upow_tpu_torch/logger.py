"""Logger setup: rotating file + console (reference upow/my_logger.py:17-53).

The port's copy of the JAX package's ``logger.py``.  One process-wide
configuration on the ``upow_tpu_torch`` logger namespace; every module
logs via ``logging.getLogger("upow_tpu_torch.<mod>")``.  The
reference's ``--nologs`` flag (helpers.py:20) maps to ``console=False``
/ a WARNING level.  The node configures it from ``Config.log`` when it
starts, as the JAX node does.
"""

from __future__ import annotations

import datetime
import json
import logging
import logging.handlers
import os
from typing import Optional

from .config import LogConfig

_configured = False


class JsonlFormatter(logging.Formatter):
    """One JSON object per line, carrying the active trace ID so log
    lines join against /debug/traces and cross-node gossip hops."""

    def format(self, record: logging.LogRecord) -> str:
        # late import: telemetry.metrics itself logs through this module
        from .telemetry import tracing

        rec = {
            "ts": datetime.datetime.fromtimestamp(
                record.created, tz=datetime.timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "trace_id": tracing.current_trace_id(),
        }
        if record.exc_info:
            rec["exc"] = self.formatException(record.exc_info)
        return json.dumps(rec, default=str)


def setup_logging(cfg: Optional[LogConfig] = None) -> logging.Logger:
    """Idempotent: first caller wins, later calls return the root logger."""
    global _configured
    root = logging.getLogger("upow_tpu_torch")
    if _configured:
        return root
    cfg = cfg or LogConfig()
    root.setLevel(getattr(logging, cfg.level.upper(), logging.INFO))
    if getattr(cfg, "json_format", False):
        fmt: logging.Formatter = JsonlFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s [%(name)s] %(message)s")
    if cfg.path:
        os.makedirs(os.path.dirname(cfg.path) or ".", exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            cfg.path, maxBytes=cfg.max_bytes, backupCount=cfg.backups)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    if cfg.console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        root.addHandler(ch)
    root.propagate = False
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(
        f"upow_tpu_torch.{name}" if name else "upow_tpu_torch")
