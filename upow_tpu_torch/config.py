"""Typed configuration: the part of the JAX package's ``config.py`` that
the miner reads.

Each field takes its default unless a ``UPOW_<SECTION>_<FIELD>``
environment variable sets it (``UPOW_DEVICE_SEARCH_BATCH=16777216``), the
JAX package's convention.  The config file, the keyword overrides, the
other fields and the other sections (node, mempool, telemetry, ...) come
with the slices that read them (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field


@dataclass
class DeviceConfig:
    """Compute settings for the miner."""

    search_batch: int = 1 << 24     # nonces per device dispatch


@dataclass
class Config:
    device: DeviceConfig = field(default_factory=DeviceConfig)

    @classmethod
    def load(cls) -> "Config":
        """Defaults, then the ``UPOW_<SECTION>_<FIELD>`` environment."""
        cfg = cls()
        _apply_env_fields(cfg.device, "device")
        return cfg


def _apply_env_fields(sub, section: str) -> None:
    """Apply ``UPOW_<SECTION>_<FIELD>`` env overrides onto one config
    dataclass instance (its fields are ints and strings)."""
    for f in dataclasses.fields(sub):
        env = f"UPOW_{section.upper()}_{f.name.upper()}"
        if env in os.environ:
            raw = os.environ[env]
            setattr(sub, f.name, int(raw) if f.type in ("int", int) else raw)
