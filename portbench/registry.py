"""Finding a cell's parts by name: ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<name>.py`` under the benchmark's
folder (or under ``base``, which the tests point at a folder of their
own).  A later cell, mix or metric is a new file, and no file here
changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, suffix: str, base: Optional[Path]) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return (base or HERE) / kind / f"{name}{suffix}"


def config(name: str, base: Optional[Path] = None) -> dict:
    with open(_path("configs", name, ".json", base)) as f:
        return json.load(f)


def traffic(name: str, base: Optional[Path] = None) -> dict:
    with open(_path("traffic", name, ".json", base)) as f:
        return json.load(f)


def metric_reader(name: str, base: Optional[Path] = None) -> ModuleType:
    """The module ``metrics/<name>.py``; its ``read(obs)`` returns the
    metric's value or None when the run left it nothing to read."""
    path = _path("metrics", name, ".py", base)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
