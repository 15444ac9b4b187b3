"""The check that nothing of JAX or of the JAX package is loaded.

A module counts by its top-level name, the part before the first dot,
compared whole: ``upow_tpu_torch`` is the port and passes, while
``upow_tpu`` and ``upow_tpu.core`` are the JAX package and do not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "upow_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
