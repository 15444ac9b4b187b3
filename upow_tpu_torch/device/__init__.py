"""Which device the port runs on, and what card that is.

The entry points (``BlockManager``, ``verify_batch_prehashed``) run on
``torch.device("cuda")`` unless the caller passes ``device="cpu"``.
Without a CUDA device and without an explicit ``"cpu"`` they raise: a
node that asked for the card never carries on quietly on the host.
:mod:`.runtime` is the one owner of each device's dispatches.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for
    and PyTorch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def current_index() -> int:
    """The calling thread's current card, by ordinal."""
    return torch._C._cuda_getDevice()


def raw_stream(index: int) -> int:
    """The current stream of card ``index`` as a raw ``cudaStream_t`` for
    a kernel launched through ctypes, without the ``torch.cuda.Stream``
    object ``current_stream()`` builds."""
    return torch._C._cuda_getCurrentRawStream(index)


def card_line() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi prints them,
    or None where nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def max_sm_clock_mhz() -> Optional[float]:
    """The first card's maximum SM clock in MHz (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
