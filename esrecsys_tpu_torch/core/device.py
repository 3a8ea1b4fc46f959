"""Device selection and static-shape helpers."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import numpy as np
import torch


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Asking for CUDA on a host without a usable card raises;
    nothing drops quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def array_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on a card through pinned host memory
    with a ``non_blocking`` copy, so the copy overlaps the host's next
    work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def card_line(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for
    a CUDA ``device``; None on the CPU. A measurement on the card names
    both, since a card set below its limit runs slower under load."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()
