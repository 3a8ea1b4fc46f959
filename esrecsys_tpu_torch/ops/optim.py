"""Optimizer state of the row-sparse train step (counterpart of the part
of ``esrecsys_tpu/ops/optim.py`` the dense momentum carrier uses)."""

from __future__ import annotations

from typing import Dict

import torch


def momentum_init(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The dense carrier's state: one float32 zero momentum buffer shaped
    like the table. The reference's lazy carrier adds a per-row
    ``last_step``; that carrier is not ported yet."""
    return {"momentum": torch.zeros(table.shape, dtype=torch.float32,
                                    device=table.device)}
