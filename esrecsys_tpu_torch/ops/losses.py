"""Loss helpers (counterpart of ``esrecsys_tpu/ops/losses.py``, the part
the playlist loss uses)."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as the reference's ``jnp.maximum(x, 0)``: where
    x == 0 the gradient splits in half between the two arguments, so x
    receives 0.5 (``torch.relu`` would give it 0)."""
    return torch.maximum(x, x.new_zeros(()))
