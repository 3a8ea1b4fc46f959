"""Loss helpers (counterpart of ``esrecsys_tpu/ops/losses.py``, the parts
the playlist and GloVe losses use)."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as the reference's ``jnp.maximum(x, 0)``: where
    x == 0 the gradient splits in half between the two arguments, so x
    receives 0.5 (``torch.relu`` would give it 0)."""
    return torch.maximum(x, x.new_zeros(()))


def glove_weight(count: torch.Tensor, x_max: float = 100.0,
                 alpha: float = 0.75) -> torch.Tensor:
    """GloVe's weight ``min(1, count / x_max) ** alpha``."""
    return torch.pow(torch.minimum(torch.ones_like(count), count / x_max),
                     alpha)


def glove_target(count: torch.Tensor) -> torch.Tensor:
    """``log10(1 + count)``: base 10, not e."""
    return torch.log10(1.0 + count)


def glove_loss(predicted: torch.Tensor, count: torch.Tensor,
               x_max: float = 100.0, alpha: float = 0.75) -> torch.Tensor:
    """Weighted squared error against the log co-occurrence, mean over the
    batch."""
    w = glove_weight(count, x_max, alpha)
    err = glove_target(count) - predicted
    return torch.mean(torch.square(err) * w)
