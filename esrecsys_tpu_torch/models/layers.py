"""Shared layers (counterpart of ``esrecsys_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.ops import guards


class TableEmbed(nn.Module):
    """Embedding table whose parameter is named ``embedding``.

    Rows are padded to a multiple of ``rows_multiple`` (the reference pads
    to 128 rows at D dividing 128 so its lane-packed layouts apply); the
    padded rows are initialised like the rest and sit past the id guard.
    Init: ``normal / sqrt(features)`` drawn from ``generator``.

    Lookup with the guard ``off`` follows ``jnp.take``'s default mode, not
    raw indexing (which is a device-side assert on CUDA): negative ids in
    ``[-R, 0)`` wrap to ``id + R`` and any other id outside ``[0, R)``
    returns a NaN row, where R is the PADDED row count.
    """

    def __init__(self, num_embeddings: int, features: int,
                 rows_multiple: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "embed"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.name = name
        rows = pad_to_multiple(num_embeddings, rows_multiple)
        init = torch.randn(rows, features, generator=generator,
                           device=device, dtype=torch.float32)
        self.embedding = nn.Parameter(init / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = guards.check_ids(ids, self.num_embeddings, self.name)
        table = self.embedding
        rows = table.shape[0]
        ids = ids.to(torch.int64)
        wrapped = torch.where(ids < 0, ids + rows, ids)
        outside = (wrapped < 0) | (wrapped >= rows)
        out = table[torch.where(outside, 0, wrapped)]
        return torch.where(outside[..., None],
                           torch.full_like(out, float("nan")), out)
