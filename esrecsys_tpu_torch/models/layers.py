"""Shared layers (counterpart of ``esrecsys_tpu/models/layers.py``)."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.ops import guards
from esrecsys_tpu_torch.ops.lookup import gather_rows


def normal_embed_init(rows: int, features: int,
                      generator: Optional[torch.Generator],
                      device: Optional[torch.device]) -> torch.Tensor:
    """``normal / sqrt(features)`` drawn from ``generator``."""
    table = torch.randn(rows, features, generator=generator, device=device,
                        dtype=torch.float32)
    return table / math.sqrt(features)


def zeros_init(rows: int, features: int,
               generator: Optional[torch.Generator],
               device: Optional[torch.device]) -> torch.Tensor:
    """Zeros (the reference's ``zeros_init``, GloVe's bias)."""
    return torch.zeros(rows, features, device=device)


class TableEmbed(nn.Module):
    """Embedding table whose parameter is named ``embedding``.

    Rows are padded to a multiple of ``rows_multiple`` (the reference pads
    to 128 rows at D dividing 128 so its lane-packed layouts apply); the
    padded rows are initialised like the rest and sit past the id guard.
    Init: ``init(rows, features, generator, device)``, by default
    :func:`normal_embed_init`.

    Lookup with the guard ``off`` follows ``jnp.take``'s default mode, not
    raw indexing (which is a device-side assert on CUDA): negative ids in
    ``[-R, 0)`` wrap to ``id + R`` and any other id outside ``[0, R)``
    returns a NaN row, where R is the PADDED row count. Rows are read
    through :func:`esrecsys_tpu_torch.ops.lookup.gather_rows` (the row
    gather kernel on the card), so the lookup is differentiable in the
    table with a row-scatter backward.
    """

    def __init__(self, num_embeddings: int, features: int,
                 rows_multiple: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 name: str = "embed",
                 init: Callable = normal_embed_init):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.name = name
        rows = pad_to_multiple(num_embeddings, rows_multiple)
        self.embedding = nn.Parameter(init(rows, features, generator,
                                           device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = guards.check_ids(ids, self.num_embeddings, self.name)
        table = self.embedding
        rows = table.shape[0]
        ids = ids.to(torch.int64)
        wrapped = torch.where(ids < 0, ids + rows, ids)
        outside = (wrapped < 0) | (wrapped >= rows)
        flat = torch.where(outside, 0, wrapped).reshape(-1)
        out = gather_rows(table, flat).reshape(*ids.shape, self.features)
        return torch.where(outside[..., None],
                           torch.full_like(out, float("nan")), out)
