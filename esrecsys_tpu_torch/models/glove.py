"""GloVe co-occurrence embedding model (counterpart of
``esrecsys_tpu/models/glove.py``): a token table and a zero-initialised
1-wide bias table, both ``TableEmbed``; a (token1, token2) pair scores
``dot(e1, e2) + b1 + b2``, which approximates log10(1 + count).

Both lookups of a batch go through one row gather per table (the row-gather
kernel on the card: its float32 instantiation for the token table, its
narrow one for the 1-wide bias), and the backward through one row scatter
per table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from esrecsys_tpu_torch.models.layers import TableEmbed
from esrecsys_tpu_torch.retrieval.mips import NEG_INF, require_full_f32


class Glove(nn.Module):
    """``num_embeddings`` rows of ``features`` (the reference's padded
    count); rows at or past ``valid_rows`` are padding, and
    :meth:`score_all` scores them ``-inf``."""

    def __init__(self, num_embeddings: int = 1024, features: int = 64,
                 valid_rows: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.valid_rows = valid_rows
        self.token_embedding = TableEmbed(
            num_embeddings, features, device=device, generator=generator,
            name="token_embedding")
        self.bias = TableEmbed(num_embeddings, 1, device=device,
                               name="bias", zeros=True)

    def forward(self, inputs: Tuple[torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
        """Predicted log10 co-occurrence of each (token1, token2): (B,)."""
        token1, token2 = inputs
        b = token1.shape[0]
        ids = torch.cat([token1, token2])
        e = self.token_embedding(ids)
        bias = self.bias(ids)[:, 0]
        return (e[:b] * e[b:]).sum(-1) + bias[:b] + bias[b:]

    def score_all(self, tokens: torch.Tensor) -> torch.Tensor:
        """(P, rows) dot products of the tokens' embeddings with every row,
        without the bias (the reference's KNN is by raw dot product), in
        full float32 (TF32 off on a card); padding rows score ``-inf``."""
        query = self.token_embedding(tokens)
        table = self.token_embedding.embedding
        require_full_f32(table)
        scores = query @ table.T
        if self.valid_rows is not None and self.valid_rows < scores.shape[-1]:
            scores[:, self.valid_rows:] = NEG_INF
        return scores
