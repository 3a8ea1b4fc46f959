"""Text -> URL two-tower model (counterpart of
``esrecsys_tpu/models/txt2url.py``): a sentence encoder (word table, then
an LSTM or a masked mean, then a dense projection into URL space) against
a URL table shared by the text head and the url2url head.

Module and parameter names mirror the reference's flax tree
(``encoder.word_embedding.embedding``, ``encoder.rnn.cell.ii.kernel``
... ``encoder.rnn.cell.ho.bias``, ``encoder.to_url.kernel``,
``url_embedding.embedding``), so ``convert.params_from_jax`` and the
artifact format carry parameters across unchanged. Dense kernels are
``(in, out)``, the transpose of a ``torch.nn.Linear`` weight.

The LSTM is flax's ``OptimizedLSTMCell`` under ``nn.RNN(...,
seq_lengths=lengths, return_carry=True)``: input projections ``ii, if,
ig, io`` without bias, hidden projections ``hi, hf, hg, ho`` with bias;
``i, f, o = sigmoid``, ``g = tanh``, ``c' = f c + i g``, ``h' = o
tanh(c')``, from a zero carry. Its recurrence is written as explicit
per-step float32 matmuls (the input projections of all steps in one).
A sequence's length is its count of non-zero tokens, and its encoding
is the ``h`` after step ``length - 1``: as in the reference, a sequence
of length 0 takes index -1, the ``h`` after the last step (the pad rows
run through the LSTM then), and steps past a sequence's end give no
gradient. On a card every float32 product here must be full float32
(TF32 off), as the reference's are.

Both tables are ``TableEmbed``s without row padding, initialised
``he_normal`` (fan-in the table's row count, as flax's variance scaling
reads an embedding table); their lookups go through the row-gather
kernel and the row scatter-add kernel in the backward. The three URL
lookups of a batch are one gather.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from esrecsys_tpu_torch.models.layers import TableEmbed
from esrecsys_tpu_torch.retrieval.mips import require_full_f32

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, std: float, generator, device) -> torch.Tensor:
    """A normal truncated at two standard deviations and scaled to
    ``std`` (flax's ``variance_scaling(..., "truncated_normal")``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std / _TRUNC_STD)


def he_normal_embed_init(rows: int, features: int, generator=None,
                         device=None) -> torch.Tensor:
    """flax's ``he_normal`` of a (rows, features) table: fan-in is the row
    count (axis -2), so the std is ``sqrt(2 / rows)``, truncated at 2
    sigma."""
    return _truncated_normal((rows, features), math.sqrt(2.0 / rows),
                             generator, device)


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` (in,
    out), lecun-normal, and ``bias`` zeros (or no bias); ``orthogonal``
    draws the kernel as flax's ``orthogonal`` initialiser does (the LSTM's
    recurrent kernels)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, orthogonal: bool = False,
                 device=None, generator=None):
        super().__init__()
        if orthogonal:
            kernel = torch.empty(in_features, out_features, device=device)
            torch.nn.init.orthogonal_(kernel, generator=generator)
        else:
            kernel = _truncated_normal((in_features, out_features),
                                       math.sqrt(1.0 / in_features),
                                       generator, device)
        self.kernel = nn.Parameter(kernel)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


GATES = "ifgo"


class LSTM(nn.Module):
    """``nn.RNN(nn.OptimizedLSTMCell(hidden))`` with ``seq_lengths`` and
    ``return_carry``: the ``h`` of each sequence's carry at its end."""

    def __init__(self, in_features: int, hidden: int, device=None,
                 generator=None):
        super().__init__()
        self.hidden = hidden
        cell = {}
        for g in GATES:
            cell[f"i{g}"] = Dense(in_features, hidden, use_bias=False,
                                  device=device, generator=generator)
            cell[f"h{g}"] = Dense(hidden, hidden, orthogonal=True,
                                  device=device, generator=generator)
        self.cell = nn.ModuleDict(cell)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        """(B, L, F) inputs and (B,) lengths -> (B, hidden)."""
        B, L, _ = x.shape
        H = self.hidden
        w_i = torch.cat([self.cell[f"i{g}"].kernel for g in GATES], -1)
        w_h = torch.cat([self.cell[f"h{g}"].kernel for g in GATES], -1)
        b_h = torch.cat([self.cell[f"h{g}"].bias for g in GATES], -1)
        x_proj = x @ w_i                                  # (B, L, 4H)
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        hs = []
        for t in range(L):
            z = (h @ w_h + b_h) + x_proj[:, t]
            i, f, g, o = z.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        # the reference's x[lengths - 1]: length 0 wraps to the last step
        last = torch.remainder(lengths.long() - 1, L)
        return torch.stack(hs)[last, torch.arange(B, device=x.device)]


class SentenceEncoder(nn.Module):
    """Tokens (B, L) -> URL-space embedding (B, url_dim)."""

    def __init__(self, vocab_size: int, word_dim: int = 64,
                 rnn_size: int = 64, url_dim: int = 64,
                 encoder_type: str = "lstm", device=None, generator=None):
        super().__init__()
        if encoder_type not in ("lstm", "mean"):
            raise ValueError(f"unknown encoder_type {encoder_type!r}")
        self.encoder_type = encoder_type
        self.word_embedding = TableEmbed(
            vocab_size, word_dim, device=device, generator=generator,
            name="word_embedding", init=he_normal_embed_init)
        if encoder_type == "lstm":
            self.rnn = LSTM(word_dim, rnn_size, device, generator)
        self.to_url = Dense(rnn_size if encoder_type == "lstm" else word_dim,
                            url_dim, device=device, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        require_full_f32(self.word_embedding.embedding)
        emb = self.word_embedding(tokens)                 # (B, L, W)
        mask = tokens != 0
        if self.encoder_type == "lstm":
            hidden = self.rnn(emb, mask.sum(-1))
        else:
            m = mask.to(emb.dtype)[..., None]
            denom = torch.clamp(m.sum(-2), min=1.0)
            hidden = (emb * m).sum(-2) / denom
        return self.to_url(hidden)


class Txt2UrlModel(nn.Module):
    def __init__(self, word_vocab_size: int, url_vocab_size: int,
                 word_dim: int = 64, rnn_size: int = 64, url_dim: int = 64,
                 encoder_type: str = "lstm", device=None, generator=None):
        super().__init__()
        self.encoder = SentenceEncoder(word_vocab_size, word_dim, rnn_size,
                                       url_dim, encoder_type, device,
                                       generator)
        self.url_embedding = TableEmbed(
            url_vocab_size, url_dim, device=device, generator=generator,
            name="url_embedding", init=he_normal_embed_init)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encoder(tokens)

    def encode_url(self, url_ids: torch.Tensor) -> torch.Tensor:
        return self.url_embedding(url_ids)

    def _urls(self, *ids: torch.Tensor):
        """Several (B,) id vectors through one lookup."""
        rows = self.url_embedding(torch.cat(ids))
        return rows.split([i.shape[0] for i in ids])

    def score_text_vs_all(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, url rows) float32 scores of each text against every URL
        row: one full-float32 matmul against the whole table."""
        table = self.url_embedding.embedding
        require_full_f32(table)
        return self.encoder(tokens) @ table.T

    def all_pairs_scores(self, url_near_text: torch.Tensor,
                         tokens: torch.Tensor, url1: torch.Tensor,
                         url2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's (B, B) similarity matrices: every text_i against
        every url_j of the text head, every url1_i against every url2_j of
        the url2url head, rows the first argument's."""
        u_text, u1, u2 = self._urls(url_near_text, url1, url2)
        return self.encoder(tokens) @ u_text.T, u1 @ u2.T

    def forward(self, url_near_text: torch.Tensor, tokens: torch.Tensor,
                url1: torch.Tensor, url2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """(text_score (B,), url_score (B,), text_embed, url_embed)."""
        text_embed = self.encoder(tokens)
        url_text_embed, u1, u2 = self._urls(url_near_text, url1, url2)
        text_score = (text_embed * url_text_embed).sum(-1)
        url_score = (u1 * u2).sum(-1)
        return text_score, url_score, text_embed, url_text_embed


def max_norm_project(table: torch.Tensor, max_norm: float,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of L2 norm above ``max_norm`` scaled onto the ball (Keras's
    ``max_norm`` constraint); the others multiplied by exactly 1. Into
    ``out`` when given (``out=table`` projects in place)."""
    norms = torch.sqrt(torch.sum(torch.square(table), dim=-1, keepdim=True))
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return torch.mul(table, scale, out=out)
