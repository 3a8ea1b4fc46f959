"""Playlist next-track model (counterpart of
``esrecsys_tpu/models/playlist.py``).

A track is concat(album_embed, artist_embed); album ids are floor-mod
hashed into a bounded table. The affinity of an item to a playlist context
is the max dot product over the context's track embeddings plus 0.1 boosts
when the item's album or artist appears in the context.

``compute_dtype=torch.bfloat16`` follows the reference's bf16 scoring:
JAX multiplies bf16 inputs with ``preferred_element_type=float32``, which
forms exact products and sums them in float32. The port rounds the inputs
to bf16, widens them back and multiplies in float32 (TF32 must be off on a
card); a bf16 product would round its output to bf16 instead. Autograd
through the two casts rounds the cotangent to bf16, as JAX does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from esrecsys_tpu_torch.models.layers import TableEmbed


def table_rows_multiple(feature_size: int) -> int:
    """Row alignment of the playlist tables: 128 whenever D divides 128,
    as the reference's ``workloads/playlist._table_rows_multiple`` gives
    under its default ``packed_tables="auto"``. At D=32 the 295,861
    artists pad to 295,936 rows, so artifacts load across the packages."""
    return 128 if 0 < feature_size < 128 and 128 % feature_size == 0 else 1


def _cast(x: torch.Tensor, compute_dtype: Optional[torch.dtype]
          ) -> torch.Tensor:
    """bf16-rounded values held in float32, or ``x`` unchanged."""
    return x if compute_dtype is None else x.to(compute_dtype).float()


def batched_isin(element: torch.Tensor, test_set: torch.Tensor
                 ) -> torch.Tensor:
    """Per-batch membership: element (B, M), test_set (B, C) -> bool
    (B, M)."""
    return (element[..., :, None] == test_set[..., None, :]).any(-1)


def affinity_scores(
    context_embed: torch.Tensor,   # (B, C, D)
    item_embed: torch.Tensor,      # (B, M, D), or shared (M, D)
    item_album: torch.Tensor,      # (B, M), or shared (M,)
    item_artist: torch.Tensor,     # (B, M), or shared (M,)
    album_context: torch.Tensor,   # (B, C)
    artist_context: torch.Tensor,  # (B, C)
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """max-dot over context slots + 0.1 album/artist membership boosts,
    batched: -> (B, M) float32. A 2-D ``item_embed`` is a shared item set
    (one pool or corpus block scored against every query). The max is
    ``amax``, whose gradient splits equally among tied slots as JAX's
    does (tracks sharing album and artist have equal vectors)."""
    ctx = _cast(context_embed, compute_dtype)
    items = _cast(item_embed, compute_dtype)
    if items.dim() == 2:
        dots = torch.einsum("md,bcd->bmc", items, ctx)
        bsz = ctx.shape[0]
        item_album = item_album.expand(bsz, -1)
        item_artist = item_artist.expand(bsz, -1)
    else:
        dots = torch.einsum("bmd,bcd->bmc", items, ctx)
    aff = dots.amax(-1)
    aff = aff + 0.1 * batched_isin(item_album, album_context).float()
    aff = aff + 0.1 * batched_isin(item_artist, artist_context).float()
    return aff


def score_embeddings(
    context_embed: torch.Tensor,   # (B, C, D)
    next_embed: torch.Tensor,      # (B, M, D)
    neg_embed: torch.Tensor,       # (B, N, D) or shared (N, D)
    next_album: torch.Tensor,
    next_artist: torch.Tensor,
    neg_album: torch.Tensor,
    neg_artist: torch.Tensor,
    album_context: torch.Tensor,
    artist_context: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple:
    """Post-gather scoring shared by :meth:`PlaylistModel.forward` and the
    row-sparse train step: (pos_affinity, neg_affinity, ctx/next/neg
    self-affinity, L2 norms; a ((B, C+M), (N,)) pair in shared-negative
    mode). L2 norms stay float32 whatever ``compute_dtype`` is."""
    shared = neg_embed.dim() == 2
    pos_affinity = affinity_scores(
        context_embed, next_embed, next_album, next_artist,
        album_context, artist_context, compute_dtype)
    neg_affinity = affinity_scores(
        context_embed, neg_embed, neg_album, neg_artist,
        album_context, artist_context, compute_dtype)

    def l2(e):
        return torch.sqrt(e.square().sum(-1))

    if shared:
        all_l2 = (l2(torch.cat([context_embed, next_embed], dim=-2)),
                  l2(neg_embed))
    else:
        all_l2 = l2(torch.cat([context_embed, next_embed, neg_embed],
                              dim=-2))

    # flip-paired self-affinities: row i against row n-1-i of one group
    def self_aff(e):
        e = _cast(e, compute_dtype)
        if e.dim() == 2:
            return torch.einsum("md,nd->mn", e.flip(-2), e)
        return torch.einsum("bmd,bnd->bmn", e.flip(-2), e)

    return (pos_affinity, neg_affinity, self_aff(context_embed),
            self_aff(next_embed), self_aff(neg_embed), all_l2)


class PlaylistModel(nn.Module):
    def __init__(self, feature_size: int, album_hash_buckets: int = 100_000,
                 num_artists: int = 295_861,
                 table_rows_multiple: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_size = feature_size
        self.compute_dtype = compute_dtype
        self.album_hash_buckets = album_hash_buckets
        self.num_artists = num_artists
        self.album_embed = TableEmbed(
            album_hash_buckets, feature_size, table_rows_multiple,
            device=device, generator=generator, name="album_embed")
        self.artist_embed = TableEmbed(
            num_artists, feature_size, table_rows_multiple,
            device=device, generator=generator, name="artist_embed")

    def get_embeddings(self, album: torch.Tensor,
                       artist: torch.Tensor) -> torch.Tensor:
        """(...,) int ids -> (..., 2 * feature_size) track embeddings."""
        # floor mod (never torch.fmod): negative raw ids land in [0, buckets)
        album_e = self.album_embed(torch.remainder(album,
                                                   self.album_hash_buckets))
        artist_e = self.artist_embed(artist)
        return torch.cat([album_e, artist_e], dim=-1)

    def forward(self, track_context, album_context, artist_context,
                next_track, next_album, next_artist,
                neg_track, neg_album, neg_artist) -> Tuple:
        """The reference's six outputs (see :func:`score_embeddings`) for
        (B, C) contexts, (B, M) next tracks and (B, N) negatives, or a
        shared (N,) pool. Track ids are unused: the model has no track
        table."""
        del track_context, next_track, neg_track
        return score_embeddings(
            self.get_embeddings(album_context, artist_context),
            self.get_embeddings(next_album, next_artist),
            self.get_embeddings(neg_album, neg_artist),
            next_album, next_artist, neg_album, neg_artist,
            album_context, artist_context,
            compute_dtype=self.compute_dtype)
