"""Playlist next-track model, embedding half (counterpart of
``esrecsys_tpu/models/playlist.py``).

A track is concat(album_embed, artist_embed); album ids are floor-mod
hashed into a bounded table. The scoring and loss half belongs to the
training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from esrecsys_tpu_torch.models.layers import TableEmbed


def table_rows_multiple(feature_size: int) -> int:
    """Row alignment of the playlist tables: 128 whenever D divides 128,
    as the reference's ``workloads/playlist._table_rows_multiple`` gives
    under its default ``packed_tables="auto"``. At D=32 the 295,861
    artists pad to 295,936 rows, so artifacts load across the packages."""
    return 128 if 0 < feature_size < 128 and 128 % feature_size == 0 else 1


class PlaylistModel(nn.Module):
    def __init__(self, feature_size: int, album_hash_buckets: int = 100_000,
                 num_artists: int = 295_861,
                 table_rows_multiple: int = 1,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_size = feature_size
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
