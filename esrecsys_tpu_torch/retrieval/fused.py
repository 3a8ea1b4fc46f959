"""Fused MIPS scan+select (counterpart of ``esrecsys_tpu/retrieval/fused.py``).

The catalog is kept TRANSPOSED and bf16, a (D, Mp) scan copy with Mp
padded to whole bin blocks. Item g maps to bin ``g mod L``; the scan keeps
each bin's top two candidates (:mod:`esrecsys_tpu_torch.kernels.fused_scan`,
a hand-written CUDA kernel on the card), and the host side finishes with
one small top-k over the (B, 2L) candidates and an exact float32 rescore
of the k winners. A true top-k item is lost only when two higher-scoring
items share its bin: about C(k,3)/L^2 items per query for score-random
item order (about 1.2 of 500 at k=500, L=4096).

:func:`binned_affinity_candidates` is the full-corpus eval's variant: the
playlist-affinity score (max over context slots plus the album and artist
membership boosts) folded into the same per-bin top-2
(:mod:`esrecsys_tpu_torch.kernels.fused_affinity`).

Not ported yet: the int8 catalog (``item_scales``) branch used by quantized
serving and the catalog-sharded path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.kernels.fused_affinity import fused_affinity
from esrecsys_tpu_torch.kernels.fused_scan import SUPPORTED_DIMS, fused_scan
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, Count, pad_topk,
                                               topk_lower_index_first,
                                               valid_bound)


def validate_fused_bins(bins: int, dim: int, use_mask: bool = False,
                        use_scales: bool = False,
                        device: Optional[torch.device] = None) -> None:
    """Raise ValueError when the fused scan cannot run at this bin count
    and dim on ``device``. The reference's limit is the TPU's VMEM budget;
    the card's kernel keeps its state in registers, so its limits are a
    positive bin count and, on a CUDA device, the dims it is built for (the
    plain version on the CPU takes any dim). The int8 (``use_scales``)
    scan is not ported yet. ``use_mask`` costs the card nothing extra."""
    del use_mask
    if use_scales:
        raise ValueError("the int8 fused scan (quantized serving) is not "
                         "ported yet")
    if bins < 1:
        raise ValueError(f"num_bins must be positive, got {bins}")
    if (device is not None and torch.device(device).type == "cuda"
            and dim not in SUPPORTED_DIMS):
        raise ValueError(f"the fused scan kernel supports dims "
                         f"{SUPPORTED_DIMS}, not {dim}")


def pack_catalog(items: torch.Tensor, num_bins: int = 4096) -> torch.Tensor:
    """(M, D) rows -> the scan layout: (D, Mp) bf16, contiguous, Mp padded
    to a multiple of ``num_bins`` with zero columns. Do it once at index
    build, not per query."""
    L = max(128, pad_to_multiple(num_bins, 128))
    M, D = items.shape
    out = torch.zeros((D, pad_to_multiple(M, L)),
                      dtype=torch.bfloat16, device=items.device)
    out[:, :M] = items.T.to(torch.bfloat16)
    return out


def pad_mask(item_mask: torch.Tensor, padded: int) -> torch.Tensor:
    """An (M,) eligibility mask as the scan's (Mp,) bool mask: the padding
    columns are never eligible. An (Mp,) bool mask comes back as it is."""
    mask = item_mask.to(torch.bool)
    if mask.shape[0] < padded:
        mask = torch.cat([mask, mask.new_zeros(padded - mask.shape[0])])
    return mask


def binned_candidates(
    queries: torch.Tensor,       # (B, D) any float dtype
    items_packed: torch.Tensor,  # (D, Mp) bf16 from pack_catalog
    num_items: int,
    num_bins: int = 4096,
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,   # (M,) or (Mp,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 candidates: (vals (B, 2L) float32, ids (B, 2L) int32).

    Queries are cast to bf16 before the scan, as the reference does. Rows
    at or past ``min(valid_count, num_items)`` and rows the mask excludes
    score -inf. An (M,) mask is padded to Mp on every call; a caller that
    reuses one mask pads it once (``pad_mask``) and passes it as it is."""
    D = queries.shape[1]
    L = max(128, pad_to_multiple(num_bins, 128))
    padded = items_packed.shape[1]
    if items_packed.shape[0] != D or padded % L:
        raise ValueError(
            f"items_packed {tuple(items_packed.shape)} does not match dim "
            f"{D} / num_bins {L}; build it with pack_catalog(items, "
            f"num_bins={L})")
    q = queries.to(torch.bfloat16).contiguous()
    mask = None if item_mask is None else pad_mask(item_mask, padded)
    return fused_scan(q, items_packed, L, valid_bound(num_items, valid_count),
                      mask)


def binned_topk_over_matrix(
    queries: torch.Tensor,   # (B, D) float32
    items: torch.Tensor,     # (M, D) float32 rescore rows
    k: int,
    num_bins: int = 4096,
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,
    items_packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-scan top-k, API-compatible with ``mips.topk_over_matrix``:
    (values (B, k) float32, ids (B, k) int64).

    Pass the long-lived ``items_packed`` scan copy (serving keeps it
    resident); without it the catalog is packed on every call. Selection
    happens at the scan's bf16 precision; the k winners are rescored in
    float32 as an elementwise multiply-sum, which no TF32 setting touches."""
    num_items = items.shape[0]
    k_eff = min(k, num_items)
    # fewer than k/2 bins would guarantee losses; keep 2L >= k
    L = max(num_bins, pad_to_multiple(-(-k_eff // 2), 128))
    if items_packed is None:
        items_packed = pack_catalog(items, num_bins=L)
    vals, ids = binned_candidates(queries, items_packed, num_items,
                                  num_bins=L, valid_count=valid_count,
                                  item_mask=item_mask)
    bvals, sel = topk_lower_index_first(vals, k_eff)
    cand = torch.gather(ids, -1, sel).to(torch.int64)      # (B, k_eff)
    rows = items[cand]                                      # (B, k_eff, D)
    exact = (rows * queries.float()[:, None, :]).sum(-1)
    exact = torch.where(torch.isfinite(bvals), exact, NEG_INF)
    out_vals, order = topk_lower_index_first(exact, k_eff)
    return pad_topk(out_vals, torch.gather(cand, -1, order), k)


def pack_payload(values: torch.Tensor, padded: int) -> torch.Tensor:
    """(M,) per-item int ids -> the scan's (Mp,) int32 payload; padding
    columns hold -2, as the reference pads them (never a context id)."""
    out = torch.full((padded,), -2, dtype=torch.int32, device=values.device)
    out[:values.shape[0]] = values.to(torch.int32)
    return out


def binned_affinity_candidates(
    ctx_embed: torch.Tensor,     # (B, C, D) per-slot context embeddings
    items_packed: torch.Tensor,  # (D, Mp) bf16 from pack_catalog
    item_album: torch.Tensor,    # (M,) album id per catalog row
    item_artist: torch.Tensor,   # (M,)
    album_ctx: torch.Tensor,     # (B, C) membership-boost id sets
    artist_ctx: torch.Tensor,    # (B, C)
    num_items: int,
    num_bins: int = 4096,
    valid_count: Count = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 of the playlist affinity score ``max_c ctx_c . item
    + 0.1 [album in ctx] + 0.1 [artist in ctx]``, fused into the scan:
    (vals (B, 2L) float32, ids (B, 2L) int32). Rows at or past
    ``min(valid_count, num_items)`` score -inf. The context is cast to bf16
    as the reference does. The kernel tiles the queries itself (64 per
    CTA, ragged B allowed), so the reference's ``query_chunk`` and its -1
    padding of context ids have no counterpart here."""
    B, C, D = ctx_embed.shape
    L = max(128, pad_to_multiple(num_bins, 128))
    padded = items_packed.shape[1]
    if items_packed.shape[0] != D or padded % L:
        raise ValueError(
            f"items_packed {tuple(items_packed.shape)} does not match dim "
            f"{D} / num_bins {L}; build it with pack_catalog(items, "
            f"num_bins={L})")
    return fused_affinity(
        ctx_embed.to(torch.bfloat16).contiguous(), items_packed,
        pack_payload(item_album, padded), pack_payload(item_artist, padded),
        album_ctx.to(torch.int32).contiguous(),
        artist_ctx.to(torch.int32).contiguous(), L,
        valid_bound(num_items, valid_count))
