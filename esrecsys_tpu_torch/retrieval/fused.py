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

Quantized serving scans an int8 copy instead (:func:`pack_catalog_int8`,
``item_scales``): D code bytes and a float32 scale per item, half the bf16
copy's bytes; the k winners are rescored from float32 rows, or from the
int8 rows dequantized (``rescore_scales``).

:func:`sharded_fused_topk_over_matrix` is the catalog-sharded form: each
rank scans its own (D, rps) slice, rescores its own rows and joins the
shards' exchange (``mips.exchange_topk``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.kernels.fused_affinity import fused_affinity
from esrecsys_tpu_torch.kernels.fused_scan import fused_scan, fused_scan_int8
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, Count,
                                               exchange_topk, pad_topk,
                                               quantize_rows, shard_bound,
                                               topk_lower_index_first,
                                               valid_bound)


def validate_fused_bins(bins: int, dim: int, use_mask: bool = False,
                        use_scales: bool = False,
                        device: Optional[torch.device] = None) -> None:
    """Raise ValueError when the fused scan cannot run at this bin count
    and dim. The reference's limit is the TPU's VMEM budget; the card's
    kernels keep their state in registers and stream the catalog through
    shared memory in chunks of depth rows, so no budget grows with the dim
    and the limits are a positive bin count and a positive dim: the tuned
    kernels run their dims (``kernels.fused_scan.SUPPORTED_DIMS``) and the
    generic one every other (``kernels.fused_scan.variant``), for the bf16
    and the int8 (``use_scales``) catalog alike, and the plain version on
    the CPU takes any dim. The limits are the same with and without a mask
    and on every ``device``, so ``use_mask`` and ``device`` are taken from
    the callers and not read."""
    del use_mask, use_scales, device
    if bins < 1:
        raise ValueError(f"num_bins must be positive, got {bins}")
    if dim < 1:
        raise ValueError(f"the fused scan needs a positive dim, got {dim}")


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


def pack_catalog_codes(q_items: torch.Tensor, scales: torch.Tensor,
                       num_bins: int = 4096
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized (M, D) int8 rows and their (M,) scales (``quantize_rows``
    or its numpy twin) -> the int8 scan layout: (codes (D, Mp) int8,
    transposed as :func:`pack_catalog` lays out the bf16 copy; scales
    (Mp,) float32). The reference blocks the scales as (ceil8(Mp/L), L)
    rows for the TPU's tiling; the flat vector is that array's row-major
    prefix. Padding columns hold code 0 and scale 0."""
    L = max(128, pad_to_multiple(num_bins, 128))
    M, D = q_items.shape
    padded = pad_to_multiple(M, L)
    codes = torch.zeros((D, padded), dtype=torch.int8, device=q_items.device)
    codes[:, :M] = q_items.T.to(torch.int8)
    flat = torch.zeros(padded, dtype=torch.float32, device=scales.device)
    flat[:M] = scales.float()
    return codes, flat


def pack_catalog_int8(items: torch.Tensor, num_bins: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) float rows -> the int8 scan layout: quantize per item
    (:func:`~esrecsys_tpu_torch.retrieval.mips.quantize_rows`), then
    :func:`pack_catalog_codes`."""
    q, sc = quantize_rows(items)
    return pack_catalog_codes(q, sc, num_bins=num_bins)


def pad_mask(item_mask: torch.Tensor, padded: int) -> torch.Tensor:
    """An (M,) eligibility mask as the scan's (Mp,) bool mask: the padding
    columns are never eligible. An (Mp,) bool mask comes back as it is."""
    mask = item_mask.to(torch.bool)
    if mask.shape[0] < padded:
        mask = torch.cat([mask, mask.new_zeros(padded - mask.shape[0])])
    return mask


def binned_candidates(
    queries: torch.Tensor,       # (B, D) any float dtype
    items_packed: torch.Tensor,  # (D, Mp): bf16 from pack_catalog, or int8
                                 # from pack_catalog_int8 (+ item_scales)
    num_items: int,
    num_bins: int = 4096,
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,   # (M,) or (Mp,) bool
    item_scales: Optional[torch.Tensor] = None,  # (Mp,) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin top-2 candidates: (vals (B, 2L) float32, ids (B, 2L) int32).

    Queries are cast to bf16 before the scan, as the reference does. Rows
    at or past ``min(valid_count, num_items)`` and rows the mask excludes
    score -inf. An (M,) mask is padded to Mp on every call; a caller that
    reuses one mask pads it once (``pad_mask``) and passes it as it is.
    ``item_scales`` (from :func:`pack_catalog_codes`) selects the int8
    scan; ``items_packed`` must then hold int8 codes."""
    D = queries.shape[1]
    L = max(128, pad_to_multiple(num_bins, 128))
    padded = items_packed.shape[1]
    if items_packed.shape[0] != D or padded % L:
        raise ValueError(
            f"items_packed {tuple(items_packed.shape)} does not match dim "
            f"{D} / num_bins {L}; build it with pack_catalog(items, "
            f"num_bins={L})")
    if item_scales is not None:
        if items_packed.dtype != torch.int8:
            raise ValueError("item_scales selects the int8 scan: pack the "
                             "catalog with pack_catalog_int8/_codes")
        if tuple(item_scales.shape) != (padded,):
            raise ValueError(
                f"item_scales {tuple(item_scales.shape)} != ({padded},); "
                f"build with pack_catalog_codes(..., num_bins={L})")
    elif items_packed.dtype == torch.int8:
        raise ValueError("an int8 scan copy needs its item_scales (from "
                         "pack_catalog_codes)")
    q = queries.to(torch.bfloat16).contiguous()
    mask = None if item_mask is None else pad_mask(item_mask, padded)
    bound = valid_bound(num_items, valid_count)
    if item_scales is not None:
        return fused_scan_int8(q, items_packed, item_scales, L, bound, mask)
    return fused_scan(q, items_packed, L, bound, mask)


def binned_topk_over_matrix(
    queries: torch.Tensor,   # (B, D) float32
    items: torch.Tensor,     # (M, D) rescore rows: float32, or int8 with
                             # rescore_scales (no float32 catalog)
    k: int,
    num_bins: int = 4096,
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,
    items_packed: Optional[torch.Tensor] = None,
    item_scales: Optional[torch.Tensor] = None,
    rescore_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-scan top-k, API-compatible with ``mips.topk_over_matrix``:
    (values (B, k) float32, ids (B, k) int64).

    Pass the long-lived ``items_packed`` scan copy (serving keeps it
    resident); without it the catalog is packed on every call. With
    ``item_scales`` it is the int8 copy of :func:`pack_catalog_int8`.
    Selection happens at the scan's bf16 precision; the k winners are
    rescored in float32 as an elementwise multiply-sum, which no TF32
    setting touches. With ``rescore_scales``, ``items`` holds int8 rows
    that are dequantized per candidate (int8 -> float32 x scale)."""
    if items.dtype == torch.int8 and rescore_scales is None:
        raise ValueError(
            "items is int8 but rescore_scales is missing: the rescore "
            "would score raw codes, wrongly scaled; pass the per-item "
            "scales from mips.quantize_rows")
    if rescore_scales is not None and items.dtype != torch.int8:
        raise ValueError(
            "rescore_scales given but items is not int8: the rescore "
            "dequantizes int8 rows (mips rescore_int8)")
    num_items = items.shape[0]
    k_eff = min(k, num_items)
    # fewer than k/2 bins would guarantee losses; keep 2L >= k
    L = max(num_bins, pad_to_multiple(-(-k_eff // 2), 128))
    if items_packed is None:
        items_packed = pack_catalog(items, num_bins=L)
    vals, ids = binned_candidates(queries, items_packed, num_items,
                                  num_bins=L, valid_count=valid_count,
                                  item_mask=item_mask,
                                  item_scales=item_scales)
    bvals, sel = topk_lower_index_first(vals, k_eff)
    cand = torch.gather(ids, -1, sel).to(torch.int64)      # (B, k_eff)
    rows = items[cand]                                      # (B, k_eff, D)
    if rescore_scales is not None:
        rows = rows.float() * rescore_scales[cand][..., None]
    exact = (rows * queries.float()[:, None, :]).sum(-1)
    exact = torch.where(torch.isfinite(bvals), exact, NEG_INF)
    out_vals, order = topk_lower_index_first(exact, k_eff)
    return pad_topk(out_vals, torch.gather(cand, -1, order), k)


def sharded_fused_topk_over_matrix(
    queries: torch.Tensor,       # (B, D) float32, the same on every shard
    items: torch.Tensor,         # (rps, D) float32 rescore rows: this rank's
    items_packed: torch.Tensor,  # (D, rps) bf16 scan copy of the same rows
    k: int,
    mesh,
    num_bins: int = 4096,
    valid_items: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Catalog-sharded fused scan+select (the reference's
    ``sharded_fused_topk_over_matrix``): each rank runs the fused scan
    over its own (D, rps) slice (``rps`` a whole number of ``L``-wide bin
    blocks: pad the catalog to ``n_model * L`` rows before cutting it,
    what the reference's ``pack_catalog(..., shards=n)`` means) with the
    valid bound of its rows, takes a local top-k of the per-bin
    candidates, rescores them exactly from its float32 rows (an
    elementwise multiply-sum in float32, which no TF32 setting touches:
    the reference's ``Precision.HIGHEST``), and joins
    ``mips.exchange_topk``. Padding rows never return. Returns (values
    (B, k), global ids (B, k) int64)."""
    L = max(128, pad_to_multiple(num_bins, 128))
    rps = items_packed.shape[1]
    if rps % L or items.shape[0] != rps:
        raise ValueError(
            f"a shard's scan copy {tuple(items_packed.shape)} and rows "
            f"{tuple(items.shape)} must hold the same whole {L}-wide bin "
            "blocks; pad the catalog to n_model * num_bins rows first")
    base, bound = shard_bound(valid_items, rps, mesh)
    k_local = min(k, rps)
    vals, ids = binned_candidates(queries, items_packed, rps, num_bins=L,
                                  valid_count=bound)
    bvals, sel = topk_lower_index_first(vals, k_local)
    cand = torch.gather(ids, -1, sel).to(torch.int64)      # local rows
    rows = items[cand]
    exact = (rows * queries.float()[:, None, :]).sum(-1)
    exact = torch.where(torch.isfinite(bvals), exact, NEG_INF)
    v, order = topk_lower_index_first(exact, k_local)
    return exchange_topk(v, torch.gather(cand, -1, order) + base, k, mesh)


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
