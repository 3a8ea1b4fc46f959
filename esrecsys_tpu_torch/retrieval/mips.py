"""Maximum-inner-product search (counterpart of
``esrecsys_tpu/retrieval/mips.py``: the exact ``topk_over_matrix``, the
streaming ``chunked_topk`` / ``chunked_grouped_topk`` of the eval, and the
int8 scan of quantized serving, ``quantize_rows`` and
``quantized_topk_over_matrix``).

The reference streams the catalog with a group-max prefilter because
``lax.top_k`` costs about a nanosecond per element on the TPU. The port
streams full-precision ``torch.matmul`` blocks into ``torch.topk`` instead;
both return the exact top-k by float32 score. Only the order among EXACTLY
equal scores can differ: the port orders equal scores by ascending item
id, as ``lax.top_k`` does, while the reference's prefilter ranks them by
group. This path is the quality yardstick of every approximate mode.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple

NEG_INF = float("-inf")

Count = Optional[Union[int, torch.Tensor]]


def require_full_f32(t: torch.Tensor) -> None:
    """Raise when a float32 matmul on ``t``'s device would run in TF32,
    which keeps about three decimal digits. The reference pins these
    products at ``Precision.HIGHEST``."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: exact MIPS needs "
            "full float32 products; set it to False")


def topk_lower_index_first(vals: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties toward the
    lower index. ``torch.topk`` promises no tie order, so this sorts
    stably."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def top_ids_lower_index_first(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the k largest of ``vals`` (..., n) float32 over the last
    axis, in :func:`topk_lower_index_first`'s order, from one
    ``torch.topk`` over int64 keys: the float's order-preserving integer
    image in the high 32 bits (-0.0 counted as +0.0), the reversed index
    in the low 32. On a 262,144-wide block a stable sort costs far more;
    on the few thousand candidates of a rescore the sort is cheaper (a
    ``torch.topk`` with k=500 of 8,192 sorts as well, then gathers)."""
    if vals.dtype != torch.float32:
        raise TypeError(f"expected float32 scores, got {vals.dtype}")
    bits = (vals + 0.0).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    idx = torch.arange(vals.shape[-1], device=vals.device)
    key = ordered * (1 << 32) + (0xFFFFFFFF - idx)
    top = torch.topk(key, k, dim=-1).values
    return 0xFFFFFFFF - (top & 0xFFFFFFFF)


def pad_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the ids of ``-inf`` slots and pad both to width ``k`` with
    (-inf, 0), the reference's contract when k exceeds what is eligible."""
    idxs = torch.where(torch.isfinite(vals), idxs, 0)
    short = k - vals.shape[-1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, short), value=0)
    return vals, idxs


def valid_bound(num_items: int, valid_count: Count) -> int:
    """Rows below the returned bound are real; the rest score -inf."""
    if valid_count is None:
        return num_items
    return max(0, min(int(valid_count), num_items))


def topk_over_matrix(
    queries: torch.Tensor,   # (B, D) float32
    items: torch.Tensor,     # (M, D) float32
    k: int,
    block_size: int = 262_144,
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,   # (M,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dot-product top-k: (values (B, k) float32, ids (B, k) int64),
    sorted descending, equal scores by ascending id.

    Rows at or past ``valid_count`` and rows where ``item_mask`` is False
    score -inf. When fewer than k rows are eligible the tail is -inf with
    id 0."""
    require_full_f32(items)
    B = queries.shape[0]
    num_items = items.shape[0]
    k_eff = min(k, num_items)
    bound = valid_bound(num_items, valid_count)
    vals = queries.new_empty((B, 0))
    idxs = torch.empty((B, 0), dtype=torch.int64, device=queries.device)
    for start in range(0, bound, block_size):
        stop = min(start + block_size, bound)
        s = queries @ items[start:stop].T
        if item_mask is not None:
            s = s.masked_fill(~item_mask[start:stop], NEG_INF)
        ids = torch.arange(start, stop, device=queries.device).expand(B, -1)
        vals = torch.cat([vals, s], dim=-1)
        idxs = torch.cat([idxs, ids], dim=-1)
        vals, sel = torch.topk(vals, min(k_eff, vals.shape[-1]), dim=-1)
        idxs = torch.gather(idxs, -1, sel)
    # canonical order: ascending id first, then a stable sort by value
    order = torch.argsort(idxs, dim=-1, stable=True)
    vals, idxs = torch.gather(vals, -1, order), torch.gather(idxs, -1, order)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return pad_topk(vals, torch.gather(idxs, -1, order), k)


def chunked_topk(
    score_block_fn: Callable[[int], torch.Tensor],
    num_items: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over a virtual (B, num_items) score matrix:
    ``score_block_fn(start)`` gives the (B, S) scores of items
    ``[start, start + S)`` (the caller pads its catalog so every block is
    full; rows at or past ``num_items`` are masked to -inf here). Returns (values (B, k), ids (B, k) int64), sorted
    descending with equal scores by ascending id as ``lax.top_k`` orders
    them; a k past the catalog pads with (-inf, 0)."""
    k_eff = min(k, num_items)
    vals = idxs = None
    start = 0
    while start < num_items:
        scores = score_block_fn(start)
        width = scores.shape[-1]
        item = start + torch.arange(width, device=scores.device)
        scores = torch.where(item < num_items, scores, NEG_INF)
        if vals is None:
            vals = scores.new_full(scores.shape[:-1] + (k_eff,), NEG_INF)
            idxs = torch.zeros(vals.shape, dtype=torch.int64,
                               device=scores.device)
        vals, sel = topk_lower_index_first(
            torch.cat([vals, scores], dim=-1), k_eff)
        idxs = torch.gather(torch.cat([idxs, item.expand_as(scores)], -1),
                            -1, sel)
        start += width
    return pad_topk(vals, idxs, k)


def chunked_grouped_topk(
    score_block_fn: Callable[[int], torch.Tensor],
    score_items_fn: Callable[[torch.Tensor], torch.Tensor],
    num_items: int,
    k: int,
    group: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact streaming top-k with a group-max prefilter (the reference's
    ``chunked_grouped_topk``): phase 1 keeps the top-k groups of
    ``group`` consecutive items by group max, phase 2 rescores their
    members with ``score_items_fn`` ((B, n) item ids -> (B, n) scores) and
    takes the final top-k. Any group holding a true top-k item has a
    group max at least that item's score, so the k best groups cover the
    top k when both phases score alike. Returns (values (B, k), ids
    (B, k) int64) as :func:`chunked_topk`."""
    gvals = gidxs = None
    start = 0
    while start < num_items:
        scores = score_block_fn(start)
        width = scores.shape[-1]
        if width % group:
            raise ValueError(f"block width {width} not divisible by group "
                             f"{group}")
        item = start + torch.arange(width, device=scores.device)
        scores = torch.where(item < num_items, scores, NEG_INF)
        gmax = scores.reshape(scores.shape[:-1] + (width // group, group)
                              ).amax(-1)
        gid = (start // group) + torch.arange(width // group,
                                              device=scores.device)
        if gvals is None:
            num_groups = -(-num_items // width) * (width // group)
            kg = min(k, num_groups)
            gvals = gmax.new_full(gmax.shape[:-1] + (kg,), NEG_INF)
            # distinct out-of-range group ids: a -inf init slot that
            # survives masks out in the rescore instead of repeating group 0
            gidxs = (num_groups + torch.arange(kg, device=scores.device)
                     ).expand_as(gvals)
        gvals, sel = topk_lower_index_first(torch.cat([gvals, gmax], -1), kg)
        gidxs = torch.gather(torch.cat([gidxs, gid.expand_as(gmax)], -1),
                             -1, sel)
        start += width
    cand = (gidxs[..., :, None] * group
            + torch.arange(group, device=gidxs.device))
    cand = cand.reshape(cand.shape[:-2] + (-1,))
    cand_scores = score_items_fn(cand.clamp(max=num_items - 1))
    cand_scores = torch.where(cand < num_items, cand_scores, NEG_INF)
    vals, sel = topk_lower_index_first(cand_scores, min(k, num_items))
    return pad_topk(vals, torch.gather(cand, -1, sel), k)


_INV127 = 1.0 / 127.0  # rounded to float32 once, as the reference does
OVERSAMPLE = 4  # int8 candidates kept per wanted item (the reference's)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization, ``x ~ q * scale[:, None]``:
    (q int8 (..., D), scale float32 (...)), bit-identical to the
    reference. ``scale = max(max|row|, 1e-30) * float32(1/127)`` (the
    clamp keeps all-zero rows at zero codes), the quotient rounded half to
    even and clipped to +-127."""
    x = x.float()
    inv = torch.tensor(_INV127, dtype=torch.float32, device=x.device)
    scale = x.abs().amax(dim=-1).clamp_min(1e-30) * inv
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows_np(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`quantize_rows`, bit-identical to it: serving's
    ``rescore_int8`` quantizes on the host so that no float32 catalog ever
    reaches the device."""
    x = np.asarray(x, np.float32)
    scale = (np.maximum(np.max(np.abs(x), axis=-1), np.float32(1e-30))
             * np.float32(_INV127))
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def int8_dot(qq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 scores ``qq @ codes.T`` of (B, D) and (n, D) int8.

    ``torch._int_mm`` sums int8 products in int32, exactly. A float32
    product of the int8 values would be exact too (|sum| <= D * 127^2 <
    2^24 for D <= 1040, under any TF32 setting), but moves four times the
    bytes; a bf16 product is exact only when the caller turns off
    ``allow_bf16_reduced_precision_reduction``, a global flag. On the card
    ``_int_mm`` needs more than 16 rows (the queries are padded to 32) and
    D a multiple of 8, and cuBLASLt refused a codes count that was a
    multiple of 8 but not of 16 (the codes are padded to whole rows of
    128)."""
    B, n = qq.shape[0], codes.shape[0]
    rows, cols = pad_to_multiple(max(B, 17), 16), pad_to_multiple(n, 128)
    if rows != B:
        qq = torch.nn.functional.pad(qq, (0, 0, 0, rows - B))
    if cols != n:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, cols - n))
    return torch._int_mm(qq.contiguous(), codes.T)[:B, :n]


def quantized_topk_over_matrix(
    queries: torch.Tensor,        # (B, D) float
    q_items: torch.Tensor,        # (M, D) int8 (quantize_rows output)
    item_scales: torch.Tensor,    # (M,) float32
    rescore_items: torch.Tensor,  # (M, D) float32 catalog, or int8 rows
    k: int,
    block_size: int = 262_144,
    select: str = "exact",
    rescore_scales: Optional[torch.Tensor] = None,  # (M,): int8 rescore
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,       # (M,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k that scans the catalog in int8, with a float32
    rescore of the candidates: (values (B, k) float32, ids (B, k) int64).

    Phase 1: the query is quantized and its scale dropped (a positive
    constant per query cannot change that query's ranking); each block's
    scores are the exact int32 dot of the int8 codes times the per-item
    float32 scale, rows at or past the valid bound and rows the mask
    excludes at -inf before the block's top-``kb`` (ties to the lower
    index). About ``OVERSAMPLE * k`` candidates are kept in all; block and
    ``kb`` are the reference's. Phase 2 rescores them against the
    unquantized query in float32: from ``rescore_items`` (float32), or,
    with ``rescore_scales``, from the int8 rows dequantized (no float32
    catalog anywhere), the mask guarding the rescore so a masked candidate
    cannot re-enter with its real dot; ids of -inf slots are 0.
    ``select="approx"`` is the reference's ``approx_max_k`` selection and
    is not ported yet."""
    if select == "approx":
        raise NotImplementedError(
            "select='approx' (approx_max_k candidate selection) is not "
            "ported yet; the port selects exactly")
    if select != "exact":
        raise ValueError(f"select must be 'exact' or 'approx', got {select!r}")
    num_items = q_items.shape[0]
    block = min(block_size, pad_to_multiple(num_items, 128))
    nblk = -(-num_items // block)
    kb = min(block, max(-(-OVERSAMPLE * k // nblk), 1))
    bound = valid_bound(num_items, valid_count)
    qq, _ = quantize_rows(queries)
    cands = []
    for b in range(nblk):
        start, stop = b * block, min((b + 1) * block, num_items)
        s = int8_dot(qq, q_items[start:stop]).float() * item_scales[start:stop]
        ok = start + torch.arange(stop - start, device=s.device) < bound
        if item_mask is not None:
            ok = ok & item_mask[start:stop]
        s = torch.where(ok, s, NEG_INF)
        if stop - start < block:  # the reference pads the last block
            s = torch.nn.functional.pad(s, (0, block - (stop - start)),
                                        value=NEG_INF)
        cands.append(top_ids_lower_index_first(s, kb) + start)
    cand = torch.cat(cands, dim=-1)                      # (B, nblk * kb)
    safe = cand.clamp(max=num_items - 1)
    rows = rescore_items[safe]                           # (B, n, D)
    if rescore_scales is not None:
        rows = rows.float() * rescore_scales[safe][..., None]
    # an elementwise float32 multiply-sum: no TF32 setting touches it
    cs = (rows * queries.float()[:, None, :]).sum(-1)
    ok = cand < bound
    if item_mask is not None:
        ok = ok & item_mask[safe]
    cs = torch.where(ok, cs, NEG_INF)
    vals, sel = topk_lower_index_first(cs, min(k, nblk * kb))
    return pad_topk(vals, torch.gather(cand, -1, sel), k)
