"""Exact maximum-inner-product search (counterpart of
``esrecsys_tpu/retrieval/mips.py``: ``topk_over_matrix`` and the
streaming ``chunked_topk`` / ``chunked_grouped_topk`` of the eval).

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

import torch

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
