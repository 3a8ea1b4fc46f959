"""Exact maximum-inner-product search (counterpart of
``esrecsys_tpu/retrieval/mips.py`` ``topk_over_matrix``).

The reference streams the catalog with a group-max prefilter because
``lax.top_k`` costs about a nanosecond per element on the TPU. The port
streams full-precision ``torch.matmul`` blocks into ``torch.topk`` instead;
both return the exact top-k by float32 score. Only the order among EXACTLY
equal scores can differ: the port orders equal scores by ascending item
id, as ``lax.top_k`` does, while the reference's prefilter ranks them by
group. This path is the quality yardstick of every approximate mode.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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
