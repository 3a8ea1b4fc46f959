"""Ranking metrics over rank-ordered retrieval hit masks (counterpart of
``esrecsys_tpu/ops/metrics.py``)."""

from __future__ import annotations

from typing import Dict

import torch


def ranking_metrics(hit: torch.Tensor, denom: torch.Tensor, k: int,
                    prefix: str, ndcg: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Recall@k, MRR@k and (optionally) NDCG@k from a rank-ordered (B, k)
    hit mask. ``denom`` is the relevant-set size, clamped >= 1 by callers;
    padded or invalid ranks must already be False."""
    hit = hit.float()
    any_hit = hit.amax(-1)
    first = hit.argmax(-1).float()  # 0 when no hit
    out = {
        f"{prefix}_recall": (hit.sum(-1) / denom).mean(),
        f"{prefix}_mrr": (any_hit / (first + 1.0)).mean(),
    }
    if ndcg:
        ranks = torch.arange(k, dtype=torch.float32, device=hit.device)
        discounts = 1.0 / torch.log2(ranks + 2.0)
        dcg = (hit * discounts).sum(-1)
        # ideal DCG: the first min(|relevant|, k) slots all hit
        ideal_cum = torch.cat([discounts.new_zeros(1),
                               torch.cumsum(discounts, 0)])
        n_rel = denom.clamp(1.0, float(k)).long()
        out[f"{prefix}_ndcg"] = (dcg / ideal_cum[n_rel]).mean()
    return out
