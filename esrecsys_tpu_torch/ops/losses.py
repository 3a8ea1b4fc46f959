"""Losses (counterpart of ``esrecsys_tpu/ops/losses.py``): GloVe's
weighted squared error, the triplet hinges, the self-affinity terms, the
norm caps, txt2url's margin loss and the in-batch sampled softmax."""

from __future__ import annotations

from typing import Optional

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as the reference's ``jnp.maximum(x, 0)``: where
    x == 0 the gradient splits in half between the two arguments, so x
    receives 0.5 (``torch.relu`` would give it 0)."""
    return torch.maximum(x, x.new_zeros(()))


def glove_weight(count: torch.Tensor, x_max: float = 100.0,
                 alpha: float = 0.75) -> torch.Tensor:
    """GloVe's weight ``min(1, count / x_max) ** alpha``."""
    return torch.pow(torch.minimum(torch.ones_like(count), count / x_max),
                     alpha)


def glove_target(count: torch.Tensor) -> torch.Tensor:
    """``log10(1 + count)``: base 10, not e."""
    return torch.log10(1.0 + count)


def glove_loss(predicted: torch.Tensor, count: torch.Tensor,
               x_max: float = 100.0, alpha: float = 0.75) -> torch.Tensor:
    """Weighted squared error against the log co-occurrence, mean over the
    batch."""
    w = glove_weight(count, x_max, alpha)
    err = glove_target(count) - predicted
    return torch.mean(torch.square(err) * w)


# ---------------------------------------------------------------- triplets

def triplet_hinge_sum(pos_score, neg_score, margin: float = 1.0):
    """``sum(relu(margin + neg - pos))``."""
    return torch.sum(relu(margin + neg_score - pos_score))


def mean_triplet(pos_affinity, neg_affinity, margin: float = 1.0):
    """``relu(margin + mean(neg) - mean(pos))``."""
    return relu(margin + torch.mean(neg_affinity) - torch.mean(pos_affinity))


def extremal_triplet(pos_affinity, neg_affinity, margin: float = 1.0):
    """``relu(margin + max(neg) - min(pos))``; tied extremes share the
    gradient equally, as ``jnp.max``'s do."""
    return relu(margin + torch.amax(neg_affinity) - torch.amin(pos_affinity))


def self_affinity_floor(affinity, floor: float = 0.5):
    """``mean(relu(floor - affinity))``: pulls self-affinity above
    ``floor``."""
    return torch.mean(relu(floor - affinity))


def self_affinity_ceiling(affinity):
    """``mean(relu(affinity))``: pushes a negative group's self-affinity
    below 0."""
    return torch.mean(relu(affinity))


# ---------------------------------------------------------------- norm caps

def norm_cap(l2_norms, cap: float):
    """``sum(relu(norm - cap))`` over precomputed L2 norms."""
    return torch.sum(relu(l2_norms - cap))


def embedding_norm_cap(embeddings, cap: float = 1.0):
    """Sum over rows of ``relu(||row||_2 - cap)``."""
    norms = torch.sqrt(torch.sum(torch.square(embeddings), dim=-1))
    return torch.sum(relu(norms - cap))


# ---------------------------------------------------------------- txt2url

def margin_square_loss(score, margin: float = 1.0):
    """``mean(square(relu(margin - score)))``: pushes a matching dot above
    the margin."""
    return torch.mean(torch.square(relu(margin - score)))


def in_batch_softmax(query: torch.Tensor, item: torch.Tensor,
                     log_q: Optional[torch.Tensor] = None,
                     temperature: float = 1.0) -> torch.Tensor:
    """In-batch sampled softmax: row i of ``query`` (B, D) is the positive
    of row i of ``item`` (B, D), every other row a negative; ``log_q``
    (B,) subtracts each item's log sampling probability from its column.
    The (B, B) logits are a float32 matmul (full float32 on a card:
    callers turn TF32 off, as the reference computes it)."""
    logits = (query @ item.T) / temperature
    if log_q is not None:
        logits = logits - log_q[None, :]
    logz = torch.logsumexp(logits, dim=-1)
    return torch.mean(logz - torch.diagonal(logits))
