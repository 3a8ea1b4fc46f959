"""Negative sampling on the device (counterpart of
``esrecsys_tpu/ops/negatives.py``).

The reference draws from a JAX key folded per step; the port draws from a
``torch.Generator`` the caller owns and seeds. The two give different ids
from the same seed, so the train step also takes injected ids (tests feed
it the ids JAX drew).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def sample_negative_ids(generator: torch.Generator, num_negatives: int,
                        corpus_size: int, batch_size: Optional[int] = None,
                        exact_range: bool = False) -> torch.Tensor:
    """Uniform int32 corpus indices on the generator's device:
    ``(num_negatives,)`` for a shared per-step pool, ``(batch_size,
    num_negatives)`` for per-example negatives. The range is
    ``[0, corpus_size)``, or the reference's ``[0, corpus_size - 1)`` with
    ``exact_range``."""
    shape = ((num_negatives,) if batch_size is None
             else (batch_size, num_negatives))
    hi = corpus_size - 1 if exact_range else corpus_size
    return torch.randint(0, hi, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def sample_negative_rows(generator: torch.Generator, num_negatives: int,
                         corpora: Sequence[torch.Tensor],
                         batch_size: Optional[int] = None,
                         exact_range: bool = False
                         ) -> Tuple[torch.Tensor, ...]:
    """Sample one index set and take the same entries of several parallel
    corpus arrays (tracks/albums/artists): ``(ids, *rows)``."""
    idx = sample_negative_ids(generator, num_negatives, corpora[0].shape[0],
                              batch_size, exact_range=exact_range)
    return (idx,) + tuple(c[idx.long()] for c in corpora)
