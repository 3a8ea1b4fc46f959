"""Row gather and pooled embedding lookup (counterpart of
``esrecsys_tpu/ops/lookup.py``).

Both entry points run through one kernel,
:mod:`esrecsys_tpu_torch.kernels.gather_pool` (the port of the TPU kernel
``_pool_kernel``): a hand-written CUDA kernel on the card, its plain
PyTorch version on the CPU. Ids are clamped into ``[0, R)`` and slots equal
to ``mask_id`` are skipped. Tables are float32 or bf16; either gives
float32 rows (bf16 rows widened exactly). The backward of the lookup
scatters the gradient into a zero table through
:mod:`esrecsys_tpu_torch.kernels.scatter_add`, as the reference's
``_fused_bwd`` scatters through XLA.
"""

from __future__ import annotations

import torch

from esrecsys_tpu_torch.kernels.gather_pool import gather_pool
from esrecsys_tpu_torch.kernels.scatter_add import scatter_add

_SUPPORTED_POOLS = ("sum", "mean")


class _LookupPool(torch.autograd.Function):
    """``pool_k(table[ids[b, k]])`` with a row-scatter backward."""

    @staticmethod
    def forward(ctx, table, ids, mean, mask_id):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        ctx.mean = mean
        ctx.mask_id = mask_id
        return gather_pool(table.detach(), ids, mean, mask_id)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        R, D = ctx.table_shape
        valid = (ids != ctx.mask_id).to(g.dtype)          # (B, K)
        if ctx.mean:
            denom = valid.sum(-1, keepdim=True).clamp(min=1.0)
            per_row = (g / denom)[:, None, :] * valid[..., None]
        else:
            per_row = g[:, None, :] * valid[..., None]
        dtable = torch.zeros((R, D), dtype=g.dtype, device=g.device)
        # rows the forward read: masked slots add zeros, clamped ids land
        # where the forward's clamp read them
        flat_ids = ids.clamp(0, R - 1).reshape(-1).contiguous()
        scatter_add(dtable, flat_ids, per_row.reshape(-1, D).contiguous())
        return dtable, None, None, None


def fused_lookup_pool(table: torch.Tensor, ids: torch.Tensor,
                      pool: str = "mean", mask_id: int = 0) -> torch.Tensor:
    """Pooled lookup ``pool_k(table[ids[b, k]])`` -> (B, D) float32 of a
    float32 or bf16 table, with ``mask_id`` slots excluded; ``mean``
    divides by ``max(count, 1)``. Differentiable in ``table``."""
    if pool not in _SUPPORTED_POOLS:
        raise ValueError(f"pool must be one of {_SUPPORTED_POOLS}, "
                         f"got {pool!r}")
    ids = ids.to(torch.int32).contiguous()
    return _LookupPool.apply(table, ids, pool == "mean", mask_id)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[ids]`` -> (n, D) float32 (a bf16 table's rows
    widened exactly): the K=1, ``mask_id=-1`` case of the pooled lookup,
    so an id of -1 gives a zero row and other ids are clamped into
    ``[0, R)``. Differentiable in ``table``."""
    return fused_lookup_pool(table, ids.reshape(-1, 1), "sum", -1)
