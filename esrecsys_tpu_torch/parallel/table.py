"""Row-sharded embedding tables over the ``model`` axis (counterpart of
``esrecsys_tpu/parallel/table.py``).

A table's rows are padded to a multiple of the model axis and each rank of
a data row holds one contiguous block of them (:meth:`Mesh.row_range`).
Lookups are owner-computes: every shard gathers the ids it owns (local
ids, -1 elsewhere, through the port's row-gather kernel on a card, which
reads a zero row for -1) and the partial rows are summed over the data
row's ranks. Exactly one shard contributes each row, so the sum adds
zeros and the rows are exact. The backward is the mirrored masked
scatter-add (the scatter-add kernel on a card) into the owning shard's
gradient, summed over the data axis when each data row looked up its own
ids.

The reference has two strategies, which it says give the same numbers:
``shard_map`` (owner-computes with a ``psum`` over ``model``) and ``auto``
(GSPMD's choice, usually an all-gather of the ids, a local gather and a
reduce-scatter of the rows). Both names are accepted here and run the
same code. In the port a rank's ids are already its whole data row's (the
row's ranks gathered their batch slices), so the all-gather of the ids is
the identity, and a reduce-scatter followed by the all-gather that gives
every rank its rows back is the all-reduce that owner-computes issues:
the same sums over the same collective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.ops import guards
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows

STRATEGIES = ("auto", "shard_map")


def shard_rows(table: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a whole (padded) table, as a new tensor; the
    table itself without a mesh."""
    if mesh is None:
        return table
    return table[mesh.row_range(table.shape[0])].clone()


def init_table(num_rows: int, dim: int, mesh: Optional[Mesh] = None,
               scale: Optional[float] = None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """``normal * scale`` (default ``1 / sqrt(dim)``, flax ``nn.Embed``'s
    variance) over ``num_rows`` rows padded to a multiple of the model
    axis, drawn whole from ``generator`` so every mesh shape holds the same
    table; returns this rank's shard."""
    n = mesh.n_model if mesh is not None else 1
    rows = pad_to_multiple(num_rows, n)
    if scale is None:
        scale = 1.0 / math.sqrt(dim)
    table = torch.randn(rows, dim, generator=generator, device=device,
                        dtype=dtype) * scale
    return shard_rows(table, mesh)


class _OwnerLookup(torch.autograd.Function):
    """Owner-computes rows of a row-sharded table, with the masked
    scatter-add backward."""

    @staticmethod
    def forward(ctx, shard, ids, mesh, ids_data_sharded):
        local = mesh.owned(ids.reshape(-1), shard.shape[0])
        ctx.save_for_backward(local)
        ctx.mesh = mesh
        ctx.shape = shard.shape
        ctx.sum_data = ids_data_sharded
        rows = mesh.sum_model(gather_rows(shard.detach(), local))
        return rows.reshape(ids.shape + (shard.shape[1],))

    @staticmethod
    def backward(ctx, g):
        (local,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        scatter_add_rows(grad, local, g.reshape(-1, ctx.shape[1]))
        if ctx.sum_data:  # each data row looked up its own ids
            ctx.mesh.sum_data(grad)
        return grad, None, None, None


def lookup(table: torch.Tensor, ids: torch.Tensor,
           mesh: Optional[Mesh] = None, strategy: str = "auto",
           ids_data_sharded: bool = True) -> torch.Tensor:
    """Rows ``table[ids]`` (..., D) float32 of a table row-sharded over
    ``model``; differentiable in the shard.

    Args:
      table: this rank's shard (the whole table without a mesh).
      ids: int ids of any shape into the whole table; every rank of a data
        row passes the same ids.
      strategy: "auto" or "shard_map" (the same code, see the module).
      ids_data_sharded: each data row passes its own ids (the gradient
        sums over the data axis); False when every rank passes the same
        ids.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    n = mesh.n_model if mesh is not None else 1
    # id-range guard: an id no shard owns would silently read a zero row
    ids = guards.check_ids(ids, table.shape[0] * n, "sharded_table")
    if mesh is None:
        return gather_rows(table, ids.reshape(-1)).reshape(
            ids.shape + (table.shape[1],))
    return _OwnerLookup.apply(table, ids, mesh, ids_data_sharded)


def lookup_pooled(table: torch.Tensor, ids: torch.Tensor, pool: str = "mean",
                  mask_id: Optional[int] = 0, mesh: Optional[Mesh] = None,
                  strategy: str = "auto") -> torch.Tensor:
    """ids (..., K) -> pooled (..., D): :func:`lookup`, then the sum,
    mean or max over K with ``mask_id`` slots left out (an all-masked
    context pools to zeros)."""
    emb = lookup(table, ids, mesh=mesh, strategy=strategy)
    if mask_id is None:
        valid = torch.ones(ids.shape, dtype=emb.dtype, device=emb.device)
    else:
        valid = (ids != mask_id).to(emb.dtype)
    vexp = valid[..., None]
    if pool == "sum":
        return (emb * vexp).sum(-2)
    if pool == "mean":
        denom = valid.sum(-1, keepdim=True).clamp(min=1.0)
        return (emb * vexp).sum(-2) / denom
    if pool == "max":
        neg = torch.finfo(emb.dtype).min
        out = torch.where(vexp > 0, emb, neg).amax(-2)
        any_valid = valid.sum(-1, keepdim=True) > 0
        return torch.where(any_valid, out, torch.zeros_like(out))
    raise ValueError(f"unknown pool {pool!r}")


@dataclasses.dataclass
class ShardedTable:
    """A named row-sharded table and its lookup configuration: the true
    vocabulary size against the padded rows, and the strategy."""

    name: str
    num_rows: int
    dim: int
    strategy: str = "auto"

    def padded_rows(self, mesh: Optional[Mesh]) -> int:
        n = mesh.n_model if mesh is not None else 1
        return pad_to_multiple(self.num_rows, n)

    def init(self, generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None, dtype=torch.float32, device=None):
        return init_table(self.num_rows, self.dim, mesh=mesh, dtype=dtype,
                          generator=generator, device=device)

    def __call__(self, table, ids, mesh: Optional[Mesh] = None):
        return lookup(table, ids, mesh=mesh, strategy=self.strategy)

    def pooled(self, table, ids, pool="mean", mask_id=0, mesh=None):
        return lookup_pooled(table, ids, pool=pool, mask_id=mask_id,
                             mesh=mesh, strategy=self.strategy)
