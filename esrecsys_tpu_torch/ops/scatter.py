"""Row scatter-add (counterpart of ``esrecsys_tpu/ops/scatter.py``
``scatter_add_rows`` and ``vmem_scatter_add_phys``).

``scatter_add_rows`` runs through :mod:`esrecsys_tpu_torch.kernels.scatter_add`
(the port of the TPU kernel ``_kernel``), ``vmem_scatter_add`` through
:mod:`esrecsys_tpu_torch.kernels.smem_scatter` (the port of
``_vmem_scatter_kernel``): hand-written CUDA kernels on the card, their
plain PyTorch versions on the CPU. The reference's ``precision`` passes
(``bf16``/``bf16x2``/``f32``) are a trick of the TPU's matrix unit and are
not ported: the port takes no ``precision``.
"""

from __future__ import annotations

import torch

from esrecsys_tpu_torch.kernels.scatter_add import scatter_add
from esrecsys_tpu_torch.kernels.smem_scatter import smem_scatter


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """``table.at[ids].add(updates.astype(table.dtype))``: unsorted ids,
    duplicates summed, float32 updates into a float32 or bf16 table (a
    bf16 table adds each update rounded to bf16). Updates ``table`` IN
    PLACE (it saves a table-sized copy per call) and returns it; ids
    outside ``[0, R)`` are dropped."""
    return scatter_add(table, ids.to(torch.int32).contiguous(),
                       updates.contiguous())


def vmem_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """``table.at[ids].add(updates)`` through per-SM sums in on-chip
    memory, the table cut by row range over one wave of CTAs (the
    reference's ``vmem_scatter_add_phys``, on the logical (R, D) float32
    table rather than its 128-lane packed form).
    Updates ``table`` IN PLACE and returns it; ids outside ``[0, R)`` are
    dropped. Raises ValueError naming the shared memory when the table
    does not fit the card's (the flagship album table fits, the artist
    table does not)."""
    return smem_scatter(table, ids.to(torch.int32).contiguous(),
                        updates.contiguous())
