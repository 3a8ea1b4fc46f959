"""Row scatter-add (counterpart of ``esrecsys_tpu/ops/scatter.py``
``scatter_add_rows``).

Runs through :mod:`esrecsys_tpu_torch.kernels.scatter_add` (the port of the
TPU kernel ``_kernel``): a hand-written CUDA kernel on the card, its plain
PyTorch version on the CPU. The reference's ``precision`` passes
(``bf16``/``bf16x2``/``f32``) are a trick of the TPU's matrix unit and are
not ported: the port is float32 throughout and takes no ``precision``.
"""

from __future__ import annotations

import torch

from esrecsys_tpu_torch.kernels.scatter_add import scatter_add


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     updates: torch.Tensor) -> torch.Tensor:
    """``table.at[ids].add(updates)``: unsorted ids, duplicates summed,
    float32. Updates ``table`` IN PLACE (it saves a table-sized copy per
    call) and returns it; ids outside ``[0, R)`` are dropped."""
    return scatter_add(table, ids.to(torch.int32).contiguous(),
                       updates.contiguous())
