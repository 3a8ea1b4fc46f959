"""Embedding-table scale run: one large table driven by training-shaped
traffic (counterpart of ``esrecsys_tpu/tools/scale_table.py``).

Each step draws ``ids_per_step`` row ids on the device, gathers the rows
through the row-gather kernel, takes the gradient of ``vdot(tanh(rows),
w)`` with respect to them and updates the table row-sparse: with
``--momentum`` > 0 through the lazy momentum carrier (``ops/optim.py``:
the exact dense SGD-momentum trajectory without a pass over the whole
table), else a scatter-add of ``-lr * grad`` (the scatter-add kernel).
The full width is 100M rows of 32 at 262,144 ids a step with momentum
0.98: the table, a momentum buffer of its dtype and size and an int32
``last_step`` a row on the card. Row offsets pass 2^31 elements there.
``--dtype`` is ``bfloat16`` (the default, as the reference's) or
``float32``; the moments take the table's dtype, as the reference's do.

How it differs from the reference: the table is the logical (R, D) one
(the reference's 128-lane packed layout is a TPU layout trick);
``steps_per_call`` only counts steps (a call is a loop of eager steps);
a ``--dtype`` other than ``float32`` or ``bfloat16`` raises (the gather
and scatter-add kernels take those two).

``--n_model N`` row-shards the table over N ranks (``torchrun
--nproc_per_node N``; more ranks add data rows): every rank draws the
whole table from the seed and keeps its rows, gathers the rows it owns
of each step's ids and sums the parts over its data row
(``parallel/table.py``'s owner-computes), and updates its shard with
every data row's gradients (``ops/optim.py`` ``rows_sharded``); a data
row takes its slice of the step's ids. Too few ranks raise
``ValueError``. Rank 0 prints the line, its rate the whole mesh's and its
peak memory rank 0's after the table's init.

Prints one JSON line: ``table_lookup_update_rows_per_sec`` as ``value``,
``ms_per_step`` (host clock over ``calls * steps_per_call`` steps after one
warm-up call, ending in a device sync), the peak device memory, and the
card's name and power limit.

Run: python -m esrecsys_tpu_torch.tools.scale_table [--rows 100000000]
         [--dtype bfloat16|float32] [--momentum 0.98] [--device cpu]
     torchrun --nproc_per_node 4 -m esrecsys_tpu_torch.tools.scale_table \
         --n_model 4
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable, Optional, Tuple

import torch

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.core.device import (card_line, pad_to_multiple,
                                           resolve_device)
from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.optim import (State, lazy_momentum_update,
                                          momentum_catchup_rows,
                                          momentum_init, sgd_update)
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    rows: int = 100_000_000
    dim: int = 32
    dtype: str = "bfloat16"
    ids_per_step: int = 262_144
    steps_per_call: int = 4
    calls: int = 4
    learning_rate: float = 0.01
    momentum: float = 0.0  # > 0: the lazy momentum carrier
    n_model: int = 1
    seed: int = 0
    device: str = "cuda"


def _check(cfg: ScaleConfig) -> None:
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the gather and scatter-add kernels take "
            "float32 and bf16 tables (--dtype float32 or bfloat16)")


def table_mesh(cfg: ScaleConfig, device: torch.device
               ) -> Tuple[Optional[Mesh], torch.device]:
    """(the mesh, this rank's device): None and ``device`` for one
    process with ``n_model`` 1; under ``torchrun`` or with ``n_model`` > 1
    the grid of every rank, ``n_model`` shards a data row (too few ranks
    raise)."""
    if not (mesh_lib.distributed_init_if_needed(device=device)
            or mesh_lib.is_initialized() or cfg.n_model > 1):
        return None, device
    mesh_lib.check_ranks(cfg.n_model, "scale_table")
    if mesh_lib.is_initialized():
        device = mesh_lib.rank_device(device)
    return mesh_lib.make_mesh(n_model=cfg.n_model), device


def init(cfg: ScaleConfig, device: torch.device, mesh: Optional[Mesh] = None
         ) -> Tuple[torch.Tensor, Optional[State]]:
    """The (rows, dim) table of ``cfg.dtype``, normal / sqrt(dim) from
    ``cfg.seed`` (the reference's ``init_table`` scale, drawn in the
    table's dtype), and the lazy carrier's state in the table's dtype
    (None at momentum 0). With a ``mesh``: the rows padded to the model
    axis, drawn whole, and this rank's shard kept."""
    _check(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    rows = cfg.rows if mesh is None else pad_to_multiple(cfg.rows,
                                                         mesh.n_model)
    table = torch.randn((rows, cfg.dim), generator=gen, device=device,
                        dtype=DTYPES[cfg.dtype])
    table.mul_(1.0 / math.sqrt(cfg.dim))
    if mesh is not None:
        part = mesh.row_range(rows)
        table = table[part.start:part.stop].clone()
    state = (momentum_init(table, lazy=True, dtype=table.dtype)
             if cfg.momentum else None)
    return table, state


def step_ids(cfg: ScaleConfig, step: int, gen: torch.Generator
             ) -> torch.Tensor:
    """The ``ids_per_step`` int32 row ids of ``step``, drawn on the
    generator's device from a seed of (``cfg.seed``, ``step``)."""
    gen.manual_seed((cfg.seed * 1_000_003 + 1) * 1_000_003 + step)
    return torch.randint(0, cfg.rows, (cfg.ids_per_step,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def make_step(cfg: ScaleConfig, table: torch.Tensor,
              state: Optional[State], mesh: Optional[Mesh] = None
              ) -> Callable[[int], torch.Tensor]:
    """(step) -> the step's loss; updates ``table`` (and ``state``) in
    place. On a ``mesh`` ``table`` is this rank's shard, the step's ids
    are split over the data rows, and the loss returned is the whole
    step's (summed over the data rows)."""
    gen = torch.Generator(device=table.device)
    n_data = mesh.n_data if mesh is not None else 1
    per = cfg.ids_per_step // n_data
    if per * n_data != cfg.ids_per_step:
        raise ValueError(f"ids_per_step {cfg.ids_per_step} does not divide "
                         f"over {n_data} data rows")
    w = torch.ones((per, cfg.dim), device=table.device)
    lr, mu = cfg.learning_rate, cfg.momentum

    def rows_of(ids: torch.Tensor, step: int) -> torch.Tensor:
        local = ids if mesh is None else mesh.owned(ids, table.shape[0])
        rows = gather_rows(table, local)
        if mu:
            rows += momentum_catchup_rows(state, local, lr=lr, mu=mu,
                                          step=step)
        return rows if mesh is None else mesh.sum_model(rows)

    def one_step(step: int) -> torch.Tensor:
        ids = step_ids(cfg, step, gen)
        if mesh is not None:
            d = mesh.data_index
            ids = ids[d * per:(d + 1) * per]
        with torch.no_grad():
            rows = rows_of(ids, step)
        rows.requires_grad_()
        loss = torch.vdot(torch.tanh(rows).reshape(-1), w.reshape(-1))
        (g,) = torch.autograd.grad(loss, rows)
        with torch.no_grad():
            if mu:
                lazy_momentum_update(table, state, ids, g, lr=lr, mu=mu,
                                     step=step, rows_sharded=mesh)
            elif mesh is not None:
                sgd_update(table, ids, g, lr=lr, rows_sharded=mesh)
            else:
                scatter_add_rows(table, ids, -lr * g)
        loss = loss.detach()
        return loss if mesh is None else mesh.sum_data(loss)

    return one_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ScaleConfig) -> dict:
    _check(cfg)
    mesh, device = table_mesh(cfg, resolve_device(cfg.device))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    table, state = init(cfg, device, mesh)
    if device.type == "cuda" and mesh is not None:
        torch.cuda.empty_cache()  # the whole draw, freed
        torch.cuda.reset_peak_memory_stats(device)
    one_step = make_step(cfg, table, state, mesh)
    spc = cfg.steps_per_call
    for s in range(spc):  # warm-up call
        loss = one_step(s)
    float(loss)
    t0 = time.perf_counter()
    for s in range(spc, spc * (cfg.calls + 1)):
        loss = one_step(s)
    last = float(loss)
    _sync(device)
    dt = time.perf_counter() - t0
    n_steps = cfg.calls * spc
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return {
        "metric": "table_lookup_update_rows_per_sec",
        "value": n_steps * cfg.ids_per_step / dt,
        "rows": cfg.rows,
        "dim": cfg.dim,
        "dtype": cfg.dtype,
        "table_gb": cfg.rows * cfg.dim * table.element_size() / 1e9,
        "n_model": cfg.n_model,
        "mesh": (None if mesh is None else
                 f"{mesh.n_data}x{mesh.n_model}"),
        "rows_per_shard": table.shape[0],
        "layout": "logical",
        "ids_per_step": cfg.ids_per_step,
        "momentum": cfg.momentum,
        "steps": n_steps,
        "ms_per_step": dt / n_steps * 1e3,
        "last_loss": last,
        "peak_memory_gb": peak,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "card": card_line(device),
    }


def main(argv=None) -> dict:
    cfg = config_lib.from_cli(ScaleConfig, argv)
    out = run(cfg)
    if mesh_lib.process_index() == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
