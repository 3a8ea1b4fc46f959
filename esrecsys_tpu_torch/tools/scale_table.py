"""Embedding-table scale run: one large table driven by training-shaped
traffic (counterpart of ``esrecsys_tpu/tools/scale_table.py``).

Each step draws ``ids_per_step`` row ids on the device, gathers the rows
through the row-gather kernel, takes the gradient of ``vdot(tanh(rows),
w)`` with respect to them and updates the table row-sparse: with
``--momentum`` > 0 through the lazy momentum carrier (``ops/optim.py``:
the exact dense SGD-momentum trajectory without a pass over the whole
table), else a scatter-add of ``-lr * grad`` (the scatter-add kernel).
The full width is 100M rows of 32 float32 at 262,144 ids a step with
momentum 0.98: the table, a momentum buffer of its size and an int32
``last_step`` a row on the card. Row offsets pass 2^31 elements there.

How it differs from the reference: the table is the logical (R, D) one
(the reference's 128-lane packed layout is a TPU layout trick);
``steps_per_call`` only counts steps (a call is a loop of eager steps);
``--n_model`` > 1 raises (sharded tables are ROADMAP queue 1 item 8);
``--dtype`` must be ``float32``, since the gather and scatter-add kernels
are float32 only (bf16 tables are ROADMAP queue 1's bf16-tables item).

Prints one JSON line: ``table_lookup_update_rows_per_sec`` as ``value``,
``ms_per_step`` (host clock over ``calls * steps_per_call`` steps after one
warm-up call, ending in a device sync), the peak device memory, and the
card's name and power limit.

Run: python -m esrecsys_tpu_torch.tools.scale_table [--rows 100000000]
         [--momentum 0.98] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable, Optional, Tuple

import torch

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core.device import card_line, resolve_device
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.optim import (State, lazy_momentum_update,
                                          momentum_catchup_rows,
                                          momentum_init)
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    rows: int = 100_000_000
    dim: int = 32
    dtype: str = "float32"
    ids_per_step: int = 262_144
    steps_per_call: int = 4
    calls: int = 4
    learning_rate: float = 0.01
    momentum: float = 0.0  # > 0: the lazy momentum carrier
    n_model: int = 1
    seed: int = 0
    device: str = "cuda"


def _check(cfg: ScaleConfig) -> None:
    if cfg.n_model > 1:
        raise NotImplementedError(
            "n_model > 1 (a row-sharded table) is not ported yet (ROADMAP "
            "queue 1 item 8, multi-device)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the gather and scatter-add kernels take "
            "float32 tables only; bf16 tables wait for their bf16 "
            "instantiations (ROADMAP queue 1, bf16 tables)")


def init(cfg: ScaleConfig, device: torch.device
         ) -> Tuple[torch.Tensor, Optional[State]]:
    """The (rows, dim) float32 table, normal / sqrt(dim) from ``cfg.seed``
    (the reference's ``init_table`` scale), and the lazy carrier's state
    (None at momentum 0)."""
    _check(cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    table = torch.randn((cfg.rows, cfg.dim), generator=gen, device=device)
    table.mul_(1.0 / math.sqrt(cfg.dim))
    state = momentum_init(table, lazy=True) if cfg.momentum else None
    return table, state


def step_ids(cfg: ScaleConfig, step: int, gen: torch.Generator
             ) -> torch.Tensor:
    """The ``ids_per_step`` int32 row ids of ``step``, drawn on the
    generator's device from a seed of (``cfg.seed``, ``step``)."""
    gen.manual_seed((cfg.seed * 1_000_003 + 1) * 1_000_003 + step)
    return torch.randint(0, cfg.rows, (cfg.ids_per_step,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def make_step(cfg: ScaleConfig, table: torch.Tensor,
              state: Optional[State]) -> Callable[[int], torch.Tensor]:
    """(step) -> the step's loss; updates ``table`` (and ``state``) in
    place."""
    gen = torch.Generator(device=table.device)
    w = torch.ones((cfg.ids_per_step, cfg.dim), device=table.device)
    lr, mu = cfg.learning_rate, cfg.momentum

    def one_step(step: int) -> torch.Tensor:
        ids = step_ids(cfg, step, gen)
        with torch.no_grad():
            rows = gather_rows(table, ids)
            if mu:
                rows += momentum_catchup_rows(state, ids, lr=lr, mu=mu,
                                              step=step)
        rows.requires_grad_()
        loss = torch.vdot(torch.tanh(rows).reshape(-1), w.reshape(-1))
        (g,) = torch.autograd.grad(loss, rows)
        with torch.no_grad():
            if mu:
                lazy_momentum_update(table, state, ids, g, lr=lr, mu=mu,
                                     step=step)
            else:
                scatter_add_rows(table, ids, -lr * g)
        return loss.detach()

    return one_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ScaleConfig) -> dict:
    _check(cfg)
    device = resolve_device(cfg.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    table, state = init(cfg, device)
    one_step = make_step(cfg, table, state)
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
        "table_gb": cfg.rows * cfg.dim * 4 / 1e9,
        "n_model": cfg.n_model,
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
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
