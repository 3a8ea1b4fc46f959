"""Time the shared-memory-resident scatter against the port's other row
scatter-adds on the card (counterpart of
``esrecsys_tpu/tools/scatter_attempt.py``).

Three ways to compute ``table.at[ids].add(updates)`` in place, float32:
the shared-memory kernel (``kernels/smem_scatter.py``, the port of the
VMEM-resident attempt), the atomic row kernel (``kernels/scatter_add.py``)
and PyTorch's ``index_add_``, at the flagship album table (100,096 x 32)
and a half-size table (50,000 x 32), each with the flagship step's 76,288
update rows drawn from seed 0. Each time is the mean of ``--iters``
launches between two CUDA events, after a warm-up; the table stays in
place between launches, so it is warm in the 50 MB L2 cache. Each row
also holds the largest difference of the two kernels from ``index_add_``
on one call from the same table.

Prints one JSON object on stdout and writes nothing else. Needs a CUDA
card: there is no CPU measurement.

Run: python -m esrecsys_tpu_torch.tools.scatter_attempt [--iters 20]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import resolve_device
from esrecsys_tpu_torch.kernels.scatter_add import scatter_add_cuda
from esrecsys_tpu_torch.kernels.smem_scatter import smem_scatter_cuda

DIM = 32
N_IDS = 76_288          # update rows of one flagship train step
ROWS = (100_096, 50_000)


def _event_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def measure(rows: int, iters: int, seed: int = 0) -> Dict[str, float]:
    """One table size: times (ms) and rows per second of the three
    scatter-adds, and the kernels' largest differences from
    ``index_add_``. Raises without a card."""
    dev = resolve_device("cuda")
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.normal(size=(rows, DIM)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, rows, N_IDS).astype(np.int32)
                           ).to(dev)
    upd = torch.from_numpy((rng.normal(size=(N_IDS, DIM)) * 1e-4)
                           .astype(np.float32)).to(dev)
    want = table.clone().index_add_(0, ids, upd)
    out = {}
    for name, fn in (("smem_scatter", smem_scatter_cuda),
                     ("scatter_add", scatter_add_cuda)):
        got = fn(table.clone(), ids, upd)
        out[f"{name}_max_abs_diff"] = float((got - want).abs().max())
    t = table.clone()
    for name, fn in (
            ("smem_scatter", lambda: smem_scatter_cuda(t, ids, upd)),
            ("scatter_add", lambda: scatter_add_cuda(t, ids, upd)),
            ("index_add", lambda: t.index_add_(0, ids, upd))):
        ms = _event_ms(fn, iters)
        out[f"{name}_ms"] = ms
        out[f"{name}_rows_per_s"] = N_IDS / (ms * 1e-3)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    results = {"device": torch.cuda.get_device_name(0)
               if torch.cuda.is_available() else None,
               "dim": DIM, "ids": N_IDS, "iters": args.iters}
    for rows in ROWS:
        results[f"R{rows}"] = measure(rows, args.iters)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
