"""Quality sweep for the playlist fast configuration (counterpart of
``esrecsys_tpu/tools/playlist_parity_sweep.py``).

The fast configuration (B=2048, 512 shared negatives, row-sparse steps,
bf16 scoring) is swept for the reference shape's track recall@500 with
the tools the port ships: the lazy or dense SGD-momentum carrier
(``ops/optim.py``), piecewise-constant lr schedules (settled at each
boundary at the outgoing lr, so the lazy trajectory stays the dense one
of the same schedule), and the GP-EI bayes sweeper (``tools/sweep.py``).

Protocol as ``tools/parity_runs.py``: the same synthetic 50k-track corpus
(seed 1234), the same 1024-playlist eval batch, a fixed budget of 25.6M
examples (what the fast configuration processes in the reference shape's
device time), the batches drawn in the reference tool's order (8 batches
a run of steps).

Run (grid, card):  python -m esrecsys_tpu_torch.tools.playlist_parity_sweep \\
                       --grid '[{"learning_rate":0.004,"momentum":0.98}]' --seeds 3
Run (bayes):       python -m esrecsys_tpu_torch.tools.playlist_parity_sweep --mode bayes
Smoke (CPU): add --device cpu --examples 16384.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import card_line, resolve_device
from esrecsys_tpu_torch.tools.parity_runs import (_playlist_batch,
                                                  _playlist_corpus, _sync,
                                                  playlist_cfg,
                                                  playlist_eval,
                                                  playlist_train)

log = logging.getLogger(__name__)

C, M = 5, 10
EVAL_PLAYLISTS = 1024
SPC = 8  # the reference tool's steps_per_call: batches drawn per run of steps

_DATA: Dict[str, Dict] = {}


def _data(device=None) -> Dict:
    """Corpus and eval batch on ``device``, built once per process and
    device (fixed seeds, identical to ``tools/parity_runs.py``)."""
    device = resolve_device(device)
    key = str(device)
    if key not in _DATA:
        from esrecsys_tpu_torch.workloads import playlist as pl

        data_rng = np.random.default_rng(1234)
        corpus_np, pools, album_of, artist_of = _playlist_corpus(data_rng)
        eval_rng = np.random.default_rng(999)
        eval_batch = _playlist_batch(eval_rng, EVAL_PLAYLISTS, C, M,
                                     pools, album_of, artist_of)
        _DATA[key] = dict(
            corpus=pl.to_device(corpus_np, device),
            pools=pools, album_of=album_of, artist_of=artist_of,
            eval_batch=pl.to_device(eval_batch, device), device=device)
    return _DATA[key]


def run_fast(overrides: Dict, seed: int, examples: int = 25_600_000,
             lr_phases: Optional[Sequence[Tuple[float, float]]] = None,
             device=None) -> Dict:
    """One fast-configuration run -> recall metrics.

    ``lr_phases``: [(fraction_of_examples, lr), ...]; at each boundary the
    lazy momentum state is settled at the outgoing lr
    (``workloads/playlist.settle_momentum_state``), so the trajectory
    equals dense SGD-momentum under the same stepwise schedule."""
    from esrecsys_tpu_torch.workloads import playlist as pl

    d = _data(device)
    device = d["device"]
    base = dict(
        batch_size=2048, num_negatives=512, shared_negatives=True,
        sparse_updates=True, momentum=0.0, learning_rate=0.3,
        compute_dtype="bfloat16")
    base.update(overrides)
    phases = list(lr_phases) if lr_phases else [(1.0, base["learning_rate"])]
    if abs(sum(f for f, _ in phases) - 1.0) >= 1e-6:
        raise ValueError(f"lr_phases fractions must sum to 1: {phases}")

    cfg0 = playlist_cfg({**base, "learning_rate": phases[0][1]}, seed, C, M)
    model, state = pl.init_state(cfg0, device)
    b = cfg0.batch_size
    batch_rng = np.random.default_rng(seed + 71)
    _sync(device)
    t0 = time.perf_counter()
    total_steps = 0
    for pi, (frac, lr) in enumerate(phases):
        cfg = playlist_cfg({**base, "learning_rate": lr}, seed, C, M)
        n_calls = max(1, int(examples * frac) // (b * SPC))
        state = playlist_train(model, state, cfg, d["corpus"], batch_rng,
                               n_calls * SPC, SPC, d["pools"],
                               d["album_of"], d["artist_of"], device)
        total_steps += n_calls * SPC
        if pi + 1 < len(phases):  # lr boundary: settle at the OUTGOING lr
            state = pl.settle_momentum_state(state, cfg, lr=lr)
    final_cfg = playlist_cfg({**base, "learning_rate": phases[-1][1]}, seed,
                             C, M)
    em = playlist_eval(model, state, final_cfg, d["corpus"], d["eval_batch"])
    out = {
        "seed": seed, **em,
        "train_seconds": round(time.perf_counter() - t0, 1),
        "steps": total_steps,
        "examples": total_steps * b,
        "overrides": overrides,
        "lr_phases": phases if lr_phases else None,
    }
    log.info("run: %s", out)
    return out


@dataclasses.dataclass(frozen=True)
class _SweptCfg:  # run_sweep merges overrides through config.with_overrides
    learning_rate: float = 6e-3
    momentum: float = 0.98
    num_negatives: int = 512
    batch_size: int = 2048


def bayes(out_dir: str, examples: int, max_runs: int, seed_base: int = 0,
          device=None) -> Dict:
    """GP-EI sweep (``tools/sweep.py``, method bayes) over (lr, momentum,
    N, B), the reference tool's spec and seed."""
    from esrecsys_tpu_torch.tools.sweep import SweepSpec, run_sweep

    spec = SweepSpec(
        method="bayes",
        metric_name="track_recall@500",
        metric_goal="maximize",
        parameters={
            "learning_rate": {"min": 1e-3, "max": 3e-2, "log": True},
            "momentum": {"values": [0.9, 0.95, 0.98]},
            "num_negatives": {"values": [256, 512, 1024]},
            "batch_size": {"values": [1024, 2048, 4096]},
        },
        max_runs=max_runs, n_init=5, early_stop_patience=8, seed=7)

    def train_fn(cfg):
        return run_fast(dataclasses.asdict(cfg), seed=seed_base,
                        examples=examples, device=device)

    return run_sweep(spec, _SweptCfg(), train_fn, out_dir,
                     metric_from_result=lambda r: r["track_recall@500"])


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="grid", choices=["grid", "bayes"])
    p.add_argument("--grid", default="[]",
                   help="JSON list of override dicts; each may carry "
                        "'lr_phases': [[frac, lr], ...]")
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--examples", type=int, default=25_600_000)
    p.add_argument("--max_runs", type=int, default=24)
    p.add_argument("--out", default="runs/playlist_sweep")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    if args.mode == "bayes":
        res = bayes(args.out, args.examples, args.max_runs, device=device)
        log.info("card: %s", card_line(device))
        print(json.dumps(res["best"]))
        return res
    results: List[Dict] = []
    for ov in json.loads(args.grid):
        phases = ov.pop("lr_phases", None)
        if phases is not None:
            phases = [tuple(x) for x in phases]
        for seed in range(args.seeds):
            results.append(run_fast(ov, seed, args.examples,
                                    lr_phases=phases, device=device))
            with open(os.path.join(args.out, "grid.json"), "w") as f:
                json.dump(results, f, indent=2)
    log.info("card: %s", card_line(device))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
