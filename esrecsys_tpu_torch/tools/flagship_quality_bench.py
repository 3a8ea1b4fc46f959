"""Training throughput of the quality flagship under each momentum
configuration (counterpart of
``esrecsys_tpu/tools/flagship_quality_bench.py``).

The quality flagship: feature_size 32, 100,000 album buckets, 295,861
artists, B=2048, C=5, M=32, a shared pool of 512 negatives, SGD momentum
0.98 at lr 0.004, bf16 scoring. Configurations:

  * ``m98_sparse_densecarrier_logical``: the row-sparse step with
    ``momentum_carrier="auto"``, which resolves to the dense carrier at
    these table sizes;
  * ``m98_lazy_logical``: the row-sparse step with the lazy carrier;
  * ``m0``: the row-sparse step at momentum 0 (lr 0.3);
  * ``m98_dense_step``: the dense autograd step with ``torch.optim.SGD``
    momentum (skipped with ``--skip_dense``).

The reference's ``*_packed`` configurations are a TPU layout trick and
are not ported. Each configuration starts from seed 0, runs one warm-up
call of ``--spc`` steps, then ``--n_calls`` calls of ``--spc`` steps on
one device-resident batch, as the reference does; examples/s is steps x
B over the host clock of the timed calls, which end in a device sync.

Writes the JSON object to ``--out`` (default
``runs/flagship_quality_bench.json``, outside the JAX package's
committed ``parity_runs/``) and prints it as one line, with the card's
name and power limit.

Run: python -m esrecsys_tpu_torch.tools.flagship_quality_bench [--spc 64]
         [--n_calls 6] [--skip_dense] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import card_line, resolve_device
from esrecsys_tpu_torch.workloads import playlist as pl

log = logging.getLogger(__name__)

NUM_TRACKS = 2_262_292
NUM_ALBUMS, NUM_ARTISTS = 100_000, 295_861
CORPUS = 262_144


def quality_configs(album_buckets: int = NUM_ALBUMS,
                    num_artists: int = NUM_ARTISTS, batch_size: int = 2048,
                    num_negatives: int = 512, skip_dense: bool = False
                    ) -> Dict[str, pl.PlaylistConfig]:
    """The configurations measured, by name."""
    quality = pl.PlaylistConfig(
        feature_size=32, album_hash_buckets=album_buckets,
        num_artists=num_artists, num_negatives=num_negatives,
        batch_size=batch_size, context_size=5, max_next=32,
        shared_negatives=True, sparse_updates=True, momentum=0.98,
        learning_rate=0.004, compute_dtype="bfloat16")
    configs = {
        "m98_sparse_densecarrier_logical": quality,
        "m98_lazy_logical": dataclasses.replace(
            quality, momentum_carrier="lazy"),
        "m0": dataclasses.replace(quality, momentum=0.0, learning_rate=0.3),
    }
    if not skip_dense:
        configs["m98_dense_step"] = dataclasses.replace(
            quality, sparse_updates=False)
    return configs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cfg: pl.PlaylistConfig, corpus, batch, spc: int, n_calls: int,
            device: torch.device) -> float:
    """examples/s of ``cfg``'s train step over ``n_calls * spc`` steps on
    ``batch``, after one warm-up call of ``spc`` steps."""
    model, state = pl.init_state(cfg, device)
    step = pl.select_train_step(model, cfg, corpus, seed=0)
    for _ in range(spc):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_calls * spc):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    _sync(device)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return n_calls * spc * cfg.batch_size / dt


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spc", type=int, default=64)
    p.add_argument("--n_calls", type=int, default=6)
    p.add_argument("--skip_dense", action="store_true",
                   help="skip the dense step (autograd through the whole "
                        "tables)")
    p.add_argument("--out", default="runs/flagship_quality_bench.json")
    p.add_argument("--device", default="cuda")
    # scale overrides (tests / CPU smoke; the defaults are the flagship's)
    p.add_argument("--album_buckets", type=int, default=NUM_ALBUMS)
    p.add_argument("--num_artists", type=int, default=NUM_ARTISTS)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--num_negatives", type=int, default=512)
    p.add_argument("--corpus_size", type=int, default=CORPUS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n = args.corpus_size
    corpus = {
        "tracks": rng.integers(0, NUM_TRACKS, n),
        "albums": rng.integers(0, args.album_buckets * 7, n),
        "artists": rng.integers(0, args.num_artists, n)}
    corpus = {k: torch.from_numpy(v.astype(np.int32)).to(device)
              for k, v in corpus.items()}
    b, c, m = args.batch_size, 5, 32
    rng = np.random.default_rng(7)
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)
    batch = pl.to_device({
        "track_context": ri(NUM_TRACKS, b, c),
        "album_context": ri(args.album_buckets * 7, b, c),
        "artist_context": ri(args.num_artists, b, c),
        "next_track": ri(NUM_TRACKS, b, m),
        "next_album": ri(args.album_buckets * 7, b, m),
        "next_artist": ri(args.num_artists, b, m),
        "next_mask": np.ones((b, m), np.float32)}, device)

    out = {}
    for name, cfg in quality_configs(
            args.album_buckets, args.num_artists, b, args.num_negatives,
            args.skip_dense).items():
        out[name] = measure(cfg, corpus, batch, args.spc, args.n_calls,
                            device)
        log.info("%s: %.1fk ex/s", name, out[name] / 1e3)
    out["platform"] = "gpu" if device.type == "cuda" else device.type
    out["card"] = card_line(device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
