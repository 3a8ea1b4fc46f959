"""MPD-scale run of the playlist workload (counterpart of
``esrecsys_tpu/tools/full_scale_run.py``).

The catalog is the reference's synthetic MPD stand-in: 2,262,292 tracks
whose album (of 700,000 raw ids, mod-hashed to 100,000 buckets) and artist
(of 295,861) come from a fixed integer hash of the track id.

Serving (the default): the model is initialised from ``--seed``, exported
in the shared artifact format, loaded back and served. ``--train`` first
trains the quality flagship (feature_size 32, a shared pool of 512
negatives, row-sparse steps with SGD momentum 0.98 at lr 0.004, bf16
scoring) on batches drawn on the device, with a full-corpus recall@500
eval every ``--eval_every`` steps, then exports the trained model and
serves that artifact. The reference's host feed from packed ``.npz``
shards, checkpoints and deploy cycles are not ported yet.

``--quantized_serving`` serves the catalog from an int8 scan copy (the
exact int8 scan, or the int8 fused kernel with ``--fused``) with a float32
rescore; ``--rescore_int8`` on top of it keeps no float32 catalog on the
device.

Run: python -m esrecsys_tpu_torch.tools.full_scale_run --out_dir DIR \
         [--fused] [--quantized_serving [--rescore_int8]] [--device cuda] \
         [--train --steps N --eval_fused_bins L]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import os
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.convert import params_from_jax
from esrecsys_tpu_torch.core.device import resolve_device
from esrecsys_tpu_torch.models.playlist import (PlaylistModel,
                                                table_rows_multiple)
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving.server import RetrievalService
from esrecsys_tpu_torch.train.export import (export_model, latest_artifact,
                                            load_model)
from esrecsys_tpu_torch.train.loop import fit
from esrecsys_tpu_torch.workloads import playlist as pl

log = logging.getLogger(__name__)

NUM_TRACKS = 2_262_292          # MPD catalog
NUM_ALBUMS_RAW = 700_000        # raw album ids, mod-hashed to buckets
ALBUM_BUCKETS = 100_000
NUM_ARTISTS = 295_861

_MIX1, _MIX2 = 2654435761, 2246822519  # Knuth/xxhash-style avalanche consts


@dataclasses.dataclass
class ServingRunConfig:
    """The quality flagship's serving shape (feature_size 32, so 64-wide
    track vectors; top-500 answers in batches of 8)."""
    out_dir: str
    num_tracks: int = NUM_TRACKS
    num_albums_raw: int = NUM_ALBUMS_RAW
    album_buckets: int = ALBUM_BUCKETS
    num_artists: int = NUM_ARTISTS
    feature_size: int = 32
    seed: int = 0
    max_k: int = 500
    max_batch: int = 8
    fused: bool = False
    fused_bins: int = 4096
    quantized: bool = False
    rescore_int8: bool = False
    device: str = "cuda"


@dataclasses.dataclass
class TrainRunConfig(ServingRunConfig):
    """The training run's options, with the reference's defaults."""
    steps: int = 30_000
    batch_size: int = 2048
    max_next: int = 64
    eval_every: int = 10_000
    eval_playlists: int = 2048
    eval_fused_bins: int = 0
    log_every: int = 2000


def mix_mod(ids: np.ndarray, salt: int, mod: int) -> np.ndarray:
    """Deterministic track-id -> album/artist-id map, bit-identical to the
    reference's ``mix_mod`` under numpy."""
    u32 = np.uint32
    h = ids.astype(u32) * u32(_MIX1) + u32(salt)
    h = h ^ (h >> u32(15))
    h = h * u32(_MIX2)
    h = h ^ (h >> u32(13))
    return (h % u32(mod)).astype(np.int32)


_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32) held in int64, in 16-bit
    halves so no product leaves the int64 range."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def mix_mod_torch(ids: torch.Tensor, salt: int, mod: int) -> torch.Tensor:
    """:func:`mix_mod` on the device, bit-identical to the numpy version.
    PyTorch has no full uint32 arithmetic, so the hash runs in int64
    masked to 32 bits."""
    h = (_mul_u32(ids.to(torch.int64) & _U32, _MIX1) + salt) & _U32
    h = h ^ (h >> 15)
    h = _mul_u32(h, _MIX2)
    h = h ^ (h >> 13)
    return (h % mod).to(torch.int32)


def synth_corpus(cfg: ServingRunConfig) -> Dict[str, np.ndarray]:
    ids = np.arange(cfg.num_tracks, dtype=np.int32)
    return {"tracks": ids,
            "albums": mix_mod(ids, 7, cfg.num_albums_raw),
            "artists": mix_mod(ids, 13, cfg.num_artists)}


def flagship_cfg(run: TrainRunConfig) -> pl.PlaylistConfig:
    """The measured-best quality configuration of the reference
    (feature_size 32, SGD momentum 0.98 at lr 0.004, a shared pool of 512
    negatives, bf16 scoring), at the run's scale."""
    return pl.PlaylistConfig(
        feature_size=run.feature_size, album_hash_buckets=run.album_buckets,
        num_artists=run.num_artists, num_negatives=512,
        shared_negatives=True, sparse_updates=True, momentum=0.98,
        learning_rate=0.004, compute_dtype="bfloat16",
        batch_size=run.batch_size, context_size=5, max_next=run.max_next,
        max_steps=run.steps, log_every_steps=run.log_every,
        eval_every_steps=run.eval_every, eval_k=500, eval_group=8,
        eval_fused_bins=run.eval_fused_bins, corpus_block=131_072,
        seed=run.seed)


def host_batch(rng: np.random.Generator, b: int, c: int, m: int,
               run: ServingRunConfig) -> Dict[str, np.ndarray]:
    """A batch of uniform playlists drawn on the host, album and artist
    ids derived from the track rows through :func:`mix_mod` (the feed's
    track-consistency invariant)."""
    ctx = rng.integers(0, run.num_tracks, (b, c)).astype(np.int32)
    nxt = rng.integers(0, run.num_tracks, (b, m)).astype(np.int32)
    return {
        "track_context": ctx,
        "album_context": mix_mod(ctx, 7, run.num_albums_raw),
        "artist_context": mix_mod(ctx, 13, run.num_artists),
        "next_track": nxt,
        "next_album": mix_mod(nxt, 7, run.num_albums_raw),
        "next_artist": mix_mod(nxt, 13, run.num_artists),
        "next_mask": np.ones((b, m), np.float32),
    }


def device_feed(run: TrainRunConfig, cfg: pl.PlaylistConfig,
                device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless training batches drawn on the device from a seeded
    generator: uniform context and next tracks, their album and artist ids
    computed with :func:`mix_mod_torch`, so no batch crosses the host."""
    gen = torch.Generator(device=device).manual_seed(17)
    b, c, m = cfg.batch_size, cfg.context_size, cfg.max_next
    while True:
        ctx = torch.randint(0, run.num_tracks, (b, c), generator=gen,
                            device=device, dtype=torch.int32)
        nxt = torch.randint(0, run.num_tracks, (b, m), generator=gen,
                            device=device, dtype=torch.int32)
        yield {
            "track_context": ctx,
            "album_context": mix_mod_torch(ctx, 7, run.num_albums_raw),
            "artist_context": mix_mod_torch(ctx, 13, run.num_artists),
            "next_track": nxt,
            "next_album": mix_mod_torch(nxt, 7, run.num_albums_raw),
            "next_artist": mix_mod_torch(nxt, 13, run.num_artists),
            "next_mask": torch.ones((b, m), device=device),
        }


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run_train(run: TrainRunConfig) -> dict:
    """Train the flagship from ``run.seed`` on the device feed, with the
    eval cadence, then export the settled model as
    ``<out_dir>/artifacts/playlist-<step>.npz``. One eval round is one
    batch of ``run.eval_playlists`` playlists drawn on the host with
    seed 999."""
    device = resolve_device(run.device)
    cfg = flagship_cfg(run)
    corpus = {k: torch.from_numpy(v).to(device)
              for k, v in synth_corpus(run).items()}
    model, state = pl.init_state(cfg, device)
    train_step = pl.select_train_step(model, cfg, corpus, seed=cfg.seed)
    eval_batch = to_device(host_batch(np.random.default_rng(999),
                                      run.eval_playlists, cfg.context_size,
                                      cfg.max_next, run), device)
    t0 = time.perf_counter()
    result = fit(
        state, train_step, device_feed(run, cfg, device),
        num_steps=cfg.max_steps,
        eval_step=pl.make_eval_step(model, cfg, corpus),
        eval_setup_fn=pl.make_corpus_embed_setup(model, cfg, corpus),
        eval_iter_fn=lambda: itertools.repeat(eval_batch),
        eval_every=cfg.eval_every_steps, eval_steps=1,
        log_every=cfg.log_every_steps, examples_per_step=cfg.batch_size)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    t_exp = time.perf_counter()
    artifact = export_model(
        run.out_dir, "playlist", pl.settled_params(result.state, cfg),
        step=int(result.state.step),
        metadata={"feature_size": cfg.feature_size,
                  "album_hash_buckets": cfg.album_hash_buckets,
                  "num_artists": cfg.num_artists,
                  "valid_rows": {"album_embed": cfg.album_hash_buckets,
                                 "artist_embed": cfg.num_artists}})
    return {"cfg": cfg, "result": result, "train_wall_s": wall,
            "export_s": time.perf_counter() - t_exp, "artifact": artifact,
            "examples": int(result.state.step) * cfg.batch_size}


def train_report(run: TrainRunConfig, tr: dict) -> dict:
    """The run's numbers, as the reference reports them: sustained
    examples/s with the eval cadence, and the steady rate without the
    first step and the eval rounds."""
    res = tr["result"]
    overhead = res.first_dispatch_s + sum(res.eval_round_s)
    steady_wall = max(tr["train_wall_s"] - overhead, 1e-9)
    return {
        "feed": "device",
        "steps": int(res.state.step),
        "examples": tr["examples"],
        "train_wall_s": tr["train_wall_s"],
        "sustained_examples_per_s": tr["examples"] / tr["train_wall_s"],
        "first_dispatch_s": res.first_dispatch_s,
        "eval_round_s": list(res.eval_round_s),
        "steady_examples_per_s": tr["examples"] / steady_wall,
        "eval_rounds": max(run.steps // run.eval_every, 0),
        "last_train": res.last_train_metrics,
        "last_eval": res.last_eval_metrics,
        "export_s": tr["export_s"],
    }


def build_model(cfg: ServingRunConfig, device: torch.device,
                generator: torch.Generator = None) -> PlaylistModel:
    return PlaylistModel(
        feature_size=cfg.feature_size, album_hash_buckets=cfg.album_buckets,
        num_artists=cfg.num_artists,
        table_rows_multiple=table_rows_multiple(cfg.feature_size),
        device=device, generator=generator)


def init_and_export(cfg: ServingRunConfig) -> str:
    """Initialise the model from ``cfg.seed`` on the device and export it
    as ``<out_dir>/artifacts/playlist-00000000.npz``."""
    device = resolve_device(cfg.device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = build_model(cfg, device, gen)
    return export_model(
        cfg.out_dir, "playlist", model, step=0,
        metadata={"feature_size": cfg.feature_size,
                  "album_hash_buckets": cfg.album_buckets,
                  "num_artists": cfg.num_artists,
                  "valid_rows": {"album_embed": cfg.album_buckets,
                                 "artist_embed": cfg.num_artists}})


def embed_catalog_from_artifact(cfg: ServingRunConfig,
                                corpus: Dict[str, np.ndarray]
                                ) -> torch.Tensor:
    """Latest exported artifact -> (num_tracks, 2 * feature_size) catalog
    matrix, embedded on the device."""
    device = resolve_device(cfg.device)
    artifact = latest_artifact(cfg.out_dir, "playlist")
    if artifact is None:
        raise FileNotFoundError(f"no playlist artifact under {cfg.out_dir}")
    params, _, _ = load_model(artifact)
    model = build_model(cfg, device)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        return model.get_embeddings(
            torch.from_numpy(corpus["albums"]).to(device),
            torch.from_numpy(corpus["artists"]).to(device))


def serve_from_artifact(cfg: ServingRunConfig,
                        corpus: Dict[str, np.ndarray]
                        ) -> Tuple[RetrievalService, dict]:
    """Artifact -> embedded catalog -> device-resident service -> first
    top-k query, then 64 queries. Returns the service and the timings."""
    t0 = time.perf_counter()
    vectors = embed_catalog_from_artifact(cfg, corpus)
    if vectors.is_cuda:
        torch.cuda.synchronize(vectors.device)
    t_embed = time.perf_counter() - t0
    vecs = vectors.cpu().numpy()
    index = EmbeddingIndex([str(i) for i in range(cfg.num_tracks)], vecs)
    svc = RetrievalService(index, max_k=cfg.max_k, max_batch=cfg.max_batch,
                           fused=cfg.fused, fused_bins=cfg.fused_bins,
                           quantized=cfg.quantized,
                           rescore_int8=cfg.rescore_int8, device=cfg.device)
    ids, scores = svc.topk(vecs[:1], k=cfg.max_k)  # the first real query
    t_first_query = time.perf_counter() - t0
    if ids.shape != (1, svc.max_k) or not np.isfinite(scores).all():
        raise RuntimeError(f"first query returned {ids.shape} ids with "
                           "non-finite scores")
    qn = min(64, cfg.num_tracks)
    tq = time.perf_counter()
    svc.topk(vecs[:qn], k=cfg.max_k)
    qps = qn / (time.perf_counter() - tq)
    return svc, {"mode": svc.mode, "device": str(svc.device),
                 "embed_catalog_s": t_embed,
                 "time_to_first_query_s": t_first_query,
                 "serving_qps": qps}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--fused", action="store_true")
    p.add_argument("--fused_bins", type=int, default=4096)
    p.add_argument("--quantized_serving", action="store_true",
                   help="serve from an int8 scan copy with a float32 "
                        "rescore")
    p.add_argument("--rescore_int8", action="store_true",
                   help="with --quantized_serving: rescore from the int8 "
                        "rows, so no float32 catalog is on the device")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    # scale overrides (tests / CPU smoke; defaults are the MPD scale)
    p.add_argument("--corpus_size", type=int, default=NUM_TRACKS)
    p.add_argument("--num_albums_raw", type=int, default=NUM_ALBUMS_RAW)
    p.add_argument("--album_buckets", type=int, default=ALBUM_BUCKETS)
    p.add_argument("--num_artists", type=int, default=NUM_ARTISTS)
    # training (--train); defaults are the reference's
    p.add_argument("--train", action="store_true",
                   help="train the flagship, then export and serve the "
                        "trained model")
    p.add_argument("--steps", type=int, default=30_000)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--max_next", type=int, default=64)
    p.add_argument("--eval_every", type=int, default=10_000)
    p.add_argument("--eval_playlists", type=int, default=2048)
    p.add_argument("--eval_fused_bins", type=int, default=0,
                   help=">0: eval rounds select candidates with the fused "
                        "affinity kernel at this bin count (approximate: "
                        "expected lost items C(k,3)/L^2), then rescore "
                        "them exactly")
    args = p.parse_args(argv)
    cfg = TrainRunConfig(
        out_dir=args.out_dir, num_tracks=args.corpus_size,
        num_albums_raw=args.num_albums_raw, album_buckets=args.album_buckets,
        num_artists=args.num_artists, seed=args.seed, fused=args.fused,
        fused_bins=args.fused_bins, quantized=args.quantized_serving,
        rescore_int8=args.rescore_int8, device=args.device, steps=args.steps,
        batch_size=args.batch_size, max_next=args.max_next,
        eval_every=args.eval_every, eval_playlists=args.eval_playlists,
        eval_fused_bins=args.eval_fused_bins)
    os.makedirs(cfg.out_dir, exist_ok=True)
    if args.train:
        out = train_report(cfg, run_train(cfg))
    else:
        t0 = time.perf_counter()
        init_and_export(cfg)
        out = {"export_s": time.perf_counter() - t0}
    _, report = serve_from_artifact(cfg, synth_corpus(cfg))
    out.update(report)
    with open(os.path.join(cfg.out_dir, "full_scale_run.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
