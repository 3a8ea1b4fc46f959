"""MPD-scale serving run: artifact -> embedded catalog -> device-resident
serving -> answered queries (serving half of
``esrecsys_tpu/tools/full_scale_run.py``).

The catalog is the reference's synthetic MPD stand-in: 2,262,292 tracks
whose album (of 700,000 raw ids, mod-hashed to 100,000 buckets) and artist
(of 295,861) come from a fixed integer hash of the track id. No trained
weights exist for the port yet, so the model is initialised from
``--seed``, exported in the shared artifact format, loaded back and
served; the training half arrives with the training slice.

Run: python -m esrecsys_tpu_torch.tools.full_scale_run --out_dir DIR \
         [--fused] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Dict, Tuple

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
    device: str = "cuda"


def mix_mod(ids: np.ndarray, salt: int, mod: int) -> np.ndarray:
    """Deterministic track-id -> album/artist-id map, bit-identical to the
    reference's ``mix_mod`` under numpy."""
    u32 = np.uint32
    h = ids.astype(u32) * u32(_MIX1) + u32(salt)
    h = h ^ (h >> u32(15))
    h = h * u32(_MIX2)
    h = h ^ (h >> u32(13))
    return (h % u32(mod)).astype(np.int32)


def synth_corpus(cfg: ServingRunConfig) -> Dict[str, np.ndarray]:
    ids = np.arange(cfg.num_tracks, dtype=np.int32)
    return {"tracks": ids,
            "albums": mix_mod(ids, 7, cfg.num_albums_raw),
            "artists": mix_mod(ids, 13, cfg.num_artists)}


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
                           device=cfg.device)
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
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    # scale overrides (tests / CPU smoke; defaults are the MPD scale)
    p.add_argument("--corpus_size", type=int, default=NUM_TRACKS)
    p.add_argument("--num_albums_raw", type=int, default=NUM_ALBUMS_RAW)
    p.add_argument("--album_buckets", type=int, default=ALBUM_BUCKETS)
    p.add_argument("--num_artists", type=int, default=NUM_ARTISTS)
    args = p.parse_args(argv)
    cfg = ServingRunConfig(
        out_dir=args.out_dir, num_tracks=args.corpus_size,
        num_albums_raw=args.num_albums_raw, album_buckets=args.album_buckets,
        num_artists=args.num_artists, seed=args.seed, fused=args.fused,
        fused_bins=args.fused_bins, device=args.device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    init_and_export(cfg)
    export_s = time.perf_counter() - t0
    _, out = serve_from_artifact(cfg, synth_corpus(cfg))
    out["export_s"] = export_s
    with open(os.path.join(cfg.out_dir, "full_scale_run.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
