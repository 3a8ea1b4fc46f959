"""MPD-scale run of the playlist workload (counterpart of
``esrecsys_tpu/tools/full_scale_run.py``).

The catalog is the reference's synthetic MPD stand-in: 2,262,292 tracks
whose album (of 700,000 raw ids, mod-hashed to 100,000 buckets) and artist
(of 295,861) come from a fixed integer hash of the track id.

Serving (the default): the model is initialised from ``--seed``, exported
in the shared artifact format, loaded back and served. ``--train`` first
trains the quality flagship (feature_size 32, a shared pool of 512
negatives, row-sparse steps with SGD momentum 0.98 at lr 0.004, bf16
scoring) with a full-corpus recall@500 eval every ``--eval_every`` steps,
then exports the trained model and serves that artifact.
``--momentum_carrier`` (``auto``, ``dense`` or ``lazy``) picks the
momentum carrier; ``auto`` takes the lazy one once a table passes
``workloads/playlist.DENSE_MOMENTUM_MAX_BYTES`` (``--album_buckets
10000000`` at D=32 is 1.28 GB). Feeds (``--feed``):

  * ``device`` (default): batches drawn on the device, so no batch crosses
    the host; ``--ckpt_every N`` adds the checkpoint cadence (to
    ``<out_dir>/checkpoints``, written on a thread with ``--ckpt_async``);
  * ``host``: the real file path. Synthetic packed ``.npz`` shards are
    written under ``<out_dir>/shards`` and ``<out_dir>/eval_shards``
    (``write_packed_shards``) and ``workloads/playlist.train()`` reads them
    through ``fit``'s prefetch, with its checkpoint and preemption
    cadences.

``--quantized_serving`` serves the catalog from an int8 scan copy (the
exact int8 scan, or the int8 fused kernel with ``--fused``) with a float32
rescore; ``--rescore_int8`` on top of it keeps no float32 catalog on the
device. ``--approx_serving`` selects candidates as ``approx_max_k`` does
(with ``--quantized_serving``, over the int8 scan).

Deploy cycles (``--train --deploy_cycles N``, device feed): a live HTTP
server in ``--deploy_serve_mode`` (a ``serving_bench.MODES`` name) and N
retrain -> export -> embed -> save -> ``/admin/reload`` cycles of
``--cycle_steps`` steps each, with a self-retrieval probe and, with
``--deploy_quality_queries``, the live answers' overlap@k against an
exact top-k over the new catalog; see :func:`deploy_loop`.

Run: python -m esrecsys_tpu_torch.tools.full_scale_run --out_dir DIR \
         [--fused] [--quantized_serving [--rescore_int8]] [--approx_serving]
         [--device cuda] [--train --steps N --eval_fused_bins L
          [--feed host|device] [--ckpt_every N [--ckpt_async]]
          [--momentum_carrier lazy]
          [--deploy_cycles N --cycle_steps S --deploy_serve_mode MODE]]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import os
import threading
import time
import urllib.request
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.convert import params_from_jax
from esrecsys_tpu_torch.core.device import resolve_device
from esrecsys_tpu_torch.models.playlist import (PlaylistModel,
                                                table_rows_multiple)
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix
from esrecsys_tpu_torch.serving.server import RetrievalService, serve
from esrecsys_tpu_torch.tools import serving_bench
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
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
    approx: bool = False
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
    feed: str = "device"  # "device" | "host"
    ckpt_every: int = 0
    ckpt_async: bool = False
    n_shards: int = 4  # host feed: packed training shards
    shard_examples: int = 262_144
    momentum_carrier: str = "auto"  # "auto" | "dense" | "lazy"
    # deploy cycles (device feed only)
    deploy_cycles: int = 0
    cycle_steps: int = 500
    deploy_serve_mode: str = "exact"
    recall_target: float = 0.95
    # the deploy server's IVF/PQ knobs (serving_bench.mode_kwargs)
    ivf_clusters: int = 4096
    nprobe: int = 64
    ivf_iters: int = 10
    ivf_max_cell: int = 0
    pq_subspaces: int = 8
    pq_oversample: int = 64
    pq_rotate: bool = False
    pq_anisotropic: float = 0.0
    build_train_sample: int = 0
    deploy_quality_queries: int = 0
    deploy_quality_k: int = 100
    deploy_reload_aux: str = "rebuild"


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


def train_corpus(cfg: ServingRunConfig) -> dict:
    """:func:`synth_corpus` with the vocabulary sizes that
    ``workloads/playlist.train()`` checks its first batch against."""
    return {**synth_corpus(cfg), "num_tracks": cfg.num_tracks,
            "num_albums": cfg.num_albums_raw,
            "num_artists": cfg.num_artists}


def flagship_cfg(run: TrainRunConfig) -> pl.PlaylistConfig:
    """The measured-best quality configuration of the reference
    (feature_size 32, SGD momentum 0.98 at lr 0.004, a shared pool of 512
    negatives, bf16 scoring), at the run's scale."""
    return pl.PlaylistConfig(
        feature_size=run.feature_size, album_hash_buckets=run.album_buckets,
        num_artists=run.num_artists, num_negatives=512,
        shared_negatives=True, sparse_updates=True, momentum=0.98,
        momentum_carrier=run.momentum_carrier, learning_rate=0.004,
        compute_dtype="bfloat16",
        batch_size=run.batch_size, context_size=5, max_next=run.max_next,
        max_steps=run.steps, log_every_steps=run.log_every,
        eval_every_steps=run.eval_every, eval_k=500, eval_group=8,
        eval_fused_bins=run.eval_fused_bins, corpus_block=131_072,
        work_dir=run.out_dir, eval_steps=run.eval_playlists,
        checkpoint_every_steps=run.ckpt_every, seed=run.seed)


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


def write_packed_shards(out_dir: str, n_shards: int, per_shard: int,
                        run: ServingRunConfig, c: int, m: int,
                        seed: int = 7) -> str:
    """Synthetic ETL output: ``n_shards`` packed ``.npz`` shards
    (``data/pipelines.pack_playlists``' format) of :func:`host_batch`
    playlists, shard s drawn from seed ``seed + s`` (so a rerun after a
    partial write writes the same data). Returns their glob pattern."""
    os.makedirs(out_dir, exist_ok=True)
    for s in range(n_shards):
        path = f"{out_dir}/packed-{s:05d}.npz"
        if not os.path.exists(path):
            np.savez(path, **host_batch(np.random.default_rng(seed + s),
                                        per_shard, c, m, run))
    return f"{out_dir}/packed-*.npz"


def run_train_host(run: TrainRunConfig) -> dict:
    """The host feed: packed shards on disk -> ``workloads/playlist.train``
    (prefetch, eval, checkpoint and preemption cadences, export)."""
    cfg = flagship_cfg(run)
    pattern = write_packed_shards(
        os.path.join(run.out_dir, "shards"), run.n_shards,
        run.shard_examples, run, cfg.context_size, cfg.max_next)
    # the eval shard holds at least the playlists an eval round pulls;
    # its seed lies far from the train shards' (seed + s)
    eval_pattern = write_packed_shards(
        os.path.join(run.out_dir, "eval_shards"), 1,
        max(run.batch_size * 4, 1024, run.eval_playlists), run,
        cfg.context_size, cfg.max_next, seed=1_000_000_099)
    cfg = dataclasses.replace(cfg, train_pattern=pattern,
                              test_pattern=eval_pattern)
    t0 = time.perf_counter()
    result = pl.train(cfg, corpus_np=train_corpus(run), device=run.device)
    wall = time.perf_counter() - t0
    return {"cfg": cfg, "result": result, "train_wall_s": wall,
            "artifact": latest_artifact(run.out_dir, "playlist"),
            "examples": int(result.state.step) * cfg.batch_size}


def run_train(run: TrainRunConfig) -> dict:
    """Train the flagship from ``run.seed`` with the eval (and, with
    ``run.ckpt_every``, checkpoint) cadence, then export the settled model
    as ``<out_dir>/artifacts/playlist-<step>.npz``. On the device feed one
    eval round is one batch of ``run.eval_playlists`` playlists drawn on
    the host with seed 999; the host feed is :func:`run_train_host`."""
    if run.feed == "host":
        return run_train_host(run)
    if run.feed != "device":
        raise ValueError(f"feed must be host or device, got {run.feed!r}")
    device = resolve_device(run.device)
    cfg = flagship_cfg(run)
    corpus = {k: torch.from_numpy(v).to(device)
              for k, v in synth_corpus(run).items()}
    model, state = pl.init_state(cfg, device)
    train_step = pl.select_train_step(model, cfg, corpus, seed=cfg.seed)
    eval_batch = pl.to_device(host_batch(np.random.default_rng(999),
                                         run.eval_playlists,
                                         cfg.context_size, cfg.max_next,
                                         run), device)
    ckpt = (Checkpointer(os.path.join(run.out_dir, "checkpoints"),
                         async_save=run.ckpt_async)
            if run.ckpt_every else None)
    t0 = time.perf_counter()
    result = fit(
        state, train_step, device_feed(run, cfg, device),
        num_steps=cfg.max_steps,
        eval_step=pl.make_eval_step(model, cfg, corpus),
        eval_setup_fn=pl.make_corpus_embed_setup(model, cfg, corpus),
        eval_iter_fn=lambda: itertools.repeat(eval_batch),
        eval_every=cfg.eval_every_steps, eval_steps=1,
        log_every=cfg.log_every_steps, examples_per_step=cfg.batch_size,
        checkpointer=ckpt, checkpoint_every=cfg.checkpoint_every_steps,
        # the feed draws on the card: it must stay on this thread
        prefetch=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    def do_export(state):
        return export_model(
            run.out_dir, "playlist", pl.settled_params(state, cfg),
            step=int(state.step), metadata=pl.export_metadata(cfg))

    def continue_fn(state, to_step):
        """One retrain segment of the deploy cycles: the same step and
        feed wiring from ``state`` (its momentum and step counter) to the
        absolute step ``to_step``, with no eval or checkpoint inside, then
        the export. The feed restarts from its seed, as the reference's
        does."""
        res = fit(state, train_step, device_feed(run, cfg, device),
                  num_steps=to_step, log_every=cfg.log_every_steps,
                  examples_per_step=cfg.batch_size, prefetch=0)
        do_export(res.state)
        return res.state

    t_exp = time.perf_counter()
    artifact = do_export(result.state)
    return {"cfg": cfg, "result": result, "train_wall_s": wall,
            "export_s": time.perf_counter() - t_exp, "artifact": artifact,
            "continue_fn": continue_fn,
            "examples": int(result.state.step) * cfg.batch_size}


def train_report(run: TrainRunConfig, tr: dict) -> dict:
    """The run's numbers, as the reference reports them: sustained
    examples/s with the eval and checkpoint cadences, and the steady rate
    without the first step, the eval rounds and the checkpoint saves. The
    host feed's export runs inside ``train()``, in its wall time."""
    res = tr["result"]
    overhead = (res.first_dispatch_s + sum(res.eval_round_s)
                + sum(res.ckpt_save_s))
    steady_wall = max(tr["train_wall_s"] - overhead, 1e-9)
    return {
        "feed": run.feed,
        "steps": int(res.state.step),
        "examples": tr["examples"],
        "train_wall_s": tr["train_wall_s"],
        "sustained_examples_per_s": tr["examples"] / tr["train_wall_s"],
        "first_dispatch_s": res.first_dispatch_s,
        "eval_round_s": list(res.eval_round_s),
        "ckpt_save_s": list(res.ckpt_save_s),
        "steady_examples_per_s": tr["examples"] / steady_wall,
        "eval_rounds": max(run.steps // run.eval_every, 0),
        "last_train": res.last_train_metrics,
        "last_eval": res.last_eval_metrics,
        "ckpt_saves": len(res.ckpt_save_s),
        "export_s": tr.get("export_s"),
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
                           approx=cfg.approx, fused=cfg.fused,
                           fused_bins=cfg.fused_bins, quantized=cfg.quantized,
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


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def live_overlap(url: str, catalog: torch.Tensor, nq: int, k: int,
                 rng: np.random.Generator) -> float:
    """overlap@k of the live server's answers to ``nq`` near-catalog
    queries against an exact top-k over ``catalog`` (the generation just
    loaded), ties counted: the share of returned ids whose exact score is
    at or above the exact k-th (tracks of one album and artist share a
    vector)."""
    vecs = catalog.cpu().numpy()
    q = (vecs[rng.integers(0, len(vecs), nq)]
         + rng.normal(size=(nq, vecs.shape[1])).astype(np.float32)
         * 0.05 * np.abs(vecs).mean())
    got = _post(f"{url}/v1/topk", {"vectors": q.tolist(), "k": k})["ids"]
    qt = torch.from_numpy(q).to(catalog.device)

    def scores(ids):  # one float32 multiply-sum for both sides
        return (catalog[ids] * qt[:, None, :]).sum(-1)

    kth = scores(topk_over_matrix(qt, catalog, k)[1]).min(-1, keepdim=True)
    ids = torch.tensor([[int(i) for i in row] for row in got],
                       device=catalog.device)
    found = (scores(ids) >= kth.values).float()
    return float(found.sum(-1).div(k).mean())


def deploy_loop(run: TrainRunConfig, corpus: Dict[str, np.ndarray], state,
                continue_fn) -> dict:
    """Continuous deployment against a live HTTP server: ``run.deploy_cycles``
    cycles of retrain (``continue_fn``, ``run.cycle_steps`` steps), export,
    embed the catalog and save it, then ``/admin/reload``
    into the running server, ``run.deploy_serve_mode`` (a
    ``serving_bench.MODES`` name). Per cycle: ``retrain_s``,
    ``embed_and_save_s``, ``reload_s`` (upload, quantize or scan copy,
    IVF/PQ builds, warm-up query), ``artifact_to_live_s`` (the last two), ``probe_hit``
    (item 17's own vector returns it in its top 10, asserted in every mode,
    as the reference does) and, with ``run.deploy_quality_queries``,
    ``overlap_at_k`` of the live answers (:func:`live_overlap`)."""
    track_ids = [str(i) for i in range(run.num_tracks)]

    def build_index(tag):
        t0 = time.perf_counter()
        vectors = embed_catalog_from_artifact(run, corpus)
        path = os.path.join(run.out_dir, f"index_{tag}.npz")
        EmbeddingIndex(track_ids, vectors.cpu().numpy()).save(path)
        return path, time.perf_counter() - t0, vectors

    mode = run.deploy_serve_mode
    mode_kw = serving_bench.mode_kwargs(mode, run)
    path0, _, _ = build_index("v0")
    t_up = time.perf_counter()
    httpd = serve(path0, port=0, max_k=run.max_k, max_batch=run.max_batch,
                  coalesce=False, device=run.device, **mode_kw)
    startup_s = time.perf_counter() - t_up
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    cycles = []
    try:
        step = int(state.step)
        for i in range(run.deploy_cycles):
            t_cycle = time.perf_counter()
            step += run.cycle_steps
            state = continue_fn(state, step)
            t_train = time.perf_counter() - t_cycle
            path, embed_s, vectors = build_index(f"v{i + 1}")
            t_reload = time.perf_counter()
            rep = _post(f"{url}/admin/reload",
                        {"index": path, "aux": run.deploy_reload_aux})
            reload_s = time.perf_counter() - t_reload
            if rep.get("status") != "ok" or rep.get("index") != path:
                raise RuntimeError(f"reload answered {rep}")
            probe = _post(f"{url}/v1/topk", {"id": "17", "k": 10})["ids"]
            probe_hit = "17" in probe
            if not probe_hit:
                raise AssertionError(
                    f"self-retrieval missed in {mode} mode: {probe}")
            cyc = {"cycle": i + 1, "steps": run.cycle_steps,
                   "retrain_s": t_train, "embed_and_save_s": embed_s,
                   "reload_s": reload_s,
                   "artifact_to_live_s": embed_s + reload_s,
                   "probe_hit": probe_hit}
            if run.deploy_quality_queries:
                cyc["overlap_at_k"] = live_overlap(
                    url, vectors, run.deploy_quality_queries,
                    run.deploy_quality_k, np.random.default_rng(1000 + i))
            cycles.append(cyc)
            log.info("deploy cycle %d: retrain %.1fs embed %.1fs reload "
                     "%.1fs", i + 1, t_train, embed_s, reload_s)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return {"deploy_cycles": cycles, "deploy_serve_mode": mode,
            "deploy_reload_aux": run.deploy_reload_aux,
            "deploy_server_startup_s": startup_s,
            "deploy_final_step": int(state.step)}


def main(argv=None) -> dict:
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
    p.add_argument("--approx_serving", action="store_true",
                   help="approx_max_k candidate selection + float32 rescore")
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
    p.add_argument("--feed", default="device", choices=["device", "host"],
                   help="device: batches drawn on the card; host: packed "
                        "npz shards written to disk, read by "
                        "workloads/playlist.train()")
    p.add_argument("--n_shards", type=int, default=4)
    p.add_argument("--shard_examples", type=int, default=262_144)
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="checkpoint cadence in steps (0: none; the host "
                        "feed's train() still saves its last step)")
    p.add_argument("--ckpt_async", action="store_true",
                   help="write the device feed's checkpoints on a thread")
    p.add_argument("--momentum_carrier", default="auto",
                   choices=["auto", "dense", "lazy"],
                   help="the row-sparse step's momentum carrier; auto takes "
                        "the lazy one past 1 GB a table")
    p.add_argument("--deploy_cycles", type=int, default=0,
                   help="after training, run N retrain->export->hot-reload "
                        "cycles against a live server (device feed only)")
    p.add_argument("--cycle_steps", type=int, default=500)
    p.add_argument("--deploy_serve_mode", default="exact",
                   choices=serving_bench.MODES,
                   help="the live server's retrieval mode; in the ivf and "
                        "pq modes a reload's seconds include the structures' "
                        "rebuild (or, with --deploy_reload_aux reuse, their "
                        "assign and encode passes)")
    p.add_argument("--recall_target", type=float, default=0.95)
    p.add_argument("--ivf_clusters", type=int, default=4096)
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--ivf_iters", type=int, default=10)
    p.add_argument("--ivf_max_cell", type=int, default=0)
    p.add_argument("--pq_subspaces", type=int, default=8)
    p.add_argument("--pq_oversample", type=int, default=64)
    p.add_argument("--pq_rotate", action="store_true")
    p.add_argument("--pq_anisotropic", type=float, default=0.0,
                   help="score-aware PQ training threshold T of the deploy "
                        "server (0: off)")
    p.add_argument("--build_train_sample", type=int, default=0,
                   help="train the deploy server's IVF/PQ k-means on this "
                        "many sampled rows")
    p.add_argument("--deploy_quality_queries", type=int, default=0,
                   help="after each reload, the live answers' overlap@k "
                        "against an exact top-k over the new catalog on "
                        "this many near-catalog queries (0: off)")
    p.add_argument("--deploy_quality_k", type=int, default=100)
    p.add_argument("--deploy_reload_aux", default="rebuild",
                   choices=["rebuild", "reuse"],
                   help="rebuild retrains the IVF/PQ structures at each "
                        "reload; reuse keeps the live centroids and "
                        "codebooks and pays only the assign and encode "
                        "passes")
    args = p.parse_args(argv)
    cfg = TrainRunConfig(
        out_dir=args.out_dir, num_tracks=args.corpus_size,
        num_albums_raw=args.num_albums_raw, album_buckets=args.album_buckets,
        num_artists=args.num_artists, seed=args.seed, fused=args.fused,
        fused_bins=args.fused_bins, quantized=args.quantized_serving,
        rescore_int8=args.rescore_int8, approx=args.approx_serving,
        device=args.device, steps=args.steps,
        batch_size=args.batch_size, max_next=args.max_next,
        eval_every=args.eval_every, eval_playlists=args.eval_playlists,
        eval_fused_bins=args.eval_fused_bins, feed=args.feed,
        n_shards=args.n_shards, shard_examples=args.shard_examples,
        ckpt_every=args.ckpt_every, ckpt_async=args.ckpt_async,
        momentum_carrier=args.momentum_carrier,
        deploy_cycles=args.deploy_cycles, cycle_steps=args.cycle_steps,
        deploy_serve_mode=args.deploy_serve_mode,
        recall_target=args.recall_target,
        ivf_clusters=args.ivf_clusters, nprobe=args.nprobe,
        ivf_iters=args.ivf_iters, ivf_max_cell=args.ivf_max_cell,
        pq_subspaces=args.pq_subspaces, pq_oversample=args.pq_oversample,
        pq_rotate=args.pq_rotate, pq_anisotropic=args.pq_anisotropic,
        build_train_sample=args.build_train_sample,
        deploy_quality_queries=args.deploy_quality_queries,
        deploy_quality_k=args.deploy_quality_k,
        deploy_reload_aux=args.deploy_reload_aux)
    os.makedirs(cfg.out_dir, exist_ok=True)
    tr = None
    if args.train:
        tr = run_train(cfg)
        out = train_report(cfg, tr)
    else:
        t0 = time.perf_counter()
        init_and_export(cfg)
        out = {"export_s": time.perf_counter() - t0}
    if cfg.deploy_cycles and (tr is None or "continue_fn" not in tr):
        raise SystemExit("--deploy_cycles needs --train with --feed device")
    _, report = serve_from_artifact(cfg, synth_corpus(cfg))
    out.update(report)
    if cfg.deploy_cycles:
        out.update(deploy_loop(cfg, synth_corpus(cfg), tr["result"].state,
                               tr["continue_fn"]))
    with open(os.path.join(cfg.out_dir, "full_scale_run.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
