"""Measured quality parity (counterpart of
``esrecsys_tpu/tools/parity_runs.py``): the reference's algorithmic shape
against the framework's fast configuration, per workload, across seeds.

The reference publishes no quality numbers, so parity is established by
experiment: on a deterministic synthetic corpus with known learnable
structure, train (a) the reference's shape and (b) the fast
configuration with the same step and eval code the real workloads use,
and compare the quality metric within run-to-run variance. Results go
to ``<out_dir>/parity_<workload>.json``, in the reference tool's format.

Workloads and metrics (the reference's definitions):
  * playlist: recall@500 of held-out next tracks over the whole corpus.
    (a) B=1, 64 per-playlist negatives, dense SGD momentum 0.98;
    (b) B=2048, 512 shared negatives, row-sparse SGD, bf16 scoring.
  * glove: weighted-MSE eval loss plus neighbour-overlap@10 against the
    ground-truth embedding that generated the co-occurrence counts.
    (a) dense Adam; (b) LazyAdam (the reference packs its tables for the
    TPU; the port runs LazyAdam on the logical tables).
  * stl: held-out triplet eval loss. (a) B=16 float32; (b) B=64 bf16.
  * txt2url: text-to-url recall@10 over the whole url table on held-out
    sentences. (a) LSTM, B=64, margin; (a') the reference's exact
    all-pairs objective; (b) the mean encoder, B=1024, in-batch softmax.

The data generators are the reference tool's numpy code: a seed gives
the same corpora, batches and eval sets bit for bit. The steps and the
order of the batches are the reference tool's too: where it scans
``steps_per_call`` batches per dispatch (a TPU dispatch amortisation the
port does not have), the port draws the same batches and runs them one
step at a time, so ``steps`` and ``examples`` in the report equal the
reference's. Model init and negatives come from the port's own
generators.

Run (card): python -m esrecsys_tpu_torch.tools.parity_runs --workload all \\
    --out_dir runs/parity [--seeds 3]
Smoke (CPU): add --device cpu and small --playlist_examples,
--glove_steps and --stl_steps (txt2url runs its 3,000 steps).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import card_line, resolve_device

log = logging.getLogger(__name__)

# the batches the reference tool scans per dispatch (its steps_per_call):
# the port runs the same batches one step at a time, so its step counts
# round as the reference's do
PLAYLIST_SPC = {"reference_shape": 512, "fast": 8}
GLOVE_SPC = 32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stacked(batches: List[Dict[str, np.ndarray]], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """A list of numpy batches stacked along a new leading axis, on
    ``device`` in one copy per key."""
    from esrecsys_tpu_torch.core.device import array_to_device

    return {k: array_to_device(np.stack([b[k] for b in batches]), device)
            for k in batches[0]}


# ------------------------------------------------------------- playlist

def _playlist_corpus(rng, n_tracks=50_000, n_albums=15_000, n_artists=5_000,
                     n_genres=50):
    """Tracks partitioned into genres; playlists draw from one genre with a
    popularity skew: recall@500 is learnable far above the 1% random
    rate."""
    genre_of = rng.integers(0, n_genres, n_tracks).astype(np.int32)
    album_of = rng.integers(0, n_albums, n_tracks).astype(np.int32)
    # artists cluster within genres (8-ish artists per genre block)
    artist_of = (genre_of * (n_artists // n_genres)
                 + rng.integers(0, n_artists // n_genres, n_tracks)).astype(np.int32)
    by_genre = [np.where(genre_of == g)[0].astype(np.int32)
                for g in range(n_genres)]
    # Zipf-ish popularity within each genre, materialized as iid presampled
    # pools so batch generation is a vectorized gather
    pool_n = 100_000
    pools = np.empty((n_genres, pool_n), np.int32)
    for g in range(n_genres):
        n = len(by_genre[g])
        p = 1.0 / (np.arange(n) + 10.0)
        pools[g] = rng.choice(by_genre[g], size=pool_n, p=p / p.sum())
    corpus = {
        "tracks": np.arange(n_tracks, dtype=np.int32),
        "albums": album_of,
        "artists": artist_of,
    }
    return corpus, pools, album_of, artist_of


def _playlist_batch(rng, b, c, m, pools, album_of, artist_of):
    n_genres = pools.shape[0]
    g = rng.integers(0, n_genres, b)
    tracks = pools[g[:, None], rng.integers(0, pools.shape[1], (b, c + m))]
    ctx, nxt = tracks[:, :c], tracks[:, c:]
    return {
        "track_context": ctx, "album_context": album_of[ctx],
        "artist_context": artist_of[ctx],
        "next_track": nxt, "next_album": album_of[nxt],
        "next_artist": artist_of[nxt],
        "next_mask": np.ones((b, m), np.float32),
    }


def playlist_cfg(overrides: Dict, seed: int, context_size: int = 5,
                 max_next: int = 10):
    """The tools' playlist configuration at the parity corpus's widths,
    ``overrides`` applied over them."""
    from esrecsys_tpu_torch.workloads import playlist as pl

    fields = dict(
        feature_size=32, album_hash_buckets=20_000, num_artists=5_000,
        context_size=context_size, max_next=max_next, eval_k=500,
        eval_group=8, corpus_block=65536, seed=seed)
    fields.update(overrides)
    return pl.PlaylistConfig(**fields)


def playlist_train(model, state, cfg, corpus, batch_rng, n_steps: int,
                   spc: int, pools, album_of, artist_of,
                   device: torch.device):
    """``n_steps`` (a multiple of ``spc``) steps from ``state``; each run of
    ``spc`` steps draws its ``spc`` batches from ``batch_rng`` first (the
    reference's order) and uploads them in one copy per key."""
    from esrecsys_tpu_torch.workloads import playlist as pl

    step = pl.select_train_step(model, cfg, corpus, seed=cfg.seed)
    b, c, m = cfg.batch_size, cfg.context_size, cfg.max_next
    for _ in range(n_steps // spc):
        stacked = _stacked([_playlist_batch(batch_rng, b, c, m, pools,
                                            album_of, artist_of)
                            for _ in range(spc)], device)
        for i in range(spc):
            state, _ = step(state, {k: v[i] for k, v in stacked.items()})
    return state


def playlist_eval(model, state, cfg, corpus, eval_batch) -> Dict[str, float]:
    """Settle through the barrier (it advances ``last_step``: the eval
    settles nothing itself, and a flush that left ``last_step`` behind
    would count the catch-up twice), then one eval of ``eval_batch``."""
    from esrecsys_tpu_torch.workloads import playlist as pl

    state = pl.settle_momentum_state(state, cfg)
    em = pl.select_eval_step(model, cfg, corpus)(state, eval_batch)
    return {"track_recall@500": float(em["track_recall"]),
            "artist_recall@500": float(em["artist_recall"])}


def run_playlist(seeds: List[int], out_dir: str, examples: int = 400_000,
                 eval_playlists: int = 1024, fast_lr: float = 0.3,
                 configs_filter=None, device=None) -> Dict:
    from esrecsys_tpu_torch.workloads import playlist as pl

    device = resolve_device(device)
    C, M = 5, 10
    data_rng = np.random.default_rng(1234)  # corpus fixed across seeds/configs
    corpus_np, pools, album_of, artist_of = _playlist_corpus(data_rng)
    corpus = pl.to_device(corpus_np, device)
    eval_rng = np.random.default_rng(999)
    eval_batch = pl.to_device(_playlist_batch(eval_rng, eval_playlists, C, M,
                                              pools, album_of, artist_of),
                              device)

    # Equal-device-time protocol: the reference shape processes `examples`
    # playlists at B=1; the fast config gets the same device seconds, which
    # at its ~64x step throughput means ~64x the examples
    configs = {
        "reference_shape": (dict(
            batch_size=1, num_negatives=64, shared_negatives=False,
            sparse_updates=False, momentum=0.98, learning_rate=1e-3), 1),
        # fast-config lr is retuned for its batch size: the loss is a batch
        # MEAN, so per-row gradients shrink ~1/B vs the B=1 reference, and
        # momentum=0 drops the reference's 1/(1-0.98)=50x velocity gain
        "fast": (dict(
            batch_size=2048, num_negatives=512, shared_negatives=True,
            sparse_updates=True, momentum=0.0, learning_rate=fast_lr,
            compute_dtype="bfloat16"), 64),
    }
    if configs_filter:
        configs = {k: v for k, v in configs.items() if k in configs_filter}
    results = {}
    for name, (overrides, ex_mult) in configs.items():
        per_seed = []
        spc = PLAYLIST_SPC[name]
        for seed in seeds:
            cfg = playlist_cfg(overrides, seed, C, M)
            model, state = pl.init_state(cfg, device)
            b = cfg.batch_size
            n_calls = max(1, examples * ex_mult // (b * spc))
            batch_rng = np.random.default_rng(seed + 71)
            _sync(device)
            t0 = time.perf_counter()
            state = playlist_train(model, state, cfg, corpus, batch_rng,
                                   n_calls * spc, spc, pools, album_of,
                                   artist_of, device)
            em = playlist_eval(model, state, cfg, corpus, eval_batch)
            per_seed.append({
                "seed": seed, **em,
                "train_seconds": round(time.perf_counter() - t0, 1),
                "steps": n_calls * spc,
                "examples": n_calls * spc * b,
            })
            log.info("playlist %s seed %d: %s", name, seed, per_seed[-1])
        results[name] = per_seed
    _dump(out_dir, "playlist", results, {
        "examples": examples, "corpus": "50k tracks / 50 genres (seed 1234)",
        "protocol": "equal device-seconds (fast config processes ~64x "
                    "examples in the same device time)",
        "metric": ("recall@500 vs full 50k corpus, 1024 held-out playlists; "
                   "artist recall follows the reference definition "
                   "(train_spotify.py:123-127: every top-500 entry whose "
                   "artist is in the next set counts, so values can "
                   "exceed 1)"),
        "card": card_line(device)})
    return results


# ------------------------------------------------------------- glove

def glove_data(vocab: int = 20_000, gt_dim: int = 16):
    """(ground-truth embedding u, probe ids, their true top-10 ids, each
    token's true top-64 neighbours), drawn from seed 4321."""
    data_rng = np.random.default_rng(4321)
    u = data_rng.normal(size=(vocab, gt_dim)).astype(np.float32) / np.sqrt(gt_dim)
    probe = data_rng.integers(0, vocab, 100).astype(np.int32)
    gt_scores = u[probe] @ u.T
    gt_nn = np.argsort(-gt_scores, axis=1)[:, 1:11]  # skip self
    # like real co-occurrence, RELATED tokens appear together far more often:
    # half the pairs are drawn from each token's true top-64 neighbourhood
    top64 = np.argsort(-(u @ u.T), axis=1)[:, 1:65].astype(np.int32)
    return u, probe, gt_nn, top64


def glove_batch(rng, u, top64, vocab: int, b: int = 2048):
    """((i, j), count): count chosen so log10(1+count) == 2.5*relu(u_i.u_j)
    exactly, so the model can drive eval loss to about 0 iff it recovers
    the geometry; neighbour pairs carry GloVe-style high counts."""
    i = rng.integers(0, vocab, b).astype(np.int32)
    j_uniform = rng.integers(0, vocab, b).astype(np.int32)
    j_near = top64[i, rng.integers(0, 64, b)]
    j = np.where(rng.random(b) < 0.5, j_near, j_uniform).astype(np.int32)
    dot = np.maximum((u[i] * u[j]).sum(-1), 0.0)
    count = np.power(10.0, 2.5 * dot) - 1.0
    return (i, j), count.astype(np.float32)


def glove_eval(model, state, u, top64, probe, gt_nn, vocab: int,
               device: torch.device) -> Dict[str, float]:
    """The eval loss over 20 fresh batches (seed 5555) and the probes'
    neighbour overlap@10 with the ground truth."""
    from esrecsys_tpu_torch.workloads import glove as gw

    erng = np.random.default_rng(5555)
    eval_step = gw.make_eval_step(model)
    eval_losses = []
    for _ in range(20):
        em = eval_step(state, gw.to_device(glove_batch(erng, u, top64, vocab),
                                           device))
        eval_losses.append(float(em["loss"]))
    _, top_idx = gw.knn(state, torch.from_numpy(probe).to(device), k=11,
                        valid_rows=vocab)
    overlap = np.mean([
        len(set(top_idx[p, 1:11]) & set(gt_nn[p])) / 10.0
        for p in range(len(probe))])
    return {"eval_loss": float(np.mean(eval_losses)),
            "probe_nn_overlap@10": float(overlap)}


def run_glove(seeds: List[int], out_dir: str, steps: int = 20_000,
              vocab: int = 20_000, gt_dim: int = 16, fast_lr: float = 2e-3,
              fast_steps_mult: float = 2.5, configs_filter=None,
              device=None) -> Dict:
    from esrecsys_tpu_torch.workloads import glove as gw

    device = resolve_device(device)
    u, probe, gt_nn, top64 = glove_data(vocab, gt_dim)
    B = 2048
    # equal device time: the fast config runs fast_steps_mult more steps;
    # LazyAdam also wants a higher lr than dense Adam (idle rows keep stale
    # first moments instead of decaying them)
    configs = {
        "reference_shape": (dict(optimizer="adam", learning_rate=5e-4), 1.0),
        "fast": (dict(optimizer="lazy_adam", learning_rate=fast_lr),
                 fast_steps_mult),
    }
    if configs_filter:
        configs = {k: v for k, v in configs.items() if k in configs_filter}
    results = {}
    for name, (overrides, steps_mult) in configs.items():
        per_seed = []
        for seed in seeds:
            cfg = gw.GloveConfig(feature_size=64, batch_size=B, seed=seed,
                                 **overrides)
            model, state = gw.init_state(cfg, num_embeddings=vocab,
                                         device=device)
            step = gw.select_train_step(model, cfg)
            rng = np.random.default_rng(seed + 17)
            n_steps = int(steps * steps_mult)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_steps // GLOVE_SPC):
                bs = [glove_batch(rng, u, top64, vocab, B)
                      for _ in range(GLOVE_SPC)]
                st = _stacked([{"i": b[0][0], "j": b[0][1], "c": b[1]}
                               for b in bs], device)
                for s in range(GLOVE_SPC):
                    state, _ = step(state, ((st["i"][s], st["j"][s]),
                                            st["c"][s]))
            em = glove_eval(model, state, u, top64, probe, gt_nn, vocab,
                            device)
            per_seed.append({
                "seed": seed, **em,
                "train_seconds": round(time.perf_counter() - t0, 1),
                "steps": n_steps,
            })
            log.info("glove %s seed %d: %s", name, seed, per_seed[-1])
        results[name] = per_seed
    _dump(out_dir, "glove", results, {
        "steps": steps, "vocab": vocab,
        "metric": ("weighted-MSE eval loss on fresh pairs + probe "
                   "neighbor-overlap@10 vs the generating embedding"),
        "card": card_line(device)})
    return results


# ------------------------------------------------------------- stl

def _stl_images(rng, n_styles, size):
    """Per style: a fixed color+stripe pattern; scenes/products of one style
    are near-duplicates with independent noise."""
    base = rng.random((n_styles, size, size, 3)).astype(np.float32)
    for s in range(n_styles):
        stripe = (np.arange(size) // 4 % 2).astype(np.float32)
        base[s, :, :, s % 3] = 0.7 * stripe[None, :] + 0.3 * base[s, :, :, s % 3]
    return base


def stl_triplets(rng, base, n_styles: int, size: int, b: int):
    """(scene, pos, neg) NHWC float32: one style's base image for scene
    and pos, another's for neg, each with its own noise."""
    s = rng.integers(0, n_styles, b)
    neg = (s + 1 + rng.integers(0, n_styles - 1, b)) % n_styles
    noise = lambda: rng.normal(0, 0.05, (b, size, size, 3)).astype(np.float32)
    return (base[s] + noise(), base[s] + noise(), base[neg] + noise())


def stl_cfg(overrides: Dict, seed: int, size: int = 32):
    from esrecsys_tpu_torch.workloads import stl as sw

    return sw.STLConfig(image_size=size, output_size=64, filters=(16, 32),
                        learning_rate=1e-4, regularization=0.2, seed=seed,
                        **overrides)


def stl_eval(model, state, cfg, base, n_styles: int, size: int,
             device: torch.device) -> float:
    """The mean triplet eval loss over 16 batches drawn from seed 31337."""
    from esrecsys_tpu_torch.workloads import stl as sw

    erng = np.random.default_rng(31337)
    ev = sw.make_eval_step(model, cfg)
    eval_losses = []
    for _ in range(16):
        em = ev(state, sw.to_device(stl_triplets(erng, base, n_styles, size,
                                                 cfg.batch_size), device))
        eval_losses.append(float(em["loss"]))
    return float(np.mean(eval_losses))


def run_stl(seeds: List[int], out_dir: str, steps: int = 600,
            n_styles: int = 16, size: int = 32, device=None) -> Dict:
    from esrecsys_tpu_torch.workloads import stl as sw

    device = resolve_device(device)
    data_rng = np.random.default_rng(777)
    base = _stl_images(data_rng, n_styles, size)
    configs = {
        "reference_shape": dict(batch_size=16, use_bf16=False),
        "fast": dict(batch_size=64, use_bf16=True),
    }
    results = {}
    for name, overrides in configs.items():
        per_seed = []
        for seed in seeds:
            cfg = stl_cfg(overrides, seed, size)
            model, state = sw.init_state(cfg, device)
            step = sw.make_train_step(model, cfg)
            rng = np.random.default_rng(seed + 5)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state, sw.to_device(stl_triplets(
                    rng, base, n_styles, size, cfg.batch_size), device))
            per_seed.append({
                "seed": seed,
                "eval_triplet_loss": stl_eval(model, state, cfg, base,
                                              n_styles, size, device),
                "train_seconds": round(time.perf_counter() - t0, 1),
                "steps": steps,
            })
            log.info("stl %s seed %d: %s", name, seed, per_seed[-1])
        results[name] = per_seed
    _dump(out_dir, "stl", results, {
        "steps": steps, "styles": n_styles, "image_size": size,
        "metric": "held-out triplet eval loss (per-example, margin 1.0)",
        "card": card_line(device)})
    return results


# ------------------------------------------------------------- txt2url

def txt2url_data(n_urls: int = 2000, n_words: int = 6000):
    """Each url's 8 characteristic words (seed 8888): a sentence for url u
    samples u's words, so text-to-url retrieval is learnable."""
    data_rng = np.random.default_rng(8888)
    return data_rng.integers(1, n_words, (n_urls, 8)).astype(np.int32)


def txt2url_batch(rng, url_words, n_urls: int, L: int, b: int):
    """A batch of ``b`` sentences and url pairs; urls in the same block of
    10 are related (the url2url head's target)."""
    words_per_url = url_words.shape[1]
    u = rng.integers(0, n_urls, b).astype(np.int32)
    toks = url_words[u[:, None], rng.integers(0, words_per_url, (b, L))]
    u1 = rng.integers(0, n_urls, b).astype(np.int32)
    u2 = np.where(rng.random(b) < 0.5,
                  (u1 // 10) * 10 + rng.integers(0, 10, b),
                  rng.integers(0, n_urls, b)).astype(np.int32)
    sqrt_dice = np.where(u1 // 10 == u2 // 10, 0.7, 0.05).astype(np.float32)
    return {"url_near_text": u, "tokens": toks.astype(np.int32),
            "url1": u1, "url2": u2, "sqrt_dice": sqrt_dice}


def txt2url_cfg(overrides: Dict, seed: int, L: int = 12):
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    return t2u.Txt2UrlConfig(word_dim=16, rnn_size=16, url_dim=16,
                             sentence_length=L, seed=seed, **overrides)


def txt2url_recall(model, eval_batch: Dict[str, np.ndarray],
                   device: torch.device) -> float:
    """Text-to-url recall@10 over the whole url table (a numpy argsort of
    the float32 scores, as the reference tool ranks them)."""
    with torch.no_grad():
        scores = model.score_text_vs_all(torch.from_numpy(
            eval_batch["tokens"]).to(device)).cpu().numpy()
    top10 = np.argsort(-scores, axis=1)[:, :10]
    return float(np.mean([eval_batch["url_near_text"][i] in top10[i]
                          for i in range(top10.shape[0])]))


def run_txt2url(seeds: List[int], out_dir: str, steps: int = 3000,
                n_urls: int = 2000, n_words: int = 6000, L: int = 12,
                fast_lr: float = 2e-3, fast_steps_mult: float = 0.6,
                device=None) -> Dict:
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    device = resolve_device(device)
    if device.type == "cuda":  # score_text_vs_all is a full float32 matmul
        torch.backends.cuda.matmul.allow_tf32 = False
    url_words = txt2url_data(n_urls, n_words)
    eval_batch = txt2url_batch(np.random.default_rng(4242), url_words,
                               n_urls, L, 512)
    configs = {
        "reference_shape": (dict(encoder_type="lstm", batch_size=64,
                                 learning_rate=1e-3), 1.0),
        # the reference's EXACT objective (both heads on the (B,B) all-pairs
        # broadcast) at the reference's own margin (0.1)
        "reference_exact": (dict(encoder_type="lstm", batch_size=64,
                                 learning_rate=1e-3, margin=0.1,
                                 text_objective="reference_exact"), 1.0),
        # mean encoder steps are much cheaper; equal device time grants it
        # fast_steps_mult * steps at its bigger batch, lr retuned for B;
        # the matched-pair margin objective has no ranking signal, so the
        # fast config takes the in-batch softmax
        "fast": (dict(encoder_type="mean", batch_size=1024,
                      text_objective="softmax",
                      learning_rate=fast_lr), fast_steps_mult),
    }
    results = {}
    for name, (overrides, steps_mult) in configs.items():
        per_seed = []
        for seed in seeds:
            cfg = txt2url_cfg(overrides, seed, L)
            model, state = t2u.init_state(cfg, word_vocab_size=n_words,
                                          url_vocab_size=n_urls,
                                          device=device)
            step = t2u.make_train_step(model, cfg)
            rng = np.random.default_rng(seed + 3)
            n_steps = int(steps * steps_mult)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_steps):
                state, _ = step(state, t2u.to_device(txt2url_batch(
                    rng, url_words, n_urls, L, cfg.batch_size), device))
            per_seed.append({
                "seed": seed,
                "text_url_recall@10": txt2url_recall(model, eval_batch,
                                                     device),
                "train_seconds": round(time.perf_counter() - t0, 1),
                "steps": n_steps,
                "examples": n_steps * cfg.batch_size,
            })
            log.info("txt2url %s seed %d: %s", name, seed, per_seed[-1])
        results[name] = per_seed
    _dump(out_dir, "txt2url", results, {
        "steps": steps, "urls": n_urls,
        "metric": "text→url retrieval recall@10 over the full url table, "
                  "512 held-out sentences (random = 10/2000 = 0.005)",
        "card": card_line(device)})
    return results


# ------------------------------------------------------------- common

def _dump(out_dir: str, workload: str, results: Dict, meta: Dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"parity_{workload}.json")
    with open(path, "w") as f:
        json.dump({"meta": meta, "results": results}, f, indent=2)
    log.info("wrote %s", path)


def main(argv=None) -> Dict:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="all",
                   choices=["all", "playlist", "glove", "stl", "txt2url"])
    p.add_argument("--out_dir", default="runs/parity")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--playlist_examples", type=int, default=400_000)
    p.add_argument("--glove_steps", type=int, default=20_000)
    p.add_argument("--stl_steps", type=int, default=600)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    seeds = list(range(args.seeds))
    out = {}
    if args.workload in ("all", "playlist"):
        out["playlist"] = run_playlist(seeds, args.out_dir,
                                       examples=args.playlist_examples,
                                       device=args.device)
    if args.workload in ("all", "glove"):
        out["glove"] = run_glove(seeds, args.out_dir, steps=args.glove_steps,
                                 device=args.device)
    if args.workload in ("all", "stl"):
        out["stl"] = run_stl(seeds, args.out_dir, steps=args.stl_steps,
                             device=args.device)
    if args.workload in ("all", "txt2url"):
        out["txt2url"] = run_txt2url(seeds, args.out_dir, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
