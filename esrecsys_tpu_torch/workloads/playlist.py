"""Playlist next-track workload: loss, train steps, full-corpus eval and
the training entry point (counterpart of
``esrecsys_tpu/workloads/playlist.py``).

Ported: ``PlaylistConfig`` (the fields below), ``playlist_loss``, the dense
autograd step with SGD momentum, the row-sparse step at momentum 0 and
with either momentum carrier (dense, or lazy: ``ops/optim.py``),
``init_state``, ``settled_params``, ``settle_momentum_state``, the exact
and fused recall@k eval over the full corpus, ``restore_adapt_carrier``
between the two carriers, and ``train()`` with its CLI: TFRecord or packed
``.npz`` files in, the eval, checkpoint and preemption cadences, resume,
and the exported artifact out. The row-sparse step gathers its touched
rows through the row-gather kernel, differentiates the loss with respect
to those rows, and scatter-adds the row gradients through the scatter-add
kernel; the fused eval scans the corpus through the playlist-affinity
kernel.

Not ported: the TPU's packed table layouts (a TPU layout trick, never
ported), ``steps_per_call``, and everything multi-device (the sharded
eval, ``n_model_shards > 1``, per-process file slices).

Run: python -m esrecsys_tpu_torch.workloads.playlist \
         --train_pattern 'data/training/*.tfrecord' \
         --test_pattern 'data/test/*.tfrecord' \
         --all_tracks data/training/all_tracks.json \
         --dictionaries data/training --work_dir runs/playlist \
         [--resume true] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core.device import pad_to_multiple, resolve_device
from esrecsys_tpu_torch.core.tracking import make_tracker
from esrecsys_tpu_torch.data import pipelines
from esrecsys_tpu_torch.models.playlist import (PlaylistModel,
                                                affinity_scores,
                                                batched_isin,
                                                score_embeddings,
                                                table_rows_multiple)
from esrecsys_tpu_torch.ops import guards, negatives
from esrecsys_tpu_torch.ops.losses import relu
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.metrics import ranking_metrics
from esrecsys_tpu_torch.ops.optim import (lazy_momentum_update,
                                          momentum_catchup_rows,
                                          momentum_flush, momentum_init,
                                          momentum_settle)
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows
from esrecsys_tpu_torch.retrieval.fused import (binned_affinity_candidates,
                                                pack_catalog)
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, chunked_grouped_topk,
                                               chunked_topk, pad_topk,
                                               require_full_f32,
                                               topk_lower_index_first)
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.train.export import export_model
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.preemption import log_if_preempted
from esrecsys_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

POS_INF = float("inf")
STREAM_NEGATIVES = 1  # the reference's core/prng stream tag

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PlaylistConfig:
    """The reference's fields that the port uses, with its defaults
    (``work_dir`` defaults to ``playlist`` under the temporary
    directory)."""

    train_pattern: str = ""  # *.tfrecord files, or packed *.npz shards
    test_pattern: str = ""
    all_tracks: str = ""  # all_tracks.json of the ETL
    dictionaries: str = ""  # directory of the ETL's uri dictionaries
    work_dir: str = os.path.join(tempfile.gettempdir(), "playlist")
    feature_size: int = 32
    album_hash_buckets: int = 100_000
    num_artists: int = 295_861
    num_negatives: int = 64
    shared_negatives: bool = False  # one pool of num_negatives per step
    exact_negative_range: bool = False  # sample in [0, corpus - 1)
    sparse_updates: bool = False  # row-sparse step (gather, row grads,
    # scatter-add) in place of autograd through the tables
    momentum_carrier: str = "auto"  # "auto" | "dense" | "lazy"
    learning_rate: float = 1e-3
    momentum: float = 0.98
    regularization: float = 10.0   # L2-norm cap
    batch_size: int = 8
    context_size: int = 5
    max_next: int = 64
    max_steps: int = 2_000_000
    log_every_steps: int = 1000
    eval_every_steps: int = 10_000
    eval_steps: int = 1000  # eval playlists a round (whole batches, >= 1)
    eval_k: int = 500
    eval_group: int = 8  # group-max prefilter width of the exact eval;
    # 0 = plain chunked_topk
    eval_score_tile_bytes: int = 128 * 1024 * 1024  # exact-eval budget of
    # the per-block (Bq, block, C) float32 score tile; larger eval batches
    # run as sequential query chunks
    eval_fused_bins: int = 0  # > 0: the eval selects candidates with the
    # fused affinity kernel at this bin count, then rescores them exactly
    compute_dtype: str = "float32"  # "bfloat16": bf16 scoring inputs
    checkpoint_every_steps: int = 100_000
    corpus_block: int = 131_072
    seed: int = 0
    n_model_shards: int = 1  # > 1 (the sharded tables and eval) raises
    resume: bool = False
    # SIGTERM -> a stop at the next step, a checkpoint and a clean exit;
    # relaunch with resume=True (train/preemption.py)
    graceful_shutdown: bool = True


# ------------------------------------------------------------------ loss

def playlist_loss(result: Tuple, next_mask: torch.Tensor,
                  regularization: float) -> Dict[str, torch.Tensor]:
    """Batched, masked playlist loss: per playlist the extremal triplet
    relu(1 + max(neg) - min(pos)), the mean triplet relu(1 + mean(neg) -
    mean(pos)), the self-affinity hinges and the norm cap; averaged over
    the batch. Shared-negative results (2-D ``neg_self``, paired L2
    output) add the pool's terms once per playlist. ``amin``/``amax``
    split the gradient among ties as JAX's min and max do."""
    (pos_aff, neg_aff, ctx_self, next_self, neg_self, l2) = result
    shared = neg_self.dim() == 2
    m = next_mask  # (B, M) 1.0 for real next tracks
    count = m.sum(-1).clamp(min=1.0)

    mean_pos = (pos_aff * m).sum(-1) / count
    mean_neg = neg_aff.mean(-1)
    mean_triplet = relu(1.0 + mean_neg - mean_pos)

    min_pos = torch.where(m > 0, pos_aff, POS_INF).amin(-1)
    max_neg = neg_aff.amax(-1)
    extremal_triplet = relu(1.0 + max_neg - min_pos)

    # self-affinity matrices (B, M, M): mask the next group's padded pairs
    pair_mask = m[:, :, None] * m[:, None, :]
    pair_mask = pair_mask.flip(-2)  # rows are flipped embeddings
    pair_count = pair_mask.sum((-1, -2)).clamp(min=1.0)
    ctx_floor = relu(0.5 - ctx_self).mean((-1, -2))
    next_floor = (relu(0.5 - next_self) * pair_mask).sum((-1, -2)) / pair_count
    neg_ceiling = relu(neg_self).mean((-1, -2))  # a scalar if shared

    # norm cap, padded next rows excluded (l2 layout [C ctx | M next | N neg])
    ctx_n = ctx_self.shape[-1]
    if shared:
        ctx_next_l2, neg_l2 = l2
        norm_mask = torch.cat([torch.ones_like(ctx_next_l2[:, :ctx_n]), m],
                              dim=-1)
        reg_loss = (relu(ctx_next_l2 - regularization) * norm_mask).sum(-1)
        reg_loss = reg_loss + relu(neg_l2 - regularization).sum()
    else:
        next_n = next_self.shape[-1]
        norm_mask = torch.cat([torch.ones_like(l2[:, :ctx_n]), m,
                               torch.ones_like(l2[:, ctx_n + next_n:])],
                              dim=-1)
        reg_loss = (relu(l2 - regularization) * norm_mask).sum(-1)

    loss = (extremal_triplet + mean_triplet + reg_loss
            + ctx_floor + next_floor + neg_ceiling)
    return {"loss": loss.mean(), "mean_triplet": mean_triplet.mean(),
            "extremal_triplet": extremal_triplet.mean(),
            "reg": reg_loss.mean()}


# ------------------------------------------------------------------ state

# Above this per-table byte size "auto" takes the lazy momentum carrier, as
# the reference does (kept for parity; the crossover on the card is
# measured in PERF.md).
DENSE_MOMENTUM_MAX_BYTES = 1_000_000_000


def use_dense_momentum(cfg: PlaylistConfig) -> bool:
    """Resolve ``cfg.momentum_carrier`` for the row-sparse momentum step."""
    if not (cfg.sparse_updates and cfg.momentum):
        return False
    mode = cfg.momentum_carrier
    if mode == "dense":
        return True
    if mode == "lazy":
        return False
    if mode != "auto":
        raise ValueError(f"momentum_carrier must be auto|dense|lazy, "
                         f"got {mode!r}")
    biggest = max(cfg.album_hash_buckets, cfg.num_artists)
    return biggest * cfg.feature_size * 4 <= DENSE_MOMENTUM_MAX_BYTES


def use_lazy_momentum(cfg: PlaylistConfig) -> bool:
    """Whether the row-sparse momentum step runs the lazy carrier."""
    return bool(cfg.sparse_updates and cfg.momentum
                and not use_dense_momentum(cfg))


def init_state(cfg: PlaylistConfig, device=None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[PlaylistModel, TrainState]:
    """The model (tables padded to 128 rows where D divides 128, as the
    reference pads them) initialised from ``generator`` (default: seeded
    with ``cfg.seed`` on the device), and its train state: per table a
    momentum buffer (the dense carrier) or a momentum buffer and
    ``last_step`` rows (the lazy carrier) for the row-sparse step with
    momentum, nothing at momentum 0, an SGD optimizer for the dense
    step."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    model = PlaylistModel(
        cfg.feature_size, cfg.album_hash_buckets, cfg.num_artists,
        table_rows_multiple=table_rows_multiple(cfg.feature_size),
        device=device, generator=generator,
        compute_dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else None))
    if cfg.sparse_updates:
        opt_state = None
        if cfg.momentum:
            lazy = use_lazy_momentum(cfg)
            opt_state = {
                "album": momentum_init(model.album_embed.embedding, lazy),
                "artist": momentum_init(model.artist_embed.embedding, lazy)}
    else:
        opt_state = torch.optim.SGD(model.parameters(), lr=cfg.learning_rate,
                                    momentum=cfg.momentum or 0.0)
    return model, TrainState(step=0, params=model, opt_state=opt_state)


def settled_params(state: TrainState, cfg: PlaylistConfig) -> PlaylistModel:
    """The model to evaluate and export: under the lazy carrier a new
    ``PlaylistModel`` whose tables are flushed copies
    (:func:`momentum_flush`, the dense trajectory at ``state.step``), the
    state untouched; otherwise ``state.params``, whose rows are always
    settled."""
    if not use_lazy_momentum(cfg):
        return state.params
    model = state.params
    out = PlaylistModel(model.feature_size, model.album_hash_buckets,
                        model.num_artists, device="meta",
                        compute_dtype=model.compute_dtype)
    with torch.no_grad():
        for name, table in (("album", model.album_embed),
                            ("artist", model.artist_embed)):
            flushed = momentum_flush(
                table.embedding, state.opt_state[name], lr=cfg.learning_rate,
                mu=cfg.momentum, step=state.step)
            out.get_submodule(f"{name}_embed").embedding = nn.Parameter(
                flushed, requires_grad=False)
    return out


def settle_momentum_state(state: TrainState, cfg: PlaylistConfig,
                          lr: Optional[float] = None) -> TrainState:
    """The learning-rate-boundary barrier of the lazy carrier: settle every
    row at the old lr (``lr``, default ``cfg.learning_rate``) and advance
    ``last_step`` (:func:`momentum_settle`), in place, so a
    piecewise-constant schedule stays the dense SGD-momentum trajectory of
    that schedule. Returns ``state``; nothing to do for other
    configurations (the dense carrier has no catch-up, so its lr can change
    between any two steps)."""
    if use_lazy_momentum(cfg):
        lr = cfg.learning_rate if lr is None else lr
        with torch.no_grad():
            for name, table in (("album", state.params.album_embed),
                                ("artist", state.params.artist_embed)):
                momentum_settle(table.embedding, state.opt_state[name],
                                lr=lr, mu=cfg.momentum, step=state.step)
    return state


# ------------------------------------------------------------------ steps

def _step_generator(device: torch.device, seed: int):
    """(step) -> a generator seeded for that step's negatives, so a step's
    draw does not depend on the steps run before it (the reference folds
    the step into its key)."""
    gen = torch.Generator(device=device)

    def for_step(step: int) -> torch.Generator:
        return gen.manual_seed(
            ((seed * 1_000_003 + STREAM_NEGATIVES) * 1_000_003 + step)
            % (1 << 63))

    return for_step


def _negatives(cfg: PlaylistConfig, corpus: Batch, for_step, step: int,
               batch_size: int, neg_ids: Optional[torch.Tensor]):
    if neg_ids is None:
        return negatives.sample_negative_rows(
            for_step(step), cfg.num_negatives,
            (corpus["albums"], corpus["artists"]),
            batch_size=None if cfg.shared_negatives else batch_size,
            exact_range=cfg.exact_negative_range)
    idx = neg_ids.long()
    return neg_ids, corpus["albums"][idx], corpus["artists"][idx]


def make_train_step(model: PlaylistModel, cfg: PlaylistConfig,
                    corpus: Batch, seed: int = 0):
    """The dense step: autograd through the table lookups (a row-scatter
    backward into table-shaped gradients) and ``torch.optim.SGD``
    momentum, which follows optax's trace: ``buf = mu * buf + g``,
    ``p -= lr * buf``. ``train_step(state, batch, neg_ids=None)`` updates
    ``state`` in place; ``neg_ids`` injects the step's negative corpus
    rows (tests feed the ids JAX drew)."""
    for_step = _step_generator(model.album_embed.embedding.device, seed)

    def train_step(state: TrainState, batch: Batch,
                   neg_ids: Optional[torch.Tensor] = None):
        neg_idx, neg_album, neg_artist = _negatives(
            cfg, corpus, for_step, state.step,
            batch["track_context"].shape[0], neg_ids)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        result = state.params(
            batch["track_context"], batch["album_context"],
            batch["artist_context"], batch["next_track"],
            batch["next_album"], batch["next_artist"],
            neg_idx, neg_album, neg_artist)
        metrics = playlist_loss(result, batch["next_mask"],
                                cfg.regularization)
        metrics["loss"].backward()
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_sparse_train_step(model: PlaylistModel, cfg: PlaylistConfig,
                           corpus: Batch, seed: int = 0):
    """Row-sparse SGD step, at momentum 0 or with either momentum carrier:

      1. gather each table's touched rows once (ctx | next | neg ids, album
         ids floor-mod the bucket count) through the row-gather kernel; the
         lazy carrier adds each row's pending catch-up, so the forward sees
         settled rows;
      2. differentiate the loss with respect to the gathered rows;
      3. momentum 0: scatter-add ``-lr * row_grad`` into the table;
         dense carrier: ``m *= mu``, scatter-add the row grads into ``m``,
         ``p -= lr * m`` (duplicates sum, as the dense gradient would);
         lazy carrier: :func:`lazy_momentum_update` on the touched rows.

    Tables and optimizer state update in place. ``train_step(state,
    batch, neg_ids=None)`` as in :func:`make_train_step`."""
    lazy = use_lazy_momentum(cfg)
    lr, mu = cfg.learning_rate, cfg.momentum
    n_albums = cfg.album_hash_buckets
    for_step = _step_generator(model.album_embed.embedding.device, seed)

    def train_step(state: TrainState, batch: Batch,
                   neg_ids: Optional[torch.Tensor] = None):
        b = batch["track_context"].shape[0]
        neg_idx, neg_album, neg_artist = _negatives(
            cfg, corpus, for_step, state.step, b, neg_ids)
        c, m = cfg.context_size, cfg.max_next
        alb_ids = torch.remainder(torch.cat([
            batch["album_context"].reshape(-1),
            batch["next_album"].reshape(-1), neg_album.reshape(-1)]),
            n_albums).to(torch.int32)
        art_ids = torch.cat([
            batch["artist_context"].reshape(-1),
            batch["next_artist"].reshape(-1),
            neg_artist.reshape(-1)]).to(torch.int32)
        alb_ids = guards.check_ids(alb_ids, n_albums, "album_embed")
        art_ids = guards.check_ids(art_ids, cfg.num_artists, "artist_embed")

        t_alb = state.params.album_embed.embedding
        t_art = state.params.artist_embed.embedding
        with torch.no_grad():
            rows_alb = gather_rows(t_alb, alb_ids)
            rows_art = gather_rows(t_art, art_ids)
            if lazy:
                rows_alb += momentum_catchup_rows(
                    state.opt_state["album"], alb_ids, lr=lr, mu=mu,
                    step=state.step)
                rows_art += momentum_catchup_rows(
                    state.opt_state["artist"], art_ids, lr=lr, mu=mu,
                    step=state.step)
        rows_alb.requires_grad_()
        rows_art.requires_grad_()
        e = torch.cat([rows_alb, rows_art], dim=-1)  # (n, 2F)
        d = e.shape[-1]
        ctx_e = e[:b * c].reshape(b, c, d)
        nxt_e = e[b * c:b * (c + m)].reshape(b, m, d)
        neg_e = e[b * (c + m):]
        if not cfg.shared_negatives:
            neg_e = neg_e.reshape(b, cfg.num_negatives, d)
        result = score_embeddings(
            ctx_e, nxt_e, neg_e, batch["next_album"], batch["next_artist"],
            neg_album, neg_artist, batch["album_context"],
            batch["artist_context"], compute_dtype=model.compute_dtype)
        metrics = playlist_loss(result, batch["next_mask"],
                                cfg.regularization)
        g_alb, g_art = torch.autograd.grad(metrics["loss"],
                                           (rows_alb, rows_art))

        with torch.no_grad():
            if lazy:
                lazy_momentum_update(t_alb, state.opt_state["album"],
                                     alb_ids, g_alb, lr=lr, mu=mu,
                                     step=state.step)
                lazy_momentum_update(t_art, state.opt_state["artist"],
                                     art_ids, g_art, lr=lr, mu=mu,
                                     step=state.step)
            elif mu:
                m_alb = state.opt_state["album"]["momentum"]
                m_art = state.opt_state["artist"]["momentum"]
                m_alb.mul_(mu)
                m_art.mul_(mu)
                scatter_add_rows(m_alb, alb_ids, g_alb)
                scatter_add_rows(m_art, art_ids, g_art)
                t_alb.sub_(lr * m_alb)
                t_art.sub_(lr * m_art)
            else:
                scatter_add_rows(t_alb, alb_ids, -lr * g_alb)
                scatter_add_rows(t_art, art_ids, -lr * g_art)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def select_train_step(model: PlaylistModel, cfg: PlaylistConfig,
                      corpus: Batch, seed: int = 0):
    if cfg.sparse_updates:
        return make_sparse_train_step(model, cfg, corpus, seed)
    return make_train_step(model, cfg, corpus, seed)


# ------------------------------------------------------------------ eval

def _eval_fused_bins(cfg: PlaylistConfig) -> int:
    """Resolved fused-eval bin count: at least ceil(eval_k / 2), in
    multiples of 128, so the per-bin top-2 can cover k."""
    return max(pad_to_multiple(cfg.eval_fused_bins, 128),
               pad_to_multiple(-(-cfg.eval_k // 2), 128))


def _eval_query_chunk(cfg: PlaylistConfig, block: int) -> int:
    """Largest multiple-of-8 query count whose (Bq, block, C) float32
    score tile fits ``cfg.eval_score_tile_bytes``."""
    per_q = block * max(1, cfg.context_size) * 4
    return max(8, (cfg.eval_score_tile_bytes // per_q) & ~7)


def _corpus_block(cfg: PlaylistConfig, num_items: int) -> int:
    return min(cfg.corpus_block, pad_to_multiple(num_items, 256))


def make_corpus_embed_setup(model: PlaylistModel, cfg: PlaylistConfig,
                            corpus: Batch):
    """(state) -> the (N_pad, D) corpus embedding matrix, computed once per
    eval round and shared by every eval batch of the round; with
    ``eval_fused_bins`` the pair (matrix, its (D, Mp) bf16 scan copy)."""
    num_items = int(corpus["tracks"].shape[0])
    block = _corpus_block(cfg, num_items)
    pad = pad_to_multiple(num_items, block) - num_items
    albums_p = F.pad(corpus["albums"], (0, pad))
    artists_p = F.pad(corpus["artists"], (0, pad))

    def setup(state: TrainState):
        with torch.no_grad():
            ce = settled_params(state, cfg).get_embeddings(albums_p,
                                                           artists_p)
        if cfg.eval_fused_bins:
            return ce, pack_catalog(ce, _eval_fused_bins(cfg))
        return ce

    return setup


def _settled_ctx_embed(state: TrainState, cfg: PlaylistConfig,
                       album_ctx: torch.Tensor,
                       artist_ctx: torch.Tensor) -> torch.Tensor:
    """(B, C, 2F) context embeddings at settled rows: under the lazy
    carrier only the gathered rows get their catch-up (B * C rows, not a
    flush of both tables per eval batch; the round's corpus matrix is
    settled once by :func:`make_corpus_embed_setup`)."""
    e = state.params.get_embeddings(album_ctx, artist_ctx)
    if not use_lazy_momentum(cfg):
        return e
    kw = dict(lr=cfg.learning_rate, mu=cfg.momentum, step=state.step)
    catchup = torch.cat([
        momentum_catchup_rows(
            state.opt_state["album"],
            torch.remainder(album_ctx, cfg.album_hash_buckets).reshape(-1),
            **kw),
        momentum_catchup_rows(state.opt_state["artist"],
                              artist_ctx.reshape(-1), **kw)], dim=-1)
    return e + catchup.reshape(e.shape)


def make_eval_topk(model: PlaylistModel, cfg: PlaylistConfig, corpus: Batch):
    """(state, batch, corpus_embed=None) -> (top_vals (B, k), top_idx
    (B, k) int64): each playlist's top ``eval_k`` corpus items by affinity
    to its context. Exact: corpus blocks streamed through
    ``chunked_grouped_topk`` (or ``chunked_topk`` at ``eval_group=0``),
    large batches in query chunks. Fused: per-bin top-2 candidates from
    the affinity kernel, then an exact float32 rescore of the best
    ``eval_k`` (a matmul with TF32 off; the eval raises if TF32 is on).
    ``corpus_embed`` is the round's setup output, computed here when
    absent."""
    num_items = int(corpus["tracks"].shape[0])
    block = _corpus_block(cfg, num_items)
    pad = pad_to_multiple(num_items, block) - num_items
    albums_p = F.pad(corpus["albums"], (0, pad))
    artists_p = F.pad(corpus["artists"], (0, pad))
    setup = make_corpus_embed_setup(model, cfg, corpus)

    def eval_topk(state: TrainState, batch: Batch, corpus_embed=None):
        if corpus_embed is None:
            corpus_embed = setup(state)
        packed = None
        if cfg.eval_fused_bins:
            corpus_embed, packed = corpus_embed
        require_full_f32(corpus_embed)
        album_ctx = batch["album_context"]
        artist_ctx = batch["artist_context"]
        with torch.no_grad():
            ctx_embed = _settled_ctx_embed(state, cfg, album_ctx, artist_ctx)

        def topk_chunk(ctx_embed, album_ctx, artist_ctx):
            def score_block(start):
                stop = start + block
                return affinity_scores(
                    ctx_embed, corpus_embed[start:stop], albums_p[start:stop],
                    artists_p[start:stop], album_ctx, artist_ctx)

            def score_items(cand):  # (Bq, n) corpus rows, exact rescore
                rows = gather_rows(corpus_embed, cand.reshape(-1))
                return affinity_scores(
                    ctx_embed, rows.reshape(cand.shape + (-1,)),
                    albums_p[cand], artists_p[cand], album_ctx, artist_ctx)

            if cfg.eval_fused_bins:
                vals2, ids2 = binned_affinity_candidates(
                    ctx_embed, packed, corpus["albums"], corpus["artists"],
                    album_ctx, artist_ctx, num_items,
                    num_bins=_eval_fused_bins(cfg))
                k_eff = min(cfg.eval_k, num_items)
                bvals, sel = topk_lower_index_first(vals2, k_eff)
                cand = torch.gather(ids2, -1, sel).long()
                exact = torch.where(torch.isfinite(bvals), score_items(cand),
                                    NEG_INF)
                top_vals, order = topk_lower_index_first(exact, k_eff)
                return pad_topk(top_vals, torch.gather(cand, -1, order),
                                cfg.eval_k)
            if cfg.eval_group:
                return chunked_grouped_topk(score_block, score_items,
                                            num_items, cfg.eval_k,
                                            group=cfg.eval_group)
            return chunked_topk(score_block, num_items, cfg.eval_k)

        with torch.no_grad():
            B = ctx_embed.shape[0]
            # the fused kernel tiles its queries itself
            Bq = B if cfg.eval_fused_bins else min(
                B, _eval_query_chunk(cfg, block))
            parts = [topk_chunk(ctx_embed[i:i + Bq], album_ctx[i:i + Bq],
                                artist_ctx[i:i + Bq])
                     for i in range(0, B, Bq)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return eval_topk


def make_eval_step(model: PlaylistModel, cfg: PlaylistConfig, corpus: Batch):
    """(state, batch, corpus_embed=None) -> recall/MRR/NDCG@k of the
    playlists' next tracks and artists against the full corpus (see
    :func:`make_eval_topk`)."""
    eval_topk = make_eval_topk(model, cfg, corpus)

    def eval_step(state: TrainState, batch: Batch, corpus_embed=None):
        top_vals, top_idx = eval_topk(state, batch, corpus_embed)
        return _hit_metrics(batch, top_vals, top_idx, corpus["tracks"],
                            corpus["artists"], cfg.eval_k)

    return eval_step


def _hit_metrics(batch: Batch, top_vals: torch.Tensor, top_idx: torch.Tensor,
                 tracks: torch.Tensor, artists: torch.Tensor, k: int):
    """Membership of the rank-ordered retrieved items in each playlist's
    next set -> recall/MRR/NDCG. Padded top-k slots (-inf) never hit."""
    top_tracks = tracks[top_idx]
    top_artists = artists[top_idx]
    valid = torch.isfinite(top_vals)
    m = batch["next_mask"]
    denom = m.sum(-1).clamp(min=1.0)
    hit_tracks = valid & batched_isin(
        top_tracks, torch.where(m > 0, batch["next_track"], -1))
    hit_artists = valid & batched_isin(
        top_artists, torch.where(m > 0, batch["next_artist"], -1))
    out = ranking_metrics(hit_tracks, denom, k, "track")
    # artist NDCG is ill-posed (one artist satisfies many slots)
    out.update(ranking_metrics(hit_artists, denom, k, "artist", ndcg=False))
    return out



# ------------------------------------------------------------------ wiring

def export_metadata(cfg: PlaylistConfig) -> Dict[str, object]:
    """The artifact metadata of a playlist model, as the reference writes
    it: the widths, and the logical (unpadded) row counts of the tables
    (rows past them are alignment padding that consumers slice off)."""
    return {"feature_size": cfg.feature_size,
            "album_hash_buckets": cfg.album_hash_buckets,
            "num_artists": cfg.num_artists,
            "valid_rows": {"album_embed": cfg.album_hash_buckets,
                           "artist_embed": cfg.num_artists}}


def restore_adapt_carrier(ckpt: Checkpointer, state_template: TrainState,
                          cfg: PlaylistConfig) -> TrainState:
    """Restore the latest checkpoint into ``state_template``, converting
    the row-sparse momentum state when the checkpoint was written under
    the other carrier. Both conversions are exact: lazy to dense settles
    every row (:func:`settle_momentum_state`, after which the buffers are
    the dense trajectory's) and drops ``last_step``; dense to lazy adds
    ``last_step = step`` (dense rows are always settled). The template's
    tensors receive the result. A checkpoint that fits neither carrier
    raises ``ValueError``."""
    try:
        return ckpt.restore(state_template)
    except ValueError:
        if not (cfg.sparse_updates and cfg.momentum):
            raise
    lazy = use_lazy_momentum(cfg)
    other = dataclasses.replace(cfg,
                                momentum_carrier="dense" if lazy else "lazy")
    os_ = state_template.opt_state
    # the template's momentum buffers, with or without last_step rows
    tmpl = {t: {"momentum": os_[t]["momentum"]} for t in os_}
    if not lazy:  # the checkpoint holds the lazy carrier
        for t in os_:
            m = os_[t]["momentum"]
            tmpl[t]["last_step"] = torch.zeros(
                (m.shape[0],), dtype=torch.int32, device=m.device)
    st = ckpt.restore(TrainState(step=0, params=state_template.params,
                                 opt_state=tmpl))
    if lazy:
        for t in os_:
            os_[t]["last_step"].fill_(st.step)
    else:
        settle_momentum_state(st, other)
    state_template.step = st.step
    log.info("adapted checkpoint opt_state from the %s momentum carrier to "
             "the configured one", other.momentum_carrier)
    return state_template


def validate_batch(batch, num_tracks: int, num_albums: int,
                   num_artists: int) -> None:
    """Input range checks of a batch's context ids (the reference runs
    them on the first batch); out-of-range ids raise ``ValueError``."""
    for key, bound in (("track_context", num_tracks),
                       ("album_context", num_albums),
                       ("artist_context", num_artists)):
        top = int(np.max(batch[key]))
        if top >= bound:
            raise ValueError(f"{key} holds id {top} >= {bound}")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """A numpy batch on ``device``: on a card through pinned host memory
    with ``non_blocking`` copies, so the copy overlaps the host's next
    work."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def train(cfg: PlaylistConfig, tracker=None, corpus_np=None, device=None,
          *, preemption=None,
          hooks: Sequence[Callable[[TrainState, int], None]] = ()
          ) -> FitResult:
    """Train from ``cfg.train_pattern`` to the absolute step
    ``cfg.max_steps``, then export ``<work_dir>/artifacts/playlist-<step>
    .npz``.

    A pattern ending in ``.npz`` reads packed shards
    (``data/pipelines.packed_playlist_batches``, shuffled), any other
    TFRecords (``playlist_batches`` with a 1,000-example shuffle buffer).
    One batch is pulled for the shape and id-range checks and dropped.
    Eval rounds run ``max(1, eval_steps // batch_size)`` batches of
    ``test_pattern``; checkpoints go to ``<work_dir>/checkpoints`` every
    ``checkpoint_every_steps`` and at the end. With ``resume`` the run
    continues from the latest checkpoint, and its input stream starts
    again from its seed, as the reference's does. ``corpus_np`` (tracks,
    albums, artists and the three ``num_*`` counts) defaults to
    ``load_track_corpus`` of ``all_tracks`` and ``dictionaries``.
    ``preemption`` defaults to ``cfg.graceful_shutdown``; pass a managed
    ``PreemptionGuard`` to stop the run from outside. ``hooks`` run as
    ``hook(state, step)`` after every step. A preempted run skips the
    export. Runs on ``device`` (default: the card).
    """
    if cfg.n_model_shards > 1:
        raise NotImplementedError(
            "n_model_shards > 1 (sharded tables and eval) is not ported yet "
            "(ROADMAP queue 1 item 8, multi-device)")
    device = resolve_device(device)
    if corpus_np is None:
        corpus_np = pipelines.load_track_corpus(
            cfg.all_tracks,
            f"{cfg.dictionaries}/track_uri_dict.json",
            f"{cfg.dictionaries}/album_uri_dict.json",
            f"{cfg.dictionaries}/artist_uri_dict.json")
    corpus = {k: torch.from_numpy(v).to(device)
              for k, v in corpus_np.items() if isinstance(v, np.ndarray)}
    model, state = init_state(cfg, device)

    ckpt = Checkpointer(f"{cfg.work_dir}/checkpoints")
    if cfg.resume and ckpt.latest_step() is not None:
        state = restore_adapt_carrier(ckpt, state, cfg)
        log.info("resumed from step %d", state.step)

    own_tracker = tracker is None
    if own_tracker:
        tracker = make_tracker(run_dir=cfg.work_dir,
                               config=config_lib.to_dict(cfg))

    def make_iter(pattern, shuf):
        if pattern.endswith(".npz"):  # ETL-packed shards
            return pipelines.packed_playlist_batches(
                pattern, batch_size=cfg.batch_size, shuffle=shuf > 0,
                seed=cfg.seed)
        return pipelines.playlist_batches(
            pattern, context_size=cfg.context_size, max_next=cfg.max_next,
            batch_size=cfg.batch_size, shuffle_buffer=shuf, seed=cfg.seed)

    train_iter = make_iter(cfg.train_pattern, 1000)
    first = next(train_iter)
    if first["next_track"].shape != (cfg.batch_size, cfg.max_next):
        raise ValueError(
            f"batch shape {first['next_track'].shape} != config "
            f"({cfg.batch_size}, {cfg.max_next}): packed shards carry their "
            "own max_next (pack_max_next at ETL time); set max_next to match")
    validate_batch(first, corpus_np["num_tracks"], corpus_np["num_albums"],
                   corpus_np["num_artists"])

    step_fn = select_train_step(model, cfg, corpus, seed=cfg.seed)
    eval_fn = make_eval_step(model, cfg, corpus)
    try:
        result = fit(
            state,
            lambda st, batch: step_fn(st, to_device(batch, device)),
            train_iter,
            num_steps=cfg.max_steps,
            eval_step=lambda st, batch, aux: eval_fn(
                st, to_device(batch, device), aux),
            eval_setup_fn=make_corpus_embed_setup(model, cfg, corpus),
            eval_iter_fn=lambda: make_iter(cfg.test_pattern, 0),
            eval_every=cfg.eval_every_steps,
            eval_steps=max(1, cfg.eval_steps // cfg.batch_size),
            log_every=cfg.log_every_steps,
            tracker=tracker,
            checkpointer=ckpt,
            checkpoint_every=cfg.checkpoint_every_steps,
            hooks=hooks,
            hook_every=1,
            examples_per_step=cfg.batch_size,
            preemption=(cfg.graceful_shutdown if preemption is None
                        else preemption),
        )
        if not log_if_preempted(result, log):
            export_model(cfg.work_dir, "playlist",
                         settled_params(result.state, cfg),
                         step=result.state.step, tracker=tracker,
                         metadata=export_metadata(cfg))
        return result
    finally:
        if own_tracker:
            tracker.finish()


def main(argv=None) -> FitResult:
    """``python -m esrecsys_tpu_torch.workloads.playlist --field value
    ... [--device cpu]``: every ``PlaylistConfig`` field is a flag."""
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, _ = p.parse_known_args(argv)
    cfg = config_lib.from_cli(PlaylistConfig, argv)
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
