"""Text -> URL retrieval workload (counterpart of
``esrecsys_tpu/workloads/txt2url.py``): the sentence encoder against the
URL table under the margin (or softmax, or the reference's all-pairs)
objective, plus the url2url head regressing sqrt(dice); RMSprop with a
staircase learning-rate decay per ``steps_per_epoch``; max-norm
projections of both tables after each update; GloVe word-embedding
transfer; the word and sentence probe hooks; a held-out eval with
recall@k over the whole URL table; checkpoints, resume, preemption and
the exported ``txt2url`` artifact, on the shared harness
(``train/loop.py`` ``fit``).

The step: autograd through the lookups (the row-gather kernel forward,
a row scatter into table-shaped gradients backward), then
``ops/optim.rmsprop_update`` on every parameter (optax's ``rmsprop``
order over whole tables), then the projections.

On a mesh (``train()`` under ``torchrun``; ``make_mesh_for_batch`` with
``n_model_shards`` model shards): the word and URL tables are row-sharded
(rows padded to the model axis, as the reference pads them) and looked
up owner-computes with autograd; each data row differentiates its share
of the global mean loss, RMSprop sums every gradient over the data axis
first (``rows_sharded``), the projections run on the shards; recall@k
over all URLs and both probe hooks run ``mips.sharded_scored_topk``
(padding rows never return); the GloVe transfer fills the sharded word
table; checkpoints are per rank, and rank 0 exports the whole model.

Run: python -m esrecsys_tpu_torch.workloads.txt2url \
         --txt2url_pattern 'txt2url/part-*' --url2url_pattern 'url_cooc/part-*' \
         --token_dictionary tokens.bz2 --title_dictionary titles.bz2 \
         --work_dir runs/txt2url [--glove_checkpoint runs/glove/checkpoints] [--device cpu]
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

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.core.device import array_to_device, resolve_device
from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.core.tracking import make_tracker
from esrecsys_tpu_torch.data import pipelines
from esrecsys_tpu_torch.data.vocab import Vocabulary, simple_tokenize
from esrecsys_tpu_torch.models.layers import TableEmbed, whole_state_dict
from esrecsys_tpu_torch.models.txt2url import Txt2UrlModel, max_norm_project
from esrecsys_tpu_torch.ops import losses
from esrecsys_tpu_torch.ops.metrics import ranking_metrics
from esrecsys_tpu_torch.ops.optim import exponential_decay, rmsprop_update
from esrecsys_tpu_torch.retrieval.mips import (require_full_f32,
                                               sharded_scored_topk,
                                               top_ids_lower_index_first)
from esrecsys_tpu_torch.convert import params_to_jax
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.train.export import export_model
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.preemption import log_if_preempted
from esrecsys_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

OBJECTIVES = ("margin", "softmax", "reference_exact")
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Txt2UrlConfig:
    """The reference's fields and defaults (``work_dir`` defaults to
    ``txt2url`` under the temporary directory)."""

    txt2url_pattern: str = ""
    url2url_pattern: str = ""
    token_dictionary: str = ""
    title_dictionary: str = ""
    work_dir: str = os.path.join(tempfile.gettempdir(), "txt2url")
    word_dim: int = 64
    rnn_size: int = 64
    url_dim: int = 64
    encoder_type: str = "lstm"      # lstm | mean
    sentence_length: int = 32
    max_sentences_per_doc: int = 4
    batch_size: int = 64
    shuffle_buffer: int = 10_000
    learning_rate: float = 1e-3
    learning_rate_decay: float = 0.9   # per steps_per_epoch, staircase
    steps_per_epoch: int = 10_000
    num_epochs: int = 10
    margin: float = 1.0
    word_max_norm: float = 3.0
    url_max_norm: float = 3.0
    # margin (matching pairs) | softmax (in-batch) | reference_exact (the
    # reference's (B, B) all-pairs losses of both heads)
    text_objective: str = "margin"
    glove_checkpoint: str = ""      # a GloVe checkpoint directory
    n_model_shards: int = 1         # the mesh's model axis (torchrun ranks)
    eval_txt2url_pattern: str = ""  # held-out docs; "" = no eval
    eval_url2url_pattern: str = ""  # defaults to url2url_pattern
    eval_every_steps: int = 10_000
    eval_steps: int = 16
    eval_recall_k: int = 10         # recall@k over the whole URL table; 0
    seed: int = 0
    resume: bool = False
    # SIGTERM -> a stop at the next step, a checkpoint and a clean exit
    graceful_shutdown: bool = True
    probe_words: str = ""           # comma-separated
    probe_sentences: str = ""       # "|"-separated


def _objective_losses(model: Txt2UrlModel, cfg: Txt2UrlConfig,
                      batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(text_loss, url_loss) under ``cfg.text_objective``; the train and
    eval steps share it."""
    if cfg.text_objective == "reference_exact":
        # the mean over B^2 entries of square(relu(margin - text_i.url_j)),
        # and of (url1_i.url2_j - sqrt_dice_i)^2: the (B,) target broadcast
        # along the last axis, as the reference's Keras graph does
        text_sim, url_sim = model.all_pairs_scores(
            batch["url_near_text"], batch["tokens"], batch["url1"],
            batch["url2"])
        text_loss = torch.mean(torch.square(losses.relu(cfg.margin
                                                        - text_sim)))
        url_loss = torch.mean(torch.square(
            url_sim - batch["sqrt_dice"][:, None]))
        return text_loss, url_loss
    text_score, url_score, text_embed, url_embed = model(
        batch["url_near_text"], batch["tokens"], batch["url1"],
        batch["url2"])
    if cfg.text_objective == "margin":
        text_loss = losses.margin_square_loss(text_score, cfg.margin)
    elif cfg.text_objective == "softmax":
        text_loss = losses.in_batch_softmax(text_embed, url_embed)
    else:
        raise ValueError(f"unknown text_objective {cfg.text_objective!r}")
    url_loss = torch.mean(torch.square(url_score - batch["sqrt_dice"]))
    return text_loss, url_loss


def learning_rate(cfg: Txt2UrlConfig, step: int) -> float:
    """The schedule's learning rate at ``step`` (optax's count)."""
    if cfg.learning_rate_decay < 1.0:
        return exponential_decay(cfg.learning_rate, cfg.steps_per_epoch,
                                 cfg.learning_rate_decay, step)
    return cfg.learning_rate


def _mesh_of(model: Txt2UrlModel) -> Optional[Mesh]:
    return getattr(model, "mesh", None)


def _means(mesh: Optional[Mesh], metrics: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the data rows (as it is without a mesh)."""
    if mesh is None:
        return metrics
    return {k: mesh.mean_data(torch.as_tensor(v, dtype=torch.float32))
            for k, v in metrics.items()}


def top_rows(emb: TableEmbed, queries: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (P, k), rows (P, k)) of a table's ``k`` largest dot
    products with ``queries`` (P, D), largest first, ties to the lower row
    (``lax.top_k``'s order), in full float32; on a sharded table
    ``mips.sharded_scored_topk`` over the shards (a collective of the data
    row), its padding rows never returned."""
    table = emb.embedding
    require_full_f32(table)
    if emb.mesh is None:
        scores = queries @ table.T
        idx = top_ids_lower_index_first(scores, k)
        return torch.gather(scores, -1, idx), idx
    return sharded_scored_topk((queries,), (table,), lambda q, t: q @ t.T,
                               k, emb.mesh, valid_items=emb.num_embeddings)


def make_train_step(model: Txt2UrlModel, cfg: Txt2UrlConfig):
    """The step: both losses, their sum's gradients, RMSprop on every
    parameter at the schedule's rate, then the max-norm projections of the
    word and URL tables. Updates ``state`` in place. On a mesh each data
    row differentiates its share of the global mean loss and RMSprop sums
    each gradient over the data axis first."""
    mesh = _mesh_of(model)
    share = 1.0 / (mesh.n_data if mesh is not None else 1)

    def train_step(state: TrainState, batch: Batch):
        params = state.params
        for p in params.parameters():
            p.grad = None
        text_loss, url_loss = _objective_losses(params, cfg, batch)
        loss = text_loss + url_loss
        (loss * share if share != 1.0 else loss).backward()
        lr = learning_rate(cfg, state.step)
        nu = state.opt_state["nu"]
        with torch.no_grad():
            for name, p in params.named_parameters():
                rmsprop_update(p, p.grad, {"nu": nu[name]}, lr=lr,
                               rows_sharded=mesh)
                p.grad = None
            for table, cap in ((params.encoder.word_embedding.embedding,
                                cfg.word_max_norm),
                               (params.url_embedding.embedding,
                                cfg.url_max_norm)):
                max_norm_project(table, cap, out=table)
        state.step += 1
        return state, _means(mesh, {"loss": loss.detach(),
                                    "text_loss": text_loss.detach(),
                                    "url_loss": url_loss.detach()})

    return train_step


def make_eval_step(model: Txt2UrlModel, cfg: Txt2UrlConfig):
    """Both objectives' losses and, with ``eval_recall_k``, recall@k and
    MRR@k of each text's own URL among the top k of the whole URL table
    (ties to the lower row, as ``lax.top_k``; :func:`top_rows`). On a mesh
    each metric is the data rows' mean."""
    mesh = _mesh_of(model)

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, float]:
        with torch.no_grad():
            text_loss, url_loss = _objective_losses(state.params, cfg,
                                                    batch)
            metrics = {"loss": text_loss + url_loss, "text_loss": text_loss,
                       "url_loss": url_loss}
            if cfg.eval_recall_k:
                _, top = top_rows(state.params.url_embedding,
                                  state.params.encoder(batch["tokens"]),
                                  cfg.eval_recall_k)
                hit = top == batch["url_near_text"][:, None].long()
                rm = ranking_metrics(
                    hit, torch.ones(hit.shape[0], device=hit.device),
                    cfg.eval_recall_k, "url", ndcg=False)
                metrics["recall_at_k"] = rm["url_recall"]
                metrics["mrr_at_k"] = rm["url_mrr"]
        return _means(mesh, metrics)

    return eval_step


def load_glove_word_embeddings(model: Txt2UrlModel,
                               table: np.ndarray) -> None:
    """Copy a (whole) GloVe token table into the word table in place; its
    rows past the word table's (GloVe pads its tables to a multiple of 128
    rows) are dropped. A sharded word table takes its rows of it (rows
    past the GloVe table's, the padding to the model axis, keep their
    init)."""
    emb = model.encoder.word_embedding
    target = emb.embedding
    n = 1 if emb.mesh is None else emb.mesh.n_model
    rows = range(target.shape[0]) if emb.mesh is None else \
        emb.mesh.row_range(target.shape[0] * n)
    if (table.shape[1] != target.shape[1]
            or table.shape[0] < emb.num_embeddings):
        raise ValueError(f"glove table {table.shape} != word table "
                         f"{(emb.num_embeddings, target.shape[1])}")
    stop = min(rows.stop, emb.num_embeddings)
    with torch.no_grad():
        target[:max(0, stop - rows.start)].copy_(torch.from_numpy(
            np.ascontiguousarray(table[rows.start:stop], np.float32)))


def glove_checkpoint_table(directory: str) -> Tuple[int, np.ndarray]:
    """(step, token table) of the latest checkpoint of the port's GloVe
    trainer in ``directory``, under either optimizer, put together from
    the ranks' shards when a mesh wrote it (``glove.checkpoint_table``)."""
    from esrecsys_tpu_torch.workloads.glove import checkpoint_table

    return checkpoint_table(directory)


def _log_neighbours(kind: str, step: int, names, probes, top_s, top_i):
    for i, probe in enumerate(probes):
        log.info("%s step=%d %s: %s", kind, step, probe, " ".join(
            f"{names(int(top_i[i, j]))}:{top_s[i, j]:.3f}"
            for j in range(top_i.shape[1])))


def word_nn_hook(token_vocab: Vocabulary, words: Sequence[str], k: int = 10
                 ) -> Callable[[TrainState, int], None]:
    """A ``fit`` hook logging each probe word's ``k`` nearest rows of the
    word table by dot product."""
    index = [token_vocab.embedding_index(w) for w in words]

    def hook(state: TrainState, step: int) -> None:
        emb = state.params.encoder.word_embedding
        with torch.no_grad():
            q = emb(torch.tensor(index, device=emb.embedding.device))
            top_s, top_i = top_rows(emb, q, k)
        _log_neighbours("word_nn", step,
                        token_vocab.token_from_embedding_index, words,
                        top_s.cpu().numpy(), top_i.cpu().numpy())

    return hook


def sentence_nn_hook(token_vocab: Vocabulary, title_vocab: Vocabulary,
                     sentences: Sequence[str], sentence_length: int,
                     k: int = 10) -> Callable[[TrainState, int], None]:
    """A ``fit`` hook logging each probe sentence's ``k`` nearest URLs;
    a sentence is ``simple_tokenize``d, cut or zero-padded to
    ``sentence_length`` embedding ids."""
    rows = []
    for s in sentences:
        ids = token_vocab.embedding_indices(
            simple_tokenize(s))[:sentence_length]
        rows.append(ids + [0] * (sentence_length - len(ids)))
    tokens = np.asarray(rows, np.int32)

    def name(i: int) -> str:
        return title_vocab.token(i) if i < len(title_vocab) else "?"

    def hook(state: TrainState, step: int) -> None:
        emb = state.params.url_embedding
        with torch.no_grad():
            top_s, top_i = top_rows(emb, state.params.encoder(
                torch.from_numpy(tokens).to(emb.embedding.device)), k)
        _log_neighbours("sentence_nn", step, name,
                        [repr(s) for s in sentences], top_s.cpu().numpy(),
                        top_i.cpu().numpy())

    return hook


def init_state(cfg: Txt2UrlConfig, word_vocab_size: int,
               url_vocab_size: int, device=None,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[Txt2UrlModel, TrainState]:
    """The model (tables of exactly the vocabulary sizes) initialised from
    ``generator`` (default: seeded with ``cfg.seed`` on the device), and
    its train state: RMSprop's zero ``nu`` per parameter,
    ``opt_state["nu"][name]``. With a ``mesh`` the tables' rows are
    padded to the model axis, every rank draws the whole model from the
    seed and keeps its rows of both tables (``model.mesh`` names the
    mesh); ``nu`` is shaped like the rank's parameters."""
    device = resolve_device(device)
    if cfg.text_objective not in OBJECTIVES:
        raise ValueError(f"unknown text_objective {cfg.text_objective!r}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    model = Txt2UrlModel(word_vocab_size, url_vocab_size, cfg.word_dim,
                         cfg.rnn_size, cfg.url_dim, cfg.encoder_type,
                         device=device, generator=generator,
                         rows_multiple=mesh.n_model if mesh else 1)
    model.mesh = mesh
    if mesh is not None:
        model.encoder.word_embedding.shard(mesh)
        model.url_embedding.shard(mesh)
    nu = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
    return model, TrainState(step=0, params=model, opt_state={"nu": nu})


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """A numpy batch of ``txt2url_batches`` on ``device``."""
    return {k: array_to_device(v, device) for k, v in batch.items()}


def export_metadata(cfg: Txt2UrlConfig, word_rows: int,
                    url_rows: int) -> dict:
    """The artifact metadata the reference writes for a txt2url model."""
    return {"word_dim": cfg.word_dim, "url_dim": cfg.url_dim,
            "rnn_size": cfg.rnn_size, "encoder_type": cfg.encoder_type,
            "sentence_length": cfg.sentence_length,
            "valid_rows": {"word_embed": word_rows, "url_embed": url_rows}}


def train(cfg: Txt2UrlConfig, tracker=None, device=None, *,
          token_vocab: Optional[Vocabulary] = None,
          title_vocab: Optional[Vocabulary] = None,
          preemption=None) -> FitResult:
    """Train for ``steps_per_epoch * num_epochs`` steps (absolute) from
    ``txt2url_batches`` of the two patterns, then export
    ``<work_dir>/artifacts/txt2url-<step>.npz``.

    With ``glove_checkpoint`` the word table starts from the latest port
    GloVe checkpoint there. Eval rounds of ``eval_steps`` unshuffled
    batches of ``eval_txt2url_pattern`` (and ``eval_url2url_pattern``,
    default the train pairs) run every ``eval_every_steps``; the probe
    hooks and checkpoints (``<work_dir>/checkpoints``) every epoch and at
    the end. With ``resume`` the run continues from the latest
    checkpoint (its input stream starts again from its seed).
    ``token_vocab`` and ``title_vocab`` default to the dictionaries'
    files; ``preemption`` to ``cfg.graceful_shutdown``. Runs on
    ``device`` (default: the card).

    Under ``torchrun`` (or with ``n_model_shards > 1``, which then needs
    its ranks: too few raise ``ValueError``) the run is one rank of the
    reference's ``make_mesh_for_batch`` grid; ``batch_size`` is the global
    batch."""
    device = resolve_device(device)
    mesh = None
    if (mesh_lib.distributed_init_if_needed(device=device)
            or mesh_lib.is_initialized() or cfg.n_model_shards > 1):
        mesh_lib.check_ranks(cfg.n_model_shards, "txt2url training")
        if mesh_lib.is_initialized():
            device = mesh_lib.rank_device(device)
        mesh = mesh_lib.make_mesh_for_batch(cfg.batch_size,
                                            n_model=cfg.n_model_shards)
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local_bs = mesh_lib.process_local_batch(cfg.batch_size)
    host_seed = cfg.seed + rank
    if token_vocab is None:
        token_vocab = Vocabulary.load(cfg.token_dictionary)
    if title_vocab is None:
        title_vocab = Vocabulary.load(cfg.title_dictionary)
    doc_freq = np.asarray([title_vocab.doc_frequency(i)
                           for i in range(len(title_vocab))], np.float64)
    model, state = init_state(cfg, token_vocab.num_embeddings,
                              len(title_vocab), device, mesh=mesh)
    if cfg.glove_checkpoint:
        step, table = glove_checkpoint_table(cfg.glove_checkpoint)
        load_glove_word_embeddings(model, table)
        log.info("transferred GloVe word embeddings from %s (step %d)",
                 cfg.glove_checkpoint, step)

    ckpt_dir = f"{cfg.work_dir}/checkpoints"
    if world > 1:  # a checkpoint per rank: its shards and replicas
        ckpt_dir = f"{ckpt_dir}/rank-{rank}-of-{world}"
    ckpt = Checkpointer(ckpt_dir)
    if cfg.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        log.info("resumed from step %d", state.step)

    own_tracker = tracker is None
    if own_tracker:
        tracker = make_tracker(run_dir=cfg.work_dir if rank == 0 else
                               f"{cfg.work_dir}/rank-{rank}",
                               config=config_lib.to_dict(cfg))
    batches = pipelines.txt2url_batches(
        cfg.txt2url_pattern, cfg.url2url_pattern, doc_freq, local_bs,
        cfg.sentence_length, cfg.max_sentences_per_doc,
        shuffle_buffer=cfg.shuffle_buffer, seed=host_seed)
    hooks = []
    if cfg.probe_words:
        hooks.append(word_nn_hook(token_vocab, cfg.probe_words.split(",")))
    if cfg.probe_sentences:
        hooks.append(sentence_nn_hook(token_vocab, title_vocab,
                                      cfg.probe_sentences.split("|"),
                                      cfg.sentence_length))
    step_fn = make_train_step(model, cfg)
    place = ((lambda b: b) if mesh is not None
             else (lambda b: to_device(b, device)))
    eval_kwargs = {}
    if cfg.eval_txt2url_pattern:
        eval_fn = make_eval_step(model, cfg)
        eval_kwargs = dict(
            eval_step=lambda st, b: eval_fn(st, place(b)),
            eval_iter_fn=lambda: pipelines.txt2url_batches(
                cfg.eval_txt2url_pattern,
                cfg.eval_url2url_pattern or cfg.url2url_pattern, doc_freq,
                local_bs, cfg.sentence_length,
                cfg.max_sentences_per_doc, shuffle_buffer=0,
                seed=host_seed),
            eval_every=cfg.eval_every_steps, eval_steps=cfg.eval_steps)
    try:
        result = fit(
            state,
            lambda st, b: step_fn(st, place(b)),
            batches,
            num_steps=cfg.steps_per_epoch * cfg.num_epochs,
            log_every=min(1000, cfg.steps_per_epoch),
            **eval_kwargs,
            tracker=tracker,
            checkpointer=ckpt,
            checkpoint_every=cfg.steps_per_epoch,
            hooks=hooks,
            hook_every=cfg.steps_per_epoch,
            examples_per_step=cfg.batch_size,
            mesh=mesh,
            device=device,
            preemption=(cfg.graceful_shutdown if preemption is None
                        else preemption),
        )
        if not log_if_preempted(result, log):
            params = params_to_jax(whole_state_dict(result.state.params))
            if rank == 0:
                export_model(cfg.work_dir, "txt2url", params,
                             step=result.state.step, tracker=tracker,
                             metadata=export_metadata(
                                 cfg, token_vocab.num_embeddings,
                                 len(title_vocab)))
        return result
    finally:
        if own_tracker:
            tracker.finish()


def main(argv=None) -> FitResult:
    """``python -m esrecsys_tpu_torch.workloads.txt2url --field value ...
    [--device cpu]``: every ``Txt2UrlConfig`` field is a flag."""
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, _ = p.parse_known_args(argv)
    cfg = config_lib.from_cli(Txt2UrlConfig, argv)
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
