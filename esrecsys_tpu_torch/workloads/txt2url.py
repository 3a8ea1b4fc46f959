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
order over whole tables), then the projections. Not ported:
``n_model_shards > 1`` (sharded tables raise) and per-process file
slices.

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
from esrecsys_tpu_torch.core.device import array_to_device, resolve_device
from esrecsys_tpu_torch.core.tracking import make_tracker
from esrecsys_tpu_torch.data import pipelines
from esrecsys_tpu_torch.data.vocab import Vocabulary, simple_tokenize
from esrecsys_tpu_torch.models.txt2url import Txt2UrlModel, max_norm_project
from esrecsys_tpu_torch.ops import losses
from esrecsys_tpu_torch.ops.metrics import ranking_metrics
from esrecsys_tpu_torch.ops.optim import exponential_decay, rmsprop_update
from esrecsys_tpu_torch.retrieval.mips import top_ids_lower_index_first
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
    n_model_shards: int = 1         # > 1 (sharded tables) raises
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


def make_train_step(model: Txt2UrlModel, cfg: Txt2UrlConfig):
    """The step: both losses, their sum's gradients, RMSprop on every
    parameter at the schedule's rate, then the max-norm projections of the
    word and URL tables. Updates ``state`` in place."""

    def train_step(state: TrainState, batch: Batch):
        params = state.params
        for p in params.parameters():
            p.grad = None
        text_loss, url_loss = _objective_losses(params, cfg, batch)
        loss = text_loss + url_loss
        loss.backward()
        lr = learning_rate(cfg, state.step)
        nu = state.opt_state["nu"]
        with torch.no_grad():
            for name, p in params.named_parameters():
                rmsprop_update(p, p.grad, {"nu": nu[name]}, lr=lr)
                p.grad = None
            for table, cap in ((params.encoder.word_embedding.embedding,
                                cfg.word_max_norm),
                               (params.url_embedding.embedding,
                                cfg.url_max_norm)):
                max_norm_project(table, cap, out=table)
        state.step += 1
        return state, {"loss": loss.detach(),
                       "text_loss": text_loss.detach(),
                       "url_loss": url_loss.detach()}

    return train_step


def make_eval_step(model: Txt2UrlModel, cfg: Txt2UrlConfig):
    """Both objectives' losses and, with ``eval_recall_k``, recall@k and
    MRR@k of each text's own URL among the top k of the whole URL table
    (ties to the lower row, as ``lax.top_k``)."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, float]:
        with torch.no_grad():
            text_loss, url_loss = _objective_losses(state.params, cfg,
                                                    batch)
            metrics = {"loss": text_loss + url_loss, "text_loss": text_loss,
                       "url_loss": url_loss}
            if cfg.eval_recall_k:
                scores = state.params.score_text_vs_all(batch["tokens"])
                top = top_ids_lower_index_first(scores, cfg.eval_recall_k)
                hit = top == batch["url_near_text"][:, None].long()
                rm = ranking_metrics(
                    hit, torch.ones(hit.shape[0], device=hit.device),
                    cfg.eval_recall_k, "url", ndcg=False)
                metrics["recall_at_k"] = rm["url_recall"]
                metrics["mrr_at_k"] = rm["url_mrr"]
        return metrics

    return eval_step


def load_glove_word_embeddings(model: Txt2UrlModel,
                               table: np.ndarray) -> None:
    """Copy a GloVe token table into the word table in place; its rows
    past the word table's (GloVe pads its tables to a multiple of 128
    rows) are dropped."""
    target = model.encoder.word_embedding.embedding
    if table.shape[1] != target.shape[1] or table.shape[0] < target.shape[0]:
        raise ValueError(f"glove table {table.shape} != word table "
                         f"{tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(np.ascontiguousarray(
            table[:target.shape[0]], np.float32)))


def glove_checkpoint_table(directory: str) -> Tuple[int, np.ndarray]:
    """(step, token table) of the latest checkpoint of the port's GloVe
    trainer in ``directory``, under either optimizer."""
    ckpt = Checkpointer(directory)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    with np.load(ckpt.path(step)) as z:
        return step, z["params/token_embedding/embedding"]


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
        table = state.params.encoder.word_embedding.embedding
        with torch.no_grad():
            q = table[torch.tensor(index, device=table.device)]
            scores = q @ table.T
            top_i = top_ids_lower_index_first(scores, k)
            top_s = torch.gather(scores, -1, top_i)
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
        device = state.params.url_embedding.embedding.device
        with torch.no_grad():
            scores = state.params.score_text_vs_all(
                torch.from_numpy(tokens).to(device))
            top_i = top_ids_lower_index_first(scores, k)
            top_s = torch.gather(scores, -1, top_i)
        _log_neighbours("sentence_nn", step, name,
                        [repr(s) for s in sentences], top_s.cpu().numpy(),
                        top_i.cpu().numpy())

    return hook


def init_state(cfg: Txt2UrlConfig, word_vocab_size: int,
               url_vocab_size: int, device=None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Txt2UrlModel, TrainState]:
    """The model (tables of exactly the vocabulary sizes) initialised from
    ``generator`` (default: seeded with ``cfg.seed`` on the device), and
    its train state: RMSprop's zero ``nu`` per parameter,
    ``opt_state["nu"][name]``."""
    device = resolve_device(device)
    if cfg.text_objective not in OBJECTIVES:
        raise ValueError(f"unknown text_objective {cfg.text_objective!r}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    model = Txt2UrlModel(word_vocab_size, url_vocab_size, cfg.word_dim,
                         cfg.rnn_size, cfg.url_dim, cfg.encoder_type,
                         device=device, generator=generator)
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
    ``device`` (default: the card)."""
    if cfg.n_model_shards > 1:
        raise NotImplementedError(
            "n_model_shards > 1 (sharded tables) is not ported yet "
            "(ROADMAP queue 1, multi-device)")
    device = resolve_device(device)
    if token_vocab is None:
        token_vocab = Vocabulary.load(cfg.token_dictionary)
    if title_vocab is None:
        title_vocab = Vocabulary.load(cfg.title_dictionary)
    doc_freq = np.asarray([title_vocab.doc_frequency(i)
                           for i in range(len(title_vocab))], np.float64)
    model, state = init_state(cfg, token_vocab.num_embeddings,
                              len(title_vocab), device)
    if cfg.glove_checkpoint:
        step, table = glove_checkpoint_table(cfg.glove_checkpoint)
        load_glove_word_embeddings(model, table)
        log.info("transferred GloVe word embeddings from %s (step %d)",
                 cfg.glove_checkpoint, step)

    ckpt = Checkpointer(f"{cfg.work_dir}/checkpoints")
    if cfg.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        log.info("resumed from step %d", state.step)

    own_tracker = tracker is None
    if own_tracker:
        tracker = make_tracker(run_dir=cfg.work_dir,
                               config=config_lib.to_dict(cfg))
    batches = pipelines.txt2url_batches(
        cfg.txt2url_pattern, cfg.url2url_pattern, doc_freq, cfg.batch_size,
        cfg.sentence_length, cfg.max_sentences_per_doc,
        shuffle_buffer=cfg.shuffle_buffer, seed=cfg.seed)
    hooks = []
    if cfg.probe_words:
        hooks.append(word_nn_hook(token_vocab, cfg.probe_words.split(",")))
    if cfg.probe_sentences:
        hooks.append(sentence_nn_hook(token_vocab, title_vocab,
                                      cfg.probe_sentences.split("|"),
                                      cfg.sentence_length))
    step_fn = make_train_step(model, cfg)
    eval_kwargs = {}
    if cfg.eval_txt2url_pattern:
        eval_fn = make_eval_step(model, cfg)
        eval_kwargs = dict(
            eval_step=lambda st, b: eval_fn(st, to_device(b, device)),
            eval_iter_fn=lambda: pipelines.txt2url_batches(
                cfg.eval_txt2url_pattern,
                cfg.eval_url2url_pattern or cfg.url2url_pattern, doc_freq,
                cfg.batch_size, cfg.sentence_length,
                cfg.max_sentences_per_doc, shuffle_buffer=0,
                seed=cfg.seed),
            eval_every=cfg.eval_every_steps, eval_steps=cfg.eval_steps)
    try:
        result = fit(
            state,
            lambda st, b: step_fn(st, to_device(b, device)),
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
            preemption=(cfg.graceful_shutdown if preemption is None
                        else preemption),
        )
        if not log_if_preempted(result, log):
            export_model(cfg.work_dir, "txt2url", result.state.params,
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
