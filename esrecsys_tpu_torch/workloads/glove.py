"""GloVe co-occurrence embedding workload (counterpart of
``esrecsys_tpu/workloads/glove.py``): weighted squared error on
log10(1 + count) over ``CooccurrenceRow`` shards, with nearest-neighbour
dumps of probe terms, on the shared harness (``train/loop.py`` ``fit``).

Ported: ``GloveConfig`` (the reference's fields and defaults but
``steps_per_call``, a TPU dispatch trick; ``work_dir`` defaults to
``glove`` under the temporary directory), the dense step (autograd
through the lookups, then Adam in optax's order over whole tables), the
row-sparse LazyAdam step in the logical layout (``ops/optim.py``),
``select_train_step``, ``make_eval_step``, ``init_state`` (tables padded
to a multiple of 128 rows), ``knn`` (``lax.top_k``'s order: ties to the
lower row), ``knn_hook``, ``train()`` with eval, hooks, checkpoints,
resume and preemption, the exported ``glove`` artifact with the
reference's metadata, and the CLI. The lookups gather rows through the
row-gather kernel and scatter gradients through the scatter-add kernel.

On a mesh (``train()`` under ``torchrun``, ``n_model_shards`` model
shards): both tables are row-sharded (``parallel/table.py``), padded as the
reference pads them, so sharded and unsharded states have the same rows;
a data row's batch is gathered from its ranks' slices (each rank reads its
slice of the files, seed ``seed + rank``); the dense step sums each
shard's gradient over the data axis before Adam, the lazy step applies
every data row's rows (``ops/optim.py`` ``rows_sharded``); the knn hook
runs ``mips.sharded_scored_topk`` (``lax.top_k``'s tie order); each rank
checkpoints its shards under ``checkpoints/rank-<r>-of-<n>`` (with the
grid in ``checkpoints/mesh.json``), and rank 0 exports the whole tables.

Not ported: the 128-lane packed LazyAdam layout (a TPU layout trick).

Run: python -m esrecsys_tpu_torch.workloads.glove \
         --train_pattern 'shards/*.bz2' --token_dictionary dict.bz2 \
         --work_dir runs/glove [--optimizer lazy_adam] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.core.device import (array_to_device, pad_to_multiple,
                                           resolve_device)
from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.core.tracking import make_tracker
from esrecsys_tpu_torch.data import pipelines
from esrecsys_tpu_torch.data.vocab import Vocabulary
from esrecsys_tpu_torch.models.glove import Glove
from esrecsys_tpu_torch.models.layers import whole_state_dict
from esrecsys_tpu_torch.ops import guards
from esrecsys_tpu_torch.ops.losses import glove_loss
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.optim import (adam_init, adam_update,
                                          lazy_adam_update)
from esrecsys_tpu_torch.parallel import table as table_lib
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, require_full_f32,
                                               sharded_scored_topk,
                                               top_ids_lower_index_first)
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.train.export import export_model
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.preemption import log_if_preempted
from esrecsys_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)

TABLES = ("token_embedding", "bias")
# the lazy state's names of the two tables, as the reference keys them
LAZY_KEYS = {"token_embedding": "embedding", "bias": "bias"}


@dataclasses.dataclass(frozen=True)
class GloveConfig:
    """The reference's fields and defaults (its reference run's), but
    ``steps_per_call``."""

    train_pattern: str = ""
    eval_pattern: str = ""  # held-out shards; defaults to train_pattern
    token_dictionary: str = ""
    work_dir: str = os.path.join(tempfile.gettempdir(), "glove")
    feature_size: int = 64
    batch_size: int = 2048
    learning_rate: float = 5e-4
    steps_per_epoch: int = 10000
    num_epochs: int = 100
    shuffle_buffer_size: int = 5_000_000
    seed: int = 12345
    terms: str = "news,apple,computer,physics,math,biology"
    optimizer: str = "adam"  # adam (dense) | lazy_adam (row-lazy)
    eval_every_epochs: int = 1
    eval_steps: int = 50
    checkpoint_every_epochs: int = 5
    n_model_shards: int = 1  # the mesh's model axis (ranks from torchrun)
    resume: bool = False
    # SIGTERM -> a stop at the next step, a checkpoint and a clean exit
    graceful_shutdown: bool = True


Batch = Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]


def init_state(cfg: GloveConfig, num_embeddings: int, device=None,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None) -> Tuple[Glove, TrainState]:
    """The model, its tables padded to a multiple of 128 rows (rows past
    ``num_embeddings`` are unreachable by valid ids and masked out of the
    neighbour lists), initialised from ``generator`` (default: seeded with
    ``cfg.seed`` on the device), and its train state: Adam's zero ``mu``
    and ``nu`` per table (``{"token_embedding": {"mu", "nu"}, "bias":
    {...}}``, float32) for ``adam``, the reference's ``{"embedding": {"m",
    "v"}, "bias": {"m", "v"}}`` for ``lazy_adam``.

    With a ``mesh`` the rows are padded on to a multiple of the model axis
    (as the reference's ``TableEmbed`` pads the 128-row table), every rank
    draws the whole tables from the same seed and keeps its row-shard,
    and the state is the shard's; ``model.mesh`` names the mesh."""
    if cfg.optimizer not in ("adam", "lazy_adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    rows = pad_to_multiple(num_embeddings, 128)
    if mesh is not None:
        rows = pad_to_multiple(rows, mesh.n_model)
    model = Glove(rows, cfg.feature_size, valid_rows=num_embeddings,
                  device=device, generator=generator)
    model.mesh = mesh
    if mesh is not None:
        for name in TABLES:
            getattr(model, name).shard(mesh)
    tables = {name: getattr(model, name).embedding for name in TABLES}
    if cfg.optimizer == "lazy_adam":
        opt_state = {LAZY_KEYS[n]: adam_init(t) for n, t in tables.items()}
    else:
        opt_state = {n: {k: torch.zeros_like(t) for k in ("mu", "nu")}
                     for n, t in tables.items()}
    return model, TrainState(step=0, params=model, opt_state=opt_state)


def _data_share(model: Glove) -> Tuple[Optional[Mesh], float]:
    """(the model's mesh, the weight of a data row's mean loss in the
    global batch's: 1 / n_data)."""
    mesh = getattr(model, "mesh", None)
    return mesh, 1.0 / (mesh.n_data if mesh is not None else 1)


def _mean_loss(mesh: Optional[Mesh], loss: torch.Tensor) -> torch.Tensor:
    return loss if mesh is None else mesh.mean_data(loss)


def make_train_step(model: Glove, cfg: GloveConfig):
    """The dense step: autograd through the lookups (a row scatter into
    table-shaped gradients), then ``optax.adam(lr)`` on every row of both
    tables (``ops/optim.adam_update``). Updates ``state`` in place. On a
    mesh the lookups are owner-computes, each data row differentiates its
    share of the global mean loss, and Adam sums the shard's gradients
    over the data axis first."""
    lr = cfg.learning_rate
    mesh, share = _data_share(model)

    def train_step(state: TrainState, batch: Batch):
        (t1, t2), count = batch
        for p in state.params.parameters():
            p.grad = None
        loss = glove_loss(state.params((t1, t2)), count)
        (loss * share if share != 1.0 else loss).backward()
        with torch.no_grad():
            for name in TABLES:
                p = getattr(state.params, name).embedding
                adam_update(p, p.grad, state.opt_state[name], lr=lr,
                            step=state.step, rows_sharded=mesh)
                p.grad = None
        state.step += 1
        return state, {"loss": _mean_loss(mesh, loss.detach())}

    return train_step


def make_lazy_adam_train_step(model: Glove, cfg: GloveConfig):
    """The row-sparse step: gather the batch's token and bias rows once,
    differentiate the loss with respect to those rows, and LazyAdam-update
    the touched rows only (``ops/optim.lazy_adam_update``: moments and
    rows of the rows the step touched, the bias correction of the global
    step; TF's LazyAdam, not dense Adam). Updates ``state`` in place. On a
    mesh each shard gathers the rows it owns and the parts are summed over
    the data row; each rank applies every data row's updates of its
    rows."""
    lr = cfg.learning_rate
    mesh, share = _data_share(model)

    def rows_of(table, ids):
        if mesh is None:
            return gather_rows(table, ids)
        return table_lib.lookup(table, ids, mesh, ids_data_sharded=False)

    def train_step(state: TrainState, batch: Batch):
        (t1, t2), count = batch
        b = t1.shape[0]
        ids = guards.check_ids(torch.cat([t1, t2]).to(torch.int32),
                               model.num_embeddings, "token_embedding")
        t_emb = state.params.token_embedding.embedding
        t_bias = state.params.bias.embedding
        with torch.no_grad():
            rows_e = rows_of(t_emb, ids)
            rows_b = rows_of(t_bias, ids)
        rows_e.requires_grad_()
        rows_b.requires_grad_()
        pred = ((rows_e[:b] * rows_e[b:]).sum(-1) + rows_b[:b, 0]
                + rows_b[b:, 0])
        loss = glove_loss(pred, count)
        g_e, g_b = torch.autograd.grad(loss * share if share != 1.0
                                       else loss, (rows_e, rows_b))
        with torch.no_grad():
            lazy_adam_update(t_emb, state.opt_state["embedding"], ids, g_e,
                             lr=lr, step=state.step, rows_sharded=mesh)
            lazy_adam_update(t_bias, state.opt_state["bias"], ids, g_b,
                             lr=lr, step=state.step, rows_sharded=mesh)
        state.step += 1
        return state, {"loss": _mean_loss(mesh, loss.detach())}

    return train_step


def select_train_step(model: Glove, cfg: GloveConfig):
    if cfg.optimizer == "lazy_adam":
        return make_lazy_adam_train_step(model, cfg)
    if cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return make_train_step(model, cfg)


def make_eval_step(model: Glove):
    mesh, _ = _data_share(model)

    def eval_step(state: TrainState, batch: Batch):
        (t1, t2), count = batch
        with torch.no_grad():
            return {"loss": _mean_loss(mesh, glove_loss(
                state.params((t1, t2)), count))}

    return eval_step


def knn(state: TrainState, tokens: torch.Tensor, k: int = 10,
        valid_rows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, ids), each (P, k) numpy: the ``k`` rows of largest
    embedding dot product with each token, largest first, ties to the
    lower row (``lax.top_k``'s order); rows at or past ``valid_rows`` are
    padding and never returned. On a mesh it is
    ``mips.sharded_scored_topk`` over the shards (a collective of the data
    row)."""
    mesh = getattr(state.params, "mesh", None)
    if mesh is not None:
        emb = state.params.token_embedding
        require_full_f32(emb.embedding)
        with torch.no_grad():
            top, idx = sharded_scored_topk(
                (emb(tokens),), (emb.embedding,), lambda q, t: q @ t.T, k,
                mesh, valid_items=valid_rows)
        return top.cpu().numpy(), idx.cpu().numpy()
    with torch.no_grad():
        scores = state.params.score_all(tokens)
        if valid_rows is not None and valid_rows < scores.shape[-1]:
            scores[:, valid_rows:] = NEG_INF
        idx = top_ids_lower_index_first(scores, k)
        top = torch.gather(scores, -1, idx)
    return top.cpu().numpy(), idx.cpu().numpy()


def knn_hook(vocab: Vocabulary, probe_tokens: Sequence[str], k: int = 10
             ) -> Callable[[TrainState, int], None]:
    """A ``fit`` hook logging each probe token's ``k`` nearest rows."""
    index = [vocab.embedding_index(t) for t in probe_tokens]

    def hook(state: TrainState, step: int) -> None:
        device = state.params.token_embedding.embedding.device
        ids = torch.tensor(index, dtype=torch.int32, device=device)
        top_scores, top_idx = knn(state, ids, k,
                                  valid_rows=vocab.num_embeddings)
        for i, token in enumerate(probe_tokens):
            neighbors = " ".join(
                "%s:%.3f" % (vocab.token_from_embedding_index(
                    int(top_idx[i, j])), top_scores[i, j])
                for j in range(k))
            log.info("knn step=%d %s: %s", step, token, neighbors)

    return hook


def to_device(batch, device: torch.device) -> Batch:
    """A numpy ((token1, token2), count) batch on ``device``
    (``core/device.array_to_device``)."""
    (t1, t2), count = batch
    return ((array_to_device(t1, device), array_to_device(t2, device)),
            array_to_device(count, device))


def _as_dict(batches):
    """((token1, token2), count) batches as the mapping ``Mesh.place``
    assembles a data row's batch from."""
    for (t1, t2), count in batches:
        yield {"token1": t1, "token2": t2, "count": count}


def _from_dict(batch) -> Batch:
    return (batch["token1"], batch["token2"]), batch["count"]


def whole_tables(model: Glove) -> dict:
    """The tables as the reference's nested ``{module: {"embedding":
    array}}`` on the host, gathered whole on a mesh (a collective every
    rank of the data row calls)."""
    sd = whole_state_dict(model)
    return {name: {"embedding": sd[f"{name}.embedding"].cpu().numpy()}
            for name in TABLES}


def export_metadata(cfg: GloveConfig, vocab_rows: int,
                    padded_rows: int) -> dict:
    """The artifact metadata the reference writes for a GloVe model."""
    return {"vocab_rows": vocab_rows, "padded_rows": padded_rows,
            "feature_size": cfg.feature_size,
            "valid_rows": {"token_embedding": vocab_rows,
                           "bias": vocab_rows}}


def train(cfg: GloveConfig, tracker=None,
          vocab: Optional[Vocabulary] = None, device=None, *,
          preemption=None) -> FitResult:
    """Train from ``cfg.train_pattern`` for ``steps_per_epoch *
    num_epochs`` steps (absolute), then export
    ``<work_dir>/artifacts/glove-<step>.npz``.

    Batches come from ``glove_batches`` with the configured shuffle buffer
    and seed; eval rounds of ``eval_steps`` unshuffled batches of
    ``eval_pattern`` (default: the train pattern) run every
    ``eval_every_epochs`` epochs, the knn hook of the probe ``terms`` every
    epoch, checkpoints to ``<work_dir>/checkpoints`` every
    ``checkpoint_every_epochs`` epochs and at the end. With ``resume`` the
    run continues from the latest checkpoint (its input stream starts
    again from its seed, as the reference's does). ``vocab`` defaults to
    ``Vocabulary.load(token_dictionary)``; ``preemption`` defaults to
    ``cfg.graceful_shutdown``. Runs on ``device`` (default: the card).

    Under ``torchrun`` (or with ``n_model_shards > 1``, which then needs
    its ranks: too few raise ``ValueError``) the run is one rank of an
    ``n_data x n_model_shards`` mesh; ``batch_size`` is the global
    batch."""
    device = resolve_device(device)
    mesh = None
    if (mesh_lib.distributed_init_if_needed(device=device)
            or mesh_lib.is_initialized() or cfg.n_model_shards > 1):
        mesh_lib.check_ranks(cfg.n_model_shards, "GloVe training")
        if mesh_lib.is_initialized():
            device = mesh_lib.rank_device(device)
        mesh = mesh_lib.make_mesh(n_model=cfg.n_model_shards)
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local_bs = mesh_lib.process_local_batch(cfg.batch_size)
    host_seed = cfg.seed + rank
    if vocab is None:
        vocab = Vocabulary.load(cfg.token_dictionary)
    model, state = init_state(cfg, vocab.num_embeddings, device, mesh=mesh)

    ckpt_dir = f"{cfg.work_dir}/checkpoints"
    if world > 1:  # a checkpoint per rank: its shards
        write_mesh_file(ckpt_dir, mesh)
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
    batches = pipelines.glove_batches(
        cfg.train_pattern, local_bs,
        shuffle_buffer=cfg.shuffle_buffer_size, seed=host_seed)
    probe_terms = [t for t in cfg.terms.split(",") if t]
    hooks = [knn_hook(vocab, probe_terms)] if probe_terms else []
    eval_pattern = cfg.eval_pattern or cfg.train_pattern
    step_fn = select_train_step(model, cfg)
    eval_fn = make_eval_step(model)

    def eval_batches():
        return pipelines.glove_batches(eval_pattern, local_bs,
                                       shuffle_buffer=0, seed=host_seed + 1)

    if mesh is None:
        feed, eval_iter_fn = batches, eval_batches
        prepare = lambda batch: to_device(batch, device)  # noqa: E731
    else:
        feed = _as_dict(batches)
        eval_iter_fn = lambda: _as_dict(eval_batches())  # noqa: E731
        prepare = _from_dict
    try:
        result = fit(
            state,
            lambda st, batch: step_fn(st, prepare(batch)),
            feed,
            num_steps=cfg.steps_per_epoch * cfg.num_epochs,
            eval_step=lambda st, batch: eval_fn(st, prepare(batch)),
            eval_iter_fn=eval_iter_fn,
            eval_every=cfg.steps_per_epoch * cfg.eval_every_epochs,
            eval_steps=cfg.eval_steps,
            log_every=min(1000, cfg.steps_per_epoch),
            tracker=tracker,
            checkpointer=ckpt,
            checkpoint_every=cfg.steps_per_epoch * cfg.checkpoint_every_epochs,
            hooks=hooks,
            hook_every=cfg.steps_per_epoch,
            examples_per_step=cfg.batch_size,
            mesh=mesh,
            device=device,
            preemption=(cfg.graceful_shutdown if preemption is None
                        else preemption),
        )
        if not log_if_preempted(result, log):
            params = whole_tables(result.state.params)
            if rank == 0:
                export_model(cfg.work_dir, "glove", params,
                             step=result.state.step, tracker=tracker,
                             metadata=export_metadata(
                                 cfg, vocab.num_embeddings,
                                 model.num_embeddings))
        return result
    finally:
        if own_tracker:
            tracker.finish()


MESH_FILE = "mesh.json"


def write_mesh_file(ckpt_dir: str, mesh: Mesh) -> None:
    """Rank 0 records the grid beside the per-rank checkpoint directories,
    so that a reader can put the shards together
    (:func:`checkpoint_table`)."""
    if mesh.rank != 0:
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, MESH_FILE), "w") as f:
        json.dump({"n_data": mesh.n_data, "n_model": mesh.n_model}, f)


def checkpoint_table(directory: str, name: str = "token_embedding"
                     ) -> Tuple[int, np.ndarray]:
    """(step, whole table ``name``) of the latest GloVe checkpoint in
    ``directory``: one file, or a mesh's per-rank files (the shards of
    data row 0, ranks ``0 .. n_model - 1``, concatenated), under either
    optimizer."""
    key = f"params/{name}/embedding"
    mesh_file = os.path.join(directory, MESH_FILE)
    if not os.path.exists(mesh_file):
        ckpt = Checkpointer(directory)
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        with np.load(ckpt.path(step)) as z:
            return step, z[key]
    with open(mesh_file) as f:
        grid = json.load(f)
    world = grid["n_data"] * grid["n_model"]
    parts, steps = [], set()
    for r in range(grid["n_model"]):
        ckpt = Checkpointer(f"{directory}/rank-{r}-of-{world}")
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints of rank {r} in "
                                    f"{directory}")
        steps.add(step)
        with np.load(ckpt.path(step)) as z:
            parts.append(z[key])
    if len(steps) != 1:
        raise ValueError(f"the ranks' latest checkpoints differ: {steps}")
    return steps.pop(), np.concatenate(parts)


def main(argv=None) -> FitResult:
    """``python -m esrecsys_tpu_torch.workloads.glove --field value ...
    [--device cpu]``: every ``GloveConfig`` field is a flag."""
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, _ = p.parse_known_args(argv)
    cfg = config_lib.from_cli(GloveConfig, argv)
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
