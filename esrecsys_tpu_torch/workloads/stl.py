"""Shop-the-Look workload: scene -> product two-tower training and offline
serving (counterpart of ``esrecsys_tpu/workloads/stl.py``).

Loss: the triplet hinge sum plus ``regularization`` times the norm caps
of the scene, pos and neg embeddings, over the batch. BatchNorm running
statistics are trained, checkpointed and exported, and eval and the
indexes use them.

Ported: ``STLConfig`` (the reference's fields and defaults; ``work_dir``
defaults to ``stl`` under the temporary directory), ``generate_triplets``
(numpy's RNG, so the triplets are the reference's bit for bit),
``make_train_step`` (autograd, then ``ops/optim.adam_update`` on every
parameter: ``optax.adam``), ``make_eval_step``, ``init_state``,
``train()`` on ``fit`` with eval, checkpoints, resume, preemption and the
``stl`` artifact (params and ``batch_stats`` in the reference's layout,
readable by either package), ``build_catalog_indexes`` (the artifact
first, then the latest checkpoint), ``recommend`` (exact top-k through
``retrieval/mips.topk_over_matrix``, then the pages) and the CLI.

On a data mesh (``train()`` under ``torchrun``: the reference's
``make_mesh_for_batch`` grid, one model shard): each rank takes its slice
of the triplets and ``batch_size / ranks`` triplets a step (seed ``seed +
rank``); BatchNorm's statistics are the global batch's
(``models/cnn.py``); each rank's loss is its share of the global loss (the
hinge and norm sums over the global batch size), the data group sums the
gradients before Adam (``rows_sharded``); checkpoints are per rank, and
rank 0 exports. With one rank every collective is the identity, and the
step is the unsharded one bit for bit.

The towers run in bf16 with ``use_bf16`` (params, BatchNorm statistics
and Adam state float32), else in float32 with TF32 off.

CLI (every ``STLConfig`` field is a flag, plus ``--device``):
  python -m esrecsys_tpu_torch.workloads.stl --mode train --stl_json pairs.json \
      --image_dir images --work_dir runs/stl [--device cpu]
  python -m esrecsys_tpu_torch.workloads.stl --mode index ...
  python -m esrecsys_tpu_torch.workloads.stl --mode recommend ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch import convert
from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.core.device import array_to_device, resolve_device
from esrecsys_tpu_torch.core.mesh import Mesh
from esrecsys_tpu_torch.core.tracking import make_tracker
from esrecsys_tpu_torch.data import images as images_lib
from esrecsys_tpu_torch.models.cnn import STLModel, pin_full_f32
from esrecsys_tpu_torch.ops import losses
from esrecsys_tpu_torch.ops.optim import adam_update
from esrecsys_tpu_torch.retrieval.html import save_results_pages
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex, build_index
from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix
from esrecsys_tpu_torch.train.checkpoint import Checkpointer
from esrecsys_tpu_torch.train.export import export_model, latest_artifact
from esrecsys_tpu_torch.train.loop import FitResult, fit
from esrecsys_tpu_torch.train.preemption import log_if_preempted
from esrecsys_tpu_torch.train.state import TrainState

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class STLConfig:
    """The reference's fields and defaults (its reference run's)."""

    mode: str = "train"            # train | index | recommend
    stl_json: str = ""             # scene -> product pair jsonl
    image_dir: str = ""
    work_dir: str = os.path.join(tempfile.gettempdir(), "stl")
    image_size: int = 512
    output_size: int = 64
    filters: Tuple[int, ...] = (16, 32, 64, 128)
    learning_rate: float = 1e-4
    regularization: float = 0.2
    num_negatives: int = 5
    batch_size: int = 16
    max_steps: int = 30_000
    log_every_steps: int = 100
    eval_every_steps: int = 2000
    eval_steps: int = 16
    checkpoint_every_steps: int = 10_000
    use_bf16: bool = True          # bf16 conv stack (params stay float32)
    seed: int = 0
    resume: bool = False
    # SIGTERM -> a stop at the next step, a checkpoint and a clean exit
    graceful_shutdown: bool = True
    # index / recommend mode:
    index_out: str = ""            # default: work_dir/{scene,product}_index.npz
    top_k: int = 10
    max_results: int = 100


Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def generate_triplets(pairs: Sequence[Tuple[str, str]], num_neg: int,
                      seed: int = 0
                      ) -> Tuple[List[Tuple[str, str, str]],
                                 List[Tuple[str, str, str]]]:
    """(scene, pos, neg) triplets, ``num_neg`` random products a pair, the
    pairs with ``i % 10 == 0`` in the test split."""
    rng = np.random.default_rng(seed)
    products = [p for _, p in pairs]
    train, test = [], []
    for i, (scene, pos) in enumerate(pairs):
        neg_indices = rng.integers(0, len(pairs), num_neg)
        dest = test if i % 10 == 0 else train
        for j in neg_indices:
            dest.append((scene, pos, products[j]))
    return train, test


def model_dtype(cfg: STLConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.use_bf16 else torch.float32


def init_state(cfg: STLConfig, device=None,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[STLModel, TrainState]:
    """The model initialised from ``generator`` (default: seeded with
    ``cfg.seed`` on the device) and its train state: Adam's zero ``mu``
    and ``nu`` per parameter, ``opt_state["mu"][name]``. A float32 model
    on a card pins TF32 off. On a data ``mesh`` every rank draws the same
    model and its BatchNorm takes global-batch statistics."""
    device = resolve_device(device)
    if device.type == "cuda" and not cfg.use_bf16:
        pin_full_f32()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    model = STLModel(cfg.output_size, tuple(cfg.filters), model_dtype(cfg),
                     device=device, generator=generator)
    model.set_data_mesh(mesh)
    opt = {k: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
           for k in ("mu", "nu")}
    return model, TrainState(step=0, params=model, opt_state=opt)


def stl_loss(cfg: STLConfig, pos_score, neg_score, scene_e, pos_e, neg_e):
    triplet = losses.triplet_hinge_sum(pos_score, neg_score, margin=1.0)
    reg = (losses.embedding_norm_cap(scene_e, 1.0)
           + losses.embedding_norm_cap(pos_e, 1.0)
           + losses.embedding_norm_cap(neg_e, 1.0))
    return (triplet + cfg.regularization * reg) / cfg.batch_size


def make_train_step(model: STLModel, cfg: STLConfig):
    """One step: the towers in training mode (batch statistics, running
    updates), the loss's gradients by autograd, then ``optax.adam(lr)``
    on every parameter (``ops/optim.adam_update``). Updates ``state`` in
    place. On a data mesh ``batch`` is this rank's slice, its loss its
    share of the global loss, and Adam sums the gradients over the data
    group first."""
    lr = cfg.learning_rate
    mesh = model.data_mesh

    def train_step(state: TrainState, batch: Batch):
        scene, pos, neg = batch
        for p in model.parameters():
            p.grad = None
        loss = stl_loss(cfg, *model(scene, pos, neg, True))
        loss.backward()
        with torch.no_grad():
            for name, p in model.named_parameters():
                adam_update(p, p.grad, {k: state.opt_state[k][name]
                                        for k in ("mu", "nu")},
                            lr=lr, step=state.step, rows_sharded=mesh)
                p.grad = None
        state.step += 1
        loss = loss.detach()
        return state, {"loss": loss if mesh is None
                       else mesh.sum_data(loss)}

    return train_step


def make_eval_step(model: STLModel, cfg: STLConfig):
    """The running statistics' loss and the share of triplets ranked
    right (pos over neg); on a data mesh, of the global batch."""
    mesh = model.data_mesh

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        scene, pos, neg = batch
        with torch.no_grad():
            pos_score, neg_score, *_ = model(scene, pos, neg, False)
            loss = losses.triplet_hinge_sum(pos_score, neg_score) \
                / cfg.batch_size
            right = (pos_score > neg_score).float().mean()
            if mesh is not None:
                loss, right = mesh.sum_data(loss), mesh.mean_data(right)
            return {"loss": loss, "triplet_accuracy": right}

    return eval_step


def to_device(batch, device: torch.device) -> Batch:
    return tuple(array_to_device(a, device) for a in batch)


def export_metadata(cfg: STLConfig) -> dict:
    return {"output_size": cfg.output_size, "image_size": cfg.image_size,
            "filters": list(cfg.filters)}


def _pairs(cfg: STLConfig) -> List[Tuple[str, str]]:
    pairs = images_lib.load_scene_product_pairs(cfg.stl_json)
    valid = images_lib.valid_scene_product(pairs, cfg.image_dir)
    log.info("%d/%d pairs have both images on disk", len(valid), len(pairs))
    return valid


def train(cfg: STLConfig, tracker=None, device=None, *,
          preemption=None) -> FitResult:
    """Train for ``max_steps`` (absolute) on the valid pairs' training
    triplets, then export ``<work_dir>/artifacts/stl-<step>.npz``.

    Eval rounds of ``eval_steps`` unshuffled test-triplet batches run
    every ``eval_every_steps``, checkpoints to ``<work_dir>/checkpoints``
    every ``checkpoint_every_steps`` and at the end. With ``resume`` the
    run continues from the latest checkpoint (its input stream starts
    again from its seed, as the reference's does). ``preemption`` defaults
    to ``cfg.graceful_shutdown``. Runs on ``device`` (default: the card).

    Under ``torchrun`` the run is one rank of the data mesh
    (``make_mesh_for_batch``); ``batch_size`` is the global batch."""
    device = resolve_device(device)
    mesh = None
    if (mesh_lib.distributed_init_if_needed(device=device)
            or mesh_lib.is_initialized()):
        device = mesh_lib.rank_device(device)
        mesh = mesh_lib.make_mesh_for_batch(cfg.batch_size)
    rank, world = mesh_lib.process_index(), mesh_lib.process_count()
    local_bs = mesh_lib.process_local_batch(cfg.batch_size)
    pairs = _pairs(cfg)
    train_trips, test_trips = generate_triplets(pairs, cfg.num_negatives,
                                                cfg.seed)
    log.info("%d train / %d test triplets", len(train_trips),
             len(test_trips))
    model, state = init_state(cfg, device, mesh=mesh)
    ckpt_dir = f"{cfg.work_dir}/checkpoints"
    if world > 1:  # a checkpoint per rank: its replicas and statistics
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
    train_iter = images_lib.triplet_image_dataset(
        train_trips, cfg.image_dir, local_bs, cfg.image_size,
        seed=cfg.seed + rank)
    step_fn = make_train_step(model, cfg)
    eval_fn = make_eval_step(model, cfg)
    try:
        result = fit(
            state,
            lambda st, b: step_fn(st, to_device(b, device)),
            train_iter,
            num_steps=cfg.max_steps,
            eval_step=lambda st, b: eval_fn(st, to_device(b, device)),
            eval_iter_fn=lambda: images_lib.triplet_image_dataset(
                test_trips, cfg.image_dir, local_bs, cfg.image_size,
                repeat=True, shuffle=False),
            eval_every=cfg.eval_every_steps,
            eval_steps=cfg.eval_steps,
            log_every=cfg.log_every_steps,
            tracker=tracker,
            checkpointer=ckpt,
            checkpoint_every=cfg.checkpoint_every_steps,
            examples_per_step=cfg.batch_size,
            preemption=(cfg.graceful_shutdown if preemption is None
                        else preemption),
        )
        if not log_if_preempted(result, log) and rank == 0:
            params, batch_stats = convert.stl_params_to_jax(model)
            export_model(cfg.work_dir, "stl", params, step=result.state.step,
                         tracker=tracker, batch_stats=batch_stats,
                         metadata=export_metadata(cfg))
        return result
    finally:
        if own_tracker:
            tracker.finish()


def load_model(cfg: STLConfig, device=None) -> STLModel:
    """The deployed towers: the newest ``stl`` artifact in ``work_dir``,
    else the latest checkpoint, in the config's dtype."""
    device = resolve_device(device)
    if device.type == "cuda" and not cfg.use_bf16:
        pin_full_f32()
    artifact = latest_artifact(cfg.work_dir, "stl")
    if artifact is not None:
        model, meta = convert.stl_model_from_artifact(
            artifact, model_dtype(cfg), device)
        log.info("loaded model artifact %s (step %s)", artifact, meta["step"])
        return model
    model, state = init_state(cfg, device)
    Checkpointer(f"{cfg.work_dir}/checkpoints").restore(state)
    return model


def build_catalog_indexes(cfg: STLConfig,
                          state: Optional[TrainState] = None,
                          device=None) -> Dict[str, str]:
    """Embed the unique scenes and products (sorted) with the towers'
    running statistics -> ``{scene,product}_index.npz`` in ``index_out``
    (default ``work_dir``); every item is kept. The towers are
    ``state.params``, or :func:`load_model`'s. Returns ``{"scene": path,
    "product": path}``."""
    device = resolve_device(device)
    pairs = _pairs(cfg)
    scenes = sorted({s for s, _ in pairs})
    products = sorted({p for _, p in pairs})
    model = state.params if state is not None else load_model(cfg, device)
    out = cfg.index_out or cfg.work_dir
    os.makedirs(out, exist_ok=True)
    paths = {}
    for name, keys, embed in (("scene", scenes, model.scene_embed),
                              ("product", products, model.product_embed)):
        def embed_fn(imgs, embed=embed):
            with torch.no_grad():
                return embed(array_to_device(imgs, device))

        batches = images_lib.keyed_image_dataset(
            keys, cfg.image_dir, cfg.batch_size, cfg.image_size)
        index = build_index(embed_fn, batches)
        path = os.path.join(out, f"{name}_index.npz")
        index.save(path)
        paths[name] = path
        log.info("wrote %d %s embeddings to %s", len(index), name, path)
    return paths


def recommend(cfg: STLConfig, device=None) -> str:
    """The top ``top_k`` products of each of the first ``max_results``
    scenes (exact inner product) -> one HTML page each under
    ``<work_dir>/recommendations``; returns that directory."""
    device = resolve_device(device)
    out = cfg.index_out or cfg.work_dir
    scene_index = EmbeddingIndex.load(os.path.join(out, "scene_index.npz"))
    product_index = EmbeddingIndex.load(
        os.path.join(out, "product_index.npz"))
    queries = torch.from_numpy(scene_index.vectors[:cfg.max_results]).to(device)
    items = torch.from_numpy(product_index.vectors).to(device)
    vals, idx = topk_over_matrix(queries, items, k=cfg.top_k)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()

    def results():
        for q in range(queries.shape[0]):
            yield scene_index.ids[q], [
                (product_index.ids[idx[q, j]], float(vals[q, j]))
                for j in range(cfg.top_k)]

    pages_dir = os.path.join(cfg.work_dir, "recommendations")
    n = save_results_pages(pages_dir, results(), images_lib.key_to_url,
                           cfg.max_results)
    log.info("wrote %d pages to %s", n, pages_dir)
    return pages_dir


def main(argv=None):
    """``python -m esrecsys_tpu_torch.workloads.stl --mode train|index|
    recommend --field value ... [--device cpu]``."""
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, _ = p.parse_known_args(argv)
    cfg = config_lib.from_cli(STLConfig, argv)
    if cfg.mode == "train":
        return train(cfg, device=args.device)
    if cfg.mode == "index":
        return build_catalog_indexes(cfg, device=args.device)
    if cfg.mode == "recommend":
        return recommend(cfg, device=args.device)
    raise SystemExit(f"unknown --mode {cfg.mode}")


if __name__ == "__main__":
    main()
