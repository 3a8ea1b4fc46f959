"""Worker processes of the port's multi-rank CPU tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_sharded.py``).

:func:`spawn` starts ``world`` processes (``multiprocessing``'s spawn
context), each joining a gloo group through ``init_method="file://..."``
in the test's temporary directory (so parallel test workers never share a
port), runs one of the ``job_*`` functions below with its rank, and
pickles what the job returns to ``out-<rank>.pkl``. It joins with a
deadline: a rank that has not finished by then (a hung collective) is
killed and the test fails with what the ranks printed.

This module imports torch, numpy and the port only (never JAX), so the
workers start quickly; the tests compute the JAX package's side in their
own process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback
from typing import Any, Dict, List


def _entry(job: str, rank: int, world: int, tmp: str, args: Any) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    log = open(os.path.join(tmp, f"log-{rank}.txt"), "w")
    sys.stdout = sys.stderr = log
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=world, rank=rank)
        out = globals()[job](rank, world, tmp, args)
        with open(os.path.join(tmp, f"out-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def spawn(job: str, world: int, tmp: str, args: Any = None,
          timeout: float = 60.0) -> List[Any]:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's result.
    Raises AssertionError (with the ranks' output) when a rank fails or
    outlives ``timeout`` seconds."""
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(job, r, world, tmp, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()

    def logs() -> str:
        parts = []
        for r in range(world):
            path = os.path.join(tmp, f"log-{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    parts.append(f"--- rank {r}\n{f.read()[-4000:]}")
        return "\n".join(parts)

    if hung:
        raise AssertionError(f"{job}: ranks {hung} still running after "
                             f"{timeout} s\n{logs()}")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"{job}: ranks {bad} failed\n{logs()}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out-{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ jobs

def job_mesh(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """The grid's arithmetic and its collectives on this rank."""
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib

    n_model = args["n_model"]
    mesh = mesh_lib.make_mesh(n_model=n_model)
    t = torch.full((2,), float(rank))
    out = {
        "shape": mesh.shape, "data_index": mesh.data_index,
        "model_index": mesh.model_index,
        "rows": list(mesh.row_range(8 * n_model)),
        "owned": mesh.owned(torch.arange(8 * n_model), 8).tolist(),
        "sum_model": mesh.sum_model(t.clone()).tolist(),
        "sum_data": mesh.sum_data(t.clone()).tolist(),
        "mean_data": mesh.mean_data(t).tolist(),
        "gather_model": mesh.gather_model(t[:1]).tolist(),
        "gather_data": mesh.gather_data(t[:1]).tolist(),
        "files": mesh_lib.process_local_files(
            [f"f{i}" for i in range(args["files"])]),
        "slice": mesh_lib.process_local_slice(list(range(args["files"]))),
        "local_batch": mesh_lib.process_local_batch(8 * world),
        "placed": mesh.place({"x": [[rank, 0]]}, torch.device("cpu"))[
            "x"].tolist(),
    }
    try:
        mesh_lib.make_mesh_for_batch(world + 1, n_model=1)
        out["for_batch"] = "no error"
    except ValueError as e:
        out["for_batch"] = str(e)
    out["for_batch_ok"] = mesh_lib.make_mesh_for_batch(
        2 * world, n_model=n_model).shape
    return out


def job_lookup(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """lookup / lookup_pooled under both strategies on this rank's shard,
    with the data row's ids; the shard's gradient of sum(out * cot)."""
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.parallel import table as ptable

    mesh = mesh_lib.make_mesh(n_model=args["n_model"])
    full = torch.from_numpy(args["table"])
    b = args["ids"].shape[0] // mesh.n_data
    mine = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    ids = torch.from_numpy(args["ids"][mine])
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
    for strategy in ptable.STRATEGIES:
        for pool in (None, "sum", "mean", "max"):
            shard = ptable.shard_rows(full, mesh).requires_grad_()
            if pool is None:
                y = ptable.lookup(shard, ids, mesh=mesh, strategy=strategy)
                cot = torch.from_numpy(args["cot"][mine])
            else:
                y = ptable.lookup_pooled(shard, ids, pool=pool, mesh=mesh,
                                         strategy=strategy)
                cot = torch.from_numpy(args["cot_pooled"][mine])
            (y * cot).sum().backward()
            out[(strategy, pool)] = (y.detach().numpy(),
                                     shard.grad.numpy())
    return out


def _mesh_and_state(args):
    from esrecsys_tpu_torch.convert import sharded_state_from_jax
    from esrecsys_tpu_torch.core import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(n_model=args["n_model"])
    state = sharded_state_from_jax(args["jstate"], args["cfg"], mesh,
                                   device="cpu")
    return mesh, state


def _corpus(args):
    import torch

    return {k: torch.from_numpy(v) for k, v in args["corpus"].items()}


def _row_batch(batch: Dict, mesh) -> Dict:
    import torch

    b = batch["next_mask"].shape[0] // mesh.n_data
    mine = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return {k: torch.from_numpy(v[mine]) for k, v in batch.items()}


def job_steps(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """Sharded steps from a converted JAX state, then the whole tables
    and momentum buffers; then the sharded eval's top-k and metrics."""
    import torch

    from esrecsys_tpu_torch.workloads import playlist as tpl

    out = {}
    for name, cfg in args["cfgs"].items():
        mesh, state = _mesh_and_state({**args, "cfg": cfg,
                                       "jstate": args["jstates"][name]})
        corpus = _corpus(args)
        step = tpl.make_sharded_train_step(state.params, cfg, corpus, mesh)
        losses = []
        for batch, negs in zip(args["batches"], args["negs_by"][name]):
            state, m = step(state, _row_batch(batch, mesh),
                            neg_ids=torch.from_numpy(negs))
            losses.append(float(m["loss"]))
        whole = tpl.whole_params(state.params)
        moms = {}
        for t, entries in (state.opt_state or {}).items():
            for key, v in entries.items():
                moms[f"{t}/{key}"] = mesh.gather_model(v).numpy()
        out[name] = {"losses": losses, "params": whole, "opt": moms,
                     "step": state.step}
        if name == args["eval_cfg"]:
            ecfg = args["eval_config"]
            topk = tpl.make_sharded_eval_topk(state.params, ecfg, corpus, mesh)
            ev = tpl.make_sharded_eval_step(state.params, ecfg, corpus, mesh)
            setup = tpl.make_sharded_corpus_embed_setup(state.params, ecfg,
                                                        corpus, mesh)
            aux = setup(state)
            eb = _row_batch(args["eval_batch"], mesh)
            vals, ids = topk(state, eb, aux)
            out["eval"] = {"data_index": mesh.data_index,
                           "vals": vals.numpy(), "ids": ids.numpy(),
                           "metrics": {k: float(v) for k, v in
                                       ev(state, eb, aux).items()}}
    return out


def job_train(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """``workloads/playlist.train`` on this rank: a full run with its
    export, then a run whose rank ``args["kill_rank"]`` sends itself
    SIGTERM after step ``args["kill_at"]``."""
    import dataclasses
    import os as _os
    import signal

    from esrecsys_tpu_torch.train import Checkpointer
    from esrecsys_tpu_torch.workloads import playlist as tpl

    cfg = args["cfg"]
    full = tpl.train(cfg, device="cpu")
    out = {"steps_run": full.steps_run, "step": full.state.step,
           "preempted": full.preempted, "eval": full.last_eval_metrics,
           "train": full.last_train_metrics}

    def kill(state, step):
        if rank == args["kill_rank"] and step == args["kill_at"]:
            _os.kill(_os.getpid(), signal.SIGTERM)

    cut = dataclasses.replace(cfg, work_dir=cfg.work_dir + "-sigterm")
    res = tpl.train(cut, device="cpu", hooks=[kill])
    ck = Checkpointer(f"{cut.work_dir}/checkpoints/rank-{rank}-of-{world}")
    out["sigterm"] = {"step": res.state.step, "preempted": res.preempted,
                      "ckpt": ck.all_steps(),
                      "artifacts": _os.path.exists(
                          f"{cut.work_dir}/artifacts")}
    # resume on the same mesh: the checkpoint restores bit for bit
    import numpy as np

    mesh = res.state.params.mesh
    before = {k: v.detach().clone() for k, v in
              res.state.params.state_dict().items()}
    _, tmpl = tpl.init_state(cut, "cpu", mesh=mesh)
    back = ck.restore(tmpl)
    out["restored"] = all(np.array_equal(before[k].numpy(), v.numpy())
                          for k, v in back.params.state_dict().items())
    # the dense carrier's shards adapted into a lazy-carrier template
    lazy = dataclasses.replace(cut, momentum_carrier="lazy")
    _, tmpl = tpl.init_state(lazy, "cpu", mesh=mesh)
    adapted = tpl.restore_adapt_carrier(ck, tmpl, lazy)
    out["adapted"] = (
        adapted.step == res.state.step
        and all(bool((adapted.opt_state[t]["last_step"]
                      == res.state.step).all())
                and np.array_equal(adapted.opt_state[t]["momentum"].numpy(),
                                   res.state.opt_state[t]["momentum"]
                                   .numpy()) for t in ("album", "artist")))
    return out


def job_one_rank(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """chip_smoke's mesh phase at a small width on a 1x1 gloo mesh: the
    sharded steps against the unsharded ones and the sharded eval against
    the exact one, each compared bit for bit here."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import playlist as tpl

    cfg = args["cfg"]
    mesh = mesh_lib.make_mesh(n_model=1)
    corpus = _corpus(args)
    model_u, state_u = tpl.init_state(cfg, "cpu")
    model_s, state_s = tpl.init_state(cfg, "cpu", mesh=mesh)
    step_u = tpl.make_sparse_train_step(model_u, cfg, corpus, cfg.seed)
    step_s = tpl.make_sharded_train_step(model_s, cfg, corpus, mesh,
                                         cfg.seed)
    losses = []
    for batch in args["batches"]:
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, mu = step_u(state_u, b)
        _, ms = step_s(state_s, b)
        losses.append((float(mu["loss"]), float(ms["loss"])))
    same = {k: bool(torch.equal(v, state_s.params.state_dict()[k]))
            for k, v in state_u.params.state_dict().items()}
    for t, d in (state_u.opt_state or {}).items():
        for k, v in d.items():
            same[f"{t}/{k}"] = bool(torch.equal(v, state_s.opt_state[t][k]))
    eb = {k: torch.from_numpy(v) for k, v in args["eval_batch"].items()}
    xv, xi = tpl.make_eval_topk(model_u, cfg, corpus)(state_u, eb)
    sv, si = tpl.make_sharded_eval_topk(model_s, cfg, corpus, mesh)(
        state_s, eb)
    return {"losses": losses, "same": same, "step": state_s.step,
            "eval_ids_equal": bool(torch.equal(xi, si)),
            "eval_vals_equal": bool(torch.equal(xv, sv)),
            "finite": bool(np.isfinite(sv.numpy()).all())}


def job_mesh_check(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """``tools/mesh_check.py`` on this rank (its JSON on rank 0)."""
    from esrecsys_tpu_torch.tools import mesh_check

    return mesh_check.main(args)
