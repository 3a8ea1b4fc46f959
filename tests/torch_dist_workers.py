"""Worker processes of the port's multi-rank CPU tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_sharded.py``,
``tests/test_torch_sharded_serving.py``,
``tests/test_torch_mesh_workloads.py``).

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


def job_serving(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """A sharded ``RetrievalService`` per mode over ``world`` ranks: rank
    0 answers the queries (two chunks of ``max_batch``) and stops the
    others, which serve their shards until then."""
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import (RetrievalService,
                                                   serve_shard_worker)

    index = EmbeddingIndex(args["ids"], args["vecs"])
    out = {}
    for name, kw in args["modes"].items():
        svc = RetrievalService(index, max_k=args["k"], max_batch=4,
                               n_model_shards=world, device="cpu", **kw)
        if rank:
            serve_shard_worker(svc)
            continue
        ids, scores = svc.topk(args["queries"], k=args["k"])
        out[name] = {"ids": ids, "scores": scores, "mode": svc.mode,
                     "bytes": svc.resident_bytes_per_item,
                     "no_f32": svc._items is None}
        svc.stop_shards()
    return out


def job_http(rank: int, world: int, tmp: str, args) -> Dict[str, Any]:
    """``serve(..., n_model_shards=world)``: rank 0 answers HTTP requests
    (a query by id, a reload of the serving path, a reload whose file
    rank 2 cannot read, a missing file, ``/statsz``) and closes; the other
    ranks return from ``serve`` when it does."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from esrecsys_tpu_torch.retrieval import index as index_lib
    from esrecsys_tpu_torch.serving import server

    if rank == 2:  # this rank cannot read the "bad" catalog
        load = index_lib.EmbeddingIndex.load.__func__

        def failing(cls, path):
            if "bad" in path:
                raise OSError(f"rank 2 cannot read {path}")
            return load(cls, path)

        index_lib.EmbeddingIndex.load = classmethod(failing)
    httpd = server.serve(args["path"], port=0, max_k=5, max_batch=2,
                         n_model_shards=world, device="cpu", **args["kw"])
    if rank:
        return {"returned": httpd is None}
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    out = {"topk": post("/v1/topk", {"id": "item3", "k": 5}),
           "vectors": post("/v1/topk", {"vectors": args["queries"], "k": 5}),
           "reload": post("/admin/reload", {}),
           "shards_kept": httpd.service.n_model_shards,
           "after_reload": post("/v1/topk", {"id": "item3", "k": 5}),
           "bad_reload": post("/admin/reload", {"index": args["bad"]}),
           "missing": post("/admin/reload", {"index": "/nonexistent.npz"}),
           "after_bad": post("/v1/topk", {"id": "item7", "k": 5})}
    with urllib.request.urlopen(base + "/statsz", timeout=30) as r:
        out["statsz"] = json.loads(r.read())
    out["items_served"] = len(httpd.service.index)
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    out["closed"] = not thread.is_alive()
    return out


def job_http_reload_race(rank: int, world: int, tmp: str,
                         args) -> Dict[str, Any]:
    """``serve(..., n_model_shards=world)`` under load: rank 0's client
    threads send ``/v1/topk`` (single vectors through the batcher, and
    two-row batches past it) while ``/admin/reload`` swaps the catalog
    between ``a`` and ``b`` ``args["reloads"]`` times; every answer is
    kept as ``(query, code, body)``."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from esrecsys_tpu_torch.serving import server

    httpd = server.serve(args["a"], port=0, max_k=5, max_batch=2,
                         n_model_shards=world, device="cpu", **args["kw"])
    if rank:
        return {"returned": httpd is None}
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    queries, stop, answers = args["queries"], threading.Event(), []

    def client(c):
        i = c
        while not stop.is_set():
            j = i % len(queries)
            if c % 2:   # two rows past the batcher
                pair = [j, (j + 1) % len(queries)]
                got = post("/v1/topk", {"vectors": [queries[x] for x in pair],
                                        "k": 5})
                answers.append((pair, *got))
            else:
                answers.append(([j], *post("/v1/topk", {"vector": queries[j],
                                                        "k": 5})))
            i += 1

    clients = [threading.Thread(target=client, args=(c,))
               for c in range(4)]
    for t in clients:
        t.start()
    reloads = [post("/admin/reload", {"index": args["b" if r % 2 == 0
                                                   else "a"]})[0]
               for r in range(args["reloads"])]
    stop.set()
    for t in clients:
        t.join(timeout=60)
    out = {"reloads": reloads, "answers": answers,
           "clients_done": not any(t.is_alive() for t in clients)}
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    out["closed"] = not thread.is_alive()
    return out


def _whole_opt(tree, mesh, sharded) -> Dict[str, Any]:
    """{path: whole numpy array} of a nested optimizer state, its sharded
    leaves (``sharded(path)``) gathered over the model group."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            for k, v in _whole_opt(value, mesh, sharded).items():
                out[f"{key}/{k}"] = v
        else:
            v = value.detach()
            out[key] = (mesh.gather_model(v.contiguous())
                        if sharded(key) else v).numpy()
    return out


def _glove_runs(rank, args) -> Dict[str, Any]:
    import torch

    from esrecsys_tpu_torch.convert import sharded_glove_state_from_jax
    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import glove as tglove

    a = args["glove"]
    out = {}
    for opt, jstate in a["jstates"].items():
        mesh = mesh_lib.make_mesh(n_model=2)
        cfg = a["cfgs"][opt]
        state = sharded_glove_state_from_jax(jstate, cfg, a["rows"], mesh,
                                             device="cpu")
        step = tglove.select_train_step(state.params, cfg)
        losses = []
        for (t1, t2), count in a["batches"]:
            state, m = step(state, ((torch.from_numpy(t1),
                                     torch.from_numpy(t2)),
                                    torch.from_numpy(count)))
            losses.append(float(m["loss"]))
        opt_state = _whole_opt(state.opt_state, mesh, lambda k: True)
        scores, ids = tglove.knn(state, torch.tensor(a["probes"]), k=5,
                                 valid_rows=a["rows"])
        eval_loss = float(tglove.make_eval_step(state.params)(state, (
            (torch.from_numpy(a["batches"][0][0][0]),
             torch.from_numpy(a["batches"][0][0][1])),
            torch.from_numpy(a["batches"][0][1])))["loss"])
        out[opt] = {"losses": losses, "tables":
                    tglove.whole_tables(state.params), "opt": opt_state,
                    "knn": (scores, ids), "eval_loss": eval_loss}
    return out


def _glove_train(rank, tmp, args) -> Dict[str, Any]:
    """``glove.train()`` on a 1x2 mesh, then its checkpoints put together
    and loaded into a sharded txt2url word table."""
    import dataclasses

    import numpy as np
    import torch

    from esrecsys_tpu_torch.train.export import latest_artifact, load_model
    from esrecsys_tpu_torch.workloads import glove as tglove
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    a = args["glove_train"]
    cfg = dataclasses.replace(a["cfg"], work_dir=os.path.join(tmp, "glove"))
    res = tglove.train(cfg, vocab=a["vocab"], device="cpu")
    step, table = t2u.glove_checkpoint_table(f"{cfg.work_dir}/checkpoints")
    whole = tglove.whole_tables(res.state.params)
    out = {"step": res.state.step, "ckpt_step": step,
           "ckpt_equal": bool(np.array_equal(
               table, whole["token_embedding"]["embedding"])),
           "eval": res.last_eval_metrics}
    if rank == 0:
        params, _, meta = load_model(latest_artifact(cfg.work_dir, "glove"))
        out["export_equal"] = bool(np.array_equal(
            params["token_embedding"]["embedding"],
            whole["token_embedding"]["embedding"]))
        out["meta"] = meta
    # the transfer into a sharded word table of the dictionary's rows
    from esrecsys_tpu_torch.core import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(n_model=2)
    words = a["vocab"].num_embeddings
    model, _ = t2u.init_state(t2u.Txt2UrlConfig(word_dim=cfg.feature_size,
                                                rnn_size=4, url_dim=4,
                                                encoder_type="mean"),
                              words, 6, "cpu", mesh=mesh)
    t2u.load_glove_word_embeddings(model, table)
    got = mesh.gather_model(model.encoder.word_embedding.embedding.detach())
    out["transfer_equal"] = bool(torch.equal(got[:words],
                                             torch.from_numpy(table[:words])))
    return out


def _txt2url_runs(rank, args) -> Dict[str, Any]:
    import torch

    from esrecsys_tpu_torch.convert import _copy_params
    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.models.layers import whole_state_dict
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    a = args["txt2url"]
    mesh = mesh_lib.make_mesh(n_model=2)
    cfg = a["cfg"]
    model, state = t2u.init_state(cfg, a["words"], a["urls"], "cpu",
                                  mesh=mesh)
    _copy_params(model, {k: torch.from_numpy(v)
                         for k, v in a["params"].items()}, mesh)
    step = t2u.make_train_step(model, cfg)
    losses = []
    for b in a["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    ev = t2u.make_eval_step(model, cfg)(state, {
        k: torch.from_numpy(v) for k, v in a["batches"][0].items()})
    emb = model.url_embedding
    with torch.no_grad():
        probe = t2u.top_rows(emb, model.encoder(torch.from_numpy(
            a["batches"][0]["tokens"])), 5)
        wemb = model.encoder.word_embedding
        words = t2u.top_rows(wemb, wemb(torch.tensor([1, 2, 3])), 5)
    nu = {}
    for name, v in state.opt_state["nu"].items():
        sharded = name.endswith("embedding.embedding")
        nu[name] = (mesh.gather_model(v) if sharded else v).numpy()
    return {"losses": losses, "params": {
        k: v.numpy() for k, v in whole_state_dict(model).items()},
        "nu": nu, "eval": {k: float(v) for k, v in ev.items()},
        "probe": [t.numpy() for t in probe],
        "words": [t.numpy() for t in words]}


def _scale_runs(rank, args) -> Dict[str, Any]:
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.tools import scale_table as tst

    out = {}
    for name, cfg in args["scale"].items():
        mesh = mesh_lib.make_mesh(n_model=cfg.n_model)
        table, state = tst.init(cfg, torch.device("cpu"), mesh)
        one = tst.make_step(cfg, table, state, mesh)
        losses = [float(one(s)) for s in range(cfg.steps_per_call)]
        out[name] = {"losses": losses,
                     "table": mesh.gather_model(table).numpy(),
                     "state": None if state is None else
                     {k: mesh.gather_model(v).numpy()
                      for k, v in state.items()}}
    return out


def _stl_runs(rank, args) -> Dict[str, Any]:
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import stl

    a = args["stl"]
    mesh = mesh_lib.make_mesh(n_model=1)           # 2 data rows
    model, state = stl.init_state(a["cfg"], "cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in a["state_dict"].items()})
    b = a["cfg"].batch_size // mesh.n_data
    mine = slice(mesh.data_index * b, (mesh.data_index + 1) * b)

    def local(batch):
        return tuple(torch.from_numpy(x[mine]) for x in batch)

    ev = stl.make_eval_step(model, a["cfg"])(state, local(a["batches"][0]))
    step, losses = stl.make_train_step(model, a["cfg"]), []
    for batch in a["batches"]:
        state, m = step(state, local(batch))
        losses.append(float(m["loss"]))
    out = {key: {k: v.numpy() for k, v in state.opt_state[key].items()}
           for key in ("mu", "nu")}
    out.update(losses=losses,
               state_dict={k: v.numpy()
                           for k, v in model.state_dict().items()},
               eval={k: float(v) for k, v in ev.items()})
    return out


def _dense_playlist_runs(rank, args) -> Dict[str, Any]:
    import torch

    from esrecsys_tpu_torch.convert import sharded_state_from_jax
    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import playlist as tpl

    a = args["dense"]
    out = {}
    for shape, jstate in a["jstates"].items():
        n_model = int(shape.split("x")[1])
        mesh = mesh_lib.make_mesh(n_model=n_model)
        cfg = a["cfgs"][shape]
        state = sharded_state_from_jax(jstate, cfg, mesh, device="cpu")
        corpus = {k: torch.from_numpy(v) for k, v in a["corpus"].items()}
        step = tpl.select_train_step(state.params, cfg, corpus, mesh=mesh)
        losses = []
        for batch, negs in zip(a["batches"], a["negs"]):
            b = batch["next_mask"].shape[0] // mesh.n_data
            mine = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
            state, m = step(state, {k: torch.from_numpy(v[mine])
                                    for k, v in batch.items()},
                            neg_ids=torch.from_numpy(negs))
            losses.append(float(m["loss"]))
        moms = {}
        for name, p in state.params.named_parameters():
            buf = state.opt_state.state[p]["momentum_buffer"]
            moms[name] = mesh.gather_model(buf).numpy()
        out[shape] = {"losses": losses,
                      "params": tpl.whole_params(state.params),
                      "momentum": moms}
    return out


def job_mesh_workloads(rank: int, world: int, tmp: str,
                       args) -> Dict[str, Any]:
    """GloVe (both optimizers, and ``train()``), txt2url and
    ``scale_table`` on a 1x2 mesh, STL on a 2x1 mesh, and the playlist's
    dense step on 1x2 and 2x1, each from the JAX package's state where
    there is one; every mesh made in one order on both ranks."""
    return {"glove": _glove_runs(rank, args),
            "glove_train": _glove_train(rank, tmp, args),
            "txt2url": _txt2url_runs(rank, args),
            "scale": _scale_runs(rank, args),
            "stl": _stl_runs(rank, args),
            "dense": _dense_playlist_runs(rank, args)}
