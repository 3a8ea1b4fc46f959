"""The port's sharded paths on a mesh of ranks, each held against the
unsharded code on rank 0, at full widths by default.

    torchrun --nproc_per_node 4 -m esrecsys_tpu_torch.tools.mesh_check
    # on the CPU (gloo): add --device cpu and small sizes (see
    #   tests/test_torch_sharded.py's test_mesh_check_tool_on_four_ranks)

``--paths`` (default all of them) chooses among:

  * ``sparse``: the playlist's row-sparse step and its sharded eval on an
    ``n_data x --n_model`` mesh (below);
  * ``serving``: ``RetrievalService(n_model_shards=4)`` (1x4) over a
    2,262,292 x 64 catalog at k=500, B=8, in the exact, int8, int8+r8 and
    fused modes, each against the single-card exact service on rank 0:
    exact's scores equal and its ids up to exactly equal scores, the
    others' overlap@500 at least their floors;
  * ``glove`` and ``txt2url``: their steps on 2x2 (565,537 and 1,000,000
    x 64 tables) against the unsharded steps, as ``chip_smoke.py``'s mesh
    phase holds them;
  * ``scale_table``: 1x4 at 100M x 32 bf16, momentum 0.98, against the
    unsharded run on rank 0 (the share of the table's elements off by
    more than 1e-6 at most 1e-4: the scatter's atomics order duplicates
    run to run);
  * ``stl``: 4x1 at 512 px, B=16, float32 towers: one step against the
    single-card step on the global batch (the loss and the running
    variances within 1e-4; Adam's ``mu`` and ``nu`` within 1e-3 of each
    parameter's largest, which a gradient of the wrong scale breaks; but
    for the BatchNorm-cancelled biases, at most 1e-3 of the parameters'
    elements over 1e-6 apart), the ranks' states equal;
  * ``dense``: the playlist's dense autograd step on 2x2 against the
    unsharded dense step, within the sparse path's bounds.

Every rank draws the same global batches and the same init from one seed;
each takes its data row's slice of the batches (``core/mesh.py``), and
rank 0 also runs the unsharded step on the whole batches. Checks:

  * from the init, the sharded eval's top-``eval_k`` (its data rows'
    results gathered) against the exact eval's: the same scores, and the
    same ids up to the order of exactly equal scores;
  * after ``--steps`` steps, the sharded tables and momentum buffers,
    gathered whole, against the unsharded ones: within 1e-5 (tables) and
    2e-4 (momentum), the bounds ``chip_smoke.py`` holds kernels against
    plain versions to (the data rows' halves of the gradient are summed
    in another order, and a last-ulp difference in a table can flip its
    bf16 rounding; a scatter into a wrong row would move a row by
    ``lr`` times its momentum). The share of elements off by more than
    1e-6 is reported beside them.

With ``--allreduce_mib N`` it also times one all-reduce of N MiB over
every rank and reports its bus bandwidth (``allreduce``); ``--paths ""``
runs that alone.

Measures the host ms per step (or call) of each sharded path on every
card and of the unsharded one on rank 0's, and, from ``torch.profiler``
on rank 0, the device time of each sharded path and the NCCL kernels'
share of it. Rank 0 prints one JSON line (``paths`` holds the new paths'
results); the exit code is 1 when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import re
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.core.device import card_line, resolve_device
from esrecsys_tpu_torch.tools import full_scale_run as fsr
from esrecsys_tpu_torch.workloads import playlist as pl

TABLE_ATOL, MOMENTUM_ATOL = 1e-5, 2e-4
PATHS = ("sparse", "serving", "glove", "txt2url", "scale_table", "stl",
         "dense")
SERVE_MODES = {"exact": {}, "int8": {"quantized": True},
               "int8+r8": {"quantized": True, "rescore_int8": True},
               "fused": {"fused": True, "fused_bins": 4096}}
# the chip's glove and wiki phases' bounds for a step against its twin:
# losses within 1e-5 relative; at most this share of the elements over
# 1e-6 apart (the scatter's atomics sum duplicates in a run-dependent
# order, and Adam or RMSprop can turn a near-cancelled element's last bits
# into another update)
LOSS_RTOL, DIFF_SHARE = 1e-5, 1e-3
STL_RTOL, STL_SHARE, STL_MOMENT_RTOL = 1e-4, 1e-3, 1e-3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps: int, device: torch.device) -> float:
    """Host ms per call of ``fn`` over ``reps`` calls, ending in a sync."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def _nccl_share(fn, reps: int, device: torch.device, rank0: bool) -> dict:
    """``fn`` in the steady state, after the checked calls (whose window
    holds each group's first collective, where NCCL builds its
    communicator): the host ms per call over ``reps`` calls, then, on rank
    0 under the profiler (every rank runs ``fn`` as often), the device ms
    per call and the NCCL kernels' share of it (not on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    out = {"steady_ms": _timed(fn, reps, device)}
    if device.type != "cuda":
        return out
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if rank0 else contextlib.nullcontext()) as prof:
        for _ in range(reps):
            fn()
        _sync(device)
    if not rank0:
        return out
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3 / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(v for _, v in rows)
    nccl = sum(v for k, v in rows if "nccl" in k.lower())
    return {**out, "busy_ms": busy, "nccl_ms": nccl,
            "nccl_share": nccl / busy if busy else None}


def _allreduce_bandwidth(mib: int, reps: int, device: torch.device) -> dict:
    """One all-reduce SUM of ``mib`` MiB of float32 over every rank: host
    ms per call over ``reps`` calls after 5 warm-up calls, the algorithm
    bandwidth (bytes over time) and the bus bandwidth (times 2 (n - 1) /
    n: what each link carries in a ring)."""
    n = dist.get_world_size()
    t = torch.zeros(mib * (1 << 20) // 4, device=device)
    for _ in range(5):
        dist.all_reduce(t)
    ms = _timed(lambda: dist.all_reduce(t), reps, device)
    alg = t.numel() * 4 / (ms / 1e3)
    return {"mib": mib, "ranks": n, "reps": reps, "ms": ms,
            "algbw_GBps": alg / 1e9, "busbw_GBps": alg * 2 * (n - 1) / n / 1e9}


def _share(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 24) -> tuple:
    """(max abs diff, share of elements over 1e-6 apart; NaN counts as
    apart) of two tensors, ``rows`` leading rows at a time."""
    worst, over = 0.0, 0
    for i in range(0, a.shape[0], rows):
        d = (a[i:i + rows].detach().float()
             - b[i:i + rows].detach().float()).abs()
        worst = max(worst, float(d.nan_to_num(float("inf")).max()))
        over += int((~(d <= 1e-6)).sum())
    return worst, over / max(a.numel(), 1)


def _overlap(vecs, queries, ids, kth) -> float:
    """The share of the returned ids whose exact float64 score is at or
    above the exact k-th score (less 1e-5 of its size)."""
    rows = vecs[ids.astype(np.int64)].astype(np.float64)
    s = np.einsum("bkd,bd->bk", rows, queries.astype(np.float64))
    return float((s >= kth[:, None] - 1e-5 * np.abs(kth[:, None])).mean())


def _serving(args, device, rank0) -> dict:
    """The sharded service (1 x world) in each mode against the
    single-card exact service on rank 0: the exact mode's scores equal and
    ids up to exactly equal scores; the int8 modes' and the fused mode's
    overlap@k against it at least their floors (0.98, 0.99: PERF.md
    section 2)."""
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving.server import (RetrievalService,
                                                   serve_shard_worker)

    n = mesh_lib.process_count()
    rng = np.random.default_rng(args.seed + 7)
    vecs = rng.standard_normal((args.catalog_items, args.catalog_dim),
                               dtype=np.float32)
    index = EmbeddingIndex([str(i) for i in range(len(vecs))], vecs)
    queries = vecs[rng.integers(0, len(vecs), 8)] + 0.1 * \
        rng.standard_normal((8, args.catalog_dim), dtype=np.float32)
    k, out, ok = args.serve_k, {}, True
    if rank0:
        ref = RetrievalService(index, max_k=k, max_batch=8, device=device)
        want_ids, want_scores = ref.topk(queries, k=k)
        out["single_card_exact_ms"] = _timed(
            lambda: ref.topk(queries, k=k), args.serve_reps, device)
        del ref
        want_rows = want_ids.astype(np.int64)
        kth = np.einsum("bd,bd->b", vecs[want_rows[:, -1]].astype(
            np.float64), queries.astype(np.float64))
    for name, kw in SERVE_MODES.items():
        svc = RetrievalService(index, max_k=k, max_batch=8,
                               n_model_shards=n, device=device, **kw)
        if not rank0:
            serve_shard_worker(svc)
            continue
        ids, scores = svc.topk(queries, k=k)
        ms = _timed(lambda: svc.topk(queries, k=k), args.serve_reps, device)
        res = {"mode": svc.mode, "ms": ms,
               "overlap": _overlap(vecs, queries, ids, kth)}
        if name == "exact":
            res["scores_equal"] = bool(np.allclose(scores, want_scores,
                                                   rtol=1e-5, atol=1e-6))
            res["id_sets_equal"] = all(set(a) == set(b) for a, b in
                                       zip(ids, want_ids))
            ok &= res["scores_equal"] and res["id_sets_equal"]
        else:
            ok &= res["overlap"] >= (0.99 if name == "fused" else 0.98)
        if name == "exact":
            res.update(_nccl_share(lambda: svc.topk(queries, k=k),
                                   args.serve_reps, device, True))
        svc.stop_shards()
        out[name] = res
    out["ok"] = bool(ok)
    return out


def _glove(args, device, rank0) -> dict:
    from esrecsys_tpu_torch.workloads import glove as gl

    mesh = mesh_lib.make_mesh(n_model=args.n_model)
    rng = np.random.default_rng(args.seed + 11)
    batches = []
    for _ in range(args.workload_steps + args.profile_steps):
        t = rng.zipf(1.3, (2, args.glove_batch)) % (args.glove_rows - 1) + 1
        batches.append(((t[0].astype(np.int32), t[1].astype(np.int32)),
                        rng.integers(1, 300, args.glove_batch)
                        .astype(np.float32)))
    b = args.glove_batch // mesh.n_data
    d = mesh.data_index

    def row(batch):
        (t1, t2), c = batch
        return gl.to_device(((t1[d * b:(d + 1) * b], t2[d * b:(d + 1) * b]),
                             c[d * b:(d + 1) * b]), device)

    out, ok = {}, True
    for opt in ("adam", "lazy_adam"):
        cfg = gl.GloveConfig(feature_size=args.glove_dim, optimizer=opt,
                             batch_size=args.glove_batch)
        model, state = gl.init_state(cfg, args.glove_rows, device,
                                     mesh=mesh)
        step = gl.select_train_step(model, cfg)
        it = iter(batches[:args.workload_steps])
        losses = []
        ms = _timed(lambda: losses.append(float(step(state, row(next(it)))[
            1]["loss"])), args.workload_steps, device)  # checked steps
        whole = gl.whole_tables(state.params)
        res = {"first_steps_ms": ms}
        if rank0:
            mu, su = gl.init_state(cfg, args.glove_rows, device)
            step_u = gl.select_train_step(mu, cfg)
            it_u = iter(batches[:args.workload_steps])
            lu = []
            res["unsharded_ms"] = _timed(lambda: lu.append(float(step_u(
                su, gl.to_device(next(it_u), device))[1]["loss"])),
                args.workload_steps, device)
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses, lu))
            diffs = {n: _share(torch.from_numpy(whole[n]["embedding"]),
                               getattr(su.params, n).embedding.cpu())
                     for n in gl.TABLES}
            res.update(loss_rel=rel, diffs=diffs)
            ok &= rel <= LOSS_RTOL and all(v[1] <= DIFF_SHARE
                                           for v in diffs.values())
        it = itertools.cycle(batches[args.workload_steps:])
        res.update(_nccl_share(lambda: step(state, row(next(it))),
                               args.profile_steps, device, rank0))
        out[opt] = res
    out["mesh"] = f"{mesh.n_data}x{mesh.n_model}"
    out["ok"] = bool(ok)
    return out


def _txt2url(args, device, rank0) -> dict:
    from esrecsys_tpu_torch.core.mesh import make_mesh_for_batch
    from esrecsys_tpu_torch.models.layers import whole_state_dict
    from esrecsys_tpu_torch.workloads import txt2url as t2u

    cfg = t2u.Txt2UrlConfig(word_dim=args.t2u_dim, rnn_size=args.t2u_dim,
                            url_dim=args.t2u_dim, batch_size=args.t2u_batch,
                            n_model_shards=args.n_model)
    mesh = make_mesh_for_batch(cfg.batch_size, n_model=args.n_model)
    rng = np.random.default_rng(args.seed + 13)
    B, L = cfg.batch_size, cfg.sentence_length

    def batch():
        tok = (rng.zipf(1.2, (B, L)) % (args.t2u_words - 1) + 1).astype(
            np.int32)
        tok[np.arange(L)[None, :] >= rng.integers(1, L + 1, B)[:, None]] = 0
        return {"url_near_text": rng.integers(0, args.t2u_urls, B)
                .astype(np.int32), "tokens": tok,
                "url1": rng.integers(0, args.t2u_urls, B).astype(np.int32),
                "url2": rng.integers(0, args.t2u_urls, B).astype(np.int32),
                "sqrt_dice": rng.random(B).astype(np.float32)}

    batches = [batch() for _ in range(args.workload_steps
                                      + args.profile_steps)]
    b, d = B // mesh.n_data, mesh.data_index

    def row(x):
        return t2u.to_device({k: v[d * b:(d + 1) * b] for k, v in x.items()},
                             device)

    model, state = t2u.init_state(cfg, args.t2u_words, args.t2u_urls, device,
                                  mesh=mesh)
    step = t2u.make_train_step(model, cfg)
    it = iter(batches[:args.workload_steps])
    losses = []
    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}"}
    out["first_steps_ms"] = _timed(lambda: losses.append(float(step(
        state, row(next(it)))[1]["loss"])), args.workload_steps, device)
    whole = whole_state_dict(model)
    ok = True
    if rank0:
        mu, su = t2u.init_state(dataclasses.replace(cfg, n_model_shards=1),
                                args.t2u_words, args.t2u_urls, device)
        step_u = t2u.make_train_step(mu, cfg)
        it_u = iter(batches[:args.workload_steps])
        lu = []
        out["unsharded_ms"] = _timed(lambda: lu.append(float(step_u(
            su, t2u.to_device(next(it_u), device))[1]["loss"])),
            args.workload_steps, device)
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, lu))
        over = total = 0.0
        for name, p in mu.named_parameters():
            w = whole[name][:p.shape[0]] if p.dim() == 2 else whole[name]
            _, share = _share(w.cpu(), p.cpu())
            over += share * p.numel()
            total += p.numel()
        out.update(loss_rel=rel, share=over / total)
        ok = rel <= LOSS_RTOL and over / total <= DIFF_SHARE
    it = itertools.cycle(batches[args.workload_steps:])
    out.update(_nccl_share(lambda: step(state, row(next(it))),
                           args.profile_steps, device, rank0))
    out["ok"] = bool(ok)
    return out


def _scale_table(args, device, rank0) -> dict:
    from esrecsys_tpu_torch.tools import scale_table as st

    n = mesh_lib.process_count()
    cfg = st.ScaleConfig(rows=args.scale_rows, dim=32, dtype="bfloat16",
                         ids_per_step=args.scale_ids, steps_per_call=4,
                         calls=2, momentum=0.98, n_model=n,
                         device=str(device))
    mesh = mesh_lib.make_mesh(n_model=n)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    table, state = st.init(cfg, device, mesh)
    one = st.make_step(cfg, table, state, mesh)
    steps = cfg.steps_per_call * cfg.calls
    it = iter(range(steps))
    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}"}
    out["first_steps_ms"] = _timed(lambda: one(next(it)), steps, device)
    whole = mesh.gather_model(table)
    ok = True
    if rank0:
        ucfg = dataclasses.replace(cfg, n_model=1)
        t_u, s_u = st.init(ucfg, device)
        one_u = st.make_step(ucfg, t_u, s_u)
        it_u = iter(range(steps))
        out["unsharded_ms"] = _timed(lambda: one_u(next(it_u)), steps,
                                     device)
        worst, share = _share(whole[:cfg.rows], t_u)
        out.update(max_diff=worst, share=share)
        ok = share <= 1e-4 and worst < float("inf")
        del t_u, s_u
    del whole
    it = itertools.count(steps)
    out.update(_nccl_share(lambda: one(next(it)), args.profile_steps,
                           device, rank0))
    out["rows_per_s"] = cfg.ids_per_step * 1e3 / out["steady_ms"]
    out["ok"] = bool(ok)
    return out


def _stl(args, device, rank0) -> dict:
    from esrecsys_tpu_torch.core.mesh import make_mesh_for_batch
    from esrecsys_tpu_torch.workloads import stl

    cfg = stl.STLConfig(image_size=args.stl_image_size,
                        batch_size=args.stl_batch, use_bf16=False,
                        filters=tuple(int(f) for f in
                                      args.stl_filters.split(",")))
    mesh = make_mesh_for_batch(cfg.batch_size)
    gen = torch.Generator().manual_seed(args.seed + 17)
    S = cfg.image_size
    batches = [tuple(torch.randn((cfg.batch_size, S, S, 3), generator=gen)
                     * 0.3 for _ in range(3))
               for _ in range(1 + args.workload_steps + args.profile_steps)]
    b, d = cfg.batch_size // mesh.n_data, mesh.data_index

    def row(x):
        return tuple(t[d * b:(d + 1) * b].to(device) for t in x)

    model, state = stl.init_state(cfg, device, mesh=mesh)
    step = stl.make_train_step(model, cfg)
    state, m = step(state, row(batches[0]))
    equal = True
    for v in model.state_dict().values():  # the replicas are equal
        every = mesh.gather_data(v[None])
        equal &= bool((every == every[:1]).all())
    mine = {k: v.cpu() for k, v in model.state_dict().items()}
    moments = {key: {k: v.cpu() for k, v in state.opt_state[key].items()}
               for key in ("mu", "nu")}
    ok = bool(equal)
    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}", "replicas_equal": equal}
    if rank0:
        mu, su = stl.init_state(cfg, device)
        su, mu_m = stl.make_train_step(mu, cfg)(
            su, tuple(t.to(device) for t in batches[0]))
        rel = abs(float(m["loss"]) - float(mu_m["loss"])) / abs(
            float(mu_m["loss"]))
        params = dict(mu.named_parameters())
        worst = over = total = 0
        var_rel = moment_rel = 0.0
        for k, v in mu.state_dict().items():
            dv = (mine[k].float() - v.cpu().float()).abs()
            if k in params:
                worst = max(worst, float(dv.max()))
                if not re.search(r"Conv_[123]\.bias$", k):
                    over += int((dv > 1e-6).sum())
                    total += dv.numel()
            elif k.endswith(".var"):
                var_rel = max(var_rel, float((dv / v.cpu().abs()).max()))
        # Adam's first step is about lr * sign(g) whatever the gradient's
        # scale; its moments are not: each parameter's mu and nu within
        # STL_MOMENT_RTOL of its largest (but the BatchNorm-cancelled
        # biases of Conv_1..3, whose gradients are float32 noise)
        for key in ("mu", "nu"):
            for k, v in su.opt_state[key].items():
                if re.search(r"Conv_[123]\.bias$", k):
                    continue
                off = float((moments[key][k] - v.cpu()).abs().max())
                moment_rel = max(moment_rel,
                                 off / float(v.abs().max().clamp_min(1e-30)))
        out.update(loss_rel=rel, param_max_diff=worst,
                   param_share=over / total, var_rel=var_rel,
                   moment_rel=moment_rel)
        ok &= (rel <= STL_RTOL and var_rel <= STL_RTOL
               and moment_rel <= STL_MOMENT_RTOL
               and over / total <= STL_SHARE)
        del mu, su
    it = itertools.cycle(batches[1:])
    out.update(_nccl_share(lambda: step(state, row(next(it))),
                           args.profile_steps, device, rank0))
    out["ok"] = bool(ok)
    return out


def _dense(args, device, rank0, run, corpus, batches) -> dict:
    mesh = mesh_lib.make_mesh(n_model=args.n_model)
    cfg = dataclasses.replace(fsr.flagship_cfg(run), eval_fused_bins=0,
                              sparse_updates=False,
                              n_model_shards=args.n_model)
    cfg_u = dataclasses.replace(cfg, n_model_shards=1)

    def row(batch):
        b = batch["next_mask"].shape[0] // mesh.n_data
        d = mesh.data_index
        return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}

    model, state = pl.init_state(cfg, device, mesh=mesh)
    step = pl.select_train_step(model, cfg, corpus, cfg.seed, mesh=mesh)
    it = iter(batches[:args.steps])
    losses = []
    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}"}
    out["first_steps_ms"] = _timed(lambda: losses.append(float(step(
        state, row(next(it)))[1]["loss"])), args.steps, device)
    whole = pl.whole_params(state.params)
    moms = {n: mesh.gather_model(state.opt_state.state[p][
        "momentum_buffer"]).cpu() for n, p in state.params.named_parameters()}
    ok = True
    if rank0:
        mu, su = pl.init_state(cfg_u, device)
        step_u = pl.select_train_step(mu, cfg_u, corpus, cfg.seed)
        it_u = iter(batches[:args.steps])
        lu = []
        out["unsharded_ms"] = _timed(lambda: lu.append(float(step_u(
            su, next(it_u))[1]["loss"])), args.steps, device)
        diffs = {}
        for n, p in su.params.named_parameters():
            t = n.split(".")[0]
            diffs[f"{t} table"] = _share(torch.from_numpy(
                whole[t]["embedding"]), p.cpu())
            diffs[f"{t} momentum"] = _share(
                moms[n], su.opt_state.state[p]["momentum_buffer"].cpu())
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, lu))
        out.update(diffs=diffs, loss_rel=rel)
        for name, (dmax, _) in diffs.items():
            ok &= dmax <= (TABLE_ATOL if "table" in name else MOMENTUM_ATOL)
        ok &= rel <= 1e-4
    it = itertools.cycle(batches[args.steps:])
    out.update(_nccl_share(lambda: step(state, row(next(it))),
                           args.profile_steps, device, rank0))
    out["ok"] = bool(ok)
    return out


def _diffs(whole: Dict[str, np.ndarray], state) -> Dict[str, tuple]:
    """{name: (max abs diff, share off by more than 1e-6)} of the sharded
    state's whole tensors against the unsharded state."""
    out = {}
    for t in ("album", "artist"):
        for name, want in (
                (f"{t} table", getattr(state.params, f"{t}_embed").embedding),
                (f"{t} momentum", state.opt_state[t]["momentum"])):
            d = np.abs(whole[name] - want.detach().cpu().numpy())
            out[name] = (float(d.max()), float((d > 1e-6).mean()))
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_model", type=int, default=2)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--max_next", type=int, default=32)
    p.add_argument("--eval_playlists", type=int, default=2048)
    p.add_argument("--corpus_size", type=int, default=fsr.NUM_TRACKS)
    p.add_argument("--num_albums_raw", type=int, default=fsr.NUM_ALBUMS_RAW)
    p.add_argument("--album_buckets", type=int, default=fsr.ALBUM_BUCKETS)
    p.add_argument("--num_artists", type=int, default=fsr.NUM_ARTISTS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paths", default=",".join(PATHS),
                   help=f"comma-separated, of {','.join(PATHS)}")
    p.add_argument("--catalog_items", type=int, default=fsr.NUM_TRACKS)
    p.add_argument("--catalog_dim", type=int, default=64)
    p.add_argument("--serve_k", type=int, default=500)
    p.add_argument("--serve_reps", type=int, default=20)
    p.add_argument("--workload_steps", type=int, default=5)
    p.add_argument("--glove_rows", type=int, default=565_537)
    p.add_argument("--glove_dim", type=int, default=64)
    p.add_argument("--glove_batch", type=int, default=2048)
    p.add_argument("--t2u_words", type=int, default=565_537)
    p.add_argument("--t2u_urls", type=int, default=1_000_000)
    p.add_argument("--t2u_dim", type=int, default=64)
    p.add_argument("--t2u_batch", type=int, default=64)
    p.add_argument("--scale_rows", type=int, default=100_000_000)
    p.add_argument("--scale_ids", type=int, default=262_144)
    p.add_argument("--stl_image_size", type=int, default=512)
    p.add_argument("--stl_batch", type=int, default=16)
    p.add_argument("--stl_filters", default="16,32,64,128")
    p.add_argument("--allreduce_mib", type=int, default=0,
                   help="> 0: also time one all-reduce of this many MiB "
                        "over every rank (its bus bandwidth)")
    args = p.parse_args(argv)
    paths = [x for x in args.paths.split(",") if x]
    unknown = sorted(set(paths) - set(PATHS))
    if unknown:
        raise SystemExit(f"unknown paths {unknown}; choose of {PATHS}")

    device = resolve_device(args.device)
    own_group = not mesh_lib.is_initialized()
    mesh_lib.distributed_init_if_needed(device=device)
    if not mesh_lib.is_initialized():
        raise SystemExit("mesh_check runs under torchrun (or another "
                         "launcher that sets MASTER_ADDR, WORLD_SIZE, RANK)")
    device = mesh_lib.rank_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        from esrecsys_tpu_torch.kernels.build import build_all, kernel_sources

        if mesh_lib.process_index() == 0:  # one build; the others load it
            build_all(kernel_sources())
        dist.barrier()
        build_all(kernel_sources())
    mesh = mesh_lib.make_mesh(n_model=args.n_model)
    rank0 = mesh.rank == 0
    run = fsr.TrainRunConfig(
        out_dir="", steps=args.steps, batch_size=args.batch_size,
        max_next=args.max_next, eval_playlists=args.eval_playlists,
        num_tracks=args.corpus_size, num_albums_raw=args.num_albums_raw,
        album_buckets=args.album_buckets, num_artists=args.num_artists,
        seed=args.seed, device=str(device))
    cfg = dataclasses.replace(fsr.flagship_cfg(run), eval_fused_bins=0,
                              n_model_shards=args.n_model)
    cfg_u = dataclasses.replace(cfg, n_model_shards=1)
    corpus = {k: torch.from_numpy(v).to(device)
              for k, v in fsr.synth_corpus(run).items()}
    rng = np.random.default_rng(args.seed + 1)
    n_batches = args.steps + args.profile_steps
    batches = [pl.to_device(fsr.host_batch(rng, args.batch_size, 5,
                                           args.max_next, run), device)
               for _ in range(n_batches)]
    eval_batch = pl.to_device(fsr.host_batch(rng, args.eval_playlists, 5,
                                             args.max_next, run), device)

    def row(batch):
        b = batch["next_mask"].shape[0] // mesh.n_data
        d = mesh.data_index
        return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}

    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}",
           "ranks": mesh.n_data * mesh.n_model,
           "backend": dist.get_backend(), "card": card_line(device),
           "batch_size": args.batch_size, "steps": args.steps}
    ok = True
    if args.allreduce_mib:
        out["allreduce"] = _allreduce_bandwidth(args.allreduce_mib, 20,
                                                device)
    if "sparse" in paths:
        model_s, state_s = pl.init_state(cfg, device, mesh=mesh)
        if rank0:
            model_u, state_u = pl.init_state(cfg_u, device)

        # ---- the sharded eval against the exact one, from the init
        with torch.no_grad():
            sv, si = pl.make_sharded_eval_topk(model_s, cfg, corpus, mesh)(
                state_s, row(eval_batch))
            sv, si = mesh.gather_data(sv), mesh.gather_data(si)
        if rank0:
            xv, xi = pl.make_eval_topk(model_u, cfg_u, corpus)(state_u,
                                                               eval_batch)
            vals_equal = bool(torch.equal(sv, xv))
            sets_equal = bool(torch.equal(si.sort(-1).values,
                                          xi.sort(-1).values))
            out["eval"] = {"playlists": args.eval_playlists, "k": cfg.eval_k,
                           "scores_equal": vals_equal, "id_sets_equal":
                           sets_equal, "ids_equal": bool(torch.equal(si, xi))}
            ok &= vals_equal and sets_equal

        # ---- steps: sharded on every rank, unsharded on rank 0
        step_s = pl.make_sharded_train_step(model_s, cfg, corpus, mesh,
                                            cfg.seed)
        _sync(device)
        t0 = time.perf_counter()
        for b in batches[:args.steps]:
            state_s, m = step_s(state_s, row(b))
        _sync(device)
        out["sharded_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                      / args.steps)
        out["sharded_loss"] = float(m["loss"])
        tables = pl.whole_params(state_s.params)
        whole = {f"{t} table": tables[f"{t}_embed"]["embedding"]
                 for t in ("album", "artist")}
        for t in ("album", "artist"):
            whole[f"{t} momentum"] = mesh.gather_model(
                state_s.opt_state[t]["momentum"]).cpu().numpy()
        if rank0:
            step_u = pl.make_sparse_train_step(model_u, cfg_u, corpus,
                                               cfg.seed)
            _sync(device)
            t0 = time.perf_counter()
            for b in batches[:args.steps]:
                state_u, mu = step_u(state_u, b)
            _sync(device)
            out["unsharded_ms_per_step"] = (
                (time.perf_counter() - t0) * 1e3 / args.steps)
            out["unsharded_loss"] = float(mu["loss"])
            diffs = _diffs(whole, state_u)
            out["diffs"] = diffs
            for name, (d, _) in diffs.items():
                ok &= d <= (TABLE_ATOL if "table" in name else MOMENTUM_ATOL)
            ok &= abs(out["sharded_loss"] - out["unsharded_loss"]) \
                <= 1e-4 * abs(out["unsharded_loss"])

        # ---- the sharded step's device time and the collectives' share
        if args.profile_steps:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with (profile(activities=acts) if rank0
                  else contextlib.nullcontext()) as prof:
                for b in batches[args.steps:]:
                    state_s, _ = step_s(state_s, row(b))
                _sync(device)
            if rank0 and device.type == "cuda":
                from torch.autograd import DeviceType

                rows = [(e.key, e.self_device_time_total / 1e3
                         / args.profile_steps) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total]
                busy = sum(v for _, v in rows)
                nccl = sum(v for k, v in rows if "nccl" in k.lower())
                out.update(busy_ms_per_step=busy, nccl_ms_per_step=nccl,
                           nccl_share=nccl / busy if busy else None)
    new = {}
    for name, fn in (("serving", _serving), ("glove", _glove),
                     ("txt2url", _txt2url), ("scale_table", _scale_table),
                     ("stl", _stl)):
        if name in paths:
            new[name] = fn(args, device, rank0)
            ok &= new[name]["ok"]
    if "dense" in paths:
        new["dense"] = _dense(args, device, rank0, run, corpus, batches)
        ok &= new["dense"]["ok"]
    out["paths"] = new
    out["ok"] = bool(ok)
    dist.barrier()
    if rank0:
        print(json.dumps(out), flush=True)
    if own_group:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
