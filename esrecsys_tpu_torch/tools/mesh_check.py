"""The playlist's sharded step and eval on a mesh of ranks, held against
the unsharded code on rank 0, at the flagship's widths by default.

    torchrun --nproc_per_node 4 -m esrecsys_tpu_torch.tools.mesh_check \
        --n_model 2
    # on the CPU (gloo): add --device cpu and small sizes, e.g.
    #   --batch_size 32 --max_next 8 --eval_playlists 16 --corpus_size 3000
    #   --num_albums_raw 900 --album_buckets 300 --num_artists 500

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

Measures the host ms per step of both (the sharded step on every card,
the unsharded one on rank 0's) and, from ``torch.profiler`` on rank 0, the
device time of the sharded step and the NCCL kernels' share of it. Rank 0
prints one JSON line; the exit code is 1 when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    args = p.parse_args(argv)

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

    model_s, state_s = pl.init_state(cfg, device, mesh=mesh)
    if rank0:
        model_u, state_u = pl.init_state(cfg_u, device)
    out = {"mesh": f"{mesh.n_data}x{mesh.n_model}",
           "ranks": mesh.n_data * mesh.n_model,
           "backend": dist.get_backend(), "card": card_line(device),
           "batch_size": args.batch_size, "steps": args.steps}
    ok = True

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
    step_s = pl.make_sharded_train_step(model_s, cfg, corpus, mesh, cfg.seed)
    _sync(device)
    t0 = time.perf_counter()
    for b in batches[:args.steps]:
        state_s, m = step_s(state_s, row(b))
    _sync(device)
    out["sharded_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / args.steps
    out["sharded_loss"] = float(m["loss"])
    tables = pl.whole_params(state_s.params)
    whole = {f"{t} table": tables[f"{t}_embed"]["embedding"]
             for t in ("album", "artist")}
    for t in ("album", "artist"):
        whole[f"{t} momentum"] = mesh.gather_model(
            state_s.opt_state[t]["momentum"]).cpu().numpy()
    if rank0:
        step_u = pl.make_sparse_train_step(model_u, cfg_u, corpus, cfg.seed)
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
        ok &= abs(out["sharded_loss"] - out["unsharded_loss"]) <= 1e-4 * abs(
            out["unsharded_loss"])

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
    out["ok"] = bool(ok)
    dist.barrier()
    if rank0:
        print(json.dumps(out), flush=True)
    if own_group:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
