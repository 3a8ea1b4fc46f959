"""Multi-card scaling evidence for the flagship playlist step (counterpart
of ``esrecsys_tpu/tools/scaling_study.py``).

1. **Collective bytes of the sharded step** (``--mode collectives``): the
   flagship's row-sparse step (``bench.py:191-197``: D=32, 100,000 album
   buckets, 295,861 artists, B=2048, C=5, M=32, 512 shared negatives,
   bf16 scoring, momentum 0) runs on gloo ranks on the CPU for each
   ``(n_data, n_model)`` mesh, and ``core/mesh.py``'s per-kind byte
   counter (every collective of the step goes through a ``Mesh`` method)
   sums the bytes each kind of collective returns per step. The counts
   depend on the shapes only, not on the device. With the unsharded
   step's time they bound scaling efficiency as

       eff >= t_step / (t_step + collective_bytes / BW)       (no overlap)
       eff  = t_step / max(t_step, collective_bytes / BW)     (full overlap)

   The reference parses the collectives out of XLA's partitioned HLO;
   PyTorch issues its collectives from Python, so the port counts them
   where they are issued. ``BW`` is a published link rate of the H100 SXM
   (below). On a card the tool times the unsharded flagship step itself;
   on the CPU ``--step_ms`` must be given.

2. **Weak-scaling measurement** (``--mode measure``): the fixed-shape
   sparse step (D=32, 20,000 buckets, 5,000 artists, N=128 shared, B=1024
   global, C=5, M=16) on 1 process and on 2 where two cards are visible
   (NCCL, one card per process), or on 1 and 2 gloo ranks with ``--device
   cpu``; per-step ms and global examples/s per process.

Run (card): python -m esrecsys_tpu_torch.tools.scaling_study --mode collectives
            python -m esrecsys_tpu_torch.tools.scaling_study --mode measure
Smoke (CPU): add --device cpu (and --step_ms with collectives, and small
sizes: --batch_size 64 --album_buckets 1000 --num_artists 500 ...).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

# Published per-card link rates of the H100 SXM (NVIDIA's H100 datasheet):
# NVLink 4 joins the cards of one host at 900 GB/s per card, 450 GB/s in
# each direction; across hosts each card has one 400 Gb/s NIC (ConnectX-7
# NDR), 50 GB/s.
NVLINK_BYTES_PER_SEC = 450e9
NIC_BYTES_PER_SEC_PER_CARD = 50e9

MESHES = ((2, 1), (2, 2), (4, 2))

# the flagship step of bench.py:191-197 as the reference's study compiles it
FLAGSHIP = dict(batch_size=2048, feature_size=32, album_buckets=100_000,
                num_artists=295_861, num_negatives=512, context_size=5,
                max_next=32, corpus=262_144, albums_raw=700_000)
# the weak-scaling step's fixed shape
MEASURE = dict(batch_size=1024, feature_size=32, album_buckets=20_000,
               num_artists=5_000, num_negatives=128, context_size=5,
               max_next=16, corpus=4096, albums_raw=20_000)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def efficiency_bound(total_bytes: float, step_seconds: float,
                     bw_bytes_per_sec: float) -> Dict[str, float]:
    t_comm = total_bytes / bw_bytes_per_sec
    return {
        "comm_seconds": t_comm,
        "efficiency_no_overlap": step_seconds / (step_seconds + t_comm),
        "efficiency_full_overlap": step_seconds / max(step_seconds, t_comm),
    }


def step_cfg(shape: Dict, n_model: int = 1, compute_dtype: str = "bfloat16"):
    """The row-sparse step's configuration at ``shape`` (momentum 0)."""
    from esrecsys_tpu_torch.workloads import playlist as pl

    return pl.PlaylistConfig(
        feature_size=shape["feature_size"],
        album_hash_buckets=shape["album_buckets"],
        num_artists=shape["num_artists"],
        num_negatives=shape["num_negatives"],
        batch_size=shape["batch_size"], context_size=shape["context_size"],
        max_next=shape["max_next"], shared_negatives=True,
        sparse_updates=True, momentum=0.0, compute_dtype=compute_dtype,
        n_model_shards=n_model)


def synth_inputs(shape: Dict, b: int, rng):
    """(corpus, batch of ``b`` playlists) as numpy, uniform ids at
    ``shape``'s ranges."""
    import numpy as np

    n = shape["corpus"]
    corpus = {"tracks": np.arange(n, dtype=np.int32),
              "albums": rng.integers(0, shape["albums_raw"], n).astype(np.int32),
              "artists": rng.integers(0, shape["num_artists"],
                                      n).astype(np.int32)}
    c, m = shape["context_size"], shape["max_next"]
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)
    batch = {
        "track_context": ri(n, b, c), "album_context": ri(shape["albums_raw"], b, c),
        "artist_context": ri(shape["num_artists"], b, c),
        "next_track": ri(n, b, m), "next_album": ri(shape["albums_raw"], b, m),
        "next_artist": ri(shape["num_artists"], b, m),
        "next_mask": np.ones((b, m), np.float32),
    }
    return corpus, batch


# ------------------------------------------------------------- workers

def _worker(kind: str, spec: Dict) -> None:
    """One rank of a study (started by :func:`_spawn` with torchrun's
    environment): ``collectives`` counts a sharded step's bytes on gloo,
    ``measure`` times the weak-scaling step."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.core import mesh as mesh_lib
    from esrecsys_tpu_torch.workloads import playlist as pl

    device = torch.device(spec["device"])
    mesh_lib.distributed_init_if_needed(device=device)
    device = mesh_lib.rank_device(device)
    if device.type == "cuda":
        from esrecsys_tpu_torch.kernels.build import build_all, kernel_sources

        build_all(kernel_sources())
    n_data, n_model = spec["n_data"], spec["n_model"]
    mesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model)
    shape = spec["shape"]
    cfg = step_cfg(shape, n_model, spec["compute_dtype"])
    model, state = pl.init_state(cfg, device, mesh=mesh)
    rng = np.random.default_rng(0)
    if kind == "collectives":
        # every rank draws the global batch; its data row takes its slice
        corpus_np, batch_np = synth_inputs(shape, shape["batch_size"], rng)
        lb = shape["batch_size"] // n_data
        d = mesh.data_index
        batch_np = {k: v[d * lb:(d + 1) * lb] for k, v in batch_np.items()}
    else:
        # as the reference's worker: each process draws its own slice of
        # the global batch from the same seed; a data row is one rank
        lb = mesh_lib.process_local_batch(shape["batch_size"])
        corpus_np, batch_np = synth_inputs(shape, lb, rng)
    corpus = pl.to_device(corpus_np, device)
    batch = pl.to_device(batch_np, device)
    step = pl.make_sharded_train_step(model, cfg, corpus, mesh, seed=0)
    state, m = step(state, batch)  # first step: the groups' set-up
    float(m["loss"])
    n = spec["steps"]
    mesh_lib.COLLECTIVE_BYTES.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch)
    float(m["loss"])  # a barrier: the loss's copy to the host
    dt = time.perf_counter() - t0
    if kind == "collectives":
        counter = mesh_lib.COLLECTIVE_BYTES
        res = {"collectives": {k: {"count": counter.count[k] // n,
                                   "bytes": counter.bytes[k] // n}
                               for k in sorted(counter.bytes)},
               "exact_per_step": all(v % n == 0
                                     for v in list(counter.bytes.values())
                                     + list(counter.count.values()))}
    else:
        res = {"step_ms": dt / n * 1e3,
               "global_examples_per_s": shape["batch_size"] * n / dt}
    res.update(process=mesh_lib.process_index(),
               processes=mesh_lib.process_count())
    if kind == "measure" or mesh.rank == 0:
        print("RESULT", json.dumps(res), flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(kind: str, n_procs: int, spec: Dict, timeout: float = 1200.0
           ) -> List[Dict]:
    """``n_procs`` ranks of ``python -m ...scaling_study --worker kind`` on
    localhost, the repository found from this file; their RESULT lines."""
    port = _free_port()
    procs = []
    threads = max(1, (os.cpu_count() or 1) // n_procs)
    for rank in range(n_procs):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n_procs), RANK=str(rank),
                   LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS=env.get("OMP_NUM_THREADS", str(threads)),
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "esrecsys_tpu_torch.tools.scaling_study",
             "--worker", kind, "--spec", json.dumps(spec)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{kind} worker failed:\n{out[-3000:]}")
    return [json.loads(line[len("RESULT "):])
            for out in outs for line in out.splitlines()
            if line.startswith("RESULT ")]


# ------------------------------------------------------------- modes

def time_unsharded_step(shape: Dict, steps: int = 20, device=None
                        ) -> Tuple[float, Optional[str]]:
    """(host ms per step of the unsharded sparse step at ``shape`` on
    ``device``, the card's name and power limit), after 3 warm-up
    steps."""
    import numpy as np
    import torch

    from esrecsys_tpu_torch.core.device import card_line, resolve_device
    from esrecsys_tpu_torch.workloads import playlist as pl

    device = resolve_device(device)
    cfg = step_cfg(shape)
    model, state = pl.init_state(cfg, device)
    corpus_np, batch_np = synth_inputs(shape, shape["batch_size"],
                                       np.random.default_rng(0))
    corpus, batch = pl.to_device(corpus_np, device), pl.to_device(batch_np,
                                                                  device)
    step = pl.make_sparse_train_step(model, cfg, corpus, seed=0)
    for _ in range(3):
        state, m = step(state, batch)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    float(m["loss"])
    return (time.perf_counter() - t0) * 1e3 / steps, card_line(device)


def run_collectives_mode(step_ms: Optional[float], out_path: Optional[str],
                         shape: Optional[Dict] = None,
                         meshes: Sequence[Tuple[int, int]] = MESHES,
                         steps: int = 2, device="cuda") -> Dict:
    """Per mesh, the sharded step's collective bytes per step (gloo ranks
    on the CPU) and the efficiency bounds over NVLink and the NIC. On a
    card (``device``) ``step_ms`` defaults to the unsharded step's time
    measured there; on the CPU it must be given."""
    shape = dict(FLAGSHIP if shape is None else shape)
    report: Dict = {"shape": shape}
    if step_ms is None:
        if str(device).startswith("cpu"):
            raise ValueError("--step_ms is required on the CPU: the bound "
                             "needs a step time measured on a card")
        step_ms, card = time_unsharded_step(shape, device=device)
        report.update(step_ms_measured_on_card=step_ms, card=card)
    else:
        report["step_ms_given"] = step_ms
    report.update(nvlink_bytes_per_sec=NVLINK_BYTES_PER_SEC,
                  nic_bytes_per_sec_per_card=NIC_BYTES_PER_SEC_PER_CARD,
                  topologies=[])
    for n_data, n_model in meshes:
        res = _spawn("collectives", n_data * n_model, {
            "device": "cpu", "n_data": n_data, "n_model": n_model,
            "shape": shape, "steps": steps, "compute_dtype": "bfloat16"})
        if len(res) != 1 or not res[0]["exact_per_step"]:
            raise RuntimeError(f"mesh {n_data}x{n_model}: {res}")
        colls = res[0]["collectives"]
        total = sum(v["bytes"] for v in colls.values())
        row = {"mesh": {"data": n_data, "model": n_model},
               "batch_size": shape["batch_size"], "collectives": colls,
               "total_collective_bytes_per_step": total,
               "nvlink": efficiency_bound(total, step_ms / 1e3,
                                          NVLINK_BYTES_PER_SEC),
               "nic": efficiency_bound(total, step_ms / 1e3,
                                       NIC_BYTES_PER_SEC_PER_CARD)}
        report["topologies"].append(row)
        log.info("mesh=%s total=%.3f MB/step  nvlink_eff>=%.4f  "
                 "nic_eff>=%.4f", row["mesh"], total / 1e6,
                 row["nvlink"]["efficiency_no_overlap"],
                 row["nic"]["efficiency_no_overlap"])
    _write(report, out_path)
    return report


def run_measure_mode(steps: int, out_path: Optional[str], device="cuda",
                     procs: Optional[Sequence[int]] = None) -> Dict:
    """The weak-scaling rows: the fixed-shape step on each process count
    of ``procs`` (default 1, and 2 where two cards are visible or on the
    CPU)."""
    import torch

    from esrecsys_tpu_torch.core.device import card_line, resolve_device

    dev = resolve_device(device)
    if procs is None:
        procs = [1] + ([2] if dev.type == "cpu"
                       or torch.cuda.device_count() >= 2 else [])
    if dev.type == "cuda" and max(procs) > torch.cuda.device_count():
        raise ValueError(f"{max(procs)} processes need as many cards; "
                         f"{torch.cuda.device_count()} are visible")
    rows = []
    for n_procs in procs:
        res = _spawn("measure", n_procs, {
            "device": dev.type, "n_data": n_procs, "n_model": 1,
            "shape": MEASURE, "steps": steps, "compute_dtype": "float32"})
        rows.append({"processes": n_procs,
                     "per_process": sorted(res, key=lambda r: r["process"])})
        log.info("%d-process: %s", n_procs, res)
    report = {"rows": rows, "device": dev.type, "card": card_line(dev)}
    if len(rows) > 1:
        t1 = rows[0]["per_process"][0]["step_ms"]
        t2 = max(r["step_ms"] for r in rows[1]["per_process"])
        report["weak_scaling_step_ratio_1p_over_2p"] = t1 / t2
    if dev.type == "cpu":
        report["caveat"] = (
            "gloo ranks share this host's cores: the 2-process row "
            "measures core contention, not interconnect cost; a "
            "functional proof and a ceiling only")
    _write(report, out_path)
    return report


def _write(report: Dict, out_path: Optional[str]) -> None:
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        log.info("wrote %s", out_path)


def main(argv=None) -> Optional[Dict]:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=["collectives", "measure"],
                   default="collectives")
    p.add_argument("--step_ms", type=float, default=None,
                   help="the unsharded flagship step's ms on a card "
                        "(default: measured here; required on the CPU)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--meshes", default="2x1,2x2,4x2",
                   help="collectives: data x model meshes")
    for k, v in FLAGSHIP.items():
        p.add_argument(f"--{k}", type=int, default=v,
                       help="collectives: the step's shape")
    p.add_argument("--out", default="")
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    p.add_argument("--spec", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker, json.loads(args.spec))
        return None
    if args.mode == "collectives":
        meshes = [tuple(int(x) for x in m.split("x"))
                  for m in args.meshes.split(",") if m]
        report = run_collectives_mode(
            args.step_ms, args.out or None,
            shape={k: getattr(args, k) for k in FLAGSHIP}, meshes=meshes,
            device=args.device)
    else:
        report = run_measure_mode(args.steps, args.out or None,
                                  device=args.device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
