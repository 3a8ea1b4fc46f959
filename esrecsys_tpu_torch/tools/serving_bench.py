"""Serving-mode bench (counterpart of ``esrecsys_tpu/tools/serving_bench.py``):
throughput and quality of every retrieval mode through the real serving
path, ``RetrievalService.topk`` (HTTP framing excluded):

  exact            streamed exact top-k (retrieval/mips.topk_over_matrix)
  approx           approx_max_k selection per block + float32 rescore
  fused            the fused scan+select kernel (retrieval/fused.py):
                   per-bin top-2 during the scan (``--fused_bins`` = L)
  fused_q8         the int8 fused kernel, float32 rescore
  fused_q8_r8      the int8 fused kernel, int8 rescore: no float32 catalog
  quantized        int8 catalog scan + float32 rescore
  quantized_approx int8 scan + approx_max_k selection
  quantized_r8     int8 scan + int8 rescore: no float32 catalog
  filtered         exact, every query under a 50% eligibility filter
  ivf              k-means inverted file, nprobe cells per query
                   (``--ivf_max_cell`` caps a cell's rows)
  ivf_quantized    ivf probe, candidates scored from int8 rows
  pq               PQ ADC scan of S-byte codes + float32 rescore
                   (``--pq_subspaces/--pq_oversample/--pq_rotate``)
  ivf_pq           ivf probe + ADC candidate scoring + float32 rescore
  pq_r8            PQ ADC scan + int8 rescore (S+D+4 bytes/item)
  ivf_pq_r8        ivf probe + ADC + int8 rescore (no float32 catalog)

Reported per mode: ``queries_per_s`` (host clock, ``--reps`` passes over
``--queries`` queries in ``--batch`` chunks), ``overlap_vs_exact`` (mean
share of the exact mode's ids, on ``--overlap_queries`` queries; the
filtered mode against the exact top-k of its eligible rows),
``setup_s`` (upload, quantize, scan copy, k-means builds, warm-up query)
and ``resident_bytes_per_item``; the IVF modes add ``ivf_imbalance`` and
``ivf_lmax``, the PQ modes ``pq_bytes_per_item``. Latency percentiles
live in the server's ``/statsz``.

Catalogs are synthetic: Gaussian by default, ``--structured`` a mixture
of components (clusterable, like trained embeddings).

Run (card): python -m esrecsys_tpu_torch.tools.serving_bench \\
    --items 2262292 --dim 64 --k 500 --batch 256 \\
    --modes exact,approx,fused,fused_q8,fused_q8_r8,quantized,\\
quantized_approx,quantized_r8,filtered,ivf,ivf_quantized,pq,ivf_pq,\\
pq_r8,ivf_pq_r8
Smoke (CPU): --device cpu --items 20000 --queries 256 --batch 32 --k 50 \\
    --ivf_clusters 64 --nprobe 8 --modes exact,approx,quantized,ivf,pq
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import card_line, resolve_device

log = logging.getLogger(__name__)

MODES = ("exact", "approx", "fused", "fused_q8", "fused_q8_r8",
         "quantized", "quantized_approx",
         "ivf", "ivf_quantized", "pq", "ivf_pq",
         "quantized_r8", "pq_r8", "ivf_pq_r8", "filtered")
# the bench's defaults for the IVF and PQ modes' knobs
IVF_PQ_DEFAULTS = {"ivf_clusters": 4096, "nprobe": 64, "ivf_iters": 10,
                   "pq_subspaces": 8, "pq_oversample": 64, "pq_rotate": False,
                   "pq_anisotropic": 0.0}


def make_catalog(n: int, dim: int, structured: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    if structured:
        n_comp = max(16, n // 1000)
        means = rng.normal(size=(n_comp, dim)).astype(np.float32) * 3.0
        comp = rng.integers(0, n_comp, n)
        x = means[comp] + rng.normal(size=(n, dim)).astype(np.float32) * 0.3
        return x.astype(np.float32)
    return rng.normal(size=(n, dim)).astype(np.float32)


def mode_kwargs(mode: str, args) -> dict:
    """Serving keywords of a named retrieval mode, the reference's.

    ``args`` is any object carrying the build knobs (this bench's and
    ``tools/full_scale_run``'s run config both do): ``recall_target``,
    ``fused_bins``, and for the IVF and PQ modes the knobs of
    ``IVF_PQ_DEFAULTS``, ``ivf_max_cell`` and ``build_train_sample``
    (those the object lacks take the bench's defaults). The dict feeds
    ``RetrievalService(index, **kw)`` and ``serving.server.serve(path,
    **kw)`` alike."""
    def knob(name):  # the IVF/PQ knobs: the bench's defaults if absent
        return getattr(args, name, IVF_PQ_DEFAULTS[name])

    kw = {}
    bins = getattr(args, "fused_bins", 4096)
    if mode == "approx":
        kw.update(approx=True, recall_target=args.recall_target)
    elif mode == "fused":
        kw.update(fused=True, fused_bins=bins)
    elif mode == "fused_q8":
        kw.update(fused=True, quantized=True, fused_bins=bins)
    elif mode == "fused_q8_r8":
        kw.update(fused=True, quantized=True, rescore_int8=True,
                  fused_bins=bins)
    elif mode == "quantized":
        kw.update(quantized=True)
    elif mode == "quantized_approx":
        kw.update(quantized=True, approx=True,
                  recall_target=args.recall_target)
    elif mode == "quantized_r8":
        kw.update(quantized=True, rescore_int8=True)
    elif mode in ("ivf", "ivf_quantized", "ivf_pq", "ivf_pq_r8"):
        kw.update(ivf_clusters=knob("ivf_clusters"), nprobe=knob("nprobe"),
                  ivf_iters=knob("ivf_iters"))
    if mode in ("pq", "ivf_pq", "pq_r8", "ivf_pq_r8"):
        kw.update(pq_subspaces=knob("pq_subspaces"),
                  pq_oversample=knob("pq_oversample"),
                  pq_rotate=knob("pq_rotate"),
                  pq_anisotropic=knob("pq_anisotropic") or None)
    if mode == "ivf_quantized":
        kw.update(quantized=True)
    if mode in ("pq_r8", "ivf_pq_r8"):
        kw.update(rescore_int8=True)
    if mode.startswith("ivf") and getattr(args, "ivf_max_cell", 0):
        kw.update(ivf_max_cell=args.ivf_max_cell)
    if getattr(args, "build_train_sample", 0) and (
            "ivf" in mode or "pq" in mode):
        kw.update(build_train_sample=args.build_train_sample)
    return kw


def service_for(mode: str, index, k: int, batch: int, args):
    from esrecsys_tpu_torch.serving.server import RetrievalService

    if mode == "filtered":
        return RetrievalService(index, max_k=k, max_batch=batch, filters={},
                                device=args.device)
    return RetrievalService(index, max_k=k, max_batch=batch,
                            device=args.device, **mode_kwargs(mode, args))


def filtered_truth(vecs: np.ndarray, queries: np.ndarray, k: int,
                   device) -> np.ndarray:
    """Catalog rows of the exact top-k over the even rows (the filtered
    mode's eligible half), computed on ``device``."""
    from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix

    _, ids = topk_over_matrix(torch.from_numpy(queries).to(device),
                              torch.from_numpy(vecs[::2]).to(device), k)
    return ids.cpu().numpy() * 2


def bench_mode(mode: str, index, queries: np.ndarray, k: int, args,
               exact_ids, vecs=None):
    t0 = time.perf_counter()
    svc = service_for(mode, index, k, args.batch, args)
    fkw = {}
    if mode == "filtered":
        # a 50% eligibility mask (the even rows), registered up front
        svc.set_filter("bench", index.ids[::2])
        fkw = {"filter": "bench"}
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ids = None
    for _ in range(args.reps):
        ids, _ = svc.topk(queries, k=k, **fkw)
    wall = time.perf_counter() - t0
    qps = args.reps * queries.shape[0] / wall

    sub = min(queries.shape[0], args.overlap_queries)
    want = None
    if mode == "filtered" and vecs is not None:
        want = filtered_truth(vecs, queries[:sub], k, svc.device).astype(str)
    elif exact_ids is not None:
        want = exact_ids
    overlap = None if want is None else float(np.mean([
        len(set(ids[b]) & set(want[b])) / k for b in range(sub)]))
    out = {"mode": mode, "queries_per_s": round(qps, 1),
           "overlap_vs_exact": overlap, "setup_s": round(setup_s, 2),
           "resident_bytes_per_item": svc.resident_bytes_per_item}
    if svc.ivf is not None:
        out["ivf_imbalance"] = round(svc.ivf.imbalance, 2)
        out["ivf_lmax"] = int(svc.ivf.bucket_ids.shape[1])
    if svc.pq is not None:
        out["pq_bytes_per_item"] = svc.pq.bytes_per_item
    return out, ids


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--items", type=int, default=2_262_292)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--k", type=int, default=500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--queries", type=int, default=2048)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--overlap_queries", type=int, default=256)
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--structured", action="store_true")
    p.add_argument("--recall_target", type=float, default=0.95)
    p.add_argument("--fused_bins", type=int, default=4096,
                   help="fused-mode bin count (retrieval/fused.py)")
    d = IVF_PQ_DEFAULTS
    p.add_argument("--ivf_clusters", type=int, default=d["ivf_clusters"])
    p.add_argument("--nprobe", type=int, default=d["nprobe"])
    p.add_argument("--ivf_iters", type=int, default=d["ivf_iters"])
    p.add_argument("--build_train_sample", type=int, default=0)
    p.add_argument("--ivf_max_cell", type=int, default=0)
    p.add_argument("--pq_subspaces", type=int, default=d["pq_subspaces"])
    p.add_argument("--pq_oversample", type=int, default=d["pq_oversample"])
    p.add_argument("--pq_rotate", action="store_true")
    p.add_argument("--pq_anisotropic", type=float,
                   default=d["pq_anisotropic"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="runs/serving_bench.json")
    args = p.parse_args(argv)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    bad = set(modes) - set(MODES)
    if bad:
        raise SystemExit(f"unknown modes {sorted(bad)}; pick from {MODES}")
    device = resolve_device(args.device)
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

    vecs = make_catalog(args.items, args.dim, args.structured)
    index = EmbeddingIndex([str(i) for i in range(args.items)], vecs)
    rng = np.random.default_rng(99)
    # queries near the catalog manifold (the serving case)
    qrows = rng.integers(0, args.items, args.queries)
    queries = (vecs[qrows] + rng.normal(size=(args.queries, args.dim))
               .astype(np.float32) * 0.1)
    if "exact" in modes:  # run exact first: it is the overlap reference
        modes = ["exact"] + [m for m in modes if m != "exact"]
    results = []
    exact_ids = None
    for mode in modes:
        res, ids = bench_mode(mode, index, queries, args.k, args,
                              exact_ids if mode != "exact" else None,
                              vecs=vecs)
        if mode == "exact":
            exact_ids = ids
        results.append(res)
        log.info("%s", res)
    out = {"items": args.items, "dim": args.dim, "k": args.k,
           "batch": args.batch, "queries": args.queries, "reps": args.reps,
           "structured": args.structured, "device": str(device),
           "card": card_line(device), "results": results}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
