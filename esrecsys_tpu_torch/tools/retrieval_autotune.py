"""Retrieval auto-tuner (counterpart of
``esrecsys_tpu/tools/retrieval_autotune.py``): pick the cheapest serving
mode that meets a recall target on YOUR catalog, and print the serving
flags that turn it on.

  1. sample calibration queries (perturbed catalog rows: serving queries
     are context embeddings near, not at, item rows);
  2. compute the exact float32 top-k once (TF32 off);
  3. build each candidate structure ONCE (IVF index, PQ codebooks, int8
     catalog), then sweep each mode's knob ascending (bins / nprobe /
     oversample) until the target recall is met on calibration;
  4. rank every config that met the target by scan traffic per query
     (bytes the catalog scan moves per query), or, with
     ``--measure_throughput``, by MEASURED queries/s of each feasible
     config on this host's card.

Cost model (bytes of catalog traffic per query vector, D-dim float32, M
items, S-byte PQ codes, IVF probe width ``nprobe x Lmax``):

  exact         4*D*M                 int8        D*M
  fused         2*D*M                 ivf         4*D*nprobe*Lmax
  ivf_int8      D*nprobe*Lmax         pq          S*M + 4*D*cand
  ivf_pq        S*nprobe*Lmax + 4*D*cand

(``cand``: exact-rescore candidates, about oversample*k.) Residency is
reported per item beside it (float32 catalog plus aux structures, as
``/statsz`` counts it), so a memory limit can veto a winner.

Bytes are a proxy that misranks selection-bound modes: a scan that moves
fewer bytes can still lose to one whose selection is cheaper. With
``--measure_throughput`` each feasible config is timed on this host (its
catalog resident on the card, each batch ending on the ids' copy to the
host after a device synchronize) and ranked by q/s: run it on the
serving hardware for deployment decisions.

``--approx`` serving is not calibrated here, as in the reference tool:
its recall contract is its own ``recall_target`` knob.

The fused rows run the card's fused scan at the catalog's dim (the tuned
kernel at its dims, the generic one at every other; the plain version on
the CPU), after serving's ``validate_fused_bins`` check. Prebuilt structures (``ivf_index`` / ``pq_book``, e.g. from
either package's npz) can be passed in place of the builds.

Run (card): python -m esrecsys_tpu_torch.tools.retrieval_autotune \\
    --artifact catalog.npz --target_recall 0.95 --k 10 [--measure_throughput]
Smoke (CPU): add --device cpu --n_items 3000 --dim 16
Prints the recommended mode and flags; the full ranking goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import card_line, resolve_device
# the SAME metric the quality study reports: calibration and study must
# never drift apart
from esrecsys_tpu_torch.tools.retrieval_quality_study import recall as _recall

log = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batched_found(fn, queries: np.ndarray, batch: int,
                   device: torch.device) -> np.ndarray:
    """Run a (vals, idx) top-k fn over query batches; pad slots (-inf
    scores come back as index 0) become -1. Each batch ends on a barrier:
    a device synchronize, then the ids' copy to the host."""
    found = []
    for s in range(0, queries.shape[0], batch):
        vals, idx = fn(torch.from_numpy(queries[s:s + batch]).to(device))
        idx = torch.where(torch.isfinite(vals), idx, -1)
        _sync(device)
        found.append(idx.cpu().numpy())
    return np.concatenate(found)


def autotune(vecs: np.ndarray, queries: np.ndarray, target_recall: float,
             k: int = 10,
             nprobes=(1, 2, 4, 8, 16, 32, 64, 128),
             oversamples=(4, 16, 64, 256),
             ivf_clusters: int = 0, ivf_max_cell: int = 0,
             pq_subspaces: int = 8, pq_rotate: bool = False,
             pq_anisotropic: float = 0.0,
             build_iters: int = 10, train_sample: int = 0,
             batch: int = 64,
             fused_bins_sweep=(512, 1024, 2048, 4096, 8192),
             measure_throughput: bool = False,
             device=None, ivf_index=None, pq_book=None) -> dict:
    """Calibrate every candidate mode on (vecs, queries) on ``device``
    (default: the card); return the ranked feasible configs. Recall is a
    function of the catalog's geometry and the index math; with
    ``measure_throughput`` the ranking times each feasible config on this
    host's device. ``ivf_index`` (an ``IVFIndex``) and ``pq_book`` (a
    ``PQCodebook``) replace the builds when given."""
    from esrecsys_tpu_torch.retrieval.fused import (binned_topk_over_matrix,
                                                    pack_catalog,
                                                    validate_fused_bins)
    from esrecsys_tpu_torch.retrieval.ivf import IVFIndex, ivf_pq_topk, ivf_topk
    from esrecsys_tpu_torch.retrieval.mips import (quantize_rows,
                                                   quantized_topk_over_matrix,
                                                   topk_over_matrix)
    from esrecsys_tpu_torch.retrieval.pq import PQCodebook, pq_topk

    device = resolve_device(device)
    if device.type == "cuda":
        # the ground truth and every rescore are full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
    m, d = vecs.shape
    if not ivf_clusters:
        # sqrt-law default, rounded to a power of two, >= 16
        ivf_clusters = max(16, 1 << int(np.log2(max(16.0, np.sqrt(m)))))
    ts = train_sample or None
    queries = np.ascontiguousarray(queries, np.float32)
    seconds = {}

    items = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(device)
    t0 = time.perf_counter()
    truth = topk_over_matrix(torch.from_numpy(queries).to(device), items,
                             k)[1].cpu().numpy()
    seconds["ground_truth"] = time.perf_counter() - t0
    log.info("ground truth: %d queries, k=%d (%.1fs)", len(queries), k,
             seconds["ground_truth"])

    configs = []  # every (mode, knob) tried, feasible or not

    def found(fn):
        return _batched_found(fn, queries, batch, device)

    def add(mode, knob, recall, scan_bytes, resident, kwargs, flags,
            fn=None):
        configs.append({
            "mode": mode, "knob": knob, "recall": round(recall, 4),
            "scan_bytes_per_query": int(scan_bytes),
            "resident_bytes_per_item": round(resident, 1),
            "meets_target": recall >= target_recall,
            "kwargs": kwargs, "flags": flags,
            "_fn": fn})  # curried top-k fn; popped before return
        log.info("%-14s %-22s recall=%.3f scan=%.2f MB/query", mode,
                 str(knob), recall, scan_bytes / 1e6)

    # every closure below takes device-resident arguments built once; a
    # call uploads only its query batch

    # ---- exact & int8 full scans (no knob) --------------------------------
    add("exact", None, 1.0, 4 * d * m, 4 * d, {}, "",
        fn=lambda q: topk_over_matrix(q, items, k))
    q8, scales = quantize_rows(items)
    fn8 = lambda q: quantized_topk_over_matrix(q, q8, scales, items, k,
                                               select="exact")
    r8 = _recall(found(fn8), truth)
    add("int8", None, r8, d * m, 4 * d + d + 4, {"quantized": True},
        "--quantized", fn=fn8)

    # ---- fused scan+select (bins sweep) ------------------------------------
    # recall rises about quadratically with L (expected losses C(k,3)/L^2);
    # calibration runs the real kernel, so bf16 selection effects count
    for L in fused_bins_sweep:
        validate_fused_bins(L, d, device=device)
        packed = pack_catalog(items, L)
        fnf = (lambda q, _L=L, _p=packed:
               binned_topk_over_matrix(q, items, k, num_bins=_L,
                                       items_packed=_p))
        r = _recall(found(fnf), truth)
        add("fused", {"bins": L}, r, 2 * d * m + 4 * d * k,
            4 * d + 2 * d, {"fused": True, "fused_bins": L},
            f"--fused --fused_bins {L}", fn=fnf)
        if r >= target_recall:
            break

    # ---- IVF (probe sweep), f32 and int8 candidate gathers ----------------
    t0 = time.perf_counter()
    index = ivf_index if ivf_index is not None else IVFIndex.build(
        items, ivf_clusters, iters=build_iters,
        max_cell=ivf_max_cell or None, train_sample=ts)
    seconds["ivf_build"] = time.perf_counter() - t0
    log.info("ivf %s: C=%d Lmax=%d (%.1fs)",
             "given" if ivf_index is not None else "built", index.n_clusters,
             index.bucket_ids.shape[1], seconds["ivf_build"])
    cent = torch.from_numpy(index.centroids).to(device)
    buckets = torch.from_numpy(index.bucket_ids).to(device)
    lmax = index.bucket_ids.shape[1]
    ivf_kw = {"ivf_clusters": ivf_clusters, "ivf_iters": build_iters}
    ivf_fl = f"--ivf_clusters {ivf_clusters} --ivf_iters {build_iters}"
    if ivf_max_cell:
        ivf_kw["ivf_max_cell"] = ivf_max_cell
        ivf_fl += f" --ivf_max_cell {ivf_max_cell}"
    for p in nprobes:
        if p > index.n_clusters:
            break
        fn = lambda q, _p=p: ivf_topk(q, cent, buckets, items, k, _p)
        r = _recall(found(fn), truth)
        # residency as /statsz counts it: +4 = the int32 bucket slot
        add("ivf", {"nprobe": p}, r, 4 * d * p * lmax, 4 * d + 4,
            dict(ivf_kw, nprobe=p), f"{ivf_fl} --nprobe {p}", fn=fn)
        if r >= target_recall:
            break
    for p in nprobes:
        if p > index.n_clusters:
            break
        fn = lambda q, _p=p: ivf_topk(q, cent, buckets, items, k, _p,
                                      q_items=q8, item_scales=scales)
        r = _recall(found(fn), truth)
        add("ivf_int8", {"nprobe": p}, r, d * p * lmax,
            4 * d + d + 4 + 4,
            dict(ivf_kw, nprobe=p, quantized=True),
            f"{ivf_fl} --nprobe {p} --quantized", fn=fn)
        if r >= target_recall:
            break

    # ---- PQ (oversample sweep) + IVF-PQ (probe sweep at max budget) -------
    t0 = time.perf_counter()
    pq_iters = max(build_iters, 15)
    book = pq_book if pq_book is not None else PQCodebook.build(
        items, pq_subspaces, iters=pq_iters, rotate=pq_rotate,
        anisotropic_threshold=pq_anisotropic or None, train_sample=ts)
    seconds["pq_build"] = time.perf_counter() - t0
    log.info("pq %s: S=%d rot=%s aniso=%s (%.1fs)",
             "given" if pq_book is not None else "built", book.n_subspaces,
             book.rotation is not None, book.anisotropic_threshold,
             seconds["pq_build"])
    pq_cent = torch.from_numpy(book.centroids).to(device)
    pq_codes = torch.from_numpy(book.codes).to(device)
    rot = (torch.from_numpy(book.rotation).to(device)
           if book.rotation is not None else None)
    s_b = book.bytes_per_item
    # pin the calibrated build depth: a serving rebuild at a different
    # pq_iters would be a DIFFERENT codebook than the one that met target
    pq_kw = {"pq_subspaces": pq_subspaces, "pq_iters": pq_iters}
    pq_fl = f"--pq_subspaces {pq_subspaces} --pq_iters {pq_iters}"
    if pq_rotate:
        pq_kw["pq_rotate"] = True
        pq_fl += " --pq_rotate"
    if pq_anisotropic:
        pq_kw["pq_anisotropic"] = pq_anisotropic
        pq_fl += f" --pq_anisotropic {pq_anisotropic}"
    for o in oversamples:
        fn = lambda q, _o=o: pq_topk(q, pq_cent, pq_codes, k,
                                     rescore_items=items, oversample=_o,
                                     rotation=rot)
        r = _recall(found(fn), truth)
        add("pq", {"oversample": o}, r, s_b * m + 4 * d * o * k,
            4 * d + s_b, dict(pq_kw, pq_oversample=o),
            f"{pq_fl} --pq_oversample {o}", fn=fn)
        if r >= target_recall:
            break
    o_max = max(oversamples)
    for p in nprobes:
        if p > index.n_clusters:
            break
        fn = lambda q, _p=p: ivf_pq_topk(
            q, cent, buckets, items, k, _p, pq_centroids=pq_cent,
            pq_codes=pq_codes, oversample=o_max, rotation=rot)
        r = _recall(found(fn), truth)
        add("ivf_pq", {"nprobe": p, "oversample": o_max}, r,
            s_b * p * lmax + 4 * d * o_max * k, 4 * d + s_b + 4,
            dict(ivf_kw, **pq_kw, nprobe=p, pq_oversample=o_max),
            f"{ivf_fl} {pq_fl} --nprobe {p} --pq_oversample {o_max}",
            fn=fn)
        if r >= target_recall:
            break

    if measure_throughput:
        # rank by reality, not the bytes proxy: steady-state wall over
        # repeated batched calls, each batch ending on its barrier
        for c in configs:
            if not c["meets_target"] or c["_fn"] is None:
                continue
            _batched_found(c["_fn"], queries[:batch], batch, device)  # warm
            t0 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                _batched_found(c["_fn"], queries, batch, device)
            wall = time.perf_counter() - t0
            c["queries_per_s"] = round(reps * queries.shape[0] / wall, 1)
            log.info("%-14s %-22s measured %.1f q/s", c["mode"],
                     str(c["knob"]), c["queries_per_s"])

    for c in configs:
        c.pop("_fn", None)
    feasible = sorted(
        (c for c in configs if c["meets_target"]),
        key=((lambda c: -c.get("queries_per_s", 0.0))
             if measure_throughput
             else (lambda c: c["scan_bytes_per_query"])))
    return {
        "n_items": int(m), "dim": int(d), "k": k,
        "target_recall": target_recall,
        "n_queries": int(queries.shape[0]),
        "ranked_by": ("measured_queries_per_s" if measure_throughput
                      else "scan_bytes_per_query"),
        "recommended": feasible[0] if feasible else None,
        "feasible": feasible,
        "all_configs": configs,
        "build_seconds": {k_: round(v, 3) for k_, v in seconds.items()},
        "card": card_line(device),
    }


def calibration_queries(vecs: np.ndarray, n_queries: int, noise: float,
                        rng: np.random.Generator) -> np.ndarray:
    """The reference's calibration queries: ``n_queries`` distinct catalog
    rows plus ``noise`` times the catalog's std of gaussian noise."""
    qi = rng.choice(vecs.shape[0], n_queries, replace=False)
    return (vecs[qi] + noise * vecs.std()
            * rng.standard_normal((n_queries, vecs.shape[1]))
            ).astype(np.float32)


def main(argv=None) -> Optional[dict]:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--artifact", default="",
                   help="EmbeddingIndex .npz to tune for (else synthetic)")
    p.add_argument("--target_recall", type=float, default=0.95)
    p.add_argument("--k", type=int, default=10,
                   help="recall@k the target applies to (match serving k)")
    p.add_argument("--n_queries", type=int, default=256)
    p.add_argument("--query_noise", type=float, default=0.1,
                   help="calibration queries = catalog rows + this much "
                        "gaussian noise (x row std)")
    p.add_argument("--ivf_clusters", type=int, default=0,
                   help="IVF coarse clusters (0 = sqrt(M) power of two)")
    p.add_argument("--ivf_max_cell", type=int, default=0)
    p.add_argument("--pq_subspaces", type=int, default=8)
    p.add_argument("--pq_rotate", action="store_true")
    p.add_argument("--pq_anisotropic", type=float, default=0.0)
    p.add_argument("--build_iters", type=int, default=10)
    p.add_argument("--build_train_sample", type=int, default=0)
    p.add_argument("--nprobes", default="1,2,4,8,16,32,64,128")
    p.add_argument("--oversamples", default="4,16,64,256")
    p.add_argument("--fused_bins_sweep", default="512,1024,2048,4096,8192",
                   help="fused-mode bin counts tried ascending "
                        "(retrieval/fused.py; recall ~ 1 - C(k,3)/(L^2 k))")
    p.add_argument("--measure_throughput", action="store_true",
                   help="rank feasible configs by MEASURED q/s on this "
                        "host instead of the scan-bytes proxy (run on the "
                        "serving hardware; see module docstring)")
    # synthetic fallback knobs (demo / CI)
    p.add_argument("--n_items", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--regime", default="clustered")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="runs/retrieval_autotune.json")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    if args.artifact:
        from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

        vecs = np.asarray(EmbeddingIndex.load(args.artifact).vectors,
                          np.float32)
        queries = calibration_queries(vecs, args.n_queries,
                                      args.query_noise, rng)
    else:
        from esrecsys_tpu_torch.tools.retrieval_quality_study import \
            synth_catalog

        vecs, queries = synth_catalog(args.regime, args.n_items,
                                      args.n_queries, args.dim, rng)

    result = autotune(
        vecs, queries, args.target_recall, k=args.k,
        nprobes=[int(x) for x in args.nprobes.split(",")],
        oversamples=[int(x) for x in args.oversamples.split(",")],
        ivf_clusters=args.ivf_clusters, ivf_max_cell=args.ivf_max_cell,
        pq_subspaces=args.pq_subspaces, pq_rotate=args.pq_rotate,
        pq_anisotropic=args.pq_anisotropic,
        build_iters=args.build_iters,
        train_sample=args.build_train_sample,
        fused_bins_sweep=[int(x) for x in args.fused_bins_sweep.split(",")],
        measure_throughput=args.measure_throughput, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    rec = result["recommended"]
    if rec is None:
        print(json.dumps({"recommended": None,
                          "note": "no config met target; raise knob caps "
                                  "or lower --target_recall"}))
    else:
        line = {"recommended": rec["mode"], "knob": rec["knob"],
                "recall": rec["recall"],
                "scan_MB_per_query":
                    round(rec["scan_bytes_per_query"] / 1e6, 2),
                "serve_flags": rec["flags"]}
        if "queries_per_s" in rec:
            line["measured_queries_per_s"] = rec["queries_per_s"]
        print(json.dumps(line))
    return result


if __name__ == "__main__":
    main()
