"""Retrieval quality of the approximate serving modes (counterpart of
``esrecsys_tpu/tools/retrieval_quality_study.py``): recall against the
exact scan, a function of the index math and the catalog's geometry.

  * IVF (``retrieval/ivf.py``): recall@10 and @100 against ``nprobe``,
    beside the share of the catalog a query scores (nprobe x Lmax / N);
  * int8 full scan (``mips.quantized_topk_over_matrix``): overlap@10 and
    @100 with the exact float32 scan;
  * PQ (``--pq_subspaces``): overlap against the rescore budget
    ``oversample`` and of the raw ADC ranking;
  * IVF-PQ (``--ivfpq``): recall against ``nprobe`` at the largest
    oversample, on the IVF and PQ structures built above.

The synthetic catalogs are the reference's (``clustered``: a heavy-tailed
Gaussian mixture; ``isotropic``: one Gaussian; ``correlated``: the mixture
with a decaying variance spectrum), drawn from ``np.random.default_rng(0)``;
``--artifact`` studies an ``EmbeddingIndex`` export instead, with queries
made from perturbed catalog rows. Prints one JSON line and writes it to
``--out``.

Run (card): python -m esrecsys_tpu_torch.tools.retrieval_quality_study \\
    [--n_items 2262292] [--artifact index.npz] [--pq_subspaces 8
    --ivfpq]
Smoke (CPU): --device cpu --n_items 4000 --n_queries 32 --n_clusters 32
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


def synth_catalog(kind: str, n: int, n_queries: int, d: int,
                  rng: np.random.Generator, components: int = 4096):
    """(catalog (n, d), queries (n_queries, d)) float32, queries drawn from
    the catalog's own distribution; the reference's draws, bit for bit."""
    if kind == "isotropic":
        return (rng.standard_normal((n, d), np.float32),
                rng.standard_normal((n_queries, d), np.float32))
    cent = rng.standard_normal((components, d)).astype(np.float32) * 2.0
    w = 1.0 / np.arange(1, components + 1) ** 0.7
    w /= w.sum()
    scales = (np.exp(-np.arange(d) / (d / 6.0)).astype(np.float32)
              if kind == "correlated" else np.ones(d, np.float32))

    def draw(m):
        comp = rng.choice(components, size=m, p=w)
        return (cent[comp]
                + rng.standard_normal((m, d)).astype(np.float32) * 0.45
                ) * scales

    return draw(n), draw(n_queries)


def recall(found: np.ndarray, truth: np.ndarray) -> float:
    """Mean share of each truth row found in the found row."""
    hits = [np.intersect1d(f, t).size for f, t in zip(found, truth)]
    return float(np.mean(hits) / truth.shape[1])


def _search(fn, queries: np.ndarray, device, batch: int) -> np.ndarray:
    """Ids of ``fn(query batch on device)`` over all queries, pad slots
    (-inf scores) as -1 so that item 0 cannot count as a hit."""
    found = []
    for s in range(0, queries.shape[0], batch):
        vals, idx = fn(torch.from_numpy(queries[s:s + batch]).to(device))
        found.append(torch.where(torch.isfinite(vals), idx, -1).cpu().numpy())
    return np.concatenate(found)


def _overlaps(found, truth10, truth100) -> dict:
    return {"overlap@10": round(recall(found[:, :10], truth10), 4),
            "overlap@100": round(recall(found, truth100), 4)}


def exact_topk(items: torch.Tensor, queries: np.ndarray, k: int,
               batch: int = 128) -> np.ndarray:
    from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix

    return _search(lambda q: topk_over_matrix(q, items, k), queries,
                   items.device, batch)


def ivf_curve(items, queries, truth10, truth100, n_clusters, iters, nprobes,
              batch: int = 32, max_cell=None) -> dict:
    from esrecsys_tpu_torch.retrieval.ivf import IVFIndex, ivf_topk

    t0 = time.perf_counter()
    index = IVFIndex.build(items, n_clusters, iters=iters, max_cell=max_cell)
    build_s = time.perf_counter() - t0
    cent = torch.from_numpy(index.centroids).to(items.device)
    buckets = torch.from_numpy(index.bucket_ids).to(items.device)
    n, lmax = items.shape[0], index.bucket_ids.shape[1]
    log.info("ivf built: C=%d Lmax=%d imbalance=%.2f (%.1fs)",
             index.n_clusters, lmax, index.imbalance, build_s)
    out = {"n_clusters": index.n_clusters, "lmax": lmax,
           "max_cell": max_cell, "imbalance": round(index.imbalance, 3),
           "build_seconds": round(build_s, 1), "curve": [],
           "_index": index}  # dropped before reporting; reused by ivfpq
    for p in nprobes:
        found = _search(lambda q: ivf_topk(q, cent, buckets, items, 100, p),
                        queries, items.device, batch)
        row = {"nprobe": p,
               "catalog_fraction_scored": round(
                   min(p, index.n_clusters) * lmax / n, 5),
               "recall@10": round(recall(found[:, :10], truth10), 4),
               "recall@100": round(recall(found, truth100), 4)}
        out["curve"].append(row)
        log.info("nprobe=%-3d frac=%.4f r@10=%.3f r@100=%.3f", p,
                 row["catalog_fraction_scored"], row["recall@10"],
                 row["recall@100"])
    return out


def int8_overlap(items, queries, truth10, truth100, batch: int = 128) -> dict:
    from esrecsys_tpu_torch.retrieval.mips import (quantize_rows,
                                                   quantized_topk_over_matrix)

    q_items, scales = quantize_rows(items)
    found = _search(lambda q: quantized_topk_over_matrix(
        q, q_items, scales, items, 100, select="exact"), queries,
        items.device, batch)
    return _overlaps(found, truth10, truth100)


def pq_quality(items, queries, truth10, truth100, n_subspaces: int,
               n_codes: int = 256, iters: int = 15, batch: int = 128,
               oversamples=(4, 16, 64, 256), rotate: bool = False,
               anisotropic=None) -> dict:
    """PQ ADC scan quality: overlap against the rescore budget
    (``oversample``, about oversample x 100 candidates rescored a query)
    and of the raw ADC ranking. The codebook is trained once."""
    from esrecsys_tpu_torch.retrieval.pq import PQCodebook, pq_topk

    t0 = time.perf_counter()
    book = PQCodebook.build(items, n_subspaces, n_codes=n_codes, iters=iters,
                            rotate=rotate, anisotropic_threshold=anisotropic)
    build_s = time.perf_counter() - t0
    log.info("pq built: S=%d C=%d (%d bytes/item) aniso=%s in %.1fs",
             n_subspaces, n_codes, book.bytes_per_item, anisotropic, build_s)
    dev = items.device
    cents = torch.from_numpy(book.centroids).to(dev)
    codes = torch.from_numpy(book.codes).to(dev)
    rot = (None if book.rotation is None
           else torch.from_numpy(book.rotation).to(dev))

    def scan(rescore, oversample):
        return _overlaps(_search(lambda q: pq_topk(
            q, cents, codes, 100, rescore_items=rescore,
            oversample=oversample, rotation=rot), queries, dev, batch),
            truth10, truth100)

    out = {"n_subspaces": n_subspaces, "n_codes": n_codes,
           "rotated": rotate, "anisotropic_threshold": anisotropic,
           "bytes_per_item": book.bytes_per_item,
           "compression_vs_f32": round(4 * items.shape[1] / n_subspaces, 1),
           "build_seconds": round(build_s, 1), "rescored_curve": [],
           "_book": book}  # dropped before reporting; reused by ivfpq
    # candidates rescored: nblk * ceil(oversample * k / nblk)
    nblk = -(-items.shape[0] // min(262_144, items.shape[0]))
    for o in oversamples:
        row = scan(items, o)
        row["oversample"] = o
        row["candidates_rescored"] = nblk * max(-(-o * 100 // nblk), 1)
        out["rescored_curve"].append(row)
        log.info("pq rescored o=%-4d (%d cand): o@10=%.3f o@100=%.3f", o,
                 row["candidates_rescored"], row["overlap@10"],
                 row["overlap@100"])
    out["raw_adc"] = scan(None, 4)
    log.info("pq raw_adc: o@10=%.3f o@100=%.3f",
             out["raw_adc"]["overlap@10"], out["raw_adc"]["overlap@100"])
    return out


def ivfpq_curve(items, queries, truth10, truth100, index, book, nprobes,
                oversample: int = 64, batch: int = 32) -> dict:
    """IVF-PQ recall against nprobe at one rescore budget, on the IVF and
    PQ structures the sections above built."""
    from esrecsys_tpu_torch.retrieval.ivf import ivf_pq_topk

    dev = items.device
    cent = torch.from_numpy(index.centroids).to(dev)
    buckets = torch.from_numpy(index.bucket_ids).to(dev)
    pq_cent = torch.from_numpy(book.centroids).to(dev)
    pq_codes = torch.from_numpy(book.codes).to(dev)
    rot = (None if book.rotation is None
           else torch.from_numpy(book.rotation).to(dev))
    n, lmax = items.shape[0], index.bucket_ids.shape[1]
    out = {"n_clusters": index.n_clusters, "lmax": lmax,
           "n_subspaces": book.n_subspaces, "oversample": oversample,
           "rotated": book.rotation is not None, "curve": []}
    for p in nprobes:
        found = _search(lambda q: ivf_pq_topk(
            q, cent, buckets, items, 100, p, pq_centroids=pq_cent,
            pq_codes=pq_codes, oversample=oversample, rotation=rot),
            queries, dev, batch)
        row = {"nprobe": p,
               "catalog_fraction_probed": round(
                   min(p, index.n_clusters) * lmax / n, 5),
               "recall@10": round(recall(found[:, :10], truth10), 4),
               "recall@100": round(recall(found, truth100), 4)}
        out["curve"].append(row)
        log.info("ivfpq nprobe=%-3d frac=%.4f r@10=%.3f r@100=%.3f", p,
                 row["catalog_fraction_probed"], row["recall@10"],
                 row["recall@100"])
    return out


def study(vecs: np.ndarray, queries: np.ndarray, n_clusters: int, iters: int,
          nprobes: list, max_cell=None, pq_subspaces=None,
          pq_oversamples=(4, 16, 64, 256), pq_rotate: bool = False,
          pq_anisotropic=None, pq_iters: int = 15, ivfpq: bool = False,
          device=None) -> dict:
    if ivfpq and not pq_subspaces:
        raise ValueError("--ivfpq needs --pq_subspaces")
    items = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(
        resolve_device(device))
    t0 = time.perf_counter()
    truth100 = exact_topk(items, queries, 100)
    truth10 = truth100[:, :10]
    log.info("exact ground truth (%.1fs)", time.perf_counter() - t0)
    out = {"n_items": int(vecs.shape[0]), "dim": int(vecs.shape[1]),
           "n_queries": int(queries.shape[0]),
           "int8_fullscan": int8_overlap(items, queries, truth10, truth100),
           "ivf": ivf_curve(items, queries, truth10, truth100, n_clusters,
                            iters, nprobes, max_cell=max_cell)}
    if pq_subspaces:
        out["pq"] = pq_quality(items, queries, truth10, truth100,
                               pq_subspaces, iters=pq_iters,
                               oversamples=pq_oversamples, rotate=pq_rotate,
                               anisotropic=pq_anisotropic)
    if ivfpq:
        out["ivfpq"] = ivfpq_curve(
            items, queries, truth10, truth100, out["ivf"]["_index"],
            out["pq"]["_book"], nprobes, oversample=max(pq_oversamples))
    out["ivf"].pop("_index", None)
    if pq_subspaces:
        out["pq"].pop("_book", None)
    return out


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_items", type=int, default=2_262_292)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--n_queries", type=int, default=512)
    p.add_argument("--n_clusters", type=int, default=1024)
    p.add_argument("--max_cell", type=int, default=0,
                   help="cap an IVF cell's rows (0: off)")
    p.add_argument("--pq_subspaces", type=int, default=0,
                   help="also measure PQ with this many bytes per item "
                        "(0: off)")
    p.add_argument("--pq_oversamples", default="4,16,64,256")
    p.add_argument("--pq_rotate", action="store_true")
    p.add_argument("--pq_anisotropic", type=float, default=0.0,
                   help="score-aware PQ training threshold T (0: off)")
    p.add_argument("--ivfpq", action="store_true",
                   help="also sweep IVF-PQ over --nprobes at the largest "
                        "--pq_oversamples budget")
    p.add_argument("--pq_iters", type=int, default=15)
    p.add_argument("--kmeans_iters", type=int, default=10)
    p.add_argument("--nprobes", default="1,2,4,8,16,32,64")
    p.add_argument("--regimes", default="clustered,isotropic")
    p.add_argument("--artifact", default="",
                   help="an EmbeddingIndex .npz: study a real catalog")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="runs/retrieval_quality.json")
    args = p.parse_args(argv)
    nprobes = [int(x) for x in args.nprobes.split(",")]
    pq_oversamples = [int(x) for x in args.pq_oversamples.split(",")]
    if args.ivfpq and not args.pq_subspaces:
        p.error("--ivfpq needs --pq_subspaces")
    device = resolve_device(args.device)
    kw = dict(max_cell=args.max_cell or None,
              pq_subspaces=args.pq_subspaces or None,
              pq_oversamples=pq_oversamples, pq_rotate=args.pq_rotate,
              pq_anisotropic=args.pq_anisotropic or None,
              pq_iters=args.pq_iters, ivfpq=args.ivfpq, device=device)
    rng = np.random.default_rng(0)
    results = {}
    if args.artifact:
        from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

        vecs = np.asarray(EmbeddingIndex.load(args.artifact).vectors,
                          np.float32)
        qi = rng.choice(vecs.shape[0], args.n_queries, replace=False)
        queries = vecs[qi] + 0.1 * rng.standard_normal(
            (args.n_queries, vecs.shape[1])).astype(np.float32)
        results["artifact"] = study(vecs, queries, args.n_clusters,
                                    args.kmeans_iters, nprobes, **kw)
    else:
        for kind in args.regimes.split(","):
            log.info("=== regime: %s (%d x %d) ===", kind, args.n_items,
                     args.dim)
            vecs, queries = synth_catalog(kind, args.n_items,
                                          args.n_queries, args.dim, rng)
            results[kind] = study(vecs, queries, args.n_clusters,
                                  args.kmeans_iters, nprobes, **kw)
    results["device"] = str(device)
    results["card"] = card_line(device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
