"""IVF (inverted-file) retrieval (counterpart of
``esrecsys_tpu/retrieval/ivf.py``): k-means cells over the catalog, and a
query scored only against the ``nprobe`` cells whose centroids it matches
best.

  * ``kmeans_assign`` is a blocked float32 L2 argmin over 65,536-row
    blocks; the Lloyd iterations sum each cell's rows through
    :func:`esrecsys_tpu_torch.ops.scatter.scatter_add_rows` (the
    ``scatter_add`` kernel on the card). Empty cells keep their centroid.
  * The cell layout is the reference's dense padded (C, Lmax) id table (pad
    -1), assembled on the host, with the same balanced median splits of
    cells over ``max_cell``. :class:`IVFIndex` has the reference's fields
    and npz format, so an index built by either package serves in the
    other (``IVFIndex(*jax_index)`` carries one across in memory).
  * ``ivf_topk`` gathers the probed cells' float32 rows through
    :func:`esrecsys_tpu_torch.ops.lookup.gather_rows` (the ``gather_pool``
    kernel at K=1 on the card) and scores them in float32 (a ``bmm`` with
    TF32 off); the int8 probe gathers int8 rows by plain indexing (the
    kernel takes float32 tables only). ``ivf_pq_topk`` scores the probed
    candidates from their PQ codes (:mod:`esrecsys_tpu_torch.retrieval.pq`)
    and rescores the best ``oversample * k`` exactly.

Both searches cut the query batch into chunks whose gathered rows stay
under :data:`GATHER_BYTES`; a query's answer does not depend on its chunk
(its scores up to the float32 rounding of a batched product).
Ties go to the lower candidate position (probe order, then cell order), as
``lax.top_k`` keeps them.

The reference draws its k-means rows from a JAX key, which torch cannot
replay: :func:`kmeans` draws them from a ``torch.Generator`` seeded with
``seed``, and :func:`lloyd` runs the iterations from given centroids, so
that the JAX package's own init rows can be fed to it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import resolve_device
from esrecsys_tpu_torch.ops.lookup import gather_rows
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, pad_topk,
                                               quantize_rows,
                                               require_full_f32,
                                               top_ids_lower_index_first,
                                               topk_lower_index_first)

# the bytes of float32 candidate rows one chunk of queries may gather: the
# 2,262,292-item catalog's padded cells (Lmax about 4,000) at nprobe 64 and
# D=64 take about 65 MB a query, so a chunk holds 16 queries
GATHER_BYTES = 1 << 30

Device = Optional[Union[str, torch.device]]


def on_device(vectors, device: Device = None) -> torch.Tensor:
    """``vectors`` as a float32 tensor: a tensor stays on its device, a
    host array is uploaded to ``device`` (``cuda`` unless asked)."""
    if isinstance(vectors, torch.Tensor):
        return vectors.float()
    return torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(
        resolve_device(device))


def kmeans_assign(items: torch.Tensor, centroids: torch.Tensor,
                  block_size: int = 65_536) -> torch.Tensor:
    """Nearest centroid of each row: (M, D) x (C, D) -> (M,) int64, the L2
    argmin without the row's own ``|x|^2``, over blocks of ``block_size``
    rows (the (block, C) distance tile is the working set). Ties go to the
    lower centroid."""
    require_full_f32(items)
    items = items.float()
    centroids = centroids.to(items.device, torch.float32)
    cn = (centroids * centroids).sum(-1)
    out = torch.empty(items.shape[0], dtype=torch.int64, device=items.device)
    for start in range(0, items.shape[0], block_size):
        s = items[start:start + block_size] @ centroids.T
        out[start:start + block_size] = torch.argmin(cn - 2.0 * s, dim=-1)
    return out


def lloyd(train: torch.Tensor, cent: torch.Tensor, iters: int,
          block_size: int = 65_536) -> torch.Tensor:
    """``iters`` Lloyd iterations from the centroids ``cent`` (C, D): each
    cell's rows summed by ``scatter_add_rows``, divided by its count; an
    empty cell keeps its centroid. Returns the (C, D) float32 centroids."""
    train = train.float()
    cent = cent.to(train.device, torch.float32).clone()
    n_clusters = cent.shape[0]
    for _ in range(iters):
        a = kmeans_assign(train, cent, block_size)
        sums = torch.zeros_like(cent)
        scatter_add_rows(sums, a, train)
        counts = torch.bincount(a, minlength=n_clusters).float()
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1.0)[:, None], cent)
    return cent


def kmeans(items: torch.Tensor, n_clusters: int, iters: int = 20,
           seed: int = 0, block_size: int = 65_536,
           train_sample: Optional[int] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked L2 k-means on ``items``' device: (centroids (C, D) float32,
    assignments (M,) int64).

    The init rows (distinct, uniform) and, with ``train_sample=N < M``, the
    N training rows come from a CPU ``torch.Generator`` seeded with
    ``seed``; a sampled build trains on the N rows and then assigns the
    whole catalog once."""
    items = items.float()
    m = items.shape[0]
    if n_clusters > m:
        raise ValueError(f"n_clusters {n_clusters} > items {m}")
    gen = torch.Generator().manual_seed(seed)
    train = items
    if train_sample is not None and train_sample < m:
        if train_sample < n_clusters:
            raise ValueError(
                f"train_sample {train_sample} < n_clusters {n_clusters}")
        rows = torch.randperm(m, generator=gen)[:train_sample]
        train = items[rows.to(items.device)]
    init = torch.randperm(train.shape[0], generator=gen)[:n_clusters]
    cent = lloyd(train, train[init.to(items.device)], iters, block_size)
    return cent, kmeans_assign(items, cent, block_size)


def _split_to_cap(ids: np.ndarray, x: np.ndarray, cap: int,
                  power_iters: int = 8) -> list:
    """Recursively split a cell (global ``ids``, rows ``x`` float64) into
    balanced parts of at most ``cap`` rows: ``[(ids, centroid float32)]``.
    Each split is a median cut along the cell's top principal direction
    (host power iteration, deterministic); a cell without variance is cut
    in index order."""
    if ids.size <= cap:
        return [(ids, x.mean(axis=0).astype(np.float32))]
    xc = x - x.mean(axis=0)
    v = np.ones((x.shape[1],), np.float64)
    for _ in range(power_iters):
        v = xc.T @ (xc @ v)
        n = np.linalg.norm(v)
        if n < 1e-12:
            v = None
            break
        v /= n
    order = (np.arange(ids.size) if v is None
             else np.argsort(xc @ v, kind="stable"))
    half = ids.size // 2
    lo, hi = order[:half], order[half:]
    return (_split_to_cap(ids[lo], x[lo], cap, power_iters)
            + _split_to_cap(ids[hi], x[hi], cap, power_iters))


def _assemble_cells(cents: list, assign: np.ndarray, vectors,
                    max_cell: Optional[int]) -> "IVFIndex":
    """Host tail of build and reassign: assignments -> cell lists -> the
    balanced splits of cells over ``max_cell`` -> the padded id table. Only
    an oversized cell's rows leave the device."""
    n_clusters = len(cents)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cells = [order[starts[c]: starts[c] + counts[c]].astype(np.int64)
             for c in range(n_clusters)]
    if max_cell is not None:
        if max_cell < 1:
            raise ValueError(f"max_cell must be >= 1, got {max_cell}")
        for slot in [i for i, g in enumerate(cells) if g.size > max_cell]:
            g = cells[slot]
            if isinstance(vectors, torch.Tensor):
                x = vectors[torch.from_numpy(g).to(vectors.device)].cpu(
                    ).numpy().astype(np.float64)
            else:
                x = np.asarray(vectors[g], np.float64)
            parts = _split_to_cap(g, x, max_cell)
            (cells[slot], cents[slot]) = parts[0]
            for ids_p, cent_p in parts[1:]:
                cells.append(ids_p)
                cents.append(cent_p)
    counts = np.array([g.size for g in cells])
    lmax = max(int(counts.max()), 1)
    table = np.full((len(cells), lmax), -1, np.int32)
    for c, g in enumerate(cells):
        table[c, : g.size] = g
    return IVFIndex(np.stack(cents).astype(np.float32), table,
                    int(vectors.shape[0]))


class IVFIndex(NamedTuple):
    """A built IVF layout: centroids and the dense padded cell id table
    (host numpy, the reference's fields)."""

    centroids: np.ndarray   # (C, D) float32
    bucket_ids: np.ndarray  # (C, Lmax) int32, pad -1
    n_items: int

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def imbalance(self) -> float:
        """Lmax over the mean cell size: what a probe pays for the padded
        width against perfectly balanced cells."""
        return (self.bucket_ids.shape[1] * self.n_clusters
                / max(self.n_items, 1))

    @classmethod
    def build(cls, vectors, n_clusters: int, iters: int = 20,
              seed: int = 0, max_cell: Optional[int] = None,
              train_sample: Optional[int] = None,
              device: Device = None) -> "IVFIndex":
        """k-means on the device, the cell table assembled on the host.
        ``vectors`` is a tensor (used where it lies, never copied) or a
        host array (uploaded to ``device``). ``max_cell`` caps a cell's
        rows by balanced splits, ``train_sample`` trains the centroids on
        that many sampled rows (see :func:`kmeans`)."""
        dev = on_device(vectors, device)
        cent, assign = kmeans(dev, n_clusters, iters, seed,
                              train_sample=train_sample)
        return _assemble_cells(list(cent.cpu().numpy()),
                               assign.cpu().numpy(), dev, max_cell)

    def reassign(self, vectors, max_cell: Optional[int] = None,
                 device: Device = None) -> "IVFIndex":
        """The layout of a new catalog under these centroids: one assign
        pass and the host assembly, no k-means (a reload's
        ``aux="reuse"``). ``max_cell`` re-applies the cap, which may grow
        the cell count."""
        if vectors.shape[1] != self.centroids.shape[1]:
            raise ValueError(
                f"catalog dim {vectors.shape[1]} != ivf centroid dim "
                f"{self.centroids.shape[1]}")
        dev = on_device(vectors, device)
        a = kmeans_assign(dev, torch.from_numpy(self.centroids).to(dev.device))
        return _assemble_cells(list(self.centroids), a.cpu().numpy(), dev,
                               max_cell)

    def save(self, path: str) -> None:
        np.savez_compressed(path, centroids=self.centroids,
                            bucket_ids=self.bucket_ids,
                            n_items=np.int64(self.n_items))

    @classmethod
    def load(cls, path: str) -> "IVFIndex":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["centroids"], z["bucket_ids"], int(z["n_items"]))


def _probe_candidates(qf: torch.Tensor, centroids: torch.Tensor,
                      bucket_ids: torch.Tensor, nprobe: int):
    """The ``nprobe`` best cells of each query, their member ids flattened
    in probe order: (cand (B, P*L) with -1 pads, valid mask, safe ids)."""
    _, probes = topk_lower_index_first(qf @ centroids.T, nprobe)
    cand = bucket_ids[probes.reshape(-1)].reshape(qf.shape[0], -1).long()
    return cand, cand >= 0, cand.clamp(min=0)


def _dot_rows(qf: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 dots of ``qf`` (B, D) with ``rows`` (B, n, D)."""
    return torch.bmm(rows, qf[:, :, None])[..., 0]


def _gather(items: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``items[ids]``: float32 rows through the gather kernel, int8 rows
    by plain indexing."""
    if items.dtype != torch.float32:
        return items[ids]
    return gather_rows(items, ids.reshape(-1)).reshape(
        ids.shape + (items.shape[1],))


def _chunks(n_queries: int, width: int, dim: int):
    """Query slices whose (chunk, width, dim) float32 gather stays under
    :data:`GATHER_BYTES`."""
    step = max(1, GATHER_BYTES // max(1, width * dim * 4))
    return [slice(s, s + step) for s in range(0, n_queries, step)]


def _best(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    position (one key top-k; a stable sort of wide rows costs more)."""
    sel = top_ids_lower_index_first(scores, k)
    return torch.gather(scores, -1, sel), sel


def ivf_topk(
    queries: torch.Tensor,       # (B, D)
    centroids: torch.Tensor,     # (C, D)
    bucket_ids: torch.Tensor,    # (C, L) int32, pad -1
    items: torch.Tensor,         # (M, D) float32 catalog, or int8 rows
    k: int,
    nprobe: int,
    q_items: Optional[torch.Tensor] = None,       # (M, D) int8 probe scan
    item_scales: Optional[torch.Tensor] = None,   # (M,) float32
    rescore_scales: Optional[torch.Tensor] = None,  # (M,): items is int8
    item_mask: Optional[torch.Tensor] = None,     # (M,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the ``nprobe`` best cells of each query and return the exact
    top-k among their members: (values (B, k) float32, ids (B, k) int64),
    descending, -inf slots with id 0 when fewer than k are eligible.

    With ``q_items``/``item_scales`` the candidates are scored from their
    int8 rows (the query quantized, its scale dropped) and only the
    selected k rescored in float32 from ``items``; with
    ``rescore_scales``, ``items`` is the int8 catalog itself, dequantized
    in the rescore. ``nprobe == n_clusters`` scans every cell and returns
    the exact top-k."""
    require_full_f32(queries)
    c, l = bucket_ids.shape
    nprobe = min(nprobe, c)
    k_eff = min(k, nprobe * l)
    outs = [_ivf_chunk(queries[sl].float(), centroids, bucket_ids, items, k,
                       k_eff, nprobe, q_items, item_scales, rescore_scales,
                       item_mask)
            for sl in _chunks(queries.shape[0], nprobe * l, items.shape[1])]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _ivf_chunk(qf, centroids, bucket_ids, items, k, k_eff, nprobe, q_items,
               item_scales, rescore_scales, item_mask):
    cand, valid, safe = _probe_candidates(qf, centroids, bucket_ids, nprobe)
    if q_items is not None:
        qq, _ = quantize_rows(qf)  # a query's scale cannot change its order
        # int8 products summed in float32 are exact: |sum| <= D * 127^2
        s = _dot_rows(qq.float(), q_items[safe].float()) * item_scales[safe]
    else:
        s = _dot_rows(qf, _gather(items, safe))
    if item_mask is not None:
        valid = valid & item_mask[safe]
    s = torch.where(valid, s, NEG_INF)
    vals, sel = _best(s, k_eff)
    idxs = torch.gather(cand, -1, sel)
    if q_items is not None:
        # the selected k rescored in float32, then sorted again
        safe_k = idxs.clamp(min=0)
        rows = _gather(items, safe_k)
        if rescore_scales is not None:
            rows = rows.float() * rescore_scales[safe_k][..., None]
        rv = _dot_rows(qf, rows)
        vals, order = topk_lower_index_first(
            torch.where(torch.isfinite(vals), rv, NEG_INF), k_eff)
        idxs = torch.gather(idxs, -1, order)
    return pad_topk(vals, idxs, k)


def ivf_pq_topk(
    queries: torch.Tensor,        # (B, D)
    centroids: torch.Tensor,      # (C, D) probe centroids
    bucket_ids: torch.Tensor,     # (C, L) int32, pad -1
    items: torch.Tensor,          # (M, D) float32, or int8 rescore rows
    k: int,
    nprobe: int,
    pq_centroids: torch.Tensor,   # (S, Cc, Ds) float32
    pq_codes: torch.Tensor,       # (M, S) uint8
    oversample: int = 4,
    rotation: Optional[torch.Tensor] = None,
    item_scales: Optional[torch.Tensor] = None,   # (M,): items is int8
    item_mask: Optional[torch.Tensor] = None,     # (M,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ: the probe of :func:`ivf_topk`, the candidates scored from
    their S-byte PQ codes (S lookups into the query's ADC table, summed in
    subspace order), the best ``min(oversample * k, nprobe * L)`` rescored
    in float32 from ``items`` (dequantized with ``item_scales`` when it is
    the int8 catalog), and the top k of the rescore returned.
    ``rotation`` is the codebook's pre-rotation, when it has one."""
    require_full_f32(queries)
    c, l = bucket_ids.shape
    nprobe = min(nprobe, c)
    n_cand = min(max(oversample * k, k), nprobe * l)
    outs = [_ivf_pq_chunk(queries[sl].float(), centroids, bucket_ids, items,
                          k, nprobe, n_cand, pq_centroids, pq_codes,
                          rotation, item_scales, item_mask)
            for sl in _chunks(queries.shape[0], nprobe * l, items.shape[1])]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def _ivf_pq_chunk(qf, centroids, bucket_ids, items, k, nprobe, n_cand,
                  pq_centroids, pq_codes, rotation, item_scales, item_mask):
    from esrecsys_tpu_torch.retrieval.pq import adc_lut, adc_scores

    cand, valid, safe = _probe_candidates(qf, centroids, bucket_ids, nprobe)
    s = adc_scores(adc_lut(qf, pq_centroids, rotation), pq_codes[safe])
    if item_mask is not None:
        valid = valid & item_mask[safe]
    s = torch.where(valid, s, NEG_INF)
    adc_vals, sel = _best(s, n_cand)
    idxs = torch.gather(cand, -1, sel)
    safe_idx = idxs.clamp(min=0)
    rows = _gather(items, safe_idx)
    if item_scales is not None:
        rows = rows.float() * item_scales[safe_idx][..., None]
    rv = torch.where(torch.isfinite(adc_vals), _dot_rows(qf, rows), NEG_INF)
    vals, order = topk_lower_index_first(rv, min(k, n_cand))
    return pad_topk(vals, torch.gather(idxs, -1, order), k)
