"""Online retrieval serving (counterpart of ``esrecsys_tpu/serving/server.py``).

  * ``RetrievalService`` keeps an :class:`EmbeddingIndex` on the device and
    answers top-k queries, exact (``mips.topk_over_matrix``) or through the
    fused scan+select kernel (``fused=True``, ``retrieval/fused.py``), with
    named eligibility filters, exclusion lists and item-to-item queries.
    ``quantized=True`` scans an int8 copy of the catalog instead (the exact
    int8 scan ``mips.quantized_topk_over_matrix``, or with ``fused`` the
    int8 kernel) and rescores the candidates in float32; ``rescore_int8``
    rescores from the int8 rows too, so no float32 catalog is on the
    device at all. ``approx=True`` selects each block's candidates as the
    TPU's ``approx_max_k`` does (``mips.approx_topk_over_matrix``; with
    ``quantized``, over the int8 scores). ``ivf_clusters=N`` k-means the
    catalog into N cells and probes ``nprobe`` per query
    (``retrieval/ivf.py``; with ``quantized`` the candidates are scored in
    int8); ``pq_subspaces=S`` scans S-byte PQ codes with a float32 rescore
    (``retrieval/pq.py``; with ``ivf_clusters`` it is IVF-PQ,
    ``ivf.ivf_pq_topk``). ``ivf_index_path``/``pq_index_path`` load a
    prebuilt structure, or build and save one there. ``add_capacity=N``
    preallocates N more rows in every device buffer, which ``add_items``
    fills in place.
  * ``QueryBatcher`` coalesces concurrent single queries into one call.
  * ``encoders`` embed raw queries (``serving/encoders.py``): ``"text"``
    through a txt2url artifact, ``"image_key"`` through an STL tower.
  * ``serve`` returns a stdlib ``ThreadingHTTPServer`` exposing:
      GET  /healthz            -> {"status": "ok", "items": N, ...}
      GET  /statsz             -> {"mode", "queries", "device_calls",
                                   "queries_per_dispatch", "reloads",
                                   "latency_ms", ...}
      POST /v1/topk            -> body {"vector": [...] | "id": "..." |
                                   "text": "..." | "image_key": "..." |
                                   "vectors": [[...], ...], "k": 10,
                                   "exclude": [...], "filter": name}
                               -> {"ids": [...], "scores": [...]}
      POST /admin/set_filter   -> body {"name": ..., "ids": [...]}
      POST /admin/add_items    -> body {"ids": [...], "vectors": [[...]]}:
                                  catalog growth into --add_capacity rows
      POST /admin/reload       -> body {"index": "path.npz"} (optional:
                                  the serving path by default), "aux":
                                  "rebuild" | "reuse"; a new service is
                                  built while the old one answers, then
                                  swapped in (RetrievalHTTPServer)

Not ported yet (construction raises ``NotImplementedError`` naming the
option): the catalog-sharded modes (``n_model_shards``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple, resolve_device
from esrecsys_tpu_torch.retrieval.fused import (binned_topk_over_matrix,
                                                pack_catalog,
                                                pack_catalog_codes, pad_mask,
                                                validate_fused_bins)
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.retrieval.ivf import IVFIndex, ivf_pq_topk, ivf_topk
from esrecsys_tpu_torch.retrieval.mips import (approx_topk_over_matrix,
                                               quantize_rows,
                                               quantize_rows_np,
                                               quantized_topk_over_matrix,
                                               topk_over_matrix)
from esrecsys_tpu_torch.retrieval.pq import PQCodebook, pq_topk

log = logging.getLogger(__name__)

# the reference's serving options that have no port yet
UNPORTED_OPTIONS = ("n_model_shards",)


def _reject_unported(options: dict) -> None:
    for name in options:
        if name not in UNPORTED_OPTIONS:
            raise TypeError(f"unexpected keyword argument {name!r}")
    for name in UNPORTED_OPTIONS:
        if options.get(name):
            raise NotImplementedError(
                f"serving option {name!r} is not ported yet; the port "
                "serves the exact, approx, fused, int8 (quantized), ivf "
                "and pq modes on one card")


def _npz_path(path: Optional[str]) -> Optional[str]:
    """``np.savez`` appends .npz to a path without it; normalised up front
    so that a restart's existence check finds what was saved."""
    if path and not path.endswith(".npz"):
        return path + ".npz"
    return path


def _finite_row(ids_row, scores_row):
    """JSON-safe (ids, scores) lists: drop the -inf tail (a filter can
    leave fewer eligible items than k; -Infinity is not valid JSON)."""
    out_i, out_s = [], []
    for x, s in zip(ids_row, scores_row):
        s = float(s)
        if not np.isfinite(s):
            break  # scores are sorted descending; the -inf tail follows
        out_i.append(str(x))
        out_s.append(s)
    return out_i, out_s


class RetrievalService:
    """Device-resident brute-force MIPS over an embedding index.

    Queries run in chunks of ``max_batch`` and return the top ``max_k``,
    trimmed to the requested k. The constructor answers one warm-up batch,
    so the kernel build and first launch happen before the first request.

    With ``add_capacity=N`` every device buffer (the float32 rows, the int8
    rows and scales, the fused scan copy and its scales, the PQ codes, the
    filter masks) is allocated at ``len(index) + N`` rows, the tail zero,
    and every scan takes the live row count as its valid bound.
    :meth:`add_items` then writes new rows in place; no buffer is
    reallocated. The IVF modes grow through a reload instead.

    ``ivf_warm_from``/``pq_warm_from`` are the trained structures of an
    earlier catalog (a reload's ``aux="reuse"``): this catalog's are
    derived from them by one assign or encode pass, ahead of a prebuilt
    path and of a fresh build.
    """

    def __init__(self, index: EmbeddingIndex, max_k: int = 100,
                 max_batch: int = 8, block_size: int = 262_144,
                 approx: bool = False, recall_target: float = 0.95,
                 fused: bool = False, fused_bins: int = 4096,
                 quantized: bool = False, rescore_int8: bool = False,
                 ivf_clusters: Optional[int] = None, nprobe: int = 8,
                 ivf_iters: int = 20,
                 build_train_sample: Optional[int] = None,
                 ivf_max_cell: Optional[int] = None,
                 ivf_index_path: Optional[str] = None,
                 pq_subspaces: Optional[int] = None, pq_codes: int = 256,
                 pq_iters: int = 15, pq_oversample: int = 64,
                 pq_rotate: bool = False,
                 pq_anisotropic: Optional[float] = None,
                 pq_index_path: Optional[str] = None,
                 add_capacity: int = 0,
                 filters: Optional[Dict[str, Sequence[str]]] = None,
                 encoders: Optional[Dict[str, Callable]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 ivf_warm_from: Optional[IVFIndex] = None,
                 pq_warm_from: Optional[PQCodebook] = None,
                 **unported):
        if fused and quantized and unported.get("n_model_shards"):
            raise ValueError(
                "sharded fused serving scans bf16: drop quantized or "
                "n_model_shards (int8 scan copies are single-shard)")
        _reject_unported(unported)
        want_ivf = bool(ivf_clusters or ivf_index_path)
        want_pq = bool(pq_subspaces or pq_index_path)
        if want_ivf and approx:
            raise ValueError("ivf and approx are mutually exclusive"
                             " (ivf probe selection already approximates)")
        if fused and (approx or want_ivf or want_pq):
            raise ValueError(
                "fused is a complete scan+select path: it does not "
                "compose with approx/ivf/pq modes")
        if want_pq and (approx or quantized):
            raise ValueError("pq is an alternative catalog scan: it does "
                             "not compose with approx/quantized")
        # rescore_int8 keeps no float32 catalog on the device, so the scan
        # must not read one: the int8 and pq scans don't
        if rescore_int8 and not (quantized or want_pq):
            raise ValueError(
                "rescore_int8 drops the resident f32 catalog, so the scan "
                "must not need it: enable quantized or a pq mode")
        if add_capacity and want_ivf:
            raise ValueError(
                "add_capacity composes with the full-scan modes "
                "(exact/approx/int8/pq); ivf catalogs grow via "
                "/admin/reload")
        self.device = resolve_device(device)
        self.index = index
        # raw-query embedders, e.g. {"text": txt2url_text_encoder(...)}
        self.encoders = dict(encoders or {})
        self.max_k = min(max_k, len(index))
        self.max_batch = max_batch
        self.block_size = block_size
        self.device_calls = 0  # query dispatches (coalescing stat)
        self.queries = 0       # query vectors answered
        self._dim = int(index.vectors.shape[1])
        self.add_capacity = int(add_capacity)
        self._n_valid = len(index)
        self.capacity = self._n_valid + self.add_capacity
        if self.add_capacity:
            # a catalog that starts small and grows is capped at its
            # capacity, not its launch size; topk clamps to the live size
            self.max_k = min(max_k, self.capacity)
            index.reserve(self.capacity)
        self.approx = approx
        self.recall_target = recall_target
        self.fused = fused
        self.quantized = quantized
        self.rescore_int8 = rescore_int8
        self.nprobe = nprobe
        self.pq_oversample = pq_oversample
        if fused:
            # at least ceil(max_k/2) bins so 2L >= k (fused.py recall math)
            self._fused_bins = max(
                pad_to_multiple(fused_bins, 128),
                pad_to_multiple(-(-min(max_k, len(index)) // 2), 128))
            validate_fused_bins(self._fused_bins, self._dim,
                                use_mask=filters is not None,
                                use_scales=quantized, device=self.device)
        else:
            self._fused_bins = None
        # one build-or-load decision per structure, shared by the upload
        # gate and the builds below
        ivf_index_path = _npz_path(ivf_index_path)
        pq_index_path = _npz_path(pq_index_path)
        ivf_prebuilt = bool(ivf_index_path and os.path.exists(ivf_index_path))
        pq_prebuilt = bool(pq_index_path and os.path.exists(pq_index_path))
        # (capacity, D) float32 rows, resident unless rescore_int8 drops
        # them; under rescore_int8 a build or a warm start uploads the real
        # rows for itself and drops them after, and with every structure
        # prebuilt no float32 catalog reaches the device at all
        self._items = (None if rescore_int8 else
                       self._at_capacity(torch.from_numpy(index.vectors)))
        build_rows = None
        if self._items is not None:
            build_rows = self._items[:self._n_valid]
        elif (ivf_warm_from is not None or pq_warm_from is not None
              or (want_ivf and not ivf_prebuilt)
              or (want_pq and not pq_prebuilt)):
            build_rows = torch.from_numpy(index.vectors).to(self.device)
        # int8 rows and scales: quantized on the device from the resident
        # float32 rows, or on the host (the bit-identical numpy twin) under
        # rescore_int8, so that no float32 catalog need reach the device;
        # the capacity tail holds code 0 and scale 0
        self._q_items = self._scales = None
        if (quantized or rescore_int8) and self._items is not None:
            q8, sc = quantize_rows(self._items[:self._n_valid])
            self._q_items, self._scales = (self._at_capacity(q8),
                                           self._at_capacity(sc))
        elif quantized or rescore_int8:
            q8, sc = quantize_rows_np(index.vectors)
            self._q_items = self._at_capacity(torch.from_numpy(q8))
            self._scales = self._at_capacity(torch.from_numpy(sc))
        self.ivf = self._centroids = self._bucket_ids = None
        if want_ivf or ivf_warm_from is not None:
            self._setup_ivf(build_rows, ivf_clusters, ivf_iters, ivf_max_cell,
                            build_train_sample, ivf_index_path, ivf_prebuilt,
                            ivf_warm_from)
        self.pq = self._pq_centroids = self._pq_codes = self._pq_rot = None
        self._pq_codes_host = None
        if want_pq or pq_warm_from is not None:
            self._setup_pq(build_rows, pq_subspaces, pq_codes, pq_iters,
                           pq_rotate, pq_anisotropic, build_train_sample,
                           pq_index_path, pq_prebuilt, pq_warm_from)
        del build_rows
        # the scan copy, built once on the device at capacity: transposed
        # bf16, or the transposed int8 codes with a flat scale per item
        self._items_packed = self._fused_scales = None
        if fused and quantized:
            self._items_packed, self._fused_scales = pack_catalog_codes(
                self._q_items, self._scales, self._fused_bins)
        elif fused:
            self._items_packed = pack_catalog(self._items, self._fused_bins)
        self._ids = np.empty(self.capacity, dtype=object)
        self._ids[:self._n_valid] = index.ids
        self._filters_enabled = filters is not None
        self._filter_masks: Dict[str, torch.Tensor] = {}
        for name, id_list in (filters or {}).items():
            mask, matched = self._mask_from_ids(id_list)
            self._filter_masks[str(name)] = mask
            log.info("filter %r: %d/%d ids matched the catalog", name,
                     matched, len(id_list))
        self._lock = threading.Lock()
        # per-dispatch latency ring (seconds); /statsz reports percentiles
        self._lat: "collections.deque[float]" = collections.deque(maxlen=2048)
        warm = torch.zeros((max_batch, self._dim), device=self.device)
        self._query(warm)[0].cpu()

    def _setup_ivf(self, rows, ivf_clusters, ivf_iters, ivf_max_cell,
                   train_sample, path, prebuilt, warm_from) -> None:
        """The inverted file: reassigned from ``warm_from``, loaded from a
        prebuilt ``path``, or built from ``rows`` (saved to ``path`` when
        one is given); then its centroids and cell table on the device."""
        n = len(self.index)
        if warm_from is not None:
            self.ivf = warm_from.reassign(rows, max_cell=ivf_max_cell)
            if path:
                self.ivf.save(path)
        elif prebuilt:
            self.ivf = IVFIndex.load(path)
            if (self.ivf.n_items != n
                    or self.ivf.centroids.shape[1] != self._dim):
                raise ValueError(
                    f"ivf index at {path} was built for "
                    f"{self.ivf.n_items} items dim "
                    f"{self.ivf.centroids.shape[1]}, catalog is {n} items "
                    f"dim {self._dim}")
            if ivf_max_cell and self.ivf.bucket_ids.shape[1] > ivf_max_cell:
                log.warning(
                    "ivf_max_cell=%d ignored: prebuilt index at %s has "
                    "Lmax=%d (built without the cap). Delete the file to "
                    "rebuild with cells capped.", ivf_max_cell, path,
                    self.ivf.bucket_ids.shape[1])
        else:
            if not ivf_clusters:
                raise ValueError(
                    f"ivf_index_path {path!r} does not exist and no "
                    "ivf_clusters given to build one")
            self.ivf = IVFIndex.build(rows, ivf_clusters, iters=ivf_iters,
                                      max_cell=ivf_max_cell,
                                      train_sample=train_sample)
            if path:
                self.ivf.save(path)
        self._centroids = torch.from_numpy(self.ivf.centroids).to(self.device)
        self._bucket_ids = torch.from_numpy(self.ivf.bucket_ids).to(
            self.device)

    def _setup_pq(self, rows, pq_subspaces, pq_codes, pq_iters, pq_rotate,
                  pq_anisotropic, train_sample, path, prebuilt,
                  warm_from) -> None:
        """The PQ codebook: encoded against ``warm_from``, loaded from a
        prebuilt ``path``, or trained on ``rows`` (saved to ``path`` when
        one is given); then its centroids, rotation and codes (at
        capacity, with a host mirror for ``add_items``) on the device."""
        n = len(self.index)
        if warm_from is not None:
            self.pq = warm_from.encode(rows)
            if path:
                self.pq.save(path)
        elif prebuilt:
            self.pq = PQCodebook.load(path)
            pq_dim = self.pq.centroids.shape[0] * self.pq.centroids.shape[2]
            if self.pq.n_items != n or pq_dim != self._dim:
                raise ValueError(
                    f"pq codebook at {path} was built for {self.pq.n_items} "
                    f"items dim {pq_dim}, catalog is {n} items dim "
                    f"{self._dim}")
            # only an explicit build request (pq_subspaces) warns: pq_codes
            # alone is a build modifier whose default is no request
            if pq_subspaces and (self.pq.n_subspaces != pq_subspaces
                                 or self.pq.n_codes != pq_codes):
                log.warning(
                    "prebuilt pq codebook at %s has S=%d C=%d; requested "
                    "S=%d C=%d ignored. Delete the file to retrain.", path,
                    self.pq.n_subspaces, self.pq.n_codes, pq_subspaces,
                    pq_codes)
        else:
            if not pq_subspaces:
                raise ValueError(
                    f"pq_index_path {path!r} does not exist and no "
                    "pq_subspaces given to build one")
            self.pq = PQCodebook.build(
                rows, pq_subspaces, n_codes=pq_codes, iters=pq_iters,
                rotate=pq_rotate, anisotropic_threshold=pq_anisotropic,
                train_sample=train_sample)
            if path:
                self.pq.save(path)
        self._pq_centroids = torch.from_numpy(self.pq.centroids).to(
            self.device)
        self._pq_rot = (None if self.pq.rotation is None else
                        torch.from_numpy(self.pq.rotation).to(self.device))
        self._pq_codes = self._at_capacity(torch.from_numpy(self.pq.codes))
        if self.add_capacity:
            # the host codes at capacity: an add writes its rows in place
            # and republishes self.pq over a view
            buf = np.zeros((self.capacity, self.pq.n_subspaces), np.uint8)
            buf[:n] = self.pq.codes
            self._pq_codes_host = buf
            self.pq = self.pq._replace(codes=buf[:n])

    def _at_capacity(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` (n, ...) on the device in a buffer of ``capacity``
        rows, the tail zero (a copy even on the CPU, so that no buffer
        aliases the host index)."""
        out = torch.zeros((self.capacity,) + tuple(rows.shape[1:]),
                          dtype=rows.dtype, device=self.device)
        out[:rows.shape[0]].copy_(rows)
        return out

    def _query(self, q: torch.Tensor, fmask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        # under rescore_int8 the candidates are rescored from the int8
        # rows, dequantized; otherwise from the float32 rows
        r8 = self.rescore_int8
        rescore = self._q_items if r8 else self._items
        rescore_scales = self._scales if r8 else None
        valid = self._n_valid  # rows past it are growth capacity
        if self.fused:
            return binned_topk_over_matrix(
                q, rescore, self.max_k, num_bins=self._fused_bins,
                valid_count=valid, item_mask=fmask,
                items_packed=self._items_packed,
                item_scales=self._fused_scales,
                rescore_scales=rescore_scales)
        # the approx, int8 and pq scans take large blocks: few scan
        # iterations, few candidates to rescore
        big = max(self.block_size, 262_144)
        if self.pq is not None and self.ivf is not None:
            # probe, ADC from the codes, float32 rescore of the best
            # oversample * k
            return ivf_pq_topk(
                q, self._centroids, self._bucket_ids, rescore, self.max_k,
                nprobe=self.nprobe, pq_centroids=self._pq_centroids,
                pq_codes=self._pq_codes, oversample=self.pq_oversample,
                rotation=self._pq_rot, item_scales=rescore_scales,
                item_mask=fmask)
        if self.pq is not None:
            return pq_topk(
                q, self._pq_centroids, self._pq_codes, self.max_k,
                rescore_items=rescore, block_size=big,
                oversample=self.pq_oversample, rotation=self._pq_rot,
                rescore_scales=rescore_scales, valid_count=valid,
                item_mask=fmask)
        if self.ivf is not None:
            return ivf_topk(
                q, self._centroids, self._bucket_ids, rescore, self.max_k,
                nprobe=self.nprobe, q_items=self._q_items,
                item_scales=self._scales, rescore_scales=rescore_scales,
                item_mask=fmask)
        if self.quantized:
            return quantized_topk_over_matrix(
                q, self._q_items, self._scales, rescore, self.max_k,
                block_size=big,
                select="approx" if self.approx else "exact",
                recall_target=self.recall_target,
                rescore_scales=rescore_scales, valid_count=valid,
                item_mask=fmask)
        if self.approx:
            return approx_topk_over_matrix(
                q, self._items, self.max_k, block_size=big,
                recall_target=self.recall_target, valid_count=valid,
                item_mask=fmask)
        return topk_over_matrix(q, self._items, self.max_k, self.block_size,
                                valid_count=valid, item_mask=fmask)

    def _mask_from_ids(self, id_list: Sequence[str]):
        """(device bool mask over the catalog rows, n ids that matched).
        Off-catalog ids no-op; the match count lets callers alarm on it.
        In fused mode the mask is padded once here to the scan's width."""
        mask = np.zeros(self.capacity, bool)
        rows = [self.index._id2row.get(str(i)) for i in id_list]
        matched = [r for r in rows if r is not None]
        if matched:
            mask[np.asarray(matched, np.int64)] = True
        dmask = torch.from_numpy(mask).to(self.device)
        if self.fused:
            dmask = pad_mask(dmask, self._items_packed.shape[1])
        return dmask, len(matched)

    def set_filter(self, name: str, id_list: Sequence[str]) -> int:
        """Register or replace a named eligibility filter at runtime
        (POST /admin/set_filter). Returns how many ids matched."""
        if not self._filters_enabled:
            raise ValueError(
                "filters are not enabled: start the service with "
                "filters={...} (or --filters_json) to enable the mask path")
        mask, matched = self._mask_from_ids(id_list)
        with self._lock:
            self._filter_masks[str(name)] = mask
        return matched

    def add_items(self, ids: Sequence[str], vectors: np.ndarray) -> int:
        """Append items to the live catalog (``/admin/add_items``); needs
        ``add_capacity`` headroom. The rows are written in place into the
        preallocated device buffers (``copy_`` on a slice, on the current
        stream, under the query lock, so they are ordered before the next
        query): the float32 rows, the int8 rows and scales from the host
        quantizer (bit-identical to the device one), the fused scan
        copy's columns (and its int8 codes and scales) at the same
        offsets, and the rows' PQ codes, encoded against the live codebook
        (``PQCodebook.encode``), on the device and in the host mirror.
        Everything is validated before any state moves, and the
        host index is extended last. Returns the new catalog size. New
        rows are outside every registered filter until it is set again."""
        if not self.add_capacity:
            raise ValueError(
                "service has no growth headroom: start it with "
                "add_capacity=N (--add_capacity) to enable add_items")
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n = vectors.shape[0]
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"vectors {vectors.shape} != (n, {self._dim})")
        str_ids = [str(i) for i in ids]
        if len(str_ids) != n:
            raise ValueError(f"{len(str_ids)} ids vs {n} vectors")
        with self._lock:
            if self._n_valid + n > self.capacity:
                raise ValueError(
                    f"capacity exhausted: {self._n_valid}+{n} > "
                    f"{self.capacity}; reload with a larger add_capacity")
            dup = [i for i in str_ids if i in self.index._id2row]
            if dup or len(set(str_ids)) != len(str_ids):
                raise ValueError(f"duplicate ids: {dup or 'within batch'}")
            enc = (None if self.pq is None else
                   self.pq.encode(vectors, device=self.device))
            start, end = self._n_valid, self._n_valid + n
            rows = torch.from_numpy(vectors)
            if self._items is not None:
                self._items[start:end].copy_(rows)
            if self._q_items is not None:
                q8, sc = (torch.from_numpy(a) for a in quantize_rows_np(vectors))
                self._q_items[start:end].copy_(q8)
                self._scales[start:end].copy_(sc)
            if self._items_packed is not None:
                # the transposed scan copy holds an item as a column
                if self._fused_scales is not None:
                    self._items_packed[:, start:end].copy_(q8.T)
                    self._fused_scales[start:end].copy_(sc)
                else:
                    self._items_packed[:, start:end].copy_(rows.T)
            if self.pq is not None:
                self._pq_codes[start:end].copy_(torch.from_numpy(enc.codes))
                self._pq_codes_host[start:end] = enc.codes
                self.pq = self.pq._replace(
                    codes=self._pq_codes_host[:end], n_items=end)
            self._ids[start:end] = str_ids
            self.index.extend(str_ids, vectors)
            self._n_valid = end
            return end

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def latency_ms(self) -> Optional[Dict[str, float]]:
        """Per-dispatch latency percentiles over the last <=2048 dispatches
        (host to device and back; HTTP framing excluded). None until the
        first real query."""
        lat = list(self._lat)
        if not lat:
            return None
        p50, p90, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 90, 99])
        return {"p50": round(float(p50), 2), "p90": round(float(p90), 2),
                "p99": round(float(p99), 2), "n": len(lat)}

    @property
    def resident_bytes_per_item(self) -> int:
        """Device bytes held per catalog item: the float32 rows (unless
        rescore_int8 dropped them), the scan copy in fused mode (bf16, or
        int8 codes and a float32 scale), the int8 rows and scale (the
        quantized modes and rescore_int8), an IVF table slot and the PQ
        codes; centroids are not counted. This is the number rescore_int8
        shrinks: D=64 pq S=8 goes 264 -> 76."""
        b = 0
        if self._items is not None:
            b += 4 * self._dim
        if self._items_packed is not None:
            b += (self._dim + 4 if self._fused_scales is not None
                  else 2 * self._dim)
        if self._q_items is not None:
            b += self._dim + 4
        if self.ivf is not None:
            b += 4  # one int32 cell slot per item (before padding)
        if self.pq is not None:
            b += self.pq.bytes_per_item
        return b

    @property
    def mode(self) -> str:
        """Human-readable name of the active catalog-scan mode."""
        r8 = "+r8" if self.rescore_int8 else ""  # int8 rescore, f32-free
        q8 = "+int8" if self.quantized else ""
        if self.pq is not None:
            rot = "+rotated" if self.pq.rotation is not None else ""
            aniso = (f"+aniso={self.pq.anisotropic_threshold:g}"
                     if self.pq.anisotropic_threshold is not None else "")
            pq_part = (f"pq:S={self.pq.n_subspaces}{rot}{aniso}"
                       f":oversample={self.pq_oversample}{r8}")
            if self.ivf is not None:
                return (f"ivf:{self.ivf.n_clusters}:nprobe={self.nprobe}"
                        f"+{pq_part}")
            return pq_part
        if self.ivf is not None:
            return f"ivf:{self.ivf.n_clusters}:nprobe={self.nprobe}{q8}{r8}"
        if self.fused:
            return f"fused:bins={self._fused_bins}{q8}{r8}"
        if self.quantized:
            return ("int8+approx" if self.approx else "int8") + r8
        return "approx" if self.approx else "exact"

    def exclusion_budget(self, k: int, exclude) -> int:
        """Validate an exclusion list against the top-k width: exclusion
        is a host post-filter over an over-fetched top-(k+E), so k + E
        must fit in ``max_k``. Returns the over-fetch width."""
        budget = k + len(set(exclude))
        if budget > self.max_k:
            raise ValueError(
                f"k={k} + {len(set(exclude))} excluded ids exceeds "
                f"max_k={self.max_k}: raise --max_k or shrink the "
                "exclusion list")
        return budget

    @staticmethod
    def _filter_excluded(ids_row, scores_row, exclude: frozenset, k: int):
        """Drop excluded ids from one over-fetched result row, keep k."""
        keep = [j for j, x in enumerate(ids_row) if x not in exclude][:k]
        return ids_row[keep], scores_row[keep]

    def topk(self, vectors: np.ndarray, k: Optional[int] = None,
             exclude: Optional[Sequence[str]] = None,
             filter: Optional[str] = None,
             ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) query vectors -> (ids (B, k) of str, scores (B, k)).

        ``exclude``: catalog ids dropped from every row; ids off the
        catalog count against the ``k + len(exclude) <= max_k`` budget but
        otherwise no-op. ``filter``: name of a registered eligibility mask;
        rows whose score comes back -inf carry a sanitized id."""
        fmask = None
        if filter is not None:
            if not self._filters_enabled:
                raise ValueError("filters are not enabled on this service")
            try:
                fmask = self._filter_masks[filter]
            except KeyError:
                raise ValueError(
                    f"unknown filter {filter!r}; registered: "
                    f"{sorted(self._filter_masks)}") from None
        k = self.max_k if k is None else min(k, self.max_k)
        # a growable service's max_k may pass the live size: never return
        # more rows than real items exist now
        k = min(k, self._n_valid)
        fetch = k if not exclude else self.exclusion_budget(k, exclude)
        if fetch > self._n_valid:
            raise ValueError(
                f"k + len(exclude) = {fetch} exceeds the current catalog "
                f"size {self._n_valid}")
        excl = frozenset(exclude) if exclude else frozenset()
        q = np.atleast_2d(np.asarray(vectors, np.float32))
        if q.shape[1] != self._dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self._dim}")
        out_v, out_i = [], []
        for start in range(0, q.shape[0], self.max_batch):
            chunk = q[start:start + self.max_batch]
            with self._lock:
                self.device_calls += 1
                self.queries += chunk.shape[0]
                t0 = time.perf_counter()
                vals, idxs = self._query(
                    torch.from_numpy(chunk).to(self.device), fmask)
                vals, idxs = vals[:, :fetch].cpu(), idxs[:, :fetch].cpu()
                self._lat.append(time.perf_counter() - t0)
            out_v.append(vals.numpy())
            out_i.append(idxs.numpy())
        vals = np.concatenate(out_v, axis=0)
        ids = self._ids[np.concatenate(out_i, axis=0)]
        if excl:
            rows = [self._filter_excluded(ids[b], vals[b], excl, k)
                    for b in range(ids.shape[0])]
            ids = np.stack([r[0] for r in rows])
            vals = np.stack([r[1] for r in rows])
        return ids, vals

    def topk_by_id(self, item_id: str, k: Optional[int] = None,
                   exclude: Optional[Sequence[str]] = None,
                   filter: Optional[str] = None):
        """Item-to-item: query with a catalog item's own vector. Pass
        ``exclude=[item_id]`` to drop the item from its own results."""
        ids, vals = self.topk(self.index.vector(item_id)[None, :], k,
                              exclude=exclude, filter=filter)
        return ids[0], vals[0]

    def encode(self, kind: str, payload) -> np.ndarray:
        """Run a raw query through its registered encoder; a kind with no
        encoder raises ``ValueError`` (a 400 over HTTP)."""
        if kind not in self.encoders:
            raise ValueError(f"no {kind!r} encoder registered (have "
                             f"{sorted(self.encoders)})")
        return np.asarray(self.encoders[kind](payload), np.float32)


class QueryBatcher:
    """Coalesce concurrent single-vector queries into one service call.

    Requests park on a queue; a dispatcher thread drains up to
    ``service.max_batch`` of them (waiting at most ``max_wait_ms`` for
    followers after the first), issues ONE call, then hands each request
    its top-k slice.
    """

    class Closed(RuntimeError):
        """Raised by submit() once close() has begun: a caller holding a
        batcher that a reload retired retries on the current one."""

    def __init__(self, service: RetrievalService, max_wait_ms: float = 2.0):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._inflight = 0
        self._state_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, vector: np.ndarray, k: int,
               exclude: Optional[Sequence[str]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking: one (D,) query -> (ids (k,), scores (k,))."""
        vec = np.asarray(vector, np.float32)
        if vec.shape != (self.service.dim,):
            # validate before enqueueing: a malformed query fails alone
            raise ValueError(
                f"query shape {vec.shape} != ({self.service.dim},)")
        excl = frozenset(exclude) if exclude else frozenset()
        fetch = self.service.exclusion_budget(k, excl) if excl else k
        done = threading.Event()
        slot: dict = {"k": k, "exclude": excl, "fetch": fetch}
        with self._state_lock:
            if self._closed:
                raise QueryBatcher.Closed("batcher closed")
            self._inflight += 1
            self._q.put((vec, done, slot))
        try:
            done.wait()
        finally:
            with self._state_lock:
                self._inflight -= 1
        if "err" in slot:
            raise slot["err"]
        return slot["ids"], slot["scores"]

    def idle(self) -> bool:
        """True when no submit() is waiting and the queue is empty."""
        with self._state_lock:
            return self._inflight == 0 and self._q.empty()

    def close(self) -> None:
        """Stop the dispatcher; waiters that slipped in get ``Closed``."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            _, done, slot = item
            slot["err"] = QueryBatcher.Closed("batcher closed")
            done.set()

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.service.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._finish(batch)
                    return
                batch.append(nxt)
            self._finish(batch)

    def _finish(self, batch) -> None:
        try:
            vecs = np.stack([b[0] for b in batch])
            kmax = max(b[2]["fetch"] for b in batch)
            ids, scores = self.service.topk(vecs, kmax)
            for i, (_, done, slot) in enumerate(batch):
                row_ids, row_scores = RetrievalService._filter_excluded(
                    ids[i], scores[i], slot["exclude"], slot["k"])
                slot["ids"] = row_ids
                slot["scores"] = row_scores
                done.set()
        except Exception as e:  # propagate to every waiter
            for _, done, slot in batch:
                slot["err"] = e
                done.set()


class _Handler(BaseHTTPRequestHandler):
    """Reads the server's (service, batcher) pair once per request, so a
    reload never hands a request the new service with the old batcher. A
    request that raced a reload into a just-closed batcher gets
    :class:`QueryBatcher.Closed` and retries once on the current pair."""

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length) or b"{}")

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("serving: " + fmt, *args)

    def do_GET(self):
        service, _ = self.server.serving
        if self.path == "/healthz":
            self._send(200, {"status": "ok", "items": len(service.index),
                             "dim": service.dim, "max_k": service.max_k,
                             "index": self.server.index_path})
        elif self.path == "/statsz":
            q, d = service.queries, service.device_calls
            self._send(200, {
                "mode": service.mode,
                "items": len(service.index),
                "capacity": service.capacity,
                "filters": (sorted(service._filter_masks)
                            if service._filters_enabled else None),
                "resident_bytes_per_item": service.resident_bytes_per_item,
                "index": self.server.index_path,
                "queries": q,
                "device_calls": d,
                "queries_per_dispatch": round(q / d, 2) if d else None,
                "reloads": self.server.reloads,
                "latency_ms": service.latency_ms,
                "device": str(service.device),
                "uptime_s": round(time.time() - self.server.started, 1)})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path.startswith("/admin/"):
            token = self.server.admin_token
            if token and self.headers.get("X-Admin-Token") != token:
                self._send(403, {"error": "bad or missing X-Admin-Token"})
                return
        if self.path == "/admin/reload":
            try:
                req = self._read_json()
                aux = req.get("aux", "rebuild")
                t0 = time.perf_counter()
                self.server.reload_index(req.get("index"), aux=aux)
                self._send(200, {
                    "status": "ok",
                    "items": len(self.server.service.index),
                    "index": self.server.index_path, "aux": aux,
                    "reload_seconds": round(time.perf_counter() - t0, 3)})
            except Exception as e:  # no path, missing file, bad aux, ...
                self._send(400, {"error": str(e)})
            return
        if self.path == "/admin/add_items":
            try:
                req = self._read_json()
                ids = req.get("ids") or []
                vecs = np.asarray(req.get("vectors") or [], np.float32)
                service = self.server.service
                total = service.add_items(ids, vecs)
                self._send(200, {"status": "ok", "added": len(ids),
                                 "items": total,
                                 "capacity_left": service.capacity - total})
            except Exception as e:  # no headroom, duplicate ids, bad dims
                self._send(400, {"error": str(e)})
            return
        if self.path == "/admin/set_filter":
            try:
                req = self._read_json()
                name = req.get("name")
                ids = req.get("ids")
                if not isinstance(name, str) or not isinstance(ids, list):
                    self._send(400, {"error": "need 'name' (str) and "
                                              "'ids' (list)"})
                    return
                matched = self.server.service.set_filter(name, ids)
                self._send(200, {"status": "ok", "filter": name,
                                 "matched": matched, "given": len(ids)})
            except Exception as e:
                self._send(400, {"error": str(e)})
            return
        if self.path != "/v1/topk":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        service, batcher = self.server.serving
        try:
            req = self._read_json()
            k = int(req.get("k", service.max_k))
            exclude = req.get("exclude", [])
            if not (isinstance(exclude, list)
                    and all(isinstance(x, str) for x in exclude)):
                self._send(400, {"error": "'exclude' must be a list of "
                                          "catalog id strings"})
                return
            # filtered requests bypass the coalescer: one call, one mask
            filt = req.get("filter")
            if filt is not None and not isinstance(filt, str):
                self._send(400, {"error": "'filter' must be a string"})
                return
            if "vectors" in req:
                vecs = np.asarray(req["vectors"], np.float32)
                if vecs.ndim != 2:
                    self._send(400, {"error": "'vectors' must be a list "
                                              "of equal-length vectors"})
                    return
                ids_b, scores_b = service.topk(vecs, k, exclude=exclude,
                                               filter=filt)
                rows = [_finite_row(i_r, s_r)
                        for i_r, s_r in zip(ids_b, scores_b)]
                self._send(200, {"ids": [r[0] for r in rows],
                                 "scores": [r[1] for r in rows]})
                return
            if "vector" in req:
                vec = np.asarray(req["vector"], np.float32)
            elif "id" in req:
                vec = service.index.vector(str(req["id"]))
            elif "text" in req:
                vec = service.encode("text", str(req["text"]))
            elif "image_key" in req:
                vec = service.encode("image_key", str(req["image_key"]))
            else:
                self._send(400, {"error":
                                 "need 'vector', 'id', 'text' or 'image_key'"})
                return
            if batcher is not None and filt is None:
                try:
                    ids, scores = batcher.submit(vec, k, exclude=exclude)
                except QueryBatcher.Closed:
                    # a reload retired the batcher between the pair's read
                    # and the submit: retry once on the current pair
                    service, batcher = self.server.serving
                    if batcher is not None:
                        ids, scores = batcher.submit(vec, k, exclude=exclude)
                    else:
                        ids2, scores2 = service.topk(vec[None, :], k,
                                                     exclude=exclude)
                        ids, scores = ids2[0], scores2[0]
            else:
                ids2, scores2 = service.topk(vec[None, :], k,
                                             exclude=exclude, filter=filt)
                ids, scores = ids2[0], scores2[0]
            out_ids, out_scores = _finite_row(ids, scores)
            self._send(200, {"ids": out_ids, "scores": out_scores})
        except KeyError as e:
            self._send(404, {"error": f"unknown id {e}"})
        except Exception as e:  # malformed JSON, wrong dim, ...
            self._send(400, {"error": str(e)})


class RetrievalHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer holding one (service, batcher) pair, with a
    reload that swaps in a new catalog while queries go on.

    ``reload_index(path)`` builds a complete new :class:`RetrievalService`
    (upload, quantize, scan copy, warm-up query) while the old one answers,
    then swaps the pair in one assignment. Reloads run one at a time. The
    replaced batcher closes once its in-flight requests drain. During a
    reload the old and the new catalog are both on the device. Closing the
    server stops the current batcher's thread."""

    index_path: Optional[str] = None
    admin_token: Optional[str] = None  # set -> /admin/* requires header
    reloads = 0
    _serving: Tuple[RetrievalService, Optional[QueryBatcher]]

    @property
    def serving(self) -> Tuple[RetrievalService, Optional[QueryBatcher]]:
        return self._serving

    @property
    def service(self) -> RetrievalService:
        return self._serving[0]

    @property
    def batcher(self) -> Optional[QueryBatcher]:
        return self._serving[1]

    def _configure(self, index_path: Optional[str], service_kwargs: dict,
                   coalesce: bool, max_wait_ms: float) -> None:
        self.index_path = index_path
        self._service_kwargs = dict(service_kwargs)
        self._coalesce = coalesce
        self._max_wait_ms = max_wait_ms
        self._reload_lock = threading.Lock()
        self.started = time.time()
        self.reloads = 0

    @staticmethod
    def _retire_batcher(batcher: QueryBatcher, grace_s: float = 60.0):
        """Close a replaced batcher once its in-flight requests drain (so
        none hangs on a queue nobody reads), at the latest after
        ``grace_s``."""
        def closer():
            deadline = time.monotonic() + grace_s
            while not batcher.idle() and time.monotonic() < deadline:
                time.sleep(0.05)
            batcher.close()
        threading.Thread(target=closer, daemon=True).start()

    def reload_index(self, index_path: Optional[str] = None,
                     aux: str = "rebuild") -> None:
        """Swap in the catalog at ``index_path`` (default: the serving
        path) with no downtime. ``aux`` says how IVF/PQ structures follow
        the catalog: ``"rebuild"`` trains them anew for the new vectors,
        ``"reuse"`` keeps the running service's centroids and codebooks
        and pays one assign or encode pass (``IVFIndex.reassign``,
        ``PQCodebook.encode``); a service without them builds the same
        either way. A configured ``ivf_index_path``/``pq_index_path`` is
        rewritten with the new structures, never loaded (it was built for
        the old catalog), and the build parameters a prebuilt file implied
        are carried from the running service. A server started from an
        :class:`EmbeddingIndex` object has no path to reload from, and a
        reload without one raises ValueError."""
        if aux not in ("rebuild", "reuse"):
            raise ValueError(f"aux must be 'rebuild' or 'reuse', got {aux!r}")
        with self._reload_lock:
            path = index_path or self.index_path
            if path is None:
                raise ValueError(
                    "this server was started from an EmbeddingIndex "
                    "object, not a path: pass 'index' to reload")
            index = EmbeddingIndex.load(path)
            kwargs = dict(self._service_kwargs)
            old, old_batcher = self._serving
            if aux == "reuse":
                if old.ivf is not None:
                    kwargs["ivf_warm_from"] = old.ivf
                if old.pq is not None:
                    kwargs["pq_warm_from"] = old.pq
            ivf_path = _npz_path(kwargs.pop("ivf_index_path", None))
            pq_path = _npz_path(kwargs.pop("pq_index_path", None))
            if ivf_path and not kwargs.get("ivf_clusters"):
                # derived once and kept: with ivf_max_cell the running
                # count is the post-split one, and deriving it at every
                # reload would ratchet C upward
                kwargs["ivf_clusters"] = old.ivf.n_clusters
                self._service_kwargs["ivf_clusters"] = old.ivf.n_clusters
            if pq_path and not kwargs.get("pq_subspaces"):
                carried = dict(pq_subspaces=old.pq.n_subspaces,
                               pq_codes=old.pq.n_codes,
                               pq_rotate=old.pq.rotation is not None,
                               pq_anisotropic=old.pq.anisotropic_threshold)
                kwargs.update(carried)
                self._service_kwargs.update(carried)
            service = RetrievalService(index, **kwargs)
            if ivf_path and service.ivf is not None:
                service.ivf.save(ivf_path)
            if pq_path and service.pq is not None:
                service.pq.save(pq_path)
            if (old.pq is not None and service.pq is not None
                    and (old.pq.n_subspaces, old.pq.n_codes)
                    != (service.pq.n_subspaces, service.pq.n_codes)):
                log.warning("reload changed pq S=%d C=%d -> S=%d C=%d",
                            old.pq.n_subspaces, old.pq.n_codes,
                            service.pq.n_subspaces, service.pq.n_codes)
            if (old.ivf is not None and service.ivf is not None
                    and old.ivf.n_clusters != service.ivf.n_clusters):
                log.warning("reload changed ivf C=%d -> C=%d",
                            old.ivf.n_clusters, service.ivf.n_clusters)
            batcher = (QueryBatcher(service, max_wait_ms=self._max_wait_ms)
                       if self._coalesce else None)
            self._serving = (service, batcher)  # one assignment
            self.index_path = path
            self.reloads += 1
            if old_batcher is not None:
                self._retire_batcher(old_batcher)
            log.info("reloaded %s: %d items (dim %d, %s)", path, len(index),
                     service.dim, service.mode)

    def server_close(self) -> None:
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def serve(index: Union[str, EmbeddingIndex], host: str = "127.0.0.1",
          port: int = 8000, max_k: int = 100, max_batch: int = 8,
          coalesce: bool = True, max_wait_ms: float = 2.0,
          approx: bool = False, recall_target: float = 0.95,
          fused: bool = False, fused_bins: int = 4096,
          quantized: bool = False, rescore_int8: bool = False,
          add_capacity: int = 0,
          filters: Optional[Dict[str, Sequence[str]]] = None,
          encoders: Optional[Dict[str, Callable]] = None,
          admin_token: Optional[str] = None,
          device: Optional[Union[str, torch.device]] = None,
          **options) -> RetrievalHTTPServer:
    """Build the service and return a ready (not yet running) HTTP server.

    ``index`` is an index file path (``.npz``/``.json``) or an
    :class:`EmbeddingIndex` already in memory (then ``/admin/reload``
    needs an explicit path). Call ``.serve_forever()`` to block, or run it
    in a thread; ``port=0`` picks a free port (``server_address[1]``).
    ``coalesce`` batches concurrent single queries (:class:`QueryBatcher`).
    ``approx`` selects candidates as ``approx_max_k`` does at
    ``recall_target``; ``quantized`` scans the catalog in int8 with a
    float32 rescore (composes with ``approx``); ``rescore_int8`` on top of
    it (or of a pq mode) keeps no float32 catalog on the device;
    ``add_capacity`` leaves room for ``/admin/add_items``; ``encoders``
    (``{"text": f, "image_key": g}``, ``serving/encoders.py``) enable raw
    queries, and a reload keeps them. ``options`` are
    :class:`RetrievalService`'s IVF and PQ keywords (``ivf_clusters``,
    ``nprobe``, ``pq_subspaces``, ``ivf_index_path``, ...)."""
    index_path = index if isinstance(index, str) else None
    if index_path is not None:
        index = EmbeddingIndex.load(index_path)
    service_kwargs = dict(max_k=max_k, max_batch=max_batch, approx=approx,
                          recall_target=recall_target, fused=fused,
                          fused_bins=fused_bins, quantized=quantized,
                          rescore_int8=rescore_int8,
                          add_capacity=add_capacity, filters=filters,
                          encoders=encoders, device=device, **options)
    service = RetrievalService(index, **service_kwargs)
    batcher = QueryBatcher(service, max_wait_ms=max_wait_ms) if coalesce else None
    httpd = RetrievalHTTPServer((host, port), _Handler)
    httpd._configure(index_path, service_kwargs, coalesce, max_wait_ms)
    httpd._serving = (service, batcher)
    httpd.admin_token = admin_token
    if host not in ("127.0.0.1", "localhost", "::1") and not admin_token:
        log.warning("serving on %s without --admin_token: /admin/* is open "
                    "to any client that can reach this port", host)
    log.info("serving %d items (dim %d, %s) on %s:%d", len(index),
             service.dim, service.mode, host, httpd.server_address[1])
    return httpd


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_k", type=int, default=100)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--no_coalesce", action="store_true")
    p.add_argument("--approx", action="store_true",
                   help="approx_max_k candidate selection per block (bins "
                        "j mod L, L from --recall_target) + float32 rescore; "
                        "composes with --quantized")
    p.add_argument("--recall_target", type=float, default=0.95)
    p.add_argument("--fused", action="store_true",
                   help="fused scan+select kernel (retrieval/fused.py): "
                        "candidate selection happens during the catalog "
                        "scan; +2*D bytes/item for the bf16 scan copy")
    p.add_argument("--fused_bins", type=int, default=4096,
                   help="fused-mode bin count L (recall rises ~L^2)")
    p.add_argument("--quantized", action="store_true",
                   help="int8 catalog scan + float32 rescore of the "
                        "candidates (exact int8 scan, or the int8 fused "
                        "kernel with --fused: D+4 bytes/item scanned)")
    p.add_argument("--rescore_int8", action="store_true",
                   help="drop the resident float32 catalog: the rescore "
                        "dequantizes int8 rows instead (requires "
                        "--quantized or a pq mode); residency falls to D+4 "
                        "bytes/item (int8), S+D+4 (pq), 2*(D+4) with "
                        "--fused, vs 4*D+; returned scores carry "
                        "<=0.4%%-of-row-max int8 rounding. With prebuilt "
                        "--ivf_index/--pq_index files no float32 catalog "
                        "reaches the device")
    p.add_argument("--ivf_clusters", type=int, default=0,
                   help="k-means the catalog into this many cells at "
                        "startup and probe --nprobe cells per query "
                        "(sublinear; composes with --quantized)")
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--ivf_iters", type=int, default=20,
                   help="k-means iterations of a fresh IVF build")
    p.add_argument("--build_train_sample", type=int, default=0,
                   help="train the startup IVF/PQ k-means on this many "
                        "sampled rows (one full assign or encode pass "
                        "still runs)")
    p.add_argument("--ivf_max_cell", type=int, default=0,
                   help="cap an IVF cell's rows by balanced median splits, "
                        "shrinking the padded probe width nprobe x Lmax "
                        "every query pays")
    p.add_argument("--ivf_index", default="",
                   help="a prebuilt inverted file (.npz): loaded if it "
                        "exists, else built from --ivf_clusters and saved "
                        "there")
    p.add_argument("--pq_subspaces", type=int, default=0,
                   help="scan PQ codes of this many bytes per item with a "
                        "float32 candidate rescore; exclusive with --approx "
                        "and --quantized; with --ivf_clusters it is IVF-PQ")
    p.add_argument("--pq_codes", type=int, default=256,
                   help="PQ codebook entries per subspace (<=256)")
    p.add_argument("--pq_iters", type=int, default=15,
                   help="PQ codebook k-means iterations")
    p.add_argument("--pq_oversample", type=int, default=64,
                   help="rescore about oversample*max_k candidates")
    p.add_argument("--pq_rotate", action="store_true",
                   help="train the codebook in a seeded random orthonormal "
                        "rotation of the space (queries rotated at search)")
    p.add_argument("--pq_anisotropic", type=float, default=0.0,
                   help="train the codebook under the score-aware loss "
                        "with this threshold T (T >= 1/sqrt(dim); 0: off)")
    p.add_argument("--pq_index", default="",
                   help="a prebuilt PQ codebook (.npz): loaded if it "
                        "exists, else trained from --pq_subspaces and "
                        "saved there")
    p.add_argument("--add_capacity", type=int, default=0,
                   help="preallocate this many extra catalog rows so POST "
                        "/admin/add_items can append items live, written in "
                        "place (full-scan modes: exact, approx, int8, pq)")
    p.add_argument("--filters_json", default="",
                   help='JSON {"name": ["catalog id", ...]} or a file of it; '
                        "'{}' enables filters with none registered yet")
    p.add_argument("--admin_token", default="")
    p.add_argument("--device", default="cuda")
    # query-side model inference (serving/encoders.py)
    p.add_argument("--txt2url_artifact", default="",
                   help="enable 'text' queries through this txt2url artifact")
    p.add_argument("--token_dictionary", default="",
                   help="the txt2url artifact's token dictionary")
    p.add_argument("--stl_artifact", default="",
                   help="enable 'image_key' queries through this STL "
                        "artifact's scene tower")
    p.add_argument("--image_dir", default="",
                   help="where 'image_key' images are (<key>.jpg)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    from esrecsys_tpu_torch.serving import encoders as encoders_lib

    enc = {}
    if args.txt2url_artifact:
        enc["text"] = encoders_lib.txt2url_text_encoder(
            args.txt2url_artifact, args.token_dictionary, device=args.device)
    if args.stl_artifact:
        enc["image_key"] = encoders_lib.stl_image_encoder(
            args.stl_artifact, args.image_dir, device=args.device)
    filters = None
    if args.filters_json:
        text = args.filters_json
        if not text.strip().startswith("{"):
            with open(text) as f:
                text = f.read()
        filters = json.loads(text)
    serve(args.index, args.host, args.port, args.max_k, args.max_batch,
          coalesce=not args.no_coalesce, approx=args.approx,
          recall_target=args.recall_target, fused=args.fused,
          fused_bins=args.fused_bins, quantized=args.quantized,
          rescore_int8=args.rescore_int8, add_capacity=args.add_capacity,
          filters=filters, encoders=enc,
          ivf_clusters=args.ivf_clusters or None,
          nprobe=args.nprobe, ivf_iters=args.ivf_iters,
          ivf_max_cell=args.ivf_max_cell or None,
          build_train_sample=args.build_train_sample or None,
          ivf_index_path=args.ivf_index or None,
          pq_subspaces=args.pq_subspaces or None, pq_codes=args.pq_codes,
          pq_iters=args.pq_iters, pq_oversample=args.pq_oversample,
          pq_rotate=args.pq_rotate,
          pq_anisotropic=args.pq_anisotropic or None,
          pq_index_path=args.pq_index or None,
          admin_token=args.admin_token or None,
          device=args.device).serve_forever()


if __name__ == "__main__":
    main()
