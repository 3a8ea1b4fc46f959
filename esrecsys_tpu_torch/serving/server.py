"""Online retrieval serving (counterpart of ``esrecsys_tpu/serving/server.py``).

  * ``RetrievalService`` keeps an :class:`EmbeddingIndex` on the device and
    answers top-k queries, exact (``mips.topk_over_matrix``) or through the
    fused scan+select kernel (``fused=True``, ``retrieval/fused.py``), with
    named eligibility filters, exclusion lists and item-to-item queries.
  * ``QueryBatcher`` coalesces concurrent single queries into one call.
  * ``serve`` returns a stdlib ``ThreadingHTTPServer`` exposing:
      GET  /healthz            -> {"status": "ok", "items": N, ...}
      GET  /statsz             -> {"mode", "queries", "device_calls",
                                   "queries_per_dispatch", "latency_ms", ...}
      POST /v1/topk            -> body {"vector": [...] | "id": "..." |
                                   "vectors": [[...], ...], "k": 10,
                                   "exclude": [...], "filter": name}
                               -> {"ids": [...], "scores": [...]}
      POST /admin/set_filter   -> body {"name": ..., "ids": [...]}

Not ported yet (construction raises ``NotImplementedError``; the HTTP
routes answer 501): the approx, quantized/int8, IVF, PQ and catalog-sharded
modes, ``add_capacity`` with ``/admin/add_items``, ``/admin/reload``, and
query encoders.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple, resolve_device
from esrecsys_tpu_torch.retrieval.fused import (binned_topk_over_matrix,
                                                pack_catalog, pad_mask,
                                                validate_fused_bins)
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.retrieval.mips import topk_over_matrix

log = logging.getLogger(__name__)

# the reference's serving options that have no port yet
UNPORTED_OPTIONS = ("approx", "quantized", "rescore_int8", "ivf_clusters",
                    "ivf_index_path", "pq_subspaces", "pq_index_path",
                    "n_model_shards", "add_capacity", "encoders")


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        if name not in UNPORTED_OPTIONS:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value:
            raise NotImplementedError(
                f"serving option {name!r} is not ported yet; the port "
                "serves the exact and fused modes")


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
    """

    def __init__(self, index: EmbeddingIndex, max_k: int = 100,
                 max_batch: int = 8, block_size: int = 262_144,
                 fused: bool = False, fused_bins: int = 4096,
                 filters: Optional[Dict[str, Sequence[str]]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **unported):
        _reject_unported(unported)
        self.device = resolve_device(device)
        self.index = index
        self.max_k = min(max_k, len(index))
        self.max_batch = max_batch
        self.block_size = block_size
        self.device_calls = 0  # query dispatches (coalescing stat)
        self.queries = 0       # query vectors answered
        self._dim = int(index.vectors.shape[1])
        self.capacity = len(index)
        self.fused = fused
        if fused:
            # at least ceil(max_k/2) bins so 2L >= k (fused.py recall math)
            self._fused_bins = max(
                pad_to_multiple(fused_bins, 128),
                pad_to_multiple(-(-min(max_k, len(index)) // 2), 128))
            validate_fused_bins(self._fused_bins, self._dim,
                                use_mask=filters is not None,
                                device=self.device)
        else:
            self._fused_bins = None
        self._items = torch.from_numpy(index.vectors).to(self.device)
        # the transposed bf16 scan copy, built once on the device
        self._items_packed = (pack_catalog(self._items, self._fused_bins)
                              if fused else None)
        self._ids = np.asarray(index.ids, dtype=object)
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

    def _query(self, q: torch.Tensor, fmask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fused:
            return binned_topk_over_matrix(
                q, self._items, self.max_k, num_bins=self._fused_bins,
                item_mask=fmask, items_packed=self._items_packed)
        return topk_over_matrix(q, self._items, self.max_k, self.block_size,
                                item_mask=fmask)

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
        """Device bytes held per catalog item: the float32 rows, plus the
        bf16 scan copy in fused mode."""
        return 4 * self._dim + (2 * self._dim if self.fused else 0)

    @property
    def mode(self) -> str:
        """Human-readable name of the active catalog-scan mode."""
        return f"fused:bins={self._fused_bins}" if self.fused else "exact"

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
        fetch = k if not exclude else self.exclusion_budget(k, exclude)
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
        """Raw-query encoders are not ported yet."""
        raise ValueError(f"no {kind!r} encoder registered: query encoders "
                         "are not ported yet")


class QueryBatcher:
    """Coalesce concurrent single-vector queries into one service call.

    Requests park on a queue; a dispatcher thread drains up to
    ``service.max_batch`` of them (waiting at most ``max_wait_ms`` for
    followers after the first), issues ONE call, then hands each request
    its top-k slice.
    """

    class Closed(RuntimeError):
        """Raised by submit() once close() has begun."""

    def __init__(self, service: RetrievalService, max_wait_ms: float = 2.0):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
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
            self._q.put((vec, done, slot))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["ids"], slot["scores"]

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
    """Reads the server's (service, batcher) pair once per request."""

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
                "reloads": 0,
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
        if self.path in ("/admin/reload", "/admin/add_items"):
            self._send(501, {"error": f"{self.path} is not ported yet"})
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
                ids, scores = batcher.submit(vec, k, exclude=exclude)
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
    """ThreadingHTTPServer holding one (service, batcher) pair; closing
    the server stops the batcher's thread."""

    index_path: Optional[str] = None
    admin_token: Optional[str] = None  # set -> /admin/* requires header
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

    def server_close(self) -> None:
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def serve(index: Union[str, EmbeddingIndex], host: str = "127.0.0.1",
          port: int = 8000, max_k: int = 100, max_batch: int = 8,
          coalesce: bool = True, max_wait_ms: float = 2.0,
          fused: bool = False, fused_bins: int = 4096,
          filters: Optional[Dict[str, Sequence[str]]] = None,
          admin_token: Optional[str] = None,
          device: Optional[Union[str, torch.device]] = None,
          **unported) -> RetrievalHTTPServer:
    """Build the service and return a ready (not yet running) HTTP server.

    ``index`` is an index file path (``.npz``/``.json``) or an
    :class:`EmbeddingIndex` already in memory. Call ``.serve_forever()``
    to block, or run it in a thread; ``port=0`` picks a free port
    (``server_address[1]``). ``coalesce`` batches concurrent single
    queries (:class:`QueryBatcher`)."""
    _reject_unported(unported)
    index_path = index if isinstance(index, str) else None
    if index_path is not None:
        index = EmbeddingIndex.load(index_path)
    service = RetrievalService(index, max_k=max_k, max_batch=max_batch,
                               fused=fused, fused_bins=fused_bins,
                               filters=filters, device=device)
    batcher = QueryBatcher(service, max_wait_ms=max_wait_ms) if coalesce else None
    httpd = RetrievalHTTPServer((host, port), _Handler)
    httpd.index_path = index_path
    httpd.started = time.time()
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
    p.add_argument("--fused", action="store_true",
                   help="fused scan+select kernel (retrieval/fused.py): "
                        "candidate selection happens during the catalog "
                        "scan; +2*D bytes/item for the bf16 scan copy")
    p.add_argument("--fused_bins", type=int, default=4096,
                   help="fused-mode bin count L (recall rises ~L^2)")
    p.add_argument("--filters_json", default="",
                   help='JSON {"name": ["catalog id", ...]} or a file of it; '
                        "'{}' enables filters with none registered yet")
    p.add_argument("--admin_token", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    filters = None
    if args.filters_json:
        text = args.filters_json
        if not text.strip().startswith("{"):
            with open(text) as f:
                text = f.read()
        filters = json.loads(text)
    serve(args.index, args.host, args.port, args.max_k, args.max_batch,
          coalesce=not args.no_coalesce, fused=args.fused,
          fused_bins=args.fused_bins, filters=filters,
          admin_token=args.admin_token or None,
          device=args.device).serve_forever()


if __name__ == "__main__":
    main()
