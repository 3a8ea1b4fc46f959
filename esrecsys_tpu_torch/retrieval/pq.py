"""Product quantization (counterpart of ``esrecsys_tpu/retrieval/pq.py``):
a catalog stored as S one-byte codes per item.

The dimension axis is split into S subspaces, each with its own k-means
codebook of up to 256 centroids (``retrieval/ivf.py`` ``kmeans``, whose
cell sums run through the ``scatter_add`` kernel on the card), and an
item is stored as its S nearest-centroid ids. A query scores an item by
ADC: S lookups into its (S, C) table of query-centroid dots, summed in
subspace order (:func:`adc_scores`, plain PyTorch: on the TPU it is an XLA
gather, not a Pallas kernel). ``pq_topk`` streams the codes in blocks,
keeps each block's best ``kb`` by ADC and rescores them in float32 from a
resident catalog (``mips._streamed_candidate_topk``), or, with no rescore
catalog, returns the raw ADC top-k.

Two training levers cost nothing at search time: ``rotate`` (a seeded
random orthonormal pre-rotation, numpy's ``default_rng(seed)`` QR, the
reference's exactly) and ``anisotropic_threshold`` (the score-aware loss
of :func:`anisotropic_eta`, refined by coordinate descent:
:func:`_refine_anisotropic`). :class:`PQCodebook` has the reference's
fields and npz format.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.core.device import pad_to_multiple
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows
from esrecsys_tpu_torch.retrieval.ivf import (Device, kmeans, kmeans_assign,
                                              on_device)
from esrecsys_tpu_torch.retrieval.mips import (NEG_INF, Count,
                                               _pad_block,
                                               _streamed_candidate_topk,
                                               chunked_topk,
                                               require_full_f32, valid_bound)


def anisotropic_eta(threshold: float, d: int) -> float:
    """Parallel over orthogonal residual weight of the score-aware loss,
    ``eta = (d-1) T^2 / (1 - T^2)`` for a relative score threshold T.
    Raises when eta < 1 (T < 1/sqrt(d)): the per-centroid normal matrix
    would be indefinite."""
    if not 0.0 < threshold < 1.0:
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    t2 = float(threshold) ** 2
    eta = (d - 1) * t2 / (1.0 - t2)
    if eta < 1.0:
        raise ValueError(
            f"threshold {threshold} gives eta={eta:.3f} < 1 at dim {d}; "
            f"need threshold >= 1/sqrt(d) = {1.0 / np.sqrt(d):.3f}")
    return eta


def _aniso_subspace_step(x_s, a_other, w, cents_s, codes_s, block: int,
                         update_centroids: bool):
    """One coordinate-descent step of the score-aware loss
    ``|r|^2 + w (x.r)^2`` on one subspace, the other subspaces' share
    ``a_other`` of ``x.r`` held fixed.

    The centroid update solves each centroid's quadratic,
    ``(n_c I + sum w x x^T) mu = sum x + sum w (a_other + |x|^2) x``: the
    three sums go through ``scatter_add_rows`` as one row of
    ``2 Ds + Ds^2`` floats per item, the C (Ds, Ds) systems through one
    batched solve; an empty centroid keeps its value. The reassignment
    scores all C centroids per row, over blocks of ``block`` rows.
    Returns (centroids, codes int64, the new ``a`` of this subspace)."""
    m, ds = x_s.shape
    c = cents_s.shape[0]
    if update_centroids:
        width = 2 * ds + ds * ds
        stats = torch.zeros((c, width), dtype=torch.float32,
                            device=x_s.device)
        for start in range(0, m, block):
            xs = x_s[start:start + block]
            wv = w[start:start + block]
            bvec = wv * (a_other[start:start + block] + (xs * xs).sum(1))
            outer = (wv[:, None, None] * xs[:, :, None] * xs[:, None, :])
            upd = torch.cat([xs, xs * bvec[:, None],
                             outer.reshape(xs.shape[0], ds * ds)], dim=1)
            scatter_add_rows(stats, codes_s[start:start + block], upd)
        cnt = torch.bincount(codes_s, minlength=c).float()
        sx, sb = stats[:, :ds], stats[:, ds:2 * ds]
        sxx = stats[:, 2 * ds:].reshape(c, ds, ds)
        eye = torch.eye(ds, dtype=torch.float32, device=x_s.device)
        lhs = cnt[:, None, None] * eye + sxx
        live = cnt > 0
        mu = torch.linalg.solve(torch.where(live[:, None, None], lhs, eye),
                                (sx + sb)[..., None])[..., 0]
        cents_s = torch.where(live[:, None], mu, cents_s)
    cn = (cents_s * cents_s).sum(1)
    codes = torch.empty(m, dtype=torch.int64, device=x_s.device)
    a_new = torch.empty(m, dtype=torch.float32, device=x_s.device)
    for start in range(0, m, block):
        xs = x_s[start:start + block]
        ao = a_other[start:start + block]
        wv = w[start:start + block]
        xs_norm = (xs * xs).sum(1)
        dot = xs @ cents_s.T
        a_cand = xs_norm[:, None] - dot
        cost = ((xs_norm[:, None] - 2.0 * dot + cn[None, :])
                + wv[:, None] * (ao[:, None] + a_cand) ** 2)
        code = torch.argmin(cost, dim=1)
        codes[start:start + block] = code
        a_new[start:start + block] = torch.gather(a_cand, 1,
                                                  code[:, None])[:, 0]
    return cents_s, codes, a_new


def _refine_anisotropic(dev: torch.Tensor, cents, codes, eta: float,
                        sweeps: int, block_size: int = 65_536,
                        update_centroids: bool = True):
    """``sweeps`` coordinate-descent sweeps (every subspace in turn) of the
    score-aware loss from ``cents`` (S, C, Ds) and ``codes`` (M, S):
    (centroids np.float32, codes np.uint8). ``update_centroids=False``
    only reassigns: the anisotropic encoder of a fixed codebook."""
    require_full_f32(dev)
    x = dev.float()
    s_sub, _, ds = np.shape(cents)
    block = min(block_size, pad_to_multiple(x.shape[0], 128))
    xnorm2 = (x * x).sum(1)
    w = torch.where(xnorm2 > 0, (eta - 1.0) / xnorm2.clamp(min=1e-12),
                    torch.zeros_like(xnorm2))
    cents_list = list(torch.as_tensor(np.asarray(cents, np.float32),
                                      device=x.device))
    codes_t = torch.as_tensor(np.asarray(codes), device=x.device).long()
    codes_cols = [codes_t[:, s].clone() for s in range(s_sub)]
    x_subs = [x[:, s * ds:(s + 1) * ds] for s in range(s_sub)]
    a = torch.stack([
        (xs * xs).sum(1) - (xs * cents_list[s][codes_cols[s]]).sum(1)
        for s, xs in enumerate(x_subs)], dim=1)           # (M, S)
    for _ in range(sweeps):
        for s in range(s_sub):
            a_other = a.sum(1) - a[:, s]
            cents_list[s], codes_cols[s], a[:, s] = _aniso_subspace_step(
                x_subs[s], a_other, w, cents_list[s], codes_cols[s], block,
                update_centroids)
    return (torch.stack(cents_list).cpu().numpy(),
            torch.stack(codes_cols, dim=1).cpu().numpy().astype(np.uint8))


def anisotropic_loss(vectors, book: "PQCodebook", threshold: float) -> float:
    """Mean score-aware loss of an encoding (host numpy)."""
    x = np.asarray(vectors, np.float32)
    r = x - book.decode()
    n2 = np.sum(x * x, axis=1)
    par = np.where(n2 > 0,
                   np.sum(x * r, axis=1) ** 2 / np.maximum(n2, 1e-12), 0.0)
    eta = anisotropic_eta(threshold, x.shape[1])
    return float(np.mean(np.sum(r * r, axis=1) + (eta - 1.0) * par))


class PQCodebook(NamedTuple):
    """Trained PQ codebooks and the encoded catalog (host numpy, the
    reference's fields). With ``rotation`` the codes live in the rotated
    space; ``q.x == (qR).(xR)``, so queries are rotated at search and the
    rescore stays in the original space."""

    centroids: np.ndarray  # (S, C, Ds) float32
    codes: np.ndarray      # (M, S) uint8
    n_items: int
    rotation: Optional[np.ndarray] = None        # (D, D) orthonormal
    anisotropic_threshold: Optional[float] = None

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_codes(self) -> int:
        return self.centroids.shape[1]

    @property
    def bytes_per_item(self) -> int:
        return self.n_subspaces

    @classmethod
    def build(cls, vectors, n_subspaces: int = 8, n_codes: int = 256,
              iters: int = 15, seed: int = 0, rotate: bool = False,
              train_sample: Optional[int] = None,
              anisotropic_threshold: Optional[float] = None,
              anisotropic_sweeps: int = 3,
              device: Device = None) -> "PQCodebook":
        """Train one k-means codebook per subspace (seed ``seed + s``) and
        encode the catalog. ``vectors`` is a tensor (sliced where it lies)
        or a host array (uploaded to ``device``). ``train_sample`` trains
        on that many sampled rows; ``anisotropic_threshold`` then refines
        centroids and codes under the score-aware loss (on the sample,
        with assignment-only sweeps over the whole catalog)."""
        m, d = vectors.shape
        if d % n_subspaces:
            raise ValueError(
                f"dim {d} not divisible by n_subspaces {n_subspaces}")
        if not 2 <= n_codes <= 256:
            raise ValueError(f"n_codes must be in [2, 256], got {n_codes}")
        if n_codes > m:
            raise ValueError(f"n_codes {n_codes} > items {m}")
        eta = (anisotropic_eta(anisotropic_threshold, d)
               if anisotropic_threshold is not None else None)
        ds = d // n_subspaces
        dev = on_device(vectors, device)
        rotation = None
        if rotate:
            q_rng = np.random.default_rng(seed)
            rotation, _ = np.linalg.qr(
                q_rng.standard_normal((d, d)).astype(np.float64))
            rotation = rotation.astype(np.float32)
            require_full_f32(dev)
            dev = dev @ torch.from_numpy(rotation).to(dev.device)
        cents, codes = [], []
        for s in range(n_subspaces):
            cent, assign = kmeans(dev[:, s * ds:(s + 1) * ds].contiguous(),
                                  n_codes, iters, seed + s,
                                  train_sample=train_sample)
            cents.append(cent.cpu().numpy())
            codes.append(assign.cpu().numpy())
        cents = np.stack(cents)
        codes = np.stack(codes, axis=1).astype(np.uint8)
        if eta is not None:
            if train_sample is not None and train_sample < m:
                idx = np.sort(np.random.default_rng(seed).choice(
                    m, train_sample, replace=False))
                cents, _ = _refine_anisotropic(
                    dev[torch.from_numpy(idx).to(dev.device)], cents,
                    codes[idx], eta, sweeps=anisotropic_sweeps)
                _, codes = _refine_anisotropic(
                    dev, cents, codes, eta,
                    sweeps=max(1, anisotropic_sweeps - 1),
                    update_centroids=False)
            else:
                cents, codes = _refine_anisotropic(
                    dev, cents, codes, eta, sweeps=anisotropic_sweeps)
        return cls(cents, codes, m, rotation, anisotropic_threshold)

    def encode(self, vectors, device: Device = None) -> "PQCodebook":
        """Encode a new catalog against these codebooks (and rotation):
        one nearest-centroid pass per subspace, then the anisotropic
        encoder's sweeps when the book was trained under that loss. No
        k-means (a reload's ``aux="reuse"``, and ``add_items``)."""
        m, d = vectors.shape
        if d != self.n_subspaces * self.centroids.shape[2]:
            raise ValueError(
                f"catalog dim {d} != codebook dim "
                f"{self.n_subspaces * self.centroids.shape[2]}")
        ds = self.centroids.shape[2]
        dev = on_device(vectors, device)
        if self.rotation is not None:
            require_full_f32(dev)
            dev = dev @ torch.from_numpy(self.rotation).to(dev.device)
        cents = torch.from_numpy(self.centroids).to(dev.device)
        codes = np.stack([
            kmeans_assign(dev[:, s * ds:(s + 1) * ds], cents[s]).cpu().numpy()
            for s in range(self.n_subspaces)], axis=1).astype(np.uint8)
        if self.anisotropic_threshold is not None:
            eta = anisotropic_eta(self.anisotropic_threshold, d)
            _, codes = _refine_anisotropic(dev, self.centroids, codes, eta,
                                           sweeps=2, update_centroids=False)
        return PQCodebook(self.centroids, codes, m, self.rotation,
                          self.anisotropic_threshold)

    def save(self, path: str) -> None:
        extra = {}
        if self.rotation is not None:
            extra["rotation"] = self.rotation
        if self.anisotropic_threshold is not None:
            extra["anisotropic_threshold"] = np.float64(
                self.anisotropic_threshold)
        np.savez_compressed(path, centroids=self.centroids,
                            codes=self.codes, n_items=np.int64(self.n_items),
                            **extra)

    @classmethod
    def load(cls, path: str) -> "PQCodebook":
        with np.load(path, allow_pickle=False) as z:
            rot = z["rotation"] if "rotation" in z.files else None
            thr = (float(z["anisotropic_threshold"])
                   if "anisotropic_threshold" in z.files else None)
            return cls(z["centroids"], z["codes"], int(z["n_items"]), rot,
                       thr)

    def decode(self) -> np.ndarray:
        """The (M, D) reconstruction in the original space (host)."""
        parts = [self.centroids[s][self.codes[:, s]]
                 for s in range(self.n_subspaces)]
        dec = np.concatenate(parts, axis=1)
        return dec @ self.rotation.T if self.rotation is not None else dec


def adc_lut(queries_f32: torch.Tensor, centroids: torch.Tensor,
            rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B..., S, C) per-query ADC tables, ``lut[..., s, c] = <q_s,
    cent_sc>``, the query rotated into the codebook's space when it has a
    rotation."""
    s_sub, _, ds = centroids.shape
    q = queries_f32 @ rotation.float() if rotation is not None else queries_f32
    return torch.einsum("...sd,scd->...sc",
                        q.reshape(q.shape[:-1] + (s_sub, ds)), centroids)


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores from (B, S, C) tables and codes: (w, S) shared by every
    query -> (B, w), or (B, w, S) per query -> (B, w). S lookups summed
    in subspace order, as the reference adds them."""
    total = None
    for s in range(lut.shape[1]):
        col = codes[..., s].long()
        part = (lut[:, s, :].index_select(-1, col) if col.dim() == 1
                else torch.gather(lut[:, s, :], -1, col))
        total = part if total is None else total + part
    return total


def pq_topk(
    queries: torch.Tensor,         # (B, D)
    centroids: torch.Tensor,       # (S, C, Ds) float32
    codes: torch.Tensor,           # (M, S) uint8
    k: int,
    rescore_items: Optional[torch.Tensor] = None,  # (M, D) float32 or int8
    block_size: int = 262_144,
    per_block_k: Optional[int] = None,
    oversample: int = 64,
    rotation: Optional[torch.Tensor] = None,
    rescore_scales: Optional[torch.Tensor] = None,  # (M,): int8 rescore
    valid_count: Count = None,
    item_mask: Optional[torch.Tensor] = None,       # (M,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k over PQ codes: (values (B, k) float32, ids (B, k) int64).

    Phase 1 streams the codes in blocks and keeps each block's best
    ``kb = per_block_k or min(block, ceil(oversample * k / nblk))`` by ADC
    (ties to the lower position). With ``rescore_items`` phase 2 rescores
    them in float32 (dequantized with ``rescore_scales`` when it is the
    int8 catalog) and returns the exact order over the candidates; without
    it the raw ADC top-k comes back. Rows at or past ``valid_count`` and
    rows where ``item_mask`` is False never return."""
    s_sub, _, ds = centroids.shape
    d = queries.shape[-1]
    if d != s_sub * ds:
        raise ValueError(f"query dim {d} != S*Ds = {s_sub}*{ds}")
    require_full_f32(queries)
    num_items = codes.shape[0]
    block = min(block_size, pad_to_multiple(num_items, 128))
    nblk = -(-num_items // block)
    kb = per_block_k or min(block, max(-(-oversample * k // nblk), 1))
    qf = queries.float()
    lut = adc_lut(qf, centroids, rotation)
    bound = valid_bound(num_items, valid_count)

    def score_block(b):
        start, stop = b * block, min((b + 1) * block, num_items)
        s = adc_scores(lut, codes[start:stop])
        if item_mask is not None:
            s = s.masked_fill(~item_mask[start:stop], NEG_INF)
        return _pad_block(s, block)

    if rescore_items is not None:
        return _streamed_candidate_topk(
            score_block, qf, rescore_items, num_items, k, block, nblk, kb,
            select="exact", recall_target=0.95,
            rescore_scales=rescore_scales, valid_count=valid_count,
            item_mask=item_mask)

    def raw_block(start):
        s = score_block(start // block)
        if start + block > bound:
            s = s.masked_fill(start + torch.arange(block, device=s.device)
                              >= bound, NEG_INF)
        return s

    return chunked_topk(raw_block, num_items, k)
