"""Offline catalog embedding index (counterpart of
``esrecsys_tpu/retrieval/index.py``).

Same storage formats as the reference: ``.npz`` with ``ids`` and
``vectors`` arrays, or ``.json`` as ``{id: [floats]}``. The index lives on
the host as numpy; serving moves the matrix to the device. ``reserve``
preallocates the host rows that serving's ``add_capacity`` holds on the
device, and ``extend`` appends into them (``/admin/add_items``).
:func:`build_index` embeds a keyed image stream into an index (the
Shop-the-Look catalogs); unlike the reference's source
(``make_embeddings.py``), no tail item is dropped.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class EmbeddingIndex:
    """An id -> vector store with dense matrix access for MIPS."""

    def __init__(self, ids: Sequence[str], vectors: np.ndarray):
        if len(ids) != vectors.shape[0]:
            raise ValueError(f"{len(ids)} ids vs {vectors.shape[0]} vectors")
        self.ids: List[str] = list(ids)
        self.vectors = np.asarray(vectors, np.float32)
        self._id2row = {k: i for i, k in enumerate(self.ids)}
        self._buf: Optional[np.ndarray] = None  # see reserve()

    def reserve(self, capacity: int) -> None:
        """Preallocate host rows up to ``capacity`` so that :meth:`extend`
        appends in O(n) instead of copying the whole matrix each call.
        ``vectors`` becomes a view of the first ``len(self)`` rows."""
        if capacity <= len(self.ids):
            return
        buf = np.zeros((capacity, self.vectors.shape[1]), np.float32)
        buf[:len(self.ids)] = self.vectors
        self._buf = buf
        self.vectors = buf[:len(self.ids)]

    def __len__(self) -> int:
        return len(self.ids)

    def vector(self, id_: str) -> np.ndarray:
        return self.vectors[self._id2row[id_]]

    def extend(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        """Append items. Ids are stringified before the duplicate check
        (a JSON number must collide with its string form); an id already
        present, a repeated id or a dim mismatch raises ValueError, and
        then nothing is appended."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.vectors.shape[1]:
            raise ValueError(
                f"vectors {vectors.shape} != (n, {self.vectors.shape[1]})")
        if len(ids) != vectors.shape[0]:
            raise ValueError(f"{len(ids)} ids vs {vectors.shape[0]} vectors")
        ids = [str(i) for i in ids]
        dup = [i for i in ids if i in self._id2row]
        if dup or len(set(ids)) != len(ids):
            raise ValueError(f"duplicate ids: {dup or 'within batch'}")
        base, end = len(self.ids), len(self.ids) + len(ids)
        if self._buf is not None and end <= self._buf.shape[0]:
            self._buf[base:end] = vectors
            self.vectors = self._buf[:end]
        else:  # past the reserved rows: back to copying
            self._buf = None
            self.vectors = np.concatenate([self.vectors, vectors], axis=0)
        self.ids.extend(ids)
        self._id2row.update((key, base + j) for j, key in enumerate(ids))

    def save(self, path: str) -> None:
        """Write ``.json`` ({id: [floats]}) or a plain (uncompressed)
        ``.npz``, which ``np.load`` reads as it reads the reference's
        compressed one: float32 vectors barely compress, and zlib over the
        flagship's 579 MB takes tens of seconds on the host, a cost each
        deploy cycle would pay."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump({k: self.vectors[i].tolist()
                           for i, k in enumerate(self.ids)}, f)
        else:
            np.savez(path, ids=np.asarray(self.ids), vectors=self.vectors)

    @classmethod
    def load(cls, path: str) -> "EmbeddingIndex":
        if path.endswith(".json"):
            with open(path) as f:
                d = json.load(f)
            ids = list(d.keys())
            return cls(ids, np.asarray([d[k] for k in ids], np.float32))
        with np.load(path, allow_pickle=False) as z:
            return cls([str(x) for x in z["ids"]], z["vectors"])


def build_index(
    embed_fn: Callable,
    batches: Iterable[Tuple[Sequence[str], np.ndarray, int]],
) -> EmbeddingIndex:
    """Run ``embed_fn`` (a tower, images -> (B, D) tensor or array) over
    keyed batches -> :class:`EmbeddingIndex` of the valid rows.

    ``batches`` yields (keys, images, valid_count) as
    ``data/images.keyed_image_dataset`` produces them."""
    ids: List[str] = []
    vecs: List[np.ndarray] = []
    for keys, images, valid in batches:
        emb = embed_fn(images)
        if hasattr(emb, "detach"):
            emb = emb.detach().cpu().numpy()
        ids.extend(keys[:valid])
        vecs.append(np.asarray(emb)[:valid])
    return EmbeddingIndex(ids, np.concatenate(vecs, axis=0))
