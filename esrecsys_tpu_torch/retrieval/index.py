"""Offline catalog embedding index (counterpart of
``esrecsys_tpu/retrieval/index.py``).

Same storage formats as the reference: ``.npz`` with ``ids`` and
``vectors`` arrays, or ``.json`` as ``{id: [floats]}``. The index lives on
the host as numpy; serving moves the matrix to the device. Growth
(``reserve``/``extend``) comes with the serving ``add_items`` path, which
is not ported yet.
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


class EmbeddingIndex:
    """An id -> vector store with dense matrix access for MIPS."""

    def __init__(self, ids: Sequence[str], vectors: np.ndarray):
        if len(ids) != vectors.shape[0]:
            raise ValueError(f"{len(ids)} ids vs {vectors.shape[0]} vectors")
        self.ids: List[str] = list(ids)
        self.vectors = np.asarray(vectors, np.float32)
        self._id2row = {k: i for i, k in enumerate(self.ids)}

    def __len__(self) -> int:
        return len(self.ids)

    def vector(self, id_: str) -> np.ndarray:
        return self.vectors[self._id2row[id_]]

    def save(self, path: str) -> None:
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump({k: self.vectors[i].tolist()
                           for i, k in enumerate(self.ids)}, f)
        else:
            np.savez_compressed(path, ids=np.asarray(self.ids),
                                vectors=self.vectors)

    @classmethod
    def load(cls, path: str) -> "EmbeddingIndex":
        if path.endswith(".json"):
            with open(path) as f:
                d = json.load(f)
            ids = list(d.keys())
            return cls(ids, np.asarray([d[k] for k in ids], np.float32))
        with np.load(path, allow_pickle=False) as z:
            return cls([str(x) for x in z["ids"]], z["vectors"])
