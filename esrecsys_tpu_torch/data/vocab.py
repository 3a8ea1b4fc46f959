"""Uri dictionaries (counterpart of ``JsonVocab`` in
``esrecsys_tpu/data/vocab.py``)."""

from __future__ import annotations

import json
from typing import Dict, Optional


class JsonVocab:
    """Insertion-ordered uri -> int dictionary, stored as a plain JSON
    object mapping each uri to its index in first-seen order."""

    def __init__(self, mapping: Optional[Dict[str, int]] = None):
        self.mapping: Dict[str, int] = dict(mapping or {})

    def add(self, uri: str) -> int:
        idx = self.mapping.get(uri)
        if idx is None:
            idx = len(self.mapping)
            self.mapping[uri] = idx
        return idx

    def __len__(self) -> int:
        return len(self.mapping)

    def __getitem__(self, uri: str) -> int:
        return self.mapping[uri]

    def get(self, uri: str, default=None):
        return self.mapping.get(uri, default)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.mapping, f)

    @classmethod
    def load(cls, path: str) -> "JsonVocab":
        with open(path) as f:
            return cls(json.load(f))
