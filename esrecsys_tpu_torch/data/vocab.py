"""Vocabularies (counterpart of ``esrecsys_tpu/data/vocab.py``): the
token ``Vocabulary`` with its minhash out-of-vocabulary buckets, and the
uri dictionaries (``JsonVocab``), the reference's tokenizer
(``simple_tokenize``), ``mod_hash`` and ``count_tokens``.

``Vocabulary`` keeps the reference's embedding-index layout: index 0 is
the mask, 1..size the dictionary's tokens by frequency rank, and
1+size .. 1+size+65535 the minhash buckets of tokens outside it. Its files
are ``TokenStat`` records in base64 lines (``data/recordio.py``), so a
dictionary written by either package loads in the other.
"""

from __future__ import annotations

import json
import re
import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import TokenStat

MINHASH_BUCKETS = 65536
MASK_INDEX = 0

# the reference tokenizer's separator class
_TOKEN_FILTER = re.compile("[ !@#$%^&*()_+\t\n\",.:;\\\\/?><|{}'\\[\\]]")


def simple_tokenize(text: str) -> List[str]:
    """Split on the separator class, lowercase, drop empty tokens."""
    return [t.lower() for t in _TOKEN_FILTER.split(text) if t]


def minhash(token) -> int:
    """The reference's 16-bit out-of-vocabulary hash: the crc32 of a token
    of at most 4 characters, else the least crc32 of the 4-byte windows
    starting in the first ``min(10, len) - 4`` positions, masked to 16
    bits. The length is counted in characters and the windows cut from
    the UTF-8 bytes, as the reference does."""
    n = len(token)
    b = token.encode("utf-8") if isinstance(token, str) else token
    if n <= 4:
        return zlib.crc32(b) & 0xFFFF
    n = min(10, n)
    h = 0xFFFFFFFF
    for i in range(n - 4):
        h = min(h, zlib.crc32(b[i:i + 4]) & 0xFFFF)
    return h


def mod_hash(ids, num_buckets: int):
    """Modulo bucketing of ids into ``num_buckets`` rows, for a Python
    int, a numpy array or a tensor (the result non-negative, as
    ``np.mod``'s)."""
    if isinstance(ids, (int, np.integer)):
        return int(ids % num_buckets)
    if isinstance(ids, torch.Tensor):
        return torch.remainder(ids, num_buckets)
    return np.mod(ids, num_buckets)


@dataclass
class VocabEntry:
    token: str
    frequency: int = 0
    doc_frequency: int = 0
    url: str = ""


class Vocabulary:
    """Frequency-sorted dictionary with minhash OOV and mask index 0."""

    def __init__(self, entries: Optional[Sequence[VocabEntry]] = None):
        self._entries: List[VocabEntry] = []
        self._token2index: Dict[str, int] = {}
        self._max_doc_frequency = 0
        for e in entries or ():
            self._append(e)

    def _append(self, e: VocabEntry) -> None:
        self._token2index[e.token] = len(self._entries)
        self._entries.append(e)
        self._max_doc_frequency = max(self._max_doc_frequency,
                                      e.doc_frequency)

    @classmethod
    def from_counts(cls, frequency: Dict[str, int],
                    doc_frequency: Optional[Dict[str, int]] = None,
                    min_frequency: int = 0, max_size: Optional[int] = None,
                    urls: Optional[Dict[str, str]] = None) -> "Vocabulary":
        """Tokens with ``frequency >= min_frequency``, by frequency
        descending (ties by token), cut to ``max_size``."""
        items = [(t, f) for t, f in frequency.items() if f >= min_frequency]
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        if max_size is not None:
            items = items[:max_size]
        return cls([VocabEntry(token=t, frequency=f,
                               doc_frequency=(doc_frequency or {}).get(t, 0),
                               url=(urls or {}).get(t, ""))
                    for t, f in items])

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size(self) -> int:
        return len(self._entries)

    @property
    def num_embeddings(self) -> int:
        """Embedding-table rows: the mask, the dictionary, the minhash
        buckets."""
        return 1 + self.size + MINHASH_BUCKETS

    @property
    def max_doc_frequency(self) -> int:
        return self._max_doc_frequency

    def token_index(self, token: str) -> Optional[int]:
        return self._token2index.get(token)

    def token(self, index: int) -> str:
        return self._entries[index].token

    def doc_frequency(self, index: int) -> int:
        return self._entries[index].doc_frequency

    def frequency(self, index: int) -> int:
        return self._entries[index].frequency

    def embedding_index(self, token: str) -> int:
        """0 is the mask; known tokens 1..size; others their minhash
        bucket after the dictionary."""
        idx = self._token2index.get(token)
        if idx is not None:
            return 1 + idx
        return 1 + self.size + minhash(token)

    def embedding_indices(self, tokens: Iterable[str]) -> List[int]:
        return [self.embedding_index(t) for t in tokens]

    def token_from_embedding_index(self, embedding_index: int) -> str:
        if embedding_index == MASK_INDEX:
            return "NULL"
        if embedding_index <= self.size:
            return self._entries[embedding_index - 1].token
        return "MINHASH %d" % (embedding_index - 1 - self.size)

    def save(self, path: str) -> None:
        """Write the entries as ``TokenStat`` records, ``index`` their
        rank."""
        recordio.write_protos(path, (
            TokenStat(token=e.token, url=e.url, frequency=e.frequency,
                      doc_frequency=e.doc_frequency, index=i)
            for i, e in enumerate(self._entries)))

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        """Read ``TokenStat`` records; their ``index`` must count from 0."""
        vocab = cls()
        for i, ts in enumerate(recordio.read_protos(path, TokenStat)):
            if ts.index != i:
                raise ValueError(f"non-contiguous index {ts.index} at row "
                                 f"{i} in {path}")
            vocab._append(VocabEntry(token=ts.token, frequency=ts.frequency,
                                     doc_frequency=ts.doc_frequency,
                                     url=ts.url))
        return vocab


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


def count_tokens(docs_tokens: Iterable[Sequence[str]]
                 ) -> Tuple[Counter, Counter]:
    """(frequency, doc_frequency) over an iterable of token lists."""
    freq: Counter = Counter()
    doc_freq: Counter = Counter()
    for tokens in docs_tokens:
        freq.update(tokens)
        doc_freq.update(set(tokens))
    return freq, doc_freq
