"""The top correlates of each row of co-occurrence shards (counterpart
of ``esrecsys_tpu/tools/dump_correlates.py``): by raw count, or by dice
``scale * joint / (df_a + df_b)`` (1.0 is the reference's dump, 2.0 the
training target's).

  python -m esrecsys_tpu_torch.tools.dump_correlates --input 'cooc/part-*' \
      --dictionary titles.bz2 --metric dice --topk 10 [--embedding_indices true]

Rows of title dictionary indices (url co-occurrence) name entries by
index; ``--embedding_indices true`` reads rows of token embedding ids
(token co-occurrence: 0 the mask, the dictionary from 1, minhash
buckets past it).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import CooccurrenceRow
from esrecsys_tpu_torch.data.vocab import Vocabulary


@dataclasses.dataclass(frozen=True)
class DumpConfig:
    input: str = ""
    dictionary: str = ""
    metric: str = "count"   # count | dice
    scale: float = 1.0
    topk: int = 10
    limit: int = 20         # rows to print (0 = all)
    embedding_indices: bool = False  # rows hold token embedding ids


def main(argv=None) -> List[str]:
    """Print one line a row; returns the lines."""
    cfg = config_lib.from_cli(DumpConfig, argv)
    vocab = Vocabulary.load(cfg.dictionary)

    def name(idx: int) -> str:
        if cfg.embedding_indices:
            return vocab.token_from_embedding_index(idx)
        return vocab.token(idx) if idx < len(vocab) else f"?{idx}"

    def df(idx: int) -> float:
        i = idx - 1 if cfg.embedding_indices else idx
        if 0 <= i < len(vocab):
            return float(vocab.doc_frequency(i))
        return 1.0

    lines = []
    for row in recordio.read_protos(cfg.input, CooccurrenceRow,
                                    skip_corrupt=True):
        scored = []
        for other, joint in zip(row.other_index, row.count):
            if cfg.metric == "dice":
                score = cfg.scale * float(joint) / (df(row.index) + df(other))
            else:
                score = float(joint)
            scored.append((score, other))
        top = heapq.nlargest(cfg.topk, scored)
        correlates = " ".join(f"{name(o)}:{s:.4f}" for s, o in top)
        lines.append(f"{name(row.index)}: {correlates}")
        print(lines[-1])
        if cfg.limit and len(lines) >= cfg.limit:
            break
    return lines


if __name__ == "__main__":
    main()
