"""Co-occurrence matrices (counterpart of
``esrecsys_tpu/etl/cooccurrence.py``).

  * :func:`build_token_cooccurrence`: a window over each document's token
    embedding ids, each pair weighted ``1/|i-j|``, kept on the larger
    id's row only (GloVe's input);
  * :func:`build_url_cooccurrence`: unweighted pair counts over each
    url2url document's title ids (txt2url's dice input).

Both add into one accumulator, the native one (``native/cooccur.cc``)
where it builds, else :class:`PyCoocAccumulator` (the same sums in the
same float64 order), and write ``CooccurrenceRow`` shards with rows split
at ``max_row_size`` entries.

CLI:
  python -m esrecsys_tpu_torch.etl.cooccurrence --mode tokens \
      --input 'docs/part-*' --token_dictionary tokens.bz2 --output cooc/
  python -m esrecsys_tpu_torch.etl.cooccurrence --mode urls \
      --input 'url2url/part-*' --output url_cooc/
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import (CooccurrenceRow, SparseDocument,
                                            TextDocument)
from esrecsys_tpu_torch.data.vocab import Vocabulary

log = logging.getLogger(__name__)


class PyCoocAccumulator:
    """The accumulator in Python (the native one's semantics)."""

    def __init__(self) -> None:
        self.rows: Dict[int, Dict[int, float]] = {}

    def add_window(self, token_ids: Sequence[int], window: int) -> None:
        """For each position i, the ids at j in ``[i - window, i +
        window)`` smaller than ``ids[i]`` add ``1/|i-j|`` to row
        ``ids[i]``; equal ids are skipped."""
        n = len(token_ids)
        for i in range(n):
            my_idx = token_ids[i]
            row = self.rows.setdefault(my_idx, {})
            for j in range(max(0, i - window), min(n, i + window)):
                other = token_ids[j]
                if my_idx <= other:
                    continue
                row[other] = row.get(other, 0.0) + 1.0 / abs(i - j)
            if not row:
                self.rows.pop(my_idx, None)

    def add_pairs(self, ids: Sequence[int]) -> None:
        """Each unordered pair of the distinct ids adds 1 to the larger
        id's row."""
        unique = sorted(set(ids))
        for i, a in enumerate(unique):
            row = self.rows.setdefault(a, {})
            for b in unique[:i]:
                row[b] = row.get(b, 0.0) + 1.0
            if not row:
                self.rows.pop(a, None)

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, others, counts) sorted by (row, other)."""
        rows, others, counts = [], [], []
        for idx in sorted(self.rows):
            for other, c in sorted(self.rows[idx].items()):
                rows.append(idx)
                others.append(other)
                counts.append(c)
        return (np.asarray(rows, np.int64), np.asarray(others, np.int64),
                np.asarray(counts, np.float64))


def make_accumulator():
    """The native accumulator where the library builds, else the Python
    one."""
    try:
        from esrecsys_tpu_torch.native import NativeCoocAccumulator

        return NativeCoocAccumulator()
    except (OSError, RuntimeError) as e:
        log.info("native accumulator unavailable (%s); using Python", e)
    return PyCoocAccumulator()


def _row_slices(rows: np.ndarray, max_row_size: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the rows' runs in (row, other) order, each cut
    every ``max_row_size`` entries."""
    n = rows.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    run_starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    run_ends = np.r_[run_starts[1:], n]
    starts = np.concatenate([np.arange(s, e, max_row_size)
                             for s, e in zip(run_starts, run_ends)])
    ends = np.minimum(starts + max_row_size,
                      np.repeat(run_ends, -(-(run_ends - run_starts)
                                            // max_row_size)))
    return starts, ends


def rows_from_accumulator(acc, max_row_size: int = 1000
                          ) -> Iterable[CooccurrenceRow]:
    """The accumulator's rows in (row, other) order, each cut into
    ``CooccurrenceRow``s of at most ``max_row_size`` entries (counts
    rounded to float32)."""
    rows, others, counts = acc.export()
    for a, b in zip(*_row_slices(rows, max_row_size)):
        yield CooccurrenceRow(index=int(rows[a]), other_index=others[a:b],
                              count=counts[a:b])


def _write_rows(acc, output_dir: str, max_row_size: int,
                rows_per_shard: int) -> int:
    n = 0
    with recordio.ShardedWriter(output_dir, rows_per_shard) as w:
        for row in rows_from_accumulator(acc, max_row_size):
            w.write_proto(row)
            n += 1
    return n


def build_token_cooccurrence(input_pattern: str, vocab: Vocabulary,
                             output_dir: str, window: int = 10,
                             max_row_size: int = 1000,
                             rows_per_shard: int = 10_000) -> int:
    """``TextDocument`` shards -> token co-occurrence shards of embedding
    ids; returns the row count."""
    acc = make_accumulator()
    n_docs = 0
    for doc in recordio.read_protos(input_pattern, TextDocument,
                                    skip_corrupt=True):
        acc.add_window(vocab.embedding_indices(doc.tokens), window)
        n_docs += 1
        if n_docs % 10_000 == 0:
            log.info("processed %d docs", n_docs)
    n = _write_rows(acc, output_dir, max_row_size, rows_per_shard)
    log.info("%d docs -> %d cooccurrence rows -> %s", n_docs, n, output_dir)
    return n


def build_url_cooccurrence(input_pattern: str, output_dir: str,
                           max_row_size: int = 1000,
                           rows_per_shard: int = 10_000) -> int:
    """url2url ``SparseDocument`` shards (primary and secondary title
    indices) -> pair-count shards; returns the row count."""
    acc = make_accumulator()
    for sdoc in recordio.read_protos(input_pattern, SparseDocument,
                                     skip_corrupt=True):
        acc.add_pairs([sdoc.primary_index] + list(sdoc.secondary_index))
    n = _write_rows(acc, output_dir, max_row_size, rows_per_shard)
    log.info("%d url cooccurrence rows -> %s", n, output_dir)
    return n


@dataclasses.dataclass(frozen=True)
class CooccurrenceConfig:
    mode: str = "tokens"        # tokens | urls
    input: str = ""
    output: str = ""
    token_dictionary: str = ""
    context_window: int = 10
    max_row_size: int = 1000


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = config_lib.from_cli(CooccurrenceConfig, argv)
    if cfg.mode == "tokens":
        vocab = Vocabulary.load(cfg.token_dictionary)
        build_token_cooccurrence(cfg.input, vocab, cfg.output,
                                 cfg.context_window, cfg.max_row_size)
    elif cfg.mode == "urls":
        build_url_cooccurrence(cfg.input, cfg.output, cfg.max_row_size)
    else:
        raise SystemExit(f"unknown --mode {cfg.mode}")


if __name__ == "__main__":
    main()
