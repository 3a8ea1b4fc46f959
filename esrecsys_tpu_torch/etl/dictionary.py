"""Dictionaries from ``TextDocument`` shards (counterpart of
``esrecsys_tpu/etl/dictionary.py``): the token dictionary counts body
tokens, the title dictionary the page URL and its links' URLs; each is
``Vocabulary.from_counts`` of the frequencies and document frequencies
(minimum frequency, frequency descending with ties by token, cut to the
maximum size), saved as ``TokenStat`` records.

CLI:
  python -m esrecsys_tpu_torch.etl.dictionary --input 'docs/part-*' \
      --token_output tokens.bz2 --title_output titles.bz2
"""

from __future__ import annotations

import dataclasses
import logging
from collections import Counter
from typing import Iterable, Tuple

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import TextDocument
from esrecsys_tpu_torch.data.vocab import Vocabulary, count_tokens

log = logging.getLogger(__name__)


def count_doc_tokens(docs: Iterable[TextDocument]) -> Tuple[Counter, Counter]:
    """(frequency, doc_frequency) of the documents' body tokens."""
    return count_tokens(doc.tokens for doc in docs)


def count_doc_titles(docs: Iterable[TextDocument]) -> Tuple[Counter, Counter]:
    """(frequency, doc_frequency) of the documents' primary and secondary
    URLs."""
    return count_tokens([doc.primary] + list(doc.secondary) for doc in docs)


def build_token_dictionary(input_pattern: str, min_frequency: int = 50,
                           max_size: int = 500_000) -> Vocabulary:
    freq, doc_freq = count_doc_tokens(recordio.read_protos(
        input_pattern, TextDocument, skip_corrupt=True))
    return Vocabulary.from_counts(freq, doc_freq, min_frequency, max_size)


def build_title_dictionary(input_pattern: str, min_frequency: int = 5,
                           max_size: int = 5_000_000) -> Vocabulary:
    freq, doc_freq = count_doc_titles(recordio.read_protos(
        input_pattern, TextDocument, skip_corrupt=True))
    return Vocabulary.from_counts(freq, doc_freq, min_frequency, max_size)


@dataclasses.dataclass(frozen=True)
class DictionaryConfig:
    """The reference's defaults: tokens of frequency 50 or more, at most
    500,000; titles of frequency 5 or more, at most 5,000,000."""

    input: str = ""
    token_output: str = ""
    title_output: str = ""
    min_token_frequency: int = 50
    max_token_dictionary_size: int = 500_000
    min_title_frequency: int = 5
    max_title_dictionary_size: int = 5_000_000


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = config_lib.from_cli(DictionaryConfig, argv)
    if cfg.token_output:
        vocab = build_token_dictionary(cfg.input, cfg.min_token_frequency,
                                       cfg.max_token_dictionary_size)
        vocab.save(cfg.token_output)
        log.info("token dictionary: %d entries -> %s", len(vocab),
                 cfg.token_output)
    if cfg.title_output:
        vocab = build_title_dictionary(cfg.input, cfg.min_title_frequency,
                                       cfg.max_title_dictionary_size)
        vocab.save(cfg.title_output)
        log.info("title dictionary: %d entries -> %s", len(vocab),
                 cfg.title_output)


if __name__ == "__main__":
    main()
