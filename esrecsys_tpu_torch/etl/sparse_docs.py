"""``TextDocument`` -> ``SparseDocument`` (counterpart of
``esrecsys_tpu/etl/sparse_docs.py``), three ways:

  * ``txt2url``: the page's title index and its tokens' embedding
    indices (pages whose URL is not in the title dictionary dropped);
  * ``url2url``: the page's title index and its links' title indices
    (links outside the dictionary dropped; pages with none left
    dropped);
  * ``tfidf``: the in-dictionary tokens' dictionary indices, sorted,
    with L2-normalised tf-idf weights, ``idf = log1p(max_df) -
    log1p(df) + 1`` clamped at 0 (float64, rounded to float32 when
    written).

CLI:
  python -m esrecsys_tpu_torch.etl.sparse_docs --mode txt2url --input 'docs/part-*' \
      --token_dictionary tokens.bz2 --title_dictionary titles.bz2 --output out/
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import Counter
from typing import Optional

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import SparseDocument, TextDocument
from esrecsys_tpu_torch.data.vocab import Vocabulary

log = logging.getLogger(__name__)


def doc_to_txt2url(doc: TextDocument, token_vocab: Vocabulary,
                   title_vocab: Vocabulary) -> Optional[SparseDocument]:
    primary = title_vocab.token_index(doc.primary)
    if primary is None:
        return None
    return SparseDocument(url=doc.primary, primary_index=primary,
                          token_index=token_vocab.embedding_indices(
                              doc.tokens))


def doc_to_url2url(doc: TextDocument, title_vocab: Vocabulary
                   ) -> Optional[SparseDocument]:
    primary = title_vocab.token_index(doc.primary)
    if primary is None:
        return None
    secondary = [idx for t in doc.secondary
                 if (idx := title_vocab.token_index(t)) is not None]
    if not secondary:
        return None
    return SparseDocument(url=doc.primary, primary_index=primary,
                          secondary_index=secondary)


def doc_to_tfidf(doc: TextDocument, token_vocab: Vocabulary,
                 title_vocab: Vocabulary) -> Optional[SparseDocument]:
    primary = title_vocab.token_index(doc.primary)
    if primary is None:
        return None
    counts: Counter = Counter()
    for tok in doc.tokens:
        idx = token_vocab.token_index(tok)
        if idx is not None:
            counts[idx] += 1
    if not counts:
        return None
    max_df = token_vocab.max_doc_frequency
    idx_list, tfidf = [], []
    for idx, tf in sorted(counts.items()):
        idf = (math.log1p(max_df) - math.log1p(token_vocab.doc_frequency(idx))
               + 1.0)
        idx_list.append(idx)
        tfidf.append(tf * max(idf, 0.0))
    norm = math.sqrt(sum(v * v for v in tfidf)) or 1.0
    return SparseDocument(url=doc.primary, primary_index=primary,
                          token_index=idx_list,
                          token_tfidf=[v / norm for v in tfidf])


_CONVERTERS = {
    "txt2url": lambda doc, tok, title: doc_to_txt2url(doc, tok, title),
    "url2url": lambda doc, tok, title: doc_to_url2url(doc, title),
    "tfidf": lambda doc, tok, title: doc_to_tfidf(doc, tok, title),
}


def convert(mode: str, input_pattern: str, output_dir: str,
            token_vocab: Optional[Vocabulary], title_vocab: Vocabulary,
            docs_per_shard: int = 1000) -> int:
    """``TextDocument`` shards -> ``SparseDocument`` shards by ``mode``;
    returns the document count."""
    fn = _CONVERTERS[mode]
    n = 0
    with recordio.ShardedWriter(output_dir, docs_per_shard) as w:
        for doc in recordio.read_protos(input_pattern, TextDocument,
                                        skip_corrupt=True):
            sdoc = fn(doc, token_vocab, title_vocab)
            if sdoc is not None:
                w.write_proto(sdoc)
                n += 1
    log.info("%s: wrote %d sparse docs to %s", mode, n, output_dir)
    return n


@dataclasses.dataclass(frozen=True)
class SparseDocConfig:
    mode: str = "txt2url"      # txt2url | url2url | tfidf
    input: str = ""
    output: str = ""
    token_dictionary: str = ""
    title_dictionary: str = ""
    docs_per_shard: int = 1000


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = config_lib.from_cli(SparseDocConfig, argv)
    token_vocab = (Vocabulary.load(cfg.token_dictionary)
                   if cfg.token_dictionary else None)
    title_vocab = Vocabulary.load(cfg.title_dictionary)
    convert(cfg.mode, cfg.input, cfg.output, token_vocab, title_vocab,
            cfg.docs_per_shard)


if __name__ == "__main__":
    main()
