"""codex: print the records of corpus shards (counterpart of
``esrecsys_tpu/tools/codex.py``), each in protobuf's text format.

  python -m esrecsys_tpu_torch.tools.codex --input 'shards/part-*.bz2' --proto doc [--limit N]

``--proto`` is one of wiki (``Page``), doc (``TextDocument``), sdoc
(``SparseDocument``), tstat (``TokenStat``), cooccur
(``CooccurrenceRow``); corrupt records are skipped.
"""

from __future__ import annotations

import dataclasses

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import recordio
from esrecsys_tpu_torch.data.protos import (CooccurrenceRow, Page,
                                            SparseDocument, TextDocument,
                                            TokenStat)

PROTOS = {
    "wiki": Page,
    "doc": TextDocument,
    "sdoc": SparseDocument,
    "tstat": TokenStat,
    "cooccur": CooccurrenceRow,
}


@dataclasses.dataclass(frozen=True)
class CodexConfig:
    input: str = ""
    proto: str = "doc"
    limit: int = 0  # 0 = all


def main(argv=None) -> int:
    """Print the records; returns how many were printed."""
    cfg = config_lib.from_cli(CodexConfig, argv)
    if cfg.proto not in PROTOS:
        raise SystemExit(f"--proto must be one of {sorted(PROTOS)}")
    n = 0
    for msg in recordio.read_protos(cfg.input, PROTOS[cfg.proto],
                                    skip_corrupt=True):
        print(msg)
        n += 1
        if cfg.limit and n >= cfg.limit:
            break
    return n


if __name__ == "__main__":
    main()
