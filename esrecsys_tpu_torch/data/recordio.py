"""Line-oriented record IO (counterpart of ``esrecsys_tpu/data/recordio.py``):
one base64(payload) per line inside a bz2 (``.bz2``), gzip (``.gz``) or
plain stream, the reference's ``*.pb.b64.bz2`` shards and directories of
``part-NNNNN.bz2`` files. The format is the reference's, so files written
by either package read in the other.

Messages are the port's own (``data/protos.py``): anything with
``SerializeToString()`` writes, and a class with ``ParseFromString`` reads.

Not ported: the reference's native base64 fast path (it comes with the
ETL's native code) and the per-process file slices of multi-host runs.
"""

from __future__ import annotations

import base64
import bz2
import glob as glob_lib
import gzip
import os
from typing import Iterable, Iterator, List, TypeVar

import numpy as np

from esrecsys_tpu_torch.data.protos import DecodeError

T = TypeVar("T")


def _open_read(path: str):
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _open_write(path: str):
    if path.endswith(".bz2"):
        return bz2.open(path, "wb")
    if path.endswith(".gz"):
        return gzip.open(path, "wb", compresslevel=5)
    return open(path, "wb")


# records joined into one write
_WRITE_BATCH = 4096


def write_records(path: str, payloads: Iterable[bytes]) -> int:
    """Write raw payloads as base64 lines. Returns the record count."""
    n = 0
    lines: List[bytes] = []
    with _open_write(path) as f:
        for payload in payloads:
            lines.append(base64.b64encode(payload) + b"\n")
            n += 1
            if len(lines) == _WRITE_BATCH:
                f.write(b"".join(lines))
                lines = []
        f.write(b"".join(lines))
    return n


def read_records(path: str) -> Iterator[bytes]:
    """Yield the raw payloads of one file (decompressed whole, then split
    into lines)."""
    with _open_read(path) as f:
        data = f.read()
    for line in data.split(b"\n"):
        if line:
            yield base64.b64decode(line)


def read_protos(pattern: str, proto_cls, skip_corrupt: bool = False
                ) -> Iterator:
    """Parse every record of the files matching a glob, in sorted path
    order, into ``proto_cls`` messages; ``skip_corrupt`` drops records
    that do not parse instead of raising :class:`DecodeError`."""
    for path in sorted(glob_lib.glob(pattern)):
        for payload in read_records(path):
            msg = proto_cls()
            try:
                msg.ParseFromString(payload)
            except DecodeError:
                if skip_corrupt:
                    continue
                raise
            yield msg


def write_protos(path: str, messages: Iterable) -> int:
    return write_records(path, (m.SerializeToString() for m in messages))


class ShardedWriter:
    """Write records into ``part-NNNNN.<ext>`` shards of at most
    ``records_per_shard`` records, as a context manager."""

    def __init__(self, output_dir: str, records_per_shard: int = 1000,
                 ext: str = "bz2"):
        self.output_dir = output_dir
        self.records_per_shard = records_per_shard
        self.ext = ext
        self._shard = -1
        self._in_shard = 0
        self._file = None
        self.total = 0
        os.makedirs(output_dir, exist_ok=True)

    def _roll(self) -> None:
        if self._file is not None:
            self._file.close()
        self._shard += 1
        self._in_shard = 0
        path = os.path.join(self.output_dir,
                            f"part-{self._shard:05d}.{self.ext}")
        self._file = _open_write(path)

    def write(self, payload: bytes) -> None:
        if self._file is None or self._in_shard >= self.records_per_shard:
            self._roll()
        self._file.write(base64.b64encode(payload))
        self._file.write(b"\n")
        self._in_shard += 1
        self.total += 1

    def write_proto(self, msg) -> None:
        self.write(msg.SerializeToString())

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "ShardedWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def proto_stream(pattern: str, proto_cls, shuffle_files: bool = False,
                 repeat: bool = False, seed: int = 0) -> Iterator:
    """Messages of the files matching a glob; ``shuffle_files`` permutes
    the file order each pass with ``np.random.default_rng(seed)``, and
    ``repeat`` makes the passes endless (the reference's order for a
    seed)."""
    files = sorted(glob_lib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no files match {pattern}")
    rng = np.random.default_rng(seed)
    while True:
        order = (rng.permutation(len(files)) if shuffle_files
                 else np.arange(len(files)))
        for i in order:
            yield from read_protos(files[i], proto_cls)
        if not repeat:
            return


def shuffled(it: Iterator[T], buffer_size: int, seed: int = 0
             ) -> Iterator[T]:
    """Streaming buffer shuffle: fill ``buffer_size`` items, then swap one
    random buffered item out per item read; drain in random order. Draws
    from ``np.random.default_rng(seed)`` as the reference does, so a seed
    gives its order."""
    rng = np.random.default_rng(seed)
    buf: List[T] = []
    for item in it:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = int(rng.integers(0, buffer_size))
        buf[j], item = item, buf[j]
        yield item
    for j in rng.permutation(len(buf)):
        yield buf[j]
