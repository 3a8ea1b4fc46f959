"""Host-side C++ code, loaded with ctypes: the ETL's (counterpart of
``esrecsys_tpu/native``; ``cooccur.cc`` and ``text.cc`` here are the
port's own copies of the reference's sources) and the image pipeline's
baseline JPEG decoder and writer (``jpeg.cc``, the port's own: the
reference decodes through TensorFlow).

The library builds with ``g++`` at its first use in a process, into
``_build/libesrecsys_native-<hash>.so`` beside the package (``<hash>``
covers the sources and the flags, so an edited source never loads a
stale library); nothing is written next to the sources. Raises
``RuntimeError`` where there is no ``g++`` or the build fails; callers
that have a Python version (``etl/cooccurrence.make_accumulator``,
``data/recordio.read_records``) use it then. The JPEG code has none:
``data/jpeg.py`` raises.

Exposes:
  * :class:`NativeCoocAccumulator`: the hash-map co-occurrence
    accumulator (window and pair modes) of ``etl/cooccurrence.py``;
  * :func:`decode_b64_lines`: the base64 lines of a record file decoded
    in one call (malformed lines raise ``ValueError``);
  * :func:`tokenize`: ``data/vocab.simple_tokenize`` in C++, equal to it
    on any text (non-ASCII tokens are lowercased by Python's
    ``str.lower``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "cooccur.cc", _DIR / "text.cc", _DIR / "jpeg.cc")
BUILD_DIR = _DIR.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libesrecsys_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native ETL code needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    log.info("building the native library: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic publish


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, its signatures declared."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        arr_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        arr_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.cooc_new.restype = ptr
        lib.cooc_free.argtypes = [ptr]
        lib.cooc_add_window.argtypes = [ptr, arr_i64, i64, i64]
        lib.cooc_add_pairs.argtypes = [ptr, arr_i64, i64]
        lib.cooc_num_entries.argtypes = [ptr]
        lib.cooc_num_entries.restype = i64
        lib.cooc_export.argtypes = [
            ptr, arr_i64, arr_i64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        lib.b64_decode_lines.argtypes = [ctypes.c_char_p, i64, arr_u8,
                                         arr_i64, i64]
        lib.b64_decode_lines.restype = i64
        lib.wiki_tokenize.argtypes = [ctypes.c_char_p, i64, arr_u8, i64,
                                      arr_u8, i64, arr_i64]
        lib.wiki_tokenize.restype = i64
        arr_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        err = ctypes.c_char_p
        lib.jpeg_header.argtypes = [ctypes.c_char_p, i64, arr_i64, err, i64]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, i64, arr_u8, i64,
                                        err, i64]
        lib.jpeg_decode_rgb.restype = ctypes.c_int
        lib.jpeg_decode_fit.argtypes = [ctypes.c_char_p, i64, i64, arr_f32,
                                        arr_f32, err, i64]
        lib.jpeg_decode_fit.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [arr_u8, i64, i64, i64, i64, i64, i64,
                                    arr_u8, i64, err, i64]
        lib.jpeg_encode.restype = i64
        _lib = lib
        return lib


class NativeCoocAccumulator:
    """The C++ co-occurrence accumulator: the semantics of
    ``etl/cooccurrence.PyCoocAccumulator``, its sums in float64 in the
    same order. Raises on construction if the library cannot be built."""

    def __init__(self) -> None:
        self._lib = load()
        self._handle = self._lib.cooc_new()

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.cooc_free(self._handle)
            self._handle = None

    def add_window(self, ids: Sequence[int], window: int) -> None:
        arr = np.ascontiguousarray(ids, np.int64)
        self._lib.cooc_add_window(self._handle, arr, len(arr), window)

    def add_pairs(self, ids: Sequence[int]) -> None:
        arr = np.ascontiguousarray(ids, np.int64)
        self._lib.cooc_add_pairs(self._handle, arr, len(arr))

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, others, counts) sorted by (row, other)."""
        n = self._lib.cooc_num_entries(self._handle)
        rows = np.empty(n, np.int64)
        others = np.empty(n, np.int64)
        counts = np.empty(n, np.float64)
        if n:
            self._lib.cooc_export(self._handle, rows, others, counts)
        return rows, others, counts


def decode_b64_lines(data: bytes) -> List[bytes]:
    """The payloads of newline-separated base64 lines, decoded in one
    call; a line that is not base64 (a character outside the alphabet, a
    length no encoding has, padding in the wrong place) raises
    ``ValueError`` naming its 0-based index. A final empty line gives no
    payload; an empty line elsewhere gives an empty one."""
    lib = load()
    max_lines = data.count(b"\n") + 1
    out = np.empty(max(1, len(data) * 3 // 4 + 4), np.uint8)
    offsets = np.empty(max(1, max_lines), np.int64)
    n = lib.b64_decode_lines(data, len(data), out, offsets, max_lines)
    if n < 0:
        raise ValueError(f"malformed base64 at line {-n - 1}")
    buf = out.tobytes()
    ends = offsets[:n].tolist()
    return [buf[a:b] for a, b in zip([0] + ends[:-1], ends)]


def tokenize(text: str) -> List[str]:
    """``data/vocab.simple_tokenize`` in C++: split on the reference's
    separator class, ASCII lowercased in C++, tokens with non-ASCII bytes
    lowercased by ``str.lower`` so Unicode case folds exactly as
    Python's."""
    lib = load()
    data = text.encode("utf-8")
    n = len(data)
    out = np.empty(max(1, n), np.uint8)
    flags = np.empty(max(1, n // 2 + 1), np.uint8)
    out_len = np.zeros(1, np.int64)
    ntok = lib.wiki_tokenize(data, n, out, out.shape[0], flags,
                             flags.shape[0], out_len)
    if ntok < 0:
        raise ValueError("wiki_tokenize: output buffer too small")
    if ntok == 0:
        return []
    toks = out[:int(out_len[0])].tobytes().decode("utf-8").split("\n")
    for i in np.flatnonzero(flags[:ntok]):
        toks[i] = toks[i].lower()
    return toks
