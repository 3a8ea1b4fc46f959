"""A proto3 wire codec for the corpus messages (counterpart of
``esrecsys_tpu/data/protos/corpus.proto``: ``TextDocument``,
``TokenStat``, ``SparseDocument``, ``CooccurrenceRow``, ``Contributor``,
``Revision`` and ``Page``), written by hand so that the port needs no
protobuf package.

The field numbers and types are ``corpus.proto``'s, so the bytes are
interchangeable with protobuf's both ways. Encoding follows protobuf's:
fields in number order, default values (0, "", False, empty lists) left
out, repeated scalars packed, a message field written when it is set
(``None`` is unset; an empty message set is written, as protobuf writes
a field it has marked present). Decoding takes packed and unpacked
repeated fields alike, lets a later value of a singular scalar win,
merges a message field that appears twice, and skips fields it does not
know; malformed bytes raise :class:`DecodeError`. Repeated fields are
plain lists: of ints, of str, of messages, or of float32 values as
Python floats (the constructor rounds them, as protobuf's does).
``str(message)`` is protobuf's text format (``tools/codex.py`` prints
it).

The arXiv messages of ``corpus.proto`` are read by no module and are not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5
_UINT64_MAX = (1 << 64) - 1
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


_ONE_BYTE = [bytes((i,)) for i in range(128)]


def encode_varint(value: int) -> bytes:
    if 0 <= value < 128:
        return _ONE_BYTE[value]
    if not 0 <= value <= _UINT64_MAX:
        raise ValueError(f"{value} is not a uint64")
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the varint at ``pos``."""
    if pos < len(data) and data[pos] < 0x80:
        return data[pos], pos + 1
    value = shift = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")
    return value & _UINT64_MAX, pos


def decode_packed_varints(data: bytes) -> List[int]:
    """The varints of a packed field's payload, decoded with numpy."""
    if not data:
        return []
    arr = np.frombuffer(data, np.uint8)
    last = np.flatnonzero(arr < 0x80)
    if last.size == 0 or last[-1] != arr.size - 1:
        raise DecodeError("truncated packed varint")
    starts = np.concatenate([[0], last[:-1] + 1])
    lens = last - starts + 1
    if int(lens.max()) > 10:
        raise DecodeError("varint longer than 10 bytes")
    shift = (np.arange(arr.size) - np.repeat(starts, lens)) * 7
    parts = (arr & 0x7F).astype(np.uint64) << shift.astype(np.uint64)
    return np.bitwise_or.reduceat(parts, starts).tolist()


def _tag(number: int, wire: int) -> bytes:
    return encode_varint(number << 3 | wire)


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == VARINT:
        return decode_varint(data, pos)[1]
    if wire == I64:
        end = pos + 8
    elif wire == I32:
        end = pos + 4
    elif wire == LEN:
        size, pos = decode_varint(data, pos)
        end = pos + size
    else:
        raise DecodeError(f"unsupported wire type {wire}")
    if end > len(data):
        raise DecodeError("truncated field")
    return end


_SCALAR_DEFAULTS = {"string": "", "uint64": 0, "int64": 0, "bool": False}


def _is_message(kind: Any) -> bool:
    """A message field, singular (a class) or repeated (a list of one)."""
    return not isinstance(kind, str)


def _default(kind: Any) -> Any:
    if isinstance(kind, list) or (isinstance(kind, str)
                                  and kind.startswith("repeated")):
        return []
    return None if _is_message(kind) else _SCALAR_DEFAULTS[kind]


class _Message:
    """A message: ``FIELDS`` maps each field number to (name, kind), kind
    one of ``string``, ``uint64``, ``int64``, ``bool``,
    ``repeated_string``, ``repeated_uint64``, ``repeated_float``, or a
    message class (a singular message field) or a one-element list of one
    (a repeated message field)."""

    FIELDS: Dict[int, Tuple[str, Any]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._KINDS = {name: kind for name, kind in cls.FIELDS.values()}
        cls._ORDER = [(name, kind, number) for number, (name, kind)
                      in sorted(cls.FIELDS.items())]

    def __init__(self, **values: Any):
        self._reset()
        for name, value in values.items():
            kind = self._KINDS.get(name)
            if kind is None:
                raise TypeError(f"{type(self).__name__} has no field {name}")
            if kind == "repeated_float":  # stored as float32
                value = np.asarray(value, np.float32).astype(
                    np.float64).tolist()
            elif kind == "repeated_uint64":
                value = [int(v) for v in value]
            elif kind == "repeated_string" or isinstance(kind, list):
                value = list(value)
            elif kind in ("uint64", "int64"):
                value = int(value)
            elif kind == "bool":
                value = bool(value)
            setattr(self, name, value)

    def _reset(self) -> None:
        for name, kind in self._KINDS.items():
            setattr(self, name, _default(kind))

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for name, kind, number in self._ORDER:
            value = getattr(self, name)
            if not value:  # a default, an empty list or an unset message
                continue
            if _is_message(kind):
                for msg in value if isinstance(kind, list) else [value]:
                    raw = msg.SerializeToString()
                    out += _tag(number, LEN) + encode_varint(len(raw)) + raw
            elif kind in ("string", "repeated_string"):
                for text in [value] if kind == "string" else value:
                    raw = text.encode("utf-8")
                    out += _tag(number, LEN) + encode_varint(len(raw)) + raw
            elif kind in ("uint64", "int64", "bool"):
                v = int(value)
                if kind == "int64":
                    if not _INT64_MIN <= v <= _INT64_MAX:
                        raise ValueError(f"{v} is not an int64")
                    v &= _UINT64_MAX
                out += _tag(number, VARINT) + encode_varint(v)
            else:
                if kind == "repeated_uint64":
                    raw = b"".join(encode_varint(int(v)) for v in value)
                else:
                    raw = np.asarray(value, np.float32).astype("<f4").tobytes()
                out += _tag(number, LEN) + encode_varint(len(raw)) + raw
        return bytes(out)

    def ParseFromString(self, data: bytes) -> None:
        """Replace this message's fields with the decoding of ``data``."""
        self._reset()
        self.MergeFromString(data)

    def MergeFromString(self, data: bytes) -> None:
        """Merge the decoding of ``data`` into this message, as protobuf
        does: singular scalars replaced, repeated fields appended, message
        fields merged."""
        data = bytes(data)
        pos = 0
        while pos < len(data):
            key, pos = decode_varint(data, pos)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            field = self.FIELDS.get(number)
            if field is None:
                pos = _skip(data, pos, wire)
                continue
            name, kind = field
            pos = self._merge(data, pos, wire, name, kind)

    def _merge(self, data: bytes, pos: int, wire: int, name: str,
               kind: Any) -> int:
        if wire == VARINT and kind in ("uint64", "int64", "bool",
                                       "repeated_uint64"):
            value, pos = decode_varint(data, pos)
            if kind == "int64" and value > _INT64_MAX:
                value -= 1 << 64
            elif kind == "bool":
                value = value != 0
            if kind == "repeated_uint64":
                getattr(self, name).append(value)
            else:
                setattr(self, name, value)
            return pos
        if kind == "repeated_float" and wire == I32:
            if pos + 4 > len(data):
                raise DecodeError("truncated float")
            getattr(self, name).append(
                float(np.frombuffer(data, "<f4", 1, pos)[0]))
            return pos + 4
        if wire != LEN:
            raise DecodeError(f"field {name}: wire type {wire} for {kind}")
        size, pos = decode_varint(data, pos)
        end = pos + size
        if end > len(data):
            raise DecodeError(f"field {name}: truncated")
        raw = data[pos:end]
        if kind in ("string", "repeated_string"):
            try:
                text = raw.decode("utf-8")
            except UnicodeDecodeError as e:
                raise DecodeError(f"field {name}: invalid UTF-8") from e
            if kind == "string":
                setattr(self, name, text)
            else:
                getattr(self, name).append(text)
        elif kind == "repeated_uint64":
            getattr(self, name).extend(decode_packed_varints(raw))
        elif kind == "repeated_float":
            if size % 4:
                raise DecodeError(f"field {name}: {size} bytes of floats")
            getattr(self, name).extend(
                np.frombuffer(raw, "<f4").astype(np.float64).tolist())
        elif isinstance(kind, list):
            getattr(self, name).append(kind[0].FromString(raw))
        elif not isinstance(kind, str):
            msg = getattr(self, name)
            if msg is None:
                setattr(self, name, kind.FromString(raw))
            else:
                msg.MergeFromString(raw)
        else:
            raise DecodeError(f"field {name}: wire type {wire} for {kind}")
        return end

    @classmethod
    def FromString(cls, data: bytes) -> "_Message":
        msg = cls.__new__(cls)
        msg.ParseFromString(data)
        return msg

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and all(
            getattr(self, n) == getattr(other, n) for n in self._KINDS)

    def __repr__(self) -> str:
        body = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._KINDS)
        return f"{type(self).__name__}({body})"

    def __str__(self) -> str:
        return "".join(self._text(""))

    def _text(self, indent: str):
        """Protobuf's text format, a line a field value."""
        for name, kind, _ in self._ORDER:
            value = getattr(self, name)
            if isinstance(kind, list) or not isinstance(kind, str):
                for msg in (value if isinstance(kind, list)
                            else [] if value is None else [value]):
                    yield f"{indent}{name} {{\n"
                    yield from msg._text(indent + "  ")
                    yield f"{indent}}}\n"
                continue
            values = value if kind.startswith("repeated") else (
                [value] if value else [])
            for v in values:
                yield f"{indent}{name}: {_text_scalar(kind, v)}\n"


_TEXT_ESCAPES = {"\n": "\\n", "\r": "\\r", "\t": "\\t", '"': '\\"',
                 "'": "\\'", "\\": "\\\\"}


def _text_scalar(kind: str, value: Any) -> str:
    if kind.endswith("string"):
        return '"' + "".join(
            _TEXT_ESCAPES.get(c) or (f"\\{ord(c):03o}"
                                     if ord(c) < 0x20 or ord(c) == 0x7F
                                     else c) for c in value) + '"'
    if kind == "bool":
        return "true" if value else "false"
    if kind == "repeated_float":
        return _shortest_float32(value)
    return str(value)


def _shortest_float32(value: float) -> str:
    """A float field as protobuf's text format prints it: 6 significant
    digits where they read back as the same float32, else 9."""
    f = np.float32(value)
    if not np.isfinite(f):
        return "nan" if np.isnan(f) else ("inf" if f > 0 else "-inf")
    text = f"{float(f):.6g}"
    return text if np.float32(float(text)) == f else f"{float(f):.9g}"


class TokenStat(_Message):
    """One vocabulary entry (``corpus.proto`` ``TokenStat``)."""

    FIELDS = {1: ("token", "string"), 2: ("url", "string"),
              3: ("frequency", "uint64"), 4: ("doc_frequency", "uint64"),
              5: ("index", "uint64")}


class CooccurrenceRow(_Message):
    """One (possibly split) row of a sparse co-occurrence matrix
    (``corpus.proto`` ``CooccurrenceRow``)."""

    FIELDS = {1: ("index", "uint64"), 2: ("other_index", "repeated_uint64"),
              3: ("count", "repeated_float")}


class TextDocument(_Message):
    """A tokenized document: the page's URL (``primary``), its links'
    URLs (``secondary``), its body tokens, and ``url``
    (``corpus.proto`` ``TextDocument``)."""

    FIELDS = {1: ("primary", "string"), 2: ("secondary", "repeated_string"),
              3: ("tokens", "repeated_string"), 4: ("url", "string")}


class SparseDocument(_Message):
    """A document after the dictionaries: title and token indices, and
    tf-idf weights (``corpus.proto`` ``SparseDocument``)."""

    FIELDS = {1: ("url", "string"), 2: ("primary_index", "uint64"),
              3: ("secondary_index", "repeated_uint64"),
              4: ("token_index", "repeated_uint64"),
              5: ("token_tfidf", "repeated_float")}


class Contributor(_Message):
    """A revision's author (``corpus.proto`` ``Contributor``)."""

    FIELDS = {1: ("username", "string"), 2: ("id", "int64"),
              3: ("ip", "string")}


class Revision(_Message):
    """One revision of a page (``corpus.proto`` ``Revision``)."""

    FIELDS = {1: ("id", "int64"), 2: ("parentid", "int64"),
              3: ("timestamp", "string"), 4: ("contributor", Contributor),
              5: ("minor", "bool"), 6: ("model", "string"),
              7: ("format", "string"), 8: ("sha1", "string"),
              9: ("text", "string")}


class Page(_Message):
    """A page of a MediaWiki export (``corpus.proto`` ``Page``)."""

    FIELDS = {1: ("title", "string"), 2: ("ns", "int64"), 3: ("id", "int64"),
              4: ("redirect_title", "string"), 5: ("revision", [Revision])}
