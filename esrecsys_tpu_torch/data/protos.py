"""A proto3 wire codec for the corpus messages the GloVe trainer reads
(counterpart of ``esrecsys_tpu/data/protos/corpus.proto``'s ``TokenStat``
and ``CooccurrenceRow``), written by hand so that the port needs no
protobuf package.

The field numbers and types are ``corpus.proto``'s, so the bytes are
interchangeable with protobuf's both ways. Encoding follows protobuf's:
fields in number order, default values (0, "", empty lists) left out,
repeated scalars packed. Decoding takes packed and unpacked repeated
fields alike, lets a later value of a singular field win, and skips
fields it does not know; malformed bytes raise :class:`DecodeError`.
Repeated fields are plain lists: ``other_index`` of ints, ``count`` of
float32 values as Python floats (the constructor rounds them, as
protobuf's does).

The corpus's other messages (``TextDocument``, ``SparseDocument``,
``Page`` and the rest) come with the Wikipedia ETL.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# wire types
VARINT, I64, LEN, I32 = 0, 1, 2, 5
_UINT64_MAX = (1 << 64) - 1


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


class _Message:
    """A message of scalar fields: ``FIELDS`` maps each field number to
    (name, kind), kind one of ``string``, ``uint64``, ``repeated_uint64``
    and ``repeated_float``."""

    FIELDS: Dict[int, Tuple[str, str]] = {}

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
            setattr(self, name, value)

    def _reset(self) -> None:
        for name, kind in self._KINDS.items():
            setattr(self, name, "" if kind == "string" else
                    0 if kind == "uint64" else [])

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for name, kind, number in self._ORDER:
            value = getattr(self, name)
            if not value:
                continue
            if kind == "string":
                raw = value.encode("utf-8")
                out += _tag(number, LEN) + encode_varint(len(raw)) + raw
            elif kind == "uint64":
                out += _tag(number, VARINT) + encode_varint(int(value))
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
               kind: str) -> int:
        if kind == "uint64" and wire == VARINT:
            value, pos = decode_varint(data, pos)
            setattr(self, name, value)
            return pos
        if kind == "repeated_uint64" and wire == VARINT:
            value, pos = decode_varint(data, pos)
            getattr(self, name).append(value)
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
        if kind == "string":
            try:
                setattr(self, name, raw.decode("utf-8"))
            except UnicodeDecodeError as e:
                raise DecodeError(f"field {name}: invalid UTF-8") from e
        elif kind == "repeated_uint64":
            getattr(self, name).extend(decode_packed_varints(raw))
        elif kind == "repeated_float":
            if size % 4:
                raise DecodeError(f"field {name}: {size} bytes of floats")
            getattr(self, name).extend(
                np.frombuffer(raw, "<f4").astype(np.float64).tolist())
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
