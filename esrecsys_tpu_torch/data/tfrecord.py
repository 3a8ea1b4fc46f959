"""TFRecord files of ``tf.train.Example`` records, in the standard
library only.

The JAX package writes its playlist records with ``tf.io.TFRecordWriter``
and ``tf.train.Example`` and reads them with ``tf.data``. This module
reads and writes the same bytes without TensorFlow or protobuf:

* **Framing.** Each record is ``uint64 length``, ``uint32
  masked_crc32c(length bytes)``, the data, ``uint32
  masked_crc32c(data)``, all little-endian. The CRC is CRC-32C
  (Castagnoli, reflected polynomial 0x82F63B78), not ``zlib.crc32``;
  the mask is ``((crc >> 15) | (crc << 17)) + 0xA282EAD8`` mod 2**32.
  The reader checks both CRCs, as TensorFlow does.
* **Examples.** ``Example{features=1: Features{feature=1: map<string,
  Feature>}}`` with ``Feature{int64_list=3: Int64List{value=1}}``. The
  encoder writes packed values (as TensorFlow does); the decoder takes
  packed and unpacked repeated fields and skips fields it does not know.
  Only ``Int64List`` features are supported: a bytes or float feature
  raises.

The CRC runs in pure Python (one table lookup a byte), so reading and
writing cost the host a few MB/s; the packed ``.npz`` shards
(``data/pipelines.pack_playlists``) are what feeds a card at scale.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Mapping, Sequence

_CASTAGNOLI = 0x82F63B78
_MASK_DELTA = 0xA282EAD8
_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def _crc_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CASTAGNOLI if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc``."""
    table = _TABLE
    c = crc ^ _U32
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ _U32


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & _U32


# ------------------------------------------------------------- framing

def write_record(f, data: bytes) -> None:
    """Append one framed record to the binary file ``f``."""
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc32c(data)))


def read_records(path: str) -> Iterator[bytes]:
    """The records of one TFRecord file, both CRCs checked. A truncated
    or corrupted file raises ``ValueError``."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) != 12:
                raise ValueError(f"{path}: truncated record header")
            length, want = struct.unpack("<QI", header)
            if masked_crc32c(header[:8]) != want:
                raise ValueError(f"{path}: corrupted record length")
            data = f.read(length)
            footer = f.read(4)
            if len(data) != length or len(footer) != 4:
                raise ValueError(f"{path}: truncated record")
            if masked_crc32c(data) != struct.unpack("<I", footer)[0]:
                raise ValueError(f"{path}: corrupted record data")
            yield data


class TFRecordWriter:
    """``with TFRecordWriter(path) as w: w.write(bytes)``."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        write_record(self._f, data)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------- protobuf wire format

def _varint(n: int) -> bytes:
    n &= _U64  # negative int64: ten bytes of two's complement
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: Mapping[str, Sequence[int]]) -> bytes:
    """Serialize ``{name: int64 values}`` as a ``tf.train.Example``."""
    entries = []
    for name, values in features.items():
        packed = b"".join(_varint(int(v)) for v in values)
        int64_list = _field(1, packed) if packed else b""
        feature = _field(3, int64_list)
        entries.append(_field(1, _field(1, name.encode()) + _field(2, feature)))
    return _field(1, b"".join(entries))


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _fields(buf: bytes):
    """(field number, wire type, value) of one message; the value of a
    length-delimited field is its bytes, of a varint its integer."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if pos > end:
            raise ValueError("truncated field")
        yield number, wire, value


def _signed(n: int) -> int:
    n &= _U64
    return n - (1 << 64) if n >> 63 else n


def _int64_values(int64_list: bytes) -> List[int]:
    values: List[int] = []
    for number, wire, value in _fields(int64_list):
        if number != 1:
            continue
        if wire == 0:  # unpacked: one value per field
            values.append(_signed(value))
        elif wire == 2:  # packed: varints back to back
            pos = 0
            while pos < len(value):
                v, pos = _read_varint(value, pos)
                values.append(_signed(v))
        else:
            raise ValueError(f"Int64List value of wire type {wire}")
    return values


def decode_example(data: bytes) -> Dict[str, List[int]]:
    """Parse a serialized ``tf.train.Example`` of ``Int64List``
    features into ``{name: values}``."""
    out: Dict[str, List[int]] = {}
    for number, wire, features in _fields(data):
        if number != 1 or wire != 2:
            continue
        for fnum, fwire, entry in _fields(features):
            if fnum != 1 or fwire != 2:
                continue
            name, feature = "", b""
            for enum, ewire, value in _fields(entry):
                if enum == 1 and ewire == 2:
                    name = value.decode()
                elif enum == 2 and ewire == 2:
                    feature = value
            values: List[int] = []
            for knum, kwire, kind in _fields(feature):
                if knum == 3 and kwire == 2:
                    values = _int64_values(kind)
                elif knum in (1, 2):
                    raise ValueError(
                        f"feature {name!r} is not an Int64List")
            out[name] = values  # a repeated map key: the last one wins
    return out
