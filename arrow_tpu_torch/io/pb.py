"""Minimal protobuf wire codec (hand-rolled, no generated code);
counterpart of arrow_tpu/io/pb.py.

Shared by the Flight RPC layer (io/flight.py; format/Flight.proto) and
the FlightSQL command layer (io/flightsql.py; format/FlightSql.proto).
The wire format is varint keys ((tag << 3) | wire_type) with
length-delimited (2), varint (0), 64-bit (1) and 32-bit (5) fields.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from ..errors import ArrowInvalid

__all__ = ["varint", "read_varint", "field", "varint_field",
           "parse_fields", "first", "first_bytes", "first_str"]


def varint(n: int) -> bytes:
    if n < 0:
        n &= (1 << 64) - 1         # two's-complement int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def field(tag: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return varint((tag << 3) | 2) + varint(len(payload)) + payload


def varint_field(tag: int, value: int) -> bytes:
    """Varint field (wire type 0); omitted when zero."""
    if value == 0:
        return b""
    return varint(tag << 3) + varint(value)


def parse_fields(buf: bytes) -> Dict[int, List]:
    """Parse a message into {field_tag: [values]}; length-delimited
    fields come back as bytes, varints as int."""
    out: Dict[int, List] = {}
    i = 0
    while i < len(buf):
        key, i = read_varint(buf, i)
        tag, wt = key >> 3, key & 7
        if wt == 2:
            ln, i = read_varint(buf, i)
            if i + ln > len(buf):
                raise ArrowInvalid(
                    f"truncated protobuf: field {tag} declares {ln} "
                    f"bytes, {len(buf) - i} remain")
            val = buf[i:i + ln]
            i += ln
        elif wt == 0:
            val, i = read_varint(buf, i)
        elif wt == 1:
            val = struct.unpack("<q", buf[i:i + 8])[0]
            i += 8
        elif wt == 5:
            val = struct.unpack("<i", buf[i:i + 4])[0]
            i += 4
        else:
            raise ArrowInvalid(f"unsupported wire type {wt}")
        out.setdefault(tag, []).append(val)
    return out


def first(fields: Dict[int, List], tag: int, default=None):
    vals = fields.get(tag)
    return vals[0] if vals else default


def first_bytes(fields: Dict[int, List], tag: int) -> bytes:
    return first(fields, tag, b"")


def first_str(fields: Dict[int, List], tag: int) -> str:
    return first_bytes(fields, tag).decode("utf-8")
