"""Thrift compact-protocol codec (hand-rolled, generic).

The Parquet footer/page metadata is thrift compact protocol
(parquet/src/format.rs is the reference's generated codec; this engine
parses the self-describing wire format generically into {field_id:
value} dicts and picks fields by id, so no codegen is needed).

Compact protocol essentials:
  * varint = LEB128; signed ints are zigzag varints
  * field header byte: (id_delta << 4) | type; delta 0 -> explicit
    zigzag-varint field id follows
  * types: 0 stop, 1 true, 2 false, 3 i8, 4 i16, 5 i32, 6 i64,
    7 double, 8 binary, 9 list, 10 set, 11 map, 12 struct
  * list header: (size << 4) | elem_type; size 15 -> varint size
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CompactReader", "CompactWriter", "ThriftStruct"]

T_STOP, T_TRUE, T_FALSE, T_I8, T_I16, T_I32, T_I64, T_DOUBLE, \
    T_BINARY, T_LIST, T_SET, T_MAP, T_STRUCT = range(13)


class ThriftStruct(dict):
    """Parsed struct: {field_id: python value}; booleans are bools,
    ints are ints, binary is bytes, lists are lists, structs nest."""

    def get_path(self, *ids, default=None):
        cur: Any = self
        for i in ids:
            if not isinstance(cur, dict) or i not in cur:
                return default
            cur = cur[i]
        return cur


class CompactReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_value(self, ttype: int):
        if ttype == T_TRUE:
            return True
        if ttype == T_FALSE:
            return False
        if ttype == T_I8:
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v >= 128 else v
        if ttype in (T_I16, T_I32, T_I64):
            return self.zigzag()
        if ttype == T_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ttype == T_BINARY:
            return self.read_binary()
        if ttype in (T_LIST, T_SET):
            hdr = self.buf[self.pos]
            self.pos += 1
            size = hdr >> 4
            etype = hdr & 0x0F
            if size == 15:
                size = self.varint()
            if etype in (T_TRUE, T_FALSE):
                # list BOOL elements are one byte each (1=true, 2=false)
                out = [self.buf[self.pos + i] == 1 for i in range(size)]
                self.pos += size
                return out
            return [self.read_value(etype) for _ in range(size)]
        if ttype == T_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self.read_value(kt): self.read_value(vt)
                    for _ in range(size)}
        if ttype == T_STRUCT:
            return self.read_struct()
        raise ValueError(f"unknown thrift compact type {ttype}")

    def read_struct(self) -> ThriftStruct:
        out = ThriftStruct()
        fid = 0
        while True:
            hdr = self.buf[self.pos]
            self.pos += 1
            if hdr == T_STOP:
                return out
            delta = hdr >> 4
            ttype = hdr & 0x0F
            if delta == 0:
                fid = (lambda v: (v >> 1) ^ -(v & 1))(self.varint())
            else:
                fid += delta
            out[fid] = self.read_value(ttype)


class CompactWriter:
    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    # spec-driven write: fields = [(id, type, value)] sorted by id;
    # value encoding per type; lists are (elem_type, [values])
    def write_struct_fields(self, fields) -> None:
        last = 0
        for fid, ttype, value in fields:
            if value is None:
                continue
            wire_type = ttype
            if ttype == T_TRUE:          # bool field: type encodes value
                wire_type = T_TRUE if value else T_FALSE
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | wire_type)
            else:
                self.out.append(wire_type)
                self.zigzag(fid)
            last = fid
            if ttype != T_TRUE:
                self.write_value(ttype, value)
        self.out.append(T_STOP)

    def write_value(self, ttype: int, value) -> None:
        if ttype == T_I8:
            self.out.append(value & 0xFF)
        elif ttype in (T_I16, T_I32, T_I64):
            self.zigzag(value)
        elif ttype == T_DOUBLE:
            self.out += struct.pack("<d", value)
        elif ttype == T_BINARY:
            if isinstance(value, str):
                value = value.encode("utf-8")
            self.varint(len(value))
            self.out += value
        elif ttype == T_LIST:
            etype, items = value
            n = len(items)
            if n < 15:
                self.out.append((n << 4) | etype)
            else:
                self.out.append(0xF0 | etype)
                self.varint(n)
            for it in items:
                if etype in (T_TRUE, T_FALSE):
                    self.out.append(1 if it else 2)
                else:
                    self.write_value(etype, it)
        elif ttype == T_STRUCT:
            # value is a pre-encoded fields list
            self.write_struct_fields(value)
        else:
            raise ValueError(f"unsupported thrift write type {ttype}")

    def bytes(self) -> bytes:
        return bytes(self.out)
