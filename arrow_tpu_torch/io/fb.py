"""Minimal FlatBuffers runtime (hand-rolled, no codegen).

The IPC layer (io/ipc.py) hand-writes the Arrow format/{Schema,Message,
File}.fbs tables with this module, replacing the reference's ~11k LoC of
generated code (arrow-ipc/src/gen/).  Only the features those schemas
need are implemented: tables with scalar/offset fields, vectors of
scalars/structs/offsets, strings, unions (as type byte + offset field
pair), and struct vectors.

Wire format recap (flatbuffers internals doc):
  * root: u32 forward offset to the root table at byte 0
  * table: i32 soffset to its vtable (vtable_pos = table_pos - soffset),
    then inline field data; vtable = [u16 vtable_bytes, u16 table_bytes,
    u16 field_offset per slot (0 = absent)]
  * offset fields: u32, target_pos = field_pos + value
  * vector: u32 length then elements; string: u32 length + bytes + NUL
  * all scalars little-endian, aligned to their size

The Builder constructs back-to-front by prepending, tracking positions
as distances from the buffer end; at finish the total size is padded to
the coarsest alignment used so end-relative alignment implies
start-relative alignment (the standard flatbuffers builder trick).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

__all__ = ["Builder", "Table"]

_SCALAR_FMT = {
    "bool": ("<b", 1), "i8": ("<b", 1), "u8": ("<B", 1),
    "i16": ("<h", 2), "u16": ("<H", 2),
    "i32": ("<i", 4), "u32": ("<I", 4),
    "i64": ("<q", 8), "u64": ("<Q", 8),
    "f32": ("<f", 4), "f64": ("<d", 8),
}


class Builder:
    def __init__(self):
        self._data = bytearray()    # final buffer tail, in final order
        self._minalign = 1
        self._vtables = {}          # bytes -> end-offset of the vtable
        # current table under construction: list of
        # (slot, kind, value, size) where kind in {scalar fmt, "off"}
        self._fields: Optional[list] = None

    # -- low level ------------------------------------------------------------

    def _pos(self) -> int:
        return len(self._data)

    def _prepend(self, b: bytes) -> int:
        self._data[:0] = b
        return len(self._data)

    def _align(self, n: int, extra: int = 0) -> None:
        """Pad so that after prepending `extra` more bytes the position is
        n-aligned (end-relative)."""
        if n > self._minalign:
            self._minalign = n
        pad = -(len(self._data) + extra) % n
        if pad:
            self._data[:0] = bytes(pad)

    # -- leaf objects ----------------------------------------------------------

    def string(self, s) -> int:
        if isinstance(s, str):
            s = s.encode("utf-8")
        # pad FIRST (pad lands after the NUL in final order) so the u32
        # length prefix is 4-aligned and the content follows contiguously
        self._align(4, len(s) + 1 + 4)
        self._prepend(s + b"\x00")
        return self._prepend(struct.pack("<I", len(s)))

    def vector_scalar(self, kind: str, values: Sequence) -> int:
        fmt, size = _SCALAR_FMT[kind]
        body = b"".join(struct.pack(fmt, v) for v in values)
        # element start must be esize-aligned; the u32 prefix sits right
        # before it (4 | esize alignment covers both)
        self._align(max(size, 4), len(body))
        self._prepend(body)
        return self._prepend(struct.pack("<I", len(values)))

    def vector_bytes(self, raw: bytes, n_elems: int, elem_align: int) -> int:
        """Vector of inline structs given as pre-packed bytes."""
        self._align(max(elem_align, 4), len(raw))
        self._prepend(raw)
        return self._prepend(struct.pack("<I", n_elems))

    def vector_offsets(self, offsets: Sequence[int]) -> int:
        """Vector of references to already-written tables/strings."""
        n = len(offsets)
        total = 4 * n
        self._align(4, total)
        body = bytearray()
        # end-offset of the vector data start once body+prefix prepended
        start = len(self._data) + total
        for i, tgt in enumerate(offsets):
            elem_pos = start - 4 * i   # end-offset of element i slot
            body += struct.pack("<I", elem_pos - tgt)
        self._prepend(bytes(body))
        return self._prepend(struct.pack("<I", n))

    # -- tables ----------------------------------------------------------------

    def start_table(self) -> None:
        assert self._fields is None, "nested start_table"
        self._fields = []

    def add_scalar(self, slot: int, kind: str, value, default=0) -> None:
        if value is None or value == default:
            return
        fmt, size = _SCALAR_FMT[kind]
        self._fields.append((slot, fmt, value, size))

    def add_offset(self, slot: int, off: Optional[int]) -> None:
        if off is None:
            return
        self._fields.append((slot, "off", off, 4))

    def add_struct_inline(self, slot: int, raw: bytes, align: int) -> None:
        """A struct field stored inline in the table."""
        self._fields.append((slot, "struct", raw, align))

    def end_table(self) -> int:
        fields = self._fields
        self._fields = None
        if not fields:
            fields = []
        # lay out inline data after the 4-byte soffset, biggest first for
        # tight packing (order within the table is unconstrained)
        def fsize(f):
            return len(f[2]) if f[1] == "struct" else f[3]
        fields_sorted = sorted(fields, key=fsize, reverse=True)
        layout = []                    # (slot, fmt, value, offset_in_table)
        off = 4
        max_align = 4
        for slot, fmt, value, size in fields_sorted:
            if fmt == "struct":
                a = size
                sz = len(value)
            else:
                a = sz = size
            max_align = max(max_align, a)
            off += -off % a
            layout.append((slot, fmt, value, off))
            off += sz
        table_size = off
        nslots = 1 + max(s for s, *_ in layout) if layout else 0
        # vtable image
        vt = bytearray(struct.pack("<HH", 4 + 2 * nslots, table_size))
        vt += bytes(2 * nslots)
        for slot, _, _, foff in layout:
            struct.pack_into("<H", vt, 4 + 2 * slot, foff)
        vt = bytes(vt)
        # table image needs its final position to encode offset fields:
        # p_table = len(data) + pad + table_size
        self._align(max_align, table_size)
        p_table = len(self._data) + table_size
        img = bytearray(table_size)
        for slot, fmt, value, foff in layout:
            if fmt == "off":
                # forward ref: value_is(end-offset of target)
                struct.pack_into("<I", img, foff,
                                 (p_table - foff) - value)
            elif fmt == "struct":
                img[foff:foff + len(value)] = value
            else:
                struct.pack_into(fmt, img, foff, value)
        # prepend table image with placeholder soffset, then (if not
        # dedup-reusable) the vtable, then patch soffset (signed: works
        # for a vtable on either side of the table)
        vt_pos = self._vtables.get(vt)
        self._prepend(bytes(img))
        p_table_actual = len(self._data)
        assert p_table_actual == p_table, (p_table_actual, p_table)
        if vt_pos is None:
            self._align(2)
            vt_pos = self._prepend(vt)
            self._vtables[vt] = vt_pos
        # soffset (i32) = abs_table - abs_vt = p_vt - p_table
        soff = vt_pos - p_table
        idx = len(self._data) - p_table   # abs address of table start
        struct.pack_into("<i", self._data, idx, soff)
        return p_table

    # -- finish ----------------------------------------------------------------

    def finish(self, root: int) -> bytes:
        self._align(max(self._minalign, 4), 4)
        p = self._prepend(struct.pack("<I", 0))
        struct.pack_into("<I", self._data, 0, p - root)
        # pad the END so total length is a multiple of minalign: every
        # object position is end-aligned, so an aligned total makes all
        # absolute addresses start-aligned too (relative offsets are
        # unaffected by trailing pad)
        pad = -len(self._data) % self._minalign
        if pad:
            self._data.extend(bytes(pad))
        return bytes(self._data)


class Table:
    """Read-side accessor for a flatbuffer table at an absolute position."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    @classmethod
    def root(cls, buf: bytes, base: int = 0) -> "Table":
        off = struct.unpack_from("<I", buf, base)[0]
        return cls(buf, base + off)

    def _field(self, slot: int) -> Optional[int]:
        soff = struct.unpack_from("<i", self.buf, self.pos)[0]
        vt = self.pos - soff
        vt_size = struct.unpack_from("<H", self.buf, vt)[0]
        o = 4 + 2 * slot
        if o + 2 > vt_size:
            return None
        foff = struct.unpack_from("<H", self.buf, vt + o)[0]
        if foff == 0:
            return None
        return self.pos + foff

    def scalar(self, slot: int, kind: str, default=0):
        p = self._field(slot)
        if p is None:
            return default
        fmt, _ = _SCALAR_FMT[kind]
        v = struct.unpack_from(fmt, self.buf, p)[0]
        return bool(v) if kind == "bool" else v

    def table(self, slot: int) -> Optional["Table"]:
        p = self._field(slot)
        if p is None:
            return None
        return Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0])

    def string(self, slot: int) -> Optional[str]:
        p = self._field(slot)
        if p is None:
            return None
        sp = p + struct.unpack_from("<I", self.buf, p)[0]
        n = struct.unpack_from("<I", self.buf, sp)[0]
        return self.buf[sp + 4: sp + 4 + n].decode("utf-8")

    def _vec(self, slot: int) -> Optional[Tuple[int, int]]:
        p = self._field(slot)
        if p is None:
            return None
        vp = p + struct.unpack_from("<I", self.buf, p)[0]
        n = struct.unpack_from("<I", self.buf, vp)[0]
        return vp + 4, n

    def vector_len(self, slot: int) -> int:
        v = self._vec(slot)
        return 0 if v is None else v[1]

    def vector_scalars(self, slot: int, kind: str) -> List:
        v = self._vec(slot)
        if v is None:
            return []
        start, n = v
        fmt, size = _SCALAR_FMT[kind]
        return [struct.unpack_from(fmt, self.buf, start + i * size)[0]
                for i in range(n)]

    def vector_structs(self, slot: int, fmt: str, size: int) -> List[Tuple]:
        v = self._vec(slot)
        if v is None:
            return []
        start, n = v
        return [struct.unpack_from(fmt, self.buf, start + i * size)
                for i in range(n)]

    def vector_tables(self, slot: int) -> List["Table"]:
        v = self._vec(slot)
        if v is None:
            return []
        start, n = v
        out = []
        for i in range(n):
            p = start + 4 * i
            out.append(Table(self.buf,
                             p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def vector_strings(self, slot: int) -> List[str]:
        v = self._vec(slot)
        if v is None:
            return []
        start, n = v
        out = []
        for i in range(n):
            p = start + 4 * i
            sp = p + struct.unpack_from("<I", self.buf, p)[0]
            ln = struct.unpack_from("<I", self.buf, sp)[0]
            out.append(self.buf[sp + 4: sp + 4 + ln].decode("utf-8"))
        return out
