"""Arrow IPC stream/file interchange — native implementation
(counterpart of arrow_tpu/io/ipc.py).

The engine's wire/spill/checkpoint format IS the Arrow IPC format
(SURVEY.md §5 checkpoint/resume).  Round 1 delegated encode/decode to
pyarrow; this is the round-2 native rewrite: flatbuffers metadata
(io/ipc_format.py over io/fb.py), buffer-level body encode/decode for
every column layout, dictionary batches with replacement/delta handling,
ZSTD/LZ4 buffer compression, the random-access File format with footer,
and a push-based StreamDecoder.

Reference behaviors re-designed (not ported):
  stream/file writer   arrow-ipc/src/writer.rs:934,1186 (FileWriter,
                       StreamWriter), encoded_batch writer.rs:477,
                       encode_dictionaries writer.rs:417
  stream/file reader   arrow-ipc/src/reader.rs:1153,1330, read_record_batch
                       reader.rs:638, FileDecoder reader.rs:836
  push decoder         arrow-ipc/src/reader/stream.rs:35
  compression framing  arrow-ipc/src/compression.rs:27

pyarrow appears NOWHERE in this path; tests use it as the byte-level
oracle only.  Writers take columns on any device and copy each buffer
to the host once (io/ipc_format.py); every reader names the `device`
its columns are built on.
"""

from __future__ import annotations

import io as _io
import struct
from typing import Dict, List, Optional, Tuple

from ..core.column import (Column, DictionaryColumn, ListColumn,
                           StructColumn)
from ..config import DeviceLike, resolve_device
from ..core.table import Table
from ..errors import ArrowInvalid
from .. import dtypes as dt
from . import ipc_format as fmt

__all__ = ["write_file", "read_file", "write_stream", "read_stream",
           "FileWriter", "StreamWriter", "StreamDecoder",
           "serialize_table", "deserialize_table"]

_MAGIC = b"ARROW1"
_CONT = 0xFFFFFFFF

_CODECS = {None: None, "zstd": fmt.COMPRESS_ZSTD,
           "lz4": fmt.COMPRESS_LZ4}


def _frame(meta: bytes) -> bytes:
    """Encapsulated message framing: 0xFFFFFFFF continuation + i32 length
    + metadata, padded to 8 bytes."""
    pad = -(len(meta)) % 8
    meta = meta + bytes(pad)
    return struct.pack("<Ii", _CONT, len(meta)) + meta


def _collect_dict_columns(col: Column, out: List[Column]) -> None:
    """Dictionary columns in schema preorder (matches the dictionary-id
    assignment order of ipc_format._write_schema_with_seq_ids)."""
    from ..core.nested import (FixedSizeListColumn, MapColumn,
                               RunEndColumn, UnionColumn, ListViewColumn)
    if isinstance(col, DictionaryColumn):
        out.append(col)
        # nested dictionaries: the values may themselves hold dictionary
        # columns with their own ids (preorder, matching
        # _write_schema_with_seq_ids)
        _collect_dict_columns(col.values, out)
        return
    if isinstance(col, (ListColumn, ListViewColumn, FixedSizeListColumn)):
        _collect_dict_columns(col.child, out)
    elif isinstance(col, MapColumn):
        _collect_dict_columns(col.entries, out)
    elif isinstance(col, StructColumn):
        for c in col.children:
            _collect_dict_columns(c, out)
    elif isinstance(col, UnionColumn):
        for c in col.children:
            _collect_dict_columns(c, out)
    elif isinstance(col, RunEndColumn):
        _collect_dict_columns(col.values, out)


def _table_dict_columns(table: Table) -> List[Column]:
    out: List[Column] = []
    for col in table.columns:
        _collect_dict_columns(col, out)
    return out


class StreamWriter:
    """IPC stream writer (writer.rs:1186): schema message up front, then
    dictionary batches as needed, then record batches."""

    def __init__(self, sink, schema_table, compression: Optional[str] = None,
                 *, _file_mode: bool = False):
        self._sink = sink
        # Writer offsets (self._pos, block offsets) count from 0, but the
        # sink may already hold data (appending to a non-empty BytesIO):
        # absolute seeks must add this base or the pre-extend would
        # overwrite the existing prefix.
        try:
            self._base = sink.tell()
        except Exception:              # noqa: BLE001 — non-seekable sink
            self._base = 0
        self._codec = _CODECS[compression]
        schema = schema_table.schema if isinstance(schema_table, Table) \
            else schema_table
        self._schema = schema
        self._file_mode = _file_mode
        self._dict_blocks: List[Tuple[int, int, int]] = []
        self._batch_blocks: List[Tuple[int, int, int]] = []
        # dict id -> the values Column last written for it.  Holding the
        # object (not id()) both pins it against id-recycling and gives
        # an exact identity compare for replacement detection.
        self._written_dicts: Dict[int, Column] = {}
        self._pos = 0
        if _file_mode:
            self._emit(_MAGIC + b"\x00\x00")
        self._emit(_frame(fmt.write_schema_message(schema)))

    def _emit(self, b: bytes) -> None:
        self._sink.write(b)
        self._pos += len(b)

    def _emit_message(self, meta: bytes, body, blocks: Optional[list]
                      ) -> None:
        """body: bytes, or a chunk list streamed to the sink without
        assembly (one fewer full-body memcpy)."""
        framed = _frame(meta)
        chunks = body if isinstance(body, list) else [body]
        blen = sum(len(c) for c in chunks)
        if blocks is not None:
            blocks.append((self._pos, len(framed), blen))
        # pre-extend BytesIO sinks ONCE per message: growing through a
        # dozen multi-MB chunk writes re-copies the accumulated stream
        # on every realloc (measured 1.4 GB/s vs the host's 4.5 GB/s
        # copy bandwidth); one seek-extend makes the chunk writes plain
        # in-place copies
        import io as _io
        total = len(framed) + blen
        if isinstance(self._sink, _io.BytesIO) and total > (1 << 20):
            self._sink.seek(self._base + self._pos + total - 1)
            self._sink.write(b"\x00")
            self._sink.seek(self._base + self._pos)
        self._emit(framed)
        for c in chunks:
            self._emit(c)

    def write(self, table: Table) -> None:
        if tuple(f.dtype for f in table.schema.fields) != \
                tuple(f.dtype for f in self._schema.fields):
            raise ArrowInvalid("batch schema does not match stream schema")
        # innermost dictionaries first (reversed preorder): a dictionary
        # batch whose values reference an inner dictionary needs that
        # inner batch decoded before it
        for dict_id, col in reversed(
                list(enumerate(_table_dict_columns(table)))):
            values = col.values
            prev = self._written_dicts.get(dict_id)
            if prev is values:     # identity; the held ref pins the id
                continue
            if prev is not None and self._file_mode:
                raise ArrowInvalid(
                    "IPC file format does not support dictionary "
                    "replacement; write a stream instead")
            meta, body = fmt.encode_dictionary_batch(
                dict_id, values, self._codec)
            self._emit_message(meta, body, self._dict_blocks)
            self._written_dicts[dict_id] = values
        meta, chunks = fmt.encode_record_batch_chunks(table, self._codec)
        self._emit_message(meta, chunks, self._batch_blocks)

    def close(self) -> None:
        self._emit(struct.pack("<Ii", _CONT, 0))    # EOS
        if self._file_mode:
            self._emit_footer()

    def _emit_footer(self) -> None:
        from .fb import Builder
        b = Builder()
        sch_off = fmt._write_schema_with_seq_ids(b, self._schema)

        def blocks_vec(blocks):
            raw = b"".join(
                struct.pack("<qiiq", off, mlen, 0, blen)[:24]
                for off, mlen, blen in blocks)
            # Block struct: i64 offset, i32 metaDataLength, 4B pad,
            # i64 bodyLength -> 24 bytes, align 8
            return b.vector_bytes(raw, len(blocks), 8)

        dicts_off = blocks_vec(self._dict_blocks)
        recs_off = blocks_vec(self._batch_blocks)
        b.start_table()
        b.add_scalar(0, "i16", fmt.MetadataV5)
        b.add_offset(1, sch_off)
        b.add_offset(2, dicts_off)
        b.add_offset(3, recs_off)
        footer = b.finish(b.end_table())
        self._emit(footer)
        self._emit(struct.pack("<i", len(footer)))
        self._emit(_MAGIC)


class FileWriter(StreamWriter):
    """IPC file format (writer.rs:934): magic + stream + Footer."""

    def __init__(self, sink, schema_table, compression: Optional[str] = None):
        super().__init__(sink, schema_table, compression, _file_mode=True)


# ---- push-based stream decoding ---------------------------------------------

class StreamDecoder:
    """Incremental IPC stream decoder (reader/stream.rs:35): feed bytes in
    arbitrary chunk sizes; completed batches pop out of next_batch(), on
    `device`."""

    def __init__(self, device: DeviceLike):
        self._dev = resolve_device(device)
        self._buf = bytearray()
        self._pos = 0
        self._schema: Optional[dt.Schema] = None
        self._dict_fields: Dict[int, dt.Field] = {}
        self._dict_ids: List[Tuple[int, dt.Field]] = []
        self._dict_id_of: Dict[int, int] = {}
        self._dictionaries: Dict[int, Column] = {}
        self._batches: List[Table] = []
        self._eos = False

    @property
    def schema(self) -> Optional[dt.Schema]:
        return self._schema

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)
        self._drain()

    def consume_buffer(self, data) -> None:
        """Whole-buffer decode (read_stream path): messages parse IN
        PLACE over memoryview slices — zero body copies and no buffer
        shifting (the incremental path must copy because its bytearray
        mutates under later feeds)."""
        mv = memoryview(data)
        n = len(data)
        pos = 0
        while n - pos >= 8:
            cont, length = struct.unpack_from("<Ii", data, pos)
            if cont != _CONT:
                length = struct.unpack_from("<i", data, pos)[0]
                header = 4
            else:
                header = 8
            if length == 0:
                self._eos = True
                pos += header
                continue
            if n - pos < header + length:
                break
            meta = bytes(mv[pos + header:pos + header + length])
            _, msg, body_len = fmt.parse_message(meta)
            total = header + length + body_len
            if n - pos < total:
                break
            self._consume(meta, mv[pos + header + length:pos + total])
            pos += total
        if n - pos:
            tail = bytes(mv[pos:])
            if tail.strip(b"\x00"):
                # an incomplete trailing message = truncated stream;
                # arrow-rs StreamReader errors here too (reader.rs:1330)
                raise ArrowInvalid(
                    f"truncated IPC stream: {n - pos} trailing bytes do "
                    "not form a complete message")
            self._eos = True       # legacy 4-byte zero EOS / padding

    def _drain(self) -> None:
        while True:
            got = self._try_consume()
            if not got:
                return

    def _try_consume(self) -> bool:
        b = self._buf
        p = self._pos
        if len(b) - p < 8:
            return False
        cont, length = struct.unpack_from("<Ii", b, p)
        if cont != _CONT:
            # legacy pre-0.15 framing: bare i32 length
            length = struct.unpack_from("<i", b, p)[0]
            header = 4
        else:
            header = 8
        if length == 0:
            self._eos = True
            self._pos = p + header
            self._compact()
            return len(b) - self._pos >= 8
        if len(b) - p < header + length:
            return False
        meta = bytes(b[p + header:p + header + length])
        _, msg, body_len = fmt.parse_message(meta)
        total = header + length + body_len
        if len(b) - p < total:
            return False
        body = bytes(b[p + header + length:p + total])
        self._pos = p + total
        self._compact()
        self._consume(meta, body)
        return True

    def _compact(self) -> None:
        # drop consumed bytes only when they dominate the buffer —
        # a del-per-message shifts the whole tail (O(n^2) over a
        # stream)
        if self._pos > (1 << 20) and self._pos * 2 > len(self._buf):
            del self._buf[:self._pos]
            self._pos = 0

    def _consume(self, meta: bytes, body: bytes) -> None:
        tag, msg, _ = fmt.parse_message(meta)
        if tag == fmt.H_SCHEMA:
            schema, dict_ids = fmt.read_schema(meta)
            self._schema = schema
            self._dict_ids = dict_ids
            self._dict_fields = {i: f for i, f in dict_ids}
            self._dict_id_of = fmt.walk_dict_ids(dict_ids)
            return
        if tag == fmt.H_DICTIONARY_BATCH:
            fmt.decode_dictionary_batch(meta, body, self._dict_fields,
                                        self._dictionaries,
                                        self._dict_ids, device=self._dev)
            return
        if tag == fmt.H_RECORD_BATCH:
            if self._schema is None:
                raise ArrowInvalid("record batch before schema")
            self._batches.append(fmt.decode_record_batch(
                self._schema, meta, body, self._dictionaries,
                self._dict_id_of, self._dev))
            return
        raise ArrowInvalid(f"unsupported IPC message tag {tag}")

    def next_batch(self) -> Optional[Table]:
        if self._batches:
            return self._batches.pop(0)
        return None


# ---- whole-file / whole-stream convenience ----------------------------------

def write_stream(sink, tables, compression: Optional[str] = None) -> None:
    tables = [tables] if isinstance(tables, Table) else list(tables)
    if not tables:
        raise ArrowInvalid("write_stream of zero batches")
    presized = None
    if isinstance(sink, _io.BytesIO) and compression is None:
        # pre-size the BytesIO to the payload estimate: growth-by-
        # doubling re-copies the whole stream ~log(n) times and was the
        # single hottest line of a 2M-row write (BytesIO.write 80% of
        # wall time under cProfile)
        from ..core.pool import table_memory_size
        est = sum(table_memory_size(t) for t in tables) + 64 * 1024
        presized = sink.tell()
        sink.seek(presized + est - 1)
        sink.write(b"\0")
        sink.seek(presized)
    w = StreamWriter(sink, tables[0], compression)
    for t in tables:
        w.write(t)
    w.close()
    if presized is not None:
        sink.truncate(sink.tell())


def read_stream(source, device: DeviceLike) -> List[Table]:
    """Every batch of an IPC stream (bytes or a readable), on `device`."""
    from ..errors import malformed_guard
    resolve_device(device)
    data = source.read() if hasattr(source, "read") else bytes(source)
    with malformed_guard("IPC stream"):
        dec = StreamDecoder(device)
        dec.consume_buffer(data)
        out = []
        while True:
            t = dec.next_batch()
            if t is None:
                break
            out.append(t)
        return out


def write_file(path_or_sink, tables, compression: Optional[str] = None
               ) -> None:
    """IPC file format w/ footer (arrow-ipc/src/writer.rs:934)."""
    tables = [tables] if isinstance(tables, Table) else list(tables)
    if not tables:
        raise ArrowInvalid("write_file of zero batches")
    own = isinstance(path_or_sink, str)
    sink = open(path_or_sink, "wb") if own else path_or_sink
    try:
        w = FileWriter(sink, tables[0], compression)
        for t in tables:
            w.write(t)
        w.close()
    finally:
        if own:
            sink.close()


def _read_footer(data: bytes):
    """-> (schema, dict_ids, dict_blocks, batch_blocks)."""
    if data[:6] != _MAGIC or data[-6:] != _MAGIC:
        raise ArrowInvalid("not an Arrow IPC file (bad magic)")
    (flen,) = struct.unpack_from("<i", data, len(data) - 10)
    footer = data[len(data) - 10 - flen: len(data) - 10]
    from .fb import Table as FTable
    ft = FTable.root(footer)
    sch = ft.table(1)
    dict_ids: List[Tuple[int, dt.Field]] = []
    fields = tuple(fmt._read_field(f, dict_ids)
                   for f in sch.vector_tables(1))
    md = sch.vector_tables(2)
    metadata = tuple((kv.string(0) or "", kv.string(1) or "")
                     for kv in md) if md else ()
    schema = dt.Schema(fields, metadata)

    def blocks(slot):
        return ft.vector_structs(slot, "<qi4xq", 24)

    return schema, dict_ids, blocks(2), blocks(3)


class FileReader:
    """Random-access IPC file reader (reader.rs:1153 FileReader /
    reader.rs:836 FileDecoder): batches on `device`."""

    def __init__(self, data: bytes, device: DeviceLike):
        self._dev = resolve_device(device)
        self._data = data
        (self.schema, dict_ids, dict_blocks,
         batch_blocks) = _read_footer(data)
        self._dict_fields = {i: f for i, f in dict_ids}
        self._dict_id_of = fmt.walk_dict_ids(dict_ids)
        self._dictionaries: Dict[int, Column] = {}
        self._batch_blocks = batch_blocks
        for off, mlen, blen in dict_blocks:
            meta, body = self._message_at(off, mlen, blen)
            fmt.decode_dictionary_batch(meta, body, self._dict_fields,
                                        self._dictionaries, dict_ids,
                                        device=self._dev)

    def _message_at(self, off: int, mlen: int, blen: int
                    ) -> Tuple[bytes, bytes]:
        raw = self._data[off: off + mlen]
        cont, length = struct.unpack_from("<Ii", raw, 0)
        hdr = 8 if cont == _CONT else 4
        if cont != _CONT:
            length = struct.unpack_from("<i", raw, 0)[0]
        meta = raw[hdr:hdr + length]
        body = self._data[off + mlen: off + mlen + blen]
        return meta, body

    @property
    def num_record_batches(self) -> int:
        return len(self._batch_blocks)

    def get_batch(self, i: int) -> Table:
        off, mlen, blen = self._batch_blocks[i]
        meta, body = self._message_at(off, mlen, blen)
        return fmt.decode_record_batch(self.schema, meta, body,
                                       self._dictionaries,
                                       self._dict_id_of, self._dev)


def read_file(path_or_source, device: DeviceLike) -> List[Table]:
    """FileReader (arrow-ipc/src/reader.rs:1153): random-access footer
    format; the batches on `device`."""
    resolve_device(device)
    if isinstance(path_or_source, str):
        with open(path_or_source, "rb") as f:
            data = f.read()
    elif hasattr(path_or_source, "read"):
        data = path_or_source.read()
    else:
        data = bytes(path_or_source)
    from ..errors import malformed_guard
    with malformed_guard("IPC file"):
        r = FileReader(data, device)
        return [r.get_batch(i) for i in range(r.num_record_batches)]


def serialize_table(table: Table, compression: Optional[str] = None
                    ) -> bytes:
    """One-shot table -> IPC stream bytes (the shuffle/spill payload)."""
    buf = _io.BytesIO()
    write_stream(buf, table, compression)
    return buf.getvalue()


def deserialize_table(data: bytes, device: DeviceLike) -> Table:
    tables = read_stream(data, device)
    if len(tables) == 1:
        return tables[0]
    from ..ops.concat import concat_tables
    return concat_tables(tables)
