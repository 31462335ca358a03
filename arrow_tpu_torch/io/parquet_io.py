"""Parquet scan/write (the parquet crate's Arrow layer; counterpart of
arrow_tpu/io/parquet_io.py).

API mirrors ParquetRecordBatchReaderBuilder (parquet/src/arrow/arrow_reader/
mod.rs:831): projection (ProjectionMask), row-group selection, predicate
pushdown (RowFilter -> our FilterPredicate applied streaming per batch),
batch size; and ArrowWriter (arrow_writer/mod.rs:131) with
WriterProperties (file/properties.rs:156): compression, row-group size,
dictionary control, statistics.

Both paths are native: READ via io/parquet_native.py (thrift footer,
C++ page decode, level assembly) and WRITE via io/parquet_writer.py
(thrift metadata, PLAIN/RLE-dict pages, v1/v2 data pages, page index,
checksums, statistics, bloom filters, modular encryption, arbitrary
nesting).  Layouts parquet cannot hold (union, run-end-encoded) are
REJECTED like the reference (parquet/src/arrow/schema/mod.rs:780
"Converting RunEndEncodedType to parquet not supported") — there is no
pyarrow fallback.

Every reader names the `device` its tables are built on (the builder's
`device` field, `read_parquet(..., device=)`); a predicate's mask comes
to the host once per row group to make the RowSelection, and the kept
rows are taken by `filter_table` on that device (K1 on a card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence

import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.table import Table
from ..errors import ArrowInvalid
from .hostio import host, to_host

__all__ = ["ParquetReaderBuilder", "WriterProperties", "ParquetWriter",
           "read_parquet", "write_parquet", "read_metadata",
           "RowSelection", "RowFilter", "StatisticsConverter"]


class RowSelection:
    """Sorted disjoint row intervals (selection.rs:100 RowSelection).

    Produced from a predicate mask (from_mask) or intervals; drives
    page-skip decode: pages fully outside the selection never
    decompress (arrow_reader/mod.rs:736 ReadPlan)."""

    def __init__(self, intervals: Sequence[tuple]):
        iv = sorted((int(s), int(e)) for s, e in intervals if e > s)
        merged: List[tuple] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self.intervals = merged

    @classmethod
    def from_mask(cls, mask) -> "RowSelection":
        import numpy as np
        m = np.asarray(mask, bool)
        if not m.size:
            return cls([])
        d = np.flatnonzero(np.diff(m.astype(np.int8)))
        edges = [0] + (d + 1).tolist() + [m.size]
        return cls([(edges[i], edges[i + 1])
                    for i in range(len(edges) - 1) if m[edges[i]]])

    def row_count(self) -> int:
        return sum(e - s for s, e in self.intervals)

    def intersection(self, other: "RowSelection") -> "RowSelection":
        out = []
        for s1, e1 in self.intervals:
            for s2, e2 in other.intervals:
                s, e = max(s1, s2), min(e1, e2)
                if e > s:
                    out.append((s, e))
        return RowSelection(out)

    def union(self, other: "RowSelection") -> "RowSelection":
        return RowSelection(self.intervals + other.intervals)


@dataclass
class RowFilter:
    """arrow_reader/filter.rs:173 RowFilter: a predicate with an
    EXPLICIT input projection.  The builder evaluates the predicate
    from its projection columns alone, turns the mask into a
    RowSelection, and decodes the remaining columns with page
    skipping."""
    predicate: Callable[[Table], object]   # Table(projection) -> bool Column
    columns: Sequence[str]


@dataclass
class WriterProperties:
    """file/properties.rs:156 subset (+ page index and page checksums,
    the reference's offset/column-index and checksum.rs roles)."""
    compression: str = "snappy"          # the reference's default too
    row_group_size: int = 1 << 20
    dictionary_enabled: bool = True
    write_statistics: bool = True
    data_page_size: Optional[int] = None
    data_page_version: str = "1.0"
    write_page_index: bool = False
    write_page_checksum: bool = False
    sorting_columns: Optional[tuple] = None   # ((name, descending), ...)
    bloom_filter_columns: tuple = ()          # native writer sbbf
    encryption: object = None   # parquet_crypto.FileEncryptionProperties
    key_value_metadata: Optional[dict] = None
    store_schema: bool = True   # embed ARROW:schema for exact round-trip
    # default VALUES encoding (properties.rs set_encoding): one of
    # plain / rle / delta_binary_packed / delta_length_byte_array /
    # delta_byte_array / byte_stream_split; None = format defaults
    encoding: Optional[str] = None
    # dictionary fallback threshold (properties.rs
    # dictionary_page_size_limit, default 1 MB): chunks whose dictionary
    # would exceed this write the fallback value encodings instead
    dictionary_page_size_limit: int = 1 << 20
    # per-column overrides: {column: {compression, dictionary_enabled,
    # write_statistics, encoding}} (properties.rs set_column_* roles)
    column_properties: Optional[dict] = None


@dataclass
class ParquetReaderBuilder:
    """Builder: with_projection / with_row_groups / with_row_filter /
    with_batch_size / with_limit+offset, then build() -> batch iterator."""
    path: object
    columns: Optional[Sequence[str]] = None
    row_groups: Optional[Sequence[int]] = None
    batch_size: int = 65536
    row_filter: Optional[Callable[[Table], object]] = None
    row_selection: Optional["RowSelection"] = None
    limit: Optional[int] = None
    offset: int = 0
    bloom_probe: Optional[tuple] = None   # (column, value)
    decryption: object = None  # parquet_crypto.FileDecryptionProperties
    device: DeviceLike = None  # where the batches are built (required)

    def with_decryption(self, props):
        """FileDecryptionProperties for encrypted files
        (encryption/decrypt.rs role)."""
        self.decryption = props
        return self

    def with_projection(self, columns: Sequence[str]):
        self.columns = list(columns)
        return self

    def with_row_groups(self, groups: Sequence[int]):
        self.row_groups = list(groups)
        return self

    def with_batch_size(self, n: int):
        self.batch_size = n
        return self

    def with_row_filter(self, predicate_fn):
        """Plain callable (Table -> boolean Column): applied per batch
        after decode.  A RowFilter instance instead enables the
        two-phase page-skip pushdown (arrow_reader/filter.rs:173)."""
        self.row_filter = predicate_fn
        return self

    def with_row_selection(self, selection: "RowSelection"):
        """Decode only the selected rows, skipping pages entirely
        outside the selection when the file has an offset index
        (arrow_reader/mod.rs with_row_selection; selection row
        coordinates are FILE-relative across the selected row
        groups)."""
        self.row_selection = selection
        return self

    def with_bloom_filter(self, column: str, value):
        """Prune row groups whose bloom filter proves `value` absent
        (bloom_filter/mod.rs + the sbbf read path); groups without a
        filter are kept."""
        self.bloom_probe = (column, value)
        return self

    def with_limit(self, n: int):
        self.limit = n
        return self

    def with_offset(self, n: int):
        self.offset = n
        return self

    def build(self) -> Iterator[Table]:
        """Streaming scan with row-group PREFETCH: while batch N's rows
        are consumed, row group N+1 fetches + decodes on a background
        thread (the reference's ParquetRecordBatchStream overlap,
        parquet/src/arrow/async_reader/mod.rs:712 — polling the next
        range concurrently with downstream consumption).  Depth via
        ARROW_TPU_PARQUET_PREFETCH (default 1, 0 = synchronous).  The
        thread decodes into host buffers only; each row group goes onto
        the device here, on the consumer's thread and current stream.

        A RowFilter (vs a plain callable) runs the two-phase ReadPlan
        (arrow_reader/mod.rs:736): decode the predicate's projection,
        turn its mask into a RowSelection, then decode the remaining
        columns SKIPPING pages outside the selection (offset index
        required for the skip; without one the selection still trims
        rows, it just cannot avoid decodes)."""
        import os
        from .parquet_native import ParquetFile
        resolve_device(self.device)
        f = ParquetFile(self.path, self.device, decryption=self.decryption)
        groups = list(self.row_groups if self.row_groups is not None
                      else range(len(f.row_groups)))
        if self.bloom_probe is not None:
            keep = set(f.prune_row_groups(*self.bloom_probe))
            groups = [g for g in groups if g in keep]
        if isinstance(self.row_filter, RowFilter):
            yield from self._emit(self._pushdown_tables(f, groups),
                                  apply_filter=False)
            return
        if self.row_selection is not None:
            yield from self._emit(self._selected_tables(f, groups))
            return
        depth = int(os.environ.get("ARROW_TPU_PARQUET_PREFETCH", "1"))
        if depth <= 0 or len(groups) <= 1:
            tables = (f.read_row_group(gi, columns=self.columns)
                      for gi in groups)
            yield from self._emit(tables)
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=depth,
                                thread_name_prefix="pq-prefetch")
        try:
            def tables():
                pending = deque()
                it = iter(groups)
                for _ in range(depth):
                    gi = next(it, None)
                    if gi is not None:
                        pending.append((gi, ex.submit(
                            f._decode_row_group, gi, self.columns)))
                while pending:
                    gj, done = pending.popleft()
                    decoded = done.result()
                    gi = next(it, None)
                    if gi is not None:
                        pending.append((gi, ex.submit(
                            f._decode_row_group, gi, self.columns)))
                    yield f._place(gj, decoded)
            yield from self._emit(tables())
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _selected_tables(self, f, groups) -> Iterator[Table]:
        """Explicit RowSelection scan: the selection is relative to the
        CONCATENATION OF THE SELECTED ROW GROUPS (arrow-rs
        with_row_selection semantics, arrow_reader/mod.rs — "rows from
        skipped row groups should not be included"), intersected with
        each scanned group's span and decoded with page skipping."""
        rg_start = {}
        acc = 0
        for gi in groups:
            rg_start[gi] = acc
            acc += f.row_groups[gi].get(3, 0)
        for gi in groups:
            base = rg_start[gi]
            nrows = f.row_groups[gi].get(3, 0)
            local = RowSelection(
                [(max(s - base, 0), min(e - base, nrows))
                 for s, e in self.row_selection.intervals
                 if s < base + nrows and e > base])
            if local.row_count() == 0:
                continue
            yield f.read_row_group(gi, columns=self.columns,
                                   selection=local.intervals)

    def _pushdown_tables(self, f, groups) -> Iterator[Table]:
        """Two-phase decode per row group: predicate projection ->
        RowSelection -> page-skipped decode of the remaining columns."""
        rf = self.row_filter
        out_cols = list(self.columns) if self.columns is not None \
            else [c.name for c in f.root.children]
        pred_cols = [c for c in rf.columns]
        rest_cols = [c for c in out_cols if c not in set(pred_cols)]
        for gi in groups:
            t_pred = f.read_row_group(gi, columns=pred_cols)
            mcol = rf.predicate(t_pred)
            keep = mcol.values.to(torch.bool)
            if getattr(mcol, "validity", None) is not None:
                keep = keep & mcol.validity
            m = host(to_host(keep))        # the mask on the host, once
            sel = RowSelection.from_mask(m)
            if sel.row_count() == 0:
                continue
            if rest_cols:
                t_rest = f.read_row_group(gi, columns=rest_cols,
                                          selection=sel.intervals)
            else:
                t_rest = None
            if not m.all():
                from ..ops.filter import filter_table
                t_pred = filter_table(t_pred, mcol)
            by_name = {}
            for name, col, fld in zip(t_pred.schema.names,
                                      t_pred.columns,
                                      t_pred.schema.fields):
                by_name[name] = (col, fld)
            if t_rest is not None:
                for name, col, fld in zip(t_rest.schema.names,
                                          t_rest.columns,
                                          t_rest.schema.fields):
                    by_name[name] = (col, fld)
            cols = tuple(by_name[nm][0] for nm in out_cols)
            fields = tuple(by_name[nm][1] for nm in out_cols)
            yield Table(cols, dt.Schema(fields))

    def _emit(self, rg_tables, apply_filter: bool = True
              ) -> Iterator[Table]:
        """Batch slicing + filter/offset/limit over decoded row groups."""
        remaining = self.limit
        to_skip = self.offset
        for rg_table in rg_tables:
            for start in range(0, max(rg_table.num_rows, 1),
                               self.batch_size):
                if start >= rg_table.num_rows and rg_table.num_rows > 0:
                    break
                t = rg_table.slice(start, min(self.batch_size,
                                              rg_table.num_rows - start))
                if apply_filter and self.row_filter is not None:
                    from ..ops.filter import filter_table
                    t = filter_table(t, self.row_filter(t))
                if to_skip:
                    drop = min(to_skip, t.num_rows)
                    t = t.slice(drop, t.num_rows - drop)
                    to_skip -= drop
                    if t.num_rows == 0:
                        continue
                if remaining is not None:
                    if remaining <= 0:
                        return
                    if t.num_rows > remaining:
                        t = t.slice(0, remaining)
                    remaining -= t.num_rows
                yield t
                if rg_table.num_rows == 0:
                    break


def read_parquet(path, columns: Optional[Sequence[str]] = None,
                 decryption=None, *, device: DeviceLike = None) -> Table:
    """Whole-file native read onto `device` (no pyarrow in this path)."""
    from .parquet_native import read_parquet_native
    return read_parquet_native(path, columns=columns,
                               decryption=decryption, device=device)


class ParquetWriter:
    """ArrowWriter (arrow_writer/mod.rs:131): streaming batch writer,
    fully native.  Layouts parquet cannot represent (union, REE) raise
    like the reference (schema/mod.rs:780)."""

    def __init__(self, path, schema_table: Table,
                 properties: WriterProperties = WriterProperties()):
        self._props = properties
        _require_native_writable(schema_table.schema)
        from .parquet_writer import NativeParquetWriter
        self._w = NativeParquetWriter(
            path, schema_table.schema,
            compression=properties.compression,
            dictionary_enabled=properties.dictionary_enabled,
            write_statistics=properties.write_statistics,
            bloom_filter_columns=properties.bloom_filter_columns,
            row_group_size=properties.row_group_size,
            data_page_size=properties.data_page_size,
            data_page_version=properties.data_page_version,
            write_page_index=properties.write_page_index,
            write_page_checksum=properties.write_page_checksum,
            sorting_columns=properties.sorting_columns,
            encryption=properties.encryption,
            key_value_metadata=properties.key_value_metadata,
            store_schema=properties.store_schema,
            column_properties=properties.column_properties)

    def write(self, table: Table) -> None:
        self._w.write_table(table)

    def close(self) -> None:
        self._w.close()


def _require_native_writable(schema: dt.Schema) -> None:
    """Raise for schemas parquet cannot hold, naming the field — the
    reference errors the same way (schema/mod.rs:780 for REE; unions
    have no parquet mapping at all)."""
    for f in schema.fields:
        if not _native_writable(dt.Schema((f,))):
            raise ArrowInvalid(
                f"column {f.name!r}: {f.dtype} cannot be written to "
                "parquet (no parquet representation; the reference "
                "rejects it too)")


def _native_writable(schema: dt.Schema) -> bool:
    from .parquet_writer import _logical_fields
    def ok(d: dt.DataType) -> bool:
        if d.name == "struct":
            return all(ok(f.dtype) for f in d.fields)
        if d.name in ("list", "large_list", "fixed_size_list",
                      "list_view", "large_list_view"):
            # views store as lists; ARROW:schema restores the view dtype
            return ok(d.value_type)
        if d.name == "map":
            return all(ok(f.dtype) for f in d.value_type.fields)
        if d.name == "dictionary":
            # any writable value type: codes materialize through the
            # page dictionary; ARROW:schema restores the dict dtype
            return ok(d.value_type)
        try:
            _logical_fields(d)
            return True
        except Exception:            # noqa: BLE001
            return False
    return all(ok(f.dtype) for f in schema.fields)


def write_parquet(path, table: Table,
                  properties: WriterProperties = WriterProperties()):
    """Whole-table native write; unrepresentable layouts raise."""
    props = properties
    _require_native_writable(table.schema)
    from .parquet_writer import write_parquet_native
    write_parquet_native(
        path, table, compression=props.compression,
        dictionary_enabled=props.dictionary_enabled,
        write_statistics=props.write_statistics,
        bloom_filter_columns=props.bloom_filter_columns,
        row_group_size=props.row_group_size,
        data_page_size=props.data_page_size,
        data_page_version=props.data_page_version,
        write_page_index=props.write_page_index,
        write_page_checksum=props.write_page_checksum,
        sorting_columns=props.sorting_columns,
        encryption=props.encryption,
        key_value_metadata=props.key_value_metadata,
        store_schema=props.store_schema,
        column_properties=props.column_properties,
        encoding=props.encoding,
        dictionary_page_size_limit=props.dictionary_page_size_limit)


class ParquetMetadata:
    """Native footer metadata view (file/metadata/mod.rs:176)."""

    def __init__(self, pf):
        self._pf = pf
        self.num_rows = pf.num_rows
        self.num_row_groups = len(pf.row_groups)
        self.created_by = pf.created_by
        self.schema = pf.schema

    def row_group_num_rows(self, i: int) -> int:
        return self._pf.row_groups[i].get(3, 0)

    def column_statistics(self, rg: int, col: int):
        """-> {min, max, null_count, distinct_count} with min/max decoded
        from their PLAIN encoding through the leaf's LOGICAL type
        (Statistics, format.rs field ids 1-6; statistics.rs decodes via
        the converted/arrow type, so UINT32/UINT64 stay unsigned and
        decimal blobs come back as Decimal)."""
        from .parquet_native import _leaves_under
        md = self._pf.row_groups[rg].get(1, [])[col].get(3, {})
        st = md.get(12)
        if st is None:
            return None
        leaves = [leaf for f in self._pf.root.children
                  for leaf in _leaves_under(f)]
        node = leaves[col]
        return {"min": _stat_decode_one(st.get(6, st.get(2)), node),
                "max": _stat_decode_one(st.get(5, st.get(1)), node),
                "null_count": st.get(3), "distinct_count": st.get(4)}


def read_metadata(path) -> ParquetMetadata:
    """Footer metadata incl. per-column statistics — parsed natively."""
    from .parquet_native import ParquetFile
    return ParquetMetadata(ParquetFile(path))


def _stat_decode_one(raw, node):
    """PLAIN-decode one min/max statistics blob through the leaf's
    LOGICAL type (the reference decodes stats via the converted/arrow
    type, statistics.rs): unsigned INT32/INT64 decode as unsigned,
    decimal INT32/INT64/BYTE_ARRAY/FLBA blobs (big-endian two's
    complement for the byte forms) decode to decimal.Decimal, utf8
    decodes to str, and non-utf8 byte stats come back as raw bytes
    instead of backslash-escaped text."""
    import struct as _st
    if raw is None or not isinstance(raw, (bytes, bytearray)):
        return None
    from .parquet_native import _logical_dtype
    d = _logical_dtype(node)
    name = d.name
    phys = node.physical
    try:
        if name.startswith("decimal"):
            if phys == 1:
                unscaled = _st.unpack("<i", raw)[0]
            elif phys == 2:
                unscaled = _st.unpack("<q", raw)[0]
            else:
                unscaled = int.from_bytes(bytes(raw), "big", signed=True)
            import decimal as _dec
            return _dec.Decimal(unscaled).scaleb(-d.scale)
        if phys == 1:
            return _st.unpack(
                "<I" if name.startswith("uint") else "<i", raw)[0]
        if phys == 2:
            return _st.unpack(
                "<Q" if name.startswith("uint") else "<q", raw)[0]
        if phys == 4:
            return _st.unpack("<f", raw)[0]
        if phys == 5:
            return _st.unpack("<d", raw)[0]
        if phys == 0:
            return bool(raw[0])
        if "utf8" in name:
            return bytes(raw).decode("utf-8")
        return bytes(raw)
    except Exception:                  # noqa: BLE001
        return None


def _stat_column_dtype(node):
    """Engine dtype for a decoded min/max statistics column: the leaf's
    logical dtype for value-like families, else the physical fallback."""
    from .parquet_native import _logical_dtype
    from .. import dtypes as _dt
    d = _logical_dtype(node)
    n = d.name
    if (n.startswith(("int", "uint", "float", "decimal"))
            or n in ("bool", "utf8", "large_utf8")):
        return d
    if n in ("binary", "large_binary", "fixed_size_binary"):
        return _dt.binary
    return {1: _dt.int32, 2: _dt.int64, 4: _dt.float32,
            5: _dt.float64, 0: _dt.bool_}.get(node.physical, _dt.utf8)


class StatisticsConverter:
    """Parquet statistics as ENGINE COLUMNS (the arrow-rs
    StatisticsConverter role, parquet/src/arrow/arrow_reader/
    statistics.rs): one row per row group (or per page, from the page
    index) with min/max/null_count decoded through the column's
    physical type — the shape pruning engines consume.  The columns are
    built on `device` (by default the ParquetFile's)."""

    def __init__(self, pf_or_path, column: str,
                 device: DeviceLike = None):
        from .parquet_native import ParquetFile
        self._pf = pf_or_path if isinstance(pf_or_path, ParquetFile) \
            else ParquetFile(pf_or_path)
        self._dev = resolve_device(device if device is not None
                                   else self._pf._device)
        self._col = column
        md = ParquetMetadata(self._pf)
        self._md = md

    def _decode_many(self, raws):
        """PLAIN-decode a list of Optional[bytes] min/max blobs into an
        engine column through the leaf's LOGICAL type (statistics.rs
        decodes via the arrow type: unsigned stays unsigned, decimal
        blobs become decimal columns)."""
        from .parquet_native import _leaves_under
        li = self._pf._leaf_index_for(self._col)
        if li is None:
            raise ArrowInvalid(f"unknown column {self._col!r}")
        leaves = [leaf for f in self._pf.root.children
                  for leaf in _leaves_under(f)]
        node = leaves[li]
        from ..core.column import column as make_col
        vals = [_stat_decode_one(r, node) for r in raws]
        return make_col(vals, _stat_column_dtype(node), device=self._dev)

    def _rg_stat_raw(self, which):
        out = []
        li = self._pf._leaf_index_for(self._col)
        for rg in range(self._md.num_row_groups):
            md = self._pf.row_groups[rg].get(1, [])[li].get(3, {})
            st = md.get(12)
            if st is None:
                out.append(None)
                continue
            if which == "min":
                out.append(st.get(6, st.get(2)))
            elif which == "max":
                out.append(st.get(5, st.get(1)))
            else:
                out.append(st.get(3))
        return out

    def row_group_statistics(self):
        """Table: one row per row group with min/max columns (decoded)
        and null_count int64."""
        mins = self._decode_many(self._rg_stat_raw("min"))
        maxs = self._decode_many(self._rg_stat_raw("max"))
        from ..core.column import column as make_col
        from .. import dtypes as _dt
        ncs = make_col(self._rg_stat_raw("null_count"), _dt.int64,
                       device=self._dev)
        return Table((mins, maxs, ncs), dt.Schema((
            dt.Field("min", mins.dtype), dt.Field("max", maxs.dtype),
            dt.Field("null_count", _dt.int64))))

    def page_statistics(self, rg_index: int):
        """Table: one row per PAGE from the column index (page-index
        driven pruning shape), or None when the file has no column
        index for this chunk."""
        ci = self._pf.column_index(rg_index, self._col)
        if ci is None:
            return None
        mins = self._decode_many(ci["min_values"])
        maxs = self._decode_many(ci["max_values"])
        from ..core.column import column as make_col
        from .. import dtypes as _dt
        ncs = make_col([int(x) for x in ci["null_counts"]]
                       if ci["null_counts"] else
                       [None] * len(ci["min_values"]), _dt.int64,
                       device=self._dev)
        nps = make_col([bool(b) for b in ci["null_pages"]], _dt.bool_,
                       device=self._dev)
        return Table((mins, maxs, ncs, nps), dt.Schema((
            dt.Field("min", mins.dtype), dt.Field("max", maxs.dtype),
            dt.Field("null_count", _dt.int64),
            dt.Field("is_null_page", _dt.bool_, nullable=False))))
