"""FlightSQL protocol layer (arrow-flight/src/sql/, 5.1k LoC;
format/FlightSql.proto); counterpart of arrow_tpu/io/flightsql.py.

FlightSQL rides ordinary Flight RPC: command messages are protobuf
structs wrapped in google.protobuf.Any and carried in
FlightDescriptor.cmd / Action bodies.  arrow-rs implements the message
layer plus client/server plumbing — the SQL itself is the application's
job.  This module does the same: a hand-rolled protobuf wire codec for
the command messages (the wire format is varint tags + length-delimited
fields; no generated code), a FlightSQLServer that dispatches commands
to a pluggable query handler, and a FlightSQLClient mirroring
sql/client.rs (execute / prepared statements / catalog metadata).

The default executor is the engine's SQL frontend (sql.py) over the
server's registered tables, which stay resident on the server's device;
the metadata tables (catalogs, SqlInfo, keys, XDBC types) are made on
that device too.  The server holds each table as a version
(storage.TableVersion): a write publishes a new one made from what the
statement changes, a transaction publishes all of its tables at once,
and a statement reads the versions current when it was admitted.  A cancelled query's ticket is refused until a new
GetFlightInfo issues the same command again, which is a new query, as
in arrow-rs (the reference refuses the command for the life of the
server: ROADMAP C7.2).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
import uuid as _uuid
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as _dt
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..storage import Delta, TableVersion
from ..utils import trace
from .flight import (FlightDescriptor, FlightInfo, FlightServer,
                     FlightTableClient, DESCRIPTOR_CMD, _concat,
                     _empty_table, schema_ipc_bytes)

__all__ = ["FlightSQLServer", "FlightSQLClient", "StatementGate",
           "simple_sql_executor", "simple_sql_update_executor", "dt_schema",
           "SNAPSHOT_KEY"]

SNAPSHOT_KEY = "arrow_tpu.snapshot"   # a result's schema metadata: its commit
TXN_IDLE_S = 30           # an open transaction idle this long is rolled back


def dt_schema(names, cols):
    """A schema of nullable fields named `names`, typed as `cols`
    (arrow_tpu/io/flightsql.py:29)."""
    from .. import dtypes as _dt
    return _dt.Schema(tuple(_dt.Field(n, c.dtype)
                            for n, c in zip(names, cols)))

_TYPE_PREFIX = "type.googleapis.com/arrow.flight.protocol.sql."


# ---- protobuf wire codec shared with the Flight layer (io/pb.py) ------------

from .pb import (varint as _varint, field as _field,
                 parse_fields as _parse_fields,
                 varint_field as _varint_field, first as _pb_first,
                 first_bytes as _pb_first_bytes)


def _any_pack(msg_name: str, payload: bytes) -> bytes:
    """google.protobuf.Any{type_url=1, value=2}."""
    return _field(1, (_TYPE_PREFIX + msg_name).encode()) \
        + _field(2, payload)


def _any_unpack(buf: bytes) -> Tuple[str, bytes]:
    f = _parse_fields(buf)
    url = f.get(1, [b""])[0].decode()
    val = f.get(2, [b""])[0]
    return url.rsplit(".", 1)[-1], val


def _decode_update_result(meta: bytes) -> int:
    """PutResult.app_metadata -> DoPutUpdateResult.record_count
    (int64; -1 = unknown)."""
    if not meta:
        return -1
    n = _pb_first(_parse_fields(meta), 1, 0)
    return n - (1 << 64) if n >= 1 << 63 else n


# ---- command messages (FlightSql.proto field numbers) -------------------------

def cmd_statement_query(query: str) -> bytes:
    return _any_pack("CommandStatementQuery", _field(1, query.encode()))


def cmd_prepared_statement_query(handle: bytes) -> bytes:
    return _any_pack("CommandPreparedStatementQuery", _field(1, handle))


def cmd_get_catalogs() -> bytes:
    return _any_pack("CommandGetCatalogs", b"")


def cmd_get_db_schemas(db_schema_filter_pattern: Optional[str] = None
                       ) -> bytes:
    body = b""
    if db_schema_filter_pattern is not None:
        body += _field(2, db_schema_filter_pattern.encode())
    return _any_pack("CommandGetDbSchemas", body)


def cmd_get_tables(include_schema: bool = False,
                   table_name_filter_pattern: Optional[str] = None,
                   table_types: Sequence[str] = ()) -> bytes:
    body = b""
    if table_name_filter_pattern is not None:
        body += _field(3, table_name_filter_pattern.encode())
    for t in table_types:
        body += _field(4, t.encode())
    if include_schema:
        body += _varint((5 << 3) | 0) + _varint(1)
    return _any_pack("CommandGetTables", body)


def action_create_prepared(query: str) -> bytes:
    return _any_pack("ActionCreatePreparedStatementRequest",
                     _field(1, query.encode()))


def action_close_prepared(handle: bytes) -> bytes:
    return _any_pack("ActionClosePreparedStatementRequest",
                     _field(1, handle))


def cmd_get_sql_info(info_ids=()) -> bytes:
    """CommandGetSqlInfo{repeated uint32 info = 1} (packed)."""
    packed = b"".join(_varint(int(i)) for i in info_ids)
    return _any_pack("CommandGetSqlInfo",
                     _field(1, packed) if packed else b"")


def cmd_get_table_types() -> bytes:
    return _any_pack("CommandGetTableTypes", b"")


def _opt_str_fields(*pairs) -> bytes:
    out = b""
    for tag, v in pairs:
        if v is not None:
            out += _field(tag, v.encode())
    return out


def cmd_get_primary_keys(table: str, catalog=None, db_schema=None
                         ) -> bytes:
    return _any_pack("CommandGetPrimaryKeys", _opt_str_fields(
        (1, catalog), (2, db_schema), (3, table)))


def cmd_get_exported_keys(table: str, catalog=None, db_schema=None
                          ) -> bytes:
    return _any_pack("CommandGetExportedKeys", _opt_str_fields(
        (1, catalog), (2, db_schema), (3, table)))


def cmd_get_imported_keys(table: str, catalog=None, db_schema=None
                          ) -> bytes:
    return _any_pack("CommandGetImportedKeys", _opt_str_fields(
        (1, catalog), (2, db_schema), (3, table)))


def cmd_get_cross_reference(pk_table: str, fk_table: str) -> bytes:
    return _any_pack("CommandGetCrossReference", _opt_str_fields(
        (3, pk_table), (6, fk_table)))


def cmd_get_xdbc_type_info(data_type: Optional[int] = None) -> bytes:
    from .pb import varint_field as _vf
    body = b"" if data_type is None else _vf(1, data_type)
    if data_type == 0:
        body = _varint(1 << 3) + _varint(0)   # explicit zero
    return _any_pack("CommandGetXdbcTypeInfo", body)


def cmd_statement_update(query: str,
                         transaction_id: Optional[bytes] = None) -> bytes:
    """CommandStatementUpdate{query=1, transaction_id=2} — the DoPut
    DML command (FlightSql.proto:1758)."""
    body = _field(1, query.encode())
    if transaction_id:
        body += _field(2, transaction_id)
    return _any_pack("CommandStatementUpdate", body)


def cmd_prepared_statement_update(handle: bytes) -> bytes:
    return _any_pack("CommandPreparedStatementUpdate", _field(1, handle))


# TableDefinitionOptions enums (FlightSql.proto:1785)
TABLE_NOT_EXIST_CREATE = 1
TABLE_NOT_EXIST_FAIL = 2
TABLE_EXISTS_FAIL = 1
TABLE_EXISTS_APPEND = 2
TABLE_EXISTS_REPLACE = 3


def cmd_statement_ingest(table: str, *,
                         if_not_exist: int = TABLE_NOT_EXIST_CREATE,
                         if_exists: int = TABLE_EXISTS_FAIL,
                         db_schema: Optional[str] = None,
                         catalog: Optional[str] = None,
                         temporary: bool = False,
                         transaction_id: Optional[bytes] = None,
                         options: Optional[Dict[str, str]] = None
                         ) -> bytes:
    """CommandStatementIngest (FlightSql.proto:1782): bulk-load the
    DoPut stream into `table` per the TableDefinitionOptions."""
    tdo = _varint_field(1, if_not_exist) + _varint_field(2, if_exists)
    body = _field(1, tdo) + _field(2, table.encode())
    if db_schema is not None:
        body += _field(3, db_schema.encode())
    if catalog is not None:
        body += _field(4, catalog.encode())
    if temporary:
        body += _varint_field(5, 1)
    if transaction_id:
        body += _field(6, transaction_id)
    for k, v in (options or {}).items():
        body += _field(1000, _field(1, k.encode())
                       + _field(2, v.encode()))
    return _any_pack("CommandStatementIngest", body)


def cmd_statement_substrait_plan(plan: bytes, version: str = "",
                                 transaction_id: Optional[bytes] = None
                                 ) -> bytes:
    """CommandStatementSubstraitPlan{plan=1{bytes plan=1, string
    version=2}, transaction_id=2} (FlightSql.proto:1503; sql/mod.rs
    CommandStatementSubstraitPlan)."""
    inner = _field(1, plan)
    if version:
        inner += _field(2, version.encode())
    body = _field(1, inner)
    if transaction_id:
        body += _field(2, transaction_id)
    return _any_pack("CommandStatementSubstraitPlan", body)


def action_cancel_query(info_bytes: bytes) -> bytes:
    """ActionCancelQueryRequest{info=1} (serialized FlightInfo)."""
    return _any_pack("ActionCancelQueryRequest", _field(1, info_bytes))


def _do_put_update_result(count: int) -> bytes:
    """DoPutUpdateResult{record_count=1} — rides PutResult.app_metadata
    (NOT Any-wrapped; sql/client.rs decodes it directly).  Encoded
    explicitly even for zero so a 0-row DDL result is distinguishable
    from a legacy empty PutResult (= unknown, -1)."""
    return _varint(1 << 3) + _varint(count & ((1 << 64) - 1))


def action_begin_transaction() -> bytes:
    return _any_pack("ActionBeginTransactionRequest", b"")


def action_end_transaction(transaction_id: bytes, commit: bool) -> bytes:
    from .pb import varint_field as _vf
    return _any_pack("ActionEndTransactionRequest",
                     _field(1, transaction_id) + _vf(2, 1 if commit
                                                     else 2))


# ---- SqlInfo metadata (sql/metadata/sql_info.rs) ----------------------------

# SqlInfo enum ids (FlightSql.proto)
SQL_INFO_SERVER_NAME = 0
SQL_INFO_SERVER_VERSION = 1
SQL_INFO_SERVER_ARROW_VERSION = 2
SQL_INFO_SERVER_READ_ONLY = 3
SQL_INFO_SERVER_TRANSACTION = 8
SQL_INFO_DDL_CATALOG = 500
SQL_INFO_IDENTIFIER_QUOTE_CHAR = 504
SQL_INFO_KEYWORDS = 508
SQL_INFO_SUPPORTS_CONVERT = 517


def _sql_info_union_fields():
    from .. import dtypes as _dt
    return (
        _dt.Field("string_value", _dt.utf8, False),
        _dt.Field("bool_value", _dt.bool_, False),
        _dt.Field("bigint_value", _dt.int64, False),
        _dt.Field("int32_bitmask", _dt.int32, False),
        _dt.Field("string_list", _dt.list_(_dt.utf8), True),
        _dt.Field("int32_to_int32_list_map",
                  _dt.map_(_dt.int32, _dt.list_(_dt.int32)), True),
    )


class SqlInfoData:
    """Typed SqlInfo registry -> GetSqlInfo result table
    (sql_info.rs:386 SqlInfoDataBuilder/GetSqlInfoBuilder: the value
    column is a DENSE union over six arms)."""

    def __init__(self):
        self._entries: Dict[int, Tuple[int, object]] = {}

    def with_value(self, info_id: int, value) -> "SqlInfoData":
        if isinstance(value, str):
            arm = 0
        elif isinstance(value, bool):
            arm = 1
        elif isinstance(value, int):
            arm = 2
        elif isinstance(value, (list, tuple)):
            arm = 4
        elif isinstance(value, dict):
            arm = 5
        else:
            raise ArrowInvalid(f"unsupported SqlInfo value {value!r}")
        self._entries[int(info_id)] = (arm, value)
        return self

    def with_bitmask(self, info_id: int, value: int) -> "SqlInfoData":
        self._entries[int(info_id)] = (3, int(value))
        return self

    def table(self, info_ids=(), *, device) -> Table:
        """The GetSqlInfo result on `device`."""
        from .. import dtypes as _dt
        from ..core.column import (column as _column, from_numpy,
                                   ListColumn, StructColumn)
        from ..core.nested import UnionColumn, MapColumn

        def column(values, dtype):
            return _column(values, dtype, device=device)

        def tensor(a):
            return torch.from_numpy(a).to(device)

        ids = sorted(self._entries if not info_ids
                     else [i for i in self._entries if i in
                           set(int(x) for x in info_ids)])
        strs: list = []
        bools: list = []
        bigints: list = []
        masks: list = []
        slists: list = []
        maps: list = []
        type_ids = np.zeros(len(ids), np.int8)
        offsets = np.zeros(len(ids), np.int32)
        arms = [strs, bools, bigints, masks, slists, maps]
        for row, i in enumerate(ids):
            arm, v = self._entries[i]
            type_ids[row] = arm
            offsets[row] = len(arms[arm])
            arms[arm].append(v)
        # child columns (empty children still need the right dtype)
        c_str = column(strs, _dt.utf8) if strs else column([], _dt.utf8)
        c_bool = column(bools, _dt.bool_)
        c_big = column([int(v) for v in bigints], _dt.int64)
        c_mask = column(masks, _dt.int32)
        # list<utf8>
        lens = np.array([len(v) for v in slists], np.int64)
        loffs = np.zeros(len(slists) + 1, np.int32)
        np.cumsum(lens, out=loffs[1:])
        flat = [s for v in slists for s in v]
        c_slist = ListColumn(tensor(loffs), column(flat, _dt.utf8))
        # map<int32, list<int32>>
        entry_counts = np.array([len(m) for m in maps], np.int64)
        moffs = np.zeros(len(maps) + 1, np.int32)
        np.cumsum(entry_counts, out=moffs[1:])
        mkeys = [k for m in maps for k in sorted(m)]
        mvals = [m[k] for m in maps for k in sorted(m)]
        vlens = np.array([len(v) for v in mvals], np.int64)
        voffs = np.zeros(len(mvals) + 1, np.int32)
        np.cumsum(vlens, out=voffs[1:])
        inner = ListColumn(tensor(voffs),
                           column([x for v in mvals for x in v],
                                  _dt.int32))
        entries = StructColumn(
            (column(mkeys, _dt.int32), inner),
            (_dt.Field("keys", _dt.int32, False),
             _dt.Field("values", _dt.list_(_dt.int32), True)))
        c_map = MapColumn(tensor(moffs), entries)
        value = UnionColumn(tensor(type_ids), tensor(offsets),
                            (c_str, c_bool, c_big, c_mask, c_slist,
                             c_map), _sql_info_union_fields())
        name_col = from_numpy(np.asarray(ids, np.uint32), None,
                              _dt.uint32, device)
        return Table(
            [name_col, value],
            _dt.Schema((_dt.Field("info_name", _dt.uint32, False),
                        _dt.Field("value", value.dtype, False))))


def default_sql_info() -> SqlInfoData:
    """The engine's server metadata (what arrow-rs examples serve)."""
    from .. import __version__ as _ver
    return (SqlInfoData()
            .with_value(SQL_INFO_SERVER_NAME, "arrow_tpu_torch")
            .with_value(SQL_INFO_SERVER_VERSION, str(_ver))
            .with_value(SQL_INFO_SERVER_ARROW_VERSION, "56.0.0")
            .with_value(SQL_INFO_SERVER_READ_ONLY, True)
            .with_value(SQL_INFO_SERVER_TRANSACTION, 1)
            .with_value(SQL_INFO_DDL_CATALOG, False)
            .with_value(SQL_INFO_IDENTIFIER_QUOTE_CHAR, '"')
            .with_value(SQL_INFO_KEYWORDS,
                        ["SELECT", "FROM", "WHERE", "GROUP", "BY",
                         "HAVING", "ORDER", "LIMIT", "OFFSET", "JOIN"])
            .with_value(SQL_INFO_SUPPORTS_CONVERT,
                        {7: [7, 10], 10: [7, 10]}))


# ---- keys / xdbc metadata tables ---------------------------------------------

_KEYS_IMPORT_EXPORT_FIELDS = (
    ("pk_catalog_name", "utf8", True), ("pk_db_schema_name", "utf8", True),
    ("pk_table_name", "utf8", False), ("pk_column_name", "utf8", False),
    ("fk_catalog_name", "utf8", True), ("fk_db_schema_name", "utf8", True),
    ("fk_table_name", "utf8", False), ("fk_column_name", "utf8", False),
    ("key_sequence", "int32", False), ("fk_key_name", "utf8", True),
    ("pk_key_name", "utf8", True), ("update_rule", "uint8", False),
    ("delete_rule", "uint8", False))


def _typed_table(fields, rows, device) -> Table:
    from .. import dtypes as _dt
    from ..core.column import column
    cols = []
    sch = []
    for j, (name, tname, nullable) in enumerate(fields):
        d = getattr(_dt, tname)
        cols.append(column([r[j] for r in rows], d, device=device))
        sch.append(_dt.Field(name, d, nullable))
    return Table(cols, _dt.Schema(tuple(sch)))


def _primary_keys_table(rows, device) -> Table:
    return _typed_table(
        (("catalog_name", "utf8", True), ("db_schema_name", "utf8", True),
         ("table_name", "utf8", False), ("column_name", "utf8", False),
         ("key_name", "utf8", True), ("key_sequence", "int32", False)),
        rows, device)


def _xdbc_type_info_table(rows, device) -> Table:
    """CommandGetXdbcTypeInfo result (metadata/xdbc_info.rs:326) on
    `device`."""
    from .. import dtypes as _dt
    from ..core.column import column, ListColumn
    names_types = (
        ("type_name", "utf8", False), ("data_type", "int32", False),
        ("column_size", "int32", True), ("literal_prefix", "utf8", True),
        ("literal_suffix", "utf8", True), ("create_params", None, True),
        ("nullable", "int32", False), ("case_sensitive", "bool_", False),
        ("searchable", "int32", False),
        ("unsigned_attribute", "bool_", True),
        ("fixed_prec_scale", "bool_", False),
        ("auto_increment", "bool_", True),
        ("local_type_name", "utf8", True), ("minimum_scale", "int32", True),
        ("maximum_scale", "int32", True), ("sql_data_type", "int32", False),
        ("datetime_subcode", "int32", True), ("num_prec_radix", "int32", True),
        ("interval_precision", "int32", True))
    cols = []
    sch = []
    for j, (name, tname, nullable) in enumerate(names_types):
        vals = [r[j] for r in rows]
        if name == "create_params":       # list<utf8 not null>
            lens = np.array([len(v or ()) for v in vals], np.int64)
            offs = np.zeros(len(vals) + 1, np.int32)
            np.cumsum(lens, out=offs[1:])
            flat = [s for v in vals if v for s in v]
            child = column(flat, _dt.utf8, device=device)
            valid = np.array([v is not None for v in vals])
            c = ListColumn(torch.from_numpy(offs).to(device), child,
                           None if valid.all()
                           else torch.from_numpy(valid).to(device))
            d = c.dtype
        else:
            d = getattr(_dt, tname)
            c = column(vals, d, device=device)
        cols.append(c)
        sch.append(_dt.Field(name, d, nullable))
    return Table(cols, _dt.Schema(tuple(sch)))


# XDBC data_type codes (ODBC SQL_* constants used by FlightSQL)
_XDBC_TYPES = [
    # type_name, data_type, size, prefix, suffix, params, nullable(1),
    # case_sens, searchable(3), unsigned, fixed_prec, autoinc, local,
    # min_scale, max_scale, sql_data_type, subcode, radix, interval_prec
    ("BOOLEAN", 16, 1, None, None, None, 1, False, 3, None, False,
     None, "bool", None, None, 16, None, None, None),
    ("BIGINT", -5, 19, None, None, None, 1, False, 3, False, False,
     False, "int64", 0, 0, -5, None, 10, None),
    ("INTEGER", 4, 10, None, None, None, 1, False, 3, False, False,
     False, "int32", 0, 0, 4, None, 10, None),
    ("DOUBLE", 8, 15, None, None, None, 1, False, 3, False, False,
     False, "float64", None, None, 8, None, 2, None),
    ("VARCHAR", 12, 2 ** 31 - 1, "'", "'", ["length"], 1, True, 3,
     None, False, None, "utf8", None, None, 12, None, None, None),
    ("DATE", 91, 10, "'", "'", None, 1, False, 3, None, False, None,
     "date32", None, None, 9, 1, None, None),
    ("TIMESTAMP", 93, 26, "'", "'", None, 1, False, 3, None, False,
     None, "timestamp", 0, 6, 9, 3, None, None),
]


# ---- default SQL executor ------------------------------------------------------

_OPS = {"=": "eq", "==": "eq", "!=": "neq", "<>": "neq",
        "<": "lt", "<=": "lt_eq", ">": "gt", ">=": "gt_eq"}


def simple_sql_executor(tables: Dict[str, Table], query: str) -> Table:
    """Execute one SELECT against `tables` via the engine's SQL
    frontend (sql.py): expressions, AND/OR/NOT, IN/BETWEEN/
    LIKE/IS NULL, JOINs, GROUP BY/HAVING, ORDER BY, LIMIT/OFFSET —
    every clause lowers onto engine kernels, on the device of the
    tables it reads.

    The reference ships no SQL engine (sql/server.rs delegates to the
    application); this is that application-side executor."""
    from ..sql import execute_sql
    return execute_sql(tables, query)


def simple_sql_update_executor(tables: Dict[str, Table], query: str, *,
                               device=None):
    """Execute one DML/DDL statement via the engine's SQL frontend ->
    (deltas, record_count) (storage.Delta by table); `CREATE TABLE`
    makes its table on `device` (sql.execute_sql_update).  The reference delegates update
    SQL to the application (sql/server.rs:399 do_put_statement_update);
    this is that application side."""
    from ..sql import execute_sql_update
    return execute_sql_update(tables, query, device=device)


# ---- the statement gate ----------------------------------------------------------

class StatementGate:
    """The one gate every statement a FlightSQL handler executes passes,
    so that statements share one card without failing for its memory.

    Statements enter together (shared).  One that raises
    `torch.cuda.OutOfMemoryError` has published nothing (a query returns
    its table, DML applies its mutations only after its executor
    returns), so it drops what it holds, waits until no other statement
    runs, and runs again alone (exclusive); while it waits the gate
    admits no new statement.  A statement that fails alone fails.  The
    card's memory held only the statements that ran beside the failed
    one, so from then on the gate lets at most that many run together:
    the limit is learned from the failures, never set, and only falls.
    The model is spark-rapids: its GPU semaphore (GpuSemaphore, a bound
    on the tasks on one card) with retry-on-OOM (RmmRapidsRetryIterator:
    the task's work released, then retried once the other tasks are
    done).

    Take the gate outside every server lock: a statement that waits here
    while holding one could wait for a statement that needs it.

    Recorded, a statement is a `flightsql.statement` span (`kind`,
    `runs`: 1, or 2 after a re-run) and each wait a `server.admit` span
    (`mode`: shared or exclusive, `limit`: 0 while there is none); the
    counter `flightsql.reruns` counts the re-runs."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cond = threading.Condition()
        self._shared = 0            # statements running together
        self._alone = False         # a statement running alone
        self._waiting = 0           # statements waiting to run alone
        self._limit = 0             # the most to run together (0: any)

    @contextlib.contextmanager
    def _admitted(self, alone: bool):
        with trace.span("server.admit", limit=self._limit,
                        mode="exclusive" if alone else "shared"):
            with self._cond:
                if alone:
                    self._waiting += 1
                    self._cond.wait_for(
                        lambda: not self._alone and not self._shared)
                    self._waiting -= 1
                    self._alone = True
                else:
                    self._cond.wait_for(
                        lambda: not self._alone and not self._waiting
                        and (not self._limit or self._shared < self._limit))
                    self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                if alone:
                    self._alone = False
                else:
                    self._shared -= 1
                self._cond.notify_all()

    def run(self, kind: str, fn: Callable):
        """`fn()` as one statement of `kind` (query, update, prepared)."""
        with trace.span("flightsql.statement", kind=kind, runs=1) as s:
            with self._admitted(False):
                try:
                    return fn()
                except torch.cuda.OutOfMemoryError:
                    # leaving the handler drops its frames
                    with self._cond:
                        if self._shared > 1:
                            self._limit = min(self._limit or self._shared,
                                              self._shared - 1)
            if s is not None:
                s.attrs["runs"] = 2
            trace.count("flightsql.reruns")
            with self._admitted(True):
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                return fn()


# ---- versions, snapshots and transactions -----------------------------------------

class _Snapshot(dict):
    """The table versions a statement reads (name -> TableVersion) as of
    commit `commit`, and the names it looked up."""

    def __init__(self, versions: dict, commit: int):
        super().__init__(versions)
        self.commit = commit
        self.read: set = set()

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)

    def as_of(self) -> int:
        """The commit whose data an answer shows: the snapshot's, or where
        the statement read a table made by CREATE TABLE ... AS, the
        oldest snapshot such a table was made from."""
        made = [v.derived for n in self.read
                if (v := dict.get(self, n)) is not None
                and v.derived is not None]
        return min(made + [self.commit])


def _stamped(table: Table, commit: int) -> Table:
    """`table` with the commit of its snapshot in its schema's metadata
    (SNAPSHOT_KEY)."""
    meta = tuple(kv for kv in table.schema.metadata
                 if kv[0] != SNAPSHOT_KEY) + ((SNAPSHOT_KEY, str(commit)),)
    return Table(table.columns, _dt.Schema(table.schema.fields, meta),
                 _validated=True)


class _Transaction:
    """An open transaction: its age `seq` (lower: older); the versions
    its statements made (None: dropped), published together at COMMIT;
    the write locks it holds until it ends; its statements running and
    when the last ended, for its expiry; the time it began and its
    statements, for its span."""

    def __init__(self, seq: int):
        self.seq = seq
        self.versions: Dict[str, Optional[TableVersion]] = {}
        self.held: set = set()
        self.wait_ns = 0
        self.statements = self.running = 0
        self.last = time.monotonic()
        self.start_ns = time.time_ns()


# ---- server --------------------------------------------------------------------

class FlightSQLServer(FlightServer):
    """FlightService with FlightSQL command dispatch
    (sql/server.rs FlightSqlService).

    get_flight_info/do_get understand wrapped FlightSQL commands;
    do_action handles prepared-statement lifecycle.  `executor` maps
    (tables, query) -> Table and defaults to simple_sql_executor; the
    registered tables, what DML and ingest make and the metadata tables
    are on `device`.

    Every query, prepared statement, DML statement and ingest passes
    `gate` (StatementGate), so statements of concurrent handlers share
    the card.

    Tables are versions (storage.TableVersion).  A statement reads the
    versions current when the gate admits it (snapshot isolation); each
    query's result carries the commit number of that snapshot under its
    schema metadata key SNAPSHOT_KEY (for a statement over a table made
    by CREATE TABLE ... AS, the snapshot that table was made from).  A
    write (DML, DDL, ingest) takes its table's write lock before the
    gate, so a writer waits only for writers of the same table; it
    applies its delta (sql.execute_sql_update) to the current version
    and publishes the result with a new commit number.  A statement or
    ingest that carries a transaction id keeps its versions, and its
    write locks, until EndTransaction: COMMIT publishes every table the
    transaction wrote as one commit, ROLLBACK publishes nothing; its own
    later statements read what it wrote.  A transaction that holds write
    locks and needs one that an older transaction holds fails at once
    (wait-die: no two writers wait for each other), and a transaction
    idle for TXN_IDLE_S is rolled back.  `history` lists each commit's
    number and tables.  Recorded, a publish is a `table.publish` span
    (`tables`, `wait_ns`: what the statement or transaction waited for
    its write locks) and a transaction a `flightsql.transaction` span
    from its begin to its end (`statements`, `outcome`).  Each GetFlightInfo of a command runs it once and issues a
    ticket of its own (the command with the server's issue number in
    field 3 of the Any, which decoders skip), and DoGet of that ticket
    returns exactly that call's result: two clients that send the same
    text at once each read their own.  A ticket left unread holds its
    result.
    """

    def __init__(self, location: str = "grpc://0.0.0.0:0", *,
                 device,
                 executor: Optional[Callable[[Dict[str, Table], str],
                                             Table]] = None,
                 update_executor: Optional[Callable] = None,
                 substrait_executor: Optional[Callable] = None, **kw):
        super().__init__(location, device=device, **kw)
        self._executor = executor or simple_sql_executor
        self._update_executor = update_executor or (
            lambda tables, query: simple_sql_update_executor(
                tables, query, device=self.device))
        self._substrait_executor = substrait_executor
        self._prepared: Dict[bytes, str] = {}
        self._prepared_params: Dict[bytes, Table] = {}
        self._plock = threading.Lock()
        # a write lock per table, by its holder (None: a statement outside
        # a transaction): a writer takes its table's before its snapshot
        # and keeps it until it publishes (or its transaction ends), so
        # two writers of one table cannot both read a version and lose
        # one write, and appends into the shared buffers' tails come one
        # at a time
        self._writers: Dict[str, Optional[_Transaction]] = {}
        self._released = threading.Condition()
        self._ages = itertools.count()
        self._commit = 0                          # the last commit's number
        self.history = collections.deque(maxlen=1 << 16)  # (commit, tables)
        self._results: Dict[bytes, Table] = {}   # ticket -> its result
        self._issued = itertools.count(1)         # a ticket's number
        self.gate = StatementGate(self.device)
        self._cancelled: set = set()   # cancelled, until issued anew
        self._temp_tables: set = set()
        self.sql_info = default_sql_info()
        self._transactions: Dict[bytes, _Transaction] = {}
        # table -> [(column_name, key_name, seq)]
        self._primary_keys: Dict[str, list] = {}
        # (pk_table, fk_table) -> [(pk_col, fk_col, seq, update, delete)]
        self._foreign_keys: Dict[Tuple[str, str], list] = {}

    # -- catalog metadata registration ------------------------------------
    def register_primary_key(self, table: str, columns,
                             key_name: Optional[str] = None) -> None:
        self._primary_keys[table] = [
            (c, key_name, i + 1) for i, c in enumerate(columns)]

    def register_foreign_key(self, pk_table: str, fk_table: str,
                             column_pairs, update_rule: int = 3,
                             delete_rule: int = 3) -> None:
        """column_pairs: [(pk_column, fk_column)]; rules are XDBC codes
        (0 cascade, 1 restrict, 2 set-null, 3 no-action, 4 default)."""
        self._foreign_keys[(pk_table, fk_table)] = [
            (p, f, i + 1, update_rule, delete_rule)
            for i, (p, f) in enumerate(column_pairs)]

    def _fk_rows(self, pk_table=None, fk_table=None) -> list:
        rows = []
        for (pt, ft), pairs in sorted(self._foreign_keys.items()):
            if pk_table is not None and pt != pk_table:
                continue
            if fk_table is not None and ft != fk_table:
                continue
            for (pc, fc, seq, ur, dr) in pairs:
                rows.append(("default", "public", pt, pc,
                             "default", "public", ft, fc, seq,
                             f"fk_{ft}", f"pk_{pt}", ur, dr))
        return rows

    # -- tables as versions -----------------------------------------------
    @property
    def put_device(self) -> torch.device:
        """DoPut streams land on the host: an ingest maps its dictionaries
        there and its rows reach the card through pinned memory, queued
        on the stream (storage.py), so a write does not wait for the
        statements already on the card."""
        return torch.device("cpu")

    def register(self, name: str, table: Table) -> None:
        with self._lock:
            self._tables[name] = TableVersion.of(table)

    def get_table(self, name: str) -> Table:
        """The table's rows as a reader sees them now."""
        with self._lock:
            v = self._tables[name]
        return v.visible()

    def _snapshot(self, txn: Optional[_Transaction] = None) -> _Snapshot:
        """The versions current now, under an open transaction's own."""
        with self._lock:
            snap = _Snapshot(self._tables, self._commit)
        if txn is not None:
            for name, v in txn.versions.items():
                if v is None:
                    dict.pop(snap, name, None)
                else:
                    dict.__setitem__(snap, name, v)
        return snap

    @contextlib.contextmanager
    def _in_transaction(self, tid: Optional[bytes]):
        """The open transaction `tid` (None without an id) while one of
        its statements runs; it does not expire meanwhile."""
        if not tid:
            yield None
            return
        with self._plock:
            txn = self._transactions.get(tid)
            if txn is None:
                raise ArrowInvalid("unknown transaction id")
            txn.running += 1
        try:
            yield txn
        finally:
            with self._plock:
                txn.running -= 1
                txn.last = time.monotonic()

    def _lock_for_write(self, name: Optional[str],
                        txn: Optional[_Transaction]) -> int:
        """Take `name`'s write lock (a transaction keeps it to its end);
        the ns waited.  No wait closes a cycle (wait-die): a transaction
        that holds write locks and finds one held by an older
        transaction fails at once, to be rolled back and retried; any
        other writer waits.  A holder idle past TXN_IDLE_S is rolled
        back, since gRPC tells a server nothing of a client that left."""
        if name is None or (txn is not None and name in txn.held):
            return 0
        t0 = time.time_ns()
        while True:
            self._expire()
            with self._released:
                if name not in self._writers:
                    self._writers[name] = txn
                    break
                holder = self._writers[name]
                if txn is not None and txn.held and holder is not None \
                        and holder.seq < txn.seq:
                    raise ArrowInvalid(
                        f"table {name!r} is written by an older "
                        f"transaction: roll this one back and retry")
                self._released.wait(TXN_IDLE_S)
        waited = time.time_ns() - t0
        if txn is not None:
            txn.held.add(name)
            txn.wait_ns += waited
        return waited

    def _unlock(self, names) -> None:
        with self._released:
            for name in names:
                self._writers.pop(name, None)
            self._released.notify_all()

    def _expire(self) -> None:
        """Roll back the open transactions idle past TXN_IDLE_S."""
        now = time.monotonic()
        with self._plock:
            idle = [tid for tid, x in self._transactions.items()
                    if not x.running and now - x.last > TXN_IDLE_S]
            txns = [self._transactions.pop(tid) for tid in idle]
        for txn in txns:
            self._end(txn, "expired")

    def _end(self, txn: _Transaction, outcome: str) -> None:
        """Publish a committed transaction's versions (one commit), then
        release its write locks."""
        try:
            if outcome == "commit":
                self._publish(txn.versions, txn.wait_ns)
        finally:
            self._unlock(txn.held)
            trace.record("flightsql.transaction", txn.start_ns,
                         statements=txn.statements, outcome=outcome)

    def _publish(self, versions: Dict[str, Optional[TableVersion]],
                 wait_ns: int) -> None:
        """Swap in every version at once, as one commit."""
        if not versions:
            return
        names = sorted(versions)
        with trace.span("table.publish", tables=",".join(names),
                        wait_ns=wait_ns):
            with self._lock:
                self._commit += 1
                for name, v in versions.items():
                    if v is None:
                        self._tables.pop(name, None)
                        self._temp_tables.discard(name)
                    else:
                        self._tables[name] = v
                self.history.append((self._commit, tuple(names)))

    def _write(self, name: Optional[str], tid: Optional[bytes],
               kind: str, make: Callable) -> int:
        """One write to table `name` as one statement at the gate:
        `make(snapshot)` -> ({name: Delta}, count) over the versions the
        writer sees (its write lock held, taken before the gate);
        published now, or kept by the transaction `tid`."""
        with self._in_transaction(tid) as txn:
            wait_ns = self._lock_for_write(name, txn)

            def run():
                snap = self._snapshot(txn)
                deltas, n = make(snap)
                made = {}
                for tname, d in deltas.items():
                    if name is not None and tname != name:
                        raise ArrowInvalid(f"a write to {name!r} changed "
                                           f"{tname!r}")
                    made[tname] = self._applied(snap, tname, d)
                return made, n
            try:
                made, n = self.gate.run(kind, run)
                if txn is None:
                    self._publish(made, wait_ns)
                else:
                    txn.versions.update(made)
                    txn.statements += 1
            finally:
                if txn is None and name is not None:
                    self._unlock([name])
            return n

    @staticmethod
    def _applied(snap: _Snapshot, name: str, d) -> Optional[TableVersion]:
        """The version after one statement's delta (a Table from an
        executor that returns tables: the table anew; None: dropped)."""
        if d is None or (isinstance(d, Delta) and d.drop):
            return None
        if isinstance(d, Table):
            d = Delta(table=d)
        base = dict.get(snap, name)
        if d.table is not None or base is None:
            v = TableVersion.of(d.table)
            if d.derived:
                v.derived = snap.as_of()
            return v
        return base.apply(d, name)

    # -- command plumbing ------------------------------------------------
    def _run(self, query: str, kind: str = "query",
             tid: Optional[bytes] = None) -> Table:
        with self._in_transaction(tid) as txn:
            def run():
                snap = self._snapshot(txn)
                return _stamped(self._executor(snap, query), snap.as_of())
            return self.gate.run(kind, run)

    def _run_update(self, query: str, kind: str = "update",
                    tid: Optional[bytes] = None) -> int:
        """Execute DML or DDL as one write to the table it names."""
        from ..sql import update_target
        return self._write(update_target(query), tid, kind,
                           lambda snap: self._update_executor(snap, query))

    def _bound_query(self, handle: bytes) -> str:
        """Prepared handle -> query text with any bound parameter row
        substituted for its `?` placeholders."""
        with self._plock:
            q = self._prepared.get(handle)
            params = self._prepared_params.get(handle)
        if q is None:
            raise ArrowInvalid("unknown prepared statement")
        if params is not None and "?" in q:
            from ..sql import bind_sql_params
            rows = list(zip(*(c.to_pylist() for c in params.columns))) \
                or [()]
            q = bind_sql_params(q, list(rows[0]))
        return q

    def _table_for_cmd(self, cmd: bytes) -> Table:
        from ..core.column import column as _column
        name, body = _any_unpack(cmd)
        f = _parse_fields(body)

        def column(values):
            return _column(values, device=self.device)
        if name == "CommandStatementQuery":
            return self._run(f[1][0].decode(), tid=_pb_first_bytes(f, 2))
        if name == "CommandPreparedStatementQuery":
            return self._run(self._bound_query(f[1][0]), "prepared")
        if name == "CommandGetCatalogs":
            return Table.from_pydict({"catalog_name": ["default"]},
                                     device=self.device)
        if name == "CommandGetDbSchemas":
            # CommandGetDbSchemas{catalog=1, db_schema_filter_pattern=2}
            rows = [("default", "public")]
            pat = f.get(2, [b""])[0].decode() if 2 in f else None
            if pat:
                import re as _re
                rx = _re.compile("^" + _re.escape(pat)
                                 .replace("%", ".*").replace("_", ".")
                                 + "$")
                rows = [r for r in rows if rx.match(r[1])]
            return Table.from_pydict({
                "catalog_name": column([r[0] for r in rows]),
                "db_schema_name": column([r[1] for r in rows])})
        if name == "CommandGetTables":
            # CommandGetTables{catalog=1, db_schema_filter_pattern=2,
            # table_name_filter_pattern=3, table_types=4,
            # include_schema=5} — filters honored like sql/server.rs
            # expects its implementors to
            names = sorted(self._tables)
            pat = f.get(3, [b""])[0].decode() if 3 in f else None
            if pat:
                import re as _re
                rx = _re.compile(
                    "^" + _re.escape(pat).replace("%", ".*")
                    .replace("_", ".").replace("\\%", ".*")
                    .replace("\\_", ".") + "$")
                names = [n for n in names if rx.match(n)]
            want_types = [t.decode() for t in f.get(4, [])]
            if want_types and "TABLE" not in want_types:
                names = []
            include_schema = bool(_pb_first(f, 5, 0))
            cols = {
                "catalog_name": column(["default"] * len(names)),
                "db_schema_name": column(["public"] * len(names)),
                "table_name": column(names),
                "table_type": column(["TABLE"] * len(names))}
            if include_schema:
                with self._lock:
                    schemas = [schema_ipc_bytes(self._tables[n].schema)
                               for n in names]
                cols["table_schema"] = column(schemas)
            return Table.from_pydict(cols)
        if name == "CommandGetTableTypes":
            return Table.from_pydict({"table_type": column(["TABLE"])})
        if name == "CommandGetSqlInfo":
            ids = []
            for v in f.get(1, []):
                if isinstance(v, int):          # unpacked encoding
                    ids.append(v)
                else:                           # packed varints
                    from .pb import read_varint
                    i = 0
                    while i < len(v):
                        x, i = read_varint(v, i)
                        ids.append(x)
            return self.sql_info.table(ids, device=self.device)
        if name == "CommandGetPrimaryKeys":
            table = f.get(3, [b""])[0].decode()
            rows = [("default", "public", table, c, k, s)
                    for (c, k, s) in self._primary_keys.get(table, [])]
            return _primary_keys_table(rows, self.device)
        if name == "CommandGetExportedKeys":
            # keys OTHER tables import from `table` (table is the PK side)
            table = f.get(3, [b""])[0].decode()
            return _typed_table(_KEYS_IMPORT_EXPORT_FIELDS,
                                self._fk_rows(pk_table=table), self.device)
        if name == "CommandGetImportedKeys":
            # keys `table` references (table is the FK side)
            table = f.get(3, [b""])[0].decode()
            return _typed_table(_KEYS_IMPORT_EXPORT_FIELDS,
                                self._fk_rows(fk_table=table), self.device)
        if name == "CommandGetCrossReference":
            pk = f.get(3, [b""])[0].decode()
            fk = f.get(6, [b""])[0].decode()
            return _typed_table(_KEYS_IMPORT_EXPORT_FIELDS,
                                self._fk_rows(pk_table=pk, fk_table=fk),
                                self.device)
        if name == "CommandStatementSubstraitPlan":
            # the reference delegates plan execution to the application
            # (sql/server.rs do_get_statement takes the command; SQL /
            # substrait semantics are app-side).  A pluggable executor
            # receives (tables, plan_bytes, version).
            if self._substrait_executor is None:
                raise ArrowNotImplementedError(
                    "no substrait executor registered")
            pf = _parse_fields(f.get(1, [b""])[0])
            plan = pf.get(1, [b""])[0]
            version = pf.get(2, [b""])[0].decode() if 2 in pf else ""
            return self.gate.run("query", lambda: self._substrait_executor(
                {n: v.visible() for n, v in self._snapshot().items()},
                plan, version))
        if name == "CommandGetXdbcTypeInfo":
            rows = _XDBC_TYPES
            if 1 in f:
                want = f[1][0]
                want = want if isinstance(want, int) else 0
                want &= (1 << 32) - 1          # int32 over the wire
                if want >= 1 << 31:
                    want -= 1 << 32            # negative ODBC codes
                rows = [r for r in rows if r[1] == want]
            return _xdbc_type_info_table(rows, self.device)
        raise ArrowInvalid(f"unsupported FlightSQL command {name}")

    # -- Flight hook overrides (native FlightServer surface) ---------------
    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        if descriptor.type == DESCRIPTOR_CMD:
            cmd = descriptor.cmd
            table = self._table_for_cmd(cmd)
            # held for this call's ticket: execute() would otherwise run
            # the full query TWICE (FlightInfo then DoGet).  The command
            # issued anew is a new query: an earlier cancel of one of
            # its tickets no longer applies (ROADMAP C7.2)
            with self._plock:
                ticket = cmd + _varint_field(3, next(self._issued))
                self._results[ticket] = table
                self._cancelled = {t for t in self._cancelled
                                   if not t.startswith(cmd)}
            return FlightInfo(schema_ipc_bytes(table.schema), descriptor,
                              [(ticket, [self.uri])], table.num_rows, -1)
        return super().get_flight_info(descriptor)

    def do_get(self, ticket: bytes):
        """A FlightSQL ticket's one table, its statement run before the
        stream is encoded (so the statement's span is a root), or the
        plain Flight stream of a dataset's name."""
        if ticket.startswith(b"\n") and _TYPE_PREFIX.encode() in ticket:
            with self._plock:
                if ticket in self._cancelled:
                    raise KeyError("query was cancelled")
                cached = self._results.pop(ticket, None)
            return [cached if cached is not None
                    else self._table_for_cmd(ticket)]
        return (t.visible() if isinstance(t, TableVersion) else t
                for t in super().do_get(ticket))

    def do_put(self, descriptor, tables, schema=None):
        """FlightSQL DML surface (sql/server.rs:399,410
        do_put_statement_update / do_put_statement_ingest /
        do_put_prepared_statement_*): command descriptors execute DML
        or bulk-ingest the stream; path descriptors fall through to the
        plain Flight dataset registry.  Returns the PutResult
        app_metadata bytes (DoPutUpdateResult)."""
        if descriptor is None or descriptor.type != DESCRIPTOR_CMD:
            from .hostio import to_device
            return super().do_put(descriptor, [to_device(t, self.device)
                                               for t in tables],
                                  schema=schema)
        name, body = _any_unpack(descriptor.cmd)
        f = _parse_fields(body)
        if name == "CommandStatementUpdate":
            return _do_put_update_result(self._run_update(
                f[1][0].decode(), tid=_pb_first_bytes(f, 2)))
        if name == "CommandPreparedStatementUpdate":
            handle = f[1][0]
            with self._plock:
                q = self._prepared.get(handle)
            if q is None:
                raise ArrowInvalid("unknown prepared statement")
            if tables and "?" in q:
                # one execution per parameter row (client.rs bind loop)
                from ..sql import bind_sql_params
                params = _concat(tables)
                total = 0
                for row in zip(*(c.to_pylist()
                                 for c in params.columns)):
                    total += self._run_update(
                        bind_sql_params(q, list(row)), "prepared")
                return _do_put_update_result(total)
            return _do_put_update_result(self._run_update(q, "prepared"))
        if name == "CommandPreparedStatementQuery":
            # parameter binding for a later do_get: store the row batch
            # and return DoPutPreparedStatementResult{handle=1}
            handle = f[1][0]
            with self._plock:
                if handle not in self._prepared:
                    raise ArrowInvalid("unknown prepared statement")
                if tables:
                    self._prepared_params[handle] = _concat(tables)
            return _field(1, handle)    # DoPutPreparedStatementResult
        if name == "CommandStatementIngest":
            return self._ingest(f, tables, schema)
        raise ArrowInvalid(f"unsupported FlightSQL DoPut command {name}")

    def _ingest(self, f, tables, schema):
        """CommandStatementIngest semantics (FlightSql.proto
        TableDefinitionOptions): create/fail on missing target,
        fail/append/replace on existing.  APPEND writes the rows into
        the table's version (storage.TableVersion), as INSERT does; a
        transaction id keeps the write until EndTransaction."""
        tdo = _parse_fields(_pb_first_bytes(f, 1)) if 1 in f else {}
        if_not_exist = _pb_first(tdo, 1, 0)
        if_exists = _pb_first(tdo, 2, 0)
        target = f.get(2, [b""])[0].decode()
        if not target:
            raise ArrowInvalid("CommandStatementIngest needs a table")
        temporary = bool(_pb_first(f, 5, 0))
        tid = _pb_first_bytes(f, 6)
        if tables:
            data = _concat(tables)
        elif schema is not None:
            data = _empty_table(schema, self.device)
        else:
            raise ArrowInvalid("ingest stream carried no schema")
        from .hostio import to_device

        def make(snap):
            existing = dict.get(snap, target)
            if existing is None:
                if if_not_exist == 2:  # TABLE_NOT_EXIST_OPTION_FAIL
                    raise ArrowInvalid(
                        f"table {target!r} does not exist")
                if if_not_exist == 0:
                    raise ArrowInvalid(
                        "TableNotExistOption must be CREATE or FAIL")
                return {target: Delta(table=to_device(data, self.device))}, \
                    data.num_rows
            if if_exists == 1:         # TABLE_EXISTS_OPTION_FAIL
                raise ArrowInvalid(f"table {target!r} already exists")
            if if_exists == 3:         # REPLACE
                return {target: Delta(table=to_device(data, self.device))}, \
                    data.num_rows
            if if_exists != 2:         # APPEND
                raise ArrowInvalid("TableExistsOption must be FAIL, "
                                   "APPEND or REPLACE")
            if tuple(fl.dtype for fl in data.schema.fields) != \
                    tuple(fl.dtype for fl in existing.schema.fields):
                raise ArrowInvalid(
                    "ingest schema does not match existing table")
            return {target: Delta(append=data)}, data.num_rows
        n = self._write(target, tid, "ingest", make)
        if temporary:
            with self._lock:
                self._temp_tables.add(target)
        return _do_put_update_result(n)

    def do_action(self, action_type: str, body: bytes):
        if action_type == "CreatePreparedStatement":
            name, inner = _any_unpack(body)
            f = _parse_fields(inner)
            query = f[1][0].decode()
            handle = _uuid.uuid4().bytes
            with self._plock:
                self._prepared[handle] = query
            yield _any_pack("ActionCreatePreparedStatementResult",
                            _field(1, handle))
            return
        if action_type == "ClosePreparedStatement":
            name, inner = _any_unpack(body)
            f = _parse_fields(inner)
            with self._plock:
                self._prepared.pop(f[1][0], None)
            return
        if action_type == "CancelQuery":
            # deprecated-but-supported explicit cancel
            # (sql/server.rs:553 do_action_cancel_query)
            name, inner = _any_unpack(body)
            f = _parse_fields(inner)
            info = FlightInfo.decode(f.get(1, [b""])[0])
            result = 3                 # CANCEL_RESULT_NOT_CANCELLABLE
            for ticket, _locs in info.endpoints:
                if ticket.startswith(b"\n") \
                        and _TYPE_PREFIX.encode() in ticket:
                    with self._plock:
                        self._results.pop(ticket, None)
                        self._cancelled.add(ticket)
                    result = 1         # CANCEL_RESULT_CANCELLED
            yield _any_pack("ActionCancelQueryResult",
                            _varint_field(1, result))
            return
        if action_type == "CancelFlightInfo":
            # the modern core-Flight replacement (Flight.proto
            # CancelFlightInfoRequest{info=1} -> Result{status=1};
            # not Any-wrapped)
            f = _parse_fields(body)
            info = FlightInfo.decode(f.get(1, [b""])[0])
            status = 3                 # CANCEL_STATUS_NOT_CANCELLABLE
            for ticket, _locs in info.endpoints:
                with self._plock:
                    self._results.pop(ticket, None)
                    self._cancelled.add(ticket)
                status = 1             # CANCEL_STATUS_CANCELLED
            yield _varint_field(1, status)
            return
        if action_type == "BeginTransaction":
            self._expire()
            tid = _uuid.uuid4().bytes
            with self._plock:
                self._transactions[tid] = _Transaction(next(self._ages))
            yield _any_pack("ActionBeginTransactionResult",
                            _field(1, tid))
            return
        if action_type == "EndTransaction":
            name, inner = _any_unpack(body)
            f = _parse_fields(inner)
            tid = f.get(1, [b""])[0]
            end = f.get(2, [0])[0]
            if end not in (1, 2):
                raise ArrowInvalid("EndTransaction action must be "
                                   "COMMIT or ROLLBACK")
            with self._plock:
                txn = self._transactions.get(tid)
                if txn is None:
                    raise ArrowInvalid("unknown transaction id")
                if txn.running:          # its write locks are not all had
                    raise ArrowInvalid("a statement of the transaction is "
                                       "still running")
                del self._transactions[tid]
            # END_TRANSACTION_COMMIT = 1
            self._end(txn, "commit" if end == 1 else "rollback")
            return
        yield from super().do_action(action_type, body)


# ---- client --------------------------------------------------------------------

class FlightSQLClient:
    """FlightSQL client (sql/client.rs): execute / prepared statements /
    catalog metadata over any FlightSQL-speaking server — on the
    engine's own Flight transport; the tables it receives land on
    `device`."""

    def __init__(self, uri: str, *, device):
        self._client = FlightTableClient(uri, device=device)

    def _get(self, cmd: bytes) -> Table:
        info = self._client.get_flight_info(
            FlightDescriptor.for_command(cmd))
        ticket = info.endpoints[0][0]
        return _concat(self._client.do_get_ticket(ticket))

    def execute(self, query: str) -> Table:
        return self._get(cmd_statement_query(query))

    def prepare(self, query: str) -> bytes:
        results = self._client.do_action("CreatePreparedStatement",
                                         action_create_prepared(query))
        name, body = _any_unpack(results[0])
        return _parse_fields(body)[1][0]

    def execute_prepared(self, handle: bytes) -> Table:
        return self._get(cmd_prepared_statement_query(handle))

    def close_prepared(self, handle: bytes) -> None:
        self._client.do_action("ClosePreparedStatement",
                               action_close_prepared(handle))

    def get_catalogs(self) -> Table:
        return self._get(cmd_get_catalogs())

    def get_db_schemas(self, **kw) -> Table:
        return self._get(cmd_get_db_schemas(**kw))

    def get_tables(self, **kw) -> Table:
        return self._get(cmd_get_tables(**kw))

    def get_table_types(self) -> Table:
        return self._get(cmd_get_table_types())

    def get_sql_info(self, info_ids=()) -> Table:
        return self._get(cmd_get_sql_info(info_ids))

    def get_primary_keys(self, table: str, **kw) -> Table:
        return self._get(cmd_get_primary_keys(table, **kw))

    def get_exported_keys(self, table: str, **kw) -> Table:
        return self._get(cmd_get_exported_keys(table, **kw))

    def get_imported_keys(self, table: str, **kw) -> Table:
        return self._get(cmd_get_imported_keys(table, **kw))

    def get_cross_reference(self, pk_table: str, fk_table: str) -> Table:
        return self._get(cmd_get_cross_reference(pk_table, fk_table))

    def get_xdbc_type_info(self, data_type: Optional[int] = None
                           ) -> Table:
        return self._get(cmd_get_xdbc_type_info(data_type))

    def execute_update(self, query: str,
                       transaction_id: Optional[bytes] = None) -> int:
        """DoPut CommandStatementUpdate -> affected-row count
        (sql/client.rs execute_update)."""
        meta = self._client.do_put_command(
            cmd_statement_update(query, transaction_id))
        return _decode_update_result(meta)

    def execute_prepared_update(self, handle: bytes,
                                params: Optional[Table] = None) -> int:
        """DoPut CommandPreparedStatementUpdate; `params` rows bind the
        query's `?` placeholders (one execution per row)."""
        meta = self._client.do_put_command(
            cmd_prepared_statement_update(handle),
            [params] if params is not None else None)
        return _decode_update_result(meta)

    def bind_prepared(self, handle: bytes, params: Table) -> bytes:
        """DoPut CommandPreparedStatementQuery: bind a parameter batch
        for the next execute_prepared; returns the (possibly updated)
        handle from DoPutPreparedStatementResult."""
        meta = self._client.do_put_command(
            cmd_prepared_statement_query(handle), [params])
        f = _parse_fields(meta) if meta else {}
        return f.get(1, [handle])[0]

    def execute_ingest(self, table: str, tables, **kw) -> int:
        """DoPut CommandStatementIngest: bulk-load `tables` (a Table or
        list of Tables) into `table`; kwargs mirror
        cmd_statement_ingest (if_not_exist/if_exists/temporary/...)."""
        if isinstance(tables, Table):
            tables = [tables]
        meta = self._client.do_put_command(
            cmd_statement_ingest(table, **kw), list(tables))
        return _decode_update_result(meta)

    def execute_substrait(self, plan: bytes, version: str = "") -> Table:
        """Execute a serialized substrait.Plan
        (sql/client.rs execute_substrait)."""
        return self._get(cmd_statement_substrait_plan(plan, version))

    def get_query_info(self, query: str) -> FlightInfo:
        """GetFlightInfo for a statement query WITHOUT fetching results
        (the handle cancel_query needs)."""
        return self._client.get_flight_info(
            FlightDescriptor.for_command(cmd_statement_query(query)))

    def cancel_query(self, info: FlightInfo) -> int:
        """ActionCancelQuery -> CancelResult enum
        (1 = CANCELLED; sql/client.rs cancel_query)."""
        results = self._client.do_action(
            "CancelQuery", action_cancel_query(info.encode()))
        name, body = _any_unpack(results[0])
        return _pb_first(_parse_fields(body), 1, 0)

    def begin_transaction(self) -> bytes:
        results = self._client.do_action("BeginTransaction",
                                         action_begin_transaction())
        name, body = _any_unpack(results[0])
        return _parse_fields(body)[1][0]

    def commit(self, transaction_id: bytes) -> None:
        self._client.do_action(
            "EndTransaction", action_end_transaction(transaction_id,
                                                     commit=True))

    def rollback(self, transaction_id: bytes) -> None:
        self._client.do_action(
            "EndTransaction", action_end_transaction(transaction_id,
                                                     commit=False))

    def close(self):
        self._client.close()
