"""Arrow integration-test JSON format (arrow-integration-test crate;
counterpart of arrow_tpu/io/integration_json.py).

The cross-implementation golden data format driven by Apache Archery:
`{"schema": ..., "batches": [...], "dictionaries": [...]}` with physical
columns `{"name", "count", "VALIDITY", "DATA", "OFFSET", "TYPE_ID",
"children"}`.  Re-designs arrow-integration-test/src/{lib,datatype,
field,schema}.rs: type mapping per datatype.rs:254-360, column decode
per lib.rs:338-950, field/dictionary attrs per field.rs:224-290.

Value conventions (matching the C++/Rust readers):
  - 64-bit integers, decimals: JSON strings; 8/16/32-bit: numbers
  - booleans: true/false; floats: numbers
  - binary / fixed-size binary: uppercase hex strings
  - interval day_time: {"days", "milliseconds"}; month_day_nano:
    {"months", "days", "nanoseconds"}
  - VALIDITY: 0/1 ints; null type: no VALIDITY/DATA at all

Reading builds each column's buffers on the host and places them on the
caller's `device` once (`hostio.tensor`); writing takes the table's
host view once (`hostio.to_host`).  The file converters
(`json_to_arrow`, `arrow_to_json`, `validate`) stay on the host.
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           NullColumn, PrimitiveColumn, StringColumn,
                           StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, IntervalMDNColumn,
                           MapColumn, UnionColumn)
from ..core.table import Table
from ..errors import ArrowNotImplementedError, ParseError
from . import hostio

_HOST = torch.device("cpu")

_UNIT_TO_JSON = {"s": "SECOND", "ms": "MILLISECOND", "us": "MICROSECOND",
                 "ns": "NANOSECOND"}
_UNIT_FROM_JSON = {v: k for k, v in _UNIT_TO_JSON.items()}
_IVL_TO_JSON = {"year_month": "YEAR_MONTH", "day_time": "DAY_TIME",
                "month_day_nano": "MONTH_DAY_NANO"}
_IVL_FROM_JSON = {v: k for k, v in _IVL_TO_JSON.items()}


# ---- DataType <-> json (datatype.rs:254 data_type_to_json) -----------------

def dtype_to_json(d: dt.DataType) -> Dict[str, Any]:
    n = d.name
    if n == "null":
        return {"name": "null"}
    if n == "bool":
        return {"name": "bool"}
    if d.is_integer:
        return {"name": "int", "bitWidth": d.bit_width,
                "isSigned": d.is_signed_integer}
    if d.is_floating:
        prec = {"float16": "HALF", "float32": "SINGLE",
                "float64": "DOUBLE"}[n]
        return {"name": "floatingpoint", "precision": prec}
    if n == "utf8":
        return {"name": "utf8"}
    if n == "large_utf8":
        return {"name": "largeutf8"}
    if n == "binary":
        return {"name": "binary"}
    if n == "large_binary":
        return {"name": "largebinary"}
    if n == "fixed_size_binary":
        return {"name": "fixedsizebinary", "byteWidth": d.list_size}
    if n == "date32":
        return {"name": "date", "unit": "DAY"}
    if n == "date64":
        return {"name": "date", "unit": "MILLISECOND"}
    if n in ("time32", "time64"):
        return {"name": "time", "bitWidth": 32 if n == "time32" else 64,
                "unit": _UNIT_TO_JSON[d.unit]}
    if n == "timestamp":
        out = {"name": "timestamp", "unit": _UNIT_TO_JSON[d.unit]}
        if d.tz is not None:
            out["timezone"] = d.tz
        return out
    if n == "duration":
        return {"name": "duration", "unit": _UNIT_TO_JSON[d.unit]}
    if n == "interval":
        return {"name": "interval", "unit": _IVL_TO_JSON[d.unit]}
    if d.is_decimal:
        return {"name": "decimal", "precision": d.precision,
                "scale": d.scale, "bitWidth": int(n[len("decimal"):])}
    if n == "list":
        return {"name": "list"}
    if n == "large_list":
        return {"name": "largelist"}
    if n == "fixed_size_list":
        return {"name": "fixedsizelist", "listSize": d.list_size}
    if n == "struct":
        return {"name": "struct"}
    if n == "map":
        return {"name": "map", "keysSorted": False}
    if n == "union":
        return {"name": "union", "mode": d.mode.upper(),
                "typeIds": list(d.type_ids)}
    raise ArrowNotImplementedError(f"integration json type {d!r}")


def dtype_from_json(t: Dict[str, Any],
                    children: Sequence[dt.Field]) -> dt.DataType:
    n = t.get("name")
    if n == "null":
        return dt.null
    if n == "bool":
        return dt.bool_
    if n == "int":
        sign = "int" if t["isSigned"] else "uint"
        return getattr(dt, f"{sign}{t['bitWidth']}")
    if n == "floatingpoint":
        return {"HALF": dt.float16, "SINGLE": dt.float32,
                "DOUBLE": dt.float64}[t["precision"]]
    if n == "utf8":
        return dt.utf8
    if n == "largeutf8":
        return dt.large_utf8
    if n == "binary":
        return dt.binary
    if n == "largebinary":
        return dt.large_binary
    if n == "fixedsizebinary":
        return dt.fixed_size_binary(t["byteWidth"])
    if n == "date":
        return dt.date32 if t["unit"] == "DAY" else dt.date64
    if n == "time":
        u = _UNIT_FROM_JSON[t["unit"]]
        return dt.time32(u) if t["bitWidth"] == 32 else dt.time64(u)
    if n == "timestamp":
        return dt.timestamp(_UNIT_FROM_JSON[t["unit"]], t.get("timezone"))
    if n == "duration":
        return dt.duration(_UNIT_FROM_JSON[t["unit"]])
    if n == "interval":
        return dt.interval(_IVL_FROM_JSON[t["unit"]])
    if n == "decimal":
        w = t.get("bitWidth", 128)
        return getattr(dt, f"decimal{w}")(t["precision"], t["scale"])
    if n == "list":
        return dt.list_(children[0].dtype)
    if n == "largelist":
        return dt.large_list(children[0].dtype)
    if n == "fixedsizelist":
        return dt.fixed_size_list(children[0].dtype, t["listSize"])
    if n == "struct":
        return dt.struct(list(children))
    if n == "map":
        kv = children[0].dtype        # the entries struct
        return dt.map_(kv.fields[0].dtype, kv.fields[1].dtype)
    if n == "union":
        return dt.union(list(children), t["mode"].lower(),
                        tuple(t["typeIds"]))
    raise ParseError(f"invalid or unsupported type name: {n}")


# ---- Field / Schema <-> json (field.rs:224, schema.rs) ---------------------

class _DictRegistry:
    """Assigns dictionary ids on write; collects value columns."""

    def __init__(self):
        self.next_id = 0
        self.entries: List[Tuple[int, dt.DataType, Column]] = []

    def register(self, value_dtype: dt.DataType, values: Column) -> int:
        i = self.next_id
        self.next_id += 1
        self.entries.append((i, value_dtype, values))
        return i


def _field_to_json(f: dt.Field, col: Optional[Column],
                   reg: Optional[_DictRegistry]) -> Dict[str, Any]:
    d = f.dtype
    out: Dict[str, Any] = {"name": f.name, "nullable": f.nullable}
    if d.is_dictionary:
        # "type" is the VALUE type; index rides in "dictionary"
        # (field.rs:224-236)
        vals_col = col.values if isinstance(col, DictionaryColumn) else None
        did = reg.register(d.value_type, vals_col) if reg is not None else 0
        out["type"] = dtype_to_json(d.value_type)
        out["children"] = _child_fields_json(d.value_type, vals_col, reg)
        out["dictionary"] = {"id": did,
                             "indexType": dtype_to_json(d.index_type),
                             "isOrdered": False}
    else:
        out["type"] = dtype_to_json(d)
        out["children"] = _child_fields_json(d, col, reg)
    if f.metadata:
        out["metadata"] = [{"key": k, "value": v} for k, v in f.metadata]
    return out


def _child_fields_json(d: dt.DataType, col: Optional[Column],
                       reg: Optional[_DictRegistry]) -> List[Dict[str, Any]]:
    def child_col(i):
        if col is None:
            return None
        if isinstance(col, (ListColumn,)):
            return col.child
        if isinstance(col, FixedSizeListColumn):
            return col.child
        if isinstance(col, MapColumn):
            return col.entries
        if isinstance(col, (StructColumn, UnionColumn)):
            return col.children[i]
        return None

    if d.name in ("list", "large_list", "fixed_size_list"):
        return [_field_to_json(dt.Field("item", d.value_type), child_col(0),
                               reg)]
    if d.name == "map":
        return [_field_to_json(dt.Field("entries", d.value_type,
                                        nullable=False), child_col(0), reg)]
    if d.name in ("struct", "union"):
        return [_field_to_json(f, child_col(i), reg)
                for i, f in enumerate(d.fields)]
    return []


def field_from_json(obj: Dict[str, Any]) -> Tuple[dt.Field, Dict[int, dt.DataType]]:
    """Returns (field, {dict_id: value_dtype}) for dictionary wiring."""
    dict_types: Dict[int, dt.DataType] = {}
    children = []
    for c in obj.get("children", []):
        cf, sub = field_from_json(c)
        children.append(cf)
        dict_types.update(sub)
    base = dtype_from_json(obj["type"], children)
    if "dictionary" in obj and obj["dictionary"] is not None:
        dct = obj["dictionary"]
        idx = dtype_from_json(dct["indexType"], [])
        dict_types[dct["id"]] = base
        base = dt.dictionary(idx, base)
        # dict ids live only in the SCHEMA field tree; nested dictionary
        # columns (struct<dict>, list<dict>) are rebuilt from dtypes, so
        # carry the id on the parsed dtype INSTANCE (identity-preserved
        # through dtype_from_json composition; frozen dataclass -> via
        # object.__setattr__, hash/eq unaffected)
        object.__setattr__(base, "_integration_dict_id", dct["id"])
    md = obj.get("metadata")
    meta: Tuple[Tuple[str, str], ...] = ()
    if isinstance(md, list):
        meta = tuple((e["key"], e["value"]) for e in md)
    elif isinstance(md, dict):
        meta = tuple(md.items())
    return dt.Field(obj["name"], base, obj.get("nullable", True),
                    meta), dict_types


# ---- column -> json (the from_batch role, lib.rs:1046, completed) ----------

def _validity_list(col: Column) -> List[int]:
    n = len(col)
    if col.validity is None:
        return [1] * n
    return [int(x) for x in hostio.host(col.validity).view(np.uint8)]


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _string_parts(col: StringColumn):
    offs = hostio.host(col.offsets).astype(np.int64)
    data = hostio.host(col.data).tobytes()
    return offs, data


def column_to_json(col: Column, name: str,
                   reg: Optional[_DictRegistry] = None) -> Dict[str, Any]:
    n = len(col)
    out: Dict[str, Any] = {"name": name, "count": n}
    d = col.dtype

    if isinstance(col, NullColumn):
        return out

    if isinstance(col, DictionaryColumn):
        out["VALIDITY"] = _validity_list(col)
        out["DATA"] = [int(x) for x in hostio.host(col.codes)]
        return out

    out["VALIDITY"] = _validity_list(col)

    if isinstance(col, PrimitiveColumn):
        v = hostio.values(col)
        if d.is_boolean:
            out["DATA"] = [bool(x) for x in v]
        elif d.name == "interval" and d.unit == "day_time":
            days = (v.astype(np.int64) >> 32).astype(np.int32)
            ms = v.astype(np.int64).astype(np.uint64).astype(np.uint32) \
                .astype(np.int32)
            out["DATA"] = [{"days": int(a), "milliseconds": int(b)}
                           for a, b in zip(days, ms)]
        elif d.is_floating:
            out["DATA"] = [float(x) for x in v.astype(np.float64)]
        elif d.name in ("decimal32", "decimal64"):
            out["DATA"] = [str(int(x)) for x in v]
        elif v.dtype.itemsize == 8:          # 64-bit ints as strings
            out["DATA"] = [str(int(x)) for x in v]
        else:
            out["DATA"] = [int(x) for x in v]
        return out

    if isinstance(col, IntervalMDNColumn):
        out["DATA"] = [{"months": int(m), "days": int(dd),
                        "nanoseconds": int(nn)}
                       for m, dd, nn in zip(hostio.host(col.months),
                                            hostio.host(col.days),
                                            hostio.host(col.nanos))]
        return out

    if isinstance(col, DecimalColumn):
        limbs = hostio.host(col.limbs).view(np.uint64)
        k = limbs.shape[1]
        vals = []
        for row in limbs:
            x = 0
            for j in range(k - 1, -1, -1):
                x = (x << 64) | int(row[j])
            if x >= 1 << (64 * k - 1):
                x -= 1 << (64 * k)
            vals.append(str(x))
        out["DATA"] = vals
        return out

    if isinstance(col, FixedSizeBinaryColumn):
        data = hostio.host(col.data)
        out["DATA"] = [_hex(row.tobytes()) for row in data]
        return out

    if isinstance(col, StringColumn):
        offs, data = _string_parts(col)
        wide = d.name in ("large_utf8", "large_binary")
        out["OFFSET"] = [str(int(o)) if wide else int(o) for o in offs]
        if d.is_string:
            out["DATA"] = [data[offs[i]:offs[i + 1]].decode("utf-8")
                           for i in range(n)]
        else:
            out["DATA"] = [_hex(data[offs[i]:offs[i + 1]])
                           for i in range(n)]
        return out

    if isinstance(col, (ListColumn, MapColumn)):
        offs = hostio.host(col.offsets)
        wide = d.name == "large_list"
        out["OFFSET"] = [str(int(o)) if wide else int(o) for o in offs]
        child = col.child if isinstance(col, ListColumn) else col.entries
        cname = "item" if isinstance(col, ListColumn) else "entries"
        out["children"] = [column_to_json(child, cname, reg)]
        return out

    if isinstance(col, FixedSizeListColumn):
        out["children"] = [column_to_json(col.child, "item", reg)]
        return out

    if isinstance(col, StructColumn):
        out["children"] = [column_to_json(c, f.name, reg)
                           for c, f in zip(col.children, col.fields)]
        return out

    if isinstance(col, UnionColumn):
        del out["VALIDITY"]            # unions carry no validity
        out["TYPE_ID"] = [int(x) for x in hostio.host(col.type_ids)]
        if col.offsets is not None:
            out["OFFSET"] = [int(x) for x in hostio.host(col.offsets)]
        out["children"] = [column_to_json(c, f.name, reg)
                           for c, f in zip(col.children, col.fields)]
        return out

    raise ArrowNotImplementedError(
        f"integration json write of {type(col).__name__}")


# ---- json -> column (array_from_json, lib.rs:338) --------------------------

def _parse_i64(x) -> int:
    return int(x) if not isinstance(x, str) else int(x, 10)


def column_from_json(obj: Dict[str, Any], field: dt.Field,
                     dictionaries: Dict[int, Column],
                     device: DeviceLike) -> Column:
    """One integration-JSON column on `device`."""
    dev = resolve_device(device)

    def on(a: np.ndarray) -> torch.Tensor:
        return hostio.tensor(a, dev)

    d = field.dtype
    n = int(obj["count"])

    if d.is_null:
        return NullColumn(n, dev)

    validity = obj.get("VALIDITY")
    mask = None
    if validity is not None and (0 in validity):
        mask = on(np.asarray(validity, np.uint8).astype(bool))

    if d.is_dictionary:
        codes = np.asarray([_parse_i64(x) for x in obj["DATA"]],
                           d.index_type.to_numpy())
        vals = dictionaries[_dict_id_of(field)]
        return DictionaryColumn(on(_storage(codes, d.index_type)), vals,
                                mask)

    data = obj.get("DATA")

    if isinstance(d, dt.DataType) and d.name == "interval" \
            and d.unit == "month_day_nano":
        m = [e["months"] if isinstance(e, dict) else 0 for e in data]
        dd = [e["days"] if isinstance(e, dict) else 0 for e in data]
        nn = [e["nanoseconds"] if isinstance(e, dict) else 0 for e in data]
        return IntervalMDNColumn(on(np.asarray(m, np.int32)),
                                 on(np.asarray(dd, np.int32)),
                                 on(np.asarray(nn, np.int64)), mask)

    if d.name == "interval" and d.unit == "day_time":
        days = np.asarray([e["days"] if isinstance(e, dict) else 0
                           for e in data], np.int64)
        ms = np.asarray([e["milliseconds"] if isinstance(e, dict) else 0
                         for e in data], np.int64)
        packed = (days << 32) | (ms & 0xFFFFFFFF)
        return PrimitiveColumn(on(_storage(packed, d)), d, mask)

    if d.name in ("decimal128", "decimal256"):
        k = 2 if d.name == "decimal128" else 4
        limbs = np.zeros((n, k), np.uint64)
        for i, s in enumerate(data):
            x = _parse_i64(s)
            if x < 0:
                x += 1 << (64 * k)
            for j in range(k):
                limbs[i, j] = (x >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
        return DecimalColumn(on(limbs.view(np.int64)), d, mask)

    if d.name == "fixed_size_binary":
        rows = np.zeros((n, d.list_size), np.uint8)
        for i, s in enumerate(data):
            b = bytes.fromhex(s)
            rows[i, :len(b)] = np.frombuffer(b, np.uint8)
        return FixedSizeBinaryColumn(on(rows), mask)

    if d.is_string or d.is_binary:
        offs = np.asarray([_parse_i64(x) for x in obj["OFFSET"]],
                          np.int64 if d.name.startswith("large") else np.int32)
        parts = []
        for i, s in enumerate(data):
            parts.append(s.encode("utf-8") if d.is_string
                         else bytes.fromhex(s))
        blob = b"".join(parts)
        return StringColumn(on(offs), on(np.frombuffer(blob, np.uint8)), d,
                            mask)

    if d.name in ("list", "large_list"):
        offs = np.asarray([_parse_i64(x) for x in obj["OFFSET"]],
                          np.int64 if d.name == "large_list" else np.int32)
        cf = dt.Field("item", d.value_type)
        child = column_from_json(obj["children"][0], cf, dictionaries, dev)
        return ListColumn(on(offs), child, mask,
                          large=d.name == "large_list")

    if d.name == "fixed_size_list":
        cf = dt.Field("item", d.value_type)
        child = column_from_json(obj["children"][0], cf, dictionaries, dev)
        return FixedSizeListColumn(child, d.list_size, mask)

    if d.name == "map":
        offs = np.asarray([_parse_i64(x) for x in obj["OFFSET"]], np.int32)
        cf = dt.Field("entries", d.value_type, nullable=False)
        entries = column_from_json(obj["children"][0], cf, dictionaries, dev)
        return MapColumn(on(offs), entries, mask)

    if d.name == "struct":
        kids = [column_from_json(c, f, dictionaries, dev)
                for c, f in zip(obj["children"], d.fields)]
        return StructColumn(tuple(kids), tuple(d.fields), mask)

    if d.name == "union":
        tids = on(np.asarray(obj["TYPE_ID"], np.int8))
        offs = None
        if d.mode == "dense":
            offs = on(np.asarray(obj["OFFSET"], np.int32))
        kids = [column_from_json(c, f, dictionaries, dev)
                for c, f in zip(obj["children"], d.fields)]
        return UnionColumn(tids, offs, kids, tuple(d.fields),
                           tuple(d.type_ids))

    # remaining primitives
    np_dt = d.to_numpy()
    if d.is_boolean:
        arr = np.asarray([bool(x) for x in data], bool)
    elif d.is_floating:
        arr = np.asarray([float(x) for x in data], np.float64).astype(np_dt)
    elif d.name == "uint64":
        arr = np.asarray([_parse_i64(x) for x in data], np.uint64)
    else:
        arr = np.asarray([_parse_i64(x) for x in data], np.int64) \
            .astype(np_dt)
    return PrimitiveColumn(on(_storage(arr, d)), d, mask)


def _storage(a: np.ndarray, d: dt.DataType) -> np.ndarray:
    """Logical numpy values at the port's storage dtype (unsigned types
    are held on signed storage of the same width)."""
    return a.astype(d.to_numpy(), copy=False).view(
        dt.torch_dtype_name(d.to_torch()))


def _dict_id_of(field: dt.Field) -> int:
    # the parsed dtype instance carries the id (field_from_json); the
    # metadata key covers fields reconstructed from metadata round-trips
    did = getattr(field.dtype, "_integration_dict_id", None)
    if did is not None:
        return int(did)
    for k, v in field.metadata:
        if k == "__dict_id":
            return int(v)
    return 0


# ---- top level: ArrowJson {schema, batches, dictionaries} ------------------

def table_to_json(table: Table) -> Dict[str, Any]:
    """One-batch ArrowJson document (lib.rs:57 ArrowJson)."""
    table = hostio.to_host(table)
    reg = _DictRegistry()
    fields = []
    for f, col in zip(table.schema.fields, table.columns):
        fields.append(_field_to_json(f, col, reg))
    schema_obj: Dict[str, Any] = {"fields": fields}
    md = getattr(table.schema, "metadata", ())
    if md:
        schema_obj["metadata"] = [{"key": k, "value": v} for k, v in md]
    batch = {"count": len(table),
             "columns": [column_to_json(c, f.name, reg)
                         for c, f in zip(table.columns,
                                         table.schema.fields)]}
    doc: Dict[str, Any] = {"schema": schema_obj, "batches": [batch]}
    if reg.entries:
        dicts = []
        for did, vdt, vcol in reg.entries:
            dicts.append({"id": did,
                          "data": {"count": len(vcol),
                                   "columns": [column_to_json(
                                       vcol, f"DICT{did}", None)]}})
        doc["dictionaries"] = dicts
    return doc


def table_from_json(doc: Dict[str, Any], *, device: DeviceLike) -> Table:
    """Parse an ArrowJson document onto `device`; batches concatenate."""
    dev = resolve_device(device)
    fields = []
    all_dict_types: Dict[int, dt.DataType] = {}
    for fo in doc["schema"]["fields"]:
        f, dts = field_from_json(fo)
        if f.dtype.is_dictionary and "dictionary" in fo:
            f = dt.Field(f.name, f.dtype, f.nullable,
                         f.metadata + (("__dict_id",
                                        str(fo["dictionary"]["id"])),))
        fields.append(f)
        all_dict_types.update(dts)

    dictionaries: Dict[int, Column] = {}
    for dobj in doc.get("dictionaries", []) or []:
        did = dobj["id"]
        vdt = all_dict_types[did]
        vcol = column_from_json(dobj["data"]["columns"][0],
                                dt.Field("values", vdt), dictionaries, dev)
        dictionaries[did] = vcol

    batches = doc.get("batches", [])
    tables = []
    for b in batches:
        cols = [column_from_json(co, f, dictionaries, dev)
                for co, f in zip(b["columns"], fields)]
        clean = [dt.Field(f.name, f.dtype, f.nullable,
                          tuple(kv for kv in f.metadata
                                if kv[0] != "__dict_id"))
                 for f in fields]
        tables.append(Table(cols, dt.Schema(tuple(clean))))
    if not tables:
        clean = [dt.Field(f.name, f.dtype, f.nullable,
                          tuple(kv for kv in f.metadata
                                if kv[0] != "__dict_id"))
                 for f in fields]
        return Table([NullColumn(0, dev) if f.dtype.is_null else
                      _empty_col(f.dtype, dev) for f in clean],
                     dt.Schema(tuple(clean)))
    if len(tables) == 1:
        return tables[0]
    from ..ops.concat import concat_tables
    return concat_tables(tables)


def _empty_col(d: dt.DataType, device: DeviceLike) -> Column:
    """A column of type `d` and no rows on `device`."""
    from ..ops.cast import _all_null
    return _all_null(d, 0, resolve_device(device))


# ---- file helpers (arrow-json-integration-test binary roles) ---------------

def write_json_file(path: str, table: Table) -> None:
    with open(path, "w") as f:
        _json.dump(table_to_json(table), f)


def read_json_file(path: str, *, device: DeviceLike) -> Table:
    with open(path) as f:
        return table_from_json(_json.load(f), device=device)


def json_to_arrow(json_path: str, arrow_path: str) -> None:
    """arrow-json-integration-test JSON_TO_ARROW mode."""
    from .ipc import write_file
    write_file(arrow_path, [read_json_file(json_path, device=_HOST)])


def arrow_to_json(arrow_path: str, json_path: str) -> None:
    """arrow-json-integration-test ARROW_TO_JSON mode."""
    from .ipc import read_file
    from ..ops.concat import concat_tables
    tables = read_file(arrow_path, _HOST)
    write_json_file(json_path, tables[0] if len(tables) == 1
                    else concat_tables(tables))


def validate(arrow_path: str, json_path: str) -> bool:
    """VALIDATE mode: arrow file content equals the json golden."""
    from .ipc import read_file
    from ..ops.concat import concat_tables
    ts = read_file(arrow_path, _HOST)
    a = ts[0] if len(ts) == 1 else concat_tables(ts)
    j = read_json_file(json_path, device=_HOST)
    return a.to_pydict() == j.to_pydict()
