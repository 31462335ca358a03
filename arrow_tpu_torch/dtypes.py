"""Logical type system of the port (counterpart of arrow_tpu/dtypes.py).

The reference's logical-type vocabulary: null, bool, the signed and
unsigned integers, float16/32/64, the temporal types (date32/64,
timestamp, time32/64, duration and the three intervals: integer storage
plus unit and timezone metadata), utf8 and dictionary, decimal32/64/128/
256, fixed_size_binary, the list family, struct, map, union and
run_end_encoded; the large, view and binary string types (their columns
are core/column.py's StringColumn); and the canonical extension types,
which ride field metadata (`ExtensionType`).  `to_torch` takes the place of
`to_jax` (arrow_tpu/dtypes.py:142): decimal32/64 are one int32/int64
tensor; decimal128/256 and interval[month_day_nano] are several
(core/nested.py) and have none.

Unsigned storage: torch's uint16/uint32/uint64 reject `+`, `<`, `>>`
and `max`, so Arrow's unsigned types live on signed storage of the same
width holding the same bits (uint8 keeps torch.uint8, which supports
everything).  Anything that orders unsigned values goes through the
sign-flip map; `to_numpy` names the logical numpy dtype for host views.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DataType", "null", "bool_", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
    "utf8", "large_utf8", "utf8_view", "binary", "large_binary",
    "binary_view", "fixed_size_binary", "date32", "date64", "timestamp",
    "time32", "time64", "duration", "interval", "decimal32", "decimal64",
    "decimal128", "decimal256", "dictionary", "list_", "large_list",
    "list_view", "large_list_view", "fixed_size_list", "struct", "map_",
    "union", "run_end_encoded", "Field", "Schema", "ExtensionType", "uuid",
    "json_", "bool8", "fixed_shape_tensor", "opaque", "from_numpy_dtype",
    "torch_dtype_name", "widen", "storage_int", "integer_bounds",
    "INT_MIN", "INT_MAX", "UINT_MAX",
]


@dataclass(frozen=True)
class DataType:
    """A logical Arrow data type (cf. arrow-schema/src/datatype.rs:97)."""

    name: str
    index_type: Optional["DataType"] = None   # dictionary key / run-end type
    value_type: Optional["DataType"] = None   # dictionary / list value type
    # dictionary: values are sorted and code order IS value order
    ordered: Optional[bool] = None
    unit: Optional[str] = None                # temporal unit
    tz: Optional[str] = None                  # timestamp timezone
    precision: Optional[int] = None           # decimal precision
    scale: Optional[int] = None               # decimal scale
    fields: Optional[Tuple["Field", ...]] = None   # struct / union children
    list_size: Optional[int] = None           # fixed-size list / binary
    mode: Optional[str] = None                # union: 'sparse' | 'dense'
    type_ids: Optional[Tuple[int, ...]] = None     # union child type ids

    @property
    def is_integer(self) -> bool:
        return self.name in _INT_NAMES

    @property
    def is_signed_integer(self) -> bool:
        return self.name in ("int8", "int16", "int32", "int64")

    @property
    def is_unsigned_integer(self) -> bool:
        return self.name in ("uint8", "uint16", "uint32", "uint64")

    @property
    def is_floating(self) -> bool:
        return self.name in ("float16", "float32", "float64")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_decimal(self) -> bool:
        return self.name in _DECIMAL_LIMBS

    @property
    def is_temporal(self) -> bool:
        return self.name in _TEMPORAL_NAMES

    @property
    def is_boolean(self) -> bool:
        return self.name == "bool"

    @property
    def is_string(self) -> bool:
        return self.name in ("utf8", "large_utf8", "utf8_view")

    @property
    def is_binary(self) -> bool:
        return self.name in ("binary", "large_binary", "binary_view",
                             "fixed_size_binary")

    @property
    def is_run_end_encoded(self) -> bool:
        return self.name == "run_end_encoded"

    @property
    def is_union(self) -> bool:
        return self.name == "union"

    @property
    def is_nested(self) -> bool:
        return self.name in ("list", "large_list", "list_view",
                             "large_list_view", "fixed_size_list",
                             "struct", "map", "union", "run_end_encoded")

    @property
    def is_null(self) -> bool:
        return self.name == "null"

    @property
    def is_dictionary(self) -> bool:
        return self.name == "dictionary"

    @property
    def is_primitive(self) -> bool:
        """Fixed-width, single-tensor representable (decimals and
        interval[month_day_nano] are not, as in the reference)."""
        if self.is_decimal or self.unit == "month_day_nano":
            return False
        return self.is_numeric or self.is_boolean or self.is_temporal

    @property
    def is_single_tensor(self) -> bool:
        """A PrimitiveColumn's type: the primitives and decimal32/64."""
        return self.is_primitive or self.name in ("decimal32", "decimal64")

    def to_torch(self) -> torch.dtype:
        """torch dtype of the physical value tensor (signed storage for
        uint16/32/64)."""
        if self.name == "dictionary":
            return self.index_type.to_torch()
        if self.name == "interval" and self.unit in _INTERVAL_TORCH:
            return _INTERVAL_TORCH[self.unit]
        m = _TORCH_DTYPE.get(self.name)
        if m is None:
            raise TypeError(f"{self} has no single-tensor physical dtype")
        return m

    def to_numpy(self) -> np.dtype:
        """Logical numpy dtype: the host view of the storage bits."""
        if self.name == "dictionary":
            return self.index_type.to_numpy()
        if self.is_temporal or self.is_decimal:
            return self.storage_numpy()
        if self.name not in _TORCH_DTYPE:
            raise TypeError(f"{self} has no single-tensor physical dtype")
        return np.dtype(self.name)

    def storage_numpy(self) -> np.dtype:
        """numpy dtype of the storage bits (signed for uint16/32/64)."""
        return np.dtype(torch_dtype_name(self.to_torch()))

    @property
    def byte_width(self) -> int:
        """Bytes per value of a fixed-width type; the multi-tensor ones
        count all their planes (decimal128 16, decimal256 32,
        interval[month_day_nano] 16, fixed_size_binary(w) w)."""
        if self.name in _DECIMAL_LIMBS and _DECIMAL_LIMBS[self.name]:
            return 8 * _DECIMAL_LIMBS[self.name]
        if self.unit == "month_day_nano":
            return 16
        if self.name == "fixed_size_binary":
            return self.list_size
        return self.to_numpy().itemsize

    @property
    def bit_width(self) -> int:
        return 1 if self.name == "bool" else self.byte_width * 8

    def __repr__(self) -> str:
        if self.name == "dictionary":
            return f"dictionary<{self.index_type!r}, {self.value_type!r}>"
        if self.name == "timestamp":
            return f"timestamp[{self.unit}{', tz=' + self.tz if self.tz else ''}]"
        if self.unit is not None:
            return f"{self.name}[{self.unit}]"
        if self.is_decimal:
            return f"{self.name}({self.precision}, {self.scale})"
        if self.name == "fixed_size_binary":
            return f"fixed_size_binary({self.list_size})"
        if self.name in ("list", "large_list", "list_view",
                         "large_list_view"):
            return f"{self.name}<{self.value_type!r}>"
        if self.name == "fixed_size_list":
            return f"fixed_size_list<{self.value_type!r}, {self.list_size}>"
        if self.name in ("struct", "union"):
            inner = ", ".join(f"{f.name}: {f.dtype!r}"
                              for f in self.fields or ())
            return f"struct<{inner}>" if self.name == "struct" \
                else f"union<{inner}; mode={self.mode}>"
        if self.name == "run_end_encoded":
            return f"run_end_encoded<{self.index_type!r}, {self.value_type!r}>"
        return self.name


_INT_NAMES = ("int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64")

_TORCH_DTYPE = {
    "bool": torch.bool,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.int16, "uint32": torch.int32,
    "uint64": torch.int64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64,
    "date32": torch.int32, "date64": torch.int64, "timestamp": torch.int64,
    "time32": torch.int32, "time64": torch.int64, "duration": torch.int64,
    "decimal32": torch.int32, "decimal64": torch.int64,
}

# interval storage by unit: year_month i32 months, day_time i64
# (days << 32 | millis); month_day_nano is three tensors
# (core/nested.py IntervalMDNColumn)
_INTERVAL_TORCH = {"year_month": torch.int32, "day_time": torch.int64}

# u64 limb planes per decimal (0: one int32/int64 tensor)
_DECIMAL_LIMBS = {"decimal32": 0, "decimal64": 0, "decimal128": 2,
                  "decimal256": 4}

_TEMPORAL_NAMES = ("date32", "date64", "timestamp", "time32", "time64",
                   "duration", "interval")

null = DataType("null")
bool_ = DataType("bool")
int8 = DataType("int8")
int16 = DataType("int16")
int32 = DataType("int32")
int64 = DataType("int64")
uint8 = DataType("uint8")
uint16 = DataType("uint16")
uint32 = DataType("uint32")
uint64 = DataType("uint64")
float16 = DataType("float16")
float32 = DataType("float32")
float64 = DataType("float64")
utf8 = DataType("utf8")
large_utf8 = DataType("large_utf8")
utf8_view = DataType("utf8_view")
binary = DataType("binary")
large_binary = DataType("large_binary")
binary_view = DataType("binary_view")
date32 = DataType("date32")
date64 = DataType("date64")


def _unit(name: str, unit: str, units) -> str:
    if unit not in units:
        from .errors import ArrowNotImplementedError
        raise ArrowNotImplementedError(f"{name}[{unit}] (units: {units})")
    return unit


def timestamp(unit: str = "us", tz: Optional[str] = None) -> DataType:
    return DataType("timestamp", unit=_unit("timestamp", unit,
                                            ("s", "ms", "us", "ns")), tz=tz)


def time32(unit: str = "s") -> DataType:
    return DataType("time32", unit=_unit("time32", unit, ("s", "ms")))


def time64(unit: str = "us") -> DataType:
    return DataType("time64", unit=_unit("time64", unit, ("us", "ns")))


def duration(unit: str = "us") -> DataType:
    return DataType("duration", unit=_unit("duration", unit,
                                           ("s", "ms", "us", "ns")))


def interval(unit: str = "month_day_nano") -> DataType:
    """Interval(YearMonth | DayTime | MonthDayNano) (arrow-buffer/src/
    interval.rs); month_day_nano is IntervalMDNColumn's three tensors."""
    return DataType("interval", unit=_unit(
        "interval", unit, ("year_month", "day_time", "month_day_nano")))


def fixed_size_binary(byte_width: int) -> DataType:
    """FixedSizeBinary(w); the width rides in `list_size`."""
    return DataType("fixed_size_binary", list_size=int(byte_width))


def _decimal(name: str, most: int, precision: int, scale: int) -> DataType:
    if not 1 <= precision <= most:
        from .errors import ArrowInvalid
        raise ArrowInvalid(f"{name} precision {precision} outside 1..{most}")
    return DataType(name, precision=int(precision), scale=int(scale))


def decimal32(precision: int, scale: int) -> DataType:
    return _decimal("decimal32", 9, precision, scale)


def decimal64(precision: int, scale: int) -> DataType:
    return _decimal("decimal64", 18, precision, scale)


def decimal128(precision: int, scale: int) -> DataType:
    return _decimal("decimal128", 38, precision, scale)


def decimal256(precision: int, scale: int) -> DataType:
    """256-bit decimal: four little-endian u64 limb planes."""
    return _decimal("decimal256", 76, precision, scale)

_BY_NUMPY = {d.name: d for d in (int8, int16, int32, int64, uint8, uint16,
                                 uint32, uint64, float16, float32, float64)}
_BY_NUMPY["bool"] = bool_


def torch_dtype_name(d: torch.dtype) -> str:
    """'int64' for torch.int64: the numpy name of a torch dtype."""
    return str(d).removeprefix("torch.")


def widen(values: torch.Tensor, d: DataType) -> torch.Tensor:
    """The exact int64 value of integer or bool storage of logical type
    `d`: sign-extended for signed types, zero-extended for unsigned ones
    (uint64 keeps its bits), 0/1 for bool."""
    w = values.to(torch.int64)
    if d.is_unsigned_integer and d.byte_width < 8:
        w = w & ((1 << (8 * d.byte_width)) - 1)
    return w


def storage_int(x: int) -> int:
    """The int64 storage value with the bits of an integer of any logical
    type (x in [-2**63, 2**64)): uint64 values above 2**63 wrap."""
    return x - (1 << 64) if x >= 1 << 63 else x


INT_MIN = {n: -(2 ** (8 * 2 ** i - 1)) for i, n in enumerate(
    ("int8", "int16", "int32", "int64"))}
INT_MAX = {n: 2 ** (8 * 2 ** i - 1) - 1 for i, n in enumerate(
    ("int8", "int16", "int32", "int64"))}
UINT_MAX = {n: 2 ** (8 * 2 ** i) - 1 for i, n in enumerate(
    ("uint8", "uint16", "uint32", "uint64"))}


def integer_bounds(dt: DataType) -> Tuple[int, int]:
    """(lo, hi) inclusive value bounds of an integer logical type; any
    other type raises TypeError (arrow_tpu/dtypes.py:452-458)."""
    if dt.is_signed_integer:
        return INT_MIN[dt.name], INT_MAX[dt.name]
    if dt.is_unsigned_integer:
        return 0, UINT_MAX[dt.name]
    raise TypeError(f"not an integer type: {dt}")


def from_numpy_dtype(d) -> DataType:
    """Logical type of a numpy dtype (fixed-width types only)."""
    name = np.dtype(d).name
    if name not in _BY_NUMPY:
        from .errors import ArrowTypeError
        raise ArrowTypeError(f"no logical type for {name}")
    return _BY_NUMPY[name]


def dictionary(index_type: DataType, value_type: DataType,
               ordered: bool = False) -> DataType:
    if not index_type.is_integer:
        raise TypeError(f"dictionary index type must be integer: {index_type}")
    return DataType("dictionary", index_type=index_type,
                    value_type=value_type, ordered=True if ordered else None)


def list_(value_type: DataType) -> DataType:
    return DataType("list", value_type=value_type)


def large_list(value_type: DataType) -> DataType:
    """LargeList: int64 offsets (list_ has int32 ones)."""
    return DataType("large_list", value_type=value_type)


def list_view(value_type: DataType) -> DataType:
    """ListView: offsets and sizes over a shared child."""
    return DataType("list_view", value_type=value_type)


def large_list_view(value_type: DataType) -> DataType:
    return DataType("large_list_view", value_type=value_type)


def fixed_size_list(value_type: DataType, list_size: int) -> DataType:
    return DataType("fixed_size_list", value_type=value_type,
                    list_size=int(list_size))


def struct(fields) -> DataType:
    return DataType("struct", fields=tuple(fields))


def map_(key_type: DataType, item_type: DataType) -> DataType:
    kv = struct([Field("key", key_type, nullable=False),
                 Field("value", item_type)])
    return DataType("map", value_type=kv)


def union(fields, mode: str = "sparse", type_ids=None) -> DataType:
    """Union(sparse | dense) (union_array.rs:123)."""
    if mode not in ("sparse", "dense"):
        from .errors import ArrowInvalid
        raise ArrowInvalid(f"union mode {mode!r}")
    fields = tuple(fields)
    tids = tuple(type_ids) if type_ids is not None \
        else tuple(range(len(fields)))
    if len(tids) != len(fields):
        from .errors import ArrowInvalid
        raise ArrowInvalid("union: one type id per field")
    return DataType("union", fields=fields, mode=mode, type_ids=tids)


def run_end_encoded(run_end_type: DataType, value_type: DataType
                    ) -> DataType:
    """RunEndEncoded (run_array.rs:63); the run-end type rides in
    `index_type`."""
    if run_end_type.name not in ("int16", "int32", "int64"):
        from .errors import ArrowInvalid
        raise ArrowInvalid(f"run-end type {run_end_type!r}")
    return DataType("run_end_encoded", index_type=run_end_type,
                    value_type=value_type)


def _merge_field_lists(existing, incoming):
    """SchemaBuilder::try_merge (schema.rs:98): merge by name, append new
    names in arrival order."""
    out = list(existing)
    index = {f.name: i for i, f in enumerate(out)}
    for f in incoming:
        i = index.get(f.name)
        if i is None:
            index[f.name] = len(out)
            out.append(f)
        else:
            out[i] = out[i].try_merge(f)
    return out


def _merge_metadata(pairs, meta: dict, what: str) -> None:
    from .errors import SchemaError
    for k, v in pairs:
        if k in meta and meta[k] != v:
            raise SchemaError(f"conflicting metadata for key {k!r} {what}")
        meta[k] = v


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    metadata: Tuple[Tuple[str, str], ...] = ()

    def with_name(self, name: str) -> "Field":
        return dataclasses.replace(self, name=name)

    def with_nullable(self, nullable: bool) -> "Field":
        return dataclasses.replace(self, nullable=nullable)

    def try_merge(self, other: "Field") -> "Field":
        """Unify with a same-named field (field.rs:697): metadata unions
        (a conflicting key raises), struct and list children merge
        recursively, null widens to the other type, other types must be
        equal; nullability ORs."""
        from .errors import SchemaError
        meta: dict = {}
        _merge_metadata(self.metadata, meta, f"merging field {self.name!r}")
        _merge_metadata(other.metadata, meta,
                        f"merging field {self.name!r}")
        sd, od = self.dtype, other.dtype
        nullable = self.nullable or other.nullable
        if sd.name == "null":
            dtype, nullable = od, True
        elif od.name == "null":
            dtype, nullable = sd, True
        elif sd.name == "struct":
            if od.name != "struct":
                raise SchemaError(f"field {self.name!r}: {od!r} is not struct")
            dtype = struct(_merge_field_lists(sd.fields, od.fields))
        elif sd.name in ("list", "large_list"):
            if od.name != sd.name:
                raise SchemaError(
                    f"field {self.name!r}: {od!r} is not {sd.name}")
            elem = Field("item", sd.value_type).try_merge(
                Field("item", od.value_type))
            dtype = DataType(sd.name, value_type=elem.dtype)
        else:
            if sd != od:
                raise SchemaError(
                    f"field {self.name!r}: {od!r} does not equal {sd!r}")
            dtype = sd
        return Field(self.name, dtype, nullable, tuple(meta.items()))


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]
    metadata: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    def project(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices), self.metadata)

    @staticmethod
    def try_merge(schemas) -> "Schema":
        """Unify schemas field by field (schema.rs:295): fields match by
        name (new names append); metadata unions, a conflict raises."""
        meta: dict = {}
        fields: list = []
        for s in schemas:
            _merge_metadata(s.metadata, meta, "of the schemas")
            fields = _merge_field_lists(fields, s.fields)
        return Schema(tuple(fields), tuple(meta.items()))

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field(self, i) -> Field:
        if isinstance(i, str):
            return self.fields[self.index_of(i)]
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)


# ---- extension types (arrow-schema/src/extension/mod.rs:188) ---------------

@dataclass(frozen=True)
class ExtensionType:
    """A logical type layered on a storage DataType through field
    metadata (ARROW:extension:name and ARROW:extension:metadata), as the
    reference's ExtensionType trait (arrow_tpu/dtypes.py:381-450)."""

    extension_name: str
    storage: DataType
    extension_metadata: str = ""

    def field_metadata(self) -> Tuple[Tuple[str, str], ...]:
        md = (("ARROW:extension:name", self.extension_name),)
        if self.extension_metadata:
            md += (("ARROW:extension:metadata", self.extension_metadata),)
        return md

    def __repr__(self):
        return f"extension<{self.extension_name}, {self.storage!r}>"


def uuid() -> ExtensionType:
    """arrow.uuid (extension/canonical/uuid.rs)."""
    return ExtensionType("arrow.uuid", fixed_size_binary(16))


def json_(storage: DataType = utf8) -> ExtensionType:
    """arrow.json (extension/canonical/json.rs) over a string type."""
    if not storage.is_string:
        raise TypeError(f"arrow.json needs a string storage, got {storage!r}")
    return ExtensionType("arrow.json", storage)


def bool8() -> ExtensionType:
    """arrow.bool8 (extension/canonical/bool8.rs): bools as int8."""
    return ExtensionType("arrow.bool8", int8)


def fixed_shape_tensor(value_type: DataType, shape) -> ExtensionType:
    """arrow.fixed_shape_tensor (extension/canonical/fixed_shape_tensor.rs):
    a fixed-size list of the shape's element count."""
    import json
    shape = [int(s) for s in shape]
    return ExtensionType("arrow.fixed_shape_tensor",
                         fixed_size_list(value_type, int(np.prod(shape))),
                         json.dumps({"shape": shape}))


def opaque(storage: DataType, type_name: str, vendor_name: str
           ) -> ExtensionType:
    """arrow.opaque (extension/canonical/opaque.rs)."""
    import json
    return ExtensionType("arrow.opaque", storage, json.dumps(
        {"type_name": type_name, "vendor_name": vendor_name}))
