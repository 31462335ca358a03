"""Logical type system of the port (counterpart of arrow_tpu/dtypes.py).

The same logical-type vocabulary as the reference, restricted to what
the port's slices carry: null, bool, the signed and unsigned integers,
float16/32/64, the temporal types (date32/64, timestamp, time32/64,
duration and the year_month and day_time intervals: integer storage
plus unit and timezone metadata), utf8 and dictionary.  `to_torch`
takes the place of `to_jax` (arrow_tpu/dtypes.py:142).

Unsigned storage: torch's uint16/uint32/uint64 reject `+`, `<`, `>>`
and `max`, so Arrow's unsigned types live on signed storage of the same
width holding the same bits (uint8 keeps torch.uint8, which supports
everything).  Anything that orders unsigned values goes through the
sign-flip map; `to_numpy` names the logical numpy dtype for host views.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DataType", "null", "bool_", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
    "utf8", "date32", "date64", "timestamp", "time32", "time64",
    "duration", "interval", "dictionary", "Field", "Schema",
    "from_numpy_dtype",
    "torch_dtype_name", "widen", "storage_int", "integer_bounds",
]


@dataclass(frozen=True)
class DataType:
    """A logical Arrow data type (cf. arrow-schema/src/datatype.rs:97)."""

    name: str
    index_type: Optional["DataType"] = None   # dictionary key type
    value_type: Optional["DataType"] = None   # dictionary value type
    # dictionary: values are sorted and code order IS value order
    ordered: Optional[bool] = None
    unit: Optional[str] = None                # temporal unit
    tz: Optional[str] = None                  # timestamp timezone

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
        return self.is_integer or self.is_floating

    @property
    def is_temporal(self) -> bool:
        return self.name in _TEMPORAL_NAMES

    @property
    def is_boolean(self) -> bool:
        return self.name == "bool"

    @property
    def is_string(self) -> bool:
        return self.name == "utf8"

    @property
    def is_null(self) -> bool:
        return self.name == "null"

    @property
    def is_dictionary(self) -> bool:
        return self.name == "dictionary"

    @property
    def is_primitive(self) -> bool:
        """Fixed-width, single-tensor representable."""
        return self.is_numeric or self.is_boolean or self.is_temporal

    def to_torch(self) -> torch.dtype:
        """torch dtype of the physical value tensor (signed storage for
        uint16/32/64)."""
        if self.name == "dictionary":
            return self.index_type.to_torch()
        if self.name == "interval":
            return _INTERVAL_TORCH[self.unit]
        m = _TORCH_DTYPE.get(self.name)
        if m is None:
            raise TypeError(f"{self} has no single-tensor physical dtype")
        return m

    def to_numpy(self) -> np.dtype:
        """Logical numpy dtype: the host view of the storage bits."""
        if self.name == "dictionary":
            return self.index_type.to_numpy()
        if self.is_temporal:
            return self.storage_numpy()
        if self.name not in _TORCH_DTYPE:
            raise TypeError(f"{self} has no single-tensor physical dtype")
        return np.dtype(self.name)

    def storage_numpy(self) -> np.dtype:
        """numpy dtype of the storage bits (signed for uint16/32/64)."""
        return np.dtype(torch_dtype_name(self.to_torch()))

    @property
    def byte_width(self) -> int:
        return self.to_numpy().itemsize

    def __repr__(self) -> str:
        if self.name == "dictionary":
            return f"dictionary<{self.index_type!r}, {self.value_type!r}>"
        if self.name == "timestamp":
            return f"timestamp[{self.unit}{', tz=' + self.tz if self.tz else ''}]"
        if self.unit is not None:
            return f"{self.name}[{self.unit}]"
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
}

# interval storage by unit: year_month i32 months, day_time i64
# (days << 32 | millis); month_day_nano is two tensors (ROADMAP A7)
_INTERVAL_TORCH = {"year_month": torch.int32, "day_time": torch.int64}

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


def interval(unit: str) -> DataType:
    """Interval(YearMonth | DayTime); MonthDayNano's 128-bit layout joins
    with ROADMAP A7."""
    return DataType("interval", unit=_unit("interval", unit,
                                           ("year_month", "day_time")))

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


def integer_bounds(d: DataType) -> Tuple[int, int]:
    """(lo, hi) inclusive value bounds of an integer logical type."""
    info = np.iinfo(d.to_numpy())
    return int(info.min), int(info.max)


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


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

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
