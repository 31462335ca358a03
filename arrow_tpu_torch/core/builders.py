"""Typed array builders (counterpart of arrow_tpu/core/builders.py;
arrow-array/src/builder/).

Builders accumulate on the host and place each buffer on their device
once, at finish(): an upload per append would cost a copy each.  Leaf
builders name the device; container builders (list, fixed-size list,
struct, map, dictionary) take their first child's.  The dictionary
builder interns values in a dict, like generic_bytes_dictionary_builder.rs.
The byte builders take str or bytes for every string and binary type;
`make_builder` also gives one for utf8_view and binary_view, which hold
the offset layout (the reference has none for the views).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..errors import ArrowInvalid, ArrowTypeError
from .column import (DictionaryColumn, ListColumn, NullColumn,
                     PrimitiveColumn, StringColumn, StructColumn)

__all__ = [
    "PrimitiveBuilder", "BooleanBuilder", "StringBuilder",
    "LargeStringBuilder", "BinaryBuilder", "LargeBinaryBuilder",
    "FixedSizeBinaryBuilder", "Decimal128Builder", "Decimal256Builder",
    "DecimalBuilder", "IntervalMDNBuilder", "DictionaryBuilder",
    "StringDictionaryBuilder", "ListBuilder", "FixedSizeListBuilder",
    "StructBuilder", "MapBuilder", "NullBuilder", "make_builder",
]


def _mask(valid: List[bool], device: torch.device):
    return None if all(valid) else \
        torch.from_numpy(np.asarray(valid, bool)).to(device)


class _Base:
    def __len__(self):
        return self._len

    def append_nulls(self, n: int):
        for _ in range(n):
            self.append_null()
        return self

    def extend(self, values):
        for v in values:
            self.append(v)
        return self

    def _push(self, valid: bool):
        self._valid.append(valid)
        self._len += 1
        return self


class PrimitiveBuilder(_Base):
    """PrimitiveBuilder<T> (builder/primitive_builder.rs), for the
    primitive types and decimal32/64 (their unscaled ints)."""

    def __init__(self, dtype: dt.DataType, device: DeviceLike = None):
        if not dtype.is_single_tensor:
            raise ArrowTypeError(f"not primitive: {dtype}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self._vals: List = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        self._vals.append(v)
        return self._push(True)

    append_value = append

    def append_null(self):
        self._vals.append(0)
        return self._push(False)

    def finish(self) -> PrimitiveColumn:
        from .column import from_numpy
        vals = np.asarray(self._vals, self.dtype.to_numpy())
        mask = None if all(self._valid) else np.asarray(self._valid, bool)
        out = from_numpy(vals, mask, self.dtype, self.device)
        PrimitiveBuilder.__init__(self, self.dtype, self.device)
        return out


class BooleanBuilder(PrimitiveBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(dt.bool_, device)

    def append(self, v):
        return super().append(None if v is None else bool(v))


class _BytesBuilder(_Base):
    """GenericByteBuilder (builder/generic_bytes_builder.rs): str or
    bytes values of one string or binary type."""

    def __init__(self, dtype: dt.DataType, device: DeviceLike = None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._values: List = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        self._values.append(v if isinstance(v, str) else bytes(v))
        return self._push(True)

    append_value = append

    def append_null(self):
        self._values.append(None)
        return self._push(False)

    def finish(self) -> StringColumn:
        out = StringColumn.from_pylist(self._values, self.dtype,
                                       device=self.device)
        _BytesBuilder.__init__(self, self.dtype, self.device)
        return out


class StringBuilder(_BytesBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(dt.utf8, device)


class LargeStringBuilder(_BytesBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(dt.large_utf8, device)


class BinaryBuilder(_BytesBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(dt.binary, device)


class LargeBinaryBuilder(_BytesBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(dt.large_binary, device)


class FixedSizeBinaryBuilder(_Base):
    def __init__(self, byte_width: int, device: DeviceLike = None):
        self.byte_width = byte_width
        self.device = resolve_device(device)
        self._rows: List[bytes] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        b = bytes(v)
        if len(b) != self.byte_width:
            raise ArrowInvalid(f"expected {self.byte_width} bytes")
        self._rows.append(b)
        return self._push(True)

    append_value = append

    def append_null(self):
        self._rows.append(b"\0" * self.byte_width)
        return self._push(False)

    def finish(self):
        from .nested import FixedSizeBinaryColumn
        data = np.frombuffer(b"".join(self._rows), np.uint8).copy() \
            .reshape(self._len, self.byte_width)
        out = FixedSizeBinaryColumn(torch.from_numpy(data).to(self.device),
                                    _mask(self._valid, self.device))
        FixedSizeBinaryBuilder.__init__(self, self.byte_width, self.device)
        return out


class DecimalBuilder(_Base):
    """Unscaled ints of a decimal128/256 (`int(v)` of what is appended, as
    the reference's builder takes it; `column()` scales Decimals).
    decimal32/64 take the PrimitiveBuilder."""

    def __init__(self, dtype: dt.DataType, device: DeviceLike = None):
        if dtype.name not in ("decimal128", "decimal256"):
            raise ArrowTypeError(f"not a decimal128/256: {dtype}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self._vals: List[int] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        self._vals.append(int(v))
        return self._push(True)

    append_value = append

    def append_null(self):
        self._vals.append(0)
        return self._push(False)

    def finish(self):
        from .nested import DecimalColumn
        out = DecimalColumn.from_pyints(self._vals, self.dtype,
                                        _mask(self._valid, self.device),
                                        device=self.device)
        DecimalBuilder.__init__(self, self.dtype, self.device)
        return out


class Decimal128Builder(DecimalBuilder):
    def __init__(self, precision: int = 38, scale: int = 0,
                 device: DeviceLike = None):
        super().__init__(dt.decimal128(precision, scale), device)


class Decimal256Builder(DecimalBuilder):
    def __init__(self, precision: int = 76, scale: int = 0,
                 device: DeviceLike = None):
        super().__init__(dt.decimal256(precision, scale), device)


class IntervalMDNBuilder(_Base):
    """(months, days, nanoseconds) tuples or dicts with those keys."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._parts: List = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        if isinstance(v, dict):
            v = (v.get("months", 0), v.get("days", 0),
                 v.get("nanoseconds", 0))
        self._parts.append(tuple(int(x) for x in v))
        return self._push(True)

    append_value = append

    def append_null(self):
        self._parts.append((0, 0, 0))
        return self._push(False)

    def finish(self):
        from .nested import IntervalMDNColumn
        m, d, n = (np.asarray(p, t) for p, t in zip(
            zip(*self._parts) if self._parts else ((), (), ()),
            (np.int32, np.int32, np.int64)))
        out = IntervalMDNColumn(*(torch.from_numpy(a).to(self.device)
                                  for a in (m, d, n)),
                                _mask(self._valid, self.device))
        IntervalMDNBuilder.__init__(self, self.device)
        return out


class DictionaryBuilder(_Base):
    """Hash-interning dictionary builder
    (builder/generic_bytes_dictionary_builder.rs)."""

    def __init__(self, value_builder, index_dtype: dt.DataType = dt.int32):
        self._value_builder = value_builder
        self._index_dtype = index_dtype
        self.device = value_builder.device
        self._intern: Dict = {}
        self._codes: List[int] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        code = self._intern.get(v)
        if code is None:
            code = self._intern[v] = len(self._intern)
            self._value_builder.append(v)
        self._codes.append(code)
        return self._push(True)

    append_value = append

    def append_null(self):
        self._codes.append(0)
        return self._push(False)

    @property
    def dictionary_size(self) -> int:
        return len(self._intern)

    def finish(self) -> DictionaryColumn:
        values = self._value_builder.finish()
        codes = np.asarray(self._codes, self._index_dtype.to_numpy())
        out = DictionaryColumn(
            torch.from_numpy(codes.view(self._index_dtype.storage_numpy()))
            .to(self.device), values, _mask(self._valid, self.device))
        DictionaryBuilder.__init__(self, self._value_builder,
                                   self._index_dtype)
        return out


class StringDictionaryBuilder(DictionaryBuilder):
    def __init__(self, device: DeviceLike = None):
        super().__init__(StringBuilder(device))


class ListBuilder(_Base):
    """ListBuilder (builder/generic_list_builder.rs): append items through
    the `values` builder, close each list with append(True)."""

    def __init__(self, values_builder, large: bool = False):
        self.values = values_builder
        self.large = large
        self.device = values_builder.device
        self._offsets: List[int] = [0]
        self._valid: List[bool] = []
        self._len = 0

    def append(self, is_valid=True):
        """Close the current list."""
        self._offsets.append(len(self.values))
        return self._push(bool(is_valid))

    def append_value(self, values: Sequence):
        for v in values:
            self.values.append(v)
        return self.append(True)

    def append_null(self):
        return self.append(False)

    def finish(self) -> ListColumn:
        child = self.values.finish()
        offs = np.asarray(self._offsets, np.int64 if self.large else np.int32)
        out = ListColumn(torch.from_numpy(offs).to(self.device), child,
                         _mask(self._valid, self.device), large=self.large)
        ListBuilder.__init__(self, self.values, self.large)
        return out


class FixedSizeListBuilder(_Base):
    def __init__(self, values_builder, list_size: int):
        self.values = values_builder
        self.list_size = list_size
        self.device = values_builder.device
        self._valid: List[bool] = []
        self._len = 0

    def append_value(self, values: Sequence):
        if len(values) != self.list_size:
            raise ArrowInvalid(f"expected {self.list_size} values")
        for v in values:
            self.values.append(v)
        return self._push(True)

    append = append_value

    def append_null(self):
        self.values.append_nulls(self.list_size)
        return self._push(False)

    def finish(self):
        from .nested import FixedSizeListColumn
        out = FixedSizeListColumn(self.values.finish(), self.list_size,
                                  _mask(self._valid, self.device))
        FixedSizeListBuilder.__init__(self, self.values, self.list_size)
        return out


class StructBuilder(_Base):
    """StructBuilder (builder/struct_builder.rs): per-field builders."""

    def __init__(self, fields: Sequence[dt.Field], builders,
                 device: DeviceLike = None):
        self.fields = tuple(fields)
        self.builders = list(builders)
        self.device = self.builders[0].device if self.builders \
            else resolve_device(device)
        self._valid: List[bool] = []
        self._len = 0

    def field_builder(self, i: int):
        return self.builders[i]

    def append(self, is_valid=True):
        return self._push(bool(is_valid))

    def append_null(self):
        for b in self.builders:
            b.append_null()
        return self.append(False)

    def finish(self) -> StructColumn:
        out = StructColumn(tuple(b.finish() for b in self.builders),
                           self.fields, _mask(self._valid, self.device))
        StructBuilder.__init__(self, self.fields, self.builders, self.device)
        return out


class MapBuilder(_Base):
    """MapBuilder (builder/map_builder.rs): (key, value) pairs per row."""

    def __init__(self, key_builder, item_builder,
                 key_field: str = "key", item_field: str = "value"):
        self.keys = key_builder
        self.items = item_builder
        self.device = key_builder.device
        self._names = (key_field, item_field)
        self._offsets: List[int] = [0]
        self._valid: List[bool] = []
        self._len = 0

    def append_value(self, pairs):
        for k, v in pairs:
            self.keys.append(k)
            self.items.append(v)
        self._offsets.append(len(self.keys))
        return self._push(True)

    append = append_value

    def append_null(self):
        self._offsets.append(self._offsets[-1])
        return self._push(False)

    def finish(self):
        from .nested import MapColumn
        keys, items = self.keys.finish(), self.items.finish()
        entries = StructColumn(
            (keys, items),
            (dt.Field(self._names[0], keys.dtype, nullable=False),
             dt.Field(self._names[1], items.dtype)))
        offs = torch.from_numpy(np.asarray(self._offsets, np.int32))
        out = MapColumn(offs.to(self.device), entries,
                        _mask(self._valid, self.device))
        MapBuilder.__init__(self, self.keys, self.items, *self._names)
        return out


class NullBuilder(_Base):
    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._len = 0

    def append_null(self):
        self._len += 1
        return self

    append = append_null

    def finish(self) -> NullColumn:
        n, self._len = self._len, 0
        return NullColumn(n, self.device)


_BYTES_BUILDERS = {"utf8": StringBuilder, "large_utf8": LargeStringBuilder,
                   "binary": BinaryBuilder, "large_binary": LargeBinaryBuilder}


def make_builder(dtype: dt.DataType, device: DeviceLike = None):
    """The builder of a type on `device` (builder/mod.rs make_builder)."""
    if dtype.is_null:
        return NullBuilder(device)
    if dtype == dt.bool_:
        return BooleanBuilder(device)
    if dtype.is_single_tensor:
        return PrimitiveBuilder(dtype, device)
    if dtype.is_decimal:
        return DecimalBuilder(dtype, device)
    if dtype.unit == "month_day_nano":
        return IntervalMDNBuilder(device)
    if dtype.name == "fixed_size_binary":
        return FixedSizeBinaryBuilder(dtype.list_size, device)
    if dtype.name == "dictionary":
        return DictionaryBuilder(make_builder(dtype.value_type, device),
                                 dtype.index_type)
    if dtype.name in ("list", "large_list"):
        return ListBuilder(make_builder(dtype.value_type, device),
                           large=dtype.name == "large_list")
    if dtype.name == "fixed_size_list":
        return FixedSizeListBuilder(make_builder(dtype.value_type, device),
                                    dtype.list_size)
    if dtype.name == "struct":
        return StructBuilder(dtype.fields, [make_builder(f.dtype, device)
                                            for f in dtype.fields], device)
    if dtype.name == "map":
        kv = dtype.value_type
        return MapBuilder(make_builder(kv.fields[0].dtype, device),
                          make_builder(kv.fields[1].dtype, device))
    if dtype.name in _BYTES_BUILDERS:
        return _BYTES_BUILDERS[dtype.name](device)
    if dtype.is_string or dtype.is_binary:         # the two views
        return _BytesBuilder(dtype, device)
    raise ArrowTypeError(f"no builder for {dtype}")
