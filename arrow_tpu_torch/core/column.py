"""Columnar arrays on one explicit torch device (counterpart of
arrow_tpu/core/column.py).

  - A column holds tensors on one device; ops keep the device of their
    inputs.  Construction from host data names the device.
  - Validity is a dense bool tensor or None (core/validity.py).
  - Null slots are zeroed at construction (arrow_tpu/core/column.py:11-14)
    so every column has exactly one bit pattern per logical value; the
    bitwise parity with the reference depends on it.
  - Unsigned types use signed storage of the same width (dtypes.py);
    host conversion views the bits back as the logical numpy dtype.

Class map (reference -> here): PrimitiveColumn (numeric, bool, temporal
and decimal32/64), StringColumn (utf8, large_utf8, utf8_view, binary,
large_binary and binary_view), DictionaryColumn, ListColumn,
StructColumn and NullColumn, each on the device the caller names; the
other layouts are in core/nested.py.

Host values: `to_pylist` lists what the reference lists.  Temporal
columns go through pyarrow (`io/interop.py`, imported when called), as
the reference's every `to_pylist` does (arrow_tpu/core/column.py:75-83):
dates, datetimes, times and timedeltas.  The other kinds list directly,
with equal values.

Every column class is a torch pytree node (`torch.utils._pytree`), as
the reference's columns are jax pytrees: their tensors are the leaves,
their type (and a dictionary's values) the static structure.  `fuse`
captures pipelines over them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..errors import ArrowInvalid, ArrowNotImplementedError, ArrowTypeError
from ..utils.trace import to_host
from . import validity as vd

__all__ = ["Column", "PrimitiveColumn", "StringColumn", "DictionaryColumn",
           "ListColumn", "StructColumn", "NullColumn", "column",
           "from_numpy", "offset_dtype"]


class Column:
    """Abstract base: a logical Arrow array (arrow-array Array trait)."""

    dtype: dt.DataType
    validity: vd.Mask

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def null_count(self) -> int:
        return vd.null_count(self.validity, len(self))

    def is_valid_mask(self) -> torch.Tensor:
        return vd.make_mask(len(self), self.validity, self.device)

    def slice(self, offset: int, length: int) -> "Column":
        raise NotImplementedError

    def with_validity(self, validity: vd.Mask) -> "Column":
        raise NotImplementedError

    def to_pylist(self) -> list:
        raise NotImplementedError

    def equals(self, other) -> bool:
        """Logical equality (arrow_tpu/core/column.py:89-100; arrow-data
        equal/): the same type, length, null positions and values, floats
        by their bits (NaN equals NaN, -0.0 differs from 0.0).  Computed
        on the column's device with one host sync (core/equal.py)."""
        from .equal import column_equals
        return column_equals(self, other)

    def __arrow_c_array__(self, requested_schema=None):
        """The Arrow PyCapsule protocol (io/cdata.py;
        arrow_tpu/core/column.py:53): `pa.array(col)` takes the column,
        its buffers copied to the host once."""
        from ..io.cdata import export_column
        return export_column(self)

    def to_pyarrow(self):
        """The column as a pyarrow array (io/interop.py)."""
        from ..io.interop import column_to_pyarrow
        return column_to_pyarrow(self)

    def _mask_host(self) -> Optional[np.ndarray]:
        return None if self.validity is None else \
            to_host("column.validity", self.validity).numpy()

    def __repr__(self):
        return (f"{type(self).__name__}<{self.dtype!r}>[{len(self)}] "
                f"{self.to_pylist()[:10]}")


def _py_equal(a, b) -> bool:
    """Recursive NaN-equal value comparison (byte-equality semantics:
    NaN == NaN at matching bits, -0.0 != 0.0, like arrow-rs PartialEq)."""
    if isinstance(a, float) and isinstance(b, float):
        import struct as _st
        return _st.pack("<d", a) == _st.pack("<d", b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_py_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_py_equal(v, b[k])
                                            for k, v in a.items())
    return a == b


def _check_mask(mask: vd.Mask, n: int, device: torch.device) -> None:
    if mask is None:
        return
    if mask.dtype != torch.bool or mask.shape != (n,) \
            or mask.device != device:
        raise ArrowInvalid(
            f"validity must be a ({n},) bool tensor on {device}, got "
            f"{tuple(mask.shape)} {mask.dtype} on {mask.device}")


class PrimitiveColumn(Column):
    """Fixed-width values: numeric, boolean, temporal, decimal32/64.

    values: 1-D tensor of dtype.to_torch(); validity: bool mask or None.
    """

    def __init__(self, values: torch.Tensor, dtype: dt.DataType,
                 validity: vd.Mask = None, *, _canonical: bool = False):
        if values.dim() != 1 or values.dtype != dtype.to_torch():
            raise ArrowInvalid(
                f"{dtype!r} needs 1-D {dtype.to_torch()} storage, got "
                f"{tuple(values.shape)} {values.dtype}")
        _check_mask(validity, values.shape[0], values.device)
        if not _canonical:
            values = vd.canonicalize(values, validity)
        self.values = values
        self.dtype = dtype
        self.validity = validity

    def __len__(self):
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def slice(self, offset, length):
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        return PrimitiveColumn(self.values[offset:offset + length],
                               self.dtype, v, _canonical=True)

    def with_validity(self, validity: vd.Mask) -> "PrimitiveColumn":
        return PrimitiveColumn(self.values, self.dtype, validity)

    def with_values(self, values: torch.Tensor,
                    dtype: Optional[dt.DataType] = None, *,
                    _canonical: bool = True) -> "PrimitiveColumn":
        """New values (of `dtype`, this column's type when None) under
        this column's validity (arrow_tpu/core/column.py:161)."""
        return PrimitiveColumn(values, dtype or self.dtype, self.validity,
                               _canonical=_canonical)

    def to_numpy(self, zero_nulls: bool = True) -> np.ndarray:
        """Host copy of the values in the logical numpy dtype.  Null slots
        hold zeros whatever `zero_nulls` says: they are zeroed at
        construction (the reference ignores the flag too)."""
        return to_host("column.values", self.values).numpy().view(
            self.dtype.to_numpy())

    def to_pylist(self) -> list:
        if self.dtype.is_temporal and self.dtype.name != "interval":
            return self.to_pyarrow().to_pylist()
        out = self.to_numpy().tolist()
        if self.dtype.is_decimal:          # unscaled ints -> Decimal
            out = [_decimal_value(v, self.dtype.scale) for v in out]
        mask = self._mask_host()
        if mask is not None:
            out = [v if ok else None for v, ok in zip(out, mask.tolist())]
        return out


# exact for every decimal256 (76 digits): the default context rounds
# past 28 digits
_EXACT = __import__("decimal").Context(prec=100)


def _decimal_value(unscaled: int, scale: int):
    """The Decimal of an unscaled integer, as pyarrow lists decimals."""
    from decimal import Decimal
    return Decimal(unscaled).scaleb(-scale, _EXACT)


def offset_dtype(d: dt.DataType) -> torch.dtype:
    """The offsets' dtype of a string layout: int64 for large_utf8 and
    large_binary, int32 for utf8, binary and the two views (which hold
    the offset layout, as the reference's ingest makes them)."""
    return torch.int64 if d.name in ("large_utf8", "large_binary") \
        else torch.int32


def _narrow_offsets(offsets: np.ndarray, want: np.dtype) -> np.ndarray:
    """Host offsets at `want`'s width; past int32 they raise."""
    if want == np.int32 and offsets.dtype != np.int32 and len(offsets) \
            and int(offsets[-1]) > np.iinfo(np.int32).max:
        raise ArrowInvalid(f"{int(offsets[-1])} bytes overflow int32 "
                           "offsets: use a large string type")
    return offsets.astype(want, copy=False)


class StringColumn(Column):
    """Variable-length bytes in the Arrow offset layout
    (arrow-array/src/array/byte_array.rs:87): offsets (n+1,) and data
    bytes, both on the column's device, as the reference keeps them.
    The offsets are int64 for large_utf8 and large_binary, int32 for
    utf8, binary, utf8_view and binary_view (`offset_dtype`).

    Not a hot compute layout: comparisons, sorts, group-bys and joins
    dictionary-encode first (ops/strings.py); take, filter and concat
    work on the buffers directly."""

    def __init__(self, offsets: torch.Tensor, data: torch.Tensor,
                 dtype: dt.DataType = dt.utf8, validity: vd.Mask = None):
        if offsets.dim() != 1 or offsets.dtype != offset_dtype(dtype) \
                or data.dim() != 1 or data.dtype != torch.uint8 \
                or data.device != offsets.device:
            raise ArrowInvalid(
                f"a {dtype!r} column needs {offset_dtype(dtype)} offsets and "
                f"uint8 data on one device, got {offsets.dtype} on "
                f"{offsets.device} and {data.dtype} on {data.device}")
        _check_mask(validity, offsets.shape[0] - 1, offsets.device)
        self.offsets = offsets          # (n+1,), offset_dtype(dtype)
        self.data = data                # uint8, (nbytes,)
        self.dtype = dtype
        self.validity = validity

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def slice(self, offset, length):
        """Rows [offset, offset + length) with rebased offsets and the
        bytes they cover (arrow_tpu/core/column.py:215-223): one host
        read of the two byte bounds."""
        offs = self.offsets[offset:offset + length + 1]
        start, end = to_host("column.slice", offs[[0, -1]]).tolist()
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        return StringColumn(offs - start, self.data[start:end], self.dtype,
                            v)

    def with_validity(self, validity: vd.Mask) -> "StringColumn":
        return StringColumn(self.offsets, self.data, self.dtype, validity)

    def retag(self, to: dt.DataType) -> "StringColumn":
        """The same bytes under another string or binary type, the
        offsets at its width (narrowing reads the last offset)."""
        want = offset_dtype(to)
        offs = self.offsets
        if want != offs.dtype:
            if want == torch.int32 and len(self) and \
                    int(offs[-1]) > torch.iinfo(torch.int32).max:
                raise ArrowInvalid(f"{int(offs[-1])} bytes overflow int32 "
                                   f"offsets of {to!r}")
            offs = offs.to(want)
        return StringColumn(offs, self.data, to, self.validity)

    @staticmethod
    def from_numpy(offsets: np.ndarray, data: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   dtype: dt.DataType = dt.utf8, *,
                   device: DeviceLike = None) -> "StringColumn":
        """A string column from host offsets (any integer width: they
        take the type's) and bytes, on `device`."""
        dev = resolve_device(device)
        want = np.dtype(dt.torch_dtype_name(offset_dtype(dtype)))
        offsets = _narrow_offsets(np.asarray(offsets), want)
        mask = None if validity is None else torch.from_numpy(
            _host_buffer(validity, bool)).to(dev)
        return StringColumn(
            torch.from_numpy(_host_buffer(offsets, want)).to(dev),
            torch.from_numpy(_host_buffer(data, np.uint8)).to(dev), dtype,
            mask)

    @staticmethod
    def from_pylist(values: Sequence, dtype: dt.DataType = dt.utf8, *,
                    device: DeviceLike = None) -> "StringColumn":
        """Python str or bytes values (None for null) on `device`."""
        chunks = [b"" if s is None else s.encode() if isinstance(s, str)
                  else bytes(s) for s in values]
        offsets = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum([len(c) for c in chunks], out=offsets[1:])
        data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        mask = np.array([s is not None for s in values], dtype=bool)
        return StringColumn.from_numpy(offsets, data,
                                       None if mask.all() else mask, dtype,
                                       device=device)

    def to_pylist(self) -> list:
        """The strings (bytes for a binary type), None at nulls: one copy
        of the buffers to the host (column.py:244-255)."""
        offs = self.offsets.cpu().numpy().tolist()
        data = self.data.cpu().numpy().tobytes()
        mask = self._mask_host()
        text = self.dtype.is_string
        return [None if mask is not None and not mask[i]
                else data[offs[i]:offs[i + 1]].decode() if text
                else data[offs[i]:offs[i + 1]] for i in range(len(self))]

    def to_pylist_host(self) -> list:
        """The rows from one host copy of the offsets and bytes
        (arrow_tpu/core/column.py:244), as `to_pylist` lists them."""
        return self.to_pylist()


class DictionaryColumn(Column):
    """Dictionary-encoded column (arrow-array dictionary_array.rs:243).

    codes: integer tensor on the column's device (0 under null slots);
    values: the dictionary, any Column (usually a StringColumn), on the
    codes' device when the column is built from host data.
    """

    def __init__(self, codes: torch.Tensor, values: Column,
                 validity: vd.Mask = None, *, _canonical: bool = False,
                 ordered: bool = False):
        if codes.dim() != 1 or codes.is_floating_point() \
                or codes.dtype == torch.bool:
            raise ArrowInvalid("dictionary codes must be a 1-D integer tensor")
        _check_mask(validity, codes.shape[0], codes.device)
        if not _canonical:
            codes = vd.canonicalize(codes, validity)
        self.codes = codes
        self.values = values
        self.validity = validity
        index_type = dt.from_numpy_dtype(dt.torch_dtype_name(codes.dtype))
        self.dtype = dt.dictionary(index_type, values.dtype, ordered=ordered)

    def __len__(self):
        return int(self.codes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def ordered(self) -> bool:
        return bool(self.dtype.ordered)

    @property
    def dictionary_size(self) -> int:
        return len(self.values)

    def slice(self, offset, length):
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        return DictionaryColumn(self.codes[offset:offset + length],
                                self.values, v, _canonical=True,
                                ordered=self.ordered)

    def with_validity(self, validity: vd.Mask) -> "DictionaryColumn":
        return DictionaryColumn(self.codes, self.values, validity,
                                ordered=self.ordered)

    def with_codes(self, codes: torch.Tensor, *,
                   _canonical: bool = True) -> "DictionaryColumn":
        """New codes over the same dictionary and validity
        (arrow_tpu/core/column.py:308)."""
        return DictionaryColumn(codes, self.values, self.validity,
                                _canonical=_canonical, ordered=self.ordered)

    def to_pylist(self) -> list:
        vals = self.values.to_pylist()
        codes = self.codes.cpu().numpy().tolist()
        mask = self._mask_host()
        return [None if mask is not None and not mask[i] else vals[c]
                for i, c in enumerate(codes)]


def _offset_rows(offsets: torch.Tensor, child: list, mask) -> list:
    """Row lists of a child's Python values cut at `offsets`."""
    offs = offsets.cpu().numpy().tolist()
    return [None if mask is not None and not mask[i]
            else child[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


class ListColumn(Column):
    """List<T> / LargeList<T> (list_array.rs:169): offsets (n+1,), int32
    for list and int64 for large_list, and a child column, both on the
    column's device."""

    def __init__(self, offsets: torch.Tensor, child: Column,
                 validity: vd.Mask = None, large: bool = False):
        if offsets.dim() != 1 or offsets.dtype not in (torch.int32,
                                                       torch.int64) \
                or offsets.device != child.device:
            raise ArrowInvalid(
                f"list offsets must be 1-D int32/int64 on the child's "
                f"device, got {offsets.dtype} on {offsets.device}")
        _check_mask(validity, offsets.shape[0] - 1, offsets.device)
        self.offsets = offsets
        self.child = child
        self.validity = validity
        self.dtype = (dt.large_list if large else dt.list_)(child.dtype)

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def _large(self) -> bool:
        return self.dtype.name == "large_list"

    def with_validity(self, validity: vd.Mask) -> "ListColumn":
        return ListColumn(self.offsets, self.child, validity, self._large())

    def slice(self, offset, length):
        """Rows [offset, offset + length): rebased offsets and the child
        rows they cover (one host read of the two bounds)."""
        offs = self.offsets[offset:offset + length + 1]
        start, end = to_host("column.slice", offs[[0, -1]]).tolist()
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        return ListColumn(offs - start, self.child.slice(start, end - start),
                          v, self._large())

    def to_pylist(self) -> list:
        return _offset_rows(self.offsets, self.child.to_pylist(),
                            self._mask_host())


class StructColumn(Column):
    """Struct (struct_array.rs:77): named children of equal length; the
    struct's own validity beside theirs.  A struct of no children has
    no rows."""

    def __init__(self, children, fields, validity: vd.Mask = None):
        children, fields = tuple(children), tuple(fields)
        if len(children) != len(fields):
            raise ArrowInvalid(f"{len(children)} children for "
                               f"{len(fields)} fields")
        if len({len(c) for c in children}) > 1 \
                or len({c.device for c in children}) > 1:
            raise ArrowInvalid("struct children differ in length or device")
        if children:
            _check_mask(validity, len(children[0]), children[0].device)
        self.children = children
        self.fields = fields
        self.validity = validity
        self.dtype = dt.struct(fields)

    def __len__(self):
        return len(self.children[0]) if self.children else 0

    @property
    def device(self) -> torch.device:
        return self.children[0].device if self.children \
            else torch.device("cpu")

    def with_validity(self, validity: vd.Mask) -> "StructColumn":
        return StructColumn(self.children, self.fields, validity)

    def slice(self, offset, length):
        v = None if self.validity is None \
            else self.validity[offset:offset + length]
        return StructColumn(tuple(c.slice(offset, length)
                                  for c in self.children), self.fields, v)

    def field(self, name: str) -> Column:
        for f, c in zip(self.fields, self.children):
            if f.name == name:
                return c
        raise KeyError(name)

    def to_pylist(self) -> list:
        kids = [c.to_pylist() for c in self.children]
        mask = self._mask_host()
        names = [f.name for f in self.fields]
        return [None if mask is not None and not mask[i]
                else {k: v[i] for k, v in zip(names, kids)}
                for i in range(len(self))]


class NullColumn(Column):
    """All-null column (arrow-array NullArray); its validity is all
    false, on `device`."""

    def __init__(self, length: int, device: DeviceLike):
        self.dtype = dt.null
        self.validity = torch.zeros((length,), dtype=torch.bool,
                                    device=torch.device(device))

    def __len__(self):
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def slice(self, offset, length):
        return NullColumn(length, self.device)

    def with_validity(self, validity: vd.Mask) -> "NullColumn":
        return self

    def to_pylist(self) -> list:
        return [None] * len(self)


pytree.register_pytree_node(
    PrimitiveColumn,
    lambda c: ([c.values, c.validity], c.dtype),
    lambda leaves, d: PrimitiveColumn(leaves[0], d, leaves[1],
                                      _canonical=True),
    serialized_type_name="arrow_tpu_torch.PrimitiveColumn")
pytree.register_pytree_node(
    StringColumn,
    lambda c: ([c.offsets, c.data, c.validity], c.dtype),
    lambda leaves, d: StringColumn(leaves[0], leaves[1], d, leaves[2]),
    serialized_type_name="arrow_tpu_torch.StringColumn")
pytree.register_pytree_node(
    DictionaryColumn,
    lambda c: ([c.codes, c.validity], (c.values, bool(c.dtype.ordered))),
    lambda leaves, ctx: DictionaryColumn(leaves[0], ctx[0], leaves[1],
                                         _canonical=True, ordered=ctx[1]),
    serialized_type_name="arrow_tpu_torch.DictionaryColumn")
pytree.register_pytree_node(
    NullColumn,
    lambda c: ([c.validity], None),
    lambda leaves, _: NullColumn(leaves[0].shape[0], leaves[0].device),
    serialized_type_name="arrow_tpu_torch.NullColumn")
pytree.register_pytree_node(
    ListColumn,
    lambda c: ([c.offsets, c.child, c.validity], c._large()),
    lambda leaves, large: ListColumn(leaves[0], leaves[1], leaves[2], large),
    serialized_type_name="arrow_tpu_torch.ListColumn")
pytree.register_pytree_node(
    StructColumn,
    lambda c: ([list(c.children), c.validity], c.fields),
    lambda leaves, fields: StructColumn(leaves[0], fields, leaves[1]),
    serialized_type_name="arrow_tpu_torch.StructColumn")


# ---- constructors ----------------------------------------------------------

def _host_buffer(a, dtype) -> np.ndarray:
    """A contiguous, writable numpy array torch can wrap (copies only when
    `a` is not already one, e.g. a read-only view of a device array)."""
    return np.require(a, dtype=dtype, requirements=["C", "W"])


def from_numpy(values: np.ndarray, validity: Optional[np.ndarray] = None,
               dtype: Optional[dt.DataType] = None,
               device: DeviceLike = None, dictionary=None,
               ordered: bool = False) -> Column:
    """Build a port column from plain numpy buffers on `device`.

    values: the value buffer, or the codes when `dictionary` is given;
    validity: bool array or None; dtype: logical type (inferred from the
    numpy dtype when None); dictionary: the dictionary's values, a Column
    (its type is kept) or a Python list (built on `device`, its type
    inferred); ordered: the dictionary type's ordered flag.  This is the
    port's way in for the reference's state: a table's buffers, walked
    to numpy.
    """
    dev = resolve_device(device)
    values = np.asarray(values)
    mask = None if validity is None else torch.from_numpy(
        _host_buffer(validity, bool)).to(dev)
    if dictionary is not None:
        if not isinstance(dictionary, Column):
            dictionary = column(list(dictionary), device=dev)
        codes = torch.from_numpy(_host_buffer(values, values.dtype)).to(dev)
        return DictionaryColumn(codes, dictionary, mask, ordered=ordered)
    ldt = dtype or dt.from_numpy_dtype(values.dtype)
    if not ldt.is_single_tensor:
        raise ArrowNotImplementedError(
            f"from_numpy for {ldt!r}: build its layout from core/nested.py")
    host = _host_buffer(values, ldt.to_numpy())
    storage = torch.from_numpy(host.view(ldt.storage_numpy()))
    return PrimitiveColumn(storage.to(dev), ldt, mask)


def column(data, dtype: Optional[dt.DataType] = None, validity=None, *,
           device: DeviceLike = None) -> Column:
    """Build a Column from a Python list, a numpy array or a pyarrow
    array, on `device`.

    Python lists may contain None (nulls).  Strings and bytes become a
    StringColumn of any string or binary type, lists (of lists) a
    ListColumn and dicts a StructColumn given its type; decimal128/256
    take `decimal.Decimal`s (scaled exactly) or ints (whole units),
    decimal32/64 their unscaled ints, as in the reference;
    interval[month_day_nano] (months, days, nanos) tuples or dicts;
    fixed-size binary, fixed-size list, map and dictionary types go
    through their builders (core/builders.py).
    """
    if isinstance(data, Column):
        return data
    if type(data).__module__.startswith("pyarrow"):
        from ..io.interop import column_from_pyarrow
        return column_from_pyarrow(data, device)
    if isinstance(data, np.ndarray) and data.dtype != object:
        return from_numpy(data, validity, dtype, device)
    if isinstance(data, (list, tuple)):
        return _column_from_pylist(list(data), dtype, validity, device)
    raise ArrowTypeError(f"cannot build column from {type(data)}")


def _column_from_pylist(values: list, dtype, validity, device) -> Column:
    non_null = [v for v in values if v is not None]
    if dtype is None:
        if not non_null:
            return NullColumn(len(values), resolve_device(device))
        v0 = non_null[0]
        if isinstance(v0, (bool, np.bool_)):
            dtype = dt.bool_
        elif isinstance(v0, (int, np.integer)):
            dtype = dt.int64
        elif isinstance(v0, (float, np.floating)):
            dtype = dt.float64
        elif isinstance(v0, str):
            dtype = dt.utf8
        elif isinstance(v0, (bytes, bytearray)):
            dtype = dt.binary
        elif isinstance(v0, (list, tuple)):
            inner = _column_from_pylist([x for row in non_null for x in row],
                                        None, None, device)
            dtype = dt.list_(inner.dtype)
        else:
            raise ArrowTypeError(f"cannot infer dtype from {type(v0)}")
    if (dtype.is_string or dtype.is_binary) \
            and dtype.name != "fixed_size_binary":
        return StringColumn.from_pylist(values, dtype, device=device)
    if dtype.is_null:
        return NullColumn(len(values), resolve_device(device))
    if dtype.name in ("list", "large_list"):
        return _list_from_pylist(values, dtype, device)
    if dtype.name == "struct":
        kids = [_column_from_pylist(
            [None if row is None else
             (row.get(f.name) if isinstance(row, dict) else row[i])
             for row in values], f.dtype, None, device)
            for i, f in enumerate(dtype.fields)]
        mask = None if len(non_null) == len(values) else torch.tensor(
            [v is not None for v in values], device=resolve_device(device))
        return StructColumn(kids, dtype.fields, mask)
    if dtype.name in ("decimal128", "decimal256"):
        # a Decimal scales exactly; an int is whole units (column.py:522)
        values = [None if v is None else _unscaled(v, dtype.scale)
                  for v in values]
    if dtype.name in ("decimal128", "decimal256", "fixed_size_binary",
                      "fixed_size_list", "map", "dictionary") \
            or dtype.unit == "month_day_nano":
        from .builders import make_builder
        b = make_builder(dtype, device)
        for v in values:
            b.append_null() if v is None else b.append(v)
        return b.finish()
    if not dtype.is_single_tensor:
        raise ArrowNotImplementedError(f"column of {dtype!r}")
    if validity is None and len(non_null) != len(values):
        validity = np.asarray([v is not None for v in values], dtype=bool)
    filled = np.asarray([0 if v is None else v for v in values],
                        dtype=dtype.to_numpy())
    return from_numpy(filled, validity, dtype, device)


def _unscaled(v, scale: int) -> int:
    """The unscaled int of a Decimal (exactly) or of whole units."""
    import decimal
    if not isinstance(v, decimal.Decimal):
        return int(v) * 10 ** scale
    scaled = v.scaleb(scale, _EXACT)
    if scaled != scaled.to_integral_value():
        raise ArrowInvalid(f"{v} does not fit scale {scale}")
    return int(scaled)


def _list_from_pylist(values: list, dtype: dt.DataType, device) -> ListColumn:
    """ListArray::from_iter (list_array.rs:169): the rows' items as one
    child, offsets from their lengths."""
    large = dtype.name == "large_list"
    lens = [0 if row is None else len(row) for row in values]
    offsets = np.zeros(len(values) + 1, np.int64 if large else np.int32)
    np.cumsum(lens, out=offsets[1:])
    child = _column_from_pylist([x for row in values if row is not None
                                 for x in row], dtype.value_type, None,
                                device)
    dev = resolve_device(device)
    mask = None if all(row is not None for row in values) else torch.tensor(
        [row is not None for row in values], device=dev)
    return ListColumn(torch.from_numpy(offsets).to(dev), child, mask, large)
