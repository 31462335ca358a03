"""The other array layouts (counterpart of arrow_tpu/core/nested.py):
fixed-size list and binary, map, union, run-end, decimal128/256,
interval[month_day_nano] and list view (arrow-array fixed_size_list,
fixed_size_binary_array.rs:53, map_array.rs:36, union_array.rs:123,
run_array.rs:63, list_view_array.rs).

Each column is a set of tensors on one explicit device with `slice`,
`with_validity`, `to_pylist` and `__len__`, and a torch pytree node (its
tensors and child columns are the leaves).  As in the reference, these
constructors keep the bits under null slots as given: a take by a null
index gathers row 0's bits there, in both packages.

`DecimalColumn` keeps the reference's little-endian u64 limb planes on
int64 storage holding the same bits (the unsigned rule of dtypes.py):
(n, 2) for decimal128 and (n, 4) for decimal256, two's complement over
all 64 * k bits.  `from_pyints` / `to_pyints` convert exactly through
Python ints.  decimal32/64 are PrimitiveColumns of int32/int64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..errors import ArrowInvalid, ArrowTypeError
from . import validity as vd
from .column import (Column, PrimitiveColumn, StructColumn, _check_mask,
                     _decimal_value, _offset_rows)

__all__ = ["FixedSizeListColumn", "FixedSizeBinaryColumn", "MapColumn",
           "UnionColumn", "RunEndColumn", "DecimalColumn",
           "IntervalMDNColumn", "ListViewColumn"]

_U64 = (1 << 64) - 1


def _sliced(mask: vd.Mask, offset: int, length: int) -> vd.Mask:
    return None if mask is None else mask[offset:offset + length]


def _masked(values: list, mask) -> list:
    if mask is None:
        return values
    return [v if ok else None for v, ok in zip(values, mask.tolist())]


class FixedSizeListColumn(Column):
    """FixedSizeList<T, k>: a child of len * k rows, no offsets."""

    def __init__(self, child: Column, list_size: int,
                 validity: vd.Mask = None):
        k = int(list_size)
        if len(child) % max(k, 1):
            raise ArrowInvalid(f"fixed-size list: {len(child)} child rows "
                               f"are not a multiple of {k}")
        self.child = child
        self.list_size = k
        self.validity = validity
        self.dtype = dt.fixed_size_list(child.dtype, k)
        _check_mask(validity, len(self), child.device)

    def __len__(self):
        return 0 if self.list_size == 0 else len(self.child) // self.list_size

    @property
    def device(self) -> torch.device:
        return self.child.device

    def with_validity(self, validity):
        return FixedSizeListColumn(self.child, self.list_size, validity)

    def slice(self, offset, length):
        k = self.list_size
        return FixedSizeListColumn(self.child.slice(offset * k, length * k),
                                   k, _sliced(self.validity, offset, length))

    def to_pylist(self) -> list:
        vals, k = self.child.to_pylist(), self.list_size
        return _masked([vals[i * k:(i + 1) * k] for i in range(len(self))],
                       self._mask_host())


class FixedSizeBinaryColumn(Column):
    """FixedSizeBinary(w): an (n, w) uint8 tensor."""

    def __init__(self, data: torch.Tensor, validity: vd.Mask = None):
        if data.dim() != 2 or data.dtype != torch.uint8:
            raise ArrowInvalid("fixed-size binary data must be (n, w) uint8")
        _check_mask(validity, data.shape[0], data.device)
        self.data = data
        self.validity = validity
        self.dtype = dt.fixed_size_binary(int(data.shape[1]))

    @property
    def byte_width(self) -> int:
        return int(self.data.shape[1])

    def __len__(self):
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def with_validity(self, validity):
        return FixedSizeBinaryColumn(self.data, validity)

    def slice(self, offset, length):
        return FixedSizeBinaryColumn(self.data[offset:offset + length],
                                     _sliced(self.validity, offset, length))

    def to_pylist(self) -> list:
        rows = self.data.cpu().numpy()
        return _masked([r.tobytes() for r in rows], self._mask_host())


class MapColumn(Column):
    """Map<K, V>: int32 offsets (n+1,) over a {key, value} struct."""

    def __init__(self, offsets: torch.Tensor, entries: StructColumn,
                 validity: vd.Mask = None):
        if len(entries.fields) != 2:
            raise ArrowInvalid("map entries are a two-field struct")
        _check_mask(validity, offsets.shape[0] - 1, offsets.device)
        self.offsets = offsets
        self.entries = entries
        self.validity = validity
        self.dtype = dt.map_(entries.fields[0].dtype, entries.fields[1].dtype)

    @property
    def keys(self) -> Column:
        return self.entries.children[0]

    @property
    def items(self) -> Column:
        return self.entries.children[1]

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def with_validity(self, validity):
        return MapColumn(self.offsets, self.entries, validity)

    def slice(self, offset, length):
        offs = self.offsets[offset:offset + length + 1]
        start, end = offs[[0, -1]].tolist()
        return MapColumn(offs - start, self.entries.slice(start, end - start),
                         _sliced(self.validity, offset, length))

    def to_pylist(self) -> list:
        pairs = list(zip(self.keys.to_pylist(), self.items.to_pylist()))
        return _offset_rows(self.offsets, pairs, self._mask_host())


class UnionColumn(Column):
    """Union: int8 type ids (n,); sparse: every child has n rows and
    offsets is None; dense: int32 offsets (n,) into the children.
    Unions carry no top-level validity (Arrow spec)."""

    def __init__(self, type_ids: torch.Tensor, offsets: Optional[torch.Tensor],
                 children: Sequence[Column], fields: Sequence[dt.Field],
                 ids: Optional[Sequence[int]] = None):
        self.type_ids = type_ids
        self.offsets = offsets
        self.children = tuple(children)
        self.fields = tuple(fields)
        self.ids = tuple(ids) if ids is not None \
            else tuple(range(len(self.children)))
        self.validity = None
        self.dtype = dt.union(self.fields, self.mode, self.ids)

    @property
    def mode(self) -> str:
        return "sparse" if self.offsets is None else "dense"

    def __len__(self):
        return int(self.type_ids.shape[0])

    @property
    def device(self) -> torch.device:
        return self.type_ids.device

    def with_validity(self, validity):
        raise TypeError("union arrays carry no top-level validity")

    def child_index(self, type_id: int) -> int:
        return self.ids.index(type_id)

    def slice(self, offset, length):
        tids = self.type_ids[offset:offset + length]
        if self.offsets is None:
            return UnionColumn(tids, None, [c.slice(offset, length)
                                            for c in self.children],
                               self.fields, self.ids)
        return UnionColumn(tids, self.offsets[offset:offset + length],
                           self.children, self.fields, self.ids)

    def to_pylist(self) -> list:
        kids = [c.to_pylist() for c in self.children]
        slot = {t: i for i, t in enumerate(self.ids)}
        tids = self.type_ids.cpu().numpy().tolist()
        rows = range(len(tids)) if self.offsets is None \
            else self.offsets.cpu().numpy().tolist()
        return [kids[slot[t]][r] for t, r in zip(tids, rows)]


class RunEndColumn(Column):
    """RunEndEncoded: strictly increasing run ends (int16/32/64, the last
    equal to the logical length) and one value per run; nulls live in
    the values."""

    def __init__(self, run_ends: torch.Tensor, values: Column,
                 length: Optional[int] = None):
        self.run_ends = run_ends
        self.values = values
        self._length = int(length) if length is not None else (
            int(run_ends[-1]) if run_ends.shape[0] else 0)
        self.validity = None
        self.dtype = dt.run_end_encoded(
            dt.from_numpy_dtype(dt.torch_dtype_name(run_ends.dtype)),
            values.dtype)

    def __len__(self):
        return self._length

    @property
    def device(self) -> torch.device:
        return self.run_ends.device

    @property
    def num_runs(self) -> int:
        return int(self.run_ends.shape[0])

    def row_to_run(self, rows: torch.Tensor) -> torch.Tensor:
        """The run of each logical row (searchsorted, right side)."""
        return torch.searchsorted(self.run_ends.to(torch.int64),
                                  rows.to(torch.int64), right=True
                                  ).to(torch.int32)

    def with_validity(self, validity):
        raise TypeError("run-end arrays carry no top-level validity")

    def slice(self, offset, length):
        """A logical slice: run ends shifted and clamped, the runs left
        empty dropped (one host read of the kept runs)."""
        from ..ops.take import take
        new_re = (self.run_ends.to(torch.int64) - offset).clamp(0, length)
        prev = torch.cat([new_re.new_zeros(1), new_re[:-1]])
        idx = ((new_re > 0) & (prev < length)).nonzero().squeeze(1)
        return RunEndColumn(new_re[idx].to(self.run_ends.dtype),
                            take(self.values, PrimitiveColumn(idx, dt.int64)),
                            length)

    def to_pylist(self) -> list:
        vals = self.values.to_pylist()
        if not len(self):
            return []
        runs = self.row_to_run(torch.arange(len(self), device=self.device))
        return [vals[r] for r in runs.cpu().numpy().tolist()]


class DecimalColumn(Column):
    """Decimal128 / Decimal256: u64 limb planes, little endian, on int64
    storage: (n, 2) or (n, 4)."""

    def __init__(self, limbs: torch.Tensor, dtype: dt.DataType,
                 validity: vd.Mask = None):
        k = {"decimal128": 2, "decimal256": 4}.get(dtype.name)
        if k is None:
            raise ArrowTypeError(f"DecimalColumn of {dtype!r}: decimal32/64 "
                                 "are PrimitiveColumns")
        if limbs.dim() != 2 or limbs.shape[1] != k \
                or limbs.dtype != torch.int64:
            raise ArrowInvalid(f"{dtype!r} needs (n, {k}) int64 limbs, got "
                               f"{tuple(limbs.shape)} {limbs.dtype}")
        _check_mask(validity, limbs.shape[0], limbs.device)
        self.limbs = limbs
        self.validity = validity
        self.dtype = dtype

    def __len__(self):
        return int(self.limbs.shape[0])

    @property
    def device(self) -> torch.device:
        return self.limbs.device

    def with_validity(self, validity):
        return DecimalColumn(self.limbs, self.dtype, validity)

    def slice(self, offset, length):
        return DecimalColumn(self.limbs[offset:offset + length], self.dtype,
                             _sliced(self.validity, offset, length))

    @staticmethod
    def from_pyints(ints: Sequence, dtype: dt.DataType,
                    validity: vd.Mask = None, *,
                    device: DeviceLike = None) -> "DecimalColumn":
        """Unscaled Python ints (two's complement over 64 * k bits) on
        `device`, or on the validity's device when it is given."""
        dev = validity.device if validity is not None \
            else resolve_device(device)
        k = 2 if dtype.name == "decimal128" else 4
        us = [int(v) & ((1 << (64 * k)) - 1) for v in ints]
        planes = np.empty((len(us), k), np.uint64)
        for j in range(k):
            planes[:, j] = [(u >> (64 * j)) & _U64 for u in us]
        return DecimalColumn(torch.from_numpy(planes.view(np.int64)).to(dev),
                             dtype, validity)

    def to_pyints(self) -> list:
        """Unscaled Python ints, None at nulls."""
        limbs = self.limbs.cpu().numpy().view(np.uint64)
        k = limbs.shape[1]
        bits = 64 * k
        us = [0] * limbs.shape[0]
        for j in range(k):
            plane = limbs[:, j].tolist()
            us = [u | (p << (64 * j)) for u, p in zip(us, plane)]
        vals = [u - (1 << bits) if u >> (bits - 1) else u for u in us]
        return _masked(vals, self._mask_host())

    def to_pylist(self) -> list:
        s = self.dtype.scale
        return [None if v is None else _decimal_value(v, s)
                for v in self.to_pyints()]


class IntervalMDNColumn(Column):
    """Interval[month_day_nano]: months int32, days int32 and nanoseconds
    int64 tensors."""

    def __init__(self, months: torch.Tensor, days: torch.Tensor,
                 nanos: torch.Tensor, validity: vd.Mask = None):
        self.months = months.to(torch.int32)
        self.days = days.to(torch.int32)
        self.nanos = nanos.to(torch.int64)
        _check_mask(validity, self.months.shape[0], self.months.device)
        self.validity = validity
        self.dtype = dt.interval("month_day_nano")

    def __len__(self):
        return int(self.months.shape[0])

    @property
    def device(self) -> torch.device:
        return self.months.device

    def with_validity(self, validity):
        return IntervalMDNColumn(self.months, self.days, self.nanos,
                                 validity)

    def slice(self, offset, length):
        s = slice(offset, offset + length)
        return IntervalMDNColumn(self.months[s], self.days[s], self.nanos[s],
                                 _sliced(self.validity, offset, length))

    def to_pylist(self) -> list:
        """(months, days, nanoseconds) tuples, None at nulls (equal to
        pyarrow's MonthDayNano)."""
        parts = zip(*(t.cpu().numpy().tolist()
                      for t in (self.months, self.days, self.nanos)))
        return _masked(list(parts), self._mask_host())


class ListViewColumn(Column):
    """ListView / LargeListView: offsets and sizes (n,) over a shared
    child; row i is child[offsets[i]:offsets[i] + sizes[i]].  Views may
    overlap, be out of order or leave gaps, so take and slice touch the
    views only."""

    def __init__(self, offsets: torch.Tensor, sizes: torch.Tensor,
                 child: Column, validity: vd.Mask = None,
                 dtype: Optional[dt.DataType] = None):
        self.offsets = offsets
        self.sizes = sizes
        self.child = child
        self.validity = validity
        self.dtype = dtype if dtype is not None else dt.list_view(child.dtype)
        if self.dtype.name not in ("list_view", "large_list_view"):
            raise ArrowTypeError(f"ListViewColumn of {self.dtype!r}")
        _check_mask(validity, offsets.shape[0], offsets.device)

    def __len__(self):
        return int(self.offsets.shape[0])

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def with_validity(self, validity):
        return ListViewColumn(self.offsets, self.sizes, self.child, validity,
                              self.dtype)

    def slice(self, offset, length):
        s = slice(offset, offset + length)
        return ListViewColumn(self.offsets[s], self.sizes[s], self.child,
                              _sliced(self.validity, offset, length),
                              self.dtype)

    def to_pylist(self) -> list:
        vals = self.child.to_pylist()
        rows = zip(self.offsets.cpu().numpy().tolist(),
                   self.sizes.cpu().numpy().tolist())
        return _masked([vals[o:o + z] for o, z in rows], self._mask_host())


pytree.register_pytree_node(
    FixedSizeListColumn, lambda c: ([c.child, c.validity], c.list_size),
    lambda v, k: FixedSizeListColumn(v[0], k, v[1]),
    serialized_type_name="arrow_tpu_torch.FixedSizeListColumn")
pytree.register_pytree_node(
    FixedSizeBinaryColumn, lambda c: ([c.data, c.validity], None),
    lambda v, _: FixedSizeBinaryColumn(v[0], v[1]),
    serialized_type_name="arrow_tpu_torch.FixedSizeBinaryColumn")
pytree.register_pytree_node(
    MapColumn, lambda c: ([c.offsets, c.entries, c.validity], None),
    lambda v, _: MapColumn(v[0], v[1], v[2]),
    serialized_type_name="arrow_tpu_torch.MapColumn")
pytree.register_pytree_node(
    UnionColumn,
    lambda c: ([c.type_ids, c.offsets, list(c.children)], (c.fields, c.ids)),
    lambda v, ctx: UnionColumn(v[0], v[1], v[2], *ctx),
    serialized_type_name="arrow_tpu_torch.UnionColumn")
pytree.register_pytree_node(
    RunEndColumn, lambda c: ([c.run_ends, c.values], c._length),
    lambda v, n: RunEndColumn(v[0], v[1], n),
    serialized_type_name="arrow_tpu_torch.RunEndColumn")
pytree.register_pytree_node(
    DecimalColumn, lambda c: ([c.limbs, c.validity], c.dtype),
    lambda v, d: DecimalColumn(v[0], d, v[1]),
    serialized_type_name="arrow_tpu_torch.DecimalColumn")
pytree.register_pytree_node(
    IntervalMDNColumn,
    lambda c: ([c.months, c.days, c.nanos, c.validity], None),
    lambda v, _: IntervalMDNColumn(*v),
    serialized_type_name="arrow_tpu_torch.IntervalMDNColumn")
pytree.register_pytree_node(
    ListViewColumn,
    lambda c: ([c.offsets, c.sizes, c.child, c.validity], c.dtype),
    lambda v, d: ListViewColumn(v[0], v[1], v[2], v[3], d),
    serialized_type_name="arrow_tpu_torch.ListViewColumn")
