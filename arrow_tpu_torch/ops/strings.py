"""Dictionary encoding, string ranks and string comparisons (counterpart
of arrow_tpu/ops/strings.py: dictionary_encode, dictionary_decode,
_as_dict, _scalar_str, compare, _compare_scalar, merged_string_ranks,
_compare_cols and _dict_slot_validity, which also stands for
_effective_validity, strings.py:45-245).

A StringColumn lives on its device (core/column.py).  What needs the
strings' order runs where the reference runs it, on the host, through
the native library (utils/hostcodec.py): one copy of the buffers to the
host, a hash interning pass, a sort of the distinct values only, and the
codes back to the device.
  - `dictionary_encode` gives value-sorted values, so its codes are the
    values' ranks; sorts, group-bys and joins key a StringColumn by them.
  - `dictionary_decode` is a `take` of the values on the device.
  - Ranks of a dictionary's values and the merged ranks of two value
    sets (join keys, dictionary against dictionary) come from the same
    interning and sort.
  - A predicate against a literal is evaluated once per dictionary value
    by merging the literal into the values' ranks; the per-code result
    goes to the device once, cached on the dictionary's values keyed by
    op, literal and device, and is gathered there by the codes.  The
    cache lets `fuse` capture the gather: a copy from host memory cannot
    be captured.  A StringColumn is dictionary-encoded first.
The other string kernels join with ROADMAP A7.5.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import capturing
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.datum import Scalar
from ..errors import ArrowNotImplementedError, ArrowTypeError
from ..utils import hostcodec

__all__ = ["dictionary_encode", "dictionary_decode", "value_ranks",
           "merged_string_ranks", "compare", "device_table"]


def _host_buffers(col: StringColumn) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 offsets, bytes) of a string column on the host."""
    return (col.offsets.cpu().numpy().astype(np.int64, copy=False),
            col.data.cpu().numpy())


def _dense_ranks(offs: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Dense uint64 ranks of the strings in byte order: equal strings
    share a rank (interning, then a sort of the distinct values)."""
    codes, uniq = hostcodec.intern_varlen(offs, data)
    uoffs, udata = hostcodec.gather_varlen(offs, data, uniq)
    order = hostcodec.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(len(uniq), 1), np.uint64)
    remap[order] = np.arange(len(uniq), dtype=np.uint64)
    return remap[codes]


def dictionary_encode(col: Column, code_dtype: torch.dtype = torch.int32,
                      ordered: bool = False) -> DictionaryColumn:
    """StringColumn -> DictionaryColumn with value-sorted distinct values
    (strings.py:45-78), on the column's device: the codes are the values'
    ranks.  Null rows keep their bytes in the interning, as the
    reference's do, and take code 0.  `ordered` marks the type ordered.
    A dictionary passes through."""
    if isinstance(col, DictionaryColumn):
        return col
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"dictionary_encode of {type(col).__name__}")
    offs, data = _host_buffers(col)
    codes, uniq = hostcodec.intern_varlen(offs, data)
    u = len(uniq)
    uoffs, udata = hostcodec.gather_varlen(offs, data, uniq)
    order = hostcodec.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(u, 1), np.int32)
    remap[order] = np.arange(u, dtype=np.int32)
    new_offs, new_data = hostcodec.gather_varlen(uoffs, udata, order)
    values = StringColumn.from_numpy(new_offs.astype(np.int32), new_data,
                                     dtype=col.dtype, device=col.device)
    # sorted and distinct: each value's rank is its slot
    values._value_ranks = (np.arange(u, dtype=np.uint64), np.zeros(u, bool))
    codes = torch.from_numpy(remap[codes].astype(
        dt.torch_dtype_name(code_dtype))).to(col.device)
    return DictionaryColumn(codes, values, col.validity,
                            _canonical=col.validity is None, ordered=ordered)


def dictionary_decode(col: DictionaryColumn) -> Column:
    """The dictionary's values at every row (strings.py:81-87): a take of
    the values by the codes, on the device."""
    from .take import take
    idx = PrimitiveColumn(col.codes, col.dtype.index_type, col.validity,
                          _canonical=True)
    return take(col.values, idx)


def value_ranks(values: StringColumn) -> Tuple[np.ndarray, np.ndarray]:
    """(dense uint64 ranks, is_null) per slot of a string dictionary's
    values: the valid values ranked by their bytes, null slots rank 0
    (row_format.py:92-115)."""
    is_null = np.zeros(len(values), bool) if values.validity is None \
        else ~values.validity.cpu().numpy()
    ranks = np.zeros(len(values), np.uint64)
    valid = np.nonzero(~is_null)[0]
    if len(valid):
        offs, data = hostcodec.gather_varlen(*_host_buffers(values), valid)
        ranks[valid] = _dense_ranks(offs, data)
    return ranks, is_null


def merged_string_ranks(lv: StringColumn, rv: StringColumn
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense uint64 ranks of two value sets in one merged byte-ordered
    domain (strings.py:183-199): (left ranks, right ranks), one per
    slot; a null slot ranks by its bytes."""
    lo, ld = _host_buffers(lv)
    ro, rd = _host_buffers(rv)
    offs = np.concatenate([lo - lo[0], ro[1:] - ro[0] + (lo[-1] - lo[0])])
    data = np.concatenate([ld[lo[0]:lo[-1]], rd[ro[0]:ro[-1]]])
    ranks = _dense_ranks(offs, data)
    return ranks[:len(lv)], ranks[len(lv):]


def _dict_slot_validity(dcol: DictionaryColumn) -> vd.Mask:
    """The dictionary's validity with its null value slots folded in
    (the reference's _dict_slot_validity and _effective_validity)."""
    entries = getattr(dcol.values, "validity", None)
    if entries is None:
        return dcol.validity
    entry_valid = device_table(dcol.values, ("entry_valid",), dcol.device,
                               lambda: entries.cpu().numpy())
    return vd.union(dcol.validity, _gather(entry_valid, dcol.codes))


def device_table(owner, key, device: torch.device,
                 build: Callable[[], np.ndarray]) -> torch.Tensor:
    """A host-built table on `device`, cached on `owner` (a dictionary's
    values) under `key`: built and copied once, reused afterwards, also
    by a pipeline `fuse` captures (where the copy could not run)."""
    cache = owner.__dict__.setdefault("_device_tables", {})
    got = cache.get((key, device))
    if got is None:
        if capturing():
            raise RuntimeError(
                f"arrow_tpu_torch.fuse: the table {key!r} was not built "
                "before the capture; the dictionary's values must be the "
                "same object in every call")
        got = torch.from_numpy(build()).to(device)
        cache[(key, device)] = got
    return got


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, codes.to(torch.int64)
                              if codes.dtype != torch.int32 else codes)


def _scalar_str(x) -> Optional[str]:
    if isinstance(x, Scalar):
        if not x.valid:
            return None
        raise ArrowTypeError("string scalar must be python str")
    if isinstance(x, bytes):
        return x.decode()
    return x


_FROM_SIGN = {
    "eq": lambda c: c == 0, "neq": lambda c: c != 0,
    "lt": lambda c: c < 0, "lt_eq": lambda c: c <= 0,
    "gt": lambda c: c > 0, "gt_eq": lambda c: c >= 0,
}
_FLIP = {"lt": "gt", "gt": "lt", "lt_eq": "gt_eq", "gt_eq": "lt_eq",
         "eq": "eq", "neq": "neq"}


def compare(op: str, lhs, rhs) -> PrimitiveColumn:
    """Dictionary- and string-aware comparison (called from ops.cmp)."""
    lhs_col, rhs_col = isinstance(lhs, Column), isinstance(rhs, Column)
    if lhs_col and not rhs_col:
        return _compare_scalar(op, lhs, rhs)
    if rhs_col and not lhs_col:
        return _compare_scalar(_FLIP[op], rhs, lhs)
    return _compare_cols(op, lhs, rhs)


def _literal_signs(values: StringColumn, lit: str) -> np.ndarray:
    """sign(value - lit) in byte order, one int64 per value slot."""
    lrank, rrank = merged_string_ranks(
        values, StringColumn.from_pylist([lit], values.dtype, device="cpu"))
    return np.sign(lrank.astype(np.int64) - rrank.astype(np.int64)[0])


def _compare_scalar(op: str, col: Column, scalar_val) -> PrimitiveColumn:
    s = _scalar_str(scalar_val)
    n, device = len(col), col.device
    if s is None:
        zeros = torch.zeros((n,), dtype=torch.bool, device=device)
        return PrimitiveColumn(zeros, dt.bool_, zeros.clone())
    dcol = dictionary_encode(col)
    if not isinstance(dcol.values, StringColumn):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    per_code = device_table(dcol.values, ("cmp", op, s), device, lambda: (
        _FROM_SIGN[op](_literal_signs(dcol.values, s))))
    return PrimitiveColumn(_gather(per_code, dcol.codes), dt.bool_,
                           _dict_slot_validity(dcol))


def _compare_cols(op: str, lhs: Column, rhs: Column) -> PrimitiveColumn:
    """Dictionary against dictionary: both map into one merged rank
    domain on the host (cmp.rs:468), the ranks compare on the device."""
    dl, dr = dictionary_encode(lhs), dictionary_encode(rhs)
    lv, rv = dl.values, dr.values
    if not (isinstance(lv, StringColumn) and isinstance(rv, StringColumn)):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    lrank, rrank = merged_string_ranks(lv, rv)
    validity = vd.union(_dict_slot_validity(dl), _dict_slot_validity(dr))
    lk = _gather(torch.from_numpy(lrank.astype(np.int64)).to(dl.device),
                 dl.codes)
    rk = _gather(torch.from_numpy(rrank.astype(np.int64)).to(dr.device),
                 dr.codes)
    from .cmp import _OPS
    return PrimitiveColumn(_OPS[op](lk, rk), dt.bool_, validity)
