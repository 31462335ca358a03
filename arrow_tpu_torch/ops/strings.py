"""String keys and string comparisons (counterpart of
arrow_tpu/ops/strings.py: _as_dict, _scalar_str, compare,
_compare_scalar, merged_string_ranks, _compare_cols and
_dict_slot_validity, which also stands for _effective_validity,
strings.py:97-245).

Strings stay on the host in this port (core/column.py).
  - Join keys: both sides are ranked there, in one merged domain ordered
    by UTF-8 bytes (the order of `row_format.dictionary_value_ranks`),
    and the ranks go to the device as int64 keys.  The reference interns
    and sorts the values with its native library; numpy's sort of byte
    strings gives the same dense ranks.
  - A dictionary predicate (`eq(dict_col, "word-0042")`) is evaluated
    once per dictionary value on the host; the per-code result goes to
    the device once, cached on the dictionary's values keyed by op,
    literal and device, and is gathered there by the codes.  The cache
    lets `fuse` capture the gather: a copy from host memory cannot be
    captured.
  - A StringColumn against a literal is compared on the host; two
    dictionaries compare by their merged ranks.
The other string kernels join with ROADMAP A7.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import capturing
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.datum import Scalar
from ..errors import ArrowNotImplementedError, ArrowTypeError

__all__ = ["string_ranks", "merged_string_ranks", "compare", "device_table"]


def _as_dict(col: Column, device: torch.device) -> DictionaryColumn:
    """`col` as a dictionary: a StringColumn becomes its own dictionary,
    one code per row, with codes on `device`."""
    if isinstance(col, DictionaryColumn):
        return col
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"dictionary_encode of {type(col).__name__}")
    validity = None if col.validity is None else col.validity.to(device)
    return DictionaryColumn(torch.arange(len(col), device=device), col,
                            validity, _canonical=True)


def string_ranks(values: List[Optional[str]]) -> np.ndarray:
    """Dense ranks (uint64) of strings in UTF-8 byte order: equal strings
    share a rank; None ranks as the empty string, as the reference
    interns a null slot's empty bytes."""
    words = np.array([b"" if s is None else s.encode() for s in values],
                     dtype=object)
    if not len(words):
        return np.zeros(0, np.uint64)
    return np.unique(words, return_inverse=True)[1].reshape(-1) \
        .astype(np.uint64)


def merged_string_ranks(lv: StringColumn, rv: StringColumn
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Ranks of two value sets in one merged domain: (left ranks, right
    ranks), one per value slot."""
    ranks = string_ranks(lv.to_pylist() + rv.to_pylist())
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


def _dict_values_host(col: DictionaryColumn) -> List[Optional[str]]:
    if isinstance(col.values, StringColumn):
        return col.values.to_pylist()
    raise ArrowNotImplementedError("non-string dictionary predicate")


def _scalar_str(x) -> Optional[str]:
    if isinstance(x, Scalar):
        if not x.valid:
            return None
        raise ArrowTypeError("string scalar must be python str")
    if isinstance(x, bytes):
        return x.decode()
    return x


_CMP_FN = {
    "eq": lambda a, b: a == b, "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "lt_eq": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "gt_eq": lambda a, b: a >= b,
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


def _compare_scalar(op: str, col: Column, scalar_val) -> PrimitiveColumn:
    s = _scalar_str(scalar_val)
    n, device = len(col), col.device
    if s is None:
        zeros = torch.zeros((n,), dtype=torch.bool, device=device)
        return PrimitiveColumn(zeros, dt.bool_, zeros.clone())
    fn = _CMP_FN[op]
    if isinstance(col, StringColumn):
        # Python orders str by code point: the UTF-8 byte order
        out = [False if v is None else fn(v, s) for v in col.to_pylist()]
        return PrimitiveColumn(torch.tensor(out, dtype=torch.bool), dt.bool_,
                               col.validity)
    dcol = _as_dict(col, device)
    per_code = device_table(dcol.values, ("cmp", op, s), device, lambda: (
        np.array([False if v is None else fn(v, s)
                  for v in _dict_values_host(dcol)], bool)))
    return PrimitiveColumn(_gather(per_code, dcol.codes), dt.bool_,
                           _dict_slot_validity(dcol))


def _compare_cols(op: str, lhs: Column, rhs: Column) -> PrimitiveColumn:
    """Dictionary against dictionary: both map into one merged rank
    domain on the host (cmp.rs:468), the ranks compare on the device."""
    dl, dr = _as_dict(lhs, lhs.device), _as_dict(rhs, rhs.device)
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

