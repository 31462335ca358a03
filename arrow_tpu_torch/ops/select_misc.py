"""zip, nullif, shift and union_extract (counterpart of
arrow_tpu/ops/select_misc.py; arrow-select/src/{zip.rs,nullif.rs,
window.rs,union_extract.rs}).

  - zip_: a null mask slot takes the falsy side (zip.rs; pyarrow's
    if_else differs).  Primitive operands and scalars select in one
    torch.where; other layouts concatenate truthy and falsy and take
    row i or n + i, the reference's interleave.
  - nullif: nulls where the condition is true; a null condition keeps
    the slot.
  - shift: a primitive column rolls in one pass; other layouts concat a
    null pad and a slice, as the reference does.
  - union_extract: one child as a column, null where the row's type id
    is another; a sparse union masks the child, a dense one takes it by
    the offsets.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, PrimitiveColumn
from ..core.datum import Scalar, as_datum
from ..errors import ArrowInvalid, ArrowTypeError

__all__ = ["zip_", "nullif", "shift", "union_extract"]


def _keep_true(mask: PrimitiveColumn) -> torch.Tensor:
    """True where the boolean column is true and valid."""
    return mask.values if mask.validity is None \
        else mask.values & mask.validity


def zip_(mask, truthy, falsy) -> Column:
    """Element-wise mask ? truthy : falsy (zip.rs:84)."""
    mask, truthy, falsy = as_datum(mask), as_datum(truthy), as_datum(falsy)
    if not mask.dtype.is_boolean:
        raise ArrowTypeError("zip mask must be boolean")
    n, device = len(mask), mask.device
    if not all(isinstance(x, (Scalar, PrimitiveColumn))
               for x in (truthy, falsy)):
        return _zip_generic(mask, truthy, falsy, n)

    def parts(x):
        if isinstance(x, Scalar):
            v = x.value if x.value.device == device else torch.full(
                (), x.value.item(), dtype=x.value.dtype, device=device)
            m = None if x.valid else torch.zeros((n,), dtype=torch.bool,
                                                 device=device)
            return v.expand(n), m, x.dtype
        return x.values, x.validity, x.dtype

    tv, tm, tdt = parts(truthy)
    fv, fm, fdt = parts(falsy)
    if tdt != fdt:
        raise ArrowTypeError(f"zip type mismatch {tdt!r} vs {fdt!r}")
    cond = _keep_true(mask)
    validity = torch.where(cond, vd.make_mask(n, tm, device),
                           vd.make_mask(n, fm, device))
    return PrimitiveColumn(torch.where(cond, tv, fv), tdt, validity)


def _zip_generic(mask, truthy, falsy, n: int) -> Column:
    """zip over any layout: row i of truthy or row n + i of their concat
    (the reference's interleave over (side, row) pairs)."""
    from .concat import concat
    from .take import take
    if isinstance(truthy, Scalar) or isinstance(falsy, Scalar):
        raise ArrowTypeError("zip of non-primitive scalars is not "
                             "supported; broadcast to a column first")
    if truthy.dtype != falsy.dtype:
        raise ArrowTypeError(
            f"zip type mismatch {truthy.dtype!r} vs {falsy.dtype!r}")
    if len(truthy) != n or len(falsy) != n:
        raise ArrowInvalid("zip arrays must share the mask's length")
    rows = torch.arange(n, device=mask.device)
    flat = torch.where(_keep_true(mask), rows, rows + n)
    return take(concat([truthy, falsy]), PrimitiveColumn(flat, dt.int64))


def nullif(col: Column, cond) -> Column:
    """Null where cond is true (nullif.rs:44); a null cond slot keeps
    the original validity."""
    cond = as_datum(cond)
    if not cond.dtype.is_boolean:
        raise ArrowTypeError("nullif condition must be boolean")
    return col.with_validity(vd.union(col.validity, ~_keep_true(cond)))


def shift(col: Column, offset: int) -> Column:
    """Window shift with null fill (window.rs:55): a positive offset moves
    values to higher indices, the vacated slots become null."""
    n = len(col)
    if offset == 0:
        return col
    if not isinstance(col, PrimitiveColumn) or abs(offset) >= n:
        from .cast import _all_null
        from .concat import concat
        k = min(abs(offset), n)
        pad = _all_null(col.dtype, k, col.device)
        if k == n:
            return pad
        if offset > 0:
            return concat([pad, col.slice(0, n - k)])
        return concat([col.slice(k, n - k), pad])
    rolled = torch.roll(col.values, offset)
    idx = torch.arange(n, device=col.device)
    in_range = idx >= offset if offset > 0 else idx < n + offset
    validity = in_range if col.validity is None \
        else torch.roll(col.validity, offset) & in_range
    return PrimitiveColumn(torch.where(in_range, rolled,
                                       torch.zeros_like(rolled)),
                           col.dtype, validity, _canonical=True)


def union_extract(col, field_name: str) -> Column:
    """One union child as a column; rows of other type ids are null
    (union_extract.rs, select_misc.py:113-140)."""
    from ..core.nested import UnionColumn
    if not isinstance(col, UnionColumn):
        raise ArrowTypeError("union_extract expects a union column")
    try:
        i = [f.name for f in col.fields].index(field_name)
    except ValueError:
        raise ArrowInvalid(f"union has no field {field_name!r}")
    selected = col.type_ids == col.ids[i]
    child = col.children[i]
    if len(child) == 0:
        # a dense union with no rows of this type: all null
        from .cast import _all_null
        return _all_null(child.dtype, len(col), col.device)
    if col.offsets is None:                        # sparse
        return child.with_validity(vd.union(child.validity, selected))
    from .take import take
    safe = torch.where(selected, col.offsets, torch.zeros_like(col.offsets))
    out = take(child, PrimitiveColumn(safe.to(torch.int64), dt.int64))
    return out.with_validity(vd.union(out.validity, selected))
