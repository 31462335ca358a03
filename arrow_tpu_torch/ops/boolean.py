"""Boolean kernels: and, or, not, the Kleene and/or, is_null and
is_not_null (counterpart of arrow_tpu/ops/boolean.py:21-101;
arrow-arith/src/boolean.rs).

`and_` and `or_` are null when either input is (the union of the
validities, boolean.rs:254,271); `and_kleene` and `or_kleene` follow
SQL's three-valued logic (boolean.rs:60,155) and, like the reference,
always return a validity mask.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import PrimitiveColumn
from ..core.datum import Datum, Scalar, as_datum, broadcast_pair
from ..errors import ArrowTypeError

__all__ = ["and_", "or_", "not_", "and_kleene", "or_kleene",
           "is_null", "is_not_null", "bool_is_static_all"]


def _check_bool(*dts) -> None:
    for d in dts:
        if not d.is_boolean:
            raise ArrowTypeError(f"boolean kernel on {d!r}")


def and_(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    lv, rv, mask, _, ldt, rdt = broadcast_pair(lhs, rhs)
    _check_bool(ldt, rdt)
    return PrimitiveColumn(lv & rv, dt.bool_, mask)


def or_(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    lv, rv, mask, _, ldt, rdt = broadcast_pair(lhs, rhs)
    _check_bool(ldt, rdt)
    return PrimitiveColumn(lv | rv, dt.bool_, mask)


def not_(col) -> PrimitiveColumn:
    col = as_datum(col)
    _check_bool(col.dtype)
    return PrimitiveColumn(~col.values, dt.bool_, col.validity)


def _known(x: Datum, n: int, device) -> torch.Tensor:
    x = as_datum(x)
    if isinstance(x, Scalar):
        return torch.full((n,), x.valid, dtype=torch.bool, device=device)
    return vd.make_mask(n, x.validity, device)


def and_kleene(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """false AND null = false; null AND null = null (boolean.rs:60)."""
    lv, rv, _, n, ldt, rdt = broadcast_pair(lhs, rhs)
    _check_bool(ldt, rdt)
    lm, rm = _known(lhs, n, lv.device), _known(rhs, n, lv.device)
    value = lv & lm & rv & rm
    # known where both are, or where either is a valid false
    known = (lm & rm) | (lm & ~lv) | (rm & ~rv)
    return PrimitiveColumn(value, dt.bool_, known)


def or_kleene(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """true OR null = true (boolean.rs:155)."""
    lv, rv, _, n, ldt, rdt = broadcast_pair(lhs, rhs)
    _check_bool(ldt, rdt)
    lm, rm = _known(lhs, n, lv.device), _known(rhs, n, lv.device)
    value = (lv & lm) | (rv & rm)
    known = (lm & rm) | (lm & lv) | (rm & rv)
    return PrimitiveColumn(value, dt.bool_, known)


def bool_is_static_all(mask) -> bool:
    """Whether a mask is all true without reading the device: never
    known, so False (boolean.py:83-86); the Kleene kernels keep their
    mask."""
    return False


def is_null(col) -> PrimitiveColumn:
    """True where the slot is null; no nulls (boolean.rs:325)."""
    col = as_datum(col)
    if col.validity is None:
        return PrimitiveColumn(torch.zeros((len(col),), dtype=torch.bool,
                                           device=col.device), dt.bool_)
    return PrimitiveColumn(~col.validity, dt.bool_)


def is_not_null(col) -> PrimitiveColumn:
    col = as_datum(col)
    if col.validity is None:
        return PrimitiveColumn(torch.ones((len(col),), dtype=torch.bool,
                                          device=col.device), dt.bool_)
    return PrimitiveColumn(col.validity, dt.bool_)
