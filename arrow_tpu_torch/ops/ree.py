"""Run-end encoding (counterpart of arrow_tpu/ops/ree.py:22,53;
arrow-array/src/array/run_array.rs:63).

encode: run starts from one shifted inequality on the device (nulls
equal nulls, like RunArray::from_iter), read on the host once for the
run count, the run ends from them, the values by one take.  decode: the
run of each logical row by a searchsorted, then one take.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..core.column import Column, PrimitiveColumn
from ..core.nested import RunEndColumn
from ..errors import ArrowInvalid, ArrowTypeError
from .take import take

__all__ = ["run_end_encode", "run_end_decode"]


def run_end_encode(col: Column, run_end_type: dt.DataType = dt.int32
                   ) -> RunEndColumn:
    """Runs of adjacent equal values of a primitive column; a length past
    the run-end type's range raises ArrowInvalid."""
    if not isinstance(col, PrimitiveColumn):
        raise ArrowTypeError("run_end_encode supports primitive columns "
                             "(dictionary-encode strings first)")
    n = len(col)
    storage = run_end_type.to_torch()
    if n == 0:
        return RunEndColumn(torch.zeros(0, dtype=storage, device=col.device),
                            col.slice(0, 0), 0)
    v = col.values
    neq = v[1:] != v[:-1]
    if col.validity is not None:
        m = col.validity
        # differ where validity flips, or both valid and values differ
        neq = (m[1:] != m[:-1]) | (neq & m[1:] & m[:-1])
    start = torch.cat([neq.new_ones(1), neq])
    starts = start.nonzero().squeeze(1)              # one host sync
    hi = torch.iinfo(storage).max
    if n > hi:
        raise ArrowInvalid(
            f"run ends overflow {run_end_type!r}: length {n} > {hi}")
    run_ends = torch.cat([starts[1:], starts.new_full((1,), n)]).to(storage)
    return RunEndColumn(run_ends, take(col, PrimitiveColumn(starts, dt.int64)),
                        n)


def run_end_decode(col: RunEndColumn) -> Column:
    """The logical rows of a run-end column: one searchsorted and one
    take."""
    if not isinstance(col, RunEndColumn):
        raise ArrowInvalid("run_end_decode expects a RunEndColumn")
    rows = torch.arange(len(col), dtype=torch.int64, device=col.device)
    return take(col.values, PrimitiveColumn(col.row_to_run(rows).to(
        torch.int64), dt.int64))
