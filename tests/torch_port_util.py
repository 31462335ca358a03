"""Helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

The same numpy inputs go through the JAX package (the reference) and
through `arrow_tpu_torch`; outputs compare with the reference's
`_py_equal` rule: values, validity, dtype and row order all match, and
floats compare by their bits (NaN equals NaN, -0.0 differs from 0.0).
Only tests import both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.core.column import _py_equal


@pytest.fixture
def cuda_device():
    """The card, for tests of a kernel against its plain version; the
    test skips where there is none.  Decided here, at run time, never
    while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel against its plain version")
    return torch.device("cuda")


def port_dtype(ref_dtype) -> att.dtypes.DataType:
    """The port's logical type for a reference type."""
    if ref_dtype.name == "dictionary":
        return att.dtypes.dictionary(port_dtype(ref_dtype.index_type),
                                     port_dtype(ref_dtype.value_type),
                                     ordered=bool(ref_dtype.ordered))
    if ref_dtype.name == "bool":
        return att.dtypes.bool_
    return getattr(att.dtypes, ref_dtype.name)


def column_spec(col) -> dict:
    """Walk a reference column into numpy: keyword arguments of
    arrow_tpu_torch.core.column.from_numpy."""
    validity = None if col.validity is None else np.asarray(col.validity)
    if isinstance(col, at.DictionaryColumn):
        return {"values": np.asarray(col.codes), "validity": validity,
                "dictionary": col.values.to_pylist()}
    return {"values": np.asarray(col.values), "validity": validity,
            "dtype": port_dtype(col.dtype)}


def port_column(col, device="cpu"):
    """The port's column holding the same buffers as a reference column."""
    return att.from_numpy(device=device, **column_spec(col))


def port_table(table, device="cpu") -> att.Table:
    """The port's Table holding the same buffers as a reference Table."""
    return att.Table.from_numpy_columns(
        {f.name: column_spec(c)
         for f, c in zip(table.schema.fields, table.columns)},
        device=device)


def assert_same(got, want, what="") -> None:
    """`_py_equal`, with the first difference in the message."""
    if _py_equal(got, want):
        return
    if isinstance(got, list) and isinstance(want, list) \
            and len(got) == len(want):
        i = next(i for i, (a, b) in enumerate(zip(got, want))
                 if not _py_equal(a, b))
        raise AssertionError(f"{what}[{i}]: {got[i]!r} != {want[i]!r}")
    raise AssertionError(f"{what}: {got!r} != {want!r}")


def assert_columns_equal(got, want, what="") -> None:
    assert repr(got.dtype) == repr(want.dtype), (what, got.dtype, want.dtype)
    assert_same(got.to_pylist(), want.to_pylist(), what)


def assert_tables_equal(got, want) -> None:
    """Same names, dtypes, rows and values (to_pydict under _py_equal)."""
    assert got.column_names == want.column_names
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        assert_columns_equal(g, w, name)


def bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of a numpy array, for bitwise comparison."""
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != bool else a
