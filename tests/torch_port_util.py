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


@pytest.fixture(params=["0", "1"], ids=["sort", "pallas"])
def route(request, monkeypatch):
    """Both routes of the reference: ARROW_TPU_USE_PALLAS=0 (its XLA
    plans) and =1 (its Pallas plans, interpreted on the CPU)."""
    monkeypatch.setenv("ARROW_TPU_USE_PALLAS", request.param)
    return request.param


@pytest.fixture
def cuda_device():
    """The card, for tests of a kernel against its plain version; the
    test skips where there is none.  Decided here, at run time, never
    while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel against its plain version")
    return torch.device("cuda")


def port_dtype(ref_dtype) -> att.dtypes.DataType:
    """The port's logical type for a reference type, nested ones
    included."""
    d, pd = ref_dtype, att.dtypes
    if d.name == "dictionary":
        return pd.dictionary(port_dtype(d.index_type),
                             port_dtype(d.value_type),
                             ordered=bool(d.ordered))
    if d.name == "bool":
        return pd.bool_
    if d.name == "timestamp":
        return pd.timestamp(d.unit, d.tz)
    if d.unit is not None:
        return getattr(pd, d.name)(d.unit)
    if d.is_decimal:
        return getattr(pd, d.name)(d.precision, d.scale)
    if d.name == "fixed_size_binary":
        return pd.fixed_size_binary(d.list_size)
    if d.name == "fixed_size_list":
        return pd.fixed_size_list(port_dtype(d.value_type), d.list_size)
    if d.name in ("list", "large_list", "list_view", "large_list_view"):
        return pd.DataType(d.name, value_type=port_dtype(d.value_type))
    if d.name == "map":
        kv = d.value_type
        return pd.DataType("map", value_type=port_dtype(kv))
    if d.name == "struct":
        return pd.struct([port_field(f) for f in d.fields])
    if d.name == "union":
        return pd.union([port_field(f) for f in d.fields], d.mode,
                        d.type_ids)
    if d.name == "run_end_encoded":
        return pd.run_end_encoded(port_dtype(d.index_type),
                                  port_dtype(d.value_type))
    return getattr(pd, d.name)


def column_spec(col, device="cpu") -> dict:
    """Walk a reference column into numpy: keyword arguments of
    arrow_tpu_torch.core.column.from_numpy (a dictionary's values as the
    port's column on `device`, its type and ordered flag kept)."""
    validity = None if col.validity is None else np.asarray(col.validity)
    if isinstance(col, at.DictionaryColumn):
        return {"values": np.asarray(col.codes), "validity": validity,
                "dictionary": port_column(col.values, device),
                "ordered": bool(col.dtype.ordered)}
    return {"values": np.asarray(col.values), "validity": validity,
            "dtype": port_dtype(col.dtype)}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def port_column(col, device="cpu"):
    """The port's column holding the same buffers as a reference column,
    on `device`: every layout, nested ones recursively (a decimal's u64
    limbs on int64 storage, a union's ids, a run-end column's length)."""
    from arrow_tpu.core import nested as rn
    from arrow_tpu_torch.core import column as pc, nested as pn
    mask = None if col.validity is None else _tensor(col.validity, device)
    if isinstance(col, at.NullColumn):
        return pc.NullColumn(len(col), device)
    if isinstance(col, at.StringColumn):
        return att.StringColumn.from_numpy(
            np.asarray(col.offsets), np.asarray(col.data),
            None if col.validity is None else np.asarray(col.validity),
            port_dtype(col.dtype), device=device)
    if isinstance(col, at.ListColumn):
        return pc.ListColumn(_tensor(col.offsets, device),
                             port_column(col.child, device), mask,
                             large=col.dtype.name == "large_list")
    if isinstance(col, at.StructColumn):
        return pc.StructColumn([port_column(c, device) for c in col.children],
                               [port_field(f) for f in col.fields], mask)
    if isinstance(col, rn.FixedSizeListColumn):
        return pn.FixedSizeListColumn(port_column(col.child, device),
                                      col.list_size, mask)
    if isinstance(col, rn.FixedSizeBinaryColumn):
        return pn.FixedSizeBinaryColumn(_tensor(col.data, device), mask)
    if isinstance(col, rn.MapColumn):
        return pn.MapColumn(_tensor(col.offsets, device),
                            port_column(col.entries, device), mask)
    if isinstance(col, rn.UnionColumn):
        return pn.UnionColumn(
            _tensor(col.type_ids, device),
            None if col.offsets is None else _tensor(col.offsets, device),
            [port_column(c, device) for c in col.children],
            [port_field(f) for f in col.fields], col.ids)
    if isinstance(col, rn.RunEndColumn):
        return pn.RunEndColumn(_tensor(col.run_ends, device),
                               port_column(col.values, device), len(col))
    if isinstance(col, rn.DecimalColumn):
        return pn.DecimalColumn(
            _tensor(np.asarray(col.limbs).view(np.int64), device),
            port_dtype(col.dtype), mask)
    if isinstance(col, rn.IntervalMDNColumn):
        return pn.IntervalMDNColumn(*(_tensor(p, device) for p in (
            col.months, col.days, col.nanos)), mask)
    if isinstance(col, rn.ListViewColumn):
        return pn.ListViewColumn(_tensor(col.offsets, device),
                                 _tensor(col.sizes, device),
                                 port_column(col.child, device), mask,
                                 port_dtype(col.dtype))
    return att.from_numpy(device=device, **column_spec(col, device))


def port_scalar(x, device="cpu"):
    """The port's Scalar for a reference Scalar (a utf8 scalar keeps its
    Python value)."""
    d = port_dtype(x.dtype)
    if not x.valid or d.is_string:
        return att.Scalar(x.as_py(), d, x.valid)
    v = np.asarray(x.value).reshape(1).view(d.storage_numpy())
    return att.Scalar(torch.from_numpy(v.copy()).reshape(()).to(device), d)


def port_datum(x, device="cpu"):
    """A reference Column or Scalar as the port's; anything else (a
    Python value) as it is."""
    from arrow_tpu.core.datum import Scalar
    if isinstance(x, at.Column):
        return port_column(x, device)
    if isinstance(x, Scalar):
        return port_scalar(x, device)
    return x


def port_options(opt):
    """The reference's SortOptions or CastOptions as the port's."""
    from arrow_tpu_torch.ops.cast import CastOptions
    from arrow_tpu_torch.ops.row_format import SortOptions
    if hasattr(opt, "safe"):
        return CastOptions(safe=opt.safe)
    return SortOptions(descending=opt.descending, nulls_first=opt.nulls_first)


def port_field(f) -> att.dtypes.Field:
    """The port's Field for a reference Field, nullability and metadata
    included."""
    return att.dtypes.Field(f.name, port_dtype(f.dtype), nullable=f.nullable,
                            metadata=tuple(f.metadata))


def port_table(table, device="cpu") -> att.Table:
    """The port's Table holding the same buffers as a reference Table,
    under the reference schema's fields (nullability included); each
    column's type must be its field's, ordered flag included."""
    cols = [port_column(c, device) for c in table.columns]
    fields = tuple(port_field(f) for f in table.schema.fields)
    for c, f in zip(cols, fields):
        assert (repr(c.dtype), c.dtype.ordered) == \
            (repr(f.dtype), f.dtype.ordered), (f.name, c.dtype, f.dtype)
    return att.Table(cols, att.dtypes.Schema(fields))


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


def assert_columns_equal(got, want, what="", masks=False) -> None:
    """Same dtype (a dictionary's ordered flag included) and values; with
    `masks`, also the same presence of a validity mask.  A nested,
    decimal or month_day_nano column also compares its buffers bit for
    bit (`buffers`)."""
    assert repr(got.dtype) == repr(want.dtype), (what, got.dtype, want.dtype)
    assert bool(got.dtype.ordered) == bool(want.dtype.ordered), \
        (what, "ordered", got.dtype.ordered, want.dtype.ordered)
    if not (got.dtype.is_primitive or got.dtype.is_string
            or got.dtype.is_dictionary or got.dtype.is_null):
        assert_layouts_equal(got, want, what)
    elif got.dtype.is_temporal or (got.dtype.is_dictionary
                                   and got.dtype.value_type.is_temporal):
        # the reference lists datetimes
        assert_same(storage_list(got), storage_list(want), what)
    else:
        assert_same(got.to_pylist(), want.to_pylist(), what)
    if masks:
        assert (got.validity is None) == (want.validity is None), \
            (what, "validity mask present in one only")


def same_outcome(port_fn, ref_fn, what="", masks=False):
    """Run both; they raise errors of the same name, or return equal
    columns.  Returns the reference's column (None when both raised)."""
    try:
        want = ref_fn()
    except Exception as e:             # the reference's error decides
        with pytest.raises(Exception) as got:
            port_fn()
        assert type(got.value).__name__ == type(e).__name__, \
            (what, got.value, e)
        return None
    assert_columns_equal(port_fn(), want, what, masks)
    return want


def assert_tables_equal(got, want) -> None:
    """Same fields (name, dtype, nullable), rows and values (to_pydict
    under _py_equal)."""
    assert got.column_names == want.column_names
    for g, w in zip(got.schema.fields, want.schema.fields):
        assert (g.name, repr(g.dtype), g.nullable) == \
            (w.name, repr(w.dtype), w.nullable), (g, w)
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        assert_columns_equal(g, w, name)


def bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of a numpy array, for bitwise comparison."""
    return a.view(f"u{a.dtype.itemsize}") if a.dtype != bool else a


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def storage_list(col) -> list:
    """A primitive column (or a dictionary of primitive values) of either
    package as its rows' raw storage bits, None at nulls."""
    if hasattr(col, "codes"):
        vals = storage_list(col.values)
        b = [vals[c] for c in _host(col.codes).tolist()]
    else:
        b = bits(_host(col.values)).tolist()
    if col.validity is None:
        return b
    return [x if ok else None for x, ok in zip(b, _host(col.validity))]


def rand_values(rng, dtype, n: int, small: bool = False) -> np.ndarray:
    """n values of a numpy dtype.  Integers span the type's whole range
    (small: [0, 40)); floats are nonzero multiples of 1/8 below 250 in
    magnitude, exact in every float type so sums are order-free (small:
    multiples of 1/2 in [-10, 10)), with NaN, +inf, -inf and -0.0 planted
    (small: NaN, +inf, -inf, -0.0 and +0.0 all present)."""
    d = np.dtype(dtype)
    if d == bool:
        return rng.random(n) < 0.5
    if d.kind in "iu":
        if small:
            return rng.integers(0, 40, n).astype(d)
        info = np.iinfo(d)
        return rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    if small:
        v = (rng.integers(-20, 20, n) / 2).astype(d)
        v[3::29] = -0.0
        v[4::31] = np.inf
        v[5::37] = -np.inf
    else:
        v = (rng.integers(1, 2000, n) * rng.choice([-1, 1], n) / 8).astype(d)
        v[3::97] = -0.0
        v[4::89] = np.inf
        v[5::83] = -np.inf
    v[::53] = np.nan
    return v


def rand_column(rng, dtype, n: int, nulls: float = 0.1, small=False):
    """A reference column of rand_values with a share of nulls."""
    valid = None if not nulls else rng.random(n) >= nulls
    return at.column(rand_values(rng, dtype, n, small), validity=valid)


# ---- nested layouts -----------------------------------------------------------

def _bits_list(x) -> list:
    return bits(_host(x)).tolist()


def _mask_list(col) -> list:
    v = col.validity
    return [True] * len(col) if v is None else _host(v).astype(bool).tolist()


def buffers(col) -> dict:
    """A column of either package as its layout's buffers, recursively:
    offsets with their dtype, value bits, decimal limbs as u64, union ids
    and type ids, run ends, and each validity as a list of bools (a
    missing mask reads all valid)."""
    kind = type(col).__name__
    out = {"kind": kind, "len": len(col)}
    if kind not in ("UnionColumn", "RunEndColumn", "NullColumn"):
        out["valid"] = _mask_list(col)

    def offsets(x):
        a = _host(x)
        return (a.dtype.name, a.astype(np.int64).tolist())
    if kind == "PrimitiveColumn":
        out["values"] = _bits_list(col.values)
    elif kind == "DictionaryColumn":
        out["codes"] = _bits_list(col.codes)
        out["dictionary"] = buffers(col.values)
    elif kind == "StringColumn":
        # the offsets at the type's width, as pyarrow lays them out and
        # the port's constructor holds them; the reference keeps a
        # source's width through a retag and writes int32 under large
        # types at times (ROADMAP C14)
        large = col.dtype.name in ("large_utf8", "large_binary")
        out["offsets"] = ("int64" if large else "int32",
                          offsets(col.offsets)[1])
        out["data"] = _host(col.data).tolist()
    elif kind in ("ListColumn", "MapColumn"):
        out["offsets"] = offsets(col.offsets)
        out["child"] = buffers(col.child if kind == "ListColumn"
                               else col.entries)
    elif kind == "StructColumn":
        out["children"] = [buffers(c) for c in col.children]
    elif kind == "FixedSizeListColumn":
        out["child"] = buffers(col.child)
    elif kind == "FixedSizeBinaryColumn":
        out["data"] = _host(col.data).tolist()
    elif kind == "DecimalColumn":
        out["limbs"] = _host(col.limbs).view(np.uint64).tolist()
    elif kind == "IntervalMDNColumn":
        out["planes"] = [_bits_list(p) for p in
                         (col.months, col.days, col.nanos)]
    elif kind == "UnionColumn":
        out["type_ids"] = _host(col.type_ids).tolist()
        out["offsets"] = None if col.offsets is None else \
            offsets(col.offsets)
        out["ids"] = list(col.ids)
        out["children"] = [buffers(c) for c in col.children]
    elif kind == "RunEndColumn":
        out["run_ends"] = offsets(col.run_ends)
        out["values"] = buffers(col.values)
    elif kind == "ListViewColumn":
        out["offsets"] = offsets(col.offsets)
        out["sizes"] = offsets(col.sizes)
        out["child"] = buffers(col.child)
    return out


def _has_temporal(d) -> bool:
    if d.is_temporal:
        return True
    kids = [f.dtype for f in d.fields or ()] + \
        [t for t in (d.value_type,) if t is not None]
    return any(_has_temporal(k) for k in kids)


def assert_layouts_equal(got, want, what="", dtype=None) -> None:
    """Same type (`dtype`, the port's, where the reference's is known to
    be wrong), the same buffers bit for bit, and equal to_pylist where no
    temporal value is inside (the reference lists those as datetimes)."""
    assert repr(got.dtype) == repr(dtype or want.dtype), \
        (what, got.dtype, want.dtype)
    gb, wb = buffers(got), buffers(want)
    if gb != wb:
        raise AssertionError(f"{what}: buffers differ\n{_first_diff(gb, wb)}")
    if not _has_temporal(got.dtype):
        assert_same(got.to_pylist(), ref_pylist(want), what)


def ref_pylist(col) -> list:
    """A reference column's to_pylist; a decimal's from its unscaled ints
    (the reference lists decimals through pyarrow, which refuses some
    precisions and negative scales)."""
    import decimal
    d = col.dtype
    if not d.is_decimal:
        return col.to_pylist()
    if hasattr(col, "to_pyints"):
        ints = col.to_pyints()
    else:
        ints = np.asarray(col.values).tolist()
        if col.validity is not None:
            ints = [v if ok else None
                    for v, ok in zip(ints, np.asarray(col.validity))]
    exact = decimal.Context(prec=100)
    return [None if v is None else decimal.Decimal(v).scaleb(-d.scale, exact)
            for v in ints]


def _first_diff(a, b, path="") -> str:
    if isinstance(a, dict) and isinstance(b, dict):
        for k in a:
            if a.get(k) != b.get(k):
                return _first_diff(a.get(k), b.get(k), f"{path}.{k}")
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_diff(x, y, f"{path}[{i}]")
    return f"{path}: {a!r} != {b!r}"


# ---- the file layer (io/cdata.py, io/ipc.py, Parquet) ----------------------

def ref_and_port(batch, device="cpu"):
    """The reference's Table of a pyarrow batch or table and the port's
    Table of the same buffers, on `device`."""
    import pyarrow as pa
    from arrow_tpu.io.interop import table_from_pyarrow
    if isinstance(batch, pa.Table):
        batch = batch.combine_chunks().to_batches()[0] if batch.num_rows \
            else pa.record_batch([c.combine_chunks() if c.num_chunks
                                  else pa.array([], c.type)
                                  for c in batch.columns],
                                 schema=batch.schema)
    ref = table_from_pyarrow(batch)
    return ref, port_table(ref, device)


def assert_tables_layouts_equal(got, want, what="", dtypes=None):
    """Same names and rows, each column's buffers bit for bit
    (`assert_layouts_equal`); `dtypes` maps a column to the port's type
    where the reference's is known to be wrong."""
    assert got.column_names == want.column_names, (what, got.column_names,
                                                   want.column_names)
    assert got.num_rows == want.num_rows, what
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        assert_layouts_equal(g, w, f"{what}{name}",
                             dtype=(dtypes or {}).get(name))


def parquet_parts(data: bytes):
    """(the bytes before the footer, the footer parsed by the thrift
    codec) of a plain Parquet file."""
    import struct
    from arrow_tpu.io.thrift import CompactReader
    (flen,) = struct.unpack_from("<i", data, len(data) - 8)
    body = data[:len(data) - 8 - flen]
    footer = CompactReader(data[len(data) - 8 - flen:len(data) - 8]) \
        .read_struct()
    return body, footer


def assert_parquet_like_reference(got: bytes, want: bytes) -> None:
    """The port's Parquet bytes against the reference's: every byte
    before the footer equal, the footer equal apart from `created_by`,
    where the port names itself."""
    gb, gf = parquet_parts(got)
    wb, wf = parquet_parts(want)
    assert got[-4:] == want[-4:] == b"PAR1"
    if gb != wb:
        i = next(i for i, (a, b) in enumerate(zip(gb, wb)) if a != b) \
            if len(gb) == len(wb) else min(len(gb), len(wb))
        raise AssertionError(f"bytes differ at {i} of {len(gb)}, "
                             f"{len(wb)} before the footers")
    assert gf.pop(6) == b"arrow_tpu_torch native writer"
    assert wf.pop(6) == b"arrow_tpu native writer"
    assert gf == wf


def applied(tables: dict, deltas: dict) -> dict:
    """The port's tables that `sql.execute_sql_update`'s deltas name,
    after them, as plain Tables (None: dropped): each delta applied to a
    version of its table (arrow_tpu_torch.storage), its rows as a reader
    sees them."""
    from arrow_tpu_torch.storage import TableVersion
    out = {}
    for name, d in deltas.items():
        if d.drop:
            out[name] = None
            continue
        base = tables.get(name)
        if base is None or d.table is not None:
            out[name] = d.table
            continue
        if not isinstance(base, TableVersion):
            base = TableVersion.of(base)
        out[name] = base.apply(d, name).visible()
    return out
