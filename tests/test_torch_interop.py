"""pyarrow interop of the port (io/interop.py) against the JAX
package's, on every layout the reference covers: primitives, temporal
types with and without zones, decimals, every string layout, sliced
arrays, dictionaries, lists and list views, fixed-size lists and
binaries, maps, structs, unions, run-end arrays, month_day_nano
intervals, null arrays and extension types (their metadata riding the
schema's fields).

For each array:
  - `column_to_pyarrow` of the port's column equals the reference's
    `column_to_pyarrow` of the same input (type, nulls and values, floats
    by their bits);
  - `column_from_pyarrow` gives the column `port_column` gives for the
    reference's ingest, buffer for buffer;
  - `to_pylist` equals the reference's, which lists through pyarrow:
    dates, datetimes, times and timedeltas for temporal columns.
"""

import datetime
import importlib
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.io import interop as pio
from torch_port_util import (assert_same, buffers,  # noqa: F401
                             cuda_device, port_column, port_dtype,
                             same_outcome)

rio = importlib.import_module("arrow_tpu.io.interop")
rdt = at.dtypes
RNG = np.random.default_rng(9)
N = 64


def _mask(n=N, share=0.2):
    return RNG.random(n) < share


def _ints(dtype, n=N):
    info = np.iinfo(dtype)
    return pa.array(RNG.integers(info.min, info.max, n, dtype=dtype,
                                 endpoint=True), mask=_mask(n))


def _floats(dtype):
    v = (RNG.standard_normal(N) * 1e3).astype(dtype)
    v[::7], v[1::9], v[2::11] = np.nan, -0.0, np.inf
    return pa.array(v, mask=_mask())


def _temporal(t, lo, hi):
    storage = pa.int32() if t.bit_width == 32 else pa.int64()
    return pa.array(RNG.integers(lo, hi, N), pa.int64(), mask=_mask()
                    ).cast(storage).cast(t)


def _words(n=N):
    pool = ["", "a", "bb", "é", "日本", "special requests", "x" * 40]
    return [None if m else pool[i] for i, m in
            zip(RNG.integers(0, len(pool), n), _mask(n))]


def _decimals(t, digits):
    """Unscaled values of up to `digits` digits (Python ints: past 18
    digits they overflow int64)."""
    hi = RNG.integers(-10 ** 9, 10 ** 9, N).tolist()
    lo = RNG.integers(0, 10 ** 9, N).tolist()
    ints = [(h * 10 ** 9 + l) * 10 ** max(digits - 18, 0) % 10 ** digits
            - 10 ** digits // 2
            for h, l in zip(hi, lo)]
    return pa.array([None if m else Decimal(v).scaleb(-t.scale)
                     for v, m in zip(ints, _mask())], t)


ARRAYS = {
    **{f"int{b}": _ints(np.dtype(f"int{b}")) for b in (8, 16, 32, 64)},
    **{f"uint{b}": _ints(np.dtype(f"uint{b}")) for b in (8, 16, 32, 64)},
    **{f"float{b}": _floats(np.dtype(f"float{b}")) for b in (16, 32, 64)},
    "bool": pa.array(RNG.random(N) < 0.5, mask=_mask()),
    "date32": _temporal(pa.date32(), -20_000, 40_000),
    "date64": pa.array(RNG.integers(-20_000, 40_000, N) * 86_400_000,
                       pa.int64(), mask=_mask()).cast(pa.date64()),
    "time32[s]": _temporal(pa.time32("s"), 0, 86_400),
    "time32[ms]": _temporal(pa.time32("ms"), 0, 86_400_000),
    "time64[us]": _temporal(pa.time64("us"), 0, 86_400_000_000),
    "timestamp[s]": _temporal(pa.timestamp("s"), -10 ** 9, 4 * 10 ** 9),
    "timestamp[ms, UTC]": _temporal(pa.timestamp("ms", "UTC"), -10 ** 12,
                                    10 ** 12),
    "timestamp[us, America/New_York]": _temporal(
        pa.timestamp("us", "America/New_York"), -10 ** 15, 10 ** 15),
    "timestamp[us, +05:30]": _temporal(pa.timestamp("us", "+05:30"), 0,
                                       10 ** 15),
    "duration[s]": _temporal(pa.duration("s"), -10 ** 9, 10 ** 9),
    "duration[us]": _temporal(pa.duration("us"), -10 ** 12, 10 ** 12),
    "decimal32": _decimals(pa.decimal32(7, 2), 6),
    "decimal64": _decimals(pa.decimal64(15, 3), 14),
    "decimal128": _decimals(pa.decimal128(30, 4), 29),
    "decimal256": _decimals(pa.decimal256(50, 5), 49),
    "utf8": pa.array(_words(), pa.string()),
    "large_utf8": pa.array(_words(), pa.large_string()),
    "binary": pa.array([None if w is None else w.encode()
                        for w in _words()], pa.binary()),
    "large_binary": pa.array([None if w is None else w.encode()
                              for w in _words()], pa.large_binary()),
    "utf8_view": pa.array(_words(), pa.string_view()),
    "binary_view": pa.array([None if w is None else w.encode()
                             for w in _words()], pa.binary_view()),
    "utf8 sliced": pa.array(_words(), pa.string()).slice(5, 40),
    "large_utf8 sliced": pa.array(_words(), pa.large_string()).slice(3, 30),
    "dictionary": pa.array(_words()).dictionary_encode(),
    "dictionary int8 ordered": pa.DictionaryArray.from_arrays(
        pa.array(RNG.integers(0, 3, N).astype(np.int8), mask=_mask()),
        pa.array(["x", "y", "z"]), ordered=True),
    "dictionary of dates": pa.DictionaryArray.from_arrays(
        pa.array(RNG.integers(0, 2, N).astype(np.int32)),
        pa.array([0, 19000], pa.int32()).cast(pa.date32())),
    "list": pa.array([None if m else list(range(k)) for k, m in
                      zip(RNG.integers(0, 4, N), _mask())],
                     pa.list_(pa.int64())),
    "large_list of utf8": pa.array([None if m else _words(k) for k, m in
                                    zip(RNG.integers(0, 3, N), _mask())],
                                   pa.large_list(pa.string())),
    "list of timestamps": pa.array(
        [None if m else [datetime.datetime(2000 + k, 1, 2)] * k
         for k, m in zip(RNG.integers(0, 3, N), _mask())],
        pa.list_(pa.timestamp("us"))),
    "list_view": pa.ListViewArray.from_arrays(
        pa.array([0, 2, 1, 0], pa.int32()), pa.array([2, 1, 0, 3], pa.int32()),
        pa.array([1, 2, 3, 4]), mask=pa.array([False, False, True, False])),
    "large_list_view": pa.LargeListViewArray.from_arrays(
        pa.array([1, 0], pa.int64()), pa.array([2, 1], pa.int64()),
        pa.array(["a", "b", "c"])),
    "fixed_size_list": pa.array([None if m else [k, k + 1] for k, m in
                                 zip(range(N), _mask())],
                                pa.list_(pa.int32(), 2)),
    "fixed_size_binary": pa.array([None if m else bytes([k % 256]) * 4
                                   for k, m in zip(range(N), _mask())],
                                  pa.binary(4)),
    "map": pa.array([None if m else [(f"k{j}", j) for j in range(k)]
                     for k, m in zip(RNG.integers(0, 3, N), _mask())],
                    pa.map_(pa.string(), pa.int64())),
    "struct": pa.array([None if m else {"a": int(k), "b": w, "c": float(k)}
                        for k, w, m in zip(range(N), _words(), _mask())],
                       pa.struct([("a", pa.int32()), ("b", pa.string()),
                                  ("c", pa.float64())])),
    "struct of dates": pa.array(
        [{"d": datetime.date(2020, 1, 1 + k % 28)} for k in range(N)],
        pa.struct([("d", pa.date32())])),
    "sparse union": pa.UnionArray.from_sparse(
        pa.array([0, 1, 0, 1], pa.int8()),
        [pa.array([1, 2, 3, 4]), pa.array(["a", "b", None, "d"])]),
    "dense union": pa.UnionArray.from_dense(
        pa.array([0, 1, 1, 0], pa.int8()), pa.array([0, 0, 1, 1], pa.int32()),
        [pa.array([1.5, None]), pa.array([True, False])]),
    "run_end_encoded": pa.RunEndEncodedArray.from_arrays(
        pa.array([2, 5, 9], pa.int32()), pa.array([7, None, 9], pa.int64())),
    "run_end of utf8": pa.RunEndEncodedArray.from_arrays(
        pa.array([1, 4], pa.int16()), pa.array(["x", "é"])),
    "month_day_nano": pa.array([None if m else (k, -k, k * 1000)
                                for k, m in zip(range(N), _mask())],
                               pa.month_day_nano_interval()),
    "null": pa.nulls(7),
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_column_round_trip(name):
    arr = ARRAYS[name]
    ref = rio.column_from_pyarrow(arr)
    got = pio.column_from_pyarrow(arr, "cpu")
    want = port_column(ref)
    assert repr(got.dtype) == repr(want.dtype), (name, got.dtype)
    assert buffers(got) == buffers(want), name
    out, ref_out = pio.column_to_pyarrow(got), rio.column_to_pyarrow(ref)
    assert out.type == ref_out.type, (out.type, ref_out.type)
    assert_same(out.to_pylist(), ref_out.to_pylist(), name)
    assert out.null_count == ref_out.null_count
    assert_same(got.to_pylist(), ref.to_pylist(), f"{name} to_pylist")
    assert_same(out.to_pylist(), arr.to_pylist(), f"{name} against pyarrow")


TEMPORAL = [n for n in ARRAYS if n.split("[")[0] in (
    "date32", "date64", "time32", "time64", "timestamp", "duration")]


@pytest.mark.parametrize("name", TEMPORAL)
def test_temporal_to_pylist_lists_python_objects(name):
    """ROADMAP A8's temporal gap, closed: to_pylist of a port column
    built by its own constructors lists what the reference lists."""
    ref = rio.column_from_pyarrow(ARRAYS[name])
    col = port_column(ref)
    got = col.to_pylist()
    kinds = {type(v) for v in got if v is not None}
    assert kinds <= {datetime.date, datetime.datetime, datetime.time,
                     datetime.timedelta}, kinds
    assert_same(got, ref.to_pylist(), name)


def test_year_month_and_day_time_list_storage():
    """ROADMAP C15's note: pyarrow builds no year_month or day_time type
    from Python, so the reference's to_pylist of one raises; the port
    lists the storage integers."""
    for unit in ("year_month", "day_time"):
        ref = at.column(np.array([1, -2, 3], np.int32 if unit == "year_month"
                                 else np.int64), rdt.interval(unit))
        with pytest.raises(at.ArrowNotImplementedError):
            ref.to_pylist()
        assert port_column(ref).to_pylist() == np.asarray(
            ref.values).tolist()


@pytest.mark.parametrize("arr", [pa.array([1, 2, None]), pa.array(["a", None]),
                                 pa.chunked_array([[1, 2], [3]])],
                         ids=["int64", "utf8", "chunked"])
def test_column_accepts_pyarrow(arr):
    got = att.column(arr, device="cpu")
    want = port_column(at.column(arr))
    assert buffers(got) == buffers(want)


def test_extension_types_ride_field_metadata():
    """The canonical extension types (dtypes.py) as the reference has
    them, and their metadata through a table round trip; a pyarrow
    extension array itself is refused by both."""
    for port_t, ref_t in ((att.dtypes.uuid(), rdt.uuid()),
                          (att.dtypes.json_(), rdt.json_()),
                          (att.dtypes.bool8(), rdt.bool8()),
                          (att.dtypes.fixed_shape_tensor(att.dtypes.float32,
                                                         (2, 3)),
                           rdt.fixed_shape_tensor(rdt.float32, (2, 3))),
                          (att.dtypes.opaque(att.dtypes.binary, "geometry",
                                             "postgis"),
                           rdt.opaque(rdt.binary, "geometry", "postgis"))):
        assert repr(port_t) == repr(ref_t)
        assert port_t.field_metadata() == ref_t.field_metadata()
        assert repr(port_t.storage) == repr(port_dtype(ref_t.storage))
    u = att.dtypes.uuid()
    fsb = pa.array([b"0123456789abcdef", None], pa.binary(16))
    rb = pa.RecordBatch.from_arrays([fsb], schema=pa.schema([pa.field(
        "id", fsb.type, metadata=dict(u.field_metadata()))]))
    t = pio.table_from_pyarrow(rb, "cpu")
    assert dict(t.schema.field("id").metadata)["ARROW:extension:name"] == \
        "arrow.uuid"
    back = pio.table_to_pyarrow(t)
    assert back.equals(rb) and back.schema.equals(rb.schema,
                                                  check_metadata=True)
    assert back.schema.equals(rio.table_to_pyarrow(rio.table_from_pyarrow(
        rb)).schema, check_metadata=True)
    ext = pa.ExtensionArray.from_storage(pa.uuid(), fsb)
    same_outcome(lambda: pio.column_from_pyarrow(ext, "cpu"),
                 lambda: rio.column_from_pyarrow(ext), "uuid array")


def test_table_round_trip():
    """Every array above in one table: table_to_pyarrow of
    table_from_pyarrow equals the batch, fields' nullability and
    metadata included, and the port's table equals the reference's."""
    names = [n for n, a in ARRAYS.items() if len(a) == N]
    rb = pa.RecordBatch.from_arrays(
        [ARRAYS[n] for n in names], schema=pa.schema([
            pa.field(n, ARRAYS[n].type, nullable=ARRAYS[n].null_count > 0,
                     metadata={"k": n}) for n in names]))
    t = att.Table.from_pyarrow(rb, device="cpu")
    back = t.to_pyarrow()
    assert back.schema.equals(rb.schema, check_metadata=True)
    for n in names:
        assert_same(back.column(n).to_pylist(), rb.column(n).to_pylist(), n)
    ref = rio.table_from_pyarrow(rb)
    assert [(f.name, repr(f.dtype), f.nullable, f.metadata)
            for f in t.schema.fields] == \
        [(f.name, repr(port_dtype(f.dtype)), f.nullable, f.metadata)
         for f in ref.schema.fields]


def test_dtype_mapping_both_ways():
    for name, arr in ARRAYS.items():
        got = pio.dtype_from_pyarrow(arr.type)
        assert repr(got) == repr(port_dtype(rio.dtype_from_pyarrow(
            arr.type))), name
        assert pio.dtype_to_pyarrow(got) == arr.type, name
    with pytest.raises(att.ArrowNotImplementedError):
        pio.dtype_to_pyarrow(att.dtypes.interval("day_time"))


def test_tensor_interchange():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = att.Tensor.from_pyarrow(pa.Tensor.from_numpy(x, dim_names=["r", "c"]),
                                device="cpu")
    assert t.dim_names == ("r", "c") and t.shape == (3, 4)
    back = t.to_pyarrow()
    np.testing.assert_array_equal(back.to_numpy(), x)
    assert list(back.dim_names) == ["r", "c"]


def test_import_needs_no_pyarrow():
    """`import arrow_tpu_torch` (and its compute facade) imports no
    pyarrow: interop imports it when called."""
    import subprocess
    import sys
    code = ("import sys, arrow_tpu_torch, arrow_tpu_torch.compute, "
            "arrow_tpu_torch.io; assert 'pyarrow' not in sys.modules; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_device_is_explicit():
    with pytest.raises(ValueError):
        pio.column_from_pyarrow(pa.array([1]), None)
    col = pio.column_from_pyarrow(pa.array([1, 2]), torch.device("cpu"))
    assert col.device == torch.device("cpu")


def test_interop_on_the_card(cuda_device):
    """Every array above onto the card and back: the card's column holds
    the CPU column's buffers, and reads back as the same pyarrow array."""
    for name, arr in ARRAYS.items():
        gpu = pio.column_from_pyarrow(arr, cuda_device)
        cpu = pio.column_from_pyarrow(arr, "cpu")
        assert gpu.device.type == "cuda", name
        assert buffers(gpu) == buffers(cpu), name
        back = pio.column_to_pyarrow(gpu)
        assert back.type == pio.column_to_pyarrow(cpu).type
        assert_same(back.to_pylist(), arr.to_pylist(), name)
