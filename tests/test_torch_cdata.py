"""The C Data Interface of the port (io/cdata.py) against the JAX
package's and pyarrow, on every layout the reference's tests cover
(tests/test_cdata.py and the IPC layouts of tests/test_ipc_native.py):

  - `import_column(arr, "cpu")` gives the buffers the reference's
    `import_column` gives, bit for bit (`assert_layouts_equal`), for
    whole and sliced arrays;
  - `pa.array(col)`, `pa.record_batch(t)` and `pa.table(t)` take port
    objects (`__arrow_c_array__` / `__arrow_c_stream__`) and give back
    the source array;
  - streams both ways (`export_stream`, `import_stream`), dictionaries,
    views, unions and run-end arrays, and the native release callbacks.

Two reference faults are recorded: a decimal32/64 crosses as decimal128
(C17), and a large_list comes in as a list (C9's family).
"""

import ctypes
import gc
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import cdata as rc
from arrow_tpu_torch.io import cdata as pc
from arrow_tpu_torch.io.interop import column_from_pyarrow, table_from_pyarrow
from test_ipc_native import _arrays
from torch_port_util import assert_layouts_equal, port_column

ARRAYS = _arrays()


def _tab():
    """tests/test_cdata.py's table."""
    return pa.table({
        "i64": pa.array([1, None, 3], pa.int64()),
        "u16": pa.array([0, 9, None], pa.uint16()),
        "f32": pa.array([1.5, 2.0, None], pa.float32()),
        "s": pa.array(["a", None, "ccc"]),
        "ls": pa.array(["a", None, "ccc"], pa.large_string()),
        "bin": pa.array([b"\x00", None, b""], pa.binary()),
        "bool": pa.array([True, None, False]),
        "ts": pa.array([1, 2, None], pa.timestamp("us", "UTC")),
        "d32": pa.array([1, None, 3], pa.date32()),
        "dur": pa.array([1, 2, 3], pa.duration("ms")),
        "dec": pa.array([Decimal("1.23"), None, Decimal("-9.99")],
                        pa.decimal128(10, 2)),
        "fsb": pa.array([b"ab", None, b"xy"], pa.binary(2)),
        "l": pa.array([[1, 2], None, []], pa.list_(pa.int64())),
        "ll": pa.array([[[1], None], None, [[2, 3]]],
                       pa.list_(pa.list_(pa.int64()))),
        "fsl": pa.array([[1, 2], None, [3, 4]], pa.list_(pa.int64(), 2)),
        "st": pa.array([{"x": 1, "y": "a"}, None, {"x": None, "y": None}],
                       pa.struct([("x", pa.int64()), ("y", pa.string())])),
        "m": pa.array([[("k", 1)], None, []],
                      pa.map_(pa.string(), pa.int64())),
    })


def _cases():
    out = dict(ARRAYS)
    tab = _tab()
    out.update({f"tab_{k}": tab[k].combine_chunks() for k in tab.column_names})
    out.update({
        "slice_i64": pa.array([1, 2, 3, 4, 5], pa.int64()).slice(2, 2),
        "slice_utf8": pa.array(["aa", "bb", None, "dd"]).slice(1, 3),
        "slice_list": pa.array([[1], [2, 3], [4], []]).slice(1, 2),
        "slice_struct": pa.array([{"a": 1}, {"a": 2}, {"a": 3}]).slice(1, 2),
        "slice_bool": pa.array([True, False, None, True]).slice(1, 3),
        "slice_fsl": pa.array([[1, 2], [3, 4], None],
                              pa.list_(pa.int64(), 2)).slice(1, 2),
        "slice_map": pa.array([[("a", 1)], [("b", 2)], []],
                              pa.map_(pa.string(), pa.int64())).slice(1, 2),
        "mdn": pa.array([(1, 2, 3), None], pa.month_day_nano_interval()),
        "list_view": pa.array([[1], None, [2, 3]], pa.list_view(pa.int64())),
        "large_list_view": pa.array([[1], [], None],
                                    pa.large_list_view(pa.int32())),
        "dict_ordered": pa.DictionaryArray.from_arrays(
            pa.array([0, 1, None, 0], pa.int8()), pa.array(["x", "y"]),
            ordered=True),
        "dict_u16": pa.DictionaryArray.from_arrays(
            pa.array([1, 0, 1], pa.uint16()), pa.array([1.5, 2.5])),
        "view_long": pa.array(["ab", None, "long-string-beyond-twelve-bytes",
                               "", "exactly12byt"], pa.string_view()),
        "binary_view_long": pa.array([b"xy", None,
                                      b"a-binary-blob-over-12-bytes!"],
                                     pa.binary_view()),
        "dense_union_named": pa.UnionArray.from_dense(
            pa.array([0, 1, 0, 0, 1], pa.int8()),
            pa.array([0, 0, 1, 2, 1], pa.int32()),
            [pa.array([1, 2, 3]), pa.array(["a", "b"])], ["i", "s"]),
        "ree_strings": pa.RunEndEncodedArray.from_arrays(
            pa.array([2, 5], pa.int32()), pa.array(["x", None])),
        "empty_i64": pa.array([], pa.int64()),
        "all_null_i32": pa.array([None, None], pa.int32()),
    })
    return out


CASES = _cases()
# the reference's known faults: decimal32/64 import as decimal128 (C17);
# a large_list imports as a list (the family of C9)
REF_FAULTS = {"dec32", "dec64"}


def _port_type(arr):
    from arrow_tpu_torch.io.interop import dtype_from_pyarrow
    return dtype_from_pyarrow(arr.type)


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_column(name):
    arr = CASES[name]
    got = pc.import_column(arr.__arrow_c_array__(), "cpu")
    assert got.device == torch.device("cpu")
    assert repr(got.dtype) == repr(_port_type(arr))
    if name in REF_FAULTS:
        want = rc.import_column(arr.__arrow_c_array__())
        assert want.dtype.name == "decimal128"          # C17
        assert got.to_pylist() == arr.to_pylist()
    else:
        assert_layouts_equal(got, rc.import_column(arr.__arrow_c_array__()),
                             name, dtype=_port_type(arr))
    # the import owns its buffers: the producer's array may go
    assert_layouts_equal(got, column_from_pyarrow(arr, "cpu"), name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pa_array_takes_a_port_column(name):
    arr = CASES[name]
    col = column_from_pyarrow(arr, "cpu")
    back = pa.array(col)
    assert back.type == arr.type
    assert back.to_pylist() == arr.to_pylist()
    if name not in REF_FAULTS and not name.startswith("slice_"):
        ref = pa.array(rc.import_column(arr.__arrow_c_array__()))
        assert back.to_pylist() == ref.to_pylist()


def test_import_large_list_keeps_its_type():
    """A large_list crosses as large_list; the reference's import makes a
    list of the same buffers (cdata.py:633-641), as its take does (C9)."""
    arr = ARRAYS["large_list"]
    got = pc.import_column(arr.__arrow_c_array__(), "cpu")
    want = rc.import_column(arr.__arrow_c_array__())
    assert got.dtype.name == "large_list" and want.dtype.name == "list"
    assert got.offsets.dtype == torch.int64
    assert got.to_pylist() == want.to_pylist() == arr.to_pylist()


@pytest.mark.parametrize("name", ["dec32", "dec64"])
def test_reference_decimal32_64_cross_as_decimal128(name):
    """C17: the reference's format for decimal32/64 has no bit width and
    its import reads any `d:p,s` as decimal128 (cdata.py:127-130,
    190-195), so pyarrow's decimal32/64 arrays come in as decimal128 of
    other values.  The port writes and reads `d:p,s,32` / `d:p,s,64` as
    pyarrow does."""
    arr = ARRAYS[name]
    want = rc.import_column(arr.__arrow_c_array__())
    got = pc.import_column(arr.__arrow_c_array__(), "cpu")
    assert want.dtype.name == "decimal128"
    assert got.dtype.name == name.replace("dec", "decimal")
    assert got.to_pylist() == arr.to_pylist()
    assert pa.array(got).equals(arr)


def test_table_through_the_struct_convention():
    tab = _tab()
    t = table_from_pyarrow(tab, "cpu")
    rb = pa.RecordBatch._import_from_c_capsule(*pc.export_table(t))
    assert rb.equals(tab.combine_chunks().to_batches()[0])
    assert pa.record_batch(t).equals(rb)
    assert pa.table(t).equals(tab.combine_chunks())
    got = pc.import_table(tab.to_batches()[0].to_struct_array(), "cpu")
    want = rc.import_table(tab.to_batches()[0].to_struct_array())
    assert got.column_names == want.column_names
    for name in tab.column_names:
        assert_layouts_equal(got.column(name), want.column(name), name)


def test_stream_both_ways():
    tab = pa.table({"x": [1, None, 3], "s": ["a", "b", None]})
    t = table_from_pyarrow(tab, "cpu")
    assert pa.table(t).equals(tab)
    rdr = pa.RecordBatchReader._import_from_c_capsule(pc.export_stream([t, t]))
    batches = list(rdr)
    assert len(batches) == 2 and batches[1].equals(tab.to_batches()[0])
    parts = pc.import_stream(pa.table({"x": [5, 6]}), "cpu")
    want = rc.import_stream(pa.table({"x": [5, 6]}))
    assert [p.num_rows for p in parts] == [w.num_rows for w in want]
    for p, w in zip(parts, want):
        assert_layouts_equal(p.column("x"), w.column("x"))
    many = pa.RecordBatchReader.from_batches(
        tab.schema, [tab.to_batches()[0]] * 3)
    assert [p.to_pydict() for p in pc.import_stream(many, "cpu")] == \
        [tab.to_pydict()] * 3


def test_export_stream_of_no_batch_raises_as_the_reference():
    with pytest.raises(Exception) as got:
        pc.export_stream([])
    with pytest.raises(Exception) as want:
        rc.export_stream([])
    assert type(got.value).__name__ == type(want.value).__name__


def test_validity_bitmaps():
    rng = np.random.default_rng(0)
    n = 1000
    arr = pa.array(rng.integers(0, 100, n), mask=rng.random(n) < 0.3)
    col = pc.import_column(arr, "cpu")
    assert col.validity.dtype == torch.bool
    assert col.to_pylist() == arr.to_pylist()
    assert pa.Array._import_from_c_capsule(*pc.export_column(col)).equals(arr)


def test_export_is_c_owned():
    """Exports carry the native release callbacks of native/hostcodec.cpp
    and keep nothing alive on the Python side."""
    from arrow_tpu_torch.utils import hostcodec
    before = len(pc._LIVE)
    col = att.column([1, 2, 3], device="cpu")
    caps = pc.export_column(col, "x")
    assert len(pc._LIVE) == before
    ap = ctypes.cast(pc._PyCapsule_GetPointer(caps[1], b"arrow_array"),
                     ctypes.POINTER(pc.ArrowArray))
    ours = ctypes.cast(ap.contents.release, ctypes.c_void_p).value
    assert ours == hostcodec.cdata_release("array")
    back = pa.Array._import_from_c_capsule(*caps)
    assert back.to_pylist() == [1, 2, 3]
    del back
    gc.collect()
    assert len(pc._LIVE) == before


def test_export_copies_the_column():
    """The exported buffers are the host copy made at export: a later
    change to the column's tensors does not reach the consumer."""
    col = att.column([1, 2, 3], device="cpu")
    caps = pc.export_column(col)
    col.values[0] = 99
    assert pa.Array._import_from_c_capsule(*caps).to_pylist() == [1, 2, 3]


def test_import_copies_the_producer_buffers():
    """An import owns its buffers (cdata.py:489-503 copy): they live on
    after the producer's array is gone."""
    arr = pa.array(np.arange(10, dtype=np.int64))
    col = pc.import_column(arr.__arrow_c_array__(), "cpu")
    del arr
    gc.collect()
    assert col.to_pylist() == list(range(10))
    col.values[0] = 7                   # writable, not a view
    assert col.to_pylist()[0] == 7


def test_import_needs_a_device():
    with pytest.raises(ValueError):
        pc.import_column(pa.array([1]).__arrow_c_array__(), None)


def test_dictionary_both_ways():
    from arrow_tpu_torch.ops.strings import dictionary_encode
    d = dictionary_encode(att.column(["b", "a", None, "b"], device="cpu"))
    back = pa.Array._import_from_c_capsule(*pc.export_column(d))
    assert pa.types.is_dictionary(back.type)
    assert back.to_pylist() == ["b", "a", None, "b"]
    pd = pa.DictionaryArray.from_arrays(
        pa.array([0, 1, None, 0], pa.int32()), pa.array(["x", "y"]))
    col = pc.import_column(pd.__arrow_c_array__(), "cpu")
    assert_layouts_equal(col, rc.import_column(pd.__arrow_c_array__()))


def test_port_column_of_the_reference_exports_alike():
    """The same buffers export to the same pyarrow array from both."""
    for name in ("utf8", "list", "struct", "map", "dict", "dec128"):
        ref = at.io.interop.column_from_pyarrow(ARRAYS[name])
        got = pa.array(port_column(ref))
        want = pa.Array._import_from_c_capsule(*rc.export_column(ref))
        assert got.equals(want), name
