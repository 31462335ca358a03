"""The Parquet readers of the port (io/parquet_native.py, io/parquet_io.py)
against the JAX package's on the same bytes: files pyarrow wrote with
every codec, page version, dictionary setting and value encoding the
reference reads (its tests/test_parquet_native.py and the Parquet class
of tests/test_io.py), and files the reference wrote.  The tables are
held buffer for buffer (`assert_layouts_equal`) and to pyarrow's read.

Also: the scan builder (projection, row groups, batch size, RowFilter,
RowSelection, limit, offset, bloom pruning, prefetch) with its page
counters moving as the reference's; footer metadata and statistics;
the vectorised decimal decode against the reference's per-value one on
edge values; C7.3 (dotted projection names) and C18 (decimal32/64 that
pyarrow stores as bytes); malformed input raising the same error names.
"""

import io
import threading
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.io import parquet_io as rio
from arrow_tpu.io import parquet_native as rnat
from arrow_tpu.io.parquet_writer import write_parquet_native as rwrite
from arrow_tpu_torch.io import parquet_io as pio
from arrow_tpu_torch.io import parquet_native as pnat
from arrow_tpu_torch.io.hostio import to_host
from test_parquet_native import _mixed_table, _nested_table
from torch_port_util import (assert_layouts_equal, assert_tables_layouts_equal,
                             cuda_device, ref_and_port)

# The reference's library loader marks itself tried before it has
# loaded, so two decode threads making its first call can see no library
# (ROADMAP C19): load it here, before its decode pool does.
rnat.nt._load()


def _pq(tab, **opts) -> bytes:
    buf = io.BytesIO()
    pq.write_table(tab, buf, **opts)
    return buf.getvalue()


def _deep_table():
    return pa.table({
        "ll": pa.array([[[1, None], []], None, [], [None, [2]]],
                       pa.list_(pa.list_(pa.int64()))),
        "lll": pa.array([[[[1], []]], [], None, [None, [[2, 3]]]],
                        pa.list_(pa.list_(pa.list_(pa.int64())))),
        "lm": pa.array([[[("a", 1)], None], None, [[]]],
                       pa.list_(pa.map_(pa.string(), pa.int64()))
                       ).take(pa.array([0, 1, 2, 2])),
        "sl": pa.array([{"x": [[1], None]}, None, {"x": None},
                        {"x": [[None]]}],
                       pa.struct([("x", pa.list_(pa.list_(pa.int64())))])),
        "lsl": pa.array([[{"y": [1, 2]}], None, [{"y": None}, None], []],
                        pa.list_(pa.struct([("y", pa.list_(pa.int64()))]))),
        "ml": pa.array([[("k", [1, None])], None, [("j", [])]],
                       pa.map_(pa.string(), pa.list_(pa.int64()))
                       ).take(pa.array([0, 1, 2, 0])),
    })


def _typed_table():
    """Every leaf type the reference maps from Parquet, with nulls."""
    return pa.table({
        "i8": pa.array([1, None, -3, 127], pa.int8()),
        "u8": pa.array([255, 0, None, 7], pa.uint8()),
        "u32": pa.array([2 ** 32 - 1, 0, None, 5], pa.uint32()),
        "u64": pa.array([2 ** 64 - 1, 0, 1, None], pa.uint64()),
        "f16": pa.array(np.array([1.5, -0.0, 65504, 0.25], np.float16)),
        "date64": pa.array([86_400_000, None, 0, -86_400_000], pa.date64()),
        "t32": pa.array([1, None, 3, 4], pa.time32("ms")),
        "t64": pa.array([1, 2, None, 4], pa.time64("ns")),
        "ts_ms": pa.array([1, 2, None, -4], pa.timestamp("ms", "UTC")),
        "ts_ns": pa.array([1, 2, 3, None], pa.timestamp("ns")),
        "dur": pa.array([1, None, -3, 4], pa.duration("us")),
        "ls": pa.array(["a", None, "", "dd"], pa.large_string()),
        "lb": pa.array([b"a", None, b"", b"dd"], pa.large_binary()),
        "dec9": pa.array([Decimal("1.5"), None, Decimal("-0.5"),
                          Decimal("9999999.9")], pa.decimal128(8, 1)),
        "dec18": pa.array([Decimal("1.25"), Decimal("-1e10"), None,
                           Decimal("0")], pa.decimal128(18, 2)),
        "dec38": pa.array([Decimal(10 ** 37), -Decimal(10 ** 36), None,
                           Decimal("-1")], pa.decimal128(38, 0)),
        "dec76": pa.array([Decimal(10 ** 70), None, -Decimal(5),
                           Decimal(0)], pa.decimal256(76, 0)),
        "dict": pa.array(["x", "y", None, "x"]).dictionary_encode(),
        "dict_i": pa.array([3, 1, 3, None]).dictionary_encode(),
        "fsl": pa.array([[1, 2], [None, 0], [3, 4], [5, None]],
                        pa.list_(pa.int32(), 2)),
        "llist": pa.array([[1], None, [], [2, 3]], pa.large_list(pa.int64())),
    })


TABLES = {"mixed": _mixed_table, "nested": _nested_table,
          "deep": _deep_table, "typed": _typed_table}
OPTS = {
    "NONE": dict(compression="NONE", use_dictionary=False),
    "SNAPPY": dict(compression="SNAPPY"),
    "GZIP": dict(compression="GZIP", use_dictionary=False),
    "ZSTD": dict(compression="ZSTD"),
    "LZ4": dict(compression="LZ4"),
    "v2": dict(data_page_version="2.0"),
    "v2 ZSTD plain": dict(data_page_version="2.0", compression="ZSTD",
                          use_dictionary=False),
    "small pages": dict(data_page_size=64, write_page_index=True,
                        row_group_size=3),
    "no schema": dict(store_schema=False),
    "checksums": dict(write_page_checksum=True),
}
# the reference's known faults on these files
REF_DTYPES = {}


# pages of a few values: the flat table only
READ_CASES = [(t, o) for t in sorted(TABLES) for o in sorted(OPTS)
              if o != "small pages" or t == "mixed"]


@pytest.mark.parametrize("table,opts", READ_CASES,
                         ids=[f"{t}-{o}" for t, o in READ_CASES])
def test_read_pyarrow_file(table, opts):
    if "ZSTD" in opts:
        pytest.importorskip("zstandard")  # the reader's ZSTD codec
    tab = TABLES[table]()
    data = _pq(tab, **OPTS[opts])
    got = pnat.ParquetFile(data, "cpu").read()
    want = rnat.ParquetFile(data).read()
    assert_tables_layouts_equal(got, want, f"{table}/{opts}: ")
    assert got.to_pyarrow().to_pydict() == want.to_pyarrow().to_pydict()


ENCODINGS = [
    ("i32", pa.int32(), "DELTA_BINARY_PACKED"),
    ("i64", pa.int64(), "DELTA_BINARY_PACKED"),
    ("s", pa.string(), "DELTA_LENGTH_BYTE_ARRAY"),
    ("s", pa.string(), "DELTA_BYTE_ARRAY"),
    ("f32", pa.float32(), "BYTE_STREAM_SPLIT"),
    ("f64", pa.float64(), "BYTE_STREAM_SPLIT"),
    ("i32", pa.int32(), "BYTE_STREAM_SPLIT"),
    ("fsb", pa.binary(3), "BYTE_STREAM_SPLIT"),
    ("b", pa.bool_(), "RLE"),
    ("s", pa.string(), "PLAIN"),
]


@pytest.mark.parametrize("ver", ["1.0", "2.0"])
@pytest.mark.parametrize("col,ty,enc", ENCODINGS,
                         ids=[f"{c}-{e}" for c, _, e in ENCODINGS])
def test_read_value_encodings(col, ty, enc, ver):
    rng = np.random.default_rng(3)
    n = 700
    if pa.types.is_string(ty):
        vals = [None if i % 11 == 0 else f"pre{i // 7:04d}/{'x' * (i % 5)}"
                for i in range(n)]
    elif pa.types.is_fixed_size_binary(ty):
        vals = [bytes(rng.integers(0, 256, 3).astype(np.uint8))
                for _ in range(n)]
    elif pa.types.is_boolean(ty):
        vals = [bool(v) for v in rng.integers(0, 2, n)]
    elif pa.types.is_floating(ty):
        vals = rng.standard_normal(n).tolist()
    else:
        vals = np.cumsum(rng.integers(-50, 50, n)).tolist()
    tab = pa.table({col: pa.array(vals, ty)})
    try:
        data = _pq(tab, use_dictionary=False, data_page_version=ver,
                   column_encoding={col: enc})
    except (pa.ArrowNotImplementedError, pa.ArrowInvalid) as e:
        pytest.skip(f"pyarrow does not write {enc} for {ty}: {e}")
    got = pnat.ParquetFile(data, "cpu").read()
    assert_tables_layouts_equal(got, rnat.ParquetFile(data).read())
    assert got.column(col).to_pylist() == tab[col].to_pylist()


def test_dictionary_to_plain_fallback_keeps_page_order():
    vals = [f"v{i % 3000:05d}-{'y' * (i % 7)}" for i in range(40_000)]
    data = _pq(pa.table({"s": vals}), dictionary_pagesize_limit=2048,
               data_page_size=4096)
    got = pnat.ParquetFile(data, "cpu").read()
    assert_tables_layouts_equal(got, rnat.ParquetFile(data).read())
    assert got.column("s").to_pylist() == vals


def test_int96_timestamps():
    tab = pa.table({"t": pa.array([1, None, -86_400_000_000_000 * 400],
                                  pa.timestamp("ns"))})
    data = _pq(tab, use_deprecated_int96_timestamps=True)
    got = pnat.ParquetFile(data, "cpu").read()
    assert_tables_layouts_equal(got, rnat.ParquetFile(data).read())


def test_row_groups_projection_and_as_dictionary():
    tab = _mixed_table()
    data = _pq(pa.concat_tables([tab] * 5), row_group_size=4)
    pf, rf = pnat.ParquetFile(data, "cpu"), rnat.ParquetFile(data)
    assert len(pf.row_groups) == len(rf.row_groups) == 5
    for i in range(5):
        assert_tables_layouts_equal(pf.read_row_group(i, ["s", "i64"]),
                                    rf.read_row_group(i, ["s", "i64"]))
    assert_tables_layouts_equal(pf.read(["f64", "s"], as_dictionary=["s"]),
                                rf.read(["f64", "s"], as_dictionary=["s"]))
    assert pf.read(["s"], as_dictionary=["s"]).column("s").dtype.name == \
        "dictionary"
    assert repr(pf.schema) == repr(rf.schema)
    assert pf.key_value_metadata() == rf.key_value_metadata()


def test_read_whole_file_and_empty_file():
    tab = _nested_table()
    data = _pq(tab, row_group_size=2)
    got = pio.read_parquet(io.BytesIO(data), device="cpu")
    assert_tables_layouts_equal(got, rio.read_parquet(io.BytesIO(data)))
    empty = _pq(pa.table({"a": pa.array([], pa.int64()),
                          "s": pa.array([], pa.string())}))
    got = pio.read_parquet(empty, device="cpu")
    assert_tables_layouts_equal(got, rio.read_parquet(empty))
    with pytest.raises(ValueError):
        pio.read_parquet(data)            # no device
    with pytest.raises(ValueError):
        pnat.ParquetFile(data).read()


def test_read_the_references_files():
    """Files the reference wrote (every option its writer takes), read by
    both."""
    ref, _ = ref_and_port(_mixed_table())
    for kw in (dict(), dict(compression="zstd", data_page_version="2.0"),
               dict(write_page_index=True, data_page_size=16),
               dict(dictionary_enabled=False, compression="gzip")):
        buf = io.BytesIO()
        rwrite(buf, ref, **kw)
        data = buf.getvalue()
        assert_tables_layouts_equal(pnat.ParquetFile(data, "cpu").read(),
                                    rnat.ParquetFile(data).read(), str(kw))


# ---- decimals: the vectorised decode ---------------------------------------

def _decimal_values(precision: int):
    top = 10 ** precision - 1
    vals = [0, 1, -1, top, -top, 127, -128, 128, -129, 255, -256, 2 ** 63,
            -2 ** 63, 2 ** 63 - 1, -(2 ** 63) - 1]
    return [Decimal(v) for v in vals if abs(v) <= top] + [None]


# the largest precision each FLBA width 1..16 holds, then decimal256's
WIDTH_PRECISIONS = [len(str(2 ** (8 * w - 1))) - 1 for w in range(1, 17)] \
    + [45, 60, 76]


@pytest.mark.parametrize("precision", WIDTH_PRECISIONS)
def test_decimal_widths_both_layouts(precision):
    """Each FLBA width pyarrow picks (1 to 32 bytes) and the BYTE_ARRAY
    layout (store_decimal_as_integer off, v2 DELTA_BYTE_ARRAY too) decode
    to the reference's limbs, negatives and both ends of the range
    included."""
    ty = pa.decimal128(precision, 0) if precision <= 38 \
        else pa.decimal256(precision, 0)
    tab = pa.table({"d": pa.array(_decimal_values(precision), ty)})
    for opts in (dict(), dict(use_dictionary=False),
                 dict(data_page_version="2.0", use_dictionary=False,
                      column_encoding={"d": "DELTA_BYTE_ARRAY"})):
        try:
            data = _pq(tab, **opts)
        except (pa.ArrowNotImplementedError, pa.ArrowInvalid):
            continue
        got = pnat.ParquetFile(data, "cpu").read()
        assert_tables_layouts_equal(got, rnat.ParquetFile(data).read(),
                                    str(opts))
        assert got.column("d").to_pylist() == tab["d"].to_pylist()


def test_be_limbs_against_python_ints():
    """`_be_limbs` on random byte strings of every width from 1 to 40
    (past 8k bytes keeps the low ones, as the reference masks)."""
    rng = np.random.default_rng(5)
    for k in (1, 2, 4):
        for w in range(1, 41):
            raw = rng.integers(0, 256, (9, w)).astype(np.uint8)
            raw[0, 0] = 0x80
            raw[1, 0] = 0x7F
            got = pnat._be_limbs(raw, k).view(np.uint64)
            for row, limbs in zip(raw, got):
                v = int.from_bytes(bytes(row), "big", signed=True)
                u = v & ((1 << (64 * k)) - 1)
                assert [int(x) for x in limbs] == \
                    [(u >> (64 * i)) & ((1 << 64) - 1) for i in range(k)]


@pytest.mark.parametrize("ty", [pa.decimal32(7, 2), pa.decimal64(15, 3)])
def test_reference_cannot_read_decimal32_64_stored_as_bytes(ty):
    """C18: pyarrow stores a decimal32/64 column as FLBA; the reference
    takes the ARROW:schema width and then builds a DecimalColumn, which
    refuses decimal32/64 (parquet_native.py:1147-1155).  The port reads
    the unscaled integers, equal to pyarrow's read."""
    tab = pa.table({"d": pa.array([Decimal("1.25"), None, Decimal("-3.5")],
                                  ty)})
    data = _pq(tab)
    with pytest.raises(AssertionError):
        rnat.ParquetFile(data).read()
    got = pnat.ParquetFile(data, "cpu").read()
    assert repr(got.column("d").dtype) == \
        f"decimal{ty.bit_width}({ty.precision}, {ty.scale})"
    assert got.column("d").to_pyarrow().equals(
        pq.read_table(io.BytesIO(data))["d"].combine_chunks())


# ---- C7.3: dotted projection names -----------------------------------------

def test_dotted_projection_names_follow_pyarrow():
    """C7.3: with a top-level column named "a.b" beside a struct a{b},
    pyarrow's columns=["a.b"] selects the top-level column; the reference
    reads the name as the struct path a -> b (parquet_native.py:128-150).
    The port follows pyarrow; a path that names no top-level column
    still selects the struct branch in both."""
    tab = pa.table({"a.b": pa.array([1, 2]),
                    "a": pa.array([{"b": 10, "c": "x"}, {"b": 20, "c": "y"}]),
                    "z": pa.array([7, 8])})
    data = _pq(tab)
    want = pq.read_table(io.BytesIO(data), columns=["a.b"])
    assert want.column_names == ["a.b"]
    got = pnat.ParquetFile(data, "cpu").read_row_group(0, columns=["a.b"])
    assert got.column_names == ["a.b"]
    assert got.column("a.b").to_pylist() == want["a.b"].to_pylist()
    ref = rnat.ParquetFile(data).read_row_group(0, columns=["a.b"])
    assert ref.column_names == ["a"]                  # the gap
    assert ref.column("a").to_pylist() == [{"b": 10}, {"b": 20}]
    got = pnat.ParquetFile(data, "cpu").read_row_group(0, columns=["a.c"])
    assert_tables_layouts_equal(
        got, rnat.ParquetFile(data).read_row_group(0, columns=["a.c"]))


# ---- the scan builder ------------------------------------------------------

def _scan_file(page_index=True):
    rng = np.random.default_rng(11)
    n = 6000
    tab = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(0, 100, n).astype(np.int32)),
        "s": pa.array([f"s{i % 97}" for i in range(n)]),
        "f": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
    })
    ref, port = ref_and_port(tab)
    buf = io.BytesIO()
    pio.write_parquet(buf, port, pio.WriterProperties(
        row_group_size=2000, data_page_size=1024,
        write_page_index=page_index))
    return buf.getvalue(), tab


def _batches(build):
    return [t for t in build()]


def _ref_pred(t):
    from arrow_tpu.ops import boolean, cmp
    return boolean.or_(cmp.lt(t.column("k"), at.scalar(300, at.int64)),
                       cmp.lt(t.column("v"), at.scalar(2, at.int32)))


def _port_pred(t):
    from arrow_tpu_torch.ops import boolean, cmp
    import arrow_tpu_torch as att
    return boolean.or_(cmp.lt(t.column("k"), att.scalar(300, att.int64)),
                       cmp.lt(t.column("v"), att.scalar(2, att.int32)))


SCANS = {
    "projection": dict(columns=["s", "k"]),
    "row groups": dict(row_groups=[2, 0]),
    "batch size": dict(batch_size=777),
    "limit offset": dict(limit=1500, offset=1900, batch_size=500),
    "callable filter": dict(row_filter="callable"),
    "row filter": dict(row_filter="RowFilter", columns=["s", "k", "f"]),
    "row filter all cols": dict(row_filter="RowFilter"),
    "selection": dict(row_selection=[(5, 40), (1990, 2100), (5990, 6000)]),
    "selection one group": dict(row_selection=[(10, 20)], row_groups=[1]),
    "bloom": dict(bloom=("k", 1234)),
}


def _builders(data, spec):
    out = []
    for mod, pred in ((pio, _port_pred), (rio, _ref_pred)):
        kw = {k: v for k, v in spec.items()
              if k not in ("row_filter", "row_selection", "bloom")}
        b = mod.ParquetReaderBuilder(
            data, **kw, **({"device": "cpu"} if mod is pio else {}))
        rf = spec.get("row_filter")
        if rf == "callable":
            b = b.with_row_filter(pred)
        elif rf == "RowFilter":
            b = b.with_row_filter(mod.RowFilter(pred, ["k", "v"]))
        if "row_selection" in spec:
            b = b.with_row_selection(mod.RowSelection(spec["row_selection"]))
        if "bloom" in spec:
            b = b.with_bloom_filter(*spec["bloom"])
        out.append(b)
    return out


@pytest.mark.parametrize("page_index", [True, False])
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_builder(scan, page_index):
    data, _ = _scan_file(page_index)
    pb, rb = _builders(data, SCANS[scan])
    before = (pnat.PAGES_DECODED[0], pnat.PAGES_SKIPPED[0],
              rnat.PAGES_DECODED[0], rnat.PAGES_SKIPPED[0])
    got, want = _batches(pb.build), _batches(rb.build)
    moved = (pnat.PAGES_DECODED[0] - before[0],
             pnat.PAGES_SKIPPED[0] - before[1])
    assert moved == (rnat.PAGES_DECODED[0] - before[2],
                     rnat.PAGES_SKIPPED[0] - before[3])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_tables_layouts_equal(g, w, scan)
    if scan.startswith("row filter") and page_index:
        assert moved[1] > 0                 # pages really skipped


def test_prefetch_and_threads_give_the_same_batches(monkeypatch):
    data, _ = _scan_file()
    runs = []
    for prefetch, threads in (("0", "0"), ("1", ""), ("3", "2")):
        monkeypatch.setenv("ARROW_TPU_PARQUET_PREFETCH", prefetch)
        monkeypatch.setenv("ARROW_TPU_PARQUET_THREADS", threads)
        runs.append(list(pio.ParquetReaderBuilder(data, device="cpu")
                         .build()))
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(other, runs[0]):
            assert_tables_layouts_equal(a, b)
    monkeypatch.setenv("ARROW_TPU_PARQUET_THREADS", "0")
    assert_tables_layouts_equal(pio.read_parquet(data, device="cpu"),
                                rio.read_parquet(data))


def test_prefetch_places_on_the_consuming_thread(monkeypatch):
    """The prefetch thread and the decode pool make no tensor: every
    column goes onto the device on the thread that takes the batches."""
    data, _ = _scan_file()
    real, threads = pnat.tensor, []

    def spy(a, device):
        threads.append(threading.get_ident())
        return real(a, device)
    monkeypatch.setattr(pnat, "tensor", spy)
    monkeypatch.setenv("ARROW_TPU_PARQUET_PREFETCH", "2")
    monkeypatch.setenv("ARROW_TPU_PARQUET_THREADS", "4")
    got = list(pio.ParquetReaderBuilder(data, device="cpu").build())
    assert len(got) > 2 and threads
    assert set(threads) == {threading.get_ident()}


def test_prefetch_on_a_card_gives_the_same_batches(cuda_device,
                                                   monkeypatch):
    data, _ = _scan_file()
    runs = []
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for prefetch in ("1", "0"):
            monkeypatch.setenv("ARROW_TPU_PARQUET_PREFETCH", prefetch)
            runs.append(list(pio.ParquetReaderBuilder(
                data, device=cuda_device).build()))
    side.synchronize()
    assert len(runs[0]) == len(runs[1]) > 2
    for a, b in zip(*runs):
        assert a.column("k").values.is_cuda
        assert_tables_layouts_equal(to_host(a), to_host(b))


def test_row_selection_algebra():
    a = pio.RowSelection([(0, 5), (3, 10), (20, 30)])
    r = rio.RowSelection([(0, 5), (3, 10), (20, 30)])
    assert a.intervals == r.intervals
    b = pio.RowSelection.from_mask(np.array([0, 1, 1, 0, 1], bool))
    assert b.intervals == rio.RowSelection.from_mask(
        np.array([0, 1, 1, 0, 1], bool)).intervals
    assert a.intersection(b).intervals == r.intersection(
        rio.RowSelection(b.intervals)).intervals
    assert a.union(b).row_count() == r.union(
        rio.RowSelection(b.intervals)).row_count()


def test_builder_needs_a_device():
    data, _ = _scan_file()
    with pytest.raises(ValueError):
        list(pio.ParquetReaderBuilder(data).build())


# ---- metadata, statistics, page index, bloom filters -----------------------

def _stats_file():
    ref, port = ref_and_port(pa.table({
        "i": pa.array([5, None, -3, 9], pa.int64()),
        "u": pa.array([2 ** 32 - 1, 1, None, 7], pa.uint32()),
        "d": pa.array([Decimal("1.5"), Decimal("-2.25"), None,
                       Decimal("0")], pa.decimal128(10, 2)),
        "s": pa.array(["pear", None, "apple", "fig"]),
        "b": pa.array([b"\xff", b"", None, b"\x00"]),
        "f": pa.array([1.5, float("nan"), None, -2.0]),
    }))
    buf = io.BytesIO()
    pio.write_parquet(buf, port, pio.WriterProperties(
        row_group_size=2, write_page_index=True,
        bloom_filter_columns=("i", "s")))
    return buf.getvalue()


def test_metadata_and_statistics():
    data = _stats_file()
    got, want = pio.read_metadata(data), rio.read_metadata(data)
    assert (got.num_rows, got.num_row_groups) == \
        (want.num_rows, want.num_row_groups)
    assert repr(got.schema) == repr(want.schema)
    for rg in range(got.num_row_groups):
        assert got.row_group_num_rows(rg) == want.row_group_num_rows(rg)
        for c in range(6):
            assert repr(got.column_statistics(rg, c)) == \
                repr(want.column_statistics(rg, c)), (rg, c)


@pytest.mark.parametrize("column", ["i", "u", "d", "s", "b", "f"])
def test_statistics_converter(column):
    data = _stats_file()
    got = pio.StatisticsConverter(data, column, device="cpu")
    want = rio.StatisticsConverter(data, column)
    g, w = got.row_group_statistics(), want.row_group_statistics()
    assert g.to_pydict() == w.to_pydict()
    for rg in range(2):
        g, w = got.page_statistics(rg), want.page_statistics(rg)
        assert (g is None) == (w is None)
        if g is not None:
            assert g.to_pydict() == w.to_pydict()


def test_page_index_and_bloom_checks():
    data = _stats_file()
    pf, rf = pnat.ParquetFile(data, "cpu"), rnat.ParquetFile(data)
    for rg in range(2):
        for col in ("i", "s", "f"):
            assert pf.column_index(rg, col) == rf.column_index(rg, col)
            assert pf.offset_index(rg, col) == rf.offset_index(rg, col)
        for col, vals in (("i", [5, -3, 9, 4]), ("s", ["pear", "kiwi"]),
                          ("f", [1.5])):
            g, w = pf.bloom_filter_check(rg, col, vals), \
                rf.bloom_filter_check(rg, col, vals)
            assert (g is None and w is None) or np.array_equal(g, w)
    assert pf.prune_row_groups("i", 9) == rf.prune_row_groups("i", 9)
    assert pf.prune_row_groups("s", "zzz") == rf.prune_row_groups("s", "zzz")


# ---- malformed input -------------------------------------------------------

MALFORMED = {
    "truncated": lambda d: d[:-30],
    "bad magic": lambda d: d[:-4] + b"PAR2",
    "footer length": lambda d: d[:-8] + (10 ** 6).to_bytes(4, "little")
    + b"PAR1",
    "page body": lambda d: d[:4] + bytes(b ^ 0x5A for b in d[4:60])
    + d[60:],
    "empty": lambda d: b"",
    "tiny": lambda d: b"PAR1",
}


@pytest.mark.parametrize("kind", sorted(MALFORMED))
def test_malformed_file_same_error(kind):
    data = MALFORMED[kind](_pq(_mixed_table(), use_dictionary=False))

    def outcome(fn):
        try:
            return fn().to_pydict()
        except Exception as e:          # compared by name
            return type(e).__name__
    got = outcome(lambda: pio.read_parquet(data, device="cpu"))
    want = outcome(lambda: rio.read_parquet(data))
    assert got == want


def test_unknown_projection_same_error():
    data = _pq(_mixed_table())
    with pytest.raises(Exception) as got:
        pio.read_parquet(data, columns=["nope"], device="cpu")
    with pytest.raises(Exception) as want:
        rio.read_parquet(data, columns=["nope"])
    assert type(got.value).__name__ == type(want.value).__name__


def test_reads_land_on_the_named_device():
    data = _pq(_nested_table())
    t = pio.read_parquet(data, device=torch.device("cpu"))
    for c in t.columns:
        assert c.device == torch.device("cpu")
