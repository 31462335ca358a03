"""Parity of the port's CSV reader and writer (arrow_tpu_torch/io/csv.py)
with the JAX package's (arrow_tpu/io/csv.py), mirroring
tests/test_csv_native.py: the same text through both readers gives equal
tables (bit for bit, `_py_equal`), the same table through both writers
gives the same bytes, and pyarrow.csv reads those bytes back as the
source.  Readers take a device; here it is the CPU."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import csv as rcsv
from arrow_tpu_torch.io import csv as pcsv
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table, ref_and_port)

CPU = "cpu"


def ref_schema(fields):
    return at.Schema(tuple(at.Field(n, getattr(at.dtypes, d))
                           for n, d in fields))


def port_schema(fields):
    return att.dtypes.Schema(tuple(
        att.dtypes.Field(n, getattr(att.dtypes, d)) for n, d in fields))


READS = {
    "quotes_escapes_crlf": ('a,b,c\r\n"x,1","say ""hi""",3\r\n'
                            'plain,"multi\nline",-7\r\n', {}),
    "inference_matrix": ("b,i,f,d,ts,s\n"
                         "true,1,1.5,2021-01-01,2021-01-01T00:00:01.5,hey\n"
                         "false,-2,2e3,1999-12-31,2021-06-01 12:30:00,ho\n"
                         ",,,,,\n", {}),
    "overflow_to_float": ("v\n99999999999999999999\n1\n", {}),
    "projection_names": (b"a,b,c\n1,x,0.5\n2,y,1.5\n",
                         {"projection": ["c", "a"]}),
    "projection_indices": (b"a,b,c\n1,x,0.5\n2,y,1.5\n",
                           {"projection": [1]}),
    "semicolon": (b'a;b\n"x;y";2\nplain;3\n', {"delimiter": ";"}),
    "pipe_tpch": (b"1|155190|7706|1|17|21168.23|0.04|0.02|N|O|1996-03-13|\n"
                  b"1|67310|7311|2|36|45983.16|0.09|0.06|N|O|1996-04-12|\n",
                  {"delimiter": "|", "has_header": False}),
    "quoted_header": (b'"he""llo",x\n1,2\n', {}),
    "no_header": (b"1,2\n3,4\n", {"has_header": False}),
    "empty_body": (b"a,b\n", {}),
    "negative_and_blank": (b"a,b\n-5,\n,2.5\n7,-0.0\n", {}),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_read_matches_reference(name):
    src, kw = READS[name]
    want = rcsv.read_csv(src, **kw)
    got = pcsv.read_csv(src, **kw, device=CPU)
    assert_tables_equal(got, port_table(want))


SCHEMAS = {
    "int_widths": ("x,y\n1,250\n-3,12\n", [("x", "int16"), ("y", "uint8")]),
    "unsigned_and_floats": ("a,b,c\n4000000000,1.5,-2\n7,,3\n",
                            [("a", "uint32"), ("b", "float32"),
                             ("c", "int8")]),
    "dates_and_bool": ("d,t\n2020-02-29,true\n1970-01-01,false\n",
                       [("d", "date32"), ("t", "bool_")]),
    "large_utf8": ("s,n\nabc,1\n,2\nxyz,3\n", [("s", "large_utf8"),
                                               ("n", "int64")]),
    "binary": ("s\nab\ncd\n", [("s", "binary")]),
    "missing_field_is_utf8": ("a,b\n1,2\n", [("a", "int32")]),
}


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_read_with_schema_matches_reference(name):
    src, fields = SCHEMAS[name]
    want = rcsv.read_csv(src, schema=ref_schema(fields))
    got = pcsv.read_csv(src, schema=port_schema(fields), device=CPU)
    assert_tables_equal(got, port_table(want))


def test_large_utf8_offsets_are_int64():
    """The port keeps int64 offsets under large_utf8; the reference
    writes int32 there (ROADMAP C14)."""
    src = "s\nabc\nde\n"
    want = rcsv.read_csv(src, schema=ref_schema([("s", "large_utf8")]))
    got = pcsv.read_csv(src, schema=port_schema([("s", "large_utf8")]),
                        device=CPU)
    assert got.column("s").offsets.dtype == torch.int64
    assert np.asarray(want.column("s").offsets).dtype == np.int32
    assert got.column("s").to_pylist() == want.column("s").to_pylist()


def test_infer_schema_matches_reference():
    src = READS["inference_matrix"][0]
    want = rcsv.infer_schema(src)
    got = pcsv.infer_schema(src)
    assert [(f.name, repr(f.dtype)) for f in got.fields] == \
        [(f.name, repr(f.dtype)) for f in want.fields]
    assert [repr(f.dtype) for f in got.fields] == [
        "bool", "int64", "float64", "date32", "timestamp[us]", "utf8"]


@pytest.mark.parametrize("src", ["a,b\n1,2\n3\n", "a\n1,2\n"])
def test_ragged_raises_in_both(src):
    with pytest.raises(at.errors.ArrowInvalid):
        rcsv.read_csv(src)
    with pytest.raises(att.errors.ArrowInvalid):
        pcsv.read_csv(src, device=CPU)


def test_unparseable_under_schema_raises_in_both():
    src = "x\n1\nfoo\n"
    with pytest.raises(at.errors.ArrowInvalid):
        rcsv.read_csv(src, schema=ref_schema([("x", "int64")]))
    with pytest.raises(att.errors.ArrowInvalid):
        pcsv.read_csv(src, schema=port_schema([("x", "int64")]), device=CPU)


def test_device_is_required():
    with pytest.raises(TypeError):
        pcsv.read_csv("a\n1\n")
    with pytest.raises(ValueError):
        pcsv.read_csv("a\n1\n", device=None)


def _random_batch(seed: int, n: int) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.1
    words = np.array(["plain", 'q"uote', "com,ma", "nl\nin", "", "é|x"])
    return pa.record_batch({
        "i64": pa.array(rng.integers(-10**12, 10**12, n), mask=null),
        "i32": pa.array(rng.integers(-2**31, 2**31, n, dtype=np.int32)),
        "u64": pa.array(rng.integers(0, 2**63, n, dtype=np.uint64)
                        * np.uint64(2)),
        "f64": pa.array(rng.standard_normal(n) * 1e3, mask=null),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5),
        "d": pa.array(rng.integers(-5000, 30000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("us")),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=null),
        "ls": pa.array(words[rng.integers(0, len(words), n)],
                       pa.large_string()),
        "dict": pa.array(words[rng.integers(0, 3, n)]).dictionary_encode(),
        "bin": pa.array([bytes([k % 256, 7]) for k in range(n)]),
    })


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delimiter", [",", "|"])
def test_write_matches_reference_bytes(seed, delimiter):
    batch = _random_batch(seed, 400)
    ref, port = ref_and_port(batch)
    want, got = io.BytesIO(), io.BytesIO()
    rcsv.WriterBuilder(delimiter=delimiter).write(want, ref)
    pcsv.WriterBuilder(delimiter=delimiter).write(got, port)
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("seed", [3, 4])
def test_written_text_reads_back_in_pyarrow_and_the_port(seed):
    """pyarrow.csv reads the port's bytes as the source (strings' nulls
    write as empty fields, read back as empty strings)."""
    rng = np.random.default_rng(seed)
    n = 500
    src = pa.record_batch({
        "k": pa.array(rng.integers(-10**9, 10**9, n)),
        "x": pa.array(np.round(rng.random(n) * 1e5, 2)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.date32()),
        "s": pa.array([f"w{v}" for v in rng.integers(0, 50, n)]),
    })
    _, port = ref_and_port(src)
    buf = io.BytesIO()
    pcsv.write_csv(buf, port)
    back = pacsv.read_csv(io.BytesIO(buf.getvalue()),
                          convert_options=pacsv.ConvertOptions(
                              column_types=src.schema))
    assert back.to_pydict() == pa.Table.from_batches([src]).to_pydict()
    schema = att.dtypes.Schema(tuple(f for f in port.schema.fields))
    again = pcsv.read_csv(buf.getvalue(), schema=schema, device=CPU)
    assert_tables_equal(again, port)


def test_roundtrip_with_quoting_matches_reference():
    data = {"s": ["plain", 'q"uote', "com,ma", None, "nl\nin"],
            "v": np.array([1, 2, 3, 4, 5], np.int64)}
    ref = at.Table.from_pydict(data)
    port = att.Table.from_pydict(data, device=CPU)
    want, got = io.BytesIO(), io.BytesIO()
    rcsv.write_csv(want, ref)
    pcsv.write_csv(got, port)
    assert got.getvalue() == want.getvalue()
    assert_tables_equal(pcsv.read_csv(got.getvalue(), device=CPU),
                        port_table(rcsv.read_csv(want.getvalue())))
    assert pacsv.read_csv(io.BytesIO(got.getvalue()))["v"].to_pylist() == \
        [1, 2, 3, 4, 5]


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_timestamp_cells_match_reference_and_numpy_iso(unit):
    rng = np.random.default_rng(7)
    scale = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}
    lim = min(250_000 * 366 * 86400 * scale[unit], 2**62)
    vals = rng.integers(-lim, lim, 300)
    vals = np.where(vals < -62135596800 * scale[unit], -vals, vals)
    ref = at.Table((at.column(vals, dtype=at.timestamp(unit)),),
                   at.Schema((at.Field("t", at.timestamp(unit)),)))
    port = port_table(ref)
    want, got = io.BytesIO(), io.BytesIO()
    rcsv.write_csv(want, ref)
    pcsv.write_csv(got, port)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().decode().strip().split("\n")[1:] == \
        vals.astype(f"datetime64[{unit}]").astype("U").tolist()


def test_date_cells_match_reference_and_numpy_iso():
    rng = np.random.default_rng(8)
    d = rng.integers(-719162, 10**6, 300).astype(np.int32)
    ref = at.Table((at.column(d, dtype=at.date32),),
                   at.Schema((at.Field("d", at.date32),)))
    want, got = io.BytesIO(), io.BytesIO()
    rcsv.write_csv(want, ref)
    pcsv.write_csv(got, port_table(ref))
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().decode().strip().split("\n")[1:] == \
        d.astype("datetime64[D]").astype("U").tolist()


def test_nested_and_decimal_cells_match_reference():
    """Cells of other types go through the ArrayFormatter in both."""
    import decimal
    batch = pa.record_batch({
        "dec": pa.array([decimal.Decimal("1.25"), None,
                         decimal.Decimal("-3.50")], pa.decimal128(6, 2)),
        "l": pa.array([[1, 2], None, []]),
        "t": pa.array([1, None, 86_399_999_999], pa.time64("us")),
    })
    ref, port = ref_and_port(batch)
    want, got = io.BytesIO(), io.BytesIO()
    rcsv.write_csv(want, ref)
    pcsv.write_csv(got, port)
    assert got.getvalue() == want.getvalue()


def test_push_decoder_chunks_match_reference():
    src = ("a,b\n" + "".join(f"{i},w{i}\n" for i in range(100))).encode()
    rdec = rcsv.ReaderBuilder().build_decoder()
    pdec = pcsv.ReaderBuilder(device=CPU).build_decoder()
    rows = 0
    for i in range(0, len(src), 17):
        rdec.decode(src[i:i + 17])
        pdec.decode(src[i:i + 17])
        want, got = rdec.flush(), pdec.flush()
        assert (want is None) == (got is None)
        if got is not None:
            assert_tables_equal(got, port_table(want))
            rows += got.num_rows
    assert rows == 100


def test_reader_builder_batches_match_reference():
    src = b"a,b\n" + b"".join(b"%d,%d.5\n" % (i, i) for i in range(10))
    want = rcsv.ReaderBuilder(batch_size=4, projection=["b"]).build(src)
    got = pcsv.ReaderBuilder(device=CPU, batch_size=4,
                             projection=["b"]).build(src)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_tables_equal(g, port_table(w))


def test_columns_parse_on_the_pool(monkeypatch):
    """Many columns parse as tasks of the file layer's pool; the table
    equals the reference's whatever the thread count."""
    rng = np.random.default_rng(5)
    n, k = 3000, 12
    vals = rng.integers(-10**6, 10**6, (n, k))
    src = (",".join(f"c{j}" for j in range(k)) + "\n"
           + "\n".join(",".join(map(str, r)) for r in vals) + "\n").encode()
    want = port_table(rcsv.read_csv(src))
    for threads in ("0", "4"):
        monkeypatch.setenv("ARROW_TPU_PARQUET_THREADS", threads)
        assert_tables_equal(pcsv.read_csv(src, device=CPU), want)


def test_read_onto_the_card(cuda_device):  # noqa: F811
    src = READS["inference_matrix"][0]
    got = pcsv.read_csv(src, device=cuda_device)
    assert all(c.device.type == "cuda" for c in got.columns)
    assert_tables_equal(got, port_table(rcsv.read_csv(src)))


# ---- the text paths the readers lean on --------------------------------------

DATE_TEXTS = ["2020-02-29", "2021-02-29", "0000-01-01", "0001-01-01",
              "9999-12-31", "1969-12-31", "1970-01-01", "2020-1-01",
              "20200101", " 2020-01-02 ", "2020-13-01", "abcd-ef-gh",
              "2020/01/01", "", None, "1992-01-02"]


@pytest.mark.parametrize("safe", [True, False])
def test_text_to_date32_matches_reference(safe):
    """The numpy fast path for exact YYYY-MM-DD text and the value by
    value parse of the rest give the reference's days and failures."""
    rng = np.random.default_rng(9)
    y, m, d = (rng.integers(1, 10000, 3000), rng.integers(1, 13, 3000),
               rng.integers(1, 32, 3000))
    texts = DATE_TEXTS + [f"{a:04d}-{b:02d}-{c:02d}" for a, b, c in
                          zip(y, m, d)]
    from arrow_tpu.ops.cast import CastOptions as RO, cast as rcast
    from arrow_tpu_torch.ops.cast import CastOptions as PO, cast as pcast
    from torch_port_util import port_column, same_outcome
    ref = at.column(texts, at.dtypes.utf8)
    same_outcome(
        lambda: pcast(port_column(ref), att.dtypes.date32, PO(safe=safe)),
        lambda: rcast(ref, at.dtypes.date32, RO(safe=safe)), "date32",
        masks=True)


@pytest.mark.parametrize("piece", [1, 64, 1 << 28])
@pytest.mark.parametrize("dtype", ["utf8", "large_utf8", "binary"])
def test_string_take_in_pieces_matches_reference(piece, dtype, monkeypatch):
    """A string take gathers GATHER_PIECE output bytes at a time; every
    piece size gives the reference's take."""
    from arrow_tpu.ops.take import take as rtake
    from arrow_tpu_torch.ops import take as ptake
    from torch_port_util import assert_columns_equal, port_column
    rng = np.random.default_rng(4)
    words = [None if k % 9 == 0 else "é" * int(k % 5) + "x" * int(k % 13)
             for k in rng.integers(0, 1000, 700)]
    if dtype == "binary":
        words = [None if w is None else w.encode() for w in words]
    ref = at.column(words, getattr(at.dtypes, dtype))
    idx = at.column(rng.integers(0, 700, 2500).astype(np.int64))
    monkeypatch.setattr(ptake, "GATHER_PIECE", piece)
    got = ptake.take(port_column(ref), port_column(idx))
    assert_columns_equal(got, port_column(rtake(ref, idx)), dtype)


def test_string_take_past_int32_offsets_raises():
    """A utf8 take whose bytes pass 2^31 raises instead of wrapping its
    int32 offsets (checked before any byte moves)."""
    from arrow_tpu_torch.core.column import PrimitiveColumn, StringColumn
    from arrow_tpu_torch.ops.take import take
    big = 1 << 20
    col = StringColumn(torch.tensor([0, big], dtype=torch.int32),
                       torch.zeros(big, dtype=torch.uint8))
    idx = PrimitiveColumn(torch.zeros(2049, dtype=torch.int64),
                          att.dtypes.int64)
    with pytest.raises(att.errors.ArrowInvalid):
        take(col, idx)
