"""Arrow IPC of the port (io/ipc.py, io/ipc_format.py) against the JAX
package's, with pyarrow as the byte-level oracle, on every layout of
the reference's tests/test_ipc_native.py and the IPC class of
tests/test_io.py:

  - the port's stream and file bytes equal the reference's for the same
    table, uncompressed and with LZ4 (and ZSTD where `zstandard` is
    installed);
  - the port's readers equal the reference's on the same bytes, the
    reference's and pyarrow's, buffer for buffer, and what the port
    writes reads back in pyarrow equal to the source;
  - dictionaries (replacement, delta, nested), chunked StreamDecoder
    feeds, views over several variadic buffers, legacy framing,
    truncated and malformed input (the same error names).
"""

import gc
import io

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import interop as ri
from arrow_tpu.io import ipc as ripc
from arrow_tpu_torch import dtypes as dt
from arrow_tpu_torch.io import ipc as pipc
from arrow_tpu_torch.io import ipc_format as pfmt
from test_ipc_native import _arrays, _pa_stream_bytes
from torch_port_util import assert_layouts_equal, port_table

ARRAYS = _arrays()
NAMES = sorted(ARRAYS)


def _tables(batch):
    """The reference's table of a pyarrow batch and the port's table of
    the same buffers."""
    ref = ri.table_from_pyarrow(batch)
    return ref, port_table(ref)


def _same_tables(got, want, what=""):
    assert got.column_names == want.column_names, what
    assert got.num_rows == want.num_rows, what
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        assert_layouts_equal(g, w, f"{what}{name}")


def _stream(write, table, **kw) -> bytes:
    buf = io.BytesIO()
    write(buf, table, **kw)
    return buf.getvalue()


CODECS = [None, "lz4", "zstd"]


def _codec(c):
    if c == "zstd":
        pytest.importorskip("zstandard")
    return c


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", NAMES)
def test_stream_bytes_equal_the_reference(name, codec):
    ref, port = _tables(pa.record_batch({name: ARRAYS[name]}))
    codec = _codec(codec)
    assert _stream(pipc.write_stream, port, compression=codec) == \
        _stream(ripc.write_stream, ref, compression=codec)


@pytest.mark.parametrize("name", NAMES)
def test_file_bytes_equal_the_reference(name):
    ref, port = _tables(pa.record_batch({name: ARRAYS[name]}))
    got = _stream(pipc.write_file, [port, port])
    assert got == _stream(ripc.write_file, [ref, ref])
    back = pipc.read_file(got, "cpu")
    want = ripc.read_file(got)
    assert len(back) == len(want) == 2
    for b, w in zip(back, want):
        _same_tables(b, w, name)


@pytest.mark.parametrize("name", NAMES)
def test_read_pyarrow_stream(name):
    batch = pa.record_batch({name: ARRAYS[name]})
    raw = _pa_stream_bytes(batch)
    got = pipc.read_stream(raw, "cpu")
    want = ripc.read_stream(raw)
    assert len(got) == len(want) == 1
    _same_tables(got[0], want[0], name)
    assert got[0].columns[0].device == torch.device("cpu")
    back = list(paipc.open_stream(_stream(pipc.write_stream, got[0])))
    assert back[0].equals(batch)


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_compressed_both_directions(codec):
    codec = _codec(codec)
    batch = pa.record_batch({
        "x": pa.array(np.arange(1000) % 7, pa.int64()),
        "s": pa.array([f"value-{i % 13}" for i in range(1000)]),
    })
    raw = _pa_stream_bytes(batch, compression=codec)
    got = pipc.read_stream(raw, "cpu")
    _same_tables(got[0], ripc.read_stream(raw)[0])
    ours = _stream(pipc.write_stream, got[0], compression=codec)
    assert len(ours) < len(_pa_stream_bytes(batch))
    assert list(paipc.open_stream(ours))[0].equals(batch)


def test_all_layouts_one_batch_each_length():
    by_len = {}
    for k, v in ARRAYS.items():
        by_len.setdefault(len(v), {})[k] = v
    for group in by_len.values():
        ref, port = _tables(pa.record_batch(group))
        raw = _stream(pipc.write_stream, port)
        assert raw == _stream(ripc.write_stream, ref)
        _same_tables(pipc.read_stream(raw, "cpu")[0],
                     ripc.read_stream(raw)[0])


def test_file_with_dictionary(tmp_path):
    batch = pa.record_batch({
        "d": pa.array(["a", "b", None, "a"],
                      pa.dictionary(pa.int32(), pa.string())),
        "v": pa.array([1.0, 2.0, 3.0, 4.0]),
    })
    sink = io.BytesIO()
    with paipc.new_file(sink, batch.schema) as w:
        w.write_batch(batch)
        w.write_batch(batch)
    ours = pipc.read_file(io.BytesIO(sink.getvalue()), "cpu")
    for o, r in zip(ours, ripc.read_file(io.BytesIO(sink.getvalue()))):
        _same_tables(o, r)
    p = str(tmp_path / "dict.arrow")
    pipc.write_file(p, ours)
    with pa.OSFile(p) as f:
        r = paipc.open_file(f)
        assert r.num_record_batches == 2
        assert r.get_batch(0).equals(batch) and r.get_batch(1).equals(batch)
    with pytest.raises(Exception) as got:   # replacement in a file
        d2 = att.compute.dictionary_encode(att.column(["z", "y", "z", "y"],
                                                      device="cpu"))
        t2 = att.Table([d2, ours[0].column("v")], ours[0].schema)
        pipc.write_file(io.BytesIO(), [ours[0], t2])
    assert type(got.value).__name__ == "ArrowInvalid"


@pytest.mark.parametrize("chunk", [1, 3, 7, 64, 1 << 20])
def test_stream_decoder_chunked(chunk):
    batch = pa.record_batch({"s": pa.array(["aa", None, "cc"]),
                             "n": pa.array([1, 2, 3], pa.int64())})
    data = _pa_stream_bytes(batch)
    dec, ref = pipc.StreamDecoder("cpu"), ripc.StreamDecoder()
    for i in range(0, len(data), chunk):
        dec.feed(data[i:i + chunk])
        ref.feed(data[i:i + chunk])
    _same_tables(dec.next_batch(), ref.next_batch())
    assert dec.next_batch() is None and ref.next_batch() is None
    assert repr(dec.schema) == repr(ref.schema)


def test_dictionary_replacement_stream():
    c1 = att.compute.dictionary_encode(att.column(["a", "b", "a"],
                                                  device="cpu"))
    c2 = att.compute.dictionary_encode(att.column(["c", "d", "c"],
                                                  device="cpu"))
    s = dt.Schema((dt.Field("k", c1.dtype),))
    buf = io.BytesIO()
    w = pipc.StreamWriter(buf, att.Table((c1,), s))
    w.write(att.Table((c1,), s))
    w.write(att.Table((c2,), s))
    w.close()
    back = list(paipc.open_stream(pa.py_buffer(buf.getvalue())))
    assert back[0].column(0).to_pylist() == ["a", "b", "a"]
    assert back[1].column(0).to_pylist() == ["c", "d", "c"]
    ours = pipc.read_stream(buf.getvalue(), "cpu")
    for o, r in zip(ours, ripc.read_stream(buf.getvalue())):
        _same_tables(o, r)


def test_dictionary_delta_stream_from_pyarrow():
    b1 = pa.record_batch({"k": pa.array(["a", "b"]).dictionary_encode()})
    b2 = pa.record_batch(
        {"k": pa.array(["a", "b", "c", "d"]).dictionary_encode()})
    sink = io.BytesIO()
    opts = paipc.IpcWriteOptions(emit_dictionary_deltas=True)
    with paipc.new_stream(sink, b1.schema, options=opts) as w:
        w.write_batch(b1)
        w.write_batch(b2)
    ours = pipc.read_stream(sink.getvalue(), "cpu")
    want = ripc.read_stream(sink.getvalue())
    assert [o.column("k").to_pylist() for o in ours] == \
        [["a", "b"], ["a", "b", "c", "d"]]
    for o, r in zip(ours, want):
        _same_tables(o, r)


def test_dictionary_replacement_not_fooled_by_id_recycling():
    enc = att.compute.dictionary_encode
    buf = io.BytesIO()
    t1 = att.Table.from_pydict({"d": enc(att.column(["aa", "bb"],
                                                    device="cpu"))})
    w = pipc.StreamWriter(buf, t1)
    w.write(t1)
    del t1
    gc.collect()
    for k in range(100):
        enc(att.column([f"junk{k}", "zz"], device="cpu"))
    w.write(att.Table.from_pydict({"d": enc(att.column(["cc", "dd"],
                                                       device="cpu"))}))
    w.close()
    out = pipc.read_stream(buf.getvalue(), "cpu")
    assert [o.column(0).to_pylist() for o in out] == [["aa", "bb"],
                                                       ["cc", "dd"]]


def test_nested_dictionary_roundtrip():
    """dict<i32, list<dict<i32, utf8>>>: inner dictionaries take their
    own ids, written innermost first; the bytes equal the reference's."""
    import jax.numpy as jnp
    inner_r = at.compute.dictionary_encode(at.column(["x", "y", "x"]))
    lst_r = at.core.column.ListColumn(jnp.array([0, 2, 3], jnp.int32),
                                      inner_r)
    outer_r = at.core.column.DictionaryColumn(
        jnp.array([0, 1, 0, 1], jnp.int32), lst_r)
    ref = at.Table((outer_r,), at.dtypes.Schema(
        (at.dtypes.Field("d", outer_r.dtype),)))
    port = port_table(ref)
    raw = _stream(pipc.write_stream, port)
    assert raw == _stream(ripc.write_stream, ref)
    _same_tables(pipc.read_stream(raw, "cpu")[0], ripc.read_stream(raw)[0])


def test_nan_bits():
    batch = pa.record_batch({"f": pa.array([np.nan, 1.0, -np.nan])})
    got = pipc.read_stream(_pa_stream_bytes(batch), "cpu")[0]
    back = list(paipc.open_stream(_stream(pipc.write_stream, got)))[0]
    assert np.array_equal(np.asarray(back.column(0)).view(np.uint64),
                          np.asarray(batch.column(0)).view(np.uint64))


def test_empty_batch():
    batch = pa.record_batch({"a": pa.array([], pa.int64()),
                             "b": pa.array([], pa.string())})
    ref, port = _tables(batch)
    raw = _stream(pipc.write_stream, port)
    assert raw == _stream(ripc.write_stream, ref)
    assert list(paipc.open_stream(raw))[0].equals(batch)
    _same_tables(pipc.read_stream(raw, "cpu")[0], ripc.read_stream(raw)[0])


def test_schema_metadata_preserved():
    schema = pa.schema([pa.field("a", pa.int64(), metadata={b"k": b"v"})],
                       metadata={b"top": b"meta"})
    batch = pa.record_batch([pa.array([1, 2])], schema=schema)
    got = pipc.read_stream(_pa_stream_bytes(batch), "cpu")[0]
    assert got.schema.metadata == (("top", "meta"),)
    back = list(paipc.open_stream(_stream(pipc.write_stream, got)))[0]
    assert back.schema.metadata == {b"top": b"meta"}
    assert back.schema.field("a").metadata == {b"k": b"v"}


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_roundtrip(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))

    def prim(dtype):
        return pa.array(rng.integers(-1000, 1000, n), dtype,
                        mask=rng.random(n) < rng.choice([0.0, 0.3]))
    batch = pa.record_batch({
        "a": prim(pa.int64()), "b": prim(pa.int32()),
        "c": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "d": pa.array([f"s{int(i)}" for i in rng.integers(0, 50, n)]),
        "e": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "f": pa.array([[int(x) for x in rng.integers(0, 9,
                                                     rng.integers(0, 4))]
                       for _ in range(n)], pa.list_(pa.int64())),
    })
    ref, port = _tables(batch)
    for codec in (None, "lz4"):
        raw = _stream(pipc.write_file, port, compression=codec)
        assert raw == _stream(ripc.write_file, ref, compression=codec)
        _same_tables(pipc.read_file(raw, "cpu")[0], ripc.read_file(raw)[0])
    back = list(paipc.open_stream(_stream(pipc.write_stream, port)))[0]
    assert back.equals(batch)


def test_view_over_several_variadic_buffers(monkeypatch):
    """Past the view limit (shrunk here) long values go to more than one
    variadic buffer; the bytes equal the reference's, pyarrow reads
    them."""
    from arrow_tpu.io import ipc_format as rfmt
    monkeypatch.setattr(pfmt, "_VIEW_BUF_LIMIT", 48)
    monkeypatch.setattr(rfmt, "_VIEW_BUF_LIMIT", 48)
    longs = [f"long-string-payload-{i:04d}-abcdefghijklmnop"
             for i in range(7)]
    vals = ["tiny", None] + longs + ["x"]
    ref, port = _tables(pa.record_batch({"v": pa.array(vals,
                                                       pa.string_view())}))
    raw = _stream(pipc.write_stream, port)
    assert raw == _stream(ripc.write_stream, ref)
    assert pipc.read_stream(raw, "cpu")[0].columns[0].to_pylist() == vals
    assert paipc.open_stream(pa.BufferReader(raw)).read_all() \
        .column(0).to_pylist() == vals


def test_day_time_interval_wire_order():
    col = att.PrimitiveColumn(torch.tensor([(1 << 32) | 2]),
                              dt.interval("day_time"))
    t = att.Table((col,), dt.Schema((dt.Field("i", col.dtype),)))
    raw = _stream(pipc.write_stream, t)
    assert bytes([1, 0, 0, 0, 2, 0, 0, 0]) in raw
    assert int(pipc.read_stream(raw, "cpu")[0].column(0).values[0]) == \
        (1 << 32) | 2


def test_legacy_v4_framing():
    rng = np.random.default_rng(0)
    pt = pa.table({
        "a": pa.array(rng.integers(-10**9, 10**9, 500), pa.int64()),
        "s": pa.array(["v%d" % (i % 7) for i in range(500)]),
        "d": pa.array(["w%d" % (i % 5) for i in range(500)]
                      ).dictionary_encode(),
        "f": pa.array(rng.random(500), pa.float64()),
    })
    opts = paipc.IpcWriteOptions(use_legacy_format=True,
                                 metadata_version=paipc.MetadataVersion.V4)
    buf = io.BytesIO()
    with paipc.new_stream(buf, pt.schema, options=opts) as w:
        w.write_table(pt)
    got = pipc.read_stream(io.BytesIO(buf.getvalue()), "cpu")
    _same_tables(got[0], ripc.read_stream(io.BytesIO(buf.getvalue()))[0])
    buf2 = io.BytesIO()
    with paipc.new_file(buf2, pt.schema, options=opts) as w:
        w.write_table(pt)
    f = pipc.FileReader(buf2.getvalue(), "cpu")
    _same_tables(f.get_batch(0), ripc.FileReader(buf2.getvalue()).get_batch(0))
    assert f.num_record_batches == 1


def test_stream_writer_appends_to_a_nonempty_sink():
    prefix = b"HEADERBYTES!" * 10
    buf = io.BytesIO()
    buf.write(prefix)
    t = att.Table.from_pydict({"x": np.arange(400_000, dtype=np.int64)},
                              device="cpu")
    w = pipc.StreamWriter(buf, t.schema)
    w.write(t)
    w.close()
    raw = buf.getvalue()
    assert raw[:len(prefix)] == prefix
    got = pipc.read_stream(raw[len(prefix):], "cpu")[0]
    assert torch.equal(got.column("x").values, torch.arange(400_000))


def test_serialize_and_deserialize():
    batches = [pa.record_batch({"x": pa.array([1, 2, None]),
                                "s": pa.array(["a", None, "c"])})] * 3
    ref = [ri.table_from_pyarrow(b) for b in batches]
    port = [port_table(r) for r in ref]
    raw = pipc.serialize_table(port[0], "lz4")
    assert raw == ripc.serialize_table(ref[0], "lz4")
    _same_tables(pipc.deserialize_table(raw, "cpu"),
                 ripc.deserialize_table(raw))
    many = _stream(pipc.write_stream, port)
    assert many == _stream(ripc.write_stream, ref)
    _same_tables(pipc.deserialize_table(many, "cpu"),
                 ripc.deserialize_table(many))


def test_readers_need_a_device():
    raw = _stream(pipc.write_stream, att.Table.from_pydict(
        {"x": [1]}, device="cpu"))
    for call in (lambda: pipc.read_stream(raw, None),
                 lambda: pipc.StreamDecoder(None),
                 lambda: pipc.deserialize_table(raw, None)):
        with pytest.raises(ValueError):
            call()


def test_reader_copies_out_of_the_body():
    """A read column owns its buffers: it is writable and does not
    change the bytes it came from."""
    raw = bytearray(_stream(pipc.write_stream, att.Table.from_pydict(
        {"x": np.arange(5, dtype=np.int64)}, device="cpu")))
    got = pipc.read_stream(bytes(raw), "cpu")[0]
    got.column("x").values[0] = 9
    assert pipc.read_stream(bytes(raw), "cpu")[0].column("x") \
        .to_pylist() == [0, 1, 2, 3, 4]


def test_unsigned_and_float16_storage():
    batch = pa.record_batch({
        "u64": pa.array([2 ** 64 - 1, 0, None], pa.uint64()),
        "u16": pa.array([65535, 1, None], pa.uint16()),
        "f16": pa.array(np.array([1.5, -0.0, np.inf], np.float16))})
    got = pipc.read_stream(_pa_stream_bytes(batch), "cpu")[0]
    assert got.column("u64").values.dtype == torch.int64
    assert got.column("u16").values.dtype == torch.int16
    assert got.column("u64").to_pylist() == [2 ** 64 - 1, 0, None]
    assert list(paipc.open_stream(_stream(pipc.write_stream, got)))[0] \
        .equals(batch)


MALFORMED = {
    "truncated": lambda raw: raw[:-12],
    "no body": lambda raw: raw[:len(raw) // 3],
    "flipped": lambda raw: raw[:40] + bytes(b ^ 0xFF for b in raw[40:80])
    + raw[80:],
    "garbage": lambda raw: b"\xff\xff\xff\xff\x10\x00\x00\x00" + b"x" * 40,
    "empty": lambda raw: b"",
}


@pytest.mark.parametrize("kind", sorted(MALFORMED))
def test_malformed_stream_same_error(kind):
    raw = MALFORMED[kind](_stream(ripc.write_stream, at.Table.from_pydict(
        {"x": [1, 2, 3, 4], "s": ["a", "b", None, "d"]})))

    def outcome(fn):
        try:
            out = fn()
        except Exception as e:           # compared by name
            return type(e).__name__
        return [t.to_pydict() for t in out]
    assert outcome(lambda: pipc.read_stream(raw, "cpu")) == \
        outcome(lambda: ripc.read_stream(raw))


@pytest.mark.parametrize("kind", ["bad magic", "truncated"])
def test_malformed_file_same_error(kind):
    raw = _stream(ripc.write_file, at.Table.from_pydict({"x": [1, 2, 3]}))
    raw = b"NOTARR" + raw[6:] if kind == "bad magic" else raw[:-20]

    def name(fn):
        with pytest.raises(Exception) as e:
            fn()
        return type(e.value).__name__
    assert name(lambda: pipc.read_file(raw, "cpu")) == \
        name(lambda: ripc.read_file(raw))


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_large_buffers_compress_in_parallel(codec):
    """Buffers past 1 MB are compressed and decompressed on a thread
    pool; the bytes are the reference's one pass."""
    codec = _codec(codec)
    rng = np.random.default_rng(4)
    n = 300_000
    batch = pa.record_batch({
        "a": pa.array(rng.integers(0, 1000, n)),
        "b": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array([f"v{i % 977}" for i in range(n)]),
        "f": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2)})
    ref, port = _tables(batch)
    raw = _stream(pipc.write_file, [port, port], compression=codec)
    assert raw == _stream(ripc.write_file, [ref, ref], compression=codec)
    for got, want in zip(pipc.read_file(raw, "cpu"), ripc.read_file(raw)):
        _same_tables(got, want)
