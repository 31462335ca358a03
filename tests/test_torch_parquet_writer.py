"""The Parquet writers of the port (io/parquet_writer.py, the writers of
io/parquet_io.py, io/async_writer.py) against the JAX package's: the
same table written with the same options gives the same bytes up to the
footer, and a footer equal but for `created_by` (the port names itself
there).  Each file also reads back in the port equal to the reference's
reading of its own file, and in pyarrow equal to the source.

Covered: every layout the reference's writer takes (flat, nested at
any depth, dictionaries, decimals of every width, unsigned, float16,
the temporal types, views stored as lists), both data page versions,
every codec, the page index, checksums, statistics, sorting columns,
bloom filters, forced value encodings, the dictionary fallback,
per-column properties, the streaming and async writers, modular
encryption (decrypted both ways with the reference), and the round-5
regressions: the nested-list write with an empty inner child and the
fuzz families of tests/test_fuzz_parity.py, every seed through both.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import arrow_tpu as at
from arrow_tpu.io import async_writer as rasync
from arrow_tpu.io import parquet_io as rio
from arrow_tpu.io import parquet_native as rnat
from arrow_tpu_torch.io import async_writer as pasync
from arrow_tpu_torch.io import parquet_io as pio
from arrow_tpu_torch.io import parquet_native as pnat
from test_fuzz_parity import (_empty_heavy_type, _empty_heavy_val,
                              _random_dtype, _random_value)
from test_parquet_native import _nested_table
from test_torch_parquet import _deep_table, _typed_table
from torch_port_util import (assert_parquet_like_reference,  # noqa: F401
                             assert_tables_layouts_equal, cuda_device,
                             ref_and_port)

rnat.nt._load()             # the reference's loader races (ROADMAP C19)


def _flat_table():
    """tests/test_parquet_native.py TestNativeWriter's table."""
    return pa.table({
        "i": pa.array([1, None, 3, 4], pa.int64()),
        "u16": pa.array([1, 2, 65535, None], pa.uint16()),
        "f32": pa.array([1.5, None, 2.0, 0.0], pa.float32()),
        "s": pa.array(["alpha", "beta", None, "alpha"]),
        "bin": pa.array([b"\x00\x01", None, b"", b"zz"], pa.binary()),
        "ts": pa.array([1, 2, None, 4], pa.timestamp("us")),
        "d32": pa.array([10, None, 12, 13], pa.date32()),
        "fsb": pa.array([b"abcd", None, b"wxyz", b"0000"], pa.binary(4)),
        "list": pa.array([[1, 2], None, [], [3, None]], pa.list_(pa.int64())),
        "struct": pa.array([{"p": 1, "q": "x"}, None, {"p": None, "q": "z"},
                            {"p": 4, "q": None}],
                           pa.struct([("p", pa.int32()), ("q", pa.string())])),
    })


def _long_table():
    """Enough rows for several row groups and pages."""
    rng = np.random.default_rng(7)
    n = 5000
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.standard_normal(n)),
        "s": pa.array([f"w{int(i)}" for i in rng.integers(0, 300, n)]),
        "t": pa.array(["x" * int(i) for i in rng.integers(0, 90, n)]),
        "d": pa.array([f"d{int(i)}" for i in rng.integers(0, 5, n)])
        .dictionary_encode(),
    })


def _views_table():
    return pa.table({
        "lv": pa.array([[1], None, [2, 3]], pa.list_view(pa.int64())),
        "sv": pa.array(["a", None, "a long string over twelve"],
                       pa.string_view()),
        "f16": pa.array(np.array([1.0, 2.0, -3.0], np.float16)),
        "date64": pa.array([0, 86_400_000, None], pa.date64()),
        "ts_s": pa.array([1, None, 3], pa.timestamp("s")),
    })


TABLES = {"flat": _flat_table, "nested": _nested_table, "deep": _deep_table,
          "typed": _typed_table, "long": _long_table, "views": _views_table}

OPTS = {
    "default": {},
    "none": dict(compression="none"),
    "gzip": dict(compression="gzip"),
    "zstd": dict(compression="zstd"),
    "v2": dict(data_page_version="2.0"),
    "v2 zstd no dict": dict(data_page_version="2.0", compression="zstd",
                            dictionary_enabled=False),
    "page index": dict(write_page_index=True, data_page_size=256,
                       row_group_size=1500),
    "checksums": dict(write_page_checksum=True, write_page_index=True),
    "no stats": dict(write_statistics=False),
    "dict limit": dict(dictionary_page_size_limit=64),
    "no schema": dict(store_schema=False,
                      key_value_metadata={"origin": "test", "k": "v"}),
}


def _props(mod, kw):
    return mod.WriterProperties(**kw)


def _both(tab, **kw):
    """(the port's bytes, the reference's bytes, the tables written)."""
    if kw.get("compression") == "zstd":
        pytest.importorskip("zstandard")
    ref, port = ref_and_port(tab)
    a, b = io.BytesIO(), io.BytesIO()
    pio.write_parquet(a, port, _props(pio, kw))
    rio.write_parquet(b, ref, _props(rio, kw))
    return a.getvalue(), b.getvalue(), ref, port


# tables pyarrow reads back equal to the source from the reference's
# writer (date64 and timestamp[s] go out as plain INT64, as the
# reference's schema/mod.rs:523,551 say, and come back as integers)
PYARROW_EXACT = {"flat", "nested", "deep", "long"}


def _check_reads(got: bytes, want: bytes, tab, exact: bool = True):
    """The port reads its file as the reference reads its own; pyarrow
    reads both alike, and (`exact`) equal to the source."""
    assert_tables_layouts_equal(pnat.ParquetFile(got, "cpu").read(),
                                rnat.ParquetFile(want).read())
    try:
        theirs = pq.read_table(io.BytesIO(got))
    except OSError as e:
        # pyarrow cannot read DELTA_BYTE_ARRAY pages into the dictionary
        # the ARROW:schema names ("Not yet implemented"): nor the
        # reference's file
        assert "Not yet implemented" in str(e)
        with pytest.raises(OSError):
            pq.read_table(io.BytesIO(want))
        return
    assert theirs.to_pydict() == pq.read_table(io.BytesIO(want)).to_pydict()
    if exact:
        assert theirs.to_pydict() == tab.to_pydict()


# "typed" holds a dictionary of integers, which the reference cannot
# write with the dictionary off (C22, its own test below)
CASES = [(t, o) for t in sorted(TABLES) for o in sorted(OPTS)
         if not (o == "page index" and t not in ("long", "flat"))
         and (t, o) != ("typed", "v2 zstd no dict")]


@pytest.mark.parametrize("table,opts", CASES,
                         ids=[f"{t}-{o}" for t, o in CASES])
def test_write_like_the_reference(table, opts):
    tab = TABLES[table]()
    got, want, _, _ = _both(tab, **OPTS[opts])
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab, table in PYARROW_EXACT)


@pytest.mark.parametrize("which", ["sorting", "bloom", "columns"])
def test_write_column_options(which):
    tab = _long_table()
    kw = {"sorting": dict(sorting_columns=(("k", False), ("v", True, False))),
          "bloom": dict(bloom_filter_columns=("k", "s", "f")),
          "columns": dict(column_properties={
              "s": {"compression": "gzip", "dictionary_enabled": False},
              "f": {"write_statistics": False, "encoding": "byte_stream_split"},
              "k": {"encoding": "delta_binary_packed"},
              "t": {"encoding": "delta_length_byte_array"}})}[which]
    got, want, _, _ = _both(tab, **kw)
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)
    if which == "bloom":
        pf, rf = pnat.ParquetFile(got, "cpu"), rnat.ParquetFile(want)
        for col, v in (("k", 17), ("s", "w5"), ("s", "absent")):
            assert pf.prune_row_groups(col, v) == rf.prune_row_groups(col, v)


ENCODINGS = [("plain", "i"), ("plain", "s"), ("rle", "b"),
             ("delta_binary_packed", "i"), ("delta_binary_packed", "u"),
             ("delta_byte_array", "s"), ("delta_length_byte_array", "s"),
             ("byte_stream_split", "f"), ("byte_stream_split", "i")]


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("enc,col", ENCODINGS,
                         ids=[f"{e}-{c}" for e, c in ENCODINGS])
def test_forced_encodings(enc, col, version):
    rng = np.random.default_rng(2)
    n = 900
    tab = pa.table({
        "i": pa.array(np.sort(rng.integers(-2 ** 40, 2 ** 40, n)),
                      mask=rng.random(n) < 0.05),
        "u": pa.array(rng.integers(0, 2 ** 31, n).astype(np.uint32)),
        "s": pa.array([f"prefix/{i // 9:05d}/{'z' * (i % 4)}"
                       for i in range(n)]),
        "b": pa.array(rng.random(n) < 0.3),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
    }).select([col])
    got, want, _, _ = _both(tab, data_page_version=version,
                            data_page_size=700, encoding=enc)
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)


def test_streaming_writer_and_async_writer():
    tab = _long_table()
    ref, port = ref_and_port(tab)
    props = dict(row_group_size=700, write_page_index=True)
    a, b = io.BytesIO(), io.BytesIO()
    pw = pio.ParquetWriter(a, port, pio.WriterProperties(**props))
    rw = rio.ParquetWriter(b, ref, rio.WriterProperties(**props))
    for start in (0, 1000, 3000):
        pw.write(port.slice(start, 1000 if start < 3000 else 2000))
        rw.write(ref.slice(start, 1000 if start < 3000 else 2000))
    pw.close()
    rw.close()
    assert_parquet_like_reference(a.getvalue(), b.getvalue())
    ps, rs = pasync.MemorySink(), rasync.MemorySink()
    pw = pasync.AsyncParquetWriter(ps, port, pio.WriterProperties(**props),
                                   buffer_size=4096)
    rw = rasync.AsyncParquetWriter(rs, ref, rio.WriterProperties(**props),
                                   buffer_size=4096)
    for w, t in ((pw, port), (rw, ref)):
        w.write(t.slice(0, 2500))
        w.write(t.slice(2500, 2500))
        w.close()
    assert ps.completed and rs.completed
    assert_parquet_like_reference(ps.getvalue(), rs.getvalue())
    assert len(ps.parts) == len(rs.parts)


def test_reference_writes_a_null_fixed_size_list_pyarrow_cannot_read():
    """C20: the reference's writer stores a fixed-size list as a LIST
    group and a null row as an empty list (the ARROW:schema hint restores
    the type); pyarrow refuses the file ("Expected all lists to be of
    size=2").  The port writes the same bytes, and both packages read
    the file back equal to the source."""
    tab = pa.table({"fsl": pa.array([[1, 2], None, [3, 4]],
                                    pa.list_(pa.int32(), 2))})
    got, want, ref, _ = _both(tab)
    assert_parquet_like_reference(got, want)
    with pytest.raises(pa.ArrowInvalid):
        pq.read_table(io.BytesIO(want))
    back = pnat.ParquetFile(got, "cpu").read()
    assert_tables_layouts_equal(back, rnat.ParquetFile(want).read())
    assert back.column("fsl").to_pylist() == tab["fsl"].to_pylist()


def test_reference_delta_of_uint32_past_int32_pyarrow_cannot_read():
    """C21: the reference's DELTA_BINARY_PACKED of a uint32 column takes
    the deltas of the int32 bits in 64-bit arithmetic
    (parquet_writer.py:1086-1093), so values on both sides of 2^31 make
    miniblocks 33 bits wide, which pyarrow refuses for INT32.  The port
    writes the same bytes; both packages read them back."""
    tab = pa.table({"u": pa.array([0, 2 ** 32 - 1, 5, 2 ** 31] * 40,
                                  pa.uint32())})
    got, want, _, _ = _both(tab, encoding="delta_binary_packed")
    assert_parquet_like_reference(got, want)
    with pytest.raises(OSError):
        pq.read_table(io.BytesIO(want))
    back = pnat.ParquetFile(got, "cpu").read()
    assert_tables_layouts_equal(back, rnat.ParquetFile(want).read())
    assert back.column("u").to_pylist() == tab["u"].to_pylist()


def test_reference_cannot_write_a_numeric_dictionary_plain():
    """C22: with the dictionary off (or an encoding forced) the reference
    decodes a dictionary column first, and its dictionary_decode takes
    string values only (ops/strings.py:81-87: AssertionError).  The port
    decodes any dictionary and writes the values plain."""
    tab = pa.table({"d": pa.array([3, 1, None, 3]).dictionary_encode()})
    ref, port = ref_and_port(tab)
    with pytest.raises(AssertionError):
        rio.write_parquet(io.BytesIO(), ref,
                          rio.WriterProperties(dictionary_enabled=False))
    buf = io.BytesIO()
    pio.write_parquet(buf, port, pio.WriterProperties(
        dictionary_enabled=False))
    assert pq.read_table(io.BytesIO(buf.getvalue())).to_pydict() == \
        tab.to_pydict()


def test_file_sink(tmp_path):
    _, port = ref_and_port(_flat_table())
    path = str(tmp_path / "f.parquet")
    w = pasync.AsyncParquetWriter(pasync.FileSink(path), port)
    w.write(port)
    w.close()
    assert pq.read_table(path).to_pydict() == _flat_table().to_pydict()


def test_write_to_a_path(tmp_path):
    tab = _nested_table()
    ref, port = ref_and_port(tab)
    pio.write_parquet(str(tmp_path / "p.parquet"), port)
    rio.write_parquet(str(tmp_path / "r.parquet"), ref)
    assert_parquet_like_reference((tmp_path / "p.parquet").read_bytes(),
                                  (tmp_path / "r.parquet").read_bytes())
    got = pio.read_parquet(str(tmp_path / "p.parquet"), device="cpu")
    assert_tables_layouts_equal(got, rio.read_parquet(
        str(tmp_path / "r.parquet")))


@pytest.mark.parametrize("kind", ["union", "ree", "mdn"])
def test_unwritable_layouts_same_error(kind):
    arr = {"union": pa.UnionArray.from_sparse(
        pa.array([0, 1], pa.int8()), [pa.array([1, 2]), pa.array(["a", "b"])]),
        "ree": pa.RunEndEncodedArray.from_arrays(pa.array([2], pa.int32()),
                                                 pa.array([7])),
        "mdn": pa.array([(1, 2, 3), None], pa.month_day_nano_interval())}[kind]
    ref, port = ref_and_port(pa.table({"c": arr}))
    with pytest.raises(Exception) as got:
        pio.write_parquet(io.BytesIO(), port)
    with pytest.raises(Exception) as want:
        rio.write_parquet(io.BytesIO(), ref)
    assert type(got.value).__name__ == type(want.value).__name__


def test_the_writer_copies_a_row_group_to_the_host_once(monkeypatch):
    """`to_host` runs once per row group; nothing else moves a tensor."""
    from arrow_tpu_torch.io import parquet_writer as pw
    calls = []
    real = pw.to_host
    monkeypatch.setattr(pw, "to_host", lambda t: calls.append(t.num_rows)
                        or real(t))
    _, port = ref_and_port(_long_table())
    pio.write_parquet(io.BytesIO(), port,
                      pio.WriterProperties(row_group_size=2000))
    assert calls == [2000, 2000, 1000]


def test_a_card_table_writes_the_cpu_bytes(cuda_device):
    """The same table on the card writes the bytes it writes from the
    CPU."""
    _, port = ref_and_port(_long_table())
    _, card = ref_and_port(_long_table(), cuda_device)
    a, b = io.BytesIO(), io.BytesIO()
    pio.write_parquet(a, port, pio.WriterProperties(write_page_index=True))
    pio.write_parquet(b, card, pio.WriterProperties(write_page_index=True))
    assert a.getvalue() == b.getvalue()
    got = pio.read_parquet(a.getvalue(), device=cuda_device)
    assert got.column("k").device.type == "cuda"
    assert_tables_layouts_equal(got, pio.read_parquet(a.getvalue(),
                                                      device="cpu"))


# ---- modular encryption ----------------------------------------------------

FK = b"0123456789012345"
CK = b"abcdefghabcdefgh"


@pytest.fixture
def fixed_random(monkeypatch):
    """os.urandom made deterministic, so both writers draw the same AAD
    suffix and nonces."""
    state = {"n": 0}

    def urandom(k):
        state["n"] += 1
        return bytes((state["n"] * 31 + i) % 256 for i in range(k))

    def reset():
        state["n"] = 0
    monkeypatch.setattr(os, "urandom", urandom)
    return reset


@pytest.mark.parametrize("mode", ["footer key", "column keys",
                                  "v2 zstd index"])
def test_encryption_both_ways(mode, fixed_random):
    pytest.importorskip("cryptography")
    from arrow_tpu.io import parquet_crypto as rc
    from arrow_tpu_torch.io import parquet_crypto as pc
    tab = _long_table()
    ref, port = ref_and_port(tab)
    kw = {"footer key": {}, "column keys": {},
          "v2 zstd index": dict(data_page_version="2.0", compression="zstd",
                                write_page_index=True,
                                data_page_size=512)}[mode]
    files = []
    for mod, crypto, t in ((pio, pc, port), (rio, rc, ref)):
        enc = crypto.FileEncryptionProperties(
            footer_key=FK, column_keys={"s": CK} if mode == "column keys"
            else {})
        fixed_random()
        buf = io.BytesIO()
        mod.write_parquet(buf, t, mod.WriterProperties(encryption=enc, **kw))
        files.append(buf.getvalue())
    got, want = files
    assert got[:4] == want[:4] == b"PARE"
    cut = len(want) - 8 - int.from_bytes(want[-8:-4], "little")
    assert got[:cut] == want[:cut]           # every page, byte for byte
    keys = dict(footer_key=FK, column_keys={"s": CK}
                if mode == "column keys" else {})
    pt = pnat.ParquetFile(want, "cpu", decryption=pc.FileDecryptionProperties(
        **keys)).read()
    rt = rnat.ParquetFile(got, decryption=rc.FileDecryptionProperties(
        **keys)).read()
    assert_tables_layouts_equal(pt, rt)
    assert pt.to_pydict() == at.Table.from_pyarrow(tab).to_pydict()
    with pytest.raises(Exception) as e1:
        pnat.ParquetFile(got, "cpu").read()
    with pytest.raises(Exception) as e2:
        rnat.ParquetFile(want).read()
    assert type(e1.value).__name__ == type(e2.value).__name__


# ---- the round-5 regressions -----------------------------------------------

EMPTY_INNER = [[None, []], [None, None], [[]], [[], None, []]]


@pytest.mark.parametrize("vals", EMPTY_INNER, ids=range(len(EMPTY_INNER)))
def test_write_nested_list_empty_inner(vals):
    """fb4e5e1: nested lists whose inner list column has no rows."""
    tab = pa.table({"c": pa.array(vals, pa.list_(pa.list_(pa.int64())))})
    got, want, _, _ = _both(tab)
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)


def test_write_struct_of_list_of_list_empty_middles():
    ty = pa.struct([("x", pa.list_(pa.list_(pa.string())))])
    tab = pa.table({"s": pa.array([{"x": []}, {"x": None}], ty)})
    got, want, _, _ = _both(tab)
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)


def _writable(port) -> bool:
    return pio._native_writable(port.schema)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_parquet_nested_write_read(seed):
    rng = np.random.default_rng(seed + 100)
    n = int(rng.integers(1, 120))
    cols = {}
    for i in range(int(rng.integers(1, 5))):
        ty = _random_dtype(rng)
        vals = [_random_value(rng, ty) for _ in range(n)]
        try:
            cols[f"c{i}"] = pa.array(vals, ty)
        except pa.lib.ArrowInvalid:
            continue
    if not cols:
        return
    tab = pa.table(cols)
    ref, port = ref_and_port(tab)
    assert _writable(port) == rio._native_writable(ref.schema)
    if not _writable(port):
        return
    got, want, _, _ = _both(tab, data_page_version=["1.0", "2.0"][seed % 2],
                            compression=["snappy", "none", "zstd"][seed % 3])
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)


@pytest.mark.parametrize("seed", range(50))
def test_fuzz_parquet_encoding_matrix(seed):
    rng = np.random.default_rng(seed + 7000)
    n = int(rng.integers(1, 3000))
    kind = ["i32", "i64", "u32", "u64", "f32", "f64", "str"][seed % 7]
    nullable = bool(rng.integers(0, 2))
    if kind == "str":
        vals = ["" if rng.random() < 0.1 else
                "p%05d/%s" % (rng.integers(0, n // 2 + 1),
                              "s" * int(rng.integers(0, 9)))
                for _ in range(n)]
        enc = ["plain", "delta_length_byte_array",
               "delta_byte_array"][seed % 3]
    elif kind in ("f32", "f64"):
        vals = rng.random(n).astype(np.float32 if kind == "f32"
                                    else np.float64)
        enc = ["plain", "byte_stream_split"][seed % 2]
    else:
        npdt = {"i32": np.int32, "i64": np.int64,
                "u32": np.uint32, "u64": np.uint64}[kind]
        lo, hi = (0, 2**31) if kind.startswith("u") else (-2**30, 2**30)
        vals = rng.integers(lo, hi, n).astype(npdt)
        if bool(rng.integers(0, 2)):
            vals = np.sort(vals)
        enc = ["plain", "delta_binary_packed",
               "byte_stream_split"][seed % 3]
        if enc == "byte_stream_split" and kind in ("u32", "u64"):
            enc = "plain"
    pavals = list(vals.tolist() if hasattr(vals, "tolist") else vals)
    if nullable:
        pavals = [None if rng.random() < 0.15 else v for v in pavals]
    patype = {"i32": pa.int32(), "i64": pa.int64(), "u32": pa.uint32(),
              "u64": pa.uint64(), "f32": pa.float32(),
              "f64": pa.float64(), "str": pa.string()}[kind]
    tab = pa.table({"c": pa.array(pavals, patype)})
    got, want, _, _ = _both(
        tab, data_page_version=["1.0", "2.0"][seed % 2],
        compression=["none", "snappy", "zstd"][seed % 3],
        data_page_size=int(rng.integers(512, 64_000)),
        column_properties={"c": {"encoding": enc}})
    assert_parquet_like_reference(got, want)
    _check_reads(got, want, tab)


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_empty_heavy_nested(seed):
    from arrow_tpu.io import ipc as ripc
    from arrow_tpu_torch.io import ipc as pipc
    rng = np.random.default_rng(seed + 77000)
    ty = _empty_heavy_type(rng)
    n = int(rng.integers(0, 8))
    bias = [0.5, 0.8, 0.95][seed % 3]
    tab = pa.table({"c": pa.array([_empty_heavy_val(rng, ty, bias)
                                   for _ in range(n)], ty)})
    ref, port = ref_and_port(tab)
    if _writable(port):
        got, want, _, _ = _both(tab)
        assert_parquet_like_reference(got, want)
        _check_reads(got, want, tab)
    a, b = io.BytesIO(), io.BytesIO()
    pipc.write_stream(a, port)
    ripc.write_stream(b, ref)
    assert a.getvalue() == b.getvalue()
    assert_tables_layouts_equal(pipc.read_stream(a.getvalue(), "cpu")[0],
                                ripc.read_stream(b.getvalue())[0])
    assert pa.table(port).to_pydict() == tab.to_pydict()


def test_concurrent_writers_under_a_short_switch_interval():
    """Twelve writers at once, each encoding its column chunks on a pool,
    with the interpreter switching threads every 10 us: each file equals
    the one written alone (no chunk lands in another's buffer)."""
    import sys
    import threading
    tabs = [ref_and_port(_long_table().slice(0, 300 + 97 * i))[1]
            for i in range(12)]
    props = dict(row_group_size=200, write_page_index=True)

    def write(t):
        buf = io.BytesIO()
        pio.write_parquet(buf, t, pio.WriterProperties(**props))
        return buf.getvalue()
    alone = [write(t) for t in tabs]
    got = [None] * len(tabs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, write(tabs[i]))) for i in range(len(tabs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert got == alone
