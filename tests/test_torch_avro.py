"""Parity of the port's Avro reader and writer (arrow_tpu_torch/io/avro.py)
with the JAX package's (arrow_tpu/io/avro.py), mirroring the Avro tests
of tests/test_io.py.  There is no fastavro here, so Avro is held to the
reference alone: the same container through both readers gives equal
tables (bit for bit), and both writers give the same bytes once the
16-byte sync marker, which `write_avro` draws from os.urandom, is the
same in both (a fixed os.urandom)."""

import decimal
import io
import json
import os
import struct

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import avro as ravro
from arrow_tpu_torch.io import avro as pavro
from test_io import _avro_bytes
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table, ref_and_port)

CPU = "cpu"


def zz(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def s(x) -> bytes:
    b = x.encode() if isinstance(x, str) else x
    return zz(len(b)) + b


FLAT = json.dumps({"type": "record", "name": "r", "fields": [
    {"name": "id", "type": "long"}, {"name": "x", "type": "double"},
    {"name": "s", "type": ["null", "string"]},
    {"name": "ok", "type": "boolean"}]})
FLAT_ROWS = [{"id": 1, "x": 1.5, "s": "a", "ok": True},
             {"id": -2, "x": -0.25, "s": None, "ok": False},
             {"id": 3, "x": 2.0, "s": "ccc", "ok": True}]

NESTED = json.dumps({"type": "record", "name": "r", "fields": [
    {"name": "arr", "type": {"type": "array", "items": "long"}},
    {"name": "m", "type": {"type": "map", "values": "long"}},
    {"name": "rec", "type": {"type": "record", "name": "in", "fields": [
        {"name": "u", "type": "long"}, {"name": "s", "type": "string"}]}},
    {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 4}}]})
NESTED_ROW = (zz(2) + zz(10) + zz(20) + zz(0) + zz(1) + s("k") + zz(7)
              + zz(0) + zz(5) + s("hi") + b"ABCD")

LOGICAL = json.dumps({"type": "record", "name": "r", "fields": [
    {"name": "dec", "type": {"type": "bytes", "logicalType": "decimal",
                             "precision": 10, "scale": 2}},
    {"name": "dur", "type": {"type": "fixed", "name": "dur12", "size": 12,
                             "logicalType": "duration"}},
    {"name": "lts", "type": {"type": "long",
                             "logicalType": "local-timestamp-micros"}},
    {"name": "d", "type": {"type": "int", "logicalType": "date"}}]})


def _dec(unscaled: int) -> bytes:
    b = unscaled.to_bytes(max(1, (unscaled.bit_length() + 8) // 8), "big",
                          signed=True)
    return zz(len(b)) + b


LOGICAL_ROWS = [_dec(12345) + struct.pack("<III", 1, 2, 3000)
                + zz(1_000_000) + zz(19000),
                _dec(-100) + struct.pack("<III", 0, 10, 0) + zz(-5) + zz(-3)]

UNION = json.dumps({"type": "record", "name": "r", "fields": [
    {"name": "u", "type": ["null", "long", "string"]}]})
UNION_ROWS = [zz(1) + zz(5), zz(0), zz(2) + s("x")]

ENUM = json.dumps({"type": "record", "name": "r", "fields": [
    {"name": "e", "type": {"type": "enum", "name": "c",
                           "symbols": ["A", "B", "C"]}}]})
ENUM_ROWS = [zz(2), zz(0), zz(2)]

CONTAINERS = {
    "flat": lambda: _avro_bytes(FLAT_ROWS, FLAT),
    "flat_deflate": lambda: _avro_bytes(FLAT_ROWS, FLAT, codec=b"deflate"),
    "nested": lambda: _avro_bytes([NESTED_ROW], NESTED),
    "logical": lambda: _avro_bytes(LOGICAL_ROWS, LOGICAL),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_read_matches_reference(name):
    data = CONTAINERS[name]()
    want = ravro.read_avro(data)
    got = pavro.read_avro(data, device=CPU)
    assert_tables_equal(got, port_table(want))


def test_multi_branch_union_raises_in_both():
    data = _avro_bytes(UNION_ROWS, UNION)
    with pytest.raises(at.errors.ArrowNotImplementedError):
        ravro.read_avro(data)
    with pytest.raises(att.errors.ArrowNotImplementedError):
        pavro.read_avro(data, device=CPU)


def test_enum_reads_as_dictionary():
    """An enum takes the columnar path as a dictionary<int32, utf8>.  The
    reference fails there (its `_assemble` names DictionaryColumn
    without importing it: NameError); its per-row path gives the
    values the port's columnar path gives."""
    data = _avro_bytes(ENUM_ROWS, ENUM)
    with pytest.raises(NameError):
        ravro.read_avro(data)
    got = pavro.read_avro(data, device=CPU)
    assert repr(got.column("e").dtype) == "dictionary<int32, utf8>"
    assert got.column("e").to_pylist() == ["C", "A", "C"]
    slow = ravro.read_avro(data, reader_schema=json.loads(ENUM))
    assert got.column("e").to_pylist() == slow.column("e").to_pylist()


def test_schema_resolution_matches_reference():
    writer = json.dumps({"type": "record", "name": "r", "fields": [
        {"name": "a", "type": "int"}, {"name": "drop", "type": "long"}]})
    data = _avro_bytes([zz(5) + zz(100), zz(-3) + zz(200)], writer)
    reader = {"type": "record", "name": "r", "fields": [
        {"name": "a", "type": "double"},
        {"name": "extra", "type": "long", "default": 42}]}
    want = ravro.read_avro(data, reader_schema=reader)
    got = pavro.read_avro(data, reader_schema=reader, device=CPU)
    assert_tables_equal(got, port_table(want))
    assert got.column("extra").to_pylist() == [42, 42]


def test_reader_builder_batches_match_reference():
    data = _avro_bytes(FLAT_ROWS, FLAT)
    want = ravro.ReaderBuilder(batch_size=2).build(data)
    got = pavro.ReaderBuilder(batch_size=2, device=CPU).build(data)
    assert [b.num_rows for b in got] == [b.num_rows for b in want] == [2, 1]
    for g, w in zip(got, want):
        assert_tables_equal(g, port_table(w))


def test_columnar_path_matches_the_per_row_path(monkeypatch):
    """The native columnar decode and the per-row fallback agree in the
    port, and each equals the reference's."""
    rng = np.random.default_rng(11)
    n = 2000
    ints = rng.integers(0, 10**6, n)
    batch = pa.record_batch({
        "i": pa.array([int(x) if x % 7 else None for x in ints]),
        "f": pa.array(rng.random(n), pa.float32()),
        "s": pa.array([f"v{x % 97}" if x % 5 else None for x in ints]),
        "l": pa.array([[int(y) for y in rng.integers(0, 9, x % 4)]
                       if x % 6 else None for x in ints]),
        "st": pa.array([{"a": int(x), "b": f"w{x % 10}"} if x % 3 else None
                        for x in ints],
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "m": pa.array([[(f"k{x % 3}", int(x))] if x % 4 else None
                       for x in ints], pa.map_(pa.string(), pa.int64())),
    })
    ref, _ = ref_and_port(batch)
    buf = io.BytesIO()
    ravro.write_avro(buf, ref, codec="deflate")
    data = buf.getvalue()
    want = port_table(ravro.read_avro(data))
    fast = pavro.read_avro(data, device=CPU)
    monkeypatch.setattr(pavro, "_read_columnar", lambda *a, **k: None)
    slow = pavro.read_avro(data, device=CPU)
    assert_tables_equal(fast, want)
    assert fast.to_pydict() == slow.to_pydict()


@pytest.fixture
def fixed_sync(monkeypatch):
    """The same 16-byte sync marker in both writers."""
    monkeypatch.setattr(os, "urandom", lambda k: bytes(range(k)))


def _writer_batch(n: int, seed: int) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    return pa.record_batch({
        "i": pa.array(rng.integers(-10**12, 10**12, n), mask=null),
        "i32": pa.array(rng.integers(-99, 99, n).astype(np.int32)),
        "f": pa.array(rng.standard_normal(n), mask=null),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "s": pa.array([f"w{k}" for k in rng.integers(0, 40, n)], mask=null),
        "b": pa.array([bytes([k % 256]) for k in range(n)]),
        "ok": pa.array(rng.random(n) < 0.5, mask=null),
        "lst": pa.array([list(range(k % 3)) for k in range(n)]),
        "st": pa.array([{"p": k, "q": f"u{k}"} for k in range(n)]),
        "m": pa.array([[("k", k)] for k in range(n)],
                      pa.map_(pa.string(), pa.int64())),
        "d32": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                        pa.date32()),
        "ts": pa.array(rng.integers(-10**15, 10**15, n),
                       pa.timestamp("us")),
        "tsn": pa.array(rng.integers(-10**18, 10**18, n),
                        pa.timestamp("ns")),
        "mdn": pa.array([(1, 2, 3_000_000)] * n,
                        pa.month_day_nano_interval()),
        "dec": pa.array([decimal.Decimal(int(k)).scaleb(-2)
                         for k in rng.integers(-10**6, 10**6, n)],
                        pa.decimal128(10, 2)),
    })


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy", "zstandard",
                                   "bzip2", "xz"])
def test_write_matches_reference_bytes(codec, fixed_sync):
    ref, port = ref_and_port(_writer_batch(300, 1))
    want, got = io.BytesIO(), io.BytesIO()
    ravro.write_avro(want, ref, codec=codec, block_rows=128)
    pavro.write_avro(got, port, codec=codec, block_rows=128)
    assert got.getvalue() == want.getvalue()
    back = pavro.read_avro(got.getvalue(), device=CPU)
    assert_tables_equal(back, port_table(ravro.read_avro(want.getvalue())))


def test_write_masked_marker_matches_reference():
    """With os.urandom as it is, the files differ only in the marker."""
    ref, port = ref_and_port(_writer_batch(50, 2))
    want, got = io.BytesIO(), io.BytesIO()
    ravro.write_avro(want, ref, codec="null")
    pavro.write_avro(got, port, codec="null")
    a, b = bytearray(want.getvalue()), bytearray(got.getvalue())
    sync_a, sync_b = bytes(a[-16:]), bytes(b[-16:])
    assert len(a) == len(b)
    assert bytes(a).replace(sync_a, b"\0" * 16) == \
        bytes(b).replace(sync_b, b"\0" * 16)


def test_written_table_reads_back_as_the_source(fixed_sync):
    _, port = ref_and_port(_writer_batch(200, 3))
    buf = io.BytesIO()
    pavro.write_avro(buf, port, codec="deflate")
    back = pavro.read_avro(buf.getvalue(), device=CPU)
    for name in port.column_names:
        a, b = port.column(name).to_pylist(), back.column(name).to_pylist()
        if name == "m":
            a = [None if x is None else list(x) for x in a]
            b = [None if x is None else list(x) for x in b]
        assert a == b, name


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_containers_have_the_same_outcome(seed):
    """Flipped bytes: both raise an error of one name, or both read equal
    tables."""
    data = bytearray(_avro_bytes(FLAT_ROWS * 20, FLAT))
    rng = np.random.default_rng(seed)
    for _ in range(3):
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
    data = bytes(data)
    try:
        want = ravro.read_avro(data)
    except Exception as e:
        with pytest.raises(Exception) as got:
            pavro.read_avro(data, device=CPU)
        assert type(got.value).__name__ == type(e).__name__
        return
    assert_tables_equal(pavro.read_avro(data, device=CPU), port_table(want))


def test_truncated_raises_arrow_invalid():
    data = _avro_bytes(FLAT_ROWS, FLAT)
    with pytest.raises(att.errors.ArrowError):
        pavro.read_avro(data[:len(data) // 3], device=CPU)
    with pytest.raises(at.errors.ArrowError):
        ravro.read_avro(data[:len(data) // 3])


def test_device_is_required():
    with pytest.raises(TypeError):
        pavro.read_avro(_avro_bytes(FLAT_ROWS, FLAT))


def test_read_onto_the_card(cuda_device):  # noqa: F811
    data = _avro_bytes([NESTED_ROW], NESTED)
    got = pavro.read_avro(data, device=cuda_device)
    assert got.column("arr").device.type == "cuda"
    assert_tables_equal(got, port_table(ravro.read_avro(data)))
