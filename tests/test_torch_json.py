"""Parity of the port's JSON reader and writer (arrow_tpu_torch/io/
json_io.py) with the JAX package's (arrow_tpu/io/json_io.py), mirroring
tests/test_json_native.py: the same text through both readers gives
equal tables (bit for bit), both writers give the same bytes, and
pyarrow.json reads the port's lines back as the source."""

import decimal
import io
import json

import numpy as np
import pyarrow as pa
import pyarrow.json as pajson
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import json_io as rjson
from arrow_tpu_torch.io import json_io as pjson
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table, ref_and_port)

CPU = "cpu"

READS = {
    "scalars_and_nulls": ('{"i": 1, "f": 1.5, "b": true, "s": "hey"}\n'
                          '{"i": null, "f": 2e3, "b": false, '
                          '"s": "a\\"b\\u00e9"}\n'
                          '{"f": -0.25, "b": null, "s": null}\n'),
    "nested_struct_and_list": ('{"o": {"a": 1, "b": "x"}, "l": [1, 2, 3]}\n'
                               '{"o": null, "l": []}\n'
                               '{"o": {"a": null, "b": "z"}, "l": null}\n'
                               '{"o": {"b": "w"}, "l": [7]}\n'),
    "list_of_struct": '{"ls": [{"v": 1}, {"v": 2}]}\n{"ls": []}\n',
    "array_form": '[{"a": 1}, {"a": 2, "b": "x"}]',
    "mixed_scalars_as_text": '{"m": 1}\n{"m": "x"}\n{"m": true}\n',
    "all_null_column": '{"a": null}\n{"a": null}\n',
    "empty_object_struct": '{"o": {}}\n{"o": {}}\n',
    "int_then_float": '{"n": 1}\n{"n": 2.5}\n',
    "escapes": '{"s": "tab\\tnl\\n\\\\ \\u00e9\\ud83d\\ude00"}\n',
    "timestamps_stay_text": ('{"ts": "2021-01-01T00:00:01"}\n'
                             '{"ts": "2022-06-15 12:30:00.250"}\n'),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_read_matches_reference(name):
    src = READS[name]
    want = rjson.read_json(src)
    got = pjson.read_json(src, device=CPU)
    assert_tables_equal(got, port_table(want))


SCHEMAS = {
    "timestamp": (READS["timestamps_stay_text"], [("ts", "timestamp_us")]),
    "float32_array": ('[{"a": 1}, {"a": 2}]', [("a", "float32")]),
    "schema_drives_output": ('{"b": 1, "x": 9}\n{"b": 2}\n',
                             [("a", "int32"), ("b", "int64")]),
}


def _dtype(mod, name):
    if name == "timestamp_us":
        return mod.dtypes.timestamp("us")
    return getattr(mod.dtypes, name)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_read_with_schema_matches_reference(name):
    src, fields = SCHEMAS[name]
    want = rjson.read_json(src, schema=at.Schema(tuple(
        at.Field(n, _dtype(at, d)) for n, d in fields)))
    got = pjson.read_json(src, schema=att.dtypes.Schema(tuple(
        att.dtypes.Field(n, _dtype(att, d)) for n, d in fields)), device=CPU)
    assert_tables_equal(got, port_table(want))


def test_matches_pyarrow_inference():
    rows = [{"x": i, "y": f"w{i % 5}", "z": i / 3} for i in range(100)]
    rows[7] = {"x": None, "y": None, "z": None}
    src = "\n".join(json.dumps(r) for r in rows)
    got = pjson.read_json(src, device=CPU)
    ref = pajson.read_json(io.BytesIO(src.encode()))
    for name in ("x", "y", "z"):
        assert got.column(name).to_pylist() == ref[name].to_pylist(), name
    assert_tables_equal(got, port_table(rjson.read_json(src)))


@pytest.mark.parametrize("src", ['{"a": }', '{"a": [1, 2}', '{"a" 1}'])
def test_malformed_input_has_the_same_outcome(src):
    """Both raise an error of one name, or (the tape is lenient about a
    missing colon) both read the same table."""
    try:
        want = rjson.read_json(src)
    except Exception as e:
        with pytest.raises(Exception) as got:
            pjson.read_json(src, device=CPU)
        assert type(got.value).__name__ == type(e).__name__
        return
    assert_tables_equal(pjson.read_json(src, device=CPU), port_table(want))


def test_read_json_objects_matches_reference():
    objs = [{"k": 1}, {"k": 2, "m": "x"}, {"k": None, "l": [1.5]}]
    assert_tables_equal(pjson.read_json_objects(objs, device=CPU),
                        port_table(rjson.read_json_objects(objs)))
    assert pjson.read_json_objects([], device=CPU).num_columns == 0


def test_device_is_required():
    with pytest.raises(TypeError):
        pjson.read_json('{"a": 1}')


def _flat_batch(seed: int, n: int) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.15
    words = np.array(["plain", 'q"uote', "back\\slash", "nl\nx", "é", ""])
    f = rng.standard_normal(n) * 1e4
    f[rng.random(n) < 0.05] = np.nan
    return pa.record_batch({
        "i64": pa.array(rng.integers(-10**15, 10**15, n), mask=null),
        "i16": pa.array(rng.integers(-300, 300, n).astype(np.int16)),
        "u64": pa.array(rng.integers(0, 2**63, n, dtype=np.uint64)),
        "f64": pa.array(f, mask=null),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=null),
        "d": pa.array(rng.integers(0, 30000, n).astype(np.int32),
                      pa.date32()),
        "ts": pa.array(rng.integers(0, 2**50, n), pa.timestamp("ms"),
                       mask=null),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=null),
        "dict": pa.array(words[rng.integers(0, 4, n)]).dictionary_encode(),
    })


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lines_writer_matches_reference_bytes(seed, explicit):
    ref, port = ref_and_port(_flat_batch(seed, 300))
    want = rjson.WriterBuilder("lines", explicit_nulls=explicit).write_str(ref)
    got = pjson.WriterBuilder("lines", explicit_nulls=explicit).write_str(port)
    assert got == want


@pytest.mark.parametrize("fmt", ["lines", "array"])
def test_nested_writer_matches_reference_bytes(fmt):
    """Binary, decimal, temporal, list, map and struct cells take the
    per-row path in both."""
    batch = pa.record_batch({
        "ts": pa.array([1_700_000_000_000_000, None], pa.timestamp("us")),
        "dec": pa.array([decimal.Decimal("1.25"), None],
                        pa.decimal128(5, 2)),
        "b": pa.array([b"\x01\xff", None]),
        "lb": pa.array([[b"\x02"], None], pa.list_(pa.binary())),
        "m": pa.array([[("k", 1)], None], pa.map_(pa.string(), pa.int64())),
        "em": pa.array([[], [("a", 1)]], pa.map_(pa.string(), pa.int64())),
        "st": pa.array([{"a": 1, "b": "x"}, None],
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
    })
    ref, port = ref_and_port(batch)
    want = rjson.WriterBuilder(fmt).write_str(ref)
    got = pjson.WriterBuilder(fmt).write_str(port)
    assert got == want
    if fmt == "lines":
        assert json.loads(got.split("\n")[0])["em"] == {}


def test_pyarrow_reads_the_lines_back():
    rng = np.random.default_rng(3)
    n = 400
    src = pa.record_batch({
        "k": pa.array(rng.integers(-10**9, 10**9, n)),
        "x": pa.array(np.round(rng.random(n) * 1e5, 2)),
        "s": pa.array([f"w{v}" for v in rng.integers(0, 50, n)]),
        "b": pa.array(rng.random(n) < 0.5),
    })
    _, port = ref_and_port(src)
    buf = io.BytesIO()
    pjson.write_json(buf, port)
    back = pajson.read_json(io.BytesIO(buf.getvalue()),
                            parse_options=pajson.ParseOptions(
                                explicit_schema=src.schema))
    assert back.to_pydict() == pa.Table.from_batches([src]).to_pydict()
    again = pjson.read_json(buf.getvalue(), device=CPU)
    assert_tables_equal(again, port_table(rjson.read_json(buf.getvalue())))


def test_writer_roundtrip_matches_reference():
    data = {"a": np.arange(5), "s": ["x", "y", "z", None, "w"]}
    want = rjson.WriterBuilder("lines").write_str(at.Table.from_pydict(data))
    got = pjson.WriterBuilder("lines").write_str(
        att.Table.from_pydict(data, device=CPU))
    assert got == want
    assert_tables_equal(pjson.read_json(got, device=CPU),
                        port_table(rjson.read_json(want)))


def test_bad_format_raises_in_both():
    with pytest.raises(at.errors.ArrowInvalid):
        rjson.WriterBuilder("csv")
    with pytest.raises(att.errors.ArrowInvalid):
        pjson.WriterBuilder("csv")


def test_read_onto_the_card(cuda_device):  # noqa: F811
    src = READS["nested_struct_and_list"]
    got = pjson.read_json(src, device=cuda_device)
    assert got.column("l").device.type == "cuda"
    assert_tables_equal(got, port_table(rjson.read_json(src)))
