"""Parity of the port's row-oriented Parquet record API
(arrow_tpu_torch/io/records.py) with the JAX package's, mirroring
tests/test_records.py: the same file gives the same rows, accessors,
JSON values and errors in both."""

import base64
import decimal

import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import records as rrec
from arrow_tpu.io.parquet_io import write_parquet
from arrow_tpu_torch.io import records as prec
from torch_port_util import cuda_device  # noqa: F401

dt = at.dtypes
CPU = "cpu"


@pytest.fixture
def pq_file(tmp_path):
    t = at.Table.from_pydict({
        "i": at.column([1, None, 3], dt.int32),
        "l": [10, 20, None],
        "f": at.column([0.5, 1.5, None], dt.float32),
        "s": ["a", None, "ccc"],
        "b": at.column([b"\x01", b"\x02\x03", None], dt.binary),
        "ok": [True, False, None],
        "lst": at.column([[1, 2], None, [3]], dt.list_(dt.int64)),
        "st": at.column([{"x": 1}, {"x": 2}, None],
                        dt.struct([dt.Field("x", dt.int64)])),
        "ts": at.column([1, None, 2], dt.timestamp("ms")),
        "d": at.column([18000, 1, None], dt.date32),
    })
    p = str(tmp_path / "r.parquet")
    write_parquet(p, t)
    return p


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.get_column_iter()) == list(w.get_column_iter())
        assert repr(g) == repr(w)
        assert g.to_json_value() == w.to_json_value()


def test_rows_match_reference(pq_file):
    _same_rows(list(prec.RowIter.from_file(pq_file, device=CPU)),
               list(rrec.RowIter.from_file(pq_file)))
    r0 = next(iter(prec.RowIter(pq_file, device=CPU)))
    assert r0.get_int(0) == 1 and r0.get_long(1) == 10
    assert r0.get_string(3) == "a" and r0.get_bytes(4) == b"\x01"
    assert list(r0.get_list(6).elements) == [1, 2]
    assert r0.get_group(7).get_long(0) == 1
    assert r0.to_json_value()["b"] == base64.b64encode(b"\x01").decode()


@pytest.mark.parametrize("getter,col", [("get_string", 0), ("get_int", 3),
                                        ("get_group", 0), ("get_map", 6),
                                        ("get_timestamp_micros", 8),
                                        ("get_decimal", 1)])
def test_wrong_type_access_raises_in_both(pq_file, getter, col):
    w = next(iter(rrec.RowIter(pq_file)))
    g = next(iter(prec.RowIter(pq_file, device=CPU)))
    with pytest.raises(at.errors.ArrowTypeError):
        getattr(w, getter)(col)
    with pytest.raises(att.errors.ArrowTypeError):
        getattr(g, getter)(col)


def test_projection_limit_and_batches_match_reference(pq_file):
    _same_rows(prec.read_records(pq_file, projection=["s", "i"], limit=2,
                                 device=CPU),
               rrec.read_records(pq_file, projection=["s", "i"], limit=2))
    _same_rows(list(prec.RowIter(pq_file, batch_size=1, device=CPU)),
               list(rrec.RowIter(pq_file, batch_size=1)))


def test_map_and_decimal_match_reference(tmp_path):
    t = at.Table.from_pydict({
        "m": at.column([[("k", 1)], [("a", 2), ("b", 3)]],
                       dt.map_(dt.utf8, dt.int64)),
        "d": at.column([decimal.Decimal("1.25"), decimal.Decimal("-3.00")],
                       dt.decimal128(9, 2)),
    })
    p = str(tmp_path / "m.parquet")
    write_parquet(p, t)
    got = list(prec.RowIter(p, device=CPU))
    _same_rows(got, list(rrec.RowIter(p)))
    m = got[1].get_map(0)
    assert m.keys() == ["a", "b"] and m.values() == [2, 3]
    assert got[0].get_decimal(1) == decimal.Decimal("1.25")


def test_device_is_required(pq_file):
    with pytest.raises(TypeError):
        prec.RowIter(pq_file)


def test_rows_through_the_card(pq_file, cuda_device):  # noqa: F811
    _same_rows(list(prec.RowIter(pq_file, device=cuda_device)),
               list(rrec.RowIter(pq_file)))
