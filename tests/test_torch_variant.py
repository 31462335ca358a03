"""Parity of the port's Variant type (arrow_tpu_torch/io/variant.py) with
the JAX package's (arrow_tpu/io/variant.py), mirroring
tests/test_variant.py: the same values encode to the same bytes, the
path walks and typed extractions give equal columns (bit for bit), the
shredded struct and the Parquet file are the reference's."""

import datetime
import io
from decimal import Decimal

import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import variant as rv
from arrow_tpu_torch.io import variant as pv
from torch_port_util import (assert_columns_equal, assert_layouts_equal,
                             cuda_device, port_column)  # noqa: F401

CPU = "cpu"

VALUES = [None, True, False, 0, -1, 127, 128, -32769, 2**40, -2**62, 3.5,
          "", "hi", "x" * 100, b"\x00\xff", Decimal("12.345"),
          list(range(500)), {"b": 1, "a": [2, {"c": None}]},
          datetime.date(2021, 3, 4),
          datetime.datetime(2021, 3, 4, 5, 6, 7, 250,
                            tzinfo=datetime.timezone.utc),
          datetime.datetime(2021, 3, 4, 5, 6, 7, 250)]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_encoding_matches_reference(i):
    v = VALUES[i]
    m, b = pv.VariantBuilder().build(v)
    assert (m, b) == rv.VariantBuilder().build(v)
    assert pv.parse_variant(m, b) == v
    assert pv.variant_to_json(m, b) == rv.variant_to_json(m, b)


def test_json_bridge_matches_reference():
    s = '{"a": [1, 2.5, "x", null, true], "b": {"c": -7}}'
    assert pv.json_to_variant(s) == rv.json_to_variant(s)


def _mixed_objs(mod):
    null = mod._NULL_SLOT
    return [{"a": 1, "b": "x"}, 42, "hello", "a" * 100, 3.5, True, None,
            [1, 2, {"c": None}], -2 ** 40, {"k": [False]}, {"a": -5},
            {"a": 2 ** 33}, {"a": 300}, {"a": "s"}, {"a": None}, {"a": [7]},
            {"a": {"z": 1}}, null, {"a": 1.5}, {"a": "y" * 80},
            {"a": False}, {"u": {"tags": ["a", "b"]}}]


def _cols():
    return (rv.VariantColumn.from_pylist(_mixed_objs(rv)),
            pv.VariantColumn.from_pylist(_mixed_objs(pv)))


PATHS = [["a"], ["u", "tags", 1], ["a", "z"], [], ["k", 0], [7]]


@pytest.mark.parametrize("path", PATHS, ids=str)
def test_path_walk_matches_reference(path):
    r, p = _cols()
    assert p.metadata == r.metadata and p.values == r.values
    got, want = pv.variant_get_column(p, path), rv.variant_get_column(r, path)
    assert (got.metadata, got.values) == (want.metadata, want.values)
    assert pv.variant_get(p, path) == rv.variant_get(r, path)


@pytest.mark.parametrize("as_type", ["int64", "float64", "bool_", "utf8"])
@pytest.mark.parametrize("path", [["a"], []], ids=str)
def test_typed_extraction_matches_reference(as_type, path):
    r, p = _cols()
    want = rv.variant_get_typed(r, path, getattr(at.dtypes, as_type))
    got = pv.variant_get_typed(p, path, getattr(att.dtypes, as_type),
                               device=CPU)
    assert_columns_equal(got, port_column(want), as_type, masks=True)


@pytest.mark.parametrize("shred", [None, "int64", "float64", "bool_",
                                   "utf8"])
def test_shredded_struct_matches_reference(shred):
    r, p = _cols()
    want = rv.variant_to_struct(r, shred and getattr(at.dtypes, shred))
    got = pv.variant_to_struct(p, shred and getattr(att.dtypes, shred),
                               device=CPU)
    assert_layouts_equal(got, port_column(want))
    assert pv.variant_from_struct(got).to_pylist() == p.to_pylist()


def test_struct_column_roundtrip_matches_reference():
    r, p = _cols()
    want = r.to_struct_column()
    got = p.to_struct_column(device=CPU)
    assert_layouts_equal(got, port_column(want))
    back = pv.VariantColumn.from_struct_column(got)
    assert back.to_pylist() == p.to_pylist()


@pytest.mark.parametrize("shred", [None, "int64", "utf8"])
def test_parquet_file_matches_reference(shred):
    r, p = _cols()
    rb, pb = io.BytesIO(), io.BytesIO()
    rv.write_variant_parquet(rb, r, shred_type=shred
                             and getattr(at.dtypes, shred))
    pv.write_variant_parquet(pb, p, shred_type=shred
                             and getattr(att.dtypes, shred))
    from torch_port_util import assert_parquet_like_reference
    assert_parquet_like_reference(pb.getvalue(), rb.getvalue())
    pb.seek(0)
    assert pv.read_variant_parquet(pb).to_pylist() == p.to_pylist()
    assert rv.read_variant_parquet(io.BytesIO(pb.getvalue())).to_pylist() \
        == r.to_pylist()


@pytest.mark.parametrize("value", [b"\x02\x05", b"\x02\x01\x00\x09",
                                   b"\x03\x03\x00", b"\x3c\x01"])
def test_corrupt_values_have_the_same_outcome(value):
    """Both raise an error of one name, or both walk to the same leaf."""
    r = rv.VariantColumn([b"\x01\x00\x00"], [value])
    p = pv.VariantColumn([b"\x01\x00\x00"], [value])
    try:
        want = rv.variant_get_column(r, ["a"])
    except Exception as e:
        with pytest.raises(Exception) as got:
            pv.variant_get_column(p, ["a"])
        assert type(got.value).__name__ == type(e).__name__
        return
    got = pv.variant_get_column(p, ["a"])
    assert (got.metadata, got.values) == (want.metadata, want.values)


def test_typed_extraction_onto_the_card(cuda_device):  # noqa: F811
    r, p = _cols()
    got = pv.variant_get_typed(p, ["a"], att.dtypes.int64,
                               device=cuda_device)
    assert got.device.type == "cuda"
    assert_columns_equal(got, port_column(
        rv.variant_get_typed(r, ["a"], at.dtypes.int64)))
