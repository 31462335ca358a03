"""Parity of the port's Arrow integration-test JSON
(arrow_tpu_torch/io/integration_json.py) with the JAX package's,
mirroring tests/test_integration_json.py: the same table gives the same
document in both, and the same document reads to equal tables (bit for
bit, every buffer)."""

import json

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import integration_json as rij
from arrow_tpu_torch.io import integration_json as pij
from test_integration_json import rich_table
from torch_port_util import (assert_tables_equal, assert_tables_layouts_equal,
                             cuda_device, port_dtype, port_table)  # noqa: F401

CPU = "cpu"


def test_rich_table_document_matches_reference():
    ref = rich_table()
    want = json.dumps(rij.table_to_json(ref), sort_keys=True)
    got = json.dumps(pij.table_to_json(port_table(ref)), sort_keys=True)
    assert got == want


def test_rich_table_reads_back_as_the_reference():
    doc = json.loads(json.dumps(rij.table_to_json(rich_table())))
    want = rij.table_from_json(doc)
    got = pij.table_from_json(doc, device=CPU)
    assert_tables_layouts_equal(got, port_table(want))
    assert [repr(f.dtype) for f in got.schema.fields] == \
        [repr(port_dtype(f.dtype)) for f in want.schema.fields]


GOLDEN = {"schema": {"fields": [
    {"name": "c1", "type": {"name": "int", "isSigned": True, "bitWidth": 32},
     "nullable": True, "children": []},
    {"name": "c4", "type": {"name": "list"}, "nullable": True,
     "children": [{"name": "custom_item",
                   "type": {"name": "int", "isSigned": True,
                            "bitWidth": 32},
                   "nullable": False, "children": []}]}]},
    "batches": [{"count": 2, "columns": [
        {"name": "c1", "count": 2, "VALIDITY": [1, 0], "DATA": [7, 0]},
        {"name": "c4", "count": 2, "VALIDITY": [1, 1], "OFFSET": [0, 2, 3],
         "children": [{"name": "custom_item", "count": 3,
                       "VALIDITY": [1, 1, 1], "DATA": [1, 2, 3]}]}]}]}

NESTED_DICTS = {
    "schema": {"fields": [
        {"name": "top", "type": {"name": "utf8"}, "nullable": True,
         "children": [],
         "dictionary": {"id": 0, "indexType": {"name": "int", "bitWidth": 32,
                                               "isSigned": True},
                        "isOrdered": False}},
        {"name": "st", "type": {"name": "struct"}, "nullable": True,
         "children": [{"name": "s", "type": {"name": "utf8"},
                       "nullable": True, "children": [],
                       "dictionary": {"id": 1, "indexType": {
                           "name": "int", "bitWidth": 32, "isSigned": True},
                           "isOrdered": False}}]}]},
    "dictionaries": [
        {"id": 0, "data": {"count": 2, "columns": [
            {"name": "DICT0", "count": 2, "VALIDITY": [1, 1],
             "OFFSET": [0, 1, 2], "DATA": ["x", "y"]}]}},
        {"id": 1, "data": {"count": 2, "columns": [
            {"name": "DICT1", "count": 2, "VALIDITY": [1, 1],
             "OFFSET": [0, 1, 2], "DATA": ["p", "q"]}]}}],
    "batches": [{"count": 2, "columns": [
        {"name": "top", "count": 2, "VALIDITY": [1, 1], "DATA": [0, 1]},
        {"name": "st", "count": 2, "VALIDITY": [1, 1], "children": [
            {"name": "s", "count": 2, "VALIDITY": [1, 1],
             "DATA": [1, 0]}]}]}]}

EMPTY = {"schema": {"fields": [
    {"name": "a", "type": {"name": "int", "isSigned": True, "bitWidth": 64},
     "nullable": True, "children": []},
    {"name": "n", "type": {"name": "null"}, "nullable": True,
     "children": []}]}, "batches": []}

TWO_BATCHES = {"schema": GOLDEN["schema"],
               "batches": GOLDEN["batches"] * 2}


@pytest.mark.parametrize("name,doc", [("golden", GOLDEN),
                                      ("nested_dictionaries", NESTED_DICTS),
                                      ("no_batches", EMPTY),
                                      ("two_batches", TWO_BATCHES)])
def test_documents_read_as_the_reference(name, doc):
    want = rij.table_from_json(json.loads(json.dumps(doc)))
    got = pij.table_from_json(json.loads(json.dumps(doc)), device=CPU)
    assert_tables_equal(got, port_table(want))


def test_union_matches_reference():
    import jax.numpy as jnp
    from arrow_tpu.core.nested import UnionColumn
    dt = at.dtypes
    fields = (dt.Field("a", dt.int32), dt.Field("b", dt.utf8))
    kids = (at.column([10, 20], dt.int32), at.column(["x"], dt.utf8))
    u = UnionColumn(jnp.asarray(np.asarray([0, 1, 0], np.int8)),
                    jnp.asarray(np.asarray([0, 0, 1], np.int32)),
                    kids, fields, ids=(0, 1))
    ref = at.Table([u], dt.Schema((dt.Field("u", u.dtype),)))
    want = rij.table_to_json(ref)
    got = pij.table_to_json(port_table(ref))
    assert json.dumps(got) == json.dumps(want)
    back = pij.table_from_json(json.loads(json.dumps(got)), device=CPU)
    assert_tables_layouts_equal(back, port_table(
        rij.table_from_json(json.loads(json.dumps(want)))))


TYPES = ["null", "bool_", "int8", "uint16", "int64", "float16", "float64",
         "utf8", "large_binary", ("fixed_size_binary", 3), "date32",
         "date64", ("time32", "s"), ("time64", "ns"),
         ("timestamp", "ms", "America/New_York"), ("duration", "us"),
         ("interval", "year_month"), ("interval", "day_time"),
         ("interval", "month_day_nano"), ("decimal128", 10, 2),
         ("decimal256", 60, 10)]


def _make(mod, spec):
    if isinstance(spec, str):
        return getattr(mod.dtypes, spec)
    return getattr(mod.dtypes, spec[0])(*spec[1:])


@pytest.mark.parametrize("spec", TYPES, ids=str)
def test_field_json_matches_reference(spec):
    rf = at.dtypes.Field("c", _make(at, spec))
    pf = att.dtypes.Field("c", _make(att, spec))
    obj = pij._field_to_json(pf, None, None)
    assert obj == rij._field_to_json(rf, None, None)
    back, _ = pij.field_from_json(json.loads(json.dumps(obj)))
    assert back.dtype == pf.dtype


def test_file_modes_match_reference(tmp_path):
    data = {"a": [1, None, 3], "s": ["x", "y", None]}
    ref = at.Table.from_pydict(data)
    port = att.Table.from_pydict(data, device=CPU)
    rj, pj = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    rij.write_json_file(rj, ref)
    pij.write_json_file(pj, port)
    assert open(pj).read() == open(rj).read()
    ra, pa_ = str(tmp_path / "r.arrow"), str(tmp_path / "p.arrow")
    rij.json_to_arrow(rj, ra)
    pij.json_to_arrow(pj, pa_)
    assert open(pa_, "rb").read() == open(ra, "rb").read()
    assert pij.validate(pa_, pj)
    p2 = str(tmp_path / "p2.json")
    pij.arrow_to_json(pa_, p2)
    assert_tables_equal(pij.read_json_file(p2, device=CPU), port)
    doc = json.load(open(pj))
    doc["batches"][0]["columns"][0]["DATA"][0] = "999"
    json.dump(doc, open(pj, "w"))
    assert not pij.validate(pa_, pj)


def test_empty_col_takes_a_device():
    col = pij._empty_col(att.dtypes.decimal128(10, 2), CPU)
    assert len(col) == 0 and col.device == torch.device("cpu")
    want = rij._empty_col(at.dtypes.decimal128(10, 2))
    assert repr(col.dtype) == repr(port_dtype(want.dtype))


def test_read_onto_the_card(cuda_device):  # noqa: F811
    got = pij.table_from_json(json.loads(json.dumps(NESTED_DICTS)),
                              device=cuda_device)
    assert got.column("top").device.type == "cuda"
    assert_tables_equal(got, port_table(rij.table_from_json(
        json.loads(json.dumps(NESTED_DICTS)))))
