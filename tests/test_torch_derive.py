"""Parity of the port's dataclass record derive (arrow_tpu_torch/io/
derive.py) with the JAX package's, mirroring the derive tests of
tests/test_derive_validate_cli.py (the CLI is ported later)."""

import dataclasses
import datetime
from typing import List, Optional

import pytest

import arrow_tpu as at
from arrow_tpu.io import derive as rd
from arrow_tpu_torch.io import derive as pd
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table)

CPU = "cpu"


@dataclasses.dataclass
class Trade:
    id: int
    px: float
    sym: Optional[str]
    ok: bool
    tags: List[int]


@dataclasses.dataclass
class Dated:
    day: datetime.date
    at_: datetime.datetime
    raw: Optional[bytes]


@dataclasses.dataclass
class C:
    z: int


@dataclasses.dataclass
class B:
    c: C
    tags: List[int]


@dataclasses.dataclass
class A:
    b: B
    name: Optional[str]


CASES = {
    "trade": (Trade, [Trade(1, 1.5, "a", True, [1, 2]),
                      Trade(2, 2.5, None, False, [])]),
    "dated": (Dated, [Dated(datetime.date(2020, 2, 29),
                            datetime.datetime(2021, 1, 1, 12, 30, 1, 5),
                            b"\x00\x01"),
                      Dated(datetime.date(1970, 1, 1),
                            datetime.datetime(1999, 12, 31), None)]),
    "deep": (A, [A(B(C(1), [1, 2]), "x"), A(B(C(2), []), None)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_schema_matches_reference(name):
    cls, _ = CASES[name]
    got, want = pd.derive_schema(cls), rd.derive_schema(cls)
    assert [(f.name, repr(f.dtype), f.nullable) for f in got.fields] == \
        [(f.name, repr(f.dtype), f.nullable) for f in want.fields]


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_matches_reference(name):
    cls, rows = CASES[name]
    got = pd.records_to_table(rows, device=CPU)
    assert_tables_equal(got, port_table(rd.records_to_table(rows)))
    assert pd.table_to_records(got, cls) == rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_parquet_roundtrip_matches_reference(tmp_path, name):
    cls, rows = CASES[name]
    rp, pp = str(tmp_path / "r.parquet"), str(tmp_path / "p.parquet")
    rd.write_records(rp, rows, cls)
    pd.write_records(pp, rows, cls)
    assert rd.read_records(pp, cls) == rows
    assert pd.read_records(rp, cls, device=CPU) == rows
    assert pd.read_records(pp, cls, device=CPU) == rows


@pytest.mark.parametrize("bad", [int, dict, Optional[dict]])
def test_unsupported_hints_raise_in_both(bad):
    @dataclasses.dataclass
    class Bad:
        x: bad
    import arrow_tpu_torch as att
    with pytest.raises(at.errors.ArrowTypeError):
        rd.derive_schema(Bad if bad is not int else int)
    with pytest.raises(att.errors.ArrowTypeError):
        pd.derive_schema(Bad if bad is not int else int)


def test_empty_records_without_a_class_raise_in_both():
    import arrow_tpu_torch as att
    with pytest.raises(at.errors.ArrowTypeError):
        rd.records_to_table([])
    with pytest.raises(att.errors.ArrowTypeError):
        pd.records_to_table([], device=CPU)


def test_records_onto_the_card(cuda_device):  # noqa: F811
    cls, rows = CASES["trade"]
    got = pd.records_to_table(rows, device=cuda_device)
    assert got.column("id").device.type == "cuda"
    assert pd.table_to_records(got, cls) == rows
