"""TPC-H as SQL text, the slice as a whole, on the CPU: chip_smoke.py's
phase-32 query texts (`P32_QUERIES`: Q1, Q3, Q4, Q6 and Q10) over its
generator's lineitem, orders, customer and nation at a few thousand
lineitem rows, through both packages (the reference's tables made from
the port's through pyarrow), through the port's CSV reader from the
tables' text, and pyarrow's own answer; then phases 31 and 32 rehearsed
with a meter that runs each call once (CPU tensors take the kernels'
plain versions, so the launch counts are zero).  Floats compare within
rtol 1e-9 where the packages add in another order, everything else
exactly."""

import contextlib
import io
import math
import time

import pytest
import torch

from arrow_tpu.io.interop import table_from_pyarrow
from arrow_tpu.sql import execute_sql as ref_sql
from arrow_tpu_torch.io import csv as pcsv
from arrow_tpu_torch.io.interop import table_to_pyarrow
from arrow_tpu_torch.sql import execute_sql
from test_torch_tpch_strings import _chip_smoke

ROWS = 6_000
CUSTOMERS = 600
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def chip():
    return _chip_smoke()


@pytest.fixture(scope="module")
def tables(chip):
    tabs, _ = chip.tpch_tables(ROWS, CUSTOMERS, CPU, text=False,
                               pool_bytes=1 << 16, seed=32)
    return tabs


def _rows(t) -> list:
    d = t.to_pydict()
    return [dict(zip(d, r)) for r in zip(*d.values())]


def _close(got: list, want: list, what: str) -> None:
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), what
        for k, v in b.items():
            if isinstance(v, float):
                assert math.isclose(a[k], v, rel_tol=1e-9), (what, i, k)
            else:
                assert a[k] == v, (what, i, k, a[k], v)


def test_generator_tables(chip, tables):
    """Every column of the spec (1.4.1), the types the readers give, and
    the keys that join: each line's order, each order's customer."""
    want = {"lineitem": 16, "orders": 9, "customer": 8, "nation": 4}
    assert {k: t.num_columns for k, t in tables.items()} == want
    types = {f.name: repr(f.dtype) for t in tables.values()
             for f in t.schema.fields}
    assert types["l_extendedprice"] == types["o_totalprice"] == \
        types["c_acctbal"] == "float64"
    assert types["l_returnflag"] == types["c_mktsegment"] == \
        "dictionary<int32, utf8>"
    assert types["o_comment"] == types["c_comment"] == "large_utf8"
    assert types["o_orderdate"] == "date32"
    li, o = tables["lineitem"], tables["orders"]
    okeys = set(o.column("o_orderkey").to_pylist())
    assert set(li.column("l_orderkey").to_pylist()) == okeys
    cust = o.column("o_custkey").to_pylist()
    assert min(cust) >= 1 and max(cust) <= CUSTOMERS
    assert all(k % 3 for k in cust)
    assert tables["customer"].column("c_name").to_pylist()[:2] == \
        ["Customer#000000001", "Customer#000000002"]
    phone = tables["customer"].column("c_phone").to_pylist()[0]
    assert len(phone) == 15 and phone[2] == phone[6] == phone[10] == "-"
    assert tables["nation"].column("n_name").to_pylist()[24] == \
        "UNITED STATES"
    status = dict(zip(o.column("o_orderkey").to_pylist(),
                      o.column("o_orderstatus").to_pylist()))
    lines = {}
    for k, s in zip(li.column("l_orderkey").to_pylist(),
                    li.column("l_linestatus").to_pylist()):
        lines.setdefault(k, set()).add(s)
    for k, s in lines.items():
        assert status[k] == ("F" if s == {"F"} else "O" if s == {"O"}
                             else "P")


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q4", "Q6", "Q10"])
def test_query_matches_reference_and_pyarrow(chip, tables, name):
    query = chip.P32_QUERIES[name]
    got = execute_sql(tables, query)
    ref = {k: table_from_pyarrow(table_to_pyarrow(t))
           for k, t in tables.items()}
    want = ref_sql(ref, query)
    assert got.column_names == want.column_names
    _close(_rows(got), _rows(want), f"{name} against the reference")
    pat = {k: chip._arrow(tables[k], cols)
           for k, cols in chip.P32_NEEDS.items()}
    _close(_rows(got), chip.p32_pyarrow(name, pat), f"{name} against "
           "pyarrow")


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q4", "Q6", "Q10"])
def test_query_over_tables_read_from_csv(chip, tables, name):
    """The tables written as '|'-delimited text and read back by the
    port's CSV reader (dictionaries come back utf8) give the same
    answers, bit for bit."""
    from arrow_tpu_torch import dtypes as dt
    read = {}
    for k, t in tables.items():
        buf = io.BytesIO()
        pcsv.WriterBuilder(delimiter="|").write(buf, t)
        schema = dt.Schema(tuple(
            dt.Field(f.name, f.dtype.value_type if f.dtype.is_dictionary
                     else f.dtype) for f in t.schema.fields))
        read[k] = pcsv.read_csv(buf.getvalue(), schema, delimiter="|",
                                device=CPU)
    query = chip.P32_QUERIES[name]
    assert _rows(execute_sql(read, query)) == _rows(execute_sql(tables,
                                                                query))


class PlainMeter:
    """CardMeter's interface on the CPU: each call runs once on the host
    clock, the watched calls are recorded, the launch counts zero."""

    what = "phases 31-32 rehearsal"

    def __init__(self, chip):
        self.chip, self.seconds, self.times = chip, {}, {}

    def host(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        self.seconds[name] = time.perf_counter() - t0
        return out

    def timed(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        self.times[name] = (time.perf_counter() - t0) * 1e3
        return out

    def counted(self, name, must, fn, *watches, exactly=None):
        with contextlib.ExitStack() as stack:
            calls = [stack.enter_context(self.chip.watch(f, m))
                     for f, m in watches]
            out = fn()
        return out, {"compact": 0, "grouped_aggregate": 0}, calls


def test_phase31_rehearsal(chip, tmp_path):
    tabs, _ = chip.tpch_tables(ROWS, CUSTOMERS, CPU, text=True,
                               pool_bytes=1 << 16, seed=31)
    assert {repr(f.dtype) for f in tabs["lineitem"].schema.fields} <= {
        "int64", "int32", "float64", "utf8", "date32"}
    meter = PlainMeter(chip)
    sizes = chip.p31_calls({k: tabs[k] for k in ("lineitem", "orders")},
                           CPU, meter, tmp_path, avro_rows=1000)
    steps = ("write_csv", "pyarrow.csv reads", "read_csv", "write_json",
             "pyarrow.json reads", "read_json", "write_avro (1,000 rows)",
             "read_avro", "restore_table")
    for t in ("lineitem", "orders"):
        assert {f"{t} {s}" for s in steps} <= set(meter.seconds)
        assert sizes[f"{t} CSV"] > 0 and sizes[f"{t} JSON lines"] > 0


def test_phase32_rehearsal(chip, tables):
    meter = PlainMeter(chip)
    sites, answers = chip.p32_calls(tables, CPU, meter, cpu_rows=2_000)
    assert set(meter.times) == {"Q1", "Q3", "Q4", "Q6", "Q10"}
    assert [len(answers[k]) for k in ("Q1", "Q3", "Q4", "Q6", "Q10")] == \
        [4, 10, 5, 1, 20]
    for name, (calls, launches) in sites.items():
        assert calls and launches == {"compact": 0, "grouped_aggregate": 0}
        for (args, _) in calls:
            want = torch.int32 if name == "Q4 group_by" else torch.bool
            assert args[0].dtype == want, name
    (args, _), = sites["Q6 WHERE"][0]
    assert args[0].shape[0] == ROWS
    assert len(sites["Q3 joins"][0]) >= 2
    (args, kwargs), = sites["Q4 group_by"][0]
    assert args[1] == 6 and kwargs["codes_valid"] is None   # 5 and null


def test_literal_columns_stay_on_the_tables_device(chip, tables):
    """A literal in a SELECT list over the SF tables is a column of the
    table's rows on its device, typed as the reference types it."""
    out = execute_sql(tables, "SELECT l_orderkey, 1 AS one, 'x' AS s, "
                              "0.5 AS h FROM lineitem WHERE l_quantity > 49")
    assert [repr(f.dtype) for f in out.schema.fields] == \
        ["int64", "int64", "utf8", "float64"]
    assert all(c.device == CPU for c in out.columns)
    assert set(out.column("one").to_pylist()) <= {1}
