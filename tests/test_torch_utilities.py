"""The port's utilities against the JAX package's: the byte builders of
every string and binary type (core/builders.py), pretty_format_table,
pretty_format_columns and ArrayFormatter (utils/display.py), OpTimings,
op_timer, trace and the counters (utils/trace.py), the seeded
generators (utils/bench_util.py), validity.is_all_valid_host,
boolean.bool_is_static_all, and the `compute` facade and package names
(every name the reference's facade exports).
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.core import builders as pb, validity as pvd
from arrow_tpu_torch.ops import boolean as pbool
from arrow_tpu_torch.utils import bench_util as pbu, display as pdisp
from arrow_tpu_torch.utils import trace as ptrace
from torch_port_util import (assert_columns_equal, assert_tables_equal,
                             buffers, port_column, port_table)

rb = importlib.import_module("arrow_tpu.core.builders")
rdisp = importlib.import_module("arrow_tpu.utils.display")
rtrace = importlib.import_module("arrow_tpu.utils.trace")
rbu = importlib.import_module("arrow_tpu.utils.bench_util")
rvd = importlib.import_module("arrow_tpu.core.validity")
rbool = importlib.import_module("arrow_tpu.ops.boolean")
rdt = at.dtypes


# ---- builders ---------------------------------------------------------------

VALUES = ["a", None, "", "é日本", b"\x00\xffz", None, "long " * 9]


@pytest.mark.parametrize("name", ["StringBuilder", "LargeStringBuilder",
                                  "BinaryBuilder", "LargeBinaryBuilder"])
def test_byte_builders(name):
    """append, append_null, append_nulls and extend; finish resets: the
    reference's buffers (int64 offsets for the large types)."""
    text = name.startswith(("String", "LargeString"))
    vals = [v.decode("latin-1") if text and isinstance(v, bytes) else v
            for v in VALUES]
    port, ref = getattr(pb, name)(device="cpu"), getattr(rb, name)()
    for b in (port, ref):
        b.append(vals[0]).append_null()
        b.extend(vals[2:])
        b.append_nulls(2)
    assert len(port) == len(ref)
    got, want = port.finish(), ref.finish()
    assert_columns_equal(got, want, name, masks=True)
    assert buffers(got) == buffers(port_column(want))
    assert got.offsets.dtype == (torch.int64 if "Large" in name
                                 else torch.int32)
    assert len(port.finish()) == len(ref.finish()) == 0


@pytest.mark.parametrize("dtype", ["utf8", "large_utf8", "binary",
                                   "large_binary", "utf8_view",
                                   "binary_view"])
def test_make_builder_and_column_of_every_string_type(dtype):
    """make_builder and column() take every string layout.  The reference
    has no builder for the views (it raises); its column() does build
    them, with int32 offsets under large types (C14)."""
    pd, rd = getattr(att.dtypes, dtype), getattr(rdt, dtype)
    vals = ["x", None, "yz", ""] if "utf8" in dtype \
        else [b"x", None, b"yz", b""]
    b = pb.make_builder(pd, "cpu")
    for v in vals:
        b.append(v)
    built = b.finish()
    col = att.column(vals, pd, device="cpu")
    want = at.column(vals, rd)
    for got in (built, col):
        assert repr(got.dtype) == repr(pd)
        assert got.to_pylist() == want.to_pylist() == vals
        assert buffers(got) == buffers(port_column(want))
    if "view" in dtype:
        with pytest.raises(at.ArrowTypeError):
            rb.make_builder(rd)
    else:
        assert buffers(rb.make_builder(rd).extend(vals).finish()) == \
            buffers(port_column(want))


def test_dictionary_builder_of_large_strings():
    port = pb.make_builder(att.dtypes.dictionary(att.dtypes.int32,
                                                 att.dtypes.large_utf8),
                           "cpu")
    ref = rb.make_builder(rdt.dictionary(rdt.int32, rdt.large_utf8))
    for b in (port, ref):
        b.extend(["b", "a", None, "b"])
    assert_columns_equal(port.finish(), ref.finish(), "dictionary")


# ---- display ----------------------------------------------------------------

def _table():
    rng = np.random.default_rng(3)
    n = 12
    mask = rng.random(n) < 0.25
    arrays = {
        "i": pa.array(rng.integers(-99, 99, n), mask=mask),
        "f": pa.array(rng.standard_normal(n), mask=mask[::-1]),
        "b": pa.array(rng.random(n) < 0.5),
        "s": pa.array([None if m else f"w{k}é" for k, m in
                       zip(range(n), mask)]),
        "bin": pa.array([bytes([k, 255]) for k in range(n)], pa.binary()),
        "d": pa.array(rng.integers(0, 20_000, n).astype(np.int32)).cast(
            pa.date32()),
        "ts": pa.array(rng.integers(0, 10 ** 15, n), mask=mask).cast(
            pa.timestamp("us")),
        "tz": pa.array(rng.integers(0, 10 ** 12, n)).cast(
            pa.timestamp("ms", "UTC")),
        "l": pa.array([[k, None] if k % 3 else None for k in range(n)],
                      pa.list_(pa.int64())),
        "st": pa.array([{"x": k, "y": "z"} for k in range(n)]),
        "dict": pa.array([["p", "q"][k % 2] for k in range(n)]
                         ).dictionary_encode(),
    }
    ref = importlib.import_module("arrow_tpu.io.interop").table_from_pyarrow(
        pa.RecordBatch.from_pydict(arrays))
    return ref, port_table(ref)


@pytest.mark.parametrize("options", [
    {}, {"null": "NULL"}, {"date_format": "%d/%m/%Y",
                           "timestamp_format": "%Y%m%d %H%M"}],
    ids=["default", "null", "formats"])
def test_pretty_format_table(options):
    ref, port = _table()
    got = pdisp.pretty_format_table(port, pdisp.FormatOptions(**options))
    want = rdisp.pretty_format_table(ref, rdisp.FormatOptions(**options))
    assert got == want
    for name in ("d", "ts", "s"):
        assert pdisp.pretty_format_columns(
            name, port.column(name), pdisp.FormatOptions(**options)) == \
            rdisp.pretty_format_columns(name, ref.column(name),
                                        rdisp.FormatOptions(**options))


def test_array_formatter_values():
    ref, port = _table()
    for name in port.column_names:
        got = att.ArrayFormatter(port.column(name))
        want = rdisp.ArrayFormatter(ref.column(name))
        assert [got.value(i) for i in range(port.num_rows)] == \
            [want.value(i) for i in range(ref.num_rows)], name


# ---- timing and counters ----------------------------------------------------

def test_op_timings_report_and_snapshot():
    """The same recorded times give the reference's snapshot and report."""
    port, ref = ptrace.OpTimings(), rtrace.OpTimings()
    for name, secs in [("filter", 0.002), ("group_by", 0.25),
                       ("filter", 0.004), ("like", 1.5)]:
        port.record(name, secs)
        ref.record(name, secs)
    assert port.snapshot() == ref.snapshot()
    assert port.report() == ref.report()
    port.reset()
    assert port.snapshot() == {}


def test_op_timer_syncs_and_records():
    sink, synced = ptrace.OpTimings(), []
    with ptrace.op_timer("like", sync=lambda: synced.append(1), sink=sink):
        torch.ones(10).sum()
    with ptrace.op_timer("like", sink=sink):     # no card: no sync
        pass
    snap = sink.snapshot()["like"]
    assert synced == [1] and snap["count"] == 2 and snap["total_ms"] >= 0
    ptrace.reset_timings()
    with att.op_timer("x"):
        pass
    assert att.timings.snapshot()["x"]["count"] == 1
    ptrace.reset_timings()


def test_counters():
    ptrace.reset_counters()
    ptrace.count("plan.sort")
    ptrace.count("plan.sort", 2)
    ptrace.count("plan.dict")
    assert ptrace.counters_snapshot() == {"plan.sort": 3, "plan.dict": 1}
    ptrace.reset_counters()
    assert ptrace.counters_snapshot() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with ptrace.trace(str(path)):
        (torch.arange(1000) * 2).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# ---- generators -------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("create_primitive_array", dict(size=300, null_density=0.2)),
    ("create_primitive_array", dict(size=300, dtype=np.uint16, seed=5)),
    ("create_primitive_array", dict(size=300, dtype=np.float32,
                                    null_density=0.1)),
    ("create_boolean_array", dict(size=300, null_density=0.3,
                                  true_density=0.7)),
    ("create_string_array", dict(size=300, null_density=0.2, seed=1)),
    ("create_string_dict_array", dict(size=300, null_density=0.2,
                                      cardinality=17)),
    ("create_timestamp_array", dict(size=300, null_density=0.1,
                                    unit="ms"))],
    ids=lambda c: c[0] if isinstance(c, str) else None)
def test_bench_util_generators(case):
    name, kw = case
    got = getattr(pbu, name)(device="cpu", **kw)
    want = at.column(getattr(rbu, name)(**kw))
    assert_columns_equal(got, want, name, masks=True)
    assert buffers(got) == buffers(port_column(want))


def test_create_random_batch():
    got = pbu.create_random_batch(500, seed=4, device="cpu")
    want = rbu.create_random_batch(500, seed=4)
    assert_tables_equal(got, want)


# ---- small helpers ----------------------------------------------------------

def test_is_all_valid_host_and_bool_is_static_all():
    for mask in (None, [True, True], [True, False], []):
        pm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
        rm = None if mask is None else jnp.asarray(mask, jnp.bool_)
        assert pvd.is_all_valid_host(pm) == rvd.is_all_valid_host(rm)
        assert pbool.bool_is_static_all(pm) == rbool.bool_is_static_all(rm)


# ---- the facade -------------------------------------------------------------

def test_compute_facade_holds_every_reference_name():
    """Every public name of arrow_tpu.ops is in arrow_tpu_torch.compute
    (none of ROADMAP's not-ported TPU-only code is a facade name), and
    the package exports what arrow_tpu's top level does."""
    import inspect
    ref_ops = importlib.import_module("arrow_tpu.ops")
    names = {n for n in dir(ref_ops) if not n.startswith("_")
             and not inspect.ismodule(getattr(ref_ops, n))}
    missing = sorted(n for n in names if not hasattr(att.compute, n))
    assert missing == []
    assert att.compute.concat_batches is att.compute.concat_tables
    assert att.compute.interleave_record_batch is \
        att.compute.interleave_tables
    top = {n for n in dir(at) if not n.startswith("_")
           and not inspect.ismodule(getattr(at, n))} - {"__version__"}
    assert sorted(n for n in top if not hasattr(att, n)) == []
    # arrow_tpu_torch.ops.<module> stays the module (the reference's
    # facade puts the function `join` in the place of its module)
    importlib.import_module("arrow_tpu_torch.ops.join")
    for name in ("join", "filter", "take", "sort", "cast", "concat"):
        assert inspect.ismodule(getattr(att.ops, name))


def test_facade_calls_run():
    col = att.column(["special requests", "x", None], device="cpu")
    assert att.compute.like(col, "%requests").to_pylist() == \
        [True, False, None]
    assert att.compute.length(col).to_pylist() == [16, 1, None]
