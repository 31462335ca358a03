"""A CPU rehearsal of chip_smoke.py's phase 30 (TPC-H lineitem through
Parquet, IPC and the C Data Interface) at 10,000 rows in row groups of
2,048: its generator with all 16 columns, then every call and check of
steps 1-9 (`p30_calls`): the Parquet write and pyarrow's read of it,
pyarrow's write from export_stream and the port's read of that file,
the Table API over the read-back table (equals against its source and
seven changed copies, the zero-copy column edits, FilterPredicate's
indices),
the Q6 and Q1 scans with their closed forms and K1 call sites, Q1's
group_by, the IPC file and stream (fed in small pieces), import_stream
of a pyarrow reader, the CPU route's list and the scan with and without
the row-group prefetch.  The meter runs each call once and reports
zeroed launch counts: CPU tensors take the kernels' plain versions."""

import contextlib
import time

import numpy as np
import torch

from test_torch_tpch_strings import _chip_smoke

ROWS = 10_000
GROUP = 2_048


class PlainMeter:
    """CardMeter's interface on the CPU: calls run once on the host
    clock, the watched calls recorded, the launch counts zero."""

    what = "phase 30 rehearsal"

    def __init__(self, chip):
        self.chip, self.seconds, self.times = chip, {}, {}

    def reads(self, fn):
        """The CPU makes no host syncs to count: the card's count is
        checked on the card (and by test_torch_table_api.py there)."""
        return fn(), 1, 0.0, 0.0

    def timed(self, name, fn):
        out, self.times[name] = fn(), 0.0
        return out

    def host(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        self.seconds[name] = time.perf_counter() - t0
        return out

    def counted(self, name, must, fn, *watches, exactly=None):
        with contextlib.ExitStack() as stack:
            calls = [stack.enter_context(self.chip.watch(f, m))
                     for f, m in watches]
            out = fn()
        return out, {"compact": 0, "grouped_aggregate": 0}, calls


def test_lineitem_generator():
    """The 16 columns of the spec, their types and TPC-H's value rules."""
    chip = _chip_smoke()
    table, g = chip.tpch_lineitem16(ROWS, torch.device("cpu"),
                                    pool_bytes=1 << 16, seed=30)
    names = [f.name for f in table.schema.fields]
    assert names == ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                     "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                     "l_returnflag", "l_linestatus", "l_shipdate",
                     "l_commitdate", "l_receiptdate", "l_shipinstruct",
                     "l_shipmode", "l_comment"]
    types = {f.name: repr(f.dtype) for f in table.schema.fields}
    assert types["l_orderkey"] == types["l_suppkey"] == "int64"
    assert types["l_linenumber"] == "int32"
    assert types["l_tax"] == "decimal128(15, 2)"
    assert types["l_commitdate"] == "date32"
    assert types["l_shipmode"] == "dictionary<int32, utf8>"
    assert types["l_comment"] == "utf8"
    assert not any(f.nullable for f in table.schema.fields)
    part = table.column("l_partkey").values
    supp = table.column("l_suppkey").values
    s = chip.P30_SUPPLIERS
    # spec 4.2.3: one of the part's four suppliers
    cands = torch.stack([(part + k * (s // 4 + (part - 1) // s)) % s + 1
                         for k in range(4)], 1)
    assert bool((cands == supp[:, None]).any(1).all())
    lens = g["comment_lens"]
    assert 10 <= int(lens.min()) and int(lens.max()) <= 43
    offs = table.column("l_comment").offsets
    assert torch.equal(offs[1:] - offs[:-1], lens.to(torch.int32))
    ship, commit, receipt = g["ship"], g["commit"], g["receipt"]
    assert bool(((receipt - ship) >= 1).all() & ((receipt - ship) <= 30)
                .all())
    assert table.column("l_shipinstruct").values.to_pylist() == \
        list(chip.P30_SHIPINSTRUCT)
    assert len(table.column("l_shipmode").values) == 7


def test_phase30_rehearsal(tmp_path):
    chip = _chip_smoke()
    dev = torch.device("cpu")
    table, g = chip.tpch_lineitem16(ROWS, dev, pool_bytes=1 << 16, seed=30)
    meter = PlainMeter(chip)
    sites, sizes = chip.p30_calls(table, g, dev, meter, tmp_path,
                                  rows=GROUP, cpu_groups=2, piece=4096)
    groups = -(-ROWS // GROUP)
    assert set(meter.seconds) >= {
        "write_parquet", "pyarrow reads the port's file",
        "pyarrow writes from export_stream", "read_parquet of pyarrow's file",
        "the Table API: equals, column edits, FilterPredicate.indices",
        "ipc.write_file (lz4)", "ipc.read_file", "ipc.write_stream",
        "StreamDecoder fed 4,096-byte pieces",
        "import_stream of pyarrow's reader", "Q6 scan", "Q1 scan and group_by",
        "the CPU route over 2 row groups",
        "a scan of 2 row groups with and without prefetch, on a side stream"}
    assert set(sizes) == {"port's parquet", "pyarrow's parquet",
                          "IPC file (lz4)", "IPC stream"}
    for name in ("Q6 predicate", "Q6 selection", "Q1 predicate",
                 "Q1 selection"):
        calls, launches = sites[name]
        assert launches == {"compact": 0, "grouped_aggregate": 0}
        assert len(calls) == groups, name
        (args, _), = calls[:1]
        assert args[0].dtype == torch.bool and args[0].shape[0] == GROUP
    keep, count, launches = sites["FilterPredicate.indices"]
    assert keep.shape[0] == ROWS and count == int(keep.sum()) > 0
    assert launches == {"compact": 0, "grouped_aggregate": 0}
    calls, _ = sites["Q1 group_by"]
    assert len(calls) == 1
    codes, ncodes = calls[0][0][:2]
    assert codes.shape[0] > 0.9 * ROWS and ncodes == 4
    _, kept_rev, mixed = chip._q6_closed_form(g, ROWS, GROUP, groups)
    assert mixed == groups and kept_rev > 0


def test_scans_take_row_groups_on_both_devices(tmp_path):
    """The Q6 and Q1 scans over chosen row groups equal their full
    scans' rows in those groups."""
    chip = _chip_smoke()
    dev = torch.device("cpu")
    table, g = chip.tpch_lineitem16(ROWS, dev, pool_bytes=1 << 16, seed=31)
    from arrow_tpu_torch.io.parquet_io import WriterProperties, write_parquet
    path = str(tmp_path / "l.parquet")
    write_parquet(path, table, WriterProperties(row_group_size=GROUP))
    whole = chip.q6_scan(path, dev)
    part = chip.q6_scan(path, dev, [1, 3])
    assert len(part) == 2
    for a, b in zip(part, (whole[1], whole[3])):
        chip._same_on_device(a, b, "Q6 row groups")
    rows, out = chip.q1_scan(path, dev, [0])
    keep = g["ship"][:GROUP] <= chip._days(1998, 9, 2)
    assert rows.num_rows == int(keep.sum())
    assert int(np.sum(out.column("l_shipdate_count_all").to_pylist())) == \
        rows.num_rows
