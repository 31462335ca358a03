"""Smoke run of the PyTorch port (arrow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path at BASELINE sizes and checks every kernel:

  1. needs torch.cuda; prints the card's name and power limit
  2. builds the CUDA kernels from arrow_tpu_torch/csrc (nvcc, sm_90a)
  3. K1 compaction against its plain version at 10M rows: every dtype
     of the slice, selectivities 1/2, 0 and 1; bitwise on [:count]
  4. K2 grouped aggregation against its plain version at 100M rows (the
     group_by's slots); sums, counts and order keys bitwise
  5. the config-1 query (WHERE x > 0: sum(y*2 + x), count(*)) through
     arrow_tpu_torch.pipeline at 10M rows, against a host float64 sum
     over the kept rows (rtol 1e-9: summation order) and the exact count
  6. the same query through Table / filter_table / mul / add / sum_
  7. group_by over a 1,000-value dictionary key at 100M rows against
     the plain-version route (the same table on the CPU)
  8. the kernels' launch counts over steps 5-7: both must be above 0
  9. kernel and plain times from CUDA events (median of 5 after one
     warm-up) at the main path's shapes
 10. BASELINE config 4, 500M rows x 1K groups: Int64 keys h % 1000 and
     values (h >> 32) % 1000 from bench.py's splitmix hash, made on the
     card; a resident group_by [sum, count, min, max] on the
     small-domain plan, held against an independent computation
     (torch.unique + index_add_ / scatter_reduce_, exact); it must
     launch K2; then K2 at this shape against its plain version
 11. config 4, 500M rows x 10M groups: a resident group_by on the sort
     plan (it must launch K1), against the same kind of independent
     computation; then K1 at its run-start compaction against its plain
     version
 12. the same 10M-group aggregate through GroupByAccumulator fed the
     125M-row chunks of bench.py:425-461 made on the card (K1 again),
     against the independent computation of step 11
 13. CUDA-event medians of the config-4 calls and the peak device
     memory of each; the tables are freed between steps

Any failure raises and exits non-zero.  The line before the last is a
JSON object of per-kernel results; the last line is the JSON result
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG1_ROWS = 10_000_000          # BASELINE config 1 (bench.py:94-97)
GROUPBY_ROWS = 100_000_000         # config 4's 500M, cut to fit the run
GROUPS = 1_000                     # config 4's 1K-group cardinality
SEED = 0
CONFIG4_ROWS = 500_000_000         # BASELINE config 4 (bench.py:395-491)
CONFIG4_CHUNK = 125_000_000        # its streamed chunks (bench.py:425)
CONFIG4_AGGS = ("sum", "count", "min", "max")      # bench.py:419-420


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| (positions where both are NaN count as 0)."""
    if a.numel() == 0:
        return 0.0
    x, y = a.to(torch.float64), b.to(torch.float64)
    d = (x - y).abs()
    d = torch.where(torch.isnan(x) & torch.isnan(y), 0.0, d)
    d = torch.where(x == y, 0.0, d)       # equal infinities
    return float(d.max())


def _same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    err = _max_abs_err(a, b)
    if not torch.equal(_bits(a), _bits(b)):
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of `fn` over `reps` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def config1_inputs(n: int):
    """bench.py config1's generator: x in [-1000, 1000), y in [0, 1)."""
    rng = np.random.default_rng(SEED)
    return rng.integers(-1000, 1000, n).astype(np.int64), rng.random(n)


def _lsr(x, k):
    """Logical shift right on int64 storage."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix(n: int, offset: int, device) -> torch.Tensor:
    """bench.py's hash of i = arange(n) + offset + 7 (bench.py:408-414),
    u64 bits in int64 storage."""
    h = torch.arange(n, dtype=torch.int64, device=device) + (offset + 7)
    h = (h ^ _lsr(h, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    return (h ^ _lsr(h, 27)) * (0x94D049BB133111EB - (1 << 64))


def config4_table(n: int, groups: int, device, offset: int = 0):
    """Config 4's table on the device (bench.py:408-417): Int64 k = h %
    groups (unsigned), v = (h >> 32) % 1000, no nulls."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    h = splitmix(n, offset, device)
    k = ((_lsr(h, 1) % groups) * 2 + (h & 1)) % groups   # u64 h % groups
    v = _lsr(h, 32) % 1000
    del h
    return Table([PrimitiveColumn(k, dt.int64), PrimitiveColumn(v, dt.int64)],
                 dt.Schema((dt.Field("k", dt.int64, nullable=False),
                            dt.Field("v", dt.int64, nullable=False))))


def independent_groupby(table):
    """sum, count, min and max of v per distinct k, by torch.unique and
    index_add_ / scatter_reduce_: no code of the port."""
    k, v = table.column("k").values, table.column("v").values
    keys, inv = torch.unique(k, sorted=True, return_inverse=True)
    g = keys.shape[0]

    def full(x):
        return torch.full((g,), x, dtype=torch.int64, device=k.device)

    out = {"k": keys,
           "v_sum": full(0).index_add_(0, inv, v),
           "v_count": full(0).index_add_(0, inv, torch.ones_like(v)),
           "v_min": full(2 ** 63 - 1).scatter_reduce_(0, inv, v, "amin"),
           "v_max": full(-2 ** 63).scatter_reduce_(0, inv, v, "amax")}
    del inv
    return out


def check_config4(out, want, what: str) -> None:
    if out.num_rows != want["k"].shape[0]:
        raise AssertionError(f"{what}: {out.num_rows} groups, independent "
                             f"computation {want['k'].shape[0]}")
    for name, ref in want.items():
        col = out.column(name)
        if col.validity is not None and not bool(col.validity.all()):
            raise AssertionError(f"{what}: {name} has nulls")
        if not torch.equal(col.values, ref):
            bad = int((col.values != ref).sum())
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"independent computation in {bad} groups")
    print(f"{what}: {out.num_rows:,} groups, keys and sum/count/min/max "
          f"equal to the independent computation", flush=True)


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def groupby_table(n: int, device: torch.device):
    """Config 4's shape on the device: an Int32 dictionary code column
    (10% null) over 1,000 Utf8 values shuffled against the codes, and
    v = hash % 1000 (bench.py's splitmix hash, 10% null)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    codes = torch.randint(0, GROUPS, (n,), generator=gen, device=device,
                          dtype=torch.int32)
    kvalid = torch.rand(n, generator=gen, device=device) >= 0.1
    h = splitmix(n, 0, device)
    v = _lsr(h, 32) % 1000
    del h
    vvalid = torch.rand(n, generator=gen, device=device) >= 0.1
    perm = np.random.default_rng(SEED).permutation(GROUPS)
    words = StringColumn.from_pylist([f"key{i:04d}" for i in perm])
    return Table([DictionaryColumn(codes, words, kvalid),
                  PrimitiveColumn(v, dt.int64, vvalid)],
                 dt.Schema((dt.Field("k", dt.dictionary(dt.int32, dt.utf8)),
                            dt.Field("v", dt.int64))))


def groupagg_slots(table):
    """The K2 call group_by makes for [sum, count, min, max, count_all]
    on v: occupancy, count(v) and sum(v) slots plus one min/max slot."""
    from arrow_tpu_torch.kernels.groupagg import MinMaxCol, SumCol
    k, v = table.column("k"), table.column("v")
    codes = torch.where(k.validity, k.codes, len(k.values)).contiguous()
    sums = [SumCol(None), SumCol(None, v.validity),
            SumCol(v.values, v.validity, v.dtype)]
    return codes, len(k.values) + 1, sums, [MinMaxCol(v.values, v.validity,
                                                      v.dtype)]


def check_compact(dev) -> float:
    from arrow_tpu_torch.kernels import compact as kc
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n = CONFIG1_ROWS
    arrays = [torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen,
                            device=dev).to(d)
              for d in (torch.int8, torch.int16, torch.int32, torch.int64)]
    arrays.append(torch.randint(-2 ** 63, 2 ** 63 - 1, (n,), generator=gen,
                                device=dev))          # uint64 storage
    for d in (torch.float16, torch.float32, torch.float64):
        f = torch.randn(n, generator=gen, device=dev, dtype=d)
        f[::101] = float("nan")
        f[1::103] = -0.0
        f[2::107] = float("inf")
        arrays.append(f)
    arrays.append(torch.rand(n, generator=gen, device=dev) < 0.5)
    err = 0.0
    for p in (0.5, 0.0, 1.0):
        keep = torch.rand(n, generator=gen, device=dev) < p
        got, got_n = kc.compact(keep, arrays)
        want, want_n = kc.compact_plain(keep, arrays, n)
        torch.cuda.synchronize()
        count = int(want_n)
        if int(got_n) != count:
            raise AssertionError(f"K1 count {int(got_n)} != {count}")
        for a, b in zip(got, want):
            err = max(err, _same_bits(a[:count], b[:count],
                                      f"K1 {a.dtype} p={p}"))
        print(f"K1 compact 10M x {len(arrays)} columns, selectivity {p}: "
              f"count {count}, bitwise equal", flush=True)
    return err


def check_groupagg(table) -> float:
    from arrow_tpu_torch.kernels import groupagg as kg
    codes, G, sums, mms = groupagg_slots(table)
    got = kg.grouped_aggregate(codes, G, sums, mms, decode=False)
    want = kg.grouped_aggregate_plain(codes, G, sums, mms)
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, b) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        err = max(err, _same_bits(a, b, f"K2 sum/count {i}"))
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        err = max(err, _same_bits(a0, b0, "K2 min keys"))
        err = max(err, _same_bits(a1, b1, "K2 max keys"))
    print(f"K2 grouped_aggregate {codes.shape[0]:,} rows x {G} groups "
          f"({len(sums)} sum + {len(mms)} min/max slots): bitwise equal",
          flush=True)
    return err


def run_main_path(dev, x_np, y_np, table):
    """Steps 5-7 through the user-facing entry points."""
    from arrow_tpu_torch import pipeline
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by

    keep = x_np > 0
    truth = float((y_np[keep] * 2.0 + x_np[keep]).sum())
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    t0 = time.perf_counter()
    total, count, _ = pipeline.query(x, y, 0)
    total, count = float(total), int(count)
    secs = time.perf_counter() - t0
    if count != int(keep.sum()):
        raise AssertionError(f"config 1: count {count} != {keep.sum()}")
    np.testing.assert_allclose(total, truth, rtol=1e-9)
    print(f"config 1 pipeline.query 10M rows: sum {total!r} (host {truth!r})"
          f", count {count}, {secs * 1e3:.3f} ms first call", flush=True)

    tab = Table.from_numpy_columns({"x": {"values": x_np},
                                    "y": {"values": y_np}}, device=dev)
    tsum, tcount = pipeline.query_table(tab, 0)
    if tcount != count:
        raise AssertionError(f"config 1 table: count {tcount} != {count}")
    np.testing.assert_allclose(tsum, truth, rtol=1e-9)
    print(f"config 1 query_table 10M rows: sum {tsum!r}, count {tcount}",
          flush=True)

    aggs = [AggSpec("v", op) for op in ("sum", "count", "min", "max",
                                        "count_all")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = group_by(table, ["k"], aggs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"group_by 100M rows x 1K dictionary groups: {out.num_rows} groups"
          f", {secs:.4f} s first call", flush=True)
    return out, aggs


def groupby_table_to(table, device):
    """The same table with its tensors on `device`."""
    from arrow_tpu_torch.core.column import DictionaryColumn, PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    k, v = table.column("k"), table.column("v")
    return Table([DictionaryColumn(k.codes.to(device), k.values,
                                   k.validity.to(device), _canonical=True),
                  PrimitiveColumn(v.values.to(device), v.dtype,
                                  v.validity.to(device), _canonical=True)],
                 table.schema)


def _k2_check(codes, G, sums, mms, what: str):
    """K2 against its plain version on the same inputs: (max abs err,
    kernel ms, plain ms)."""
    from arrow_tpu_torch.kernels import groupagg as kg
    got = kg.grouped_aggregate(codes, G, sums, mms, decode=False)
    want = kg.grouped_aggregate_plain(codes, G, sums, mms)
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, b) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        err = max(err, _same_bits(a, b, f"{what} sum/count {i}"))
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        err = max(err, _same_bits(a0, b0, f"{what} min keys"))
        err = max(err, _same_bits(a1, b1, f"{what} max keys"))
    del got, want
    print(f"{what}: {codes.shape[0]:,} rows x {G} codes ({len(sums)} sum + "
          f"{len(mms)} min/max slots), kernel and plain version bitwise "
          f"equal", flush=True)
    ms = time_ms(lambda: kg.grouped_aggregate(codes, G, sums, mms,
                                              decode=False))
    plain = time_ms(lambda: kg.grouped_aggregate_plain(codes, G, sums, mms))
    return err, ms, plain


def _reset_counts():
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.compact.launches = 0
    kg.grouped_aggregate.launches = 0


def _read_counts(what: str, must: str) -> dict:
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
    torch.cuda.synchronize()
    launches = {"compact": kc.compact.launches,
                "grouped_aggregate": kg.grouped_aggregate.launches}
    print(f"{what}: launches {launches}, peak device memory "
          f"{peak_gib():.2f} GiB", flush=True)
    if launches[must] <= 0:
        raise AssertionError(f"{what} never launched {must}")
    return launches


def run_config4_1k(dev) -> dict:
    """Step 10: 500M x 1K on the small-domain plan (one K2 pass)."""
    from arrow_tpu_torch.kernels.groupagg import MinMaxCol, SumCol
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    aggs = [AggSpec("v", op) for op in CONFIG4_AGGS]
    table = config4_table(CONFIG4_ROWS, 1_000, dev)
    want = independent_groupby(table)
    _reset_counts()
    t0 = time.perf_counter()
    out = group_by(table, ["k"], aggs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts("config 4 500M x 1K group_by", "grouped_aggregate")
    check_config4(out, want, f"config 4 500M x 1K group_by ({secs:.3f} s "
                             f"first call)")
    del out, want
    gb_ms = time_ms(lambda: group_by(table, ["k"], aggs))
    # K2 as the small-domain plan launches it: digits k - min(k) over
    # 1,000 codes; slots: occupancy, count(v), sum(v), min/max(v)
    k, v = table.column("k").values, table.column("v").values
    if int(k.min()) != 0 or int(k.max()) != 999:
        raise AssertionError("config 4 1K keys do not span [0, 999]")
    codes = k.to(torch.int32)
    err, ms, plain = _k2_check(
        codes, 1_000, [SumCol(None), SumCol(None), SumCol(v, None)],
        [MinMaxCol(v)], "K2 at config 4's small-domain plan")
    del codes, table
    print(f"config 4 500M x 1K: group_by {gb_ms:.4f} ms (CUDA events, "
          f"median of 5); K2 {ms:.4f} ms vs plain {plain:.4f} ms; peak "
          f"device memory {peak_gib():.2f} GiB", flush=True)
    return {"launches": launches["grouped_aggregate"], "err": err, "ms": ms,
            "plain_ms": plain, "groupby_ms": gb_ms}


def run_config4_10m(dev):
    """Steps 11-12: 500M x 10M resident on the sort plan, then streamed
    through GroupByAccumulator."""
    from arrow_tpu_torch.kernels import compact as kc
    from arrow_tpu_torch.ops import groupby as gb
    from arrow_tpu_torch.ops.groupby import (AggSpec, GroupByAccumulator,
                                             group_by)
    aggs = [AggSpec("v", op) for op in CONFIG4_AGGS]
    n, groups = CONFIG4_ROWS, 10_000_000
    table = config4_table(n, groups, dev)
    want = independent_groupby(table)
    groups_seen = want["k"].shape[0]
    plan = "resident" if n <= gb._SORT_AGG_CHUNK else \
        f"chunked by {gb._SORT_AGG_CHUNK:,} rows"
    _reset_counts()
    t0 = time.perf_counter()
    out = group_by(table, ["k"], aggs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts(f"config 4 500M x 10M group_by ({plan})",
                            "compact")
    check_config4(out, want, f"config 4 500M x 10M group_by, {plan} "
                             f"({secs:.3f} s first call)")
    del out
    resident_peak = peak_gib()
    gb_ms = time_ms(lambda: group_by(table, ["k"], aggs))

    # K1 as the sort plan launches it: row positions and first rows at
    # the run starts of the sorted keys
    keys = [table.column("k")]
    order, run_start, cap = gb._discover(keys, gb._scan(keys), n)
    arrays = (torch.arange(n, dtype=torch.int32, device=dev), order)
    got, got_n = kc.compact(run_start, arrays, out_cap=cap)
    plain, plain_n = kc.compact_plain(run_start, arrays, cap)
    torch.cuda.synchronize()
    count = int(plain_n)
    if int(got_n) != count or count != groups_seen:
        raise AssertionError(f"K1 run starts: count {int(got_n)}, plain "
                             f"{count}, groups {groups_seen}")
    err = max(_same_bits(a[:count], b[:count], "K1 run starts")
              for a, b in zip(got, plain))
    del got, plain
    print(f"K1 at the sort plan's run starts: {n:,} rows, {count:,} kept "
          f"({count / n:.1%}), out_cap {cap:,}; kernel and plain version "
          f"bitwise equal", flush=True)
    k1_ms = time_ms(lambda: kc.compact(run_start, arrays, out_cap=cap))
    k1_plain = time_ms(lambda: kc.compact_plain(run_start, arrays, cap))
    del order, run_start, arrays, keys, table
    print(f"config 4 500M x 10M: group_by {gb_ms:.4f} ms (CUDA events, "
          f"median of 5); K1 {k1_ms:.4f} ms vs plain {k1_plain:.4f} ms",
          flush=True)

    def stream():
        acc = GroupByAccumulator(["k"], aggs)
        for off in range(0, n, CONFIG4_CHUNK):
            acc.update(config4_table(min(CONFIG4_CHUNK, n - off), groups,
                                     dev, off))
        return acc.finalize()

    _reset_counts()
    out = stream()
    stream_launches = _read_counts(
        f"config 4 500M x 10M GroupByAccumulator ({CONFIG4_CHUNK:,}-row "
        "chunks made on the card)", "compact")
    check_config4(out, want, "config 4 500M x 10M GroupByAccumulator")
    stream_peak = peak_gib()
    del out, want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = stream()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    del out
    print(f"config 4 500M x 10M streamed: {stream_s * 1e3:.1f} ms (host "
          f"clock, second run, chunk generation included); peak device "
          f"memory {stream_peak:.2f} GiB (resident group_by: "
          f"{resident_peak:.2f} GiB)", flush=True)
    return {"launches": launches["compact"], "err": err, "ms": k1_ms,
            "plain_ms": k1_plain, "groupby_ms": gb_ms,
            "stream_launches": stream_launches["compact"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg, native
    from arrow_tpu_torch.ops.groupby import group_by

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    lib = native.library()
    print(f"kernels built in {lib.build_seconds:.2f} s (nvcc), loaded in "
          f"{time.perf_counter() - t0:.2f} s: {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    k1_err = check_compact(dev)
    table = groupby_table(GROUPBY_ROWS, dev)
    print(f"group-by table: {table.num_rows:,} rows on {dev}", flush=True)
    k2_err = check_groupagg(table)

    x_np, y_np = config1_inputs(CONFIG1_ROWS)
    torch.cuda.reset_peak_memory_stats()
    kc.compact.launches = 0
    kg.grouped_aggregate.launches = 0
    out, aggs = run_main_path(dev, x_np, y_np, table)
    launches = {"compact": kc.compact.launches,
                "grouped_aggregate": kg.grouped_aggregate.launches}
    print(f"launches over the main path: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    # the plain-version route: the same table on the CPU
    host = groupby_table_to(table, torch.device("cpu"))
    t0 = time.perf_counter()
    want = group_by(host, ["k"], aggs)
    print(f"group_by plain route (CPU): {time.perf_counter() - t0:.2f} s",
          flush=True)
    got_d, want_d = out.to_pydict(), want.to_pydict()
    if got_d != want_d:
        raise AssertionError("group_by on the card differs from the plain "
                             "route")
    if out.num_rows != GROUPS + 1:
        raise AssertionError(f"expected {GROUPS + 1} groups, got "
                             f"{out.num_rows}")
    print(f"group_by to_pydict equal to the plain route ({out.num_rows} "
          f"groups, first {got_d['k'][:2]} -> {got_d['v_sum'][:2]})",
          flush=True)

    # times at the main path's shapes
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    keep = x > 0
    k1_ms = time_ms(lambda: kc.compact(keep, (x, y)))
    k1_plain = time_ms(lambda: kc.compact_plain(keep, (x, y), x.shape[0]))
    codes, G, sums, mms = groupagg_slots(table)
    k2_ms = time_ms(lambda: kg.grouped_aggregate(codes, G, sums, mms,
                                                 decode=False))
    k2_plain = time_ms(lambda: kg.grouped_aggregate_plain(codes, G, sums,
                                                          mms))
    from arrow_tpu_torch import pipeline
    q_ms = time_ms(lambda: pipeline.query(x, y, 0))
    gb_ms = time_ms(lambda: group_by(table, ["k"], aggs))
    print(f"times (CUDA events, median of 5): K1 {k1_ms:.4f} ms vs plain "
          f"{k1_plain:.4f} ms; K2 {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms;"
          f" config-1 query {q_ms:.4f} ms; group_by 100M {gb_ms:.4f} ms",
          flush=True)

    del x, y, keep, codes, sums, mms, table, out, host, want
    c4_1k = run_config4_1k(dev)
    c4_10m = run_config4_10m(dev)

    k1 = {"name": "compact", "route": "cuda",
          "source": "arrow_tpu_torch/csrc/compact.cu",
          "replaces": "arrow_tpu/kernels/compact.py:46"}
    k2 = {"name": "grouped_aggregate", "route": "cuda",
          "source": "arrow_tpu_torch/csrc/groupagg.cu",
          "replaces": "arrow_tpu/kernels/groupagg.py:38"}
    kernels = [
        {**k1, "call_site": "config-1 filter, 10M rows",
         "launches": launches["compact"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {**k2, "call_site": "dictionary group_by, 100M rows x 1,001 codes",
         "launches": launches["grouped_aggregate"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
        {**k1, "call_site": "sort-plan run starts, config 4 500M x 10M",
         "launches": c4_10m["launches"], "max_abs_err": c4_10m["err"],
         "ms": c4_10m["ms"], "plain_ms": c4_10m["plain_ms"]},
        {**k2, "call_site": "small-domain plan, config 4 500M x 1K",
         "launches": c4_1k["launches"], "max_abs_err": c4_1k["err"],
         "ms": c4_1k["ms"], "plain_ms": c4_1k["plain_ms"]},
    ]
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
