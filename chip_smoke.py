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


def groupby_table(n: int, device: torch.device):
    """Config 4's shape on the device: an Int32 dictionary code column
    (10% null) over 1,000 Utf8 values shuffled against the codes, and
    v = hash % 1000 (bench.py's splitmix hash, 10% null)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table

    def lsr(x, k):                  # logical shift right on int64 storage
        return (x >> k) & ((1 << (64 - k)) - 1)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    codes = torch.randint(0, GROUPS, (n,), generator=gen, device=device,
                          dtype=torch.int32)
    kvalid = torch.rand(n, generator=gen, device=device) >= 0.1
    h = torch.arange(n, dtype=torch.int64, device=device) + 7
    h = (h ^ lsr(h, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    h = (h ^ lsr(h, 27)) * (0x94D049BB133111EB - (1 << 64))
    v = lsr(h, 32) % 1000
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

    kernels = [
        {"name": "compact", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/compact.cu",
         "replaces": "arrow_tpu/kernels/compact.py:46",
         "launches": launches["compact"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "grouped_aggregate", "route": "cuda",
         "source": "arrow_tpu_torch/csrc/groupagg.cu",
         "replaces": "arrow_tpu/kernels/groupagg.py:38",
         "launches": launches["grouped_aggregate"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
