"""Smoke run of the PyTorch port (arrow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Drives the port's main path at BASELINE sizes and checks every kernel:

  1. needs torch.cuda; prints the card's name and power limit
  2. builds the CUDA kernels from arrow_tpu_torch/csrc (nvcc, sm_90a)
  3. K1 compaction against its plain version at 10M rows: every dtype
     of the slice, selectivities 1/2, 0 and 1, and the positions
     output; bitwise on [:count]
  4. K2 grouped aggregation against its plain version at 100M rows, as
     the dictionary plan calls it (the key's codes and validity, the
     group_by's slots); sums, counts and order keys bitwise
  5. the config-1 query (WHERE x > 0: sum(y*2 + x), count(*)) through
     arrow_tpu_torch.pipeline at 10M rows, against a host float64 sum
     over the kept rows (rtol 1e-9: summation order) and the exact count
  6. the same query through Table / filter_table / mul / add / sum_
  7. group_by over a 1,000-value dictionary key at 100M rows against
     the plain-version route (the same table on the CPU)
  8. the kernels' launch counts over steps 5-7: both must be above 0
  9. kernel, plain and library times at the main path's shapes
 10. K1 at 100M rows with 0.1%, 2%, 50% and 100% kept: filter_table
     over an Int64 and a Float64 column (it must launch K1; its output
     equals `a[keep]`), then K1 over the same columns and the positions,
     bitwise against its plain version and against PyTorch's
     boolean-index compaction (`a[keep]`, `keep.nonzero()`), with the
     times of all three
 11. the sort plan's K2 call site: 100M rows, keys (h % 1000) << 20 span
     more than K2's 1,024 codes, so group_by sorts them and takes K2 for
     the min/max of v over the 1,000 groups; it must launch K2 and
     equal an independent computation; then K2 at its inputs bitwise
     against its plain version
 12. BASELINE config 4, 500M rows x 1K groups: Int64 keys h % 1000 and
     values (h >> 32) % 1000 from bench.py's splitmix hash, made on the
     card; a resident group_by [sum, count, min, max] on the
     small-domain plan, held against an independent computation
     (torch.unique + index_add_ / scatter_reduce_, exact); it must
     launch K2; then K2 at this shape (the Int64 key read as it is)
     against its plain version
 13. config 4, 500M rows x 10M groups: a resident group_by on the sort
     plan (it must launch K1), against the same kind of independent
     computation; then K1 at its run-start compaction (the sorted
     order and the positions) against its plain version
 14. the same 10M-group aggregate through GroupByAccumulator fed the
     125M-row chunks of bench.py:425-461 made on the card (K1 again),
     against the independent computation of step 13
 15. CUDA-event medians of the config-4 calls and the peak device
     memory of each; the tables are freed between steps
 16. BASELINE config 5, resident: 100M probe keys from bench.py's
     config-5 generator made on the card (hot h % 1024 or cold
     h % 20M by bit 40 of the hash) against the build keys
     arange(10M) * 2; join_indices inner, left, semi and anti on the
     index plan, each held against the closed form (probe row i
     matches build row k // 2 exactly when k is even); each is run with
     the launch counts at 0 and K1 must launch over the four; the inner
     join's CUDA-event median and probe rows/s
 17. K1 at the join's call sites, on the inputs the joins of steps 16
     and 18 gave it: the inner finish (the matched build rows and the
     probe positions), the semi and anti row lists (positions alone),
     the merge plan's run starts (positions alone) and the multi-key
     collision check; each bitwise against its plain version and timed
     against a[keep] / keep.nonzero()
 18. the merge plan at scale: the same probe keys against the build
     keys (arange(10M) // 2) * 2, each twice, so the duplicate check
     declines the index plan; against the closed form (rows k and k + 1
     when k is even and below 10M); K1 must launch (the run starts);
     then a two-column join whose
     mixer is made to collide on every pair of equal first keys, so
     the collision check compacts the pairs, against its closed form
 19. BASELINE config 5, streamed: HashJoiner over the build keys
     arange(100M) * 2 (the index plan), probed by eight 125M-row chunks
     made on the card through probe_count_device, accumulated on the
     device and synced every two chunks; pair count and build-row
     checksum against the closed form summed per chunk; build and
     streamed probe times on the host clock, synced
 20. BASELINE config 2, 10M rows from bench.py:181-193's generator
     (rng(1)): bench.py's run() (three casts, three comparisons, the
     dictionary predicate eq(dict, "word-0042")) eagerly, against closed
     forms (m1 false where i32 is valid, with i32's validity; m2 codes ==
     42; m3 all true), then through fuse (a CUDA graph), bitwise equal
     to the eager run; bench.py's ten-pass steady-state loop
     (bench.py:264-294) in one fused call, eager and fused equal to a
     numpy closed form; CUDA-event medians of all three
 21. config 2's WHERE (m1 OR m4) AND m2 AND m3 (m4 = gt_eq(cast(i32,
     int64), 0), bench.py:281) through or_kleene / and_kleene and
     filter_table over the three source columns: it must launch K1; its
     count and rows equal numpy's; then K1 at its inputs against its
     plain version and `a[keep]`
 22. BASELINE config 3, 100M rows made on the card (bench.py:344-349:
     keys _mix2(arange(n)), 10% null where h % 10 == 0, dictionary codes
     h % 1000): lexsort_to_indices ascending, nulls first, held to an
     independent O(n) check (a permutation; keys non-decreasing, nulls
     first; ties in ascending index); sort_table of the same table equal
     to take_table by those indices; CUDA-event medians and peak memory
 23. rank and partition over config 3's sorted Int64 column: each must
     launch K1, rank equals an independent searchsorted rank, partition
     the runs of the sorted keys; then K1 at rank's run starts and at
     partition's boundaries (positions alone) bitwise against its plain
     version and timed against keep.nonzero()
 24. a streamed dictionary GROUP BY at config 4's size: 500M rows in four
     125M-row chunks made on the card, each with a Dictionary<utf8> key
     over config 2's 1,000 words and a Dictionary<utf8> s over 100 more,
     both in a permutation of the chunk's own, and an Int32 v (10%
     null), through GroupByAccumulator: count_all, sum and mean of v
     (mean widens through cast), min and max of s (the string rank
     proxy).  Each chunk takes the dictionary plan (K2 must launch); the
     merge concatenates partials whose dictionaries differ and takes
     the sort plan (K1 must launch).  Equal, bit for bit, to bincount /
     index_add_ / scatter_reduce_ over each row's word id; host-clock
     time (synced, generation included) and peak memory; then K2 at a
     chunk's call and K1 at the merge's run starts against their plain
     versions
 25. device strings: config 2's dictionary decoded to a utf8 column on
     the card (bytes equal to the closed form) and encoded back (the
     words in order, the codes); group_by on the utf8 key (K2 must
     launch) against bincount over the codes; filter_table over i32, ts
     and the utf8 column at config 2's WHERE (about 0.04% kept) and at
     i32 > 0 (about 45%), one K1 launch each, offsets and bytes equal to
     a host numpy gather; every new function of ops/numeric,
     ops/aggregate, ops/bitwise and ops/select_misc on config 2's
     columns, bitwise equal to the same call on CPU copies; config 5's
     index-plan inner join (100M x 10M) whose build side carries the
     word of (k // 2) % 1000, the strings equal to the closed form;
     CUDA-event medians of each call, K1 at both filter sites and K2 at
     the group-by against their plain versions
 26. TPC-H lineitem's dates (spec 4.2.3) at SF5, 30M rows (cut from
     SF10's 60M to keep the script's time with phase 29) made on the
     card from splitmix: add_interval of the ship delay (month_day_nano
     days) equal to l_shipdate; Q1's cutoff (1998-12-01 minus 90 days as
     day_time, 1998-09-02) and filter_table of the dates table by
     lt_eq, one K1 launch, equal to a[keep]; every date part of
     l_shipdate, four of a timestamp[us, America/New_York] (a fixed
     offset where the card's machine has no tzdata) and four of receipt
     - ship as a duration; timestamp - timestamp and timestamp +
     duration against closed forms; one year_month month later (the
     end-of-month clamp); group_by year, quarter (K2 must launch) equal
     to bincount / index_add_ over datetime's calendar
 27. config 2's 10M rows with a column of every layout (List<Int64>,
     LargeList<Utf8>, Struct{Int32, Dictionary<Utf8>}, FixedSizeList,
     FixedSizeBinary(16), Decimal128(15, 2), IntervalMDN, a sparse
     union, RunEnd<Int32, Int64>): filter_table at the WHERE and at
     i32 > 0 (one K1 launch each), take_table by a permutation, concat
     of four slices equal to the whole, run_end_encode / decode round
     trips, union_extract, and decimal sum_, min_, max_, add, mul and lt
     at 1M rows; CUDA-event medians of each call, K1 and K2 at the new
     sites against their plain versions.  The calls of phases 26-27 are
     held to the same calls on CPU copies (all rows, bit for bit) after
     every kernel site is measured.
 28. TPC-H SF10 lineitem, 59,986,052 rows made on the card by the
     spec's rules (orders of 1-7 lines under sparse keys, prices from
     the part keys, l_quantity, l_extendedprice, l_discount and l_tax as
     Decimal128(15, 2), the flags as Dictionary<Utf8>): group_by
     (l_discount, l_tax) with count_all, sum and min / max of l_shipdate
     on the sort plan (K1 and K2 must launch), equal to bincount /
     index_add_ / scatter_reduce_ over disc * 9 + tax; sort_table by
     l_extendedprice descending, then l_orderkey, held to an O(n) check;
     rank of l_extendedprice (K1) equal to a searchsorted rank of the
     generator's cents; group_by over run_end_encode(l_orderkey), 15M
     groups (K1), equal to the generator's line counts; at 500K rows (cut:
     a Python key per row) a struct {l_returnflag, l_linestatus} key
     through group_by (K1) and sort_table, a List<Int64> key through
     sort_to_indices against Python's stable sort; at 10M rows on the
     card the list, struct, run-end (runs kept) and interval casts; at
     500K rows (cut: host parsing and formatting) the text round trips of
     l_shipdate, an Int64, a Float64 (bits) and a month_day_nano, utf8 ->
     timestamp[us] against its closed form, base64; RowConverter over
     config 2's 10M rows (convert_rows gives back every column,
     Rows.argsort equals lexsort_to_indices).  Every call is held to the
     same call on CPU copies over the first 1,000,000 rows of its inputs
     (100,000 for the host-ranked keys and the text casts; cut: the CPU
     route over 60M rows took two minutes), on the card and on the CPU
     alike; K1 and K2 at the new sites against their plain versions.
 29. TPC-H SF10's string predicates: part (2M rows), supplier (100K),
     customer (1.5M) and orders (15M) string columns made on the host
     with numpy by the spec's rules (4.2.3; text cut from a pool of the
     4.2.2.13-14 grammar, about 730 MB of o_comment), built as pyarrow
     tables and brought onto the card by table_from_pyarrow (each
     round-trips through table_to_pyarrow): Q9's contains / like green,
     Q20's starts_with forest, Q14's like PROMO%, Q2's ends_with BRASS,
     Q16's nlike MEDIUM POLISHED%, neq Brand#45 and like
     %Customer%Complaints%; Q13's nlike %special%requests% (and its
     regexp_is_match negation and ilike) over utf8, then over the
     large_utf8, binary and utf8_view casts, filter_table of orders with
     the large_utf8 comment aboard (one K1 launch) and group_by
     o_custkey count_all (the sort plan, K1 at its run starts) against
     bincount; Q22's substring(c_phone, 0, 2), dictionary_encode and
     group_by with count_all and sum(c_acctbal) (K2, dictionary plan)
     against bincount / add.at, printed by pretty_format_table; upper /
     lower of p_type, length / octet_length / bit_length of o_comment,
     concat_elements(p_brand, p_container), concat of four slices of
     the large_utf8 comment, take by a permutation, regexp_match at 1M
     rows (cut: a Python list a row).  Every output equals
     pyarrow.compute over the source tables and its closed form; every
     call is held to the same call on CPU copies; the calls' first runs
     go through op_timer, whose report is printed; o_comment's copy to
     the host is timed apart.
 30. TPC-H SF10 lineitem with all 16 columns of the spec (59,986,052
     rows, about 9 GB on the card: phase 28's columns, l_partkey,
     l_suppkey by 4.2.3's formula, the commit and receipt dates,
     l_shipinstruct and l_shipmode as Dictionary<Int32, Utf8>, l_comment
     of 10-43 bytes cut from phase 29's text pool, made on the card)
     through the file layer: write_parquet (snappy, dictionary,
     1,048,576-row row groups, statistics, page index); pyarrow reads
     each row group equal to the source rows; pyarrow writes the rows it
     takes from the port's export_stream (decimals as FLBA(7)) and
     read_parquet of that file onto the card equals the source (the last
     offset of l_comment below 2^31; filter_table of it takes
     range_gather's int32 index, as INDEX32_LIMIT says); Q6's scan
     (RowFilter over l_shipdate, l_discount, l_quantity; l_extendedprice
     read by the rows kept) with K1 in every row group at both sites and
     sum(l_extendedprice * l_discount) equal to the generator's cents;
     Q1's scan (RowFilter l_shipdate <= 1998-09-02) and group_by
     l_returnflag, l_linestatus (count, min and max of l_shipdate and
     l_receiptdate) on the dictionary plan (K2) equal to bincount /
     scatter_reduce_ over the generator's codes; write_file with LZ4 and
     read_file onto the card, write_stream and a StreamDecoder fed 64 MB
     pieces, each batch equal; import_stream of a pyarrow reader over the
     port's file, equal; the first four row groups read on the CPU route
     and the two scans over them, equal to the card's bit for bit; a
     plain ParquetReaderBuilder scan of those row groups with the
     row-group prefetch, on a side stream, equal to one without.  Each
     scan's K1 launches equal its K1 calls, every keep mask on the card.
     Each call's seconds on the host clock (synced), the file sizes, the
     peak device memory, the host's available memory before and after
     the phase and its lowest reading after a step; then K1 at the four
     scan sites (row group 0) and K2 at Q1's group_by against their plain
     versions.  Phase 30 is not traced with --profile (host-bound).
 31. TPC-H SF1 through the text formats: lineitem (6,001,215 rows, 16
     columns) and orders (one row per generated order, 9 columns) made
     on the card in the types the CSV reader gives dbgen's text (money
     Float64, dates Date32, flags and text utf8; `tpch_tables`):
     write_csv with '|' read back by pyarrow.csv equal to the source and
     by read_csv onto the card equal to the source; the same for
     write_json (lines) against pyarrow.json and read_json; write_avro /
     read_avro of the first 100,000 rows (cut: the writer encodes a
     Python value a cell) equal to the source; checkpoint_table /
     restore_table.  Each step's seconds on the host clock (synced)
     and the bytes written.
 32. TPC-H SF10 as SQL text: lineitem (59,986,052 rows), orders (one row
     per generated order), customer (1,500,000) and nation (25) at every
     column, made on the card (money Float64, flags, modes, priorities,
     clerks and segments Dictionary<Int32, Utf8>, the comments a join
     repeats large_utf8); Q1, Q3, Q6 and Q10 (`P32_QUERIES`) through
     execute_sql, each run with the launch counts at 0 (every K1 call
     on the card launched once, K1 launched), held to pyarrow over host
     copies (keys, counts and row order exactly, float sums within rtol
     1e-9), then timed (CUDA events, tables resident) with its peak
     memory; Q1 at 1M rows on the CPU route equal to the card's; then
     K1 at Q6's WHERE, Q1's and Q3's sort-plan run starts and Q3's
     joins against its plain version.  Q1's float sums take the sort
     plan: K2 sums integers only, so phase 32 launches no K2.
 33. TPC-H SF10 served: phase 32's four tables made again on the card
     (phase 32's freed first) and registered with a FlightSQLServer on
     the card at grpc://localhost:0; a FlightSQLClient on the card asks
     for Q1, Q3, Q4, Q6 and Q10 as SQL text, each with the launch
     counts at 0 around the call (every K1 and K2 call the server made
     on the card launched once; Q1, Q3, Q6 and Q10 launch K1, Q4 K2),
     its answer equal to execute_sql's in process (bit for bit where two
     direct runs agree, else within rtol 1e-9) and to pyarrow's; the
     served call's host-clock median of 5 beside the direct call's host
     and CUDA-event medians.  orders (14,998,113 rows) through DoGet by
     the port's client and by pyarrow.flight's, and back by the port's
     DoPut under a new name (it lands on the card), each equal to its
     source, with seconds and GB/s; CREATE TABLE and four clients
     inserting at once (the count exact: the update lock); a prepared
     Q4 with its dates bound; ActionCancelQuery; the CLI's flight-sql of
     Q6 equal to pretty_format_table of the direct answer, parquet-read
     and pretty with --device cuda over an SF1 orders Parquet file the
     phase writes; then K1 at served Q6's WHERE and K2 at served Q4's
     grouping against their plain versions.
 34. the distributed operators (arrow_tpu_torch/parallel) over a
     LocalMesh of 8 shards on the one card, a thread a shard (the
     reference's 8-device mesh; NCCL refuses two ranks on one GPU):
     dryrun_multichip(8, "cuda") and its host-truth checks; config 4's
     500M rows (keys h % 1,000, then h % 10M) through dist_group_by with
     a shuffle cap of 1.25 times the uniform share (raised to the
     largest bucket, printed) and a group cap from the key domain, equal
     to the single-device group_by of the same rows (computed first, its
     groups kept on the host); config 3's 100M Int64 keys (10% null)
     through dist_sort with the row ids riding, equal as a sequence to
     one stable torch.sort; config 5's 100M probe x 10M unique build
     rows (cut from 1B x 100M: eight shards of one card hold what eight
     hosts would) through dist_join_unique and dist_join, and Zipf(1.1)
     probe keys through dist_join_skew, every matched pair equal to the
     single-device join_indices; TPC-H SF1 (phase 31's generators)
     through dist_table_group_by (l_returnflag, l_linestatus),
     dist_table_sort (l_shipdate descending, l_orderkey) and
     dist_table_join (lineitem and orders on l_orderkey), equal to
     group_by, sort_table and join; dist_group_by through
     ProcessGroupComm over NCCL at world size 1 in this process, equal to
     a one-shard LocalMesh.  Each step's seconds on the host clock
     (synced) and the phase's peak device memory; then K1 at the run
     starts of local_group_aggregate, at dist_join_skew's
     _compact_front and at the three table calls' trims against its
     plain version.
 35. the port's scaling harness (tools_torch/bench_scaling.py; the
     reference's tools/bench_scaling.py): its five operators
     (dist_group_by, dist_sort, dist_join_unique, dist_join_skew, a
     group-by then a sort) with the reference's capacities over a
     LocalMesh of 1, 2, 4 and 8 shards on the card, 2^18 rows a shard
     (the reference's default) drawn as the reference draws them, one
     warm and one timed run each; every operator's answer at N shards
     (the valid groups' keys and sums, the valid keys in order, the
     matched values) equal to its answer over the same rows on one
     shard, no overflow flag raised; K1 must launch; the harness's JSON
     (rows/s, efficiency, throughput retention, peak memory, overflow
     by shard count); then K1 at the 8-shard group-by's run starts
     against its plain version.  With --profile, one 8-shard
     dist_group_by at 2^18 and at 2^21 rows a shard split into the
     device time of its exchange and of its local sort and aggregate,
     beside the call's wall time and the card's idle share.

`--profile` also traces the dictionary and config-4 group-bys, the
config-5 joins on both plans, one streamed chunk, config 2 (eager and
fused), config 3 (lexsort, sort_table), phase 24's streamed run,
phase 25's decode, encode, filters and join and every call of phases
26-29 on the card (not the host-bound ones) with torch.profiler and
prints, for each, the device time per kernel, the host wall time and
the card's idle share; a breakdown whose trace drops a K1 or K2 launch
is taken again, and printed null when no trace is complete.

Times: `ms` is the median CUDA-event time of the wrapper's call (host
work included), `kernel_ms` the kernel's device time per call from
torch.profiler (null when no trace held every launch), `plain_ms` / `library_ms` the plain version's and the
PyTorch call's; `bound_ms` is the bytes the call must move (each input
read once, each output written once) over 3.35 TB/s, computed from this
run's inputs.  `launches` is the kernel's count over the main-path run
of the step that holds the call site: steps 5-7 for the config-1 and
dictionary entries, the filter_table call at the same kept share for
the sweep entries, steps 11, 12 and 13 for the group-by entries, and
the join call that holds the site for the join entries (the inner
join; the semi and anti joins; the merge-plan join; the colliding
two-column join), the filter_table call of config 2's WHERE, the
rank and partition calls of step 23, the first streamed run of step 24,
the group_by and filter_table calls of steps 25-27, the group_by and
rank calls of step 28, Q13's filter_table and group_by and Q22's
group_by in step 29, and in step 30 the calls each scan site made over
its scan (one a row group; the scan's launch count equals the two
sites' calls) and the launches of Q1's group_by; in steps 32 and 33 the
calls of the query that holds the site (in step 33 the served query,
its kernels launched on the server's gRPC worker threads); in step 34
the call over the mesh that holds the site (config 4's 10M-group
dist_group_by: one run-start launch a shard; dist_join_skew: one a
shard; each table call: its trim, and the group-by's run starts), from
all eight shards' threads; in step 35 the 8-shard group_by's warm and
timed runs, eight shards each.

Any failure raises and exits non-zero.  The line before the last is a
JSON object of per-kernel results; the last line is the JSON result
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, dense HBM3 peak
SEED = 0
CONFIG1_ROWS = 10_000_000          # BASELINE config 1 (bench.py:94-97)
DICT_ROWS = 100_000_000            # the dictionary group-by, cut from 500M
GROUPS = 1_000                     # config 4's 1K-group cardinality
CONFIG4_ROWS = 500_000_000         # BASELINE config 4 (bench.py:395-491)
CONFIG4_CHUNK = 125_000_000        # its streamed chunks (bench.py:425)
CONFIG4_AGGS = ("sum", "count", "min", "max")      # bench.py:419-420
SWEEP_ROWS = 100_000_000
SWEEP_SHARES = (0.001, 0.02, 0.5, 1.0)
SORT_K2_ROWS = 100_000_000         # keys (h % 1000) << 20: sort plan, G 1,000
CONFIG5_PROBE = 100_000_000        # BASELINE config 5 resident (bench.py:573)
CONFIG5_BUILD = 10_000_000
CONFIG5_STREAM = 1_000_000_000     # config 5 streamed (bench.py:618)
CONFIG5_STREAM_BUILD = 100_000_000
CONFIG5_CHUNK = 125_000_000
HOWS = ("inner", "left", "semi", "anti")
CONFIG2_ROWS = 10_000_000          # BASELINE config 2 (bench.py:181)
CONFIG2_PASSES = 10                # its steady-state loop (bench.py:264)
CONFIG3_ROWS = 100_000_000         # BASELINE config 3 (bench.py:339)


# ---- measurement ---------------------------------------------------------

def time_ms(fn: Callable, reps: int = 5) -> float:
    """Median CUDA-event time of `fn` over `reps` runs after a warm-up:
    the call as its caller sees it, host work included."""
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


def _profile(fn: Callable, reps: int):
    """torch.profiler's trace of `reps` calls of `fn`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def native_trace(fn: Callable, reps: int = 3):
    """torch.profiler's key averages over `reps` calls of K3's native
    routine after a warm-up.  The profiler now and then returns a trace
    holding only some of the kernels launched in it: the trace must hold
    one key_kernel for each pass the calls ran (the counter
    strings.native_passes), else it is taken again, at most three times;
    None when none was complete."""
    from arrow_tpu_torch.utils import trace
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        before = trace.counters_snapshot().get("strings.native_passes", 0)
        averages = _profile(fn, reps).key_averages()
        passes = trace.counters_snapshot().get("strings.native_passes",
                                               0) - before
        traced = sum(e.count for e in averages if "key_kernel" in e.key)
        if traced == passes > 0:
            return averages
        print(f"native_trace: trace {attempt} holds {traced} key_kernel "
              f"launches of {passes} passes", flush=True)
    return None


def kernel_ms(fn: Callable, name: Optional[str], wrapper, reps: int = 3
              ) -> Optional[float]:
    """Device time per call of the kernels whose name holds `name` (of
    every kernel of a complete `native_trace` when `name` is None: a
    native call that launches many), from torch.profiler over `reps`
    calls after a warm-up.  The profiler now and then returns a trace
    holding only some of the kernels launched in it, or none: a trace
    that holds fewer such kernels than `wrapper` counted launches is
    taken again, at most three times; None when none was complete."""
    if name is None:
        averages = native_trace(fn, reps)
        return None if averages is None else sum(
            e.device_time_total for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        before = wrapper.launches
        events = [e for e in _profile(fn, reps).key_averages()
                  if name in e.key]
        launched = wrapper.launches - before
        traced = sum(e.count for e in events)
        if traced == launched > 0:
            return sum(e.device_time_total for e in events) / 1e3 / reps
        print(f"kernel_ms: trace {attempt} of {name} holds {traced} of "
              f"{launched} launches", flush=True)
    return None


def profile_call(what: str, fn: Callable) -> None:
    """Device time by kernel per call (torch.profiler over 3 calls), the
    host wall median of 5 synced calls and the idle share between.  As
    in `kernel_ms`, a trace that holds fewer K1 or K2 kernels than their
    wrappers counted launches is taken again, at most three times; the
    breakdown is null when none was complete.  Dropped kernels of
    PyTorch's own go uncounted: no wrapper counts them."""
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
    wrappers = (("compact_kernel", kc.compact),
                ("groupagg_kernel", kg.grouped_aggregate))
    fn()
    torch.cuda.synchronize()
    per = None
    for attempt in range(1, 4):
        before = [w.launches for _, w in wrappers]
        events = _profile(fn, 3).key_averages()
        launched = [w.launches - b for (_, w), b in zip(wrappers, before)]
        traced = [sum(e.count for e in events if name in e.key)
                  for name, _ in wrappers]
        if traced == launched:
            per = sorted(((e.device_time_total / 3e3, e.key) for e in events
                          if e.device_time_total > 0), reverse=True)
            break
        print(f"profile_call: trace {attempt} of {what} holds {traced} of "
              f"{launched} K1, K2 launches", flush=True)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    device = None if per is None else sum(ms for ms, _ in per)
    print(f"profile {what}: " + json.dumps(
        {"wall_ms": wall, "device_ms": device,
         "idle_share": None if per is None else 1 - device / wall,
         "top": None if per is None
         else [[k[:60], round(ms, 4)] for ms, k in per[:12]]}), flush=True)


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move `nbytes`."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors given (None ignored)."""
    seen = {}
    for t in tensors:
        if t is not None:
            seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


# ---- inputs --------------------------------------------------------------

def _lsr(x, k):
    """Logical shift right on int64 storage."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix2(h: torch.Tensor) -> torch.Tensor:
    """bench.py's two splitmix rounds, u64 bits in int64 storage."""
    h = (h ^ _lsr(h, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    return (h ^ _lsr(h, 27)) * (0x94D049BB133111EB - (1 << 64))


def splitmix(n: int, offset: int, device) -> torch.Tensor:
    """bench.py's hash of i = arange(n) + offset + 7 (bench.py:408-414),
    u64 bits in int64 storage."""
    return _mix2(torch.arange(n, dtype=torch.int64, device=device)
                 + (offset + 7))


def _umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """u64 h % m on int64 storage."""
    return ((_lsr(h, 1) % m) * 2 + (h & 1)) % m


def config1_inputs():
    """bench.py config1's generator: x in [-1000, 1000), y in [0, 1)."""
    rng = np.random.default_rng(SEED)
    return (rng.integers(-1000, 1000, CONFIG1_ROWS).astype(np.int64),
            rng.random(CONFIG1_ROWS))


def config4_table(n: int, groups: int, device, offset: int = 0,
                  shift: int = 0):
    """Config 4's table on the device (bench.py:408-417): Int64 k = h %
    groups (unsigned) << shift, v = (h >> 32) % 1000, no nulls."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    h = splitmix(n, offset, device)
    k = _umod(h, groups)
    v = _lsr(h, 32) % 1000
    del h
    return Table([PrimitiveColumn(k << shift, dt.int64),
                  PrimitiveColumn(v, dt.int64)],
                 dt.Schema((dt.Field("k", dt.int64, nullable=False),
                            dt.Field("v", dt.int64, nullable=False))))


def dictionary_table(n: int, device):
    """The dictionary group-by's table: an Int32 dictionary code column
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
    v = _lsr(splitmix(n, 0, device), 32) % 1000
    vvalid = torch.rand(n, generator=gen, device=device) >= 0.1
    perm = np.random.default_rng(SEED).permutation(GROUPS)
    words = StringColumn.from_pylist([f"key{i:04d}" for i in perm],
                                     device=device)
    return Table([DictionaryColumn(codes, words, kvalid),
                  PrimitiveColumn(v, dt.int64, vvalid)],
                 dt.Schema((dt.Field("k", dt.dictionary(dt.int32, dt.utf8)),
                            dt.Field("v", dt.int64))))


def sweep_table(dev, share: float):
    """SWEEP_ROWS rows of an Int64 x and a Float64 y, and a mask keeping
    `share` of them at random."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    n = SWEEP_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    keep = torch.rand(n, generator=gen, device=dev) < share
    return Table([PrimitiveColumn(x, dt.int64), PrimitiveColumn(y, dt.float64)],
                 dt.Schema((dt.Field("x", dt.int64, nullable=False),
                            dt.Field("y", dt.float64, nullable=False)))), keep


def config5_keys(n: int, offset: int, domain: int, device) -> torch.Tensor:
    """bench.py's config-5 probe keys (bench.py:576-584,626-637): h is two
    splitmix rounds of i = arange(n) + offset; the hot key h % 1024 where
    bit 40 of h is 0, else the cold key h % domain (u64 modulo)."""
    h = _mix2(torch.arange(n, dtype=torch.int64, device=device) + offset)
    return torch.where((_lsr(h, 40) & 1) == 0, h & 1023, _umod(h, domain))


def key_table(**cols):
    """A table of non-null Int64 columns."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    return Table([PrimitiveColumn(v, dt.int64) for v in cols.values()],
                 dt.Schema(tuple(dt.Field(name, dt.int64, nullable=False)
                                 for name in cols)))


# ---- call sites ----------------------------------------------------------

@dataclass
class Site:
    """One call site of a kernel: `run` calls the kernel's wrapper as the
    site calls it, `plain` its plain version and `library` one PyTorch
    call computing the same function (None: there is none), all on the
    same inputs; `bytes` is what the function must move."""
    kernel: str                # "compact" | "grouped_aggregate" | "strkey"
    call_site: str
    run: Callable
    plain: Callable
    library: Optional[Callable]
    bytes: int

    def measure(self) -> dict:
        from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
        from arrow_tpu_torch.kernels import strkey as ks
        name, wrapper = {
            "compact": ("compact_kernel", kc.compact),
            "grouped_aggregate": ("groupagg_kernel", kg.grouped_aggregate),
            "strkey": (None, ks.strrank)}[self.kernel]
        out = {"name": self.kernel, "call_site": self.call_site,
               "ms": time_ms(self.run),
               "kernel_ms": kernel_ms(self.run, name, wrapper),
               "plain_ms": time_ms(self.plain),
               "library_ms": None if self.library is None
               else time_ms(self.library),
               "bound_ms": bound_ms(self.bytes), "bound_by": "bytes",
               "bytes": self.bytes}
        out["share"] = None if out["kernel_ms"] is None \
            else out["bound_ms"] / out["kernel_ms"]
        if out["share"] is not None and out["share"] > 1.05:
            raise AssertionError(
                f"{self.kernel} at {self.call_site}: {out['kernel_ms']} ms "
                f"of kernel for a {out['bound_ms']} ms bound")
        return out


def _compact_site(call_site, keep, arrays, cap, library,
                  positions=torch.int64) -> Site:
    """K1 over `arrays`, plus the kept rows' positions unless `positions`
    is None."""
    from arrow_tpu_torch.kernels import compact as kc
    count = int(keep.sum())
    full = keep.shape[0] if cap is None else cap
    moved = keep.numel() + count * (
        sum(a.element_size() for a in arrays) * 2
        + (0 if positions is None else positions.itemsize))
    return Site("compact", call_site,
                lambda: kc.compact(keep, arrays, out_cap=cap,
                                   positions=positions),
                lambda: kc.compact_plain(keep, arrays, full, positions),
                library, moved)


def _strkey_site(call_site: str, call) -> Site:
    """K3 at the inputs a watched strrank call was given: every row's
    sorted position, the passes run and the drops made.  The least bytes:
    the offsets and the rows' bytes read once, the positions written."""
    from arrow_tpu_torch.kernels import strkey as ks
    offsets, data, passes = call[0]
    moved = nbytes(offsets) + int(offsets[-1] - offsets[0]) \
        + (offsets.shape[0] - 1) * 4
    return Site("strkey", call_site,
                lambda: ks.strrank(offsets, data, passes),
                lambda: ks.strrank_plain(offsets, data, passes),
                None, moved)


def _same_ranks(got, want, what: str) -> float:
    """K3's (positions, passes, drops) equal to its plain loop's."""
    if got[1:] != want[1:]:
        raise AssertionError(f"{what}: passes and drops {got[1:]} != "
                             f"{want[1:]}")
    return _same_bits(got[0], want[0], what)


def k1_config1(dev) -> Site:
    """K1 as the config-1 query calls it: int64 x and float64 y, x > 0
    (about half kept), no cap."""
    from arrow_tpu_torch.kernels import compact as kc
    x_np, y_np = config1_inputs()
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    keep = x > 0
    count = int(keep.sum())
    return Site("compact", f"config-1 filter, {CONFIG1_ROWS:,} rows",
                lambda: kc.compact(keep, (x, y)),
                lambda: kc.compact_plain(keep, (x, y), x.shape[0]),
                lambda: (x[keep], y[keep]),
                keep.numel() + count * 32)


def k1_sweep(table, keep, share: float) -> Site:
    """K1 over the sweep's x and y and the positions."""
    x, y = table.column("x").values, table.column("y").values
    return _compact_site(f"sweep, {keep.shape[0]:,} rows, {share:.1%} kept",
                         keep, (x, y), None,
                         lambda: (x[keep], y[keep], keep.nonzero()))


def sort_plan_inputs(table):
    """The sort plan's sort of one key column: (order, run_start, cap)
    as ops/groupby.py::_discover gives them."""
    from arrow_tpu_torch.ops import groupby as gb
    keys = [table.column("k")]
    return gb._discover(keys, gb._scan(keys), table.num_rows)


def k1_run_starts(table) -> Site:
    """K1 as the sort plan calls it at the run starts: the sorted order
    and the positions, under the key domain's cap."""
    order, run_start, cap = sort_plan_inputs(table)
    return _compact_site(
        f"sort-plan run starts, {table.num_rows:,} rows", run_start,
        (order,), cap, lambda: (order[run_start], run_start.nonzero()))


def k2_dictionary(table) -> Site:
    """K2 as the dictionary plan calls it for [sum, count, min, max,
    count_all] of v: the key's codes and validity as they are."""
    from arrow_tpu_torch.kernels import groupagg as kg
    k, v = table.column("k"), table.column("v")
    G = len(k.values) + 1
    sums = [kg.SumCol(None), kg.SumCol(v.values, v.validity, v.dtype)]
    mms = [kg.MinMaxCol(v.values, v.validity, v.dtype)]
    moved = nbytes(k.codes, k.validity, v.values, v.validity) \
        + 8 * G * (1 + 2 * len(sums) + 2 * len(mms))
    return Site("grouped_aggregate",
                f"dictionary plan, {table.num_rows:,} rows x {G:,} codes",
                lambda: kg.grouped_aggregate(k.codes, G, sums, mms,
                                             decode=False,
                                             codes_valid=k.validity),
                lambda: kg.grouped_aggregate_plain(k.codes, G, sums, mms,
                                                   codes_valid=k.validity),
                None, moved)


def k2_small_domain(table) -> Site:
    """K2 as the small-domain plan calls it for config 4's [sum, count,
    min, max] of v over keys 0..999: the Int64 key read as it is."""
    from arrow_tpu_torch.kernels import groupagg as kg
    k, v = table.column("k").values, table.column("v").values
    sums, mms = [kg.SumCol(None), kg.SumCol(v)], [kg.MinMaxCol(v)]
    moved = nbytes(k, v) + 8 * GROUPS * (1 + 2 * len(sums) + 2)
    return Site("grouped_aggregate",
                f"small-domain plan, {table.num_rows:,} rows x 1,000 codes",
                lambda: kg.grouped_aggregate(k, GROUPS, sums, mms,
                                             decode=False, base=0),
                lambda: kg.grouped_aggregate_plain(k, GROUPS, sums, mms,
                                                   base=0),
                None, moved)


def k2_sort_plan(table) -> Site:
    """K2 as the sort plan calls it for the integer min/max over at most
    1,024 groups: group ids of the sorted rows and v in key order."""
    from arrow_tpu_torch.kernels import groupagg as kg
    order, run_start, _ = sort_plan_inputs(table)
    gid = torch.cumsum(run_start, 0, dtype=torch.int32) - 1
    G = int(gid[-1]) + 1
    vs = table.column("v").values[order]
    del order, run_start
    mms = [kg.MinMaxCol(vs, None, table.column("v").dtype)]
    return Site("grouped_aggregate",
                f"sort-plan min/max, {table.num_rows:,} rows x {G:,} groups",
                lambda: kg.grouped_aggregate(gid, G, mm_cols=mms,
                                             decode=False),
                lambda: kg.grouped_aggregate_plain(gid, G, [], mms),
                None, nbytes(gid, vs) + 16 * G)


# ---- checks --------------------------------------------------------------

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
    if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def same_compaction(got, want, what: str) -> float:
    """K1 outputs ((arrays, count) pairs) equal on [:count]."""
    (g, g_n), (w, w_n) = got, want
    count = int(w_n)
    if int(g_n) != count or len(g) != len(w):
        raise AssertionError(f"{what}: count {int(g_n)} != {count}")
    return max([_same_bits(a[:count], b[:count], f"{what} {a.dtype}")
                for a, b in zip(g, w)] or [0.0])


def same_aggregates(got, want, what: str) -> float:
    """K2 outputs (sums, counts, [(min keys, max keys)]) bitwise equal."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        err = max(err, _same_bits(a, b, f"{what} sum/count {i}"))
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        err = max(err, _same_bits(a0, b0, f"{what} min keys"))
        err = max(err, _same_bits(a1, b1, f"{what} max keys"))
    return err


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


def check_compact(dev) -> float:
    """Step 3."""
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
        got = kc.compact(keep, arrays)
        want = kc.compact_plain(keep, arrays, n)
        torch.cuda.synchronize()
        err = max(err, same_compaction(got, want, f"K1 p={p}"))
        print(f"K1 compact 10M x {len(arrays)} columns, selectivity {p}: "
              f"count {int(want[1])}, bitwise equal", flush=True)
    for positions in (torch.int32, torch.int64):
        got = kc.compact(keep, arrays[:2], positions=positions)
        want = kc.compact_plain(keep, arrays[:2], n, positions)
        torch.cuda.synchronize()
        err = max(err, same_compaction(got, want, f"K1 {positions}"))
    print("K1 compact 10M, int32 and int64 positions: bitwise equal",
          flush=True)
    return err


def check_site(site, same, what: str) -> float:
    """A call site's kernel against its plain version, bitwise."""
    got, want = site.run(), site.plain()
    torch.cuda.synchronize()
    err = same(got, want, what)
    del got, want
    print(f"{what}: kernel and plain version bitwise equal", flush=True)
    return err


# ---- steps ---------------------------------------------------------------

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


def _reset_counts():
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kc.compact.launches = 0
    kg.grouped_aggregate.launches = 0


def _read_counts(what: str, must: Optional[str]) -> dict:
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
    torch.cuda.synchronize()
    launches = {"compact": kc.compact.launches,
                "grouped_aggregate": kg.grouped_aggregate.launches}
    print(f"{what}: launches {launches}, peak device memory "
          f"{peak_gib():.2f} GiB", flush=True)
    if must is not None and launches[must] <= 0:
        raise AssertionError(f"{what} never launched {must}")
    return launches


def _entry(site, launches: int, err: float) -> dict:
    """The site's measurements as one entry of the kernels line."""
    m = site.measure()
    kernel = "not measured" if m["kernel_ms"] is None \
        else f"{m['kernel_ms']:.4f} ms"
    print(f"{site.kernel} at {site.call_site}: {m['ms']:.4f} ms "
          f"(kernel {kernel}), plain {m['plain_ms']:.4f} ms"
          f", library {m['library_ms']}, bound {m['bound_ms']:.4f} ms",
          flush=True)
    return {**m, "launches": launches, "max_abs_err": err}


def run_k1_sweep(dev):
    """Step 10."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.ops.filter import filter_table
    entries = []
    for share in SWEEP_SHARES:
        table, keep = sweep_table(dev, share)
        what = f"filter_table, {SWEEP_ROWS:,} rows, {share:.1%} kept"
        _reset_counts()
        out = filter_table(table, PrimitiveColumn(keep, dt.bool_))
        launches = _read_counts(what, "compact")
        for name in ("x", "y"):
            _same_bits(out.column(name).values,
                       table.column(name).values[keep], f"{what}: {name}")
        del out
        site = k1_sweep(table, keep, share)
        err = check_site(site, same_compaction, f"K1 {site.call_site}")
        got, lib = site.run(), site.library()
        torch.cuda.synchronize()
        (x_k, y_k, pos_k), count = got
        c = int(count)
        for a, b, name in ((x_k[:c], lib[0], "x"), (y_k[:c], lib[1], "y"),
                           (pos_k[:c], lib[2].squeeze(1), "positions")):
            _same_bits(a, b, f"K1 sweep {share} {name} against a[keep]")
        del got, lib
        entries.append(_entry(site, launches["compact"], err))
        del site, table, keep
    return entries


def run_sort_plan_k2(dev) -> dict:
    """Step 11."""
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    table = config4_table(SORT_K2_ROWS, GROUPS, dev, shift=20)
    want = independent_groupby(table)
    aggs = [AggSpec("v", op) for op in CONFIG4_AGGS]
    what = "sort plan with K2 min/max, 100M x 1K"
    _reset_counts()
    out = group_by(table, ["k"], aggs)
    launches = _read_counts(what, "grouped_aggregate")
    check_config4(out, want, what)
    del out, want
    gb_ms = time_ms(lambda: group_by(table, ["k"], aggs))
    site = k2_sort_plan(table)
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entry = _entry(site, launches["grouped_aggregate"], err)
    print(f"{what}: group_by {gb_ms:.4f} ms", flush=True)
    return entry


def run_config4_1k(dev, profile: bool) -> dict:
    """Step 12: 500M x 1K on the small-domain plan (one K2 pass)."""
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    aggs = [AggSpec("v", op) for op in CONFIG4_AGGS]
    table = config4_table(CONFIG4_ROWS, GROUPS, dev)
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
    if profile:
        profile_call("config 4 500M x 1K",
                     lambda: group_by(table, ["k"], aggs))
    k = table.column("k").values
    if int(k.min()) != 0 or int(k.max()) != 999:
        raise AssertionError("config 4 1K keys do not span [0, 999]")
    site = k2_small_domain(table)
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entry = _entry(site, launches["grouped_aggregate"], err)
    del site, k, table
    print(f"config 4 500M x 1K: group_by {gb_ms:.4f} ms (CUDA events, "
          f"median of 5); peak device memory {peak_gib():.2f} GiB",
          flush=True)
    return entry


def run_config4_10m(dev, profile: bool) -> dict:
    """Steps 13-14: 500M x 10M resident on the sort plan, then streamed
    through GroupByAccumulator."""
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
    if profile:
        profile_call("config 4 500M x 10M resident",
                     lambda: group_by(table, ["k"], aggs))

    site = k1_run_starts(table)
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    count = int(site.run()[1])
    if count != groups_seen:
        raise AssertionError(f"K1 run starts: count {count}, groups "
                             f"{groups_seen}")
    entry = _entry(site, launches["compact"], err)
    del site, table
    print(f"config 4 500M x 10M: group_by {gb_ms:.4f} ms (CUDA events, "
          f"median of 5)", flush=True)

    def stream():
        acc = GroupByAccumulator(["k"], aggs)
        for off in range(0, n, CONFIG4_CHUNK):
            acc.update(config4_table(min(CONFIG4_CHUNK, n - off), groups,
                                     dev, off))
        return acc.finalize()

    _reset_counts()
    out = stream()
    _read_counts(f"config 4 500M x 10M GroupByAccumulator "
                 f"({CONFIG4_CHUNK:,}-row chunks made on the card)",
                 "compact")
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
    return entry


@contextlib.contextmanager
def watch(name: str, module: str = "join"):
    """Record (args, kwargs) of each call of
    arrow_tpu_torch.ops.<module>.<name> (arrow_tpu_torch.<module>.<name>
    for a dotted module) made inside the block, from any thread."""
    import importlib
    mod = importlib.import_module(
        f"arrow_tpu_torch.{module}" if "." in module
        else f"arrow_tpu_torch.ops.{module}")
    real, calls = getattr(mod, name), []

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        setattr(mod, name, real)


def check_pairs(got, want, what: str) -> int:
    """Row ids equal to the closed form, exactly; returns the pairs."""
    for g, w, side in zip(got, want, ("left", "right")):
        if g.dtype != torch.int64 or g.shape != w.shape \
                or not torch.equal(g, w):
            raise AssertionError(f"{what}: {side} row ids differ from the "
                                 f"closed form ({tuple(g.shape)} against "
                                 f"{tuple(w.shape)})")
    return int(got[0].shape[0])


def config5_closed_form(k: torch.Tensor, how: str):
    """Probe row i matches build row k // 2 of the build keys
    arange(10M) * 2 exactly when k is even (every key is below 20M)."""
    even = (k & 1) == 0
    if how == "left":
        return (torch.arange(k.shape[0], device=k.device),
                torch.where(even, k >> 1, -1))
    rows = (even if how != "anti" else ~even).nonzero().squeeze(1)
    return rows, (k[rows] >> 1 if how == "inner"
                  else torch.full_like(rows, -1))


def _k1_call(calls, arity: int):
    """(keep, arrays, out_cap, positions) of the first K1 call of a join
    over `arity` arrays."""
    for args, kwargs in calls:
        if len(args[1]) == arity:
            return (args[0], tuple(args[1]), kwargs.get("out_cap"),
                    kwargs.get("positions"))
    raise AssertionError(f"the join made no K1 call over {arity} arrays")


def run_config5_resident(dev, profile: bool):
    """Steps 16-18: the resident joins and K1 at the join's call sites."""
    from arrow_tpu_torch.ops.join import join_indices
    from arrow_tpu_torch.ops import join as pj
    k = config5_keys(CONFIG5_PROBE, 0, 2 * CONFIG5_BUILD, dev)
    left = key_table(k=k)
    right = key_table(k=torch.arange(CONFIG5_BUILD, device=dev) * 2)
    what = f"config 5 {CONFIG5_PROBE // 10 ** 6}M x " \
        f"{CONFIG5_BUILD // 10 ** 6}M"
    launches, calls = {}, {}
    for how in HOWS:
        _reset_counts()
        with watch("compact") as calls[how]:
            got = join_indices(left, right, ["k"], how)
        launches[how] = _read_counts(f"{what} {how} join", None)["compact"]
        pairs = check_pairs(got, config5_closed_form(k, how),
                            f"{what} {how}")
        print(f"{what} {how} join: {pairs:,} rows, equal to the closed "
              f"form", flush=True)
        del got
    if sum(launches.values()) <= 0:
        raise AssertionError(f"{what}: the joins never launched compact")
    finish = _k1_call(calls["inner"], 1)
    if finish[1][0].dtype != torch.int32:
        raise AssertionError(f"{what}: the inner join did not take the "
                             f"index plan's finish")
    lists = _k1_call(calls["semi"], 0)
    del calls
    peak = peak_gib()
    join_ms = time_ms(lambda: join_indices(left, right, ["k"]))
    print(f"{what} inner join (index plan): {join_ms:.4f} ms (CUDA events, "
          f"median of 5), {CONFIG5_PROBE / join_ms * 1e3:.4g} probe rows/s;"
          f" peak device memory {peak:.2f} GiB", flush=True)
    if profile:
        profile_call(f"{what} inner join",
                     lambda: join_indices(left, right, ["k"]))

    keep, arrays, cap, pos = finish
    s1 = _compact_site(f"join inner finish, index plan, "
                       f"{CONFIG5_PROBE:,} probe rows", keep, arrays, cap,
                       lambda: (arrays[0][keep], keep.nonzero()), pos)
    keep2, _, cap2, pos2 = lists
    s2 = _compact_site(f"join semi/anti row lists (positions alone), "
                       f"{CONFIG5_PROBE:,} rows", keep2, (), cap2,
                       lambda: keep2.nonzero(), pos2)
    entries = []
    for site, n in ((s1, launches["inner"]),
                    (s2, launches["semi"] + launches["anti"])):
        err = check_site(site, same_compaction, f"K1 at {site.call_site}")
        entries.append(_entry(site, n, err))
    del s1, s2, finish, lists, keep, arrays, keep2, right

    # step 18: the merge plan, each build key twice
    right = key_table(k=(torch.arange(CONFIG5_BUILD, device=dev) // 2) * 2)
    even = ((k & 1) == 0) & (k < CONFIG5_BUILD)
    rows = even.nonzero().squeeze(1)
    want = (rows.repeat_interleave(2),
            torch.stack([k[rows], k[rows] + 1], 1).reshape(-1))
    del even, rows
    _reset_counts()
    with watch("_merge_stage") as merges, watch("compact") as calls:
        got = join_indices(left, right, ["k"])
    n = _read_counts(f"{what} inner join, merge plan", "compact")["compact"]
    if len(merges) != 1:
        raise AssertionError(f"{what}: the repeated build keys did not "
                             f"take the merge plan")
    del merges
    pairs = check_pairs(got, want, f"{what} merge plan")
    del got, want
    peak = peak_gib()
    keep, arrays, cap, pos = _k1_call(calls, 0)
    del calls
    site = _compact_site(f"join merge-plan run starts (positions alone), "
                         f"{keep.shape[0]:,} sorted rows", keep, arrays, cap,
                         lambda: keep.nonzero(), pos)
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, n, err))
    del site, keep
    merge_ms = time_ms(lambda: join_indices(left, right, ["k"]))
    print(f"{what} inner join, merge plan (each build key twice): "
          f"{pairs:,} pairs equal to the closed form; {merge_ms:.4f} ms "
          f"(CUDA events, median of 5); peak device memory {peak:.2f} GiB",
          flush=True)
    if profile:
        profile_call(f"{what} inner join, merge plan",
                     lambda: join_indices(left, right, ["k"]))
    del right

    # the collision check: column j is left out of the fold
    i = torch.arange(CONFIG5_PROBE, device=dev)
    left2 = key_table(k=k, j=i & 1)
    r = torch.arange(CONFIG5_BUILD, device=dev)
    right2 = key_table(k=r * 2, j=(r >> 1) & 1)
    del r
    m = ((k & 1) == 0) & ((i & 1) == ((k >> 2) & 1))
    rows = m.nonzero().squeeze(1)
    want = (rows, k[rows] >> 1)
    del i, m, rows
    real_fold = pj._fold
    pj._fold = lambda keys: keys[0]
    try:
        _reset_counts()
        with watch("compact") as calls:
            got = join_indices(left2, right2, ["k", "j"])
        n = _read_counts(f"{what} two-column join, colliding mixer",
                         "compact")["compact"]
    finally:
        pj._fold = real_fold
    pairs = check_pairs(got, want, f"{what} colliding two-column join")
    print(f"{what} two-column join with the mixer colliding on every "
          f"equal first key: {pairs:,} pairs equal to the closed form",
          flush=True)
    del got, want, left2, right2
    keep, arrays, cap, pos = _k1_call(calls, 2)
    del calls
    s3 = _compact_site(f"join collision check, {keep.shape[0]:,} candidate "
                       f"pairs", keep, arrays, cap,
                       lambda: tuple(a[keep] for a in arrays), pos)
    err = check_site(s3, same_compaction, f"K1 at {s3.call_site}")
    entries.append(_entry(s3, n, err))
    return entries


def run_config5_stream(dev, profile: bool) -> None:
    """Step 19: 1B probe rows streamed through HashJoiner."""
    from arrow_tpu_torch.ops.join import HashJoiner
    nb = CONFIG5_STREAM_BUILD
    right = key_table(k=torch.arange(nb, device=dev) * 2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    joiner = HashJoiner(right, ["k"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if joiner._plan != "index":
        raise AssertionError(f"HashJoiner took the {joiner._plan} plan")

    def stream(check: bool):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        pairs, chk, want_pairs, want_chk = zero, zero, zero, zero
        for ci in range(CONFIG5_STREAM // CONFIG5_CHUNK):
            k = config5_keys(CONFIG5_CHUNK, ci * CONFIG5_CHUNK, 2 * nb, dev)
            c, s = joiner.probe_count_device(key_table(k=k))
            pairs, chk = pairs + c, chk + s
            if check:        # every key is below 2 * nb: even keys match
                even = (k & 1) == 0
                want_pairs = want_pairs + even.sum()
                want_chk = want_chk + torch.where(even, k >> 1, 0).sum()
            if ci % 2 == 1:
                pairs.item()                 # sync every two chunks
            del k
        return torch.stack([pairs, chk, want_pairs, want_chk]).tolist()

    pairs, chk, want_pairs, want_chk = stream(True)
    if (pairs, chk) != (want_pairs, want_chk):
        raise AssertionError(f"config 5 streamed: pairs {pairs}, checksum "
                             f"{chk}; closed form {want_pairs}, {want_chk}")
    peak = peak_gib()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream(False)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    print(f"config 5 {CONFIG5_STREAM // 10 ** 9}B x {nb // 10 ** 6}M "
          f"streamed through HashJoiner ({CONFIG5_CHUNK:,}-row chunks made "
          f"on the card): {pairs:,} pairs, build-row checksum {chk}, equal "
          f"to the closed form; build {build_s * 1e3:.1f} ms, streamed probe "
          f"{probe_s * 1e3:.1f} ms (host clock, second run, chunk "
          f"generation included), {CONFIG5_STREAM / probe_s:.4g} probe "
          f"rows/s; peak device memory {peak:.2f} GiB", flush=True)
    if profile:
        profile_call("config 5 streamed chunk (generation and probe)",
                     lambda: joiner.probe_count_device(key_table(
                         k=config5_keys(CONFIG5_CHUNK, 0, 2 * nb, dev))))


# ---- config 2: cast + compare -------------------------------------------

def config2_words() -> list:
    """Config 2's 1,000 dictionary words (bench.py:190), in byte order."""
    return [f"word-{i:04d}" for i in range(1000)]


def config2_inputs(n: int, dev):
    """bench.py:181-193's generator (rng(1)): host arrays and the columns
    on the card."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    rng = np.random.default_rng(1)
    i32 = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ts = rng.integers(0, 2 ** 40, n)
    codes = rng.integers(0, 1000, n).astype(np.int32)
    words = StringColumn.from_pylist(config2_words(), device=dev)
    cols = (PrimitiveColumn(torch.from_numpy(i32).to(dev), dt.int32,
                            torch.from_numpy(valid).to(dev)),
            PrimitiveColumn(torch.from_numpy(ts).to(dev), dt.timestamp("us")),
            DictionaryColumn(torch.from_numpy(codes).to(dev), words))
    return (i32, valid, ts, codes), cols


def config2_run(i32, ts, dcol):
    """bench.py's config-2 run() (bench.py:195-202)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import eq, gt_eq, lt
    a = cast(i32, dt.int64)
    b = cast(i32, dt.float64)
    c = cast(ts, dt.timestamp("ns"))
    return lt(b, cast(a, dt.float64)), eq(dcol, "word-0042"), gt_eq(c, c)


def config2_loop(i32, tsi, dcol):
    """bench.py's steady-state loop (bench.py:264-294): CONFIG2_PASSES
    passes whose scalars vary, summing the kept rows."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import eq, gt_eq, lt
    from arrow_tpu_torch.ops.numeric import add_wrapping
    m2 = eq(dcol, "word-0042")
    acc = torch.zeros((), dtype=torch.int64, device=i32.device)
    for i in range(CONFIG2_PASSES):
        x = add_wrapping(i32, Scalar(i, dt.int32))
        a = cast(x, dt.int64)
        b = cast(x, dt.float64)
        t2 = add_wrapping(tsi, Scalar(i, dt.int64))
        c = cast(cast(t2, dt.timestamp("us")), dt.timestamp("ns"))
        m1 = lt(b, Scalar(float(i * 100_000_000), dt.float64))
        m4 = gt_eq(a, Scalar(-i, dt.int64))
        m3 = gt_eq(c, Scalar(i * 1000, dt.timestamp("ns")))
        keep = (m1.values | m4.values) & m2.values & m3.values
        acc = acc + keep.sum()
    return acc


def config2_loop_closed_form(host) -> int:
    """The loop's sum by numpy."""
    i32, valid, ts, codes = host
    total = 0
    for i in range(CONFIG2_PASSES):
        x = (i32.astype(np.int64) + i).astype(np.int32)    # wrapping
        m1 = valid & (x.astype(np.float64) < i * 1e8)
        m4 = valid & (x.astype(np.int64) >= -i)
        m3 = (ts + i) * 1000 >= i * 1000
        total += int(((m1 | m4) & (codes == 42) & m3).sum())
    return total


def _same_column(a, b, what: str) -> None:
    """Equal values (a dictionary's codes) and validity, bitwise."""
    va, vb = getattr(a, "codes", a.values), getattr(b, "codes", b.values)
    if not torch.equal(_bits(va), _bits(vb)) or \
            (a.validity is None) != (b.validity is None) or \
            (a.validity is not None and not torch.equal(a.validity,
                                                        b.validity)):
        raise AssertionError(f"{what}: columns differ")


def run_config2(dev, profile: bool) -> dict:
    """Steps 20-21."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.fuse import fuse
    from arrow_tpu_torch.ops.boolean import and_kleene, or_kleene
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import gt_eq
    from arrow_tpu_torch.ops.filter import filter_table
    n = CONFIG2_ROWS
    host, (i32, ts, dcol) = config2_inputs(n, dev)
    i32_np, valid_np, ts_np, codes_np = host
    what = f"config 2, {n:,} rows"

    m1, m2, m3 = config2_run(i32, ts, dcol)
    torch.cuda.synchronize()
    valid = torch.from_numpy(valid_np).to(dev)
    if bool(m1.values.any()) or not torch.equal(m1.validity, valid):
        raise AssertionError(f"{what}: m1 is not false with i32's validity")
    if not torch.equal(m2.values, torch.from_numpy(codes_np == 42).to(dev)):
        raise AssertionError(f"{what}: m2 differs from codes == 42")
    if not bool(m3.values.all()) or not bool(m3.validity.all()):
        raise AssertionError(f"{what}: m3 is not all true")
    fused_run = fuse(config2_run)
    for got, want, name in zip(fused_run(i32, ts, dcol), (m1, m2, m3),
                               ("m1", "m2", "m3")):
        _same_column(got, want, f"{what} fused {name}")
    print(f"{what}: run() equal to the closed forms (m1 false on "
          f"{int(valid.sum()):,} valid rows, m2 {int(m2.values.sum()):,} "
          f"rows of word-0042, m3 all true); fuse bitwise equal to eager",
          flush=True)

    tsi = PrimitiveColumn(ts.values, dt.int64)
    fused_loop = fuse(config2_loop)
    want = config2_loop_closed_form(host)
    eager_sum = int(config2_loop(i32, tsi, dcol))
    fused_sum = int(fused_loop(i32, tsi, dcol))
    if not eager_sum == fused_sum == want:
        raise AssertionError(f"{what}: loop sums eager {eager_sum}, fused "
                             f"{fused_sum}, numpy {want}")
    eager_ms = time_ms(lambda: config2_run(i32, ts, dcol))
    fused_ms = time_ms(lambda: fused_run(i32, ts, dcol))
    loop_ms = time_ms(lambda: fused_loop(i32, tsi, dcol))
    loop_eager_ms = time_ms(lambda: config2_loop(i32, tsi, dcol))
    print(f"{what}: run() eager {eager_ms:.4f} ms, fused {fused_ms:.4f} ms; "
          f"the {CONFIG2_PASSES}-pass loop (sum {want:,}, equal to numpy) "
          f"fused {loop_ms:.4f} ms ({CONFIG2_PASSES * n / loop_ms * 1e3:.4g}"
          f" rows/s), eager {loop_eager_ms:.4f} ms (CUDA events, median of "
          f"5)", flush=True)
    if profile:
        profile_call(f"{what} run() eager", lambda: config2_run(i32, ts, dcol))
        profile_call(f"{what} run() fused", lambda: fused_run(i32, ts, dcol))
        profile_call(f"{what} {CONFIG2_PASSES}-pass loop fused",
                     lambda: fused_loop(i32, tsi, dcol))
    del fused_run, fused_loop

    # step 21: the WHERE query
    m4 = gt_eq(cast(i32, dt.int64), Scalar(0, dt.int64))
    pred = and_kleene(and_kleene(or_kleene(m1, m4), m2), m3)
    table = Table([i32, ts, dcol], dt.Schema((
        dt.Field("i32", dt.int32), dt.Field("ts", dt.timestamp("us")),
        dt.Field("d", dcol.dtype))))
    _reset_counts()
    out = filter_table(table, pred)
    launches = _read_counts(f"{what} WHERE filter_table", "compact")
    keep_np = valid_np & (i32_np >= 0) & (codes_np == 42)
    rows = int(keep_np.sum())
    got = (out.column("i32").values, out.column("ts").values,
           out.column("d").codes)
    for g, w, name in zip(got, (i32_np, ts_np, codes_np),
                          ("i32", "ts", "codes")):
        if g.shape[0] != rows or not np.array_equal(g.cpu().numpy(),
                                                    w[keep_np]):
            raise AssertionError(f"{what} WHERE: {name} differs from numpy")
    where_ms = time_ms(lambda: filter_table(table, pred))
    print(f"{what} WHERE (m1 OR m4) AND m2 AND m3: {rows:,} rows equal to "
          f"numpy; filter_table {where_ms:.4f} ms", flush=True)
    keep = (pred.values & pred.validity).contiguous()
    buffers = (i32.values, i32.validity, ts.values, dcol.codes)
    site = _compact_site(f"config-2 WHERE, filter_table, {n:,} rows",
                         keep, buffers, rows,
                         lambda: tuple(b[keep] for b in buffers), None)
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    return _entry(site, launches["compact"], err)


# ---- config 3: two-key sort ------------------------------------------------

def config3_table(n: int, dev):
    """bench.py:344-349 on the card: Int64 keys h = _mix2(arange(n)), null
    where h % 10 == 0; Dictionary<Utf8> codes h % 1000 over 1,000 words."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table
    h = _mix2(torch.arange(n, dtype=torch.int64, device=dev))
    codes = _umod(h, 1000).to(torch.int32)
    valid = _umod(h, 10) != 0
    words = StringColumn.from_pylist([f"w{i:04d}" for i in range(1000)],
                                     device=dev)
    return Table([PrimitiveColumn(h, dt.int64, valid),
                  DictionaryColumn(codes, words)],
                 dt.Schema((dt.Field("k", dt.int64),
                            dt.Field("d", dt.dictionary(dt.int32, dt.utf8)))))


def check_lexsorted(idx: torch.Tensor, k, valid, codes, what: str) -> None:
    """An O(n) check that needs no sort: idx is a permutation; the
    gathered (key, code) pairs do not decrease, nulls first; ties keep
    ascending indices."""
    n = k.shape[0]
    idx = idx.to(torch.int64)
    if idx.shape[0] != n or int(idx.min()) < 0 or int(idx.max()) >= n:
        raise AssertionError(f"{what}: indices out of range")
    seen = torch.zeros(n, dtype=torch.bool, device=idx.device)
    seen[idx] = True
    if not bool(seen.all()):
        raise AssertionError(f"{what}: indices are not a permutation")
    del seen
    kv, vv, cv = k[idx], valid[idx], codes[idx]
    if bool((vv[:-1] & ~vv[1:]).any()):
        raise AssertionError(f"{what}: a null after a valid key")
    both_valid = vv[:-1] & vv[1:]
    both_null = ~vv[:-1] & ~vv[1:]
    keq = kv[:-1] == kv[1:]
    ceq = cv[:-1] == cv[1:]
    cle = cv[:-1] <= cv[1:]
    ok = ~both_valid | (kv[:-1] < kv[1:]) | (keq & cle)
    ok &= ~both_null | cle
    tie = ((both_valid & keq) | both_null) & ceq
    ok &= ~tie | (idx[:-1] < idx[1:])
    if not bool(ok.all()):
        raise AssertionError(f"{what}: {int((~ok).sum())} pairs out of "
                             f"order")


def run_config3(dev, profile: bool):
    """Steps 22-23."""
    from arrow_tpu_torch.ops.sort import (SortColumn, SortOptions,
                                          lexsort_to_indices, partition,
                                          rank, sort_table)
    from arrow_tpu_torch.ops.take import take_table
    n = CONFIG3_ROWS
    what = f"config 3, {n:,} rows"
    table = config3_table(n, dev)
    k, d = table.column("k"), table.column("d")
    opts = SortOptions(descending=False, nulls_first=True)
    cols = [SortColumn(k, opts), SortColumn(d, opts)]
    by = [("k", opts), ("d", opts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    idx = lexsort_to_indices(cols)
    torch.cuda.synchronize()
    lex_peak = peak_gib()
    check_lexsorted(idx.values, k.values, k.validity, d.codes, what)
    torch.cuda.reset_peak_memory_stats()
    out = sort_table(table, by)
    torch.cuda.synchronize()
    table_peak = peak_gib()
    want = take_table(table, idx)
    for name in ("k", "d"):
        _same_column(out.column(name), want.column(name),
                     f"{what}: sort_table against take_table, column {name}")
    del want
    print(f"{what}: lexsort_to_indices passes the order check "
          f"({int((~k.validity).sum()):,} nulls first); sort_table equal to "
          f"take_table by its indices", flush=True)
    lex_ms = time_ms(lambda: lexsort_to_indices(cols))
    tab_ms = time_ms(lambda: sort_table(table, by))
    print(f"{what}: lexsort_to_indices {lex_ms:.4f} ms "
          f"({n / lex_ms * 1e3:.4g} rows/s), sort_table {tab_ms:.4f} ms "
          f"(CUDA events, median of 5); peak device memory {lex_peak:.2f} "
          f"/ {table_peak:.2f} GiB", flush=True)
    if profile:
        profile_call(f"{what} lexsort_to_indices",
                     lambda: lexsort_to_indices(cols))
        profile_call(f"{what} sort_table", lambda: sort_table(table, by))
    del idx, table, cols

    # step 23: rank and partition over the sorted Int64 column
    sk = out.column("k")
    del out
    nulls = int((~sk.validity).sum())
    _reset_counts()
    with watch("compact", "sort") as calls:
        r = rank(sk)
    r_launches = _read_counts(f"{what} rank of the sorted keys",
                              "compact")["compact"]
    vals = sk.values[nulls:]
    want_r = torch.searchsorted(vals, vals, right=True) + nulls
    if not bool((r[:nulls] == nulls).all()) or \
            not torch.equal(r[nulls:].to(torch.int64), want_r):
        raise AssertionError(f"{what}: rank differs from searchsorted")
    del want_r
    rank_call = calls[0]
    _reset_counts()
    with watch("compact", "sort") as calls:
        parts = partition([sk])
    p_launches = _read_counts(f"{what} partition of the sorted keys",
                              "compact")["compact"]
    runs = int((vals[1:] != vals[:-1]).sum()) + 1 + (nulls > 0)
    b = parts.boundaries
    if len(parts) != runs or b[0] != 0 or b[-1] != n or \
            (nulls and b[1] != nulls) or not (np.diff(b) > 0).all():
        raise AssertionError(f"{what}: partition gives {len(parts)} runs, "
                             f"the sorted keys {runs}")
    part_call = calls[0]
    rank_ms = time_ms(lambda: rank(sk))
    print(f"{what}: rank of the sorted Int64 column equal to searchsorted "
          f"({rank_ms:.4f} ms); partition {len(parts):,} runs", flush=True)
    entries = []
    for (args, kwargs), launches, where in (
            (rank_call, r_launches, "rank run starts"),
            (part_call, p_launches, "partition boundaries")):
        keep = args[0]
        site = _compact_site(f"{where} (positions alone), {keep.shape[0]:,} "
                             f"sorted rows", keep, (), None,
                             lambda keep=keep: keep.nonzero(),
                             kwargs.get("positions"))
        err = check_site(site, same_compaction, f"K1 at {site.call_site}")
        entries.append(_entry(site, launches, err))
    return entries


# ---- phase 24: a streamed dictionary GROUP BY ------------------------------

P24_WORDS = 1_000                  # config 2's words (bench.py:190)
P24_SWORDS = 100                   # the second dictionary's words
P24_AGGS = (("v", "count_all"), ("v", "sum"), ("v", "mean"), ("s", "min"),
            ("s", "max"))


def p24_swords() -> list:
    return [f"s-{i:02d}" for i in range(P24_SWORDS)]


def p24_ids(n: int, offset: int, device):
    """Row ids of a chunk from bench.py's splitmix hash: the word id w,
    the second word id sw (within 13 of 7w, mod 100), v = (h >> 32) %
    1000 and its validity (10% null)."""
    h = splitmix(n, offset, device)
    w = _umod(h, P24_WORDS)
    sw = (w * 7 + _umod(_lsr(h, 20), 13)) % P24_SWORDS
    v = (_lsr(h, 32) % 1000).to(torch.int32)
    vvalid = _umod(_lsr(h, 12), 10) != 0
    return w, sw, v, vvalid


def p24_chunk(n: int, offset: int, chunk: int, device):
    """One chunk with dictionaries of its own: k over the 1,000 words and
    s over the 100 in permutations seeded by the chunk number, so every
    chunk codes the same word differently."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table
    w, sw, v, vvalid = p24_ids(n, offset, device)
    cols = []
    for ids, vocab, seed in ((w, config2_words(), chunk),
                             (sw, p24_swords(), 1000 + chunk)):
        perm = np.random.default_rng(seed).permutation(len(vocab))
        inv = torch.from_numpy(np.argsort(perm).astype(np.int32)).to(device)
        values = StringColumn.from_pylist([vocab[i] for i in perm],
                                          device=device)
        cols.append(DictionaryColumn(inv[ids], values))
        del ids
    d = dt.dictionary(dt.int32, dt.utf8)
    return Table(cols + [PrimitiveColumn(v, dt.int32, vvalid)],
                 dt.Schema((dt.Field("k", d, nullable=False),
                            dt.Field("s", d, nullable=False),
                            dt.Field("v", dt.int32))))


def p24_independent(dev) -> dict:
    """count_all, sum, mean and the min and max second word per word id,
    chunk by chunk from the generator: bincount, index_add_ and
    scatter_reduce_, no code of the port."""
    g = P24_WORDS
    cnt = torch.zeros(g, dtype=torch.int64, device=dev)
    vsum, vcnt = torch.zeros_like(cnt), torch.zeros_like(cnt)
    smin = torch.full((g,), P24_SWORDS, dtype=torch.int64, device=dev)
    smax = torch.full((g,), -1, dtype=torch.int64, device=dev)
    for off in range(0, CONFIG4_ROWS, CONFIG4_CHUNK):
        w, sw, v, vvalid = p24_ids(min(CONFIG4_CHUNK, CONFIG4_ROWS - off),
                                   off, dev)
        cnt += torch.bincount(w, minlength=g)
        vsum.index_add_(0, w, torch.where(vvalid, v.to(torch.int64), 0))
        vcnt.index_add_(0, w, vvalid.to(torch.int64))
        smin.scatter_reduce_(0, w, sw, "amin")
        smax.scatter_reduce_(0, w, sw, "amax")
        del w, sw, v, vvalid
    return {"cnt": cnt, "sum": vsum.to(torch.int32),
            "mean": vsum.to(torch.float64) / vcnt.clamp(min=1)
            .to(torch.float64),
            "smin": smin.tolist(), "smax": smax.tolist()}


def p24_check(out, want, what: str) -> None:
    words, swords = config2_words(), p24_swords()
    if out.num_rows != P24_WORDS or out.column("k").to_pylist() != words:
        raise AssertionError(f"{what}: keys differ from the words in order")
    for name, ref in (("v_count_all", want["cnt"]), ("v_sum", want["sum"]),
                      ("v_mean", want["mean"])):
        col = out.column(name)
        if col.validity is not None and not bool(col.validity.all()):
            raise AssertionError(f"{what}: {name} has nulls")
        if col.values.dtype != ref.dtype or \
                not torch.equal(_bits(col.values), _bits(ref)):
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"independent computation")
    for name, ids in (("s_min", want["smin"]), ("s_max", want["smax"])):
        if out.column(name).to_pylist() != [swords[i] for i in ids]:
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"independent computation")
    print(f"{what}: {out.num_rows:,} groups; count_all, sum, mean and the "
          f"min/max strings equal to the independent computation, bit for "
          f"bit", flush=True)


def _k2_site(call_site: str, call) -> Site:
    """K2 at the inputs a watched grouped_aggregate call was given."""
    from arrow_tpu_torch.kernels import groupagg as kg
    (codes, g), kwargs = call[0][:2], call[1]
    sums, mms = kwargs.get("sum_cols", ()), kwargs.get("mm_cols", ())
    extra = {"base": kwargs.get("base", 0),
             "codes_valid": kwargs.get("codes_valid"),
             "codes_dtype": kwargs.get("codes_dtype")}
    moved = nbytes(codes, extra["codes_valid"],
                   *[t for c in sums for t in (c.values, c.valid)],
                   *[t for c in mms for t in (c.values, c.valid)]) \
        + 8 * g * (2 * len(sums) + 2 * len(mms))
    return Site("grouped_aggregate", call_site,
                lambda: kg.grouped_aggregate(codes, g, sums, mms,
                                             decode=False, **extra),
                lambda: kg.grouped_aggregate_plain(codes, g, sums, mms,
                                                   **extra),
                None, moved)


def run_phase24(dev, profile: bool) -> list:
    """Phase 24: config 4's 500M rows in four 125M-row chunks, each with
    Dictionary<utf8> columns of its own, through GroupByAccumulator."""
    from arrow_tpu_torch.ops.groupby import AggSpec, GroupByAccumulator
    aggs = [AggSpec(*a) for a in P24_AGGS]
    what = f"phase 24, {CONFIG4_ROWS:,} rows in {CONFIG4_CHUNK:,}-row " \
        f"chunks with dictionaries of their own"

    def stream():
        acc = GroupByAccumulator(["k"], aggs)
        for i, off in enumerate(range(0, CONFIG4_ROWS, CONFIG4_CHUNK)):
            acc.update(p24_chunk(min(CONFIG4_CHUNK, CONFIG4_ROWS - off), off,
                                 i, dev))
        return acc.finalize()

    want = p24_independent(dev)
    _reset_counts()
    with watch("grouped_aggregate", "groupby") as k2_calls, \
            watch("compact", "groupby") as k1_calls:
        out = stream()
    launches = _read_counts(what, "grouped_aggregate")
    if launches["compact"] <= 0:
        raise AssertionError(f"{what}: the merge never launched compact")
    k2_call, k1_call = k2_calls[0], k1_calls[-1]
    del k2_calls, k1_calls
    p24_check(out, want, what)
    del out
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = stream()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = peak_gib()
    p24_check(out, want, f"{what} (second run)")
    del out, want
    print(f"{what}: {secs * 1e3:.1f} ms (host clock, synced, chunk "
          f"generation included), {CONFIG4_ROWS / secs:.4g} rows/s; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    if profile:
        profile_call("phase 24 streamed group_by", stream)
    entries = []
    site = _k2_site(f"phase 24 dictionary plan, {CONFIG4_CHUNK:,}-row chunk "
                    f"x {k2_call[0][1]:,} codes", k2_call)
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, launches["grouped_aggregate"], err))
    del site, k2_call
    (keep, arrays), kwargs = k1_call[0][:2], k1_call[1]
    site = _compact_site(f"phase 24 merge, sort-plan run starts, "
                         f"{keep.shape[0]:,} partial rows", keep,
                         tuple(arrays), kwargs.get("out_cap"),
                         lambda: (arrays[0][keep], keep.nonzero()),
                         kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    return entries


# ---- phase 25: device strings at config 2's and config 5's sizes ----------

def _word_bytes(dev) -> torch.Tensor:
    """(1,000, 9) uint8: the bytes of config 2's words."""
    raw = "".join(config2_words()).encode()
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
        .reshape(P24_WORDS, 9).to(dev)


def _same_strings(col, ids: torch.Tensor, what: str) -> None:
    """A column of 9-byte words equal to the words at `ids`, bitwise."""
    dev = ids.device
    offs = torch.arange(ids.shape[0] + 1, dtype=torch.int64, device=dev) * 9
    data = _word_bytes(dev)[ids.to(torch.int64)].reshape(-1)
    if not torch.equal(col.offsets.to(torch.int64), offs) or \
            not torch.equal(col.data, data):
        raise AssertionError(f"{what}: offsets or bytes differ from the "
                             f"closed form")


def _host_gather(offs: np.ndarray, data: np.ndarray, keep: np.ndarray):
    """The kept rows' offsets and bytes, by numpy."""
    idx = np.nonzero(keep)[0]
    lens = offs[idx + 1] - offs[idx]
    new = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=new[1:])
    src = np.repeat(offs[idx] - new[:-1], lens) + np.arange(new[-1])
    return new, data[src]


def _cpu(x):
    """A column or table of the port with its tensors, every
    dictionary's values included, on the CPU."""
    from torch.utils import _pytree as pytree
    from arrow_tpu_torch.core.column import DictionaryColumn

    def move(t):
        if isinstance(t, DictionaryColumn):
            return DictionaryColumn(t.codes.cpu(), _cpu(t.values),
                                    None if t.validity is None
                                    else t.validity.cpu(), _canonical=True,
                                    ordered=bool(t.dtype.ordered))
        return t.cpu() if isinstance(t, torch.Tensor) else t
    return pytree.tree_map(move, x, is_leaf=lambda t: isinstance(
        t, DictionaryColumn))


def _outcome(fn):
    """fn's result, or the name of the error it raised."""
    try:
        return fn()
    except Exception as e:                 # compared by name
        return type(e).__name__


def _same_outcome(got, want, what: str) -> None:
    """A card result equal to the CPU route's, bit for bit."""
    from torch.utils import _pytree as pytree
    gl, gs = pytree.tree_flatten(got)
    wl, ws = pytree.tree_flatten(want)
    if str(gs) != str(ws) or len(gl) != len(wl):
        raise AssertionError(f"{what}: {gs} against {ws}")
    for a, b in zip(gl, wl):
        if isinstance(a, torch.Tensor):
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(_bits(a.cpu()), _bits(b)):
                raise AssertionError(f"{what}: differs from the CPU route")
        elif a != b:
            raise AssertionError(f"{what}: {a!r} against {b!r}")


def p25_compute_calls(i32, ts, dcol, dv, m2, m3):
    """Each new function of numeric, aggregate, bitwise and select_misc
    once, on config 2's columns: (name, call)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.ops import aggregate as pa, bitwise as pb
    from arrow_tpu_torch.ops import numeric as pn, select_misc as psel
    from arrow_tpu_torch.ops.cast import cast
    i64 = cast(i32, dt.int64)
    f64, fdv = cast(i32, dt.float64), cast(dv, dt.float64)
    return [
        ("div", lambda: pn.div(i32, dv)),
        ("rem", lambda: pn.rem(i32, dv)),
        ("neg", lambda: pn.neg(i64)),
        ("neg_wrapping", lambda: pn.neg_wrapping(i32)),
        ("div (float64)", lambda: pn.div(f64, fdv)),
        ("rem (float64)", lambda: pn.rem(f64, fdv)),
        ("neg (float64)", lambda: pn.neg(f64)),
        ("sum_checked", lambda: pa.sum_checked(i64)),
        ("min_", lambda: pa.min_(i32)),
        ("max_", lambda: pa.max_(i32)),
        ("min_max", lambda: pa.min_max(ts)),
        ("min_ (dictionary)", lambda: pa.min_(dcol)),
        ("max_ (dictionary)", lambda: pa.max_(dcol)),
        ("count_nulls", lambda: pa.count_nulls(i32)),
        ("bool_and", lambda: pa.bool_and(m3)),
        ("bool_or", lambda: pa.bool_or(m2)),
        ("bit_and", lambda: pa.bit_and(i32)),
        ("bit_or", lambda: pa.bit_or(i32)),
        ("bit_xor", lambda: pa.bit_xor(i32)),
        ("bitwise_and", lambda: pb.bitwise_and(i32, dv)),
        ("bitwise_or", lambda: pb.bitwise_or(i32, dv)),
        ("bitwise_xor", lambda: pb.bitwise_xor(i32, dv)),
        ("bitwise_not", lambda: pb.bitwise_not(i32)),
        ("bitwise_shift_left", lambda: pb.bitwise_shift_left(i32, dv)),
        ("bitwise_shift_right", lambda: pb.bitwise_shift_right(i32, dv)),
        ("zip_", lambda: psel.zip_(m2, i32, dv)),
        ("zip_ (dictionary)", lambda: psel.zip_(m2, dcol, dcol)),
        ("nullif", lambda: psel.nullif(i32, m2)),
        ("shift", lambda: psel.shift(i32, 3)),
        ("shift (dictionary)", lambda: psel.shift(dcol, -5)),
    ]


P25_TAIL = 4096                    # bytes of phase 25's long-tail value
P25_COMMENT_ROWS = 1_100_000       # rows of phase 25's Q10-shaped column
P25_TEXT = np.frombuffer(
    b"furiously regular deposits sleep carefully among the final pinto "
    b"beans. quickly ironic accounts wake blithely express, even requests "
    b"haggle slyly; bold packages nag ", np.uint8)


def q10_comment(n: int, device):
    """n rows drawn like Q10's c_comment after its joins: 29-116 bytes of
    text cut at random offsets from a pool of TPC-H-like words, about
    three rows a value."""
    from arrow_tpu_torch.core.column import StringColumn
    rng = np.random.default_rng(SEED)
    pool = P25_TEXT[rng.integers(0, len(P25_TEXT), 1 << 16)]
    u = max(n // 3, 1)
    pick = rng.integers(0, u, n)
    lens = rng.integers(29, 117, u)[pick]
    starts = rng.integers(0, len(pool) - 116, u)[pick]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = pool[np.repeat(starts - offs[:-1], lens) + np.arange(offs[-1])]
    return StringColumn.from_numpy(offs, data, device=device)


def _q10_comment_site(dev) -> dict:
    """K3 at a Q10-shaped c_comment (`q10_comment`): the encode's one
    native call against its plain loop, which must run at least three
    drops, and small_kernel in the native trace; the column decoded back
    from its encode equals it.  The site's entry of the kernels line."""
    from arrow_tpu_torch.kernels import strkey as ks
    from arrow_tpu_torch.ops.strings import (dictionary_decode,
                                             dictionary_encode)
    col = q10_comment(P25_COMMENT_ROWS, dev)
    what = f"phase 25, Q10-shaped c_comment of {P25_COMMENT_ROWS:,} rows"
    launches = ks.strrank.launches
    with watch("strrank", "strings") as calls:
        enc = dictionary_encode(col)
    launches = ks.strrank.launches - launches
    back = dictionary_decode(enc)
    torch.cuda.synchronize()
    if not (torch.equal(back.offsets.to(torch.int64),
                        col.offsets.to(torch.int64))
            and torch.equal(back.data, col.data)):
        raise AssertionError(f"{what}: the column decoded from its encode "
                             f"differs from it")
    if not launches == len(calls) == 1:
        raise AssertionError(f"{what}: dictionary_encode made {launches} "
                             f"native calls, {len(calls)} strrank calls")
    offsets, data, passes = calls[0][0]
    _, run, drops = ks.strrank_plain(offsets, data, passes)
    if drops < 3:
        raise AssertionError(f"{what}: the plain loop made {drops} drops in "
                             f"{run} passes; the site wants three or more")
    averages = native_trace(lambda: ks.strrank(offsets, data, passes), 1)
    small = None if averages is None else sum(
        e.count for e in averages if "small_kernel" in e.key)
    if small == 0:
        raise AssertionError(f"{what}: K3 ran no small_kernel in {run} "
                             f"passes")
    print(f"{what}: {run} passes, {drops} drops, "
          f"{'not measured' if small is None else small} small_kernel "
          f"launches; decoded back equal", flush=True)
    site = _strkey_site(f"phase 25 dictionary_encode, Q10-shaped c_comment "
                        f"of {P25_COMMENT_ROWS:,} rows, {run} passes, "
                        f"{drops} drops", calls[0])
    del enc, back, calls
    err = check_site(site, _same_ranks, f"K3 at {site.call_site}")
    return _entry(site, launches, err)


def run_phase25(dev, profile: bool) -> list:
    """Phase 25: config 2's dictionary decoded to device strings, encoded
    back (K3's native call against its plain loop: 9-byte rows, where
    only the sort path runs, and a Q10-shaped c_comment, where the drops
    chain their offsets and the small groups take small_kernel), grouped
    by and filtered; config 5's index-plan join carrying a string column;
    the new elementwise functions against the CPU route."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops.boolean import and_kleene, or_kleene
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import gt, gt_eq
    from arrow_tpu_torch.ops.filter import filter_table
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    from arrow_tpu_torch.ops.join import join
    from arrow_tpu_torch.ops.strings import (dictionary_decode,
                                             dictionary_encode)
    from arrow_tpu_torch.kernels import strkey as ks
    from arrow_tpu_torch.utils import trace
    n = CONFIG2_ROWS
    host, (i32, ts, dcol) = config2_inputs(n, dev)
    i32_np, valid_np, ts_np, codes_np = host
    codes = torch.from_numpy(codes_np).to(dev)
    what = f"phase 25, {n:,} rows"
    times = {}

    s = dictionary_decode(dcol)
    torch.cuda.synchronize()
    _same_strings(s, codes, f"{what}: dictionary_decode")
    times["dictionary_decode"] = time_ms(lambda: dictionary_decode(dcol))
    torch.cuda.synchronize()
    ks.strrank.launches = 0
    trace.reset_spans()
    with watch("strrank", "strings") as k3_calls, trace.recording():
        enc = dictionary_encode(s)
    torch.cuda.synchronize()
    k3_launches = ks.strrank.launches
    (encode,) = [x for x in trace.spans() if x.name == "strings.encode"]
    trace.reset_spans()
    if enc.values.to_pylist() != config2_words() or \
            not torch.equal(enc.codes, codes) or enc.validity is not None:
        raise AssertionError(f"{what}: dictionary_encode differs from the "
                             f"words and their indices")
    passes = encode.attrs["passes"]
    if not k3_launches == len(k3_calls) == 1 or passes < 2:
        raise AssertionError(f"{what}: dictionary_encode called K3 "
                             f"{k3_launches} times for {passes} passes")
    times["dictionary_encode"] = time_ms(lambda: dictionary_encode(s), 3)
    del enc
    # a long tail: the same rows, a value of P25_TAIL bytes twice and its
    # prefix one byte shorter, which sort last; the rows of 9 bytes finish
    # after two passes and drop out, the three run on alone
    ends = s.offsets[-1] + torch.tensor([P25_TAIL, 2 * P25_TAIL,
                                         3 * P25_TAIL - 1], device=dev,
                                        dtype=s.offsets.dtype)
    long_col = StringColumn(torch.cat([s.offsets, ends]), torch.cat([
        s.data, torch.full((3 * P25_TAIL - 1,), ord("x"), dtype=torch.uint8,
                           device=dev)]), dt.utf8)
    trace.reset_spans()
    with trace.recording():
        enc = dictionary_encode(long_col)
    torch.cuda.synchronize()
    (encode,) = [x for x in trace.spans() if x.name == "strings.encode"]
    reads = sum(x.name == "readback" for x in trace.spans())
    trace.reset_spans()
    if enc.values.to_pylist() != config2_words() + [
            "x" * (P25_TAIL - 1), "x" * P25_TAIL] or \
            not torch.equal(enc.codes[:n], codes) or \
            enc.codes[n:].tolist() != [1001, 1001, 1000]:
        raise AssertionError(f"{what}: dictionary_encode of the long tail "
                             f"differs from the words and their indices")
    tail_passes = encode.attrs["passes"]
    times["dictionary_encode (long tail)"] = time_ms(
        lambda: dictionary_encode(long_col), 3)
    del enc, long_col, ends
    print(f"{what}: dictionary_encode of the rows and three of up to "
          f"{P25_TAIL:,} bytes equal to the words and codes: {tail_passes} "
          f"passes, {reads} readbacks, "
          f"{times['dictionary_encode (long tail)']:.4f} ms", flush=True)
    site = _strkey_site(f"phase 25 dictionary_encode, {n:,} rows of 9 "
                        f"bytes, {passes} passes", k3_calls[0])
    err = check_site(site, _same_ranks, f"K3 at {site.call_site}")
    entries = [_entry(site, k3_launches, err)]
    del site, k3_calls
    entries.append(_q10_comment_site(dev))
    if profile:
        profile_call(f"{what} dictionary_decode",
                     lambda: dictionary_decode(dcol))
        profile_call(f"{what} dictionary_encode",
                     lambda: dictionary_encode(s))
    print(f"{what}: dictionary_decode to {s.data.numel():,} bytes on the "
          f"card and dictionary_encode back equal the words and codes; "
          f"decode {times['dictionary_decode']:.4f} ms, encode (K3's sort "
          f"refinement, {passes} passes in {k3_launches} call) "
          f"{times['dictionary_encode']:.4f} ms", flush=True)

    # group-by on the Utf8 key
    table = Table([s, i32], dt.Schema((dt.Field("s", dt.utf8, False),
                                       dt.Field("i32", dt.int32))))
    aggs = [AggSpec("i32", "count_all"), AggSpec("i32", "count"),
            AggSpec("i32", "sum")]
    _reset_counts()
    with watch("grouped_aggregate", "groupby") as k2_calls:
        out = group_by(table, ["s"], aggs)
    gb_launches = _read_counts(f"{what} group_by on the utf8 key",
                               "grouped_aggregate")
    c64, valid = codes.to(torch.int64), i32.validity
    v64 = torch.where(valid, i32.values.to(torch.int64), 0)

    def per_word(x):
        return torch.zeros(1000, dtype=torch.int64,
                           device=dev).index_add_(0, c64, x)
    want = (torch.bincount(c64, minlength=1000),
            per_word(valid.to(torch.int64)), per_word(v64).to(torch.int32))
    if out.column("s").to_pylist() != config2_words() or any(
            not torch.equal(out.column(c).values, w)
            for c, w in zip(("i32_count_all", "i32_count", "i32_sum"), want)):
        raise AssertionError(f"{what}: group_by on the utf8 key differs from "
                             f"bincount / index_add_ over the codes")
    del out, want, v64, c64
    times["group_by (utf8 key)"] = time_ms(lambda: group_by(table, ["s"],
                                                            aggs))
    print(f"{what}: group_by on the utf8 key equal to bincount / index_add_ "
          f"over the codes; {times['group_by (utf8 key)']:.4f} ms",
          flush=True)
    site = _k2_site(f"phase 25 utf8-key group_by (dictionary plan), "
                    f"{n:,} rows x {k2_calls[0][0][1]:,} codes", k2_calls[0])
    del k2_calls
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, gb_launches["grouped_aggregate"], err))
    del site, table

    # filter_table at config 2's WHERE and at i32 > 0
    m1, m2, m3 = config2_run(i32, ts, dcol)
    m4 = gt_eq(cast(i32, dt.int64), Scalar(0, dt.int64))
    preds = {"WHERE": and_kleene(and_kleene(or_kleene(m1, m4), m2), m3),
             "i32 > 0": gt(i32, Scalar(0, dt.int32))}
    keeps = {"WHERE": valid_np & (i32_np >= 0) & (codes_np == 42),
             "i32 > 0": valid_np & (i32_np > 0)}
    ftable = Table([i32, ts, s], dt.Schema((
        dt.Field("i32", dt.int32), dt.Field("ts", dt.timestamp("us")),
        dt.Field("s", dt.utf8, False))))
    s_offs, s_data = s.offsets.cpu().numpy().astype(np.int64), \
        s.data.cpu().numpy()
    for name, pred in preds.items():
        _reset_counts()
        with watch("compact", "filter") as calls:
            out = filter_table(ftable, pred)
        launches = _read_counts(f"{what} filter_table {name}", "compact")
        if launches["compact"] != 1:
            raise AssertionError(f"{what} filter_table {name}: "
                                 f"{launches['compact']} K1 launches, not 1")
        keep_np = keeps[name]
        offs_np, data_np = _host_gather(s_offs, s_data, keep_np)
        got = out.column("s")
        if not np.array_equal(got.offsets.cpu().numpy(), offs_np) or \
                not np.array_equal(got.data.cpu().numpy(), data_np) or \
                not np.array_equal(out.column("i32").values.cpu().numpy(),
                                   i32_np[keep_np]) or \
                not np.array_equal(out.column("ts").values.cpu().numpy(),
                                   ts_np[keep_np]):
            raise AssertionError(f"{what} filter_table {name}: differs from "
                                 f"the host numpy gather")
        del out, got
        times[f"filter_table {name}"] = time_ms(
            lambda: filter_table(ftable, pred))
        if profile:
            profile_call(f"{what} filter_table {name}",
                         lambda: filter_table(ftable, pred))
        print(f"{what}: filter_table {name} keeps {int(keep_np.sum()):,} rows"
              f" (one K1 launch), offsets and bytes equal to the host numpy "
              f"gather; {times[f'filter_table {name}']:.4f} ms", flush=True)
        (keep, arrays), kwargs = calls[0][0][:2], calls[0][1]
        del calls
        site = _compact_site(
            f"phase 25 filter_table {name} with a utf8 column, {n:,} rows, "
            f"{keep_np.mean():.2%} kept", keep, tuple(arrays),
            kwargs.get("out_cap"),
            lambda keep=keep, arrays=arrays: (
                tuple(a[keep] for a in arrays), keep.nonzero()),
            kwargs.get("positions"))
        err = check_site(site, same_compaction, f"K1 at {site.call_site}")
        entries.append(_entry(site, launches["compact"], err))
        del site, keep, arrays
    del ftable

    # the new compute functions against the CPU route
    dv_np = ((i32_np >> 3) % 1000).astype(np.int32)
    dv_np[dv_np == 0] = 1
    dv = PrimitiveColumn(torch.from_numpy(dv_np).to(dev), dt.int32)
    args = (i32, ts, dcol, dv, m2, m3)
    cpu_calls = dict(p25_compute_calls(*[_cpu(a) for a in args]))
    for name, call in p25_compute_calls(*args):
        got = _outcome(call)
        torch.cuda.synchronize()
        _same_outcome(got, _outcome(cpu_calls[name]),
                      f"{what}: {name} on the card")
        times[name] = None if isinstance(got, str) else time_ms(call)
        del got
    print(f"{what}: {len(cpu_calls)} calls of div, rem, neg, the "
          f"aggregates, the bitwise ops, zip_, nullif and shift equal to "
          f"the CPU route", flush=True)
    del cpu_calls, args, m1, m2, m3, m4, preds

    # config 5's index-plan join with a utf8 column on the build side
    k = config5_keys(CONFIG5_PROBE, 0, 2 * CONFIG5_BUILD, dev)
    left = key_table(k=k)
    r = torch.arange(CONFIG5_BUILD, device=dev)
    words = dcol.values
    right = Table([PrimitiveColumn(r * 2, dt.int64), dictionary_decode(
        DictionaryColumn((r % 1000).to(torch.int32), words))],
        dt.Schema((dt.Field("k", dt.int64, False),
                   dt.Field("w", dt.utf8, False))))
    del r
    torch.cuda.reset_peak_memory_stats()
    out = join(left, right, ["k"])
    torch.cuda.synchronize()
    peak = peak_gib()
    rows = ((k & 1) == 0).nonzero().squeeze(1)
    if not torch.equal(out.column("k").values, k[rows]):
        raise AssertionError(f"{what}: the join's rows differ from the "
                             f"closed form")
    _same_strings(out.column("w"), (k[rows] >> 1) % 1000,
                  f"{what}: the join's utf8 column")
    pairs = out.num_rows
    del out, rows
    times["join (utf8 payload)"] = time_ms(lambda: join(left, right, ["k"]))
    if profile:
        profile_call("config 5 inner join with a utf8 build column",
                     lambda: join(left, right, ["k"]))
    print(f"config 5 {CONFIG5_PROBE:,} x {CONFIG5_BUILD:,} inner join with a "
          f"utf8 build column: {pairs:,} rows, the strings equal to the "
          f"closed form; {times['join (utf8 payload)']:.4f} ms (CUDA events,"
          f" median of 5), peak device memory {peak:.2f} GiB", flush=True)
    print("phase 25 times (CUDA events, median of 5; ms): "
          + json.dumps(times), flush=True)
    return entries

# ---- phase 26: TPC-H lineitem's dates at SF5 -------------------------------

P26_ROWS = 30_000_000              # SF5 lineitem, rounded (cut from SF10)
P26_ZONE = "America/New_York"
P26_PARTS = ("year", "month", "day", "quarter", "doy", "dow", "dow_sunday0",
             "week", "week_iso", "year_iso", "hour", "minute", "second",
             "millisecond", "microsecond", "nanosecond")
_EPOCH = __import__("datetime").date(1970, 1, 1)


def _days(y: int, m: int, d: int) -> int:
    import datetime
    return (datetime.date(y, m, d) - _EPOCH).days


def tpch_dates(n: int, dev):
    """TPC-H's lineitem dates (spec 4.2.3) from splitmix on the card:
    o_orderdate uniform over [1992-01-01, 1998-12-31 - 151 days],
    l_shipdate = o_orderdate + U[1, 121], l_commitdate = o_orderdate +
    U[30, 90], l_receiptdate = l_shipdate + U[1, 30], l_quantity U[1, 50];
    and a second of the day per row.  Returns int32 day numbers (int64
    for the rest) and the ship delay."""
    lo, hi = _days(1992, 1, 1), _days(1998, 12, 31) - 151
    cols = {}
    order = lo + _umod(splitmix(n, 0, dev), hi - lo + 1)
    delay = 1 + _umod(splitmix(n, n, dev), 121)
    cols["o_orderdate"] = order.to(torch.int32)
    cols["l_shipdate"] = (order + delay).to(torch.int32)
    cols["l_commitdate"] = (order + 30 + _umod(splitmix(n, 2 * n, dev), 61)
                            ).to(torch.int32)
    cols["l_receiptdate"] = (cols["l_shipdate"] + 1 + _umod(
        splitmix(n, 3 * n, dev), 30)).to(torch.int32)
    cols["l_quantity"] = 1 + _umod(splitmix(n, 4 * n, dev), 50)
    second = _umod(splitmix(n, 5 * n, dev), 86_400)
    return cols, delay.to(torch.int32), second


def _year_quarter_table(dev):
    """(year, quarter) of every day of 1992-2000 by Python's datetime:
    no code of the port."""
    import datetime
    base = _days(1992, 1, 1)
    days = [_EPOCH + datetime.timedelta(days=base + i) for i in range(3300)]
    return base, torch.tensor([[d.year, (d.month - 1) // 3 + 1]
                               for d in days], device=dev)


def _same(got, want, what: str) -> None:
    """Equal to the CPU route or to another result on the card, bit for
    bit."""
    _same_outcome(got, _cpu(want), what)


def run_phase26(dev, profile: bool) -> list:
    """Phase 26: TPC-H SF5 lineitem's dates through ops/temporal.py, the
    temporal arms of add and sub, a K1 filter_table and a K2 group_by.
    Returns the kernel entries and the calls `check_against_cpu` holds to
    the CPU route once every kernel site is measured."""
    import os
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.core.nested import IntervalMDNColumn
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops import numeric as pn, temporal as pt
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import lt_eq
    from arrow_tpu_torch.ops.filter import filter_table
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    n = P26_ROWS
    what = f"phase 26, TPC-H SF5 lineitem dates, {n:,} rows"
    zone_file = os.path.join("/usr/share/zoneinfo", *P26_ZONE.split("/"))
    zone = P26_ZONE if os.path.exists(zone_file) else "-05:00"
    print(f"{what}: tzdata probe: {zone_file} "
          f"{'present' if zone == P26_ZONE else 'missing'}; zone {zone}",
          flush=True)
    raw, delay, second = tpch_dates(n, dev)
    date = {k: PrimitiveColumn(v, dt.date32) for k, v in raw.items()
            if k != "l_quantity"}
    qty = PrimitiveColumn(raw["l_quantity"], dt.int64)
    ship = date["l_shipdate"]
    times, entries, cpu_calls = {}, [], []

    def timed(name, fn):
        times[name] = time_ms(fn)
        if profile:
            profile_call(f"{what} {name}", fn)

    # add_interval of the ship delay as interval[month_day_nano] days
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    iv = IntervalMDNColumn(zeros, delay, zeros.to(torch.int64))
    got = pt.add_interval(date["o_orderdate"], iv)
    if not torch.equal(got.values, ship.values) or got.validity is not None:
        raise AssertionError(f"{what}: add_interval(o_orderdate, delay) is "
                             f"not l_shipdate")
    timed("add_interval (month_day_nano days)",
          lambda: pt.add_interval(date["o_orderdate"], iv))
    del got, iv

    # Q1's cutoff and WHERE l_shipdate <= cutoff through K1
    start = PrimitiveColumn(torch.tensor([_days(1998, 12, 1)],
                                         dtype=torch.int32, device=dev),
                            dt.date32)
    ninety = PrimitiveColumn(torch.tensor([90 << 32], device=dev),
                             dt.interval("day_time"))
    cutoff = int(pt.sub_interval(start, ninety).values[0])
    if cutoff != _days(1998, 9, 2):
        raise AssertionError(f"{what}: 1998-12-01 - 90 days = {cutoff}")
    table = Table([*date.values(), qty], dt.Schema(tuple(
        dt.Field(k, dt.date32 if k != "l_quantity" else dt.int64, False)
        for k in raw)))
    pred = lt_eq(ship, Scalar(cutoff, dt.date32))
    _reset_counts()
    with watch("compact", "filter") as calls:
        out = filter_table(table, pred)
    launches = _read_counts(f"{what} Q1 filter_table", "compact")
    keep = ship.values <= cutoff
    for name, col in zip(table.column_names, table.columns):
        _same_bits(out.column(name).values, col.values[keep],
                   f"{what} Q1 filter_table {name}")
    share = float(keep.sum()) / n
    print(f"{what}: 1998-12-01 - 90 days (day_time) = 1998-09-02; Q1's "
          f"WHERE l_shipdate <= 1998-09-02 keeps {int(keep.sum()):,} rows "
          f"({share:.4%}), one K1 launch, equal to a[keep]", flush=True)
    del out
    timed("Q1 filter_table", lambda: filter_table(table, pred))
    (k_keep, arrays), kwargs = calls[0][0][:2], calls[0][1]
    del calls
    site = _compact_site(f"phase 26 Q1 filter_table, {n:,} rows, "
                         f"{share:.2%} kept", k_keep, tuple(arrays),
                         kwargs.get("out_cap"),
                         lambda: tuple(a[k_keep] for a in arrays),
                         kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    del site, k_keep, arrays, keep, pred

    # group_by year, quarter of l_shipdate: the small-domain plan on K2
    gtable = Table([pt.year(ship), pt.quarter(ship), qty], dt.Schema((
        dt.Field("y", dt.int32, False), dt.Field("q", dt.int32, False),
        dt.Field("l_quantity", dt.int64, False))))
    aggs = [AggSpec("l_quantity", "count_all"), AggSpec("l_quantity", "sum")]
    _reset_counts()
    with watch("grouped_aggregate", "groupby") as k2_calls:
        out = group_by(gtable, ["y", "q"], aggs)
    gb_launches = _read_counts(f"{what} group_by y, q", "grouped_aggregate")
    base, yq = _year_quarter_table(dev)
    row = yq[ship.values.to(torch.int64) - base]
    key = (row[:, 0] - 1992) * 4 + row[:, 1] - 1
    counts = torch.bincount(key, minlength=36)
    sums = torch.zeros(36, dtype=torch.int64, device=dev).index_add_(
        0, key, qty.values)
    present = counts.nonzero().squeeze(1)
    got = [out.column(c).values for c in ("y", "q", "l_quantity_count_all",
                                          "l_quantity_sum")]
    want = [(present // 4 + 1992).to(torch.int32),
            (present % 4 + 1).to(torch.int32), counts[present],
            sums[present]]
    if any(g.shape != w.shape or not torch.equal(g, w)
           for g, w in zip(got, want)):
        raise AssertionError(f"{what}: group_by y, q differs from the "
                             f"bincount of the generator's years and "
                             f"quarters")
    print(f"{what}: group_by year, quarter: {out.num_rows} groups, counts "
          f"and sums equal to bincount / index_add_ over datetime's "
          f"calendar", flush=True)
    del out, row, key
    timed("group_by year, quarter", lambda: group_by(gtable, ["y", "q"],
                                                     aggs))
    site = _k2_site(f"phase 26 small-domain plan, year x quarter, {n:,} "
                    f"rows x {k2_calls[0][0][1]:,} codes", k2_calls[0])
    del k2_calls, gtable
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, gb_launches["grouped_aggregate"], err))
    del site

    # every date part of l_shipdate, and of a zoned timestamp
    for part in P26_PARTS:
        cpu_calls.append((f"date_part {part}", pt.date_part, ship, part))
    ts = PrimitiveColumn(ship.values.to(torch.int64) * 86_400_000_000
                         + second * 1_000_000, dt.timestamp("us", zone))
    for part in ("hour", "minute", "day", "dow"):
        cpu_calls.append((f"date_part {part} (timestamp[us, {zone}])",
                          pt.date_part, ts, part))

    # receipt - ship as timestamps, its parts, and ship + that duration
    ship_s = cast(ship, dt.timestamp("s"))
    receipt_s = cast(date["l_receiptdate"], dt.timestamp("s"))
    dur = pn.sub(receipt_s, ship_s)
    want = (date["l_receiptdate"].values - ship.values).to(torch.int64) \
        * 86_400
    if dur.dtype != dt.duration("s") or not torch.equal(dur.values, want):
        raise AssertionError(f"{what}: receipt - ship differs")
    timed("sub (timestamp - timestamp)", lambda: pn.sub(receipt_s, ship_s))
    for part in ("day", "hour", "second", "week"):
        cpu_calls.append((f"date_part {part} (duration[s])", pt.date_part,
                          dur, part))
    back = pn.add(ship_s, dur)
    if back.dtype != receipt_s.dtype or \
            not torch.equal(back.values, receipt_s.values):
        raise AssertionError(f"{what}: ship + (receipt - ship) != receipt")
    timed("add (timestamp + duration)", lambda: pn.add(ship_s, dur))
    del ship_s, receipt_s, want, back

    # one month later, year_month: the end-of-month clamp
    month = PrimitiveColumn(torch.ones(n, dtype=torch.int32, device=dev),
                            dt.interval("year_month"))
    cpu_calls.append(("add_interval (one month, year_month)",
                      pt.add_interval, ship, month))
    for name, fn, *args in cpu_calls:
        timed(name, lambda: fn(*args))
    print(f"phase 26 times (CUDA events, median of 5; ms): "
          + json.dumps(times), flush=True)
    return entries, [(f"{what}: {name}", fn, args)
                     for name, fn, *args in cpu_calls]


def check_against_cpu(checks) -> None:
    """Each (what, fn, args) call on the card equal to the same call on
    CPU copies of its arguments, bit for bit."""
    for what, fn, args in checks:
        got = fn(*args)
        torch.cuda.synchronize()
        _same(got, fn(*[_cpu(a) for a in args]), f"{what} against the CPU "
              f"route")
        del got
    print(f"{len(checks)} calls equal to the CPU route, bit for bit",
          flush=True)


# ---- phase 27: nested, decimal and interval layouts at config 2's size -----

P27_DECIMAL_ROWS = 1_000_000       # host-exact decimal arithmetic


def p27_table(dev):
    """Config 2's 10M rows (rng(1)) with a column of each layout, made on
    the card from splitmix."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn, ListColumn,
                                             PrimitiveColumn, StructColumn)
    from arrow_tpu_torch.core import nested as nd
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops.strings import dictionary_decode
    n = CONFIG2_ROWS
    host, (i32, ts, dcol) = config2_inputs(n, dev)
    h = [splitmix(n, k * n, dev) for k in range(8)]

    def offsets(lens, odt):
        return torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]).to(odt)
    lens = _umod(h[0], 8)
    lst = ListColumn(offsets(lens, torch.int32),
                     PrimitiveColumn(splitmix(int(lens.sum()), 9 * n, dev),
                                     dt.int64),
                     _umod(_lsr(h[0], 8), 10) != 0)
    wl = _umod(h[1], 4)
    wn = int(wl.sum())
    words = DictionaryColumn(_umod(splitmix(wn, 10 * n, dev), 1000).to(
        torch.int32), dcol.values)
    llst = ListColumn(offsets(wl, torch.int64), dictionary_decode(words),
                      large=True)
    st = StructColumn([i32, dcol], [dt.Field("i32", dt.int32),
                                    dt.Field("d", dcol.dtype)],
                      _umod(h[2], 20) != 0)          # 5% null structs
    fsl = nd.FixedSizeListColumn(PrimitiveColumn(
        (splitmix(4 * n, 11 * n, dev) >> 40).to(torch.float32) / 1024,
        dt.float32), 4)
    fsb = nd.FixedSizeBinaryColumn(torch.stack([h[3], h[4]], 1).contiguous()
                                   .view(torch.uint8))
    unscaled = _umod(h[5], 2 * 10 ** 13) - 10 ** 13
    dec = nd.DecimalColumn(torch.stack([unscaled, unscaled >> 63], 1),
                           dt.decimal128(15, 2))
    mdn = nd.IntervalMDNColumn((_umod(h[6], 25) - 12).to(torch.int32),
                               (_umod(_lsr(h[6], 16), 61) - 30).to(
                                   torch.int32), h[7] >> 20)
    uni = nd.UnionColumn((h[7] & 1).to(torch.int8), None, [
        PrimitiveColumn(h[3] >> 3, dt.int64),
        PrimitiveColumn((h[4] >> 11).to(torch.float64) / 2 ** 20,
                        dt.float64)],
        [dt.Field("i", dt.int64), dt.Field("f", dt.float64)])
    run_lens = 1 + _umod(splitmix(n // 16, 12 * n, dev), 64)
    ends = torch.cumsum(run_lens, 0)
    ends = torch.cat([ends[ends < n], ends.new_full((1,), n)])
    ree = nd.RunEndColumn(ends.to(torch.int32), PrimitiveColumn(
        splitmix(ends.shape[0], 13 * n, dev), dt.int64), n)
    cols = {"i32": i32, "ts": ts, "d": dcol, "list": lst,
            "large_list": llst, "struct": st, "fsl": fsl, "fsb": fsb,
            "decimal": dec, "interval": mdn, "union": uni, "run_end": ree}
    return host, Table(list(cols.values()), dt.Schema(tuple(
        dt.Field(k, c.dtype) for k, c in cols.items())))


def p27_decimal_calls(dec, d64):
    """The decimal calls, host-exact: (name, call)."""
    from arrow_tpu_torch.ops import aggregate as pa, cmp as pc
    from arrow_tpu_torch.ops import numeric as pn
    return [("sum_", lambda: pa.sum_(dec)), ("min_", lambda: pa.min_(dec)),
            ("max_", lambda: pa.max_(dec)), ("add", lambda: pn.add(dec, d64)),
            ("mul", lambda: pn.mul(dec, d64)),
            ("lt (decimal64(18, 3))", lambda: pc.lt(dec, d64))]


def run_phase27(dev, profile: bool) -> list:
    """Phase 27: filter_table, take_table, concat, run_end_encode /
    decode, union_extract and decimals over config 2's 10M rows with a
    column of every layout.  Returns the kernel entries and the calls
    `check_against_cpu` holds to the CPU route."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.ops.boolean import and_kleene, or_kleene
    from arrow_tpu_torch.ops.cast import cast
    from arrow_tpu_torch.ops.cmp import gt, gt_eq
    from arrow_tpu_torch.ops.concat import concat_tables
    from arrow_tpu_torch.ops.filter import filter_table
    from arrow_tpu_torch.ops.ree import run_end_decode, run_end_encode
    from arrow_tpu_torch.ops.select_misc import union_extract
    from arrow_tpu_torch.ops.take import take_table
    n = CONFIG2_ROWS
    host, table = p27_table(dev)
    i32_np, valid_np, ts_np, codes_np = host
    what = f"phase 27, {n:,} rows with a column of every layout"
    print(f"{what}: {len(table.column('list').child):,} list values, "
          f"{len(table.column('large_list').child):,} strings in the large "
          f"list, {table.column('run_end').num_runs:,} runs", flush=True)
    times, entries, cpu_checks = {}, [], []

    def timed(name, fn):
        times[name] = time_ms(fn)
        if profile:
            profile_call(f"{what} {name}", fn)

    i32, ts, dcol = (table.column(c) for c in ("i32", "ts", "d"))
    m1, m2, m3 = config2_run(i32, ts, dcol)
    m4 = gt_eq(cast(i32, dt.int64), Scalar(0, dt.int64))
    preds = {"WHERE": and_kleene(and_kleene(or_kleene(m1, m4), m2), m3),
             "i32 > 0": gt(i32, Scalar(0, dt.int32))}
    keeps = {"WHERE": valid_np & (i32_np >= 0) & (codes_np == 42),
             "i32 > 0": valid_np & (i32_np > 0)}
    for name, pred in preds.items():
        _reset_counts()
        with watch("compact", "filter") as calls:
            out = filter_table(table, pred)
        launches = _read_counts(f"{what} filter_table {name}", "compact")
        if launches["compact"] != 1:
            raise AssertionError(f"{what} filter_table {name}: "
                                 f"{launches['compact']} K1 launches, not 1")
        kept = int(keeps[name].sum())
        if out.num_rows != kept:
            raise AssertionError(f"{what} filter_table {name}: "
                                 f"{out.num_rows} rows, numpy {kept}")
        del out
        timed(f"filter_table {name}", lambda: filter_table(table, pred))
        print(f"{what}: filter_table {name} keeps {kept:,} rows "
              f"({keeps[name].mean():.2%}), one K1 launch; "
              f"{times[f'filter_table {name}']:.4f} ms", flush=True)
        (keep, arrays), kwargs = calls[0][0][:2], calls[0][1]
        del calls
        site = _compact_site(
            f"phase 27 filter_table of every layout, {n:,} rows, "
            f"{keeps[name].mean():.2%} kept", keep, tuple(arrays),
            kwargs.get("out_cap"),
            lambda keep=keep, arrays=arrays: (
                tuple(a[keep] for a in arrays), keep.nonzero()),
            kwargs.get("positions"))
        err = check_site(site, same_compaction, f"K1 at {site.call_site}")
        entries.append(_entry(site, launches["compact"], err))
        del site, keep, arrays
        cpu_checks.append((f"filter_table {name}", filter_table, table,
                           pred))
    del m1, m2, m3, m4

    idx = PrimitiveColumn(torch.argsort(splitmix(n, 14 * n, dev)), dt.int64)
    timed("take_table (permutation)", lambda: take_table(table, idx))
    cpu_checks.append(("take_table by a permutation", take_table, table,
                       idx))

    quarter = n // 4
    parts = [table.slice(i * quarter, quarter) for i in range(4)]
    whole = concat_tables(parts)
    for name, a, b in zip(table.column_names, whole.columns, table.columns):
        if name == "run_end":      # runs meeting at a seam stay apart
            a, b = run_end_decode(a), run_end_decode(b)
        _same(a, b, f"{what}: concat of four slices, {name}")
    del whole
    timed("concat_tables (four slices)", lambda: concat_tables(parts))
    del parts
    print(f"{what}: concat of four {quarter:,}-row slices equal to the "
          f"whole", flush=True)

    ree = table.column("run_end")
    flat = run_end_decode(ree)
    again = run_end_encode(flat)
    _same(again, ree, f"{what}: run_end_encode(run_end_decode(x)) = x")
    _same(run_end_decode(again), flat, f"{what}: decode(encode(y)) = y")
    timed("run_end_decode", lambda: run_end_decode(ree))
    timed("run_end_encode", lambda: run_end_encode(flat))
    del flat, again
    cpu_checks.append(("run_end_decode", run_end_decode, ree))
    uni = table.column("union")
    for f in ("i", "f"):
        timed(f"union_extract {f}", lambda: union_extract(uni, f))
        cpu_checks.append((f"union_extract {f}", union_extract, uni, f))
    print(f"{what}: run_end_encode(run_end_decode(x)) = x and "
          f"decode(encode(y)) = y on the card", flush=True)

    k = P27_DECIMAL_ROWS
    dec = table.column("decimal").slice(0, k)
    d64 = cast(PrimitiveColumn(_umod(splitmix(k, 15 * n, dev),
                                     2 * 10 ** 12) - 10 ** 12, dt.int64),
               dt.decimal64(18, 3))
    cpu_dec = dict(p27_decimal_calls(_cpu(dec), _cpu(d64)))
    for name, call in p27_decimal_calls(dec, d64):
        _same(_outcome(call), _outcome(cpu_dec[name]),
              f"{what}: decimal {name} at {k:,} rows against the CPU route")
        times[f"decimal {name} ({k:,} rows)"] = time_ms(call, 3)
    print(f"{what}: decimal sum_, min_, max_, add, mul and lt at {k:,} rows "
          f"(host-exact) equal to the CPU route", flush=True)
    print("phase 27 times (CUDA events, median of 5, the decimals of 3; "
          "ms): " + json.dumps(times), flush=True)
    return entries, [(f"{what}: {name}", fn, args)
                     for name, fn, *args in cpu_checks]


# ---- phase 28: decimal, run-end and nested keys, casts and rows ------------

P28_ROWS = 59_986_052              # TPC-H SF10 lineitem
P28_HOST_ROWS = 1_000_000          # host-ranked keys and text casts (cut)
P28_CPU_ROWS = 1_000_000           # the CPU route: each call's first rows
P28_CPU_HOST_ROWS = 100_000        # ... for the host-ranked and text calls
P28_CURRENT = "1995-06-17"         # TPC-H's CURRENTDATE (spec 4.2.3)


def tpch_lineitem(n: int, dev):
    """lineitem's columns by TPC-H's rules (spec 4.2.3) from splitmix on
    the card: orders of 1-7 lines under sparse keys (the first 8 of every
    32), part keys over SF10's 2M parts, l_extendedprice = l_quantity *
    p_retailprice, discounts 0.00-0.10, taxes 0.00-0.08, the dates and
    quantities of `tpch_dates`, the flags from the receipt and ship dates
    against CURRENTDATE.  Returns the table and the generator's integers
    (cents, codes, line counts)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.nested import DecimalColumn
    from arrow_tpu_torch.core.table import Table
    m = n // 4 + n // 100 + 1_000          # 4 lines an order on average
    lines = 1 + _umod(splitmix(m, 6 * n, dev), 7)
    ends = torch.cumsum(lines, 0)
    orders = int((ends < n).sum()) + 1
    lines = lines[:orders].clone()
    lines[-1] -= int(ends[orders - 1]) - n          # the last order cut
    order = torch.repeat_interleave(torch.arange(orders, device=dev), lines,
                                    output_size=n)
    start = torch.cat([lines.new_zeros(1), torch.cumsum(lines, 0)[:-1]])
    linenumber = (torch.arange(n, device=dev) - start[order] + 1).to(
        torch.int32)
    okeys = (torch.arange(orders, device=dev) // 8) * 32 \
        + torch.arange(orders, device=dev) % 8 + 1
    raw, _, _ = tpch_dates(n, dev)
    qty = raw["l_quantity"]
    part = 1 + _umod(splitmix(n, 7 * n, dev), 2_000_000)
    retail = 90_000 + (part // 10) % 20_001 + 100 * (part % 1_000)
    cents = {"l_quantity": qty * 100, "l_extendedprice": qty * retail,
             "l_discount": _umod(splitmix(n, 8 * n, dev), 11),
             "l_tax": _umod(splitmix(n, 9 * n, dev), 9)}
    current = _days(*map(int, P28_CURRENT.split("-")))
    ret = torch.where(raw["l_receiptdate"] <= current,
                      2 * _umod(splitmix(n, 10 * n, dev), 2), 1)  # R/A, N
    status = (raw["l_shipdate"] > current).to(torch.int32)    # F 0, O 1
    flags = StringColumn.from_pylist(["A", "N", "R"], device=dev)
    stats = StringColumn.from_pylist(["F", "O"], device=dev)
    dec = dt.decimal128(15, 2)
    cols = {"l_orderkey": PrimitiveColumn(okeys[order], dt.int64),
            "l_linenumber": PrimitiveColumn(linenumber, dt.int32),
            **{k: DecimalColumn(torch.stack([v, v >> 63], 1), dec)
               for k, v in cents.items()},
            "l_returnflag": DictionaryColumn(ret.to(torch.int32), flags),
            "l_linestatus": DictionaryColumn(status.to(torch.int32), stats),
            "l_shipdate": PrimitiveColumn(raw["l_shipdate"], dt.date32)}
    table = Table(list(cols.values()), dt.Schema(tuple(
        dt.Field(k, c.dtype, False) for k, c in cols.items())))
    return table, {**cents, "lines": lines, "okeys": okeys,
                   "ship": raw["l_shipdate"], "linenumber": linenumber,
                   "flag": ret, "status": status, "part": part,
                   "commit": raw["l_commitdate"],
                   "receipt": raw["l_receiptdate"]}


def _limb_ints(col) -> torch.Tensor:
    """A decimal128's unscaled values as int64, checked to fit."""
    lo, hi = col.limbs[:, 0], col.limbs[:, 1]
    if not torch.equal(hi, lo >> 63):
        raise AssertionError("a decimal128 key past int64")
    return lo


def _p28_groupby_check(out, g, what: str) -> None:
    """group_by [l_discount, l_tax] against bincount / index_add_ /
    scatter_reduce_ over disc * 9 + tax."""
    code = g["l_discount"] * 9 + g["l_tax"]
    cnt = torch.bincount(code, minlength=99)
    present = cnt.nonzero().squeeze(1)
    sums = torch.zeros(99, dtype=torch.int64, device=code.device).index_add_(
        0, code, g["linenumber"].to(torch.int64))
    ship = g["ship"]
    lo = torch.full((99,), 2 ** 31 - 1, dtype=torch.int32,
                    device=code.device).scatter_reduce_(0, code, ship, "amin")
    hi = torch.full((99,), -2 ** 31, dtype=torch.int32,
                    device=code.device).scatter_reduce_(0, code, ship, "amax")
    got = [_limb_ints(out.column("l_discount")), _limb_ints(out.column(
        "l_tax")), out.column("l_linenumber_count_all").values,
        out.column("l_linenumber_sum").values.to(torch.int64),
        out.column("l_shipdate_min").values,
        out.column("l_shipdate_max").values]
    want = [present // 9, present % 9, cnt[present], sums[present],
            lo[present], hi[present]]
    for name, a, b in zip(("discount", "tax", "count", "sum", "min", "max"),
                          got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"independent computation")


def _p28_sorted_check(idx: torch.Tensor, price: torch.Tensor,
                      okey: torch.Tensor, what: str) -> None:
    """O(n): a permutation; prices non-increasing, then order keys
    non-decreasing, then rows ascending."""
    n = price.shape[0]
    if not torch.equal(torch.bincount(idx, minlength=n),
                       torch.ones(n, dtype=torch.int64, device=idx.device)):
        raise AssertionError(f"{what}: not a permutation")
    p, k = price[idx], okey[idx]
    dp, dk, di = p[1:] - p[:-1], k[1:] - k[:-1], idx[1:] - idx[:-1]
    bad = (dp > 0) | ((dp == 0) & ((dk < 0) | ((dk == 0) & (di <= 0))))
    if bool(bad.any()):
        raise AssertionError(f"{what}: rows out of order")


def _p28_list_key(n: int, dev):
    """A List<Int64> column of 0-3 values in [0, 5), 10% null rows."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import ListColumn, PrimitiveColumn
    h = splitmix(n, 11 * n, dev)
    lens = _umod(h, 4)
    offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    child = _umod(splitmix(int(offs[-1]), 12 * n, dev), 5)
    return ListColumn(offs.to(torch.int32), PrimitiveColumn(child, dt.int64),
                      _umod(_lsr(h, 8), 10) != 0)


def once_ms(fn):
    """(fn(), its CUDA-event time in ms): one run, for calls whose host
    work takes seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def _same_values(got, want, what: str) -> None:
    """A round trip's column equal to its source: the same validity (a
    cast back may add an all-true mask) and the same storage bits where
    valid (a cast writes zeros under nulls)."""
    planes = lambda c: [c.values] if hasattr(c, "values") else \
        [c.months, c.days, c.nanos]
    m = want.is_valid_mask()
    if got.dtype != want.dtype or not torch.equal(got.is_valid_mask(), m) \
            or not all(torch.equal(_bits(a[m]), _bits(b[m]))
                       for a, b in zip(planes(got), planes(want))):
        raise AssertionError(f"{what}: differs from the source")


def _py_key(v):
    """Python order of a list row with None first (the reference's tuple
    keys of list<int64> with child nulls first)."""
    return (0,) if v is None else (1, tuple(v))


def p28_cast_columns(dev):
    """Phase 27's 10M rows' List<Int64>, Struct{Int32, Dictionary<Utf8>},
    RunEnd<Int32, Int64> and a month_day_nano of whole nanoseconds with
    zero months and days, made on the card from splitmix."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (ListColumn, PrimitiveColumn,
                                             StructColumn)
    from arrow_tpu_torch.core import nested as nd
    n = CONFIG2_ROWS
    _, (i32, _, dcol) = config2_inputs(n, dev)
    h = [splitmix(n, k * n, dev) for k in (20, 21, 22)]
    lens = _umod(h[0], 8)
    offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    x = splitmix(int(offs[-1]), 23 * n, dev)
    lst = ListColumn(offs.to(torch.int32), PrimitiveColumn(
        x >> _umod(x, 64), dt.int64), _umod(_lsr(h[0], 8), 10) != 0)
    st = StructColumn([i32, dcol], [dt.Field("i32", dt.int32),
                                    dt.Field("d", dcol.dtype)],
                      _umod(h[2], 20) != 0)
    run_lens = 1 + _umod(splitmix(n // 16, 24 * n, dev), 64)
    ends = torch.cumsum(run_lens, 0)
    ends = torch.cat([ends[ends < n], ends.new_full((1,), n)])
    ree = nd.RunEndColumn(ends.to(torch.int32), PrimitiveColumn(
        splitmix(ends.shape[0], 25 * n, dev) >> 12, dt.int64), n)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    mdn = nd.IntervalMDNColumn(zeros, zeros, h[1] >> 2,
                               _umod(h[2], 7) != 0)
    return {"list": lst, "struct": st, "run_end": ree, "interval": mdn}


def p28_host_columns(table, g, dev):
    """The 1M-row inputs of the text casts: l_shipdate, an Int64, a
    Float64 of every exponent and a month_day_nano of months and days
    (the reference parses no 'mins' or 'secs', so its text of a clock
    does not come back)."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.nested import IntervalMDNColumn
    k = P28_HOST_ROWS
    h = splitmix(k, 13 * k, dev)
    bits = (h & ~(0x7FF << 52)) | (_umod(_lsr(h, 3), 2046) + 1) << 52
    mdn = IntervalMDNColumn((1 + _umod(h, 24)).to(torch.int32),
                            (_umod(_lsr(h, 16), 61) - 30).to(torch.int32),
                            torch.zeros(k, dtype=torch.int64, device=dev))
    return {"date": table.column("l_shipdate").slice(0, k),
            "int64": PrimitiveColumn(splitmix(k, 14 * k, dev), dt.int64),
            "float64": PrimitiveColumn(bits.view(torch.float64), dt.float64),
            "interval": mdn}


def _head(x, rows: int):
    """A column's or a table's first `rows` rows (a view); any other
    argument as it is."""
    from arrow_tpu_torch.core.column import Column
    from arrow_tpu_torch.core.table import Table
    if isinstance(x, Table):
        return x.slice(0, min(rows, x.num_rows))
    if isinstance(x, Column):
        return x.slice(0, min(rows, len(x)))
    return x


def run_phase28(dev, profile: bool) -> list:
    """Phase 28: TPC-H SF10 lineitem's decimal keys through group_by,
    sort_table and rank, a run-end key, struct and list keys, the
    remaining casts and RowConverter.  Returns the kernel entries and the
    calls `check_against_cpu` holds to the CPU route: each call over the
    first P28_CPU_ROWS rows of its inputs (P28_CPU_HOST_ROWS for the
    host-ranked keys and the text casts), on the card and on the CPU
    alike.  The full-size calls on the card are held to independent
    computations inside the phase."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (PrimitiveColumn, StringColumn,
                                             StructColumn)
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops import cast as pc
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    from arrow_tpu_torch.ops.ree import run_end_encode
    from arrow_tpu_torch.ops.row_format import (RowConverter, SortField,
                                                SortOptions)
    from arrow_tpu_torch.ops.sort import (SortColumn, lexsort_to_indices,
                                          rank, sort_table, sort_to_indices)
    from arrow_tpu_torch.ops.strings import dictionary_decode
    from arrow_tpu_torch.ops.take import take_table
    n = P28_ROWS
    what = f"phase 28, TPC-H SF10 lineitem, {n:,} rows"
    torch.cuda.reset_peak_memory_stats()
    table, g = tpch_lineitem(n, dev)
    limbs = nbytes(*[c.limbs for c in table.columns if hasattr(c, "limbs")])
    print(f"{what}: {g['okeys'].shape[0]:,} orders, {limbs / 1e9:.2f} GB of "
          f"decimal limbs, peak {peak_gib():.2f} GiB", flush=True)
    times, entries, cpu_calls, host_calls = {}, [], [], []

    def timed(name, fn):
        times[name] = time_ms(fn)
        if profile:
            profile_call(f"{what} {name}", fn)

    def once(name, fn):
        """A host-bound call's result and its one CUDA-event time."""
        out, times[name] = once_ms(fn)
        return out

    # group_by l_discount, l_tax: the sort plan, K1 and K2
    aggs = [AggSpec("l_linenumber", "count_all"),
            AggSpec("l_linenumber", "sum"), AggSpec("l_shipdate", "min"),
            AggSpec("l_shipdate", "max")]
    keys = ["l_discount", "l_tax"]
    _reset_counts()
    with watch("compact", "groupby") as k1_calls, \
            watch("grouped_aggregate", "groupby") as k2_calls:
        out = group_by(table, keys, aggs)
    launches = _read_counts(f"{what} group_by discount, tax", "compact")
    if launches["grouped_aggregate"] <= 0:
        raise AssertionError(f"{what}: group_by discount, tax never "
                             f"launched grouped_aggregate")
    _p28_groupby_check(out, g, f"{what} group_by discount, tax")
    print(f"{what}: group_by discount, tax: {out.num_rows} groups on the "
          f"sort plan, equal to bincount / index_add_ / scatter_reduce_ "
          f"over disc * 9 + tax", flush=True)
    del out
    timed("group_by discount, tax", lambda: group_by(table, keys, aggs))
    cpu_calls.append(("group_by discount, tax", group_by, table, keys, aggs))
    (keep, arrays), kwargs = k1_calls[0][0][:2], k1_calls[0][1]
    site = _compact_site(f"phase 28 sort-plan run starts, decimal (discount,"
                         f" tax) keys, {n:,} rows", keep, tuple(arrays),
                         kwargs.get("out_cap"),
                         lambda: (arrays[0][keep], keep.nonzero()),
                         kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    site = _k2_site(f"phase 28 sort plan, min/max of l_shipdate over "
                    f"{k2_calls[0][0][1]} (discount, tax) groups, {n:,} rows",
                    k2_calls[0])
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, launches["grouped_aggregate"], err))
    del site, keep, arrays, k1_calls, k2_calls

    # sort_table by price descending, then order key; rank of the price
    names = ["l_orderkey", "l_extendedprice", "l_shipdate"]
    sub = Table([table.column(c) for c in names], dt.Schema(tuple(
        table.schema.field(c) for c in names)))
    by = [("l_extendedprice", SortOptions(descending=True)),
          ("l_orderkey", SortOptions())]
    idx = lexsort_to_indices([SortColumn(sub.column(c), o) for c, o in by])
    idx = idx.values.to(torch.int64)
    _p28_sorted_check(idx, g["l_extendedprice"], sub.column(
        "l_orderkey").values, f"{what} sort_table price desc, orderkey")
    _same(sort_table(sub, by), take_table(sub, idx),
          f"{what} sort_table against take_table by its order")
    print(f"{what}: sort_table by price descending, order key: a "
          f"permutation, prices non-increasing, ties by order key and row",
          flush=True)
    del idx
    timed("sort_table price desc, orderkey", lambda: sort_table(sub, by))
    cpu_calls.append(("sort_table price desc, orderkey", sort_table, sub,
                      by))
    price = table.column("l_extendedprice")
    _reset_counts()
    with watch("compact", "sort") as k1_calls:
        r = rank(price)
    launches = _read_counts(f"{what} rank l_extendedprice", "compact")
    cents = g["l_extendedprice"]
    want = torch.searchsorted(torch.sort(cents).values, cents, right=True)
    if not torch.equal(r.to(torch.int64), want):
        raise AssertionError(f"{what}: rank differs from the searchsorted "
                             f"rank of the generator's cents")
    print(f"{what}: rank of l_extendedprice equal to a searchsorted rank",
          flush=True)
    del r, want
    timed("rank l_extendedprice", lambda: rank(price))
    cpu_calls.append(("rank l_extendedprice", rank, price))
    (keep, arrays), kwargs = k1_calls[0][0][:2], k1_calls[0][1]
    site = _compact_site(f"phase 28 rank run starts, decimal l_extendedprice"
                         f", {n:,} rows", keep, tuple(arrays), None,
                         lambda: keep.nonzero(), kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    del site, keep, arrays, k1_calls

    # group_by run_end_encode(l_orderkey): 15M groups
    ree = run_end_encode(table.column("l_orderkey"))
    rtab = Table([ree, table.column("l_linenumber")], dt.Schema((
        dt.Field("k", ree.dtype), dt.Field("v", dt.int32))))
    ragg = [AggSpec("v", "count_all")]
    _reset_counts()
    with watch("compact", "groupby") as k1_calls:
        out = group_by(rtab, ["k"], ragg)
    launches = _read_counts(f"{what} group_by run-end l_orderkey", "compact")
    if not torch.equal(out.column("v_count_all").values, g["lines"]) or \
            out.column("k").dtype != ree.dtype or not torch.equal(
                out.column("k").values.values, g["okeys"]):
        raise AssertionError(f"{what}: group_by run-end l_orderkey differs "
                             f"from the generator's line counts")
    print(f"{what}: group_by run_end_encode(l_orderkey): {out.num_rows:,} "
          f"groups ({ree.num_runs:,} runs), counts equal to the generator's",
          flush=True)
    del out
    timed("group_by run-end l_orderkey", lambda: group_by(rtab, ["k"], ragg))
    cpu_calls.append(("group_by run-end l_orderkey", group_by, rtab, ["k"],
                      ragg))
    (keep, arrays), kwargs = k1_calls[0][0][:2], k1_calls[0][1]
    site = _compact_site(f"phase 28 sort-plan run starts, run-end l_orderkey"
                         f", {n:,} rows", keep, tuple(arrays),
                         kwargs.get("out_cap"),
                         lambda: (arrays[0][keep], keep.nonzero()),
                         kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    del site, keep, arrays, k1_calls, ree

    # struct and list keys at P28_HOST_ROWS (host comparator ranks)
    k = P28_HOST_ROWS
    flag = table.column("l_returnflag").slice(0, k)
    stat = table.column("l_linestatus").slice(0, k)
    st = StructColumn([flag, stat], [dt.Field("f", flag.dtype),
                                     dt.Field("s", stat.dtype)])
    stab = Table([st, table.column("l_linenumber").slice(0, k)], dt.Schema((
        dt.Field("k", st.dtype), dt.Field("v", dt.int32))))
    _reset_counts()
    with watch("compact", "groupby") as k1_calls:
        out = once(f"group_by struct (flag, status) ({k:,} rows)",
                   lambda: group_by(stab, ["k"], ragg))
    launches = _read_counts(f"{what} group_by struct (flag, status), "
                            f"{k:,} rows", "compact")
    code = g["flag"][:k] * 2 + g["status"][:k]
    cnt = torch.bincount(code, minlength=6)
    if not torch.equal(out.column("v_count_all").values,
                       cnt[cnt.nonzero().squeeze(1)]):
        raise AssertionError(f"{what}: group_by struct differs from the "
                             f"bincount of flag * 2 + status")
    del out
    host_calls.append((f"group_by struct (flag, status) ({k:,} rows)",
                       group_by, stab, ["k"], ragg))
    (keep, arrays), kwargs = k1_calls[0][0][:2], k1_calls[0][1]
    site = _compact_site(f"phase 28 sort-plan run starts, struct (flag, "
                         f"status) key, {k:,} rows", keep, tuple(arrays),
                         kwargs.get("out_cap"),
                         lambda: (arrays[0][keep], keep.nonzero()),
                         kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    del site, keep, arrays, k1_calls
    sby = [("k", SortOptions()), ("v", SortOptions(descending=True))]
    got = once(f"sort_table struct key ({k:,} rows)",
               lambda: sort_table(stab, sby))
    c = got.column("k").children
    key = (c[0].codes.to(torch.int64) * 2 + c[1].codes) * 8 + \
        (7 - got.column("v").values.to(torch.int64))
    if bool((key[1:] < key[:-1]).any()):
        raise AssertionError(f"{what}: sort_table by the struct key out of "
                             f"order")
    del got, c, key
    host_calls.append((f"sort_table struct key ({k:,} rows)", sort_table,
                       stab, sby))
    lst = _p28_list_key(k, dev)
    rows = lst.to_pylist()
    order = once(f"sort_to_indices List<Int64> ({k:,} rows)",
                 lambda: sort_to_indices(lst))
    if sorted(range(k), key=lambda i: _py_key(rows[i])) != \
            order.values.to(torch.int64).cpu().tolist():
        raise AssertionError(f"{what}: sort_to_indices of the list key "
                             f"differs from Python's stable sort")
    del rows, order
    host_calls.append((f"sort_to_indices List<Int64> ({k:,} rows)",
                       sort_to_indices, lst))
    print(f"{what}: struct key group_by (bincount) and sort_table, list key "
          f"sort_to_indices (Python's stable sort) at {k:,} rows", flush=True)

    # casts on the card at 10M rows
    cc = p28_cast_columns(dev)
    dev_casts = [
        ("List<Int64> -> List<Int32>", cc["list"], dt.list_(dt.int32)),
        ("List<Int64> -> LargeList<Int64>", cc["list"],
         dt.large_list(dt.int64)),
        ("Struct{Int32, Dictionary} -> Struct{Int64, Dictionary<int64>}",
         cc["struct"], dt.struct([dt.Field("i32", dt.int64), dt.Field(
             "d", dt.dictionary(dt.int64, dt.utf8))])),
        ("RunEnd<Int32, Int64> -> RunEnd<Int64, Float64>", cc["run_end"],
         dt.run_end_encoded(dt.int64, dt.float64)),
        ("IntervalMDN -> duration[ns]", cc["interval"], dt.duration("ns"))]
    for name, col, to in dev_casts:
        timed(f"cast {name}", lambda col=col, to=to: pc.cast(col, to))
        cpu_calls.append((f"cast {name}", pc.cast, col, to))
    r2 = pc.cast(cc["run_end"], dt.run_end_encoded(dt.int64, dt.float64))
    if r2.num_runs != cc["run_end"].num_runs or not torch.equal(
            r2.values.values, cc["run_end"].values.values.to(torch.float64)):
        raise AssertionError(f"{what}: the run-end cast lost its runs")
    dur = pc.cast(cc["interval"], dt.duration("ns"))
    _same_values(pc.cast(dur, dt.interval("month_day_nano")),
                 cc["interval"],
                 f"{what}: month_day_nano -> duration -> month_day_nano")
    timed("cast duration[ns] -> IntervalMDN",
          lambda: pc.cast(dur, dt.interval("month_day_nano")))
    cpu_calls.append(("cast duration[ns] -> IntervalMDN", pc.cast, dur,
                      dt.interval("month_day_nano")))
    del r2, dur
    print(f"{what}: list, struct, run-end (runs kept) and interval casts at "
          f"{CONFIG2_ROWS:,} rows on the card", flush=True)

    # text casts at P28_HOST_ROWS (host parsing and formatting)
    hc = p28_host_columns(table, g, dev)
    for name in ("date", "int64", "float64", "interval"):
        col = hc[name]
        text = once(f"cast {name} -> utf8 ({k:,} rows)",
                    lambda: pc.cast(col, dt.utf8))
        back = once(f"cast utf8 -> {name} ({k:,} rows)",
                    lambda: pc.cast(text, col.dtype))
        _same_values(back, col, f"{what}: {name} -> utf8 -> {name}")
        host_calls.append((f"cast {name} -> utf8 ({k:,} rows)", pc.cast,
                           col, dt.utf8))
        host_calls.append((f"cast utf8 -> {name} ({k:,} rows)", pc.cast,
                           text, col.dtype))
    second = _umod(splitmix(k, 15 * k, dev), 86_400)
    days = hc["date"].values.to(torch.int64)
    stamps = StringColumn.from_pylist(
        [f"{d}T{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}" for d, s in
         zip(pc.cast(hc["date"], dt.utf8).to_pylist(), second.tolist())],
        device=dev)
    ts = once(f"cast utf8 -> timestamp[us] ({k:,} rows)",
              lambda: pc.cast(stamps, dt.timestamp("us")))
    if not torch.equal(ts.values, (days * 86_400 + second) * 1_000_000):
        raise AssertionError(f"{what}: utf8 -> timestamp[us] differs from "
                             f"the closed form")
    host_calls.append((f"cast utf8 -> timestamp[us] ({k:,} rows)", pc.cast,
                       stamps, dt.timestamp("us")))
    raw = pc.cast(stamps, dt.binary)
    enc = once(f"base64_encode ({k:,} rows)", lambda: pc.base64_encode(raw))
    _same(once(f"base64_decode ({k:,} rows)", lambda: pc.base64_decode(enc)),
          raw, f"{what}: base64 round trip")
    host_calls.append((f"base64_encode ({k:,} rows)", pc.base64_encode,
                       raw))
    host_calls.append((f"base64_decode ({k:,} rows)", pc.base64_decode,
                       enc))
    print(f"{what}: date, int64, float64 (bits) and interval text round "
          f"trips, utf8 -> timestamp[us] (closed form) and base64 at {k:,} "
          f"rows", flush=True)
    del table, sub, price, rtab, g

    # RowConverter over config 2's 10M rows
    _, (i32, tsc, dcol) = config2_inputs(CONFIG2_ROWS, dev)
    cols = [i32, tsc, dcol, dictionary_decode(dcol)]
    conv = RowConverter([SortField() for _ in cols])
    rows = conv.convert_columns(cols)
    for name, got, want in zip(("i32", "ts", "dictionary", "words"),
                               conv.convert_rows(rows, cols), cols):
        gv = got.validity if got.validity is not None else None
        if (gv is None) != (want.validity is None) or (
                gv is not None and not torch.equal(gv, want.validity)):
            raise AssertionError(f"{what}: convert_rows {name} validity")
        m = want.is_valid_mask()
        if name == "words":
            same = torch.equal(got.offsets.to(torch.int64),
                               want.offsets.to(torch.int64)) and \
                torch.equal(got.data, want.data)
        else:
            a, b = (got.codes, want.codes) if name == "dictionary" \
                else (got.values, want.values)
            same = torch.equal(_bits(a[m]), _bits(b[m]))
        if not same:
            raise AssertionError(f"{what}: convert_rows {name}")
    if not torch.equal(rows.argsort().to(torch.int64), lexsort_to_indices(
            [SortColumn(c) for c in cols]).values.to(torch.int64)):
        raise AssertionError(f"{what}: Rows.argsort differs from "
                             f"lexsort_to_indices")
    print(f"RowConverter over config 2's {CONFIG2_ROWS:,} rows: "
          f"{rows.data.shape[1]} bytes a row; convert_rows gives back every "
          f"column; Rows.argsort equals lexsort_to_indices", flush=True)
    timed("RowConverter.convert_columns (config 2)",
          lambda: conv.convert_columns(cols))
    timed("Rows.argsort (config 2)", rows.argsort)
    cpu_calls.append(("RowConverter.convert_columns (config 2)",
                      lambda *c: conv.convert_columns(c).data, *cols))
    print(f"phase 28 peak device memory {peak_gib():.2f} GiB; times (CUDA "
          f"events: median of 5, host-bound calls one run; ms): "
          + json.dumps(times), flush=True)
    return entries, [
        (f"{what}: {name}, first {rows:,} rows", fn,
         [_head(a, rows) for a in args])
        for calls, rows in ((cpu_calls, P28_CPU_ROWS),
                            (host_calls, P28_CPU_HOST_ROWS))
        for name, fn, *args in calls]


# ---- phase 29: TPC-H SF10's string predicates ------------------------------

P29_ROWS = {"part": 2_000_000, "supplier": 100_000, "customer": 1_500_000,
            "orders": 15_000_000}          # TPC-H SF10 (spec 4.2.5)
P29_REGEX_ROWS = 1_000_000         # regexp_match (cut: a Python list a row)
P29_POOL_BYTES = 16 << 20          # the text pool comments are cut from

# spec 4.2.3: P_NAME's 92 colours, P_TYPE's and P_CONTAINER's syllables
P29_COLOURS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
P29_TYPES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
             ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
             ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
P29_CONTAINERS = (("SM", "LG", "MED", "JUMBO", "WRAP"),
                  ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))


def _weighted(spec: str):
    """'word:weight ...' (underscores for spaces) -> (words, p)."""
    pairs = [w.rsplit(":", 1) for w in spec.split()]
    weights = np.array([float(k) for _, k in pairs])
    return [w.replace("_", " ") for w, _ in pairs], weights / weights.sum()


# spec 4.2.2.13's word classes, with weights as dbgen's dists.dss gives
# them (written from the distribution file's published text)
P29_GRAMMAR = {
    "noun": _weighted(
        "packages:40 requests:40 accounts:40 deposits:40 foxes:20 ideas:20 "
        "theodolites:20 pinto_beans:20 instructions:20 dependencies:10 "
        "excuses:10 platelets:10 asymptotes:10 courts:5 dolphins:5 "
        "multipliers:1 sauternes:1 warthogs:1 frets:1 dinos:1 attainments:1 "
        "somas:1 Tiresias:1 patterns:1 forges:1 braids:1 frays:1 "
        "warhorses:1 dugouts:1 notornis:1 epitaphs:1 pearls:1 tithes:1 "
        "waters:1 orbits:1 gifts:1 sheaves:1 depths:1 sentiments:1 decoys:1 "
        "realms:1 pains:1 grouches:1 escapades:1 hockey_players:1"),
    "verb": _weighted(
        "sleep:20 wake:20 are:20 cajole:20 haggle:20 nag:10 use:10 boost:10 "
        "affix:5 detect:5 integrate:5 maintain:1 nod:1 was:1 lose:1 "
        "sublate:1 solve:1 thrash:1 promise:1 engage:1 hinder:1 print:1 "
        "x-ray:1 breach:1 eat:1 grow:1 impress:1 mold:1 poach:1 serve:1 "
        "run:1 dazzle:1 snooze:1 doze:1 unwind:1 kindle:1 play:1 hang:1 "
        "believe:1 doubt:1"),
    "adjective": _weighted(
        "special:20 pending:20 unusual:20 express:20 furious:1 sly:1 "
        "careful:1 blithe:1 quick:1 fluffy:1 slow:1 quiet:1 ruthless:1 "
        "thin:1 close:1 dogged:1 daring:1 brave:1 stealthy:1 permanent:1 "
        "enticing:1 idle:1 busy:1 regular:50 final:40 ironic:40 even:30 "
        "bold:20 silent:10"),
    "adverb": _weighted(
        "sometimes:1 always:1 never:1 furiously:50 slyly:50 carefully:50 "
        "blithely:40 quickly:30 fluffily:20 slowly:1 quietly:1 ruthlessly:1 "
        "thinly:1 closely:1 doggedly:1 daringly:1 bravely:1 stealthily:1 "
        "permanently:1 enticingly:1 idly:1 busily:1 regularly:1 finally:1 "
        "ironically:1 evenly:1 boldly:1 silently:1"),
    "preposition": _weighted(
        "about:50 above:50 according_to:50 across:50 after:50 against:40 "
        "along:40 alongside_of:30 among:30 around:20 at:10 atop:1 before:1 "
        "behind:1 beneath:1 beside:1 besides:1 between:1 beyond:1 by:1 "
        "despite:1 during:1 except:1 for:1 from:1 in_place_of:1 inside:1 "
        "instead_of:1 into:1 near:1 of:1 on:1 outside:1 over:1 past:1 "
        "since:1 through:1 throughout:1 to:1 toward:1 under:1 until:1 up:1 "
        "upon:1 without:1 with:1 within:1"),
    "auxiliary": _weighted(
        "do:1 may:1 might:1 shall:1 will:1 would:1 can:1 could:1 should:1 "
        "ought_to:1 must:1 will_have_to:1 shall_have_to:1 could_have_to:1 "
        "should_have_to:1 must_have_to:1 need_to:1 try_to:1"),
    "terminator": _weighted(".:50 ;:1 :::1 ?:1 !:1 --:1"),
}
# spec 4.2.2.14: sentence, noun phrase and verb phrase shapes (weights)
P29_SENTENCES = (("NVT", 3), ("NVPT", 3), ("NVNT", 3), ("NPVNT", 1),
                 ("NPVPT", 1))
P29_NOUN_PHRASES = (("n", 10), ("jn", 20), ("j,jn", 10), ("djn", 50))
P29_VERB_PHRASES = (("v", 30), ("xv", 1), ("vd", 40), ("xvd", 1))


def tpch_text_pool(rng, nbytes: int) -> np.ndarray:
    """dbgen's text pool (spec 4.2.2.13-14): sentences of the grammar,
    space-separated, until `nbytes` bytes; comments are cut from it at
    random offsets."""
    g = {k: (w, p) for k, (w, p) in P29_GRAMMAR.items()}

    def pick(kind, k):
        words, p = g[kind]
        return [words[i] for i in rng.choice(len(words), k, p=p)]

    def shapes(table, k):
        names = [s for s, _ in table]
        w = np.array([x for _, x in table], float)
        return [names[i] for i in rng.choice(len(names), k, p=w / w.sum())]

    out, size = [], 0
    batch = 4096
    while size < nbytes:
        sent = shapes(P29_SENTENCES, batch)
        draws = {k: iter(pick(k, 8 * batch)) for k in g}
        nps = iter(shapes(P29_NOUN_PHRASES, 4 * batch))
        vps = iter(shapes(P29_VERB_PHRASES, 2 * batch))
        phrase = {"n": "noun", "j": "adjective", "d": "adverb",
                  "v": "verb", "x": "auxiliary"}

        def render(shape):
            words = []
            for c in shape:
                if c == ",":
                    words[-1] += ","
                else:
                    words.append(next(draws[phrase[c]]))
            return " ".join(words)
        for s in sent:
            parts = []
            for c in s:
                if c == "N":
                    parts.append(render(next(nps)))
                elif c == "V":
                    parts.append(render(next(vps)))
                elif c == "P":
                    parts.append(next(draws["preposition"]) + " the "
                                 + render(next(nps)))
            text = " ".join(parts) + next(draws["terminator"]) + " "
            out.append(text)
            size += len(text)
    return np.frombuffer("".join(out).encode()[:nbytes], np.uint8).copy()


def _cut(pool: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """(int32 offsets, bytes) of pool[starts[i]:starts[i] + lens[i]]:
    rows of a sliding window over the pool, cut to their lengths, 1M
    rows at a time."""
    w = int(lens.max()) if len(lens) else 0
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.empty(int(offs[-1]), np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([pool, np.zeros(w, np.uint8)]), max(w, 1))
    col = np.arange(max(w, 1))
    for a in range(0, len(lens), 1 << 20):
        b = min(a + (1 << 20), len(lens))
        data[offs[a]:offs[b]] = win[starts[a:b]][col < lens[a:b, None]]
    return offs.astype(np.int32), data


def _join_tokens(ids: np.ndarray, words, sep: bytes = b" "):
    """(int32 offsets, bytes) of each row's words, joined by `sep`:
    ids (n, k) index `words`."""
    table = [w.encode() for w in words] + [sep]
    lens = np.array([len(w) for w in table], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pool = np.frombuffer(b"".join(table), np.uint8)
    n, k = ids.shape
    tok = np.full((n, 2 * k - 1), len(table) - 1, np.int64)
    tok[:, ::2] = ids
    tok = tok.reshape(-1)
    tl = lens[tok]
    off, data = _cut(pool, starts[tok], tl)
    rows = np.zeros(n + 1, np.int64)
    np.cumsum(tl.reshape(n, -1).sum(1), out=rows[1:])
    return rows.astype(np.int32), data


def _distinct_draws(rng, n: int, k: int, m: int) -> np.ndarray:
    """(n, k) draws from range(m), distinct within each row."""
    ids = rng.integers(0, m, (n, k))
    while True:
        s = np.sort(ids, 1)
        bad = (s[:, 1:] == s[:, :-1]).any(1)
        if not bad.any():
            return ids
        ids[bad] = rng.integers(0, m, (int(bad.sum()), k))


def _utf8(offs: np.ndarray, data: np.ndarray, large: bool = False):
    import pyarrow as pa
    t = pa.large_string() if large else pa.string()
    return pa.Array.from_buffers(t, len(offs) - 1, [
        None, pa.py_buffer(offs.astype(np.int64 if large else np.int32)),
        pa.py_buffer(data)])


def tpch_strings(rows: dict, pool_bytes: int, seed: int = SEED):
    """TPC-H's part, supplier, customer and orders string columns by the
    spec's rules (4.2.3; text 4.2.2.10-14), made on the host with numpy
    from `seed`, as pyarrow tables; and the generator's integers, the
    closed forms the calls are held to."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    pool = tpch_text_pool(rng, pool_bytes)

    def text(n, lo, hi):
        lens = rng.integers(lo, hi + 1, n)
        return _cut(pool, rng.integers(0, len(pool) - lens), lens)

    np_ = rows["part"]
    colours = _distinct_draws(rng, np_, 5, len(P29_COLOURS))
    syl = np.stack([rng.integers(0, len(s), np_) for s in P29_TYPES], 1)
    cont = np.stack([rng.integers(0, len(s), np_) for s in P29_CONTAINERS],
                    1)
    mfgr, brand = rng.integers(1, 6, np_), rng.integers(1, 6, np_)
    type_words = [w for s in P29_TYPES for w in s]
    type_ids = syl + np.array([0, 6, 11])
    cont_ids = cont + np.array([0, 5])
    brand_b = np.frombuffer(b"Brand#00" * np_, np.uint8).reshape(np_, 8).copy()
    brand_b[:, 6] += mfgr.astype(np.uint8)
    brand_b[:, 7] += brand.astype(np.uint8)
    part = pa.table({
        "p_partkey": pa.array(np.arange(1, np_ + 1)),
        "p_name": _utf8(*_join_tokens(colours, P29_COLOURS)),
        "p_type": _utf8(*_join_tokens(type_ids, type_words)),
        "p_brand": _utf8(np.arange(np_ + 1, dtype=np.int32) * 8,
                         brand_b.reshape(-1)),
        "p_container": _utf8(*_join_tokens(cont_ids, [w for s in
                                                      P29_CONTAINERS
                                                      for w in s]))})

    ns = rows["supplier"]
    soffs, sdata = text(ns, 25, 100)
    k = max(ns // 2000, 1)                       # SF * 5 rows of each
    marked = rng.choice(ns, 2 * k, replace=False)
    for j, r in enumerate(marked):
        tail = b"Complaints" if j < k else b"Recommends"
        a, b = int(soffs[r]), int(soffs[r + 1])
        gap = int(rng.integers(0, b - a - 18 + 1))
        at_ = a + int(rng.integers(0, b - a - 18 - gap + 1))
        sdata[at_:at_ + 8] = np.frombuffer(b"Customer", np.uint8)
        sdata[at_ + 8 + gap:at_ + 18 + gap] = np.frombuffer(tail, np.uint8)
    supplier = pa.table({"s_suppkey": pa.array(np.arange(1, ns + 1)),
                         "s_comment": _utf8(soffs, sdata)})

    nc = rows["customer"]
    nation = rng.integers(0, 25, nc)
    fields = [(nation + 10, 2), (rng.integers(100, 1000, nc), 3),
              (rng.integers(100, 1000, nc), 3),
              (rng.integers(1000, 10000, nc), 4)]
    phone = np.full((nc, 15), ord("-"), np.uint8)      # CC-LLL-LLL-LLLL
    at_ = 0
    for v, width in fields:
        for j in range(width):
            phone[:, at_ + j] = ord("0") + v // 10 ** (width - 1 - j) % 10
        at_ += width + 1
    phone = phone.reshape(-1)
    acct = rng.integers(-99_999, 1_000_000, nc)
    customer = pa.table({
        "c_custkey": pa.array(np.arange(1, nc + 1)),
        "c_phone": _utf8(np.arange(nc + 1, dtype=np.int32) * 15, phone),
        "c_acctbal": pa.array(acct)})

    no = rows["orders"]
    i = np.arange(no)
    k3 = rng.integers(0, 2 * nc // 3, no)        # custkeys % 3 != 0
    ooffs, odata = text(no, 19, 78)
    orders = pa.table({
        "o_orderkey": pa.array((i // 8) * 32 + i % 8 + 1),
        "o_custkey": pa.array(3 * (k3 // 2) + 1 + k3 % 2),
        "o_comment": _utf8(ooffs, odata)})
    truth = {"colours": colours, "syllables": syl, "mfgr": mfgr,
             "brand": brand, "nation": nation, "acctbal": acct,
             "complaints": np.sort(marked[:k])}
    return {"part": part, "supplier": supplier, "customer": customer,
            "orders": orders}, truth


class CardMeter:
    """Phase 29's timing and launch counting on the card: device calls by
    CUDA-event medians of 5, host-bound calls by one run (`once`), each
    call's first run inside op_timer; launches with the counts set to 0
    just before.  `peak_gib()` is the phase's peak device memory: each
    count's reset also resets the card's peak, so the peak is read before
    every reset and kept."""

    def __init__(self, profile: bool, what: str):
        self.profile, self.what, self.times = profile, what, {}
        self.peak = 0
        self.seconds = {}

    def peak_gib(self) -> float:
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        return self.peak / 2 ** 30

    def timed(self, name, fn):
        from arrow_tpu_torch.utils.trace import op_timer
        with op_timer(name):
            out = fn()
        self.times[name] = time_ms(fn)
        if self.profile:
            profile_call(f"{self.what} {name}", fn)
        return out

    def once(self, name, fn):
        from arrow_tpu_torch.utils.trace import op_timer
        with op_timer(name):
            out, self.times[name] = once_ms(fn)
        return out

    def host(self, name, fn):
        """fn's result; its seconds on the host clock, synced around."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        return out

    def reads(self, fn):
        """fn's result, the host syncs it made (torch's sync debug mode
        warns at each), the card's peak memory over it and the memory
        held before it, GiB."""
        self.peak_gib()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("called a synchronizing" in str(w.message) for w in seen)
        return out, syncs, torch.cuda.max_memory_allocated() / 2 ** 30, held

    def counted(self, name, must, fn, *watches, exactly=None):
        """fn's result, the launch counts over it and each watched
        function's recorded calls; `must` launched at least once, and
        `exactly` times where that is given."""
        self.peak_gib()
        _reset_counts()
        with contextlib.ExitStack() as stack:
            calls = [stack.enter_context(watch(f, m)) for f, m in watches]
            out = fn()
        launches = _read_counts(f"{self.what} {name}", must)
        if exactly is not None and launches[must] != exactly:
            raise AssertionError(f"{self.what} {name}: {launches[must]} "
                                 f"{must} launches, not {exactly}")
        return out, launches, calls


def _same_arrow(got, want, what: str) -> None:
    """A port column, read back through pyarrow, equal to pyarrow's."""
    import pyarrow as pa
    from arrow_tpu_torch.io.interop import column_to_pyarrow
    if isinstance(want, pa.ChunkedArray):
        want = want.combine_chunks()
    ours = column_to_pyarrow(got)
    if ours.type != want.type or not ours.equals(want):
        raise AssertionError(f"{what}: differs from pyarrow.compute")


def _share(mask) -> float:
    return float(mask.values.to(torch.float64).mean())


def p29_calls(tabs: dict, src: dict, truth: dict, meter, regex_rows: int):
    """Phase 29's calls on the port tables `tabs` (made from the pyarrow
    tables `src`), each held to pyarrow.compute and to its closed form;
    returns (the K1 and K2 calls the sites take, their launch counts, the
    calls `check_against_cpu` holds to the CPU route, the kept shares)."""
    import pyarrow as pa
    import pyarrow.compute as pac
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops import cast as pc, cmp, strings as ps
    from arrow_tpu_torch.ops.concat import concat
    from arrow_tpu_torch.ops.filter import filter_table
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    from arrow_tpu_torch.ops.take import take
    from arrow_tpu_torch.utils.display import pretty_format_table
    part, supp, cust, orders = (tabs[k] for k in ("part", "supplier",
                                                  "customer", "orders"))
    sp, ss, sc, so = (src[k] for k in ("part", "supplier", "customer",
                                       "orders"))
    cpu_calls, shares, sites = [], {}, {}
    dev = part.column("p_name").device

    def mask_call(name, fn, col, arg, want, closed=None):
        got = meter.once(name, lambda: fn(col, arg))
        _same_arrow(got, want, name)
        if closed is not None and not np.array_equal(
                got.values.cpu().numpy(), closed):
            raise AssertionError(f"{name}: differs from the generator")
        shares[name] = _share(got)
        cpu_calls.append((name, fn, col, arg))
        return got

    # Q9, Q20, Q14, Q2 over part
    green = P29_COLOURS.index("green")
    has_green = (truth["colours"] == green).any(1)
    pname, ptype = part.column("p_name"), part.column("p_type")
    m9 = mask_call("Q9 contains(p_name, green)", ps.contains, pname, "green",
                   pac.match_substring(sp["p_name"], "green"), has_green)
    m9b = mask_call("Q9 like(p_name, %green%)", ps.like, pname, "%green%",
                    pac.match_like(sp["p_name"], "%green%"), has_green)
    if not torch.equal(m9.values, m9b.values):
        raise AssertionError("Q9: like %green% differs from contains green")
    mask_call("Q20 starts_with(p_name, forest)", ps.starts_with, pname,
              "forest", pac.starts_with(sp["p_name"], "forest"),
              truth["colours"][:, 0] == P29_COLOURS.index("forest"))
    syl = truth["syllables"]
    mask_call("Q14 like(p_type, PROMO%)", ps.like, ptype, "PROMO%",
              pac.match_like(sp["p_type"], "PROMO%"), syl[:, 0] == 5)
    mask_call("Q2 ends_with(p_type, BRASS)", ps.ends_with, ptype, "BRASS",
              pac.ends_with(sp["p_type"], "BRASS"), syl[:, 2] == 2)

    # Q16: the part and supplier predicates
    mask_call("Q16 nlike(p_type, MEDIUM POLISHED%)", ps.nlike, ptype,
              "MEDIUM POLISHED%",
              pac.invert(pac.match_like(sp["p_type"], "MEDIUM POLISHED%")),
              ~((syl[:, 0] == 2) & (syl[:, 1] == 3)))
    mask_call("Q16 neq(p_brand, Brand#45)", cmp.neq, part.column("p_brand"),
              "Brand#45", pac.not_equal(sp["p_brand"], "Brand#45"),
              ~((truth["mfgr"] == 4) & (truth["brand"] == 5)))
    complaints = np.zeros(len(ss), bool)
    complaints[truth["complaints"]] = True
    mask_call("Q16 like(s_comment, %Customer%Complaints%)", ps.like,
              supp.column("s_comment"), "%Customer%Complaints%",
              pac.match_like(ss["s_comment"], "%Customer%Complaints%"),
              complaints)

    # Q13 over orders: the utf8 comment and its other layouts
    com = orders.column("o_comment")
    pat = "%special%requests%"
    want13 = pac.invert(pac.match_like(so["o_comment"], pat))
    m13 = mask_call("Q13 nlike(o_comment)", ps.nlike, com, pat, want13)
    mask_call("Q13 regexp_is_match(o_comment, special.*requests)",
              ps.regexp_is_match, com, "special.*requests",
              pac.match_substring_regex(so["o_comment"], "special.*requests"),
              ~m13.values.cpu().numpy())
    mask_call("Q13 ilike(o_comment, %SPECIAL%REQUESTS%)", ps.ilike, com,
              "%SPECIAL%REQUESTS%",
              pac.match_like(so["o_comment"], "%SPECIAL%REQUESTS%",
                             ignore_case=True), ~m13.values.cpu().numpy())
    layouts = {}
    for name in ("large_utf8", "binary", "utf8_view"):
        to = getattr(dt, name)
        layouts[name] = meter.timed(f"cast o_comment -> {name}",
                                    lambda to=to: pc.cast(com, to))
        cpu_calls.append((f"cast o_comment -> {name}", pc.cast, com, to))
        got = meter.once(f"Q13 nlike(o_comment as {name})",
                         lambda c=layouts[name]: ps.nlike(c, pat))
        if not torch.equal(got.values, m13.values) or got.validity is not None:
            raise AssertionError(f"Q13 nlike over the {name} cast differs "
                                 f"from the utf8 result")
        cpu_calls.append((f"Q13 nlike(o_comment as {name})", ps.nlike,
                          layouts[name], pat))
    large = layouts["large_utf8"]
    if large.offsets.dtype != torch.int64:
        raise AssertionError("the large_utf8 cast lost its int64 offsets")
    ftab = Table([orders.column("o_orderkey"), orders.column("o_custkey"),
                  large], dt.Schema((dt.Field("o_orderkey", dt.int64, False),
                                     dt.Field("o_custkey", dt.int64, False),
                                     dt.Field("o_comment", dt.large_utf8,
                                              False))))
    kept, launches, (k1,) = meter.counted(
        "Q13 filter_table(orders, nlike)", "compact",
        lambda: filter_table(ftab, m13), ("compact", "filter"), exactly=1)
    keep_np = m13.values.cpu().numpy()
    want_t = so.filter(pac.invert(pac.match_like(so["o_comment"], pat)))
    for name in ("o_orderkey", "o_custkey"):
        _same_arrow(kept.column(name), want_t[name].combine_chunks(),
                    f"Q13 filter_table {name}")
    _same_arrow(kept.column("o_comment"), want_t["o_comment"].combine_chunks(
    ).cast("large_string"), "Q13 filter_table o_comment")
    meter.timed("Q13 filter_table(orders, nlike)",
                lambda: filter_table(ftab, m13))
    cpu_calls.append(("Q13 filter_table(orders, nlike)", filter_table, ftab,
                      m13))
    sites["filter"] = (k1[0], launches)
    aggs = [AggSpec("o_orderkey", "count_all")]
    counts, launches, (k1,) = meter.counted(
        "Q13 group_by(o_custkey)", "compact",
        lambda: group_by(kept, ["o_custkey"], aggs), ("compact", "groupby"))
    cust_np = so["o_custkey"].to_numpy()[keep_np]
    bins = np.bincount(cust_np)
    present = np.nonzero(bins)[0]
    if not np.array_equal(counts.column("o_custkey").values.cpu().numpy(),
                          present) or not np.array_equal(
            counts.column("o_orderkey_count_all").values.cpu().numpy(),
            bins[present]):
        raise AssertionError("Q13 group_by(o_custkey) differs from bincount "
                             "over the kept custkeys")
    meter.timed("Q13 group_by(o_custkey)",
                lambda: group_by(kept, ["o_custkey"], aggs))
    cpu_calls.append(("Q13 group_by(o_custkey)", group_by, kept,
                      ["o_custkey"], aggs))
    sites["run_starts"] = (k1[0], launches)

    # Q22: the country code, its dictionary and a group-by on it (K2)
    phone = cust.column("c_phone")
    cc = meter.once("Q22 substring(c_phone, 0, 2)",
                    lambda: ps.substring(phone, 0, 2))
    _same_arrow(cc, pac.utf8_slice_codeunits(sc["c_phone"], 0, 2),
                "Q22 substring")
    cpu_calls.append(("Q22 substring(c_phone, 0, 2)", ps.substring, phone, 0,
                      2))
    code = meter.once("Q22 dictionary_encode(cntrycode)",
                      lambda: ps.dictionary_encode(cc))
    cpu_calls.append(("Q22 dictionary_encode(cntrycode)",
                      ps.dictionary_encode, cc))
    if not np.array_equal(code.codes.cpu().numpy(), truth["nation"]):
        raise AssertionError("Q22: the codes differ from the nation keys")
    qtab = Table([code, cust.column("c_acctbal")], dt.Schema((
        dt.Field("cntrycode", code.dtype, False),
        dt.Field("c_acctbal", dt.int64, False))))
    qaggs = [AggSpec("c_acctbal", "count_all"), AggSpec("c_acctbal", "sum")]
    res, launches, (k2,) = meter.counted(
        "Q22 group_by(cntrycode)", "grouped_aggregate",
        lambda: group_by(qtab, ["cntrycode"], qaggs),
        ("grouped_aggregate", "groupby"))
    nat, acct = truth["nation"], truth["acctbal"]
    sums = np.zeros(25, np.int64)
    np.add.at(sums, nat, acct)
    if res.column("cntrycode").to_pylist() != [f"{c + 10}" for c in
                                               range(25)] or \
            not np.array_equal(res.column("c_acctbal_count_all").values.cpu()
                               .numpy(), np.bincount(nat, minlength=25)) or \
            not np.array_equal(res.column("c_acctbal_sum").values.cpu()
                               .numpy(), sums):
        raise AssertionError("Q22 group_by differs from bincount / add.at "
                             "over the nation keys")
    meter.timed("Q22 group_by(cntrycode)",
                lambda: group_by(qtab, ["cntrycode"], qaggs))
    cpu_calls.append(("Q22 group_by(cntrycode)", group_by, qtab,
                      ["cntrycode"], qaggs))
    sites["dictionary"] = (k2[0], launches)
    print(f"phase 29 Q22 (25 country codes):\n" + pretty_format_table(res),
          flush=True)

    # transforms, lengths, concat and take
    for name, fn, wantf in (("upper", ps.upper, pac.utf8_upper),
                            ("lower", ps.lower, pac.utf8_lower)):
        got = meter.once(f"{name}(p_type)", lambda fn=fn: fn(ptype))
        _same_arrow(got, wantf(sp["p_type"]), f"{name}(p_type)")
        cpu_calls.append((f"{name}(p_type)", fn, ptype))
    for name, fn, wantf in (
            ("length", ps.length, pac.utf8_length),
            ("octet_length", ps.octet_length, pac.binary_length),
            ("bit_length", ps.bit_length,
             lambda a: pac.multiply(pac.binary_length(a),
                                    pa.scalar(8, pa.int32())))):
        got = meter.timed(f"{name}(o_comment)", lambda fn=fn: fn(com))
        _same_arrow(got, wantf(so["o_comment"]), f"{name}(o_comment)")
        cpu_calls.append((f"{name}(o_comment)", fn, com))
    brand, container = part.column("p_brand"), part.column("p_container")
    got = meter.once("concat_elements(p_brand, p_container)",
                     lambda: ps.concat_elements(brand, container))
    _same_arrow(got, pac.binary_join_element_wise(
        sp["p_brand"], sp["p_container"], ""), "concat_elements")
    cpu_calls.append(("concat_elements(p_brand, p_container)",
                      ps.concat_elements, brand, container))
    n = len(large)
    cuts = [0, n // 7, n // 2, n - n // 5, n]
    slices = [large.slice(a, b - a) for a, b in zip(cuts, cuts[1:])]
    whole = meter.timed("concat of four o_comment slices (large_utf8)",
                        lambda: concat(slices))
    if not (torch.equal(whole.offsets, large.offsets)
            and torch.equal(whole.data, large.data)):
        raise AssertionError("concat of the slices differs from the whole")
    cpu_calls.append(("concat of four o_comment slices (large_utf8)",
                      lambda *s: concat(list(s)), *slices))
    perm = torch.from_numpy(np.random.default_rng(SEED).permutation(n)).to(
        dev)
    got = meter.timed("take(o_comment large_utf8, permutation)",
                      lambda: take(large, perm))
    _same_arrow(got, pac.take(so["o_comment"], perm.cpu().numpy()
                              ).combine_chunks().cast("large_string"),
                "take by a permutation")
    cpu_calls.append(("take(o_comment large_utf8, permutation)", take, large,
                      perm))
    sub = ptype.slice(0, min(regex_rows, len(ptype)))
    rx = "(\\w+) (\\w+) (\\w+)"
    got = meter.once(f"regexp_match(p_type, {rx}) ({len(sub):,} rows)",
                     lambda: ps.regexp_match(sub, rx))
    if got.to_pylist() != [s.split(" ") for s in sub.to_pylist()]:
        raise AssertionError("regexp_match differs from the type's words")
    cpu_calls.append((f"regexp_match(p_type) ({len(sub):,} rows)",
                      ps.regexp_match, sub, rx))
    return sites, cpu_calls, shares


def run_phase29(dev, profile: bool):
    """Phase 29: TPC-H SF10's LIKE, substring and case predicates over
    part, supplier, customer and orders, brought onto the card through
    pyarrow.  Returns the kernel entries and the calls held to the CPU
    route."""
    from arrow_tpu_torch.io.interop import table_from_pyarrow, \
        table_to_pyarrow
    from arrow_tpu_torch.ops import strings as ps
    from arrow_tpu_torch.utils.trace import reset_timings, timings
    what = "phase 29, TPC-H SF10 strings"
    t0 = time.perf_counter()
    src, truth = tpch_strings(P29_ROWS, P29_POOL_BYTES)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tabs, load = {}, {}
    for name, t in src.items():
        out, load[name] = once_ms(lambda t=t: table_from_pyarrow(t, dev))
        if not table_to_pyarrow(out).equals(t.combine_chunks().to_batches(
        )[0]):
            raise AssertionError(f"{what}: {name} does not round-trip")
        tabs[name] = out
    com = tabs["orders"].column("o_comment")
    print(f"{what}: {', '.join(f'{k} {v.num_rows:,}' for k, v in src.items())}"
          f" rows made on the host in {gen_s:.1f} s; o_comment "
          f"{com.data.numel():,} bytes; table_from_pyarrow (ms): "
          f"{json.dumps(load)}; each round-trips through table_to_pyarrow",
          flush=True)
    _, copy_ms = once_ms(lambda: ps._host_buffers(com))
    meter = CardMeter(profile, what)
    reset_timings()
    sites, cpu_calls, shares = p29_calls(tabs, src, truth, meter,
                                         P29_REGEX_ROWS)
    print(f"{what}: every call equal to pyarrow.compute and its closed form;"
          f" kept shares " + json.dumps(shares), flush=True)
    print(f"{what}: op_timer's first runs:\n{timings.report()}", flush=True)
    print(f"{what}: peak device memory {meter.peak_gib():.2f} GiB "
          f"(loading included); o_comment's "
          f"copy to the host {copy_ms:.1f} ms; times (CUDA events: device "
          f"calls median of 5, host-bound calls one run; ms): "
          + json.dumps(meter.times), flush=True)
    entries = []
    (args, kwargs), launches = sites["filter"]
    keep, arrays = args[:2]
    site = _compact_site(
        f"phase 29 Q13 filter_table of orders with a large_utf8 comment, "
        f"{keep.shape[0]:,} rows, {float(keep.float().mean()):.2%} kept",
        keep, tuple(arrays), kwargs.get("out_cap"),
        lambda: (tuple(a[keep] for a in arrays), keep.nonzero()),
        kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    (args, kwargs), launches = sites["run_starts"]
    keep, arrays = args[:2]
    site = _compact_site(
        f"phase 29 Q13 group_by(o_custkey) sort-plan run starts, "
        f"{keep.shape[0]:,} rows, {int(keep.sum()):,} kept", keep,
        tuple(arrays), kwargs.get("out_cap"),
        lambda: (arrays[0][keep], keep.nonzero()), kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    call, launches = sites["dictionary"]
    site = _k2_site(f"phase 29 Q22 dictionary plan, "
                    f"{len(call[0][0]):,} rows x {call[0][1]} codes", call)
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, launches["grouped_aggregate"], err))
    return entries, [(f"{what}: {name}", fn, args)
                     for name, fn, *args in cpu_calls]


# ---- phase 30: the C Data Interface, Arrow IPC and Parquet -----------------

P30_ROWS = 59_986_052              # TPC-H SF10 lineitem (spec 4.2.3)
P30_SUPPLIERS = 100_000            # S = SF * 10,000 (spec 4.2.3)
P30_ROW_GROUP = 1 << 20            # WriterProperties' default row group
P30_CPU_GROUPS = 4                 # row groups the CPU route reads
P30_IPC_GROUPS = None              # row groups through IPC and C Data (all)
P30_PIECE = 64 << 20               # StreamDecoder's feed, bytes
P30_POOL_BYTES = P29_POOL_BYTES    # the text pool l_comment is cut from
P30_SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                    "TAKE BACK RETURN")
P30_SHIPMODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
P30_Q6_DATES = ("1994-01-01", "1995-01-01")        # Q6's shipdate year
P30_Q6_DISCOUNT = (5, 7)           # 0.06 +- 0.01, in cents
P30_Q6_QUANTITY = 24
P30_Q1_CUT = "1998-09-02"          # Q1: 1998-12-01 minus 90 days


def _cut_device(pool: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, chunk: int = 1 << 23):
    """(int64 offsets, bytes) of pool[starts[i]:starts[i] + lens[i]] on
    the card, `chunk` rows at a time."""
    n = lens.shape[0]
    offs = torch.zeros(n + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(lens, 0, out=offs[1:])
    data = torch.empty(int(offs[-1]), dtype=torch.uint8, device=lens.device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        lo, hi = int(offs[a]), int(offs[b])
        rid = torch.repeat_interleave(
            torch.arange(b - a, device=lens.device), lens[a:b],
            output_size=hi - lo)
        pos = torch.arange(hi - lo, device=lens.device) \
            - (offs[a:b] - lo)[rid]
        data[lo:hi] = pool[starts[a:b][rid] + pos]
    return offs, data


def tpch_lineitem16(n: int, dev, pool_bytes: int = P30_POOL_BYTES,
                    seed: int = SEED):
    """lineitem with all 16 columns of the spec (1.4.1, 4.2.3) on the
    card: phase 28's columns, and l_partkey (the part phase 28 draws),
    l_suppkey by 4.2.3's formula over S suppliers, l_commitdate and
    l_receiptdate from `tpch_dates`, l_shipinstruct (4 values) and
    l_shipmode (7) as Dictionary<Int32, Utf8>, l_comment of 10-43 bytes
    cut from the text pool at random offsets.  Keys Int64, l_linenumber
    Int32, the money columns Decimal128(15, 2), dates Date32; no nulls.
    Returns the table and the generator's integers."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table
    base, g = tpch_lineitem(n, dev)
    part = g["part"]
    s = P30_SUPPLIERS
    i = _umod(splitmix(n, 11 * n, dev), 4)
    supp = (part + i * (s // 4 + (part - 1) // s)) % s + 1
    instruct = _umod(splitmix(n, 12 * n, dev), len(P30_SHIPINSTRUCT))
    mode = _umod(splitmix(n, 13 * n, dev), len(P30_SHIPMODE))
    pool = torch.from_numpy(tpch_text_pool(np.random.default_rng(seed),
                                           pool_bytes)).to(dev)
    lens = 10 + _umod(splitmix(n, 14 * n, dev), 34)
    starts = _umod(splitmix(n, 15 * n, dev), pool.shape[0] - 43)
    offs, data = _cut_device(pool, starts, lens)
    col = {f.name: c for f, c in zip(base.schema.fields, base.columns)}
    words = lambda ws: StringColumn.from_pylist(list(ws), device=dev)
    cols = {"l_orderkey": col["l_orderkey"],
            "l_partkey": PrimitiveColumn(part, dt.int64),
            "l_suppkey": PrimitiveColumn(supp, dt.int64),
            "l_linenumber": col["l_linenumber"],
            **{k: col[k] for k in ("l_quantity", "l_extendedprice",
                                   "l_discount", "l_tax", "l_returnflag",
                                   "l_linestatus", "l_shipdate")},
            "l_commitdate": PrimitiveColumn(g["commit"], dt.date32),
            "l_receiptdate": PrimitiveColumn(g["receipt"], dt.date32),
            "l_shipinstruct": DictionaryColumn(instruct.to(torch.int32),
                                               words(P30_SHIPINSTRUCT)),
            "l_shipmode": DictionaryColumn(mode.to(torch.int32),
                                           words(P30_SHIPMODE)),
            "l_comment": StringColumn(offs.to(torch.int32), data, dt.utf8)}
    table = Table(list(cols.values()), dt.Schema(tuple(
        dt.Field(k, c.dtype, False) for k, c in cols.items())))
    return table, {**g, "supp": supp, "instruct": instruct, "mode": mode,
                   "comment_lens": lens}


def _meminfo_gib() -> float:
    """The host's available memory (/proc/meminfo), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def _same_on_device(got, want, what: str) -> None:
    """Two columns or tables of the port, on one device, bit for bit."""
    from torch.utils import _pytree as pytree
    gl, gs = pytree.tree_flatten(got)
    wl, ws = pytree.tree_flatten(want)
    if str(gs) != str(ws) or len(gl) != len(wl):
        raise AssertionError(f"{what}: {gs} against {ws}")
    for a, b in zip(gl, wl):
        if isinstance(a, torch.Tensor):
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(_bits(a), _bits(b.to(a.device))):
                raise AssertionError(f"{what}: the buffers differ")
        elif a != b:
            raise AssertionError(f"{what}: {a!r} against {b!r}")


def _same_table(got, want, what: str) -> None:
    """A table read back equal to its source: the same fields (name,
    type, nullability) and rows; dictionary columns compare by their
    decoded strings (a reader may build its own dictionary), the others
    buffer by buffer."""
    from arrow_tpu_torch.ops.strings import dictionary_decode
    fields = lambda t: [(f.name, repr(f.dtype), f.nullable)
                        for f in t.schema.fields]
    if fields(got) != fields(want) or got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {fields(got)} ({got.num_rows} rows)"
                             f" against {fields(want)} ({want.num_rows})")
    for f, a, b in zip(got.schema.fields, got.columns, want.columns):
        if f.dtype.is_dictionary:
            a, b = dictionary_decode(a), dictionary_decode(b)
        _same_on_device(a, b, f"{what}: {f.name}")


def _day_scalar(day: str):
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.datum import Scalar
    return Scalar(_days(*map(int, day.split("-"))), dt.date32)


def q6_predicate(t):
    """Q6's WHERE over a table of l_shipdate, l_discount, l_quantity: the
    dates and the Decimal128(15, 2) columns through the port's public
    comparisons (a decimal Scalar is rescaled on the host, ROADMAP
    C24)."""
    from decimal import Decimal
    from arrow_tpu_torch.core.datum import Scalar
    from arrow_tpu_torch.ops import boolean as pb, cmp
    ship, disc = t.column("l_shipdate"), t.column("l_discount")
    qty = t.column("l_quantity")
    cents = lambda c, col: Scalar(Decimal(c).scaleb(-2), col.dtype)
    lo, hi = P30_Q6_DISCOUNT
    m = pb.and_(cmp.gt_eq(ship, _day_scalar(P30_Q6_DATES[0])),
                cmp.lt(ship, _day_scalar(P30_Q6_DATES[1])))
    m = pb.and_(m, pb.and_(cmp.gt_eq(disc, cents(lo, disc)),
                           cmp.lt_eq(disc, cents(hi, disc))))
    return pb.and_(m, cmp.lt(qty, cents(100 * P30_Q6_QUANTITY, qty)))


def q1_predicate(t):
    """Q1's WHERE: l_shipdate <= 1998-09-02."""
    from arrow_tpu_torch.ops import cmp
    return cmp.lt_eq(t.column("l_shipdate"), _day_scalar(P30_Q1_CUT))


P30_Q1_AGGS = (("l_shipdate", "count_all"), ("l_shipdate", "min"),
               ("l_shipdate", "max"), ("l_receiptdate", "min"),
               ("l_receiptdate", "max"))


def q6_scan(path: str, dev, groups=None):
    """Q6's scan: the predicate's columns decoded first, then the other
    projected column with the rows it keeps; -> the batches."""
    from arrow_tpu_torch.io.parquet_io import ParquetReaderBuilder, RowFilter
    b = ParquetReaderBuilder(
        path, columns=["l_extendedprice", "l_discount"],
        batch_size=P30_ROW_GROUP, device=dev, row_groups=groups,
        row_filter=RowFilter(q6_predicate,
                             ["l_shipdate", "l_discount", "l_quantity"]))
    return list(b.build())


def q1_scan(path: str, dev, groups=None):
    """Q1's scan and GROUP BY l_returnflag, l_linestatus: -> (the
    concatenated batches, the grouped table)."""
    from arrow_tpu_torch.io.parquet_io import ParquetReaderBuilder, RowFilter
    from arrow_tpu_torch.ops.concat import concat_tables
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    b = ParquetReaderBuilder(
        path, columns=["l_returnflag", "l_linestatus", "l_shipdate",
                       "l_receiptdate"],
        batch_size=P30_ROW_GROUP, device=dev, row_groups=groups,
        row_filter=RowFilter(q1_predicate, ["l_shipdate"]))
    rows = concat_tables(list(b.build()))
    return rows, group_by(rows, ["l_returnflag", "l_linestatus"],
                          [AggSpec(c, op) for c, op in P30_Q1_AGGS])


def _q6_closed_form(g, n: int, rows: int, groups: int):
    """Q6's kept rows and revenue (cents * cents) from the generator's
    integers, and the row groups whose kept share is strictly between 0
    and 1 (those filter, K1)."""
    lo, hi = (_days(*map(int, d.split("-"))) for d in P30_Q6_DATES)
    ship, disc = g["ship"][:n], g["l_discount"][:n]
    keep = (ship >= lo) & (ship < hi) & (disc >= P30_Q6_DISCOUNT[0]) \
        & (disc <= P30_Q6_DISCOUNT[1]) \
        & (g["l_quantity"][:n] < 100 * P30_Q6_QUANTITY)
    rev = int((g["l_extendedprice"][:n] * disc)[keep].sum())
    per = torch.bincount(torch.arange(n, device=keep.device)[keep] // rows,
                         minlength=groups)
    size = torch.full_like(per, rows)
    size[-1] = n - rows * (groups - 1)
    return keep, rev, int(((per > 0) & (per < size)).sum())


def _q1_check(out, g, n: int, what: str) -> None:
    """Q1's groups against bincount / scatter_reduce_ over the
    generator's flag * 2 + status where l_shipdate <= the cut."""
    from arrow_tpu_torch.ops.strings import dictionary_decode
    cut = _days(*map(int, P30_Q1_CUT.split("-")))
    keep = g["ship"][:n] <= cut
    code = (g["flag"][:n] * 2 + g["status"][:n])[keep]
    cnt = torch.bincount(code, minlength=6)
    want = {}
    for c in cnt.nonzero().squeeze(1).tolist():
        row = [int(cnt[c])]
        for key in ("ship", "receipt"):
            v = g[key][:n][keep][code == c]
            row += [int(v.min()), int(v.max())]
        want[("ANR"[c // 2], "FO"[c % 2])] = row
    flags = dictionary_decode(out.column("l_returnflag")).to_pylist()
    stats = dictionary_decode(out.column("l_linestatus")).to_pylist()
    got = {(f, s): [int(out.columns[2 + j].values[i])
                    for j in range(len(P30_Q1_AGGS))]
           for i, (f, s) in enumerate(zip(flags, stats))}
    if got != want:
        raise AssertionError(f"{what}: {got} against {want}")


def _classify(filters, compacts, pred_cols):
    """The K1 calls of a scan by call site: a filter_table of the
    predicate's columns (parquet_io.py) or of the rows a selection keeps
    (parquet_native.py); each filter_table makes one compaction."""
    if len(filters) != len(compacts):
        raise AssertionError(f"{len(filters)} filter_table calls made "
                             f"{len(compacts)} compactions")
    sites = {"predicate": [], "selection": []}
    for (args, _), call in zip(filters, compacts):
        names = set(args[0].schema.names)
        sites["predicate" if names <= set(pred_cols) else
              "selection"].append(call)
    return sites


# the modules that call K1's wrapper; a scan watches each of them
K1_CALLERS = (("compact", "groupby"), ("compact", "sort"),
              ("compact", "join"))


def _launched_each(by_site, others, launches, dev, what: str) -> None:
    """Every K1 call of a scan on the scan's device, and the launch
    counter over the scan equal to the calls whose keep is on a card:
    those of the two scan sites and `others`, the wrapper's calls from
    the rest of K1_CALLERS (Q1's group_by makes one).  So the per-site
    launches of the kernels line are the counter's."""
    calls = by_site["predicate"] + by_site["selection"] + others
    off = [a[0].device for a, _ in calls if a[0].device != dev]
    if off:
        raise AssertionError(f"{what}: a keep mask on {off[0]}, not {dev}")
    on_card = sum(a[0].is_cuda for a, _ in calls)
    if launches["compact"] != on_card:
        raise AssertionError(f"{what}: {launches['compact']} K1 launches "
                             f"for {on_card} calls on the card")


def _planted(n: int):
    """The rows of the float column's -0.0 and NaN."""
    return n // 7, n // 5


def _tensors(t) -> set:
    """The data pointers of every tensor of a table."""
    from torch.utils import _pytree as pytree
    return {x.data_ptr() for x in pytree.tree_leaves(t)
            if isinstance(x, torch.Tensor)}


def _priced(t):
    """`t` with l_extendedprice's value as a float64 column appended
    (its Decimal128(15, 2) low limb over 100), -0.0 and a NaN planted."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn
    price = t.column("l_extendedprice").limbs[:, 0].to(torch.float64) / 100
    zero, nan = _planted(t.num_rows)
    price[zero] = -0.0
    price[nan] = float("nan")
    return t.append_column("l_price_f64", PrimitiveColumn(price, dt.float64))


def _changed_copies(t, row: int) -> dict:
    """Copies of `t` (from _priced) each changed in one thing, made when
    called: a float's sign of zero, a NaN's payload, one decimal limb
    bit, one string byte, one validity bit, the column order, one field's
    metadata."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import PrimitiveColumn, StringColumn
    from arrow_tpu_torch.core.nested import DecimalColumn
    fi = t.schema.index_of("l_price_f64")
    zero, nan = _planted(t.num_rows)

    def price_bits(i, bits):
        v = t.column(fi).values.clone()
        v.view(torch.int64)[i] = bits
        return t.set_column(fi, t.schema.fields[fi],
                            PrimitiveColumn(v, dt.float64))

    def limb():
        j = t.schema.index_of("l_discount")
        c = t.column(j)
        limbs = c.limbs.clone()
        limbs[row, 1] ^= 1 << 40
        return t.set_column(j, t.schema.fields[j],
                            DecimalColumn(limbs, c.dtype, c.validity))

    def byte():
        j = t.schema.index_of("l_comment")
        c = t.column(j)
        data = c.data.clone()
        data[c.offsets[row].to(torch.int64)] ^= 1
        return t.set_column(j, t.schema.fields[j],
                            StringColumn(c.offsets, data, c.dtype, c.validity))

    def validity():
        j = t.schema.index_of("l_quantity")
        mask = torch.ones(t.num_rows, dtype=torch.bool,
                          device=t.column(j).device)
        mask[row] = False
        return t.set_column(j, t.schema.fields[j],
                            t.column(j).with_validity(mask))

    def metadata():
        j = t.schema.index_of("l_shipmode")
        f = t.schema.fields[j]
        return t.set_column(j, dt.Field(f.name, f.dtype, f.nullable,
                                        (("origin", "changed"),)),
                            t.column(j))
    return {"-0.0 set to 0.0": lambda: price_bits(zero, 0),
            "NaN with another payload": lambda: price_bits(
                nan, 0x7FF8000000000001),
            "one l_discount limb bit": limb,
            "one byte of one l_comment row": byte,
            "one l_quantity validity bit": validity,
            "select in another column order": lambda: t.select(
                t.column_names[::-1]),
            "one field's metadata": metadata}


def _column_edits(t) -> None:
    """select, drop_column, rename_columns, append_column and set_column
    keep the same tensors and give the expected schema."""
    names = t.column_names
    col = t.column("l_comment")
    edits = {
        "select": (t.select(["l_comment", 0]), ["l_comment", names[0]]),
        "drop_column": (t.drop_column("l_tax"),
                        [c for c in names if c != "l_tax"]),
        "rename_columns": (t.rename_columns([c.upper() for c in names]),
                           [c.upper() for c in names]),
        "append_column": (t.append_column("again", col), names + ["again"]),
        "set_column": (t.set_column(1, t.schema.field("l_comment"), col),
                       names[:1] + ["l_comment"] + names[2:])}
    ptrs = _tensors(t)
    for name, (got, want) in edits.items():
        if got.column_names != want or not _tensors(got) <= ptrs:
            raise AssertionError(f"{name}: {got.column_names} against "
                                 f"{want}, or new tensors")
        if [repr(f.dtype) for f in got.schema.fields] != \
                [repr(c.dtype) for c in got.columns]:
            raise AssertionError(f"{name}: field types")


def p30_table_api(table, back, meter):
    """Table.equals of the read-back lineitem against its source, with a
    float64 column appended to both (-0.0 and a NaN planted): True, and
    the same answer as `_same_table`; False for each changed copy; one
    host sync a call.  The column edits zero-copy.  Then
    FilterPredicate(q6_predicate).indices: one K1 launch, bit for bit
    its plain version and keep.nonzero().  Returns the K1 site's
    (keep, count, launches)."""
    from arrow_tpu_torch.core.pool import table_memory_size
    from arrow_tpu_torch.kernels import compact as kc
    from arrow_tpu_torch.ops.filter import FilterPredicate
    what = meter.what
    n = table.num_rows
    if not (back.equals(table) and table.equals(back)):
        raise AssertionError(f"{what}: read_back.equals(source) is False, "
                             "where _same_table found them equal")
    src, got = _priced(table), _priced(back)
    _column_edits(got)
    same, syncs, peak, held = meter.reads(lambda: got.equals(src))
    if not same or syncs != 1:
        raise AssertionError(f"{what}: Table.equals {same} with {syncs} "
                             "host syncs")
    nbytes = table_memory_size(src) + table_memory_size(got)
    name = "Table.equals, read back against source"
    meter.timed(name, lambda: got.equals(src))
    print(f"{what}: {name}: True, {syncs} host sync; "
          f"{meter.times[name]:.4f} ms (CUDA events, median of 5), bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes:,} bytes over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); peak {peak:.2f} GiB, "
          f"{peak - held:.2f} above the {held:.2f} GiB held before",
          flush=True)
    per = {}
    for c in src.column_names:
        key = f"Column.equals {c}"
        meter.timed(key, lambda c=c: got.column(c).equals(src.column(c)))
        per[c] = round(meter.times[key], 4)
    print(f"{what}: Column.equals by column, ms (CUDA events, median of "
          f"5): {json.dumps(per)}", flush=True)
    changes = _changed_copies(got, n // 3)
    for change, make in changes.items():
        other = make()
        if other.equals(src) or src.equals(other):
            raise AssertionError(f"{what}: equals is True with {change}")
        del other
    print(f"{what}: Table.equals False for each changed copy: "
          f"{', '.join(changes)}", flush=True)
    del src, got

    pred = FilterPredicate(q6_predicate(back))
    idx, launches, _ = meter.counted(
        "FilterPredicate(q6_predicate).indices", "compact",
        lambda: pred.indices, exactly=1)
    keep, count = pred.keep, pred.count
    (plain,), _ = kc.compact_plain(keep, (), count, torch.int32)
    library = keep.nonzero().squeeze(1).to(torch.int32)
    if idx.values.dtype != torch.int32 or not (
            torch.equal(idx.values, plain) and torch.equal(plain, library)):
        raise AssertionError(f"{what}: FilterPredicate.indices differs from "
                             "compact_plain or keep.nonzero()")
    print(f"{what}: FilterPredicate(q6_predicate).indices: {count:,} of "
          f"{n:,} rows ({count / n:.2%}), int32, bit for bit compact_plain "
          f"and keep.nonzero(); launches {launches}", flush=True)
    return keep, count, launches


def p30_calls(table, g, dev, meter, tmp, rows: int = P30_ROW_GROUP,
              cpu_groups: int = P30_CPU_GROUPS, ipc_groups=P30_IPC_GROUPS,
              piece: int = P30_PIECE):
    """Phase 30's calls over `table` (from `tpch_lineitem16`), its files
    under the directory `tmp`; each call timed by `meter` and checked.
    Returns (the K1 and K2 calls the sites take with their launches, the
    step seconds, the file sizes)."""
    import io
    import pyarrow as pa
    import pyarrow.parquet as pq
    from arrow_tpu_torch.io import cdata, ipc
    from arrow_tpu_torch.io import parquet_native as pn
    from arrow_tpu_torch.io.interop import table_from_pyarrow
    from arrow_tpu_torch.io.parquet_io import (ParquetReaderBuilder,
                                               WriterProperties, read_metadata,
                                               read_parquet, write_parquet)
    from arrow_tpu_torch.ops import take as tk
    from arrow_tpu_torch.ops.concat import concat_tables
    from arrow_tpu_torch.ops.filter import filter_table
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    n = table.num_rows
    groups = -(-n // rows)
    what = meter.what
    sizes, sites, lows = {}, {}, []

    def step(name, fn):
        """meter.host, then the host's available memory read."""
        out = meter.host(name, fn)
        lows.append((_meminfo_gib(), name))
        return out
    part = lambda k: [table.slice(a, min(rows, n - a))
                      for a in range(0, min(n, k * rows), rows)]

    # 1. write
    ours = str(tmp / "lineitem.parquet")
    step("write_parquet", lambda: write_parquet(
        ours, table, WriterProperties(row_group_size=rows,
                                      write_page_index=True)))
    sizes["port's parquet"] = Path(ours).stat().st_size
    md = read_metadata(ours)
    if (md.num_rows, md.num_row_groups) != (n, groups):
        raise AssertionError(f"{what}: the footer says {md.num_rows} rows "
                             f"in {md.num_row_groups} row groups")

    # 2. pyarrow reads the port's file, row group by row group
    def pyarrow_reads():
        pf = pq.ParquetFile(ours)
        for i, want in enumerate(part(groups)):
            _same_table(table_from_pyarrow(pf.read_row_group(i), dev), want,
                        f"{what}: pyarrow's row group {i}")
    step("pyarrow reads the port's file", pyarrow_reads)

    # 3. pyarrow writes the rows it takes from export_stream; the port
    # reads that file back
    theirs = str(tmp / "lineitem_pyarrow.parquet")

    class Exported:
        def __arrow_c_stream__(self, requested_schema=None):
            return cdata.export_stream(part(groups))

    def pyarrow_writes():
        reader = pa.RecordBatchReader.from_stream(Exported())
        with pq.ParquetWriter(theirs, reader.schema) as w:
            for batch in reader:
                w.write_batch(batch)
    step("pyarrow writes from export_stream", pyarrow_writes)
    sizes["pyarrow's parquet"] = Path(theirs).stat().st_size
    flba = pq.ParquetFile(theirs).schema.column(4)
    back = step("read_parquet of pyarrow's file",
                      lambda: read_parquet(theirs, device=dev))
    _same_table(back, table, f"{what}: read_parquet of pyarrow's file "
                f"({flba.physical_type}({flba.length}) decimals)")
    last = int(back.column("l_comment").offsets[-1])
    if last >= 2 ** 31:
        raise AssertionError(f"{what}: l_comment's last offset {last}")
    real, seen = tk._source_index, []

    def spy(starts, ends, new_offs, total, limit):
        out = real(starts, ends, new_offs, total, limit)
        seen.append((limit, total, out.dtype))
        return out
    tk._source_index = spy
    try:
        kept = filter_table(back, q1_predicate(back))
    finally:
        tk._source_index = real
    print(f"{what}: l_comment's last offset {last:,} (< 2^31); "
          f"filter_table of the read-back table keeps {kept.num_rows:,} rows;"
          f" range_gather (limit, total, index): {seen} (INDEX32_LIMIT "
          f"{tk.INDEX32_LIMIT:,})", flush=True)
    if not seen or any((max(lim, tot) < tk.INDEX32_LIMIT)
                       != (ix == torch.int32) for lim, tot, ix in seen):
        raise AssertionError(f"{what}: range_gather's index type")
    del kept

    # 3b. the Table API over the read-back table: equals against the
    # source and against changed copies, the column edits, and
    # FilterPredicate.indices (K1)
    sites["FilterPredicate.indices"] = step(
        "the Table API: equals, column edits, FilterPredicate.indices",
        lambda: p30_table_api(table, back, meter))

    # 4. Q6
    pages = (pn.PAGES_DECODED[0], pn.PAGES_SKIPPED[0])
    q6_cols = ["l_shipdate", "l_discount", "l_quantity"]
    batches, launches, (filters, compacts, *others) = meter.counted(
        "Q6 scan", "compact",
        lambda: step("Q6 scan", lambda: q6_scan(ours, dev)),
        ("filter_table", "filter"), ("compact", "filter"), *K1_CALLERS)
    others = sum(others, [])
    pages = (pn.PAGES_DECODED[0] - pages[0], pn.PAGES_SKIPPED[0] - pages[1])
    keep, rev, mixed = _q6_closed_form(g, n, rows, groups)
    q6 = concat_tables(batches)
    got = int((_limb_ints(q6.column("l_extendedprice"))
               * _limb_ints(q6.column("l_discount"))).sum())
    by_site = _classify(filters, compacts, q6_cols)
    print(f"{what}: Q6 scan kept {q6.num_rows:,} rows "
          f"({q6.num_rows / n:.2%}), revenue {got / 1e4:,.4f}; K1 calls "
          f"{ {k: len(v) for k, v in by_site.items()} } over {mixed} row "
          f"groups that keep some rows, {len(others)} elsewhere; "
          f"launches {launches}; "
          f"PAGES_DECODED {pages[0]}, PAGES_SKIPPED {pages[1]}", flush=True)
    if (q6.num_rows, got) != (int(keep.sum()), rev):
        raise AssertionError(f"{what}: Q6 {q6.num_rows} rows, {got} "
                             f"against {int(keep.sum())}, {rev}")
    if any(len(v) != mixed for v in by_site.values()):
        raise AssertionError(f"{what}: Q6's K1 calls by site")
    _launched_each(by_site, others, launches, dev, f"{what}: Q6 scan")
    sites["Q6 predicate"] = (by_site["predicate"], launches)
    sites["Q6 selection"] = (by_site["selection"], launches)

    # 5. Q1
    (rows1, out), launches, (filters, compacts, *others) = meter.counted(
        "Q1 scan", "compact",
        lambda: step("Q1 scan and group_by", lambda: q1_scan(ours, dev)),
        ("filter_table", "filter"), ("compact", "filter"), *K1_CALLERS)
    others = sum(others, [])
    by_site = _classify(filters, compacts, ["l_shipdate"])
    _launched_each(by_site, others, launches, dev, f"{what}: Q1 scan")
    _q1_check(out, g, n, f"{what}: Q1")
    print(f"{what}: Q1 scan kept {rows1.num_rows:,} rows "
          f"({rows1.num_rows / n:.2%}); K1 calls "
          f"{ {k: len(v) for k, v in by_site.items()} }, {len(others)} "
          f"elsewhere; launches {launches}; {out.num_rows} groups equal to "
          f"the closed form",
          flush=True)
    sites["Q1 predicate"] = (by_site["predicate"], launches)
    sites["Q1 selection"] = (by_site["selection"], launches)
    aggs = [AggSpec(c, op) for c, op in P30_Q1_AGGS]
    out2, launches, (k2_calls,) = meter.counted(
        "Q1 group_by", "grouped_aggregate",
        lambda: group_by(rows1, ["l_returnflag", "l_linestatus"], aggs),
        ("grouped_aggregate", "groupby"))
    _same_on_device(out2, out, f"{what}: Q1 group_by again")
    sites["Q1 group_by"] = (k2_calls, launches)
    del rows1, out, out2, q6, batches, filters, compacts

    # 6. IPC: a file with LZ4 and a stream fed in pieces
    k = groups if ipc_groups is None else min(ipc_groups, groups)
    src = [back.slice(a, min(rows, n - a))
           for a in range(0, min(n, k * rows), rows)]
    buf = io.BytesIO()
    step("ipc.write_file (lz4)",
               lambda: ipc.write_file(buf, src, compression="lz4"))
    sizes["IPC file (lz4)"] = buf.tell()
    got = step("ipc.read_file", lambda: ipc.read_file(
        buf.getbuffer(), dev))
    for i, (a, b) in enumerate(zip(got, src)):
        _same_table(a, b, f"{what}: IPC file batch {i}")
    if len(got) != len(src):
        raise AssertionError(f"{what}: {len(got)} IPC file batches")
    del got, buf
    buf = io.BytesIO()
    step("ipc.write_stream", lambda: ipc.write_stream(buf, src))
    sizes["IPC stream"] = buf.tell()

    def decode():
        dec, view, i = ipc.StreamDecoder(dev), buf.getbuffer(), 0
        for a in range(0, len(view), piece):
            dec.feed(view[a:a + piece])
            while (t := dec.next_batch()) is not None:
                _same_table(t, src[i], f"{what}: IPC stream batch {i}")
                i += 1
        del view
        return i
    if step(f"StreamDecoder fed {piece:,}-byte pieces", decode) \
            != len(src):
        raise AssertionError(f"{what}: the stream's batch count")
    del buf, src

    # 7. the C Data Interface: a pyarrow reader over the port's file
    def c_import():
        pf = pq.ParquetFile(ours)
        reader = pa.RecordBatchReader.from_batches(
            pf.schema_arrow, pf.iter_batches(batch_size=rows,
                                             row_groups=range(k)))
        at = 0
        for t in cdata.import_stream(reader, dev):
            _same_table(t, table.slice(at, t.num_rows),
                        f"{what}: import_stream at row {at}")
            at += t.num_rows
        return at
    if step("import_stream of pyarrow's reader", c_import) \
            != min(n, k * rows):
        raise AssertionError(f"{what}: import_stream's row count")
    del back

    # 8. the CPU route over the first row groups
    cpu = torch.device("cpu")
    first = list(range(min(cpu_groups, groups)))

    def cpu_route():
        for i in first:
            _same_outcome(pn.ParquetFile(ours, dev).read_row_group(i),
                          pn.ParquetFile(ours, cpu).read_row_group(i),
                          f"{what}: row group {i} on the CPU route")
        _same_outcome(q6_scan(ours, dev, first), q6_scan(ours, cpu, first),
                      f"{what}: Q6 over row groups {first} on the CPU route")
        _same_outcome(q1_scan(ours, dev, first), q1_scan(ours, cpu, first),
                      f"{what}: Q1 over row groups {first} on the CPU route")
    step(f"the CPU route over {len(first)} row groups", cpu_route)

    # 9. a plain scan with the row-group prefetch, on a side stream,
    # equal to one without
    def scan(depth):
        old = os.environ.get("ARROW_TPU_PARQUET_PREFETCH")
        os.environ["ARROW_TPU_PARQUET_PREFETCH"] = depth
        try:
            return list(ParquetReaderBuilder(ours, batch_size=rows,
                                             device=dev, row_groups=first)
                        .build())
        finally:
            if old is None:
                del os.environ["ARROW_TPU_PARQUET_PREFETCH"]
            else:
                os.environ["ARROW_TPU_PARQUET_PREFETCH"] = old

    def prefetch():
        streams = torch.get_device_module(dev)
        with streams.stream(streams.Stream()):
            got, want = scan("1"), scan("0")
            for i, (a, b) in enumerate(zip(got, want)):
                _same_on_device(a, b, f"{what}: prefetched row group {i}")
        if len(got) != len(want) or len(got) != len(first):
            raise AssertionError(f"{what}: {len(got)} prefetched row "
                                 f"groups, {len(want)} without")
    step(f"a scan of {len(first)} row groups with and without prefetch, "
         f"on a side stream", prefetch)
    low, after = min(lows)
    print(f"{what}: host memory available after each step: lowest "
          f"{low:.1f} GiB, after {after!r}", flush=True)
    return sites, sizes


def run_phase30(dev, profile: bool):
    """Phase 30: TPC-H SF10 lineitem, all 16 columns, made on the card,
    written to Parquet and read back by pyarrow, written by pyarrow from
    the port's export_stream and read back by the port, scanned with
    Q6's and Q1's filters pushed down, grouped for Q1, carried through
    IPC and the C Data Interface, read on the CPU route and scanned with
    and without prefetch.  Returns the kernel entries.  Its files go to
    a temporary directory under the checkout's build/ (git-ignored)."""
    import tempfile
    n = P30_ROWS
    what = (f"phase 30, TPC-H SF10 lineitem through Parquet, IPC and C "
            f"Data, {n:,} rows")
    free0 = _meminfo_gib()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table, g = tpch_lineitem16(n, dev)
    torch.cuda.synchronize()
    from arrow_tpu_torch.core.pool import table_memory_size
    com = table.column("l_comment")
    print(f"{what}: made on the card in {time.perf_counter() - t0:.1f} s "
          f"(the text pool on the host included); "
          f"{table_memory_size(table):,} bytes of buffers, l_comment "
          f"{com.data.numel():,}; peak {peak_gib():.2f} GiB; host "
          f"memory available {free0:.1f} GiB", flush=True)
    meter = CardMeter(profile, what)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        sites, sizes = p30_calls(table, g, dev, meter, Path(tmp))
    print(f"{what}: seconds (host clock, synced): "
          f"{json.dumps({k: round(v, 3) for k, v in meter.seconds.items()})}"
          f"; bytes: {json.dumps(sizes)}; peak device memory "
          f"{meter.peak_gib():.2f} GiB; host memory available "
          f"{free0:.1f} GiB before, {_meminfo_gib():.1f} GiB after",
          flush=True)
    entries = []
    for name in ("Q6 predicate", "Q6 selection", "Q1 predicate",
                 "Q1 selection"):
        calls, launches = sites[name]
        (args, kwargs) = calls[0]
        keep, arrays = args[:2]
        where = "parquet_io.py" if name.endswith("predicate") \
            else "parquet_native.py"
        site = _compact_site(
            f"phase 30 {name} ({where}), row group 0, {keep.shape[0]:,} "
            f"rows, {float(keep.float().mean()):.2%} kept", keep,
            tuple(arrays), kwargs.get("out_cap"),
            lambda keep=keep, arrays=arrays: (
                tuple(a[keep] for a in arrays), keep.nonzero()),
            kwargs.get("positions"))
        err = check_site(site, same_compaction, f"K1 at {site.call_site}")
        entries.append(_entry(site, len(calls), err))
    keep, count, launches = sites["FilterPredicate.indices"]
    site = _compact_site(
        f"phase 30 FilterPredicate(q6_predicate).indices of the read-back "
        f"lineitem, {keep.shape[0]:,} rows, {count / keep.shape[0]:.2%} "
        f"kept, int32 positions alone", keep, (), count,
        lambda: keep.nonzero(), torch.int32)
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    entries.append(_entry(site, launches["compact"], err))
    calls, launches = sites["Q1 group_by"]
    site = _k2_site(f"phase 30 Q1 group_by(l_returnflag, l_linestatus) "
                    f"dictionary plan, {len(calls[0][0][0]):,} rows x "
                    f"{calls[0][0][1]} codes", calls[0])
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    entries.append(_entry(site, launches["grouped_aggregate"], err))
    return entries


# ---- phases 31-32: TPC-H through the text formats, and as SQL --------------

P31_ROWS = 6_001_215               # TPC-H SF1 lineitem (spec 4.2.5)
P31_AVRO_ROWS = 100_000            # write_avro: a Python value a cell (cut)
P31_CUSTOMERS = 150_000            # SF1 customer (SF * 150,000)
P32_ROWS = 59_986_052              # TPC-H SF10 lineitem
P32_CUSTOMERS = 1_500_000          # SF10 customer
P32_CPU_ROWS = 1_000_000           # Q1 on the CPU route (cut)
P32_RTOL = 1e-9                    # float sums: the card adds in another order
P32_SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                "HOUSEHOLD")
P32_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                  "5-LOW")
P32_NATIONS = (                    # spec 4.2.3: (n_name, n_regionkey)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1))


# TPC-H Q1, Q3, Q6 and Q10 (spec 2.4) in sql.py's grammar: JOIN ... ON for
# the comma joins, the tables in the spec's FROM order (the smaller side
# on the left, so the wide joins repeat the fewest bytes; a join keeps
# the left key only, so Q3 names l_orderkey by the o_orderkey equal to
# it), and each date bound as its day number (sql.py takes
# CAST('1998-09-02' AS date32) too, but casts that literal once per
# row).
P32_QUERIES = {
    # l_shipdate <= date '1998-12-01' - interval '90' day (1998-09-02)
    "Q1": "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
          "SUM(l_extendedprice) AS sum_base_price, "
          "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
          "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) "
          "AS sum_charge, AVG(l_quantity) AS avg_qty, "
          "AVG(l_extendedprice) AS avg_price, AVG(l_discount) AS avg_disc, "
          "COUNT(*) AS count_order FROM lineitem "
          f"WHERE l_shipdate <= {_days(1998, 9, 2)} "
          "GROUP BY l_returnflag, l_linestatus "
          "ORDER BY l_returnflag, l_linestatus",
    # o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
    "Q3": "SELECT o_orderkey AS l_orderkey, "
          "SUM(l_extendedprice * (1 - l_discount)) AS revenue, o_orderdate, "
          "o_shippriority FROM customer "
          "JOIN orders ON c_custkey = o_custkey "
          "JOIN lineitem ON o_orderkey = l_orderkey "
          "WHERE c_mktsegment = 'BUILDING' "
          f"AND o_orderdate < {_days(1995, 3, 15)} "
          f"AND l_shipdate > {_days(1995, 3, 15)} "
          "GROUP BY o_orderkey, o_orderdate, o_shippriority "
          "ORDER BY revenue DESC, o_orderdate LIMIT 10",
    # Q4 without its EXISTS subquery (the grammar has none): the orders
    # of [1993-07-01, 1993-10-01) counted by priority, a dictionary key;
    # COUNT(*) is an aggregate K2 covers, so this GROUP BY takes the
    # dictionary plan
    "Q4": "SELECT o_orderpriority, COUNT(*) AS order_count FROM orders "
          f"WHERE o_orderdate >= {_days(1993, 7, 1)} "
          f"AND o_orderdate < {_days(1993, 10, 1)} "
          "GROUP BY o_orderpriority ORDER BY o_orderpriority",
    # l_shipdate in [1994-01-01, 1995-01-01), discount 0.06 +- 0.01
    "Q6": "SELECT SUM(l_extendedprice * l_discount) AS revenue "
          f"FROM lineitem WHERE l_shipdate >= {_days(1994, 1, 1)} "
          f"AND l_shipdate < {_days(1995, 1, 1)} "
          "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24",
    # o_orderdate in [1993-10-01, 1994-01-01)
    "Q10": "SELECT c_custkey, c_name, "
           "SUM(l_extendedprice * (1 - l_discount)) AS revenue, c_acctbal, "
           "n_name, c_address, c_phone, c_comment FROM nation "
           "JOIN customer ON n_nationkey = c_nationkey "
           "JOIN orders ON c_custkey = o_custkey "
           "JOIN lineitem ON o_orderkey = l_orderkey "
           f"WHERE o_orderdate >= {_days(1993, 10, 1)} "
           f"AND o_orderdate < {_days(1994, 1, 1)} "
           "AND l_returnflag = 'R' "
           "GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, "
           "c_address, c_comment ORDER BY revenue DESC LIMIT 20",
}


def _ascii_rows(parts, dev):
    """A utf8 column of fixed-width rows: `parts` are bytes (the same in
    every row) or (n, w) uint8 tensors, joined left to right."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import StringColumn
    n = next(p.shape[0] for p in parts if isinstance(p, torch.Tensor))
    cols = [p if isinstance(p, torch.Tensor) else torch.tensor(
        list(p), dtype=torch.uint8, device=dev).expand(n, len(p))
        for p in parts]
    rows = torch.cat(cols, 1)
    w = rows.shape[1]
    return StringColumn(torch.arange(n + 1, dtype=torch.int32, device=dev)
                        * w, rows.reshape(-1).contiguous(), dt.utf8)


def _digits(v: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) ASCII digits of v, zero-padded."""
    p = 10 ** torch.arange(width - 1, -1, -1, device=v.device)
    return (48 + (v[:, None] // p) % 10).to(torch.uint8)


def _text_column(pool, n: int, lo: int, hi: int, salt: int, dev, large):
    """n comments of lo-hi bytes cut from the text pool on the card."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import StringColumn
    lens = lo + _umod(splitmix(n, salt, dev), hi - lo + 1)
    starts = _umod(splitmix(n, salt + n, dev), pool.shape[0] - hi)
    offs, data = _cut_device(pool, starts, lens)
    if large:
        return StringColumn(offs, data, dt.large_utf8)
    return StringColumn(offs.to(torch.int32), data, dt.utf8)


def tpch_tables(n: int, customers: int, dev, text: bool,
                pool_bytes: int = P30_POOL_BYTES, seed: int = SEED):
    """TPC-H's lineitem, orders, customer and nation at every column of
    the spec (1.4.1), made on the card, in the types the CSV reader gives
    dbgen's text: the money columns Float64 (the generator's cents over
    100), keys Int64, l_linenumber and o_shippriority Int32, dates
    Date32.  lineitem is phase 30's (`tpch_lineitem16`); orders holds
    one row per order of its generator (its key, its lines' status F, O
    or P, its lines' total price, its first line's order date),
    o_custkey over the customers not divisible by 3 (4.2.3); customer
    and nation by 4.2.3's rules, the text cut from the pool.  With
    `text`, the flags, modes, priorities, clerks and segments are utf8
    (as read from text) and every comment utf8; else they are
    Dictionary<Int32, Utf8> and the comments that a join repeats past
    2^31 bytes (o_, c_ and n_comment) large_utf8.  Every field is
    nullable, as the readers make them.  Returns the tables and the
    generator's integers."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.ops.strings import dictionary_decode
    pool = torch.from_numpy(tpch_text_pool(np.random.default_rng(seed + 1),
                                           pool_bytes)).to(dev)
    base, g = tpch_lineitem16(n, dev, pool_bytes, seed)

    def f64(cents):
        return PrimitiveColumn(cents.to(torch.float64) / 100, dt.float64)

    def words(ws, codes):
        col = DictionaryColumn(codes.to(torch.int32),
                               StringColumn.from_pylist(list(ws), device=dev))
        return dictionary_decode(col) if text else col

    def table(cols):
        return Table(list(cols.values()), dt.Schema(tuple(
            dt.Field(k, c.dtype) for k, c in cols.items())))

    li = {f.name: c for f, c in zip(base.schema.fields, base.columns)}
    for k in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        li[k] = f64(g[k])
    if text:
        for k in ("l_returnflag", "l_linestatus", "l_shipinstruct",
                  "l_shipmode"):
            li[k] = dictionary_decode(li[k])
    lineitem = table(li)
    del base, li

    lines = g["lines"]
    m = lines.shape[0]
    order = torch.repeat_interleave(torch.arange(m, device=dev), lines,
                                    output_size=n)
    first = torch.cumsum(lines, 0) - lines
    open_ = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
        0, order, g["status"].to(torch.int64))
    status = torch.where(open_ == 0, 0, torch.where(open_ == lines, 1, 2))
    charge = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
        0, order, g["l_extendedprice"] * (100 + g["l_tax"])
        * (100 - g["l_discount"]))
    raw, _, _ = tpch_dates(n, dev)
    k3 = _umod(splitmix(m, 16 * n, dev), 2 * customers // 3)
    clerks = max(n // 6_000, 1)                 # SF * 1,000 (4.2.3)
    clerk_names = _ascii_rows([b"Clerk#", _digits(
        torch.arange(1, clerks + 1, device=dev), 9)], dev)
    clerk = DictionaryColumn(_umod(splitmix(m, 17 * n, dev), clerks)
                             .to(torch.int32), clerk_names)
    orders = table({
        "o_orderkey": PrimitiveColumn(g["okeys"], dt.int64),
        "o_custkey": PrimitiveColumn(3 * (k3 // 2) + 1 + k3 % 2, dt.int64),
        "o_orderstatus": words("FOP", status),
        "o_totalprice": f64((charge + 5_000) // 10_000),
        "o_orderdate": PrimitiveColumn(raw["o_orderdate"][first], dt.date32),
        "o_orderpriority": words(P32_PRIORITIES,
                                 _umod(splitmix(m, 18 * n, dev), 5)),
        "o_clerk": dictionary_decode(clerk) if text else clerk,
        "o_shippriority": PrimitiveColumn(
            torch.zeros(m, dtype=torch.int32, device=dev), dt.int32),
        "o_comment": _text_column(pool, m, 19, 78, 19 * n, dev, not text)})
    del order, first, open_, charge, raw

    nc = customers
    key = torch.arange(1, nc + 1, device=dev)
    nation = _umod(splitmix(nc, 20 * n, dev), 25)
    dash = b"-"
    phone = [_digits(nation + 10, 2), dash,
             _digits(100 + _umod(splitmix(nc, 21 * n, dev), 900), 3), dash,
             _digits(100 + _umod(splitmix(nc, 22 * n, dev), 900), 3), dash,
             _digits(1000 + _umod(splitmix(nc, 23 * n, dev), 9000), 4)]
    customer = table({
        "c_custkey": PrimitiveColumn(key, dt.int64),
        "c_name": _ascii_rows([b"Customer#", _digits(key, 9)], dev),
        "c_address": _text_column(pool, nc, 10, 40, 24 * n, dev, False),
        "c_nationkey": PrimitiveColumn(nation, dt.int64),
        "c_phone": _ascii_rows(phone, dev),
        "c_acctbal": f64(_umod(splitmix(nc, 25 * n, dev), 1_099_999)
                         - 99_999),
        "c_mktsegment": words(P32_SEGMENTS,
                              _umod(splitmix(nc, 26 * n, dev), 5)),
        "c_comment": _text_column(pool, nc, 29, 116, 27 * n, dev,
                                  not text)})
    nations = table({
        "n_nationkey": PrimitiveColumn(torch.arange(25, device=dev),
                                       dt.int64),
        "n_name": StringColumn.from_pylist([a for a, _ in P32_NATIONS],
                                           device=dev),
        "n_regionkey": PrimitiveColumn(torch.tensor(
            [b for _, b in P32_NATIONS], device=dev), dt.int64),
        "n_comment": _text_column(pool, 25, 31, 114, 28 * n, dev,
                                  not text)})
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "nation": nations}, g


def _arrow(t, names=None):
    """Columns of a port table as a pyarrow Table on the host (one copy
    a buffer), dictionaries decoded."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.io.interop import table_to_pyarrow
    if names is not None:
        fields = {f.name: f for f in t.schema.fields}
        t = Table([t.column(k) for k in names],
                  dt.Schema(tuple(fields[k] for k in names)))
    b = table_to_pyarrow(t)
    cols = [pc.cast(c, c.type.value_type) if pa.types.is_dictionary(c.type)
            else c for c in b.columns]
    return pa.table(cols, names=b.schema.names)


def _valid_masks_dropped(t):
    """`t` with each all-true validity mask dropped (a reader's cast may
    add one; its rows are the same)."""
    from arrow_tpu_torch.core.table import Table
    cols = [c.with_validity(None) if c.validity is not None
            and bool(c.validity.all()) else c for c in t.columns]
    return Table(cols, t.schema)


def p31_calls(tables: dict, dev, meter, tmp, avro_rows: int = P31_AVRO_ROWS):
    """Phase 31's steps for each table: write_csv with '|', pyarrow.csv
    reads the text back equal to the source and read_csv onto the card
    equal to the source; the same with write_json (lines) against
    pyarrow.json (dates read as text, then cast); write_avro / read_avro
    of the first `avro_rows` rows held to the source; checkpoint_table /
    restore_table.  Each step timed on the host clock (synced) by
    `meter`; returns the bytes written."""
    import io
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.csv as pacsv
    import pyarrow.json as pajson
    from arrow_tpu_torch.io import avro, checkpoint, csv, json_io
    codec = "lz4"
    what = meter.what
    sizes = {}
    for name, t in tables.items():
        src = _arrow(t)
        types = src.schema

        def same_arrow(got, step):
            got = got.combine_chunks()
            if not got.equals(src):
                raise AssertionError(f"{what}: {name} {step} differs from "
                                     "the source")

        buf = io.BytesIO()
        meter.host(f"{name} write_csv",
                   lambda: csv.WriterBuilder(delimiter="|").write(buf, t))
        data = buf.getvalue()
        sizes[f"{name} CSV"] = len(data)
        same_arrow(meter.host(f"{name} pyarrow.csv reads", lambda: (
            pacsv.read_csv(io.BytesIO(data), parse_options=pacsv.ParseOptions(
                delimiter="|"), convert_options=pacsv.ConvertOptions(
                column_types=types)))), "CSV read by pyarrow")
        got = meter.host(f"{name} read_csv", lambda: csv.read_csv(
            data, t.schema, delimiter="|", device=dev))
        _same_table(got, t, f"{what}: {name} read_csv")
        del data, got

        buf = io.BytesIO()
        meter.host(f"{name} write_json", lambda: json_io.write_json(buf, t))
        data = buf.getvalue()
        sizes[f"{name} JSON lines"] = len(data)
        text = pa.schema([pa.field(f.name, pa.string()
                                   if pa.types.is_date(f.type) else f.type)
                          for f in types])
        back = meter.host(f"{name} pyarrow.json reads", lambda: (
            pajson.read_json(io.BytesIO(data), parse_options=(
                pajson.ParseOptions(explicit_schema=text)))))
        same_arrow(pa.table([pc.cast(back[f.name], f.type) for f in types],
                            schema=types), "JSON read by pyarrow")
        got = meter.host(f"{name} read_json", lambda: json_io.read_json(
            data, t.schema, device=dev))
        _same_table(_valid_masks_dropped(got), t,
                    f"{what}: {name} read_json")
        del data, got, back

        part = t.slice(0, min(avro_rows, t.num_rows))
        buf = io.BytesIO()
        meter.host(f"{name} write_avro ({part.num_rows:,} rows)",
                   lambda: avro.write_avro(buf, part))
        sizes[f"{name} Avro ({part.num_rows:,} rows)"] = buf.tell()
        got = meter.host(f"{name} read_avro", lambda: avro.read_avro(
            buf.getvalue(), device=dev))
        _same_table(got, part, f"{what}: {name} read_avro")

        path = str(tmp / f"{name}.arrow")
        meter.host(f"{name} checkpoint_table ({codec})",
                   lambda: checkpoint.checkpoint_table(path, t,
                                                       compression=codec))
        sizes[f"{name} checkpoint ({codec})"] = Path(path).stat().st_size
        got = meter.host(f"{name} restore_table", lambda: (
            checkpoint.restore_table(path, device=dev)))
        _same_table(got, t, f"{what}: {name} restore_table")
        del got, src
    return sizes


def run_phase31(dev, profile: bool) -> None:
    """Phase 31: TPC-H SF1 lineitem and orders made on the card, through
    CSV, JSON lines, Avro (cut) and checkpoints, each held to the source
    and to pyarrow's reading."""
    import tempfile
    what = "phase 31, TPC-H SF1 through the text formats"
    t0 = time.perf_counter()
    tabs, _ = tpch_tables(P31_ROWS, P31_CUSTOMERS, dev, text=True)
    tabs = {k: tabs[k] for k in ("lineitem", "orders")}
    torch.cuda.synchronize()
    print(f"{what}: lineitem {tabs['lineitem'].num_rows:,} rows, orders "
          f"{tabs['orders'].num_rows:,} made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    meter = CardMeter(profile, what)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        sizes = p31_calls(tabs, dev, meter, Path(tmp))
    print(f"{what}: every round trip equal to its source and to pyarrow's "
          f"reading; seconds (host clock, synced): "
          f"{json.dumps({k: round(v, 3) for k, v in meter.seconds.items()})}"
          f"; bytes: {json.dumps(sizes)}; peak device memory "
          f"{peak_gib():.2f} GiB", flush=True)


def _rows_close(got: list, want: list, floats: set, what: str) -> None:
    """Rows of (name -> value) dicts: equal, floats within P32_RTOL."""
    import math
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        for k, v in b.items():
            ok = math.isclose(a[k], v, rel_tol=P32_RTOL) if k in floats \
                else a[k] == v
            if not ok:
                raise AssertionError(f"{what}: row {i} {k} {a[k]!r} "
                                     f"against {v!r}")


def _port_rows(t) -> list:
    d = t.to_pydict()
    return [dict(zip(d, r)) for r in zip(*d.values())]


def p32_pyarrow(name: str, pat: dict) -> list:
    """The answer to P32_QUERIES[name] computed by pyarrow over host
    copies of the tables (an independent computation): rows of dicts,
    in the query's order."""
    import pyarrow as pa
    import pyarrow.compute as pc
    d = lambda *a: pa.scalar(_days(*a), pa.date32())
    li = pat["lineitem"]
    rev = lambda t: pc.multiply(t["l_extendedprice"],
                                pc.subtract(1.0, t["l_discount"]))
    if name == "Q1":
        f = li.filter(pc.less_equal(li["l_shipdate"], d(1998, 9, 2)))
        dp = rev(f)
        t = pa.table({"l_returnflag": f["l_returnflag"],
                      "l_linestatus": f["l_linestatus"],
                      "q": f["l_quantity"], "p": f["l_extendedprice"],
                      "dp": dp, "ch": pc.multiply(dp, pc.add(1.0, f["l_tax"])),
                      "d": f["l_discount"]})
        g = t.group_by(["l_returnflag", "l_linestatus"]).aggregate([
            ("q", "sum"), ("p", "sum"), ("dp", "sum"), ("ch", "sum"),
            ("q", "mean"), ("p", "mean"), ("d", "mean"), ("q", "count")])
        g = g.sort_by([("l_returnflag", "ascending"),
                       ("l_linestatus", "ascending")])
        names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
                 "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
                 "avg_disc", "count_order"]
        cols = ["l_returnflag", "l_linestatus", "q_sum", "p_sum", "dp_sum",
                "ch_sum", "q_mean", "p_mean", "d_mean", "q_count"]
    elif name == "Q4":
        o = pat["orders"]
        f = o.filter(pc.and_(pc.greater_equal(o["o_orderdate"],
                                              d(1993, 7, 1)),
                             pc.less(o["o_orderdate"], d(1993, 10, 1))))
        g = f.group_by(["o_orderpriority"]).aggregate([([], "count_all")])
        g = g.sort_by([("o_orderpriority", "ascending")])
        names = ["o_orderpriority", "order_count"]
        cols = ["o_orderpriority", "count_all"]
    elif name == "Q6":
        f = li.filter(pc.and_(pc.and_(
            pc.greater_equal(li["l_shipdate"], d(1994, 1, 1)),
            pc.less(li["l_shipdate"], d(1995, 1, 1))), pc.and_(pc.and_(
                pc.greater_equal(li["l_discount"], 0.05),
                pc.less_equal(li["l_discount"], 0.07)),
                pc.less(li["l_quantity"], 24.0))))
        s = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"]))
        return [{"revenue": s.as_py()}]
    elif name == "Q3":
        c = pat["customer"]
        c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING"))
        o = pat["orders"]
        o = o.filter(pc.less(o["o_orderdate"], d(1995, 3, 15)))
        o = o.join(c.select(["c_custkey"]), "o_custkey", "c_custkey",
                   join_type="inner")
        f = li.filter(pc.greater(li["l_shipdate"], d(1995, 3, 15)))
        j = f.join(o, "l_orderkey", "o_orderkey", join_type="inner")
        t = pa.table({"l_orderkey": j["l_orderkey"], "r": rev(j),
                      "o_orderdate": j["o_orderdate"],
                      "o_shippriority": j["o_shippriority"]})
        g = t.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
            .aggregate([("r", "sum")])
        g = g.sort_by([("r_sum", "descending"),
                       ("o_orderdate", "ascending")]).slice(0, 10)
        names = ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]
        cols = ["l_orderkey", "r_sum", "o_orderdate", "o_shippriority"]
    elif name == "Q10":
        o = pat["orders"]
        o = o.filter(pc.and_(pc.greater_equal(o["o_orderdate"],
                                              d(1993, 10, 1)),
                             pc.less(o["o_orderdate"], d(1994, 1, 1))))
        f = li.filter(pc.equal(li["l_returnflag"], "R"))
        j = f.join(o.select(["o_orderkey", "o_custkey"]), "l_orderkey",
                   "o_orderkey", join_type="inner")
        j = j.join(pat["customer"], "o_custkey", "c_custkey",
                   join_type="inner")        # keeps o_custkey's name
        j = j.join(pat["nation"].select(["n_nationkey", "n_name"]),
                   "c_nationkey", "n_nationkey", join_type="inner")
        keys = ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                "c_address", "c_comment"]
        t = pa.table({**{k: j["o_custkey" if k == "c_custkey" else k]
                         for k in keys}, "r": rev(j)})
        g = t.group_by(keys).aggregate([("r", "sum")])
        g = g.sort_by([("r_sum", "descending")]).slice(0, 20)
        names = ["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                 "c_address", "c_phone", "c_comment"]
        cols = ["c_custkey", "c_name", "r_sum", "c_acctbal", "n_name",
                "c_address", "c_phone", "c_comment"]
    else:
        raise KeyError(name)
    py = {n: g[c].to_pylist() for n, c in zip(names, cols)}
    return [dict(zip(py, r)) for r in zip(*py.values())]


P32_FLOATS = {"sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
              "avg_qty", "avg_price", "avg_disc", "revenue"}
P32_NEEDS = {"lineitem": ["l_orderkey", "l_quantity", "l_extendedprice",
                          "l_discount", "l_tax", "l_returnflag",
                          "l_linestatus", "l_shipdate"],
             "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                        "o_orderpriority", "o_shippriority"],
             "customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                          "c_phone", "c_acctbal", "c_mktsegment",
                          "c_comment"],
             "nation": ["n_nationkey", "n_name"]}
# Q1's float sums take the sort plan (K2 sums integers only, as in the
# reference's _agg_supported), so K2 runs under SQL at Q4's COUNT(*)
P32_MUST = {"Q1": "compact", "Q3": "compact", "Q4": "grouped_aggregate",
            "Q6": "compact", "Q10": "compact"}
# the modules whose K1 calls an SQL query makes: Q10's string keys are
# encoded on the card, and the encode drops finished rows and finds the
# values' first rows with K1
K1_SQL = (("compact", "filter"), ("compact", "groupby"), ("compact", "join"),
          ("compact", "sort"), ("compact", "strings"))


def p32_calls(tabs: dict, dev, meter, cpu_rows: int = P32_CPU_ROWS):
    """Phase 32's queries (P32_QUERIES) through execute_sql over `tabs`
    on `dev`, each run with the launch counts at 0 (every K1 and K2 call
    of the run on the card launched once), then timed by `meter`, its
    answer held to pyarrow's over host copies (group keys, counts and
    row order exactly, float sums within P32_RTOL).  Q1 at `cpu_rows`
    rows also runs on the CPU route and equals the card's answer (float
    sums within P32_RTOL: the card's scan adds in another order).
    Returns {site: (recorded calls, the query's launch counts)} for the
    K1 and K2 sites and the rows each query gave."""
    from arrow_tpu_torch.sql import execute_sql
    what = meter.what
    pat = {k: _arrow(tabs[k], cols) for k, cols in P32_NEEDS.items()}
    sites, answers = {}, {}
    for name, query in P32_QUERIES.items():
        run = lambda query=query: execute_sql(tabs, query)
        out, launches, calls = meter.counted(
            name, P32_MUST[name], run, *K1_SQL,
            ("grouped_aggregate", "groupby"))
        k1, k2 = sum(calls[:len(K1_SQL)], []), calls[len(K1_SQL)]
        for kernel, made in (("compact", k1), ("grouped_aggregate", k2)):
            on_card = sum(a[0].is_cuda for a, _ in made)
            if launches[kernel] != on_card:
                raise AssertionError(f"{what}: {name} launched {kernel} "
                                     f"{launches[kernel]} times for "
                                     f"{on_card} calls on the card")
        if any(c.device != dev for c in out.columns):
            raise AssertionError(f"{what}: {name}'s answer is not on {dev}")
        got = _port_rows(out)
        _rows_close(got, p32_pyarrow(name, pat), P32_FLOATS,
                    f"{what}: {name} against pyarrow")
        answers[name] = got
        filt, grp, join, _, enc = calls[:len(K1_SQL)]
        print(f"{what}: {name} {len(got)} rows equal to pyarrow's; "
              f"launches {launches}; K1 calls: filter {len(filt)}, "
              f"group_by {len(grp)}, join {len(join)}, string encodes "
              f"{len(enc)}; K2 calls {len(k2)}; "
              f"first row "
              f"{got[0] if got else None}", flush=True)
        if name == "Q6":
            sites["Q6 WHERE"] = (filt, launches)
        elif name == "Q1":
            sites["Q1 group_by run starts"] = (grp, launches)
        elif name == "Q3":
            sites["Q3 joins"] = (join, launches)
            sites["Q3 group_by run starts"] = (grp, launches)
        elif name == "Q4":
            sites["Q4 group_by"] = (k2, launches)
        # the recorded calls hold the joins' inputs: only the sites' stay
        del out, calls, k1, k2, filt, grp, join, enc
        meter.timed(name, run)
    part = {"lineitem": tabs["lineitem"].slice(0, min(
        cpu_rows, tabs["lineitem"].num_rows))}
    on_card = _port_rows(execute_sql(part, P32_QUERIES["Q1"]))
    on_cpu = _port_rows(execute_sql({"lineitem": _cpu(part["lineitem"])},
                                    P32_QUERIES["Q1"]))
    _rows_close(on_card, on_cpu, P32_FLOATS - {"sum_qty", "avg_qty"},
                f"{what}: Q1 at {part['lineitem'].num_rows:,} rows against "
                f"the CPU route")
    print(f"{what}: Q1 at {part['lineitem'].num_rows:,} rows equal to the "
          f"CPU route (keys, counts and the integer-valued quantity sums "
          f"bit for bit)", flush=True)
    return sites, answers


def run_phase32(dev, profile: bool) -> list:
    """Phase 32: TPC-H Q1, Q3, Q4, Q6 and Q10 as SQL text at SF10 over
    lineitem, orders, customer and nation made on the card.  Returns the
    kernel entries of its K1 and K2 sites, each with the launches of the
    query that holds it."""
    what = "phase 32, TPC-H SF10 as SQL"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tabs, _ = tpch_tables(P32_ROWS, P32_CUSTOMERS, dev, text=False)
    torch.cuda.synchronize()
    from arrow_tpu_torch.core.pool import table_memory_size
    print(f"{what}: " + ", ".join(
        f"{k} {t.num_rows:,} rows ({table_memory_size(t):,} bytes)"
        for k, t in tabs.items())
        + f" made on the card in {time.perf_counter() - t0:.1f} s; peak "
        f"{peak_gib():.2f} GiB", flush=True)
    meter = CardMeter(profile, what)
    sites, _ = p32_calls(tabs, dev, meter)
    print(f"{what}: peak device memory {meter.peak_gib():.2f} GiB; "
          f"latency (CUDA events, median of 5; ms): "
          + json.dumps(meter.times), flush=True)
    entries = [q6_where_entry("phase 32", *sites["Q6 WHERE"])]
    for key, label in (("Q1 group_by run starts",
                        "Q1 GROUP BY l_returnflag, l_linestatus sort-plan "
                        "run starts"), ("Q3 joins", "Q3 JOIN"),
                       ("Q3 group_by run starts",
                        "Q3 GROUP BY o_orderkey, o_orderdate, "
                        "o_shippriority sort-plan run starts")):
        calls, launches = sites[key]
        for i, (args, kwargs) in enumerate(calls):
            keep, arrays = args[:2]
            site = _compact_site(
                f"phase 32 {label}, K1 call {i + 1} of {len(calls)}, "
                f"{keep.shape[0]:,} rows, {int(keep.sum()):,} kept", keep,
                tuple(arrays), kwargs.get("out_cap"),
                lambda keep=keep, arrays=arrays: (
                    tuple(a[keep] for a in arrays), keep.nonzero()),
                kwargs.get("positions"))
            err = check_site(site, same_compaction, f"K1 at "
                             f"{site.call_site}")
            entries.append(_entry(site, launches["compact"], err))
    entries.append(q4_group_entry("phase 32", *sites["Q4 group_by"]))
    return entries


def q6_where_entry(phase: str, calls, launches) -> dict:
    """K1 at Q6's WHERE (filter_table of lineitem), from the one call
    the query made, against its plain version: the kernels-line entry,
    with the query's launches."""
    (args, kwargs), = calls
    keep, arrays = args[:2]
    site = _compact_site(
        f"{phase} Q6 WHERE filter_table of lineitem (16 columns), "
        f"{keep.shape[0]:,} rows, {float(keep.float().mean()):.2%} kept",
        keep, tuple(arrays), kwargs.get("out_cap"),
        lambda: (tuple(a[keep] for a in arrays), keep.nonzero()),
        kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    return _entry(site, launches["compact"], err)


def q4_group_entry(phase: str, calls, launches) -> dict:
    """K2 at Q4's GROUP BY o_orderpriority (the dictionary plan's
    COUNT(*)), from the one call the query made, against its plain
    version and, for counts alone, torch.bincount."""
    (args, kwargs), = calls
    codes, groups = args[:2]
    site = _k2_site(f"{phase} Q4 GROUP BY o_orderpriority dictionary plan, "
                    f"COUNT(*), {codes.shape[0]:,} rows x {groups} codes",
                    calls[0])
    if not kwargs.get("mm_cols") and kwargs.get("codes_valid") is None \
            and kwargs.get("base", 0) == 0 \
            and all(c.values is None for c in kwargs["sum_cols"]):
        # counts alone: one bincount computes the same function
        site = dataclasses.replace(site, library=lambda: torch.bincount(
            codes, minlength=groups))
    err = check_site(site, same_aggregates, f"K2 at {site.call_site}")
    return _entry(site, launches["grouped_aggregate"], err)


P33_REPS = 5                       # served and direct calls timed
P33_WRITERS = 4                    # clients inserting at once
P33_INSERTS = 25                   # single-row INSERTs each


def host_ms(fn, reps: int = P33_REPS) -> float:
    """Median host-clock time of `fn` over `reps` runs after a warm-up,
    synced before and after each: a served call as its client sees it."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _fields(t) -> list:
    return [(f.name, repr(f.dtype), f.nullable) for f in t.schema.fields]


def p33_served(client, tabs: dict, dev, meter, pat: dict):
    """Phase 33's queries (P32_QUERIES) served: each asked of the
    FlightSQL server by `client`, with the launch counts at 0 around the
    call (every K1 and K2 call the server made on the card launched
    once; the query's kernel launched), its answer on the client's
    device equal to execute_sql's in process on the same tables (bit for
    bit where two direct runs agree bit for bit, else within P32_RTOL)
    and to pyarrow's; then the served call's host-clock median beside
    the direct call's host-clock and CUDA-event medians.  Returns the
    sites of served Q6's WHERE (K1) and Q4's grouping (K2), the direct
    answers, and the queries whose direct float sums varied."""
    from arrow_tpu_torch.sql import execute_sql
    what = meter.what
    sites, answers, varied, times = {}, {}, [], {}
    for name, query in P32_QUERIES.items():
        served, launches, calls = meter.counted(
            name, P32_MUST[name], lambda query=query: client.execute(query),
            *K1_SQL, ("grouped_aggregate", "groupby"))
        k1, k2 = sum(calls[:len(K1_SQL)], []), calls[len(K1_SQL)]
        for kernel, made in (("compact", k1), ("grouped_aggregate", k2)):
            on_card = sum(a[0].is_cuda for a, _ in made)
            if launches[kernel] != on_card:
                raise AssertionError(f"{what}: served {name} launched "
                                     f"{kernel} {launches[kernel]} times "
                                     f"for {on_card} calls on the card")
        if name == "Q6":
            sites["Q6 WHERE"] = (calls[0], launches)
        elif name == "Q4":
            sites["Q4 group_by"] = (k2, launches)
        del calls, k1, k2
        if any(c.device != dev for c in served.columns):
            raise AssertionError(f"{what}: served {name} is not on {dev}")
        direct = execute_sql(tabs, query)
        again = _port_rows(execute_sql(tabs, query))
        want, got = _port_rows(direct), _port_rows(served)
        if _fields(served) != _fields(direct):
            raise AssertionError(f"{what}: served {name}'s fields "
                                 f"{_fields(served)} against "
                                 f"{_fields(direct)}")
        if again == want:
            if got != want:
                raise AssertionError(f"{what}: served {name} differs from "
                                     f"execute_sql's answer")
        else:
            varied.append(name)
            _rows_close(got, want, P32_FLOATS,
                        f"{what}: served {name} against execute_sql")
        _rows_close(got, p32_pyarrow(name, pat), P32_FLOATS,
                    f"{what}: served {name} against pyarrow")
        answers[name] = direct
        times[name] = {
            "served_host_ms": host_ms(lambda query=query:
                                      client.execute(query)),
            "direct_host_ms": host_ms(lambda query=query:
                                      execute_sql(tabs, query)),
            "direct_cuda_ms": time_ms(lambda query=query:
                                      execute_sql(tabs, query))}
        t = times[name]
        print(f"{what}: served {name}, {len(got)} rows, "
              f"{'bit for bit' if name not in varied else 'within rtol'} "
              f"equal to execute_sql's and equal to pyarrow's; launches "
              f"{launches}; served {t['served_host_ms']:.3f} ms (host "
              f"clock), direct {t['direct_host_ms']:.3f} ms (host clock), "
              f"{t['direct_cuda_ms']:.3f} ms (CUDA events); overhead "
              f"{t['served_host_ms'] - t['direct_host_ms']:.3f} ms",
              flush=True)
    return sites, answers, varied, times


def p33_transfers(uri: str, server, tabs: dict, dev) -> dict:
    """orders through DoGet (the port's client and pyarrow.flight's) and
    DoPut (the port's client, under a new name, onto the server's card),
    each equal to its source; seconds and GB/s (the table's bytes on the
    card over the host-clock seconds, synced)."""
    import pyarrow as pa
    import pyarrow.flight as paf
    from arrow_tpu_torch.core.pool import table_memory_size
    from arrow_tpu_torch.io.flight import FlightTableClient
    from arrow_tpu_torch.io.interop import table_to_pyarrow
    what = "phase 33 transfers"
    orders = tabs["orders"]
    nbytes = table_memory_size(orders)
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = {"s": secs, "GB/s": nbytes / secs / 1e9}
        print(f"{what}: {name} of orders ({orders.num_rows:,} rows, "
              f"{nbytes:,} bytes) {secs:.3f} s, {nbytes / secs / 1e9:.3f} "
              f"GB/s; peak device memory {peak_gib():.2f} GiB", flush=True)
        return got

    client = FlightTableClient(uri, device=dev)
    try:
        got = timed("DoGet, the port's client",
                    lambda: client.do_get("orders"))
        if any(c.device != dev for c in got.columns):
            raise AssertionError(f"{what}: DoGet's orders not on {dev}")
        _same_table(got, orders, f"{what}: DoGet, the port's client")
        del got
        pa_client = paf.connect(uri)
        try:
            got = timed("DoGet, pyarrow.flight's client", lambda: pa_client
                        .do_get(paf.Ticket(b"orders")).read_all())
        finally:
            pa_client.close()
        if not got.equals(pa.Table.from_batches([table_to_pyarrow(orders)])):
            raise AssertionError(f"{what}: pyarrow.flight's DoGet differs "
                                 f"from orders")
        del got
        timed("DoPut, the port's client",
              lambda: client.do_put("orders_copy", orders))
        copy = server.get_table("orders_copy")
        if any(c.device != dev for c in copy.columns):
            raise AssertionError(f"{what}: DoPut's orders not on {dev}")
        _same_table(copy, orders, f"{what}: DoPut")
        del copy
    finally:
        client.close()
    print(f"{what}: every copy equal to orders", flush=True)
    return out


def p33_dml(client, uri: str, dev, answers: dict) -> None:
    """DML and statements over the service: CREATE TABLE, then
    P33_WRITERS clients inserting P33_INSERTS rows each at once (every
    row lands: the update lock); a prepared Q4 with its date range bound
    as parameters, equal to Q4's direct answer; ActionCancelQuery of Q6
    (its ticket refused, the query served again afterwards)."""
    import threading
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.io.flight import FlightError
    from arrow_tpu_torch.io.flightsql import FlightSQLClient
    what = "phase 33 DML"
    if client.execute_update("CREATE TABLE p33_log (k BIGINT, w BIGINT)"):
        raise AssertionError(f"{what}: CREATE TABLE counted rows")
    errors = []

    def writer(w):
        c = FlightSQLClient(uri, device=dev)
        try:
            for i in range(P33_INSERTS):
                if c.execute_update(f"INSERT INTO p33_log VALUES "
                                    f"({w * P33_INSERTS + i}, {w})") != 1:
                    raise AssertionError("an INSERT counted other than 1")
        except Exception as e:            # reported below, raised there
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(P33_WRITERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.perf_counter() - t0
    if errors:
        raise errors[0]
    n = P33_WRITERS * P33_INSERTS
    got = client.execute(
        "SELECT COUNT(*) AS n, SUM(k) AS s FROM p33_log").to_pydict()
    if got != {"n": [n], "s": [n * (n - 1) // 2]}:
        raise AssertionError(f"{what}: {got} after {n} inserts")
    print(f"{what}: {P33_WRITERS} clients x {P33_INSERTS} INSERTs at once, "
          f"{n} rows exactly ({secs:.3f} s)", flush=True)

    q4 = P32_QUERIES["Q4"]
    lo, hi = _days(1993, 7, 1), _days(1993, 10, 1)
    h = client.prepare(q4.replace(str(lo), "?").replace(str(hi), "?"))
    h = client.bind_prepared(h, Table.from_pydict({"p0": [lo], "p1": [hi]},
                                                  device=dev))
    bound = client.execute_prepared(h)
    client.close_prepared(h)
    if _port_rows(bound) != _port_rows(answers["Q4"]):
        raise AssertionError(f"{what}: the prepared Q4 differs from Q4")
    print(f"{what}: prepared Q4 with its dates bound equal to Q4",
          flush=True)

    info = client.get_query_info(P32_QUERIES["Q6"])
    if client.cancel_query(info) != 1:
        raise AssertionError(f"{what}: CancelQuery did not cancel")
    try:
        client._client.do_get_ticket(info.endpoints[0][0])
    except FlightError as e:
        refused = e
    else:
        raise AssertionError(f"{what}: a cancelled ticket was served")
    again = client.execute(P32_QUERIES["Q6"])
    if _port_rows(again) != _port_rows(answers["Q6"]):
        raise AssertionError(f"{what}: Q6 after the cancel differs")
    print(f"{what}: ActionCancelQuery of Q6: its ticket refused "
          f"({refused.code}), the query served again after", flush=True)


def p33_cli(uri: str, dev, tmp: str, answers: dict, rows: int = P31_ROWS,
            customers: int = P31_CUSTOMERS) -> None:
    """The CLI on `dev` (--device cuda on the card): flight-sql of Q6
    against the server prints pretty_format_table of the direct answer;
    parquet-read and pretty over an SF1 orders Parquet file the phase
    writes (`rows` lineitem rows) print its first 20 rows as pyarrow
    reads them and as the source holds them."""
    import contextlib
    import io
    import pyarrow.parquet as papq
    from arrow_tpu_torch import cli
    from arrow_tpu_torch.io.parquet_io import write_parquet
    from arrow_tpu_torch.utils.display import pretty_format_table
    what = "phase 33 CLI"

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue()

    out = run(["flight-sql", "--uri", uri, P32_QUERIES["Q6"], "--device",
               dev.type])
    if out != pretty_format_table(answers["Q6"]) + "\n":
        raise AssertionError(f"{what}: flight-sql printed {out!r}")
    print(f"{what}: flight-sql Q6 prints the direct answer:\n{out}",
          end="", flush=True)
    sf1, _ = tpch_tables(rows, customers, dev, text=False)
    orders = sf1["orders"]
    del sf1
    path = os.path.join(tmp, "orders_sf1.parquet")
    write_parquet(path, orders)
    t0 = time.perf_counter()
    lines = run(["parquet-read", path, "--limit", "20", "--device",
                 dev.type]).splitlines()
    read_s = time.perf_counter() - t0
    rows = papq.read_table(path).slice(0, 20).to_pylist()
    if lines != [json.dumps(r, default=str) for r in rows]:
        raise AssertionError(f"{what}: parquet-read differs from pyarrow's "
                             f"reading of the file")
    t0 = time.perf_counter()
    out = run(["pretty", path, "--device", dev.type])
    pretty_s = time.perf_counter() - t0
    if out != pretty_format_table(orders.slice(0, 20)) + "\n":
        raise AssertionError(f"{what}: pretty differs from the source rows")
    print(f"{what}: parquet-read (--limit 20) and pretty of SF1 orders "
          f"({orders.num_rows:,} rows, {os.path.getsize(path):,} bytes) on "
          f"{dev} equal pyarrow's reading and the source; "
          f"{read_s:.2f} s and {pretty_s:.2f} s", flush=True)


def run_phase33(dev, profile: bool) -> list:
    """Phase 33: a FlightSQL server holding TPC-H SF10 on the card, and
    clients asking it for Q1, Q3, Q4, Q6 and Q10 over localhost gRPC;
    orders through DoGet and DoPut; DML, a prepared statement and a
    cancel over the service; the CLI on the card.  Returns the kernel
    entries of served Q6's WHERE (K1) and served Q4's grouping (K2)."""
    import tempfile
    from arrow_tpu_torch.core.pool import table_memory_size
    from arrow_tpu_torch.io.flightsql import FlightSQLClient, FlightSQLServer
    what = "phase 33, FlightSQL over TPC-H SF10"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tabs, _ = tpch_tables(P32_ROWS, P32_CUSTOMERS, dev, text=False)
    torch.cuda.synchronize()
    print(f"{what}: " + ", ".join(
        f"{k} {t.num_rows:,} rows ({table_memory_size(t):,} bytes)"
        for k, t in tabs.items())
        + f" made on the card in {time.perf_counter() - t0:.1f} s",
        flush=True)
    server = FlightSQLServer("grpc://localhost:0", device=dev)
    for name, t in tabs.items():
        server.register(name, t)
    client = FlightSQLClient(server.uri, device=dev)
    meter = CardMeter(profile, what)
    try:
        pat = {k: _arrow(tabs[k], cols) for k, cols in P32_NEEDS.items()}
        sites, answers, varied, times = p33_served(client, tabs, dev, meter,
                                                   pat)
        del pat
        print(f"{what}: served answers whose direct float sums varied "
              f"between two direct runs (held within rtol "
              f"{P32_RTOL}): {varied or 'none'}; latency (ms): "
              + json.dumps(times), flush=True)
        rates = p33_transfers(server.uri, server, tabs, dev)
        client.execute_update("DROP TABLE orders_copy")
        p33_dml(client, server.uri, dev, answers)
        build = Path(__file__).resolve().parent / "build"
        build.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            p33_cli(server.uri, dev, tmp, answers)
        entries = [q6_where_entry("phase 33 served", *sites["Q6 WHERE"]),
                   q4_group_entry("phase 33 served", *sites["Q4 group_by"])]
    finally:
        client.close()
        server.shutdown()
    print(f"{what}: transfers {json.dumps(rates)}; peak device memory "
          f"{meter.peak_gib():.2f} GiB", flush=True)
    return entries


# ---- phase 34: the distributed operators over a mesh on the card -----------

P34_SHARDS = 8                     # the reference's 8-device mesh
P34_CONFIG4_ROWS = CONFIG4_ROWS    # BASELINE config 4, 500M rows
P34_CONFIG4_GROUPS = (1_000, 10_000_000)
P34_CONFIG3_ROWS = CONFIG3_ROWS    # BASELINE config 3, 100M rows
P34_PROBE = CONFIG5_PROBE          # config 5 (cut from 1B x 100M: one card)
P34_BUILD = CONFIG5_BUILD
P34_ZIPF = 1.1                     # config 5's skewed probe keys
P34_SF1_ROWS = P31_ROWS            # TPC-H SF1 lineitem for the table API
P34_NCCL_ROWS = 10_000_000
P34_SLACK = 1.25                   # a shuffle cap over the uniform share


def p34_largest_bucket(key: torch.Tensor, n_shards: int) -> int:
    """The most rows one shard's block of `key` hashes to one shard."""
    from arrow_tpu_torch.parallel.partition import _umod, hash_u64
    per = key.shape[0] // n_shards
    return max(int(torch.bincount(_umod(hash_u64(key[i * per:(i + 1) * per]),
                                        n_shards), minlength=n_shards).max())
               for i in range(n_shards))


def p34_cap(key: torch.Tensor, n_shards: int, slack: float = P34_SLACK):
    """A per-destination shuffle cap of `slack` times the uniform share,
    raised to the largest bucket the keys make (printed)."""
    per = key.shape[0] // n_shards
    biggest = p34_largest_bucket(key, n_shards)
    return max(math.ceil(slack * per / n_shards), biggest), biggest


def zipf_keys(n: int, domain: int, s: float, dev) -> torch.Tensor:
    """Ranks in [0, domain) with P(rank r) ~ (r + 1)^-s: the continuous
    inverse CDF of x^-s over [1, domain + 1) at splitmix's uniforms."""
    u = (_lsr(splitmix(n, 31 * n, dev), 11).to(torch.float64) + 0.5) / 2 ** 53
    a = 1.0 - s
    x = (1.0 + u * ((domain + 1.0) ** a - 1.0)) ** (1.0 / a)
    return torch.clamp(x.to(torch.int64) - 1, 0, domain - 1)


def _trimmed(mask: torch.Tensor, *arrays: torch.Tensor):
    return tuple(a[mask] for a in arrays)


def _same_tensor(got, want, what: str) -> None:
    if got.shape != want.shape or not torch.equal(_bits(got), _bits(want)):
        raise AssertionError(f"{what}: differs from the single-device answer "
                             f"({tuple(got.shape)} against "
                             f"{tuple(want.shape)})")


def _site_from(calls, call_site: str, launches: int,
               phase: str = "phase 34") -> dict:
    """K1 at a parallel call site, from the recorded call (of one shard's
    thread) that kept the most rows, against its plain version: the
    kernels-line entry."""
    (args, kwargs) = max(calls, key=lambda c: int(c[0][0].sum()))
    keep, arrays = args[0], tuple(args[1])
    site = _compact_site(
        f"{phase} {call_site}, {keep.shape[0]:,} rows, "
        f"{float(keep.float().mean()):.2%} kept", keep, arrays,
        kwargs.get("out_cap"),
        lambda: (tuple(a[keep] for a in arrays), keep.nonzero()),
        kwargs.get("positions"))
    err = check_site(site, same_compaction, f"K1 at {site.call_site}")
    return _entry(site, launches, err)


def p34_config4(mesh, dev, meter, groups: int, site: bool):
    """dist_group_by over config 4's rows, equal to the single-device
    group_by of the same rows (computed first and kept on the host)."""
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    n, ns = P34_CONFIG4_ROWS, mesh.size
    what = f"config 4, {n:,} rows x {groups:,} groups"
    table = config4_table(n, groups, dev)
    single = meter.host(f"{what} single-device group_by", lambda: group_by(
        table, ["k"], [AggSpec("v", op) for op in CONFIG4_AGGS]))
    want = [single.column(c).values.cpu() for c in
            ["k"] + [f"v_{op}" for op in CONFIG4_AGGS]]
    del single
    torch.cuda.empty_cache()
    k, v = table.column("k").values, table.column("v").values
    cap, biggest = p34_cap(k, ns)
    group_cap = min(groups, math.ceil(groups / ns * 1.02) + 64)
    print(f"phase 34 {what}: shuffle cap {cap:,} a destination (largest "
          f"bucket {biggest:,}; uniform share {n // ns // ns:,}), group cap "
          f"{group_cap:,} a shard", flush=True)
    ok = torch.ones(n, dtype=torch.bool, device=dev)

    def body(comm, kk, vv, okk):
        gk, gv, outs, over = par.dist_group_by(
            comm, kk, okk, cap, group_cap, [(op, vv) for op in CONFIG4_AGGS])
        return gk, gv, tuple(outs), over

    step = par.shard_map(body, mesh, (0, 0, 0), (0, 0, (0,) * 4, None))
    (gk, gv, outs, over), launches, (calls,) = meter.counted(
        what, "compact", lambda: meter.host(f"{what} dist_group_by",
                                            lambda: step(k, v, ok)),
        ("compact", "parallel.dist"))
    if bool(over):
        raise AssertionError(f"phase 34 {what}: capacity overflow")
    del table, k, v, ok
    got = _trimmed(gv, gk, *outs)
    order = torch.argsort(got[0])
    for g, w, name in zip(got, want, ["k"] + list(CONFIG4_AGGS)):
        _same_tensor(g[order], w.to(dev), f"phase 34 {what}: {name}")
    print(f"phase 34 {what}: {int(gv.sum()):,} groups over {ns} shards "
          f"equal to the single-device group_by; dist_group_by "
          f"{meter.seconds[f'{what} dist_group_by']:.3f} s, single-device "
          f"{meter.seconds[f'{what} single-device group_by']:.3f} s (host "
          f"clock, synced)", flush=True)
    del gk, gv, outs, got, want
    entry = None
    if site:
        entry = _site_from(calls, f"config 4 local_group_aggregate run "
                           f"starts (one of {ns} shards)", launches["compact"])
    del calls
    torch.cuda.empty_cache()
    return entry


def p34_config3(mesh, dev, meter) -> None:
    """dist_sort of config 3's Int64 keys (their order keys) with the row
    ids riding, equal as a sequence to one stable torch.sort."""
    from arrow_tpu_torch import parallel as par
    n, ns = P34_CONFIG3_ROWS, mesh.size
    what = f"config 3, dist_sort of {n:,} Int64 keys"
    k = config3_table(n, dev).column("k")
    valid = k.validity
    rows = torch.arange(n, device=dev)
    sel = valid.nonzero().squeeze(1)
    want_k, o = meter.host(f"{what} single-device sort", lambda: torch.sort(
        k.values[sel], stable=True))
    want_rows = sel[o]
    del sel, o
    # nulls are invalid rows, which go to the last shard with the sentinel
    cap = n // ns // 2
    key = k.values ^ (-(1 << 63))          # Int64's u64 order key

    def body(comm, kk, okk, rr):
        sk, sv, (sr,), over = par.dist_sort(comm, kk, okk, cap, (rr,))
        return sk, sv, sr, over

    step = par.shard_map(body, mesh, (0, 0, 0), (0, 0, 0, None))
    sk, sv, sr, over = meter.host(f"{what} dist_sort",
                                  lambda: step(key, valid, rows))
    if bool(over):
        raise AssertionError(f"phase 34 {what}: capacity overflow")
    got_k, got_rows = _trimmed(sv, sk, sr)
    _same_tensor(got_k ^ (-(1 << 63)), want_k, f"phase 34 {what}: keys")
    _same_tensor(got_rows, want_rows, f"phase 34 {what}: row ids")
    print(f"phase 34 {what}: {got_k.shape[0]:,} valid rows globally sorted "
          f"over {ns} shards, equal to one stable torch.sort; dist_sort "
          f"{meter.seconds[f'{what} dist_sort']:.3f} s (host clock, "
          f"synced)", flush=True)
    del k, valid, rows, key, sk, sv, sr, got_k, got_rows, want_k, want_rows
    torch.cuda.empty_cache()


def _pairs(left, right):
    """(left, right) row-id pairs sorted by left then right."""
    o = torch.argsort(left * (1 << 24) + right) if left.numel() \
        else left
    return left[o], right[o]


def p34_config5(mesh, dev, meter) -> dict:
    """dist_join_unique, dist_join and dist_join_skew at config 5's sizes,
    each equal to the single-device join_indices; returns the kernels
    entry of K1 at _compact_front."""
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.ops.join import join_indices
    n, nb, ns = P34_PROBE, P34_BUILD, mesh.size
    what = f"config 5, {n:,} probe x {nb:,} build rows"
    build = torch.arange(nb, device=dev) * 2
    prow = torch.arange(n, device=dev)
    brow = torch.arange(nb, device=dev)
    ones_p = torch.ones(n, dtype=torch.bool, device=dev)
    ones_b = torch.ones(nb, dtype=torch.bool, device=dev)
    bcap, _ = p34_cap(build, ns)
    entry = None
    for skewed in (False, True):
        probe = 2 * zipf_keys(n, nb, P34_ZIPF, dev) if skewed \
            else config5_keys(n, 0, 2 * nb, dev)
        name = f"{what}, {'Zipf(1.1)' if skewed else 'config-5'} keys"
        li, ri = meter.host(f"{name} single-device join_indices",
                            lambda: join_indices(key_table(k=probe),
                                                 key_table(k=build), ["k"]))
        want = _pairs(li, ri)
        del li, ri
        if skewed:
            pcap = math.ceil(2 * n / ns / ns)
            print(f"phase 34 {name}: light probe cap {pcap:,} a "
                  f"destination", flush=True)

            def body(comm, pk, pok, pr, bk, bok, br):
                light, (hit_h, (got_h,), hover) = par.dist_join_skew(
                    comm, pk, pok, (pr,), bk, bok, (br,), pcap, bcap)
                lk, lvalid, (lpr,), lhit, (lbr,), lover = light
                m = lvalid & lhit
                return m, lpr, lbr, hit_h, got_h, lover | hover

            step = par.shard_map(body, mesh, (0,) * 6,
                                 (0, 0, 0, 0, 0, None))
            out, launches, (calls,) = meter.counted(
                f"{name} dist_join_skew", "compact",
                lambda: meter.host(f"{name} dist_join_skew", lambda: step(
                    probe, ones_p, prow, build, ones_b, brow)),
                ("compact", "parallel.dist"))
            m, lpr, lbr, hit_h, got_h, over = out
            if bool(over):
                raise AssertionError(f"phase 34 {name}: capacity overflow")
            heavy = int(hit_h.sum())
            got = _pairs(torch.cat([lpr[m], prow[hit_h]]),
                         torch.cat([lbr[m], got_h[hit_h]]))
            for g, w, side in zip(got, want, ("probe", "build")):
                _same_tensor(g, w, f"phase 34 {name} dist_join_skew: "
                             f"{side} rows")
            print(f"phase 34 {name}: dist_join_skew matched {got[0].shape[0]:,}"
                  f" rows ({heavy:,} on the heavy keys' local path), equal "
                  f"to join_indices; {meter.seconds[f'{name} dist_join_skew']:.3f}"
                  f" s (host clock, synced)", flush=True)
            del out, m, lpr, lbr, hit_h, got_h, got
            entry = _site_from(calls, f"config 5 dist_join_skew "
                               f"_compact_front of the heavy build rows (one "
                               f"of {ns} shards)", launches["compact"])
            del calls
        else:
            pcap, biggest = p34_cap(probe, ns)
            print(f"phase 34 {name}: probe cap {pcap:,} a destination "
                  f"(largest bucket {biggest:,}), build cap {bcap:,}",
                  flush=True)

            def unique(comm, pk, pok, pr, bk, bok, br):
                _, pvalid, (spr,), hit, (sbr,), over = par.dist_join_unique(
                    comm, pk, pok, (pr,), bk, bok, (br,), pcap, bcap)
                return pvalid & hit, spr, sbr, over

            def general(comm, pk, pok, pr, bk, bok, br):
                ov, _, (spr,), (sbr,), over = par.dist_join(
                    comm, pk, pok, (pr,), bk, bok, (br,), pcap, bcap,
                    ns * pcap)
                return ov, spr, sbr, over

            for fn, call in ((unique, "dist_join_unique"),
                             (general, "dist_join")):
                step = par.shard_map(fn, mesh, (0,) * 6, (0, 0, 0, None))
                m, spr, sbr, over = meter.host(f"{name} {call}", lambda: step(
                    probe, ones_p, prow, build, ones_b, brow))
                if bool(over):
                    raise AssertionError(f"phase 34 {name} {call}: capacity "
                                         f"overflow")
                got = _pairs(spr[m], sbr[m])
                for g, w, side in zip(got, want, ("probe", "build")):
                    _same_tensor(g, w, f"phase 34 {name} {call}: {side} rows")
                print(f"phase 34 {name}: {call} matched {got[0].shape[0]:,} "
                      f"rows, equal to join_indices; "
                      f"{meter.seconds[f'{name} {call}']:.3f} s (host clock, "
                      f"synced)", flush=True)
                del m, spr, sbr, got
        del probe, want
        torch.cuda.empty_cache()
    return entry


def _same_tables(got, want, what: str) -> None:
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if g.to_pylist() != w.to_pylist():
            raise AssertionError(f"{what}: column {name} differs from the "
                                 f"single-device answer")


def p34_table_api(mesh, dev, meter) -> list:
    """dist_table_group_by, dist_table_sort and dist_table_join over TPC-H
    SF1, each equal to the single-device group_by / sort_table / join;
    returns the kernels entries of K1 at the three trims."""
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.ops.groupby import AggSpec, group_by
    from arrow_tpu_torch.ops.join import join
    from arrow_tpu_torch.ops.sort import SortOptions, sort_table
    tabs, _ = tpch_tables(P34_SF1_ROWS, P31_CUSTOMERS, dev, text=False)
    li, od = tabs["lineitem"], tabs["orders"]
    del tabs
    what = f"TPC-H SF1 ({li.num_rows:,} lineitem rows)"
    entries = []

    keys = ["l_returnflag", "l_linestatus"]
    lg = li.select(keys + ["l_quantity", "l_extendedprice", "l_orderkey"])
    aggs = [AggSpec("l_quantity", "sum"), AggSpec("l_quantity", "count"),
            AggSpec("l_extendedprice", "min"),
            AggSpec("l_extendedprice", "max"), AggSpec("l_orderkey", "sum")]
    want = group_by(lg, keys, aggs)
    got, launches, (calls,) = meter.counted(
        f"{what} dist_table_group_by", "compact",
        lambda: meter.host(f"{what} dist_table_group_by",
                           lambda: par.dist_table_group_by(lg, keys, aggs,
                                                           mesh)),
        ("compact", "parallel.api"))
    _same_tables(got, want, f"phase 34 {what} dist_table_group_by")
    print(f"phase 34 {what}: dist_table_group_by by (l_returnflag, "
          f"l_linestatus), {got.num_rows} groups, equal to group_by; "
          f"{meter.seconds[f'{what} dist_table_group_by']:.3f} s", flush=True)
    entries.append(_site_from(calls, "dist_table_group_by trim",
                              launches["compact"]))
    del lg, got, want, calls

    ls = li.select(["l_shipdate", "l_orderkey", "l_extendedprice"])
    desc, asc = SortOptions(descending=True), SortOptions()
    want = sort_table(ls, [("l_shipdate", desc), ("l_orderkey", asc)])
    got, launches, (calls,) = meter.counted(
        f"{what} dist_table_sort", "compact",
        lambda: meter.host(f"{what} dist_table_sort", lambda:
                           par.dist_table_sort(ls, ["l_shipdate",
                                                    "l_orderkey"],
                                               [desc, asc], mesh=mesh)),
        ("compact", "parallel.api"))
    for name in ls.column_names:
        _same_tensor(got.column(name).values, want.column(name).values,
                     f"phase 34 {what} dist_table_sort: {name}")
    print(f"phase 34 {what}: dist_table_sort by l_shipdate descending, "
          f"l_orderkey equal to sort_table; "
          f"{meter.seconds[f'{what} dist_table_sort']:.3f} s", flush=True)
    del ls, got, want
    entries.append(_site_from(calls, "dist_table_sort trim",
                              launches["compact"]))
    del calls

    lj = li.select(["l_orderkey", "l_linenumber", "l_quantity"])
    oj = od.select(["o_orderkey", "o_totalprice", "o_orderdate"]) \
        .rename_columns(["l_orderkey", "o_totalprice", "o_orderdate"])
    del li, od
    want = join(lj, oj, ["l_orderkey"])
    got, launches, (calls,) = meter.counted(
        f"{what} dist_table_join", "compact",
        lambda: meter.host(f"{what} dist_table_join",
                           lambda: par.dist_table_join(lj, oj, ["l_orderkey"],
                                                       mesh)),
        ("compact", "parallel.api"))
    if got.num_rows != want.num_rows:
        raise AssertionError(f"phase 34 {what} dist_table_join: "
                             f"{got.num_rows} rows, join {want.num_rows}")

    def by_line(t):
        o = torch.argsort(t.column("l_orderkey").values * 8
                          + t.column("l_linenumber").values.to(torch.int64))
        return {c: t.column(c).values[o] for c in t.column_names}
    g, w = by_line(got), by_line(want)
    for name in w:
        _same_tensor(g[name], w[name], f"phase 34 {what} dist_table_join: "
                     f"{name}")
    print(f"phase 34 {what}: dist_table_join of lineitem and orders on "
          f"l_orderkey, {got.num_rows:,} rows, equal to join (as rows); "
          f"{meter.seconds[f'{what} dist_table_join']:.3f} s", flush=True)
    del lj, oj, got, want, g, w
    entries.append(_site_from(calls, "dist_table_join trim",
                              launches["compact"]))
    del calls
    torch.cuda.empty_cache()
    return entries


def p34_nccl(dev, meter, backend: str = "nccl") -> None:
    """dist_group_by through ProcessGroupComm over NCCL at world size 1 in
    this process, equal to the LocalMesh of one shard: the NCCL calls
    launch.  Runs over several GPUs are not covered."""
    import datetime
    import tempfile
    import torch.distributed as tdist
    from arrow_tpu_torch import parallel as par
    n = P34_NCCL_ROWS
    table = config4_table(n, GROUPS, dev)
    k, v = table.column("k").values, table.column("v").values
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    specs = [(op, v) for op in CONFIG4_AGGS]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tdist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                 rank=0, world_size=1,
                                 timeout=datetime.timedelta(seconds=300))
        try:
            comm = par.ProcessGroupComm()
            got = meter.host("NCCL dist_group_by", lambda: par.dist_group_by(
                comm, k, ok, n, GROUPS, specs))
            backend = tdist.get_backend()
        finally:
            tdist.destroy_process_group()
    want = par.shard_map(lambda comm, kk, okk, vv: par.dist_group_by(
        comm, kk, okk, n, GROUPS, [(op, vv) for op in CONFIG4_AGGS]),
        par.make_mesh(1, dev), (0, 0, 0), (0, 0, (0,) * 4, None))(k, ok, v)
    for i, (g, w) in enumerate(zip([got[0], got[1], *got[2], got[3]],
                                   [want[0], want[1], *want[2], want[3]])):
        _same_tensor(g, w, f"phase 34 NCCL dist_group_by output {i}")
    print(f"phase 34 NCCL ({backend}, world size 1): dist_group_by of "
          f"{n:,} rows through ProcessGroupComm equal to the one-shard "
          f"LocalMesh; {meter.seconds['NCCL dist_group_by']:.3f} s",
          flush=True)


def run_phase34(dev, profile: bool) -> list:
    """Phase 34: the distributed operators over a LocalMesh of 8 shards on
    the one card (the reference's 8-device mesh): the dry run, configs
    4, 3 and 5 and the table API over TPC-H SF1, each equal to its
    single-device answer, then the NCCL route at world size 1.  Returns
    the kernels entries of K1 at the parallel call sites."""
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.parallel.dryrun import dryrun_multichip
    what = "phase 34"
    meter = CardMeter(profile, what)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    meter.host("dryrun_multichip", lambda: dryrun_multichip(P34_SHARDS, dev))
    print(f"{what}: dryrun_multichip({P34_SHARDS}, {dev}) passes every "
          f"host-truth check ({meter.seconds['dryrun_multichip']:.2f} s)",
          flush=True)
    mesh = par.make_mesh(P34_SHARDS, dev)
    entries = []
    for groups in P34_CONFIG4_GROUPS:
        e = p34_config4(mesh, dev, meter, groups,
                        site=groups == P34_CONFIG4_GROUPS[-1])
        entries += [e] if e is not None else []
    p34_config3(mesh, dev, meter)
    entries.append(p34_config5(mesh, dev, meter))
    entries += p34_table_api(mesh, dev, meter)
    p34_nccl(dev, meter)
    print(f"{what}: seconds (host clock, synced): " + json.dumps(
        {k: round(v, 3) for k, v in meter.seconds.items()})
        + f"; peak device memory {meter.peak_gib():.2f} GiB", flush=True)
    return entries


# ---- phase 35: the scaling harness on the card -----------------------------

P35_ROWS = 1 << 18                 # rows a shard: the reference's default
P35_LARGE_ROWS = 1 << 21           # the harness's largest size on the card


def run_phase35(dev, profile: bool) -> list:
    """Phase 35: the port's scaling harness (tools_torch/bench_scaling.py)
    over a LocalMesh of 1, 2, 4 and 8 shards on the card at P35_ROWS rows
    a shard, one timed run each; every operator's answer at N shards
    equal to its answer over the same rows on one shard, no overflow;
    the harness's JSON printed.  Returns the kernels entry of K1 at the
    8-shard group_by's run starts.  With `profile`, one 8-shard
    dist_group_by at P35_ROWS and at P35_LARGE_ROWS split into its
    exchange and its local work."""
    import importlib
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.kernels import compact as kc
    bs = importlib.import_module("tools_torch.bench_scaling")
    what = "phase 35"
    last = bs.COUNTS[-1]
    site = {}

    @contextlib.contextmanager
    def observe(op, nd):
        if (op, nd) != ("group_by", last):
            yield
            return
        before = kc.compact.launches
        with watch("compact", "parallel.dist") as calls:
            yield
        torch.cuda.synchronize()
        site["launches"], site["calls"] = kc.compact.launches - before, calls

    _reset_counts()
    t0 = time.perf_counter()
    results = bs.measure_local(dev, P35_ROWS, 1, observe)
    seconds = time.perf_counter() - t0
    launches = _read_counts(f"{what} the scaling harness", "compact")
    one = par.make_mesh(1, dev)
    for nd, x in bs.draws(P35_ROWS):
        args = bs.on(dev, x)
        for op in bs.OPS:
            rec = results[op][nd]
            if rec["overflow"]:
                raise AssertionError(f"{what} {op} at {nd} shards: capacity "
                                     f"overflow")
            if nd == 1:
                continue
            out = bs.run_local(op, one, args)
            if bool(out[1]) or not bs.same_answer(rec["answer"],
                                                  bs.answer(op, out)):
                raise AssertionError(f"{what} {op} at {nd} shards differs "
                                     f"from its answer at 1 shard")
            del out
        del args
    print(f"{what}: the scaling harness at {P35_ROWS:,} rows a shard, "
          f"{len(bs.OPS)} operators at {bs.COUNTS} shards, every answer "
          f"equal to the 1-shard answer over the same rows, no overflow; "
          f"{seconds:.3f} s (host clock); K1 launches {launches['compact']}",
          flush=True)
    print(json.dumps(bs.report(results, P35_ROWS, dev.type, "local",
                               card())), flush=True)
    entry = _site_from(site["calls"], f"{last}-shard group_by "
                       f"local_group_aggregate run starts (one of {last} "
                       f"shards)", site["launches"], phase=what)
    del site
    if profile:
        for per in (P35_ROWS, P35_LARGE_ROWS):
            print(f"profile {what} dist_group_by, {last} shards x {per:,} "
                  f"rows: " + json.dumps(bs.profile_split(dev, per)),
                  flush=True)
    torch.cuda.empty_cache()
    return [entry]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace the group-bys, the joins, configs 2 "
                         "and 3 and phases 24-29 with torch.profiler, and "
                         "split phase 35's 8-shard dist_group_by into its "
                         "exchange and its local work (phase 34 is "
                         "host-clock timed only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from arrow_tpu_torch import pipeline
    from arrow_tpu_torch.kernels import compact as kc, groupagg as kg, native
    from arrow_tpu_torch.ops.groupby import group_by

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    lib = native.library()
    print(f"kernels built in {lib.build_seconds:.2f} s (nvcc), loaded in "
          f"{time.perf_counter() - t0:.2f} s: {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    k1_err = check_compact(dev)
    table = dictionary_table(DICT_ROWS, dev)
    print(f"group-by table: {table.num_rows:,} rows on {dev}", flush=True)
    k2_site = k2_dictionary(table)
    k2_err = check_site(k2_site, same_aggregates, f"K2 at "
                        f"{k2_site.call_site}")

    x_np, y_np = config1_inputs()
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
    del host, want, got_d, want_d

    # step 9: times at the main path's shapes
    entries = [_entry(k1_config1(dev), launches["compact"], k1_err),
               _entry(k2_site, launches["grouped_aggregate"], k2_err)]
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    q_ms = time_ms(lambda: pipeline.query(x, y, 0))
    gb_ms = time_ms(lambda: group_by(table, ["k"], aggs))
    print(f"times (CUDA events, median of 5): config-1 query {q_ms:.4f} ms;"
          f" group_by 100M {gb_ms:.4f} ms", flush=True)
    if args.profile:
        profile_call("dictionary group_by, 100M",
                     lambda: group_by(table, ["k"], aggs))
    del x, y, k2_site, table, out

    laps = {"steps 1-9": time.perf_counter() - t_start}

    def lap(name, run):
        t0 = time.perf_counter()
        out = run()
        laps[name] = time.perf_counter() - t0
        return out

    entries += lap("K1 sweep (step 10)", lambda: run_k1_sweep(dev))
    entries.append(lap("sort plan K2 (step 11)",
                       lambda: run_sort_plan_k2(dev)))
    entries.append(lap("config 4 1K (step 12)",
                       lambda: run_config4_1k(dev, args.profile)))
    entries.append(lap("config 4 10M (steps 13-15)",
                       lambda: run_config4_10m(dev, args.profile)))
    entries += lap("config 5 resident (steps 16-18)",
                   lambda: run_config5_resident(dev, args.profile))
    lap("config 5 streamed (step 19)",
        lambda: run_config5_stream(dev, args.profile))
    entries.append(lap("config 2 (steps 20-21)",
                       lambda: run_config2(dev, args.profile)))
    entries += lap("config 3 (steps 22-23)",
                   lambda: run_config3(dev, args.profile))
    entries += lap("phase 24", lambda: run_phase24(dev, args.profile))
    entries += lap("phase 25", lambda: run_phase25(dev, args.profile))
    e26, checks26 = lap("phase 26", lambda: run_phase26(dev, args.profile))
    e27, checks27 = lap("phase 27", lambda: run_phase27(dev, args.profile))
    e28, checks28 = lap("phase 28", lambda: run_phase28(dev, args.profile))
    e29, checks29 = lap("phase 29", lambda: run_phase29(dev, args.profile))
    e30 = lap("phase 30", lambda: run_phase30(dev, args.profile))
    for name, checks in (("phase 26", checks26), ("phase 27", checks27),
                         ("phase 28", checks28), ("phase 29", checks29)):
        lap(f"{name}'s CPU route", lambda checks=checks:
            check_against_cpu(checks))
    # the CPU route's inputs (phase 28's SF10 tables among them) go
    # before phase 32's joins need the card
    del checks, checks26, checks27, checks28, checks29
    lap("phase 31", lambda: run_phase31(dev, args.profile))
    e32 = lap("phase 32", lambda: run_phase32(dev, args.profile))
    e33 = lap("phase 33", lambda: run_phase33(dev, args.profile))
    e34 = lap("phase 34", lambda: run_phase34(dev, args.profile))
    e35 = lap("phase 35", lambda: run_phase35(dev, args.profile))
    entries += e26 + e27 + e28 + e29 + e30 + e32 + e33 + e34 + e35
    print("seconds by step (host clock): " + json.dumps(
        {k: round(v, 1) for k, v in laps.items()}), flush=True)

    sources = {
        "compact": {"route": "cuda",
                    "source": "arrow_tpu_torch/csrc/compact.cu",
                    "replaces": "arrow_tpu/kernels/compact.py:46"},
        "grouped_aggregate": {"route": "cuda",
                              "source": "arrow_tpu_torch/csrc/groupagg.cu",
                              "replaces": "arrow_tpu/kernels/groupagg.py:38"},
        "strkey": {"route": "cuda", "source": "arrow_tpu_torch/csrc/strkey.cu",
                   "replaces": "none: arrow_tpu/ops/strings.py "
                               "dictionary_encode interns on the host"},
    }
    kernels = [{**e, **sources[e["name"]]} for e in entries]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
