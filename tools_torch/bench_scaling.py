"""Weak scaling of the distributed operators over a shard mesh
(counterpart of tools/bench_scaling.py).

Runs the reference harness's five bodies -- the hash-shuffle group-by,
the range-partitioned sort, the FK join, the skew-aware join and a
group-by followed by a sort -- at 1, 2, 4 and 8 shards with
`--rows-per-device` rows a shard (N shards process N times the rows:
weak scaling), and prints one JSON line: rows/s per operator and shard
count, the efficiency against N times the 1-shard rate, the throughput
retention against the 1-shard rate, the peak device memory and the
mesh-agreed overflow flag of each run.

    python tools_torch/bench_scaling.py               # LocalMesh on the card
    python tools_torch/bench_scaling.py --device cpu  # rehearsal on the CPU
    python tools_torch/bench_scaling.py --device cpu --comm gloo

`--comm local` (the default) runs a LocalMesh: a thread a shard, all on
`--device`.  The shards of one device take turns between collectives,
so the efficiency is bounded by 1/N and `throughput_retention` is the
number that means something.  `--comm gloo` runs ProcessGroupComm over
gloo in 1, 2 and 4 CPU processes that meet at a file store.  NCCL across
cards is not measured: NCCL refuses two ranks on one GPU.

With no card, the default `--device cuda` exits non-zero; nothing falls
back to the CPU.  `--profile` also splits one 8-shard dist_group_by's
device time into its exchange and its local work (torch.profiler, CUDA).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from arrow_tpu_torch import parallel as par  # noqa: E402

COUNTS = (1, 2, 4, 8)          # shard counts of the local mesh
GLOO_COUNTS = (1, 2, 4)        # processes of the gloo route
KEY_DOMAIN = 1 << 20           # keys in [0, 2^20) (tools/bench_scaling.py:68)
GLOO_TIMEOUT = 600             # seconds a gloo process waits in a collective
ARGS = ("k", "v", "m", "bk", "bm", "bv")


# ---- inputs ---------------------------------------------------------------

def draw(rng: np.random.Generator, per: int, nd: int) -> Dict[str, np.ndarray]:
    """One shard count's inputs, the numbers tools/bench_scaling.py:66-73
    draws in its order: probe keys uniform over the key domain and values
    in [-1000, 1000), all valid; build keys and values arange(n).  u64
    keys are their bits on int64 storage, as parallel/ takes them."""
    n = per * nd
    keys = rng.integers(0, KEY_DOMAIN, n, dtype=np.uint64).view(np.int64)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    return {"k": keys, "v": vals, "m": np.ones(n, np.bool_),
            "bk": np.arange(n, dtype=np.int64), "bm": np.ones(n, np.bool_),
            "bv": np.arange(n, dtype=np.int64)}


def draws(per: int, upto: int = COUNTS[-1]
          ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """(nd, inputs) for each shard count of COUNTS up to `upto`, drawn in
    turn from one default_rng(0): a count's inputs are the same whichever
    route or test asks for them."""
    rng = np.random.default_rng(0)
    for nd in COUNTS:
        if nd > upto:
            return
        yield nd, draw(rng, per, nd)


def inputs_at(per: int, nd: int) -> Dict[str, np.ndarray]:
    return dict(draws(per, nd))[nd]


def on(device, x: Dict[str, np.ndarray]) -> tuple:
    """The inputs as tensors on `device`, in the bodies' argument order."""
    return tuple(torch.from_numpy(x[a]).to(device) for a in ARGS)


# ---- the five bodies (tools/bench_scaling.py:82-107) -----------------------
#
# Each is a per-shard body over one communicator: (arrays, overflow),
# the arrays sharded by rows (spec 0), the flag agreed over the mesh (P()).
# The capacities are the reference's, from the shard's rows `per` and
# the shard count `nd`.

def op_group_by(comm, k, v, m, bk, bm, bv):
    per = k.shape[0]
    gk, gv, (gsum,), over = par.dist_group_by(comm, k, m, per, per,
                                              [("sum", v)])
    return (gk, gv, gsum), over


def op_sort(comm, k, v, m, bk, bm, bv):
    sk, svalid, _, over = par.dist_sort(comm, k, m, k.shape[0] * 2)
    return (sk, svalid), over


def op_join_unique(comm, k, v, m, bk, bm, bv):
    per = k.shape[0]
    _, jvalid, _, hit, (got,), over = par.dist_join_unique(
        comm, k, m, (v,), bk, bm, (bv,), per * 2, per * 2)
    return (jvalid, hit, got), over


def op_join_skew(comm, k, v, m, bk, bm, bv):
    nd = comm.size
    n = k.shape[0] * nd
    light, (hit_h, (got_h,), heavy_over) = par.dist_join_skew(
        comm, k, m, (v,), bk, bm, (bv,), n, n, heavy_cap=8,
        build_heavy_cap=8 * nd, heavy_min_frac=1.0 / 8)
    _, lvalid, _, lhit, (lgot,), light_over = light
    return (lvalid, lhit, lgot, hit_h, got_h), light_over | heavy_over


def op_fused(comm, k, v, m, bk, bm, bv):
    (gk, gv, gsum), g_over = op_group_by(comm, k, v, m, bk, bm, bv)
    (sk, svalid), s_over = op_sort(comm, k, v, m, bk, bm, bv)
    return (gk, gv, gsum, sk, svalid), g_over | s_over


OPS: Dict[str, Callable] = {
    "group_by": op_group_by, "sort": op_sort, "join_unique": op_join_unique,
    "join_skew": op_join_skew, "fused": op_fused}


def run_local(op: str, mesh, args: tuple):
    """`op` over `mesh`: (its arrays concatenated over the shards in rank
    order, the overflow flag)."""
    return par.shard_map(OPS[op], mesh, (0,) * len(ARGS), (0, None))(*args)


# ---- answers --------------------------------------------------------------

def answer(op: str, out) -> Dict[str, np.ndarray]:
    """What an operator's output means, on the host, independent of the
    shard count: the (key, sum) pairs of the valid groups by key, the
    valid keys in their order, the matched build values sorted."""
    arrays, _ = out
    a = [t.cpu().numpy() for t in arrays]
    if op == "sort":
        return {"sorted_keys": a[0][a[1]]}
    if op == "join_unique":
        return {"matched": np.sort(a[2][a[0] & a[1]])}
    if op == "join_skew":
        return {"matched": np.sort(np.concatenate(
            [a[2][a[0] & a[1]], a[4][a[3]]]))}
    keys, sums = a[0][a[1]], a[2][a[1]]
    order = np.argsort(keys, kind="stable")
    got = {"group_keys": keys[order], "group_sums": sums[order]}
    if op == "fused":
        got["sorted_keys"] = a[3][a[4]]
    return got


def same_answer(got: Dict[str, np.ndarray],
                want: Dict[str, np.ndarray]) -> bool:
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)


# ---- measurement ----------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(op: str, run: Callable, device: torch.device, reps: int) -> dict:
    """One warm run, whose answer and overflow flag are kept, then `reps`
    runs, each timed on the host clock with the device synchronised
    around it; the device's peak memory over all of them."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = run()
    _sync(device)
    rec = {"answer": answer(op, out), "overflow": bool(out[1])}
    del out
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    rec["seconds"] = seconds
    rec["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if device.type == "cuda" else None
    return rec


def _line(op: str, nd: int, per: int, rec: dict) -> None:
    dt = statistics.mean(rec["seconds"])
    print(f"shards={nd:>2}  {op:<12} rows={per * nd:>9}  {dt * 1e3:10.3f} ms"
          f"  {per * nd / dt / 1e6:9.3f} Mrows/s  peak "
          f"{rec['peak_gib']} GiB  overflow {rec['overflow']}", flush=True)


def measure_local(device, per: int, reps: int,
                  observe: Optional[Callable] = None) -> dict:
    """{op: {nd: record}} over a LocalMesh of each shard count on
    `device`.  `observe(op, nd)`, where given, is a context manager
    entered around each operator's runs at each count."""
    device = torch.device(device)
    results = {op: {} for op in OPS}
    for nd, x in draws(per):
        mesh = par.make_mesh(nd, device)
        args = on(device, x)
        for op in OPS:
            with observe(op, nd) if observe else contextlib.nullcontext():
                rec = measure(op, lambda: run_local(op, mesh, args), device,
                              reps)
            results[op][nd] = rec
            _line(op, nd, per, rec)
        del args
    return results


GLOO_CHILD = ("import sys; from tools_torch.bench_scaling import "
              "gloo_worker; a = sys.argv[1:]; "
              "gloo_worker(a[0], int(a[1]), int(a[2]), int(a[3]), int(a[4]), "
              "a[5])")


def gloo_worker(store: str, rank: int, world: int, per: int, reps: int,
                out: str) -> None:
    """One process of the gloo route: its block of the inputs of `world`
    shards through each body over ProcessGroupComm, one warm run kept,
    then `reps` runs timed between barriers; saved to `out`.  Each of the
    `world` processes takes an equal share of the host's cores."""
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=GLOO_TIMEOUT))
    try:
        comm = par.ProcessGroupComm()
        rows = slice(rank * per, (rank + 1) * per)
        x = inputs_at(per, world)
        args = tuple(torch.from_numpy(x[a][rows].copy()) for a in ARGS)
        got = {}
        for op, body in OPS.items():
            first = body(comm, *args)
            seconds = []
            for _ in range(reps):
                dist.barrier()
                t0 = time.perf_counter()
                body(comm, *args)
                dist.barrier()
                seconds.append(time.perf_counter() - t0)
            got[op] = {"out": first, "seconds": seconds}
        torch.save(got, out)
    finally:
        dist.destroy_process_group()


def run_gloo(world: int, per: int, reps: int) -> dict:
    """{op: record} of `world` gloo processes: the arrays of every rank
    concatenated in rank order (a LocalMesh's layout), the slowest rank's
    time of each run."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs, logs = [], []
        try:
            for r in range(world):
                logs.append(open(Path(tmp) / f"log{r}", "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", GLOO_CHILD, f"{tmp}/store", str(r),
                     str(world), str(per), str(reps), f"{tmp}/out{r}.pt"],
                    env=env, stdout=logs[r], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + GLOO_TIMEOUT * 2
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            ended = [r for r, p in enumerate(procs)
                     if p.poll() not in (None, 0)]
            running = [r for r, p in enumerate(procs) if p.poll() is None]
            if ended or running:
                r = (ended + running)[0]
                logs[r].seek(0)
                raise RuntimeError(f"gloo process {r} of {world} "
                                   + (f"ended with {procs[r].returncode}"
                                      if ended else "timed out") + ":\n"
                                   + logs[r].read()[-3000:])
            parts = [torch.load(Path(tmp) / f"out{r}.pt")
                     for r in range(world)]
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
    results = {}
    for op in OPS:
        outs = [p[op]["out"] for p in parts]
        arrays = tuple(torch.cat([o[0][i] for o in outs])
                       for i in range(len(outs[0][0])))
        results[op] = {"answer": answer(op, (arrays, outs[0][1])),
                       "overflow": bool(outs[0][1]),
                       "seconds": [max(s) for s in zip(
                           *[p[op]["seconds"] for p in parts])],
                       "peak_gib": None}
    return results


def measure_gloo(per: int, reps: int) -> dict:
    """{op: {world: record}} over 1, 2 and 4 gloo processes."""
    results = {op: {} for op in OPS}
    for world in GLOO_COUNTS:
        for op, rec in run_gloo(world, per, reps).items():
            results[op][world] = rec
            _line(op, world, per, rec)
    return results


def profile_split(device, per: int, nd: int = COUNTS[-1],
                  reps: int = 3) -> dict:
    """One `nd`-shard dist_group_by (the group_by body) on the card, and
    its two stages run as mesh calls of their own: the exchange
    (repartition_arrays: the slab build and the all_to_all's copies) and
    the local sort and aggregate (local_group_aggregate over the
    received slabs).  Device ms a call from torch.profiler's kernels
    (every shard's thread launches on the card's stream), host wall ms a
    call (median, synchronised), and the idle share of the whole call."""
    from torch.profiler import ProfilerActivity, profile
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("profile_split reads the card's kernels: pass a "
                         "CUDA device")
    mesh = par.make_mesh(nd, device)
    args = on(device, inputs_at(per, nd))

    def exchange(comm, k, v, m, bk, bm, bv):
        sh = par.repartition_arrays(comm, k, m, k.shape[0], k, v)
        return (sh.arrays[0], sh.arrays[1], sh.valid), sh.overflow

    def local(comm, k, v, ok):
        gk, gv, (gsum,), _ = par.local_group_aggregate(k, ok, per,
                                                       [("sum", v)])
        return gk, gv, gsum

    whole = par.shard_map(op_group_by, mesh, (0,) * len(ARGS), (0, None))
    shuffle = par.shard_map(exchange, mesh, (0,) * len(ARGS), (0, None))
    slabs, _ = shuffle(*args)
    aggregate = par.shard_map(local, mesh, (0, 0, 0), 0)

    def timings(fn) -> Tuple[float, float]:
        fn()
        _sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            _sync(device)
        busy = sum(e.device_time_total for e in prof.key_averages()) \
            / 1e3 / reps
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        return busy, statistics.median(walls)

    busy, wall = timings(lambda: whole(*args))
    x_busy, x_wall = timings(lambda: shuffle(*args))
    l_busy, l_wall = timings(lambda: aggregate(*slabs))
    return {"rows_per_shard": per, "shards": nd, "wall_ms": wall,
            "device_ms": busy, "idle_share": 1 - busy / wall,
            "exchange_device_ms": x_busy, "exchange_wall_ms": x_wall,
            "local_device_ms": l_busy, "local_wall_ms": l_wall}


# ---- the report -----------------------------------------------------------

NOTES = {
    "local": ("LocalMesh: a thread a shard, all on one device. The shards of "
              "one device take turns between collectives, so N shards do "
              "N times the work one after another and weak-scaling "
              "efficiency is bounded by 1/N (shared_core_efficiency_bound); "
              "throughput_retention (rows/s at N shards over rows/s at 1) is "
              "the number that means something: 1.0 = the mesh adds no cost "
              "over one shard's rate."),
    "gloo": ("ProcessGroupComm over gloo: N CPU processes on one host, each "
             "with 1/N of its cores, meeting at a file store. The host's "
             "cores are shared, so efficiency is bounded by 1/N as well; "
             "throughput_retention is the number that means something."),
}


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None
    where nvidia-smi does not answer)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.splitlines()[0] if r.stdout else None


def report(results: dict, per: int, backend: str, comm: str,
           card_name: Optional[str]) -> dict:
    """tools/bench_scaling.py's JSON (its keys, counts as strings) with
    the peak device memory, the overflow flags and the card added."""
    out = {"metric": "dist_weak_scaling_efficiency", "per_device_rows": per,
           "backend": backend, "comm": comm, "card": card_name,
           "operators": {}}
    for op, res in results.items():
        counts = sorted(res)
        rate = {nd: per * nd / statistics.mean(res[nd]["seconds"])
                for nd in counts}
        base = rate[counts[0]] / counts[0]
        out["operators"][op] = {
            "rows_per_s": {str(nd): rate[nd] for nd in counts},
            "efficiency": {str(nd): rate[nd] / (nd * base) for nd in counts},
            "throughput_retention": {str(nd): rate[nd] / rate[counts[0]]
                                     for nd in counts},
            "peak_gib": {str(nd): res[nd]["peak_gib"] for nd in counts},
            "overflow": {str(nd): res[nd]["overflow"] for nd in counts}}
    out["note"] = NOTES[comm]
    counts = sorted(next(iter(results.values())))
    out["shared_core_efficiency_bound"] = {str(nd): 1 / nd for nd in counts
                                           if nd > 1}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device (default cuda; cpu to rehearse)")
    ap.add_argument("--rows-per-device", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--comm", choices=("local", "gloo"), default="local",
                    help="local: a LocalMesh of threads on --device; gloo: "
                         "ProcessGroupComm in 1, 2 and 4 CPU processes")
    ap.add_argument("--profile", action="store_true",
                    help="also split one 8-shard dist_group_by's device time "
                         "into its exchange and its local work (CUDA only)")
    args = ap.parse_args(argv)
    if args.reps < 1 or args.rows_per_device < 1:
        ap.error("--reps and --rows-per-device must be at least 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_scaling: torch.cuda.is_available() is False; this "
              "harness measures the card (pass --device cpu to rehearse on "
              "the CPU)", file=sys.stderr)
        return 2
    if args.comm == "gloo" and device.type != "cpu":
        print("bench_scaling: the gloo route carries CPU tensors; pass "
              "--device cpu", file=sys.stderr)
        return 2
    if args.profile and device.type != "cuda":
        print("bench_scaling: --profile reads the card's kernels",
              file=sys.stderr)
        return 2
    per = args.rows_per_device
    name = card() if device.type == "cuda" else None
    if name is not None:
        print(name, flush=True)
    results = measure_gloo(per, args.reps) if args.comm == "gloo" \
        else measure_local(device, per, args.reps)
    out = report(results, per, device.type, args.comm, name)
    if args.profile:
        out["profile_split"] = profile_split(device, per)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
