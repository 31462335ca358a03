"""Run one cell of the benchmark once and print its result as the last
line of standard output.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(configs/<name>.json: the tables and the driver) and a traffic mix
(traffic/<name>.json: the queries, queries/<name>.json, and the streams
that ask them).  The run
makes the tables on the card from the seed, sets up the driver, warms
one query of each type, measures for `--seconds` (with `--trace 1` under
torch.profiler, the per-layer metrics then read by metrics/<name>.py),
and judges a sample of the window's answers, drawn from the seed,
against the plain reference (reference/<query>.py) by compare.py.
Without as many CUDA cards as the cell asks for it exits with 2 and
prints no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_tpu")

# every cache of a build or a compile inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton_cache")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import compare, harness, tpch_gen, traffic  # noqa: E402
from benchmark.trace import Profile, breakdown, spy_kernels  # noqa: E402


@dataclass
class Window:
    """What the end-to-end readers read (end_to_end/<name>.py)."""
    records: List[harness.Record]
    t_start: float
    t_open: float
    t_close: float
    completed: int
    peak_bytes: int


def _find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def reader(kind: str, metric: dict):
    """The module that reads a metric: `<kind>/<name>.py`, where a name
    `<prefix>.<name>` is the same quantity in other cells, moving (or
    bounded as) another end-to-end metric."""
    return importlib.import_module(
        f"benchmark.{kind}.{metric['name'].rsplit('.', 1)[-1]}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def cards(chips: int) -> Optional[torch.device]:
    """The first card, where there are as many as the cell asks for."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be: JAX and the
    JAX package, compared whole (arrow_tpu_torch is not arrow_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def host_use(before, after) -> str:
    """The process's CPU time between two getrusage readings: how much
    of the window the host side kept a core busy."""
    return (f"window host: user {after.ru_utime - before.ru_utime:.1f} s, "
            f"sys {after.ru_stime - before.ru_stime:.1f} s, torch threads "
            f"{torch.get_num_threads()}")


def judge(samples, tables: dict, mix: dict) -> dict:
    """Each sampled answer against the reference's: the numbers compared,
    each with its limit."""
    specs = traffic.queries_of(mix)
    cache, mismatches, gaps, seen = {}, 0, {}, {}
    for name, params, got in samples:
        spec = specs[name]
        key = (name, tuple(sorted(params.items())))
        if key not in cache:
            ref = importlib.import_module(f"benchmark.reference."
                                          f"{name.lower()}")
            cache[key] = ref.answer(tables, params)
        want, k = cache[key]
        why, gap = compare.compare(got, want, k, spec["answer"])
        seen[name] = seen.get(name, 0) + 1
        if why is not None:
            mismatches += 1
            if mismatches <= 5:
                _say(f"mismatch: {name} {params}: {why}")
        if spec["answer"]["floats"]:
            gaps[name] = max(gaps.get(name, 0.0), gap)
    checks = {"mismatches": {"value": mismatches, "limit": 0}}
    for name in mix["queries"]:
        checks[f"{name}.compared"] = {"value": seen.get(name, 0), "min": 1}
        if specs[name]["answer"]["floats"]:
            checks[f"{name}.rel_err"] = {
                "value": gaps.get(name), "limit": specs[name]["limits"][
                    "rel_err"]}
    return checks


def passed(c: dict) -> bool:
    v = c["value"]
    if v is None:
        return False
    return v >= c["min"] if "min" in c else v <= c["limit"]


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = _find(bench["workloads"], args.workload, "workload")
    config = _find(bench["configs"], cell["config"], "configuration")
    cfg = json.loads((ROOT / config["file"]).read_text())
    mix = traffic.load("traffic", cell["traffic"])

    dev = device if device is not None else cards(cell["chips"])
    if dev is None:
        _say(f"{args.workload} needs {cell['chips']} CUDA card(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
             f"{torch.cuda.device_count()} found")
        return 2
    on_card = dev.type == "cuda"
    if on_card:
        _say(f"card: {power_limit()}")

    driver_mod = importlib.import_module(f"benchmark.drivers.{cfg['driver']}")
    driver = driver_mod.Driver(cfg, mix, args.seed, dev, bool(args.trace))
    driver.start()
    try:
        t_tables = time.monotonic()
        tables = tpch_gen.make_tables(cfg, args.seed, dev)
        if on_card:
            torch.cuda.synchronize(dev)
            from arrow_tpu_torch.kernels import native
            lib = native.library()
            _say(f"kernel library {lib.path.name}: built in "
                 f"{lib.build_seconds:.1f} s" if lib.build_seconds
                 else f"kernel library {lib.path.name}: loaded")
        t_setup = time.monotonic()
        driver.setup(tables)
        _say(f"set-up: imports {t_tables - T_START:.1f} s, tables "
             f"{t_setup - t_tables:.1f} s, driver and warm queries "
             f"{time.monotonic() - t_setup:.1f} s")
        gc.collect()
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        if args.trace:
            with spy_kernels() as spies, Profile() as prof:
                records = driver.window(args.seconds)
        else:
            records = driver.window(args.seconds)
        _say(host_use(use0, resource.getrusage(resource.RUSAGE_SELF)))
        t_close = max(r.latencies[-1][2] for r in records if r.latencies)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    except BaseException:
        driver.close()
        raise
    driver.close()

    lat = [x for r in records for x in r.latencies]
    failed = sum(x[3] for x in lat)
    for r in records:
        for e in r.errors:
            _say(f"failed: {e}")
    w = Window(records, T_START, driver.t_open, t_close, len(lat) - failed,
               peak)
    metrics, extra = {}, {}
    if args.trace:
        reduce_from = time.monotonic()
        t = prof.trace(len(lat), spies)
        _say(f"trace: {len(t.dev_dur)} device events in "
             f"{t.window_s:.1f} s, reduced in "
             f"{time.monotonic() - reduce_from:.1f} s")
        for m in bench["per_layer"]:
            if _applies(m, args.workload):
                v = reader("metrics", m).read(t)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": t.busy_s, "window_s": t.window_s}
        bd = breakdown(t)
        del t, prof, spies
    else:
        for m in bench["end_to_end"]:
            if _applies(m, args.workload):
                v = reader("end_to_end", m).read(w)
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    samples = [s for r in records for s in r.samples]
    del records, w
    gc.collect()
    checks = {"failed": {"value": failed, "limit": 0},
              **judge(samples, tables, mix)}
    correct = all(passed(c) for c in checks.values())
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if on_card
                         else "cpu", "count": cell["chips"],
                         "memory_peak_bytes": peak, **extra}}
    if args.trace:
        result["breakdown"] = bd
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        _say(f"modules that must not load were loaded: {found}")
        return 3
    for k, c in checks.items():
        bound = f"at least {c['min']}" if "min" in c else f"limit {c['limit']}"
        _say(f"check {k}: {c['value']} ({bound})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
