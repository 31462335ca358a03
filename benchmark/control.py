"""The lower-precision control of `correct`, at a cell's own size: the
plain reference computed in float32 (the money columns and every
product and sum) put in the program's place, judged by compare.py
against the exact reference on the queries a run of the cell samples.
The benchmark's runs do not run it; a limit is set between the program's
readings and these.

  python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints, for each seed, the widest float gap of each query and the
answers that mismatched, as one JSON line.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import compare, tpch_gen, traffic  # noqa: E402


def readings(cfg: dict, mix: dict, seed: int, device, per_query: int):
    tables = tpch_gen.make_tables(cfg, seed, device)
    specs = traffic.queries_of(mix)
    stream = traffic.stream(mix, seed, 0)
    seen = {q: 0 for q in mix["queries"]}
    out = {q: {"rel_err": [], "mismatches": 0} for q in mix["queries"]}
    while min(seen.values()) < per_query:
        q = next(stream)
        if seen[q.name] >= per_query:
            continue
        seen[q.name] += 1
        spec = specs[q.name]["answer"]
        ref = importlib.import_module(f"benchmark.reference."
                                      f"{q.name.lower()}")
        want, k = ref.answer(tables, q.params)
        got, _ = ref.answer(tables, q.params, torch.float32)
        got = [{c: float(v) if c in spec["floats"] else v
                for c, v in r.items()} for r in got[:k]]
        why, gap = compare.compare(got, want, k, spec)
        out[q.name]["mismatches"] += why is not None
        if spec["floats"]:
            out[q.name]["rel_err"].append(gap)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    mix = traffic.load("traffic", cell["traffic"])
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else None
    if dev is None:
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(cfg, mix, seed, dev, mix["sample"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
