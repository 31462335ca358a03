"""A CPU rehearsal of chip_smoke.py's phase 29 (TPC-H SF10's string
predicates) at 10,000 rows of each table: its generators, every call
and every check it makes on the card (pyarrow.compute over the source
tables, the generator's closed forms, bincount for Q13 and Q22), and
each call of its CPU-route list run on CPU copies of its arguments.
The card's timing, launch counts and kernel sites are not rehearsed:
CPU tensors take the kernels' plain versions."""

import contextlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pyarrow.compute as pac
import torch

from arrow_tpu_torch.io.interop import table_from_pyarrow, table_to_pyarrow

REPO = Path(__file__).resolve().parents[1]
ROWS = {"part": 10_000, "supplier": 10_000, "customer": 10_000,
        "orders": 10_000}


def _chip_smoke():
    """chip_smoke.py as a module (registered, as its dataclasses need)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", REPO / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


class PlainMeter:
    """CardMeter's interface on the CPU: each call run once, untimed;
    the watched calls recorded, no launch counts."""

    def timed(self, name, fn):
        return fn()

    once = timed

    def counted(self, name, must, fn, *watches, exactly=None):
        with contextlib.ExitStack() as stack:
            calls = [stack.enter_context(self.chip.watch(f, m))
                     for f, m in watches]
            out = fn()
        return out, None, calls


def test_phase29_rehearsal():
    chip = _chip_smoke()
    src, truth = chip.tpch_strings(ROWS, 1 << 18, seed=29)
    assert len(chip.P29_COLOURS) == 92
    assert src["orders"].num_rows == ROWS["orders"]
    lens = pac.binary_length(src["orders"]["o_comment"]).to_numpy()
    assert lens.min() >= 19 and lens.max() <= 78
    lens = pac.binary_length(src["supplier"]["s_comment"]).to_numpy()
    assert lens.min() >= 25 and lens.max() <= 100
    keys = src["orders"]["o_custkey"].to_numpy()
    assert (keys % 3 != 0).all() and keys.min() >= 1 \
        and keys.max() <= ROWS["customer"]
    recommends = pac.match_like(src["supplier"]["s_comment"],
                                "%Customer%Recommends%").to_numpy(False)
    assert recommends.sum() == len(truth["complaints"]) == 5
    tabs = {}
    for name, t in src.items():
        tabs[name] = table_from_pyarrow(t, "cpu")
        assert table_to_pyarrow(tabs[name]).equals(
            t.combine_chunks().to_batches()[0])
    meter = PlainMeter()
    meter.chip = chip
    sites, cpu_calls, shares = chip.p29_calls(tabs, src, truth, meter,
                                              ROWS["part"])
    assert set(sites) == {"filter", "run_starts", "dictionary"}
    (args, _), launches = sites["filter"]
    assert launches is None and args[0].dtype == torch.bool
    assert 0 < shares["Q9 contains(p_name, green)"] < 0.2
    assert shares["Q16 like(s_comment, %Customer%Complaints%)"] == 5 / 10_000
    assert 0.9 < shares["Q13 nlike(o_comment)"] < 1.0
    assert len(cpu_calls) == 31
    for name, fn, *args in cpu_calls:
        chip._same_outcome(fn(*args), chip._cpu(fn(*[chip._cpu(a)
                                                      for a in args])), name)


def test_text_pool_follows_the_grammar():
    """Sentences of the spec's word classes, ending in a terminator."""
    chip = _chip_smoke()
    pool = chip.tpch_text_pool(np.random.default_rng(1), 1 << 14).tobytes()
    words = {w for ws, _ in chip.P29_GRAMMAR.values() for w in ws
             for w in w.split()} | {"the"}
    for sentence in pool.decode().split(". ")[1:-1]:
        for token in sentence.replace(",", " ").split():
            assert token.rstrip(";:?!-") in words or token in ("--",), token
