"""Tests of the benchmark itself.  They run on the CPU at tiny sizes;
those that need a CUDA card are marked `card` and skip without one (the
fixture decides at run time, never at import):

  python -m pytest benchmark/tests -q -p no:cacheprovider
  python -m pytest benchmark/tests -q -p no:cacheprovider -m card   # on the card
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {"lineitem": 6_000, "customer": 1_500, "supplier": 100}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_config(name: str = "tpch-sf10-embedded", rows=None) -> dict:
    import json
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                     .read_text())
    return dict(cfg, rows=dict(rows or SMALL), text_pool_bytes=1 << 16)


@pytest.fixture
def small_tables(monkeypatch):
    """run.main at tiny sizes on the CPU: the generator's row counts cut."""
    from benchmark import tpch_gen
    real = tpch_gen.make_tables

    def make(cfg, seed, device):
        return real(dict(cfg, rows=dict(SMALL), text_pool_bytes=1 << 16),
                    seed, device)
    monkeypatch.setattr(tpch_gen, "make_tables", make)
