"""Print the arrow_tpu_torch version and device (arrow/examples/
version.rs; counterpart of examples/version.py).

    python examples_torch/version.py [--device cuda|cpu]
"""

import argparse

import torch

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    print("arrow_tpu_torch", att.__version__, "on", dev.type,
          f"({count} device(s))")


if __name__ == "__main__":
    main()
