"""Tensor type (arrow/examples/tensor_builder.rs; counterpart of
examples/tensor_builder.py): dense n-dimensional values alongside the
columnar data, on the device; converts to/from pyarrow.Tensor.

    python examples_torch/tensor_builder.py [--device cuda|cpu]
"""

import argparse

import torch

from arrow_tpu_torch import Tensor
from arrow_tpu_torch.config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    t = Tensor(torch.arange(24, dtype=torch.int32, device=dev)
               .reshape(2, 3, 4), dim_names=("batch", "row", "col"))
    print(t)
    print("shape:", t.shape, "strides:", t.strides,
          "row-major:", t.is_row_major())
    pa_t = t.to_pyarrow()
    back = Tensor.from_pyarrow(pa_t, device=dev)
    print("pyarrow round-trip equal:",
          bool((back.data == t.data).all()))


if __name__ == "__main__":
    main()
