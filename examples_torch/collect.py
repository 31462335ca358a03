"""Creating columns straight from Python values
(arrow/examples/collect.rs: FromIterator; counterpart of
examples/collect.py): `column` infers or takes an explicit dtype; None
is a null.

    python examples_torch/collect.py [--device cuda|cpu]
"""

import argparse

import arrow_tpu_torch as att
from arrow_tpu_torch import dtypes as dt
from arrow_tpu_torch.config import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    print(att.column([1, 2, 3, 4], dt.int8, device=dev).to_pylist())
    print(att.column([1, 2, None, 3], dt.int8, device=dev).to_pylist())
    print(att.column([1.0, 2.5, None], dt.float32, device=dev).to_pylist())

    # list<int32> from nested Python lists
    lst = att.column([[1, 2], None, [3]], dt.list_(dt.int32), device=dev)
    print(lst.dtype, lst.to_pylist())


if __name__ == "__main__":
    main()
