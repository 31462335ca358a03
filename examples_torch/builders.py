"""Building columns value-by-value with the typed builders
(arrow/examples/builders.rs; counterpart of examples/builders.py):
builders accumulate on the host and finish() places one dense tensor
and its validity mask on the device.

    python examples_torch/builders.py [--device cuda|cpu]
"""

import argparse

from arrow_tpu_torch import dtypes as dt
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.core.builders import (ListBuilder, PrimitiveBuilder,
                                           StringBuilder,
                                           StringDictionaryBuilder)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # primitive builder with nulls (append(None) == append_null())
    b = PrimitiveBuilder(dt.int32, dev)
    for v in (1, 2, None, 4):
        b.append(v)
    ints = b.finish()
    print(ints.dtype, ints.to_pylist())

    # strings
    sb = StringBuilder(dev)
    for v in ("alpha", None, "gamma"):
        sb.append(v)
    print(sb.finish().to_pylist())

    # dictionary builder interns repeated values
    db = StringDictionaryBuilder(dev)
    for v in ("lo", "hi", "lo", "lo", "hi"):
        db.append(v)
    d = db.finish()
    print(d.dtype, "->", d.to_pylist())

    # list<int64> builder: fill the child, close each list
    lb = ListBuilder(PrimitiveBuilder(dt.int64, dev))
    lb.append_value([1, 2, 3])
    lb.append_null()
    lb.append_value([])
    print(lb.finish().to_pylist())


if __name__ == "__main__":
    main()
