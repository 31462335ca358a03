"""Nested struct data + runtime type dispatch
(arrow/examples/dynamic_types.rs; counterpart of
examples/dynamic_types.py): build a table with a struct column, then
process it by inspecting dtypes dynamically.

    python examples_torch/dynamic_types.py [--device cuda|cpu]
"""

import argparse

import arrow_tpu_torch as att
from arrow_tpu_torch import dtypes as dt
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.core.column import StructColumn
from arrow_tpu_torch.core.table import Table
from arrow_tpu_torch.utils.display import pretty_format_table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    ids = att.column([1, 2, 3, 4, 5], dt.int32, device=dev)
    nested = StructColumn(
        (att.column(["a", "b", "c", "d", "e"], dt.utf8, device=dev),
         att.column([1.1, 2.2, 3.3, 4.4, 5.5], dt.float64, device=dev),
         att.column([2.2, 3.3, 4.4, 5.5, 6.6], dt.float64, device=dev)),
        (dt.Field("a", dt.utf8, False),
         dt.Field("b", dt.float64, False),
         dt.Field("c", dt.float64, False)))
    t = Table((ids, nested),
              dt.Schema((dt.Field("id", dt.int32, False),
                         dt.Field("nested", nested.dtype, False))))
    print(pretty_format_table(t))

    # dynamic dispatch: walk the schema, process by dtype name
    for field, col in zip(t.schema.fields, t.columns):
        if field.dtype.name == "struct":
            b, c = col.children[1], col.children[2]
            product = att.compute.mul(b, c)
            print(f"{field.name}.b * {field.name}.c =",
                  product.to_pylist())


if __name__ == "__main__":
    main()
