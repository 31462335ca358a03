"""CSV into a table on the device, with and without an explicit schema
(arrow/examples/read_csv.rs + read_csv_infer_schema.rs; counterpart of
examples/read_csv.py), then a compute kernel over the result.

    python examples_torch/read_csv.py [--device cuda|cpu]
"""

import argparse
import io

import arrow_tpu_torch as att
from arrow_tpu_torch import dtypes as dt
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io.csv import infer_schema, read_csv
from arrow_tpu_torch.utils.display import pretty_format_table

DATA = """city,lat,lng
Elgin,57.653484,-3.335724
Solihull,52.412811,-1.778197
Cardiff,51.481583,-3.17909
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # explicit schema (read_csv.rs)
    schema = dt.Schema((dt.Field("city", dt.utf8, False),
                        dt.Field("lat", dt.float64, False),
                        dt.Field("lng", dt.float64, False)))
    t = read_csv(io.BytesIO(DATA.encode()), schema=schema, device=dev)
    print(pretty_format_table(t))

    # inferred schema (read_csv_infer_schema.rs)
    inferred = infer_schema(io.BytesIO(DATA.encode()))
    print("inferred:", [(f.name, str(f.dtype)) for f in inferred.fields])

    # a kernel over the parsed columns
    north = att.compute.gt(t.column("lat"), 52.0)
    print("north of 52:", north.to_pylist())


if __name__ == "__main__":
    main()
