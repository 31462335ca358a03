"""End-to-end ETL across the native IO matrix (counterpart of
examples/etl_pipeline.py): CSV in -> SQL transform -> Parquet out ->
native read-back -> Avro out -> read-back.  Every hop is the engine's
own codec (no pyarrow anywhere in this pipeline); the tables live on
the device.

    python examples_torch/etl_pipeline.py [--device cuda|cpu]
"""

import argparse
import io

from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io.avro import read_avro, write_avro
from arrow_tpu_torch.io.csv import read_csv
from arrow_tpu_torch.io.parquet_io import read_parquet, write_parquet
from arrow_tpu_torch.sql import execute_sql
from arrow_tpu_torch.utils.display import pretty_format_table

DATA = """region,product,units,price
east,widget,12,9.99
west,widget,3,9.99
east,gadget,7,24.50
west,gadget,20,24.50
east,widget,5,9.99
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    orders = read_csv(io.BytesIO(DATA.encode()), device=dev)

    report = execute_sql({"orders": orders}, """
        SELECT region,
               count(*)            AS orders,
               sum(units)          AS units,
               sum(units * price)  AS revenue,
               max(product)        AS last_product
        FROM orders
        WHERE units > 2
        GROUP BY region
        ORDER BY region
    """)
    print(pretty_format_table(report))

    pq = io.BytesIO()
    write_parquet(pq, report)
    back = read_parquet(io.BytesIO(pq.getvalue()), device=dev)
    assert back.to_pydict() == report.to_pydict()

    av = io.BytesIO()
    write_avro(av, back, codec="deflate")
    again = read_avro(av.getvalue(), device=dev)
    assert again.column("revenue").to_pylist() == \
        back.column("revenue").to_pylist()
    print("parquet + avro round-trips: OK")
    return report


if __name__ == "__main__":
    main()
