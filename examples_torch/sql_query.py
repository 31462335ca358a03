"""SQL over engine tables on the device (counterpart of
examples/sql_query.py; the application layer the reference leaves to
its users: arrow_tpu_torch/sql.py lowers every clause onto the compute
kernels).

    python examples_torch/sql_query.py [--device cuda|cpu]
"""

import argparse

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.sql import execute_sql
from arrow_tpu_torch.utils.display import pretty_format_table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    orders = att.Table.from_pydict({
        "id": [1, 2, 3, 4, 5, 6],
        "customer": ["ada", "bob", "ada", "cid", "bob", "ada"],
        "amount": [10.0, 20.0, 7.5, 99.0, 3.25, 12.0],
    }, device=dev)
    customers = att.Table.from_pydict({
        "name": ["ada", "bob", "cid"],
        "region": ["eu", "us", "eu"],
    }, device=dev)
    out = execute_sql(
        {"orders": orders, "customers": customers},
        """
        SELECT c.region, SUM(o.amount) AS total, COUNT(*) AS n
        FROM orders o JOIN customers c ON o.customer = c.name
        WHERE o.amount > 5
        GROUP BY c.region
        ORDER BY total DESC
        """)
    print(pretty_format_table(out))


if __name__ == "__main__":
    main()
