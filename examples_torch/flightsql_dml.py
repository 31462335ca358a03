"""FlightSQL DML end-to-end (counterpart of examples/flightsql_dml.py):
CREATE / bulk-ingest / INSERT / UPDATE / DELETE / prepared statements
with parameters / cancel — the full arrow-flight sql/server.rs DoPut
surface over the engine's own gRPC protocol layer (no pyarrow.flight).
The server's tables and the client's answers live on the device.

    python examples_torch/flightsql_dml.py [--device cuda|cpu]
"""

import argparse

import numpy as np

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io.flightsql import (FlightSQLClient, FlightSQLServer,
                                          TABLE_EXISTS_APPEND)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    srv = FlightSQLServer("grpc://127.0.0.1:0", device=dev)
    cli = FlightSQLClient(srv.uri, device=dev)

    # DDL + literal DML through CommandStatementUpdate
    assert cli.execute_update(
        "CREATE TABLE trades (id BIGINT, px DOUBLE)") == 0
    assert cli.execute_update(
        "INSERT INTO trades VALUES (1, 10.5), (2, 11.25)") == 2
    assert cli.execute_update(
        "UPDATE trades SET px = px * 2 WHERE id = 1") == 1

    # bulk ingest: a Table streams through DoPut CommandStatementIngest
    bulk = att.Table.from_pydict({
        "id": np.arange(10, 1010, dtype=np.int64),
        "px": np.linspace(1.0, 2.0, 1000)}, device=dev)
    assert cli.execute_ingest("trades", bulk,
                              if_exists=TABLE_EXISTS_APPEND) == 1000

    # prepared statement with positional parameters, one exec per row
    h = cli.prepare("INSERT INTO trades VALUES (?, ?)")
    params = att.Table.from_pydict({"p0": [2000, 2001],
                                    "p1": [5.0, 6.0]}, device=dev)
    assert cli.execute_prepared_update(h, params) == 2

    n = cli.execute("SELECT COUNT(*) AS n FROM trades").to_pydict()["n"]
    print("rows now:", n[0])
    assert n == [1004]

    # cancel: get the query handle, cancel it, the ticket is dead
    info = cli.get_query_info("SELECT * FROM trades")
    assert cli.cancel_query(info) == 1      # CANCEL_RESULT_CANCELLED

    assert cli.execute_update("DELETE FROM trades WHERE id >= 10") == 1002
    assert cli.execute_update("DROP TABLE trades") == 0
    cli.close()
    srv.shutdown()
    print("flightsql dml example ok")


if __name__ == "__main__":
    main()
