"""chip_smoke.py's phase 33 rehearsed on the CPU at a few thousand
lineitem rows: a FlightSQL server holding its generator's TPC-H tables,
the five query texts served over localhost gRPC (each equal to
execute_sql's answer and to pyarrow's), orders through DoGet (the
port's client and pyarrow.flight's) and DoPut, concurrent INSERTs, a
prepared statement, a cancel and the CLI.  CPU tensors take the
kernels' plain versions, so the meter's launch counts are zero."""

import pytest
import torch

from test_torch_tpch_sql import CPU, CUSTOMERS, ROWS, PlainMeter
from test_torch_tpch_strings import _chip_smoke


@pytest.fixture(scope="module")
def chip():
    return _chip_smoke()


@pytest.fixture
def served(chip, monkeypatch):
    """The phase's server over the generator's tables, a client, and
    the card's clocks stubbed: (tables, server, client)."""
    from arrow_tpu_torch.io.flightsql import FlightSQLClient, FlightSQLServer
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip, "time_ms", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(chip, "peak_gib", lambda: 0.0)
    tabs, _ = chip.tpch_tables(ROWS, CUSTOMERS, CPU, text=False,
                               pool_bytes=1 << 16, seed=33)
    server = FlightSQLServer("grpc://localhost:0", device=CPU)
    for name, t in tabs.items():
        server.register(name, t)
    client = FlightSQLClient(server.uri, device=CPU)
    yield tabs, server, client
    client.close()
    server.shutdown()


def test_phase33_rehearsal(chip, served, tmp_path):
    tabs, server, client = served
    meter = PlainMeter(chip)
    pat = {k: chip._arrow(tabs[k], cols) for k, cols in chip.P32_NEEDS.items()}
    sites, answers, varied, times = chip.p33_served(client, tabs, CPU, meter,
                                                    pat)
    assert set(answers) == set(times) == {"Q1", "Q3", "Q4", "Q6", "Q10"}
    assert varied == []
    for t in times.values():
        assert set(t) == {"served_host_ms", "direct_host_ms",
                          "direct_cuda_ms"}
    (args, _), = sites["Q6 WHERE"][0]
    assert args[0].dtype == torch.bool and args[0].shape[0] == ROWS
    (args, kwargs), = sites["Q4 group_by"][0]
    assert args[1] == 6 and kwargs["codes_valid"] is None
    rates = chip.p33_transfers(server.uri, server, tabs, CPU)
    assert set(rates) == {"DoGet, the port's client",
                          "DoGet, pyarrow.flight's client",
                          "DoPut, the port's client"}
    assert client.execute_update("DROP TABLE orders_copy") == 0
    chip.p33_dml(client, server.uri, CPU, answers)
    chip.p33_cli(server.uri, CPU, str(tmp_path), answers, rows=3_000,
                 customers=300)


def test_phase33_refuses_a_wrong_served_answer(chip, served, monkeypatch):
    """The served answers are held to execute_sql's: a server whose
    executor drops a row fails the phase."""
    tabs, server, client = served
    real = server._executor
    server._executor = lambda t, q: real(t, q).slice(0, 1) \
        if "GROUP BY o_orderpriority" in q else real(t, q)
    pat = {k: chip._arrow(tabs[k], cols) for k, cols in chip.P32_NEEDS.items()}
    with pytest.raises(AssertionError, match="served Q4"):
        chip.p33_served(client, tabs, CPU, PlainMeter(chip), pat)
