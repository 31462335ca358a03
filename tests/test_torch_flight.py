"""Parity of the port's Flight layer (arrow_tpu_torch/io/flight.py, pb.py)
with the reference's (arrow_tpu/io/flight.py): each test of
tests/test_flight_native.py runs on both packages over the same seeded
numpy inputs, each package against its own server on localhost, and
the tables, flight infos and errors compare.  The wire checks hold the
FlightData bytes of encode_flight_stream to the reference's, and run
each package's client against the other's server."""

import re
import time

import grpc
import numpy as np
import pyarrow as pa
import pyarrow.flight as fl
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.io import flight as rf
from arrow_tpu.io.interop import table_to_pyarrow as ref_to_pa
from arrow_tpu_torch.io import flight as pf
from arrow_tpu_torch.io.interop import table_to_pyarrow as port_to_pa
from torch_port_util import assert_tables_equal, port_table

CPU = torch.device("cpu")


class Kit:
    """One package's Flight classes, with the port's device named."""

    def __init__(self, mod, port: bool):
        self.mod, self.port = mod, port
        self.kw = {"device": "cpu"} if port else {}

    def server(self, location="grpc://0.0.0.0:0", **kw):
        return self.mod.FlightServer(location, **kw, **self.kw)

    def client(self, uri):
        return self.mod.FlightTableClient(uri, **self.kw)


REF, PORT = Kit(rf, False), Kit(pf, True)


def ref_table(n: int = 500, seed: int = 0):
    rng = np.random.default_rng(seed)
    return at.Table.from_pydict({
        "a": rng.integers(-1000, 1000, n),
        "b": rng.standard_normal(n),
        "s": [f"w{i % 7}" for i in range(n)],
    })


@pytest.fixture()
def tables():
    ref = ref_table()
    return ref, port_table(ref)


def _same_tables(got_port, got_ref):
    assert len(got_port) == len(got_ref)
    for p, r in zip(got_port, got_ref):
        assert_tables_equal(p, r)


# ---- tests/test_flight_native.py, both packages --------------------------

def test_our_client_vs_our_server(tables):
    def run(kit, table):
        srv = kit.server()
        try:
            srv.register("t", table)
            cli = kit.client(srv.uri)
            got = cli.do_get("t")
            flights = cli.list_flights()
            cli.do_put("t2", table)
            put = srv.get_table("t2")
            outs = cli.do_exchange("x", table)
            echo = cli.handshake(b"hello")
            info = cli.get_flight_info(kit.mod.FlightDescriptor.for_path("t"))
            cli.close()
            return got, flights, put, outs, echo, info
        finally:
            srv.shutdown()

    ref, port = tables
    r, p = run(REF, ref), run(PORT, port)
    assert_tables_equal(p[0], r[0])
    assert p[1] == r[1] == ["t"]
    assert_tables_equal(p[2], r[2])
    assert p[2].num_rows == 500
    _same_tables(p[3], r[3])
    assert p[4] == r[4] == b"hello"
    assert p[5].encode() == r[5].encode().replace(
        r[5].endpoints[0][1][0].encode(), p[5].endpoints[0][1][0].encode())
    assert p[5].total_records == r[5].total_records == 500
    for t in (p[0], p[2], *p[3]):
        assert all(c.device == CPU for c in t.columns)


def test_pyarrow_client_reads_our_server(tables):
    def run(kit, table, to_pa):
        srv = kit.server()
        try:
            srv.register("t", table)
            c = fl.connect(srv.uri)
            got = c.do_get(fl.Ticket(b"t")).read_all().combine_chunks()
            info = c.get_flight_info(fl.FlightDescriptor.for_path(b"t"))
            batch = to_pa(table)
            writer, _ = c.do_put(fl.FlightDescriptor.for_path(b"up"),
                                 batch.schema)
            writer.write_batch(batch)
            writer.close()
            time.sleep(0.2)
            up = srv.get_table("up")
            c.close()
            return got, info, up
        finally:
            srv.shutdown()

    ref, port = tables
    rg, ri, ru = run(REF, ref, ref_to_pa)
    pg, pi, pu = run(PORT, port, port_to_pa)
    assert pg.equals(rg)
    assert pg.to_pydict() == port_to_pa(port).to_pydict()
    assert pi.total_records == ri.total_records == 500
    assert [f.name for f in pi.schema] == ["a", "b", "s"]
    assert pi.schema.equals(ri.schema)
    assert_tables_equal(pu, ru)
    assert pu.num_rows == 500


def test_our_client_reads_pyarrow_server(tables):
    ref, port = tables
    batch = ref_to_pa(ref)

    class PaServer(fl.FlightServerBase):
        def do_get(self, context, ticket):
            return fl.RecordBatchStream(pa.Table.from_batches([batch]))

        def do_put(self, context, descriptor, reader, writer):
            self.received = reader.read_all().combine_chunks()

        def list_flights(self, context, criteria):
            desc = fl.FlightDescriptor.for_path(b"t")
            yield fl.FlightInfo(batch.schema, desc,
                                [fl.FlightEndpoint(b"t", [])], 500, -1)

    srv = PaServer("grpc://localhost:0")
    try:
        out = {}
        for kit, table in ((REF, ref), (PORT, port)):
            cli = kit.client(f"grpc://localhost:{srv.port}")
            got = cli.do_get("t")
            assert cli.list_flights() == ["t"]
            cli.do_put("up", table)
            out[kit.port] = (got, srv.received)
            cli.close()
        assert_tables_equal(out[True][0], out[False][0])
        assert out[True][1].equals(out[False][1])
        assert out[True][1].to_pydict() == batch.to_pydict()
    finally:
        srv.shutdown()


def test_dictionary_over_flight(tables):
    from arrow_tpu.ops.strings import dictionary_encode
    ref, _ = tables
    d = dictionary_encode(ref.column("s"))
    ref2 = ref.set_column(2, at.dtypes.Field("s", d.dtype), d)
    port2 = port_table(ref2)
    out = {}
    for kit, table in ((REF, ref2), (PORT, port2)):
        srv = kit.server()
        try:
            srv.register("d", table)
            c = fl.connect(srv.uri)
            by_pa = c.do_get(fl.Ticket(b"d")).read_all()
            c.close()
            cli = kit.client(srv.uri)
            out[kit.port] = (by_pa, cli.do_get("d"))
            cli.close()
        finally:
            srv.shutdown()
    assert out[True][0].equals(out[False][0])
    assert out[True][0].column("s").to_pylist() == \
        ref.column("s").to_pylist()
    assert_tables_equal(out[True][1], out[False][1])


def test_large_stream_splits():
    n = 1_000_000
    ref = at.Table.from_pydict({"x": np.arange(n, dtype=np.int64),
                                "y": np.arange(n, dtype=np.float64)})
    out = {}
    for kit, table in ((REF, ref), (PORT, port_table(ref))):
        srv = kit.server()
        try:
            srv.register("big", table)
            cli = kit.client(srv.uri)
            out[kit.port] = cli.do_get_stream("big")
            cli.close()
        finally:
            srv.shutdown()
    assert len(out[True]) > 1
    assert sum(p.num_rows for p in out[True]) == n
    _same_tables(out[True], out[False])


def test_no_pyarrow_imports_in_wire_modules():
    import importlib
    for name in ("flight", "ipc", "ipc_format", "parquet_native",
                 "parquet_writer", "csv", "json_io", "avro", "thrift",
                 "fb", "pb", "flightsql"):
        mod = importlib.import_module(f"arrow_tpu_torch.io.{name}")
        src = open(mod.__file__).read()
        assert not re.search(r"^\s*(import pyarrow|from pyarrow)", src,
                             re.M), mod.__name__


@pytest.mark.parametrize("counts", [(0, 0), (-1, -1), (500, 12345)])
def test_flightinfo_zero_counts_roundtrip(counts):
    out = []
    for kit in (REF, PORT):
        m = kit.mod
        info = m.FlightInfo(b"s", m.FlightDescriptor.for_path("p"),
                            [(b"t", ["grpc://h:1"])], *counts)
        raw = info.encode()
        back = m.FlightInfo.decode(raw)
        assert (back.total_records, back.total_bytes) == counts
        assert back.endpoints == [(b"t", ["grpc://h:1"])]
        out.append(raw)
    assert out[0] == out[1]


def test_producer_schema_and_empty_stream():
    out = {}
    for kit, mk in ((REF, at), (PORT, att)):
        srv = kit.server()
        try:
            schema = mk.Schema((mk.Field("x", mk.int64),))
            srv.register_producer("empty", lambda: iter(()), schema=schema)
            cli = kit.client(srv.uri)
            info = cli.get_flight_info(
                kit.mod.FlightDescriptor.for_path("empty"))
            raw = info.schema_bytes
            if raw[:4] == b"\xff\xff\xff\xff":
                raw = raw[8:]
            from arrow_tpu_torch.io import ipc_format as fmt
            got_schema, _ = fmt.read_schema(raw)
            assert [f.name for f in got_schema.fields] == ["x"]
            tables = cli.do_get_stream("empty")
            assert tables == [] or sum(t.num_rows for t in tables) == 0
            out[kit.port] = (info.schema_bytes, len(tables))
            cli.close()
        finally:
            srv.shutdown()
    assert out[True] == out[False]


@pytest.mark.parametrize("cut", [1, 3, 5])
def test_truncated_protobuf_raises(cut):
    from arrow_tpu.errors import ArrowInvalid as RefInvalid
    from arrow_tpu.io import pb as rpb
    from arrow_tpu_torch.errors import ArrowInvalid
    from arrow_tpu_torch.io import pb
    msg = pb.field(1, b"hello")
    assert msg == rpb.field(1, b"hello")
    with pytest.raises(RefInvalid):
        rpb.parse_fields(msg[:-cut])
    with pytest.raises(ArrowInvalid):
        pb.parse_fields(msg[:-cut])


def test_flight_basic_auth_roundtrip_and_rejection():
    out = {}
    for kit, mk in ((REF, at), (PORT, att)):
        auth = kit.mod.BasicAuthHandler({"alice": "secret"})
        srv = kit.server("grpc://127.0.0.1:0", auth_handler=auth)
        srv.register("t", mk.Table.from_pydict(
            {"x": np.arange(4)}, **kit.kw))
        try:
            anon = kit.client(srv.uri)
            with pytest.raises(kit.mod.FlightError) as ei:
                anon.do_get("t")
            assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
            assert ei.value.trailers.get("x-arrow-error-class") == \
                "FlightUnauthenticated"
            anon.close()
            bad = kit.client(srv.uri)
            with pytest.raises(kit.mod.FlightError) as ei:
                bad.authenticate_basic_token("alice", "wrong")
            assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
            bad.close()
            cli = kit.client(srv.uri)
            token = cli.authenticate_basic_token("alice", "secret")
            assert token and auth.peer_identity(token.decode()) == "alice"
            out[kit.port] = cli.do_get("t")
            cli.close()
        finally:
            srv.shutdown()
    assert out[True].num_rows == 4
    assert_tables_equal(out[True], out[False])


def test_flight_middleware_headers_and_rejection():
    out = {}
    for kit, mk in ((REF, at), (PORT, att)):
        seen = []

        class Recorder:
            def start_call(self, method, metadata):
                seen.append((method, metadata.get("x-tenant")))
                return {"x-served-by": "arrow-tpu"}

        class TenantGate:
            def start_call(self, method, metadata, kit=kit):
                if method != "Handshake" and \
                        metadata.get("x-tenant") != "good":
                    raise kit.mod.FlightUnauthenticated("unknown tenant")

        srv = kit.server("grpc://127.0.0.1:0",
                         middleware=(Recorder(), TenantGate()))
        srv.register("t", mk.Table.from_pydict(
            {"x": np.arange(3)}, **kit.kw))
        try:
            cli = kit.client(srv.uri)
            with pytest.raises(kit.mod.FlightError) as ei:
                cli.do_get("t")
            assert ei.value.code == grpc.StatusCode.UNAUTHENTICATED
            cli.add_header("x-tenant", "good")
            out[kit.port] = cli.do_get("t")
            assert ("DoGet", "good") in seen
            cli.close()
        finally:
            srv.shutdown()
    assert out[True].num_rows == 3
    assert_tables_equal(out[True], out[False])


# ---- the wire: FlightData bytes and the two packages across ----------------

def _dict_table(n: int, seed: int = 1):
    """The reference's table with a dictionary column, nulls and a
    second string column."""
    from arrow_tpu.ops.strings import dictionary_encode
    rng = np.random.default_rng(seed)
    words = np.array([f"word-{i}" for i in range(37)])
    s = at.column([None if i % 11 == 0 else str(w) for i, w in
                   enumerate(words[rng.integers(0, 37, n)])])
    return at.Table.from_pydict({
        "k": dictionary_encode(s),
        "v": at.column(rng.integers(-10**9, 10**9, n),
                       validity=rng.random(n) > 0.1),
        "f": rng.standard_normal(n),
        "t": [f"row {i}" * (i % 4) for i in range(n)],
    })


def _halves(t):
    """Two slices of one table: one dictionary object under both, sent
    once."""
    return [t.slice(0, 1000), t.slice(1000, 1000)]


WIRE_CASES = {
    "plain": lambda: [ref_table(500)],
    "dictionary": lambda: [_dict_table(1000)],
    "2MB splits": lambda: [_dict_table(300_000)],
    "two tables, one dictionary": lambda: [_dict_table(2000)],
    "empty": lambda: [ref_table(0)],
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_flight_data_bytes_equal_the_reference(case):
    refs = WIRE_CASES[case]()
    ports = [port_table(t) for t in refs]
    if case == "two tables, one dictionary":
        refs, ports = _halves(refs[0]), _halves(ports[0])
    desc_r = rf.FlightDescriptor.for_path("p")
    desc_p = pf.FlightDescriptor.for_path("p")
    want = list(rf.encode_flight_stream(refs, descriptor=desc_r))
    got = list(pf.encode_flight_stream(ports, descriptor=desc_p))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"message {i} of {len(want)} differs"
    if case == "2MB splits":
        assert len(want) > 3
    # and they decode to the same tables on the port's device
    _same_tables(pf.FlightStreamDecoder("cpu").decode_all(got),
                 rf.FlightStreamDecoder().decode_all(want))


def test_encode_copies_each_table_to_the_host_once(monkeypatch):
    calls = []
    real = pf.to_host

    def counted(x, **kw):
        calls.append(x)
        return real(x, **kw)
    monkeypatch.setattr(pf, "to_host", counted)
    t = port_table(_dict_table(300_000))
    msgs = list(pf.encode_flight_stream([t, t.slice(0, 10)]))
    assert len(msgs) > 4 and len(calls) == 2


def test_reference_and_port_across_the_wire(tables):
    ref, port = tables
    rsrv, psrv = REF.server(), PORT.server()
    try:
        rsrv.register("t", ref)
        psrv.register("t", port)
        # the reference's client reads the port's server and writes to it
        rcli = REF.client(psrv.uri)
        assert_tables_equal(port_table(rcli.do_get("t")), ref)
        rcli.do_put("from_ref", ref)
        assert_tables_equal(psrv.get_table("from_ref"), ref)
        assert rcli.list_flights() == ["t", "from_ref"]
        rcli.close()
        # the port's client reads the reference's server and writes to it
        pcli = PORT.client(rsrv.uri)
        got = pcli.do_get("t")
        assert_tables_equal(got, ref)
        assert all(c.device == CPU for c in got.columns)
        pcli.do_put("from_port", port)
        assert_tables_equal(port_table(rsrv.get_table("from_port")), ref)
        _same_tables(pcli.do_exchange("x", port), [ref])
        pcli.close()
    finally:
        rsrv.shutdown()
        psrv.shutdown()


def test_every_table_maker_names_its_device():
    with pytest.raises(TypeError):
        pf.FlightStreamDecoder()
    with pytest.raises(TypeError):
        pf.FlightServer("grpc://127.0.0.1:0")
    with pytest.raises(TypeError):
        pf.FlightTableClient("grpc://127.0.0.1:1")
    with pytest.raises(ValueError):
        pf.FlightStreamDecoder(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pf.FlightStreamDecoder("cuda")


def test_schema_only_put_lands_empty_columns_on_the_device():
    srv = PORT.server()
    try:
        schema = att.Schema((att.Field("x", att.int64),
                             att.Field("s", att.utf8),
                             att.Field("n", att.null)))
        cli = PORT.client(srv.uri)
        stream = pf.encode_flight_stream(
            [], descriptor=pf.FlightDescriptor.for_path("e"), schema=schema)
        list(cli._method("stream_stream", "DoPut")(stream))
        t = srv.get_table("e")
        assert t.num_rows == 0 and t.column_names == ["x", "s", "n"]
        assert all(c.device == CPU for c in t.columns)
        cli.close()
    finally:
        srv.shutdown()
