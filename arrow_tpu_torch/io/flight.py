"""Flight RPC ingress/egress — own gRPC protocol layer (no pyarrow);
counterpart of arrow_tpu/io/flight.py.

Flight is the engine's HOST boundary: hand-rolled protobuf for
format/Flight.proto messages (io/pb.py), grpcio generic handlers for
the FlightService methods, and the engine's own native IPC encoder for
payloads.  The FlightData bytes equal the reference's for the same
table.

Reference behaviors re-designed:
  service surface    arrow-flight/src/arrow.flight.protocol.rs:861-992
                     (handshake/list_flights/get_flight_info/get_schema/
                      do_get/do_put/do_exchange/do_action/list_actions)
  stream encode      arrow-flight/src/encode.rs:269 (FlightDataEncoder,
                     ~2MB batch splitting at encode.rs:148)
  stream decode      arrow-flight/src/decode.rs:83 (FlightRecordBatchStream)

Devices: every class that makes tables names the device they land on
(`FlightStreamDecoder(device)`, `FlightServer(..., device=)`,
`FlightTableClient(uri, device=)`; no default).  Encoding copies each
table to the host once (hostio.to_host) and splits and encodes from
host memory, so a table on the card costs one device-to-host copy per
buffer, not one per ~2MB piece.  The server's handlers run on gRPC
worker threads under the server's device.

Interops with pyarrow.flight peers and with the reference (tested both
directions).
"""

from __future__ import annotations

import contextlib
import struct
import threading
from concurrent import futures
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import grpc
import torch

from ..config import DeviceLike, resolve_device
from ..core.column import Column
from ..core.table import Table
from ..errors import ArrowInvalid
from .. import dtypes as dt
from . import ipc_format as fmt
from .hostio import to_host
from ..utils import trace
from .ipc import _table_dict_columns
from . import pb

__all__ = ["FlightServer", "FlightTableClient", "MAX_FLIGHT_DATA_SIZE",
           "FlightDescriptor", "FlightInfo", "BasicAuthHandler",
           "FlightUnauthenticated", "FlightError"]

MAX_FLIGHT_DATA_SIZE = 2 * 1024 * 1024  # encode.rs:148 default target

_SVC = "/arrow.flight.protocol.FlightService/"
_GRPC_OPTS = [("grpc.max_receive_message_length", 64 * 1024 * 1024),
              ("grpc.max_send_message_length", 64 * 1024 * 1024)]

DESCRIPTOR_UNKNOWN, DESCRIPTOR_PATH, DESCRIPTOR_CMD = 0, 1, 2


# ---------------------------------------------------------------------------
# Flight.proto messages
# ---------------------------------------------------------------------------

class FlightDescriptor:
    __slots__ = ("type", "cmd", "path")

    def __init__(self, dtype: int = DESCRIPTOR_UNKNOWN,
                 cmd: bytes = b"", path: Tuple[str, ...] = ()):
        self.type = dtype
        self.cmd = cmd
        self.path = tuple(path)

    @classmethod
    def for_path(cls, *path: str) -> "FlightDescriptor":
        return cls(DESCRIPTOR_PATH, b"", path)

    @classmethod
    def for_command(cls, cmd: bytes) -> "FlightDescriptor":
        return cls(DESCRIPTOR_CMD, cmd, ())

    def encode(self) -> bytes:
        out = pb.varint_field(1, self.type)
        if self.cmd:
            out += pb.field(2, self.cmd)
        for p in self.path:
            out += pb.field(3, p)
        return out

    @classmethod
    def decode(cls, raw: bytes) -> "FlightDescriptor":
        f = pb.parse_fields(raw)
        return cls(pb.first(f, 1, 0), pb.first_bytes(f, 2),
                   tuple(v.decode() for v in f.get(3, [])))


class FlightInfo:
    __slots__ = ("schema_bytes", "descriptor", "endpoints",
                 "total_records", "total_bytes")

    def __init__(self, schema_bytes: bytes, descriptor: FlightDescriptor,
                 endpoints, total_records: int = -1,
                 total_bytes: int = -1):
        self.schema_bytes = schema_bytes
        self.descriptor = descriptor
        self.endpoints = list(endpoints)   # [(ticket_bytes, [uri, ...])]
        self.total_records = total_records
        self.total_bytes = total_bytes

    def encode(self) -> bytes:
        out = pb.field(1, self.schema_bytes)
        out += pb.field(2, self.descriptor.encode())
        for ticket, locs in self.endpoints:
            ep = pb.field(1, pb.field(1, ticket))
            for uri in locs:
                ep += pb.field(2, pb.field(1, uri))
            out += pb.field(3, ep)
        out += pb.varint_field(4, self.total_records)
        out += pb.varint_field(5, self.total_bytes)
        return out

    @classmethod
    def decode(cls, raw: bytes) -> "FlightInfo":
        f = pb.parse_fields(raw)
        eps = []
        for ep_raw in f.get(3, []):
            ef = pb.parse_fields(ep_raw)
            ticket = pb.parse_fields(pb.first_bytes(ef, 1)).get(1, [b""])[0]
            locs = [pb.first_str(pb.parse_fields(l), 1)
                    for l in ef.get(2, [])]
            eps.append((ticket, locs))
        # proto3: a missing int64 field IS zero (varint_field omits
        # zeros on encode), so known-empty round-trips as 0; unknown is
        # the explicit -1 arrow-flight convention
        tr = pb.first(f, 4, 0)
        tb = pb.first(f, 5, 0)
        # int64 two's complement
        if tr >= 1 << 63:
            tr -= 1 << 64
        if tb >= 1 << 63:
            tb -= 1 << 64
        return cls(pb.first_bytes(f, 1),
                   FlightDescriptor.decode(pb.first_bytes(f, 2)),
                   eps, tr, tb)


def _flight_data(data_header: bytes = b"", data_body: bytes = b"",
                 descriptor: Optional[FlightDescriptor] = None,
                 app_metadata: bytes = b"") -> bytes:
    out = b""
    if descriptor is not None:
        out += pb.field(1, descriptor.encode())
    if data_header:
        out += pb.field(2, data_header)
    if app_metadata:
        out += pb.field(3, app_metadata)
    if data_body:
        out += pb.field(1000, data_body)
    return out


def _parse_flight_data(raw: bytes):
    f = pb.parse_fields(raw)
    desc_raw = pb.first(f, 1)
    return (FlightDescriptor.decode(desc_raw)
            if desc_raw is not None else None,
            pb.first_bytes(f, 2), pb.first_bytes(f, 3),
            pb.first_bytes(f, 1000))


# ---------------------------------------------------------------------------
# Table <-> FlightData streams (encode.rs:269 / decode.rs:83 roles)
# ---------------------------------------------------------------------------

def schema_ipc_bytes(schema: dt.Schema) -> bytes:
    """Encapsulated IPC schema message (SchemaAsIpc role)."""
    from .ipc import _frame
    return _frame(fmt.write_schema_message(schema))


def _strip_framing(header: bytes) -> bytes:
    """data_header may arrive bare or with encapsulation framing."""
    if len(header) >= 8:
        cont, ln = struct.unpack_from("<Ii", header, 0)
        if cont == 0xFFFFFFFF:
            return header[8:8 + ln]
    return header


def _split_tables(table: Table) -> List[Table]:
    """Split near MAX_FLIGHT_DATA_SIZE (FlightDataEncoder encode.rs:148).

    Sizing excludes dictionary VALUES bytes: the dictionary batch is
    deduped by identity and sent once regardless of how many record
    batches follow, so a big dictionary must not shred small codes."""
    from ..core.pool import column_memory_size, table_memory_size
    nbytes = table_memory_size(table)
    for dc in _table_dict_columns(table):
        nbytes -= column_memory_size(dc.values)
    if nbytes <= MAX_FLIGHT_DATA_SIZE or table.num_rows <= 1:
        return [table]
    rows_per = max(int(table.num_rows * MAX_FLIGHT_DATA_SIZE / nbytes), 1)
    return [table.slice(i, min(rows_per, table.num_rows - i))
            for i in range(0, table.num_rows, rows_per)]


def encode_flight_stream(tables, descriptor: Optional[FlightDescriptor]
                         = None, schema: Optional[dt.Schema] = None
                         ) -> Iterator[bytes]:
    """tables (list OR lazy iterator) -> FlightData protobuf messages
    (schema, dictionaries, record batches; ~2MB splits).  Streaming:
    each input table is encoded and yielded before the next is pulled.
    `schema` lets an EMPTY stream still emit its schema message (a
    Flight stream must start with one).  Each table comes to the host
    once, each buffer a `readback` of site `flight.encode`; its pieces
    are cut and encoded there.  The whole stream is one `flight.encode`
    span (`rows`, `messages`, `bytes` sent)."""
    if isinstance(tables, Table):
        tables = [tables]
    with trace.span("flight.encode") as s:
        sent = {"rows": 0, "messages": 0, "bytes": 0}
        for msg in _encode_stream(iter(tables), descriptor, schema, sent):
            yield msg
        if s is not None:
            s.attrs.update(sent)


def _encode_stream(it, descriptor, schema, sent: dict) -> Iterator[bytes]:
    """encode_flight_stream's messages, counted into `sent`."""
    first = None
    if schema is None:
        first = next(it, None)
        if first is None:
            return
        schema = first.schema

    def message(meta, body=b"", desc=None):
        out = _flight_data(meta, body, desc)
        sent["messages"] += 1
        sent["bytes"] += len(out)
        return out

    yield message(fmt.write_schema_message(schema), desc=descriptor)

    def _stream():
        if first is not None:
            yield first
        yield from it

    # dict id -> the caller's values object last sent (held, so the id
    # stays pinned); identity is the caller's, not the host copy's,
    # which is made anew for each table
    written: Dict[int, Column] = {}
    for t in _stream():
        sent_as = [c.values for c in _table_dict_columns(t)]
        sent["rows"] += t.num_rows
        for part in _split_tables(to_host(t, site="flight.encode")):
            # innermost dictionaries first (reversed preorder) so nested
            # dictionary values decode before their parents
            for dict_id, col in reversed(
                    list(enumerate(_table_dict_columns(part)))):
                if written.get(dict_id) is sent_as[dict_id]:
                    continue
                yield message(*fmt.encode_dictionary_batch(dict_id,
                                                           col.values))
                written[dict_id] = sent_as[dict_id]
            yield message(*fmt.encode_record_batch(part))


class FlightStreamDecoder:
    """FlightData messages -> Tables on `device`
    (FlightRecordBatchStream role): each record batch's buffers are
    placed on the device once, as they are decoded."""

    def __init__(self, device: DeviceLike):
        self.device = resolve_device(device)
        self.schema: Optional[dt.Schema] = None
        self.descriptor: Optional[FlightDescriptor] = None
        self._dict_fields: Dict[int, dt.Field] = {}
        self._dict_ids: List[Tuple[int, dt.Field]] = []
        self._dict_id_of: Dict[int, int] = {}
        self._dicts: Dict[int, Column] = {}

    def feed(self, raw: bytes) -> Optional[Table]:
        desc, header, _, body = _parse_flight_data(raw)
        if desc is not None and self.descriptor is None:
            self.descriptor = desc
        header = _strip_framing(header)
        if not header:
            return None
        tag, msg, _ = fmt.parse_message(header)
        if tag == fmt.H_SCHEMA:
            schema, dict_ids = fmt.read_schema(header)
            self.schema = schema
            self._dict_ids = dict_ids
            self._dict_fields = {i: f for i, f in dict_ids}
            self._dict_id_of = fmt.walk_dict_ids(dict_ids)
            return None
        if tag == fmt.H_DICTIONARY_BATCH:
            fmt.decode_dictionary_batch(header, body, self._dict_fields,
                                        self._dicts, self._dict_ids,
                                        device=self.device)
            return None
        if tag == fmt.H_RECORD_BATCH:
            if self.schema is None:
                raise ArrowInvalid("record batch before schema")
            return fmt.decode_record_batch(self.schema, header, body,
                                           self._dicts, self._dict_id_of,
                                           self.device)
        raise ArrowInvalid(f"unexpected Flight message tag {tag}")

    def decode_all(self, raws) -> List[Table]:
        out = []
        for raw in raws:
            t = self.feed(raw)
            if t is not None:
                out.append(t)
        return out


def _concat(tables: List[Table]) -> Table:
    if len(tables) == 1:
        return tables[0]
    from ..ops.concat import concat_tables
    return concat_tables(tables)


def _empty_table(schema: dt.Schema, device: torch.device) -> Table:
    """A table of `schema` with no rows on `device`."""
    from ..core.column import NullColumn
    from .integration_json import _empty_col
    return Table(tuple(NullColumn(0, device) if f.dtype.is_null
                       else _empty_col(f.dtype, device)
                       for f in schema.fields), schema)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class FlightUnauthenticated(Exception):
    """Raised by auth handlers / middleware to reject a call."""


class FlightError(Exception):
    """Client-side RPC failure carrying the server's error trailers
    (client.rs FlightError::Tonic keeps the Status metadata)."""

    def __init__(self, message: str, code=None, trailers=()):
        super().__init__(message)
        self.code = code
        self.trailers = dict(trailers)


class BasicAuthHandler:
    """Username/password handshake -> bearer token
    (the reference's auth scenario: BasicAuth in HandshakeRequest,
    token in HandshakeResponse, `authorization: Bearer <t>` after;
    arrow-flight/src/client.rs:139 handshake contract)."""

    def __init__(self, users: Dict[str, str]):
        self._users = dict(users)
        self._tokens: Dict[str, str] = {}

    def authenticate(self, username: str, password: str) -> str:
        if self._users.get(username) != password:
            raise FlightUnauthenticated("invalid username/password")
        import uuid as _uuid
        token = _uuid.uuid4().hex
        self._tokens[token] = username
        return token

    def is_valid(self, token: str) -> bool:
        return token in self._tokens

    def peer_identity(self, token: str) -> Optional[str]:
        return self._tokens.get(token)


class FlightServer:
    """FlightService over grpcio generic handlers (the
    arrow.flight.protocol.rs:861 service surface, hand-rolled).

    Tables that `do_put` receives land on `device`, and every handler
    runs under it (`_device_scope`).  `auth_handler` gates every RPC but
    Handshake behind a bearer token issued by the handshake;
    `middleware` is a list of objects with `start_call(method, metadata)
    -> optional response-header dict` (may raise FlightUnauthenticated)
    — the reference's server middleware hook
    (arrow-integration-testing flight_server_scenarios middleware.rs)."""

    def __init__(self, location: str = "grpc://0.0.0.0:0", *,
                 device: DeviceLike,
                 exchange_fn: Optional[Callable[[Table], Table]] = None,
                 auth_handler: Optional[BasicAuthHandler] = None,
                 middleware=()):
        self.device = resolve_device(device)
        self._tables: Dict[str, Table] = {}
        self._producers: Dict[str, Callable[[], Iterator[Table]]] = {}
        self._exchange_fn = exchange_fn or (lambda t: t)
        self._auth_handler = auth_handler
        self._middleware = tuple(middleware)
        self._lock = threading.Lock()
        host_port = location.split("://", 1)[-1]
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=_GRPC_OPTS)
        self._server.add_generic_rpc_handlers([_Handlers(self)])
        self.port = self._server.add_insecure_port(host_port)
        self._server.start()

    @property
    def uri(self) -> str:
        return f"grpc://localhost:{self.port}"

    @property
    def put_device(self) -> torch.device:
        """Where a DoPut stream's tables are decoded (the server's
        device; io/flightsql.py decodes on the host)."""
        return self.device

    def shutdown(self) -> None:
        self._server.stop(grace=None)

    # FlightServerBase-compat aliases
    def serve(self):
        self._server.wait_for_termination()

    def _device_scope(self):
        """The server's device as the current one on a handler's worker
        thread.  Concurrent handlers on one card are safe: every thread
        issues its kernels on the device's default stream, so they run
        in issue order, and the caching allocator reuses a freed block
        only after that stream's earlier work."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- registration ---------------------------------------------------------
    def register(self, name: str, table: Table) -> None:
        with self._lock:
            self._tables[name] = table

    def register_producer(self, name: str,
                          producer: Callable[[], Iterator[Table]],
                          schema: Optional[dt.Schema] = None) -> None:
        """`schema` lets get_flight_info/get_schema advertise the
        stream's real schema (and lets an empty stream stay decodable)
        without draining the producer."""
        with self._lock:
            self._producers[name] = (producer, schema)

    def get_table(self, name: str) -> Table:
        with self._lock:
            return self._tables[name]

    # -- auth / middleware ------------------------------------------------
    def _before_call(self, method: str, context) -> None:
        """Runs middleware and enforces bearer auth; aborts the RPC on
        rejection (error class recorded in the trailers)."""
        meta = {k: v for k, v in context.invocation_metadata()}
        hdrs: Dict[str, str] = {}
        try:
            for mw in self._middleware:
                extra = mw.start_call(method, meta)
                if extra:
                    hdrs.update(extra)
        except FlightUnauthenticated as e:
            context.set_trailing_metadata(
                (("x-arrow-error-class", "FlightUnauthenticated"),))
            context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
        if hdrs:
            context.send_initial_metadata(tuple(hdrs.items()))
        if self._auth_handler is not None and method != "Handshake":
            auth = meta.get("authorization", "")
            token = auth[7:] if auth.startswith("Bearer ") else ""
            if not token or not self._auth_handler.is_valid(token):
                context.set_trailing_metadata(
                    (("x-arrow-error-class", "FlightUnauthenticated"),))
                context.abort(grpc.StatusCode.UNAUTHENTICATED,
                              "invalid bearer token")

    # -- handler hooks (overridable; flightsql.py overrides these) -----------
    def handshake(self, payloads: Iterator[bytes]) -> Iterator[bytes]:
        if self._auth_handler is None:
            for p in payloads:
                yield p               # echo
            return
        for p in payloads:
            # payload is a Flight BasicAuth{username=2, password=3}
            f = pb.parse_fields(p)
            user = pb.first_bytes(f, 2).decode()
            pw = pb.first_bytes(f, 3).decode()
            token = self._auth_handler.authenticate(user, pw)
            yield token.encode()

    def list_flights(self) -> Iterator[FlightInfo]:
        with self._lock:
            names = list(self._tables) + list(self._producers)
        for name in names:
            yield self.get_flight_info(FlightDescriptor.for_path(name))

    def schema_for(self, name: str) -> Optional[dt.Schema]:
        with self._lock:
            t = self._tables.get(name)
            prod = self._producers.get(name)
        if t is not None:
            return t.schema
        if prod is not None and prod[1] is not None:
            return prod[1]
        return None

    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        name = descriptor.path[0] if descriptor.path else ""
        if isinstance(name, bytes):
            name = name.decode()
        with self._lock:
            t = self._tables.get(name)
        schema = self.schema_for(name) or dt.Schema(())
        return FlightInfo(schema_ipc_bytes(schema), descriptor,
                          [(name.encode(), [self.uri])],
                          t.num_rows if t is not None else -1, -1)

    def get_schema(self, descriptor: FlightDescriptor) -> bytes:
        return self.get_flight_info(descriptor).schema_bytes

    def do_get(self, ticket: bytes) -> Iterator[Table]:
        name = ticket.decode()
        with self._lock:
            producer = self._producers.get(name)
            table = self._tables.get(name)
        if producer is not None:
            yield from producer[0]()
            return
        if table is None:
            raise KeyError(f"unknown ticket {name!r}")
        yield table

    def do_put(self, descriptor: Optional[FlightDescriptor],
               tables: List[Table],
               schema: Optional[dt.Schema] = None) -> None:
        if descriptor is None or not descriptor.path:
            raise ArrowInvalid(
                "do_put needs a path descriptor naming the dataset "
                "(command descriptors are for FlightSQL-style services)")
        name = descriptor.path[0]
        if isinstance(name, bytes):
            name = name.decode()
        if not tables:
            # schema-only put: register the empty dataset
            if schema is None:
                raise ArrowInvalid("do_put stream carried no schema")
            self.register(name, _empty_table(schema, self.device))
            return
        self.register(name, _concat(tables))

    def do_action(self, action_type: str, body: bytes) -> Iterator[bytes]:
        raise KeyError(f"unknown action {action_type!r}")

    def list_actions(self) -> List[Tuple[str, str]]:
        return []


class _Handlers(grpc.GenericRpcHandler):
    """Raw-bytes gRPC plumbing for FlightServer."""

    def __init__(self, server: FlightServer):
        self._s = server

    def service(self, details):
        if not details.method.startswith(_SVC):
            return None
        name = details.method[len(_SVC):]
        s = self._s

        def _err(context, e):
            # error class rides the trailers (client.rs keeps Status
            # metadata on FlightError)
            context.set_trailing_metadata(
                (("x-arrow-error-class", type(e).__name__),))
            if isinstance(e, KeyError):
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            elif isinstance(e, ArrowInvalid):
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            elif isinstance(e, FlightUnauthenticated):
                context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            else:
                context.abort(grpc.StatusCode.INTERNAL, repr(e))

        def guarded(fn):
            # middleware + bearer-token gate run before the handler,
            # which runs under the server's device
            def inner(req, context):
                s._before_call(name, context)
                with s._device_scope():
                    return fn(req, context)
            return inner

        def guarded_stream(fn):
            # as guarded, for handlers that yield: the device scope is
            # held while the response stream is drawn
            def inner(req, context):
                s._before_call(name, context)
                with s._device_scope():
                    yield from fn(req, context)
            return inner

        if name == "Handshake":
            def handshake(req_iter, context):
                def payloads():
                    for raw in req_iter:
                        f = pb.parse_fields(raw)
                        yield pb.first_bytes(f, 2)
                try:
                    for p in s.handshake(payloads()):
                        yield pb.field(2, p)
                except FlightUnauthenticated as e:
                    _err(context, e)
            return grpc.stream_stream_rpc_method_handler(
                guarded_stream(handshake))

        if name == "ListFlights":
            def list_flights(raw, context):
                for info in s.list_flights():
                    yield info.encode()
            return grpc.unary_stream_rpc_method_handler(
                guarded_stream(list_flights))

        if name == "GetFlightInfo":
            def get_info(raw, context):
                try:
                    return s.get_flight_info(
                        FlightDescriptor.decode(raw)).encode()
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
            return grpc.unary_unary_rpc_method_handler(guarded(get_info))

        if name == "GetSchema":
            def get_schema(raw, context):
                try:
                    return pb.field(
                        1, s.get_schema(FlightDescriptor.decode(raw)))
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
            return grpc.unary_unary_rpc_method_handler(guarded(get_schema))

        if name == "DoGet":
            def do_get(raw, context):
                f = pb.parse_fields(raw)
                ticket = pb.first_bytes(f, 1)
                try:
                    # STREAMING: each table encodes and ships before
                    # the next is pulled from the producer; an empty
                    # producer stream still gets its schema message
                    try:
                        schema = s.schema_for(ticket.decode())
                    except UnicodeDecodeError:
                        schema = None    # binary (FlightSQL) tickets
                    yield from encode_flight_stream(s.do_get(ticket),
                                                    schema=schema)
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
            return grpc.unary_stream_rpc_method_handler(
                guarded_stream(do_get))

        if name == "DoPut":
            def do_put(req_iter, context):
                dec = FlightStreamDecoder(s.put_device)
                try:
                    tables = dec.decode_all(req_iter)
                    # a do_put hook may RETURN app_metadata bytes (the
                    # FlightSQL DoPutUpdateResult convention) carried on
                    # the PutResult (sql/server.rs:399 DML surface)
                    meta = s.do_put(dec.descriptor, tables,
                                    schema=dec.schema)
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
                    return
                yield pb.field(1, meta) if meta else b""
            return grpc.stream_stream_rpc_method_handler(
                guarded_stream(do_put))

        if name == "DoExchange":
            def do_exchange(req_iter, context):
                dec = FlightStreamDecoder(s.device)

                def results():
                    # ping-pong: each response table encodes as soon as
                    # its input batch lands, not after half-close
                    for raw in req_iter:
                        t = dec.feed(raw)
                        if t is not None:
                            yield s._exchange_fn(t)

                try:
                    yield from encode_flight_stream(results())
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
            return grpc.stream_stream_rpc_method_handler(
                guarded_stream(do_exchange))

        if name == "DoAction":
            def do_action(raw, context):
                f = pb.parse_fields(raw)
                atype = pb.first_str(f, 1)
                body = pb.first_bytes(f, 2)
                try:
                    for result in s.do_action(atype, body):
                        yield pb.field(1, result)
                except KeyError as e:
                    context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                except Exception as e:       # noqa: BLE001
                    _err(context, e)
            return grpc.unary_stream_rpc_method_handler(
                guarded_stream(do_action))

        if name == "ListActions":
            def list_actions(raw, context):
                for atype, desc in s.list_actions():
                    yield pb.field(1, atype) + pb.field(2, desc)
            return grpc.unary_stream_rpc_method_handler(
                guarded_stream(list_actions))

        return None


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def _to_flight_error(e: "grpc.RpcError") -> FlightError:
    trailers = ()
    try:
        trailers = e.trailing_metadata() or ()
    except Exception:        # noqa: BLE001
        pass
    code = None
    try:
        code = e.code()
    except Exception:        # noqa: BLE001
        pass
    details = str(e)
    try:
        details = e.details()
    except Exception:        # noqa: BLE001
        pass
    return FlightError(details, code, trailers)


def _stream_guard(resp):
    """Convert mid-stream RpcError into FlightError w/ trailers."""
    try:
        for item in resp:
            yield item
    except grpc.RpcError as e:
        raise _to_flight_error(e) from None


class FlightTableClient:
    """Mid-level client (arrow-flight/src/client.rs:70): typed tables in
    and out, over our own protobuf/gRPC plumbing; the tables it receives
    land on `device`."""

    def __init__(self, uri: str, *, device: DeviceLike):
        self.device = resolve_device(device)
        host_port = uri.split("://", 1)[-1]
        self._channel = grpc.insecure_channel(host_port,
                                              options=_GRPC_OPTS)
        self._headers: Dict[str, str] = {}

    def add_header(self, key: str, value: str) -> None:
        """Attach a metadata header to every subsequent call
        (client.rs FlightClient::add_header)."""
        self._headers[key.lower()] = value

    def authenticate_basic_token(self, username: str, password: str
                                 ) -> bytes:
        """BasicAuth handshake -> bearer token attached to all later
        calls (client.rs:139 handshake contract)."""
        payload = pb.field(2, username.encode()) \
            + pb.field(3, password.encode())
        token = self.handshake(payload)
        self._headers["authorization"] = "Bearer " + token.decode()
        return token

    def _md(self):
        return tuple(self._headers.items()) or None

    def _method(self, kind: str, name: str):
        fn = getattr(self._channel, kind)
        inner = fn(_SVC + name)
        md = self._md()
        streaming = kind.endswith("_stream")

        def call(request):
            try:
                resp = inner(request, metadata=md)
            except grpc.RpcError as e:
                raise _to_flight_error(e) from None
            return _stream_guard(resp) if streaming else resp
        return call

    def do_get(self, name: str) -> Table:
        return _concat(self.do_get_stream(name))

    def do_get_stream(self, name: str) -> List[Table]:
        return self.do_get_ticket(name.encode())

    def do_get_ticket(self, ticket: bytes) -> List[Table]:
        stream = self._method("unary_stream", "DoGet")(
            pb.field(1, ticket))
        return FlightStreamDecoder(self.device).decode_all(stream)

    def do_put(self, name: str, table: Table) -> None:
        desc = FlightDescriptor.for_path(name)
        # the encoder generator streams: one ~2MB message in flight at
        # a time, never the whole encoded dataset in memory
        results = self._method("stream_stream", "DoPut")(
            encode_flight_stream(table, descriptor=desc))
        list(results)                  # drain PutResults

    def do_put_command(self, cmd: bytes, tables=None,
                       schema: Optional[dt.Schema] = None) -> bytes:
        """do_put with a COMMAND descriptor (the FlightSQL DML shape):
        streams `tables` (or a descriptor-only FlightData when there is
        no payload) and returns the first PutResult's app_metadata —
        where DoPutUpdateResult rides (sql/client.rs execute_update)."""
        desc = FlightDescriptor.for_command(cmd)
        if tables:
            stream = encode_flight_stream(tables, descriptor=desc,
                                          schema=schema)
        elif schema is not None:
            stream = encode_flight_stream([], descriptor=desc,
                                          schema=schema)
        else:
            stream = iter([_flight_data(descriptor=desc)])
        results = list(self._method("stream_stream", "DoPut")(stream))
        if not results:
            return b""
        return pb.first_bytes(pb.parse_fields(results[0]), 1)

    def do_exchange(self, name: str, tables) -> List[Table]:
        desc = FlightDescriptor.for_path(name)
        stream = self._method("stream_stream", "DoExchange")(
            encode_flight_stream(tables, descriptor=desc))
        return FlightStreamDecoder(self.device).decode_all(stream)

    def get_flight_info(self, descriptor: FlightDescriptor) -> FlightInfo:
        raw = self._method("unary_unary", "GetFlightInfo")(
            descriptor.encode())
        return FlightInfo.decode(raw)

    def do_action(self, action_type: str, body: bytes = b""
                  ) -> List[bytes]:
        stream = self._method("unary_stream", "DoAction")(
            pb.field(1, action_type) + (pb.field(2, body) if body
                                        else b""))
        return [pb.first_bytes(pb.parse_fields(r), 1) for r in stream]

    def list_flights(self) -> List[str]:
        stream = self._method("unary_stream", "ListFlights")(b"")
        out = []
        for raw in stream:
            info = FlightInfo.decode(raw)
            if info.descriptor.path:
                out.append(info.descriptor.path[0])
        return out

    def handshake(self, payload: bytes = b"") -> bytes:
        stream = self._method("stream_stream", "Handshake")(
            iter([pb.field(2, payload)]))
        for raw in stream:
            return pb.first_bytes(pb.parse_fields(raw), 2)
        return b""

    def close(self):
        self._channel.close()
