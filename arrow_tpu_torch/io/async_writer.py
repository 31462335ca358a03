"""Async parquet writer + object-store sink (counterpart of
arrow_tpu/io/async_writer.py, host code copied whole; the
parquet/src/arrow/async_writer/mod.rs role: AsyncArrowWriter buffering
encoded bytes and shipping them to an AsyncFileWriter /
ParquetObjectWriter multipart upload while encoding continues).

The engine's form: `AsyncParquetWriter` encodes synchronously through
`NativeParquetWriter` (which copies each row group of a device table
to the host once) into an in-memory staging buffer; whenever the
staging buffer passes `buffer_size`, the accumulated bytes ship to the
sink's `put_part` on ONE background uploader thread — encode of row
group N+1 overlaps the upload of row group N.  `close()` drains the
queue and `complete()`s the sink (the multipart-commit step).

Sinks implement the ObjectStoreSink protocol: `put_part(bytes)` in
order, then `complete()` (or `abort()` on error) — the object_store
multipart contract the reference's ParquetObjectWriter drives.
"""

from __future__ import annotations

import io
import queue
import threading
from typing import Optional

from ..core.table import Table
from ..errors import ArrowInvalid

__all__ = ["ObjectStoreSink", "FileSink", "MemorySink",
           "AsyncParquetWriter"]


class ObjectStoreSink:
    """Ordered multipart sink (object_store WriteMultipart contract)."""

    def put_part(self, data: bytes) -> None:
        raise NotImplementedError

    def complete(self) -> None:
        pass

    def abort(self) -> None:
        pass


class FileSink(ObjectStoreSink):
    """Local-file sink: parts append in order; complete() fsyncs."""

    def __init__(self, path):
        self._f = open(path, "wb")

    def put_part(self, data: bytes) -> None:
        self._f.write(data)

    def complete(self) -> None:
        self._f.flush()
        import os
        os.fsync(self._f.fileno())
        self._f.close()

    def abort(self) -> None:
        try:
            self._f.close()
        except Exception:              # noqa: BLE001
            pass


class MemorySink(ObjectStoreSink):
    """Collects parts in memory (tests / small outputs)."""

    def __init__(self):
        self.parts = []
        self.completed = False

    def put_part(self, data: bytes) -> None:
        self.parts.append(bytes(data))

    def complete(self) -> None:
        self.completed = True

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _StagingBuffer(io.RawIOBase):
    """File-like staging area the NativeParquetWriter writes into;
    `drain()` takes everything accumulated so far."""

    def __init__(self):
        self._buf = bytearray()

    def write(self, b) -> int:
        self._buf += b
        return len(b)

    def pending(self) -> int:
        return len(self._buf)

    def drain(self) -> bytes:
        out = bytes(self._buf)
        self._buf.clear()
        return out


class AsyncParquetWriter:
    """AsyncArrowWriter (async_writer/mod.rs:198): encode into a
    staging buffer, ship buffered bytes to the sink on a background
    thread whenever they exceed `buffer_size`, overlap encode with
    upload; close() drains and completes the multipart write."""

    def __init__(self, sink: ObjectStoreSink, schema_table: Table,
                 properties=None, buffer_size: int = 8 << 20):
        from .parquet_io import WriterProperties, ParquetWriter
        self._sink = sink
        self._staging = _StagingBuffer()
        self._buffer_size = buffer_size
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=4)
        self._err: list = []
        self._uploader = threading.Thread(target=self._upload_loop,
                                          daemon=True)
        self._uploader.start()
        self._w = ParquetWriter(self._staging, schema_table,
                                properties or WriterProperties())
        self._closed = False

    def _upload_loop(self):
        # After a put_part failure the loop KEEPS DRAINING (discarding
        # parts) rather than exiting: with the bounded queue full, an
        # exited uploader would deadlock the producer's blocking put
        # forever instead of letting _ship_pending surface self._err.
        failed = False
        while True:
            part = self._q.get()
            if part is None:
                return
            if failed:
                continue
            try:
                self._sink.put_part(part)
            except Exception as e:     # noqa: BLE001
                self._err.append(e)
                failed = True

    def _ship_pending(self, force: bool = False):
        if self._err:
            # terminal: stop the uploader, abort the multipart write,
            # and surface the sink error to the caller
            if not self._closed:
                self._closed = True
                self._q.put(None)
                self._uploader.join()
                self._sink.abort()
            raise ArrowInvalid(f"sink upload failed: {self._err[0]}")
        if force or self._staging.pending() >= self._buffer_size:
            part = self._staging.drain()
            if part:
                self._q.put(part)

    def write(self, table: Table) -> None:
        if self._closed:
            raise ArrowInvalid("writer already closed")
        self._w.write(table)
        self._ship_pending()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._w.close()
            self._ship_pending(force=True)
        except Exception:
            self._q.put(None)
            self._uploader.join()
            self._sink.abort()
            raise
        self._q.put(None)
        self._uploader.join()
        if self._err:
            self._sink.abort()
            raise ArrowInvalid(f"sink upload failed: {self._err[0]}")
        self._sink.complete()
