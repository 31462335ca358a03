"""Error taxonomy mirroring the reference's ArrowError
(arrow-schema/src/error.rs:26-56), adapted to an eager/jit split:

Inside jitted code errors cannot be raised; checked kernels instead thread an
error-flag tensor through the computation.  The eager API layer syncs the
flag and raises the corresponding exception here.
"""

from __future__ import annotations


class ArrowError(Exception):
    """Base of all engine errors."""


class ArrowTypeError(ArrowError):
    """Type mismatch (ArrowError::CastError / InvalidArgumentError)."""


class ArrowInvalid(ArrowError):
    """Invalid argument or malformed data."""


class ArrowNotImplementedError(ArrowError, NotImplementedError):
    """Feature not yet implemented (ArrowError::NotYetImplemented)."""


class ArithmeticOverflow(ArrowError):
    """Checked arithmetic overflowed
    (arrow-schema error::ArrowError::ArithmeticOverflow)."""


class DivideByZero(ArrowError):
    """Integer division by zero (ArrowError::DivideByZeroError)."""


class CastError(ArrowError):
    """Cast failed under CastOptions{safe: false}."""


class ParseError(ArrowError):
    """String parse failure."""


class IoError(ArrowError):
    """I/O failure (ArrowError::IoError)."""


class SchemaError(ArrowError):
    """Schema mismatch (ArrowError::SchemaError)."""


def malformed_guard(what: str):
    """Context manager converting stdlib parse-time errors over
    UNTRUSTED bytes into ArrowInvalid (the reference's parsers return
    ArrowError::ParseError; raw struct.error/KeyError/... must not
    escape a reader entry point)."""
    import contextlib
    import struct as _struct
    import zlib as _zlib

    @contextlib.contextmanager
    def _guard():
        try:
            yield
        except ArrowError:
            raise
        except (ValueError, KeyError, IndexError, TypeError,
                AttributeError, OverflowError, MemoryError, EOFError,
                _struct.error, _zlib.error) as e:
            raise ArrowInvalid(f"malformed {what}: {e!r}") from e

    return _guard()
