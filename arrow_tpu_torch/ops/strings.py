"""String compute on every string layout (counterpart of
arrow_tpu/ops/strings.py): dictionary encoding and decoding, string
ranks and comparisons, the predicates (like, ilike, nlike, nilike,
starts_with, ends_with, contains, regexp_is_match), regexp_match,
substring, upper, lower, concat_elements and the length kernels.

A StringColumn (utf8, large_utf8, utf8_view, binary, large_binary or
binary_view) lives on its device (core/column.py).  What inspects the
bytes runs where the reference runs it, on the host, through the native
library (utils/hostcodec.py): the offsets and bytes are copied to the
host once per call (no copy when they are already there), one native
pass makes the mask or the new buffers, and those go back to the
column's device beside the column's own validity.  A dictionary makes
that pass over its distinct values and gathers the result by its codes
on the device.  length, octet_length and bit_length compute on the
device.
  - `dictionary_encode` gives value-sorted values, so its codes are the
    values' ranks; sorts, group-bys and joins key a StringColumn by them.
    On a CUDA column it ranks the rows on the card (K3: sort refinement,
    7 bytes a pass, in one native call) and copies none of the bytes to
    the host.
  - `dictionary_decode` is a `take` of the values on the device.
  - Ranks of a dictionary's values and the merged ranks of two value
    sets (join keys, dictionary against dictionary) come from the same
    interning and sort.
  - A comparison against a literal is evaluated once per dictionary
    value by merging the literal into the values' ranks; the per-code
    result goes to the device once, cached on the dictionary's values
    keyed by op, literal and device, and is gathered there by the
    codes.  The cache lets `fuse` capture the gather: a copy from host
    memory cannot be captured.  A StringColumn is dictionary-encoded
    first.
  - The reference's Python semantics stay where it uses them, once per
    distinct value: ILIKE with a non-ASCII pattern or data (`re` with
    IGNORECASE), a regex the native engine declines or non-ASCII data
    under a regex (`re`), str.upper / str.lower of non-ASCII data,
    substring of a dictionary, concat_elements over the observed code
    pairs, regexp_match one row at a time.
  - Where those per-value transforms build new values, the port keeps
    the column's string type; the reference gives utf8 (ROADMAP C15).
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import capturing, on_cuda
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           PrimitiveColumn, StringColumn)
from ..core.datum import Scalar
from ..errors import ArrowNotImplementedError, ArrowTypeError
from ..kernels.compact import compact
from ..kernels.strkey import BYTES as STRKEY_BYTES, strrank
from ..utils import hostcodec
from ..utils.trace import span, to_host

__all__ = ["dictionary_encode", "dictionary_decode", "value_ranks",
           "merged_string_ranks", "compare", "device_table", "like", "ilike",
           "nlike", "nilike", "starts_with", "ends_with", "contains",
           "regexp_is_match", "regexp_match", "substring", "length",
           "octet_length", "bit_length", "upper", "lower",
           "concat_elements"]


def _host_buffers(col: StringColumn) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 offsets, bytes) of a string column on the host."""
    return (to_host("strings.offsets", col.offsets).numpy().astype(
        np.int64, copy=False), to_host("strings.bytes", col.data).numpy())


def _dense_ranks(offs: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Dense uint64 ranks of the strings in byte order: equal strings
    share a rank (interning, then a sort of the distinct values)."""
    codes, uniq = hostcodec.intern_varlen(offs, data)
    uoffs, udata = hostcodec.gather_varlen(offs, data, uniq)
    order = hostcodec.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(len(uniq), 1), np.uint64)
    remap[order] = np.arange(len(uniq), dtype=np.uint64)
    return remap[codes]


def dictionary_encode(col: Column, code_dtype: torch.dtype = torch.int32,
                      ordered: bool = False) -> DictionaryColumn:
    """StringColumn -> DictionaryColumn with value-sorted distinct values
    (strings.py:45-78), on the column's device: the codes are the values'
    ranks.  Null rows keep their bytes in the ranking, as the
    reference's do, and take code 0.  `ordered` marks the type ordered.
    A dictionary passes through.

    A column on a CUDA device is ranked there (`_encode_on_device`); a
    column on the CPU is interned by the host library, as the reference
    does.  Both give the same codes and values.  The call is a
    `strings.encode` span: its rows, distinct values, passes and drops
    (0 on the host)."""
    if isinstance(col, DictionaryColumn):
        return col
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"dictionary_encode of {type(col).__name__}")
    with span("strings.encode", rows=len(col)) as s:
        if on_cuda(col.offsets):
            out, passes, drops = _encode_on_device(col, code_dtype, ordered)
        else:
            out, passes, drops = _encode_on_host(col, code_dtype, ordered), \
                0, 0
        if s is not None:
            s.attrs.update(distinct=len(out.values), passes=passes,
                           drops=drops)
    return out


def _encode_on_host(col: StringColumn, code_dtype: torch.dtype,
                    ordered: bool) -> DictionaryColumn:
    """The host route: the buffers copied to the host, interned, the
    distinct values sorted there, values and codes copied back."""
    offs, data = _host_buffers(col)
    codes, uniq = hostcodec.intern_varlen(offs, data)
    u = len(uniq)
    uoffs, udata = hostcodec.gather_varlen(offs, data, uniq)
    order = hostcodec.argsort_varlen(uoffs, udata).astype(np.int64)
    remap = np.empty(max(u, 1), np.int32)
    remap[order] = np.arange(u, dtype=np.int32)
    new_offs, new_data = hostcodec.gather_varlen(uoffs, udata, order)
    values = StringColumn.from_numpy(new_offs.astype(np.int32), new_data,
                                     dtype=col.dtype, device=col.device)
    # sorted and distinct: each value's rank is its slot
    values._value_ranks = (np.arange(u, dtype=np.uint64), np.zeros(u, bool))
    codes = torch.from_numpy(remap[codes].astype(
        dt.torch_dtype_name(code_dtype))).to(col.device)
    return DictionaryColumn(codes, values, col.validity,
                            _canonical=col.validity is None, ordered=ordered)


def _encode_on_device(col: StringColumn, code_dtype: torch.dtype,
                      ordered: bool) -> Tuple[DictionaryColumn, int, int]:
    """The device route: K3 ranks the rows (`strrank`: each row's sorted
    position by sort refinement, 7 bytes a pass, dropping finished rows
    after passes 1, 2, 4, ...; one native call on a CUDA column).  The
    codes are the dense ranks of the positions; a row of each position,
    taken in position order, gives the values.

    Scalars reach the host, never the bytes or offsets: the longest row
    (the number of passes), the rows left after each drop (inside K3's
    call), and the distinct count with the values' bytes
    (`_gather_bytes` adds two reads, its piece bounds, past GATHER_PIECE
    bytes of values).  Returns the column, the passes run and the drops
    made.  Runs on any device (K1 and K3 take their plain versions on
    the CPU); `dictionary_encode` sends only CUDA columns here."""
    from .take import _gather_bytes
    n, offs, dev = len(col), col.offsets, col.device
    lens = (offs[1:] - offs[:-1]).to(torch.int64)
    passes = -(-int(to_host("strings.maxlen", lens.max())) // STRKEY_BYTES) \
        if n else 0
    at, done, drops = strrank(offs, col.data, passes)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[at] = True                 # the positions that start a value
    codes = (torch.cumsum(first, 0, dtype=at.dtype) - 1)[at].to(code_dtype)
    row_at = torch.zeros(n, dtype=torch.int64, device=dev)
    row_at[at] = torch.arange(n, device=dev)   # a row of each position
    (pos,), count = compact(first, [], positions=torch.int64)
    nbytes = torch.where(first, lens[row_at], 0).sum()
    del lens, at, first
    u, total = to_host("strings.distinct",
                       torch.stack([count, nbytes])).tolist()
    voffs, vdata = _gather_bytes(offs, col.data, row_at[pos[:u]], total)
    values = StringColumn(voffs, vdata, col.dtype)
    # sorted and distinct: each value's rank is its slot
    values._value_ranks = (np.arange(u, dtype=np.uint64), np.zeros(u, bool))
    return DictionaryColumn(codes, values, col.validity,
                            _canonical=col.validity is None,
                            ordered=ordered), done, drops


def dictionary_decode(col: DictionaryColumn) -> Column:
    """The dictionary's values at every row (strings.py:81-87): a take of
    the values by the codes, on the device."""
    from .take import take
    idx = PrimitiveColumn(col.codes, col.dtype.index_type, col.validity,
                          _canonical=True)
    return take(col.values, idx)


def value_ranks(values: StringColumn) -> Tuple[np.ndarray, np.ndarray]:
    """(dense uint64 ranks, is_null) per slot of a string dictionary's
    values: the valid values ranked by their bytes, null slots rank 0
    (row_format.py:92-115)."""
    is_null = np.zeros(len(values), bool) if values.validity is None \
        else ~to_host("strings.validity", values.validity).numpy()
    ranks = np.zeros(len(values), np.uint64)
    valid = np.nonzero(~is_null)[0]
    if len(valid):
        offs, data = hostcodec.gather_varlen(*_host_buffers(values), valid)
        ranks[valid] = _dense_ranks(offs, data)
    return ranks, is_null


def merged_string_ranks(lv: StringColumn, rv: StringColumn
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense uint64 ranks of two value sets in one merged byte-ordered
    domain (strings.py:183-199): (left ranks, right ranks), one per
    slot; a null slot ranks by its bytes."""
    lo, ld = _host_buffers(lv)
    ro, rd = _host_buffers(rv)
    offs = np.concatenate([lo - lo[0], ro[1:] - ro[0] + (lo[-1] - lo[0])])
    data = np.concatenate([ld[lo[0]:lo[-1]], rd[ro[0]:ro[-1]]])
    ranks = _dense_ranks(offs, data)
    return ranks[:len(lv)], ranks[len(lv):]


def _dict_slot_validity(dcol: DictionaryColumn) -> vd.Mask:
    """The dictionary's validity with its null value slots folded in
    (the reference's _dict_slot_validity and _effective_validity)."""
    entries = getattr(dcol.values, "validity", None)
    if entries is None:
        return dcol.validity
    entry_valid = device_table(dcol.values, ("entry_valid",), dcol.device,
                               lambda: to_host("strings.validity",
                                               entries).numpy())
    return vd.union(dcol.validity, _gather(entry_valid, dcol.codes))


def device_table(owner, key, device: torch.device,
                 build: Callable[[], np.ndarray]) -> torch.Tensor:
    """A host-built table on `device`, cached on `owner` (a dictionary's
    values) under `key`: built and copied once, reused afterwards, also
    by a pipeline `fuse` captures (where the copy could not run)."""
    cache = owner.__dict__.setdefault("_device_tables", {})
    got = cache.get((key, device))
    if got is None:
        if capturing():
            raise RuntimeError(
                f"arrow_tpu_torch.fuse: the table {key!r} was not built "
                "before the capture; the dictionary's values must be the "
                "same object in every call")
        got = torch.from_numpy(build()).to(device)
        cache[(key, device)] = got
    return got


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return torch.index_select(table, 0, codes.to(torch.int64)
                              if codes.dtype != torch.int32 else codes)


def _scalar_str(x) -> Optional[str]:
    if isinstance(x, Scalar):
        if not x.valid:
            return None
        raise ArrowTypeError("string scalar must be python str")
    if isinstance(x, bytes):
        return x.decode()
    return x


_FROM_SIGN = {
    "eq": lambda c: c == 0, "neq": lambda c: c != 0,
    "lt": lambda c: c < 0, "lt_eq": lambda c: c <= 0,
    "gt": lambda c: c > 0, "gt_eq": lambda c: c >= 0,
}
_FLIP = {"lt": "gt", "gt": "lt", "lt_eq": "gt_eq", "gt_eq": "lt_eq",
         "eq": "eq", "neq": "neq"}


def compare(op: str, lhs, rhs) -> PrimitiveColumn:
    """Dictionary- and string-aware comparison (called from ops.cmp)."""
    lhs_col, rhs_col = isinstance(lhs, Column), isinstance(rhs, Column)
    if lhs_col and not rhs_col:
        return _compare_scalar(op, lhs, rhs)
    if rhs_col and not lhs_col:
        return _compare_scalar(_FLIP[op], rhs, lhs)
    return _compare_cols(op, lhs, rhs)


def _literal_signs(values: StringColumn, lit: str) -> np.ndarray:
    """sign(value - lit) in byte order, one int64 per value slot."""
    lrank, rrank = merged_string_ranks(
        values, StringColumn.from_pylist([lit], values.dtype, device="cpu"))
    return np.sign(lrank.astype(np.int64) - rrank.astype(np.int64)[0])


def _compare_scalar(op: str, col: Column, scalar_val) -> PrimitiveColumn:
    s = _scalar_str(scalar_val)
    n, device = len(col), col.device
    if s is None:
        zeros = torch.zeros((n,), dtype=torch.bool, device=device)
        return PrimitiveColumn(zeros, dt.bool_, zeros.clone())
    dcol = dictionary_encode(col)
    if not isinstance(dcol.values, StringColumn):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    per_code = device_table(dcol.values, ("cmp", op, s), device, lambda: (
        _FROM_SIGN[op](_literal_signs(dcol.values, s))))
    return PrimitiveColumn(_gather(per_code, dcol.codes), dt.bool_,
                           _dict_slot_validity(dcol))


def _compare_cols(op: str, lhs: Column, rhs: Column) -> PrimitiveColumn:
    """Dictionary against dictionary: both map into one merged rank
    domain on the host (cmp.rs:468), the ranks compare on the device."""
    dl, dr = dictionary_encode(lhs), dictionary_encode(rhs)
    lv, rv = dl.values, dr.values
    if not (isinstance(lv, StringColumn) and isinstance(rv, StringColumn)):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    lrank, rrank = merged_string_ranks(lv, rv)
    validity = vd.union(_dict_slot_validity(dl), _dict_slot_validity(dr))
    lk = _gather(torch.from_numpy(lrank.astype(np.int64)).to(dl.device),
                 dl.codes)
    rk = _gather(torch.from_numpy(rrank.astype(np.int64)).to(dr.device),
                 dr.codes)
    from .cmp import _OPS
    return PrimitiveColumn(_OPS[op](lk, rk), dt.bool_, validity)


# ---- predicates (strings.py:250-433) ----------------------------------------

def _dict_values_host(dcol: DictionaryColumn) -> list:
    """A string dictionary's values as Python values (str, or bytes for
    a binary type)."""
    if not isinstance(dcol.values, StringColumn):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    return dcol.values.to_pylist()


def _per_code(dcol: DictionaryColumn, table: torch.Tensor, dtype
              ) -> PrimitiveColumn:
    """A per-value result gathered by the dictionary's codes on the
    device, the null value slots folded into the validity
    (strings.py:282-296)."""
    return PrimitiveColumn(_gather(table.to(dcol.device), dcol.codes), dtype,
                           _dict_slot_validity(dcol))


def _per_value(col: Column, fn: Callable) -> PrimitiveColumn:
    """A predicate evaluated once per distinct value in Python, then
    gathered by code (strings.py:250-257)."""
    dcol = dictionary_encode(col)
    vals = _dict_values_host(dcol)
    hits = np.array([False if v is None else bool(fn(v)) for v in vals],
                    bool)
    return _per_code(dcol, torch.from_numpy(hits), dt.bool_)


def _is_ascii(b: bytes) -> bool:
    return not any(c & 0x80 for c in b)


def _any_high_byte(data: torch.Tensor) -> bool:
    """Whether any byte is outside ASCII: one reduction where the bytes
    are, one flag read."""
    return data.numel() > 0 and bool(to_host("strings.high_byte",
                                             (data >= 0x80).any()))


def _on_device(hits: np.ndarray, col: Column) -> torch.Tensor:
    return torch.from_numpy(hits).to(col.device)


def _match_mask(col: Column, op: int, pattern: str, ci: bool = False,
                negate: bool = False) -> PrimitiveColumn:
    """One native pass (predicate.rs:28, like.rs:79-186): over the bytes
    of a StringColumn, or over a dictionary's distinct values gathered by
    code; the column's validity kept (strings.py:264-297)."""
    pat = pattern.encode("utf-8")
    if ci and not _is_ascii(pat):
        return _match_fallback(col, op, pattern, ci, negate)
    if isinstance(col, StringColumn):
        if ci and _any_high_byte(col.data):
            return _match_fallback(col, op, pattern, ci, negate)
        hits = hostcodec.bytes_match(*_host_buffers(col), pat, op, ci)
        if negate:
            hits = ~hits
        return PrimitiveColumn(_on_device(hits, col), dt.bool_, col.validity)
    dcol = dictionary_encode(col)
    if not isinstance(dcol.values, StringColumn):
        raise ArrowNotImplementedError("non-string dictionary predicate")
    return _per_code(dcol, _match_mask(dcol.values, op, pattern, ci,
                                       negate).values, dt.bool_)


def _match_fallback(col, op, pattern, ci, negate) -> PrimitiveColumn:
    """Per distinct value in Python (strings.py:300-313): ILIKE where the
    pattern or the data is not ASCII."""
    if op == hostcodec.MATCH_LIKE:
        flags = re.DOTALL | (re.IGNORECASE if ci else 0)
        rx = re.compile(_like_regex(pattern), flags)
        fn = lambda v: (rx.match(v) is not None) != negate
    elif op == hostcodec.MATCH_STARTS:
        fn = lambda v: v.startswith(pattern) != negate
    elif op == hostcodec.MATCH_ENDS:
        fn = lambda v: v.endswith(pattern) != negate
    else:
        fn = lambda v: (pattern in v) != negate
    return _per_value(col, fn)


def _like_regex(pattern: str) -> str:
    """A LIKE pattern as an anchored regex: % any run, _ one character,
    backslash escaping % and _ (strings.py:316-337)."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern) and pattern[i + 1] in "%_":
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def like(col, pattern: str) -> PrimitiveColumn:
    """SQL LIKE (like.rs): % and _ wildcards, backslash escapes."""
    return _match_mask(col, hostcodec.MATCH_LIKE, pattern)


def ilike(col, pattern: str) -> PrimitiveColumn:
    """Case-insensitive LIKE."""
    return _match_mask(col, hostcodec.MATCH_LIKE, pattern, ci=True)


def nlike(col, pattern: str) -> PrimitiveColumn:
    """NOT LIKE."""
    return _match_mask(col, hostcodec.MATCH_LIKE, pattern, negate=True)


def nilike(col, pattern: str) -> PrimitiveColumn:
    """NOT ILIKE."""
    return _match_mask(col, hostcodec.MATCH_LIKE, pattern, ci=True,
                       negate=True)


def starts_with(col, prefix: str) -> PrimitiveColumn:
    return _match_mask(col, hostcodec.MATCH_STARTS, prefix)


def ends_with(col, suffix: str) -> PrimitiveColumn:
    return _match_mask(col, hostcodec.MATCH_ENDS, suffix)


def contains(col, needle: str) -> PrimitiveColumn:
    return _match_mask(col, hostcodec.MATCH_CONTAINS, needle)


def _regex_native_mask(col, pattern: str, ci: bool
                       ) -> Optional[PrimitiveColumn]:
    """One native lazy-DFA pass over every value's bytes (regexp.rs:39),
    or None where Python's `re` decides: a non-ASCII pattern or data, a
    construct the engine declines (strings.py:368-398)."""
    if not _is_ascii(pattern.encode()):
        return None
    h = hostcodec.regex_compile(pattern, ci)
    if h is None:
        return None
    if isinstance(col, StringColumn):
        if _any_high_byte(col.data):
            return None                # byte DFA against code points
        hits = hostcodec.regex_match(h, *_host_buffers(col))
        return PrimitiveColumn(_on_device(hits, col), dt.bool_, col.validity)
    dcol = dictionary_encode(col)
    if not isinstance(dcol.values, StringColumn):
        return None
    inner = _regex_native_mask(dcol.values, pattern, ci)
    return None if inner is None else _per_code(dcol, inner.values,
                                                dt.bool_)


def regexp_is_match(col, pattern: str, flags: str = "") -> PrimitiveColumn:
    """Whether the regex matches anywhere in each value (regexp.rs
    regexp_is_match); flags "i" folds case.  The pattern is compiled by
    `re` first, so a bad pattern raises re.error as in the reference."""
    ci = "i" in flags
    rx = re.compile(pattern, re.IGNORECASE if ci else 0)
    native = _regex_native_mask(col, pattern, ci)
    if native is not None:
        return native
    return _per_value(col, lambda v: rx.search(v) is not None)


def regexp_match(col, pattern: str, flags: str = "") -> Column:
    """The first match's capture groups (the whole match when there are
    none) per row as List<Utf8>; no match or a null row is a null list
    (regexp.rs regexp_match).  Matched once per distinct value, built one
    row at a time, as in the reference (strings.py:410-441)."""
    from ..core.builders import ListBuilder, StringBuilder
    rx = re.compile(pattern, re.IGNORECASE if "i" in flags else 0)
    d = dictionary_encode(col)
    per_value = []
    for v in _dict_values_host(d):
        m = None if v is None else rx.search(v)
        per_value.append(None if m is None else list(m.groups())
                         if rx.groups else [m.group(0)])
    codes = to_host("strings.codes", d.codes).numpy().tolist()
    valid = None if d.validity is None else \
        to_host("strings.validity", d.validity).numpy()
    lb = ListBuilder(StringBuilder(d.device))
    for i, c in enumerate(codes):
        row = per_value[c] if valid is None or valid[i] else None
        lb.append_null() if row is None else lb.append_value(row)
    return lb.finish()


# ---- transforms (strings.py:446-517) ---------------------------------------

def _map_values(col: Column, fn: Callable) -> Column:
    """A transform of each distinct value in Python; the codes kept, the
    column's string type kept (the reference gives utf8: ROADMAP C15)."""
    dcol = dictionary_encode(col)
    vals = _dict_values_host(dcol)
    new_vals = StringColumn.from_pylist(
        [None if v is None else fn(v) for v in vals], dcol.values.dtype,
        device=dcol.device)
    out = DictionaryColumn(dcol.codes, new_vals, dcol.validity,
                           _canonical=True)
    return out if isinstance(col, DictionaryColumn) else \
        dictionary_decode(out)


def substring(col, start: int, length: Optional[int] = None) -> Column:
    """Characters [start, start + length) of each value (substring.rs: a
    negative start counts from the end, no length runs to the end): one
    native pass over a StringColumn's bytes; a dictionary maps its
    values.  The offsets take the type's width (the reference writes
    int32 under every type: ROADMAP C14)."""
    if isinstance(col, StringColumn):
        offs, data = hostcodec.utf8_substring(*_host_buffers(col), start,
                                              length)
        out = StringColumn.from_numpy(offs, data, None, col.dtype,
                                      device=col.device)
        return out.with_validity(col.validity)

    def f(v):
        s = start if start >= 0 else max(len(v) + start, 0)
        e = len(v) if length is None else min(s + length, len(v))
        return v[s:e]
    return _map_values(col, f)


def _case_transform(col, to_upper: bool) -> Column:
    """ASCII case over a StringColumn's whole byte buffer, the offsets
    kept; non-ASCII data and dictionaries map case per value
    (str.upper / str.lower)."""
    if isinstance(col, StringColumn):
        out, is_ascii = hostcodec.ascii_case(_host_buffers(col)[1], to_upper)
        if is_ascii:
            return StringColumn(col.offsets, torch.from_numpy(out).to(
                col.device), col.dtype, col.validity)
    return _map_values(col, str.upper if to_upper else str.lower)


def upper(col) -> Column:
    return _case_transform(col, True)


def lower(col) -> Column:
    return _case_transform(col, False)


def concat_elements(lhs: Column, rhs: Column) -> Column:
    """Element-wise concatenation (concat_elements.rs): the observed
    (left code, right code) pairs, ranked on the device, become one
    dictionary of joined values built on the host; a row is null where
    either side is (strings.py:490-517)."""
    dl, dr = dictionary_encode(lhs), dictionary_encode(rhs)
    lv, rv = _dict_values_host(dl), _dict_values_host(dr)
    m = max(len(rv), 1)
    pair = dl.codes.to(torch.int64) * m + dr.codes.to(torch.int64)
    uniq, inv = torch.unique(pair, sorted=True, return_inverse=True)
    vals = []
    for p in to_host("strings.pairs", uniq).tolist():
        a, b = lv[p // m], rv[p % m]
        vals.append(None if a is None or b is None else a + b)
    out = DictionaryColumn(inv.to(torch.int32), StringColumn.from_pylist(
        vals, dl.values.dtype, device=dl.device),
        vd.union(dl.validity, dr.validity))
    return out if isinstance(lhs, DictionaryColumn) else \
        dictionary_decode(out)


# ---- length kernels, on the device (strings.py:520-574) --------------------

def octet_length(col) -> PrimitiveColumn:
    """Bytes per value (length.rs octet_length): the offsets' differences,
    int32."""
    if isinstance(col, DictionaryColumn):
        return _per_code(col, octet_length(col.values).values, dt.int32)
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"octet_length of {type(col).__name__}")
    lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int32)
    return PrimitiveColumn(lens, dt.int32, col.validity)


def length(col) -> PrimitiveColumn:
    """Characters per value (length.rs length): the bytes that are not
    UTF-8 continuation bytes, from one prefix sum over the byte buffer;
    element counts of lists and maps (int64 for a large_list), list view
    sizes, and the fixed width of fixed-size lists and binaries."""
    from ..core.nested import (FixedSizeBinaryColumn, FixedSizeListColumn,
                               ListViewColumn, MapColumn)
    if isinstance(col, DictionaryColumn):
        return _per_code(col, length(col.values).values, dt.int32)
    if isinstance(col, (ListColumn, MapColumn)):
        wide = col.dtype.name == "large_list"
        counts = col.offsets[1:] - col.offsets[:-1]
        return PrimitiveColumn(counts.to(torch.int64 if wide
                                         else torch.int32),
                               dt.int64 if wide else dt.int32, col.validity)
    if isinstance(col, ListViewColumn):
        return PrimitiveColumn(col.sizes.to(torch.int32), dt.int32,
                               col.validity)
    if isinstance(col, (FixedSizeListColumn, FixedSizeBinaryColumn)):
        width = col.list_size if isinstance(col, FixedSizeListColumn) \
            else col.byte_width
        return PrimitiveColumn(torch.full((len(col),), width,
                                          dtype=torch.int32,
                                          device=col.device),
                               dt.int32, col.validity)
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"length of {type(col).__name__}")
    from . import take
    acc = torch.int32 if col.data.numel() < take.INDEX32_LIMIT \
        else torch.int64
    starts = (col.data & 0xC0) != 0x80
    prefix = torch.cat([torch.zeros(1, dtype=acc, device=col.device),
                        torch.cumsum(starts, 0, dtype=acc)])
    counts = prefix[col.offsets[1:]] - prefix[col.offsets[:-1]]
    return PrimitiveColumn(counts.to(torch.int32), dt.int32, col.validity)


def bit_length(col) -> PrimitiveColumn:
    """Bits per value: octet_length * 8."""
    o = octet_length(col)
    return PrimitiveColumn(o.values * 8, dt.int32, o.validity)
