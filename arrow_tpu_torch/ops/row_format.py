"""Order-preserving key encoding for sorts, group-bys and joins
(counterpart of arrow_tpu/ops/row_format.py: key_kind, key_parts,
dictionary_value_ranks, encode_value_key, _encode_one_traced and
lexsort_order_traced, row_format.py:64-163,375-400,483-634,703-717).

Each key column becomes a group of integer sort keys, most significant
first (the reference's u8 class keys plus a value key at native width):

  null class   1 bit: null 0, valid 1 (nulls first)
  int          the value at native width, signed values sign-flipped
               (arrow-row fixed.rs:47); rebased to (v - kmin) in the
               fewest bits when the caller knows the column's range
  bool, uint   the value (zero-extended)
  float        a NaN class bit (NaN above everything) + the IEEE
               totalOrder bits at native width of the NaN-cleaned value
               with -0.0 folded into +0.0 (row_format.py:522-530,575-589)
  dictionary   the dense rank of the dictionary value, through a rank
               LUT on the device; null dictionary entries fold into the
               validity

`torch.sort` has no multi-key form (ROADMAP, "Port environment"), so
`lexsort_order` packs consecutive keys into one int64 word (int32 when
they fit in 31 bits) while their bits fit in 63, and sorts the words
with stable passes from the last word to the first.

`encode_value_key` is the join's key: one u64 per row (in int64
storage) whose unsigned order is the value order, with no null class
and no float folding: floats map through f64 to their IEEE totalOrder
bits, so -0.0 and +0.0 differ and NaNs compare by their bits.

String, REE, decimal and nested sort and group keys raise
ArrowNotImplementedError: those layouts join with ROADMAP A7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..errors import ArrowNotImplementedError

__all__ = ["SortKey", "KeyRange", "dictionary_value_ranks", "key_kind",
           "key_parts", "encode_keys", "lexsort_order", "sort_keys",
           "float_order_key", "int_order_key", "encode_value_key"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_WORD_BITS = 63                    # a packed word stays a non-negative int64


@dataclass(frozen=True)
class SortKey:
    """One integer sort key: order values in [0, 2**bits) (for bits ==
    64, the u64 bits in int64 storage)."""
    values: torch.Tensor
    bits: int


@dataclass(frozen=True)
class KeyRange:
    """Masked (min, max, has_null) of an integer or bool column, as
    Python ints in the logical type (groupby.py:2106-2130)."""
    lo: int
    hi: int
    has_null: bool

    @property
    def bounds(self) -> Tuple[int, int]:
        """(lo, hi), or (0, 0) for a column with no valid value."""
        return (self.lo, self.hi) if self.lo <= self.hi else (0, 0)


def dictionary_value_ranks(values: Column) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ranks of a dictionary's values, on the host (row_format.py:92).
    Returns (ranks uint64, is_null bool) per dictionary slot; equal values
    share a rank; strings rank by their UTF-8 bytes."""
    if isinstance(values, StringColumn):
        lst = values.to_pylist()
        is_null = np.array([v is None for v in lst], dtype=bool)
        keys = sorted({v.encode() for v in lst if v is not None})
        rank_of = {k: i for i, k in enumerate(keys)}
        ranks = np.array([0 if v is None else rank_of[v.encode()]
                          for v in lst], dtype=np.uint64)
        return ranks, is_null
    if isinstance(values, PrimitiveColumn):
        vals = values.to_numpy()
        is_null = ~values.is_valid_mask().cpu().numpy()
        ranks = np.zeros(len(vals), np.uint64)
        if (~is_null).any():
            _, inv = np.unique(vals[~is_null], return_inverse=True)
            ranks[~is_null] = inv.astype(np.uint64)
        return ranks, is_null
    raise ArrowNotImplementedError(f"dictionary of {type(values).__name__}")


def _not_yet(what: str) -> ArrowNotImplementedError:
    return ArrowNotImplementedError(
        f"{what} as a sort or group key joins with ROADMAP A7")


def key_kind(c: Column) -> str:
    """'dict', 'float', 'uint' (bool and unsigned) or 'int'
    (row_format.py:375-400)."""
    if isinstance(c, DictionaryColumn):
        return "dict"
    if isinstance(c, PrimitiveColumn):
        d = c.dtype
        if d.is_floating:
            return "float"
        if d.is_boolean or d.is_unsigned_integer:
            return "uint"
        return "int"
    raise _not_yet(f"{type(c).__name__} ({c.dtype!r})")


def key_parts(c: Column):
    """(values, ranks, entry_valid, validity) of one key column
    (row_format.py:483-519).  A dictionary's ranks are computed on the
    host; ranks is None when the dictionary is value-sorted (codes are
    ranks), entry_valid None when it holds no null value.  A declared
    ordered flag is not trusted: ranks come from the values, as pyarrow
    orders them (ROADMAP C, reference fault 1)."""
    key_kind(c)
    if isinstance(c, DictionaryColumn):
        ranks, dict_null = dictionary_value_ranks(c.values)
        entry_valid = None if not dict_null.any() else \
            torch.from_numpy(~dict_null).to(c.device)
        if not dict_null.any() and \
                bool((np.diff(ranks.astype(np.int64)) > 0).all()):
            return c.codes, None, None, c.validity
        r = torch.from_numpy(ranks.astype(np.int64)).to(c.device)
        return c.codes, r, entry_valid, c.validity
    return c.values, None, None, c.validity


def float_order_key(values: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(IEEE totalOrder bits at the value's own width as int64, width):
    key order == float order, -0.0 below +0.0, NaN above +inf."""
    width = 8 * values.element_size()
    if width == 64:
        b = values.view(torch.int64)
        return torch.where(b < 0, ~b, b | _SIGN), 64
    storage = torch.int32 if width == 32 else torch.int16
    mask = (1 << width) - 1
    b = values.view(storage).to(torch.int64) & mask
    top = 1 << (width - 1)
    return torch.where(b >= top, ~b & mask, b | top), width


def int_order_key(values: torch.Tensor, d: dt.DataType,
                  rng: Optional[KeyRange] = None
                  ) -> Tuple[torch.Tensor, int]:
    """(order key as int64, bits) of integer or bool storage of logical
    type `d`: v - lo in the fewest bits when the range is known, else
    the native width with signed values sign-flipped
    (row_format.py:545-556)."""
    w = dt.widen(values, d)
    if rng is not None:
        lo, hi = rng.bounds
        return w - dt.storage_int(lo), (hi - lo).bit_length()
    if d.is_boolean:
        return w, 1
    width = 8 * d.byte_width
    if d.is_unsigned_integer:
        return w, width
    if width == 64:
        return w ^ _SIGN, 64
    return w + (1 << (width - 1)), width


def encode_value_key(col: Column
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(u64 order key per row in int64 storage, effective validity)
    (row_format.py:133-163).  Signed integers and temporal values are
    sign-flipped, unsigned and bool zero-extended, an interval[day_time]
    flips both 32-bit halves, floats take f64 totalOrder bits; a
    dictionary maps through its value ranks, its null entries folding
    into the validity; a StringColumn is ranked on the fly."""
    if isinstance(col, PrimitiveColumn):
        d, v = col.dtype, col.values
        if d.is_floating:
            return float_order_key(v.to(torch.float64))[0], col.validity
        w = dt.widen(v, d)
        if d.is_boolean or d.is_unsigned_integer:
            return w, col.validity
        if d.name == "interval" and d.unit == "day_time":
            return w ^ (0x80000000 | _SIGN), col.validity
        return w ^ _SIGN, col.validity
    if isinstance(col, DictionaryColumn):
        ranks, dict_null = dictionary_value_ranks(col.values)
        codes = col.codes.to(torch.int64)
        key = torch.from_numpy(ranks.view(np.int64)).to(col.device)[codes]
        validity = col.validity
        if dict_null.any():
            ev = torch.from_numpy(~dict_null).to(col.device)[codes]
            validity = ev if validity is None else validity & ev
        return key, validity
    if isinstance(col, StringColumn):
        from .strings import string_ranks
        ranks = string_ranks(col.to_pylist())
        return torch.from_numpy(ranks.view(np.int64)), col.validity
    raise ArrowNotImplementedError(f"row key for {type(col).__name__}")


def _encode_one(c: Column, rng: Optional[KeyRange]) -> List[SortKey]:
    """One column's key group, most significant first
    (_encode_one_traced, row_format.py:559-634)."""
    kind = key_kind(c)
    vals, ranks, entry_valid, validity = key_parts(c)
    keys: List[SortKey] = []
    if kind == "float":
        isnan = torch.isnan(vals)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        clean = torch.where(isnan | (vals == 0), zero, vals)
        vkey, bits = float_order_key(clean)
        nan_key = isnan.to(torch.int64)
        if validity is not None:
            keys.append(SortKey(validity.to(torch.int64), 1))
            nan_key = torch.where(validity, nan_key, 0)
            vkey = torch.where(validity, vkey, 0)
        return keys + [SortKey(nan_key, 1), SortKey(vkey, bits)]
    if kind == "dict":
        codes = vals.to(torch.int64)
        vkey = codes if ranks is None else ranks[codes]
        bits = max(len(c.values) - 1, 0).bit_length()   # ranks < size
        if entry_valid is not None:
            ev = entry_valid[codes]
            validity = ev if validity is None else validity & ev
    else:
        vkey, bits = int_order_key(vals, c.dtype, rng)
        if rng is not None and not rng.has_null:
            validity = None
    if validity is not None:
        keys.append(SortKey(validity.to(torch.int64), 1))
        vkey = torch.where(validity, vkey, 0)
    keys.append(SortKey(vkey, bits))
    return keys


def encode_keys(cols: Sequence[Column],
                ranges: Optional[Sequence[Optional[KeyRange]]] = None
                ) -> List[SortKey]:
    """Key stack of several columns, first column most significant;
    ranges[i] (integer and bool columns only) narrows column i's value
    key and drops its null class when it holds no null."""
    ranges = ranges or [None] * len(cols)
    return [k for c, r in zip(cols, ranges) for k in _encode_one(c, r)]


def _pack_words(keys: Sequence[SortKey]) -> List[torch.Tensor]:
    """Pack consecutive keys into sortable words (signed order == key
    order), most significant first.  A 64-bit key is a word of its own
    (sign-flipped); 0-bit keys vanish; words of at most 31 bits are
    int32, halving the sort's traffic."""
    words: List[torch.Tensor] = []
    acc, acc_bits = None, 0

    def flush():
        nonlocal acc, acc_bits
        if acc is not None:
            words.append(acc.to(torch.int32) if acc_bits <= 31 else acc)
        acc, acc_bits = None, 0

    for k in reversed(keys):
        if k.bits == 0:
            continue
        if k.bits >= 64:
            flush()
            words.append(k.values ^ _SIGN)
            continue
        if acc_bits + k.bits > _WORD_BITS:
            flush()
        part = k.values if acc is None else k.values << acc_bits
        acc = part if acc is None else acc | part
        acc_bits += k.bits
    flush()
    return words[::-1]


def _lex_passes(words: Sequence[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Stable LSD passes: (order, the first word in sorted order), or
    (None, None) when there is no word (every key constant)."""
    order = first = None
    for w in reversed(words):
        first, idx = torch.sort(w if order is None else w[order],
                                stable=True)
        order = idx if order is None else order[idx]
    return order, first


def sort_keys(keys: Sequence[SortKey], n: int, device
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(stable lexicographic order as int64, the packed words in that
    order): equal rows have equal words, so run boundaries are a shifted
    compare of the words."""
    words = _pack_words(keys)
    order, first = _lex_passes(words)
    if order is None:
        return torch.arange(n, dtype=torch.int64, device=device), []
    return order, [first] + [w[order] for w in words[1:]]


def lexsort_order(keys: Sequence[SortKey], n: int, device) -> torch.Tensor:
    """Stable lexicographic argsort of a key stack, keys[0] most
    significant (lexsort_order_traced, row_format.py:703-717)."""
    order, _ = _lex_passes(_pack_words(keys))
    if order is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    return order
