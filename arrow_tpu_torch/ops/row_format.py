"""Order-preserving key encoding for sorts, group-bys and joins
(counterpart of arrow_tpu/ops/row_format.py: SortOptions, SortField,
key_kind, key_parts, dictionary_value_ranks, encode_value_key,
_encode_one_traced, group_has_null_key, decode_sorted_group,
lexsort_order_traced and lexsort_indices_fused, row_format.py:50-163,
375-400,483-742).

Each key column becomes a group of integer sort keys, most significant
first (the reference's u8 class keys plus a value key at native width):

  null class   1 bit: null 0, valid 1 (nulls first; nulls last flips it)
  int          the value at native width, signed values sign-flipped
               (arrow-row fixed.rs:47); rebased to (v - kmin) in the
               fewest bits when the caller knows the column's range
  bool, uint   the value (zero-extended)
  float        a NaN class bit (NaN above everything) + the IEEE
               totalOrder bits at native width of the NaN-cleaned value
               with -0.0 folded into +0.0 (row_format.py:522-530,575-589)
  dictionary   the dense rank of the dictionary value, through a rank
               LUT on the device; null dictionary entries fold into the
               validity; a StringColumn is dictionary-encoded first
               (strings.dictionary_encode, row_format.py:494-496), so
               its codes are its ranks
  day_time     (sort keys) bit 31 flipped first, so the signed millis
               half orders under the int64 key (row_format.py:393-396)

A value key holds values in [0, 2**bits); descending order maps v to
(2**bits - 1) - v (for 64 bits, ~v on the u64 bits), and null rows'
value keys are 0 under either option.  Group and join keys take the
defaults (ascending, nulls first) and keep their outputs.

`torch.sort` has no multi-key form (ROADMAP, "Port environment"), so
`lexsort_order` packs consecutive keys into one int64 word (int32 when
they fit in 31 bits) while their bits fit in 63, and sorts the words
with stable passes from the last word to the first.

`encode_value_key` is the join's key: one u64 per row (in int64
storage) whose unsigned order is the value order, with no null class
and no float folding: floats map through f64 to their IEEE totalOrder
bits, so -0.0 and +0.0 differ and NaNs compare by their bits.

The packed words of a sorted key stack unpack back into the sorted
keys, and `decode_sorted_group` turns one column's sorted keys back into
its values (or dictionary codes) and validity: `sort_table` gets its
key columns without a gather of the column.  Float value keys fold -0.0
into +0.0 (the reference sorts them as ties), so a float column is not
decoded from its keys: ops/sort.py gathers it and writes the canonical
NaN, as the reference's decode does.

REE, decimal, interval[month_day_nano] and nested sort and group keys
raise ArrowNotImplementedError: they join with ROADMAP A7.4, the byte
rows of `RowConverter` with A7.4 and A8.
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

__all__ = ["SortOptions", "SortField", "SortKey", "KeyRange",
           "dictionary_value_ranks", "key_kind", "key_parts", "encode_keys",
           "encode_key_groups", "lexsort_order", "sort_keys",
           "sorted_key_values",
           "group_has_null_key", "decode_sorted_group",
           "lexsort_indices_fused", "float_order_key", "int_order_key",
           "encode_value_key"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_WORD_BITS = 63                    # a packed word stays a non-negative int64


@dataclass(frozen=True)
class SortOptions:
    """arrow-schema SortOptions (lib.rs:84): ascending, nulls first by
    default (lib.rs:161-169)."""
    descending: bool = False
    nulls_first: bool = True


@dataclass(frozen=True)
class SortField:
    """arrow-row SortField (lib.rs:576)."""
    options: SortOptions = SortOptions()


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
    share a rank; strings rank by their UTF-8 bytes, through the native
    interning and sort (strings.value_ranks).  Computed once per values
    column and kept on it (`dictionary_encode` sets them)."""
    ranks = getattr(values, "_value_ranks", None)
    if ranks is None:
        ranks = values._value_ranks = _value_ranks(values)
    return ranks


def _value_ranks(values: Column) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(values, StringColumn):
        from .strings import value_ranks
        return value_ranks(values)
    if isinstance(values, PrimitiveColumn):
        vals = values.to_numpy()
        is_null = ~values.is_valid_mask().cpu().numpy()
        ranks = np.zeros(len(vals), np.uint64)
        if (~is_null).any():
            _, inv = np.unique(vals[~is_null], return_inverse=True)
            ranks[~is_null] = inv.reshape(-1).astype(np.uint64)
        return ranks, is_null
    raise ArrowNotImplementedError(f"dictionary of {type(values).__name__}")


def _not_yet(what: str) -> ArrowNotImplementedError:
    return ArrowNotImplementedError(
        f"{what} as a sort or group key joins with ROADMAP A7.4")


def key_kind(c: Column) -> str:
    """'dict' (dictionaries and strings), 'float', 'uint' (bool and
    unsigned) or 'int' (row_format.py:375-400)."""
    if isinstance(c, (DictionaryColumn, StringColumn)):
        return "dict"
    if isinstance(c, PrimitiveColumn) and not c.dtype.is_decimal:
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
    host and go to the device once (kept on its values, so `fuse` can
    capture a sort); ranks is None when the dictionary is value-sorted
    (codes are ranks), entry_valid None when it holds no null value.  A
    declared ordered flag is not trusted: ranks come from the values, as
    pyarrow orders them (ROADMAP C7.1); a dictionary from
    `dictionary_encode` carries its ranks, so its codes are taken as
    they are without a host pass.  A StringColumn is dictionary-encoded
    (row_format.py:494-496)."""
    from .strings import device_table, dictionary_encode
    key_kind(c)
    if isinstance(c, StringColumn):
        c = dictionary_encode(c)
    if isinstance(c, DictionaryColumn):
        ranks, dict_null = dictionary_value_ranks(c.values)
        if not dict_null.any() and \
                bool((np.diff(ranks.astype(np.int64)) > 0).all()):
            return c.codes, None, None, c.validity
        r = device_table(c.values, ("ranks",), c.device,
                         lambda: ranks.astype(np.int64))
        entry_valid = None if not dict_null.any() else device_table(
            c.values, ("entry_valid",), c.device, lambda: ~dict_null)
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
    into the validity; a StringColumn is dictionary-encoded first."""
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
        from .strings import dictionary_encode
        return encode_value_key(dictionary_encode(col))
    raise ArrowNotImplementedError(f"row key for {type(col).__name__}")


def _flip(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Descending order of a key in [0, 2**bits)."""
    return ~v if bits >= 64 else ((1 << bits) - 1) - v


def _dict_bits(c: DictionaryColumn) -> int:
    """Bits of a dictionary's ranks (< its size)."""
    return max(len(c.values) - 1, 0).bit_length()


def _encode_one(c: Column, rng: Optional[KeyRange],
                opt: Optional[SortOptions] = None) -> List[SortKey]:
    """One column's key group, most significant first
    (_encode_one_traced, row_format.py:559-634).  `opt` is a sort's
    options; group and join keys pass None (ascending, nulls first, and
    day_time intervals in their int64 storage order)."""
    kind = key_kind(c)
    if isinstance(c, StringColumn):
        from .strings import dictionary_encode
        c = dictionary_encode(c)
    descending = opt is not None and opt.descending
    nulls_first = opt is None or opt.nulls_first
    vals, ranks, entry_valid, validity = key_parts(c)
    if kind == "float":
        isnan = torch.isnan(vals)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        clean = torch.where(isnan | (vals == 0), zero, vals)
        vkey, bits = float_order_key(clean)
        nan_key = isnan.to(torch.int64)
        if descending:
            vkey, nan_key = _flip(vkey, bits), 1 - nan_key
        values = [(nan_key, 1), (vkey, bits)]
    else:
        if kind == "dict":
            codes = vals.to(torch.int64)
            vkey = codes if ranks is None else ranks[codes]
            bits = _dict_bits(c)
            if entry_valid is not None:
                ev = entry_valid[codes]
                validity = ev if validity is None else validity & ev
        else:
            if opt is not None and c.dtype == dt.interval("day_time"):
                vals = vals ^ 0x80000000
            vkey, bits = int_order_key(vals, c.dtype, rng)
            if rng is not None and not rng.has_null:
                validity = None
        values = [(_flip(vkey, bits) if descending else vkey, bits)]
    keys: List[SortKey] = []
    if validity is not None:
        keys.append(SortKey((validity if nulls_first else ~validity)
                            .to(torch.int64), 1))
        values = [(torch.where(validity, v, 0), b) for v, b in values]
    return keys + [SortKey(v, b) for v, b in values]


def encode_key_groups(cols: Sequence[Column],
                      options: Optional[Sequence[SortOptions]] = None,
                      ranges: Optional[Sequence[Optional[KeyRange]]] = None
                      ) -> List[List[SortKey]]:
    """Each column's key group (encode_key_groups_traced,
    row_format.py:637-640); options[i] is column i's sort order,
    ranges[i] (integer and bool columns only) narrows its value key and
    drops its null class when it holds no null."""
    ranges = ranges or [None] * len(cols)
    options = options or [None] * len(cols)
    return [_encode_one(c, r, o) for c, r, o in zip(cols, ranges, options)]


def encode_keys(cols: Sequence[Column],
                ranges: Optional[Sequence[Optional[KeyRange]]] = None,
                options: Optional[Sequence[SortOptions]] = None
                ) -> List[SortKey]:
    """Key stack of several columns, first column most significant (see
    `encode_key_groups`)."""
    return [k for g in encode_key_groups(cols, options, ranges) for k in g]


def _layout(bits: Sequence[int]
            ) -> Tuple[List[Optional[Tuple[int, int]]], List[int]]:
    """Where `_pack_words` puts each key: (word, shift), None for 0-bit
    keys; and each word's bits, words most significant first.  Keys fill
    words from the last key up; a 64-bit key is a word of its own."""
    place: List[Optional[Tuple[int, int]]] = [None] * len(bits)
    used: List[int] = []                  # bits per word, last word first
    open_word = False
    for i in reversed(range(len(bits))):
        b = bits[i]
        if b == 0:
            continue
        if b >= 64:
            used.append(64)
            place[i], open_word = (len(used) - 1, 0), False
            continue
        if not open_word or used[-1] + b > _WORD_BITS:
            used.append(0)
            open_word = True
        place[i] = (len(used) - 1, used[-1])
        used[-1] += b
    last = len(used) - 1
    return ([None if p is None else (last - p[0], p[1]) for p in place],
            used[::-1])


def _pack_words(keys: Sequence[SortKey]) -> List[torch.Tensor]:
    """Pack consecutive keys into sortable words (signed order == key
    order), most significant first.  A 64-bit key is a word of its own
    (sign-flipped); 0-bit keys vanish; words of at most 31 bits are
    int32, halving the sort's traffic."""
    place, used = _layout([k.bits for k in keys])
    words: List[Optional[torch.Tensor]] = [None] * len(used)
    for k, p in zip(keys, place):
        if p is None:
            continue
        w, shift = p
        if k.bits >= 64:
            words[w] = k.values ^ _SIGN
            continue
        part = k.values << shift if shift else k.values
        words[w] = part if words[w] is None else words[w] | part
    return [w.to(torch.int32) if b <= 31 else w for w, b in zip(words, used)]


def _unpack(words: Sequence[torch.Tensor], keys: Sequence[SortKey],
            n: int, device) -> List[torch.Tensor]:
    """The keys held in packed words (the inverse of `_pack_words`)."""
    place, _ = _layout([k.bits for k in keys])
    out = []
    for k, p in zip(keys, place):
        if p is None:
            out.append(torch.zeros((n,), dtype=torch.int64, device=device))
            continue
        w, shift = p
        word = words[w].to(torch.int64)
        out.append(word ^ _SIGN if k.bits >= 64
                   else (word >> shift) & ((1 << k.bits) - 1))
    return out


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


def sorted_key_values(keys: Sequence[SortKey], n: int, device,
                      limit: Optional[int] = None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(stable order as int64, each key's values in that order), both
    cut to the first `limit` rows: the sort's words unpacked, so a key
    column decodes without a gather of the column."""
    order, words = sort_keys(keys, n, device)
    if limit is not None:
        order, words = order[:limit], [w[:limit] for w in words]
    return order, _unpack(words, keys, order.shape[0], device)


def group_has_null_key(kind: str, part) -> bool:
    """Whether one column's key group leads with a null class
    (row_format.py:650-656)."""
    _, _, entry_valid, validity = part
    if kind == "dict":
        return validity is not None or entry_valid is not None
    return validity is not None


def decode_sorted_group(kind: str, opt: SortOptions, has_null: bool,
                        group: Sequence[torch.Tensor], bits: Sequence[int],
                        dtype: dt.DataType, out_dtype: torch.dtype,
                        inv_slots: Optional[torch.Tensor] = None):
    """(values or dictionary codes, validity or None) of one column from
    its sorted key group (row_format.py:659-700): the inverse of
    `_encode_one` for integer, unsigned, bool, temporal (not interval)
    and dictionary columns (`inv_slots` maps a rank to its dictionary
    slot; None when codes are ranks).  Null rows decode to canonical
    zeros."""
    validity = None
    if has_null:
        validity = group[0] == (1 if opt.nulls_first else 0)
        group, bits = group[1:], bits[1:]
    v, b = group[0], bits[0]
    if opt.descending:
        v = _flip(v, b)
    if validity is not None:           # null rows decode as key 0
        v = torch.where(validity, v, 0)
    if kind == "dict":
        out = v if inv_slots is None else inv_slots[v]
    elif dtype.is_boolean or dtype.is_unsigned_integer:
        out = v
    elif dtype.byte_width == 8:
        out = v ^ _SIGN
    else:
        out = v - (1 << (8 * dtype.byte_width - 1))
    out = out.to(out_dtype)
    if validity is not None:
        out = torch.where(validity, out, torch.zeros((), dtype=out_dtype,
                                                     device=out.device))
    return out, validity


def lexsort_indices_fused(cols: Sequence[Column],
                          opts: Sequence[SortOptions],
                          limit: Optional[int] = None) -> torch.Tensor:
    """Stable sort indices (int64) of any mix of key columns, the first
    most significant (row_format.py:720-742).  With `limit`, the first
    `limit` of them: the stable prefix, the order of the reference's
    top_k, whose ties break by ascending index."""
    keys = encode_keys(cols, options=opts)
    n = len(cols[0])
    device = keys[0].values.device if keys else cols[0].device
    order = lexsort_order(keys, n, device)
    return order if limit is None else order[:limit]
