"""Order-preserving key encoding for sorts, group-bys and joins
(counterpart of arrow_tpu/ops/row_format.py: SortOptions, SortField,
key_kind, key_parts, _host_rankable, _pyval_key, _host_rank_parts,
dictionary_value_ranks, encode_value_key, Rows, RowConverter,
_decode_key, _encode_one_traced, group_has_null_key,
decode_sorted_group, lexsort_order_traced and lexsort_indices_fused,
row_format.py:50-742).

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
  decimal      64-bit limb keys, most significant first: the top limb
               sign-flipped, the lower limbs as unsigned
               (row_format.py:590-610); a decimal128 of precision <= 18
               whose top limbs are all the low limb's sign keys by its
               low limb alone, one word instead of two
  run-end      the decoded rows' keys (row_format.py:377-379,489-491)
  host         list, large list, list view, fixed-size list, fixed-size
               binary, struct, map and interval[month_day_nano]: dense
               comparator ranks from one Python key per row on the host
               (row_format.py:403-480), child nulls placed by nulls_first
               != descending

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

Unions and null columns are no sort or group key (the reference's
"sort key of" error).  `RowConverter` builds the reference's byte rows
(row_format.py:203-372): per fixed-width column a tag byte and the
8-byte big-endian `encode_value_key`, on the device; per string column
arrow-row's variable-length cells through the native host library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..config import in_fused_region
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, IntervalMDNColumn,
                           ListViewColumn, MapColumn, RunEndColumn)
from ..errors import ArrowNotImplementedError
from ..utils.trace import to_host

__all__ = ["SortOptions", "SortField", "SortKey", "KeyRange",
           "dictionary_value_ranks", "key_kind", "key_parts", "encode_keys",
           "encode_key_groups", "lexsort_order", "sort_keys",
           "sorted_key_values",
           "group_has_null_key", "decode_sorted_group",
           "lexsort_indices_fused", "float_order_key", "int_order_key",
           "encode_value_key", "host_ranks", "Rows", "RowConverter"]

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
        is_null = ~to_host("row_format.ranks", values.is_valid_mask()).numpy()
        ranks = np.zeros(len(vals), np.uint64)
        if (~is_null).any():
            _, inv = np.unique(vals[~is_null], return_inverse=True)
            ranks[~is_null] = inv.reshape(-1).astype(np.uint64)
        return ranks, is_null
    raise ArrowNotImplementedError(f"dictionary of {type(values).__name__}")


def _host_rankable(c: Column) -> bool:
    """Keys ranked by a comparator on the host (row_format.py:403-416):
    list, large list, list view, fixed-size list, fixed-size binary,
    struct, map and interval[month_day_nano] columns -- the reference's
    own design for these types (sort.rs:514 child_rank: rank on the CPU,
    then sort the ranks)."""
    return isinstance(c, (ListColumn, ListViewColumn, FixedSizeListColumn,
                          FixedSizeBinaryColumn, IntervalMDNColumn,
                          StructColumn, MapColumn))


def _pyval_key(v, d: dt.DataType, nf: bool):
    """Total-order key of a possibly-null Python value of type `d`;
    child nulls order by `nf` (row_format.py:419-424)."""
    if v is None:
        return (0,) if nf else (2,)
    return (1, _pyval_body(v, d, nf))


def _pyval_body(v, d: dt.DataType, nf: bool):
    """row_format.py:427-463: NaN above every float, lists and structs
    as tuples of their children's keys, month_day_nano as (months, days,
    nanoseconds), a map as its list of (key, value) entries."""
    n = d.name
    if d.is_floating:
        f = float(v)
        return (1, 0.0) if f != f else (0, f)
    if n in ("list", "large_list", "list_view", "large_list_view",
             "fixed_size_list"):
        return tuple(_pyval_key(x, d.value_type, nf) for x in v)
    if n == "struct":                  # a dict by field name
        return tuple(_pyval_key(v[f.name], f.dtype, nf) for f in d.fields)
    if n == "interval" and d.unit == "month_day_nano":
        m, dd, nn = v
        return (int(m), int(dd), int(nn))
    if n == "map":                     # (key, value) pairs
        kf, vf = d.value_type.fields
        return tuple((_pyval_key(k, kf.dtype, nf),
                      _pyval_key(x, vf.dtype, nf)) for k, x in v)
    if d.is_dictionary:
        return _pyval_body(v, d.value_type, nf)
    if isinstance(v, list):
        return tuple(v)
    return v


def host_ranks(c: Column, opt: Optional[SortOptions] = None
               ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """(dense comparator rank per row as int64 on the column's device,
    the number of ranks, validity) of a host-ranked column
    (_host_rank_parts, row_format.py:466-480): one Python key per row,
    ranked over the sorted distinct keys.  Child nulls sort first when
    nulls_first differs from descending (child_rank's inversion,
    sort.rs:516)."""
    desc = opt is not None and opt.descending
    nf = opt is None or opt.nulls_first
    py = c.to_pylist()
    keys = [_pyval_key(v, c.dtype, nf != desc) for v in py]
    rank_of = {k: i for i, k in enumerate(sorted(set(keys)))}
    ranks = np.fromiter((rank_of[k] for k in keys), np.int64, len(keys))
    validity = c.validity
    if validity is None and any(v is None for v in py):
        validity = torch.from_numpy(np.asarray([v is not None for v in py])
                                    ).to(c.device)
    return torch.from_numpy(ranks).to(c.device), len(rank_of), validity


def key_kind(c: Column) -> str:
    """'dict' (dictionaries and strings), 'float', 'uint' (bool and
    unsigned), 'int' (signed, temporal, decimal32/64), 'dec2' / 'dec4'
    (decimal128 / decimal256 limbs) or 'host' (host-ranked layouts); a
    run-end column is the kind of its decoded values (row_format.py:
    375-400).  Unions and null columns raise."""
    if isinstance(c, RunEndColumn):
        return key_kind(c.values)
    if isinstance(c, (DictionaryColumn, StringColumn)):
        return "dict"
    if isinstance(c, DecimalColumn):
        return f"dec{c.limbs.shape[1]}"
    if isinstance(c, PrimitiveColumn):
        d = c.dtype
        if d.is_floating:
            return "float"
        if d.is_boolean or d.is_unsigned_integer:
            return "uint"
        return "int"
    if _host_rankable(c):
        return "host"
    raise ArrowNotImplementedError(f"sort key of {type(c).__name__}")


def key_parts(c: Column):
    """(values, ranks, entry_valid, validity) of one dictionary, string or
    primitive key column (row_format.py:483-519); `_encode_one` keys
    run-end, decimal128/256 and host-ranked columns itself.  A
    dictionary's ranks are computed on the host and go to the device once
    (kept on its values, so `fuse` can capture a sort); ranks is None
    when the dictionary is value-sorted (codes are ranks), entry_valid
    None when it holds no null value.  A declared ordered flag is not
    trusted: ranks come from the values, as pyarrow orders them (ROADMAP
    C7.1); a dictionary from `dictionary_encode` carries its ranks, so
    its codes are taken as they are without a host pass.  A StringColumn
    is dictionary-encoded (row_format.py:494-496)."""
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


def _decimal_limb_keys(limbs: torch.Tensor, d: dt.DataType
                       ) -> List[Tuple[torch.Tensor, int]]:
    """The 64-bit keys of decimal128/256 limbs, most significant first
    (_encode_one_traced, row_format.py:590-610): the top limb with its
    sign bit flipped, then the lower limbs as unsigned.  A decimal128 of
    precision at most 18 whose top limb is only the sign of the low limb
    (one check on the device, skipped inside `fuse`) keys by its low
    limb alone, sign-flipped: the same order in one word."""
    k = limbs.shape[1]
    lo = limbs[:, 0]
    if k == 2 and d.precision <= 18 and not in_fused_region() and \
            torch.equal(limbs[:, 1], lo >> 63):
        return [(lo ^ _SIGN, 64)]
    return [(limbs[:, j] ^ _SIGN if j == k - 1 else limbs[:, j], 64)
            for j in range(k - 1, -1, -1)]


def _encode_one(c: Column, rng: Optional[KeyRange],
                opt: Optional[SortOptions] = None) -> List[SortKey]:
    """One column's key group, most significant first
    (_encode_one_traced, row_format.py:559-634).  `opt` is a sort's
    options; group and join keys pass None (ascending, nulls first, and
    day_time intervals in their int64 storage order).  A run-end column
    keys by its decoded rows."""
    if isinstance(c, RunEndColumn):
        from .ree import run_end_decode
        c = run_end_decode(c)
    kind = key_kind(c)
    if isinstance(c, StringColumn):
        from .strings import dictionary_encode
        c = dictionary_encode(c)
    descending = opt is not None and opt.descending
    nulls_first = opt is None or opt.nulls_first
    if kind == "host":
        vals, count, validity = host_ranks(c, opt)
        bits = max(count - 1, 0).bit_length()
        values = [(_flip(vals, bits) if descending else vals, bits)]
    elif kind.startswith("dec"):
        values = _decimal_limb_keys(c.limbs, c.dtype)
        if descending:
            values = [(~v, b) for v, b in values]
        validity = c.validity
    elif kind == "float":
        vals, _, _, validity = key_parts(c)
        isnan = torch.isnan(vals)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        clean = torch.where(isnan | (vals == 0), zero, vals)
        vkey, bits = float_order_key(clean)
        nan_key = isnan.to(torch.int64)
        if descending:
            vkey, nan_key = _flip(vkey, bits), 1 - nan_key
        values = [(nan_key, 1), (vkey, bits)]
    else:
        vals, ranks, entry_valid, validity = key_parts(c)
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


# ---- byte rows (RowConverter, row_format.py:203-372) -----------------------

@dataclass
class Rows:
    """memcmp-comparable rows (arrow-row Rows, lib.rs:1166): an (n,
    width) uint8 tensor on the columns' device; row i sorts before row j
    iff its bytes are lexicographically smaller.  `layout` holds each
    column's (byte offset, width)."""
    data: torch.Tensor
    fields: Tuple[SortField, ...]
    layout: Tuple[Tuple[int, int], ...]
    dtypes: Tuple[dt.DataType, ...]

    def __len__(self):
        return int(self.data.shape[0])

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def argsort(self) -> torch.Tensor:
        """Stable order of the rows by their bytes: uint32 values in an
        int32 tensor.  Eight bytes make one big-endian word, sign-flipped
        so signed order is byte order, and the words sort in stable
        passes from the last to the first."""
        n, w = self.data.shape
        if n == 0 or w == 0:
            return torch.arange(n, dtype=torch.int32, device=self.data.device)
        pad = -w % 8
        data = torch.nn.functional.pad(self.data, (0, pad)) if pad \
            else self.data
        words = data.reshape(n, -1, 8).flip(-1).contiguous() \
            .view(torch.int64).reshape(n, -1) ^ _SIGN
        order, _ = _lex_passes(list(words.t()))
        return order.to(torch.int32)


def _be_bytes(key: torch.Tensor) -> torch.Tensor:
    """(n, 8) big-endian bytes of u64 keys in int64 storage."""
    return key.unsqueeze(1).contiguous().view(torch.uint8).reshape(-1, 8) \
        .flip(-1)


def _from_be_bytes(b: torch.Tensor) -> torch.Tensor:
    """The u64 keys (int64 storage) of (n, 8) big-endian bytes."""
    return b.flip(-1).contiguous().view(torch.int64).reshape(-1)


class RowConverter:
    """Columns to comparable rows and back (arrow-row RowConverter,
    lib.rs:413,642,749; row_format.py:227-318).  A fixed-width column is
    a tag byte (0x01 valid; 0x00 null first, 0xFF null last) and its
    8-byte big-endian `encode_value_key`, inverted when descending, built
    on the column's device; a dictionary encodes its value rank, which
    orders within this converter's columns.  A string column takes
    arrow-row's variable-length cells (variable.rs:28-100) from the
    native host library, wide enough for its longest value, and goes to
    the device.  Other layouts raise, as in the reference."""

    def __init__(self, fields: Sequence[SortField]):
        self.fields = tuple(fields)

    def convert_columns(self, cols: Sequence[Column]) -> Rows:
        if len(cols) != len(self.fields):
            raise ValueError(f"{len(cols)} columns for {len(self.fields)} "
                             f"fields")
        parts, layout, offset = [], [], 0
        for col, f in zip(cols, self.fields):
            opt = f.options
            if isinstance(col, StringColumn):
                from ..utils import hostcodec
                offs = col.offsets.cpu().numpy().astype(np.int32)
                n = len(col)
                max_len = int((offs[1:] - offs[:-1]).max()) if n else 0
                valid = None if col.validity is None \
                    else col.validity.cpu().numpy()
                cells = hostcodec.encode_varlen_rows(
                    offs, col.data.cpu().numpy(), valid,
                    max(1, -(-max_len // 32)), opt.descending,
                    opt.nulls_first)
                parts.append(torch.from_numpy(cells).to(col.device))
            else:
                key, validity = encode_value_key(col)
                if opt.descending:
                    key = ~key
                tag = torch.ones((len(col), 1), dtype=torch.uint8,
                                 device=key.device)
                if validity is not None:
                    tag = torch.where(validity.unsqueeze(1), tag,
                                      0x00 if opt.nulls_first else 0xFF
                                      ).to(torch.uint8)
                    key = torch.where(validity, key, 0)
                parts.append(torch.cat([tag, _be_bytes(key)], 1))
            layout.append((offset, parts[-1].shape[1]))
            offset += parts[-1].shape[1]
        return Rows(torch.cat(parts, 1), self.fields, tuple(layout),
                    tuple(c.dtype for c in cols))

    def convert_rows(self, rows: Rows, like: Sequence[Column]
                     ) -> List[Column]:
        """The columns back from their rows; `like` gives each field's
        source column (a dictionary's values, a string's type)."""
        out: List[Column] = []
        host = None
        for (off, w), f, src in zip(rows.layout, self.fields, like):
            opt = f.options
            if isinstance(src, StringColumn):
                from ..utils import hostcodec
                if host is None:
                    host = rows.to_numpy()
                offs, data, valid = hostcodec.decode_varlen_rows(
                    host, off, (w - 1) // 33, opt.descending,
                    opt.nulls_first)
                mask = None if valid.all() else valid.view(bool)
                out.append(StringColumn.from_numpy(
                    offs, data, mask, src.dtype, device=rows.data.device))
                continue
            key = _from_be_bytes(rows.data[:, off + 1:off + 9])
            if opt.descending:
                key = ~key
            out.append(_decode_key(key, rows.data[:, off] == 0x01, src))
        return out


def _decode_key(key: torch.Tensor, validity: torch.Tensor, src: Column
                ) -> Column:
    """One column from its u64 value keys (row_format.py:321-363): the
    inverse of `encode_value_key`."""
    mask = None if bool(to_host("row_format.decode", validity.all())) \
        else validity
    d = src.dtype
    if isinstance(src, PrimitiveColumn):
        if d.is_floating:
            bits = torch.where(key < 0, key & ~_SIGN, ~key)
            f = bits.view(torch.float64)
            return PrimitiveColumn(f.to(d.to_torch()), d, mask)
        if d.is_boolean:
            return PrimitiveColumn(key != 0, d, mask)
        if d.is_unsigned_integer:
            return PrimitiveColumn(key.to(d.to_torch()), d, mask)
        if d == dt.interval("day_time"):
            # undo both flips of encode_value_key; the reference undoes
            # only the sign bit's (ROADMAP C11)
            key = key ^ 0x80000000
        return PrimitiveColumn((key ^ _SIGN).to(d.to_torch()), d, mask)
    if isinstance(src, DictionaryColumn):
        ranks, dict_null = dictionary_value_ranks(src.values)
        valid = np.nonzero(~dict_null)[0]
        nranks = int(ranks[valid].max()) + 1 if len(valid) else 0
        rank_to_code = np.zeros(max(nranks, 1), np.int64)
        rank_to_code[ranks[valid][::-1].astype(np.int64)] = valid[::-1]
        codes = torch.from_numpy(rank_to_code).to(key.device)[
            key.clamp(0, max(nranks - 1, 0))]
        return DictionaryColumn(codes.to(src.codes.dtype), src.values, mask)
    raise ArrowNotImplementedError(f"decode of {type(src).__name__}")


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
