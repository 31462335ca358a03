"""Table-level distributed operators (counterpart of
arrow_tpu/parallel/api.py:53-460): the per-shard bodies of parallel/dist.py
run over a mesh (`mesh.shard_map`) under the engine's Table surface.

  * multi-key, string and dictionary key columns encode into ONE u64 per
    row (int64 storage) through the order-preserving value keys of
    ops/row_format.py, bit-packed most-significant field first, so that
    lexicographic order and group identity survive the packing;
  * payload columns ride the shuffle as raw value tensors (and validity
    planes); string payloads ride as dictionary codes;
  * outputs are trimmed of capacity padding on the table's device (one
    K1 compaction, kernels/compact.py) and decoded back into columns.

Packing needs each field's key range: one small host read per key
column.  Fields whose combined width exceeds 63 bits raise
ArrowNotImplementedError rather than collide.  Each call then reads the
device once more, for the overflow flag and the kept count together, and
raises ArrowInvalid on overflow.  `mesh` has no default: the reference's
defaults to every JAX device, the port names its devices.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..kernels.compact import compact
from ..ops.groupby import AggSpec, _agg_dtype
from ..ops.row_format import SortOptions, _decode_key, encode_value_key
from . import dist
from .mesh import LocalMesh, shard_map

__all__ = ["dist_table_group_by", "dist_table_sort", "dist_table_join",
           "pack_key_columns"]

_SIGN = -(1 << 63)
_U64 = (1 << 64) - 1
_ROWS = 0                      # shard_map's P(axis)


# ---------------------------------------------------------------------------
# key packing

class _KeyPlan:
    """Per-field (bits, vmin, nullable, src_column, opts) for one packed
    u64; vmin is the field's least value key, a u64 as a Python int."""

    def __init__(self, fields):
        self.fields = fields
        self.total_bits = sum(b + (1 if nu else 0)
                              for b, _, nu, _, _ in fields)


def _as_dict_src(col: Column) -> Column:
    """The column whose type `_decode_key` can invert (strings decode
    through their on-the-fly dictionary)."""
    if isinstance(col, StringColumn):
        from ..ops.strings import dictionary_encode
        return dictionary_encode(col)
    return col


def _storage(u: int) -> int:
    """A u64 Python int as the int64 with its bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _key_range(vkey: torch.Tensor, validity: Optional[torch.Tensor]):
    """(validity or None when all rows are valid, vmin, vmax): the u64
    range of the valid value keys, (0, 0) when there is none.  One host
    read."""
    o = vkey ^ _SIGN                      # u64 order as int64 order
    big, small = (1 << 63) - 1, _SIGN
    if validity is None:
        validity_all = torch.ones((), dtype=torch.bool, device=o.device)
        lo, hi = o.min(), o.max()
        anyv = validity_all
    else:
        validity_all = validity.all()
        anyv = validity.any()
        lo = torch.where(validity, o, big).min()
        hi = torch.where(validity, o, small).max()
    all_v, any_v, lo, hi = torch.stack(
        [validity_all.to(torch.int64), anyv.to(torch.int64), lo, hi]).tolist()
    if not any_v:
        return validity, 0, 0
    return (None if all_v else validity,
            (lo ^ _SIGN) & _U64, (hi ^ _SIGN) & _U64)


def pack_key_columns(cols: Sequence[Column],
                     opts: Optional[Sequence[SortOptions]] = None
                     ) -> Tuple[torch.Tensor, _KeyPlan]:
    """Encode key columns into ONE order-preserving u64 per row (int64
    storage, below 2^63).

    Each column contributes an (optional null bit, rebased value key)
    field, most significant column first; with `opts`, descending fields
    invert within their width and nulls_first sets the null bit's
    polarity, so the packed key's order IS the requested lexicographic
    order, and equality IS row equality.  Null keys are real values here
    (their own group or sort position), unlike the dist bodies' `valid`
    mask, which marks padding only.
    """
    if opts is None:
        opts = [SortOptions()] * len(cols)
    fields, vkeys = [], []
    for col, opt in zip(cols, opts):
        src = _as_dict_src(col)
        vkey, validity = encode_value_key(src)
        if vkey.shape[0]:
            validity, vmin, vmax = _key_range(vkey, validity)
        else:
            validity, vmin, vmax = None, 0, 0
        bits = max(int(vmax - vmin).bit_length(), 1)
        fields.append((bits, vmin, validity is not None, src, opt))
        vkeys.append((vkey, validity))
    total = sum(b + (1 if nu else 0) for b, _, nu, _, _ in fields)
    if total > 63:
        raise ArrowNotImplementedError(
            f"distributed key too wide: {total} bits packed (>63); "
            "reduce key columns or cardinality")

    packed = torch.zeros(len(cols[0]), dtype=torch.int64,
                         device=cols[0].device)
    for (bits, vmin, nullable, _, opt), (vkey, validity) in zip(fields,
                                                                vkeys):
        mask = (1 << bits) - 1
        digit = (vkey - _storage(vmin)) & mask
        if opt.descending:
            digit = mask - digit
        if nullable:
            null_bit = (validity if opt.nulls_first else ~validity) \
                .to(torch.int64)
            digit = torch.where(validity, digit, 0)
            packed = (packed << (bits + 1)) | (null_bit << bits) | digit
        else:
            packed = (packed << bits) | digit
    return packed, _KeyPlan(fields)


def _unpack_keys(packed: torch.Tensor, plan: _KeyPlan) -> List[Column]:
    """Invert pack_key_columns over (trimmed) group keys."""
    pieces, shift = [], 0
    for bits, _, nullable, _, _ in reversed(plan.fields):
        w = bits + (1 if nullable else 0)
        pieces.append((packed >> shift) & ((1 << w) - 1))
        shift += w
    out = []
    for (bits, vmin, nullable, src, opt), field in zip(plan.fields,
                                                       reversed(pieces)):
        mask = (1 << bits) - 1
        digit = field & mask
        if opt.descending:
            digit = mask - digit
        vkey = digit + _storage(vmin)
        if nullable:
            null_bit = (field >> bits) & 1
            validity = (null_bit == 1) if opt.nulls_first \
                else (null_bit == 0)
        else:
            validity = torch.ones(field.shape, dtype=torch.bool,
                                  device=field.device)
        out.append(_decode_key(vkey, validity, src))
    return out


# ---------------------------------------------------------------------------
# payload packing

def _payload_arrays(col: Column):
    """(arrays, rebuild): raw tensors that ride the shuffle, and a closure
    turning the shuffled tensors back into a Column."""
    inner_string = isinstance(col, StringColumn)
    if inner_string:
        from ..ops.strings import dictionary_encode
        col = dictionary_encode(col)
    if isinstance(col, DictionaryColumn):
        values = col.values
        arrs = [col.codes]
        has_mask = col.validity is not None
        if has_mask:
            arrs.append(col.validity)

        def rebuild(arrs_out):
            d = DictionaryColumn(arrs_out[0], values,
                                 arrs_out[1] if has_mask else None)
            if inner_string:
                from ..ops.cast import cast
                return cast(d, values.dtype)
            return d
        return arrs, rebuild
    if isinstance(col, PrimitiveColumn):
        arrs = [col.values]
        has_mask = col.validity is not None
        dtype = col.dtype
        if has_mask:
            arrs.append(col.validity)

        def rebuild(arrs_out):
            return PrimitiveColumn(arrs_out[0], dtype,
                                   arrs_out[1] if has_mask else None)
        return arrs, rebuild
    raise ArrowNotImplementedError(
        f"distributed payload of {type(col).__name__}")


def _pad(arr: torch.Tensor, n: int) -> torch.Tensor:
    if arr.shape[0] == n:
        return arr
    pad = torch.zeros((n - arr.shape[0],) + tuple(arr.shape[1:]),
                      dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _pad_all(arrays: Sequence[torch.Tensor], n: int) -> list:
    """_pad of each array; one padded copy of a tensor passed twice."""
    done = {}
    return [done.setdefault(id(a), _pad(a, n)) for a in arrays]


def _trim(mask: torch.Tensor, over: torch.Tensor,
          arrays: Sequence[torch.Tensor], what: str) -> list:
    """The rows where `mask`, in order, of every array: one K1
    compaction on the device, then one host read of the overflow flag
    and the kept count together; raises ArrowInvalid on overflow."""
    outs, count = compact(mask, arrays)
    over, count = torch.stack([over.to(torch.int64), count]).tolist()
    if over:
        raise ArrowInvalid(f"distributed {what} capacity overflow")
    return [o[:count] for o in outs]


def _padded_rows(n: int, mesh: LocalMesh) -> int:
    """n rounded up to a whole row block a shard (at least one row)."""
    return max(math.ceil(n / mesh.size), 1) * mesh.size


def _ones(n: int, n_pad: int, device) -> torch.Tensor:
    return _pad(torch.ones(n, dtype=torch.bool, device=device), n_pad)


_UNSIGNED_ON_SIGNED = {torch.int16: -(1 << 15), torch.int32: -(1 << 31),
                       torch.int64: _SIGN}


def _minmax_order_bit(col: PrimitiveColumn) -> Optional[int]:
    """The sign bit to flip so that signed storage of an unsigned type
    orders as the type does (None where the storage already does)."""
    if not col.dtype.is_unsigned_integer:
        return None
    return _UNSIGNED_ON_SIGNED.get(col.values.dtype)


# ---------------------------------------------------------------------------
# operators

def dist_table_group_by(table: Table, keys: Sequence[str],
                        aggs: Sequence[AggSpec], mesh: LocalMesh,
                        group_cap: Optional[int] = None) -> Table:
    """Distributed GROUP BY over a mesh: hash-shuffle rows by the packed
    key, aggregate per shard (`dist.dist_group_by`), trim the padding,
    decode keys, and return one Table (rows in packed-key order).

    Aggregate source columns must be non-nullable primitives (the dist
    bodies carry raw value tensors); key columns may be any packable mix
    of int, string and dictionary, nulls included (a null key is its own
    group, Arrow semantics).  The shuffle is lossless: each shard sends
    up to its whole row block to every shard, so the mesh holds
    n_shards^2 * n slab rows; `group_cap` defaults to lossless too.
    """
    key_cols = [table.column(k) for k in keys]
    packed, plan = pack_key_columns(key_cols)

    sources, flips = [], []
    for a in aggs:
        if a.op not in ("sum", "count", "min", "max"):
            raise ArrowNotImplementedError(f"distributed aggregate {a.op}")
        c = table.column(a.column)
        if not isinstance(c, PrimitiveColumn) or c.validity is not None:
            nullable = getattr(c, "validity", None) is not None
            raise ArrowNotImplementedError(
                "distributed aggregate sources must be non-nullable "
                f"primitives; {a.column} is {type(c).__name__}"
                f"{' (nullable)' if nullable else ''}")
        flip = _minmax_order_bit(c) if a.op in ("min", "max") else None
        sources.append(c.values if flip is None else c.values ^ flip)
        flips.append(flip)

    n = table.num_rows
    n_pad = _padded_rows(n, mesh)
    if group_cap is None:
        group_cap = n_pad            # lossless upper bound
    shuffle_cap = n_pad              # lossless
    ops = [a.op for a in aggs]

    def body(comm, k, ok, *vs):
        gk, gv, outs, over = dist.dist_group_by(
            comm, k, ok, shuffle_cap, group_cap, list(zip(ops, vs)))
        return gk, gv, tuple(outs), over

    step = shard_map(body, mesh, in_specs=(_ROWS,) * (2 + len(sources)),
                     out_specs=(_ROWS, _ROWS, (_ROWS,) * len(sources), None))
    gk, gv, outs, over = step(_pad(packed, n_pad),
                              _ones(n, n_pad, packed.device),
                              *_pad_all(sources, n_pad))
    gk_t, *outs_t = _trim(gv, over, [gk, *outs], "group_by")
    # packed keys are below 2^63: int64 order is their u64 order
    gk_t, order = torch.sort(gk_t, stable=True)

    cols = _unpack_keys(gk_t, plan)
    fields = [dt.Field(k, c.dtype, nullable=table.schema.field(k).nullable)
              for k, c in zip(keys, cols)]
    for a, o, flip in zip(aggs, outs_t, flips):
        out_dt = _agg_dtype(table.column(a.column).dtype, a.op)
        o = o[order]
        if flip is not None:
            o = o ^ flip
        cols.append(PrimitiveColumn(o.to(out_dt.to_torch()), out_dt))
        fields.append(dt.Field(a.out_name, out_dt, nullable=False))
    return Table(tuple(cols), dt.Schema(tuple(fields)))


def _payloads(columns) -> Tuple[list, list, list]:
    arrays, rebuilds, counts = [], [], []
    for c in columns:
        arrs, rb = _payload_arrays(c)
        arrays.extend(arrs)
        rebuilds.append(rb)
        counts.append(len(arrs))
    return arrays, rebuilds, counts


def _rebuild(trimmed: list, rebuilds: list, counts: list) -> list:
    cols, i = [], 0
    for rb, cnt in zip(rebuilds, counts):
        cols.append(rb(trimmed[i:i + cnt]))
        i += cnt
    return cols


def dist_table_sort(table: Table, keys: Sequence[str],
                    options: Optional[Sequence[SortOptions]] = None, *,
                    mesh: LocalMesh) -> Table:
    """Distributed multi-key sort: pack the sort key (descending and
    nulls_first folded into the packing), range-partition and sort
    locally over the mesh (`dist.dist_sort`), then reassemble the
    globally sorted Table (shard i's rows all precede shard i+1's).
    Equal keys keep their input order."""
    key_cols = [table.column(k) for k in keys]
    if options is None:
        options = [SortOptions()] * len(keys)
    packed, _ = pack_key_columns(key_cols, options)
    pays, rebuilds, counts = _payloads(table.columns)

    n = table.num_rows
    n_pad = _padded_rows(n, mesh)
    capacity = n_pad                 # lossless (skew-safe) capacity

    def body(comm, k, ok, *ps):
        sk, svalid, spays, over = dist.dist_sort(comm, k, ok, capacity, ps)
        return svalid, spays, over

    step = shard_map(body, mesh, in_specs=(_ROWS,) * (2 + len(pays)),
                     out_specs=(_ROWS, (_ROWS,) * len(pays), None))
    svalid, spays, over = step(_pad(packed, n_pad),
                               _ones(n, n_pad, packed.device),
                               *_pad_all(pays, n_pad))
    trimmed = _trim(svalid, over, spays, "sort")
    return Table(tuple(_rebuild(trimmed, rebuilds, counts)), table.schema)


def dist_table_join(left: Table, right: Table, keys: Sequence[str],
                    mesh: LocalMesh) -> Table:
    """Distributed many-to-many inner join on `keys` (the same names in
    both tables): pack keys, co-shuffle both sides by key hash, expand
    match pairs per shard (`dist.dist_join`), trim, and reassemble the
    left columns and the right's non-key columns.

    Null keys never match (SQL inner-join semantics): rows whose packed
    key has a null field are masked out before the shuffle.
    """
    from ..ops.concat import concat
    lk_cols = [left.column(k) for k in keys]
    rk_cols = [right.column(k) for k in keys]
    # one shared packing domain: pack the concatenation, split back
    both = [concat([lc, rc]) for lc, rc in zip(lk_cols, rk_cols)]
    packed_all, _ = pack_key_columns(both)
    nl, nr = left.num_rows, right.num_rows
    lpacked, rpacked = packed_all[:nl], packed_all[nl:]

    def null_free(cols, m):
        ok = torch.ones(m, dtype=torch.bool, device=packed_all.device)
        for c in cols:
            if getattr(c, "validity", None) is not None:
                ok = ok & c.validity
        return ok

    l_pays, l_rb, l_cnt = _payloads(left.columns)
    r_names = [name for name in right.schema.names if name not in keys]
    r_pays, r_rb, r_cnt = _payloads([right.column(nm) for nm in r_names])

    nl_pad, nr_pad = _padded_rows(nl, mesh), _padded_rows(nr, mesh)
    out_cap = 2 * (nl_pad + nr_pad)  # per-shard expansion capacity
    n_l = len(l_pays)

    def body(comm, lk, lok, lv, rk, rok, rv):
        out_valid, _, out_l, out_r, over = dist.dist_join(
            comm, lk, lok, lv, rk, rok, rv, nl_pad, nr_pad, out_cap)
        return out_valid, tuple(out_l), tuple(out_r), over

    step = shard_map(body, mesh,
                     in_specs=(_ROWS,) * 6,
                     out_specs=(_ROWS, (_ROWS,) * n_l,
                                (_ROWS,) * len(r_pays), None))
    ov, outs_l, outs_r, over = step(
        _pad(lpacked.contiguous(), nl_pad), _pad(null_free(lk_cols, nl),
                                                 nl_pad),
        tuple(_pad_all(l_pays, nl_pad)),
        _pad(rpacked.contiguous(), nr_pad), _pad(null_free(rk_cols, nr),
                                                 nr_pad),
        tuple(_pad_all(r_pays, nr_pad)))
    trimmed = _trim(ov, over, list(outs_l) + list(outs_r), "join")

    cols = _rebuild(trimmed[:n_l], l_rb, l_cnt)
    fields = list(left.schema.fields)
    for name, c in zip(r_names, _rebuild(trimmed[n_l:], r_rb, r_cnt)):
        cols.append(c)
        fields.append(dt.Field(name, c.dtype))
    return Table(tuple(cols), dt.Schema(tuple(fields)))
