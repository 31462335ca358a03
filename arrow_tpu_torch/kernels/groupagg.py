"""K2: fused grouped aggregation over dense codes (counterpart of
arrow_tpu/kernels/groupagg.py, kernels/groupminmax.py and
kernels/segagg.py).

One pass over codes in [0, G), G <= G_MAX; codes out of range are
dropped.  The codes come from one key column at its own width (1, 2, 4
or 8 bytes, bool included): a row's code is key - `base` (mod 2^64),
and G - 1 where `codes_valid` is False, so a caller with a range-scanned
key hands it over as it is, without a digit pass.  For each SumCol: a
wrapping-i64 SUM where null rows add 0, and a COUNT of valid rows (a
SumCol without values only counts).  For each MinMaxCol: MIN and MAX
over valid rows in order-key space.  Empty groups get the identities
(sum/count 0, min key UINT64_MAX, max key 0).  Every SumCol without
validity reads one shared count of in-range rows.

Order keys are u64 values held in int64 tensors (the same bits).  They
take the place of the reference's (hi, lo) i32 order planes, which
existed because Mosaic is 32-bit; `decode=False` returns them undecoded
as (min_keys, max_keys) so chunked callers can merge partials exactly,
the role of groupby.py::_merge_fast_agg.

Routing is by device: CPU tensors take `grouped_aggregate_plain`
(index_add_ and scatter_reduce on signed int64 keys: key ^ 1 << 63,
since CPU torch cannot order uint64); CUDA tensors launch the kernel in
csrc/groupagg.cu or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..config import on_cuda
from ..errors import ArrowInvalid
from ..utils.trace import span
from . import native

__all__ = ["G_MAX", "SumCol", "MinMaxCol", "grouped_aggregate",
           "grouped_aggregate_plain", "row_codes", "encode_order_key",
           "decode_order_key", "grouped_sum_count", "grouped_count",
           "grouped_min_max"]

G_MAX = 1024                      # the reference's bound (segagg.py:24)
_SIGN = -(1 << 63)                # int64 bits of 1 << 63
_UNSIGNED, _SIGNED, _FLOAT = 0, 1, 2
_SUM, _MINMAX = 0, 1              # slot kinds of csrc/groupagg.cu


@dataclass
class SumCol:
    """SUM/COUNT request: integer values (None: count only) + optional
    validity.  `dtype` is the logical type of the values (needed to tell
    unsigned from signed storage); None means the storage's own type."""
    values: Optional[torch.Tensor]
    valid: Optional[torch.Tensor] = None
    dtype: Optional[dt.DataType] = None


@dataclass
class MinMaxCol:
    """MIN/MAX request: integer or float values + optional validity."""
    values: torch.Tensor
    valid: Optional[torch.Tensor] = None
    dtype: Optional[dt.DataType] = None
    want_min: bool = True
    want_max: bool = True


def _logical(values: torch.Tensor, dtype: Optional[dt.DataType]
             ) -> dt.DataType:
    d = dtype or dt.from_numpy_dtype(dt.torch_dtype_name(values.dtype))
    if d.to_torch() != values.dtype:
        raise ArrowInvalid(f"{d!r} does not match storage {values.dtype}")
    return d


def _cls(d: dt.DataType) -> int:
    if d.is_signed_integer:
        return _SIGNED
    if d.is_unsigned_integer:
        return _UNSIGNED
    if d.is_floating:
        return _FLOAT
    raise ArrowInvalid(f"grouped aggregate of {d!r}")


def _f32_bits(values: torch.Tensor) -> torch.Tensor:
    """f32 bits (as int64) of f16/f32 values; f16 widens exactly and a
    NaN gets the quiet bit, as XLA's convert does."""
    if values.dtype == torch.float32:
        return values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = values.view(torch.int16).to(torch.int64) & 0xFFFF
    nan = ((h & 0x8000) << 16) | 0x7FC00000 | ((h & 0x3FF) << 13)
    wide = values.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    return torch.where(torch.isnan(values), nan, wide)


def encode_order_key(values: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """u64 order keys (int64 storage): key order == value order.  Signed
    ints flip the sign bit (arrow-row fixed.rs:47); unsigned keep their
    bits; f16/f32 put the IEEE totalOrder map of the f32 bits in the high
    word (groupminmax.py:63-73: NaN above +inf); f64 uses the 64-bit map.
    """
    if d.is_signed_integer:
        return values.to(torch.int64) ^ _SIGN
    if d.is_unsigned_integer:
        return dt.widen(values, d)
    if d.name == "float64":
        bits = values.view(torch.int64)
        return torch.where(bits < 0, ~bits, bits | _SIGN)
    if d.name in ("float16", "float32"):
        b = _f32_bits(values)
        key32 = torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
        return key32 << 32
    raise ArrowInvalid(f"order key of {d!r}")


def decode_order_key(key: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Inverse of encode_order_key, in d's storage dtype.  Gives the
    reference's exact bits (decode_order_value), identities and NaN
    payloads included: narrowing truncates, and f32 -> f16 NaNs keep
    sign | 0x7E00 | the top payload bits, as XLA's convert does."""
    storage = d.to_torch()
    if d.is_signed_integer:
        return (key ^ _SIGN).to(storage)
    if d.is_unsigned_integer:
        return key.to(storage)
    if d.name == "float64":
        return torch.where(key < 0, key ^ _SIGN, ~key).view(torch.float64)
    if d.name not in ("float16", "float32"):
        raise ArrowInvalid(f"order key of {d!r}")
    key32 = (key >> 32) & 0xFFFFFFFF
    bits = torch.where(key32 >= 0x80000000, key32 & 0x7FFFFFFF,
                       ~key32 & 0xFFFFFFFF)
    f32 = bits.to(torch.int32).view(torch.float32)
    if d.name == "float32":
        return f32
    nan = ((bits >> 16) & 0x8000) | 0x7E00 | ((bits & 0x7FFFFF) >> 13)
    h = torch.where(torch.isnan(f32), nan.to(torch.int16),
                    f32.to(torch.float16).view(torch.int16))
    return h.view(torch.float16)


def _key_type(codes: torch.Tensor, codes_dtype: Optional[dt.DataType]
              ) -> dt.DataType:
    d = _logical(codes, codes_dtype)
    if not (d.is_integer or d.is_boolean):
        raise ArrowInvalid(f"grouped_aggregate: codes of {d!r}")
    return d


def _check_args(codes, num_groups, sum_cols, mm_cols, base, codes_valid,
                codes_dtype):
    if codes.dim() != 1 or not codes.is_contiguous() \
            or codes.element_size() not in (1, 2, 4, 8):
        raise ArrowInvalid("codes must be a contiguous 1-D tensor of 1, 2, "
                           "4 or 8-byte integers")
    _key_type(codes, codes_dtype)
    if not 0 < num_groups <= G_MAX:
        raise ArrowInvalid(f"grouped_aggregate: num_groups must be in "
                           f"[1, {G_MAX}], got {num_groups}")
    if not -(1 << 63) <= base < 1 << 64:
        raise ArrowInvalid(f"grouped_aggregate: base {base} is not a 64-bit "
                           f"integer")
    n = codes.shape[0]
    tensors = [(codes_valid, "codes_valid")]
    for c in (*sum_cols, *mm_cols):
        tensors += [(c.values, "values"), (c.valid, "valid")]
    for t, what in tensors:
        if t is None:
            continue
        if t.dim() != 1 or t.shape[0] != n or t.device != codes.device \
                or not t.is_contiguous():
            raise ArrowInvalid(f"grouped_aggregate: {what} must be "
                               f"contiguous ({n},) on {codes.device}")
        if what != "values" and t.dtype != torch.bool:
            raise ArrowInvalid(f"grouped_aggregate: {what} must be bool")
    for c in sum_cols:
        if c.values is not None and not _logical(c.values, c.dtype).is_integer:
            raise ArrowInvalid("grouped_aggregate: sums need integer values")
    for c in mm_cols:
        _cls(_logical(c.values, c.dtype))


def row_codes(codes: torch.Tensor, num_groups: int, base: int = 0,
              codes_valid: Optional[torch.Tensor] = None,
              codes_dtype: Optional[dt.DataType] = None) -> torch.Tensor:
    """Each row's int64 code as the kernel computes it: codes - base
    (mod 2^64), num_groups - 1 where codes_valid is False; a code
    outside [0, num_groups) drops its row."""
    c = dt.widen(codes, _key_type(codes, codes_dtype)) - dt.storage_int(base)
    if codes_valid is not None:
        c = torch.where(codes_valid, c, num_groups - 1)
    return c


def grouped_aggregate_plain(codes: torch.Tensor, num_groups: int,
                            sum_cols: Sequence[SumCol] = (),
                            mm_cols: Sequence[MinMaxCol] = (),
                            base: int = 0,
                            codes_valid: Optional[torch.Tensor] = None,
                            codes_dtype: Optional[dt.DataType] = None):
    """The kernel's plain PyTorch version: (sums, counts, [(min_keys,
    max_keys)]), every entry an int64 (G,) tensor."""
    G = num_groups
    c64 = row_codes(codes, G, base, codes_valid, codes_dtype)
    in_range = (c64 >= 0) & (c64 < G)

    def buckets(valid):            # dropped rows land in bucket G
        ok = in_range if valid is None else in_range & valid
        return torch.where(ok, c64, G)

    def zeros():
        return torch.zeros(G + 1, dtype=torch.int64, device=codes.device)

    sums, counts, keys = [], [], []
    ones = torch.ones((), dtype=torch.int64, device=codes.device) \
        .expand(codes.shape[0])
    count_all = None
    for c in sum_cols:
        b = buckets(c.valid)
        if c.valid is not None:
            counts.append(zeros().index_add_(0, b, ones)[:G])
        else:
            if count_all is None:
                count_all = zeros().index_add_(0, b, ones)[:G]
            counts.append(count_all)
        s = zeros()
        if c.values is not None:
            s.index_add_(0, b, dt.widen(c.values,
                                        _logical(c.values, c.dtype)))
        sums.append(s[:G])
    for c in mm_cols:
        b = buckets(c.valid)
        skey = encode_order_key(c.values, _logical(c.values, c.dtype)) ^ _SIGN
        mn = torch.full((G + 1,), torch.iinfo(torch.int64).max,
                        dtype=torch.int64, device=codes.device)
        mx = torch.full((G + 1,), torch.iinfo(torch.int64).min,
                        dtype=torch.int64, device=codes.device)
        mn.scatter_reduce_(0, b, skey, "amin")
        mx.scatter_reduce_(0, b, skey, "amax")
        keys.append((mn[:G] ^ _SIGN, mx[:G] ^ _SIGN))
    return sums, counts, keys


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(codes: torch.Tensor, G: int, sum_cols: Sequence[SumCol],
            mm_cols: Sequence[MinMaxCol], base: int,
            codes_valid: Optional[torch.Tensor],
            codes_dtype: Optional[dt.DataType]):
    """Launches of csrc/groupagg.cu, each a full pass over the codes.
    Shared memory per group: 4 B for the count of in-range rows (every
    SumCol without validity reads it), 8 B for a sum, 4 B for a count of
    valid rows, 8 B for a min/max of 4 bytes or fewer and 16 B above.
    Slots past one block's shared memory (or past
    `atp_groupagg_max_slots`) go to further launches: at G = 1,024, 14
    min/max slots of 8 bytes ride one launch."""
    lib = native.library().lib
    dev = codes.device
    rows, sizes = [], []      # slot descriptors and their outputs' offsets
    n_out = 0

    def region():
        nonlocal n_out
        n_out += G
        return n_out - G

    cnt_all = region() if any(c.valid is None for c in sum_cols) else -1
    sum_at, cnt_at, mm_at = [], [], []
    for c in sum_cols:
        d = None if c.values is None else _logical(c.values, c.dtype)
        s_off = -1 if d is None else region()
        c_off = cnt_all if c.valid is None else region()
        sum_at.append(s_off)
        cnt_at.append(c_off)
        if d is None and c.valid is None:
            continue                       # the shared count is its count
        rows.append([_ptr(c.values), _ptr(c.valid), _SUM,
                     1 if d is None else d.byte_width,
                     _UNSIGNED if d is None else _cls(d), s_off,
                     -1 if c.valid is None else c_off])
        sizes.append((0 if d is None else 8) + (0 if c.valid is None else 4))
    for c in mm_cols:
        d = _logical(c.values, c.dtype)
        mn, mx = region(), region()
        mm_at.append((mn, mx))
        rows.append([_ptr(c.values), _ptr(c.valid), _MINMAX, d.byte_width,
                     _cls(d), mn, mx])
        sizes.append(16 if d.byte_width == 8 else 8)

    out = torch.zeros(max(n_out, 1), dtype=torch.int64, device=dev)
    for mn, _ in mm_at:
        out[mn:mn + G] = -1                # min identity UINT64_MAX
    kd = _key_type(codes, codes_dtype)
    budget = (lib.atp_groupagg_smem_limit() - 4) // G   # bytes a group
    batches, batch, used = [], [], 4 if cnt_all >= 0 else 0
    for row, size in zip(rows, sizes):
        if batch and (used + size > budget
                      or len(batch) == lib.atp_groupagg_max_slots()):
            batches.append(batch)
            batch, used = [], 0
        batch.append(row)
        used += size
    if batch or cnt_all >= 0:
        batches.append(batch)
    for i, batch in enumerate(batches):
        # read by the C entry before it returns: host memory, no upload
        desc = (ctypes.c_longlong * max(7 * len(batch), 1))(
            *[v for row in batch for v in row])
        status = lib.atp_groupagg(
            dev.index, codes.data_ptr(), _ptr(codes_valid),
            dt.storage_int(base), codes.element_size(),
            int(kd.is_signed_integer), codes.shape[0], G, desc,
            len(batch), cnt_all if i == 0 else -1, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        grouped_aggregate.launches += 1
        native.check(status, "grouped_aggregate kernel")
    zeros = torch.zeros(G, dtype=torch.int64, device=dev)
    sums = [zeros if s < 0 else out[s:s + G] for s in sum_at]
    counts = [out[c:c + G] for c in cnt_at]
    keys = [(out[mn:mn + G], out[mx:mx + G]) for mn, mx in mm_at]
    return sums, counts, keys


def grouped_aggregate(codes: torch.Tensor, num_groups: int,
                      sum_cols: Sequence[SumCol] = (),
                      mm_cols: Sequence[MinMaxCol] = (),
                      decode: bool = True, *, base: int = 0,
                      codes_valid: Optional[torch.Tensor] = None,
                      codes_dtype: Optional[dt.DataType] = None):
    """All grouped aggregates in one pass (groupagg.py:248).

    `codes` is a key column of 1, 2, 4 or 8-byte integers or bools of
    logical type `codes_dtype` (None: its storage's own type); a row's
    code is codes - base (mod 2^64), or num_groups - 1 where
    `codes_valid` is False (see `row_codes`).

    Returns (sums, counts, minmaxes): sums[i] / counts[i] are int64 (G,)
    for sum_cols[i]; minmaxes[j] is a (min, max) pair decoded to
    mm_cols[j]'s type, an entry None when not requested.  With
    decode=False, minmaxes[j] is the undecoded (min_keys, max_keys) pair,
    identities still distinct from real extremes, for exact merges.
    """
    sum_cols, mm_cols = tuple(sum_cols), tuple(mm_cols)
    _check_args(codes, num_groups, sum_cols, mm_cols, base, codes_valid,
                codes_dtype)
    run = _launch if on_cuda(codes) else grouped_aggregate_plain
    with span("kernel.k2", rows=codes.shape[0]):
        sums, counts, keys = run(codes, num_groups, sum_cols, mm_cols, base,
                                 codes_valid, codes_dtype)
    if not decode:
        return sums, counts, keys
    minmaxes = []
    for c, (mn, mx) in zip(mm_cols, keys):
        d = _logical(c.values, c.dtype)
        minmaxes.append((decode_order_key(mn, d) if c.want_min else None,
                         decode_order_key(mx, d) if c.want_max else None))
    return sums, counts, minmaxes


grouped_aggregate.launches = 0   # kernel launches; plain calls add nothing


def grouped_sum_count(values: torch.Tensor, codes: torch.Tensor,
                      valid: Optional[torch.Tensor], num_groups: int,
                      dtype: Optional[dt.DataType] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) per group for integer values (segagg.py:27)."""
    sums, counts, _ = grouped_aggregate(
        codes, num_groups, sum_cols=[SumCol(values, valid, dtype)])
    return sums[0], counts[0]


def grouped_count(codes: torch.Tensor, valid: Optional[torch.Tensor],
                  num_groups: int) -> torch.Tensor:
    """COUNT per group of valid rows (segagg.py:43); a count-only slot,
    with no zeros column behind it."""
    _, counts, _ = grouped_aggregate(codes, num_groups,
                                     sum_cols=[SumCol(None, valid)])
    return counts[0]


def grouped_min_max(values: torch.Tensor, codes: torch.Tensor,
                    valid: Optional[torch.Tensor], num_groups: int,
                    dtype: Optional[dt.DataType] = None,
                    want_min: bool = True, want_max: bool = True
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Null-skipping per-group (min, max) (groupminmax.py:114); empty
    groups hold identities that callers mask with valid counts."""
    _, _, mms = grouped_aggregate(
        codes, num_groups,
        mm_cols=[MinMaxCol(values, valid, dtype, want_min, want_max)])
    return mms[0]
