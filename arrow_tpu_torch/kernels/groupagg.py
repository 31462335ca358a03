"""K2: fused grouped aggregation over dense codes (counterpart of
arrow_tpu/kernels/groupagg.py, kernels/groupminmax.py and
kernels/segagg.py).

One pass over codes in [0, G), G <= G_MAX; codes out of range are
dropped.  For each SumCol: a wrapping-i64 SUM where null rows add 0, and
a COUNT of valid rows (a SumCol without values only counts).  For each
MinMaxCol: MIN and MAX over valid rows in order-key space.  Empty groups
get the identities (sum/count 0, min key UINT64_MAX, max key 0).

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

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..config import on_cuda
from ..errors import ArrowInvalid
from . import native

__all__ = ["G_MAX", "SumCol", "MinMaxCol", "grouped_aggregate",
           "grouped_aggregate_plain", "encode_order_key", "decode_order_key",
           "grouped_sum_count", "grouped_count", "grouped_min_max"]

G_MAX = 1024                      # the reference's bound (segagg.py:24)
_SIGN = -(1 << 63)                # int64 bits of 1 << 63
# dynamic shared memory a block may use: 227 KB less the kernel's static
# table of 64 slot descriptors (32 B each)
_SMEM_LIMIT = 227 * 1024 - 64 * 32
_UNSIGNED, _SIGNED, _FLOAT = 0, 1, 2


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


def _check_args(codes, num_groups, sum_cols, mm_cols):
    if codes.dim() != 1 or codes.dtype != torch.int32 \
            or not codes.is_contiguous():
        raise ArrowInvalid("codes must be a contiguous 1-D int32 tensor")
    if not 0 < num_groups <= G_MAX:
        raise ArrowInvalid(f"grouped_aggregate: num_groups must be in "
                           f"[1, {G_MAX}], got {num_groups}")
    n = codes.shape[0]
    for c in (*sum_cols, *mm_cols):
        for t, what in ((c.values, "values"), (c.valid, "valid")):
            if t is None:
                continue
            if t.dim() != 1 or t.shape[0] != n or t.device != codes.device \
                    or not t.is_contiguous():
                raise ArrowInvalid(
                    f"grouped_aggregate: {what} must be contiguous "
                    f"({n},) on {codes.device}")
        if c.valid is not None and c.valid.dtype != torch.bool:
            raise ArrowInvalid("grouped_aggregate: valid must be bool")
    for c in sum_cols:
        if c.values is not None and not _logical(c.values, c.dtype).is_integer:
            raise ArrowInvalid("grouped_aggregate: sums need integer values")
    for c in mm_cols:
        _cls(_logical(c.values, c.dtype))


def grouped_aggregate_plain(codes: torch.Tensor, num_groups: int,
                            sum_cols: Sequence[SumCol] = (),
                            mm_cols: Sequence[MinMaxCol] = ()):
    """The kernel's plain PyTorch version: (sums, counts, [(min_keys,
    max_keys)]), every entry an int64 (G,) tensor."""
    G = num_groups
    in_range = (codes >= 0) & (codes < G)

    def buckets(valid):            # dropped rows land in bucket G
        ok = in_range if valid is None else in_range & valid
        return torch.where(ok, codes.to(torch.int64), G)

    def zeros():
        return torch.zeros(G + 1, dtype=torch.int64, device=codes.device)

    sums, counts, keys = [], [], []
    ones = torch.ones((), dtype=torch.int64, device=codes.device) \
        .expand(codes.shape[0])
    for c in sum_cols:
        b = buckets(c.valid)
        counts.append(zeros().index_add_(0, b, ones)[:G])
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


def _launch_one(lib, codes: torch.Tensor, G: int,
                sum_cols: Sequence[SumCol], mm_cols: Sequence[MinMaxCol]):
    n_sum, n_mm = len(sum_cols), len(mm_cols)
    dev = codes.device

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rows = []
    for c in sum_cols:
        d = None if c.values is None else _logical(c.values, c.dtype)
        rows.append([ptr(c.values), ptr(c.valid),
                     0 if d is None else d.byte_width,
                     _SIGNED if d is None else _cls(d)])
    for c in mm_cols:
        d = _logical(c.values, c.dtype)
        rows.append([ptr(c.values), ptr(c.valid), d.byte_width, _cls(d)])
    desc = torch.tensor(rows or [[0, 0, 0, 0]], dtype=torch.int64).to(dev)
    acc = torch.zeros(2 * G * (n_sum + n_mm) or 1, dtype=torch.int64,
                      device=dev)
    mm_base = 2 * G * n_sum
    acc[mm_base:mm_base + G * n_mm] = -1          # min identity UINT64_MAX
    status = lib.atp_groupagg(
        dev.index, codes.data_ptr(), codes.shape[0], G, desc.data_ptr(),
        n_sum, n_mm, acc.data_ptr(), acc[G * n_sum:].data_ptr(),
        acc[mm_base:].data_ptr(), acc[mm_base + G * n_mm:].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    grouped_aggregate.launches += 1
    native.check(status, "grouped_aggregate kernel")
    sums = [acc[s * G:(s + 1) * G] for s in range(n_sum)]
    counts = [acc[(n_sum + s) * G:(n_sum + s + 1) * G] for s in range(n_sum)]
    keys = [(acc[mm_base + m * G:mm_base + (m + 1) * G],
             acc[mm_base + (n_mm + m) * G:mm_base + (n_mm + m + 1) * G])
            for m in range(n_mm)]
    return sums, counts, keys


def _launch(codes: torch.Tensor, G: int, sum_cols: Sequence[SumCol],
            mm_cols: Sequence[MinMaxCol]):
    """One launch holds at most `atp_groupagg_max_slots` slots and
    16 B x G per slot of shared memory; more slots than that are split
    across launches, each a full pass over the codes (at G = 1024, 14
    slots a launch)."""
    lib = native.library().lib
    per = min(lib.atp_groupagg_max_slots(), _SMEM_LIMIT // (16 * G))
    slots = [(True, c) for c in sum_cols] + [(False, c) for c in mm_cols]
    sums, counts, keys = [], [], []
    for i in range(0, max(len(slots), 1), per):
        batch = slots[i:i + per]
        s, c, k = _launch_one(lib, codes, G,
                              [x for is_sum, x in batch if is_sum],
                              [x for is_sum, x in batch if not is_sum])
        sums += s
        counts += c
        keys += k
    return sums, counts, keys


def grouped_aggregate(codes: torch.Tensor, num_groups: int,
                      sum_cols: Sequence[SumCol] = (),
                      mm_cols: Sequence[MinMaxCol] = (),
                      decode: bool = True):
    """All grouped aggregates in one pass (groupagg.py:248).

    Returns (sums, counts, minmaxes): sums[i] / counts[i] are int64 (G,)
    for sum_cols[i]; minmaxes[j] is a (min, max) pair decoded to
    mm_cols[j]'s type, an entry None when not requested.  With
    decode=False, minmaxes[j] is the undecoded (min_keys, max_keys) pair,
    identities still distinct from real extremes, for exact merges.
    """
    sum_cols, mm_cols = tuple(sum_cols), tuple(mm_cols)
    _check_args(codes, num_groups, sum_cols, mm_cols)
    run = _launch if on_cuda(codes) else grouped_aggregate_plain
    sums, counts, keys = run(codes, num_groups, sum_cols, mm_cols)
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
