"""String keys of a join (counterpart of arrow_tpu/ops/strings.py:
_as_dict, merged_string_ranks and _dict_slot_validity, strings.py:97-100,
183-207).

Strings stay on the host in this port (core/column.py), so both sides
of a string join key are ranked there, in one merged domain ordered by
UTF-8 bytes (the order of `row_format.dictionary_value_ranks`), and the
ranks go to the device as int64 keys.  The reference interns and sorts
the values with its native library; numpy's sort of byte strings gives
the same dense ranks.  The other string kernels join with ROADMAP A7.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import validity as vd
from ..core.column import Column, DictionaryColumn, StringColumn
from ..errors import ArrowTypeError

__all__ = ["string_ranks", "merged_string_ranks"]


def _as_dict(col: Column, device: torch.device) -> DictionaryColumn:
    """`col` as a dictionary: a StringColumn becomes its own dictionary,
    one code per row, with codes on `device`."""
    if isinstance(col, DictionaryColumn):
        return col
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"dictionary_encode of {type(col).__name__}")
    validity = None if col.validity is None else col.validity.to(device)
    return DictionaryColumn(torch.arange(len(col), device=device), col,
                            validity, _canonical=True)


def string_ranks(values: List[Optional[str]]) -> np.ndarray:
    """Dense ranks (uint64) of strings in UTF-8 byte order: equal strings
    share a rank; None ranks as the empty string, as the reference
    interns a null slot's empty bytes."""
    words = np.array([b"" if s is None else s.encode() for s in values],
                     dtype=object)
    if not len(words):
        return np.zeros(0, np.uint64)
    return np.unique(words, return_inverse=True)[1].reshape(-1) \
        .astype(np.uint64)


def merged_string_ranks(lv: StringColumn, rv: StringColumn
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Ranks of two value sets in one merged domain: (left ranks, right
    ranks), one per value slot."""
    ranks = string_ranks(lv.to_pylist() + rv.to_pylist())
    return ranks[:len(lv)], ranks[len(lv):]


def _dict_slot_validity(dcol: DictionaryColumn) -> vd.Mask:
    """The dictionary's validity with its null value slots folded in."""
    values = dcol.values
    if getattr(values, "validity", None) is None:
        return dcol.validity
    entry = values.validity.to(dcol.device)[dcol.codes.to(torch.int64)]
    return vd.union(dcol.validity, entry)
