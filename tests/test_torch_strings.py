"""Strings on the port's device and dictionaries built right, against the
JAX package on the CPU: the test-helper repairs (dictionary value types
and `ordered` through `port_column`), the device StringColumn and
NullColumn, dictionary_encode / dictionary_decode, value and merged
ranks, take and filter of strings and null columns, string keys through
row_format, sort and group_by (the dictionary plan and K2), min and max
over strings and dictionaries, and string columns in join's output.

Every comparison is bitwise: values (a string's offsets and bytes
where both packages define them), validity, dtype (a dictionary's
ordered flag included) and row order, or errors of the same name.  No
tolerance is needed: nothing here sums floats.  Inputs are made from a
seed with numpy and run on both reference routes (the `route` fixture;
the reference's Pallas kernels interpreted, n <= 4,096).  The CUDA tests
hold the card's results to the CPU route's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu.ops.row_format import SortOptions as RSortOptions
from arrow_tpu_torch.core.column import NullColumn, StringColumn
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops import filter as pf, groupby as gb
from arrow_tpu_torch.ops import join as pj, row_format as prf
from arrow_tpu_torch.ops import sort as psort, strings as ps
from arrow_tpu_torch.ops.cast import cast
from arrow_tpu_torch.ops.groupby import AggSpec, group_by
from arrow_tpu_torch.ops.take import take, take_table
from torch_port_util import (assert_columns_equal,  # noqa: F401
                             assert_tables_equal, cuda_device, port_column,
                             port_dtype, port_options, port_table, route,
                             storage_list)

rstr = importlib.import_module("arrow_tpu.ops.strings")
rtake = importlib.import_module("arrow_tpu.ops.take")
rfilter = importlib.import_module("arrow_tpu.ops.filter")
rsort = importlib.import_module("arrow_tpu.ops.sort")
rrf = importlib.import_module("arrow_tpu.ops.row_format")
rjoin = importlib.import_module("arrow_tpu.ops.join")
rcast = importlib.import_module("arrow_tpu.ops.cast")
rdt = at.dtypes
N = 600
WORDS = ["", "a", "a\x00", "ab", "b", "é", "éa", "z", "日本", "word-0042"]


def words(rng, n, nulls=0.15, pool=WORDS):
    """n strings drawn from `pool` (empty, NUL-suffixed and non-ASCII
    ones included), a share of them null."""
    pick = rng.integers(0, len(pool), n)
    null = rng.random(n) < nulls
    return [None if z else pool[i] for i, z in zip(pick, null)]


def string_column(rng, n=N, nulls=0.15, pool=WORDS):
    return at.column(words(rng, n, nulls, pool), rdt.utf8)


def same_buffers(got: StringColumn, want) -> None:
    """Offsets, bytes and validity equal to the reference's, bitwise."""
    np.testing.assert_array_equal(got.offsets.cpu().numpy(),
                                  np.asarray(want.offsets))
    np.testing.assert_array_equal(got.data.cpu().numpy(),
                                  np.asarray(want.data))
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        np.testing.assert_array_equal(got.validity.cpu().numpy(),
                                      np.asarray(want.validity))


# ---- the test helper carries a dictionary's type (ROADMAP C1) --------------

VALUE_TYPES = {
    "int8": np.array([-128, 5, 127, -3], np.int8),
    "uint16": np.array([65535, 2, 40000, 7], np.uint16),
    "uint64": np.array([2 ** 64 - 1, 2 ** 63, 5, 2 ** 63 + 7], np.uint64),
    "float16": np.array([1.5, -0.0, np.inf, -2.25], np.float16),
    "float32": np.array([1.5, -0.0, np.nan, -2.25], np.float32),
}


def value_dict(rng, name, ordered=False, n=N):
    vals = VALUE_TYPES[name]
    if ordered:                 # a declared order that holds
        vals = np.sort(vals)
    codes = rng.integers(0, len(vals), n).astype(np.int32)
    return at.DictionaryColumn(jnp.asarray(codes), at.column(vals),
                               jnp.asarray(rng.random(n) > 0.1),
                               ordered=ordered)


@pytest.mark.parametrize("ordered", [False, True], ids=["plain", "ordered"])
@pytest.mark.parametrize("name", list(VALUE_TYPES))
def test_port_column_keeps_the_dictionary_type(rng, name, ordered):
    """Fault C1: the values keep their type (uint64 past 2^63 included)
    and the ordered flag survives."""
    ref = value_dict(rng, name, ordered)
    got = port_column(ref)
    assert repr(got.dtype) == repr(port_dtype(ref.dtype))
    assert got.dtype.ordered == port_dtype(ref.dtype).ordered
    assert got.values.dtype == port_dtype(ref.values.dtype)
    assert storage_list(got.values) == storage_list(ref.values)
    assert storage_list(got) == storage_list(ref)


def test_port_table_checks_each_column_against_its_field(rng):
    """A column whose type is not its field's fails port_table."""
    t = at.Table.from_pydict({"d": value_dict(rng, "int8")})
    port_table(t)
    wrong = at.Table(t.columns, rdt.Schema((rdt.Field(
        "d", rdt.dictionary(rdt.int32, rdt.int64)),)))
    with pytest.raises(AssertionError):
        port_table(wrong)


@pytest.mark.parametrize("op", ["cast", "sort", "rank", "group_by"])
@pytest.mark.parametrize("ordered", [False, True], ids=["plain", "ordered"])
@pytest.mark.parametrize("name", list(VALUE_TYPES))
def test_dictionary_value_types_through_the_ops(rng, route, name, ordered,
                                                op):
    """Dictionaries of int8, uint16, uint64, float16 and float32 values,
    plain and declared ordered (with values that are in order), through
    cast, sort, rank and as group_by keys."""
    ref = value_dict(rng, name, ordered)
    got = port_column(ref)
    if op == "cast":
        to = rdt.float64 if name.startswith("float") else rdt.int64
        assert storage_list(cast(got, port_dtype(to))) == \
            storage_list(rcast.cast(ref, to))
    elif op == "sort":
        for o in [(False, True), (True, False)]:
            g = psort.sort(got, port_options(RSortOptions(*o)))
            w = rsort.sort(ref, RSortOptions(*o))
            assert storage_list(g) == storage_list(w)
    elif op == "rank":
        assert psort.rank(got).numpy().view(np.uint32).tolist() == \
            np.asarray(rsort.rank(ref)).astype(np.uint32).tolist()
    else:
        t = at.Table.from_pydict({"k": ref, "v": at.column(
            rng.integers(-50, 50, N))})
        want = ref_group_by(t, ["k"], [RefAggSpec("v", "sum"),
                                       RefAggSpec("v", "count_all")])
        got_t = group_by(port_table(t), ["k"], [AggSpec("v", "sum"),
                                                AggSpec("v", "count_all")])
        assert storage_list(got_t.column("k")) == \
            storage_list(want.column("k"))
        for c in ("v_sum", "v_count_all"):
            assert_columns_equal(got_t.column(c), want.column(c))


@pytest.mark.parametrize("op", ["take", "filter", "sort_table"])
def test_ordered_flag_follows_pyarrow(rng, op):
    """ROADMAP C2: the reference drops `ordered` in take, filter and
    sort_table; pyarrow 25 keeps it, and so does the port.  The values
    agree; the flag is the recorded gap."""
    ref = value_dict(rng, "int8", ordered=True, n=50)
    t = at.Table.from_pydict({"d": ref})
    pt = port_table(t)
    if op == "take":
        idx = at.column(np.arange(49, -1, -1))
        g, w = take(pt.column("d"), port_column(idx)), rtake.take(ref, idx)
    elif op == "filter":
        pred = at.column(rng.random(50) < 0.5)
        g = pf.filter_table(pt, port_column(pred)).column("d")
        w = rfilter.filter_table(t, pred).column("d")
    else:
        g = psort.sort_table(pt, [("d", port_options(RSortOptions()))]) \
            .column("d")
        w = rsort.sort_table(t, [("d", RSortOptions())]).column("d")
    assert g.dtype.ordered is True and w.dtype.ordered is None
    assert storage_list(g) == storage_list(w)


# ---- the StringColumn and NullColumn on the caller's device ------------------

def test_string_and_null_columns_take_the_named_device():
    """Fault 2 and 3: a StringColumn and a NullColumn live on the device
    the caller names (the meta device stands for a card here), and
    neither has a default."""
    s = StringColumn.from_pylist(["a", None, "é"], device="meta")
    assert s.offsets.device.type == s.data.device.type == "meta"
    assert s.validity.device.type == "meta"
    assert att.column(["x", "y"], device="meta").device.type == "meta"
    assert NullColumn(4, "meta").device.type == "meta"
    with pytest.raises(ValueError, match="explicit device"):
        StringColumn.from_pylist(["a"])
    with pytest.raises(TypeError):
        NullColumn(4)


def test_from_numpy_puts_dictionary_values_on_the_callers_device():
    """Fault 4: a dictionary given as a list is built on the codes'
    device, not on the CPU."""
    d = att.from_numpy(np.array([0, 1, 0], np.int32), device="meta",
                       dictionary=["p", "q"], ordered=True)
    assert d.codes.device.type == d.values.device.type == "meta"
    assert d.dtype.ordered


def test_string_column_matches_reference_layout(rng):
    """from_pylist builds the reference's offsets and bytes; to_pylist
    reads them back."""
    vals = words(rng, 200)
    got = StringColumn.from_pylist(vals, device="cpu")
    want = at.StringColumn.from_pylist(vals)
    same_buffers(got, want)
    assert got.to_pylist() == vals
    assert StringColumn.from_pylist([], device="cpu").to_pylist() == []


@pytest.mark.parametrize("lo,length", [(0, 0), (0, 200), (17, 50),
                                       (199, 1), (200, 0)])
def test_string_slice_rebases_offsets(rng, lo, length):
    ref = string_column(rng, 200)
    same_buffers(port_column(ref).slice(lo, length), ref.slice(lo, length))


def test_string_column_is_a_pytree(rng):
    """Its tensors are the leaves, its type the structure, as fuse needs."""
    col = port_column(string_column(rng, 30))
    leaves, spec = pytree.tree_flatten(col)
    assert len(leaves) == 3
    back = pytree.tree_unflatten(leaves, spec)
    assert isinstance(back, StringColumn) and back.to_pylist() == \
        col.to_pylist()


# ---- dictionary encoding and ranks -----------------------------------------

@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int64, torch.int16])
@pytest.mark.parametrize("nulls", [0.0, 0.2])
def test_dictionary_encode_matches_reference(rng, code_dtype, nulls):
    """Codes are value ranks; the values come sorted and distinct."""
    ref = string_column(rng, N, nulls)
    want = rstr.dictionary_encode(ref, jnp.dtype(str(code_dtype)[6:]),
                                  ordered=True)
    got = ps.dictionary_encode(port_column(ref), code_dtype, ordered=True)
    assert got.codes.dtype == code_dtype
    assert_columns_equal(got, want, masks=True)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    same_buffers(got.values, want.values)
    assert ps.dictionary_encode(got) is got


def test_dictionary_encode_of_empty_and_all_null_columns():
    for vals in ([], [None, None], ["", ""]):
        ref = at.column(vals, rdt.utf8) if vals else \
            at.StringColumn.from_pylist([])
        want = rstr.dictionary_encode(ref)
        got = ps.dictionary_encode(port_column(ref))
        assert_columns_equal(got, want, masks=True)
        same_buffers(got.values, want.values)


# ---- the device route of dictionary_encode (sort refinement, K3) -----------

TEXT = np.frombuffer(b"furiously regular deposits sleep carefully among the "
                     b"final pinto beans. quickly ironic accounts wake "
                     b"blithely express, even requests haggle slyly; "
                     b"bold packages nag ", np.uint8)


def _rows(chunks, valid=None):
    """(int64 offsets, bytes, validity) of a list of bytes."""
    offs = np.zeros(len(chunks) + 1, np.int64)
    np.cumsum([len(c) for c in chunks], out=offs[1:])
    return offs, np.frombuffer(b"".join(chunks), np.uint8), valid


def _tpch_text(seed: int):
    """20,000 rows drawn like Q10's c_address (10-40 bytes) and c_comment
    (29-116) after its joins: text cut from a pool at random offsets,
    each of 7,000 customers' rows repeated."""
    rng = np.random.default_rng(seed)
    pool = TEXT[rng.integers(0, len(TEXT), 1 << 14)].tobytes()
    lens = np.where(rng.random(7_000) < 0.5, rng.integers(10, 41, 7_000),
                    rng.integers(29, 117, 7_000))
    starts = rng.integers(0, len(pool) - 116, 7_000)
    uniq = [pool[a:a + n] for a, n in zip(starts, lens)]
    return _rows([uniq[i] for i in rng.integers(0, 7_000, 20_000)])


def _long_tail(seed: int):
    """3,000 short rows (0-20 bytes, repeated) and a tail: one value of
    1,000 bytes, a copy of it, and its prefixes of 999, 994, 500 and 64
    bytes, so rows finish at many passes and a few run on alone."""
    rng = np.random.default_rng(seed)
    long = rng.integers(0, 256, 1000, np.uint8).tobytes()
    short = [rng.integers(0, 256, n, np.uint8).tobytes()
             for n in rng.integers(0, 21, 900)]
    tail = [long, long, long[:999], long[:994], long[:500], long[:64]]
    return _rows([short[i] for i in rng.integers(0, 900, 3_000)] + tail)


def _early_end(seed: int):
    """2,000 short rows (0-20 bytes, repeated) and one value of 1,000
    bytes found nowhere else: every row finishes long before the longest
    row's last pass, so the encode stops early."""
    rng = np.random.default_rng(seed)
    short = [rng.integers(0, 256, n, np.uint8).tobytes()
             for n in rng.integers(0, 21, 600)]
    return _rows([short[i] for i in rng.integers(0, 600, 2_000)]
                 + [rng.integers(0, 256, 1000, np.uint8).tobytes()])


def _all_distinct(seed: int):
    """500 distinct rows of 0-40 random bytes: every row ends alone."""
    rng = np.random.default_rng(seed)
    uniq = {rng.integers(0, 256, n, np.uint8).tobytes()
            for n in rng.integers(0, 41, 520)}
    return _rows(sorted(uniq, key=lambda b: rng.random())[:500])


def _key_edges():
    """Rows ending just before, at and after a key's 7 bytes and two
    keys' 14, with and without zero bytes after a shared prefix."""
    base = b"abcdefghijklmnop"
    rows = [base[:n] + tail for n in (6, 7, 8, 13, 14, 15)
            for tail in (b"", b"\x00", b"\x00\x00")]
    return _rows(rows * 3 + [b"\x00" * 7, b"\x00" * 14, b"\x00" * 8])


def _group_sizes(seed: int, copies: bool):
    """Groups past and under the 64 rows a thread sorts on the card: 300
    rows sharing their first 7 bytes, then 2 copies of each suffix (one
    group of 300 after pass 1, of 2 after pass 2); with `copies`, 3
    values of 40 bytes 70-130 times each too (groups of more than 64 to
    the last pass)."""
    rng = np.random.default_rng(seed)
    suffix = [rng.integers(0, 256, 20, np.uint8).tobytes() for _ in range(150)]
    rows = [b"common!" + x for x in suffix * 2]
    if copies:
        values = [rng.integers(0, 256, 40, np.uint8).tobytes()
                  for _ in range(3)]
        rows += [v for v, k in zip(values, (70, 100, 130)) for _ in range(k)]
    return _rows([rows[i] for i in rng.permutation(len(rows))])


ENCODE_CASES = {
    "prefix_fanout": lambda: _group_sizes(47, False),
    "large_copies": lambda: _group_sizes(53, True),
    "zero_rows": lambda: _rows([]),
    "one_row": lambda: _rows([b"word"]),
    "all_equal": lambda: _rows([b"same value"] * 50),
    "all_distinct": lambda: _all_distinct(31),
    "key_edges": _key_edges,
    "empty_string": lambda: _rows([b"", b"a", b"", b"\x00", b""]),
    "all_empty": lambda: _rows([b""] * 9, np.arange(9) % 3 == 0),
    "embedded_zeros": lambda: _rows(
        [b"\x00", b"a\x00b", b"a\x00", b"a", b"\x00a", b"\x00\x00",
         b"a\x00b\x00", b"a\x00a", b"\x00"] * 2),
    "prefix_across_words": lambda: _rows(
        [b"abcdefghi", b"abcdefgh\x00", b"abcdefgh", b"abcdefgh", b"abcdefg",
         b"abcdefgh\x00\x00", b"abcdefghabcdefgh", b"abcdefghabcdefgh\x00",
         b"abcdefghabcdefg", b"abcdef", b"abcdefg\x00", b"abcdefgabcdefg",
         b"abcdefgabcdefg\x00", b"abcdefgabcdef"]),
    "high_bytes": lambda: _rows([bytes([b]) for b in range(255, -1, -1)]
                                + [b"\x7f\xff", b"\x80", b"\x80\x00",
                                   b"\xff" * 9, b"\xff" * 8, b"\xff" * 7]),
    "lengths_0_130": lambda: _rows(
        [np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
         for n in range(131)] * 2),
    "nulls_with_and_without_bytes": lambda: _rows(
        [b"kept", b"", b"hidden", b"kept", b"hidden", b"", b"x"],
        np.array([True, False, False, True, True, True, False])),
    "tpch_text": lambda: _tpch_text(19),
    "long_tail": lambda: _long_tail(23),
    "early_end": lambda: _early_end(29),
}


def _encode_case(case, layout, device="cpu"):
    """The case as a reference column (int32 offsets, int64 under a large
    layout) and as the port's column on `device`, and its longest row."""
    offs, data, valid = ENCODE_CASES[case]()
    wide = layout.startswith("large")
    ref = at.StringColumn(jnp.asarray(offs.astype(np.int64 if wide
                                                  else np.int32)),
                          jnp.asarray(data), getattr(rdt, layout),
                          None if valid is None else jnp.asarray(valid))
    return ref, port_column(ref, device), int(np.diff(offs).max(initial=0))


def _same_encoding(got, want, col) -> None:
    """Codes (int32, the value's rank under a null row too), values,
    validity and type of an encode bitwise equal to the reference's."""
    assert got.codes.dtype == torch.int32
    np.testing.assert_array_equal(got.codes.cpu().numpy(),
                                  np.asarray(want.codes))
    # the type and the masks as assert_columns_equal holds them; the rows
    # by their buffers (to_pylist cannot decode the cases' non-UTF-8 text)
    assert repr(got.dtype) == repr(want.dtype)
    assert bool(got.dtype.ordered) == bool(want.dtype.ordered)
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        np.testing.assert_array_equal(got.validity.cpu().numpy(),
                                      np.asarray(want.validity))
    same_buffers(got.values, want.values)
    # the layout's offsets (the reference keeps int32 under a large one)
    assert got.values.offsets.dtype == col.offsets.dtype
    assert got.values.dtype == col.dtype and got.validity is col.validity
    u = len(want.values)
    np.testing.assert_array_equal(got.values._value_ranks[0],
                                  np.arange(u, dtype=np.uint64))
    assert not got.values._value_ranks[1].any()


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
@pytest.mark.parametrize("layout", ["utf8", "large_utf8", "binary",
                                    "large_binary"])
def test_device_route_of_dictionary_encode_equals_the_host_route(case,
                                                                 layout):
    """The route a CUDA column takes (K3's ranking by sort refinement
    with its drops of finished rows, K1's run starts, here on their plain
    versions) and the host route both give the reference's
    codes, values and validity bit for bit, null rows' bytes ranked with
    the rest; the device route runs at most one pass a 7 bytes of the
    longest row."""
    from arrow_tpu_torch.kernels.strkey import BYTES
    ref, col, longest = _encode_case(case, layout)
    want = rstr.dictionary_encode(ref, ordered=True)
    got, passes, drops = ps._encode_on_device(col, torch.int32, True)
    assert passes <= -(-longest // BYTES) and drops <= passes
    if case == "early_end":
        assert passes < 8
    _same_encoding(got, want, col)
    _same_encoding(ps._encode_on_host(col, torch.int32, True), want, col)


def _python_words(chunks, k, rows):
    """Key k of each asked row, by the definition: the 7 bytes from 7k,
    zero-padded, big-endian, times 16, plus the bytes left from 7k on
    (0 to 7, 8 for more)."""
    out = []
    for r in rows:
        w = (chunks[r][7 * k:7 * k + 7] + bytes(7))[:7]
        left = min(max(len(chunks[r]) - 7 * k, 0), 8)
        out.append(int.from_bytes(w, "big") * 16 + left)
    return out


@pytest.mark.parametrize("off_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("with_rows", [False, True])
def test_strkey_plain_gives_the_words(rng, off_dtype, with_rows):
    """K3's plain version: each row's key k as the definition gives it,
    for sliced offsets (not starting at 0) and a row list."""
    from arrow_tpu_torch.kernels.strkey import strkey_plain
    chunks = [rng.integers(0, 256, n, np.uint8).tobytes()
              for n in rng.integers(0, 30, 200)]
    offs, data, _ = _rows([b"skipped"] + chunks)
    offsets = torch.from_numpy(offs[1:]).to(off_dtype)
    rows = rng.permutation(200)[:150] if with_rows else np.arange(200)
    for k in range(6):
        got = strkey_plain(offsets, torch.from_numpy(data.copy()), k,
                           torch.from_numpy(rows) if with_rows else None)
        assert got.dtype == torch.int64
        assert got.tolist() == _python_words(chunks, k, rows)


STRRANK_BAD_ARGS = {
    "int16_offsets": lambda o, d: (o.to(torch.int16), d, 1),
    "2d_offsets": lambda o, d: (o.reshape(1, -1), d, 1),
    "strided_offsets": lambda o, d: (torch.stack([o, o], 1)[:, 0], d, 1),
    "no_offsets": lambda o, d: (o[:0], d, 0),
    "int8_data": lambda o, d: (o, d.to(torch.int8), 1),
    "strided_data": lambda o, d: (o, torch.stack([d, d], 1)[:, 0], 1),
    "negative_passes": lambda o, d: (o, d, -1),
}


@pytest.mark.parametrize("bad", sorted(STRRANK_BAD_ARGS))
def test_strkey_rejects_bad_arguments(bad):
    """K3's wrapper checks its arguments before any launch, on either
    device."""
    from arrow_tpu_torch.errors import ArrowInvalid
    from arrow_tpu_torch.kernels import strkey as ks
    offs = torch.tensor([0, 2, 3], dtype=torch.int32)
    data = torch.zeros(3, dtype=torch.uint8)
    before = ks.strrank.launches
    with pytest.raises(ArrowInvalid):
        ks.strrank(*STRRANK_BAD_ARGS[bad](offs, data))
    assert ks.strrank.launches == before


def test_dictionary_decode_matches_reference(rng, route):
    ref = rstr.dictionary_encode(string_column(rng))
    got = ps.dictionary_decode(port_column(ref))
    want = rstr.dictionary_decode(ref)
    assert_columns_equal(got, want, masks=True)
    same_buffers(got, want)


def test_encode_rejects_other_layouts():
    from arrow_tpu_torch.errors import ArrowTypeError
    with pytest.raises(ArrowTypeError):
        ps.dictionary_encode(att.column([1, 2], device="cpu"))


@pytest.mark.parametrize("nulls", [0.0, 0.3])
def test_dictionary_value_ranks_of_strings(rng, nulls):
    """Dense ranks in byte order: 'a' below 'a\\x00', both below 'ab'."""
    ref = string_column(rng, 80, nulls)
    want = rrf.dictionary_value_ranks(ref)
    got = prf.dictionary_value_ranks(port_column(ref))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_merged_string_ranks_match_reference(rng):
    left, right = string_column(rng, 70), string_column(rng, 40)
    want = rstr.merged_string_ranks(left, right)
    got = ps.merged_string_ranks(port_column(left), port_column(right))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


CMP_OPS = ["eq", "neq", "lt", "lt_eq", "gt", "gt_eq"]


@pytest.mark.parametrize("op", CMP_OPS)
@pytest.mark.parametrize("lit", ["a", "a\x00", "", "zz", "日本"])
def test_string_literal_compare_through_the_encoding(rng, op, lit):
    """A StringColumn against a literal: one encode, one gather."""
    pcmp = importlib.import_module("arrow_tpu_torch.ops.cmp")
    rcmp = importlib.import_module("arrow_tpu.ops.cmp")
    ref = string_column(rng, 120)
    assert_columns_equal(getattr(pcmp, op)(port_column(ref), lit),
                         getattr(rcmp, op)(ref, lit), op, masks=True)


# ---- take and filter ---------------------------------------------------------

@pytest.mark.parametrize("null_indices", [False, True])
@pytest.mark.parametrize("index_type", ["int32", "int64", "uint32"])
def test_take_strings_matches_reference(rng, null_indices, index_type):
    """Offsets from a cumsum of the gathered lengths, bytes gathered on
    the device; out-of-range indices clamp, null indices give nulls."""
    ref = string_column(rng, 300)
    idx_np = rng.integers(0, 320, 500).astype(index_type)
    valid = rng.random(500) > 0.2 if null_indices else None
    idx = at.column(idx_np, validity=valid)
    got = take(port_column(ref), port_column(idx))
    want = rtake.take(ref, idx)
    assert_columns_equal(got, want, masks=True)
    same_buffers(got, want)


@pytest.mark.parametrize("order", [[1, 1, 0, 2, 1], [0, 2, 2, 0],
                                   [1, 1, 1], [2, 1, 0, 1, 1, 2]])
def test_take_strings_with_empty_rows_anywhere(order):
    """Empty rows first, last and in runs: their jumps in the byte map
    add up to the next row's start."""
    ref = at.column(["abc", "", "é日"], rdt.utf8)
    idx = at.column(np.asarray(order, np.int64))
    got = take(port_column(ref), port_column(idx))
    want = rtake.take(ref, idx)
    assert_columns_equal(got, want)
    same_buffers(got, want)


def test_take_strings_with_no_rows(rng):
    ref = string_column(rng, 20)
    idx = at.column(np.zeros(0, np.int64))
    got = take(port_column(ref), port_column(idx))
    same_buffers(got, rtake.take(ref, idx))
    null = take(NullColumn(5, "cpu"), torch.tensor([0, 4, 2]))
    assert isinstance(null, NullColumn) and len(null) == 3


def mixed_table(rng, n=N):
    return at.Table.from_pydict({
        "i": at.column(rng.integers(-9, 9, n).astype(np.int32),
                       validity=rng.random(n) > 0.1),
        "s": string_column(rng, n),
        "z": at.NullColumn(n),
        "d": at.DictionaryColumn(jnp.asarray(rng.integers(0, 3, n)
                                             .astype(np.int8)),
                                 at.column(["x", "yy", ""])),
        "t": string_column(rng, n, 0.0)})


@pytest.mark.parametrize("share", [0.0, 0.04, 0.5, 1.0])
def test_filter_table_with_strings_and_nulls(rng, route, monkeypatch, share):
    """One K1 call for the whole batch: its fixed-width buffers and the
    kept positions the string columns are gathered by."""
    t = mixed_table(rng)
    pred = at.column(rng.random(N) < share, validity=rng.random(N) > 0.05)
    calls = []
    real = kc.compact_plain
    monkeypatch.setattr(kc, "compact_plain",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    got = pf.filter_table(port_table(t), port_column(pred))
    want = rfilter.filter_table(t, pred)
    assert_tables_equal(got, want)
    for name in ("s", "t"):
        same_buffers(got.column(name), want.column(name))
    assert len(calls) == 1 and calls[0][3] == torch.int64


@pytest.mark.parametrize("layout", ["string", "null", "empty-string"])
def test_filter_of_one_column(rng, layout):
    if layout == "string":
        col = string_column(rng, 200)
    elif layout == "null":
        col = at.NullColumn(200)
    else:
        col = at.StringColumn.from_pylist([""] * 200)
    pred = at.column(rng.random(200) < 0.3)
    got = pf.filter(port_column(col), port_column(pred))
    want = rfilter.filter(col, pred)
    assert type(got).__name__ == type(want).__name__
    assert_columns_equal(got, want, masks=True)
    if layout != "null":
        same_buffers(got, want)


def test_filter_table_of_only_null_columns_launches_nothing(monkeypatch):
    monkeypatch.setattr(kc, "compact_plain", None)      # must not be called
    t = att.Table([NullColumn(4, "cpu")], att.dtypes.Schema(
        (att.dtypes.Field("z", att.dtypes.null),)))
    out = pf.filter_table(t, att.column([True, False, True, True],
                                        device="cpu"))
    assert len(out.column("z")) == 3


# ---- string keys -------------------------------------------------------------

@pytest.mark.parametrize("opt", [(False, True), (True, False)])
def test_sort_and_rank_of_strings(rng, route, opt):
    ref = string_column(rng)
    got = port_column(ref)
    assert_columns_equal(psort.sort(got, port_options(RSortOptions(*opt))),
                         rsort.sort(ref, RSortOptions(*opt)))
    np.testing.assert_array_equal(
        psort.sort_to_indices(got, port_options(RSortOptions(*opt)))
        .values.numpy().astype(np.int64),
        np.asarray(rsort.sort_to_indices(ref, RSortOptions(*opt)).values))
    assert psort.rank(got).numpy().view(np.uint32).tolist() == \
        np.asarray(rsort.rank(ref)).astype(np.uint32).tolist()


def test_sort_table_by_a_string_key(rng, route):
    t = mixed_table(rng)
    by = [("s", RSortOptions(descending=True, nulls_first=False))]
    assert_tables_equal(
        psort.sort_table(port_table(t), [(c, port_options(o))
                                         for c, o in by]),
        rsort.sort_table(t, by))


def test_encode_value_key_of_strings(rng):
    ref = string_column(rng, 150)
    key, valid = prf.encode_value_key(port_column(ref))
    want_key, want_valid = rrf.encode_value_key(ref)
    np.testing.assert_array_equal(key.numpy().view(np.uint64),
                                  np.asarray(want_key))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


STRING_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
               ("v", "count_all"), ("v", "mean"), ("s", "min"),
               ("s", "max"), ("s", "count"), ("d", "min"), ("d", "max")]


def key_table(rng, n=N, pool=WORDS, nulls=0.15):
    dvals = at.column(["q", None, "b", "q", "", "é"])
    return at.Table.from_pydict({
        "k": string_column(rng, n, nulls, pool),
        "j": at.column(rng.integers(0, 3, n).astype(np.int16)),
        "v": at.column(rng.integers(-1000, 1000, n).astype(np.int32),
                       validity=rng.random(n) > 0.1),
        "s": string_column(rng, n, 0.3),
        "d": at.DictionaryColumn(jnp.asarray(rng.integers(0, 6, n)
                                             .astype(np.int32)), dvals,
                                 jnp.asarray(rng.random(n) > 0.1))})


@pytest.mark.parametrize("keys", [["k"], ["k", "j"], ["j", "k"], ["j"]],
                         ids=["string", "string-int", "int-string", "int"])
def test_group_by_string_keys_and_string_min_max(rng, route, keys):
    """String keys (dictionary-encoded: the dictionary plan when the
    combined codes fit K2) and min/max over strings and dictionaries
    (a null dictionary value and a repeated one included)."""
    t = key_table(rng)
    want = ref_group_by(t, keys, [RefAggSpec(*a) for a in STRING_AGGS])
    got = group_by(port_table(t), keys, [AggSpec(*a) for a in STRING_AGGS])
    assert_tables_equal(got, want)


def test_string_key_takes_the_dictionary_plan(rng, monkeypatch):
    """The encoded key reaches K2's plan, and its output decodes back to
    a utf8 column under the key's own field."""
    plans = []
    real = gb._k2_plan
    monkeypatch.setattr(gb, "_k2_plan",
                        lambda *a: plans.append(a) or real(*a))
    t = port_table(key_table(rng))
    out = group_by(t, ["k"], [AggSpec("v", "sum")])
    assert len(plans) == 1
    assert isinstance(out.column("k"), StringColumn)
    assert out.schema.field("k") == t.schema.field("k")


def test_group_by_many_distinct_strings_takes_the_sort_plan(rng, route):
    """2,000 distinct keys pass K2's 1,024 codes: the sort plan, K1 at
    the run starts."""
    pool = [f"key-{i:05d}" for i in range(2000)] + ["", "é"]
    t = key_table(rng, 3000, pool)
    aggs = [("v", "sum"), ("s", "max"), ("v", "count_all")]
    assert_tables_equal(
        group_by(port_table(t), ["k"], [AggSpec(*a) for a in aggs]),
        ref_group_by(t, ["k"], [RefAggSpec(*a) for a in aggs]))


def test_group_by_of_an_empty_table_with_strings(rng):
    t = key_table(rng).slice(0, 0)
    aggs = [("s", "min"), ("d", "max"), ("v", "sum")]
    assert_tables_equal(
        group_by(port_table(t), ["k"], [AggSpec(*a) for a in aggs]),
        ref_group_by(t, ["k"], [RefAggSpec(*a) for a in aggs]))


def test_group_by_all_null_string_min(rng):
    t = at.Table.from_pydict({"k": at.column([1, 1, 2]),
                              "s": at.column([None, None, "x"], rdt.utf8)})
    assert_tables_equal(
        group_by(port_table(t), ["k"], [AggSpec("s", "min")]),
        ref_group_by(t, ["k"], [RefAggSpec("s", "min")]))


# ---- join --------------------------------------------------------------------

@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("key", ["int", "string"])
def test_join_carries_string_columns(rng, route, how, key):
    """String payloads on both sides ride take; string keys rank in one
    merged domain."""
    n_l, n_r = 300, 120
    if key == "int":
        lk = at.column(rng.integers(0, 150, n_l))
        rk = at.column(rng.permutation(200)[:n_r])
    else:
        lk, rk = string_column(rng, n_l, 0.1), string_column(rng, n_r, 0.1,
                                                             WORDS[:6])
    left = at.Table.from_pydict({"k": lk, "s": string_column(rng, n_l),
                                 "z": at.NullColumn(n_l)})
    right = at.Table.from_pydict({"k": rk, "s": string_column(rng, n_r),
                                  "t": string_column(rng, n_r, 0.0)})
    got = pj.join(port_table(left), port_table(right), ["k"], how=how)
    want = rjoin.join(left, right, ["k"], how=how)
    if key == "string" and how in ("inner", "left"):
        # build keys repeat: the reference's order within a probe row is
        # unspecified (ROADMAP C5), so the rows compare as a multiset
        assert [(f.name, repr(f.dtype), f.nullable)
                for f in got.schema.fields] == \
            [(f.name, repr(f.dtype), f.nullable) for f in want.schema.fields]
        assert sorted(map(repr, zip(*got.to_pydict().values()))) == \
            sorted(map(repr, zip(*want.to_pydict().values())))
    else:
        assert_tables_equal(got, want)


# ---- on the card ---------------------------------------------------------------

def _to(col, device):
    return port_column(col, device)


def _q10_comment(seed: int, n: int):
    """n rows drawn like Q10's c_comment after its joins: 29-116 bytes of
    text cut from a pool at random offsets, about three rows a value."""
    rng = np.random.default_rng(seed)
    pool = TEXT[rng.integers(0, len(TEXT), 1 << 16)]
    u = max(n // 3, 1)
    pick = rng.integers(0, u, n)
    lens = rng.integers(29, 117, u)[pick]
    starts = rng.integers(0, len(pool) - 116, u)[pick]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = pool[np.repeat(starts - offs[:-1], lens) + np.arange(offs[-1])]
    return offs, data, None


def _string_column(offs, data, device):
    return StringColumn.from_numpy(offs.astype(np.int32), data,
                                   dtype=att.dtypes.utf8, device=device)


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
@pytest.mark.parametrize("off_dtype", [torch.int32, torch.int64])
def test_strrank_matches_plain_on_cuda(cuda_device, case, off_dtype):
    """K3 against its plain loop: every row's sorted position, the passes
    run and the drops made, with offsets not starting at 0; one native
    call a ranking."""
    from arrow_tpu_torch.kernels import strkey as ks
    offs, data, _ = ENCODE_CASES[case]()
    offsets = torch.from_numpy(offs + 5).to(off_dtype)
    data = torch.from_numpy(np.concatenate([np.full(5, 255, np.uint8), data,
                                            np.full(3, 255, np.uint8)]))
    passes = -(-int(np.diff(offs).max(initial=0)) // ks.BYTES)
    want = ks.strrank_plain(offsets, data, passes)
    before = ks.strrank.launches
    at, done, drops = ks.strrank(offsets.to(cuda_device),
                                 data.to(cuda_device), passes)
    torch.cuda.synchronize()
    assert ks.strrank.launches == before + 1
    assert at.device.type == "cuda" and at.dtype == torch.int32
    assert torch.equal(at.cpu(), want[0]) and (done, drops) == want[1:]


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
@pytest.mark.parametrize("layout", ["utf8", "large_utf8", "binary",
                                    "large_binary"])
def test_dictionary_encode_on_cuda_equals_the_host_route(cuda_device, case,
                                                         layout):
    """dictionary_encode of a CUDA column ranks it on the card: the
    reference's codes and values bit for bit, as the host route and the
    plain loop give them, with the plain loop's passes and drops; one K3
    call and one K1 launch (the run starts) an encode; a `strings.encode`
    span; and only scalar readbacks (the longest row, the distinct count
    with the values' bytes; K3 reads the rows left after each drop inside
    its call, with no readback span): none of the column's bytes or
    offsets reach the host."""
    from arrow_tpu_torch.kernels import strkey as ks
    from arrow_tpu_torch.utils import trace
    ref, gpu, longest = _encode_case(case, layout, cuda_device)
    want = rstr.dictionary_encode(ref)
    cpu = port_column(ref)
    _same_encoding(ps.dictionary_encode(cpu), want, cpu)
    plain, passes, drops = ps._encode_on_device(cpu, torch.int32, False)
    _same_encoding(plain, want, cpu)
    assert passes <= -(-longest // ks.BYTES)
    before = (ks.strrank.launches, kc.compact.launches)
    trace.reset_spans()
    with trace.recording():
        got = ps.dictionary_encode(gpu)
        torch.cuda.synchronize()
    spans = trace.spans()
    trace.reset_spans()
    (enc,) = [s for s in spans if s.name == "strings.encode"]
    assert enc.attrs == {"rows": len(gpu), "distinct": len(want.values),
                         "passes": passes, "drops": drops}
    assert (ks.strrank.launches, kc.compact.launches) == \
        (before[0] + 1, before[1] + 1)
    reads = [s.attrs["site"] for s in spans if s.name == "readback"]
    assert reads == ["strings.maxlen"] * bool(len(gpu)) + ["strings.distinct"]
    assert all(s.attrs["bytes"] <= 16 for s in spans if s.name == "readback")
    assert got.codes.device == gpu.device
    _same_encoding(got, want, gpu)


def test_strrank_of_a_q10_comment_on_cuda(cuda_device):
    """A column shaped like Q10's c_comment at 1M rows (17 passes): K3
    equals its plain loop, and the encode on the card the host route."""
    from arrow_tpu_torch.kernels import strkey as ks
    offs, data, _ = _q10_comment(37, 1 << 20)
    cpu, gpu = (_string_column(offs, data, d) for d in ("cpu", cuda_device))
    passes = -(-int(np.diff(offs).max()) // ks.BYTES)
    want = ks.strrank_plain(cpu.offsets, cpu.data, passes)
    at, done, drops = ks.strrank(gpu.offsets, gpu.data, passes)
    assert (done, drops) == want[1:] and done == passes == 17
    assert torch.equal(at.cpu(), want[0])
    host, dev = ps.dictionary_encode(cpu), ps.dictionary_encode(gpu)
    assert torch.equal(dev.codes.cpu(), host.codes)
    assert torch.equal(dev.values.offsets.cpu(), host.values.offsets)
    assert torch.equal(dev.values.data.cpu(), host.values.data)


def test_cuda_encode_takes_no_more_memory_than_the_plain_loop(
        cuda_device, monkeypatch):
    """The peak a CUDA encode adds with K3's routine is no more than the
    same encode with the plain loop on the card."""
    from arrow_tpu_torch.kernels import strkey as ks
    gpu = _string_column(*_q10_comment(41, 200_000)[:2], cuda_device)

    def rise():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = ps.dictionary_encode(gpu)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    native, got = rise()
    monkeypatch.setattr(ps, "strrank", ks.strrank_plain)
    plain, want = rise()
    assert torch.equal(got.codes, want.codes)
    assert 0 < native <= plain


class _CountOps(TorchDispatchMode):
    """Counts the ops the dispatcher sees."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_cuda_encode_ops_do_not_grow_with_its_passes(cuda_device):
    """A CUDA encode makes no torch op a pass: a 17-pass column costs no
    more eager ops than a 3-pass one."""
    from arrow_tpu_torch.utils import trace
    rng = np.random.default_rng(43)
    ops = {}
    for lo, hi in ((15, 22), (113, 120)):
        chunks = [TEXT[rng.integers(0, len(TEXT), n)].tobytes()
                  for n in rng.integers(lo, hi, 2_000)]
        offs, data, _ = _rows([chunks[i] for i in
                               rng.integers(0, 2_000, 6_000)])
        gpu = _string_column(offs, data, cuda_device)
        ps.dictionary_encode(gpu)
        before = trace.counters_snapshot().get("strings.native_passes", 0)
        with _CountOps() as count:
            ps.dictionary_encode(gpu)
        passes = trace.counters_snapshot()["strings.native_passes"] - before
        ops[passes] = count.n
    assert sorted(ops) == [3, 17]
    assert ops[17] <= ops[3]


def test_cuda_strings_match_the_cpu_route(cuda_device, rng):
    """take, filter_table, encode, decode, concat, group_by and join on
    the card equal the plain route bit for bit, and the filter and the
    group-by launch their kernels."""
    from arrow_tpu_torch.ops.concat import concat
    t = mixed_table(rng, 3000)
    cpu, gpu = port_table(t), port_table(t, cuda_device)
    idx = torch.from_numpy(rng.integers(0, 3000, 4000))
    g, c = take(gpu.column("s"), idx.to(cuda_device)), take(cpu.column("s"),
                                                             idx)
    assert g.offsets.device.type == "cuda"
    assert torch.equal(g.offsets.cpu(), c.offsets)
    assert torch.equal(g.data.cpu(), c.data)
    pred = rng.random(3000) < 0.3
    before = kc.compact.launches
    fg = pf.filter_table(gpu, att.column(pred, device=cuda_device))
    assert kc.compact.launches == before + 1
    fc = pf.filter_table(cpu, att.column(pred, device="cpu"))
    assert fg.to_pydict() == fc.to_pydict()
    for name in ("s", "t"):
        assert torch.equal(fg.column(name).data.cpu(), fc.column(name).data)
    eg, ec = ps.dictionary_encode(gpu.column("s")), \
        ps.dictionary_encode(cpu.column("s"))
    assert eg.codes.device.type == "cuda" and \
        torch.equal(eg.codes.cpu(), ec.codes)
    assert ps.dictionary_decode(eg).to_pylist() == \
        ps.dictionary_decode(ec).to_pylist()
    assert concat([gpu.column("s"), gpu.column("t")]).to_pylist() == \
        concat([cpu.column("s"), cpu.column("t")]).to_pylist()
    kt = key_table(rng, 3000)
    aggs = [AggSpec(*a) for a in STRING_AGGS]
    before = kg.grouped_aggregate.launches
    og = group_by(port_table(kt, cuda_device), ["k"], aggs)
    assert kg.grouped_aggregate.launches > before
    assert og.to_pydict() == group_by(port_table(kt), ["k"], aggs) \
        .to_pydict()
    right = at.Table.from_pydict({"i": at.column(np.arange(10)
                                                 .astype(np.int32)),
                                  "w": string_column(rng, 10, 0.0)})
    jg = pj.join(gpu, port_table(right, cuda_device), ["i"])
    jc = pj.join(cpu, port_table(right), ["i"])
    assert jg.to_pydict() == jc.to_pydict()
    tg = take_table(gpu, torch.arange(5, device=cuda_device))
    assert tg.to_pydict() == take_table(cpu, torch.arange(5)).to_pydict()
