"""The string kernels of ops/strings.py on every string layout, against
the JAX package on the CPU: like, ilike, nlike, nilike, starts_with,
ends_with, contains, regexp_is_match, regexp_match, substring, upper,
lower, concat_elements, length, octet_length and bit_length over utf8,
large_utf8, binary, utf8_view, sliced and dictionary columns (a null
value slot included), with nulls, empty strings and multibyte UTF-8;
LIKE escapes, the `i` regex flag and patterns the native regex engine
declines; decimal `rem` held to the reference's outcome.

Every comparison is exact: values, validity and dtype, or errors of the
same name (`same_outcome`).  Two reference faults are recorded by tests
that assert both sides: C14 (int32 offsets under a large_utf8 type) and
C15 (per-value transforms retag the result utf8).  Inputs are made from
a seed with numpy; n is small (the reference runs jnp on the CPU).
"""

import importlib
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.core.column import DictionaryColumn, StringColumn
from arrow_tpu_torch.ops import numeric as pn, strings as ps
from arrow_tpu_torch.utils import hostcodec
from torch_port_util import (assert_columns_equal, assert_same,  # noqa: F401
                             cuda_device, port_column, same_outcome)

rstr = importlib.import_module("arrow_tpu.ops.strings")
rnum = importlib.import_module("arrow_tpu.ops.numeric")
rdt = at.dtypes
N = 240
ASCII = ["", "a", "ab", "abc", "b%c", "a_b", "special requests", "xyz",
         "Brand#45", "MEDIUM POLISHED TIN", "forest green", "a\\%b"]
WIDE = ASCII + ["é", "éa", "日本語", "ÉCOLE", "straße"]


def draw(rng, n=N, pool=WIDE, nulls=0.15) -> list:
    pick = rng.integers(0, len(pool), n)
    null = rng.random(n) < nulls
    return [None if z else pool[i] for i, z in zip(pick, null)]


def layout(name: str, values: list):
    """A reference column of `values` in one string layout."""
    if name == "utf8":
        return at.column(pa.array(values, pa.string()))
    if name == "large_utf8":
        return at.column(pa.array(values, pa.large_string()))
    if name == "binary":
        return at.column(pa.array([None if v is None else v.encode()
                                   for v in values], pa.binary()))
    if name == "utf8_view":
        return at.column(pa.array(values, pa.string_view()))
    if name == "sliced":
        return at.column(pa.array(values, pa.string())).slice(7, len(values)
                                                              - 20)
    if name == "dictionary":
        return rstr.dictionary_encode(at.column(pa.array(values,
                                                         pa.string())))
    if name == "dictionary_null_slot":
        # a null value slot the codes point at: the slot validity folds in
        base = at.column(pa.array(values, pa.string()))
        d = rstr.dictionary_encode(base)
        vals = d.values.to_pylist_host() + [None]
        codes = np.asarray(d.codes).copy()
        codes[::11] = len(vals) - 1
        return at.DictionaryColumn(jnp.asarray(codes), at.column(
            vals, rdt.utf8), d.validity)
    raise KeyError(name)


LAYOUTS = ["utf8", "large_utf8", "binary", "utf8_view", "sliced",
           "dictionary", "dictionary_null_slot"]


def check(port_fn, ref_fn, what, fix_dtype=None):
    """Equal outcomes; where the reference's type is a known fault
    (C14/C15), equal values under the port's `fix_dtype`."""
    if fix_dtype is None:
        return same_outcome(port_fn, ref_fn, what, masks=True)
    got, want = port_fn(), ref_fn()
    assert repr(got.dtype) == repr(fix_dtype), (what, got.dtype)
    assert_same(got.to_pylist(), want.to_pylist(), what)


# ---- predicates -------------------------------------------------------------

PREDICATES = [
    ("like", "a%"), ("like", "%b"), ("like", "_"), ("like", "a\\%b"),
    ("like", "a\\_b"), ("like", "%special%requests%"), ("like", ""),
    ("like", "é%"), ("ilike", "A%"), ("ilike", "%SPECIAL%"),
    ("ilike", "É%"), ("nlike", "%special%requests%"), ("nlike", "_b%"),
    ("nilike", "%B%"), ("nilike", "ÉCOLE"), ("starts_with", "forest"),
    ("starts_with", ""), ("ends_with", "TIN"), ("ends_with", "é"),
    ("contains", "green"), ("contains", "%"), ("contains", "本"),
]


@pytest.mark.parametrize("fn,pattern", PREDICATES,
                         ids=[f"{f}-{p!r}" for f, p in PREDICATES])
@pytest.mark.parametrize("name", LAYOUTS)
def test_predicates(name, fn, pattern):
    rng = np.random.default_rng(len(pattern) * 7 + LAYOUTS.index(name))
    col = layout(name, draw(rng))
    check(lambda: getattr(ps, fn)(port_column(col), pattern),
          lambda: getattr(rstr, fn)(col, pattern), f"{name} {fn}")


def test_ilike_ascii_data_takes_the_native_pass(monkeypatch):
    """ASCII data and pattern: one native pass (no per-value Python);
    non-ASCII data: the per-value path, still equal to the reference."""
    rng = np.random.default_rng(3)
    ref = layout("utf8", draw(rng, pool=ASCII))
    calls = []
    real = hostcodec.bytes_match
    monkeypatch.setattr(hostcodec, "bytes_match",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    check(lambda: ps.ilike(port_column(ref), "%A%"),
          lambda: rstr.ilike(ref, "%A%"), "ascii ilike")
    assert len(calls) == 1 and calls[0][3] == hostcodec.MATCH_LIKE
    wide = layout("utf8", draw(rng))
    check(lambda: ps.ilike(port_column(wide), "%É%"),
          lambda: rstr.ilike(wide, "%É%"), "non-ascii ilike")
    assert len(calls) == 1


REGEXES = [("a.b", ""), ("^a", ""), ("c$", ""), ("[0-9]+", ""),
           ("special.*requests", ""), ("A", "i"), ("(\\w+) (\\w+)", ""),
           ("(a)\\1", ""), ("(?=b)", ""), ("\\bre", ""), ("é", ""),
           ("É", "i")]


@pytest.mark.parametrize("pattern,flags", REGEXES,
                         ids=[f"{p!r}{f}" for p, f in REGEXES])
@pytest.mark.parametrize("name", ["utf8", "large_utf8", "utf8_view",
                                  "sliced", "dictionary",
                                  "dictionary_null_slot"])
def test_regexp_is_match(name, pattern, flags):
    rng = np.random.default_rng(11 + len(pattern))
    col = layout(name, draw(rng))
    check(lambda: ps.regexp_is_match(port_column(col), pattern, flags),
          lambda: rstr.regexp_is_match(col, pattern, flags),
          f"{name} regexp_is_match {pattern!r}")


def test_regexp_errors_and_declined_patterns():
    """A bad pattern raises re.error in both (validated by `re` first);
    the native engine declines a backreference and takes a plain class."""
    col = layout("utf8", draw(np.random.default_rng(5)))
    same_outcome(lambda: ps.regexp_is_match(port_column(col), "(a"),
                 lambda: rstr.regexp_is_match(col, "(a"), "bad pattern")
    assert hostcodec.regex_compile("(a)\\1") is None
    assert hostcodec.regex_compile("[a-z]+") is not None


@pytest.mark.parametrize("pattern,flags", [("(\\w+) (\\w+)", ""),
                                           ("a(b)?", ""), ("[0-9]", ""),
                                           ("É(C)", "i"), ("(x)(y)(z)", "")])
@pytest.mark.parametrize("name", ["utf8", "large_utf8", "sliced",
                                  "dictionary", "dictionary_null_slot"])
def test_regexp_match(name, pattern, flags):
    col = layout(name, draw(np.random.default_rng(13)))
    check(lambda: ps.regexp_match(port_column(col), pattern, flags),
          lambda: rstr.regexp_match(col, pattern, flags),
          f"{name} regexp_match {pattern!r}")


# ---- transforms -------------------------------------------------------------

SUBSTRINGS = [(0, 2), (1, None), (-2, None), (-3, 2), (5, 1), (0, 0),
              (2, 100)]


@pytest.mark.parametrize("start,length", SUBSTRINGS)
@pytest.mark.parametrize("name", ["utf8", "binary", "utf8_view", "sliced",
                                  "dictionary", "dictionary_null_slot"])
def test_substring(name, start, length):
    col = layout(name, draw(np.random.default_rng(17)))
    check(lambda: ps.substring(port_column(col), start, length),
          lambda: rstr.substring(col, start, length),
          f"{name} substring {start} {length}")


@pytest.mark.parametrize("fn", ["upper", "lower"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_case_ascii(name, fn):
    col = layout(name, draw(np.random.default_rng(19), pool=ASCII))
    check(lambda: getattr(ps, fn)(port_column(col)),
          lambda: getattr(rstr, fn)(col), f"{name} {fn}")


@pytest.mark.parametrize("fn", ["upper", "lower"])
@pytest.mark.parametrize("name", ["utf8", "sliced", "dictionary",
                                  "dictionary_null_slot"])
def test_case_unicode(name, fn):
    """Non-ASCII bytes: the native pass declines, str.upper / str.lower
    map each distinct value."""
    col = layout(name, draw(np.random.default_rng(23)))
    check(lambda: getattr(ps, fn)(port_column(col)),
          lambda: getattr(rstr, fn)(col), f"{name} {fn}")


def test_reference_retags_per_value_transforms_utf8():
    """ROADMAP C15: where the reference maps values one by one (non-ASCII
    case, a dictionary's substring), its result is utf8 whatever the
    input's type (strings.py:446-456 builds the values with
    StringColumn.from_pylist's default).  pyarrow keeps large_string, as
    the port does; the values are equal."""
    values = draw(np.random.default_rng(29))
    large = layout("large_utf8", values)
    want = rstr.upper(large)
    assert want.dtype == rdt.utf8
    got = ps.upper(port_column(large))
    assert got.dtype == att.dtypes.large_utf8
    assert got.offsets.dtype == torch.int64
    assert_same(got.to_pylist(), want.to_pylist(), "upper")
    theirs = pa.compute.utf8_upper(pa.array(values, pa.large_string()))
    assert theirs.type == pa.large_string()
    # one difference of case rules, not of the port (ROADMAP C16):
    # pyarrow maps ß to ẞ, Python's str.upper (and Rust's to_uppercase,
    # which arrow-rs uses) to SS
    assert [v for v in got.to_pylist() if v is None or "SS" not in v] == \
        [v for v in theirs.to_pylist() if v is None or "ẞ" not in v]
    assert "STRASSE" in got.to_pylist() and "STRAẞE" in theirs.to_pylist()
    view = layout("utf8_view", values)
    check(lambda: ps.lower(port_column(view)), lambda: rstr.lower(view),
          "utf8_view lower", fix_dtype=att.dtypes.utf8_view)


def test_reference_large_utf8_offsets_are_int32():
    """ROADMAP C14: the reference's column() of a large_utf8 type and its
    substring of a large_utf8 column write int32 offsets
    (arrow_tpu/core/column.py:241, ops/strings.py:466); pyarrow's
    large_string has int64 offsets, and so has the port's, with equal
    values."""
    values = draw(np.random.default_rng(31))
    built = at.column(values, rdt.large_utf8)
    assert np.asarray(built.offsets).dtype == np.int32
    ported = att.column(values, att.dtypes.large_utf8, device="cpu")
    assert ported.offsets.dtype == torch.int64
    np.testing.assert_array_equal(ported.offsets.numpy(),
                                  np.asarray(built.offsets))
    large = layout("large_utf8", values)
    assert np.asarray(large.offsets).dtype == np.int64
    want = rstr.substring(large, 1, 3)
    assert np.asarray(want.offsets).dtype == np.int32
    got = ps.substring(port_column(large), 1, 3)
    assert got.offsets.dtype == torch.int64 and \
        got.dtype == att.dtypes.large_utf8 == port_column(want).dtype
    assert_columns_equal(got, want, "substring large_utf8")


CONCAT = [("utf8", "utf8"), ("dictionary", "dictionary"),
          ("dictionary", "utf8"), ("utf8", "dictionary"),
          ("dictionary_null_slot", "utf8"), ("sliced", "sliced")]


@pytest.mark.parametrize("left,right", CONCAT,
                         ids=[f"{a}+{b}" for a, b in CONCAT])
def test_concat_elements(left, right):
    rng = np.random.default_rng(37)
    lhs, rhs = layout(left, draw(rng)), layout(right, draw(rng))
    check(lambda: ps.concat_elements(port_column(lhs), port_column(rhs)),
          lambda: rstr.concat_elements(lhs, rhs), f"{left} + {right}")


# ---- lengths ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["length", "octet_length", "bit_length"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_lengths(name, fn):
    col = layout(name, draw(np.random.default_rng(41)))
    check(lambda: getattr(ps, fn)(port_column(col)),
          lambda: getattr(rstr, fn)(col), f"{name} {fn}")


NESTED = {
    "list": pa.array([[1, 2], None, [], [3]], pa.list_(pa.int64())),
    "large_list": pa.array([[1], [], None, [2, 3, 4]],
                           pa.large_list(pa.int32())),
    "map": pa.array([[("a", 1)], None, [("b", 2), ("c", 3)]],
                    pa.map_(pa.string(), pa.int64())),
    "list_view": pa.ListViewArray.from_arrays(
        pa.array([0, 1, 0], pa.int32()), pa.array([2, 1, 0], pa.int32()),
        pa.array([5, 6, 7])),
    "fixed_size_list": pa.array([[1, 2], None, [3, 4]],
                                pa.list_(pa.int64(), 2)),
    "fixed_size_binary": pa.array([b"abc", None, b"xyz"], pa.binary(3)),
}


@pytest.mark.parametrize("name", list(NESTED))
def test_length_of_lists_and_fixed_sizes(name):
    col = at.column(NESTED[name])
    check(lambda: ps.length(port_column(col)), lambda: rstr.length(col),
          f"length {name}")


def test_lengths_and_gathers_past_int32_positions(monkeypatch):
    """Past 2^31 bytes length's prefix sum and range_gather's index run
    in int64: INDEX32_LIMIT lowered to 8 takes that route over a small
    large_utf8 column, with the same results as the int32 route."""
    ptake = importlib.import_module("arrow_tpu_torch.ops.take")
    pconcat = importlib.import_module("arrow_tpu_torch.ops.concat")
    pfilter = importlib.import_module("arrow_tpu_torch.ops.filter")
    col = att.column(draw(np.random.default_rng(43)), att.dtypes.large_utf8,
                     device="cpu")
    idx = torch.from_numpy(np.random.default_rng(44).permutation(len(col)))
    keep = att.column(np.arange(len(col)) % 3 != 0, device="cpu")
    calls = lambda: (ps.length(col), ptake.take(col, idx),
                     pfilter.filter(col, keep),
                     pconcat.concat([col.slice(0, 50), col.slice(50, 150)]))
    narrow = calls()
    monkeypatch.setattr(ptake, "INDEX32_LIMIT", 8)
    src = ptake.range_gather(col.offsets, idx, len(col.data))[1]
    assert src.dtype == torch.int64
    for a, b in zip(calls(), narrow):
        assert a.dtype == b.dtype == att.dtypes.large_utf8 or \
            a.dtype == b.dtype == att.dtypes.int32
        assert a.to_pylist() == b.to_pylist()
        if isinstance(a, StringColumn):
            assert a.offsets.dtype == torch.int64


def test_port_dictionary_predicate_gathers_on_the_codes_device():
    """A dictionary's per-value mask is gathered by its codes: one native
    pass over the distinct values, not the rows."""
    rng = np.random.default_rng(47)
    ref = layout("dictionary", draw(rng, n=2000))
    col = port_column(ref)
    assert isinstance(col, DictionaryColumn)
    seen = []
    real = hostcodec.bytes_match
    try:
        hostcodec.bytes_match = lambda o, d, *a: seen.append(len(o) - 1) \
            or real(o, d, *a)
        out = ps.like(col, "%a%")
    finally:
        hostcodec.bytes_match = real
    assert seen == [len(col.values)]
    assert_columns_equal(out, rstr.like(ref, "%a%"), "like dictionary")


def test_bytes_match_in_row_ranges(monkeypatch):
    """Past PARALLEL_ROWS rows the matcher runs in row ranges across
    threads, with the one-range result."""
    col = att.column(draw(np.random.default_rng(49), n=5000), device="cpu")
    offs, data = ps._host_buffers(col)
    want = hostcodec.bytes_match(offs, data, b"%a%", hostcodec.MATCH_LIKE)
    monkeypatch.setattr(hostcodec, "PARALLEL_ROWS", 700)
    for op, pat in ((hostcodec.MATCH_LIKE, b"%a%"),
                    (hostcodec.MATCH_CONTAINS, b"b"),
                    (hostcodec.MATCH_ENDS, b"c")):
        got = hostcodec.bytes_match(offs, data, pat, op, True)
        monkeypatch.setattr(hostcodec, "PARALLEL_ROWS", 1 << 20)
        assert np.array_equal(got, hostcodec.bytes_match(offs, data, pat, op,
                                                         True))
        monkeypatch.setattr(hostcodec, "PARALLEL_ROWS", 700)
    assert np.array_equal(hostcodec.bytes_match(
        offs, data, b"%a%", hostcodec.MATCH_LIKE), want)


def test_hostcodec_bindings_match_the_reference():
    """The port's own ctypes bindings give the reference's bindings'
    results on the same buffers."""
    nt = importlib.import_module("arrow_tpu.utils.native")
    col = att.column(draw(np.random.default_rng(51), n=600), device="cpu")
    offs, data = ps._host_buffers(col)
    for op, pat in ((hostcodec.MATCH_LIKE, b"a%"),
                    (hostcodec.MATCH_STARTS, b"ab"),
                    (hostcodec.MATCH_ENDS, b"c"),
                    (hostcodec.MATCH_CONTAINS, b"\xc3"),
                    (hostcodec.MATCH_EQ, b"xyz")):
        for ci in (False, True):
            assert np.array_equal(hostcodec.bytes_match(offs, data, pat, op,
                                                        ci),
                                  nt.bytes_match(offs, data, pat, op, ci))
    assert np.array_equal(hostcodec.bytes_cmp_scalar(offs, data, b"abc"),
                          nt.bytes_cmp_scalar(offs, data, b"abc"))
    for up in (True, False):
        got, want = hostcodec.ascii_case(data, up), nt.ascii_case(data, up)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    for start, length in ((1, 2), (-2, None), (0, 0)):
        for a, b in zip(hostcodec.utf8_substring(offs, data, start, length),
                        nt.utf8_substring(offs, data, start, length)):
            assert np.array_equal(a, b)
    assert np.array_equal(hostcodec.utf8_char_lengths(offs, data),
                          nt.utf8_char_lengths(offs, data))
    ascii_offs, ascii_data = ps._host_buffers(att.column(
        draw(np.random.default_rng(52), n=600, pool=ASCII), device="cpu"))
    h, r = hostcodec.regex_compile("a.c|sp"), nt.regex_compile("a.c|sp")
    assert np.array_equal(hostcodec.regex_match(h, ascii_offs, ascii_data),
                          nt.regex_match(r, ascii_offs, ascii_data))


# ---- decimal rem ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["decimal32(7, 2)", "decimal64(15, 2)",
                                   "decimal128(20, 2)", "decimal256(40, 3)"])
def test_decimal_rem_follows_the_reference(dtype):
    """decimal128/256 rem raises ArrowTypeError as the reference does
    (its binary kernel takes primitive columns only); decimal32/64 take
    the storage integers' remainder, as the reference does."""
    name, args = dtype.split("(")
    d = getattr(rdt, name)(*map(int, args[:-1].split(",")))
    rng = np.random.default_rng(53)
    ints = rng.integers(-50_000, 50_000, 64)
    if d.name in ("decimal128", "decimal256"):
        vals = [None if i % 9 == 0 else Decimal(int(x)).scaleb(-d.scale)
                for i, x in enumerate(ints)]
        divs = [Decimal(int(x) % 97 + 1).scaleb(-d.scale) for x in ints]
    else:
        vals = [None if i % 9 == 0 else int(x) for i, x in enumerate(ints)]
        divs = [int(x) % 97 + 1 for x in ints]
    a, b = at.column(vals, d), at.column(divs, d)
    same_outcome(lambda: pn.rem(port_column(a), port_column(b)),
                 lambda: rnum.rem(a, b), f"rem {dtype}")


# ---- the new layouts through take, filter, concat, cast and the keys -------

pcast = importlib.import_module("arrow_tpu_torch.ops.cast")
ptake = importlib.import_module("arrow_tpu_torch.ops.take")
pfilter = importlib.import_module("arrow_tpu_torch.ops.filter")
pconcat = importlib.import_module("arrow_tpu_torch.ops.concat")
psort = importlib.import_module("arrow_tpu_torch.ops.sort")
pgroup = importlib.import_module("arrow_tpu_torch.ops.groupby")
pjoin = importlib.import_module("arrow_tpu_torch.ops.join")
rcast = importlib.import_module("arrow_tpu.ops.cast")
rtake = importlib.import_module("arrow_tpu.ops.take")
rfilter = importlib.import_module("arrow_tpu.ops.filter")
rconcat = importlib.import_module("arrow_tpu.ops.concat")
rsort = importlib.import_module("arrow_tpu.ops.sort")
rgroup = importlib.import_module("arrow_tpu.ops.groupby")
rjoin = importlib.import_module("arrow_tpu.ops.join")
NEW_LAYOUTS = ["large_utf8", "binary", "utf8_view", "large_binary",
               "binary_view"]


def new_layout(name: str, values: list):
    if name in ("large_binary", "binary_view"):
        t = pa.large_binary() if name == "large_binary" else pa.binary_view()
        return at.column(pa.array([None if v is None else v.encode()
                                   for v in values], t))
    return layout(name, values)


@pytest.mark.parametrize("name", NEW_LAYOUTS)
def test_take_filter_concat(name):
    """take by indices with nulls, filter, filter_table with a primitive
    column aboard (K1's positions take the strings), concat of slices."""
    from torch_port_util import port_table
    rng = np.random.default_rng(59)
    col = new_layout(name, draw(rng))
    idx = at.column(rng.integers(0, N, 300), validity=rng.random(300) > 0.1)
    same_outcome(lambda: ptake.take(port_column(col), port_column(idx)),
                 lambda: rtake.take(col, idx), f"take {name}", masks=True)
    keep = at.column(rng.random(N) < 0.4, validity=rng.random(N) > 0.1)
    same_outcome(lambda: pfilter.filter(port_column(col), port_column(keep)),
                 lambda: rfilter.filter(col, keep), f"filter {name}")
    t = at.Table.from_pydict({"s": col, "v": at.column(np.arange(N))})
    got = pfilter.filter_table(port_table(t), port_column(keep))
    want = rfilter.filter_table(t, keep)
    for g, w in zip(got.columns, want.columns):
        assert_columns_equal(g, w, f"filter_table {name}")
    parts = [col.slice(0, 50), col.slice(50, 100), col.slice(150, N - 150)]
    same_outcome(lambda: pconcat.concat([port_column(p) for p in parts]),
                 lambda: rconcat.concat(parts), f"concat {name}")


STRING_TYPES = ["utf8", "large_utf8", "utf8_view", "binary", "large_binary",
                "binary_view"]


@pytest.mark.parametrize("to", STRING_TYPES)
@pytest.mark.parametrize("src", STRING_TYPES)
def test_casts_among_string_types(src, to):
    """Every pair of the six string and binary types: the same bytes
    under the target type, the offsets at its width; can_cast agrees."""
    col = new_layout(src, draw(np.random.default_rng(61), pool=ASCII))
    pto, rto = getattr(att.dtypes, to), getattr(rdt, to)
    assert pcast.can_cast(port_column(col).dtype, pto) == \
        rcast.can_cast(col.dtype, rto)
    got = pcast.cast(port_column(col), pto)
    want = rcast.cast(col, rto)
    assert_columns_equal(got, want, f"{src} -> {to}", masks=True)
    assert got.offsets.dtype == (torch.int64 if to.startswith("large")
                                 else torch.int32)


@pytest.mark.parametrize("to", ["int64", "float64", "date32",
                                "fixed_size_binary"])
@pytest.mark.parametrize("src", ["large_utf8", "utf8_view", "large_binary"])
def test_parse_casts_from_new_layouts(src, to):
    pool = {"int64": ["1", "-20", "x", ""], "float64": ["1.5", "nan", "z"],
            "date32": ["2020-01-02", "1999-12-31", "bad"],
            "fixed_size_binary": ["abcd", "ab", "wxyz"]}[to]
    col = new_layout(src, draw(np.random.default_rng(67), pool=pool))
    pto = att.dtypes.fixed_size_binary(4) if to == "fixed_size_binary" \
        else getattr(att.dtypes, to)
    rto = rdt.fixed_size_binary(4) if to == "fixed_size_binary" \
        else getattr(rdt, to)
    same_outcome(lambda: pcast.cast(port_column(col), pto),
                 lambda: rcast.cast(col, rto), f"{src} -> {to}")


@pytest.mark.parametrize("name", NEW_LAYOUTS)
def test_keys_of_new_layouts(name):
    """Sort, group_by and join keys of the new layouts ride
    dictionary_encode, as utf8 keys do."""
    from torch_port_util import assert_tables_equal, port_table
    rng = np.random.default_rng(71)
    col = new_layout(name, draw(rng, pool=WIDE[:9]))
    got = psort.sort_to_indices(port_column(col))
    want = rsort.sort_to_indices(col)
    assert got.values.tolist() == np.asarray(want.values).tolist()
    t = at.Table.from_pydict({"k": col, "v": at.column(rng.integers(0, 9, N))})
    aggs = [("v", "sum"), ("v", "count_all"), ("k", "min")]
    assert_tables_equal(
        pgroup.group_by(port_table(t), ["k"],
                        [pgroup.AggSpec(*a) for a in aggs]),
        rgroup.group_by(t, ["k"], [rgroup.AggSpec(*a) for a in aggs]))
    right = at.Table.from_pydict({"k": new_layout(name, WIDE[:9]),
                                  "w": at.column(np.arange(9))})
    got = pjoin.join(port_table(t), port_table(right), ["k"], how="inner")
    want = rjoin.join(t, right, ["k"], how="inner")
    assert_tables_equal(got, want)


# ---- on the card ------------------------------------------------------------

def _outcome(fn):
    """fn's result, or the name of the error it raised."""
    try:
        return fn()
    except Exception as e:                 # compared by name
        return type(e).__name__


def test_string_kernels_on_the_card_match_the_cpu_route(cuda_device):
    """Every string kernel over each layout on the card: its result on
    the column's device, equal bit for bit to the same call on the CPU
    copy (the host pass sees the same bytes either way)."""
    from torch_port_util import buffers
    rng = np.random.default_rng(73)
    for name in ("utf8", "large_utf8", "binary", "utf8_view", "dictionary"):
        ref = new_layout(name, draw(rng, n=3000)) if name != "dictionary" \
            else layout(name, draw(rng, n=3000))
        cpu, gpu = port_column(ref), port_column(ref, cuda_device)
        calls = [(ps.like, "%a%"), (ps.ilike, "%A%"), (ps.nlike, "_b%"),
                 (ps.starts_with, "a"), (ps.ends_with, "c"),
                 (ps.contains, "é"), (ps.regexp_is_match, "a.b"),
                 (ps.substring, 1), (ps.length,), (ps.octet_length,),
                 (ps.bit_length,)]
        if name != "binary":
            calls += [(ps.upper,), (ps.lower,), (ps.regexp_match, "(a)(b)")]
        for fn, *args in calls:
            got, want = (_outcome(lambda c=c: fn(c, *args))
                         for c in (gpu, cpu))
            if isinstance(want, str):          # an error, of the same name
                assert got == want, (name, fn.__name__)
                continue
            assert got.device == gpu.device, (name, fn.__name__)
            assert repr(got.dtype) == repr(want.dtype)
            assert buffers(got) == buffers(want), (name, fn.__name__)
        got = ps.concat_elements(gpu, gpu)
        assert buffers(got) == buffers(ps.concat_elements(cpu, cpu))
