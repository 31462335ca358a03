"""SQL frontend over the engine's kernels (counterpart of
arrow_tpu/sql.py).

The reference ships no SQL engine (arrow-rs FlightSQL sql/server.rs
delegates query execution to the application) — this module is the
application-side executor for this engine's FlightSQL service and CLI.
Every clause lowers onto the engine's own operators: WHERE -> ops.cmp/
boolean + filter, JOIN -> ops.join, GROUP BY/aggregates -> ops.groupby,
ORDER BY -> ops.sort, projection/expressions -> ops.numeric/strings/
cast.

Supported grammar:

    SELECT expr [AS alias] [, ...] | *
    FROM t [ [INNER|LEFT] JOIN t2 ON t.a = t2.b ]
    [WHERE <bool expr>]
    [GROUP BY col [, ...]] [HAVING <bool expr over aggregates>]
    [ORDER BY expr [ASC|DESC] [, ...]]
    [LIMIT n [OFFSET m]]

Expressions: +-*/%, comparisons, AND/OR/NOT, parentheses, IS [NOT]
NULL, [NOT] IN (...), BETWEEN a AND b, [NOT] LIKE, CAST(e AS type),
ABS/UPPER/LOWER/LENGTH/COALESCE, aggregates COUNT(*)/COUNT/SUM/MIN/
MAX/AVG.

A statement runs on the device of the tables it reads (tables on two
devices raise) and reads only the columns it names: each table is cut to
them before its joins and its WHERE (SELECT * reads every one).  Before
the joins, each table is filtered by the WHERE's conjuncts that name it
alone (`_pushdown`); the rest of the WHERE runs after them.  WHERE
and HAVING filter through `filter_table` (the compaction kernel on a
card), GROUP BY runs `group_by` (the grouped-aggregation kernel on the
dictionary and small-domain plans, the compaction kernel at the sort
plan's run starts), JOIN runs `ops.join.join`, ORDER BY
`lexsort_to_indices` and `take_table`.  A literal used as a column is a
fill of the table's row count on that device, of the dtype `column()`
infers for it (int64, float64, bool, utf8 or null).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import datetime
import decimal
import math

import numpy as np
import torch

from . import dtypes as dt
from .config import DeviceLike, resolve_device
from .core.column import (Column, NullColumn, PrimitiveColumn, StringColumn,
                          column as make_col)
from .core.datum import scalar as make_scalar
from .core.table import Table
from .errors import ArrowInvalid
from .storage import Delta, TableVersion
from .utils.trace import annotate, count, span, to_host

__all__ = ["execute_sql", "execute_sql_update", "bind_sql_params"]


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d*|\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|<>|!=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.|;)
    )""", re.VERBOSE)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order",
    "limit", "offset", "as", "and", "or", "not", "in", "between",
    "like", "is", "null", "true", "false", "asc", "desc", "join",
    "inner", "left", "on", "cast", "distinct",
}


# an IN list of integer literals alone is read as one token
_INTS = re.compile(r"\(\s*+(-?\d++(?:\s*+,\s*+-?\d++)*+)\s*+\)")
_INT64 = np.iinfo(np.int64)


def _int_run(q: str, at: int):
    """(the integers as an int64 array, end) of a parenthesized list of
    integer literals starting at `at`; None where there is none or an
    item is past int64."""
    m = _INTS.match(q, at)
    if m is None:
        return None
    text = m.group(1)
    ints = np.fromstring(text, dtype=np.int64, sep=",")  # saturates
    if ints.min() == _INT64.min or ints.max() == _INT64.max:
        try:
            ints = np.array([int(x) for x in text.split(",")], np.int64)
        except OverflowError:
            return None
    return ints, m.end()


def _tokenize(q: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(q):
        if out and out[-1] == ("kw", "in"):
            run = _int_run(q, len(q) - len(q[pos:].lstrip()))
            if run is not None:
                out.append(("ints", run[0]))
                pos = run[1]
                continue
        m = _TOKEN.match(q, pos)
        if not m:
            if q[pos:].strip() == "":
                break
            raise ArrowInvalid(f"SQL tokenize error at {q[pos:pos+20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", m.group("num")))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("id") is not None:
            low = m.group("id").lower()
            out.append(("kw" if low in _KEYWORDS else "id",
                        low if low in _KEYWORDS else m.group("id")))
        else:
            op = m.group("op")
            if op == ";":
                break
            out.append(("op", op))
    out.append(("end", ""))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Lit:
    value: object


@dataclass
class Col:
    table: Optional[str]
    name: str


@dataclass
class Bin:
    op: str
    left: object
    right: object


@dataclass
class Un:
    op: str            # not / neg / isnull / notnull
    operand: object


@dataclass
class Func:
    name: str
    args: list
    cast_to: Optional[str] = None


@dataclass
class Agg:
    fn: str            # count/sum/min/max/avg/count_all
    arg: object        # expr or None for count(*)


@dataclass
class InList:
    expr: object
    items: list
    negated: bool
    ints: Optional[np.ndarray] = None    # a list of integers, as read


def _items(e: InList) -> list:
    """An IN list's items as expressions."""
    return e.items if e.ints is None else [Lit(v) for v in e.ints.tolist()]


@dataclass
class Between:
    expr: object
    lo: object
    hi: object


@dataclass
class LikeOp:
    expr: object
    pattern: str
    negated: bool


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, typ, val=None):
        t = self.peek()
        if t[0] == typ and (val is None or t[1] == val):
            self.i += 1
            return t
        return None

    def expect(self, typ, val=None):
        t = self.accept(typ, val)
        if t is None:
            raise ArrowInvalid(
                f"SQL parse error: expected {val or typ}, got "
                f"{self.peek()!r}")
        return t

    # -- expression grammar (precedence climbing) --
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = Bin("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.accept("kw", "and"):
            e = Bin("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.accept("kw", "not"):
            return Un("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        e = self.add_expr()
        t = self.peek()
        if t[0] == "op" and t[1] in ("=", "!=", "<>", "<", "<=", ">",
                                     ">="):
            self.next()
            return Bin(t[1], e, self.add_expr())
        if t == ("kw", "is"):
            self.next()
            neg = self.accept("kw", "not") is not None
            self.expect("kw", "null")
            return Un("notnull" if neg else "isnull", e)
        neg = False
        if t == ("kw", "not"):
            self.next()
            neg = True
            t = self.peek()
        if t == ("kw", "in"):
            self.next()
            if self.peek()[0] == "ints":
                return InList(e, [], neg, self.next()[1])
            self.expect("op", "(")
            items = [self.expr()]
            while self.accept("op", ","):
                items.append(self.expr())
            self.expect("op", ")")
            return InList(e, items, neg)
        if t == ("kw", "between"):
            self.next()
            lo = self.add_expr()
            self.expect("kw", "and")
            hi = self.add_expr()
            out = Between(e, lo, hi)
            return Un("not", out) if neg else out
        if t == ("kw", "like"):
            self.next()
            pat = self.expect("str")[1]
            return LikeOp(e, pat, neg)
        if neg:
            raise ArrowInvalid("SQL parse error after NOT")
        return e

    def add_expr(self):
        e = self.mul_expr()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("+", "-"):
                self.next()
                e = Bin(t[1], e, self.mul_expr())
            else:
                return e

    def mul_expr(self):
        e = self.unary()
        while True:
            t = self.peek()
            if t[0] == "op" and t[1] in ("*", "/", "%"):
                self.next()
                e = Bin(t[1], e, self.unary())
            else:
                return e

    def unary(self):
        if self.accept("op", "-"):
            return Un("neg", self.unary())
        if self.accept("op", "+"):
            return self.unary()
        return self.atom()

    def atom(self):
        t = self.peek()
        if t[0] == "num":
            self.next()
            return Lit(float(t[1]) if "." in t[1] else int(t[1]))
        if t[0] == "str":
            self.next()
            return Lit(t[1])
        if t == ("kw", "null"):
            self.next()
            return Lit(None)
        if t == ("kw", "true"):
            self.next()
            return Lit(True)
        if t == ("kw", "false"):
            self.next()
            return Lit(False)
        if t == ("kw", "cast"):
            self.next()
            self.expect("op", "(")
            e = self.expr()
            self.expect("kw", "as")
            ty = self.expect("id")[1]
            self.expect("op", ")")
            return Func("cast", [e], cast_to=ty)
        if self.accept("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        if t[0] == "id":
            self.next()
            name = t[1]
            if self.accept("op", "("):          # function / aggregate
                low = name.lower()
                if low == "count" and self.accept("op", "*"):
                    self.expect("op", ")")
                    return Agg("count_all", None)
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                if low in ("count", "sum", "min", "max", "avg"):
                    if len(args) != 1:
                        raise ArrowInvalid(f"{name} takes one argument")
                    return Agg("mean" if low == "avg" else low, args[0])
                return Func(low, args)
            if self.accept("op", "."):
                col = self.expect("id")[1]
                return Col(name, col)
            return Col(None, name)
        raise ArrowInvalid(f"SQL parse error at {t!r}")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

_CMP = {"=": "eq", "!=": "neq", "<>": "neq",
        "<": "lt", "<=": "lt_eq", ">": "gt", ">=": "gt_eq"}

_SQL_TYPES = {
    "int": dt.int64, "integer": dt.int64, "bigint": dt.int64,
    "smallint": dt.int16, "tinyint": dt.int8, "float": dt.float32,
    "real": dt.float32, "double": dt.float64, "varchar": dt.utf8,
    "text": dt.utf8, "string": dt.utf8, "boolean": dt.bool_,
    "bool": dt.bool_, "date": dt.date32,
}


def _sql_type(name: str) -> dt.DataType:
    low = name.lower()
    if low in _SQL_TYPES:
        return _SQL_TYPES[low]
    if low == "timestamp":
        return dt.timestamp("us")
    if hasattr(dt, low):
        v = getattr(dt, low)
        if isinstance(v, dt.DataType):
            return v
    raise ArrowInvalid(f"unknown SQL type {name!r}")


def _is_agg(e) -> bool:
    if isinstance(e, Agg):
        return True
    if isinstance(e, Bin):
        return _is_agg(e.left) or _is_agg(e.right)
    if isinstance(e, Un):
        return _is_agg(e.operand)
    if isinstance(e, Func):
        return any(_is_agg(a) for a in e.args)
    return False


def _rows_of(t) -> Table:
    """The rows a statement reads of a table or a table version
    (storage.TableVersion): every row written, deleted ones too; the
    version's live mask says which remain."""
    return t.table if isinstance(t, TableVersion) else t


def _live_of(t) -> Optional[torch.Tensor]:
    """A table version's live mask (None: no row deleted)."""
    return t.live if isinstance(t, TableVersion) else None


def _device_of(tables) -> Optional[torch.device]:
    """The one device of the tables' columns (None when they have no
    columns); tables on two devices raise."""
    devs = {c.device for t in tables for c in _rows_of(t).columns}
    if len(devs) > 1:
        raise ArrowInvalid(f"SQL over tables on several devices: "
                           f"{sorted(str(d) for d in devs)}")
    return next(iter(devs), None)


def _literal_column(v, n: int, dev: torch.device) -> Column:
    """`n` rows of the literal `v` on `dev`, typed as `column()` types a
    list of it: int64, float64, bool, utf8, or the null type."""
    if v is None:
        return NullColumn(n, dev)
    if isinstance(v, str):
        b = torch.tensor(list(v.encode()), dtype=torch.uint8, device=dev)
        if n * len(b) > torch.iinfo(torch.int32).max:
            raise ArrowInvalid(f"{n * len(b)} bytes overflow int32 offsets "
                               "of utf8")
        offs = torch.arange(n + 1, dtype=torch.int32, device=dev) * len(b)
        return StringColumn(offs, b.repeat(n), dt.utf8)
    d = {bool: dt.bool_, int: dt.int64, float: dt.float64}[type(v)]
    return PrimitiveColumn(torch.full((n,), v, dtype=d.to_torch(),
                                      device=dev), d, _canonical=True)


class _Evaluator:
    """Expression -> Column over a table (non-aggregate context) on the
    device `dev`."""

    def __init__(self, t: Table, aliases: Dict[str, str],
                 suffixes: Optional[Dict[str, str]] = None,
                 dev: Optional[torch.device] = None):
        self.t = t
        self.dev = dev if dev is not None \
            else _device_of([t]) or torch.device("cpu")
        self.aliases = aliases       # table alias -> table name
        self.suffixes = suffixes or {}   # table name -> join suffix

    def colname(self, e: Col) -> str:
        """The resolved PHYSICAL column name for a (maybe qualified)
        reference: the first of its `_candidates` the table has."""
        for c in _candidates(e, self.aliases, self.suffixes):
            if c in self.t.column_names:
                return c
        raise ArrowInvalid(f"no such column {e.name!r}")

    def col(self, e: Col) -> Column:
        return self.t.column(self.colname(e))

    def eval(self, e) -> Column:
        from .ops import boolean as b_ops
        from .ops import cmp as c_ops
        from .ops import numeric as n_ops
        if isinstance(e, Lit):
            # typed even when empty: the null dtype would break
            # arithmetic over empty tables
            return _literal_column(e.value, self.t.num_rows, self.dev)
        if isinstance(e, Col):
            return self.col(e)
        if isinstance(e, Bin):
            if e.op in ("and", "or"):
                lc, rc = self.eval(e.left), self.eval(e.right)
                return getattr(b_ops, f"{e.op}_kleene")(lc, rc)
            lc, rc = self._coerce_pair(e.left, e.right)
            if e.op in _CMP:
                return getattr(c_ops, _CMP[e.op])(lc, rc)
            fn = {"+": "add", "-": "sub", "*": "mul", "/": "div",
                  "%": "rem"}[e.op]
            return getattr(n_ops, fn)(lc, rc)
        if isinstance(e, Un):
            if e.op == "not":
                return b_ops.not_(self.eval(e.operand))
            if e.op == "neg":
                return n_ops.neg(self.eval(e.operand))
            c = self.eval(e.operand)
            m = b_ops.is_null(c)
            return b_ops.not_(m) if e.op == "notnull" else m
        if isinstance(e, InList):
            acc = self._member(e)
            if acc is None:
                for item in _items(e):
                    m = self.eval(Bin("=", e.expr, item))
                    acc = m if acc is None else b_ops.or_kleene(acc, m)
            if acc is None:
                acc = _literal_column(False, self.t.num_rows, self.dev)
            return b_ops.not_(acc) if e.negated else acc
        if isinstance(e, Between):
            lo = self.eval(Bin(">=", e.expr, e.lo))
            hi = self.eval(Bin("<=", e.expr, e.hi))
            return b_ops.and_kleene(lo, hi)
        if isinstance(e, LikeOp):
            from .ops import strings as s_ops
            m = s_ops.like(self.eval(e.expr), e.pattern)
            return b_ops.not_(m) if e.negated else m
        if isinstance(e, Func):
            return self._func(e)
        raise ArrowInvalid(f"cannot evaluate {e!r}")

    def _member(self, e: InList) -> Optional[Column]:
        """`e.expr IN (...)` as one membership test on the column's device,
        where the list is integer literals alone (read as one token) and
        the expression an integer column whose type holds every item: the
        distinct items as the column stores them, sorted, a binary search
        a row, one compare; NULL where the row is NULL, as the ORs of the
        per-item comparisons give it.  None otherwise (the items are then
        compared one by one)."""
        if e.ints is None:
            return None
        c = self.eval(e.expr)
        if not isinstance(c, PrimitiveColumn) or not c.dtype.is_integer:
            return None
        ints = torch.from_numpy(e.ints)
        lo, hi = dt.integer_bounds(c.dtype)
        if int(ints.min()) < lo or int(ints.max()) > hi:
            return None
        from .io.hostio import to_device
        test = to_device(ints.to(c.values.dtype).unique(), c.device)
        at = torch.searchsorted(test, c.values).clamp_(max=len(test) - 1)
        hit = test[at] == c.values
        if c.validity is not None:
            hit = hit & c.validity
        return PrimitiveColumn(hit, dt.bool_, c.validity, _canonical=True)

    def _coerce_pair(self, le, re_):
        """Evaluate a binary op's operands with SQL literal coercion:
        a literal takes the column side's dtype (int literal vs float
        column -> float scalar; float literal vs int column -> the
        COLUMN is widened to float64)."""
        from .ops.cast import cast as cast_kernel

        def typed_scalar(lit, other):
            v = lit.value
            d = other.dtype
            if isinstance(v, int) and d.is_floating:
                return make_scalar(float(v), d), other
            if isinstance(v, float) and d.is_integer:
                return make_scalar(v, dt.float64), \
                    cast_kernel(other, dt.float64)
            if isinstance(v, bool):
                return make_scalar(v), other
            if v is None:
                return make_scalar(None, d), other
            if isinstance(v, str):
                # cmp/strings kernels take raw str scalars (no tensor
                # representation exists for utf8 scalars)
                return v, other
            return make_scalar(v, d), other

        llit = isinstance(le, Lit)
        rlit = isinstance(re_, Lit)
        if llit and not rlit:
            rc = self.eval(re_)
            lc, rc = typed_scalar(le, rc)
            return lc, rc
        if rlit and not llit:
            lc = self.eval(le)
            rc, lc = typed_scalar(re_, lc)
            return lc, rc
        if llit and rlit:
            return make_scalar(le.value), make_scalar(re_.value)
        lc, rc = self.eval(le), self.eval(re_)
        if lc.dtype != rc.dtype:
            if lc.dtype.is_integer and rc.dtype.is_floating:
                lc = cast_kernel(lc, rc.dtype)
            elif lc.dtype.is_floating and rc.dtype.is_integer:
                rc = cast_kernel(rc, lc.dtype)
            elif lc.dtype.is_integer and rc.dtype.is_integer:
                lc = cast_kernel(lc, dt.int64)
                rc = cast_kernel(rc, dt.int64)
        return lc, rc

    def _func(self, e: Func):
        from .ops.cast import cast as cast_kernel
        from .ops import cmp as c_ops
        from .ops import numeric as n_ops
        from .ops import strings as s_ops
        if e.name == "cast":
            return cast_kernel(self.eval(e.args[0]),
                               _sql_type(e.cast_to))
        if e.name == "abs":
            from .ops import select_misc as sm
            c = self.eval(e.args[0])
            return sm.zip_(c_ops.lt(c, make_scalar(0, c.dtype)),
                           n_ops.neg(c), c)
        if e.name in ("upper", "lower"):
            return getattr(s_ops, e.name)(self.eval(e.args[0]))
        if e.name == "length":
            return s_ops.length(self.eval(e.args[0]))
        if e.name == "coalesce":
            from .core.column import NullColumn
            from .ops import select_misc as sm
            from .ops import boolean as b_ops
            out = None
            for a in e.args:
                c = self.eval(a)
                if isinstance(c, NullColumn):
                    continue         # contributes nothing
                if out is None:
                    out = c
                else:
                    mask = b_ops.is_null(out)
                    out = sm.zip_(mask, c, out)
            return out if out is not None \
                else _literal_column(None, self.t.num_rows, self.dev)
        raise ArrowInvalid(f"unknown function {e.name}")


def _select_items(p: _Parser):
    if p.accept("op", "*"):
        return None                  # SELECT *
    items = []
    while True:
        e = p.expr()
        alias = None
        if p.accept("kw", "as"):
            alias = p.expect("id")[1]
        elif p.peek()[0] == "id" and p.peek(1)[1] in (",", "from"):
            alias = p.next()[1]      # bare alias: SELECT expr alias
        items.append((e, alias))
        if not p.accept("op", ","):
            return items


def _default_name(e, i: int) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Agg):
        if e.fn == "count_all":
            return "count"
        base = _default_name(e.arg, i) if isinstance(e.arg, Col) \
            else f"expr{i}"
        fn = {"mean": "avg"}.get(e.fn, e.fn)
        return f"{base}_{fn}" if isinstance(e.arg, Col) else fn
    return f"expr{i}"


def execute_sql(tables: Dict[str, Table], query: str) -> Table:
    """Parse and execute one SELECT statement against `tables`, on the
    device of the tables it reads."""
    with span("sql.execute"):
        return _select(tables, query)


def _candidates(e: Col, aliases: Dict[str, str],
                suffixes: Dict[str, str]) -> List[str]:
    """The physical names a (maybe qualified) reference may resolve to,
    in the order the resolvers try them: a joined right table's
    colliding columns carry a suffix, which a qualified reference
    prefers."""
    if e.table is None:
        return [e.name]
    tname = aliases.get(e.table, e.table)
    cands = [f"{tname}.{e.name}", e.name]
    sfx = suffixes.get(tname)
    if sfx:
        cands.insert(0, f"{e.name}{sfx}")
    return cands


def _col_refs(e):
    """Every column reference inside an expression tree (or a list of
    them)."""
    if isinstance(e, Col):
        yield e
    elif isinstance(e, (list, tuple)):
        for x in e:
            yield from _col_refs(x)
    elif dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            yield from _col_refs(getattr(e, f.name))


_SUFFIX = "_right"               # ops.join's name for a colliding right column


@dataclass
class _JoinStep:
    how: str
    rname: str
    aliases: Dict[str, str]      # the aliases its ON clause sees
    left: Col
    right: Col


def _named_columns(joins: List[_JoinStep], exprs,
                   aliases: Dict[str, str]) -> set:
    """Every physical name the statement's references may resolve to,
    under the resolvers' candidate rules with the suffix of every joined
    table, and the name each suffixed one comes from."""
    every = {j.rname: _SUFFIX for j in joins}
    names = set()
    for j in joins:
        for c in (j.left, j.right):
            names.update(_candidates(c, j.aliases, every))
    for c in _col_refs(exprs):
        names.update(_candidates(c, aliases, every))
    for n in list(names):
        while n.endswith(_SUFFIX):
            n = n[:-len(_SUFFIX)]
            names.add(n)
    return names


def _prune(t: Table, names) -> Table:
    """`t` with only its columns named in `names`, in their order: the
    same column objects, no copy.  A table none of whose columns is named
    keeps one, fixed-width where it has one, so its row count holds."""
    keep = [i for i, n in enumerate(t.column_names) if n in names]
    if not keep and t.columns:
        keep = [next((i for i, c in enumerate(t.columns)
                      if isinstance(c, PrimitiveColumn)), 0)]
    return t if len(keep) == t.num_columns else t.select(keep)


def _join_keys(left: List[str], right: List[str], j: _JoinStep,
               suffixes: Dict[str, str]) -> Tuple[str, str]:
    """The (left, right) key names of one join over tables with these
    column names: explicit table qualifiers (resolved through aliases)
    decide the sides, else unqualified-name membership; a qualified left
    key may carry an earlier join's suffix."""
    def side(c):
        if c.table is None:
            return None
        return "r" if j.aliases.get(c.table, c.table) == j.rname else "l"

    a, b = j.left, j.right
    sa, sb = side(a), side(b)
    if sa == "r" or sb == "l":
        a, b = b, a                  # a = left column, b = right column
    elif sa is None and sb is None and not (a.name in left
                                            and b.name in right):
        a, b = b, a
    l_on = a.name
    if a.table is not None:
        sfx = suffixes.get(j.aliases.get(a.table, a.table))
        if sfx and f"{a.name}{sfx}" in left:
            l_on = f"{a.name}{sfx}"
    return l_on, b.name


def _joined_columns(src: Dict[str, Table], tname: str,
                    joins: List[_JoinStep]) -> List[Tuple[str, str, str]]:
    """The joined table's columns from the tables' names alone, in
    ops.join's order and naming: (name, table, the column's name
    there)."""
    cols = [(n, tname, n) for n in src[tname].column_names]
    suffixes: Dict[str, str] = {}
    for j in joins:
        left = [n for n, _, _ in cols]
        right = src[j.rname].column_names
        _, r_on = _join_keys(left, right, j, suffixes)
        taken = set(left)
        cols += [(n if n not in taken else n + _SUFFIX, j.rname, n)
                 for n in right if n != r_on]
        suffixes[j.rname] = _SUFFIX
    return cols


def _conjuncts(e) -> list:
    """The top-level AND operands of a WHERE, in order."""
    if isinstance(e, Bin) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _and_all(es):
    """The conjuncts joined again by AND, left-deep as the parser builds
    them (None for none)."""
    out = None
    for e in es:
        out = e if out is None else Bin("and", out, e)
    return out


def _row_safe(e) -> bool:
    """True when `e` is built only from comparisons, BETWEEN, IN, LIKE,
    IS [NOT] NULL, NOT, AND and OR over columns and literals: whether
    one of these raises depends on the types alone, never on a row's
    value (checked arithmetic, functions and casts may)."""
    if isinstance(e, (Col, Lit)):
        return True
    if isinstance(e, Bin):
        return (e.op in _CMP or e.op in ("and", "or")) and \
            _row_safe(e.left) and _row_safe(e.right)
    if isinstance(e, Un):
        return e.op != "neg" and _row_safe(e.operand)
    if isinstance(e, InList):
        return all(map(_row_safe, [e.expr] + e.items))   # ints are literals
    if isinstance(e, Between):
        return all(map(_row_safe, (e.expr, e.lo, e.hi)))
    if isinstance(e, LikeOp):
        return _row_safe(e.expr)
    return False


def _pushdown(where, src: Dict[str, Table], tname: str,
              joins: List[_JoinStep], aliases: Dict[str, str]):
    """The WHERE's conjuncts that name one table alone, by table, and the
    WHERE left to run after the joins (None when nothing is left).

    A conjunct goes to table T when each of its references resolves, by
    the resolvers' rules over the joined table, to a column of T, and
    over T alone to the same column; an unqualified name counts only
    where one table of the statement holds it.  T is read once and is
    not the right side of a LEFT JOIN.  A filter drops rows from a
    join's input without reordering the rest (ops/join.py: probe order,
    each probe row's matches in build-row order), so the joins give the
    rows of the whole WHERE in the same order.  A WHERE with a part that
    may raise on a row's value stays whole: the rows the pushed filters
    drop would no longer raise."""
    conj = _conjuncts(where)
    if not all(map(_row_safe, conj)):
        return {}, where
    read = [tname] + [j.rname for j in joins]
    right_of_left = {j.rname for j in joins if j.how == "left"}
    joined = _joined_columns(src, tname, joins)
    names = [n for n, _, _ in joined]
    every = {j.rname: _SUFFIX for j in joins}

    def home(c: Col) -> Optional[str]:
        if c.table is None and sum(c.name in src[n].column_names
                                   for n in set(read)) != 1:
            return None
        phys = next((x for x in _candidates(c, aliases, every)
                     if x in names), None)
        if phys is None:
            return None
        _, t, orig = joined[names.index(phys)]
        alone = next((x for x in _candidates(c, aliases, {})
                      if x in src[t].column_names), None)
        return t if alone == orig else None

    pushed: Dict[str, list] = {}
    kept = []
    for e in conj:
        homes = {home(c) for c in _col_refs(e)}
        t = homes.pop() if len(homes) == 1 else None
        if t is None or read.count(t) != 1 or t in right_of_left:
            kept.append(e)
        else:
            pushed.setdefault(t, []).append(e)
    return pushed, (_and_all(kept) if pushed else where)


def _select(tables: Dict[str, Table], query: str) -> Table:
    p = _Parser(_tokenize(query))
    p.expect("kw", "select")
    distinct = p.accept("kw", "distinct") is not None
    items = _select_items(p)
    p.expect("kw", "from")
    tname = p.expect("id")[1]
    if tname not in tables:
        raise ArrowInvalid(f"no such table {tname!r}")
    read = [tname]
    aliases: Dict[str, str] = {}
    if p.peek()[0] == "id":          # FROM t alias
        aliases[p.next()[1]] = tname

    # JOIN: parsed here, run once the statement's names are known
    joins: List[_JoinStep] = []
    while True:
        how = "inner"
        if p.accept("kw", "left"):
            p.expect("kw", "join")
            how = "left"
        elif p.accept("kw", "inner"):
            p.expect("kw", "join")
        elif p.accept("kw", "join"):
            pass
        else:
            break
        rname = p.expect("id")[1]
        if rname not in tables:
            raise ArrowInvalid(f"no such table {rname!r}")
        read.append(rname)
        _device_of([tables[n] for n in read])
        if p.peek()[0] == "id" and p.peek()[1] != "on":
            aliases[p.next()[1]] = rname
        p.expect("kw", "on")
        cond = p.expr()
        if not (isinstance(cond, Bin) and cond.op == "="
                and isinstance(cond.left, Col)
                and isinstance(cond.right, Col)):
            raise ArrowInvalid("JOIN ON must be t1.a = t2.b")
        joins.append(_JoinStep(how, rname, dict(aliases), cond.left,
                               cond.right))

    where = p.expr() if p.accept("kw", "where") else None

    def colref():
        """id [. id] -> a column reference, resolved after the joins."""
        name = p.expect("id")[1]
        if p.accept("op", "."):
            return Col(name, p.expect("id")[1])
        return Col(None, name)

    group = None
    if p.accept("kw", "group"):
        p.expect("kw", "by")
        group = [colref()]
        while p.accept("op", ","):
            group.append(colref())
    having = p.expr() if p.accept("kw", "having") else None
    order = []
    if p.accept("kw", "order"):
        p.expect("kw", "by")
        while True:
            oe = p.expr()
            desc = False
            if p.accept("kw", "desc"):
                desc = True
            else:
                p.accept("kw", "asc")
            order.append((oe, desc))
            if not p.accept("op", ","):
                break
    limit = offset = None
    if p.accept("kw", "limit"):
        limit = int(p.expect("num")[1])
        if p.accept("kw", "offset"):
            offset = int(p.expect("num")[1])
    p.expect("end")
    dev = _device_of([tables[n] for n in read]) or torch.device("cpu")

    # read only the columns the statement names (SELECT * reads every
    # one).  A name is kept on every table at once, so a collision is
    # kept on both sides or on neither and each join names its columns
    # as it would over the whole tables.  A table version's rows are
    # every row written; its live mask drops the deleted ones below.
    src = {n: _rows_of(tables[n]) for n in read}
    live = {n: m for n in dict.fromkeys(read)
            if (m := _live_of(tables[n])) is not None}
    columns_in = sum(src[n].num_columns for n in read)
    if items is not None:
        names = _named_columns(joins, [items, where, group, having, order],
                               aliases)
        src = {n: _prune(s, names) for n, s in src.items()}
    columns_read = sum(src[n].num_columns for n in read)

    # the WHERE's one-table conjuncts filter their table before the
    # joins; the columns only they named are then cut by the same rule.
    # A live mask is one more conjunct of its table's filter (a table
    # without one costs nothing); over one table, a WHERE that cannot
    # raise on a row's value joins it, so one filter does both
    pushed = {}
    if joins and where is not None:
        pushed, where = _pushdown(where, src, tname, joins, aliases)
    n_pushed = sum(map(len, pushed.values()))
    if not joins and tname in live and where is not None \
            and _row_safe(where):
        pushed, where = {tname: _conjuncts(where)}, None
    annotate("sql.execute", columns_in=columns_in,
             columns_read=columns_read, conjuncts_pushed=n_pushed,
             rows_masked=sum(tables[n].deleted for n in live))
    count("sql.columns_pruned", columns_in - columns_read)
    count("sql.conjuncts_pushed", n_pushed)
    if pushed or live:
        from .ops.boolean import and_kleene
        from .ops.filter import filter_table
        masks = {}
        for n in dict.fromkeys([*live, *pushed]):
            m = None if n not in pushed else _Evaluator(
                src[n], aliases, None, dev).eval(_and_all(pushed[n]))
            if n in live:
                keep = PrimitiveColumn(live[n], dt.bool_, _canonical=True)
                m = keep if m is None else and_kleene(keep, m)
            masks[n] = m
        if pushed and items is not None:
            names = _named_columns(joins, [items, where, group, having,
                                           order], aliases)
            src = {n: _prune(s, names) for n, s in src.items()}
        for n, m in masks.items():
            src[n] = filter_table(src[n], m)

    t = src[tname]
    suffixes: Dict[str, str] = {}
    for j in joins:
        rt = src[j.rname]
        l_on, r_on = _join_keys(t.column_names, rt.column_names, j,
                                suffixes)
        from .ops.join import join as join_op
        t = join_op(t, rt, [l_on], how=j.how, right_on=[r_on],
                    suffix=_SUFFIX)
        suffixes[j.rname] = _SUFFIX
    if group is not None:
        # the candidates in order; a name none matches goes on as written
        group = [next((c for c in _candidates(g, aliases, suffixes)
                       if c in t.column_names), g.name) for g in group]

    if where is not None:
        from .ops.filter import filter_table
        t = filter_table(t, _Evaluator(t, aliases, suffixes, dev)
                         .eval(where))

    has_agg = items is not None and any(_is_agg(e) for e, _ in items)
    if group and not has_agg:
        raise ArrowInvalid("GROUP BY requires aggregates in SELECT")

    pre_t = None                 # row-aligned source for ORDER BY names
    hidden: List[str] = []
    if has_agg:
        t, having, hidden = _aggregate(t, aliases, suffixes, items,
                                       group or [], having, dev)
    elif items is not None:
        ev = _Evaluator(t, aliases, suffixes, dev)
        cols, fields = [], []
        for i, (e, alias) in enumerate(items):
            c = ev.eval(e)
            name = alias or _default_name(e, i)
            cols.append(c)
            fields.append(dt.Field(name, c.dtype))
        pre_t = t
        t = Table(tuple(cols), dt.Schema(tuple(fields)))

    if having is not None:
        from .ops.filter import filter_table
        t = filter_table(t, _Evaluator(t, {}, None, dev).eval(having))
    if hidden:                   # HAVING-only aggregates: drop them
        keep = [i for i, f in enumerate(t.schema.fields)
                if f.name not in hidden]
        t = Table(tuple(t.columns[i] for i in keep),
                  dt.Schema(tuple(t.schema.fields[i] for i in keep)))

    if distinct:
        from .ops.groupby import group_by
        t = group_by(t, list(t.column_names), [])

    if order:
        # keys resolve against the SELECT output first, then the
        # row-aligned source (SQL lets ORDER BY use dropped columns)
        from .ops.sort import SortColumn, SortOptions, lexsort_to_indices
        from .ops.take import take_table
        sort_cols = []
        for oe, desc in order:
            if not isinstance(oe, Col):
                raise ArrowInvalid("ORDER BY supports columns only")
            if oe.name in t.column_names:
                c = t.column(oe.name)
            elif pre_t is not None and oe.name in pre_t.column_names:
                c = pre_t.column(oe.name)
            else:
                raise ArrowInvalid(f"no such column {oe.name!r}")
            sort_cols.append(SortColumn(c,
                                        SortOptions(descending=desc)))
        idx = lexsort_to_indices(sort_cols)
        t = take_table(t, idx)

    if offset:
        t = t.slice(min(offset, t.num_rows),
                    max(t.num_rows - offset, 0))
    if limit is not None:
        t = t.slice(0, min(limit, t.num_rows))
    return t


def _rewrite_aggs(e, add_agg):
    """Replace every Agg node with a Col reference to its aggregate
    output column (HAVING over aggregate expressions)."""
    if isinstance(e, Agg):
        return Col(None, add_agg(e))
    if isinstance(e, Bin):
        return Bin(e.op, _rewrite_aggs(e.left, add_agg),
                   _rewrite_aggs(e.right, add_agg))
    if isinstance(e, Un):
        return Un(e.op, _rewrite_aggs(e.operand, add_agg))
    if isinstance(e, Func):
        return Func(e.name, [_rewrite_aggs(a, add_agg) for a in e.args],
                    e.cast_to)
    if isinstance(e, InList):
        return dataclasses.replace(e, expr=_rewrite_aggs(e.expr, add_agg))
    return e


def _aggregate(t: Table, aliases, suffixes, items,
               group: List[str], having=None,
               dev: Optional[torch.device] = None):
    """Lower an aggregate SELECT onto ops.group_by (grouped) or the
    whole-array aggregates (global).  -> (table, rewritten_having,
    hidden_names): aggregates referenced only by HAVING are computed
    as hidden columns the caller drops after filtering."""
    from .ops.groupby import AggSpec, group_by
    ev = _Evaluator(t, aliases, suffixes, dev)

    # materialize aggregate ARGUMENT expressions as temp columns
    specs: List[AggSpec] = []
    out_plan = []                    # (kind, payload, name, agg_expr)
    tmp_cols: Dict[str, Column] = {}

    def arg_column(e, i):
        if isinstance(e, Col):
            # resolved name (qualified refs after a join carry join
            # suffixes — the raw name would aggregate the wrong column)
            return ev.col(e), ev.colname(e)
        name = f"__agg_arg{i}"
        tmp_cols[name] = ev.eval(e)
        return tmp_cols[name], name

    def add_spec(e, out_name, i):
        if e.fn == "count_all":
            specs.append(AggSpec(t.column_names[0], "count_all",
                                 name=out_name))
        else:
            _, tmp = arg_column(e.arg, i)
            specs.append(AggSpec(tmp, e.fn, name=out_name))

    for i, (e, alias) in enumerate(items):
        name = alias or _default_name(e, i)
        if isinstance(e, Col) and e.name in group:
            out_plan.append(("group", e.name, name, None))
            continue
        if isinstance(e, Agg):
            add_spec(e, f"__a{i}", i)
            out_plan.append(("agg", f"__a{i}", name, e))
            continue
        raise ArrowInvalid(
            "aggregate SELECT items must be group keys or aggregates")

    hidden: List[str] = []
    if having is not None and _is_agg(having):
        counter = [0]

        def add_agg(e):
            for kind, _, name, pe in out_plan:
                if kind == "agg" and pe == e:
                    return name      # reuse a SELECT aggregate
            hname = f"__h{counter[0]}"
            counter[0] += 1
            add_spec(e, hname, hname)
            out_plan.append(("agg", hname, hname, e))
            hidden.append(hname)
            return hname

        having = _rewrite_aggs(having, add_agg)

    if tmp_cols:
        cols = list(t.columns) + list(tmp_cols.values())
        fields = list(t.schema.fields) + \
            [dt.Field(n, c.dtype) for n, c in tmp_cols.items()]
        t = Table(tuple(cols), dt.Schema(tuple(fields)))

    if group:
        g = group_by(t, group, specs)
        cols, fields = [], []
        for kind, src, name, _ in out_plan:
            c = g.column(src)
            cols.append(c)
            fields.append(dt.Field(name, c.dtype))
        return (Table(tuple(cols), dt.Schema(tuple(fields))),
                having, hidden)

    # global aggregates
    from .ops import aggregate as agg_ops
    cols, fields = [], []
    for kind, src, name, e in out_plan:
        assert kind == "agg"
        if e.fn == "count_all":
            v = t.num_rows
        else:
            c = t.column(specs[[s.out_name for s in specs]
                               .index(src)].column)
            if e.fn == "count":
                v = int(agg_ops.count(c))
            elif isinstance(c, NullColumn):
                v = None             # SUM/AVG/MIN/MAX of the null type
            elif e.fn == "mean":
                cnt = int(agg_ops.count(c))
                # AVG of zero non-null rows is NULL (Scalar.valid is the
                # null flag; .value is always a tensor, never None)
                v = (None if cnt == 0 else
                     float(agg_ops.sum_(c).as_py()) / cnt)
            else:
                r = getattr(agg_ops, {"sum": "sum_", "min": "min_",
                                      "max": "max_"}[e.fn])(c)
                v = None if r is None else r.as_py()
        col = make_col([v], device=ev.dev)
        cols.append(col)
        fields.append(dt.Field(name, col.dtype))
    return Table(tuple(cols), dt.Schema(tuple(fields))), having, hidden


# ---------------------------------------------------------------------------
# DML / DDL (the update-statement surface behind FlightSQL
# CommandStatementUpdate — arrow-flight/src/sql/server.rs:399 delegates
# the SQL itself to the application; this is that application side)
# ---------------------------------------------------------------------------

def _word(p: _Parser, w: str) -> bool:
    """Accept a case-insensitive bare word (DML verbs are not in the
    SELECT keyword set, so they arrive as `id` tokens)."""
    t = p.peek()
    if (t[0] == "id" and t[1].lower() == w) or t == ("kw", w):
        p.next()
        return True
    return False


def _expect_word(p: _Parser, w: str) -> None:
    if not _word(p, w):
        raise ArrowInvalid(
            f"SQL parse error: expected {w.upper()}, got {p.peek()!r}")


def _const_value(e):
    """Evaluate a VALUES-row expression to one python value by running
    the row evaluator over a one-row dummy table (so CAST, arithmetic
    and negation all work)."""
    dummy = Table.from_pydict({"__one": [0]}, device="cpu")
    c = _Evaluator(dummy, {}).eval(e)
    vals = c.to_pylist()
    if len(vals) != 1:
        raise ArrowInvalid("VALUES expressions must be scalar")
    return vals[0]


def _typed_col(vals, dtype, dev: torch.device):
    """Python values -> Column of `dtype` on `dev`, falling back to
    infer+cast for types make_col can't build directly from literals."""
    from .ops.cast import cast as cast_kernel
    try:
        return make_col(vals, dtype, device=dev)
    except Exception:                  # noqa: BLE001
        return cast_kernel(make_col(vals, device=dev), dtype)


def _mask_arrays(mask_col, live: Optional[torch.Tensor] = None):
    """Bool predicate column -> (true & valid (& live) bool tensor on its
    device, count)."""
    m = mask_col.values.to(torch.bool)
    if getattr(mask_col, "validity", None) is not None:
        m = m & mask_col.validity
    if live is not None:
        m = m & live
    return m, int(to_host("sql.matched", m.sum()))


def _visible(t) -> Table:
    """The rows a reader sees of a table or a table version."""
    return t.visible() if isinstance(t, TableVersion) else t


_TARGET = re.compile(
    r"\s*(?:insert\s+into|update|delete\s+from|create\s+table"
    r"(?:\s+if\s+not\s+exists)?|drop\s+table(?:\s+if\s+exists)?)"
    r"\s+([A-Za-z_][A-Za-z_0-9]*)", re.IGNORECASE)


def update_target(query: str) -> Optional[str]:
    """The one table a DML or DDL statement writes, read from its head
    (None where the head names none: the statement then fails to
    parse)."""
    m = _TARGET.match(query)
    return None if m is None else m.group(1)


def _select_tail(query: str) -> str:
    m = re.search(r"(?i)\bselect\b", query)
    if m is None:
        raise ArrowInvalid("expected SELECT")
    return query[m.start():]


def execute_sql_update(tables: Dict[str, Table], query: str, *,
                       device: DeviceLike = None
                       ) -> Tuple[Dict[str, Delta], int]:
    """Execute one DML/DDL statement against `tables` (Tables or
    storage.TableVersions).

    Returns (deltas, record_count): deltas maps the table written to
    what the statement changes (storage.Delta), not to a rewritten
    table: INSERT gives the rows to append, DELETE ... WHERE a mask of
    the rows it deletes (over every row the table holds, deleted ones
    too, which it never matches), UPDATE, DELETE without WHERE and
    CREATE TABLE the table anew, DROP TABLE a drop;
    `TableVersion.apply` makes the next version.  record_count is the
    DoPutUpdateResult count (rows inserted / matched / deleted; 0 for
    DDL).  Rows are made on the device of the table they go to;
    `CREATE TABLE t (...)` makes its empty table on `device`, or without
    one on the device of the tables in `tables`.

    Grammar: INSERT INTO t [(cols)] VALUES (...)[, ...] | SELECT ...;
    UPDATE t SET c = expr [, ...] [WHERE pred];
    DELETE FROM t [WHERE pred];
    CREATE TABLE [IF NOT EXISTS] t (c TYPE [, ...]) | AS SELECT ...;
    DROP TABLE [IF EXISTS] t.
    """
    with span("sql.execute"):
        return _update(tables, query, device)


def _update(tables: Dict[str, Table], query: str, device: DeviceLike
            ) -> Tuple[Dict[str, Delta], int]:
    p = _Parser(_tokenize(query))

    if _word(p, "insert"):
        _expect_word(p, "into")
        tname = p.expect("id")[1]
        if tname not in tables:
            raise ArrowInvalid(f"no such table {tname!r}")
        target = tables[tname]
        names = list(target.column_names)
        if p.accept("op", "("):
            names = [p.expect("id")[1]]
            while p.accept("op", ","):
                names.append(p.expect("id")[1])
            p.expect("op", ")")
            for n in names:
                if n not in target.column_names:
                    raise ArrowInvalid(f"no such column {n!r}")
        if _word(p, "values"):
            rows = []
            while True:
                p.expect("op", "(")
                row = [_const_value(p.expr())]
                while p.accept("op", ","):
                    row.append(_const_value(p.expr()))
                p.expect("op", ")")
                if len(row) != len(names):
                    raise ArrowInvalid(
                        f"VALUES row has {len(row)} values, expected "
                        f"{len(names)}")
                rows.append(row)
                if not p.accept("op", ","):
                    break
            p.expect("end")
            by_name = {n: [r[i] for r in rows]
                       for i, n in enumerate(names)}
            dev = _device_of([target]) or torch.device("cpu")
            cols = tuple(
                _typed_col(by_name.get(f.name, [None] * len(rows)),
                           f.dtype, dev)
                for f in target.schema.fields)
            add = Table(cols, target.schema)
        else:
            sel = execute_sql(tables, _select_tail(query))
            dev = _device_of([target, sel]) or torch.device("cpu")
            if sel.num_columns != len(names):
                raise ArrowInvalid(
                    f"SELECT produces {sel.num_columns} columns, "
                    f"expected {len(names)}")
            from .ops.cast import cast as cast_kernel
            by_name = dict(zip(names, sel.columns))
            cols = []
            for f in target.schema.fields:
                if f.name in by_name:
                    c = by_name[f.name]
                    cols.append(c if c.dtype == f.dtype
                                else cast_kernel(c, f.dtype))
                else:
                    cols.append(_typed_col([None] * sel.num_rows,
                                           f.dtype, dev))
            add = Table(tuple(cols), target.schema)
        return {tname: Delta(append=add)}, add.num_rows

    if _word(p, "update"):
        tname = p.expect("id")[1]
        if tname not in tables:
            raise ArrowInvalid(f"no such table {tname!r}")
        t = _visible(tables[tname])
        _expect_word(p, "set")
        sets = []
        while True:
            cname = p.expect("id")[1]
            if cname not in t.column_names:
                raise ArrowInvalid(f"no such column {cname!r}")
            p.expect("op", "=")
            sets.append((cname, p.expr()))
            if not p.accept("op", ","):
                break
        where = p.expr() if p.accept("kw", "where") else None
        p.expect("end")
        ev = _Evaluator(t, {})
        from .ops.cast import cast as cast_kernel
        from .ops.select_misc import zip_ as zip_kernel
        if where is not None:
            mcol = ev.eval(where)
            m, count = _mask_arrays(mcol)
            mask = PrimitiveColumn(m, dt.bool_, _canonical=True)
        else:
            mask, count = None, t.num_rows
        updates = {}
        for cname, e in sets:
            newc = ev.eval(e)
            old = t.column(cname)
            if newc.dtype != old.dtype:
                newc = cast_kernel(newc, old.dtype)
            updates[cname] = newc if mask is None \
                else zip_kernel(mask, newc, old)
        cols = tuple(updates.get(f.name, c)
                     for f, c in zip(t.schema.fields, t.columns))
        return {tname: Delta(table=Table(cols, t.schema))}, count

    if _word(p, "delete"):
        p.expect("kw", "from")
        tname = p.expect("id")[1]
        if tname not in tables:
            raise ArrowInvalid(f"no such table {tname!r}")
        v = tables[tname]
        where = p.expr() if p.accept("kw", "where") else None
        p.expect("end")
        if where is None:
            t = _visible(v)
            return {tname: Delta(table=t.slice(0, 0))}, t.num_rows
        t, live = _rows_of(v), _live_of(v)
        if live is None or _row_safe(where):
            m, count = _mask_arrays(_Evaluator(t, {}).eval(where), live)
        else:
            # a WHERE that may raise on a row's value reads only the rows
            # a reader sees; its matches go back to their rows
            seen, count = _mask_arrays(_Evaluator(v.visible(), {})
                                       .eval(where))
            m = torch.zeros_like(live)
            if len(seen):
                at = (torch.cumsum(live, 0) - 1).clamp_(min=0)
                m = live & seen[at]
        return {tname: Delta(delete=m, deleted=count)}, count

    if _word(p, "create"):
        _expect_word(p, "table")
        if_not_exists = False
        if _word(p, "if"):
            p.expect("kw", "not")
            _expect_word(p, "exists")
            if_not_exists = True
        tname = p.expect("id")[1]
        if tname in tables:
            if if_not_exists:
                return {}, 0
            raise ArrowInvalid(f"table {tname!r} already exists")
        if p.accept("kw", "as"):
            sel = execute_sql(tables, _select_tail(query))
            return {tname: Delta(table=sel, derived=True)}, sel.num_rows
        p.expect("op", "(")
        fields = []
        while True:
            cname = p.expect("id")[1]
            tok = p.next()
            if tok[0] not in ("id", "kw"):
                raise ArrowInvalid(
                    f"SQL parse error: expected type, got {tok!r}")
            fields.append(dt.Field(cname, _sql_type(tok[1])))
            if not p.accept("op", ","):
                break
        p.expect("op", ")")
        p.expect("end")
        from .io.integration_json import _empty_col
        dev = resolve_device(device) if device is not None \
            else _device_of(tables.values())
        if dev is None:
            raise ArrowInvalid("CREATE TABLE needs a device: pass device= "
                               "or a catalog of tables on one")
        cols = tuple(NullColumn(0, dev) if f.dtype.is_null
                     else _empty_col(f.dtype, dev) for f in fields)
        return {tname: Delta(table=Table(cols, dt.Schema(tuple(fields))))}, 0

    if _word(p, "drop"):
        _expect_word(p, "table")
        if_exists = False
        if _word(p, "if"):
            _expect_word(p, "exists")
            if_exists = True
        tname = p.expect("id")[1]
        p.expect("end")
        if tname not in tables:
            if if_exists:
                return {}, 0
            raise ArrowInvalid(f"no such table {tname!r}")
        return {tname: Delta(drop=True)}, 0

    raise ArrowInvalid(
        "expected INSERT / UPDATE / DELETE / CREATE / DROP")


def _param_literal(v) -> str:
    """A bound parameter as SQL text that the tokenizer reads back as the
    same value (arrow-rs binds typed values; the reference's repr()
    made tokens the grammar rejects, ROADMAP C7.4): integers in digits,
    finite floats and decimals in positional digits, non-finite floats
    and dates as a CAST of their text; other types raise."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            return f"CAST('{v!r}' AS double)"
        text = format(decimal.Decimal(repr(v)), "f")
        return text if "." in text else text + ".0"
    if isinstance(v, decimal.Decimal) and v.is_finite():
        text = format(v, "f")
        return text if "." in text else text + ".0"
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return f"CAST('{v.isoformat()}' AS date32)"
    raise ArrowInvalid(f"cannot bind a {type(v).__name__} parameter as a "
                       "SQL literal")


def bind_sql_params(query: str, row) -> str:
    """Substitute positional `?` placeholders with SQL literals (the
    parameter-binding convention FlightSQL prepared statements carry in
    their do_put parameter batch; sql/client.rs bind contract)."""
    out = []
    it = iter(row)
    i = 0
    while i < len(query):
        ch = query[i]
        if ch == "'":                  # skip string literals
            j = i + 1
            while j < len(query):
                if query[j] == "'" and j + 1 < len(query) \
                        and query[j + 1] == "'":
                    j += 2
                    continue
                if query[j] == "'":
                    break
                j += 1
            out.append(query[i:j + 1])
            i = j + 1
            continue
        if ch == "?":
            try:
                v = next(it)
            except StopIteration:
                raise ArrowInvalid(
                    "not enough parameters for placeholders") from None
            out.append(_param_literal(v))
            i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)
