"""What the benchmark takes from the program (arrow_tpu_torch): its tables
made from the generator's tensors, and its answers read back to the host
in the form the comparison takes.  The port's columns share the
generator's storage; nothing is copied."""

from __future__ import annotations

from typing import Dict

import torch


def port_tables(tables: Dict[str, dict], device) -> dict:
    """The port's Tables over the generator's columns (tpch_gen.Col):
    Dictionary<Int32, Utf8> for dict columns, utf8 / large_utf8 text,
    every field nullable, as the readers make them."""
    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.core.column import (DictionaryColumn,
                                             PrimitiveColumn, StringColumn)
    from arrow_tpu_torch.core.table import Table
    prim = {"int64": dt.int64, "int32": dt.int32, "float64": dt.float64,
            "date32": dt.date32}

    def column(c):
        if c.kind in prim:
            return PrimitiveColumn(c.values, prim[c.kind])
        if c.kind == "dict":
            return DictionaryColumn(c.values, StringColumn.from_pylist(
                list(c.words), device=device))
        return StringColumn(c.values, c.data, dt.utf8 if c.kind == "utf8"
                            else dt.large_utf8)

    out = {}
    for name, cols in tables.items():
        made = {k: column(c) for k, c in cols.items()}
        out[name] = Table(list(made.values()), dt.Schema(tuple(
            dt.Field(k, c.dtype) for k, c in made.items())))
    return out


def _values(col) -> list:
    """A column's Python values: dates as day numbers, dictionaries
    decoded, nulls as None."""
    from arrow_tpu_torch.core.column import PrimitiveColumn
    if isinstance(col, PrimitiveColumn):
        out = col.values.cpu().tolist()
        if col.validity is not None:
            ok = col.validity.cpu().tolist()
            out = [v if k else None for v, k in zip(out, ok)]
        return out
    return col.to_pylist()


def run_query(execute, tables: dict, q):
    """The answer of `q` (traffic.Query) by `execute(tables, sql)`: each
    step's answer registered as a table under its name, then the last
    statement."""
    if q.steps:
        tables = dict(tables)
        for into, sql in q.steps:
            tables[into] = execute(tables, sql)
    return execute(tables, q.sql)


def read_answer(table) -> list:
    """A port Table as the comparison takes it: rows of dicts."""
    names = [f.name for f in table.schema.fields]
    cols = [_values(c) for c in table.columns]
    return [dict(zip(names, r)) for r in zip(*cols)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
