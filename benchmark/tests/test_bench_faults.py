"""A run driven on the CPU at a tiny size (the harness's look for a card
skipped) with the timed path broken underneath: `correct` comes out
false for each fault a cell of this benchmark can have.  A query's
answer altered where it is produced, and half of the rows a WHERE keeps
left out.  (No cell carries state from step to step or spans chips, so
the unchanged state and the missing exchange have no cell here.)"""

import json

import pytest
import torch

from benchmark import run


def _result(capsys, cell, seconds=4.0):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                   "--seconds", str(seconds), "--trace", "0"],
                  device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_caught(r):
    """`correct` false because an answer was judged wrong."""
    assert r["correct"] is False
    assert r["checks"]["mismatches"]["value"] > 0 or any(
        c["value"] is not None and c["value"] > c["limit"]
        for k, c in r["checks"].items() if k.endswith("rel_err"))


def _altered(real):
    """execute_sql whose answer has its first number changed by one."""
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table

    def execute_sql(tables, query):
        out = real(tables, query)
        cols = list(out.columns)
        for i, c in enumerate(cols):
            if isinstance(c, PrimitiveColumn) and len(c) and \
                    c.values.dtype in (torch.float64, torch.int64):
                v = c.values.clone()
                v[0] += 1
                cols[i] = c.with_values(v)
                break
        return Table(cols, out.schema)
    return execute_sql


def _half_kept(real):
    """filter_table handing on the first half of the rows it keeps."""
    def filter_table(table, *args, **kwargs):
        out = real(table, *args, **kwargs)
        return out.slice(0, out.num_rows // 2)
    return filter_table


@pytest.mark.parametrize("cell", ["tpch-sf10-embedded.scan",
                                  "tpch-sf10-embedded.join"])
def test_sound_run_is_correct(small_tables, capsys, cell):
    r = _result(capsys, cell)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", ["tpch-sf10-embedded.scan",
                                  "tpch-sf10-embedded.join"])
def test_altered_answer_is_not_correct(small_tables, capsys, monkeypatch,
                                       cell):
    import arrow_tpu_torch.sql as sql
    monkeypatch.setattr(sql, "execute_sql", _altered(sql.execute_sql))
    _assert_caught(_result(capsys, cell))


@pytest.mark.parametrize("cell", ["tpch-sf10-embedded.scan",
                                  "tpch-sf10-embedded.join"])
def test_half_the_rows_left_out_is_not_correct(small_tables, capsys,
                                               monkeypatch, cell):
    import arrow_tpu_torch.ops.filter as flt
    monkeypatch.setattr(flt, "filter_table", _half_kept(flt.filter_table))
    _assert_caught(_result(capsys, cell))
