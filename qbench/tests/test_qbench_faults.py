"""A run with the program broken underneath the harness comes out not
correct: the whole run but the look for a card, at a small size on the
CPU, once for each fault a cell of this benchmark can have. (One chip a
cell: no exchange between chips to leave out.)

- altered: every statement's answer has one value changed where it is
  produced (its last column's first row);
- unchanged: every statement after the first returns the first one's
  answer and leaves the tables as they were;
- half: every answer keeps only the first half of its rows.
"""

from __future__ import annotations

import pytest
from qbench_cells import CELLS, run_small

from aquery2_tpu_torch.engine.executor import Executor


def _answer_table(executor, result):
    if result is not None:
        return result.table
    return executor.session.catalog.tables.get("ans")


def altered(real):
    def execute(self, stmt):
        res = real(self, stmt)
        t = _answer_table(self, res)
        if t is not None and t.nrows:
            c = list(t.columns.values())[-1]
            if c.sqltype.is_vector:
                c.values = c.values.clone()
                c.values[0] += 1
            else:
                c.data = c.data.clone()
                c.data[0] += 1
        return res
    return execute


def unchanged(real):
    first = []

    def execute(self, stmt):
        if not first:
            first.append(real(self, stmt))
        return first[0]
    return execute


def half(real):
    def execute(self, stmt):
        res = real(self, stmt)
        t = _answer_table(self, res)
        if t is not None and t.nrows > 1:
            for c in t.columns.values():
                c.nrows = t.nrows // 2
        return res
    return execute


@pytest.mark.parametrize("fault", [altered, unchanged, half])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(Executor, "execute", fault(Executor.execute))
    out = run_small(cell)
    assert out["correct"] is False
    failed = {k for k, v in out["checks"].items()
              if v["value"] > v["limit"]}
    assert failed or out["failed"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    out = run_small(cell)
    assert out["correct"] is True, out["checks"]
