"""The plain reference against the program on the CPU, every query of
both configurations at 10,000 rows; the control at that size comes out
not correct."""

from __future__ import annotations

import pytest
import torch
from qbench_cells import SEED, small_cell
from qbench import check, control, harness

QUERIES = [(cell, q.name) for cell in ("h2o_g1_1e8.groupby",
                                       "h2o_j1_1e7.join")
           for q in harness.find_cell(cell).queries]


@pytest.fixture(scope="module")
def programs():
    """One loaded program a configuration, by cell name."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = harness.Program(small_cell(name), SEED,
                                         torch.device("cpu"))
        return made[name]
    yield get
    for p in made.values():
        p.close()


@pytest.mark.parametrize("cell,query", QUERIES)
def test_reference_matches_program(programs, cell, query):
    c = small_cell(cell)
    prog = programs(cell)
    q = next(q for q in c.queries if q.name == query)
    got = harness.plain_answer(harness.host_copy(prog.run(q, True, False,
                                                          False)),
                               prog.strings, prog.string_format)
    want = harness.reference_fn(c.workload["config"], query)(
        harness.make_tables(c, SEED, "cpu"))
    assert want.nrows > 0
    res = check.compare(got, want)
    assert res["schema"] == 0 and res["cells"] == 0, res
    if want.floats:
        assert res["float"] <= c.workload["float_limit"], res


@pytest.mark.parametrize("cell", ["h2o_g1_1e8.groupby", "h2o_j1_1e7.join",
                                  "h2o_g1_1e8.dense"])
def test_control_is_not_correct(cell):
    checks = control.control_checks(small_cell(cell), SEED, "cpu")
    failed = [k for k, (v, lim) in checks.items() if v > lim]
    assert failed, checks


def test_compare_orders_rows_and_ragged_vectors():
    want = check.Answer({"k": torch.tensor([1, 2, 3]),
                         "v": torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])},
                        ["k"], offsets={"v": torch.tensor([0, 2, 3, 5])})
    got = check.Answer({"k": torch.tensor([3, 1, 2]),
                        "v": torch.tensor([4.0, 5.0, 1.0, 2.0, 3.0])},
                       offsets={"v": torch.tensor([0, 2, 4, 5])})
    assert check.compare(got, want) == {"schema": 0, "cells": 0,
                                        "float": 0.0}
    got.columns["v"][0] = 4.5
    assert check.compare(got, want)["cells"] == 1


def test_compare_counts_nulls_and_float_error():
    want = check.Answer({"k": torch.tensor([1, 2]),
                         "f": torch.tensor([10.0, 20.0],
                                           dtype=torch.float64)},
                        ["k"], ["f"], valid={"f": torch.tensor([True,
                                                                False])})
    got = check.Answer({"k": torch.tensor([2, 1]),
                        "f": torch.tensor([7.0, 10.0 + 2e-9],
                                          dtype=torch.float64)})
    res = check.compare(got, want)
    assert res["cells"] == 1                    # the NULL is missing
    assert res["float"] == pytest.approx(2e-10, rel=1e-3)
    assert check.compare(None, want)["float"] == check.WORST


def test_strings_of_another_dictionary_are_decoded():
    """A string column whose dictionary is not the one the harness made
    is judged by its strings."""
    from aquery2_tpu_torch.storage.table import StringDict
    d = StringDict(["id7", "id5"])
    mine = StringDict(["id5", "id7"])
    strings = {id(mine): (mine, torch.tensor([5, 7], dtype=torch.int32))}
    cols = [("a", torch.tensor([1, 0, 1], dtype=torch.int32), None, None, d),
            ("b", torch.tensor([0, 1, 0], dtype=torch.int32), None, None,
             mine)]
    ans = harness.plain_answer(cols, strings, "id{}")
    assert ans.columns["a"].tolist() == [5, 7, 5]
    assert ans.columns["b"].tolist() == [5, 7, 5]


def test_bulk_dictionary_is_the_constructors():
    """The harness's dictionary built in bulk holds the strings, codes and
    ranks that StringDict's constructor gives."""
    import numpy as np
    from aquery2_tpu_torch.storage.table import StringDict
    keys = np.array([3, 10, 2, 100], dtype=np.int32)
    d = harness.string_dict(StringDict, "id{}", keys)
    e = StringDict(f"id{k}" for k in keys.tolist())
    assert d.strings() == e.strings() == ["id3", "id10", "id2", "id100"]
    assert [d.lookup(s) for s in e.strings()] == [0, 1, 2, 3]
    assert d.lookup("id4") == -1
    assert d.ranks.tolist() == e.ranks.tolist()
    assert len(harness.string_dict(StringDict, "{}",
                                   keys[:0])) == 0


def test_shared_dictionary_serves_both_tables():
    """The id6 columns of J1's x and big hold one dictionary, as the
    generator's SHARED says; every other string column its own."""
    prog = harness.Program(small_cell("h2o_j1_1e7.join"), SEED,
                           torch.device("cpu"))
    t = prog.db.catalog.tables
    assert t["x"].columns["id6"].dictionary is \
        t["big"].columns["id6"].dictionary
    assert t["x"].columns["id5"].dictionary is not \
        t["big"].columns["id5"].dictionary
    prog.close()
