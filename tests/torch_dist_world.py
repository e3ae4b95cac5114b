"""Shared harness of the tests/test_torch_dist_*.py modules.

Each module runs its statements twice: in one 4-rank gloo world of the
port (aquery2_tpu_torch.parallel.launch, ranks on the CPU), and in the
JAX package's ``connect(mesh=4)`` session in the test process (the
reference, on tests/conftest.py's virtual CPU devices). Both record, for
every statement, its rows, column names, and how the mesh session counted
it (``dist_spmd`` / ``dist_fallback`` and the reasons added), or the error
it raised. Every rank of the world must return the same record.

It also holds SQL_FAULTS, statements whose SQL answers the port once
got wrong (IN over a subquery holding NULLs, positional ORDER BY and
GROUP BY), shared by tests/test_torch_general.py (one device) and
tests/test_torch_mesh.py (the 4-rank world).

This module imports no JAX, so that the spawned ranks can import it.
"""

from __future__ import annotations

import hashlib
import math
import pickle

WORLD = 4

SQL_FAULT_TABLES = (
    "CREATE TABLE p(a INT, i INT);"
    "INSERT INTO p VALUES (0, 1), (NULL, 2), (3, 3), (5, 4);"
    "CREATE TABLE q(b INT); INSERT INTO q VALUES (NULL), (3);"
    "CREATE TABLE ps(a VARCHAR(4), i INT);"
    "INSERT INTO ps VALUES ('x', 1), (NULL, 2), ('y', 3), ('z', 4);"
    "CREATE TABLE qs(b VARCHAR(4)); INSERT INTO qs VALUES (NULL), ('y'), "
    "('w');"
    "CREATE TABLE fl(v INT, g INT);"
    "INSERT INTO fl VALUES (1, 2), (2, 1), (3, 2), (4, 1), (5, 2), (6, 1)")
# statement -> its SQL answer; rows in this order where the statement has
# an ORDER BY, else in any order
SQL_FAULTS = {
    "in_null": ("SELECT i FROM p WHERE a IN (SELECT b FROM q)", [(3,)]),
    "not_in_null": ("SELECT i FROM p WHERE a NOT IN (SELECT b FROM q)", []),
    "not_in_no_null": ("SELECT i FROM p WHERE a NOT IN (SELECT b FROM q "
                       "WHERE b IS NOT NULL)", [(1,), (4,)]),
    "in_value": ("SELECT i, a IN (SELECT b FROM q) AS x FROM p ORDER BY i",
                 [(1, None), (2, None), (3, True), (4, None)]),
    "in_value_no_null": ("SELECT i, a IN (SELECT b FROM q WHERE b IS NOT "
                         "NULL) AS x FROM p ORDER BY i",
                         [(1, False), (2, None), (3, True), (4, False)]),
    "not_in_or": ("SELECT i FROM p WHERE NOT (a IN (SELECT b FROM q)) OR "
                  "i = 4", [(4,)]),
    "in_string": ("SELECT i FROM ps WHERE a IN (SELECT b FROM qs)", [(3,)]),
    "not_in_string": ("SELECT i FROM ps WHERE a NOT IN (SELECT b FROM qs)",
                      []),
    "not_in_string_no_null": ("SELECT i FROM ps WHERE a NOT IN (SELECT b "
                              "FROM qs WHERE b IS NOT NULL)", [(1,), (4,)]),
    "order_1_desc": ("SELECT v FROM fl ORDER BY 1 DESC",
                     [(6,), (5,), (4,), (3,), (2,), (1,)]),
    "order_1_grouped": ("SELECT g, sum(v) FROM fl GROUP BY g ORDER BY 1 "
                        "DESC", [(2, 9), (1, 12)]),
    "order_2_aggregate": ("SELECT g, sum(v) AS s FROM fl GROUP BY g "
                          "ORDER BY 2 DESC", [(1, 12), (2, 9)]),
    "order_two_items": ("SELECT g, v FROM fl ORDER BY 1, 2 DESC",
                        [(1, 6), (1, 4), (1, 2), (2, 5), (2, 3), (2, 1)]),
    "order_expression": ("SELECT v * 10 - g AS w FROM fl ORDER BY 1",
                         [(8,), (19,), (28,), (39,), (48,), (59,)]),
    "order_constant": ("SELECT v FROM fl WHERE g = 1 ORDER BY 1 + 0",
                       [(2,), (4,), (6,)]),
    "order_derived": ("SELECT w FROM (SELECT v * 10 - g AS w, g FROM fl) "
                      "WHERE g = 2 ORDER BY 1 DESC", [(48,), (28,), (8,)]),
    "group_1": ("SELECT g, sum(v) FROM fl GROUP BY 1", [(2, 9), (1, 12)]),
    "group_1_expression": ("SELECT g * 10 AS k, count(*) AS c FROM fl "
                           "GROUP BY 1 ORDER BY 1 DESC", [(20, 3), (10, 3)]),
}
# positional items that raise, and the words of each error
SQL_FAULT_RAISES = {
    "SELECT v FROM fl ORDER BY 2": "out of range",
    "SELECT v FROM fl ORDER BY 0": "out of range",
    "SELECT g, sum(v) FROM fl GROUP BY 3": "out of range",
    "SELECT g, sum(v) FROM fl GROUP BY 2": "aggregate",
    "SELECT * FROM fl ORDER BY 1": "*",
}


def sql_answer_matches(sql: str, got, want) -> bool:
    """Rows equal to the SQL answer, in order where sql orders them."""
    if "ORDER BY" in sql:
        return list(got) == list(want)
    return sorted(got, key=repr) == sorted(want, key=repr)


def _record(db, q: str) -> dict:
    st = db.stats
    sp0, fb0 = st.dist_spmd, st.dist_fallback
    reasons0 = dict(st.dist_fallback_reasons)
    out: dict = {}
    try:
        r = db.execute(q)
        if r is not None:
            out["names"] = list(r.column_names())
            out["rows"] = [tuple(row) for row in r.rows()]
    except Exception as e:                      # noqa: BLE001 — recorded
        out["error"] = f"{type(e).__name__}: {e}"
    out["spmd"] = st.dist_spmd - sp0
    out["fallback"] = st.dist_fallback - fb0
    out["reasons"] = sorted(
        k for k, v in st.dist_fallback_reasons.items()
        if v != reasons0.get(k, 0))
    return out


def run_steps(db, load, queries) -> list[dict]:
    db.log_level = "error"
    load(db)
    return [_record(db, q) for q in queries]


def world_main(rank: int, world: int, load, queries, extra=None):
    """One rank: a mesh session on the CPU, the module's tables, every
    statement; the records, checked equal across the ranks. ``extra``
    (a function of the session) runs after the statements and its value
    is returned beside the records."""
    import torch.distributed as dist

    import aquery2_tpu_torch as aq

    db = aq.connect(device="cpu", mesh=world)
    recs = run_steps(db, load, queries)
    more = extra(db) if extra is not None else None
    digest = hashlib.sha256(pickle.dumps((recs, more))).hexdigest()
    every = [None] * world
    dist.all_gather_object(every, digest)
    if len(set(every)) != 1:
        raise AssertionError(f"ranks disagree: {every}")
    return recs, more


def run_world(load, queries, extra=None, timeout_s: float = 120.0):
    from aquery2_tpu_torch.parallel import launch

    return launch.run(world_main, WORLD, load, queries, extra,
                      timeout_s=timeout_s)


def reference(load, queries) -> list[dict]:
    """The JAX package's mesh=4 session over the same statements."""
    import aquery2_tpu as jaq

    return run_steps(jaq.connect(mesh=WORLD), load, queries)


def assert_rows(got, want, rtol: float = 1e-12, ctx=None) -> None:
    """Rows equal: integers, strings and NULLs exactly, floats within
    rtol (NaN equal to NaN)."""
    assert len(got) == len(want), (ctx, len(got), len(want))
    for a, b in zip(got, want):
        assert len(a) == len(b), (ctx, a, b)
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                if x is None or y is None:
                    assert x is y, (ctx, a, b)
                elif math.isnan(y):
                    assert math.isnan(x), (ctx, a, b)
                else:
                    assert math.isclose(x, y, rel_tol=rtol,
                                        abs_tol=1e-12), (ctx, a, b)
            elif isinstance(x, (list, tuple)):
                assert list(x) == list(y), (ctx, a, b)
            else:
                assert x == y, (ctx, a, b)


def assert_same(got: dict, want: dict, q: str, rtol: float = 1e-12,
                routes: bool = True, names=None) -> None:
    """A port record equal to the reference's: the rows, the names (or
    ``names``, where the reference names a join's output by its rewrite,
    a known reference fault) and, where ``routes``, the mesh
    accounting."""
    assert "error" not in got, (q, got["error"])
    assert "error" not in want, (q, want["error"])
    assert got.get("names") == (names or want.get("names")), q
    assert_rows(got.get("rows", []), want.get("rows", []), rtol, q)
    if routes:
        assert (got["spmd"], got["fallback"], got["reasons"]) == \
            (want["spmd"], want["fallback"], want["reasons"]), (q, got, want)
