"""Shared harness of the tests/test_torch_dist_*.py modules.

Each module runs its statements twice: in one 4-rank gloo world of the
port (aquery2_tpu_torch.parallel.launch, ranks on the CPU), and in the
JAX package's ``connect(mesh=4)`` session in the test process (the
reference, on tests/conftest.py's virtual CPU devices). Both record, for
every statement, its rows, column names, and how the mesh session counted
it (``dist_spmd`` / ``dist_fallback`` and the reasons added), or the error
it raised. Every rank of the world must return the same record.

This module imports no JAX, so that the spawned ranks can import it.
"""

from __future__ import annotations

import hashlib
import math
import pickle

WORLD = 4


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
