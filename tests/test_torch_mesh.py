"""The mesh surface of the port (aquery2_tpu_torch.parallel) in 4-rank gloo
worlds on the CPU: the comm layer's counts and bytes against figures
worked out by hand, the distribution primitives of tests/test_parallel.py
against numpy, DML and fallback statements against the single-device
port, a median, an ordered group-by and an OVER window against the JAX
package's mesh session, IN over a subquery holding NULLs and positional
ORDER BY / GROUP BY against the single-device port and SQL, the raises
of connect(), and a rank that raises ending its world with that error.
"""

import time

import numpy as np
import pytest
import torch

import aquery2_tpu_torch as aq
from aquery2_tpu_torch.ops import hashing
from aquery2_tpu_torch.parallel import launch
from torch_dist_world import (SQL_FAULT_RAISES, SQL_FAULT_TABLES, SQL_FAULTS,
                              sql_answer_matches)

WORLD = 4
N = 4 * 256                     # rows of t: one 256-row block a rank
K_DENSE = 8                     # t.k in 1..8: the dense tier
K_WIDE = 1000                   # u.k in 0..999: the packed tier


def _data():
    rng = np.random.default_rng(12345)
    return {"k": rng.integers(1, K_DENSE + 1, N).astype(np.int32),
            "v": rng.integers(0, 100, N).astype(np.int32),
            "uk": rng.integers(0, K_WIDE, N).astype(np.int32),
            "fk": rng.integers(0, 64, N).astype(np.int32),
            "dk": np.concatenate([rng.integers(0, 64, 299),
                                  [6_000_000]]).astype(np.int32)}


def _load(db):
    from aquery2_tpu_torch.storage.table import Table

    d = _data()
    for name, cols in (("t", {"k": d["k"], "v": d["v"]}),
                       ("u", {"k": d["uk"], "v": d["v"]}),
                       ("fact", {"k": d["fk"]}), ("dim", {"k": d["dk"]})):
        tbl = Table.from_numpy(name, cols, device="cpu")
        db.catalog.create(tbl)
        db.place_table(tbl)


COMM_QUERIES = {
    "dense": "SELECT k, sum(v) FROM t GROUP BY k",
    "sortmerge": "SELECT k, sum(v) FROM u GROUP BY k",
    "shuffle_join": "SELECT count(*) FROM fact f, dim d WHERE f.k = d.k",
}

# the median, an ordered group-by and an OVER window: each group's or
# partition's rows moved to one rank (engine/dist_ordered.py,
# dist_window.py)
SHUFFLED = {
    "median": "SELECT k, median(v) FROM t GROUP BY k",
    "ordered": "SELECT k, sums(v) FROM t ASSUMING ASC v GROUP BY k",
    "window": "SELECT k, v, sum(v) OVER (PARTITION BY k ORDER BY v) "
              "AS rs FROM t",
}

DML = [
    "DELETE FROM t WHERE v > 90",
    "UPDATE t SET v = v + 1 WHERE k = 3",
    "INSERT INTO t SELECT k, v FROM t WHERE k = 1",
    "CREATE TABLE t3 AS SELECT k, sum(v) AS s FROM t GROUP BY k",
    "SELECT k, count(*), sum(v) FROM t GROUP BY k ORDER BY k",
    "SELECT * FROM t3 ORDER BY k",
    "SELECT k, CASE WHEN v > 50 THEN 1 END AS hi FROM t ORDER BY k, v "
    "LIMIT 20",
    "SELECT k, v FROM t WHERE v = (SELECT max(v) FROM t) ORDER BY k",
    "SELECT k, v FROM t WHERE k = (SELECT max(k) FROM t3 WHERE CASE WHEN "
    "s > 0 THEN 1 END = 1) ORDER BY v LIMIT 5",
    "SELECT count(*) FROM t WHERE v > 10",
]


def _mesh_world(rank, world):
    """Every check that needs the world, run once; rank 0 returns what
    every rank saw."""
    import torch.distributed as dist
    import torch_dist_world

    from aquery2_tpu_torch.parallel import (comm, dist_groupby, dist_join,
                                            dist_scan, step)
    from aquery2_tpu_torch.parallel.mesh import ShardedColumn

    db = aq.connect(device="cpu", mesh=world)
    db.log_level = "error"
    _load(db)
    out: dict = {"comm": {}, "shuffled": {}, "dml": [], "placed": {}}
    for tag, q in COMM_QUERIES.items():
        out["comm"][tag] = (db.execute(q).rows(), comm.last_query_comm(db))
    for tag, q in SHUFFLED.items():
        out["shuffled"][tag] = torch_dist_world._record(db, q)
    for q in DML:
        r = db.execute(q)
        out["dml"].append(None if r is None else r.rows())
    db.execute(torch_dist_world.SQL_FAULT_TABLES)
    out["faults"] = {q: torch_dist_world._record(db, q) for q in
                     [sql for sql, _ in torch_dist_world.SQL_FAULTS.values()]
                     + list(torch_dist_world.SQL_FAULT_RAISES)}
    for name in ("t", "t3"):
        out["placed"][name] = all(isinstance(c, ShardedColumn)
                                  for c in db.catalog.get(name)
                                  .columns.values())

    # the primitives of tests/test_parallel.py on this rank's rows
    mesh = db.mesh
    rng = np.random.default_rng(7)
    n = world * 512
    codes = rng.integers(0, 16, n).astype(np.int32)
    vals = rng.integers(0, 100, n).astype(np.int64)
    valid = np.ones(n, bool)
    valid[-100:] = False
    lo, hi = rank * 512, (rank + 1) * 512
    T = torch.from_numpy
    counts, sums = dist_groupby.dist_grouped_sums(
        mesh, T(codes[lo:hi]), [T(vals[lo:hi])], T(valid[lo:hi]), 16)
    x = rng.integers(-5, 50, n).astype(np.int64)
    scans = [f(mesh, T(x[lo:hi])) for f in (dist_scan.dist_sums,
                                            dist_scan.dist_mins,
                                            dist_scan.dist_maxs)]
    lk = rng.integers(0, 50, n).astype(np.int64)
    lk[: n // 2] = 7                                  # a heavy hitter
    rk = rng.integers(0, 50, n).astype(np.int64)
    pairs = dist_join.dist_join_counts(mesh, T(lk[lo:hi]), T(valid[lo:hi]),
                                       T(rk[lo:hi]), T(valid[lo:hi]))
    wide = rng.integers(0, 3000, n).astype(np.int32)
    sc, scnt, ssum = dist_groupby.dist_grouped_sums_shuffle(
        mesh, T(wide[lo:hi]), [T(vals[lo:hi])], T(valid[lo:hi]))
    ex = step.make_example(mesh)
    st = step.distributed_query_step(mesh, *ex, domain=32)
    mine = {"scans": [s.tolist() for s in scans],
            "shuffle": (sc.tolist(), scnt.tolist(), ssum.tolist()),
            "step_run": st[5].tolist()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    out["prims"] = {"counts": counts.tolist(), "sums": sums.tolist(),
                    "pairs": pairs, "ranks": every,
                    "step": [st[0].tolist(), st[1].tolist(), st[2].tolist(),
                             st[4]]}
    return out


@pytest.fixture(scope="module")
def world():
    return launch.run(_mesh_world, WORLD, timeout_s=120)


def _rank_rows(col: np.ndarray, rank: int) -> np.ndarray:
    """Rank r's rows of a placed column of N rows (capacity 1024)."""
    blk = 1024 // WORLD
    return col[rank * blk:(rank + 1) * blk]


def _dest(keys: np.ndarray) -> np.ndarray:
    """The rank a key's row goes to: its hash mod the world."""
    h = hashing.hash64(torch.from_numpy(keys.astype(np.int64)))
    return ((h & ((1 << 62) - 1)) % WORLD).numpy()


def test_comm_dense_query_by_hand(world):
    """Dense tier: one all_reduce of the [lanes, domain + 1] int64 slots
    (the count and the sum: two lanes) and nothing else."""
    rows, c = world["comm"]["dense"]
    nbytes = 2 * (K_DENSE + 1) * 8
    assert c == {"all_reduce": {"count": 1, "tensor_bytes": nbytes},
                 "wire_bytes_per_chip": int(2 * 3 / 4 * nbytes)}
    d = _data()
    assert rows == [(k, int(d["v"][d["k"] == k].sum()))
                    for k in range(1, K_DENSE + 1)]


def test_comm_sortmerge_query_by_hand(world):
    """Packed tier, owner merge, on rank 0: the partial groups' counts
    exchanged (world int64), their rows (key word int32 + count int64 +
    sum int64 = 20 bytes) sent to the rank of their key's hash, then the
    merged groups' row counts gathered (world int64) and their rows
    gathered, padded to the largest rank's."""
    _rows, c = world["comm"]["sortmerge"]
    d = _data()
    kmin = int(d["uk"].min())
    parts = [np.unique(_rank_rows(d["uk"], r)) - kmin for r in range(WORLD)]
    dest = [_dest(p) for p in parts]
    recv0 = sum(int((x == 0).sum()) for x in dest)
    sent_off0 = int((dest[0] != 0).sum())
    merged = [len(np.unique(np.concatenate(
        [p[x == r] for p, x in zip(parts, dest)]))) for r in range(WORLD)]
    row = 4 + 8 + 8
    a2a = WORLD * 8 + recv0 * row
    gat = WORLD * 8 + WORLD * max(merged) * row
    assert c["all_to_all"] == {"count": 2, "tensor_bytes": a2a}
    assert c["all_gather"] == {"count": 2, "tensor_bytes": gat}
    assert set(c) == {"all_to_all", "all_gather", "wire_bytes_per_chip"}
    wire = (WORLD - 1) * 8 + sent_off0 * row + 3 / 4 * gat
    assert c["wire_bytes_per_chip"] == int(wire)


def test_comm_shuffle_join_by_hand(world):
    """The count join over a wide domain exchanges both sides' keys
    (int32) by hash, then one all_reduce adds the ranks' pair counts.
    Before it the star join gathers the build key (dim: 1024 int32 of
    capacity) and declines its duplicate keys."""
    rows, c = world["comm"]["shuffle_join"]
    d = _data()
    recv = 0
    sent = 0
    for side, n in ((d["fk"], N), (d["dk"], 300)):
        for r in range(WORLD):
            col = np.pad(side, (0, 1024 - n))
            blk = col[r * 256:(r + 1) * 256][:max(0, min(256, n - r * 256))]
            dst = _dest(blk)
            recv += int((dst == 0).sum())
            if r == 0:
                sent += int((dst != 0).sum())
    assert c["all_to_all"] == {"count": 4,
                               "tensor_bytes": 2 * WORLD * 8 + recv * 4}
    assert c["all_reduce"] == {"count": 1, "tensor_bytes": 8}
    assert c["all_gather"] == {"count": 1, "tensor_bytes": 1024 * 4}
    wire = 2 * (WORLD - 1) * 8 + sent * 4 + 2 * 3 / 4 * 8 + 3 / 4 * 4096
    assert c["wire_bytes_per_chip"] == int(wire)
    want = sum(int((d["dk"] == k).sum()) for k in d["fk"])
    assert rows == [(want,)]


def _load_sql(db):
    """t of _load through SQL, which both packages take."""
    d = _data()
    db.execute("CREATE TABLE t(k INT, v INT)")
    db.catalog.get("t").append_rows(
        [(int(a), int(b)) for a, b in zip(d["k"], d["v"])])
    db.place_table(db.catalog.get("t"))


@pytest.fixture(scope="module")
def shuffled_reference():
    import torch_dist_world

    return dict(zip(SHUFFLED, torch_dist_world.reference(
        _load_sql, list(SHUFFLED.values()))))


@pytest.mark.parametrize("tag", sorted(SHUFFLED))
def test_median_ordered_window_match_jax_mesh(world, shuffled_reference,
                                              tag):
    """Each runs on the mesh (SPMD) and equals the JAX package's mesh
    session: rows, names and route."""
    import torch_dist_world

    got = world["shuffled"][tag]
    torch_dist_world.assert_same(got, shuffled_reference[tag], SHUFFLED[tag],
                                 rtol=1e-9)
    assert (got["spmd"], got["fallback"]) == (1, 0), got


def test_dml_and_fallbacks_match_single_device(world):
    """DELETE, UPDATE, INSERT … SELECT, CREATE TABLE AS and the gathered
    fallbacks on the mesh equal the single-device port; every table they
    change is placed again."""
    db = aq.connect(device="cpu")
    db.log_level = "error"
    _load(db)
    for q, got in zip(DML, world["dml"]):
        r = db.execute(q)
        want = None if r is None else r.rows()
        assert got == want, q
    assert world["placed"] == {"t": True, "t3": True}


@pytest.mark.parametrize("tag", sorted(SQL_FAULTS))
def test_sql_faults_match_single_device(world, tag):
    """IN over a subquery holding NULLs and positional ORDER BY / GROUP BY
    on the mesh: the single-device port's rows, which are the SQL answer
    (tests/test_torch_general.py holds them to it)."""
    sql, want = SQL_FAULTS[tag]
    got = world["faults"][sql]
    assert "error" not in got, got
    db = aq.connect(device="cpu")
    db.execute(SQL_FAULT_TABLES)
    rows = db.execute(sql).rows()
    assert got["rows"] == rows, (got["rows"], rows)
    assert sql_answer_matches(sql, rows, want), rows


def test_sql_fault_positions_raise_on_the_mesh(world):
    """A position out of range, behind a * or naming an aggregate in
    GROUP BY raises on every rank, with the single device's error."""
    db = aq.connect(device="cpu")
    db.execute(SQL_FAULT_TABLES)
    for sql, words in SQL_FAULT_RAISES.items():
        with pytest.raises(Exception) as e:
            db.execute(sql)
        got = world["faults"][sql]
        assert got.get("error") == f"{type(e.value).__name__}: {e.value}", \
            (sql, got)
        assert words in got["error"], got


def test_primitives_match_numpy(world):
    p = world["prims"]
    rng = np.random.default_rng(7)
    n = WORLD * 512
    codes = rng.integers(0, 16, n)
    vals = rng.integers(0, 100, n)
    valid = np.ones(n, bool)
    valid[-100:] = False
    assert p["counts"] == np.bincount(codes[valid], minlength=16).tolist()
    want = np.zeros(16, np.int64)
    np.add.at(want, codes[valid], vals[valid])
    assert p["sums"] == want.tolist()
    x = rng.integers(-5, 50, n)
    got = [sum((r["scans"][i] for r in p["ranks"]), []) for i in range(3)]
    assert got == [np.cumsum(x).tolist(), np.minimum.accumulate(x).tolist(),
                   np.maximum.accumulate(x).tolist()]
    lk = rng.integers(0, 50, n)
    lk[: n // 2] = 7
    rk = rng.integers(0, 50, n)
    lc = np.bincount(lk[valid], minlength=50)
    rc = np.bincount(rk[valid], minlength=50)
    assert p["pairs"] == int((lc * rc).sum())
    wide = rng.integers(0, 3000, n)
    seen: dict = {}
    for r in p["ranks"]:
        for c, k, s in zip(*r["shuffle"]):
            assert c not in seen, "a group on two ranks"
            seen[c] = (k, s)
    want_s = {int(c): (int((wide[valid] == c).sum()),
                       int(vals[valid][wide[valid] == c].sum()))
              for c in np.unique(wide[valid])}
    assert seen == want_s


def test_step_matches_numpy(world):
    p = world["prims"]
    rng = np.random.default_rng(0)
    n = WORLD * 256
    codes, v1, v3, t, lk, rk = (rng.integers(0, 32, n), rng.integers(0, 5, n),
                                rng.integers(0, 7, n),
                                rng.integers(0, 100, n),
                                rng.integers(0, 64, n),
                                rng.integers(0, 64, n))
    counts, sums, fsums, pairs = p["step"]
    assert counts == np.bincount(codes, minlength=32).tolist()
    assert sums == np.bincount(codes, v1, minlength=32).astype(int).tolist()
    assert fsums == np.bincount(codes, v3, minlength=32).astype(int).tolist()
    lc, rc = np.bincount(lk, minlength=64), np.bincount(rk, minlength=64)
    assert pairs == int((lc * rc).sum())
    assert sum((r["step_run"] for r in p["ranks"]), []) == \
        np.cumsum(t).tolist()


def test_connect_mesh_needs_power_of_two_and_a_group():
    with pytest.raises(ValueError, match="power of two"):
        aq.connect(device="cpu", mesh=3)
    with pytest.raises(RuntimeError, match="process group"):
        aq.connect(device="cpu", mesh=4)
    assert aq.connect(device="cpu", mesh=1).mesh is None


def _raising_world(rank, world):
    import torch.distributed as dist

    if rank == 2:
        raise ValueError("rank two gives up")
    dist.barrier()                  # the others wait for rank 2 in vain
    return rank


def test_a_raising_rank_fails_its_world():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="rank two gives up"):
        launch.run(_raising_world, WORLD, timeout_s=60)
    assert time.monotonic() - t0 < 60


_CHILD = r"""
import os, sys
import numpy as np
import aquery2_tpu_torch as aq
from aquery2_tpu_torch.storage.table import Table

db = aq.connect(device="cpu", mesh=2)        # joins from AQ_* (tcp://)
rng = np.random.default_rng(99)              # the same data on each rank
k, v = rng.integers(1, 9, 1600), rng.integers(1, 100, 1600)
t = db.catalog.create(Table.from_numpy("t", {"k": k, "v": v}, device="cpu"))
db.place_table(t)
got = db.execute("SELECT k, sum(v), count(*) FROM t GROUP BY k").rows()
want = [(int(a), int(v[k == a].sum()), int((k == a).sum()))
        for a in np.unique(k)]
assert got == want, (got, want)
# tests/test_multihost.py's median, subvec (h2o q8's top-2 under ASSUMING
# DESC), OVER (the default RANGE frame's peers) and running sums
got = db.execute("SELECT k, median(v) FROM t GROUP BY k ORDER BY k").rows()
assert got == [(int(a), float(np.median(v[k == a]))) for a in np.unique(k)]
got = db.execute("SELECT k, subvec(v, 0, 2) AS top2 FROM t "
                 "ASSUMING DESC v GROUP BY k").rows()
assert got == [(int(a), np.sort(v[k == a])[::-1][:2].tolist())
               for a in np.unique(k)], got
got = db.execute("SELECT k, v, sum(v) OVER (PARTITION BY k ORDER BY v) "
                 "AS rs FROM t").rows()
assert got == [(int(a), int(b), int(v[(k == a) & (v <= b)].sum()))
               for a, b in zip(k, v)]
ts = rng.permutation(1600)
tr = db.catalog.create(Table.from_numpy("tr", {"k": k, "ts": ts, "v": v},
                                        device="cpu"))
db.place_table(tr)
got = db.execute("SELECT k, sums(v) AS s FROM tr ASSUMING ASC ts "
                 "GROUP BY k").rows()
assert got == [(int(a), np.cumsum(v[k == a][np.argsort(
    ts[k == a], kind="stable")]).tolist()) for a in np.unique(k)], got
assert (db.stats.dist_spmd, db.stats.dist_fallback) == (5, 0), \
    db.stats.dist_fallback_reasons
print("MULTIHOST_OK", os.environ["AQ_PROCESS_ID"], flush=True)
"""


def test_two_processes_join_from_the_environment(tmp_path):
    """tests/test_multihost.py's launch: two processes given only
    AQ_COORDINATOR, AQ_NUM_PROCESSES and AQ_PROCESS_ID run one mesh: its
    grouped sum, median, subvec, OVER and ASSUMING running sums against
    numpy, every statement SPMD."""
    import os
    import socket
    import subprocess
    import sys

    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(2):
        env = dict(os.environ, AQ_COORDINATOR=f"localhost:{port}",
                   AQ_NUM_PROCESSES="2", AQ_PROCESS_ID=str(i),
                   PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"MULTIHOST_OK {i}" in out
