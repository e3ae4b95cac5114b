"""Stored procedures, interval and conditional triggers, the REPL and the
server of the port (runtime/, repl/), each case held to the JAX package
(aquery2_tpu.connect()) on the same statements: the cases of
tests/test_runtime.py but the engine/recover ones (the port has no
fallback) and the bucket helper, the .aqp files both ways, and close()
stopping the trigger threads.

Every port session here collects what its log_error is given (a trigger
action's exception is logged, not raised) and a test fails on any."""

import os
import threading
import time
from pathlib import Path

import pytest
import torch

import aquery2_tpu
from aquery2_tpu.repl.prompt import Repl as JaxRepl
from aquery2_tpu.runtime.procedures import ProcedureStore as JaxStore

import aquery2_tpu_torch
from aquery2_tpu_torch.repl.prompt import Repl
from aquery2_tpu_torch.runtime.procedures import ProcedureStore

REPO = Path(__file__).resolve().parents[1]


def port_session(base_dir):
    db = aquery2_tpu_torch.connect(device="cpu", base_dir=str(base_dir))
    db.errors = []
    log_error = db.log_error
    db.log_error = lambda msg: (db.errors.append(msg), log_error(msg))
    return db


@pytest.fixture
def both(tmp_path):
    """A port session and a JAX session, each under its own directory."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ts = port_session(tmp_path / "t")
    js = aquery2_tpu.connect(base_dir=str(tmp_path / "j"))
    yield ts, js
    ts.close()
    js.close()
    assert ts.errors == []


def count(db, table):
    return db.execute(f"SELECT count(*) FROM {table}").scalar()


def test_procedure_record_replay(both):
    got = []
    for db in both:
        ps = db.procedures
        db.execute("CREATE TABLE t(a INT)")
        ps.start_recording("addrow")
        db.execute("INSERT INTO t VALUES (1)")
        ps.stop_recording()
        got.append([count(db, "t")])
        db.run_procedure("addrow")
        db.run_procedure("addrow")
        got[-1] += [count(db, "t"), db.execute("SELECT a FROM t").rows()]
    assert got[0] == got[1] == [1, 3, [(1,), (1,), (1,)]]


def test_procedure_persistence(both, tmp_path):
    got = []
    for db, mod in zip(both, (aquery2_tpu_torch, aquery2_tpu)):
        ps = db.procedures
        db.execute("CREATE TABLE p(a INT)")
        ps.start_recording("fill")
        db.execute("INSERT INTO p VALUES (7)")
        ps.stop_recording()
        # a new session under the same base_dir reads the .aqp file
        s2 = mod.connect(**({"device": "cpu"} if mod is aquery2_tpu_torch
                            else {}), base_dir=db.base_dir)
        s2.execute("CREATE TABLE p(a INT)")
        s2.run_procedure("fill")
        got.append((count(s2, "p"), s2.procedures.display("fill")))
        s2.close()
    assert got[0] == got[1] == (1, "INSERT INTO p VALUES (7)")
    assert (tmp_path / "t" / "procedures" / "fill.aqp").read_bytes() == \
        (tmp_path / "j" / "procedures" / "fill.aqp").read_bytes()


def test_repo_procedures_load_read_only(tmp_path):
    """The repo's own procedures/democq.aqp (written before the port) loads
    in the port as in the JAX package, and stays as it was."""
    path = REPO / "procedures" / "democq.aqp"
    before = path.read_bytes()
    db = port_session(tmp_path)
    js = aquery2_tpu.connect(base_dir=str(tmp_path))
    mine = ProcedureStore(db, str(REPO / "procedures")).load("democq")
    theirs = JaxStore(js, str(REPO / "procedures")).load("democq")
    assert mine.statements == theirs.statements == \
        ["select count(*) > 100 from source"]
    assert path.read_bytes() == before
    db.close()
    js.close()


def test_jax_package_loads_a_saved_procedure(both):
    """A procedure of several batches (one of two statements, one with a
    non-ASCII literal) saved by the port replays in the JAX package."""
    ts, js = both
    ts.execute("CREATE TABLE q(a INT, s VARCHAR(8))")
    ts.procedures.start_recording("Two")
    ts.execute("INSERT INTO q VALUES (1, 'x'); INSERT INTO q VALUES (2, 'é')")
    ts.execute("INSERT INTO q VALUES (3, 'y')")
    ts.procedures.stop_recording()
    store = JaxStore(js, os.path.join(ts.base_dir, "procedures"))
    assert store.load("two").statements == \
        ts.procedures.load("two").statements
    js.execute("CREATE TABLE q(a INT, s VARCHAR(8))")
    store.run("two")
    ts.run_procedure("two")
    assert ts.execute("SELECT a, s FROM q").rows()[3:] == \
        js.execute("SELECT a, s FROM q").rows() == \
        [(1, "x"), (2, "é"), (3, "y")]


def test_conditional_trigger(both):
    """CREATE TRIGGER c ON t ACTION act WHEN cond runs act after an
    INSERT into t while cond's result is true; DROP TRIGGER stops it."""
    got = []
    for db in both:
        db.execute("CREATE TABLE t(a INT)")
        db.execute("CREATE TABLE audit(cnt INT)")
        ps = db.procedures
        ps.start_recording("cond")
        db.execute("SELECT count(*) > 1 FROM t")
        ps.stop_recording()
        ps.start_recording("act")
        db.execute("INSERT INTO audit VALUES (1)")
        ps.stop_recording()
        db.execute("DELETE FROM audit")
        db.execute("create trigger c on t action act when cond")
        seen = []
        for v in (1, 2):
            db.execute(f"INSERT INTO t VALUES ({v})")
            assert db.triggers.drain()
            seen.append(count(db, "audit"))
        db.execute("drop trigger c")
        db.execute("INSERT INTO t VALUES (3)")
        assert db.triggers.drain()
        seen.append(count(db, "audit"))
        got.append(seen)
    assert got[0] == got[1] == [0, 1, 1]


def test_triggers_fire_after_load_and_insert_select(both, tmp_path):
    """LOAD DATA INFILE and INSERT … SELECT notify the table's triggers,
    as INSERT VALUES does."""
    (tmp_path / "t" / "r.csv").write_text("5\n6\n")
    (tmp_path / "j" / "r.csv").write_text("5\n6\n")
    got = []
    for db in both:
        db.execute("CREATE TABLE t(a INT)")
        db.execute("CREATE TABLE s(a INT)")
        db.execute("INSERT INTO s VALUES (1), (2)")
        db.execute("CREATE TABLE log(n BIGINT)")
        db.procedures.start_recording("snap")
        db.execute("INSERT INTO log SELECT count(*) FROM t")
        db.procedures.stop_recording()
        db.execute("DELETE FROM log")
        db.execute("create trigger w on t action snap")
        db.execute('LOAD DATA INFILE "r.csv" INTO TABLE t')
        assert db.triggers.drain()
        db.execute("INSERT INTO t SELECT a FROM s")
        assert db.triggers.drain()
        got.append(db.execute("SELECT n FROM log").rows())
    assert got[0] == got[1] == [(2,), (4,)]


def test_conditional_trigger_does_not_block_insert(tmp_path):
    """The INSERT returns while the action still waits (on an Event the
    test sets afterwards): the inserting thread never runs it."""
    db = port_session(tmp_path)
    db.execute("CREATE TABLE t2(a INT)")
    db.execute("CREATE TABLE dummy(a INT)")
    ps = db.procedures
    ps.start_recording("slowact")
    db.execute("INSERT INTO dummy VALUES (1)")
    ps.stop_recording()
    db.execute("DELETE FROM dummy")
    release, started = threading.Event(), threading.Event()
    orig = db.run_procedure

    def slow_run(name):
        if name == "slowact":
            started.set()
            assert release.wait(10)
        return orig(name)

    db.run_procedure = slow_run
    db.execute("create trigger s on t2 action slowact")
    db.execute("INSERT INTO t2 VALUES (1)")
    assert started.wait(10)
    assert count(db, "dummy") == 0      # the action is still waiting
    release.set()
    assert db.triggers.drain()
    assert count(db, "dummy") == 1
    db.close()
    assert db.errors == []


def test_interval_trigger(both):
    """An interval trigger fires until it is dropped (polled, at most
    10 s), then stops: at most the firing under way ends after DROP."""
    for db in both:
        db.execute("CREATE TABLE tick(a INT)")
        ps = db.procedures
        ps.start_recording("pulse")
        db.execute("INSERT INTO tick VALUES (1)")
        ps.stop_recording()
        db.execute("DELETE FROM tick")
        db.execute("create trigger heartbeat action pulse interval 100")
        deadline = time.monotonic() + 10
        while count(db, "tick") < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        db.execute("drop trigger heartbeat")
        n = count(db, "tick")
        assert n >= 2
        time.sleep(1.0)                 # a firing under way may end
        after = count(db, "tick")
        assert after - n <= 1
        time.sleep(1.0)
        assert count(db, "tick") == after


def test_close_stops_trigger_threads(tmp_path):
    db = port_session(tmp_path)
    db.execute("CREATE TABLE t(a INT)")
    db.procedures.start_recording("noop")
    db.execute("SELECT count(*) FROM t")
    db.procedures.stop_recording()
    db.execute("create trigger i action noop interval 50")
    db.execute("create trigger c on t action noop")
    db.execute("INSERT INTO t VALUES (1)")
    assert db.triggers.drain()
    threads = db.triggers.threads()
    assert len(threads) == 2 and all(t.is_alive() for t in threads)
    db.close()
    assert not any(t.is_alive() for t in threads)
    assert db.errors == []


def test_trigger_errors_are_logged_and_threads_live_on(tmp_path):
    db = port_session(tmp_path)
    db.execute("CREATE TABLE t(a INT)")
    db.procedures.start_recording("bad")
    db.procedures.stop_recording()
    db.procedures.procedures["bad"].statements.append(
        "SELECT nosuch FROM t")
    db.execute("create trigger c on t action bad")
    db.execute("INSERT INTO t VALUES (1)")
    assert db.triggers.drain()
    db.execute("INSERT INTO t VALUES (2)")
    assert db.triggers.drain()
    assert len(db.errors) == 2 and "trigger c" in db.errors[0]
    db.close()


def test_repl_commands(both, tmp_path, capsys):
    outs = []
    for db in both:
        r = (Repl if db is both[0] else JaxRepl)(db)
        r.handle_line("CREATE TABLE x(a INT)")
        r.handle_line("INSERT INTO x VALUES (5), (6)")
        r.handle_line("exec")
        r.handle_line("SELECT sum(a) FROM x")
        r.handle_line("xexec")
        out = capsys.readouterr().out
        r.handle_line("echo hello-from-repl")
        echo = capsys.readouterr().out
        r.handle_line("stats")
        stats = capsys.readouterr().out
        script = Path(db.base_dir) / "s.a"
        script.write_text("#!aquery\nSELECT count(*) FROM x\nexec\n")
        r.handle_line(f"script {script}")
        out2 = capsys.readouterr().out
        r.handle_line("procedure p record")
        r.handle_line("INSERT INTO x VALUES (7)")
        r.handle_line("exec")
        r.handle_line("procedure p stop")
        r.handle_line("procedure p run")
        r.handle_line("procedure p display")
        out3 = capsys.readouterr().out
        r.handle_line("stats off")
        r.handle_line("SELECT count(*) FROM x")
        r.handle_line("exec")
        capsys.readouterr()
        queries = db.stats.queries
        r.handle_line("stats on")
        outs.append((out, echo, "Queries executed" in stats, out2, out3,
                     queries, db.execute("SELECT sum(a) FROM x").scalar()))
    assert outs[0] == outs[1]
    out, echo, stats, out2, out3, queries, total = outs[0]
    assert "11" in out and "hello-from-repl" in echo and stats
    assert "2" in out2 and "INSERT INTO x VALUES (7)" in out3
    assert queries == 5 and total == 25


def test_engine_switch(tmp_path, capsys, monkeypatch):
    """`engine status|cpu|cuda`: without a card `engine cuda` prints the
    error and moves nothing; `engine cpu` moves every table (here, onto
    the device it is on) and the same GROUP BY answers as before, as in
    the JAX package."""
    db = port_session(tmp_path)
    r = Repl(db)
    for line in ("CREATE TABLE t(a INT, b INT)", "r",
                 "INSERT INTO t VALUES (1,2),(1,3),(2,5)", "r",
                 "CREATE TABLE v(x vecint)", "r",
                 "INSERT INTO v VALUES (1)", "r"):
        r.handle_line(line)
    before = db.execute("SELECT a, sum(b) FROM t GROUP BY a").rows()
    capsys.readouterr()
    r.handle_line("engine status")
    assert "cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = db.catalog.get("t").columns["a"].data
    r.handle_line("engine cuda")
    assert "cannot switch" in capsys.readouterr().out
    assert db.device.type == "cpu" and \
        db.catalog.get("t").columns["a"].data is data
    r.handle_line("engine cpu")
    assert "2 tables moved" in capsys.readouterr().out
    r.handle_line("SELECT a, sum(b) FROM t GROUP BY a")
    r.handle_line("r")
    out = capsys.readouterr().out
    js = aquery2_tpu.connect(base_dir=str(tmp_path))
    js.execute("CREATE TABLE t(a INT, b INT)")
    js.execute("INSERT INTO t VALUES (1,2),(1,3),(2,5)")
    assert before == js.execute(
        "SELECT a, sum(b) FROM t GROUP BY a").rows() == [(1, 5), (2, 5)]
    assert "2 | 5" in out
    assert db.execute("SELECT * FROM v").rows() == [([1],)]
    db.close()
    js.close()


def test_server_mode(tmp_path):
    """Client/server mode: the JAX package's protocol and answers."""
    from aquery2_tpu.repl.server import AqServer as JaxServer
    from aquery2_tpu_torch.repl.server import AqClient, AqServer

    got = []
    (tmp_path / "j").mkdir()
    for srv in (AqServer(port=0, session=port_session(tmp_path)),
                JaxServer(port=0, session=aquery2_tpu.connect(
                    base_dir=str(tmp_path / "j")))):
        srv.start_background()
        try:
            c = AqClient(port=srv.port)
            out = [c.execute("CREATE TABLE t(a INT)")]
            c.execute("INSERT INTO t VALUES (1), (2), (3)")
            out.append(c.execute("SELECT sum(a) FROM t"))
            with pytest.raises(RuntimeError):
                c.execute("SELECT * FROM missing_table")
            c2 = AqClient(port=srv.port)     # a second client, one catalog
            out.append(c2.execute("SELECT count(*) FROM t")["rows"])
            c.close()
            c2.close()
        finally:
            srv.shutdown()
            srv.session.close()
        got.append(out)
    assert got[0] == got[1]
    assert got[0][1]["rows"] == [("6",)] and got[0][2] == [("3",)]


def test_main_runs_scripts_and_commands(tmp_path):
    """`python -m aquery2_tpu_torch --device cpu` runs a #!aquery script
    (procedures, stats, engine) and `-c` runs SQL."""
    import subprocess
    import sys

    (tmp_path / "s.a").write_text(
        "#!aquery\nCREATE TABLE t(a INT, b INT)\n"
        "INSERT INTO t VALUES (1,2),(1,3),(2,5)\nexec\n"
        "procedure p record\nINSERT INTO t VALUES (3,1)\nexec\n"
        "procedure p stop\nprocedure p run\nstats\nengine status\n"
        "engine cpu\nSELECT a, sum(b) FROM t GROUP BY a\nexec\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "aquery2_tpu_torch", "--device", "cpu",
         str(tmp_path / "s.a")], capture_output=True, text=True,
        timeout=240, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Queries executed" in out.stdout
    assert "engine: torch device = cpu" in out.stdout
    assert "3 | 2" in out.stdout and "2 | 5" in out.stdout
    assert (tmp_path / "procedures" / "p.aqp").exists()
    out = subprocess.run(
        [sys.executable, "-m", "aquery2_tpu_torch", "--device", "cpu", "-c",
         "SELECT 1 + 2"], capture_output=True, text=True, timeout=240,
        cwd=str(tmp_path), env=env)
    assert out.returncode == 0 and "3" in out.stdout, out.stderr[-2000:]
