"""A cell of more than one chip runs as ranks of one mesh session
(qbench/ranks.py): h2o_g1_1e8.groupby's q1-q10 as a cell of 4 chips,
made in memory, through the function that run.py calls.

On the CPU: 4 ranks over gloo give one correct result with the fullest
rank's peak, and write nothing to standard output; with the exchange
between ranks left out the check fails; a rank whose query raises, a rank
that dies, and a rank that hangs each end the world within its own
limit, never in a hang; a new cell of 4 chips needs data files alone.
On the card (marked gpu): the same cell at
G1_1e7 over NCCL on 4 cards, and as 4 ranks sharing cuda:0 over gloo:

    python -m pytest qbench/tests/test_qbench_ranks.py -m gpu -q
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
import torch.multiprocessing as mp
from qbench_cells import SEED, mesh_cell
from qbench import harness, ranks

RANKS = 4
MIB = 2**20
COPY_S = 1.5
CPU = [torch.device("cpu")] * RANKS


def _peaks(rank: int, size: int) -> None:
    """Each rank reads its memory peak as rank + 1 MiB."""
    harness.memory_peak = lambda device: (rank + 1) * MIB


def _query_raises(sql: str, bad_rank: int, rank: int, size: int) -> None:
    """On bad_rank, Session.execute raises on sql's first run in the
    window (its runs before that are the warm-up's)."""
    if rank != bad_rank:
        return
    from aquery2_tpu_torch.session import Session

    real, runs = Session.execute, [0]

    def execute(self, text):
        if text == sql:
            runs[0] += 1
            if runs[0] > harness.WARMUP_CYCLES:
                raise RuntimeError("planted fault")
        return real(self, text)
    Session.execute = execute


def _slow_copies(rank: int, size: int) -> None:
    """Rank 0 takes COPY_S longer over each sampled answer's copy."""
    if rank == 0:
        real = harness.host_copy

        def host_copy(table):
            time.sleep(COPY_S)
            return real(table)
        harness.host_copy = host_copy


def _no_exchange(rank: int, size: int) -> None:
    """The exchange between ranks left out: each rank's sums, counts,
    minima and maxima stay its own, and of the rows it shuffles it keeps
    those it would send itself."""
    from aquery2_tpu_torch.parallel import comm

    comm.all_reduce = lambda mesh, t, op="sum": t.clone()
    comm.all_to_all_v = lambda mesh, dest, lanes: [
        x[dest == mesh.rank] for x in lanes]


def _dies(rank: int, size: int) -> None:
    if rank == 1:
        os._exit(9)


def _hangs(rank: int, size: int) -> None:
    if rank == 1:
        time.sleep(3600)


def _run(cell, rank_setup=None, deadline_s=240.0, devices=CPU,
         backend="gloo", seconds=0.2, traced=False):
    return ranks.run(cell, SEED, seconds, traced, devices, backend,
                     time.perf_counter(), log=lambda msg: None,
                     rank_setup=rank_setup, deadline_s=deadline_s)


def test_four_gloo_ranks_give_one_correct_result(capfd):
    cell = mesh_cell()
    out, bad = _run(cell, rank_setup=_peaks)
    assert capfd.readouterr().out == ""          # the ranks print nothing
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and bad == []
    cycles, rest = divmod(out["attempted"], len(cell.queries))
    assert rest == 0 and cycles >= harness.MIN_CYCLES
    assert out["device"]["count"] == RANKS
    assert out["device"]["memory_peak_bytes"] == RANKS * MIB
    assert out["metrics"]["peak_mem_gib"]["value"] == RANKS * MIB / 2**30
    assert sorted(out["metrics"]) == sorted(m["name"]
                                            for m in cell.end_to_end)
    assert list(out)[-1] == "checks"
    assert not mp.active_children()


def test_hand_over_gives_each_column_once():
    from aquery2_tpu_torch import types as T
    from aquery2_tpu_torch.storage.table import Table

    types = {"a": T.IntT, "b": T.DoubleT}

    def cols():
        return {"a": torch.arange(5, dtype=torch.int32),
                "b": torch.arange(5, dtype=torch.float64) / 2}
    given = cols()
    got = Table.from_numpy("t", harness.HandOver(given), types,
                           device="cpu")
    want = Table.from_numpy("t", cols(), types, device="cpu")
    assert given == {}                      # each column taken out
    assert list(got.columns) == list(want.columns) == ["a", "b"]
    for name, c in want.columns.items():
        assert got.columns[name].nrows == c.nrows == 5
        assert torch.equal(got.columns[name].data, c.data)


def test_four_gloo_ranks_traced():
    out, _ = _run(mesh_cell(), traced=True)
    assert out["correct"] is True, out["checks"]
    assert "frontend.parse_ms" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_ranks_wait_out_rank_0s_copies_inside_the_pause():
    """Every rank leaves the pause with rank 0, so the others' windows,
    averaged into the result's, leave rank 0's copies out too."""
    cell = mesh_cell()
    out, _ = _run(cell, rank_setup=_slow_copies, traced=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["window_s"] < COPY_S * len(cell.queries) / 2


def _q3() -> str:
    (sql,) = next(q for q in mesh_cell().queries if q.name == "q3").statements
    return sql


@pytest.mark.parametrize("fault", ["query_raises", "dies"])
def test_a_failed_rank_ends_the_world(fault):
    setup = (functools.partial(_query_raises, _q3(), 2)
             if fault == "query_raises" else _dies)
    t0 = time.monotonic()
    out, _ = _run(mesh_cell(), rank_setup=setup)
    assert time.monotonic() - t0 < 120
    assert out["correct"] is False
    assert out["failed"] >= 1 and out["checks"]["ranks_failed"]["value"] > 0
    assert out["device"]["count"] == RANKS
    assert not mp.active_children()


def test_a_mesh_without_its_exchange_is_not_correct():
    out, _ = _run(mesh_cell(), rank_setup=_no_exchange)
    assert out["correct"] is False
    failed = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    assert failed and out["failed"] == 0, out["checks"]


def test_a_hung_world_is_killed_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(ranks.WorldTimeout):
        _run(mesh_cell(), rank_setup=_hangs, deadline_s=15)
    assert time.monotonic() - t0 < 60
    assert not mp.active_children()


def test_a_new_mesh_cell_needs_only_data_files(tmp_path):
    """A copy of the benchmark gains a cell of 4 chips as a workload file
    and an entry of BENCHMARK.json alone; the harness finds it by name
    and runs it over 4 ranks."""
    root = tmp_path / "repo"
    shutil.copytree(harness.ROOT, root / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = harness.load_json(harness.ROOT / "workloads"
                                / "h2o_g1_1e8.groupby.json")
    traffic.update(name="h2o_g1_1e8.mesh_tiny", chips=RANKS)
    (root / "qbench" / "workloads" / "h2o_g1_1e8.mesh_tiny.json").write_text(
        json.dumps(traffic))
    m = harness.load_json(harness.REPO / "BENCHMARK.json")
    m["workloads"].append({"name": "h2o_g1_1e8.mesh_tiny",
                           "config": "h2o_g1_1e8", "traffic": "mesh_tiny",
                           "chips": RANKS, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    probe = (
        "import sys, time, torch; sys.path.insert(0, sys.argv[1]); "
        "sys.path.insert(1, sys.argv[2])\n"
        "from qbench import harness, ranks\n"
        "if __name__ == '__main__':\n"
        "    c = harness.find_cell('h2o_g1_1e8.mesh_tiny')\n"
        "    c.config = harness.scaled(c.config, 2000)\n"
        "    out, bad = ranks.run(c, 5, 0.05, False, "
        "[torch.device('cpu')] * c.workload['chips'], 'gloo', "
        "time.perf_counter(), log=lambda m: None, deadline_s=240)\n"
        "    print(out['correct'], out['device']['count'], bad)")
    script = tmp_path / "probe.py"
    script.write_text(probe)
    r = subprocess.run([sys.executable, str(script), str(root),
                        str(harness.REPO)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().split("\n")[-1] == f"True {RANKS} []", r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_rank_path_on_cards(backend, traced):
    """G1_1e7 over 4 ranks: one card a rank over NCCL, or all four on
    cuda:0 over gloo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if backend == "nccl" and torch.cuda.device_count() < RANKS:
        pytest.skip(f"NCCL ranks need {RANKS} CUDA cards")
    devices = ([torch.device("cuda", r) for r in range(RANKS)]
               if backend == "nccl" else [torch.device("cuda", 0)] * RANKS)
    out, bad = _run(mesh_cell(10_000_000), devices=devices, backend=backend,
                    seconds=3, traced=traced, deadline_s=900)
    print(json.dumps(out))                      # the result line, with -s
    assert out["correct"] is True, out["checks"]
    assert bad == [] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == RANKS
    assert out["device"]["memory_peak_bytes"] > 0
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
