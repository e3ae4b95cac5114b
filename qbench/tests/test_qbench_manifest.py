"""BENCHMARK.json against the form its readers expect, and the data-driven
layout: every name it holds is found as a file under qbench/, and a new
cell, query and metric are found by name with no existing file edited."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
from qbench_cells import CELLS
from qbench import harness

M = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [r for c in M["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in M[k]]
    assert all(UNIT.match(u) for u in units), units
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in M[k]}) == len(M[k])


def test_each_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["name"] in [x["name"]
                                 for x in harness.find_cell(cell).per_layer]
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        c = harness.find_cell(cell)
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        cfg = harness.load_json(harness.REPO / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert (harness.ROOT / "reference" / f"{c['name']}.py").exists()
        assert (harness.ROOT / "generators"
                / f"{cfg['generator']}.py").exists()
    for w in M["workloads"]:
        c = harness.find_cell(w["name"])
        assert c.workload["name"] == w["name"]
        for q in c.queries:
            assert q.statements
            assert callable(harness.reference_fn(w["config"], q.name))
    for m in M["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


NEW_GENERATOR = '''
import torch

STRINGS = {}


def make(cfg, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = cfg["rows"]
    yield "t", {"k": torch.randint(1, 6, (n,), generator=g, device=device,
                                   dtype=torch.int32),
                "v": torch.randint(0, 9, (n,), generator=g, device=device,
                                   dtype=torch.int32)}


def scaled(cfg, rows):
    return {**cfg, "rows": rows}
'''

NEW_REFERENCE = '''
import torch

from qbench.check import Answer


def ksum(t, fdtype=None):
    k, v = t["t"]["k"], t["t"]["v"]
    keys, inv = torch.unique(k, return_inverse=True)
    s = torch.zeros(len(keys), dtype=torch.int64).index_add_(
        0, inv, v.to(torch.int64))
    return Answer({"k": keys, "s": s}, ["k"])
'''


def test_a_new_config_cell_query_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration (its file, generator,
    reference and query), a cell of it, a new mix of an existing
    configuration with a new query, and a per-layer metric, as files and
    entries only: the harness finds each by name and runs both cells."""
    root = tmp_path / "repo"
    shutil.copytree(harness.ROOT, root / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "qbench").rglob("*")
              if p.is_file()}
    q = root / "qbench"
    (q / "queries" / "h2o_g1_1e8" / "q1_desc.sql").write_text(
        "SELECT id1, sum(v1) AS v1 FROM source GROUP BY id1 "
        "ORDER BY id1 DESC;\n")
    (q / "reference" / "h2o_g1_1e8.q1_desc.py").write_text(
        "from qbench.harness import load_module\n\n\n"
        "def answer(t, fdtype=None):\n"
        "    return load_module('reference', 'h2o_g1_1e8').q1(t)\n")
    (q / "workloads" / "h2o_g1_1e8.tiny.json").write_text(
        json.dumps({"name": "h2o_g1_1e8.tiny", "config": "h2o_g1_1e8",
                    "chips": 1, "why": "a test",
                    "queries": [{"name": "q1", "input_rows": 100},
                                {"name": "q1_desc", "input_rows": 100}]}))
    (q / "configs" / "tiny_t.json").write_text(json.dumps(
        {"name": "tiny_t", "generator": "tiny_t", "rows": 1000,
         "reduced": []}))
    (q / "generators" / "tiny_t.py").write_text(NEW_GENERATOR)
    (q / "reference" / "tiny_t.py").write_text(NEW_REFERENCE)
    (q / "queries" / "tiny_t").mkdir()
    (q / "queries" / "tiny_t" / "ksum.sql").write_text(
        "SELECT k, sum(v) AS s FROM t GROUP BY k;\n")
    (q / "workloads" / "tiny_t.sum.json").write_text(
        json.dumps({"name": "tiny_t.sum", "config": "tiny_t", "chips": 1,
                    "why": "a test",
                    "queries": [{"name": "ksum", "input_rows": 1000}]}))
    (q / "metrics" / "test.queries.py").write_text(
        "def read(w):\n    return float(w.queries)\n")
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "tiny_t", "source": "a test",
                         "file": "qbench/configs/tiny_t.json",
                         "reduced": [], "why": "a test"})
    m["workloads"] += [
        {"name": "h2o_g1_1e8.tiny", "config": "h2o_g1_1e8",
         "traffic": "tiny", "chips": 1, "why": "a test"},
        {"name": "tiny_t.sum", "config": "tiny_t", "traffic": "sum",
         "chips": 1, "why": "a test"}]
    m["per_layer"].append({"name": "test.queries", "unit": "queries",
                           "better": "higher", "source": "program_counter",
                           "layer": "front end", "moves": "rows_per_s",
                           "workloads": ["h2o_g1_1e8.tiny", "tiny_t.sum"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data           # nothing edited
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1]); "
        "sys.path.insert(1, sys.argv[2]); import time, torch; "
        "from qbench import harness\n"
        "for name in ('h2o_g1_1e8.tiny', 'tiny_t.sum'):\n"
        "    c = harness.find_cell(name)\n"
        "    c.config = harness.scaled(c.config, 2000)\n"
        "    out = harness.run(c, 3, 0.05, True, torch.device('cpu'), "
        "time.perf_counter(), log=lambda m: None)\n"
        "    print(name, out['correct'], "
        "out['metrics']['test.queries']['value'] > 0)")
    r = subprocess.run([sys.executable, "-c", probe, str(root),
                        str(harness.REPO)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[-3:-1] == [
        "h2o_g1_1e8.tiny True True", "tiny_t.sum True True"], r.stdout[-500:]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_query_file_is_read(cell):
    c = harness.find_cell(cell)
    assert [q.name for q in c.queries] == [
        q["name"] for q in c.workload["queries"]]
    assert all(q.input_rows > 0 for q in c.queries)
