"""What the benchmark loads: a run at a tiny size loads neither JAX nor
the JAX package (compared by whole top-level name, so the port passes),
and the yardstick's files import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from qbench_cells import CELLS
from qbench import harness

YARDSTICK = ["check.py", "trace.py", "roofline.py", "reference",
             "generators", "metrics"]
PROGRAM = ("aquery2_tpu_torch", "aquery2_tpu", "jax", "jaxlib", "flax")


def imported(path) -> set[str]:
    """Top-level names a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_yardstick_imports_nothing_of_the_program():
    files = []
    for name in YARDSTICK:
        p = harness.ROOT / name
        files += sorted(p.glob("*.py")) if p.is_dir() else [p]
    assert any(f.parent.name == "reference" for f in files)
    for f in files:
        bad = imported(f) & set(PROGRAM)
        assert not bad, f"{f} imports {bad}"


def test_nothing_imports_jax_by_name():
    for f in harness.ROOT.rglob("*.py"):
        names = imported(f)
        assert not names & {"jax", "jaxlib", "flax", "aquery2_tpu"}, f


def test_a_run_loads_no_jax(tmp_path):
    probe = (
        "import sys, time, torch; sys.path.insert(0, sys.argv[1]); "
        "from qbench import harness; "
        "runs = []\n"
        "for name in sys.argv[2:]:\n"
        "    c = harness.find_cell(name)\n"
        "    c.config = harness.scaled(c.config, 2000)\n"
        "    runs.append(harness.run(c, 11, 0.05, True, torch.device('cpu'),"
        " time.perf_counter(), log=lambda m: None)['correct'])\n"
        "mods = sorted(sys.modules)\n"
        "print(all(runs), 'aquery2_tpu_torch' in mods, "
        "harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", probe, str(harness.REPO),
                        *CELLS], capture_output=True, text=True,
                       timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().split("\n")[-1] == "True True []", r.stdout


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("aquery2_tpu_torch_probe_name", sys)
    try:
        assert "aquery2_tpu_torch_probe_name" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["aquery2_tpu_torch_probe_name"]
