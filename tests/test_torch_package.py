"""Package-level checks of the PyTorch port: it imports no JAX, parses
like the JAX package, refuses a missing card, and (on a machine with a
CUDA card) its kernels agree with their plain versions.

Only the parser test imports the JAX package, so that the card test runs
where JAX is not installed:
    python -m pytest tests/test_torch_package.py -m gpu --noconftest -q"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import aquery2_tpu_torch
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.parser import parse as tparse
from bench import QUERIES

PKG = pathlib.Path(aquery2_tpu_torch.__file__).parent


def test_import_pulls_in_no_jax():
    code = ("import sys; before = set(sys.modules); import aquery2_tpu_torch; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'aquery2_tpu')); "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_name_no_jax():
    """No module of the port imports jax or the JAX package."""
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                assert nm.split(".")[0] not in ("jax", "jaxlib",
                                                "aquery2_tpu"), (path, nm)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_parser_matches_jax(name):
    from aquery2_tpu.parser import parse as jparse

    assert repr(tparse(QUERIES[name])) == repr(jparse(QUERIES[name]))


def test_connect_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aquery2_tpu_torch.connect()
    assert aquery2_tpu_torch.connect(device="cpu").device.type == "cpu"


def test_library_name_follows_sources():
    so = K.library_path()
    assert so.parent == K.BUILD_DIR and so.suffix == ".so"
    assert K.library_path() == so


def test_diagnostic_builds_get_their_own_library():
    assert K.library_path(("-DAQ_LOOKBACK_DIAG",)) != K.library_path()
    assert K.library_path(("-DAQ_LOOKBACK_SMEM=16384",)).parent == K.BUILD_DIR


def test_ptxas_report_names_the_scans(tmp_path, monkeypatch):
    log = tmp_path / "lib.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN2aq16segscan_lookbackIN"
        "8aq_multi5MultiIyLi3EEELb1EEEvT_PKhPNS4_1WES8_Pili' for 'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers, 1104 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN2aq16segscan_lookbackIN"
        "6aq_i646AddI64ELb0EEEvT_PKhPNS3_1WES7_Pili' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers\n")
    monkeypatch.setattr(K, "library_path", lambda defines=(): log.with_suffix(
        ".so"))
    assert K.ptxas_report() == [
        {"kernel": "seg_scan_multi 3 x 64-bit, flags 1", "smem": 1104,
         "stack": 8, "spill_stores": 12, "spill_loads": 12, "registers": 56},
        {"kernel": "seg_cumsum_i64, flags 0", "smem": 0, "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 32}]


def test_lookback_diag_summarizes_tile_records():
    """Two SMs, each holding two blocks at a time over its span: two blocks
    resident; the phases' shares of the blocks' cycles."""
    from aquery2_tpu_torch.utils.lookback_diag import summarize

    # [sm, entry, loaded, scanned, looked back, written, windows, threads]
    rec = np.array([[0, 0, 40, 50, 50, 100, 0, 64],      # tile 0: no walk
                    [1, 0, 40, 50, 70, 100, 1, 64],
                    [0, 0, 40, 50, 70, 100, 1, 64],
                    [1, 0, 40, 50, 90, 100, 3, 64]], np.int64)
    s = summarize(rec, threads=64)
    assert s["sms"] == 2 and s["tiles"] == 4
    assert s["resident_blocks_per_sm"] == 2.0
    assert s["achieved_warp_occupancy"] == 2 * 2 / 64
    assert (s["share_load"], s["share_fold_scan"]) == (0.4, 0.1)
    assert s["share_look_back"] == 80 / 400
    assert s["share_rescan_store"] == 120 / 400
    assert s["windows_max"] == 3 and s["look_back_cycles_max"] == 40


_N_CASES = ["1", "tile-1", "tile", "tile+1", "3tile+5", "61563"]


def _rows(case: str, tile: int) -> int:
    return {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "3tile+5": 3 * tile + 5, "61563": 61563}[case]


def _flag_cases(rng, n, tile, dev):
    """None, density 0.01, and lone flags: on the first row of the last
    tile, in the middle of the last tile (after every earlier tile had
    none), and on the last row."""
    cases = [None, torch.from_numpy(rng.random(n) < 0.01).to(dev)]
    last = (n - 1) // tile * tile
    for row in (last, min(n - 1, last + tile // 2 + 3), n - 1):
        f = torch.zeros(n, dtype=torch.bool, device=dev)
        f[row] = True
        cases.append(f)
    return cases


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


@pytest.mark.gpu
@pytest.mark.parametrize("case", _N_CASES)
def test_kernels_match_plain_on_card(case):
    """The four kernels against their plain versions, exactly (float32
    running sums against a float64 cumsum, within 1e-5 of the running sum
    of |x|). The single-pass scans at one row, one row below, at and above
    their tile, a ragged fourth tile and 61,563 rows, each call twice in a
    row (fresh scratch, then the allocator's reused scratch), over the flag
    cases; seg_scan_multi with 1 to 4 lanes of 32-bit and of 64-bit words
    (int32 and int64 add, min and max; float min and max with NaN; the
    64-bit float adds integer-valued, exact in any order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lib = K.build()
    rng = np.random.default_rng(_N_CASES.index(case))
    dev = torch.device("cuda")

    def scans(tile, make, kernel, plain):
        n = _rows(case, tile)
        for f in _flag_cases(rng, n, tile, dev):
            args = make(n, f)
            want = plain(*args)
            for _ in range(2):
                _assert_equal(kernel(*args), want)

    def cumsum(n, f):
        x = torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(dev)
        x[0] = 2**63 - 1                     # wraps on the next add
        return f, x
    scans(lib.aq_seg_cumsum_i64_tile_rows(), cumsum,
          lambda f, x: (K.seg_cumsum_i64(f, x),),
          lambda f, x: (K.seg_cumsum_i64_plain(f, x),))

    def lanes(k, names, ops):
        def make(n, f):
            xi = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32))
            xf = torch.from_numpy(rng.normal(size=n).astype(np.float32))
            xf[::977] = float("nan")
            cols = {"xi": xi, "xf": xf, "xd": xf.double() * 2.0 ** 40,
                    "x64": torch.from_numpy(rng.integers(-2**62, 2**62, n)),
                    "xa": torch.from_numpy(rng.integers(-2**20, 2**20, n)
                                           .astype(np.float64))}
            return (f, tuple(cols[c].to(dev) for c in names[:k]), ops[:k])
        return make
    # (word width, lanes, ops): each (width, k) is its own tile geometry;
    # the 64-bit sets cover int64 add, min and max, float64 min and max
    # with NaN and an integer-valued float64 add
    lane_sets = [(0, ("xi", "xf", "xf", "xi"), ("add", "min", "max", "min")),
                 (0, ("xi", "xi", "xf", "xf"), ("min", "max", "min", "max")),
                 (1, ("x64", "xd", "xd", "xa"), ("add", "min", "max", "add")),
                 (1, ("x64", "x64", "xd", "x64"), ("min", "max", "max", "add"))]
    for k in (4, 3, 2, 1):
        for wide, names, ops in lane_sets:
            scans(lib.aq_seg_scan_multi_tile_rows(k, wide),
                  lanes(k, names, ops), K.seg_scan_multi,
                  K.seg_scan_multi_plain)

    n = _rows(case, 4096)
    flags = torch.from_numpy(rng.random(n) < 0.01).to(dev)
    x64 = torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(dev)
    xi = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32)).to(dev)
    xf = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    xf[::977] = float("nan")
    lanes4 = (x64, xi, flags, xi.to(torch.int64) * x64)
    for dp in (1, 11, 513):
        code = torch.from_numpy(rng.integers(0, dp, n).astype(np.int32)).to(dev)
        assert torch.equal(K.onehot_segment_sums(code, lanes4, dp),
                           K.onehot_segment_sums_plain(code, lanes4, dp))
    xr = torch.nan_to_num(xf)               # NaN-free sums; NaN min/max
    got = K.fused_running_stats(xr)
    exact = torch.cumsum(xr.double(), 0)
    scale = torch.cumsum(xr.double().abs(), 0)
    assert bool(((got[0].double() - exact).abs() <= 1e-5 * scale).all())
    _assert_equal(K.fused_running_stats(xf)[1:],
                  K.fused_running_stats_plain(xf)[1:])
