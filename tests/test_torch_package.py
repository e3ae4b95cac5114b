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
        "ptxas info    : Used 32 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN2aq16segscan_lookbackIN"
        "10aq_running8RunStatsELb0EEEvT_PKhPNS3_1WES7_Pili' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 532 bytes smem\n")
    monkeypatch.setattr(K, "library_path", lambda defines=(): log.with_suffix(
        ".so"))
    assert K.ptxas_report() == [
        {"kernel": "seg_scan_multi 3 x 64-bit, flags 1", "smem": 1104,
         "stack": 8, "spill_stores": 12, "spill_loads": 12, "registers": 56},
        {"kernel": "seg_cumsum_i64, flags 0", "smem": 0, "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 32},
        {"kernel": "fused_running_stats 3 x float32, one input", "smem": 532,
         "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 40}]


def test_ptxas_report_names_onehot_routes():
    assert K._kernel_name("_ZN9aq_onehot11onehot_sumsILi5ELb1EEEvNS_6Params"
                          "E") == "onehot_segment_sums 5 lanes, private"
    assert K._kernel_name("_ZN9aq_onehot11onehot_sumsILi8ELb0EEEvNS_6Params"
                          "E") == "onehot_segment_sums 8 lanes, shared"


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


def test_lookback_diag_shapes_count_their_bytes():
    """Each diagnosed shape's bytes (inputs read once, the outputs its call
    returns written once, flags 1 B/row; on the CPU the calls take the
    plain versions) and the instantiation it names in ptxas' report;
    fused_running_stats reads one float32 column and writes three."""
    from aquery2_tpu_torch.utils.lookback_diag import SHAPES, Shape, columns

    n = 1000
    cols = columns(torch.device("cpu"), n)
    shapes = {s.label: s for s in (Shape(*sh, cols) for sh in SHAPES)}
    per_row = {label: s.nbytes() / n for label, s in shapes.items()}
    assert per_row["seg_cumsum_i64, 1 x int64"] == 17
    assert per_row["seg_cumsum_i64, 1 x int64, no flags"] == 16
    assert per_row["seg_scan_multi, q7: int32 min + int32 max"] == 17
    assert per_row["seg_scan_multi, 3 x 32-bit"] == 25
    assert per_row["seg_scan_multi, 3 x 64-bit"] == 49
    run = shapes["fused_running_stats, 1 x float32 in, 3 out, no flags"]
    assert per_row[run.label] == 16 and run.flags is None
    assert run.name == K._kernel_name(
        "_ZN2aq16segscan_lookbackIN10aq_running8RunStatsELb0EEEvT_PKhPNS3_1WE"
        "S7_Pili")
    assert shapes["seg_scan_multi, 3 x 64-bit"].name == K._kernel_name(
        "_ZN2aq16segscan_lookbackIN8aq_multi5MultiIyLi3EEELb1EEEvT_PKhPNS4_1W"
        "ES8_Pili")
    assert shapes["seg_cumsum_i64, 1 x int64, no flags"].name == (
        K._kernel_name("_ZN2aq16segscan_lookbackIN6aq_i646AddI64ELb0EEEvT_PKh"
                       "PNS3_1WES7_Pili"))


@pytest.mark.gpu
def test_lookback_diag_reads_each_block_from_the_library():
    """The diagnosed blocks as launch_lookback makes them: fused_running_stats
    stages two 4,096-row float32 buffers (32 KB, 256 threads), the three
    32-bit seg_scan_multi lanes three 3,584-row buffers (43,008 B, 224
    threads); and the blocks an SM's shared memory could hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.utils.lookback_diag import (
        SHAPES, Shape, columns, occupancy_limits)

    lib = K.build()
    cols = columns(torch.device("cuda"), 64)
    shapes = {s.label: s for s in (Shape(*sh, cols) for sh in SHAPES)}
    run = shapes["fused_running_stats, 1 x float32 in, 3 out, no flags"]
    assert run.block(lib) == (256, 32768)
    assert run.rows(lib) == lib.aq_fused_running_stats_tile_rows() == 4096
    assert shapes["seg_scan_multi, 3 x 32-bit"].block(lib) == (224, 43008)
    for sh in shapes.values():
        threads, dyn = sh.block(lib)
        assert dyn % sh.rows(lib) == 0 and sh.rows(lib) % threads == 0
    ptxas = {r["kernel"]: r for r in K.ptxas_report()}
    assert occupancy_limits(ptxas[run.name], 256, 32768)[
        "by_shared_memory"] == 6


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


_Q4_LANES = (torch.bool, torch.int32, torch.int32, torch.int64, torch.int64)
_NA8_LANES = (torch.bool,) * 4 + (torch.int32,) * 2 + (torch.int64,) * 2


def _onehot_views(rng, case, dev):
    """onehot_segment_sums at the case's rows counted in its own tiles, on
    q4's lanes and the NA variant's 8-lane mix: the codes as views at
    offsets 0, 1 and 3 and each lane at another offset in 0..3 (aligned
    and not), at dp 11 and 101 (each route) and at the
    private route's limit for q4's lanes and one past it."""
    lim = 1
    while K.onehot_route(lim + 1, _Q4_LANES, 1 << 20)["private"]:
        lim += 1
    for dtypes in (_Q4_LANES, _NA8_LANES):
        for dp in (11, 101, lim, lim + 1):
            n = _rows(case, K.onehot_route(dp, dtypes, 1 << 20)["tile_rows"])
            cols = [torch.from_numpy(
                rng.random(n + 3) < 0.5 if dt == torch.bool
                else rng.integers(-2**62, 2**62, n + 3) if dt == torch.int64
                else rng.integers(-2**31, 2**31 - 1, n + 3).astype(np.int32)
            ).to(dev) for dt in dtypes]
            code = torch.from_numpy(
                rng.integers(0, dp, n + 3).astype(np.int32)).to(dev)
            for off in (0, 1, 3):
                c = code[off:off + n]
                ls = tuple(x[(off + j) % 4:(off + j) % 4 + n]
                           for j, x in enumerate(cols))
                assert torch.equal(K.onehot_segment_sums(c, ls, dp),
                                   K.onehot_segment_sums_plain(c, ls, dp)), (
                    dtypes, dp, n, off)


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
    64-bit float adds integer-valued, exact in any order);
    fused_running_stats on an aligned column and on views at offsets 1 and
    3, NaN-free (the sums on every row) and with NaNs from three tiles in."""
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
    _onehot_views(rng, case, dev)

    # a NaN-free column, its sums checked on every row; and the same column
    # with NaNs from three tiles into the view (from its last row where it
    # is shorter), so that the carries of all three statistics across tiles
    # are compared before the first NaN
    tile = lib.aq_fused_running_stats_tile_rows()
    n = _rows(case, tile)
    late = min(3 * tile + 7, n - 1)
    clean = torch.from_numpy(rng.normal(size=n + 3).astype(np.float32)).to(dev)
    for nan in (False, True):
        for off in (0, 1, 3):
            col = clean
            if nan:
                col = clean.clone()
                col[off + late::977] = float("nan")
            x = col[off:off + n]
            want = K.fused_running_stats_plain(x)
            exact = torch.cumsum(torch.nan_to_num(x).double(), 0)
            scale = torch.cumsum(torch.nan_to_num(x).double().abs(), 0)
            for _ in range(2):
                got = K.fused_running_stats(x)
                _assert_equal(got[1:], want[1:])
                assert torch.equal(got[0].isnan(), want[0].isnan())
                ok = ~got[0].isnan()
                assert int(ok.sum()) == (late if nan else n)
                assert bool(((got[0].double() - exact).abs()[ok]
                             <= 1e-5 * scale[ok]).all()), (n, off)
