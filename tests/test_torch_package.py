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
import torch_onehot_cases as C

PKG = pathlib.Path(aquery2_tpu_torch.__file__).parent


def test_import_pulls_in_no_jax():
    code = ("import sys; before = set(sys.modules); import aquery2_tpu_torch; "
            "import aquery2_tpu_torch.engine.fused_star, "
            "aquery2_tpu_torch.engine.fused_join, "
            "aquery2_tpu_torch.engine.eval, "
            "aquery2_tpu_torch.engine.fused_scan, "
            "aquery2_tpu_torch.engine.join, "
            "aquery2_tpu_torch.engine.udf, "
            "aquery2_tpu_torch.engine.udf_rewrite, "
            "aquery2_tpu_torch.engine.udf_device, "
            "aquery2_tpu_torch.runtime.stats, "
            "aquery2_tpu_torch.storage.csvio, "
            "aquery2_tpu_torch.ops.window, "
            "aquery2_tpu_torch.ops.hashing, "
            "aquery2_tpu_torch.runtime.procedures, "
            "aquery2_tpu_torch.runtime.triggers, "
            "aquery2_tpu_torch.native, "
            "aquery2_tpu_torch.storage.datasource, "
            "aquery2_tpu_torch.storage.external, "
            "aquery2_tpu_torch.sdk.modules, "
            "aquery2_tpu_torch.models.decision_tree, "
            "aquery2_tpu_torch.models.random_forest, "
            "aquery2_tpu_torch.models.irf, "
            "aquery2_tpu_torch.repl.prompt, "
            "aquery2_tpu_torch.repl.server, "
            "aquery2_tpu_torch.demo, "
            "aquery2_tpu_torch.parallel.mesh, "
            "aquery2_tpu_torch.parallel.comm, "
            "aquery2_tpu_torch.parallel.multihost, "
            "aquery2_tpu_torch.parallel.launch, "
            "aquery2_tpu_torch.parallel.dist_groupby, "
            "aquery2_tpu_torch.parallel.dist_join, "
            "aquery2_tpu_torch.parallel.dist_scan, "
            "aquery2_tpu_torch.parallel.step, "
            "aquery2_tpu_torch.engine.dist_query, "
            "aquery2_tpu_torch.engine.dist_join_query, "
            "aquery2_tpu_torch.engine.dist_scan, "
            "aquery2_tpu_torch.engine.dist_setop, "
            "aquery2_tpu_torch.engine.dist_ordered, "
            "aquery2_tpu_torch.engine.dist_window; "
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
    paths = sorted(PKG.rglob("*.py"))
    assert {PKG / "engine" / nm for nm in (
        "fused_star.py", "fused_join.py", "eval.py", "fused_scan.py",
        "groupby.py", "grouped_agg.py", "join.py", "udf.py",
        "udf_rewrite.py", "udf_device.py")} | {PKG / "ops" / nm for nm in (
            "agg.py", "filter.py", "ragged.py", "hashing.py", "window.py")} \
        | {PKG / "runtime" / "stats.py", PKG / "storage" / "csvio.py"} \
        | {PKG / nm for nm in (
            "runtime/procedures.py", "runtime/triggers.py",
            "native/__init__.py", "storage/datasource.py",
            "storage/external.py", "sdk/modules.py",
            "models/decision_tree.py", "models/random_forest.py",
            "models/irf.py", "repl/prompt.py", "repl/server.py",
            "__main__.py", "demo.py")} \
        | {PKG / "parallel" / nm for nm in (
            "__init__.py", "mesh.py", "comm.py", "multihost.py", "launch.py",
            "dist_groupby.py", "dist_join.py", "dist_scan.py", "step.py")} \
        | {PKG / "engine" / f"dist_{nm}.py" for nm in (
            "query", "join_query", "scan", "setop", "ordered",
            "window")} <= set(paths)
    for path in paths:
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
    def name(args):
        return K._kernel_name(f"_ZN9aq_onehot11onehot_sumsI{args}EEvNS_6Para"
                              f"msE")
    assert name("Li5ELb1ELb0ELi0E") == ("onehot_segment_sums 5 lanes, "
                                        "private, code")
    assert name("Li8ELb0ELb0ELi0E") == ("onehot_segment_sums 8 lanes, "
                                        "shared, code")
    assert name("Li6ELb0ELb1ELi0E") == ("onehot_segment_sums 6 lanes, "
                                        "shared, float64, code")
    assert name("Li6ELb0ELb0ELi2E") == ("onehot_segment_sums 6 lanes, "
                                        "shared, 2 keys")
    assert name("Li4ELb1ELb1ELi1E") == ("onehot_segment_sums 4 lanes, "
                                        "private, float64, 1 key")


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


def _f64_check(code, lanes, dp, got, place):
    """got (a call's [dp, k] output) against the plain version: the float64
    lane at place within C.F64_RTOL normwise of each slot's math.fsum,
    with the plain version's NaNs, infinities and signed zeros where its
    sums are not finite or zero; every other lane equal bit for bit to an
    integer-only plain call over the rows whose code is in [0, dp)."""
    ok = (code >= 0) & (code < dp)
    c, ls = code[ok], tuple(x[ok] for x in lanes)
    want = K.onehot_segment_sums_plain(c, ls, dp)[:, place].view(torch.float64)
    f = got[:, place].view(torch.float64)
    assert torch.equal(f.isnan(), want.isnan()), (f, want)
    fin = want.isfinite()
    assert torch.equal(f[~fin & ~want.isnan()], want[~fin & ~want.isnan()])
    assert torch.equal(f[want == 0].signbit(), want[want == 0].signbit())
    if bool(ls[place].isfinite().all()):
        assert C.normwise_error(f, C.fsum_slots(c, ls[place], dp)) \
            <= C.F64_RTOL, (dp, len(lanes), place)
    else:
        assert C.normwise_error(f[fin], want[fin].cpu().numpy()) \
            <= C.F64_RTOL
    ints = [j for j in range(len(lanes)) if j != place]
    if ints:
        assert torch.equal(got[:, ints], K.onehot_segment_sums_plain(
            c, tuple(ls[j] for j in ints), dp))


@pytest.mark.gpu
@pytest.mark.parametrize("k,place", C.F64_PLACES)
@pytest.mark.parametrize("dp", C.F64_DPS)
def test_onehot_float64_lane_on_card(dp, k, place):
    """The kernel with a float64 lane at the first, a middle or the last of
    1, 6 and 8 lanes, over five tiles and 123 rows, at dp 2, 11 (private
    route), 101 and 513 (shared route; copies of its own for each warp or
    shared by warps): the float64 column within 1e-12 normwise of each
    slot's math.fsum, the integer and bool lanes bit for bit as an
    integer-only call gives them; ONEHOT_LANES counts each lane's dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(dp * 100 + k * 10 + place)
    dev = torch.device("cuda")
    cpu = C.f64_lanes(rng, 1, k, place)
    tile = K.onehot_route(dp, tuple(x.dtype for x in cpu), 1 << 20)[
        "tile_rows"]
    n = 5 * tile + 123
    code = torch.from_numpy(rng.integers(0, dp, n).astype(np.int32)).to(dev)
    lanes = tuple(x.to(dev) for x in C.f64_lanes(rng, n, k, place))
    before = dict(K.ONEHOT_LANES)
    got = K.onehot_segment_sums(code, lanes, dp)
    counted = {d: K.ONEHOT_LANES[d] - before[d] for d in before}
    assert counted == {d: sum(str(x.dtype) == "torch." + d for x in lanes)
                       for d in before}
    _f64_check(code, lanes, dp, got, place)


# The integer-only routes of the dense tier's lanes at G1_1e8's 100,663,296
# rows as the kernel planned them before it took float64 lanes (on an
# NVIDIA H100 80GB HBM3): private, copies, threads, blocks, tile rows,
# shared memory, blocks an SM holds, stage bytes.
_INT_LANES = {
    "q1": (11, (torch.bool, torch.int32)),
    "q2": (101, (torch.bool, torch.int32)),
    "q4": (11, (torch.bool, torch.int32, torch.int32)),
    "q9": (101, (torch.bool, torch.int32, torch.int32) + (torch.int64,) * 3),
    "na8_dp513": (513, _NA8_LANES),
}
_INT_ROUTES = {
    "q1": (1, 256, 256, 264, 3072, 100448, 2, 27696),
    "q2": (0, 1, 256, 528, 3072, 57008, 4, 27696),
    "q4": (1, 256, 256, 132, 2048, 120960, 1, 26688),
    "q9": (0, 8, 256, 264, 1024, 114784, 2, 38000),
    "na8_dp513": (0, 1, 256, 264, 1024, 98656, 2, 32912),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["views", "ragged", "one_slot", "specials",
                                  "out_of_range", "routes", "int_only",
                                  "many_tiles"])
def test_onehot_float64_edges_on_card(case):
    """The float64 lane's edges on the card, each against the plain
    version as _f64_check holds it: views (the codes at element offsets 1
    and 3, the float64 lane at 1 and 3, 8 and 24 bytes: 8-byte aligned,
    not 16); ragged n (1, 1,023, 1,025, five tiles and 123); every row in
    one slot (a warp's 32 lanes in one group); NaN, ±inf, +inf with -inf
    in one slot, and a slot of -0.0 only; codes outside [0, dp) dropped;
    both routes with the float64 lane, the private route's last dp and one
    past it, and the shared route's copies of a warp's own and shared by
    warps; an integer-only call's route as before float64 lanes existed
    and its output as the plain version's; and rows enough that each block
    of the persistent grid walks four tiles and more, staged two at a time
    (q4's lanes and 8 lanes on both routes, and q4's at element offset 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7 + len(case))
    dev = torch.device("cuda")
    q4 = (torch.bool, torch.int32, torch.int32, torch.float64)

    def lanes_of(dtypes, n):
        place = dtypes.index(torch.float64)
        k = len(dtypes)
        got = C.f64_lanes(rng, n, k, place)
        return tuple(x.to(dev) for x in got), place

    def run(dp, dtypes, n, code=None, edit=None):
        lanes, place = lanes_of(dtypes, n)
        if code is None:
            code = torch.from_numpy(
                rng.integers(0, dp, n).astype(np.int32)).to(dev)
        if edit is not None:
            lanes = edit(code, lanes, place)
        _f64_check(code, lanes, dp,
                   K.onehot_segment_sums(code, lanes, dp), place)

    eight = (torch.int64, torch.int32, torch.bool, torch.float64,
             torch.int64, torch.int32, torch.bool, torch.int64)
    if case == "views":
        for dp in (11, 101):
            n = 3 * K.onehot_route(dp, q4, 1 << 20)["tile_rows"] + 5
            base, place = lanes_of(q4, n + 3)
            code = torch.from_numpy(
                rng.integers(0, dp, n + 3).astype(np.int32)).to(dev)
            for off in (1, 3):
                c = code[off:off + n]
                ls = tuple(x[(off + j) % 4:(off + j) % 4 + n]
                           for j, x in enumerate(base))
                ls = ls[:place] + (base[place][off:off + n],) + ls[place + 1:]
                assert ls[place].data_ptr() % 16 == 8
                _f64_check(c, ls, dp, K.onehot_segment_sums(c, ls, dp), place)
    elif case == "ragged":
        for dtypes in (q4, eight):
            for dp in (11, 101):
                tile = K.onehot_route(dp, dtypes, 1 << 20)["tile_rows"]
                for n in (1, 1023, 1025, 5 * tile + 123):
                    run(dp, dtypes, n)
    elif case == "one_slot":
        for dp in (11, 101, 513):
            for dtypes in (q4, eight):
                n = 40_000
                run(dp, dtypes, n, code=torch.full((n,), dp - 1,
                                                   dtype=torch.int32,
                                                   device=dev))
    elif case == "specials":
        def specials(code, lanes, place):
            x = lanes[place].clone()
            rows = {s: torch.nonzero(code == s).squeeze(1) for s in range(6)}
            x[rows[1]] = -0.0                       # a slot of -0.0 only
            x[rows[2][0]] = float("nan")
            x[rows[3][0]] = float("inf")
            x[rows[4][0]] = float("-inf")
            x[rows[5][:2]] = torch.tensor([float("inf"), float("-inf")],
                                          dtype=torch.float64, device=dev)
            return lanes[:place] + (x,) + lanes[place + 1:]
        for dp in (11, 101):
            for dtypes in (q4, eight):
                run(dp, dtypes, 30_000, edit=specials)
    elif case == "out_of_range":
        for dp in (11, 101):
            n = 30_000
            code = torch.from_numpy(
                rng.integers(0, dp, n).astype(np.int32)).to(dev)
            bad = torch.from_numpy(rng.random(n) < 0.1).to(dev)
            junk = torch.tensor([-5, -1, dp, dp + 7, 2**31 - 1],
                                dtype=torch.int32, device=dev)
            code[bad] = junk[torch.arange(int(bad.sum()), device=dev) % 5]
            for dtypes in (q4, eight):
                run(dp, dtypes, n, code=code)
    elif case == "routes":
        lim = 1
        while K.onehot_route(lim + 1, q4, 1 << 20)["private"]:
            lim += 1
        copies = set()
        for dtypes in (q4, eight):
            # a float64 entry is 8 bytes like an int64 one, so the route is
            # the int64 lane's; a private block that holds its SM alone
            # takes larger tiles
            ints = tuple(torch.int64 if d == torch.float64 else d
                         for d in dtypes)
            for dp in (11, 101, lim, lim + 1, 513):
                route = K.onehot_route(dp, dtypes, 1 << 20)
                same = K.onehot_route(dp, ints, 1 << 20)
                assert route["private"] == same["private"]
                assert route["tile_rows"] >= same["tile_rows"]
                assert route["private"] == (dp <= lim) or dtypes == eight
                if not route["private"]:
                    copies.add(route["copies"])
                run(dp, dtypes, 3 * route["tile_rows"] + 77)
        assert 8 in copies and min(copies) < 8, copies
        assert K.onehot_route(11, q4, 1 << 20)["tile_rows"] == 3072
    elif case == "many_tiles":
        for dtypes in (q4, eight):
            for dp in (11, 101, 513):
                r = K.onehot_route(dp, dtypes, 1 << 26)
                run(dp, dtypes, 4 * r["blocks"] * r["tile_rows"] + 123)
        r = K.onehot_route(11, q4, 1 << 26)
        n = 4 * r["blocks"] * r["tile_rows"] + 77
        base, place = lanes_of(q4, n + 1)
        code = torch.from_numpy(
            rng.integers(0, 11, n + 1).astype(np.int32)).to(dev)
        c, ls = code[1:], tuple(x[1:] for x in base)
        assert ls[place].data_ptr() % 16 == 8
        _f64_check(c, ls, 11, K.onehot_segment_sums(c, ls, 11), place)
    else:
        n = 100_663_296
        for name, (dp, dtypes) in _INT_LANES.items():
            assert tuple(K.onehot_route(dp, dtypes, n).values()) == \
                _INT_ROUTES[name], name
            m = 3 * K.onehot_route(dp, dtypes, 1 << 20)["tile_rows"] + 9
            code = torch.from_numpy(
                rng.integers(0, dp, m).astype(np.int32)).to(dev)
            ls = tuple(torch.from_numpy(
                rng.random(m) < 0.5 if dt == torch.bool
                else rng.integers(-2**62, 2**62, m) if dt == torch.int64
                else rng.integers(-2**31, 2**31 - 1, m).astype(np.int32)
            ).to(dev) for dt in dtypes)
            assert torch.equal(K.onehot_segment_sums(code, ls, dp),
                               K.onehot_segment_sums_plain(code, ls, dp))


_KEY_IDS = [np.dtype(d).name for d in C.KEY_DTYPES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", C.KEY_DTYPES, ids=_KEY_IDS)
@pytest.mark.parametrize("nkeys", [1, 2, 3, 4])
def test_onehot_keyed_form_on_card(nkeys, dtype):
    """The keyed form on the card against its plain version: 1 to 4 keys of
    each integer dtype at both ends of the dtype's range, a row mask,
    int32 lanes near ±2^31 with their products, a bool lane, an int64 or
    a float64 lane, the row count; over three tiles and 77 rows, the
    columns at element offsets 0, 1 and 3 (the keys, the mask and the
    lanes off 16-byte boundaries), garbage past the rows taken. Integer
    columns bit for bit, a float64 lane within 1e-12 normwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(nkeys * 10 + _KEY_IDS.index(
        np.dtype(dtype).name))
    dev = torch.device("cuda")
    for f64 in (False, True):
        lane_dts = (torch.int32, torch.int32, torch.bool,
                    torch.float64 if f64 else torch.int64)
        tile = K.onehot_route(
            int(np.prod(C.KEY_RANGES[nkeys])), lane_dts, 1 << 20,
            keys=(torch.from_numpy(np.zeros(1, dtype)).dtype,) * nkeys,
            row_mask=True, products=C.KEYED_PRODUCTS, counts=True)[
                "tile_rows"]
        n = 3 * tile + 77
        case = C.keyed_case(rng, nkeys, dtype, n + 3, n + 99, f64=f64)
        for off in (0, 1, 3):
            code, lanes, dp, kw = C.keyed_args(case, dev, off)
            got = K.onehot_segment_sums(code, lanes, dp, **kw)
            C.keyed_equal(got, K.onehot_segment_sums_plain(
                code, lanes, dp, **kw), lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["out_of_range", "counts_only", "ragged",
                                  "one_slot", "max_entries", "many_tiles",
                                  "code_form_is_one_int32_key"])
def test_onehot_keyed_edges_on_card(case):
    """The keyed form's edges on the card against its plain version: keys
    outside their ranges dropped; the row count alone; 1, 1,023 and 1,025
    rows; every row in one slot (a float64 lane's warp sums) on both
    routes; dp · k at ONEHOT_MAX_ENTRIES; rows enough that each block of
    the persistent grid walks four tiles and more; and one int32 key of
    minimum 0 and stride 1 equal to the code form's call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(11 + len(case))
    dev = torch.device("cuda")

    def check(c, off=0):
        code, lanes, dp, kw = C.keyed_args(c, dev, off)
        got = K.onehot_segment_sums(code, lanes, dp, **kw)
        C.keyed_equal(got, K.onehot_segment_sums_plain(code, lanes, dp,
                                                       **kw), lanes)
        return got
    if case == "out_of_range":
        for nkeys in (1, 2):
            c = C.keyed_case(rng, nkeys, np.int32, 30_000, 30_000, f64=True)
            bad = rng.random(30_000) < 0.1
            c["keys"][0][bad] = rng.integers(-2**31, 2**31 - 1, int(bad.sum()))
            check(c, 1)
    elif case == "counts_only":
        c = C.keyed_case(rng, 2, np.int64, 50_000, 50_003)
        c["lanes"], c["products"] = [], ()
        check(c, 3)
    elif case == "ragged":
        for n in (1, 1023, 1025):
            for f64 in (False, True):
                check(C.keyed_case(rng, 3, np.int16, n, n + 5, f64=f64))
    elif case == "one_slot":
        for ranges in ((11,), (101,), (513,)):
            c = C.keyed_case(rng, 1, np.int8 if ranges[0] < 200 else np.int16,
                             40_000, 40_000, f64=True, ranges=ranges)
            c["keys"][0][:] = c["mins"][0] + ranges[0] - 1
            check(c)
    elif case == "max_entries":
        dp = K.ONEHOT_MAX_ENTRIES // 2
        c = C.keyed_case(rng, 1, np.int32, 60_000, 60_000, ranges=(dp,))
        c["lanes"], c["products"] = c["lanes"][:1], ()
        check(c, 1)
    elif case == "many_tiles":
        for nkeys, f64 in ((1, True), (2, False), (4, True)):
            dp = int(np.prod(C.KEY_RANGES[nkeys]))
            dts = (torch.int32, torch.int32, torch.bool,
                   torch.float64 if f64 else torch.int64)
            r = K.onehot_route(dp, dts, 1 << 26, keys=(torch.int32,) * nkeys,
                               row_mask=True, products=C.KEYED_PRODUCTS,
                               counts=True)
            n = 4 * r["blocks"] * r["tile_rows"] + 123
            check(C.keyed_case(rng, nkeys, np.int32, n, n + 1, f64=f64), 1)
    else:
        c = C.keyed_case(rng, 1, np.int32, 30_000, 30_000, ranges=(101,),
                         mask=False)
        c["keys"][0] -= np.int32(-2**31)             # min 0, stride 1
        c["mins"], c["products"] = [0], ()
        code, lanes, dp, kw = C.keyed_args(c, dev)
        got = check(c)
        assert torch.equal(got[:, :len(lanes)],
                           K.onehot_segment_sums(code, lanes, dp))


@pytest.mark.gpu
def test_dense_tier_keyed_form_at_g1_shapes_on_card():
    """q1, q2, q4 (v3 a DOUBLE, as the benchmark's G1), q9 and a WHERE on
    G1 at 1e7 rows on the card: each dense query makes one
    onehot_segment_sums call, in the keyed form, reading the stored
    columns (no product, code or validity made), and its output equals
    the plain version's on the same arguments (integer columns exactly,
    the float64 lane within 1e-12 normwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import h2o_g1

    src = h2o_g1(10_000_000, 10, 23)
    src["v3"] = src["v3"].astype(np.float64)
    db = aquery2_tpu_torch.connect()
    db.catalog.create(Table.from_numpy("source", src, device="cuda"))
    cols = {nm: c.data for nm, c in db.catalog.get("source").columns.items()}
    where = ("SELECT id2, id4, sum(v1) AS s, avg(v3) AS a FROM source "
             "WHERE v2 > 7 GROUP BY id2, id4")
    real = K.onehot_segment_sums
    for sql in (QUERIES["q1"], QUERIES["q2"], QUERIES["q4"], QUERIES["q9"],
                where):
        calls = []

        def spy(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)
        K.onehot_segment_sums = spy
        try:
            forms = dict(K.ONEHOT_FORMS)
            db.execute(sql)
        finally:
            K.onehot_segment_sums = real
        assert K.ONEHOT_FORMS["keyed"] - forms["keyed"] == 1, sql
        assert K.ONEHOT_FORMS["code"] == forms["code"], sql
        (code, lanes, dp), kw = calls[0]
        stored = {c.data_ptr() for c in cols.values()}
        for x in (code, *lanes, *kw["keys"]):
            assert x.data_ptr() in stored and x.numel() == 10_000_000, sql
        got = real(code, lanes, dp, **kw)
        C.keyed_equal(got, K.onehot_segment_sums_plain(code, lanes, dp, **kw),
                      lanes)


@pytest.mark.gpu
def test_dense_q4_sums_its_double_in_the_kernel_on_card():
    """G1's q4 (avg of v1, v2 and a DOUBLE v3 by id4) on the card at 2e5
    rows: one onehot_segment_sums launch with one float64 lane, and the
    averages equal to the CPU session's (v1, v2 exactly; v3 within 1e-12,
    its float64 adds in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import h2o_g1

    src = h2o_g1(200_000, 10, 5)
    src["v3"] = src["v3"].astype(np.float64)
    got = {}
    for dev in ("cpu", "cuda"):
        db = aquery2_tpu_torch.connect(device=dev)
        db.catalog.create(Table.from_numpy("source", src, device=dev))
        launches = K.LAUNCHES["onehot_segment_sums"]
        f64 = K.ONEHOT_LANES["float64"]
        got[dev] = db.execute(QUERIES["q4"]).table.columns
        if dev == "cuda":
            assert K.LAUNCHES["onehot_segment_sums"] - launches == 1
            assert K.ONEHOT_LANES["float64"] - f64 == 1
    for nm, col in got["cpu"].items():
        want, have = col.to_numpy(), got["cuda"][nm].to_numpy()
        if nm == "v3":
            np.testing.assert_allclose(have, want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(have, want, err_msg=nm)


@pytest.mark.gpu
def test_joins_match_numpy_on_card():
    """h2o qj and qjg through connect() on the card at 2e5 rows against
    numpy: the count, and per w (ascending) the count and int64 sum of v1
    over the matched rows, exactly; qjg's group-by launches
    onehot_segment_sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import h2o_dim, h2o_g1

    n = 200_000
    src, dim = h2o_g1(n, 10, 3), h2o_dim(n, 10, 3)
    db = aquery2_tpu_torch.connect()
    db.catalog.create(Table.from_numpy("source", src, device="cuda"))
    db.catalog.create(Table.from_numpy("dim", dim, device="cuda"))
    lut = np.zeros(n // 10 + 2, np.int64)
    lut[dim["id3"]] = dim["w"]
    w = lut[src["id3"]]
    hit = w > 0
    assert db.execute(QUERIES["qj"]).scalar() == int(hit.sum())
    before = K.LAUNCHES["onehot_segment_sums"]
    r = db.execute(QUERIES["qjg"])
    assert K.LAUNCHES["onehot_segment_sums"] > before
    ws, inv = np.unique(w[hit], return_inverse=True)
    assert r.column_names() == ["w", "c", "sv"]
    cols = r.table.columns
    np.testing.assert_array_equal(cols["w"].to_numpy(), ws)
    np.testing.assert_array_equal(cols["c"].to_numpy(), np.bincount(inv))
    np.testing.assert_array_equal(
        cols["sv"].to_numpy(),
        np.bincount(inv, weights=src["v1"][hit]).astype(np.int64))


@pytest.mark.gpu
def test_general_engine_matches_numpy_on_card():
    """The general engine through connect() on the card at 2e5 trades rows
    against numpy: best_profit under ASSUMING DESC (seg_scan_multi), a
    windowed average (seg_cumsum_i64), per-symbol first/last/last(mins)
    (seg_scan_multi with flags), a fused top-k scan and a DELETE."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch import types as T
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import trades

    n = 200_000
    a, d = trades(n, 20, 5)
    db = aquery2_tpu_torch.connect()
    db.catalog.create(Table.from_numpy("t", a, {"stocksymbol": T.StrT},
                                       device="cuda",
                                       dictionaries={"stocksymbol": d}))
    sym, t, p = a["stocksymbol"], a["time"], a["price"].astype(np.int64)
    before = dict(K.LAUNCHES)
    r = db.execute("SELECT max(price - mins(price)) FROM t "
                   "ASSUMING DESC time")
    rp = p[np.argsort(-t.astype(np.int64), kind="stable")]
    assert r.scalar() == (rp - np.minimum.accumulate(rp)).max()
    assert K.LAUNCHES["seg_scan_multi"] > before["seg_scan_multi"]
    r = db.execute("SELECT avgs(3, price) AS m FROM t ASSUMING ASC time")
    c = np.cumsum(p)
    pos = np.arange(n)
    w = np.where(pos >= 3, c - np.r_[np.zeros(3, np.int64), c[:-3]], c)
    np.testing.assert_allclose(r.table["m"].to_numpy(),
                               w / np.minimum(pos + 1, 3), rtol=1e-12)
    assert K.LAUNCHES["seg_cumsum_i64"] > before["seg_cumsum_i64"]
    r = db.execute("SELECT stocksymbol, first(price) AS f, last(price) AS l, "
                   "last(mins(price)) AS lm FROM t ASSUMING ASC time "
                   "GROUP BY stocksymbol")
    syms, first = np.unique(sym, return_index=True)
    last = n - 1 - np.unique(sym[::-1], return_index=True)[1]
    np.testing.assert_array_equal(r.table["f"].to_numpy(), p[first])
    np.testing.assert_array_equal(r.table["l"].to_numpy(), p[last])
    np.testing.assert_array_equal(
        r.table["lm"].to_numpy(),
        [p[sym == s].min() for s in syms])
    r = db.execute("SELECT time, price FROM t WHERE quantity > 50 "
                   "ORDER BY price DESC, time LIMIT 50")
    idx = np.flatnonzero(a["quantity"] > 50)
    idx = idx[np.lexsort((t[idx], -p[idx]))[:50]]
    np.testing.assert_array_equal(r.table["time"].to_numpy(), t[idx])
    db.execute("DELETE FROM t WHERE price > 250")
    assert db.execute("SELECT count(*) FROM t").scalar() == int((p <= 250)
                                                                .sum())


@pytest.mark.gpu
def test_joins_and_set_operations_match_numpy_on_card():
    """db-benchmark's join q2 and q3 (J1 at 2e5 rows) by their row count
    and sums, an EXCEPT ALL and an INTERSECT, count(DISTINCT …) per group
    (seg_cumsum_i64) and a NaN float sum (the general engine) through
    connect() on the card, against numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch import types as T
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import h2o_j1

    tables = h2o_j1(200_000, 5)
    db = aquery2_tpu_torch.connect()
    for name, (arrays, dicts) in tables.items():
        db.catalog.create(Table.from_numpy(
            name, arrays, {c: T.StrT for c in dicts}, dictionaries=dicts,
            device="cuda"))
    x, med = tables["x"][0], tables["medium"][0]
    pos = {k: i for i, k in enumerate(med["id2"].tolist())}
    hit = np.array([k in pos for k in x["id2"].tolist()])
    v2 = np.array([med["v2"][pos[k]] for k in x["id2"][hit].tolist()])
    for kind, rows, s2 in (("", hit.sum(), v2.sum()),
                           ("LEFT", len(hit), v2.sum())):
        r = db.execute(f"SELECT count(*), sum(v1), sum(v2) FROM x {kind} "
                       f"JOIN medium USING (id2)").rows()[0]
        assert r[0] == rows
        np.testing.assert_allclose(r[1:], [x["v1"][hit].sum()
                                           if not kind else x["v1"].sum(),
                                           s2], rtol=1e-9)
    got = db.execute("SELECT id2 FROM x EXCEPT ALL SELECT id2 FROM medium")
    keep = np.ones(len(x["id2"]), bool)
    for k in med["id2"].tolist():           # medium's id2 are unique
        first = np.flatnonzero(x["id2"] == k)[:1]
        keep[first] = False
    np.testing.assert_array_equal(got.table["id2"].to_numpy(),
                                  x["id2"][keep])
    got = db.execute("SELECT id1 FROM x INTERSECT SELECT id1 FROM small")
    _u, first = np.unique(x["id1"], return_index=True)
    want = x["id1"][np.sort(first)]
    np.testing.assert_array_equal(got.table["id1"].to_numpy(),
                                  want[np.isin(want, tables["small"][0]["id1"])])
    before = K.LAUNCHES["seg_cumsum_i64"]
    r = db.execute("SELECT id1, count(DISTINCT id2) AS c FROM x GROUP BY id1")
    assert K.LAUNCHES["seg_cumsum_i64"] > before
    keys = np.unique(x["id1"])
    np.testing.assert_array_equal(r.table["c"].to_numpy(),
                                  [len(np.unique(x["id2"][x["id1"] == k]))
                                   for k in keys])
    v = np.ones(1000, np.float32)
    v[7] = np.nan
    db.catalog.create(Table.from_numpy(
        "f", {"g": np.arange(1000, dtype=np.int32) % 3, "v": v},
        device="cuda"))
    got = db.execute("SELECT g, sum(v) AS s FROM f GROUP BY g")
    np.testing.assert_array_equal(got.table["s"].to_numpy(),
                                  [334.0, np.nan, 333.0])


@pytest.mark.gpu
def test_windows_and_functions_match_numpy_on_card():
    """OVER windows and FUNCTIONs through connect() on the card at 2e5
    trades rows against numpy: row_number and lag (seg_scan_multi),
    dense_rank (seg_cumsum_i64), a 5-row moving avg (one three-lane
    seg_scan_multi), max over +-2 rows, and udfcov rewritten into the
    dense tier (onehot_segment_sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch import types as T
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import trades

    n = 200_000
    a, d = trades(n, 20, 5)
    db = aquery2_tpu_torch.connect()
    db.catalog.create(Table.from_numpy("t", a, {"stocksymbol": T.StrT},
                                       device="cuda",
                                       dictionaries={"stocksymbol": d}))
    sym, t = a["stocksymbol"], a["time"]
    order = np.lexsort((t, sym))
    ps, ts = a["price"][order].astype(np.int64), t[order]
    idx = np.arange(n)
    part = np.r_[True, sym[order][1:] != sym[order][:-1]]
    start = np.maximum.accumulate(np.where(part, idx, 0))
    pos = idx - start
    peer = part | np.r_[True, ts[1:] != ts[:-1]]
    c = np.cumsum(peer)
    run = np.cumsum(ps)
    run = run - run[start] + ps[start]
    behind = np.where(pos >= 5, run[np.maximum(idx - 5, 0)], 0)
    last = np.r_[np.flatnonzero(part)[1:], n] - 1
    last = last[np.cumsum(part) - 1]
    mx = ps.copy()
    for s in (1, 2):
        mx = np.maximum(mx, np.where(idx + s <= last,
                                     ps[np.minimum(idx + s, n - 1)], mx))
        mx = np.maximum(mx, np.where(idx - s >= start, ps[idx - s], mx))
    want = {"rn": pos + 1, "dr": c - c[start] + 1,
            "lg": np.where(pos > 0, ps[idx - 1], 0),
            "a": (run - behind) / np.minimum(pos + 1, 5), "mx": mx}
    over = "OVER (PARTITION BY stocksymbol ORDER BY time"
    before = dict(K.LAUNCHES)
    r = db.execute(f"SELECT row_number() {over}) AS rn, dense_rank() "
                   f"{over}) AS dr, lag(price) {over}) AS lg, avg(price) "
                   f"{over} ROWS BETWEEN 4 PRECEDING AND CURRENT ROW) AS a, "
                   f"max(price) {over} ROWS BETWEEN 2 PRECEDING AND 2 "
                   f"FOLLOWING) AS mx FROM t")
    for k in ("seg_scan_multi", "seg_cumsum_i64"):
        assert K.LAUNCHES[k] > before[k], k
    for nm, w in want.items():
        got = r.table[nm].to_numpy()[order]
        if nm == "a":
            np.testing.assert_allclose(got, w, rtol=1e-12)
        else:
            if nm == "lg":
                valid = r.table[nm].valid[:n].cpu().numpy()[order]
                np.testing.assert_array_equal(valid, pos > 0)
                got = np.where(valid, got, 0)
            np.testing.assert_array_equal(got, w, err_msg=nm)
    db.execute("AGGREGATION FUNCTION udfcov(x, y){ sx := 0.; sy := 0.; "
               "sxy := 0.; l := _builtin_len; for (i := 0; i < l; i += 1) "
               "{ sx += x[i]; sy += y[i]; sxy += x[i]*y[i]; } "
               "(sxy - sx * sy / l) / l }")
    before = K.LAUNCHES["onehot_segment_sums"]
    r = db.execute("SELECT stocksymbol, udfcov(price, quantity) AS c FROM t "
                   "GROUP BY stocksymbol")
    assert K.LAUNCHES["onehot_segment_sums"] > before
    x, y = a["price"].astype(np.int64), a["quantity"].astype(np.int64)
    cov = []
    for s in np.unique(sym):
        m = sym == s
        sx, sy, sxy, k = x[m].sum(), y[m].sum(), (x[m] * y[m]).sum(), m.sum()
        cov.append((sxy - sx * sy / k) / k)
    np.testing.assert_allclose(r.table["c"].to_numpy(), cov, rtol=1e-12)


@pytest.mark.gpu
def test_function_bodies_and_csv_match_numpy_on_card(tmp_path):
    """AGGREGATION FUNCTION bodies on the card at 2e5 trades rows against
    numpy: clipsum (an if inside a for) and a running sum into
    _builtin_ret, both through the general pipeline over 2e4 groups of
    several length classes, then the table through CSV LOAD and INTO
    OUTFILE."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch import types as T
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import trades

    n = 200_000
    a, d = trades(n, 20, 5)
    db = aquery2_tpu_torch.connect(base_dir=str(tmp_path))
    db.catalog.create(Table.from_numpy("t", a, {"stocksymbol": T.StrT},
                                       device="cuda",
                                       dictionaries={"stocksymbol": d}))
    db.execute("AGGREGATION FUNCTION clipsum(x, c){ s := 0.; "
               "l := _builtin_len; for (i := 0; i < l; i += 1) { "
               "if (x[i] > c) { s += c; } else { s += x[i]; } } s }")
    db.execute("AGGREGATION FUNCTION runsum(x){ s := 0.; for (i := 0; "
               "i < _builtin_len; i += 1) { s += x[i]; _builtin_ret[i] "
               ":= s; } Null }")
    sym, price = a["stocksymbol"], a["price"].astype(np.float64)
    r = db.execute("SELECT time, clipsum(price, 250) AS s FROM t "
                   "GROUP BY time")
    keys, inv = np.unique(a["time"], return_inverse=True)
    np.testing.assert_array_equal(r.table["time"].to_numpy(), keys)
    np.testing.assert_allclose(r.table["s"].to_numpy(), np.bincount(
        inv, weights=np.minimum(price, 250)), rtol=1e-12)
    r = db.execute("SELECT time, runsum(price) AS r FROM t GROUP BY time "
                   "ORDER BY time")
    order = np.argsort(inv, kind="stable")
    starts = np.r_[0, np.cumsum(np.bincount(inv))[:-1]]
    run = np.cumsum(price[order])
    want = run - np.repeat(run[starts] - price[order][starts],
                           np.bincount(inv))
    np.testing.assert_allclose(r.table["r"].to_numpy(), want, rtol=1e-12)
    assert db.stats.udf_paths == {"traced": 2}
    (tmp_path / "t.csv").write_text("stocksymbol,time,quantity,price\n" + "".join(
        f"{d.strings()[s]},{t},{q},{p}\n" for s, t, q, p in zip(
            sym, a["time"], a["quantity"], a["price"])))
    db.execute("CREATE TABLE c(stocksymbol VARCHAR(8), time INT, "
               "quantity INT, price INT)")
    db.execute('LOAD DATA INFILE "t.csv" INTO TABLE c')
    db.execute('SELECT stocksymbol, sum(quantity) FROM c GROUP BY '
               'stocksymbol INTO OUTFILE "o.csv"')
    back = np.loadtxt(tmp_path / "o.csv", delimiter=",", comments=None,
                      dtype=[("s", object), ("q", np.int64)], ndmin=1)
    qty = np.bincount(sym, weights=a["quantity"]).astype(np.int64)
    assert {str(s): int(q) for s, q in back} == {
        d.strings()[i]: int(qty[i]) for i in np.unique(sym)}


@pytest.mark.gpu
def test_services_match_numpy_on_card(tmp_path):
    """Procedures and a conditional and an interval trigger running h2o q1
    and q7 on the card from the trigger threads (onehot_segment_sums,
    seg_scan_multi), a LOAD DATA INFILE on the native scanner, and LOAD
    MODULE of a Python module, each against numpy; no trigger logs an
    error and close() leaves no trigger thread alive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from aquery2_tpu_torch.storage import csvio
    from aquery2_tpu_torch.storage.table import Table
    from aquery2_tpu_torch.utils.datagen import h2o_g1

    data = h2o_g1(200_000, 10, 11)
    db = aquery2_tpu_torch.connect(base_dir=str(tmp_path))
    errors = []
    db.log_error = errors.append
    db.catalog.create(Table.from_numpy("x", data, device="cuda"))
    db.execute("CREATE TABLE stream(id1 INT, id2 INT, id3 INT, id4 INT, "
               "id5 INT, id6 INT, v1 INT, v2 INT, v3 REAL)")
    ps = db.procedures
    ps.start_recording("s_q1")
    db.execute("DROP TABLE IF EXISTS s1; CREATE TABLE s1 AS SELECT id1, "
               "sum(v1) AS v1 FROM stream GROUP BY id1")
    ps.stop_recording()
    ps.start_recording("s_q7")
    db.execute("DROP TABLE IF EXISTS s7; CREATE TABLE s7 AS SELECT id3, "
               "max(v1) - min(v2) AS r FROM stream GROUP BY id3")
    ps.stop_recording()
    db.execute("CREATE TRIGGER t1 ON stream ACTION s_q1")
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    seen = np.zeros(len(data["v1"]), bool)
    for b in (1, 2):
        db.execute(f"INSERT INTO stream SELECT * FROM x WHERE id4 = {b}")
        assert db.triggers.drain(60)
        seen |= data["id4"] == b
        got = db.execute("SELECT id1, v1 FROM s1 ORDER BY id1").rows()
        want = np.bincount(data["id1"][seen], data["v1"][seen],
                           minlength=11).astype(np.int64)
        assert got == [(k, int(want[k])) for k in np.unique(
            data["id1"][seen])]
    assert K.LAUNCHES["onehot_segment_sums"] == 2
    (tmp_path / "b.csv").write_text("id1,id2,id3,id4,id5,id6,v1,v2,v3\n" +
                                    "".join(f"{i % 10 + 1},1,1,3,1,1,{i},"
                                            f"1,0.5\n" for i in range(100)))
    assert csvio.route(db.catalog.get("stream")) == "native"
    db.execute('LOAD DATA INFILE "b.csv" INTO TABLE stream')
    assert db.triggers.drain(60)
    extra = np.bincount(np.arange(100) % 10 + 1, np.arange(100),
                        minlength=11)
    want = (np.bincount(data["id1"][seen], data["v1"][seen], minlength=11)
            + extra).astype(np.int64)
    assert db.execute("SELECT id1, v1 FROM s1 ORDER BY id1").rows() == \
        [(k, int(want[k])) for k in range(1, 11)]
    db.execute("DROP TRIGGER t1")
    K.LAUNCHES["seg_scan_multi"] = 0
    db.execute("CREATE TRIGGER t7 ACTION s_q7 INTERVAL 100")
    deadline = time.monotonic() + 10
    while K.LAUNCHES["seg_scan_multi"] < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    db.execute("DROP TRIGGER t7")
    time.sleep(0.3)
    assert K.LAUNCHES["seg_scan_multi"] >= 2
    t = db.catalog.get("stream")
    id3 = t.columns["id3"].to_numpy()
    v1, v2 = t.columns["v1"].to_numpy(), t.columns["v2"].to_numpy()
    keys = np.unique(id3)
    mx = np.full(keys.max() + 1, np.iinfo(np.int64).min)
    mn = np.full(keys.max() + 1, np.iinfo(np.int64).max)
    np.maximum.at(mx, id3, v1)
    np.minimum.at(mn, id3, v2)
    assert db.execute("SELECT id3, r FROM s7 ORDER BY id3").rows() == \
        [(int(k), int(mx[k] - mn[k])) for k in keys]
    (tmp_path / "m.py").write_text("def twice(x):\n    return x * 2\n")
    db.execute('LOAD MODULE FROM "m.py" FUNCTIONS (twice(x:vecint) -> vecint)')
    r = db.execute("SELECT twice(v1) AS w FROM stream")
    assert r.table["w"].device.type == "cuda"
    np.testing.assert_array_equal(r.table["w"].to_numpy(), v1 * 2)
    threads = db.triggers.threads()
    db.close()
    assert errors == [] and not any(th.is_alive() for th in threads)


_SORT_ROWS = [0, 1, 3, 1_000_007]


@pytest.mark.gpu
@pytest.mark.parametrize("n", _SORT_ROWS)
def test_lexsort_matches_torch_sort_on_card(n):
    """lexsort through radix_sort_pairs gives torch.sort(stable=True)'s
    permutation, element for element, and its sorted keys: one bounded key
    of 1, 9, 25, 31, 32, 37, 61 and 63 bits (each route, 32-bit and
    64-bit keys), a validity bit above it, float64 keys with -0.0, NaN
    and ±inf each way, int64 keys without bounds, all-equal keys (the
    order stable), and a chain of three packs; radix_sort_pairs on int32
    words with their high bits set and on int64 values against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.ops import sort as S

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n + 5)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int64)

    def check(keys, order):
        perm, sk = S.lexsort(keys)
        want = torch.sort(order, stable=True).indices
        assert perm.dtype == torch.int64 and torch.equal(perm, want)
        for k, s in zip(keys, sk):               # floats bit for bit
            t = k[0][want]
            assert torch.equal(*(x.view(torch.int64) for x in (s, t))
                               if t.is_floating_point() else (s, t))

    for bits in (1, 9, 25, 31, 32, 37, 61, 63):
        hi = (1 << bits) - 1
        x = ints(0, hi) if bits < 63 else ints(-(1 << 62), 1 << 62) + (
            1 << 62)
        x[: min(n, 3)] = hi
        check([(x, True, (0, hi))], x)
        check([(x, False, (0, hi))], hi - x)
        if bits < 63:
            b = ints(0, 2) == 0
            check([(b, True), (x, True, (0, hi))], b.long() << bits | x)
    sample = torch.tensor([-0.0, 0.0, float("nan"), float("inf"),
                           -float("inf"), 1.5, -2.5], device=dev,
                          dtype=torch.float64)
    f = sample[ints(0, len(sample))]
    check([(f, True)], S.canonical_float(f))
    check([(f, False)], S.canonical_float(-f))
    w = ints(-2**62, 2**62) * 2 + ints(0, 2)
    check([(w, True)], w)
    check([(w, False)], ~w)
    same = torch.full((n,), 7, dtype=torch.int32, device=dev)
    check([(same, True, (0, 9))], same)
    assert torch.equal(S.lexsort([(same, True)])[0],
                       torch.arange(n, device=dev))
    c = (ints(0, 2) == 0, (ints(0, 1 << 20) << 20 | ints(0, 1 << 20)),
         ints(0, 300).to(torch.int32))
    perm, _sk = S.lexsort([(c[0], False), (c[1], True, (0, (1 << 40) - 1)),
                           (f, True), (c[2], False, (0, 299))])
    want = torch.arange(n, device=dev)
    for order in (-c[2].long(), S.canonical_float(f), c[1], (~c[0]).long()):
        want = want[torch.sort(order[want], stable=True).indices]
    assert torch.equal(perm, want)
    k32 = ints(-2**31, 2**31).to(torch.int32)
    for end in (7, 32):
        for vals in (torch.arange(n, device=dev, dtype=torch.int32),
                     ints(-2**40, 2**40)):
            got = K.radix_sort_pairs(k32.clone(), vals.clone(), end)
            want = K.radix_sort_pairs_plain(k32, vals, end)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_lexsort_counts_its_packs_on_card():
    """Each pack a CUDA lexsort sorts counts once in LAUNCHES and in
    SORT_PACKS by its route, with ceil(end bit / 8) digit passes; a
    float64 key of one row runs its order-bits pass alone (one launch, no
    digit pass), and an int key of one row, or any key of none, launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aquery2_tpu_torch.ops import sort as S

    dev = torch.device("cuda")
    n = 1000
    keys = [(torch.arange(n, device=dev) % 2 == 0, True),
            (torch.arange(n, device=dev, dtype=torch.int32) % 37, True,
             (0, 36)),
            (torch.arange(n, device=dev, dtype=torch.float64).sin(), False),
            (torch.arange(n, device=dev) * 3, True, (0, 1 << 40))]
    packs = S.plan(keys)[1]
    assert [(r, e) for _, r, e in packs] == [("u32", 7), ("f64", 64),
                                            ("u64", 41)]
    launches, packs0 = K.LAUNCHES["radix_sort_pairs"], dict(K.SORT_PACKS)
    S.lexsort(keys)
    assert K.LAUNCHES["radix_sort_pairs"] - launches == 3
    assert {k: K.SORT_PACKS[k] - packs0[k] for k in K.SORT_PACKS} == {
        "u32": 1, "u64": 1, "f64": 1, "passes": 1 + 8 + 6}
    for m, launched in ((1, 1), (0, 0)):
        launches, packs0 = K.LAUNCHES["radix_sort_pairs"], dict(K.SORT_PACKS)
        one = [(k[0][:m], *k[1:]) for k in keys]
        perm, sk = S.lexsort(one)
        assert torch.equal(perm, torch.arange(m, device=dev))
        assert torch.equal(sk[2], keys[2][0][:m])
        assert K.LAUNCHES["radix_sort_pairs"] - launches == launched
        assert {k: K.SORT_PACKS[k] - packs0[k] for k in K.SORT_PACKS} == {
            "u32": 0, "u64": 0, "f64": launched, "passes": 0}
