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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 3 * 4096 * 5 + 123])
def test_kernels_match_plain_on_card(n):
    """One row, one row past a tile, and a ragged last tile: the four
    kernels against their plain versions, seg_scan_multi with 32-bit and
    64-bit lanes (float32 running sums against a float64 cumsum, within
    1e-5 of the running sum of |x|; everything else exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    dev = torch.device("cuda")
    flags = torch.from_numpy(rng.random(n) < 0.01).to(dev)
    x64 = torch.from_numpy(rng.integers(-2**62, 2**62, n)).to(dev)
    x64[0] = 2**63 - 1                         # wraps on the next add
    for f in (None, flags):
        assert torch.equal(K.seg_cumsum_i64(f, x64),
                           K.seg_cumsum_i64_plain(f, x64))
    xi = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32)).to(dev)
    xf = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    xf[::977] = float("nan")
    ops = ("add", "min", "max", "min")
    xs = (xi, xf, xf, xi)
    for f in (None, flags):
        got = K.seg_scan_multi(f, xs, ops)
        want = K.seg_scan_multi_plain(f, xs, ops)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan())
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    # 64-bit lanes: int64 add (wraps), min, max; float64 min/max with NaN
    # and an integer-valued float64 add (exact in any order)
    xd = xf.double() * 2.0 ** 40
    xa = torch.from_numpy(rng.integers(-2**20, 2**20, n).astype(np.float64)
                          ).to(dev)
    for xs, ops in (((x64, x64, x64, xa), ("add", "min", "max", "add")),
                    ((xd, xd, x64), ("min", "max", "max"))):
        for f in (None, flags):
            got = K.seg_scan_multi(f, xs, ops)
            want = K.seg_scan_multi_plain(f, xs, ops)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(g.isnan(), w.isnan())
                assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    lanes = (x64, xi, flags, xi.to(torch.int64) * x64)
    for dp in (1, 11, 513):
        code = torch.from_numpy(rng.integers(0, dp, n).astype(np.int32)).to(dev)
        assert torch.equal(K.onehot_segment_sums(code, lanes, dp),
                           K.onehot_segment_sums_plain(code, lanes, dp))
    xr = torch.nan_to_num(xf)               # NaN-free sums; NaN min/max
    got = K.fused_running_stats(xr)
    exact = torch.cumsum(xr.double(), 0)
    scale = torch.cumsum(xr.double().abs(), 0)
    assert bool(((got[0].double() - exact).abs() <= 1e-5 * scale).all())
    got = K.fused_running_stats(xf)
    want = K.fused_running_stats_plain(xf)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
