"""Float sums over NaN, ±inf and large finite values in the fused tiers.

The dense, packed and multikey tiers, the star join (which runs the fused
group-by) and the ordered group-by sum a float32 argument in two integer
limbs and, in the sort tiers, a float64 one as differences of one running
total: exact for finite values of moderate size, wrong for NaN, ±inf and
float32 values of 2^49 or more. Their planners decline such arguments
(``fused_groupby.float_sums_fit``) and the general engine answers. Each
tier's query is held to numpy here: NaN where a group holds a NaN or both
infinities, ±inf where it holds one, the large finite sums to 1e-12. (The
JAX package raises on a NaN column, ROADMAP queue 3, so numpy is the
reference; its finite answers stay equal to the port's bit for bit,
tests/test_torch_slice.py.)"""

import numpy as np
import pytest

import aquery2_tpu_torch
from aquery2_tpu_torch.engine import fused_groupby as TF
from aquery2_tpu_torch.storage.table import Table as TTable

N = 4000
RTOL = 1e-12

AGGS = ("sum(x) AS s, avg(x) AS a, var(x) AS v, stddev(x) AS sd, "
        "sum(w) AS sw, count(*) AS c")
TIERS = {
    "dense": f"SELECT g AS k, {AGGS} FROM t GROUP BY g",
    "packed": f"SELECT h AS k, {AGGS} FROM t GROUP BY h",
    "multikey": f"SELECT g * 10000 + h AS k, {AGGS} FROM t "
                f"GROUP BY g * 10000 + h",
    "star": "SELECT d.q AS k, sum(t.x) AS s, avg(t.x) AS a, var(t.x) AS v, "
            "stddev(t.x) AS sd, sum(d.f) AS sw, count(*) AS c FROM t, d "
            "WHERE t.h = d.h GROUP BY d.q",
    "ordered": "SELECT g AS k, sum(x) AS s, avg(x) AS a, var(x) AS v, "
               "stddev(x) AS sd, sum(w) AS sw, count(*) AS c FROM t "
               "ASSUMING ASC o GROUP BY g",
}


def _tables(kind: str):
    """t (g in [1, 10], h in [1, 1500], float32 x, float64 w, order o) and
    the star join's d (unique h, a group q, float64 f), with the values of
    kind planted in chosen groups."""
    rng = np.random.default_rng(21)
    g = rng.integers(1, 11, N).astype(np.int32)
    h = rng.integers(1, 1501, N).astype(np.int32)
    x = np.round(rng.random(N) * 100, 3).astype(np.float32)
    w = np.round(rng.normal(size=N) * 10, 3)
    o = rng.permutation(N).astype(np.int32)
    dh = np.arange(1, 1501, dtype=np.int32)
    q = (dh % 7).astype(np.int32)
    f = np.round(rng.random(1500) * 5, 2)
    if kind == "nan":
        x[np.flatnonzero(g == 3)[:1]] = np.nan
        w[np.flatnonzero(g == 5)[:2]] = np.nan
        f[4] = np.nan
    elif kind == "inf":
        x[np.flatnonzero(g == 2)[:3]] = np.inf
        x[np.flatnonzero(g == 4)[:3]] = -np.inf
        x[np.flatnonzero(g == 6)[:1]] = np.inf
        x[np.flatnonzero(g == 6)[1:2]] = -np.inf
        w[np.flatnonzero(g == 7)[:1]] = np.inf
        w[0] = -np.inf
        f[9] = np.inf
    else:                   # finite, but past the limbs' range
        x[np.flatnonzero(g == 8)[:2]] = np.float32(3e20)
        x[np.flatnonzero(g == 1)[:1]] = np.float32(-2.0 ** 50)
    return ({"g": g, "h": h, "x": x, "w": w, "o": o},
            {"h": dh, "q": q, "f": f})


def _oracle(tier, t, d):
    """{key: [s, a, v, sd, sw, c]} in float64, var dividing by c + 1 (the
    reference's rule, config.STRICT_REFERENCE_SEMANTICS)."""
    x = t["x"].astype(np.float64)
    w = t["w"]
    if tier == "star":
        pos = t["h"] - 1                       # d.h is 1..1500, all present
        key, w = d["q"][pos], d["f"][pos]
    elif tier == "packed":
        key = t["h"]
    elif tier == "multikey":
        key = t["g"].astype(np.int64) * 10000 + t["h"]
    else:
        key = t["g"]
    out = {}
    with np.errstate(invalid="ignore"):
        for k in np.unique(key):
            m = key == k
            c = int(m.sum())
            s = x[m].sum()
            v = ((x[m] * x[m]).sum() - s * s / (c + 1)) / (c + 1)
            out[int(k)] = [s, s / c, v, np.sqrt(np.maximum(v, 0.0)),
                           w[m].sum(), c]
    return out


@pytest.mark.parametrize("kind", ["nan", "inf", "big"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_float_sums_match_numpy(tier, kind, monkeypatch):
    t, d = _tables(kind)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_numpy("t", t, device="cpu"))
    ts.catalog.create(TTable.from_numpy("d", d, device="cpu"))
    fits = []
    gate = TF.float_sums_fit
    monkeypatch.setattr(TF, "float_sums_fit",
                        lambda *a, **k: fits.append(gate(*a, **k)) or
                        fits[-1])
    r = ts.execute(TIERS[tier])
    assert fits and not fits[-1], "the fused tier must decline"
    want = _oracle(tier, t, d)
    cols = r.table.columns
    keys = cols["k"].to_numpy().tolist()
    assert keys == sorted(want)
    got = np.stack([cols[c].to_numpy().astype(np.float64)
                    for c in ("s", "a", "v", "sd", "sw", "c")], axis=1)
    exp = np.array([want[k] for k in keys], np.float64)
    np.testing.assert_allclose(got, exp, rtol=RTOL, equal_nan=True)
    if kind != "big":
        assert np.isnan(got).any() or np.isinf(got).any()


def test_float_sums_of_a_computed_argument_match_numpy():
    """sum(g / z) with z = 0: a NaN (0 / 0) or ±inf in each group; the
    gate reads all computed arguments in one sync."""
    ts = aquery2_tpu_torch.connect(device="cpu")
    g = np.array([1, 1, 2, 2, 3, 0, 0], np.int32)
    z = np.zeros(7, np.int32)
    s = np.array([1, -1, 1, 1, -1, 0, 1], np.int32)
    ts.catalog.create(TTable.from_numpy("t", {"g": g, "z": z, "s": s},
                                        device="cpu"))
    r = ts.execute("SELECT g, sum(s / z) AS q FROM t GROUP BY g").rows()
    with np.errstate(divide="ignore", invalid="ignore"):
        v = s.astype(np.float32) / z.astype(np.float32)
    want = [(k, float(v[g == k].astype(np.float64).sum()))
            for k in np.unique(g)]
    assert [k for k, _ in r] == [k for k, _ in want]
    np.testing.assert_array_equal([q for _, q in r], [q for _, q in want])


def test_finite_sums_stay_fused_and_read_a_cached_summary(monkeypatch):
    """Finite float columns pass the gate, each column's summary is read
    once and kept (no host sync on a second run)."""
    t, _d = _tables("big")
    t["x"] = np.round(t["x"].clip(0, 100), 3)
    ts = aquery2_tpu_torch.connect(device="cpu")
    ts.catalog.create(TTable.from_numpy("t", t, device="cpu"))
    col = ts.catalog.get("t").columns["x"]
    assert col._fsum is None
    fits = []
    gate = TF.float_sums_fit
    monkeypatch.setattr(TF, "float_sums_fit",
                        lambda *a, **k: fits.append(gate(*a, **k)) or
                        fits[-1])
    ts.execute(TIERS["packed"])
    summary = col._fsum
    assert summary == (True, float(t["x"].max()))
    ts.execute(TIERS["dense"])
    assert col._fsum is summary and fits == [True, True]
