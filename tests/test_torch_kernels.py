"""The port's four kernels against the JAX package's Pallas kernels
(interpret mode, as tests/test_pallas.py runs them on the CPU) and against
numpy oracles: seg_cumsum_i64, seg_scan_multi, onehot_segment_sums (held
against reduce._pallas_onehot_reduce, the kernel with its caller) and
fused_running_stats with best_profit.

On the CPU the port's wrappers run their plain PyTorch versions. Results
are exact, except float32 running sums (rtol 2e-5, test_pallas.py's
tolerance: the scans add in another order than the row loop)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aquery2_tpu.ops import pallas_kernels as PK
from aquery2_tpu.ops import reduce as JR
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import scan as S
import torch_onehot_cases as C

_MASK64 = (1 << 64) - 1


def _seg_oracle(x, flags, op):
    """Inclusive segmented scan, one row at a time (flags[i] restarts)."""
    out = np.empty(len(x), x.dtype)
    acc = None
    for i in range(len(x)):
        acc = x[i] if (flags is not None and flags[i]) or acc is None \
            else op(acc, x[i])
        out[i] = acc
    return out


def _seg_oracle_i64(x, flags):
    """Segmented int64 sum with Python ints, wrapping mod 2^64."""
    out = np.empty(len(x), np.int64)
    acc = 0
    for i, v in enumerate(x.tolist()):
        acc = v if (flags is not None and flags[i]) or i == 0 \
            else (acc + v) & _MASK64
        acc &= _MASK64
        out[i] = acc - (1 << 64) if acc >= 1 << 63 else acc
    return out


def _pallas_i64(flags, v):
    hi, lo = PK.split_i64_limbs(jnp.asarray(v))
    shi, slo = PK.seg_cumsum_i64(None if flags is None else jnp.asarray(flags),
                                 hi, lo, interpret=True, block_rows=64)
    return np.asarray(PK.join_i64_limbs(shi, slo))


def _port_i64(flags, v):
    f = None if flags is None else torch.from_numpy(flags)
    return K.seg_cumsum_i64(f, torch.from_numpy(v)).numpy()


def _i64_case(name, rng):
    cap = 8192 * 2
    flags = rng.random(cap) < 0.005
    if name == "random":
        return flags, rng.integers(-2**40, 2**40, cap)
    if name == "no_flags":
        return None, rng.integers(-2**40, 2**40, cap)
    if name == "wraparound":
        # values near ±2^62: running sums wrap past ±2^63 inside segments
        v = rng.integers(2**62 - 2**20, 2**62, cap)
        v[rng.random(cap) < 0.3] *= -1
        return rng.random(cap) < 0.002, v
    # cross-block carry: one boundary mid-block, another at a tile edge
    v = np.full(cap * 2, 2**31 - 1, np.int64)
    flags = np.zeros(cap * 2, bool)
    flags[20000] = True
    flags[8192] = True
    return flags, v


@pytest.mark.parametrize("case", ["random", "no_flags", "wraparound",
                                  "cross_block_carry"])
def test_seg_cumsum_i64_matches_pallas(case, rng):
    flags, v = _i64_case(case, rng)
    got = _port_i64(flags, v)
    np.testing.assert_array_equal(got, _pallas_i64(flags, v))
    np.testing.assert_array_equal(got, _seg_oracle_i64(v, flags))


_NP_OPS = {"add": np.add, "min": np.minimum, "max": np.maximum}


def _multi_lanes(rng, cap, nan):
    xi = rng.integers(-50, 50, cap).astype(np.int32)
    xf = rng.normal(size=cap).astype(np.float32)
    if nan:
        xf[rng.random(cap) < 0.002] = np.nan
    xi2 = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    return ((xi, "add"), (xf, "min"), (xf, "max"), (xi2, "max"))


@pytest.mark.parametrize("with_flags", [True, False])
@pytest.mark.parametrize("nan", [False, True])
def test_seg_scan_multi_matches_pallas(with_flags, nan, rng):
    cap = 8192 * 3
    lanes = _multi_lanes(rng, cap, nan)
    flags = rng.random(cap) < 0.01 if with_flags else None
    xs = tuple(x for x, _ in lanes)
    ops = tuple(op for _, op in lanes)
    want = PK.seg_scan_multi(None if flags is None else jnp.asarray(flags),
                             tuple(jnp.asarray(x) for x in xs), ops,
                             interpret=True, block_rows=64)
    got = K.seg_scan_multi(None if flags is None else torch.from_numpy(flags),
                           tuple(torch.from_numpy(x) for x in xs), ops)
    for g, w, x, op in zip(got, want, xs, ops):
        assert g.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(),
                                      _seg_oracle(x, flags, _NP_OPS[op]))


def test_seg_scan_multi_float_add(rng):
    cap = 8192 * 2
    xf = rng.normal(size=cap).astype(np.float32)
    xi = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    flags = rng.random(cap) < 0.01
    want = PK.seg_scan_multi(jnp.asarray(flags),
                             (jnp.asarray(xf), jnp.asarray(xi)),
                             ("add", "add"), interpret=True, block_rows=64)
    got = K.seg_scan_multi(torch.from_numpy(flags),
                           (torch.from_numpy(xf), torch.from_numpy(xi)),
                           ("add", "add"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=1e-5)
    # int32 adds wrap mod 2^32 in both
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_scan_dispatch(rng):
    """ops/scan routes int64 sums to seg_cumsum_i64, int32/float32/float64
    sums and min/max to seg_scan_multi, and refuses to sum other dtypes
    (the running aggregates widen them first)."""
    n = 3000
    flags = torch.from_numpy(rng.random(n) < 0.05)
    x64 = torch.from_numpy(rng.integers(-9, 9, n))
    x32 = x64.to(torch.int32)
    np.testing.assert_array_equal(S.seg_cumsum(x64, flags).numpy(),
                                  _seg_oracle_i64(x64.numpy(), flags.numpy()))
    np.testing.assert_array_equal(
        S.seg_cummin(x32, flags).numpy(),
        _seg_oracle(x32.numpy(), flags.numpy(), np.minimum))
    np.testing.assert_array_equal(
        S.seg_cummax(x32, None).numpy(), np.maximum.accumulate(x32.numpy()))
    np.testing.assert_array_equal(
        S.seg_cumsum(x64.to(torch.float64), flags).numpy(),
        _seg_oracle(x64.numpy().astype(np.float64), flags.numpy(), np.add))
    with pytest.raises(TypeError):
        S.seg_cumsum(x64.to(torch.int16), flags)


# --- the single-pass look-back of csrc/segscan.cuh, modelled ----------------

_EMPTY, _AGG, _INC, _AGG_FLAG = 0, 1, 2, 3     # segscan.cuh's status words


def _fold(vals, flags, comb, ident):
    """(flag-seen, value since the last flag) of a span of rows."""
    f, v = False, ident
    for x, fl in zip(vals, flags):
        f, v = f or fl, x if fl else comb(v, x)
    return f, v


def _lookback_model(flags, lanes, tile, rng, p_inc, window=32):
    """segscan_lookback, one tile at a time in tile order, but with each
    predecessor's status as a look-back could find it at any timing: its
    aggregate or, with probability p_inc, already its inclusive prefix
    (tile 0 is always inclusive); a tile before the window's nearest stop
    may not have published at all (the walk does not wait for it), here
    with probability 1/2. Each walk reads `window` predecessors at a time,
    stops at the nearest inclusive prefix or flagged aggregate, and folds
    the window in tile order (earlier . later), windows further back in
    front. lanes: (values, comb, identity) with each value a shape-(1,)
    array, so that numpy's adds wrap silently."""
    n = len(lanes[0][0])
    flags = np.zeros(n, bool) if flags is None else flags
    ntiles = -(-n // tile)

    def seg(a, b):                       # (fa, va) . (fb, vb), per lane
        return (a[0] or b[0],
                b[1] if b[0] else [c(x, y) for (_, c, _), x, y
                                   in zip(lanes, a[1], b[1])])

    ident = (False, [i for _, _, i in lanes])
    aggs, incs, out = [], [], [np.empty(n, v.dtype) for v, _, _ in lanes]
    for t in range(ntiles):
        rows = range(t * tile, min(n, (t + 1) * tile))
        agg = (bool(flags[rows].any()), [
            _fold([v[r:r + 1] for r in rows], flags[rows], c, i)[1]
            for v, c, i in lanes])
        run, end = ident, t
        while t > 0:
            ps = range(end - window, end)
            st = {p: (_EMPTY if p < 0 else _INC if p == 0
                      or rng.random() < p_inc else
                      _AGG_FLAG if aggs[p][0] else _AGG) for p in ps}
            stops = [p for p in ps if st[p] >= _INC]
            for p in ps:
                if stops and p < stops[-1] and rng.random() < 0.5:
                    st[p] = _EMPTY
            w = ident
            for p in ps:                  # lanes in tile order
                if p >= (stops[-1] if stops else end - window) \
                        and st[p] > _EMPTY:
                    w = seg(w, (True, incs[p]) if st[p] == _INC
                            else aggs[p])
            run = seg(w, run)
            if stops:
                break
            end -= window
        incs.append(seg(run, agg)[1])
        aggs.append(agg)
        acc = run[1]
        for r in rows:
            acc = [v[r:r + 1] if flags[r] else c(a, v[r:r + 1])
                   for (v, c, _), a in zip(lanes, acc)]
            for o, a in zip(out, acc):
                o[r] = a[0]
    return out


def _model_flags(case, n, tile, rng):
    """The flag cases of chip_smoke.py at the model's size: none, the
    main path's density, nearly every row, and lone flags (in the middle
    of a tile after many flagless tiles, on a tile's first row, on the
    last row)."""
    if case == "none":
        return None
    if case in ("0.1", "0.999"):
        return rng.random(n) < float(case)
    f = np.zeros(n, bool)
    f[{"lone_mid": (n // tile - 2) * tile + tile // 2 + 1,
       "tile_first_row": (n // tile // 2) * tile,
       "last_row": n - 1}[case]] = True
    return f


_MODEL_CASES = ["none", "0.1", "0.999", "lone_mid", "tile_first_row",
                "last_row"]


@pytest.mark.parametrize("tile", [4, 16, 64])
@pytest.mark.parametrize("case", _MODEL_CASES)
def test_lookback_model_matches_plain(case, tile, rng):
    """The segmented look-back rule (stop at an inclusive prefix or a
    flagged aggregate, combine earlier . later) equals the plain versions:
    seg_cumsum_i64 with int64 sums that wrap, seg_scan_multi with int32
    add, float32 min/max with NaNs and an integer-valued float32 add, and
    (without flags) fused_running_stats: one integer-valued float32 column
    with NaNs feeding add, min and max. 40+ tiles, so a walk spans more
    than one window of 32."""
    n = 41 * tile + tile // 3 + 1
    flags = _model_flags(case, n, tile, rng)
    tflags = None if flags is None else torch.from_numpy(flags)
    x64 = rng.integers(2**62 - 2**20, 2**62, n)
    x64[rng.random(n) < 0.3] *= -1               # running sums wrap
    want = K.seg_cumsum_i64_plain(tflags, torch.from_numpy(x64)).numpy()
    for p_inc in (0.5, 0.0):
        got = _lookback_model(flags, [(x64, np.add, np.zeros(1, np.int64))],
                              tile, rng, p_inc)[0]
        np.testing.assert_array_equal(got, want)

    xi = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    xf = rng.normal(size=n).astype(np.float32)
    xf[rng.random(n) < 0.02] = np.nan
    xa = rng.integers(-50, 50, n).astype(np.float32)
    inf = np.array([np.inf], np.float32)
    lanes = [(xi, np.add, np.zeros(1, np.int32)), (xf, np.minimum, inf),
             (xf, np.maximum, -inf), (xa, np.add, np.zeros(1, np.float32))]
    want = K.seg_scan_multi_plain(
        tflags, tuple(torch.from_numpy(x) for x, _, _ in lanes),
        ("add", "min", "max", "add"))
    for p_inc in (0.5, 0.0):
        got = _lookback_model(flags, lanes, tile, rng, p_inc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())

    if flags is None:                    # fused_running_stats has no flags
        xr = rng.integers(-50, 50, n).astype(np.float32)
        xr[rng.random(n) < 0.02] = np.nan
        want = K.fused_running_stats_plain(torch.from_numpy(xr))
        for p_inc in (0.5, 0.0):
            got = _lookback_model(None, _running_lanes(xr), tile, rng, p_inc)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())


def _running_lanes(x):
    """fused_running_stats as the look-back's lanes: add, min and max of
    the one column x."""
    inf = np.array([np.inf], np.float32)
    return [(x, np.add, np.zeros(1, np.float32)), (x, np.minimum, inf),
            (x, np.maximum, -inf)]


def test_lookback_model_walks_past_one_window(rng):
    """With no inclusive prefix seen but tile 0's, a walk crosses
    windows; a window of 3 does it many times on a short input."""
    tile, n = 4, 4 * 30 + 2
    flags = np.zeros(n, bool)
    flags[5] = True
    x = rng.integers(-9, 9, n)
    got = _lookback_model(flags, [(x, np.add, np.zeros(1, np.int64))], tile,
                          rng, 0.0, window=3)[0]
    np.testing.assert_array_equal(got, _seg_oracle_i64(x, flags))


def test_wrappers_check_inputs_and_count_only_launches():
    before = dict(K.LAUNCHES)
    x = torch.arange(10, dtype=torch.int64)
    K.seg_cumsum_i64(None, x)
    K.seg_scan_multi(None, (x.to(torch.int32),), ("min",))
    K.fused_running_stats(x.to(torch.float32)[3:])
    assert K.LAUNCHES == before          # CPU tensors take the plain versions
    with pytest.raises(ValueError):
        K.seg_cumsum_i64(None, x.to(torch.int32))
    with pytest.raises(ValueError):
        K.seg_cumsum_i64(torch.zeros(9, dtype=torch.bool), x)
    with pytest.raises(ValueError):         # one word width per call
        K.seg_scan_multi(None, (x.to(torch.int32), x.to(torch.float64)),
                         ("add", "add"))
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.int16),), ("add",))
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.int32),) * 5, ("add",) * 5)
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.int32),), ("mul",))


# --- onehot_segment_sums ----------------------------------------------------

def _onehot_case(name, rng):
    """(code int32, {tag: lane}, dp, bounds) for _pallas_onehot_reduce."""
    n = 16384
    if name == "superblock":
        # max_digit 63 forces one block per superblock (test_pallas.py)
        n, dp = 32768, 8
        return ((np.arange(n) % dp).astype(np.int32),
                {"s": np.full(n, 63, np.int32)}, dp, {"s": 63})
    if name in ("q4_lanes", "na8_lanes", "ragged_16383", "ragged_1009"):
        # q4's lanes as the dense tier builds them: counts, avg(v1) and
        # avg(v2) sums, v3's two float32 limbs; with NAs each aggregate
        # adds its bool :cnt lane
        n = {"ragged_16383": 16383, "ragged_1009": 1009}.get(name, n)
        dp = 11
        code = rng.integers(0, dp, n).astype(np.int32)
        cnt = rng.random(n) < 0.95
        lanes = {"__counts__": cnt}
        for v, hi in (("v1", 6), ("v2", 16)):
            if name == "na8_lanes":
                lanes[v + ":cnt"] = cnt & (rng.random(n) < 0.95)
            lanes[v + ":sum"] = np.where(cnt, rng.integers(1, hi, n),
                                         0).astype(np.int32)
        if name == "na8_lanes":
            lanes["v3:cnt"] = cnt & (rng.random(n) < 0.95)
        lanes["v3#A"] = rng.integers(0, 100 << 14, n)
        lanes["v3#B"] = rng.integers(-2**37, 2**37, n)
        return code, lanes, dp, {}
    dp = {"dp2": 2, "dp16": 16, "dp101_six_lanes": 101, "dp513": 513,
          "one_slot": 11}[name]
    code = rng.integers(0, dp, n).astype(np.int32)
    if name == "one_slot":
        code[:] = dp - 1
    lanes = {"c": rng.random(n) < 0.7,
             "w": rng.integers(-2**40, 2**40, n)}
    if name != "dp2":
        lanes["s"] = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    if name == "dp101_six_lanes":
        lanes["t"] = rng.integers(-5, 6, n).astype(np.int32)
        lanes["u"] = -rng.integers(2**39, 2**40, n)
        lanes["b"] = rng.random(n) < 0.01
    return code, lanes, dp, {}


def _add_at(code, v, dp):
    """Exact per-slot int64 sums (np.add.at wraps mod 2^64)."""
    out = np.zeros(dp, np.int64)
    np.add.at(out, code, v.astype(np.int64))
    return out


def _views(code, lanes):
    """The codes as a view at offset 1 and the lanes at 3, 1, 0, 3, ...
    (torch slices of longer tensors), with the numpy rows they hold."""
    n = len(code) - 3
    tcode = torch.from_numpy(code)[1:1 + n]
    tl, nl = [], {}
    for j, (t, v) in enumerate(lanes.items()):
        off = (3, 1, 0)[j % 3]
        tl.append(torch.from_numpy(v)[off:off + n])
        nl[t] = v[off:off + n]
    return tcode, tl, code[1:1 + n], nl


@pytest.mark.parametrize("case", ["dp2", "dp16", "dp101_six_lanes", "dp513",
                                  "one_slot", "superblock", "q4_lanes",
                                  "na8_lanes", "odd_offsets", "ragged_16383",
                                  "ragged_1009"])
def test_onehot_segment_sums_matches_pallas(case, rng):
    """The port against _pallas_onehot_reduce and np.add.at: slot counts
    and lane dtypes, q4's lanes and the NA variant's 8-lane mix, views at
    odd offsets and lengths that are not a multiple of 16."""
    code, lanes, dp, bounds = _onehot_case(
        "dp101_six_lanes" if case == "odd_offsets" else case, rng)
    tags = list(lanes)
    if case == "odd_offsets":
        tcode, tlanes, code, lanes = _views(code, lanes)
        assert tcode.storage_offset() == 1 and tcode.is_contiguous()
    else:
        tcode = torch.from_numpy(code)
        tlanes = [torch.from_numpy(lanes[t]) for t in tags]
    got = K.onehot_segment_sums(tcode, tuple(tlanes), dp)
    assert got.dtype == torch.int64 and tuple(got.shape) == (dp, len(tags))
    # the Pallas kernel takes whole 1024-row blocks: rows of zeros in slot
    # 0 pad it there and add nothing
    pad = -len(code) % 1024
    want = JR._pallas_onehot_reduce(
        jnp.asarray(np.pad(code, (0, pad))),
        {t: jnp.asarray(np.pad(v, (0, pad))) for t, v in lanes.items()},
        dp - 1, bounds=bounds, interpret=True)
    for j, t in enumerate(tags):
        np.testing.assert_array_equal(got[:, j].numpy(), np.asarray(want[t]),
                                      err_msg=t)
        np.testing.assert_array_equal(got[:, j].numpy(),
                                      _add_at(code, lanes[t], dp), err_msg=t)


def test_onehot_segment_sums_wraps_like_int64():
    """Sums past ±2^63 wrap mod 2^64, as int64 index_add_ does."""
    code = torch.tensor([0, 0, 1, 1, 0], dtype=torch.int32)
    big = torch.tensor([2**62, 2**62, -2**62, -2**62, 2**62])
    got = K.onehot_segment_sums(code, (big,), 2)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  _add_at(code.numpy(), big.numpy(), 2))
    assert got[0, 0] == 2**62 * 3 - 2**64 and got[1, 0] == -2**63


@pytest.mark.parametrize("k,place", C.F64_PLACES)
@pytest.mark.parametrize("dp", C.F64_DPS)
def test_onehot_segment_sums_float64_lane(dp, k, place, rng):
    """A float64 lane at the first, a middle or the last of 1, 6 and 8
    lanes: its column, read as float64, within 1e-12 normwise of each
    slot's math.fsum; every integer and bool lane equal bit for bit to an
    integer-only call's column and to np.add.at."""
    n = 4099
    code = torch.from_numpy(rng.integers(0, dp, n).astype(np.int32))
    lanes = C.f64_lanes(rng, n, k, place)
    got = K.onehot_segment_sums(code, lanes, dp)
    assert got.dtype == torch.int64 and tuple(got.shape) == (dp, k)
    f = got[:, place].view(torch.float64)
    assert C.normwise_error(f, C.fsum_slots(code, lanes[place], dp)) \
        <= C.F64_RTOL
    ints = [j for j in range(k) if j != place]
    if ints:
        alone = K.onehot_segment_sums(code, tuple(lanes[j] for j in ints), dp)
        assert torch.equal(got[:, ints], alone)
    for j in ints:
        np.testing.assert_array_equal(
            got[:, j].numpy(), _add_at(code.numpy(), lanes[j].numpy(), dp))


def test_onehot_segment_sums_checks_inputs():
    code = torch.zeros(10, dtype=torch.int32)
    lane = torch.ones(10, dtype=torch.int64)
    before = dict(K.LAUNCHES)
    K.onehot_segment_sums(code, (lane,) * 8, 3)
    assert K.LAUNCHES == before          # CPU tensors take the plain version
    with pytest.raises(ValueError):      # one copy would not fit
        K.onehot_segment_sums(code, (lane,), K.ONEHOT_MAX_ENTRIES + 1)
    with pytest.raises(ValueError):
        K.onehot_segment_sums(code, (lane,) * 9, 3)
    with pytest.raises(ValueError):
        K.onehot_segment_sums(code.to(torch.int64), (lane,), 3)
    with pytest.raises(ValueError):
        K.onehot_segment_sums(code, (lane.to(torch.float32),), 3)
    with pytest.raises(ValueError):
        K.onehot_segment_sums(code, (lane[:9],), 3)


_KEY_IDS = [np.dtype(d).name for d in C.KEY_DTYPES]


@pytest.mark.parametrize("dtype", C.KEY_DTYPES, ids=_KEY_IDS)
@pytest.mark.parametrize("nkeys", [1, 2, 3, 4])
def test_onehot_keyed_form_matches_code_form_and_pallas(nkeys, dtype, rng):
    """The keyed form (1 to 4 keys of each integer dtype, at both ends of
    the dtype's range; 4,099 of 5,120 rows, garbage past them; a row
    mask; int32 lanes near ±2^31 with their products, a bool and an int64
    lane; the row count) equal to the code form on the code the dense
    tier built from the same columns (the overflow slot cut), and to
    _pallas_onehot_reduce on that code, column for column; the int32
    lanes' own sums to np.add.at instead (the JAX package's digit split
    reads an int32 at or above 2^30 as negative: 2^31 - 5 sums as
    -(2^31 + 5))."""
    case = C.keyed_case(rng, nkeys, dtype, 4099, 5120)
    code, lanes, dp, kw = C.keyed_args(case)
    got = K.onehot_segment_sums(code, lanes, dp, **kw)
    assert tuple(got.shape) == (dp, 8)
    assert torch.equal(got, K.onehot_segment_sums_plain(code, lanes, dp,
                                                        **kw))
    dense = C.dense_code(case)
    cols = C.dense_columns(case)
    want = K.onehot_segment_sums(torch.from_numpy(dense),
                                 tuple(torch.from_numpy(x) for x in cols),
                                 dp + 1)
    assert torch.equal(got, want[:dp])
    jw = JR._pallas_onehot_reduce(
        jnp.asarray(dense),
        {str(j): jnp.asarray(x) for j, x in enumerate(cols)}, dp,
        interpret=True)
    for j, x in enumerate(cols):
        want = (_add_at(dense, x, dp + 1) if x.dtype == np.int32
                else np.asarray(jw[str(j)]))
        np.testing.assert_array_equal(got[:, j].numpy(), want[:dp],
                                      err_msg=str(j))


@pytest.mark.parametrize("case", ["float64", "out_of_range", "no_mask",
                                  "counts_only", "max_entries",
                                  "one_key_int32"])
def test_onehot_keyed_form_edges(case, rng):
    """The keyed form's edges against numpy: a float64 lane within 1e-12
    normwise of math.fsum (the integer columns as the code form gives
    them); keys outside their ranges dropped; no row mask; the row count
    alone; dp · k at ONEHOT_MAX_ENTRIES; and one int32 key of minimum 0
    and stride 1, which is the code form."""
    n, cap = 3001, 3333
    if case == "max_entries":
        dp = K.ONEHOT_MAX_ENTRIES // 2
        c = C.keyed_case(rng, 1, np.int32, n, cap, ranges=(dp,))
        c["lanes"], c["products"] = c["lanes"][:1], ()
    else:
        c = C.keyed_case(rng, 2, np.int16, n, cap, f64=case == "float64",
                         mask=case != "no_mask")
    if case == "counts_only":
        c["lanes"], c["products"] = [], ()
    if case == "one_key_int32":
        c = C.keyed_case(rng, 1, np.int32, n, cap, ranges=(77,), mask=False)
        c["keys"][0] -= np.int32(-2**31)             # min 0, stride 1
        c["mins"] = [0]
    code, lanes, dp, kw = C.keyed_args(c)
    if case == "out_of_range":
        bad = torch.from_numpy(rng.random(n) < 0.1)
        code = code.clone()
        code[bad] = torch.tensor([-2**15, 2**15 - 1], dtype=torch.int16)[
            torch.arange(int(bad.sum())) % 2]
    got = K.onehot_segment_sums(code, lanes, dp, **kw)
    slot = np.zeros(n, np.int64)
    for k, mn, st in zip((code, *kw["keys"]), kw["mins"], kw["strides"]):
        slot += (k.numpy().astype(np.int64) - mn) * st
    keep = (slot >= 0) & (slot < dp)
    if kw["row_mask"] is not None:
        keep &= kw["row_mask"].numpy()
    s = slot[keep]
    cols = [x.numpy()[keep] for x in lanes] + [
        lanes[a].numpy()[keep].astype(np.int64)
        * lanes[b].numpy()[keep].astype(np.int64) for a, b in kw["products"]]
    assert tuple(got.shape) == (dp, len(cols) + 1)
    for j, v in enumerate(cols):
        if v.dtype == np.float64:
            f = got[:, j].view(torch.float64)
            assert C.normwise_error(f, C.fsum_slots(
                torch.from_numpy(s), torch.from_numpy(v), dp)) <= C.F64_RTOL
        else:
            np.testing.assert_array_equal(got[:, j].numpy(), _add_at(s, v, dp))
    np.testing.assert_array_equal(got[:, -1].numpy(), np.bincount(s, None, dp))
    if case == "one_key_int32":
        plain = K.onehot_segment_sums(code, lanes, dp)
        assert torch.equal(got[:, :len(lanes)], plain)


def test_onehot_keyed_form_checks_inputs():
    """The keyed form refuses keys of two dtypes, a float64 factor, more
    than 4 keys, a row mask that is not bool, more than 8 columns, its
    keywords without mins, and accumulators that do not fit beside its
    rows; every call counts in ONEHOT_FORMS, on the CPU too."""
    k8 = torch.zeros(10, dtype=torch.int8)
    k64 = torch.zeros(10, dtype=torch.int64)
    x = torch.ones(10, dtype=torch.int32)
    f = torch.ones(10, dtype=torch.float64)
    before = dict(K.ONEHOT_FORMS)
    K.onehot_segment_sums(k8, (x,), 3, keys=(k8,), mins=(0, 0),
                          strides=(1, 1), counts=True)
    K.onehot_segment_sums(k8.to(torch.int32), (x,), 3)
    assert K.ONEHOT_FORMS == {"keyed": before["keyed"] + 1,
                              "code": before["code"] + 1}
    bad = [dict(keys=(k64,), mins=(0, 0), strides=(1, 1)),
           dict(mins=(0,), strides=(1,), products=((0, 1),), lanes=(x, f)),
           dict(keys=(k8,) * 4, mins=(0,) * 5, strides=(1,) * 5),
           dict(mins=(0,), strides=(1,), row_mask=x),
           dict(mins=(0,), strides=(1,), lanes=(x,) * 8, counts=True),
           dict(counts=True), dict(row_mask=x.bool()),
           dict(mins=(0,), strides=(1,), keys=(k64, k64, k64),
                lanes=(k64,) * 8, dp=K.ONEHOT_MAX_ENTRIES // 8)]
    code = {0: k8, 1: k8, 2: k8, 3: k8, 4: k8, 5: k8.to(torch.int32),
            6: k8.to(torch.int32), 7: k64}
    for i, kw in enumerate(bad):
        lanes = kw.pop("lanes", (x,))
        dp = kw.pop("dp", 3)
        with pytest.raises(ValueError):
            K.onehot_segment_sums(code[i], lanes, dp, **kw)
    K.onehot_segment_sums(k8.to(torch.int32), (k64,) * 8,
                          K.ONEHOT_MAX_ENTRIES // 8, mins=(0,), strides=(1,))


# --- fused_running_stats and best_profit ------------------------------------

def _running_x(case, rng, cap):
    if case == "zero_one":     # sums stay integers below 2^24: exact
        return rng.integers(0, 2, cap).astype(np.float32)
    x = (rng.random(cap) * 100 - 50).astype(np.float32)
    if case == "nan":
        x[rng.random(cap) < 0.001] = np.nan
    return x


@pytest.mark.parametrize("case", ["normal", "nan", "zero_one"])
def test_fused_running_stats_matches_pallas(case, rng):
    cap = 16384
    x = _running_x(case, rng, cap)
    got = K.fused_running_stats(torch.from_numpy(x))
    want = [np.asarray(w) for w in PK.fused_running_stats(jnp.asarray(x),
                                                          interpret=True)]
    for g in got:
        assert g.dtype == torch.float32 and tuple(g.shape) == (cap,)
    sums, mins, maxs = (g.numpy() for g in got)
    if case == "zero_one":
        np.testing.assert_array_equal(sums, want[0])
        np.testing.assert_array_equal(sums, np.cumsum(x, dtype=np.float64))
    else:
        np.testing.assert_allclose(sums, want[0], rtol=2e-5)
        np.testing.assert_allclose(sums, np.cumsum(x, dtype=np.float32),
                                   rtol=2e-5)
    np.testing.assert_array_equal(mins, want[1])
    np.testing.assert_array_equal(maxs, want[2])
    np.testing.assert_array_equal(mins, np.minimum.accumulate(x))
    np.testing.assert_array_equal(maxs, np.maximum.accumulate(x))


@pytest.mark.parametrize("case", ["normal", "nan", "zero_one"])
def test_running_stats_lookback_model_matches_pallas(case, rng):
    """The single-pass look-back as fused_running_stats runs it (no flags,
    one column for three lanes; 64-row tiles, so 256 tiles, and with no
    inclusive prefix but tile 0's walks of up to eight windows of 32)
    against the Pallas kernel: min and max exactly, sums within 1e-5 of
    the running sum of |x| (chip_smoke.py's RUN_SUM_TOL; exactly for
    {0, 1})."""
    cap = 16384
    x = _running_x(case, rng, cap)
    got = _lookback_model(None, _running_lanes(x), 64, rng,
                          0.0 if case == "nan" else 0.5)
    want = [np.asarray(w) for w in PK.fused_running_stats(jnp.asarray(x),
                                                          interpret=True)]
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    if case == "zero_one":
        np.testing.assert_array_equal(got[0], want[0])
    else:
        ok = ~np.isnan(want[0])
        scale = np.cumsum(np.abs(np.nan_to_num(x)).astype(np.float64))
        assert (np.abs(got[0].astype(np.float64) - want[0])[ok]
                <= 1e-5 * scale[ok]).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("cap,n", [(8192, 5000), (16384, 16384)])
def test_best_profit_matches_pallas(cap, n, rng):
    x = np.zeros(cap, np.float32)
    x[:n] = rng.integers(1, 100, n)
    got = K.best_profit(torch.from_numpy(x), n)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(PK.best_profit(jnp.asarray(x), n, interpret=True))
    assert float(got) == want == float((x[:n] - np.minimum.accumulate(
        x[:n])).max())


def test_fused_running_stats_any_length():
    """The port takes any length (the TPU kernel wanted a multiple of
    8192); integer input is taken as float32, as in the JAX package."""
    x = torch.tensor([3, 1, 4, 1, 5, 9, 2], dtype=torch.int32)
    sums, mins, maxs = K.fused_running_stats(x)
    np.testing.assert_array_equal(sums.numpy(), [3, 4, 8, 9, 14, 23, 25])
    np.testing.assert_array_equal(mins.numpy(), [3, 1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(maxs.numpy(), [3, 3, 4, 4, 5, 9, 9])
    assert sums.dtype == torch.float32
    assert float(K.best_profit(x, 6)) == 8.0
