"""The port's seg_cumsum_i64 and seg_scan_multi against the JAX package's
Pallas kernels (interpret mode, block_rows=64, as tests/test_pallas.py
runs them on the CPU) and against a row-by-row oracle.

On the CPU the port's wrappers run their plain PyTorch versions. Results
are exact, except float32 'add' lanes (rtol 2e-5: the doubling scan adds
in another order than the row loop)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aquery2_tpu.ops import pallas_kernels as PK
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import scan as S

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
    """ops/scan routes int64 to seg_cumsum_i64, int32/float32 to
    seg_scan_multi, and refuses other dtypes."""
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
    with pytest.raises(NotImplementedError):
        S.seg_cumsum(x64.to(torch.float64), flags)


def test_wrappers_check_inputs_and_count_only_launches():
    before = dict(K.LAUNCHES)
    x = torch.arange(10, dtype=torch.int64)
    K.seg_cumsum_i64(None, x)
    K.seg_scan_multi(None, (x.to(torch.int32),), ("min",))
    assert K.LAUNCHES == before          # CPU tensors take the plain versions
    with pytest.raises(ValueError):
        K.seg_cumsum_i64(None, x.to(torch.int32))
    with pytest.raises(ValueError):
        K.seg_cumsum_i64(torch.zeros(9, dtype=torch.bool), x)
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.float64),), ("add",))
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.int32),) * 5, ("add",) * 5)
    with pytest.raises(ValueError):
        K.seg_scan_multi(None, (x.to(torch.int32),), ("mul",))
