"""Cases of onehot_segment_sums shared by the CPU test
(tests/test_torch_kernels.py) and the card test (tests/test_torch_package.py,
which imports no JAX): a float64 lane at the first, a middle or the last
place of 1, 6 or 8 lanes beside int64, int32 and bool lanes, and its exact
per-slot sums by math.fsum; and the keyed form's inputs (keyed_case) with
the code the dense tier built from them before the kernel read its keys
(dense_code). Imports numpy and torch only."""

import math

import numpy as np
import torch

F64_DPS = (2, 11, 101, 513)
# (lanes, the float64 lane's place)
F64_PLACES = ((1, 0), (6, 0), (6, 3), (6, 5), (8, 0), (8, 4), (8, 7))
F64_RTOL = 1e-12          # normwise: float64 adds in another order
_OTHERS = (torch.int64, torch.int32, torch.bool)


def f64_lanes(rng, n: int, k: int, place: int) -> tuple[torch.Tensor, ...]:
    """k CPU lanes of n rows: float64 at place (normal values scaled by
    1e-3 to 1e6), the others int64, int32 and bool in turn."""
    lanes = []
    for j in range(k):
        if j == place:
            lanes.append(torch.from_numpy(
                rng.normal(size=n) * 10.0 ** rng.integers(-3, 7, n)))
            continue
        dt = _OTHERS[(j - (j > place)) % 3]
        if dt == torch.int64:
            x = rng.integers(-2**62, 2**62, n)
        elif dt == torch.int32:
            x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
        else:
            x = rng.random(n) < 0.5
        lanes.append(torch.from_numpy(x))
    return tuple(lanes)


def fsum_slots(code: torch.Tensor, x: torch.Tensor, dp: int) -> np.ndarray:
    """Each slot's correctly rounded float64 sum of x over its rows (rows
    whose code is outside [0, dp) left out)."""
    c, v = code.cpu().numpy(), x.cpu().numpy()
    return np.array([math.fsum(v[c == s]) for s in range(dp)])


def normwise_error(got: torch.Tensor, want: np.ndarray) -> float:
    """||got - want|| / ||want|| over the slots (2-norms)."""
    g = got.cpu().numpy()
    return float(np.linalg.norm(g - want) / max(np.linalg.norm(want),
                                                np.finfo(np.float64).tiny))


# The keyed form: 1 to 4 keys of each integer dtype, each key's range (a
# domain of 77 to 101 slots), and the products of keyed_case's lanes.
KEY_DTYPES = (np.int8, np.int16, np.int32, np.int64)
KEY_RANGES = {1: (101,), 2: (11, 7), 3: (5, 4, 3), 4: (3, 3, 2, 2)}
KEYED_PRODUCTS = ((0, 1), (0, 0), (1, 1))


def near_int32_ends(rng, n: int) -> np.ndarray:
    """int32 values within 2^16 of -2^31 or of 2^31 - 1, so that their
    products and squares take 62 bits and their sums wrap int64."""
    x = rng.integers(2**31 - 2**16, 2**31, n)
    return np.where(rng.random(n) < 0.5, -x, x - 1).astype(np.int32)


def keyed_case(rng, nkeys: int, dtype, n: int, cap: int, *, mask=True,
               f64=False, ranges=None) -> dict:
    """A keyed call's CPU inputs over cap rows, of which the call takes the
    first n (the rest is garbage of the whole dtype range): nkeys key
    columns of dtype, the first key's values at the bottom of the dtype's
    range, the next at its top, and so on, both ends of each key's own
    range present; a row mask (80% True) or None; lanes x and y (int32
    near ±2^31), a bool, and an int64 lane (a float64 one where f64);
    keyed_case's products (x·y, x², y²) and each slot's row count."""
    info = np.iinfo(dtype)
    ranges = ranges or KEY_RANGES[nkeys]
    mins = [int(info.min) if q % 2 == 0 else int(info.max) - r + 1
            for q, r in enumerate(ranges)]
    strides = [int(np.prod(ranges[q + 1:], dtype=np.int64))
               for q in range(len(ranges))]
    keys = []
    for mn, r in zip(mins, ranges):
        k = (np.int64(mn) + rng.integers(0, r, cap)).astype(dtype)
        k[[0, 1]] = (mn, mn + r - 1)
        k[n:] = rng.integers(info.min, info.max, cap - n, endpoint=True,
                             dtype=dtype)
        keys.append(k)
    last = (rng.normal(size=cap) * 10.0 ** rng.integers(-3, 7, cap) if f64
            else rng.integers(-2**62, 2**62, cap))
    return {"keys": keys, "mins": mins, "strides": strides,
            "dp": int(np.prod(ranges)),
            "row_mask": rng.random(cap) < 0.8 if mask else None,
            "lanes": [near_int32_ends(rng, cap), near_int32_ends(rng, cap),
                      rng.random(cap) < 0.5, last],
            "products": KEYED_PRODUCTS, "n": n}


def keyed_args(case: dict, device="cpu", offset=0):
    """(code, lanes, dp, keywords) of onehot_segment_sums' keyed form over
    the case's first n rows, as torch tensors on device: views of the
    columns from their row ``offset`` on, so that a key, the mask and the
    lanes may start off a 16-byte boundary."""
    n = case["n"] - offset

    def t(a):
        return torch.from_numpy(a).to(device)[offset:offset + n]
    keys = [t(k) for k in case["keys"]]
    kw = {"keys": tuple(keys[1:]), "mins": tuple(case["mins"]),
          "strides": tuple(case["strides"]),
          "row_mask": None if case["row_mask"] is None
          else t(case["row_mask"]),
          "products": case["products"], "counts": True}
    return keys[0], tuple(t(x) for x in case["lanes"]), case["dp"], kw


def dense_code(case: dict) -> np.ndarray:
    """The int32 code the dense tier built before the kernel read its keys:
    over every row of the columns, sum (key - min) * stride, and the
    overflow slot dp for a row past n or masked out."""
    cap = len(case["keys"][0])
    code = np.zeros(cap, np.int64)
    for k, mn, st in zip(case["keys"], case["mins"], case["strides"]):
        code += (k.astype(np.int64) - mn) * st      # wraps in the tail
    valid = np.arange(cap) < case["n"]
    if case["row_mask"] is not None:
        valid &= case["row_mask"]
    return np.where(valid, code, case["dp"]).astype(np.int32)


def dense_columns(case: dict) -> list[np.ndarray]:
    """The columns the dense tier handed the code form for the keyed
    form's: the lanes, the products in int64 and the validity (its row
    count), over every row."""
    x = case["lanes"]
    valid = dense_code(case) < case["dp"]
    return [*x, *(x[a].astype(np.int64) * x[b].astype(np.int64)
                  for a, b in case["products"]), valid]


def keyed_equal(got: torch.Tensor, want: torch.Tensor, lanes) -> None:
    """got equal to want, two [dp, k] outputs of one keyed call: every
    column but a float64 lane's bit for bit, a float64 lane's within
    F64_RTOL normwise (the same adds in another order)."""
    f64 = [j for j, x in enumerate(lanes) if x.dtype == torch.float64]
    ints = [j for j in range(got.shape[1]) if j not in f64]
    assert torch.equal(got[:, ints].cpu(), want[:, ints].cpu())
    for j in f64:
        w = want[:, j].view(torch.float64).cpu().numpy()
        assert normwise_error(got[:, j].view(torch.float64), w) <= F64_RTOL
