"""Cases of onehot_segment_sums with a float64 lane, shared by the CPU test
(tests/test_torch_kernels.py) and the card test (tests/test_torch_package.py,
which imports no JAX): the float64 lane at the first, a middle or the last
place of 1, 6 or 8 lanes beside int64, int32 and bool lanes, and its exact
per-slot sums by math.fsum. Imports numpy and torch only."""

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
