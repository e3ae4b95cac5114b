"""Synthetic data generators.

``h2o_g1`` makes the h2o db-benchmark G1 group-by table
(groupby-datagen.R: id1..id6, v1..v3) with numpy, so the JAX package and
the port can load identical data from one seed.
"""

from __future__ import annotations

import numpy as np

H2O_COLUMNS = ("id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3")


def h2o_g1(n: int, k: int, seed: int) -> dict[str, np.ndarray]:
    """G1-shaped columns of ``n`` rows with ``k`` groups per low-cardinality
    id (the shape of ``bench.make_data``, drawn with numpy instead of
    jax.random): id1, id2, id4, id5 in [1, k]; id3, id6 in [1, n/k];
    v1 in [1, 5]; v2 in [1, 15] (int32); v3 = round(uniform·100, 6)
    (float32). No NAs."""
    rng = np.random.default_rng(seed)
    nk = max(n // k, 1)

    def ints(hi: int) -> np.ndarray:
        return rng.integers(1, hi + 1, n, dtype=np.int32)

    cols = {
        "id1": ints(k), "id2": ints(k), "id3": ints(nk),
        "id4": ints(k), "id5": ints(k), "id6": ints(nk),
        "v1": ints(5), "v2": ints(15),
    }
    v3 = rng.random(n, dtype=np.float32) * np.float32(100)
    cols["v3"] = np.round(v3, 6).astype(np.float32)
    return cols
