"""Synthetic data generators.

``h2o_g1`` makes the h2o db-benchmark G1 group-by table
(groupby-datagen.R: id1..id6, v1..v3), ``h2o_dim`` the dimension table
that the h2o join queries qj and qjg join it with (``bench.make_data``'s
``dim``), and ``trades`` the trades benchmark table (the JAX package's
``datagen.trades_table``) with numpy, so the JAX package and the port can
load identical data from one seed.
"""

from __future__ import annotations

import numpy as np

from aquery2_tpu_torch.storage.table import StringDict

H2O_COLUMNS = ("id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3")
TRADES_COLUMNS = ("stocksymbol", "time", "quantity", "price")


def h2o_g1(n: int, k: int, seed: int, nas: int = 0) -> dict[str, np.ndarray]:
    """G1-shaped columns of ``n`` rows with ``k`` groups per low-cardinality
    id (the shape of ``bench.make_data``, drawn with numpy instead of
    jax.random): id1, id2, id4, id5 in [1, k]; id3, id6 in [1, n/k];
    v1 in [1, 5]; v2 in [1, 15] (int32); v3 = round(uniform·100, 6)
    (float32).

    nas > 0 is the h2o NA variant (G1_1e7_1e1_5_0 for nas=5), NULLed as
    the db-benchmark's groupby-datagen.R does: in each of id1..id6 every
    row of int(u · nas / 100) of its u distinct values, drawn without
    replacement (so at k=10 the low-cardinality ids get none below
    nas=10), and in each of v1..v3 int(n · nas / 100) rows. The NAs are
    drawn after the values, so the values equal those of nas=0 from the
    same seed. A column that gets NULLs is a numpy masked array, masked
    where NULL; the others stay plain arrays."""
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
    if nas > 0:
        for nm in H2O_COLUMNS[:6]:
            u = np.unique(cols[nm])
            nna = len(u) * nas // 100
            if nna:
                null = np.isin(cols[nm], rng.choice(u, nna, replace=False))
                cols[nm] = np.ma.masked_array(cols[nm], mask=null)
        nna = n * nas // 100
        for nm in H2O_COLUMNS[6:] if nna else ():
            null = np.zeros(n, bool)
            null[rng.choice(n, nna, replace=False)] = True
            cols[nm] = np.ma.masked_array(cols[nm], mask=null)
    return cols


def h2o_dim(n: int, k: int, seed: int) -> dict[str, np.ndarray]:
    """The dim table of ``bench.make_data`` for an ``h2o_g1(n, k, ...)``
    source, drawn with numpy: nk // 10 rows (nk = n / k, the id3 domain),
    unique int32 keys id3 = (10 i + 1) % nk + 1, a strided sample of a
    tenth of id3's values, and an int32 weight w in [1, 99] drawn from
    seed + 1."""
    nk = max(n // k, 1)
    dsize = max(nk // 10, 1)
    id3 = ((np.arange(dsize) * 10 + 1) % nk + 1).astype(np.int32)
    w = np.random.default_rng(seed + 1).integers(1, 100, dsize,
                                                 dtype=np.int32)
    return {"id3": id3, "w": w}


def trades(n: int, n_symbols: int = 100, seed: int = 7
           ) -> tuple[dict[str, np.ndarray], StringDict]:
    """The trades table of the reference benchmark (load_data.a):
    stocksymbol (int32 codes into the returned StringDict of "S0000"…),
    time (sorted int32), quantity and price (int32): the arrays of the JAX
    package's ``datagen.trades_table`` from the same seed. Load with
    ``Table.from_numpy(name, arrays, {"stocksymbol": types.StrT},
    dictionaries={"stocksymbol": d}, device=...)``."""
    rng = np.random.default_rng(seed)
    d = StringDict([f"S{i:04d}" for i in range(n_symbols)])
    sym = rng.integers(0, n_symbols, n).astype(np.int32)
    t = np.sort(rng.integers(0, max(n // 10, 10), n)).astype(np.int32)
    qty = rng.integers(1, 1000, n).astype(np.int32)
    price = rng.integers(1, 500, n).astype(np.int32)
    return {"stocksymbol": sym, "time": t, "quantity": qty,
            "price": price}, d
