"""Synthetic data generators.

``h2o_g1`` makes the h2o db-benchmark G1 group-by table
(groupby-datagen.R: id1..id6, v1..v3), ``h2o_dim`` the dimension table
that the h2o join queries qj and qjg join it with (``bench.make_data``'s
``dim``), ``h2o_j1`` the db-benchmark's four join tables (J1, x, small,
medium and big), ``trades`` the trades benchmark table (the JAX
package's ``datagen.trades_table``), ``stock_csv``, ``base_csv`` and
``tick_hist_csv`` the CSV files of the reference's best_profit.a, and
``electricity_csv`` the demo's CSV batches, with numpy, so the JAX
package and the port can load identical data from one seed.
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


def _split_keys(m: int, rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """join-datagen.R's split_xlr: a permutation of 1.1·m keys cut into
    the shared 0.9·m, the left table's own 0.1·m and the right table's
    own 0.1·m."""
    key = (rng.permutation(m + m // 10) + 1).astype(np.int32)
    shared = m - m // 10
    return key[:shared], key[shared:m], key[m:]


def _sample_all(keys: np.ndarray, size: int, rng) -> np.ndarray:
    """join-datagen.R's sample_all: every key once, the rest of size drawn
    with replacement, shuffled."""
    y = np.concatenate([keys, rng.choice(keys, size - len(keys))])
    return rng.permutation(y)


def _id_strings(ids: np.ndarray) -> tuple[np.ndarray, StringDict]:
    """sprintf("id%.0f", ids) as int32 codes into a StringDict of its own
    (in ascending id order)."""
    u, inv = np.unique(ids, return_inverse=True)
    return inv.astype(np.int32), StringDict([f"id{k}" for k in u])


def h2o_j1(n: int, seed: int
           ) -> dict[str, tuple[dict[str, np.ndarray], dict[str, StringDict]]]:
    """The db-benchmark join task's tables (J1_<n>_NA_0_0), drawn with
    numpy as ``_data/join-datagen.R`` is recalled here (not copied from
    it): name → (arrays, dictionaries), the string columns as int32 codes
    with a StringDict each (load with ``Table.from_numpy(name, arrays,
    {c: types.StrT for c in dictionaries}, dictionaries=dictionaries,
    device=...)``).

    Three key domains of m1 = n/1e6, m2 = n/1e3 and m3 = n keys, each a
    permutation of 1.1·m keys: x draws from the shared 0.9·m and 0.1·m
    of its own, every right table from the same 0.9·m and 0.1·m of its
    own, so about 90% of keys match. Each column takes every key of its
    pool once and fills the rest with replacement.

    - x, n rows: id1..id3 (int32), id4..id6 = "id<k>" of id1..id3 (one
      dictionary each), v1 = round(uniform·100, 6) (float64);
    - small, m1 rows: id1, id4, v2;
    - medium, m2 rows: id1, id2, id4, id5, v2;
    - big, n rows: id1..id6, v2.

    What differs from the original: numpy's generator, not R's, so the
    values differ and only the shapes match; id1..id3 are int32 and
    id4..id6 dictionary-coded strings, where R has integers and factors;
    no NA variant; m1 and m2 are at least 10 so that a small n keeps
    several keys in each domain."""
    rng = np.random.default_rng(seed)
    m1, m2 = max(n // 10**6, 10), max(n // 10**3, 10)
    k1, k2, k3 = _split_keys(m1, rng), _split_keys(m2, rng), _split_keys(n, rng)

    def table(size: int, left: bool, ids: int):
        pools = [np.concatenate([k[0], k[1] if left else k[2]])
                 for k in (k1, k2, k3)[:ids]]
        arrays = {f"id{i + 1}": _sample_all(p, size, rng)
                  for i, p in enumerate(pools)}
        dicts = {}
        for i in range(ids):
            arrays[f"id{i + 4}"], dicts[f"id{i + 4}"] = _id_strings(
                arrays[f"id{i + 1}"])
        v = np.round(rng.random(size) * 100, 6)
        arrays["v1" if left else "v2"] = v
        return arrays, dicts

    x = table(n, True, 3)
    small = table(m1, False, 1)
    medium = table(m2, False, 2)
    big = table(n, False, 3)
    return {"x": x, "small": small, "medium": medium, "big": big}


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


def stock_csv(path: str, n_days: int = 100, n_symbols: int = 4,
              seed: int = 3) -> None:
    """data/stock.csv of the reference's tests/best_profit.a (ID varchar,
    timestamp int, tradeDate date, price int): the JAX package's
    ``datagen.stock_csv``, byte for byte."""
    rng = np.random.default_rng(seed)
    syms = [chr(ord("S") + i) for i in range(n_symbols)]
    with open(path, "w") as f:
        f.write("ID,timestamp,tradeDate,price\n")
        ts = 0
        for day in range(n_days):
            date = f"2003-01-{(day % 28) + 1:02d}"
            for s in syms:
                for _ in range(rng.integers(1, 6)):
                    ts += 1
                    f.write(f"{s},{ts},{date},{rng.integers(1, 100)}\n")


def base_csv(path: str, n_symbols: int = 4, seed: int = 5) -> None:
    """data/base.csv of tests/best_profit.a (ID varchar, name varchar):
    each tick ID's name, one of them "x" (the script filters on it); the
    JAX package's ``datagen.base_csv``, byte for byte."""
    rng = np.random.default_rng(seed)
    syms = [chr(ord("S") + i) for i in range(n_symbols)]
    names = ["x"] + [f"n{i}" for i in range(1, n_symbols)]
    rng.shuffle(names)
    names[0] = "x"
    with open(path, "w") as f:
        f.write("ID,name\n")
        for s, nm in zip(syms, names):
            f.write(f"{s},{nm}\n")


def tick_hist_csv(tick_path: str, hist_path: str, n_symbols: int = 6,
                  n_days: int = 40, seed: int = 9) -> None:
    """data/tick-price-file.csv and data/hist-price-file.csv of
    tests/best_profit.a (the reference's tests/datagen_jose/tickgen.cpp
    and histgen.cpp), '|'-separated: TradedStocks(ID, SeqNo, TradeDate,
    TimeStamp, Type) and HistoricQuotes(ID, TradeDate, High, Low, Close,
    Open, volume); the JAX package's ``datagen.tick_hist_csv``, byte for
    byte."""
    rng = np.random.default_rng(seed)
    syms = [f"SYM{i:02d}" for i in range(n_symbols)]
    with open(tick_path, "w") as f:
        f.write("ID|SeqNo|TradeDate|TimeStamp|Type\n")
        seq = 0
        for day in range(n_days):
            date = f"2010-{(day // 28) + 1:02d}-{(day % 28) + 1:02d}"
            for s in syms:
                for _ in range(int(rng.integers(1, 4))):
                    seq += 1
                    hh, mm, ss = (int(rng.integers(9, 17)),
                                  int(rng.integers(0, 60)),
                                  int(rng.integers(0, 60)))
                    ty = "T" if rng.random() < 0.8 else "Q"
                    f.write(f"{s}|{seq}|{date}|{hh:02d}:{mm:02d}:{ss:02d}"
                            f"|{ty}\n")
    with open(hist_path, "w") as f:
        f.write("ID|TradeDate|HighPrice|LowPrice|ClosePrice|OpenPrice|"
                "volume\n")
        for day in range(n_days):
            date = f"2010-{(day // 28) + 1:02d}-{(day % 28) + 1:02d}"
            for s in syms:
                o = float(rng.uniform(10, 100))
                c = o * float(rng.uniform(0.95, 1.05))
                hi = max(o, c) * 1.01
                lo = min(o, c) * 0.99
                f.write(f"{s}|{date}|{hi:.2f}|{lo:.2f}|{c:.2f}|{o:.2f}"
                        f"|{int(rng.integers(1000, 100000))}\n")


def electricity_csv(path: str, n: int = 250, n_features: int = 7,
                    seed: int = 11) -> None:
    """A LOAD COMPLEX DATA file of the demo's electricity batches,
    (x vecdouble, y int64) with ';' between a vector's values: the JAX
    package's ``datagen.electricity_csv``, byte for byte."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            y = int(rng.integers(0, 2))
            x = rng.normal(loc=3.0 * y, scale=1.0, size=n_features)
            f.write(";".join(f"{v:.5f}" for v in x) + f",{y}\n")
