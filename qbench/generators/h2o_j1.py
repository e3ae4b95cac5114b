"""db-benchmark's join tables J1 (x, small, medium, big), made on the
device from the run's seed.

The shapes of join-datagen.R (h2oai/db-benchmark, _data/), as the
program's own generator has them (``aquery2_tpu_torch/utils/datagen.py``:
``h2o_j1``; a frozen copy), drawn with a ``torch.Generator`` on the
device instead of numpy's on the host. Three key domains of m1 = rows /
1e6, m2 = rows / 1e3 and m3 = rows keys (m1 and m2 at least 10), each a
permutation of 1.1 m keys cut into a shared 0.9 m, the left table's own
0.1 m and the right tables' own 0.1 m, so about 90% of keys match. Each
key column takes every key of its pool once and fills the rest with
replacement, shuffled:

- x, rows rows: id1..id3 (int32), id4..id6 = "id<k>" of id1..id3, v1 =
  round(uniform * 100, 6) (float64);
- small, m1 rows: id1, id4, v2;  medium, m2 rows: id1, id2, id4, id5, v2;
- big, rows rows: id1..id6, v2.

A string column is yielded as the integers k of its strings "id<k>"
(``STRINGS`` names them, ``STRING_FORMAT`` spells them): the harness
makes the dictionary the program loads, and the reference works on the
integers. The id6 columns of x and big, which no question joins or
compares on, share one dictionary (``SHARED``): one of 1.1 rows strings
where two of rows strings each would double the set-up that every run
pays. Every other string column has its own, as a load of each table
gives it. The same seed on the same kind of device gives the same tables.
"""

from __future__ import annotations

import torch

STRINGS = {"x": ["id4", "id5", "id6"], "small": ["id4"],
           "medium": ["id4", "id5"], "big": ["id4", "id5", "id6"]}
STRING_FORMAT = "id{}"
SHARED = {"id6": ("x", "big")}


def make(cfg: dict, seed: int, device):
    """Yield (table name, {column: tensor}) for x, small, medium, big."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = cfg["rows"]
    m1, m2 = max(n // 10**6, 10), max(n // 10**3, 10)

    def split(m: int):
        key = (torch.randperm(m + m // 10, generator=g, device=device)
               + 1).to(torch.int32)
        shared = m - m // 10
        return key[:shared], key[shared:m], key[m:]

    def sample_all(keys: torch.Tensor, size: int) -> torch.Tensor:
        extra = torch.randint(0, keys.shape[0], (size - keys.shape[0],),
                              generator=g, device=device)
        y = torch.cat([keys, keys[extra]])
        return y[torch.randperm(size, generator=g, device=device)]

    domains = (split(m1), split(m2), split(n))

    def table(size: int, left: bool, ids: int) -> dict[str, torch.Tensor]:
        cols = {}
        for i, k in enumerate(domains[:ids]):
            cols[f"id{i + 1}"] = sample_all(
                torch.cat([k[0], k[1] if left else k[2]]), size)
        for i in range(ids):
            cols[f"id{i + 4}"] = cols[f"id{i + 1}"]
        v = torch.rand(size, generator=g, device=device, dtype=torch.float64)
        cols["v1" if left else "v2"] = torch.round(v.mul_(100), decimals=6)
        return cols

    for name, size, left, ids in (("x", n, True, 3), ("small", m1, False, 1),
                                  ("medium", m2, False, 2),
                                  ("big", n, False, 3)):
        yield name, table(size, left, ids)


def scaled(cfg: dict, rows: int) -> dict:
    """cfg at rows rows (small and medium follow from rows)."""
    return {**cfg, "rows": rows}
