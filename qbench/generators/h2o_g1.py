"""db-benchmark's group-by table G1, made on the device from the run's
seed.

The shapes of groupby-datagen.R (h2oai/db-benchmark, _data/), as the
program's own generator has them (``aquery2_tpu_torch/utils/datagen.py``:
``h2o_g1``; a frozen copy, so that a change there does not move the
benchmark), drawn with a ``torch.Generator`` on the device in one call a
column instead of numpy's on the host. ``rows`` rows: id1, id2, id4, id5
in [1, k]; id3, id6 in [1, rows / k]; v1 in [1, 5]; v2 in [1, 15]
(int32); v3 = round(uniform * 100, 6) as a double (float64), as
groupby-datagen.R writes it.

The same seed on the same kind of device gives the same table, column by
column in the order above, so the reference can make it again after the
window.
"""

from __future__ import annotations

import torch

STRINGS: dict[str, list[str]] = {}       # no string columns


def make(cfg: dict, seed: int, device):
    """Yield ("source", {column: tensor})."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, k = cfg["rows"], cfg["k"]
    nk = max(n // k, 1)

    def ints(hi: int) -> torch.Tensor:
        return torch.randint(1, hi + 1, (n,), generator=g, device=device,
                             dtype=torch.int32)

    source = {}
    for name, hi in (("id1", k), ("id2", k), ("id3", nk), ("id4", k),
                     ("id5", k), ("id6", nk), ("v1", 5), ("v2", 15)):
        source[name] = ints(hi)
    v3 = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    source["v3"] = torch.round(v3.mul_(100), decimals=6)
    yield "source", source


def scaled(cfg: dict, rows: int) -> dict:
    """cfg at rows rows."""
    return {**cfg, "rows": rows}
