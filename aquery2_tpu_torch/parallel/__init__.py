"""The distribution layer: tables row-sharded over torch.distributed ranks.

Counterpart of ``aquery2_tpu/parallel/``. One rank (process) per shard,
every rank issuing the same statements (multihost.py); each rank holds
its contiguous block of every placed column (mesh.py) and every
collective goes through comm.py, which counts it.

  mesh.py          Mesh, placement, the dist tiers' local view, gathers
  comm.py          counted collectives, split-size exchanges
  multihost.py     joining the process group (tcp://, env://)
  launch.py        spawning a world of ranks on one machine
  dist_groupby.py  dense partials + one all_reduce; the shuffle tier
  dist_join.py     hash exchange + local probe: counts, inner, outer
  dist_scan.py     local scans + carries across ranks
  step.py          one combined step over every pattern above
"""

from aquery2_tpu_torch.parallel.mesh import make_mesh, shard_1d

__all__ = ["make_mesh", "shard_1d"]
