"""aquery2_tpu_torch — the AQuery engine in PyTorch, for an NVIDIA H100.

A port of ``aquery2_tpu`` (the JAX package, which stays the reference):
the same dialect, the same ``connect()`` / ``execute()`` / ``Result``
surface and the same results, on torch tensors. The kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA here
(``csrc/``, bound in ``ops/kernels.py``). This package imports torch and
numpy, never jax.

    >>> import aquery2_tpu_torch as aq
    >>> db = aq.connect(device="cpu")
    >>> db.execute("CREATE TABLE t(a INT, b INT)")
    >>> db.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    >>> db.execute("SELECT a, sum(b) FROM t GROUP BY a").rows()
    [(1, 2), (3, 4)]
"""

from __future__ import annotations

from aquery2_tpu_torch.session import Session, connect
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.table import Column, Table

__version__ = "0.1.0"

__all__ = ["Session", "connect", "Table", "Column", "Result", "__version__"]
