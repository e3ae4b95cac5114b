"""Filter = mask + stable compaction.

Counterpart of ``aquery2_tpu/ops/filter.py``. The JAX package keeps
fixed-capacity buffers and compacts through a stable argsort of the
negated mask; here ``torch.nonzero`` lists the selected rows in order,
which sizes its output and so is the one host sync (the count).
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(idx, count): the int64 indices of the True rows, in order, and
    how many there are."""
    idx = torch.nonzero(mask).squeeze(1)
    return idx, int(idx.shape[0])
