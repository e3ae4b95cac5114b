"""The card's peaks and the bytes of each hand-kernel call, counted from
the call's logical inputs and outputs (a copy of ``chip_smoke.py``'s
``scan_bytes``, ``bound_ms`` and its onehot_segment_sums count, so that
a change to the program does not move them).

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again:

- seg_cumsum_i64(flags, x): the flags (1 B a row) and x read, x's width
  written;
- seg_scan_multi(flags, lanes, ops): the flags and every lane read, every
  lane's width written;
- onehot_segment_sums(code, lanes, dp): the codes and every lane read,
  the [dp, k] int64 sums written;
- fused_running_stats(x): x read, its sum, min and max written.

Imports torch only: nothing of the program.
"""

from __future__ import annotations

import torch

# the memory rate of each card by the name torch.cuda.get_device_name
# gives: NVIDIA H100 SXM5 80GB, NVIDIA's data sheet, HBM3 at 3.35 TB/s
# (at the card's full 700 W power limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# the program's four hand kernels, by entry point of ops/kernels.py, and
# the device kernel names they launch (csrc/segscan.cuh's
# segscan_lookback for the three scans, csrc/onehot_segment_sums.cu's
# onehot_sums)
ENTRY_POINTS = ("seg_cumsum_i64", "seg_scan_multi", "onehot_segment_sums",
                "fused_running_stats")
DEVICE_NAMES = ("segscan_lookback", "onehot_sums")


def nbytes(x: torch.Tensor | None) -> int:
    return 0 if x is None else x.numel() * x.element_size()


def call_bytes(entry: str, args: tuple) -> int:
    """The bytes one call of a hand kernel moves, from its arguments."""
    if entry == "seg_cumsum_i64":
        flags, x = args[:2]
        return nbytes(flags) + 2 * nbytes(x)
    if entry == "seg_scan_multi":
        flags, xs = args[:2]
        return nbytes(flags) + 2 * sum(nbytes(x) for x in xs)
    if entry == "onehot_segment_sums":
        code, lanes, dp = args[:3]
        return (nbytes(code) + sum(nbytes(x) for x in lanes)
                + 8 * dp * len(lanes))
    if entry == "fused_running_stats":
        return 4 * nbytes(args[0])
    raise ValueError(f"not a hand kernel: {entry}")


def bound_s(total_bytes: int, hbm_bytes_per_s: float) -> float:
    """The least time in which the card moves total_bytes."""
    return total_bytes / hbm_bytes_per_s


def is_hand_kernel(name: str) -> bool:
    return any(d in name for d in DEVICE_NAMES)
