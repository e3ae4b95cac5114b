"""kernels.roofline_share: the hand kernels' share of their roofline, %.

The bound of every hand-kernel call of the traced window (its bytes,
counted from the call's logical inputs and outputs by
``qbench/roofline.py``, over the card's HBM rate), summed, over the
device time of the hand kernels' launches (the events named as
``roofline.DEVICE_NAMES``), summed. Nothing where no hand kernel ran or
the card's peak is not in the table."""

from qbench import roofline


def read(w):
    secs, n = w.device_seconds(roofline.is_hand_kernel)
    if not n or not w.kernel_calls or w.hbm_bytes_per_s is None:
        return None
    total = sum(b for _, b in w.kernel_calls)
    return 100.0 * roofline.bound_s(total, w.hbm_bytes_per_s) / secs
