"""device.idle_share: the share of the window the device is idle, %.

1 - (the union of the intervals of the device's events in the traced
window, over the window's length), the harness's pauses left out of
both (qbench/trace.py)."""


def read(w):
    if not w.window_s or not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
