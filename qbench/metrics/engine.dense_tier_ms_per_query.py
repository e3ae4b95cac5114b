"""engine.dense_tier_ms_per_query: device ms of the dense group-by tier
per query.

The union of the device events launched inside the program's spans
``aq.groupby.dense`` (each event's CUDA runtime call linked to it by its
correlation id, qbench/spans.py), over the queries completed in the
window: the dense tier's work whatever kernels implement it. Nothing
where the program opened no such span (a program without spans, or no
dense query) or the trace has no device."""

from qbench import spans


def read(w):
    return spans.per_query_ms(w, lambda p: p.device_seconds(
        lambda name: name == "groupby.dense"))
