"""ops.join_ms_per_query: device ms of the general join per query.

The union of the device events launched inside the program's spans
``aq.join.<part>`` (translate, hash, sort, probe, expand, verify, outer,
compose; each event's CUDA runtime call linked to it by its correlation
id, qbench/spans.py), over the queries completed in the window. Nothing
where the program opened no such span or the trace has no device."""

from qbench import spans


def read(w):
    return spans.per_query_ms(w, lambda p: p.device_seconds(
        lambda name: name.startswith("join.")))
