"""engine.plan_ms_per_query: the program's planning time per query, host
ms.

The union of the program's spans ``aq.plan`` (the SELECT rewrites, and
each tier's host work before its first launch: the group-by plan, the
tier choice, the NULL gate and the float-sum gate), less the parts its
``aq.sync.<site>`` spans cover (their wait on the device), over the
queries completed in the window (qbench/spans.py). Nothing where the
program opened no such span."""

from qbench import spans


def read(w):
    return spans.per_query_ms(w, lambda p: p.host_self_seconds(
        lambda name: name == "plan"))
