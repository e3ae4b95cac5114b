"""engine.host_syncs_per_query: host syncs the program makes per query.

torch's sync debug mode, set to "warn" around each ``Session.execute``
call of the window (not around the harness's own synchronize), reports
each call that makes the host wait for the device (``.item()``, a copy
to the host, ``nonzero``, ...): a frozen copy of ``chip_smoke.py``'s
``count_syncs``. Their number over the queries completed in the
window."""


def read(w):
    if not w.queries or not w.device:
        return None                 # no card: the mode reports nothing
    return w.syncs / w.queries
