"""frontend.parse_ms: the program's parse time per query, ms.

The change in ``Session.stats.parse_time`` (the front end's own timer
around ``parser.parse``, host time) over the window, over the queries
completed in it. A J1 query parses its CREATE TABLE AS and its DROP."""


def read(w):
    if not w.queries:
        return None
    return w.parse_s / w.queries * 1e3
