"""Query execution on torch tensors.

  executor.py       statement execution against a Session: the SELECT
                    tiers, then the general pipeline
  eval.py           expression evaluation of the general engine
  fused_scan.py     ungrouped scan, filter, order and limit
  groupby.py        the general engine's grouping (dense or sort)
  grouped_agg.py    the general engine's per-group aggregates
  fused_groupby.py  the grouped-aggregation path (dense and packed tiers)
  fused_ordered.py  the ordered group-by (ASSUMING, running aggregates)
  fused_star.py     the star join into the fused group-by (qjg)
  fused_join.py     count(*) over an equi-join (qj)
  dist_query.py     on a mesh: grouped and ungrouped aggregates
  dist_join_query.py  on a mesh: the exchanged equi-join, then a dist tier
  dist_scan.py      on a mesh: top-k and ordered scans
  dist_setop.py     on a mesh: EXCEPT, INTERSECT and DISTINCT of rows
  dist_ordered.py   on a mesh: the median and the ordered group-by, each
                    group's rows moved to one rank
  dist_window.py    on a mesh: OVER windows, each partition's rows moved
                    to one rank
"""
