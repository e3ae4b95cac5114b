"""Query execution on torch tensors.

  executor.py       statement execution against a Session
  fused_groupby.py  the grouped-aggregation path (dense and packed tiers)
  fused_ordered.py  the ordered group-by (ASSUMING, running aggregates)
  fused_star.py     the star join into the fused group-by (qjg)
  fused_join.py     count(*) over an equi-join (qj)
"""
