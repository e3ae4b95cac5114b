"""Query execution on torch tensors.

  executor.py       statement execution against a Session
  fused_groupby.py  the grouped-aggregation path (dense and packed tiers)
"""
