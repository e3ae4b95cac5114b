"""Operators on torch tensors.

  kernels.py  the hand-written CUDA kernels (csrc/) and their plain versions
  scan.py     segmented running sum/min/max, dispatched to the kernels
  reduce.py   the group-by reductions: dense (segment_reduce) and over
              key-sorted rows (sorted_group_reduce)
  agg.py      whole-column aggregates
  filter.py   mask compaction
  ragged.py   vector-column (CSR) gathers
  hashing.py  dense key packing and 64-bit hashes
"""
