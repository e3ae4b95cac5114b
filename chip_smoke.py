#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aquery2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any mismatch raises; there is no fallback):
  1. identify the card (nvidia-smi name and power limit, torch, CUDA);
  2. build the CUDA kernels from aquery2_tpu_torch/csrc/, and print
     ptxas' registers, spills, stack and static shared memory of each;
  3. each of the four kernels against its plain PyTorch version at the
     main path's scale (12,582,912 rows = bucket_size(1e7)): the
     segmented scans over every flag case REPEATS times (seg_scan_multi
     at every lane set it is timed at and every one the main path
     launches, 1 to 4 lanes of 32-bit and of 64-bit words),
     fused_running_stats over its cases REPEATS times (NaNs, a late lone
     NaN, tile edges, misaligned views), then timings (CUDA events: each
     kernel's median of 10, the device's time and the time with the
     host's gaps; each plain version one run after a warm-up,
     PHASE3_PLAIN_REPS) at the main path's shapes beside their bytes, their
     bound at the H100's 3.35 TB/s and the share of it reached:
     seg_cumsum_i64 (and an unsegmented torch.cumsum of the same column,
     not the same function), seg_scan_multi at q7's, q8's, 3 x 32-bit,
     max_stddevs' 2 x float64 and 3 x 64-bit lanes,
     onehot_segment_sums at q1's and q9's, and at q4's with v3 a DOUBLE
     (its float64 lane; checked with float64 lanes over the whole column,
     ragged, misaligned, one slot, NaN and ±inf, on both routes), beside
     the index_add_ calls that compute the same sums, which the port never
     makes,
     fused_running_stats;
  4. through connect(device="cuda").execute, each query checked against a
     numpy oracle with its kernel launches counted from zero, and the
     single-pass scans' calls tallied by instantiation (printed with
     their ptxas report):
     - the h2o queries q1 q2 q3 q4 q5 q6 q7 q8 q9 q10 qj qjg on
       G1_1e7_1e1_0_0 (1e7 rows, K=10, no NAs, seed 42) and its dim table
       (datagen.h2o_dim: 1e5 unique id3 keys, a weight w), and a
       computed-key query (the multikey tier); then the joins' parts,
       each called directly and checked: the count join's routes at qj's
       shape and at a domain near PERFECT_HASH_MAX_DOMAIN (the histogram
       and the sort), the star join's build and probe at qjg's shape,
       device times beside their bounds;
     - avgs(5, price) and MAX(stddevs(3, price)) under ASSUMING ASC time
       on a trades table of 1e7 rows and 100 symbols (seed 7);
     - q1 q2 q3 q4 q5 q7 q9 q10 on G1_1e7_1e1_5_0 (datagen.h2o_g1 with
       nas=5: 5% of the rows of v1..v3 NULL, every row of 5% of id3's and
       id6's distinct values NULL), the oracle skipping NULL arguments and
       putting the NULL keys in one group, last;
     then best_profit over a 1e7-row price column (the entry point of
     fused_running_stats, which no query calls), checked against numpy;
  5. the general engine (engine/executor.py, eval.py, fused_scan.py),
     through connect(device="cuda").execute, each query against numpy
     with its median of 3 warm runs and its launches counted from zero:
     on the trades table (a fresh load, 1e7 rows, 100 symbols, seed 7)
     COUNT(*), CREATE TABLE AS, UNION ALL, a range WHERE, a top-100
     ORDER BY, max(price - mins(price)) with and without ASSUMING DESC,
     avgs(3, price) under ASSUMING, first/last/last(mins) per symbol,
     SELECT DISTINCT and a DELETE/UPDATE/INSERT … SELECT sequence; then
     q6 and q8 on G1_1e7_1e1_5_0 (a fresh load), NULLs as SQL treats
     them (general_queries, general_oracle, na_general_oracle);
  6. the general join, set operations, DISTINCT aggregates and the
     fused tiers' float-sum gate, through connect(device="cuda").execute,
     each against numpy with its median of 3 warm runs, its host syncs
     (counted by reading the code, SYNCS, and as torch's sync debug mode
     reports them) and its launches: db-benchmark's join questions q1-q5
     on J1_1e7_NA_0_0 (datagen.h2o_j1, seed 42), each a CREATE TABLE AS
     checked by its row count and sum(v1), sum(v2); a grouped LEFT JOIN
     the star join declines; UNION, EXCEPT, INTERSECT, EXCEPT ALL and
     INTERSECT ALL row for row in the JAX package's order; count/sum
     (DISTINCT …) per id1 and count(DISTINCT id3); then q1, q3, q5 and
     q10 over a fresh G1_1e7_1e1_0_0 whose v3 holds a NaN, three +inf
     and three -inf (one id3 group both), against numpy's nan-aware sums,
     with the path that answered each;
  7. OVER windows and user FUNCTIONs, through connect(device="cuda")
     .execute, each against numpy with its median of 3 warm runs, its
     host syncs (read and measured) and its launches per run: on x =
     G1_1e7_1e1_0_0 db-benchmark's SQL of q8 (row_number in a derived
     table), sum and count(*) over id3's 1e6 partitions, a sum over the
     default RANGE frame's peers, percent_rank, cume_dist and ntile, and
     the AGGREGATION FUNCTION udfcov in q9's shape (rewritten into the
     fused dense tier); on trades rank, dense_rank and row_number, lag and
     lead, a 5-row moving avg (held to avgs(5, price)), max over +-5 rows
     and a running min, and a scalar FUNCTION f inlined into sum(); on x
     = G1_1e7_1e1_5_0 count and avg over +-2 rows of the 5%-NULL v3;
  8. AGGREGATION FUNCTION bodies that the accumulation-loop rewrite
     declines, through connect(device="cuda").execute, each against a
     numpy oracle that runs the body's loop one position at a time over
     all groups at once, with its median of 3 warm runs, its host syncs
     (read from the code, udf_syncs, and measured), its route in
     session.stats.udf_paths ("traced" alone) and its launches
     (u_ewma one run, its synchronizing calls counted in that run): on
     x = G1_1e7_1e1_0_0 covariances2 (tests/test_udf_device.py) per id3,
     1e6 groups (a vector result, if and for, x[i - w], slices),
     clipsum (an if inside a for) per id3 and per (id4, id6) under
     WHERE v1 > 2, all through the general pipeline; on trades cut to
     2.5e6 rows (PHASE8_TRADES) ewma per symbol (100 series of about
     2.5e4 rows: a loop of about 2.5e4
     host driven passes); then io_trades: that table written as CSV
     with a header under a temporary directory, LOAD DATA INFILE into a
     new table (every column equal to the generated arrays, the load's
     seconds and rows per second), ewma on it equal to the run on the
     generated table, and a grouped sum INTO OUTFILE read back with
     numpy; io_h2o_na: G1_1e7_1e1_5_0 written as CSV with its NULLs as
     empty cells and LOADed, every column's values and NULLs equal;
  9. each query launched its path's kernel: onehot_segment_sums (the
     dense tier, qjg's group-by), seg_cumsum_i64 (packed and multikey
     sums, integer running sums, g_moving's windowed sum, set operations'
     run counts, DISTINCT counts and sums), seg_scan_multi (min/max, q8's
     positions, the float64 running sums, mins in g_best, g_best_desc
     and g_firstlast, the general engine's float sums), and best_profit
     fused_running_stats, the windows seg_scan_multi (positions,
     partition ends, min/max, float64 frame sums) and seg_cumsum_i64
     (integer frame sums, counts, dense_rank), udfcov
     onehot_segment_sums, io_trades' INTO OUTFILE query
     onehot_segment_sums (the dense tier); qj, the J1 questions and the
     batched FUNCTION bodies launch none (no TPU
     kernel computes a join), q6 and q8 on the 5%-NULL variant their
     group sums and counts by seg_cumsum_i64 and seg_scan_multi (q8 the
     first only), and the other general queries' launches are recorded;
     q1-q10, qj and qjg launched exactly what they launched before the
     fused tiers' float-sum gate existed (MAIN_PATH_LAUNCHES);
 10. services and surfaces, through connect(device="cuda"), under a
     temporary directory in build/aquery2_tpu_torch/: stored procedures
     s_q1 and s_q3 (h2o q1 and q3 over the table stream, each into a
     table), s_big (the stream holds half of G1_1e7_1e1_0_0's rows) and
     s_q7; the conditional triggers t1 (s_q1) and t3 (s_q3 when s_big)
     fire on the worker thread while x streams into stream in 10 batches
     of about 1e6 rows (INSERT … SELECT … WHERE id4 = b; the tenth by LOAD
     DATA INFILE of its rows as CSV, the native route), each batch's
     statement wall and the time until its actions were done printed,
     s1 (and s3, once half the rows are in) against numpy after each,
     and each batch's launches exactly q1's (and q3's) per-run counts of
     phase 4 (onehot_segment_sums 1, seg_cumsum_i64 3); the interval
     trigger t7 (s_q7, every 200 ms) fires at least 3 times, stops once
     dropped, s7 against numpy, seg_scan_multi once a firing; SQLite
     (attach ":memory:", backend_append of s1 and 1e6 rows, a GROUP BY
     there back into a device table, equal to the port's); LOAD MODULE of
     sdk/example_module.cpp (mydiv, mulvec over 1e6 rows) against numpy;
     the demo (aquery2_tpu_torch.demo) on the card, accuracy above 0.8;
     `python -m aquery2_tpu_torch` on a #!aquery script (a procedure,
     stats, engine status, the same GROUP BY after `engine cpu` and
     `engine cuda`: equal); an AqServer and a client running q1 over 1e6
     rows; no trigger logged an error and close() left no trigger
     thread alive. Phase 8's io_h2o_na takes the native route; the
     loadtxt route is timed on the same file beside it;
 11. the mesh (aquery2_tpu_torch.parallel): phase 4's G1_1e7_1e1_0_0,
     dim table and trades (1e7 rows, 100 symbols, seed 7: the int32
     codes, the 100-string dictionary beside them) and phase 6's
     J1_1e7_NA_0_0 (its numeric columns) written as .npy files under
     build/, which each rank maps; four ranks spawned
     (parallel/launch.py) after the parent built the kernels: on one
     card all four on cuda:0 over gloo (whose collectives the comm layer
     stages through host memory), one rank a card over NCCL where the
     machine shows four; each rank's backend, world and device printed.
     Each rank places every table (its quarter: 3,145,728 rows of
     12,582,912) and runs, through its mesh session, q1-q10 (q6's median
     and q8's ASSUMING subvec with each group's rows moved to one rank,
     engine/dist_ordered.py), qj, qjg, phase 7's w_partition and w_peers
     over source (each partition's rows moved to one rank,
     engine/dist_window.py), phase 4's avgs and max_stddevs on trades,
     an ungrouped aggregate, a top-100 ORDER BY and a LIMIT-less
     ordered scan, a CASE without ELSE (the gathered fallback), two J1
     questions (x JOIN small / medium USING …) as CREATE TABLE AS,
     EXCEPT, INTERSECT ALL and a UNION's DISTINCT: rank 0 checks each
     answer against the phase-4/6/7 numpy oracle, every rank's answer
     and route (dist_spmd / dist_fallback and the reason) must agree,
     and each rank must launch each query's kernels (MESH_KERNEL); a
     warm run's wall on rank 0 (host clock, a synchronize and a
     barrier) and its collectives (last_query_comm) are printed. Four
     ranks sharing one card measure correctness and traffic, not
     scaling;
 12. the h2o main path at the JAX bench's own size (bench.py's default
     --rows 1e8, BASELINE.md's G1-1e8 metric): q1-q10, qj and qjg
     through connect(device="cuda").execute over G1_1e8
     (datagen.h2o_g1(1e8, 10, 42): every published width, nothing cut)
     and its dim table (1e6 id3 keys) at the capacity 100,663,296: each
     query's first run and median of 3 warm runs, its device memory
     peak, its launches over the 4 runs equal to MAIN_PATH_LAUNCHES
     (launches_1e8: q10's second sort pass added), its tiers equal to
     phase 4's (PlanProbe), its key words, sort passes and
     float_sums_fit decisions printed (q10: 3 words and 2 sort
     passes, asserted), its answer against the numpy oracle (column
     arrays, never rows()) and the oracle's seconds; then
     onehot_segment_sums, seg_cumsum_i64 and seg_scan_multi at q9's,
     q3's and q7's inputs against their plain versions (exactly), and
     onehot_segment_sums at q4's with v3 a DOUBLE (integer lanes exactly,
     the float64 lane within ONEHOT_F64_RTOL normwise), and
     radix_sort_pairs at q10's two packs (28 bits as a 32-bit key, 37 as
     a 64-bit one) and at q6's and q8's float64 sorts of v3 as a DOUBLE
     (ascending and descending; keys and permutation exactly), each timed
     beside its bound, and the process's peak RSS.
The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
no CUDA card is available or the package is missing.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from aquery2_tpu_torch import config, connect
from aquery2_tpu_torch import types as T
from aquery2_tpu_torch.engine import executor as E
from aquery2_tpu_torch.engine import fused_groupby, fused_join, fused_star
from aquery2_tpu_torch.engine import join as J
from aquery2_tpu_torch.ops import kernels as K
from aquery2_tpu_torch.ops import ragged
from aquery2_tpu_torch.ops import scan as S
from aquery2_tpu_torch.ops.filter import compact_indices
from aquery2_tpu_torch.storage import csvio
from aquery2_tpu_torch.storage.result import Result
from aquery2_tpu_torch.storage.table import Column, StringDict, Table
from aquery2_tpu_torch.utils.datagen import h2o_dim, h2o_g1, h2o_j1, trades

ROWS = 10_000_000
CAP = 12_582_912                 # config.bucket_size(1e7)
K_GROUPS = 10
SEED = 42
QUERIES = {                      # bench.QUERIES, and a computed key
    "q1": "SELECT id1, sum(v1) AS v1 FROM source GROUP BY id1",
    "q2": "SELECT id1, id2, sum(v1) AS v1 FROM source GROUP BY id1, id2",
    "q3": "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM source GROUP BY id3",
    "q4": ("SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 "
           "FROM source GROUP BY id4"),
    "q5": ("SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 "
           "FROM source GROUP BY id6"),
    "q6": ("SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd "
           "FROM source GROUP BY id4, id5"),
    "q7": ("SELECT id3, max(v1) - min(v2) AS range_v1_v2 FROM source "
           "GROUP BY id3"),
    "q8": ("SELECT id6, subvec(v3, 0, 2) AS largest2_v3 FROM source "
           "ASSUMING DESC v3 GROUP BY id6"),
    "q9": ("SELECT id2, id4, pow(corr(v1, v2), 2) AS r2 FROM source "
           "GROUP BY id2, id4"),
    "q10": ("SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, "
            "count(*) AS cnt FROM source GROUP BY id1, id2, id3, id4, id5, id6"),
    "qj": "SELECT count(*) FROM source s, dim d WHERE s.id3 = d.id3",
    "qjg": ("SELECT d.w, count(*) AS c, sum(s.v1) AS sv FROM source s, dim d "
            "WHERE s.id3 = d.id3 GROUP BY d.w"),
    "multikey": ("SELECT id1 * 100 + id4 AS k, sum(v1) AS s, max(v3) AS mx "
                 "FROM source GROUP BY id1 * 100 + id4"),
}
TRADES = {
    "avgs": ("SELECT stocksymbol, avgs(5, price) AS a FROM trades "
             "ASSUMING ASC time GROUP BY stocksymbol"),
    "max_stddevs": ("SELECT stocksymbol, MAX(stddevs(3, price)) AS m "
                    "FROM trades ASSUMING ASC time GROUP BY stocksymbol"),
}
ONEHOT_SHAPES = ("q1", "q2", "q4", "q9", "qjg")   # the dense tier
NAS_QUERIES = ("q1", "q2", "q3", "q4", "q5", "q7", "q9", "q10")
KEYS = {"q1": ["id1"], "q2": ["id1", "id2"], "q3": ["id3"], "q4": ["id4"],
        "q5": ["id6"], "q6": ["id4", "id5"], "q7": ["id3"], "q8": ["id6"],
        "q9": ["id2", "id4"],
        "q10": ["id1", "id2", "id3", "id4", "id5", "id6"]}
# the kernels each query must launch
MAIN_KERNEL = {"q1": ["onehot_segment_sums"], "q2": ["onehot_segment_sums"],
               "q4": ["onehot_segment_sums"], "q9": ["onehot_segment_sums"],
               "q3": ["seg_cumsum_i64"], "q5": ["seg_cumsum_i64"],
               "q6": ["seg_cumsum_i64"], "q10": ["seg_cumsum_i64"],
               "q7": ["seg_scan_multi"], "q8": ["seg_scan_multi"],
               "qjg": ["onehot_segment_sums"], "qj": [],
               "multikey": ["seg_cumsum_i64", "seg_scan_multi"],
               "avgs": ["seg_cumsum_i64", "seg_scan_multi"],
               "max_stddevs": ["seg_scan_multi"],
               # the general engine (phase 5): a kernel each must launch,
               # [] where the launches are only recorded
               "g_count": [], "g_ctas": [], "g_union": [], "g_range": [],
               "g_topk": [], "g_distinct": [], "g_dml": [],
               "g_best": ["seg_scan_multi"],
               "g_best_desc": ["seg_scan_multi"],
               "g_moving": ["seg_cumsum_i64"],
               "g_firstlast": ["seg_scan_multi"],
               # the group sums and counts read at group ends of scans
               "q6@5pct_NA": ["seg_cumsum_i64", "seg_scan_multi"],
               "q8@5pct_NA": ["seg_cumsum_i64"],
               # phase 6: the joins, set operations, DISTINCT aggregates
               # and the non-finite float sums
               "j1_q1": [], "j1_q2": [], "j1_q3": [], "j1_q4": [],
               "j1_q5": [],
               "j1_outer_grouped": ["seg_scan_multi"],   # sum of float64 v1
               "set_union": [], "set_except": ["seg_cumsum_i64"],
               "set_intersect": ["seg_cumsum_i64"],
               "set_except_all": ["seg_cumsum_i64"],
               "set_intersect_all": ["seg_cumsum_i64"],
               "distinct_grouped": ["seg_cumsum_i64"],
               "distinct_ungrouped": [],
               "q1@nonfinite": ["onehot_segment_sums"],
               "q3@nonfinite": ["seg_cumsum_i64", "seg_scan_multi"],
               "q5@nonfinite": ["seg_cumsum_i64", "seg_scan_multi"],
               "q10@nonfinite": ["seg_scan_multi"],
               # phase 7: a window's positions and partition ends are
               # int32 scans (seg_scan_multi), its integer sums and counts
               # int64 ones (seg_cumsum_i64); udfcov is rewritten into
               # the fused dense tier's sums; f's float64 group sums
               "w_q8": ["seg_scan_multi"],
               "w_partition": ["seg_scan_multi", "seg_cumsum_i64"],
               "w_peers": ["seg_scan_multi", "seg_cumsum_i64"],
               "w_dist": ["seg_scan_multi"],
               "udf_cov": ["onehot_segment_sums"],
               "w_rank": ["seg_scan_multi", "seg_cumsum_i64"],
               "w_lag": ["seg_scan_multi"], "w_moving": ["seg_scan_multi"],
               "w_extreme": ["seg_scan_multi", "seg_cumsum_i64"],
               "udf_scalar": ["seg_scan_multi"],
               "w_nulls": ["seg_scan_multi", "seg_cumsum_i64"],
               # phase 8: a batched FUNCTION body is torch ops (its
               # grouping too: the general dense grouping); io_trades'
               # INTO OUTFILE query is the fused dense tier
               "u_cov2": [], "u_clip": [], "u_clip_where": [], "u_ewma": [],
               "io_trades": ["onehot_segment_sums"]}
# phase 4's launches over its 4 runs of each h2o query, as an H100 run
# counted them before the fused tiers' float-sum gate existed (the gate
# must add none over finite data), with ops/sort.lexsort's radix sorts (one
# a run where the keys take one pack)
MAIN_PATH_LAUNCHES = {"q1": {"onehot_segment_sums": 4},
                      "q2": {"onehot_segment_sums": 4},
                      "q3": {"seg_cumsum_i64": 12, "radix_sort_pairs": 4},
                      "q4": {"onehot_segment_sums": 4},
                      "q5": {"seg_cumsum_i64": 16, "radix_sort_pairs": 4},
                      "q6": {"seg_cumsum_i64": 16, "radix_sort_pairs": 4},
                      "q7": {"seg_scan_multi": 4, "radix_sort_pairs": 4},
                      "q8": {"seg_scan_multi": 4, "radix_sort_pairs": 4},
                      "q9": {"onehot_segment_sums": 4},
                      "q10": {"seg_cumsum_i64": 8, "radix_sort_pairs": 4},
                      "qj": {}, "qjg": {"onehot_segment_sums": 4}}
# db-benchmark's join task (J1_1e7_NA_0_0), each question a CREATE TABLE
# AS as the benchmark's SQL solutions run it
J1 = {
    "j1_q1": "SELECT x.*, small.id4 AS small_id4, v2 FROM x JOIN small "
             "USING (id1)",
    "j1_q2": "SELECT x.*, medium.id1 AS medium_id1, medium.id4 AS "
             "medium_id4, medium.id5 AS medium_id5, v2 FROM x JOIN medium "
             "USING (id2)",
    "j1_q3": "SELECT x.*, medium.id1 AS medium_id1, medium.id4 AS "
             "medium_id4, medium.id5 AS medium_id5, v2 FROM x LEFT JOIN "
             "medium USING (id2)",
    "j1_q4": "SELECT x.*, medium.id1 AS medium_id1, medium.id2 AS "
             "medium_id2, medium.id4 AS medium_id4, v2 FROM x JOIN medium "
             "USING (id5)",
    "j1_q5": "SELECT x.*, big.id1 AS big_id1, big.id2 AS big_id2, big.id4 "
             "AS big_id4, big.id5 AS big_id5, big.id6 AS big_id6, v2 FROM x "
             "JOIN big USING (id3)",
}
J1_ON = {"j1_q1": ("small", "id1"), "j1_q2": ("medium", "id2"),
         "j1_q3": ("medium", "id2"), "j1_q4": ("medium", "id2"),
         "j1_q5": ("big", "id3")}      # q4's id5 strings are "id" + id2
SET_QUERIES = {
    "j1_outer_grouped": ("SELECT medium.id4, count(*), sum(x.v1) FROM x "
                         "LEFT JOIN medium USING (id2) GROUP BY medium.id4"),
    "set_union": "SELECT id2 FROM x UNION SELECT id2 FROM medium",
    "set_except": "SELECT id1, id2 FROM x EXCEPT SELECT id1, id2 FROM medium",
    "set_intersect": "SELECT id3 FROM x INTERSECT SELECT id3 FROM big",
    "set_except_all": "SELECT id2 FROM x EXCEPT ALL SELECT id2 FROM medium",
    "set_intersect_all": ("SELECT id3 FROM x INTERSECT ALL SELECT id3 "
                          "FROM big"),
    "distinct_grouped": ("SELECT id1, count(DISTINCT id3), sum(DISTINCT id2) "
                         "FROM x GROUP BY id1"),
    "distinct_ungrouped": "SELECT count(DISTINCT id3) FROM x",
}
NONFINITE = ("q1", "q3", "q5", "q10")
# phase 7: OVER windows and user FUNCTIONs, on x = G1_1e7_1e1_0_0, the
# trades table and x = G1_1e7_1e1_5_0
OVER_RANK = "OVER (PARTITION BY stocksymbol ORDER BY price DESC)"
OVER_TIME = "OVER (PARTITION BY stocksymbol ORDER BY time"
OVER_DIST = "OVER (PARTITION BY id1 ORDER BY v3)"
OVER_NULLS = ("OVER (PARTITION BY id1 ORDER BY id4 ROWS BETWEEN 2 PRECEDING "
              "AND 2 FOLLOWING)")
WINDOW_QUERIES = {
    # db-benchmark's own SQL of h2o q8
    "w_q8": ("SELECT id6, largest2_v3 FROM (SELECT id6, v3 AS largest2_v3, "
             "row_number() OVER (PARTITION BY id6 ORDER BY v3 DESC) AS "
             "order_v3 FROM x WHERE v3 IS NOT NULL) sub_query "
             "WHERE order_v3 <= 2"),
    "w_partition": ("SELECT id3, sum(v1) OVER (PARTITION BY id3) AS s, "
                    "count(*) OVER (PARTITION BY id3) AS c FROM x"),
    "w_peers": ("SELECT id4, id6, sum(v1) OVER (PARTITION BY id4 ORDER BY "
                "id6) AS s FROM x"),
    "w_dist": (f"SELECT id1, v3, percent_rank() {OVER_DIST} AS pr, "
               f"cume_dist() {OVER_DIST} AS cd, ntile(4) {OVER_DIST} AS nt "
               f"FROM x"),
    "udf_cov": "SELECT id2, id4, udfcov(v1, v2) FROM x GROUP BY id2, id4",
    "w_rank": (f"SELECT stocksymbol, price, rank() {OVER_RANK} AS rk, "
               f"dense_rank() {OVER_RANK} AS dr, row_number() {OVER_RANK} "
               f"AS rn FROM trades"),
    "w_lag": (f"SELECT stocksymbol, time, price - lag(price) {OVER_TIME}) "
              f"AS d, lead(price, 2, 0) {OVER_TIME}) AS ld FROM trades"),
    "w_moving": (f"SELECT stocksymbol, time, avg(price) {OVER_TIME} ROWS "
                 f"BETWEEN 4 PRECEDING AND CURRENT ROW) AS a FROM trades"),
    "w_extreme": (f"SELECT stocksymbol, time, max(price) {OVER_TIME} ROWS "
                  f"BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS mx, min(price) "
                  f"{OVER_TIME} ROWS UNBOUNDED PRECEDING) AS mn FROM trades"),
    "udf_scalar": ("SELECT stocksymbol, sum(f(price, quantity)) AS s FROM "
                   "trades GROUP BY stocksymbol"),
    "w_nulls": (f"SELECT id1, id4, v3, count(v3) {OVER_NULLS} AS c, "
                f"avg(v3) {OVER_NULLS} AS a FROM x"),
}
PHASE7 = (("h2o", ("w_q8", "w_partition", "w_peers", "w_dist", "udf_cov")),
          ("trades", ("w_rank", "w_lag", "w_moving", "w_extreme",
                      "udf_scalar")),
          ("nas", ("w_nulls",)))
UDFCOV = """AGGREGATION FUNCTION udfcov(x, y){
    sx := 0.; sy := 0.; sxy := 0.;
    l := _builtin_len;
    for (i := 0; i < l; i += 1) { sx += x[i]; sy += y[i]; sxy += x[i]*y[i]; }
    (sxy - sx * sy / l) / l
}"""
SCALAR_UDF = "FUNCTION f(p, q) { v := p * q; w := v / 100; w - p }"
# host syncs of one run of each phase-6 query, counted by reading the code
# (engine/join.py, executor.py, groupby.py, fused_scan.py): a join 2
# (candidates, pairs) + 1 per outer side; a string key's dictionary remap
# 1 (a host-to-device copy); a fused scan arm 1; _set_op 1 (its kept
# rows); a general GROUP BY 1 per key's stats until the keys' domain
# passes PERFECT_HASH_MAX_DOMAIN (q10: 4) + 1 per nullable key (its
# sentinel), then dense: torch.bincount 2 (it reads its input's minimum
# and maximum) + 1 (the group count), or sort: 1 (the group count) + 1
# (the offsets' host-to-device copy); _distinct is such a GROUP BY; the
# fused dense tier 1; the float summary of v3 once per load (not in a
# warm run)
SYNCS = {"j1_q1": 2, "j1_q2": 2, "j1_q3": 3, "j1_q4": 3, "j1_q5": 2,
         "j1_outer_grouped": 8, "set_union": 6, "set_except": 3,
         "set_intersect": 3, "set_except_all": 3, "set_intersect_all": 3,
         "distinct_grouped": 4, "distinct_ungrouped": 0,
         "q1@nonfinite": 1, "q3@nonfinite": 4, "q5@nonfinite": 4,
         "q10@nonfinite": 6,
         # phase 7: a general WHERE 1 (its kept rows; w_q8 has two); a
         # string partition key 1 (its rank table's host-to-device copy,
         # once per distinct PARTITION BY and ORDER BY); an integer key
         # column's stats 1, cached after the first run; the fused dense
         # tier 1; the general GROUP BY of a string key 4
         "w_q8": 2, "w_partition": 0, "w_peers": 0, "w_dist": 0,
         "udf_cov": 1, "w_rank": 1, "w_lag": 1, "w_moving": 1,
         "w_extreme": 1, "udf_scalar": 4, "w_nulls": 0}
# phase 8: AGGREGATION FUNCTION bodies the rewrite declines, on x =
# G1_1e7_1e1_0_0 and the trades table, and CSV in and out
COVARIANCES2 = """AGGREGATION FUNCTION covariances2(x, y, win){
    xmeans := 0.; ymeans := 0.; l := _builtin_len;
    if (l > 0) { xmeans := x[0]; ymeans := y[0]; _builtin_ret[0] := 0.; }
    w := win;
    if (w > l) w := l;
    for (i := 1, j:= 0; i < w; i := i+1) {
        xmeans += x[i]; ymeans += y[i];
        _builtin_ret[i] := avg (( x(0, i) - xmeans/i ) * (y(0, i) - ymeans/i ));
    }
    xmeans /= w; ymeans /= w;
    for (i := w; i < l; i += 1) {
        xmeans += (x[i] - x[i - w]) / w; ymeans += (y[i] - y[i - w]) / w;
        _builtin_ret[i] := avg (( x(i-w, i) - xmeans ) * (y(i - w, i) - ymeans ));
    }
    Null
}"""
CLIPSUM = """AGGREGATION FUNCTION clipsum(x, c){ s := 0.; l := _builtin_len;
    for (i := 0; i < l; i += 1) { if (x[i] > c) { s += c; }
    else { s += x[i]; } } s }"""
EWMA = """AGGREGATION FUNCTION ewma(x, a){ m := x[0]; l := _builtin_len;
    for (i := 0; i < l; i += 1) { m := a * x[i] + (1 - a) * m;
    _builtin_ret[i] := m; } Null }"""
UDF_QUERIES = {
    "u_cov2": "SELECT id3, covariances2(v1, v3, 4) FROM x GROUP BY id3",
    "u_clip": "SELECT id3, clipsum(v3, 50) AS s FROM x GROUP BY id3",
    "u_clip_where": ("SELECT id4, id6, clipsum(v3, 50) AS s FROM x WHERE "
                     "v1 > 2 GROUP BY id4, id6"),
    "u_ewma": ("SELECT stocksymbol, ewma(price, 0.1) FROM trades GROUP BY "
               "stocksymbol"),
}
COV2_RTOL, COV2_ATOL = 1e-9, 1e-12     # tests/test_udf_device.py's
CLIP_RTOL = EWMA_RTOL = 1e-12
GENERAL_NAS = ("q6", "q8")      # G1_1e7_1e1_5_0 through the general engine
FLOAT_RTOL = 1e-9       # float sums/averages vs the float64 numpy oracle
EXACT_SUMS_RTOL = {"r2": 1e-12}   # q9: exact int64 sums, float64 formula
ADD_F32_RTOL = 2e-5     # float32 'add' lanes: |err| ≤ this · running Σ|x|
RUN_SUM_TOL = 1e-5      # float32 running sums: |err| ≤ this · running Σ|x|
ADD_F64_TOL = 1e-12     # float64 'add' lanes: |err| ≤ this · running Σ|x|
ONEHOT_F64_RTOL = 1e-12  # onehot float64 lanes: normwise, adds reordered
# a float window frame's sum is a difference of prefix sums, S[hi] - S[lo]
# + x[lo], and the float add lanes are not bit-reproducible on the card:
# its error is bounded by this · the partition's running Σ|x| at hi, not
# by the frame's own value
FRAME_F64_TOL = 1e-12
# trades: the float64 running sums of integer prices are exact in any
# order (below 2^53), and the rest is the oracle's own sequence of
# correctly rounded operations; 1e-12 leaves room for one more rounding
TRADES_RTOL = 1e-12
REPEATS = 20            # runs of each scan per flag case (phase 3)
# phase 8's trades table (u_ewma, io_trades): a quarter of 1e7 rows, about
# 2.5e4 a series, so that ewma's host-driven loop (one pass a row of the
# longest series) keeps the whole script near 500 s
PHASE8_TRADES = ROWS // 4
# depth cuts paying for phase 12 (PERF.md §4): phase 3 times each plain
# version in one run after its warm-up (it took 10); phase 8 runs u_ewma
# once, counting its synchronizing calls in that run (it took 3 warm runs
# and a fifth run for the count)
PHASE3_PLAIN_REPS = 1
SLEEP_CYCLES = 2_000_000    # about 1 ms of the card's clock: longer than
                            # the host takes to enqueue one kernel call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet


_START = time.perf_counter()


def phase(name: str) -> None:
    """Print that a phase passed, with the seconds since the script
    started."""
    torch.cuda.synchronize()
    print(f"# {name} ({time.perf_counter() - _START:.1f} s)", flush=True)


def cuda_ms(fn, reps: int = 10, host_gaps: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of one fn() (after one
    warm-up). By default each run is queued behind a torch.cuda._sleep of
    SLEEP_CYCLES, so the device is still busy while the host enqueues it
    and the events time the device alone; with host_gaps=True the device
    also waits for the host's enqueueing (a wrapper's checks, allocations
    and ctypes call), as a bare pair of events around one call does."""
    fn()
    times = []
    for _ in range(reps):
        if not host_gaps:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    both_nan = got.isnan() & want.isnan() if got.is_floating_point() else None
    if got.dtype == torch.int64:
        diff = (got - want).abs()        # exact cases: 0 whatever the size
    else:
        diff = (got.double() - want.double()).abs()
    if both_nan is not None:
        diff = torch.where(both_nan, 0.0, diff)
        if bool((got.isnan() != want.isnan()).any()):
            return float("inf")
    return float(diff.max())


def flag_cases(rng, dev):
    """Flag arrays of the main path's densities plus lone flags: one in
    the middle of a tile with no flag in the 3,000-odd tiles before it
    (the longest look-back), one on the first row of a tile of each
    single-pass tile size, one on the last row."""
    cases = {"none": None}
    for name, p in (("1e-6", 1e-6), ("0.1", 0.1), ("0.999", 0.999)):
        cases[name] = torch.from_numpy(rng.random(CAP) < p).to(dev)
    lib = K.build()
    tile = lib.aq_seg_cumsum_i64_tile_rows()
    lone = torch.zeros(CAP, dtype=torch.bool, device=dev)
    lone[(CAP // tile - 2) * tile + tile // 2 + 3] = True
    cases["lone_mid"] = lone
    first = torch.zeros(CAP, dtype=torch.bool, device=dev)
    for i in range(8):
        t = lib.aq_seg_scan_multi_tile_rows(i % 4 + 1, i // 4)
        first[(CAP // t // 2 + 7 * i) * t] = True
    cases["tile_first_rows"] = first
    last = torch.zeros(CAP, dtype=torch.bool, device=dev)
    last[CAP - 1] = True
    cases["last_row"] = last
    return cases


def bound_ms(nbytes: int) -> float:
    """Least time to move nbytes at the H100's published HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bytes(f, xs) -> int:
    """A scan's bytes: flags and every lane read once, every lane's
    output written once."""
    return (0 if f is None else f.numel()) + 2 * sum(
        x.numel() * x.element_size() for x in xs)


def time_shape(label: str, kernel, plain, nbytes: int) -> dict:
    """Kernel times (CUDA events, median of 10) and the plain version's
    (one run after a warm-up: PHASE3_PLAIN_REPS) beside the bound of
    nbytes."""
    ms, pms = cuda_ms(kernel), cuda_ms(plain, reps=PHASE3_PLAIN_REPS)
    host = cuda_ms(kernel, host_gaps=True)
    b = bound_ms(nbytes)
    print(f"# {label}: kernel {ms:.4f} ms ({host:.4f} with the host's "
          f"gaps; median of 10), plain {pms:.4f} ms (one run; {CAP} rows); "
          f"{nbytes} "
          f"bytes ({nbytes / CAP:g} B/row), bound {b:.4f} ms at 3.35 TB/s, "
          f"{b / ms:.1%} of bound", flush=True)
    return {"shape": label, "ms": ms, "ms_with_host": host, "plain_ms": pms,
            "bytes": nbytes, "bound_ms": b, "share_of_bound": b / ms}


def check_repeated(name, kernel, plain, flags, close) -> float:
    """kernel(f) against plain(f) for every flag case, REPEATS times each
    (the plain version once per case): a missing fence shows as an
    occasional wrong carry. close(got, want, f) says whether one output
    matches. Returns the max |err|."""
    err = 0.0
    for case, f in flags.items():
        want = plain(f)
        for rep in range(REPEATS):
            for lane, (g, w) in enumerate(zip(kernel(f), want)):
                if g.dtype != w.dtype:
                    raise AssertionError(f"{name} lane {lane} dtype {g.dtype}")
                if not close(lane, g, w, f):
                    raise AssertionError(
                        f"{name} lane {lane} differs (flags {case}, run "
                        f"{rep}): max |err| {max_abs_err(g, w)}")
                err = max(err, max_abs_err(g, w))
    return err


def exact(lane, g, w, f) -> bool:
    """Equal, NaN where the plain version has NaN."""
    ok = torch.equal(g.isnan(), w.isnan()) if g.is_floating_point() else True
    return ok and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


def check_kernels(dev, data) -> list[dict]:
    rng = np.random.default_rng(SEED)
    flags = flag_cases(rng, dev)

    # int64 values near ±2^62: running sums wrap past ±2^63
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP)
    x64[rng.random(CAP) < 0.3] *= -1
    x64 = torch.from_numpy(x64).to(dev)
    err64 = check_repeated(
        "seg_cumsum_i64", lambda f: (K.seg_cumsum_i64(f, x64),),
        lambda f: (K.seg_cumsum_i64_plain(f, x64),), flags, exact)
    errm, err_w, timed_calls = check_multi(rng, dev, flags, x64)
    print(f"# seg_cumsum_i64 and seg_scan_multi (every lane set above) "
          f"equal to their plain versions over {len(flags)} flag cases, "
          f"{REPEATS} runs each (non-integer float32 adds within "
          f"{ADD_F32_RTOL}, float64 adds within {ADD_F64_TOL} of the "
          f"running sum of |x|)", flush=True)
    torch.cuda.synchronize()

    onehot_err, onehot_timed = check_onehot(rng, dev, data)
    run_err, run_timed = check_running(rng, dev)

    # the main path's shapes, at the q3/q7-like density of 0.1
    f = flags["0.1"]
    sum_row = time_shape(
        "seg_cumsum_i64, 1 x int64, density 0.1",
        lambda: K.seg_cumsum_i64(f, x64),
        lambda: K.seg_cumsum_i64_plain(f, x64), scan_bytes(f, (x64,)))
    sum_row["cumsum_ms"] = cuda_ms(lambda: torch.cumsum(x64, 0))
    print(f"# torch.cumsum of the same int64 column (unsegmented, not the "
          f"same function: the single-pass rate this card reaches): "
          f"{sum_row['cumsum_ms']:.4f} ms", flush=True)
    multi_shapes = [time_shape(
        f"seg_scan_multi, {label}, density 0.1",
        lambda: K.seg_scan_multi(f, lanes, lops),
        lambda: K.seg_scan_multi_plain(f, lanes, lops), scan_bytes(f, lanes))
        for label, lanes, lops in timed_calls]
    main = next(s for s in multi_shapes if "3 x 32-bit" in s["shape"])
    rows = [
        {"name": "seg_cumsum_i64", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_cumsum_i64.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:277",
         "max_abs_err": err64, "ms": sum_row["ms"],
         "ms_with_host": sum_row["ms_with_host"],
         "plain_ms": sum_row["plain_ms"], "bound_ms": sum_row["bound_ms"],
         "bound_by": "bytes", "share_of_bound": sum_row["share_of_bound"],
         "library_ms": None, "cumsum_ms": sum_row["cumsum_ms"]},
        {"name": "seg_scan_multi", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/seg_scan_multi.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:339",
         "max_abs_err": errm, "max_abs_err_64bit": err_w,
         "ms": main["ms"], "ms_with_host": main["ms_with_host"],
         "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": "bytes",
         "share_of_bound": main["share_of_bound"], "library_ms": None,
         "shapes": multi_shapes},
        {"name": "onehot_segment_sums", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/onehot_segment_sums.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:438",
         "max_abs_err": onehot_err, "bound_by": "bytes", **onehot_timed},
        {"name": "fused_running_stats", "route": "cuda",
         "source": "aquery2_tpu_torch/csrc/fused_running_stats.cu",
         "replaces": "aquery2_tpu/ops/pallas_kernels.py:73",
         "max_abs_err": run_err, "bound_by": "bytes",
         "library_ms": None, **run_timed},
    ]
    return rows


def check_multi(rng, dev, flags, x64):
    """seg_scan_multi against its plain version over the flag cases,
    REPEATS times each, for every lane set it is timed at and every one
    the main path launches (each (word width, lane count) is its own tile
    geometry): integer lanes (int64 values near ±2^62, so sums wrap),
    min/max with NaNs and integer-valued float adds exactly; a normal
    float32 add within ADD_F32_RTOL and a normal float64 add within
    ADD_F64_TOL of the running Σ|x| (another order of rounding, and
    another from run to run). Returns the max |err| of the 32-bit and of
    the 64-bit calls, and the (label, lanes, ops) of the timed shapes."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    xi = col(rng.integers(-2**31, 2**31 - 1, CAP).astype(np.int32))
    xf = col(rng.normal(size=CAP).astype(np.float32))
    xfn = xf.clone()
    xfn[col(rng.random(CAP) < 1e-4)] = float("nan")
    xa = col(rng.integers(0, 2, CAP).astype(np.float32))  # exact below 2^24
    v1 = col(rng.integers(1, 6, CAP).astype(np.int32))
    v2 = col(rng.integers(1, 16, CAP).astype(np.int32))
    ones = torch.ones(CAP, dtype=torch.int32, device=dev)
    xd = col(rng.normal(size=CAP) * 1e3)
    xdn = xd.clone()
    xdn[col(rng.random(CAP) < 1e-4)] = float("nan")
    xint = col(rng.integers(-2**20, 2**20, CAP).astype(np.float64))
    loose = {id(xf): ADD_F32_RTOL, id(xd): ADD_F64_TOL}
    # (label, lanes, ops, timed); the main path's: q7's min(v2), max(v1);
    # q8's (and avgs') in-group positions; the multikey query's float32
    # max; max_stddevs' float64 sums of x and x² and its float64 max
    calls = [
        ("q7: int32 min + int32 max", (v2, v1), ("min", "max"), True),
        ("q8: 1 x int32 add (positions)", (ones,), ("add",), True),
        ("1 x float32 max (multikey)", (xfn,), ("max",), False),
        ("1 x float32 add", (xf,), ("add",), False),
        ("3 x 32-bit (int32 max, float32 min, float32 add)",
         (xi, xfn, xa), ("max", "min", "add"), True),
        ("4 x 32-bit", (xi, xfn, xfn, xi), ("add", "min", "max", "min"),
         False),
        ("max_stddevs: 2 x float64 add", (xd, xint), ("add", "add"), True),
        ("max_stddevs: 1 x float64 max", (xdn,), ("max",), False),
        ("3 x 64-bit (int64 max, float64 min, float64 add)",
         (x64, xdn, xd), ("max", "min", "add"), True),
        ("4 x 64-bit int64", (x64, x64, x64, xint),
         ("add", "min", "max", "add"), False),
        ("4 x 64-bit float64", (xdn, x64, xd, xdn),
         ("min", "max", "add", "max"), False),
    ]
    scales = {}

    def close(xs, ops):
        def ok(lane, g, w, f):
            tol = loose.get(id(xs[lane]))
            if tol is None or ops[lane] != "add":
                return exact(lane, g, w, f)
            key = (id(xs[lane]), id(f))
            if key not in scales:
                scales[key] = K.seg_scan_multi_plain(
                    f, (xs[lane].abs().double(),), ("add",))[0]
            diff = (g.double() - w.double()).abs()
            return bool((diff <= tol * scales[key]).all())
        return ok

    err = {4: 0.0, 8: 0.0}
    for label, xs, ops, _ in calls:
        err[xs[0].element_size()] = max(err[xs[0].element_size()],
                                        check_repeated(
            f"seg_scan_multi, {label}",
            lambda f: K.seg_scan_multi(f, xs, ops),
            lambda f: K.seg_scan_multi_plain(f, xs, ops), flags,
            close(xs, ops)))
    scales.clear()
    return err[4], err[8], [c[:3] for c in calls if c[3]]


def capture_onehot(dev, data) -> dict:
    """The (code, lanes, dp, keywords) of the first onehot_segment_sums
    call of each dense query (q1 q2 q4 q9, and qjg's group-by) on
    G1_1e7_1e1_0_0 and its dim table: the main path's inputs, its lanes
    as fused_groupby._build_lanes builds them (the keyed form's: the
    stored columns)."""
    db = connect(device=dev)
    load(db, "source", data, dev)
    load(db, "dim", h2o_dim(ROWS, K_GROUPS, SEED), dev)
    calls = {}
    for q in ONEHOT_SHAPES:
        (code, lanes, dp), kw = capture_first(
            "onehot_segment_sums", lambda: db.execute(QUERIES[q]))
        calls[q] = (code, tuple(lanes), dp, kw)
    return calls


def capture_q4_double(dev, data):
    """The (code, lanes, dp, keywords) of q4's onehot_segment_sums call over
    the columns q4 reads, v3 a DOUBLE as db-benchmark's groupby-datagen.R
    writes it (datagen.h2o_g1 makes it float32): the kernel's float64 lane
    on the main path."""
    db = connect(device=dev)
    load(db, "source", {"id4": data["id4"], "v1": data["v1"],
                        "v2": data["v2"],
                        "v3": data["v3"].astype(np.float64)}, dev)
    (code, lanes, dp), kw = capture_first(
        "onehot_segment_sums", lambda: db.execute(QUERIES["q4"]))
    if [x.dtype for x in lanes].count(torch.float64) != 1:
        raise AssertionError(f"q4 with v3 a DOUBLE summed lanes of "
                             f"{[x.dtype for x in lanes]}")
    return code, tuple(lanes), dp, kw


def onehot_close(label: str, got, want, lanes) -> float:
    """got against want, two [dp, k] outputs of onehot_segment_sums over
    lanes: the integer and bool columns equal bit for bit; each float64
    column (read through .view(torch.float64)) NaN where want is NaN,
    equal where want is infinite or zero (signed zeros included), and its
    finite sums within ONEHOT_F64_RTOL normwise of want's (the same
    float64 adds in another order). Raises otherwise; returns the largest
    normwise error (0 without a float64 lane)."""
    f64 = [j for j, x in enumerate(lanes) if x.dtype == torch.float64]
    ints = [j for j in range(got.shape[1]) if j not in f64]
    if ints and not torch.equal(got[:, ints], want[:, ints]):
        raise AssertionError(f"onehot_segment_sums differs ({label}): max "
                             f"|err| {max_abs_err(got[:, ints], want[:, ints])}")
    err = 0.0
    for j in f64:
        g, w = got[:, j].view(torch.float64), want[:, j].view(torch.float64)
        fin, nan = w.isfinite(), w.isnan()
        inf, zero = ~fin & ~nan, w == 0
        if not (torch.equal(g.isnan(), nan) and torch.equal(g[inf], w[inf])
                and torch.equal(g[zero], w[zero])
                and torch.equal(g[zero].signbit(), w[zero].signbit())):
            raise AssertionError(f"onehot_segment_sums' float64 lane {j} "
                                 f"differs in its NaNs, infinities or zeros "
                                 f"({label})")
        e = float((g[fin] - w[fin]).norm()
                  / w[fin].norm().clamp_min(np.finfo(np.float64).tiny))
        if not e <= ONEHOT_F64_RTOL:
            raise AssertionError(f"onehot_segment_sums' float64 lane {j} "
                                 f"{e:.3e} normwise from the plain version "
                                 f"({label})")
        err = max(err, e)
    return err


def onehot_library(code, lanes, dp, **kw):
    """The library calls that compute onehot_segment_sums' function,
    prepared outside any timing (the port calls none of them): one
    index_add_ of the integer and bool columns (a keyed call's products
    and row count among them, over its slots as K.onehot_slots makes
    them, the dropped rows in a last slot cut off) as an [n, k] int64
    source and one float64 index_add_ a float64 lane. Returns the call,
    which gives the [dp, k] int64 output, float64 columns as their bits."""
    size = dp + 1 if "mins" in kw else dp
    code64 = (K.onehot_slots(code, dp, kw.get("keys", ()), kw["mins"],
                             kw["strides"], kw.get("row_mask"))
              if "mins" in kw else code.to(torch.int64))
    cols = (*lanes, *(lanes[a].to(torch.int64) * lanes[b].to(torch.int64)
                      for a, b in kw.get("products", ())),
            *((torch.ones_like(code64),) if kw.get("counts") else ()))
    f64 = [j for j, x in enumerate(cols) if x.dtype == torch.float64]
    ints = [j for j in range(len(cols)) if j not in f64]
    src = torch.stack([cols[j].to(torch.int64) for j in ints], 1)

    def library():
        out = torch.zeros(size, len(cols), dtype=torch.int64,
                          device=code.device)
        out[:, ints] = torch.zeros(size, len(ints), dtype=torch.int64,
                                   device=code.device).index_add_(
            0, code64, src)
        for j in f64:
            out[:, j] = torch.zeros(size, dtype=torch.float64,
                                    device=code.device).index_add_(
                0, code64, cols[j]).view(torch.int64)
        return out[:dp]
    return library


def onehot_bytes(code, lanes, out, **kw) -> int:
    """onehot_segment_sums' bytes: the codes (or keys and row mask) and
    every lane read once, the [dp, k] output written once."""
    read = (code, *kw.get("keys", ()), *lanes,
            *([kw["row_mask"]] if kw.get("row_mask") is not None else []))
    return (sum(x.numel() * x.element_size() for x in read)
            + out.numel() * out.element_size())


def route_line(dp, lanes, n, code=None, **kw) -> str:
    r = onehot_route_of(code, dp, lanes, n, **kw)
    return (f"{'private' if r['private'] else 'shared'} route, "
            f"{r['copies']} copies, {r['threads']} threads x {r['blocks']} "
            f"blocks ({r['blocks_per_sm']} an SM), {r['tile_rows']}-row "
            f"tiles, {r['smem']} B shared memory a block")


def onehot_route_of(code, dp, lanes, n, **kw) -> dict:
    """K.onehot_route for a call's code (its first key), lanes and
    keywords."""
    if "mins" not in kw:
        return K.onehot_route(dp, tuple(x.dtype for x in lanes), n)
    return K.onehot_route(
        dp, tuple(x.dtype for x in lanes), n,
        keys=(code.dtype,) * (1 + len(kw.get("keys", ()))),
        row_mask=kw.get("row_mask") is not None,
        products=kw.get("products", ()), counts=kw.get("counts", False))


def private_limit(dtypes) -> int:
    """The largest dp whose lanes of these dtypes take the private route."""
    dp = 1
    while K.onehot_route(dp + 1, dtypes, CAP)["private"]:
        dp += 1
    return dp


def onehot_f64_cases(rng, dev, col, codes, x64, x32, b50, lanes):
    """check_onehot's cases with float64 lanes, (label, code, lanes, dp)
    each, q4's lanes with v3 a DOUBLE first; and the largest dp at which
    those lanes take the private route. Float64 values are normal ones
    scaled by 1e-3 to 1e6, so the sums cancel."""
    def f64(n):
        return col(rng.normal(size=n) * 10.0 ** rng.integers(-3, 7, n))
    d = f64(CAP + 3)
    q4d = (b50[:CAP], x32[:CAP], lanes[4], d[:CAP])
    two = (x64[:CAP], x32[:CAP], d[:CAP], b50[:CAP], lanes[3], lanes[4],
           d[3:CAP + 3], lanes[5])
    cases = [(f"q4's lanes with v3 a DOUBLE, dp {dp}", codes[dp][:CAP], q4d,
              dp) for dp in (11, 2, 101, 513)]
    cases += [(f"8 lanes, two float64, dp {dp}", codes[dp][:CAP], two, dp)
              for dp in (101, 513)]
    dtypes = tuple(x.dtype for x in q4d)
    lim = private_limit(dtypes)
    for dp in (lim, lim + 1):
        c = col(rng.integers(0, dp, CAP).astype(np.int32))
        cases.append((f"q4's lanes with v3 a DOUBLE at dp {dp} "
                      f"({'at' if dp == lim else 'one past'} the private "
                      f"route's limit)", c, q4d, dp))
    for dp, ls in ((11, q4d), (513, two)):
        cases.append((f"every row in slot {dp - 2}, dp {dp}, float64",
                      torch.full((CAP,), dp - 2, dtype=torch.int32,
                                 device=dev), ls, dp))
    for dp in (11, 101):
        x = d[:CAP].clone()
        c = codes[dp][:CAP]
        rows = [torch.nonzero(c == s).squeeze(1) for s in range(6)]
        x[rows[1]] = -0.0                              # a slot of -0.0 only
        x[rows[2][:5]] = float("nan")
        x[rows[3][:1]] = float("inf")
        x[rows[4][:1]] = float("-inf")
        x[rows[5][:2]] = torch.tensor([float("inf"), float("-inf")],
                                      dtype=torch.float64, device=dev)
        cases.append((f"NaN, ±inf, inf - inf and -0.0 slots, dp {dp}", c,
                      q4d[:3] + (x,), dp))
    n = CAP - 3
    odd = (x32[1:n + 1], d[1:n + 1], b50[3:n + 3], x64[3:n + 3], d[3:n + 3])
    for dp in (11, 101):
        cases.append((f"float64 views at offsets 1 and 3, dp {dp}",
                      codes[dp][1:n + 1], odd, dp))
    for dp in (11, 101):
        tile = K.onehot_route(dp, dtypes, CAP)["tile_rows"]
        for n in (1, 15, 17, tile - 1, tile, tile + 1, 5 * tile + 123,
                  CAP - 3):
            for off in (0, 3):
                cases.append((f"{n} rows at offset {off}, dp {dp}, float64",
                              codes[dp][off:off + n],
                              tuple(x[off:off + n] for x in q4d), dp))
    return cases, lim


def check_onehot(rng, dev, data):
    """onehot_segment_sums equal to its plain version (torch.equal) over
    dp 2, 11, 101, 513 with 6 mixed lanes; every row in one slot on each
    route; q4's 8-lane mix of the NA variant (4 bool, 2 int32, 2 int64);
    dp x k at the private route's limit and one past it; codes and lanes
    that are views at odd offsets; and 1, 15, 17, a tile - 1, a tile, a
    tile + 1 and five tiles + 123 rows on each route, aligned and not.
    Float64 lanes, as onehot_close holds them (integer lanes exactly, the
    float64 columns within ONEHOT_F64_RTOL normwise): q4's lanes with v3 a
    DOUBLE (bool, int32, int32, float64) at dp 2, 11, 101 and 513, at the
    private route's limit and one past it, and over the whole column
    (each block of the persistent grid walks many tiles); 8 lanes with two
    float64 at dp 101 and 513 (copies of a warp's own and shared by warps);
    every row in one slot; NaN, ±inf and -0.0 slots; views at odd offsets;
    the ragged row counts above and CAP - 3 at offsets 0 and 3. Then timed
    at the inputs the main path gives it at q1 q2 q4 q9 qjg, and at q4's
    with v3 a DOUBLE, each beside its route and the library calls that
    compute the same sums (onehot_library)."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    x64 = rng.integers(2**62 - 2**20, 2**62, CAP + 3)
    x64[rng.random(CAP + 3) < 0.3] *= -1             # sums wrap past ±2^63
    x64 = col(x64)
    x32 = col(rng.integers(-2**31, 2**31 - 1, CAP + 3).astype(np.int32))
    b50 = col(rng.random(CAP + 3) < 0.5)
    lanes = (x64[:CAP], x32[:CAP], b50[:CAP],
             col(rng.integers(-5, 6, CAP)),
             col(rng.integers(0, 15, CAP).astype(np.int32)),
             col(rng.random(CAP) < 0.999))
    # q4 with NAs: counts, then (:cnt, :sum) for v1 and v2, (:cnt, #A, #B)
    # for v3
    na8 = (b50[:CAP], lanes[5], x32[:CAP], b50[1:CAP + 1], lanes[4],
           lanes[5], x64[:CAP], lanes[3])
    q4 = (b50[:CAP], x32[:CAP], lanes[4], x64[:CAP], lanes[3])
    codes = {dp: col(rng.integers(0, dp, CAP + 1).astype(np.int32))
             for dp in (2, 11, 101, 513)}
    cases = [(f"dp {dp}, 6 lanes", codes[dp][:CAP], lanes, dp)
             for dp in codes]
    cases += [
        ("every row in slot 7, dp 513", torch.full(
            (CAP,), 7, dtype=torch.int32, device=dev), lanes, 513),
        ("every row in slot 3, dp 11", torch.full(
            (CAP,), 3, dtype=torch.int32, device=dev), q4, 11),
        ("q4's 8-lane NA mix, dp 11", codes[11][:CAP], na8, 11),
        ("q4's 8-lane NA mix, dp 101 (copies shared by warps)",
         codes[101][:CAP], na8, 101)]
    lim = private_limit(tuple(x.dtype for x in q4))
    for dp in (lim, lim + 1):
        c = col(rng.integers(0, dp, CAP).astype(np.int32))
        cases.append((f"q4's lanes at dp {dp} ({'at' if dp == lim else 'one past'}"
                      f" the private route's limit)", c, q4, dp))
    n = CAP - 3
    odd = (x64[3:n + 3], x32[1:n + 1], b50[3:n + 3], x64[1:n + 1],
           b50[1:n + 1])
    for dp in (11, 101):
        cases.append((f"views at offsets 1 and 3, dp {dp}",
                      codes[dp][1:n + 1], odd, dp))
    for dp in (11, 101):
        tile = K.onehot_route(dp, tuple(x.dtype for x in q4), CAP)["tile_rows"]
        for n in (1, 15, 17, tile - 1, tile, tile + 1, 5 * tile + 123):
            for off in (0, 3):
                cases.append((f"{n} rows at offset {off}, dp {dp}",
                              codes[dp][off:off + n],
                              tuple(x[off:off + n] for x in q4), dp))
    err = 0.0
    for label, code, ls, dp in cases:
        got = K.onehot_segment_sums(code, ls, dp)
        want = K.onehot_segment_sums_plain(code, ls, dp)
        err = max(err, max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"onehot_segment_sums differs ({label}): "
                                 f"max |err| {max_abs_err(got, want)}")
    print(f"# onehot_segment_sums equal to its plain version in {len(cases)} "
          f"cases; q4's lanes take the private route up to dp {lim} "
          f"({lim * len(q4)} entries): dp {lim} {route_line(lim, q4, CAP)}; "
          f"dp {lim + 1} {route_line(lim + 1, q4, CAP)}; the 8-lane NA mix "
          f"at dp 101: {route_line(101, na8, CAP)}", flush=True)
    f64_cases, lim64 = onehot_f64_cases(rng, dev, col, codes, x64, x32, b50,
                                        lanes)
    err64 = 0.0
    for label, code, ls, dp in f64_cases:
        for rep in range(3):
            err64 = max(err64, onehot_close(
                f"{label}, run {rep}", K.onehot_segment_sums(code, ls, dp),
                K.onehot_segment_sums_plain(code, ls, dp), ls))
    q4d = f64_cases[0][2]
    print(f"# onehot_segment_sums with float64 lanes as its plain version in "
          f"{len(f64_cases)} cases, 3 runs each (integer lanes equal, "
          f"float64 within {err64:.3e} normwise); q4's lanes with v3 a "
          f"DOUBLE take the private route up to dp {lim64}: dp 11 "
          f"{route_line(11, q4d, CAP)}; dp {lim64 + 1} "
          f"{route_line(lim64 + 1, q4d, CAP)}", flush=True)

    timed = {}
    inputs = capture_onehot(dev, data)
    if sorted(inputs) != sorted(ONEHOT_SHAPES):
        raise AssertionError(f"dense queries called onehot_segment_sums: "
                             f"{sorted(inputs)}")
    inputs["q4@float64"] = capture_q4_double(dev, data)
    for q, (code, ls, dp, kw) in inputs.items():
        got = K.onehot_segment_sums(code, ls, dp, **kw)
        onehot_close(q, got, K.onehot_segment_sums_plain(code, ls, dp, **kw),
                     ls)
        library = onehot_library(code, ls, dp, **kw)
        onehot_close(f"the library calls at {q}", library(), got, ls)
        kinds = ", ".join(str(x.dtype).removeprefix("torch.") for x in ls)
        form = (f"keyed ({1 + len(kw.get('keys', ()))} keys, "
                f"{len(kw.get('products', ()))} products)" if kw else "code")
        print(f"# onehot_segment_sums at {q}: {code.numel()} rows, dp {dp}, "
              f"{form} form, lanes ({kinds}): "
              f"{route_line(dp, ls, code.numel(), code, **kw)}", flush=True)
        timed[q] = time_shape(
            f"onehot_segment_sums at {q}'s inputs (dp {dp}, {len(ls)} "
            f"lanes, {form} form)",
            lambda: K.onehot_segment_sums(code, ls, dp, **kw),
            lambda: K.onehot_segment_sums_plain(code, ls, dp, **kw),
            onehot_bytes(code, ls, got, **kw))
        timed[q]["library_ms"] = cuda_ms(library)
        timed[q]["route"] = onehot_route_of(code, dp, ls, code.numel(), **kw)
        print(f"# the library calls (index_add_ of the integer lanes as an "
              f"[n, k] int64 source, and of each float64 lane) at {q}: "
              f"{timed[q]['library_ms']:.4f} ms", flush=True)
    row = {k: timed["q9"][k] for k in ("ms", "ms_with_host", "plain_ms",
                                       "bound_ms", "share_of_bound",
                                       "library_ms")}
    row["shapes"] = list(timed.values())
    row["float64_normwise_err"] = err64
    return err, row


def sass_atomics() -> dict[str, collections.Counter]:
    """The atomic instructions of each onehot_segment_sums instantiation in
    the built library's SASS (cuobjdump -sass): whether its shared 64-bit
    add is one ATOMS.ADD.64 or a compare-and-swap loop. Empty when the
    toolkit has no cuobjdump."""
    tool = Path(K._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(K.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = K._kernel_name(m[1]) if "onehot" in m[1] else None
            if name:
                per[name] = collections.Counter()
        elif name:
            m = re.search(r"\b(?:ATOMS|ATOMG|ATOM|RED)\.[\w.]+", line)
            if m:
                per[name][m[0]] += 1
    return per


def check_running(rng, dev):
    """fused_running_stats against its plain version, each case REPEATS
    times in a row (the first call's scratch newly allocated after
    torch.cuda.empty_cache(), the rest the allocator's reused blocks; a
    missing fence shows as an occasional wrong carry): {0, 1} values (float32 sums exact below
    2^24), normal values, normal values with NaNs, a lone NaN in the
    middle of a late tile after thousands of NaN-free tiles, 1, tile - 1,
    tile, tile + 1 and 3 tiles + 5 rows, and the misaligned views x[1:]
    and x[3:]. Min and max equal the plain version's (NaN where it has
    NaN), sums NaN where it has NaN and elsewhere within RUN_SUM_TOL of
    the running sum of |x| of a float64 cumsum. Then best_profit equal to
    the plain computation, and the timing at 12,582,912 rows."""
    def col(a):
        return torch.from_numpy(a).to(dev)
    tile = K.build().aq_fused_running_stats_tile_rows()
    xn = col(rng.normal(size=CAP + 3).astype(np.float32))
    xnan = xn.clone()
    xnan[col(rng.random(CAP + 3) < 1e-6)] = float("nan")
    lone = xn.clone()
    lone[(CAP // tile - 2) * tile + tile // 2 + 3] = float("nan")
    cases = {"{0, 1}": col(rng.integers(0, 2, CAP).astype(np.float32)),
             "normal": xn[:CAP], "NaN 1e-6": xnan[:CAP],
             "lone NaN in a late tile": lone[:CAP],
             "x[1:]": xnan[1:CAP + 1], "x[3:]": xnan[3:CAP + 3]}
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 5):
        cases[f"{n} rows"] = xnan[:n]
    err = 0.0
    for case, x in cases.items():
        want = K.fused_running_stats_plain(x)
        exact_sum = torch.cumsum(torch.nan_to_num(x).double(), 0)
        scale = torch.cumsum(torch.nan_to_num(x).double().abs(), 0)
        torch.cuda.empty_cache()
        for rep in range(REPEATS):
            got = K.fused_running_stats(x)
            for lane, (g, w) in enumerate(zip(got, want)):
                ok = torch.equal(g.isnan(), w.isnan())
                if lane:
                    ok = ok and exact(lane, g, w, None)
                else:
                    num = ~g.isnan()
                    ok = ok and bool(((g.double() - exact_sum).abs()[num]
                                      <= RUN_SUM_TOL * scale[num]).all())
                    err = max(err, max_abs_err(g, w))
                if not ok:
                    raise AssertionError(
                        f"fused_running_stats lane {lane} differs ({case}, "
                        f"run {rep}): max |err| {max_abs_err(g, w)}")
    x01 = cases["{0, 1}"]
    if not all(torch.equal(g, w) for g, w in zip(
            K.fused_running_stats(x01), K.fused_running_stats_plain(x01))):
        raise AssertionError("fused_running_stats sums of {0, 1} not exact")
    xn = cases["normal"]
    idx = torch.arange(CAP, device=dev)
    for n in (ROWS, CAP):
        bp = K.best_profit(xn, n)
        plain = torch.where(idx < n, xn - torch.cummin(xn, 0).values,
                            float("-inf")).max()
        if not torch.equal(bp, plain):
            raise AssertionError(f"best_profit {bp} vs plain {plain}")
    print(f"# fused_running_stats ({tile}-row tiles) equal to its plain "
          f"version in {len(cases)} cases, {REPEATS} runs each: min, max "
          f"and the {{0, 1}} sums exactly, the other sums within "
          f"{RUN_SUM_TOL} of the running sum of |x| (max |err| vs plain "
          f"{err}); best_profit equal", flush=True)
    timed = time_shape("fused_running_stats",
                       lambda: K.fused_running_stats(xn),
                       lambda: K.fused_running_stats_plain(xn),
                       4 * xn.numel() * xn.element_size())
    timed.pop("shape")
    timed.pop("bytes")
    return err, timed


def _groups(keycols: dict[str, np.ndarray], groups: dict | None = None):
    """Key-ascending groups of the rows: (the sorted unique key columns,
    each row's group, each group's row count). The keys' mixed-radix code
    groups by one bincount where its domain is at most 4 codes a row (every
    G1 key set but q10's), else by np.unique (one sort). ``groups``, where
    given, keeps each key set's grouping for the other queries of the same
    table (q3 and q7 share id3's, q5 and q8 id6's)."""
    if groups is not None and tuple(keycols) in groups:
        return groups[tuple(keycols)]
    n = len(next(iter(keycols.values())))
    code = np.zeros(n, np.int64)
    radix = {}
    domain = 1
    for k, v in keycols.items():
        lo = int(v.min())
        radix[k] = (lo, int(v.max()) - lo + 1)
        domain *= radix[k][1]
        code *= radix[k][1]
        code += v
        code -= lo
    if domain <= 4 * n:
        per = np.bincount(code, minlength=domain)
        ucode = np.flatnonzero(per)
        inv = (np.cumsum(per > 0) - 1)[code]
        cnt = per[ucode]
    else:
        ucode, inv, cnt = np.unique(code, return_inverse=True,
                                    return_counts=True)
    keys = {}
    for k in reversed(list(keycols)):
        lo, r = radix[k]
        keys[k] = ucode % r + lo
        ucode = ucode // r
    out = {k: keys[k] for k in keycols}, inv, cnt
    if groups is not None:
        groups[tuple(keycols)] = out
    return out


def group_sorted(inv: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A 32-bit column's values ordered by (group, value): one np.sort of
    int64 keys that hold the group above the value's 32 order bits (a
    float's sign flips its other bits, so -0.0 sorts before 0.0; no NaN).
    Each group's run then starts at the sum of the counts before it."""
    if v.dtype == np.float32:
        b = v.view(np.uint32)
        bits = np.where(b >> 31 == 1, ~b, b | np.uint32(1 << 31))
    else:
        bits = v.astype(np.int32).view(np.uint32) ^ np.uint32(1 << 31)
    key = inv.astype(np.int64) << 32
    key |= bits
    key.sort()
    b = key.astype(np.uint32)                   # the low 32 bits
    if v.dtype == np.float32:
        return np.where(b >> 31 == 1, b & np.uint32(0x7FFFFFFF),
                        ~b).view(np.float32)
    return (b ^ np.uint32(1 << 31)).view(np.int32).astype(v.dtype)


def oracle(data: dict[str, np.ndarray], q: str, groups: dict | None = None):
    """(answer, per-group row counts, {key: NULL mask}): the query computed
    on the host with numpy, key-ascending. On masked columns (the NA
    variant) a NULL key codes as (max + 1), so the NULLs make one group,
    last, and aggregates skip NULL arguments. Sums and counts are
    bincounts over the groups; min, max and the median read each group's
    run of group_sorted. ``groups`` as _groups takes it."""
    def col(nm):
        c = data[nm]
        if isinstance(c, np.ma.MaskedArray):
            return np.ma.getdata(c), ~np.ma.getmaskarray(c)
        return c, None

    keycols = {}
    if q == "multikey":
        keycols["k"] = col("id1")[0].astype(np.int64) * 100 + col("id4")[0]
    for k in KEYS.get(q, []):
        v, ok = col(k)
        keycols[k] = v if ok is None else np.where(ok, v, v[ok].max() + 1)
    keys, inv, cnt = _groups(keycols, groups)
    starts = np.cumsum(cnt) - cnt
    out, nulls = {}, {}
    for k, kv in keys.items():
        if k == "k":                             # the computed key
            out[k] = kv.astype(np.int32)
            continue
        v, ok = col(k)
        # the sentinel group; no NULL key where the column has no mask
        nulls[k] = (np.zeros(len(kv), bool) if ok is None
                    else kv == int(v[ok].max()) + 1)
        out[k] = np.where(nulls[k], 0, kv).astype(np.int32)

    def isum(nm):
        v, ok = col(nm)
        return np.bincount(inv, weights=v if ok is None else np.where(ok, v, 0)
                           ).astype(np.int64)

    def fsum(nm):
        v, ok = col(nm)
        return np.bincount(inv, weights=v if ok is None else np.where(ok, v, 0))

    def nn(nm):
        ok = col(nm)[1]
        return cnt if ok is None else np.maximum(np.bincount(inv, weights=ok),
                                                 1)

    def extreme(nm, last, ident):
        v, ok = col(nm)
        sv = group_sorted(inv, v if ok is None
                          else np.where(ok, v, ident).astype(v.dtype))
        return sv[starts + cnt - 1] if last else sv[starts]

    if q in ("q1", "q2"):
        out["v1"] = isum("v1")
    elif q == "q3":
        out["v1"], out["v3"] = isum("v1"), fsum("v3") / nn("v3")
    elif q == "q4":
        for nm in ("v1", "v2", "v3"):
            out[nm] = fsum(nm) / nn(nm)
    elif q == "q5":
        out["v1"], out["v2"], out["v3"] = isum("v1"), isum("v2"), fsum("v3")
    elif q == "q6":
        v = col("v3")[0]
        sv = group_sorted(inv, v).astype(np.float64)
        out["median_v3"] = (sv[starts + (cnt - 1) // 2]
                            + sv[starts + cnt // 2]) * 0.5
        s1 = fsum("v3")
        s2 = np.bincount(inv, weights=(v * v).astype(np.float64))  # f32 sq
        den = cnt + 1.0                          # var divides by n + 1
        out["sd"] = np.sqrt(np.maximum((s2 - s1 * s1 / den) / den, 0.0))
    elif q == "q7":
        mx = extreme("v1", True, np.iinfo(np.int32).min)
        mn = extreme("v2", False, np.iinfo(np.int32).max)
        out["range_v1_v2"] = (mx.astype(np.int64) - mn).astype(np.int32)
    elif q == "q9":
        (x, okx), (y, oky) = col("v1"), col("v2")
        ok = None if okx is None and oky is None else (
            (True if okx is None else okx) & (True if oky is None else oky))
        x = (x if ok is None else np.where(ok, x, 0)).astype(np.int64)
        y = y if ok is None else np.where(ok, y, 0)
        sx, sy, sxy, sx2, sy2 = (
            np.bincount(inv, weights=a)
            for a in (x, y, x * y, x * x, y * y))
        n2 = cnt if ok is None else np.bincount(inv, weights=ok)
        r = (n2 * sxy - sx * sy) / np.sqrt((n2 * sx2 - sx * sx)
                                           * (n2 * sy2 - sy * sy))
        out["r2"] = r ** 2
    elif q == "multikey":
        out["s"] = isum("v1")
        out["mx"] = extreme("v3", True, -np.inf)
    else:
        out["v3"], out["cnt"] = fsum("v3"), cnt.astype(np.int64)
    return out, cnt, nulls


def check_result(q: str, res, want: dict[str, np.ndarray],
                 cnt: np.ndarray, nulls: dict[str, np.ndarray]) -> None:
    """Keys, their NULLs, counts, integer sums, min/max and medians
    exactly; float sums, averages and stddev to FLOAT_RTOL plus the limb
    split's rounding of each row (at most 2^-39 per row, so cnt · 2^-39
    per group); q9's r2, from exact integer sums, to EXACT_SUMS_RTOL."""
    names = res.column_names()
    if names != list(want):
        raise AssertionError(f"{q}: columns {names}, want {list(want)}")
    for nm, null in nulls.items():
        v = res.table.columns[nm].valid
        got_null = (np.zeros(res.nrows, bool) if v is None
                    else ~v[:res.nrows].cpu().numpy())
        np.testing.assert_array_equal(got_null, null, err_msg=f"{q}.{nm} NULL")
    for nm in names:
        got = res.table.columns[nm].to_numpy()
        w = want[nm]
        if got.shape != w.shape:
            raise AssertionError(f"{q}.{nm}: shape {got.shape} vs {w.shape}")
        if nm == "median_v3":
            np.testing.assert_array_equal(got, w, err_msg=f"{q}.{nm}")
        elif got.dtype.kind == "f" and nm != "mx":
            if not np.isfinite(got).all():
                raise AssertionError(f"{q}.{nm}: non-finite values")
            tol = (EXACT_SUMS_RTOL[nm] * np.abs(w) if nm in EXACT_SUMS_RTOL
                   else FLOAT_RTOL * np.abs(w) + cnt * 2.0**-39)
            bad = np.abs(got - w) > tol
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(f"{q}.{nm}: {int(bad.sum())} groups "
                                     f"differ, first {i}: {got[i]!r} vs "
                                     f"{w[i]!r}")
        else:
            if got.dtype != w.dtype:
                raise AssertionError(f"{q}.{nm}: dtype {got.dtype} vs {w.dtype}")
            np.testing.assert_array_equal(got, w, err_msg=f"{q}.{nm}")


def q8_oracle(data, groups: dict | None = None):
    """q8's answer: the id6 values ascending, each one's row count, and
    the two largest v3 of each, in descending order, concatenated (each
    group's last two of group_sorted). ``groups`` as _groups takes it."""
    keys, inv, cnt = _groups({"id6": data["id6"]}, groups)
    sv = group_sorted(inv, data["v3"])
    ends = np.cumsum(cnt)
    kept = np.minimum(cnt, 2)
    at = np.cumsum(kept) - kept
    top2 = np.empty(int(kept.sum()), np.float32)
    top2[at] = sv[ends - 1]
    two = cnt >= 2
    top2[at[two] + 1] = sv[ends[two] - 2]
    return keys["id6"].astype(data["id6"].dtype), cnt, top2


def check_q8(res, data, groups: dict | None = None) -> None:
    """q8: per id6, its two largest v3 in descending order, and the
    VectorColumn's offsets (cumulative min(count, 2))."""
    ids, cnt, top2 = q8_oracle(data, groups)
    cols = res.table.columns
    if res.column_names() != ["id6", "largest2_v3"]:
        raise AssertionError(f"q8: columns {res.column_names()}")
    np.testing.assert_array_equal(cols["id6"].to_numpy(), ids, err_msg="q8 id6")
    v = cols["largest2_v3"]
    np.testing.assert_array_equal(v.offsets_numpy(),
                                  np.r_[0, np.cumsum(np.minimum(cnt, 2))],
                                  err_msg="q8 offsets")
    np.testing.assert_array_equal(v.to_numpy(), top2, err_msg="q8 values")


def timed_runs(db, sql: str, reps: int, probe=None):
    """(result of a first run, median ms of ``reps`` warm runs), host
    clock around execute plus a synchronize; the first run inside the
    PlanProbe ``probe``, where given."""
    if probe is None:
        res = db.execute(sql)          # first run: caches, allocator
    else:
        with probe:
            res = db.execute(sql)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t1 = time.perf_counter()
        db.execute(sql)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
    return res, float(np.median(runs)) * 1e3


def run_queries(db, queries: dict[str, str], check, reps: int = 3,
                tag: str = "", walls: dict[str, float] | None = None,
                plans: dict | None = None) -> dict[str, dict[str, int]]:
    """Each query: its launches counted from zero over its runs, the
    result checked by check(q, res), the median warm time printed (and
    kept in walls), and where plans is given, its first run's PlanProbe
    kept there."""
    launches = {}
    for q, sql in queries.items():
        reset_launches()
        probe = None
        if plans is not None:
            probe = plans[q + tag] = PlanProbe()
        res, ms = timed_runs(db, sql, reps, probe)
        launches[q + tag] = {k: v for k, v in K.LAUNCHES.items() if v}
        check(q, res)
        if walls is not None:
            walls[q + tag] = ms
        print(f"# {q}{tag}: {res.nrows} groups, {ms:.3f} ms (median of "
              f"{reps} warm runs), matches the numpy oracle, launches "
              f"{launches[q + tag]}", flush=True)
    return launches


def load(db, name, arrays, dev, **kw) -> None:
    t0 = time.perf_counter()
    t = db.catalog.create(Table.from_numpy(name, arrays, device=dev, **kw))
    torch.cuda.synchronize()
    print(f"# loaded {name}: {t.nrows} rows x {len(arrays)} columns, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def join_oracle(data, dim, q: str):
    """qj: the count of source rows whose id3 is a dim key; qjg: per w,
    ascending, the count and the int64 sum of v1 over those rows. As
    oracle() returns it (answer, per-group row counts, no NULLs)."""
    lut = np.zeros(int(max(data["id3"].max(), dim["id3"].max())) + 1,
                   np.int32)
    lut[dim["id3"]] = dim["w"]                  # every w is at least 1
    w = lut[data["id3"]]
    hit = w > 0
    if q == "qj":
        return {"count": np.array([hit.sum()], np.int64)}, np.ones(1), {}
    ws, inv = np.unique(w[hit], return_inverse=True)
    cnt = np.bincount(inv)
    sv = np.bincount(inv, weights=data["v1"][hit]).astype(np.int64)
    return {"w": ws, "c": cnt.astype(np.int64), "sv": sv}, cnt, {}


def run_slice(dev, data, dim, walls, plans):
    """The h2o queries and the computed-key query on G1_1e7_1e1_0_0 and
    its dim table, each first run's plan kept in plans: (the launches,
    the session)."""
    db = connect(device=dev)
    load(db, "source", data, dev)
    load(db, "dim", dim, dev)
    groups: dict = {}

    def check(q, res):
        if q == "q8":
            check_q8(res, data, groups)
        elif q in ("qj", "qjg"):
            check_result(q, res, *join_oracle(data, dim, q))
        else:
            check_result(q, res, *oracle(data, q, groups))
    return run_queries(db, QUERIES, check, walls=walls, plans=plans), db


def time_joins(db, data, dim) -> dict[str, float]:
    """The joins' parts at the main path's shapes, each called directly,
    checked against numpy, then timed (device time, median of 10) beside
    its bound (its inputs read once, outputs written once, at 3.35 TB/s):
    - the count join's routes at qj's shape: the histogram and the sort;
    - the histogram and the sort at a wide domain, 1e5 build keys spread
      over [1, 2^27] and 1e7 probe keys, half of them build keys: the
      histogram's gate (PERFECT_HASH_MAX_DOMAIN) at its limit;
    - the star join at qjg's shape: the position table's build and the
      probe (positions, match, the gathered w)."""
    src, d = db.catalog.get("source").columns, db.catalog.get("dim").columns
    pkey, bkey, bw = src["id3"], d["id3"], d["w"]
    dev = pkey.device
    mn, mx = bkey.stats()
    out = {}

    def timed(label, fn, nbytes):
        ms = cuda_ms(fn)
        b = bound_ms(nbytes)
        print(f"# {label}: {ms:.4f} ms device time (median of 10); "
              f"{nbytes} bytes, bound {b:.4f} ms at 3.35 TB/s, "
              f"{b / ms:.1%} of bound", flush=True)
        out[label] = ms
        return ms

    def count_routes(shape, pk, bk, want):
        routes = {"histogram route": lambda: fused_join.count_histogram(
                      pk, bk, *bk.stats()),
                  "sort route": lambda: fused_join.count_sorted(pk, bk)}
        for route, fn in routes.items():
            got = int(fn())
            if got != want:
                raise AssertionError(f"count join, {route} at {shape}: "
                                     f"{got}, numpy {want}")
            timed(f"count join, {route}, at {shape}", fn,
                  4 * pk.nrows + 4 * bk.nrows + 8)

    bmn, bmx = bkey.stats()
    count_routes(f"qj's shape ({pkey.nrows} x {bkey.nrows} rows, domain "
                 f"{bmx - bmn + 1})", pkey, bkey,
                 int(np.isin(data["id3"], dim["id3"]).sum()))
    rng = np.random.default_rng(SEED)
    wide_b = (rng.choice(2**27, bkey.nrows, replace=False) + 1).astype(np.int32)
    wide_p = np.where(rng.random(ROWS) < 0.5, rng.choice(wide_b, ROWS),
                      rng.integers(1, 2**27 + 1, ROWS)).astype(np.int32)
    wb = Column("k", T.IntT, wide_b, device=dev)
    wp = Column("k", T.IntT, wide_p, device=dev)
    wmn, wmx = wb.stats()
    count_routes(f"a wide domain ({ROWS} x {wb.nrows} rows, domain "
                 f"{wmx - wmn + 1})", wp, wb,
                 int(np.isin(wide_p, wide_b).sum()))
    del wb, wp

    # the star join's parts at qjg's shape, against numpy
    lut = np.zeros(int(max(data["id3"].max(), mx)) + 1, np.int32)
    lut[dim["id3"]] = dim["w"]
    want_w = lut[data["id3"]]
    want_match = want_w > 0
    pos, unique = fused_star.build_positions(bkey, mn, mx)
    match, (w,) = fused_star.probe(pos, pkey, mn, [bw.data])
    if not (bool(unique) and np.array_equal(match.cpu().numpy(), want_match)
            and np.array_equal(w.cpu().numpy()[want_match],
                               want_w[want_match])):
        raise AssertionError("star build or probe differs from numpy")
    dom = mx - mn + 1
    timed(f"star build, position table (domain {dom}, {bkey.nrows} rows)",
          lambda: fused_star.build_positions(bkey, mn, mx),
          4 * bkey.nrows + 4 * (dom + 1) + 1)
    timed("star probe, positions (match and w)",
          lambda: fused_star.probe(pos, pkey, mn, [bw.data]),
          4 * (dom + 1) + 4 * pkey.nrows + 4 * bw.nrows + 5 * pkey.nrows)
    return out


def trades_oracle(arrays, q: str):
    """Per symbol (code order): avgs(5, price) as flat values with
    offsets, or MAX(stddevs(3, price)); rows ordered by time within each
    symbol, ties in insertion order."""
    sym, t, price = arrays["stocksymbol"], arrays["time"], arrays["price"]
    order = np.lexsort((t, sym))
    syms, cnt = np.unique(sym, return_counts=True)
    first = np.repeat(np.r_[0, np.cumsum(cnt)[:-1]], cnt)
    pos = np.arange(ROWS) - first
    p = price[order].astype(np.int64)
    c = np.cumsum(p)
    c = c - np.r_[0, c][first]                   # running sum in the group

    def window(run, w):
        behind = np.where(pos >= w, np.arange(ROWS) - w, 0)
        return np.where(pos >= w, run - run[behind], run)

    if q == "avgs":
        a = window(c, 5) / np.minimum(pos + 1, 5).astype(np.float64)
        return syms, cnt, a
    pf = p.astype(np.float64)
    sq = np.cumsum(pf * pf)
    sq = sq - np.r_[0.0, sq][first]
    cnt3 = np.minimum(pos + 1, 3).astype(np.float64)
    mean = window(c.astype(np.float64), 3) / cnt3
    var = np.maximum(window(sq, 3) / cnt3 - mean * mean, 0.0)
    sd = np.sqrt(var)
    return syms, cnt, np.maximum.reduceat(sd, np.r_[0, np.cumsum(cnt)[:-1]])


def run_trades(dev) -> dict[str, dict[str, int]]:
    """The trades queries on 1e7 rows and 100 symbols (seed 7)."""
    arrays, d = trades(ROWS, 100, 7)
    db = connect(device=dev)
    load(db, "trades", arrays, dev, types={"stocksymbol": T.StrT},
         dictionaries={"stocksymbol": d})

    return run_queries(db, TRADES,
                       lambda q, res: check_trades(arrays, q, res))


def check_trades(arrays, q: str, res) -> None:
    """A trades query against trades_oracle: the symbols and offsets
    exactly, the values to TRADES_RTOL."""
    syms, cnt, want = trades_oracle(arrays, q)
    cols = res.table.columns
    np.testing.assert_array_equal(cols["stocksymbol"].to_numpy(), syms,
                                  err_msg=f"{q} symbols")
    if q == "avgs":
        np.testing.assert_array_equal(cols["a"].offsets_numpy(),
                                      np.r_[0, np.cumsum(cnt)])
        got = cols["a"].to_numpy()
    else:
        got = cols["m"].to_numpy()
    if got.dtype != np.float64 or got.shape != want.shape:
        raise AssertionError(f"{q}: {got.dtype} {got.shape}")
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-300)))
    if not err <= TRADES_RTOL:
        raise AssertionError(f"{q}: max relative error {err}")


def run_nas(dev) -> dict[str, dict[str, int]]:
    """q1 q2 q3 q4 q5 q7 q9 q10 on G1_1e7_1e1_5_0."""
    data = h2o_g1(ROWS, K_GROUPS, SEED, nas=5)
    db = connect(device=dev)
    load(db, "source", data, dev)
    groups: dict = {}
    return run_queries(db, {q: QUERIES[q] for q in NAS_QUERIES},
                       lambda q, res: check_result(
                           q, res, *oracle(data, q, groups)),
                       tag="@5pct_NA")


def general_queries(arrays) -> dict[str, str]:
    """The general engine's queries on the trades table (phase 5), with
    the range bounds and thresholds at percentiles of the data: lo/hi and
    t10 of time, p90 and p95 of price. g_ctas and g_dml start with their
    CREATE TABLE AS, so every run starts from the same res0."""
    t, p = arrays["time"], arrays["price"]
    lo, hi = (int(np.percentile(t, q)) for q in (10, 60))
    p90, p95 = (int(np.percentile(p, q)) for q in (90, 95))
    ctas = "CREATE TABLE res0 AS SELECT * FROM trades; "
    return {
        "g_count": "SELECT COUNT(*) FROM trades",
        "g_ctas": ctas + "SELECT count(*), sum(price) FROM res0",
        "g_union": "SELECT * FROM trades UNION ALL SELECT * FROM trades",
        "g_range": ("SELECT stocksymbol, quantity, price FROM trades "
                    f"WHERE time >= {lo} AND time <= {hi}"),
        "g_topk": ("SELECT stocksymbol, time, price FROM trades WHERE "
                   "quantity > 50 ORDER BY price DESC, time LIMIT 100"),
        "g_best": "SELECT max(price - mins(price)) FROM trades",
        "g_best_desc": ("SELECT max(price - mins(price)) FROM trades "
                        "ASSUMING DESC time"),
        "g_moving": "SELECT time, avgs(3, price) FROM trades ASSUMING ASC time",
        "g_firstlast": ("SELECT stocksymbol, first(price) AS f, "
                        "last(price) AS l, last(mins(price)) AS lm "
                        "FROM trades ASSUMING ASC time GROUP BY stocksymbol"),
        "g_distinct": "SELECT DISTINCT stocksymbol FROM trades",
        "g_dml": (ctas + f"DELETE FROM res0 WHERE price > {p90}; "
                  "UPDATE res0 SET quantity = quantity + 1 WHERE time < "
                  f"{lo}; INSERT INTO res0 SELECT * FROM trades WHERE "
                  f"price > {p95}; SELECT count(*), sum(quantity), "
                  "sum(price) FROM res0"),
    }


def general_oracle(arrays, sql: str, q: str) -> list:
    """Each output column of general query q, in order, from numpy (a
    scalar result as a 1-row array)."""
    sym, t = arrays["stocksymbol"], arrays["time"]
    qty, price = arrays["quantity"], arrays["price"]
    p64 = price.astype(np.int64)

    def one(x, dt):
        return np.array([x], dt)

    if q == "g_count":
        return [one(ROWS, np.int64)]
    if q == "g_ctas":
        return [one(ROWS, np.int64), one(p64.sum(), np.int64)]
    if q == "g_range":
        lo, hi = (int(x) for x in re.findall(r"time [<>]= (\d+)", sql))
        m = (t >= lo) & (t <= hi)
        return [sym[m], qty[m], price[m]]
    if q == "g_topk":
        idx = np.flatnonzero(qty > 50)
        idx = idx[np.lexsort((t[idx], -p64[idx]))[:100]]
        return [sym[idx], t[idx], price[idx]]
    if q in ("g_best", "g_best_desc"):
        pr = p64 if q == "g_best" else p64[np.argsort(-t.astype(np.int64),
                                                      kind="stable")]
        return [one((pr - np.minimum.accumulate(pr)).max(), np.int32)]
    if q == "g_moving":                      # time is sorted already
        c = np.cumsum(p64)
        pos = np.arange(ROWS)
        w = np.where(pos >= 3, c - np.r_[np.zeros(3, np.int64), c[:-3]], c)
        return [t, w / np.minimum(pos + 1, 3).astype(np.float64)]
    if q == "g_firstlast":
        syms, first = np.unique(sym, return_index=True)
        last = ROWS - 1 - np.unique(sym[::-1], return_index=True)[1]
        order = np.argsort(sym, kind="stable")
        starts = np.r_[0, np.cumsum(np.bincount(sym)[syms])[:-1]]
        return [syms, price[first], price[last],
                np.minimum.reduceat(price[order], starts)]
    if q == "g_distinct":
        return [np.unique(sym)]
    if q == "g_dml":
        p90, t10, p95 = (int(a or b) for a, b in re.findall(
            r"price > (\d+)|time < (\d+)", sql))
        keep, add = price <= p90, price > p95
        q2 = qty[keep].astype(np.int64) + (t[keep] < t10)
        return [one(keep.sum() + add.sum(), np.int64),
                one(q2.sum() + qty[add].astype(np.int64).sum(), np.int64),
                one(p64[keep].sum() + p64[add].sum(), np.int64)]
    raise KeyError(q)


def check_general(arrays, queries, q: str, res) -> None:
    """A general query's columns against general_oracle: exactly, float
    columns (avgs) to TRADES_RTOL; g_union by its row count and the
    int64 sum of each column (computed on the card)."""
    cols = list(res.table.columns.values())
    if q == "g_union":
        if res.nrows != 2 * ROWS:
            raise AssertionError(f"g_union: {res.nrows} rows")
        for c in cols:
            got = int(c.data[:c.nrows].to(torch.int64).sum())
            want = 2 * int(arrays[c.name].astype(np.int64).sum())
            if got != want:
                raise AssertionError(f"g_union.{c.name}: sum {got} vs {want}")
        return
    want = general_oracle(arrays, queries[q], q)
    if len(cols) != len(want):
        raise AssertionError(f"{q}: {len(cols)} columns, want {len(want)}")
    for c, w in zip(cols, want):
        got = c.to_numpy()
        if got.shape != w.shape or got.dtype != w.dtype:
            raise AssertionError(f"{q}.{c.name}: {got.dtype}{got.shape} vs "
                                 f"{w.dtype}{w.shape}")
        if got.dtype.kind == "f":
            err = float(np.max(np.abs(got - w) / np.maximum(np.abs(w),
                                                            1e-300)))
            if not err <= TRADES_RTOL:
                raise AssertionError(f"{q}.{c.name}: relative error {err}")
        else:
            np.testing.assert_array_equal(got, w, err_msg=f"{q}.{c.name}")


def na_general_oracle(data, q: str):
    """q6 and q8 on G1_1e7_1e1_5_0 as SQL answers them: q6's median and
    stddev skip the NULL v3 (stddev divides by the non-NULL count + 1);
    q8 orders each id6 group (NULL id6 last) by v3 descending with the
    NULLs last (ASSUMING and ORDER BY put NULL first ascending) and keeps
    the first two rows, a NULL as 0.0 (a vector cell has no NULL)."""
    v3 = data["v3"]
    ok = ~np.ma.getmaskarray(v3)
    v = np.ma.getdata(v3)
    if q == "q6":
        keys, inv, cnt = _groups(
            {k: data[k].astype(np.int64) for k in ("id4", "id5")})
        nn = np.bincount(inv, weights=ok).astype(np.int64)
        byval = np.lexsort((v, ~ok, inv))        # group, NULLs last, value
        first = np.r_[0, np.cumsum(cnt)[:-1]]
        sv = v[byval].astype(np.float64)
        med = (sv[first + np.maximum((nn - 1) // 2, 0)]
               + sv[first + np.maximum(nn // 2, 0)]) * 0.5
        vf = np.where(ok, v, 0).astype(np.float64)
        s1 = np.bincount(inv, weights=vf)
        s2 = np.bincount(inv, weights=vf * vf)
        den = nn + 1.0
        sd = np.sqrt(np.maximum((s2 - s1 * s1 / den) / den, 0.0))
        return {"id4": keys["id4"].astype(np.int32),
                "id5": keys["id5"].astype(np.int32),
                "median_v3": med, "sd": sd}, cnt, {}
    id6 = data["id6"]
    ok6 = ~np.ma.getmaskarray(id6)
    d6 = np.ma.getdata(id6).astype(np.int64)
    key = np.where(ok6, d6, d6[ok6].max() + 1)
    vkey = np.where(ok, v.astype(np.float64), -np.inf)
    order = np.argsort(-vkey, kind="stable")
    order = order[np.argsort(key[order], kind="stable")]
    ks, cnt = np.unique(key, return_counts=True)
    pos = np.arange(ROWS) - np.repeat(np.r_[0, np.cumsum(cnt)[:-1]], cnt)
    vals = np.where(ok, v, np.float32(0))[order][pos < 2]
    return ks, ok6, cnt, vals


def check_na_general(data, q: str, res) -> None:
    if q == "q6":
        check_result(q, res, *na_general_oracle(data, q))
        return
    ks, ok6, cnt, vals = na_general_oracle(data, q)
    cols = res.table.columns
    if res.column_names() != ["id6", "largest2_v3"]:
        raise AssertionError(f"q8: columns {res.column_names()}")
    null_key = int(np.ma.getdata(data["id6"])[ok6].max()) + 1
    if cols["id6"].to_python() != [None if k == null_key else int(k)
                                   for k in ks]:
        raise AssertionError("q8@5pct_NA: id6 differs")
    vc = cols["largest2_v3"]
    np.testing.assert_array_equal(vc.offsets_numpy(),
                                  np.r_[0, np.cumsum(np.minimum(cnt, 2))],
                                  err_msg="q8@5pct_NA offsets")
    np.testing.assert_array_equal(vc.to_numpy(), vals,
                                  err_msg="q8@5pct_NA values")


def run_general(dev, walls):
    """Phase 5: the general engine, through connect().execute, on the
    trades table (1e7 rows, 100 symbols, seed 7) and on G1_1e7_1e1_5_0;
    each query against numpy, its median of 3 warm runs and launches."""
    arrays, d = trades(ROWS, 100, 7)
    db = connect(device=dev)
    load(db, "trades", arrays, dev, types={"stocksymbol": T.StrT},
         dictionaries={"stocksymbol": d})
    queries = general_queries(arrays)
    launches = run_queries(
        db, queries, lambda q, res: check_general(arrays, queries, q, res),
        walls=walls)
    del db
    data = h2o_g1(ROWS, K_GROUPS, SEED, nas=5)
    db = connect(device=dev)
    load(db, "source", data, dev)
    launches.update(run_queries(
        db, {q: QUERIES[q] for q in GENERAL_NAS},
        lambda q, res: check_na_general(data, q, res), tag="@5pct_NA",
        walls=walls))
    return launches


def run_best_profit(dev) -> dict[str, int]:
    """best_profit over a 1e7-row price column (a random walk, padded to
    the capacity), against numpy; returns the launches of that call."""
    rng = np.random.default_rng(SEED)
    walk = 1000.0 + np.cumsum(rng.normal(size=ROWS))
    prices = np.zeros(CAP, np.float32)
    prices[:ROWS] = np.round(walk, 2).astype(np.float32)
    x = torch.from_numpy(prices).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = float(K.best_profit(x, ROWS))
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    p = prices[:ROWS]
    want = float((p - np.minimum.accumulate(p)).max())
    if got != want:
        raise AssertionError(f"best_profit {got} vs numpy {want}")
    print(f"# best_profit over {ROWS} prices: {got} in {ms:.3f} ms (one "
          f"call), matches numpy, launches {launches}", flush=True)
    return launches


def count_syncs(db, sql: str, timed: bool = False):
    """The synchronizing CUDA calls of one run of sql as torch's sync
    debug mode reports them, a check beside SYNCS (which reads the code):
    their number and the Python lines that made them, "file:line x
    count". With timed=True also (the run's result, its ms: host clock
    around execute plus a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = db.execute(sql)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in caught
                                if "synchroniz" in str(w.message))
    text = (f"{sum(sites.values())} ("
            f"{', '.join(f'{k} x {v}' for k, v in sorted(sites.items()))})")
    return (text, (res, ms)) if timed else text


def _lut(keys: np.ndarray) -> np.ndarray:
    """position of each (unique) key, -1 for the other values up to the
    largest key."""
    lut = np.full(int(keys.max()) + 1, -1, np.int64)
    lut[keys] = np.arange(len(keys))
    return lut


def _probe(lut: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """lut's position of each key, -1 where it has none."""
    inside = keys < len(lut)
    return np.where(inside, lut[np.where(inside, keys, 0)], -1)


def j1_oracle(tables, q: str) -> tuple[int, float, float]:
    """(rows, sum(v1), sum(v2)) of J1 question q with numpy: each right
    table's join key is unique where the question joins on it."""
    x = tables["x"][0]
    name, key = J1_ON[q]
    right = tables[name][0]
    pos = _probe(_lut(right[key]), x[key])
    hit = pos >= 0
    s2 = float(right["v2"][pos[hit]].sum())
    if q == "j1_q3":                            # LEFT: every x row
        return ROWS, float(x["v1"].sum()), s2
    return int(hit.sum()), float(x["v1"][hit].sum()), s2


def check_j1(q: str, ans: Table, want) -> None:
    """The CREATE TABLE AS result: x's seven columns first, its row count
    exactly, sum(v1) and sum(v2) (NULLs skipped) to FLOAT_RTOL."""
    names = ans.column_names()
    if names[:7] != ["id1", "id2", "id3", "id4", "id5", "id6", "v1"] \
            or names[-1] != "v2":
        raise AssertionError(f"{q}: columns {names}")
    rows, s1, s2 = want
    if ans.nrows != rows:
        raise AssertionError(f"{q}: {ans.nrows} rows, numpy {rows}")
    got = []
    for nm in ("v1", "v2"):
        c = ans.columns[nm]
        d = c.data[:ans.nrows].to(torch.float64)
        if c.valid is not None:
            d = torch.where(c.valid[:ans.nrows], d, 0.0)
        got.append(float(d.sum()))
    for nm, g, w in zip(("v1", "v2"), got, (s1, s2)):
        if abs(g - w) > FLOAT_RTOL * abs(w):
            raise AssertionError(f"{q}: sum({nm}) {g!r} vs numpy {w!r}")


def set_oracle(tables, q: str) -> list[np.ndarray]:
    """Each output column of set query q, in order, from numpy: the JAX
    package's orders (left-input order for EXCEPT and INTERSECT, keys
    ascending for UNION and GROUP BY, NULL last)."""
    x, med, big = (tables[t][0] for t in ("x", "medium", "big"))
    if q == "j1_outer_grouped":
        pos = _probe(_lut(med["id2"]), x["id2"])
        code = np.where(pos >= 0, med["id4"][np.maximum(pos, 0)], -1)
        keys, inv = np.unique(code, return_inverse=True)
        cnt = np.bincount(inv)
        s1 = np.bincount(inv, weights=x["v1"])
        if keys[0] == -1:                       # the NULL group goes last
            keys, cnt, s1 = (np.r_[a[1:], a[:1]] for a in (keys, cnt, s1))
        return [keys.astype(np.int32), cnt.astype(np.int64), s1]
    if q == "set_union":
        return [np.unique(np.concatenate([x["id2"], med["id2"]]))]
    if q == "set_except":
        code = x["id1"].astype(np.int64) << 32 | x["id2"]
        _u, first = np.unique(code, return_index=True)
        first = np.sort(first)
        mcode = med["id1"].astype(np.int64) << 32 | med["id2"]
        keep = first[~np.isin(code[first], mcode)]
        return [x["id1"][keep], x["id2"][keep]]
    if q in ("set_intersect", "set_intersect_all"):    # both id3 unique
        return [x["id3"][np.isin(x["id3"], big["id3"])]]
    if q == "set_except_all":               # medium's id2 are unique
        u, first = np.unique(x["id2"], return_index=True)
        keep = np.ones(ROWS, bool)
        keep[first[np.isin(u, med["id2"])]] = False
        return [x["id2"][keep]]
    id1, id2, id3 = x["id1"], x["id2"], x["id3"]
    if q == "distinct_grouped":
        keys = np.unique(id1)
        return [keys,
                np.array([len(np.unique(id3[id1 == k])) for k in keys],
                         np.int64),
                np.array([np.unique(id2[id1 == k]).sum() for k in keys],
                         np.int64)]
    return [np.array([len(np.unique(id3))], np.int64)]


def check_set(tables, q: str, res) -> None:
    """Every column row for row: exactly, float sums to FLOAT_RTOL; the
    grouped outer join's NULL group by its validity."""
    want = set_oracle(tables, q)
    cols = list(res.table.columns.values())
    if len(cols) != len(want):
        raise AssertionError(f"{q}: {len(cols)} columns, want {len(want)}")
    for i, (c, w) in enumerate(zip(cols, want)):
        got = c.to_numpy()
        if got.shape != w.shape:
            raise AssertionError(f"{q}.{c.name}: shape {got.shape} vs "
                                 f"{w.shape}")
        if q == "j1_outer_grouped" and i == 0:
            null = (np.zeros(len(got), bool) if c.valid is None
                    else ~c.valid[:res.nrows].cpu().numpy())
            np.testing.assert_array_equal(null, w == -1,
                                          err_msg=f"{q} NULL key")
            got = np.where(null, -1, got)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, w, rtol=FLOAT_RTOL,
                                       err_msg=f"{q}.{c.name}")
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{q}.{c.name}")


def nonfinite_data() -> dict[str, np.ndarray]:
    """G1_1e7_1e1_0_0 with v3 NaN at 1 row, +inf at 3 and -inf at 3: one
    id3 group holds both infinities."""
    data = h2o_g1(ROWS, K_GROUPS, SEED)
    v3, id3 = data["v3"], data["id3"]
    both = np.flatnonzero(id3 == id3[0])
    v3[both[0]], v3[both[1]] = np.inf, -np.inf
    v3[np.flatnonzero(id3 == id3[100])[0]] = np.nan
    v3[[200, 300]] = np.inf
    v3[[400, 500]] = -np.inf
    return data


def check_nonfinite(q: str, res, want, cnt, nulls) -> None:
    """check_result over the finite groups; the others must be NaN or the
    same infinity as numpy's nan-aware sums give."""
    bad = np.zeros(len(cnt), bool)
    for w in want.values():
        if w.dtype.kind == "f":
            bad |= ~np.isfinite(w)
    if not bad.any():
        if q != "q1":                   # q1 reads no float column
            raise AssertionError(f"{q}: numpy finds no non-finite group")
        check_result(q, res, want, cnt, nulls)
        return
    for nm, w in want.items():
        if w.dtype.kind != "f":
            continue
        got = res.table.columns[nm].to_numpy()[bad]
        np.testing.assert_array_equal(got, w[bad],
                                      err_msg=f"{q}.{nm} non-finite")
    keep = torch.from_numpy(np.flatnonzero(~bad))
    sub = Table(res.table.name, [Column(c.name, c.sqltype,
                                        c.data[keep.to(c.data.device)],
                                        nrows=len(keep),
                                        dictionary=c.dictionary)
                                 for c in res.table.columns.values()])
    kn = keep.numpy()
    check_result(q, Result(sub), {k: v[kn] for k, v in want.items()},
                 cnt[kn], {k: v[kn] for k, v in nulls.items()})


def time_join_parts(db) -> None:
    """The general join's and the set operations' parts at phase 6's
    shapes, each called as engine/join.equi_join and executor._set_op
    call it: device time (median of 10) beside the bound of its bytes
    (inputs read once, outputs written once, at 3.35 TB/s); the parts
    that read a count on the host, and the whole calls, with the host's
    gaps. J1 q5's join (1e7 probe keys, 1e7 unique build keys), q2's
    (1e4 build keys), and the INTERSECT of x.id3 and big.id3."""
    def timed(label, fn, nbytes, host_gaps=False):
        ms = cuda_ms(fn, host_gaps=host_gaps)
        b = bound_ms(nbytes)
        gaps = ", with the host's gaps" if host_gaps else ""
        print(f"# {label}: {ms:.4f} ms device time (median of 10{gaps}); "
              f"{nbytes} bytes, bound {b:.4f} ms, {b / ms:.1%} of bound",
              flush=True)

    x = db.catalog.get("x").columns
    for q, rname, key in (("j1_q5", "big", "id3"), ("j1_q2", "medium", "id2")):
        lcol, rcol = x[key], db.catalog.get(rname).columns[key]
        lk, rk = lcol.data, rcol.data
        nl, nr = lk.shape[0], rk.shape[0]
        lok = torch.arange(nl, device=lk.device) < lcol.nrows
        rok = torch.arange(nr, device=rk.device) < rcol.nrows
        lh = J._key_hash([lk])
        rh = torch.where(rok, J._key_hash([rk]), torch.iinfo(torch.int64).max)
        rh_s, perm = torch.sort(rh, stable=True)
        lo = torch.searchsorted(rh_s, lh, side="left")
        hi = torch.searchsorted(rh_s, lh, side="right")
        counts = torch.where(lok, hi - lo, 0)
        total = int(counts.sum())
        cap = config.bucket_size(max(total, 1))
        li, within, valid = ragged.expand(counts, cap, total)
        ri = perm[(lo[li] + within).clamp(0, nr - 1)]
        shape = f"{q}'s join ({lcol.nrows} x {rcol.nrows} keys, {total} pairs)"
        timed(f"{shape}: hash of the probe keys", lambda: J._key_hash([lk]),
              12 * nl)
        timed(f"{shape}: stable sort of the build hashes",
              lambda: torch.sort(rh, stable=True), 24 * nr)
        timed(f"{shape}: two searchsorted probes",
              lambda: (torch.searchsorted(rh_s, lh, side="left"),
                       torch.searchsorted(rh_s, lh, side="right")),
              8 * nl + 8 * nr + 16 * nl)
        timed(f"{shape}: ragged.expand", lambda: ragged.expand(
            counts, cap, total), 8 * nl + 17 * cap)
        timed(f"{shape}: verify and compact",
              lambda: compact_indices(valid & rok[ri] & (lk[li] == rk[ri])),
              25 * cap + 4 * 2 * total + 8 * total, host_gaps=True)
        timed(f"{shape}: the whole equi_join",
              lambda: J.equi_join([lk], [rk], lcol.nrows, rcol.nrows),
              4 * nl + 4 * nr + 16 * total, host_gaps=True)

    left = Table("l", [x["id3"]])
    right = Table("r", [db.catalog.get("big").columns["id3"]])
    n1, n2 = left.nrows, right.nrows
    cap = config.bucket_size(n1 + n2)
    dev = x["id3"].device
    cat = torch.cat([right.columns["id3"].data[:n2], x["id3"].data[:n1]])
    keys = [(torch.cat([cat, cat.new_zeros(cap - n1 - n2)]), True)]
    ok = torch.arange(cap, device=dev) < n1 + n2
    perm, valid_s, _sk, starts, _l = fused_groupby.sorted_groups(ok, keys)
    flags = (valid_s & (perm >= n2)).to(torch.int64) \
        | ((valid_s & (perm < n2)).to(torch.int64) << 32)
    shape = f"INTERSECT of x.id3 and big.id3 ({n1} + {n2} rows)"
    timed(f"{shape}: the tuples' stable sort",
          lambda: fused_groupby.sorted_groups(ok, keys), 20 * cap)
    timed(f"{shape}: seg_cumsum_i64 of the side flags",
          lambda: S.seg_cumsum(flags, starts), 17 * cap)
    timed(f"{shape}: the whole _set_op",
          lambda: E._set_op(left, right, "intersect"),
          4 * (n1 + n2) + 4 * n1, host_gaps=True)


def run_slice10(dev, walls, tables) -> dict[str, dict[str, int]]:
    """Phase 6: db-benchmark's J1 questions, a grouped outer join, five
    set operations and two DISTINCT aggregates on tables
    (J1_1e7_NA_0_0), then q1, q3, q5 and q10 over G1_1e7_1e1_0_0 with
    non-finite v3 values; each against numpy, with its median of 3 warm
    runs, its host syncs (read and measured) and its launches."""
    db = connect(device=dev)
    for name, (arrays, dicts) in tables.items():
        load(db, name, arrays, dev, types={c: T.StrT for c in dicts},
             dictionaries=dicts)
    launches = {}
    for q, sql in J1.items():
        ctas = f"CREATE TABLE ans AS {sql}"
        reset_launches()
        _res, ms = timed_runs(db, ctas, 3)
        launches[q] = {k: v for k, v in K.LAUNCHES.items() if v}
        ans = db.catalog.get("ans")
        check_j1(q, ans, j1_oracle(tables, q))
        walls[q] = ms
        print(f"# {q}: {ans.nrows} rows x {len(ans.columns)} columns, "
              f"{ms:.3f} ms (median of 3 warm runs), syncs read "
              f"{SYNCS[q]} measured {count_syncs(db, ctas)}, matches numpy, "
              f"launches {launches[q]}", flush=True)
    time_join_parts(db)
    launches.update(run_queries(
        db, SET_QUERIES, lambda q, res: check_set(tables, q, res),
        walls=walls))
    for q, sql in SET_QUERIES.items():
        print(f"# {q}: syncs read {SYNCS[q]} measured "
              f"{count_syncs(db, sql)}", flush=True)
    del db

    data = nonfinite_data()
    db = connect(device=dev)
    load(db, "source", data, dev)
    fits = []
    gate = fused_groupby.float_sums_fit

    def spy(*args, **kw):
        fits.append(gate(*args, **kw))
        return fits[-1]
    fused_groupby.float_sums_fit = spy
    try:
        for q in NONFINITE:
            fits.clear()
            db.execute(QUERIES[q])
            path = ("the fused tier" if all(fits)
                    else "the general engine (the fused tier declined)")
            print(f"# {q}@nonfinite answered by {path}", flush=True)
    finally:
        fused_groupby.float_sums_fit = gate
    launches.update(run_queries(
        db, {q: QUERIES[q] for q in NONFINITE},
        lambda q, res: check_nonfinite(q, res, *oracle(data, q)),
        tag="@nonfinite", walls=walls))
    for q in NONFINITE:
        print(f"# {q}@nonfinite: syncs read {SYNCS[q + '@nonfinite']} "
              f"measured {count_syncs(db, QUERIES[q])}", flush=True)
    return launches


def sorted_domain(parts, orders):
    """numpy's side of a window: the stable order by (parts, orders), most
    significant first (ties in row order), and in that order each row's
    partition start, peer-group start (partition or an order key
    changes), partition's first and last row, and peer group's last
    row."""
    order = np.lexsort(tuple(reversed(list(parts) + list(orders))))
    idx = np.arange(len(order))

    def starts(keys):
        f = np.zeros(len(order), bool)
        f[0] = True
        for k in keys:
            ks = k[order]
            f[1:] |= ks[1:] != ks[:-1]
        return f

    def ends(f):
        e = np.r_[np.flatnonzero(f)[1:], len(order)] - 1
        return e[np.cumsum(f) - 1]

    ps = starts(parts)
    qs = starts(list(parts) + list(orders))
    start = np.maximum.accumulate(np.where(ps, idx, 0))
    return order, ps, qs, start, ends(ps), ends(qs)


def unsort(order, a):
    out = np.empty_like(a)
    out[order] = a
    return out


def window_oracle(tables, q: str) -> dict[str, np.ndarray]:
    """Each phase-7 window query's answer columns in row order, a column
    with NULLs as (values, NULL mask), from sorted_domain."""
    if q in ("w_rank", "w_lag", "w_moving", "w_extreme"):
        t = tables["trades"]
        sym, tm, price = t["stocksymbol"], t["time"], t["price"]
    else:
        x = tables["nas" if q == "w_nulls" else "h2o"]
    if q == "w_partition":
        s = np.bincount(x["id3"], weights=x["v1"]).astype(np.int64)
        c = np.bincount(x["id3"])
        return {"s": s[x["id3"]], "c": c[x["id3"]]}
    if q == "w_rank":
        order, ps, qs, start, last, peer_last = sorted_domain(
            [sym], [-price.astype(np.int64)])
        idx = np.arange(ROWS)
        peer_first = np.maximum.accumulate(np.where(qs, idx, 0))
        c = np.cumsum(qs)
        return {"rk": unsort(order, peer_first - start + 1),
                "dr": unsort(order, c - c[start] + 1),
                "rn": unsort(order, idx - start + 1)}
    if q in ("w_lag", "w_moving", "w_extreme"):
        order, ps, qs, start, last, peer_last = sorted_domain([sym], [tm])
        p = price[order].astype(np.int64)
        idx = np.arange(ROWS)
        if q == "w_lag":
            prev = np.r_[0, p[:-1]]
            lead = np.r_[p[2:], 0, 0]
            return {"d": (unsort(order, p - prev), unsort(order,
                                                          idx == start)),
                    "ld": unsort(order, np.where(idx + 2 <= last, lead, 0))}
        if q == "w_moving":
            _syms, _cnt, a = trades_oracle(t, "avgs")   # avgs(5, price)
            return {"a": unsort(order, a)}
        mx = p.copy()
        for s in range(1, 6):
            ahead = np.r_[p[s:], np.zeros(s, np.int64)]
            behind = np.r_[np.zeros(s, np.int64), p[:-s]]
            mx = np.maximum(mx, np.where(idx + s <= last, ahead, mx))
            mx = np.maximum(mx, np.where(idx - s >= start, behind, mx))
        part = np.cumsum(ps) - 1                   # segmented running min
        mn = np.minimum.accumulate(p - part * 1000) + part * 1000
        return {"mx": unsort(order, mx.astype(np.int32)),
                "mn": unsort(order, mn.astype(np.int32))}
    if q == "w_peers":
        order, ps, qs, start, last, peer_last = sorted_domain(
            [x["id4"]], [x["id6"]])
        v = x["v1"][order].astype(np.int64)
        c = np.cumsum(v)
        run = c - c[start] + v[start]
        return {"s": unsort(order, run[peer_last])}
    if q == "w_dist":
        order, ps, qs, start, last, peer_last = sorted_domain(
            [x["id1"]], [x["v3"]])
        idx = np.arange(ROWS)
        peer_first = np.maximum.accumulate(np.where(qs, idx, 0))
        n = last - start + 1
        pr = np.where(n > 1, (peer_first - start).astype(np.float64)
                      / np.maximum(n - 1, 1), 0.0)
        cd = (peer_last - start + 1).astype(np.float64) / n
        return {"pr": unsort(order, pr), "cd": unsort(order, cd),
                "nt": unsort(order, (idx - start) * 4 // n + 1)}
    if q == "w_nulls":
        order, ps, qs, start, last, peer_last = sorted_domain(
            [x["id1"]], [x["id4"]])
        v3 = x["v3"]
        ok = ~np.ma.getmaskarray(v3)[order]
        v = np.where(ok, np.ma.getdata(v3)[order], 0).astype(np.float64)
        idx = np.arange(ROWS)
        cnt = np.zeros(ROWS, np.int64)
        tot = np.zeros(ROWS)
        for s in range(-2, 3):
            j = np.clip(idx + s, 0, ROWS - 1)
            inside = (idx + s >= start) & (idx + s <= last)
            cnt += inside & ok[j]
            tot += np.where(inside, v[j], 0.0)
        r = np.cumsum(np.abs(v))
        run_abs = (r - r[start] + np.abs(v)[start])[np.minimum(idx + 2,
                                                               last)]
        return {"c": unsort(order, cnt),
                "a": (unsort(order, tot / np.maximum(cnt, 1)),
                      unsort(order, cnt == 0)),
                "a_tol": unsort(order, FRAME_F64_TOL * run_abs
                                / np.maximum(cnt, 1))}
    raise KeyError(q)


def check_window(tables, q: str, res) -> None:
    """A phase-7 window query against window_oracle: row counts, NULLs,
    integers, ranks, counts and row picks exactly; w_moving to
    TRADES_RTOL; w_nulls' avg within its a_tol (FRAME_F64_TOL)."""
    if q == "w_q8":
        ids, cnt, top2 = q8_oracle(tables["h2o"])
        if res.column_names() != ["id6", "largest2_v3"]:
            raise AssertionError(f"w_q8: columns {res.column_names()}")
        id6 = res.table.columns["id6"].to_numpy()
        v3 = res.table.columns["largest2_v3"].to_numpy()
        order = np.lexsort((-v3, id6))          # per id6, v3 descending
        np.testing.assert_array_equal(id6[order],
                                      np.repeat(ids, np.minimum(cnt, 2)),
                                      err_msg="w_q8 id6")
        np.testing.assert_array_equal(v3[order], top2, err_msg="w_q8 v3")
        return
    want = window_oracle(tables, q)
    if res.nrows != ROWS:
        raise AssertionError(f"{q}: {res.nrows} rows")
    for nm, w in want.items():
        if nm.endswith("_tol"):
            continue
        col = res.table.columns[nm]
        got = col.to_numpy()
        null = (np.zeros(ROWS, bool) if col.valid is None
                else ~col.valid[:ROWS].cpu().numpy())
        w, wnull = w if isinstance(w, tuple) else (w, np.zeros(ROWS, bool))
        np.testing.assert_array_equal(null, wnull, err_msg=f"{q}.{nm} NULL")
        if q == "w_moving":
            err = float(np.max(np.abs(got - w) / np.abs(w)))
            if not err <= TRADES_RTOL:
                raise AssertionError(f"{q}.{nm}: relative error {err}")
        elif nm == "a":                             # w_nulls' avg
            bad = ~null & (np.abs(got - w) > want["a_tol"])
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(f"{q}.a: {int(bad.sum())} rows differ, "
                                     f"first {i}: {got[i]!r} vs {w[i]!r}")
        else:
            np.testing.assert_array_equal(np.where(null, 0, got),
                                          np.where(null, 0, w),
                                          err_msg=f"{q}.{nm}")


def udf_oracle(tables, q: str):
    """udf_cov: per (id2, id4), key-ascending, udfcov's loop as the
    aggregates it rewrites into, over exact int64 sums; udf_scalar: per
    symbol, the sum of f(price, quantity) in float64."""
    if q == "udf_cov":
        x = tables["h2o"]
        keys, inv, cnt = _groups({"id2": x["id2"], "id4": x["id4"]})
        a, b = x["v1"].astype(np.int64), x["v2"].astype(np.int64)
        sx, sy, sxy = (np.bincount(inv, weights=z).astype(np.int64)
                       for z in (a, b, a * b))
        n = cnt.astype(np.int64)
        return {"id2": keys["id2"].astype(np.int32),
                "id4": keys["id4"].astype(np.int32),
                "udfcov_v1_v2": (sxy - sx * sy / n) / n}, cnt, {}
    t = tables["trades"]
    p, qty = t["price"].astype(np.float64), t["quantity"]
    f = (t["price"] * qty) / 100 - p
    syms = np.unique(t["stocksymbol"])
    return (syms, np.bincount(t["stocksymbol"], weights=f),
            np.bincount(t["stocksymbol"], weights=np.abs(f)))


def check_udf(tables, q: str, res) -> None:
    if q == "udf_cov":
        check_result(q, res, *udf_oracle(tables, q))
        return
    syms, want, abs_sum = udf_oracle(tables, q)
    cols = res.table.columns
    np.testing.assert_array_equal(cols["stocksymbol"].to_numpy(), syms,
                                  err_msg="udf_scalar symbols")
    got = cols["s"].to_numpy()
    bad = np.abs(got - want) > ADD_F64_TOL * abs_sum
    if bad.any():
        raise AssertionError(f"udf_scalar: {int(bad.sum())} symbols differ")


def run_slice11(dev, data, walls) -> dict[str, dict[str, int]]:
    """Phase 7: OVER windows and user FUNCTIONs through
    connect(device="cuda").execute at 1e7 rows, on G1_1e7_1e1_0_0 (as x),
    trades and G1_1e7_1e1_5_0 (as x); each against numpy, with its median
    of 3 warm runs, its host syncs (read and measured) and its launches
    per run."""
    launches = {}
    trade_arrays, d = trades(ROWS, 100, 7)
    tables = {"h2o": data, "trades": trade_arrays}
    for name, queries in PHASE7:
        db = connect(device=dev)
        if name == "trades":
            load(db, "trades", trade_arrays, dev,
                 types={"stocksymbol": T.StrT},
                 dictionaries={"stocksymbol": d})
        else:
            if name == "nas":
                tables["nas"] = h2o_g1(ROWS, K_GROUPS, SEED, nas=5)
            load(db, "x", tables[name], dev)
        db.execute(UDFCOV)
        db.execute(SCALAR_UDF)
        for q in queries:
            sql = WINDOW_QUERIES[q]
            reset_launches()
            res, ms = timed_runs(db, sql, 3)
            total = {k: v for k, v in K.LAUNCHES.items() if v}
            launches[q] = total
            if q.startswith("udf"):
                check_udf(tables, q, res)
            else:
                check_window(tables, q, res)
            walls[q] = ms
            per_run = {k: v / 4 for k, v in total.items()}
            print(f"# {q}: {res.nrows} rows, {ms:.3f} ms (median of 3 warm "
                  f"runs), syncs read {SYNCS[q]} measured "
                  f"{count_syncs(db, sql)}, matches numpy, launches per run "
                  f"{per_run}", flush=True)
        del db
    return launches


def group_matrix(keys: np.ndarray, vals: np.ndarray):
    """Key-ascending groups of vals, rows in insertion order: (unique keys,
    counts, the [G, Lmax] float64 matrix of each group's rows, zeros
    past each group's end)."""
    order = np.argsort(keys, kind="stable")
    uk, starts, cnt = np.unique(keys[order], return_index=True,
                                return_counts=True)
    gid = np.repeat(np.arange(len(uk)), cnt)
    pos = np.arange(len(keys)) - np.repeat(starts, cnt)
    mat = np.zeros((len(uk), int(cnt.max())))
    mat[gid, pos] = vals[order]
    return uk, cnt, mat


def cov2_oracle(x: np.ndarray, y: np.ndarray, cnt: np.ndarray, win: int):
    """covariances2's two loops, one position at a time over every group
    at once (the body's own sequence of float64 operations); the [G,
    Lmax] _builtin_ret."""
    g, lmax = x.shape
    rows = np.arange(g)
    ln = cnt.astype(np.float64)
    ret = np.zeros((g, lmax))
    xm, ym = x[:, 0].copy(), y[:, 0].copy()          # every group has a row
    w = np.where(win > ln, ln, float(win))
    for i in range(1, win):
        act = i < w
        xm = np.where(act, xm + x[:, i], xm)
        ym = np.where(act, ym + y[:, i], ym)
        d = (x[:, :i] - (xm / i)[:, None]) * (y[:, :i] - (ym / i)[:, None])
        ret[:, i] = np.where(act, d.sum(1) / i, ret[:, i])
    xm, ym = xm / w, ym / w
    for i in range(1, lmax):
        act = (i >= w) & (i < ln)
        if not act.any():
            continue
        if not (w[act] == win).all():
            raise AssertionError("cov2 oracle: a second-loop group has w < win")
        back = np.clip(i - w.astype(np.int64), 0, lmax - 1)
        xm = np.where(act, xm + (x[:, i] - x[rows, back]) / w, xm)
        ym = np.where(act, ym + (y[:, i] - y[rows, back]) / w, ym)
        lo = max(i - win, 0)
        d = (x[:, lo:i] - xm[:, None]) * (y[:, lo:i] - ym[:, None])
        ret[:, i] = np.where(act, d.sum(1) / win, ret[:, i])
    return ret


def ewma_oracle(x: np.ndarray, cnt: np.ndarray, a: float):
    """ewma's loop, one position at a time over every group at once."""
    m = x[:, 0].copy()
    b = 1 - a
    ret = np.zeros_like(x)
    for i in range(x.shape[1]):
        m = np.where(i < cnt, a * x[:, i] + b * m, m)
        ret[:, i] = m
    return ret


def flat_rows(mat: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Each group's first cnt values, group after group."""
    return mat[np.arange(mat.shape[1]) < cnt[:, None]]


def loop_syncs(passes: int) -> int:
    """The host checks of a device loop of ``passes`` passes
    (engine/udf_device._Tracer._for): after condition 1, 2, 4, 8, 16, 32
    and then every 32nd, up to the first at or past condition passes + 1,
    where no group is active."""
    check, k = 1, 1
    while check < passes + 1:
        check += min(check, 32)
        k += 1
    return k


def class_max(cnt: np.ndarray) -> list[int]:
    """The longest group of each power-of-two length class present."""
    cls = np.frexp(np.maximum(cnt - 1, 0).astype(np.float64))[1]
    return [int(cnt[cls == c].max()) for c in np.unique(cls)]


def udf_syncs(q: str, cnt: np.ndarray) -> int:
    """Host syncs of one warm run, read from the code: the general GROUP
    BY, 4 for one key column (the key's stats, executor._KeyCol, 1; the
    dense grouping's torch.bincount 2 and group count 1), and for
    u_clip_where 6 (the WHERE's compaction 1, the two keys' stats 2, the
    bincount 2 and the group count 1); the length classes 1; then each
    class's loops (loop_syncs of the class's longest group):
    covariances2 min(4, l) - 1 and l - 4 passes, clipsum and ewma l."""
    loops = 0
    for mx in class_max(cnt):
        if q == "u_cov2":
            loops += loop_syncs(min(4, mx) - 1) + loop_syncs(max(mx - 4, 0))
        else:
            loops += loop_syncs(mx)
    head = 6 if q == "u_clip_where" else 4
    return head + 1 + loops


def udf_oracle12(tables, q: str):
    """(keys, counts, expected values: per group for a scalar body, flat
    row values for a vector one) of a phase-8 query."""
    if q == "u_ewma":
        t = tables["trades"]
        uk, cnt, mat = group_matrix(t["stocksymbol"], t["price"])
        return uk, cnt, flat_rows(ewma_oracle(mat, cnt, 0.1), cnt)
    x = tables["h2o"]
    if q == "u_cov2":
        uk, cnt, xm = group_matrix(x["id3"], x["v1"])
        _uk, _cnt, ym = group_matrix(x["id3"], x["v3"])
        return uk, cnt, flat_rows(cov2_oracle(xm, ym, cnt, 4), cnt)
    keep = np.ones(len(x["v3"]), bool) if q == "u_clip" else x["v1"] > 2
    if q == "u_clip":
        key = x["id3"].astype(np.int64)
    else:
        key = x["id4"].astype(np.int64) << 20 | x["id6"]
    uk, inv = np.unique(key[keep], return_inverse=True)
    cnt = np.bincount(inv)
    s = np.bincount(inv, weights=np.minimum(x["v3"][keep], 50.0))
    if q == "u_clip_where":
        uk = (uk >> 20, uk & ((1 << 20) - 1))
    return uk, cnt, s


def check_udf12(q: str, res, want) -> None:
    uk, cnt, vals = want
    cols = list(res.table.columns.values())
    if q == "u_clip_where":
        np.testing.assert_array_equal(cols[0].to_numpy(), uk[0],
                                      err_msg=f"{q} id4")
        np.testing.assert_array_equal(cols[1].to_numpy(), uk[1],
                                      err_msg=f"{q} id6")
    else:
        np.testing.assert_array_equal(cols[0].to_numpy(), uk,
                                      err_msg=f"{q} keys")
    got = cols[-1]
    if q in ("u_cov2", "u_ewma"):
        np.testing.assert_array_equal(got.offsets_numpy(),
                                      np.r_[0, np.cumsum(cnt)],
                                      err_msg=f"{q} offsets")
    g = got.to_numpy()
    if g.dtype != np.float64 or g.shape != vals.shape:
        raise AssertionError(f"{q}: {g.dtype} {g.shape} vs {vals.shape}")
    rtol, atol = ((COV2_RTOL, COV2_ATOL) if q == "u_cov2"
                  else (CLIP_RTOL, 0.0))
    bad = ~(np.abs(g - vals) <= atol + rtol * np.abs(vals))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise AssertionError(f"{q}: {int(bad.sum())} values differ, first "
                             f"{i}: {g[i]!r} vs {vals[i]!r}")


def write_trades_csv(path: Path, arrays, d) -> None:
    """The trades table as CSV with a header, in column order."""
    names = list(arrays)
    syms = np.asarray(d.strings(), dtype=object)[arrays["stocksymbol"]]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for lo in range(0, len(syms), 1_000_000):
            cols = [syms[lo:lo + 1_000_000].tolist()] + [
                arrays[nm][lo:lo + 1_000_000].tolist() for nm in names[1:]]
            f.write("".join(f"{a},{b},{c},{e}\n" for a, b, c, e in zip(*cols)))


def ewma_by_symbol(res) -> dict[str, np.ndarray]:
    cols = list(res.table.columns.values())
    offs, vals = cols[1].offsets_numpy(), cols[1].to_numpy()
    return {s: vals[offs[i]:offs[i + 1]]
            for i, s in enumerate(cols[0].to_python())}


def run_io(dev, arrays, d, ewma_res, tmp: Path) -> dict[str, int]:
    """io_trades: the trades table written as CSV (a header, four
    columns) and LOADed into a new table, every column equal to the
    generated arrays; ewma on it equal to the run on the generated table;
    a grouped sum written INTO OUTFILE and read back with numpy. Returns
    the launches after the load."""
    n = len(arrays["price"])
    path = tmp / "trades.csv"
    t0 = time.perf_counter()
    write_trades_csv(path, arrays, d)
    wrote = time.perf_counter() - t0
    db = connect(device=dev, base_dir=str(tmp))
    db.execute("CREATE TABLE trades_csv(stocksymbol VARCHAR(8), time INT, "
               "quantity INT, price INT)")
    db.execute(EWMA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.execute('LOAD DATA INFILE "trades.csv" INTO TABLE trades_csv '
               'FIELDS TERMINATED BY ","')
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tbl = db.catalog.get("trades_csv")
    if tbl.nrows != n:
        raise AssertionError(f"io_trades: {tbl.nrows} rows loaded of {n}")
    sym = tbl.columns["stocksymbol"]
    names = np.asarray(sym.dictionary.strings(), dtype=object)[sym.to_numpy()]
    want = np.asarray(d.strings(), dtype=object)[arrays["stocksymbol"]]
    if not (names == want).all():
        raise AssertionError("io_trades: stocksymbol differs")
    for nm in ("time", "quantity", "price"):
        np.testing.assert_array_equal(tbl.columns[nm].to_numpy(), arrays[nm],
                                      err_msg=f"io_trades {nm}")
    print(f"# io_trades: wrote {n} rows ({path.stat().st_size} bytes) in "
          f"{wrote:.2f} s; LOAD DATA INFILE {load_s:.3f} s, "
          f"{n / load_s:.0f} rows/s; every column equals the generated "
          f"arrays", flush=True)
    reset_launches()
    got = ewma_by_symbol(db.execute(UDF_QUERIES["u_ewma"].replace(
        "FROM trades", "FROM trades_csv")))
    base = ewma_by_symbol(ewma_res)
    if sorted(got) != sorted(base):
        raise AssertionError("io_trades: ewma symbols differ")
    for s_, v in base.items():
        np.testing.assert_allclose(got[s_], v, rtol=EWMA_RTOL, atol=0,
                                   err_msg=f"io_trades ewma {s_}")
    db.execute("SELECT stocksymbol, sum(quantity) FROM trades_csv GROUP BY "
               "stocksymbol INTO OUTFILE \"sums.csv\" FIELDS TERMINATED BY "
               "\",\"")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    back = np.loadtxt(tmp / "sums.csv", delimiter=",", comments=None,
                      dtype=[("s", object), ("q", np.int64)], ndmin=1)
    qty = np.bincount(arrays["stocksymbol"], weights=arrays["quantity"])
    want = {s_: int(qty[i]) for i, s_ in enumerate(d.strings())}
    if {str(s_): int(q) for s_, q in back} != want or len(back) != len(want):
        raise AssertionError("io_trades: INTO OUTFILE differs")
    if db.stats.udf_paths != {"traced": 1}:
        raise AssertionError(f"io_trades routes {db.stats.udf_paths}")
    print(f"# io_trades: ewma on the loaded table equals the generated "
          f"table's; INTO OUTFILE read back with numpy equals the sums; "
          f"launches {launches}", flush=True)
    return launches


def run_slice12(dev, data, walls) -> dict[str, dict[str, int]]:
    """Phase 8: AGGREGATION FUNCTION bodies the rewrite declines through
    connect(device="cuda").execute, on x = G1_1e7_1e1_0_0 and trades
    (PHASE8_TRADES rows, 100 symbols), each against a numpy oracle that
    runs the body's loop one position at a time over all groups at once,
    with its median of 3 warm runs (u_ewma: one run), its host syncs
    (read: udf_syncs; measured), its route (session.stats.udf_paths,
    never interpreted) and its launches; then io_trades (CSV LOAD, INTO
    OUTFILE)."""
    launches = {}
    trade_arrays, d = trades(PHASE8_TRADES, 100, 7)
    tables = {"h2o": data, "trades": trade_arrays}
    ewma_res = None
    for name, queries in (("h2o", ("u_cov2", "u_clip", "u_clip_where")),
                          ("trades", ("u_ewma",))):
        db = connect(device=dev)
        if name == "trades":
            load(db, "trades", trade_arrays, dev,
                 types={"stocksymbol": T.StrT},
                 dictionaries={"stocksymbol": d})
        else:
            load(db, "x", data, dev)
        for body in (COVARIANCES2, CLIPSUM, EWMA):
            db.execute(body)
        for q in queries:
            sql = UDF_QUERIES[q]
            want = udf_oracle12(tables, q)
            reset_launches()
            db.stats.reset()
            syncs = None
            if q == "u_ewma":
                # one run, its synchronizing calls counted in it: host
                # bound, its warm walls in PERF.md §5 (a depth cut, §4)
                syncs, (res, ms) = count_syncs(db, sql, timed=True)
                runs, timing = 1, "one run, synchronizing calls counted"
            else:
                res, ms = timed_runs(db, sql, 3)
                runs, timing = 4, "median of 3 warm runs"
            total = {k: v for k, v in K.LAUNCHES.items() if v}
            launches[q] = total
            paths = dict(db.stats.udf_paths)
            if paths != {"traced": runs}:
                raise AssertionError(f"{q}: routes {paths}, want traced "
                                     "only")
            check_udf12(q, res, want)
            walls[q] = ms
            if q == "u_ewma":
                ewma_res = res
            per_run = {k: v / runs for k, v in total.items()}
            if syncs is None:
                syncs = count_syncs(db, sql)
            print(f"# {q}: {res.nrows} groups, {ms:.3f} ms ({timing}), "
                  "route traced, syncs read "
                  f"{udf_syncs(q, want[1])} measured {syncs}, "
                  f"matches numpy, launches per run {per_run}", flush=True)
        del db
    with tempfile.TemporaryDirectory() as tmp:
        launches["io_trades"] = run_io(dev, trade_arrays, d, ewma_res,
                                       Path(tmp))
        walls["io_h2o_na"], walls["io_h2o_na loadtxt"] = run_io_nulls(
            dev, Path(tmp))
    return launches


H2O_NA_CSV = ("CREATE TABLE x_csv(id1 INT, id2 INT, id3 INT, id4 INT, "
              "id5 INT, id6 INT, v1 INT, v2 INT, v3 DOUBLE)")


def write_nulls_csv(path: Path, data) -> None:
    """G1_1e7_1e1_5_0 as db-benchmark's CSV holds it: a header, a NULL
    as an empty cell; v3 written as the shortest float64 text of its
    float32 value, so that it reads back exactly."""
    names = list(data)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for lo in range(0, len(data["v3"]), 1_000_000):
            cols = []
            for nm in names:
                a = data[nm][lo:lo + 1_000_000]
                strs = np.ma.getdata(a).astype(
                    np.float64 if nm == "v3" else np.int64).astype(str)
                strs[np.ma.getmaskarray(a)] = ""
                cols.append(strs.tolist())
            f.write("".join(",".join(r) + "\n" for r in zip(*cols)))


def run_io_nulls(dev, tmp: Path) -> tuple[float, float]:
    """io_h2o_na: G1_1e7_1e1_5_0 written as CSV with its NULLs as empty
    cells and LOADed on the native route (the C++ scanner; the schema is
    all INT and REAL): every column's values and NULLs equal the
    generated ones. Then csvio's loadtxt route (np.loadtxt reading the
    numeric columns as strings) on the same file into another table,
    equal to the first. Returns both loads' ms."""
    data = h2o_g1(ROWS, K_GROUPS, SEED, nas=5)
    n = len(data["v3"])
    path = tmp / "g1_na.csv"
    t0 = time.perf_counter()
    write_nulls_csv(path, data)
    wrote = time.perf_counter() - t0
    db = connect(device=dev, base_dir=str(tmp))
    db.execute(H2O_NA_CSV)
    tbl = db.catalog.get("x_csv")
    route = csvio.route(tbl)
    if route != "native":
        raise AssertionError(f"io_h2o_na: the {route} route, want native")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.execute('LOAD DATA INFILE "g1_na.csv" INTO TABLE x_csv '
               'FIELDS TERMINATED BY ","')
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if tbl.nrows != n:
        raise AssertionError(f"io_h2o_na: {tbl.nrows} rows loaded of {n}")
    nulls = 0
    for nm, a in data.items():
        col = tbl.columns[nm]
        null = np.ma.getmaskarray(a)
        valid = (np.ones(n, bool) if col.valid is None
                 else col.valid[:n].cpu().numpy())
        np.testing.assert_array_equal(valid, ~null,
                                      err_msg=f"io_h2o_na {nm} NULLs")
        want = np.ma.getdata(a).astype(col.to_numpy().dtype)
        np.testing.assert_array_equal(col.to_numpy()[~null], want[~null],
                                      err_msg=f"io_h2o_na {nm}")
        nulls += int(null.sum())
    # the loadtxt route on the same file, called directly (it reads the
    # numeric columns as strings, since cells are empty)
    db.execute(H2O_NA_CSV.replace("x_csv", "x_txt"))
    txt = db.catalog.get("x_txt")
    t0 = time.perf_counter()
    csvio._load_numpy(txt, str(path), ",")
    torch.cuda.synchronize()
    txt_s = time.perf_counter() - t0
    for nm in data:
        a, b = tbl.columns[nm], txt.columns[nm]
        same_valid = (a.valid is None and b.valid is None) or (
            a.valid is not None and b.valid is not None
            and torch.equal(a.valid, b.valid))
        if not (same_valid and torch.equal(a.data, b.data)):
            raise AssertionError(f"io_h2o_na {nm}: native and loadtxt differ")
    print(f"# io_h2o_na: wrote {n} rows ({path.stat().st_size} bytes, "
          f"{nulls} empty cells) in {wrote:.2f} s; LOAD DATA INFILE on the "
          f"{route} route {load_s:.3f} s, {n / load_s:.0f} rows/s; every "
          f"column's values and NULLs equal the generated arrays; the "
          f"loadtxt route on the same file {txt_s:.3f} s, "
          f"{n / txt_s:.0f} rows/s, the same table", flush=True)
    path.unlink()
    return load_s * 1e3, txt_s * 1e3


# phase 10: services and surfaces. The stream has G1_1e7_1e1_0_0's schema;
# its triggers run h2o q1 and q3 (when the stream holds half the rows), an
# interval trigger q7, each into a table of its own
STREAM = ("CREATE TABLE stream(id1 INT, id2 INT, id3 INT, id4 INT, id5 INT, "
          "id6 INT, v1 INT, v2 INT, v3 REAL)")
SERVICE_ROWS = 1_000_000         # the SQLite, module and server tables


def stream_procedures(big: int) -> dict[str, str]:
    def into(table: str, q: str) -> str:
        return (f"DROP TABLE IF EXISTS {table}; CREATE TABLE {table} AS "
                + QUERIES[q].replace("FROM source", "FROM stream"))
    return {"s_q1": into("s1", "q1"), "s_q3": into("s3", "q3"),
            "s_big": f"SELECT count(*) >= {big} FROM stream",
            "s_q7": into("s7", "q7")}


def stream_oracle(cols: dict[str, np.ndarray], q: str):
    """q1 or q3 over the rows streamed so far, key-ascending, as oracle
    gives it: (answer, per-group counts, no NULL keys), by bincount over
    the keys themselves (id1 in [1, K], id3 in [1, ROWS / K])."""
    key = KEYS[q][0]
    k = cols[key]
    cnt = np.bincount(k)
    keys = np.flatnonzero(cnt)
    out = {key: keys.astype(np.int32),
           "v1": np.bincount(k, weights=cols["v1"].astype(np.float64)
                             )[keys].astype(np.int64)}
    if q == "q3":
        out["v3"] = np.bincount(k, weights=cols["v3"].astype(np.float64)
                                )[keys] / cnt[keys]
    return out, cnt[keys], {}


def collect_errors(db) -> list[str]:
    """What db.log_error is given from now on (a trigger action's
    exception is logged there, not raised)."""
    errors: list[str] = []
    log_error = db.log_error
    db.log_error = lambda msg: (errors.append(msg), log_error(msg))
    return errors


def time_procedures(db) -> list[tuple[str, float, float]]:
    """Wrap db.run_procedure, which the trigger threads call, so that each
    run appends (name, start, end), end after a synchronize."""
    runs: list[tuple[str, float, float]] = []
    run = db.run_procedure

    def timed(name):
        t = time.perf_counter()
        out = run(name)
        torch.cuda.synchronize()
        runs.append((name, t, time.perf_counter()))
        return out
    db.run_procedure = timed
    return runs


def run_stream(db, data, tmp: Path, runs) -> dict[str, dict[str, int]]:
    """Ten batches of x into stream, each id4 value one batch (the tenth
    by LOAD DATA INFILE of its rows as CSV, on the native route), the
    conditional triggers t1 (s_q1) and t3 (s_q3 when s_big) firing on the
    worker thread: after each batch drain(), then s1 (and s3 once the
    stream holds half the rows; before that s3 stays empty) against
    numpy, and the batch's launches exactly the phase-4 per-run counts
    of q1 (and q3)."""
    n_all = len(data["v1"])
    path = tmp / "batch10.csv"
    t0 = time.perf_counter()
    write_nulls_csv(path, {k: v[data["id4"] == 10] for k, v in data.items()})
    print(f"# stream: batch 10 written as CSV ({path.stat().st_size} bytes) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    per_run = {q: {k: v // 4 for k, v in MAIN_PATH_LAUNCHES[q].items()}
               for q in ("q1", "q3")}
    launches = {}
    seen = np.zeros(n_all, bool)
    for b in range(1, 11):
        if b < 10:
            sql = f"INSERT INTO stream SELECT * FROM x WHERE id4 = {b}"
        else:
            if csvio.route(db.catalog.get("stream")) != "native":
                raise AssertionError("stream: LOAD would not take the "
                                     "native route")
            sql = f'LOAD DATA INFILE "{path.name}" INTO TABLE stream'
        reset_launches()
        runs.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db.execute(sql)
        torch.cuda.synchronize()
        ins = time.perf_counter() - t0
        if not db.triggers.drain(120):
            raise AssertionError(f"stream batch {b}: triggers not done")
        per = {k: v for k, v in K.LAUNCHES.items() if v}
        seen |= data["id4"] == b
        n = int(seen.sum())
        big = n >= n_all // 2
        names = sorted(nm for nm, _, _ in runs)
        want_names = sorted(["s_q1", "s_big"] + (["s_q3"] if big else []))
        if names != want_names:
            raise AssertionError(f"stream batch {b}: ran {names}, want "
                                 f"{want_names}")
        want = collections.Counter(per_run["q1"])
        if big:
            want.update(per_run["q3"])
        if per != dict(want):
            raise AssertionError(f"stream batch {b}: launched {per}, want "
                                 f"{dict(want)}")
        if db.catalog.get("stream").nrows != n:
            raise AssertionError(f"stream batch {b}: "
                                 f"{db.catalog.get('stream').nrows} rows")
        sub = {k: data[k][seen] for k in ("id1", "id3", "v1", "v3")}
        check_result("q1", Result(db.catalog.get("s1")),
                     *stream_oracle(sub, "q1"))
        if big:
            check_result("q3", Result(db.catalog.get("s3")),
                         *stream_oracle(sub, "q3"))
        elif db.catalog.get("s3").nrows:
            raise AssertionError(f"stream batch {b}: s3 filled early")
        launches[f"stream@b{b}"] = per
        acts = ", ".join(f"{nm} {(e - s) * 1e3:.3f} ms" for nm, s, e in runs)
        print(f"# stream batch {b} ({'INSERT … SELECT' if b < 10 else 'LOAD DATA INFILE, native'}): "
              f"{n} rows; the statement {ins * 1e3:.3f} ms, its triggers "
              f"done {(max(e for _, _, e in runs) - t0) * 1e3:.3f} ms after "
              f"it began ({acts}); launches {per}; s1"
              f"{' and s3' if big else ''} match numpy", flush=True)
    path.unlink()
    return launches


def run_interval(db, data, runs) -> dict[str, int]:
    """CREATE TRIGGER t7 ACTION s_q7 INTERVAL 200 while nothing is
    inserted: it fires at least 3 times (at most 10 s), stops firing once
    dropped, s7 equals numpy's q7 over the whole stream, and each firing
    launched q7's seg_scan_multi."""
    reset_launches()
    runs.clear()
    db.execute("CREATE TRIGGER t7 ACTION s_q7 INTERVAL 200")
    t0 = time.perf_counter()
    while len(runs) < 3 and time.perf_counter() - t0 < 10:
        time.sleep(0.02)
    db.execute("DROP TRIGGER t7")
    time.sleep(0.5)                     # a firing under way ends
    fired = len(runs)
    time.sleep(0.6)
    if fired < 3 or len(runs) != fired:
        raise AssertionError(f"interval: {fired} firings, then "
                             f"{len(runs)} after DROP TRIGGER")
    per = {k: v for k, v in K.LAUNCHES.items() if v}
    want = {k: v // 4 * fired for k, v in MAIN_PATH_LAUNCHES["q7"].items()}
    if per != want:
        raise AssertionError(f"interval: launched {per}, want {want}")
    check_result("q7", Result(db.catalog.get("s7")), *oracle(data, "q7"))
    gaps = np.diff([s for _, s, _ in runs]) * 1e3
    print(f"# interval trigger t7 (s_q7, 200 ms): {fired} firings, "
          f"{', '.join(f'{(e - s) * 1e3:.3f}' for _, s, e in runs)} ms each, "
          f"{', '.join(f'{g:.1f}' for g in gaps)} ms apart; none after DROP "
          f"TRIGGER; s7 matches numpy; launches {per}", flush=True)
    return per


def run_sqlite(db, data) -> None:
    """attach a :memory: SQLite, write s1 and SERVICE_ROWS rows of x's id1,
    id3, v1 into it, run a GROUP BY id1 there back into a device table:
    equal to the port's own answer."""
    walls = {}
    t0 = time.perf_counter()
    db.attach("lite", ":memory:")
    db.backend_append("lite", "s1")
    walls["append s1"] = time.perf_counter() - t0
    db.catalog.create(Table.from_numpy("x1m", {
        k: data[k][:SERVICE_ROWS] for k in ("id1", "id3", "v1")},
        device=db.device))
    t0 = time.perf_counter()
    db.backend_append("lite", "x1m")
    walls[f"append {SERVICE_ROWS} rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = db.backend_exec("lite", "SELECT id1, sum(v1) AS v1 FROM x1m "
                          "GROUP BY id1 ORDER BY id1", into="lite_q1")
    walls["GROUP BY id1 there, back"] = time.perf_counter() - t0
    if got.columns["v1"].device != db.device:
        raise AssertionError("sqlite: the answer is not on the card")
    mine = db.execute("SELECT id1, sum(v1) AS v1 FROM x1m GROUP BY id1")
    if Result(got).rows() != mine.rows():
        raise AssertionError("sqlite: GROUP BY id1 differs from the port's")
    back = db.backend_exec("lite", "SELECT id1, v1 FROM s1 ORDER BY id1")
    if Result(back).rows() != Result(db.catalog.get("s1")).rows():
        raise AssertionError("sqlite: s1 did not come back as it went")
    db.detach("lite")
    print("# sqlite: " + "; ".join(f"{k} {v * 1e3:.1f} ms"
                                   for k, v in walls.items())
          + f"; {got.nrows} groups equal the port's", flush=True)


def run_modules(dev, tmp: Path, rng) -> None:
    """LOAD MODULE of the port's example_module.cpp, compiled with g++:
    mydiv(2, 3) and mulvec(2, x) over a SERVICE_ROWS-row REAL column
    against numpy; then the demo (aquery2_tpu_torch.demo.main) on the
    card: the forest's accuracy after each batch, the last above 0.8."""
    from aquery2_tpu_torch import demo

    sdk = Path(K.__file__).resolve().parents[1] / "sdk"
    so = tmp / "example_module.so"
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-I", str(sdk), "-o",
                    str(so), str(sdk / "example_module.cpp")], check=True,
                   timeout=120)
    built = time.perf_counter() - t0
    db = connect(device=dev, base_dir=str(tmp))
    errors = collect_errors(db)
    db.execute(f'LOAD MODULE FROM "{so}" FUNCTIONS (mydiv(a:int, b:int) '
               f'-> double, mulvec(a:int, b:vecfloat) -> vecfloat)')
    if db.execute("SELECT mydiv(2, 3)").scalar() != 2 / 3:
        raise AssertionError("mydiv(2, 3)")
    x = rng.uniform(-100, 100, SERVICE_ROWS).astype(np.float32)
    db.catalog.create(Table.from_numpy("v", {"x": x}, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = db.execute("SELECT mulvec(2, x) AS y FROM v")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    y = r.table.columns["y"]
    if y.device != db.device:
        raise AssertionError("mulvec's answer is not on the card")
    np.testing.assert_array_equal(y.to_numpy(), np.float32(2) * x,
                                  err_msg="mulvec")
    db.close()
    if errors:
        raise AssertionError(f"modules: {errors}")
    print(f"# LOAD MODULE: example_module.so built in {built:.2f} s; "
          f"mydiv(2, 3) = 2/3; mulvec(2, x) over {SERVICE_ROWS} rows "
          f"{ms:.3f} ms (to the host and back), equal to numpy", flush=True)
    t0 = time.perf_counter()
    demo.main([], base_dir=str(tmp / "demo"))
    print(f"# demo on the card: {time.perf_counter() - t0:.2f} s", flush=True)


REPL_SCRIPT = """#!aquery
CREATE TABLE t(a INT, b INT)
INSERT INTO t VALUES (1, 2), (1, 3), (2, 5), (3, 7)
exec
procedure p record
INSERT INTO t VALUES (3, 1)
exec
procedure p stop
procedure p run
stats
engine status
engine cpu
echo ==cpu==
SELECT a, sum(b) AS s, count(*) AS n FROM t GROUP BY a
exec
engine cuda
echo ==cuda==
SELECT a, sum(b) AS s, count(*) AS n FROM t GROUP BY a
exec
echo ==end==
"""


def run_surfaces(dev, data, tmp: Path) -> None:
    """`python -m aquery2_tpu_torch` on a #!aquery script (a procedure
    recorded and run, stats, engine status, the same GROUP BY after
    `engine cpu` and after `engine cuda`: equal answers); then an
    AqServer on a connect() session and a client running h2o q1 over
    SERVICE_ROWS rows."""
    from aquery2_tpu_torch.repl.server import AqClient, AqServer

    root = Path(K.__file__).resolve().parents[2]
    (tmp / "s.a").write_text(REPL_SCRIPT)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "aquery2_tpu_torch", "s.a"],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp), env={**os.environ,
                                            "PYTHONPATH": str(root)})
    wall = time.perf_counter() - t0
    text = out.stdout
    if out.returncode or "==end==" not in text:
        raise AssertionError(f"the REPL failed ({out.returncode}):\n"
                             f"{text[-2000:]}\n{out.stderr[-2000:]}")
    cpu = text.split("==cpu==")[1].split("engine:")[0]
    cuda = text.split("==cuda==")[1].split("==end==")[0]
    for want in ("Queries executed", "engine: torch device = cuda",
                 "engine: switched to cpu", "engine: switched to cuda"):
        if want not in text:
            raise AssertionError(f"the REPL printed no {want!r}:\n{text}")
    if cpu != cuda or "3 | 9 | 3" not in cpu:
        raise AssertionError(f"the REPL's answers differ:\n{cpu}\n{cuda}")
    print(f"# python -m aquery2_tpu_torch s.a: {wall:.2f} s (a new process "
          f"on the card); the GROUP BY on cpu and on cuda equal", flush=True)

    db = connect(device=dev)
    errors = collect_errors(db)
    db.catalog.create(Table.from_numpy(
        "source", {k: v[:SERVICE_ROWS] for k, v in data.items()}, device=dev))
    srv = AqServer(port=0, session=db)
    th = srv.start_background()
    client = AqClient(port=srv.port)
    t0 = time.perf_counter()
    got = client.execute(QUERIES["q1"])
    ms = (time.perf_counter() - t0) * 1e3
    client.close()
    srv.shutdown()
    th.join(10)
    db.close()
    want, _, _ = stream_oracle({k: data[k][:SERVICE_ROWS]
                                for k in ("id1", "v1")}, "q1")
    if got["columns"] != ["id1", "v1"] or got["rows"] != [
            (str(k), str(v)) for k, v in zip(want["id1"], want["v1"])]:
        raise AssertionError(f"server q1: {got}")
    if errors or th.is_alive():
        raise AssertionError(f"server: errors {errors}, alive {th.is_alive()}")
    print(f"# server: h2o q1 over {SERVICE_ROWS} rows from a client "
          f"{ms:.3f} ms, equal to numpy", flush=True)


def run_slice13(dev, data) -> dict[str, dict[str, int]]:
    """Phase 10: services and surfaces on the card. Returns the stream's
    and the interval trigger's launches."""
    t_start = time.perf_counter()
    launches = {}
    rng = np.random.default_rng(SEED)
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir)
        db = connect(device=dev, base_dir=str(tmp))
        errors = collect_errors(db)
        load(db, "x", data, dev)
        db.execute(STREAM)
        for name, sql in stream_procedures(len(data["v1"]) // 2).items():
            db.procedures.start_recording(name)
            db.execute(sql)
            db.procedures.stop_recording()
        db.execute("CREATE TRIGGER t1 ON stream ACTION s_q1")
        db.execute("CREATE TRIGGER t3 ON stream ACTION s_q3 WHEN s_big")
        runs = time_procedures(db)
        launches.update(run_stream(db, data, tmp, runs))
        launches["interval_q7"] = run_interval(db, data, runs)
        run_sqlite(db, data)
        threads = db.triggers.threads()
        db.close()
        if any(th.is_alive() for th in threads) or len(threads) != 2:
            raise AssertionError(f"close() left {threads}")
        if errors:
            raise AssertionError(f"the triggers logged {errors}")
        print(f"# close(): the ticker and the worker stopped; no error "
              f"logged", flush=True)
        run_modules(dev, tmp, rng)
        run_surfaces(dev, data, tmp)
    for name in ("onehot_segment_sums", "seg_cumsum_i64", "seg_scan_multi"):
        if not sum(per.get(name, 0) for per in launches.values()):
            raise AssertionError(f"phase 10 launched no {name}")
    print(f"# phase 10 took {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches


# phase 11: the mesh. Four ranks (one process each) of one process group
# run the distributed tiers over row-sharded tables: on one card the
# ranks share cuda:0 over gloo (its collectives staged through host
# memory); where the machine shows at least four cards, one rank a card
# over NCCL. Every rank reads the same tables (written once by the parent)
# and keeps its quarter of each (place_table).
MESH_RANKS = 4
MESH_H2O = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10",
            "qj", "qjg")
MESH_TRADES = ("avgs", "max_stddevs")     # phase 4's, on trades
MESH_WINDOWS = ("w_partition", "w_peers")    # phase 7's, on source
MESH_OTHER = {
    "m_ungrouped": ("SELECT count(*) AS n, sum(v1) AS s, avg(v3) AS a, "
                    "min(v2) AS lo, max(v2) AS hi FROM source"),
    "m_topk": "SELECT id6, v3 FROM source ORDER BY v3 DESC, id6 LIMIT 100",
    "m_scan": ("SELECT id1, id2, v1 FROM source WHERE v3 > 99.99 "
               "ORDER BY v1, id2"),
    "m_fallback": ("SELECT id1, CASE WHEN v1 > 3 THEN 1 END AS hi "
                   "FROM source ORDER BY id1, v1 LIMIT 10"),
}
MESH_J1 = {          # two J1 questions as CREATE TABLE AS, and set queries
    "m_j1_q1": ("CREATE TABLE ans1 AS SELECT x.id1, x.v1, small.v2 FROM x "
                "JOIN small USING (id1)"),
    "m_j1_q2": ("CREATE TABLE ans2 AS SELECT x.id2, x.v1, medium.v2 FROM x "
                "JOIN medium USING (id2)"),
    "m_except": SET_QUERIES["set_except"],
    "m_intersect_all": SET_QUERIES["set_intersect_all"],
    "m_union": SET_QUERIES["set_union"],
}
MESH_FALLBACK = {"m_fallback": "unsupported scan shape: CASE without ELSE "
                               "(NULL branch)"}
MESH_SPMD = {"m_except": 3, "m_intersect_all": 3,   # each arm, and the set
             "m_union": 3}                          # operation's SELECT
MESH_KERNEL = {**{q: MAIN_KERNEL[q] for q in MESH_H2O + MESH_TRADES},
               "q7": ["seg_scan_multi", "seg_cumsum_i64"],
               **{"m_" + q: ["seg_cumsum_i64", "seg_scan_multi"]
                  for q in MESH_WINDOWS},
               "m_ungrouped": ["onehot_segment_sums"], "m_topk": [],
               "m_scan": [], "m_fallback": [], "m_j1_q1": [], "m_j1_q2": [],
               "m_except": ["seg_cumsum_i64", "seg_scan_multi"],
               "m_intersect_all": ["seg_cumsum_i64", "seg_scan_multi"],
               "m_union": ["seg_cumsum_i64", "seg_scan_multi"]}


def mesh_oracle(q: str, data, dim, tables):
    """The check of mesh query q's answer on rank 0: a function of the
    Result (of the table made, gathered, for the CREATE TABLE AS
    ones)."""
    if q in MESH_H2O:
        if q in ("qj", "qjg"):
            return lambda res: check_result(q, res,
                                            *join_oracle(data, dim, q))
        if q == "q8":
            return lambda res: check_q8(res, data)
        return lambda res: check_result(q, res, *oracle(data, q))
    if q in MESH_TRADES:
        return lambda res: check_trades(tables["trades"][0], q, res)
    if q[2:] in MESH_WINDOWS:
        return lambda res: check_window({"h2o": data}, q[2:], res)
    if q in ("m_except", "m_intersect_all", "m_union"):
        sq = "set_" + q[2:]
        return lambda res: check_set(tables, sq, res)
    if q in ("m_j1_q1", "m_j1_q2"):
        want = j1_oracle(tables, q[2:])

        def check(ans):
            rows, s1, s2 = want
            got = [float(ans.columns[nm].data[:ans.nrows]
                         .to(torch.float64).sum()) for nm in ("v1", "v2")]
            if ans.nrows != rows or any(
                    abs(g - w) > FLOAT_RTOL * abs(w)
                    for g, w in zip(got, (s1, s2))):
                raise AssertionError(f"{q}: {ans.nrows} rows, sums {got} vs "
                                     f"numpy {rows}, {s1}, {s2}")
        return check
    v1, v2, v3 = (data[c] for c in ("v1", "v2", "v3"))
    if q == "m_ungrouped":
        want = [ROWS, int(v1.astype(np.int64).sum()),
                float(v3.astype(np.float64).mean()), int(v2.min()),
                int(v2.max())]

        def check(res):
            got = list(res.rows()[0])
            if got[:2] + got[3:] != want[:2] + want[3:] or \
                    abs(got[2] - want[2]) > FLOAT_RTOL * want[2]:
                raise AssertionError(f"{q}: {got} vs numpy {want}")
        return check
    if q == "m_topk":
        order = np.lexsort((data["id6"], -v3))[:100]
        want = list(zip(data["id6"][order].tolist(),
                        v3[order].astype(np.float64).tolist()))
    elif q == "m_scan":
        keep = np.flatnonzero(v3 > np.float32(99.99))
        order = keep[np.lexsort((keep, data["id2"][keep], v1[keep]))]
        want = list(zip(data["id1"][order].tolist(),
                        data["id2"][order].tolist(), v1[order].tolist()))
    else:                                           # m_fallback
        order = np.lexsort((v1, data["id1"]))[:10]
        want = [(int(a), 1 if b > 3 else None)
                for a, b in zip(data["id1"][order], v1[order])]

    def check(res):
        got = res.rows()
        if got != want:
            raise AssertionError(f"{q}: {got[:3]}… vs numpy {want[:3]}…")
    return check


def save_mesh_tables(path: Path, data, dim, j1, trade) -> None:
    """The phase's tables as .npy files under path: data and dim (phase
    4's), j1 (phase 6's J1_1e7_NA_0_0) but its string columns (no
    phase-11 query reads those; a J1 string column's dictionary holds up
    to 1e7 strings), and trade (phase 4's trades: its symbols' int32
    codes, and their 100-string dictionary in layout.json). Every rank
    maps the same bytes."""
    arrays_t, d = trade
    tables = {"source": data, "dim": dim, "trades": arrays_t,
              **{name: {c: a for c, a in arrays.items() if c not in dicts}
                 for name, (arrays, dicts) in j1.items()}}
    for name, arrays in tables.items():
        for col, arr in arrays.items():
            np.save(path / f"{name}.{col}.npy", arr)
    (path / "layout.json").write_text(json.dumps(
        {"columns": {name: list(arrays) for name, arrays in tables.items()},
         "strings": {"trades": {"stocksymbol": d.strings()}}}))


def load_mesh_tables(path: Path):
    """save_mesh_tables' tables, mapped: ({name: {column: array}},
    {name: {string column: its StringDict}})."""
    layout = json.loads((path / "layout.json").read_text())
    return ({name: {c: np.load(path / f"{name}.{c}.npy", mmap_mode="r")
                    for c in cols}
             for name, cols in layout["columns"].items()},
            {name: {c: StringDict(strs) for c, strs in cols.items()}
             for name, cols in layout["strings"].items()})


def _mesh_rank(rank: int, world: int, backend: str, path: str,
               kind: str = "cuda"):
    """One rank of phase 11: its device (of ``kind``), the tables (read
    from path) placed, every query run twice (the first checked against
    numpy, each query's answer by one rank in turn: every rank holds it
    whole; the second timed), its launches, route and traffic. Returns
    every rank's record (rank 0's)."""
    import torch.distributed as dist

    from aquery2_tpu_torch.parallel import comm

    dev = torch.device(kind, rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    K.build()                       # loads what the parent built
    db = connect(device=dev, mesh=world)
    db.log_level = "error"
    t0 = time.perf_counter()
    every_table, strings = load_mesh_tables(Path(path))
    data, dim = every_table["source"], every_table["dim"]
    tables = {nm: (arrays, strings.get(nm, {}))
              for nm, arrays in every_table.items()}
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, (arrays, dicts) in tables.items():
        tbl = Table.from_numpy(name, arrays, device=dev,
                               types={c: T.StrT for c in dicts},
                               dictionaries=dicts)
        db.catalog.create(tbl)
        db.place_table(tbl)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    queries = {**{q: QUERIES[q] for q in MESH_H2O},
               **{q: TRADES[q] for q in MESH_TRADES},
               **{"m_" + q: WINDOW_QUERIES[q].replace(" FROM x",
                                                       " FROM source")
                  for q in MESH_WINDOWS},
               **MESH_OTHER, **MESH_J1}
    out = {"rank": rank, "device": str(dev), "backend": db.mesh.backend,
           "world": db.mesh.world, "gen_s": gen_s, "place_s": place_s,
           "queries": {}}
    for i, (q, sql) in enumerate(queries.items()):
        st = db.stats
        sp0, fb0 = st.dist_spmd, st.dist_fallback
        reasons0 = dict(st.dist_fallback_reasons)
        reset_launches()
        res = db.execute(sql)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        route = (st.dist_spmd - sp0, st.dist_fallback - fb0, sorted(
            k for k, v in st.dist_fallback_reasons.items()
            if v != reasons0.get(k, 0)))
        answer = (db.readable(db.catalog.get(f"ans{q[-1]}"))
                  if sql.startswith("CREATE") else res.table)
        if i % world == rank:
            mesh_oracle(q, data, dim, tables)(
                answer if sql.startswith("CREATE") else res)
        digest = tuple(int((c.values[:c.total_values()] if c.is_vector
                            else c.data[:answer.nrows])
                           .to(torch.float64).sum())
                       for c in answer.columns.values()) + (answer.nrows,)
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        db.execute(sql)
        torch.cuda.synchronize()
        dist.barrier()
        wall = (time.perf_counter() - t1) * 1e3
        out["queries"][q] = {"launches": launches, "route": route,
                             "digest": digest, "wall_ms": wall,
                             "comm": comm.last_query_comm(db)}
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def run_mesh(data, dim, j1) -> dict[str, dict[str, int]]:
    """Phase 11: the mesh session's queries on MESH_RANKS ranks over data
    and dim (G1_1e7_1e1_0_0 and its dim table), j1 (J1_1e7_NA_0_0) and
    phase 4's trades (generated again, seed 7); each answer against numpy
    and equal on every rank, each route and each rank's kernels
    asserted. Returns the launches of every rank's query, for the kernel
    report."""
    from aquery2_tpu_torch.parallel import launch

    t_start = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card
    backend = "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as tmp:
        save_mesh_tables(Path(tmp), data, dim, j1, trades(ROWS, 100, 7))
        print(f"# wrote G1_1e7_1e1_0_0, its dim table, J1_1e7_NA_0_0's "
              f"numeric columns and trades in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        ranks = launch.run(_mesh_rank, MESH_RANKS, backend, tmp,
                           backend=backend, timeout_s=600)
    for r in ranks:
        print(f"# mesh rank {r['rank']} of {r['world']}: backend "
              f"{r['backend']}, device {r['device']}, read the tables in "
              f"{r['gen_s']:.1f} s, placed its blocks in "
              f"{r['place_s']:.1f} s", flush=True)
    launches = {}
    for q in ranks[0]["queries"]:
        recs = [r["queries"][q] for r in ranks]
        if len({rec["digest"] for rec in recs}) != 1:
            raise AssertionError(f"{q}: the ranks' answers differ")
        route = recs[0]["route"]
        if any(rec["route"] != route for rec in recs):
            raise AssertionError(f"{q}: the ranks' routes differ")
        want = ((0, 1, [MESH_FALLBACK[q]]) if q in MESH_FALLBACK
                else (MESH_SPMD.get(q, 1), 0, []))
        if tuple(route) != want:
            raise AssertionError(f"{q}: route {route}, want {want}")
        for r, rec in zip(ranks, recs):
            for name in MESH_KERNEL[q]:
                if rec["launches"].get(name, 0) <= 0:
                    raise AssertionError(f"{q}: rank {r['rank']} launched "
                                         f"no {name}: {rec['launches']}")
            launches[f"{q}@mesh{r['rank']}"] = rec["launches"]
        c = recs[0]["comm"]
        kinds = {k: v for k, v in c.items() if k != "wire_bytes_per_chip"}
        print(f"# {q}@mesh: {'SPMD' if route[0] else 'gathered'}, rank 0 "
              f"{recs[0]['wall_ms']:.3f} ms (warm run, synchronize and "
              f"barrier), comm {kinds}, wire {c['wire_bytes_per_chip']} B "
              f"a rank, launches per rank "
              f"{[rec['launches'] for rec in recs]}", flush=True)
    for name in ("onehot_segment_sums", "seg_cumsum_i64", "seg_scan_multi"):
        for r in ranks:
            if not sum(rec["launches"].get(name, 0)
                       for rec in r["queries"].values()):
                raise AssertionError(f"mesh rank {r['rank']} launched no "
                                     f"{name}")
    print(f"# phase 11 took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return launches


# phase 12: the h2o main path at the JAX bench's own size: bench.py's
# default --rows 100_000_000, BASELINE.md's G1-1e8 metric scale. Every
# published width of h2o G1 (9 columns, k = 10); nothing cut.
ROWS_1E8 = 100_000_000
CAP_1E8 = 100_663_296            # config.bucket_size(1e8)
G1_1E8 = ("q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10", "qj",
          "qjg")
# the packed tier's 30-bit key words at 1e8 (id3 and id6 take 24 bits) and
# q10's sort passes: its three words (8, 28 and 28 bits used) and the
# validity bit take 65 bits, two stable radix sorts of 28 and 37 bits
# (ops/sort.lexsort); at 1e7 two words and one sort of 57 bits
WORDS_1E8 = {"q3": 1, "q5": 1, "q6": 1, "q7": 1, "q10": 3}
SORTS_1E8 = {"q10": 2}
# the kernels held against their plain versions at this pass's inputs:
# the first call of each in the query named
KERNEL_AT_1E8 = {"onehot_segment_sums": "q9", "seg_cumsum_i64": "q3",
                 "seg_scan_multi": "q7"}
# radix_sort_pairs' calls held against its plain version at 1e8: q10's
# packs in the order lexsort sorts them, (key dtype, end bit, descending),
# and the float64 sort of v3 as a DOUBLE in q6 (median, ascending) and q8
# (ASSUMING DESC v3)
SORTS_AT_1E8 = {"q10": [(torch.int32, 28, False), (torch.int64, 37, False)],
                "q6@float64": [(torch.float64, 64, False)],
                "q8@float64": [(torch.float64, 64, True)]}


def launches_1e8(q: str) -> dict:
    """q's launches over phase 12's 4 runs: phase 4's, but for one radix
    sort a run for each of SORTS_1E8's sort passes."""
    want = dict(MAIN_PATH_LAUNCHES[q])
    if q in SORTS_1E8:
        want["radix_sort_pairs"] = 4 * SORTS_1E8[q]
    return want


class PlanProbe:
    """What the engine planned for the statements run inside ``with``:
    the tiers that answered, innermost first (the fused group-by's
    strategy; the ordered group-by; the star join, whose group-by is the
    fused group-by's; the count join), the packed tier's key words
    (fused_groupby._plan_words), each float_sums_fit decision and the
    radix_sort_pairs calls (ops/sort.lexsort's sort passes; on the CPU
    too, where it takes its plain version). It wraps those functions where
    the engine looks them up and unwraps them on exit."""

    def __init__(self):
        self.tiers, self.words, self.fits, self.sorts = [], set(), [], 0
        self._saved = []

    def _wrap(self, module, name, make):
        real = getattr(module, name)
        self._saved.append((module, name, real))
        setattr(module, name, make(real))

    def _tier(self, name):
        def make(real):
            def run(*a, **kw):
                out = real(*a, **kw)
                if out is not None:
                    self.tiers.append(self._strategy if name is None
                                      else name)
                return out
            return run
        return make

    def __enter__(self):
        fg = fused_groupby
        self._strategy = None

        def strategy(real):
            def choose(*a):
                out = real(*a)
                self._strategy = None if out is None else out[0]
                return out
            return choose

        def words(real):
            def plan(key_ranges):
                out = real(key_ranges)
                if out is not None:
                    self.words.add(out[1])
                return out
            return plan

        def fits(real):
            def fit(*a, **kw):
                self.fits.append(real(*a, **kw))
                return self.fits[-1]
            return fit

        def sort(real):
            def counted(*a, **kw):
                self.sorts += 1
                return real(*a, **kw)
            return counted

        self._wrap(fg, "choose_strategy", strategy)
        self._wrap(fg, "_plan_words", words)
        self._wrap(fg, "float_sums_fit", fits)
        self._wrap(fg, "run", self._tier(None))
        self._wrap(E.fused_ordered, "run", self._tier("ordered"))
        self._wrap(fused_star, "try_run", self._tier("star join"))
        self._wrap(fused_join, "try_run", self._tier("count join"))
        self._wrap(K, "radix_sort_pairs", sort)
        return self

    def __exit__(self, *exc):
        for module, name, real in reversed(self._saved):
            setattr(module, name, real)
        return False

    def line(self) -> str:
        return (f"tier {' in '.join(self.tiers) or '-'}, key words "
                f"{sorted(self.words) or '-'}, sort passes {self.sorts}, "
                f"float_sums_fit {self.fits or '-'}")


def capture_first(name: str, run):
    """The arguments and keywords of the first K.<name> call that run()
    makes."""
    real, got = getattr(K, name), []

    def spy(*a, **kw):
        if not got:
            got.append((a, kw))
        return real(*a, **kw)
    setattr(K, name, spy)
    try:
        run()
    finally:
        setattr(K, name, real)
    torch.cuda.synchronize()
    return got[0]


def capture_sorts(run) -> list[tuple]:
    """Each K.radix_sort_pairs call that run() makes, as (keys, values,
    end bit, descending), copies taken before the call: on the card it
    overwrites its int keys and its values."""
    real, got = K.radix_sort_pairs, []

    def spy(keys, values, end_bit, descending=False):
        got.append((keys.clone(), values.clone(), end_bit, descending))
        return real(keys, values, end_bit, descending)
    K.radix_sort_pairs = spy
    try:
        run()
    finally:
        K.radix_sort_pairs = real
    torch.cuda.synchronize()
    return got


def sort_bytes(keys, values, end_bit: int) -> int:
    """A radix sort's bytes: the histogram pass reads the keys, each digit
    pass of 8 bits reads and writes keys and values; float64 keys are read
    once and their order bits written, then sorted as 64-bit keys."""
    kb = 8 if keys.dtype == torch.float64 else keys.element_size()
    per_row = kb + -(-end_bit // 8) * 2 * (kb + values.element_size())
    if keys.dtype == torch.float64:
        per_row += 16
    return keys.numel() * per_row


def sort_ms(keys, values, end_bit: int, desc: bool, reps: int = 10):
    """Median device time (CUDA events, after one warm-up) of
    radix_sort_pairs on the call's inputs, which are copied back into its
    buffers before each run, outside the events, and each run queued
    behind a torch.cuda._sleep as cuda_ms queues it."""
    k = keys if keys.dtype == torch.float64 else keys.clone()
    v = values.clone()
    times = []
    for rep in range(reps + 1):
        if k is not keys:
            k.copy_(keys)
        v.copy_(values)
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        K.radix_sort_pairs(k, v, end_bit, desc)
        end.record()
        end.synchronize()
        if rep:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def sorts_at_1e8(db, data, dev, rows: list[dict]) -> None:
    """radix_sort_pairs at SORTS_AT_1E8's calls: q10's over G1_1e8, q6's and
    q8's float64 sorts over its id4, id5, id6 and v3 with v3 a DOUBLE, as
    db-benchmark's groupby-datagen.R writes it. Each call's sorted keys and
    values equal radix_sort_pairs_plain's (torch.sort of the same bits),
    its device time beside the bound of sort_bytes, the plain version
    timed once; added to the kernel report as the radix_sort_pairs row."""
    calls = {"q10": capture_sorts(lambda: db.execute(QUERIES["q10"]))}
    db64 = connect(device=dev)
    load(db64, "source", {"id4": data["id4"], "id5": data["id5"],
                          "id6": data["id6"],
                          "v3": data["v3"].astype(np.float64)}, dev)
    for q in ("q6", "q8"):
        calls[q + "@float64"] = [
            c for c in capture_sorts(lambda: db64.execute(QUERIES[q]))
            if c[0].dtype == torch.float64]
    del db64
    shapes = []
    for q, want in SORTS_AT_1E8.items():
        got = [(c[0].dtype, c[2], c[3]) for c in calls[q]]
        if got != want:
            raise AssertionError(f"{q} at 1e8 called radix_sort_pairs with "
                                 f"{got}, want {want}")
        for keys, values, end_bit, desc in calls[q]:
            route = K._SORT_ROUTES[keys.dtype]
            k = keys if route == "f64" else keys.clone()
            sk, sv = K.radix_sort_pairs(k, values.clone(), end_bit, desc)
            wk, wv = K.radix_sort_pairs_plain(keys, values, end_bit, desc)
            for g, w in ((sk, wk), (sv, wv)):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(
                        f"radix_sort_pairs at {q}'s {route} pack of "
                        f"{end_bit} bits differs from its plain version")
            del k, sk, sv, wk, wv
            ms = sort_ms(keys, values, end_bit, desc)
            pms = cuda_ms(lambda: K.radix_sort_pairs_plain(
                keys, values, end_bit, desc), reps=1)
            nbytes = sort_bytes(keys, values, end_bit)
            b = bound_ms(nbytes)
            shape = (f"{route}, {end_bit} bits, "
                     f"{'descending' if desc else 'ascending'}, "
                     f"{str(values.dtype).removeprefix('torch.')} values")
            shapes.append({"query": q, "shape": shape,
                           "rows": keys.numel(), "ms": ms, "plain_ms": pms,
                           "bytes": nbytes, "bound_ms": b,
                           "share_of_bound": b / ms})
            print(f"# radix_sort_pairs at {q}'s inputs at 1e8 ({shape}, "
                  f"{keys.numel()} rows): equal to its plain version; "
                  f"kernel {ms:.4f} ms (median of 10), plain {pms:.4f} ms "
                  f"(one run); {nbytes} bytes, bound {b:.4f} ms at 3.35 "
                  f"TB/s, {b / ms:.1%} of bound", flush=True)
        del calls[q]
    main = next(s for s in shapes if s["query"] == "q10"
                and s["shape"].startswith("u64"))
    rows.append({"name": "radix_sort_pairs", "route": "cuda",
                 "source": "aquery2_tpu_torch/csrc/radix_sort.cu",
                 "replaces": "none: the JAX package sorts with lax.sort",
                 "max_abs_err": 0, "ms": main["ms"],
                 "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                 "bound_by": "bytes",
                 "share_of_bound": main["share_of_bound"],
                 "library_ms": None, "g1_1e8": shapes})


def kernel_at_1e8(name: str, call, rows: list[dict],
                  query: str | None = None, key: str = "g1_1e8") -> None:
    """One kernel at a phase-12 query's inputs (query, by default
    KERNEL_AT_1E8's): equal to its plain version (integers exactly; a
    float64 onehot lane as onehot_close holds it), its device time (CUDA
    events, median of 10) beside the bound of its bytes, the plain
    version timed once (and for onehot_segment_sums the library calls
    that compute the same sums, onehot_library), added to its row of the
    kernel report under key."""
    query = query or KERNEL_AT_1E8[name]
    args, kw = call
    kernel = functools.partial(getattr(K, name), **kw)
    plain = functools.partial(getattr(K, name + "_plain"), **kw)
    got, want = kernel(*args), plain(*args)
    if name == "onehot_segment_sums":
        onehot_close(f"{query} at 1e8", got, want, args[1])
    else:
        outs = (got,) if isinstance(got, torch.Tensor) else tuple(got)
        wants = (want,) if isinstance(want, torch.Tensor) else tuple(want)
        for g, w in zip(outs, wants):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{name} at 1e8 differs from its plain "
                                     f"version: max |err| "
                                     f"{max_abs_err(g, w)}")
    if name == "onehot_segment_sums":
        code, lanes, dp = args
        nbytes = onehot_bytes(code, lanes, got, **kw)
        library = onehot_library(code, lanes, dp, **kw)
        onehot_close(f"the library calls at {query} at 1e8", library(), got,
                     lanes)
        lib_ms = cuda_ms(library, reps=3)
        del library
        kinds = ", ".join(str(x.dtype).removeprefix("torch.") for x in lanes)
        shape, n = f"dp {dp}, {len(lanes)} lanes ({kinds})", code.numel()
    else:
        f, xs = args[0], args[1] if name == "seg_scan_multi" else (args[1],)
        nbytes = scan_bytes(f, xs)
        lib_ms = None
        shape = f"{len(xs)} x {8 * xs[0].element_size()}-bit, flags"
        n = xs[0].numel()
    ms, pms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args),
                                                      reps=1)
    b = bound_ms(nbytes)
    at = {"query": query, "shape": shape, "rows": n,
          "ms": ms, "plain_ms": pms, "bytes": nbytes, "bound_ms": b,
          "share_of_bound": b / ms, "library_ms": lib_ms}
    if name == "onehot_segment_sums":
        at["route"] = onehot_route_of(code, dp, lanes, n, **kw)
    next(r for r in rows if r["name"] == name)[key] = at
    print(f"# {name} at {query}'s inputs at 1e8 ({shape}, {n} rows): "
          f"equal to its plain version; kernel {ms:.4f} ms (median of 10), "
          f"plain {pms:.4f} ms (one run)"
          + ("" if lib_ms is None else f", the library calls {lib_ms:.4f} ms")
          + f"; {nbytes} bytes, bound {b:.4f} ms at 3.35 TB/s, "
          f"{b / ms:.1%} of bound", flush=True)


def run_g1_1e8(dev, plans_1e7: dict, rows: list[dict]):
    """Phase 12: q1-q10, qj and qjg through connect(device="cuda").execute
    over G1_1e8 (datagen.h2o_g1(1e8, 10, 42)) and its dim table at the
    capacity bucket_size(1e8): each query's first run and 3 warm runs,
    its launches over the 4 runs equal to launches_1e8 (phase 4's at 1e7,
    q10's second sort pass added), its tier equal to phase 4's, its key words, sort passes and
    float_sums_fit decisions printed (q10's 3 words and 2 sorts
    asserted), the device memory peak over its runs, its answer against
    the numpy oracle and the oracle's seconds; then each kernel at its
    query's inputs (KERNEL_AT_1E8), onehot_segment_sums at q4's with
    v3 a DOUBLE (capture_q4_double: its float64 lane), and
    radix_sort_pairs at SORTS_AT_1E8's calls (sorts_at_1e8). Returns the
    launches."""
    t_start = time.perf_counter()
    data = h2o_g1(ROWS_1E8, K_GROUPS, SEED)
    dim = h2o_dim(ROWS_1E8, K_GROUPS, SEED)
    print(f"# generated G1_1e8 (9 columns x {ROWS_1E8} rows) and its dim "
          f"table ({len(dim['id3'])} rows) in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    db = connect(device=dev)
    load(db, "source", data, dev)
    load(db, "dim", dim, dev)
    cap = db.catalog.get("source").columns["id1"].data.shape[0]
    if cap != CAP_1E8 or config.bucket_size(ROWS_1E8) != CAP_1E8:
        raise AssertionError(f"capacity {cap}, want {CAP_1E8}")
    resident = torch.cuda.memory_allocated()
    groups: dict = {}
    launches, oracle_s = {}, 0.0
    for q in G1_1E8:
        sql = QUERIES[q]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        with PlanProbe() as plan:
            res = db.execute(sql)
            torch.cuda.synchronize()
        first = (time.perf_counter() - t1) * 1e3
        runs = []
        for _ in range(3):
            t1 = time.perf_counter()
            db.execute(sql)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        launches[q + "@1e8"] = got
        if got != launches_1e8(q):
            raise AssertionError(f"{q} at 1e8 launched {got} over 4 runs, "
                                 f"want {launches_1e8(q)}")
        if plan.tiers != plans_1e7[q].tiers:
            raise AssertionError(f"{q} at 1e8 took {plan.tiers}, at 1e7 "
                                 f"{plans_1e7[q].tiers}")
        if q in WORDS_1E8 and plan.words != {WORDS_1E8[q]}:
            raise AssertionError(f"{q} at 1e8 planned {plan.words} key "
                                 f"words, want {WORDS_1E8[q]}")
        if q in SORTS_1E8 and plan.sorts != SORTS_1E8[q]:
            raise AssertionError(f"{q} at 1e8 sorted {plan.sorts} times, "
                                 f"want {SORTS_1E8[q]}")
        t1 = time.perf_counter()
        if q == "q8":
            check_q8(res, data, groups)
        elif q in ("qj", "qjg"):
            check_result(q, res, *join_oracle(data, dim, q))
        else:
            check_result(q, res, *oracle(data, q, groups))
        secs = time.perf_counter() - t1
        oracle_s += secs
        print(f"# {q}@1e8: {res.nrows} groups; {plan.line()} (at 1e7: "
              f"{plans_1e7[q].line()}); first run {first:.3f} ms, "
              f"{float(np.median(runs)):.3f} ms (median of 3 warm runs, "
              f"{min(runs):.3f}-{max(runs):.3f}); device memory peak "
              f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} "
              f"above the tables' {resident / 2**30:.3f}); launches per run "
              f"{ {k: v / 4 for k, v in got.items()} }; matches numpy "
              f"(oracle {secs:.1f} s)", flush=True)
        del res
    print(f"# the numpy oracle took {oracle_s:.1f} s for the 12 queries",
          flush=True)
    for name, q in KERNEL_AT_1E8.items():
        call = capture_first(name, lambda: db.execute(QUERIES[q]))
        kernel_at_1e8(name, call, rows)
        del call
    *args, kw = capture_q4_double(dev, data)
    kernel_at_1e8("onehot_segment_sums", (tuple(args), kw), rows,
                  "q4@float64", "g1_1e8_q4_float64")
    del args, kw
    sorts_at_1e8(db, data, dev, rows)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"# phase 12 took {time.perf_counter() - t_start:.1f} s; the "
          f"process's peak RSS {rss:.2f} GiB", flush=True)
    del db
    torch.cuda.empty_cache()
    return launches


def ptxas_line(r: dict) -> str:
    return (f"{r['registers']} registers, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads, {r['stack']} B "
            f"stack, {r['smem']} B static shared memory")


def tally_scans(calls: collections.Counter):
    """Wrap K.seg_cumsum_i64 and K.seg_scan_multi, which the engine calls
    through the module, so that calls tallies each call by the name of
    the instantiation it runs, as ptxas_report names it (the wrappers
    still count their launches). Returns the function that unwraps
    them."""
    cumsum, multi = K.seg_cumsum_i64, K.seg_scan_multi

    def seg_cumsum_i64(flags, x):
        calls[f"seg_cumsum_i64, flags {int(flags is not None)}"] += 1
        return cumsum(flags, x)

    def seg_scan_multi(flags, xs, ops):
        xs = tuple(xs)
        calls[f"seg_scan_multi {len(xs)} x {8 * xs[0].element_size()}-bit, "
              f"flags {int(flags is not None)}"] += 1
        return multi(flags, xs, ops)

    K.seg_cumsum_i64, K.seg_scan_multi = seg_cumsum_i64, seg_scan_multi

    def untally():
        K.seg_cumsum_i64, K.seg_scan_multi = cumsum, multi
    return untally


def reset_launches() -> None:
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    phase("1. card")
    print(card)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    lib = K.build()
    phase("2. build")
    print(f"# built {K.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {r["kernel"]: r for r in K.ptxas_report()}
    for r in ptxas.values():
        print(f"# ptxas {r['kernel']}: {ptxas_line(r)}")
    for name, ops in sass_atomics().items():
        print(f"# SASS atomics of {name}: {dict(sorted(ops.items()))}")
    if lib.aq_onehot_max_entries() != K.ONEHOT_MAX_ENTRIES:
        raise AssertionError("ONEHOT_MAX_ENTRIES differs from the kernel's")

    data = h2o_g1(ROWS, K_GROUPS, SEED)
    rows = check_kernels(dev, data)
    phase("3. kernels vs plain: equal")

    scans = collections.Counter()
    untally = tally_scans(scans)
    walls: dict[str, float] = {}
    dim = h2o_dim(ROWS, K_GROUPS, SEED)
    plans: dict[str, PlanProbe] = {}
    launches, db = run_slice(dev, data, dim, walls, plans)
    join_ms = time_joins(db, data, dim)
    del db
    launches.update(run_trades(dev))
    launches.update(run_nas(dev))
    untally()
    launches["best_profit"] = run_best_profit(dev)
    phase(f"4. slice: {len(launches) - 1} queries and best_profit match the "
          f"oracles")

    general = run_general(dev, walls)
    total = collections.Counter()
    for per in general.values():
        total.update(per)
    print(f"# the general phase launched {dict(sorted(total.items()))} "
          f"over its {len(general)} queries, 4 runs each", flush=True)
    launches.update(general)
    phase(f"5. general engine: {len(general)} queries match numpy")

    t0 = time.perf_counter()
    j1 = h2o_j1(ROWS, SEED)         # phase 6's, and phase 11's
    print(f"# generated J1_1e7_NA_0_0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    slice10 = run_slice10(dev, walls, j1)
    launches.update(slice10)
    phase(f"6. joins, set operations, DISTINCT aggregates, non-finite "
          f"sums: {len(slice10)} queries match numpy")

    slice11 = run_slice11(dev, data, walls)
    launches.update(slice11)
    phase(f"7. OVER windows and user FUNCTIONs: {len(slice11)} queries match "
          f"numpy")

    slice12 = run_slice12(dev, data, walls)
    launches.update(slice12)
    phase(f"8. AGGREGATION FUNCTION bodies on the device and CSV in and "
          f"out: {len(slice12)} queries match numpy")

    for q, per in launches.items():
        want = MAIN_KERNEL.get(q, MAIN_KERNEL.get(q.split("@")[0],
                                                  ["fused_running_stats"]))
        for name in want:
            if per.get(name, 0) <= 0:
                raise AssertionError(f"{q} did not launch {name}: {per}")
    for q, per in MAIN_PATH_LAUNCHES.items():
        if launches[q] != per:
            raise AssertionError(f"{q} launched {launches[q]}, want {per}")
    for name, calls in sorted(scans.items()):
        print(f"# phase 4 called {name} {calls} times; ptxas: "
              f"{ptxas_line(ptxas[name])}", flush=True)
    build = join_ms[next(k for k in join_ms
                         if k.startswith("star build, position"))]
    print(f"# the star build, {build:.4f} ms of device time, is "
          f"{build / walls['qjg']:.1%} of qjg's {walls['qjg']:.3f} ms wall "
          f"(qj {walls['qj']:.3f} ms)", flush=True)
    phase("9. each query launched its path's kernels (q1-q10, qj and qjg "
          "exactly as before the float-sum gate), best_profit "
          "fused_running_stats")

    slice13 = run_slice13(dev, data)
    launches.update(slice13)
    phase("10. services and surfaces: the stream's triggers (s1, s3), the "
          "interval trigger (s7), SQLite, LOAD MODULE, the demo, the REPL "
          "and the server match numpy; onehot_segment_sums, seg_cumsum_i64 "
          "and seg_scan_multi launched from the trigger threads")
    mesh = run_mesh(data, dim, j1)
    launches.update(mesh)
    phase("11. the mesh: q1-q10, qj, qjg, w_partition, w_peers, avgs, "
          "max_stddevs, two J1 questions, an ungrouped aggregate, a top-k "
          "and an ordered scan, EXCEPT, INTERSECT ALL and a UNION's "
          "DISTINCT match numpy on every rank over the distributed tiers, "
          "the CASE without ELSE over gathered tables; onehot_segment_sums, "
          "seg_cumsum_i64 and seg_scan_multi launched on every rank")
    launches.update(run_g1_1e8(dev, plans, rows))
    phase("12. G1_1e8: q1-q10, qj and qjg over 1e8 rows match numpy, each "
          "on its 1e7 tier with its 1e7 launches a run, q10 on 3 key words "
          "and 2 sort passes; onehot_segment_sums, seg_cumsum_i64, "
          "seg_scan_multi and radix_sort_pairs equal their plain versions "
          "at its inputs")
    for r in rows:
        r["launches"] = sum(per.get(r["name"], 0)
                            for per in launches.values())

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
