#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (presto_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each one that fails ends the run with a nonzero exit code and no
result line):

1. device and build: prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them, then builds every CUDA kernel of ``presto_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc process per source, all at once);
2. kernels: runs each kernel's wrapper on the card at the sizes Q3 gives
   it at SF1 (the probe with random keys, and with lineitem's clustered
   key order) and on edge cases (tile edges, empty and dead inputs, the
   largest descriptor set), and holds every result bit for bit against
   the kernel's plain PyTorch version on the same inputs; times the
   wrapper, the plain version and one PyTorch library call computing the
   same function (CUDA events, median of several runs after warm-up),
   takes each kernel's device-only time per call (torch.profiler's CUDA
   records, or CUDA events over 20 back-to-back calls where the profiler
   records none) and works out each kernel's bound;
3. path: with every launch count set to 0, runs TPC-H Q6, Q1 and Q3 at
   SF1 through ``LocalRunner(tpch_sf=1, rows_per_batch=2**23)`` on
   ``cuda`` (cold, then warm; one batch holds all 6 M lineitem rows;
   every cold run here and in the next two phases starts with the scan
   cache cleared, so a warm run replays the query's own splits),
   reads the counts, fails if a kernel of the path never launched (both
   must launch during Q3), and compares each result with the port's own
   ``device="cpu"`` run: integers, dates and strings exactly, doubles
   within rel 1e-9 (the GPU's atomic float adds sum in another order);
4. tpch: with every launch count set to 0 again, runs the other 19
   queries of ``tests/tpch_queries.py`` at SF1 on ``cuda`` (one cold run
   each, same runner settings), compares each with the port's
   ``device="cpu"`` run as above, prints per query the cuda and cpu
   walls, the rows, the host time spent in LIKE and the launches of each
   kernel, fails if the probe never launched in the phase, then breaks
   down the slowest query's wall;
5. tpcds: with every launch count set to 0 again, runs q27 (ROLLUP and
   GROUPING()) and the 22 queries of ``tests/tpcds_queries.py`` (star
   joins, windows, correlated and scalar subqueries) at TPCDS_SF (0.5)
   through ``LocalRunner(catalog="tpcds", rows_per_batch=2**23)`` on
   ``cuda`` (one cold run each) against the port's ``device="cpu"`` run
   as above, printing per query the cuda and cpu walls, the rows, the
   peak device memory and the launches of each kernel; then the CPU
   rows of q55 and q27 at SF10 (``store_sales`` 28.8 M rows, four
   batches), which the scan phase's runs on the card are held to; fails
   if the probe never launched in the phase, reports the segment sum's
   launches, and breaks down the slowest of those queries' walls;
6. scan: the device scan cache and the prefetching scan pipeline. With
   every launch count set to 0 and the scan cache cleared, runs Q1 and Q3
   at SF1 and q55 and q27 at SF10 on ``cuda``, cold then warm, printing
   per run the wall, the scan cache's hits, misses and inserts, its
   resident bytes on the card, the prefetch stall seconds and the peak
   device memory, and the card's busy share of a profiled warm run; runs
   q55 cold again with ``scan_prefetch=false``; compares every result
   with the port's ``device="cpu"`` run as above (the path and tpcds
   phases' CPU rows) and fails if the warm q55 hits no split; then
   the write path: CREATE TABLE memory.default.t AS a projection of SF1
   lineitem, reads it twice (cold, warm), INSERTs more rows and reads it
   again, which must miss and return the new rows from batches on the
   card, each read against the same statements on the CPU. Fails if
   either kernel never launched in the phase;
7. surface: with every launch count set to 0 and the scan cache cleared,
   runs the statements of ``SURFACE_QUERIES`` at SURFACE_SF (0.5) on
   ``cuda``, cold
   then warm: DISTINCT aggregates beside others (MarkDistinct), variance,
   boolean and sketch aggregates (HLL, the percentile histogram and its
   drained grouped form), a sort-path grouping by ``l_orderkey``, long
   decimals as sums, group and sort keys, join payload and join key, the
   regex / date / math / JSON / URL functions, and UNNEST over orders
   and over ``sequence``; compares each with the port's ``device="cpu"``
   run (integers, decimals, dates and strings exactly, doubles within rel
   1e-9), prints per statement the walls, the rows, the peak device
   memory and the launches of each kernel, then the checked-arithmetic
   and literal-typing statements of ``SURFACE_CHECKED`` (Presto's
   INTEGER literals, decimal-integral arithmetic; the types and error
   names on the card must equal the CPU run's and the expected ones),
   and fails unless both kernels launched in the phase;
8. files: BASELINE config 5 and the file catalogs. Writes TPC-H at
   FILES_SF (0.5) with
   the port's own writers into a temporary directory (lineitem's 16
   columns in ORC_LINEITEM_FILES ORC files, orders and customer in one
   each, stripes of 2^16 rows; lineitem's PARQUET_COLUMNS in
   PARQUET_FILES Parquet files), times each Q1 column's decode alone on
   one thread (per ORC stripe and per Parquet row group), runs Q6, Q1
   and Q3 over ORC and Q6 and Q1 over Parquet on ``cuda`` (scan cache
   off, then cold and warm), each against the TPC-H catalog's CPU rows
   at FILES_SF, printing per run the wall, the stripes or row
   groups read and pruned, the host decode seconds, the peak device
   memory, the RLEv2 runs over 56 bits decoded on the host and the
   launches of each kernel, and for each query the device busy time of
   its expansions (the kernels under the readers' torch.profiler
   ranges, in one more run with the cache off and the splits and join
   probe sides on one thread) beside the host decode seconds; runs CONFIG5_SQL (config 5's scan-filter-project) against the
   CPU run and fails unless it pruned a stripe; prints the ``[device``
   lines, the kernels section and the Verdict line of EXPLAIN ANALYZE of
   ORC Q3 and Q6 with the scan cache off (the decode path); checks that
   a warm profiled ORC Q3's per-operator device seconds lie between
   torch.profiler's busy time and the query's wall; fails unless both
   kernels launched in the phase;
9. chains: the fused join chains. With every launch count set to 0,
   runs the TPC-H queries of CHAIN_QUERIES at SF1 and q27 at SF10
   (``rows_per_batch=2**23``) on ``cuda`` with ``fused_pipeline`` on
   and off, each cold (scan cache cleared) then warm, printing
   per run the wall, the source and tail lanes, the liveness readbacks,
   the launches of each kernel and the peak device memory; compares on
   with off and each with the CPU rows of the tpch and tpcds phases;
   fails if a query took no chain with the chain on, if q27's tail lanes
   are not below half its source lanes, or if the probe never launched
   inside a fused tail;
10. spill: ``LocalRunner(tpch_sf=1, rows_per_batch=2**20)`` with
   ``dense_grouping=false`` runs SPILL_QUERIES on ``cuda`` unbudgeted
   (scan cache cleared, then warm), then with ``query_max_memory`` at a
   quarter of the warm run's pool peak,
   and the join and the ORDER BY also with the disk tier
   (``spill_to_disk_bytes``, a temporary ``spill_path``), printing per
   run the wall, the pool peak, ``torch.cuda.max_memory_allocated``, the
   spilled, host-staged and disk bytes, the revocations and the launches
   of each kernel; compares each budgeted run with the unbudgeted one
   and that with the port's ``device="cpu"`` run; fails if a budgeted
   run's pool peak exceeds its budget or it spilled nothing, if a disk
   run wrote no page or left a file, or if the segment sum never
   launched in the phase;
11. statements: the runner's statement surface at STATEMENTS_SF (1) on
   ``cuda``, against the port's ``device="cpu"`` runner where that is
   cheap: Q3 as a view and Q6 as PREPARE ... EXECUTE USING equal the
   literal queries' CPU rows, DESCRIBE OUTPUT lists Q3's columns;
   CREATE TABLE memory.default.li AS lineitem, START TRANSACTION,
   INSERT of the rows shipped from 1998, ROLLBACK (the count, read twice
   with the scan cache on, is the CTAS count again), the INSERT again
   and COMMIT; INSERT with a reordered column list; with the role manager
   enforcing, a user without the SELECT grant is refused Q6 and gets its
   rows after the grant; ``system.runtime.queries`` counts the phase's
   own statements by state, a profiled Q3 leaves its
   ``completed_queries`` record and ``operator_stats`` rows with device
   seconds, ``executables`` lists both kernels with launches and
   ``nodes`` names the card; customer written into a SQLite file in a
   temporary directory joins ``tpch.orders`` on the card (equal to the
   same join over the TPC-H catalog, and the probe launches); EXPLAIN
   (FORMAT JSON / GRAPHVIZ, TYPE IO / VALIDATE) of Q3 equal the CPU
   runner's text; a warm Q3 timed with the tracer off and on (three
   runs each, in turns), EXPLAIN ANALYZE's trace section, and one traced
   Q3 written as a Chrome trace that parses back with its ``query``,
   ``plan`` and ``device-sync`` spans; Q1 and SPILL_QUERIES[0] with
   ``dense_grouping=false`` under ``task_concurrency`` 1 and 4 (equal
   rows, the segment sum launching under both, warm walls printed);
   orders and lineitem written as ORC partitioned by orderkey % 8 and
   joined on (orderkey, b) with ``grouped_execution`` on and off (equal
   rows, the pool peak lower in buckets, the probe launching in the
   buckets); and the ``Verifier`` over the 22 TPC-H queries at
   VERIFY_SF (0.1), the CPU runner as control and the card runner as
   test (doubles within rel 1e-9), which must report 22 MATCH. Fails if
   a check fails or a kernel never launched in the phase.
12. mesh: SPMD execution (``exec/distributed.py``) with the card seen as
   MESH_SLOTS (4) mesh slots (``PRESTO_TPU_TORCH_MESH_SLOTS``, set only
   for this phase, so the earlier phases stay on one slot), every query
   with ``mesh_execution=on``: the 22 TPC-H queries at MESH_SF (1)
   against the path and tpch phases' CPU rows (in order; per query the
   wall, the flight rounds and the dominant bucket); BASELINE config 3,
   Q3 at MESH_BIG_SF (10; SF100 in BASELINE.json, cut for the time
   limit, widths and query untouched), cold and warm on the mesh, then
   cold and warm on one device (``mesh_execution=off``; the scan cache's
   limit raised to MESH_CACHE_BYTES for these runs, since Q3's splits
   at SF10 outgrow the default 2 GiB), the mesh rows
   against the single-device warm run, with the walls, the repartition
   rounds and bytes shipped, ``torch.cuda.max_memory_allocated`` over
   the mesh runs and the flight recorder's bucket split; the TPC-DS
   battery and q27 at TPCDS_SF against the tpcds phase's CPU rows (as
   multisets: ORDER BY ties may reorder); EXPLAIN (TYPE DISTRIBUTED) of
   Q3 equal to a CPU runner's text; EXPLAIN ANALYZE of Q3 with its mesh
   rounds section and ``system.runtime.mesh_rounds`` rows under its
   query id; ``mesh.repartition=error:boom,times:1`` armed, the next
   mesh Q3 raising ``FailpointError`` and the one after it returning
   equal rows; Q6 and Q1 on two threads under the fair scheduler, rows
   equal, the scheduler's accounts printed (each is one output batch,
   so one quantum: they run one after the other); then the scheduler's
   arbitration: a long mesh scan of about 370 batches and a short one
   started once the long one reached level 1, every quantum held at
   least FAIR_FLOOR_MS, and from the scheduler's quantum spans no two
   quanta overlapping, the short one at level 0 finishing before the
   long one with at most one long quantum between two of its own, rows
   equal to the single-device runs. Launches count in the mesh runs
   only (not the single-device reference runs), and per slot in each
   slot's shard bodies. Fails if a check fails, the segment sum never
   launched in the mesh runs or on any one slot; prints the probe's
   launches and the phase wall. The kernels line carries each kernel's
   mesh launches and their split over the slots.
13. serving: the serving and observability planes (``serving/``,
   ``obs/timeseries.py``, ``obs/slo.py``, ``obs/exposition.py``) on
   ``LocalRunner(tpch_sf=SERVING_SF (1), rows_per_batch=2**23)``: (a)
   warm Q3 SERVING_RUNS (10) times with ``plan_cache=false`` and 10
   times with it on, in turns (median wall, median planning seconds
   from the tracer's ``plan`` span, plan-cache hits: 9), rows against
   the path phase's CPU rows; (b) ``plan_template_cache``: a prepared Q6 form EXECUTEd
   with 8 bindings (discount range and quantity vary, the shipdate range
   fixed) must count 1 template build, 7 hits and 0 guard fallbacks, a
   binding that moves the shipdate bound 1 guard fallback, then a Q3
   form with 4 date bindings; every result equals the statement with
   its literals inlined run with templates off on the card, and Q6's and
   Q3's first binding the CPU rows; both kernels must launch in these
   runs; (c) ``result_cache``: Q1 a miss then a hit (equal rows; the hit
   launches neither kernel; both walls printed), a memory table read,
   then an INSERT into it (the next run misses and shows the row), an
   ORC table with a file appended (a partial hit that reads only the
   appended split, rows equal to a run with the cache off), and a write
   at the ``resultcache.stamp`` failpoint vetoing the insert; (d) four
   concurrent Q1s sent over HTTP to a ``PrestoTpuServer`` over the
   phase's runner whose resource groups are two groups, weights 2 and 1,
   by two ``StatementClient`` users each (rows equal,
   ``system.runtime.resource_groups`` rows, the scheduler's device
   seconds per group, group memory back at 0, two served walls per group
   recorded by the server itself); (e) after them
   ``system.runtime.timeseries``, ``slo`` and ``alerts`` return rows and
   ``render_exposition()`` parses back through ``parse_exposition``
   with the plan, template and result cache counters. Fails if a check
   fails; prints both kernels' launches and the phase wall.
14. frontdoor: the HTTP front door (``server/protocol.py``, ``client.py``,
   ``dbapi.py``, ``cli.py``, ``serving/fleet.py``, ``config.py``'s
   ``server_from_etc``). An etc directory in a temporary folder (tpch at
   FRONTDOOR_SF (1), memory, a SQLite catalog, ``http-server.http.port=0``,
   the serving phase's two weighted groups under a root ``frontdoor`` in
   ``resource-groups.json``)
   boots ``server_from_etc(etc, device="cuda")`` (its runner in 2^23-row
   batches, as the other phases'): (a) the 22 TPC-H queries through
   ``StatementClient`` against the path and tpch phases' CPU rows passed
   through the protocol's JSON encoding (integers, strings and dates
   exactly, doubles within rel 1e-9); (b) warm Q6, Q1 and Q3
   FRONTDOOR_RUNS (10) times each over HTTP and through
   ``runner.execute`` on the same runner, in turns: medians, minima,
   their difference (the protocol's cost a statement), responses and
   data pages a statement, and the statements the inline lane served;
   (c) the serving phase's Q6 form with its 8 qmark bindings through
   ``dbapi.connect(...).cursor()``, rows equal to the runner's; (d)
   ``cli.main`` with ``--server`` and CSV output of Q1, held against the
   CPU rows, then the embedded CLI (``--device cuda --sf
   FRONTDOOR_CLI_SF (0.1) --profile-out DIR -e Q3``), whose
   ``merged_trace.json`` must hold the tracer's host spans and both
   kernels' CUDA events inside Q3's query span; (e) a second server from
   the same etc, both fleet members: a write through the first drops the
   second's cached result (a bump folded) before its next read, which
   equals an uncached run, and ``GET /v1/fleet`` lists the peer; (f)
   ``/v1/metrics`` holds the ``serving_latency_seconds`` series of both
   groups as the server recorded them, ``/v1/metrics/history`` answers,
   ``/v1/info`` shows ``ACTIVE`` then ``SHUTTING_DOWN`` after
   ``begin_shutdown``, and the drained member leaves its peer's list.
   Fails if a check fails or a kernel never launched in the phase;
   prints both kernels' launches and the phase wall. The kernels line
   carries each kernel's frontdoor launches.
15. cluster: the coordinator and its workers (``exec/cluster.py``,
   ``server/worker.py``, ``exec/spool.py``, ``planner/codec.py``), with
   the tracer off except in (e). Two in-process ``WorkerServer``s on
   ``cuda`` under a discovery-fed ``ClusterRunner(device="cuda",
   heartbeat=True)``, all in 2^23-row batches at CLUSTER_SF (1): (a) the
   22 TPC-H queries, each cold (scan cache cleared), against the CPU
   rows, each wall beside the one-device cold wall of the path and tpch
   phases, with the exchange bytes, pages and responses it sent and the
   launches of its tasks (the reference's ClusterRunner runs all 22 at
   SF 0.01, so none is left out); (b) Q3 with
   ``broadcast_join_row_limit=0`` (BASELINE config 3's partitioned
   lineitem-orders join, over HTTP) warm CLUSTER_RUNS (5) times in turns
   with one device, medians; the exchange bytes of a broadcast and a
   partitioned Q3; (e) a traced Q3: the spans of every task of both
   workers lie under the query's span; (f) a cluster memory limit of
   CLUSTER_MEMORY_LIMIT (1 MiB) kills Q3 with the reference's error;
   (d) a subprocess worker (``python -m presto_tpu_torch.server.worker
   --device cuda --tpch-sf 1``) announces to a statement server serving
   the ``ClusterRunner``; Q1 and Q3 over HTTP on the three workers equal
   the CPU rows, the subprocess's ``/v1/metrics`` counts its own
   launches of both kernels, and after ``PUT /v1/info/state``
   SHUTTING_DOWN the process exits within its grace; (c) the chaos
   scenarios of ``_devtools/chaos.py`` at CLUSTER_CHAOS_SF (0.1) on
   ``cuda`` with a CLUSTER_STRAGGLER_S (6 s) straggler: rows equal the
   fault-free run after each fault, recovery counters move, and the
   spool ends with no per-query directory. Fails if a check fails or a
   kernel never launched inside the workers' tasks; the kernels line
   carries each kernel's cluster launches (the workers' tasks in this
   process and the subprocess worker's, which it also shows apart).
16. autoscale: the elasticity control loop (``exec/autoscale.py``,
   ``_devtools/chaos.py``'s drills). (a) ``server_from_etc(etc,
   device="cuda")`` from an etc directory with ``autoscale.enabled=true``
   (AUTOSCALE_MIN_WORKERS to AUTOSCALE_MAX_WORKERS workers, one per step,
   AUTOSCALE_INTERVAL_S ticks, AUTOSCALE_COOLDOWN_S cooldown), a spool
   directory, TPC-H at AUTOSCALE_SF (1) and one resource group of
   concurrency 1: the boot seats the floor worker (``python -m
   presto_tpu_torch.server.worker --device cuda --etc-dir ...``, launched
   by the controller's ``LocalProcessProvider``), the server serves a
   ``ClusterRunner`` over its discovery (2^23-row batches), and
   AUTOSCALE_CLIENTS (6) clients each sending Q3 after Q3 queue deep: the
   controller confirms ``scale_up`` and launches subprocess workers on
   the card, which announce and take the queued Q3s (each equal to the
   CPU rows); the load holds until the pool is at its ceiling and every
   worker launched both kernels; once idle, ``scale_down`` drains the
   pool back to its floor (each drained process exits by itself, code
   0), and the harness drains the floor worker. Prints each worker's
   ready time, every action with its time, the pool size over time, the
   counters and ``GET /v1/autoscale``'s policy and streaks; fails unless
   ``autoscale_actions_total.scale_up`` and ``.scale_down`` moved and
   every worker's ``/v1/metrics`` (read before its drain) counts its own
   launches of both kernels. (b) ``run_elastic_ramp(device="cuda")`` at
   the reference's RAMP (SF 0.02, 1 -> 3 -> 1 workers, 8 s windows, 4
   clients, a 60 ms device floor in
   ``PRESTO_TPU_TORCH_DEVICE_FLOOR_MS``, 16384-row batches): no failed
   query, the pool back at 1, peak QPS at least 1.5x the one-worker
   floor, every drained worker exiting with code 0; the kernel libraries
   are unchanged after (no worker built one). (c) the preemption storm and scale to zero (from the cluster
   phase's chaos run; run alone, the phase runs the scenarios) and
   ``run_fleet_chaos`` at CLUSTER_CHAOS_SF (0.1) on ``cuda``: rows equal
   the fault-free run's, the spool and the object store end with no
   per-query directory. Every line carries the card's name and power
   limit. The kernels line carries each kernel's autoscale launches (the
   autoscaled workers' own), also summed into its launches.
17. tools: the port's reference tools (``_devtools/``). With every
   launch count read before and after: ``profile_query`` of Q3 at
   TOOLS_SF (1) on ``cuda``, warm (its second run profiled): prints the
   operator table (wall, self, rows, batches, device and kernel seconds,
   bound-formula bytes, join strategy) and the kernel rows; fails unless
   the document lists both hand kernels with launches and device seconds
   and its rows equal the CPU rows; then the same query on the card
   seen as TOOLS_MESH_SLOTS (4) slots, whose flight attribution must
   pass ``mesh_report.validate_attribution``; then
   ``slo_report.validate_slo_block`` over the live ``GET /v1/slo`` block
   of a small server (SF 0.01, one SLO'd group) that served three
   statements. The kernels line carries each kernel's tools launches,
   also summed into its launches.

Every breakdown line times the plan's table scans twice: with the scan
cache cleared (host generation and the copy to the card) and as a warm
replay of the cached splits.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or presto_tpu.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 2 alone and
prints the kernels line; ``--surface-only`` runs phases 1 and 7 alone,
``--files-only`` phases 1 and 8, ``--chains-only`` phases 1 and 9,
``--spill-only`` phases 1 and 10, ``--statements-only`` phases 1 and 11,
``--mesh-only`` phases 1 and 12, ``--serving-only`` phases 1 and 13,
``--frontdoor-only`` phases 1 and 14, ``--cluster-only`` phases 1 and
15, ``--autoscale-only`` phases 1 and 16, ``--tools-only`` phases 1
and 17 (each computes its reference rows itself; the mesh phase's are
the card's single-device runs).
Either times whichever ``presto_tpu_torch`` sits beside the script, so
a copy of the script placed in a checkout of another commit measures
that commit (turn by turn with this one, in one call, to compare them).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

#: H100 SXM device memory rate, bytes per second (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
SEED = 20261016
ROWS_PER_BATCH = 1 << 23
#: the queries of the path phase; the tpch phase runs the others
PATH_QUERIES = ("q6", "q1", "q3")
#: the tpcds phase's scales: the battery, and q55 / q27 as the benchmark
#: runs them. The battery and the surface phase run at SF 0.5 (SF1 up to
#: PR 7) so that the chains and spill phases fit the script's time aim;
#: their CPU reference runs took most of those phases' walls.
TPCDS_SF, TPCDS_BIG_SF = 0.5, 10
SURFACE_SF = 0.5
#: q27 as the benchmark runs it (bench.py); tests/tpcds_queries.py
#: carries the other queries
TPCDS_Q27 = """
select i_item_id, s_state, grouping(s_state) g_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College' and d_year = 2002
  and s_state in ('TN', 'TN', 'TN', 'TN', 'TN', 'TN')
group by rollup (i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100
"""
#: the surface phase's statements (name, SQL): mixed DISTINCT,
#: variance, boolean and sketch aggregates, long decimals as values, keys
#: and join payloads, the scalar functions, and UNNEST
SURFACE_QUERIES = (
    ("aggs_drain", """
select l_returnflag, l_linestatus, count(distinct l_suppkey),
       sum(distinct l_linenumber), stddev(l_quantity), var_pop(l_discount),
       var_samp(l_discount), bool_and(l_quantity > 1),
       bool_or(l_quantity > 49), approx_distinct(l_orderkey),
       approx_percentile(l_extendedprice, 0.5)
from lineitem group by l_returnflag, l_linestatus order by 1, 2"""),
    ("aggs_dense", """
select l_returnflag, l_linestatus, count(distinct l_suppkey),
       sum(distinct l_linenumber), stddev(l_quantity), var_pop(l_discount),
       var_samp(l_discount), bool_and(l_quantity > 1),
       bool_or(l_quantity > 49), count(*)
from lineitem group by l_returnflag, l_linestatus order by 1, 2"""),
    ("sketches", """
select approx_distinct(l_orderkey), approx_distinct(l_partkey, 0.01),
       approx_distinct(l_shipmode), approx_percentile(l_extendedprice, 0.5),
       approx_percentile(l_quantity, 0.9), count(distinct l_suppkey),
       sum(distinct l_linenumber), stddev_pop(l_extendedprice)
from lineitem"""),
    ("aggs_sort", """
select count(*), sum(d), sum(s), sum(v), max(v), min(s)
from (select l_orderkey, count(distinct l_suppkey) d,
             variance(l_quantity) v, sum(l_linenumber) s
      from lineitem group by l_orderkey)"""),
    ("aggs_sort_top", """
select l_orderkey, count(distinct l_suppkey), variance(l_quantity),
       sum(l_linenumber)
from lineitem group by l_orderkey order by 4 desc, 1 limit 20"""),
    ("dec_sums", """
select l_returnflag, sum(cast(l_extendedprice as decimal(38,2))),
       avg(cast(l_extendedprice as decimal(38,2))),
       sum(cast(l_quantity as decimal(20,2))
           * cast(l_discount as decimal(20,2))),
       min(cast(l_extendedprice as decimal(30,2))),
       max(cast(l_extendedprice as decimal(30,2)))
from lineitem group by l_returnflag order by 1"""),
    ("dec_keys", """
select cast(o_totalprice as decimal(30,2)) p, count(*)
from orders group by 1 order by 2 desc, 1 limit 20"""),
    ("dec_order", """
select o_orderkey, cast(o_totalprice as decimal(30,2)) p
from orders order by p desc, o_orderkey limit 20"""),
    ("dec_payload_join", """
select l_returnflag, sum(p), count(*)
from lineitem join (select o_orderkey,
                           cast(o_totalprice as decimal(30,2)) p
                    from orders) o on l_orderkey = o.o_orderkey
group by l_returnflag order by 1"""),
    ("dec_key_join", """
select count(*), sum(q)
from (select cast(l_orderkey as decimal(25,0)) lk, l_quantity q
      from lineitem) l
  join (select cast(o_orderkey as decimal(25,0)) k, o_orderstatus
        from orders) o on l.lk = o.k
where o.o_orderstatus = 'F'"""),
    ("functions", """
select date_trunc('month', o_orderdate) m, count(*),
       round(sum(o_totalprice), 1), sqrt(sum(o_totalprice)),
       max(date_diff('day', o_orderdate, date '1998-12-31')),
       min(ltrim(o_clerk)), json_extract_scalar('{"a": 1}', '$.a'),
       url_extract_host('http://example.com:8080/x?y=1')
from orders where regexp_like(o_comment, 'special')
group by 1 order by 1"""),
    ("unnest_group", """
select u, count(*), sum(x)
from orders cross join unnest(array[o_orderstatus, o_orderpriority],
                              array[o_custkey, o_shippriority]) as t(u, x)
group by u order by u"""),
    ("unnest_sequence", """
select count(*), sum(x), min(x), max(x), sum(o)
from unnest(sequence(1, 100000)) with ordinality as t(x, o)"""),
)
#: the surface phase's checked statements (name, SQL, the error name the
#: card and the CPU must both raise or None where their rows must match,
#: the type displays both must give or None): the column-level
#: out-of-range cast (the card's conversion saturated it, the CPU's
#: wrapped it), a sort-path grouped sum whose groups leave int64, the
#: exact short-decimal division past 2^53, substr with a negative start;
#: then integer literals typed INTEGER where they fit in 32 bits (Presto's
#: LongLiteral typing), an INTEGER CASE summed on the sort path (it
#: launches the segment sum), INTEGER arithmetic that must raise, and
#: decimal arithmetic with integral operands of their own digits
_DEC7 = "cast(o_totalprice / 10 as decimal(7,2))"
SURFACE_CHECKED = (
    ("cast_out_of_range", """
select max(cast(cast(o_orderkey as double) * 1e6 as integer))
from orders""", "INVALID_CAST_ARGUMENT", None),
    ("sum_overflow_sort", """
select o_orderkey % 7 k, sum(cast(o_orderkey as bigint) * 1000000000000)
from orders group by 1 order by 1""", "NUMERIC_VALUE_OUT_OF_RANGE", None),
    ("decimal_division", """
select o_orderkey, cast(cast(o_orderkey as bigint) * 100000000000
                        as decimal(18,0)) / cast(3 as decimal(1,0))
from orders order by o_orderkey desc limit 5""", None, None),
    ("substr_negative", """
select n_nationkey, substr(n_name, -3) from nation order by 1""", None,
     None),
    ("literal_types", """
select 1, 2147483647, 2147483648, -2147483648, array[1, 2],
       sequence(1, 3)""", None,
     ["integer", "integer", "bigint", "bigint", "array(integer)",
      "array(bigint)"]),
    ("sum_integer_case_sort", """
select o_custkey % 5 k,
       sum(case when o_orderpriority = '1-URGENT' then 1 else 0 end),
       avg(case when o_orderstatus = 'F' then 2 else 0 end)
from orders group by 1 order by 1""", None, ["bigint", "bigint", "double"]),
    ("integer_plus_literal", """
select max(cast(o_orderkey as integer) + 2147483600), count(*)
from orders where o_orderkey <= 47""", None, ["integer", "bigint"]),
    ("integer_plus_literal_overflow", """
select max(cast(o_orderkey as integer) + 2147483600) from orders""",
     "NUMERIC_VALUE_OUT_OF_RANGE", None),
    ("integer_sum_of_literals_overflow", """
select sum(2147483647 + o_shippriority + 1) from orders""",
     "NUMERIC_VALUE_OUT_OF_RANGE", None),
    ("values_sum_overflow", """
select sum(k + 2147483600) from (values 1, 47, 48) t(k)""",
     "NUMERIC_VALUE_OUT_OF_RANGE", None),
    ("constant_overflow", "select 2147483647 + 1",
     "NUMERIC_VALUE_OUT_OF_RANGE", None),
    ("try_constant_overflow", "select try(2147483647 + 1)", None,
     ["integer"]),
    ("decimal_times_integer", f"""
select o_orderkey, {_DEC7} * cast(o_custkey as integer), {_DEC7} * 3
from orders order by o_orderkey limit 50""", None,
     ["bigint", "decimal(17,2)", "decimal(17,2)"]),
    ("decimal_plus_smallint", f"""
select o_orderkey, {_DEC7} + cast(o_shippriority + 7 as smallint)
from orders order by o_orderkey limit 50""", None,
     ["bigint", "decimal(8,2)"]),
    ("decimal_mod", f"""
select o_orderkey, {_DEC7} % 2, {_DEC7} % cast(o_custkey as bigint),
       {_DEC7} % cast(200000000000000000 as bigint)
from orders order by o_orderkey limit 50""", None,
     ["bigint", "decimal(7,2)", "decimal(7,2)", "decimal(7,2)"]),
    ("values_join_integer_key", """
select n_name, v.w from nation join (values (1, 'x'), (7, 'y'), (24, 'z'))
  v(k, w) on n_nationkey = v.k order by n_name""", None,
     ["varchar(25)", "varchar(1)"]),
    ("values_mixed_width", """
select x from (values (1), (5000000000)) t(x) order by x""", None,
     ["bigint"]),
)
#: the sort-path grouped sum near the int64 edge: its factor is chosen
#: from the CPU run so that the largest group lies within one factor of
#: 2^63 - 1
SURFACE_EDGE_KEYS = """
select o_orderkey % 7 k, sum(o_orderkey) from orders group by 1"""
SURFACE_EDGE_SUM = """
select o_orderkey % 7 k, sum(cast(o_orderkey as bigint) * {factor})
from orders group by 1 order by 1"""
#: rows a block of csrc/scan.cu sums (ops/scan.py TILE_ROWS); a constant
#: here so that the script also times kernels of commits that predate it
SCAN_TILE_ROWS = 2048
#: the files phase: TPC-H at FILES_SF, lineitem (all 16 columns) in this
#: many ORC files, orders and customer in one each, every file in stripes
#: of the writer's default 2^16 rows; lineitem's Q1 and Q6 columns in
#: this many Parquet files of one row group each. SF 0.5 (SF1 up to PR 7)
#: keeps the script near its time aim with the chains and spill phases.
FILES_SF = 0.5
ORC_LINEITEM_FILES = 4
PARQUET_FILES = 8
PARQUET_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                   "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
#: BASELINE config 5's scan-filter-project, returning rows: an
#: l_orderkey range over the clustered key, which must prune stripes (at
#: SF1 keys 1 000 000 to 1 060 000 of 1.5 M orders; the range scales with
#: FILES_SF, so it covers the same share of the table)
def config5_sql(sf):
    """CONFIG5_SQL at scale factor ``sf``."""
    return f"""
select l_orderkey, l_linenumber, l_extendedprice * (1 - l_discount) as
       disc_price, l_shipdate, l_shipmode
from lineitem
where l_orderkey between {int(1_000_000 * sf)}
  and {int(1_060_000 * sf)} and l_quantity < 24
"""


CONFIG5_SQL = config5_sql(FILES_SF)


#: the chains phase: the TPC-H queries the JAX package runs through a
#: fused join chain (q27 at SF10 joins them)
CHAIN_QUERIES = ("q2", "q5", "q7", "q8", "q9", "q10", "q11", "q17", "q18",
                 "q21")
#: the spill phase: tests/test_spill.py's queries (hash aggregation, a
#: partitioned join, a left join, DISTINCT, a full ORDER BY with a
#: descending string key, string group keys) over TPC-H SF1 in batches
#: of 2^20 rows, so lineitem streams as 6 batches whose partial states
#: merge
SPILL_QUERIES = (
    "select l_orderkey, sum(l_quantity) q, count(*) c from lineitem "
    "group by l_orderkey order by l_orderkey limit 50",
    "select o_orderpriority, count(*) c from orders, lineitem "
    "where l_orderkey = o_orderkey group by o_orderpriority "
    "order by o_orderpriority",
    "select count(*) c, count(o_orderkey) co from customer left join "
    "orders on c_custkey = o_custkey",
    "select count(*) c from (select distinct l_suppkey, l_returnflag "
    "from lineitem) t",
    "select o_orderstatus, o_orderkey from orders "
    "order by o_orderstatus desc, o_orderkey",
    "select l_returnflag, l_linestatus, count(*) c, sum(l_quantity) q "
    "from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
)
SPILL_ROWS_PER_BATCH = 1 << 20
#: the mesh phase: one card seen as this many mesh slots
#: (PRESTO_TPU_TORCH_MESH_SLOTS, set only for the phase), TPC-H at
#: MESH_SF on the mesh, BASELINE config 3 (TPC-H Q3 with a partitioned
#: exchange; SF100 in BASELINE.json) cut to MESH_BIG_SF so the script
#: stays inside its time limit (widths and the query untouched), and the
#: TPC-DS battery at TPCDS_SF
MESH_SLOTS = 4
MESH_SF, MESH_BIG_SF = 1, 10
#: the scan cache's limit for config 3's runs (the default is 2 GiB)
MESH_CACHE_BYTES = 12 << 30
#: the fair scheduler's arbitration check: rows a slot takes per batch at
#: SF1 (scaled with the scale factor), so the long scan below runs about
#: 370 quanta and the short one about 10; and the modeled device-service
#: floor of each quantum during the check (taskexec.set_service_floor_ms),
#: so the long scan climbs to level 1 (1 s billed over 4 slots) after
#: about 63 quanta on any host: warm quanta of these scans take well
#: under a millisecond, which would leave it at level 0
FAIR_ROWS_PER_BATCH = 1 << 12
FAIR_FLOOR_MS = 4.0
FAIR_LONG_SQL = ("select l_orderkey, l_linenumber from lineitem "
                 "where l_quantity = 1 and l_discount = 0")
FAIR_SHORT_SQL = "select c_custkey from customer where c_acctbal > 9900"
#: the join and the ORDER BY also run with the disk tier; the ORDER BY
#: stages about 29 MiB, so the host tier is cut to 16 MiB for both
SPILL_DISK_QUERIES = (1, 4)
SPILL_DISK_BYTES = 16 << 20


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr,
          flush=True)
    sys.exit(1)


def median_ms(fn, torch, warmup: int = 3, runs: int = 15) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, torch, calls: int = 20):
    """(ms, source): device-only time of one ``fn()`` call, the sum of the
    CUDA records (kernels, memsets, copies) torch.profiler takes over
    ``calls`` calls divided by ``calls``; where the profiler records none,
    CUDA events around ``calls`` back-to-back calls, divided likewise."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / calls, "profiler"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls, "events"


def phase_device(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = out.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    from presto_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    secs = kernels.build()
    print(f"build: {json.dumps({k: round(v, 3) for k, v in secs.items()})} "
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in kernels.PTXAS_REPORT.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    return card


def _runs_case(torch, gen, n: int, live: int, groups: int):
    """Sorted-run segment-sum inputs: ``groups`` runs over the first
    ``live`` rows, a zero-valued dead tail, absent groups at starts == n,
    and values near +-2^62 so the int64 sums wrap."""
    dev = torch.device("cuda")
    values = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                           device=dev, dtype=torch.int64)
    values[live:] = 0
    cuts = torch.randperm(live - 1, generator=gen, device=dev)[:groups - 1] + 1
    starts = torch.full((n,), n, dtype=torch.int32, device=dev)
    starts[0] = 0
    starts[1:groups] = torch.sort(cuts).values.to(torch.int32)
    gid = torch.searchsorted(starts[:groups].to(torch.int64),
                             torch.arange(n, device=dev), right=True) - 1
    return values, starts, gid


def _scan_edge_cases(torch, gen):
    """(name, values, starts) cases around the kernel's tiles of
    ``SCAN_TILE_ROWS`` rows; every case compares all segments, absent
    ones included."""
    dev = torch.device("cuda")
    tile = SCAN_TILE_ROWS

    def vals(n):
        return torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                             device=dev, dtype=torch.int64)

    def starts_of(points, cap, n):
        s = torch.full((cap,), n, dtype=torch.int32, device=dev)
        s[:len(points)] = torch.tensor(points, dtype=torch.int32, device=dev)
        return s

    n = 5 * tile + 3
    edges = [0, tile - 1, tile, tile + 1, 2 * tile - 1, 3 * tile + 1,
             4 * tile, 4 * tile + 2, 5 * tile]
    ragged = 3 * tile + 1001
    cuts = torch.sort(torch.randperm(ragged - 1, generator=gen, device=dev)
                      [:300] + 1).values.tolist()
    return [
        ("tile_edges", vals(n), starts_of(edges, len(edges) + 4, n)),
        ("one_run_all_rows", vals(n), starts_of([0], 8, n)),
        ("all_groups_absent", vals(n), starts_of([], 16, n)),
        ("ragged_n", vals(ragged), starts_of([0] + cuts, 400, ragged)),
        ("one_row", vals(1), starts_of([0], 2, 1)),
        ("empty_at_row_0", vals(n), starts_of([0, 0, 0, 7, 7, tile], 9, n)),
    ]


def check_scan(torch, gen):
    from presto_tpu_torch.ops import scan
    # bit-exactness at 2^23 lanes, with few long runs and with a million
    # short ones, at Q3's shape, and on the edge cases; timing at the
    # shape Q3's partial aggregation gives the kernel at SF1 (a 2^18-lane
    # compacted join output, ~150 K live rows, ~56.5 K groups), and at
    # 2^23 short runs
    n = 1 << 23
    live = 6_000_000
    cases = {"few_long_runs": (n, _runs_case(torch, gen, n, live, 64)),
             "short_runs": (n, _runs_case(torch, gen, n, live, 1 << 20)),
             "q3_partial": (1 << 18, _runs_case(torch, gen, 1 << 18,
                                                150_000, 56_552))}
    checks = [(name, size, values, starts)
              for name, (size, (values, starts, _)) in cases.items()]
    checks += [(name, starts.shape[0], values, starts)
               for name, values, starts in _scan_edge_cases(torch, gen)]
    errs = []
    for name, size, values, starts in checks:
        got = scan.segment_sum_sorted_i64(values, starts, size)
        want = scan.segment_sum_sorted_plain(values, starts, size)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"segment sum {name}: {bad} groups differ")
        errs.append(int((got - want).abs().max()))
        groups = int((starts < values.shape[0]).sum())
        print(f"segment_sum_sorted_i64 {name}: n={values.shape[0]} "
              f"segments={size} live={groups} bit-exact", flush=True)

    def timed(size, values, starts, gid):
        call = lambda: scan.segment_sum_sorted_i64(values, starts, size)
        ms = median_ms(call, torch)
        dev_ms, dev_by = device_ms(call, torch)
        plain_ms = median_ms(lambda: scan.segment_sum_sorted_plain(
            values, starts, size), torch)
        lib_ms = median_ms(lambda: torch.zeros(
            size, dtype=torch.int64, device=values.device)
            .index_add_(0, gid, values), torch)
        bytes_moved = 8 * size + 4 * size + 8 * size  # values, starts, sums
        return (ms, dev_ms, dev_by, plain_ms, lib_ms,
                bytes_moved / HBM_BYTES_PER_S * 1e3)

    big = timed(n, *cases["short_runs"][1])
    ms, dev_ms, dev_by, plain_ms, lib_ms, bound_ms = timed(
        1 << 18, *cases["q3_partial"][1])
    for label, t in (("2^23 lanes, 2^20 runs", big),
                     ("2^18 lanes (Q3)", (ms, dev_ms, dev_by, plain_ms,
                                          lib_ms, bound_ms))):
        print(f"segment_sum_sorted_i64 {label}: wrapper {t[0]:.4f} ms, "
              f"device {t[1]:.4f} ms ({t[2]}), plain {t[3]:.4f} ms, "
              f"library {t[4]:.4f} ms, bound {t[5]:.4f} ms", flush=True)
    return {"name": "segment_sum_sorted_i64", "route": "cuda",
            "source": "presto_tpu_torch/csrc/scan.cu",
            "replaces": "presto_tpu/ops/pallas_scan.py:85",
            "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms,
            "device_ms": dev_ms, "device_ms_by": dev_by,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "ok": True,
            "shape": "n=262144 segments=262144 runs=56552",
            "edge_cases": len(checks) - len(cases),
            "n2p23_ms": big[0], "n2p23_device_ms": big[1],
            "n2p23_plain_ms": big[3], "n2p23_library_ms": big[4],
            "n2p23_bound_ms": big[5]}


def _probe_bits(torch, t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.to(torch.int64) if t.dtype == torch.bool else t


def _probe_equal(torch, name, got, want):
    """Bit-exact comparison of (cnt, vb, payload outputs); returns the
    largest float difference (0 when equal)."""
    pairs = [(got[0], want[0]), (got[1], want[1])] + list(zip(got[2],
                                                              want[2]))
    err = 0.0
    for i, (a, b) in enumerate(pairs):
        if a.shape != b.shape or not torch.equal(_probe_bits(torch, a),
                                                 _probe_bits(torch, b)):
            raise AssertionError(f"probe {name}: output {i} differs")
        if a.is_floating_point() and a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def _probe_table(torch, gen, size, n_build, live_build, key_span):
    """lo/cnt tables of a unique build: ``live_build`` sorted keys below
    ``key_span`` at build rows 0..live_build-1."""
    dev = torch.device("cuda")
    keys = torch.sort(torch.randperm(key_span, generator=gen, device=dev)
                      [:live_build]).values
    lo_table = torch.full((size,), n_build, dtype=torch.int32, device=dev)
    lo_table[keys] = torch.arange(live_build, dtype=torch.int32, device=dev)
    cnt_table = torch.zeros(size, dtype=torch.int32, device=dev)
    cnt_table[keys] = 1
    return lo_table, cnt_table


def _probe_column(torch, gen, kind, rows):
    dev = torch.device("cuda")
    if kind == "bool":
        return torch.rand(rows, generator=gen, device=dev) < 0.5
    if kind == "int":
        return torch.randint(-(1 << 30), 1 << 30, (rows,), generator=gen,
                             device=dev, dtype=torch.int32)
    i64 = torch.randint(-(1 << 62), 1 << 62, (rows,), generator=gen,
                        device=dev, dtype=torch.int64)
    if kind == "bigint":
        return i64
    if kind == "double":
        return i64.to(torch.float64) * 1e-9
    return torch.stack([i64 >> 3, i64], dim=1)                    # int128


def _probe_edge_cases(torch, gen):
    """(name, codes, lo, cnt, vbits, payload) edge cases: all lanes dead,
    an empty build, exactly 31 payload columns (the largest by-value
    descriptor set), and int128 and 1-byte columns at a lane count that
    is no multiple of a block's lanes or of a thread's 4."""
    dev = torch.device("cuda")
    size, n_build = 4096, 3000
    lo, cnt = _probe_table(torch, gen, size, n_build, 2500, 4000)

    def codes(n, dead=0.3):
        c = torch.randint(0, 4000, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        c[torch.rand(n, generator=gen, device=dev) < dead] = -1
        return c

    def vbits(rows, cols):
        return torch.randint(0, 1 << min(cols, 30), (rows,), generator=gen,
                             device=dev, dtype=torch.int32)

    kinds = ["bool", "int", "bigint", "double", "int128"]
    zoo = [_probe_column(torch, gen, k, n_build) for k in kinds]
    wide = [_probe_column(torch, gen, kinds[c % len(kinds)], n_build)
            for c in range(31)]
    empty = [p[:0] for p in zoo]
    return [
        ("all_lanes_dead", torch.full((5000,), -1, dtype=torch.int32,
                                      device=dev), lo, cnt,
         vbits(n_build, 5), zoo),
        ("empty_build", codes(5000), lo, torch.zeros_like(cnt),
         vbits(0, 5), empty),
        ("31_columns", codes(9000), lo, cnt, vbits(n_build, 31), wide),
        ("int128_and_bool_ragged", codes(3 * 1024 + 517), lo, cnt,
         vbits(n_build, 2), [zoo[0], zoo[4]]),
    ]


def check_probe(torch, gen):
    from presto_tpu_torch.ops import probe
    dev = torch.device("cuda")
    # Q3's lineitem x orders probe at SF1 in one batch: 6 M lineitem rows
    # in a 2^23-lane batch of which ~54% pass the ship-date filter,
    # orders keys 1..1.5 M in a 2^21-slot table, the ~730 K orders rows
    # that pass the date filter in a 2^20-row compacted build
    n, size, n_build = 1 << 23, 1 << 21, 1 << 20
    key_span, live_build, rows = 1_500_000, 727_000, 6_000_000
    lo_table, cnt_table = _probe_table(torch, gen, size, n_build,
                                       live_build, key_span)
    codes = torch.randint(0, key_span, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    codes[rows:] = -1
    codes[torch.rand(n, generator=gen, device=dev) >= 0.54] = -1
    vbits = torch.randint(0, 1 << 6, (n_build,), generator=gen, device=dev,
                          dtype=torch.int32)
    payload = [_probe_column(torch, gen, k, n_build) for k in
               ("bool", "int", "int", "bigint", "double", "int128")]
    payload[2] = payload[2] & 3                                   # code
    # the same lanes with lineitem's key order: ascending order keys, about
    # four lanes a key, the same dead lanes
    clustered = (torch.arange(n, device=dev) * key_span // rows).to(
        torch.int32)
    clustered[codes < 0] = -1
    cases = [("q3_shape", codes, lo_table, cnt_table, vbits, payload),
             ("q3_shape_clustered_keys", clustered, lo_table, cnt_table,
              vbits, payload)]
    cases += _probe_edge_cases(torch, gen)
    err = 0.0
    for name, *inputs in cases:
        got = probe.direct_probe(*inputs)
        want = probe.direct_probe_plain(*inputs)
        torch.cuda.synchronize()
        err = max(err, _probe_equal(torch, name, got, want))
        print(f"direct_probe {name}: n={inputs[0].shape[0]} "
              f"build={inputs[3].shape[0]} cols={len(inputs[4])} "
              f"hits={int((got[0] > 0).sum())} bit-exact", flush=True)
    widths = sum(p.element_size() * (p.shape[1] if p.ndim == 2 else 1)
                 for p in payload)

    def timed(codes):
        """(wrapper ms, device ms, its source, plain ms, library ms, bound
        ms, live lanes, matched lanes) at the Q3 shape with ``codes``."""
        want = probe.direct_probe_plain(codes, lo_table, cnt_table, vbits,
                                        payload)
        live = int((codes >= 0).sum())
        hits = int((want[0] > 0).sum())
        call = lambda: probe.direct_probe(codes, lo_table, cnt_table, vbits,
                                          payload)
        ms = median_ms(call, torch)
        dev_ms, dev_by = device_ms(call, torch)
        plain_ms = median_ms(lambda: probe.direct_probe_plain(
            codes, lo_table, cnt_table, vbits, payload), torch)
        pos = torch.where(want[0] > 0,
                          lo_table[codes.clamp(min=0).long()], 0).long()
        lib_ms = median_ms(lambda: [p.index_select(0, pos)
                                    for p in payload], torch)
        bytes_moved = (4 * n + 8 * live        # codes, lo/cnt of live lanes
                       + hits * (4 + widths)   # vbits + payload gathered
                       + n * (4 + 4 + widths))  # cnt, vb, payload written
        return (ms, dev_ms, dev_by, plain_ms, lib_ms,
                bytes_moved / HBM_BYTES_PER_S * 1e3, live, hits)

    ms, dev_ms, dev_by, plain_ms, lib_ms, bound_ms, live, hits = timed(codes)
    print(f"direct_probe Q3 shape, random keys: wrapper {ms:.4f} ms, device "
          f"{dev_ms:.4f} ms ({dev_by}), plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms", flush=True)
    cl = timed(clustered)
    print(f"direct_probe Q3 shape, clustered keys: wrapper {cl[0]:.4f} ms, "
          f"device {cl[1]:.4f} ms ({cl[2]}), plain {cl[3]:.4f} ms, library "
          f"{cl[4]:.4f} ms, bound {cl[5]:.4f} ms", flush=True)
    return {"name": "direct_probe", "route": "cuda",
            "source": "presto_tpu_torch/csrc/probe.cu",
            "replaces": "presto_tpu/ops/pallas_join.py:218",
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "device_ms": dev_ms, "device_ms_by": dev_by,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "ok": True,
            "edge_cases": len(cases) - 2,
            "shape": f"n={n} slots={size} build={n_build} live={live} "
                     f"hits={hits} cols={len(payload)}",
            "clustered_ms": cl[0], "clustered_device_ms": cl[1],
            "clustered_plain_ms": cl[3], "clustered_library_ms": cl[4],
            "clustered_bound_ms": cl[5]}


def _same_rows(gpu_rows, cpu_rows, rel: float, what: str = "") -> None:
    """``what`` (a query's name) heads the message of a mismatch."""
    at = f"{what}: " if what else ""
    if len(gpu_rows) != len(cpu_rows):
        raise AssertionError(f"{at}{len(gpu_rows)} rows on cuda, "
                             f"{len(cpu_rows)} on cpu")
    for i, (a, b) in enumerate(zip(gpu_rows, cpu_rows)):
        for u, v in zip(a, b):
            if isinstance(u, float):
                if not (math.isfinite(u) and abs(u - v) <= rel * abs(v)):
                    raise AssertionError(f"{at}row {i}: {u!r} vs {v!r}")
            elif u != v:
                raise AssertionError(f"{at}row {i}: {u!r} vs {v!r}")


def phase_path(torch):
    """Q6, Q1, Q3 at SF1 cold and warm on the card against the CPU run;
    returns the launches and the CPU rows."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.ops import probe, scan
    queries = _queries()
    # one 2^23-lane batch holds all of SF1's 6 M lineitem rows
    gpu = LocalRunner(tpch_sf=1, rows_per_batch=ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=1, device="cpu", rows_per_batch=ROWS_PER_BATCH)
    results, cpu_rows = {}, {}
    scan.launches = 0
    probe.launches = 0
    q3_launches = None
    for name in PATH_QUERIES:
        before = (scan.launches, probe.launches)
        walls = []
        CACHE.clear()
        for _ in range(2):              # cold, then warm
            t0 = time.perf_counter()
            res = gpu.execute(queries[name])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if name == "q3":
            q3_launches = (scan.launches - before[0],
                           probe.launches - before[1])
        results[name] = (res, walls)
        LOCAL_COLD_WALLS[name] = walls[0]
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"path launches: {json.dumps(launches)} q3 (cold+warm): "
          f"scan {q3_launches[0]} probe {q3_launches[1]}", flush=True)
    if min(q3_launches) <= 0:
        raise AssertionError("a kernel of the Q3 path never launched")
    for name, (res, walls) in results.items():
        t0 = time.perf_counter()
        ref = cpu.execute(queries[name])
        cpu_s = time.perf_counter() - t0
        cpu_rows[name] = ref.rows
        _same_rows(res.rows, ref.rows, 1e-9)
        print(f"{name}: cuda cold {walls[0]:.3f} s warm {walls[1]:.3f} s | "
              f"cpu {cpu_s:.3f} s | {len(res.rows)} rows match the cpu run",
              flush=True)
    q3_all = queries["q3"].replace("limit 10", "")
    print(f"q3 groups before LIMIT 10 at SF1: "
          f"{len(gpu.execute(q3_all).rows)}", flush=True)
    for name in PATH_QUERIES:
        _breakdown(torch, gpu, name, queries[name])
    return launches, cpu_rows


def _card_busy(torch, fn) -> str:
    """The card's busy time over one ``fn()`` call from torch.profiler's
    CUDA records, against the call's wall. Informational: a profiler that
    records nothing gives 'not measured' and fails no phase."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    except Exception as e:  # noqa: BLE001 - informational only
        return f"not measured ({type(e).__name__}: {e})"
    if dev_us <= 0:
        return "not measured"
    return (f"{dev_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms profiled wall "
            f"({100 * dev_us / 1e6 / wall:.2f}% busy)")


def _breakdown(torch, runner, name, sql) -> None:
    """Where a warm query's time goes: the wall of its table scans alone,
    with the scan cache cleared (host generation + copy to the card) and
    as a warm replay of the cached splits, and the card's busy time over a
    warm run."""
    from presto_tpu_torch.exec.local import _Executor
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.planner.plan import TableScanNode
    plan = runner.plan(sql)
    scans, stack = [], [plan.root]
    while stack:
        node = stack.pop()
        if isinstance(node, TableScanNode):
            scans.append(node)
        stack.extend(node.children)

    def scans_alone() -> float:
        ex = _Executor(runner.session, runner.rows_per_batch, runner.device)
        t0 = time.perf_counter()
        for node in scans:
            for _ in ex.run(node):
                pass
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    CACHE.clear()
    cold_s = scans_alone()
    warm_s = scans_alone()
    runner.execute(sql)           # the query's own splits are resident
    busy = _card_busy(torch, lambda: runner.execute(sql))
    print(f"{name} breakdown: scans alone {cold_s:.3f} s (cache cleared), "
          f"{warm_s:.3f} s warm replay; card busy (warm run) {busy}",
          flush=True)


def phase_tpch(torch):
    """The 19 TPC-H queries the path phase does not run, at SF1 on the
    card, each against the port's CPU run."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.expr import functions
    from presto_tpu_torch.ops import probe, scan
    queries = {n: sql for n, sql in _queries().items()
               if n not in PATH_QUERIES}
    gpu = LocalRunner(tpch_sf=1, rows_per_batch=ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=1, device="cpu", rows_per_batch=ROWS_PER_BATCH)
    # host seconds inside LIKE (its regex runs over each batch's
    # vocabulary on the host); the wrapper syncs so the time is whole
    like, like_s = functions._REGISTRY["like"], [0.0]

    def timed_like(args, out):
        t0 = time.perf_counter()
        res = like(args, out)
        torch.cuda.synchronize()
        like_s[0] += time.perf_counter() - t0
        return res
    functions._REGISTRY["like"] = timed_like
    walls, cpu_rows = {}, {}
    scan.launches = 0
    probe.launches = 0
    try:
        for name, sql in queries.items():
            before = (scan.launches, probe.launches)
            like_s[0] = 0.0
            CACHE.clear()               # cold: no split of another query
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = gpu.execute(sql)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            LOCAL_COLD_WALLS[name] = walls[name]
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            counts = (scan.launches - before[0], probe.launches - before[1])
            t0 = time.perf_counter()
            ref = cpu.execute(sql)
            cpu_s = time.perf_counter() - t0
            cpu_rows[name] = ref.rows
            _same_rows(res.rows, ref.rows, 1e-9)
            if not res.rows:
                print(f"{name}: no rows on cuda, none on cpu either",
                      flush=True)
            print(f"{name}: cuda cold {walls[name]:.3f} s | cpu "
                  f"{cpu_s:.3f} s | {len(res.rows)} rows match the cpu run "
                  f"| like {like_s[0]:.3f} s | peak {peak_gb:.2f} GiB | "
                  f"launches scan {counts[0]} probe {counts[1]}", flush=True)
    finally:
        functions._REGISTRY["like"] = like
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"tpch launches: {json.dumps(launches)}", flush=True)
    if launches["direct_probe"] <= 0:
        raise AssertionError("the probe kernel never launched in the phase")
    slowest = max(walls, key=walls.get)
    print(f"slowest on cuda: {slowest} ({walls[slowest]:.3f} s cold)",
          flush=True)
    _breakdown(torch, gpu, slowest, queries[slowest])
    return launches, cpu_rows


def _tests_on_path() -> None:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


def _queries():
    """Every TPC-H query as the test suite carries them, in its order."""
    _tests_on_path()
    from tpch_queries import Q
    return {n: sql for n, sql, _ in Q}


def _tpcds_queries():
    """q27, then the TPC-DS battery as the test suite carries it."""
    _tests_on_path()
    from tpcds_queries import Q
    return {"q27": TPCDS_Q27, **{n: sql for n, sql, _ in Q}}


def phase_tpcds(torch):
    """q27 and the TPC-DS battery at TPCDS_SF on the card, each against the
    port's CPU run; then the CPU rows of q55 and q27 at SF10, which the
    scan phase's cold and warm runs on the card (and the chains phase's
    q27) are held to. Returns the launches, the SF10 CPU rows and the
    battery's CPU rows."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.ops import probe, scan
    queries = _tpcds_queries()

    def runners(sf):
        return (LocalRunner(tpch_sf=sf, catalog="tpcds",
                            rows_per_batch=ROWS_PER_BATCH),
                LocalRunner(tpch_sf=sf, catalog="tpcds", device="cpu",
                            rows_per_batch=ROWS_PER_BATCH))

    def on_card(runner, sql, cold=True):
        if cold:
            CACHE.clear()
        before = (scan.launches, probe.launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = runner.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (res, wall, torch.cuda.max_memory_allocated() / 2**30,
                (scan.launches - before[0], probe.launches - before[1]))

    def on_cpu(runner, sql):
        t0 = time.perf_counter()
        res = runner.execute(sql)
        return res, time.perf_counter() - t0

    scan.launches = 0
    probe.launches = 0
    gpu, cpu = runners(TPCDS_SF)
    walls, battery_rows = {}, {}
    for name, sql in queries.items():
        res, walls[name], peak_gb, counts = on_card(gpu, sql)
        ref, cpu_s = on_cpu(cpu, sql)
        battery_rows[name] = ref.rows
        _same_rows(res.rows, ref.rows, 1e-9)
        if not res.rows:
            print(f"tpcds {name}: no rows on cuda, none on cpu either",
                  flush=True)
        print(f"tpcds sf{TPCDS_SF} {name}: cuda cold {walls[name]:.3f} s | "
              f"cpu {cpu_s:.3f} s | {len(res.rows)} rows match the cpu run "
              f"| peak {peak_gb:.2f} GiB | launches scan {counts[0]} probe "
              f"{counts[1]}", flush=True)
    slowest = max(walls, key=walls.get)
    print(f"tpcds slowest on cuda: {slowest} ({walls[slowest]:.3f} s cold)",
          flush=True)
    _breakdown(torch, gpu, slowest, queries[slowest])
    del gpu, cpu
    # the card's runs of q55 and q27 at SF10, cold and warm, are the scan
    # phase's (they ran here too up to PR 14: the same queries, scale and
    # reference rows, cut to keep the whole script inside its limit)
    cpu = LocalRunner(tpch_sf=TPCDS_BIG_SF, catalog="tpcds", device="cpu",
                      rows_per_batch=ROWS_PER_BATCH)
    cpu_rows = {}
    for name in ("q55", "q27"):
        ref, cpu_s = on_cpu(cpu, queries[name])
        cpu_rows[name] = ref.rows
        if not ref.rows:
            raise AssertionError(f"{name} at SF{TPCDS_BIG_SF} has no rows")
        print(f"tpcds sf{TPCDS_BIG_SF} {name}: cpu {cpu_s:.3f} s, "
              f"{len(ref.rows)} rows (the scan phase's reference)",
              flush=True)
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"tpcds launches: {json.dumps(launches)}", flush=True)
    if launches["direct_probe"] <= 0:
        raise AssertionError("the probe kernel never launched in the phase")
    return launches, cpu_rows, battery_rows


def phase_scan(torch, tpch_cpu_rows, tpcds_cpu_rows):
    """The scan cache and the prefetching pipeline at full scale: cold and
    warm runs, prefetch off, the write path; every result against the
    port's CPU run."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.ops import probe, scan
    card = torch.device("cuda")
    inserts = REGISTRY.counter("scan_cache_insert_total")
    tpch = _queries()
    tpcds = _tpcds_queries()
    gpu_h = LocalRunner(tpch_sf=1, rows_per_batch=ROWS_PER_BATCH)
    cpu_h = LocalRunner(tpch_sf=1, device="cpu",
                        rows_per_batch=ROWS_PER_BATCH)
    gpu_ds = LocalRunner(tpch_sf=TPCDS_BIG_SF, catalog="tpcds",
                         rows_per_batch=ROWS_PER_BATCH)

    def run(runner, sql, label, properties=None):
        """One run on the card, with its scan-cache line."""
        i0 = inserts.value
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = runner.execute(sql, properties=properties)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = runner.last_stats
        print(f"scan {label}: wall {wall:.3f} s | hits {st.cache_hits} "
              f"misses {st.cache_misses} inserts {int(inserts.value - i0)} "
              f"| resident {CACHE.resident_bytes(card) / 2**30:.3f} GiB | "
              f"prefetch stall {st.prefetch_stall_s:.3f} s | peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        return res, st, wall

    scan.launches = 0
    probe.launches = 0
    CACHE.clear()
    cases = [(gpu_h, "q1", tpch["q1"], tpch_cpu_rows["q1"]),
             (gpu_h, "q3", tpch["q3"], tpch_cpu_rows["q3"]),
             (gpu_ds, "q55", tpcds["q55"], tpcds_cpu_rows["q55"]),
             (gpu_ds, "q27", tpcds["q27"], tpcds_cpu_rows["q27"])]
    warm_hits = {}
    for runner, name, sql, ref_rows in cases:
        sf = 1 if runner is gpu_h else TPCDS_BIG_SF
        cold, _, _ = run(runner, sql, f"sf{sf} {name} cold")
        warm, st, _ = run(runner, sql, f"sf{sf} {name} warm")
        warm_hits[name] = st.cache_hits
        busy = _card_busy(torch, lambda: runner.execute(sql))
        _same_rows(cold.rows, ref_rows, 1e-9)
        _same_rows(warm.rows, ref_rows, 1e-9)
        print(f"scan sf{sf} {name}: {len(ref_rows)} rows match the cpu run "
              f"cold and warm; card busy (warm run) {busy}", flush=True)
    if warm_hits["q55"] <= 0:
        raise AssertionError("the warm q55 hit no split of the scan cache")
    CACHE.clear()
    off, _, _ = run(gpu_ds, tpcds["q55"], f"sf{TPCDS_BIG_SF} q55 cold, "
                    "scan_prefetch=false", properties={"scan_prefetch": False})
    _same_rows(off.rows, tpcds_cpu_rows["q55"], 1e-9)
    CACHE.clear()
    run(gpu_ds, tpcds["q55"], f"sf{TPCDS_BIG_SF} q55 cold, prefetch on "
        "(again)")
    del gpu_ds

    # the write path: CTAS, warm read, INSERT, read that must miss
    table = "memory.default.t"
    ctas = (f"create table {table} as select l_orderkey, l_partkey, "
            "l_quantity, l_extendedprice, l_discount, l_shipdate "
            "from lineitem")
    insert = (f"insert into {table} select l_orderkey, l_partkey, "
              "l_quantity, l_extendedprice, l_discount, l_shipdate "
              "from lineitem where l_quantity < 5")
    read = (f"select count(*), sum(l_quantity), sum(l_extendedprice), "
            f"min(l_shipdate), max(l_orderkey) from {table}")
    for runner in (gpu_h, cpu_h):
        runner.execute(f"drop table if exists {table}")
    steps = [("ctas", ctas), ("read cold", read), ("read warm", read),
             ("insert", insert), ("read after insert", read)]
    stored = {}
    for step, sql in steps:
        got, st, _ = run(gpu_h, sql, f"write path {step}")
        stored[step] = list(gpu_h.session.catalogs.get("memory").tables["t"])
        want = cpu_h.execute(sql).rows
        _same_rows(got.rows, want, 1e-9)
        print(f"scan write path {step}: {got.rows} match the cpu run",
              flush=True)
        if step == "read warm" and st.cache_hits != 1:
            raise AssertionError("the warm read of the table did not hit")
        if step == "read after insert" and (st.cache_misses != 1
                                            or st.cache_hits):
            raise AssertionError("the read after INSERT did not miss")
    after = stored["insert"]
    if len(after) <= len(stored["ctas"]) or any(
            b.device.type != "cuda" for b in after):
        raise AssertionError("the INSERT's batches are not on the card")
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"scan launches: {json.dumps(launches)}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the scan phase")
    return launches


def phase_surface(torch):
    """The SQL surface of the port's later slices at SURFACE_SF: each
    statement of SURFACE_QUERIES on the card, cold then warm, against the
    port's CPU run."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.ops import probe, scan
    gpu = LocalRunner(tpch_sf=SURFACE_SF, rows_per_batch=ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=SURFACE_SF, device="cpu",
                      rows_per_batch=ROWS_PER_BATCH)
    scan.launches = 0
    probe.launches = 0
    CACHE.clear()
    t_phase = time.perf_counter()
    for name, sql in SURFACE_QUERIES:
        before = (scan.launches, probe.launches)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        CACHE.clear()
        for _ in range(2):              # cold, then warm
            t0 = time.perf_counter()
            res = gpu.execute(sql)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = (scan.launches - before[0], probe.launches - before[1])
        t0 = time.perf_counter()
        ref = cpu.execute(sql)
        cpu_s = time.perf_counter() - t0
        if not ref.rows:
            raise AssertionError(f"surface {name} has no rows")
        _same_rows(res.rows, ref.rows, 1e-9)
        print(f"surface {name}: cuda cold {walls[0]:.3f} s warm "
              f"{walls[1]:.3f} s | cpu {cpu_s:.3f} s | {len(res.rows)} rows "
              f"match the cpu run | peak {peak_gb:.2f} GiB | launches "
              f"(cold+warm) scan {counts[0]} probe {counts[1]}", flush=True)
    _surface_checked(gpu, cpu, torch.cuda.synchronize)
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"surface launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the surface phase")
    return launches


def _error_name(runner, sql: str):
    """(rows, type displays, None), or (None, None, the QueryError's
    name), of one statement."""
    from presto_tpu_torch.errors import QueryError
    try:
        res = runner.execute(sql)
    except QueryError as e:
        return None, None, e.name
    return res.rows, [t.display() for t in res.types], None


def _surface_checked(gpu, cpu, sync, counter: str = "launches",
                     statements=SURFACE_CHECKED) -> None:
    """``statements`` and the near-edge sum on the card (``gpu``)
    against the CPU run: the same error names, or the same rows and,
    where a statement lists them, the expected types on both; the
    sort-path sums call the segment sum (``scan.<counter>`` rises:
    launches on the card, plain_calls in a CPU rehearsal)."""
    from presto_tpu_torch.ops import scan
    i64_max = (1 << 63) - 1
    keys = dict(cpu.execute(SURFACE_EDGE_KEYS).rows)
    factor = i64_max // max(int(v) for v in keys.values())
    edge = ("sum_near_edge", SURFACE_EDGE_SUM.format(factor=factor), None,
            None)
    for name, sql, want, types in tuple(statements) + (edge,):
        before = getattr(scan, counter)
        t0 = time.perf_counter()
        rows, got_types, err = _error_name(gpu, sql)
        sync()
        wall = time.perf_counter() - t0
        launched = getattr(scan, counter) - before
        t0 = time.perf_counter()
        cpu_rows, cpu_types, cpu_err = _error_name(cpu, sql)
        cpu_s = time.perf_counter() - t0
        if err != want or cpu_err != want:
            raise AssertionError(
                f"surface {name}: cuda raised {err}, cpu raised {cpu_err}, "
                f"expected {want}")
        if types is not None and (got_types != types or cpu_types != types):
            raise AssertionError(
                f"surface {name}: types {got_types} (cuda), {cpu_types} "
                f"(cpu), expected {types}")
        if want is None:
            _same_rows(rows, cpu_rows, 0.0, name)
        if name.startswith("sum_") and launched <= 0:
            raise AssertionError(
                f"surface {name} did not launch the segment sum")
        if name == "sum_near_edge":
            exact = sorted((k, int(v) * factor) for k, v in keys.items())
            if [(int(k), int(v)) for k, v in rows] != exact:
                raise AssertionError("surface sum_near_edge is not exact")
        if name == "decimal_division":
            top = int(rows[0][0]) * 100000000000
            if int(rows[0][1]) != (top + 1) // 3:
                raise AssertionError("surface decimal_division is not exact")
        if name == "substr_negative" and rows[0][1] != "RIA":
            raise AssertionError(f"surface substr gave {rows[0][1]!r}")
        print(f"surface {name}: cuda {wall:.3f} s | cpu {cpu_s:.3f} s | "
              + (f"both raise {err}" if want else
                 f"{len(rows)} rows match the cpu run")
              + (f" | types {', '.join(types)}" if types else "")
              + f" | scan {counter} {launched}", flush=True)


def write_tpch_files(root: str, sf: float) -> str:
    """TPC-H ``sf`` written with the port's writers under ``root``:
    ``orc/{lineitem,orders,customer}`` and ``parquet/lineitem`` (the
    PARQUET_COLUMNS). Returns a line of seconds and sizes."""
    from presto_tpu_torch.connectors.spi import TableHandle
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.formats.orc_writer import write_orc
    from presto_tpu_torch.formats.parquet import write_parquet_batches
    tp = TpchConnector(sf=sf)
    out = []

    def batches(split, cols):
        return tp.page_source(split, list(cols), rows_per_batch=1 << 20,
                              device="cpu").batches()

    def size(d):
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))

    for table, files in (("lineitem", ORC_LINEITEM_FILES), ("orders", 1),
                         ("customer", 1)):
        th = TableHandle("tpch", "default", table)
        schema = tp.metadata.table_schema(th)
        d = os.path.join(root, "orc", table)
        os.makedirs(d)
        t0 = time.perf_counter()
        rows = 0
        for i, split in enumerate(tp.split_manager.splits(th, files)):
            rows += write_orc(os.path.join(d, f"part{i}.orc"), schema,
                              batches(split, schema.names))
        out.append(f"orc {table} {rows} rows {size(d) / 2**20:.1f} MiB "
                   f"{time.perf_counter() - t0:.3f} s")
    th = TableHandle("tpch", "default", "lineitem")
    schema = tp.metadata.table_schema(th).select(PARQUET_COLUMNS)
    d = os.path.join(root, "parquet", "lineitem")
    os.makedirs(d)
    t0 = time.perf_counter()
    rows = 0
    for i, split in enumerate(tp.split_manager.splits(th, PARQUET_FILES)):
        rows += write_parquet_batches(os.path.join(d, f"part{i}.parquet"),
                                      schema, batches(split, schema.names))
    out.append(f"parquet lineitem {rows} rows {size(d) / 2**20:.1f} MiB "
               f"{time.perf_counter() - t0:.3f} s")
    return " | ".join(out)


def _decode_breakdown(torch, root: str) -> None:
    """Each of Q1's columns decoded alone, on one thread, from the first
    ORC lineitem file (per stripe) and the first Parquet file (per row
    group): where a cold file scan's host time goes."""
    from presto_tpu_torch.formats.orc import OrcReader
    from presto_tpu_torch.formats.parquet import ParquetReader
    dev = torch.device("cuda")
    orc = OrcReader(os.path.join(root, "orc", "lineitem", "part0.orc"))
    pq = ParquetReader(os.path.join(root, "parquet", "lineitem",
                                    "part0.parquet"))
    out = []
    for kind, reader, units in (("orc", orc, len(orc.tail.stripes)),
                                ("parquet", pq, len(pq.row_groups))):
        for col in PARQUET_COLUMNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in reader.batches([col], device=dev):
                pass
            torch.cuda.synchronize()
            out.append(f"{kind} {col} "
                       f"{(time.perf_counter() - t0) / units * 1e3:.2f}")
    print(f"files decode breakdown (ms a stripe / a row group, one "
          f"thread): {' | '.join(out)}", flush=True)


def _file_counters():
    from presto_tpu_torch.formats import decodestats as ds
    from presto_tpu_torch.ops import probe, scan
    return {"stripes read": ds.ORC_STRIPES_READ,
            "stripes pruned": ds.ORC_STRIPES_PRUNED,
            "orc files pruned": ds.ORC_FILES_PRUNED,
            "row groups read": ds.PARQUET_GROUPS_READ,
            "row groups pruned": ds.PARQUET_GROUPS_PRUNED,
            "host decode s": ds.HOST_SECONDS,
            "wide host decodes": ds.WIDE_HOST_DECODES}, (scan, probe)


def phase_files(torch):
    """BASELINE config 5 and the file catalogs on the card: TPC-H at
    FILES_SF written as ORC and Parquet by the port's writers, Q6, Q1 and Q3 over
    ORC and Q6 and Q1 over Parquet (scan cache off, then cold and warm)
    against the TPC-H catalog's CPU rows, the config-5 scan-filter-project
    that must prune stripes, EXPLAIN ANALYZE of ORC Q3 and Q6, and the
    profiler against torch.profiler's busy time over a warm ORC Q3.
    Returns the launches of the phase."""
    import tempfile

    from presto_tpu_torch.connectors.orc import OrcConnector
    from presto_tpu_torch.connectors.parquet import ParquetConnector
    from presto_tpu_torch.connectors.spi import CatalogManager
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.formats.decodestats import EXPANSION
    from torch.profiler import ProfilerActivity, profile
    queries = _queries()
    counters, (scan, probe) = _file_counters()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="files_")
    try:
        print(f"files write: {write_tpch_files(root, FILES_SF)}",
              flush=True)
        _decode_breakdown(torch, root)
        cpu = LocalRunner(tpch_sf=FILES_SF, device="cpu",
                          rows_per_batch=ROWS_PER_BATCH)
        tpch_cpu_rows = {n: cpu.execute(queries[n]).rows
                         for n in PATH_QUERIES}
        runners = {}
        for kind, conn in (("orc", OrcConnector), ("parquet",
                                                   ParquetConnector)):
            cm = CatalogManager()
            cm.register(kind, conn(os.path.join(root, kind)))
            runners[kind] = LocalRunner(catalogs=cm, catalog=kind)
        scan.launches = 0
        probe.launches = 0

        def run(kind, name, sql, label, properties=None):
            before = {k: c.value for k, c in counters.items()}
            launched = (scan.launches, probe.launches)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = runners[kind].execute(sql, properties=properties)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            delta = {k: c.value - before[k] for k, c in counters.items()}
            print(f"files {kind} {name} {label}: wall {wall:.3f} s | "
                  f"{int(delta['stripes read'])} stripes read "
                  f"{int(delta['stripes pruned'])} pruned, "
                  f"{int(delta['row groups read'])} row groups read "
                  f"{int(delta['row groups pruned'])} pruned | host decode "
                  f"{delta['host decode s']:.3f} s | peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
                  f"widths over 56 on the host "
                  f"{int(delta['wide host decodes'])} | launches scan "
                  f"{scan.launches - launched[0]} probe "
                  f"{probe.launches - launched[1]}", flush=True)
            return res, wall, delta

        def expansion_seconds(kind, sql):
            """Device busy seconds of the expansions of one scan with the
            cache off: the kernels under the EXPANSION ranges in a
            torch.profiler trace. Splits and join probe sides run inline,
            on the thread the profiler follows (it records no other)."""
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = runners[kind].execute(sql, properties={
                    "scan_cache": False, "scan_prefetch": False,
                    "probe_prefetch": False})
                torch.cuda.synchronize()
            ranges = [e for e in prof.events() if e.name == EXPANSION]
            return (res, len(ranges),
                    sum(e.device_time_total for e in ranges) / 1e6)

        for kind, names in (("orc", PATH_QUERIES), ("parquet", ("q6",
                                                                "q1"))):
            for name in names:
                CACHE.clear()
                for label, props in (("scan_cache=false",
                                      {"scan_cache": False}),
                                     ("cold", None), ("warm", None)):
                    res, _, delta = run(kind, name, queries[name], label,
                                        props)
                    _same_rows(res.rows, tpch_cpu_rows[name], 1e-9)
                    if label == "scan_cache=false":
                        host_s = delta["host decode s"]
                print(f"files {kind} {name}: {len(res.rows)} rows match the "
                      "TPC-H cpu run (scan cache off, cold and warm)",
                      flush=True)
                res, n_ranges, dev_s = expansion_seconds(kind,
                                                         queries[name])
                _same_rows(res.rows, tpch_cpu_rows[name], 1e-9)
                print(f"files {kind} {name} decode: host decode "
                      f"{host_s:.3f} s (scan_cache=false run) vs "
                      f"expansion kernels {dev_s:.6f} s over {n_ranges} "
                      "expansions (torch.profiler, scan_cache=false, "
                      "splits and probe sides inline)", flush=True)
                # every ORC integer column expands on the device; Parquet's
                # PLAIN pages (Q6 reads only those) have nothing to expand
                if kind == "orc" and n_ranges == 0:
                    raise AssertionError(f"no expansion range in the "
                                         f"{kind} {name} trace")

        # BASELINE config 5: scan-filter-project returning rows
        res, wall, delta = run("orc", "config5", CONFIG5_SQL,
                               "scan_cache=false", {"scan_cache": False})
        want = LocalRunner(tpch_sf=FILES_SF, device="cpu",
                           rows_per_batch=ROWS_PER_BATCH).execute(
            CONFIG5_SQL).rows
        _same_rows(sorted(res.rows), sorted(want), 1e-9)
        print(f"files orc config5: {len(res.rows)} rows match the TPC-H cpu "
              f"run; {int(delta['stripes pruned'])} stripes pruned "
              f"({int(delta['orc files pruned'])} whole files), "
              f"{int(delta['stripes read'])} read", flush=True)
        if not res.rows or delta["stripes pruned"] <= 0:
            raise AssertionError("the config-5 range pruned no stripe")

        for name in ("q3", "q6"):
            # the decode path is the question: is the file scan input-bound?
            text = [r[0] for r in runners["orc"].execute(
                "explain analyze " + queries[name],
                properties={"scan_cache": False}).rows]
            for line in text:
                if ("[device " in line or line.startswith(
                        ("Kernels", "  segment_sum", "  direct_probe",
                         "Verdict:", "Total:"))):
                    print(f"files explain {name}: {line.strip()}",
                          flush=True)
            if not any(line.startswith("Verdict: ") for line in text):
                raise AssertionError(f"EXPLAIN ANALYZE of {name} printed "
                                     "no Verdict line")

        # the profiler against torch.profiler over the same warm Q3
        gpu = runners["orc"]
        gpu.execute(queries["q3"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gpu.execute(queries["q3"], properties={"profile": True})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        ops = sum(st.device_time_s
                  for st in gpu.last_stats.by_node.values())
        print(f"files profiler q3 warm: per-operator device "
              f"{ops * 1e3:.3f} ms | torch.profiler busy "
              f"{busy * 1e3:.3f} ms | wall {wall * 1e3:.3f} ms", flush=True)
        if not busy <= ops <= wall:
            raise AssertionError("the per-operator device seconds lie "
                                 "outside [busy, wall]")
        from presto_tpu_torch.obs import profiler
        print(f"files hbm: {json.dumps(profiler.hbm_totals())} | kernel "
              f"records: {json.dumps(profiler.KERNELS.snapshot())}",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"files launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the files phase")
    return launches


def _launch_counts():
    from presto_tpu_torch.ops import probe, scan
    return {"segment_sum_sorted_i64": scan.launches,
            "direct_probe": probe.launches}


def _reset_launches() -> None:
    from presto_tpu_torch.ops import probe, scan
    scan.launches = 0
    probe.launches = 0


def phase_chains(torch, tpch_cpu_rows=None, q27_cpu_rows=None):
    """The fused join chains: the TPC-H queries the reference fuses at
    SF1 and q27 at SF10, each with fused_pipeline on and off, cold and
    warm, against each other and the CPU rows of the earlier phases.
    Returns the launches of the phase."""
    from presto_tpu_torch.exec import fused
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.ops import probe
    queries = _queries()
    counters = {k: REGISTRY.counter(f"fused_{k}_total")
                for k in ("source_lanes", "tail_lanes",
                          "liveness_readbacks")}
    # probe launches inside fused tails: the tail's direct-address join
    # stages call exec/fused.lookup_join_direct
    in_tail = {"calls": 0, "launches": 0}
    orig = fused.lookup_join_direct

    def counted(*args, **kwargs):
        before = probe.launches
        out = orig(*args, **kwargs)
        in_tail["calls"] += 1
        in_tail["launches"] += probe.launches - before
        return out

    def run(runner, label, sql, fused_on, cold):
        if cold:
            CACHE.clear()
        before = {k: c.value for k, c in counters.items()}
        launched = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = runner.execute(sql, properties={"fused_pipeline": fused_on})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k: int(c.value - before[k]) for k, c in counters.items()}
        now = _launch_counts()
        print(f"chains {label} fused={'on' if fused_on else 'off'} "
              f"{'cold' if cold else 'warm'}: wall {wall:.3f} s | lanes "
              f"source {delta['source_lanes']} tail {delta['tail_lanes']} "
              f"| readbacks {delta['liveness_readbacks']} | launches probe "
              f"{now['direct_probe'] - launched['direct_probe']} scan "
              f"{now['segment_sum_sorted_i64'] - launched['segment_sum_sorted_i64']}"
              f" | peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        return res, delta

    def one(runner, label, sql, ref_rows):
        """On cold, on warm, off cold, off warm (cold: the scan cache
        cleared first)."""
        out = {}
        for fused_on, cold in ((True, True), (True, False), (False, True),
                               (False, False)):
            res, delta = run(runner, label, sql, fused_on, cold)
            _same_rows(res.rows, ref_rows, 1e-9)
            if fused_on and delta["source_lanes"] <= 0:
                raise AssertionError(f"{label} took no fused chain")
            if not fused_on and delta["source_lanes"]:
                raise AssertionError(f"{label} fused with the chain off")
            out[(fused_on, cold)] = (res, delta)
        on, off = out[(True, False)][0], out[(False, False)][0]
        _same_rows(on.rows, off.rows, 1e-9)
        print(f"chains {label}: {len(ref_rows)} rows, on and off cold and "
              "warm, match the cpu run and each other", flush=True)
        return out[(True, True)][1]

    t_phase = time.perf_counter()
    gpu = LocalRunner(tpch_sf=1, rows_per_batch=ROWS_PER_BATCH)
    if tpch_cpu_rows is None:
        cpu = LocalRunner(tpch_sf=1, device="cpu",
                          rows_per_batch=ROWS_PER_BATCH)
        tpch_cpu_rows = {n: cpu.execute(queries[n]).rows
                         for n in CHAIN_QUERIES}
        del cpu
    ds = _tpcds_queries()
    if q27_cpu_rows is None:
        q27_cpu_rows = LocalRunner(
            tpch_sf=TPCDS_BIG_SF, catalog="tpcds", device="cpu",
            rows_per_batch=ROWS_PER_BATCH).execute(ds["q27"]).rows
    _reset_launches()
    fused.lookup_join_direct = counted
    try:
        for name in CHAIN_QUERIES:
            one(gpu, f"sf1 {name}", queries[name], tpch_cpu_rows[name])
        del gpu
        big = LocalRunner(tpch_sf=TPCDS_BIG_SF, catalog="tpcds",
                          rows_per_batch=ROWS_PER_BATCH)
        delta = one(big, f"sf{TPCDS_BIG_SF} q27", ds["q27"], q27_cpu_rows)
    finally:
        fused.lookup_join_direct = orig
    launches = _launch_counts()
    print(f"chains launches: {json.dumps(launches)} | probe in fused "
          f"tails: {in_tail['calls']} calls, {in_tail['launches']} launches "
          f"| phase wall {time.perf_counter() - t_phase:.3f} s", flush=True)
    if not delta["tail_lanes"] * 2 < delta["source_lanes"]:
        raise AssertionError(f"q27 SF{TPCDS_BIG_SF}: tail lanes "
                             f"{delta['tail_lanes']} not below half the "
                             f"source lanes {delta['source_lanes']}")
    if in_tail["launches"] <= 0:
        raise AssertionError("the probe never launched in a fused tail")
    return launches


def phase_spill(torch):
    """Memory-bounded queries: SPILL_QUERIES at SF1 unbudgeted, with a
    quarter of that run's pool peak as query_max_memory, and (the join
    and the ORDER BY) with the disk tier; every run against the
    unbudgeted one, which runs against the CPU. Returns the launches."""
    import tempfile

    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.obs.metrics import REGISTRY
    base = {"dense_grouping": False}
    gpu = LocalRunner(tpch_sf=1, rows_per_batch=SPILL_ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=1, device="cpu",
                      rows_per_batch=SPILL_ROWS_PER_BATCH)
    host_staged = REGISTRY.counter("spill_host_staged_bytes_total")
    t_phase = time.perf_counter()
    _reset_launches()

    def run(label, sql, props):
        launched = _launch_counts()
        staged0 = host_staged.value
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = gpu.execute(sql, properties=props)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = gpu.session.last_memory_stats
        now = _launch_counts()
        print(f"spill {label}: wall {wall:.3f} s | pool peak "
              f"{st.peak_bytes} B | max allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
              f"spilled {st.spilled_bytes} B, host staged "
              f"{int(host_staged.value - staged0)} B, disk "
              f"{st.disk_spilled_bytes} B, revocations {st.revocations} | "
              f"launches scan "
              f"{now['segment_sum_sorted_i64'] - launched['segment_sum_sorted_i64']}"
              f" probe {now['direct_probe'] - launched['direct_probe']}",
              flush=True)
        return res, st

    for i, sql in enumerate(SPILL_QUERIES):
        # budgeted runs replay the warm splits: hold them against the
        # unbudgeted warm run
        CACHE.clear()
        run(f"q{i} unbudgeted cold", sql, base)
        free, st = run(f"q{i} unbudgeted warm", sql, base)
        t0 = time.perf_counter()
        ref = cpu.execute(sql, properties=base)
        cpu_s = time.perf_counter() - t0
        _same_rows(free.rows, ref.rows, 1e-9)
        if st.spilled_bytes:
            raise AssertionError(f"q{i} spilled without a budget")
        budget = st.peak_bytes // 4
        cases = [("budget", {"query_max_memory": budget})]
        if i in SPILL_DISK_QUERIES:
            cases.append(("budget+disk", {
                "query_max_memory": budget,
                "spill_to_disk_bytes": SPILL_DISK_BYTES}))
        for label, props in cases:
            spill_dir = tempfile.mkdtemp(prefix="spill_")
            try:
                if "spill_to_disk_bytes" in props:
                    props = dict(props, spill_path=spill_dir)
                res, bst = run(f"q{i} {label} {budget} B", sql,
                               dict(base, **props))
                left = os.listdir(spill_dir)
            finally:
                shutil.rmtree(spill_dir, ignore_errors=True)
            _same_rows(res.rows, free.rows, 1e-9)
            if bst.peak_bytes > budget:
                raise AssertionError(f"q{i} {label}: pool peak "
                                     f"{bst.peak_bytes} over {budget}")
            if bst.spilled_bytes <= 0:
                raise AssertionError(f"q{i} {label} spilled nothing")
            if "spill_path" in props and (bst.disk_spilled_bytes <= 0
                                          or left):
                raise AssertionError(f"q{i} {label}: {bst.disk_spilled_bytes}"
                                     f" B on disk, left {left}")
        print(f"spill q{i}: {len(ref.rows)} rows; budgeted runs match the "
              f"unbudgeted one, which matches the cpu run ({cpu_s:.3f} s)",
              flush=True)
    launches = _launch_counts()
    print(f"spill launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if launches["segment_sum_sorted_i64"] <= 0:
        raise AssertionError("the segment sum never launched in the phase")
    return launches


#: the statements phase: TPC-H at STATEMENTS_SF on the card; the
#: verifier's 22 queries at VERIFY_SF on the CPU and on the card; the
#: grouped-execution tables partitioned into GROUPED_BUCKETS buckets by
#: orderkey
STATEMENTS_SF = 1
VERIFY_SF = 0.1
GROUPED_BUCKETS = 8
#: Q6 with its five literals as parameters, and the benchmark's values
Q6_PREPARED = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= ?
  and l_shipdate < ? + interval '1' year
  and l_discount between ? - 0.01 and ? + 0.01
  and l_quantity < ?
"""
Q6_USING = "date '1994-01-01', date '1994-01-01', 0.06, 0.06, 24"
#: the orders of each customer by nation: the SQLite catalog's customer
#: against the TPC-H catalog's
SQLITE_JOIN = """
select c_nationkey, count(*) n, sum(o_orderkey) s, max(o_custkey) m
from {customer} join tpch.default.orders on c_custkey = o_custkey
group by c_nationkey order by c_nationkey
"""
#: the co-partitioned join of the grouped-execution check
GROUPED_JOIN = """
select count(*) n, sum(l_quantity) q, sum(o_custkey) c
from li_p join ord_p on l_orderkey = o_orderkey and li_p.b = ord_p.b
"""


def _kernel_calls(device: str):
    """Launches of each kernel on the card; on the CPU (a rehearsal of
    the phase) the calls of each kernel's plain version."""
    if device == "cuda":
        return _launch_counts()
    from presto_tpu_torch.obs.profiler import KERNELS
    return {k["name"]: k["plain_calls"] for k in KERNELS.snapshot()}


def phase_statements(torch, tpch_cpu_rows=None, sf=STATEMENTS_SF,
                     verify_sf=VERIFY_SF, device="cuda"):
    """The runner's statement surface, catalogs, tracer, history and
    local parallelism on the card (``device="cpu"`` rehearses it on the
    CPU at a small ``sf``). Returns the launches of the phase."""
    import collections
    import tempfile

    from presto_tpu_torch.connectors.orc import OrcConnector
    from presto_tpu_torch.connectors.spi import CatalogManager
    from presto_tpu_torch.connectors.sqlite import SqliteConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.obs.trace import TRACER, write_chrome_trace
    from presto_tpu_torch.server.security import AccessDeniedError
    from presto_tpu_torch.verifier import Verifier
    queries = _queries()
    cuda = device == "cuda"
    card = torch.cuda.get_device_name(0) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def calls():
        return _kernel_calls(device)

    def delta(before):
        now = calls()
        return {k: now[k] - before.get(k, 0) for k in now}

    def text(res):
        return "\n".join(r[0] for r in res.rows)

    t_phase = time.perf_counter()
    _reset_launches()
    start = calls()
    gpu = LocalRunner(tpch_sf=sf, device=device,
                      rows_per_batch=ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=sf, device="cpu", rows_per_batch=ROWS_PER_BATCH)
    ran = collections.Counter()

    def run(sql, **kw):
        """One statement on the card runner, counted for the query-log
        check; returns (result, wall seconds)."""
        t0 = time.perf_counter()
        try:
            res = gpu.execute(sql, **kw)
        except Exception:
            ran["FAILED"] += 1
            raise
        sync()
        ran["FINISHED"] += 1
        return res, time.perf_counter() - t0

    if tpch_cpu_rows is None:
        tpch_cpu_rows = {}
    for name in ("q3", "q6", "q1"):
        if name not in tpch_cpu_rows:
            tpch_cpu_rows[name] = cpu.execute(queries[name]).rows

    # -- views and prepared statements
    run("create view q3v as " + queries["q3"])
    res, wall = run("select * from q3v order by revenue desc, o_orderdate, "
                    "l_orderkey")
    _same_rows(res.rows, tpch_cpu_rows["q3"], 1e-9)
    run("prepare q6p from " + Q6_PREPARED)
    res6, wall6 = run(f"execute q6p using {Q6_USING}")
    _same_rows(res6.rows, tpch_cpu_rows["q6"], 1e-9)
    run("prepare q3p from " + queries["q3"])
    out = [r[0] for r in run("describe output q3p")[0].rows]
    if out != ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]:
        raise AssertionError(f"DESCRIBE OUTPUT of Q3: {out}")
    print(f"statements views: Q3 as a view {wall:.3f} s, Q6 prepared "
          f"{wall6:.3f} s, both equal the literal queries' cpu rows; "
          f"DESCRIBE OUTPUT {out}", flush=True)

    # -- transactions over the memory catalog, the scan cache on
    def count(table="memory.default.li"):
        return int(run(f"select count(*) from {table}")[0].rows[0][0])
    CACHE.clear()
    n_ctas = int(run("create table memory.default.li as "
                     "select * from lineitem")[0].rows[0][0])
    n_src = int(cpu.execute("select count(*) from lineitem").rows[0][0])
    warm = [count(), count()]
    if n_ctas != n_src or warm != [n_src, n_src]:
        raise AssertionError(f"CTAS {n_ctas} rows, counts {warm}, "
                             f"lineitem {n_src}")
    late = "select * from lineitem where l_shipdate >= date '1998-01-01'"
    run("start transaction")
    n_ins = int(run("insert into memory.default.li " + late)[0].rows[0][0])
    inside = count()
    run("rollback")
    after_rollback = [count(), count()]
    run("start transaction")
    run("insert into memory.default.li " + late)
    run("commit")
    committed = [count(), count()]
    if not (n_ins > 0 and inside == n_ctas + n_ins
            and after_rollback == [n_ctas] * 2
            and committed == [n_ctas + n_ins] * 2):
        raise AssertionError(
            f"transactions: ctas {n_ctas} insert {n_ins} inside {inside} "
            f"after rollback {after_rollback} committed {committed}")
    run("create table memory.default.t as select 1 a, cast(2 as bigint) b")
    run("insert into memory.default.t (b, a) select 10, 20")
    got = [tuple(int(v) for v in r) for r in
           run("select a, b from memory.default.t order by a")[0].rows]
    if got != [(1, 2), (20, 10)]:
        raise AssertionError(f"INSERT with a column list: {got}")
    print(f"statements transactions: CTAS {n_ctas} rows, INSERT {n_ins} "
          f"rows, count inside {inside}, after ROLLBACK {after_rollback} "
          f"(scan cache on), after COMMIT {committed}; INSERT (b, a) "
          f"stored {got[1]}", flush=True)

    # -- roles: SELECT needs a grant while the role manager enforces
    gpu.roles.enforce = True
    gpu.roles.user_roles["boss"] = {"admin"}
    try:
        try:
            run(queries["q6"], user="carol")
            raise AssertionError("carol read lineitem without a grant")
        except AccessDeniedError as e:
            denied = str(e)
        run("grant select on lineitem to carol", user="boss")
        granted = run(queries["q6"], user="carol")[0]
        _same_rows(granted.rows, tpch_cpu_rows["q6"], 1e-9)
    finally:
        gpu.roles.enforce = False
    print(f"statements roles: before the grant: {denied}; after it carol "
          "gets Q6's rows", flush=True)

    # -- the system catalog
    want = dict(ran)
    res = run("select state, count(*) from system.runtime.queries "
              "group by state order by state")[0]
    states = {r[0]: int(r[1]) for r in res.rows}
    if states != {**want, "RUNNING": 1}:
        raise AssertionError(f"system.runtime.queries {states}, the phase "
                             f"ran {want} and this query")
    run(queries["q3"], properties={"profile": True})
    qid = gpu.query_log[-1].query_id
    rec = run("select state, rows, plan_summary from "
              "system.runtime.completed_queries where query_id = "
              f"'{qid}'")[0].rows
    ops = run("select operator, batches, device_time_s, hbm_bytes from "
              "system.runtime.operator_stats where query_id = "
              f"'{qid}'")[0].rows
    dev_s = sum(float(r[2]) for r in ops)
    if len(rec) != 1 or rec[0][0] != "FINISHED" or not ops or dev_s <= 0:
        raise AssertionError(f"history of {qid}: {rec}, operators {ops}")
    exes = {r[0]: int(r[1]) for r in run(
        "select name, invocations from system.runtime.executables")[0].rows}
    nodes = run("select node_id, uri, hbm_in_use_bytes from "
                "system.runtime.nodes")[0].rows
    if cuda and min(exes.get(k, 0) for k in
                    ("segment_sum_sorted_i64", "direct_probe")) <= 0:
        raise AssertionError(f"system.runtime.executables {exes}")
    if [r[1] for r in nodes] != [card]:
        raise AssertionError(f"system.runtime.nodes {nodes}")
    print(f"statements system: queries {states}; Q3 {qid} {rec[0][2]!r}, "
          f"{len(ops)} operator rows, device {dev_s:.4f} s; executables "
          f"{exes}; nodes {[(r[0], r[1], int(r[2])) for r in nodes]}",
          flush=True)

    # -- SQLite: customer written into a SQLite file, joined on the card
    with tempfile.TemporaryDirectory(prefix="sqlite_") as tmp:
        cat = CatalogManager()
        cat.register("tpch", TpchConnector(sf=sf))
        cat.register("sq", SqliteConnector(os.path.join(tmp, "tpch.db")))
        sq = LocalRunner(catalogs=cat, device=device,
                         rows_per_batch=ROWS_PER_BATCH)
        t0 = time.perf_counter()
        n_cust = int(sq.execute("create table sq.default.customer as "
                                "select * from tpch.default.customer"
                                ).rows[0][0])
        write_s = time.perf_counter() - t0
        before = calls()
        t0 = time.perf_counter()
        got = sq.execute(SQLITE_JOIN.format(customer="sq.default.customer"))
        sync()
        join_s = time.perf_counter() - t0
        d = delta(before)
        ref = sq.execute(SQLITE_JOIN.format(
            customer="tpch.default.customer"))
        _same_rows(got.rows, ref.rows, 0.0)
        if d["direct_probe"] <= 0:
            raise AssertionError(f"the SQLite join launched no probe: {d}")
    print(f"statements sqlite: {n_cust} customers written in {write_s:.3f} "
          f"s; the join {join_s:.3f} s, {len(got.rows)} rows equal the "
          f"TPC-H catalog's; calls {d}", flush=True)

    # -- EXPLAIN's other forms against the CPU runner's text
    for opt in ("format json", "format graphviz", "type io",
                "type validate"):
        sql = f"explain ({opt}) {queries['q3']}"
        if run(sql)[0].rows != cpu.execute(sql).rows:
            raise AssertionError(f"EXPLAIN ({opt}) differs from the cpu's")
    run(queries["q3"])                   # warm the splits for the timings
    walls = {False: [], True: []}
    TRACER.clear()
    try:
        for on in (False, True, True, False, False, True):
            TRACER.enable(on)
            walls[on].append(run(queries["q3"])[1])
        TRACER.enable(True)
        analyzed = text(run("explain analyze " + queries["q3"])[0])
        if "Trace (spans by name):" not in analyzed:
            raise AssertionError("EXPLAIN ANALYZE has no trace section")
        TRACER.clear()
        run(queries["q3"])
        spans = TRACER.export()
    finally:
        TRACER.enable(False)
    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        path = write_chrome_trace(os.path.join(tmp, "q3.json"), spans)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e["ph"] == "X")
    if not {"query", "plan", "device-sync"} <= set(names):
        raise AssertionError(f"Chrome trace spans {dict(names)}")
    trace = analyzed[analyzed.index("Trace (spans by name):"):]
    print("statements explain: JSON, GRAPHVIZ, IO and VALIDATE equal the "
          "cpu runner's; warm Q3 tracer off "
          f"{statistics.median(walls[False]):.4f} s, on "
          f"{statistics.median(walls[True]):.4f} s (medians of 3); "
          f"Chrome trace spans {dict(names)}\n"
          + "\n".join(trace.split("\n")[:12]), flush=True)

    # -- local parallelism: the sort-path partials on 1 and 4 drivers
    for name, sql in (("q1", queries["q1"]), ("l_orderkey",
                                              SPILL_QUERIES[0])):
        rows = {}
        for tc in (1, 4):
            props = {"dense_grouping": False, "task_concurrency": tc}
            run(sql, properties=props)                  # warm the splits
            before = calls()
            res, wall = run(sql, properties=props)
            d = delta(before)
            if d["segment_sum_sorted_i64"] <= 0:
                raise AssertionError(f"{name} task_concurrency={tc}: no "
                                     "segment sum")
            rows[tc] = res.rows
            print(f"statements parallel {name} task_concurrency={tc}: warm "
                  f"{wall:.4f} s | calls {d}", flush=True)
        _same_rows(rows[4], rows[1], 1e-9)

    # -- grouped execution over co-partitioned ORC tables
    with tempfile.TemporaryDirectory(prefix="grouped_") as tmp:
        cat = CatalogManager()
        cat.register("tpch", TpchConnector(sf=sf))
        cat.register("orc", OrcConnector(tmp))
        orc = LocalRunner(catalogs=cat, catalog="orc", device=device,
                          rows_per_batch=ROWS_PER_BATCH)
        t0 = time.perf_counter()
        orc.execute("create table ord_p with (partitioned_by = array['b']) "
                    "as select o_orderkey, o_custkey, o_orderkey % "
                    f"{GROUPED_BUCKETS} b from tpch.default.orders")
        orc.execute("create table li_p with (partitioned_by = array['b']) "
                    "as select l_orderkey, l_quantity, l_orderkey % "
                    f"{GROUPED_BUCKETS} b from tpch.default.lineitem")
        write_s = time.perf_counter() - t0
        out = {}
        for grouped in (True, False):
            before = calls()
            t0 = time.perf_counter()
            res = orc.execute(GROUPED_JOIN,
                              properties={"grouped_execution": grouped})
            sync()
            out[grouped] = (res.rows, time.perf_counter() - t0,
                            orc.session.last_memory_stats.peak_bytes,
                            delta(before))
    _same_rows(out[True][0], out[False][0], 1e-9)
    (_, g_s, g_peak, g_calls), (_, p_s, p_peak, p_calls) = \
        out[True], out[False]
    print(f"statements grouped: ORC written in {write_s:.3f} s; "
          f"{GROUPED_BUCKETS} buckets {g_s:.3f} s, pool peak {g_peak} B, "
          f"calls {g_calls}; whole {p_s:.3f} s, pool peak {p_peak} B, "
          f"calls {p_calls}; rows "
          f"{[tuple(v.item() for v in r) for r in out[True][0]]}",
          flush=True)
    if not g_peak < p_peak:
        raise AssertionError(f"grouped peak {g_peak} not below {p_peak}")
    if g_calls["direct_probe"] <= 0:
        raise AssertionError("no probe in the lifespan buckets")

    # -- the verifier: the 22 TPC-H queries, CPU runner against card runner
    t0 = time.perf_counter()
    results = Verifier(
        LocalRunner(tpch_sf=verify_sf, device="cpu",
                    rows_per_batch=ROWS_PER_BATCH),
        LocalRunner(tpch_sf=verify_sf, device=device,
                    rows_per_batch=ROWS_PER_BATCH),
        rel_tol=1e-9).run(list(queries.values()))
    status = collections.Counter(r.status for r in results)
    print(f"statements verifier SF{verify_sf}: {dict(status)} in "
          f"{time.perf_counter() - t0:.3f} s (control "
          f"{sum(r.control_ms for r in results) / 1e3:.3f} s, test "
          f"{sum(r.test_ms for r in results) / 1e3:.3f} s)", flush=True)
    if status != {"MATCH": len(queries)}:
        raise AssertionError("; ".join(f"{r.status} {r.detail}"
                                       for r in results
                                       if r.status != "MATCH"))
    launches = delta(start)
    print(f"statements launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the phase")
    return launches


def _mesh_rows(rows):
    """Rows sorted by value: the TPC-DS battery's ORDER BYs leave ties
    whose order a mesh does not fix (q73 at SF 0.01 has two), so its
    rows compare as multisets."""
    def key(r):
        return tuple((v is None, type(v).__name__,
                      round(float(v), 6) if isinstance(v, float) else v)
                     for v in (x.item() if hasattr(x, "item") else x
                               for x in r))
    return sorted(rows, key=key)


@contextlib.contextmanager
def _slot_launches(device, per_slot):
    """Adds to ``per_slot[name][i]`` the launches of each kernel made
    while a shard body of slot i runs (the DistributedExecutor enters
    ``_in_slot(i)`` around each slot's body; nested entries count once)."""
    from presto_tpu_torch.exec.distributed import DistributedExecutor
    plain = DistributedExecutor._in_slot
    depth = [0]

    @contextlib.contextmanager
    def in_slot(self, i):
        depth[0] += 1
        before = _kernel_calls(device) if depth[0] == 1 else None
        try:
            with plain(self, i):
                yield
        finally:
            depth[0] -= 1
            if before is not None:
                for k, v in _kernel_calls(device).items():
                    per_slot[k][i] += v - before.get(k, 0)
    DistributedExecutor._in_slot = in_slot
    try:
        yield
    finally:
        DistributedExecutor._in_slot = plain


@contextlib.contextmanager
def _mesh_bytes(acc):
    """Adds to ``acc`` the bytes of the sharded batches the mesh scans
    yield (``scanned``: every round of ``DistributedExecutor._assemble``)
    and the batch data stacked onto the controller device, slot 0's
    (``stacked``, ``stacked_calls``: ``exec/distributed.controller_copy``),
    made inside the block."""
    from presto_tpu_torch.exec import distributed as D
    from presto_tpu_torch.memory import batch_device_bytes
    plain = D.DistributedExecutor._assemble

    def assemble(self, parts, schema):
        out = plain(self, parts, schema)
        acc["scanned"] += batch_device_bytes(out)
        return out
    before = D.copy_counters()
    D.DistributedExecutor._assemble = assemble
    try:
        yield acc
    finally:
        D.DistributedExecutor._assemble = plain
        after = D.copy_counters()
        acc["stacked"] += after["stacked_bytes"] - before["stacked_bytes"]
        acc["stacked_calls"] += (after["stacked_calls"]
                                 - before["stacked_calls"])


def _fair_arbitration(runner, props, sf):
    """The fair scheduler arbitrating a long mesh scan (about 370 output
    batches, one quantum each) and a short one started once the long one
    has climbed to level 1, every quantum held for at least
    FAIR_FLOOR_MS. From the scheduler's ``quantum`` spans it
    requires: no two quanta overlap (the device is granted to one query
    at a time); the long query reached level 1 or above and the short one
    stayed at level 0; each billed at least 2 quanta; the short one
    finished before the long one's last quantum, with at most one long
    quantum between two of its own (the level-0 query wins each grant
    while both wait). Returns (long, short): each query's rows, wall,
    quanta and levels."""
    import threading

    from presto_tpu_torch.exec.taskexec import set_service_floor_ms
    from presto_tpu_torch.obs.trace import TRACER
    was_on, old_rows = TRACER.enabled, runner.rows_per_batch
    runner.rows_per_batch = max(16, int(FAIR_ROWS_PER_BATCH * sf))
    got, errors, walls = {}, [], {}

    def worker(name, sql):
        t0 = time.perf_counter()
        try:
            got[name] = runner.execute(sql, properties=props).rows
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
        walls[name] = time.perf_counter() - t0

    def quanta():
        return sorted((q for q in TRACER.export() if q["name"] == "quantum"),
                      key=lambda q: q["start"])
    TRACER.clear()
    TRACER.enable(True)
    old_floor = set_service_floor_ms(FAIR_FLOOR_MS)
    try:
        long_t = threading.Thread(target=worker, args=("long", FAIR_LONG_SQL))
        long_t.start()
        deadline = time.perf_counter() + 300
        while not any(q["attrs"]["level"] >= 1 for q in quanta()):
            if not long_t.is_alive() or time.perf_counter() > deadline:
                raise AssertionError("the long query never reached level 1 "
                                     "of the fair scheduler")
            time.sleep(0.002)
        short_t = threading.Thread(target=worker,
                                   args=("short", FAIR_SHORT_SQL))
        short_t.start()
        for t in (short_t, long_t):
            t.join(timeout=300)
        if errors or long_t.is_alive() or short_t.is_alive():
            raise AssertionError(f"the fair-scheduling queries failed: "
                                 f"{errors}")
        qs = quanta()
    finally:
        set_service_floor_ms(old_floor)
        TRACER.enable(was_on)
        TRACER.clear()
        runner.rows_per_batch = old_rows
    tasks = list(dict.fromkeys(q["attrs"]["task"] for q in qs))
    if len(tasks) != 2:
        raise AssertionError(f"expected the quanta of 2 queries, got "
                             f"{len(tasks)}")
    long_q = [q for q in qs if q["attrs"]["task"] == tasks[0]]
    short_q = [q for q in qs if q["attrs"]["task"] == tasks[1]]
    for a, b in zip(qs, qs[1:]):
        if b["start"] < a["end"]:
            raise AssertionError("two quanta held the device at once")
    if len(long_q) < 2 or len(short_q) < 2:
        raise AssertionError(f"quanta billed: long {len(long_q)}, short "
                             f"{len(short_q)}; each needs 2")
    if max(q["attrs"]["level"] for q in long_q) < 1 \
            or max(q["attrs"]["level"] for q in short_q) != 0:
        raise AssertionError("the levels did not separate the queries")
    if short_q[-1]["end"] > long_q[-1]["start"]:
        raise AssertionError("the short query waited for the long one")
    between = sum(short_q[0]["start"] <= q["start"] <= short_q[-1]["end"]
                  for q in long_q)
    if between > len(short_q) - 1:
        raise AssertionError(f"{between} long quanta ran among the short "
                             f"query's {len(short_q)}")
    return tuple({"rows": got[n], "wall": walls[n], "quanta": len(q),
                  "levels": sorted({x["attrs"]["level"] for x in q}),
                  "between": between}
                 for n, q in (("long", long_q), ("short", short_q)))


def phase_mesh(torch, tpch_cpu_rows=None, tpcds_cpu_rows=None,
               device="cuda", sf=MESH_SF, big_sf=MESH_BIG_SF,
               ds_sf=TPCDS_SF):
    """SPMD execution on one card seen as MESH_SLOTS mesh slots: the 22
    TPC-H queries, BASELINE config 3's Q3 at ``big_sf`` cold and warm
    against the card's single-device run, the TPC-DS battery, EXPLAIN
    (TYPE DISTRIBUTED) and EXPLAIN ANALYZE of Q3, system.runtime.
    mesh_rounds, an armed mesh.repartition failpoint, two concurrent
    queries under the fair scheduler and its arbitration of a long and a
    short scan. Reference rows not given are the card's single-device
    run's (``device="cpu"`` rehearses the phase on the CPU at small
    scale factors). Launches count in the mesh runs only (the
    single-device reference runs and config 3's ``mesh_execution=off``
    runs are outside them). Returns those launches and, per kernel, its
    launches in each slot's shard bodies."""
    import collections
    import threading

    from presto_tpu_torch.exec.failpoints import FAILPOINTS, FailpointError
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE, DEFAULT_CACHE_BYTES
    from presto_tpu_torch.obs.flight import FLIGHTS
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    old_slots = os.environ.get("PRESTO_TPU_TORCH_MESH_SLOTS")
    os.environ["PRESTO_TPU_TORCH_MESH_SLOTS"] = str(MESH_SLOTS)
    mesh = {"mesh_execution": "on", "mesh_devices": MESH_SLOTS}
    local = {"mesh_execution": "off"}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    mesh_n = collections.Counter()
    per_slot = collections.defaultdict(lambda: [0] * MESH_SLOTS)

    @contextlib.contextmanager
    def on_mesh():
        """Adds the launches made inside the block to the mesh runs'."""
        before = _kernel_calls(device)
        try:
            yield
        finally:
            for k, v in _kernel_calls(device).items():
                mesh_n[k] += v - before.get(k, 0)

    #: the last mesh run's scanned and stacked bytes (_mesh_bytes)
    copies = {}

    def run(runner, sql, props):
        t0 = time.perf_counter()
        if props is not mesh:
            res = runner.execute(sql, properties=props)
            sync()
            return res, time.perf_counter() - t0
        copies.update(scanned=0, stacked=0, stacked_calls=0)
        with on_mesh(), _mesh_bytes(copies):
            res = runner.execute(sql, properties=props)
            sync()
        return res, time.perf_counter() - t0

    def stacked_line():
        return (f"{copies['stacked']} B stacked onto {device}:0 in "
                f"{copies['stacked_calls']} calls, {copies['scanned']} B "
                f"scanned")

    def flight_of(runner):
        fl = runner.last_stats.mesh_flight
        if fl is None or fl.n_devices != MESH_SLOTS:
            raise AssertionError("the query did not run on the mesh")
        return fl.attribution

    slot_tally = contextlib.ExitStack()
    try:
        slot_tally.enter_context(_slot_launches(device, per_slot))
        # -- the 22 TPC-H queries --------------------------------------------
        queries = _queries()
        gpu = LocalRunner(tpch_sf=sf, rows_per_batch=ROWS_PER_BATCH,
                          device=device)
        for name, sql in queries.items():
            res, wall = run(gpu, sql, mesh)
            a = flight_of(gpu)
            want, one = (tpch_cpu_rows or {}).get(name), ""
            if want is None:
                ref, ref_s = run(gpu, sql, local)
                want, one = ref.rows, f" | one device {ref_s:.3f} s"
            _same_rows(res.rows, want, 1e-9)
            print(f"mesh tpch sf{sf} {name}: {wall:.3f} s{one} | "
                  f"{len(res.rows)} rows match | {a['rounds']} rounds, "
                  f"dominant {a['dominant_bucket']} | {stacked_line()}",
                  flush=True)

        # -- BASELINE config 3: Q3 with a partitioned exchange ---------------
        big = LocalRunner(tpch_sf=big_sf, rows_per_batch=ROWS_PER_BATCH,
                          device=device)
        q3 = queries["q3"]
        CACHE.clear()
        # Q3's SF10 splits (about 2 GiB as 4 shards, as much again as the
        # single device's 2 splits) outgrow the cache's default 2 GiB; a
        # larger limit for these runs keeps the warm runs warm
        CACHE.set_limit(MESH_CACHE_BYTES)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        walls, attrs, stacks = [], [], []
        try:
            for _ in range(2):                   # cold, then warm
                res, wall = run(big, q3, mesh)
                walls.append(wall)
                attrs.append(flight_of(big))
                stacks.append(stacked_line())
                # the shards stay on their slots: only the root's rows and
                # the shard-0 finalizes' gathers come onto card 0
                if copies["stacked"] > 0.01 * copies["scanned"]:
                    raise AssertionError(f"config 3 stacked more than 1% "
                                         f"of its scanned bytes: "
                                         f"{stacked_line()}")
            fl = FLIGHTS.last()
            mesh_peak = (torch.cuda.max_memory_allocated() / 2**30
                         if cuda else 0)
            one = [run(big, q3, local) for _ in range(2)]
        finally:
            CACHE.clear()
            CACHE.set_limit(DEFAULT_CACHE_BYTES)
        _same_rows(res.rows, one[1][0].rows, 1e-9)
        if not res.rows:
            raise AssertionError("config 3 returned no rows")
        reparts = [r for r in fl.records() if r["kind"] == "repartition"]
        if not reparts:
            raise AssertionError("config 3 shipped no hash exchange")
        print(f"mesh config 3 (Q3 sf{big_sf}, {MESH_SLOTS} slots): cold "
              f"{walls[0]:.3f} s warm {walls[1]:.3f} s | single device "
              f"cold {one[0][1]:.3f} s warm {one[1][1]:.3f} s | "
              f"{len(res.rows)} rows match the single-device warm run | "
              f"warm: {len(reparts)} repartition rounds, "
              f"{sum(r['bytes'] for r in reparts)} B shipped, "
              f"{attrs[1]['rounds']} rounds | peak {mesh_peak:.2f} GiB "
              f"(max_memory_allocated over the mesh runs) | scan cache "
              f"limit {MESH_CACHE_BYTES >> 30} GiB for these runs",
              flush=True)
        for label, a, st in (("cold", attrs[0], stacks[0]),
                             ("warm", attrs[1], stacks[1])):
            split = {b: round(v, 6) for b, v in a["buckets"].items()}
            print(f"mesh config 3 {label} buckets (s): {json.dumps(split)} "
                  f"| dominant {a['dominant_bucket']} | "
                  f"{a['reconciled_pct']}% of {a['wall_s']} s attributed "
                  f"| critical path shard "
                  f"{a['critical_path']['slowest_shard']} | {st}",
                  flush=True)
        del big

        # -- the TPC-DS battery ----------------------------------------------
        ds = LocalRunner(tpch_sf=ds_sf, catalog="tpcds",
                         rows_per_batch=ROWS_PER_BATCH, device=device)
        for name, sql in _tpcds_queries().items():
            res, wall = run(ds, sql, mesh)
            a = flight_of(ds)
            want, one = (tpcds_cpu_rows or {}).get(name), ""
            if want is None:
                ref, ref_s = run(ds, sql, local)
                want, one = ref.rows, f" | one device {ref_s:.3f} s"
            _same_rows(_mesh_rows(res.rows), _mesh_rows(want), 1e-9)
            print(f"mesh tpcds sf{ds_sf} {name}: {wall:.3f} s{one} | "
                  f"{len(res.rows)} rows match | {a['rounds']} rounds, "
                  f"dominant {a['dominant_bucket']}", flush=True)
        del ds

        # -- EXPLAIN (TYPE DISTRIBUTED), EXPLAIN ANALYZE, mesh_rounds --------
        text = [r[0] for r in gpu.execute(
            "explain (type distributed) " + q3).rows]
        cpu_text = [r[0] for r in LocalRunner(
            tpch_sf=sf, device="cpu").execute(
            "explain (type distributed) " + q3).rows]
        if text != cpu_text:
            raise AssertionError("EXPLAIN (TYPE DISTRIBUTED) differs from "
                                 "the CPU run's")
        with on_mesh():
            analyze = "\n".join(r[0] for r in gpu.execute(
                "explain analyze " + q3, properties=mesh).rows)
        if "Mesh rounds:" not in analyze:
            raise AssertionError("EXPLAIN ANALYZE has no mesh rounds")
        qid = gpu.query_log[-1].query_id
        n_rounds = gpu.execute(
            "select count(*) from system.runtime.mesh_rounds where "
            f"query_id = '{qid}'", properties=local).rows[0][0]
        if not n_rounds:
            raise AssertionError(f"mesh_rounds holds no row of {qid}")
        print(f"mesh explain: distributed text {len(text)} lines equal to "
              f"the cpu run's; analyze "
              f"{[ln for ln in analyze.splitlines() if ln.startswith('Mesh')]};"
              f" mesh_rounds holds {n_rounds} rows of {qid}", flush=True)

        # -- an armed failpoint ----------------------------------------------
        want = run(gpu, q3, mesh)[0].rows
        FAILPOINTS.configure_from_spec("mesh.repartition=error:boom,times:1")
        try:
            try:
                run(gpu, q3, mesh)
            except FailpointError as e:
                print(f"mesh failpoint: the armed run raised {e}",
                      flush=True)
            else:
                raise AssertionError("the armed mesh Q3 did not raise")
            _same_rows(run(gpu, q3, mesh)[0].rows, want, 1e-9)
        finally:
            FAILPOINTS.clear()
        print("mesh failpoint: the next run returned equal rows", flush=True)

        # -- fair scheduling: Q6 and Q1 on two threads -----------------------
        names = ("q6", "q1")
        wants = {n: run(gpu, queries[n], mesh)[0].rows for n in names}
        got, errors = {}, []

        def worker(n):
            try:
                got[n] = gpu.execute(queries[n], properties=mesh)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(n,))
                   for n in names]
        t0 = time.perf_counter()
        with on_mesh():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        both_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent queries failed: {errors}")
        for n in names:
            _same_rows(got[n].rows, wants[n], 1e-9)
        accounts = [s.scheduler for s in gpu.live_stats.values()
                    if getattr(s, "scheduler", None)][-2:]
        # each of these aggregations is one output batch, so one quantum
        # (and the closing one): they run one after the other
        print(f"mesh fair scheduling: q6 and q1 together {both_s:.3f} s, "
              f"rows equal; scheduler accounts {accounts}", flush=True)

        # -- fair scheduling: the arbitration of a long and a short scan -----
        with on_mesh():
            long_r, short_r = _fair_arbitration(gpu, mesh, sf)
        for r, sql in ((long_r, FAIR_LONG_SQL), (short_r, FAIR_SHORT_SQL)):
            _same_rows(_mesh_rows(r["rows"]),
                       _mesh_rows(run(gpu, sql, local)[0].rows), 1e-9)
        print(f"mesh fair arbitration: long scan {long_r['wall']:.3f} s, "
              f"{long_r['quanta']} quanta at levels {long_r['levels']}; "
              f"short scan started at level 1 of the long one, "
              f"{short_r['wall']:.3f} s, {short_r['quanta']} quanta at "
              f"levels {short_r['levels']}, {long_r['between']} long quanta "
              f"among them; no two quanta overlapped; rows equal to the "
              f"single-device runs", flush=True)
    finally:
        slot_tally.close()
        if old_slots is None:
            os.environ.pop("PRESTO_TPU_TORCH_MESH_SLOTS", None)
        else:
            os.environ["PRESTO_TPU_TORCH_MESH_SLOTS"] = old_slots
    launches = {k: mesh_n[k] for k in _kernel_calls(device)}
    slots = {k: per_slot[k] for k in launches}
    print(f"mesh launches (mesh runs only): {json.dumps(launches)} | in "
          f"each slot's shard bodies: {json.dumps(slots)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if launches["segment_sum_sorted_i64"] <= 0:
        raise AssertionError("the segment sum never launched in the mesh "
                             "runs")
    idle = [i for i, v in enumerate(slots["segment_sum_sorted_i64"])
            if v <= 0]
    if idle:
        raise AssertionError(f"the segment sum never launched on slots "
                             f"{idle}")
    return launches, slots


#: the serving phase: TPC-H at SERVING_SF in 2^23-row batches; Q3 ten
#: times warm with the plan cache off, then on; the EXECUTE fleet's 8
#: bindings of a Q6 form (discount range and quantity vary, the shipdate
#: range fixed), then one that moves the shipdate bound; a Q3 form with 4
#: date bindings
SERVING_SF = 1
SERVING_RUNS = 10
Q6_FORM = ("select sum(l_extendedprice * l_discount) as revenue "
           "from lineitem where l_shipdate >= ? and l_shipdate < ? "
           "and l_discount between ? and ? and l_quantity < ?")
Q6_DATES = "date '1994-01-01', date '1995-01-01'"
#: (discount low, discount high, quantity): the first is Q6's own
Q6_BINDINGS = (("0.05", "0.07", 24), ("0.02", "0.04", 25),
               ("0.03", "0.05", 30), ("0.04", "0.06", 20),
               ("0.06", "0.08", 24), ("0.01", "0.09", 40),
               ("0.00", "0.03", 10), ("0.07", "0.10", 50))
Q3_DATES = ("1995-03-15", "1995-03-01", "1995-03-31", "1995-02-14")
#: the resource groups of the serving phase: two leaves under one root,
#: scheduling weights 2 and 1; dash carries a latency objective every Q1
#: misses (1 ms), so its burn pages and an alert transition is recorded
SERVING_GROUPS = {
    "rootGroups": [{
        "name": "serving", "hardConcurrencyLimit": 4, "maxQueued": 16,
        "subGroups": [
            {"name": "dash", "hardConcurrencyLimit": 2,
             "schedulingWeight": 2,
             "slo": {"latencyTargetMs": 1, "latencyObjective": 0.95,
                     "availabilityObjective": 0.99,
                     "windows": [60, 300]}},
            {"name": "adhoc", "hardConcurrencyLimit": 2,
             "schedulingWeight": 1}]}],
    "selectors": [{"user": "dash.*", "group": "serving.dash"},
                  {"group": "serving.adhoc"}]}


def _q3_form(day: str) -> str:
    """Q3 with both of its date literals set to ``day``."""
    return _queries()["q3"].replace("1995-03-15", day)


def phase_serving(torch, tpch_cpu_rows=None, device="cuda", sf=SERVING_SF,
                  rows_per_batch=ROWS_PER_BATCH):
    """The serving and observability planes on the card (``device="cpu"``
    rehearses the phase on the CPU at a small ``sf``): the plan cache on
    warm Q3, the template cache on an EXECUTE fleet and a Q3 form, the
    result cache (a Q1 hit, a memory-table write, an ORC append
    maintained incrementally, a vetoed insert), four Q1s admitted through
    two weighted resource groups, and the time-series, SLO and
    exposition planes over all of it. Reference rows not given are a CPU
    runner's. Returns the launches of the phase."""
    import tempfile
    import threading

    from presto_tpu_torch.connectors.orc import OrcConnector
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.taskexec import GLOBAL
    from presto_tpu_torch.obs.exposition import (
        parse_exposition, render_exposition,
    )
    from presto_tpu_torch.obs.history import HISTORY
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.obs.slo import SLO
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.obs.trace import TRACER
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.server import PrestoTpuServer
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    queries = _queries()
    tmp = tempfile.mkdtemp(prefix="serving_")
    runner = LocalRunner(tpch_sf=sf, device=device,
                         rows_per_batch=rows_per_batch)
    runner.session.catalogs.register("orc", OrcConnector(tmp))
    cpu = None
    if tpch_cpu_rows is None or not cuda:
        cpu = LocalRunner(tpch_sf=sf, device="cpu",
                          rows_per_batch=rows_per_batch)

    def cpu_rows(sql):
        return cpu.execute(sql).rows

    def counter(name):
        return REGISTRY.counter(name).value

    def timed(sql, props=None, **kw):
        t0 = time.perf_counter()
        res = runner.execute(sql, properties=props, **kw)
        if cuda:
            torch.cuda.synchronize()
        return res.rows, time.perf_counter() - t0

    base = _kernel_calls(device)

    def launches_since(ref):
        now = _kernel_calls(device)
        return {k: now[k] - ref[k] for k in now}

    # (a) the plan cache on warm Q3
    q3 = queries["q3"]
    want_q3 = (tpch_cpu_rows or {}).get("q3") if cuda else None
    if want_q3 is None:
        want_q3 = cpu_rows(q3)
    timed(q3, {"plan_cache": False})           # warm the scan cache
    TRACER.enable(True)
    try:
        # the two settings in turns (off, on, off, on, ...), so that
        # neither gets the card in a better state than the other
        walls, plan_ms = {False: [], True: []}, {False: [], True: []}
        h0 = counter("plan_cache_hit_total")
        for _ in range(SERVING_RUNS):
            for on in (False, True):
                rows, wall = timed(q3, {"plan_cache": on})
                _same_rows(rows, want_q3, 1e-9)
                walls[on].append(wall)
                plan_ms[on].append(HISTORY.snapshot()[-1]["planning_ms"])
        hits = counter("plan_cache_hit_total") - h0
        for on in (False, True):
            w, pm = walls[on], plan_ms[on]
            print(f"serving plan cache {'on' if on else 'off'}: warm q3 "
                  f"median wall {statistics.median(w):.4f} s (min "
                  f"{min(w):.4f}), median planning "
                  f"{statistics.median(pm) / 1e3:.4f} s", flush=True)
        print(f"serving plan cache: {hits:.0f} hits in {SERVING_RUNS} "
              "runs with it on", flush=True)
        if hits != SERVING_RUNS - 1:
            raise AssertionError(f"{hits} plan-cache hits in "
                                 f"{SERVING_RUNS} runs, expected "
                                 f"{SERVING_RUNS - 1}")
    finally:
        TRACER.enable(False)
        TRACER.clear()

    # (b) the template cache: an EXECUTE fleet, a guard fallback, a Q3 form
    tprops = {"plan_template_cache": True}
    runner.execute(f"prepare q6f from {Q6_FORM}")

    def tcounts():
        return {k: counter(f"plan_template_cache_{k}_total")
                for k in ("hit", "miss", "guard_fallback")}

    def inlined(lo, hi, qty, dates=("1994-01-01", "1995-01-01")):
        return (f"select sum(l_extendedprice * l_discount) as revenue "
                f"from lineitem where l_shipdate >= date '{dates[0]}' and "
                f"l_shipdate < date '{dates[1]}' and l_discount between "
                f"{lo} and {hi} and l_quantity < {qty}")

    t0 = tcounts()
    fleet_walls = []
    for i, (lo, hi, qty) in enumerate(Q6_BINDINGS):
        rows, wall = timed(f"execute q6f using {Q6_DATES}, {lo}, {hi}, "
                           f"{qty}", tprops)
        fleet_walls.append(wall)
        _same_rows(rows, runner.execute(inlined(lo, hi, qty)).rows, 1e-9)
        if i == 0:
            want = ((tpch_cpu_rows or {}).get("q6") if cuda else None) \
                or cpu_rows(inlined(lo, hi, qty))
            _same_rows(rows, want, 1e-9)
    t1 = tcounts()
    fleet = {k: t1[k] - t0[k] for k in t1}
    print(f"serving template fleet: 8 bindings of the Q6 form, walls "
          f"{' '.join(f'{w:.4f}' for w in fleet_walls)} s; builds "
          f"{fleet['miss']:.0f}, hits {fleet['hit']:.0f}, guard "
          f"fallbacks {fleet['guard_fallback']:.0f}", flush=True)
    if (fleet["miss"], fleet["hit"], fleet["guard_fallback"]) != (1, 7, 0):
        raise AssertionError(f"template counters {fleet}, expected 1 "
                             "build, 7 hits, 0 fallbacks")
    rows, _ = timed("execute q6f using date '1995-01-01', "
                    "date '1996-01-01', 0.05, 0.07, 24", tprops)
    _same_rows(rows, runner.execute(inlined(
        "0.05", "0.07", 24, ("1995-01-01", "1996-01-01"))).rows, 1e-9)
    t2 = tcounts()
    if t2["guard_fallback"] - t1["guard_fallback"] != 1:
        raise AssertionError("moving the shipdate bound did not count one "
                             "guard fallback")
    print("serving template guard: a binding that moves the shipdate "
          "bound counted 1 guard fallback", flush=True)
    for i, day in enumerate(Q3_DATES):
        rows, wall = timed(_q3_form(day), tprops)
        _same_rows(rows, runner.execute(_q3_form(day)).rows, 1e-9)
        if i == 0:
            _same_rows(rows, want_q3, 1e-9)
    t3 = tcounts()
    print(f"serving template q3 form: 4 date bindings, counters "
          f"{json.dumps({k: t3[k] - t2[k] for k in t3})}", flush=True)
    miss_launches = launches_since(base)
    print(f"serving launches in the plan and template runs: "
          f"{json.dumps(miss_launches)}", flush=True)
    if min(miss_launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the miss runs")

    # (c) the result cache
    rprops = {"result_cache": True}
    q1 = queries["q1"]
    m0, h0 = counter("result_cache_miss_total"), \
        counter("result_cache_hit_total")
    miss_rows, miss_wall = timed(q1, rprops)
    before = _kernel_calls(device)
    hit_rows, hit_wall = timed(q1, rprops)
    hit_launches = launches_since(before)
    if (counter("result_cache_miss_total") - m0,
            counter("result_cache_hit_total") - h0) != (1, 1):
        raise AssertionError("q1 was not one miss then one hit")
    if hit_rows != miss_rows:
        raise AssertionError("the result-cache hit's rows differ")
    want_q1 = ((tpch_cpu_rows or {}).get("q1") if cuda else None) \
        or cpu_rows(q1)
    _same_rows(miss_rows, want_q1, 1e-9)
    if any(hit_launches.values()):
        raise AssertionError(f"the result-cache hit launched {hit_launches}")
    print(f"serving result cache q1: miss {miss_wall:.4f} s, hit "
          f"{hit_wall:.6f} s, hit launches {json.dumps(hit_launches)}",
          flush=True)
    runner.execute("create table memory.default.sv as select n_nationkey k, "
                   "n_name name from nation")
    mem_sql = "select count(*), max(k) from memory.default.sv"
    first = runner.execute(mem_sql, properties=rprops).rows
    runner.execute(mem_sql, properties=rprops)
    m0 = counter("result_cache_miss_total")
    runner.execute("insert into memory.default.sv select n_nationkey + 1000, "
                   "n_name from nation where n_nationkey = 1")
    after = runner.execute(mem_sql, properties=rprops).rows
    if counter("result_cache_miss_total") - m0 != 1 or \
            tuple(after[0]) != (first[0][0] + 1, 1001):
        raise AssertionError(f"after the insert: {after} (before {first})")
    print(f"serving result cache memory table: {first} -> {after} after "
          "the insert (a miss)", flush=True)
    n_orders = int(100_000 * sf) + 100
    runner.execute(f"create table orc.default.sli as select l_orderkey k, "
                   f"l_quantity q, l_returnflag f from tpch.default.lineitem "
                   f"where l_orderkey < {n_orders}")
    conn = runner.session.catalogs.get("orc")
    old_files = set(conn.table_files("sli"))
    orc_sql = ("select f, count(*), sum(q), max(k) from orc.default.sli "
               "group by f order by f")
    oprops = {"result_cache": True, "scan_cache": False}
    runner.execute(orc_sql, properties=oprops)
    # the appended file's columns carry the table's names (an INSERT
    # into a file table writes the query's own column names)
    runner.execute(f"insert into orc.default.sli select l_orderkey k, "
                   f"l_quantity q, l_returnflag f from tpch.default.lineitem "
                   f"where l_orderkey between {n_orders} and "
                   f"{n_orders + n_orders // 10}")
    new_files = set(conn.table_files("sli")) - old_files
    read = []
    source = conn.page_source

    def recording(split, *a, **k):
        read.append(split.info[0])
        return source(split, *a, **k)

    conn.page_source = recording
    p0 = counter("result_cache_partial_total")
    try:
        rows, partial_wall = timed(orc_sql, oprops)
    finally:
        del conn.page_source
    cold = runner.execute(orc_sql, properties={"scan_cache": False}).rows
    if counter("result_cache_partial_total") - p0 != 1:
        raise AssertionError("the appended ORC table was not a partial hit")
    if not new_files or set(read) != new_files:
        raise AssertionError(f"the partial hit read {sorted(read)}, the "
                             f"appended files are {sorted(new_files)}")
    _same_rows(rows, cold, 1e-9)
    print(f"serving result cache orc append: partial hit {partial_wall:.4f}"
          f" s, read {len(read)} appended split(s) of "
          f"{len(old_files) + len(new_files)}", flush=True)
    veto_sql = "select max(k), count(*) from memory.default.sv"
    FAILPOINTS.configure(
        "resultcache.stamp", action="callback", times=1,
        callback=lambda **_: runner.execute(
            "insert into memory.default.sv select n_nationkey + 2000, "
            "n_name from nation where n_nationkey = 2"))
    try:
        vetoed = runner.execute(veto_sql, properties=rprops).rows
    finally:
        FAILPOINTS.clear("resultcache.stamp")
    m0 = counter("result_cache_miss_total")
    again = runner.execute(veto_sql, properties=rprops).rows
    if counter("result_cache_miss_total") - m0 != 1 or again != vetoed:
        raise AssertionError("the write at resultcache.stamp did not veto "
                             "the insert")
    print("serving result cache veto: a write at resultcache.stamp vetoed "
          "the insert (the next run missed)", flush=True)

    # (d) four Q1s through the statement server's two weighted groups
    srv = PrestoTpuServer(runner, resource_groups=SERVING_GROUPS)
    mgr = srv.resource_groups
    results, errors = {}, []

    def serve(user):
        try:
            client = StatementClient(f"http://127.0.0.1:{srv.port}",
                                     user=user)
            results[user] = client.execute(q1).rows
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{user}: {type(e).__name__}: {e}")

    # the families the server feeds, registered before the first sample
    # so that the windows have a baseline point
    for path in ("serving.dash", "serving.adhoc"):
        REGISTRY.histogram(f"serving_latency_seconds.{path}")
        REGISTRY.counter(f"serving_requests_total.{path}")
        REGISTRY.counter(f"serving_errors_total.{path}")
    TIMESERIES.sample()
    served0 = {p: REGISTRY.histogram(f"serving_latency_seconds.{p}").count
               for p in ("serving.dash", "serving.adhoc")}
    srv.start()
    try:
        users = ("dash-1", "adhoc-1", "dash-2", "adhoc-2")
        threads = [threading.Thread(target=serve, args=(u,))
                   for u in users]
        t_groups = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        groups_wall = time.perf_counter() - t_groups
    finally:
        srv.stop()
        TIMESERIES.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("; ".join(errors) or "a client never returned")
    for user in users:
        _same_rows(results[user], _json_rows(want_q1), 1e-9)
    served = {p: REGISTRY.histogram(f"serving_latency_seconds.{p}").count
              - served0[p] for p in served0}
    if served != {"serving.dash": 2, "serving.adhoc": 2}:
        raise AssertionError(f"the server recorded {served} served walls")
    shares = GLOBAL.group_shares()
    dev_s = {g: shares.get(f"{mgr.scope}/serving.{g}", {}).get(
        "device_seconds", 0.0) for g in ("dash", "adhoc")}
    table = runner.execute("select \"group\", running, queued, "
                           "memory_reserved_bytes, scheduling_weight, "
                           "device_seconds, quanta from "
                           "system.runtime.resource_groups").rows
    mine = [r for r in table if r[0].startswith("serving")]
    if len(mine) != 3:
        raise AssertionError(f"resource_groups rows {table}")
    reserved = [g["memoryReservedBytes"] for g in mgr.info()]
    if any(reserved) or any(r[3] for r in mine):
        raise AssertionError(f"group memory left charged: {mine}")
    print(f"serving resource groups: 4 concurrent q1 over http in "
          f"{groups_wall:.3f} s, the server recorded {json.dumps(served)} "
          f"served walls, scheduler device seconds dash (weight 2) "
          f"{dev_s['dash']:.4f} adhoc (weight 1) {dev_s['adhoc']:.4f}; "
          f"rows {json.dumps(mine, default=int)}", flush=True)

    # (e) the time-series, SLO and exposition planes over the phase
    TIMESERIES.sample()
    SLO.evaluate()
    series = runner.execute("select count(*) from "
                            "system.runtime.timeseries").rows[0][0]
    slo = runner.execute("select group_path, objective, state, burn_short "
                         "from system.runtime.slo").rows
    alerts = runner.execute("select group_path, from_state, to_state, rule "
                            "from system.runtime.alerts").rows
    if not series or not slo or not alerts:
        raise AssertionError(f"timeseries {series} slo {slo} alerts "
                             f"{alerts}")
    samples, types = parse_exposition(render_exposition())
    fams = ("plan_cache_hit_total", "plan_template_cache_hit_total",
            "plan_template_cache_guard_fallback_total",
            "result_cache_hit_total", "result_cache_partial_total")
    missing = [f for f in fams if types.get(f) != "counter"
               or (f, ()) not in samples]
    if missing:
        raise AssertionError(f"the exposition lacks {missing}")
    print(f"serving observability: {series} timeseries rows, slo "
          f"{json.dumps(slo)}, alerts {json.dumps(alerts)}; exposition "
          f"{len(samples)} samples, cache counters "
          f"{json.dumps({f: samples[(f, ())] for f in fams})}", flush=True)
    launches = launches_since(base)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"serving launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    return launches


#: the frontdoor phase: TPC-H at FRONTDOOR_SF served over HTTP by a
#: server booted from an etc directory; warm Q6, Q1 and Q3 FRONTDOOR_RUNS
#: times each over HTTP and through the runner, in turns; the embedded
#: CLI's profiled Q3 at FRONTDOOR_CLI_SF
FRONTDOOR_SF = 1
FRONTDOOR_RUNS = 10
FRONTDOOR_CLI_SF = 0.1
FRONTDOOR_WARM = ("q6", "q1", "q3")
#: the names the CUDA kernels carry in a torch.profiler trace
KERNEL_SYMBOLS = {"segment_sum_sorted_i64": "segment_sum_kernel",
                  "direct_probe": "direct_probe_kernel"}
#: the serving phase's two weighted groups under a root of this phase's
#: own, so the series the server records here are told apart from the
#: serving phase's
FRONTDOOR_GROUPS = {
    "rootGroups": [dict(SERVING_GROUPS["rootGroups"][0], name="frontdoor")],
    "selectors": [{"user": "dash.*", "group": "frontdoor.dash"},
                  {"group": "frontdoor.adhoc"}]}


def _write_etc(root: str, sf, groups) -> str:
    """An etc directory: tpch at ``sf``, memory, a SQLite catalog, an
    HTTP port chosen by the system, and the resource groups ``groups``."""
    etc = os.path.join(root, "etc")
    os.makedirs(os.path.join(etc, "catalog"))
    catalogs = {"tpch": f"connector.name=tpch\ntpch.scale-factor={sf}\n",
                "memory": "connector.name=memory\n",
                "sq": "connector.name=sqlite\nsqlite.path="
                      f"{os.path.join(root, 'frontdoor.db')}\n"}
    for name, props in catalogs.items():
        with open(os.path.join(etc, "catalog", f"{name}.properties"),
                  "w") as f:
            f.write(props)
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write("coordinator=true\nhttp-server.http.port=0\n"
                "session.catalog=tpch\n")
    with open(os.path.join(etc, "resource-groups.json"), "w") as f:
        json.dump(groups, f)
    return etc


def _json_rows(rows):
    """Rows as the statement protocol encodes them."""
    from presto_tpu_torch.server.protocol import _json_value
    return [[_json_value(v) for v in r] for r in rows]


def _http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def _check_merged_trace(path: str, cuda: bool) -> str:
    """The CLI's merged trace holds the tracer's host spans and, on the
    card, the CUDA events of both kernels inside the profiled statement's
    query span. Returns a summary line."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "presto_tpu_torch"
             and e.get("ph") == "X"]
    queries = [e for e in spans if e["name"] == "query"]
    if not queries:
        raise AssertionError("the merged trace holds no query span")
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "presto_tpu_torch"]
    if not device:
        raise AssertionError("the merged trace holds no profiler event")
    q3 = max(queries, key=lambda e: e["dur"])
    lo, hi = q3["ts"], q3["ts"] + q3["dur"]
    found = {}
    for name, symbol in KERNEL_SYMBOLS.items():
        ev = [e for e in device if symbol in str(e.get("name"))]
        inside = [e for e in ev if lo <= e["ts"] <= hi]
        found[name] = (len(ev), len(inside))
        if cuda and not inside:
            first = ev[0]["ts"] if ev else None
            raise AssertionError(
                f"{len(ev)} {symbol} events, none inside the query span "
                f"[{lo}, {hi}] us (first at {first})")
    from presto_tpu_torch.obs.profiler import find_device_traces
    bases = []
    for trace in find_device_traces(os.path.dirname(path)):
        with open(trace) as f:
            bases.append(json.load(f).get("baseTimeNanoseconds"))
    return (f"{len(spans)} host spans, {len(device)} profiler events "
            f"(shifted by the traces' baseTimeNanoseconds {bases}); "
            f"kernel events (all, inside the Q3 span): "
            f"{json.dumps(found)}")


def phase_frontdoor(torch, tpch_cpu_rows=None, device="cuda",
                    sf=FRONTDOOR_SF, cli_sf=FRONTDOOR_CLI_SF,
                    runs=FRONTDOOR_RUNS, rows_per_batch=ROWS_PER_BATCH):
    """The front door on the card (``device="cpu"`` rehearses the phase
    on the CPU at a small ``sf``): a statement server booted from an etc
    directory serves the 22 TPC-H queries over HTTP, then warm Q6, Q1
    and Q3 over HTTP against the same runner, DB-API bindings, the CLI
    against the server and embedded with ``--profile-out``, a fleet of
    two coordinators over one SQLite file, and the server's metrics,
    history and lifecycle endpoints. Reference rows not given are a CPU
    runner's. Returns the launches of the phase."""
    import csv
    import datetime
    import io
    import tempfile

    from presto_tpu_torch import cli, dbapi
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.config import server_from_etc
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.obs.exposition import parse_exposition
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.obs.trace import TRACER
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    queries = _queries()
    tmp = tempfile.mkdtemp(prefix="frontdoor_")
    etc = _write_etc(tmp, sf, FRONTDOOR_GROUPS)
    base = _kernel_calls(device)

    def counter(name):
        return REGISTRY.counter(name).value

    def sync():
        if cuda:
            torch.cuda.synchronize()

    laps = [time.perf_counter()]

    def lap():
        """Seconds since the last lap: each part's own wall."""
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    cpu_rows = dict(tpch_cpu_rows or {}) if cuda else {}
    missing = [n for n in queries if n not in cpu_rows]
    cpu_s = 0.0
    if missing:
        cpu = LocalRunner(tpch_sf=sf, device="cpu",
                          rows_per_batch=rows_per_batch)
        for name in missing:
            cpu_rows[name] = cpu.execute(queries[name]).rows
        del cpu
        cpu_s = lap()
        print(f"frontdoor cpu reference rows of {len(missing)} queries: "
              f"{cpu_s:.3f} s", flush=True)
    srv, _ = server_from_etc(etc, device=device)
    srv.runner.rows_per_batch = rows_per_batch
    srv.start()
    servers = [srv]
    try:
        url = f"http://127.0.0.1:{srv.port}"
        runner = srv.runner
        client = StatementClient(url, user="frontdoor")

        # (a) the 22 TPC-H queries over HTTP against the CPU rows
        walls = {}
        for name, sql in queries.items():
            t0 = time.perf_counter()
            res = client.execute(sql)
            walls[name] = time.perf_counter() - t0
            _same_rows(res.rows, _json_rows(cpu_rows[name]), 1e-9)
        cold = {n: round(w, 4) for n, w in walls.items()}
        print(f"frontdoor tpch over http: 22 queries equal the cpu rows; "
              f"cold walls {json.dumps(cold)} s, sum "
              f"{sum(walls.values()):.3f} s (part {lap():.3f} s, with the "
              f"boot)", flush=True)

        # (b) warm Q6, Q1 and Q3: HTTP against the runner, in turns
        i0 = counter("serving_inline_lane_total")
        for name in FRONTDOOR_WARM:
            sql = queries[name]
            want = _json_rows(cpu_rows[name])
            client.execute(sql)                   # warm both ways
            runner.execute(sql)
            http, direct, docs, pages = [], [], 0, 0
            for _ in range(runs):
                t0 = time.perf_counter()
                rows = []
                for doc in client.pages(sql):
                    docs += 1
                    if "data" in doc:
                        pages += 1
                        rows.extend(doc["data"])
                sync()
                http.append(time.perf_counter() - t0)
                _same_rows(rows, want, 1e-9)
                t0 = time.perf_counter()
                res = runner.execute(sql)
                sync()
                direct.append(time.perf_counter() - t0)
                _same_rows(_json_rows(res.rows), want, 1e-9)
            cost = statistics.median(http) - statistics.median(direct)
            print(f"frontdoor warm {name}: http median "
                  f"{statistics.median(http) * 1e3:.3f} ms (min "
                  f"{min(http) * 1e3:.3f}), runner median "
                  f"{statistics.median(direct) * 1e3:.3f} ms (min "
                  f"{min(direct) * 1e3:.3f}); protocol cost "
                  f"{cost * 1e3:.3f} ms a statement; {docs / runs:g} "
                  f"responses and {pages / runs:g} data pages a statement",
                  flush=True)
        print(f"frontdoor inline lane: "
              f"{counter('serving_inline_lane_total') - i0:.0f} of "
              f"{len(FRONTDOOR_WARM) * (runs + 1)} warm http statements "
              f"(part {lap():.3f} s)", flush=True)

        # (c) DB-API: the serving phase's Q6 form with 8 qmark bindings
        cur = dbapi.connect(port=srv.port, user="dash-dbapi").cursor()
        dates = (datetime.date(1994, 1, 1), datetime.date(1995, 1, 1))
        for lo, hi, qty in Q6_BINDINGS:
            cur.execute(Q6_FORM, (*dates, float(lo), float(hi), qty))
            got = [list(r) for r in cur.fetchall()]
            inlined = Q6_FORM
            for v in (*(f"date '{d}'" for d in dates), lo, hi, qty):
                inlined = inlined.replace("?", str(v), 1)
            _same_rows(got, _json_rows(runner.execute(inlined).rows), 1e-9)
        print(f"frontdoor dbapi: {len(Q6_BINDINGS)} qmark bindings of the "
              f"Q6 form equal the runner's rows (part {lap():.3f} s)",
              flush=True)

        # (d) the CLI: against the server, and embedded with a profile
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--server", url, "-e", queries["q1"],
                           "--output-format", "CSV"])
        lines = list(csv.reader(io.StringIO(out.getvalue())))
        want = _json_rows(cpu_rows["q1"])
        if rc != 0 or len(lines) != len(want):
            raise AssertionError(f"cli rc {rc}, {len(lines)} csv lines "
                                 f"for {len(want)} rows")
        for line, row in zip(lines, want):
            _same_rows([[float(c) if isinstance(v, float) else c
                         for c, v in zip(line, row)]],
                       [[v if isinstance(v, float) else str(v)
                         for v in row]], 1e-9)
        prof_dir = os.path.join(tmp, "profile")
        err = io.StringIO()
        before = _kernel_calls(device)
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["--device", device, "--sf", str(cli_sf),
                               "--profile-out", prof_dir,
                               "-e", queries["q3"]])
        finally:
            TRACER.enable(False)
            TRACER.clear()
        cli_launches = {k: v - before[k]
                        for k, v in _kernel_calls(device).items()}
        if rc != 0 or "device profiler unavailable" in err.getvalue():
            raise AssertionError(f"embedded cli rc {rc}: {err.getvalue()}")
        summary = _check_merged_trace(
            os.path.join(prof_dir, "merged_trace.json"), cuda)
        print(f"frontdoor cli: q1 csv through the server equals the cpu "
              f"rows; embedded q3 at sf {cli_sf} launches "
              f"{json.dumps(cli_launches)}; merged trace: {summary} "
              f"(part {lap():.3f} s)", flush=True)

        # (e) a fleet of two coordinators over one SQLite file
        srv_b, _ = server_from_etc(etc, device=device)
        srv_b.start()
        servers.append(srv_b)
        url_b = f"http://127.0.0.1:{srv_b.port}"
        srv.enable_fleet("frontdoor-a", peers=[url_b], heartbeat_s=5.0)
        srv_b.enable_fleet("frontdoor-b", peers=[url], heartbeat_s=5.0)
        srv_b.runner.session.properties["result_cache"] = True
        b = StatementClient(url_b, user="frontdoor")
        client.execute("create table sq.default.fd as select n_nationkey k, "
                       "n_name name from tpch.default.nation")
        fd_sql = "select count(*), sum(k), max(name) from sq.default.fd"
        h0 = counter("result_cache_hit_total")
        first = b.execute(fd_sql).rows
        if b.execute(fd_sql).rows != first or \
                counter("result_cache_hit_total") - h0 != 1:
            raise AssertionError("the second read on b was not a "
                                 "result-cache hit")
        f0, v0 = counter("fleet_bump_fold_total"), \
            counter("result_cache_invalidated_total")
        client.execute("insert into sq.default.fd select n_nationkey + 100, "
                       "n_name from tpch.default.nation where n_nationkey "
                       "< 3")
        folds = counter("fleet_bump_fold_total") - f0
        dropped = counter("result_cache_invalidated_total") - v0
        if folds < 1 or dropped < 1:
            raise AssertionError(f"the write through a folded {folds} bumps "
                                 f"and dropped {dropped} entries on b")
        h1 = counter("result_cache_hit_total")
        after = b.execute(fd_sql).rows
        uncached = _json_rows(srv_b.runner.execute(
            fd_sql, properties={"result_cache": False}).rows)
        if counter("result_cache_hit_total") != h1 or after != uncached \
                or after[0][0] != first[0][0] + 3:
            raise AssertionError(f"b read {after} after the write (before "
                                 f"{first}, uncached {uncached})")
        fleet = json.loads(_http_get(f"{url}/v1/fleet"))
        if fleet["peers"] != [url_b]:
            raise AssertionError(f"/v1/fleet of a lists {fleet['peers']}")
        print(f"frontdoor fleet: a write through a folded {folds:.0f} "
              f"bump(s) on b and dropped {dropped:.0f} cached entries "
              f"before b's next read; b read {first} -> {after} (uncached "
              f"{uncached}); /v1/fleet of a lists {fleet['peers']} "
              f"(part {lap():.3f} s)", flush=True)

        # (f) the server's own series and endpoints
        TIMESERIES.sample()
        samples, _ = parse_exposition(_http_get(f"{url}/v1/metrics").decode())
        groups = sorted({dict(lbl).get("key", "") for (n, lbl) in samples
                         if n.startswith("serving_latency_seconds")})
        if "frontdoor.adhoc" not in groups or "frontdoor.dash" not in groups:
            raise AssertionError(f"/v1/metrics serving latency groups "
                                 f"{groups}")
        hist = json.loads(_http_get(
            f"{url}/v1/metrics/history?name=serving_requests_total."
            "frontdoor.adhoc&window=600"))
        if hist.get("kind") != "counter":
            raise AssertionError(f"/v1/metrics/history: {hist}")
        states = [json.loads(_http_get(f"{url_b}/v1/info"))["state"]]
        pages = b.pages("select l_orderkey from lineitem limit 10000")
        next(pages)                   # b holds a page: the drain waits
        srv_b.begin_shutdown()
        states.append(json.loads(_http_get(f"{url_b}/v1/info"))["state"])
        for _ in pages:
            pass
        left = json.loads(_http_get(f"{url}/v1/fleet"))["peers"]
        if states != ["ACTIVE", "SHUTTING_DOWN"] or left:
            raise AssertionError(f"/v1/info states {states}, a's peers "
                                 f"after b drained {left}")
        print(f"frontdoor endpoints: /v1/metrics serving latency groups "
              f"{groups}; /v1/metrics/history {len(hist['points'])} "
              f"points; /v1/info {' -> '.join(states)}; a's peers after "
              f"b drained {left} (part {lap():.3f} s)", flush=True)
    finally:
        for s in servers:
            s.stop()
        TIMESERIES.stop()
    launches = {k: v - base[k] for k, v in _kernel_calls(device).items()}
    shutil.rmtree(tmp, ignore_errors=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the phase: "
                             f"{launches}")
    wall = time.perf_counter() - t_phase
    print(f"frontdoor launches: {json.dumps(launches)} | phase wall "
          f"{wall:.3f} s ({wall - cpu_s:.3f} s without the cpu reference "
          f"runs)", flush=True)
    return launches


#: the cluster phase: the 22 TPC-H queries on CLUSTER_WORKERS in-process
#: workers at CLUSTER_SF in 2^23-row batches, cold, beside one device;
#: config 3's shape (Q3, partitioned joins) warm CLUSTER_RUNS times in
#: turns with one device; the chaos scenarios at CLUSTER_CHAOS_SF with a
#: CLUSTER_STRAGGLER_S straggler; a subprocess worker at CLUSTER_SF; a
#: traced Q3; the memory manager killing Q3 under CLUSTER_MEMORY_LIMIT
CLUSTER_SF = 1
CLUSTER_WORKERS = 2
CLUSTER_RUNS = 5
CLUSTER_CHAOS_SF = 0.1
CLUSTER_STRAGGLER_S = 6.0
CLUSTER_MEMORY_LIMIT = 1 << 20
#: a drained subprocess worker exits within its grace (5 s) plus this
CLUSTER_EXIT_SLACK_S = 25.0
#: walls of the cold one-device runs of the path and tpch phases (the
#: cluster phase prints them beside its own cold walls; run alone, it
#: measures them itself)
LOCAL_COLD_WALLS = {}
#: the summary of the cluster phase's chaos run (its preemption storm
#: and scale to zero are read by the autoscale phase; run alone, that
#: phase runs the scenarios itself)
CLUSTER_CHAOS = {}
#: the queries the JAX package's ClusterRunner does not run at SF 0.01
#: (tests/test_torch_cluster*.py hold the port to its rows on all 22)
CLUSTER_LEFT_OUT = ()


@contextlib.contextmanager
def _task_launches(device, acc):
    """Adds to ``acc`` the launches of each kernel made under the block
    outside the coordinator's init plans: with the cluster's workers in
    this process, the launches of the workers' tasks."""
    import presto_tpu_torch.exec.local as local
    plain = local.run_init_plans
    init = dict.fromkeys(acc, 0)

    def counted(ex, plan):
        before = _kernel_calls(device)
        try:
            return plain(ex, plan)
        finally:
            for k, v in _kernel_calls(device).items():
                init[k] += v - before[k]
    local.run_init_plans = counted
    start = _kernel_calls(device)
    try:
        yield
    finally:
        local.run_init_plans = plain
        for k, v in _kernel_calls(device).items():
            acc[k] += v - start[k] - init[k]


def _metric_samples(url):
    from presto_tpu_torch.obs.exposition import parse_exposition
    samples, _ = parse_exposition(_http_get(f"{url}/v1/metrics").decode())
    return samples


def _worker_kernel_calls(url, device):
    """A worker's own kernel launches (plain calls on the CPU), from its
    ``/v1/metrics``."""
    fam = "kernel_launches_total" if device == "cuda" \
        else "kernel_plain_calls_total"
    samples = _metric_samples(url)
    return {name: int(samples.get((fam, (("key", name),)), 0))
            for name in ("segment_sum_sorted_i64", "direct_probe")}


def phase_cluster(torch, tpch_cpu_rows=None, device="cuda", sf=CLUSTER_SF,
                  chaos_sf=CLUSTER_CHAOS_SF, runs=CLUSTER_RUNS,
                  straggler_s=CLUSTER_STRAGGLER_S,
                  rows_per_batch=ROWS_PER_BATCH, local_walls=None):
    """The cluster on the card (``device="cpu"`` rehearses the phase on
    the CPU at a small ``sf``): (a) the 22 TPC-H queries on two
    in-process workers, cold, against the CPU rows and beside one
    device; (b) Q3 with partitioned joins, warm, in turns with one
    device; (c) the chaos scenarios; (d) a subprocess worker announcing
    to a statement server that serves a discovery-fed ClusterRunner,
    then drained; (e) a traced Q3; (f) the memory manager. Returns the
    launches of the workers' tasks in this process and those of the
    subprocess worker."""
    import subprocess as sp
    import urllib.request

    from presto_tpu_torch._devtools import chaos
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.exec.cluster import ClusterRunner, QueryFailedError
    from presto_tpu_torch.exec.discovery import DiscoveryNodeManager
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.exec.spool import SPOOL
    from presto_tpu_torch.obs.metrics import REGISTRY, TASKS
    from presto_tpu_torch.obs.trace import TRACER
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server.worker import WorkerServer
    cuda = device == "cuda"
    t_phase = time.perf_counter()
    TRACER.enable(False)
    queries = _queries()
    names = [n for n in queries if n not in CLUSTER_LEFT_OUT]
    launches = dict.fromkeys(("segment_sum_sorted_i64", "direct_probe"), 0)

    def counter(name):
        return REGISTRY.counter(name).value

    def sync():
        if cuda:
            torch.cuda.synchronize()

    laps = [time.perf_counter()]

    def lap():
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    cpu_rows = dict(tpch_cpu_rows or {}) if cuda else {}
    missing = [n for n in names if n not in cpu_rows]
    cpu_s = 0.0
    if missing:
        cpu = LocalRunner(tpch_sf=sf, device="cpu",
                          rows_per_batch=rows_per_batch)
        for name in missing:
            cpu_rows[name] = cpu.execute(queries[name]).rows
        del cpu
        cpu_s = lap()
        print(f"cluster cpu reference rows of {len(missing)} queries: "
              f"{cpu_s:.3f} s", flush=True)
    local = LocalRunner(tpch_sf=sf, device=device,
                        rows_per_batch=rows_per_batch)
    local_walls = dict(local_walls or {})
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    workers = [WorkerServer(tpch_sf=sf, device=device)
               for _ in range(CLUSTER_WORKERS)]
    for w in workers:
        w.start()
        discovery.announce(w.node_id, f"http://127.0.0.1:{w.port}")
    runner = ClusterRunner(tpch_sf=sf, heartbeat=True, discovery=discovery,
                           device=device, rows_per_batch=rows_per_batch)
    srv = proc = None
    try:
        # (a) the 22 queries, cold, against the CPU rows
        print(f"cluster left out: {list(CLUSTER_LEFT_OUT) or 'none'} (the "
              f"reference's ClusterRunner runs all 22 at SF 0.01)",
              flush=True)
        walls = {}
        for name in names:
            sql = queries[name]
            b0 = counter("exchange_sent_bytes_total")
            p0 = counter("exchange_sent_pages_total")
            r0 = counter("exchange_responses_total")
            CACHE.clear()
            before = _kernel_calls(device)
            with _task_launches(device, launches):
                t0 = time.perf_counter()
                res = runner.execute(sql)
                sync()
                wall = time.perf_counter() - t0
            counts = {k: v - before[k]
                      for k, v in _kernel_calls(device).items()}
            _same_rows(res.rows, cpu_rows[name], 1e-9, f"cluster {name}")
            if name not in local_walls:
                CACHE.clear()
                t0 = time.perf_counter()
                local.execute(sql)
                sync()
                local_walls[name] = time.perf_counter() - t0
            walls[name] = wall
            print(f"cluster {name}: cold {wall:.3f} s | one device cold "
                  f"{local_walls[name]:.3f} s ({wall / local_walls[name]:.2f}"
                  f"x) | {len(res.rows)} rows match the cpu run | "
                  f"exchange {counter('exchange_sent_bytes_total') - b0:.0f}"
                  f" B in {counter('exchange_sent_pages_total') - p0:.0f} "
                  f"pages, {counter('exchange_responses_total') - r0:.0f} "
                  f"responses | launches {json.dumps(counts)}", flush=True)
        print(f"cluster tpch: {len(names)} queries equal the cpu rows; "
              f"cold walls sum {sum(walls.values()):.3f} s against "
              f"{sum(local_walls[n] for n in names):.3f} s on one device "
              f"(part {lap():.3f} s)", flush=True)

        # (b) config 3's shape: Q3 with partitioned joins, warm, in turns
        q3 = queries["q3"]
        part = {"broadcast_join_row_limit": 0}
        for props in (None, part):
            b0 = counter("exchange_sent_bytes_total")
            p0 = counter("exchange_sent_pages_total")
            r0 = counter("exchange_responses_total")
            with _task_launches(device, launches):
                runner.execute(q3, properties=props)
            print(f"cluster q3 {'partitioned' if props else 'broadcast'}: "
                  f"exchange {counter('exchange_sent_bytes_total') - b0:.0f}"
                  f" B in {counter('exchange_sent_pages_total') - p0:.0f} "
                  f"pages, {counter('exchange_responses_total') - r0:.0f} "
                  f"responses (warm)", flush=True)
        local.execute(q3, properties=part)
        cl, one = [], []
        for _ in range(runs):
            with _task_launches(device, launches):
                t0 = time.perf_counter()
                res = runner.execute(q3, properties=part)
                sync()
                cl.append(time.perf_counter() - t0)
            _same_rows(res.rows, cpu_rows["q3"], 1e-9, "cluster q3")
            t0 = time.perf_counter()
            res = local.execute(q3, properties=part)
            sync()
            one.append(time.perf_counter() - t0)
            _same_rows(res.rows, cpu_rows["q3"], 1e-9)
        ratio = statistics.median(cl) / statistics.median(one)
        print(f"cluster config 3 shape (q3, partitioned joins, sf {sf}): "
              f"warm median {statistics.median(cl) * 1e3:.3f} ms (min "
              f"{min(cl) * 1e3:.3f}) on {CLUSTER_WORKERS} workers against "
              f"{statistics.median(one) * 1e3:.3f} ms (min "
              f"{min(one) * 1e3:.3f}) on one device: {ratio:.2f}x "
              f"(part {lap():.3f} s)", flush=True)

        # (e) a traced Q3: every task's span under the query's span
        TRACER.clear()
        TRACER.enable()
        wait = REGISTRY.histogram("exchange_wait_seconds")
        w0, s0 = wait.sum, counter("spool_write_bytes_total")
        try:
            with _task_launches(device, launches):
                runner.execute(q3, properties=part)
        finally:
            TRACER.enable(False)
        spans = TRACER.export()
        TRACER.clear()
        query = [s for s in spans if s["name"] == "query"
                 and s["attrs"].get("mode") == "cluster"][-1]
        by_id = {s["spanId"]: s for s in spans}

        def under_query(s):
            while s is not None:
                if s["spanId"] == query["spanId"]:
                    return True
                s = by_id.get(s.get("parentId"))
            return False
        tasks = [s for s in spans if s["name"] == "task"]
        qid = query["attrs"]["query_id"]
        want = {t["task_id"] for t in TASKS.snapshot()
                if t.get("query_id") == qid}
        got = {s["attrs"]["task_id"] for s in tasks if under_query(s)}
        nodes = {s["attrs"]["node_id"] for s in tasks if under_query(s)}
        if not want or got != want \
                or nodes != {w.node_id for w in workers}:
            raise AssertionError(f"traced q3: task spans {sorted(got)} "
                                 f"under the query span, tasks "
                                 f"{sorted(want)}, nodes {sorted(nodes)}")
        print(f"cluster trace: the spans of all {len(want)} tasks on "
              f"{len(nodes)} workers lie under q3's query span "
              f"({len(spans)} spans; part {lap():.3f} s)", flush=True)
        # where the partitioned q3's wall goes: each stage's longest task
        kinds = {s["attrs"].get("stage_id"): s["attrs"].get("partitioning")
                 for s in spans if s["name"] == "stage"}
        per_stage = {}
        for s in tasks:
            per_stage.setdefault(s["attrs"]["stage_id"], []).append(
                s["end"] - s["start"])
        print(f"cluster q3 breakdown (traced, warm): query span "
              f"{query['end'] - query['start']:.3f} s; "
              + "; ".join(f"stage {fid} [{kinds.get(fid)}] {len(ts)} "
                          f"tasks, longest {max(ts):.3f} s"
                          for fid, ts in sorted(per_stage.items()))
              + f"; consumers blocked on remote pages "
              f"{wait.sum - w0:.3f} s in all; spool written "
              f"{counter('spool_write_bytes_total') - s0:.0f} B",
              flush=True)

        # (f) the memory manager: a limit below q3's reservation
        runner.enable_memory_manager(CLUSTER_MEMORY_LIMIT, interval_s=0.01)
        killed = None
        try:
            for _ in range(10):
                CACHE.clear()
                try:
                    with _task_launches(device, launches):
                        runner.execute(q3, properties={"scan_cache": False})
                except QueryFailedError as e:
                    killed = str(e)
                    break
        finally:
            mm = runner.memory_manager
            mm.stop()
            runner.memory_manager = None
        if killed is None or "exceeded cluster memory limit" not in killed:
            raise AssertionError(f"q3 ran under a {CLUSTER_MEMORY_LIMIT} B "
                                 f"cluster limit: {killed}")
        print(f"cluster memory manager: q3 killed at "
              f"{json.dumps(mm.killed)} B reserved against a "
              f"{CLUSTER_MEMORY_LIMIT} B limit: {killed[:120]} "
              f"(part {lap():.3f} s)", flush=True)

        # (d) a subprocess worker joins by announcement, serves q1 and q3
        srv = PrestoTpuServer(runner=runner, discovery=discovery)
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        env = {k: v for k, v in os.environ.items()
               if k != "PRESTO_TPU_TORCH_TRACE"}
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = sp.Popen(
            [sys.executable, "-m", "presto_tpu_torch.server.worker",
             "--device", device, "--tpch-sf", str(sf),
             "--coordinator", url], stdout=sp.PIPE, env=env, text=True)
        hello = json.loads(proc.stdout.readline())
        wurl = f"http://127.0.0.1:{hello['port']}"
        deadline = time.time() + 60
        while wurl not in discovery.active_urls():
            if time.time() > deadline or proc.poll() is not None:
                raise AssertionError(f"the subprocess worker never "
                                     f"announced (exit {proc.poll()})")
            time.sleep(0.05)
        boot_s = time.perf_counter() - t0
        client = StatementClient(url, user="cluster")
        sub0 = _worker_kernel_calls(wurl, device)
        for name in ("q1", "q3"):
            CACHE.clear()
            t0 = time.perf_counter()
            with _task_launches(device, launches):
                rows = client.execute(queries[name]).rows
            wall = time.perf_counter() - t0
            _same_rows(rows, _json_rows(cpu_rows[name]), 1e-9,
                       f"cluster {name} over http")
            print(f"cluster {name} over http on {CLUSTER_WORKERS + 1} "
                  f"workers (one a subprocess): {wall:.3f} s cold, rows "
                  f"equal the cpu rows", flush=True)
        sub = {k: v - sub0[k]
               for k, v in _worker_kernel_calls(wurl, device).items()}
        if min(sub.values()) <= 0:
            raise AssertionError(f"the subprocess worker's own launches "
                                 f"{sub}")
        req = urllib.request.Request(
            f"{wurl}/v1/info/state", method="PUT",
            data=json.dumps("SHUTTING_DOWN").encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=30):
            pass
        code = proc.wait(timeout=5.0 + CLUSTER_EXIT_SLACK_S)
        exit_s = time.perf_counter() - t0
        print(f"cluster subprocess worker: booted and announced in "
              f"{boot_s:.3f} s; its /v1/metrics counts its own launches "
              f"{json.dumps(sub)}; drained and exited (code {code}) "
              f"{exit_s:.3f} s after SHUTTING_DOWN (part {lap():.3f} s)",
              flush=True)
        if code != 0:
            raise AssertionError(f"the drained worker exited with {code}")
        srv.stop()
        srv = None

        # (c) the chaos scenarios on the device
        summary = chaos.run_chaos(sf=chaos_sf, device=device,
                                  straggler_sleep_s=straggler_s)
        if not summary.get("ok") or summary.get("orphans") \
                or SPOOL.query_dirs():
            raise AssertionError(f"chaos: {summary}, spool directories "
                                 f"{SPOOL.query_dirs()}")
        print(f"cluster chaos at sf {chaos_sf}: "
              f"{json.dumps(summary['scenarios'])}; 0 spool directories "
              f"left (part {lap():.3f} s)", flush=True)
        CLUSTER_CHAOS.clear()
        CLUSTER_CHAOS.update(summary)
    finally:
        if srv is not None:
            srv.stop()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        runner.detector.stop()
        for w in workers:
            w.stop()
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched inside the workers' "
                             f"tasks: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"cluster launches in the workers' tasks: {json.dumps(launches)}"
          f"; in the subprocess worker {json.dumps(sub)} | phase wall "
          f"{wall:.3f} s ({wall - cpu_s:.3f} s without the cpu reference "
          f"runs)", flush=True)
    return launches, sub


#: the autoscale phase: (a) a coordinator booted from an etc directory with
#: the autoscaler on (AUTOSCALE_MIN_WORKERS .. AUTOSCALE_MAX_WORKERS
#: subprocess workers, one per step, AUTOSCALE_INTERVAL_S ticks,
#: AUTOSCALE_COOLDOWN_S between actions) and one resource group of
#: concurrency 1, AUTOSCALE_CLIENTS clients sending Q3 at AUTOSCALE_SF
#: until the pool is at its ceiling and every worker served, then idle
#: until the pool is back at its floor; (b) the reference's load ramp at
#: RAMP; (c) the preemption storm, scale to zero and the coordinator-fleet
#: drill at CLUSTER_CHAOS_SF
AUTOSCALE_SF = 1
AUTOSCALE_MIN_WORKERS = 1
AUTOSCALE_MAX_WORKERS = 3
AUTOSCALE_INTERVAL_S = 0.5
AUTOSCALE_COOLDOWN_S = 2.0
AUTOSCALE_CLIENTS = 6
#: how long the load may take to grow the pool to its ceiling
AUTOSCALE_LOAD_S = 150.0
#: how long the idle pool may take to drain back to its floor
AUTOSCALE_IDLE_S = 90.0
#: tools/chaos_smoke.py's own ramp parameters (its ELASTIC_r02 run)
RAMP = {"sf": 0.02, "phases": (1, 3, 1), "phase_s": 8.0, "clients": 4,
        "device_floor_ms": 60.0, "rows_per_batch": 16384}


def _write_autoscale_etc(root: str, sf) -> str:
    """An etc directory for an autoscaling coordinator: tpch at ``sf``, a
    spool directory, the autoscale policy, and one group of concurrency 1
    so a load queues. The workers boot from the same directory."""
    etc = os.path.join(root, "etc")
    os.makedirs(os.path.join(etc, "catalog"))
    with open(os.path.join(etc, "catalog", "tpch.properties"), "w") as f:
        f.write(f"connector.name=tpch\ntpch.scale-factor={sf}\n")
    with open(os.path.join(etc, "config.properties"), "w") as f:
        f.write("coordinator=true\nhttp-server.http.port=0\n"
                "session.catalog=tpch\n"
                f"spool.dir={os.path.join(root, 'spool')}\n"
                "autoscale.enabled=true\n"
                f"autoscale.min-workers={AUTOSCALE_MIN_WORKERS}\n"
                f"autoscale.max-workers={AUTOSCALE_MAX_WORKERS}\n"
                "autoscale.scale-step=1\n"
                f"autoscale.interval-s={AUTOSCALE_INTERVAL_S}\n"
                f"autoscale.cooldown-s={AUTOSCALE_COOLDOWN_S}\n")
    with open(os.path.join(etc, "resource-groups.json"), "w") as f:
        json.dump({"rootGroups": [{"name": "autoscale",
                                   "hardConcurrencyLimit": 1,
                                   "maxQueued": 1000}],
                   "selectors": [{"group": "autoscale"}]}, f)
    return etc


def _build_state():
    """The built kernel libraries and their modification times: a worker
    that built a kernel would change them."""
    from presto_tpu_torch.ops import kernels
    if not kernels.BUILD_DIR.exists():
        return {}
    return {p.name: p.stat().st_mtime_ns
            for p in kernels.BUILD_DIR.iterdir()}


def phase_autoscale(torch, tpch_cpu_rows=None, device="cuda", card="",
                    sf=AUTOSCALE_SF, clients=AUTOSCALE_CLIENTS,
                    ramp=RAMP,
                    chaos_sf=CLUSTER_CHAOS_SF, chaos_summary=None,
                    straggler_s=CLUSTER_STRAGGLER_S,
                    rows_per_batch=ROWS_PER_BATCH):
    """The autoscaler on the card (``device="cpu"`` rehearses the phase
    on the CPU at a small ``sf``): (a) a coordinator booted from an etc
    directory with ``autoscale.enabled=true`` scales its subprocess
    workers up under a queue of Q3s and drains them back to the floor
    when idle; (b) the 1 -> N -> 1 load ramp; (c) the preemption storm,
    scale to zero (the cluster phase's run of them when given) and the
    coordinator-fleet drill. Returns the launches of the autoscaled
    workers' own tasks, read from their ``/v1/metrics``."""
    import dataclasses
    import gc
    import tempfile
    import threading

    from presto_tpu_torch._devtools import chaos
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.config import server_from_etc
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.spool import SPOOL
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.obs.signals import cluster_signals
    from presto_tpu_torch.serving.groups import live_managers
    cuda = device == "cuda"
    at = f"[{card}]" if card else f"[{device}]"
    t_phase = time.perf_counter()
    q3 = _queries()["q3"]
    laps = [time.perf_counter()]

    def lap():
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    def counter(name):
        return REGISTRY.counter(name).value

    cpu_q3 = (tpch_cpu_rows or {}).get("q3") if cuda else None
    cpu_s = 0.0
    if cpu_q3 is None:
        cpu_q3 = LocalRunner(tpch_sf=sf, device="cpu",
                             rows_per_batch=rows_per_batch).execute(q3).rows
        cpu_s = lap()
        print(f"autoscale cpu reference rows of q3 {at}: {cpu_s:.3f} s",
              flush=True)
    want = _json_rows(cpu_q3)
    actions = ("scale_up", "scale_down")
    before = {a: counter(f"autoscale_actions_total.{a}") for a in actions}
    evals0 = counter("autoscale_evaluations_total")

    def blocked_counts():
        prefix = "autoscale_blocked_total."
        return {m["name"][len(prefix):]: m["value"]
                for m in REGISTRY.collect()
                if m["name"].startswith(prefix)}
    blocked0 = blocked_counts()
    build0 = _build_state()
    root = tempfile.mkdtemp(prefix="smoke-autoscale-")
    spool_settings = SPOOL.settings()
    gc.collect()
    foreign = sum(1 for m in live_managers())
    launches = dict.fromkeys(("segment_sum_sorted_i64", "direct_probe"), 0)
    per_worker = {}
    srv = None
    try:
        # (a) the config-driven controller
        etc = _write_autoscale_etc(root, sf)
        t0 = time.perf_counter()
        srv, cfg = server_from_etc(etc, device=device)
        boot_s = time.perf_counter() - t0
        ctl, prov, runner = srv.autoscaler, srv.autoscaler.provider, srv.runner
        runner.rows_per_batch = runner.local.rows_per_batch = rows_per_batch
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        t_start = time.perf_counter()
        # the feed's groups and nodes are every server's and cluster's
        # of this process (earlier phases' too): the controller reads
        # this coordinator's own groups and the nodes its discovery knows
        own, stack = set(), list(srv.resource_groups.info())
        while stack:
            g = stack.pop()
            own.add(g["id"])
            stack.extend(g["subGroups"])

        def own_signals():
            snap = cluster_signals()
            known = {n["nodeId"] for n in srv.discovery.nodes()}
            return dataclasses.replace(
                snap, groups=tuple(g for g in snap.groups
                                   if g.group in own),
                nodes=tuple(n for n in snap.nodes if n.node_id in known))
        ctl.signals_fn = own_signals

        events = []         # (seconds since start, what)
        ready = {}          # node id -> seconds to its ready line
        exits = {}          # node id -> (exit code, seconds to exit)
        plain_launch, plain_drain = prov.launch, prov.drain

        def launch():
            t = time.perf_counter()
            h = plain_launch()
            ready[h.node_id] = time.perf_counter() - t
            events.append((time.perf_counter() - t_start,
                           f"launched {h.node_id} "
                           f"(ready {ready[h.node_id]:.3f} s)"))
            return h

        def drain(h, timeout_s=30.0):
            # the worker's own launches, read before it drains
            per_worker[h.node_id] = _worker_kernel_calls(h.url, device)
            t = time.perf_counter()
            ok = plain_drain(h, timeout_s=timeout_s)
            exits[h.node_id] = (h.proc.returncode,
                                time.perf_counter() - t)
            events.append((time.perf_counter() - t_start,
                           f"drained {h.node_id} ({ok}, exit "
                           f"{h.proc.returncode} after "
                           f"{exits[h.node_id][1]:.3f} s)"))
            return ok
        prov.launch, prov.drain = launch, drain
        plain_eval = ctl.evaluate

        def evaluate(signals=None, now=None):
            rep = plain_eval(signals, now)
            for a in rep["applied"]:
                events.append((time.perf_counter() - t_start,
                               f"{a['action']} x{a['count']} "
                               f"({a['reason']})"))
            return rep
        ctl.evaluate = evaluate

        floor = prov.nodes()
        # the boot launched the floor before the wrappers: its ready line
        # came within the boot
        ready.update({h.node_id: boot_s for h in floor})
        deadline = time.time() + 60
        while len(runner.worker_urls) < len(floor):
            if time.time() > deadline:
                raise AssertionError("the floor worker never announced")
            time.sleep(0.05)
        print(f"autoscale boot {at}: server_from_etc seated "
              f"{len(floor)} worker(s) ({', '.join(n.node_id for n in floor)}"
              f") in {boot_s:.3f} s, announced "
              f"{time.perf_counter() - t_start:.3f} s after "
              f"the server started; {foreign} resource-group managers "
              f"live in the process, the controller reads its own groups "
              f"{sorted(own)}", flush=True)

        pool = []           # (seconds, workers, announced, queued)
        sampling = threading.Event()

        def sample():
            last = None
            while not sampling.wait(0.1):
                g = own_signals().group("autoscale")
                cur = (len(prov.nodes()), len(runner.worker_urls),
                       g.queued if g else 0)
                if cur != last:
                    pool.append((time.perf_counter() - t_start, *cur))
                    last = cur
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        walls, errors = [], []
        stop_load = threading.Event()

        def client(i):
            # one client sends Q3 after Q3 until the load stops
            sc = StatementClient(url, user=f"burst-{i}")
            try:
                while not stop_load.is_set():
                    t = time.perf_counter()
                    rows = sc.execute(q3).rows
                    walls.append(time.perf_counter() - t)
                    _same_rows(rows, want, 1e-9,
                               f"autoscale q3 {len(walls)}")
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"client {i}: {type(e).__name__}: {e}")
            finally:
                sc.close()

        def served(h):
            return min(_worker_kernel_calls(h.url, device).values()) > 0
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        try:
            # the load holds until the pool is at its ceiling and every
            # worker, the last joiner too, launched both kernels
            deadline = time.time() + AUTOSCALE_LOAD_S
            while not errors:
                nodes = prov.nodes()
                if len(nodes) >= AUTOSCALE_MAX_WORKERS \
                        and all(served(h) for h in nodes):
                    break
                if time.time() > deadline:
                    raise AssertionError(
                        f"under load the pool reached {len(nodes)} "
                        f"workers in {AUTOSCALE_LOAD_S} s: "
                        f"{ctl.status()}")
                time.sleep(0.5)
        finally:
            stop_load.set()
            for t in threads:
                t.join()
        if errors:
            raise AssertionError(f"load: {errors}")
        burst_s = time.perf_counter() - t_start
        grown = len(prov.nodes())
        print(f"autoscale load {at}: {len(walls)} q3 at sf {sf} from "
              f"{clients} clients over HTTP equal the cpu rows in "
              f"{burst_s:.3f} s (walls {min(walls):.3f}-"
              f"{max(walls):.3f} s, median "
              f"{statistics.median(walls):.3f} s, behind a group of "
              f"concurrency 1); the pool grew to {grown} workers, each "
              f"serving (part {lap():.3f} s)", flush=True)
        deadline = time.time() + AUTOSCALE_IDLE_S
        while len(prov.nodes()) > AUTOSCALE_MIN_WORKERS:
            if time.time() > deadline:
                raise AssertionError(
                    f"the idle pool stayed at {len(prov.nodes())} "
                    f"workers: {ctl.status()}")
            time.sleep(0.1)
        idle_s = time.perf_counter() - t_start
        status = json.loads(_http_get(f"{url}/v1/autoscale"))
        sampling.set()
        sampler.join(timeout=5)
        for h in prov.nodes():
            # the floor: drained like the rest, by the harness
            if not prov.drain(h, timeout_s=60.0):
                raise AssertionError(f"the floor worker {h.node_id} did "
                                     f"not drain")
        moved = {a: counter(f"autoscale_actions_total.{a}") - before[a]
                 for a in actions}
        for line in (f"t+{t:.3f} s {what}" for t, what in events):
            print(f"autoscale action {at}: {line}", flush=True)
        print(f"autoscale pool over time {at} (seconds, workers, "
              f"announced, queued): "
              + "; ".join(f"{t:.2f} {w} {a} {q}" for t, w, a, q in pool),
              flush=True)
        print(f"autoscale status {at}: policy {json.dumps(status['policy'])}, "
              f"streaks {json.dumps(status['streaks'])}, "
              f"{counter('autoscale_evaluations_total') - evals0:.0f} "
              f"evaluations; actions {json.dumps(moved)}; blocked "
              + json.dumps({k: v - blocked0.get(k, 0)
                            for k, v in blocked_counts().items()
                            if v > blocked0.get(k, 0)}), flush=True)
        if min(moved.values()) < 1:
            raise AssertionError(f"the controller's actions {moved}")
        if status["policy"]["maxWorkers"] != AUTOSCALE_MAX_WORKERS \
                or "streaks" not in status:
            raise AssertionError(f"/v1/autoscale: {status}")
        bad = {n: e for n, e in exits.items() if e[0] != 0}
        if bad or len(exits) != len(ready):
            raise AssertionError(f"drained workers' exits {exits}, "
                                 f"launched {sorted(ready)}")
        for node, calls in per_worker.items():
            print(f"autoscale worker {node} {at}: ready line "
                  f"{ready.get(node, boot_s):.3f} s after launch, own "
                  f"launches {json.dumps(calls)}, drained and exited "
                  f"(code {exits[node][0]}) {exits[node][1]:.3f} s after "
                  f"SHUTTING_DOWN", flush=True)
            if min(calls.values()) <= 0:
                raise AssertionError(f"worker {node} launched "
                                     f"{calls}")
            for k, v in calls.items():
                launches[k] += v
        print(f"autoscale controller {at}: grew to {grown} and drained "
              f"back to {AUTOSCALE_MIN_WORKERS} {idle_s - burst_s:.3f} s "
              f"after the load stopped (part {lap():.3f} s)", flush=True)
        srv.stop()
        runner.detector.stop()
        srv = None
        print(f"autoscale coordinator stopped {at} (part {lap():.3f} s)",
              flush=True)

        # (b) the load ramp on subprocess workers
        if ramp is not None:
            ramp_events = []
            t_ramp = time.perf_counter()

            crashed = []

            def on_event(kind, **f):
                ramp_events.append(f"t+{time.perf_counter() - t_ramp:.3f} "
                                   f"s {kind} {json.dumps(f)}")
                if kind == "drain" and f["code"] != 0:
                    crashed.append(f)
            block = chaos.run_elastic_ramp(device=device,
                                           on_event=on_event, **ramp)
            ramp_events.append(f"t+{time.perf_counter() - t_ramp:.3f} s "
                               f"returned")
            for line in ramp_events:
                print(f"autoscale ramp event {at}: {line}", flush=True)
            if crashed:
                raise AssertionError(f"drained ramp workers exited with "
                                     f"{crashed}")
            print(f"autoscale ramp {at}: "
                  + "; ".join(f"{p['workers']} workers {p['qps']} qps "
                              f"({p['queries']} queries, {p['failed']} "
                              f"failed, {p['window_s']} s)"
                              for p in block["phases"])
                  + f"; peak_over_floor {block['peak_over_floor']} "
                  f"(sf {block['sf']}, {block['clients']} clients, "
                  f"device floor {block['device_floor_ms']} ms; part "
                  f"{lap():.3f} s)", flush=True)
        build1 = _build_state()
        if build1 != build0:
            raise AssertionError(f"a worker built a kernel: {build0} -> "
                                 f"{build1}")

        # (c) the drills on the device
        summary = chaos_summary or chaos.run_chaos(
            sf=chaos_sf, device=device, straggler_sleep_s=straggler_s)
        orphans = SPOOL.query_dirs() + SPOOL.object_store.query_dirs()
        if not summary.get("ok") or orphans:
            raise AssertionError(f"chaos: {summary}, spool directories "
                                 f"{orphans}")
        whose = "" if chaos_summary is None else " (the cluster phase's)"
        for name in ("preemption_storm", "scale_to_zero"):
            print(f"autoscale {name} {at} at sf {summary['sf']}{whose}: "
                  f"{json.dumps(summary['scenarios'][name])}", flush=True)
        fleet = chaos.run_fleet_chaos(sf=chaos_sf, device=device)
        print(f"autoscale fleet drill {at} at sf {chaos_sf}: "
              f"{json.dumps(fleet['scenarios']['coordinator_kill'])}; "
              f"elastic recovery {summary['elastic']['value']} ms; 0 spool "
              f"directories left (part {lap():.3f} s)", flush=True)
    finally:
        if srv is not None:
            srv.stop()
            srv.runner.detector.stop()
            srv.autoscaler.provider.stop_all()
        SPOOL.restore(spool_settings)
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"autoscale launches in the autoscaled workers' tasks {at}: "
          f"{json.dumps(launches)} | phase wall {wall:.3f} s "
          f"({wall - cpu_s:.3f} s without the cpu reference run)",
          flush=True)
    return launches



TOOLS_SF = 1
TOOLS_MESH_SLOTS = 4
#: the resource groups of the tools phase's small server: one group
#: under a latency and an availability objective
TOOLS_GROUPS = {
    "rootGroups": [{"name": "tools", "hardConcurrencyLimit": 4,
                    "subGroups": [
                        {"name": "dash", "hardConcurrencyLimit": 2,
                         "slo": {"latencyTargetMs": 2000,
                                 "latencyObjective": 0.95,
                                 "availabilityObjective": 0.99}}]}],
    "selectors": [{"group": "tools.dash"}]}


def _print_profile(doc, at: str) -> None:
    """The profile document's operator table and kernel rows, one line
    each."""
    print(f"tools profile {at}: wall {doc['wall_s']:.6f} s, device "
          f"{json.dumps(doc['device'])}, verdict "
          f"{json.dumps(doc['cost_verdict'])}", flush=True)
    for r in doc["operators"]:
        dev = (f" device {r['device_time_s'] * 1e3:.3f} ms kernels "
               f"{r['kernel_s'] * 1e3:.3f} ms {r['bytes']} B"
               if "device_time_s" in r else "")
        wall = (f" wall {r['wall_s'] * 1e3:.3f} ms self "
                f"{r['self_s'] * 1e3:.3f} ms {r['rows']} rows "
                f"{r['batches']} batches" if "wall_s" in r else "")
        js = f" [{r['join_strategy']}]" if "join_strategy" in r else ""
        print(f"tools op {'  ' * r['depth']}{r['operator'][:90]}{wall}"
              f"{dev}{js}", flush=True)
    for k in doc["kernels"]:
        print(f"tools kernel {k['name']} ({k['source']}): "
              f"{k['launches']} launches, device "
              f"{k['device_time_s'] * 1e3:.4f} ms, "
              f"{k['bytes_per_call']:.0f} B a call", flush=True)


def phase_tools(torch, tpch_cpu_rows=None, device="cuda", sf=TOOLS_SF,
                rows_per_batch=ROWS_PER_BATCH, card=""):
    """The port's reference tools on the card (``device="cpu"``
    rehearses the phase on the CPU at a small ``sf``):
    ``_devtools/profile_query`` of Q3 at ``sf``, warm, whose document
    must list both hand kernels with launches and device seconds and
    whose rows must equal the CPU rows; the same on TOOLS_MESH_SLOTS
    slots of the card, whose flight attribution must pass
    ``_devtools/mesh_report.validate_attribution``; and
    ``_devtools/slo_report.validate_slo_block`` over the live
    ``GET /v1/slo`` block of a small server that served statements in
    an SLO'd group. Reference rows not given are a CPU runner's. Returns
    the launches of the phase."""
    import gc

    from presto_tpu_torch._devtools import mesh_report, slo_report
    from presto_tpu_torch._devtools.profile_query import (
        make_runner, profile_query,
    )
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.obs.slo import SLO
    from presto_tpu_torch.obs.timeseries import TIMESERIES
    from presto_tpu_torch.server import PrestoTpuServer
    t_phase = time.perf_counter()
    at = f"({card})" if card else f"({device})"
    q3 = _queries()["q3"]
    cpu_s = 0.0
    if tpch_cpu_rows is None or device != "cuda":
        t0 = time.perf_counter()
        want = LocalRunner(tpch_sf=sf, device="cpu",
                           rows_per_batch=rows_per_batch).execute(q3).rows
        cpu_s = time.perf_counter() - t0
    else:
        want = tpch_cpu_rows["q3"]
    want = [list(r) for r in _json_rows(want)]
    runner = make_runner("tpch", sf, rows_per_batch, device)
    base = _kernel_calls(device)

    def phase_launches():
        now = _kernel_calls(device)
        return {k: now[k] - base[k] for k in now}

    # (a) Q3, warm: the second run is the profiled one
    doc = profile_query(runner, q3, rows=True)
    _print_profile(doc, at)
    _same_rows(doc["rows"], want, 1e-9, "q3 profile")
    kernels = {k["name"]: k for k in doc["kernels"]}
    if set(kernels) != set(KERNEL_SYMBOLS):
        raise AssertionError(f"the profile lists kernels {sorted(kernels)}"
                             f", not {sorted(KERNEL_SYMBOLS)}")
    for k in kernels.values():
        if k["launches"] <= 0 or k["device_time_s"] <= 0.0:
            raise AssertionError(f"profile kernel row {k}")
    if device == "cuda" and doc["device"]["name"] is None:
        raise AssertionError("the profile names no card")
    # (b) the same query on the card seen as TOOLS_MESH_SLOTS slots
    old = os.environ.get("PRESTO_TPU_TORCH_MESH_SLOTS")
    os.environ["PRESTO_TPU_TORCH_MESH_SLOTS"] = str(TOOLS_MESH_SLOTS)
    copies = {"scanned": 0, "stacked": 0, "stacked_calls": 0}
    try:
        with _mesh_bytes(copies):
            mdoc = profile_query(runner, q3, mesh=TOOLS_MESH_SLOTS,
                                 rows=True)
    finally:
        if old is None:
            os.environ.pop("PRESTO_TPU_TORCH_MESH_SLOTS", None)
        else:
            os.environ["PRESTO_TPU_TORCH_MESH_SLOTS"] = old
    mesh = mdoc["mesh"]
    if not (mesh["selected"] and mesh["n_devices"] == TOOLS_MESH_SLOTS
            and "attribution" in mesh):
        raise AssertionError(f"the mesh profile did not run on "
                             f"{TOOLS_MESH_SLOTS} slots: {mesh}")
    _same_rows(mdoc["rows"], want, 1e-9, "q3 mesh profile")
    verdict = mesh_report.validate_attribution(
        mesh_report.profile_pin(mdoc))
    attr = mesh["attribution"]
    share = attr["buckets"].get("dispatch_overhead", 0.0) / max(
        attr["wall_s"], 1e-12)
    print(f"tools mesh profile {at}: {len(mesh['stages'])} stages, wall "
          f"{mdoc['wall_s']:.6f} s, attribution "
          f"{json.dumps(attr['buckets'])} dominant "
          f"{attr['dominant_bucket']} reconciled {attr['reconciled_pct']}%"
          f", dispatch_overhead {100 * share:.1f}% of "
          f"{attr['wall_s']} s; {copies['stacked']} B stacked onto slot "
          f"0's device in {copies['stacked_calls']} calls over the "
          f"profile's runs, {copies['scanned']} B scanned; mesh_report "
          f"{json.dumps(verdict)}", flush=True)
    if not verdict["ok"] or verdict["blocks"] != 1:
        raise AssertionError(f"mesh_report: {verdict}")
    launches = phase_launches()
    # (c) the live SLO block of a small server that served statements
    gc.collect()                       # stopped servers' groups go
    TIMESERIES.stop()
    TIMESERIES.reset(keep_listeners=False)
    SLO.reset()
    srv = PrestoTpuServer(LocalRunner(tpch_sf=0.01, device=device),
                          resource_groups=TOOLS_GROUPS)
    try:
        for fam in ("serving_latency_seconds", "serving_requests_total",
                    "serving_errors_total"):
            getattr(REGISTRY, "histogram" if fam.endswith("seconds")
                    else "counter")(f"{fam}.tools.dash")
        TIMESERIES.sample()
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        client = StatementClient(url, user="tools")
        for _ in range(3):
            if client.execute("select count(*) from nation").rows != [[25]]:
                raise AssertionError("the SLO server's statement")
        flat = slo_report.live_pin([url])
        slo = slo_report.validate_slo_block(flat)
        print(f"tools slo {at}: {json.dumps(slo)}", flush=True)
        print(slo_report.render(flat, slo), flush=True)
        if not slo["ok"] or slo["blocks"] != 1:
            raise AssertionError(f"slo_report: {slo}")
    finally:
        srv.stop()
        TIMESERIES.stop()
    wall = time.perf_counter() - t_phase
    print(f"tools launches {at}: {json.dumps(launches)} | phase wall "
          f"{wall:.3f} s ({wall - cpu_s:.3f} s without the cpu reference "
          f"run)", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    flags = ("--kernels-only", "--surface-only", "--files-only",
             "--chains-only", "--spill-only", "--statements-only",
             "--mesh-only", "--serving-only", "--frontdoor-only",
             "--cluster-only", "--autoscale-only", "--tools-only")
    if sys.argv[1:] and (len(sys.argv) != 2 or sys.argv[1] not in flags):
        fail("device", f"unknown arguments {sys.argv[1:]}")
    only = sys.argv[1] if len(sys.argv) == 2 else None
    try:
        import torch
    except ImportError as e:
        fail("device", f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    try:
        import presto_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("device", f"the presto_tpu_torch package is missing: {e}")
    try:
        card = phase_device(torch)
    except Exception as e:  # noqa: BLE001 - report the phase, exit nonzero
        fail("device and build", f"{type(e).__name__}: {e}")
    for flag, name, phase in (("--surface-only", "surface", phase_surface),
                              ("--files-only", "files", phase_files),
                              ("--chains-only", "chains", phase_chains),
                              ("--spill-only", "spill", phase_spill),
                              ("--statements-only", "statements",
                               phase_statements),
                              ("--mesh-only", "mesh", phase_mesh),
                              ("--serving-only", "serving",
                               phase_serving),
                              ("--frontdoor-only", "frontdoor",
                               phase_frontdoor),
                              ("--cluster-only", "cluster",
                               phase_cluster),
                              ("--autoscale-only", "autoscale",
                               lambda torch: phase_autoscale(
                                   torch, card=card)),
                              ("--tools-only", "tools",
                               lambda torch: phase_tools(
                                   torch, card=card))):
        if only == flag:
            try:
                phase(torch)
            except Exception as e:  # noqa: BLE001
                fail(name, f"{type(e).__name__}: {e}")
            return
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    try:
        entries = [check_scan(torch, gen), check_probe(torch, gen)]
    except Exception as e:  # noqa: BLE001
        fail("kernels", f"{type(e).__name__}: {e}")
    if only == "--kernels-only":
        print(json.dumps({"kernels": entries}), flush=True)
        return
    try:
        launches, tpch_cpu_rows = phase_path(torch)
    except Exception as e:  # noqa: BLE001
        fail("path", f"{type(e).__name__}: {e}")
    try:
        tpch_launches, tpch_cpu_more = phase_tpch(torch)
    except Exception as e:  # noqa: BLE001
        fail("tpch", f"{type(e).__name__}: {e}")
    try:
        tpcds_launches, tpcds_cpu_rows, battery_cpu_rows = \
            phase_tpcds(torch)
    except Exception as e:  # noqa: BLE001
        fail("tpcds", f"{type(e).__name__}: {e}")
    try:
        scan_launches = phase_scan(torch, tpch_cpu_rows, tpcds_cpu_rows)
    except Exception as e:  # noqa: BLE001
        fail("scan", f"{type(e).__name__}: {e}")
    try:
        surface_launches = phase_surface(torch)
    except Exception as e:  # noqa: BLE001
        fail("surface", f"{type(e).__name__}: {e}")
    try:
        files_launches = phase_files(torch)
    except Exception as e:  # noqa: BLE001
        fail("files", f"{type(e).__name__}: {e}")
    try:
        chains_launches = phase_chains(
            torch, {**tpch_cpu_rows, **tpch_cpu_more},
            tpcds_cpu_rows["q27"])
    except Exception as e:  # noqa: BLE001
        fail("chains", f"{type(e).__name__}: {e}")
    try:
        spill_launches = phase_spill(torch)
    except Exception as e:  # noqa: BLE001
        fail("spill", f"{type(e).__name__}: {e}")
    try:
        statements_launches = phase_statements(torch, dict(tpch_cpu_rows))
    except Exception as e:  # noqa: BLE001
        fail("statements", f"{type(e).__name__}: {e}")
    try:
        mesh_launches, mesh_slots = phase_mesh(
            torch, {**tpch_cpu_rows, **tpch_cpu_more}, battery_cpu_rows)
    except Exception as e:  # noqa: BLE001
        fail("mesh", f"{type(e).__name__}: {e}")
    try:
        serving_launches = phase_serving(torch, dict(tpch_cpu_rows))
    except Exception as e:  # noqa: BLE001
        fail("serving", f"{type(e).__name__}: {e}")
    try:
        frontdoor_launches = phase_frontdoor(
            torch, {**tpch_cpu_rows, **tpch_cpu_more})
    except Exception as e:  # noqa: BLE001
        fail("frontdoor", f"{type(e).__name__}: {e}")
    try:
        task_launches, sub_launches = phase_cluster(
            torch, {**tpch_cpu_rows, **tpch_cpu_more},
            local_walls=LOCAL_COLD_WALLS)
    except Exception as e:  # noqa: BLE001
        fail("cluster", f"{type(e).__name__}: {e}")
    cluster_launches = {k: v + sub_launches[k]
                        for k, v in task_launches.items()}
    try:
        autoscale_launches = phase_autoscale(
            torch, {**tpch_cpu_rows, **tpch_cpu_more}, card=card,
            chaos_summary=CLUSTER_CHAOS or None)
    except Exception as e:  # noqa: BLE001
        fail("autoscale", f"{type(e).__name__}: {e}")
    try:
        tools_launches = phase_tools(torch, dict(tpch_cpu_rows), card=card)
    except Exception as e:  # noqa: BLE001
        fail("tools", f"{type(e).__name__}: {e}")
    for entry in entries:
        # launches over every phase that drives the engine: path, tpch,
        # tpcds, scan, surface, files, chains, spill, statements, mesh,
        # serving, frontdoor, cluster, autoscale and tools
        entry["launches"] = sum(p[entry["name"]] for p in (
            launches, tpch_launches, tpcds_launches, scan_launches,
            surface_launches, files_launches, chains_launches,
            spill_launches, statements_launches, mesh_launches,
            serving_launches, frontdoor_launches, cluster_launches,
            autoscale_launches, tools_launches))
        # the profiled Q3 runs of the tools phase
        entry["tools_launches"] = tools_launches[entry["name"]]
        # the autoscaled subprocess workers' own, from their /v1/metrics
        entry["autoscale_launches"] = autoscale_launches[entry["name"]]
        entry["serving_launches"] = serving_launches[entry["name"]]
        entry["frontdoor_launches"] = frontdoor_launches[entry["name"]]
        # the workers' tasks: in this process and in the subprocess
        # worker (counted there, read from its /v1/metrics)
        entry["cluster_launches"] = cluster_launches[entry["name"]]
        entry["cluster_subprocess_launches"] = sub_launches[entry["name"]]
        # the mesh runs' share, and its split over the slots
        entry["mesh_launches"] = mesh_launches[entry["name"]]
        entry["mesh_slot_launches"] = mesh_slots[entry["name"]]
    print(f"total wall {time.perf_counter() - t_start:.3f} s", flush=True)
    # the card line again, so a log kept only from its tail still has it
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
