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
   peak device memory and the launches of each kernel; then q55 and q27
   at SF10 (``store_sales`` 28.8 M rows, four batches), cold and warm
   on ``cuda``, against the CPU run; fails if the probe never launched
   in the phase, reports the segment sum's launches, and breaks down the
   slowest of those queries' walls;
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
   memory and the launches of each kernel, and fails unless both kernels
   launched in the phase;
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

Every breakdown line times the plan's table scans twice: with the scan
cache cleared (host generation and the copy to the card) and as a warm
replay of the cached splits.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or presto_tpu.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 2 alone and
prints the kernels line; ``--surface-only`` runs phases 1 and 7 alone,
``--files-only`` phases 1 and 8, ``--chains-only`` phases 1 and 9,
``--spill-only`` phases 1 and 10, ``--statements-only`` phases 1 and 11
(each computes its CPU reference rows itself).
Either times whichever ``presto_tpu_torch`` sits beside the script, so
a copy of the script placed in a checkout of another commit measures
that commit (turn by turn with this one, in one call, to compare them).
"""
from __future__ import annotations

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


def _same_rows(gpu_rows, cpu_rows, rel: float) -> None:
    if len(gpu_rows) != len(cpu_rows):
        raise AssertionError(f"{len(gpu_rows)} rows on cuda, "
                             f"{len(cpu_rows)} on cpu")
    for i, (a, b) in enumerate(zip(gpu_rows, cpu_rows)):
        for u, v in zip(a, b):
            if isinstance(u, float):
                if not (math.isfinite(u) and abs(u - v) <= rel * abs(v)):
                    raise AssertionError(f"row {i}: {u!r} vs {v!r}")
            elif u != v:
                raise AssertionError(f"row {i}: {u!r} vs {v!r}")


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
    port's CPU run; then q55 and q27 at SF10, cold and warm."""
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
    walls = {}
    for name, sql in queries.items():
        res, walls[name], peak_gb, counts = on_card(gpu, sql)
        ref, cpu_s = on_cpu(cpu, sql)
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
    gpu, cpu = runners(TPCDS_BIG_SF)
    cpu_rows = {}
    for name in ("q55", "q27"):
        cold, cold_s, cold_gb, cold_n = on_card(gpu, queries[name])
        warm, warm_s, warm_gb, warm_n = on_card(gpu, queries[name],
                                                cold=False)
        ref, cpu_s = on_cpu(cpu, queries[name])
        cpu_rows[name] = ref.rows
        _same_rows(cold.rows, ref.rows, 1e-9)
        _same_rows(warm.rows, ref.rows, 1e-9)
        if not ref.rows:
            raise AssertionError(f"{name} at SF{TPCDS_BIG_SF} has no rows")
        print(f"tpcds sf{TPCDS_BIG_SF} {name}: cuda cold {cold_s:.3f} s "
              f"warm {warm_s:.3f} s | cpu {cpu_s:.3f} s | {len(ref.rows)} "
              f"rows match the cpu run | peak {max(cold_gb, warm_gb):.2f} "
              f"GiB | launches (cold+warm) scan {cold_n[0] + warm_n[0]} "
              f"probe {cold_n[1] + warm_n[1]}", flush=True)
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"tpcds launches: {json.dumps(launches)}", flush=True)
    if launches["direct_probe"] <= 0:
        raise AssertionError("the probe kernel never launched in the phase")
    return launches, cpu_rows


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
    launches = {"segment_sum_sorted_i64": scan.launches,
                "direct_probe": probe.launches}
    print(f"surface launches: {json.dumps(launches)} | phase wall "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel never launched in the surface phase")
    return launches


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


def main() -> None:
    t_start = time.perf_counter()
    flags = ("--kernels-only", "--surface-only", "--files-only",
             "--chains-only", "--spill-only", "--statements-only")
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
                               phase_statements)):
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
        tpcds_launches, tpcds_cpu_rows = phase_tpcds(torch)
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
    for entry in entries:
        # launches over every phase that drives the engine: path, tpch,
        # tpcds, scan, surface, files, chains, spill and statements
        entry["launches"] = sum(p[entry["name"]] for p in (
            launches, tpch_launches, tpcds_launches, scan_launches,
            surface_launches, files_launches, chains_launches,
            spill_launches, statements_launches))
    print(f"total wall {time.perf_counter() - t_start:.3f} s", flush=True)
    # the card line again, so a log kept only from its tail still has it
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
