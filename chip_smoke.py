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
   joins, windows, correlated and scalar subqueries) at SF1 through
   ``LocalRunner(tpch_sf=1, catalog="tpcds", rows_per_batch=2**23)`` on
   ``cuda`` (one cold run each) against the port's ``device="cpu"`` run
   as above, printing per query the cuda and cpu walls, the rows, the
   peak device memory and the launches of each kernel; then q55 and q27
   at SF10 (``store_sales`` 28.8 M rows, four batches), cold and warm
   on ``cuda``, against the CPU run; fails if the probe never launched
   in the phase, reports the segment sum's launches, and breaks down the
   slowest SF1 query's wall;
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
   either kernel never launched in the phase.

Every breakdown line times the plan's table scans twice: with the scan
cache cleared (host generation and the copy to the card) and as a warm
replay of the cached splits.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or presto_tpu.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 2 alone and
prints the kernels line. It times the kernels of whichever
``presto_tpu_torch`` sits beside the script, so a copy of the script
placed in a checkout of another commit times that commit's kernels.
"""
from __future__ import annotations

import json
import math
import os
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
#: runs them
TPCDS_SF, TPCDS_BIG_SF = 1, 10
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
#: rows a block of csrc/scan.cu sums (ops/scan.py TILE_ROWS); a constant
#: here so that the script also times kernels of commits that predate it
SCAN_TILE_ROWS = 2048


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
    walls = {}
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
    return launches


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
    """q27 and the TPC-DS battery at SF1 on the card, each against the
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


def main() -> None:
    t_start = time.perf_counter()
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        fail("device", f"unknown arguments {sys.argv[1:]}")
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
        phase_device(torch)
    except Exception as e:  # noqa: BLE001 - report the phase, exit nonzero
        fail("device and build", f"{type(e).__name__}: {e}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    try:
        entries = [check_scan(torch, gen), check_probe(torch, gen)]
    except Exception as e:  # noqa: BLE001
        fail("kernels", f"{type(e).__name__}: {e}")
    if kernels_only:
        print(json.dumps({"kernels": entries}), flush=True)
        return
    try:
        launches, tpch_cpu_rows = phase_path(torch)
    except Exception as e:  # noqa: BLE001
        fail("path", f"{type(e).__name__}: {e}")
    try:
        tpch_launches = phase_tpch(torch)
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
    for entry in entries:
        # launches over every phase that drives the engine: path, tpch,
        # tpcds and scan
        entry["launches"] = sum(p[entry["name"]] for p in (
            launches, tpch_launches, tpcds_launches, scan_launches))
    print(f"total wall {time.perf_counter() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
