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
   it at SF1
   and holds its result bit for bit against the kernel's plain PyTorch
   version on the same inputs; times kernel, plain version and one
   PyTorch library call computing the same function (CUDA events, median
   of several runs after warm-up) and works out each kernel's bound;
3. path: with every launch count set to 0, runs TPC-H Q6, Q1 and Q3 at
   SF1 through ``LocalRunner(tpch_sf=1, rows_per_batch=2**23)`` on
   ``cuda`` (cold, then warm; one batch holds all 6 M lineitem rows),
   reads the counts, fails if a kernel of the path never launched (both
   must launch during Q3), and compares each result with the port's own
   ``device="cpu"`` run: integers, dates and strings exactly, doubles
   within rel 1e-9 (the GPU's atomic float adds sum in another order).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or presto_tpu.
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


def check_scan(torch, gen):
    from presto_tpu_torch.ops import scan
    # bit-exactness at 2^23 lanes, with few long runs and with a million
    # short ones; timing at the shape Q3's partial aggregation gives the
    # kernel at SF1 (a 2^18-lane compacted join output, ~150 K live rows,
    # ~56.5 K groups), and at 2^23 short runs
    n = 1 << 23
    live = 6_000_000
    cases = {"few_long_runs": (n, _runs_case(torch, gen, n, live, 64)),
             "short_runs": (n, _runs_case(torch, gen, n, live, 1 << 20)),
             "q3_partial": (1 << 18, _runs_case(torch, gen, 1 << 18,
                                                150_000, 56_552))}
    errs = []
    for name, (size, (values, starts, _)) in cases.items():
        got = scan.segment_sum_sorted_i64(values, starts, size)
        want = scan.segment_sum_sorted_plain(values, starts, size)
        torch.cuda.synchronize()
        groups = int((starts < size).sum())
        if not torch.equal(got[:groups], want[:groups]):
            bad = int((got[:groups] != want[:groups]).sum())
            raise AssertionError(f"segment sum {name}: {bad} groups differ")
        errs.append(int((got[:groups] - want[:groups]).abs().max()))
        print(f"segment_sum_sorted_i64 {name}: n={size} groups={groups} "
              "bit-exact", flush=True)

    def timed(size, values, starts, gid):
        ms = median_ms(lambda: scan.segment_sum_sorted_i64(
            values, starts, size), torch)
        plain_ms = median_ms(lambda: scan.segment_sum_sorted_plain(
            values, starts, size), torch)
        lib_ms = median_ms(lambda: torch.zeros(
            size, dtype=torch.int64, device=values.device)
            .index_add_(0, gid, values), torch)
        bytes_moved = 8 * size + 4 * size + 8 * size  # values, starts, sums
        return ms, plain_ms, lib_ms, bytes_moved / HBM_BYTES_PER_S * 1e3

    big = timed(n, *cases["short_runs"][1])
    ms, plain_ms, lib_ms, bound_ms = timed(1 << 18, *cases["q3_partial"][1])
    return {"name": "segment_sum_sorted_i64", "route": "cuda",
            "source": "presto_tpu_torch/csrc/scan.cu",
            "replaces": "presto_tpu/ops/pallas_scan.py:85",
            "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "ok": True,
            "shape": "n=262144 segments=262144 runs=56552",
            "n2p23_ms": big[0], "n2p23_plain_ms": big[1],
            "n2p23_library_ms": big[2], "n2p23_bound_ms": big[3]}


def check_probe(torch, gen):
    from presto_tpu_torch.ops import probe
    dev = torch.device("cuda")
    # Q3's lineitem x orders probe at SF1 in one batch: 6 M lineitem rows
    # in a 2^23-lane batch of which ~54% pass the ship-date filter,
    # orders keys 1..1.5 M in a 2^21-slot table, the ~730 K orders rows
    # that pass the date filter in a 2^20-row compacted build
    n, size, n_build = 1 << 23, 1 << 21, 1 << 20
    key_span, live_build, rows = 1_500_000, 727_000, 6_000_000
    keys = torch.sort(torch.randperm(key_span, generator=gen, device=dev)
                      [:live_build]).values
    lo_table = torch.full((size,), n_build, dtype=torch.int32, device=dev)
    lo_table[keys] = torch.arange(live_build, dtype=torch.int32, device=dev)
    cnt_table = torch.zeros(size, dtype=torch.int32, device=dev)
    cnt_table[keys] = 1
    codes = torch.randint(0, key_span, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    codes[rows:] = -1
    codes[torch.rand(n, generator=gen, device=dev) >= 0.54] = -1
    vbits = torch.randint(0, 1 << 6, (n_build,), generator=gen, device=dev,
                          dtype=torch.int32)
    i64 = torch.randint(-(1 << 62), 1 << 62, (n_build,), generator=gen,
                        device=dev, dtype=torch.int64)
    payload = [
        torch.rand(n_build, generator=gen, device=dev) < 0.5,        # bool
        torch.randint(-(1 << 30), 1 << 30, (n_build,), generator=gen,
                      device=dev, dtype=torch.int32),                 # int
        torch.randint(0, 5, (n_build,), generator=gen, device=dev,
                      dtype=torch.int32),                             # code
        i64,                                                          # bigint
        torch.randn(n_build, generator=gen, device=dev,
                    dtype=torch.float64) * 1e9,                       # double
        torch.stack([i64 >> 3, i64], dim=1),                          # int128
    ]
    got = probe.direct_probe(codes, lo_table, cnt_table, vbits, payload)
    want = probe.direct_probe_plain(codes, lo_table, cnt_table, vbits,
                                    payload)
    torch.cuda.synchronize()

    def bits(t):
        if t.dtype == torch.float64:
            return t.view(torch.int64)
        return t.to(torch.int64) if t.dtype == torch.bool else t
    pairs = [(got[0], want[0]), (got[1], want[1])] + list(zip(got[2],
                                                              want[2]))
    err = 0
    for i, (a, b) in enumerate(pairs):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"probe output {i} differs")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()))
    live = int((codes >= 0).sum())
    hits = int((got[0] > 0).sum())
    print(f"direct_probe: n={n} slots={size} build={n_build} live={live} "
          f"hits={hits} bit-exact", flush=True)
    ms = median_ms(lambda: probe.direct_probe(codes, lo_table, cnt_table,
                                              vbits, payload), torch)
    plain_ms = median_ms(lambda: probe.direct_probe_plain(
        codes, lo_table, cnt_table, vbits, payload), torch)
    pos = torch.where(want[0] > 0, lo_table[codes.clamp(min=0).long()],
                      0).long()
    lib_ms = median_ms(lambda: [p.index_select(0, pos) for p in payload],
                       torch)
    widths = sum(p.element_size() * (p.shape[1] if p.ndim == 2 else 1)
                 for p in payload)
    bytes_moved = (4 * n + 8 * live            # codes, lo/cnt of live lanes
                   + hits * (4 + widths)       # vbits + payload gathered
                   + n * (4 + 4 + widths))     # cnt, vb, payload written
    return {"name": "direct_probe", "route": "cuda",
            "source": "presto_tpu_torch/csrc/probe.cu",
            "replaces": "presto_tpu/ops/pallas_join.py:218",
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "ok": True,
            "shape": f"n={n} slots={size} build={n_build} live={live} "
                     f"cols={len(payload)}"}


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
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import probe, scan
    queries = _queries()
    # one 2^23-lane batch holds all of SF1's 6 M lineitem rows
    gpu = LocalRunner(tpch_sf=1, rows_per_batch=ROWS_PER_BATCH)
    cpu = LocalRunner(tpch_sf=1, device="cpu", rows_per_batch=ROWS_PER_BATCH)
    results = {}
    scan.launches = 0
    probe.launches = 0
    q3_launches = None
    for name in ("q6", "q1", "q3"):
        before = (scan.launches, probe.launches)
        walls = []
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
        _same_rows(res.rows, ref.rows, 1e-9)
        print(f"{name}: cuda cold {walls[0]:.3f} s warm {walls[1]:.3f} s | "
              f"cpu {cpu_s:.3f} s | {len(res.rows)} rows match the cpu run",
              flush=True)
    q3_all = queries["q3"].replace("limit 10", "")
    print(f"q3 groups before LIMIT 10 at SF1: "
          f"{len(gpu.execute(q3_all).rows)}", flush=True)
    for name in ("q6", "q1", "q3"):
        _breakdown(torch, gpu, name, queries[name])
    return launches


def _breakdown(torch, runner, name, sql) -> None:
    """Where a warm query's time goes: the wall of its table scans alone
    (host generation + copy to the card), and the card's busy time from
    torch.profiler's CUDA kernel records. Informational: a profiler
    that records nothing prints 'not measured' and fails no phase."""
    from presto_tpu_torch.exec.local import _Executor
    from presto_tpu_torch.planner.plan import TableScanNode
    plan = runner.plan(sql)
    scans, stack = [], [plan.root]
    while stack:
        node = stack.pop()
        if isinstance(node, TableScanNode):
            scans.append(node)
        stack.extend(node.children)
    ex = _Executor(runner.session, runner.rows_per_batch, runner.device)
    t0 = time.perf_counter()
    for node in scans:
        for _ in ex.run(node):
            pass
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    busy = "not measured"
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.execute(sql)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if dev_us > 0:
            busy = (f"{dev_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms profiled "
                    f"wall ({100 * dev_us / 1e6 / wall:.2f}% busy)")
    except Exception as e:  # noqa: BLE001 - informational only
        busy = f"not measured ({type(e).__name__}: {e})"
    print(f"{name} breakdown: scans alone {scan_s:.3f} s; card busy {busy}",
          flush=True)


def _queries():
    """TPC-H Q6, Q1 and Q3 as the test suite carries them."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from tpch_queries import Q
    return {n: sql for n, sql, _ in Q if n in ("q1", "q3", "q6")}


def main() -> None:
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
    try:
        launches = phase_path(torch)
    except Exception as e:  # noqa: BLE001
        fail("path", f"{type(e).__name__}: {e}")
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
