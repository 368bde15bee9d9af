"""One run of one cell: set-up, the timed window, the comparison with the
plain reference, the result line.

``main`` is the command's entry; ``run_cell`` does the work on any
device, so the tests drive a whole run on the CPU at a small scale.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from . import compare, spec, trace as tracing, traffic
from .loop import ClosedLoop, Statement, run_all

#: modules that no process of the benchmark may hold (top-level names)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "presto_tpu"})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What the metric readers read (``metrics/<name>.py``)."""
    seconds: float
    setup_s: float
    statements: List[Statement]
    counters: Dict[str, float]          # deltas over the window
    query_mem_bytes: Optional[int]      # None off the card
    slice: Optional[tracing.Slice]
    device_name: str
    window_epoch: float                 # epoch seconds at the window's start
    _out: Optional[Callable[[float], bool]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def completed(self) -> List[Statement]:
        """Statements that came back, without error, inside the window."""
        return [s for s in self.statements if s.done is not None
                and s.error is None and s.done <= self.seconds]

    def out_at(self, epoch_s: float) -> bool:
        """Whether a statement was out (sent and not yet back) then."""
        if self._out is None:
            self._out = tracing.cover((s.sent, s.done)
                                      for s in self.statements)
        return self._out(epoch_s - self.window_epoch)


def _counters() -> Dict[str, float]:
    """The program's registry now: every counter under its own name, each
    histogram's count and sum as ``<name>.count`` and ``<name>.sum`` (the
    registry's snapshot names), and the scan cache's two counters again
    under the keys that ``scan_cache_hit_pct`` reads."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    out: Dict[str, float] = {}
    for m in REGISTRY.collect():
        if m["kind"] == "counter":
            out[m["name"]] = m["value"]
        elif m["kind"] == "histogram":
            out[m["name"] + ".count"] = m["count"]
            out[m["name"] + ".sum"] = m["sum"]
    out["scan_cache_hits"] = out.get("scan_cache_hit_total", 0.0)
    out["scan_cache_misses"] = out.get("scan_cache_miss_total", 0.0)
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _judge(statements: List[Statement], suite: str, sf: float,
           device, limit_gap: float) -> Dict[str, Dict]:
    """Compare every statement sent in the window with the reference of
    its parameter set, computed once per set."""
    import torch
    data = spec.reference_tables(suite).Data(sf, device)
    answers = {}
    failed = mismatched = 0
    worst = 0.0
    for st in statements:
        if st.error is not None or st.done is None:
            failed += 1
            continue
        inst = st.instance
        ref = spec.reference(suite, inst.template)
        if inst.key not in answers:
            answers[inst.key] = ref.answer(data, inst.params,
                                           torch.float64)
        v = compare.judge(st.rows, answers[inst.key], ref.ORDER_BY)
        if v.gap > limit_gap and v.gap > worst:
            log(f"gap {v.gap!r} {inst.template} {inst.params}: row, column, "
                f"value, reference {v.worst}")
        worst = max(worst, v.gap)
        if not v.matched:
            mismatched += 1
            if mismatched <= 3:
                log(f"mismatch {inst.template} {inst.params}: {v.why}")
    data.free()
    if not math.isfinite(worst):
        worst = 1e300        # JSON has no infinity
    if not statements:
        failed += 1          # nothing came back: nothing to call correct
    return {"failed_statements": {"value": failed, "limit": 0},
            "mismatched_statements": {"value": mismatched, "limit": 0},
            "max_rel_gap": {"value": worst, "limit": limit_gap}}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float,
             overrides: Optional[Dict] = None) -> Dict:
    """Run the cell and return the result line's object. ``overrides``
    replaces configuration keys (the tests' small scale)."""
    import torch
    from presto_tpu_torch.config import apply_node_config
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.exec.scancache import CACHE
    from presto_tpu_torch.ops import kernels

    cfg = {**cell.config, **(overrides or {})}
    on_card = device.startswith("cuda")
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        log("card", power_limit() or name)
        kernels.build()
    apply_node_config({k: str(v) for k, v in cfg.get("node", {}).items()})
    runner = LocalRunner(catalog=cfg["catalog"], tpch_sf=cfg["scale_factor"],
                         device=device, rows_per_batch=cfg["rows_per_batch"])
    props = cfg.get("session") or None

    def execute(sql: str):
        return runner.execute(sql, properties=props).rows

    warm = traffic.warm(cfg["suite"], cell.traffic, seed)
    clients = int(cell.traffic["clients"])
    t = time.perf_counter()
    log(f"set-up before the warm pass {t - t_start:.3f} s")
    run_all(execute, [warm[c::clients] for c in range(clients)])
    log(f"warm pass of {len(warm)} statements "
        f"{time.perf_counter() - t:.3f} s; resident "
        f"{CACHE.resident_bytes(device)} B")
    sequences = [traffic.sequence(cfg["suite"], cell.traffic, seed, c)
                 for c in range(clients)]
    recorder = tracing.Recorder(device) if trace and on_card else None
    if recorder is not None:
        recorder.prepare()
    loop = ClosedLoop(execute, sequences, seconds)
    setup_peak = base = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    c0 = _counters()
    setup_s = time.perf_counter() - t_start
    window_epoch = time.time()
    loop.start()
    sliced = None
    if recorder is not None:
        time.sleep(max(0.0, tracing.SLICE[0] * seconds - loop.now()))
        recorder.start()
        time.sleep(max(0.0, tracing.SLICE[1] * seconds - loop.now()))
        t = time.perf_counter()
        sliced = recorder.stop()
        log(f"traced slice stopped and read {time.perf_counter() - t:.3f} s")
    came_back = loop.wait()
    c1 = _counters()
    statements = list(loop.statements)
    for tmpl in sorted({s.instance.template for s in statements}):
        lat = sorted(s.done - s.sent for s in statements
                     if s.instance.template == tmpl and s.done is not None)
        if lat:
            log(f"{tmpl}: {len(lat)} statements, latency median "
                f"{1000 * lat[len(lat) // 2]:.1f} ms, max "
                f"{1000 * lat[-1]:.1f} ms")
    slow = sorted((s for s in statements if s.done is not None),
                  key=lambda s: s.sent - s.done)[:5]
    log("slowest: " + "; ".join(
        f"{s.instance.template} {s.instance.params} client {s.client} sent "
        f"{s.sent:.2f} s took {s.done - s.sent:.2f} s" for s in slow))
    query_mem = peak = None
    if on_card:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, window_peak)
        query_mem = window_peak - base
    # the engine's state goes before the reference runs on the card
    CACHE.clear()
    del runner, execute, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = _judge(statements, cfg["suite"], cfg["scale_factor"],
                    device, float(cfg["compare"]["max_rel_gap"]))
    if not came_back:
        checks["failed_statements"]["value"] += 1
    log(f"reference and comparison {time.perf_counter() - t:.3f} s over "
        f"{len(statements)} statements")
    ctx = Context(float(seconds), setup_s, statements,
                  {k: c1[k] - c0.get(k, 0.0) for k in c1}, query_mem,
                  sliced, name, window_epoch)
    reduced = None
    if sliced is not None:
        t = time.perf_counter()
        busy, gaps = sliced.busy()
        reduced = tracing.breakdown(sliced, ctx.out_at)
        log(f"reduction of the traced slice {time.perf_counter() - t:.3f} s "
            f"over {len(sliced.records)} CUDA records, {len(gaps)} idle "
            f"gaps, {len(sliced.spans)} spans, {len(sliced.launches)} "
            f"launch records, {len(statements)} statements; slice "
            f"{sliced.seconds:.3f} s, busy {busy / 1e9:.3f} s")
    metrics = {}
    for m in cell.metrics:
        if (m.kind == "per_layer") != bool(trace):
            continue
        t = time.perf_counter()
        value = spec.metric_reader(m.name).read(ctx)
        log(f"metric {m.name} read in {time.perf_counter() - t:.3f} s")
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": len(statements),
              "failed": sum(1 for s in statements
                            if s.error is not None or s.done is None),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": name, "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if reduced is not None:
        result["device"]["busy_s"] = busy / 1e9
        result["device"]["window_s"] = sliced.seconds
        result["breakdown"] = reduced
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(spec.HERE.parent, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        log("the process holds forbidden modules: " + ", ".join(found))
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    for v in result["metrics"].values():
        if not math.isfinite(v["value"]):
            log("a metric is not finite:", result["metrics"])
            return 4
    print(json.dumps(result), flush=True)
    return 0
