"""Bucket-level diff of two mesh flight attributions, and the per-bucket
overhead budgets.

The counterpart of the JAX package's ``tools/mesh_report.py``. A mesh
query's flight recorder (``obs/flight.py``) finishes with an
``attribution`` block: wall-clock seconds per bucket (``device_compute``
/ ``dispatch_overhead`` / ``host_staging`` / ``control_sync`` /
``repartition`` / ``stall``), the dominant bucket, the reconciled
fraction and the per-shard critical path. This module checks a block's
schema and budgets (:func:`validate_attribution`) and diffs two
documents bucket by bucket (:func:`diff_pins`), so "q3 on 4 slots got
1.3x faster" decomposes into "repartition dropped 800 ms, dispatch
unchanged".

It reads pinned MULTICHIP files, profile documents of
``_devtools/profile_query.py --mesh N`` (their ``mesh.attribution``), or
the attributions this process's flight recorder finished
(``obs/flight.FLIGHTS``, :func:`live_pin`).

Usage::

    python -m presto_tpu_torch._devtools.mesh_report OLD.json NEW.json
    python -m presto_tpu_torch._devtools.mesh_report OLD NEW --json report.json

Documents without attribution blocks diff as ``no attribution`` and pass
the budgets vacuously. Exit 0 when the NEW document's attribution passes
schema and budgets (or has none), 1 on violations, 2 on usage or IO
errors.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

#: attribution bucket names, display order (``obs/flight.BUCKETS``)
BUCKETS = ("device_compute", "dispatch_overhead", "host_staging",
           "control_sync", "repartition", "stall")

#: per-bucket budget: the most of a query's wall (percent) an overhead
#: bucket may take. ``device_compute`` is the useful work and has none;
#: ``dispatch_overhead`` also holds whatever device work a dispatch call
#: waits for, so its budget stays high; ``control_sync`` is the bucket a
#: control-plane regression moves.
BUCKET_BUDGET_PCT: Dict[str, float] = {
    "dispatch_overhead": 90.0,
    "host_staging": 80.0,
    "control_sync": 25.0,
    "repartition": 85.0,
    "stall": 60.0,
}

#: the keys of one attribution block (``obs/flight.FlightRecorder.finish``)
_REQUIRED = ("query_id", "n_devices", "wall_s", "rounds", "buckets",
             "dominant_bucket", "reconciled_pct", "overhead_s",
             "critical_path")


def load_pin(path: str) -> Dict[str, Dict]:
    """{metric: record} from a MULTICHIP pin: a committed ``_r*``
    wrapper (use its ``parsed``) or a bare ``MULTICHIP_OUT`` summary."""
    with open(path) as f:
        doc = json.loads(f.read().strip())
    if isinstance(doc, dict) and "parsed" in doc:
        doc = doc["parsed"]
    out: Dict[str, Dict] = {}
    if not isinstance(doc, dict) or "metric" not in doc:
        raise ValueError(f"{path}: not a MULTICHIP summary")
    out[doc["metric"]] = {k: v for k, v in doc.items()
                          if k != "sub_metrics"}
    for sub in doc.get("sub_metrics") or ():
        if isinstance(sub, dict) and "metric" in sub:
            out[sub["metric"]] = sub
    return out


def _check_block(metric: str, attr: object,
                 violations: List[Dict]) -> None:
    """Schema + budget checks for ONE attribution block; appends any
    violations (each ``{"metric", "kind", "detail"}``)."""

    def bad(kind: str, detail: str) -> None:
        violations.append({"metric": metric, "kind": kind,
                           "detail": detail})

    if not isinstance(attr, dict):
        return bad("schema", "attribution is not an object")
    missing = [k for k in _REQUIRED if k not in attr]
    if missing:
        return bad("schema", f"missing keys: {', '.join(missing)}")
    buckets = attr["buckets"]
    if not isinstance(buckets, dict) or \
            sorted(buckets) != sorted(BUCKETS):
        return bad("schema", "buckets must carry exactly "
                             f"{'/'.join(BUCKETS)}")
    for b, s in buckets.items():
        if not isinstance(s, (int, float)) or s < 0:
            return bad("schema", f"bucket {b} is not a "
                                 "non-negative number")
    if attr["dominant_bucket"] not in BUCKETS:
        bad("schema", f"dominant_bucket {attr['dominant_bucket']!r} "
                      "is not a bucket")
    wall = float(attr["wall_s"] or 0.0)
    if wall <= 0:
        return bad("schema", "wall_s must be positive")
    cp = attr["critical_path"]
    if not isinstance(cp, dict) or \
            not isinstance(cp.get("per_shard_s"), list) or \
            len(cp["per_shard_s"]) != int(attr["n_devices"]):
        bad("schema", "critical_path.per_shard_s must list one entry "
                      "per device")
    for b, budget in BUCKET_BUDGET_PCT.items():
        share = float(buckets.get(b, 0.0)) / wall * 100.0
        if share > budget:
            bad("budget", f"{b} at {share:.1f}% of wall exceeds the "
                          f"{budget:g}% budget")


def validate_attribution(flat: Dict[str, Dict]) -> Dict:
    """Schema-validate + budget-check every attribution block in a
    flattened pin. Pins without any block pass vacuously (pre-r07
    history). Returns ``{"blocks", "violations", "ok"}``."""
    violations: List[Dict] = []
    blocks = 0
    for metric in sorted(flat):
        attr = flat[metric].get("attribution")
        if attr is None:
            continue
        blocks += 1
        _check_block(metric, attr, violations)
    return {"blocks": blocks, "violations": violations,
            "ok": not violations}


def diff_pins(old: Dict[str, Dict], new: Dict[str, Dict]) -> List[Dict]:
    """Per-metric bucket deltas for metrics carrying attribution on
    either side. ``delta_s`` is new minus old (negative = the bucket
    got cheaper); sides without attribution diff as None."""
    rows: List[Dict] = []
    for metric in sorted(set(old) | set(new)):
        a_old = (old.get(metric) or {}).get("attribution")
        a_new = (new.get(metric) or {}).get("attribution")
        if a_old is None and a_new is None:
            continue
        row = {"metric": metric,
               "old_wall_s": a_old and a_old.get("wall_s"),
               "new_wall_s": a_new and a_new.get("wall_s"),
               "buckets": {}}
        for b in BUCKETS:
            o = a_old and float(a_old["buckets"].get(b, 0.0))
            n = a_new and float(a_new["buckets"].get(b, 0.0))
            row["buckets"][b] = {
                "old_s": o, "new_s": n,
                "delta_s": (round(n - o, 6)
                            if o is not None and n is not None
                            else None)}
        if a_new is not None:
            row["new_dominant"] = a_new.get("dominant_bucket")
            row["new_reconciled_pct"] = a_new.get("reconciled_pct")
        rows.append(row)
    return rows


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:9.1f}"


def format_report(rows: List[Dict], verdict: Dict,
                  old_path: str, new_path: str) -> str:
    """Human-readable bucket-delta tables, one per metric."""
    out = [f"mesh report: {os.path.basename(old_path)} -> "
           f"{os.path.basename(new_path)}"]
    if not rows:
        out.append("  no attribution blocks on either side "
                   "(pre-flight-recorder pins)")
    for row in rows:
        wall = (f"wall {_fmt_s(row['old_wall_s']).strip()}ms -> "
                f"{_fmt_s(row['new_wall_s']).strip()}ms")
        out.append(f"\n{row['metric']}  ({wall})")
        out.append(f"  {'bucket':<18} {'old_ms':>9} {'new_ms':>9} "
                   f"{'delta_ms':>9}")
        for b in BUCKETS:
            d = row["buckets"][b]
            delta = ("-" if d["delta_s"] is None
                     else f"{d['delta_s'] * 1e3:+9.1f}")
            out.append(f"  {b:<18} {_fmt_s(d['old_s'])} "
                       f"{_fmt_s(d['new_s'])} {delta:>9}")
        if "new_dominant" in row:
            out.append(f"  dominant: {row['new_dominant']}, "
                       f"{row['new_reconciled_pct']}% of wall "
                       "attributed")
    out.append(f"\nbudgets ({verdict['blocks']} attribution "
               f"block{'s' if verdict['blocks'] != 1 else ''}): "
               + ("PASS" if verdict["ok"] else "FAIL"))
    for v in verdict["violations"]:
        out.append(f"  {v['metric']}: [{v['kind']}] {v['detail']}")
    return "\n".join(out)


def live_pin(recorders=None) -> Dict[str, Dict]:
    """A flattened pin of finished flight attributions, one record per
    query id: the given recorders, or this process's ``FLIGHTS`` log."""
    if recorders is None:
        from ..obs.flight import FLIGHTS
        recorders = FLIGHTS.snapshot()
    out: Dict[str, Dict] = {}
    for fl in recorders:
        attr = getattr(fl, "attribution", None)
        if attr is not None:
            qid = str(attr.get("query_id"))
            out[qid] = {"metric": qid, "attribution": attr}
    return out


def profile_pin(doc: Dict, metric: str = "profile") -> Dict[str, Dict]:
    """A flattened pin of one profile document's mesh attribution
    (``_devtools/profile_query.py --mesh N``)."""
    attr = (doc.get("mesh") or {}).get("attribution")
    return {metric: {"metric": metric, "attribution": attr}} \
        if attr is not None else {}


def _load(path: str) -> Dict[str, Dict]:
    """A MULTICHIP pin, or a profile document with a mesh block."""
    with open(path) as f:
        doc = json.loads(f.read().strip())
    if isinstance(doc, dict) and "mesh" in doc and "operators" in doc:
        return profile_pin(doc, os.path.basename(path))
    return load_pin(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="diff two documents' mesh attributions bucket by "
                    "bucket and enforce the per-bucket overhead budgets "
                    "on the new one")
    ap.add_argument("old", help="baseline (a MULTICHIP pin or a profile "
                                "document)")
    ap.add_argument("new", help="candidate (a MULTICHIP pin or a "
                                "profile document)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the machine-readable report here")
    args = ap.parse_args(argv)

    try:
        old = _load(args.old)
        new = _load(args.new)
    except (OSError, ValueError) as e:
        print(json.dumps({"verdict": "error", "error": str(e)}))
        return 2

    rows = diff_pins(old, new)
    verdict = validate_attribution(new)
    print(format_report(rows, verdict, args.old, args.new))
    if args.json:
        doc = {"old": args.old, "new": args.new, "diff": rows,
               "budgets": verdict,
               "verdict": "pass" if verdict["ok"] else "fail"}
        with open(args.json, "w") as f:
            f.write(json.dumps(doc, indent=2) + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
