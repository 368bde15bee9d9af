"""Verdict and schema check of an SLO block: a pinned SERVING file's, or
the port's live block.

The counterpart of the JAX package's ``tools/slo_report.py``. An SLO
block (``obs/slo.slo_block``, served on ``GET /v1/slo``) carries each
resource group's declared objectives (``latency`` / ``availability``)
with their burn rates, error-budget remainder and alert state, every
alert transition the tracker fired, and the sampled burn timeline with
the windowed p95 beside it. This module renders the block as a per-group
verdict ("dash latency: OK, budget 100% left, worst burn 0.3x") and
checks its schema (:func:`validate_slo_block`), so a block that lost its
timeline or fired an unknown alert fails.

Fleet blocks carry the merged form of several coordinators' blocks: a
``coordinators`` count and a ``coordinator`` tag on every objective,
alert and timeline row (:func:`merge_slo_blocks` builds it); the
windowed-p95 coverage check then applies per coordinator.

Usage::

    python -m presto_tpu_torch._devtools.slo_report     # latest pin
    python -m presto_tpu_torch._devtools.slo_report SERVING_r03.json
    python -m presto_tpu_torch._devtools.slo_report --live URL
    python -m presto_tpu_torch._devtools.slo_report --live URL1 --live URL2
    python -m presto_tpu_torch._devtools.slo_report PIN --json report.json

Exit 0 when every block passes the schema (a pin with none passes), 1 on
violations, 2 on usage or IO errors.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import urllib.request
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: alert states, escalation order (``obs/slo._RANK``'s keys)
STATES = ("OK", "WARN", "PAGE")

#: alert rule names (``obs/slo.ALERT_RULES``)
RULES = ("latency_burn", "availability_burn")

#: objective kinds a group may declare (``server/resource_groups.py``
#: ``_parse_slo``)
OBJECTIVES = ("latency", "availability")

#: the keys of one slo block (``obs/slo.slo_block``)
_REQUIRED = ("sample_interval_s", "objectives", "alerts", "timeline")


def load_pin(path: str) -> Dict[str, Dict]:
    """{metric: record} from a SERVING pin: a committed ``_r*``
    wrapper (use its ``parsed``) or a bare ``SERVING_OUT`` summary."""
    with open(path) as f:
        doc = json.loads(f.read().strip())
    if isinstance(doc, dict) and "parsed" in doc:
        doc = doc["parsed"]
    out: Dict[str, Dict] = {}
    if not isinstance(doc, dict) or "metric" not in doc:
        raise ValueError(f"{path}: not a SERVING summary")
    out[doc["metric"]] = {k: v for k, v in doc.items()
                          if k != "sub_metrics"}
    for sub in doc.get("sub_metrics") or ():
        if isinstance(sub, dict) and "metric" in sub:
            out[sub["metric"]] = sub
    return out


def latest_pin(root: str = _REPO) -> Optional[str]:
    """Highest-numbered SERVING_r*.json — the pinned serving axis."""
    best, best_n = None, -1
    for p in glob.glob(os.path.join(root, "SERVING_r*.json")):
        m = re.search(r"SERVING_r(\d+)\.json$", os.path.basename(p))
        if m and int(m.group(1)) > best_n:
            best, best_n = p, int(m.group(1))
    return best


def _num(v: object) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_block(metric: str, slo: object,
                 violations: List[Dict]) -> None:
    """Schema checks for ONE slo block; appends any violations (each
    ``{"metric", "kind", "detail"}``)."""

    def bad(kind: str, detail: str) -> None:
        violations.append({"metric": metric, "kind": kind,
                           "detail": detail})

    if not isinstance(slo, dict):
        return bad("schema", "slo is not an object")
    missing = [k for k in _REQUIRED if k not in slo]
    if missing:
        return bad("schema", f"missing keys: {', '.join(missing)}")
    if not _num(slo["sample_interval_s"]) or \
            slo["sample_interval_s"] <= 0:
        bad("schema", "sample_interval_s must be a positive number")

    # fleet pins (r04 on) merge per-coordinator blocks into one:
    # ``coordinators`` counts the fleet and EVERY objective/alert/
    # timeline row must say which coordinator it came from, or the
    # merged block could silently collapse to one member's view
    fleet = slo.get("coordinators")
    if fleet is not None and (isinstance(fleet, bool)
                              or not isinstance(fleet, int)
                              or fleet < 2):
        bad("schema", "coordinators must be an int >= 2")
        fleet = None

    def coord_of(row: dict, where: str):
        if fleet is None:
            return None
        c = row.get("coordinator")
        if not isinstance(c, str) or not c:
            bad("schema", f"{where}: multi-coordinator block rows "
                          "need a non-empty coordinator tag")
            return None
        return c

    objectives = slo["objectives"]
    if not isinstance(objectives, list) or not objectives:
        return bad("schema", "objectives must be a non-empty list")
    latency_keys = set()
    for i, obj in enumerate(objectives):
        if not isinstance(obj, dict):
            bad("schema", f"objectives[{i}] is not an object")
            continue
        where = f"objectives[{i}]"
        if not isinstance(obj.get("group"), str) or not obj.get("group"):
            bad("schema", f"{where}: group must be a non-empty string")
        if obj.get("objective") not in OBJECTIVES:
            bad("schema", f"{where}: objective "
                          f"{obj.get('objective')!r} is not one of "
                          f"{'/'.join(OBJECTIVES)}")
        if not _num(obj.get("target")) or \
                not (0.0 < obj["target"] < 1.0):
            bad("schema", f"{where}: target must be in (0, 1)")
        coord = coord_of(obj, where)
        if obj.get("objective") == "latency":
            latency_keys.add((coord, obj.get("group"), "latency"))
            if not _num(obj.get("threshold_ms")) or \
                    obj["threshold_ms"] <= 0:
                bad("schema", f"{where}: latency objective needs a "
                              "positive threshold_ms")
        if obj.get("state") not in STATES:
            bad("schema", f"{where}: state {obj.get('state')!r} is "
                          f"not one of {'/'.join(STATES)}")
        for burn_key in ("burn_short", "burn_long"):
            b = obj.get(burn_key)
            if b is not None and (not _num(b) or b < 0):
                bad("schema", f"{where}: {burn_key} must be None or "
                              "a non-negative number")
        budget = obj.get("budget_remaining")
        if budget is not None and \
                (not _num(budget) or not (0.0 <= budget <= 1.0)):
            bad("schema", f"{where}: budget_remaining must be None "
                          "or in [0, 1]")

    alerts = slo["alerts"]
    if not isinstance(alerts, list):
        bad("schema", "alerts must be a list")
        alerts = []
    for i, a in enumerate(alerts):
        where = f"alerts[{i}]"
        if not isinstance(a, dict):
            bad("schema", f"{where} is not an object")
            continue
        coord_of(a, where)
        if not _num(a.get("ts")):
            bad("schema", f"{where}: ts must be a number")
        if a.get("rule") not in RULES:
            bad("schema", f"{where}: rule {a.get('rule')!r} is not "
                          f"one of {'/'.join(RULES)}")
        for side in ("from", "to"):
            if a.get(side) not in STATES:
                bad("schema", f"{where}: {side} state "
                              f"{a.get(side)!r} is not one of "
                              f"{'/'.join(STATES)}")

    timeline = slo["timeline"]
    if not isinstance(timeline, list) or not timeline:
        return bad("schema", "timeline must be a non-empty list "
                             "(the burn timeline is the point)")
    seen_p95 = set()
    for i, pt in enumerate(timeline):
        where = f"timeline[{i}]"
        if not isinstance(pt, dict):
            bad("schema", f"{where} is not an object")
            continue
        if not _num(pt.get("t")):
            bad("schema", f"{where}: t must be a number")
        if not isinstance(pt.get("group"), str) or \
                pt.get("objective") not in OBJECTIVES:
            bad("schema", f"{where}: needs group + objective")
        if pt.get("state") not in STATES:
            bad("schema", f"{where}: state {pt.get('state')!r} is "
                          f"not one of {'/'.join(STATES)}")
        b = pt.get("burn")
        if b is not None and (not _num(b) or b < 0):
            bad("schema", f"{where}: burn must be None or a "
                          "non-negative number")
        coord = coord_of(pt, where)
        p95 = pt.get("p95_ms")
        if p95 is not None:
            if not _num(p95) or p95 < 0:
                bad("schema", f"{where}: p95_ms must be a "
                              "non-negative number")
            else:
                seen_p95.add((coord, pt.get("group"),
                              pt.get("objective")))
    # the windowed p95 is what makes the latency timeline actionable;
    # a latency objective whose timeline never carries one means the
    # sampler never saw the histogram — a broken pin, not a quiet one.
    # In a merged fleet block the coverage is PER COORDINATOR: every
    # member's sampler must have seen its own histogram
    for coord, group, objective in sorted(
            latency_keys, key=lambda k: (k[0] or "", k[1], k[2])):
        if (coord, group, objective) not in seen_p95:
            who = f" on coordinator {coord!r}" if coord else ""
            bad("schema", f"latency objective for group {group!r}"
                          f"{who} has no timeline point with a "
                          "windowed p95_ms")


def validate_slo_block(flat: Dict[str, Dict]) -> Dict:
    """Schema-validate every slo block in a flattened pin. Pins
    without any block pass vacuously (pre-r03 history). Returns
    ``{"blocks", "violations", "ok"}``."""
    violations: List[Dict] = []
    blocks = 0
    for metric in sorted(flat):
        slo = flat[metric].get("slo")
        if slo is None:
            continue
        blocks += 1
        _check_block(metric, slo, violations)
    return {"blocks": blocks, "violations": violations,
            "ok": not violations}


def render(flat: Dict[str, Dict], verdict: Dict) -> str:
    """Human verdict: one line per objective, then the alert log."""
    lines: List[str] = []
    for metric in sorted(flat):
        slo = flat[metric].get("slo")
        if not isinstance(slo, dict):
            continue
        fleet = slo.get("coordinators")
        fleet_s = f", merged over {fleet} coordinators" \
            if isinstance(fleet, int) and not isinstance(fleet, bool) \
            else ""
        lines.append(f"{metric}: slo block "
                     f"(sampled every "
                     f"{slo.get('sample_interval_s')}s{fleet_s})")
        for obj in slo.get("objectives") or ():
            if not isinstance(obj, dict):
                continue
            burns = [b for b in (obj.get("burn_short"),
                                 obj.get("burn_long")) if b is not None]
            worst = f"worst burn {max(burns):.2f}x" if burns \
                else "no burn data"
            budget = obj.get("budget_remaining")
            budget_s = f"{budget * 100.0:.0f}% budget left" \
                if budget is not None else "budget unknown"
            thr = obj.get("threshold_ms")
            target = obj.get("target")
            detail = f"p{target * 100:g} < {thr:g}ms" \
                if obj.get("objective") == "latency" and \
                _num(thr) and _num(target) \
                else f"target {target}"
            c = obj.get("coordinator")
            gname = f"{c}:{obj.get('group')}" if c \
                else obj.get("group")
            lines.append(f"  {gname}/"
                         f"{obj.get('objective')} ({detail}): "
                         f"{obj.get('state')}, {budget_s}, {worst}")
        alerts = slo.get("alerts") or ()
        if alerts:
            lines.append(f"  {len(alerts)} alert transition(s):")
            for a in alerts:
                if isinstance(a, dict):
                    lines.append(f"    {a.get('group')}/"
                                 f"{a.get('objective')} "
                                 f"{a.get('from')} -> {a.get('to')} "
                                 f"({a.get('rule')})")
        else:
            lines.append("  no alert transitions")
    if not verdict["blocks"]:
        lines.append("no slo block (pre-r03 pin) — vacuous pass")
    for v in verdict["violations"]:
        lines.append(f"VIOLATION [{v['metric']}] {v['kind']}: "
                     f"{v['detail']}")
    lines.append(f"verdict: {'ok' if verdict['ok'] else 'FAIL'} "
                 f"({verdict['blocks']} block(s), "
                 f"{len(verdict['violations'])} violation(s))")
    return "\n".join(lines)


def live_block(url: Optional[str] = None) -> Dict:
    """The live slo block: a server's ``GET /v1/slo`` at ``url``, or
    this process's tracker (``obs/slo.slo_block``) when None."""
    if url is None:
        from ..obs.slo import slo_block
        return slo_block()
    with urllib.request.urlopen(url.rstrip("/") + "/v1/slo",
                                timeout=30) as r:
        return json.loads(r.read().decode("utf-8"))


def merge_slo_blocks(blocks: Dict[str, Dict]) -> Dict:
    """The fleet (merged) form of several coordinators' blocks, keyed by
    coordinator node id: one ``coordinators`` count, the first block's
    sample interval, and every objective, alert and timeline row tagged
    with the coordinator it came from."""
    merged: Dict = {"coordinators": len(blocks),
                    "sample_interval_s": None,
                    "objectives": [], "alerts": [], "timeline": []}
    for node, blk in blocks.items():
        if merged["sample_interval_s"] is None:
            merged["sample_interval_s"] = blk.get("sample_interval_s")
        for key in ("objectives", "alerts", "timeline"):
            for row in blk.get(key) or ():
                merged[key].append({**row, "coordinator": node})
    return merged


def live_pin(urls: List[str]) -> Dict[str, Dict]:
    """A flattened pin of live blocks: one server's block as is, several
    servers' merged into the fleet form (each tagged by its URL)."""
    if len(urls) == 1:
        return {"live": {"metric": "live", "slo": live_block(urls[0])}}
    merged = merge_slo_blocks({u: live_block(u) for u in urls})
    return {"live": {"metric": "live", "slo": merged}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render and schema-check an slo block: a pinned "
                    "SERVING file's or a live server's")
    ap.add_argument("pin", nargs="?", default=None,
                    help="SERVING pin (default: the latest "
                         "SERVING_r*.json)")
    ap.add_argument("--live", action="append", default=None,
                    metavar="URL",
                    help="read GET URL/v1/slo instead of a pin "
                         "(repeat for a fleet: the merged form)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the verdict JSON to this file")
    args = ap.parse_args(argv)

    if args.live:
        try:
            flat = live_pin(args.live)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 2
        path = ",".join(args.live)
    else:
        path = args.pin or latest_pin()
        if path is None or not os.path.exists(path):
            print("no SERVING_r*.json pin found", file=sys.stderr)
            return 2
        try:
            flat = load_pin(path)
        except (OSError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 2

    verdict = validate_slo_block(flat)
    verdict["pin"] = path
    print(render(flat, verdict))
    if args.json:
        with open(args.json, "w") as f:
            f.write(json.dumps(verdict, indent=2) + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
