"""CLI for the port's static-analysis plane:
``python -m presto_tpu_torch._devtools.analyze``.

Modes:

- default: full scan, exit 0 iff no unsuppressed findings and no stale
  baseline suppressions;
- ``--changed``: git-diff-scoped fast mode (per-file rules on the
  working-tree delta only; registry rules one-way unless a declaring
  input changed; stale detection skipped) — the pre-commit loop;
- ``--format json``: machine-readable verdict on stdout (one JSON
  document, ``ok`` is the gate).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import CHECKERS, git_changed_files, run, run_changed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch._devtools.analyze",
        description="static analysis of presto_tpu_torch: device-sync "
                    "bracketing, lock discipline, registry consistency, "
                    "cache-protocol contracts")
    ap.add_argument("--checker", action="append", choices=sorted(CHECKERS),
                    help="run only this checker (repeatable; full-scan "
                         "mode only)")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: this repo)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore baseline.json suppressions")
    ap.add_argument("--list", action="store_true",
                    help="also print baseline-suppressed findings")
    ap.add_argument("--changed", action="store_true",
                    help="fast mode: scan only the git working-tree "
                         "delta (skips stale-suppression detection)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (default text)")
    args = ap.parse_args(argv)

    baseline = "/dev/null" if args.no_baseline else None
    if args.changed:
        files = git_changed_files(args.root)
        findings, suppressed, stale = run_changed(
            files, root=args.root, baseline_path=baseline)
    else:
        findings, suppressed, stale = run(
            root=args.root, checkers=args.checker,
            baseline_path=baseline)

    ok = not findings and not stale
    if args.format == "json":
        doc = {
            "ok": ok,
            "mode": "changed" if args.changed else "full",
            "findings": [
                {"checker": f.checker, "rule": f.rule, "path": f.path,
                 "line": f.line, "symbol": f.symbol, "ident": f.ident,
                 "message": f.message}
                for f in findings],
            "suppressed": len(suppressed),
            "stale_suppressions": stale,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0 if ok else 1

    for f in findings:
        print(f.render(), file=sys.stderr)
    if args.list:
        for f in suppressed:
            print(f"[baseline] {f.render()}")
    for ident in stale:
        print(f"stale baseline suppression (fixed? delete it): "
              f"{ident}", file=sys.stderr)
    print(f"{'ok' if ok else 'FAIL'}: {len(findings)} finding(s), "
          f"{len(suppressed)} baseline-suppressed, "
          f"{len(stale)} stale suppression(s)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
