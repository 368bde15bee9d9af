"""Watcher over the autoscaler's signals feed: a shim over the rule
registry.

The policy lives in ``exec/autoscale.py`` (:data:`RULES` /
:func:`decide`), shared with the real ``AutoscaleController``, so the
watcher and the controller cannot drift (``decide`` here *is*
``autoscale.decide``). The watcher prints what the rules recommend for
one snapshot; it decides nothing and provisions nothing.

Usage::

    python -m presto_tpu_torch._devtools.autoscale_watch          # this process
    python -m presto_tpu_torch._devtools.autoscale_watch --demo   # synthetic

Exit 0 always (a recommendation is not a failure).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..exec.autoscale import RULES, decide, demo_signals  # noqa: F401
from ..obs.signals import cluster_signals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="threshold watcher over the signals feed")
    ap.add_argument("--demo", action="store_true",
                    help="run against a synthetic busy cluster "
                         "instead of this process's live registries")
    args = ap.parse_args(argv)

    signals = demo_signals() if args.demo else cluster_signals()
    decisions = decide(signals)
    print(json.dumps({"ts": signals.ts,
                      "groups": len(signals.groups),
                      "nodes": len(signals.nodes),
                      "decisions": decisions}, indent=2))
    if not decisions:
        print("no action recommended", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
