"""The control of a cell's comparison: the plain reference computed in
float32, put in the engine's place, judged as a run judges the engine.

    python3 gpubench/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed it prints one JSON line with the numbers a run compares
(over the statements each client's sequence starts with, at the
configuration's scale).
The benchmark's runs never run it; its readings set the upper end of
``compare.max_rel_gap`` (see PERF.md).
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gpubench.harness.control import control_readings  # noqa: E402
from gpubench.harness import spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seed:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control_readings(cell, seed, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
