"""Run one cell of BENCHMARK.json as ``run.py --trace 1`` does, with the
CUDA runtime's launch records kept, so that each CUDA record is charged
to the engine span that launched it (``harness/attribution.py``).

    python3 gpubench/attribute.py --workload <cell> --seed <n> --seconds <s>

Prints the result line last on standard output, with the per-layer
metrics that read the launch records; on standard error, the device
time a statement by template and by operator.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import gpubench.run  # noqa: E402,F401  (run.py's set-up: caches, path)
from gpubench.harness.attribution import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
