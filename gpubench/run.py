"""Run one cell of BENCHMARK.json on the CUDA device of this machine.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output; exits non-zero, with no
result, where no CUDA device is present.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "gpubench" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from gpubench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
