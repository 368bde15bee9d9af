"""Shared fixtures of the benchmark's tests (run on the CPU:
``python -m pytest gpubench/tests -q``; the ``cuda`` tests run where
torch sees a GPU)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tests' scale: small enough for a CPU, large enough that every
#: template returns rows
SMALL = {"scale_factor": 0.01, "rows_per_batch": 1 << 14}


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def cell(name: str):
    """The cell ``name`` of BENCHMARK.json."""
    from gpubench.harness import spec
    return spec.load_cell(ROOT, name)
