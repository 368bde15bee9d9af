"""Build and load the hand-written CUDA kernels of ``presto_tpu_torch/csrc``.

Each source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library under
``presto_tpu_torch/_build/``, then loaded with ``ctypes``. Libraries are
named by a hash of their source, so an edited kernel is rebuilt and a
built one is reused by later processes. ``build()`` compiles several
sources at once, one ``nvcc`` process each. Nothing here runs at import
time: this module imports on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Sequence, Tuple

from ..obs import profiler

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: kernel name -> source file in csrc/
SOURCES = {"scan": "scan.cu", "probe": "probe.cu", "slotsum": "slotsum.cu"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}
_LOCK = threading.Lock()
#: kernel name -> nvcc's register/shared-memory report of the last build
PTXAS_REPORT: Dict[str, str] = {}
#: guards the wrappers' launch and plain-call counts: a join's probe side
#: may run on a producer thread (exec/local_exchange.py), and an unlocked
#: ``+=`` on a module integer can lose an update between threads
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, all ``nvcc``
    processes running at once. Returns seconds per compiled kernel;
    raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        profiler.KERNELS.note_build(name, seconds[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def entry(name: str, fn: str, argtypes: Sequence) -> Callable[..., int]:
    """C entry point ``fn`` of kernel ``name``, bound to ``argtypes`` the
    first time it is asked for; every entry returns a ``cudaError_t``."""
    bound = _ENTRIES.get((name, fn))
    if bound is None:
        bound = getattr(library(name), fn)
        bound.argtypes = list(argtypes)
        bound.restype = ctypes.c_int
        _ENTRIES[(name, fn)] = bound
    return bound


def aligned16(t):
    """``t`` itself when its data starts on a 16-byte boundary, else a
    contiguous copy, which the allocator places on one (the kernels read
    and write 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(name: str, status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point of
    kernel ``name`` (every entry returns ``cudaGetLastError()`` after its
    launches)."""
    if status != 0:
        msg = library(name).cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
