"""chip_smoke.py's cluster phase rehearsed on the CPU at SF 0.01 (two
warm runs, one-row-group batches as on the card): the 22 TPC-H queries
on two in-process workers equal the CPU rows, partitioned Q3 warm in
turns with one device, a traced Q3 whose every task span lies under the
query's span, the memory manager's kill, a subprocess worker
(``--device cpu``) that announces, serves Q1 and Q3, counts its own
kernel calls on its /v1/metrics and exits after its drain, and the
chaos scenarios; the plain versions of both kernels ran inside the
workers' tasks, here and in the subprocess."""
import importlib.util
import pathlib

import torch

import torch_parity  # noqa: F401  (one torch thread per worker)


def test_cluster_phase_rehearsed_on_the_cpu():
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tasks, sub = smoke.phase_cluster(torch, None, device="cpu", sf=0.01,
                                     chaos_sf=0.01, runs=2,
                                     straggler_s=6.0)
    assert min(tasks.values()) > 0, tasks
    assert min(sub.values()) > 0, sub
