"""chip_smoke.py's autoscale phase rehearsed on the CPU at SF 0.01: a
coordinator booted from an etc directory with ``autoscale.enabled=true``
grows its ``--device cpu`` subprocess workers under a queue of Q3s (each
equal to the CPU rows), every worker counts its own calls of both
kernels' plain versions on its /v1/metrics, the idle pool drains back to
its floor with every process exiting by itself, and
``autoscale_actions_total`` moves for both actions; then the drills
(the preemption storm, scale to zero, the fleet). The load ramp is left
out here: tests/test_torch_chaos.py rehearses it on the CPU.

Every process of the phase runs one OpenMP thread: the CPU is the device
here, and full thread pools in four processes contend for its cores."""
import importlib.util
import pathlib

import torch

import torch_parity  # noqa: F401  (one torch thread per worker)


def test_autoscale_phase_rehearsed_on_the_cpu(monkeypatch):
    from presto_tpu_torch.obs.metrics import REGISTRY
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = {a: REGISTRY.counter(f"autoscale_actions_total.{a}").value
              for a in ("scale_up", "scale_down")}
    launches = smoke.phase_autoscale(
        torch, device="cpu", sf=0.01, rows_per_batch=1 << 12, ramp=None,
        chaos_sf=0.01, straggler_s=6.0)
    # the plain versions of both kernels ran inside the autoscaled
    # workers' tasks, in every worker (the phase checks each)
    assert min(launches.values()) > 0, launches
    moved = {a: REGISTRY.counter(f"autoscale_actions_total.{a}").value
             - v for a, v in before.items()}
    assert moved["scale_up"] >= 1 and moved["scale_down"] >= 1, moved
