"""chip_smoke.py's mesh phase rehearsed on the CPU at small scale
factors (one CPU seen as four mesh slots), and its fair-scheduling check
held against schedulers that do not arbitrate: with ``fair_scheduling``
off, and with a level order that favours the long query, the check
fails."""
import importlib.util
import pathlib

import pytest
import torch

from presto_tpu_torch.exec import taskexec
from presto_tpu_torch.exec.runner import LocalRunner

MESH = {"mesh_execution": "on", "mesh_devices": 4}


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture
def runner(monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    return LocalRunner(tpch_sf=0.01, device="cpu")


def test_smoke_mesh_phase_on_the_cpu(smoke, capsys):
    """Every check of the phase passes; the launches count the mesh runs
    only, and the segment sum runs in the shard bodies of all 4 slots."""
    launches, slots = smoke.phase_mesh(torch, device="cpu", sf=0.01,
                                       big_sf=0.02, ds_sf=0.01)
    seg = slots["segment_sum_sorted_i64"]
    assert len(seg) == 4 and min(seg) > 0
    assert launches["segment_sum_sorted_i64"] >= sum(seg)
    out = capsys.readouterr().out
    assert "mesh fair arbitration: long scan" in out
    assert "no two quanta overlapped" in out


def test_fair_check_fails_without_the_scheduler(smoke, runner):
    with pytest.raises(AssertionError, match="never reached level 1"):
        smoke._fair_arbitration(runner, {**MESH, "fair_scheduling": False},
                                0.01)


def test_fair_check_fails_when_the_long_query_wins(smoke, runner,
                                                   monkeypatch):
    monkeypatch.setattr(taskexec.DeviceScheduler, "_wait_key",
                        staticmethod(lambda t: (-t.level,
                                                -t.device_seconds)))
    with pytest.raises(AssertionError, match="waited for the long one"):
        smoke._fair_arbitration(runner, MESH, 0.01)


def test_fair_check_passes_with_the_scheduler(smoke, runner):
    long_r, short_r = smoke._fair_arbitration(runner, MESH, 0.01)
    assert max(long_r["levels"]) >= 1 and short_r["levels"] == [0]
    assert long_r["quanta"] >= 2 and short_r["quanta"] >= 2


def test_fair_check_fails_when_quanta_overlap(smoke, runner, monkeypatch):
    monkeypatch.setattr(taskexec.DeviceScheduler, "_eligible",
                        lambda self, handle: True)
    with pytest.raises(AssertionError, match="held the device at once"):
        smoke._fair_arbitration(runner, MESH, 0.01)
