"""The comparison that decides ``correct``: it passes a sound run, fails
the control (the reference in float32 in the engine's place) and fails a
run whose timed path is broken underneath, once for each fault a
single-card SQL cell can have."""
import dataclasses

import pytest

from conftest import SMALL, cell as load
from gpubench.harness import cell
from gpubench.harness.control import control_readings

CELLS = ("tpch_sf10.agg",)


def _cell(name):
    c = load(name)
    # two clients keep the CPU run short; the mix is the cell's
    return dataclasses.replace(c, traffic={**c.traffic, "clients": 2})


def _run(name, seconds=1.5):
    import time
    return cell.run_cell(_cell(name), 17, seconds, False, "cpu",
                         time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("seed", (3, 2_147_483_659, 77_777))
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, seed):
    c = load(name)
    r = control_readings(c, seed, "cpu", overrides=SMALL)
    assert r["max_rel_gap"] > r["limit"] or r["mismatched_statements"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, cuda_device):
    c = load(name)
    for seed in (3, 2_147_483_659, 77_777):
        r = control_readings(c, seed, cuda_device, overrides=SMALL)
        assert r["max_rel_gap"] > r["limit"] or \
            r["mismatched_statements"], r


def _stale(orig):
    """Each statement returns the previous statement's answer."""
    last = {}

    def execute(self, sql, *a, **k):
        out = orig(self, sql, *a, **k)
        prev, last["r"] = last.get("r"), out
        return prev if prev is not None else out
    return execute


def _altered(orig):
    """One number of every answer is altered where it is produced."""
    def execute(self, sql, *a, **k):
        out = orig(self, sql, *a, **k)
        rows = [list(r) for r in out.rows]
        for r in rows:
            for i, v in enumerate(r):
                if isinstance(v, float) or hasattr(v, "dtype") and \
                        v.dtype.kind == "f":
                    r[i] = float(v) * (1 + 1e-6) + 1e-6
                    return dataclasses.replace(out, rows=[tuple(x)
                                                          for x in rows])
        return out
    return execute


def _half_batches(orig):
    """Half of every scan's batches left out: sums and means are taken
    over the rest."""
    def scan(*a, **k):
        for i, b in enumerate(orig(*a, **k)):
            if i % 2 == 0:
                yield b
    return scan


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from presto_tpu_torch.exec import runner, scancache
    if fault == "stale":
        monkeypatch.setattr(runner.LocalRunner, "execute",
                            _stale(runner.LocalRunner.execute))
    elif fault == "altered":
        monkeypatch.setattr(runner.LocalRunner, "execute",
                            _altered(runner.LocalRunner.execute))
    else:
        monkeypatch.setattr(scancache, "scan_splits",
                            _half_batches(scancache.scan_splits))
    res = _run(name)
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]
