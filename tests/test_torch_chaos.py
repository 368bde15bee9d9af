"""The port's chaos scenarios (presto_tpu_torch/_devtools/chaos.py) on
in-process CPU workers at SF 0.01, with the assertions of presto_tpu's
tests/test_chaos.py: every recovery path (task retry, exchange drop,
speculative win over a straggler, fail-fast under retry_policy=NONE,
worker death, spool replay without a re-run, spool corruption caught by
its checksum, a late joiner taking re-created tasks, a mid-read drain
finished from the spool) returns the fault-free rows, and the spool ends
with no per-query directory. The scenarios that need exec/autoscale.py
(the preemption storm, scale to zero, the fleet drill, the load ramp and
its gate) wait for it."""
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)


@pytest.fixture(scope="module")
def summary():
    from presto_tpu_torch._devtools.chaos import run_chaos
    return run_chaos(sf=0.01, device="cpu", straggler_sleep_s=6.0)


def test_chaos_smoke(summary):
    assert summary["ok"] is True
    scenarios = summary["scenarios"]
    assert scenarios["task_failure"]["task_retries"] >= 1
    assert scenarios["exchange_drop"]["task_retries"] >= 1
    assert scenarios["straggler"]["speculative_won"] >= 1
    assert scenarios["worker_death"]["task_retries"] >= 1
    assert "retry_none" in scenarios
    assert scenarios["spool_replay"]["spool_replays"] >= 1
    assert scenarios["spool_replay"]["spool_fallbacks"] >= 1
    assert scenarios["spool_corrupt"]["corruptions"] >= 1
    assert scenarios["spool_corrupt"]["task_retries"] >= 1
    assert scenarios["worker_join"]["landed_on_joiner"] >= 1
    assert scenarios["drain_exit"]["task_retries"] == 0
    assert scenarios["drain_exit"]["spool_fallbacks"] >= 1
    assert summary["orphans"] == 0
    assert summary["device"] == "cpu"


def test_lock_discipline_clean_after_chaos(summary):
    """After the whole chaos run (retries, speculation, drain, worker
    death) the lock-order validator saw every lock edge the cluster
    plane takes under stress: the graph holds no cycle and no guarded
    field was touched without its lock."""
    from presto_tpu_torch._devtools import lockcheck
    assert lockcheck.ENABLED
    assert lockcheck.GRAPH.check() == [], lockcheck.GRAPH.check()


def test_chaos_spec_with_unknown_site_fails_fast():
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    with pytest.raises(ValueError, match="unknown failpoint site"):
        FAILPOINTS.configure_from_spec("worker.task_ruin=error")
