"""The port's chaos scenarios (presto_tpu_torch/_devtools/chaos.py) on
in-process CPU workers at SF 0.01, with the assertions of presto_tpu's
tests/test_chaos.py: every recovery path (task retry, exchange drop,
speculative win over a straggler, fail-fast under retry_policy=NONE,
worker death, spool replay without a re-run, spool corruption caught by
its checksum, a late joiner taking re-created tasks, a mid-read drain
finished from the spool, a seeded preemption storm, scale to zero over
the object-store spool) returns the fault-free rows, and the spool ends
with no per-query directory. Then the coordinator-fleet drill (one of
three coordinators killed mid-run, no failed query), and a CPU rehearsal
of the 1 -> 2 -> 1 load ramp on ``LocalProcessProvider`` subprocess
workers whose ``ramp`` block, attached to the elastic summary, passes
the reference's elastic gate (``tools/check_bench_regression.py``)."""
import json
import os
import sys

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
    # the scenarios that wait for the autoscaler's node plane
    storm = scenarios["preemption_storm"]
    assert storm["preemptions"] >= 3 and storm["queries"] >= 5
    assert storm["spool_replays"] >= 1
    zero = scenarios["scale_to_zero"]
    assert zero["spool_replays"] >= 1 and zero["task_retries"] >= 1
    assert zero["object_puts"] >= 1 and zero["object_gets"] >= 1
    assert zero["object_orphans"] == 0
    # the recovery-time summary in the reference's bench format
    assert summary["elastic"]["value"] > 0
    assert [m["metric"] for m in summary["elastic"]["sub_metrics"]] == [
        f"{s}_ms" for s in ("worker_death", "spool_replay",
                            "spool_corrupt", "worker_join", "drain_exit",
                            "preemption_storm", "scale_to_zero")]


def test_scale_to_zero_restores_the_spool(summary):
    """The drills leave the process-wide spool as they found it: the
    local backend, no object store directory of theirs."""
    from presto_tpu_torch.exec.spool import SPOOL
    assert SPOOL.backend == "local"
    assert SPOOL.query_dirs() == []


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


def test_fleet_coordinator_kill():
    """One of three coordinators over one worker pool killed mid-run: no
    failed query (the FleetClient re-dispatches), the survivors drop the
    dead coordinator's federated counts after the staleness grace, and
    ``coordinator_lost_total`` moves, read over SQL."""
    from presto_tpu_torch._devtools.chaos import run_fleet_chaos
    summary = run_fleet_chaos(sf=0.01, device="cpu")
    assert summary["ok"] is True
    kill = summary["scenarios"]["coordinator_kill"]
    assert kill["failed"] == 0
    assert kill["queries"] >= 6
    assert kill["failovers"] >= 1
    assert kill["coordinator_lost_total"] >= 1.0
    assert kill["survivor_lost_view"] == ["coord-2"]


def test_elastic_ramp_passes_the_reference_gate(summary, tmp_path,
                                                monkeypatch):
    """The 1 -> 2 -> 1 load ramp on subprocess workers (``--device cpu``)
    with the device floor on: no failed query, the pool back at one
    worker, and the ramp block attached to the elastic summary passes the
    reference's elastic gate (the pool really ramps, every window has 0
    failures, peak QPS >= 1.5x the one-worker floor). Every process of
    the ramp runs one OpenMP thread: the CPU is the device here, and
    full thread pools in three processes contend for its cores. Small
    batches keep the modeled device floor above the CPU's own work per
    batch, and 8 s windows count enough queries (about 12 and 22) that
    one query more or less moves the ratio by less than a tenth."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools"))
    import check_bench_regression as gate
    from presto_tpu_torch._devtools.chaos import run_elastic_ramp
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    events = []
    ramp = run_elastic_ramp(sf=0.01, phases=(1, 2, 1), phase_s=8.0,
                            clients=4, device_floor_ms=20.0,
                            rows_per_batch=2048, device="cpu",
                            on_event=lambda kind, **f: events.append(kind))
    assert [p["workers"] for p in ramp["phases"]] == [1, 2, 1]
    assert all(p["failed"] == 0 for p in ramp["phases"])
    assert ramp["peak_over_floor"] >= 1.5
    assert events.count("launch") == 2 and events.count("drain") == 1
    path = tmp_path / "elastic.json"
    path.write_text(json.dumps({**summary["elastic"], "ramp": ramp}))
    verdict = gate._elastic_gate(gate.load_summary(str(path)))
    assert verdict == {"blocks": 1, "violations": [], "ok": True}


def test_cluster_query_ids_are_unique_across_runners():
    """Coordinators that share a worker name their tasks and spool
    directories by query id, so two runners' ids must never meet (the
    JAX package numbers each ClusterRunner's queries from cq_000001:
    the fleet drill's coordinators collided on the shared worker and a
    query could read another's released spool)."""
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.server.worker import WorkerServer
    w = WorkerServer(tpch_sf=0.001, device="cpu")
    w.start()
    url = f"http://127.0.0.1:{w.port}"
    runners = [ClusterRunner([url], tpch_sf=0.001, heartbeat=False,
                             device="cpu") for _ in range(2)]
    try:
        for r in runners:
            assert r.execute("select count(*) from nation").rows == [(25,)]
        qids = {tid.split(".")[0]
                for tid in list(w.tasks) + list(w.done)}
        assert len(qids) == 2, qids
        assert all(q.startswith("cq_") for q in qids)
    finally:
        for r in runners:
            r.detector.stop()
        w.stop()
