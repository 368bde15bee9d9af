"""Chaos scenarios: an elastic in-process cluster under seeded failpoints.

The port's copy of the cluster scenarios of the JAX package's
``tools/chaos_smoke.py`` (``run_chaos``). It drives every recovery path
of the fault-tolerance and spooled-exchange layers (``exec/cluster.py``,
``exec/spool.py``, ``exec/failpoints.py``) with in-process workers on
one device, and holds the rows after each injected fault equal to the
fault-free run:

- ``task_failure``: one task FAILs at start (``worker.task_run``
  error); the coordinator re-creates it on a healthy worker.
- ``exchange_drop``: one exchange pull dies mid-stream
  (``exchange.pull`` error); the error names the upstream attempt and
  the retry layer replaces exactly that producer.
- ``straggler``: one source task sleeps ``straggler_sleep_s``
  (``worker.task_run`` sleep); the StageMonitor flags it, a speculative
  duplicate launches on another node and wins, the loser is aborted.
- ``retry_none``: the same task fault under ``retry_policy=NONE`` fails
  fast.
- ``worker_death``: a failpoint callback kills one worker's HTTP server
  mid-query; its tasks reschedule onto the survivors.
- ``spool_replay``: a worker is killed after its source task committed
  its spool, mid-shuffle: consumers replay the pages from the spool and
  the source task is not run again.
- ``spool_corrupt``: one spooled page is corrupted on disk
  (``spool.corrupt``) and its worker killed: the checksum catches it and
  the retry layer re-runs exactly that producer.
- ``worker_join``: a fresh worker boots and announces mid-query while
  another dies: the re-created tasks land on the late joiner.
- ``drain_exit``: a worker is put into SHUTTING_DOWN mid-query while the
  root still reads its output: it exits within its drain grace and the
  consumer finishes from the spool, with no task retry.

Recovery is observed through ``system.runtime.metrics`` over SQL
(``task_retry_total``, ``speculative_won_total``,
``spool_replayed_task_total``, ``exchange_spool_fallback_total``,
``spool_corruption_total``, ``node_joined_total``); at the end the spool
holds no per-query directory. The JAX package's preemption storm, scale
to zero, coordinator-fleet drill and load ramp wait for the port's
autoscaler (``exec/autoscale.py``).

Run it: ``python -m presto_tpu_torch._devtools.chaos --device cpu``
(prints a JSON summary).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

QUERY = ("select l_returnflag, l_linestatus, count(*) c, "
         "sum(l_quantity) q, sum(l_extendedprice) e from lineitem "
         "where l_shipdate <= date '1998-09-02' "
         "group by 1, 2 order by 1, 2")


def _metric_sql(runner, name: str) -> float:
    res = runner.local.execute(
        "select value from system.runtime.metrics "
        f"where name = '{name}'")
    return float(res.rows[0][0]) if res.rows else 0.0


def _assert_rows_equal(got, want, scenario: str) -> None:
    assert len(got) == len(want), \
        f"{scenario}: {len(got)} rows vs {len(want)}"
    for gr, wr in zip(got, want):
        for gv, wv in zip(gr, wr):
            if isinstance(wv, float):
                # partial-aggregation pages merge in arrival order;
                # double sums agree only to rounding
                assert abs(gv - wv) <= max(abs(wv), 1.0) * 1e-9, \
                    (scenario, gr, wr)
            else:
                assert gv == wv, (scenario, gr, wr)


def run_chaos(sf: float = 0.01, device=None, query: str = QUERY,
              straggler_sleep_s: float = 10.0, rows_per_batch: int = 1 << 17,
              verbose: bool = False) -> dict:
    """Run every scenario on in-process workers on ``device`` (the GPU
    when none is named); returns the summary, ``ok`` True when every
    scenario held. Raises ``AssertionError`` naming the scenario that
    failed."""
    from ..device import resolve_device
    from ..exec.cluster import ClusterRunner, QueryFailedError
    from ..exec.discovery import DiscoveryNodeManager
    from ..exec.failpoints import FAILPOINTS
    from ..exec.spool import SPOOL
    from ..server.worker import WorkerServer
    device = resolve_device(device)

    def log(msg: str) -> None:
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    # discovery-fed membership (not a static URL list): workers may
    # join or leave mid-query
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    workers = []

    def add_worker() -> WorkerServer:
        w = WorkerServer(tpch_sf=sf, drain_grace_s=2.0, device=device)
        w.start()
        workers.append(w)
        discovery.announce(w.node_id, f"http://127.0.0.1:{w.port}")
        return w

    def kill_worker(w: WorkerServer) -> None:
        """In-process stand-in for a worker process death: the network
        surface goes away and its task threads stop."""
        w.httpd.shutdown()
        w.httpd.server_close()
        for t in list(w.tasks.values()):
            t.abort()

    for _ in range(3):
        add_worker()
    runner = ClusterRunner(tpch_sf=sf, heartbeat=False,
                           discovery=discovery, device=device,
                           rows_per_batch=rows_per_batch)
    summary: dict = {"sf": sf, "device": str(device), "scenarios": {}}
    FAILPOINTS.clear()
    try:
        # fault-free reference (the second run is warm, so the fault
        # runs time recovery, not first-touch generation)
        t0 = time.perf_counter()
        want = runner.execute(query).rows
        runner.execute(query)
        summary["baseline_s"] = round(time.perf_counter() - t0, 3)
        log(f"baseline: {len(want)} rows in {summary['baseline_s']}s")

        def scenario(name: str):
            t = time.perf_counter()

            def finish(**extra):
                FAILPOINTS.clear()
                summary["scenarios"][name] = {
                    "elapsed_s": round(time.perf_counter() - t, 3),
                    **extra}
                log(f"{name}: ok {summary['scenarios'][name]}")
            return finish

        # -- (a) one task failure -> task-level retry ---------------------
        finish = scenario("task_failure")
        before = _metric_sql(runner, "task_retry_total")
        FAILPOINTS.configure("worker.task_run", action="error",
                             message="chaos: task failure", times=1)
        _assert_rows_equal(runner.execute(query).rows, want,
                           "task_failure")
        retries = _metric_sql(runner, "task_retry_total") - before
        assert retries >= 1, "task failure did not trigger a retry"
        finish(task_retries=retries)

        # -- (b) exchange drop mid-stream -> upstream replaced ------------
        finish = scenario("exchange_drop")
        before = _metric_sql(runner, "task_retry_total")
        FAILPOINTS.configure("exchange.pull", action="error",
                             message="chaos: exchange drop", times=1)
        _assert_rows_equal(runner.execute(query).rows, want,
                           "exchange_drop")
        retries = _metric_sql(runner, "task_retry_total") - before
        assert retries >= 1, "exchange drop did not trigger a retry"
        finish(task_retries=retries)

        # -- (c) 10x straggler -> speculative attempt wins ----------------
        finish = scenario("straggler")
        before = _metric_sql(runner, "speculative_won_total")
        # partition 0 of the source stage sleeps far past the stage
        # median; attempt suffixes keep the duplicate out of the rule.
        # The sleep must outlast two status rounds of the coordinator
        # (one long poll of the root each, 2 s) plus the duplicate's
        # run, or the original wakes first and keeps the win
        FAILPOINTS.configure("worker.task_run", action="sleep",
                             sleep_s=straggler_sleep_s, match=r"\.0\.0@",
                             times=1)
        # ... and the SIBLING source tasks must clear the monitor's
        # straggler median floor (min_elapsed_ms): with the scan cache
        # primed by the earlier scenarios they finish in a few ms, the
        # stage median lands under the floor, and the straggler is
        # never flagged — the exact warm-cluster shape that made this
        # scenario order-dependent inside the full test suite
        FAILPOINTS.configure("worker.task_run", action="sleep",
                             sleep_s=0.1, match=r"\.0\.[1-9]\d*@",
                             times=None)
        _assert_rows_equal(runner.execute(query).rows, want,
                           "straggler")
        FAILPOINTS.clear()      # the sibling pad rule is unbounded
        won = _metric_sql(runner, "speculative_won_total") - before
        assert won >= 1, "straggler did not produce a speculative win"
        finish(speculative_won=won)

        # -- (d) retry_policy=NONE fails fast -----------------------------
        finish = scenario("retry_none")
        FAILPOINTS.configure("worker.task_run", action="error",
                             message="chaos: fail fast", times=1)
        runner.session.properties["retry_policy"] = "NONE"
        try:
            failed = False
            try:
                runner.execute(query)
            except QueryFailedError as e:
                failed = True
                assert "chaos: fail fast" in str(e), str(e)
            assert failed, "retry_policy=NONE still recovered"
        finally:
            del runner.session.properties["retry_policy"]
        finish()

        # -- (e) worker death mid-query -> reschedule on survivors --------
        finish = scenario("worker_death")
        before = _metric_sql(runner, "task_retry_total")
        victim = workers[-1]

        def kill(key="", **ctx):
            kill_worker(victim)

        FAILPOINTS.configure("worker.task_run", action="callback",
                             callback=kill, times=1,
                             match=f"@{victim.node_id}$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "worker_death")
        retries = _metric_sql(runner, "task_retry_total") - before
        assert retries >= 1, "worker death did not trigger a retry"
        # the dead node must be out of the schedulable set now
        assert f"http://127.0.0.1:{victim.port}" \
            not in runner._schedulable_workers()
        finish(task_retries=retries)
        add_worker()               # replenish the pool to 3 live nodes

        # fragment ids of the smoke query (the scenarios below target
        # the source stage's tasks / the stage the root consumes)
        from ..planner.fragmenter import fragment_plan
        from ..planner.plan import RemoteSourceNode
        fp = fragment_plan(runner.local.plan(query).root)
        source_fid = next(f.id for f in fp.fragments
                          if f.partitioning == "source")

        def _nodes(n):
            yield n
            for c in n.children:
                yield from _nodes(c)
        feed_fid = next(fid for node in _nodes(fp.root.root)
                        if isinstance(node, RemoteSourceNode)
                        for fid in node.fragment_ids)

        def live_workers():
            return [w for w in workers if w.httpd.socket.fileno() != -1
                    and not w.shutting_down]

        def pick_victim():
            # the single (root) fragment lands on the first worker of
            # the schedulable sweep (sorted by URL): the max-URL live
            # worker can never host the root, which keeps the
            # drain/kill scenarios' retry accounting deterministic
            return max(live_workers(),
                       key=lambda w: f"http://127.0.0.1:{w.port}")

        def wait_stage_finished(w: WorkerServer, fid: int,
                                timeout_s: float = 30.0) -> None:
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                ts = [t for t in list(w.tasks.values())
                      if t.task_id.split(".")[1] == str(fid)]
                if ts and all(t.state == "FINISHED" for t in ts):
                    return
                time.sleep(0.05)
            raise AssertionError(
                f"stage {fid} on {w.node_id} never finished")

        # -- (f) spool replay: kill a worker AFTER its source task ------
        # committed its spool, mid-shuffle. Consumers replay the pages
        # from the durable spool; the source task is NOT re-executed.
        finish = scenario("spool_replay")
        before = _metric_sql(runner, "task_retry_total")
        before_replay = _metric_sql(runner, "spool_replayed_task_total")
        before_fb = _metric_sql(runner,
                                "exchange_spool_fallback_total")
        victim2 = pick_victim()
        killed = threading.Event()
        kill_lock = threading.Lock()

        def kill_after_spool(key="", **ctx):
            # EVERY pull of the victim's source task funnels through
            # here (times unlimited): no page is ever served live, so
            # every consumer must replay from the spool — and the kill
            # only lands once the spool is committed
            with kill_lock:
                if not killed.is_set():
                    wait_stage_finished(victim2, source_fid)
                    kill_worker(victim2)
                    killed.set()

        FAILPOINTS.configure(
            "exchange.pull", action="callback",
            callback=kill_after_spool, times=None,
            match=rf":{victim2.port}/v1/task/[^/]*\.{source_fid}\.\d+$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "spool_replay")
        FAILPOINTS.clear()
        replays = _metric_sql(
            runner, "spool_replayed_task_total") - before_replay
        fallbacks = _metric_sql(
            runner, "exchange_spool_fallback_total") - before_fb
        retries = _metric_sql(runner, "task_retry_total") - before
        assert replays >= 1, \
            "lost-but-spooled task was not preserved"
        assert fallbacks >= 1, \
            "no consumer replayed from the spool"
        # the headline assertion: NO source-stage task was re-executed
        # (retries are the victim's other tasks — never the producer
        # whose output lives in the spool)
        events = runner._last_run_info.get("events") or []
        source_retries = [
            ev for ev in events if ev.get("kind") == "task_retry"
            and str(ev.get("task", "")).split(".")[1]
            == str(source_fid)]
        assert not source_retries, \
            f"spooled source task was re-executed: {source_retries}"
        finish(spool_replays=replays, spool_fallbacks=fallbacks,
               task_retries=retries)
        add_worker()

        # -- (g) spool corruption: checksum -> retry from upstream ------
        finish = scenario("spool_corrupt")
        before = _metric_sql(runner, "task_retry_total")
        before_cor = _metric_sql(runner, "spool_corruption_total")
        victim3 = pick_victim()
        killed3 = threading.Event()
        kill3_lock = threading.Lock()
        corrupt_armed = threading.Event()

        def arm_corrupt(key="", task_id="", **ctx):
            # corrupt the first spooled page of a source task ON THE
            # VICTIM (the task id is only known once the worker starts
            # it): the frame keeps the original checksum, the payload
            # flips one byte on disk. Arming by exact task id matters:
            # a survivor's corrupted page would be served from the
            # clean in-memory fast path and never detected.
            import re as _re
            if task_id.split(".")[1] == str(source_fid) \
                    and not corrupt_armed.is_set():
                corrupt_armed.set()
                FAILPOINTS.configure(
                    "spool.corrupt", action="error", times=1,
                    match=rf"^{_re.escape(task_id)}/")

        FAILPOINTS.configure("worker.task_run", action="callback",
                             callback=arm_corrupt, times=None,
                             match=f"@{victim3.node_id}$")

        def kill_after_corrupt(key="", **ctx):
            with kill3_lock:
                if not killed3.is_set():
                    wait_stage_finished(victim3, source_fid)
                    kill_worker(victim3)
                    killed3.set()

        FAILPOINTS.configure(
            "exchange.pull", action="callback",
            callback=kill_after_corrupt, times=None,
            match=rf":{victim3.port}/v1/task/[^/]*\.{source_fid}\.\d+$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "spool_corrupt")
        FAILPOINTS.clear()
        corruptions = _metric_sql(
            runner, "spool_corruption_total") - before_cor
        retries = _metric_sql(runner, "task_retry_total") - before
        assert corrupt_armed.is_set(), \
            "victim never ran a source task to corrupt"
        assert corruptions >= 1, \
            "corrupted spool page was served without detection"
        assert retries >= 1, \
            "spool corruption did not re-run the producer"
        finish(corruptions=corruptions, task_retries=retries)
        add_worker()

        # -- (h) elastic join: a fresh worker boots + announces -------
        # mid-query while another dies; the re-created tasks land on
        # the late joiner
        finish = scenario("worker_join")
        before = _metric_sql(runner, "task_retry_total")
        before_join = _metric_sql(runner, "node_joined_total")
        victim4 = pick_victim()
        joiner: dict = {}

        def kill_and_join(key="", **ctx):
            kill_worker(victim4)
            joiner["w"] = add_worker()

        FAILPOINTS.configure("worker.task_run", action="callback",
                             callback=kill_and_join, times=1,
                             match=f"@{victim4.node_id}$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "worker_join")
        FAILPOINTS.clear()
        retries = _metric_sql(runner, "task_retry_total") - before
        joined = _metric_sql(runner, "node_joined_total") - before_join
        assert retries >= 1, "worker death did not trigger a retry"
        assert joined >= 1, "the late joiner was never federated"
        joiner_url = f"http://127.0.0.1:{joiner['w'].port}"
        events = runner._last_run_info.get("events") or []
        landed = [ev for ev in events
                  if ev.get("kind") == "task_retry"
                  and ev.get("to") == joiner_url]
        assert landed, \
            f"no re-created task landed on the late joiner: {events}"
        finish(task_retries=retries, joined=joined,
               landed_on_joiner=len(landed))

        # -- (i) drain-and-exit: SHUTTING_DOWN mid-read ----------------
        # the worker exits within its drain grace while the root is
        # still consuming its output; the root finishes from the spool
        # with ZERO task retries
        finish = scenario("drain_exit")
        before = _metric_sql(runner, "task_retry_total")
        before_fb = _metric_sql(runner,
                                "exchange_spool_fallback_total")
        victim5 = pick_victim()
        drained = threading.Event()
        drain_lock = threading.Lock()

        def drain_after_finish(key="", **ctx):
            with drain_lock:
                if not drained.is_set():
                    wait_stage_finished(victim5, feed_fid)
                    victim5.begin_shutdown()
                    drained.set()

        # the root's pulls of the victim's feed-stage task trigger the
        # drain (once that task finished), then slow to one page per
        # second — guaranteeing the worker is GONE before the root
        # drains the buffer, so the tail must come from the spool
        FAILPOINTS.configure(
            "exchange.pull", action="callback",
            callback=drain_after_finish, times=None,
            match=rf":{victim5.port}/v1/task/[^/]*\.{feed_fid}\.\d+$")
        FAILPOINTS.configure(
            "exchange.pull", action="sleep", sleep_s=1.0, times=None,
            match=rf":{victim5.port}/v1/task/[^/]*\.{feed_fid}\.\d+$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "drain_exit")
        FAILPOINTS.clear()
        retries = _metric_sql(runner, "task_retry_total") - before
        fallbacks = _metric_sql(
            runner, "exchange_spool_fallback_total") - before_fb
        assert retries == 0, \
            f"drain caused {retries} retries (spool should replay)"
        assert fallbacks >= 1, \
            "root never replayed the drained worker's output"
        # the drained worker's process actually EXITED within its
        # grace (no lingering until downstream completion): its socket
        # must refuse within a short post-query window
        exit_deadline = time.time() + 5.0
        gone = False
        while time.time() < exit_deadline:
            try:
                import urllib.request
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{victim5.port}/v1/info",
                        timeout=1):
                    pass
            except Exception:
                gone = True
                break
            time.sleep(0.1)
        assert gone, "drained worker lingered past its grace"
        assert f"http://127.0.0.1:{victim5.port}" \
            not in runner._schedulable_workers()
        finish(task_retries=retries, spool_fallbacks=fallbacks)

        # the retry count is part of the query history record
        res = runner.local.execute(
            "select retries from system.runtime.completed_queries "
            "where mode = 'cluster' order by create_time")
        assert res.rows and any(int(r[0]) >= 1 for r in res.rows), \
            "no completed_queries record carries a retry count"

        # spool GC: after every scenario (successes, kills, drains and
        # fail-fast aborts alike) no per-query spool directory survives
        orphans = SPOOL.query_dirs()
        assert not orphans, f"orphaned spool directories: {orphans}"
        summary["orphans"] = len(orphans)

        # a spec naming an unregistered site would inject nothing and
        # "pass" every scenario above: the registry refuses to arm it
        finish = scenario("failpoint_validation")
        rejected = False
        try:
            FAILPOINTS.configure_from_spec("worker.task_ruin=error")
        except ValueError as e:
            rejected = "unknown failpoint site" in str(e)
        assert rejected, "typo'd failpoint spec was silently accepted"
        finish(rejected=True)
        summary["ok"] = True
        return summary
    finally:
        FAILPOINTS.clear()
        for w in workers:
            try:
                w.stop()
            except Exception:
                pass
        runner.detector.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=0.01,
                    help="TPC-H scale factor (default 0.01)")
    ap.add_argument("--device", default=None,
                    help="torch device of the workers (default: the GPU)")
    ap.add_argument("--straggler-sleep-s", type=float, default=10.0)
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    summary = run_chaos(sf=args.sf, device=args.device,
                        straggler_sleep_s=args.straggler_sleep_s,
                        verbose=not args.quiet)
    print(json.dumps(summary, indent=2))
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
