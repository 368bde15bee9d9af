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
- ``preemption_storm``: seeded Poisson preemptions (drain notices)
  under query load, a replacement joining each time: no query fails and
  at least one preempted worker's output is replayed from the spool.
- ``scale_to_zero``: with the spool on the object-store backend, every
  worker is killed after the source stage committed and two fresh ones
  join: the query completes from the object store, and no object-spool
  query is left (the process-wide spool's settings are restored after).

Recovery is observed through ``system.runtime.metrics`` over SQL
(``task_retry_total``, ``speculative_won_total``,
``spool_replayed_task_total``, ``exchange_spool_fallback_total``,
``spool_corruption_total``, ``node_joined_total``,
``spool_object_put_total`` / ``_get_total``); at the end the spool
holds no per-query directory, and ``summary["elastic"]`` holds the
elastic scenarios' recovery times in the reference's bench format.

``run_fleet_chaos`` kills one of three coordinators over one worker
pool mid-run (no failed query, ``coordinator_lost_total`` over SQL).
``run_elastic_ramp`` drives ``exec/autoscale.LocalProcessProvider``
subprocess workers 1 -> N -> 1 under client load (drain-only
scale-down; peak QPS at least 1.5x the one-worker floor).

Run it: ``python -m presto_tpu_torch._devtools.chaos --device cpu``
(prints a JSON summary; ``--ramp`` adds the load ramp's block,
``--elastic-out PATH`` writes the elastic block, ``--fleet`` runs the
fleet drill instead).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time

QUERY = ("select l_returnflag, l_linestatus, count(*) c, "
         "sum(l_quantity) q, sum(l_extendedprice) e from lineitem "
         "where l_shipdate <= date '1998-09-02' "
         "group by 1, 2 order by 1, 2")

#: the load ramp's query: a selective scan, not an aggregate. Its device
#: cost is the batches scanned (which shrink per worker as the pool
#: grows), while its small result keeps exchange, sort and client cost
#: flat; an aggregate collapses each task to about one output page
RAMP_QUERY = ("select l_orderkey, l_linenumber, l_extendedprice "
              "from lineitem where l_extendedprice > 90000 "
              "order by 1, 2")


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

        # -- (j) preemption storm: workers are preemptible by design ---
        # Poisson-cadence preemptions (seeded, so replayable) under
        # sustained query load: every preemption is a drain notice
        # (begin_shutdown: active tasks commit their spool, the worker
        # stops), a replacement joins, and no query fails. The first
        # preemption is deterministic (the drain_exit recipe), so at
        # least one coordinator-side spool replay happens whatever the
        # storm's timing
        finish = scenario("preemption_storm")
        # drain_exit left two live workers; the storm's two-live guard
        # needs headroom after the deterministic first drain
        while len(live_workers()) < 3:
            add_worker()
        before_replay = _metric_sql(runner, "spool_replayed_task_total")
        before_fb = _metric_sql(runner,
                                "exchange_spool_fallback_total")
        victim6 = pick_victim()
        preempted = threading.Event()
        pre_lock = threading.Lock()

        def preempt_after_finish(key="", **ctx):
            with pre_lock:
                if not preempted.is_set():
                    wait_stage_finished(victim6, feed_fid)
                    victim6.begin_shutdown()
                    preempted.set()

        FAILPOINTS.configure(
            "exchange.pull", action="callback",
            callback=preempt_after_finish, times=None,
            match=rf":{victim6.port}/v1/task/[^/]*\.{feed_fid}\.\d+$")
        FAILPOINTS.configure(
            "exchange.pull", action="sleep", sleep_s=1.0, times=None,
            match=rf":{victim6.port}/v1/task/[^/]*\.{feed_fid}\.\d+$")
        _assert_rows_equal(runner.execute(query).rows, want,
                           "preemption_storm")
        FAILPOINTS.clear()
        preemptions = [1]
        storm_stop = threading.Event()
        rng = random.Random(0xE1A57)

        def storm() -> None:
            # exponential inter-arrivals: a Poisson preemption process;
            # never preempt below two live workers (a preemptible pool
            # has a floor too: the autoscaler's min_workers)
            while not storm_stop.wait(rng.expovariate(1 / 0.5)):
                lw = live_workers()
                if len(lw) < 2:
                    continue
                v = max(lw, key=lambda w: f"http://127.0.0.1:{w.port}")
                v.begin_shutdown()
                preemptions[0] += 1
                add_worker()

        st = threading.Thread(target=storm, daemon=True)
        st.start()
        storm_queries = 1
        storm_deadline = time.time() + 60.0
        try:
            # bounded by preemptions, not by queries: on a warm cluster
            # a fixed query budget can end before three arrivals land
            # (the wall-clock cap guards a wedged storm thread)
            while (storm_queries < 5 or preemptions[0] < 3) \
                    and time.time() < storm_deadline:
                _assert_rows_equal(runner.execute(query).rows, want,
                                   "preemption_storm")
                storm_queries += 1
        finally:
            storm_stop.set()
            st.join(timeout=5)
        while len(live_workers()) < 3:
            add_worker()
        replays = _metric_sql(
            runner, "spool_replayed_task_total") - before_replay
        fallbacks = _metric_sql(
            runner, "exchange_spool_fallback_total") - before_fb
        assert preemptions[0] >= 3, \
            f"storm landed only {preemptions[0]} preemptions"
        assert replays >= 1, \
            "no preempted worker's output was replayed from the spool"
        finish(queries=storm_queries, preemptions=preemptions[0],
               spool_replays=replays, spool_fallbacks=fallbacks)

        # -- (k) scale to zero: the worker set vanishes entirely -------
        # mid-shuffle with the spool on the object-store backend (a
        # latency-modeled GCS/S3 stand-in): every worker is killed after
        # the source stage committed, two fresh workers join, and the
        # query completes with the same rows: shuffle state outlived the
        # whole worker set because it lives in the object store
        finish = scenario("scale_to_zero")
        obj_dir = tempfile.mkdtemp(prefix="chaos-objspool-")
        saved_spool = SPOOL.settings()
        SPOOL.configure(backend="object", object_dir=obj_dir,
                        object_put_latency_s=0.002,
                        object_get_latency_s=0.002)
        try:
            before = _metric_sql(runner, "task_retry_total")
            before_replay = _metric_sql(runner,
                                        "spool_replayed_task_total")
            before_put = _metric_sql(runner, "spool_object_put_total")
            before_get = _metric_sql(runner, "spool_object_get_total")
            wiped = threading.Event()
            wipe_lock = threading.Lock()

            def wipe(key="", **ctx):
                with wipe_lock:
                    if wiped.is_set():
                        return
                    lw = live_workers()
                    deadline = time.time() + 30.0
                    while time.time() < deadline:
                        src = [t for w in lw
                               for t in list(w.tasks.values())
                               if t.task_id.split(".")[1]
                               == str(source_fid)]
                        if src and all(t.state == "FINISHED"
                                       for t in src):
                            break
                        time.sleep(0.05)
                    else:
                        raise AssertionError(
                            "source stage never committed before "
                            "the wipe")
                    for w in lw:
                        kill_worker(w)
                    add_worker()
                    add_worker()
                    wiped.set()

            FAILPOINTS.configure(
                "exchange.pull", action="callback", callback=wipe,
                times=None,
                match=rf"/v1/task/[^/]*\.{source_fid}\.\d+$")
            _assert_rows_equal(runner.execute(query).rows, want,
                               "scale_to_zero")
            FAILPOINTS.clear()
            assert wiped.is_set(), "the wipe callback never fired"
            replays = _metric_sql(
                runner, "spool_replayed_task_total") - before_replay
            retries = _metric_sql(runner, "task_retry_total") - before
            puts = _metric_sql(
                runner, "spool_object_put_total") - before_put
            gets = _metric_sql(
                runner, "spool_object_get_total") - before_get
            assert replays >= 1, \
                "no source task was preserved across the wipe"
            assert retries >= 1, \
                "no downstream task was re-created on fresh workers"
            assert puts >= 1 and gets >= 1, \
                f"object-store spool never moved (puts={puts}, " \
                f"gets={gets})"
            # per-query GC held across the wipe: no orphaned objects
            obj_orphans = SPOOL.object_store.query_dirs()
            assert not obj_orphans, \
                f"orphaned object-spool queries: {obj_orphans}"
            finish(spool_replays=replays, task_retries=retries,
                   object_puts=puts, object_gets=gets,
                   object_orphans=len(obj_orphans))
        finally:
            FAILPOINTS.clear()
            SPOOL.restore(saved_spool)
            shutil.rmtree(obj_dir, ignore_errors=True)
        while len(live_workers()) < 3:
            add_worker()

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

        # the recovery-time summary of the elastic scenarios, in the
        # reference's bench format (all *_ms: lower is better)
        elastic_scenarios = ("worker_death", "spool_replay",
                             "spool_corrupt", "worker_join",
                             "drain_exit", "preemption_storm",
                             "scale_to_zero")
        summary["elastic"] = {
            "metric": "elastic_recovery_ms",
            "value": round(sum(
                summary["scenarios"][s]["elapsed_s"]
                for s in elastic_scenarios) * 1e3, 1),
            "sub_metrics": [
                {"metric": f"{s}_ms",
                 "value": round(
                     summary["scenarios"][s]["elapsed_s"] * 1e3, 1)}
                for s in elastic_scenarios],
        }
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


def run_fleet_chaos(sf: float = 0.01, coordinators: int = 3,
                    clients: int = 2, per_client: int = 3, device=None,
                    rows_per_batch: int = 1 << 17,
                    verbose: bool = False) -> dict:
    """Coordinator-death drill: an in-process fleet of ``coordinators``
    statement servers over one shared worker pool on ``device`` (the GPU
    when none is named), one coordinator killed mid-run.

    Holds the fleet contract end to end: no failed query (the
    ``FleetClient`` re-dispatches around the corpse), the survivors drop
    the dead coordinator's federated resource-group counts once its
    heartbeats age past the staleness grace, and the loss is counted:
    ``coordinator_lost_total``, read back over SQL from a survivor."""
    from ..client import FleetClient
    from ..device import resolve_device
    from ..exec.cluster import ClusterRunner
    from ..exec.discovery import DiscoveryNodeManager
    from ..exec.failpoints import FAILPOINTS
    from ..server.protocol import PrestoTpuServer
    from ..server.worker import WorkerServer
    device = resolve_device(device)

    def log(msg: str) -> None:
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    groups = {
        "rootGroups": [
            {"name": "serving", "hardConcurrencyLimit": 8,
             "maxQueued": 1000}],
        "selectors": [{"group": "serving"}]}

    # one shared discovery plane = one shared worker pool: every
    # coordinator's scheduler reads the same membership
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    worker = WorkerServer(tpch_sf=sf, device=device)
    worker.start()
    discovery.announce(worker.node_id,
                       f"http://127.0.0.1:{worker.port}")

    servers = []
    summary: dict = {"sf": sf, "coordinators": coordinators,
                     "device": str(device), "scenarios": {}}
    FAILPOINTS.clear()
    try:
        for _ in range(coordinators):
            runner = ClusterRunner(tpch_sf=sf, heartbeat=False,
                                   discovery=discovery, device=device,
                                   rows_per_batch=rows_per_batch)
            srv = PrestoTpuServer(runner, resource_groups=groups,
                                  discovery=discovery)
            srv.start()
            servers.append(srv)
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        for i, srv in enumerate(servers):
            srv.enable_fleet(
                f"coord-{i}",
                peers=[u for j, u in enumerate(urls) if j != i],
                heartbeat_s=0.2, staleness_grace_s=0.6)
        victim_idx = coordinators - 1
        victim_id = f"coord-{victim_idx}"

        # the kill only means something once the victim's heartbeats
        # are in every survivor's federated admission view
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if all(victim_id in s.fleet.status()["remote"]
                   for s in servers[:victim_idx]):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(
                "victim heartbeats never reached the survivors")

        # warm every coordinator once (round-robin covers the fleet)
        # and take the fault-free rows
        warm = FleetClient(urls, user="fleet-chaos")
        want = warm.execute(QUERY).rows
        for _ in range(coordinators - 1):
            _assert_rows_equal(warm.execute(QUERY).rows, want,
                               "fleet_warmup")
        warm.close()
        log(f"fleet warm: {len(want)} rows via {coordinators} "
            f"coordinators")

        t0 = time.perf_counter()
        total = clients * per_client
        kill_after = max(1, total // 3)
        done = [0]
        count_lock = threading.Lock()
        killed = threading.Event()
        errors: list = []
        fleet_clients = []
        kill_gate = threading.Lock()

        def ensure_killed() -> None:
            # checked by every client before each dispatch: once the
            # statement count passes the threshold the kill happens
            # before every remaining dispatch, and the ring rotation
            # puts at least one of them on the victim's slot (a polling
            # killer thread can lose the race on a loaded host)
            if killed.is_set():
                return
            with count_lock:
                due = done[0] >= kill_after
            if due:
                with kill_gate:
                    if not killed.is_set():
                        log(f"killing {victim_id} after {done[0]} "
                            f"statements")
                        servers[victim_idx].kill()
                        killed.set()

        def client_run(ci: int) -> None:
            fc = FleetClient(urls, user="fleet-chaos")
            fleet_clients.append(fc)
            for _ in range(per_client):
                ensure_killed()
                try:
                    res = fc.execute(QUERY)
                    _assert_rows_equal(res.rows, want,
                                       "coordinator_kill")
                except Exception as e:        # noqa: BLE001
                    errors.append(f"client {ci}: {e!r}")
                with count_lock:
                    done[0] += 1

        threads = [threading.Thread(target=client_run, args=(ci,))
                   for ci in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert killed.is_set(), "the kill threshold was never reached"
        assert not errors, f"queries failed across the kill: {errors}"

        # deterministic failover probe: one more statement whose ring
        # starts at the corpse (the concurrent clients may all have
        # drawn their victim-slot visit before the kill)
        probe = FleetClient(urls, user="fleet-chaos")
        probe._rr = victim_idx
        fleet_clients.append(probe)
        _assert_rows_equal(probe.execute(QUERY).rows, want,
                           "failover_probe")
        probe.close()
        total += 1

        # survivors absorb the loss: the dead coordinator ages out of
        # the federated admission view after the staleness grace and
        # lands in the lost ledger; the counter is SQL-visible
        deadline = time.time() + 10.0
        absorbed = False
        lost_seen = 0.0
        views = []
        while time.time() < deadline:
            views = [s.fleet.status() for s in servers[:victim_idx]]
            absorbed = all(
                victim_id in v["lost"]
                and victim_id not in v["remote"] for v in views)
            lost_seen = _metric_sql(servers[0].runner,
                                    "coordinator_lost_total")
            if absorbed and lost_seen >= 1.0:
                break
            time.sleep(0.1)
        assert absorbed, \
            f"survivors still count the dead coordinator: {views}"
        assert lost_seen >= 1.0, "coordinator_lost_total never moved"

        summary["scenarios"]["coordinator_kill"] = {
            "elapsed_s": round(time.perf_counter() - t0, 3),
            "queries": total,
            "failed": len(errors),
            "failovers": sum(fc.failovers_total
                             for fc in fleet_clients),
            "retries": sum(fc.retries_total for fc in fleet_clients),
            "coordinator_lost_total": lost_seen,
            "survivor_lost_view": sorted(views[0]["lost"]),
        }
        log(f"coordinator_kill: "
            f"{summary['scenarios']['coordinator_kill']}")
        summary["ok"] = True
        return summary
    finally:
        FAILPOINTS.clear()
        for srv in servers:
            try:
                srv.kill()
            except Exception:
                pass
        try:
            worker.stop()
        except Exception:
            pass


def run_elastic_ramp(sf: float = 0.02, phases=(1, 3, 1),
                     phase_s: float = 8.0, clients: int = 4,
                     device_floor_ms: float = 60.0,
                     rows_per_batch: int = 16384, device=None,
                     on_event=None, verbose: bool = False) -> dict:
    """Load ramp: sustained client load while the worker pool scales
    1 -> N -> 1 through the autoscaler's node plane, every worker a
    subprocess on ``device`` (the GPU when none is named; raises
    without one).

    Workers are real subprocesses (``LocalProcessProvider``, the
    provider the config-driven autoscaler boots), announcing to an
    in-process coordinator over HTTP and sharing one spool directory;
    scale-down is always the drain path (SHUTTING_DOWN -> spool commit
    -> explicit deregister -> process exit), never a kill. The
    reference's contract:

    - throughput tracks the ramp: peak-N QPS >= 1.5x the 1-worker floor;
    - no failed query across every transition, drains included;
    - the pool really returns to 1.

    ``device_floor_ms`` sets ``PRESTO_TPU_TORCH_DEVICE_FLOOR_MS`` on the
    worker processes: a fixed-throughput device model (each quantum,
    and each scanned batch, holds the device at least that long), so
    per-worker capacity is the bottleneck whatever the host's cores.
    ``rows_per_batch`` is low so a query scans many batches that can
    spread across the pool; the query is ``RAMP_QUERY`` (a selective
    scan) for the same reason. ``on_event(kind, **fields)``, when given,
    hears each launch, drain and phase as it happens."""
    from ..client import StatementClient
    from ..device import resolve_device
    from ..exec.autoscale import LocalProcessProvider
    from ..exec.cluster import ClusterRunner
    from ..exec.discovery import DiscoveryNodeManager
    from ..exec.spool import SPOOL
    from ..server.protocol import PrestoTpuServer
    device = resolve_device(device)

    def log(msg: str) -> None:
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    def event(kind: str, **fields) -> None:
        if on_event is not None:
            on_event(kind, **fields)

    if not (phases and phases[0] == 1 and phases[-1] == 1
            and max(phases) > 1):
        raise ValueError("the ramp must go 1 -> N -> 1 (the scale-down "
                         f"is part of the claim): {phases}")

    groups = {
        "rootGroups": [
            {"name": "ramp", "hardConcurrencyLimit": 8,
             "maxQueued": 10000}],
        "selectors": [{"group": "ramp"}]}

    # one shared spool directory: drained workers' committed output
    # must be replayable by the survivors across process boundaries
    spool_dir = tempfile.mkdtemp(prefix="ramp-spool-")
    saved_spool = SPOOL.settings()
    SPOOL.configure(directory=spool_dir)
    discovery = DiscoveryNodeManager(ttl_s=3600.0)
    srv = provider = warm = None
    stop_evt = threading.Event()
    count_lock = threading.Lock()
    completed = [0]
    errors: list = []
    threads: list = []
    want: list = []

    def set_workers(target: int, timeout_s: float = 120.0) -> None:
        """Converge the pool to ``target``: launches for scale-up, the
        drain path for scale-down; then wait until the coordinator's
        discovery view agrees (drained workers leave by an explicit GONE
        announcement, so membership is prompt)."""
        while len(provider.nodes()) < target:
            t0 = time.perf_counter()
            h = provider.launch()
            event("launch", node=h.node_id,
                  ready_s=time.perf_counter() - t0)
            log(f"ramp: launched {h.node_id}")
        while len(provider.nodes()) > target:
            h = provider.nodes()[-1]
            log(f"ramp: draining {h.node_id}")
            t0 = time.perf_counter()
            if not provider.drain(h, timeout_s=timeout_s):
                raise AssertionError(
                    f"worker {h.node_id} did not drain out")
            event("drain", node=h.node_id, code=h.proc.returncode,
                  exit_s=time.perf_counter() - t0)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if len(discovery.active_urls()) == target:
                return
            time.sleep(0.05)
        raise AssertionError(
            f"discovery never converged to {target} workers: "
            f"{discovery.nodes()}")

    def client_run(ci: int) -> None:
        sc = StatementClient(url, user="ramp")
        try:
            while not stop_evt.is_set():
                try:
                    res = sc.execute(RAMP_QUERY)
                    _assert_rows_equal(res.rows, want, "ramp")
                except Exception as e:          # noqa: BLE001
                    if stop_evt.is_set():
                        return
                    errors.append(f"client {ci}: {e!r}")
                    return
                with count_lock:
                    completed[0] += 1
        finally:
            sc.close()

    try:
        runner = ClusterRunner(tpch_sf=sf, heartbeat=False,
                               discovery=discovery, device=device,
                               rows_per_batch=rows_per_batch)
        srv = PrestoTpuServer(runner, resource_groups=groups,
                              discovery=discovery)
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        provider = LocalProcessProvider(
            [url], tpch_sf=sf, spool_dir=spool_dir, device=device,
            extra_env={"PRESTO_TPU_TORCH_DEVICE_FLOOR_MS":
                       str(device_floor_ms)} if device_floor_ms else None)
        # floor worker and fault-free rows before any load
        set_workers(1)
        warm = StatementClient(url, user="ramp")
        want.extend(warm.execute(RAMP_QUERY).rows)
        log(f"ramp: reference {len(want)} rows via 1 worker")

        threads = [threading.Thread(target=client_run, args=(ci,),
                                    daemon=True)
                   for ci in range(clients)]
        for t in threads:
            t.start()

        phase_rows = []
        for target in phases:
            set_workers(target)        # the transition happens under load
            # absorb a fresh worker's first queries (its CUDA context,
            # its first splits) before the window opens: provisioning
            # latency, not steady-state throughput
            for _ in range(2):
                _assert_rows_equal(warm.execute(RAMP_QUERY).rows,
                                   want, "ramp-warmup")
            with count_lock:
                c0, e0 = completed[0], len(errors)
            t0 = time.perf_counter()
            time.sleep(phase_s)
            with count_lock:
                c1, e1 = completed[0], len(errors)
            w = time.perf_counter() - t0
            phase_rows.append({
                "workers": target,
                "queries": c1 - c0,
                "failed": e1 - e0,
                "qps": round((c1 - c0) / w, 2),
                "window_s": round(w, 2)})
            event("phase", **phase_rows[-1])
            log(f"ramp: phase {phase_rows[-1]}")

        stop_evt.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, f"queries failed across the ramp: {errors}"
        assert len(provider.nodes()) == 1 \
            and len(discovery.active_urls()) == 1, \
            "the pool did not return to 1 worker"

        floor = phase_rows[0]["qps"]
        peak = max(r["qps"] for r in phase_rows
                   if r["workers"] == max(phases))
        ratio = round(peak / floor, 3) if floor > 0 else 0.0
        ramp = {"sf": sf, "clients": clients,
                "device_floor_ms": device_floor_ms,
                "phases": phase_rows, "peak_over_floor": ratio}
        assert ratio >= 1.5, \
            (f"peak QPS {peak} is only {ratio}x the 1-worker floor "
             f"{floor} (need >= 1.5x): {phase_rows}")
        return ramp
    finally:
        stop_evt.set()
        for t in threads:
            t.join(timeout=10)
        if warm is not None:
            warm.close()
        if srv is not None:
            srv.kill()
        if provider is not None:
            provider.stop_all()
        SPOOL.restore(saved_spool)
        shutil.rmtree(spool_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=0.01,
                    help="TPC-H scale factor (default 0.01)")
    ap.add_argument("--device", default=None,
                    help="torch device of the workers (default: the GPU)")
    ap.add_argument("--straggler-sleep-s", type=float, default=10.0)
    ap.add_argument("--fleet", action="store_true",
                    help="run the coordinator-fleet death drill instead "
                         "of the worker scenarios")
    ap.add_argument("--ramp", action="store_true",
                    help="also run the 1 -> N -> 1 load ramp (subprocess "
                         "workers) and attach its block to the elastic "
                         "summary")
    ap.add_argument("--elastic-out", default=os.environ.get("ELASTIC_OUT"),
                    metavar="PATH",
                    help="write the elastic recovery-time summary (the "
                         "reference's bench format) to PATH")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.fleet:
        summary = run_fleet_chaos(sf=args.sf, device=args.device,
                                  verbose=not args.quiet)
        print(json.dumps(summary, indent=2))
        return 0 if summary.get("ok") else 1
    summary = run_chaos(sf=args.sf, device=args.device,
                        straggler_sleep_s=args.straggler_sleep_s,
                        verbose=not args.quiet)
    if args.ramp and summary.get("elastic"):
        summary["elastic"]["ramp"] = run_elastic_ramp(
            device=args.device, verbose=not args.quiet)
    print(json.dumps(summary, indent=2))
    if args.elastic_out and summary.get("elastic"):
        tmp = args.elastic_out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(summary["elastic"], f, indent=2)
        os.replace(tmp, args.elastic_out)
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
