"""Cluster runner: the coordinator scheduling fragments onto workers.

The counterpart of ``presto_tpu/exec/cluster.py``, the coordinator half
of the multi-process runtime (reference presto-main/.../execution/
scheduler/SqlQueryScheduler.java:112,281,533 stage tree and task launch;
server/remotetask/HttpRemoteTask.java:100 task lifecycle over HTTP;
execution/SqlStageExecution.java). The mesh path (``exec/distributed.py``)
runs one controller over device slots in one process; this is the other
story: independent worker servers (``server/worker.py``), each owning a
device, exchanging pages over HTTP. Several workers may share one card:
in-process workers share its CUDA context, allocator, scan cache and
device scheduler; subprocess workers each hold a context of their own.

Scheduling (the reference's NodeScheduler / UniformNodeSelector,
simplified to uniform assignment):

- ``source`` fragments: splits round-robin over the ACTIVE workers, one
  task per worker that received splits;
- ``fixed`` fragments: one task on every active worker, input pages
  hash-routed by the producer (buffer index = consumer partition);
- ``single`` fragments: one task on the first worker.

Failure handling (the reference's failuredetector/
HeartbeatFailureDetector and the fault-tolerant execution's retries over
a spooled exchange):

- a background heartbeat pings ``/v1/info``; nodes failing
  ``max_consecutive`` pings are excluded from scheduling;
- ``retry_policy=TASK`` (the default): a FAILED task, or a task lost
  with its worker, is re-created (the same deterministic fragment and
  splits, a new attempt id) on a healthy node with exponential backoff,
  bounded by ``task_retry_attempts``; every transitive downstream
  consumer is re-created too and re-reads its upstreams from token 0,
  out of the durable spool (``exec/spool.py``) or retained buffers;
- ``retry_policy=QUERY``: any task failure re-runs the whole query
  (``query_retry_attempts`` times);
- ``retry_policy=NONE``: fail fast;
- speculative execution: a task the ``StageMonitor`` flags as a
  straggler gets a duplicate attempt on another node; the first to
  finish wins and the loser is aborted (attempt-versioned buffers make
  duplicate rows impossible by construction);
- drain-aware scheduling: nodes reporting ``SHUTTING_DOWN`` finish their
  running tasks but receive no new ones;
- ``query_max_run_time``: a coordinator-side deadline that aborts every
  task of the query on expiry;
- ``cluster_memory_limit``: the ``ClusterMemoryManager`` kills the
  query holding the most memory while the workers' reservations exceed
  it.

Init plans (uncorrelated scalar subqueries) run on the coordinator and
their values ship inside every task update. A subplan that an init plan
shares with the main plan or another init plan (Q15's view, read by the
main plan and by its ``max``) runs once on the workers first, and every
consumer reads its rows as a ``ValuesNode``: run twice, its double sums
would add in two orders, and an equality on them could match no row.
(The local executor keeps the same promise by memoizing the subplan.)

Device: ``ClusterRunner(device=None)`` takes the GPU and raises without
one. Its embedded ``LocalRunner`` (statements other than queries) and the
coordinator's init plans run there; result pages decode on the host.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
import secrets
import statistics
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..connectors.spi import Split
from ..errors import QueryError
from ..obs.log import LOG
from ..obs.metrics import NODES, REGISTRY, TASKS
from ..obs.trace import TRACER
from ..planner import codec
from ..planner.fragmenter import (
    FragmentedPlan, PlanFragment, fragment_plan,
)
from ..planner.plan import (
    AggregationNode, PlanNode, RemoteSourceNode, TableScanNode, ValuesNode,
    WindowNode,
)
from .failpoints import FAILPOINTS
from .local import QueryResult
from .runner import LocalRunner


class QueryFailedError(RuntimeError):
    pass


class _QueryRetry(Exception):
    """Internal: ``retry_policy=QUERY`` requested a whole-query rerun."""


#: cluster query ids: unique among every ClusterRunner of this process
#: (a sequence) and among coordinators of other processes (a random tag):
#: coordinators sharing a worker pool and a spool directory name their
#: tasks and spool directories by these ids, so two coordinators' ids
#: must never meet on a worker
_QUERY_TAG = secrets.token_hex(3)
_QUERY_SEQ = itertools.count(1)

#: duration strings accepted by ``query_max_run_time`` (reference
#: io.airlift.units.Duration): bare numbers are seconds
_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h)?\s*$")
_DURATION_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


def parse_duration_s(value) -> Optional[float]:
    """'500ms' | '30s' | '5m' | '2h' | 12.5 -> seconds; None/'' -> None."""
    if value is None or value == "":
        return None
    if isinstance(value, (int, float)):
        return float(value)
    m = _DURATION_RE.match(str(value))
    if m is None:
        raise ValueError(f"bad duration {value!r} (want e.g. 30s, 500ms)")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


def _retry_policy(session) -> str:
    p = str(session.properties.get("retry_policy", "TASK")).upper()
    if p not in ("TASK", "QUERY", "NONE"):
        raise ValueError(
            f"retry_policy must be TASK, QUERY or NONE, got {p!r}")
    return p


class HeartbeatFailureDetector:
    """Marks workers dead after consecutive failed pings (reference
    failuredetector/HeartbeatFailureDetector.java:77,360 — the
    exponential-decay rate collapsed to a consecutive-failure budget)."""

    def __init__(self, urls, interval_s: float = 5.0,
                 max_consecutive: int = 3, on_info=None):
        # ``urls`` may be a static list or a zero-arg callable returning
        # the current membership (discovery-fed, reference
        # DiscoveryNodeManager feeding the failure detector)
        self._source = urls if callable(urls) else (lambda: list(urls))
        self.interval_s = interval_s
        self.max_consecutive = max_consecutive
        self.failures: Dict[str, int] = {}
        #: optional ``(url, info_doc)`` callback on every successful
        #: ping — the heartbeat doubles as the node-state federator feed
        self.on_info = on_info
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    @property
    def urls(self) -> List[str]:
        return list(self._source())

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # bounded join (the loop notices _stop within one interval;
        # the in-flight ping holds it at most its 5s timeout): a
        # heartbeat that outlives its runner keeps writing the node
        # registry through teardown (locks/unjoined-thread)
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def ping(self, url: str) -> Optional[dict]:
        """The worker's ``/v1/info`` doc on success (always truthy),
        None on failure."""
        try:
            # failpoint: simulate a missed heartbeat (FailpointError
            # falls into the generic failure path below)
            FAILPOINTS.hit("heartbeat.ping", key=url)
            with urllib.request.urlopen(f"{url}/v1/info",
                                        timeout=5) as resp:
                return json.loads(resp.read()) or {"state": "ACTIVE"}
        except Exception:
            return None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            for u in self.urls:
                info = self.ping(u)
                if info is not None:
                    self.failures[u] = 0
                    if self.on_info is not None:
                        self.on_info(u, info)
                else:
                    self.failures[u] = self.failures.get(u, 0) + 1

    def active(self) -> List[str]:
        return [u for u in self.urls
                if self.failures.get(u, 0) < self.max_consecutive]


class ClusterMemoryManager:
    """Coordinator-side memory guard (reference
    memory/ClusterMemoryManager.java + TotalReservationLowMemoryKiller):
    polls workers' heartbeat memory payloads; while the cluster-wide
    reservation exceeds ``limit_bytes``, kills the query holding the
    most memory (DELETE /v1/query/{id} on every worker)."""

    def __init__(self, runner: "ClusterRunner", limit_bytes: int,
                 interval_s: float = 0.5):
        self.runner = runner
        self.limit = limit_bytes
        self.interval_s = interval_s
        self.killed: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # join like the failure detector: the kill loop must not issue
        # DELETEs against a runner that already tore down its workers
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def poll_once(self) -> Dict[str, int]:
        totals: Dict[str, int] = {}
        for url in self.runner.detector.active():
            try:
                # single attempt, short timeout: the next 0.5s poll is
                # the retry, and enforcement must not stall on a worker
                # the failure detector hasn't evicted yet
                info = self.runner._request(f"{url}/v1/info",
                                            retries=0, timeout=5)
            except Exception:
                continue
            for qid, b in info.get("queryMemory", {}).items():
                totals[qid] = totals.get(qid, 0) + int(b)
        return totals

    def enforce(self, totals: Dict[str, int]) -> None:
        live = {q: b for q, b in totals.items() if q not in self.killed}
        if not live or sum(live.values()) <= self.limit:
            return
        victim = max(live, key=live.get)
        self.killed[victim] = live[victim]
        LOG.log("query_killed_low_memory", query_id=victim,
                reserved_bytes=live[victim], limit_bytes=self.limit)
        for url in list(self.runner.worker_urls):
            try:
                self.runner._request(f"{url}/v1/query/{victim}",
                                     method="DELETE", retries=0,
                                     timeout=5)
            except Exception:
                continue

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.enforce(self.poll_once())


_STRAGGLERS_DETECTED = REGISTRY.counter("straggler_detected_total")
_SKEWED_STAGES = REGISTRY.counter("skewed_stage_total")
_TASK_RETRIES = REGISTRY.counter("task_retry_total")
_QUERY_RETRIES = REGISTRY.counter("query_retry_total")
_SPEC_LAUNCHED = REGISTRY.counter("speculative_launched_total")
_SPEC_WON = REGISTRY.counter("speculative_won_total")
_NODES_DRAINED = REGISTRY.counter("node_drained_total")
_NODES_JOINED = REGISTRY.counter("node_joined_total")
_SPOOL_REPLAYED = REGISTRY.counter("spool_replayed_task_total")


class StageMonitor:
    """Coordinator-side progress + straggler/skew detection over task
    status docs (the role of the reference's SqlStageExecution task
    stats aggregation feeding the low-memory killer and the webapp's
    stage timelines; see tf.data's production straggler story for why
    this must be always-on, not a profiling mode).

    Fed by the status polls the collector already makes: per stage it
    tracks completion progress, flags a task as a straggler when its
    elapsed time exceeds ``straggler_ratio`` x the median of the
    stage's OTHER tasks (median-of-others keeps a 2-task stage
    flaggable), and flags a stage as skewed when its max per-partition
    output row count exceeds ``skew_ratio`` x the stage median (the
    mean is useless here: max/mean is bounded by the task count, so a
    3-task stage could never cross a 4x threshold). Findings
    land in the shared TaskRegistry (``system.runtime.tasks`` columns
    ``straggler``/``skew_ratio``), in counters
    (``straggler_detected_total``/``skewed_stage_total``) so tests can
    assert regressions, and in the structured log."""

    straggler_ratio = 3.0
    min_elapsed_ms = 25.0
    skew_ratio = 4.0
    min_stage_rows = 256

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._stragglers: set = set()
        self._skew: Dict[int, float] = {}
        self.progress: Dict[int, float] = {}
        self.last_statuses: List[dict] = []

    @staticmethod
    def _stage_of(task_id: str) -> int:
        parts = task_id.split(".")
        return int(parts[1]) if len(parts) > 2 and parts[1].isdigit() \
            else 0

    def _by_stage(self, statuses: List[dict]) -> Dict[int, List[dict]]:
        out: Dict[int, List[dict]] = {}
        for st in statuses:
            tid = st.get("taskId")
            if tid:
                out.setdefault(self._stage_of(tid), []).append(st)
        return out

    def observe(self, statuses: List[dict]) -> None:
        self.last_statuses = statuses
        for fid, sts in self._by_stage(statuses).items():
            done = sum(1 for s in sts if s.get("state") == "FINISHED")
            self.progress[fid] = round(100.0 * done / len(sts), 1)
            for st in sts:
                # mirror worker status into the coordinator's registry:
                # system.runtime.tasks works against remote workers too
                TASKS.update(
                    st["taskId"], query_id=self.query_id, stage_id=fid,
                    state=st.get("state", ""),
                    elapsed_ms=float(st.get("elapsedMs") or 0.0),
                    output_rows=int(st.get("rowsOut") or 0),
                    output_bytes=int(st.get("bytesOut") or 0))
            elapsed = [float(s.get("elapsedMs") or 0.0) for s in sts]
            if len(elapsed) < 2:
                continue
            for i, st in enumerate(sts):
                tid = st["taskId"]
                if tid in self._stragglers:
                    continue
                others = elapsed[:i] + elapsed[i + 1:]
                med = statistics.median(others)
                if med >= self.min_elapsed_ms \
                        and elapsed[i] > self.straggler_ratio * med:
                    self._stragglers.add(tid)
                    _STRAGGLERS_DETECTED.inc()
                    TASKS.update(tid, straggler=True)
                    LOG.log("straggler_detected",
                            query_id=self.query_id, task_id=tid,
                            stage_id=fid,
                            elapsed_ms=round(elapsed[i], 1),
                            stage_median_ms=round(med, 1))

    def finalize(self, statuses: List[dict]) -> Dict[str, object]:
        """Final pass once every task reached a terminal state: one
        more straggler sweep over frozen elapsed values (a query that
        finished within one long-poll never hit ``observe``), then
        per-stage output-row skew. Returns the summary that rides the
        query-history record."""
        if statuses:
            self.observe(statuses)
        for fid, sts in self._by_stage(self.last_statuses).items():
            if fid in self._skew or len(sts) < 2:
                continue
            rows = [float(s.get("rowsOut") or 0.0) for s in sts]
            total = sum(rows)
            if total < self.min_stage_rows:
                continue
            # floor the median at one row: an all-in-one-partition
            # stage must flag with a FINITE ratio (inf would leak
            # non-strict "Infinity" tokens into the JSONL history sink
            # and the structured log)
            ratio = max(rows) / max(statistics.median(rows), 1.0)
            if ratio >= self.skew_ratio:
                self._skew[fid] = round(ratio, 2)
                _SKEWED_STAGES.inc()
                for st in sts:
                    TASKS.update(st["taskId"], skew_ratio=round(ratio, 2))
                LOG.log("stage_skew_detected", query_id=self.query_id,
                        stage_id=fid, skew_ratio=round(ratio, 2),
                        rows=[int(r) for r in rows])
        return self.summary()

    @property
    def stragglers(self) -> Set[str]:
        """Task ids flagged as stragglers so far — the speculative
        execution layer's launch feed."""
        return set(self._stragglers)

    def summary(self) -> Dict[str, object]:
        return {"progress": dict(sorted(self.progress.items())),
                "stragglers": sorted(self._stragglers),
                "skewed_stages": dict(sorted(self._skew.items()))}


#: matches the upstream-task reference an ExchangeFailedError embeds in
#: a failed consumer's error string (server/worker.py) — the retry
#: layer's pointer to WHICH attempt to replace
_UPSTREAM_RE = re.compile(r"upstream task (\S+?)[\s:]")


class _TaskAttempt:
    """One live attempt of one logical task (a (fragment, partition)
    slot). Attempt ids are versioned into the task id — every attempt
    owns its own worker-side output buffer, so consumers can never
    interleave pages from two attempts."""

    __slots__ = ("key", "attempt", "worker", "url", "task_id",
                 "speculative")

    def __init__(self, key, attempt, worker, url, task_id,
                 speculative=False):
        self.key = key                  # (fragment_id, partition)
        self.attempt = attempt
        self.worker = worker
        self.url = url
        self.task_id = task_id
        self.speculative = speculative


class _QueryExecution:
    """One cluster query's task graph with fault tolerance: scheduling,
    status-poll driven retry/rescheduling, speculative straggler
    attempts, drain-aware worker choice, and the query deadline. The
    coordinator-side core of the reference's SqlQueryScheduler +
    SqlStageExecution retry machinery, collapsed onto the deterministic
    re-executable task docs this engine already ships."""

    def __init__(self, runner: "ClusterRunner", fp: FragmentedPlan,
                 init_values: List[object], workers: List[str],
                 exec_id: str, monitor: StageMonitor,
                 deadline: Optional[float] = None, session=None):
        self.runner = runner
        self.fp = fp
        self.init_values = init_values
        self.workers = list(workers)
        self.exec_id = exec_id
        self.monitor = monitor
        self.deadline = deadline        # time.monotonic() cutoff
        session = session if session is not None else runner.session
        self.session = session
        self.policy = _retry_policy(session)
        self.max_task_retries = int(
            session.properties.get("task_retry_attempts", 2))
        self.backoff_s = float(
            session.properties.get("task_retry_backoff_s", 0.05))
        from ..planner.planner import bool_property
        self.spec_enabled = self.policy == "TASK" and bool_property(
            session, "speculative_execution", True)
        # spooled exchange (exec/spool.py, default on): non-root tasks
        # write every output page through to the durable page-
        # addressed spool, so consumers replay by token (retries and
        # speculative attempts never re-run healthy upstreams), a
        # drained worker exits without lingering, and shuffle size is
        # no longer capped by worker memory. spool_exchange=false
        # keeps acked pages in the workers' memory instead.
        self.spool = self.policy == "TASK" and bool_property(
            session, "spool_exchange", True)
        self.retain = self.policy == "TASK" and not self.spool
        #: keys whose lost-but-spool-complete attempt was preserved
        #: instead of re-created (the replay-not-rerun ledger)
        self.spool_preserved: Set[Tuple[int, int]] = set()
        # -- graph ------------------------------------------------------------
        self.frag_of: Dict[int, PlanFragment] = {
            f.id: f for f in fp.fragments}
        self.consumer_fid: Dict[int, int] = {}
        for f in fp.fragments:
            for node in _walk(f.root):
                if isinstance(node, RemoteSourceNode):
                    for fid in node.fragment_ids:
                        self.consumer_fid[fid] = f.id
        self.task_count: Dict[int, int] = {}
        self.splits_of: Dict[Tuple[int, int], List[Split]] = {}
        self.parts: Dict[int, List[Tuple[int, int]]] = {}
        self.n_buffers_of: Dict[int, int] = {}
        #: initial placement mirrors the pre-fault-tolerance scheduler:
        #: source tasks follow their split assignment, fixed stages put
        #: one task per worker, single stages take the first worker
        self.placement: Dict[Tuple[int, int], str] = {}
        for f in fp.fragments:
            if f.partitioning == "source":
                keys = []
                part = 0
                for w, splits in zip(self.workers,
                                     runner._assign_splits(
                                         f, self.workers)):
                    if not splits:
                        continue
                    key = (f.id, part)
                    self.splits_of[key] = splits
                    self.placement[key] = w
                    keys.append(key)
                    part += 1
                self.parts[f.id] = keys
            elif f.partitioning == "fixed":
                self.parts[f.id] = [(f.id, p)
                                    for p in range(len(self.workers))]
                for p, w in enumerate(self.workers):
                    self.placement[(f.id, p)] = w
            else:
                self.parts[f.id] = [(f.id, 0)]
                self.placement[(f.id, 0)] = self.workers[0]
            self.task_count[f.id] = len(self.parts[f.id])
        for f in fp.fragments:
            self.n_buffers_of[f.id] = self.task_count.get(
                self.consumer_fid.get(f.id, -1), 1)
        self.root_fid = fp.root.id
        # -- live state -------------------------------------------------------
        self.tasks: Dict[Tuple[int, int], _TaskAttempt] = {}
        self.spec: Dict[Tuple[int, int], _TaskAttempt] = {}
        self.spec_done: Set[Tuple[int, int]] = set()
        #: a failed task's QueryError code (``_probe``): poll raises it
        self.user_error: Optional[int] = None
        self.attempt_no: Dict[Tuple[int, int], int] = {}
        self.retries_used: Dict[Tuple[int, int], int] = {}
        self.bad_workers: Set[str] = set()
        self._sched: Optional[List[str]] = None
        self.retries = 0
        self.spec_launched = 0
        self.spec_won = 0
        self.events: List[Dict[str, object]] = []

    # -- scheduling -----------------------------------------------------------
    def schedule_all(self) -> None:
        """Create every task, upstream-first (the fragments list is in
        dependency order: children were cut before their consumers)."""
        self._sched = None
        for f in self.fp.fragments:
            with TRACER.span("stage", query_id=self.exec_id,
                             stage_id=f.id,
                             partitioning=f.partitioning):
                for key in self.parts[f.id]:
                    self._launch(key,
                                 preferred=self.placement.get(key))

    def _task_id(self, key: Tuple[int, int], attempt: int) -> str:
        base = f"{self.exec_id}.{key[0]}.{key[1]}"
        return base if attempt == 0 else f"{base}.a{attempt}"

    def _sources_for(self, f: PlanFragment) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for node in _walk(f.root):
            if isinstance(node, RemoteSourceNode):
                for fid in node.fragment_ids:
                    out[fid] = [self.tasks[k].url
                                for k in self.parts[fid]]
        return out

    def _schedulable(self) -> List[str]:
        """The runner's schedulable set, swept at most once per
        scheduling burst / recovery round (``schedule_all`` and
        ``poll`` invalidate). With heartbeat off the runner sweep
        probes every worker synchronously (~5s per unreachable host),
        so per-launch sweeps would serialize exactly the dead-worker
        recovery they serve."""
        if self._sched is None:
            self._sched = self.runner._schedulable_workers()
        return self._sched

    def _pick_worker(self, exclude: Set[str] = frozenset()) -> str:
        """A schedulable worker for a (re)launch: heartbeat-alive, not
        draining, not observed bad this query; prefer workers outside
        ``exclude`` (the failed attempt's host), least-loaded first."""
        cands = [w for w in self._schedulable()
                 if w not in self.bad_workers]
        if not cands:
            cands = [w for w in self.runner.detector.active()
                     if w not in self.bad_workers]
        if not cands:
            raise QueryFailedError(
                "no active workers to (re)schedule task")
        load: Dict[str, int] = {}
        for at in self.tasks.values():
            load[at.worker] = load.get(at.worker, 0) + 1
        preferred = [w for w in cands if w not in exclude] or cands
        return min(preferred, key=lambda w: (load.get(w, 0),
                                             cands.index(w)))

    def _launch(self, key: Tuple[int, int],
                preferred: Optional[str] = None,
                exclude: Set[str] = frozenset(),
                speculative: bool = False) -> _TaskAttempt:
        """Create one attempt of ``key`` on a healthy worker; workers
        that refuse the create are marked bad and another is tried."""
        f = self.frag_of[key[0]]
        tried: Set[str] = set()
        while True:
            worker = preferred if preferred is not None \
                and preferred not in tried \
                and preferred not in self.bad_workers \
                else self._pick_worker(exclude | tried)
            attempt = self.attempt_no.get(key, -1) + 1
            self.attempt_no[key] = attempt
            task_id = self._task_id(key, attempt)
            retain = self.retain and key[0] != self.root_fid
            spool = self.spool and key[0] != self.root_fid
            try:
                url = self.runner._create_task(
                    worker, self.exec_id, f, key[1],
                    self.n_buffers_of[f.id],
                    self.splits_of.get(key, []),
                    self._sources_for(f), self.init_values,
                    task_id=task_id, retain=retain, spool=spool,
                    session=self.session)
            except QueryFailedError:
                # the chosen worker is unreachable: exclude it and try
                # the next one (its running tasks are recovered by the
                # status-poll path, not here)
                tried.add(worker)
                self.bad_workers.add(worker)
                continue
            except urllib.error.HTTPError as e:
                # HTTP-level refusal that survived _request's 5xx retry
                # budget — e.g. a 503 from a worker that began draining
                # between the schedulable sweep and this create: treat
                # the worker as bad and pick another. 4xx refusals are
                # deterministic (a malformed doc would fail everywhere)
                # so they fail the query with the worker's verdict.
                if e.code >= 500:
                    tried.add(worker)
                    self.bad_workers.add(worker)
                    continue
                detail = e.read().decode(errors="replace")
                raise QueryFailedError(
                    f"worker refused task create "
                    f"({e.code}): {detail}") from None
            at = _TaskAttempt(key, attempt, worker, url, task_id,
                              speculative=speculative)
            if speculative:
                self.spec[key] = at
            else:
                self.tasks[key] = at
            return at

    # -- views ----------------------------------------------------------------
    def root_url(self) -> str:
        return self.tasks[(self.root_fid, 0)].url

    def all_urls(self) -> List[str]:
        return [at.url for at in self.tasks.values()] + \
               [at.url for at in self.spec.values()]

    def summary(self) -> Dict[str, object]:
        return {"policy": self.policy, "retries": self.retries,
                "speculative_launched": self.spec_launched,
                "speculative_won": self.spec_won,
                "events": list(self.events)}

    # -- recovery -------------------------------------------------------------
    def _delete(self, at: _TaskAttempt) -> None:
        try:
            self.runner._request(at.url, method="DELETE", retries=0,
                                 timeout=5)
        except Exception:
            pass

    def abort_all(self) -> None:
        """Query-level abort: DELETE /v1/query/{id} on every worker —
        the cancellation-propagation path (deadline, QUERY retry)."""
        for url in set(list(self.runner.worker_urls)
                       + [at.worker for at in self.tasks.values()]):
            try:
                self.runner._request(
                    f"{url}/v1/query/{self.exec_id}", method="DELETE",
                    retries=0, timeout=5)
            except Exception:
                continue

    def check_deadline(self) -> None:
        if self.deadline is not None \
                and time.monotonic() > self.deadline:
            self.abort_all()
            raise QueryFailedError(
                "query exceeded query_max_run_time "
                f"({self.session.properties.get('query_max_run_time')})"
            )

    def _spool_complete(self, at: _TaskAttempt) -> bool:
        """True when this attempt committed its full output to the
        durable spool (its ``.done`` marker exists): consumers replay
        its pages from storage, so losing the worker does NOT require
        re-running the task."""
        if not self.spool:
            return False
        from .spool import SPOOL
        return SPOOL.finished_tokens(self.exec_id,
                                     at.task_id) is not None

    def _probe(self):
        """One status sweep over current attempts. Returns
        ``(statuses, failed, spec_status)`` where ``failed`` maps key ->
        human reason for FAILED/ABORTED/lost primaries and
        ``spec_status`` maps key -> status doc or None (lost)."""
        statuses: List[dict] = []
        failed: Dict[Tuple[int, int], str] = {}
        spec_status: Dict[Tuple[int, int], Optional[dict]] = {}
        dead: Set[str] = set()

        def fetch(at: _TaskAttempt) -> Tuple[Optional[dict], str]:
            if at.worker in dead:
                return None, f"worker {at.worker} unreachable"
            try:
                return self.runner._request(at.url, retries=1,
                                            timeout=5), ""
            except urllib.error.HTTPError as e:
                # the worker ANSWERED: the task is unknown there
                # (tombstone evicted, worker restarted) — the TASK is
                # lost, the worker is not; don't poison bad_workers
                return None, (f"task {at.task_id} unknown to "
                              f"{at.worker} (HTTP {e.code})")
            except Exception as e:
                dead.add(at.worker)
                self.bad_workers.add(at.worker)
                return None, f"worker {at.worker} unreachable: {e}"

        for key, at in list(self.tasks.items()):
            if key in self.spool_preserved:
                # this attempt's worker is gone but its complete
                # output lives in the spool — report it FINISHED
                # without probing the dead host again
                statuses.append({"taskId": at.task_id,
                                 "state": "FINISHED", "elapsedMs": 0,
                                 "rowsOut": 0, "bytesOut": 0})
                continue
            st, why = fetch(at)
            if st is None:
                if self._spool_complete(at):
                    # the task finished and committed its spool before
                    # its worker vanished (drain exit, crash after
                    # FINISH): replay, don't re-run — the whole point
                    # of the spooled exchange
                    self.spool_preserved.add(key)
                    _SPOOL_REPLAYED.inc()
                    self.events.append(
                        {"kind": "spool_replay", "task": at.task_id,
                         "worker": at.worker})
                    LOG.log("spool_replayed", query_id=self.exec_id,
                            task_id=at.task_id, worker=at.worker)
                    statuses.append({"taskId": at.task_id,
                                     "state": "FINISHED",
                                     "elapsedMs": 0, "rowsOut": 0,
                                     "bytesOut": 0})
                    continue
                failed[key] = f"lost task {at.task_id} ({why})"
                continue
            statuses.append(st)
            if st.get("state") == "FAILED" and st.get("errorCode"):
                # a row error of the query itself: no retry repairs it
                self.user_error = int(st["errorCode"])
            if st.get("state") in ("FAILED", "ABORTED"):
                failed[key] = (f"task {at.task_id} "
                               f"{st.get('state', '').lower()}: "
                               f"{st.get('error')}")
        for key, at in list(self.spec.items()):
            spec_status[key] = fetch(at)[0]
        return statuses, failed, spec_status

    def _resolve_speculation(self, statuses: List[dict],
                             failed: Dict[Tuple[int, int], str],
                             spec_status) -> None:
        """First-finished-wins between a primary and its speculative
        duplicate; the loser is aborted. A winner's downstream
        consumers are re-created against its buffer."""
        by_id = {st.get("taskId"): st for st in statuses}
        for key, sst in list(spec_status.items()):
            spec = self.spec.get(key)
            if spec is None:
                continue
            primary = self.tasks[key]
            pst = by_id.get(primary.task_id)
            if sst is None or (sst.get("state")
                               in ("FAILED", "ABORTED")):
                # the duplicate died: drop it, the primary carries on
                del self.spec[key]
                self._delete(spec)
                continue
            if pst is not None and pst.get("state") == "FINISHED" \
                    and key not in failed:
                del self.spec[key]
                self._delete(spec)
                LOG.log("speculative_lost", query_id=self.exec_id,
                        task_id=spec.task_id)
                continue
            if sst.get("state") == "FINISHED":
                # speculative win: promote the duplicate, rewire every
                # downstream consumer to its buffer, abort the loser
                del self.spec[key]
                self.tasks[key] = spec
                failed.pop(key, None)
                self.spec_won += 1
                _SPEC_WON.inc()
                self.events.append(
                    {"kind": "speculative_won", "task": spec.task_id,
                     "worker": spec.worker})
                LOG.log("speculative_won", query_id=self.exec_id,
                        task_id=spec.task_id, loser=primary.task_id)
                self._recreate_downstream({key[0]})
                self._delete(primary)

    def _downstream_fids(self, fids: Set[int]) -> List[int]:
        out: Set[int] = set()
        frontier = set(fids)
        while frontier:
            nxt = {self.consumer_fid[f] for f in frontier
                   if f in self.consumer_fid}
            nxt -= out
            out |= nxt
            frontier = nxt
        return [f.id for f in self.fp.fragments if f.id in out]

    def _recreate_downstream(self, fids: Set[int]) -> None:
        """Re-create every task transitively downstream of ``fids`` (in
        dependency order) so their exchange clients re-read the current
        upstream attempts' retained buffers from token 0."""
        for fid in self._downstream_fids(fids):
            for key in self.parts[fid]:
                # the fresh attempt is live again: a stale spool
                # preservation would make _probe fabricate FINISHED
                # for it forever and blind lost-task detection
                self.spool_preserved.discard(key)
                old = self.tasks[key]
                sp = self.spec.pop(key, None)
                if sp is not None:
                    self._delete(sp)
                self._delete(old)
                self._launch(key, preferred=old.worker)

    def _recover(self, failed: Dict[Tuple[int, int], str]) -> None:
        """Apply the retry policy to this round's failures."""
        if not failed:
            return
        qid = self.exec_id.split("r")[0]
        mm = self.runner.memory_manager
        if mm is not None and (self.exec_id in mm.killed
                               or qid in mm.killed):
            # the cluster memory manager killed this query on purpose —
            # resurrecting it would fight the OOM killer
            raise QueryFailedError(
                "Query killed: exceeded cluster memory limit "
                f"({next(iter(failed.values()))})")
        reason = next(iter(failed.values()))
        if self.policy == "NONE":
            raise QueryFailedError(reason)
        if self.policy == "QUERY":
            raise _QueryRetry(reason)
        self.check_deadline()
        # an ExchangeFailedError names the upstream attempt that died:
        # the real fault is THERE; its consumer is collateral and is
        # re-created by the cascade without burning its own budget
        by_id = {at.task_id: key for key, at in self.tasks.items()}
        extra: Dict[Tuple[int, int], str] = {}
        for key, why in failed.items():
            m = _UPSTREAM_RE.search(why or "")
            if not m:
                continue
            tid = m.group(1)
            ukey = by_id.get(tid)
            if ukey is None:
                parts = tid.split(".")
                if len(parts) >= 3 and parts[1].isdigit() \
                        and parts[2].isdigit():
                    ukey = (int(parts[1]), int(parts[2]))
            if ukey is not None and ukey in self.tasks:
                extra[ukey] = why
        failed = dict(failed)
        failed.update(extra)
        collateral = set()
        failed_fids = {k[0] for k in failed}
        for fid in self._downstream_fids(failed_fids):
            for key in self.parts[fid]:
                collateral.add(key)
        billed = {k: v for k, v in failed.items()
                  if k not in collateral}
        if not billed:       # pure collateral (stale consumer errors)
            billed = dict(failed)
        max_used = 0
        for key, why in billed.items():
            used = self.retries_used.get(key, 0) + 1
            self.retries_used[key] = used
            max_used = max(max_used, used)
            if used > self.max_task_retries:
                raise QueryFailedError(
                    f"task {self.tasks[key].task_id} failed after "
                    f"{used} attempts: {why}")
        from .backoff import jittered
        time.sleep(jittered(min(self.backoff_s * (2 ** (max_used - 1)),
                                2.0)))
        # replace failed attempts upstream-first, then cascade to every
        # transitive consumer (they re-read spooled/retained output
        # from token 0)
        replace = {k for k in failed if k not in collateral} \
            or set(failed)
        for f in self.fp.fragments:
            for key in self.parts[f.id]:
                if key not in replace:
                    continue
                # an explicitly-billed upstream (e.g. its spool copy
                # came back corrupt) must actually re-run: drop the
                # preservation so _probe stops reporting the dead
                # attempt FINISHED
                self.spool_preserved.discard(key)
                old = self.tasks[key]
                sp = self.spec.pop(key, None)
                self._delete(old)
                self.retries += 1
                _TASK_RETRIES.inc()
                if sp is not None:
                    # the straggler hedge outlived its primary: promote
                    # the duplicate (probed healthy this round —
                    # _resolve_speculation already dropped dead ones)
                    # instead of restarting the work from zero
                    self.tasks[key] = at = sp
                else:
                    at = self._launch(key, exclude={old.worker})
                self.events.append(
                    {"kind": "task_retry", "task": at.task_id,
                     "from": old.worker, "to": at.worker,
                     "attempt": at.attempt,
                     "reason": failed.get(key, "")})
                LOG.log("task_retried", query_id=self.exec_id,
                        task_id=old.task_id, new_task_id=at.task_id,
                        from_worker=old.worker, to_worker=at.worker,
                        attempt=at.attempt,
                        reason=failed.get(key, ""))
        self._recreate_downstream({k[0] for k in replace})

    def _maybe_speculate(self, statuses: List[dict]) -> None:
        if not self.spec_enabled:
            return
        stragglers = self.monitor.stragglers
        if not stragglers:
            return
        by_id = {at.task_id: (key, at)
                 for key, at in self.tasks.items()}
        states = {st.get("taskId"): st.get("state") for st in statuses}
        for tid in stragglers:
            ent = by_id.get(tid)
            if ent is None:
                continue
            key, at = ent
            if key in self.spec or key in self.spec_done \
                    or states.get(tid) != "RUNNING":
                continue
            if not any(w != at.worker and w not in self.bad_workers
                       for w in self._schedulable()):
                # no second host right now: don't create a duplicate
                # that _launch would land on the straggler's own
                # already-slow worker; re-check next round (a node
                # may finish draining or rejoin)
                continue
            try:
                dup = self._launch(key, exclude={at.worker},
                                   speculative=True)
            except QueryFailedError:
                continue          # no second host available: skip
            if dup.worker == at.worker:
                # a one-node cluster cannot speculate usefully; mark
                # the key done so the next poll round doesn't land
                # another create/abort churn on the already-slow host
                self.spec.pop(key, None)
                self._delete(dup)
                self.spec_done.add(key)
                continue
            self.spec_done.add(key)
            self.spec_launched += 1
            _SPEC_LAUNCHED.inc()
            self.events.append(
                {"kind": "speculative_launched", "task": dup.task_id,
                 "straggler": tid, "worker": dup.worker})
            LOG.log("speculative_launched", query_id=self.exec_id,
                    straggler_task_id=tid, task_id=dup.task_id,
                    worker=dup.worker)

    def poll(self) -> int:
        """One recovery round: deadline, status sweep, speculation
        resolution/launch, failure recovery. Returns the number of
        recovery actions taken (retries + speculation changes)."""
        self.check_deadline()
        self._sched = None
        before = self.retries + self.spec_launched + self.spec_won
        statuses, failed, spec_status = self._probe()
        if self.user_error:
            raise QueryError(self.user_error)
        self.monitor.observe(statuses)
        self._resolve_speculation(statuses, failed, spec_status)
        self._recover(failed)
        self._maybe_speculate(statuses)
        return (self.retries + self.spec_launched + self.spec_won) \
            - before

    def cleanup(self) -> None:
        for at in list(self.tasks.values()) + list(self.spec.values()):
            self._delete(at)


class ClusterRunner:
    """Executes SELECT queries across worker servers; everything else
    (DDL, SET, EXPLAIN) falls through to the embedded LocalRunner on
    ``device`` (the GPU when none is named; raises without one)."""

    def __init__(self, worker_urls: Optional[List[str]] = None,
                 catalogs=None,
                 catalog: str = "tpch", schema: str = "default",
                 tpch_sf: float = 0.01, rows_per_batch: int = 1 << 17,
                 heartbeat: bool = True, discovery=None, device=None):
        # static URL list OR discovery-fed dynamic membership (reference
        # DiscoveryNodeManager: workers join by announcing, any time)
        self.discovery = discovery
        self._static_urls = list(worker_urls or ())
        self.local = LocalRunner(catalogs=catalogs, catalog=catalog,
                                 schema=schema, tpch_sf=tpch_sf,
                                 device=device,
                                 rows_per_batch=rows_per_batch)
        self.device = self.local.device
        self.session = self.local.session
        self.rows_per_batch = rows_per_batch
        #: worker url -> node id learned from /v1/info (node federator)
        self._node_ids: Dict[str, str] = {}
        #: worker url -> last seen /v1/info state — the drain-aware
        #: scheduling feed (SHUTTING_DOWN nodes finish their running
        #: tasks but are never assigned new ones)
        self._node_states: Dict[str, str] = {}
        #: monitor/recovery info of the last _run_fragments call (the
        #: cluster EXPLAIN ANALYZE feed)
        self._last_run_info: Dict[str, object] = {}
        NODES.update("coordinator", state="ACTIVE", coordinator=True,
                     uri="", active_tasks=0, mem_pool_peak_bytes=0)
        self.detector = HeartbeatFailureDetector(
            self._current_urls, on_info=self._note_node_info)
        self._heartbeat_on = bool(heartbeat)
        if heartbeat:
            self.detector.start()
        self.memory_manager: Optional[ClusterMemoryManager] = None
        limit = self.session.properties.get("cluster_memory_limit")
        if limit:
            self.enable_memory_manager(int(limit))

    def enable_memory_manager(self, limit_bytes: int,
                              interval_s: float = 0.5) -> None:
        self.memory_manager = ClusterMemoryManager(self, limit_bytes,
                                                   interval_s)
        self.memory_manager.start()

    def _current_urls(self) -> List[str]:
        if self.discovery is not None:
            return self.discovery.active_urls()
        return list(self._static_urls)

    @property
    def worker_urls(self) -> List[str]:
        return self._current_urls()

    # -- node-state federation (system.runtime.nodes) ------------------------
    def _note_node_info(self, url: str, info: dict) -> None:
        """Fold one worker's ``/v1/info`` doc into the process-wide
        node registry — the feed of ``system.runtime.nodes`` and of the
        node-labeled series on the coordinator's ``/v1/metrics``."""
        nid = str(info.get("nodeId") or url)
        if url not in self._node_ids:
            # first contact with this worker — covers boot-time
            # membership AND mid-query elastic joins (a worker that
            # announced while queries were running)
            _NODES_JOINED.inc()
            LOG.log("node_joined", node_id=nid, uri=url)
        self._node_ids[url] = nid
        state = str(info.get("state", "ACTIVE"))
        if state == "SHUTTING_DOWN" \
                and self._node_states.get(url) != "SHUTTING_DOWN":
            # ACTIVE -> SHUTTING_DOWN transition: the node entered its
            # drain window; the scheduler stops assigning to it
            _NODES_DRAINED.inc()
            LOG.log("node_draining", node_id=nid, uri=url)
        self._node_states[url] = state
        tasks = info.get("tasks") or {}
        fields = dict(
            state=state, coordinator=False, uri=url,
            active_tasks=int(tasks.get("RUNNING", 0) or 0),
            mem_pool_peak_bytes=int(
                info.get("memPoolPeakBytes", 0) or 0))
        # worker-sampled device.memory_stats() riding the heartbeat —
        # the feed of system.runtime.nodes' HBM columns and the
        # node_hbm_* series on the coordinator /v1/metrics scrape.
        # Only nodes whose backend actually reported stats get the
        # fields: a stats-less (CPU) node must stay absent from the
        # node_hbm_* series, not publish zeros
        hbm = info.get("hbm") or {}
        drop = ()
        if int(hbm.get("devices", 0) or 0) > 0:
            fields["hbm_in_use_bytes"] = int(hbm.get("bytesInUse", 0)
                                             or 0)
            fields["hbm_peak_bytes"] = int(hbm.get("peakBytes", 0) or 0)
        else:
            # a node that stops reporting device stats (restarted under
            # the same id on a stats-less backend) must not keep serving
            # its previous incarnation's sample
            drop = ("hbm_in_use_bytes", "hbm_peak_bytes")
        NODES.update(nid, drop=drop, **fields)
        # federate the heartbeat sample into the coordinator's
        # time-series store: per-node history becomes range-readable on
        # the coordinator's /v1/metrics/history and
        # system.runtime.timeseries without re-polling the worker
        from ..obs.timeseries import TIMESERIES
        TIMESERIES.record(f"node_active_tasks.{nid}",
                          fields["active_tasks"])
        TIMESERIES.record(f"node_mem_pool_peak_bytes.{nid}",
                          fields["mem_pool_peak_bytes"])
        if "hbm_in_use_bytes" in fields:
            TIMESERIES.record(f"node_hbm_in_use_bytes.{nid}",
                              fields["hbm_in_use_bytes"])
            TIMESERIES.record(f"node_hbm_peak_bytes.{nid}",
                              fields["hbm_peak_bytes"])

    def poll_nodes(self, urls: Optional[List[str]] = None) -> None:
        """One synchronous federation sweep (the background heartbeat
        does the same continuously when enabled); unreachable workers
        keep their last heartbeat timestamp so their age grows."""
        for url in (urls if urls is not None else self.worker_urls):
            try:
                info = self._request(f"{url}/v1/info", retries=0,
                                     timeout=5)
            except Exception:
                self._node_states[url] = "UNREACHABLE"
                nid = self._node_ids.get(url)
                if nid:
                    NODES.update(nid, seen=False, state="UNREACHABLE")
                continue
            self._note_node_info(url, info)
        # coordinator-role discovery entries (the serving fleet's
        # peers) surface in system.runtime.nodes too, flagged
        # coordinator=True — they are membership, never task targets
        # (active_urls() filters them out of scheduling)
        if self.discovery is not None:
            for n in self.discovery.nodes():
                if n.get("role") == "coordinator" and n.get("active"):
                    NODES.update(n["nodeId"], state=n.get(
                        "state", "ACTIVE"), coordinator=True,
                        uri=n.get("uri", ""))

    def _mesh_route(self, properties: Optional[Dict[str, object]] = None
                    ) -> bool:
        """Should this query run on the local device mesh instead of
        remote worker tasks? ``mesh_execution=on`` always; ``auto``
        (the default) only when >1 device is effective AND no remote
        worker is schedulable — a cluster that HAS healthy workers
        keeps the task/exchange path (spool, retries, speculation),
        while a worker-less multi-chip coordinator gets the SPMD
        substrate instead of failing with no nodes."""
        import dataclasses as _dc

        from ..config import validate_session_property
        from .distributed import mesh_device_count, mesh_mode
        session = self.session
        if properties:
            # only the two routing props matter here, and they must go
            # through the registry gate NOW: a malformed mesh_devices
            # raises the declared SessionPropertyError instead of a
            # bare int() crash before the overlay's own validation
            overlay = {k: validate_session_property(k, properties[k])
                       for k in ("mesh_execution", "mesh_devices")
                       if k in properties}
            if overlay:
                session = _dc.replace(
                    session,
                    properties={**session.properties, **overlay})
        mode = mesh_mode(session)
        if mode == "off":
            return False
        if mode == "on":
            return True
        if mesh_device_count(session, self.device) < 2:
            return False
        return not self._schedulable_workers()

    def _schedulable_workers(self) -> List[str]:
        """Workers eligible for NEW task assignment: heartbeat-alive and
        not draining (reference NodeScheduler skips nodes the
        GracefulShutdownHandler flagged SHUTTING_DOWN). Drain state
        merges two feeds: the ``/v1/info`` heartbeat sweep and the
        discovery announcements (a draining worker pushes
        SHUTTING_DOWN immediately, ahead of the next sweep)."""
        urls = self.detector.active()
        if not self._heartbeat_on:
            # no background federator: one synchronous sweep so drain
            # state and system.runtime.nodes are fresh for this query
            self.poll_nodes(urls)
        draining = {u for u, s in
                    (self.discovery.states() if self.discovery
                     is not None else {}).items()
                    if s == "SHUTTING_DOWN"}
        return [u for u in urls
                if u not in draining
                and self._node_states.get(u)
                not in ("SHUTTING_DOWN", "UNREACHABLE")]

    # -- HTTP helpers --------------------------------------------------------
    #: transient-failure budget for one remote-task call (reference
    #: server/remotetask/RequestErrorTracker.java wraps every remote-task
    #: request in retry-with-backoff; one socket blip must not fail a
    #: query with healthy workers)
    REQUEST_RETRIES = 4
    REQUEST_BACKOFF_S = 0.1

    def _request(self, url: str, method: str = "GET",
                 body: Optional[dict] = None,
                 retries: Optional[int] = None,
                 timeout: float = 10) -> dict:
        """Remote-task HTTP with retry/backoff. Retrying is safe because
        every mutating endpoint is idempotent (task PUT is an upsert on
        the worker, DELETE/abort tolerate repeats). Latency-sensitive
        callers (the memory manager's poll/kill loop) pass retries=0 —
        their next poll IS the retry. These are small-JSON control-plane
        calls (create/status/delete): the 10s timeout bounds a
        black-holed worker at ~a minute across the whole retry budget,
        not 5 minutes (result pages stream through a separate client)."""
        data = json.dumps(body).encode() if body is not None else None
        budget = self.REQUEST_RETRIES if retries is None else retries
        last: Optional[Exception] = None
        for attempt in range(budget + 1):
            if attempt:
                # jittered exponential backoff: N clients retrying a
                # recovering worker must not synchronize into bursts
                from .backoff import jittered
                time.sleep(jittered(
                    self.REQUEST_BACKOFF_S * (2 ** (attempt - 1))))
            req = urllib.request.Request(url, data=data, method=method)
            if data is not None:
                req.add_header("Content-Type", "application/json")
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                if e.code >= 500 and attempt < budget:
                    last = e
                    continue
                raise
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError) as e:
                # transport-level failure: retry with backoff; the
                # heartbeat failure detector owns the
                # permanently-dead-worker verdict
                last = e
                if attempt >= budget:
                    break
                continue
        raise QueryFailedError(
            f"remote task request failed after "
            f"{budget + 1} attempts: {url}: {last}")

    # -- public API ----------------------------------------------------------
    def execute(self, sql: str,
                properties: Optional[Dict[str, object]] = None,
                user: str = "", cancel_event=None,
                serving=None) -> QueryResult:
        """Run one statement across the cluster. The keyword surface
        matches LocalRunner.execute, so the statement protocol serves
        a ClusterRunner through the SAME resource-group admission,
        per-query session overlay, cancellation, and serving handoff —
        multi-worker deployments get the same limits. SELECTs ride
        the compiled-plan cache (serving/plancache.py): a repeated
        statement skips parse/plan/optimize straight to fragmenting."""
        import dataclasses as _dc
        from ..serving.plancache import cached_plan, parse_cached
        from ..sql import ast as A
        stmt = parse_cached(sql)
        analyze = isinstance(stmt, A.Explain) and stmt.analyze \
            and isinstance(stmt.statement, A.Query) \
            and stmt.type == "logical" and stmt.format == "text"
        if not isinstance(stmt, A.Query) and not analyze:
            return self.local.execute(sql, properties=properties,
                                      user=user,
                                      cancel_event=cancel_event,
                                      serving=serving)
        if self._mesh_route(properties):
            # mesh-native execution: with multiple chips on this host
            # the device mesh IS the cluster substrate — shards of one
            # SPMD program replace worker tasks. Route through the
            # embedded LocalRunner (same admission/serving/security
            # surface), whose execute_plan picks the SPMD executor.
            # Under ``auto`` remote workers still win when any are
            # schedulable; ``on`` forces the mesh.
            return self.local.execute(sql, properties=properties,
                                      user=user,
                                      cancel_event=cancel_event,
                                      serving=serving)
        session = self.session
        secured = bool(self.local.access_control.catalog_rules)
        if properties or secured or serving is not None:
            catalogs = session.catalogs
            if secured:
                from ..server.security import SecuredCatalogs
                catalogs = SecuredCatalogs(catalogs, user,
                                           self.local.access_control)
            session = _dc.replace(
                session, catalogs=catalogs, serving=serving,
                properties={**session.properties, **(properties or {})})
        if analyze:
            # EXPLAIN ANALYZE runs the inner query: it goes through
            # the SAME secured session overlay, privilege checks, and
            # cancellation as a plain SELECT — analyzing a statement
            # must never be a way around running it
            return self._explain_analyze(stmt.statement, sql,
                                         session=session, user=user,
                                         cancel_event=cancel_event)
        from ..planner.planner import bool_property
        sec = secured or self.local.roles.enforce
        use_template = bool_property(session, "plan_template_cache",
                                     False)
        use_results = bool_property(session, "result_cache", False)
        bindings = bound_key = None
        if use_template:
            from ..serving.template import template_plan
            plan, bindings, bound_key = template_plan(
                stmt, session, user=user, secured=sec)
        else:
            plan = cached_plan(stmt, session, user=user, secured=sec)
        if secured:
            self.local._check_catalog_access(plan, user)
        if self.local.roles.enforce:
            self.local._check_select_privileges(plan, user)
        if bindings:
            # remote fragments ship over the codec and trace literals
            # as constants — materialize this query's bindings (the
            # coordinator still skipped parse/plan/optimize on the hit)
            from ..expr.params import bind_plan
            plan = bind_plan(plan, bindings)
        rc_token = None
        if use_results:
            # the SAME begin/commit contract as LocalRunner: keying,
            # pre-execution dep/epoch stamps, and the mid-run write
            # veto must agree across execution modes
            from ..serving import resultcache as RC
            from ..serving.plancache import bound_fingerprint
            if bound_key is None:
                bound_key = bound_fingerprint(stmt, session, user=user,
                                              secured=sec)
            served, rc_token = RC.begin(
                bound_key, plan, session, self.device,
                self.rows_per_batch, cancel_event=cancel_event)
            if served is not None:
                return served
        # init plans (uncorrelated scalar subqueries) run on the
        # coordinator; their values ship inside every task update
        from .local import run_init_plans, _Executor
        plan = self._share_subplans(plan, sql, session, cancel_event, user)
        ex = _Executor(session, self.rows_per_batch, self.device)
        run_init_plans(ex, plan)
        init_values = ex.init_values
        fragmented = fragment_plan(plan.root)
        out = self._run_fragments(fragmented, init_values, sql,
                                  session=session,
                                  cancel_event=cancel_event,
                                  user=user)
        if rc_token is not None:
            from ..serving import resultcache as RC
            RC.commit(rc_token, session, out)
        return out

    def _explain_analyze(self, query_stmt, sql: str, session=None,
                         user: str = "",
                         cancel_event=None) -> QueryResult:
        """Cluster EXPLAIN ANALYZE: run the inner query on the cluster,
        then render the plan plus the stage summary and the
        fault-tolerance section (retries/speculation/spool replays) —
        the cluster analogue of the local runner's trace/skew/scan-cache
        sections. ``session`` is the caller's (possibly secured)
        per-query overlay; planning against its catalogs enforces the
        same access control as a plain SELECT."""
        from .. import types as T
        from ..planner.planner import plan_query
        from ..planner.optimizer import optimize
        from ..planner.printer import format_retry_summary, print_plan
        from .local import run_init_plans, _Executor
        session = session if session is not None else self.session
        t0 = time.perf_counter()
        plan = optimize(plan_query(query_stmt, session), session)
        if self.local.roles.enforce:
            self.local._check_select_privileges(plan, user)
        plan = self._share_subplans(plan, sql, session, cancel_event, user)
        ex = _Executor(session, self.rows_per_batch, self.device)
        run_init_plans(ex, plan)
        fragmented = fragment_plan(plan.root)
        out = self._run_fragments(fragmented, ex.init_values, sql,
                                  session=session,
                                  cancel_event=cancel_event,
                                  user=user)
        wall_ms = (time.perf_counter() - t0) * 1e3
        text = print_plan(plan)
        info = dict(self._last_run_info)
        text += (f"\nCluster: {len(fragmented.fragments)} stages, "
                 f"{len(out.rows):,} rows, total {wall_ms:,.0f}ms")
        retry = format_retry_summary(info)
        if retry:
            text += "\n" + retry
        from ..planner.planner import bool_property
        if bool_property(session, "profile", False):
            # in-process workers share this process's KERNELS registry,
            # so the section shows the run's kernel launches; remote
            # workers keep theirs on their own /v1/metrics
            from ..planner.printer import format_kernels_registry
            kernels = format_kernels_registry()
            if kernels:
                text += "\n" + kernels
        return QueryResult(["Query Plan"], [T.VARCHAR],
                           [(line,) for line in text.split("\n")])

    def _share_subplans(self, plan, sql: str, session, cancel_event,
                        user: str):
        """``plan`` with each subplan that an init plan shares with
        another consumer (``_init_shared``) run once on the workers and
        replaced everywhere by a ``ValuesNode`` of its rows."""
        subs = {}
        for sub in _init_shared(plan):
            res = self._run_fragments(fragment_plan(sub), [], sql,
                                      session=session,
                                      cancel_event=cancel_event, user=user)
            subs[sub] = ValuesNode(fields=sub.fields, rows=tuple(
                tuple(v.item() if isinstance(v, np.generic) else v
                      for v in r) for r in res.rows))
        if not subs:
            return plan
        return dataclasses.replace(
            plan, root=_substitute(plan.root, subs),
            init_plans=[_substitute(p, subs) for p in plan.init_plans])

    # -- scheduling ----------------------------------------------------------
    def _schedulable_or_raise(self) -> List[str]:
        if not self.detector.active():
            raise QueryFailedError("no active workers")
        workers = self._schedulable_workers()
        if not workers:
            raise QueryFailedError(
                "no schedulable workers (all draining)")
        return workers

    def _run_fragments(self, fp: FragmentedPlan,
                       init_values: List[object],
                       sql: str = "", session=None,
                       cancel_event=None, user: str = "") -> QueryResult:
        session = session if session is not None else self.session
        workers = self._schedulable_or_raise()
        qid = f"cq_{_QUERY_TAG}_{next(_QUERY_SEQ):06d}"
        REGISTRY.counter("cluster_queries_total").inc()
        from ..connectors.system import QueryLogEntry
        from ..events import QueryCompletedEvent
        # validate session properties BEFORE the RUNNING log entry is
        # appended: a bad value must raise without leaving a phantom
        # forever-RUNNING row in system.runtime.queries
        policy = _retry_policy(session)
        q_budget = int(session.properties.get(
            "query_retry_attempts", 1)) if policy == "QUERY" else 0
        max_run = parse_duration_s(
            session.properties.get("query_max_run_time"))
        deadline = (time.monotonic() + max_run) if max_run else None
        entry = QueryLogEntry(qid, "RUNNING", sql.strip(), 0.0,
                              user=user, create_time=time.time())
        with self.local._state_lock:
            self.local.query_log.append(entry)
            # same bound LocalRunner.execute applies: a cluster-only
            # coordinator must not grow the log without limit
            if len(self.local.query_log) > 1000:
                del self.local.query_log[:-500]
        monitor = StageMonitor(qid)
        total_retries = 0
        t0 = time.perf_counter()
        error: Optional[str] = None
        try:
            with TRACER.span("query", query_id=qid, mode="cluster",
                             workers=len(workers)):
                for qtry in range(q_budget + 1):
                    # QUERY-policy reruns use a distinct exec id so the
                    # rerun's tasks never share worker-side query state
                    # (device-scheduler handles, query-level aborts)
                    # with still-draining tasks of the aborted attempt
                    exec_id = qid if qtry == 0 else f"{qid}r{qtry}"
                    monitor = StageMonitor(qid)
                    run = _QueryExecution(self, fp, init_values,
                                          workers, exec_id, monitor,
                                          deadline=deadline,
                                          session=session)
                    try:
                        run.schedule_all()
                        out = self._collect(fp, run,
                                            cancel_event=cancel_event)
                        break
                    except _QueryRetry as e:
                        run.abort_all()
                        if qtry >= q_budget:
                            raise QueryFailedError(
                                f"query failed after {qtry + 1} "
                                f"attempts: {e}") from None
                        _QUERY_RETRIES.inc()
                        LOG.log("query_retried", query_id=qid,
                                attempt=qtry + 1, reason=str(e))
                        time.sleep(min(
                            float(session.properties.get(
                                "task_retry_backoff_s", 0.05))
                            * (2 ** qtry), 2.0))
                        workers = self._schedulable_or_raise()
                    finally:
                        # final status sweep BEFORE the task DELETEs:
                        # frozen elapsed/rows feed the last straggler
                        # pass, the skew pass, and the query-history
                        # operator records
                        monitor.finalize(
                            self._task_statuses(run.all_urls()))
                        self._harvest_spans(run.all_urls())
                        run.cleanup()
                        # spool GC: this exec attempt's pages can
                        # never be read again once its tasks are gone
                        # (success, failure and abort all pass here) —
                        # no orphaned per-query spool directories.
                        # Spool-less runs (NONE policy,
                        # spool_exchange=false) skip the per-worker
                        # DELETE round trips entirely.
                        if run.spool:
                            self._release_spool(exec_id)
                        total_retries += run.retries
                        self._last_run_info = {
                            **run.summary(), "retries": total_retries,
                            "query_retries": qtry}
            entry.state = "FINISHED"
            return out
        except Exception as e:
            entry.state = "FAILED"
            error = str(e)
            raise
        finally:
            entry.elapsed_ms = (time.perf_counter() - t0) * 1e3
            entry.error = error
            summary = monitor.summary()
            history = {
                "query_id": qid, "query": entry.query, "user": user,
                "state": entry.state, "error": error,
                "error_code": None, "create_time": entry.create_time,
                "elapsed_ms": round(entry.elapsed_ms, 3),
                "mode": "cluster", "plan_summary": " | ".join(
                    f"stage{f.id}[{f.partitioning}]"
                    for f in fp.fragments),
                "stages": summary,
                "retries": total_retries,
                "operators": [
                    {"operator": "task " + str(st.get("taskId", "")),
                     "rows": int(st.get("rowsOut") or 0),
                     "bytes": int(st.get("bytesOut") or 0),
                     "batches": 0,
                     "wall_ms": float(st.get("elapsedMs") or 0.0)}
                    for st in monitor.last_statuses],
            }
            self.local.events.query_completed(QueryCompletedEvent(
                query_id=qid, query=entry.query, user=user,
                state=entry.state, elapsed_ms=entry.elapsed_ms,
                error=error, create_time=entry.create_time,
                history=history))
            if LOG.enabled:
                LOG.log("query_completed", query_id=qid, mode="cluster",
                        state=entry.state,
                        elapsed_ms=round(entry.elapsed_ms, 3),
                        error=error, retries=total_retries, **summary)

    def _task_statuses(self, all_tasks: List[str]) -> List[dict]:
        """Best-effort status fetch for every task (single attempt —
        this runs on the completion path, including after a failure, so
        a dead worker must cost ONE timeout, not one per task: the
        first unreachable task skips the rest of that worker)."""
        out: List[dict] = []
        dead: set = set()
        for u in all_tasks:
            base = u.split("/v1/task/")[0]
            if base in dead:
                continue
            try:
                out.append(self._request(u, retries=0, timeout=2))
            except Exception:
                dead.add(base)
        return out

    def _harvest_spans(self, all_tasks: List[str]) -> None:
        """Pull each task's spans (its share of this query's trace) back
        to the coordinator so distributed traces stitch; the tracer
        dedupes by span id, so in-process workers sharing the ring are
        harmless."""
        if not TRACER.enabled:
            return
        # one fetch per distinct WORKER: a task's span export is the
        # worker's whole share of the trace, so per-task fetches would
        # download K duplicate copies for import_spans to throw away
        by_worker: Dict[str, str] = {}
        for u in all_tasks:
            by_worker.setdefault(u.split("/v1/task/")[0], u)
        for u in by_worker.values():
            try:
                st = self._request(f"{u}?spans=1", retries=0, timeout=5)
            except Exception:
                continue
            TRACER.import_spans(st.get("spans") or [])

    def _assign_splits(self, f: PlanFragment,
                       workers: List[str]) -> List[List[Split]]:
        scan = next(n for n in _walk(f.root)
                    if isinstance(n, TableScanNode))
        conn = self.session.catalogs.get(scan.catalog)
        splits = conn.split_manager.splits(scan.table, len(workers))
        out: List[List[Split]] = [[] for _ in workers]
        for i, s in enumerate(splits):
            out[i % len(workers)].append(s)
        return out

    def _create_task(self, worker: str, qid: str, f: PlanFragment,
                     partition: int, n_buffers: int,
                     splits: List[Split], sources: Dict[int, List[str]],
                     init_values: List[object],
                     task_id: Optional[str] = None,
                     retain: bool = False, spool: bool = False,
                     session=None) -> str:
        if task_id is None:
            task_id = f"{qid}.{f.id}.{partition}"
        session = session if session is not None else self.session
        doc = {
            "fragment": codec.encode(f.root),
            "output": {
                "kind": f.output.kind if f.output else "single",
                "keys": list(f.output.keys) if f.output else [],
                "n_buffers": n_buffers,
                # retain=True: acked pages survive in memory so a
                # re-created consumer attempt can re-read from token 0
                # (the spool_exchange=false fallback)
                "retain": bool(retain),
                # spool=True: every page writes through to the durable
                # page-addressed spool (exec/spool.py) — replay
                # storage that outlives this worker process
                "spool": bool(spool),
            },
            "splits": [codec.encode(s) for s in splits],
            "sources": {str(k): v for k, v in sources.items()},
            "partition": partition,
            "session": {
                "catalog": session.catalog,
                "schema": session.schema,
                "properties": {
                    k: v for k, v in session.properties.items()
                    if isinstance(v, (str, int, float, bool))
                },
            },
            "init_values": codec.encode_values(init_values),
            "rows_per_batch": self.rows_per_batch,
        }
        serving = getattr(session, "serving", None)
        if serving is not None:
            # admitted-query handoff: the worker registers the query's
            # device-scheduler handle under the admitting group's
            # stride share, so cluster queries obey the same group
            # weights as LocalRunner queries (serving/groups.py)
            doc["serving"] = {"group": serving.scheduler_group,
                              "weight": serving.weight,
                              "label": serving.group_path}
        ctx = TRACER.context()
        if ctx is not None:
            # span context over the wire (the stage span is current):
            # the worker's task span joins this trace
            doc["trace"] = ctx
        self._request(f"{worker}/v1/task/{task_id}", method="PUT",
                      body=doc)
        return f"{worker}/v1/task/{task_id}"

    def _release_spool(self, exec_id: str) -> None:
        """Per-query spool GC, everywhere: the coordinator's local
        store (shared with in-process workers) plus a DELETE to every
        worker for node-local spool directories."""
        from .spool import SPOOL
        SPOOL.release_query(exec_id)
        for url in list(self.worker_urls):
            try:
                self._request(f"{url}/v1/spool/{exec_id}",
                              method="DELETE", retries=0, timeout=5)
            except Exception:
                continue

    # -- result collection ---------------------------------------------------
    def _collect(self, fp: FragmentedPlan, run: _QueryExecution,
                 cancel_event=None) -> QueryResult:
        from .pages import deserialize_page
        from ..server.worker import unframe_pages
        out_node = fp.root.root
        names = [f.name for f in out_node.fields]
        types = [f.type for f in out_node.fields]
        rows: List[tuple] = []
        token = 0
        cur = run.root_url()
        while True:
            if cancel_event is not None and cancel_event.is_set():
                # client-side cancel (protocol DELETE): abort every
                # task everywhere and surface the cancellation
                run.abort_all()
                from ..errors import QueryCancelledError
                raise QueryCancelledError("query cancelled")
            run.check_deadline()
            if run.root_url() != cur:
                # the root task was re-created (retry cascade or a
                # speculative win): restart collection from token 0 —
                # every attempt owns its own buffer, so discarding the
                # old attempt's rows makes duplicates impossible
                cur = run.root_url()
                token = 0
                rows = []
            req = urllib.request.Request(
                f"{cur}/results/0/{token}?max_wait=2")
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    body = resp.read()
                    complete = resp.headers.get(
                        "X-Buffer-Complete") == "true"
                    token = int(resp.headers.get("X-Next-Token", token))
            except urllib.error.HTTPError as e:
                # the root answered with a failure (its buffer failed or
                # the task is gone): one recovery round decides between
                # retry and propagating the real error
                detail = e.read().decode(errors="replace")
                if not run.poll() and run.root_url() == cur:
                    raise QueryFailedError(detail) from None
                continue
            except Exception as e:
                # transport error: the root's worker may be gone; the
                # recovery round reschedules its tasks elsewhere
                if not run.poll() and run.root_url() == cur:
                    raise QueryFailedError(str(e)) from None
                continue
            for page in unframe_pages(body):
                # result pages decode on the host: rows are host values
                rows.extend(deserialize_page(page, "cpu").to_pylist())
            if complete:
                break
            run.poll()
        return QueryResult(names=names, types=types, rows=rows)


def _walk(node: PlanNode):
    yield node
    for c in node.children:
        yield from _walk(c)


def _init_shared(plan) -> List[PlanNode]:
    """The outermost subplans that aggregate a table's rows, occur in
    an init plan and occur more than once among the init plans and the
    main plan, outermost first; each once. Left out: a subplan without
    an aggregation or a window (its rows do not depend on the order of
    its inputs), one that reads an init plan's value (it could not run
    before the init plans) and one with a column that a ``ValuesNode``
    cannot carry (ARRAY, MAP, ROW)."""
    from .. import types as T
    from ..planner.planner import InitPlanRef
    counts: Dict[PlanNode, int] = {}

    def count(n: PlanNode) -> None:
        counts[n] = counts.get(n, 0) + 1
        if counts[n] == 1:
            for c in n.children:
                count(c)

    for r in [*plan.init_plans, plan.root]:
        count(r)

    def reads_init(obj) -> bool:
        if isinstance(obj, InitPlanRef):
            return True
        if isinstance(obj, (tuple, list)):
            return any(reads_init(v) for v in obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return any(reads_init(getattr(obj, f.name))
                       for f in dataclasses.fields(obj))
        return False

    out: List[PlanNode] = []

    def pick(n: PlanNode) -> None:
        if n in out:
            return
        below = [type(m) for m in _walk(n)]
        if counts[n] > 1 and n.fields and TableScanNode in below \
                and (AggregationNode in below or WindowNode in below) \
                and not any(isinstance(t, (T.ArrayType, T.MapType,
                                           T.RowType)) for t in n.types) \
                and not reads_init(n):
            out.append(n)
            return
        for c in n.children:
            pick(c)

    for p in plan.init_plans:
        pick(p)
    return out


def _substitute(node: PlanNode, subs: Dict[PlanNode, PlanNode]) -> PlanNode:
    """``node`` with every subtree equal to a key of ``subs`` replaced
    by its value."""
    if node in subs:
        return subs[node]
    kids = node.children
    new = tuple(_substitute(c, subs) for c in kids)
    if all(a is b for a, b in zip(new, kids)):
        return node
    return node.with_children(new)
