"""The elasticity control loop: ClusterSignals in, scale actions out.

The counterpart of ``presto_tpu/exec/autoscale.py``. The mechanisms it
drives are the cluster's (``exec/cluster.py``, ``server/worker.py``:
join by announcement, drain and exit, spool replay) and its sensor is
``obs/signals.py``; this module closes the loop. Three layers:

- **Rules** (:data:`RULES` / :func:`decide`): the one rule registry, a
  pure function from a frozen snapshot to recommendations
  (``scale_up`` / ``scale_down`` / ``replace_node`` / ``grow_cache`` /
  ``scale_coordinator``). ``_devtools/autoscale_watch.py`` is a shim
  over exactly this registry, so the watcher and the controller cannot
  drift.

- **Providers** (:class:`NodeProvider`): the boundary to whatever owns
  worker capacity. :class:`LocalProcessProvider` spawns real ``python
  -m presto_tpu_torch.server.worker --device <device>`` subprocesses (a
  cloud provider slots in behind the same four methods);
  :class:`InProcessProvider` runs ``WorkerServer`` objects in this
  process (the chaos and test substrate). Both run their workers on
  ``device``: the GPU when none is named, and they raise without one.

- **Controller** (:class:`AutoscaleController`): the coordinator-side
  loop. It reads the signals feed on a cadence and applies confirmed
  decisions with *hysteresis* (a decision must repeat for
  ``confirm_evals`` consecutive evaluations before it acts),
  *cooldowns* (``cooldown_s`` between applied scale actions), *bounded
  steps* (``scale_step`` workers per action, clamped to ``[min_workers,
  max_workers]``), and the SLO invariant re-checked at apply time:
  while any group's alert is PAGE, the cluster never scales down.
  Scale-down always takes the drain path (``PUT /v1/info/state
  SHUTTING_DOWN``: active tasks finish and commit their spool, the
  worker's final GONE announcement deregisters it), never a kill. When
  a group is admission-bound (queue deep while every device sits idle,
  so more workers cannot help) the controller scales the *coordinator*
  tier instead, through an injected scaler (``_devtools/fleet.py``'s
  ``FleetHandle``).

Everything is counted: ``autoscale_evaluations_total``,
``autoscale_decision_total.<action>``, ``autoscale_actions_total.
<action>``, ``autoscale_blocked_total.<reason>`` (hysteresis /
cooldown / page-held / bounds / no-scaler / drain-failed / unknown-node
/ scaler-refused).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device
from ..obs.metrics import REGISTRY
from ..obs.signals import (CacheSignals, ClusterSignals, GroupSignals,
                           NodeSignals, cluster_signals)

_EVALS = REGISTRY.counter("autoscale_evaluations_total")

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# -- the rule registry --------------------------------------------------------
# One registry for the watcher and the controller. Every rule is a pure
# function (signals, cfg) -> [decision], each decision ``{"action",
# "target", "reason", "signals": {...}}`` carrying the raw values it
# fired on, so an operator (or a test) can audit it against the feed.

DEFAULT_RULE_CONFIG: Dict[str, float] = {
    "queue_ratio": 2.0,
    "idle_ratio": 0.25,
    "stale_heartbeat_s": 30.0,
    "cache_pressure": 0.9,
    "min_budget": 0.5,
    "coordinator_queue_ratio": 4.0,
}


def _wants_scale_up(g: GroupSignals, cfg: Dict[str, float]) -> bool:
    limit = max(1, g.hard_concurrency_limit)
    return g.queued >= cfg["queue_ratio"] * limit \
        or g.alert_state == "PAGE"


def _rule_scale_up(signals: ClusterSignals,
                   cfg: Dict[str, float]) -> List[Dict]:
    out: List[Dict] = []
    for g in signals.groups:
        limit = max(1, g.hard_concurrency_limit)
        if _wants_scale_up(g, cfg):
            why = (f"alert {g.alert_state}" if g.alert_state == "PAGE"
                   else f"queue {g.queued} >= {cfg['queue_ratio']:g}x "
                        f"limit {limit}")
            out.append({"action": "scale_up", "target": g.group,
                        "reason": why,
                        "signals": {"queued": g.queued,
                                    "running": g.running,
                                    "limit": limit,
                                    "alert_state": g.alert_state,
                                    "burn_short": g.burn_short,
                                    "p95_s": g.p95_s}})
    return out


def _rule_scale_down(signals: ClusterSignals,
                     cfg: Dict[str, float]) -> List[Dict]:
    out: List[Dict] = []
    for g in signals.groups:
        limit = max(1, g.hard_concurrency_limit)
        if (not _wants_scale_up(g, cfg)
                and g.queued == 0
                and g.running < cfg["idle_ratio"] * limit
                and g.alert_state == "OK"
                and (g.error_budget_remaining is None
                     or g.error_budget_remaining >= cfg["min_budget"])):
            out.append({"action": "scale_down", "target": g.group,
                        "reason": f"idle: running {g.running} < "
                                  f"{cfg['idle_ratio']:g}x limit "
                                  f"{limit}, no queue, alert OK",
                        "signals": {"running": g.running,
                                    "limit": limit,
                                    "budget":
                                        g.error_budget_remaining}})
    return out


def _rule_replace_node(signals: ClusterSignals,
                       cfg: Dict[str, float]) -> List[Dict]:
    out: List[Dict] = []
    for n in signals.nodes:
        if n.heartbeat_age_s > cfg["stale_heartbeat_s"]:
            out.append({"action": "replace_node", "target": n.node_id,
                        "reason": f"heartbeat {n.heartbeat_age_s:.1f}s"
                                  f" > {cfg['stale_heartbeat_s']:g}s "
                                  "stale threshold",
                        "signals": {"state": n.state,
                                    "heartbeat_age_s":
                                        n.heartbeat_age_s}})
    return out


def _rule_grow_cache(signals: ClusterSignals,
                     cfg: Dict[str, float]) -> List[Dict]:
    out: List[Dict] = []
    caches = signals.caches
    for name, pressure in (("scan", caches.scan_cache_pressure),
                           ("plan", caches.plan_cache_pressure),
                           ("result", caches.result_cache_pressure)):
        if pressure > cfg["cache_pressure"]:
            out.append({"action": "grow_cache",
                        "target": f"{name}_cache",
                        "reason": f"fill {pressure:.0%} > "
                                  f"{cfg['cache_pressure']:.0%} "
                                  "pressure threshold",
                        "signals": {"pressure": round(pressure, 4)}})
    return out


def _rule_scale_coordinator(signals: ClusterSignals,
                            cfg: Dict[str, float]) -> List[Dict]:
    """Admission-bound detection: a group's queue is deep while every
    device sits idle, so the hard concurrency limit (admission), not
    worker capacity, is the bottleneck and more workers cannot help.
    The fix is more *coordinators*: each fleet member brings its own
    admission slots, federated with bounded staleness."""
    out: List[Dict] = []
    if not signals.nodes:
        return out                   # device idleness unknown: hold
    active = sum(n.active_tasks for n in signals.nodes)
    if active > len(signals.nodes):
        return out                   # devices busy: worker-bound
    for g in signals.groups:
        limit = max(1, g.hard_concurrency_limit)
        if g.queued >= cfg["coordinator_queue_ratio"] * limit \
                and g.running >= limit:
            out.append({"action": "scale_coordinator",
                        "target": g.group,
                        "reason": f"admission-bound: queue {g.queued} "
                                  f">= {cfg['coordinator_queue_ratio']:g}"
                                  f"x limit {limit} with "
                                  f"{active} active tasks across "
                                  f"{len(signals.nodes)} idle nodes",
                        "signals": {"queued": g.queued,
                                    "running": g.running,
                                    "limit": limit,
                                    "active_tasks": active,
                                    "nodes": len(signals.nodes)}})
    return out


#: evaluation order matters only for output ordering; each rule is
#: independent (scale_down re-checks the scale_up predicate itself)
RULES: "Dict[str, Callable[[ClusterSignals, Dict[str, float]], List[Dict]]]" = {
    "scale_up": _rule_scale_up,
    "scale_down": _rule_scale_down,
    "replace_node": _rule_replace_node,
    "grow_cache": _rule_grow_cache,
    "scale_coordinator": _rule_scale_coordinator,
}


def decide(signals: ClusterSignals, *,
           queue_ratio: float = 2.0,
           idle_ratio: float = 0.25,
           stale_heartbeat_s: float = 30.0,
           cache_pressure: float = 0.9,
           min_budget: float = 0.5,
           coordinator_queue_ratio: float = 4.0) -> List[Dict]:
    """Map one frozen snapshot to scaling recommendations by running
    every registered rule. Pure and deterministic: same snapshot, same
    decisions."""
    cfg = {"queue_ratio": queue_ratio, "idle_ratio": idle_ratio,
           "stale_heartbeat_s": stale_heartbeat_s,
           "cache_pressure": cache_pressure, "min_budget": min_budget,
           "coordinator_queue_ratio": coordinator_queue_ratio}
    out: List[Dict] = []
    for rule in RULES.values():
        out.extend(rule(signals, cfg))
    return out


def demo_signals() -> ClusterSignals:
    """A synthetic busy cluster exercising every classic rule: one
    backed-up group, one paging group, one idle group, one stale node,
    one hot cache (the watcher's ``--demo`` input)."""
    return ClusterSignals(
        ts=0.0,
        groups=(
            GroupSignals(group="serving.dash", state="FULL",
                         running=8, queued=20,
                         hard_concurrency_limit=8,
                         p95_s=0.45, burn_short=1.2, burn_long=0.8,
                         error_budget_remaining=0.6,
                         alert_state="OK"),
            GroupSignals(group="serving.adhoc", state="CAN_RUN",
                         running=3, queued=1,
                         hard_concurrency_limit=8,
                         p95_s=2.1, burn_short=14.0, burn_long=11.0,
                         error_budget_remaining=0.0,
                         alert_state="PAGE"),
            GroupSignals(group="batch", state="CAN_RUN",
                         running=0, queued=0,
                         hard_concurrency_limit=16,
                         error_budget_remaining=1.0,
                         alert_state="OK"),
        ),
        nodes=(
            NodeSignals(node_id="w0", state="active",
                        heartbeat_age_s=1.5, active_tasks=4),
            NodeSignals(node_id="w1", state="active",
                        heartbeat_age_s=95.0, active_tasks=0),
        ),
        caches=CacheSignals(scan_cache_resident_bytes=950,
                            scan_cache_limit_bytes=1000,
                            plan_cache_entries=10,
                            plan_cache_capacity=64,
                            result_cache_resident_bytes=100,
                            result_cache_limit_bytes=1000),
    )


# -- the drain path -----------------------------------------------------------

def drain_node(url: str, timeout_s: float = 30.0,
               poll_s: float = 0.1) -> bool:
    """The scale-down primitive: ask the node to drain (``PUT
    /v1/info/state SHUTTING_DOWN``: active tasks finish and commit their
    spool, the node deregisters itself with a final GONE announcement)
    and wait until its socket refuses. Returns False if the node never
    confirmed the drain or outlived ``timeout_s``; the caller decides
    what a stuck drain means. This function never kills anything."""
    req = urllib.request.Request(
        f"{url}/v1/info/state", data=b'"SHUTTING_DOWN"', method="PUT",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
    except Exception:
        return False
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"{url}/v1/info",
                                        timeout=2) as resp:
                resp.read()
        except urllib.error.HTTPError:
            pass                      # still answering: keep waiting
        except Exception:
            return True               # socket refused: drained and gone
        time.sleep(poll_s)
    return False


# -- providers ----------------------------------------------------------------

class NodeHandle:
    """One worker the provider owns."""

    __slots__ = ("node_id", "url", "proc", "server")

    def __init__(self, node_id: str, url: str, proc=None, server=None):
        self.node_id = node_id
        self.url = url
        self.proc = proc              # LocalProcessProvider
        self.server = server          # InProcessProvider

    def __repr__(self) -> str:
        return f"NodeHandle({self.node_id} @ {self.url})"


class NodeProvider:
    """The capacity boundary. The controller only ever calls these four
    methods; a cloud provider implements the same surface against real
    instance APIs. ``terminate`` exists for replacing nodes that no
    longer answer their drain: the controller never calls it for
    scale-down."""

    def launch(self) -> NodeHandle:
        raise NotImplementedError

    def nodes(self) -> List[NodeHandle]:
        raise NotImplementedError

    def drain(self, handle: NodeHandle,
              timeout_s: float = 30.0) -> bool:
        raise NotImplementedError

    def terminate(self, handle: NodeHandle) -> None:
        raise NotImplementedError


class LocalProcessProvider(NodeProvider):
    """Workers as real subprocesses (``python -m
    presto_tpu_torch.server.worker --device <device>``), announcing to
    the coordinator(s) over HTTP: separate address spaces (on the GPU,
    a CUDA context each), real process exit on drain, SIGKILL
    preemption. ``device`` is the workers' device: the GPU when none is
    named (the provider raises without one), ``"cpu"`` on the CPU."""

    def __init__(self, coordinator_urls: Sequence[str],
                 tpch_sf: float = 0.01, host: str = "127.0.0.1",
                 spool_dir: Optional[str] = None,
                 etc_dir: Optional[str] = None,
                 ready_timeout_s: float = 180.0,
                 extra_env: Optional[Dict[str, str]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.coordinator_urls = list(coordinator_urls)
        self.tpch_sf = float(tpch_sf)
        self.host = host
        self.spool_dir = spool_dir
        self.etc_dir = etc_dir
        self.ready_timeout_s = float(ready_timeout_s)
        #: worker-process environment overlay (e.g. the load ramp's
        #: PRESTO_TPU_TORCH_DEVICE_FLOOR_MS device model)
        self.extra_env = dict(extra_env or {})
        self._handles: List[NodeHandle] = []
        self._lock = threading.Lock()

    def launch(self) -> NodeHandle:
        # each worker is named here: workers booted from one etc
        # directory would otherwise all take its node.id, and discovery
        # keeps one entry per id
        argv = [sys.executable, "-m", "presto_tpu_torch.server.worker",
                "--device", str(self.device),
                "--host", self.host, "--port", "0",
                "--node-id", f"worker-{uuid.uuid4().hex[:12]}",
                "--tpch-sf", str(self.tpch_sf)]
        if self.coordinator_urls:
            argv += ["--coordinator", ",".join(self.coordinator_urls)]
        if self.spool_dir:
            argv += ["--spool-dir", self.spool_dir]
        if self.etc_dir:
            argv += ["--etc-dir", self.etc_dir]
        env = dict(os.environ)
        env.update(self.extra_env)
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, cwd=_REPO_ROOT, env=env,
            start_new_session=True)
        ready: List[Optional[bytes]] = [None]

        def read_line():
            ready[0] = proc.stdout.readline()
        t = threading.Thread(target=read_line, daemon=True)
        t.start()
        t.join(self.ready_timeout_s)
        if ready[0] is None or not ready[0].strip():
            proc.kill()
            proc.wait()
            raise RuntimeError(
                f"worker subprocess not ready in "
                f"{self.ready_timeout_s:.0f}s (exit {proc.poll()})")
        doc = json.loads(ready[0])
        handle = NodeHandle(doc["nodeId"],
                            f"http://{self.host}:{doc['port']}",
                            proc=proc)
        with self._lock:
            self._handles.append(handle)
        return handle

    def nodes(self) -> List[NodeHandle]:
        with self._lock:
            self._handles = [h for h in self._handles
                             if h.proc.poll() is None]
            return list(self._handles)

    def _forget(self, handle: NodeHandle) -> None:
        with self._lock:
            if handle in self._handles:
                self._handles.remove(handle)

    def drain(self, handle: NodeHandle,
              timeout_s: float = 30.0) -> bool:
        ok = drain_node(handle.url, timeout_s=timeout_s)
        if ok:
            try:
                handle.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                ok = False
        if ok:
            # the drained worker's stdout pipe closes with it
            handle.proc.stdout.close()
            self._forget(handle)
        return ok

    def terminate(self, handle: NodeHandle) -> None:
        handle.proc.kill()
        try:
            handle.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        handle.proc.stdout.close()
        self._forget(handle)

    def stop_all(self) -> None:
        """Provider teardown (harness cleanup, not controller policy)."""
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            self.terminate(h)


class InProcessProvider(NodeProvider):
    """``WorkerServer`` objects inside this process on ``device`` (the
    GPU when none is named; raises without one), announcing into an
    in-process ``DiscoveryNodeManager``: the chaos and test substrate.
    Drain still goes over real HTTP; the explicit deregister is a final
    GONE announcement."""

    def __init__(self, discovery, tpch_sf: float = 0.01,
                 catalogs=None, drain_grace_s: float = 2.0,
                 device=None):
        self.device = resolve_device(device)
        self.discovery = discovery
        self.tpch_sf = float(tpch_sf)
        self.catalogs = catalogs
        self.drain_grace_s = float(drain_grace_s)
        self._handles: List[NodeHandle] = []

    def launch(self) -> NodeHandle:
        from ..server.worker import WorkerServer
        w = WorkerServer(catalogs=self.catalogs, tpch_sf=self.tpch_sf,
                         drain_grace_s=self.drain_grace_s,
                         device=self.device)
        w.start()
        url = f"http://127.0.0.1:{w.port}"
        self.discovery.announce(w.node_id, url)
        handle = NodeHandle(w.node_id, url, server=w)
        self._handles.append(handle)
        return handle

    def nodes(self) -> List[NodeHandle]:
        self._handles = [
            h for h in self._handles
            if h.server.httpd.socket.fileno() != -1]
        return list(self._handles)

    def drain(self, handle: NodeHandle,
              timeout_s: float = 30.0) -> bool:
        ok = drain_node(handle.url, timeout_s=timeout_s)
        if ok:
            ok = handle.server.stopped.wait(timeout=timeout_s)
        if ok:
            # in-process workers announce through the provider, so the
            # provider issues their explicit deregister too
            self.discovery.announce(handle.node_id, handle.url,
                                    state="GONE")
            if handle in self._handles:
                self._handles.remove(handle)
        return ok

    def terminate(self, handle: NodeHandle) -> None:
        w = handle.server
        try:
            w.httpd.shutdown()
            w.httpd.server_close()
        except Exception:
            pass
        for t in list(w.tasks.values()):
            t.abort()
        self.discovery.announce(handle.node_id, handle.url,
                                state="GONE")
        if handle in self._handles:
            self._handles.remove(handle)

    def stop_all(self) -> None:
        for h in list(self._handles):
            self.terminate(h)


# -- the controller -----------------------------------------------------------

@dataclass
class AutoscalePolicy:
    """Everything the controller needs to stay stable: floor and
    ceiling, bounded steps, cooldown between applied actions, and the
    consecutive-evaluation confirmation count (hysteresis). The rule
    thresholds ride along so one object configures the whole loop."""
    min_workers: int = 1
    max_workers: int = 8
    scale_step: int = 1
    cooldown_s: float = 30.0
    confirm_evals: int = 2
    interval_s: float = 5.0
    rule_config: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_RULE_CONFIG))


class AutoscaleController:
    """The coordinator-side control loop (see the module docstring)."""

    def __init__(self, provider: NodeProvider,
                 policy: Optional[AutoscalePolicy] = None,
                 signals_fn: Callable[[], ClusterSignals]
                 = cluster_signals,
                 coordinator_scaler=None,
                 on_grow_cache: Optional[Callable[[str], None]] = None,
                 drain_timeout_s: float = 30.0):
        from .._devtools.lockcheck import checked_lock
        self.provider = provider
        self.policy = policy or AutoscalePolicy()
        self.signals_fn = signals_fn
        #: duck-typed coordinator-tier scaler: ``scale_up(reason)`` /
        #: ``scale_down(reason)`` (_devtools/fleet.FleetHandle)
        self.coordinator_scaler = coordinator_scaler
        self.on_grow_cache = on_grow_cache
        self.drain_timeout_s = float(drain_timeout_s)
        self._lock = checked_lock("autoscale.controller")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (action, target) -> consecutive evaluations recommending it
        self._streaks: Dict[Tuple[str, str], int] = {}
        self._last_action_t: Optional[float] = None
        self._last_report: Dict = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscale-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.evaluate()
            except Exception:
                # the control loop must outlive a bad snapshot or a
                # provider hiccup; the next tick retries
                REGISTRY.counter("autoscale_loop_errors_total").inc()

    # -- one control tick ----------------------------------------------------
    def evaluate(self, signals: Optional[ClusterSignals] = None,
                 now: Optional[float] = None) -> Dict:
        """One control tick: snapshot -> rules -> hysteresis, cooldown
        and bounds gates -> applied actions. Injectable ``signals`` and
        ``now`` make the loop testable tick by tick."""
        with self._lock:
            return self._evaluate_locked(signals, now)

    def _evaluate_locked(self, signals, now) -> Dict:
        now = time.monotonic() if now is None else now
        signals = self.signals_fn() if signals is None else signals
        _EVALS.inc()
        decisions = decide(signals, **self.policy.rule_config)
        for d in decisions:
            REGISTRY.counter(
                f"autoscale_decision_total.{d['action']}").inc()

        seen = {(d["action"], d["target"]) for d in decisions}
        self._streaks = {k: v + 1 for k, v in self._streaks.items()
                         if k in seen}
        for k in seen:
            self._streaks.setdefault(k, 1)

        applied: List[Dict] = []
        blocked: List[Dict] = []

        def block(d: Dict, why: str) -> None:
            REGISTRY.counter(f"autoscale_blocked_total.{why}").inc()
            blocked.append({**d, "blocked": why})

        paged = any(g.alert_state == "PAGE" for g in signals.groups)
        for d in decisions:
            action, target = d["action"], d["target"]
            if self._streaks.get((action, target), 0) \
                    < self.policy.confirm_evals:
                block(d, "hysteresis")
                continue
            if action == "grow_cache":
                # advisory unless a grower is injected: cache sizing is
                # a config decision, not a capacity one
                if self.on_grow_cache is not None:
                    self.on_grow_cache(target)
                    self._applied(d, applied)
                continue
            if self._last_action_t is not None \
                    and now - self._last_action_t \
                    < self.policy.cooldown_s:
                block(d, "cooldown")
                continue
            if action == "scale_up":
                n = min(self.policy.scale_step,
                        self.policy.max_workers
                        - len(self.provider.nodes()))
                if n <= 0:
                    block(d, "bounds")
                    continue
                for _ in range(n):
                    self.provider.launch()
                self._applied(d, applied, now, count=n)
            elif action == "scale_down":
                if paged:
                    # the SLO invariant, re-checked at apply time: a
                    # paging cluster never shrinks, not even a group
                    # the rules judged idle
                    block(d, "page-held")
                    continue
                nodes = self.provider.nodes()
                n = min(self.policy.scale_step,
                        len(nodes) - self.policy.min_workers)
                if n <= 0:
                    block(d, "bounds")
                    continue
                victims = self._pick_victims(nodes, signals, n)
                ok = all(self.provider.drain(
                    v, timeout_s=self.drain_timeout_s)
                    for v in victims)
                if ok:
                    self._applied(d, applied, now, count=len(victims))
                else:
                    # a stuck drain is not escalated to a kill: the
                    # node keeps serving, the next tick retries
                    block(d, "drain-failed")
            elif action == "replace_node":
                handle = next(
                    (h for h in self.provider.nodes()
                     if h.node_id == target), None)
                if handle is None:
                    block(d, "unknown-node")
                    continue
                self.provider.launch()   # capacity first
                if not self.provider.drain(
                        handle, timeout_s=self.drain_timeout_s):
                    # a node too dead to drain is what terminate exists
                    # for: replacement of a corpse, not scale-down
                    self.provider.terminate(handle)
                self._applied(d, applied, now)
            elif action == "scale_coordinator":
                if self.coordinator_scaler is None:
                    block(d, "no-scaler")
                    continue
                if self.coordinator_scaler.scale_up(d["reason"]):
                    self._applied(d, applied, now)
                else:
                    block(d, "scaler-refused")

        self._last_report = {
            "ts": signals.ts, "now": now,
            "workers": len(self.provider.nodes()),
            "decisions": decisions, "applied": applied,
            "blocked": blocked,
        }
        return self._last_report

    def _applied(self, d: Dict, applied: List[Dict],
                 now: Optional[float] = None, count: int = 1) -> None:
        REGISTRY.counter(
            f"autoscale_actions_total.{d['action']}").inc()
        applied.append({**d, "count": count})
        if now is not None:
            self._last_action_t = now

    @staticmethod
    def _pick_victims(nodes: List[NodeHandle],
                      signals: ClusterSignals,
                      n: int) -> List[NodeHandle]:
        """Idle-most first, judged by the feed's per-node active-task
        counts (unknown nodes sort last-launched-first-drained)."""
        active = {ns.node_id: ns.active_tasks for ns in signals.nodes}
        order = sorted(
            enumerate(nodes),
            key=lambda iv: (active.get(iv[1].node_id, 0), -iv[0]))
        return [h for _i, h in order[:n]]

    # -- observability -------------------------------------------------------
    def status(self) -> Dict:
        """The ``/v1/autoscale`` document."""
        return {
            "running": self._thread is not None,
            "policy": {
                "minWorkers": self.policy.min_workers,
                "maxWorkers": self.policy.max_workers,
                "scaleStep": self.policy.scale_step,
                "cooldownS": self.policy.cooldown_s,
                "confirmEvals": self.policy.confirm_evals,
                "intervalS": self.policy.interval_s,
            },
            "workers": [
                {"nodeId": h.node_id, "url": h.url}
                for h in self.provider.nodes()],
            "streaks": {f"{a}:{t}": c
                        for (a, t), c in self._streaks.items()},
            "lastReport": self._last_report,
        }
