"""The autoscaler signals feed: one frozen, typed cluster snapshot.

The counterpart of ``presto_tpu/obs/signals.py``.

An autoscaler that watches resource-group queue depth, p95 and
per-node HBM needs a *stable input contract*.  This module is that
contract:
:func:`cluster_signals` assembles one immutable :class:`ClusterSignals`
from surfaces that already exist —

- per-group admission state (queue depth / running) from the live
  resource-group managers (``serving/groups.py``),
- per-group windowed p95 + SLO burn/budget/alert-state from the
  time-series store and SLO tracker (``obs/timeseries.py``,
  ``obs/slo.py``),
- per-node heartbeat age, active tasks, and HBM in-use/peak from the
  node registry (``obs.metrics.NODES``, fed by the cluster heartbeat),
- scan-cache / plan-cache / result-cache pressure from the serving
  cache singletons.

Consumers MUST treat a snapshot as a value: every field is frozen, and
``None`` means "no data yet" (e.g. p95 before two samples exist), never
zero.

Compatibility promise: fields are only added, never renamed or removed;
new fields always default to ``None``/empty so older consumers keep
working.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .slo import SLO
from .timeseries import TIMESERIES

#: default window (seconds) for the windowed p95 in GroupSignals
SIGNAL_WINDOW_S = 300.0


@dataclass(frozen=True)
class GroupSignals:
    """One resource group's health at the snapshot instant."""
    group: str                       # dotted path, e.g. "serving.dash"
    state: str                       # CAN_RUN | FULL | OVER_SOFT_MEMORY_LIMIT
    running: int
    queued: int
    hard_concurrency_limit: int
    p95_s: Optional[float] = None    # windowed serving latency p95
    burn_short: Optional[float] = None   # shortest-window burn rate
    burn_long: Optional[float] = None    # longest-window burn rate
    error_budget_remaining: Optional[float] = None  # 0..1
    alert_state: str = "OK"          # OK | WARN | PAGE


@dataclass(frozen=True)
class NodeSignals:
    """One worker node's health, from the heartbeat-fed registry."""
    node_id: str
    state: str                       # e.g. "active"
    heartbeat_age_s: float           # inf when never seen
    active_tasks: int = 0
    hbm_in_use_bytes: Optional[int] = None
    hbm_peak_bytes: Optional[int] = None


@dataclass(frozen=True)
class CacheSignals:
    """Serving-cache pressure (0..1 fill fractions where a limit exists)."""
    scan_cache_resident_bytes: int = 0
    scan_cache_limit_bytes: int = 0
    plan_cache_entries: int = 0
    plan_cache_capacity: int = 0
    result_cache_resident_bytes: int = 0
    result_cache_limit_bytes: int = 0

    @property
    def scan_cache_pressure(self) -> float:
        if self.scan_cache_limit_bytes <= 0:
            return 0.0
        return self.scan_cache_resident_bytes / self.scan_cache_limit_bytes

    @property
    def plan_cache_pressure(self) -> float:
        if self.plan_cache_capacity <= 0:
            return 0.0
        return self.plan_cache_entries / self.plan_cache_capacity

    @property
    def result_cache_pressure(self) -> float:
        if self.result_cache_limit_bytes <= 0:
            return 0.0
        return (self.result_cache_resident_bytes
                / self.result_cache_limit_bytes)


@dataclass(frozen=True)
class ClusterSignals:
    """The complete autoscaler input: groups + nodes + caches at ``ts``."""
    ts: float
    groups: Tuple[GroupSignals, ...] = ()
    nodes: Tuple[NodeSignals, ...] = ()
    caches: CacheSignals = field(default_factory=CacheSignals)

    def group(self, path: str) -> Optional[GroupSignals]:
        for g in self.groups:
            if g.group == path:
                return g
        return None

    def node(self, node_id: str) -> Optional[NodeSignals]:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        return None


def _group_signals(now: float) -> Tuple[GroupSignals, ...]:
    from ..serving.groups import live_managers
    budgets: Dict[str, Tuple] = {}
    for row in SLO.snapshot_rows(now=now):
        # prefer the latency objective's burn for a group with both
        group, objective = row[0], row[1]
        if group not in budgets or objective == "latency":
            budgets[group] = (row[7], row[8], row[9])
    declared = {(o.group, o.objective) for o in SLO.objectives()}
    out = []
    seen = set()
    for mgr in live_managers():
        stack = list(mgr.info())
        while stack:
            g = stack.pop()
            stack.extend(g["subGroups"])
            path = g["id"]
            if path in seen:
                continue
            seen.add(path)
            p95 = TIMESERIES.window_quantile(
                f"serving_latency_seconds.{path}", SIGNAL_WINDOW_S,
                0.95, now=now)
            burn_short, burn_long, budget = budgets.get(
                path, (None, None, None))
            kind = ("latency" if (path, "latency") in declared
                    else "availability")
            out.append(GroupSignals(
                group=path, state=g["state"],
                running=int(g["numRunning"]),
                queued=int(g["numQueued"]),
                hard_concurrency_limit=int(g["hardConcurrencyLimit"]),
                p95_s=p95, burn_short=burn_short, burn_long=burn_long,
                error_budget_remaining=budget,
                alert_state=SLO.state_of(path, kind)))
    out.sort(key=lambda g: g.group)
    return tuple(out)


def _node_signals() -> Tuple[NodeSignals, ...]:
    from .metrics import NODES
    out = []
    for doc in NODES.snapshot():
        out.append(NodeSignals(
            node_id=str(doc.get("node_id", "")),
            state=str(doc.get("state", "unknown")),
            heartbeat_age_s=float(doc.get("heartbeat_age_s",
                                          float("inf"))),
            active_tasks=int(doc.get("active_tasks", 0) or 0),
            hbm_in_use_bytes=doc.get("hbm_in_use_bytes"),
            hbm_peak_bytes=doc.get("hbm_peak_bytes")))
    out.sort(key=lambda n: n.node_id)
    return tuple(out)


def _cache_signals() -> CacheSignals:
    from ..exec.scancache import CACHE
    from ..serving.plancache import PLANS
    from ..serving.resultcache import RESULTS
    rstats = RESULTS.stats()
    # the port keeps one scan cache per device: resident bytes over all
    # of them, against the per-device limit
    return CacheSignals(
        scan_cache_resident_bytes=int(CACHE.resident_bytes()),
        scan_cache_limit_bytes=int(CACHE.limit_bytes),
        plan_cache_entries=len(PLANS),
        plan_cache_capacity=int(PLANS.capacity),
        result_cache_resident_bytes=int(rstats["resident_bytes"]),
        result_cache_limit_bytes=int(RESULTS.pool.limit))


def cluster_signals(now: Optional[float] = None) -> ClusterSignals:
    """Assemble one frozen :class:`ClusterSignals` snapshot.

    ``now`` (``time.time()`` domain) pins the windowed reads for
    deterministic tests; production callers omit it.
    """
    t = time.time() if now is None else float(now)
    return ClusterSignals(
        ts=t,
        groups=_group_signals(t),
        nodes=_node_signals(),
        caches=_cache_signals())
