"""Hierarchical resource groups: admission control for the statement server.

The counterpart of ``presto_tpu/server/resource_groups.py``. The
statement server (``server/protocol.py``) admits every statement through
its manager; a caller without a server admits a query itself
(``submit``, ``wait``) and runs it with ``LocalRunner.execute(...,
serving=QueryServingContext(admission.group))``.

The role of the reference's resource-group subsystem (reference
presto-main/.../execution/resourcegroups/InternalResourceGroup.java —
hierarchical concurrency/queue limits, weighted-fair dequeue across
subgroups via WeightedFairQueue.java;
InternalResourceGroupManager.java + the file-based configuration of
presto-resource-group-managers). Queries run in LEAF groups; a query is
eligible to start only while every group on its path is under its own
``hard_concurrency_limit``; full queues reject new work
(QUERY_QUEUE_FULL).

Configuration mirrors the file manager's JSON shape::

    {"rootGroups": [
        {"name": "global", "hardConcurrencyLimit": 4, "maxQueued": 100,
         "subGroups": [
            {"name": "adhoc", "hardConcurrencyLimit": 2,
             "schedulingWeight": 1},
            {"name": "etl", "hardConcurrencyLimit": 3,
             "schedulingWeight": 3}]}],
     "selectors": [
        {"user": "etl-.*", "group": "global.etl"},
        {"group": "global.adhoc"}]}

Dequeue is deterministic weighted-fair: among sibling subgroups with
queued queries, the one with the lowest running/weight ratio goes first.

Serving-plane extensions (presto_tpu_torch/serving/):

- ``softMemoryLimit`` / ``hardMemoryLimit`` (bytes): running queries
  charge their device-memory reservations to the admitting group chain
  (serving/groups.QueryServingContext); a group over its soft limit
  queues new queries instead of starting them, a reservation past the
  hard limit kills the requesting query (reference
  InternalResourceGroup.softMemoryLimit semantics).
- ``queryQueuedTimeout`` (duration): a query still queued past the
  deadline fails with QUERY_QUEUED_TIMEOUT instead of waiting forever
  (overridable per query via the ``query_queued_timeout`` session
  property).
- ``schedulingWeight`` additionally drives the device scheduler's
  per-group stride shares (exec/taskexec.py), so the weight governs
  device quanta, not just dequeue order.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional

from ..obs.metrics import REGISTRY

_ADMITTED = REGISTRY.counter("resource_group_admitted_total")
_QUEUED = REGISTRY.counter("resource_group_queued_total")
_REJECTED = REGISTRY.counter("resource_group_rejected_total")
_QUEUE_TIMEOUTS = REGISTRY.counter("resource_group_queued_timeout_total")


class QueryQueueFullError(RuntimeError):
    pass


class QueryQueuedTimeoutError(RuntimeError):
    """Admission deadline exceeded (``queryQueuedTimeout`` group config
    or ``query_queued_timeout`` session property)."""

    name = "QUERY_QUEUED_TIMEOUT"


def _parse_limit_bytes(v) -> Optional[int]:
    if v is None:
        return None
    return int(v)


def _parse_timeout_s(v) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    from ..exec.cluster import parse_duration_s
    return parse_duration_s(v)


def _parse_slo(spec) -> Optional[dict]:
    """Normalize and validate a per-group ``slo`` block (see
    docs/serving.md): latency objective (``latencyTargetMs`` +
    ``latencyObjective``), availability objective
    (``availabilityObjective``), optional ``windows`` (seconds).
    Objectives are fractions in (0, 1); fail fast on malformed config
    so a typo'd SLO cannot silently track nothing."""
    if spec is None:
        return None
    if not isinstance(spec, dict):
        raise ValueError(f"slo block must be an object, got {spec!r}")
    out: dict = {}
    lat_obj = spec.get("latencyObjective")
    if lat_obj is not None:
        target_ms = spec.get("latencyTargetMs")
        if target_ms is None:
            raise ValueError("slo.latencyObjective requires "
                             "slo.latencyTargetMs")
        out["latencyObjective"] = float(lat_obj)
        out["latencyTargetMs"] = float(target_ms)
    avail = spec.get("availabilityObjective")
    if avail is not None:
        out["availabilityObjective"] = float(avail)
    for key in ("latencyObjective", "availabilityObjective"):
        v = out.get(key)
        if v is not None and not 0.0 < v < 1.0:
            raise ValueError(f"slo.{key} must be in (0, 1), got {v}")
    if not out:
        raise ValueError("slo block declares no objective "
                         "(latencyObjective or availabilityObjective)")
    windows = spec.get("windows")
    if windows is not None:
        ws = sorted(float(w) for w in windows)
        if not ws or any(w <= 0 for w in ws):
            raise ValueError(f"slo.windows must be positive seconds, "
                             f"got {windows!r}")
        out["windows"] = ws
    return out


class Admission:
    """Handle for one submitted query: wait() blocks until a run slot is
    granted; release() frees it (must be called exactly once)."""

    def __init__(self, group: "ResourceGroup"):
        self.group = group
        self.submit_time = time.monotonic()
        self._granted = threading.Event()
        self._released = False

    def queued_timeout_s(self, override=None) -> Optional[float]:
        """Effective admission deadline in seconds: the per-query
        session-property override wins, else the leaf group's
        ``queryQueuedTimeout``; None = wait forever."""
        if override is not None:
            return _parse_timeout_s(override)
        return self.group.query_queued_timeout

    def time_out(self) -> None:
        """Mark this admission as dead-on-queue: releases the queue slot
        and counts the timeout (callers raise QueryQueuedTimeoutError)."""
        _QUEUE_TIMEOUTS.inc()
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._granted.wait(timeout)

    @property
    def granted(self) -> bool:
        return self._granted.is_set()

    def release(self) -> None:
        with self.group.manager.lock:
            if self._released:
                return
            self._released = True
            if self.granted:
                g = self.group
                while g is not None:
                    g.running -= 1
                    g = g.parent
            else:
                # abandoned while QUEUED (cancel before grant): leave no
                # ghost entry for the dispatcher to grant a slot to
                try:
                    self.group.queue.remove(self)
                except ValueError:
                    pass
        self.group.manager._dispatch()


class ResourceGroup:
    def __init__(self, manager: "ResourceGroupManager", name: str,
                 parent: Optional["ResourceGroup"],
                 hard_concurrency_limit: int = 1,
                 max_queued: int = 100, scheduling_weight: int = 1,
                 soft_memory_limit: Optional[int] = None,
                 hard_memory_limit: Optional[int] = None,
                 query_queued_timeout: Optional[float] = None,
                 slo: Optional[dict] = None):
        self.manager = manager
        self.name = name
        self.parent = parent
        self.path = name if parent is None else f"{parent.path}.{name}"
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        self.scheduling_weight = max(scheduling_weight, 1)
        #: device-memory bytes charged by this group's running queries
        #: (and its descendants'), maintained under manager.memory_lock
        #: by serving.groups.QueryServingContext
        self.soft_memory_limit = soft_memory_limit
        self.hard_memory_limit = hard_memory_limit
        self.memory_reserved = 0
        self.query_queued_timeout = query_queued_timeout
        #: normalized SLO block (``_parse_slo``) — consumed by
        #: obs/slo.py through ``info()``; None = no objectives
        self.slo = slo
        self.children: Dict[str, ResourceGroup] = {}
        self.queue: List[Admission] = []
        self.running = 0

    # -- accounting (manager.lock held) --------------------------------------
    def queued_total(self) -> int:
        return len(self.queue) + sum(c.queued_total()
                                     for c in self.children.values())

    def _remote_running(self) -> int:
        """Running count this group's path holds on OTHER coordinators
        (fleet federation; serving/fleet.py). 0 when standalone. Called
        under manager.lock — the provider takes only its own lock
        (order: resourcegroups.manager -> fleet.member)."""
        fed = self.manager.federation
        if fed is None:
            return 0
        try:
            return int(fed.remote_running(self.path))
        except Exception:
            return 0

    def _remote_memory(self) -> int:
        fed = self.manager.federation
        if fed is None:
            return 0
        try:
            return int(fed.remote_memory(self.path))
        except Exception:
            return 0

    def over_soft_memory(self) -> bool:
        return (self.soft_memory_limit is not None
                and self.memory_reserved + self._remote_memory()
                > self.soft_memory_limit)

    def _over_soft_memory_local(self) -> bool:
        return (self.soft_memory_limit is not None
                and self.memory_reserved > self.soft_memory_limit)

    def can_run_more(self) -> bool:
        g: Optional[ResourceGroup] = self
        while g is not None:
            remote = g._remote_running()
            if g.running + remote >= g.hard_concurrency_limit:
                if remote and g.running < g.hard_concurrency_limit:
                    # a coordinator-local view would have admitted:
                    # the fleet-wide limit is what blocked
                    g.manager._note_remote_blocked()
                return False
            if g.over_soft_memory():
                # kill-or-queue: over the soft limit the group keeps its
                # running queries but admits nothing new until memory
                # returns (reference InternalResourceGroup.canRunMore)
                if not g._over_soft_memory_local():
                    g.manager._note_remote_blocked()
                return False
            g = g.parent
        return True

    def _pick_queued(self) -> Optional["ResourceGroup"]:
        """Deepest-first weighted-fair choice of a descendant leaf-queue
        with work, honoring every level's concurrency limit (federated:
        a group whose fleet-wide running count fills its limit is not a
        candidate, so it cannot shadow an admissible sibling)."""
        if self.running + self._remote_running() \
                >= self.hard_concurrency_limit \
                or self.over_soft_memory():
            return None
        candidates = [c._pick_queued() for c in self.children.values()]
        candidates = [c for c in candidates if c is not None]
        if self.queue:
            candidates.append(self)
        if not candidates:
            return None
        return min(candidates,
                   key=lambda g: (g.running / g.scheduling_weight,
                                  g.path))

    def info(self) -> dict:
        if self.over_soft_memory():
            state = "OVER_SOFT_MEMORY_LIMIT"
        elif self.running >= self.hard_concurrency_limit:
            state = "FULL"
        else:
            state = "CAN_RUN"
        return {
            "id": self.path,
            "state": state,
            "hardConcurrencyLimit": self.hard_concurrency_limit,
            "maxQueued": self.max_queued,
            "schedulingWeight": self.scheduling_weight,
            "softMemoryLimitBytes": self.soft_memory_limit,
            "hardMemoryLimitBytes": self.hard_memory_limit,
            "memoryReservedBytes": self.memory_reserved,
            "queryQueuedTimeoutS": self.query_queued_timeout,
            "slo": self.slo,
            "numRunning": self.running,
            "numQueued": len(self.queue),
            "subGroups": [c.info() for c in self.children.values()],
        }


_SCOPE_SEQ = iter(range(1, 1 << 62))


class ResourceGroupManager:
    def __init__(self, config: Optional[dict] = None):
        from .._devtools.lockcheck import checked_lock
        #: process-unique scope for this manager's groups: same-named
        #: groups of DIFFERENT managers (two embedded servers in one
        #: process) must not share one device-scheduler stride account
        self.scope = f"rg{next(_SCOPE_SEQ)}"
        self.lock = checked_lock("resourcegroups.manager")
        #: guards the per-group memory ledgers — separate from ``lock``
        #: because memory charges arrive from inside QueryMemoryPool
        #: reservations (hot path) while ``lock`` serializes dispatch
        self.memory_lock = checked_lock("resourcegroups.memory")
        #: fleet federation provider (serving/fleet.FleetMember), set by
        #: the member on install; None = standalone coordinator. Must
        #: expose remote_running(path) / remote_memory(path) /
        #: note_remote_blocked(), and must never call back into this
        #: manager while holding its own lock (lock order:
        #: resourcegroups.manager -> fleet.member).
        self.federation = None
        self.roots: Dict[str, ResourceGroup] = {}
        self.selectors: List[dict] = []
        config = config or {
            "rootGroups": [{"name": "global", "hardConcurrencyLimit": 1,
                            "maxQueued": 200}],
            "selectors": [{"group": "global"}],
        }
        for spec in config.get("rootGroups", []):
            self._build(spec, None)
        self.selectors = list(config.get("selectors", []))
        # the system.runtime.resource_groups table reflects every live
        # manager in the process (weak registration)
        from ..serving.groups import register_manager
        register_manager(self)

    def _build(self, spec: dict, parent: Optional[ResourceGroup]) -> None:
        g = ResourceGroup(
            self, spec["name"], parent,
            hard_concurrency_limit=int(
                spec.get("hardConcurrencyLimit", 1)),
            max_queued=int(spec.get("maxQueued", 100)),
            scheduling_weight=int(spec.get("schedulingWeight", 1)),
            soft_memory_limit=_parse_limit_bytes(
                spec.get("softMemoryLimit")),
            hard_memory_limit=_parse_limit_bytes(
                spec.get("hardMemoryLimit")),
            query_queued_timeout=_parse_timeout_s(
                spec.get("queryQueuedTimeout")),
            slo=_parse_slo(spec.get("slo")))
        if parent is None:
            self.roots[g.name] = g
        else:
            parent.children[g.name] = g
        for sub in spec.get("subGroups", []):
            self._build(sub, g)

    # -- selection -----------------------------------------------------------
    def _group_for(self, user: str, source: str) -> ResourceGroup:
        for sel in self.selectors:
            if "user" in sel and not re.fullmatch(sel["user"], user or ""):
                continue
            if "source" in sel and not re.fullmatch(sel["source"],
                                                    source or ""):
                continue
            return self._resolve(sel["group"])
        # no selector matched: first root
        return next(iter(self.roots.values()))

    def _resolve(self, path: str) -> ResourceGroup:
        parts = path.split(".")
        g = self.roots[parts[0]]
        for p in parts[1:]:
            g = g.children[p]
        return g

    # -- submission ----------------------------------------------------------
    def submit(self, user: str = "", source: str = "") -> Admission:
        with self.lock:
            group = self._group_for(user, source)
            if group.queued_total() >= group.max_queued:
                _REJECTED.inc()
                raise QueryQueueFullError(
                    f"Too many queued queries for {group.path!r}")
            adm = Admission(group)
            group.queue.append(adm)
            _QUEUED.inc()
        self._dispatch()
        return adm

    def _dispatch(self) -> None:
        with self.lock:
            while True:
                started = False
                for root in self.roots.values():
                    g = root._pick_queued()
                    if g is None or not g.queue:
                        continue
                    if not g.can_run_more():
                        continue
                    adm = g.queue.pop(0)
                    walk: Optional[ResourceGroup] = g
                    while walk is not None:
                        walk.running += 1
                        walk = walk.parent
                    adm._granted.set()
                    _ADMITTED.inc()
                    started = True
                if not started:
                    return

    def _note_remote_blocked(self) -> None:
        fed = self.federation
        if fed is not None:
            try:
                fed.note_remote_blocked()
            except Exception:
                pass

    def group_counts(self) -> Dict[str, dict]:
        """Per-group ``{running, queued, memory}`` snapshot, keyed by
        dotted path — the fleet heartbeat payload (serving/fleet.py)."""
        out: Dict[str, dict] = {}
        with self.lock:
            stack = list(self.roots.values())
            while stack:
                g = stack.pop()
                out[g.path] = {"running": g.running,
                               "queued": len(g.queue),
                               "memory": g.memory_reserved}
                stack.extend(g.children.values())
        return out

    def info(self) -> List[dict]:
        with self.lock:
            return [g.info() for g in self.roots.values()]
