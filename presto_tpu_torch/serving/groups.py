"""Per-group execution accounting: the glue between admission control
(server/resource_groups.py) and the executor.

The counterpart of ``presto_tpu/serving/groups.py``. The reference tracks
``cachedMemoryUsageBytes`` per resource group and refuses to start
queries in a group above its ``softMemoryLimit`` (reference
execution/resourcegroups/InternalResourceGroup.java
``canRunMore``/``updateMemoryUsage``); device-time fairness lives in a
separate TaskExecutor. Here both bridges meet in one per-query
:class:`QueryServingContext`:

- **memory**: the query's ``memory.QueryMemoryPool`` charges every
  device-byte reservation to the admitting group chain (under the
  manager's memory lock). A group past its ``softMemoryLimit`` queues
  new queries (``ResourceGroup.can_run_more``); a reservation pushing
  any ancestor past its ``hardMemoryLimit`` raises: the requesting
  query is killed (``resource_group_memory_kill_total``) instead of the
  whole group wedging.
- **device**: ``exec/taskexec.DeviceScheduler`` quanta are allotted per
  group (stride scheduling over ``schedulingWeight``), then per task
  within the group; the context carries the group path and weight so
  ``execute_plan`` can register its task handle under the right share.

``group_snapshot()`` joins every live manager's admission counters with
the scheduler's device-share ledger: the feed of
``system.runtime.resource_groups``.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional

from .._devtools.lockcheck import checked_lock
from ..memory import MemoryLimitExceeded
from ..obs.metrics import REGISTRY

_MEMORY_KILLS = REGISTRY.counter("resource_group_memory_kill_total")

#: every live ResourceGroupManager registers here (construction-time),
#: so the process-wide system.runtime.resource_groups table can reflect
#: the servers running in this process without holding them alive.
#: WeakSet mutation is not atomic (add races GC-driven discard); two
#: servers booting concurrently must not lose a registration.
_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()
_managers_lock = checked_lock("serving.managers")


def register_manager(manager) -> None:
    with _managers_lock:
        _MANAGERS.add(manager)


def live_managers() -> list:
    """Stable list of the live managers (the SLO tracker and the
    signals feed walk group trees through this)."""
    with _managers_lock:
        return list(_MANAGERS)


class QueryServingContext:
    """One admitted query's serving identity: the group it bills memory
    to and the scheduler share its device quanta draw from. Carried on
    the per-query ``Session.serving`` field; ``close()`` refunds any
    residual group memory exactly once (every protocol exit path calls
    it, so accounting cannot leak with the admission slot)."""

    def __init__(self, group):
        self.group = group
        self.group_path: str = group.path
        #: scheduler share key, scoped by the owning manager so two
        #: servers' same-named groups keep separate stride accounts
        self.scheduler_group: str = \
            f"{group.manager.scope}/{group.path}"
        self.weight: int = group.scheduling_weight
        self._net = 0
        self._closed = False

    # -- memory bridge (QueryMemoryPool.group protocol) ----------------------
    def charge(self, delta: int) -> None:
        """Bill ``delta`` device bytes (negative = release) to the
        admitting group chain. Raises MemoryLimitExceeded when a grow
        would push any ancestor past its hard limit — the pool
        propagates it and this query fails, the group survives."""
        mgr = self.group.manager
        with mgr.memory_lock:
            if self._closed:
                return
            if delta > 0:
                g = self.group
                while g is not None:
                    if g.hard_memory_limit is not None \
                            and g.memory_reserved + delta \
                            > g.hard_memory_limit:
                        _MEMORY_KILLS.inc()
                        raise MemoryLimitExceeded(
                            f"resource group {g.path!r} hard memory "
                            f"limit {g.hard_memory_limit} bytes "
                            f"exceeded (reserved {g.memory_reserved}, "
                            f"requested {delta})")
                    g = g.parent
            self._net += delta
            g = self.group
            while g is not None:
                g.memory_reserved += delta
                g = g.parent

    def close(self) -> None:
        """Refund whatever this query still has charged (idempotent) and
        wake the dispatcher — a group queued on its soft memory limit
        may become eligible the moment this query's bytes return."""
        mgr = self.group.manager
        with mgr.memory_lock:
            if self._closed:
                return
            self._closed = True
            residual, self._net = self._net, 0
            if residual:
                g = self.group
                while g is not None:
                    g.memory_reserved -= residual
                    g = g.parent
        mgr._dispatch()


def serving_context(admission) -> Optional[QueryServingContext]:
    """Context for a granted admission (None when admission control is
    not in play, e.g. direct LocalRunner use)."""
    if admission is None:
        return None
    return QueryServingContext(admission.group)


def group_snapshot() -> List[Dict]:
    """Rows for ``system.runtime.resource_groups``: every group of every
    live manager, joined with the device scheduler's per-group ledger."""
    from ..exec.taskexec import GLOBAL as scheduler
    shares = scheduler.group_shares()
    total_device = sum(s["device_seconds"] for s in shares.values()) \
        or 0.0
    out: List[Dict] = []
    with _managers_lock:
        managers = list(_MANAGERS)
    for mgr in managers:
        for info in mgr.info():
            stack = [info]
            while stack:
                g = stack.pop()
                share = shares.get(f"{mgr.scope}/{g['id']}", {})
                dev_s = float(share.get("device_seconds", 0.0))
                out.append({
                    "group": g["id"],
                    "state": g["state"],
                    "running": g["numRunning"],
                    "queued": g["numQueued"],
                    "memory_reserved_bytes": g["memoryReservedBytes"],
                    "soft_memory_limit_bytes": g["softMemoryLimitBytes"],
                    "scheduling_weight": g["schedulingWeight"],
                    "device_seconds": dev_s,
                    "device_share": (dev_s / total_device
                                     if total_device else 0.0),
                    "quanta": int(share.get("quanta", 0)),
                })
                stack.extend(g["subGroups"])
    return out
