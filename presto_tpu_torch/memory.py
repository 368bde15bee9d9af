"""Memory accounting: per-query device-memory pool + operator contexts.

The counterpart of ``presto_tpu/memory.py`` (reference
presto-memory-context/.../AggregatedMemoryContext.java,
LocalMemoryContext.java; pools memory/MemoryPool.java:44,111,143; revoke
execution/MemoryRevokingScheduler.java:46), reshaped for a device
runtime:

- the accounted resource is DEVICE-RESIDENT batch bytes; host copies are
  not charged;
- a reservation is *revocable* when its context registered a revoke
  callback (operators that can stage their state to the host);
- revoking is synchronous and only targets OTHER contexts: an operator
  whose own reservation fails spills itself (``try_reserve`` returns
  False); ``reserve`` raises when revoking others did not make room.

The spill buffers (``exec/spill.py``) hold revocable reservations; the
pool also carries the second spill tier's budget (``disk_threshold``,
compared with ``host_staged_bytes``, the host bytes staged by all of the
query's spill stores) and its directory.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

from .batch import data_parts
from .obs.metrics import REGISTRY

UNLIMITED = 1 << 62

#: process-wide high-water mark across every pool (the per-query peak
#: lives on MemoryStats)
_POOL_PEAK = REGISTRY.gauge("memory_pool_peak_bytes")


def batch_device_bytes(batch) -> int:
    """Accounted footprint of a batch: data, validity and row mask (a
    mesh's sharded batch: the sum over its parts)."""
    parts = getattr(batch, "parts", None)
    if parts is not None:
        return sum(batch_device_bytes(p) for p in parts)
    total = batch.row_mask.numel() * batch.row_mask.element_size()
    for c in batch.columns:
        for a in data_parts(c.data):
            total += a.numel() * a.element_size()
        total += c.validity.numel() * c.validity.element_size()
    return int(total)


@dataclasses.dataclass
class MemoryStats:
    peak_bytes: int = 0
    revocations: int = 0
    spilled_bytes: int = 0          # device bytes staged to the host
    disk_spilled_bytes: int = 0     # compressed page bytes written to disk


class MemoryLimitExceeded(RuntimeError):
    pass


class QueryMemoryPool:
    """A device-memory budget (reference memory/MemoryPool.java): one per
    query, and one per device for the scan cache."""

    def __init__(self, limit_bytes: Optional[int] = None,
                 disk_threshold: Optional[int] = None,
                 spill_dir: Optional[str] = None, group=None):
        self.limit = limit_bytes if limit_bytes is not None else UNLIMITED
        #: serving-plane group account (serving/groups.py): every change
        #: to ``reserved`` is mirrored to the admitting resource group
        #: via ``group.charge(delta)``; a charge may raise when the
        #: group's hard memory limit is hit: the requesting query dies,
        #: its siblings in the group survive
        self.group = group
        # the second (disk) spill tier's budget and directory
        # (reference NodeSpillConfig.maxSpillPerNode + spiller-spill-path)
        self.disk_threshold = disk_threshold
        self.spill_dir = spill_dir
        # host bytes currently staged by ALL of this query's spill stores
        self.host_staged_bytes = 0
        self.reserved = 0
        self.stats = MemoryStats()
        self._contexts: List["OperatorMemoryContext"] = []
        # re-entrant: a reservation under the lock can revoke another
        # context of the same thread, whose callback reserves again
        self.lock = threading.RLock()

    def context(self, name: str,
                revoke_cb: Optional[Callable[[], int]] = None
                ) -> "OperatorMemoryContext":
        ctx = OperatorMemoryContext(self, name, revoke_cb)
        with self.lock:
            self._contexts.append(ctx)
        return ctx

    def try_reserve(self, n: int, ctx: "OperatorMemoryContext") -> bool:
        """Reserve n bytes for ctx, revoking other revocable contexts
        (largest first) if needed. False: the caller must spill itself."""
        with self.lock:
            if n > self.limit:
                return False  # can never fit: don't force futile revokes
            if self.reserved + n > self.limit:
                self._revoke_others(self.reserved + n - self.limit, ctx)
            if self.reserved + n > self.limit:
                return False
            if self.group is not None:
                # bill the resource group BEFORE taking the bytes: a
                # hard-limit raise must leave both ledgers untouched
                self.group.charge(n)
            self.reserved += n
            ctx.bytes += n
            if self.reserved > self.stats.peak_bytes:
                self.stats.peak_bytes = self.reserved
                _POOL_PEAK.max_update(self.reserved)
            return True

    def reserve(self, n: int, ctx: "OperatorMemoryContext") -> None:
        """Like try_reserve but raising, for state that cannot spill."""
        if not self.try_reserve(n, ctx):
            raise MemoryLimitExceeded(
                f"query memory limit {self.limit} bytes exceeded: "
                f"reserved {self.reserved}, requested {n} ({ctx.name})")

    def _revoke_others(self, needed: int,
                       requester: "OperatorMemoryContext") -> None:
        holders = sorted(
            (c for c in self._contexts
             if c is not requester and c.revocable and c.bytes > 0),
            key=lambda c: -c.bytes)
        freed = 0
        for c in holders:
            if freed >= needed:
                break
            freed += c.revoke()
            self.stats.revocations += 1


class OperatorMemoryContext:
    """One operator's reservation (reference LocalMemoryContext).

    ``revoke_cb`` (if set) makes the reservation revocable: when called it
    must release the context's device memory and return the bytes freed.
    """

    def __init__(self, pool: QueryMemoryPool, name: str,
                 revoke_cb: Optional[Callable[[], int]] = None):
        self.pool = pool
        self.name = name
        self.bytes = 0
        self._revoke_cb = revoke_cb

    @property
    def revocable(self) -> bool:
        return self._revoke_cb is not None

    def pin(self) -> None:
        """End revocability: the holder handed its state to a consumer, so
        revoking could no longer free the device memory."""
        self._revoke_cb = None

    def revoke(self) -> int:
        with self.pool.lock:
            freed = self._revoke_cb() if self._revoke_cb is not None else 0
            self.release_all()
            return freed

    def release_all(self) -> None:
        with self.pool.lock:
            if self.pool.group is not None and self.bytes:
                self.pool.group.charge(-self.bytes)
            self.pool.reserved -= self.bytes
            self.bytes = 0

    def close(self) -> None:
        with self.pool.lock:
            self.release_all()
            if self in self.pool._contexts:
                self.pool._contexts.remove(self)
