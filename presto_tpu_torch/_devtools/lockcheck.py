"""Runtime lock-order validator.

The counterpart of ``presto_tpu/_devtools/lockcheck.py``. The engine's
thread pools (scan prefetch workers, local-exchange producers and
drivers, the history sink) share locks whose order a reader cannot see
from one module. This module records the acquisition edges taken at run
time: every instrumented lock pushes itself onto a per-thread held
stack, and acquiring lock B while holding lock A records the edge A->B.
``check()`` then fails on

- **cycles** in the observed edge graph (an AB/BA inversion was
  executed, even if the two orders ran on different threads and never
  deadlocked in this run), and
- **guarded-field violations**: an attribute declared
  ``x = guarded_by("lock.name")`` fails fast (raises
  :class:`GuardedFieldError` and records a violation) when read or
  written by a thread not holding that checked lock. The first write is
  exempt so ``__init__`` can seed the field before the object is
  published.

An interleaving explorer can install a **scheduler hook**
(``set_scheduler``): while one is active, threads it registered route
their ``checked_lock`` acquires through it (non-blocking probe and
blocked bookkeeping), so a thread descheduled while holding a lock
cannot silently deadlock the exploration.

Gating: instrumentation is decided once at import by the
``PRESTO_TPU_TORCH_LOCKCHECK`` environment variable (``1`` / ``0``);
when unset it is on under pytest ("pytest" already imported) and off
otherwise, so a ``checked_lock`` / ``checked_rlock`` in production costs
exactly a plain ``threading.Lock``.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["ENABLED", "GRAPH", "GuardedFieldError", "LockGraph",
           "checked_lock", "checked_rlock", "guarded_by", "set_scheduler"]

_env = os.environ.get("PRESTO_TPU_TORCH_LOCKCHECK")
if _env is None:
    #: on by default under pytest, off everywhere else
    ENABLED = "pytest" in sys.modules
else:
    ENABLED = _env.strip().lower() not in ("0", "false", "off", "")

#: active interleaving scheduler or None, consulted per checked-lock
#: acquire and release; only threads the scheduler registered are routed
#: through it
_SCHEDULER = None


def set_scheduler(sched) -> None:
    """Install (or, with None, remove) the interleaving scheduler the
    checked locks report to. Exploration runs are serial, so a plain
    module global is enough."""
    global _SCHEDULER
    _SCHEDULER = sched


class LockGraph:
    """Observed lock-acquisition edges + violations, per graph instance
    (the process uses :data:`GRAPH`; tests build private ones so seeded
    inversions don't fail the suite-wide clean check)."""

    def __init__(self):
        self._local = threading.local()
        # raw primitive lock: the graph guards itself and must never
        # recurse into its own instrumentation
        self._mu = threading.Lock()
        #: (held_name, acquired_name) -> first-seen description
        self.edges: Dict[Tuple[str, str], str] = {}
        #: guarded-field violations, appended as they happen
        self.violations: List[str] = []

    # -- held-stack plumbing (called from _CheckedLock) ----------------------
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _acquired(self, name: str) -> None:
        st = self._stack()
        for held in st:
            if held != name and (held, name) not in self.edges:
                with self._mu:
                    self.edges.setdefault(
                        (held, name), f"{held} -> {name}")
        st.append(name)

    def _released(self, name: str) -> None:
        st = self._stack()
        # remove the innermost occurrence (re-entrant RLocks push twice)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    # -- public API ----------------------------------------------------------
    def lock(self, name: str) -> "_CheckedLock":
        return _CheckedLock(name, threading.Lock(), self)

    def rlock(self, name: str) -> "_CheckedLock":
        return _CheckedLock(name, threading.RLock(), self)

    def held(self) -> List[str]:
        return list(self._stack())

    def check(self) -> List[str]:
        """Violation strings: recorded guarded-field violations plus
        every cycle in the observed acquisition-order graph."""
        with self._mu:
            out = list(self.violations)
            adj: Dict[str, List[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, []).append(b)
        state: Dict[str, int] = {}   # 0=visiting, 1=done
        path: List[str] = []

        def visit(n: str) -> Optional[List[str]]:
            state[n] = 0
            path.append(n)
            for m in adj.get(n, ()):
                if state.get(m) == 0:
                    return path[path.index(m):] + [m]
                if m not in state:
                    cyc = visit(m)
                    if cyc:
                        return cyc
            path.pop()
            state[n] = 1
            return None

        seen_cycles = set()
        for n in sorted(adj):
            if n not in state:
                cyc = visit(n)
                if cyc:
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append("lock-order cycle: "
                                   + " -> ".join(cyc))
                    # keep scanning other components: everything still
                    # on the aborted DFS path counts as finished so a
                    # later visit can't index a cleared path
                    state.update({k: 1 for k in path})
                    state.update({k: 1 for k in cyc})
                    path.clear()
        return out

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.violations.clear()


class _CheckedLock:
    """Lock/RLock wrapper feeding a :class:`LockGraph`. Supports the
    subset of the lock protocol the engine (and ``threading.Condition``
    over it) uses: acquire/release/context manager."""

    __slots__ = ("name", "_inner", "_graph")

    def __init__(self, name: str, inner, graph: LockGraph):
        self.name = name
        self._inner = inner
        self._graph = graph

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = _SCHEDULER
        if sched is not None and blocking and timeout == -1 \
                and sched.owns_current_thread():
            # interleaving exploration: the scheduler serializes
            # registered threads, so a blocking acquire from one must
            # go through it (non-blocking probe + blocked bookkeeping)
            # or a descheduled holder would deadlock the exploration
            got = sched.checked_acquire(self._inner, self.name)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph._acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph._released(self.name)
        sched = _SCHEDULER
        if sched is not None:
            sched.lock_released(self.name)

    def __enter__(self) -> "_CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._inner, "locked", None)
        if fn is not None:
            return fn()
        # RLock before Python 3.12 has no locked(): probe with a
        # non-blocking acquire on the raw primitive (no graph edges —
        # this is introspection, not an acquisition)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


#: the process-wide graph instrumented engine locks feed
GRAPH = LockGraph()


def checked_lock(name: str):
    """A ``threading.Lock`` — instrumented into :data:`GRAPH` when the
    validator is enabled, a plain primitive lock otherwise."""
    if not ENABLED:
        return threading.Lock()
    return GRAPH.lock(name)


def checked_rlock(name: str):
    if not ENABLED:
        return threading.RLock()
    return GRAPH.rlock(name)


# -- guarded fields -----------------------------------------------------------

class GuardedFieldError(RuntimeError):
    """A ``guarded_by`` field was touched without its lock held."""


class _GuardedField:
    """Data descriptor enforcing a guarded-by contract on one attribute.
    Values live in the instance ``__dict__`` under a mangled key (a data
    descriptor wins the lookup, so the public name stays clean); every
    read and every write after the first checks the current thread's
    held-lock stack. ``check=False`` (production) keeps the storage
    protocol with zero validation."""

    __slots__ = ("lock_name", "lock_attr", "name", "slot", "check",
                 "_graph")

    def __init__(self, lock_name: Optional[str], lock_attr: Optional[str],
                 check: bool, graph=None):
        self.lock_name = lock_name
        self.lock_attr = lock_attr
        self.check = check
        self._graph = graph
        self.name = "<unbound>"
        self.slot = "_guarded__<unbound>"

    def __set_name__(self, owner, name: str) -> None:
        self.name = f"{owner.__name__}.{name}"
        self.slot = f"_guarded__{name}"

    def _required_name(self, obj) -> Optional[str]:
        if self.lock_name is not None:
            return self.lock_name
        lock = getattr(obj, self.lock_attr, None)
        # a foreign primitive (not a _CheckedLock) has no name for the
        # held stack to carry, so there is nothing to verify
        return getattr(lock, "name", None)

    def _validate(self, obj, op: str) -> None:
        required = self._required_name(obj)
        if required is None:
            return
        graph = self._graph if self._graph is not None else GRAPH
        if required in graph._stack():
            return
        msg = (f"guarded field {self.name} {op} without holding "
               f"checked lock {required!r} (held: "
               f"{sorted(set(graph._stack()))})")
        with graph._mu:
            graph.violations.append(msg)
        raise GuardedFieldError(msg)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            value = obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None
        if self.check:
            self._validate(obj, "read")
        return value

    def __set__(self, obj, value) -> None:
        if self.check and self.slot in obj.__dict__:
            # first write (``__init__`` seeding, pre-publication) is
            # exempt; every re-bind afterwards needs the lock
            self._validate(obj, "write")
        obj.__dict__[self.slot] = value

    def __delete__(self, obj) -> None:
        if self.check:
            self._validate(obj, "delete")
        obj.__dict__.pop(self.slot, None)


def guarded_by(lock_name: Optional[str] = None, *,
               attr: Optional[str] = None, graph=None) -> _GuardedField:
    """Class-level annotation: ``_entries = guarded_by("cache.lock")``
    makes every read/write of ``self._entries`` (after the ``__init__``
    seed) fail fast unless the named :func:`checked_lock` is held by the
    current thread. ``guarded_by(attr="_lock")`` resolves the required
    name from the INSTANCE's lock instead — for classes whose lock name
    is a constructor parameter. Name-granular like the rest
    of the validator: two instances sharing a lock NAME satisfy each
    other's guard, which matches how the engine names its locks (one
    name per subsystem lock). No-op (plain storage) when the validator
    is disabled."""
    if (lock_name is None) == (attr is None):
        raise TypeError("guarded_by takes exactly one of a lock name "
                        "or attr=")
    return _GuardedField(lock_name, attr, check=ENABLED, graph=graph)
