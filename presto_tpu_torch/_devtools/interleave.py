"""Deterministic interleaving explorer (the dynamic half of the
concurrency verification plane).

The counterpart of ``presto_tpu/_devtools/interleave.py``. The serving
caches' races (a stale scan-cache insert, the plan cache's write-epoch
veto, the result cache's partial-hit double-apply) are each a specific
interleaving of a handful of steps, which plain threaded tests sample
ONE schedule of per run. This module turns those races into pinned
red/green tests by running a scenario's threads under a cooperative
scheduler that serializes them onto one runnable-at-a-time schedule and
then systematically enumerates the schedules (CHESS-style stateless
search: bounded, optionally preemption-bounded, or seeded random
sampling past the bound).

How a scenario yields control:

- **explicit points** — scenario code calls :func:`point` (module
  level; a no-op for threads no active exploration owns, so the same
  call is safe in helpers shared with normal tests);
- **failpoint sites** — :func:`failpoints_as_points` arms ``callback``
  rules on declared engine sites (``plancache.plan``,
  ``resultcache.stamp``, ``resultcache.partial``, ...) that forward to
  :func:`point`, so REAL engine paths become schedulable without
  monkeypatching;
- **checked locks** — while an exploration is active, registered
  threads' ``checked_lock`` acquires route through the scheduler
  (lockcheck's scheduler hook): an acquire that would block marks the
  thread BLOCKED instead of deadlocking the exploration, and a state
  where every live thread is blocked is reported as a **deadlock
  finding** rather than a hang. Lock acquisition is deliberately NOT a
  scheduling point — schedules branch only at explicit points, keeping
  the search space proportional to the scenario, not to the engine's
  lock traffic.

Only one scenario thread ever runs at a time, so each segment between
points executes atomically and a schedule (a decision list) replays
bit-for-bit — the determinism contract that lets a failing interleaving
be committed as a regression test.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import lockcheck

__all__ = ["Exploration", "Interleaver", "Schedule", "explore",
           "failpoints_as_points", "point", "sample"]

#: the interleaver currently driving threads (explorations are serial)
_ACTIVE: Optional["Interleaver"] = None

_NEW, _READY, _RUNNING, _BLOCKED, _DONE = range(5)


class _Abort(BaseException):
    """Raised inside a scenario thread to unwind it when the
    exploration is torn down (deadlock or hang) — BaseException so
    scenario ``except Exception`` blocks can't swallow it."""


class _TState:
    __slots__ = ("index", "sem", "state", "label", "blocked_on",
                 "error", "thread")

    def __init__(self, index: int):
        self.index = index
        self.sem = threading.Semaphore(0)
        self.state = _NEW
        self.label = "start"
        self.blocked_on: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class Interleaver:
    """One schedule's cooperative scheduler. ``decisions`` replays a
    prefix (each entry is a POSITION in that step's sorted runnable
    set); steps past the prefix pick position 0, or a seeded-random
    position when ``rng`` is given. :meth:`run` drives the threads to
    completion and leaves the evidence on the instance (``trace``,
    ``choices``, ``deadlocked``, per-thread errors)."""

    def __init__(self, decisions: Optional[Sequence[int]] = None,
                 rng: Optional[random.Random] = None,
                 step_timeout: float = 20.0):
        self._decisions = list(decisions or [])
        self._rng = rng
        self._step_timeout = step_timeout
        self._threads: List[_TState] = []
        self._by_ident: Dict[int, _TState] = {}
        self._ctl = threading.Semaphore(0)
        self._mu = threading.Lock()
        self._aborted = False
        #: (thread_index, label) per observed event
        self.trace: List[Tuple[int, str]] = []
        #: (chosen_pos, runnable thread indices, prev thread index)
        self.choices: List[Tuple[int, Tuple[int, ...], int]] = []
        #: positions actually taken (prefix + defaults/rng)
        self.decisions_taken: List[int] = []
        self.deadlocked = False
        self.hung = False

    # -- thread side ----------------------------------------------------------
    def _me(self) -> Optional[_TState]:
        return self._by_ident.get(threading.get_ident())

    def owns_current_thread(self) -> bool:
        return threading.get_ident() in self._by_ident

    def point(self, label: str) -> None:
        st = self._me()
        if st is None or self._aborted:
            return
        with self._mu:
            st.state = _READY
            st.label = label
        self._ctl.release()
        st.sem.acquire()
        if self._aborted:
            raise _Abort()

    def checked_acquire(self, inner, name: str) -> bool:
        """lockcheck hook: blocking acquire of a checked lock's inner
        primitive by a registered thread. Not a scheduling point — but
        a failed probe parks the thread as BLOCKED so the controller
        can schedule someone else (or call deadlock)."""
        st = self._me()
        if st is None:
            return inner.acquire()
        while True:
            if inner.acquire(False):
                return True
            if self._aborted:
                raise _Abort()
            with self._mu:
                st.state = _BLOCKED
                st.blocked_on = name
                self.trace.append((st.index, f"blocked:{name}"))
            self._ctl.release()
            st.sem.acquire()
            if self._aborted:
                raise _Abort()

    def lock_released(self, name: str) -> None:
        """lockcheck hook: any release of a checked lock makes threads
        blocked on that name probe-worthy again."""
        with self._mu:
            for st in self._threads:
                if st.state == _BLOCKED and st.blocked_on == name:
                    st.state = _READY
                    st.blocked_on = None

    # -- controller -----------------------------------------------------------
    def _wrap(self, st: _TState, fn: Callable[[], None]) -> None:
        self._by_ident[threading.get_ident()] = st
        st.sem.acquire()
        try:
            if not self._aborted:
                fn()
        except _Abort:
            pass
        except BaseException as e:          # noqa: BLE001 — reported
            st.error = e
        finally:
            with self._mu:
                st.state = _DONE
            self._ctl.release()

    def run(self, fns: Sequence[Callable[[], None]]) -> None:
        global _ACTIVE
        if not fns:
            return
        self._threads = [_TState(i) for i in range(len(fns))]
        _ACTIVE = self
        lockcheck.set_scheduler(self)
        try:
            for st, fn in zip(self._threads, fns):
                st.thread = threading.Thread(
                    target=self._wrap, args=(st, fn), daemon=True)
                st.thread.start()
            # wait until every wrapper registered (first thing it does
            # is park on its semaphore, so no event is needed beyond
            # ident-map size)
            deadline = time.monotonic() + 10.0
            while len(self._by_ident) < len(fns) \
                    and time.monotonic() < deadline:
                time.sleep(0.0005)
            for st in self._threads:
                if st.state == _NEW:
                    st.state = _READY
            self._loop()
        finally:
            lockcheck.set_scheduler(None)
            _ACTIVE = None
            if self._aborted:
                for st in self._threads:
                    st.sem.release()
            for st in self._threads:
                if st.thread is not None:
                    st.thread.join(timeout=5.0)

    def _abort(self) -> None:
        self._aborted = True
        for st in self._threads:
            st.sem.release()

    def _loop(self) -> None:
        prev = -1
        step = 0
        while True:
            with self._mu:
                if all(st.state == _DONE for st in self._threads):
                    return
                runnable = tuple(st.index for st in self._threads
                                 if st.state == _READY)
                live = [st for st in self._threads
                        if st.state != _DONE]
            if not runnable:
                # every live thread is blocked on a lock: a REAL
                # deadlock this schedule executed — report, abort
                self.deadlocked = all(st.state == _BLOCKED
                                      for st in live)
                self._abort()
                return
            if step < len(self._decisions):
                pos = self._decisions[step]
                if pos >= len(runnable):
                    pos = len(runnable) - 1
            elif self._rng is not None:
                pos = self._rng.randrange(len(runnable))
            else:
                pos = 0
            chosen = self._threads[runnable[pos]]
            self.choices.append((pos, runnable, prev))
            self.decisions_taken.append(pos)
            self.trace.append((chosen.index, chosen.label))
            with self._mu:
                chosen.state = _RUNNING
            chosen.sem.release()
            if not self._ctl.acquire(timeout=self._step_timeout):
                # a scenario segment hung (blocked on something the
                # scheduler can't see): fail the schedule loudly
                self.hung = True
                self._abort()
                return
            prev = chosen.index
            step += 1

    # -- results --------------------------------------------------------------
    def errors(self) -> List[BaseException]:
        return [st.error for st in self._threads
                if st.error is not None]


def point(label: str) -> None:
    """Yield control to the active exploration's scheduler; a no-op on
    threads no exploration owns (production, plain tests)."""
    sched = _ACTIVE
    if sched is not None:
        sched.point(label)


@contextlib.contextmanager
def failpoints_as_points(sites: Sequence[str], registry=None):
    """Arm ``callback`` rules on the given declared failpoint sites
    that forward each hit into :func:`point` — the bridge that makes
    real engine seams (serving-cache epoch windows, scan decode, spool
    I/O) schedulable without touching engine code."""
    from ..exec.failpoints import FAILPOINTS
    reg = registry if registry is not None else FAILPOINTS

    def _cb(site):
        def cb(key: str = "", **_ctx):
            point(site)
        return cb

    for s in sites:
        reg.configure(s, action="callback", times=None, callback=_cb(s))
    try:
        yield
    finally:
        for s in sites:
            reg.clear(s)


# -- systematic exploration ---------------------------------------------------

@dataclasses.dataclass
class Schedule:
    """One executed schedule: its decision list, the event trace, and
    what went wrong (None = clean)."""
    decisions: List[int]
    trace: List[Tuple[int, str]]
    choices: List[Tuple[int, Tuple[int, ...], int]]
    error: Optional[str]
    deadlocked: bool = False

    def describe(self) -> str:
        steps = " -> ".join(f"T{i}:{lbl}" for i, lbl in self.trace)
        return f"[{','.join(map(str, self.decisions))}] {steps}"


@dataclasses.dataclass
class Exploration:
    """Every schedule an :func:`explore`/:func:`sample` run executed.
    ``exhausted`` is True when the bounded DFS enumerated the whole
    (preemption-bounded) schedule space."""
    schedules: List[Schedule]
    exhausted: bool = True

    @property
    def failures(self) -> List[Schedule]:
        return [s for s in self.schedules if s.error is not None]

    @property
    def deadlocks(self) -> List[Schedule]:
        return [s for s in self.schedules if s.deadlocked]

    def assert_clean(self) -> None:
        if self.failures:
            raise AssertionError(
                f"{len(self.failures)}/{len(self.schedules)} "
                f"schedule(s) failed; first: "
                f"{self.failures[0].error} at "
                f"{self.failures[0].describe()}")


def _run_one(make_scenario, decisions: Sequence[int],
             rng: Optional[random.Random] = None,
             step_timeout: float = 20.0) -> Schedule:
    threads, check = _scenario(make_scenario)
    sch = Interleaver(decisions=decisions, rng=rng,
                      step_timeout=step_timeout)
    sch.run(threads)
    error: Optional[str] = None
    if sch.deadlocked:
        error = "deadlock: every live thread blocked on a checked lock"
    elif sch.hung:
        error = "hang: a scenario segment never returned to the scheduler"
    else:
        errs = sch.errors()
        if errs:
            error = f"thread raised {errs[0]!r}"
        elif check is not None:
            error = check()
    return Schedule(decisions=list(sch.decisions_taken),
                    trace=list(sch.trace), choices=list(sch.choices),
                    error=error, deadlocked=sch.deadlocked)


def _scenario(make_scenario):
    made = make_scenario()
    if isinstance(made, tuple):
        threads, check = made
    else:
        threads, check = made, None
    return list(threads), check


def _preemptions(choices, decisions: List[int]) -> int:
    """Preemption count of a decision list against the recorded
    runnable sets: choosing a thread other than the previous one while
    the previous one was still runnable."""
    count = 0
    for pos, (_recorded, runnable, prev) in zip(decisions, choices):
        chosen = runnable[min(pos, len(runnable) - 1)]
        if prev >= 0 and prev in runnable and chosen != prev:
            count += 1
    return count


def explore(make_scenario, max_schedules: int = 256,
            preemption_bound: Optional[int] = None,
            step_timeout: float = 20.0) -> Exploration:
    """Bounded exhaustive DFS over the scenario's schedules.

    ``make_scenario()`` returns ``(thread_fns, check)`` — fresh state
    per call (each schedule is a fresh run); ``check()`` runs after all
    threads finish and returns an error string or None. Every schedule
    executed exactly once: a run with prefix P branches only at steps
    past ``len(P)``, pushing one new prefix per unexplored alternative
    (deepest-first). ``preemption_bound`` prunes prefixes whose forced
    context switches exceed the bound — the CHESS result that most
    races need very few."""
    stack: List[List[int]] = [[]]
    schedules: List[Schedule] = []
    while stack:
        if len(schedules) >= max_schedules:
            return Exploration(schedules, exhausted=False)
        prefix = stack.pop()
        sched = _run_one(make_scenario, prefix,
                         step_timeout=step_timeout)
        schedules.append(sched)
        for i in range(len(sched.choices) - 1, len(prefix) - 1, -1):
            chosen_pos, runnable, _prev = sched.choices[i]
            for alt in range(len(runnable)):
                if alt == sched.decisions[i]:
                    continue
                cand = sched.decisions[:i] + [alt]
                if preemption_bound is not None and _preemptions(
                        sched.choices, cand) > preemption_bound:
                    continue
                stack.append(cand)
    return Exploration(schedules, exhausted=True)


def sample(make_scenario, n: int = 64, seed: int = 0,
           step_timeout: float = 20.0) -> Exploration:
    """Seeded random sampling for scenarios whose exhaustive space is
    out of reach: ``n`` schedules drawn by one ``random.Random(seed)``
    — replayable bit-for-bit, like the failpoint registry's
    probabilistic rules."""
    rng = random.Random(seed)
    schedules = [_run_one(make_scenario, [], rng=rng,
                          step_timeout=step_timeout)
                 for _ in range(n)]
    return Exploration(schedules, exhausted=False)
