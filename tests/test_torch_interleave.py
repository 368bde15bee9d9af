"""The deterministic interleaving explorer of presto_tpu_torch
(_devtools/interleave.py) against presto_tpu: the cases of
tests/test_interleave.py, on the port's explorer, checked locks and
serving caches.

Three layers:

- the explorer itself: exhaustive schedule enumeration, preemption
  bounding, seeded sampling, deadlock detection through checked locks,
  failpoint-site glue, guarded-field fail-fast; the same scenario
  explored by both packages' explorers takes the same schedules with
  the same outcomes;
- the two serving-cache races replayed as red/green pairs: the LIVE
  classes pass every schedule, and fixture-level copies with the fix
  mechanically reverted (a copied method minus the fix) fail
  deterministically:
    * the plan cache's write-epoch veto (a connector write landing
      between epoch capture and put must refuse the insert);
    * the result cache's partial-hit double-apply (concurrent partial
      hits must merge against their lookup-time snapshot and lose the
      re-stamp race);
- the plan cache's epoch window exercised END-TO-END through the real
  serving/plancache.cached_plan path, scheduled via the declared
  `plancache.plan` failpoint site.
"""
import threading
import types
import weakref
from collections import OrderedDict

import pytest

from presto_tpu_torch._devtools import interleave, lockcheck
from presto_tpu_torch._devtools.interleave import explore, point, sample
from presto_tpu_torch._devtools.lockcheck import (GuardedFieldError, LockGraph,
                                            checked_lock, guarded_by)


# -- explorer mechanics ------------------------------------------------------

def _lost_update_scenario():
    state = {"x": 0}

    def inc():
        v = state["x"]
        point("read")
        state["x"] = v + 1

    def check():
        return None if state["x"] == 2 else f"lost update: x={state['x']}"

    return [inc, inc], check


def test_explore_enumerates_all_schedules_and_finds_the_race():
    ex = explore(_lost_update_scenario)
    assert ex.exhausted
    # 2 threads x 2 segments each: C(4,2) = 6 interleavings
    assert len(ex.schedules) == 6
    assert len(ex.failures) == 4           # every overlapped schedule
    assert all("lost update" in s.error for s in ex.failures)


def test_explore_is_deterministic():
    a = explore(_lost_update_scenario)
    b = explore(_lost_update_scenario)
    assert [s.decisions for s in a.schedules] \
        == [s.decisions for s in b.schedules]
    assert [s.error for s in a.schedules] == [s.error for s in b.schedules]


def test_preemption_bound_prunes_but_keeps_a_failure():
    ex = explore(_lost_update_scenario, preemption_bound=1)
    assert len(ex.schedules) < 6
    assert ex.failures                     # the race needs 1 preemption


def test_sample_replays_bit_for_bit():
    a = sample(_lost_update_scenario, n=12, seed=7)
    b = sample(_lost_update_scenario, n=12, seed=7)
    assert [s.decisions for s in a.schedules] \
        == [s.decisions for s in b.schedules]
    assert sample(_lost_update_scenario, n=12, seed=8).schedules \
        != a.schedules


def test_max_schedules_reports_non_exhaustive():
    ex = explore(_lost_update_scenario, max_schedules=3)
    assert len(ex.schedules) == 3 and not ex.exhausted


def test_checked_lock_deadlock_is_a_finding_not_a_hang():
    def make():
        g = LockGraph()
        a, b = g.lock("IA"), g.lock("IB")

        def t1():
            with a:
                point("has-a")
                with b:
                    pass

        def t2():
            with b:
                point("has-b")
                with a:
                    pass

        return [t1, t2], None

    ex = explore(make)
    assert ex.deadlocks                     # AB/BA executed -> deadlock
    assert any("deadlock" in s.error for s in ex.failures)
    # well-ordered schedules (one thread finishes first) stay clean
    assert any(s.error is None for s in ex.schedules)


def test_locks_serialize_correctly_under_the_scheduler():
    # same increment race, but properly locked: every schedule clean
    def make():
        lk = checked_lock("interleave.serialize")
        state = {"x": 0}

        def inc():
            point("before")
            with lk:
                v = state["x"]
                state["x"] = v + 1

        def check():
            return None if state["x"] == 2 else f"x={state['x']}"

        return [inc, inc], check

    explore(make).assert_clean()


def test_failpoints_as_points_schedule_engine_sites():
    from presto_tpu_torch.exec.failpoints import FailpointRegistry
    reg = FailpointRegistry()               # synthetic sites allowed
    hits = []

    def make():
        log = []

        def worker():
            reg.hit("synthetic.window", key="w")
            log.append("worked")

        def other():
            log.append("other")

        def check():
            hits.append(tuple(log))
            return None

        return [worker, other], check

    with interleave.failpoints_as_points(["synthetic.window"],
                                         registry=reg):
        ex = explore(make)
    ex.assert_clean()
    # the failpoint became a real scheduling point: both orders ran
    assert {h for h in hits} >= {("worked", "other"),
                                 ("other", "worked")}


def test_point_is_noop_outside_exploration():
    point("nobody-listening")               # must not raise or block


# -- guarded fields ----------------------------------------------------------

def test_guarded_field_fails_fast_without_lock():
    g = LockGraph()

    class Box:
        data = guarded_by("box.lock", graph=g)

        def __init__(self):
            self._lock = g.lock("box.lock")
            self.data = {}                  # first write: init, exempt

    b = Box()
    with b._lock:
        b.data["k"] = 1                     # guarded read under lock: ok
        assert b.data["k"] == 1
    with pytest.raises(GuardedFieldError):
        _ = b.data                          # read without the lock
    with pytest.raises(GuardedFieldError):
        b.data = {}                         # re-bind without the lock
    assert any("guarded field" in v for v in g.check())


def test_guarded_field_attr_form_resolves_per_instance():
    g = LockGraph()

    class Cache:
        entries = guarded_by(attr="_lock", graph=g)

        def __init__(self, name):
            self._lock = g.lock(name)
            self.entries = OrderedDict()

    a, b = Cache("cache.a"), Cache("cache.b")
    with a._lock:
        assert a.entries == OrderedDict()   # a's name satisfies a
        with pytest.raises(GuardedFieldError):
            _ = b.entries                   # but not b

    with b._lock:
        assert b.entries == OrderedDict()


def test_engine_caches_are_guard_annotated():
    from presto_tpu_torch.exec.scancache import ScanCache
    from presto_tpu_torch.serving.plancache import IdentMemo, PlanCache
    from presto_tpu_torch.serving.resultcache import ResultCache
    for cls, fields in ((PlanCache, ("_entries", "_epoch")),
                        (ResultCache, ("_entries", "_epoch")),
                        (IdentMemo, ("_entries",)),
                        (ScanCache, ("_entries", "_inflight"))):
        for f in fields:
            d = getattr(cls, f)
            assert type(d).__name__ == "_GuardedField", (cls, f)
            assert d.check is lockcheck.ENABLED


def test_engine_cache_guard_trips_on_unlocked_poke():
    from presto_tpu_torch.serving.plancache import PlanCache
    c = PlanCache(lock_name="interleave.guardprobe")
    assert len(c) == 0                      # locked paths work
    with pytest.raises(GuardedFieldError):
        _ = c._entries                      # unlocked direct poke fails
    # scrub the recorded violation: it was deliberate, and the serving
    # suites assert a clean process graph
    with lockcheck.GRAPH._mu:
        lockcheck.GRAPH.violations[:] = [
            v for v in lockcheck.GRAPH.violations
            if "interleave.guardprobe" not in v]


# -- plan-cache write-epoch race (fixture-level revert) ---------------------

class _FakeConn:
    """data_version-bearing stand-in: bump() is 'a write landed'."""

    def __init__(self):
        self._v = 0

    def data_version(self, table):
        return self._v

    def bump(self):
        self._v += 1


def _mk_plan_caches():
    from presto_tpu_torch.serving.plancache import PlanCache, _Entry

    class _Harness(PlanCache):
        """Real PlanCache over the fake connector's dep stamps."""

        def __init__(self, conn):
            super().__init__(lock_name="interleave.plancache")
            self._conn = conn

        def _plan_deps(self, plan, session):
            return [(weakref.ref(self._conn), "c", "t",
                     self._conn.data_version("t"))]

    class _NoVeto(_Harness):
        """The epoch veto mechanically reverted: a fixture-level copy of
        PlanCache.put WITHOUT the epoch comparison (the pre-fix code
        shape — deps stamped post-plan validate a stale plan)."""

        def put(self, key, plan, session, epoch=None, payload=None):
            deps = self._plan_deps(plan, session)
            if deps is None:
                return False
            with self._lock:
                # (reverted) if epoch is not None and epoch != self._epoch:
                #     return False
                if key in self._entries:
                    return True
                self._entries[key] = _Entry(
                    payload if payload is not None else plan, deps)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                return True

    return _Harness, _NoVeto


def _plan_epoch_scenario(cache_cls):
    """One planner capturing its epoch then 'optimizing' (reading the
    connector's stats version) then inserting; one writer bumping the
    version mid-air. Invariant: a SERVED plan was never built against
    a version older than the data."""
    def make():
        conn = _FakeConn()
        cache = cache_cls(conn)
        key = b"q1"

        def planner():
            epoch = cache.epoch()
            point("epoch-captured")
            built_against = conn.data_version("t")   # optimizer stats
            point("planned")
            cache.put(key, {"built": built_against}, session=None,
                      epoch=epoch)

        def writer():
            point("about-to-write")
            conn.bump()
            cache.note_write()
            cache.invalidate(conn, "t")

        def check():
            served = cache.get(key)
            now = conn.data_version("t")
            if served is not None and served["built"] != now:
                return (f"stale plan served: built against "
                        f"v{served['built']}, data at v{now}")
            return None

        return [planner, writer], check

    return make


def test_plan_cache_epoch_veto_green_on_live_class():
    harness, _noveto = _mk_plan_caches()
    ex = explore(_plan_epoch_scenario(harness))
    assert ex.exhausted
    ex.assert_clean()


def test_plan_cache_epoch_race_red_when_fix_reverted():
    _harness, noveto = _mk_plan_caches()
    ex = explore(_plan_epoch_scenario(noveto))
    assert ex.failures, "reverting the epoch veto must reproduce the race"
    assert any("stale plan served" in s.error for s in ex.failures)
    # and the exact interleaving is the documented one: write lands
    # between epoch capture and put
    bad = ex.failures[0]
    labels = [lbl for _i, lbl in bad.trace]
    assert "planned" in labels and "about-to-write" in labels


# -- result-cache partial-hit double-apply (fixture-level revert) -----------

def _mk_result_caches():
    from presto_tpu_torch.serving import resultcache as RC

    class _Fixed(RC.ResultCache):
        pass

    class _NoSnapshot(RC.ResultCache):
        """The snapshot fix mechanically reverted: update() is a fixture-level
        copy WITHOUT the base_deps compare, so a merge computed against
        a superseded base can re-stamp over a newer state."""

        def update(self, ph, result, subplan_rows):
            size = (RC._rows_bytes(result.rows)
                    + RC._rows_bytes(subplan_rows) + 1024)
            with self._lock:
                if ph.epoch != self._epoch:
                    return False
                e = self._entries.get(ph.key)
                if e is not ph.entry:
                    return False
                # (reverted) if e.deps != ph.base_deps: return False
                if size > self.pool.limit:
                    del self._entries[ph.key]
                    e.ctx.close()
                    return False
                e.rows = list(result.rows)
                e.subplan_rows = subplan_rows
                e.deps = list(ph.fresh_deps)
                self._account_locked(e, size)
                return True

    return _Fixed, _NoSnapshot


class _FileConn:
    """filebase-shaped version tokens: (seq, ((relpath, mtime), ...))."""

    def __init__(self):
        self.files = {"a.csv": 1.0}

    def data_version(self, table):
        return (0, tuple(sorted(self.files.items())))

    def add_file(self, name):
        self.files[name] = 2.0


def _res(rows):
    return types.SimpleNamespace(rows=rows, names=["g", "s"],
                                 types=["varchar", "bigint"])


def _partial_scenario(cache_cls, snapshot_base):
    """Two readers resolve a partial hit on one entry (base sum 10,
    append-only delta +5) and race the delta merge + re-stamp.
    ``snapshot_base=False`` additionally reverts the lookup-time
    snapshot (the second half of the fix): the merge reads the
    LIVE entry rows at merge time. Invariant: the entry must end at
    15, never 20 (delta applied twice)."""
    from presto_tpu_torch.serving import resultcache as RC

    def make():
        conn = _FileConn()
        rc = cache_cls()
        key = b"standing-query"
        spec = RC.IncrementalSpec(agg=None, dep_index=0, catalog="c",
                                  table="t", n_keys=1,
                                  agg_cols=((1, "sum"),))
        deps = [(weakref.ref(conn), "c", "t",
                 RC._freeze(conn.data_version("t")))]
        assert rc.put(key, _res([("g", 10)]), deps, rc.epoch(),
                      subplan_rows=[("g", 10)], spec=spec, plan=None)
        conn.add_file("b.csv")              # append-only drift: +5

        def reader():
            outcome, ph = rc.get(key)
            if outcome != "partial":
                return                      # lost the re-stamp race
            point("looked-up")
            base = (ph.base_subplan if snapshot_base
                    else ph.entry.subplan_rows)
            merged = RC.merge_subplan_rows(ph.spec, base, [("g", 5)])
            point("merged")
            rc.update(ph, _res(merged), merged)

        def check():
            # the closure keeps `conn` alive: entry deps are weakrefs,
            # and a collected connector reads as a dead dep (= miss)
            assert conn.files
            outcome, e = rc.get(key)
            if outcome != "hit":
                return f"entry lost: {outcome}"
            if list(e.rows) != [("g", 15)]:
                return (f"delta double-applied: {list(e.rows)} "
                        f"(base 10 + one delta of 5 must be 15)")
            return None

        return [reader, reader], check

    return make


def test_result_cache_partial_green_on_live_class():
    fixed, _nosnap = _mk_result_caches()
    ex = explore(_partial_scenario(fixed, snapshot_base=True))
    assert ex.exhausted
    ex.assert_clean()


def test_result_cache_double_apply_red_when_fix_reverted():
    _fixed, nosnap = _mk_result_caches()
    ex = explore(_partial_scenario(nosnap, snapshot_base=False))
    assert ex.failures, \
        "reverting the base-snapshot fix must reproduce the race"
    assert any("double-applied" in s.error for s in ex.failures)


# -- the epoch window end-to-end through the real cached_plan path ----------

@pytest.fixture(scope="module")
def plan_runner():
    from presto_tpu_torch.exec.runner import LocalRunner
    r = LocalRunner(tpch_sf=0.01, device="cpu")
    r.execute("create table memory.ilv as select 1 as x")
    return r


def test_engine_cached_plan_epoch_window_via_failpoint(plan_runner):
    """The declared `plancache.plan` failpoint site turns the REAL
    cached_plan epoch window into a scheduling point: a memory-table
    write landing inside it must veto the insert (entry absent), a
    write before it must not stop caching, and a write after it must
    eagerly invalidate — all three interleavings, one exploration."""
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    from presto_tpu_torch.serving.plancache import (PLANS, PlanCache,
                                              parse_cached)
    r = plan_runner
    conn = r.session.catalogs.get("memory")
    sql = "select count(*) from memory.ilv"
    stmt = parse_cached(sql)
    key = PlanCache.fingerprint(stmt, r.session)
    holder = {}

    FAILPOINTS.configure(
        "plancache.plan", action="callback", times=None,
        callback=lambda key="", **kw: (holder["log"].append("window"),
                                       point("plancache.plan")))
    try:
        def make():
            from presto_tpu_torch.serving.plancache import cached_plan
            PLANS.clear()
            log = holder["log"] = []

            def planner():
                plan = cached_plan(stmt, r.session)
                assert plan is not None     # veto never loses the query

            def writer():
                conn.append("ilv", conn.tables["ilv"][0])
                log.append("wrote")

            def check():
                cached = PLANS.get(key) is not None
                if "window" not in log:
                    return "warm hit: the per-run clear() didn't miss"
                if log.index("wrote") < log.index("window"):
                    # write fully preceded the epoch capture: the
                    # insert is clean and must have landed
                    return None if cached else \
                        "clean insert refused (veto misfired)"
                # write landed mid-window (veto) or after the insert
                # (eager invalidation): either way the entry must be
                # gone — a cached entry here is the TOCTOU
                return ("stale plan cached despite a post-epoch write"
                        if cached else None)

            return [planner, writer], check

        ex = explore(make, max_schedules=16)
        ex.assert_clean()
        assert ex.exhausted
    finally:
        FAILPOINTS.clear("plancache.plan")


# -- the process lock graph stayed clean through all of the above ------------

def test_interleave_suite_leaves_lock_graph_clean():
    assert lockcheck.GRAPH.check() == [], lockcheck.GRAPH.check()


# -- the port's explorer against the reference's ----------------------------

def _counter_scenario(interleave_mod):
    """The lost-update race over the given package's ``point``."""
    def make():
        state = {"x": 0}

        def inc():
            v = state["x"]
            interleave_mod.point("read")
            state["x"] = v + 1

        def check():
            return None if state["x"] == 2 else f"lost update: x={state['x']}"

        return [inc, inc], check
    return make


@pytest.mark.parametrize("how", ["explore", "bounded", "sample"])
def test_explorer_schedules_equal_reference(how):
    """Both packages' explorers take the same schedules, with the same
    traces and the same outcomes, for one scenario."""
    from presto_tpu._devtools import interleave as jinterleave
    runs = []
    for mod in (interleave, jinterleave):
        make = _counter_scenario(mod)
        if how == "explore":
            ex = mod.explore(make)
        elif how == "bounded":
            ex = mod.explore(make, preemption_bound=1)
        else:
            ex = mod.sample(make, n=10, seed=3)
        runs.append([(s.decisions, s.trace, s.error, s.deadlocked)
                     for s in ex.schedules] + [ex.exhausted])
    assert runs[0] == runs[1]
