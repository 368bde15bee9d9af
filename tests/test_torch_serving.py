"""The serving plane of presto_tpu_torch against presto_tpu: the plan
cache (``serving/plancache.py``) and the resource-group bridge
(``serving/groups.py``) with the fair scheduler's group shares, the
plan-cache and group cases of tests/test_serving.py. The statement
server's cases are in tests/test_torch_protocol.py, the fleet's in
tests/test_torch_fleet.py; the cluster's case (a statement server in
front of a ClusterRunner) is the last one here.

Each plan-cache case runs the same statements through both packages'
LocalRunners (TPC-H SF 0.001 as in the reference's file, SF 0.01 where
rows must differ between bindings) and holds the rows equal and the
cache counters' moves equal to the reference's (rows exactly: these
statements return integers)."""
import threading
import time

import pytest

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.obs.metrics import REGISTRY as JREG
from presto_tpu.serving.plancache import PlanCache as JPlanCache
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.serving.plancache import (
    PLANS, PlanCache, parse_cached,
)

COUNTERS = ("plan_cache_hit_total", "plan_cache_miss_total",
            "plan_cache_invalidated_total", "plan_cache_evicted_total")


def _snap(reg):
    vals = {m["name"]: float(m["value"]) for m in reg.snapshot()}
    return {c: vals.get(c, 0.0) for c in COUNTERS}


class Pair:
    """Both packages' runners; ``run`` executes one statement in each and
    returns (port rows, reference rows, port counter moves, reference
    counter moves)."""

    def __init__(self, sf=0.001):
        self.jax = JRunner(tpch_sf=sf)
        self.port = LocalRunner(tpch_sf=sf, device="cpu")

    def run(self, sql, **kw):
        j0, t0 = _snap(JREG), _snap(REGISTRY)
        want = self.jax.execute(sql, **kw).rows
        got = self.port.execute(sql, **kw).rows
        j1, t1 = _snap(JREG), _snap(REGISTRY)
        return (got, want, {c: t1[c] - t0[c] for c in COUNTERS},
                {c: j1[c] - j0[c] for c in COUNTERS})

    def check(self, sql, **kw):
        got, want, dt, dj = self.run(sql, **kw)
        assert [tuple(r) for r in got] == [tuple(r) for r in want]
        assert dt == dj, (sql, dt, dj)
        return got, dt


@pytest.fixture()
def pair():
    # both plan caches start empty: an entry of an earlier test whose
    # connector was collected would count as invalidated at the next
    # write in one package and not yet in the other
    from presto_tpu.serving.plancache import PLANS as JPLANS
    PLANS.clear()
    JPLANS.clear()
    return Pair()


# -- plan cache ---------------------------------------------------------------

def test_plan_cache_repeated_statement_hits(pair):
    sql = "select count(*) from nation where n_regionkey = 1"
    first, d1 = pair.check(sql)
    second, d2 = pair.check(sql)
    assert first == second
    assert d1["plan_cache_miss_total"] == 1
    assert d2["plan_cache_hit_total"] == 1


def test_plan_cache_execute_skips_replan(pair):
    pair.check("prepare dash from "
               "select count(*) from orders where o_totalprice > ?")
    a, _ = pair.check("execute dash using 1000")
    b, d = pair.check("execute dash using 1000")
    assert a == b
    # the second EXECUTE of identical arguments rides the cached plan
    assert d["plan_cache_hit_total"] == 1
    # different arguments are a different fingerprint: re-planned under
    # the new binding, never served the other binding's plan
    rows, d = pair.check("execute dash using 999999999")
    assert rows == [(0,)] and d["plan_cache_miss_total"] == 1


def test_plan_cache_invalidated_by_write(pair):
    pair.check("create table memory.t1 as select 1 as x")
    sql = "select count(*) from memory.t1"
    assert pair.check(sql)[0] == [(1,)]
    _, d = pair.check("insert into memory.t1 select 2")
    # the write invalidated the cached plan (eager hook) and the re-run
    # sees the new row: never a stale plan over stale stats
    assert d["plan_cache_invalidated_total"] >= 1
    assert pair.check(sql)[0] == [(2,)]


def test_plan_cache_property_sensitivity(pair):
    """A session-property overlay is part of the fingerprint: toggling
    an optimizer gate must not serve the other variant's plan."""
    sql = "select count(*) from lineitem where l_quantity > 20"
    base, _ = pair.check(sql)
    off, d = pair.check(sql, properties={"dense_grouping": False})
    assert base == off and d["plan_cache_miss_total"] == 1


def test_plan_cache_disabled_by_session_prop(pair):
    sql = "select count(*) from region"
    for _ in range(2):
        _, d = pair.check(sql, properties={"plan_cache": False})
        assert d["plan_cache_hit_total"] == d["plan_cache_miss_total"] == 0


def test_plan_cache_uncacheable_system_tables(pair):
    """system.runtime tables have no data version: never cached."""
    sql = "select count(*) from system.runtime.queries"
    pair.port.execute(sql)
    h0 = REGISTRY.counter("plan_cache_hit_total").value
    pair.port.execute(sql)
    assert REGISTRY.counter("plan_cache_hit_total").value == h0
    assert pair.port.session.catalogs.get("system").data_version(
        "queries") is None


def test_plan_cache_lru_eviction():
    """Capacity 2 holds the two newest of three dep-free plans, in both
    packages."""
    class _Plan:
        def __init__(self):
            self.root = type("N", (), {"children": ()})()
            self.init_plans = []

    class _Sess:
        class catalogs:
            @staticmethod
            def get(name):
                raise AssertionError("no scans, no deps")

    for cls in (PlanCache, JPlanCache):
        pc = cls(capacity=2)
        for i in range(3):
            # dep-free plans (no scans) cache unconditionally
            assert pc.put(bytes([i]), _Plan(), _Sess())
        assert len(pc) == 2
        assert pc.get(bytes([0])) is None      # oldest evicted
        assert pc.get(bytes([2])) is not None


def test_plan_cache_epoch_veto():
    """A write landing between epoch capture and put refuses the
    insert (the plan's stats may predate the write)."""
    class _Plan:
        root = type("N", (), {"children": ()})()
        init_plans = []

    for cls in (PlanCache, JPlanCache):
        pc = cls()
        epoch = pc.epoch()
        pc.note_write()
        assert not pc.put(b"k", _Plan(), None, epoch=epoch)
        assert pc.put(b"k", _Plan(), None, epoch=pc.epoch())


def test_fingerprints_separate_sessions_and_parse_cache_shares_text():
    """parse_cached returns one AST per text; the fingerprint folds the
    session's catalog, schema, properties and connector identities in,
    so two runners never share a plan."""
    sql = "select count(*) from nation"
    assert parse_cached(sql) is parse_cached(sql)
    a = LocalRunner(tpch_sf=0.001, device="cpu")
    b = LocalRunner(tpch_sf=0.001, device="cpu")
    stmt = parse_cached(sql)
    assert PlanCache.fingerprint(stmt, a.session) != \
        PlanCache.fingerprint(stmt, b.session)
    assert PlanCache.fingerprint(stmt, a.session) == \
        PlanCache.fingerprint(stmt, a.session)
    assert len(PLANS) <= PLANS.capacity


def test_distributed_runner_rides_the_plan_cache(monkeypatch):
    """DistributedRunner plans through parse_cached / cached_plan: a
    repeated statement is a plan-cache hit, with the same rows."""
    from presto_tpu_torch.exec.distributed import DistributedRunner
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "2")
    r = DistributedRunner(tpch_sf=0.001, device="cpu", n_devices=2)
    sql = "select n_regionkey, count(*) from nation group by 1 order by 1"
    first = r.execute(sql).rows
    h0 = REGISTRY.counter("plan_cache_hit_total").value
    assert r.execute(sql).rows == first
    assert REGISTRY.counter("plan_cache_hit_total").value == h0 + 1
    assert first == JRunner(tpch_sf=0.001).execute(sql).rows


# -- group-weighted fair device scheduling ------------------------------------

def test_group_weighted_quanta_ratio():
    """Under saturation a 2-weight group receives >= 1.5x the device
    quanta of a 1-weight group."""
    from presto_tpu_torch.exec.taskexec import DeviceScheduler

    sched = DeviceScheduler()
    stop = threading.Event()
    counts = {"heavy": 0, "light": 0}
    lock = threading.Lock()

    def worker(group: str, weight: int) -> None:
        h = sched.task(name=f"{group}-t", group=group, weight=weight)
        try:
            while not stop.is_set():
                sched.run_quantum(h, lambda: time.sleep(0.002))
                with lock:
                    counts[group] += 1
        finally:
            h.close()

    threads = [threading.Thread(target=worker, args=("heavy", 2)),
               threading.Thread(target=worker, args=("heavy", 2)),
               threading.Thread(target=worker, args=("light", 1)),
               threading.Thread(target=worker, args=("light", 1))]
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    assert counts["light"] > 0, counts
    assert counts["heavy"] / counts["light"] >= 1.5, counts
    shares = sched.group_shares()
    assert shares["heavy"]["device_seconds"] > \
        shares["light"]["device_seconds"]


def test_group_share_registry_bounded():
    """Idle shares beyond the cap evict."""
    from presto_tpu_torch.exec.taskexec import _MAX_SHARES, DeviceScheduler

    sched = DeviceScheduler()
    for i in range(_MAX_SHARES + 50):
        sched.task(name=f"t{i}", group=f"rg{i}/g").close()
    live = sched.task(name="live", group="keep/g")
    assert len(sched.group_shares()) <= _MAX_SHARES + 1
    assert "keep/g" in sched.group_shares()
    live.close()


def test_group_share_idle_return_clamp():
    """A group returning from idle competes from the active floor."""
    from presto_tpu_torch.exec.taskexec import DeviceScheduler

    sched = DeviceScheduler()
    a = sched.task(name="a", group="ga", weight=1)
    for _ in range(20):
        sched.run_quantum(a, lambda: time.sleep(0.001))
    b = sched.task(name="b", group="gb", weight=1)
    shares = sched.group_shares()
    assert shares["gb"]["vtime"] >= shares["ga"]["vtime"] * 0.99
    a.close()
    b.close()


# -- group memory accounting --------------------------------------------------

def _group_manager(pkg, **leaf):
    mod = __import__(f"{pkg}.server.resource_groups",
                     fromlist=["ResourceGroupManager"])
    return mod.ResourceGroupManager({
        "rootGroups": [{"name": "g", "hardConcurrencyLimit": 8,
                        "maxQueued": 100, **leaf}],
        "selectors": [{"group": "g"}]})


@pytest.mark.parametrize("pkg", ["presto_tpu_torch", "presto_tpu"])
def test_group_memory_charges_and_refunds(pkg):
    groups = __import__(f"{pkg}.serving.groups",
                        fromlist=["QueryServingContext"])
    m = _group_manager(pkg, softMemoryLimit=1000)
    adm = m.submit()
    ctx = groups.QueryServingContext(adm.group)
    ctx.charge(600)
    assert adm.group.memory_reserved == 600
    assert not adm.group.over_soft_memory()
    ctx.charge(600)
    assert adm.group.over_soft_memory()
    # over the soft limit the group queues new work
    adm2 = m.submit()
    assert not adm2.granted
    # refund wakes the dispatcher: the queued query is admitted
    ctx.close()
    assert adm.group.memory_reserved == 0
    assert adm2.granted
    adm2.release()
    adm.release()


@pytest.mark.parametrize("pkg", ["presto_tpu_torch", "presto_tpu"])
def test_group_hard_memory_limit_kills_requester(pkg):
    memory = __import__(f"{pkg}.memory", fromlist=["QueryMemoryPool"])
    groups = __import__(f"{pkg}.serving.groups",
                        fromlist=["QueryServingContext"])
    m = _group_manager(pkg, hardMemoryLimit=1 << 20)
    adm = m.submit()
    ctx = groups.QueryServingContext(adm.group)
    pool = memory.QueryMemoryPool(group=ctx)
    opctx = pool.context("op")
    pool.reserve(1 << 19, opctx)
    with pytest.raises(memory.MemoryLimitExceeded) as ei:
        pool.reserve(1 << 20, opctx)
    assert "resource group" in str(ei.value)
    # the failed reservation left both ledgers consistent
    assert pool.reserved == 1 << 19
    assert adm.group.memory_reserved == 1 << 19
    opctx.close()
    assert adm.group.memory_reserved == 0
    ctx.close()
    adm.release()


def test_admitted_query_bills_its_group():
    """A query run with a serving context registers its task under the
    group's scheduler share and returns its group memory to zero; the
    resource_groups table shows the group with its quanta."""
    from presto_tpu_torch.exec.taskexec import GLOBAL
    from presto_tpu_torch.serving.groups import QueryServingContext
    m = _group_manager("presto_tpu_torch")
    r = LocalRunner(tpch_sf=0.001, device="cpu")
    sql = ("select l_returnflag, count(*) from lineitem group by 1 "
           "order by 1")
    adm = m.submit()
    assert adm.wait(5)
    ctx = QueryServingContext(adm.group)
    try:
        rows = r.execute(sql, serving=ctx).rows
    finally:
        ctx.close()
        adm.release()
    assert rows == JRunner(tpch_sf=0.001).execute(sql).rows
    share = GLOBAL.group_shares()[f"{m.scope}/g"]
    assert share["quanta"] >= 1
    assert adm.group.memory_reserved == 0
    table = r.execute("select \"group\", running, quanta from "
                      "system.runtime.resource_groups").rows
    assert ("g", 0, share["quanta"]) in table


def test_serving_phase_rehearsed_on_the_cpu():
    """chip_smoke.py's serving phase on the CPU at SF 0.01: every check
    of the phase holds (plan-cache hits, the template fleet's 1 build, 7
    hits and 0 fallbacks then 1 fallback, a result-cache hit calling
    neither kernel, the partial hit reading only the appended files, the
    vetoed insert, the groups' rows and memory, the observability
    tables and the exposition), and both kernels' plain versions ran."""
    import importlib.util
    import pathlib

    import torch
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    launches = smoke.phase_serving(torch, None, device="cpu", sf=0.01,
                                   rows_per_batch=1 << 12)
    assert min(launches.values()) > 0, launches


def _metric(name: str) -> float:
    return float(REGISTRY.counter(name).value)


def test_cluster_runner_through_admission_and_plan_cache():
    """The statement server fronts a ClusterRunner with the same
    resource-group admission, serving handoff and plan cache that a
    LocalRunner gets: repeated statements skip parse/plan/optimize, the
    admitting group's slot frees on every exit path, and the query's
    quanta bill the group's scheduler share on the in-process workers;
    its rows equal the reference cluster's."""
    from presto_tpu.exec.cluster import ClusterRunner as JCluster
    from presto_tpu.server.worker import WorkerServer as JWorker
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.exec.taskexec import GLOBAL
    from presto_tpu_torch.server.protocol import (
        PrestoTpuServer, _runner_accepts_serving,
    )
    from presto_tpu_torch.server.worker import WorkerServer
    workers = [WorkerServer(tpch_sf=0.001, device="cpu") for _ in range(2)]
    jworkers = [JWorker(tpch_sf=0.001) for _ in range(2)]
    for w in workers + jworkers:
        w.start()
    runner = ClusterRunner([f"http://127.0.0.1:{w.port}" for w in workers],
                           tpch_sf=0.001, heartbeat=False, device="cpu")
    assert _runner_accepts_serving(runner)
    srv = PrestoTpuServer(runner=runner, resource_groups={
        "rootGroups": [{"name": "fleet", "hardConcurrencyLimit": 2,
                        "schedulingWeight": 3}],
        "selectors": [{"group": "fleet"}]})
    try:
        sql = ("select n_regionkey, count(*) c from nation "
               "group by n_regionkey order by n_regionkey")
        h0 = _metric("plan_cache_hit_total")
        q1 = srv.create_query(sql, {}, user="alice")
        q1.done.wait(timeout=60)
        assert q1.state == "FINISHED", q1.error
        q2 = srv.create_query(sql, {}, user="alice")
        q2.done.wait(timeout=60)
        assert q2.state == "FINISHED", q2.error
        assert _metric("plan_cache_hit_total") >= h0 + 1
        info = srv.resource_groups.info()[0]
        assert info["numRunning"] == 0 and info["numQueued"] == 0
        assert any(k.endswith("/fleet") for k in GLOBAL.group_shares()), \
            GLOBAL.group_shares().keys()
        q3 = srv.create_query(sql, {"retry_policy": "BOGUS"})
        q3.done.wait(timeout=60)
        assert q3.state == "FAILED"
        q4 = srv.create_query(sql, {"retry_policy": "NONE"})
        q4.done.wait(timeout=60)
        assert q4.state == "FINISHED", q4.error
        jrunner = JCluster([f"http://127.0.0.1:{w.port}" for w in jworkers],
                           tpch_sf=0.001, heartbeat=False)
        assert runner.execute(sql).rows == jrunner.execute(sql).rows
    finally:
        srv.stop()
        for w in workers + jworkers:
            try:
                w.stop()
            except Exception:
                pass
