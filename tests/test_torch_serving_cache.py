"""Plan templates and the versioned result cache of presto_tpu_torch
(``serving/template.py``, ``serving/resultcache.py``) against
presto_tpu: the cases of tests/test_serving_cache.py up to its statement
server case (in tests/test_torch_protocol.py), and its cluster case on
both packages' ClusterRunners.

Each case runs the same statements through both packages' LocalRunners
over the same catalogs (TPC-H SF 0.01, a memory catalog, an ORC catalog
in a temporary directory, SQLite) and holds the rows equal (integers,
decimals and strings exactly, doubles within rel 1e-12: both packages
run the same plans over the same splits) and the template and result
cache counters' moves equal to the reference's."""
import dataclasses
import os
import tempfile

import pytest

from presto_tpu.connectors.memory import MemoryConnector as JMemory
from presto_tpu.connectors.orc import OrcConnector as JOrc
from presto_tpu.connectors.spi import CatalogManager as JCatalogs
from presto_tpu.connectors.sqlite import SqliteConnector as JSqlite
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.obs.metrics import REGISTRY as JREG
from presto_tpu.serving import resultcache as JRC
from presto_tpu.serving.template import parameterize as jparameterize
from presto_tpu.sql.parser import parse_statement as jparse
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.orc import OrcConnector
from presto_tpu_torch.connectors.spi import CatalogManager
from presto_tpu_torch.connectors.sqlite import SqliteConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.serving import resultcache as RC
from presto_tpu_torch.serving.plancache import bound_fingerprint, parse_cached
from presto_tpu_torch.serving.template import TEMPLATES, parameterize

from torch_parity import assert_rows_match

SF = 0.01
REL = 1e-12
TPROPS = {"plan_template_cache": True}
RPROPS = {"result_cache": True}
COUNTERS = tuple(
    f"{fam}_{k}_total" for fam, ks in (
        ("plan_template_cache", ("hit", "miss", "guard_fallback")),
        ("result_cache", ("hit", "miss", "partial", "invalidated",
                          "evicted")))
    for k in ks)


def _snap(reg):
    vals = {m["name"]: float(m["value"]) for m in reg.snapshot()}
    return {c: vals.get(c, 0.0) for c in COUNTERS}


class Pair:
    """Both packages' runners over the same catalogs; ``check`` runs a
    statement in each, holds the rows equal and returns the port's
    rows and counter moves after holding them equal to the
    reference's."""

    def __init__(self, files: bool = False):
        if not files:
            self.jax = JRunner(tpch_sf=SF)
            self.port = LocalRunner(tpch_sf=SF, device="cpu")
            return
        jcats, cats = JCatalogs(), CatalogManager()
        jcats.register("tpch", JTpch(sf=SF))
        cats.register("tpch", TpchConnector(sf=SF))
        jcats.register("memory", JMemory())
        cats.register("memory", MemoryConnector())
        jcats.register("orc", JOrc(tempfile.mkdtemp()))
        cats.register("orc", OrcConnector(tempfile.mkdtemp()))
        self.jax = JRunner(catalogs=jcats, catalog="tpch")
        self.port = LocalRunner(catalogs=cats, catalog="tpch", device="cpu")

    def check(self, sql, **kw):
        j0, t0 = _snap(JREG), _snap(REGISTRY)
        want = self.jax.execute(sql, **kw).rows
        j1 = _snap(JREG)
        got = self.port.execute(sql, **kw).rows
        t1 = _snap(REGISTRY)
        assert_rows_match(got, want, REL)
        dt = {c: t1[c] - t0[c] for c in COUNTERS}
        dj = {c: j1[c] - j0[c] for c in COUNTERS}
        assert dt == dj, (sql, dt, dj)
        return got, dt


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture()
def files():
    # both result caches start empty: an entry of an earlier case whose
    # connector was collected would count as invalidated at the next
    # write in one package and not yet in the other
    RC.RESULTS.clear()
    JRC.RESULTS.clear()
    return Pair(files=True)


# -- plan templates -----------------------------------------------------------

def test_template_parity_across_bindings(pair):
    """The same statement shape with different literals returns the
    same rows under the template cache, N bindings from ONE plan."""
    sqls = ["select count(*), sum(l_extendedprice) from lineitem "
            f"where l_quantity > {q}" for q in (10, 20, 30)]
    cold = [pair.check(s)[0] for s in sqls]
    moves = [pair.check(s, properties=TPROPS) for s in sqls]
    assert [m[0] for m in moves] == cold
    assert sum(m[1]["plan_template_cache_miss_total"] for m in moves) == 1
    assert sum(m[1]["plan_template_cache_hit_total"] for m in moves) == 2


def test_template_hits_share_one_plan(pair):
    """A template hit returns the one cached plan object (the port has
    no compile cache to share; what the fleet shares is the plan)."""
    from presto_tpu_torch.serving.template import template_plan
    r = pair.port
    sql = ("select l_returnflag, count(*) from lineitem "
           "where l_discount between 0.0%d and 0.08 "
           "group by l_returnflag order by l_returnflag")
    cold = [pair.check(sql % d)[0] for d in (1, 2, 3)]
    warm = [pair.check(sql % d, properties=TPROPS)[0] for d in (1, 2, 3)]
    assert warm == cold
    session = dataclasses.replace(
        r.session, properties={**r.session.properties, **TPROPS})
    plans = [template_plan(parse_cached(sql % d), session)
             for d in (1, 2, 3)]
    assert plans[1][0] is plans[0][0] and plans[2][0] is plans[0][0]
    from decimal import Decimal
    assert [p[1] for p in plans] == [
        {0: Decimal(f"0.0{d}"), 1: Decimal("0.08")} for d in (1, 2, 3)]


def test_execute_fleet_parity(pair):
    """EXECUTE with different bindings rides one template."""
    pair.check("prepare fleet_q from select count(*) from lineitem "
               "where l_quantity > ?")
    got = [pair.check(f"execute fleet_q using {q}", properties=TPROPS)
           for q in (5, 15, 25)]
    want = [pair.check(
        f"select count(*) from lineitem where l_quantity > {q}")[0]
        for q in (5, 15, 25)]
    assert [g[0] for g in got] == want
    assert sum(g[1]["plan_template_cache_hit_total"] for g in got) >= 2


def test_guard_fallback_on_flipped_pushdown_literal(pair):
    """A DATE range literal feeds scan-pushdown bounds: the template
    records an equality guard, a binding that flips it falls back to
    the per-binding fingerprint, with the right rows either way."""
    s1 = ("select count(*) from lineitem "
          "where l_shipdate <= date '1998-09-02'")
    s2 = ("select count(*) from lineitem "
          "where l_shipdate <= date '1997-09-02'")
    c1, c2 = pair.check(s1)[0], pair.check(s2)[0]
    assert pair.check(s1, properties=TPROPS)[0] == c1
    rows, d = pair.check(s1, properties=TPROPS)
    assert rows == c1 and d["plan_template_cache_guard_fallback_total"] == 0
    rows, d = pair.check(s2, properties=TPROPS)
    assert rows == c2 and d["plan_template_cache_guard_fallback_total"] == 1


def test_template_plans_keep_pushdown_quality(pair):
    """The guarded consult keeps literal-derived scan pushdown on the
    template plan, as in the reference."""
    from presto_tpu.planner.optimizer import optimize as joptimize
    from presto_tpu.planner.planner import plan_query as jplan_query
    from presto_tpu_torch.planner.optimizer import optimize
    from presto_tpu_torch.planner.plan import TableScanNode
    from presto_tpu_torch.planner.planner import plan_query
    sql = "select count(*) from lineitem where l_shipdate <= date '1998-09-02'"
    _t, marked, values = parameterize(parse_cached(sql))
    assert values
    plan = optimize(plan_query(marked, pair.port.session),
                    pair.port.session)
    _jt, jmarked, _ = jparameterize(jparse(sql))
    jplan = joptimize(jplan_query(jmarked, pair.jax.session),
                      pair.jax.session)

    def scans(n):
        if hasattr(n, "pushdown") and hasattr(n, "table"):
            yield n
        for c in n.children:
            yield from scans(c)
    [scan] = list(scans(plan.root))
    [jscan] = list(scans(jplan.root))
    assert isinstance(scan, TableScanNode)
    assert any(name == "l_shipdate" and hi is not None
               for name, _lo, hi in scan.pushdown)
    assert list(scan.pushdown) == list(jscan.pushdown)


#: statements of test_template_mix_of_kinds with integer literals in
#: their holes, and how many
TEMPLATE_INTEGER_HOLES = {
    "select 1 from lineitem where l_quantity > 5": 1,
    "select 1 from lineitem where l_comment like '%x%' and l_linenumber "
    "in (1, 2)": 2,
}


@pytest.mark.parametrize("sql", [
    "select 1 from lineitem where l_quantity > 5",
    "select 1 from lineitem where l_quantity > 5.0",
    "select 1 from lineitem where l_discount between 0.05 and 0.07",
    "select 1 from lineitem where l_shipdate < date '1995-01-01'",
    "select l_returnflag, count(*) from lineitem group by 1 order by 1 "
    "limit 3",
    "select 1 from lineitem where l_comment like '%x%' and l_linenumber "
    "in (1, 2)",
    "select 1 from orders where o_totalprice > 12345678901234567890.5",
])
def test_template_mix_of_kinds(sql):
    """INTEGER / DOUBLE / short-DECIMAL / DATE literals parameterize
    as in the reference (kind is part of the key: 5 and 5.0 never share
    a template; LIMIT counts, GROUP BY ordinals, LIKE patterns and long
    decimals stay baked). An integer literal's kind is its type: INTEGER
    in the port (Presto's LongLiteral typing) where the reference says
    BIGINT, in the number of holes TEMPLATE_INTEGER_HOLES lists."""
    t, m, v = parameterize(parse_cached(sql))
    jt, jm, jv = jparameterize(jparse(sql))
    assert v == jv
    holes = TEMPLATE_INTEGER_HOLES.get(sql, 0)
    assert repr(jt).count("kind='bigint'") == holes
    assert repr(t) == repr(jt).replace("kind='bigint'", "kind='integer'")
    assert repr(m) == repr(jm)


def test_template_kind_is_part_of_the_key():
    a = parameterize(parse_cached(
        "select 1 from lineitem where l_quantity > 5"))
    b = parameterize(parse_cached(
        "select 1 from lineitem where l_quantity > 5.0"))
    assert a[0] != b[0]
    assert a[2] == {0: 5} and b[2] == {0: 5.0}


def test_parse_cache_does_not_leak_across_sessions():
    """parse_cached keys on TEXT only; two sessions with different
    tables behind one name share the parsed AST but not the plan or the
    result."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Schema
    from presto_tpu_torch.serving.plancache import PlanCache

    def mem_runner(vals):
        cats = CatalogManager()
        mem = MemoryConnector()
        cats.register("memory", mem)
        cats.register("tpch", TpchConnector(sf=0.001))
        r = LocalRunner(catalogs=cats, catalog="memory", device="cpu")
        mem.create_table("t", Schema([("x", T.BIGINT)]))
        mem.append("t", Batch.from_pydict({"x": (T.BIGINT, vals)},
                                          device="cpu"))
        return r

    r1, r2 = mem_runner([1, 2, 3]), mem_runner([10, 20])
    sql = "select sum(x) s from t"
    assert parse_cached(sql) is parse_cached(sql)
    stmt = parse_cached(sql)
    assert PlanCache.fingerprint(stmt, r1.session) != \
        PlanCache.fingerprint(stmt, r2.session)
    props = {**TPROPS, **RPROPS}
    assert r1.execute(sql, properties=props).rows == [(6,)]
    assert r2.execute(sql, properties=props).rows == [(30,)]
    assert r1.execute(sql, properties=props).rows == [(6,)]


# -- result cache -------------------------------------------------------------

def test_result_cache_hit_and_write_invalidation(files):
    """Eager invalidation rides spi.notify_data_change for memory,
    SQLite and file-table writes, the path the plan cache uses."""
    tmp = tempfile.mkdtemp()
    files.jax.session.catalogs.register(
        "sqlite", JSqlite(os.path.join(tmp, "j.sqlite")))
    files.port.session.catalogs.register(
        "sqlite", SqliteConnector(os.path.join(tmp, "t.sqlite")))
    cases = [(cat, f"select count(*) c, sum(q) s from {cat}.t")
             for cat in ("memory", "sqlite", "orc")]
    for cat, _ in cases:
        files.check(f"create table {cat}.t as select l_orderkey k, "
                    "l_quantity q from lineitem where l_orderkey < 100")
    for cat, sql in cases:
        a, _ = files.check(sql, properties=RPROPS)
        b, d = files.check(sql, properties=RPROPS)
        assert a == b and d["result_cache_hit_total"] == 1
        _, d = files.check(f"insert into {cat}.t select l_orderkey k, "
                           "l_quantity q from lineitem "
                           "where l_orderkey between 100 and 150")
        if cat != "orc":
            # file-table appends stay resident for incremental
            # maintenance; the others drop eagerly
            assert d["result_cache_invalidated_total"] > 0
        c, _ = files.check(sql, properties=RPROPS)
        assert c == files.check(sql)[0]
        assert c != a                  # the write is visible


def test_result_cache_mid_execution_write_vetoes_insert(files):
    """A connector write notifying while the query runs vetoes the
    insert (the stored rows could straddle versions)."""
    from presto_tpu_torch.connectors import spi
    r = files.port
    r.execute("create table memory.v as select l_orderkey k from "
              "lineitem where l_orderkey < 50")
    mem = r.session.catalogs.get("memory")
    sql = "select count(*) from memory.v"
    fired = []
    orig = MemoryConnector.page_source

    def chaotic(self, *a, **k):
        if not fired:
            fired.append(1)
            spi.notify_data_change(mem, "unrelated")  # mid-run write
        return orig(self, *a, **k)

    MemoryConnector.page_source = chaotic
    try:
        m0 = REGISTRY.counter("result_cache_miss_total").value
        r.execute(sql, properties=RPROPS)
        # vetoed: the very next execution is a miss again
        r.execute(sql, properties=RPROPS)
        assert REGISTRY.counter("result_cache_miss_total").value == m0 + 2
    finally:
        MemoryConnector.page_source = orig
    r.execute(sql, properties=RPROPS)
    h0 = REGISTRY.counter("result_cache_hit_total").value
    assert r.execute(sql, properties=RPROPS).rows == r.execute(sql).rows
    assert REGISTRY.counter("result_cache_hit_total").value == h0 + 1


def test_result_cache_epoch_api_veto():
    from presto_tpu_torch.exec.local import QueryResult
    for mod, qr in ((RC, QueryResult),
                    (JRC, __import__("presto_tpu.exec.local",
                                     fromlist=["QueryResult"]).QueryResult)):
        epoch = mod.RESULTS.epoch()
        mod.RESULTS.note_write()
        assert not mod.RESULTS.put(b"k-veto", qr(["a"], [], [(1,)]),
                                   deps=[], epoch=epoch)


def test_result_cache_stamp_failpoint_write_vetoes(files):
    """A write landing at the ``resultcache.stamp`` failpoint, between
    the epoch capture and the dep stamps, vetoes the insert."""
    from presto_tpu_torch.exec.failpoints import FAILPOINTS
    r = files.port
    r.execute("create table memory.st as select l_orderkey k from "
              "lineitem where l_orderkey < 30")
    sql = "select count(*) from memory.st"
    FAILPOINTS.configure(
        "resultcache.stamp", action="callback", times=1,
        callback=lambda **_: r.execute(
            "insert into memory.st select 999999"))
    try:
        m0 = REGISTRY.counter("result_cache_miss_total").value
        first = r.execute(sql, properties=RPROPS).rows
    finally:
        FAILPOINTS.clear("resultcache.stamp")
    cold = r.execute(sql).rows
    assert first == cold               # the write landed before the scan
    # vetoed: the next run misses again and inserts
    assert r.execute(sql, properties=RPROPS).rows == cold
    assert REGISTRY.counter("result_cache_miss_total").value == m0 + 2


def test_incremental_partial_maintenance(files):
    """Append-only file-table growth: only the changed splits recompute;
    the merged result equals a cold run for grouped AND global
    distributive aggregations; a rewrite falls back to a miss."""
    files.check("create table orc.inc as select l_orderkey k, "
                "l_quantity q, l_returnflag flag from lineitem "
                "where l_orderkey < 500")
    grouped = ("select flag, count(*) c, sum(q) sq, max(k) mk "
               "from orc.inc group by flag order by flag")
    glob = "select count(*), sum(q), min(k) from orc.inc where q > 10"
    files.check(grouped, properties=RPROPS)
    files.check(glob, properties=RPROPS)
    files.check("insert into orc.inc select l_orderkey k, l_quantity q, "
                "l_returnflag flag from lineitem "
                "where l_orderkey between 500 and 1000")
    for sql in (grouped, glob):
        rows, d = files.check(sql, properties=RPROPS)
        assert d["result_cache_partial_total"] == 1
        assert rows == files.check(sql)[0]
    # the re-stamped entry serves plain hits afterwards
    assert files.check(grouped, properties=RPROPS)[1][
        "result_cache_hit_total"] == 1
    # rewrite (drop + recreate): old files gone -> full miss, not merge
    files.check("drop table orc.inc")
    files.check("create table orc.inc as select l_orderkey k, "
                "l_quantity q, l_returnflag flag from lineitem "
                "where l_orderkey < 300")
    rows, d = files.check(grouped, properties=RPROPS)
    assert d["result_cache_partial_total"] == 0
    assert rows == files.check(grouped)[0]


def test_partial_hit_recomputes_only_the_appended_split(files):
    """The delta run scans the appended file's split and no other
    (``execute_plan``'s ``split_restrict``)."""
    r = files.port
    r.execute("create table orc.one as select l_orderkey k, l_quantity q "
              "from lineitem where l_orderkey < 400")
    sql = "select count(*) c, sum(q) s from orc.one"
    conn = r.session.catalogs.get("orc")
    old = set(conn.table_files("one"))
    r.execute(sql, properties=RPROPS)
    r.execute("insert into orc.one select l_orderkey k, l_quantity q "
              "from lineitem where l_orderkey between 400 and 600")
    new = set(conn.table_files("one")) - old
    assert old and new
    seen = []
    import presto_tpu_torch.exec.local as L
    real = L.execute_plan

    def spy(plan, session, device, *a, split_restrict=None, **k):
        if split_restrict is not None:
            ((key, pred),) = split_restrict.items()
            handle = __import__(
                "presto_tpu_torch.connectors.spi",
                fromlist=["TableHandle"]).TableHandle("orc", "default",
                                                      "one")
            seen.append({s.info[0]: pred(s) for s in
                         conn.split_manager.splits(handle)})
        return real(plan, session, device, *a,
                    split_restrict=split_restrict, **k)

    L.execute_plan = spy
    try:
        got = r.execute(sql, properties=RPROPS).rows
    finally:
        L.execute_plan = real
    assert seen == [{f: f in new for f in old | new}]
    assert got == r.execute(sql).rows


def test_concurrent_partial_hits_never_double_apply(files):
    """Two lookups racing on one appended entry each merge the delta
    into their LOOKUP-TIME snapshot; the second re-stamp is rejected, so
    the delta never counts twice."""
    r = files.port
    r.execute("create table orc.race as select l_orderkey k, "
              "l_quantity q from lineitem where l_orderkey < 400")
    sql = "select count(*) c, sum(q) sq from orc.race"
    r.execute(sql, properties=RPROPS)
    r.execute("insert into orc.race select l_orderkey k, l_quantity q "
              "from lineitem where l_orderkey between 400 and 800")
    session = dataclasses.replace(r.session, properties={
        **r.session.properties, **RPROPS})
    key = bound_fingerprint(parse_cached(sql), session)
    out1, ph1 = RC.RESULTS.get(key)
    out2, ph2 = RC.RESULTS.get(key)
    assert out1 == out2 == "partial"
    restrict = RC.split_predicate(session, ph1.spec, ph1.new_files)
    d1 = RC.subplan_result(ph1.plan, ph1.spec, session, "cpu", 1 << 17,
                           split_restrict=restrict)
    m1 = RC.merge_subplan_rows(ph1.spec, ph1.base_subplan, d1)
    o1 = RC.replay_suffix(ph1.plan, ph1.spec, m1, session, "cpu", 1 << 17)
    assert RC.RESULTS.update(ph1, o1, m1)
    m2 = RC.merge_subplan_rows(ph2.spec, ph2.base_subplan, d1)
    o2 = RC.replay_suffix(ph2.plan, ph2.spec, m2, session, "cpu", 1 << 17)
    assert sorted(o2.rows) == sorted(o1.rows)
    assert not RC.RESULTS.update(ph2, o2, m2)
    assert r.execute(sql, properties=RPROPS).rows == r.execute(sql).rows


def test_result_cache_stores_materialized_plans(files):
    """With templates and the result cache combined, the stored plan is
    binding-free (a later guard-fallback query replays it with no
    binding scope)."""
    from presto_tpu_torch.expr.params import has_params
    r = files.port
    r.execute("create table orc.mat as select l_orderkey k, "
              "l_quantity q from lineitem where l_orderkey < 200")
    props = {**TPROPS, **RPROPS}
    sql = "select count(*) c, sum(q) s from orc.mat where q > 5"
    r.execute(sql, properties=props)
    session = dataclasses.replace(
        r.session, properties={**r.session.properties, **props})
    outcome, entry = RC.RESULTS.get(bound_fingerprint(parse_cached(sql),
                                                      session))
    assert outcome == "hit"
    assert entry.spec is not None          # incremental-eligible
    assert not has_params(entry.plan)      # materialized for replay


def test_result_cache_eviction_under_limit(files):
    r = files.port
    r.execute("create table memory.ev as select l_orderkey k from "
              "lineitem where l_orderkey < 200")
    old_limit = RC.RESULTS.pool.limit
    try:
        RC.RESULTS.clear()
        r.execute("select count(*) from memory.ev where k > 0",
                  properties=RPROPS)
        size0 = RC.RESULTS.pool.reserved
        assert size0 > 0
        limit = int(size0 * 2.5)        # room for 2 entries, never 3
        RC.RESULTS.set_limit(limit)
        e0 = REGISTRY.counter("result_cache_evicted_total").value
        for lo in (50, 100, 150):
            r.execute(f"select count(*) from memory.ev where k > {lo}",
                      properties=RPROPS)
        assert RC.RESULTS.pool.reserved <= limit
        assert REGISTRY.counter("result_cache_evicted_total").value > e0
        assert len(RC.RESULTS) <= 2
    finally:
        RC.RESULTS.set_limit(old_limit)


def test_explain_analyze_result_cache_line(files):
    files.check("create table memory.t as select l_orderkey k from "
                "lineitem where l_orderkey < 100")
    sql = "select count(*) from memory.t"
    files.check(sql, properties=RPROPS)
    line = [row[0] for row in files.port.execute(
        "explain analyze " + sql, properties=RPROPS).rows
        if row[0].startswith("Result cache:")]
    jline = [row[0] for row in files.jax.execute(
        "explain analyze " + sql, properties=RPROPS).rows
        if row[0].startswith("Result cache:")]
    assert len(line) == 1 and line[0].startswith(
        "Result cache: cached (1 rows)")
    assert jline[0].startswith("Result cache: cached (1 rows)")


def test_template_cache_invalidated_by_write(files):
    """The template cache rides the same write hook as the plan cache."""
    files.check("create table memory.tw as select l_orderkey k from "
                "lineitem where l_orderkey < 100")
    sql = "select count(*) from memory.tw where k > %d"
    files.check(sql % 10, properties=TPROPS)
    n0 = len(TEMPLATES)
    files.check("insert into memory.tw select 5")
    assert len(TEMPLATES) <= n0
    rows, d = files.check(sql % 1, properties=TPROPS)
    assert d["plan_template_cache_miss_total"] == 1


def test_cluster_template_and_result_cache_parity():
    """Row-exact parity on the ClusterRunner path, in both packages:
    template-cached plans materialize their bindings before fragmenting,
    and result-cache hits serve the stored rows."""
    from presto_tpu.exec.cluster import ClusterRunner as JCluster
    from presto_tpu.server.worker import WorkerServer as JWorker
    from presto_tpu_torch.exec.cluster import ClusterRunner
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.server.worker import WorkerServer
    workers = [WorkerServer(tpch_sf=0.001, device="cpu") for _ in range(2)]
    jworkers = [JWorker(tpch_sf=0.001) for _ in range(2)]
    for w in workers + jworkers:
        w.start()
    try:
        out = []
        for runner, reg in (
                (ClusterRunner([f"http://127.0.0.1:{w.port}"
                                for w in workers], tpch_sf=0.001,
                               heartbeat=False, device="cpu"), REGISTRY),
                (JCluster([f"http://127.0.0.1:{w.port}" for w in jworkers],
                          tpch_sf=0.001, heartbeat=False), JREG)):
            props = {**TPROPS, **RPROPS}
            sql = ("select n_regionkey, count(*) c from nation "
                   "where n_nationkey > %d group by n_regionkey "
                   "order by n_regionkey")
            cold = [runner.execute(sql % k).rows for k in (3, 7)]
            warm = [runner.execute(sql % k, properties=props).rows
                    for k in (3, 7)]
            assert warm == cold
            h0 = reg.counter("result_cache_hit_total").value
            again = [runner.execute(sql % k, properties=props).rows
                     for k in (3, 7)]
            assert again == cold
            assert reg.counter("result_cache_hit_total").value == h0 + 2
            out.append(cold)
        assert out[0] == out[1]
    finally:
        for w in workers + jworkers:
            w.stop()
