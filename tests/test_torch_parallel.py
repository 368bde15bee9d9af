"""Local parallelism and grouped execution of presto_tpu_torch against
presto_tpu: ``task_concurrency`` on the grouped aggregation's partial
step (dense and sort path), the hash mode of the local exchange,
``parallel_drivers``, the lock-order validator the runner's locks feed,
and grouped (lifespan) execution over co-partitioned ORC tables
(tests/test_partitioned_catalog.py's two grouped-execution cases). On
the CPU, TPC-H SF 0.01."""
import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.batch import Batch as JBatch, Schema as JSchema
from presto_tpu.exec.local_exchange import LocalExchange as JExchange
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.parallel.exchange import hash_partition_ids as jhash
from presto_tpu_torch._devtools.lockcheck import (
    ENABLED, GRAPH, GuardedFieldError, LockGraph, checked_lock, guarded_by,
)
from presto_tpu_torch.connectors.orc import OrcConnector
from presto_tpu_torch.connectors.spi import CatalogManager
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.local_exchange import (
    LocalExchange, parallel_drivers,
)
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.obs.profiler import KERNELS
from torch_parity import assert_results_match, to_port

SF = 0.01
SEED = 20261018
AGG_QUERIES = [
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "min(l_shipdate), max(l_orderkey) from lineitem group by 1, 2 "
    "order by 1, 2",
    "select l_orderkey, count(*) c, sum(l_linenumber) s from lineitem "
    "group by l_orderkey order by l_orderkey limit 40",
    "select o_orderpriority, count(*) from orders, lineitem "
    "where l_orderkey = o_orderkey group by 1 order by 1",
]


@pytest.fixture(scope="module")
def pair():
    # 2^14-row batches: lineitem streams as four batches, one per driver
    return (JRunner(tpch_sf=SF, rows_per_batch=1 << 14),
            LocalRunner(tpch_sf=SF, device="cpu", rows_per_batch=1 << 14))


def _calls(name):
    return [k for k in KERNELS.snapshot() if k["name"] == name][0][
        "plain_calls"]


# -- task_concurrency ---------------------------------------------------------

@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sort"])
@pytest.mark.parametrize("i", range(len(AGG_QUERIES)))
def test_task_concurrency_equals_reference(pair, i, dense):
    """Partials on four driver threads: the rows of one driver and, for
    one sort-path shape, of the reference with four drivers; integer
    columns exactly, double sums within rel 1e-9 (the drivers' partials
    merge in no fixed order)."""
    jr, tr = pair
    sql = AGG_QUERIES[i]
    one = tr.execute(sql, properties={"dense_grouping": dense})
    before = _calls("segment_sum_sorted_i64")
    four = tr.execute(sql, properties={"dense_grouping": dense,
                                       "task_concurrency": 4})
    assert_results_match(four, one, 1e-9)
    if dense:
        return
    # the sort path's partials run the segment sum on the drivers
    assert _calls("segment_sum_sorted_i64") > before
    if i == 1:
        # the 15 000-group shape against the reference with four drivers
        # (the other shapes' one-driver rows are the reference's in
        # test_torch_aggregates.py and test_torch_spill.py)
        want = jr.execute(sql, properties={"dense_grouping": dense,
                                           "task_concurrency": 4})
        assert_results_match(four, want, 1e-9)


def test_task_concurrency_explain_analyze_keeps_device_time(pair):
    """The drivers' partials are charged to the aggregation node: under
    EXPLAIN ANALYZE with four drivers it still shows device time."""
    text = "\n".join(r[0] for r in pair[1].execute(
        "explain analyze " + AGG_QUERIES[1],
        properties={"dense_grouping": False, "task_concurrency": 4}).rows)
    agg = [line for line in text.split("\n") if "Aggregate[" in line
           and "device" in line]
    assert agg, text


# -- the hash local exchange ----------------------------------------------------

def _seeded_batch(n=500, cap=1024):
    rng = np.random.default_rng(SEED)
    words = tuple(f"w{i}" for i in range(37))
    cols = [("k", JT.BIGINT, rng.integers(-2**40, 2**40, n)),
            ("s", JT.VARCHAR, rng.integers(0, len(words), n).astype(np.int32)),
            ("d", JT.DOUBLE, rng.normal(0, 1e4, n)),
            ("t", JT.DATE, rng.integers(0, 20000, n).astype(np.int32))]
    schema = JSchema([(name, t) for name, t, _ in cols])
    b = JBatch.from_arrays(
        schema, [a for _, _, a in cols],
        [rng.random(n) < 0.9 for _ in cols],
        [words if t.is_string else None for _, t, _ in cols],
        capacity=cap, num_rows=n)
    mask = np.asarray(b.row_mask).copy()
    mask[rng.random(cap) < 0.1] = False
    return JBatch(b.schema, b.columns, mask)


@pytest.mark.parametrize("keys", [[0], [1], [2], [3], [1, 0, 3]],
                         ids=["bigint", "varchar", "double", "date", "mixed"])
@pytest.mark.parametrize("n", [3, 4])
def test_hash_exchange_equals_reference_partition_ids(keys, n):
    """Consumer c gets exactly the live rows whose key tuple the
    reference's hash_partition_ids sends to c, string keys by value."""
    jb = _seeded_batch()
    ex = LocalExchange("hash", n, key_cols=keys, buffer_batches=2)
    ex.push(to_port(jb))
    ex.finish()
    got = [next(iter(c)).row_mask.numpy() for c in ex.consumers()]
    pid = np.asarray(jhash(jb, keys, n))
    mask = np.asarray(jb.row_mask)
    for c in range(n):
        assert (got[c] == (mask & (pid == c))).all()
    jex = JExchange("hash", n, key_cols=keys, buffer_batches=2)
    jex.push(jb)
    jex.finish()
    want = [np.asarray(next(iter(c)).row_mask) for c in jex.consumers()]
    assert all((g == w).all() for g, w in zip(got, want))
    assert sum(int(g.sum()) for g in got) == int(mask.sum())


def test_hash_exchange_needs_keys():
    with pytest.raises(ValueError, match="key columns"):
        LocalExchange("hash", 2)


# -- parallel_drivers -----------------------------------------------------------

def test_parallel_drivers_apply_every_batch_once():
    seen = []
    lock = threading.Lock()

    def fn(x):
        with lock:
            seen.append(threading.current_thread().name)
        return x * 10

    out = list(parallel_drivers(iter(range(50)), fn, 4))
    assert sorted(out) == [x * 10 for x in range(50)]
    assert len(seen) == 50
    assert list(parallel_drivers(iter(range(5)), fn, 1)) == \
        [0, 10, 20, 30, 40]


def test_parallel_drivers_raise_a_driver_error_and_join():
    def fn(x):
        if x == 7:
            raise ValueError("bad batch")
        return x

    before = threading.active_count()
    with pytest.raises(ValueError, match="bad batch"):
        list(parallel_drivers(iter(range(20)), fn, 4))
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_parallel_drivers_early_close_stops_the_threads():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = threading.active_count()
    it = parallel_drivers(endless(), lambda x: x, 4, buffer_batches=1)
    assert next(it) is not None
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_parallel_drivers_stress_no_lost_batch():
    """More drivers than cores and a short switch interval: every batch
    comes back exactly once."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = list(parallel_drivers(
            (torch.full((4,), i) for i in range(300)),
            lambda t: int(t.sum()), 16, buffer_batches=2))
    finally:
        sys.setswitchinterval(old)
    assert sorted(out) == [4 * i for i in range(300)]


# -- the lock-order validator ---------------------------------------------------

def test_lock_graph_finds_an_inversion():
    g = LockGraph()
    a, b = g.lock("a"), g.lock("b")
    with a:
        with b:
            pass
    assert g.check() == []
    with b:
        with a:
            pass
    (finding,) = g.check()
    assert "cycle" in finding and "a" in finding and "b" in finding


def test_guarded_field_needs_its_lock():
    g = LockGraph()

    class Box:
        value = guarded_by("box.lock", graph=g)

        def __init__(self):
            self.lock = g.lock("box.lock")
            self.value = 1          # the first write is exempt

    box = Box()
    with box.lock:
        box.value = 2
        assert box.value == 2
    with pytest.raises(GuardedFieldError):
        box.value = 3
    assert g.check()


def test_engine_locks_keep_a_clean_order(pair):
    """The runner's, the history's and the registries' checked locks,
    taken by queries with four drivers, form no cycle."""
    assert ENABLED        # on under pytest
    assert checked_lock("x").__class__.__name__ == "_CheckedLock"
    pair[1].execute(AGG_QUERIES[1], properties={"dense_grouping": False,
                                                "task_concurrency": 4})
    pair[1].execute("select count(*) from system.runtime.completed_queries")
    assert not [v for v in GRAPH.check() if "cycle" in v]


# -- grouped (lifespan) execution ------------------------------------------------

def _orc_runner(tmp_path, sf=SF):
    catalogs = CatalogManager()
    catalogs.register("orc", OrcConnector(str(tmp_path)))
    catalogs.register("tpch", TpchConnector(sf=sf))
    return LocalRunner(catalogs=catalogs, catalog="orc", device="cpu",
                       rows_per_batch=1 << 12)


def test_grouped_execution_against_the_whole_join(tmp_path):
    """The port's lifespan rows equal its own grouped_execution=false
    rows; the pool peak is lower in buckets, and each bucket probes a
    direct-address table on the join key left after its partition key."""
    r = _orc_runner(tmp_path)
    r.execute("create table ord_p with (partitioned_by = array['b']) as "
              "select o_orderkey, o_custkey, o_orderkey % 8 b "
              "from tpch.default.orders")
    r.execute("create table li_p with (partitioned_by = array['b']) as "
              "select l_orderkey, l_quantity, l_orderkey % 8 b "
              "from tpch.default.lineitem")
    q = ("select count(*), sum(l_quantity), sum(o_custkey) from li_p "
         "join ord_p on l_orderkey = o_orderkey and li_p.b = ord_p.b")
    before = _calls("direct_probe")
    grouped = r.execute(q)
    probes = _calls("direct_probe") - before
    peak_grouped = r.session.last_memory_stats.peak_bytes
    before = _calls("direct_probe")
    plain = r.execute(q, properties={"grouped_execution": False})
    peak_plain = r.session.last_memory_stats.peak_bytes
    assert _calls("direct_probe") == before       # two keys: binary search
    assert_results_match(grouped, plain, 1e-12)
    want = r.execute("select count(*), sum(l_quantity), sum(o_custkey) "
                     "from tpch.default.lineitem join tpch.default.orders "
                     "on l_orderkey = o_orderkey")
    assert_results_match(grouped, want, 1e-12)
    assert probes >= 8
    assert peak_grouped * 4 < peak_plain


def test_grouped_execution_skips_non_copartitioned(tmp_path):
    r = _orc_runner(tmp_path)
    r.execute("create table na with (partitioned_by = array['p']) as "
              "select * from (values (1, 0), (2, 1), (3, 0)) t(id, p)")
    r.execute("create table nb as select * from "
              "(values (1, 10), (2, 20), (4, 40)) t(id, v)")
    assert r.execute("select ga.id, nb.v from na ga join nb "
                     "on ga.id = nb.id order by 1").rows == [(1, 10), (2, 20)]


def _jax_orc_runner(tmp_path):
    from presto_tpu.connectors.orc import OrcConnector as JOrc
    from presto_tpu.connectors.spi import CatalogManager as JCatalogs
    from presto_tpu.connectors.tpch import TpchConnector as JTpch
    catalogs = JCatalogs()
    catalogs.register("orc", JOrc(str(tmp_path)))
    catalogs.register("tpch", JTpch(sf=SF))
    return JRunner(catalogs=catalogs, catalog="orc")


@pytest.mark.slow
def test_partitioned_catalog_grouped_cases_equal_reference(tmp_path):
    """tests/test_partitioned_catalog.py's two grouped-execution cases
    through both packages: the same rows, and a lower pool peak in
    buckets in both. Slow, as the reference's own cases are: the
    reference runs its lifespan path."""
    n = 6000 * 3
    rows_a = ", ".join(f"({i}, {i % 3})" for i in range(n))
    rows_b = ", ".join(f"({i}, {i % 3}, {i * 2})" for i in range(n))
    setup = [
        "CREATE TABLE ga WITH (partitioned_by = ARRAY['p']) AS "
        f"SELECT * FROM (VALUES {rows_a}) t(id, p)",
        "CREATE TABLE gb WITH (partitioned_by = ARRAY['p']) AS "
        f"SELECT * FROM (VALUES {rows_b}) t(id, p, v)",
        "CREATE TABLE na WITH (partitioned_by = ARRAY['p']) AS "
        "SELECT * FROM (VALUES (1, 0), (2, 1), (3, 0)) t(id, p)",
        "CREATE TABLE nb AS SELECT * FROM "
        "(VALUES (1, 10), (2, 20), (4, 40)) t(id, v)",
    ]
    out = []
    for r in (_jax_orc_runner(tmp_path / "ref"),
              _orc_runner(tmp_path / "port")):
        for sql in setup:
            r.execute(sql)
        q = ("SELECT count(*), sum(gb.v) FROM ga "
             "JOIN gb ON ga.id = gb.id AND ga.p = gb.p")
        grouped = r.execute(q).rows
        peak_grouped = r.session.last_memory_stats.peak_bytes
        plain = r.execute(q, properties={"grouped_execution": "false"}).rows
        peak_plain = r.session.last_memory_stats.peak_bytes
        assert grouped == plain == [(n, sum(i * 2 for i in range(n)))]
        assert peak_grouped < peak_plain
        out.append(r.execute("SELECT ga.id, nb.v FROM na ga JOIN nb "
                             "ON ga.id = nb.id ORDER BY 1").rows)
    assert out[0] == out[1] == [(1, 10), (2, 20)]
