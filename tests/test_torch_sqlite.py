"""The SQLite connector of presto_tpu_torch against presto_tpu's (the cases
of tests/test_sqlite_connector.py but the plugin factory): each package
writes a TPC-H SF 0.01 subset into its own SQLite file through its write
path, then reads it back, pushes filters into SQLite's WHERE, joins it
across catalogs and feeds its statistics to the optimizer, on the CPU."""
import dataclasses
import sqlite3

import pytest

from presto_tpu.connectors.spi import CatalogManager as JCatalogs
from presto_tpu.connectors.spi import TableHandle as JHandle
from presto_tpu.connectors.sqlite import SqliteConnector as JSqlite
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch.connectors.spi import CatalogManager, TableHandle
from presto_tpu_torch.connectors.sqlite import SqliteConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.exec.scancache import CACHE
from torch_parity import assert_results_match

SF = 0.01
SETUP = (
    "create table sq.default.nation2 as select * from nation",
    "create table sq.default.orders2 as select o_orderkey, o_custkey, "
    "o_totalprice, o_orderdate, o_orderstatus from orders "
    "where o_orderkey < 1000",
)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("sqlite")
    jc = JCatalogs()
    jc.register("tpch", JTpch(sf=SF))
    jc.register("sq", JSqlite(str(base / "ref.db")))
    tc = CatalogManager()
    tc.register("tpch", TpchConnector(sf=SF))
    tc.register("sq", SqliteConnector(str(base / "port.db")))
    out = (JRunner(catalogs=jc, catalog="tpch"),
           LocalRunner(catalogs=tc, catalog="tpch", device="cpu"))
    for sql in SETUP:
        assert out[1].execute(sql).rows == out[0].execute(sql).rows
    return out


def both(pair, sql, rel=1e-12):
    jr, tr = pair
    got, want = tr.execute(sql), jr.execute(sql)
    assert_results_match(got, want, rel)
    return got


def test_metadata_discovery(pair):
    conn = pair[1].session.catalogs.get("sq")
    tables = conn.metadata.list_tables()
    assert tables == pair[0].session.catalogs.get("sq").metadata.list_tables()
    assert "nation2" in tables and "orders2" in tables
    schema = conn.metadata.table_schema(
        TableHandle("sq", "default", "orders2"))
    want = pair[0].session.catalogs.get("sq").metadata.table_schema(
        JHandle("sq", "default", "orders2"))
    assert schema.names == want.names
    assert [t.display() for t in schema.types] == \
        [t.display() for t in want.types]


def test_written_files_hold_the_same_rows(pair, tmp_path_factory):
    """Both packages' write paths stored the same values in SQLite."""
    dbs = [c.session.catalogs.get("sq").path for c in pair]
    rows = []
    for db in dbs:
        with sqlite3.connect(db) as con:
            rows.append(con.execute(
                "select * from orders2 order by o_orderkey").fetchall())
    assert rows[0] == rows[1] and rows[0]


@pytest.mark.parametrize("sql", [
    "select n_nationkey, n_name, n_regionkey from sq.default.nation2 "
    "order by 1",
    "select count(*), sum(o_totalprice), min(o_orderdate), "
    "max(o_orderstatus) from sq.default.orders2 "
    "where o_orderkey between 10 and 500",
    "select r_name, count(*) from sq.default.nation2 "
    "join tpch.default.region on n_regionkey = r_regionkey "
    "group by r_name order by r_name",
    "select o_orderstatus, count(*), sum(c_acctbal) from sq.default.orders2 "
    "join customer on o_custkey = c_custkey group by 1 order by 1",
])
def test_queries_equal_reference(pair, sql):
    assert both(pair, sql).rows


def test_roundtrip_matches_source(pair):
    tr = pair[1]
    want = tr.execute("select n_nationkey, n_name from nation order by 1")
    got = tr.execute("select n_nationkey, n_name from sq.default.nation2 "
                     "order by 1")
    assert got.rows == want.rows


def test_filter_pushdown_reaches_sqlite(pair):
    """The planner's bounds render into SQLite's WHERE clause (reference
    JdbcMetadata.applyFilter -> QueryBuilder)."""
    conn = pair[1].session.catalogs.get("sq")
    split = conn.split_manager.splits(
        TableHandle("sq", "default", "orders2"), 1)[0]
    src = conn.page_source(split, ["o_orderkey", "o_totalprice"],
                           pushdown=(("o_orderkey", 10, 500),),
                           device="cpu")
    assert '"o_orderkey" >= ?' in src._sql and '"o_orderkey" <= ?' in src._sql
    n = sum(b.host_count() for b in src.batches())
    full = conn.page_source(split, ["o_orderkey"], device="cpu")
    assert 0 < n < sum(b.host_count() for b in full.batches())
    # string bounds arrive as dictionary codes: never pushed down
    src = conn.page_source(split, ["o_orderstatus"],
                           pushdown=(("o_orderstatus", 0, 1),), device="cpu")
    assert '"o_orderstatus" >=' not in src._sql


def test_engine_filters_through_connector(pair):
    tr = pair[1]
    got = tr.execute("select count(*), sum(o_totalprice) from "
                     "sq.default.orders2 where o_orderkey between 10 and 500")
    want = tr.execute("select count(*), sum(o_totalprice) from orders "
                      "where o_orderkey between 10 and 500 "
                      "and o_orderkey < 1000")
    assert int(got.rows[0][0]) == int(want.rows[0][0])
    assert float(got.rows[0][1]) == pytest.approx(float(want.rows[0][1]),
                                                  rel=1e-9)


def test_pushdown_in_explain(pair):
    text = "\n".join(r[0] for r in both(
        pair, "explain select o_totalprice from sq.default.orders2 "
              "where o_orderkey between 10 and 500").rows)
    assert "sq.default.orders2" in text


def test_stats_feed_optimizer(pair):
    conn = pair[1].session.catalogs.get("sq")
    stats = conn.metadata.table_stats(TableHandle("sq", "default", "nation2"))
    want = pair[0].session.catalogs.get("sq").metadata.table_stats(
        JHandle("sq", "default", "nation2"))
    assert stats.row_count == want.row_count == 25
    assert {k: dataclasses.astuple(v) for k, v in stats.columns.items()} \
        == {k: dataclasses.astuple(v) for k, v in want.columns.items()}
    cs = stats.columns["n_nationkey"]
    assert cs.distinct_count == 25 and cs.min_value == 0


def test_writes_invalidate_stats_and_scan_cache(pair):
    tr = pair[1]
    tr.execute("create table sq.default.w as select 1 a")
    conn = tr.session.catalogs.get("sq")
    h = TableHandle("sq", "default", "w")
    v0 = conn.data_version("w")
    assert conn.metadata.table_stats(h).row_count == 1
    CACHE.clear()
    assert tr.execute("select count(*) from sq.default.w").rows == [(1,)]
    tr.execute("insert into sq.default.w select 2")
    assert conn.data_version("w") != v0
    assert conn.metadata.table_stats(h).row_count == 2
    assert tr.execute("select count(*) from sq.default.w").rows == [(2,)]
    tr.execute("drop table sq.default.w")
    assert "w" not in conn.metadata.list_tables()


def test_the_join_probes_through_the_direct_table(pair):
    """A build read from SQLite declares no keys; its measured key
    multiplicity is 1, so the join probes a direct-address table (on the
    card, the probe kernel; here its plain version)."""
    from presto_tpu_torch.obs.profiler import KERNELS

    def probe_calls():
        return [k for k in KERNELS.snapshot()
                if k["name"] == "direct_probe"][0]["plain_calls"]
    before = probe_calls()
    both(pair, "select c_nationkey, count(*), sum(o_orderkey) from "
               "sq.default.orders2 join customer on o_custkey = c_custkey "
               "group by 1 order by 1")
    assert probe_calls() > before
