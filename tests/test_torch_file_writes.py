"""The file catalogs' write path in the port: CREATE TABLE AS with
``partitioned_by`` (rows routed into ``key=value`` directories, the
reference's HivePageSink role), INSERT INTO, partition pruning on read,
the scan cache's invalidation on a write, and DROP TABLE, on the ORC and
the Parquet catalog, held against presto_tpu running the same
statements on its own copy of the catalog."""
import os

import pytest

from presto_tpu.connectors.orc import OrcConnector as JOrc
from presto_tpu.connectors.parquet import ParquetConnector as JParquet
from presto_tpu.connectors.spi import CatalogManager as JCatalogs
from presto_tpu.connectors.tpch import TpchConnector as JTpch
from presto_tpu.exec.runner import LocalRunner as JRunner

from presto_tpu_torch.connectors.orc import OrcConnector
from presto_tpu_torch.connectors.parquet import ParquetConnector
from presto_tpu_torch.connectors.spi import CatalogManager
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.formats import decodestats

from torch_parity import assert_results_match, assert_rows_match

SF = 0.01


def _runners(tmp_path, kind):
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jroot.mkdir()
    troot.mkdir()
    jc, tc = JCatalogs(), CatalogManager()
    jconn, tconn = {"orc": (JOrc, OrcConnector),
                    "parquet": (JParquet, ParquetConnector)}[kind]
    jc.register("files", jconn(str(jroot)))
    jc.register("tpch", JTpch(sf=SF))
    tc.register("files", tconn(str(troot)))
    tc.register("tpch", TpchConnector(sf=SF))
    return (JRunner(catalogs=jc, catalog="files"),
            LocalRunner(catalogs=tc, catalog="files", device="cpu"),
            troot)


CTAS = ("create table files.default.{t} with (partitioned_by = "
        "ARRAY['o_orderpriority']) as select o_orderkey, o_custkey, "
        "o_totalprice, o_orderdate, o_orderpriority from tpch.default.orders "
        "where o_orderkey < 2000")
INSERT = ("insert into files.default.{t} select o_orderkey, o_custkey, "
          "o_totalprice, o_orderdate, o_orderpriority from "
          "tpch.default.orders where o_orderkey between 2000 and 2999")
READ = ("select o_orderpriority, count(*), sum(o_totalprice), "
        "min(o_orderdate), max(o_orderkey) from {t} group by 1 order by 1")


@pytest.mark.parametrize("kind", ["orc", "parquet"])
def test_partitioned_ctas_insert_drop(tmp_path, kind):
    jr, tr, troot = _runners(tmp_path, kind)
    t = "ords"
    assert_results_match(tr.execute(CTAS.format(t=t)),
                         jr.execute(CTAS.format(t=t)))
    parts = sorted(os.listdir(troot / t))
    assert len(parts) == 5 and all(p.startswith("o_orderpriority=")
                                   for p in parts)
    assert_results_match(tr.execute(READ.format(t=t)),
                         jr.execute(READ.format(t=t)))
    # warm: the read replays from the scan cache; INSERT bumps the data
    # version, so the next read misses and sees the new rows
    tr.execute(READ.format(t=t))
    assert tr.last_stats.cache_hits > 0
    assert_results_match(tr.execute(INSERT.format(t=t)),
                         jr.execute(INSERT.format(t=t)))
    after = tr.execute(READ.format(t=t))
    assert tr.last_stats.cache_hits == 0
    assert_results_match(after, jr.execute(READ.format(t=t)))
    assert sum(r[1] for r in after.rows) == 2999   # order keys 1..2999
    sql = (f"select count(*) from {t} where o_orderpriority = '1-URGENT'")
    assert_results_match(tr.execute(sql), jr.execute(sql))
    drop = f"drop table files.default.{t}"
    tr.execute(drop)
    assert not os.path.exists(troot / t)
    with pytest.raises(KeyError):
        tr.execute(READ.format(t=t))


def test_partition_pruning_by_integer_key(tmp_path):
    """An integer partition key's bounds prune directories (counted) and
    the answer stays the reference's."""
    jr, tr, troot = _runners(tmp_path, "orc")
    ctas = ("create table files.default.li with (partitioned_by = "
            "ARRAY['l_linenumber']) as select l_orderkey, l_quantity, "
            "l_linenumber from tpch.default.lineitem "
            "where l_orderkey < 3000")
    tr.execute(ctas)
    jr.execute(ctas)
    assert len(os.listdir(troot / "li")) == 7
    sql = ("select count(*), sum(l_quantity) from li "
           "where l_linenumber between 2 and 3")
    pruned0 = decodestats.PARTITIONS_PRUNED.value
    assert_results_match(tr.execute(sql, properties={"scan_cache": False}),
                         jr.execute(sql))
    assert decodestats.PARTITIONS_PRUNED.value - pruned0 == 5
    with pytest.raises(ValueError, match="unknown table properties"):
        tr.execute("create table files.default.x with (format = 'ORC') "
                   "as select 1 a")


def test_smoke_files_phase_data(tmp_path):
    """chip_smoke.py's files phase at SF 0.01 on the CPU: its writers'
    tables read back through both catalogs equal to the TPC-H catalog,
    and config 5's range (scaled) prunes stripes."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    line = smoke.write_tpch_files(str(tmp_path), SF)
    assert "orc lineitem 60472 rows" in line
    assert "parquet lineitem 60472 rows" in line
    tpch = LocalRunner(tpch_sf=SF, device="cpu")
    for kind, conn in (("orc", OrcConnector), ("parquet",
                                               ParquetConnector)):
        cm = CatalogManager()
        cm.register(kind, conn(str(tmp_path / kind)))
        r = LocalRunner(catalogs=cm, catalog=kind, device="cpu")
        sql = ("select l_returnflag, l_linestatus, count(*), "
               "sum(l_quantity), min(l_shipdate) from lineitem "
               "group by 1, 2 order by 1, 2")
        # the files store varchar(n) as ORC / Parquet strings: the rows
        # are held, the type displays differ
        assert_rows_match(r.execute(sql).rows, tpch.execute(sql).rows,
                          1e-12)
    config5 = smoke.config5_sql(SF)
    assert "between 10000\n  and 10600 " in config5
    cm = CatalogManager()
    cm.register("orc", OrcConnector(str(tmp_path / "orc")))
    r = LocalRunner(catalogs=cm, catalog="orc", device="cpu")
    pruned0 = decodestats.ORC_STRIPES_PRUNED.value
    got = r.execute(config5, properties={"scan_cache": False}).rows
    assert sorted(got) == sorted(tpch.execute(config5).rows) and got
    assert decodestats.ORC_STRIPES_PRUNED.value > pruned0


@pytest.mark.parametrize("kind", ["orc", "parquet"])
def test_long_decimal_ctas_raises_and_leaves_no_table(tmp_path, kind):
    """A long-decimal column cannot be written: the port raises
    NotImplementedError before it opens a file, and the table does not
    exist afterwards (presto_tpu raises too, TypeError for ORC, where it
    leaves a partial file that breaks the next read, and struct.error
    for Parquet)."""
    jr, tr, troot = _runners(tmp_path, kind)
    sql = ("create table files.default.dec as select cast(o_totalprice as "
           "decimal(30, 2)) p, o_orderkey, o_orderdate from "
           "tpch.default.orders")
    with pytest.raises(Exception):
        jr.execute(sql)
    with pytest.raises(NotImplementedError):
        tr.execute(sql)
    conn = tr.session.catalogs.get("files")
    assert "dec" not in conn.metadata.list_tables()
    assert not (troot / "dec").exists() or not any((troot / "dec").iterdir())
    with pytest.raises(Exception, match="dec"):
        tr.execute("select count(*) from files.default.dec")
    # a short decimal of the same values writes and reads back
    tr.execute(sql.replace("decimal(30, 2)", "decimal(12, 2)"))
    assert tr.execute("select count(*) from files.default.dec").rows == \
        [(15000,)]


# -- faults of the reference that the port repairs ----------------------------

@pytest.mark.parametrize("kind", ["orc", "parquet"])
def test_insert_writes_the_tables_column_names(tmp_path, kind):
    """An INSERT whose query names its columns otherwise appends a file
    under the table's names. The reference writes the query's names
    (``l_orderkey``, ...), so its next read of ``f`` fails; the port
    writes the table's and reads every row back."""
    jr, tr, troot = _runners(tmp_path, kind)
    ctas = ("create table files.default.t as select l_orderkey k, "
            "l_quantity q, l_returnflag f from tpch.default.lineitem "
            "where l_orderkey < 1100")
    insert = ("insert into files.default.t select l_orderkey, l_quantity, "
              "l_returnflag from tpch.default.lineitem "
              "where l_orderkey between 1100 and 1200")
    read = "select f, count(*) from files.default.t group by f order by f"
    for r in (jr, tr):
        r.execute(ctas)
    assert_results_match(tr.execute(insert), jr.execute(insert))
    # the reference's answer: an error, which depends on which of the
    # two files (random names) its schema comes from: KeyError 'f',
    # "column f cannot be resolved", or a StopIteration from the read
    with pytest.raises(Exception):
        jr.execute(read)
    got = tr.execute(read)
    want = tr.execute(
        "select l_returnflag, count(*) from tpch.default.lineitem "
        "where l_orderkey <= 1200 group by 1 order by 1")
    assert got.rows == want.rows and len(got.rows) == 3


@pytest.mark.parametrize("kind", ["orc", "parquet"])
def test_null_partition_key_reads_back_as_null(tmp_path, kind):
    """A NULL partition key goes to Hive's default partition and reads
    back as NULL; ``p = 0`` does not read it. The reference routes the
    NULL row by its storage value, under ``p=0``, and reads it back as
    ``(2, 0)``."""
    jr, tr, troot = _runners(tmp_path, kind)
    ctas = ("create table files.default.na with (partitioned_by = "
            "array['p']) as select * from (values (1, 0), "
            "(2, cast(null as bigint))) t(id, p)")
    read = "select id, p from files.default.na order by id"
    for r in (jr, tr):
        r.execute(ctas)
    assert jr.execute(read).rows == [(1, 0), (2, 0)]   # the reference
    assert tr.execute(read).rows == [(1, 0), (2, None)]
    assert sorted(os.listdir(troot / "na")) == [
        "p=0", "p=__HIVE_DEFAULT_PARTITION__"]
    assert tr.execute("select id from files.default.na where p = 0"
                      ).rows == [(1,)]
    assert tr.execute("select id from files.default.na where p is null"
                      ).rows == [(2,)]
    # an INSERT routes the same way; a string key too
    tr.execute("insert into files.default.na values (3, null), (4, 7)")
    assert tr.execute(read).rows == [(1, 0), (2, None), (3, None), (4, 7)]
    tr.execute("create table files.default.ns with (partitioned_by = "
               "array['s']) as select * from (values (1, 'a'), "
               "(2, cast(null as varchar))) t(id, s)")
    assert tr.execute("select id, s from files.default.ns order by id"
                      ).rows == [(1, "a"), (2, None)]
    assert tr.execute("select id from files.default.ns where s = 'a'"
                      ).rows == [(1,)]
