"""The port's memory connector and write statements
(presto_tpu_torch/connectors/memory.py, exec/runner.py): CREATE TABLE AS,
INSERT INTO and DROP TABLE read back the same rows as presto_tpu's
memory catalog, each write bumps the table's data version and reaches
the scan cache, and the page source serves stored batches on the device
asked for."""
import pytest
import torch

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Schema
from presto_tpu_torch.connectors import spi
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.spi import Split, TableHandle
from presto_tpu_torch.exec.runner import LocalRunner

from torch_parity import assert_results_match

SF = 0.01


@pytest.fixture(scope="module")
def runners():
    return JRunner(tpch_sf=SF), LocalRunner(tpch_sf=SF, device="cpu")


def _both(runners, sql, **kw):
    """The statement's result in presto_tpu and in the port."""
    jr, tr = runners
    return jr.execute(sql, **kw), tr.execute(sql, **kw)


def _same(runners, sql, rel=1e-12, retyped=None):
    want, got = _both(runners, sql)
    assert_results_match(got, want, rel, retyped)
    return got


_WRITES = [
    # (CTAS source, INSERT source, read-back query)
    ("select l_orderkey, l_partkey, l_quantity, l_extendedprice, "
     "l_returnflag, l_shipdate from lineitem where l_quantity < 10",
     "select l_orderkey, l_partkey, l_quantity, l_extendedprice, "
     "l_returnflag, l_shipdate from lineitem where l_quantity > 45",
     "select l_returnflag, count(*), sum(l_quantity), "
     "sum(l_extendedprice), min(l_shipdate), max(l_orderkey) "
     "from memory.w_{i} group by l_returnflag order by 1"),
    ("select n_nationkey, n_name, n_regionkey from nation",
     "select n_nationkey + 100, n_name, n_regionkey from nation "
     "where n_regionkey = 2",
     "select n_regionkey, count(*), max(n_name) from memory.w_{i} "
     "group by 1 order by 1"),
    ("select o_orderkey, o_totalprice, o_orderpriority from orders "
     "where o_orderdate < date '1993-01-01'",
     "select o_orderkey, o_totalprice, o_orderpriority from orders "
     "where o_orderdate >= date '1998-06-01'",
     "select o_orderpriority, count(*), sum(o_totalprice) "
     "from memory.w_{i} group by 1 order by 1"),
]


@pytest.mark.parametrize("i", range(len(_WRITES)))
def test_ctas_insert_read_back_matches_reference(runners, i):
    ctas, insert, read = (s.format(i=i) for s in _WRITES[i])
    _both(runners, f"drop table if exists memory.w_{i}")
    # the write statements return their row counts
    _same(runners, f"create table memory.w_{i} as {ctas}")
    first = _same(runners, read)
    assert first.rows
    _same(runners, read)                            # the warm read
    _same(runners, f"insert into memory.w_{i} {insert}")
    second = _same(runners, read)
    assert second.rows != first.rows
    _same(runners, f"select count(*) from memory.w_{i}")
    _both(runners, f"drop table memory.w_{i}")


def test_insert_reads_its_own_table_as_a_snapshot(runners):
    _both(runners, "drop table if exists memory.snap")
    _same(runners, "create table memory.snap as select r_regionkey, "
                   "r_name from region")
    # INSERT INTO t SELECT ... FROM t reads the rows from before it
    _same(runners, "insert into memory.snap select r_regionkey + 10, "
                   "r_name from memory.snap")
    got = _same(runners, "select count(*), sum(r_regionkey) from memory.snap")
    assert got.rows == [(10, 10 + 60)]
    _both(runners, "drop table memory.snap")


def test_drop_and_create_if_not_exists(runners):
    _both(runners, "drop table if exists memory.d")
    _same(runners, "create table memory.d as select 1 as a")
    # IF NOT EXISTS on an existing table writes nothing
    _same(runners, "create table if not exists memory.d as select 2 as a")
    # a was made from the literal 1: INTEGER in the port, BIGINT in the
    # reference
    _same(runners, "select a from memory.d",
          retyped={0: ("bigint", "integer")})
    for r in runners:
        with pytest.raises(ValueError, match="already exists"):
            r.execute("create table memory.d as select 3 as a")
    _both(runners, "drop table memory.d")
    for r in runners:
        with pytest.raises(KeyError):
            r.execute("drop table memory.d")
        r.execute("drop table if exists memory.d")


def test_write_errors_match_reference(runners):
    _both(runners, "drop table if exists memory.e")
    _both(runners, "create table memory.e as select n_nationkey from nation")
    for r in runners:
        with pytest.raises(ValueError, match="schema mismatch"):
            r.execute("insert into memory.e select n_name from nation")
        with pytest.raises(ValueError, match="not writable"):
            r.execute("create table tpch.default.x as select 1 as a")
    _both(runners, "drop table memory.e")


def test_each_write_bumps_version_and_notifies():
    conn = MemoryConnector()
    seen = []
    spi.on_data_change(lambda c, t: seen.append(t) if c is conn else None)
    schema = Schema([("a", T.BIGINT)])
    b = Batch.from_pydict({"a": (T.BIGINT, [1, 2, 3])},
                          device=torch.device("cpu"))
    assert conn.data_version("t") == 0
    conn.create_table("t", schema)
    v1 = conn.data_version("t")
    assert conn.append("t", b) == 3
    v2 = conn.data_version("t")
    conn.drop_table("t")
    assert 0 < v1 < v2 < conn.data_version("t")
    assert seen == ["t", "t", "t"]


def test_page_source_selects_columns_on_the_device_asked_for():
    conn = MemoryConnector()
    cpu = torch.device("cpu")
    b = Batch.from_pydict({"a": (T.BIGINT, [1, None]),
                           "s": (T.VARCHAR, ["x", "y"])}, device=cpu)
    conn.create_table("t", b.schema)
    conn.append("t", b)
    split = conn.split_manager.splits(TableHandle("memory", "default",
                                                  "t"))[0]
    assert split == Split(TableHandle("memory", "default", "t"), (0,))
    out = list(conn.page_source(split, ["s"], device="meta").batches())
    assert len(out) == 1
    assert out[0].schema.names == ["s"]
    assert out[0].device.type == "meta"
    back = list(conn.page_source(split, ["s", "a"], device=cpu).batches())
    assert back[0].to_pylist() == [("x", 1), ("y", None)]


def test_write_statements_outside_the_port_raise(runners):
    """INSERT with a column list and START TRANSACTION are ported: an
    INSERT into a missing table raises the reference's KeyError, and a
    transaction begins and rolls back."""
    jr, tr = runners
    for r in (jr, tr):
        with pytest.raises(KeyError, match="'nope' does not exist"):
            r.execute("insert into memory.nope (a) select 1")
    assert tr.execute("start transaction").rows[0][0].startswith("tx_")
    assert tr.execute("rollback").rows == [(True,)]


def test_insert_coerces_to_the_tables_types(runners):
    """INSERT widens varchar(1) into a varchar(25) column and an integer
    into a bigint, as Presto does. The reference compares the type
    displays exactly and raises; the port inserts the row. A type with
    no implicit coercion still raises the same error in both."""
    jr, tr = runners
    ctas = ("create table memory.default.co as select n_nationkey k, "
            "n_name name, n_regionkey r from nation")
    insert = "insert into memory.default.co select 999, 'X', 9"
    for r in runners:
        r.execute(ctas)
    with pytest.raises(ValueError, match="insert schema mismatch"):
        jr.execute(insert)                     # the reference's answer
    assert tr.execute(insert).rows == [(1,)]
    assert tr.execute("select k, name, r from memory.default.co "
                      "where k = 999").rows == [(999, "X", 9)]
    tr.execute("insert into memory.default.co "
               "select cast(1000 as integer), 'Y', cast(1 as smallint)")
    got = tr.execute("select k, name, r from memory.default.co "
                     "where k >= 999 order by k")
    assert got.rows == [(999, "X", 9), (1000, "Y", 1)]
    assert [t.display() for t in got.types] == [
        "bigint", "varchar(25)", "bigint"]
    for r in runners:
        with pytest.raises(ValueError, match="insert schema mismatch"):
            r.execute("insert into memory.default.co "
                      "select 1.5, 'Z', 1")
