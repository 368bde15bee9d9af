"""The runner's statement surface of presto_tpu_torch against presto_tpu:
views, prepared statements, transactions and EXPLAIN's other forms
(the cases of tests/test_views_prepare.py, test_transactions.py and
test_explain_formats.py, except TYPE DISTRIBUTED and the UI endpoints),
at TPC-H SF 0.01 on the CPU. Every statement runs through both runners
and must give the same rows, or the same error."""
import importlib.util
import json
import pathlib

import pytest

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu_torch.exec.runner import LocalRunner as TRunner
from presto_tpu_torch.exec.scancache import CACHE
from torch_parity import assert_results_match
from torch_retyped import (TPCH_RETYPED, TPCH_RETYPED_JSON,
                           assert_retyped)
from tpch_queries import Q as TPCH

QUERIES = {n: sql for n, sql, _ in TPCH}

SF = 0.01
Q = ("select l_returnflag, count(*) from lineitem, orders "
     "where l_orderkey = o_orderkey group by 1 order by 1")


def _outcome(runner, sql, **kw):
    try:
        return runner.execute(sql, **kw), None
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        return None, e


def both(pair, sql, retyped=None, **kw):
    """Run ``sql`` through the reference and the port: the same rows, or
    the same error (class name and message). Returns the port's result,
    or its error. ``retyped``: the columns whose types differ by design
    (``torch_parity.assert_results_match``)."""
    jr, tr = pair
    want, werr = _outcome(jr, sql, **kw)
    got, gerr = _outcome(tr, sql, **kw)
    if werr is not None or gerr is not None:
        assert werr is not None and gerr is not None, (sql, werr, gerr)
        assert type(gerr).__name__ == type(werr).__name__, (werr, gerr)
        assert str(gerr) == str(werr)
        return gerr
    assert_results_match(got, want, 1e-12, retyped)
    return got


@pytest.fixture()
def pair():
    return JRunner(tpch_sf=SF), TRunner(tpch_sf=SF, device="cpu")


@pytest.fixture(scope="module")
def shared():
    return JRunner(tpch_sf=SF), TRunner(tpch_sf=SF, device="cpu")


# -- views and prepared statements (tests/test_views_prepare.py) -------------

def test_create_select_drop_view(pair):
    both(pair, "create view v1 as select n_name, n_regionkey "
               "from nation where n_nationkey < 5")
    assert both(pair, "select count(*) from v1").rows == [(5,)]
    got = both(pair, "select v1.n_name from v1 join region "
                     "on v1.n_regionkey = region.r_regionkey "
                     "where region.r_name = 'AMERICA' order by 1")
    assert [r[0] for r in got.rows] == ["ARGENTINA", "BRAZIL", "CANADA"]
    both(pair, "drop view v1")
    assert isinstance(both(pair, "select * from v1"), Exception)


def test_view_over_view(pair):
    both(pair, "create view a_nations as "
               "select * from nation where n_name like 'A%'")
    both(pair, "create view al_nations as "
               "select * from a_nations where n_name like 'AL%'")
    assert both(pair, "select n_name from al_nations").rows == [("ALGERIA",)]


def test_or_replace(pair):
    both(pair, "create view v as select 1 as x")
    err = both(pair, "create view v as select 2 as x")
    assert isinstance(err, ValueError) and "already exists" in str(err)
    both(pair, "create or replace view v as select 2 as x")
    # the literal 2 is INTEGER in the port, BIGINT in the reference
    assert both(pair, "select x from v",
                retyped={0: ("bigint", "integer")}).rows == [(2,)]


def test_drop_view_if_exists(pair):
    both(pair, "drop view if exists nope")
    err = both(pair, "drop view nope")
    assert isinstance(err, ValueError) and "does not exist" in str(err)


def test_broken_view_fails_at_create(pair):
    assert isinstance(
        both(pair, "create view bad as select no_such_col from nation"),
        Exception)


def test_view_shows_in_show_tables(pair):
    both(pair, "create view zzz_view as select 1 as x")
    names = [r[0] for r in both(pair, "show tables").rows]
    assert "zzz_view" in names


def test_prepare_execute(pair):
    both(pair, "prepare q1 from "
               "select n_name from nation where n_nationkey = ?")
    assert both(pair, "execute q1 using 3").rows == [("CANADA",)]
    assert both(pair, "execute q1 using 4").rows == [("EGYPT",)]


def test_prepare_multiple_params(pair):
    both(pair, "prepare q2 from select n_name from nation "
               "where n_nationkey = ? or n_name = ? order by 1")
    assert both(pair, "execute q2 using 3, 'PERU'").rows \
        == [("CANADA",), ("PERU",)]


def test_prepare_no_params(pair):
    both(pair, "prepare q3 from select count(*) from region")
    assert both(pair, "execute q3").rows == [(5,)]


def test_describe_input_output(pair):
    both(pair, "prepare q4 from select n_name, n_nationkey + ? as k "
               "from nation where n_regionkey = ?")
    assert len(both(pair, "describe input q4").rows) == 2
    assert [r[0] for r in both(pair, "describe output q4").rows] \
        == ["n_name", "k"]


def test_deallocate(pair):
    both(pair, "prepare q5 from select 1")
    both(pair, "deallocate prepare q5")
    err = both(pair, "execute q5")
    assert isinstance(err, ValueError) and "not found" in str(err)


def test_too_few_parameters(pair):
    both(pair, "prepare q6 from select * from nation where n_nationkey = ?")
    err = both(pair, "execute q6")
    assert isinstance(err, ValueError) and "parameters" in str(err)


def test_unbound_parameter_rejected(pair):
    err = both(pair, "select * from nation where n_nationkey = ?")
    assert type(err).__name__ == "AnalysisError" and "unbound" in str(err)


def test_view_not_captured_by_outer_cte(pair):
    both(pair, "create view vcnt as select count(*) as c from nation")
    assert both(pair, "with nation as (select 1 as x) "
                      "select * from vcnt").rows == [(25,)]


def test_view_cannot_shadow_table(pair):
    err = both(pair, "create view nation as select 1 as x")
    assert isinstance(err, ValueError) and "shadow" in str(err)


def test_prepare_of_execute_rejected(pair):
    err = both(pair, "prepare p from execute p")
    assert isinstance(err, ValueError) and "cannot prepare" in str(err)


def test_describe_view(pair):
    both(pair, "create view dv as select n_name, n_nationkey + 1 as k "
               "from nation")
    assert [r[0] for r in both(pair, "describe dv").rows] == ["n_name", "k"]


def test_too_many_parameters(pair):
    both(pair, "prepare q7 from select ? as a")
    err = both(pair, "execute q7 using 1, 2, 3")
    assert "expected 1 but found 3" in str(err)


def test_or_replace_table_rejected(pair):
    err = both(pair, "create or replace table memory.default.t "
                     "as select 1 as x")
    assert type(err).__name__ == "SqlSyntaxError" and "OR REPLACE" in str(err)


def test_prepare_insert(pair):
    both(pair, "create table memory.default.pt as select 1 as x")
    both(pair, "prepare ins from insert into memory.default.pt select ?")
    both(pair, "execute ins using 42")
    assert both(pair, "select sum(x) from memory.default.pt").rows == [(43,)]


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_q3_view_and_prepared_q6(shared):
    """The smoke's statements: Q3 as a view and Q6 as EXECUTE USING give
    the literal queries' rows (test_torch_runner.py holds those against
    the reference)."""
    chip_smoke = _chip_smoke()
    tr = shared[1]
    tr.execute("create or replace view q3v as " + QUERIES["q3"])
    assert_results_match(
        tr.execute("select * from q3v order by revenue desc, o_orderdate, "
                   "l_orderkey"), tr.execute(QUERIES["q3"]), 0.0)
    tr.execute("prepare q6p from " + chip_smoke.Q6_PREPARED)
    got = tr.execute(f"execute q6p using {chip_smoke.Q6_USING}")
    assert got.rows == tr.execute(QUERIES["q6"]).rows
    assert len(tr.execute("describe input q6p").rows) == 5


def test_smoke_statements_phase_on_the_cpu(capsys):
    """chip_smoke.py's statements phase, rehearsed on the CPU at SF 0.001
    with its every check (the kernels' plain versions stand in for the
    launches it counts on the card)."""
    import torch
    launches = _chip_smoke().phase_statements(torch, sf=0.001,
                                              verify_sf=0.001, device="cpu")
    assert min(launches.values()) > 0
    out = capsys.readouterr().out
    assert "statements verifier SF0.001: {'MATCH': 22}" in out
    assert "CTAS 6200 rows, INSERT 722 rows, count inside 6922, after " \
        "ROLLBACK [6200, 6200] (scan cache on)" in out


# -- transactions (tests/test_transactions.py) -------------------------------

def _count(pair, table):
    return both(pair, f"select count(*) from memory.default.{table}")


def _begin(pair, sql="start transaction"):
    """START TRANSACTION in both: transaction ids are random, so only
    their shape is compared."""
    for r in pair:
        assert r.execute(sql).rows[0][0].startswith("tx_")


def test_commit_keeps_writes(pair):
    _begin(pair)
    both(pair, "create table memory.default.t as "
               "select n_nationkey k from nation")
    both(pair, "insert into memory.default.t select r_regionkey from region")
    assert _count(pair, "t").rows == [(30,)]     # read-your-writes
    both(pair, "commit")
    assert _count(pair, "t").rows == [(30,)]


def test_rollback_restores_snapshot(pair):
    both(pair, "create table memory.default.base as "
               "select r_regionkey k from region")
    _begin(pair)
    both(pair, "insert into memory.default.base "
               "select n_nationkey from nation")
    both(pair, "create table memory.default.scratch as select 1 x")
    assert _count(pair, "base").rows == [(30,)]
    both(pair, "rollback")
    assert _count(pair, "base").rows == [(5,)]   # insert undone
    assert isinstance(_count(pair, "scratch"), Exception)  # create undone


def test_drop_rolled_back(pair):
    both(pair, "create table memory.default.keep as select 1 x")
    _begin(pair)
    both(pair, "drop table memory.default.keep")
    both(pair, "rollback")
    assert _count(pair, "keep").rows == [(1,)]


def test_read_only_rejects_writes(pair):
    _begin(pair, "start transaction read only")
    err = both(pair, "create table memory.default.x as select 1 a")
    assert type(err).__name__ == "TransactionError" and "read-only" in str(err)
    both(pair, "rollback")


def test_isolation_level_parses(pair):
    _begin(pair, "start transaction isolation level serializable, "
                 "read write")
    both(pair, "commit")
    _begin(pair, "start transaction isolation level repeatable read")
    both(pair, "commit")


def test_nested_begin_rejected(pair):
    _begin(pair)
    err = both(pair, "start transaction")
    assert "already in progress" in str(err)
    both(pair, "rollback")


def test_commit_without_tx_rejected(pair):
    err = both(pair, "commit")
    assert type(err).__name__ == "TransactionError"
    assert "no transaction" in str(err)


def test_autocommit_unaffected(pair):
    both(pair, "create table memory.default.ac as select 1 a")
    assert _count(pair, "ac").rows == [(1,)]


def test_rollback_with_warm_scan_cache(pair):
    """CTAS, warm SELECT, BEGIN, INSERT, warm SELECT, ROLLBACK, SELECT:
    the last count is the pre-insert one with the scan cache on, because
    the restore bumps the memory tables' data versions (a warm scan
    would otherwise replay the rolled-back rows' splits)."""
    CACHE.clear()
    both(pair, "create table memory.default.li as "
               "select l_orderkey, l_quantity from lineitem")
    n = _count(pair, "li").rows[0][0]
    stats = pair[1].last_stats
    assert _count(pair, "li").rows == [(n,)]
    assert pair[1].last_stats.cache_hits > 0, stats
    _begin(pair)
    both(pair, "insert into memory.default.li select l_orderkey, "
               "l_quantity from lineitem where l_shipdate >= "
               "date '1998-01-01'")
    grown = _count(pair, "li").rows[0][0]
    assert grown > n
    assert _count(pair, "li").rows == [(grown,)]
    both(pair, "rollback")
    assert _count(pair, "li").rows == [(n,)]
    assert _count(pair, "li").rows == [(n,)]


# -- INSERT with a column list: a fault of the reference ----------------------

def test_insert_column_list_reorders():
    """presto_tpu ignores INSERT's column list and stores the query's
    columns by position, so `insert into t (b, a) select 10, 20` stores
    (a=10, b=20); the port maps the list onto the table's columns and
    stores (a=20, b=10), the row SQL asks for."""
    jr, tr = JRunner(tpch_sf=SF), TRunner(tpch_sf=SF, device="cpu")
    for r in (jr, tr):
        r.execute("create table memory.t as select 1 a, cast(2 as bigint) b")
        r.execute("insert into memory.t (b, a) select 10, 20")
    sql = "select a, b from memory.t order by a"
    assert jr.execute(sql).rows == [(1, 2), (10, 20)]    # the fault
    assert tr.execute(sql).rows == [(1, 2), (20, 10)]


def test_insert_partial_column_list_raises_like_the_reference(pair):
    both(pair, "create table memory.t as select 1 a, cast(2 as bigint) b")
    for r in pair:
        with pytest.raises(ValueError, match="insert schema mismatch"):
            r.execute("insert into memory.t (b) select cast(5 as bigint)")
    both(pair, "insert into memory.t (a, b) select 3, cast(4 as bigint)")
    # column a was made from the literal 1: INTEGER in the port, BIGINT
    # in the reference
    assert both(pair, "select a, b from memory.t order by a",
                retyped={0: ("bigint", "integer")}).rows == [(1, 2), (3, 4)]


# -- EXPLAIN's forms (tests/test_explain_formats.py) --------------------------

def test_explain_validate(shared):
    assert both(shared, f"explain (type validate) {Q}").rows == [(True,)]
    assert isinstance(
        both(shared, "explain (type validate) select nope from nation"),
        Exception)


def test_explain_io_json_graphviz(shared):
    doc = json.loads("\n".join(
        r[0] for r in both(shared, f"explain (type io) {Q}").rows))
    assert {t["table"] for t in doc["inputTableColumnInfos"]} \
        == {"lineitem", "orders"}
    doc = json.loads("\n".join(
        r[0] for r in both(shared, f"explain (format json) {Q}").rows))
    assert doc["name"] == "Output" and doc["children"]
    text = "\n".join(
        r[0] for r in both(shared, f"explain (format graphviz) {Q}").rows)
    assert text.startswith("digraph") and "->" in text


def test_explain_analyze_rejects_options(shared):
    for sql in ("explain (type distributed) analyze select 1",
                "explain (format json) analyze select 1"):
        err = both(shared, sql)
        assert isinstance(err, ValueError) and "ANALYZE" in str(err)


def test_explain_default_unchanged(shared):
    text = "\n".join(r[0] for r in both(shared, f"explain {Q}").rows)
    assert "Output" in text and "TableScan" in text


def test_explain_distributed_names_the_missing_module(shared):
    """EXPLAIN (TYPE DISTRIBUTED) raised naming planner/fragmenter.py
    until the port took the fragmenter; now its text is the reference's
    line for line."""
    jr, tr = shared
    got = tr.execute(f"explain (type distributed) {Q}").rows
    assert got == jr.execute(f"explain (type distributed) {Q}").rows
    assert got[0][0].startswith("Fragment 0 [")


@pytest.mark.parametrize("fmt", ["format json", "format graphviz", "type io"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_explain_forms_equal_reference(shared, name, fmt):
    """EXPLAIN (FORMAT JSON / GRAPHVIZ, TYPE IO) of every TPC-H query:
    the port's document equals the reference's line for line, but for
    the integer literals the port types INTEGER (tests/torch_retyped.py:
    the reference's token beside the port's)."""
    sql = QUERIES[name]
    jr, tr = shared
    want = jr.execute(f"explain ({fmt}) {sql}").rows
    got = tr.execute(f"explain ({fmt}) {sql}").rows
    assert len(want) > 1
    retyped = (TPCH_RETYPED_JSON if fmt == "format json" else
               {} if fmt == "type io" else TPCH_RETYPED).get(name, ())
    assert_retyped([r[0] for r in got], [r[0] for r in want], retyped)
