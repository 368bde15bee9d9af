"""The statements that presto_tpu answered and presto_tpu_torch refused
before this slice, and the surface phase's statements of chip_smoke.py,
through both LocalRunners on the CPU over TPC-H SF 0.01: the same names,
types and rows in the same order. Doubles within rel 1e-12; integers,
strings, dates, decimals and sketch results exactly."""
import importlib.util
import pathlib

import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: each raised NotImplementedError in the port before this slice
REFUSED = [
    "select count(*), count(distinct l_suppkey), sum(distinct l_linenumber)"
    " from lineitem",
    "select l_returnflag, stddev(l_quantity), var_pop(l_discount) "
    "from lineitem group by l_returnflag order by 1",
    "select bool_and(o_totalprice > 1000), bool_or(o_totalprice > 500000) "
    "from orders",
    "select approx_distinct(o_custkey) from orders",
    "select o_orderstatus, approx_percentile(o_totalprice, 0.5) from orders"
    " group by o_orderstatus order by 1",
    "select round(l_extendedprice, 1), sqrt(l_quantity) from lineitem "
    "order by l_orderkey, l_linenumber limit 20",
    "select date_trunc('month', o_orderdate), date_diff('day', o_orderdate,"
    " date '1998-08-02') from orders order by o_orderkey limit 20",
    "select regexp_like(c_name, '00$'), ltrim(c_name) from customer "
    "order by c_custkey limit 20",
    "select json_extract_scalar('{\"a\": 1}', '$.a')",
    "select url_extract_host('http://example.com:8080/x?y=1')",
    "select cast(l_extendedprice as decimal(20,4)) * l_discount "
    "from lineitem order by l_orderkey, l_linenumber limit 20",
    "select cast(1.5 as decimal(30,2)) + cast(2 as decimal(30,2))",
    "select x from unnest(array[1,2,3]) as t(x)",
    "select n_name, x from nation cross join unnest(array[n_nationkey, "
    "n_regionkey]) as t(x) order by 1, 2",
]


#: statements of REFUSED (by index) whose column of integer literals is
#: INTEGER in the port (Presto's LongLiteral typing), BIGINT in the
#: reference: ``unnest(array[1,2,3])``
RETYPED = {12: {0: ("bigint", "integer")}}


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_formerly_refused_statement_matches(runners, i):
    jr, tr = runners
    got = tr.execute(REFUSED[i])
    assert got.rows
    assert_results_match(got, jr.execute(REFUSED[i]), 1e-12,
                         RETYPED.get(i))


@pytest.mark.parametrize("name", [n for n, _ in _smoke().SURFACE_QUERIES])
def test_surface_phase_statement_matches(runners, name):
    sql = dict(_smoke().SURFACE_QUERIES)[name]
    jr, tr = runners
    got = tr.execute(sql)
    assert got.rows
    assert_results_match(got, jr.execute(sql), 1e-12)
