"""The scalar functions through presto_tpu and presto_tpu_torch on the
CPU: the port registers every function name the reference registers
(functions.py and array_functions.py), and statements over TPC-H SF 0.01
that exercise them about ten at a time (math and bitwise, dates and
times, the vocabulary string functions with regex and Presto's
replacement syntax, JSON and URL, casts) return the same names, types
and rows. Doubles within rel 1e-12 (cbrt: the port takes x^(1/3), the
reference XLA's cbrt), everything else exactly."""
import pytest

import presto_tpu.expr.compiler  # noqa: F401  (registers array functions)
import presto_tpu_torch.expr.compiler  # noqa: F401
from presto_tpu.exec.runner import LocalRunner
from presto_tpu.expr import functions as JF
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.expr import functions as TF

from torch_parity import assert_results_match


def test_registry_holds_every_reference_name():
    missing = sorted(set(JF._REGISTRY) - set(TF._REGISTRY))
    assert not missing, missing
    assert len(TF._REGISTRY) >= len(JF._REGISTRY)


@pytest.mark.parametrize("name", sorted(JF._REGISTRY))
def test_registered_name_infers_like_reference(name):
    """Return-type inference agrees wherever the reference's does."""
    from presto_tpu import types as JT
    from presto_tpu_torch import types as TT
    for args in ([JT.DOUBLE], [JT.BIGINT, JT.BIGINT], [JT.VARCHAR]):
        try:
            want = JF.infer_call_type(name, args)
        except Exception:          # noqa: BLE001 - not this arity
            continue
        got = TF.infer_call_type(name, [TT.parse_type(t.display())
                                        for t in args])
        assert got.display() == want.display()


SQL = {
    "math":
        "select round(l_extendedprice, 1), sqrt(l_quantity), "
        "round(l_discount), floor(l_tax * 100), ceil(l_extendedprice), "
        "power(l_quantity, 2), ln(l_quantity), exp(l_discount), "
        "log2(l_extendedprice), log10(l_extendedprice), "
        "log(3, l_quantity), truncate(l_extendedprice, 1) "
        "from lineitem order by l_orderkey, l_linenumber limit 50",
    "trig_and_tests":
        "select sin(o_totalprice), cos(1.0), tan(0.5), asin(0.5), "
        "acos(0.5), atan(2.0), atan2(1.0, 2.0), sinh(0.5), cosh(0.5), "
        "tanh(0.5), degrees(1.0), radians(90.0), "
        "sign(o_totalprice - 100000), is_nan(o_totalprice), "
        "is_finite(o_totalprice), is_infinite(o_totalprice / 0) "
        "from orders order by o_orderkey limit 40",
    "buckets_and_extremes":
        "select width_bucket(o_totalprice, 0, 500000, 10), "
        "greatest(o_orderkey, o_custkey), least(o_totalprice, 100000), "
        "greatest(o_shippriority, 1), abs(o_custkey - 700), "
        "sign(o_custkey - 700), cbrt(o_totalprice) "
        "from orders order by o_orderkey limit 40",
    "bitwise":
        "select bitwise_and(o_orderkey, 7), bitwise_or(o_orderkey, 8), "
        "bitwise_xor(o_orderkey, 5), bitwise_not(o_orderkey), "
        "bitwise_left_shift(o_orderkey, 2), "
        "bitwise_right_shift(-o_orderkey, 3), "
        "bitwise_arithmetic_shift_right(-o_orderkey, 3), "
        "bit_count(o_orderkey), bit_count(-o_orderkey, 64), "
        "bit_count(o_orderkey, 8) from orders order by o_orderkey limit 40",
    "dates":
        "select date_trunc('month', o_orderdate), "
        "date_diff('day', o_orderdate, date '1998-12-31'), "
        "date_diff('month', o_orderdate, date '1998-12-31'), "
        "date_diff('year', date '1992-01-01', o_orderdate), "
        "date_diff('quarter', o_orderdate, date '1992-01-01'), "
        "day_of_week(o_orderdate), day_of_year(o_orderdate), "
        "week(o_orderdate), year_of_week(o_orderdate), "
        "last_day_of_month(o_orderdate) from orders "
        "order by o_orderkey limit 60",
    "date_trunc_and_add":
        "select date_trunc('quarter', o_orderdate) q, "
        "date_trunc('year', o_orderdate) y, "
        "date_trunc('week', o_orderdate) w, "
        "date_add('month', 1, o_orderdate), date_add('day', 3, o_orderdate),"
        " date_add('year', -1, o_orderdate), count(*) from orders "
        "group by 1, 2, 3, 4, 5, 6 order by 1, 2, 3, 4, 5, 6 limit 40",
    "timestamps":
        "select hour(timestamp '2020-01-02 03:04:05.678'), "
        "minute(timestamp '2020-01-02 03:04:05.678'), "
        "second(timestamp '2020-01-02 03:04:05.678'), "
        "millisecond(timestamp '2020-01-02 03:04:05.678'), "
        "to_unixtime(timestamp '2020-01-02 03:04:05'), "
        "from_unixtime(1577934245), "
        "date_trunc('hour', timestamp '2020-01-02 03:04:05'), "
        "date_add('hour', 5, timestamp '2020-01-02 03:04:05'), "
        "date_diff('minute', timestamp '2020-01-02 03:04:05', "
        "timestamp '2020-01-03 01:00:00'), "
        "day_of_week(timestamp '2020-01-05 23:00:00')",
    "strings":
        "select regexp_like(c_name, '00$'), ltrim(c_name), rtrim(c_name), "
        "reverse(c_name), lpad(c_mktsegment, 12, '*'), "
        "rpad(c_mktsegment, 3), replace(c_name, 'Customer', 'C'), "
        "strpos(c_name, '#'), split_part(c_name, '#', 2), "
        "starts_with(c_name, 'Cust'), ends_with(c_name, '9') "
        "from customer order by c_custkey limit 60",
    "regex_and_distances":
        "select regexp_extract(c_phone, '([0-9]+)-([0-9]+)', 2), "
        "regexp_replace(c_name, 'Customer#0*([0-9]+)', 'c$1'), "
        "regexp_replace(c_phone, '-', '\\$'), codepoint(c_mktsegment), "
        "levenshtein_distance(c_mktsegment, 'BUILDING'), "
        "hamming_distance(c_mktsegment, 'BUILDING'), "
        "translate(c_mktsegment, 'AEI', 'aei'), length(to_utf8(c_name)), "
        "from_utf8(to_utf8(c_mktsegment)) "
        "from customer order by c_custkey limit 60",
    "json_and_url":
        "select json_extract_scalar('{\"a\": 1}', '$.a'), "
        "json_extract_scalar('{\"a\": {\"b\": [1, 2, \"x\"]}}', '$.a.b[2]'),"
        " json_extract_scalar('{\"a\": true}', '$.a'), "
        "json_extract_scalar('[1,2]', '$[5]'), "
        "url_extract_host('http://example.com:8080/path?q=1#f'), "
        "url_extract_port('http://example.com:8080/path'), "
        "url_extract_protocol('https://x.org/a'), "
        "url_extract_path('http://example.com/p/q'), "
        "url_extract_query('http://a.b/c?x=1&y=2'), "
        "url_extract_fragment('http://a.b/c#frag')",
    "functions_in_group_by":
        "select date_trunc('month', o_orderdate) m, count(*), "
        "round(sum(o_totalprice), 1), sqrt(sum(o_totalprice)), "
        "max(date_diff('day', o_orderdate, date '1998-12-31')), "
        "min(ltrim(o_clerk)), json_extract_scalar('{\"a\": 1}', '$.a'), "
        "url_extract_host('http://example.com/x') from orders "
        "where regexp_like(o_comment, 'special') group by 1 order by 1",
}


#: columns typed INTEGER in the port where the reference says BIGINT: an
#: INTEGER literal (Presto's LongLiteral typing) meets an INTEGER column,
#: as in ``greatest(o_shippriority, 1)``
RETYPED = {
    "buckets_and_extremes": {3: ("bigint", "integer")},
}


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


@pytest.mark.parametrize("name", list(SQL))
def test_function_sql_matches_reference(runners, name):
    jr, tr = runners
    got = tr.execute(SQL[name])
    assert got.rows
    assert_results_match(got, jr.execute(SQL[name]), 1e-12,
                         RETYPED.get(name))
