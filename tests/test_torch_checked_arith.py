"""Checked arithmetic in presto_tpu_torch: statements where presto_tpu
gives a wrong row and the port gives Presto's answer or Presto's named
error. Each case runs through both LocalRunners on the CPU over TPC-H SF
0.01: the reference's row is asserted first (it stays as it is), then
the port's.

Presto's behaviour is that of its scalar operators and aggregations:
``DoubleOperators.castToLong`` / ``castToInteger`` and ``DecimalCasts``
(INVALID_CAST_ARGUMENT), ``BigintOperators.add`` and
``LongSumAggregation`` (``Math.addExact``: NUMERIC_VALUE_OUT_OF_RANGE),
``StringFunctions.substr``, and the analyzer's refusal of ``date ±
date``."""
import datetime
from decimal import Decimal

import pytest

from presto_tpu.exec.runner import LocalRunner
from presto_tpu_torch.errors import QueryError
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner

from torch_parity import assert_results_match

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
I32_MAX = (1 << 31) - 1
I32_MIN = -(1 << 31)


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


def _raises(port, sql: str, name: str) -> None:
    with pytest.raises(QueryError) as ei:
        port.execute(sql)
    assert ei.value.name == name, (sql, ei.value.name)


def _ref_rows(ref, sql: str, head: int):
    return [tuple(r) for r in ref.execute(sql).rows[:head]]


#: (statement, the reference's first rows): the reference saturates
#: where the port raises INVALID_CAST_ARGUMENT
DOUBLE_CASTS = [
    ("select cast(1e10 as integer)", [(I32_MAX,)]),
    ("select cast(1e20 as bigint)", [(I64_MAX,)]),
    ("select cast(-1e10 as integer)", [(I32_MIN,)]),
    ("select cast(cast(n_nationkey as double) * 1e9 as integer) "
     "from nation order by n_nationkey",
     [(0,), (1000000000,), (2000000000,), (I32_MAX,)]),
    ("select cast(cast(n_nationkey as real) * 1e9 as integer) "
     "from nation order by n_nationkey",
     [(0,), (1000000000,), (2000000000,), (I32_MAX,)]),
]


@pytest.mark.parametrize("sql,ref_head", DOUBLE_CASTS)
def test_out_of_range_double_cast_raises_invalid_cast_argument(
        runners, sql, ref_head):
    ref, port = runners
    assert _ref_rows(ref, sql, len(ref_head)) == ref_head
    _raises(port, sql, "INVALID_CAST_ARGUMENT")


@pytest.mark.parametrize("sql", [
    "select cast(nan() as bigint)",
    "select cast(infinity() as integer)",
    "select cast(cast(n_nationkey as double) / 0e0 as bigint) from nation",
    "select cast(1e30 as decimal(10,2))",
    "select cast(cast(n_nationkey as double) * 1e9 as decimal(10,0)) "
    "from nation",
    "select cast(1e300 as decimal(38,2))",
])
def test_non_finite_and_decimal_double_casts_raise(runners, sql):
    _raises(runners[1], sql, "INVALID_CAST_ARGUMENT")


def test_in_range_double_casts_keep_their_rows(runners):
    ref, port = runners
    sql = ("select cast(cast(n_nationkey as double) * 8e7 + 0.5e0 "
           "as integer), cast(n_nationkey * -2.5e0 as bigint), "
           "cast(n_nationkey * 1.25e0 as decimal(10,2)) "
           "from nation order by n_nationkey")
    assert_results_match(port.execute(sql), ref.execute(sql))


#: (statement, the reference's row, Presto's row): the reference divides
#: short decimals through float64 and loses the digits past 2^53
DECIMAL_DIVISIONS = [
    ("select cast(999999999999999999 as decimal(18,0)) "
     "/ cast(3 as decimal(1,0))",
     (Decimal("333333333333333312"),), (Decimal("333333333333333333"),)),
    ("select cast(9007199254740993 as decimal(16,0)) "
     "/ cast(1 as decimal(1,0))",
     (Decimal("9007199254740992"),), (Decimal("9007199254740993"),)),
    ("select cast(12345678901234.5678 as decimal(18,4)) "
     "/ cast(3 as decimal(1,0))",
     (Decimal("4115226300411.5224"),), (Decimal("4115226300411.5226"),)),
]


@pytest.mark.parametrize("sql,ref_row,presto_row", DECIMAL_DIVISIONS)
def test_short_decimal_division_is_exact(runners, sql, ref_row, presto_row):
    ref, port = runners
    assert _ref_rows(ref, sql, 1) == [ref_row]
    assert [tuple(r) for r in port.execute(sql).rows] == [presto_row]


def test_short_decimal_division_keeps_rows_that_fit(runners):
    """Quotients that float64 gave right stay bit-identical: half-up
    rounding away from zero, negative divisors, a wide divisor."""
    ref, port = runners
    sql = ("select cast(o_totalprice as decimal(12,2)) "
           "/ cast(o_custkey as decimal(10,0)), "
           "cast(-o_custkey as decimal(10,0)) / cast(4 as decimal(1,0)), "
           "cast(o_custkey as decimal(10,0)) / cast(-8 as decimal(2,1)), "
           "cast(o_orderkey as decimal(12,2)) / 7 "
           "from orders order by o_orderkey")
    assert_results_match(port.execute(sql), ref.execute(sql))


def test_short_decimal_division_by_zero(runners):
    _, port = runners
    sql = "cast(n_nationkey as decimal(3,0)) / cast(0 as decimal(3,0))"
    _raises(port, f"select {sql} from nation", "DIVISION_BY_ZERO")
    rows = port.execute(f"select try({sql}) from nation").rows
    assert rows == [(None,)] * 25


#: (statement, the reference's rows, Presto's rows): StringFunctions.substr
#: counts a negative start from the end, and a start of 0 gives ''
SUBSTRS = [
    ("select substr('hello', -3)", [("ello",)], [("llo",)]),
    ("select substr('hello', -3, 2)", [("el",)], [("ll",)]),
    ("select substr('hello', 0)", [("o",)], [("",)]),
    ("select substr(n_name, -3) from nation order by n_nationkey",
     [("ERIA",), ("TINA",)], [("RIA",), ("INA",)]),
]


@pytest.mark.parametrize("sql,ref_head,presto_head", SUBSTRS)
def test_substr_counts_a_negative_start_from_the_end(runners, sql, ref_head,
                                                     presto_head):
    ref, port = runners
    assert _ref_rows(ref, sql, len(ref_head)) == ref_head
    assert _ref_rows(port, sql, len(presto_head)) == presto_head


def test_substr_edges(runners):
    _, port = runners
    rows = port.execute(
        "select substr('hello', -9), substr('hello', 2, 0), "
        "substr('hello', 2, -1), substr('héllo', -4, 2), "
        "substr('hello', 9), substr('hello', 2, 3), substr('hello', -1)"
    ).rows
    assert [tuple(r) for r in rows] == [("", "", "", "él", "", "ell", "o")]


#: (statement, the reference's first row): DATE ± DATE was typed DATE;
#: Presto has no such operator and refuses the statement at analysis
DATE_PAIRS = [
    ("select date '2020-01-05' - date '2020-01-01'",
     (datetime.date(1970, 1, 5),)),
    ("select date '2020-01-05' + date '2020-01-01'",
     (datetime.date(2070, 1, 4),)),
    ("select o_orderdate - date '1995-01-01' from orders "
     "order by o_orderkey limit 2", (datetime.date(1968, 11, 22),)),
]


@pytest.mark.parametrize("sql,ref_row", DATE_PAIRS)
def test_date_plus_minus_date_raises_at_analysis(runners, sql, ref_row):
    ref, port = runners
    assert _ref_rows(ref, sql, 1) == [ref_row]
    with pytest.raises(TypeError):
        port.execute(sql)


def test_date_interval_arithmetic_keeps_its_types(runners):
    ref, port = runners
    sql = ("select o_orderdate - interval '3' day, "
           "o_orderdate + interval '2' month from orders "
           "order by o_orderkey limit 5")
    assert_results_match(port.execute(sql), ref.execute(sql))


#: (statement, the reference's first rows): integral arithmetic and
#: narrowing casts wrap in the reference; the port raises
#: NUMERIC_VALUE_OUT_OF_RANGE
INTEGRAL_OVERFLOWS = [
    ("select cast(9223372036854775807 as bigint) + 1", [(I64_MIN,)]),
    ("select cast(2147483647 as integer) + cast(1 as integer)",
     [(I32_MIN,)]),
    ("select abs(cast(-9223372036854775808 as bigint))", [(I64_MIN,)]),
    ("select cast(-9223372036854775808 as bigint) / -1", [(I64_MIN,)]),
    ("select 9223372036854775807 * 2", [(-2,)]),
    ("select cast(300 as tinyint)", [(300,)]),
    ("select cast(3000000000 as integer)", [(-1294967296,)]),
    ("select cast(o_orderkey as bigint) * 4611686018427387904 "
     "from orders order by o_orderkey",
     [(1 << 62,), (I64_MIN,), (-(1 << 62),)]),
]


@pytest.mark.parametrize("sql,ref_head", INTEGRAL_OVERFLOWS)
def test_integral_overflow_raises_numeric_value_out_of_range(
        runners, sql, ref_head):
    ref, port = runners
    assert _ref_rows(ref, sql, len(ref_head)) == ref_head
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")


@pytest.mark.parametrize("expr,want", [
    ("-cast(-9223372036854775808 as bigint)", None),
    ("cast(-9223372036854775807 as bigint) - 2", None),
    ("cast(3037000500 as bigint) * 3037000500", None),
    ("cast(-128 as tinyint) / cast(-1 as tinyint)", None),
    ("-cast(-128 as tinyint)", None),
    ("cast(100 as tinyint) + cast(100 as tinyint)", None),
    ("cast(-32768 as smallint) * cast(-1 as smallint)", None),
    ("cast(o_orderkey as integer) + cast(2147483600 as integer)", None),
    ("cast(-9223372036854775808 as bigint) / 2", -(1 << 62)),
    ("cast(-9223372036854775807 as bigint) / 2", -((1 << 62) - 1)),
    ("cast(-3037000499 as bigint) * 3037000499", -3037000499 ** 2),
    ("cast(-4611686018427387904 as bigint) * 2", I64_MIN),
    ("cast(-9223372036854775807 as bigint) - 1", I64_MIN),
    ("cast(-128 as tinyint) / cast(2 as tinyint)", -64),
    ("cast(-9223372036854775808 as bigint) % -1", 0),
    ("-cast(-127 as tinyint)", 127),
    ("cast(2147483647 as integer) * cast(-1 as integer)", -I32_MAX),
])
def test_integral_edges(runners, expr, want):
    """Results at the edge of each type's range: those that fit are
    exact (integer division truncates toward zero), the others raise."""
    _, port = runners
    sql = f"select {expr} from orders order by o_orderkey limit 9"
    if want is None:
        _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    else:
        assert [r[0] for r in port.execute(sql).rows] == [want] * 9


#: TRY of every raising statement above gives NULL in the port, where the
#: reference gives its wrong row
TRY_FORMS = [
    ("try(cast(1e10 as integer))", [(I32_MAX,)], [(None,)]),
    ("try(cast(nan() as bigint))", None, [(None,)]),
    ("try(cast(cast(n_nationkey as double) * 1e9 as integer)) "
     "from nation order by n_nationkey",
     [(0,), (1000000000,), (2000000000,), (I32_MAX,)],
     [(0,), (1000000000,), (2000000000,), (None,)]),
    ("try(cast(9223372036854775807 as bigint) + 1)", [(I64_MIN,)],
     [(None,)]),
    ("try(cast(2147483647 as integer) + cast(1 as integer))", [(I32_MIN,)],
     [(None,)]),
    ("try(abs(cast(-9223372036854775808 as bigint)))", [(I64_MIN,)],
     [(None,)]),
    ("try(cast(-9223372036854775808 as bigint) / -1)", [(I64_MIN,)],
     [(None,)]),
    ("try(cast(300 as tinyint))", [(300,)], [(None,)]),
    ("try(cast(3000000000 as integer))", [(-1294967296,)], [(None,)]),
    ("try(cast(o_orderkey as bigint) * 4611686018427387904) "
     "from orders order by o_orderkey",
     [(1 << 62,), (I64_MIN,)], [(1 << 62,), (None,)]),
]


@pytest.mark.parametrize("body,ref_head,port_head", TRY_FORMS)
def test_try_gives_null(runners, body, ref_head, port_head):
    ref, port = runners
    sql = f"select {body}"
    if ref_head is not None:
        assert _ref_rows(ref, sql, len(ref_head)) == ref_head
    assert _ref_rows(port, sql, len(port_head)) == port_head


# -- checked integral sums ---------------------------------------------------

def _wrap64(v: int) -> int:
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


#: a bigint whose per-group sums leave int64 at SF 0.01 (each value fits)
BIG = "cast(o_orderkey as bigint) * 100000000000000"
#: a grouping key with no stats bounds: the sort path
SORT_KEY = "o_custkey % 5"

#: (statement, the reference's first rows): the reference's sums wrap
SUM_OVERFLOWS = [
    ("select k, sum(x) from (values (1, 9223372036854775807), (1, 1)) "
     "t(k, x) group by k", [(1, I64_MIN)]),
    ("select sum(x) from (values 9223372036854775807, 1) t(x)",
     [(I64_MIN,)]),
    ("select k, sum(x) over (order by k) from (values "
     "(1, 9223372036854775807), (2, 1)) t(k, x) order by k",
     [(1, I64_MAX), (2, I64_MIN)]),
]


@pytest.mark.parametrize("sql,ref_head", SUM_OVERFLOWS)
def test_sum_overflow_raises(runners, sql, ref_head):
    ref, port = runners
    assert _ref_rows(ref, sql, len(ref_head)) == ref_head
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")


def _exact_sums(runner, key: str, value: str):
    """{key: exact Python sum of value} over orders."""
    out = {}
    for k, v in runner.execute(
            f"select {key}, {value} from orders").rows:
        out[k] = out.get(k, 0) + int(v)
    return out


#: column-level sums: (name, statement over orders, grouping key or None)
COLUMN_SUMS = [
    ("sort_path", f"select {SORT_KEY} k, sum({{v}}) from orders "
     "group by 1 order by 1", SORT_KEY),
    ("dense_path", "select o_orderstatus k, sum({v}) from orders "
     "group by 1 order by 1", "o_orderstatus"),
    ("global", "select sum({v}) from orders", None),
]


@pytest.mark.parametrize("name,template,key", COLUMN_SUMS,
                         ids=[c[0] for c in COLUMN_SUMS])
def test_column_sum_overflow_raises(runners, name, template, key):
    """The reference's rows are the exact sums wrapped mod 2^64; the port
    raises. On the sort path the planes go through the segment-sum
    kernel's wrapper (its plain version on the CPU)."""
    from presto_tpu_torch.ops import scan
    ref, port = runners
    sql = template.format(v=BIG)
    exact = _exact_sums(ref, key or "0", BIG)
    if key is None:
        want = [(_wrap64(exact[0]),)]
    else:
        want = [(k, _wrap64(exact[k])) for k in sorted(exact)]
    got = [tuple(r) for r in ref.execute(sql).rows]
    assert got == want
    assert any(_wrap64(v) != v for v in exact.values())
    before = scan.plain_calls
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    if name == "sort_path":
        assert scan.plain_calls > before


@pytest.mark.parametrize("name,template,key", COLUMN_SUMS,
                         ids=[c[0] for c in COLUMN_SUMS])
def test_column_sum_near_the_edge_fits(runners, name, template, key):
    """o_orderkey scaled so that the largest group's sum lies within one
    factor of the int64 edge: the port's rows equal the reference's,
    which are then the exact sums."""
    from presto_tpu_torch.ops import scan
    ref, port = runners
    keys = _exact_sums(ref, key or "0", "o_orderkey")
    factor = I64_MAX // max(keys.values())
    value = f"cast(o_orderkey as bigint) * {factor}"
    exact = {k: v * factor for k, v in keys.items()}
    assert max(exact.values()) > I64_MAX - factor
    sql = template.format(v=value)
    before = scan.plain_calls
    got = port.execute(sql)
    assert_results_match(got, ref.execute(sql))
    if key is None:
        assert [tuple(r) for r in got.rows] == [(exact[0],)]
    else:
        assert [tuple(r) for r in got.rows] == sorted(exact.items())
    if name == "sort_path":
        assert scan.plain_calls > before


def test_windowed_column_sum_overflow_raises(runners):
    ref, port = runners
    sql = (f"select o_orderkey, sum({BIG}) over (partition by "
           "o_orderstatus order by o_orderkey) from orders "
           "order by o_orderkey")
    exact = {}
    running = {}
    for k, st in ref.execute("select o_orderkey, o_orderstatus from orders "
                             "order by o_orderkey").rows:
        running[st] = running.get(st, 0) + int(k) * 100000000000000
        exact[k] = running[st]
    rows = ref.execute(sql).rows
    assert [(k, v) for k, v in rows] == [(k, _wrap64(exact[k]))
                                         for k, _ in rows]
    assert any(_wrap64(v) != v for v in exact.values())
    _raises(port, sql, "NUMERIC_VALUE_OUT_OF_RANGE")
    fits = sql.replace(BIG, "cast(o_orderkey as bigint)")
    assert_results_match(port.execute(fits), ref.execute(fits))


def test_sum_that_overflows_and_comes_back_fits(runners):
    """A group's exact sum is what is checked: (2^63-1, 1, -5) fits, as
    it does in the reference (whose wrapping sum lands on the same
    bits). Presto's row-by-row addExact raises on some orders of these
    rows; that difference is agreed (ROADMAP §3)."""
    ref, port = runners
    sql = ("select k, sum(x) from (values (1, 9223372036854775807), "
           "(1, 1), (1, -5), (2, -9223372036854775807), (2, -1)) t(k, x) "
           "group by k order by k")
    # k is a VALUES column of integer literals: INTEGER in the port,
    # BIGINT in the reference
    assert_results_match(port.execute(sql), ref.execute(sql),
                         retyped={0: ("bigint", "integer")})
    assert [tuple(r) for r in port.execute(sql).rows] == [
        (1, I64_MAX - 4), (2, I64_MIN)]


@pytest.mark.parametrize("name,template,key", COLUMN_SUMS,
                         ids=[c[0] for c in COLUMN_SUMS])
def test_mesh_sum_overflow_raises(runners, monkeypatch, name, template,
                                  key):
    """On a 4-slot mesh: partial and final on the slots, the dense
    path's fused waves included."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    monkeypatch.setenv("PRESTO_TPU_TORCH_MESH_SLOTS", "4")
    _, port = runners
    props = {"mesh_execution": "on", "mesh_devices": 4}
    selected = REGISTRY.counter("mesh_path_selected_total")
    before = selected.value
    with pytest.raises(QueryError) as ei:
        port.execute(template.format(v=BIG), properties=props)
    assert ei.value.name == "NUMERIC_VALUE_OUT_OF_RANGE"
    assert selected.value > before
    fits = template.format(v="cast(o_orderkey as bigint)")
    assert port.execute(fits, properties=props).rows == \
        port.execute(fits).rows


def test_cluster_sum_overflow_raises():
    """In the cluster the worker task fails with the row error and the
    coordinator fails the statement with its name, with no retry; the
    reference's cluster gives the wrapped sums."""
    from torch_cluster import Clusters
    clusters = Clusters(0.01)
    try:
        sql = (f"select {SORT_KEY} k, sum({BIG}) from orders "
               "group by 1 order by 1")
        exact = _exact_sums(clusters.ref, SORT_KEY, BIG)
        assert [tuple(r) for r in clusters.ref.execute(sql).rows] == [
            (k, _wrap64(exact[k])) for k in sorted(exact)]
        with pytest.raises(QueryError) as ei:
            clusters.port.execute(sql)
        assert ei.value.name == "NUMERIC_VALUE_OUT_OF_RANGE"
        assert clusters.port._last_run_info["retries"] == 0
        clusters.check(sql.replace(BIG, "cast(o_orderkey as bigint)"))
    finally:
        clusters.stop()


@pytest.mark.parametrize("reducer", ["slot", "seg", "global"])
def test_plane_sum_matches_python_integers(reducer):
    """checked_sum_i64 over seeded int64 values near ±2^63 and small
    ones, through each reducer on the CPU: the overflow flag is set
    exactly where the Python sum leaves int64, the value is the exact
    sum where it fits, and its bits are always those of the plain
    wrapping sum."""
    import numpy as np
    import torch
    from presto_tpu_torch.ops import aggregation as A

    rng = np.random.default_rng(16)
    n, groups = 6000, 41
    big = rng.integers(I64_MAX - (1 << 40), I64_MAX, size=n,
                       endpoint=True)
    small = rng.integers(-(1 << 20), 1 << 20, size=n)
    sign = rng.choice([-1, 1], size=n)
    kind = rng.integers(0, 4, size=n)
    vals = np.where(kind == 0, big, np.where(kind == 1, -big,
                                             small * sign))
    if reducer == "global":
        gid = np.zeros(n, dtype=np.int64)
        groups = 1
        # one fitting sum with a wrapping running total
        vals = np.concatenate([[I64_MAX, 7, -9], small[:50]])
        gid = np.zeros(vals.shape[0], dtype=np.int64)
    else:
        gid = np.sort(rng.integers(0, groups, size=n))
    x = torch.from_numpy(vals.astype(np.int64))
    g = torch.from_numpy(gid)
    if reducer == "slot":
        red = A._SlotReducers(g, groups)
    elif reducer == "seg":
        starts = np.full(groups, n, dtype=np.int32)
        for i in range(n - 1, -1, -1):
            starts[gid[i]] = i
        red = A._SegReducers(g, groups, torch.from_numpy(starts))
    else:
        red = A._GlobalReducer()
    val, ovf = A.checked_sum_i64(x, red.sum)
    plain = red.sum(x)
    val, ovf, plain = (t.reshape(-1).tolist() for t in (val, ovf, plain))
    exact = [0] * groups
    for v, k in zip(vals.tolist(), gid.tolist()):
        exact[k] += v
    fits = [I64_MIN <= e <= I64_MAX for e in exact]
    assert ovf == [not f for f in fits]
    assert val == plain
    assert [v for v, f in zip(val, fits) if f] == \
        [e for e, f in zip(exact, fits) if f]
    if reducer != "global":
        assert 0 < sum(fits) < groups


def test_surface_phase_checked_statements_rehearsed(runners):
    """chip_smoke.py's checked-arithmetic statements of its surface phase
    at SF 0.01, with a second CPU runner in the card's place: the same
    error names or rows, and the sort-path sums through the segment
    sum's wrapper."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, port = runners
    other = TLocalRunner(tpch_sf=0.01, device="cpu")
    smoke._surface_checked(other, port, lambda: None, counter="plain_calls")
