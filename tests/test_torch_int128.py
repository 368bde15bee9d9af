"""presto_tpu_torch/ops/int128.py against presto_tpu/ops/int128.py on the
same seeded limb pairs (every function, overflow flags, division by
small and wide divisors, half-up rounding, float conversion, digit-plane
sums), then long decimals in SQL through both LocalRunners on the CPU,
mirroring tests/test_decimal128.py. Every comparison is exact: limbs bit
for bit, decimals as Decimal; doubles only where a cast produces one."""
import decimal
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec.runner import LocalRunner
from presto_tpu.ops import int128 as J
from presto_tpu_torch import errors as TE
from presto_tpu_torch.errors import QueryError as TQueryError
from presto_tpu_torch.exec.runner import LocalRunner as TLocalRunner
from presto_tpu_torch.ops import int128 as P

from torch_parity import assert_results_match

SEED = 20261017
N = 4000


def _values(k: int, digits: int = 38):
    """Seeded Python ints up to ``digits`` digits, with edge cases."""
    rng = np.random.default_rng(SEED + k)
    out = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64 - 1, -(2 ** 64),
           2 ** 63, -(2 ** 63), 2 ** 127 - 1, -(2 ** 127)]
    while len(out) < N:
        nd = int(rng.integers(1, digits + 1))
        v = int("".join(str(d) for d in rng.integers(0, 10, nd)))
        out.append(-v if rng.random() < 0.5 else v)
    return out


def _limbs(vals) -> np.ndarray:
    return J.np_limbs(vals)


def _pair(vals):
    a = _limbs(vals)
    return jnp.asarray(a), torch.from_numpy(a)


def _eq(j, t):
    assert np.array_equal(np.asarray(j), t.numpy())


def test_np_limbs_and_const_match():
    vals = _values(0)
    assert np.array_equal(J.np_limbs(vals), P.np_limbs(vals))
    for v in vals[:11]:
        assert P.limbs_of(v) == J.limbs_of(v)
        assert P.int_of(*P.limbs_of(v)) == v


@pytest.mark.parametrize("fn", ["add", "sub", "mul", "eq", "lt", "le"])
def test_binary_ops_bit_exact(fn):
    ja, ta = _pair(_values(1))
    jb, tb = _pair(_values(2, digits=20))
    got, want = getattr(P, fn)(ta, tb), getattr(J, fn)(ja, jb)
    if fn == "mul":
        _eq(want[0], got[0])
        _eq(want[1], got[1])
    else:
        _eq(want, got)


def test_add_overflow_flags():
    ja, ta = _pair(_values(3))
    jb, tb = _pair(_values(4))
    _eq(J.add_overflows(ja, jb, J.add(ja, jb)),
        P.add_overflows(ta, tb, P.add(ta, tb)))


@pytest.mark.parametrize("fn", ["neg", "abs_", "sign", "is_neg", "is_zero",
                                "sortable_lo", "to_f64",
                                "digit_sum_tiles"])
def test_unary_ops_bit_exact(fn):
    ja, ta = _pair(_values(5))
    _eq(getattr(J, fn)(ja), getattr(P, fn)(ta))


@pytest.mark.parametrize("precision", [1, 9, 18, 19, 30, 38])
def test_fits_decimal(precision):
    ja, ta = _pair(_values(6))
    _eq(J.fits_decimal(ja, precision), P.fits_decimal(ta, precision))


@pytest.mark.parametrize("delta", [-37, -20, -9, -3, -1, 0, 1, 5, 18, 25])
def test_rescale_half_up_and_overflow(delta):
    ja, ta = _pair(_values(7, digits=30))
    (jv, jo), (tv, to) = J.rescale(ja, delta), P.rescale(ta, delta)
    _eq(jv, tv)
    _eq(jo, to)


@pytest.mark.parametrize("d", [1, 7, 10, 10 ** 9, 2 ** 31])
def test_short_division(d):
    vals = [abs(v) % (2 ** 127) for v in _values(8)]
    ja, ta = _pair(vals)
    (jq, jr), (tq, tr) = J.divmod_small_abs(ja, d), P.divmod_small_abs(ta, d)
    _eq(jq, tq)
    _eq(jr, tr)
    sa, st = _pair(_values(9))
    _eq(J.div_round_half_up(sa, d), P.div_round_half_up(st, d))


def test_short_division_by_tensor_divisors():
    ja, ta = _pair(_values(10))
    dv = np.random.default_rng(SEED).integers(1, 2 ** 31, N)
    _eq(J.div_round_half_up(ja, jnp.asarray(dv)),
        P.div_round_half_up(ta, torch.from_numpy(dv)))


def test_wide_division_exact():
    num = [abs(v) % 2 ** 127 for v in _values(11)]
    den = [max(abs(v) % 2 ** 127, 1) for v in _values(12, digits=25)]
    (jq, jr) = J.divmod_abs(*(jnp.asarray(_limbs(x)) for x in (num, den)))
    (tq, tr) = P.divmod_abs(*(torch.from_numpy(_limbs(x))
                              for x in (num, den)))
    _eq(jq, tq)
    _eq(jr, tr)
    for i in range(0, N, 97):
        assert P.int_of(*tq[i].tolist()) == num[i] // den[i]
    sn, tn = _pair(_values(13))
    den_s = [v if v else 3 for v in _values(14, digits=19)]
    sd, td = _pair(den_s)
    _eq(J.div_round_half_up_wide(sn, sd), P.div_round_half_up_wide(tn, td))


def test_from_f64_rounds_like_reference():
    rng = np.random.default_rng(SEED + 15)
    v = np.concatenate([rng.normal(size=N) * 10.0 ** rng.integers(
        0, 37, N), [0.5, 1.5, -2.5, -2357.0, 2.0 ** 62, -2.0 ** 63,
                    1e37, -1e37, 2.0 ** 64 - 2048.0]])
    _eq(J.from_f64(jnp.asarray(v)), P.from_f64(torch.from_numpy(v)))


def test_digit_sums_checked():
    vals = _values(16)
    ja, ta = _pair(vals)
    js = jnp.sum(J.digit_sum_tiles(ja), axis=0)
    ts = P.digit_sum_tiles(ta).sum(0)
    _eq(js, ts)
    (jv, jo), (tv, to) = (J.from_digit_sum_tiles_checked(js),
                          P.from_digit_sum_tiles_checked(ts))
    _eq(jv, tv)
    _eq(jo, to)
    _eq(J.from_digit_sum_tiles(js), P.from_digit_sum_tiles(ts))
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        assert bool(to) == (not -(2 ** 127) <= sum(vals) < 2 ** 127)
    assert np.array_equal(J.OVERFLOW_SENTINEL, P.OVERFLOW_SENTINEL)
    sent = torch.from_numpy(P.OVERFLOW_SENTINEL)[None]
    assert bool(P.is_overflow_sentinel(sent)[0])


# -- long decimals in SQL -----------------------------------------------------

SQL = {
    "literals_and_arith":
        "select decimal '12345678901234567890.12345' + "
        "decimal '98765432109876543210.5', "
        "decimal '99999999999999999999' * decimal '1000000000000000000', "
        "decimal '12345678901234567890.5' - decimal '0.5'",
    "division_and_rounding":
        "select cast('12345678901234567890.5' as decimal(38,2)) / 4, "
        "round(decimal '12345678901234567890.567', 1), "
        "floor(decimal '-12345678901234567890.5'), "
        "ceil(decimal '-12345678901234567890.5')",
    "comparisons_and_abs":
        "select decimal '12345678901234567890' > "
        "decimal '12345678901234567889', "
        "abs(decimal '-123456789012345678901'), "
        "sign(decimal '-123456789012345678901')",
    "casts":
        "select cast(decimal '123456789012345678901.5' as double), "
        "cast(decimal '123.45678901234567890123' as decimal(10,2)), "
        "cast(12345 as decimal(38,3)), "
        "cast(decimal '42.0000000000000000000009' as bigint)",
    "null_propagation":
        "select cast(null as decimal(38,2)) + decimal '1.00', "
        "coalesce(cast(null as decimal(30,1)), decimal '7.5')",
    "sum_widens_to_38":
        "select sum(x), avg(x), min(x), max(x) from (values "
        "decimal '999999999999999.99', decimal '999999999999999.99', "
        "decimal '-0.01', cast(null as decimal(17,2))) t(x)",
    "grouped_long_decimal_aggs":
        "select k, sum(x), min(x), max(x) from (values "
        "(1, decimal '99999999999999999999999999999999.99'), "
        "(1, decimal '0.01'), "
        "(2, decimal '-99999999999999999999999999999999.99'), "
        "(2, cast(null as decimal(34,2)))) t(k, x) group by k order by k",
    "group_and_order_by_key":
        "select x, count(*) from (values decimal '12345678901234567890.5', "
        "decimal '12345678901234567890.5', decimal '-1.0', "
        "cast(null as decimal(21,1))) t(x) group by x order by x desc",
    "distinct":
        "select distinct x from (values decimal '1.00', decimal '1.00', "
        "decimal '99999999999999999999.99') t(x) order by x",
    "join_key":
        "with t as (select * from (values decimal '12345678901234567890.5', "
        "decimal '-1.0', decimal '99999999999999999999999999.25') v(q)) "
        "select count(*) from t a join t b on a.q = b.q",
    "window_partition":
        "select x, k, rank() over (partition by x order by k) from (values "
        "(decimal '12345678901234567890.5', 2), "
        "(decimal '12345678901234567890.5', 1), (decimal '-1.0', 3)) "
        "t(x, k) order by x, k",
    "window_short_decimal_sum":
        "select k, sum(x) over (partition by k) from (values "
        "(1, decimal '1.50'), (1, decimal '2.00'), (2, decimal '5.00')) "
        "t(k, x) order by k",
    "round_beyond_scale":
        "select round(decimal '9999999999999999999999999999999999', 10), "
        "round(decimal '123456789012345678.12', 5)",
    "small_values_to_double":
        "select cast(cast('4.00' as decimal(38,2)) as double), "
        "cast(cast('-7.25' as decimal(20,2)) as double), "
        "cast(cast('0.01' as decimal(38,2)) as double)",
    "lineitem_columns":
        "select l_returnflag, sum(cast(l_extendedprice as decimal(38,2))), "
        "avg(cast(l_quantity as decimal(25,2))), "
        "max(cast(l_extendedprice as decimal(30,2)) * l_discount), "
        "min(cast(l_extendedprice as decimal(20,4)) / 3) "
        "from lineitem group by 1 order by 1",
    "wide_division":
        "select cast('12345678901234567890123456.78' as decimal(38,2)) / "
        "cast('987654321098765.4' as decimal(16,1)), "
        "cast('99999999999999999999.99' as decimal(22,2)) / "
        "cast('-3.7' as decimal(16,1)), "
        "cast('0.04' as decimal(38,2)) / "
        "cast('400000000000000000.0' as decimal(19,1))",
    "percentile_and_distinct":
        "select approx_percentile(cast(l_extendedprice as decimal(30,2)), "
        "0.5), approx_distinct(cast(l_extendedprice as decimal(30,2))), "
        "count(distinct cast(l_extendedprice as decimal(30,2))) "
        "from lineitem",
}


#: VALUES columns of integer literals: INTEGER in the port (Presto's
#: LongLiteral typing), BIGINT in the reference
RETYPED = {
    "grouped_long_decimal_aggs": {0: ("bigint", "integer")},
    "window_partition": {1: ("bigint", "integer")},
    "window_short_decimal_sum": {0: ("bigint", "integer")},
}


@pytest.fixture(scope="module")
def runners():
    return LocalRunner(tpch_sf=0.01), TLocalRunner(tpch_sf=0.01,
                                                   device="cpu")


@pytest.mark.parametrize("name", list(SQL))
def test_long_decimal_sql_matches_reference(runners, name):
    jr, tr = runners
    got = tr.execute(SQL[name])
    assert got.rows
    assert_results_match(got, jr.execute(SQL[name]), 1e-12,
                         RETYPED.get(name))


def test_decimal_results_are_exact(runners):
    _, tr = runners
    rows = tr.execute(SQL["literals_and_arith"]).rows
    assert rows[0] == (Decimal("111111111011111111100.62345"),
                       Decimal("99999999999999999999000000000000000000"),
                       Decimal("12345678901234567890.0"))


@pytest.mark.parametrize("sql", [
    "select decimal '99999999999999999999999999999999999999' + decimal '1'",
    "select cast(decimal '12345678901234567890' as integer)",
    "select cast(1 as decimal(30,2)) / cast(0 as decimal(30,2))",
    "select cast(1e37 as decimal(38,0)) * 100",
    "select sum(x) from (values "
    "decimal '99999999999999999999999999999999999999', "
    "decimal '99999999999999999999999999999999999999') t(x)",
])
def test_long_decimal_errors_match_reference(runners, sql):
    jr, tr = runners
    with pytest.raises(Exception) as want:
        jr.execute(sql)
    with pytest.raises(TQueryError) as got:
        tr.execute(sql)
    assert got.value.code == PORT_CODES.get(sql, want.value.code)


#: where the port raises Presto's error and the reference another: a
#: decimal past an integral type is INVALID_CAST_ARGUMENT in DecimalCasts
#: (the reference raises NUMERIC_VALUE_OUT_OF_RANGE)
PORT_CODES = {
    "select cast(decimal '12345678901234567890' as integer)":
        TE.INVALID_CAST_ARGUMENT,
}


def test_window_over_long_decimal_rejected(runners):
    """Window aggregates over decimal(>18) stay an analysis error."""
    from presto_tpu_torch.sql.analyzer import AnalysisError
    _, tr = runners
    with pytest.raises(AnalysisError, match="decimal"):
        tr.execute("select sum(cast(x as decimal(38,2))) over () from "
                   "(values decimal '1.00') t(x)")
